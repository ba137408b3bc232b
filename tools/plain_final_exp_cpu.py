"""CPU time of K11's plain version, `cuda_final_exp.final_exp_plain`, in
its two forms: as committed (each stage's independent Fp2 products
batched along the rows, the way the kernel spreads them over lanes) and
on the sequential K5 bodies `cuda_pairing._f12_sqr` / `_f12_mul` (one
torch call per Fp2 product).  Both give the same bits; the script checks
that and prints one JSON line of seconds per call.

    python tools/plain_final_exp_cpu.py [--rows 1 4 16] [--threads 1]

The plain version is what a CPU tensor runs: the CPU tests and
`CUDABackend(device="cpu")`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from charon_tpu_torch.ops import cuda_final_exp as cfe  # noqa: E402
from charon_tpu_torch.ops import cuda_pairing as cp  # noqa: E402


def _sequential(f: torch.Tensor) -> torch.Tensor:
    """final_exp_plain with its squarings and products on the K5 bodies."""
    r = f.shape[-1]

    def planes(x):
        return cfe._stack(x).reshape(12, 32, r)

    def back(t):
        return cfe._unstack(t.reshape(*cfe.F12_SHAPE, r))

    with mock.patch.object(cfe, "_sqr", lambda x: back(cp._f12_sqr(
            planes(x)))), \
         mock.patch.object(cfe, "_mul", lambda x, y: back(cp._f12_mul(
             planes(x), planes(y)))):
        return cfe.final_exp_plain(f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 4, 16])
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    gen = np.random.default_rng(args.seed)
    out = {"threads": args.threads, "rows": {}}
    for r in args.rows:
        f = torch.from_numpy(gen.integers(0, 4096, (*cfe.F12_SHAPE, r),
                                          dtype=np.int32))
        t0 = time.perf_counter()
        batched = cfe.final_exp_plain(f)
        t1 = time.perf_counter()
        seq = _sequential(f)
        t2 = time.perf_counter()
        if not torch.equal(batched, seq):
            raise SystemExit(f"the two forms differ at {r} rows")
        out["rows"][r] = {"batched_s": t1 - t0, "sequential_s": t2 - t1}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
