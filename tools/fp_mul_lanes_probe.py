"""Probe: one Fp product over the 4 lanes of a row group against the
one-thread product of csrc/fp381.cuh, each in a chain of 380 dependent
squarings (the squarings of a fixed-exponent pow: K18's and K19's
critical path), at the row counts of a slot-start hash batch (256 root
rows, 64 normalised points) and a 2,048-message batch (8,192, 2,048).
Builds tools/fp_mul_lanes.cu with nvcc into build/fp_mul_lanes/, holds
the 4-lane chain against the one-thread chain bit for bit (and that
against `fp.mul_plain` iterated at 64 rows), times both with CUDA
events.  Not on any path.  Needs a CUDA card and nvcc:

    python3 tools/fp_mul_lanes_probe.py
    python3 tools/fp_mul_lanes_probe.py --json results.json   # also write the results

Prints each result and the card's name and power limit, and exits
non-zero on a mismatch.
"""
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from charon_tpu_torch.ops import build, fp  # noqa: E402

ITERS = 380


def library() -> ctypes.CDLL:
    out = ROOT / "build" / "fp_mul_lanes"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libfp_mul_lanes.so"
    cmd = [build.nvcc_path(), *build.ARCH, *build.FLAGS, "-I",
           str(build.CSRC), "-shared", str(ROOT / "tools" / "fp_mul_lanes.cu"),
           "-o", str(lib)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for line in (res.stdout + res.stderr).splitlines():
        if re.search(r"Compiling entry|Used \d+ registers|spill", line):
            print(line.strip(), flush=True)
    so = ctypes.CDLL(str(lib))
    so.charon_probe_chain.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
    so.charon_probe_chain.restype = ctypes.c_int
    return so


def main() -> int:
    so = library()
    dev = torch.device("cuda", 0)
    card = cs.smi("name,power.limit")
    print(card, flush=True)
    gen = np.random.default_rng(20261032)

    def chain(lanes, a, iters=ITERS):
        out = torch.empty_like(a)
        err = so.charon_probe_chain(
            lanes, out.data_ptr(), a.data_ptr(), a.shape[0], iters,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out

    a = torch.from_numpy(gen.integers(0, fp.LMAX + 1, (64, 32),
                                      dtype=np.int32)).to(dev)
    a[0] = fp.LMAX
    acc = a.T.contiguous()
    for _ in range(8):
        acc = fp.mul_plain(acc, acc)
    if not torch.equal(chain(1, a, 8), acc.T):
        raise AssertionError("the one-thread chain differs from mul_plain")
    res = {"card": card, "iters": ITERS, "rows": {}}
    for n in (64, 256, 2048, 8192):
        a = torch.from_numpy(gen.integers(0, fp.LMAX + 1, (n, 32),
                                          dtype=np.int32)).to(dev)
        a[0] = fp.LMAX
        one, four = chain(1, a), chain(4, a)
        torch.cuda.synchronize()
        if not torch.equal(one, four):
            raise AssertionError(f"the 4-lane chain differs at {n} rows")
        r = {"one_lane_ms": cs.time_ms(lambda: chain(1, a), 3),
             "four_lanes_ms": cs.time_ms(lambda: chain(4, a), 3)}
        r["speedup"] = r["one_lane_ms"] / r["four_lanes_ms"]
        res["rows"][n] = r
        print(f"{n:,} rows, {ITERS} squarings: one lane {r['one_lane_ms']:.4f}"
              f" ms, four lanes {r['four_lanes_ms']:.4f} ms "
              f"({r['speedup']:.2f}×), bit-identical", flush=True)
    if "--json" in sys.argv:
        path = Path(sys.argv[sys.argv.index("--json") + 1])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(res, indent=1, default=str))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
