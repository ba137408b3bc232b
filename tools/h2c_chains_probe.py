"""A short first check of kernels K18 (csrc/f2_chain.cu), K19
(csrc/normalize.cu) and K20 (csrc/g1_tables.cu) on the card: build the
library, run chip_smoke.py's phases for the three — each kernel against
its plain version bit for bit and against the launch sequence it
replaces, timed beside it, K18's sweep over lanes, slots and window
widths — re-check K11 at one row (its Fp inverse moved to
csrc/fp_inv.cuh), and time a device hash batch of 64 and of 2,048
messages through the backend with its launches, its points held against
the pure-Python hash_to_g2 on a few messages.  Needs a CUDA card and
nvcc:

    python3 tools/h2c_chains_probe.py
    python3 tools/h2c_chains_probe.py --json results.json   # also write the results

Prints each result and the card's name and power limit, and exits
non-zero on a mismatch.
"""
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from charon_tpu_torch.ops import build, cuda_final_exp  # noqa: E402
from charon_tpu_torch.ops import curve as tcurve  # noqa: E402
from charon_tpu_torch.tbls import backend_cuda  # noqa: E402
from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2  # noqa: E402


def main() -> int:
    t0 = time.time()
    build.library()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    for r in build.ptxas_rows():
        if any(k in r["name"] for k in ("f2_chain_program", "g2_normalize",
                                        "g1_tables", "final_exp")):
            print(r, flush=True)
    dev = torch.device("cuda", 0)
    card = cs.smi("name,power.limit")
    print(card, flush=True)
    clock = float(cs.smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * clock * 1e6
    out = {"card": card}
    t0 = time.time()
    out["g1_tables"] = cs.tables_phase(dev, 4096, rate)
    out["g2_normalize"] = cs.normalize_phase(dev, rate)
    out["f2_chain"] = cs.chains_phase(dev, rate)
    print(f"phases {time.time() - t0:.1f} s", flush=True)
    # K11 at one row: its inverse now comes from csrc/fp_inv.cuh
    gen = np.random.default_rng(5)
    f = cs.limbs(dev, gen, (12, 32, 1), "random").reshape(2, 3, 2, 32, 1)
    if not torch.equal(cuda_final_exp.final_exp(f),
                       cuda_final_exp.final_exp_plain(f)):
        raise AssertionError("K11 differs from its plain version")
    print("K11 at 1 row: bit-identical to its plain version", flush=True)
    # device hash batches through the backend's stage
    be = backend_cuda.CUDABackend()
    msgs = cs.distinct_messages(2048)
    out["batches"] = {}
    for m in (64, 2048):
        runs = []
        for rep in range(4):
            cs.reset_all_launches()
            stages, launches = {}, {}
            planes = be._hash_on_card(msgs[:m], stages, launches)
            if rep == 0:
                counts = {k: n for k, n in launches["h2c_s"].items() if n}
            else:
                runs.append(stages["h2c_s"])
        for k in (0, m // 2, m - 1):
            if not np.array_equal(planes[..., k], tcurve.g2_pack(
                    [hash_to_g2(msgs[k])])[..., 0]):
                raise AssertionError(f"batch {m}: message {k} != the oracle")
        out["batches"][m] = {"h2c_s": statistics.median(runs), "reps": runs,
                             "launches": counts}
        print(f"hash batch of {m}: h2c_s median {statistics.median(runs):.6f}"
              f" s {runs}; launches {counts}", flush=True)
    if "--json" in sys.argv:
        path = Path(sys.argv[sys.argv.index("--json") + 1])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1, default=str))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
