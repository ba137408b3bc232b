"""`chip_smoke.py`'s chaos phase alone on one card: the build (the
phase's signatures made on the host's workers meanwhile, as in
`chip_smoke.py`), the card's name and power limit, one pure-Python
signature's time, then `chip_smoke.chaos_phase` (the fault catalogue and
the race stress with real BLS) and its launches.

    python3 tools/chaos_probe.py

Run from the root of a checkout; it needs a CUDA device.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chaos_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from charon_tpu_torch.ops import build
    from charon_tpu_torch.tbls import api, backend_cuda

    cs.log(f"one pure-Python tbls.sign: {cs.simnet_sign_seconds():.4f} s")
    try:
        presigned = cs.chaos_presign(cs.host_pool())
        t0 = time.perf_counter()
        build.library()
        cs.log(f"build {time.perf_counter() - t0:.1f} s")
        cs.log(f"card: {cs.smi('name,power.limit')}")
        # the backend chip_smoke.py's phases before it leave registered
        api.register_backend("cuda", backend_cuda.CUDABackend(resident=False))
        t0 = time.perf_counter()
        counts = cs.chaos_phase(torch.device("cuda", 0), presigned)
        cs.log(f"chaos phase {time.perf_counter() - t0:.1f} s; launches "
               f"{ {k: n for k, n in counts.items() if n} }")
    finally:
        cs.host_pool().shutdown(cancel_futures=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
