"""The short chip call of the multi-card combine: the build, chip_smoke's
`combine` phase (its 10,000 × 7 batch), then its `multichip` phase alone
(about 4 minutes of command on an H100 host, most of it the build).

    python3 tools/multichip_probe.py

Prints what the two phases print (the card's name and power limit among
it), then ``probe ok``.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    import chip_smoke as cs
    from charon_tpu_torch.ops import build
    from charon_tpu_torch.tbls import api, backend_cuda

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    try:
        build.library()
        cs.log(f"build {time.perf_counter() - t0:.1f} s")
        api.register_backend("cuda",
                             backend_cuda.CUDABackend(resident=False))
        t0 = time.perf_counter()
        _, _, _, sig_sets = cs.combine_phase(dev)
        cs.log(f"combine phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches = cs.multichip_phase(dev, sig_sets)
        cs.log(f"multichip phase {time.perf_counter() - t0:.1f} s")
        cs.log("launches " + str({k: n for k, n in launches.items() if n}))
    finally:
        cs.host_pool().shutdown(cancel_futures=True)
    print("probe ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
