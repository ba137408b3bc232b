"""The short first chip call of K21 and K22, and K2's times at the hash
batches' rows on any checkout.

    python3 tools/g2_law_probe.py ROOT [OUT_JSON]

ROOT is a checkout (this one, or an unpacked `git archive` of another
commit), imported and built as `tools/verify_ab.py` does.  On every
checkout: K2's doubling and addition (CUDA-event medians of 5) at a hash
batch's 64 and 2,048 rows and at the combine's 71,680.  On a checkout
that has K21 and K22: `chip_smoke.g2_law_phase` (K22's three programs
against their plain versions and the K2 sequences, with the sweep) and
`chip_smoke.g1_decompress_phase` on 10,000 fresh keys sk·G1 made on the
card (K21 against its plain version and the K1 chain, with bad rows).
Prints the card's name and power limit, then one JSON line; OUT_JSON
(optional) receives the same object.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    dest = Path(sys.argv[2]) if len(sys.argv) > 2 else None
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from charon_tpu_torch.ops import build, cuda_g2

    if not torch.cuda.is_available():
        print("g2_law_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.library()
    res = {"root": str(root), "build_s": time.perf_counter() - t0}
    card = cs.smi("name,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clocks = sms * float(cs.smi("clocks.max.sm").split()[0]) * 1e6
    gen = np.random.default_rng(9)
    res["k2"] = {}
    for n in (64, 2048, 71_680):
        p = cs.limbs(dev, gen, (6, cs.NL, n), "random")
        q = cs.limbs(dev, gen, (6, cs.NL, n), "random")
        res["k2"][n] = {"dbl_ms": cs.time_ms(lambda: cuda_g2.dbl(p)),
                        "add_ms": cs.time_ms(lambda: cuda_g2.add(p, q))}
    print(f"K2: {json.dumps(res['k2'])}", flush=True)
    if hasattr(cs, "g2_law_phase"):
        from charon_tpu_torch.ops import codec, curve as tcurve
        from charon_tpu_torch.tbls.ref import curve as rc
        from charon_tpu_torch.tbls.ref.fields import R

        res["ptxas"] = [r for r in build.ptxas_rows()
                        if r["name"].split()[0] in ("g1_decompress.cu",
                                                    "g2_law.cu")]
        res["g2_law"] = cs.g2_law_phase(dev, clocks, 71_680)
        rng = np.random.default_rng(11)
        sks = [int(k) for k in rng.integers(1, 2**62, cs.VALIDATORS)]
        bits = torch.from_numpy(np.ascontiguousarray(
            tcurve.scalars_to_bits(sks).T)).to(dev)
        g1 = torch.from_numpy(tcurve.g1_pack([rc.G1_GEN])).to(dev).expand(
            3, cs.NL, cs.VALIDATORS).contiguous()
        x, y, inf = codec.g1_normalize(
            tcurve.scalar_mul(tcurve.FP_OPS, g1, bits))
        pks = codec.g1_compress_np(x.cpu().numpy().T, y.cpu().numpy().T,
                                   inf.cpu().numpy())
        pks = [pks[k].tobytes() for k in range(cs.VALIDATORS)]
        if pks[7] != rc.g1_to_bytes(rc.multiply(rc.G1_GEN, sks[7] % R)):
            raise AssertionError("key 7 != the oracle's")
        res["g1_decompress"] = cs.g1_decompress_phase(dev, pks, clocks)
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    if dest is not None:
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
