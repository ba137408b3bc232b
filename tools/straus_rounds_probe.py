"""Time kernel K16 (csrc/straus.cu) against the number of validator rows
on the combine's digits (7 shares, 87 windows, every row real): 10,240
(the combine's), 6,336 (one round of 6 one-warp blocks an SM at 4 lanes
and 34 slots: 792 warps of 8 rows), 3,168, and 1,056 twice (one warp an
SM); with 4 lanes and 34 or 30 slots (6 or 7 blocks an SM), 8 lanes and
2 lanes.  Every variant must give the default's bits.  At 10,240 rows
also, with the default lanes, the combine's own inputs one change at a
time: the last 240 rows' digits 0 (10,000 validators padded), the first
240 rows' digits 0 instead, every digit 0 (HEADs only), and ∞ rows in
the tables (every 997th point).  Needs a CUDA card and nvcc:

    python3 tools/straus_rounds_probe.py

Prints one line of CUDA-event medians (ms) per row count and the card's
name and power limit, and writes chiprun_out/straus_rounds_probe.json.
"""
import json, sys, time, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np, torch
import chip_smoke as cs
from charon_tpu_torch.ops import build, cuda_g2
from charon_tpu_torch.tbls.backend_cuda import STRAUS_NWIN, _lagrange_digits


def main() -> int:
    build.library()
    dev = torch.device("cuda", 0)
    print(cs.smi("name,power.limit"), flush=True)
    gen = np.random.default_rng(1)
    T = 7
    lag = _lagrange_digits(tuple(range(1, T + 1)))
    out = {}
    ref = None
    for n in (10_240, 6_336, 3_168, 1_056, 132 * 8):
        rows = n * T
        pts = cs.limbs(dev, gen, (6, 32, rows), "random")
        tables = cuda_g2.straus_tables(pts)
        d = torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(lag[:, None, :], (T, n, STRAUS_NWIN)).reshape(rows, STRAUS_NWIN).T)).to(dev)
        r = {}
        base = cuda_g2.straus_msm(tables, d, T)
        for cfg in ((4, 34, 40), (4, 30, 40), (8, 36, 40), (2, 26, 40)):
            got = cuda_g2.straus_msm(tables, d, T, *cfg)
            assert torch.equal(got, base), cfg
            r[str(cfg)] = cs.time_ms(lambda: cuda_g2.straus_msm(tables, d, T, *cfg), 3)
        if n == 10_240:
            v = torch.arange(rows, device=dev) % n
            padded = d.clone()
            padded[:, v >= 10_000] = 0
            first = d.clone()
            first[:, v < n - 10_000] = 0
            r["padded_first"] = cs.time_ms(
                lambda: cuda_g2.straus_msm(tables, first, T), 3)
            zero = torch.zeros_like(d)
            r["heads_only"] = cs.time_ms(
                lambda: cuda_g2.straus_msm(tables, zero, T), 3)
            inf = torch.arange(3, rows, 997, device=dev)
            pts[..., inf] = cuda_g2.inf_planes(len(inf), dev)
            inf_tables = cuda_g2.straus_tables(pts)
            r["padded"] = cs.time_ms(
                lambda: cuda_g2.straus_msm(tables, padded, T), 3)
            r["inf_rows"] = cs.time_ms(
                lambda: cuda_g2.straus_msm(inf_tables, d, T), 3)
            r["padded_inf_rows"] = cs.time_ms(
                lambda: cuda_g2.straus_msm(inf_tables, padded, T), 3)
            r["default_again"] = cs.time_ms(
                lambda: cuda_g2.straus_msm(tables, d, T), 3)
        out[n] = r
        print(n, r, flush=True)
    pathlib.Path("chiprun_out").mkdir(exist_ok=True)
    pathlib.Path("chiprun_out/straus_rounds_probe.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
