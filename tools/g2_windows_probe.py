"""A short first check of kernels K16 (csrc/straus.cu) and K17
(csrc/g2_zmul.cu) on the card: build the library, hold each against the
launch sequence it replaces bit for bit (K16 at the combine's 10,240
rows × 7 shares × 87 windows on the combine's digits and on random
digits; K17 at 4,096 and 128 rows, and against its plain version at
128), time both beside that sequence with 2, 4 and 8 lanes a row, and
re-check K13 and K15, which share the op-program interpreter, against
their launch sequences.  Needs a CUDA card and nvcc:

    python3 tools/g2_windows_probe.py

Prints each result, the card's name and power limit, writes
chiprun_out/g2_windows_probe.json, and exits non-zero on a mismatch.
"""
import json, sys, time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import numpy as np, torch
import chip_smoke as cs
from charon_tpu_torch.ops import build, cuda_g2, cuda_h2c as ch, cuda_pairing as cp
from charon_tpu_torch.ops import miller_program as mp
from charon_tpu_torch.tbls.backend_cuda import STRAUS_NWIN, _lagrange_digits


def main() -> int:
    t0 = time.time()
    build.library()
    print("build", time.time() - t0, flush=True)
    for r in build.ptxas_rows():
        if any(k in r["name"] for k in ("straus_msm", "g2_zmul", "miller_loop_kernel", "g1_scalar_mul")):
            print(r, flush=True)
    dev = torch.device("cuda", 0)
    print(cs.smi("name,power.limit"), flush=True)
    out = {}
    gen = np.random.default_rng(1)
    # K16
    V, T, vrows = 10_000, 7, 10_240
    rows = vrows * T
    pts = cs.limbs(dev, gen, (6, 32, rows), "random")
    inf = torch.arange(3, rows, 997, device=dev)
    pts[..., inf] = cuda_g2.inf_planes(len(inf), dev)
    tables = cuda_g2.straus_tables(pts)
    lag = _lagrange_digits(tuple(range(1, T + 1)))
    comb = np.zeros((T, vrows, STRAUS_NWIN), np.int32)
    comb[:, :V] = lag[:, None, :]
    ds = {"combine": np.ascontiguousarray(comb.reshape(rows, STRAUS_NWIN).T),
          "random": gen.integers(-4, 4, (STRAUS_NWIN, rows), dtype=np.int32)}
    for label, d_np in ds.items():
        d = torch.from_numpy(d_np).to(dev)
        got = cuda_g2.straus_msm(tables, d, T)
        steps = cuda_g2.straus_steps(tables, d, T)
        torch.cuda.synchronize()
        eq = torch.equal(got, steps)
        print("K16", label, "equal", eq, flush=True)
        r = {"equal": eq, "ms": cs.time_ms(lambda: cuda_g2.straus_msm(tables, d, T), 3),
             "steps_ms": cs.time_ms(lambda: cuda_g2.straus_steps(tables, d, T), 3), "sweep": {}}
        for cfg in ((2, 26, 40), (4, 34, 40), (8, 36, 40)):
            e = torch.equal(cuda_g2.straus_msm(tables, d, T, *cfg), got)
            r["sweep"][str(cfg)] = (e, cs.time_ms(lambda: cuda_g2.straus_msm(tables, d, T, *cfg), 3))
        r["repack_ms"] = cs.time_ms(lambda: cuda_g2.straus_block(tables), 3)
        out["k16_" + label] = r
        print(label, r, flush=True)
    # K17
    for n in (4096, 128):
        q = cs.limbs(dev, gen, (6, 32, n), "random")
        q[..., 5:21] = cuda_g2.inf_planes(16, dev)
        got = ch.zmul(q)
        eq = torch.equal(got, ch.zmul_steps(q))
        r = {"equal_steps": eq, "ms": cs.time_ms(lambda: ch.zmul(q)),
             "steps_ms": cs.time_ms(lambda: ch.zmul_steps(q)), "sweep": {}}
        if n == 128:
            r["equal_plain"] = torch.equal(got, ch.zmul_plain(q))
        for cfg in ((2, 30, 40), (4, 36, 80), (8, 38, 20)):
            e = torch.equal(ch.zmul(q, *cfg), got)
            r["sweep"][str(cfg)] = (e, cs.time_ms(lambda: ch.zmul(q, *cfg)))
        out[f"k17_{n}"] = r
        print("K17", n, r, flush=True)
    # K13 / K15 after the interpreter refactor
    p = cs.limbs(dev, gen, (3, 32, 4096), "random"); qq = cs.limbs(dev, gen, (4, 32, 4096), "random")
    f = cp.miller_loop(p, qq)
    out["k13"] = {"equal": torch.equal(f, cp.miller_steps(p, qq)), "ms": cs.time_ms(lambda: cp.miller_loop(p, qq))}
    tb = [cs.limbs(dev, gen, (3, 32, 4096), "random") for _ in range(3)]
    w = torch.from_numpy(gen.integers(0, 4, (32, 4096), dtype=np.int32)).to(dev)
    g = cp.g1_scalar_mul_rows(*tb, w)
    out["k15"] = {"equal": torch.equal(g, cp.g1_scalar_mul_steps(*tb, w)), "ms": cs.time_ms(lambda: cp.g1_scalar_mul_rows(*tb, w))}
    print(out["k13"], out["k15"], flush=True)
    import pathlib
    pathlib.Path("chiprun_out").mkdir(exist_ok=True)
    pathlib.Path("chiprun_out/g2_windows_probe.json").write_text(json.dumps(out, indent=1))
    ok = all(v.get("equal", v.get("equal_steps")) for v in out.values())
    print("ALL OK" if ok else "MISMATCH", time.time() - t0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
