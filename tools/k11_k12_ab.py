"""Time kernels K11 (csrc/final_exp.cu) and K12 (csrc/decompress.cu) of
this checkout beside another checkout's (the parent's) on one card.

    python3 tools/k11_k12_ab.py PARENT [--sweep] [--plain] [--json OUT]

PARENT is a checkout of another commit (an unpacked `git archive`); both
builds run at once, each into its own ``build/``, and the parent's two
kernels are called through its own library with its own C signatures
(`charon_g2_decompress` without the lanes argument).  K12 runs at 1, 4,
2,048 and 71,680 rows (chip_smoke.py's `k12_inputs`: the pool's
signatures with ∞, off-curve, off-group and α = −1 rows; at 71,680 the
combine's 70,000 signatures and ∞ padding), K11 with its verdict at 1 and
2,048 rows (`fe_rows`).  Each shape is timed parent, change, change,
parent (CUDA-event medians of 5 launches each), and the two kernels'
outputs must be equal by value (canonical limbs) with equal ok flags and
verdicts, the ok flags as each row's kind wants.  `--sweep` also times
the change's K12 at both lane counts (16 and 8 a row, through its C
launcher: the wrapper takes no lane count) at those row counts and at
2,560, 3,072, 3,584, 4,096, 5,120, 6,144, 7,168, 8,192 and 20,480 rows
(the combines of 3 or 4 shares and 7-of-10 DKG's 7 × 1,024 fall between
a verify tile and the combine's 71,680), 16, 8, 8, 16, the two lane
counts' outputs bit for bit equal; `--plain` holds the change's kernels
against their plain versions bit for bit at the smallest shapes.  Prints
the card's name and power limit, a line per shape, and one JSON line
(also written to OUT); exits 1 on any mismatch.  Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from charon_tpu_torch.ops import (build, cuda_codec, cuda_final_exp,  # noqa: E402
                                  fp)
from charon_tpu_torch.ops import pairing as tpair  # noqa: E402

K12_ROWS = ((1, 1), (4, 1), (2048, 2048), (71_680, 70_000))
K12_SWEEP = tuple((n, n) for n in (2560, 3072, 3584, 4096, 5120, 6144,
                                   7168, 8192, 20_480))
K11_ROWS = (1, 2048)


def parent_library(proc: subprocess.Popen) -> ctypes.CDLL:
    text, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"the parent's build failed:\n{text[-3000:]}")
    lib = ctypes.CDLL(text.strip().splitlines()[-1])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.charon_g2_decompress.argtypes = [p, p, p, p, p, p, i, p]
    lib.charon_g2_decompress.restype = i
    lib.charon_final_exp.argtypes = [p, p, p, i, p]
    lib.charon_final_exp.restype = i
    return lib


def k12_at(lanes: int, xc0, xc1, sign, inf):
    """The change's K12 with `lanes` a row (16 or 8), whatever
    `cuda_codec.decompress_lanes` would choose."""
    n = xc0.shape[-1]
    pts = xc0.new_empty((3, 2, fp.NLIMBS, n))
    ok = torch.empty(n, dtype=torch.bool, device=xc0.device)
    err = build.library().charon_g2_decompress(
        lanes, pts.data_ptr(), ok.data_ptr(), xc0.data_ptr(), xc1.data_ptr(),
        sign.data_ptr(), inf.data_ptr(), n,
        torch.cuda.current_stream(xc0.device).cuda_stream)
    if err:
        raise RuntimeError(f"K12 at {lanes} lanes: cudaError {err}")
    return pts, ok


def canon(t: torch.Tensor, planes: int) -> torch.Tensor:
    return fp.canon_std(t.reshape(planes, fp.NLIMBS, t.shape[-1]))


def ab(label: str, parent_fn, change_fn) -> dict:
    """parent, change, change, parent: CUDA-event medians of 5 each."""
    t = [cs.time_ms(f) for f in (parent_fn, change_fn, change_fn, parent_fn)]
    out = {"parent_ms": [t[0], t[3]], "change_ms": [t[1], t[2]],
           "speedup": (t[0] + t[3]) / (t[1] + t[2])}
    cs.log(f"{label}: parent {t[0]:.4f} / {t[3]:.4f} ms, change {t[1]:.4f} "
           f"/ {t[2]:.4f} ms, {out['speedup']:.2f}×")
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--json")
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from charon_tpu_torch.ops import build; build.library(); "
         "print(build.INFO['path'])"],
        cwd=str(Path(a.parent).resolve()), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    build.library()
    old = parent_library(proc)
    cs.log(f"builds: both {time.perf_counter() - t0:.1f} s")
    for row in build.ptxas_rows():
        if row["name"].split()[0] in ("decompress.cu", "final_exp.cu"):
            cs.log(f"ptxas: {json.dumps(row)}")
    card = cs.smi("name,power.limit")
    cs.log(card)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _, _, pool = cs.make_pool(dev, 1024, b"k11-k12-ab", seed=1)
    gen = np.random.default_rng(20261021)
    res: dict = {"card": card, "k12": {}, "k11": {}, "sweep": {}}
    bad = []

    def old_k12(xc0, xc1, sign, inf):
        n = xc0.shape[-1]
        pts = xc0.new_empty((3, 2, fp.NLIMBS, n))
        ok = torch.empty(n, dtype=torch.bool, device=dev)
        err = old.charon_g2_decompress(
            pts.data_ptr(), ok.data_ptr(), xc0.data_ptr(), xc1.data_ptr(),
            sign.data_ptr(), inf.data_ptr(), n, stream)
        if err:
            raise RuntimeError(f"the parent's K12: cudaError {err}")
        return pts, ok

    def old_k11(f):
        out = torch.empty_like(f)
        ok = torch.empty(f.shape[-1], dtype=torch.bool, device=dev)
        err = old.charon_final_exp(out.data_ptr(), f.data_ptr(),
                                   ok.data_ptr(), f.shape[-1], stream)
        if err:
            raise RuntimeError(f"the parent's K11: cudaError {err}")
        return out, ok

    shapes = K12_ROWS + (K12_SWEEP if a.sweep else ())
    for rows, real in sorted(shapes):
        args, kind = cs.k12_inputs(dev, gen, pool, rows, real)
        (p_pts, p_ok), (c_pts, c_ok) = old_k12(*args), \
            cuda_codec.g2_decompress(*args)
        want = torch.tensor([k in ("valid", "inf") for k in kind],
                            device=dev)
        if not (torch.equal(canon(p_pts, 6), canon(c_pts, 6))
                and torch.equal(p_ok, c_ok) and torch.equal(c_ok, want)):
            bad.append(f"K12 at {rows}: the change differs from the parent")
        if a.plain and rows <= 4:
            got = cuda_codec.g2_decompress_plain(*args)
            if not all(torch.equal(g, w) for g, w in zip(got, (c_pts, c_ok))):
                bad.append(f"K12 at {rows}: kernel differs from its plain "
                           f"version")
        if (rows, real) in K12_ROWS:
            res["k12"][rows] = {
                **ab(f"K12 at {rows:,} rows "
                     f"({cuda_codec.decompress_lanes(rows)} lanes)",
                     lambda: old_k12(*args),
                     lambda: cuda_codec.g2_decompress(*args)),
                "lanes": cuda_codec.decompress_lanes(rows)}
        if a.sweep:
            wide, narrow = k12_at(16, *args), k12_at(8, *args)
            if not all(torch.equal(w, n) for w, n in zip(wide, narrow)):
                bad.append(f"K12 at {rows}: 16 and 8 lanes differ")
            t = {16: [], 8: []}
            for lanes in (16, 8, 8, 16):
                t[lanes].append(cs.time_ms(lambda lanes=lanes: k12_at(
                    lanes, *args)))
            res["sweep"][rows] = t
            cs.log(f"K12 sweep at {rows:,} rows: {t}")
        del args
    for rows in K11_ROWS:
        f = cs.fe_rows(dev, gen, rows)
        (p_out, p_ok), (c_out, c_ok) = old_k11(f), \
            cuda_final_exp.final_exp_is_one(f)
        if not (torch.equal(canon(p_out, 12), canon(c_out, 12))
                and torch.equal(p_ok, c_ok)):
            bad.append(f"K11 at {rows}: the change differs from the parent")
        if a.plain and rows == 1:
            out = cuda_final_exp.final_exp_plain(f)
            if not (torch.equal(out, c_out)
                    and torch.equal(tpair.is_one(out), c_ok)):
                bad.append("K11 at 1: kernel differs from its plain version")
        res["k11"][rows] = ab(f"K11 at {rows:,} rows", lambda: old_k11(f),
                              lambda: cuda_final_exp.final_exp_is_one(f))
    res["mismatches"] = bad
    for b in bad:
        cs.log(f"MISMATCH: {b}")
    line = json.dumps(res)
    if a.json:
        Path(a.json).parent.mkdir(parents=True, exist_ok=True)
        Path(a.json).write_text(line + "\n")
    print(line, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
