#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (charon_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # the full run: 10,000 validators, 7-of-10

Phases, in order; any failure raises and exits non-zero:

1. build   — compile csrc/*.cu with nvcc (one process per source, in
             parallel); print the build seconds, the compiler's register /
             spill report, and the card's name and power limit.
2. kernels — every kernel (K1 fp ops, K2 G2 dbl/add, K3 Straus head/tail)
             against its plain PyTorch version ON THE CARD at the main
             path's shapes, on seeded random and all-LMAX limbs: the
             results must be bit-identical.  Kernel and plain times are
             CUDA-event medians of 5 runs.
3. combine — a pool of 1,024 distinct signatures s·H(m) built on the card;
             a real-Shamir check (V = 128: the combined bytes must equal
             sk·H(m)); then 10,000 SigAgg.aggregate() calls in one event-loop
             tick (T = 7, share indices 1..7) that must coalesce into ONE
             combine, 4 random rows checked against the pure-Python oracle;
             malformed and off-curve signatures must raise ValueError; the
             p50 of 3 full combines split into stages, with every kernel's
             launch count on the main path (each must be > 0).

The second-to-last line is the `kernels` JSON object; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import asyncio
import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# Int32 peaks per SM per clock on compute capability 9.0: IMAD issues only
# on the FMA pipe at 64 lanes (CUDA C++ Programming Guide, "Throughput of
# Native Arithmetic Instructions"; Nsight Compute's pipe list puts IMAD on
# the FMA pipe, the logic, shift and add ops on the ALU pipe), and the four
# schedulers issue at most one warp instruction each per clock, 128 lanes
# in all, whichever pipe takes the rest.
IMAD_LANES_PER_SM = 64
ISSUE_LANES_PER_SM = 128

# The combine the script drives: the north star's 10,000 validators, T = 7
# partials each (a 7-of-10 cluster), p50 over REPS full combines.
VALIDATORS, SHARES, REPS = 10_000, 7, 3


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Int32 instructions per row, [IMAD, ALU], from the loops of
# csrc/fp381.cuh: a product or fold term is one IMAD; a partial-carry
# column is three ALU instructions (and, add, shift); a column sum of up to
# three terms is one three-input add.  The bound of a launch is the larger
# of its IMADs over the FMA pipe's rate, all its instructions over the
# issue rate, and its bytes over the memory rate.
# ---------------------------------------------------------------------------

NL = 32


def _imad(n):
    return np.array([n, 0])


def _alu(n):
    return np.array([0, n])


def _cr(w):
    return _alu(3 * w)


def _fold(w):
    return _imad((w - NL) * NL)


def _red(w, iters):
    return (_cr(w) + _cr(w + 1) + _fold(w + 2)
            + iters * (_cr(NL) + _cr(NL + 1) + _fold(NL + 2)))


OPS = {}
OPS["fp_mul"] = _imad(NL * NL) + _red(2 * NL - 1, 5)
OPS["fp_add"] = _alu(NL) + _red(NL, 1)
OPS["fp_sub"] = _alu(NL) + _red(NL + 1, 1)
OPS["fp_neg"] = _alu(NL) + _red(NL + 1, 1)
OPS["fp_mul_small"] = _imad(NL) + _red(NL, 2)
_CONV_PC2 = _imad(NL * NL) + _cr(2 * NL - 1) + _cr(2 * NL)
# t2 − t0 − t1 + OFF2 (two adds) and t0 − t1 + OFF1 (one) per column
_F2MUL = (3 * _CONV_PC2 + 2 * OPS["fp_add"] + _alu(3 * (2 * NL + 1))
          + 2 * _red(2 * NL + 2, 6))
_F2SQR = (OPS["fp_add"] + OPS["fp_sub"] + _CONV_PC2 + _alu(2 * NL + 1)
          + _red(2 * NL + 1, 5) + OPS["fp_mul"])
_F2ADD, _F2SUB = 2 * OPS["fp_add"], 2 * OPS["fp_sub"]
_F2SMALL = 2 * OPS["fp_mul_small"]
_B3 = OPS["fp_sub"] + OPS["fp_add"] + 2 * OPS["fp_mul_small"]
OPS["g2_dbl"] = (2 * _F2SQR + 6 * _F2MUL + _B3 + 3 * _F2SMALL + 2 * _F2ADD
                 + _F2SUB)
OPS["g2_add"] = 12 * _F2MUL + 12 * _F2ADD + 5 * _F2SUB + _F2SMALL + 2 * _B3
PT_BYTES = 6 * NL * 4


def straus_work(digits: np.ndarray, head: bool) -> tuple[np.ndarray, int]:
    """([IMAD, ALU] instructions, bytes) one K3 launch needs for this digit
    row: a zero digit skips the addition and the table read, a negative
    one adds two negations."""
    n = digits.size
    nz = int((digits != 0).sum())
    ng = int((digits < 0).sum())
    ops = (3 * OPS["g2_dbl"] * n if head else 0) + nz * OPS["g2_add"] \
        + ng * 2 * OPS["fp_neg"]
    return ops, n * (2 * PT_BYTES + 4) + nz * PT_BYTES


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 5) -> float:
    """Median of `reps` CUDA-event timings of fn() (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernels_phase(dev, rows: int, vrows: int, sm_clocks_per_s: float) -> dict:
    from charon_tpu_torch.ops import cuda_fp, cuda_g2, fp

    gen = np.random.default_rng(20261016)
    lmax = fp.LMAX

    def limbs(shape, pattern):
        if pattern == "lmax":
            return torch.full(shape, lmax, dtype=torch.int32, device=dev)
        return torch.from_numpy(
            gen.integers(0, lmax + 1, shape, dtype=np.int32)).to(dev)

    def bound(ops: np.ndarray, nbytes: float) -> tuple[float, str]:
        imad, alu = (float(x) for x in ops)
        t_ops = max(imad / IMAD_LANES_PER_SM,
                    (imad + alu) / ISSUE_LANES_PER_SM) / sm_clocks_per_s
        t_mem = nbytes / MEM_BYTES_PER_S
        return (max(t_ops, t_mem) * 1e3,
                "operations" if t_ops >= t_mem else "bytes")

    results = {}

    def record(name, kernel_fn, plain_fn, ops, nbytes, patterns):
        err = 0
        for pat in patterns:
            args = pat()
            got, want = kernel_fn(*args), plain_fn(*args)
            torch.cuda.synchronize()
            if got.shape != want.shape:
                raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                                     f"{tuple(want.shape)}")
            diff = int((got.long() - want.long()).abs().max())
            if diff:
                raise AssertionError(f"{name}: kernel differs from its plain "
                                     f"version (max abs err {diff})")
            err = max(err, diff)
        args = patterns[0]()
        ms = time_ms(lambda: kernel_fn(*args))
        plain_ms = time_ms(lambda: plain_fn(*args))
        bms, by = bound(ops, nbytes)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bms, "bound_by": by}
        log(f"kernel {name}: bit-identical; {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms, bound {bms:.4f} ms by {by})")

    # K1 on [2, 32, rows] = 2·rows Fp rows
    fshape = (2, NL, rows)
    nfp = 2 * rows
    for name, k_fn, p_fn, n_in in (
            ("fp_mul", cuda_fp.mul, fp.mul_plain, 2),
            ("fp_add", cuda_fp.add, fp.add_plain, 2),
            ("fp_sub", cuda_fp.sub, fp.sub_plain, 2),
            ("fp_neg", cuda_fp.neg, fp.neg_plain, 1)):
        pats = [lambda n_in=n_in, p=p: tuple(limbs(fshape, p)
                                             for _ in range(n_in))
                for p in ("random", "lmax")]
        record(name, k_fn, p_fn, OPS[name] * nfp, (n_in + 1) * 128 * nfp,
               pats)
    pats = [lambda p=p: (limbs(fshape, p), 12) for p in ("random", "lmax")]
    record("fp_mul_small", cuda_fp.mul_small, fp.mul_small_plain,
           OPS["fp_mul_small"] * nfp, 2 * 128 * nfp, pats)

    # K2 on [6, 32, rows]
    pshape = (6, NL, rows)
    pats = [lambda p=p: (limbs(pshape, p),) for p in ("random", "lmax")]
    record("g2_dbl", cuda_g2.dbl, cuda_g2.dbl_plain, OPS["g2_dbl"] * rows,
           2 * PT_BYTES * rows, pats)
    pats = [lambda p=p: (limbs(pshape, p), limbs(pshape, p))
            for p in ("random", "lmax")]
    record("g2_add", cuda_g2.add, cuda_g2.add_plain, OPS["g2_add"] * rows,
           3 * PT_BYTES * rows, pats)

    # K3: acc [6, 32, vrows], four tables [6, 32, rows], digits [rows] in
    # [-4, 3], rows [row0, row0 + vrows)
    digits = torch.from_numpy(
        gen.integers(-4, 4, rows, dtype=np.int32)).to(dev)
    d_np = digits.cpu().numpy()
    for name, head, row0 in (("straus_head", True, 0),
                             ("straus_tail", False, vrows)):
        def pat(p, head=head, row0=row0):
            tabs = tuple(limbs(pshape, p) for _ in range(4))
            return (limbs((6, NL, vrows), p), tabs, row0, digits, head)
        ops, nbytes = straus_work(d_np[row0:row0 + vrows], head)
        record(name, cuda_g2.straus_step, cuda_g2.straus_step_plain, ops,
               nbytes, [lambda p=p: pat(p) for p in ("random", "lmax")])
    return results


# ---------------------------------------------------------------------------
# Phase 3: the combine through SigAgg
# ---------------------------------------------------------------------------

def make_pool(dev, n: int, msg: bytes, seed: int):
    """n distinct signatures s·H(m) (96-byte compressed), made on the card
    through the port's curve.scalar_mul, plus their scalars."""
    from charon_tpu_torch.tbls.ref.fields import R
    from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2

    h = hash_to_g2(msg)
    rng = random.Random(seed)
    scalars = [rng.randrange(1, R) for _ in range(n)]
    return h, scalars, sigs_on_card(dev, h, scalars)


def sigs_on_card(dev, h, scalars) -> list[bytes]:
    """[s·H for s in scalars] as compressed bytes, computed on the card."""
    from charon_tpu_torch.ops import codec, curve as tcurve

    n = len(scalars)
    base = torch.from_numpy(tcurve.g2_pack([h])).to(dev).expand(
        3, 2, NL, n).contiguous()
    bits = torch.from_numpy(
        np.ascontiguousarray(tcurve.scalars_to_bits(scalars).T)).to(dev)
    pts = tcurve.scalar_mul(tcurve.F2_OPS, base, bits)
    xc0, xc1, yc0, yc1, inf = codec.g2_normalize(pts)
    comp = codec.g2_compress_np(*[a.cpu().numpy().T
                                  for a in (xc0, xc1, yc0, yc1)],
                                inf.cpu().numpy())
    return [comp[k].tobytes() for k in range(n)]


def oracle_combine(sigs: dict[int, bytes]) -> bytes:
    from charon_tpu_torch.tbls import shamir
    from charon_tpu_torch.tbls.ref import curve as rc

    lam = shamir.lagrange_coeffs_at_zero(list(sigs))
    acc = None
    for i, s in sigs.items():
        acc = rc.add(acc, rc.multiply(rc.g2_from_bytes(s, False), lam[i]))
    return rc.g2_to_bytes(acc)


async def sigagg_round(parsigs_by_pk: dict, threshold: int, slot: int):
    """One SigAgg.aggregate() per validator, all in one loop tick; returns
    ({pubkey: group signature}, combine launches on the pipeline)."""
    from charon_tpu_torch.core.sigagg import SigAgg
    from charon_tpu_torch.core.types import Duty, DutyType
    from charon_tpu_torch.tbls import dispatch

    agg = SigAgg(threshold)
    out = {}

    async def sub(duty, pk, signed):
        out[pk] = signed.signature

    agg.subscribe(sub)
    pipe = dispatch.default_pipeline()
    before = pipe.launches
    duty = Duty(slot, DutyType.RANDAO)
    await asyncio.gather(*[agg.aggregate(duty, pk, ps)
                           for pk, ps in parsigs_by_pk.items()])
    return out, pipe.launches - before


def parsigs_for(sig_sets: list[dict[int, bytes]], epoch: int) -> dict:
    from charon_tpu_torch.core.types import ParSignedData, SignedRandao

    return {f"0x{v:096x}": [ParSignedData(SignedRandao(epoch, s), i)
                            for i, s in sigs.items()]
            for v, sigs in enumerate(sig_sets)}


def combine_phase(dev) -> tuple[dict, dict]:
    from charon_tpu_torch.ops import cuda_fp, cuda_g2
    from charon_tpu_torch.tbls import api, shamir
    from charon_tpu_torch.tbls.ref import curve as rc
    from charon_tpu_torch.tbls.ref.fields import FQ2, R

    v, t = VALIDATORS, SHARES
    backend = api._backend()        # the default: the cuda backend
    msg = b"charon-tpu-torch chip smoke: randao epoch 1"

    t0 = time.perf_counter()
    h, scalars, pool = make_pool(dev, 1024, msg, seed=1)
    for k in (0, 511, 1023):
        want = rc.g2_to_bytes(rc.multiply(h, scalars[k]))
        if pool[k] != want:
            raise AssertionError(f"pool row {k} != s·H(m)")
    log(f"pool: 1,024 signatures s·H(m) on the card in "
        f"{time.perf_counter() - t0:.2f} s (3 rows oracle-checked)")

    # real Shamir shares: V = 128 validators, 7 of 10 shares each, a
    # random 7-subset per validator
    t0 = time.perf_counter()
    rng = random.Random(7)
    nv = 128
    sks = [rng.randrange(1, R) for _ in range(nv)]
    subsets, share_vals = [], []
    for sk in sks:
        shares, _ = shamir.split_secret(sk, 7, 10, rng)
        idxs = sorted(rng.sample(range(1, 11), 7))
        subsets.append(idxs)
        share_vals += [shares[i] for i in idxs]
    part = sigs_on_card(dev, h, share_vals)
    sig_sets = [dict(zip(idxs, part[7 * k:7 * k + 7]))
                for k, idxs in enumerate(subsets)]
    got, launches = asyncio.run(sigagg_round(parsigs_for(sig_sets, 1), 7, 32))
    if launches != 1:
        raise AssertionError(f"Shamir round took {launches} combines")
    for k, sk in enumerate(sks):
        if got[f"0x{k:096x}"] != rc.g2_to_bytes(rc.multiply(h, sk)):
            raise AssertionError(f"validator {k}: combined != sk·H(m)")
    log(f"shamir: {nv} validators, random 7-of-10 subsets: every combined "
        f"signature == sk·H(m) ({time.perf_counter() - t0:.2f} s)")

    # malformed and off-curve signatures
    bad_flag = bytes([pool[0][0] & 0x7F]) + pool[0][1:]   # C flag cleared
    x = 1
    while (FQ2([x, 0]) ** 3 + rc.B2).sqrt() is not None:
        x += 1
    off_curve = bytes([0x80]) + bytes(47) + x.to_bytes(48, "big")
    good = {i: pool[i] for i in range(1, 8)}
    for label, batch in (
            ("malformed + off-curve", [good, {**good, 2: bad_flag},
                                       {**good, 3: off_curve}]),
            ("off-curve", [good, {**good, 3: off_curve}])):
        try:
            api.threshold_combine(batch)
        except ValueError as exc:
            log(f"reject: {label} batch raised ValueError ({exc})")
        else:
            raise AssertionError(f"{label} batch was accepted")

    # the main path: V validators × T shares through SigAgg, one tick
    gen = np.random.default_rng(3)
    pick = gen.integers(0, len(pool), (v, t))
    idxs = list(range(1, t + 1))
    sig_sets = [{i: pool[pick[r, k]] for k, i in enumerate(idxs)}
                for r in range(v)]
    parsigs = parsigs_for(sig_sets, 2)
    cuda_fp.reset_launches()
    cuda_g2.reset_launches()
    runs = []
    launch_counts = stage_launches = None
    for rep in range(REPS):
        t0 = time.perf_counter()
        got, launches = asyncio.run(sigagg_round(parsigs, t, 64 + rep))
        wall = time.perf_counter() - t0
        if rep == 0:
            launch_counts = {**cuda_fp.LAUNCHES, **cuda_g2.LAUNCHES}
            stage_launches = backend.last_launches
        if launches != 1 or len(got) != v:
            raise AssertionError(f"rep {rep}: {launches} combines for "
                                 f"{len(got)} of {v} validators")
        runs.append({"wall_s": wall, **backend.last_stages})
        log(f"combine rep {rep}: {v} validators × {t}: {wall:.3f} s wall; "
            + ", ".join(f"{k} {val:.4f}" for k, val in
                        backend.last_stages.items()))
    for r in sorted(gen.choice(v, 4, replace=False).tolist()):
        if got[f"0x{r:096x}"] != oracle_combine(sig_sets[r]):
            raise AssertionError(f"row {r}: combine != oracle")
    log("combine: 4 random rows equal the pure-Python oracle")
    zero = [k for k, n in launch_counts.items() if n == 0]
    if zero:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{zero}")
    by_stage = {k: sum(st[k] for st in stage_launches.values())
                for k in launch_counts}
    if by_stage != launch_counts:
        raise AssertionError(f"stage launches {by_stage} do not add up to "
                             f"the combine's {launch_counts}")
    p50 = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    log("combine p50 over %d reps: %s" % (REPS, json.dumps(
        {k: round(val, 6) for k, val in p50.items()})))
    log("launches per combine: " + json.dumps(launch_counts))
    log("launches per stage: " + json.dumps(
        {st: {k: n for k, n in c.items() if n}
         for st, c in stage_launches.items()}))
    return launch_counts, p50


# ---------------------------------------------------------------------------

SOURCES = {
    "fp_mul": ("charon_tpu_torch/csrc/fp_ops.cu", "charon_tpu/ops/pallas_fp.py:78"),
    "fp_add": ("charon_tpu_torch/csrc/fp_ops.cu", "charon_tpu/ops/pallas_fp.py:97"),
    "fp_sub": ("charon_tpu_torch/csrc/fp_ops.cu", "charon_tpu/ops/pallas_fp.py:104"),
    "fp_neg": ("charon_tpu_torch/csrc/fp_ops.cu", "charon_tpu/ops/pallas_fp.py:112"),
    "fp_mul_small": ("charon_tpu_torch/csrc/fp_ops.cu",
                     "charon_tpu/ops/pallas_fp.py:120"),
    "g2_dbl": ("charon_tpu_torch/csrc/g2.cu", "charon_tpu/ops/pallas_g2.py:350"),
    "g2_add": ("charon_tpu_torch/csrc/g2.cu", "charon_tpu/ops/pallas_g2.py:354"),
    "straus_head": ("charon_tpu_torch/csrc/g2.cu",
                    "charon_tpu/ops/pallas_g2.py:706"),
    "straus_tail": ("charon_tpu_torch/csrc/g2.cu",
                    "charon_tpu/ops/pallas_g2.py:700"),
}


def main() -> int:
    if not (ROOT / "charon_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: charon_tpu_torch/ is not beside this script (run "
              "it from a checkout of the repository)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from charon_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.INFO['build_seconds']:.1f} s) → {build.INFO['path']}")
    log(build.ptxas_report())
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_clocks_per_s = sms * clock_mhz * 1e6
    log(f"card: {card}; {sms} SMs, max SM clock {clock_mhz:.0f} MHz → "
        f"IMAD peak {IMAD_LANES_PER_SM * sm_clocks_per_s / 1e12:.2f} T/s, "
        f"int32 issue peak {ISSUE_LANES_PER_SM * sm_clocks_per_s / 1e12:.2f}"
        f" T/s")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    # the kernels at the shapes the combine gives them: its padded
    # validator rows (one Straus step) times the shares (decompress, tables)
    from charon_tpu_torch.tbls import api
    vrows = api.combine_padded_rows(VALIDATORS, SHARES)
    kern = kernels_phase(dev, vrows * SHARES, vrows, sm_clocks_per_s)
    launches, _ = combine_phase(dev)

    from charon_tpu_torch.tbls import dispatch
    pipe = dispatch.current_pipeline()
    if pipe is not None:
        pipe.shutdown()

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         **kern[name], "library_ms": None}
        for name in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
