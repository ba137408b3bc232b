"""Kernels K12, K19 and K21 — the whole G2 decompression, the whole G2
normalisation and the whole G1 decompression on the card
(csrc/decompress.cu, csrc/normalize.cu, csrc/g1_decompress.cu).

Everything `codec.g2_decompress` (the JAX package's ops/codec.py
`g2_decompress`) does on the device, as ONE launch per batch: rhs = x³ +
b', the Fp2 square root of Alg. 9 (two fixed-exponent pows, the α = −1
select and the check root² == rhs), the ZCash sign of the canonical y and
the flip, `from_affine` with the ∞ flag, and the subgroup check ψ(Q) ==
[z]Q.  On the TPU each of those field ops reaches a `pallas_fp` kernel
(`_mul_kernel` :78, `_add_kernel` :97, `_sub_kernel` :104, `_neg_kernel`
:112, `_small_kernel_factory` :120); the port's plain copy makes each a
K1 launch — 7,467 per batch.

A row runs on a group of 16 or 8 lanes (`decompress_lanes`), every Fp
element spread over them (csrc/fp_lanes.cuh, the same integers as the
csrc/fp381.cuh functions); the pows run 3-bit windows, MSB first
(`_f2_pow_w3`), their squarings `f2_sqr`, the group law the complete
RCB doubling and addition of K2, plus exact `canon`, `is_zero` and
`sgn`.  The [|z|]Q multiplication is `curve.scalar_mul`'s 2-bit windowed
double-and-add over |z| with the additions of zero windows left out and
the top window's table entry as the start (the same group element: Q + ∞
= Q).  The plain version here, `g2_decompress_plain`, runs the same
sequence on cuda_g2's plain field library and is BIT-IDENTICAL to the
kernel; it is value-equal to `codec.g2_decompress` and to JAX's, with the
same ok flags (an x off the curve fails the square root whatever the
later steps compute).

Inputs: standard-form x = c0 + c1·u limb planes [32, R] int32, sign and
inf flags [R] bool.  Output: (projective points [3, 2, 32, R], ok [R]
bool) — `codec.g2_decompress`'s contract.  The wrapper routes CPU tensors
to the plain version and launches the kernel for CUDA tensors (or
raises); `LAUNCHES` counts kernel launches.

K19 `g2_normalize` is `codec.g2_normalize` (the JAX package's ops/
codec.py :319, `curve.to_affine` then the standard form) in ONE launch,
one thread per row: the norm Z0² + Z1², its Fp inverse by 4-bit windows
(`fp_inv_w4`, 489 products where `fp.pow_fixed`'s square-and-multiply
launches 397 K1 products a call, 609 Fp products), Z⁻¹ = (Z0, −Z1)/norm,
x = X·Z⁻¹, y = Y·Z⁻¹ and the exact canonicalisation, ∞ (Z ≡ 0) giving
(0, 0, True).  The outputs are canonical, so any chain gives the same
bytes: the plain version `g2_normalize_plain` runs the kernel's sequence
and equals `codec.g2_normalize` and JAX's bit for bit.

K21 `g1_decompress` is `codec.g1_decompress` (the JAX package's ops/
codec.py :266, the subgroup check `g1_in_subgroup` :254) with the
backend's ∞ mask, in ONE launch per key batch, one thread per row: rhs =
x³ + 4, the root rhs^((p+1)/4) by `fp.pow_fixed`'s LSB-first square-and-
multiply, ok = (root² == rhs), the ZCash sign of the canonical root and
the flip, `from_affine` with the ∞ flag, and the verdict ok ∧ ¬∞ ∧ [r]P
= ∞.  The points are bit for bit codec's (the same products in the same
order); [r]P runs 4-bit windows of r over the table P..15P on the
complete G1 law — another schedule than codec's 2-bit one, the same
group element, so the same verdict.  `g1_decompress_plain` runs the
kernel's sequence in plain PyTorch (the CPU route).
"""

from __future__ import annotations

import numpy as np
import torch

from ..tbls.ref.fields import P, R
from . import build, codec, fp, launch_count, miller_program
from .cuda_g2 import (_addf, _cuda_ready, _f2add, _f2mul, _f2sqr, _f2sub,
                      _g2_add, _g2_double, _mulf, _negf, _raise_on,
                      _table_f2)
from .cuda_pairing import _g1_add, _g1_double
from .curve import F2_OPS

NL = fp.NLIMBS

# Fp2 constants, i in rows 2i, 2i+1: the twist's b' = 4(1 + u), −1, and
# the ψ coefficients c_x, c_y (codec._PSI_CX_M / _PSI_CY_M)
_DC_NP = np.concatenate([F2_OPS.b, codec._F2_MINUS_ONE, codec._PSI_CX_M,
                         codec._PSI_CY_M]).astype(np.int32)
_DC_B, _DC_M1, _DC_CX, _DC_CY = 0, 1, 2, 3

EXP_P34 = (P - 3) // 4      # a^((p−3)/4): the root candidate's pow
EXP_P12 = (P - 1) // 2      # (α + 1)^((p−1)/2)
EXP_P14 = (P + 1) // 4      # the Fp root rhs^((p+1)/4) (codec.fp_sqrt)
#: the 4-bit digits of r, MSB first (csrc/g1_decompress.cu reads them from
#: EXP_R's words; the top one, 7, is the multiplication's start)
R_DIGITS = miller_program.pow_digits(R, 4)
assert len(R_DIGITS) == 64 and R_DIGITS[0] != 0

#: |z| and the sign of z (codec's derived, checked values)
ABS_Z = abs(codec._Z_SIGNED)
Z_NEG = codec._Z_SIGNED < 0
#: 2-bit windows of |z| over 64 bits, MSB first (the top one non-zero:
#: the scalar multiplication starts from its table entry)
Z_WINDOWS = tuple((ABS_Z >> (62 - 2 * i)) & 3 for i in range(32))
assert ABS_Z < 1 << 64 and Z_WINDOWS[0] != 0


def dc_consts() -> np.ndarray:
    """The constant table [8, 32] of csrc/fp381_consts.cuh (DC)."""
    return _DC_NP.copy()


def _cf2(idx: int, like: torch.Tensor):
    return _table_f2(_DC_NP, idx, like)


def _f2_one(like: torch.Tensor):
    one = fp.const(fp.ONE, like.device).unsqueeze(-1).expand_as(like)
    return (one, torch.zeros_like(like))


#: the windows of K12's pows (csrc/decompress.cu): 3 bits, MSB first
POW_WINDOW = 3


def _f2_pow_w3(a, e: int):
    """a^e by 3-bit windows, MSB first (csrc/decompress.cu `pow`): the
    table a..a⁷ (a² by f2_sqr, then products by a), then per window three
    squarings (f2_sqr) and, for a non-zero digit, one product."""
    tbl = [None, a, _f2sqr(a)]
    for k in range(3, 1 << POW_WINDOW):
        tbl.append(_f2mul(tbl[k - 1], a))
    digits = miller_program.pow_digits(e, POW_WINDOW)
    acc = tbl[digits[0]]
    for d in digits[1:]:
        for _ in range(POW_WINDOW):
            acc = _f2sqr(acc)
        if d:
            acc = _f2mul(acc, tbl[d])
    return acc


def _f2_is_zero(a) -> torch.Tensor:
    return fp.is_zero(a[0]) & fp.is_zero(a[1])


def _f2_sel(cond, a, b):
    return (torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1]))


def _f2_neg(a):
    return (_negf(a[0]), _negf(a[1]))


def _pt(x, y, z) -> torch.Tensor:
    return torch.stack([x[0], x[1], y[0], y[1], z[0], z[1]])


def _in_subgroup(pt: torch.Tensor) -> torch.Tensor:
    """ψ(Q) == [z]Q per row of [6, 32, R] points (True at ∞)."""
    tables = (None, pt, _g2_double(pt))
    tables += (_g2_add(tables[2], pt),)
    acc = tables[Z_WINDOWS[0]]
    for w in Z_WINDOWS[1:]:
        acc = _g2_double(_g2_double(acc))
        if w:
            acc = _g2_add(acc, tables[w])
    x2, y2, z2 = (acc[0], acc[1]), (acc[2], acc[3]), (acc[4], acc[5])
    if Z_NEG:
        y2 = _f2_neg(y2)
    like = pt[0]
    x, y, z = (pt[0], pt[1]), (pt[2], pt[3]), (pt[4], pt[5])
    x1 = _f2mul(_cf2(_DC_CX, like), (x[0], _negf(x[1])))
    y1 = _f2mul(_cf2(_DC_CY, like), (y[0], _negf(y[1])))
    z1 = (z[0], _negf(z[1]))
    xa, xb = _f2mul(x1, z2), _f2mul(x2, z1)
    ya, yb = _f2mul(y1, z2), _f2mul(y2, z1)
    i1, i2 = _f2_is_zero(z1), _f2_is_zero(z2)
    return (i1 & i2) | (~i1 & ~i2 & _f2_is_zero(_f2sub(xa, xb))
                        & _f2_is_zero(_f2sub(ya, yb)))


def g2_decompress_plain(xc0: torch.Tensor, xc1: torch.Tensor,
                        sign: torch.Tensor, inf: torch.Tensor):
    """The kernel's sequence: (points [3, 2, 32, R], ok [R] bool)."""
    x = (xc0, xc1)
    rhs = _f2add(_f2mul(_f2sqr(x), x), _cf2(_DC_B, xc0))
    # the square root (codec.f2_sqrt)
    a1 = _f2_pow_w3(rhs, EXP_P34)
    alpha = _f2mul(_f2sqr(a1), rhs)
    x0 = _f2mul(a1, rhs)
    root_u = (_negf(x0[1]), x0[0])
    root_b = _f2mul(_f2_pow_w3(_f2add(alpha, _f2_one(xc0)), EXP_P12), x0)
    is_m1 = _f2_is_zero(_f2sub(alpha, _cf2(_DC_M1, xc0)))
    y = _f2_sel(is_m1, root_u, root_b)
    ok = _f2_is_zero(_f2sub(_f2sqr(y), rhs))
    # the sign of the canonical y
    y0_std, y1_std = fp.canon_std(y[0]), fp.canon_std(y[1])
    cur = torch.where(fp.is_zero(y1_std), fp.sgn(y0_std), fp.sgn(y1_std))
    y = _f2_sel(cur != sign, _f2_neg(y), y)
    # from_affine with the ∞ flag
    zero, one = torch.zeros_like(xc0), _f2_one(xc0)
    pt = _pt(_f2_sel(inf, (zero, zero), x), _f2_sel(inf, one, y),
             _f2_sel(inf, (zero, zero), one))
    ok = (ok | inf) & _in_subgroup(pt)
    return pt.reshape(3, 2, NL, xc0.shape[-1]), ok


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

#: kernel launches since the last `reset_launches()` (all threads;
#: `launch_count.this_thread()` has the calling thread's own)
LAUNCHES = {"g2_decompress": 0, "g2_normalize": 0, "g1_decompress": 0}


def reset_launches() -> None:
    launch_count.reset(LAUNCHES)


#: K12's lanes a row by batch (csrc/decompress.cu's two instantiations):
#: 16 up to this many rows (a verify tile, a combine of 3 shares), 8
#: above it (4 shares, a DKG's 7, the 10,000 × 7 combine).  On the H100
#: the two cross between 3,072 and 3,584 rows, where 16-lane groups pass
#: one wave (132 SMs × 12 one-warp blocks × 2 rows = 3,168) and 8-lane
#: ones do not (PERF.md row 26: `tools/k11_k12_ab.py --sweep`)
DECOMPRESS_WIDE_ROWS = 3072


def decompress_lanes(rows: int) -> int:
    """The lanes a row K12 runs `rows` rows on."""
    return 16 if rows <= DECOMPRESS_WIDE_ROWS else 8


def decompress_kernel_name(rows: int) -> str:
    """The instantiation K12 launches at `rows` rows (the registry's and
    the compiler report's name)."""
    return f"decompress.cu g2_decompress_kernel<{decompress_lanes(rows)}>"


def g2_decompress(xc0: torch.Tensor, xc1: torch.Tensor, sign: torch.Tensor,
                  inf: torch.Tensor):
    """Std-form x limb planes [32, R] (int32) + sign/inf flags [R] (bool)
    → (projective points [3, 2, 32, R], ok [R] bool): one launch, a row
    on `decompress_lanes(R)` threads."""
    r = xc0.shape[-1]
    for name, t in (("xc0", xc0), ("xc1", xc1)):
        if t.dtype != torch.int32 or tuple(t.shape) != (NL, r) or r == 0:
            raise ValueError(f"g2_decompress: {name} must be int32 [32, R], "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, t in (("sign", sign), ("inf", inf)):
        if t.dtype != torch.bool or tuple(t.shape) != (r,):
            raise ValueError(f"g2_decompress: {name} must be bool [{r}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if any(t.device != xc0.device for t in (xc1, sign, inf)):
        raise ValueError("g2_decompress: operands on different devices")
    if xc0.device.type == "cpu":
        return g2_decompress_plain(xc0, xc1, sign, inf)
    if not all(t.is_contiguous() for t in (xc0, xc1, sign, inf)):
        raise ValueError("g2_decompress: operands must be contiguous")
    if 6 * NL * r >= 2 ** 31:
        raise ValueError(f"g2_decompress: {r} rows exceed the int index")
    _cuda_ready("g2_decompress", xc0)
    pts = xc0.new_empty((3, 2, NL, r))
    ok = torch.empty(r, dtype=torch.bool, device=xc0.device)
    err = build.library().charon_g2_decompress(
        decompress_lanes(r), pts.data_ptr(), ok.data_ptr(), xc0.data_ptr(),
        xc1.data_ptr(), sign.data_ptr(), inf.data_ptr(), r,
        torch.cuda.current_stream(xc0.device).cuda_stream)
    _raise_on("g2_decompress", err)
    launch_count.bump(LAUNCHES, "g2_decompress")
    return pts, ok


# ---------------------------------------------------------------------------
# K19: projective G2 → canonical affine
# ---------------------------------------------------------------------------

#: the 4-bit windows of p − 2, MSB first (csrc/fp_inv.cuh reads them from
#: EXP_PM2's words)
_INV_DIGITS = miller_program.pow_digits(P - 2, 4)


def _fp_inv_w4(a: torch.Tensor) -> torch.Tensor:
    """a^(p−2) (inv(0) = 0): the table a¹..a¹⁵, then per 4-bit window
    four squarings and a product for a non-zero digit (csrc/fp_inv.cuh
    `fp_inv_w4`)."""
    tbl = [None, a, _mulf(a, a)]
    for k in range(3, 16):
        tbl.append(_mulf(tbl[k - 1], a))
    acc = tbl[_INV_DIGITS[0]]
    for d in _INV_DIGITS[1:]:
        for _ in range(4):
            acc = _mulf(acc, acc)
        if d:
            acc = _mulf(acc, tbl[d])
    return acc


def g2_normalize_plain(pt: torch.Tensor):
    """The kernel's sequence on projective [3, 2, 32, R] → (xc0, xc1, yc0,
    yc1 canonical std [32, R], inf [R] bool)."""
    x, y, z = pt[0], pt[1], pt[2]
    ninv = _fp_inv_w4(_addf(_mulf(z[0], z[0]), _mulf(z[1], z[1])))
    zinv = (_mulf(z[0], ninv), _negf(_mulf(z[1], ninv)))
    xa = _f2mul((x[0], x[1]), zinv)
    ya = _f2mul((y[0], y[1]), zinv)
    inf = fp.is_zero(z[0]) & fp.is_zero(z[1])
    return (*(fp.canon_std(t) for t in (*xa, *ya)), inf)


def g2_normalize(pt: torch.Tensor):
    """K19: projective G2 [3, 2, 32, R] → (xc0, xc1, yc0, yc1 canonical
    std [32, R], inf [R] bool), `codec.g2_normalize`'s contract (∞ → (0,
    0, True)), in ONE launch, one thread per row."""
    if pt.device.type == "cpu":
        return g2_normalize_plain(pt)
    r = pt.shape[-1]
    if pt.dtype != torch.int32 or tuple(pt.shape) != (3, 2, NL, r) \
            or r == 0 or not pt.is_contiguous():
        raise ValueError(f"g2_normalize: expected a contiguous int32 "
                         f"[3, 2, 32, R], got {pt.dtype} {tuple(pt.shape)}")
    if 6 * NL * r >= 2 ** 31:
        raise ValueError(f"g2_normalize: {r} rows exceed the int index")
    _cuda_ready("g2_normalize", pt)
    out = pt.new_empty((4, NL, r))
    inf = torch.empty(r, dtype=torch.bool, device=pt.device)
    err = build.library().charon_g2_normalize(
        out.data_ptr(), inf.data_ptr(), pt.data_ptr(), r,
        torch.cuda.current_stream(pt.device).cuda_stream)
    _raise_on("g2_normalize", err)
    launch_count.bump(LAUNCHES, "g2_normalize")
    return (*out.unbind(0), inf)


# ---------------------------------------------------------------------------
# K21: the G1 pubkey decompression
# ---------------------------------------------------------------------------

_G1_B = fp.to_limbs(4)          # y² = x³ + 4


def _fp_pow(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e, LSB first (fp.pow_fixed's products, one at a time)."""
    result = fp.const(fp.ONE, a.device).unsqueeze(-1).expand_as(a)
    base, nbits = a, e.bit_length()
    for i in range(nbits):
        if (e >> i) & 1:
            result = fp.mul_plain(result, base)
        if i != nbits - 1:
            base = fp.mul_plain(base, base)
    return result


def _g1_r_is_inf(pt: torch.Tensor) -> torch.Tensor:
    """[r]P == ∞ per row of [3, 32, R] points: 4-bit windows of r, MSB
    first, over the table P..15P; a zero digit adds nothing."""
    tbl = [None, pt, _g1_double(pt)]
    for k in range(3, 16):
        tbl.append(_g1_add(tbl[k - 1], pt))
    acc = tbl[R_DIGITS[0]]
    for d in R_DIGITS[1:]:
        for _ in range(4):
            acc = _g1_double(acc)
        if d:
            acc = _g1_add(acc, tbl[d])
    return fp.is_zero(acc[2])


def g1_decompress_plain(x: torch.Tensor, sign: torch.Tensor,
                        inf: torch.Tensor):
    """The kernel's sequence: (points [3, 32, R], verdicts [R] bool)."""
    rhs = fp.add_plain(fp.mul_plain(fp.mul_plain(x, x), x),
                       fp.elem(_G1_B, x.device))
    y = _fp_pow(rhs, EXP_P14)
    ok = fp.is_zero(fp.sub_plain(fp.mul_plain(y, y), rhs))
    flip = fp.sgn(fp.canon_std(y)) != sign
    y = torch.where(flip, fp.neg_plain(y), y)
    zero = torch.zeros_like(x)
    one = fp.const(fp.ONE, x.device).unsqueeze(-1).expand_as(x)
    pt = torch.stack([torch.where(inf, zero, x), torch.where(inf, one, y),
                      torch.where(inf, zero, one)])
    return pt, ok & ~inf & _g1_r_is_inf(pt)


def g1_decompress(x: torch.Tensor, sign: torch.Tensor, inf: torch.Tensor):
    """K21: std-form x limb planes [32, R] (int32) + sign/inf flags [R]
    (bool) → (projective points [3, 32, R], verdicts [R] bool) in ONE
    launch, one thread per row: the points are `codec.g1_decompress`'s,
    bit for bit, and a verdict is its ok with ∞ rows false (the key is
    on the curve, in G1 and not ∞)."""
    r = x.shape[-1]
    if x.dtype != torch.int32 or tuple(x.shape) != (NL, r) or r == 0:
        raise ValueError(f"g1_decompress: x must be int32 [32, R], got "
                         f"{x.dtype} {tuple(x.shape)}")
    for name, t in (("sign", sign), ("inf", inf)):
        if t.dtype != torch.bool or tuple(t.shape) != (r,):
            raise ValueError(f"g1_decompress: {name} must be bool [{r}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if any(t.device != x.device for t in (sign, inf)):
        raise ValueError("g1_decompress: operands on different devices")
    if x.device.type == "cpu":
        return g1_decompress_plain(x, sign, inf)
    if not all(t.is_contiguous() for t in (x, sign, inf)):
        raise ValueError("g1_decompress: operands must be contiguous")
    if 3 * NL * r >= 2 ** 31:
        raise ValueError(f"g1_decompress: {r} rows exceed the int index")
    _cuda_ready("g1_decompress", x)
    pts = x.new_empty((3, NL, r))
    ok = torch.empty(r, dtype=torch.bool, device=x.device)
    err = build.library().charon_g1_decompress(
        pts.data_ptr(), ok.data_ptr(), x.data_ptr(), sign.data_ptr(),
        inf.data_ptr(), r, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on("g1_decompress", err)
    launch_count.bump(LAUNCHES, "g1_decompress")
    return pts, ok


def _register_kernels() -> None:
    """K12's two instantiations (a row on 16 or 8 lanes, one-warp blocks),
    K19 and K21 (a thread a row, 32 threads a block) for the kernel
    contract audit."""
    from ..analysis import registry
    from . import smem_budget

    for lanes, budget, replaces in (
            (16, (168, 688, 32), "charon_tpu/ops/pallas_fp.py:78"),
            (8, (255, 1104, 0), None)):
        registry.register_kernel(registry.KernelSpec(
            name=f"decompress.cu g2_decompress_kernel<{lanes}>",
            symbol="g2_decompress_kernel", source="csrc/decompress.cu",
            launch="g2_decompress", attr_index=0 if lanes == 16 else 1,
            geometry=smem_budget.lane_groups(lanes), budget=budget,
            replaces=replaces, perf_rows=(26,)))
    for name, stem, sym, budget, replaces, row in (
            ("g2_normalize", "normalize", "g2_normalize_kernel",
             (255, 3584, 0), "charon_tpu/ops/codec.py:319", 33),
            ("g1_decompress", "g1_decompress", "g1_decompress_kernel",
             (168, 8320, 0), "charon_tpu/ops/codec.py:266", 35)):
        registry.register_kernel(registry.KernelSpec(
            name=f"{stem}.cu {sym}", symbol=sym, source=f"csrc/{stem}.cu",
            launch=name, attr_index=0, geometry=smem_budget.per_thread(32),
            budget=budget, replaces=replaces, perf_rows=(row,)))


_register_kernels()
