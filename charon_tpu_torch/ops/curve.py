"""Batched G1/G2 point arithmetic for BLS12-381 in PyTorch.

The port of the JAX package's ops/curve.py: HOMOGENEOUS PROJECTIVE points
(X : Y : Z) with infinity (0 : 1 : 0), and the Renes–Costello–Batina
COMPLETE addition/doubling for a = 0 curves (one straight-line formula for
every input pair, no zero-tests).  The group law is generic over a
field-ops table, instantiated for Fp (G1, `FP_OPS`) and Fp2 (G2,
`F2_OPS`).  Every field op reaches kernel K1.

Layout: a point batch is ``[..., 3, *elem]`` with the coordinates stacked
just before the element axes; an element is ``[32, R]`` (Fp) or
``[2, 32, R]`` (Fp2), rows last.  A G2 batch ``[3, 2, 32, R]`` is the
``[6, 32, R]`` plane layout of the group-law kernels (ops/cuda_g2.py), a
G1 batch ``[3, 32, R]`` that of the pairing kernels (ops/cuda_pairing.py).
Per-row flags are ``[..., R]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from . import fp, tower
from ..tbls.ref.fields import FQ2, R


@dataclass(frozen=True)
class FieldOps:
    name: str
    elem_ndim: int  # trailing dims of one element batch, rows included
    add: Callable
    sub: Callable
    neg: Callable
    mul: Callable
    dbl: Callable
    mul_small: Callable
    inv: Callable
    is_zero: Callable
    eq: Callable
    select: Callable
    mul_many: Callable
    mul_b3: Callable     # ×3b (small-constant multiple; RCB formulas)
    one: Any             # 1 (numpy, element without the row axis)
    b: Any               # curve coefficient b (numpy)


def _fp_mul_b3(x):
    return fp.mul_small(x, 12)          # 3·b = 12 on G1


def _f2_mul_b3(x):
    return tower.f2_mul_small(tower.f2_mul_by_xi(x), 12)  # 3·4(1+u) = 12ξ


FP_OPS = FieldOps(
    name="fp", elem_ndim=2,
    add=fp.add, sub=fp.sub, neg=fp.neg, mul=fp.mul, dbl=fp.double,
    mul_small=fp.mul_small, inv=fp.inv, is_zero=fp.is_zero, eq=fp.eq,
    select=fp.select, mul_many=fp.mul_many, mul_b3=_fp_mul_b3,
    one=fp.ONE,
    b=fp.to_limbs(4),                        # y² = x³ + 4
)

F2_OPS = FieldOps(
    name="fp2", elem_ndim=3,
    add=tower.f2_add, sub=tower.f2_sub, neg=tower.f2_neg, mul=tower.f2_mul,
    dbl=tower.f2_double, mul_small=tower.f2_mul_small,
    inv=tower.f2_inv, is_zero=tower.f2_is_zero, eq=tower.f2_eq,
    select=tower.f2_select, mul_many=tower.f2_mul_many,
    mul_b3=_f2_mul_b3,
    one=tower.F2_ONE,
    b=tower.f2_pack([FQ2([4, 4])])[..., 0],  # twist: y² = x³ + 4(u+1)
)


# ---------------------------------------------------------------------------
# Point helpers
# ---------------------------------------------------------------------------

def _coords(F: FieldOps, pt: torch.Tensor):
    return pt.unbind(-(F.elem_ndim + 1))


def make_point(F: FieldOps, x, y, z) -> torch.Tensor:
    return torch.stack([x, y, z], dim=-(F.elem_ndim + 1))


def _row_cond(cond: torch.Tensor, inner: int) -> torch.Tensor:
    """[..., R] flags → [..., 1 × inner, R], broadcastable over the
    `inner` axes that sit between the batch axes and the row axis."""
    return cond.reshape(*cond.shape[:-1], *([1] * inner), cond.shape[-1])


def point_select(F: FieldOps, cond, a, b):
    return torch.where(_row_cond(cond, F.elem_ndim), a, b)


def _one(F: FieldOps, device) -> torch.Tensor:
    return fp.elem(F.one, device)


def inf_points(F: FieldOps, n: int, device) -> torch.Tensor:
    """n points at infinity (0 : 1 : 0) as a [3, *elem] batch of n rows."""
    one = _one(F, device)
    pt = torch.stack([torch.zeros_like(one), one, torch.zeros_like(one)])
    return pt.expand(*pt.shape[:-1], n).contiguous()


def is_inf(F: FieldOps, pt) -> torch.Tensor:
    _, _, z = _coords(F, pt)
    return F.is_zero(z)


def from_affine(F: FieldOps, x, y, inf=None):
    """(x, y) → (x : y : 1); rows flagged `inf` become exactly (0 : 1 : 0)
    (the complete formulas need genuine curve points)."""
    one = _one(F, x.device).expand(x.shape)
    zero = torch.zeros_like(x)
    if inf is None:
        return make_point(F, x, y, one)
    return make_point(F, F.select(inf, zero, x), F.select(inf, one, y),
                      F.select(inf, zero, one))


def neg_point(F: FieldOps, pt):
    x, y, z = _coords(F, pt)
    return make_point(F, x, F.neg(y), z)


def double_point(F: FieldOps, pt):
    """COMPLETE doubling, RCB16 Algorithm 9 (a = 0)."""
    x, y, z = _coords(F, pt)
    yy, yz, zz, xy = F.mul_many([(y, y), (y, z), (z, z), (x, y)])
    bzz = F.mul_b3(zz)                       # 3b·Z²
    e8 = F.mul_small(yy, 8)                  # 8Y²
    s = F.add(yy, bzz)                       # Y² + 3bZ²
    d = F.sub(yy, F.mul_small(bzz, 3))       # Y² − 9bZ²
    x3a, z3, y3a, x3b = F.mul_many(
        [(bzz, e8), (yz, e8), (d, s), (d, xy)])
    y3 = F.add(x3a, y3a)
    x3 = F.dbl(x3b)
    return make_point(F, x3, y3, z3)


def add_points(F: FieldOps, p1, p2):
    """COMPLETE addition, RCB16 Algorithm 7 (a = 0)."""
    x1, y1, z1 = _coords(F, p1)
    x2, y2, z2 = _coords(F, p2)
    t0, t1, t2, pxy, pyz, pxz = F.mul_many([
        (x1, x2), (y1, y2), (z1, z2),
        (F.add(x1, y1), F.add(x2, y2)),
        (F.add(y1, z1), F.add(y2, z2)),
        (F.add(x1, z1), F.add(x2, z2))])
    t3 = F.sub(pxy, F.add(t0, t1))           # X1Y2 + X2Y1
    t4 = F.sub(pyz, F.add(t1, t2))           # Y1Z2 + Y2Z1
    t5 = F.sub(pxz, F.add(t0, t2))           # X1Z2 + X2Z1
    m = F.mul_small(t0, 3)                   # 3·X1X2
    bz = F.mul_b3(t2)                        # 3b·Z1Z2
    s = F.add(t1, bz)                        # Y1Y2 + 3bZ1Z2
    d = F.sub(t1, bz)                        # Y1Y2 − 3bZ1Z2
    by = F.mul_b3(t5)                        # 3b·(X1Z2+X2Z1)
    x3a, x3b, y3a, y3b, z3a, z3b = F.mul_many([
        (t3, d), (t4, by), (d, s), (m, by), (t4, s), (t3, m)])
    return make_point(F, F.sub(x3a, x3b), F.add(y3a, y3b),
                      F.add(z3a, z3b))


def to_affine(F: FieldOps, pt):
    """Projective → affine (x, y, is_inf); ∞ maps to (0, 0, True)."""
    x, y, z = _coords(F, pt)
    zinv = F.inv(z)
    return F.mul(x, zinv), F.mul(y, zinv), F.is_zero(z)


def eq_points(F: FieldOps, p1, p2):
    """Group-element equality across projective representatives."""
    x1, y1, z1 = _coords(F, p1)
    x2, y2, z2 = _coords(F, p2)
    xa, xb, ya, yb = F.mul_many(
        [(x1, z2), (x2, z1), (y1, z2), (y2, z1)])
    i1, i2 = F.is_zero(z1), F.is_zero(z2)
    return (i1 & i2) | (~i1 & ~i2 & F.eq(xa, xb) & F.eq(ya, yb))


# ---------------------------------------------------------------------------
# Scalar multiplication
# ---------------------------------------------------------------------------

def scalars_to_bits(scalars) -> np.ndarray:
    """Host: list of ints (mod R) → [len, 256] int32 bit planes, MSB first
    (the JAX package's layout; `scalar_mul` takes the transpose)."""
    raw = np.stack([
        np.frombuffer((int(s) % R).to_bytes(32, "big"), np.uint8)
        for s in scalars])
    return np.unpackbits(raw, axis=-1).astype(np.int32)


def scalar_mul(F: FieldOps, pt, bits: torch.Tensor):
    """Batched 2-bit-windowed double-and-add, MSB first.  `pt` [3, *elem]
    over R rows, `bits` [nbits, R] int32 (bit-major).  Per window: two
    complete doublings and ONE complete addition of a table entry from
    {∞, P, 2P, 3P} — adding ∞ is a no-op of the complete formulas."""
    nbits = bits.shape[0]
    if nbits % 2:
        bits = torch.cat([bits.new_zeros((1,) + tuple(bits.shape[1:])), bits])
        nbits += 1
    inf = inf_points(F, pt.shape[-1], pt.device)
    p2 = double_point(F, pt)
    p3 = add_points(F, p2, pt)
    acc = inf
    for i in range(nbits // 2):
        acc = double_point(F, double_point(F, acc))
        w = bits[2 * i] * 2 + bits[2 * i + 1]
        addend = point_select(F, w == 1, pt,
                              point_select(F, w == 2, p2,
                                           point_select(F, w == 3, p3, inf)))
        acc = add_points(F, acc, addend)
    return acc


# ---------------------------------------------------------------------------
# Host conversions (oracle points ↔ limb planes)
# ---------------------------------------------------------------------------

def g1_pack(pts) -> np.ndarray:
    """Host: oracle G1 affine points (None → ∞) → [3, 32, len]."""
    out = np.zeros((len(pts), 3, fp.NLIMBS), np.int32)
    for n, pt in enumerate(pts):
        if pt is None:
            out[n, 1] = fp.ONE
        else:
            out[n, 0] = fp.to_limbs(pt[0].n)
            out[n, 1] = fp.to_limbs(pt[1].n)
            out[n, 2] = fp.ONE
    return np.ascontiguousarray(np.moveaxis(out, 0, -1))


def g2_pack(pts) -> np.ndarray:
    """Host: oracle G2 affine points (None → ∞) → [3, 2, 32, len]."""
    out = np.zeros((len(pts), 3, 2, fp.NLIMBS), np.int32)
    for n, pt in enumerate(pts):
        if pt is None:
            out[n, 1] = tower.F2_ONE
        else:
            out[n, 0] = tower.f2_pack([pt[0]])[..., 0]
            out[n, 1] = tower.f2_pack([pt[1]])[..., 0]
            out[n, 2] = tower.F2_ONE
    return np.ascontiguousarray(np.moveaxis(out, 0, -1))
