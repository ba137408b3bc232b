"""Batched ZCash point (de)serialisation — bytes on the host, square roots
on the device.  The port of the JAX package's ops/codec.py (G1 and G2).

The host does only vectorised numpy bit shuffles (48-byte pubkeys and
96-byte signatures ↔ 12-bit limb planes, no per-element Python); the
expensive part of decompression — y as a square root by fixed-exponent
pows, then the subgroup check ([r]P = ∞ on G1, ψ(Q) = [z]Q on G2) — runs
on the device, batched over all points, and every field op there is a
launch of kernel K1.

Host helpers keep the JAX package's limb-last numpy layout (``[N, 32]``);
device functions take and return port-layout tensors (``[32, R]``
elements, ``[3, 2, 32, R]`` points, ``[R]`` flags).
"""

from __future__ import annotations

import numpy as np
import torch

from . import fp, tower
from . import curve as tcurve
from .curve import F2_OPS, FP_OPS, from_affine, to_affine
from ..tbls.ref import curve as refcurve
from ..tbls.ref.fields import BLS_X, FQ2, P, R

# ---------------------------------------------------------------------------
# Host-side vectorised byte ↔ limb conversion (numpy, limb-last)
# ---------------------------------------------------------------------------

_C_FLAG, _I_FLAG, _S_FLAG = 0x80, 0x40, 0x20
_P_LIMBS = fp.to_limbs(P)
_HALF_LIMBS = fp.to_limbs((P - 1) // 2)  # sgn(v): v > (p-1)/2
_W12 = (1 << np.arange(fp.LIMB_BITS, dtype=np.int64)).astype(np.int32)


def bytes48_to_limbs(raw: np.ndarray) -> np.ndarray:
    """[..., 48] uint8 big-endian → [..., 32] int32 little-endian limbs."""
    bits_le = np.unpackbits(raw, axis=-1)[..., ::-1]
    shaped = bits_le.reshape(*raw.shape[:-1], fp.NLIMBS, fp.LIMB_BITS)
    return (shaped.astype(np.int32) * _W12).sum(-1, dtype=np.int32)


def limbs_to_bytes48(limbs: np.ndarray) -> np.ndarray:
    """[..., 32] int32 limbs → [..., 48] uint8 big-endian."""
    bits_le = ((limbs[..., :, None] >> np.arange(fp.LIMB_BITS)) & 1).astype(
        np.uint8)
    bits_be = bits_le.reshape(*limbs.shape[:-1], 48 * 8)[..., ::-1]
    return np.packbits(bits_be, axis=-1)


def _limbs_cmp_const(a: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Sign of (a − c) per row for a [..., 32] batch vs a constant."""
    neq = a != c
    idx = (fp.NLIMBS - 1) - np.argmax(neq[..., ::-1], axis=-1)
    picked_a = np.take_along_axis(a, idx[..., None], -1)[..., 0]
    out = np.sign(picked_a - c[idx])
    out[~neq.any(-1)] = 0
    return out


def limbs_lt_p(a: np.ndarray) -> np.ndarray:
    return _limbs_cmp_const(a, _P_LIMBS) < 0


def limbs_sgn(a: np.ndarray) -> np.ndarray:
    """ZCash lexicographic sign of a standard-form Fp element."""
    return _limbs_cmp_const(a, _HALF_LIMBS) > 0


def g1_bytes_split(raw: np.ndarray):
    """[N, 48] uint8 → (x [N, 32], sign [N], inf [N], bad [N])."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    flags = raw[:, 0]
    c = (flags & _C_FLAG) != 0
    i = (flags & _I_FLAG) != 0
    s = (flags & _S_FLAG) != 0
    data = raw.copy()
    data[:, 0] &= 0x1F
    x = bytes48_to_limbs(data)
    bad = ~c
    bad |= i & (s | (x != 0).any(-1))
    bad |= ~i & ~limbs_lt_p(x)
    return x, s, i, bad


def g2_bytes_split(raw: np.ndarray):
    """[N, 96] uint8 → (xc0, xc1 [N, 32], sign [N], inf [N], bad [N])."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    flags = raw[:, 0]
    c = (flags & _C_FLAG) != 0
    i = (flags & _I_FLAG) != 0
    s = (flags & _S_FLAG) != 0
    hi = raw[:, :48].copy()
    hi[:, 0] &= 0x1F
    xc1 = bytes48_to_limbs(hi)
    xc0 = bytes48_to_limbs(raw[:, 48:])
    bad = ~c
    bad |= i & (s | (xc1 != 0).any(-1) | (xc0 != 0).any(-1))
    bad |= ~i & ~(limbs_lt_p(xc0) & limbs_lt_p(xc1))
    return xc0, xc1, s, i, bad


def g1_assemble(x_std: np.ndarray, y_sgn: np.ndarray,
                inf: np.ndarray) -> np.ndarray:
    """Std-form affine x limbs + y sign + inf → [N, 48] uint8 compressed."""
    out = limbs_to_bytes48(x_std)
    out[:, 0] |= _C_FLAG | np.where(y_sgn, _S_FLAG, 0).astype(np.uint8)
    out[inf] = 0
    out[inf, 0] = _C_FLAG | _I_FLAG
    return out


def g2_assemble(xc0_std: np.ndarray, xc1_std: np.ndarray, y_sgn: np.ndarray,
                inf: np.ndarray) -> np.ndarray:
    out = np.concatenate([limbs_to_bytes48(xc1_std),
                          limbs_to_bytes48(xc0_std)], axis=-1)
    out[:, 0] |= _C_FLAG | np.where(y_sgn, _S_FLAG, 0).astype(np.uint8)
    out[inf] = 0
    out[inf, 0] = _C_FLAG | _I_FLAG
    return out


def fp2_sgn_np(c0_std: np.ndarray, c1_std: np.ndarray) -> np.ndarray:
    """Vectorised ZCash sign of an Fp2 value from standard-form limbs."""
    c1_zero = (c1_std == 0).all(-1)
    return np.where(c1_zero, limbs_sgn(c0_std), limbs_sgn(c1_std))


def g2_compress_np(xc0, xc1, yc0, yc1, inf) -> np.ndarray:
    """numpy std-form affine limb planes [N, 32] → [N, 96] compressed."""
    sgn = fp2_sgn_np(np.asarray(yc0), np.asarray(yc1))
    return g2_assemble(np.asarray(xc0), np.asarray(xc1), sgn, np.asarray(inf))


def g1_compress_np(x, y, inf) -> np.ndarray:
    """numpy std-form affine limb planes [N, 32] → [N, 48] compressed."""
    return g1_assemble(np.asarray(x), limbs_sgn(np.asarray(y)),
                       np.asarray(inf))


# ---------------------------------------------------------------------------
# Device square roots
# ---------------------------------------------------------------------------

def fp_sqrt(a: torch.Tensor):
    """Batched Fp square root: p ≡ 3 mod 4 ⇒ candidate a^((p+1)/4).
    Returns (root, ok); root is garbage where ok is False."""
    root = fp.pow_fixed(a, (P + 1) // 4)
    return root, fp.eq(fp.sqr(root), a)


_F2_MINUS_ONE = np.stack([fp.to_limbs(P - 1), fp.ZERO])


def f2_sqrt(a: torch.Tensor):
    """Batched Fp2 square root, Alg. 9 of Adj & Rodríguez-Henríquez (2012)
    for p ≡ 3 mod 4 — two fixed-exponent pows, branch-free:

        a1 = a^((p−3)/4);  α = a1²·a;  x0 = a1·a
        α = −1 → root = u·x0;  else → root = (α+1)^((p−1)/2) · x0

    Returns (root, ok); root is garbage where ok is False."""
    a1 = tower.f2_pow_fixed(a, (P - 3) // 4)
    alpha = tower.f2_mul(tower.f2_sqr(a1), a)
    x0 = tower.f2_mul(a1, a)
    root_u = tower.f2(fp.neg(x0[..., 1, :, :]), x0[..., 0, :, :])
    b = tower.f2_pow_fixed(
        tower.f2_add(alpha, fp.elem(tower.F2_ONE, a.device)),
        (P - 1) // 2)
    root_b = tower.f2_mul(b, x0)
    is_m1 = tower.f2_eq(alpha, fp.elem(_F2_MINUS_ONE, a.device))
    root = tower.f2_select(is_m1, root_u, root_b)
    ok = tower.f2_eq(tower.f2_sqr(root), a)
    return root, ok


# ---------------------------------------------------------------------------
# Subgroup membership: Q ∈ G2 ⟺ ψ(Q) = [z]Q, z the BLS parameter, with
# ψ(x, y) = (c_x·x̄ᵖ, c_y·ȳᵖ).  The constants and the sign of z are DERIVED
# from the oracle at import and checked on subgroup points and on a
# cofactor point — nothing is trusted from memory.
# ---------------------------------------------------------------------------

def _find_g2_cofactor_point():
    """An on-curve E'(Fp2) point NOT in the r-order subgroup."""
    x = 1
    while True:
        xf = FQ2([x, 0])
        y = (xf * xf * xf + refcurve.B2).sqrt()
        if y is not None:
            pt = (xf, y)
            if refcurve.multiply_raw(pt, R) is not None:
                return pt
        x += 1


def _derive_psi_constants():
    g = refcurve.G2_GEN
    cofactor_pt = _find_g2_cofactor_point()
    for z_signed in (-BLS_X, BLS_X):
        target = refcurve.multiply(g, z_signed % R)
        cx = target[0] / g[0].frobenius()
        cy = target[1] / g[1].frobenius()

        def psi(q):
            return (cx * q[0].frobenius(), cy * q[1].frobenius())

        ok = all(
            psi(q) == refcurve.multiply(q, z_signed % R)
            for q in (refcurve.multiply(g, 12345),
                      refcurve.multiply(g, 2**200 + 7)))
        if ok and psi(cofactor_pt) != refcurve.multiply(
                cofactor_pt, z_signed % R):
            return cx, cy, z_signed
    raise AssertionError("could not derive a valid psi-endomorphism check")


_PSI_CX, _PSI_CY, _Z_SIGNED = _derive_psi_constants()
_PSI_CX_M = tower.f2_pack([_PSI_CX])[..., 0]
_PSI_CY_M = tower.f2_pack([_PSI_CY])[..., 0]
_ABS_Z_BITS = np.array([(abs(_Z_SIGNED) >> (63 - i)) & 1 for i in range(64)],
                       np.int32)
_R_BITS = np.array([(R >> (254 - i)) & 1 for i in range(255)], np.int32)


def g2_psi(pt: torch.Tensor) -> torch.Tensor:
    """ψ on projective coords: (c_x·X̄ : c_y·Ȳ : Z̄)."""
    x, y, z = tcurve._coords(F2_OPS, pt)
    return tcurve.make_point(
        F2_OPS,
        tower.f2_mul(fp.elem(_PSI_CX_M, pt.device), tower.f2_conj(x)),
        tower.f2_mul(fp.elem(_PSI_CY_M, pt.device), tower.f2_conj(y)),
        tower.f2_conj(z))


def g2_in_subgroup(pt: torch.Tensor) -> torch.Tensor:
    """Batched ψ(Q) == [z]Q check over [3, 2, 32, R] (True at ∞)."""
    bits = fp.const(_ABS_Z_BITS, pt.device).unsqueeze(-1).expand(
        64, pt.shape[-1])
    zq = tcurve.scalar_mul(F2_OPS, pt, bits)
    if _Z_SIGNED < 0:
        zq = tcurve.neg_point(F2_OPS, zq)
    return tcurve.eq_points(F2_OPS, g2_psi(pt), zq)


def g1_in_subgroup(pt: torch.Tensor) -> torch.Tensor:
    """Batched [r]P == ∞ check over [3, 32, R] (E(Fp)[r] is exactly G1)."""
    bits = fp.const(_R_BITS, pt.device).unsqueeze(-1).expand(
        255, pt.shape[-1])
    return tcurve.is_inf(FP_OPS, tcurve.scalar_mul(FP_OPS, pt, bits))


# ---------------------------------------------------------------------------
# Device decompression and normalisation
# ---------------------------------------------------------------------------

def limbs_sgn_device(a_std: torch.Tensor) -> torch.Tensor:
    """Device ZCash sign of a standard-form element: a > (p−1)/2."""
    return fp.sgn(a_std)


def g1_decompress(x_std: torch.Tensor, sign: torch.Tensor, inf: torch.Tensor,
                  subgroup_check: bool = True):
    """Std-form x limb planes [32, R] + sign/inf flags [R] → (projective
    points [3, 32, R], ok [R]).  ok is False for an x off the curve and,
    by default, for a point outside G1 — the oracle deserialiser's rule."""
    rhs = fp.add(fp.mul(fp.sqr(x_std), x_std), fp.elem(FP_OPS.b, x_std.device))
    y, ok = fp_sqrt(rhs)
    flip = limbs_sgn_device(fp.canon_std(y)) != sign
    y = fp.select(flip, fp.neg(y), y)
    pt = from_affine(FP_OPS, x_std, y, inf=inf)
    ok = ok | inf
    if subgroup_check:
        ok = ok & g1_in_subgroup(pt)
    return pt, ok


def g2_decompress(xc0_std: torch.Tensor, xc1_std: torch.Tensor,
                  sign: torch.Tensor, inf: torch.Tensor,
                  subgroup_check: bool = True):
    """Std-form x = c0 + c1·u limb planes [32, R] + sign/inf flags [R] →
    (projective points [3, 2, 32, R], ok [R]).  ok is False for an x
    off the curve and, by default, for a point outside G2."""
    x = tower.f2(xc0_std, xc1_std)
    rhs = tower.f2_add(tower.f2_mul(tower.f2_sqr(x), x),
                       fp.elem(F2_OPS.b, x.device))
    y, ok = f2_sqrt(rhs)
    y0_std = fp.canon_std(y[..., 0, :, :])
    y1_std = fp.canon_std(y[..., 1, :, :])
    cur = torch.where(fp.is_zero(y1_std), fp.sgn(y0_std), fp.sgn(y1_std))
    y = tower.f2_select(cur != sign, tower.f2_neg(y), y)
    pt = from_affine(F2_OPS, x, y, inf=inf)
    ok = ok | inf
    if subgroup_check:
        ok = ok & g2_in_subgroup(pt)
    return pt, ok


def g1_normalize(pt: torch.Tensor):
    """Projective [3, 32, R] → (x std, y std [32, R], inf [R])."""
    x, y, inf = to_affine(FP_OPS, pt)
    return fp.canon_std(x), fp.canon_std(y), inf


def g2_normalize(pt: torch.Tensor):
    """Projective [3, 2, 32, R] → (xc0, xc1, yc0, yc1 std [32, R], inf [R])."""
    x, y, inf = to_affine(F2_OPS, pt)
    return (fp.canon_std(x[..., 0, :, :]), fp.canon_std(x[..., 1, :, :]),
            fp.canon_std(y[..., 0, :, :]), fp.canon_std(y[..., 1, :, :]), inf)
