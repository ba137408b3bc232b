"""Batched optimal-ate pairing on BLS12-381 in PyTorch: plain tower code.

The port of the JAX package's ops/pairing.py.  Every field op reaches
kernel K1 through `tower`/`fp`; the fused Miller kernels (K4/K5,
ops/cuda_pairing.py) serve the batch check and K11 (ops/cuda_final_exp.py)
its final exponentiation.  This module serves the per-row re-check after a
failed batch equation (its Miller loop here, its final exponentiation
through K11) and the reference copy of the JAX functions
(`final_exponentiate`, `pairing`).

- Miller loop over the static bits of |z| (z the negative BLS parameter):
  the G2 accumulator in homogeneous projective coordinates on the
  M-twist, lines as sparse (c0, c1, c4) Fp2 triples for
  `tower.f12_mul_by_014`, scaled by 2YZ² (doubling) / δ (addition) — Fp2
  factors the final exponentiation annihilates.  The addition step runs
  only on the 5 set bits (the JAX fori_loop computes it every step and
  selects: the rows agree bit for bit).
- Final exponentiation: the easy part f^((p⁶−1)(p²+1)), then the hard
  part to the power 3·(p⁴−p²+1)/r = (z−1)²·(z+p)·(z²+p²−1) + 3; the
  extra cube is harmless for is-one checks since gcd(3, r) = 1.

Layout: G1 points ``[..., 3, 32, R]``, G2 points ``[..., 3, 2, 32, R]``
(packed: Z plane 1 for affine, 0 for ∞), Fp12 ``[..., 2, 3, 2, 32, R]``.
Correctness oracle: charon_tpu_torch.tbls.ref.pairing (result == oracle³).
"""

from __future__ import annotations

import torch

from . import cuda_final_exp, fp
from .tower import (F12_ONE, F2_ONE, f2_mul_fp, f2_mul_many, f2_mul_small,
                    f2_add, f2_sub, f12_conj, f12_eq, f12_frob, f12_inv,
                    f12_mul, f12_mul_by_014, f12_select, f12_sqr)
from ..tbls.ref.fields import BLS_X

# Bits of |z| below the leading one, MSB first — the Miller loop schedule
# and the exponent of `_exp_abs_z`.
_LOOP_BITS = [int(b) for b in bin(BLS_X)[3:]]


def _dbl_step(X, Y, Z):
    """Projective doubling on the twist (EFD dbl-2007-bl, a=0) + the line
    through 2·R at P, scaled by 2YZ²:
        c0 = 2Y²Z − 3X³, c1 = 3X²Z·xP, c4 = −2YZ²·yP
    (the c1/c4 bases are returned; `_ell` scales them by xP and −yP)."""
    XX, YY, s, XY = f2_mul_many([(X, X), (Y, Y), (Y, Z), (X, Y)])
    w = f2_mul_small(XX, 3)            # 3X²
    ss, B, c1b, wX, YYZ, sZ = f2_mul_many(
        [(s, s), (XY, s), (w, Z), (w, X), (YY, Z), (s, Z)])
    wsq, YYss, sss = f2_mul_many([(w, w), (YY, ss), (s, ss)])
    h = f2_sub(wsq, f2_mul_small(B, 8))
    hs, wterm = f2_mul_many([(h, s), (w, f2_sub(f2_mul_small(B, 4), h))])
    X3 = f2_mul_small(hs, 2)
    Y3 = f2_sub(wterm, f2_mul_small(YYss, 8))
    Z3 = f2_mul_small(sss, 8)
    c0 = f2_sub(f2_mul_small(YYZ, 2), wX)
    c4b = f2_mul_small(sZ, 2)
    return (X3, Y3, Z3), c0, c1b, c4b


def _add_step(X1, Y1, Z1, x2, y2):
    """Mixed addition R + Q (Q affine) + the line, scaled by δ:
        θ = Y1 − y2·Z1, δ = X1 − x2·Z1
        c0 = δ·y2 − θ·x2, c1 = θ·xP, c4 = −δ·yP."""
    yZ, xZ = f2_mul_many([(y2, Z1), (x2, Z1)])
    theta = f2_sub(Y1, yZ)
    delta = f2_sub(X1, xZ)
    c, d, dy, tx = f2_mul_many(
        [(theta, theta), (delta, delta), (delta, y2), (theta, x2)])
    e, f_, g = f2_mul_many([(delta, d), (Z1, c), (X1, d)])
    h = f2_sub(f2_add(e, f_), f2_mul_small(g, 2))
    X3, t, eY, Z3 = f2_mul_many(
        [(delta, h), (theta, f2_sub(g, h)), (e, Y1), (Z1, e)])
    Y3 = f2_sub(t, eY)
    c0 = f2_sub(dy, tx)
    return (X3, Y3, Z3), c0, theta, delta


def _ell(f, c0, c1b, c4b, xp, yp_neg):
    """f times the sparse line value."""
    return f12_mul_by_014(f, c0, f2_mul_fp(c1b, xp), f2_mul_fp(c4b, yp_neg))


def _bcast(x: torch.Tensor, shape) -> torch.Tensor:
    return x.expand(shape).contiguous()


def miller_loop(p_g1: torch.Tensor, q_g2: torch.Tensor) -> torch.Tensor:
    """f_{|z|,Q}(P), conjugated for the negative BLS parameter — the
    oracle's miller_loop up to an Fp2 factor the final exponentiation
    kills.  `p_g1` [..., 3, 32, R], `q_g2` [..., 3, 2, 32, R]: packed
    points whose Z plane is 1 (affine) or 0 (∞); pairs with an ∞ member
    give 1."""
    xp, yp = p_g1[..., 0, :, :], p_g1[..., 1, :, :]
    p_inf = fp.is_zero(p_g1[..., 2, :, :])
    x2, y2 = q_g2[..., 0, :, :, :], q_g2[..., 1, :, :, :]
    q_inf = torch.all(torch.all(q_g2[..., 2, :, :, :] == 0, dim=-2), dim=-2)
    yp_neg = fp.neg(yp)
    dev = p_g1.device
    # element batch: the leading axes of both sides, rows last
    lead = torch.broadcast_shapes(xp.shape[:-2], x2.shape[:-3])
    r = max(xp.shape[-1], x2.shape[-1])
    f2_shape = lead + (2, fp.NLIMBS, r)
    f = _bcast(fp.elem(F12_ONE, dev), lead + (2, 3) + f2_shape[-3:])
    X, Y = _bcast(x2, f2_shape), _bcast(y2, f2_shape)
    Z = _bcast(fp.elem(F2_ONE, dev), f2_shape)
    for bit in _LOOP_BITS:
        f = f12_sqr(f)
        (X, Y, Z), c0, c1b, c4b = _dbl_step(X, Y, Z)
        f = _ell(f, c0, c1b, c4b, xp, yp_neg)
        if bit:
            (X, Y, Z), c0, c1b, c4b = _add_step(X, Y, Z, x2, y2)
            f = _ell(f, c0, c1b, c4b, xp, yp_neg)
    f = f12_conj(f)                     # negative parameter
    return f12_select(p_inf | q_inf, fp.elem(F12_ONE, dev), f)


def _exp_abs_z(g: torch.Tensor) -> torch.Tensor:
    """g^|z| by square-and-multiply over the parameter's bits (plain Fp12
    squaring; the cyclotomic square is a later optimisation)."""
    acc = g
    for bit in _LOOP_BITS:
        acc = f12_sqr(acc)
        if bit:
            acc = f12_mul(acc, g)
    return acc


def _exp_z(g: torch.Tensor) -> torch.Tensor:
    """g^z for the negative parameter; g cyclotomic, so the inverse is
    the conjugate."""
    return f12_conj(_exp_abs_z(g))


def final_exponentiate(f: torch.Tensor) -> torch.Tensor:
    """f^(3·(p¹²−1)/r) — the oracle's final exponentiation, cubed."""
    f = f12_mul(f12_conj(f), f12_inv(f))            # ^(p⁶−1)
    f = f12_mul(f12_frob(f12_frob(f)), f)           # ^(p²+1): cyclotomic
    t0 = f12_mul(_exp_z(f), f12_conj(f))            # f^(z−1)
    t1 = f12_mul(_exp_z(t0), f12_conj(t0))          # f^(z−1)²
    t2 = f12_mul(_exp_z(t1), f12_frob(t1))          # f^((z−1)²(z+p))
    t3 = _exp_z(_exp_z(t2))                         # ^z²
    t5 = f12_mul(f12_mul(t3, f12_frob(f12_frob(t2))), f12_conj(t2))
    f3 = f12_mul(f12_sqr(f), f)
    return f12_mul(t5, f3)


def pairing(p_g1: torch.Tensor, q_g2: torch.Tensor) -> torch.Tensor:
    """e(P, Q)³ ∈ GT, batched (the cube is transparent to every equality
    and product-is-one use)."""
    return final_exponentiate(miller_loop(p_g1, q_g2))


def is_one(f: torch.Tensor) -> torch.Tensor:
    """f == 1 in Fp12 → [..., R] bool."""
    return f12_eq(f, fp.elem(F12_ONE, f.device))


def pairing_product_is_one(ps: torch.Tensor, qs: torch.Tensor
                           ) -> torch.Tensor:
    """Π_k e(P_k, Q_k) == 1 with one shared final exponentiation per row —
    the per-row verification primitive (oracle:
    ref.pairing.multi_pairing_is_one).  `ps` [K, 3, 32, R], `qs`
    [K, 3, 2, 32, R], the product over the leading pair axis → [R] bool.
    The final exponentiation is K11's (`cuda_final_exp.final_exp`: one
    launch over the rows on the card)."""
    prod = miller_loop(ps, qs)
    k = prod.shape[0]
    while k > 1:
        half = k // 2
        prod = torch.cat([f12_mul(prod[:half], prod[half:2 * half]),
                          prod[2 * half:k]])
        k = half + (k - 2 * half)
    return is_one(cuda_final_exp.final_exp(prod[0].contiguous()))
