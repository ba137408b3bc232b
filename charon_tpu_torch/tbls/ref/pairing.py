"""Optimal ate pairing on BLS12-381 (pure-Python oracle).

A copy of the JAX package's oracle (tbls/ref/pairing.py), so the port
imports nothing of that package.

e : G1 × G2 → GT ⊂ Fp12*, computed as miller_loop(untwist(Q), cast(P))
followed by the final exponentiation f^((p^12-1)/r).

This is the op the reference performs twice per signature verification
(reference: tbls/tss.go:200-217 Verify) and which the device backends batch
into fused multi-pairing kernels (BASELINE.md north star).

Known limitation (zero-egress build): no external GT known-answer vector is
available, so the *sign* convention of the pairing (e vs e^-1, i.e. whether
the negative-x conjugation is applied once) is pinned only by convention,
not by a published vector.  Signature verification is sign-agnostic — it
only ever checks products of pairings against 1 — so all framework
behaviour is unaffected either way.
"""

from __future__ import annotations

from .curve import Point, add, double
from .fields import (FQ2, FQ12, P, R, W2_INV, W3_INV, BLS_X,
                     BLS_X_IS_NEGATIVE, fq2_to_fq12)

FINAL_EXP = (P**12 - 1) // R

# Bits of |x| from the second-most-significant down, precomputed once.
_LOOP_BITS = [int(b) for b in bin(BLS_X)[3:]]


def untwist(pt: Point) -> Point:
    """Map a point on the M-twist E'/Fp2 into E(Fp12): (x, y) → (x/w^2, y/w^3)."""
    if pt is None:
        return None
    x, y = pt
    return (fq2_to_fq12(x) * W2_INV, fq2_to_fq12(y) * W3_INV)


def cast_g1(pt: Point) -> Point:
    """Embed a G1 point into E(Fp12)."""
    if pt is None:
        return None
    x, y = pt
    return (FQ12([x.n] + [0] * 11), FQ12([y.n] + [0] * 11))


def _linefunc(p1: Point, p2: Point, t: Point) -> FQ12:
    """Evaluate the line through p1, p2 at t (all in E(Fp12), affine)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (3 * (x1 * x1)) / (2 * y1)
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def miller_loop(q: Point, p: Point) -> FQ12:
    """f_{|x|,Q}(P); conjugated at the end because the BLS parameter is negative."""
    if q is None or p is None:
        return FQ12.one()
    r = q
    f = FQ12.one()
    for bit in _LOOP_BITS:
        f = f * f * _linefunc(r, r, p)
        r = double(r)
        if bit:
            f = f * _linefunc(r, q, p)
            r = add(r, q)
    if BLS_X_IS_NEGATIVE:
        f = f.conjugate_p6()  # f^(p^6) ≡ f^-1 after the final exponentiation
    return f


def final_exponentiate(f: FQ12) -> FQ12:
    return f**FINAL_EXP


def pairing(p: Point, q: Point, *, final_exp: bool = True) -> FQ12:
    """e(P, Q) with P ∈ G1(E/Fp), Q ∈ G2(E'/Fp2) — G1-first, matching the
    (P_i, Q_i) pair order of multi_pairing_is_one."""
    if q is not None and not isinstance(q[0], FQ2):
        raise TypeError("pairing(p, q) takes the G1 point first, G2 second")
    f = miller_loop(untwist(q), cast_g1(p))
    return final_exponentiate(f) if final_exp else f


def multi_pairing_is_one(pairs: list[tuple[Point, Point]]) -> bool:
    """Check Π e(P_i, Q_i) == 1 with a single shared final exponentiation.

    This product-of-pairings form is the core of batched verification: one
    signature verify is e(-g1, sig)·e(pk, H(m)) == 1 (2 Miller loops, one
    final exp), and random-linear-combination batches collapse further.
    """
    f = FQ12.one()
    for p, q in pairs:
        if p is None or q is None:
            continue
        f = f * miller_loop(untwist(q), cast_g1(p))
    if f == FQ12.one():
        return True
    return final_exponentiate(f) == FQ12.one()
