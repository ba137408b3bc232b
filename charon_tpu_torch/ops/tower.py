"""Batched BLS12-381 extension-field tower in PyTorch: Fp2 → Fp6 → Fp12 —
the port of the JAX package's ops/tower.py.

    Fp2  = Fp[u]/(u² + 1)               [..., 2, 32, R]
    Fp6  = Fp2[v]/(v³ − ξ), ξ = u + 1   [..., 3, 2, 32, R]
    Fp12 = Fp6[w]/(w² − v)              [..., 2, 3, 2, 32, R]

Coefficient axes, then the limb axis, then rows (see ops/fp.py for the
layout); an Fp12 batch reshaped to ``[12, 32, R]`` is the pairing
kernels' plane stack (plane m = (k·3 + j)·2 + c).  Every op reaches the
K1 kernel through `fp`; the independent products of one formula are
stacked into one multiplier launch, as the JAX package batches them, and
each op is bit-identical to its JAX counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fp
from ..tbls.ref.fields import FQ2, FQ12, P

f2_add = fp.add
f2_sub = fp.sub
f2_neg = fp.neg
f2_double = fp.double


def f2(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    return torch.stack([c0, c1], dim=-3)


def _c(a: torch.Tensor, i: int) -> torch.Tensor:
    return a[..., i, :, :]


def f2_mul_many(pairs: list[tuple[torch.Tensor, torch.Tensor]]
                ) -> list[torch.Tensor]:
    """K independent Fp2 Karatsuba products through ONE fp multiplier
    launch (3K stacked Fp products)."""
    k = len(pairs)
    shape = torch.broadcast_shapes(
        *[t.shape[:-3] + t.shape[-2:] for pr in pairs for t in pr])

    def stk(els):
        return torch.stack([e.expand(shape) for e in els])

    a0 = stk([_c(a, 0) for a, _ in pairs])                 # [K, ..., 32, R]
    a1 = stk([_c(a, 1) for a, _ in pairs])
    b0 = stk([_c(b, 0) for _, b in pairs])
    b1 = stk([_c(b, 1) for _, b in pairs])
    sa = fp.add(a0, a1)
    sb = fp.add(b0, b1)
    t = fp.mul(torch.cat([a0, a1, sa]), torch.cat([b0, b1, sb]))
    t0, t1, t2 = t[:k], t[k:2 * k], t[2 * k:]
    c0 = fp.sub(t0, t1)
    c1 = fp.sub(t2, fp.add(t0, t1))
    return [f2(c0[i], c1[i]) for i in range(k)]


def f2_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    [out] = f2_mul_many([(a, b)])
    return out


def _stack_bcast(els: list[torch.Tensor]) -> torch.Tensor:
    shape = torch.broadcast_shapes(*[e.shape for e in els])
    return torch.stack([e.expand(shape) for e in els])


def f2_sqr_many(els: list[torch.Tensor]) -> list[torch.Tensor]:
    """K independent Fp2 squarings (2K stacked Fp products)."""
    k = len(els)
    a0 = _stack_bcast([_c(a, 0) for a in els])
    a1 = _stack_bcast([_c(a, 1) for a in els])
    t = fp.mul(torch.cat([fp.add(a0, a1), a0]),
               torch.cat([fp.sub(a0, a1), a1]))
    return [f2(t[i], fp.double(t[k + i])) for i in range(k)]


def f2_mul_fp(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Both coefficients times an Fp scalar s [..., 32, R]: one fp product
    batched over the coefficient axis."""
    return fp.mul(a, s.unsqueeze(-3))


def f2_sqr(a: torch.Tensor) -> torch.Tensor:
    """(a0+a1)(a0−a1) + 2·a0·a1·u: two Fp products in one launch."""
    [out] = f2_sqr_many([a])
    return out


def f2_conj(a: torch.Tensor) -> torch.Tensor:
    return f2(_c(a, 0), fp.neg(_c(a, 1)))


def f2_mul_by_xi(a: torch.Tensor) -> torch.Tensor:
    """×ξ = (1 + u): (a0 − a1) + (a0 + a1)u."""
    a0, a1 = _c(a, 0), _c(a, 1)
    return f2(fp.sub(a0, a1), fp.add(a0, a1))


def f2_inv(a: torch.Tensor) -> torch.Tensor:
    a0, a1 = _c(a, 0), _c(a, 1)
    s0, s1 = fp.mul_many([(a0, a0), (a1, a1)])
    norm_inv = fp.inv(fp.add(s0, s1))
    t0, t1 = fp.mul_many([(a0, norm_inv), (a1, norm_inv)])
    return f2(t0, fp.neg(t1))


def f2_is_zero(a: torch.Tensor) -> torch.Tensor:
    return fp.is_zero(_c(a, 0)) & fp.is_zero(_c(a, 1))


def f2_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return f2_is_zero(f2_sub(a, b))


def f2_select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """cond ? a : b, cond shaped like the batch dims [..., R]."""
    return torch.where(cond.unsqueeze(-2).unsqueeze(-2), a, b)


def f2_mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    return torch.stack([fp.mul_small(_c(a, 0), k),
                        fp.mul_small(_c(a, 1), k)], dim=-3)


def f2_pow_fixed(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e in Fp2 for a host-known exponent (the device square root's
    building block).  As fp.pow_fixed: a zero bit squares only, a one bit
    multiplies and squares in one stacked launch — bit-identical rows to
    the JAX fori_loop."""
    one = fp.elem(F2_ONE, a.device).expand(a.shape).contiguous()
    if e == 0:
        return one
    result, base = one, a
    nbits = e.bit_length()
    for i in range(nbits):
        last = i == nbits - 1
        if (e >> i) & 1:
            if last:
                result = f2_mul(result, base)
            else:
                result, base = f2_mul_many([(result, base), (base, base)])
        elif not last:
            # the Karatsuba product base·base, as the JAX loop computes it
            # (f2_sqr reduces differently and would not be bit-identical)
            base = f2_mul(base, base)
    return result


# ---------------------------------------------------------------------------
# Fp6: a0 + a1·v + a2·v², v³ = ξ
# ---------------------------------------------------------------------------

def f6(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    return torch.stack([c0, c1, c2], dim=-4)


def _f6c(a: torch.Tensor):
    return a[..., 0, :, :, :], a[..., 1, :, :, :], a[..., 2, :, :, :]


f6_add = fp.add
f6_sub = fp.sub
f6_neg = fp.neg
f6_double = fp.double


def f6_mul_many(pairs: list[tuple[torch.Tensor, torch.Tensor]]
                ) -> list[torch.Tensor]:
    """K independent Fp6 products — 6K Fp2 Karatsuba products through one
    fp multiplier launch, the operand and result additions batched
    (Toom-style v0..v2 + three cross sums)."""
    k = len(pairs)
    cs = [(_f6c(a), _f6c(b)) for a, b in pairs]
    # operand sums, one batched add: (a1+a2),(b1+b2),(a0+a1),(b0+b1),
    # (a0+a2),(b0+b2)
    left = _stack_bcast(
        [x for (a, b) in cs for x in (a[1], b[1], a[0], b[0], a[0], b[0])])
    right = _stack_bcast(
        [x for (a, b) in cs for x in (a[2], b[2], a[1], b[1], a[2], b[2])])
    sums = fp.add(left, right)                      # [6K, ..., 2, 32, R]
    f2_pairs = []
    for i, ((a0, a1, a2), (b0, b1, b2)) in enumerate(cs):
        s = sums[6 * i:6 * i + 6]
        f2_pairs += [(a0, b0), (a1, b1), (a2, b2),
                     (s[0], s[1]), (s[2], s[3]), (s[4], s[5])]
    ts = f2_mul_many(f2_pairs)
    # t = cross − (v_x + v_y), then the ξ and plain additions, batched
    vx = _stack_bcast([ts[6 * i + j] for i in range(k) for j in (1, 0, 0)])
    vy = _stack_bcast([ts[6 * i + j] for i in range(k) for j in (2, 1, 2)])
    cross = _stack_bcast([ts[6 * i + j] for i in range(k) for j in (3, 4, 5)])
    t = fp.sub(cross, fp.add(vx, vy))               # [3K, ..., 2, 32, R]
    xi_in = _stack_bcast(
        [t[3 * i] for i in range(k)] + [ts[6 * i + 2] for i in range(k)])
    xi_out = f2_mul_by_xi(xi_in)                    # ξ·t12, ξ·v2
    base = _stack_bcast(
        [ts[6 * i] for i in range(k)]               # v0   (c0)
        + [t[3 * i + 1] for i in range(k)]          # t01  (c1)
        + [t[3 * i + 2] for i in range(k)])         # t02  (c2)
    addend = _stack_bcast(
        [xi_out[i] for i in range(k)]               # ξ·t12
        + [xi_out[k + i] for i in range(k)]         # ξ·v2
        + [ts[6 * i + 1] for i in range(k)])        # v1
    c = fp.add(base, addend)
    return [f6(c[i], c[k + i], c[2 * k + i]) for i in range(k)]


def f6_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    [out] = f6_mul_many([(a, b)])
    return out


def f6_sqr_many(els: list[torch.Tensor]) -> list[torch.Tensor]:
    return f6_mul_many([(a, a) for a in els])


def f6_mul_by_v(a: torch.Tensor) -> torch.Tensor:
    """×v: (ξ·a2, a0, a1)."""
    a0, a1, a2 = _f6c(a)
    return f6(f2_mul_by_xi(a2), a0, a1)


def f6_sqr(a: torch.Tensor) -> torch.Tensor:
    return f6_mul(a, a)


def f6_mul_by_01_many(triples: list[tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]]
                      ) -> list[torch.Tensor]:
    """K independent sparse (d0 + d1·v) products — 5K Fp2 products in one
    multiplier launch."""
    f2_pairs = []
    for a, d0, d1 in triples:
        a0, a1, a2 = _f6c(a)
        f2_pairs += [(a0, d0), (a1, d1), (f2_add(a1, a2), d1),
                     (f2_add(a0, a1), f2_add(d0, d1)), (f2_add(a0, a2), d0)]
    ts = f2_mul_many(f2_pairs)
    out = []
    for i in range(len(triples)):
        v0, v1, x12, x01, x02 = ts[5 * i:5 * i + 5]
        out.append(f6(f2_add(v0, f2_mul_by_xi(f2_sub(x12, v1))),
                      f2_sub(x01, f2_add(v0, v1)),
                      f2_add(f2_sub(x02, v0), v1)))
    return out


def f6_mul_by_01(a: torch.Tensor, d0: torch.Tensor,
                 d1: torch.Tensor) -> torch.Tensor:
    """Sparse (d0 + d1·v) product — 5 Fp2 products in one launch."""
    [out] = f6_mul_by_01_many([(a, d0, d1)])
    return out


def f6_mul_by_1(a: torch.Tensor, d1: torch.Tensor) -> torch.Tensor:
    """Sparse d1·v product: one Fp2 product batched over the three
    coefficients, then the v-rotation."""
    a0d, a1d, a2d = _f6c(f2_mul(a, d1.unsqueeze(-4)))
    return f6(f2_mul_by_xi(a2d), a0d, a1d)


def f6_mul_f2(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Every Fp2 coefficient times s ∈ Fp2 (coefficient axis batched)."""
    return f2_mul(a, s.unsqueeze(-4))


def f6_inv(a: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = _f6c(a)
    s0, s1, s2, p12, p01, p02 = f2_mul_many(
        [(a0, a0), (a1, a1), (a2, a2), (a1, a2), (a0, a1), (a0, a2)])
    A = f2_sub(s0, f2_mul_by_xi(p12))
    B = f2_sub(f2_mul_by_xi(s2), p01)
    C = f2_sub(s1, p02)
    fa, fb, fc = f2_mul_many([(a0, A), (a2, B), (a1, C)])
    finv = f2_inv(f2_add(fa, f2_mul_by_xi(f2_add(fb, fc))))
    ra, rb, rc = f2_mul_many([(A, finv), (B, finv), (C, finv)])
    return f6(ra, rb, rc)


def f6_select(cond, a, b):
    """cond ? a : b, cond shaped like the batch dims [..., R]."""
    return torch.where(cond.unsqueeze(-2).unsqueeze(-2).unsqueeze(-2), a, b)


# ---------------------------------------------------------------------------
# Fp12: a0 + a1·w, w² = v
# ---------------------------------------------------------------------------

def f12(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    return torch.stack([c0, c1], dim=-5)


def _f12c(a: torch.Tensor):
    return a[..., 0, :, :, :, :], a[..., 1, :, :, :, :]


f12_add = fp.add
f12_sub = fp.sub


def f12_mul_many(pairs: list[tuple[torch.Tensor, torch.Tensor]]
                 ) -> list[torch.Tensor]:
    """K independent Fp12 Karatsuba products — 3K Fp6 = 18K Fp2 = 54K Fp
    products through one multiplier launch."""
    k = len(pairs)
    f6_pairs = []
    for a, b in pairs:
        a0, a1 = _f12c(a)
        b0, b1 = _f12c(b)
        f6_pairs += [(a0, b0), (a1, b1), (f6_add(a0, a1), f6_add(b0, b1))]
    ts = f6_mul_many(f6_pairs)
    out = []
    for i in range(k):
        aa, bb, cross = ts[3 * i:3 * i + 3]
        c1 = f6_sub(cross, f6_add(aa, bb))
        c0 = f6_add(aa, f6_mul_by_v(bb))
        out.append(f12(c0, c1))
    return out


def f12_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    [out] = f12_mul_many([(a, b)])
    return out


def f12_sqr(a: torch.Tensor) -> torch.Tensor:
    a0, a1 = _f12c(a)
    v0, t = f6_mul_many([(a0, a1),
                         (f6_add(a0, a1), f6_add(a0, f6_mul_by_v(a1)))])
    c0 = f6_sub(f6_sub(t, v0), f6_mul_by_v(v0))
    c1 = f6_double(v0)
    return f12(c0, c1)


def f12_conj(a: torch.Tensor) -> torch.Tensor:
    """a^(p⁶): (c0, −c1) — the inverse of a unitary element."""
    a0, a1 = _f12c(a)
    return f12(a0, f6_neg(a1))


def f12_inv(a: torch.Tensor) -> torch.Tensor:
    a0, a1 = _f12c(a)
    s0, s1 = f6_sqr_many([a0, a1])
    t = f6_inv(f6_sub(s0, f6_mul_by_v(s1)))
    m0, m1 = f6_mul_many([(a0, t), (a1, t)])
    return f12(m0, f6_neg(m1))


def f12_mul_by_014(a: torch.Tensor, c0: torch.Tensor, c1: torch.Tensor,
                   c4: torch.Tensor) -> torch.Tensor:
    """Multiply by the sparse line value (c0 + c1·v) + (c4·v)·w: all 13
    Fp2 products (two sparse-01 products and the coefficient-wise c4
    product) in one multiplier launch."""
    a0, a1 = _f12c(a)
    a00, a01, a02 = _f6c(a0)
    s0, s1, s2 = _f6c(f6_add(a0, a1))
    o = f2_add(c1, c4)
    b10, b11, b12 = _f6c(a1)
    ts = f2_mul_many([
        # f6_mul_by_01(a0; c0, c1) — 5 products
        (a00, c0), (a01, c1), (f2_add(a01, a02), c1),
        (f2_add(a00, a01), f2_add(c0, c1)), (f2_add(a00, a02), c0),
        # f6_mul_by_01(a0 + a1; c0, o) — 5 products
        (s0, c0), (s1, o), (f2_add(s1, s2), o),
        (f2_add(s0, s1), f2_add(c0, o)), (f2_add(s0, s2), c0),
        # f6_mul_by_1(a1; c4) — 3 coefficient products
        (b10, c4), (b11, c4), (b12, c4),
    ])

    def combine01(v0, v1, x12, x01, x02):
        return f6(f2_add(v0, f2_mul_by_xi(f2_sub(x12, v1))),
                  f2_sub(x01, f2_add(v0, v1)),
                  f2_add(f2_sub(x02, v0), v1))

    aa = combine01(*ts[0:5])
    t6 = combine01(*ts[5:10])
    bb = f6(f2_mul_by_xi(ts[12]), ts[10], ts[11])
    r1 = f6_sub(t6, f6_add(aa, bb))
    r0 = f6_add(f6_mul_by_v(bb), aa)
    return f12(r0, r1)


def f12_select(cond, a, b):
    return torch.where(cond[..., None, None, None, None, :], a, b)


def f12_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Value equality: every Fp coefficient of a − b ≡ 0 mod p (12 stacked
    zero tests) → [..., R] bool."""
    d = f12_sub(a, b)
    flat = d.reshape(*d.shape[:-5], 12, fp.NLIMBS, d.shape[-1])
    return torch.all(fp.is_zero(flat), dim=-2)


# ---------------------------------------------------------------------------
# Frobenius (x ↦ x^p): coefficients precomputed on the host
# ---------------------------------------------------------------------------

def _fq2_const(x: FQ2) -> np.ndarray:
    """Oracle FQ2 → limb-plane constant [2, 32]."""
    return np.stack([fp.to_limbs(c % P) for c in x.coeffs])


_XI = FQ2([1, 1])
# v^p = γ1·v, v^(2p) = γ2·v², w^p = γw·w  (γ ∈ Fp2)
FROB_G1 = _fq2_const(_XI ** ((P - 1) // 3))
FROB_G2 = _fq2_const(_XI ** (2 * (P - 1) // 3))
FROB_GW = _fq2_const(_XI ** ((P - 1) // 6))


def f6_frob(a: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = _f6c(a)
    return f6(f2_conj(a0),
              f2_mul(f2_conj(a1), fp.elem(FROB_G1, a.device)),
              f2_mul(f2_conj(a2), fp.elem(FROB_G2, a.device)))


def f12_frob(a: torch.Tensor) -> torch.Tensor:
    a0, a1 = _f12c(a)
    return f12(f6_frob(a0),
               f6_mul_f2(f6_frob(a1), fp.elem(FROB_GW, a.device)))


# ---------------------------------------------------------------------------
# Constants and host-side conversions
# ---------------------------------------------------------------------------

def f2_pack(xs: list[FQ2]) -> np.ndarray:
    """Oracle FQ2 list → limb planes [2, 32, len] (port layout; a single
    constant is `f2_pack([x])[..., 0]`, for `fp.elem`)."""
    return np.ascontiguousarray(np.stack(
        [np.stack([fp.to_limbs(c) for c in x.coeffs]) for x in xs], -1))


def f2_unpack(arr) -> list[FQ2]:
    """Limb planes [..., 2, 32, R] → flat list of oracle FQ2 (the leading
    axes, then the rows)."""
    a = np.moveaxis(np.asarray(arr), -1, -3).reshape(-1, 2, fp.NLIMBS)
    return [FQ2([fp.from_limbs(row[0]) % P, fp.from_limbs(row[1]) % P])
            for row in a]


def f12_pack(xs: list[FQ12]) -> np.ndarray:
    """Oracle single-variable FQ12 list → tower limb planes
    [2, 3, 2, 32, len].  Inverse of the embedding u = w⁶ − 1: the tower
    coefficient b_m = x_m + y_m·u at w^m (m = 2j + k) has y_m = c_{m+6},
    x_m = c_m + c_{m+6}."""
    out = np.zeros((len(xs), 2, 3, 2, fp.NLIMBS), np.int32)
    for n, el in enumerate(xs):
        c = el.coeffs
        for m in range(6):
            y = c[m + 6]
            x = (c[m] + y) % P
            k, j = m % 2, m // 2
            out[n, k, j, 0] = fp.to_limbs(x)
            out[n, k, j, 1] = fp.to_limbs(y % P)
    return np.ascontiguousarray(np.moveaxis(out, 0, -1))


def f12_unpack(arr) -> list[FQ12]:
    """Tower limb planes [..., 2, 3, 2, 32, R] → flat list of oracle FQ12."""
    a = np.moveaxis(np.asarray(arr), -1, -5).reshape(-1, 2, 3, 2, fp.NLIMBS)
    out = []
    for row in a:
        coeffs = [0] * 12
        for k in range(2):
            for j in range(3):
                x = fp.from_limbs(row[k, j, 0]) % P
                y = fp.from_limbs(row[k, j, 1]) % P
                m = 2 * j + k
                coeffs[m] = (coeffs[m] + x - y) % P
                coeffs[m + 6] = (coeffs[m + 6] + y) % P
        out.append(FQ12(coeffs))
    return out


F2_ONE = np.stack([fp.ONE, fp.ZERO])
F6_ONE = np.concatenate([F2_ONE[None], np.zeros((2, 2, fp.NLIMBS), np.int32)])
F12_ONE = np.stack([F6_ONE, np.zeros((3, 2, fp.NLIMBS), np.int32)])
