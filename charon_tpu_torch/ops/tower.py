"""Batched Fp2 = Fp[u]/(u² + 1) in PyTorch — the Fp2 part of the JAX
package's ops/tower.py (Fp6/Fp12 come with the verify slice).

An Fp2 batch is ``[..., 2, 32, R]``: coefficient axis, limb axis, rows
(see ops/fp.py for the layout).  Every op reaches the K1 kernel through
`fp`, and each is bit-identical to its JAX counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fp
from ..tbls.ref.fields import FQ2

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


def f2_sqr(a: torch.Tensor) -> torch.Tensor:
    """(a0+a1)(a0−a1) + 2·a0·a1·u: two Fp products in one launch."""
    a0, a1 = _c(a, 0), _c(a, 1)
    t = fp.mul(torch.stack([fp.add(a0, a1), a0]),
               torch.stack([fp.sub(a0, a1), a1]))
    return f2(t[0], fp.double(t[1]))


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
# Constants and host-side conversions
# ---------------------------------------------------------------------------

def f2_pack(xs: list[FQ2]) -> np.ndarray:
    """Oracle FQ2 list → limb planes [2, 32, len] (port layout; a single
    constant is `f2_pack([x])[..., 0]`, for `fp.elem`)."""
    return np.ascontiguousarray(np.stack(
        [np.stack([fp.to_limbs(c) for c in x.coeffs]) for x in xs], -1))


F2_ONE = np.stack([fp.ONE, fp.ZERO])
