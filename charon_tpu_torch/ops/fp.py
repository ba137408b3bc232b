"""Batched Fp arithmetic for BLS12-381 in PyTorch: 32×12-bit int32 limbs.

The port of the JAX package's ops/fp.py.  The representation and the
column arithmetic are the same (so every op is bit-identical to its JAX
counterpart and tests compare exactly):

    value(x) = Σ xₖ·2^(12k)  with  0 ≤ xₖ ≤ LMAX = 8191

An element denotes value(x) mod p; ring ops end in `_reduce` (partial
carries plus folding of the ≥2^384 columns through FOLDC), and only the
boundaries (equality, sign, serialisation) run the exact carry of
`canon_std`.  See the JAX module for the convergence argument.

LAYOUT.  An element batch is a tensor ``[..., 32, R]``: the limb axis is
second to last and the row axis last, so that on the card neighbouring
threads (neighbouring rows) read neighbouring addresses, and a G2 point
batch ``[3, 2, 32, R]`` is the kernels' ``[6, 32, R]`` plane layout with
no copy.  A per-row flag or scalar is ``[..., R]`` and broadcasts against
an element by ``cond.unsqueeze(-2)``.

DISPATCH.  `mul`, `add`, `sub`, `neg` and `mul_small` go to kernel K1
through `cuda_fp` at every size: a CUDA tensor launches the kernel, a CPU
tensor takes the plain versions below (`*_plain`).  `canon_std`, `eq`,
`is_zero`, `sgn` and `select` are plain tensor code on either device, as
they are plain jnp in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..tbls.ref.fields import P
from . import cuda_fp

LIMB_BITS = 12
NLIMBS = 32  # 32 × 12 = 384 bits ≥ 381-bit p
MASK = (1 << LIMB_BITS) - 1
LMAX = (1 << 13) - 1  # redundant-limb bound: 32·LMAX² = 2146959392 < 2^31
DTYPE = torch.int32


# ---------------------------------------------------------------------------
# Host-side conversions (numpy)
# ---------------------------------------------------------------------------

def to_limbs(x: int, nlimbs: int = NLIMBS) -> np.ndarray:
    """Integer → little-endian 12-bit limb vector (host side)."""
    assert 0 <= x < 1 << (LIMB_BITS * nlimbs)
    return np.array([(x >> (LIMB_BITS * i)) & MASK for i in range(nlimbs)],
                    dtype=np.int32)


def from_limbs(limbs) -> int:
    """Limb vector (1-D) → integer (host side)."""
    arr = np.asarray(limbs, dtype=np.int64)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(arr))


def pack(xs) -> np.ndarray:
    """Host: ints (standard form) → [32, len] limb planes, each mod p."""
    return np.ascontiguousarray(
        np.stack([to_limbs(int(x) % P) for x in xs], axis=-1))


def unpack(arr) -> list[int]:
    """[..., 32, R] limb planes → flat list of ints (mod p), row-major
    over the leading axes then R."""
    a = np.moveaxis(np.asarray(arr, dtype=np.int64), -2, -1)
    a = a.reshape(-1, NLIMBS)
    return [sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(row)) % P
            for row in a]


P_LIMBS = to_limbs(P)
ZERO = to_limbs(0)
ONE = to_limbs(1)

# FOLDC[j] = 2^(12·(32+j)) mod p: column 32+j folds back through it.
_FOLD_ROWS = 36
FOLDC = np.stack([to_limbs(pow(2, LIMB_BITS * (NLIMBS + j), P))
                  for j in range(_FOLD_ROWS)])

# Multiples of p as 34-limb canonical digit arrays (canon_std / is_zero).
_N_PMULT = 48
PMULT = np.stack([to_limbs(c * P, 34) for c in range(_N_PMULT)])
_ONE_HOT0_34 = np.zeros(34, np.int32)
_ONE_HOT0_34[0] = 1

# 48p in "spread" form: 33 limbs, every low limb ≥ LMAX, value exactly 48p.
_d48 = to_limbs(48 * P, 33).astype(np.int64)
SPREAD48P = _d48.copy()
SPREAD48P[:NLIMBS] += 3 << LIMB_BITS
SPREAD48P[1:NLIMBS + 1] -= 3
assert (SPREAD48P[:NLIMBS] >= LMAX).all() and (SPREAD48P >= 0).all()
assert sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(SPREAD48P)) \
    == 48 * P
SPREAD48P = SPREAD48P.astype(np.int32)

_HALF_P1 = to_limbs((P + 1) // 2)[None]        # [1, 32]: one constant row


_CONSTS: dict[tuple[int, str], tuple[np.ndarray, torch.Tensor]] = {}


def const(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy constant as an int32 tensor on `device`, uploaded once per
    (array object, device).  The cache holds the array too, so its id
    cannot be reused by another array while the entry exists."""
    key = (id(arr), str(device))
    hit = _CONSTS.get(key)
    if hit is None:
        hit = (arr, torch.as_tensor(np.asarray(arr, np.int32), device=device))
        _CONSTS[key] = hit
    return hit[1]


def elem(arr: np.ndarray, device) -> torch.Tensor:
    """A constant element [..., 32] (numpy) as a broadcastable port-layout
    tensor [..., 32, 1]."""
    return const(arr, device).unsqueeze(-1)


# ---------------------------------------------------------------------------
# Plain carry machinery (limb axis −2)
# ---------------------------------------------------------------------------

def _pad_limbs(x: torch.Tensor, n: int) -> torch.Tensor:
    """Append n zero limbs (axis −2)."""
    return F.pad(x, (0, 0, 0, n))


def _shift_up(h: torch.Tensor) -> torch.Tensor:
    """Limb k → k+1, dropping the top limb."""
    return F.pad(h[..., :-1, :], (0, 0, 1, 0))


def _partial_carry(x: torch.Tensor, rounds: int) -> torch.Tensor:
    for _ in range(rounds):
        x = (x & MASK) + _shift_up(x >> LIMB_BITS)
    return x


def _fold_high(x: torch.Tensor) -> torch.Tensor:
    """[..., W>32, R] → [..., 32, R], value preserved mod p."""
    h = x.shape[-2] - NLIMBS
    fold = const(FOLDC, x.device)[:h]                     # [h, 32]
    hi = x[..., NLIMBS:, :].unsqueeze(-2)                 # [..., h, 1, R]
    return x[..., :NLIMBS, :] + torch.sum(
        hi * fold.unsqueeze(-1), dim=-3, dtype=DTYPE)


def _reduce(x: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """Any nonnegative column vector [..., W, R] (32 ≤ W ≤ 66, columns
    < 2^31) → redundant residue with limbs ≤ LMAX (fp._reduce)."""
    x = _fold_high(_partial_carry(_pad_limbs(x, 2), 2))
    for _ in range(iters):
        x = _fold_high(_partial_carry(_pad_limbs(x, 2), 2))
    return x


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook columns Σ_{i+j=k} aᵢ·bⱼ, [..., 32, R] ×2 → [..., 63, R]:
    one outer product, then the pad/flatten/reshape staircase that shifts
    row i right by i, then one sum (broadcast-multiply and sum — integer
    matmul/einsum is not available on CUDA)."""
    L = a.shape[-2]
    outer = a.unsqueeze(-2) * b.unsqueeze(-3)              # [..., L, L, R]
    lead = outer.shape[:-3]
    r = outer.shape[-1]
    flat = F.pad(outer, (0, 0, 0, L)).reshape(*lead, 2 * L * L, r)
    shifted = flat[..., : L * (2 * L - 1), :].reshape(*lead, L, 2 * L - 1, r)
    return torch.sum(shifted, dim=-3, dtype=DTYPE)


def _bcast(*ts: torch.Tensor) -> list[torch.Tensor]:
    """Broadcast operands to one shape and make each contiguous (the
    kernel wrappers take equal, contiguous shapes)."""
    if all(t.shape == ts[0].shape for t in ts):
        return [t.contiguous() for t in ts]
    return [t.contiguous() for t in torch.broadcast_tensors(*ts)]


# ---------------------------------------------------------------------------
# Plain versions of the K1 ops (the JAX package's jnp bodies)
# ---------------------------------------------------------------------------

def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce(_conv(a, b))


def add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce(a + b, iters=1)


def sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a − b + 48p (the spread form keeps every limb difference ≥ 0)."""
    return _reduce(elem(SPREAD48P, a.device) + _pad_limbs(a - b, 1), iters=1)


def neg_plain(a: torch.Tensor) -> torch.Tensor:
    return _reduce(elem(SPREAD48P, a.device) - _pad_limbs(a, 1), iters=1)


def mul_small_plain(a: torch.Tensor, k: int) -> torch.Tensor:
    return _reduce(a * k, iters=2)


# ---------------------------------------------------------------------------
# Ring ops (redundant residues in and out)
# ---------------------------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return cuda_fp.add(*_bcast(a, b))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return cuda_fp.sub(*_bcast(a, b))


def neg(a: torch.Tensor) -> torch.Tensor:
    return cuda_fp.neg(a.contiguous())


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a·k for a small static positive k ≤ 16 (group-law constants)."""
    assert 1 <= k <= 16
    return cuda_fp.mul_small(a.contiguous(), k)


def double(a: torch.Tensor) -> torch.Tensor:
    return mul_small(a, 2)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b mod p: one convolution folded back to 32 limbs."""
    return cuda_fp.mul(*_bcast(a, b))


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def sqr_many(els: list[torch.Tensor]) -> list[torch.Tensor]:
    return mul_many([(a, a) for a in els])


def mul_many(pairs: list[tuple[torch.Tensor, torch.Tensor]]
             ) -> list[torch.Tensor]:
    """K independent products in ONE multiplier launch (stacked on a new
    leading axis)."""
    if len(pairs) == 1:
        return [mul(*pairs[0])]
    shape = torch.broadcast_shapes(*[t.shape for pr in pairs for t in pr])
    xs = torch.stack([a.expand(shape) for a, _ in pairs])
    ys = torch.stack([b.expand(shape) for _, b in pairs])
    return list(mul(xs, ys).unbind(0))


def to_mont(a) -> torch.Tensor:
    """Standard form → internal form: the identity (the representation is
    plain; the name is the JAX package's)."""
    return torch.as_tensor(a)


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Internal form → canonical standard form in [0, p)."""
    return canon_std(a)


def pow_fixed(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a host-known exponent: square-and-multiply, LSB first.
    The exponent's bits are known on the host, so a zero bit launches
    the squaring alone; a one bit multiplies result and base in one
    stacked launch.  Rows agree bit for bit with the JAX fori_loop, which
    computes the same products and selects."""
    one = elem(ONE, a.device).expand(a.shape).contiguous()
    if e == 0:
        return one
    result, base = one, a
    nbits = e.bit_length()
    for i in range(nbits):
        last = i == nbits - 1
        if (e >> i) & 1:
            if last:
                result = mul(result, base)
            else:
                result, base = mul_many([(result, base), (base, base)])
        elif not last:
            base = sqr(base)
    return result


def inv(a: torch.Tensor) -> torch.Tensor:
    """a⁻¹ via Fermat; inv(0) = 0 (the curve layer's ∞ convention)."""
    return pow_fixed(a, P - 2)


# ---------------------------------------------------------------------------
# Exact boundary: canonicalisation, equality, sign (plain tensor code; the
# helpers below work limb-LAST, callers move the limb axis)
# ---------------------------------------------------------------------------

def _partial_carry_last(x: torch.Tensor, rounds: int) -> torch.Tensor:
    for _ in range(rounds):
        x = (x & MASK) + F.pad((x >> LIMB_BITS)[..., :-1], (1, 0))
    return x


def _exact_carry(v: torch.Tensor) -> torch.Tensor:
    """Exact canonical digits of a nonnegative limb-last vector whose width
    holds the full value: three partial rounds, then carry lookahead (the
    carry into limb k is the generate bit of the most recent
    non-propagating limb below k)."""
    v = _partial_carry_last(v, 3)
    g = v > MASK
    p_ = v == MASK
    L = v.shape[-1]
    pos = torch.arange(L, dtype=DTYPE, device=v.device)
    anchor = torch.cummax(torch.where(p_, -1, pos), dim=-1).values
    anchor_prev = F.pad(anchor[..., :-1], (1, 0), value=-1)
    eq_m = anchor_prev.unsqueeze(-1) == pos
    c_in = torch.any(eq_m & g.unsqueeze(-2), dim=-1).to(DTYPE)
    return (v + c_in) & MASK


def _ge_consts(x: torch.Tensor, consts: np.ndarray) -> torch.Tensor:
    """Lexicographic x ≥ consts[c]: [*, L] vs [C, L] → [*, C] bool."""
    m = const(consts, x.device)
    x = x.unsqueeze(-2)
    eq_ = x == m
    gt = x > m
    eq_rev = torch.flip(eq_, dims=(-1,))
    suffix = torch.cumprod(
        F.pad(eq_rev[..., :-1].to(DTYPE), (1, 0), value=1), dim=-1,
        dtype=DTYPE)
    eq_above = torch.flip(suffix, dims=(-1,)).bool()
    return torch.any(gt & eq_above, dim=-1) | torch.all(eq_, dim=-1)


def canon_std(a: torch.Tensor) -> torch.Tensor:
    """Redundant residue [..., 32, R] → canonical standard form in [0, p)."""
    x = a.movedim(-2, -1)                               # [..., R, 32]
    digits = _exact_carry(F.pad(x, (0, 34 - x.shape[-1])))
    ge = _ge_consts(digits, PMULT)                      # [..., R, 48]
    c = torch.sum(ge, dim=-1, dtype=DTYPE) - 1
    pos = torch.arange(_N_PMULT, dtype=DTYPE, device=a.device)
    onehot = (pos == c.unsqueeze(-1)).to(DTYPE)
    cp = torch.sum(onehot.unsqueeze(-1) * const(PMULT, a.device), dim=-2,
                   dtype=DTYPE)
    t = digits + (MASK - cp) + const(_ONE_HOT0_34, a.device)
    t = _exact_carry(t)
    return t[..., :NLIMBS].movedim(-1, -2).contiguous()


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """value(a) ≡ 0 (mod p) → [..., R] bool."""
    x = a.movedim(-2, -1)
    digits = _exact_carry(F.pad(x, (0, 34 - x.shape[-1])))
    eq_ = torch.all(digits.unsqueeze(-2) == const(PMULT, a.device), dim=-1)
    return torch.any(eq_, dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return is_zero(sub(a, b))


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """cond ? a : b, cond shaped like the batch dims [..., R]."""
    return torch.where(cond.unsqueeze(-2), a, b)


def sgn(a_std: torch.Tensor) -> torch.Tensor:
    """ZCash sign of a STANDARD-form element: 1 iff a ≥ (p+1)/2."""
    return _ge_consts(a_std.movedim(-2, -1), _HALF_P1)[..., 0]
