"""Kernel K11 — the whole final exponentiation on the card
(csrc/final_exp.cu).

The final exponentiation f ↦ f^(3·(p¹²−1)/r) of `pairing.
final_exponentiate` (the JAX package's ops/pairing.py `final_exponentiate`)
as ONE launch per call.  On the TPU the JAX function is one jitted program
whose every field op reaches `pallas_fp` (`_mul_kernel` :78, `_add_kernel`
:97, `_sub_kernel` :104, `_neg_kernel` :112, `_small_kernel_factory`
:120); the port's plain tower copy makes each of them a K1 launch — 7,914
per call.  K11 runs the same sequence inside one kernel:

- the easy part: conj(f)·f⁻¹, then frob²(f)·f;
- the hard part: t0 = f^z·conj(f), t1 = t0^z·conj(t0), t2 =
  t1^z·frob(t1), t3 = (t2^z)^z, t5 = t3·frob²(t2)·conj(t2), and the
  result t5·f²·f — each ^z 63 squarings and 5 products over the bits of
  |z|, then a conjugation (z < 0, the argument is cyclotomic).

One WARP per row: the 12 Fp2 products of a squaring and the 18 of a
product (their Toom-style Fp6 products) are independent, one per lane,
with the operands in shared memory.  Every product and sum is the same
csrc/fp381.cuh function on the same inputs as the sequential K5 tower
(`cuda_pairing._f12_sqr`, `_f12_mul`), so the kernel is BIT-IDENTICAL to
its plain version here, `final_exp_plain`, which batches each stage's
independent products along the row axis the way the kernel spreads them
over lanes: on the CPU that is ~5× faster than the same sequence on the
K5 bodies (tools/plain_final_exp_cpu.py).  It is value-equal, not bit-equal, to `pairing.
final_exponentiate` and to JAX's: their tower reduces in another order.

LAYOUT.  An Fp12 batch is ``[2, 3, 2, 32, R]`` (ops/pairing.py), which is
the pairing kernels' ``[12, 32, R]`` plane stack (plane m = (k·3 + j)·2 +
c) with no copy.  The wrapper routes a CPU tensor to the plain version
and launches the kernel for a CUDA tensor (or raises); `LAUNCHES` counts
kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tbls.ref.fields import BLS_X, P
from . import build, fp, launch_count, tower
from .cuda_g2 import (_addf, _cuda_ready, _f2add, _f2mul, _f2small, _f2sub,
                      _mulf, _negf, _raise_on, _table_f2)
from .cuda_pairing import _f2_mul_xi, _f6_mul, _f6_mul_by_v, _f6_sub

NL = fp.NLIMBS
F12_SHAPE = (2, 3, 2, NL)

# bits of |z| below the leading one, MSB first: the ^|z| chain's schedule
_Z_BITS = tuple(int(b) for b in bin(BLS_X)[3:])

# Frobenius constants γ1, γ2, γw ∈ Fp2 (tower.FROB_*), Fp2 i in rows 2i, 2i+1
_FE_NP = np.concatenate([tower.FROB_G1, tower.FROB_G2, tower.FROB_GW])
_FE_G1, _FE_G2, _FE_GW = 0, 1, 2


def fe_consts() -> np.ndarray:
    """The Frobenius table [6, 32] of csrc/fp381_consts.cuh (FE_G)."""
    return _FE_NP.copy()


# ---------------------------------------------------------------------------
# Plain version.  An Fp element is a [32, R] tensor, an Fp2 a (c0, c1)
# tuple, an Fp6 a triple of Fp2, an Fp12 a list of its six Fp2
# coefficients (k·3 + j).  `_many` runs K independent calls of one field
# function as ONE call on the rows concatenated — the rows of a plain op
# never mix, so each result is the bits the sequential call gives.
# ---------------------------------------------------------------------------

def _cat(xs):
    return torch.cat(xs, dim=-1)


def _many(fn, args: list[tuple]) -> list:
    """[fn(*a) for a in args] as one call of fn on concatenated rows (each
    argument an Fp2 tuple; all rows of one width)."""
    k = len(args)
    if k == 1:
        return [fn(*args[0])]
    cat = [(_cat([a[i][0] for a in args]), _cat([a[i][1] for a in args]))
           for i in range(len(args[0]))]
    out = fn(*cat)
    c0, c1 = out[0].chunk(k, dim=-1), out[1].chunk(k, dim=-1)
    return list(zip(c0, c1))


def _cf2(idx: int, like: torch.Tensor):
    """Frobenius constant `idx` broadcast to the rows of `like` [32, R]."""
    return _table_f2(_FE_NP, idx, like)


def _f6_products(a6s, b6s):
    """K Toom-style Fp6 products (fp381 f6_mul): the 6K Fp2 products in
    one call (the kernel's product lanes), then the three combinations of
    each (its combination lanes)."""
    pre = _many(_f2add, [pr for a, b in zip(a6s, b6s) for pr in (
        (a[1], a[2]), (b[1], b[2]), (a[0], a[1]), (b[0], b[1]),
        (a[0], a[2]), (b[0], b[2]))])
    pairs = []
    for k, (a, b) in enumerate(zip(a6s, b6s)):
        s = pre[6 * k:6 * k + 6]
        pairs += [(a[0], b[0]), (a[1], b[1]), (a[2], b[2]),
                  (s[0], s[1]), (s[2], s[3]), (s[4], s[5])]
    pr = _many(_f2mul, pairs)
    k6 = range(len(a6s))
    u = _many(_f2add, [x for k in k6 for x in (
        (pr[6 * k + 1], pr[6 * k + 2]), (pr[6 * k], pr[6 * k + 1]),
        (pr[6 * k], pr[6 * k + 2]))])
    t = _many(_f2sub, [(pr[6 * k + 3 + i], u[3 * k + i])
                       for k in k6 for i in range(3)])
    xi = _many(_f2_mul_xi, [x for k in k6 for x in ((t[3 * k],),
                                                     (pr[6 * k + 2],))])
    c = _many(_f2add, [x for k in k6 for x in (
        (pr[6 * k], xi[2 * k]), (t[3 * k + 1], xi[2 * k + 1]),
        (t[3 * k + 2], pr[6 * k + 1]))])
    return [tuple(c[3 * k:3 * k + 3]) for k in k6]


def _sqr(f: list) -> list:
    """f² (fp381 f12_sqr), as the kernel's lanes split it."""
    f0, f1 = f[:3], f[3:]
    xi = _f2_mul_xi(f1[2])
    s_u = _many(_f2add, [(f0[0], f1[0]), (f0[1], f1[1]), (f0[2], f1[2]),
                         (f0[0], xi), (f0[1], f1[0]), (f0[2], f1[1])])
    v0, t = _f6_products([f0, s_u[:3]], [f1, s_u[3:]])
    d = _many(_f2sub, [(t[i], v0[i]) for i in range(3)])
    o0 = _many(_f2sub, [(d[0], _f2_mul_xi(v0[2])), (d[1], v0[0]),
                        (d[2], v0[1])])
    o1 = _many(lambda a: _f2small(a, 2), [(v,) for v in v0])
    return o0 + o1


def _mul(f: list, g: list) -> list:
    """f·g (fp381 f12_mul), as the kernel's lanes split it."""
    s = _many(_f2add, [(f[i], f[3 + i]) for i in range(3)]
              + [(g[i], g[3 + i]) for i in range(3)])
    aa, bb, cr = _f6_products([f[:3], f[3:], s[:3]], [g[:3], g[3:], s[3:]])
    o0 = _many(_f2add, [(aa[0], _f2_mul_xi(bb[2])), (aa[1], bb[0]),
                        (aa[2], bb[1])])
    ab = _many(_f2add, [(aa[i], bb[i]) for i in range(3)])
    o1 = _many(_f2sub, [(cr[i], ab[i]) for i in range(3)])
    return o0 + o1


def _conj(f: list) -> list:
    """(f0, −f1): every coefficient of f1 negated."""
    return f[:3] + _many(lambda a: (_negf(a[0]), _negf(a[1])),
                         [(x,) for x in f[3:]])


def _frob(f: list) -> list:
    """f^p, coefficient by coefficient: conj(x)·γ_j, and ·γw for the w
    half (tower.f12_frob)."""
    like = f[0][0]
    cj = _many(lambda a: (a[0], _negf(a[1])), [(x,) for x in f])
    g = [_cf2(_FE_G1, like), _cf2(_FE_G2, like)]
    m1 = _many(_f2mul, [(cj[k * 3 + j], g[j - 1])
                        for k in range(2) for j in (1, 2)])
    out = [cj[0], m1[0], m1[1], cj[3], m1[2], m1[3]]
    gw = _cf2(_FE_GW, like)
    return out[:3] + _many(_f2mul, [(x, gw) for x in out[3:]])


def _exp_abs_z(g: list) -> list:
    acc = _sqr(g)
    if _Z_BITS[0]:
        acc = _mul(acc, g)
    for bit in _Z_BITS[1:]:
        acc = _sqr(acc)
        if bit:
            acc = _mul(acc, g)
    return acc


def _exp_z(g: list) -> list:
    return _conj(_exp_abs_z(g))


# -- the inverse: one lane of the kernel, sequential fp381 functions --------

_EXP_PM2 = P - 2


def _fp_inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p−2), LSB first (fp.pow_fixed's schedule); inv(0) = 0."""
    result = fp.const(fp.ONE, a.device).unsqueeze(-1).expand_as(a)
    base = a
    nbits = _EXP_PM2.bit_length()
    for i in range(nbits):
        if (_EXP_PM2 >> i) & 1:
            result = _mulf(result, base)
        if i != nbits - 1:
            base = _mulf(base, base)
    return result


def _f2_inv(a):
    n = _addf(_mulf(a[0], a[0]), _mulf(a[1], a[1]))
    ni = _fp_inv(n)
    return (_mulf(a[0], ni), _negf(_mulf(a[1], ni)))


def _f6_inv(a):
    s0, s1, s2 = _f2mul(a[0], a[0]), _f2mul(a[1], a[1]), _f2mul(a[2], a[2])
    p12, p01, p02 = _f2mul(a[1], a[2]), _f2mul(a[0], a[1]), _f2mul(a[0], a[2])
    A = _f2sub(s0, _f2_mul_xi(p12))
    B = _f2sub(_f2_mul_xi(s2), p01)
    C = _f2sub(s1, p02)
    fa, fb, fc = _f2mul(a[0], A), _f2mul(a[2], B), _f2mul(a[1], C)
    t = _f2_inv(_f2add(fa, _f2_mul_xi(_f2add(fb, fc))))
    return (_f2mul(A, t), _f2mul(B, t), _f2mul(C, t))


def _inv(f: list) -> list:
    """f⁻¹ (tower.f12_inv's formulas on the K5 Fp6 product)."""
    a0, a1 = tuple(f[:3]), tuple(f[3:])
    s0, s1 = _f6_mul(a0, a0), _f6_mul(a1, a1)
    t = _f6_inv(_f6_sub(s0, _f6_mul_by_v(s1)))
    m0, m1 = _f6_mul(a0, t), _f6_mul(a1, t)
    return list(m0) + [(_negf(x[0]), _negf(x[1])) for x in m1]


def _unstack(f: torch.Tensor) -> list:
    """[2, 3, 2, 32, R] → six Fp2 tuples."""
    p = f.reshape(12, NL, f.shape[-1])
    return [(p[2 * m], p[2 * m + 1]) for m in range(6)]


def _stack(f: list) -> torch.Tensor:
    return torch.stack([c for x in f for c in x]).reshape(
        *F12_SHAPE, f[0][0].shape[-1])


def final_exp_plain(f: torch.Tensor) -> torch.Tensor:
    """f^(3·(p¹²−1)/r) over [2, 3, 2, 32, R] — the kernel's sequence."""
    x = _unstack(f)
    x = _mul(_conj(x), _inv(x))                     # ^(p⁶−1)
    x = _mul(_frob(_frob(x)), x)                    # ^(p²+1)
    t0 = _mul(_exp_z(x), _conj(x))                  # x^(z−1)
    t1 = _mul(_exp_z(t0), _conj(t0))                # x^(z−1)²
    t2 = _mul(_exp_z(t1), _frob(t1))                # x^((z−1)²(z+p))
    t3 = _exp_z(_exp_z(t2))                         # ^z²
    t5 = _mul(_mul(t3, _frob(_frob(t2))), _conj(t2))
    f3 = _mul(_sqr(x), x)
    return _stack(_mul(t5, f3))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

#: kernel launches since the last `reset_launches()` (all threads;
#: `launch_count.this_thread()` has the calling thread's own)
LAUNCHES = {"final_exp": 0}


def reset_launches() -> None:
    LAUNCHES["final_exp"] = 0


def final_exp(f: torch.Tensor) -> torch.Tensor:
    """f^(3·(p¹²−1)/r) per row of an int32 [2, 3, 2, 32, R] Fp12 batch: one
    launch, one warp per row."""
    return _final_exp(f, False)


def final_exp_is_one(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(f^(3·(p¹²−1)/r), its verdict "= 1" [R] bool) per row of an int32
    [2, 3, 2, 32, R] Fp12 batch: one launch, which also writes the
    verdict (lanes 0–11 each test one coefficient of the result minus
    one); on the CPU `pairing.is_one(final_exp_plain(f))`."""
    return _final_exp(f, True)


def _final_exp(f: torch.Tensor, verdict: bool):
    if f.dtype != torch.int32:
        raise TypeError(f"final_exp: int32 limbs expected, got {f.dtype}")
    if f.dim() != 5 or tuple(f.shape[:4]) != F12_SHAPE or f.shape[4] == 0:
        raise ValueError(f"final_exp: expected [2, 3, 2, 32, R], got "
                         f"{tuple(f.shape)}")
    if f.device.type == "cpu":
        from .pairing import is_one

        out = final_exp_plain(f)
        return (out, is_one(out)) if verdict else out
    if not f.is_contiguous():
        raise ValueError("final_exp: the operand must be contiguous")
    if f.numel() >= 2 ** 31:
        raise ValueError(f"final_exp: {f.numel()} limbs exceed the int index")
    _cuda_ready("final_exp", f)
    out = torch.empty_like(f)
    ok = torch.empty(f.shape[-1], dtype=torch.bool, device=f.device) \
        if verdict else None
    err = build.library().charon_final_exp(
        out.data_ptr(), f.data_ptr(), 0 if ok is None else ok.data_ptr(),
        f.shape[-1], torch.cuda.current_stream(f.device).cuda_stream)
    _raise_on("final_exp", err)
    launch_count.bump(LAUNCHES, "final_exp")
    return (out, ok) if verdict else out
