"""Kernels K7–K9, K17, K18, K23, K24 and the batched device hash-to-G2
(csrc/h2c.cu, csrc/g2_zmul.cu, csrc/f2_chain.cu, csrc/h2c_map.cu,
csrc/h2c_sswu.cu).

The counterpart of the JAX package's ops/pallas_h2c.py: the host keeps
expand_message_xmd + hash_to_field (SHA-256, `pack_messages`), and the
card runs SSWU onto E', the Fp2 square roots and inversion as fixed
addition chains, the 3-isogeny, the two-point addition and the
Budroni–Pintore ψ cofactor clearing:

- K7 `f2_chain<SQR|MUL|SQR4|SQR4MUL>` replaces `_h2c_sqr_kernel`,
  `_h2c_mul_kernel`, `_h2c_sqr4_kernel` and `_h2c_sqr4mul_kernel`: a²,
  a·b, a¹⁶ and a¹⁶·m on one Fp2 row (one 4-bit window of a fixed-exponent
  pow per SQR4/SQR4MUL launch).
- K8 `h2c_sswu` replaces `_h2c_sswu_kernel`: the SSWU fraction x = xn/xd
  and both square-root radicands v1 = g'(x1)·xd⁴ and v2 = (Z·u²)³·v1,
  reading an exceptional flag (tv1 = 0).  It remains for the smoke run's
  kernel phase and as the step K24 is held to.
- K9 `h2c_point<ISO3|PSI>` replaces `_h2c_iso3_kernel` (Horner over the
  isogeny table to a projective point) and `_h2c_psi_kernel` (ψ as two
  conjugations and two constant products).  It remains for the smoke
  run's kernel phase and as the steps K23 and K22 are held to
  (`map_tail_steps`, `law_steps("pre")`).
- K23 `h2c_map_tail` (csrc/h2c_map.cu) replaces K9 ISO3 and the map
  tail's exact boundary around it (pallas_h2c `map_to_g2_rows` :601-612):
  x's select by ok₁, the RFC 9380 sgn0 sign fix, the 3-isogeny as one
  straight-line program on `MT_CONFIG`'s lanes a row (ops/miller_program.py
  `iso3_dag`) and the ∞ guard, in ONE launch.
- K24 `h2c_sswu_head` (csrc/h2c_sswu.cu) replaces K8 on the path: SSWU as
  one straight-line program on `SW_CONFIG`'s lanes a row (ops/miller_
  program.py `sswu_dag`), whose prologue derives from u alone the two
  flags that the JAX package's `pack_messages` computes on the host — the
  exceptional flag and sgn0(u), which K23 reads — in ONE launch.
  tv1 = Z²u⁴ + Zu² is 0 exactly where u is: Z·u² = −1 has no root, since
  −1 is a square in Fp2 and Z is not (its norm, 5, is a non-residue mod
  p).  So the flag is u ≡ 0, an exact test of u's coefficients.

- K17 `g2_zmul` (csrc/g2_zmul.cu) replaces the launch sequence of
  `_zmul` (:537): one [|x|]-multiply — the table {Q, 2Q, 3Q} by K2 and
  32 K10 `dblsel` windows, 34 launches — in ONE launch, a group of
  `ZM_LANES` threads per row running ops/miller_program.py's straight-
  line `zmul_program`.  The cofactor clearing runs [|x|]P and [|x|]ψ(P)
  as one launch over both row sets, then [x²]P; K10 remains for the
  smoke run's kernel phase and as the steps K17 is held to
  (`zmul_steps`).
- K18 `f2_chain` (csrc/f2_chain.cu) replaces the K7 launch sequences of
  the fixed-exponent chains (`f2_pow_rows` :482, `f2_sqrt_rows` :497,
  `f2_inv_rows` :517): a batch's Fp2 square root (both pows, α, both
  candidate roots and their squares) and its inversion-and-affine step
  are ONE launch each, ops/miller_program.py's straight-line
  `chain_program`s with each Fp2 op split into Fp products that lanes
  of a row run side by side (the norm's pow in Fp alone).  K7 remains
  for the smoke run's kernel phase and as the sequences K18 is held to
  (`f2_sqrt_steps`, `f2_inv_steps`, `f2_affine_steps`).

The group law around the clearing runs K22 (ops/cuda_g2.py `g2_law`):
the halves' sum R, its double 2R, ψ(R) and ψ²(2R) in one launch, the
clearing's five additions, with their three point negations as LIN
forms, in another.  The exactness boundaries, which the JAX package
keeps at the jnp level, run inside the kernels that produce their
operands, on csrc/fp381.cuh's exact `canon` / `is_zero`: the tests α =
−1 and root² = v and the root's select in K18's epilogue, sgn0 with the
sign fix and the isogeny's ∞ guard in K23, the exceptional flag and
sgn0(u) in K24.  A hash batch is 9 launches: K24, 2 K18, K23, 2 K17, 2
K22 and the normalisation's K19.  Their plain versions
(`sqrt_select_plain`, `map_tail_plain`, `sswu_head_plain`) are the same
boundary in plain tensor code.

Each kernel is bit-identical to its plain version here: for K7–K9 the
JAX `_DIRECT_FNS` body line for line on `cuda_g2`'s plain field library;
for K18 its program executed on PyTorch tensors, which equals the K7
chains (and JAX's) in value, every field element the same residue; for
K23 its program executed on tensors inside the plain boundary, which
equals K9 ISO3 and JAX's map tail bit for bit; for K24 likewise, equal
to K8 and JAX's `_sswu_body` given the host's flags.

LAYOUT.  A batch of n-plane rows is ``[n, 32, R]`` int32; an Fp2 batch
``[2, 32, R]`` is also the port tower's element layout.  The u rows are
u-MAJOR, as in the JAX package: rows [0, m) hold u₀ of each message and
[m, 2m) hold u₁, so the two mapped halves are two row ranges of one
tensor; both square-root candidates ride one chain, stacked on the row
axis.  Nothing is padded.

Every wrapper routes a CPU tensor to the plain version and launches the
kernel for a CUDA tensor (or raises).  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tbls.ref import sswu as refsswu
from ..tbls.ref.fields import BLS_X, FQ2, P
from ..tbls.ref.hash_to_curve import DST_G2, hash_to_field_fp2
from . import (build, codec, cuda_g2, cuda_pairing, fp, launch_count,
               miller_program, tower)
from .cuda_g2 import (_cuda_ready, _f2add, _f2mul, _f2sqr, _negf,
                      _raise_on, _subf, _table_f2)

NL = fp.NLIMBS

# ---------------------------------------------------------------------------
# The h2c constant table: SSWU constants, 3-isogeny coefficients and the ψ
# constants as Fp limb rows [42, 32]; Fp2 constant i occupies rows
# (2i, 2i + 1) = (c0, c1).  The kernels hold it in __constant__ memory
# (csrc/fp381_consts.cuh, rendered by build.render_consts_header()).
# ---------------------------------------------------------------------------

_HC_ONE = 0          # FQ2 one (for tv1 + 1)
_HC_Z = 1            # SSWU Z = −(2 + u)
_HC_A = 2            # A' of E'
_HC_NEG_A = 3        # −A'  (x1 denominator: xd = −A'·tv1)
_HC_ZA = 4           # Z·A' (the tv1 = 0 exceptional denominator)
_HC_B = 5            # B' of E'
_HC_XN = 6           # 6..9   isogeny x-numerator k1_0..k1_3
_HC_XD = 10          # 10..11 x-denominator k2_0..k2_1 (monic, deg 2)
_HC_YN = 12          # 12..15 y-numerator k3_0..k3_3
_HC_YD = 16          # 16..18 y-denominator k4_0..k4_2 (monic, deg 3)
_HC_PSI_CX = 19      # ψ x-constant
_HC_PSI_CY = 20      # ψ y-constant


def _build_hc() -> np.ndarray:
    consts = [FQ2.one(), refsswu.Z_SSWU, refsswu.A_PRIME,
              -refsswu.A_PRIME, refsswu.Z_SSWU * refsswu.A_PRIME,
              refsswu.B_PRIME]
    consts += list(refsswu._XN)
    consts += list(refsswu._XD[:2])
    consts += list(refsswu._YN)
    consts += list(refsswu._YD[:3])
    consts += [codec._PSI_CX, codec._PSI_CY]
    rows = [fp.to_limbs(int(c) % P) for x in consts for c in x.coeffs]
    return np.stack(rows).astype(np.int32)


_HC_NP = _build_hc()
assert refsswu._XD[2] == FQ2.one() and refsswu._YD[3] == FQ2.one()


def iso3_const_planes() -> np.ndarray:
    """The isogeny's 13 Fp2 coefficients as [26, 32] limb planes, in the
    order of K23's constant block (`miller_program.MT_XN`..): the table's
    rows from k1_0 to k4_2."""
    return _HC_NP[2 * _HC_XN:2 * (_HC_YD + 3)].copy()


def sswu_const_planes() -> np.ndarray:
    """SSWU's six Fp2 constants (one, Z, A', −A', Z·A', B') as [12, 32]
    limb planes, in the order of K24's constant block
    (`miller_program.SW_ONE`..): the table's first rows."""
    return _HC_NP[2 * _HC_ONE:2 * (_HC_B + 1)].copy()


def psi_const_planes() -> np.ndarray:
    """ψ's constants c_x, c_y as [4, 32] limb planes (K22's "pre" reads
    them as input planes)."""
    return _HC_NP[2 * _HC_PSI_CX:2 * _HC_PSI_CY + 2].copy()


def h2c_consts() -> np.ndarray:
    """The constant table [42, 32] (the JAX `h2c_consts()` without its
    lane broadcast)."""
    return _HC_NP.copy()


def _cf2(idx: int, like: torch.Tensor):
    """Fp2 constant `idx` broadcast to the shape of `like` ([32, R])."""
    return _table_f2(_HC_NP, idx, like)


def _planes(*els) -> torch.Tensor:
    return torch.stack(els)


# ---------------------------------------------------------------------------
# Plain versions (the JAX kernel bodies on cuda_g2's plain field library)
# ---------------------------------------------------------------------------

def sswu_plain(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u [2, 32, R], w [R] the exceptional flag → [10, 32, R]
    (xn, xd, zu2, v1, v2): x1 = xn/xd on E', v1 = gx_num·xd with gx_num =
    g'(x1)·xd³ (so y1 = sqrt(v1)/xd²), v2 = (Z·u²)³·v1."""
    uu = (u[0], u[1])
    z = _cf2(_HC_Z, u[0])
    a = _cf2(_HC_A, u[0])
    na = _cf2(_HC_NEG_A, u[0])
    za = _cf2(_HC_ZA, u[0])
    b = _cf2(_HC_B, u[0])
    one = _cf2(_HC_ONE, u[0])
    u2 = _f2sqr(uu)
    zu2 = _f2mul(z, u2)
    zu2sq = _f2sqr(zu2)
    tv1 = _f2add(zu2sq, zu2)
    xd_reg = _f2mul(na, tv1)
    excb = w != 0
    xd = (torch.where(excb, za[0], xd_reg[0]),
          torch.where(excb, za[1], xd_reg[1]))
    xn = _f2mul(b, _f2add(tv1, one))
    xd2 = _f2sqr(xd)
    xd3 = _f2mul(xd2, xd)
    xn2 = _f2sqr(xn)
    xn3 = _f2mul(xn2, xn)
    gx_num = _f2add(_f2add(xn3, _f2mul(a, _f2mul(xn, xd2))),
                    _f2mul(b, xd3))
    v1 = _f2mul(gx_num, xd)
    zu2cu = _f2mul(zu2sq, zu2)
    v2 = _f2mul(zu2cu, v1)
    return _planes(*xn, *xd, *zu2, *v1, *v2)


def sqr_plain(a: torch.Tensor) -> torch.Tensor:
    return _planes(*_f2sqr((a[0], a[1])))


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _planes(*_f2mul((a[0], a[1]), (b[0], b[1])))


def sqr4_plain(a: torch.Tensor) -> torch.Tensor:
    acc = (a[0], a[1])
    for _ in range(4):
        acc = _f2sqr(acc)
    return _planes(*acc)


def sqr4mul_plain(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """One 4-bit window step of a fixed-exponent pow: acc ← acc¹⁶·m."""
    acc = (a[0], a[1])
    for _ in range(4):
        acc = _f2sqr(acc)
    return _planes(*_f2mul(acc, (m[0], m[1])))


def _horner(x, idxs, monic: bool):
    """Σ kᵢ·xⁱ by Horner; `idxs` are the table slots of k₀..k_deg (k_deg
    omitted and implied 1 when monic)."""
    if monic:
        acc = _f2add(x, _cf2(idxs[-1], x[0]))
    else:
        acc = _cf2(idxs[-1], x[0])
    for i in reversed(idxs[:-1]):
        acc = _f2add(_f2mul(acc, x), _cf2(i, x[0]))
    return acc


def iso3_plain(xy: torch.Tensor) -> torch.Tensor:
    """3-isogeny E' → E: affine (x, y) [4, 32, R] → projective [6, 32, R]
    (xn'·yd', y·yn'·xd', xd'·yd'); ∞ surfaces as Zo ≡ 0."""
    x = (xy[0], xy[1])
    y = (xy[2], xy[3])
    xnum = _horner(x, [_HC_XN + i for i in range(4)], monic=False)
    xden = _horner(x, [_HC_XD + i for i in range(2)], monic=True)
    ynum = _horner(x, [_HC_YN + i for i in range(4)], monic=False)
    yden = _horner(x, [_HC_YD + i for i in range(3)], monic=True)
    xo = _f2mul(xnum, yden)
    yo = _f2mul(y, _f2mul(ynum, xden))
    zo = _f2mul(xden, yden)
    return _planes(*xo, *yo, *zo)


def psi_plain(pt: torch.Tensor) -> torch.Tensor:
    """ψ on projective planes [6, 32, R]: (c_x·X̄, c_y·Ȳ, Z̄)."""
    cx = _cf2(_HC_PSI_CX, pt[0])
    cy = _cf2(_HC_PSI_CY, pt[0])
    xb = (pt[0], _negf(pt[1]))
    yb = (pt[2], _negf(pt[3]))
    xo = _f2mul(cx, xb)
    yo = _f2mul(cy, yb)
    return _planes(*xo, *yo, pt[4], _negf(pt[5]))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

#: kernel launches since the last `reset_launches()` (all threads;
#: `launch_count.this_thread()` has the calling thread's own)
LAUNCHES = {"h2c_sswu": 0, "h2c_sqr": 0, "h2c_mul": 0, "h2c_sqr4": 0,
            "h2c_sqr4mul": 0, "h2c_iso3": 0, "h2c_psi": 0, "g2_zmul": 0,
            "f2_chain": 0, "h2c_map_tail": 0, "h2c_sswu_head": 0}

#: K7 op codes (csrc/h2c.cu) and K9 kinds
_CHAIN = {"h2c_sqr": 0, "h2c_mul": 1, "h2c_sqr4": 2, "h2c_sqr4mul": 3}
_POINT = {"h2c_iso3": (0, 4), "h2c_psi": (1, 6)}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, t: torch.Tensor, planes: int, n: int) -> None:
    """A contiguous int32 [planes, 32, n] operand."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: int32 planes expected, got {t.dtype}")
    if t.dim() != 3 or tuple(t.shape) != (planes, NL, n) or n == 0:
        raise ValueError(f"{name}: expected [{planes}, 32, {n}], got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: operands must be contiguous")
    if 10 * NL * n >= 2 ** 31:
        raise ValueError(f"{name}: {n} rows exceed the int index")


def _same_device(name: str, *ts: torch.Tensor) -> None:
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{name}: operands on different devices")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _chain(name: str, a: torch.Tensor, b: torch.Tensor | None
           ) -> torch.Tensor:
    n = a.shape[-1]
    _check(name, a, 2, n)
    if b is not None:
        _check(name, b, 2, n)
        _same_device(name, a, b)
    _cuda_ready(name, a)
    out = torch.empty_like(a)
    err = build.library().charon_f2_chain(
        _CHAIN[name], out.data_ptr(), a.data_ptr(),
        0 if b is None else b.data_ptr(), n, _stream(a))
    _raise_on(name, err)
    launch_count.bump(LAUNCHES, name)
    return out


def h2c_sqr(a: torch.Tensor) -> torch.Tensor:
    """[2, 32, R] Fp2 rows → a²."""
    if a.device.type == "cpu":
        return sqr_plain(a)
    return _chain("h2c_sqr", a, None)


def h2c_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[2, 32, R] × [2, 32, R] → a·b."""
    if a.device.type == "cpu":
        return mul_plain(a, b)
    return _chain("h2c_mul", a, b)


def h2c_sqr4(a: torch.Tensor) -> torch.Tensor:
    """[2, 32, R] → a¹⁶."""
    if a.device.type == "cpu":
        return sqr4_plain(a)
    return _chain("h2c_sqr4", a, None)


def h2c_sqr4mul(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[2, 32, R] × [2, 32, R] → a¹⁶·m."""
    if a.device.type == "cpu":
        return sqr4mul_plain(a, m)
    return _chain("h2c_sqr4mul", a, m)


def h2c_sswu(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u [2, 32, R], w [R] int32 exceptional flags → [10, 32, R]."""
    if u.device.type == "cpu":
        return sswu_plain(u, w)
    n = u.shape[-1]
    _check("h2c_sswu", u, 2, n)
    if w.dtype != torch.int32 or tuple(w.shape) != (n,) \
            or not w.is_contiguous():
        raise ValueError(f"h2c_sswu: w must be a contiguous int32 [{n}] row")
    _same_device("h2c_sswu", u, w)
    _cuda_ready("h2c_sswu", u)
    out = u.new_empty((10, NL, n))
    err = build.library().charon_h2c_sswu(out.data_ptr(), u.data_ptr(),
                                          w.data_ptr(), n, _stream(u))
    _raise_on("h2c_sswu", err)
    launch_count.bump(LAUNCHES, "h2c_sswu")
    return out


def _point(name: str, x: torch.Tensor) -> torch.Tensor:
    kind, planes = _POINT[name]
    n = x.shape[-1]
    _check(name, x, planes, n)
    _cuda_ready(name, x)
    out = x.new_empty((6, NL, n))
    err = build.library().charon_h2c_point(kind, out.data_ptr(),
                                           x.data_ptr(), n, _stream(x))
    _raise_on(name, err)
    launch_count.bump(LAUNCHES, name)
    return out


def h2c_iso3(xy: torch.Tensor) -> torch.Tensor:
    """Affine E' points [4, 32, R] → projective E points [6, 32, R]."""
    if xy.device.type == "cpu":
        return iso3_plain(xy)
    return _point("h2c_iso3", xy)


def h2c_psi(pt: torch.Tensor) -> torch.Tensor:
    """ψ over projective points [6, 32, R]."""
    if pt.device.type == "cpu":
        return psi_plain(pt)
    return _point("h2c_psi", pt)


# ---------------------------------------------------------------------------
# Exactness boundaries and negations between launches
# ---------------------------------------------------------------------------

#: exact Fp2 equality / zero test of [2, 32, R] batches → [R] bool (the
#: port tower's element layout is the rows' layout)
f2_eq_rows = tower.f2_eq
f2_is_zero_rows = tower.f2_is_zero


def f2_eq_const_rows(a: torch.Tensor, const_planes: np.ndarray
                     ) -> torch.Tensor:
    """Exact equality against a host [2, 32] limb constant."""
    return tower.f2_eq(a, fp.elem(const_planes, a.device))


def f2_sgn0_rows(a: torch.Tensor) -> torch.Tensor:
    """RFC 9380 sgn0 (m = 2) of [2, 32, R] → [R] bool.  Parity needs the
    CANONICAL representative: one exact-carry canonicalisation each."""
    c0 = fp.canon_std(a[0])
    c1 = fp.canon_std(a[1])
    s0 = (c0[0] & 1) == 1
    z0 = torch.all(c0 == 0, dim=0)
    s1 = (c1[0] & 1) == 1
    return s0 | (z0 & s1)


def _f2_neg_t(a: torch.Tensor) -> torch.Tensor:
    """Negate an Fp2 batch (K1; bit-identical to the in-kernel negation)."""
    return _planes(fp.neg(a[0]), fp.neg(a[1]))


def _pt_neg_t(p: torch.Tensor) -> torch.Tensor:
    """Negate projective points [6, 32, R] (Y planes 2, 3)."""
    return torch.cat([p[0:2], fp.neg(p[2])[None], fp.neg(p[3])[None],
                      p[4:6]])


_F2_MINUS_ONE = np.stack([fp.to_limbs(P - 1), fp.ZERO])
#: K18 root's input block: v, then the constant one
CH_V = miller_program.CH_V


def _f2_sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _planes(_subf(a[0], b[0]), _subf(a[1], b[1]))


def _f2_is_zero_plain(a: torch.Tensor) -> torch.Tensor:
    return fp.is_zero(a[0]) & fp.is_zero(a[1])


# ---------------------------------------------------------------------------
# Drivers: fixed-exponent pow, Alg-9 sqrt, norm inversion
# ---------------------------------------------------------------------------

def _pow_digits(e: int) -> tuple[int, ...]:
    """Base-16 digits of a positive exponent, MSB first (first nonzero) —
    the static window schedule of the fixed addition chain."""
    assert e > 0
    return miller_program.pow_digits(e, 4)


#: The three chain exponents: Alg-9's two pows and the Fermat inversion.
EXP_SQRT_A1 = miller_program.EXP_SQRT_A1
EXP_SQRT_B = miller_program.EXP_SQRT_B
EXP_INV = miller_program.EXP_INV


def f2_pow_steps(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e over [2, 32, R] for a host-known exponent: a 15-entry window
    table (14 launches), then one K7 sqr4mul / sqr4 launch per 4-bit
    window, MSB first."""
    tbl = [None, a, h2c_sqr(a)]
    for k in range(3, 16):
        tbl.append(h2c_mul(tbl[k - 1], a))
    digs = _pow_digits(e)
    acc = tbl[digs[0]]
    for d in digs[1:]:
        acc = h2c_sqr4mul(acc, tbl[d]) if d else h2c_sqr4(acc)
    return acc


def f2_sqrt_steps(v: torch.Tensor):
    """Alg. 9 as K7 launches (2 pows, ~200 launches) and K1 glue: what
    K18's square-root program replaced, kept for the smoke run's
    comparison → (root, ok [R])."""
    a1 = f2_pow_steps(v, EXP_SQRT_A1)
    alpha = h2c_mul(h2c_sqr(a1), v)
    x0 = h2c_mul(a1, v)
    # branch 1: α = −1 ⇒ root = u·x0 = (−x0c1) + x0c0·u
    root_u = _planes(fp.neg(x0[1]), x0[0])
    # branch 2: root = (α+1)^((p−1)/2) · x0
    ap1 = _planes(fp.add(alpha[0], fp.elem(fp.ONE, v.device)), alpha[1])
    b = f2_pow_steps(ap1, EXP_SQRT_B)
    root_b = h2c_mul(b, x0)
    is_m1 = f2_eq_const_rows(alpha, _F2_MINUS_ONE)
    root = torch.where(is_m1, root_u, root_b)
    ok = f2_eq_rows(h2c_sqr(root), v)
    return root, ok


def f2_inv_steps(a: torch.Tensor) -> torch.Tensor:
    """a⁻¹ = ā·(a·ā)^(p−2) as K7 launches (inv(0) = 0): what K18's
    inverse program replaced."""
    ac = _planes(a[0], fp.neg(a[1]))
    n = h2c_mul(a, ac)
    ninv = f2_pow_steps(n, EXP_INV)
    return h2c_mul(ac, ninv)


def f2_affine_steps(xd, xn, zu2, root):
    """The map's affine step as K7 launches: what K18's affine program
    replaced → (xn·xd⁻¹, Z·u²·xn·xd⁻¹, root·xd⁻²)."""
    xdi = f2_inv_steps(xd)
    return (h2c_mul(xn, xdi), h2c_mul(h2c_mul(zu2, xn), xdi),
            h2c_mul(root, h2c_sqr(xdi)))


def chain_config(kind: str, rows: int, device) -> tuple:
    """The configuration K18 runs program `kind` with on `rows` rows of
    `device` (`miller_program.chain_config`; the CPU's plain version takes
    the default)."""
    device = torch.device(device)
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else 0)
    return miller_program.chain_config(kind, rows, sms)


def sqrt_select_plain(out: torch.Tensor, v: torch.Tensor):
    """The root's exact boundary on the sqrt program's 10 output planes
    (α, root_u, root_b, root_u², root_b²) and its v: the tests α = −1 and
    root² = v and the select → (root, ok [R]), plain tensor code (K18's
    epilogue computes the same on the card)."""
    alpha, root_u, root_b, sq_u, sq_b = out.split(2)
    is_m1 = _f2_is_zero_plain(_f2_sub_plain(alpha, fp.elem(_F2_MINUS_ONE,
                                                            v.device)))
    root = torch.where(is_m1, root_u, root_b)
    ok = _f2_is_zero_plain(_f2_sub_plain(torch.where(is_m1, sq_u, sq_b), v))
    return root, ok


def chain_plain(kind: str, inp: torch.Tensor, cfg=None):
    """K18's plain version: program `kind` executed on tensors
    (`chain_run_plain`), and for "sqrt" its exact boundary
    (`sqrt_select_plain`) → what `_run_chain` returns."""
    prog = miller_program.chain_program(
        kind, cfg or chain_config(kind, inp.shape[-1], inp.device))
    out = miller_program.chain_run_plain(prog, list(inp))
    return sqrt_select_plain(out, inp[CH_V:CH_V + 2]) if kind == "sqrt" \
        else out


def _run_chain(kind: str, inp: torch.Tensor, cfg):
    """K18: run program `kind` (miller_program.chain_program) on the
    [in planes, 32, R] input block under `cfg` (None: `chain_config`'s)
    → [out planes, 32, R]; for "sqrt" the kernel's epilogue takes the
    exact tests and the select, → (root [2, 32, R], ok [R] bool).  On the
    CPU its plain version, `chain_plain`, bit for bit."""
    if inp.device.type == "cpu":
        return chain_plain(kind, inp, cfg)
    prog = miller_program.chain_program(
        kind, cfg or chain_config(kind, inp.shape[-1], inp.device))
    _, in_planes, out_planes = miller_program.CHAINS[kind]
    n = inp.shape[-1]
    inp = inp.contiguous()
    _check("f2_chain", inp, in_planes, n)
    _cuda_ready("f2_chain", inp)
    code, fout, steps = miller_program.on_device(prog, inp.device)
    block = inp.permute(2, 0, 1).contiguous()
    sqrt = kind == "sqrt"
    out = inp.new_empty((2 if sqrt else out_planes, NL, n))
    ok = torch.empty(n, dtype=torch.bool, device=inp.device) if sqrt \
        else None
    err = build.library().charon_f2_chain_program(
        out.data_ptr(), 0 if ok is None else ok.data_ptr(), block.data_ptr(),
        code.data_ptr(), steps, fout.data_ptr(), in_planes, out_planes,
        prog.lanes, prog.slots, n, _stream(inp))
    _raise_on("f2_chain", err)
    launch_count.bump(LAUNCHES, "f2_chain")
    return (out, ok) if sqrt else out


def f2_sqrt_rows(v: torch.Tensor, cfg: tuple | None = None):
    """Batched Fp2 square root (Adj–Rodríguez-Henríquez Alg. 9) → (root,
    ok [R] bool); the root is garbage where ok is False.  ONE K18 launch:
    the chain — both pows, α, both candidate roots and their squares —
    and its exact boundary, the tests α = −1 and root² = v and the
    select (the kernel's epilogue)."""
    n = v.shape[-1]
    one = fp.const(fp.ONE, v.device).unsqueeze(-1).expand(NL, n)
    return _run_chain("sqrt", torch.cat([v, one[None]]), cfg)


def f2_inv_rows(a: torch.Tensor, cfg: tuple | None = None) -> torch.Tensor:
    """Batched Fp2 inversion, a⁻¹ = ā·(a·ā)^(p−2) (inv(0) = 0), in ONE K18
    launch."""
    return _run_chain("inv", a, cfg)


def f2_affine_rows(xd, xn, zu2, root, cfg: tuple | None = None):
    """The map's affine step in ONE K18 launch: xd⁻¹ and the products →
    (xn·xd⁻¹, Z·u²·xn·xd⁻¹, root·xd⁻²), each [2, 32, R]."""
    out = _run_chain("affine", torch.cat([xd, xn, zu2, root]), cfg)
    return out.split(2)


# ---------------------------------------------------------------------------
# ψ-cofactor clearing
# ---------------------------------------------------------------------------

#: Static 2-bit window schedule of |x| (the 64-bit BLS parameter): one
#: window for every row of a dblsel launch.
_Z_WINDOWS = miller_program.Z_WINDOWS
assert BLS_X.bit_length() == 64


def _zmul_with(q, dbl, add, dblsel) -> torch.Tensor:
    """[|x|]Q over [6, 32, R]: the table {Q, 2Q, 3Q} and 32 dblsel
    windows, each with one window for every row."""
    q2 = dbl(q)
    q3 = add(q2, q)
    n = q.shape[-1]
    rows = [torch.full((n,), w, dtype=torch.int32, device=q.device)
            for w in range(4)]
    acc = cuda_g2.inf_planes(n, q.device)
    for w in _Z_WINDOWS:
        acc = dblsel(acc, q, q2, q3, rows[w])
    return acc


def zmul_plain(q: torch.Tensor) -> torch.Tensor:
    """[|x|]Q on the plain K2 and K10 bodies (pallas_h2c `_zmul`)."""
    return _zmul_with(q, cuda_g2.dbl_plain, cuda_g2.add_plain,
                      cuda_g2.dblsel_plain)


def zmul_steps(q: torch.Tensor) -> torch.Tensor:
    """The same through the K2 and K10 wrappers (34 launches on the
    card): what K17 replaced, kept for the smoke run's comparison."""
    return _zmul_with(q, cuda_g2.dbl, cuda_g2.add, cuda_g2.dblsel)


def zmul(q: torch.Tensor, lanes: int = miller_program.ZM_LANES,
         slots: int = miller_program.ZM_SLOTS,
         window: int = miller_program.ZM_WINDOW) -> torch.Tensor:
    """K17: [|x|]Q over [6, 32, R] projective points in ONE launch,
    `lanes` threads a row running ops/miller_program.py's `zmul_program`
    with `slots` Fp elements of shared memory a row (and look-ahead
    `window`); `zmul_plain` on the CPU, bit for bit."""
    if q.device.type == "cpu":
        return zmul_plain(q)
    n = q.shape[-1]
    _check("g2_zmul", q, 6, n)
    _cuda_ready("g2_zmul", q)
    code, fout, steps = miller_program.on_device(
        miller_program.zmul_program(lanes, slots, window), q.device)
    consts = cuda_pairing._rows_of(cuda_pairing._CONST_PLANES, n, q.device)
    inp = torch.cat([q, consts]).permute(2, 0, 1).contiguous()
    out = q.new_empty((6, NL, n))
    err = build.library().charon_g2_zmul(
        out.data_ptr(), inp.data_ptr(), code.data_ptr(), steps,
        fout.data_ptr(), lanes, slots, n,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("g2_zmul", err)
    launch_count.bump(LAUNCHES, "g2_zmul")
    return out


def clear_cofactor_rows(p: torch.Tensor, psip: torch.Tensor,
                        psi2p2: torch.Tensor) -> torch.Tensor:
    """Budroni–Pintore clearing over projective points P [6, 32, R], with
    ψ(P) and ψ²(2P) from `g2_law("pre")`:

        h_eff·P = [x²−x−1]P + [x−1]ψ(P) + ψ²([2]P),   x = −|x|

    i.e. ([x²]P + [|x|]P − P) + (−[|x|]ψ(P) − ψ(P)) + ψ²(2P): three
    [|x|]-multiplies in two K17 launches ([|x|]P and [|x|]ψ(P) over both
    row sets at once), and the five additions with their three negations
    in one K22 launch (`g2_law("post")`)."""
    m = p.shape[-1]
    t0, xpsip = zmul(torch.cat([p, psip], dim=-1)).split(m, dim=-1)
    t1 = zmul(t0.contiguous())             # [x²]P
    return cuda_g2.g2_law("post", torch.cat([t1, t0, p, xpsip, psip,
                                             psi2p2]))


def law_steps(kind: str, block: torch.Tensor) -> torch.Tensor:
    """The K2 launch sequence (K1 for the negations, K9 for ψ) that K22's
    program `kind` replaced, on the same [in planes, 32, R] input block →
    the same output planes: kept for the smoke run's comparison.
    "tables" is `cuda_g2.straus_tables_steps`; "pre" the halves' sum R,
    its double, ψ(R) and ψ²(2R); "post" the clearing's additions as
    `clear_cofactor_rows` launched them before K22."""
    pts = list(block.split(6))
    if kind == "tables":
        return torch.cat(cuda_g2.straus_tables_steps(pts[0])[1:])
    if kind == "pre":
        r = cuda_g2.add(*pts)
        d = cuda_g2.dbl(r)
        return torch.cat([r, d, h2c_psi(r), h2c_psi(h2c_psi(d))])
    t1, t0, p, xpsip, psip, psi2p2 = pts
    part1 = cuda_g2.add(cuda_g2.add(t1, t0), _pt_neg_t(p))
    part2 = cuda_g2.add(_pt_neg_t(xpsip), _pt_neg_t(psip))
    return cuda_g2.add(cuda_g2.add(part1, part2), psi2p2)


# ---------------------------------------------------------------------------
# K23: the map's tail — x's select, the sign fix, the isogeny, the ∞ guard
# ---------------------------------------------------------------------------

def map_tail_plain(aff: torch.Tensor, ok1: torch.Tensor, sgn: torch.Tensor,
                   prog=None) -> torch.Tensor:
    """K23's plain version: the prologue (x = ok₁ ? x₁ : x₂; y negated
    where RFC 9380's sgn0(y) ≠ sgn0(u)) and the epilogue (the exact
    (0 : 1 : 0) where Z ≡ 0) as plain tensor code, the isogeny the
    kernel's program executed on tensors (`map_tail_run_plain`).
    aff [6, 32, R] = (x₁, x₂, y), ok1 [R] bool, sgn [R] int32 →
    [6, 32, R]."""
    prog = prog or miller_program.map_tail_program()
    x = torch.where(ok1, aff[0:2], aff[2:4])
    y = aff[4:6]
    flip = f2_sgn0_rows(y) != (sgn != 0)
    y = torch.where(flip, _planes(_negf(y[0]), _negf(y[1])), y)
    pt = miller_program.map_tail_run_plain(prog, x, y)
    inf_pt = fp.const(cuda_g2._INF_PLANES, aff.device).unsqueeze(-1)
    return torch.where(_f2_is_zero_plain(pt[4:6]), inf_pt, pt)


def map_tail_steps(aff: torch.Tensor, ok1: torch.Tensor, sgn: torch.Tensor
                   ) -> torch.Tensor:
    """The same tail as K9 ISO3, the K1 negation and the plain exact
    boundary launched it before K23 (`map_to_g2_rows` of the parent): kept
    for the smoke run's comparison."""
    x = torch.where(ok1, aff[0:2], aff[2:4])
    y = aff[4:6]
    flip = f2_sgn0_rows(y) != (sgn != 0)
    y = torch.where(flip, _f2_neg_t(y), y)
    pt = h2c_iso3(torch.cat([x, y]))
    inf_pt = fp.const(cuda_g2._INF_PLANES, aff.device).unsqueeze(-1)
    return torch.where(f2_is_zero_rows(pt[4:6]), inf_pt, pt)


def h2c_map_tail(aff: torch.Tensor, ok1: torch.Tensor, sgn: torch.Tensor,
                 cfg: tuple | None = None) -> torch.Tensor:
    """K23: the map's tail in ONE launch — x's select by ok₁, the sign
    fix, the 3-isogeny (ops/miller_program.py's `iso3_dag` on `lanes`
    threads a row, cfg = (lanes, slots, look-ahead), None: `MT_CONFIG`)
    and the ∞ guard.  aff [6, 32, R] = (x₁, x₂, y) as K18's affine step
    writes them, ok1 [R] bool, sgn [R] int32 → projective E points
    [6, 32, R]; `map_tail_plain` on the CPU, bit for bit."""
    prog = miller_program.map_tail_program(cfg)
    if aff.device.type == "cpu":
        return map_tail_plain(aff, ok1, sgn, prog)
    n = aff.shape[-1]
    _check("h2c_map_tail", aff, 6, n)
    for name, t, dtype in (("ok1", ok1, torch.bool), ("sgn", sgn,
                                                      torch.int32)):
        if t.dtype != dtype or tuple(t.shape) != (n,) or \
                not t.is_contiguous():
            raise ValueError(f"h2c_map_tail: {name} must be a contiguous "
                             f"{dtype} [{n}] row")
    _same_device("h2c_map_tail", aff, ok1, sgn)
    _cuda_ready("h2c_map_tail", aff)
    code, fout, steps = miller_program.on_device(prog, aff.device)
    consts = fp.const(prog.consts, aff.device)     # one block, every row
    out = aff.new_empty((6, NL, n))
    err = build.library().charon_h2c_map_tail(
        out.data_ptr(), aff.data_ptr(), ok1.data_ptr(), sgn.data_ptr(),
        consts.data_ptr(), code.data_ptr(), steps, fout.data_ptr(),
        prog.lanes, prog.slots, n, _stream(aff))
    _raise_on("h2c_map_tail", err)
    launch_count.bump(LAUNCHES, "h2c_map_tail")
    return out


# ---------------------------------------------------------------------------
# K24: SSWU with its flags — the exceptional flag and sgn0(u) — from u alone
# ---------------------------------------------------------------------------

def sswu_flags_plain(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K24's prologue in plain tensor code: u [2, 32, R] → (exc, sgn) [R]
    int32, exc the exceptional flag tv1 = 0, which holds exactly where
    u ≡ 0 (module docstring), and sgn RFC 9380's sgn0(u)."""
    return f2_is_zero_rows(u).int(), f2_sgn0_rows(u).int()


def sswu_head_plain(u: torch.Tensor, prog=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """K24's plain version: the prologue (`sswu_flags_plain`) and SSWU as
    the kernel's program executed on tensors (`sswu_run_plain`, the flag
    the SEL's digit).  u [2, 32, R] → ((xn, xd, Z·u², v1, v2) [10, 32, R],
    sgn0(u) [R] int32), the planes bit for bit K8's given the flag."""
    exc, sgn = sswu_flags_plain(u)
    prog = prog or miller_program.sswu_program()
    return miller_program.sswu_run_plain(prog, u, exc), sgn


def h2c_sswu_head(u: torch.Tensor, cfg: tuple | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K24: SSWU in ONE launch — the prologue's exceptional flag (u ≡ 0)
    and sgn0(u), then ops/miller_program.py's `sswu_dag` on `lanes`
    threads a row (cfg = (lanes, slots, look-ahead), None: `SW_CONFIG`).
    u [2, 32, R] canonical limbs → ((xn, xd, Z·u², v1, v2) [10, 32, R],
    sgn0(u) [R] int32); `sswu_head_plain` on the CPU, bit for bit."""
    prog = miller_program.sswu_program(cfg)
    if u.device.type == "cpu":
        return sswu_head_plain(u, prog)
    n = u.shape[-1]
    _check("h2c_sswu_head", u, 2, n)
    _cuda_ready("h2c_sswu_head", u)
    code, fout, steps = miller_program.on_device(prog, u.device)
    consts = fp.const(prog.consts, u.device)       # one block, every row
    out = u.new_empty((10, NL, n))
    sgn = torch.empty(n, dtype=torch.int32, device=u.device)
    err = build.library().charon_h2c_sswu_head(
        out.data_ptr(), sgn.data_ptr(), u.data_ptr(), consts.data_ptr(),
        code.data_ptr(), steps, fout.data_ptr(), prog.lanes, prog.slots, n,
        _stream(u))
    _raise_on("h2c_sswu_head", err)
    launch_count.bump(LAUNCHES, "h2c_sswu_head")
    return out, sgn


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

def map_to_g2_rows(u: torch.Tensor) -> torch.Tensor:
    """SSWU + sqrt + sign fix + 3-isogeny: u [2, 32, R] canonical limbs →
    [6, 32, R] projective points on E, one per u row (NOT
    cofactor-cleared): K24 (with the flags), the root (K18, its exact
    tests on the card), the affine step (K18) and the tail (K23, reading
    K24's sgn0(u))."""
    s = u.shape[-1]
    out, sgn = h2c_sswu_head(u)
    xn, xd, zu2 = out[0:2], out[2:4], out[4:6]
    v1, v2 = out[6:8], out[8:10]
    # ONE chain for both candidates, candidate 2 rows after candidate 1
    root, ok = f2_sqrt_rows(torch.cat([v1, v2], dim=-1))
    ok1 = ok[:s]
    rootsel = torch.where(ok1, root[..., :s], root[..., s:])
    # affine x, y via ONE inversion chain: x = xnum·xd⁻¹ with xnum = xn
    # where the first candidate's root checked, else Z·u²·xn (K23 picks);
    # y = sqrt(gx_num·xd)·xd⁻² (the xd³ fraction trick)
    aff = _run_chain("affine", torch.cat([xd, xn, zu2, rootsel]), None)
    # RFC sgn0 sign fix, the isogeny and its ∞ guard (zero denominator ⇒
    # Zo ≡ 0: the exact (0 : 1 : 0) the complete group law requires)
    return h2c_map_tail(aff, ok1, sgn)


def hash_to_g2_rows(u: torch.Tensor) -> torch.Tensor:
    """The device hash-to-G2 over a u-major batch of 2m rows (`pack_
    messages`) → [6, 32, m] cleared projective G2 points, one per
    message.  The two mapped halves' sum R, its double, ψ(R) and ψ²(2R)
    are ONE K22 launch (`g2_law("pre")`) on the halves' planes side by
    side."""
    half = u.shape[-1] // 2
    mapped = map_to_g2_rows(u)
    r, _, psir, psi2r2 = cuda_g2.g2_law(
        "pre", torch.cat([mapped[..., :half], mapped[..., half:]])).split(6)
    return clear_cofactor_rows(r, psir, psi2r2)


# ---------------------------------------------------------------------------
# Host half: SHA-256 expand + hash_to_field
# ---------------------------------------------------------------------------

def _pack_u(us: list[FQ2]) -> np.ndarray:
    """Fp2 u values → their canonical limb planes [2, 32, n] int32, split
    in one numpy pass: each coefficient's 48 little-endian bytes, three
    bytes to two 12-bit limbs (`fp.to_limbs`'s limbs, bit for bit)."""
    n = len(us)
    raw = b"".join(int(c).to_bytes(48, "little") for u in us
                   for c in u.coeffs)
    b = np.frombuffer(raw, np.uint8).reshape(n, 2, NL // 2, 3)
    b = b.astype(np.int32)
    limbs = np.stack([b[..., 0] | (b[..., 1] & 0xF) << 8,
                      b[..., 1] >> 4 | b[..., 2] << 4], axis=-1)
    return np.ascontiguousarray(limbs.reshape(n, 2, NL).transpose(1, 2, 0))


def pack_messages(msgs, dst: bytes = DST_G2) -> np.ndarray:
    """expand_message_xmd + hash_to_field for m messages → u [2, 32, 2m]
    int32, u-major (row j·m + k = u_j of message k).  K24 derives the
    flags on the card."""
    pairs = [hash_to_field_fp2(msg, 2, dst) for msg in msgs]
    return _pack_u([p[0] for p in pairs] + [p[1] for p in pairs])
