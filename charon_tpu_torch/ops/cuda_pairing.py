"""Kernels K4–K6 and K13–K15 — the batched Miller loop, its product fold
and the RLC scaling on the card (csrc/pairing.cu, csrc/miller.cu,
csrc/fold.cu, csrc/g1_scalar_mul.cu).

The counterpart of the JAX package's ops/pallas_pairing.py:

- K4 `pp_step<DBL|ADD>` replaces `_pp_dbl_kernel` / `_pp_add_kernel`: a
  Miller doubling or mixed-addition step on the projective twist point
  plus its sparse line (c0, c1b, c4b).
- K5 `f12_step<SQR|MUL014|F12MUL>` replaces `_pp_sqr_kernel`,
  `_pp_mul014_kernel` (f·ℓ(P), the line scaled by zP so P stays
  projective) and `_pp_f12mul_kernel` (the product fold).
- K6 `g1_dblsel` replaces `_pp_g1_dblsel_kernel`: one 2-bit window of
  the per-row G1 scalar multiplication (acc ← 4·acc + table[w]) that
  scales each pair row by its random RLC coefficient.
- K13 `miller_loop` replaces the launch sequence of `miller_rows`
  (:489): the whole loop — 63 doublings, 5 additions, 62 squarings and
  68 line multiplies, 198 K4/K5 launches a tile — in ONE launch, 8
  threads per pair row running the op program of ops/miller_program.py
  on the row's state in shared memory.  `miller_rows` (the verify path's
  Miller loop and its per-row re-check) calls it; K4 and the K5
  sqr/mul014 steps remain for the smoke run's kernel phase and as the
  plain bodies K13 is held to (`miller_loop_plain`).
- K14 `f12_fold` replaces the fold's log₂ R K5 F12MUL launches
  (`fold_product_plain`; pallas_pairing `miller_product_tiled` :535):
  the product of all rows in ONE cooperative launch, a warp per Fp12
  product, the levels separated by a grid-wide barrier, dropped rows read
  as one.  `fold_product` calls it.
- K15 `g1_scalar_mul` replaces the 32 K6 launches of the RLC scaling
  (`g1_scalar_mul_plain`; pallas_pairing `g1_scalar_mul_rows` :520): the
  windows as one op program (ops/miller_program.py `g1_program`) run by
  K13's interpreter, `G1_LANES` threads a row.  `g1_scalar_mul_rows`
  calls it; on the verify path its program also negates y (`neg_y`), so
  the Miller p-side comes out of the launch with no K1 negation.  K6 and K5 F12MUL stay: K6 for the smoke run's kernel phase
  and as the plain window K15 is held to, F12MUL for the re-check's one
  product of halves.
- K20 `g1_tables` replaces the K1 launches of the RLC tables (31 a tile:
  `curve.double_point` and `add_points` on `FP_OPS`, the JAX backend's
  `_rlc_g1_tables_kernel`): 2P and 3P of the pair rows as ONE straight-
  line program (ops/miller_program.py `g1_tables_program`, `Dag.
  g1_double` then `g1_add`) on K15's interpreter settings.

In K4–K6 one thread per pair row runs a whole step with every
intermediate in its registers and local memory.  The field arithmetic is
the JAX package's (the in-kernel library of pallas_g2: lazy-Karatsuba
Fp2, fold-reduced Fp), so each kernel is BIT-IDENTICAL to its plain
version here — the port of the `_DIRECT_FNS` bodies, which the CPU tests
compare with JAX and the chip smoke compares with the kernel.

LAYOUT.  A batch of n-plane rows is ``[n, 32, R]`` int32: an Fp12 12
planes (plane m = (k·3 + j)·2 + c), a Miller accumulator (X, Y, Z) 6, a
line 6, an affine G2 point (x, y) 4, a G1 point 3 — for the Miller
p-side (xP, −yP, zP).  K4 returns ``[12, 32, R]``: the next accumulator
in planes 0–5 and the line in 6–11 (slices, no copy).  K5 F12MUL reads
its two operands at a row stride of their own, so the fold multiplies
the halves of one tensor without copying them.

Every wrapper routes a CPU tensor to the plain version and launches the
kernel for a CUDA tensor (or raises).  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tbls.ref.fields import BLS_X
from . import build, fp, launch_count, miller_program
from .cuda_g2 import (_addf, _cuda_ready, _f2add, _f2mul, _f2small, _f2sqr,
                      _f2sub, _msmall, _mulf, _raise_on, _subf)

NL = fp.NLIMBS

# Miller-loop schedule: bits of |z| below the leading one, MSB first (63
# doubling steps; its 5 set bits add a mixed-addition step).
LOOP_BITS = tuple(int(b) for b in bin(BLS_X)[3:])

F12_PLANES, XYZ_PLANES, LINE_PLANES, Q_PLANES, P_PLANES = 12, 6, 6, 4, 3


# ---------------------------------------------------------------------------
# Plain versions: the bodies of pallas_pairing's `_DIRECT_FNS`, on the
# plain field library of cuda_g2.  An Fp element is a [32, R] tensor, an
# Fp2 a (c0, c1) tuple, an Fp6 a triple of Fp2, an Fp12 a pair of Fp6.
# ---------------------------------------------------------------------------

def _f2_mul_xi(a):
    """×ξ = (1 + u): (a0 − a1) + (a0 + a1)·u."""
    return (_subf(a[0], a[1]), _addf(a[0], a[1]))


def _f2_mul_fp(a, s):
    return (_mulf(a[0], s), _mulf(a[1], s))


def _f6_add(a, b):
    return tuple(_f2add(x, y) for x, y in zip(a, b))


def _f6_sub(a, b):
    return tuple(_f2sub(x, y) for x, y in zip(a, b))


def _f6_mul_by_v(a):
    return (_f2_mul_xi(a[2]), a[0], a[1])


def _f6_mul(a, b):
    """Toom-style Fp6 product — 6 Fp2 products."""
    v0 = _f2mul(a[0], b[0])
    v1 = _f2mul(a[1], b[1])
    v2 = _f2mul(a[2], b[2])
    t12 = _f2sub(_f2mul(_f2add(a[1], a[2]), _f2add(b[1], b[2])),
                 _f2add(v1, v2))
    t01 = _f2sub(_f2mul(_f2add(a[0], a[1]), _f2add(b[0], b[1])),
                 _f2add(v0, v1))
    t02 = _f2sub(_f2mul(_f2add(a[0], a[2]), _f2add(b[0], b[2])),
                 _f2add(v0, v2))
    return (_f2add(v0, _f2_mul_xi(t12)), _f2add(t01, _f2_mul_xi(v2)),
            _f2add(t02, v1))


def _f6_mul_by_01(a, d0, d1):
    """Sparse (d0 + d1·v) product — 5 Fp2 products."""
    v0 = _f2mul(a[0], d0)
    v1 = _f2mul(a[1], d1)
    x12 = _f2mul(_f2add(a[1], a[2]), d1)
    x01 = _f2mul(_f2add(a[0], a[1]), _f2add(d0, d1))
    x02 = _f2mul(_f2add(a[0], a[2]), d0)
    return (_f2add(v0, _f2_mul_xi(_f2sub(x12, v1))),
            _f2sub(x01, _f2add(v0, v1)),
            _f2add(_f2sub(x02, v0), v1))


def _f12_unstack(f):
    """[12, 32, R] → ((f6), (f6)) nested Fp2 tuples."""
    def f6_at(base):
        return ((f[base], f[base + 1]), (f[base + 2], f[base + 3]),
                (f[base + 4], f[base + 5]))

    return f6_at(0), f6_at(6)


def _f12_stack(b0, b1):
    return torch.stack([c for f6 in (b0, b1) for f2 in f6 for c in f2])


def _f12_sqr(f):
    a0, a1 = _f12_unstack(f)
    v0 = _f6_mul(a0, a1)
    t = _f6_mul(_f6_add(a0, a1), _f6_add(a0, _f6_mul_by_v(a1)))
    c0 = _f6_sub(_f6_sub(t, v0), _f6_mul_by_v(v0))
    c1 = tuple((_msmall(c[0], 2), _msmall(c[1], 2)) for c in v0)
    return _f12_stack(c0, c1)


def _f12_mul(f, g):
    a0, a1 = _f12_unstack(f)
    b0, b1 = _f12_unstack(g)
    aa = _f6_mul(a0, b0)
    bb = _f6_mul(a1, b1)
    cross = _f6_mul(_f6_add(a0, a1), _f6_add(b0, b1))
    c1 = _f6_sub(cross, _f6_add(aa, bb))
    c0 = _f6_add(aa, _f6_mul_by_v(bb))
    return _f12_stack(c0, c1)


def _f12_mul_by_014(f, c0, c1, c4):
    """f · ((c0 + c1·v) + c4·v·w) — 13 Fp2 products."""
    a0, a1 = _f12_unstack(f)
    aa = _f6_mul_by_01(a0, c0, c1)
    t6 = _f6_mul_by_01(_f6_add(a0, a1), c0, _f2add(c1, c4))
    b0 = _f2mul(a1[0], c4)
    b1 = _f2mul(a1[1], c4)
    b2 = _f2mul(a1[2], c4)
    bb = (_f2_mul_xi(b2), b0, b1)
    r1 = _f6_sub(t6, _f6_add(aa, bb))
    r0 = _f6_add(_f6_mul_by_v(bb), aa)
    return _f12_stack(r0, r1)


def _xyz_unstack(a):
    return (a[0], a[1]), (a[2], a[3]), (a[4], a[5])


def _planes(*els):
    return torch.stack(els)


def _dbl_step(xyz):
    """Projective doubling on the twist + line coeffs (c0, c1b, c4b),
    scaled by 2YZ²."""
    X, Y, Z = _xyz_unstack(xyz)
    XX = _f2sqr(X)
    YY = _f2sqr(Y)
    s = _f2mul(Y, Z)
    XY = _f2mul(X, Y)
    w = _f2small(XX, 3)
    ss = _f2sqr(s)
    B = _f2mul(XY, s)
    c1b = _f2mul(w, Z)
    wX = _f2mul(w, X)
    YYZ = _f2mul(YY, Z)
    sZ = _f2mul(s, Z)
    wsq = _f2sqr(w)
    YYss = _f2mul(YY, ss)
    sss = _f2mul(s, ss)
    h = _f2sub(wsq, _f2small(B, 8))
    hs = _f2mul(h, s)
    wterm = _f2mul(w, _f2sub(_f2small(B, 4), h))
    X3 = _f2small(hs, 2)
    Y3 = _f2sub(wterm, _f2small(YYss, 8))
    Z3 = _f2small(sss, 8)
    c0 = _f2sub(_f2small(YYZ, 2), wX)
    c4b = _f2small(sZ, 2)
    return _planes(*X3, *Y3, *Z3, *c0, *c1b, *c4b)


def _add_step(xyz, q):
    """Mixed addition R + Q (Q affine) + line coeffs, scaled by δ."""
    X1, Y1, Z1 = _xyz_unstack(xyz)
    x2, y2 = (q[0], q[1]), (q[2], q[3])
    yZ = _f2mul(y2, Z1)
    xZ = _f2mul(x2, Z1)
    theta = _f2sub(Y1, yZ)
    delta = _f2sub(X1, xZ)
    c = _f2sqr(theta)
    d = _f2sqr(delta)
    dy = _f2mul(delta, y2)
    tx = _f2mul(theta, x2)
    e = _f2mul(delta, d)
    f_ = _f2mul(Z1, c)
    g = _f2mul(X1, d)
    h = _f2sub(_f2add(e, f_), _f2small(g, 2))
    X3 = _f2mul(delta, h)
    t = _f2mul(theta, _f2sub(g, h))
    eY = _f2mul(e, Y1)
    Z3 = _f2mul(Z1, e)
    Y3 = _f2sub(t, eY)
    c0 = _f2sub(dy, tx)
    return _planes(*X3, *Y3, *Z3, *c0, *theta, *delta)


def _g1_double(p):
    x, y, z = p[0], p[1], p[2]
    yy = _mulf(y, y)
    yz = _mulf(y, z)
    zz = _mulf(z, z)
    xy = _mulf(x, y)
    bzz = _msmall(zz, 12)
    e8 = _msmall(yy, 8)
    s = _addf(yy, bzz)
    d = _subf(yy, _msmall(bzz, 3))
    x3 = _msmall(_mulf(d, xy), 2)
    y3 = _addf(_mulf(bzz, e8), _mulf(d, s))
    z3 = _mulf(yz, e8)
    return _planes(x3, y3, z3)


def _g1_add(p1, p2):
    x1, y1, z1 = p1[0], p1[1], p1[2]
    x2, y2, z2 = p2[0], p2[1], p2[2]
    t0 = _mulf(x1, x2)
    t1 = _mulf(y1, y2)
    t2 = _mulf(z1, z2)
    pxy = _mulf(_addf(x1, y1), _addf(x2, y2))
    pyz = _mulf(_addf(y1, z1), _addf(y2, z2))
    pxz = _mulf(_addf(x1, z1), _addf(x2, z2))
    t3 = _subf(pxy, _addf(t0, t1))           # X1Y2 + X2Y1
    t4 = _subf(pyz, _addf(t1, t2))           # Y1Z2 + Y2Z1
    t5 = _subf(pxz, _addf(t0, t2))           # X1Z2 + X2Z1
    m = _msmall(t0, 3)
    bz = _msmall(t2, 12)
    s = _addf(t1, bz)
    d = _subf(t1, bz)
    by = _msmall(t5, 12)
    x3 = _subf(_mulf(t3, d), _mulf(t4, by))
    y3 = _addf(_mulf(d, s), _mulf(m, by))
    z3 = _addf(_mulf(t4, s), _mulf(t3, m))
    return _planes(x3, y3, z3)


def _line_eval(f, line, p):
    """f ← f · ℓ(P) for projective P = (xP, −yP, zP): the line is scaled
    by zP, an Fp factor the final exponentiation annihilates."""
    c0b, c1b, c4b = (line[0], line[1]), (line[2], line[3]), (line[4], line[5])
    return _f12_mul_by_014(f, _f2_mul_fp(c0b, p[2]), _f2_mul_fp(c1b, p[0]),
                           _f2_mul_fp(c4b, p[1]))


def pp_dbl_plain(xyz: torch.Tensor) -> torch.Tensor:
    return _dbl_step(xyz)


def pp_add_plain(xyz: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return _add_step(xyz, q)


def pp_sqr_plain(f: torch.Tensor) -> torch.Tensor:
    return _f12_sqr(f)


def pp_mul014_plain(f: torch.Tensor, line: torch.Tensor,
                    p: torch.Tensor) -> torch.Tensor:
    return _line_eval(f, line, p)


def pp_f12mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _f12_mul(a, b)


def g1_dblsel_plain(acc, t1, t2, t3, w: torch.Tensor) -> torch.Tensor:
    """acc ← 4·acc + table[w]; w = 0 keeps the doubled accumulator."""
    acc4 = _g1_double(_g1_double(acc))
    sel = torch.where(w == 1, t1, torch.where(w == 2, t2, t3))
    return torch.where(w == 0, acc4, _g1_add(acc4, sel))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

#: kernel launches since the last `reset_launches()` (all threads;
#: `launch_count.this_thread()` has the calling thread's own)
LAUNCHES = {"pp_dbl": 0, "pp_add": 0, "pp_sqr": 0, "pp_mul014": 0,
            "pp_f12mul": 0, "g1_dblsel": 0, "miller_loop": 0,
            "miller_thread": 0, "f12_fold": 0, "g1_scalar_mul": 0,
            "g1_tables": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, t: torch.Tensor, planes: int, n: int,
           stride: int | None = None) -> None:
    """An int32 [planes, 32, n] operand on the operand device, row-stride
    `stride` (contiguous when None)."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: int32 planes expected, got {t.dtype}")
    if t.dim() != 3 or tuple(t.shape) != (planes, NL, n) or n == 0:
        raise ValueError(f"{name}: expected [{planes}, 32, {n}], got "
                         f"{tuple(t.shape)}")
    st = n if stride is None else stride
    if t.stride() != (NL * st, st, 1):
        raise ValueError(f"{name}: operand strides {t.stride()} are not "
                         f"those of row stride {st}")
    if planes * NL * st >= 2 ** 31:
        raise ValueError(f"{name}: {planes * NL * st} limbs exceed the int "
                         f"index")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _same_device(name: str, *ts: torch.Tensor) -> None:
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{name}: operands on different devices")


def pp_dbl(xyz: torch.Tensor) -> torch.Tensor:
    """[6, 32, R] Miller accumulators → [12, 32, R] (2·R, line)."""
    if xyz.device.type == "cpu":
        return pp_dbl_plain(xyz)
    n = xyz.shape[-1]
    _check("pp_dbl", xyz, XYZ_PLANES, n)
    _cuda_ready("pp_dbl", xyz)
    out = xyz.new_empty((F12_PLANES, NL, n))
    err = build.library().charon_pp_step(0, out.data_ptr(), xyz.data_ptr(),
                                         0, n, _stream(xyz))
    _raise_on("pp_dbl", err)
    launch_count.bump(LAUNCHES, "pp_dbl")
    return out


def pp_add(xyz: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[6, 32, R] accumulators + [4, 32, R] affine Q → [12, 32, R]."""
    if xyz.device.type == "cpu":
        return pp_add_plain(xyz, q)
    n = xyz.shape[-1]
    _check("pp_add", xyz, XYZ_PLANES, n)
    _check("pp_add", q, Q_PLANES, n)
    _same_device("pp_add", xyz, q)
    _cuda_ready("pp_add", xyz)
    out = xyz.new_empty((F12_PLANES, NL, n))
    err = build.library().charon_pp_step(1, out.data_ptr(), xyz.data_ptr(),
                                         q.data_ptr(), n, _stream(xyz))
    _raise_on("pp_add", err)
    launch_count.bump(LAUNCHES, "pp_add")
    return out


def _f12_step(name: str, kind: int, a: torch.Tensor, b, p,
              istride: int) -> torch.Tensor:
    n = a.shape[-1]
    _check(name, a, F12_PLANES, n, istride)
    if kind == 1:
        _check(name, b, LINE_PLANES, n, istride)
        _check(name, p, P_PLANES, n, istride)
        _same_device(name, a, b, p)
    elif kind == 2:
        _check(name, b, F12_PLANES, n, istride)
        _same_device(name, a, b)
    _cuda_ready(name, a)
    out = a.new_empty((F12_PLANES, NL, n))
    err = build.library().charon_f12_step(
        kind, out.data_ptr(), a.data_ptr(),
        0 if b is None else b.data_ptr(), 0 if p is None else p.data_ptr(),
        n, istride, _stream(a))
    _raise_on(name, err)
    launch_count.bump(LAUNCHES, name)
    return out


def pp_sqr(f: torch.Tensor) -> torch.Tensor:
    """[12, 32, R] → f²."""
    if f.device.type == "cpu":
        return pp_sqr_plain(f)
    return _f12_step("pp_sqr", 0, f, None, None, f.shape[-1])


def pp_mul014(f: torch.Tensor, line: torch.Tensor,
              p: torch.Tensor) -> torch.Tensor:
    """f [12, 32, R] · ℓ(P): line [6, 32, R], p (xP, −yP, zP) [3, 32, R]."""
    if f.device.type == "cpu":
        return pp_mul014_plain(f, line, p)
    return _f12_step("pp_mul014", 1, f, line, p, f.shape[-1])


def pp_f12mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b over [12, 32, n] operands that share one row stride ≥ n (two
    contiguous tensors, or two row slices of one tensor)."""
    if a.device.type == "cpu":
        return pp_f12mul_plain(a, b)
    return _f12_step("pp_f12mul", 2, a, b, None, a.stride(1))


def g1_dblsel(acc: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor,
              t3: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One 2-bit window of the per-row G1 scalar multiplication:
    [3, 32, R] accumulators and tables {P, 2P, 3P}, w [R] int32 in 0..3."""
    if acc.device.type == "cpu":
        return g1_dblsel_plain(acc, t1, t2, t3, w)
    n = acc.shape[-1]
    for t in (acc, t1, t2, t3):
        _check("g1_dblsel", t, P_PLANES, n)
    if w.dtype != torch.int32 or tuple(w.shape) != (n,) \
            or not w.is_contiguous():
        raise ValueError(f"g1_dblsel: w must be a contiguous int32 [{n}] row")
    _same_device("g1_dblsel", acc, t1, t2, t3, w)
    _cuda_ready("g1_dblsel", acc)
    out = torch.empty_like(acc)
    err = build.library().charon_g1_dblsel(
        out.data_ptr(), acc.data_ptr(), t1.data_ptr(), t2.data_ptr(),
        t3.data_ptr(), w.data_ptr(), n, _stream(acc))
    _raise_on("g1_dblsel", err)
    launch_count.bump(LAUNCHES, "g1_dblsel")
    return out


# ---------------------------------------------------------------------------
# Constants, layout helpers and the launch sequences
# ---------------------------------------------------------------------------

_F12_ONE = np.zeros((F12_PLANES, NL), np.int32)
_F12_ONE[0] = fp.ONE
_G1_INF = np.zeros((P_PLANES, NL), np.int32)
_G1_INF[1] = fp.ONE                      # (0 : 1 : 0)
_F2_ONE_PLANES = np.zeros((2, NL), np.int32)
_F2_ONE_PLANES[0] = fp.ONE


def _rows_of(planes: np.ndarray, n: int, device) -> torch.Tensor:
    return fp.const(planes, device).unsqueeze(-1).expand(
        *planes.shape, n).contiguous()


def f12_one(n: int, device) -> torch.Tensor:
    """n rows of Fp12 one as [12, 32, n]."""
    return _rows_of(_F12_ONE, n, device)


def g1_inf(n: int, device) -> torch.Tensor:
    """n G1 points at infinity as [3, 32, n]."""
    return _rows_of(_G1_INF, n, device)


def g1_proj_rows(pts: torch.Tensor) -> torch.Tensor:
    """[3, 32, R] projective G1 points → (xP, −yP, zP) Miller p-side planes
    (the Y negation happens once, here)."""
    return torch.stack([pts[0], fp.neg(pts[1]), pts[2]])


def g2_affine_rows(pts: torch.Tensor) -> torch.Tensor:
    """[3, 2, 32, R] packed affine G2 points (Z ignored; ∞ rows are masked
    downstream) → [4, 32, R] (x_c0, x_c1, y_c0, y_c1)."""
    return pts[:2].reshape(Q_PLANES, NL, pts.shape[-1]).contiguous()


def windows_from_bits(bits: np.ndarray) -> np.ndarray:
    """Host: [R, nbits] scalar bit planes (MSB first) → [nbits/2, R] 2-bit
    window indices, iteration-major (pallas_g2.windows_from_bits without
    its lane tiling)."""
    r, nbits = bits.shape
    assert nbits % 2 == 0
    w = bits[:, 0::2] * 2 + bits[:, 1::2]
    return np.ascontiguousarray(w.T.astype(np.int32))


def _step_sequence(p, q, sqr, dbl, add, mul014) -> torch.Tensor:
    r = p.shape[-1]
    xyz = torch.cat([q, _rows_of(_F2_ONE_PLANES, r, q.device)])  # (x, y, 1)
    f = f12_one(r, p.device)
    for i, bit in enumerate(LOOP_BITS):
        if i:
            f = sqr(f)                      # f = 1 on step 0
        out = dbl(xyz)
        xyz, line = out[:XYZ_PLANES], out[XYZ_PLANES:]
        f = mul014(f, line, p)
        if bit:
            out = add(xyz, q)
            xyz, line = out[:XYZ_PLANES], out[XYZ_PLANES:]
            f = mul014(f, line, p)
    return f


def miller_loop_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The Miller loop as the K4/K5 step sequence on their plain bodies:
    62 squarings, 63 doublings, 5 additions and 68 line multiplies."""
    return _step_sequence(p, q, pp_sqr_plain, pp_dbl_plain, pp_add_plain,
                          pp_mul014_plain)


def miller_steps(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The same sequence through the K4/K5 step wrappers (198 launches on
    the card): what K13 replaced, kept for the smoke run's comparison."""
    return _step_sequence(p, q, pp_sqr, pp_dbl, pp_add, pp_mul014)


_CONST_PLANES = np.stack([fp.ONE, fp.ZERO, fp.ZERO, fp.ZERO])  # (1,0), (0,0)
_G1_CONST_PLANES = np.stack([fp.ONE, fp.ZERO])


def _check_pairs(name: str, p: torch.Tensor, q: torch.Tensor) -> int:
    n = p.shape[-1]
    _check(name, p, P_PLANES, n)
    _check(name, q, Q_PLANES, n)
    _same_device(name, p, q)
    _cuda_ready(name, p)
    return n


def miller_loop(p: torch.Tensor, q: torch.Tensor,
                lanes: int = miller_program.LANES,
                slots: int = miller_program.SLOTS,
                window: int = miller_program.WINDOW) -> torch.Tensor:
    """K13: the whole Miller loop (`miller_loop_plain`) in one launch,
    `lanes` threads per pair row running the program ops/miller_program.py
    schedules with `slots` Fp elements of shared memory a row (and its
    look-ahead `window`).  p [3, 32, R], q [4, 32, R] → f [12, 32, R]."""
    if p.device.type == "cpu":
        return miller_loop_plain(p, q)
    n = _check_pairs("miller_loop", p, q)
    code, fout, steps = miller_program.on_device(
        miller_program.miller_program(lanes, slots, window), p.device)
    consts = _rows_of(_CONST_PLANES, n, p.device)
    inp = torch.cat([p, q, consts]).permute(2, 0, 1).contiguous()
    out = p.new_empty((F12_PLANES, NL, n))
    err = build.library().charon_miller_loop(
        out.data_ptr(), inp.data_ptr(), code.data_ptr(), steps,
        fout.data_ptr(), lanes, slots, n, _stream(p))
    _raise_on("miller_loop", err)
    launch_count.bump(LAUNCHES, "miller_loop")
    return out


def miller_thread(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """K13's probe design: the same loop in one launch, ONE thread per
    row running the K4/K5 functions on its stack (csrc/miller.cu
    `miller_thread_kernel`).  No path calls it; the smoke run times it."""
    if p.device.type == "cpu":
        return miller_loop_plain(p, q)
    n = _check_pairs("miller_thread", p, q)
    out = p.new_empty((F12_PLANES, NL, n))
    err = build.library().charon_miller_thread(
        out.data_ptr(), p.data_ptr(), q.data_ptr(), n, _stream(p))
    _raise_on("miller_thread", err)
    launch_count.bump(LAUNCHES, "miller_thread")
    return out


def miller_rows(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Batched Miller loop f_{|z|,Q}(P) over pair rows: one K13 launch
    (`miller_loop`) on the card, its plain version on the CPU.

    p [3, 32, R] projective G1 planes (xP, −yP, zP), q [4, 32, R] affine
    G2 planes → f [12, 32, R].

    NOT conjugated for the negative BLS parameter: conjugation commutes
    with the final exponentiation, so product-is-one checks are
    unaffected; `ops.pairing.miller_loop` equals conj(row).  Rows whose P
    or Q is at infinity produce garbage — mask them to 1 (`mask_rows`)
    before the fold."""
    return miller_loop(p, q)


def mask_rows(f: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    """Rows flagged in `drop` [R] (infinity members, rejected entries,
    padding) become Fp12 one."""
    return torch.where(drop, fp.const(_F12_ONE, f.device).unsqueeze(-1), f)


def fold_product_plain(f: torch.Tensor) -> torch.Tensor:
    """[12, 32, R] (R a power of two) → [12, 32, 1], the product of all
    rows: log₂ R F12MUL plain bodies, the lower half times the upper."""
    s = f.shape[-1]
    assert s & (s - 1) == 0, f"R={s} must be a power of two"
    while s > 1:
        s //= 2
        f = pp_f12mul_plain(f[..., :s], f[..., s:2 * s])
    return f


def fold_steps(f: torch.Tensor) -> torch.Tensor:
    """The same fold through the K5 F12MUL wrapper (log₂ R launches on the
    card): what K14 replaced, kept for the smoke run's comparison."""
    s = f.shape[-1]
    while s > 1:
        s //= 2
        f = pp_f12mul(f[..., :s], f[..., s:2 * s])
    return f


def fold_product(f: torch.Tensor, drop: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """K14: [12, 32, R] (R a power of two) → [12, 32, 1], the product of
    all rows, rows flagged in `drop` [R] bool read as Fp12 one — ONE
    launch on the card; `fold_product_plain(mask_rows(f, drop))` on the
    CPU, bit for bit."""
    if f.device.type == "cpu":
        return fold_product_plain(f if drop is None else mask_rows(f, drop))
    n = f.shape[-1]
    if n & (n - 1):
        raise ValueError(f"f12_fold: R={n} must be a power of two")
    _check("f12_fold", f, F12_PLANES, n)
    if drop is not None:
        if drop.dtype != torch.bool or tuple(drop.shape) != (n,) \
                or not drop.is_contiguous():
            raise ValueError(f"f12_fold: drop must be a contiguous bool "
                             f"[{n}] row")
        _same_device("f12_fold", f, drop)
    _cuda_ready("f12_fold", f)
    out = f.new_empty((F12_PLANES, NL, 1))
    scratch = f.new_empty((n * F12_PLANES * NL,))
    err = build.library().charon_f12_fold(
        out.data_ptr(), f.data_ptr(), 0 if drop is None else drop.data_ptr(),
        scratch.data_ptr(), n, _stream(f))
    _raise_on("f12_fold", err)
    launch_count.bump(LAUNCHES, "f12_fold")
    return out


def g1_scalar_mul_plain(t1: torch.Tensor, t2: torch.Tensor, t3: torch.Tensor,
                        windows: torch.Tensor) -> torch.Tensor:
    """Per-row G1 scalar multiplication: the plain K6 window per 2-bit
    window (MSB first) from ∞."""
    acc = g1_inf(t1.shape[-1], t1.device)
    for i in range(windows.shape[0]):
        acc = g1_dblsel_plain(acc, t1, t2, t3, windows[i])
    return acc


def g1_scalar_mul_steps(t1: torch.Tensor, t2: torch.Tensor,
                        t3: torch.Tensor, windows: torch.Tensor
                        ) -> torch.Tensor:
    """The same windows through the K6 wrapper (one launch each on the
    card): what K15 replaced, kept for the smoke run's comparison."""
    acc = g1_inf(t1.shape[-1], t1.device)
    for i in range(windows.shape[0]):
        acc = g1_dblsel(acc, t1, t2, t3, windows[i])
    return acc


def g1_scalar_mul_rows(t1: torch.Tensor, t2: torch.Tensor, t3: torch.Tensor,
                       windows: torch.Tensor,
                       lanes: int = miller_program.G1_LANES,
                       slots: int = miller_program.G1_SLOTS,
                       window: int = miller_program.G1_WINDOW,
                       neg_y: bool = False) -> torch.Tensor:
    """K15: per-row G1 scalar multiplication in ONE launch, `lanes`
    threads a row running ops/miller_program.py's `g1_program` with
    `slots` Fp elements of shared memory a row; `g1_scalar_mul_plain` on
    the CPU, bit for bit.  t1/t2/t3 [3, 32, R] are the tables {P, 2P, 3P},
    windows [nwin, R] int32 in 0..3, MSB first → [3, 32, R] projective
    r·P rows; with `neg_y` the Miller p-side (x, −y, z) of those rows, y
    negated inside the program (on the CPU `g1_proj_rows` of the plain
    rows)."""
    if t1.device.type == "cpu":
        acc = g1_scalar_mul_plain(t1, t2, t3, windows)
        return g1_proj_rows(acc) if neg_y else acc
    n = t1.shape[-1]
    for t in (t1, t2, t3):
        _check("g1_scalar_mul", t, P_PLANES, n)
    nwin = windows.shape[0] if windows.dim() == 2 else 0
    if windows.dtype != torch.int32 or tuple(windows.shape) != (nwin, n) \
            or nwin == 0 or not windows.is_contiguous():
        raise ValueError(f"g1_scalar_mul: windows must be a contiguous "
                         f"int32 [nwin, {n}] array")
    _same_device("g1_scalar_mul", t1, t2, t3, windows)
    _cuda_ready("g1_scalar_mul", t1)
    code, fout, steps = miller_program.on_device(
        miller_program.g1_program(nwin, lanes, slots, window, neg_y),
        t1.device)
    consts = _rows_of(_G1_CONST_PLANES, n, t1.device)
    inp = torch.cat([t1, t2, t3, consts]).permute(2, 0, 1).contiguous()
    out = t1.new_empty((P_PLANES, NL, n))
    err = build.library().charon_g1_scalar_mul(
        out.data_ptr(), inp.data_ptr(), code.data_ptr(), steps,
        fout.data_ptr(), windows.data_ptr(), lanes, slots, n, _stream(t1))
    _raise_on("g1_scalar_mul", err)
    launch_count.bump(LAUNCHES, "g1_scalar_mul")
    return out


def g1_tables_plain(base: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K20's program on CPU (or any) tensors: [3, 32, R] → (2P, 3P)."""
    out = miller_program.g1_tables_run_plain(
        miller_program.g1_tables_program(), base)
    return out[:P_PLANES], out[P_PLANES:]


def g1_tables(base: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K20: the RLC tables (2P, 3P) of [3, 32, R] projective G1 rows in
    ONE launch, `G1_LANES` threads a row; `g1_tables_plain` on the CPU,
    bit for bit."""
    if base.device.type == "cpu":
        return g1_tables_plain(base)
    n = base.shape[-1]
    _check("g1_tables", base, P_PLANES, n)
    _cuda_ready("g1_tables", base)
    prog = miller_program.g1_tables_program()
    code, fout, steps = miller_program.on_device(prog, base.device)
    inp = base.permute(2, 0, 1).contiguous()
    out = base.new_empty((2 * P_PLANES, NL, n))
    err = build.library().charon_g1_tables(
        out.data_ptr(), inp.data_ptr(), code.data_ptr(), steps,
        fout.data_ptr(), prog.lanes, prog.slots, n, _stream(base))
    _raise_on("g1_tables", err)
    launch_count.bump(LAUNCHES, "g1_tables")
    return out[:P_PLANES], out[P_PLANES:]
