"""Kernels K2, K3 and K22 — whole G2 group-law steps on the card
(csrc/g2.cu, csrc/g2_law.cu).

The counterpart of the JAX package's ops/pallas_g2.py:

- K2 `g2_step<DBL|ADD>` replaces `_dbl_kernel` / `_add_kernel`: one
  complete Renes–Costello–Batina (a = 0) doubling or addition per row.
- K3 `straus_step<HEAD>` replaces `_dbl3sel_s_kernel` (HEAD: acc ← 8·acc
  ± table[|d|]) and `_addsel_s_kernel` (acc ← acc ± table[|d|]); a zero
  digit keeps the accumulator.
- K16 `straus_msm` (csrc/straus.cu) replaces the launch sequence of
  `straus_combine` (:797): the whole window loop — 87 heads and 87·(T −
  1) tails, 609 K3 launches a 7-share combine — in ONE launch, a group
  of `ST_LANES` threads per validator row running ops/miller_program.py's
  HEAD and TAIL programs on the row's accumulator in shared memory.
  The combine calls it; K3 remains for the smoke run's
  kernel phase and as the steps K16 is held to (`straus_steps`).
- K10 `g2_sel<DBL>` replaces `_dblsel_kernel` (DBL: acc ← 4·acc +
  table[w]) and `_addsel_kernel` (acc ← acc + table[w]) with an UNSIGNED
  window w ∈ {0, 1, 2, 3} over the table {Q, 2Q, 3Q}; w = 0 keeps the
  (quadrupled) accumulator.  dblsel runs the hash-to-G2 cofactor
  clearing's [|x|]-multiplies (ops/cuda_h2c.py); addsel has no caller in
  the JAX package and is ported for parity.
- K22 `g2_law` (csrc/g2_law.cu) replaces K2's launch sequences: the
  combine's tables 2P, 3P, 4P (3 launches) and hash-to-G2's group law
  around the clearing (7 launches and 6 K1 negations a batch) with its
  ψ maps (2 K9 launches), each one straight-line program of
  ops/miller_program.py (`LAWS`) in ONE launch.  K2 and K9 ψ remain for
  the smoke run's kernel phase and as the sequences K22 is held to
  (`straus_tables_steps`, `cuda_h2c.law_steps`).

One thread per point row holds the whole step: every intermediate stays
in the thread's registers and local memory, and device memory sees only
the operand points and the result — the same "inputs + outputs" traffic
the Pallas kernels get from VMEM.  The field arithmetic is the JAX
package's column arithmetic (12-bit limbs, lazy Karatsuba Fp2 products
with the _OFF1/_OFF2 spread offsets), so each kernel is BIT-IDENTICAL to
its plain version here: the port of the DIRECT bodies (`pallas_g2.
_DIRECT_FNS`), which the CPU tests compare with JAX and the chip smoke
compares with the kernel.

LAYOUT.  A point batch is ``[6, 32, R]`` int32: planes (X0, X1, Y0, Y1,
Z0, Z1) × limbs × rows — the port's `[3, 2, 32, R]` point reshaped, with
no copy.  Neighbouring threads read neighbouring rows.  Straus digits are
``[nwin, R]`` int32, iteration-major, rows t-major (row = t·Vpad + v) as
in the JAX backend; K3 reads its table slices and digit row through a row
offset and the tables' row stride, so the window loop makes no copies.

Every wrapper routes a CPU tensor to the plain version and launches the
kernel for a CUDA tensor (or raises).  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tbls.ref.fields import P
from . import build, fp, launch_count, miller_program

NL = fp.NLIMBS
MASK = fp.MASK


# ---------------------------------------------------------------------------
# Host-side constants (copies of pallas_g2's tables)
# ---------------------------------------------------------------------------

def _spread_multiple(width: int, min_digit: int) -> np.ndarray:
    """A multiple of p as `width + 1` nonnegative digits with every digit
    below `width` at least `min_digit` (fp.SPREAD48P, generalised)."""
    k = ((min_digit * 4) << (12 * (width - 1))) // P + 2
    digits = [int(d) for d in fp.to_limbs(k * P, width + 1)]
    for i in range(width):
        while digits[i] < min_digit:
            digits[i] += 1 << 12
            digits[i + 1] -= 1
    assert all(d >= 0 for d in digits)
    assert sum(d << (12 * i) for i, d in enumerate(digits)) == k * P
    return np.asarray(digits, np.int64)


# Offsets for the lazy Karatsuba combines: columns after two carry rounds
# are < 2^13, and c1 subtracts two such vectors.
OFF1 = _spread_multiple(65, 1 << 13)      # 66 digits
OFF2 = _spread_multiple(65, 1 << 14)      # 66 digits

# Worst fold width is 68 (66 lazy-combine columns widened by two carry
# rounds) → 36 high columns.
FC_ROWS = 36
_FC_NP = fp.FOLDC[:FC_ROWS].astype(np.int32)          # [36, 32]
_OFF1_32 = OFF1.astype(np.int32)
_OFF2_32 = OFF2.astype(np.int32)
_SPREAD = fp.SPREAD48P                                 # 33 digits


def fold_consts() -> np.ndarray:
    """The fold-constant table [36, 32] (the JAX `fold_consts()` without
    its lane broadcast; the kernels hold it in __constant__ memory)."""
    return _FC_NP.copy()


# ---------------------------------------------------------------------------
# Plain field library (the DIRECT bodies of pallas_g2).  An Fp element is
# a [W, R] int32 tensor (limb axis first); an Fp2 element a (c0, c1) tuple.
# ---------------------------------------------------------------------------

def _col(arr: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """A per-limb constant column shaped to broadcast against x [W, ...]."""
    t = fp.const(arr, x.device)
    return t.view(t.shape[0], *([1] * (x.dim() - 1)))


def _table_f2(table: np.ndarray, idx: int, like: torch.Tensor):
    """Fp2 constant `idx` of a [2n, 32] table (rows 2·idx, 2·idx + 1)
    broadcast to the rows of `like` [32, R]."""
    t = fp.const(table, like.device)
    return (t[2 * idx].unsqueeze(-1).expand_as(like),
            t[2 * idx + 1].unsqueeze(-1).expand_as(like))


def _zrow(x: torch.Tensor, n: int = 1) -> torch.Tensor:
    return x.new_zeros((n,) + tuple(x.shape[1:]))


def _pc(x: torch.Tensor, rounds: int) -> torch.Tensor:
    """Partial carries; widens by one limb per round."""
    for _ in range(rounds):
        z = _zrow(x)
        x = (torch.cat([x & MASK, z]) + torch.cat([z, x >> fp.LIMB_BITS]))
    return x


def _fold(x: torch.Tensor) -> torch.Tensor:
    """[W ≥ 32, ...] → [32, ...], value preserved mod p."""
    h = x.shape[0] - NL
    assert h <= FC_ROWS
    if not h:
        return x
    fc = fp.const(_FC_NP, x.device)[:h]
    fc = fc.view(h, NL, *([1] * (x.dim() - 1)))
    return x[:NL] + torch.sum(x[NL:].unsqueeze(1) * fc, dim=0,
                              dtype=torch.int32)


def _reduce(x: torch.Tensor, iters: int) -> torch.Tensor:
    x = _fold(_pc(x, 2))
    for _ in range(iters):
        x = _fold(_pc(x, 2))
    return x


def _addf(a, b):
    return _reduce(a + b, 1)


def _add_off(cols: torch.Tensor, off: np.ndarray) -> torch.Tensor:
    """Add a spread multiple of p column-wise (one extra top column)."""
    w = cols.shape[0]
    full = _col(off, cols)
    return torch.cat([cols + full[:w], full[w:w + 1].expand_as(cols[:1])])


def _subf(a, b):
    d = torch.cat([a - b, _zrow(a)])
    return _reduce(d + _col(_SPREAD, d), 1)


def _negf(a):
    d = torch.cat([a, _zrow(a)])
    return _reduce(_col(_SPREAD, d) - d, 1)


def _msmall(a, k: int):
    assert 1 <= k <= 16
    return _reduce(a * k, 2)


_conv = fp._conv  # 63 raw convolution columns of two [32, R] elements


def _mulf(a, b):
    return _reduce(_conv(a, b), 5)


def _f2add(a, b):
    return (_addf(a[0], b[0]), _addf(a[1], b[1]))


def _f2sub(a, b):
    return (_subf(a[0], b[0]), _subf(a[1], b[1]))


def _f2small(a, k: int):
    return (_msmall(a[0], k), _msmall(a[1], k))


def _f2mul(a, b):
    """Lazy Karatsuba: combine the three sub-products at column level,
    then ONE fold-reduction per output coefficient."""
    t0 = _pc(_conv(a[0], b[0]), 2)                       # 65 cols < 2^13
    t1 = _pc(_conv(a[1], b[1]), 2)
    t2 = _pc(_conv(_addf(a[0], a[1]), _addf(b[0], b[1])), 2)
    c0 = _add_off(t0 - t1, _OFF1_32)                     # 66 cols
    c1 = _add_off(t2 - t0 - t1, _OFF2_32)
    return (_reduce(c0, 6), _reduce(c1, 6))


def _f2sqr(a):
    """(a0+a1)(a0−a1) + 2a0a1·u."""
    c0 = _mulf(_addf(a[0], a[1]), _subf(a[0], a[1]))
    t = _pc(_conv(a[0], a[1]), 2)
    return (c0, _reduce(t * 2, 5))


def _f2_mul_b3(a):
    """×3b = ×12(1+u)."""
    return (_msmall(_subf(a[0], a[1]), 12), _msmall(_addf(a[0], a[1]), 12))


def _pt_unstack(p):
    return ((p[0], p[1]), (p[2], p[3]), (p[4], p[5]))


def _pt_stack(x, y, z):
    return torch.stack([x[0], x[1], y[0], y[1], z[0], z[1]])


def _g2_double(p):
    x, y, z = _pt_unstack(p)
    yy = _f2sqr(y)
    yz = _f2mul(y, z)
    zz = _f2sqr(z)
    xy = _f2mul(x, y)
    bzz = _f2_mul_b3(zz)
    e8 = _f2small(yy, 8)
    s = _f2add(yy, bzz)
    d = _f2sub(yy, _f2small(bzz, 3))
    x3 = _f2small(_f2mul(d, xy), 2)
    y3 = _f2add(_f2mul(bzz, e8), _f2mul(d, s))
    z3 = _f2mul(yz, e8)
    return _pt_stack(x3, y3, z3)


def _g2_add(p1, p2):
    x1, y1, z1 = _pt_unstack(p1)
    x2, y2, z2 = _pt_unstack(p2)
    t0 = _f2mul(x1, x2)
    t1 = _f2mul(y1, y2)
    t2 = _f2mul(z1, z2)
    pxy = _f2mul(_f2add(x1, y1), _f2add(x2, y2))
    pyz = _f2mul(_f2add(y1, z1), _f2add(y2, z2))
    pxz = _f2mul(_f2add(x1, z1), _f2add(x2, z2))
    t3 = _f2sub(pxy, _f2add(t0, t1))         # X1Y2 + X2Y1
    t4 = _f2sub(pyz, _f2add(t1, t2))         # Y1Z2 + Y2Z1
    t5 = _f2sub(pxz, _f2add(t0, t2))         # X1Z2 + X2Z1
    m = _f2small(t0, 3)                      # 3·X1X2
    bz = _f2_mul_b3(t2)                      # 3b·Z1Z2
    s = _f2add(t1, bz)
    d = _f2sub(t1, bz)
    by = _f2_mul_b3(t5)
    x3 = _f2sub(_f2mul(t3, d), _f2mul(t4, by))
    y3 = _f2add(_f2mul(d, s), _f2mul(m, by))
    z3 = _f2add(_f2mul(t4, s), _f2mul(t3, m))
    return _pt_stack(x3, y3, z3)


def _signed_sel(w, t1, t2, t3, t4):
    """table[|w|] (|w| = 0 or 4 → t4), Y negated where w < 0."""
    wa = torch.abs(w)
    pt = torch.where(wa == 1, t1,
                     torch.where(wa == 2, t2, torch.where(wa == 3, t3, t4)))
    neg = w < 0
    return torch.stack([pt[0], pt[1],
                        torch.where(neg, _negf(pt[2]), pt[2]),
                        torch.where(neg, _negf(pt[3]), pt[3]),
                        pt[4], pt[5]])


def dbl_plain(p: torch.Tensor) -> torch.Tensor:
    return _g2_double(p)


def add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _g2_add(a, b)


def straus_step_plain(acc, tables, row0: int, digits: torch.Tensor,
                      head: bool) -> torch.Tensor:
    """acc ← (8·acc if head else acc) ± table[|d|] over rows
    [row0, row0 + n) of the tables and digit row; d = 0 keeps."""
    n = acc.shape[-1]
    t1, t2, t3, t4 = (t[..., row0:row0 + n] for t in tables)
    w = digits[row0:row0 + n]
    if head:
        acc = _g2_double(_g2_double(_g2_double(acc)))
    added = _g2_add(acc, _signed_sel(w, t1, t2, t3, t4))
    return torch.where(w == 0, acc, added)


def _unsigned_sel(w, t1, t2, t3):
    """table[w] for w ∈ {1, 2, 3} (pallas_g2._sel: anything else → t3)."""
    return torch.where(w == 1, t1, torch.where(w == 2, t2, t3))


def dblsel_plain(acc, t1, t2, t3, w: torch.Tensor) -> torch.Tensor:
    """acc ← 4·acc + table[w]; w = 0 keeps 4·acc (pallas_g2._dblsel_body)."""
    acc4 = _g2_double(_g2_double(acc))
    added = _g2_add(acc4, _unsigned_sel(w, t1, t2, t3))
    return torch.where(w == 0, acc4, added)


def addsel_plain(acc, t1, t2, t3, w: torch.Tensor) -> torch.Tensor:
    """acc ← acc + table[w]; w = 0 keeps acc (pallas_g2._addsel_body)."""
    added = _g2_add(acc, _unsigned_sel(w, t1, t2, t3))
    return torch.where(w == 0, acc, added)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

#: kernel launches since the last `reset_launches()` (all threads;
#: `launch_count.this_thread()` has the calling thread's own)
LAUNCHES = {"g2_dbl": 0, "g2_add": 0, "straus_head": 0, "straus_tail": 0,
            "g2_dblsel": 0, "g2_addsel": 0, "straus_msm": 0, "g2_law": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_pts(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: int32 planes expected, got {t.dtype}")
        if t.dim() != 3 or t.shape[:2] != (6, NL) or t.shape[2] == 0:
            raise ValueError(f"{name}: expected [6, 32, R], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: operands on different devices")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name}: {t.numel()} limbs exceed the int index")


def _cuda_ready(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensor on {t.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")


def _g2_step(name: str, kind: int, a: torch.Tensor,
             b: torch.Tensor | None) -> torch.Tensor:
    ops = (a,) if b is None else (a, b)
    _check_pts(name, *ops)
    if b is not None and b.shape != a.shape:
        raise ValueError(f"{name}: operand shapes differ")
    _cuda_ready(name, a)
    out = torch.empty_like(a)
    err = build.library().charon_g2_step(
        kind, out.data_ptr(), a.data_ptr(),
        0 if b is None else b.data_ptr(), a.shape[2],
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(name, err)
    launch_count.bump(LAUNCHES, name)
    return out


def dbl(p: torch.Tensor) -> torch.Tensor:
    """[6, 32, R] G2 points → doubled points."""
    if p.device.type == "cpu":
        return dbl_plain(p)
    return _g2_step("g2_dbl", 0, p, None)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return add_plain(a, b)
    return _g2_step("g2_add", 1, a, b)


def straus_step(acc: torch.Tensor, tables, row0: int, digits: torch.Tensor,
                head: bool) -> torch.Tensor:
    """One Straus window step over n = acc rows: tables are four
    [6, 32, RT] point batches (P, 2P, 3P, 4P), read at rows
    [row0, row0 + n); digits is one [RT] int32 digit row."""
    if acc.device.type == "cpu":
        return straus_step_plain(acc, tables, row0, digits, head)
    name = "straus_head" if head else "straus_tail"
    _check_pts(name, acc, *tables)
    n, rt = acc.shape[2], tables[0].shape[2]
    if any(t.shape != tables[0].shape for t in tables):
        raise ValueError(f"{name}: table shapes differ")
    if not 0 <= row0 <= rt - n:
        raise ValueError(f"{name}: rows [{row0}, {row0 + n}) outside {rt}")
    if (digits.dtype != torch.int32 or digits.shape != (rt,)
            or not digits.is_contiguous() or digits.device != acc.device):
        raise ValueError(f"{name}: digits must be a contiguous int32 [{rt}] "
                         f"row on {acc.device}")
    _cuda_ready(name, acc)
    out = torch.empty_like(acc)
    off = 4 * row0                      # byte offset of row0 in every plane
    err = build.library().charon_straus_step(
        int(head), out.data_ptr(), acc.data_ptr(),
        *[t.data_ptr() + off for t in tables], rt,
        digits.data_ptr() + off, n,
        torch.cuda.current_stream(acc.device).cuda_stream)
    _raise_on(name, err)
    launch_count.bump(LAUNCHES, name)
    return out


def _g2_sel(name: str, dbl: bool, acc, t1, t2, t3,
            w: torch.Tensor) -> torch.Tensor:
    _check_pts(name, acc, t1, t2, t3)
    n = acc.shape[2]
    if any(t.shape != acc.shape for t in (t1, t2, t3)):
        raise ValueError(f"{name}: operand shapes differ")
    if (w.dtype != torch.int32 or tuple(w.shape) != (n,)
            or not w.is_contiguous() or w.device != acc.device):
        raise ValueError(f"{name}: w must be a contiguous int32 [{n}] row "
                         f"on {acc.device}")
    _cuda_ready(name, acc)
    out = torch.empty_like(acc)
    err = build.library().charon_g2_sel(
        int(dbl), out.data_ptr(), acc.data_ptr(), t1.data_ptr(),
        t2.data_ptr(), t3.data_ptr(), w.data_ptr(), n,
        torch.cuda.current_stream(acc.device).cuda_stream)
    _raise_on(name, err)
    launch_count.bump(LAUNCHES, name)
    return out


def dblsel(acc: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor,
           t3: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One 2-bit window of a per-row G2 scalar multiplication: [6, 32, R]
    accumulators and tables {Q, 2Q, 3Q}, w [R] int32 in 0..3."""
    if acc.device.type == "cpu":
        return dblsel_plain(acc, t1, t2, t3, w)
    return _g2_sel("g2_dblsel", True, acc, t1, t2, t3, w)


def addsel(acc: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor,
           t3: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """acc + table[w] per row (w = 0 keeps acc); shapes as `dblsel`."""
    if acc.device.type == "cpu":
        return addsel_plain(acc, t1, t2, t3, w)
    return _g2_sel("g2_addsel", False, acc, t1, t2, t3, w)


# ---------------------------------------------------------------------------
# Layout helpers + the Straus MSM
# ---------------------------------------------------------------------------

_INF_PLANES = np.zeros((6, NL), np.int32)
_INF_PLANES[2] = fp.ONE  # (0 : 1 : 0)


def as_planes(pt: torch.Tensor) -> torch.Tensor:
    """[3, 2, 32, R] point batch → the kernels' [6, 32, R] view."""
    return pt.reshape(6, NL, pt.shape[-1])


def as_points(planes: torch.Tensor) -> torch.Tensor:
    """[6, 32, R] planes → [3, 2, 32, R] point batch (a view)."""
    return planes.reshape(3, 2, NL, planes.shape[-1])


def inf_planes(n: int, device) -> torch.Tensor:
    """n points at infinity as [6, 32, n] planes."""
    return fp.const(_INF_PLANES, device).unsqueeze(-1).expand(
        6, NL, n).contiguous()


def signed_digit_rows(bits: np.ndarray) -> np.ndarray:
    """Host: [R, nbits] scalar bit planes (MSB first) → [R, nwin] balanced
    base-8 digits in [−4, 3], MSB-first per row; value-exact
    (Σᵢ d_{nwin−1−i}·8^i == the scalar).  The balanced recode's carry
    chain resolves by carry lookahead: digit i GENERATES a carry iff
    u_i ≥ 4 and PROPAGATES iff u_i == 3."""
    r, nbits = bits.shape
    pad = (-nbits) % 3
    b = np.concatenate([np.zeros((r, pad), bits.dtype), bits], axis=1)
    nd = b.shape[1] // 3
    u = (b[:, ::-1][:, 0::3] * 1 + b[:, ::-1][:, 1::3] * 2
         + b[:, ::-1][:, 2::3] * 4)                     # [R, nd] LSB-first
    gen = u >= 4
    pos = np.arange(nd, dtype=np.int64)
    anchor = np.maximum.accumulate(np.where(u == 3, -1, pos), axis=1)
    gen_pad = np.concatenate([np.zeros((r, 1), bool), gen], axis=1)
    anchor_prev = np.concatenate(
        [np.full((r, 1), -1, np.int64), anchor[:, :-1]], axis=1)
    c_in = np.take_along_axis(gen_pad, anchor_prev + 1, axis=1)
    v = u + c_in.astype(np.int32)
    d = np.zeros((r, nd + 1), np.int32)
    d[:, :nd] = np.where(v >= 4, v - 8, v)
    d[:, nd] = np.take_along_axis(gen_pad, anchor[:, -1:] + 1,
                                  axis=1)[:, 0]
    return np.ascontiguousarray(d[:, ::-1])             # MSB-first


def straus_combine(pts: torch.Tensor, digits: torch.Tensor,
                   t_count: int) -> torch.Tensor:
    """Joint-T Straus MSM over a t-major batch:

    pts    [6, 32, R]  rows t-major (row = t·Vpad + v),
    digits [nwin, R]   balanced base-8 digits, iteration-major,
    → [6, 32, Vpad] combined points (Vpad = R / t_count).

    acc ← 8·acc + Σ_t d_{t,i}·P_t per window i — one head step (t = 0)
    and T − 1 tail steps per window, all in one K16 launch — on tables
    {P, 2P, 3P, 4P} built once by K22 over all rows."""
    return straus_msm(straus_tables(pts), digits, t_count)


def straus_tables(pts: torch.Tensor) -> tuple:
    """The window tables (P, 2P, 3P, 4P) over all rows: 2P, 3P and 4P in
    one K22 launch (`g2_law("tables")`), views of its [18, 32, R]
    output."""
    out = g2_law("tables", pts)
    return (pts, out[0:6], out[6:12], out[12:18])


def straus_tables_steps(pts: torch.Tensor) -> tuple:
    """The same tables by the 3 K2 launches K22 replaced, kept for the
    smoke run's comparison."""
    p2 = dbl(pts)
    return (pts, p2, add(p2, pts), dbl(p2))


def _straus_iterate(step, tables, digits, t_count):
    r = tables[0].shape[-1]
    assert r % t_count == 0
    sv = r // t_count
    acc = inf_planes(sv, tables[0].device)
    for i in range(digits.shape[0]):
        row = digits[i]
        acc = step(acc, tables, 0, row, True)
        for k in range(1, t_count):
            acc = step(acc, tables, k * sv, row, False)
    return acc


def straus_msm_plain(tables: tuple, digits: torch.Tensor,
                     t_count: int) -> torch.Tensor:
    """The window loop as iterated plain steps (`straus_step_plain`): one
    head (share 0) and T − 1 tails a window."""
    return _straus_iterate(straus_step_plain, tables, digits, t_count)


def straus_steps(tables: tuple, digits: torch.Tensor,
                 t_count: int) -> torch.Tensor:
    """The same loop through the K3 wrapper (87·T launches on the card):
    what K16 replaced, kept for the smoke run's comparison."""
    return _straus_iterate(straus_step, tables, digits, t_count)


def straus_block(tables: tuple) -> torch.Tensor:
    """The four [6, 32, T·n] tables as K16's input blocks [T·n, 24, 32]:
    row k·n + r holds share k's P, 2P, 3P, 4P of row r (one copy a
    table)."""
    rt = tables[0].shape[-1]
    blk = tables[0].new_empty((rt, miller_program.ST_PLANES, NL))
    for j, t in enumerate(tables):
        blk[:, 6 * j:6 * j + 6] = t.permute(2, 0, 1)
    return blk


def straus_msm(tables: tuple, digits: torch.Tensor, t_count: int,
               lanes: int = miller_program.ST_LANES,
               slots: int = miller_program.ST_SLOTS,
               window: int = miller_program.ST_WINDOW) -> torch.Tensor:
    """K16: the whole joint-T Straus loop in one launch.  tables: four
    [6, 32, T·n] point batches (P, 2P, 3P, 4P; rows t-major), digits
    [nwin, T·n] int32 balanced base-8 digits in [−4, 3] → [6, 32, n]
    Σ_k Σ_i d_{k,i}·8^(nwin−1−i)·P_k per row, bit for bit
    `straus_msm_plain` (its CPU route).  `lanes` threads a row run
    ops/miller_program.py's HEAD and TAIL programs with `slots` Fp
    elements of shared memory a row (and look-ahead `window`)."""
    if tables[0].device.type == "cpu":
        return straus_msm_plain(tables, digits, t_count)
    name = "straus_msm"
    _check_pts(name, *tables)
    rt = tables[0].shape[2]
    if any(t.shape != tables[0].shape for t in tables):
        raise ValueError(f"{name}: table shapes differ")
    if t_count <= 0 or rt % t_count:
        raise ValueError(f"{name}: {rt} table rows are not {t_count} shares")
    nwin = digits.shape[0] if digits.dim() == 2 else 0
    if (digits.dtype != torch.int32 or tuple(digits.shape) != (nwin, rt)
            or nwin == 0 or not digits.is_contiguous()
            or digits.device != tables[0].device):
        raise ValueError(f"{name}: digits must be a contiguous int32 "
                         f"[nwin, {rt}] array on {tables[0].device}")
    _cuda_ready(name, tables[0])
    n = rt // t_count
    (hcode, hout, hsteps), (tcode, tout, tsteps) = (
        miller_program.on_device(prog, tables[0].device)
        for prog in miller_program.straus_programs(lanes, slots, window))
    blk = straus_block(tables)
    # share k's TAIL of window i runs unless its digits are 0 on every row
    live = (digits.view(nwin, t_count, n) != 0).any(dim=2).to(torch.int32)
    out = tables[0].new_empty((6, NL, n))
    err = build.library().charon_straus_msm(
        out.data_ptr(), blk.data_ptr(), digits.data_ptr(), live.data_ptr(),
        hcode.data_ptr(), hsteps, hout.data_ptr(), tcode.data_ptr(), tsteps,
        tout.data_ptr(), nwin, t_count, n, lanes, slots,
        torch.cuda.current_stream(out.device).cuda_stream)
    _raise_on(name, err)
    launch_count.bump(LAUNCHES, name)
    return out


# ---------------------------------------------------------------------------
# K22: K2's launch sequences as one launch each
# ---------------------------------------------------------------------------

#: the kind codes of csrc/g2_law.cu's charon_g2_law
_LAW_KIND = {"tables": 0, "pre": 1, "post": 2}


def g2_law(kind: str, block: torch.Tensor, cfg=None) -> torch.Tensor:
    """K22: program `kind` of ops/miller_program.py (`LAWS`: "tables" 2P,
    3P, 4P of P; "pre" R = M₀ + M₁, 2R, ψ(R) and ψ²(2R); "post" the
    clearing's five additions) on the input points' planes [in planes,
    32, R] → the output points' planes [out planes, 32, R], in ONE
    launch, under `cfg` = (lanes, slots, look-ahead) (None:
    `miller_program.LW_CONFIG`'s).  The program's constant planes (ψ's,
    for "pre") join each row's input block here.  Bit for bit the launch
    sequence it replaced; on the CPU the plain program
    (`law_run_plain`)."""
    _, in_planes, out_planes = miller_program.LAWS[kind]
    n = block.shape[-1]
    if tuple(block.shape) != (in_planes, NL, n) or n == 0 \
            or block.dtype != torch.int32:
        raise ValueError(f"g2_law {kind}: expected int32 [{in_planes}, 32, "
                         f"R], got {block.dtype} {tuple(block.shape)}")
    prog = miller_program.law_program(kind, cfg)
    if block.device.type == "cpu":
        return miller_program.law_run_plain(prog, block)
    _cuda_ready("g2_law", block)
    if max(in_planes, out_planes) * NL * n >= 2 ** 31:
        raise ValueError(f"g2_law: {n} rows exceed the int index")
    code, fout, steps = miller_program.on_device(prog, block.device)
    consts = miller_program.const_rows(prog, n, block.device)
    if consts:
        block = torch.cat([block, torch.stack(consts)])
    inp = block.permute(2, 0, 1).contiguous()
    out = block.new_empty((out_planes, NL, n))
    err = build.library().charon_g2_law(
        _LAW_KIND[kind], out.data_ptr(), inp.data_ptr(), code.data_ptr(),
        steps, fout.data_ptr(), prog.lanes, prog.slots, n,
        torch.cuda.current_stream(block.device).cuda_stream)
    _raise_on("g2_law", err)
    launch_count.bump(LAUNCHES, "g2_law")
    return out
