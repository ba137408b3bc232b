"""The batched Miller loop and the RLC scalar multiplication as scheduled
programs of field ops — the data that kernels K13 (csrc/miller.cu) and
K15 (csrc/g1_scalar_mul.cu) run through the interpreter of
csrc/program.cuh.

K13 spreads one pair row over a group of `LANES` threads.  What each
thread does at each step is fixed before the launch: this module writes
the whole Miller loop f_{|z|,Q}(P) as a dataflow graph of the field ops
the K4/K5 step kernels run one after another (Fp2 products and squares,
Fp products, sums, differences and small multiples, each the same
csrc/fp381.cuh function on the same inputs), and schedules it:

- a STEP is up to `LANES` independent ops of ONE kind (lane i runs op
  i), so the threads of a group — and the groups of a warp, which all
  run the same program — take one instruction stream, and a
  `__syncwarp()` follows every step;
- every intermediate lives in a SLOT of the row's shared memory (one Fp
  element, 32 int32 limbs; an Fp2 takes two neighbouring slots); a slot
  is freed when the last op that reads it has run, and reused from the
  next step on, so no op reads a slot another op of its step writes;
- P, Q and the constants one and zero stay in device memory (`GLOBAL`
  codes), read where an op needs them.

The scheduler is a list scheduler over the unrolled loop (all 63
iterations, `schedule`): each step takes the kind whose ready ops leave
the fewest lane-instructions idle, then up to `LANES` of them, oldest
first, as far as free slots allow, looking at most `WINDOW` ops ahead of
the sequential order.  Because the doubling chain of T does not depend
on f, the next iteration's doubling overlaps this iteration's line
multiplication.

Every op is an op of the sequential step sequence on the same inputs, so
the program computes exactly the bits of `cuda_pairing.miller_loop_plain`
(the plain K4/K5 bodies in order): `run_plain` executes the encoded
program on CPU tensors with the plain field functions, and the CPU tests
hold it to that bit for bit.

K15's program (`g1_program`) is the same machinery on a G1 graph: 32
windows of acc ← 4·acc + T[w] (`cuda_pairing.g1_dblsel_plain`), whose
values are single Fp elements (one slot each, `Dag.fp_vals`).  Its one
extra op kind, SEL, copies per row one of its operands, chosen by the
row's digit of a window: the table point T[w] (T[0] stands in as P, so
every row runs the same addition), then acc4 where w = 0 and the sum
elsewhere.  `g1_run_plain` on the result equals the iterated plain
windows bit for bit.

The G2 window loops are the same machinery on the complete G2 law
(`Dag.g2_double` / `g2_add`, op for op `cuda_g2._g2_double` /
`_g2_add`):

- K16 (csrc/straus.cu, the combine's Straus MSM) runs two small
  programs in a loop on the device, the accumulator resident in slots
  0–5 (`Program.preset`): HEAD (`straus_head_dag`, acc ← 8·acc) once a
  window, TAIL (`straus_tail_dag`, acc ← acc ± T[|d|], d = 0 keeping
  acc) once a share, its input block share k's four table points.  A
  program cannot address the 609 (window, share) digits or a 7-share
  row's 168 table planes, so the kernel points the input block and the
  digit at share k before each TAIL run; TAIL's SELs read three fields
  of the one digit d (`ST_ABS`, `ST_NEG`, `ST_NZ`).  `straus_run_plain`
  loops the two programs as the kernel does.
- K17 (csrc/g2_zmul.cu, hash-to-G2's [|x|]-multiply) is one straight-
  line program (`zmul_dag`): the windows of |x| are host constants, so
  it needs no SEL.

K18 (csrc/f2_chain.cu) runs hash-to-G2's fixed-exponent chains as
straight-line programs (`chain_program`: `sqrt_dag`, `inv_dag`,
`affine_dag`): each pow is its constant windows, and each Fp2 square or
product is split into Fp ops (`_F2Split`) so that the lanes of a row
share it.  K20 (csrc/g1_tables.cu) is one G1 doubling and one addition
(`g1_tables_dag`).  K22 (csrc/g2_law.cu) runs K2's launch sequences as
straight-line programs on the G2 law (`law_program`): the combine's
Straus tables, hash-to-G2's halves' sum with its double, ψ of the sum
and ψ² of the double (`g2_psi`: each conjugation a copy of c0 — LIN's
copy form, iters 0 — and c1's negation, then two MUL2 by the constants,
which the program reads as input planes, `Program.consts`), and the
clearing's five additions.  K23 (csrc/h2c_map.cu) runs the 3-isogeny
(`iso3_dag`): the four Horner evaluations of K9 ISO3 side by side, on
the affine (x, y) that the kernel's prologue pins in slots, the
isogeny's coefficients one block of input planes that every row reads.
K24 (csrc/h2c_sswu.cu) runs SSWU (`sswu_dag`) the same way on the u that
its prologue pins, its exceptional denominator a SEL whose digit is the
prologue's flag u ≡ 0.

ENCODING (`Program.code`, int32 [steps, LANES, 2]): word 0 is kind |
out << 8 | a << 16 | b << 24, word 1 LIN's form (k | (s + 1) << 8 |
iters << 12 | spread << 16) or SEL's (window | stride << 8).  An operand
code below `GLOBAL` is a shared-memory slot; `GLOBAL + m` is plane m of
the row's input block [in planes, 32] in device memory.  An Fp2 operand
or output names the slot (plane) of its c0; c1 follows it.  SEL writes
a where the row's digit d of its window is 0, else b + stride·(d − 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..tbls.ref.fields import BLS_X, P
from . import fp

# op kinds (csrc/program.cuh's switch): the Fp2 product and square, the Fp
# product, LIN — fp381's add, sub and mul_small as one function,
# spread·48p + k·a + s·b reduced (see `lin_plain`) — and SEL, the
# per-row copy chosen by a window digit (K15, K16)
NOP, MUL2, SQR2, MUL, LIN, SEL = range(6)
KIND_NAMES = ("nop", "f2_mul", "f2_sqr", "mul", "lin", "sel")

#: int32 instructions per op, counted from csrc/fp381.cuh (chip_smoke.py's
#: OPS table; LIN as its costliest form, mul_small; SEL a digit load and a
#: 32-limb copy): the scheduler's cost model
COST = {MUL2: 11_720, SQR2: 9_172, MUL: 3_756, LIN: 809, SEL: 70}

# LIN forms: (k, s, iters, spread); iters = 0 is a plain copy of a (no
# reduction: the same limbs), which ψ's conjugation needs beside the
# negated half
_ADD, _SUB, _NEG = (1, 1, 1, 0), (1, -1, 1, 1), (0, -1, 1, 1)
_COPY = (1, 0, 0, 0)

#: threads per pair row, and the shared-memory slots of a row
LANES = 8
SLOTS = 52
#: how far (in ops of the sequential order) the schedule may run ahead
WINDOW = 40

#: operand codes at or above GLOBAL name a plane of the row's input block
GLOBAL = 192
# the input block's planes: P = (xP, −yP, zP), Q = (x, y) affine, and the
# constants (1, 0) and (0, 0) as Fp2 pairs
IN_PX, IN_PY, IN_PZ, IN_QX, IN_QY, IN_ONE, IN_ZERO = 0, 1, 2, 3, 5, 7, 9
IN_PLANES = 11

# bits of |z| below the leading one, MSB first (cuda_pairing.LOOP_BITS)
LOOP_BITS = tuple(int(b) for b in bin(BLS_X)[3:])

# K15's input block: the tables T1 = P, T2 = 2P, T3 = 3P as (x, y, z)
# planes, then the constants one and zero; a SEL of the table reads
# plane c + G1_STRIDE·(w − 1)
G1_T1, G1_ONE, G1_ZERO, G1_STRIDE = 0, 9, 10, 3
#: K15's threads per row, slots a row and look-ahead (chip_smoke.py's
#: sweep over 2, 4 and 8 lanes chose them)
G1_LANES = 4
G1_SLOTS = 20
G1_WINDOW = 40

# K16's accumulator: Fp2 pairs at slots 0, 2, 4 (x, y, z), resident
# across the window loop.  TAIL's input block is one share's table
# points T1 = P .. T4 = 4P as (x, y, z) Fp2 planes, ST_STRIDE planes
# apart; its SEL windows are fields of the share's digit d: |d| mod 4
# (T4 stands in for 0 and 4, as cuda_g2._signed_sel takes it), d < 0
# and d ≠ 0
ST_ACC = (0, 2, 4)
ST_T1, ST_T4, ST_STRIDE, ST_PLANES = 0, 18, 6, 24
ST_ABS, ST_NEG, ST_NZ = 0, 1, 2
#: K16's threads per row, slots a row and look-ahead
ST_LANES = 4
ST_SLOTS = 34
ST_WINDOW = 40

# K17's input block: Q as (x, y, z) Fp2 planes, then the Fp2 constants
# one (1, 0) and zero (0, 0)
ZM_Q, ZM_ONE, ZM_ZERO, ZM_PLANES = 0, 6, 8, 10
#: the 2-bit windows of |x| (the BLS parameter), MSB first
Z_WINDOWS = tuple((BLS_X >> (62 - 2 * i)) & 3 for i in range(32))
#: K17's threads per row, slots a row and look-ahead
ZM_LANES = 4
ZM_SLOTS = 36
ZM_WINDOW = 80


# ---------------------------------------------------------------------------
# The dataflow graph
# ---------------------------------------------------------------------------

@dataclass
class _Op:
    kind: int
    out: int                  # value id
    half: int | None          # the half written (Fp ops), None: both
    ins: tuple                # (value id, half | None) refs
    lin: tuple = (0, 0, 0, 0)  # LIN's (k, s, iters, spread)
    sel: tuple = (0, 0)       # SEL's (window, stride)


class Dag:
    """Values are Fp2 elements (two halves), Fp elements (one slot:
    `fp_vals`), device-memory inputs or Fp2 inputs resident in slots
    (`pinned`); ops write one half (Fp ops), a whole Fp2 (MUL2, SQR2) or
    an Fp element."""

    def __init__(self):
        self.ops: list[_Op] = []
        self.glob: dict[int, int] = {}      # value id → input plane
        self.pinned: dict[int, int] = {}    # value id → its pair's c0 slot
        self.fp_vals: set[int] = set()
        self.n = 0

    def _new(self) -> int:
        self.n += 1
        return self.n - 1

    def _new_fp(self) -> int:
        v = self._new()
        self.fp_vals.add(v)
        return v

    def input(self, plane: int) -> int:
        v = self._new()
        self.glob[v] = plane
        return v

    def slot_input(self, slot: int) -> int:
        """An Fp2 input the kernel keeps in the pair at `slot` (even): the
        scheduler never gives that pair to another value."""
        assert slot % 2 == 0
        v = self._new()
        self.pinned[v] = slot
        return v

    # Fp2 helpers, each the fp381.cuh function of the same name
    def f2_mul(self, a, b):
        v = self._new()
        self.ops.append(_Op(MUL2, v, None, ((a, None), (b, None))))
        return v

    def f2_sqr(self, a):
        v = self._new()
        self.ops.append(_Op(SQR2, v, None, ((a, None),)))
        return v

    def _lin(self, forms):
        """One Fp2 value, half h = LIN of forms[h] = (ins, form)."""
        v = self._new()
        for h, (ins, form) in enumerate(forms):
            self.ops.append(_Op(LIN, v, h, ins, form))
        return v

    def f2_add(self, a, b):
        return self._lin([(((a, 0), (b, 0)), _ADD), (((a, 1), (b, 1)), _ADD)])

    def f2_sub(self, a, b):
        return self._lin([(((a, 0), (b, 0)), _SUB), (((a, 1), (b, 1)), _SUB)])

    def f2_small(self, a, k):
        form = (k, 0, 2, 0)
        return self._lin([(((a, 0),), form), (((a, 1),), form)])

    def f2_mul_xi(self, a):
        """(a0 − a1) + (a0 + a1)·u"""
        return self._lin([(((a, 0), (a, 1)), _SUB),
                          (((a, 0), (a, 1)), _ADD)])

    def f2_neg(self, a):
        """0 − a per half: LIN with k = 0 gives fp381 neg's columns."""
        form = (0, -1, 1, 1)
        return self._lin([(((a, 0), (a, 0)), form), (((a, 1), (a, 1)),
                                                     form)])

    def f2_conj(self, a):
        """(a0, −a1): half 0 a copy of a0 (LIN's copy form), half 1 fp381
        neg's columns — an Fp2 pair, so a MUL2 can read it."""
        return self._lin([(((a, 0),), _COPY), (((a, 1), (a, 1)), _NEG)])

    def f2_mul_b3(self, a):
        """×3b = ×12·(1 + u): (a0 − a1, a0 + a1), then ×12."""
        return self.f2_small(self.f2_mul_xi(a), 12)

    def f2_sel(self, window, a, b, stride):
        """`sel` on both halves of an Fp2 value."""
        v = self._new()
        for h in (0, 1):
            self.ops.append(_Op(SEL, v, h, ((a, h), (b, h)),
                                sel=(window, stride)))
        return v

    def f2_mul_fp(self, a, s):
        v = self._new()
        self.ops.append(_Op(MUL, v, 0, ((a, 0), (s, 0))))
        self.ops.append(_Op(MUL, v, 1, ((a, 1), (s, 0))))
        return v

    # the tower (cuda_pairing._f6_* / _f12_*)
    def f6_add(self, a, b):
        return tuple(self.f2_add(x, y) for x, y in zip(a, b))

    def f6_sub(self, a, b):
        return tuple(self.f2_sub(x, y) for x, y in zip(a, b))

    def f6_mul_by_v(self, a):
        return (self.f2_mul_xi(a[2]), a[0], a[1])

    def f6_mul(self, a, b):
        v0 = self.f2_mul(a[0], b[0])
        v1 = self.f2_mul(a[1], b[1])
        v2 = self.f2_mul(a[2], b[2])
        t12 = self.f2_sub(self.f2_mul(self.f2_add(a[1], a[2]),
                                      self.f2_add(b[1], b[2])),
                          self.f2_add(v1, v2))
        t01 = self.f2_sub(self.f2_mul(self.f2_add(a[0], a[1]),
                                      self.f2_add(b[0], b[1])),
                          self.f2_add(v0, v1))
        t02 = self.f2_sub(self.f2_mul(self.f2_add(a[0], a[2]),
                                      self.f2_add(b[0], b[2])),
                          self.f2_add(v0, v2))
        return (self.f2_add(v0, self.f2_mul_xi(t12)),
                self.f2_add(t01, self.f2_mul_xi(v2)),
                self.f2_add(t02, v1))

    def f6_mul_by_01(self, a, d0, d1):
        v0 = self.f2_mul(a[0], d0)
        v1 = self.f2_mul(a[1], d1)
        x12 = self.f2_mul(self.f2_add(a[1], a[2]), d1)
        x01 = self.f2_mul(self.f2_add(a[0], a[1]), self.f2_add(d0, d1))
        x02 = self.f2_mul(self.f2_add(a[0], a[2]), d0)
        return (self.f2_add(v0, self.f2_mul_xi(self.f2_sub(x12, v1))),
                self.f2_sub(x01, self.f2_add(v0, v1)),
                self.f2_add(self.f2_sub(x02, v0), v1))

    def f12_sqr(self, f):
        a0, a1 = f
        v0 = self.f6_mul(a0, a1)
        t = self.f6_mul(self.f6_add(a0, a1),
                        self.f6_add(a0, self.f6_mul_by_v(a1)))
        c0 = self.f6_sub(self.f6_sub(t, v0), self.f6_mul_by_v(v0))
        c1 = tuple(self.f2_small(c, 2) for c in v0)
        return c0, c1

    def f12_mul_by_014(self, f, c0, c1, c4):
        a0, a1 = f
        aa = self.f6_mul_by_01(a0, c0, c1)
        t6 = self.f6_mul_by_01(self.f6_add(a0, a1), c0, self.f2_add(c1, c4))
        b0 = self.f2_mul(a1[0], c4)
        b1 = self.f2_mul(a1[1], c4)
        b2 = self.f2_mul(a1[2], c4)
        bb = (self.f2_mul_xi(b2), b0, b1)
        r1 = self.f6_sub(t6, self.f6_add(aa, bb))
        r0 = self.f6_add(self.f6_mul_by_v(bb), aa)
        return r0, r1

    # the Miller steps (cuda_pairing._dbl_step / _add_step / _line_eval)
    def dbl_step(self, T):
        X, Y, Z = T
        XX = self.f2_sqr(X)
        YY = self.f2_sqr(Y)
        s = self.f2_mul(Y, Z)
        XY = self.f2_mul(X, Y)
        w = self.f2_small(XX, 3)
        ss = self.f2_sqr(s)
        B = self.f2_mul(XY, s)
        c1b = self.f2_mul(w, Z)
        wX = self.f2_mul(w, X)
        YYZ = self.f2_mul(YY, Z)
        sZ = self.f2_mul(s, Z)
        wsq = self.f2_sqr(w)
        YYss = self.f2_mul(YY, ss)
        sss = self.f2_mul(s, ss)
        h = self.f2_sub(wsq, self.f2_small(B, 8))
        hs = self.f2_mul(h, s)
        wterm = self.f2_mul(w, self.f2_sub(self.f2_small(B, 4), h))
        X3 = self.f2_small(hs, 2)
        Y3 = self.f2_sub(wterm, self.f2_small(YYss, 8))
        Z3 = self.f2_small(sss, 8)
        c0 = self.f2_sub(self.f2_small(YYZ, 2), wX)
        c4b = self.f2_small(sZ, 2)
        return (X3, Y3, Z3), (c0, c1b, c4b)

    def add_step(self, T, x2, y2):
        X1, Y1, Z1 = T
        yZ = self.f2_mul(y2, Z1)
        xZ = self.f2_mul(x2, Z1)
        theta = self.f2_sub(Y1, yZ)
        delta = self.f2_sub(X1, xZ)
        c = self.f2_sqr(theta)
        d = self.f2_sqr(delta)
        dy = self.f2_mul(delta, y2)
        tx = self.f2_mul(theta, x2)
        e = self.f2_mul(delta, d)
        f_ = self.f2_mul(Z1, c)
        g = self.f2_mul(X1, d)
        h = self.f2_sub(self.f2_add(e, f_), self.f2_small(g, 2))
        X3 = self.f2_mul(delta, h)
        t = self.f2_mul(theta, self.f2_sub(g, h))
        eY = self.f2_mul(e, Y1)
        Z3 = self.f2_mul(Z1, e)
        Y3 = self.f2_sub(t, eY)
        c0 = self.f2_sub(dy, tx)
        return (X3, Y3, Z3), (c0, theta, delta)

    def line_eval(self, f, line, P):
        px, py, pz = P
        c0b, c1b, c4b = line
        return self.f12_mul_by_014(f, self.f2_mul_fp(c0b, pz),
                                   self.f2_mul_fp(c1b, px),
                                   self.f2_mul_fp(c4b, py))

    # Fp values (cuda_g2._mulf / _addf / _subf / _msmall) and the G1 law
    # (cuda_pairing._g1_double / _g1_add)
    def fp_mul(self, a, b):
        v = self._new_fp()
        self.ops.append(_Op(MUL, v, 0, ((a, 0), (b, 0))))
        return v

    def _fp_lin(self, ins, form):
        v = self._new_fp()
        self.ops.append(_Op(LIN, v, 0, tuple((x, 0) for x in ins), form))
        return v

    def fp_add(self, a, b):
        return self._fp_lin((a, b), _ADD)

    def fp_sub(self, a, b):
        return self._fp_lin((a, b), _SUB)

    def fp_small(self, a, k):
        return self._fp_lin((a,), (k, 0, 2, 0))

    def fp_neg(self, a):
        """0 − a: LIN with k = 0 gives fp381 neg's columns."""
        return self._fp_lin((a, a), _NEG)

    def sel(self, window, a, b, stride):
        """a where the row's digit d of `window` is 0, else the value of
        code b + stride·(d − 1)."""
        v = self._new_fp()
        self.ops.append(_Op(SEL, v, 0, ((a, 0), (b, 0)), sel=(window,
                                                               stride)))
        return v

    def g1_double(self, p):
        x, y, z = p
        yy = self.fp_mul(y, y)
        yz = self.fp_mul(y, z)
        zz = self.fp_mul(z, z)
        xy = self.fp_mul(x, y)
        bzz = self.fp_small(zz, 12)
        e8 = self.fp_small(yy, 8)
        s = self.fp_add(yy, bzz)
        d = self.fp_sub(yy, self.fp_small(bzz, 3))
        x3 = self.fp_small(self.fp_mul(d, xy), 2)
        y3 = self.fp_add(self.fp_mul(bzz, e8), self.fp_mul(d, s))
        z3 = self.fp_mul(yz, e8)
        return x3, y3, z3

    def g1_add(self, p1, p2):
        x1, y1, z1 = p1
        x2, y2, z2 = p2
        t0 = self.fp_mul(x1, x2)
        t1 = self.fp_mul(y1, y2)
        t2 = self.fp_mul(z1, z2)
        pxy = self.fp_mul(self.fp_add(x1, y1), self.fp_add(x2, y2))
        pyz = self.fp_mul(self.fp_add(y1, z1), self.fp_add(y2, z2))
        pxz = self.fp_mul(self.fp_add(x1, z1), self.fp_add(x2, z2))
        t3 = self.fp_sub(pxy, self.fp_add(t0, t1))
        t4 = self.fp_sub(pyz, self.fp_add(t1, t2))
        t5 = self.fp_sub(pxz, self.fp_add(t0, t2))
        m = self.fp_small(t0, 3)
        bz = self.fp_small(t2, 12)
        s = self.fp_add(t1, bz)
        d = self.fp_sub(t1, bz)
        by = self.fp_small(t5, 12)
        x3 = self.fp_sub(self.fp_mul(t3, d), self.fp_mul(t4, by))
        y3 = self.fp_add(self.fp_mul(d, s), self.fp_mul(m, by))
        z3 = self.fp_add(self.fp_mul(t4, s), self.fp_mul(t3, m))
        return x3, y3, z3


    # the G2 law (cuda_g2._g2_double / _g2_add, fp381 g2_double / g2_add)
    def g2_double(self, p):
        x, y, z = p
        yy = self.f2_sqr(y)
        yz = self.f2_mul(y, z)
        zz = self.f2_sqr(z)
        xy = self.f2_mul(x, y)
        bzz = self.f2_mul_b3(zz)
        e8 = self.f2_small(yy, 8)
        s = self.f2_add(yy, bzz)
        d = self.f2_sub(yy, self.f2_small(bzz, 3))
        x3 = self.f2_small(self.f2_mul(d, xy), 2)
        y3 = self.f2_add(self.f2_mul(bzz, e8), self.f2_mul(d, s))
        z3 = self.f2_mul(yz, e8)
        return x3, y3, z3

    def g2_add(self, p1, p2):
        x1, y1, z1 = p1
        x2, y2, z2 = p2
        t0 = self.f2_mul(x1, x2)
        t1 = self.f2_mul(y1, y2)
        t2 = self.f2_mul(z1, z2)
        pxy = self.f2_mul(self.f2_add(x1, y1), self.f2_add(x2, y2))
        pyz = self.f2_mul(self.f2_add(y1, z1), self.f2_add(y2, z2))
        pxz = self.f2_mul(self.f2_add(x1, z1), self.f2_add(x2, z2))
        t3 = self.f2_sub(pxy, self.f2_add(t0, t1))
        t4 = self.f2_sub(pyz, self.f2_add(t1, t2))
        t5 = self.f2_sub(pxz, self.f2_add(t0, t2))
        m = self.f2_small(t0, 3)
        bz = self.f2_mul_b3(t2)
        s = self.f2_add(t1, bz)
        d = self.f2_sub(t1, bz)
        by = self.f2_mul_b3(t5)
        x3 = self.f2_sub(self.f2_mul(t3, d), self.f2_mul(t4, by))
        y3 = self.f2_add(self.f2_mul(d, s), self.f2_mul(m, by))
        z3 = self.f2_add(self.f2_mul(t4, s), self.f2_mul(t3, m))
        return x3, y3, z3

    def g2_psi(self, p, cx, cy):
        """ψ as csrc/h2c.cu's K9 PSI computes it: (c_x·x̄, c_y·ȳ, z̄), the
        constants first."""
        x, y, z = p
        return (self.f2_mul(cx, self.f2_conj(x)),
                self.f2_mul(cy, self.f2_conj(y)), self.f2_conj(z))


def miller_dag() -> tuple[Dag, list[int]]:
    """The unrolled loop of `cuda_pairing.miller_loop_plain` → (graph,
    the six Fp2 values of f)."""
    g = Dag()
    P = tuple(g.input(m) for m in (IN_PX, IN_PY, IN_PZ))
    qx, qy = g.input(IN_QX), g.input(IN_QY)
    one, zero = g.input(IN_ONE), g.input(IN_ZERO)
    T = (qx, qy, one)
    f = ((one, zero, zero), (zero, zero, zero))
    for i, bit in enumerate(LOOP_BITS):
        if i:
            f = g.f12_sqr(f)
        T, line = g.dbl_step(T)
        f = g.line_eval(f, line, P)
        if bit:
            T, line = g.add_step(T, qx, qy)
            f = g.line_eval(f, line, P)
    return g, [*f[0], *f[1]]


def g1_dag(nwin: int, neg_y: bool = False) -> tuple[Dag, list[int]]:
    """`nwin` windows of `cuda_pairing.g1_dblsel_plain` from ∞ → (graph,
    the three Fp values of acc).  Each window computes 4·acc + T[w] with
    T[0] standing in as P, and SEL keeps 4·acc where w = 0.  With `neg_y`
    the graph ends in one LIN more, y's negation with fp381 neg's columns:
    the outputs are the Miller p-side (x, −y, z) of
    `cuda_pairing.g1_proj_rows`."""
    g = Dag()
    t1 = tuple(g.input(G1_T1 + c) for c in range(3))
    one, zero = g.input(G1_ONE), g.input(G1_ZERO)
    acc = (zero, one, zero)
    for i in range(nwin):
        acc4 = g.g1_double(g.g1_double(acc))
        t = tuple(g.sel(i, c, c, G1_STRIDE) for c in t1)
        s = g.g1_add(acc4, t)
        acc = tuple(g.sel(i, a, b, 0) for a, b in zip(acc4, s))
    if neg_y:
        acc = (acc[0], g.fp_neg(acc[1]), acc[2])
    return g, list(acc)


def straus_head_dag() -> tuple[Dag, list[int]]:
    """K16's HEAD: acc ← 8·acc, three doublings of the resident acc."""
    g = Dag()
    acc = tuple(g.slot_input(s) for s in ST_ACC)
    for _ in range(3):
        acc = g.g2_double(acc)
    return g, list(acc)


def straus_tail_dag() -> tuple[Dag, list[int]]:
    """K16's TAIL, one share's step of `cuda_g2.straus_step_plain`:
    acc ← acc + T[|d|] with T's y negated where d < 0; d = 0 keeps acc
    (the sum is computed and dropped, as the plain step computes it)."""
    g = Dag()
    acc = tuple(g.slot_input(s) for s in ST_ACC)
    t = tuple(g.f2_sel(ST_ABS, g.input(ST_T4 + 2 * c), g.input(ST_T1 + 2 * c),
                       ST_STRIDE) for c in range(3))
    y = g.f2_sel(ST_NEG, t[1], g.f2_neg(t[1]), 0)
    s = g.g2_add(acc, (t[0], y, t[2]))
    return g, [g.f2_sel(ST_NZ, a, b, 0) for a, b in zip(acc, s)]


def zmul_dag() -> tuple[Dag, list[int]]:
    """K17: [|x|]Q as `cuda_h2c.zmul_plain` computes it — the table {Q,
    2Q, 3Q} (one doubling, one addition), then per 2-bit window two
    doublings and, for a non-zero window, one addition (a zero window
    keeps 4·acc, so it needs none)."""
    g = Dag()
    q = tuple(g.input(ZM_Q + 2 * c) for c in range(3))
    one, zero = g.input(ZM_ONE), g.input(ZM_ZERO)
    q2 = g.g2_double(q)
    table = (None, q, q2, g.g2_add(q2, q))
    acc = (zero, one, zero)
    for w in Z_WINDOWS:
        acc = g.g2_double(g.g2_double(acc))
        if w:
            acc = g.g2_add(acc, table[w])
    return g, list(acc)


class _F2Split:
    """Fp2 values as (c0, c1) pairs of Fp values, each op split into
    independent Fp ops that lanes of a row run side by side: a square is
    (a0 + a1)(a0 − a1) and (a0 + a0)·a1 (one LIN step, one product step),
    a product the four schoolbook products and two LINs.  The same values
    as MUL2 / SQR2, other redundant limbs."""

    def __init__(self, g: Dag):
        self.g = g

    def sqr(self, a):
        g = self.g
        a0, a1 = a
        return (g.fp_mul(g.fp_add(a0, a1), g.fp_sub(a0, a1)),
                g.fp_mul(g.fp_add(a0, a0), a1))

    def mul(self, a, b):
        g = self.g
        (a0, a1), (b0, b1) = a, b
        return (g.fp_sub(g.fp_mul(a0, b0), g.fp_mul(a1, b1)),
                g.fp_add(g.fp_mul(a0, b1), g.fp_mul(a1, b0)))


class _FpOps:
    """Fp values, for the norm's Fermat pow."""

    def __init__(self, g: Dag):
        self.g = g

    def sqr(self, a):
        return self.g.fp_mul(a, a)

    def mul(self, a, b):
        return self.g.fp_mul(a, b)


# K18's three exponents (cuda_h2c's): Alg. 9's two pows and Fermat's
EXP_SQRT_A1 = (P - 3) // 4
EXP_SQRT_B = (P - 1) // 2
EXP_INV = P - 2


def pow_digits(e: int, bits: int) -> tuple[int, ...]:
    """Base-2^bits digits of a positive exponent, MSB first."""
    out = []
    while e:
        out.append(e & ((1 << bits) - 1))
        e >>= bits
    return tuple(reversed(out))


def _pow(F, a, e: int, bits: int):
    """a^e by fixed windows of `bits`, MSB first: the table a..a^top (top
    the largest digit), then per window `bits` squarings and, for a
    non-zero digit, one product — with bits = 4 the schedule of cuda_h2c
    `f2_pow_steps` (its 14 table launches and its sqr4 / sqr4mul
    windows)."""
    digs = pow_digits(e, bits)
    tbl = [None, a]
    if max(digs) >= 2:
        tbl.append(F.sqr(a))
    for k in range(3, max(digs) + 1):
        tbl.append(F.mul(tbl[k - 1], a))
    acc = tbl[digs[0]]
    for d in digs[1:]:
        for _ in range(bits):
            acc = F.sqr(acc)
        if d:
            acc = F.mul(acc, tbl[d])
    return acc


# K18's input blocks: the root's v (Fp2) and the constant one; the
# inverse's a; the map's affine step's xd, xn, Z·u² and the chosen root
# (Fp2 each)
CH_V, CH_ONE, CH_SQRT_PLANES = 0, 2, 3
CH_INV_PLANES = 2
CH_XD, CH_XN, CH_ZU2, CH_ROOT, CH_AFFINE_PLANES = 0, 2, 4, 6, 8


def _f2_in(g: Dag, plane: int):
    return g.input(plane), g.input(plane + 1)


def sqrt_dag(bits: int) -> tuple[Dag, list[int]]:
    """Alg. 9 as `cuda_h2c.f2_sqrt_steps` computes it: a1 = v^((p−3)/4),
    α = a1²·v, x0 = a1·v, root_u = u·x0 = (−x0c1, x0c0), root_b =
    (α + 1)^((p−1)/2)·x0 → outputs α, root_u, root_b, root_u², root_b²
    (10 planes).  The exact tests — α = −1, root² = v — and the select
    stay with the caller."""
    g = Dag()
    one = g.input(CH_ONE)
    v = _f2_in(g, CH_V)
    F = _F2Split(g)
    a1 = _pow(F, v, EXP_SQRT_A1, bits)
    alpha = F.mul(F.sqr(a1), v)
    x0 = F.mul(a1, v)
    root_u = (g.fp_neg(x0[1]), x0[0])
    ap1 = (g.fp_add(alpha[0], one), alpha[1])
    root_b = F.mul(_pow(F, ap1, EXP_SQRT_B, bits), x0)
    outs = [alpha, root_u, root_b, F.sqr(root_u), F.sqr(root_b)]
    return g, [x for o in outs for x in o]


def _inv(g: Dag, a, bits: int):
    """a⁻¹ = ā·(a·ā)^(p−2) (inv(0) = 0), with the norm a0² + a1² and its
    pow in Fp alone (the norm's imaginary part is zero in value)."""
    a0, a1 = a
    n = g.fp_add(g.fp_mul(a0, a0), g.fp_mul(a1, a1))
    ninv = _pow(_FpOps(g), n, EXP_INV, bits)
    return g.fp_mul(a0, ninv), g.fp_mul(g.fp_neg(a1), ninv)


def inv_dag(bits: int) -> tuple[Dag, list[int]]:
    """The Fp2 inverse of the input block's a → 2 planes."""
    g = Dag()
    return g, list(_inv(g, _f2_in(g, 0), bits))


def affine_dag(bits: int) -> tuple[Dag, list[int]]:
    """The map's step from the root to affine E' points (`cuda_h2c.
    map_to_g2_rows`): xdi = xd⁻¹, then x = xn·xdi and (Z·u²·xn)·xdi for
    both choices of the numerator, y = root·xdi² → 6 planes; the caller
    picks the numerator where the first candidate's root checked."""
    g = Dag()
    xd, xn, zu2, root = (_f2_in(g, p) for p in (CH_XD, CH_XN, CH_ZU2,
                                                CH_ROOT))
    F = _F2Split(g)
    xdi = _inv(g, xd, bits)
    outs = [F.mul(xn, xdi), F.mul(F.mul(zu2, xn), xdi),
            F.mul(root, F.sqr(xdi))]
    return g, [x for o in outs for x in o]


def g1_tables_dag() -> tuple[Dag, list[int]]:
    """K20: the RLC tables 2P = `g1_double`(P), 3P = `g1_add`(2P, P) of
    `cuda_pairing._g1_double` / `_g1_add` → 6 planes."""
    g = Dag()
    base = tuple(g.input(c) for c in range(3))
    p2 = g.g1_double(base)
    return g, [*p2, *g.g1_add(p2, base)]


# K22's programs (csrc/g2_law.cu): K2's launch sequences on the complete
# G2 law.  Each input block holds whole points, (x, y, z) as Fp2 planes,
# 6 planes a point; the outputs are points too.

def _g2_in(g: Dag, plane: int):
    return tuple(g.input(plane + 2 * c) for c in range(3))


def _g2_neg(g: Dag, p):
    """−P = (x, −y, z), y negated by LIN (fp381 neg's columns)."""
    return p[0], g.f2_neg(p[1]), p[2]


def g2_tables_dag() -> tuple[Dag, list[int]]:
    """The combine's Straus tables (the K2 launches of
    `cuda_g2.straus_tables_steps`): 2P = dbl(P), 3P = add(2P, P), 4P =
    dbl(2P) → 18 planes."""
    g = Dag()
    p = _g2_in(g, 0)
    p2 = g.g2_double(p)
    return g, [*p2, *g.g2_add(p2, p), *g.g2_double(p2)]


#: the "pre" program's ψ constants c_x, c_y: Fp2 planes 12–15 of its
#: input block, after the two halves' points (`Program.consts`)
PRE_PSI_CX, PRE_PSI_CY = 12, 14


def h2c_pre_dag() -> tuple[Dag, list[int]]:
    """Hash-to-G2 before the clearing's multiplies: R = M₀ + M₁, the two
    mapped halves' sum, D = 2R, ψ(R) and ψ²(2R) = ψ(ψ(D)) (ψ(D) only a
    step on the way) → 24 planes."""
    g = Dag()
    r = g.g2_add(_g2_in(g, 0), _g2_in(g, 6))
    d = g.g2_double(r)
    cx, cy = g.input(PRE_PSI_CX), g.input(PRE_PSI_CY)
    psi2d = g.g2_psi(g.g2_psi(d, cx, cy), cx, cy)
    return g, [*r, *d, *g.g2_psi(r, cx, cy), *psi2d]


def h2c_post_dag() -> tuple[Dag, list[int]]:
    """The clearing's five additions (`cuda_h2c.law_steps("post")`):
    ((t1 + t0) + −R) + (−[|x|]ψ(R) + −ψ(R)), plus ψ²(2R); inputs t1 =
    [x²]R, t0 = [|x|]R, R, [|x|]ψ(R), ψ(R), ψ²(2R) → 6 planes."""
    g = Dag()
    t1, t0, r, xpsir, psir, psi2d = (_g2_in(g, 6 * k) for k in range(6))
    part1 = g.g2_add(g.g2_add(t1, t0), _g2_neg(g, r))
    part2 = g.g2_add(_g2_neg(g, xpsir), _g2_neg(g, psir))
    return g, list(g.g2_add(g.g2_add(part1, part2), psi2d))


#: kind → (the graph, the caller's input planes, output planes); "pre"'s
#: block also carries the ψ constants (`law_program` sets them as the
#: program's `consts`)
LAWS = {"tables": (g2_tables_dag, 6, 18), "pre": (h2c_pre_dag, 12, 24),
        "post": (h2c_post_dag, 36, 6)}


# K23's program (csrc/h2c_map.cu): the 3-isogeny E' → E of an affine
# point (x, y) that the kernel's prologue writes into the pinned pairs at
# slots MT_X and MT_Y.  Its constants are the isogeny's 13 Fp2
# coefficients, one block in device memory that every row reads (the
# program's GLOBAL planes): the x-numerator k1_0..k1_3 at planes 0–7, the
# monic x-denominator k2_0, k2_1 at 8–11, the y-numerator k3_0..k3_3 at
# 12–19, the monic y-denominator k4_0..k4_2 at 20–25.
MT_X, MT_Y = 0, 2
MT_XN, MT_XD, MT_YN, MT_YD, MT_CONST_PLANES = 0, 8, 12, 20, 26
#: K23's (lanes, slots, look-ahead): chip_smoke.py's sweep over 4, 8 and
#: 16 lanes at 128 and 4,096 rows (PERF.md) — 8 lanes with 20 slots (9
#: steps) as fast as 16 at 128 rows and 1.9× faster at 4,096, 16 slots
#: (12 steps) 10–17% slower
MT_CONFIG = (8, 20, 40)


def iso3_dag() -> tuple[Dag, list[int]]:
    """The 3-isogeny as csrc/h2c.cu's K9 ISO3 computes it: the four
    Horner evaluations of `horner<DEG, MONIC>` (each op on the same
    operands, so every value keeps its bits), then xn·yd, y·(yn·xd) and
    xd·yd → the projective (X, Y, Z), 6 planes."""
    g = Dag()
    x, y = g.slot_input(MT_X), g.slot_input(MT_Y)

    def horner(base: int, deg: int, monic: bool):
        def k(i):
            return g.input(base + 2 * i)

        acc = g.f2_add(x, k(deg - 1)) if monic else k(deg)
        for i in range(deg - 1 - monic, -1, -1):
            acc = g.f2_add(g.f2_mul(acc, x), k(i))
        return acc

    xn, xd = horner(MT_XN, 3, False), horner(MT_XD, 2, True)
    yn, yd = horner(MT_YN, 3, False), horner(MT_YD, 3, True)
    return g, [g.f2_mul(xn, yd), g.f2_mul(y, g.f2_mul(yn, xd)),
               g.f2_mul(xd, yd)]


# K24's program (csrc/h2c_sswu.cu): SSWU's fraction and both radicands of
# a row's u, which the kernel's prologue writes into the pinned pair at
# slot SW_U.  Its constants are the first six Fp2 constants of the h2c
# table (cuda_h2c._HC_ONE.._HC_B), one block in device memory that every
# row reads: one at planes 0–1, Z 2–3, A' 4–5, −A' 6–7, Z·A' 8–9, B'
# 10–11.  The exceptional denominator is a SEL on window 0, whose digit
# is the prologue's flag u ≡ 0.
SW_U = 0
SW_ONE, SW_Z, SW_A, SW_NEG_A, SW_ZA, SW_B, SW_CONST_PLANES = (
    0, 2, 4, 6, 8, 10, 12)
#: K24's (lanes, slots, look-ahead): chip_smoke.py's sweep over 2, 4, 8
#: and 16 lanes at 128 and 4,096 rows (PERF.md) — every width from 4
#: lanes schedules 14 steps; 4 lanes were the fastest at 4,096 rows,
#: where 16 took twice as long, and within 1% of the best at 128; 16
#: slots are too few to schedule
SW_CONFIG = (4, 20, 40)


def sswu_dag() -> tuple[Dag, list[int]]:
    """SSWU as csrc/h2c.cu's K8 computes it (pallas_h2c `_sswu_body`),
    every op on the same operands, so every value keeps its bits: u², Z·u²,
    (Z·u²)², tv1, then xd = −A'·tv1 or, where the row's flag is set, Z·A'
    (a SEL), xn = B'·(tv1 + 1), the powers of xd and xn, gx_num and v1 =
    gx_num·xd, v2 = (Z·u²)³·v1 → (xn, xd, Z·u², v1, v2), 10 planes."""
    g = Dag()
    u = g.slot_input(SW_U)
    one, z, a, na, za, b = (g.input(c) for c in (SW_ONE, SW_Z, SW_A,
                                                  SW_NEG_A, SW_ZA, SW_B))
    zu2 = g.f2_mul(z, g.f2_sqr(u))
    zu2sq = g.f2_sqr(zu2)
    tv1 = g.f2_add(zu2sq, zu2)
    xd = g.f2_sel(0, g.f2_mul(na, tv1), za, 0)
    xn = g.f2_mul(b, g.f2_add(tv1, one))
    xd2 = g.f2_sqr(xd)
    xd3 = g.f2_mul(xd2, xd)
    xn3 = g.f2_mul(g.f2_sqr(xn), xn)
    gx = g.f2_add(g.f2_add(xn3, g.f2_mul(a, g.f2_mul(xn, xd2))),
                  g.f2_mul(b, xd3))
    v1 = g.f2_mul(gx, xd)
    return g, [xn, xd, zu2, v1, g.f2_mul(g.f2_mul(zu2sq, zu2), v1)]


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------

@dataclass
class Program:
    code: np.ndarray          # int32 [steps, lanes, 2]
    kinds: np.ndarray         # int32 [steps]
    out: np.ndarray           # int32 [planes]: each output plane's code
    lanes: int
    slots: int
    preset: tuple = ()        # slots that hold the kernel's values on entry
    consts: np.ndarray | None = None  # [planes, 32] after the caller's block

    @property
    def steps(self) -> int:
        return len(self.kinds)

    def cost(self) -> int:
        """Instructions one lane issues: each step costs its kind."""
        return int(sum(COST[int(k)] for k in self.kinds))


def schedule(dag: Dag, outs: list[int], lanes: int = LANES,
             slots: int = SLOTS, window: int = WINDOW) -> Program:
    """List-schedule the graph: each step takes the kind whose ready ops
    waste the fewest lane-instructions, (lanes − ops) · cost, then up to
    `lanes` ops of it, oldest first.  Cheap LIN steps run as soon as they
    are ready, so products wait until more of them are ready at once.
    Only ops within `window` of the oldest unscheduled one are candidates,
    which bounds how far the program runs ahead of the sequential order
    (and so the slots it holds).  An Fp2 value takes a free pair of
    slots; an Fp value (`dag.fp_vals`) a free single slot, splitting a
    pair when none is left.  A pinned input keeps its pair throughout."""
    ops = dag.ops
    nops = len(ops)
    prod: dict[tuple[int, int], int] = {}
    for i, op in enumerate(ops):
        for h in ((0, 1) if op.half is None else (op.half,)):
            prod[(op.out, h)] = i
    deps = [set() for _ in ops]
    users: dict[int, int] = {}
    for i, op in enumerate(ops):
        for v, h in op.ins:
            if v in dag.glob:
                continue
            users[v] = users.get(v, 0) + 1
            if v in dag.pinned:
                continue
            for hh in ((0, 1) if h is None else (h,)):
                deps[i].add(prod[(v, hh)])
    succ = [[] for _ in ops]
    for i, d in enumerate(deps):
        for j in d:
            succ[j].append(i)
    keep = set(outs)
    waiting = [len(d) for d in deps]
    ready = {i for i in range(nops) if not deps[i]}
    scheduled = [False] * nops
    oldest = 0
    # pairs, by their c0 slot
    free = [p for p in range(0, slots - 1, 2)
            if p not in dag.pinned.values()][::-1]
    free1: list[int] = []                        # single slots
    home: dict[int, int] = dict(dag.pinned)      # value → (c0) slot
    left = dict(users)
    code, kinds = [], []
    done = 0

    def at(v, h):
        base = (GLOBAL + dag.glob[v]) if v in dag.glob else home[v]
        return base + (h or 0)

    while done < nops:
        while scheduled[oldest]:
            oldest += 1
        by_kind: dict[int, list[int]] = {}
        for i in sorted(ready):
            if i < oldest + window:
                by_kind.setdefault(ops[i].kind, []).append(i)
        best = None
        for kind, cand in by_kind.items():
            # the ops a step of this kind can take: a new value needs a
            # free pair (an Fp value a free slot)
            new, take = set(), []
            avail2, avail1 = len(free), len(free1)
            for i in cand:
                v = ops[i].out
                if v not in home and v not in new:
                    if v in dag.fp_vals and avail1:
                        avail1 -= 1
                    elif not avail2:
                        continue
                    else:
                        avail2 -= 1
                        avail1 += v in dag.fp_vals
                    new.add(v)
                take.append(i)
                if len(take) == lanes:
                    break
            if not take:
                continue
            key = ((lanes - len(take)) * COST[kind], take[0])
            if best is None or key < best[0]:
                best = (key, kind, take)
        if best is None:
            raise RuntimeError(f"schedule: {slots} slots are too few (every "
                               f"ready op needs a new pair)")
        _, kind, chosen = best
        for i in chosen:
            v = ops[i].out
            if v in home:
                continue
            if v in dag.fp_vals:
                if not free1:
                    free1.append(free.pop() + 1)
                    home[v] = free1[-1] - 1
                else:
                    home[v] = free1.pop()
            else:
                home[v] = free.pop()
        freed, freed1 = [], []
        row = np.zeros((lanes, 2), np.uint32)
        for lane, i in enumerate(chosen):
            op = ops[i]
            out = home[op.out] + (op.half or 0)
            a = at(*op.ins[0])
            b = at(*op.ins[1]) if len(op.ins) > 1 else a
            if op.kind == SEL:
                win, stride = op.sel
                w1 = win | stride << 8
            else:
                k, sg, iters, spread = op.lin
                w1 = k | (sg + 1) << 8 | iters << 12 | spread << 16
            row[lane] = (op.kind | out << 8 | a << 16 | b << 24, w1)
            for v, _ in op.ins:
                if v in dag.glob:
                    continue
                left[v] -= 1
                if left[v] == 0 and v not in keep and v not in dag.pinned:
                    (freed1 if v in dag.fp_vals else freed).append(home[v])
        code.append(row.view(np.int32))
        kinds.append(kind)
        free.extend(freed)
        free1.extend(freed1)
        for i in chosen:
            ready.discard(i)
            scheduled[i] = True
            done += 1
            for j in succ[i]:
                waiting[j] -= 1
                if waiting[j] == 0:
                    ready.add(j)
    out = np.array([at(v, h) for v in outs
                    for h in ((0,) if v in dag.fp_vals else (0, 1))],
                   np.int32)
    preset = tuple(sorted(s + h for s in dag.pinned.values() for h in (0, 1)))
    return Program(np.stack(code), np.asarray(kinds, np.int32), out, lanes,
                   slots, preset)


_PROGRAM: dict[tuple, Program] = {}


def miller_program(lanes: int = LANES, slots: int = SLOTS,
                   window: int = WINDOW) -> Program:
    """The scheduled Miller loop (built once per shape)."""
    key = ("miller", lanes, slots, window)
    if key not in _PROGRAM:
        dag, outs = miller_dag()
        _PROGRAM[key] = schedule(dag, outs, lanes, slots, window)
    return _PROGRAM[key]


def g1_program(nwin: int, lanes: int = G1_LANES, slots: int = G1_SLOTS,
               window: int = G1_WINDOW, neg_y: bool = False) -> Program:
    """The scheduled `nwin`-window G1 scalar multiplication, its y
    negated with `neg_y` (built once per shape)."""
    key = ("g1", nwin, lanes, slots, window) + (("neg_y",) if neg_y else ())
    if key not in _PROGRAM:
        dag, outs = g1_dag(nwin, neg_y)
        _PROGRAM[key] = schedule(dag, outs, lanes, slots, window)
    return _PROGRAM[key]


def straus_programs(lanes: int = ST_LANES, slots: int = ST_SLOTS,
                    window: int = ST_WINDOW) -> tuple[Program, Program]:
    """K16's scheduled (HEAD, TAIL) programs (built once per shape)."""
    key = ("straus", lanes, slots, window)
    if key not in _PROGRAM:
        _PROGRAM[key] = tuple(schedule(*dag(), lanes, slots, window)
                              for dag in (straus_head_dag, straus_tail_dag))
    return _PROGRAM[key]


def zmul_program(lanes: int = ZM_LANES, slots: int = ZM_SLOTS,
                 window: int = ZM_WINDOW) -> Program:
    """K17's scheduled [|x|]-multiply (built once per shape)."""
    key = ("zmul", lanes, slots, window)
    if key not in _PROGRAM:
        _PROGRAM[key] = schedule(*zmul_dag(), lanes, slots, window)
    return _PROGRAM[key]


#: K18's programs: the function that makes each graph, and its input /
#: output planes
CHAINS = {"sqrt": (sqrt_dag, CH_SQRT_PLANES, 10),
          "inv": (inv_dag, CH_INV_PLANES, 2),
          "affine": (affine_dag, CH_AFFINE_PLANES, 6)}
#: each program's (lanes, slots, look-ahead, window bits), chosen
#: by chip_smoke.py's sweep (PERF.md): the root's at a batch that fills
#: the card, where the rows' shared memory decides (3-bit windows keep 24
#: slots a row, 2 lanes the issued instructions few); the inverse's and
#: the affine step's, whose Fp pow runs on one lane, at every size
CH_CONFIG = {"sqrt": (2, 24, 40, 3), "inv": (2, 18, 40, 4),
             "affine": (2, 18, 40, 4)}
#: the root's configuration for a batch of at most `CH_WIDE_WARPS` warps
#: an SM at its lanes: there each row's chain is what the launch costs,
#: and 4 lanes shorten it
CH_WIDE = {"sqrt": (4, 24, 40, 3)}
CH_WIDE_WARPS = 4


def chain_config(kind: str, rows: int, sms: int) -> tuple:
    """The configuration K18 runs `kind` with on `rows` rows of a card with
    `sms` SMs (0: no card, the plain version's default)."""
    wide = CH_WIDE.get(kind)
    if wide and sms and rows * wide[0] <= 32 * CH_WIDE_WARPS * sms:
        return wide
    return CH_CONFIG[kind]


def chain_program(kind: str, cfg: tuple | None = None) -> Program:
    """K18's scheduled `kind` program ("sqrt", "inv" or "affine") under
    cfg = (lanes, slots, look-ahead, window bits) (built once per
    configuration)."""
    lanes, slots, window, bits = cfg or CH_CONFIG[kind]
    key = ("chain", kind, lanes, slots, window, bits)
    if key not in _PROGRAM:
        dag = CHAINS[kind][0](bits)
        _PROGRAM[key] = schedule(*dag, lanes, slots, window)
    return _PROGRAM[key]


#: K22's configurations (lanes, slots, look-ahead) per program: 8 lanes
#: were fastest at every shape of chip_smoke.py's sweep (the combine's
#: 71,680 table rows, a hash batch's 64 and 2,048; PERF.md), where 16
#: lanes tie or lose; the slots are those with the fewest issued
#: instructions a lane (`Program.cost`) at 8 lanes ("pre" with ψ: 26
#: slots schedule 31 steps, 30 slots 23)
LW_CONFIG = {"tables": (8, 34, 40), "pre": (8, 30, 40), "post": (8, 36, 40)}


def law_program(kind: str, cfg: tuple | None = None) -> Program:
    """K22's scheduled `kind` program ("tables", "pre" or "post") under
    cfg = (lanes, slots, look-ahead) (built once per configuration)."""
    lanes, slots, window = cfg or LW_CONFIG[kind]
    key = ("law", kind, lanes, slots, window)
    if key not in _PROGRAM:
        prog = schedule(*LAWS[kind][0](), lanes, slots, window)
        if kind == "pre":
            from .cuda_h2c import psi_const_planes

            prog.consts = psi_const_planes()
        _PROGRAM[key] = prog
    return _PROGRAM[key]


def map_tail_program(cfg: tuple | None = None) -> Program:
    """K23's scheduled isogeny under cfg = (lanes, slots, look-ahead)
    (None: `MT_CONFIG`; built once per configuration); its `consts` the
    isogeny's coefficient block."""
    lanes, slots, window = cfg or MT_CONFIG
    key = ("map_tail", lanes, slots, window)
    if key not in _PROGRAM:
        from .cuda_h2c import iso3_const_planes

        prog = schedule(*iso3_dag(), lanes, slots, window)
        prog.consts = iso3_const_planes()
        _PROGRAM[key] = prog
    return _PROGRAM[key]


def sswu_program(cfg: tuple | None = None) -> Program:
    """K24's scheduled SSWU under cfg = (lanes, slots, look-ahead) (None:
    `SW_CONFIG`; built once per configuration); its `consts` the six Fp2
    constants' block."""
    lanes, slots, window = cfg or SW_CONFIG
    key = ("sswu", lanes, slots, window)
    if key not in _PROGRAM:
        from .cuda_h2c import sswu_const_planes

        prog = schedule(*sswu_dag(), lanes, slots, window)
        prog.consts = sswu_const_planes()
        _PROGRAM[key] = prog
    return _PROGRAM[key]


def g1_tables_program() -> Program:
    """K20's scheduled doubling and addition, on K15's lanes, slots and
    look-ahead (built once)."""
    key = ("g1_tables",)
    if key not in _PROGRAM:
        _PROGRAM[key] = schedule(*g1_tables_dag(), G1_LANES, G1_SLOTS,
                                 G1_WINDOW)
    return _PROGRAM[key]


_ON_DEVICE: dict = {}


def on_device(prog: Program, device) -> tuple:
    """(code, output plane codes, steps) of a scheduled program as
    tensors on `device`, uploaded once per program and device."""
    key = (id(prog), str(device))
    if key not in _ON_DEVICE:
        # the entry holds the program, so its id is never reused
        _ON_DEVICE[key] = (prog, torch.from_numpy(prog.code).to(device),
                           torch.from_numpy(prog.out).to(device))
    return (*_ON_DEVICE[key][1:], prog.steps)


def _fields(code: np.ndarray):
    """[..., 2] int32 words → (kind, out, a, b, k, s, iters, spread,
    stride); SEL's window is k."""
    w0 = code[..., 0].astype(np.int64) & 0xFFFFFFFF
    w1 = code[..., 1].astype(np.int64)
    return (w0 & 0xFF, (w0 >> 8) & 0xFF, (w0 >> 16) & 0xFF, w0 >> 24,
            w1 & 0xFF, ((w1 >> 8) & 0xF) - 1, (w1 >> 12) & 0xF,
            (w1 >> 16) & 1, (w1 >> 8) & 0xFF)


def _sel_codes(b: int, stride: int) -> list[int]:
    """The codes a SEL may copy from besides a: b, or T[1..3] from b."""
    return [b + stride * j for j in range(3 if stride else 1)]


def check(prog: Program) -> None:
    """The invariants the kernel relies on: one kind a step; no op of a
    step reads or writes a slot another op of it writes; every slot read
    was written at an earlier step (or is preset); slots in range; a SEL
    steps through input planes only (its stride never walks the slots);
    with preset slots, every output is a slot outside them, so the kernel
    can copy the outputs into them."""
    kind, out, a, b, *_, stride = _fields(prog.code)
    written: set[int] = set(prog.preset)
    if prog.preset and not all(int(c) < prog.slots and int(c) not in
                               prog.preset for c in prog.out):
        raise AssertionError(f"outputs {prog.out.tolist()} are not slots "
                             f"outside the preset {prog.preset}")
    for s in range(prog.steps):
        live = kind[s] != NOP
        if set(kind[s][live].tolist()) != {int(prog.kinds[s])}:
            raise AssertionError(f"step {s}: kinds {kind[s][live]}")
        wide = int(prog.kinds[s]) in (MUL2, SQR2)
        reads, writes = set(), []
        for lane in np.flatnonzero(live):
            writes += [int(out[s, lane]) + h for h in range(1 + wide)]
            srcs = {int(a[s, lane]), int(b[s, lane])}
            if int(prog.kinds[s]) == SEL:
                st = int(stride[s, lane])
                if st and int(b[s, lane]) < GLOBAL:
                    raise AssertionError(f"step {s}: SEL strides from slot "
                                         f"{int(b[s, lane])}")
                srcs |= set(_sel_codes(int(b[s, lane]), st))
            for code in srcs:
                if code < GLOBAL:
                    reads |= {code + h for h in range(1 + wide)}
        if len(set(writes)) != len(writes) or reads & set(writes):
            raise AssertionError(f"step {s}: a slot is both read and written")
        if not reads <= written:
            raise AssertionError(f"step {s}: reads unwritten slots "
                                 f"{sorted(reads - written)}")
        if max(writes) >= prog.slots:
            raise AssertionError(f"step {s}: slot out of range")
        written |= set(writes)


def lin_plain(a: torch.Tensor, b: torch.Tensor, k: int, s: int, iters: int,
              spread: int) -> torch.Tensor:
    """The kernel's LIN on [32, R] tensors: spread·48p + k·a + s·b, one
    zero (or 48p's top) column above, reduced (cuda_g2's plain reduce);
    iters = 0 copies a."""
    from .cuda_g2 import _SPREAD, _col, _reduce

    if iters == 0:
        return a
    d = torch.cat([k * a + s * b, a.new_zeros((1,) + tuple(a.shape[1:]))])
    if spread:
        d = d + _col(_SPREAD, d)
    return _reduce(d, iters)


def execute(prog: Program, planes: list, digits=None,
            preset=None) -> torch.Tensor:
    """Execute the program on CPU (or any) tensors with the plain field
    functions, as the kernel's lanes do: `planes` the row's input block as
    [32, R] tensors, `digits` [nwin, R] the window digits SEL reads,
    `preset` the [32, R] contents of `prog.preset`'s slots → the output
    planes [len(prog.out), 32, R].  A step's writes land after all its
    reads."""
    from .cuda_g2 import _f2mul, _f2sqr, _mulf

    slots: dict[int, torch.Tensor] = dict(zip(prog.preset, preset or ()))

    def get(code: int) -> torch.Tensor:
        return planes[code - GLOBAL] if code >= GLOBAL else slots[code]

    fields = _fields(prog.code)
    for s in range(prog.steps):
        writes = {}
        for lane in range(prog.lanes):
            kind, o, a, b, k, sg, iters, spread, stride = (
                int(f[s, lane]) for f in fields)
            if kind == SEL:
                d = digits[k]
                out = get(a)
                for j, code in enumerate(_sel_codes(b, stride)):
                    out = torch.where(d == j + 1 if stride else d != 0,
                                      get(code), out)
                writes[o] = out
            elif kind == MUL2:
                writes[o], writes[o + 1] = _f2mul((get(a), get(a + 1)),
                                                  (get(b), get(b + 1)))
            elif kind == SQR2:
                writes[o], writes[o + 1] = _f2sqr((get(a), get(a + 1)))
            elif kind == MUL:
                writes[o] = _mulf(get(a), get(b))
            elif kind == LIN:
                writes[o] = lin_plain(get(a), get(b), k, sg, iters, spread)
        slots.update(writes)
    return torch.stack([get(int(c)) for c in prog.out])


def _consts(n: int, device, k: int) -> list[torch.Tensor]:
    """The planes one, then k − 1 zeros, of n rows."""
    one = fp.const(fp.ONE, device).unsqueeze(-1).expand(fp.NLIMBS, n)
    return [one] + [torch.zeros_like(one)] * (k - 1)


def run_plain(prog: Program, p: torch.Tensor, q: torch.Tensor
              ) -> torch.Tensor:
    """The Miller program on [3, 32, R] / [4, 32, R] tensors → f
    [12, 32, R]."""
    return execute(prog, [*p, *q, *_consts(p.shape[-1], p.device, 4)])


def g1_run_plain(prog: Program, t1: torch.Tensor, t2: torch.Tensor,
                 t3: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """K15's program on the [3, 32, R] tables and [nwin, R] windows →
    [3, 32, R] projective rows."""
    return execute(prog, [*t1, *t2, *t3, *_consts(t1.shape[-1], t1.device,
                                                  2)], windows)


def straus_run_plain(head: Program, tail: Program, tables, digits:
                     torch.Tensor, t_count: int) -> torch.Tensor:
    """K16's loop on CPU tensors: the four [6, 32, T·n] tables (rows
    t-major), digits [nwin, T·n] → [6, 32, n].  From ∞, per window one
    HEAD run, then per share one TAIL run on that share's table rows and
    digit fields, skipped where every digit is 0 (as the kernel skips
    it); each run's outputs become the next run's preset
    accumulator."""
    from .cuda_g2 import inf_planes

    n = tables[0].shape[-1] // t_count
    acc = list(inf_planes(n, tables[0].device))
    for i in range(digits.shape[0]):
        acc = list(execute(head, [], None, acc))
        for k in range(t_count):
            d = digits[i, k * n:(k + 1) * n]
            if not bool((d != 0).any()):
                continue
            planes = [t[j, :, k * n:(k + 1) * n] for t in tables
                      for j in range(6)]
            fields = torch.stack([d.abs() & 3, (d < 0).int(),
                                  (d != 0).int()])
            acc = list(execute(tail, planes, fields, acc))
    return torch.stack(acc)


def zmul_run_plain(prog: Program, q: torch.Tensor) -> torch.Tensor:
    """K17's program on [6, 32, R] points → [|x|]Q [6, 32, R]."""
    return execute(prog, [*q, *_consts(q.shape[-1], q.device, 4)])


def chain_run_plain(prog: Program, planes) -> torch.Tensor:
    """K18's program on CPU (or any) tensors: `planes` the input block as
    [32, R] tensors → the output planes."""
    return execute(prog, list(planes))


def const_rows(prog: Program, n: int, device) -> list[torch.Tensor]:
    """The program's constant planes (`Program.consts`), each broadcast to
    n rows as a [32, n] tensor (none: [])."""
    if prog.consts is None:
        return []
    c = fp.const(prog.consts, device)
    return list(c.unsqueeze(-1).expand(*c.shape, n))


def law_run_plain(prog: Program, block: torch.Tensor) -> torch.Tensor:
    """K22's program on CPU (or any) tensors: `block` the input points'
    planes [in planes, 32, R] → the output planes."""
    return execute(prog, list(block) + const_rows(prog, block.shape[-1],
                                                  block.device))


def map_tail_run_plain(prog: Program, x: torch.Tensor, y: torch.Tensor
                       ) -> torch.Tensor:
    """K23's program on CPU (or any) tensors: the affine (x, y) [2, 32, R]
    each, pinned where the kernel's prologue puts them → the isogeny's
    projective planes [6, 32, R]."""
    return execute(prog, const_rows(prog, x.shape[-1], x.device), None,
                   [x[0], x[1], y[0], y[1]])


def sswu_run_plain(prog: Program, u: torch.Tensor, exc: torch.Tensor
                   ) -> torch.Tensor:
    """K24's program on CPU (or any) tensors: u [2, 32, R], pinned where
    the kernel's prologue puts it, and the flag exc [R] (u ≡ 0) as the
    digit of the SEL's window → (xn, xd, Z·u², v1, v2) [10, 32, R]."""
    return execute(prog, const_rows(prog, u.shape[-1], u.device),
                   exc[None], [u[0], u[1]])


def g1_tables_run_plain(prog: Program, base: torch.Tensor) -> torch.Tensor:
    """K20's program on [3, 32, R] points → [6, 32, R]: 2P then 3P."""
    return execute(prog, list(base))
