#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (charon_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # the full run: 10,000 validators, 7-of-10

Phases, in order; any failure raises and exits non-zero:

1. build   — compile csrc/*.cu with nvcc (one process per source, in
             parallel); print the build seconds, the compiler's register /
             spill report, and the card's name and power limit.
2. kernels — every kernel (K1 fp ops, K2 G2 dbl/add, K3 Straus head/tail
             at the combine's shapes; K4 Miller dbl/add, K5 Fp12
             sqr/mul014/f12mul and K6 G1 dblsel at one verify tile, 4,096
             Miller rows) against its plain PyTorch version ON THE CARD, on
             seeded random and all-LMAX limbs: the results must be
             bit-identical.  Kernel and plain times are CUDA-event medians
             of 5 runs.  K4, the K5 sqr/mul014 steps and K6 run only here
             now: K13 and K15 replaced their launch sequences on the verify
             path.  K3 also on the combine's own digit rows (one row for
             all validators, 164 of 609 digits non-zero): a launch's mean
             time over the combine's 87 heads and 522 tails.  K14 (the
             fold in one cooperative launch) against the plain fold at
             4,096 rows with drop flags, at R = 2 and at 32,768 rows; K15
             (the 32 RLC windows in one launch) against the iterated plain
             K6 window at 4,096 rows with every digit, ∞ rows, all-LMAX
             and real tables; both timed beside the launch sequences they
             replaced, K15 also with 2, 4 and 8 lanes a row.  K16 (the
             combine's whole Straus loop in one launch) against the 609 K3
             launches it replaced, bit for bit, at the combine's shape
             (10,240 accumulator rows, T = 7, 87 windows) on the combine's
             own digits and on random digits, tables with ∞ rows built by
             K2, and against the plain loop (one run) on the combine's
             digits; K17 (one [|x|]-multiply in one launch) against its
             plain version and the 34 K2/K10 launches it replaced at a hash
             batch's 4,096 rows and the slot-start batch's 128; both timed
             beside their bounds, with 2, 4 and 8 lanes a row.  K18 (a
             hash batch's Fp2 root, and its inversion-and-affine step, one
             launch each) against its plain programs bit for bit and
             against the K7 launch sequences it replaced by value at the
             slot-start batch's 256 / 128 rows and a 2,048-message
             batch's 8,192 / 4,096, with zero rows, rows of the α = −1
             branch and squares, timed beside them and the bound of the
             function (`chain_ops`), the sweep over lanes, slots and
             window widths; K19 (the G2
             normalisation in one launch) against its plain version and
             the K1 chain of codec.g2_normalize, bit for bit, at the
             combine's 10,240 rows and a batch's 64 and 2,048, with ∞ rows
             and Z ≠ 1; K20 (the RLC tables in one launch) against its
             plain program bit for bit and the K1 chain by value at a
             verify tile's 4,096 rows, ∞ and −g1 rows among them.  K22
             (K2's launch sequences, one launch each: the combine's
             tables, and a hash batch's halves' sum with its double and
             the clearing's five additions) against its plain programs
             and the K2 sequences, bit for bit, at the combine's 71,680
             rows and the batches' 64 and 2,048, with ∞ and all-LMAX
             rows (the hash batch's first program with ψ(R) and ψ²(2R),
             against K2 and two K9 ψ launches); the sweep over lanes;
             K2's own times at 64 and 2,048 rows.  K23 (the map's tail:
             x's select, the sign fix, the isogeny and its ∞ guard in one
             launch) against its plain version and the K9 iso3 launch
             with the K1 negation and exact boundary it replaced, bit for
             bit, at the batches' 128 and 4,096 u rows with an isogeny-∞
             row; the sweep over 4, 8 and 16 lanes.  K24 (SSWU with its
             exceptional flag and sgn0(u) from u alone, one launch)
             against its plain version bit for bit, and against K8 given
             the host's flags (the JAX packing's formula), at the batches'
             128 and 4,096 u rows with u = 0, c0 = 0 and c1 = 0 rows and
             all-LMAX limbs; the sweep over 2, 4, 8 and 16 lanes and the
             slots.  K18's root with the
             exact tests and select of its epilogue (rows v = 0, −1 of
             the α = −1 branch, the non-square 9 + 16u and a square), K15
             with y negated in its program, K11 with its verdict "= 1"
             (rows that are one and rows that are not): each against its
             plain version, bit for bit.
3. combine — a pool of 1,024 distinct signatures s·H(m) built on the card;
             a real-Shamir check (V = 128: the combined bytes must equal
             sk·H(m)); then 10,000 SigAgg.aggregate() calls in one event-loop
             tick (T = 7, share indices 1..7) that must coalesce into ONE
             combine, 4 random rows checked against the pure-Python oracle;
             malformed and off-curve signatures must raise ValueError; the
             p50 of 3 full combines split into stages, with every kernel's
             launch count on the combine path (each must be > 0; K1, K2
             and K3 must not launch), ONE K12 launch in its decompress
             stage, ONE K22 launch in its tables stage, ONE K16 launch in
             its Straus stage and ONE K19 launch in its normalise
             stage.
   redesign — K11 (the final exponentiation in one launch, a warp per
             row) against its plain version at 1 row and at a verify
             tile's 2,048, and K12 (the G2 decompression in one launch, a
             thread per row) at 2,048 rows and at the combine's 71,680, on
             the pool's signatures with ∞ rows, x off the curve and points
             outside G2 mixed in: bit-identical, every ok flag as its row's
             kind wants; both timed beside their bounds.  K13 (the whole
             Miller loop in one launch, 8 threads a row) against
             miller_loop_plain at a verify tile's 4,096 rows on random,
             all-LMAX and real pairs with ∞ rows, bit for bit, timed beside
             the 198-launch K4/K5 sequence it replaced and its bound; the
             probe behind its design (pp_mul014 from 132 to 8,192 rows,
             the loop one thread per row, K13 at other row counts and with
             4 and 16 lanes a row).
4. verify  — 10,000 keys and 64 messages (one per committee); pk = sk·G1
             and sig = sk·H(m) computed on the card, 3 rows checked against
             the oracle.  The G1 decompress of the 10,000 keys alone on the
             idle card (ONE K21 launch); a cold BatchVerifier.verify_many
             of the 10,000 entries (one peer's parsigex message) fills the
             pubkey LRU (its decompress, one K21 launch a tile and no K1,
             overlaps earlier tiles); then K21 against its plain version
             and the K1 chain of codec.g1_decompress at 2,048 and 10,000
             of those keys with ∞, off-curve and off-subgroup rows mixed
             in; then 3 timed reps,
             each ONE pipeline launch of 5 tiles (4 × 2,048 + 1,808), all
             verdicts True, stages summed over the tiles, K13, K14, K15
             and K20 launched and no K4/K5 step or K6 window, one K12
             launch per tile in sig_decompress_s, one K20 and nothing else
             in rlc_tables_s, one K15 (its −Y inside)
             in rlc_scalar_mul_s, one K13 in miller_s, one K14 in fold_s
             and one K11 (its verdict inside) in final_exp_s, K5 F12MUL
             only in a re-check, no K1 launch in the warm or the cold
             flush; then
             a 2,048-entry batch with 6 bad entries whose verdicts must
             equal the pure-Python oracle on the bad rows and on 4 random
             good ones (its re-check one K1 negation of the unscaled
             p-side, one K13 launch over the unscaled rows, one K5 product
             of the halves and one K11 over the entries).  Then the slot's first flush: the same 10,000
             keys over 64 messages that are new each rep (the next slot's
             attestation data), signed on the card, so the first tile
             misses every message and hashes them on the card as one batch
             of 64 on the prep thread (2 K17 launches, no K10): all
             verdicts True, p50 of 3 with its h2c stages.
5. h2c     — the distinct flush's first 2,048 messages (one verify tile)
             through the device hash-to-G2 (cuda_h2c.hash_to_g2_rows)
             must equal the same pipeline on the plain versions on the
             card in every row; its normalised points must equal the
             pure-Python hash_to_g2 on 32 sampled messages, and a batch of
             the five RFC 9380 J.10.1 messages under the QUUX DST the same;
             the batch timed alone on the idle card (h2c_s by CUDA events,
             median of 3) with its launches; card batches of 1 and 7
             messages timed against one host hash_to_g2 (the crossover of
             the backend's size rule).
6. distinct — 10,000 entries with one distinct message per validator
             (a selection-proof-like flush), signed on the card over H(m)
             from the device pipeline, whose first 2,048 rows must equal
             phase 5's plain pipeline; the pubkey LRU warm, the message LRU
             cleared before each of 3 reps of one verify_many: all verdicts
             True, every tile's misses hashed on the card under h2c_s, the
             stage launches adding up, K11 and K12 as in phase 4; then a
             2,048-entry batch with 4 entries carrying another entry's
             message, rejected exactly, agreeing with the pure-Python
             oracle, its re-check as in phase 4.

7. resident — the verify path's resident route (device stores of
             decompressed pubkeys and hashed messages, a verify tile as one
             CUDA graph replay) on a fresh CUDABackend(resident=True), the
             phases before it having run on the bytes route: prewarm through
             the dispatch pipeline's prewarm thread with the pool's 10,000
             pubshares at V = 10,000, T = 7 (its report, the stores' bytes;
             the 2,048 bucket's graph captured, every key in the store);
             a cold-after-prewarm flush (the 64 messages in the store
             beforehand, as the bytes route's cold flush finds them in its
             LRU) with no key miss and no K21 launch; REPS warm and
             slot-start (one device hash batch) flushes, one cold flush (the
             pubkey store emptied; one K21 a tile), REPS distinct flushes
             (the message store emptied each rep; a hash batch a tile), each
             with every verdict True, K12, K20, K15, K13, K14 and K11
             counted once a graph replay in graph_s, nothing else launching
             outside the miss stages, and one device-to-host copy a tile on
             the launch thread (the verdict and `live`); sampled
             message-store rows equal to the oracle's H(m); a reject tile
             whose 6 bad rows are rejected exactly (re-check from the
             graph's buffers); a backend with 2,048-row stores over two
             10,000-entry flushes (evictions, every verdict True); then
             every flush kind's p50 wall on both routes side by side.

Phase 2 also holds the h2c kernels (K7 sqr/mul/sqr4/sqr4mul at 8,192 rows,
K8 sswu and K9 iso3 at 4,096, K9 psi and K10 dblsel/addsel at 2,048: one
2,048-message batch's shapes) against their plain versions.  Every device
hash batch (phases 4–6) must launch 1 K24 and no K8, 2 K18, no K7, one K23
and no K9, 2 K17, no K10 dblsel, 2 K22 and no K2, one K19 and no K1: 9
launches.  Phase 5 also times `pack_messages` alone at 10,000 messages.
No flush (warm, cold, slot-start, distinct) and no combine launches K1
or K9; K1 and K9 run in phase 2 as references.

A kernel's `launches` in the JSON line is its count over the main-path
runs: `launches_combine` (one combine rep), `launches_verify` (one
10,000-entry verify rep, warm caches), `launches_verify_cold` (the
flush that fills the pubkey LRU), `launches_verify_slot_start` (one
rep of the slot's first flush) and `launches_verify_distinct` (one rep of
the distinct-message flush) and `launches_resident` (the first run of
each resident flush kind: cold after prewarm, warm, slot-start, distinct,
cold; a replay counts its graph's captured launches), each counted from
zero. K10 addsel has no
caller on any path (nor in the JAX package): only phase 2 launches it, as
it does K3, K4, the K5 sqr/mul014 steps, K6 and K10 dblsel now. K11's ms,
plain_ms and bound_ms are at the batch check's 1 row (its `recheck` key at
2,048), K12's at a verify tile's 2,048 (its `combine` key at 71,680),
K13's at a verify tile's 4,096 Miller rows (`steps_ms` the K4/K5
sequence's, `probe` the design probe), K14's and K15's at 4,096 rows
(`steps_ms` the 12 K5 and 32 K6 launches they replaced; K14's `at_2` and
`at_32768`, its `chain_ms` = log₂ 4,096 × its time at R = 2; K15's
`lanes_ms` sweep), K16's on the combine's digits at its shape (`steps_ms`
the 609 K3 launches, `random` the same on random digits, `repack_ms` the
table repack, `lanes_ms`), K17's at 4,096 rows (`steps_ms` the 34 K2/K10
launches, `at_128`, `lanes_ms`), K18's the root's at a 2,048-message
batch's 8,192 rows (`plain_ms` its plain program at the slot-start
batch's 256; `programs` each program's times at both batches beside the
K7 sequences', `steps_ms`, and the sweep), K19's at the combine's 10,240
rows (`steps_ms` the K1 chain; `at_64`, `at_2048`), K20's at 4,096
(`steps_ms` the K1 chain), K21's at a verify tile's 2,048 keys
(`steps_ms` the K1 chain; `at_10000`), K22's the tables at the combine's
71,680 rows (`steps_ms` the K2 sequence, `sweep`; `programs` the hash
batch's two at 64 and 2,048 messages; `k2_at_batches` K2's own times
there), K23's at a 2,048-message batch's 4,096 u rows (`steps_ms` the K9
iso3 launch and the glue it replaced, `iso3_ms` K9 iso3 alone, `sweep`;
`at_128`), K24's at 4,096 u rows (`k8_ms` K8 given the host's flags,
`sweep`; `at_128`), K15's and K11's with −Y and the verdict (K15's
`plain_y_ms` without), and K3's `combine_digits` the mean over the combine's own
launches. `regs`, `stack` and `spill` are the compiler's
(-Xptxas -v) for each kernel's function. Every bound_ms is at the card's
full rate; K11 also gives `bound_one_warp_ms`, the bound at the rate of
the SMs its rows can occupy under its one-warp-per-row design (one SM at 1
row).
The second-to-last line is the `kernels` JSON object; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import random
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# Int32 peaks per SM per clock on compute capability 9.0: IMAD issues only
# on the FMA pipe at 64 lanes (CUDA C++ Programming Guide, "Throughput of
# Native Arithmetic Instructions"; Nsight Compute's pipe list puts IMAD on
# the FMA pipe, the logic, shift and add ops on the ALU pipe), and the four
# schedulers issue at most one warp instruction each per clock, 128 lanes
# in all, whichever pipe takes the rest.
IMAD_LANES_PER_SM = 64
ISSUE_LANES_PER_SM = 128

# The combine the script drives: the north star's 10,000 validators, T = 7
# partials each (a 7-of-10 cluster), p50 over REPS full combines.  The
# verify: one peer's parsigex message at the same node — one partial per
# validator — over MESSAGES attestation messages (one per committee).
VALIDATORS, SHARES, REPS = 10_000, 7, 3
MESSAGES = 64
# The device hash-to-G2 checks: messages sampled against the pure-Python
# oracle, and the RFC 9380 J.10.1 suite's messages and DST.
H2C_ORACLE_SAMPLES = 32
J101_DST = b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"
J101_MSGS = [b"", b"abc", b"abcdef0123456789", b"q128_" + b"q" * 128,
             b"a512_" + b"a" * 512]


#: p50 flush walls by route and flush kind, printed side by side at the end
WALLS: dict[str, dict[str, float]] = {"bytes": {}, "resident": {}}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Int32 instructions per row, [IMAD, ALU], from the loops of
# csrc/fp381.cuh: a product or fold term is one IMAD; a partial-carry
# column is three ALU instructions (and, add, shift); a column sum of up to
# three terms is one three-input add.  The bound of a launch is the larger
# of its IMADs over the FMA pipe's rate, all its instructions over the
# issue rate, and its bytes over the memory rate.
# ---------------------------------------------------------------------------

NL = 32


def _imad(n):
    return np.array([n, 0])


def _alu(n):
    return np.array([0, n])


def _cr(w):
    return _alu(3 * w)


def _fold(w):
    return _imad((w - NL) * NL)


def _red(w, iters):
    return (_cr(w) + _cr(w + 1) + _fold(w + 2)
            + iters * (_cr(NL) + _cr(NL + 1) + _fold(NL + 2)))


OPS = {}
OPS["fp_mul"] = _imad(NL * NL) + _red(2 * NL - 1, 5)
OPS["fp_add"] = _alu(NL) + _red(NL, 1)
OPS["fp_sub"] = _alu(NL) + _red(NL + 1, 1)
OPS["fp_neg"] = _alu(NL) + _red(NL + 1, 1)
OPS["fp_mul_small"] = _imad(NL) + _red(NL, 2)
_CONV_PC2 = _imad(NL * NL) + _cr(2 * NL - 1) + _cr(2 * NL)
# t2 − t0 − t1 + OFF2 (two adds) and t0 − t1 + OFF1 (one) per column
_F2MUL = (3 * _CONV_PC2 + 2 * OPS["fp_add"] + _alu(3 * (2 * NL + 1))
          + 2 * _red(2 * NL + 2, 6))
_F2SQR = (OPS["fp_add"] + OPS["fp_sub"] + _CONV_PC2 + _alu(2 * NL + 1)
          + _red(2 * NL + 1, 5) + OPS["fp_mul"])
_F2ADD, _F2SUB = 2 * OPS["fp_add"], 2 * OPS["fp_sub"]
_F2SMALL = 2 * OPS["fp_mul_small"]
_B3 = OPS["fp_sub"] + OPS["fp_add"] + 2 * OPS["fp_mul_small"]
OPS["g2_dbl"] = (2 * _F2SQR + 6 * _F2MUL + _B3 + 3 * _F2SMALL + 2 * _F2ADD
                 + _F2SUB)
OPS["g2_add"] = 12 * _F2MUL + 12 * _F2ADD + 5 * _F2SUB + _F2SMALL + 2 * _B3
# the pairing kernels (csrc/fp381.cuh tower and G1 law, csrc/pairing.cu)
_XI = OPS["fp_sub"] + OPS["fp_add"]
_F6ADD, _F6SUB = 3 * _F2ADD, 3 * _F2SUB
_F6MUL = 6 * _F2MUL + 12 * _F2ADD + 3 * _F2SUB + 2 * _XI
_F6MUL01 = 5 * _F2MUL + 7 * _F2ADD + 3 * _F2SUB + _XI
OPS["pp_sqr"] = (2 * _F6MUL + 2 * _F6ADD + 2 * _XI + 2 * _F6SUB
                 + 3 * _F2SMALL)
OPS["pp_f12mul"] = 3 * _F6MUL + 4 * _F6ADD + _F6SUB + _XI
OPS["pp_mul014"] = (6 * OPS["fp_mul"] + 2 * _F6MUL01 + 3 * _F6ADD + _F2ADD
                    + 3 * _F2MUL + 2 * _XI + _F6SUB)
OPS["pp_dbl"] = 4 * _F2SQR + 11 * _F2MUL + 8 * _F2SMALL + 4 * _F2SUB
OPS["pp_add"] = (2 * _F2SQR + 11 * _F2MUL + 6 * _F2SUB + _F2ADD
                 + _F2SMALL)
OPS["g1_dbl"] = (8 * OPS["fp_mul"] + 4 * OPS["fp_mul_small"]
                 + 2 * OPS["fp_add"] + OPS["fp_sub"])
OPS["g1_add"] = (12 * OPS["fp_mul"] + 12 * OPS["fp_add"] + 5 * OPS["fp_sub"]
                 + 3 * OPS["fp_mul_small"])
# the hash-to-G2 kernels (csrc/h2c.cu) and K10 (csrc/g2.cu)
OPS["h2c_sqr"] = _F2SQR
OPS["h2c_mul"] = _F2MUL
OPS["h2c_sqr4"] = 4 * _F2SQR
OPS["h2c_sqr4mul"] = 4 * _F2SQR + _F2MUL
# 10 products, 4 squares, 4 sums on every row; a row whose flag is clear
# adds the product −A'·tv1 (counted where the rows are known)
OPS["h2c_sswu"] = 10 * _F2MUL + 4 * _F2SQR + 4 * _F2ADD
OPS["h2c_iso3"] = 13 * _F2MUL + 11 * _F2ADD
OPS["h2c_psi"] = 2 * _F2MUL + 3 * OPS["fp_neg"]
EL_BYTES = NL * 4
PT_BYTES = 6 * EL_BYTES
# the exact boundary of csrc/fp381.cuh: canon is the exact carry (3 ALU a
# limb), 47 comparisons with the multiples of p (~3 digits of ~4
# instructions each before they differ) and the borrow subtraction (5 a
# limb); is_zero ORs the 32 canonical limbs
_CANON = _alu(3 * NL + 47 * 12 + 5 * NL)
_ISZERO = _CANON + _alu(NL)
_F2EQ = _F2SUB + 2 * _ISZERO
# K23 (csrc/h2c_map.cu): the isogeny, sgn0(y)'s two canonicalisations and
# Z's two zero tests on every row; a flipped row adds y's negation
OPS["h2c_map_tail"] = OPS["h2c_iso3"] + 2 * _CANON + 2 * _ISZERO
# K24 (csrc/h2c_sswu.cu): K8's function and the prologue's two
# canonicalisations (the flag and sgn0(u)) on every row; a row whose flag
# is clear adds the product −A'·tv1 (counted where the rows are known)
OPS["h2c_sswu_head"] = OPS["h2c_sswu"] + 2 * _CANON


def _pow_ops(e: int, sqr, mul):
    """A fixed-exponent pow, LSB first: a squaring per bit but the last,
    a product per set bit."""
    return (e.bit_length() - 1) * sqr + bin(e).count("1") * mul


def final_exp_ops() -> np.ndarray:
    """[IMAD, ALU] of one K11 row (csrc/final_exp.cu): five ^z chains of
    63 squarings and popcount(|z|) − 1 products, one more squaring and
    nine products around them, 5 Frobenius maps, 9 conjugations and the
    inverse (its Fp inverse the pow p − 2).  Each ^z squaring is counted
    as the full K5 squaring the kernel runs: the argument is cyclotomic
    there, and a Granger–Scott squaring would need fewer products."""
    from charon_tpu_torch.ops import cuda_codec
    from charon_tpu_torch.tbls.ref.fields import P

    zbits = cuda_codec.ABS_Z.bit_length() - 1
    zmuls = bin(cuda_codec.ABS_Z).count("1") - 1
    f2_inv = (4 * OPS["fp_mul"] + OPS["fp_add"] + OPS["fp_neg"]
              + _pow_ops(P - 2, OPS["fp_mul"], OPS["fp_mul"]))
    f6_inv = 12 * _F2MUL + 3 * _XI + 3 * _F2SUB + 2 * _F2ADD + f2_inv
    f12_inv = 4 * _F6MUL + _XI + _F6SUB + f6_inv + 6 * OPS["fp_neg"]
    conj = 6 * OPS["fp_neg"]
    frob = 6 * OPS["fp_neg"] + 7 * _F2MUL
    return ((5 * zbits + 1) * OPS["pp_sqr"] + (5 * zmuls + 9)
            * OPS["pp_f12mul"] + 5 * frob + 9 * conj + f12_inv)


def decompress_ops(n_valid: int, n_inf: int, n_off_curve: int,
                   n_off_group: int) -> np.ndarray:
    """[IMAD, ALU] of one K12 launch over rows of four kinds
    (csrc/decompress.cu): every row computes x³ + b', both pows, the root,
    its check and sign; a row whose root checks (valid, off the subgroup)
    or that is ∞ runs the ψ check, whose equality multiplies only for two
    finite points and stops at a differing x (off the subgroup)."""
    from charon_tpu_torch.ops import cuda_codec

    n = n_valid + n_inf + n_off_curve + n_off_group
    every = (_F2SQR + _F2MUL + _F2ADD
             + _pow_ops(cuda_codec.EXP_P34, _F2SQR, _F2MUL)
             + _F2SQR + 2 * _F2MUL + _F2ADD
             + _pow_ops(cuda_codec.EXP_P12, _F2SQR, _F2MUL) + _F2MUL
             + _F2EQ + _F2SQR + _F2EQ + 2 * _CANON)
    adds = sum(1 for w in cuda_codec.Z_WINDOWS[1:] if w)
    chain = ((1 + 2 * (len(cuda_codec.Z_WINDOWS) - 1)) * OPS["g2_dbl"]
             + (1 + adds) * OPS["g2_add"] + 2 * _F2MUL
             + 5 * OPS["fp_neg"] + 4 * _ISZERO)
    return (n * every + (n_valid + n_inf + n_off_group) * chain
            + n_valid * (4 * _F2MUL + 2 * _F2EQ)
            + n_off_group * (2 * _F2MUL + _F2EQ))


def straus_work(digits: np.ndarray, head: bool) -> tuple[np.ndarray, int]:
    """([IMAD, ALU] instructions, bytes) one K3 launch needs for this digit
    row: a zero digit skips the addition and the table read, a negative
    one adds two negations."""
    n = digits.size
    nz = int((digits != 0).sum())
    ng = int((digits < 0).sum())
    ops = (3 * OPS["g2_dbl"] * n if head else 0) + nz * OPS["g2_add"] \
        + ng * 2 * OPS["fp_neg"]
    return ops, n * (2 * PT_BYTES + 4) + nz * PT_BYTES


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 5) -> float:
    """Median of `reps` CUDA-event timings of fn() (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def limbs(dev, gen, shape, pattern):
    """Seeded random limbs in [0, LMAX], or all LMAX."""
    from charon_tpu_torch.ops import fp

    if pattern == "lmax":
        return torch.full(shape, fp.LMAX, dtype=torch.int32, device=dev)
    return torch.from_numpy(
        gen.integers(0, fp.LMAX + 1, shape, dtype=np.int32)).to(dev)


def bound(ops: np.ndarray, nbytes: float, sm_clocks_per_s: float
          ) -> tuple[float, str]:
    """(least ms, what bounds it): IMADs over the FMA pipe, all int32
    instructions over the schedulers' rate, or bytes over the memory
    rate."""
    imad, alu = (float(x) for x in ops)
    t_ops = max(imad / IMAD_LANES_PER_SM,
                (imad + alu) / ISSUE_LANES_PER_SM) / sm_clocks_per_s
    t_mem = nbytes / MEM_BYTES_PER_S
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


def record(results: dict, name, kernel_fn, plain_fn, ops, nbytes, patterns,
           sm_clocks_per_s: float, plain_reps: int = 5) -> None:
    """Hold the kernel against its plain version on every input pattern
    (bit for bit), then time both on the first pattern (the kernel over 5
    runs, the plain version over `plain_reps`)."""
    err = 0
    for pat in patterns:
        args = pat()
        got, want = kernel_fn(*args), plain_fn(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if [g.shape for g in got] != [w.shape for w in want]:
            raise AssertionError(
                f"{name}: shapes {[tuple(g.shape) for g in got]} != "
                f"{[tuple(w.shape) for w in want]}")
        diff = max(int((g.long() - w.long()).abs().max())
                   for g, w in zip(got, want))
        if diff:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {diff})")
        err = max(err, diff)
    args = patterns[0]()
    ms = time_ms(lambda: kernel_fn(*args))
    plain_ms = time_ms(lambda: plain_fn(*args), plain_reps)
    bms, by = bound(ops, nbytes, sm_clocks_per_s)
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by}
    log(f"kernel {name}: bit-identical on {len(patterns)} inputs; {ms:.4f} "
        f"ms (plain {plain_ms:.4f} ms, bound {bms:.4f} ms by {by})")


def kernels_phase(dev, rows: int, vrows: int, sm_clocks_per_s: float) -> dict:
    from charon_tpu_torch.ops import cuda_fp, cuda_g2, fp

    gen = np.random.default_rng(20261016)
    results = {}

    def rec(name, kernel_fn, plain_fn, ops, nbytes, patterns):
        record(results, name, kernel_fn, plain_fn, ops, nbytes, patterns,
               sm_clocks_per_s)

    def lim(shape, pattern):
        return limbs(dev, gen, shape, pattern)

    # K1 on [2, 32, rows] = 2·rows Fp rows
    fshape = (2, NL, rows)
    nfp = 2 * rows
    for name, k_fn, p_fn, n_in in (
            ("fp_mul", cuda_fp.mul, fp.mul_plain, 2),
            ("fp_add", cuda_fp.add, fp.add_plain, 2),
            ("fp_sub", cuda_fp.sub, fp.sub_plain, 2),
            ("fp_neg", cuda_fp.neg, fp.neg_plain, 1)):
        pats = [lambda n_in=n_in, p=p: tuple(lim(fshape, p)
                                             for _ in range(n_in))
                for p in ("random", "lmax")]
        rec(name, k_fn, p_fn, OPS[name] * nfp, (n_in + 1) * 128 * nfp, pats)
    pats = [lambda p=p: (lim(fshape, p), 12) for p in ("random", "lmax")]
    rec("fp_mul_small", cuda_fp.mul_small, fp.mul_small_plain,
        OPS["fp_mul_small"] * nfp, 2 * 128 * nfp, pats)

    # K2 on [6, 32, rows]
    pshape = (6, NL, rows)
    pats = [lambda p=p: (lim(pshape, p),) for p in ("random", "lmax")]
    rec("g2_dbl", cuda_g2.dbl, cuda_g2.dbl_plain, OPS["g2_dbl"] * rows,
        2 * PT_BYTES * rows, pats)
    pats = [lambda p=p: (lim(pshape, p), lim(pshape, p))
            for p in ("random", "lmax")]
    rec("g2_add", cuda_g2.add, cuda_g2.add_plain, OPS["g2_add"] * rows,
        3 * PT_BYTES * rows, pats)

    # K3: acc [6, 32, vrows], four tables [6, 32, rows], digits [rows] in
    # [-4, 3], rows [row0, row0 + vrows)
    digits = torch.from_numpy(
        gen.integers(-4, 4, rows, dtype=np.int32)).to(dev)
    d_np = digits.cpu().numpy()
    for name, head, row0 in (("straus_head", True, 0),
                             ("straus_tail", False, vrows)):
        def pat(p, head=head, row0=row0):
            tabs = tuple(lim(pshape, p) for _ in range(4))
            return (lim((6, NL, vrows), p), tabs, row0, digits, head)
        ops, nbytes = straus_work(d_np[row0:row0 + vrows], head)
        rec(name, cuda_g2.straus_step, cuda_g2.straus_step_plain, ops,
            nbytes, [lambda p=p: pat(p) for p in ("random", "lmax")])
    straus_combine_digits(dev, gen, rows, vrows, results, sm_clocks_per_s)
    return results


def straus_combine_digits(dev, gen, rows: int, vrows: int, results: dict,
                          sm_clocks_per_s: float) -> None:
    """K3 head and tail on the digit rows the combine really gives them:
    every validator shares the index set 1..SHARES, so each (window,
    share) digit is one value for all VALIDATORS rows (the padding rows
    zero), and a zero digit skips the addition.  One head and one tail
    launch held against the plain version on a window with non-zero
    digits; then the mean launch time over the combine's 87 heads and
    522 tails (as straus_steps runs them, on seeded tables), beside the
    mean bound for those digits."""
    from charon_tpu_torch.ops import cuda_g2
    from charon_tpu_torch.tbls.backend_cuda import (STRAUS_NWIN,
                                                    _lagrange_digits)

    lag = _lagrange_digits(tuple(range(1, SHARES + 1)))     # [T, 87]
    digits = np.zeros((SHARES, vrows, STRAUS_NWIN), np.int32)
    digits[:, :VALIDATORS] = lag[:, None, :]
    d_np = np.ascontiguousarray(digits.reshape(rows, STRAUS_NWIN).T)
    drows = torch.from_numpy(d_np).to(dev)
    tabs = tuple(limbs(dev, gen, (6, NL, rows), "random") for _ in range(4))
    acc = limbs(dev, gen, (6, NL, vrows), "random")
    win = int((lag != 0).sum(0).argmax())
    nonzero = int((lag != 0).sum())
    for name, head, row0 in (("straus_head", True, 0),
                             ("straus_tail", False, vrows)):
        args = (acc, tabs, row0, drows[win], head)
        got = cuda_g2.straus_step(*args)
        want = cuda_g2.straus_step_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} on the combine's digits differs "
                                 f"from its plain version")
        launches = [(i, k * vrows) for i in range(STRAUS_NWIN)
                    for k in ((0,) if head else range(1, SHARES))]

        def run(launches=launches, head=head):
            for i, r0 in launches:
                cuda_g2.straus_step(acc, tabs, r0, drows[i], head)

        ms = time_ms(run, 3) / len(launches)
        ops = sum(straus_work(d_np[i, r0:r0 + vrows], head)[0]
                  for i, r0 in launches)
        nbytes = sum(straus_work(d_np[i, r0:r0 + vrows], head)[1]
                     for i, r0 in launches)
        bms, by = bound(ops, nbytes, sm_clocks_per_s)
        results[name]["combine_digits"] = {
            "launches": len(launches), "ms": ms,
            "bound_ms": bms / len(launches), "bound_by": by,
            "nonzero_digits": nonzero, "digits": SHARES * STRAUS_NWIN}
        log(f"kernel {name} on the combine's digits ({nonzero} of "
            f"{SHARES * STRAUS_NWIN} non-zero, one row for all validators): "
            f"bit-identical; {ms:.4f} ms a launch, mean of "
            f"{len(launches)} (bound {bms / len(launches):.4f} ms by {by})")


def pairing_kernels_phase(dev, rows: int, sm_clocks_per_s: float) -> dict:
    """K4–K6 against their plain versions at `rows` Miller rows (one
    verify tile), on seeded random and all-LMAX limbs; F12MUL also on the
    fold's operands, the two row halves of one tensor.  K14 (the fold in
    one launch) and K15 (the RLC scaling in one launch) against the plain
    fold and the iterated plain K6 window (`fold_phase`, `rlc_phase`)."""
    from charon_tpu_torch.ops import cuda_pairing as cp

    gen = np.random.default_rng(20261017)
    results = {}

    def rec(name, kernel_fn, plain_fn, ops, nbytes, patterns):
        record(results, name, kernel_fn, plain_fn, ops, nbytes, patterns,
               sm_clocks_per_s)

    def lim(planes, pattern, n=rows):
        return limbs(dev, gen, (planes, NL, n), pattern)

    pats = ("random", "lmax")
    rec("pp_dbl", cp.pp_dbl, cp.pp_dbl_plain, OPS["pp_dbl"] * rows,
        (6 + 12) * EL_BYTES * rows, [lambda p=p: (lim(6, p),) for p in pats])
    rec("pp_add", cp.pp_add, cp.pp_add_plain, OPS["pp_add"] * rows,
        (6 + 4 + 12) * EL_BYTES * rows,
        [lambda p=p: (lim(6, p), lim(4, p)) for p in pats])
    rec("pp_sqr", cp.pp_sqr, cp.pp_sqr_plain, OPS["pp_sqr"] * rows,
        (12 + 12) * EL_BYTES * rows,
        [lambda p=p: (lim(12, p),) for p in pats])
    rec("pp_mul014", cp.pp_mul014, cp.pp_mul014_plain,
        OPS["pp_mul014"] * rows, (12 + 6 + 3 + 12) * EL_BYTES * rows,
        [lambda p=p: (lim(12, p), lim(6, p), lim(3, p)) for p in pats])

    def halves():
        f = lim(12, "random", 2 * rows)
        return f[..., :rows], f[..., rows:]

    rec("pp_f12mul", cp.pp_f12mul, cp.pp_f12mul_plain,
        OPS["pp_f12mul"] * rows, (12 + 12 + 12) * EL_BYTES * rows,
        [lambda p=p: (lim(12, p), lim(12, p)) for p in pats] + [halves])
    w = torch.from_numpy(gen.integers(0, 4, rows, dtype=np.int32)).to(dev)
    nz = int((w != 0).sum())
    rec("g1_dblsel", cp.g1_dblsel, cp.g1_dblsel_plain,
        OPS["g1_dbl"] * 2 * rows + OPS["g1_add"] * nz,
        rows * (6 * EL_BYTES + 4) + nz * 3 * EL_BYTES,
        [lambda p=p: (lim(3, p), lim(3, p), lim(3, p), lim(3, p), w)
         for p in pats])
    results["f12_fold"] = fold_phase(dev, gen, rows, sm_clocks_per_s)
    results["g1_scalar_mul"] = rlc_phase(dev, gen, rows, sm_clocks_per_s)
    return results


def fold_phase(dev, gen, rows: int, sm_clocks_per_s: float) -> dict:
    """K14 against `fold_product_plain(mask_rows(f, drop))`, bit for bit:
    at `rows` on random limbs with a quarter of the rows dropped, all-LMAX
    limbs with drops and random limbs with none; at R = 2 (one warp
    product: the chain's unit) and at 32,768 rows (past one wave of
    warps).  Timed beside the log₂ R K5 launches it replaced
    (`fold_steps`), its bound and the plain version."""
    from charon_tpu_torch.ops import cuda_pairing as cp

    def plain(f, drop):
        return cp.fold_product_plain(cp.mask_rows(f, drop))

    def pat(pattern, n, drops=True):
        f = limbs(dev, gen, (12, NL, n), pattern)
        d = torch.from_numpy(gen.random(n) < (0.25 if drops else 0)).to(dev)
        return f, d

    def work(n):
        return OPS["pp_f12mul"] * (n - 1), (12 * EL_BYTES + 1) * n \
            + 12 * EL_BYTES

    out = {}
    record(out, "f12_fold", cp.fold_product, plain, *work(rows),
           [lambda: pat("random", rows), lambda: pat("lmax", rows),
            lambda: pat("random", rows, drops=False)], sm_clocks_per_s,
           plain_reps=1)
    res = out["f12_fold"]
    f, d = pat("random", rows)
    masked = cp.mask_rows(f, d)
    if not torch.equal(cp.fold_steps(masked), cp.fold_product(f, d)):
        raise AssertionError("K14 differs from the K5 launch sequence")
    res["steps_ms"] = time_ms(lambda: cp.fold_steps(masked))
    res["rows"] = rows
    for n in (2, 32_768):
        part = {}
        record(part, "f12_fold", cp.fold_product, plain, *work(n),
               [lambda n=n: pat("random", n), lambda n=n: pat("lmax", n)],
               sm_clocks_per_s, plain_reps=1)
        res[f"at_{n}"] = part["f12_fold"]
    levels = rows.bit_length() - 1
    res["chain_ms"] = levels * res["at_2"]["ms"]
    log(f"K14 f12_fold at {rows:,} rows: {res['ms']:.4f} ms against "
        f"{res['steps_ms']:.4f} ms for the {levels} K5 launches it "
        f"replaced; the chain of {levels} warp products at R = 2's "
        f"{res['at_2']['ms']:.4f} ms each: {res['chain_ms']:.4f} ms; "
        f"{res['at_32768']['ms']:.4f} ms at 32,768 rows")
    return res


def rlc_tables(dev, rows: int, inf_rows: slice) -> tuple:
    """Real RLC tables {P, 2P, 3P} of `rows` G1 points (64 distinct
    multiples of the generator made on the card, repeated), ∞ at
    `inf_rows`, built as verify_device_exec builds them."""
    from charon_tpu_torch.ops import curve as tcurve
    from charon_tpu_torch.tbls.ref import curve as rc

    rng = random.Random(31)
    scalars = [rng.randrange(1, 2**64) for _ in range(64)]
    g1 = torch.from_numpy(tcurve.g1_pack([rc.G1_GEN])).to(dev).expand(
        3, NL, 64).contiguous()
    bits = torch.from_numpy(np.ascontiguousarray(
        tcurve.scalars_to_bits(scalars).T)).to(dev)
    pts = tcurve.scalar_mul(tcurve.FP_OPS, g1, bits)
    base = pts.repeat(1, 1, -(-rows // 64))[..., :rows].contiguous()
    base[..., inf_rows] = torch.from_numpy(tcurve.g1_pack([None])).to(dev)
    p2 = tcurve.double_point(tcurve.FP_OPS, base)
    p3 = tcurve.add_points(tcurve.FP_OPS, p2, base)
    return base, p2.contiguous(), p3.contiguous()


def rlc_phase(dev, gen, rows: int, sm_clocks_per_s: float) -> dict:
    """K15 with y negated in its program (the verify path's Miller
    p-side) against the iterated `g1_dblsel_plain` and `g1_proj_rows` at
    `rows` (a tile's pair rows) over 32 windows with every digit 0–3
    present, bit for bit: on random-limb tables with ∞ rows, on all-LMAX
    tables and on real tables of G1 points with ∞ rows.  Timed beside the
    program without the negation (`plain_y_ms`), the 32 K6 launches it
    replaced (`g1_scalar_mul_steps`), its bound (the additions of these
    digits) and the plain version; the sweep over 2, 4 and 8 lanes a
    row; the time at twice the rows."""
    from charon_tpu_torch.ops import cuda_pairing as cp
    from charon_tpu_torch.ops import miller_program as mp

    nwin = 32
    w = torch.from_numpy(gen.integers(0, 4, (nwin, rows),
                                      dtype=np.int32)).to(dev)
    inf = torch.from_numpy(cp._G1_INF).to(dev).unsqueeze(-1)

    def pat(pattern):
        tabs = [limbs(dev, gen, (3, NL, rows), pattern) for _ in range(3)]
        if pattern == "random":
            for t in tabs:
                t[..., 100:116] = inf
        return (*tabs, w)

    real = rlc_tables(dev, rows, slice(200, 216))
    nz = int((w != 0).sum())
    ops = (OPS["g1_dbl"] * 2 * nwin * rows + OPS["g1_add"] * nz
           + OPS["fp_neg"] * rows)
    nbytes = rows * (9 * EL_BYTES + nwin * 4 + 3 * EL_BYTES)
    out = {}
    # the path's form: y negated in the program (the Miller p-side),
    # against the plain windows and `g1_proj_rows`
    record(out, "g1_scalar_mul",
           lambda *a: cp.g1_scalar_mul_rows(*a, neg_y=True),
           lambda *a: cp.g1_proj_rows(cp.g1_scalar_mul_plain(*a)), ops,
           nbytes, [lambda: pat("random"), lambda: pat("lmax"),
                    lambda: (*real, w)], sm_clocks_per_s, plain_reps=1)
    res = out["g1_scalar_mul"]
    args = (*real, w)
    want = cp.g1_scalar_mul_rows(*args)
    if not torch.equal(cp.g1_scalar_mul_steps(*args), want):
        raise AssertionError("K15 differs from the K6 launch sequence")
    if not torch.equal(cp.g1_proj_rows(want),
                       cp.g1_scalar_mul_rows(*args, neg_y=True)):
        raise AssertionError("K15's −Y differs from g1_proj_rows")
    res["plain_y_ms"] = time_ms(lambda: cp.g1_scalar_mul_rows(*args))
    res["steps_ms"] = time_ms(lambda: cp.g1_scalar_mul_steps(*args))
    res["rows"] = rows
    res["lanes_ms"] = {}
    for cfg in ((2, 16, 40), (4, 20, 40), (8, 20, 40)):
        if not torch.equal(cp.g1_scalar_mul_rows(*args, *cfg), want):
            raise AssertionError(f"K15 with {cfg} differs from the default")
        prog = mp.g1_program(nwin, *cfg)
        res["lanes_ms"][str(cfg)] = {
            "ms": time_ms(lambda cfg=cfg: cp.g1_scalar_mul_rows(*args, *cfg)),
            "steps": prog.steps, "cost": prog.cost()}
    # a tile twice as large (ROADMAP B-1): twice the rows on the same SMs
    big = [limbs(dev, gen, (3, NL, 2 * rows), "random") for _ in range(3)]
    wbig = torch.from_numpy(gen.integers(0, 4, (nwin, 2 * rows),
                                         dtype=np.int32)).to(dev)
    res[f"at_{2 * rows}_ms"] = time_ms(
        lambda: cp.g1_scalar_mul_rows(*big, wbig))
    prog = mp.g1_program(nwin)
    res.update(lanes=mp.G1_LANES, slots=mp.G1_SLOTS, program_steps=prog.steps,
               program_cost=prog.cost())
    log(f"K15 g1_scalar_mul at {rows:,} rows ({mp.G1_LANES} lanes a row, "
        f"{mp.G1_SLOTS} slots, {prog.steps} steps, {prog.cost():,} "
        f"instructions a lane): {res['ms']:.4f} ms with −Y "
        f"({res['plain_y_ms']:.4f} without) against "
        f"{res['steps_ms']:.4f} ms for the {nwin} K6 launches it replaced; "
        f"{res[f'at_{2 * rows}_ms']:.4f} ms at {2 * rows:,} rows; sweep "
        f"{json.dumps(res['lanes_ms'])}")
    return res


def straus_msm_work(d_np: np.ndarray, vrows: int) -> tuple[np.ndarray, int]:
    """([IMAD, ALU], bytes) of the whole Straus loop on these digits
    [nwin, T·vrows]: the per-step work of `straus_work` summed over the
    windows and shares; device memory sees the digits, the table rows of
    the non-zero digits and the output once."""
    ops = sum(straus_work(d_np[i, r0:r0 + vrows], r0 == 0)[0]
              for i in range(d_np.shape[0])
              for r0 in range(0, d_np.shape[1], vrows))
    return ops, 4 * d_np.size + (int((d_np != 0).sum()) + vrows) * PT_BYTES


def straus_msm_phase(dev, rows: int, vrows: int,
                     sm_clocks_per_s: float) -> dict:
    """K16 against the iterated K3 steps (`straus_steps`: the 87 heads and
    87·(T − 1) tails it replaced), bit for bit, at the combine's shape —
    `vrows` accumulator rows, T = SHARES, all 87 windows — on the
    combine's own digits (one index set for every validator, the padding
    rows zero) and on random digits; the tables built by K22 from random
    limbs with ∞ rows, as the combine builds them.  Against the plain loop
    (`straus_msm_plain`, one run: it takes ~43 s on the card) on the
    combine's digits.  Timed beside the K3 sequence and the bound of these
    digits' work; the table repack alone; the sweep over 2, 4 and 8
    lanes."""
    from charon_tpu_torch.ops import cuda_g2
    from charon_tpu_torch.ops import miller_program as mp
    from charon_tpu_torch.tbls.backend_cuda import (STRAUS_NWIN,
                                                    _lagrange_digits)

    gen = np.random.default_rng(20261021)
    pts = limbs(dev, gen, (6, NL, rows), "random")
    inf = torch.arange(3, rows, 997, device=dev)
    pts[..., inf] = cuda_g2.inf_planes(len(inf), dev)
    tables = cuda_g2.straus_tables(pts)
    lag = _lagrange_digits(tuple(range(1, SHARES + 1)))     # [T, 87]
    comb = np.zeros((SHARES, vrows, STRAUS_NWIN), np.int32)
    comb[:, :VALIDATORS] = lag[:, None, :]
    digit_sets = {
        "combine": np.ascontiguousarray(comb.reshape(rows, STRAUS_NWIN).T),
        "random": gen.integers(-4, 4, (STRAUS_NWIN, rows), dtype=np.int32)}
    res, outs = {}, {}
    for label, d_np in digit_sets.items():
        d = torch.from_numpy(d_np).to(dev)
        outs[label] = got = cuda_g2.straus_msm(tables, d, SHARES)
        steps = cuda_g2.straus_steps(tables, d, SHARES)
        torch.cuda.synchronize()
        err = int((got.long() - steps.long()).abs().max())
        if err:
            raise AssertionError(f"K16 on {label} digits differs from the "
                                 f"K3 launch sequence (max abs err {err})")
        ops, nbytes = straus_msm_work(d_np, vrows)
        bms, by = bound(ops, nbytes, sm_clocks_per_s)
        res[label] = {
            "max_abs_err": err,
            "ms": time_ms(lambda d=d: cuda_g2.straus_msm(tables, d, SHARES)),
            "steps_ms": time_ms(
                lambda d=d: cuda_g2.straus_steps(tables, d, SHARES), 3),
            "bound_ms": bms, "bound_by": by,
            "nonzero_digits": int((d_np != 0).sum())}
    comb_d = torch.from_numpy(digit_sets["combine"]).to(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = cuda_g2.straus_msm_plain(tables, comb_d, SHARES)
    end.record()
    torch.cuda.synchronize()
    if not torch.equal(plain, outs["combine"]):
        raise AssertionError("K16 differs from the plain loop")
    out = {**res["combine"], "plain_ms": start.elapsed_time(end),
           "random": res["random"], "rows": vrows, "shares": SHARES,
           "windows": STRAUS_NWIN,
           "repack_ms": time_ms(lambda: cuda_g2.straus_block(tables)),
           "lanes_ms": {}}
    for cfg in ((2, 26, 40), (4, 34, 40), (8, 36, 40)):
        if not torch.equal(cuda_g2.straus_msm(tables, comb_d, SHARES, *cfg),
                           outs["combine"]):
            raise AssertionError(f"K16 with {cfg} differs from the default")
        head, tail = mp.straus_programs(*cfg)
        out["lanes_ms"][str(cfg)] = {
            "ms": time_ms(lambda cfg=cfg: cuda_g2.straus_msm(
                tables, comb_d, SHARES, *cfg)),
            "head_steps": head.steps, "tail_steps": tail.steps,
            "head_cost": head.cost(), "tail_cost": tail.cost()}
    head, tail = mp.straus_programs()
    out.update(lanes=mp.ST_LANES, slots=mp.ST_SLOTS, head_steps=head.steps,
               tail_steps=tail.steps)
    log(f"K16 straus_msm at {vrows:,} rows × {SHARES} shares × "
        f"{STRAUS_NWIN} windows ({mp.ST_LANES} lanes a row, {mp.ST_SLOTS} "
        f"slots; HEAD {head.steps} steps, TAIL {tail.steps}): on the "
        f"combine's digits {out['ms']:.4f} ms against {out['steps_ms']:.4f} "
        f"ms for the K3 launches it replaced (bound {out['bound_ms']:.4f} "
        f"ms; plain loop {out['plain_ms']:.1f} ms, one run); on random "
        f"digits {res['random']['ms']:.4f} ms against "
        f"{res['random']['steps_ms']:.4f} ms (bound "
        f"{res['random']['bound_ms']:.4f}); table repack "
        f"{out['repack_ms']:.4f} ms; sweep {json.dumps(out['lanes_ms'])}")
    return out


def zmul_phase(dev, sm_clocks_per_s: float) -> dict:
    """K17 against `zmul_plain` bit for bit at a 2,048-message hash
    batch's [|x|]P, [|x|]ψ(P) launch (4,096 rows) and at the slot-start
    batch's (128 rows), on random limbs with ∞ rows and all-LMAX limbs,
    and against the 34 K2/K10 launches it replaced (`zmul_steps`); timed
    beside them, its bound and the plain version; the sweep over 2, 4 and
    8 lanes at 4,096 rows."""
    from charon_tpu_torch.ops import cuda_g2, cuda_h2c as ch
    from charon_tpu_torch.ops import miller_program as mp

    gen = np.random.default_rng(20261022)
    row_ops = 65 * OPS["g2_dbl"] + 6 * OPS["g2_add"]
    res = {}
    for n in (4096, 128):
        def pat(pattern, n=n):
            q = limbs(dev, gen, (6, NL, n), pattern)
            if pattern == "random":
                q[..., 5:21] = cuda_g2.inf_planes(16, dev)
            return (q,)

        part = {}
        record(part, "g2_zmul", ch.zmul, ch.zmul_plain, row_ops * n,
               2 * PT_BYTES * n, [lambda: pat("random"), lambda: pat("lmax")],
               sm_clocks_per_s, plain_reps=1)
        q, = pat("random")
        if not torch.equal(ch.zmul_steps(q), ch.zmul(q)):
            raise AssertionError(f"K17 at {n} rows differs from the K2/K10 "
                                 f"launch sequence")
        part["g2_zmul"]["steps_ms"] = time_ms(lambda q=q: ch.zmul_steps(q))
        res[n] = part["g2_zmul"]
    out = {**res[4096], "rows": 4096, "at_128": res[128], "lanes_ms": {}}
    q = limbs(dev, gen, (6, NL, 4096), "random")
    want = ch.zmul(q)
    for cfg in ((2, 30, 40), (4, 36, 80), (8, 38, 20)):
        if not torch.equal(ch.zmul(q, *cfg), want):
            raise AssertionError(f"K17 with {cfg} differs from the default")
        prog = mp.zmul_program(*cfg)
        out["lanes_ms"][str(cfg)] = {
            "ms": time_ms(lambda cfg=cfg: ch.zmul(q, *cfg)),
            "steps": prog.steps, "cost": prog.cost()}
    prog = mp.zmul_program()
    out.update(lanes=mp.ZM_LANES, slots=mp.ZM_SLOTS, program_steps=prog.steps,
               program_cost=prog.cost())
    log(f"K17 g2_zmul ({mp.ZM_LANES} lanes a row, {mp.ZM_SLOTS} slots, "
        f"{prog.steps} steps): at 4,096 rows {out['ms']:.4f} ms against "
        f"{out['steps_ms']:.4f} ms for the 34 K2/K10 launches it replaced "
        f"(bound {out['bound_ms']:.4f} ms); at 128 rows "
        f"{res[128]['ms']:.4f} ms against {res[128]['steps_ms']:.4f} ms "
        f"(bound {res[128]['bound_ms']:.4f}); sweep "
        f"{json.dumps(out['lanes_ms'])}")
    return out


def program_ops(prog) -> np.ndarray:
    """[IMAD, ALU] one row of a scheduled program needs: each live op its
    csrc/fp381.cuh function's count (a LIN by its form: the small multiple
    with two rounds, the spread difference or negation, the sum, the copy;
    a SEL a 32-limb copy)."""
    from charon_tpu_torch.ops import miller_program as mp

    kind, *_, iters, spread, _ = mp._fields(prog.code)
    cost = {mp.MUL2: _F2MUL, mp.SQR2: _F2SQR, mp.MUL: OPS["fp_mul"],
            mp.SEL: _alu(NL)}
    total = np.zeros(2, np.int64)
    for k, it, sp in zip(kind.ravel(), iters.ravel(), spread.ravel()):
        if k == mp.LIN and it == 0:
            total += _alu(NL)                       # the copy form
        elif k == mp.LIN:
            total += OPS["fp_mul_small" if it == 2 else
                         "fp_sub" if sp else "fp_add"]
        elif k != mp.NOP:
            total += cost[int(k)]
    return total


def _pow_w4_ops(e: int, sqr, mul):
    """A fixed-exponent pow by 4-bit windows, MSB first: the table
    a..a^top (one squaring, top − 2 products), then per window 4
    squarings and, for a non-zero digit, one product."""
    digs = [int(d, 16) for d in f"{e:x}"]
    top = max(digs)
    return ((top >= 2) * sqr + max(top - 2, 0) * mul
            + 4 * (len(digs) - 1) * sqr + sum(map(bool, digs[1:])) * mul)


def chain_ops(kind: str, rows: int, alpha_m1: int = 0) -> np.ndarray:
    """[IMAD, ALU] of K18's function `kind` on `rows` rows, not of the
    program it launches: whole MUL2 / SQR2 ops (`_F2MUL`, `_F2SQR`) and
    4-bit windows.  The root (`alpha_m1` of its rows take the α = −1
    branch): a1's pow, α = a1²·v, x0 = a1·v, then u·x0 and its square,
    or (α + 1)'s pow, its product with x0 and its square; the exact tests
    α = −1 and root² = v of the kernel's epilogue.  The inverse:
    the norm a0² + a1², its Fp pow p − 2, ā·norm⁻¹.  The affine step: the
    inverse, xn·xd⁻¹, Z·u²·xn·xd⁻¹ and root·xd⁻²."""
    from charon_tpu_torch.ops import miller_program as mp

    fmul = OPS["fp_mul"]
    inv = (4 * fmul + OPS["fp_add"] + OPS["fp_neg"]
           + _pow_w4_ops(mp.EXP_INV, fmul, fmul))
    if kind == "inv":
        return rows * inv
    if kind == "affine":
        return rows * (inv + 4 * _F2MUL + _F2SQR)
    every = _pow_w4_ops(mp.EXP_SQRT_A1, _F2SQR, _F2MUL) + _F2SQR + 2 * _F2MUL
    branch_b = (OPS["fp_add"] + _pow_w4_ops(mp.EXP_SQRT_B, _F2SQR, _F2MUL)
                + _F2MUL + _F2SQR)
    return (rows * (every + 2 * _F2EQ) + alpha_m1 * (OPS["fp_neg"] + _F2SQR)
            + (rows - alpha_m1) * branch_b)


#: K18's function's planes: read (the root's v, the inverse's a, the
#: affine step's xd, xn, Z·u², root) and written (the root and its ok
#: byte; the inverse; x for both numerators and y)
CHAIN_IO_PLANES = {"sqrt": (2, 2), "inv": (2, 2), "affine": (8, 6)}


def canon_planes(t: torch.Tensor) -> torch.Tensor:
    """[planes, 32, R] → each plane's canonical standard form."""
    from charon_tpu_torch.ops import fp

    return torch.stack([fp.canon_std(p) for p in t])


#: K18's sweep: (lanes, slots, look-ahead, window bits) per program
CHAIN_SWEEP = {
    "sqrt": ((2, 38, 40, 4), (4, 38, 40, 4), (1, 24, 40, 3),
             (2, 24, 40, 3), (4, 24, 40, 3), (8, 26, 40, 3),
             (2, 16, 40, 2), (4, 16, 40, 2)),
    "affine": ((1, 18, 40, 4), (2, 18, 40, 4), (4, 18, 40, 4),
               (2, 12, 40, 3)),
}


def chains_phase(dev, sm_clocks_per_s: float, batches=(64, 2048)) -> dict:
    """K18's three programs at a hash batch's shapes (`batches` messages:
    the slot-start batch's 64 and a verify tile's 2,048 — the root on 4·m
    rows, the inverse and the affine step on 2·m): each against its plain
    version on the card (the program, and for the root the exact tests
    and select of its epilogue: root and ok), bit for bit, under the configuration
    `chain_config` picks at that shape, and against the K7 launch
    sequence it replaced (`f2_sqrt_steps`, `f2_inv_steps`,
    `f2_affine_steps`) by value, on random and all-LMAX limbs with zero
    rows, rows of the α = −1 branch and squares; timed beside those
    sequences, the bound of the function (`chain_ops`) and that of the
    program's own ops (`program_ops`); the sweep over lanes, slots and
    window widths."""
    from charon_tpu_torch.ops import cuda_h2c as ch, fp
    from charon_tpu_torch.ops import miller_program as mp
    from charon_tpu_torch.tbls.ref.fields import P

    gen = np.random.default_rng(20261024)

    def inputs(kind, n, pattern):
        planes = mp.CHAINS[kind][1] - (kind == "sqrt")
        x = limbs(dev, gen, (planes, NL, n), pattern)
        x[..., 0] = 0                               # v = 0, a = 0, xd = 0
        if kind == "sqrt":
            # −1, an Fp non-residue (α = −1: its root is u); 9 + 16u, a
            # non-square (its norm 337 is not a square mod p); (3 + 4u)²
            x[:, :, 1] = torch.from_numpy(np.stack(
                [fp.to_limbs(P - 1), fp.ZERO])).to(dev)
            x[:, :, 2] = torch.from_numpy(np.stack(
                [fp.to_limbs(9), fp.to_limbs(16)])).to(dev)
            x[:, :, 3] = torch.from_numpy(np.stack(
                [fp.to_limbs(P - 7), fp.to_limbs(24)])).to(dev)
        return x

    def block(kind, x):
        """The kernel's input block: the root's v gains the constant one."""
        if kind != "sqrt":
            return x
        one = fp.const(fp.ONE, dev).unsqueeze(-1).expand(NL, x.shape[-1])
        return torch.cat([x, one[None]])

    def run(kind, x, cfg=None):
        if kind == "sqrt":
            return ch.f2_sqrt_rows(x, cfg)
        if kind == "inv":
            return (ch.f2_inv_rows(x, cfg),)
        return tuple(ch.f2_affine_rows(*x.split(2), cfg))

    def steps(kind, x):
        if kind == "sqrt":
            return ch.f2_sqrt_steps(x)
        if kind == "inv":
            return (ch.f2_inv_steps(x),)
        return tuple(ch.f2_affine_steps(*x.split(2)))

    def same_value(kind, got, want):
        if kind == "sqrt":
            (r, ok), (r2, ok2) = got, want
            return bool(torch.equal(ok, ok2)) and bool(torch.equal(
                canon_planes(r[..., ok]), canon_planes(r2[..., ok2])))
        return all(torch.equal(canon_planes(a), canon_planes(b))
                   for a, b in zip(got, want))

    res = {}
    for kind in ("sqrt", "affine", "inv"):
        prog = mp.chain_program(kind)
        part = {"lanes": prog.lanes, "slots": prog.slots,
                "window_bits": mp.CH_CONFIG[kind][3], "steps": prog.steps,
                "cost": prog.cost()}
        rd, wr = CHAIN_IO_PLANES[kind]
        for m in batches:
            n = (4 if kind == "sqrt" else 2) * m
            for pattern in ("random", "lmax"):
                x = inputs(kind, n, pattern)
                if not same_value(kind, run(kind, x), steps(kind, x)):
                    raise AssertionError(f"K18 {kind} at {n} rows "
                                         f"({pattern}) differs from the K7 "
                                         f"sequence in value")
            x = inputs(kind, n, "random")
            blk = block(kind, x)
            cfg = ch.chain_config(kind, n, dev)
            cprog = mp.chain_program(kind, cfg)
            # the kernel against its plain version on the card: the
            # program, and for the root the exact boundary of its epilogue
            got = ch._run_chain(kind, blk, cfg)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            raw = mp.chain_run_plain(cprog, list(blk))
            want = (ch.sqrt_select_plain(raw, blk[ch.CH_V:ch.CH_V + 2])
                    if kind == "sqrt" else raw)
            end.record()
            torch.cuda.synchronize()
            err = max(int((g.long() - w.long()).abs().max()) for g, w in
                      zip(*((t if kind == "sqrt" else (t,))
                            for t in (got, want))))
            if err:
                raise AssertionError(f"K18 {kind} at {n} rows: kernel "
                                     f"differs from its plain version "
                                     f"(max abs err {err})")
            if kind == "sqrt":
                # v = 0, −1 (the α = −1 branch) and (3 + 4u)² have roots,
                # 9 + 16u has none
                ok = got[1][:4].tolist()
                if ok != [True, True, False, True]:
                    raise AssertionError(f"K18 sqrt at {n} rows: ok flags "
                                         f"{ok} of v = 0, −1, 9 + 16u, "
                                         f"(3 + 4u)²")
            # the rows of the α = −1 branch, which need no second pow
            alpha_m1 = (int(ch.f2_eq_const_rows(raw[:2], ch._F2_MINUS_ONE)
                            .sum()) if kind == "sqrt" else 0)
            nbytes = n * ((rd + wr) * EL_BYTES + (kind == "sqrt"))
            bms, by = bound(chain_ops(kind, n, alpha_m1), nbytes,
                            sm_clocks_per_s)
            ims, _ = bound(program_ops(cprog) * n,
                           n * sum(mp.CHAINS[kind][1:]) * EL_BYTES,
                           sm_clocks_per_s)
            part[f"at_{n}"] = {
                "rows": n, "config": cfg, "alpha_m1_rows": alpha_m1,
                "ms": time_ms(lambda: run(kind, x)),
                "steps_ms": time_ms(lambda: steps(kind, x), 3),
                "bound_ms": bms, "bound_by": by, "issued_bound_ms": ims,
                "max_abs_err": err, "plain_ms": start.elapsed_time(end)}
        if kind in CHAIN_SWEEP:
            part["sweep"] = {}
            for m in batches:
                n = (4 if kind == "sqrt" else 2) * m
                x = inputs(kind, n, "random")
                want = run(kind, x)
                for cfg in CHAIN_SWEEP[kind]:
                    if not same_value(kind, run(kind, x, cfg), want):
                        raise AssertionError(f"K18 {kind} with {cfg} "
                                             f"differs from the default")
                    p = mp.chain_program(kind, cfg)
                    part["sweep"][f"{cfg}@{n}"] = {
                        "ms": time_ms(lambda cfg=cfg: run(kind, x, cfg)),
                        "steps": p.steps, "cost": p.cost()}
        res[kind] = part
        log(f"K18 f2_chain {kind} ({prog.lanes} lanes a row, {prog.slots} "
            f"slots, {prog.steps} steps, {prog.cost():,} instructions a "
            f"lane): " + "; ".join(
                f"at {a['rows']:,} rows {a['ms']:.4f} ms against "
                f"{a['steps_ms']:.4f} ms for the K7 sequence (bound "
                f"{a['bound_ms']:.4f} ms, the program's ops "
                f"{a['issued_bound_ms']:.4f}; plain {a['plain_ms']:.1f} ms)"
                for k, a in part.items() if k.startswith("at_"))
            + (f"; sweep {json.dumps(part['sweep'])}"
               if "sweep" in part else ""))
    # the main path's shapes: the root at a 2,048-message batch's rows
    big = res["sqrt"][f"at_{4 * batches[-1]}"]
    small = res["sqrt"][f"at_{4 * batches[0]}"]
    return {"ms": big["ms"], "plain_ms": small["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "max_abs_err": max(a["max_abs_err"] for part in res.values()
                               for k, a in part.items()
                               if k.startswith("at_")),
            "programs": res}


def normalize_phase(dev, sm_clocks_per_s: float,
                    sizes=(10_240, 64, 2048)) -> dict:
    """K19 against its plain version bit for bit and against the K1 chain
    it replaced (`codec.g2_normalize`, canonical, so bit for bit too) at
    the combine's 10,240 rows and a hash batch's 64 and 2,048: random
    limbs with Z ≠ 1, ∞ rows (Z = 0 and Z = (p, 0), zero in value only)
    and all-LMAX limbs; timed beside the K1 chain and the bound."""
    from charon_tpu_torch.ops import codec, cuda_codec, fp
    from charon_tpu_torch.tbls.ref.fields import P

    gen = np.random.default_rng(20261025)
    digits = cuda_codec._INV_DIGITS
    row_ops = (2 * OPS["fp_mul"] + OPS["fp_add"]
               + (14 + 4 * (len(digits) - 1)
                  + sum(1 for d in digits[1:] if d)) * OPS["fp_mul"]
               + 2 * OPS["fp_mul"] + OPS["fp_neg"] + 2 * _F2MUL
               + 4 * _CANON + 2 * _ISZERO)

    def pat(n, pattern):
        pt = limbs(dev, gen, (3, 2, NL, n), pattern)
        if pattern == "random":
            pt[2, :, :, 3::97] = 0
            pt[2, 0, :, 5::97] = torch.from_numpy(fp.to_limbs(P)).to(
                dev).unsqueeze(-1)
            pt[2, 1, :, 5::97] = 0
        return (pt,)

    res = {}
    for n in sizes:
        part = {}
        record(part, "g2_normalize", cuda_codec.g2_normalize,
               cuda_codec.g2_normalize_plain, row_ops * n,
               n * (6 + 4) * EL_BYTES + n,
               [lambda: pat(n, "random"), lambda: pat(n, "lmax")],
               sm_clocks_per_s, plain_reps=1)
        pt, = pat(n, "random")
        got, want = cuda_codec.g2_normalize(pt), codec.g2_normalize(pt)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K19 at {n} rows differs from the K1 "
                                 f"chain of codec.g2_normalize")
        if not bool(got[4][3::97].all()) or not bool(got[4][5::97].all()):
            raise AssertionError("K19: an ∞ row was not flagged")
        part["g2_normalize"]["steps_ms"] = time_ms(
            lambda: codec.g2_normalize(pt), 3)
        res[n] = part["g2_normalize"]
    log("K19 g2_normalize: " + "; ".join(
        f"at {n:,} rows {r['ms']:.4f} ms against {r['steps_ms']:.4f} ms for "
        f"the K1 chain (bound {r['bound_ms']:.4f} ms)"
        for n, r in res.items()))
    return {**res[sizes[0]], "rows": sizes[0],
            **{f"at_{n}": res[n] for n in sizes[1:]}}


def tables_phase(dev, rows: int, sm_clocks_per_s: float) -> dict:
    """K20 against its plain program bit for bit at a verify tile's
    `rows` pair rows (real G1 points with ∞ and −g1 rows; random and
    all-LMAX limbs), and against the K1 chain it replaced (`curve.
    double_point` / `add_points`) by value; timed beside it and the
    bound."""
    from charon_tpu_torch.ops import cuda_pairing as cp
    from charon_tpu_torch.ops import curve as tcurve
    from charon_tpu_torch.ops import miller_program as mp
    from charon_tpu_torch.tbls.ref import curve as rc

    gen = np.random.default_rng(20261026)
    real = rlc_tables(dev, rows, slice(200, 216))[0]
    real[..., 0::2] = torch.from_numpy(tcurve.g1_pack(
        [rc.neg(rc.G1_GEN)])).to(dev)
    real = real.contiguous()
    prog = mp.g1_tables_program()

    def k1_chain(base):
        p2 = tcurve.double_point(tcurve.FP_OPS, base)
        return p2, tcurve.add_points(tcurve.FP_OPS, p2, base)

    out = {}
    record(out, "g1_tables", cp.g1_tables, cp.g1_tables_plain,
           program_ops(prog) * rows, rows * 9 * EL_BYTES,
           [lambda: (real,),
            lambda: (limbs(dev, gen, (3, NL, rows), "random"),),
            lambda: (limbs(dev, gen, (3, NL, rows), "lmax"),)],
           sm_clocks_per_s)
    res = out["g1_tables"]
    for a, b in zip(cp.g1_tables(real), k1_chain(real)):
        if not torch.equal(canon_planes(a), canon_planes(b)):
            raise AssertionError("K20 differs from the K1 chain in value")
    res.update(steps_ms=time_ms(lambda: k1_chain(real)), rows=rows,
               lanes=prog.lanes, slots=prog.slots, program_steps=prog.steps)
    log(f"K20 g1_tables at {rows:,} rows ({prog.lanes} lanes a row, "
        f"{prog.steps} steps): {res['ms']:.4f} ms against "
        f"{res['steps_ms']:.4f} ms for the K1 chain (bound "
        f"{res['bound_ms']:.4f} ms)")
    return res


def g1_decompress_ops(n: int, n_live: int) -> np.ndarray:
    """[IMAD, ALU] of one K21 launch (csrc/g1_decompress.cu) over n rows,
    n_live of them a key on the curve and not ∞: every row computes x³ +
    4, the root's pow (LSB first), its check, the canonical root and its
    negation (counted on every row: at most one Fp negation a row too
    many); a live row then [r]P by 4-bit windows — the table (1
    doubling, 13 additions), 4 doublings a window, an addition a non-zero
    digit — and the test Z ≡ 0."""
    from charon_tpu_torch.ops import cuda_codec

    fmul = OPS["fp_mul"]
    every = (2 * fmul + OPS["fp_add"]
             + _pow_ops(cuda_codec.EXP_P14, fmul, fmul) + fmul
             + OPS["fp_sub"] + _ISZERO + _CANON + OPS["fp_neg"])
    digits = cuda_codec.R_DIGITS
    live = ((1 + 4 * (len(digits) - 1)) * OPS["g1_dbl"]
            + (13 + sum(1 for d in digits[1:] if d)) * OPS["g1_add"]
            + _ISZERO)
    return n * every + n_live * live


def g1_decompress_rows(pks: list[bytes]) -> tuple[list[bytes], list[str]]:
    """The keys with a bad row every 97th: ∞, an x off the curve, a point
    on E(Fp) outside G1 and its negation, in turn (the CPU test's
    kinds)."""
    from charon_tpu_torch.tbls.ref import curve as rc
    from charon_tpu_torch.tbls.ref.fields import FQ, R

    x = 1
    while (FQ(x) ** 3 + 4).sqrt() is not None:
        x += 1
    off_curve = bytes([0x80]) + x.to_bytes(48, "big")[1:]
    x = 1
    while True:
        y = (FQ(x) ** 3 + 4).sqrt()
        if y is not None and rc.multiply_raw((FQ(x), y), R) is not None:
            break
        x += 1
    special = [("inf", rc.g1_to_bytes(None)), ("off_curve", off_curve),
               ("off_subgroup", rc.g1_to_bytes((FQ(x), y))),
               ("off_subgroup_neg", rc.g1_to_bytes(rc.neg((FQ(x), y))))]
    rows, kinds = list(pks), ["valid"] * len(pks)
    for j, r in enumerate(range(3, len(rows), 97)):
        kinds[r], rows[r] = special[j % len(special)]
    return rows, kinds


def g1_decompress_phase(dev, pks: list[bytes], sm_clocks_per_s: float,
                        sizes=(2048, VALIDATORS)) -> dict:
    """K21 against its plain version bit for bit, and against the K1 chain
    it replaced (`codec.g1_decompress` and the backend's ∞ mask) — points
    bit for bit, the same verdicts — at a verify tile's 2,048 keys and at
    the flush's 10,000: the verify pool's keys (both signs of y) with ∞,
    off-curve and off-subgroup rows mixed in, each verdict as its row's
    kind wants; timed beside the K1 chain, its plain version and the
    bound of this data's work."""
    from charon_tpu_torch.ops import codec, cuda_codec, fp

    rows, kinds = g1_decompress_rows(pks)
    res = {}
    for n in sizes:
        x, sign, inf, bad = codec.g1_bytes_split(
            np.stack([np.frombuffer(b, np.uint8) for b in rows[:n]]))
        if bad.any():
            raise AssertionError("K21 phase: a malformed key row")
        args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (x.T, sign, inf))
        valid = np.array([k == "valid" for k in kinds[:n]])
        part = {}
        record(part, "g1_decompress", cuda_codec.g1_decompress,
               cuda_codec.g1_decompress_plain,
               g1_decompress_ops(n, int(valid.sum())),
               n * (4 * EL_BYTES + 3), [lambda: args], sm_clocks_per_s,
               plain_reps=1)
        pts, ok = cuda_codec.g1_decompress(*args)
        cpts, cok = codec.g1_decompress(*args)
        cok = cok & ~fp.is_zero(cpts[2])
        if not torch.equal(pts, cpts) or not torch.equal(ok, cok):
            raise AssertionError(f"K21 at {n} rows differs from the K1 chain "
                                 f"of codec.g1_decompress")
        if not np.array_equal(ok.cpu().numpy(), valid):
            wrong = sorted({kinds[r] for r in np.flatnonzero(
                ok.cpu().numpy() != valid)})
            raise AssertionError(f"K21 at {n} rows: wrong verdicts on {wrong}")
        part["g1_decompress"]["steps_ms"] = time_ms(
            lambda: codec.g1_decompress(*args), 3)
        res[n] = part["g1_decompress"]
    log("K21 g1_decompress: " + "; ".join(
        f"at {n:,} keys {r['ms']:.4f} ms against {r['steps_ms']:.4f} ms for "
        f"the K1 chain (bound {r['bound_ms']:.4f} ms by {r['bound_by']}; "
        f"plain {r['plain_ms']:.1f} ms)" for n, r in res.items()))
    return {**res[sizes[0]], "rows": sizes[0],
            **{f"at_{n}": res[n] for n in sizes[1:]}}


#: K22's programs' [IMAD, ALU] a row, from the law's OPS counts: the
#: tables 2 doublings and an addition; the halves' sum, its double and
#: three ψ maps; the clearing's 5 additions and 3 point negations (an Fp2
#: negation each)
LAW_OPS = {"tables": 2 * OPS["g2_dbl"] + OPS["g2_add"],
           "pre": OPS["g2_dbl"] + OPS["g2_add"] + 3 * OPS["h2c_psi"],
           "post": 5 * OPS["g2_add"] + 6 * OPS["fp_neg"]}
#: K22's sweep: (lanes, slots, look-ahead) per program
LAW_SWEEP = {"tables": ((4, 30, 40), (8, 34, 40), (16, 34, 40)),
             "pre": ((4, 28, 40), (8, 30, 40), (8, 34, 40), (16, 30, 40)),
             "post": ((4, 30, 40), (8, 34, 40), (8, 36, 40), (16, 40, 40))}


def g2_law_phase(dev, sm_clocks_per_s: float, combine_rows: int,
                 batches=(MESSAGES, 2048)) -> dict:
    """K22's three programs against their plain programs and against the
    K2 launch sequences they replaced (`cuda_h2c.law_steps`), bit for bit:
    the tables at the combine's `combine_rows` point rows, the hash
    batch's two at the slot-start batch's and a verify tile's message
    counts; random limbs with ∞ rows and all-LMAX limbs; timed beside the
    K2 sequences, the plain programs and the bound; the sweep over lanes;
    K2's own times at the hash batches' rows."""
    from charon_tpu_torch.ops import cuda_g2, cuda_h2c
    from charon_tpu_torch.ops import miller_program as mp

    gen = np.random.default_rng(20261027)
    shapes = {"tables": (combine_rows,), "pre": batches, "post": batches}
    res = {}
    for kind, sizes in shapes.items():
        _, nin, nout = mp.LAWS[kind]
        for n in sizes:
            def pat(pattern, n=n, nin=nin):
                blk = limbs(dev, gen, (nin, NL, n), pattern)
                if pattern == "random":
                    for k in range(nin // 6):
                        blk[6 * k:6 * k + 6, :, 3 + k::61] = \
                            cuda_g2.inf_planes(len(range(3 + k, n, 61)), dev)
                return (blk,)

            part = {}
            record(part, "g2_law", lambda b, kind=kind: cuda_g2.g2_law(kind, b),
                   lambda b, kind=kind: mp.law_run_plain(
                       mp.law_program(kind), b),
                   LAW_OPS[kind] * n, n * (nin + nout) * EL_BYTES,
                   [lambda: pat("random"), lambda: pat("lmax")],
                   sm_clocks_per_s, plain_reps=1)
            r = part["g2_law"]
            blk, = pat("random")
            if not torch.equal(cuda_g2.g2_law(kind, blk),
                               cuda_h2c.law_steps(kind, blk)):
                raise AssertionError(f"K22 {kind} at {n} rows differs from "
                                     f"the K2 launch sequence")
            r["steps_ms"] = time_ms(lambda: cuda_h2c.law_steps(kind, blk))
            r["config"] = mp.LW_CONFIG[kind]
            r["sweep"] = {}
            want = cuda_g2.g2_law(kind, blk)
            for cfg in LAW_SWEEP[kind]:
                if not torch.equal(cuda_g2.g2_law(kind, blk, cfg), want):
                    raise AssertionError(f"K22 {kind} with {cfg} differs "
                                         f"from the default")
                prog = mp.law_program(kind, cfg)
                r["sweep"][str(cfg)] = {
                    "ms": time_ms(lambda cfg=cfg: cuda_g2.g2_law(kind, blk,
                                                                 cfg)),
                    "steps": prog.steps, "cost": prog.cost()}
            res[f"{kind}@{n}"] = r
            log(f"K22 g2_law {kind} at {n:,} rows ({r['config']}): "
                f"{r['ms']:.4f} ms against {r['steps_ms']:.4f} ms for the K2 "
                f"sequence (bound {r['bound_ms']:.4f} ms; plain "
                f"{r['plain_ms']:.1f} ms); sweep {json.dumps(r['sweep'])}")
    k2 = {}
    for n in batches:
        p = limbs(dev, gen, (6, NL, n), "random")
        q = limbs(dev, gen, (6, NL, n), "random")
        k2[n] = {"dbl_ms": time_ms(lambda: cuda_g2.dbl(p)),
                 "add_ms": time_ms(lambda: cuda_g2.add(p, q))}
    log(f"K2 at the hash batches' rows: {json.dumps(k2)}")
    top = res[f"tables@{combine_rows}"]
    return {**top, "rows": combine_rows,
            "max_abs_err": max(r["max_abs_err"] for r in res.values()),
            "programs": {k: r for k, r in res.items()
                         if not k.startswith("tables@")},
            "k2_at_batches": k2}


#: K23's sweep: (lanes, slots, look-ahead)
MT_SWEEP = ((4, 20, 40), (8, 16, 40), (8, 20, 40), (16, 20, 40))


def map_tail_inputs(dev, gen, n: int, pattern: str) -> tuple:
    """(aff [6, 32, n], ok1 [n] bool, sgn [n] int32) for K23: seeded
    random or all-LMAX limbs, every mix of ok₁ and sgn0(u); row 3's x a
    root of the isogeny's x-denominator x² + k₂₁x + k₂₀ (Z ≡ 0: the exact
    ∞ comes out), row 5's y zero, row 7 the zero element in x."""
    from charon_tpu_torch.ops import fp
    from charon_tpu_torch.tbls.ref import sswu
    from charon_tpu_torch.tbls.ref.fields import FQ2, P

    aff = limbs(dev, gen, (6, NL, n), pattern)
    k20, k21 = sswu._XD[0], sswu._XD[1]
    root = (-k21 + (k21 * k21 - k20 * 4).sqrt()) * FQ2([(P + 1) // 2, 0])
    for c in range(2):
        for x in (0, 2):
            aff[x + c, :, 3] = torch.from_numpy(
                fp.to_limbs(int(root.coeffs[c]) % P)).to(dev)
    aff[4:6, :, 5] = 0
    aff[0:4, :, 7] = 0
    ok1 = torch.from_numpy(gen.integers(0, 2, n).astype(bool)).to(dev)
    sgn = torch.from_numpy(gen.integers(0, 2, n, dtype=np.int32)).to(dev)
    return aff, ok1, sgn


def map_tail_phase(dev, sm_clocks_per_s: float,
                   batches=(MESSAGES, 2048)) -> dict:
    """K23 (the map's tail: x's select, the sign fix, the 3-isogeny and
    the ∞ guard in one launch) against its plain version on the card, bit
    for bit, at a hash batch's u rows (2 a message: the slot-start
    batch's 128, a verify tile's 4,096) on random and all-LMAX limbs with
    an isogeny-∞ row; timed beside the K9 iso3 launch with the K1
    negation and exact boundary it replaced (`map_tail_steps`, held equal
    too), the plain version and the bound; the sweep over 4, 8 and 16
    lanes a row."""
    from charon_tpu_torch.ops import cuda_g2, cuda_h2c as ch, fp
    from charon_tpu_torch.ops import miller_program as mp

    gen = np.random.default_rng(20261102)
    inf = fp.const(cuda_g2._INF_PLANES, dev)
    res = {}
    for m in batches:
        n = 2 * m
        part = {}
        args = map_tail_inputs(dev, gen, n, "random")
        flips = int((ch.f2_sgn0_rows(args[0][4:6]) != (args[2] != 0)).sum())
        ops = OPS["h2c_map_tail"] * n + 2 * OPS["fp_neg"] * flips
        record(part, "h2c_map_tail", ch.h2c_map_tail, ch.map_tail_plain,
               ops, n * (12 * EL_BYTES + 5),
               [lambda: args,
                lambda: map_tail_inputs(dev, gen, n, "lmax")],
               sm_clocks_per_s, plain_reps=1)
        r = part["h2c_map_tail"]
        got = ch.h2c_map_tail(*args)
        if not torch.equal(got[..., 3], inf):
            raise AssertionError("K23: the isogeny-∞ row is not (0 : 1 : 0)")
        if not torch.equal(got, ch.map_tail_steps(*args)):
            raise AssertionError(f"K23 at {n} rows differs from the K9 "
                                 f"sequence it replaced")
        r["steps_ms"] = time_ms(lambda: ch.map_tail_steps(*args))
        r["iso3_ms"] = time_ms(lambda: ch.h2c_iso3(
            torch.cat([args[0][0:2], args[0][4:6]])))
        r["config"] = mp.MT_CONFIG
        r["flipped_rows"] = flips
        r["sweep"] = {}
        for cfg in MT_SWEEP:
            if not torch.equal(ch.h2c_map_tail(*args, cfg), got):
                raise AssertionError(f"K23 with {cfg} differs from the "
                                     f"default")
            prog = mp.map_tail_program(cfg)
            r["sweep"][str(cfg)] = {
                "ms": time_ms(lambda cfg=cfg: ch.h2c_map_tail(*args, cfg)),
                "steps": prog.steps, "cost": prog.cost()}
        res[n] = r
        log(f"K23 h2c_map_tail at {n:,} rows ({r['config']}): "
            f"{r['ms']:.4f} ms against {r['steps_ms']:.4f} ms for the "
            f"sequence it replaced (K9 iso3 alone {r['iso3_ms']:.4f}; bound "
            f"{r['bound_ms']:.4f} ms; plain {r['plain_ms']:.1f} ms); sweep "
            f"{json.dumps(r['sweep'])}")
    big, small = res[2 * batches[-1]], res[2 * batches[0]]
    return {**big, "rows": 2 * batches[-1], f"at_{2 * batches[0]}": small,
            "max_abs_err": max(r["max_abs_err"] for r in res.values())}


#: K24's sweep: (lanes, slots, look-ahead)
SW_SWEEP = ((2, 20, 40), (4, 20, 40), (4, 24, 40), (8, 20, 40),
            (16, 20, 40))


def sswu_head_inputs(dev, gen, n: int, pattern: str) -> torch.Tensor:
    """u [2, 32, n] for K24: seeded random canonical values (rows 0 and
    5 mod 64 u = 0, rows 1 mod 8 c0 = 0, rows 2 mod 8 c1 = 0), or all-LMAX
    limbs (a redundant form; row 1 zero)."""
    from charon_tpu_torch.ops import cuda_h2c as ch, fp
    from charon_tpu_torch.tbls.ref.fields import FQ2, P

    if pattern == "lmax":
        u = torch.full((2, NL, n), fp.LMAX, dtype=torch.int32)
        u[:, :, 1] = 0
        return u.to(dev)
    vals = [[int.from_bytes(gen.bytes(48), "little") % P for _ in range(2)]
            for _ in range(n)]
    for r in range(n):
        if r % 64 in (0, 5):
            vals[r] = [0, 0]
        elif r % 8 in (1, 2):
            vals[r][r % 8 - 1] = 0
    return torch.from_numpy(ch._pack_u([FQ2(v) for v in vals])).to(dev)


def host_flags(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two flags as the JAX package's `pack_messages` computes them per
    row on the host (tv1 = 0, sgn0(u)), from the rows' values: what K8
    reads, and what K24's prologue must reproduce."""
    from charon_tpu_torch.ops import fp
    from charon_tpu_torch.tbls.ref import sswu
    from charon_tpu_torch.tbls.ref.fields import FQ2

    c0, c1 = (fp.unpack(u[j].cpu().numpy()) for j in range(2))
    exc, sgn = [], []
    for a, b in zip(c0, c1):
        x = FQ2([a, b])
        zu2 = sswu.Z_SSWU * (x * x)
        exc.append(1 if (zu2 * zu2 + zu2).is_zero() else 0)
        sgn.append(sswu._sgn0(x))
    return (torch.tensor(exc, dtype=torch.int32, device=u.device),
            torch.tensor(sgn, dtype=torch.int32, device=u.device))


def sswu_head_phase(dev, sm_clocks_per_s: float,
                    batches=(MESSAGES, 2048)) -> dict:
    """K24 (SSWU with its exceptional flag and sgn0(u) in one launch)
    against its plain version on the card, bit for bit, at a hash batch's
    u rows (2 a message: the slot-start batch's 128, a verify tile's
    4,096) on canonical u with u = 0, c0 = 0 and c1 = 0 rows and on
    all-LMAX limbs; against K8 given the host's flags (`host_flags`), its
    planes bit for bit and its sgn0 row equal to the host's; timed beside
    K8, the plain version and the bound; the sweep over lanes and
    slots."""
    from charon_tpu_torch.ops import cuda_h2c as ch
    from charon_tpu_torch.ops import miller_program as mp

    gen = np.random.default_rng(20261121)
    res = {}
    for m in batches:
        n = 2 * m
        part = {}
        u = sswu_head_inputs(dev, gen, n, "random")
        exc, _ = host_flags(u)
        ops = OPS["h2c_sswu_head"] * n + _F2MUL * int((exc == 0).sum())
        record(part, "h2c_sswu_head", ch.h2c_sswu_head, ch.sswu_head_plain,
               ops, n * (12 * EL_BYTES + 4),
               [lambda: (u,),
                lambda: (sswu_head_inputs(dev, gen, n, "lmax"),)],
               sm_clocks_per_s, plain_reps=1)
        r = part["h2c_sswu_head"]
        got, got_sgn = ch.h2c_sswu_head(u)
        for x in (u, sswu_head_inputs(dev, gen, n, "lmax")):
            w, s_host = host_flags(x)
            out, s_dev = ch.h2c_sswu_head(x)
            if not torch.equal(out, ch.h2c_sswu(x, w)) or \
                    not torch.equal(s_dev, s_host):
                raise AssertionError(f"K24 at {n} rows differs from K8 "
                                     f"given the host's flags")
        r["k8_ms"] = time_ms(lambda: ch.h2c_sswu(u, exc))
        r["config"] = mp.SW_CONFIG
        r["exceptional_rows"] = int(exc.sum())
        r["sweep"] = {}
        for cfg in SW_SWEEP:
            out, s = ch.h2c_sswu_head(u, cfg)
            if not torch.equal(out, got) or not torch.equal(s, got_sgn):
                raise AssertionError(f"K24 with {cfg} differs from the "
                                     f"default")
            prog = mp.sswu_program(cfg)
            r["sweep"][str(cfg)] = {
                "ms": time_ms(lambda cfg=cfg: ch.h2c_sswu_head(u, cfg)),
                "steps": prog.steps, "cost": prog.cost()}
        res[n] = r
        log(f"K24 h2c_sswu_head at {n:,} rows ({r['config']}, "
            f"{r['exceptional_rows']} rows u = 0): {r['ms']:.4f} ms against "
            f"{r['k8_ms']:.4f} ms for K8 (bound {r['bound_ms']:.4f} ms; "
            f"plain {r['plain_ms']:.1f} ms); sweep {json.dumps(r['sweep'])}")
    big, small = res[2 * batches[-1]], res[2 * batches[0]]
    return {**big, "rows": 2 * batches[-1], f"at_{2 * batches[0]}": small,
            "max_abs_err": max(r["max_abs_err"] for r in res.values())}


def h2c_kernels_phase(dev, msgs: int, sm_clocks_per_s: float) -> dict:
    """K7–K9 and K10 (dblsel, addsel) against their plain versions at the
    shapes of one `msgs`-message hash batch: the sqrt chain's 4·msgs rows
    (both candidates of both u values), SSWU and the isogeny's 2·msgs, ψ
    and the cofactor steps' msgs; seeded random and all-LMAX limbs."""
    from charon_tpu_torch.ops import cuda_g2, cuda_h2c as ch

    gen = np.random.default_rng(20261018)
    results = {}

    def rec(name, kernel_fn, plain_fn, ops, nbytes, patterns):
        record(results, name, kernel_fn, plain_fn, ops, nbytes, patterns,
               sm_clocks_per_s)

    def lim(planes, pattern, n):
        return limbs(dev, gen, (planes, NL, n), pattern)

    pats = ("random", "lmax")
    n = 4 * msgs
    for name, k_fn, p_fn, n_in in (
            ("h2c_sqr", ch.h2c_sqr, ch.sqr_plain, 1),
            ("h2c_mul", ch.h2c_mul, ch.mul_plain, 2),
            ("h2c_sqr4", ch.h2c_sqr4, ch.sqr4_plain, 1),
            ("h2c_sqr4mul", ch.h2c_sqr4mul, ch.sqr4mul_plain, 2)):
        rec(name, k_fn, p_fn, OPS[name] * n, (n_in + 1) * 2 * EL_BYTES * n,
            [lambda p=p, n_in=n_in: tuple(lim(2, p, n) for _ in range(n_in))
             for p in pats])
    n = 2 * msgs
    w = gen.integers(0, 16, n, dtype=np.int32) == 0        # ~1 in 16 set
    w_t = torch.from_numpy(w.astype(np.int32)).to(dev)
    rec("h2c_sswu", ch.h2c_sswu, ch.sswu_plain,
        OPS["h2c_sswu"] * n + _F2MUL * int((~w).sum()),
        n * (12 * EL_BYTES + 4),
        [lambda p=p: (lim(2, p, n), w_t) for p in pats])
    rec("h2c_iso3", ch.h2c_iso3, ch.iso3_plain, OPS["h2c_iso3"] * n,
        n * 10 * EL_BYTES, [lambda p=p: (lim(4, p, n),) for p in pats])
    n = msgs
    rec("h2c_psi", ch.h2c_psi, ch.psi_plain, OPS["h2c_psi"] * n,
        n * 2 * PT_BYTES, [lambda p=p: (lim(6, p, n),) for p in pats])
    w = torch.from_numpy(gen.integers(0, 4, n, dtype=np.int32)).to(dev)
    nz = int((w != 0).sum())
    for name, k_fn, p_fn, dbls in (
            ("g2_dblsel", cuda_g2.dblsel, cuda_g2.dblsel_plain, 2),
            ("g2_addsel", cuda_g2.addsel, cuda_g2.addsel_plain, 0)):
        rec(name, k_fn, p_fn, OPS["g2_dbl"] * dbls * n + OPS["g2_add"] * nz,
            n * (2 * PT_BYTES + 4) + nz * PT_BYTES,
            [lambda p=p: (lim(6, p, n), lim(6, p, n), lim(6, p, n),
                          lim(6, p, n), w) for p in pats])
    return results


def k1_main_shapes(dev, sm_clocks_per_s: float) -> dict:
    """K1's mul, add and sub at the shapes the main path launched them
    before K20, K19 and K11's verdict took them (the RLC tables' [6, 32,
    4,096] products and [32, 4,096] sums, the combine normalisation's
    [32, 10,240] inverse chain, is_one's [2, 3, 2, 32, 1] difference): the
    kernel's CUDA-event median, and the
    wall per launch through the `fp` entry point with its tensor glue (200
    calls back to back, one synchronise)."""
    from charon_tpu_torch.ops import cuda_fp, fp

    gen = np.random.default_rng(20261020)
    out = {}
    for name, shape, k_fn, fp_fn in (
            ("fp_mul", (6, NL, 4096), cuda_fp.mul, fp.mul),
            ("fp_mul", (NL, 10_240), cuda_fp.mul, fp.mul),
            ("fp_add", (NL, 4096), cuda_fp.add, fp.add),
            ("fp_sub", (NL, 4096), cuda_fp.sub, fp.sub),
            ("fp_sub", (2, 3, 2, NL, 1), cuda_fp.sub, fp.sub)):
        a, b = limbs(dev, gen, shape, "random"), limbs(dev, gen, shape,
                                                      "random")
        ms = time_ms(lambda: k_fn(a, b))
        fp_fn(a, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fp_fn(a, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 200 * 1e3
        rows = a.numel() // NL
        nbytes = 3 * EL_BYTES * rows
        bms, by = bound(OPS[name] * rows, nbytes, sm_clocks_per_s)
        out.setdefault(name, []).append(
            {"shape": list(shape), "ms": ms, "wall_ms": wall_ms,
             "bound_ms": bms, "bound_by": by})
        log(f"K1 {name} at {list(shape)}: {ms:.4f} ms (bound {bms:.4f} ms by "
            f"{by}); {wall_ms:.4f} ms wall per launch through fp.{name[3:]}")
    return out


def redesign_kernels_phase(dev, pool: list[bytes], tile: int,
                           combine_real: int, combine_rows: int,
                           sm_clocks_per_s: float, sms: int) -> dict:
    """K11 with its verdict "= 1" against `final_exp_plain` and
    `pairing.is_one` at 1 row (the batch check) and `tile` rows (a
    re-check), on seeded random limbs — half the rows Fp elements, which
    come out one — and all-LMAX limbs; K12 against
    `g2_decompress_plain` at `tile` rows (a verify tile) and `combine_rows`
    (the combine: `combine_real` signatures, the rest ∞ padding), on the
    pool's signatures (both signs) with ∞ rows, x off the curve and
    on-curve points outside G2 mixed in.  Bit for bit, every row's ok flag
    as its kind wants, and both timed beside their bounds."""
    from charon_tpu_torch.ops import codec, cuda_codec, cuda_final_exp
    from charon_tpu_torch.ops import pairing as tpair
    from charon_tpu_torch.tbls.ref import curve as rc
    from charon_tpu_torch.tbls.ref.fields import FQ2

    gen = np.random.default_rng(20261019)
    results = {}
    # K11: bound_ms at the card's full rate; `bound_one_warp_ms` at the
    # rate of the SMs that one warp per row can occupy (one SM a row), an
    # assumption of this design that the function does not force
    def fe_rows(rows, pattern):
        """Fp12 rows; with random limbs the first ⌈rows / 2⌉ of them Fp
        elements (c0's c0 only), which the exponentiation takes to one."""
        f = limbs(dev, gen, (2, 3, 2, NL, rows), pattern)
        if pattern == "random":
            f.view(12, NL, rows)[1:, :, :-(-rows // 2)] = 0
        return (f,)

    def fe_plain(f):
        out = cuda_final_exp.final_exp_plain(f)
        return out, tpair.is_one(out)

    for rows in (1, tile):
        part = {}
        ops = (final_exp_ops() + 12 * (OPS["fp_sub"] + _ISZERO)) * rows
        nbytes = (2 * 12 * EL_BYTES + 1) * rows
        # the path's form: the result and its verdict "= 1" in one launch
        record(part, "final_exp", cuda_final_exp.final_exp_is_one, fe_plain,
               ops, nbytes,
               [lambda rows=rows, p=p: fe_rows(rows, p)
                for p in ("random", "lmax")],
               sm_clocks_per_s, plain_reps=1)
        f, = fe_rows(rows, "random")
        _, one = cuda_final_exp.final_exp_is_one(f)
        want = [k < -(-rows // 2) for k in range(rows)]
        if one.tolist() != want:
            raise AssertionError(f"K11 at {rows} rows: verdicts "
                                 f"{one.tolist()[:8]}…, want {want[:8]}…")
        one_warp, _ = bound(ops, nbytes,
                            sm_clocks_per_s * min(rows, sms) / sms)
        results[f"final_exp@{rows}"] = {**part["final_exp"], "rows": rows,
                                        "bound_one_warp_ms": one_warp}
        log(f"K11 at {rows:,} rows: bound {one_warp:.4f} ms if each row "
            f"stays on one SM (one warp per row)")

    # K12: the kinds of row
    off_curve = []
    x = 1
    while len(off_curve) < 8:
        if (FQ2([x, 0]) ** 3 + rc.B2).sqrt() is None:
            off_curve.append(bytes([0x80 | (0x20 if x % 2 else 0)])
                             + bytes(47) + x.to_bytes(48, "big"))
        x += 1
    cof = codec._find_g2_cofactor_point()
    off_group = [rc.g2_to_bytes(cof), rc.g2_to_bytes(rc.neg(cof))]
    inf = rc.g2_to_bytes(None)
    for rows, real in ((tile, tile), (combine_rows, combine_real)):
        raw = [pool[k % len(pool)] for k in range(real)] \
            + [inf] * (rows - real)
        kind = ["valid"] * real + ["inf"] * (rows - real)
        spots = gen.choice(real, 8 + 8 * 4 + 8, replace=False).tolist()
        special = ([(b, "off_curve") for b in off_curve]
                   + [(b, "off_group") for b in off_group * 16]
                   + [(inf, "inf")] * 8)
        for r, (b, k) in zip(spots, special):
            raw[r], kind[r] = b, k
        xc0, xc1, sign, inf_f, bad = codec.g2_bytes_split(
            np.stack([np.frombuffer(b, np.uint8) for b in raw]))
        if bad.any():
            raise AssertionError("K12 inputs: a row does not decode")
        args = (torch.from_numpy(np.ascontiguousarray(xc0.T)).to(dev),
                torch.from_numpy(np.ascontiguousarray(xc1.T)).to(dev),
                torch.from_numpy(sign).to(dev),
                torch.from_numpy(inf_f).to(dev))
        _, ok = cuda_codec.g2_decompress(*args)
        ok = ok.cpu().numpy()
        want = np.array([k in ("valid", "inf") for k in kind])
        if not np.array_equal(ok, want):
            raise AssertionError(f"K12 at {rows} rows: ok flags of "
                                 f"{int((ok != want).sum())} rows are wrong")
        counts = {k: kind.count(k) for k in
                  ("valid", "inf", "off_curve", "off_group")}
        part = {}
        record(part, "g2_decompress", cuda_codec.g2_decompress,
               cuda_codec.g2_decompress_plain,
               decompress_ops(counts["valid"], counts["inf"],
                              counts["off_curve"], counts["off_group"]),
               rows * (2 * EL_BYTES + 2 + PT_BYTES + 1), [lambda: args],
               sm_clocks_per_s, plain_reps=1)
        results[f"g2_decompress@{rows}"] = {**part["g2_decompress"],
                                           "rows": rows}
        log(f"K12 at {rows:,} rows: ok flags right for every kind "
            f"{json.dumps(counts)}, {int(sign.sum()):,} rows of sign 1")
    return results


def miller_ops() -> np.ndarray:
    """[IMAD, ALU] of one Miller row (K13, or the 198 K4/K5 launches):
    63 doublings, 5 mixed additions, 62 squarings and 68 line multiplies
    (the bits of |z| below its leading one, 5 of them set)."""
    from charon_tpu_torch.ops import cuda_pairing

    bits = cuda_pairing.LOOP_BITS
    adds = sum(bits)
    return (len(bits) * OPS["pp_dbl"] + adds * OPS["pp_add"]
            + (len(bits) - 1) * OPS["pp_sqr"]
            + (len(bits) + adds) * OPS["pp_mul014"])


def miller_pairs(dev, pool: list[bytes], rows: int) -> tuple:
    """`rows` real Miller rows in the re-check's layout [(−g1, sig_k) |
    (s_k·G1, sig_k')]: the pool's signatures decompressed on the card, G1
    multiples computed on the card; 16 rows with P at ∞ and 16 with Q at
    ∞ (Q's planes zero).  → (p [3, 32, rows], q [4, 32, rows])."""
    from charon_tpu_torch.ops import codec, cuda_codec, cuda_pairing as cp
    from charon_tpu_torch.ops import curve as tcurve
    from charon_tpu_torch.tbls.ref import curve as rc

    half = rows // 2
    raw = np.stack([np.frombuffer(pool[k % len(pool)], np.uint8)
                    for k in range(rows)])
    xc0, xc1, sign, inf, bad = codec.g2_bytes_split(raw)
    if bad.any():
        raise AssertionError("Miller rows: a pool signature does not decode")
    sigs, ok = cuda_codec.g2_decompress(
        *[torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in (xc0.T, xc1.T, sign, inf)])
    if not bool(ok.all()):
        raise AssertionError("Miller rows: a pool signature is not in G2")
    rng = random.Random(29)
    scalars = [rng.randrange(1, 2**64) for _ in range(64)]
    g1 = torch.from_numpy(tcurve.g1_pack([rc.G1_GEN])).to(dev).expand(
        3, NL, 64).contiguous()
    bits = torch.from_numpy(np.ascontiguousarray(
        tcurve.scalars_to_bits(scalars).T)).to(dev)
    mults = tcurve.scalar_mul(tcurve.FP_OPS, g1, bits)
    neg_g1 = torch.from_numpy(tcurve.g1_pack([rc.neg(rc.G1_GEN)])).to(dev)
    pts = torch.cat([neg_g1.expand(3, NL, half),
                     mults.repeat(1, 1, -(-half // 64))[..., :half]], -1)
    pts[..., 100:116] = torch.from_numpy(tcurve.g1_pack([None])).to(dev)
    p = cp.g1_proj_rows(pts.contiguous())
    q = cp.g2_affine_rows(sigs)
    q[..., rows - 116:rows - 100] = 0
    return p.contiguous(), q.contiguous()


def miller_phase(dev, pool: list[bytes], rows: int,
                 sm_clocks_per_s: float) -> dict:
    """K13 against `miller_loop_plain` at `rows` Miller rows (a verify
    tile), bit for bit, on seeded random limbs, all-LMAX limbs and real
    pairs with ∞ rows; timed beside the 198-launch K4/K5 sequence it
    replaced (also held bit for bit), its bound and the plain version.
    The probe that chose its design: pp_mul014 across row counts, the same
    loop one thread per row (`miller_thread`), K13 at other row counts and
    with 4 and 16 lanes a row."""
    from charon_tpu_torch.ops import cuda_pairing as cp
    from charon_tpu_torch.ops import miller_program as mp

    gen = np.random.default_rng(20261021)
    pats = {pat: (limbs(dev, gen, (3, NL, rows), pat),
                  limbs(dev, gen, (4, NL, rows), pat))
            for pat in ("random", "lmax")}
    pats["pairs"] = miller_pairs(dev, pool, rows)
    err = 0
    plain_ms = None
    for name, (p, q) in pats.items():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = cp.miller_loop_plain(p, q)
        end.record()
        torch.cuda.synchronize()
        plain_ms = plain_ms or start.elapsed_time(end)
        for label, fn in (("K13", cp.miller_loop),
                          ("the K4/K5 sequence", cp.miller_steps),
                          ("the thread-per-row probe", cp.miller_thread)):
            got = fn(p, q)
            torch.cuda.synchronize()
            diff = int((got.long() - want.long()).abs().max())
            if diff:
                raise AssertionError(f"{label} at {rows} rows ({name}): "
                                     f"differs from miller_loop_plain (max "
                                     f"abs err {diff})")
            err = max(err, diff)
    log(f"K13 at {rows:,} rows: bit-identical to miller_loop_plain on "
        f"random, LMAX and real pairs with ∞ rows (the K4/K5 sequence and "
        f"the thread-per-row probe too)")
    p, q = pats["random"]
    ms = time_ms(lambda: cp.miller_loop(p, q))
    steps_ms = time_ms(lambda: cp.miller_steps(p, q), 3)
    bms, by = bound(miller_ops() * rows, rows * (3 + 4 + 12) * EL_BYTES,
                    sm_clocks_per_s)
    prog = mp.miller_program()
    probe = {"thread_per_row_ms": time_ms(lambda: cp.miller_thread(p, q), 3),
             "pp_mul014_ms": {}, "k13_ms": {}, "k13_lanes_ms": {}}
    for n in (132, 528, 1056, 2048, 4096, 8192):
        f, ln, pp = (limbs(dev, gen, (k, NL, n), "random") for k in (12, 6, 3))
        probe["pp_mul014_ms"][n] = time_ms(lambda: cp.pp_mul014(f, ln, pp))
    for n in (132, 1056, 2048, 8192):
        pn, qn = (limbs(dev, gen, (k, NL, n), "random") for k in (3, 4))
        probe["k13_ms"][n] = time_ms(lambda: cp.miller_loop(pn, qn), 3)
    probe["k13_ms"][rows] = ms
    for cfg in ((4, 52, 60), (mp.LANES, mp.SLOTS, mp.WINDOW), (16, 110, 100)):
        got = cp.miller_loop(p, q, *cfg)
        if not torch.equal(got, cp.miller_loop(p, q)):
            raise AssertionError(f"K13 with {cfg} differs from the default")
        probe["k13_lanes_ms"][str(cfg)] = (
            ms if cfg == (mp.LANES, mp.SLOTS, mp.WINDOW)
            else time_ms(lambda: cp.miller_loop(p, q, *cfg), 3))
    log(f"kernel miller_loop (K13, {mp.LANES} lanes a row, {mp.SLOTS} "
        f"slots, {prog.steps} steps, {prog.cost():,} instructions a lane "
        f"by the scheduler's count): {ms:.3f} ms at {rows:,} rows; the "
        f"198-launch K4/K5 sequence {steps_ms:.3f} ms "
        f"({steps_ms / ms:.2f}×); plain {plain_ms:.1f} ms; bound "
        f"{bms:.4f} ms by {by}")
    log(f"K13 probe: {json.dumps(probe)}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "rows": rows,
            "steps_ms": steps_ms, "lanes": mp.LANES, "slots": mp.SLOTS,
            "program_steps": prog.steps, "program_cost": prog.cost(),
            "probe": probe}


# ---------------------------------------------------------------------------
# Phase 3: the combine through SigAgg
# ---------------------------------------------------------------------------

def make_pool(dev, n: int, msg: bytes, seed: int):
    """n distinct signatures s·H(m) (96-byte compressed), made on the card
    through the port's curve.scalar_mul, plus their scalars."""
    from charon_tpu_torch.tbls.ref.fields import R
    from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2

    h = hash_to_g2(msg)
    rng = random.Random(seed)
    scalars = [rng.randrange(1, R) for _ in range(n)]
    return h, scalars, sigs_on_card(dev, h, scalars)


def sigs_on_card(dev, h, scalars) -> list[bytes]:
    """[s·H for s in scalars] as compressed bytes, computed on the card."""
    from charon_tpu_torch.ops import codec, curve as tcurve

    n = len(scalars)
    base = torch.from_numpy(tcurve.g2_pack([h])).to(dev).expand(
        3, 2, NL, n).contiguous()
    bits = torch.from_numpy(
        np.ascontiguousarray(tcurve.scalars_to_bits(scalars).T)).to(dev)
    pts = tcurve.scalar_mul(tcurve.F2_OPS, base, bits)
    xc0, xc1, yc0, yc1, inf = codec.g2_normalize(pts)
    comp = codec.g2_compress_np(*[a.cpu().numpy().T
                                  for a in (xc0, xc1, yc0, yc1)],
                                inf.cpu().numpy())
    return [comp[k].tobytes() for k in range(n)]


def oracle_combine(sigs: dict[int, bytes]) -> bytes:
    from charon_tpu_torch.tbls import shamir
    from charon_tpu_torch.tbls.ref import curve as rc

    lam = shamir.lagrange_coeffs_at_zero(list(sigs))
    acc = None
    for i, s in sigs.items():
        acc = rc.add(acc, rc.multiply(rc.g2_from_bytes(s, False), lam[i]))
    return rc.g2_to_bytes(acc)


async def sigagg_round(parsigs_by_pk: dict, threshold: int, slot: int):
    """One SigAgg.aggregate() per validator, all in one loop tick; returns
    ({pubkey: group signature}, combine launches on the pipeline)."""
    from charon_tpu_torch.core.sigagg import SigAgg
    from charon_tpu_torch.core.types import Duty, DutyType
    from charon_tpu_torch.tbls import dispatch

    agg = SigAgg(threshold)
    out = {}

    async def sub(duty, pk, signed):
        out[pk] = signed.signature

    agg.subscribe(sub)
    pipe = dispatch.default_pipeline()
    before = pipe.launches
    duty = Duty(slot, DutyType.RANDAO)
    await asyncio.gather(*[agg.aggregate(duty, pk, ps)
                           for pk, ps in parsigs_by_pk.items()])
    return out, pipe.launches - before


def parsigs_for(sig_sets: list[dict[int, bytes]], epoch: int) -> dict:
    from charon_tpu_torch.core.types import ParSignedData, SignedRandao

    return {f"0x{v:096x}": [ParSignedData(SignedRandao(epoch, s), i)
                            for i, s in sigs.items()]
            for v, sigs in enumerate(sig_sets)}


#: cuda_g2's kernels that no combine launches: K3 (K16 replaced its 609
#: launches), K10 (hash-to-G2's; K17 replaced dblsel there) and K2 (K22
#: replaced its 3 table launches)
COMBINE_PHASE_ONLY = ("straus_head", "straus_tail", "g2_dblsel",
                      "g2_addsel", "g2_dbl", "g2_add")
#: the combine's kernels: K12 decompresses, K22 builds the Straus tables,
#: K16 runs the window loop and K19 normalises; no K1 (K19 replaced the
#: normalisation's 397 launches)
COMBINE_PATH_KERNELS = ("g2_decompress", "g2_law", "straus_msm",
                        "g2_normalize")


def combine_phase(dev) -> tuple[dict, dict, list[bytes]]:
    """→ (launch counts of one combine rep, its stage p50s, the pool of
    1,024 signatures)."""
    from charon_tpu_torch.ops import cuda_codec, cuda_fp, cuda_g2
    from charon_tpu_torch.tbls import api, shamir
    from charon_tpu_torch.tbls.ref import curve as rc
    from charon_tpu_torch.tbls.ref.fields import FQ2, R

    v, t = VALIDATORS, SHARES
    backend = api._backend()        # the default: the cuda backend
    msg = b"charon-tpu-torch chip smoke: randao epoch 1"

    t0 = time.perf_counter()
    h, scalars, pool = make_pool(dev, 1024, msg, seed=1)
    for k in (0, 511, 1023):
        want = rc.g2_to_bytes(rc.multiply(h, scalars[k]))
        if pool[k] != want:
            raise AssertionError(f"pool row {k} != s·H(m)")
    log(f"pool: 1,024 signatures s·H(m) on the card in "
        f"{time.perf_counter() - t0:.2f} s (3 rows oracle-checked)")

    # real Shamir shares: V = 128 validators, 7 of 10 shares each, a
    # random 7-subset per validator
    t0 = time.perf_counter()
    rng = random.Random(7)
    nv = 128
    sks = [rng.randrange(1, R) for _ in range(nv)]
    subsets, share_vals = [], []
    for sk in sks:
        shares, _ = shamir.split_secret(sk, 7, 10, rng)
        idxs = sorted(rng.sample(range(1, 11), 7))
        subsets.append(idxs)
        share_vals += [shares[i] for i in idxs]
    part = sigs_on_card(dev, h, share_vals)
    sig_sets = [dict(zip(idxs, part[7 * k:7 * k + 7]))
                for k, idxs in enumerate(subsets)]
    got, launches = asyncio.run(sigagg_round(parsigs_for(sig_sets, 1), 7, 32))
    if launches != 1:
        raise AssertionError(f"Shamir round took {launches} combines")
    for k, sk in enumerate(sks):
        if got[f"0x{k:096x}"] != rc.g2_to_bytes(rc.multiply(h, sk)):
            raise AssertionError(f"validator {k}: combined != sk·H(m)")
    log(f"shamir: {nv} validators, random 7-of-10 subsets: every combined "
        f"signature == sk·H(m) ({time.perf_counter() - t0:.2f} s)")

    # malformed and off-curve signatures
    bad_flag = bytes([pool[0][0] & 0x7F]) + pool[0][1:]   # C flag cleared
    x = 1
    while (FQ2([x, 0]) ** 3 + rc.B2).sqrt() is not None:
        x += 1
    off_curve = bytes([0x80]) + bytes(47) + x.to_bytes(48, "big")
    good = {i: pool[i] for i in range(1, 8)}
    for label, batch in (
            ("malformed + off-curve", [good, {**good, 2: bad_flag},
                                       {**good, 3: off_curve}]),
            ("off-curve", [good, {**good, 3: off_curve}])):
        try:
            api.threshold_combine(batch)
        except ValueError as exc:
            log(f"reject: {label} batch raised ValueError ({exc})")
        else:
            raise AssertionError(f"{label} batch was accepted")

    # the main path: V validators × T shares through SigAgg, one tick
    gen = np.random.default_rng(3)
    pick = gen.integers(0, len(pool), (v, t))
    idxs = list(range(1, t + 1))
    sig_sets = [{i: pool[pick[r, k]] for k, i in enumerate(idxs)}
                for r in range(v)]
    parsigs = parsigs_for(sig_sets, 2)
    cuda_fp.reset_launches()
    cuda_g2.reset_launches()
    cuda_codec.reset_launches()
    runs = []
    launch_counts = stage_launches = None
    for rep in range(REPS):
        t0 = time.perf_counter()
        got, launches = asyncio.run(sigagg_round(parsigs, t, 64 + rep))
        wall = time.perf_counter() - t0
        if rep == 0:
            launch_counts = {k: n for k, n in {
                **cuda_fp.LAUNCHES, **cuda_g2.LAUNCHES,
                **cuda_codec.LAUNCHES}.items()
                if k not in COMBINE_PHASE_ONLY}
            replaced = {k: cuda_g2.LAUNCHES[k] for k in COMBINE_PHASE_ONLY
                        if cuda_g2.LAUNCHES[k]}
            if replaced:
                raise AssertionError(f"combine: kernels K16, K17 and K22 "
                                     f"replaced launched on the path: "
                                     f"{replaced}")
            stage_launches = backend.last_launches
        if launches != 1 or len(got) != v:
            raise AssertionError(f"rep {rep}: {launches} combines for "
                                 f"{len(got)} of {v} validators")
        runs.append({"wall_s": wall, **backend.last_stages})
        log(f"combine rep {rep}: {v} validators × {t}: {wall:.3f} s wall; "
            + ", ".join(f"{k} {val:.4f}" for k, val in
                        backend.last_stages.items()))
    for r in sorted(gen.choice(v, 4, replace=False).tolist()):
        if got[f"0x{r:096x}"] != oracle_combine(sig_sets[r]):
            raise AssertionError(f"row {r}: combine != oracle")
    log("combine: 4 random rows equal the pure-Python oracle")
    zero = [k for k in COMBINE_PATH_KERNELS if launch_counts[k] == 0]
    if zero:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{zero}")
    check_no_k1("combine", launch_counts)
    by_stage = {k: sum(st[k] for st in stage_launches.values())
                for k in launch_counts}
    if by_stage != launch_counts:
        raise AssertionError(f"stage launches {by_stage} do not add up to "
                             f"the combine's {launch_counts}")
    p50 = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    log("combine p50 over %d reps: %s" % (REPS, json.dumps(
        {k: round(val, 6) for k, val in p50.items()})))
    log("launches per combine: " + json.dumps(launch_counts))
    log("launches per stage: " + json.dumps(
        {st: {k: n for k, n in c.items() if n}
         for st, c in stage_launches.items()}))
    check_stage_launches("combine", stage_launches, "decompress_s",
                         {"g2_decompress": 1})
    check_stage_launches("combine", stage_launches, "tables_s",
                         {"g2_law": 1})
    check_stage_launches("combine", stage_launches, "straus_s",
                         {"straus_msm": 1})
    check_stage_launches("combine", stage_launches, "normalize_s",
                         {"g2_normalize": 1})
    return launch_counts, p50, pool


# ---------------------------------------------------------------------------
# Phase 4: batched verification through BatchVerifier
# ---------------------------------------------------------------------------

def oracle_verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """The pure-Python verdict on wire bytes (a decode failure is False)."""
    from charon_tpu_torch.tbls.ref import bls
    from charon_tpu_torch.tbls.ref import curve as rc

    try:
        return bls.verify(rc.g1_from_bytes(pk), msg, rc.g2_from_bytes(sig))
    except ValueError:
        return False


def sign_on_card(dev, bits: torch.Tensor, hms: np.ndarray) -> list[bytes]:
    """Row k: sk_k·H_k as compressed bytes, computed on the card (bits
    [256, v] the keys' bits on the card, hms [3, 2, 32, v] packed H(m))."""
    from charon_tpu_torch.ops import codec, curve as tcurve

    base = torch.from_numpy(np.ascontiguousarray(hms)).to(dev)
    xc0, xc1, yc0, yc1, inf = codec.g2_normalize(
        tcurve.scalar_mul(tcurve.F2_OPS, base, bits))
    sigs = codec.g2_compress_np(*[a.cpu().numpy().T
                                  for a in (xc0, xc1, yc0, yc1)],
                                inf.cpu().numpy())
    return [sigs[k].tobytes() for k in range(sigs.shape[0])]


def verify_pool(dev, backend):
    """VALIDATORS entries (pk, m_{k mod 64}, sk·H(m)): keys and signatures
    computed on the card through the port's curve and codec, H(m) through
    the backend's message cache (the 64 misses hashed on the card).
    Returns (entries, sks, the keys' bits on the card)."""
    from charon_tpu_torch.ops import codec, curve as tcurve
    from charon_tpu_torch.tbls.ref import bls
    from charon_tpu_torch.tbls.ref import curve as rc
    from charon_tpu_torch.tbls.ref.fields import R

    v = VALIDATORS
    rng = random.Random(11)
    sks = [rng.randrange(1, R) for _ in range(v)]
    msgs = [f"charon-tpu-torch chip smoke: slot 96 committee {c}".encode()
            for c in range(MESSAGES)]
    t0 = time.perf_counter()
    hms = backend._hash_points(msgs, {}, {})            # [3, 2, 32, 64]
    t_hash = time.perf_counter() - t0
    t0 = time.perf_counter()
    bits = torch.from_numpy(np.ascontiguousarray(
        tcurve.scalars_to_bits(sks).T)).to(dev)
    g1 = torch.from_numpy(tcurve.g1_pack([rc.G1_GEN])).to(dev).expand(
        3, NL, v).contiguous()
    x, y, inf = codec.g1_normalize(tcurve.scalar_mul(tcurve.FP_OPS, g1, bits))
    pks = codec.g1_compress_np(x.cpu().numpy().T, y.cpu().numpy().T,
                               inf.cpu().numpy())
    sigs = sign_on_card(dev, bits, hms[..., np.arange(v) % MESSAGES])
    entries = [(pks[k].tobytes(), msgs[k % MESSAGES], sigs[k])
               for k in range(v)]
    t_card = time.perf_counter() - t0
    for k in (0, v // 2, v - 1):
        pk, msg, sig = entries[k]
        if pk != rc.g1_to_bytes(bls.sk_to_pk(sks[k])) or \
                sig != rc.g2_to_bytes(bls.sign(sks[k], msg)):
            raise AssertionError(f"pool row {k}: pk or sig != the oracle's")
    log(f"verify pool: {v:,} keys and signatures over {MESSAGES} messages; "
        f"hash_to_g2 through the backend {t_hash:.2f} s, pk = sk·G1 and "
        f"sig = sk·H(m) on the card {t_card:.2f} s (3 rows oracle-checked)")
    return entries, sks, bits


async def verify_round(entries):
    """One BatchVerifier.verify_many in one tick → (verdicts, pipeline
    launches, tiles)."""
    from charon_tpu_torch.core.verify import BatchVerifier
    from charon_tpu_torch.tbls import dispatch

    verifier = BatchVerifier()
    pipe = dispatch.default_pipeline()
    before = (pipe.launches, pipe.tiles)
    oks = await verifier.verify_many(entries)
    return oks, pipe.launches - before[0], pipe.tiles - before[1]


def _wrapper_modules():
    from charon_tpu_torch.ops import (cuda_codec, cuda_final_exp, cuda_fp,
                                      cuda_g2, cuda_h2c, cuda_pairing)

    return (cuda_fp, cuda_g2, cuda_pairing, cuda_h2c, cuda_final_exp,
            cuda_codec)


def reset_all_launches() -> None:
    for mod in _wrapper_modules():
        mod.reset_launches()


def all_launches() -> dict:
    return {k: n for mod in _wrapper_modules()
            for k, n in mod.LAUNCHES.items()}


def check_stage_launches(label: str, stage_launches: dict, stage: str,
                         want: dict) -> None:
    """The launches of one stage are exactly `want` (K11 / K12 replaced
    the K1 chains of the final exponentiation and the decompression)."""
    got = {k: n for k, n in stage_launches.get(stage, {}).items() if n}
    if got != want:
        raise AssertionError(f"{label}: {stage} launched {got}, want {want}")


def check_redesigned_stages(label: str, stage_launches: dict,
                            tiles: int) -> None:
    """One K12 launch per tile in sig_decompress_s; one K20 launch per
    tile, and nothing else, in rlc_tables_s; one K15 launch per tile (the
    p-side's negation inside it) in rlc_scalar_mul_s; one K13 launch per
    tile, and nothing else, in miller_s; one K14 launch per tile, and
    nothing else, in fold_s; one K11 launch per tile (its verdict
    included) in final_exp_s; K5 F12MUL nowhere but in a re-check."""
    check_stage_launches(label, stage_launches, "sig_decompress_s",
                         {"g2_decompress": tiles})
    check_stage_launches(label, stage_launches, "rlc_tables_s",
                         {"g1_tables": tiles})
    check_stage_launches(label, stage_launches, "rlc_scalar_mul_s",
                         {"g1_scalar_mul": tiles})
    check_stage_launches(label, stage_launches, "miller_s",
                         {"miller_loop": tiles})
    check_stage_launches(label, stage_launches, "fold_s",
                         {"f12_fold": tiles})
    check_stage_launches(label, stage_launches, "final_exp_s",
                         {"final_exp": tiles})
    f12mul = {st: c["pp_f12mul"] for st, c in stage_launches.items()
              if st != "recheck_s" and c.get("pp_f12mul")}
    if f12mul:
        raise AssertionError(f"{label}: pp_f12mul launched outside the "
                             f"re-check: {f12mul}")


#: the verify path's pairing kernels; the K4/K5 step kernels K13 replaced
#: (and its thread-per-row probe) and the K6 window K15 replaced run only
#: in the kernel phases; K5 F12MUL only in a re-check
VERIFY_PAIRING_KERNELS = ("miller_loop", "f12_fold", "g1_scalar_mul",
                          "g1_tables")
PHASE_ONLY_KERNELS = ("pp_dbl", "pp_add", "pp_sqr", "pp_mul014",
                      "miller_thread", "g1_dblsel")


#: K7's four chain kernels, which K18 replaced on the path
K7_KERNELS = ("h2c_sqr", "h2c_mul", "h2c_sqr4", "h2c_sqr4mul")


def check_h2c_launches(label: str, h2c: dict, batches: int) -> None:
    """`batches` device hash batches in one h2c_s stage: per batch one K24
    launch (SSWU with its flags) and no K8, 2 K18 (the root with its exact
    tests, then the inversion and affine step), no K7, one K23 (the map's tail) and no K9, 2 K17
    launches ([|x|]R with [|x|]ψ(R), then [x²]R), no K10 window, 2 K22
    (the halves' sum with its double, ψ(R) and ψ²(2R), then the
    clearing's five additions) and no K2, one K19 (the normalisation) and
    no K1 (K18's epilogue and K23 took the exactness glue): 9 launches a
    batch."""
    k1 = ("fp_mul", "fp_add", "fp_sub", "fp_neg", "fp_mul_small")
    got = {k: h2c.get(k, 0) for k in ("h2c_sswu_head", "h2c_sswu",
                                      "f2_chain", "h2c_iso3", "h2c_psi",
                                      "h2c_map_tail", "g2_zmul",
                                      "g2_dblsel", "g2_law", "g2_normalize",
                                      *k1)}
    got["K7"] = sum(h2c.get(k, 0) for k in K7_KERNELS)
    got["g2_dbl+g2_add"] = h2c.get("g2_dbl", 0) + h2c.get("g2_add", 0)
    want = {"h2c_sswu_head": batches, "h2c_sswu": 0,
            "f2_chain": 2 * batches, "h2c_iso3": 0,
            "h2c_psi": 0, "h2c_map_tail": batches, "g2_zmul": 2 * batches,
            "g2_dblsel": 0, "g2_law": 2 * batches, "g2_normalize": batches,
            "K7": 0, "g2_dbl+g2_add": 0, **{k: 0 for k in k1}}
    if got != want:
        raise AssertionError(f"{label}: h2c_s launched {got}, want {want}")
    if sum(h2c.values()) != 9 * batches:
        raise AssertionError(f"{label}: h2c_s launched "
                             f"{sum(h2c.values())} kernels for {batches} "
                             f"batch(es), want 9 a batch: {h2c}")


def check_no_k1(label: str, counts: dict) -> None:
    """No K1 launch in a main-path run (a flush or the combine): K15, K11,
    K18, K22 and K23 took the last glue into their launches."""
    from charon_tpu_torch.ops import cuda_fp

    k1 = {k: counts.get(k, 0) for k in cuda_fp.LAUNCHES if counts.get(k)}
    if k1:
        raise AssertionError(f"{label}: K1 launched on the path: {k1}")


def check_recheck(label: str, stage_launches: dict) -> None:
    """The per-row re-check: one K1 negation of the unscaled p-side (a
    rejected tile only), one K13 launch over the unscaled rows, one K5
    product of the halves and one K11 with its verdicts."""
    got = {k: n for k, n in stage_launches["recheck_s"].items() if n}
    want = {"fp_neg": 1, "miller_loop": 1, "pp_f12mul": 1, "final_exp": 1}
    if got != want:
        raise AssertionError(f"{label}: recheck_s launched {got}, want "
                             f"{want}")


def check_stage_sums(label: str, counts: dict, stage_launches: dict) -> None:
    """Every launch of the run lands in exactly one stage of the thread
    that made it."""
    by_stage = {k: sum(st.get(k, 0) for st in stage_launches.values())
                for k in counts}
    if by_stage != counts:
        raise AssertionError(f"{label}: stage launches {by_stage} do not add "
                             f"up to the run's {counts}")


def bad_entries(entries, pool_rows):
    """The six kinds of bad entry of the reject run, made from good ones."""
    from charon_tpu_torch.ops import codec
    from charon_tpu_torch.tbls.ref import curve as rc

    (pk0, m0, s0), (pk1, m1, s1) = entries[pool_rows[0]], entries[
        pool_rows[1]]
    other_msg = next(m for _, m, _ in entries if m != m0)
    cof = rc.g2_to_bytes(codec._find_g2_cofactor_point())
    return [
        ("wrong_msg", (pk0, other_msg, s0)),
        ("other_key", (pk0, m1, s1)),
        ("bad_sig_bytes", (pk0, m0, bytes([s0[0] & 0x7F]) + s0[1:])),
        ("bad_pk_bytes", (bytes([pk0[0] & 0x7F]) + pk0[1:], m0, s0)),
        ("off_subgroup", (pk0, m0, cof)),
        ("short_pk", (pk0[:47], m0, s0)),
    ]


def verify_phase(dev):
    """→ (launch counts of one warm rep, of the cold run, the pool's
    pubkeys, sks and key bits on the card, its entries)."""
    from charon_tpu_torch.tbls import api, dispatch

    backend = api._backend()
    entries, sks, bits = verify_pool(dev, backend)
    tiles_want = len(dispatch.tile_sizes(VALIDATORS, dispatch.VERIFY_TILE))

    # the G1 decompress of every key alone, on the idle card, through a
    # second backend (its own, empty pubkey LRU)
    stages, stage_launches = {}, {}
    _, ok = type(backend)()._pk_planes_cached([pk for pk, _, _ in entries],
                                              stages, stage_launches)
    if not ok.all():
        raise AssertionError(f"{int((~ok).sum())} valid keys failed to "
                             f"decompress")
    check_stage_launches("pk decompress alone", stage_launches,
                         "pk_decompress_s", {"g1_decompress": 1})
    log(f"pk decompress alone: {VALIDATORS:,} keys, "
        f"{stages['pk_decompress_s']:.4f} s (CUDA events); launches "
        + json.dumps({k: n for k, n in
                      stage_launches['pk_decompress_s'].items() if n}))

    # cold: the pubkey LRU fills; each tile's misses decompress on the
    # host-prep thread's stream while the launch thread runs the tile
    # before, and every launch lands in the stage of the thread that made it
    backend.reset_verify_totals()
    reset_all_launches()
    t0 = time.perf_counter()
    oks, launches, tiles = asyncio.run(verify_round(entries))
    wall = time.perf_counter() - t0
    if not all(oks) or len(oks) != VALIDATORS:
        raise AssertionError(f"cold run: {oks.count(False)} of {len(oks)} "
                             f"valid entries rejected")
    cold_launches = all_launches()
    check_stage_sums("cold run", cold_launches, backend.verify_launch_totals)
    # every tile brings new keys: one K21 launch each, no K1 chain
    check_stage_launches("cold run", backend.verify_launch_totals,
                         "pk_decompress_s", {"g1_decompress": tiles})
    WALLS["bytes"]["cold"] = wall
    log(f"verify cold: {VALIDATORS:,} entries, {tiles} tiles, {wall:.3f} s "
        f"wall; pk_decompress_s "
        f"{backend.verify_totals['pk_decompress_s']:.4f} summed over tiles, "
        f"overlapping the tiles' device work "
        f"({backend.pk_cache_misses:,} key misses); " + ", ".join(
            f"{k} {val:.4f}" for k, val in backend.verify_totals.items()))
    log("verify cold launches per stage: " + json.dumps(
        {st: {k: n for k, n in c.items() if n}
         for st, c in backend.verify_launch_totals.items()}))

    # timed: warm caches, one pipeline launch of 5 tiles per rep
    runs, launch_counts, stage_launches = [], None, None
    for rep in range(REPS):
        backend.reset_verify_totals()
        reset_all_launches()
        t0 = time.perf_counter()
        oks, launches, tiles = asyncio.run(verify_round(entries))
        wall = time.perf_counter() - t0
        if rep == 0:
            launch_counts = all_launches()
            stage_launches = {k: dict(c) for k, c in
                              backend.verify_launch_totals.items()}
        if not all(oks) or launches != 1 or tiles != tiles_want:
            raise AssertionError(
                f"verify rep {rep}: {oks.count(False)} rejected, {launches} "
                f"pipeline launches, {tiles} tiles (want 1, {tiles_want})")
        if "recheck_s" in backend.verify_totals:
            raise AssertionError(f"verify rep {rep}: an all-valid flush "
                                 f"took the per-row re-check")
        runs.append({"wall_s": wall, **backend.verify_totals})
        log(f"verify rep {rep}: {VALIDATORS:,} entries, {tiles} tiles: "
            f"{wall:.3f} s wall; " + ", ".join(
                f"{k} {val:.4f}" for k, val in backend.verify_totals.items()))
    zero = [k for k in (*VERIFY_PAIRING_KERNELS, "final_exp",
                        "g2_decompress") if launch_counts[k] == 0]
    if zero:
        raise AssertionError(f"kernels never launched on the verify path: "
                             f"{zero}")
    steps = {k: launch_counts[k] for k in PHASE_ONLY_KERNELS
             if launch_counts[k]}
    if steps:
        raise AssertionError(f"verify: kernels K13 replaced launched on the "
                             f"path: {steps}")
    check_stage_sums("verify", launch_counts, stage_launches)
    check_redesigned_stages("verify", stage_launches, tiles_want)
    check_no_k1("verify", launch_counts)
    check_no_k1("verify cold", cold_launches)
    redesigned = statistics.median(r["final_exp_s"] + r["sig_decompress_s"]
                                   for r in runs)
    log(f"verify: no K1 launch in the warm or cold flush; final_exp_s + "
        f"sig_decompress_s p50 over the tiles {redesigned:.6f} s")
    p50 = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    WALLS["bytes"]["warm"] = p50["wall_s"]
    log("verify p50 over %d reps (stages summed over tiles): %s" % (
        REPS, json.dumps({k: round(val, 6) for k, val in p50.items()})))
    log("verify launches per flush: " + json.dumps(
        {k: n for k, n in launch_counts.items() if n}))
    log("verify launches per stage: " + json.dumps(
        {st: {k: n for k, n in c.items() if n}
         for st, c in stage_launches.items()}))

    # reject: one tile with 6 bad rows; verdicts equal the oracle's
    gen = np.random.default_rng(5)
    batch = list(entries[:dispatch.VERIFY_TILE])
    bad_rows = sorted(gen.choice(len(batch), 6, replace=False).tolist())
    good_rows = [r for r in range(len(batch)) if r not in bad_rows]
    for (kind, entry), r in zip(bad_entries(batch, good_rows[:2]), bad_rows):
        batch[r] = entry
    backend.reset_verify_totals()
    t0 = time.perf_counter()
    oks, launches, tiles = asyncio.run(verify_round(batch))
    wall = time.perf_counter() - t0
    rejected = [r for r, ok in enumerate(oks) if not ok]
    if rejected != bad_rows:
        raise AssertionError(f"reject run: rows {rejected} rejected, want "
                             f"{bad_rows}")
    check_recheck("reject run", backend.verify_launch_totals)
    sample = bad_rows + sorted(gen.choice(good_rows, 4,
                                          replace=False).tolist())
    t1 = time.perf_counter()
    for r in sample:
        if oracle_verify(*batch[r]) != oks[r]:
            raise AssertionError(f"reject run row {r}: verdict {oks[r]} != "
                                 f"the oracle's")
    log(f"verify reject: {len(batch):,} entries, 6 bad rows {bad_rows} "
        f"rejected, every other row accepted; {len(sample)} rows equal the "
        f"pure-Python oracle ({time.perf_counter() - t1:.1f} s); "
        f"{wall:.3f} s wall, recheck_s "
        f"{backend.verify_totals['recheck_s']:.4f}; launches per stage "
        + json.dumps({st: {k: n for k, n in c.items() if n}
                      for st, c in backend.verify_launch_totals.items()}))
    return (launch_counts, cold_launches, [pk for pk, _, _ in entries], sks,
            bits, entries)


def verify_slot_start_phase(dev, pks: list[bytes], sks: list[int],
                            bits: torch.Tensor) -> dict:
    """The slot's first flush: the warm flush's 10,000 keys over MESSAGES
    messages that are new each rep (the next slot's attestation data), so
    the message LRU misses every one and the first tile hashes them on the
    card as one batch on the prep thread.  Signatures made on the card
    over H(m) from the device pipeline (the LRU emptied after), one row
    oracle-checked.  All verdicts True; one device hash batch with 2 K17
    launches and no K10; p50 of REPS reps.  → the launch counts of one
    rep."""
    from charon_tpu_torch.tbls import api, dispatch
    from charon_tpu_torch.tbls.ref import bls
    from charon_tpu_torch.tbls.ref import curve as rc

    backend = api._backend()
    v = VALIDATORS
    tiles_want = len(dispatch.tile_sizes(v, dispatch.VERIFY_TILE))
    runs, launch_counts, stage_launches = [], None, None
    for rep in range(REPS):
        msgs = [f"charon-tpu-torch chip smoke: slot {97 + rep} committee "
                f"{c}".encode() for c in range(MESSAGES)]
        hms = backend._hash_points(msgs, {}, {})
        sigs = sign_on_card(dev, bits, hms[..., np.arange(v) % MESSAGES])
        entries = [(pks[k], msgs[k % MESSAGES], sigs[k]) for k in range(v)]
        if rep == 0 and sigs[1] != rc.g2_to_bytes(bls.sign(sks[1], msgs[1])):
            raise AssertionError("slot-start row 1: sig != the oracle's")
        backend._hm_cache.clear()
        backend.reset_verify_totals()
        reset_all_launches()
        t0 = time.perf_counter()
        oks, launches, tiles = asyncio.run(verify_round(entries))
        wall = time.perf_counter() - t0
        if rep == 0:
            launch_counts = all_launches()
            stage_launches = {k: dict(c) for k, c in
                              backend.verify_launch_totals.items()}
        if not all(oks) or launches != 1 or tiles != tiles_want:
            raise AssertionError(
                f"slot-start rep {rep}: {oks.count(False)} rejected, "
                f"{launches} pipeline launches, {tiles} tiles")
        check_h2c_launches(f"slot-start rep {rep}",
                           backend.verify_launch_totals.get("h2c_s", {}), 1)
        if len(backend._hm_cache) != MESSAGES:
            raise AssertionError(f"slot-start rep {rep}: "
                                 f"{len(backend._hm_cache)} messages cached")
        runs.append({"wall_s": wall, **backend.verify_totals})
        log(f"slot-start rep {rep}: {v:,} entries, {MESSAGES} new messages, "
            f"{tiles} tiles: {wall:.3f} s wall; " + ", ".join(
                f"{k} {val:.4f}" for k, val in backend.verify_totals.items()))
    check_stage_sums("slot-start", launch_counts, stage_launches)
    check_redesigned_stages("slot-start", stage_launches, tiles_want)
    check_no_k1("slot-start", launch_counts)
    p50 = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    WALLS["bytes"]["slot_start"] = p50["wall_s"]
    log("slot-start p50 over %d reps (stages summed over tiles): %s" % (
        REPS, json.dumps({k: round(val, 6) for k, val in p50.items()})))
    log("slot-start launches per stage: " + json.dumps(
        {st: {k: n for k, n in c.items() if n}
         for st, c in stage_launches.items()}))
    return launch_counts


# ---------------------------------------------------------------------------
# Phase 5: the device hash-to-G2 against its plain pipeline and the oracle
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper the h2c pipeline and its normalisation reach
    (K1, K2, K7–K9, K17–K19, K22–K24) replaced by its plain version, on
    any device."""
    from charon_tpu_torch.ops import cuda_codec, cuda_fp, cuda_g2, fp
    from charon_tpu_torch.ops import cuda_h2c as ch
    from charon_tpu_torch.ops import miller_program as mp

    def law_plain(kind, block, cfg=None):
        return mp.law_run_plain(mp.law_program(kind), block)

    def map_tail_plain(aff, ok1, sgn, cfg=None):
        return ch.map_tail_plain(aff, ok1, sgn, mp.map_tail_program(cfg))

    def sswu_head_plain(u, cfg=None):
        return ch.sswu_head_plain(u, mp.sswu_program(cfg))

    swaps = [(ch, {"h2c_sqr": ch.sqr_plain, "h2c_mul": ch.mul_plain,
                   "h2c_sqr4": ch.sqr4_plain, "h2c_sqr4mul": ch.sqr4mul_plain,
                   "h2c_sswu": ch.sswu_plain, "h2c_iso3": ch.iso3_plain,
                   "h2c_psi": ch.psi_plain, "_run_chain": ch.chain_plain,
                   "h2c_map_tail": map_tail_plain,
                   "h2c_sswu_head": sswu_head_plain}),
             (ch, {"zmul": ch.zmul_plain}),
             (cuda_codec, {"g2_normalize": cuda_codec.g2_normalize_plain}),
             (cuda_g2, {"dbl": cuda_g2.dbl_plain, "add": cuda_g2.add_plain,
                        "dblsel": cuda_g2.dblsel_plain,
                        "g2_law": law_plain}),
             (cuda_fp, {"mul": fp.mul_plain, "add": fp.add_plain,
                        "sub": fp.sub_plain, "neg": fp.neg_plain,
                        "mul_small": fp.mul_small_plain})]
    saved = [(mod, {k: getattr(mod, k) for k in fns}) for mod, fns in swaps]
    try:
        for mod, fns in swaps:
            for k, fn in fns.items():
                setattr(mod, k, fn)
        yield
    finally:
        for mod, fns in saved:
            for k, fn in fns.items():
                setattr(mod, k, fn)


def distinct_messages(n: int) -> list[bytes]:
    """The distinct-message flush's messages, one per validator."""
    return [f"charon-tpu-torch chip smoke: selection proof slot 96 "
            f"validator {k}".encode() for k in range(n)]


def pack_messages_timing(n: int) -> None:
    """Time the host half of hashing alone: `pack_messages` of the distinct
    flush's first n messages, then its two parts apart (hash_to_field,
    the limb split)."""
    from charon_tpu_torch.ops import cuda_h2c
    from charon_tpu_torch.tbls.ref.hash_to_curve import (DST_G2,
                                                         hash_to_field_fp2)

    msgs = distinct_messages(n)
    t0 = time.perf_counter()
    u = cuda_h2c.pack_messages(msgs)
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    pairs = [hash_to_field_fp2(msg, 2, DST_G2) for msg in msgs]
    t_field = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = cuda_h2c._pack_u([p[0] for p in pairs] + [p[1] for p in pairs])
    t_split = time.perf_counter() - t0
    if not np.array_equal(u, again):
        raise AssertionError("pack_messages: the parts differ from the whole")
    log(f"pack_messages alone: {n:,} messages in {t_pack:.4f} s "
        f"({t_pack / n * 1e6:.1f} µs a message): hash_to_field "
        f"{t_field:.4f} s, limb split {t_split:.4f} s")


def h2c_phase(dev, batch: int) -> np.ndarray:
    """One batch of the first `batch` messages of the distinct flush:
    kernels vs the plain pipeline on the card, normalised points vs the
    oracle, timed alone, and small batches against the host hash (the
    size rule's crossover).  → the plain pipeline's packed affine H(m)
    [3, 2, 32, batch]."""
    from charon_tpu_torch.ops import cuda_g2, cuda_h2c, curve as tcurve
    from charon_tpu_torch.tbls import backend_cuda
    from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2

    msgs = distinct_messages(batch)
    pack_messages_timing(VALIDATORS)
    t0 = time.perf_counter()
    u_np = cuda_h2c.pack_messages(msgs)
    t_pack = time.perf_counter() - t0
    u = torch.from_numpy(u_np).to(dev)
    got = cuda_h2c.hash_to_g2_rows(u)
    t0 = time.perf_counter()
    with plain_kernels():
        want = cuda_h2c.hash_to_g2_rows(u)
        plain_planes = backend_cuda._affine_planes(
            cuda_g2.as_points(want)).cpu().numpy()
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).any(dim=0).any(dim=0).sum())
        raise AssertionError(f"h2c pipeline: {bad} of {batch} rows differ "
                             f"from the plain pipeline on the card")
    log(f"h2c: {batch:,} messages through the device pipeline equal the "
        f"plain pipeline on the card in every row (plain {t_plain:.1f} s); "
        f"pack_messages {t_pack:.4f} s on the host")

    # timed alone on the idle card, through the backend's stage
    be = backend_cuda.CUDABackend()
    runs = []
    for rep in range(1 + REPS):
        reset_all_launches()
        stages, launches = {}, {}
        planes = be._hash_on_card(msgs, stages, launches)
        if rep == 0:
            counts = all_launches()
            check_stage_sums("h2c batch", counts, launches)
            check_h2c_launches("h2c batch", launches["h2c_s"], 1)
        else:
            runs.append(stages)
    rng = random.Random(13)
    sample = sorted(rng.sample(range(batch), H2C_ORACLE_SAMPLES))
    t0 = time.perf_counter()
    for k in sample:
        if not np.array_equal(planes[..., k],
                              tcurve.g2_pack([hash_to_g2(msgs[k])])[..., 0]):
            raise AssertionError(f"h2c message {k}: != the oracle's H(m)")
    # the same pipeline under the J.10.1 suite's DST
    pts = cuda_h2c.hash_to_g2_rows(torch.from_numpy(
        cuda_h2c.pack_messages(J101_MSGS, J101_DST)).to(dev))
    jp = backend_cuda._affine_planes(cuda_g2.as_points(pts)).cpu().numpy()
    for k, msg in enumerate(J101_MSGS):
        if not np.array_equal(jp[..., k], tcurve.g2_pack(
                [hash_to_g2(msg, J101_DST)])[..., 0]):
            raise AssertionError(f"J.10.1 message {msg[:8]!r}: != the "
                                 f"oracle's H(m)")
    log(f"h2c: {H2C_ORACLE_SAMPLES} sampled messages and the 5 RFC 9380 "
        f"J.10.1 messages (QUUX DST) equal the pure-Python hash_to_g2 "
        f"({time.perf_counter() - t0:.1f} s)")
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    log(f"h2c alone: {batch:,} messages, median of {REPS}: h2c_s "
        f"{med['h2c_s']:.6f} s (CUDA events), h2c_host_s "
        f"{med['h2c_host_s']:.6f} s; reps h2c_s "
        + ", ".join(f"{r['h2c_s']:.6f}" for r in runs) + "; launches "
        + json.dumps({k: n for k, n in counts.items() if n})
        + f" ({sum(counts.values())} in all)")

    # the size rule (fewer than H2C_MIN_BATCH misses hash on the host): a
    # small batch on the card, wall time from the messages to the packed
    # points, against the pure-Python hash of one message
    small = {}
    for m in (1, backend_cuda.H2C_MIN_BATCH - 1):
        walls, devs = [], []
        for _ in range(REPS):
            stages = {}
            t0 = time.perf_counter()
            be._hash_on_card(msgs[:m], stages, {})
            walls.append(time.perf_counter() - t0)
            devs.append(stages["h2c_s"])
        small[m] = (statistics.median(walls), statistics.median(devs))
    host = []
    for k in range(REPS):
        t0 = time.perf_counter()
        hash_to_g2(msgs[k])
        host.append(time.perf_counter() - t0)
    sizes = "; of ".join(f"{m} message(s) {w:.6f} s wall (h2c_s {d:.6f})"
                         for m, (w, d) in small.items())
    log(f"h2c size rule, median of {REPS}: a card batch of {sizes}; the "
        f"host hash_to_g2 {statistics.median(host):.6f} s per message")
    return plain_planes


# ---------------------------------------------------------------------------
# Phase 6: a flush of 10,000 distinct messages
# ---------------------------------------------------------------------------

H2C_PATH_KERNELS = ("h2c_sswu_head", "f2_chain", "h2c_map_tail", "g2_zmul",
                    "g2_law", "g2_normalize")


def verify_distinct_phase(dev, pks: list[bytes], sks: list[int],
                          bits: torch.Tensor,
                          plain_planes: np.ndarray) -> dict:
    """`plain_planes`: the plain pipeline's H(m) of the flush's first
    messages (`h2c_phase`).  → the launch counts of one rep of the
    distinct-message flush."""
    from charon_tpu_torch.tbls import api, dispatch
    from charon_tpu_torch.tbls.ref import bls
    from charon_tpu_torch.tbls.ref import curve as rc

    backend = api._backend()
    v = VALIDATORS
    msgs = distinct_messages(v)
    t0 = time.perf_counter()
    stages = {}
    hms = backend._hash_points(msgs, stages, {})
    t_hash = time.perf_counter() - t0
    # the signatures are made over these H(m) and the verify hashes the
    # messages again through the same kernels: hold the first tile's rows
    # against the plain pipeline, so a fault both hashes share shows
    t = plain_planes.shape[-1]
    if not np.array_equal(hms[..., :t], plain_planes):
        bad = int((hms[..., :t] != plain_planes).reshape(-1, t).any(0).sum())
        raise AssertionError(f"distinct pool: {bad} of the first {t} H(m) "
                             f"differ from the plain pipeline's")
    t0 = time.perf_counter()
    sigs = sign_on_card(dev, bits, hms)
    entries = [(pks[k], msgs[k], sigs[k]) for k in range(v)]
    t_sign = time.perf_counter() - t0
    for k in (0, v - 1):
        if sigs[k] != rc.g2_to_bytes(bls.sign(sks[k], msgs[k])):
            raise AssertionError(f"distinct pool row {k}: sig != the "
                                 f"oracle's")
    log(f"distinct pool: {v:,} messages hashed on the card in {t_hash:.2f} s "
        f"(h2c_host_s {stages['h2c_host_s']:.4f}, h2c_s "
        f"{stages['h2c_s']:.4f}), the first {t:,} equal to the plain "
        f"pipeline's; signed on the card in {t_sign:.2f} s (2 rows "
        f"oracle-checked)")

    tiles_want = len(dispatch.tile_sizes(v, dispatch.VERIFY_TILE))
    runs, launch_counts, stage_launches = [], None, None
    for rep in range(REPS):
        backend._hm_cache.clear()
        misses0 = backend.hm_cache_misses
        backend.reset_verify_totals()
        reset_all_launches()
        t0 = time.perf_counter()
        oks, launches, tiles = asyncio.run(verify_round(entries))
        wall = time.perf_counter() - t0
        if rep == 0:
            launch_counts = all_launches()
            stage_launches = {k: dict(c) for k, c in
                              backend.verify_launch_totals.items()}
        if not all(oks) or launches != 1 or tiles != tiles_want:
            raise AssertionError(
                f"distinct rep {rep}: {oks.count(False)} rejected, "
                f"{launches} pipeline launches, {tiles} tiles")
        h2c = backend.verify_launch_totals.get("h2c_s", {})
        if backend.hm_cache_misses - misses0 != v or \
                h2c.get("h2c_sswu_head", 0) != tiles:
            raise AssertionError(
                f"distinct rep {rep}: {backend.hm_cache_misses - misses0} "
                f"message misses, {h2c.get('h2c_sswu_head', 0)} device h2c "
                f"batches for {tiles} tiles")
        if "recheck_s" in backend.verify_totals:
            raise AssertionError(f"distinct rep {rep}: an all-valid flush "
                                 f"took the per-row re-check")
        runs.append({"wall_s": wall, **backend.verify_totals})
        log(f"distinct rep {rep}: {v:,} entries, {v:,} distinct messages, "
            f"{tiles} tiles: {wall:.3f} s wall; " + ", ".join(
                f"{k} {val:.4f}" for k, val in backend.verify_totals.items()))
    zero = [k for k in H2C_PATH_KERNELS if launch_counts[k] == 0]
    if zero:
        raise AssertionError(f"h2c kernels never launched on the distinct "
                             f"flush: {zero}")
    check_stage_sums("distinct", launch_counts, stage_launches)
    check_redesigned_stages("distinct", stage_launches, tiles_want)
    check_h2c_launches("distinct", stage_launches["h2c_s"], tiles_want)
    check_no_k1("distinct", launch_counts)
    p50 = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    WALLS["bytes"]["distinct"] = p50["wall_s"]
    log("distinct p50 over %d reps (stages summed over tiles): %s" % (
        REPS, json.dumps({k: round(val, 6) for k, val in p50.items()})))
    log("distinct launches per flush: " + json.dumps(
        {k: n for k, n in launch_counts.items() if n}))
    log("distinct launches per stage: " + json.dumps(
        {st: {k: n for k, n in c.items() if n}
         for st, c in stage_launches.items()}))

    # reject: 4 entries carry the next entry's message
    gen = np.random.default_rng(17)
    batch = list(entries[:dispatch.VERIFY_TILE])
    bad_rows = sorted(gen.choice(len(batch) - 1, 4, replace=False).tolist())
    for r in bad_rows:
        pk, _, sig = batch[r]
        batch[r] = (pk, entries[r + 1][1], sig)
    backend._hm_cache.clear()
    backend.reset_verify_totals()
    t0 = time.perf_counter()
    oks, _, _ = asyncio.run(verify_round(batch))
    wall = time.perf_counter() - t0
    rejected = [r for r, ok in enumerate(oks) if not ok]
    if rejected != bad_rows:
        raise AssertionError(f"distinct reject: rows {rejected} rejected, "
                             f"want {bad_rows}")
    check_recheck("distinct reject", backend.verify_launch_totals)
    good = [r for r in range(len(batch)) if r not in bad_rows]
    sample = bad_rows + sorted(gen.choice(good, 2, replace=False).tolist())
    for r in sample:
        if oracle_verify(*batch[r]) != oks[r]:
            raise AssertionError(f"distinct reject row {r}: verdict "
                                 f"{oks[r]} != the oracle's")
    log(f"distinct reject: {len(batch):,} entries, 4 swapped-message rows "
        f"{bad_rows} rejected, every other row accepted; {len(sample)} rows "
        f"equal the pure-Python oracle; {wall:.3f} s wall; " + ", ".join(
            f"{k} {val:.4f}" for k, val in backend.verify_totals.items()))
    return launch_counts


# ---------------------------------------------------------------------------
# Phase 7: the resident route — device stores, a verify tile as one CUDA
# graph, prewarm
# ---------------------------------------------------------------------------

#: the verify tile's kernels: each launched once a replay of its graph
GRAPH_KERNELS = ("g2_decompress", "g1_tables", "g1_scalar_mul",
                 "miller_loop", "f12_fold", "final_exp")
#: the resident route's stages that may launch kernels
RESIDENT_STAGES = ("graph_s", "pk_decompress_s", "h2c_s", "recheck_s")


def check_graph_stage(label: str, stage_launches: dict, tiles: int) -> None:
    """graph_s holds the tile's six kernels once a replay (counted from
    the captured launches) and nothing else; the stores' gathers launch
    nothing; no stage outside the tile, the misses and a re-check
    launches."""
    check_stage_launches(label, stage_launches, "graph_s",
                         {k: tiles for k in GRAPH_KERNELS})
    stray = {st: {k: n for k, n in c.items() if n}
             for st, c in stage_launches.items()
             if st not in RESIDENT_STAGES and any(c.values())}
    if stray:
        raise AssertionError(f"{label}: launches outside the resident "
                             f"stages: {stray}")


def resident_flush(backend, entries, label: str) -> tuple[dict, dict, dict]:
    """One verify_many of `entries` on the resident route, all verdicts
    True → (wall and stages, the run's launch counts, its stage
    launches)."""
    from charon_tpu_torch.tbls import dispatch

    tiles_want = len(dispatch.tile_sizes(len(entries), dispatch.VERIFY_TILE))
    backend.reset_verify_totals()
    reset_all_launches()
    # the device-to-host copies the launch thread makes: one a tile
    readbacks = []
    real_cpu = torch.Tensor.cpu

    def counted_cpu(t, *args, **kwargs):
        if threading.current_thread().name.startswith("charon-cuda-launch"):
            readbacks.append(tuple(t.shape))
        return real_cpu(t, *args, **kwargs)

    torch.Tensor.cpu = counted_cpu
    try:
        t0 = time.perf_counter()
        oks, launches, tiles = asyncio.run(verify_round(entries))
        wall = time.perf_counter() - t0
    finally:
        torch.Tensor.cpu = real_cpu
    counts = all_launches()
    stage_launches = {k: dict(c) for k, c in
                      backend.verify_launch_totals.items()}
    if not all(oks) or launches != 1 or tiles != tiles_want:
        raise AssertionError(f"{label}: {oks.count(False)} rejected, "
                             f"{launches} pipeline launches, {tiles} tiles")
    check_stage_sums(label, counts, stage_launches)
    check_graph_stage(label, stage_launches, tiles)
    check_no_k1(label, counts)
    if len(readbacks) != tiles:
        raise AssertionError(f"{label}: {len(readbacks)} readbacks on the "
                             f"launch thread for {tiles} tiles: {readbacks}")
    run = {"wall_s": wall, **backend.verify_totals}
    log(f"{label}: {len(entries):,} entries, {tiles} tiles ({tiles} graph "
        f"replays, {len(readbacks)} readbacks of {readbacks[0]}): "
        f"{wall:.3f} s wall; " + ", ".join(
            f"{k} {val:.4f}" for k, val in backend.verify_totals.items()))
    return run, counts, stage_launches


def hm_rows_equal_oracle(backend, msgs: list[bytes], label: str) -> None:
    """Rows of the message store against the pure-Python H(m)."""
    import hashlib

    from charon_tpu_torch.ops import curve as tcurve
    from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2

    _, hm = backend._dev_caches()
    _, _, missing, rows = hm.lookup_rows([hashlib.sha256(m).digest()
                                          for m in msgs])
    want = tcurve.g2_pack([hash_to_g2(m) for m in msgs])
    if missing or not np.array_equal(
            rows.view(3, 2, NL, len(msgs)).cpu().numpy(), want):
        raise AssertionError(f"{label}: message store rows != the oracle's "
                             f"H(m) ({len(missing)} missing)")


def resident_phase(dev, entries, bits: torch.Tensor) -> dict:
    """The resident route on a fresh backend: prewarm with the pool's
    10,000 pubshares at V = 10,000, T = 7 (its report and the stores'
    bytes), a cold-after-prewarm flush (no key miss, no K21), REPS warm
    and slot-start flushes, a cold flush, one reject tile, REPS distinct
    flushes (last: they empty the message store), and a backend with
    2,048-row stores over two flushes (evictions, every verdict right).
    → the launch counts of each flush kind's first run."""
    from charon_tpu_torch.tbls import api, backend_cuda, dispatch

    bytes_be = api._backend()
    res = backend_cuda.CUDABackend(resident=True)
    api.register_backend("cuda", res)
    v = VALIDATORS
    tiles = len(dispatch.tile_sizes(v, dispatch.VERIFY_TILE))
    pks = [pk for pk, _, _ in entries]
    counts: dict[str, dict] = {}

    # prewarm, on the pipeline's prewarm thread
    async def prewarm():
        return await dispatch.default_pipeline().prewarm(pks, v, SHARES)

    t0 = time.perf_counter()
    report = asyncio.run(prewarm())
    t_prewarm = time.perf_counter() - t0
    stats = res.devcache_stats()
    bucket = api.verify_padded_rows(dispatch.VERIFY_TILE)
    if stats["pk"]["rows"] != v or \
            f"resident:rlc:v={bucket}" not in report["graph_keys"] or \
            not report["verify_path"].endswith("+res"):
        raise AssertionError(f"prewarm: {report}, {stats}")
    log(f"prewarm: {t_prewarm:.3f} s; report " + json.dumps(report))
    log("resident stores after prewarm: " + json.dumps(
        {k: stats[k] for k in ("pk", "hm")}) + f"; torch allocated "
        f"{torch.cuda.memory_allocated(dev):,} B")

    # cold after prewarm: the flush's 64 messages are in the message store
    # (the bytes route's cold flush finds them in its LRU); no key misses
    msgs = [entries[k][1] for k in range(MESSAGES)]
    with res._prep_context():
        res._hm_rows_resident(msgs, {}, {})
    pk_misses = res._pk_dev.misses
    run, counts["cold_after_prewarm"], _ = resident_flush(
        res, entries, "resident cold after prewarm")
    if res._pk_dev.misses != pk_misses or \
            counts["cold_after_prewarm"]["g1_decompress"]:
        raise AssertionError(
            f"cold after prewarm: {res._pk_dev.misses - pk_misses} key "
            f"misses, {counts['cold_after_prewarm']['g1_decompress']} K21")
    WALLS["resident"]["cold_after_prewarm"] = run["wall_s"]

    # warm
    runs = []
    for rep in range(REPS):
        run, c, _ = resident_flush(res, entries, f"resident warm rep {rep}")
        runs.append(run)
        counts.setdefault("warm", c)
    p50 = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    WALLS["resident"]["warm"] = p50["wall_s"]
    log("resident warm p50 over %d reps: %s" % (
        REPS, json.dumps({k: round(val, 6) for k, val in p50.items()})))

    # slot-start: 64 new messages each rep, one device hash batch
    runs = []
    for rep in range(REPS):
        news = [f"charon-tpu-torch chip smoke: resident slot {300 + rep} "
                f"committee {c}".encode() for c in range(MESSAGES)]
        hms = bytes_be._hash_points(news, {}, {})
        sigs = sign_on_card(dev, bits, hms[..., np.arange(v) % MESSAGES])
        run, c, st = resident_flush(
            res, [(pks[k], news[k % MESSAGES], sigs[k]) for k in range(v)],
            f"resident slot-start rep {rep}")
        check_h2c_launches(f"resident slot-start rep {rep}",
                           st.get("h2c_s", {}), 1)
        runs.append(run)
        if rep == 0:
            counts["slot_start"] = c
            hm_rows_equal_oracle(res, news[:2], "resident slot-start")
    WALLS["resident"]["slot_start"] = statistics.median(
        r["wall_s"] for r in runs)

    # cold: the pubkey store emptied; one K21 launch a tile
    res._pk_dev.clear()
    run, counts["cold"], st = resident_flush(res, entries, "resident cold")
    check_stage_launches("resident cold", st, "pk_decompress_s",
                         {"g1_decompress": tiles})
    WALLS["resident"]["cold"] = run["wall_s"]

    # reject: one tile with 6 bad rows; verdicts equal the oracle's
    gen = np.random.default_rng(23)
    batch = list(entries[:dispatch.VERIFY_TILE])
    bad_rows = sorted(gen.choice(len(batch), 6, replace=False).tolist())
    good_rows = [r for r in range(len(batch)) if r not in bad_rows]
    for (_, entry), r in zip(bad_entries(batch, good_rows[:2]), bad_rows):
        batch[r] = entry
    res.reset_verify_totals()
    t0 = time.perf_counter()
    oks, _, _ = asyncio.run(verify_round(batch))
    wall = time.perf_counter() - t0
    rejected = [r for r, ok in enumerate(oks) if not ok]
    if rejected != bad_rows:
        raise AssertionError(f"resident reject: rows {rejected} rejected, "
                             f"want {bad_rows}")
    check_recheck("resident reject", res.verify_launch_totals)
    check_graph_stage("resident reject", res.verify_launch_totals, 1)
    sample = bad_rows + sorted(gen.choice(good_rows, 2,
                                          replace=False).tolist())
    for r in sample:
        if oracle_verify(*batch[r]) != oks[r]:
            raise AssertionError(f"resident reject row {r}: verdict "
                                 f"{oks[r]} != the oracle's")
    log(f"resident reject: 6 bad rows {bad_rows} rejected exactly, "
        f"{len(sample)} rows equal the oracle; {wall:.3f} s wall; "
        + ", ".join(f"{k} {val:.4f}"
                    for k, val in res.verify_totals.items()))

    # distinct: the message store emptied before each rep
    dmsgs = distinct_messages(v)
    sigs = sign_on_card(dev, bits, bytes_be._hash_points(dmsgs, {}, {}))
    distinct = [(pks[k], dmsgs[k], sigs[k]) for k in range(v)]
    runs = []
    for rep in range(REPS):
        res._hm_dev.clear()
        run, c, st = resident_flush(res, distinct,
                                    f"resident distinct rep {rep}")
        check_h2c_launches(f"resident distinct rep {rep}",
                           st.get("h2c_s", {}), tiles)
        runs.append(run)
        counts.setdefault("distinct", c)
    hm_rows_equal_oracle(res, [dmsgs[0], dmsgs[-1]], "resident distinct")
    WALLS["resident"]["distinct"] = statistics.median(
        r["wall_s"] for r in runs)

    # small stores: 2,048 rows each, two flushes of 10,000 keys
    small = backend_cuda.CUDABackend(resident=True, devcache_mb=2.25)
    api.register_backend("cuda", small)
    for rep in range(2):
        resident_flush(small, entries, f"resident 2,048-row stores rep {rep}")
    st = small.devcache_stats()
    if st["pk"]["capacity_rows"] != 2048 or st["pk"]["evictions"] == 0:
        raise AssertionError(f"small stores: {st}")
    log("resident 2,048-row stores after two flushes: " + json.dumps(
        {k: st[k] for k in ("pk", "hm")}))
    api.register_backend("cuda", bytes_be)

    log("flush walls p50, bytes | resident route: " + json.dumps(
        {kind: [WALLS["bytes"].get(kind), WALLS["resident"].get(kind)]
         for kind in ("warm", "slot_start", "distinct", "cold",
                      "cold_after_prewarm")}))
    zero = ([k for k in GRAPH_KERNELS if not counts["warm"][k]]
            + [k for k in H2C_PATH_KERNELS if not counts["distinct"][k]]
            + [k for k in ("g1_decompress",) if not counts["cold"][k]])
    if zero:
        raise AssertionError(f"resident route: never launched {zero}")
    return counts


# ---------------------------------------------------------------------------

SOURCES = {
    "fp_mul": ("charon_tpu_torch/csrc/fp_ops.cu", "charon_tpu/ops/pallas_fp.py:78"),
    "fp_add": ("charon_tpu_torch/csrc/fp_ops.cu", "charon_tpu/ops/pallas_fp.py:97"),
    "fp_sub": ("charon_tpu_torch/csrc/fp_ops.cu", "charon_tpu/ops/pallas_fp.py:104"),
    "fp_neg": ("charon_tpu_torch/csrc/fp_ops.cu", "charon_tpu/ops/pallas_fp.py:112"),
    "fp_mul_small": ("charon_tpu_torch/csrc/fp_ops.cu",
                     "charon_tpu/ops/pallas_fp.py:120"),
    "g2_dbl": ("charon_tpu_torch/csrc/g2.cu", "charon_tpu/ops/pallas_g2.py:350"),
    "g2_add": ("charon_tpu_torch/csrc/g2.cu", "charon_tpu/ops/pallas_g2.py:354"),
    "straus_head": ("charon_tpu_torch/csrc/g2.cu",
                    "charon_tpu/ops/pallas_g2.py:706"),
    "straus_tail": ("charon_tpu_torch/csrc/g2.cu",
                    "charon_tpu/ops/pallas_g2.py:700"),
    "pp_dbl": ("charon_tpu_torch/csrc/pairing.cu",
               "charon_tpu/ops/pallas_pairing.py:328"),
    "pp_add": ("charon_tpu_torch/csrc/pairing.cu",
               "charon_tpu/ops/pallas_pairing.py:332"),
    "pp_sqr": ("charon_tpu_torch/csrc/pairing.cu",
               "charon_tpu/ops/pallas_pairing.py:336"),
    "pp_mul014": ("charon_tpu_torch/csrc/pairing.cu",
                  "charon_tpu/ops/pallas_pairing.py:340"),
    "pp_f12mul": ("charon_tpu_torch/csrc/pairing.cu",
                  "charon_tpu/ops/pallas_pairing.py:345"),
    "g1_dblsel": ("charon_tpu_torch/csrc/pairing.cu",
                  "charon_tpu/ops/pallas_pairing.py:349"),
    "h2c_sswu": ("charon_tpu_torch/csrc/h2c.cu",
                 "charon_tpu/ops/pallas_h2c.py:285"),
    "h2c_sqr": ("charon_tpu_torch/csrc/h2c.cu",
                "charon_tpu/ops/pallas_h2c.py:290"),
    "h2c_mul": ("charon_tpu_torch/csrc/h2c.cu",
                "charon_tpu/ops/pallas_h2c.py:294"),
    "h2c_sqr4": ("charon_tpu_torch/csrc/h2c.cu",
                 "charon_tpu/ops/pallas_h2c.py:298"),
    "h2c_sqr4mul": ("charon_tpu_torch/csrc/h2c.cu",
                    "charon_tpu/ops/pallas_h2c.py:302"),
    "h2c_iso3": ("charon_tpu_torch/csrc/h2c.cu",
                 "charon_tpu/ops/pallas_h2c.py:306"),
    "h2c_psi": ("charon_tpu_torch/csrc/h2c.cu",
                "charon_tpu/ops/pallas_h2c.py:311"),
    "g2_dblsel": ("charon_tpu_torch/csrc/g2.cu",
                  "charon_tpu/ops/pallas_g2.py:389"),
    "g2_addsel": ("charon_tpu_torch/csrc/g2.cu",
                  "charon_tpu/ops/pallas_g2.py:384"),
    # K11 and K12 each replace a whole chain of K1 launches (the pallas_fp
    # kernels, :78 the product that does most of their work) in
    # ops/pairing.py final_exponentiate and ops/codec.py g2_decompress
    "final_exp": ("charon_tpu_torch/csrc/final_exp.cu",
                  "charon_tpu/ops/pallas_fp.py:78"),
    "g2_decompress": ("charon_tpu_torch/csrc/decompress.cu",
                      "charon_tpu/ops/pallas_fp.py:78"),
    # K13 replaces the Miller loop's K4/K5 launch sequence (pallas_pairing
    # miller_rows over the kernels of :328–:340), K14 the fold's F12MUL
    # launches (miller_product_tiled over :345) and K15 the RLC scaling's
    # K6 launches (g1_scalar_mul_rows over :349)
    "miller_loop": ("charon_tpu_torch/csrc/miller.cu",
                    "charon_tpu/ops/pallas_pairing.py:489"),
    "f12_fold": ("charon_tpu_torch/csrc/fold.cu",
                 "charon_tpu/ops/pallas_pairing.py:535"),
    "g1_scalar_mul": ("charon_tpu_torch/csrc/g1_scalar_mul.cu",
                      "charon_tpu/ops/pallas_pairing.py:520"),
    # K16 replaces the combine's K3 launch sequence (pallas_g2
    # straus_combine over the kernels of :700 and :706), K17 each
    # [|x|]-multiply's K2/K10 launches (pallas_h2c _zmul over :389)
    "straus_msm": ("charon_tpu_torch/csrc/straus.cu",
                   "charon_tpu/ops/pallas_g2.py:797"),
    "g2_zmul": ("charon_tpu_torch/csrc/g2_zmul.cu",
                "charon_tpu/ops/pallas_h2c.py:537"),
    # K18 replaces the K7 launch sequences of the Fp2 root and inversion
    # (pallas_h2c f2_sqrt_rows / f2_inv_rows over f2_pow_rows :482), K19
    # the K1 chain of codec.g2_normalize (:319, its products the pallas_fp
    # kernel :78) and K20 the RLC tables' K1 chain (backend_tpu
    # _rlc_g1_tables_kernel :543)
    "f2_chain": ("charon_tpu_torch/csrc/f2_chain.cu",
                 "charon_tpu/ops/pallas_h2c.py:482"),
    "g2_normalize": ("charon_tpu_torch/csrc/normalize.cu",
                     "charon_tpu/ops/codec.py:319"),
    "g1_tables": ("charon_tpu_torch/csrc/g1_tables.cu",
                  "charon_tpu/tbls/backend_tpu.py:543"),
    # K21 replaces the K1 chain of codec.g1_decompress (:266, its subgroup
    # check :254), K22 the K2 launch sequences (pallas_g2 :350 / :354) of
    # the combine's tables (straus_combine :811-813) and of hash-to-G2's
    # group law (pallas_h2c hash_to_g2_rows :614, clear_cofactor_rows
    # :550)
    "g1_decompress": ("charon_tpu_torch/csrc/g1_decompress.cu",
                      "charon_tpu/ops/codec.py:266"),
    "g2_law": ("charon_tpu_torch/csrc/g2_law.cu",
               "charon_tpu/ops/pallas_g2.py:811"),
    # K23 replaces K9 ISO3 (pallas_h2c _h2c_iso3_kernel :306) and the map
    # tail's exact boundary around it (map_to_g2_rows :601-612)
    "h2c_map_tail": ("charon_tpu_torch/csrc/h2c_map.cu",
                     "charon_tpu/ops/pallas_h2c.py:306"),
    # K24 replaces K8 (pallas_h2c _h2c_sswu_kernel :285) and the host
    # flags of pack_messages (:659-662)
    "h2c_sswu_head": ("charon_tpu_torch/csrc/h2c_sswu.cu",
                      "charon_tpu/ops/pallas_h2c.py:285"),
}

#: each kernel's compiled function in the ptxas report (its registers,
#: stack frame and largest spill go into the kernels line)
PTXAS_NAMES = {
    "fp_mul": "fp_ops.cu fp_op_kernel<0>",
    "fp_add": "fp_ops.cu fp_op_kernel<1>",
    "fp_sub": "fp_ops.cu fp_op_kernel<2>",
    "fp_neg": "fp_ops.cu fp_op_kernel<3>",
    "fp_mul_small": "fp_ops.cu fp_op_kernel<4>",
    "g2_dbl": "g2.cu g2_step_kernel<1>",
    "g2_add": "g2.cu g2_step_kernel<0>",
    "straus_head": "g2.cu straus_step_kernel<1>",
    "straus_tail": "g2.cu straus_step_kernel<0>",
    "pp_dbl": "pairing.cu pp_step_kernel<0>",
    "pp_add": "pairing.cu pp_step_kernel<1>",
    "pp_sqr": "pairing.cu f12_step_kernel<0>",
    "pp_mul014": "pairing.cu f12_step_kernel<1>",
    "pp_f12mul": "pairing.cu f12_step_kernel<2>",
    "g1_dblsel": "pairing.cu g1_dblsel_kernel",
    "h2c_sswu": "h2c.cu h2c_sswu_kernel",
    "h2c_sqr": "h2c.cu f2_chain_kernel<0>",
    "h2c_mul": "h2c.cu f2_chain_kernel<1>",
    "h2c_sqr4": "h2c.cu f2_chain_kernel<2>",
    "h2c_sqr4mul": "h2c.cu f2_chain_kernel<3>",
    "h2c_iso3": "h2c.cu h2c_point_kernel<0>",
    "h2c_psi": "h2c.cu h2c_point_kernel<1>",
    "g2_dblsel": "g2.cu g2_sel_kernel<1>",
    "g2_addsel": "g2.cu g2_sel_kernel<0>",
    "final_exp": "final_exp.cu final_exp_kernel",
    "g2_decompress": "decompress.cu g2_decompress_kernel",
    "miller_loop": "miller.cu miller_loop_kernel",
    "f12_fold": "fold.cu f12_fold_kernel",
    "g1_scalar_mul": "g1_scalar_mul.cu g1_scalar_mul_kernel",
    "straus_msm": "straus.cu straus_msm_kernel",
    "g2_zmul": "g2_zmul.cu g2_zmul_kernel",
    "f2_chain": "f2_chain.cu f2_chain_program_kernel<1>",
    "g2_normalize": "normalize.cu g2_normalize_kernel",
    "g1_tables": "g1_tables.cu g1_tables_kernel",
    "g1_decompress": "g1_decompress.cu g1_decompress_kernel",
    "g2_law": "g2_law.cu g2_law_kernel<6>",
    "h2c_map_tail": "h2c_map.cu h2c_map_tail_kernel",
    "h2c_sswu_head": "h2c_sswu.cu h2c_sswu_head_kernel",
}


def main() -> int:
    if not (ROOT / "charon_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: charon_tpu_torch/ is not beside this script (run "
              "it from a checkout of the repository)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from charon_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    t_start = t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.INFO['build_seconds']:.1f} s) → {build.INFO['path']}")
    log(build.ptxas_report())
    ptxas = {r["name"]: r for r in build.ptxas_rows()}
    missing = [k for k in SOURCES if PTXAS_NAMES[k] not in ptxas]
    if missing:
        raise AssertionError(f"no ptxas report for {missing}")
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_clocks_per_s = sms * clock_mhz * 1e6
    log(f"card: {card}; {sms} SMs, max SM clock {clock_mhz:.0f} MHz → "
        f"IMAD peak {IMAD_LANES_PER_SM * sm_clocks_per_s / 1e12:.2f} T/s, "
        f"int32 issue peak {ISSUE_LANES_PER_SM * sm_clocks_per_s / 1e12:.2f}"
        f" T/s")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    # the phases before the resident one drive the bytes route (their
    # per-stage breakdown); the resident phase registers its own backends
    from charon_tpu_torch.tbls import api, backend_cuda, dispatch
    api.register_backend("cuda", backend_cuda.CUDABackend(resident=False))
    # the kernels at the shapes the combine gives them: its padded
    # validator rows (one Straus step) times the shares (decompress, tables)
    vrows = api.combine_padded_rows(VALIDATORS, SHARES)
    def mark(phase: str) -> None:
        log(f"phase {phase}: starts at {time.perf_counter() - t_start:.1f} s")

    mark("kernels")
    kern = kernels_phase(dev, vrows * SHARES, vrows, sm_clocks_per_s)
    # the pairing kernels at one verify tile: 2 Miller rows per entry
    kern.update(pairing_kernels_phase(
        dev, 2 * api.verify_padded_rows(dispatch.VERIFY_TILE),
        sm_clocks_per_s))
    # the h2c kernels at one verify tile's message batch
    kern.update(h2c_kernels_phase(dev, dispatch.VERIFY_TILE,
                                  sm_clocks_per_s))
    for name, at in k1_main_shapes(dev, sm_clocks_per_s).items():
        kern[name]["main_shapes"] = at
    # K16 at the combine's shape, K17 at a hash batch's
    mark("straus_msm")
    kern["straus_msm"] = straus_msm_phase(dev, vrows * SHARES, vrows,
                                          sm_clocks_per_s)
    mark("zmul")
    kern["g2_zmul"] = zmul_phase(dev, sm_clocks_per_s)
    mark("chains, normalize, tables")
    # K18 at the slot-start and a verify tile's hash batches, K19 at the
    # combine's rows and those batches, K20 at a verify tile's pair rows
    kern["f2_chain"] = chains_phase(dev, sm_clocks_per_s,
                                    (MESSAGES, dispatch.VERIFY_TILE))
    kern["g2_normalize"] = normalize_phase(
        dev, sm_clocks_per_s, (vrows, MESSAGES, dispatch.VERIFY_TILE))
    kern["g1_tables"] = tables_phase(
        dev, 2 * api.verify_padded_rows(dispatch.VERIFY_TILE),
        sm_clocks_per_s)
    # K22 at the combine's table rows and the hash batches' messages
    mark("g2_law")
    kern["g2_law"] = g2_law_phase(dev, sm_clocks_per_s, vrows * SHARES,
                                  (MESSAGES, dispatch.VERIFY_TILE))
    # K23 at the hash batches' u rows
    mark("map_tail")
    kern["h2c_map_tail"] = map_tail_phase(dev, sm_clocks_per_s,
                                          (MESSAGES, dispatch.VERIFY_TILE))
    # K24 at the hash batches' u rows
    mark("sswu_head")
    kern["h2c_sswu_head"] = sswu_head_phase(dev, sm_clocks_per_s,
                                            (MESSAGES, dispatch.VERIFY_TILE))
    mark("combine")
    combine_launches, _, pool = combine_phase(dev)
    mark("redesign")
    # K11 at the batch check's 1 row and a re-check tile's rows, K12 at a
    # verify tile and at the combine's padded 10,240 × 7 rows
    tile = api.verify_padded_rows(dispatch.VERIFY_TILE)
    redesign = redesign_kernels_phase(dev, pool, tile, VALIDATORS * SHARES,
                                      vrows * SHARES, sm_clocks_per_s, sms)
    # the main path's shapes: K11 at 1 row, K12 at a verify tile; the other
    # shape beside it
    kern["final_exp"] = {**redesign["final_exp@1"],
                         "recheck": redesign[f"final_exp@{tile}"]}
    kern["g2_decompress"] = {**redesign[f"g2_decompress@{tile}"],
                             "combine": redesign[
                                 f"g2_decompress@{vrows * SHARES}"]}
    # K13 at a verify tile's Miller rows
    mark("miller")
    kern["miller_loop"] = miller_phase(dev, pool, 2 * tile, sm_clocks_per_s)
    mark("verify")
    verify_launches, cold_launches, pks, sks, bits, entries = verify_phase(
        dev)
    # K21 at a verify tile's keys and the flush's, on the pool's keys
    mark("g1_decompress")
    kern["g1_decompress"] = g1_decompress_phase(
        dev, pks, sm_clocks_per_s, (dispatch.VERIFY_TILE, VALIDATORS))
    mark("slot-start")
    slot_launches = verify_slot_start_phase(dev, pks, sks, bits)
    mark("h2c")
    plain_planes = h2c_phase(dev, dispatch.VERIFY_TILE)
    mark("distinct")
    distinct_launches = verify_distinct_phase(dev, pks, sks, bits,
                                              plain_planes)
    mark("resident")
    resident_launches = resident_phase(dev, entries, bits)

    from charon_tpu_torch.tbls import dispatch
    pipe = dispatch.current_pipeline()
    if pipe is not None:
        pipe.shutdown()

    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": (combine_launches.get(name, 0) + verify_launches[name]
                      + cold_launches[name] + slot_launches[name]
                      + distinct_launches[name]
                      + sum(c[name] for c in resident_launches.values())),
         "launches_combine": combine_launches.get(name, 0),
         "launches_verify": verify_launches[name],
         "launches_verify_cold": cold_launches[name],
         "launches_verify_slot_start": slot_launches[name],
         "launches_verify_distinct": distinct_launches[name],
         "launches_resident": {kind: c[name] for kind, c in
                               resident_launches.items()},
         **kern[name],
         **{k: ptxas[PTXAS_NAMES[name]][k] for k in ("regs", "stack",
                                                     "spill")},
         "library_ms": None}
        for name in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
