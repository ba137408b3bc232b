#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (charon_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # the full run: 10,000 validators, 7-of-10

Phases, in order; any failure raises and exits non-zero:

1. build   — compile csrc/*.cu with nvcc (one process per source, in
             parallel); print the build seconds, the compiler's register /
             spill report, and the card's name and power limit.  The
             host's 8 worker processes start first (below nvcc's
             priority) and make what needs no kernel meanwhile: the chaos
             phase's signatures and the cluster phase's `create cluster`
             (its V by one signature timed before them); later phases
             hand them the oracle's larger checks.
   contract — the kernel contract audit (`python -m
             charon_tpu_torch.analysis`) with the build's ptxas.log, its
             AST lints run in a host worker beside the build; then, for
             every registered kernel instantiation, the card's own figures
             (`cudaFuncGetAttributes`: registers, local memory, static
             shared memory, threads a block; the occupancy API's blocks an
             SM at its launch geometry) held against the compiler's report
             and ops/smem_budget.py's model; the resident verify tile
             captured at a 2-entry bucket as one CUDA graph of K12, K20,
             K15, K13, K14 and K11 in order (its nodes read through
             libcuda); and the on-card golden-bad `resident_roundtrip`,
             which must be flagged.  Any violation fails the run.  Each
             kernel's shared memory a block and blocks an SM join its
             entry in the kernels line.
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
   multichip — the multi-card combine on the combine's batch:
             `torch.cuda.device_count()` and each card's name and power
             limit; `multichip.dryrun_multichip(device_count)` (the audit
             with its shard pass on the cards, V = device_count
             validators' 2-of-2 partials through
             `backend_cuda.straus_combine_sharded`, each verified on a
             card of its own by the re-check's kernels: K19, K1's
             negation, K13, K5's product, K11); then the 10,000 × 7
             batch, decompressed by K12, sharded one shard a visible card
             and 4 shards on cuda:0: the normalised, compressed result
             byte-equal to the unsharded `threshold_combine_bytes` of the
             batch in each of 3 reps and 4 sampled rows to the oracle,
             each shard's K22 and K16 seconds (CUDA events on its
             stream), the sharded call's wall (its p50 of 3), and the
             unsharded K22 + K16 at 10,240 rows beside them; then the
             shard pass on the cards at both layouts and its golden-bad
             `replicated_carry` flagged on the card.  One
             card leaves copies between cards and shards running at once
             on different cards unexercised.
   redesign — K11 (the final exponentiation in one launch, a block of
             12 lane groups per row) against its plain version at 1 row
             and at a verify tile's 2,048, and K12 (the G2 decompression
             in one launch, 16 or 8 lanes per row) at 1, 4 and 2,048 rows
             and at the combine's 71,680, on the pool's signatures with ∞
             rows, x off the curve, points outside G2 and α = −1 rows
             mixed in: bit-identical, every ok flag as its row's kind
             wants; both timed beside their bounds.  K13 (the whole
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
8. simnet  — the duty workflow: in-process clusters of app/node.Node
             (scheduler → fetcher → consensus → dutydb → validatorapi →
             parsigdb → parsigex → sigagg → aggsigdb → bcast) with mock
             VCs signing real BLS partials, on a fresh resident backend,
             12 s slots of 4-slot epochs: BASELINE.json config 1 (1
             validator, 4-of-4, attestation) for its attester slot, on
             leadercast and again on QBFT (`core/consensus.QBFTConsensus`
             over one `ConsensusMemNetwork`), then config 2's cluster
             (3-of-4, attestation + sync committee message) on QBFT with
             V the largest count whose mock-VC signing (the measured
             pure-Python sign time) fits ⅔ of a slot, for 2 slots; each
             after `prewarm` at its (V, T) and every verify bucket its
             flushes can reach.  Each QBFT node has its own metrics
             registry, and with it the tracer, tracker, slot budget and
             probes of the JAX node.  Every attestation and sync message
             in the BeaconMock must carry exactly the oracle's bytes
             (ref.bls.sign with the group secret), every node the same
             bytes, no duty of a waited slot missing, every waited
             consensus duty decided on every node with one value, every
             waited duty tracked as a success with full participation on
             every node (the tracker's `analyse`, called once the duties
             are in: the call the deadline would make), every registry
             rendering the workflow's families, the resident route, no
             K1, and K12, K20, K15, K13, K14, K11 (verify) and K12, K22,
             K16, K19 (combine) launched in every waited slot.  Per slot:
             flushes and entries, combines and validators, graph
             captures, verify stages, the combines' K12 and K16 stage
             seconds, launches; per node: each duty's seconds from slot
             start to the broadcast; with a registry also, per duty and
             node, the slot budget's hand-offs in seconds from slot start,
             QBFT's decided round, timeouts and round changes, the
             tracker's verdict, the sums of
             `core_dispatch_stage_seconds{stage,op}` and the
             device-memory gauge beside `torch.cuda.memory_allocated`.
9. dkg     — BASELINE.json config 5 (FROST DKG share-proof verify, 1,000
             validators, 7-of-10) on a fresh resident backend: real Shamir
             shares on the host, validator v's proof by share (v mod 10) +
             1, pubshares share·G1 and proofs share·H(m) made on the card;
             warm — `keygen.verify_share_proofs` over one transcript, one
             tile (one graph replay), p50 of 5, row 500's proof swapped
             for row 501's rejected alone, it and 8 more rows equal to the
             pure-Python oracle; cold — `verify_share_proofs_multi` over
             1,000 transcripts (H(m) hashed and signed on the card), both
             message caches emptied before each of 5 reps so each rep
             hashes its 1,000 messages in one device batch, a corrupted
             transcript rejected alone, p50 and messages/s.  Then a
             keycast ceremony (4 operators, 3-of-4, 2 validators) of four
             `run_dkg`s on this loop over the port's TCP mesh, whose
             launches are `launches_dkg`; then the ceremony as operators
             run it: `create enr` ×4, `create dkg` (Pedersen, 3-of-4, 8
             validators: the lock / deposit batch's 9 messages are hashed
             on the card), `sign` ×4, four `python -m charon_tpu_torch
             dkg` processes timed from spawn to the last exit, each
             reporting its verify, hash and combine kernels; equal locks
             that verify on load, keystores of the nodes' pubshares,
             every deposit signature verified by the oracle, `combine`
             over 3 node directories recombining every group key and
             refusing 2.
10. chaos   — the fault catalogue and the race stress with real BLS, on
             a fresh resident backend (`testutil/chaos.py`, one inline
             dispatch pipeline a run, the nodes on a virtual clock):
             `garbage` (24 slots: a byzantine node's 96 random bytes as
             partials, off-round consensus frames) and
             `byzantine_equivocation` (22 slots, cut from 32: validly
             signed conflicting partials that the card must accept for
             the detector to count them) at seed 0, and `garbage` at 8
             slots twice, all four at once (their walls concurrent), each
             on a thread and a CUDA stream of its own with its own copy of
             every verify bucket (captured first, dropped after the runs;
             `verify_graphs_per_stream`); the signatures the mock VCs will make
             (recorded from the same runs under insecure-test) made
             beforehand on the host's workers during the build; the
             cluster phase's four node processes boot on the same card
             beside the runs' end.  Each run passes
             `ChaosHarness.check` (liveness, safety, telemetry truth), 8
             distinct attestations of each scenario equal the oracle,
             the verify tile's and the combine's kernels launch and K1
             only as a re-check's negation; per scenario the wall, the
             nodes' verify flushes, tiles, rows rejected, re-checks,
             combines, attestations, verify stages and launches; the two
             8-slot runs must give one fingerprint.  Then
             `testutil/racecheck.py`'s dispatch_stress (seed 5, bls: the
             verifies, prewarm and a device store on the card beside
             scrape and commit threads, a fresh backend's two locks
             instrumented) twice: clean, every entry verified,
             `CUDABackend.*` among the writers, one fingerprint.
11. cluster — the node as a process: config 2's cluster (4 nodes,
             3-of-4, attestation + sync committee message, QBFT, 12 s
             slots) written by `python -m charon_tpu_torch create
             cluster` with real BLS (on a host worker during the build),
             spawned during the chaos phase's runs once their estimated
             time left and the phase's tail fit before the genesis (90 s
             after the spawn: the nodes boot beside the phase's end, their
             waited slots after it), V the largest count whose mock-VC
             signing in ONE node's process fits ⅔ of a slot, at most 32
             (what one card keeps up with for four nodes); a
             BeaconMockServer a node in this process over one mock; four
             `python -m charon_tpu_torch run --simnet-validator-mock`
             processes (one CUDA context each on the one card, no MPS:
             their kernels time-slice), each verifying the lock and
             prewarming on the card; every /readyz polled, then 3 slots
             with every node, node 4 sent SIGTERM, 2 slots (one led by
             node 4 in QBFT's round 1) with the other three, SIGTERM to
             those.  Every waited duty must reach the mock from every live
             node with the oracle's bytes (ref.bls.sign with the group
             secret recombined from 3 nodes' keystores), every node's
             verifies on the resident route with the verify tile's, the
             combine's and K21's kernels launched (its /metrics), every
             down-window consensus duty decided on the live nodes (node
             4's by a round change), every process exit 0 with no
             traceback.  Printed: each duty's seconds from slot start to
             the mock by node, each node's boot split (import,
             verify_lock, prewarm), `core_slot_phase_seconds`,
             `core_dispatch_stage_seconds` and kernel launches, the
             decided rounds, and the mesh's pure-Python crypto's share of
             a slot on one node's loop.

Phase 2 also holds the h2c kernels (K7 sqr/mul/sqr4/sqr4mul at 8,192 rows,
K8 sswu and K9 iso3 at 4,096, K9 psi and K10 dblsel/addsel at 2,048: one
2,048-message batch's shapes) against their plain versions.  Every device
hash batch (phases 4–6) must launch 1 K24 and no K8, 2 K18, no K7, one K23
and no K9, 2 K17, no K10 dblsel, 2 K22 and no K2, one K19 and no K1: 9
launches.  Phase 5 also times `pack_messages` alone at 10,000 messages.
No flush (warm, cold, slot-start, distinct) and no combine launches K1
or K9; K1 and K9 run in phase 2 as references.

A kernel's `launches` in the JSON line is its count over the main-path
runs: `launches_combine` (one combine rep), `launches_multichip` (the
multichip phase's dry run and its two sharded combines, from zero; the
unsharded reference and the shard pass outside it), `launches_verify` (one
10,000-entry verify rep, warm caches), `launches_verify_cold` (the
flush that fills the pubkey LRU), `launches_verify_slot_start` (one
rep of the slot's first flush) and `launches_verify_distinct` (one rep of
the distinct-message flush) and `launches_resident` (the first run of
each resident flush kind: cold after prewarm, warm, slot-start, distinct,
cold; a replay counts its graph's captured launches) and
`launches_simnet` (the three clusters' runs, each from its first slot's
tick to the end) and `launches_dkg` (the in-process keycast ceremony of
phase 9, from zero) and `launches_chaos` (phase 10's two scenarios,
each from zero) and `launches_cluster` (the four node processes' own
counts from their spawn, each read from its /metrics just before its
SIGTERM), each counted from zero. K10 addsel has no
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
full rate; K11 also gives `bound_one_sm_ms`, the bound at the rate of
the SMs its rows can occupy under its block-per-row design (one SM at 1
row).  K11's and K12's bounds count the fewest operations known for
their function (windowed pows, the α = −1 skip, the cyclotomic
squaring: `final_exp_design_ops`, `decompress_design_ops`); their
entries add `naive_ops` and `naive_bound_ms`, the count by
square-and-multiply pows and tower squarings (`final_exp_ops`,
`decompress_ops`) that their bounds were taken from before; K12 adds
`lanes` (a row's) and `tiles`, its figures at 1 and 4 rows.
A `plain_ms` taken on a plain version's first call in the run is cold
(`plain_warm` false: its first-use set-up included), any other warm;
the script orders each kernel's shapes so that its top-level entry's is
warm where one call can serve (K13's, on one input of random, all-LMAX
and real rows, is its only call and cold).
The second-to-last line is the `kernels` JSON object; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import multiprocessing
import random
import re
import statistics
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import Future, ProcessPoolExecutor
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


#: the host's worker processes for the run's pure-Python work (the chaos
#: runs' signatures, `create cluster`, the oracle's larger checks):
#: spawned (never forked after CUDA is up) before the build, so that the
#: work no kernel needs runs while nvcc does, below nvcc's priority
HOST_WORKERS, HOST_NICE = 8, 10
HOST_POOL: ProcessPoolExecutor | None = None


def _host_worker_init() -> None:
    import os

    os.nice(HOST_NICE)


def host_pool() -> ProcessPoolExecutor:
    """The run's host workers, started on first use."""
    global HOST_POOL
    if HOST_POOL is None:
        HOST_POOL = ProcessPoolExecutor(
            max_workers=HOST_WORKERS, initializer=_host_worker_init,
            mp_context=multiprocessing.get_context("spawn"))
    return HOST_POOL


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
    """[IMAD, ALU] of one final exponentiation by the naive sequence: five
    ^z chains of 63 squarings and popcount(|z|) − 1 products, one more
    squaring and nine products around them, 5 Frobenius maps, 9
    conjugations and the inverse (its Fp inverse the pow p − 2 by square
    and multiply), each ^z squaring a full K5 squaring.  The bound takes
    `final_exp_design_ops`, which needs fewer."""
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
    """[IMAD, ALU] of one G2 decompression over rows of four kinds by the
    naive sequence: every row computes x³ + b', both pows by square and
    multiply, the root, its check and sign; a row whose root checks
    (valid, off the subgroup) or that is ∞ runs the ψ check, whose
    equality multiplies only for two finite points and stops at a
    differing x (off the subgroup).  The bound takes
    `decompress_design_ops`, which needs fewer."""
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


def _pow_w3_ops(e: int, sqr, mul):
    """A fixed-exponent pow by 3-bit windows, MSB first (csrc/
    decompress.cu): the table a..a⁷ (one squaring, five products), then per
    window three squarings and, for a non-zero digit, one product."""
    from charon_tpu_torch.ops import miller_program

    digs = miller_program.pow_digits(e, 3)
    return (sqr + 5 * mul + 3 * (len(digs) - 1) * sqr
            + sum(map(bool, digs[1:])) * mul)


def final_exp_design_ops() -> np.ndarray:
    """[IMAD, ALU] of what csrc/final_exp.cu's design executes a row, at
    fp381.cuh's costs (no lane-split overhead): `final_exp_ops`'s function
    with the 315 ^z squarings cyclotomic — nine Fp2 squarings, three pair
    sums and six combinations each — and the inverse's pow by 4-bit
    windows."""
    from charon_tpu_torch.ops import cuda_codec
    from charon_tpu_torch.tbls.ref.fields import P

    zbits = cuda_codec.ABS_Z.bit_length() - 1
    zmuls = bin(cuda_codec.ABS_Z).count("1") - 1
    cyc = (9 * _F2SQR + 3 * _F2ADD + 3 * (_XI + _F2ADD)
           + 3 * (_F2ADD + _F2SUB) + _XI
           + 3 * _F2SUB + 3 * _F2ADD + 6 * (_F2SMALL + _F2ADD))
    f2_inv = (4 * OPS["fp_mul"] + OPS["fp_add"] + OPS["fp_neg"]
              + _pow_w4_ops(P - 2, OPS["fp_mul"], OPS["fp_mul"]))
    f6_inv = 12 * _F2MUL + 3 * _XI + 3 * _F2SUB + 2 * _F2ADD + f2_inv
    f12_inv = 4 * _F6MUL + _XI + _F6SUB + f6_inv + 6 * OPS["fp_neg"]
    conj = 6 * OPS["fp_neg"]
    frob = 6 * OPS["fp_neg"] + 7 * _F2MUL
    return (5 * zbits * cyc + OPS["pp_sqr"] + (5 * zmuls + 9)
            * OPS["pp_f12mul"] + 5 * frob + 9 * conj + f12_inv)


def decompress_design_ops(n_valid: int, n_inf: int, n_off_curve: int,
                          n_off_group: int, n_alpha_m1: int = 0
                          ) -> np.ndarray:
    """[IMAD, ALU] of what csrc/decompress.cu's design executes over rows of
    four kinds, at fp381.cuh's costs (no lane-split overhead):
    `decompress_ops`'s function with both pows by 3-bit windows and the
    second pow skipped on the `n_alpha_m1` rows (among the off-group ones)
    where α = −1."""
    from charon_tpu_torch.ops import cuda_codec

    n = n_valid + n_inf + n_off_curve + n_off_group
    base = decompress_ops(n_valid, n_inf, n_off_curve, n_off_group)
    pows = lambda f: (f(cuda_codec.EXP_P34, _F2SQR, _F2MUL)
                      + f(cuda_codec.EXP_P12, _F2SQR, _F2MUL))
    return (base + n * (pows(_pow_w3_ops) - pows(_pow_ops))
            - n_alpha_m1 * (_pow_w3_ops(cuda_codec.EXP_P12, _F2SQR, _F2MUL)
                            + _F2ADD + _F2MUL))


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


#: the plain versions this run has called (by module and name): a plain
#: version's first call pays its first-use set-up, so a time taken on it
#: is marked cold (`plain_warm` false)
PLAIN_CALLED: set = set()


def record(results: dict, name, kernel_fn, plain_fn, ops, nbytes, patterns,
           sm_clocks_per_s: float, plain_reps: int = 5) -> tuple:
    """Hold the kernel against its plain version on every input pattern
    (bit for bit), then time both on the first pattern (the kernel over 5
    runs, the plain version over `plain_reps`).  With `plain_reps` 1 the
    first pattern is compared last and its comparison call is the plain
    version's one timed run: warm where an earlier call of the same plain
    version came before it in this run (another pattern's, or another
    shape's), and marked cold (`plain_warm` false) where none did.  → the
    plain version's outputs on the first pattern."""
    err = 0
    plain_ms = first = None
    warm = True
    once = plain_reps == 1
    key = (plain_fn.__module__, plain_fn.__qualname__)
    order = [*patterns[1:], patterns[0]] if once else patterns
    for pat in order:
        args = pat()
        got = kernel_fn(*args)
        if once and pat is patterns[0]:
            warm = key in PLAIN_CALLED
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = plain_fn(*args)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
        else:
            want = plain_fn(*args)
        PLAIN_CALLED.add(key)
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
        if pat is patterns[0]:
            first = want
    args = patterns[0]()
    ms = time_ms(lambda: kernel_fn(*args))
    if plain_ms is None:
        plain_ms = time_ms(lambda: plain_fn(*args), plain_reps)
    bms, by = bound(ops, nbytes, sm_clocks_per_s)
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "plain_warm": warm, "bound_ms": bms, "bound_by": by}
    log(f"kernel {name}: bit-identical on {len(patterns)} inputs; {ms:.4f} "
        f"ms (plain {plain_ms:.4f} ms{'' if warm else ', cold'}, bound "
        f"{bms:.4f} ms by {by})")
    return first


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
    batch's (128 rows), on random limbs with ∞ rows and a quarter of the
    rows all-LMAX (one input, one plain call a shape),
    and against the 34 K2/K10 launches it replaced (`zmul_steps`); timed
    beside them, its bound and the plain version; the sweep over 2, 4 and
    8 lanes at 4,096 rows."""
    from charon_tpu_torch.ops import cuda_g2, fp
    from charon_tpu_torch.ops import cuda_h2c as ch
    from charon_tpu_torch.ops import miller_program as mp

    gen = np.random.default_rng(20261022)
    row_ops = 65 * OPS["g2_dbl"] + 6 * OPS["g2_add"]
    res = {}
    # the slot-start batch's 128 rows first: the plain version's first
    # call (cold), the 4,096 rows' after it warm
    for n in (128, 4096):
        q = limbs(dev, gen, (6, NL, n), "random")
        q[..., 5:21] = cuda_g2.inf_planes(16, dev)
        q[..., n - n // 4:] = fp.LMAX
        part = {}
        record(part, "g2_zmul", ch.zmul, ch.zmul_plain, row_ops * n,
               2 * PT_BYTES * n, [lambda q=q: (q,)], sm_clocks_per_s,
               plain_reps=1)
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
    # the last size first: the plain version's one call there is its
    # first (cold), the first size's (the kernels line's) after it warm
    for n in reversed(sizes):
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
        f"plain {r['plain_ms']:.1f} ms{'' if r['plain_warm'] else ', cold'})"
        for n, r in ((n, res[n]) for n in sizes)))
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


def fe_rows(dev, gen, rows: int) -> torch.Tensor:
    """K11's input: Fp12 rows of seeded random limbs, the first ⌈rows /
    2⌉ of them Fp elements (c0's c0 only), which the exponentiation takes
    to one, and the last ⌊rows / 4⌋ all-LMAX."""
    from charon_tpu_torch.ops import fp

    f = limbs(dev, gen, (2, 3, 2, NL, rows), "random")
    f.view(12, NL, rows)[1:, :, :-(-rows // 2)] = 0
    if rows // 4:
        f[..., rows - rows // 4:] = fp.LMAX
    return f


def alpha_m1_rows(count: int, seed: int = 20261021) -> list[bytes]:
    """Compressed G2 encodings of `count` x on the twist whose root has α
    = −1 (rhs = x³ + b' = −c², c ∈ Fp: rhs^((p−1)/2) = −1), by a seeded
    search: x1 at random, x0 = √((x1³ − 4)/(3·x1)) (so that rhs ∈ Fp),
    kept where α = −1.  On the curve, outside G2 (ok false)."""
    from charon_tpu_torch.tbls.ref import curve as rc
    from charon_tpu_torch.tbls.ref.fields import FQ, FQ2, P

    rng = random.Random(seed)
    out = []
    while len(out) < count:
        x1 = FQ(rng.randrange(1, P))
        x0 = ((x1 ** 3 - FQ(4)) / (FQ(3) * x1)).sqrt()
        if x0 is None:
            continue
        x = FQ2([x0.n, x1.n])
        rhs = x ** 3 + rc.B2
        if rhs ** ((P - 1) // 2) != FQ2([P - 1, 0]):
            continue
        # flags (compressed; the sign alternates) over c1, then c0
        head = x1.n | (0x80 | 0x20 * (len(out) % 2)) << 376
        out.append(head.to_bytes(48, "big") + x0.n.to_bytes(48, "big"))
    return out


def k12_inputs(dev, gen, pool: list[bytes], rows: int, real: int
               ) -> tuple[tuple, list[str]]:
    """K12's input at `rows` rows: `real` of the pool's signatures (both
    signs), the rest ∞ padding; at 64 rows and more, 8 x off the curve,
    32 on-curve points outside G2 (the cofactor point, its negation, and 2
    x whose root has α = −1) and 8 ∞ rows at seeded spots; at 4 rows one
    row of each kind → (the wrapper's arguments, each row's kind)."""
    from charon_tpu_torch.ops import codec
    from charon_tpu_torch.tbls.ref import curve as rc
    from charon_tpu_torch.tbls.ref.fields import FQ2

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
    raw = [pool[k % len(pool)] for k in range(real)] + [inf] * (rows - real)
    kind = ["valid"] * real + ["inf"] * (rows - real)
    if rows >= 64:
        special = ([(b, "off_curve") for b in off_curve]
                   + [(b, "off_group") for b in off_group * 15]
                   + [(b, "alpha_m1") for b in alpha_m1_rows(2)]
                   + [(inf, "inf")] * 8)
        spots = gen.choice(real, len(special), replace=False).tolist()
        for r, (b, k) in zip(spots, special):
            raw[r], kind[r] = b, k
    elif rows == 4:
        raw[1:], kind[1:] = ([inf, off_curve[0], alpha_m1_rows(1)[0]],
                             ["inf", "off_curve", "alpha_m1"])
    xc0, xc1, sign, inf_f, bad = codec.g2_bytes_split(
        np.stack([np.frombuffer(b, np.uint8) for b in raw]))
    if bad.any():
        raise AssertionError("K12 inputs: a row does not decode")
    args = (torch.from_numpy(np.ascontiguousarray(xc0.T)).to(dev),
            torch.from_numpy(np.ascontiguousarray(xc1.T)).to(dev),
            torch.from_numpy(sign).to(dev), torch.from_numpy(inf_f).to(dev))
    return args, kind


def k12_counts(kind: list[str]) -> dict:
    """Rows of each kind (α = −1 rows are on the curve, outside G2)."""
    return {k: kind.count(k) for k in
            ("valid", "inf", "off_curve", "off_group", "alpha_m1")}


def k12_ops(counts: dict, design: bool) -> np.ndarray:
    """The design's op count (`decompress_design_ops`: the bound) or the
    naive sequence's (`decompress_ops`) over rows of these kinds."""
    kinds = (counts["valid"], counts["inf"], counts["off_curve"],
             counts["off_group"] + counts["alpha_m1"])
    return (decompress_design_ops(*kinds, counts["alpha_m1"]) if design
            else decompress_ops(*kinds))


def redesign_kernels_phase(dev, pool: list[bytes], tile: int,
                           combine_real: int, combine_rows: int,
                           sm_clocks_per_s: float, sms: int) -> dict:
    """K11 with its verdict "= 1" against `final_exp_plain` and
    `pairing.is_one` at `tile` rows (a re-check) on `fe_rows`' input, and
    at 1 row (the batch check) on an Fp element and on three rows of that
    input; K12 against `g2_decompress_plain` at `combine_rows` (the
    combine: `combine_real` signatures, the rest ∞ padding), `tile` rows
    (a verify tile) and 4 and 1 rows (the chaos and cluster tiles) on
    `k12_inputs` from the pool's signatures.  Bit for bit, every row's ok
    flag as its kind wants, and each timed beside its bound (the design's
    op count, the fewest known) and the naive sequence's (`naive_ops`)."""
    from charon_tpu_torch.ops import cuda_codec, cuda_final_exp
    from charon_tpu_torch.ops import pairing as tpair

    gen = np.random.default_rng(20261019)
    results = {}

    def fe_plain(f):
        out = cuda_final_exp.final_exp_plain(f)
        return out, tpair.is_one(out)

    def naive(part, name, ops):
        bms, _ = bound(ops, 0, sm_clocks_per_s)
        part[name].update({"naive_ops": [int(x) for x in ops],
                           "naive_bound_ms": bms})

    # K11: bound_ms at the card's full rate; `bound_one_sm_ms` at the rate
    # of the SMs that a block per row occupies (one SM a row), an
    # assumption of this design that the function does not force.  The
    # re-check's rows first (the plain version's first call, cold), then
    # the batch check's 1 row (warm): there one launch a row on a row that
    # is one, a random row and an all-LMAX row of the re-check's input,
    # each against the plain version's row of it
    big = fe_rows(dev, gen, tile)
    for rows in (tile, 1):
        part = {}
        check = 12 * (OPS["fp_sub"] + _ISZERO)
        ops = (final_exp_design_ops() + check) * rows
        nbytes = (2 * 12 * EL_BYTES + 1) * rows
        f = big if rows == tile else fe_rows(dev, gen, 1)
        # the path's form: the result and its verdict "= 1" in one launch
        want = record(part, "final_exp", cuda_final_exp.final_exp_is_one,
                      fe_plain, ops, nbytes, [lambda f=f: (f,)],
                      sm_clocks_per_s, plain_reps=1)
        naive(part, "final_exp", (final_exp_ops() + check) * rows)
        if rows == tile:
            plain_big = want
        _, one = cuda_final_exp.final_exp_is_one(f)
        want = [k < -(-rows // 2) for k in range(rows)]
        if one.tolist() != want:
            raise AssertionError(f"K11 at {rows} rows: verdicts "
                                 f"{one.tolist()[:8]}…, want {want[:8]}…")
        one_sm, _ = bound(ops, nbytes, sm_clocks_per_s * min(rows, sms) / sms)
        results[f"final_exp@{rows}"] = {**part["final_exp"], "rows": rows,
                                        "bound_one_sm_ms": one_sm}
        log(f"K11 at {rows:,} rows: bound {one_sm:.4f} ms if each row "
            f"stays on one SM (a block per row)")
    for r in (0, tile // 2, tile - 1):
        got = cuda_final_exp.final_exp_is_one(big[..., r:r + 1].contiguous())
        if any(not torch.equal(g, w[..., r:r + 1])
               for g, w in zip(got, plain_big)):
            raise AssertionError(f"K11 at 1 row: the re-check input's row "
                                 f"{r} differs from its plain version")

    # K12: the combine's shape first: the plain version's one call there
    # is its first (cold), the others after it warm
    for rows, real in ((combine_rows, combine_real), (tile, tile), (4, 1),
                       (1, 1)):
        args, kind = k12_inputs(dev, gen, pool, rows, real)
        _, ok = cuda_codec.g2_decompress(*args)
        ok = ok.cpu().numpy()
        want = np.array([k in ("valid", "inf") for k in kind])
        if not np.array_equal(ok, want):
            raise AssertionError(f"K12 at {rows} rows: ok flags of "
                                 f"{int((ok != want).sum())} rows are wrong")
        counts = k12_counts(kind)
        part = {}
        record(part, "g2_decompress", cuda_codec.g2_decompress,
               cuda_codec.g2_decompress_plain, k12_ops(counts, True),
               rows * (2 * EL_BYTES + 2 + PT_BYTES + 1), [lambda: args],
               sm_clocks_per_s, plain_reps=1)
        naive(part, "g2_decompress", k12_ops(counts, False))
        results[f"g2_decompress@{rows}"] = {
            **part["g2_decompress"], "rows": rows,
            "lanes": cuda_codec.decompress_lanes(rows)}
        log(f"K12 at {rows:,} rows ({cuda_codec.decompress_lanes(rows)} "
            f"lanes a row): ok flags right for every kind "
            f"{json.dumps(counts)}, {int(args[2].sum()):,} rows of sign 1")
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


def miller_inputs(dev, gen, pool: list[bytes], rows: int) -> tuple:
    """One Miller input of `rows` rows: a third seeded random limbs, a
    third all-LMAX, the rest (an even count, as `miller_pairs` builds
    them) real pairs with ∞ rows → (p [3, 32, rows], q [4, 32, rows])."""
    n_real = rows // 3 // 2 * 2
    cut = (rows // 3, rows - n_real)
    pairs = miller_pairs(dev, pool, n_real)
    return tuple(torch.cat([limbs(dev, gen, (k, NL, cut[0]), "random"),
                            limbs(dev, gen, (k, NL, cut[1] - cut[0]), "lmax"),
                            real], -1).contiguous()
                 for k, real in ((3, pairs[0]), (4, pairs[1])))


def miller_phase(dev, pool: list[bytes], rows: int,
                 sm_clocks_per_s: float) -> dict:
    """K13 against `miller_loop_plain` at `rows` Miller rows (a verify
    tile), bit for bit, on one input of seeded random limbs, all-LMAX
    limbs and real pairs with ∞ rows (one call of the plain version, its
    time); timed beside the 198-launch K4/K5 sequence it
    replaced (also held bit for bit), its bound and the plain version.
    The probe that chose its design: pp_mul014 across row counts, the same
    loop one thread per row (`miller_thread`), K13 at other row counts and
    with 4 and 16 lanes a row."""
    from charon_tpu_torch.ops import cuda_pairing as cp
    from charon_tpu_torch.ops import miller_program as mp

    gen = np.random.default_rng(20261021)
    p, q = miller_inputs(dev, gen, pool, rows)
    key = (cp.miller_loop_plain.__module__, cp.miller_loop_plain.__qualname__)
    warm = key in PLAIN_CALLED
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = cp.miller_loop_plain(p, q)
    end.record()
    torch.cuda.synchronize()
    PLAIN_CALLED.add(key)
    plain_ms = start.elapsed_time(end)
    err = 0
    for label, fn in (("K13", cp.miller_loop),
                      ("the K4/K5 sequence", cp.miller_steps),
                      ("the thread-per-row probe", cp.miller_thread)):
        got = fn(p, q)
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max())
        if diff:
            raise AssertionError(f"{label} at {rows} rows: differs from "
                                 f"miller_loop_plain (max abs err {diff})")
        err = max(err, diff)
    log(f"K13 at {rows:,} rows: bit-identical to miller_loop_plain on one "
        f"input of random, all-LMAX and real pairs with ∞ rows (the K4/K5 "
        f"sequence and the thread-per-row probe too)")
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
        f"({steps_ms / ms:.2f}×); plain {plain_ms:.1f} ms"
        f"{'' if warm else ' (cold)'}; bound "
        f"{bms:.4f} ms by {by}")
    log(f"K13 probe: {json.dumps(probe)}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "plain_warm": warm, "bound_ms": bms, "bound_by": by,
            "rows": rows, "steps_ms": steps_ms, "lanes": mp.LANES,
            "slots": mp.SLOTS,
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
    want = host_pool().map(oracle_mul, [h] * nv, sks, chunksize=8)
    for k, w in enumerate(want):
        if got[f"0x{k:096x}"] != w:
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
    rows = sorted(gen.choice(v, 4, replace=False).tolist())
    for r, w in zip(rows, host_pool().map(oracle_combine,
                                          [sig_sets[r] for r in rows])):
        if got[f"0x{r:096x}"] != w:
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
    return launch_counts, p50, pool, sig_sets


# ---------------------------------------------------------------------------
# Phase 3b: the multi-card combine
# ---------------------------------------------------------------------------

#: the kernels of the phase's counted runs: the dry run's (its shard pass,
#: combine and re-check kernels) and the full-width combines' (K12, the
#: shards' K22 and K16, K19)
MULTICHIP_KERNELS = ("g2_decompress", "g2_law", "straus_msm",
                     "g2_normalize", "miller_loop", "pp_f12mul",
                     "final_exp", "fp_neg")


def multichip_layouts() -> dict:
    """The sharded combine's layouts: one shard a visible card, and four
    shards on cuda:0 (one card shows the split, the padding, each shard's
    device context and stream, the gather; not copies between cards nor
    shards running at once on different cards)."""
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return {"one_a_card": cards, "four_on_cuda0": [cards[0]] * 4}


def multichip_phase(dev, sig_sets: list[dict[int, bytes]]) -> dict:
    """The multi-card combine (module docstring, phase "multichip") on the
    combine phase's 10,000 × 7 batch → the launches of its counted runs
    (`dryrun_multichip` over every visible card, then the sharded combine
    at both layouts: K12's decompression, the shards' K22 and K16, K19's
    normalisation).  The unsharded reference bytes and K22 + K16 at 10,240
    rows are made before the count, the shard pass at both layouts after
    it."""
    from charon_tpu_torch import multichip
    from charon_tpu_torch.analysis import fixtures
    from charon_tpu_torch.analysis.audit import run_shard_audit
    from charon_tpu_torch.ops import codec, cuda_codec, cuda_g2
    from charon_tpu_torch.tbls import api, backend_cuda

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    log(f"multichip: torch.cuda.device_count() = {count}")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for i, line in enumerate(out.stdout.strip().splitlines()):
        log(f"multichip: card {i}: {line}")
    layouts = multichip_layouts()
    backend = api._backend()
    v, t = len(sig_sets), max(len(s) for s in sig_sets)

    # before the count: the unsharded combine's bytes, and its K22 + K16
    # at 10,240 rows on the same decompressed points
    want = backend.threshold_combine_bytes(sig_sets)
    prep = backend.combine_host_prep(sig_sets)
    put = backend._put
    vpad = prep["vpad"]

    def decompressed():
        pts, ok = cuda_codec.g2_decompress(put(prep["xc0"]),
                                           put(prep["xc1"]),
                                           put(prep["sign"]),
                                           put(prep["inf"]))
        if not bool((ok | ~put(prep["real"])).all()):
            raise AssertionError("multichip: a partial did not decompress")
        return pts

    pts = decompressed()
    digits = put(prep["digits"])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    tables = cuda_g2.straus_tables(cuda_g2.as_planes(pts))
    ev[1].record()
    cuda_g2.straus_msm(tables, digits, t)
    ev[2].record()
    ev[2].synchronize()
    unsharded = {"tables_s": ev[0].elapsed_time(ev[1]) / 1e3,
                 "straus_s": ev[1].elapsed_time(ev[2]) / 1e3,
                 "rows": vpad}
    del tables
    for devs in layouts.values():
        backend_cuda.prime_shards(t, digits.shape[0], devs)

    reset_all_launches()
    dry = multichip.dryrun_multichip(count)
    results = {}
    got_by_layout = {}
    for name, devs in layouts.items():
        walls, reps = [], []
        for rep in range(REPS):
            pts = decompressed()
            pts_vt = pts.view(3, 2, NL, t, vpad)[..., :v].permute(
                0, 1, 2, 4, 3)
            digits_vt = digits.view(-1, t, vpad)[..., :v].permute(0, 2, 1)
            timings = []
            for d in set(devs):
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            comb = backend_cuda.straus_combine_sharded(
                pts_vt, digits_vt, devs, timings=timings)
            for d in set(devs):
                torch.cuda.synchronize(d)
            walls.append(time.perf_counter() - t0)
            xc0, xc1, yc0, yc1, inf = cuda_codec.g2_normalize(comb)
            host = [a.cpu().numpy() for a in (xc0, xc1, yc0, yc1)]
            comp = codec.g2_compress_np(*[a.T for a in host],
                                        inf.cpu().numpy())
            got = [comp[k].tobytes() for k in range(v)]
            if got != want:
                bad = sum(a != b for a, b in zip(got, want))
                raise AssertionError(
                    f"multichip {name} rep {rep}: {bad} of {v} combined "
                    f"signatures differ from the unsharded combine's bytes")
            got_by_layout[name] = got
            reps.append([{"shard": s["shard"], "device": s["device"],
                          "validators": s["validators"],
                          "v_local": s["v_local"], **s["clock"].seconds()}
                         for s in timings])
            log(f"multichip {name} rep {rep}: {v} × {t} over {len(devs)} "
                f"shard(s), byte-equal to the unsharded combine; sharded "
                f"call {walls[-1]:.4f} s wall; per shard (K22 tables_s, K16 "
                f"straus_s, CUDA events on its stream): " + "; ".join(
                    f"{s['device']} #{s['shard']} {s['validators']}/"
                    f"{s['v_local']}: {s['tables_s']:.4f} + "
                    f"{s['straus_s']:.4f}" for s in reps[-1]))
        results[name] = {"devices": [str(d) for d in devs],
                         "wall_s": walls,
                         "wall_p50_s": statistics.median(walls),
                         "shards": reps}
    launches = all_launches()
    log(f"multichip: unsharded K22 + K16 at {vpad} rows: "
        f"{unsharded['tables_s']:.4f} + {unsharded['straus_s']:.4f} s")
    for k in MULTICHIP_KERNELS:
        if not launches[k]:
            raise AssertionError(f"multichip: {k} never launched in the "
                                 f"phase's runs")

    # the oracle on a sample of rows
    gen = np.random.default_rng(5)
    rows = sorted(gen.choice(v, 4, replace=False).tolist())
    for r, w in zip(rows, host_pool().map(oracle_combine,
                                          [sig_sets[r] for r in rows])):
        for name, got in got_by_layout.items():
            if got[r] != w:
                raise AssertionError(f"multichip {name}: row {r} != oracle")

    # the shard pass on the real devices at both layouts, and its
    # golden-bad on the card
    passes = {}
    for name, devs in layouts.items():
        t0 = time.perf_counter()
        (case,) = run_shard_audit(devices=devs)
        passes[name] = {"plans": case.plans_checked, "ops": case.ops,
                        "s": time.perf_counter() - t0}
        if case.violations:
            raise AssertionError(f"multichip shard pass {name}: "
                                 + "; ".join(case.violations))
    bad = fixtures.audit_golden_bad("replicated_carry", dev)
    if bad.ok:
        raise AssertionError("multichip: the golden-bad replicated_carry "
                             "was not flagged on the card")
    log("multichip: shard pass clean at both layouts "
        + json.dumps(passes) + "; golden-bad replicated_carry flagged: "
        + "; ".join(bad.violations))
    log("multichip: " + json.dumps({
        "device_count": count, "dryrun": {
            "devices": dry["devices"], "verdicts": dry["verdicts"],
            "audit_s": dry["audit_s"], "combine_s": dry["combine_s"],
            "verify_s": dry["verify_s"]},
        "layouts": results, "unsharded": unsharded,
        "launches": {k: n for k, n in launches.items() if n},
        "phase_s": time.perf_counter() - t_phase}))
    return launches


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


def oracle_verdicts(rows) -> list[bool]:
    """`oracle_verify` of each (pk, msg, sig) row, on the host's workers."""
    rows = list(rows)
    return list(host_pool().map(oracle_verify, *zip(*rows)))


def oracle_mul(point, k: int) -> bytes:
    """The pure-Python [k]·point of G2, compressed."""
    from charon_tpu_torch.tbls.ref import curve as rc

    return rc.g2_to_bytes(rc.multiply(point, k))


def oracle_hm(msg: bytes, dst: bytes | None = None) -> np.ndarray:
    """The pure-Python hash_to_g2(msg) (the signature DST by default) as
    the device pipeline's affine planes."""
    from charon_tpu_torch.ops import curve as tcurve
    from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2

    pt = hash_to_g2(msg) if dst is None else hash_to_g2(msg, dst)
    return tcurve.g2_pack([pt])[..., 0]


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
    import importlib

    from charon_tpu_torch.ops import launch_count

    return tuple(importlib.import_module(f"charon_tpu_torch.ops.{mod}")
                 for mod in launch_count.WRAPPER_MODULES)


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
    for r, ok in zip(sample, oracle_verdicts(batch[r] for r in sample)):
        if ok != oks[r]:
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
    from charon_tpu_torch.ops import cuda_g2, cuda_h2c
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
    want = list(host_pool().map(
        oracle_hm, [msgs[k] for k in sample] + list(J101_MSGS),
        [None] * len(sample) + [J101_DST] * len(J101_MSGS)))
    for k, w in zip(sample, want):
        if not np.array_equal(planes[..., k], w):
            raise AssertionError(f"h2c message {k}: != the oracle's H(m)")
    # the same pipeline under the J.10.1 suite's DST
    pts = cuda_h2c.hash_to_g2_rows(torch.from_numpy(
        cuda_h2c.pack_messages(J101_MSGS, J101_DST)).to(dev))
    jp = backend_cuda._affine_planes(cuda_g2.as_points(pts)).cpu().numpy()
    for k, (msg, w) in enumerate(zip(J101_MSGS, want[len(sample):])):
        if not np.array_equal(jp[..., k], w):
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
    for r, ok in zip(sample, oracle_verdicts(batch[r] for r in sample)):
        if ok != oks[r]:
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
    for r, ok in zip(sample, oracle_verdicts(batch[r] for r in sample)):
        if ok != oks[r]:
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
# Phase 8: the duty workflow — in-process DV clusters, real BLS, on the card
# ---------------------------------------------------------------------------

#: mainnet's slot; 4-slot epochs, so each validator attests every 4 slots
SIM_SLOT_S, SIM_SPE = 12.0, 4
#: the most slots a cluster's run may take (the phase fails past them)
SIM_MAX_SLOTS = 8
SIM_FORK = bytes(4)
#: the combine's kernels (the verify tile's are GRAPH_KERNELS): each must
#: launch in every slot a cluster's run waits for
SIM_COMBINE_KERNELS = ("g2_decompress", "g2_law", "straus_msm",
                       "g2_normalize")


def simnet_sign_seconds(reps: int = 5) -> float:
    """Median seconds of one pure-Python `tbls.sign` on this host: what a
    mock VC pays for a signature, on the event loop."""
    from charon_tpu_torch.tbls import api

    sk = api.int_to_privkey(0x5EED5EED)
    times = []
    for k in range(reps):
        t0 = time.perf_counter()
        api.sign(sk, b"charon-tpu-torch simnet sign %d" % k)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


#: the share of a slot the mock VCs' signing may take: up to the
#: aggregation offset (⅔), the last third left for verifying, combining
#: and broadcasting (at the whole slot, PR 13's chip run saw the loop hold
#: the slot's first flush past the slot's end)
SIM_SIGN_SHARE = 2 / 3


def simnet_validators(sign_s: float, nodes: int,
                      share: float = SIM_SIGN_SHARE) -> int:
    """Config 2's V: the largest count whose mock-VC signing fits `share`
    of a slot.  Each of the `nodes` VCs signs, a slot, a sync committee
    message for every validator and an attestation for the V / SPE (on
    average) that attest in it, in pure Python on the one event loop."""
    return max(1, int(share * SIM_SLOT_S
                      / (nodes * (1 + 1 / SIM_SPE) * sign_s)))


def simnet_attesters(bmock, slot: int, v: int) -> dict:
    """(committee, position) → validator index, for the validators that
    attest at `slot`."""
    duties = asyncio.run(bmock.attester_duties(slot // SIM_SPE,
                                               list(range(v))))
    out: dict = {}
    for d in duties:
        if d.slot == slot:
            key = (d.committee_index, d.validator_committee_index)
            out[key] = None if key in out else d.validator_index
    return out


def simnet_start_slot(bmock, v: int, slots: int) -> int:
    """The first slot from which each of `slots` slots has an attester and
    no two attesters on one committee position (the dutydb's reverse index
    refuses that, in the JAX package too)."""
    for s0 in range(64):
        atts = [simnet_attesters(bmock, s, v) for s in range(s0, s0 + slots)]
        if all(a and None not in a.values() for a in atts):
            return s0
    raise AssertionError(f"no {slots} slots with clean attesters for V={v}")


def simnet_oracle(cluster, records: list, label: str) -> int:
    """Every broadcast record (kind, validator index, signing root, bytes)
    carries exactly `ref.bls.sign` with the group secret (`combine_shares`
    of the share keys) over its signing root (`oracle_signs` a root on the
    host's workers) → the signatures computed."""
    from charon_tpu_torch.tbls import api

    by_root: dict = {}
    for _, vi, root, _ in records:
        vis = by_root.setdefault(root, [])
        if vi not in vis:
            vis.append(vi)
    roots = list(by_root)
    keys = [[api.privkey_to_int(api.combine_shares(
        cluster.validators[vi].share_privkeys)) for vi in by_root[r]]
        for r in roots]
    want = {(vi, root): sig for root, sigs in zip(
        roots, host_pool().map(oracle_signs, roots, keys))
        for vi, sig in zip(by_root[root], sigs)}
    for kind, vi, root, sig in records:
        if sig != want[(vi, root)]:
            raise AssertionError(f"{label}: {kind} of validator {vi} carries "
                                 f"{sig.hex()[:16]}…, not the oracle's "
                                 f"{want[(vi, root)].hex()[:16]}…")
    return len(want)


def rendered(registry) -> dict:
    """The registry's Prometheus text (`render`) → {(series, ((label,
    value), ...)): value}; a histogram by its _bucket, _sum and _count
    series."""
    return parse_metrics(registry.render())


def parse_metrics(text: str) -> dict:
    """Prometheus text → {(series, ((label, value), ...)): value}."""
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series, value = line.rsplit(" ", 1)
        name, _, labels = series.partition("{")
        out[(name, tuple(sorted(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"',
                                           labels))))] = float(value)
    return out


def lag_histogram(registry) -> dict:
    """`app_event_loop_lag_seconds` of a registry → {"samples", "mean_s",
    "le": {bound: cumulative count}} (one probe's series)."""
    r = rendered(registry)
    le = {dict(k[1])["le"]: int(v) for k, v in r.items()
          if k[0] == "app_event_loop_lag_seconds_bucket"}
    count = sum(v for k, v in r.items()
                if k[0] == "app_event_loop_lag_seconds_count")
    total = sum(v for k, v in r.items()
                if k[0] == "app_event_loop_lag_seconds_sum")
    return {"samples": int(count), "mean_s": total / max(1.0, count),
            "le": le}


#: the families every registry of a cluster must render after a run (the
#: core_qbft_ ones on QBFT only)
SIM_FAMILIES = (
    "core_qbft_decided_total", "core_qbft_round_duration_seconds",
    "core_qbft_current_round", "core_qbft_leader",
    "core_slot_phase_seconds", "core_slot_budget_remaining_seconds",
    "charon_tpu_tracker_participation",
    "charon_tpu_tracker_duties_analysed_total",
    "charon_tpu_tracker_inclusion_delay", "core_dispatch_stage_seconds",
    "core_bcast_delay_seconds", "core_bcast_broadcast_total",
    "core_parsigex_inbound_total", "core_parsigex_outbound_total",
    "app_event_loop_lag_seconds", "app_dispatch_queue_depth",
    "core_dispatch_overlap_efficiency", "charon_tpu_hbm_live_bytes",
    "app_span_duration_seconds", "charon_tpu_devcache_resident",
    "charon_tpu_devcache_rows", "app_cuda_graphs_total",
    "app_cuda_build_seconds", "core_dispatch_launches_total")


def simnet_qbft(label: str, nodes, sniffers, waited_duties) -> None:
    """A QBFT cluster's instances after its run: prints, per consensus duty
    and node, the decided round, timeouts and round changes (the
    `consensus/qbft/{slot}` span and the sniffer's `render_json`).  Raises
    unless every node has both for every waited consensus duty."""
    from charon_tpu_torch.core.types import DutyType

    qbft: dict = {}
    for i, node in enumerate(nodes, 1):
        spans = {s.attrs.get("duty"): s for s in node.tracer.spans
                 if s.name.startswith("consensus/qbft/")}
        inst = {x["duty"]: x for x in json.loads(
            sniffers[i - 1].render_json())["instances"]}
        for duty in waited_duties:
            if duty.type != DutyType.ATTESTER:
                continue
            sp, sn = spans.get(str(duty)), inst.get(str(duty))
            if sp is None or sn is None:
                raise AssertionError(f"simnet {label}: node {i} has no QBFT "
                                     f"span or sniffer entry for {duty}")
            qbft.setdefault(str(duty), {})[f"node{i}"] = {
                "decided": sp.attrs.get("decided"),
                "round": sp.attrs.get("rounds"),
                "timeouts": sum(m["rule"] == "ROUND_TIMEOUT"
                                for m in sn["msgs"]),
                "round_changes": sp.attrs.get("rounds", 1) - 1,
                "s": round(sp.attrs.get("duration", 0.0), 4),
                "rules": sn["n_msgs"]}
    log(f"simnet {label}: QBFT per duty and node (instance span, sniffer): "
        + json.dumps(qbft))


def simnet_telemetry(label: str, nodes, reports: dict, budgets: dict,
                     waited_duties, qbft: bool) -> None:
    """A cluster's telemetry after its run: prints, per duty and node, the
    tracker's verdict and the slot budget's hand-offs in seconds from slot
    start; from node 1's rendered registry its QBFT counters per duty type,
    the sums of `core_dispatch_stage_seconds{stage,op}`, the cuda/* spans
    and the event-loop lag; the device-memory gauge beside
    `torch.cuda.memory_allocated`.  Raises unless every waited duty is a
    success with full participation on every node and every registry
    renders `SIM_FAMILIES`."""
    from charon_tpu_torch.app import monitoring
    from charon_tpu_torch.core.slotbudget import PHASES

    n = len(nodes)
    bad = []
    for (i, duty), r in sorted(reports.items(), key=lambda kv: (
            kv[0][1], kv[0][0])):
        full = r.participation == {k: True for k in range(1, n + 1)}
        if not (r.success and full):
            bad.append((i, str(duty), r.failed_step, r.reason,
                        r.participation))
    verdicts = {str(d): "".join("S" if reports[(i, d)].success else "F"
                                for i in range(1, n + 1))
                for d in waited_duties}
    log(f"simnet {label}: tracker verdicts per duty, nodes 1–{n} "
        f"(S success, F failure): " + json.dumps(verdicts))
    if bad:
        raise AssertionError(f"simnet {label}: tracked as failed or short "
                             f"of full participation: {bad}")
    by_type: dict = {}
    for i in range(1, n + 1):
        for duty in waited_duties:
            ph = budgets[i].get(duty)
            if ph is None:
                raise AssertionError(f"simnet {label}: node {i} has no slot "
                                     f"budget for {duty}")
            cum, at = {}, 0.0
            for phase in PHASES:
                if phase in ph:
                    at += ph[phase]
                    cum[phase] = round(at, 3)
            by_type.setdefault(duty.type.name.lower(), {}).setdefault(
                f"node{i}", {})[duty.slot] = cum
    for dtype, per_node in sorted(by_type.items()):
        log(f"simnet {label}: slot budget, {dtype}: seconds from slot start "
            "at each hand-off (first validator), per node and slot: "
            + json.dumps(per_node))
    log(f"simnet {label}: late duties (past the {SIM_SLOT_S:.0f} s budget) "
        "per node: " + json.dumps([nd.slotbudget.late_duties
                                   for nd in nodes]))
    reg0 = rendered(nodes[0].registry)
    if qbft:
        counters = {f"{k[0][len('core_qbft_'):]}[{dict(k[1]).get('duty')}]":
                    v for k, v in sorted(reg0.items())
                    if k[0].startswith("core_qbft_")
                    and k[0].endswith("_total")}
        log(f"simnet {label}: node 1's QBFT counters per duty type: "
            + json.dumps(counters))
    stages = {f"{dict(k[1])['op']}/{dict(k[1])['stage']}":
              [round(v, 4), int(reg0[("core_dispatch_stage_seconds_count",
                                      k[1])])]
              for k, v in sorted(reg0.items())
              if k[0] == "core_dispatch_stage_seconds_sum"}
    spans = {dict(k[1])["span"]: [round(v, 4), int(reg0[(
        "app_span_duration_seconds_count", k[1])])]
             for k, v in sorted(reg0.items())
             if k[0] == "app_span_duration_seconds_sum"
             and dict(k[1])["span"].startswith("cuda/")}
    log(f"simnet {label}: core_dispatch_stage_seconds sums [s, jobs] "
        "(one process pipeline, the same series on every registry): "
        + json.dumps(stages) + "; cuda spans [s, count]: "
        + json.dumps(spans))
    if not {"verify/device_exec", "combine/device_exec"} <= set(stages):
        raise AssertionError(f"simnet {label}: stage histograms {stages}")
    log(f"simnet {label}: node 1's app_event_loop_lag_seconds "
        + json.dumps(lag_histogram(nodes[0].registry)))
    dev = torch.device("cuda", torch.cuda.current_device())
    families = [f for f in SIM_FAMILIES
                if qbft or not f.startswith("core_qbft_")]
    gauges = []
    for i, node in enumerate(nodes, 1):
        reg = node.registry
        monitoring.export_devcache_metrics(reg)
        monitoring.export_dispatch_metrics(reg)
        text = reg.render()
        missing = [f for f in families if f not in text]
        if missing:
            raise AssertionError(f"simnet {label}: node {i}'s registry "
                                 f"lacks {missing}")
        gauges.append(rendered(reg).get(("charon_tpu_hbm_live_bytes",
                                         (("node", f"node{i - 1}"),))))
    now = torch.cuda.memory_allocated(dev)
    log(f"simnet {label}: charon_tpu_hbm_live_bytes per node (last 5 s "
        f"sample) {gauges}; torch.cuda.memory_allocated now {now}; every "
        f"registry renders {len(families)} families "
        f"({len(nodes[0].registry.render())} bytes on node 1)")
    if not all(g and g > 0 for g in gauges):
        raise AssertionError(f"simnet {label}: device-memory gauge {gauges}")


def simnet_cluster(label: str, n: int, t: int, v: int, slots: int,
                   sync: bool, consensus: str = "leadercast",
                   telemetry: bool = False, seed: str | None = None,
                   signer=None) -> tuple[dict, dict]:
    """One in-process cluster on the card, on a fresh resident backend (its
    host LRUs and device stores empty, so no run finds another's hashed
    roots): n `Node`s (`consensus`: leadercast or QBFT; with `telemetry` a
    metrics registry, tracker and slot budget on every node; the
    in-memory parsigex), one `BeaconMock`, a mock VC a node, the keys of
    `new_cluster_for_test` from `seed` (default: the label; the VCs sign
    on the loop, or on `signer`, an executor, when given); `prewarm`
    with the cluster's pubshares at its (V, T) and at each verify bucket
    its flushes can reach, then the run from the first of `slots` slots
    that have attesters (the VCs sign in those slots) until every duty of
    those slots reached the BeaconMock from every node (at most
    SIM_MAX_SLOTS).  An event-loop lag probe of the script's own runs in
    every cluster alike.  Checks: every record the oracle's bytes, every
    node the same bytes, no duty missing, every waited consensus duty
    decided alike on every node, the resident route, no K1, and the verify
    tile's and the combine's kernels launched in every slot waited for;
    on QBFT each instance's span and sniffer entry (`simnet_qbft`); with
    telemetry also the trackers' verdicts and the registries' families
    (`simnet_telemetry`).  → (the run's launches, {"bcast_s": seconds from
    slot start to each node's broadcast, "consensus_s": each node's slot
    budget consensus phase (telemetry only), "lag": the script's
    loop-lag histogram})."""
    from charon_tpu_torch.app.monitoring import Registry, loop_lag_probe
    from charon_tpu_torch.app.node import Node, NodeConfig
    from charon_tpu_torch.app.qbftdebug import QBFTSniffer
    from charon_tpu_torch.app.tracing import Tracer, duty_trace_id
    from charon_tpu_torch.core.consensus import (ConsensusMemNetwork,
                                                 QBFTConsensus)
    from charon_tpu_torch.core.leadercast import (LeaderCast,
                                                  MemTransportNetwork)
    from charon_tpu_torch.core.parsigex import MemParSigExNetwork
    from charon_tpu_torch.core.types import Duty, DutyType
    from charon_tpu_torch.eth2util.signing import DomainName, signing_root
    from charon_tpu_torch.eth2util.ssz import Bitlist
    from charon_tpu_torch.tbls import api, backend_cuda, dispatch
    from charon_tpu_torch.testutil.beaconmock import BeaconMock
    from charon_tpu_torch.testutil.cluster import new_cluster_for_test
    from charon_tpu_torch.testutil.validatormock import ValidatorMock

    api.register_backend("cuda", backend_cuda.CUDABackend())
    be = api._backend()
    pipe = dispatch.default_pipeline()
    t0 = time.perf_counter()
    cluster = new_cluster_for_test(t, n, v, seed=b"chip-smoke " +
                                   (seed or label).encode())
    keygen_s = time.perf_counter() - t0
    probe = BeaconMock(slot_duration=SIM_SLOT_S, slots_per_epoch=SIM_SPE,
                       genesis_time=0.0)
    for val in cluster.validators:
        probe.add_validator(val.group_pubkey)
    s0 = simnet_start_slot(probe, v, slots)
    waited = list(range(s0, s0 + slots))
    attesters = {s: simnet_attesters(probe, s, v)
                 for s in range(s0, s0 + SIM_MAX_SLOTS + 1)}

    # prewarm before the first slot: the cluster's (V, T), then every
    # verify bucket up to the largest flush a node can make (its own VC's
    # and its peers' partials of a slot)
    pubshares = [ps for val in cluster.validators
                 for ps in val.pubshares.values()]
    largest = backend_cuda._pad_pow2(n * v * (2 if sync else 1))
    sizes = [v] + [b for b in (1 << k for k in range(largest.bit_length()))
                   if b != api.verify_padded_rows(v)]

    async def prewarm():
        return [await pipe.prewarm(pubshares, size, t) for size in sizes]

    t0 = time.perf_counter()
    reports = asyncio.run(prewarm())
    prewarm_s = time.perf_counter() - t0
    log(f"simnet {label}: {n} nodes, {t}-of-{n}, V = {v}, "
        f"{'attestation + sync committee message' if sync else 'attestation'}"
        f", {consensus}{' + telemetry' if telemetry else ''}; keys {keygen_s:.3f} s; prewarm at V = {sizes} {prewarm_s:.3f} s "
        f"(the cluster's: {json.dumps(reports[0])}); graphs "
        f"{backend_cuda.resident_graph_keys()}; slots {waited}")

    # genesis: slot s0 starts as the nodes start
    genesis = time.time() - s0 * SIM_SLOT_S - 0.05
    bmock = BeaconMock(slot_duration=SIM_SLOT_S, slots_per_epoch=SIM_SPE,
                       genesis_time=genesis)
    for val in cluster.validators:
        bmock.add_validator(val.group_pubkey)

    async def no_proposals(*_):
        return []

    # configs 1 and 2 carry no block duty
    bmock.overrides["proposer_duties"] = no_proposals
    pubshares_by_peer = {i: cluster.pubshare_map(i) for i in range(1, n + 1)}
    psx_net, lc_net = MemParSigExNetwork(), MemTransportNetwork()
    qnet = ConsensusMemNetwork()
    #: config 2's validator client: attestations and the sync committee's
    #: messages alone (no selection proofs or contributions)
    flows = ("attester", "sync_message") if sync else ("attester",)
    #: node index → {duty: {pubkey: hash tree root}} of its decisions
    decided: dict[int, dict] = {}
    sniffers: list = []
    #: slot → the probes' snapshot at the first node's tick of it, taken
    #: before any VC of that slot starts
    ticks: dict[int, dict] = {}

    async def on_tick(tick) -> None:
        if tick.slot not in ticks:
            ticks[tick.slot] = snap()

    def waited_only(on_slot):
        """The VCs sign in the waited slots only: at V near the loop's
        limit a backlog of later slots' signing would starve the waited
        duties, and the run ends once they are in."""
        async def fn(tick) -> None:
            if tick.slot in waited:
                await on_slot(tick)
        return fn

    def decision_sink(i: int):
        async def fn(duty, unsigned) -> None:
            decided.setdefault(i, {})[duty] = {
                pk: ud.hash_tree_root() for pk, ud in unsigned.items()}
        return fn

    #: node index → {duty: {pubkey: share indices}} of the partials it
    #: holds, its own and its peers'
    shares: dict[int, dict] = {i: {} for i in range(1, n + 1)}

    def share_sink(i: int):
        async def fn(duty, pset) -> None:
            for pk, psig in pset.items():
                shares[i].setdefault(duty, {}).setdefault(pk, set()).add(
                    psig.share_idx)
        return fn

    #: (node index, duty) → the tracker's report
    reports: dict = {}

    def report_sink(i: int):
        async def fn(report) -> None:
            reports[(i, report.duty)] = report
        return fn

    nodes = []
    for i in range(1, n + 1):
        reg = (Registry(const_labels={"node": f"node{i - 1}"})
               if telemetry else None)
        tracer = Tracer(reg)
        if consensus == "qbft":
            sniffers.append(QBFTSniffer())
            cons = QBFTConsensus(qnet, i - 1, n, sniffer=sniffers[-1],
                                 registry=reg, tracer=tracer,
                                 trace_id_fn=duty_trace_id)
        else:
            cons = LeaderCast(lc_net, i - 1, n)
        cons.subscribe(decision_sink(i))
        psx = psx_net.join(registry=reg)
        node = Node(NodeConfig(share_idx=i, threshold=t,
                               pubshares_by_peer=pubshares_by_peer,
                               fork_version=SIM_FORK),
                    bmock, consensus=cons, parsigex=psx,
                    slots_per_epoch=SIM_SPE, genesis_time=genesis,
                    slot_duration=SIM_SLOT_S, registry=reg, tracer=tracer,
                    fetched_types=(DutyType.ATTESTER,))
        if telemetry:
            node.parsigdb.subscribe_internal(share_sink(i))
            psx.subscribe(share_sink(i))
            node.tracker.subscribe(report_sink(i))
        vmock = ValidatorMock(node.vapi, cluster.share_privkey_map(i),
                              SIM_FORK, slots_per_epoch=SIM_SPE,
                              eth2cl=bmock if sync else None, flows=flows,
                              signer=signer)
        node.scheduler.subscribe_slots(on_tick)
        node.scheduler.subscribe_slots(waited_only(vmock.on_slot))
        nodes.append(node)
    #: node index → {duty: the slot budget's phases}
    budgets: dict[int, dict] = {i: {} for i in range(1, n + 1)}

    def tracked_all(i: int, duty) -> bool:
        """Node i holds a partial of every share for every validator of
        `duty`."""
        got = shares[i].get(duty, {})
        return bool(got) and all(len(s) == n for s in got.values())

    def records() -> dict:
        """(kind, slot, validator index) → [(signing root, bytes)], one
        entry a node's broadcast."""
        out: dict = {}
        for att in bmock.attestations:
            pos = Bitlist.to_bools(att.aggregation_bits).index(True)
            vi = attesters.get(att.data.slot, {}).get((att.data.index, pos))
            if vi is None and att.data.slot not in waited:
                continue    # two attesters on one position, past the wait
            root = signing_root(DomainName.BEACON_ATTESTER,
                                att.data.hash_tree_root(), SIM_FORK)
            out.setdefault(("attestation", att.data.slot, vi),
                           []).append((root, att.signature))
        for msg in bmock.sync_messages:
            root = signing_root(DomainName.SYNC_COMMITTEE,
                                msg.beacon_block_root, SIM_FORK)
            out.setdefault(("sync_message", msg.slot, msg.validator_index),
                           []).append((root, msg.signature))
        for kind, got in (("block", bmock.blocks),
                          ("contribution", bmock.sync_contributions)):
            if got:
                raise AssertionError(f"simnet {label}: {len(got)} {kind}s; "
                                     "the config has no such duty")
        return out

    expected = {("attestation", s, vi) for s in waited
                for vi in attesters[s].values()}
    if sync:
        expected |= {("sync_message", s, vi) for s in waited
                     for vi in range(v)}

    def done() -> bool:
        got = records()
        return all(len(got.get(k, ())) == n for k in expected)

    #: the duties the run waits for, as the trackers see them
    waited_duties = [Duty(s, DutyType.ATTESTER) for s in waited
                     if attesters[s]]
    if sync:
        waited_duties += [Duty(s, DutyType.SYNC_MESSAGE) for s in waited]

    # the run's probes: the pipeline's combines (wall start, validators),
    # the combine stages on the launch thread, snapshots at slot ticks
    combines, combine_stages = [], []
    real_combine, real_exec = pipe.threshold_combine, be.combine_device_exec

    async def counted_combine(batch, stats=None):
        combines.append((time.time(), len(batch)))
        return await real_combine(batch, stats=stats)

    def exec_and_note(prepared):
        out = real_exec(prepared)
        combine_stages.append(dict(be.last_stages))
        return out

    def snap() -> dict:
        return {"t": time.time(),
                "flushes": sum(nd.verifier.launches for nd in nodes),
                "entries": sum(nd.verifier.entries_total for nd in nodes),
                "combines": len(combines),
                "combine_rows": sum(r for _, r in combines),
                "launches": all_launches(),
                "stages": dict(be.verify_totals),
                "graphs": len(backend_cuda.resident_graph_keys())}

    async def run() -> list[dict]:
        lag_task = asyncio.get_running_loop().create_task(
            loop_lag_probe(lag_reg))
        for node in nodes:
            node.start()
        try:
            while not done() and len(ticks) <= SIM_MAX_SLOTS:
                await asyncio.sleep(0.05)
            snaps = [ticks[k] for k in sorted(ticks)] + [snap()]
            if telemetry and done():
                # the partials that arrive after each node's threshold
                # (the 4th of a 3-of-4) still count for participation
                t_end = time.time() + SIM_SLOT_S
                while time.time() < t_end and not all(
                        tracked_all(i, d) for i in range(1, n + 1)
                        for d in waited_duties):
                    await asyncio.sleep(0.05)
        finally:
            lag_task.cancel()
            for node in nodes:
                node.stop()
            # the pipeline's stages are FIFO: a no-op through each, awaited,
            # means no launch of this run is still running
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(pipe._prep_pool, lambda: None)
            await loop.run_in_executor(pipe._launch_pool, lambda: None)
        # what `_gc_loop` does at each duty's deadline (5 slots on), now;
        # the phases first, as the report's subscriber would finalise them
        for i, node in enumerate(nodes, 1):
            if node.tracker is None:
                continue
            for duty in waited_duties:
                if (i, duty) in reports:
                    continue    # analysed at its deadline, phases gone
                phases = node.slotbudget.finalize(duty)
                if phases is not None:
                    budgets[i][duty] = phases
                await node.tracker.analyse(duty)
        return snaps

    lag_reg = Registry()
    be.reset_verify_totals()
    reset_all_launches()
    pipe.threshold_combine, be.combine_device_exec = (counted_combine,
                                                      exec_and_note)
    try:
        snaps = asyncio.run(run())
    finally:
        del pipe.threshold_combine, be.combine_device_exec
    got = records()
    run_s = snaps[-1]["t"] - snaps[0]["t"]

    # every waited consensus duty decided on every node, with one value
    undecided = [(i, str(d)) for d in waited_duties
                 if d.type == DutyType.ATTESTER for i in range(1, n + 1)
                 if d not in decided.get(i, {})]
    if undecided:
        raise AssertionError(f"simnet {label}: {consensus} never decided "
                             f"{undecided}")
    for d in waited_duties:
        if d.type == DutyType.ATTESTER and len(
                {tuple(sorted(decided[i][d].items()))
                 for i in range(1, n + 1)}) != 1:
            raise AssertionError(f"simnet {label}: nodes decided different "
                                 f"values for {d}")

    # every duty of the waited slots from every node, every node the same
    # bytes, every record the oracle's bytes
    missing = sorted(k for k in expected if len(got.get(k, ())) != n)
    if missing:
        raise AssertionError(f"simnet {label}: duties missing or short of "
                             f"{n} broadcasts after {run_s:.1f} s: "
                             f"{missing[:8]} ({len(missing)})")
    split = [k for k, recs in got.items() if len({s for _, s in recs}) != 1]
    if split or any(k[2] is None for k in got):
        raise AssertionError(f"simnet {label}: nodes broadcast different "
                             f"bytes for {split}, or an unknown attester")
    signed = simnet_oracle(cluster, [(k[0], k[2], *recs[0])
                                     for k, recs in got.items()],
                           f"simnet {label}")

    # the resident route, no K1, the kernels of both call sites each slot
    paths = {p for nd in nodes for p in nd.verifier.paths}
    if paths != {api.verify_path(1)} or not api.verify_path(1).endswith(
            "+res"):
        raise AssertionError(f"simnet {label}: verify paths {paths}")
    counts = all_launches()
    check_no_k1(f"simnet {label}", counts)
    idle: dict[int, list] = {}
    for slot, (a, b) in zip(sorted(ticks), zip(snaps, snaps[1:])):
        d = {name: b["launches"][name] - a["launches"][name]
             for name in counts}
        st = {name: b["stages"].get(name, 0.0) - a["stages"].get(name, 0.0)
              for name in b["stages"]}
        cs = combine_stages[a["combines"]:b["combines"]]
        log(f"simnet {label} slot {slot}: {b['flushes'] - a['flushes']} "
            f"verify flushes ({b['entries'] - a['entries']} entries), "
            f"{b['combines'] - a['combines']} combines "
            f"({b['combine_rows'] - a['combine_rows']} validators, padded "
            f"to {api.combine_padded_rows(1, t)} a combine), graph captures "
            f"{b['graphs'] - a['graphs']} "
            f"({st.get('graph_capture_s', 0.0):.4f} s); verify stages "
            + json.dumps({name: round(s, 4) for name, s in st.items() if s})
            + "; combine decompress_s (K12) "
            + json.dumps([round(c.get("decompress_s", 0.0), 5) for c in cs])
            + ", straus_s (K16) "
            + json.dumps([round(c.get("straus_s", 0.0), 5) for c in cs])
            + "; launches " + json.dumps({name: c for name, c in d.items()
                                          if c}))
        never = [name for name in (*GRAPH_KERNELS, *SIM_COMBINE_KERNELS)
                 if not d[name]]
        if slot in waited and never:
            idle[slot] = never
    bcast_s = []
    for i, node in enumerate(nodes):
        by_duty: dict = {}
        for duty, delay in node.bcast.broadcast_delays:
            by_duty.setdefault(str(duty), []).append(delay)
            bcast_s.append(delay)
        log(f"simnet {label} node {i + 1}: seconds from slot start to the "
            "broadcast, per duty: " + json.dumps(
                {duty: [len(ds), round(min(ds), 3),
                        round(statistics.median(ds), 3), round(max(ds), 3)]
                 for duty, ds in sorted(by_duty.items())}))
    if idle:
        raise AssertionError(f"simnet {label}: slots without these "
                             f"launches: {idle}")
    if consensus == "qbft":
        simnet_qbft(label, nodes, sniffers, waited_duties)
    if telemetry:
        simnet_telemetry(label, nodes, reports, budgets, waited_duties,
                         qbft=consensus == "qbft")
    lag = lag_histogram(lag_reg)
    log(f"simnet {label}: the script's app_event_loop_lag_seconds "
        + json.dumps(lag))
    cs = combine_stages
    log(f"simnet {label}: every duty of slots {waited} from all {n} nodes "
        f"({len(got)} duties, {len(expected)} waited for), byte-equal to "
        f"the oracle ({signed} signatures), decided alike on every node by "
        f"{consensus}; run {run_s:.3f} s; route "
        f"{api.verify_path(1)}; combines {len(cs)}, median decompress_s "
        f"(K12) {statistics.median(c['decompress_s'] for c in cs):.5f}, "
        f"straus_s (K16) {statistics.median(c['straus_s'] for c in cs):.5f}")
    consensus_s = [ph["consensus"] for i in budgets
                   for ph in budgets[i].values() if "consensus" in ph]
    return counts, {"bcast_s": bcast_s, "consensus_s": consensus_s,
                    "lag": lag}


#: config 1's runs: (label, consensus, telemetry), leadercast and QBFT
#: each with and without the registry path, in an order that puts neither
#: consensus nor telemetry always first; every run on the same keys
SIM_CONFIG1_RUNS = (("config1", "leadercast", False),
                    ("config1-qbft-telemetry", "qbft", True),
                    ("config1-telemetry", "leadercast", True),
                    ("config1-qbft", "qbft", False))


def simnet_compare(results: dict) -> None:
    """Config 1's four runs side by side: the median seconds from slot
    start to a node's broadcast, the slot budget's consensus phase, the
    script's loop-lag mean; then QBFT − leadercast with and without
    telemetry, and telemetry − none on each consensus."""
    med = {label: statistics.median(r["bcast_s"])
           for label, r in results.items()}
    log("simnet config 1: " + json.dumps({
        label: {"bcast_s": [round(x, 3) for x in sorted(r["bcast_s"])],
                "bcast_median_s": round(med[label], 3),
                "consensus_phase_s": [round(x, 4) for x in r["consensus_s"]],
                "loop_lag_mean_s": round(r["lag"]["mean_s"], 4),
                "loop_lag_samples": r["lag"]["samples"]}
        for label, r in results.items()}))
    log("simnet config 1: median broadcast, QBFT − leadercast: "
        f"{med['config1-qbft'] - med['config1']:+.3f} s without telemetry, "
        f"{med['config1-qbft-telemetry'] - med['config1-telemetry']:+.3f} s "
        "with it; telemetry − none: "
        f"{med['config1-telemetry'] - med['config1']:+.3f} s on leadercast, "
        f"{med['config1-qbft-telemetry'] - med['config1-qbft']:+.3f} s on "
        "QBFT")


def simnet_phase() -> dict:
    """BASELINE.json config 1 (1 validator, 4-of-4, attestation) on
    leadercast and on QBFT, each with and without the telemetry
    (`SIM_CONFIG1_RUNS`), and config 2's cluster (3-of-4, attestation +
    sync committee message, V the largest count whose mock-VC signing fits
    ⅔ of a slot on one loop, the VCs signing in four worker processes) on
    QBFT with telemetry, each cluster on a fresh resident
    backend (the card's default route) → the launches of the five runs."""
    from charon_tpu_torch.tbls import api

    bytes_be = api._backend()
    try:
        sign_s = simnet_sign_seconds()
        v = simnet_validators(sign_s, 4)
        per_slot = 4 * (1 + 1 / SIM_SPE) * v
        log(f"simnet: one pure-Python tbls.sign {sign_s:.4f} s (median of "
            f"5) → config 2's V = {v} ({per_slot:.1f} signatures a slot "
            f"expected, {per_slot * sign_s:.2f} s of a {SIM_SLOT_S:.0f} s "
            f"slot; V = {simnet_validators(sign_s, 4, 1.0)} at the whole "
            "slot)")
        runs, config1 = [], {}
        for label, consensus, telemetry in SIM_CONFIG1_RUNS:
            counts, config1[label] = simnet_cluster(
                label, 4, 4, 1, 1, sync=False, consensus=consensus,
                telemetry=telemetry, seed="config1")
            runs.append(counts)
        simnet_compare(config1)
        # config 2's VCs sign in worker processes (spawned: never a fork
        # after CUDA is up), as the App's VC does: on the one loop a slot's
        # 50-odd signatures held the slot before's combines past the next
        # slot's tick.  Each worker signs once before the run, so none
        # starts in a slot
        with ProcessPoolExecutor(
                max_workers=4,
                mp_context=multiprocessing.get_context("spawn")) as signer:
            sk = api.int_to_privkey(0x5EED5EED)
            list(signer.map(api.sign, [sk] * 4,
                            [b"warm %d" % k for k in range(4)]))
            runs.append(simnet_cluster("config2-qbft", 4, 3, v, 2, sync=True,
                                       consensus="qbft", telemetry=True,
                                       signer=signer)[0])
    finally:
        api.register_backend("cuda", bytes_be)
    return {name: sum(r[name] for r in runs) for name in runs[0]}


# ---------------------------------------------------------------------------
# Phase 10: the node as a process — four `python -m charon_tpu_torch run`
# ---------------------------------------------------------------------------

#: BASELINE.json config 2's cluster: 4 nodes, 3-of-4, 12 s slots (of
#: SIM_SPE-slot epochs), attestation + sync committee message, QBFT
CL_NODES, CL_T = 4, 3
#: each node's attester duty is signed by a VC process of its own (the
#: port's `testutil.httpvc`) over HTTP through the node's validator-API
#: router (`:vc`: not by the mock); its sync messages by the node's
#: in-process validator mock (the HTTP VC, as the JAX one, has no
#: sync-committee flow)
CL_FLOWS, CL_VC_FLOWS = "attester:vc,sync_message", "attester"
#: the base of the VCs over HTTP: this phase as it ran before they moved
#: there (its VCs in the nodes' processes, no router, no auto-profiler)
#: on an H100 80GB HBM3 at 700 W, V = 37 (a sign of 0.1036 s) — each
#: node's median seconds from slot start to an attestation's arrival at
#: the mock in each slot of the up window, and the arrivals past their
#: slot's end by kind and window
CL_BASE = {
    "v": 37,
    "attestation_up": {1: [14.236, 14.723, 15.037],
                       2: [14.048, 14.79, 14.588],
                       3: [14.829, 15.19, 15.049],
                       4: [15.007, 15.313, 15.327]},
    "late": {"attestation/down": [31, 57], "attestation/up": [80, 112],
             "sync_message/down": [222, 222], "sync_message/up": [444, 444]},
}
#: the /debug/profile capture's seconds and the captures tried until one
#: names a kernel of the port (each on the next node)
CL_PROFILE_S, CL_PROFILE_TRIES = 2.0, 3
#: config 2's V; the phase cuts it to what one node's VC signs in ⅔ slot,
#: and at most to what one card keeps up with for four node processes
#: (four CUDA contexts time-slice it): on an H100 at V = 37 every waited
#: duty arrived, each slot's sync messages ≈ 1.3 s later than the slot
#: before and all past their slot's end; at V = 44 a node was still 24 of
#: 44 sync messages short CL_LATE_SLOTS slots after the window
CL_V_FULL, CL_V_CARD = 500, 37
#: slots the phase waits, past its window's last slot, for every waited
#: duty to arrive at all (it fails past them); a duty that arrives after
#: its own slot's end is past its deadline, and is counted and reported
CL_LATE_SLOTS = 3
#: slots waited with every node up, then with node 4 down
CL_UP_SLOTS, CL_DOWN_SLOTS = 3, 2
#: the mock's genesis, in seconds after the spawn: every node must be
#: ready (/readyz 200 with its prewarm and profiler set-up done) before
#: it, so that no slot is scheduled before the cluster is up; and the
#: seconds a node may take to exit after SIGTERM
CL_GENESIS_S, CL_EXIT_TIMEOUT = 90.0, 60.0
#: the nodes boot beside the chaos phase's runs: `main` spawns them once
#: the runs' estimated seconds left (`chaos_left`) plus CHAOS_TAIL_S (the
#: runs' cool-down and final check, the oracle, the two stress runs) are
#: CL_SPAWN_SLACK_S under CL_GENESIS_S, so that the phase ends before the
#: genesis and no slot of the nodes runs beside it (a node's slots before
#: the waited ones leave it behind: on an H100, ten of them beside the
#: whole phase put slot 12's sync messages over CL_LATE_SLOTS late)
CHAOS_TAIL_S, CL_SPAWN_SLACK_S = 30.0, 20.0
#: the verify and combine kernels every node must launch, and K21 (the
#: pubshares' decompression at prewarm)
CL_NODE_KERNELS = ("g1_decompress",)


def free_ports(n: int) -> list[int]:
    """n ports the kernel hands out for port 0 now."""
    import socket

    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


#: the ports `quiet_base_port` draws from: below Linux's default
#: ephemeral range (32768–60999), which the run's outgoing connections
#: and `free_ports` take theirs from
QUIET_PORTS = (20000, 32000)


def quiet_base_port(n: int) -> int:
    """A base port whose n consecutive ports are free now and lie outside
    the ephemeral range: `create cluster` writes the mesh ports into the
    ENRs during the build, and no connection of the phases between takes
    one of them before the nodes bind it."""
    import socket

    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(QUIET_PORTS[0], QUIET_PORTS[1] - n)
        socks = []
        try:
            for p in range(base, base + n):
                sock = socket.socket()
                socks.append(sock)
                sock.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    raise AssertionError("cluster: no free run of mesh ports")


def http_get(port: int, path: str, timeout: float = 5.0) -> tuple[int, bytes]:
    """(status, body) of one GET on a node's monitoring API; (0, b"") when
    nothing answers."""
    import http.client

    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        conn.request("GET", path)
        resp = conn.getresponse()
        out = resp.status, resp.read()
        conn.close()
        return out
    except OSError:
        return 0, b""


def cluster_attester_duties(mock):
    """An `attester_duties` override with no two attesters on one
    (committee, position), as on a real chain: validator i attests at the
    epoch's slot i mod SPE, in committee k mod 4 at position k div 4
    (k = i div SPE)."""
    from charon_tpu_torch.testutil.beaconmock import AttesterDutyInfo

    async def duties(epoch: int, indices: list[int]):
        by_index = {v.index: v for v in mock.validators.values()}
        out = []
        for i in indices:
            v = by_index.get(i)
            if v is None:
                continue
            k = i // mock.slots_per_epoch
            out.append(AttesterDutyInfo(
                pubkey=v.pubkey, validator_index=i,
                slot=epoch * mock.slots_per_epoch + i % mock.slots_per_epoch,
                committee_index=k % 4, committee_length=64,
                committees_at_slot=4, validator_committee_index=k // 4))
        return out

    return duties


def crypto_costs(reps: int = 20) -> dict:
    """Median seconds on this host of the mesh's pure-Python primitives:
    an Ed25519 sign and verify, an X25519 exchange, and a frame's seal and
    open at 1 kB and 64 kB."""
    from charon_tpu_torch.p2p import aead, ed25519

    def med(fn) -> float:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    seed, msg = bytes(range(32)), bytes(300)
    pub = ed25519.public_key(seed)
    sig = ed25519.sign(seed, msg)
    aead_ = aead.ChaCha20Poly1305(bytes(32))
    nonce = bytes(12)
    out = {"ed25519_sign_s": med(lambda: ed25519.sign(seed, msg, pub)),
           "ed25519_verify_s": med(lambda: ed25519.verify(pub, sig, msg)),
           "x25519_s": med(lambda: aead.x25519(seed, pub))}
    for size in (1024, 65536):
        data = bytes(size)
        ct = aead_.encrypt(nonce, data, None)
        out[f"seal_{size}_s"] = med(lambda: aead_.encrypt(nonce, data, None))
        out[f"open_{size}_s"] = med(lambda: aead_.decrypt(nonce, ct, None))
    return out


def frame_cost(costs: dict, op: str, nbytes: float) -> float:
    """A frame's seal or open seconds at `nbytes`, linear between the 1 kB
    and 64 kB timings."""
    lo, hi = costs[f"{op}_1024_s"], costs[f"{op}_65536_s"]
    return lo + (hi - lo) * (nbytes - 1024) / (65536 - 1024)


def family(metrics: dict, name: str, by: tuple) -> dict:
    """Sum a rendered family's series by the labels `by` → {labels: v}."""
    out: dict = {}
    for (series, labels), v in metrics.items():
        if series == name:
            d = dict(labels)
            key = "/".join(d.get(k, "") for k in by)
            out[key] = out.get(key, 0.0) + v
    return out


def cluster_check_node(i: int, metrics: dict) -> dict:
    """One node's /metrics at its end: its verifies on the card's
    resident route and the verify tile's, the combine's and K21's kernels
    launched → its launches per kernel."""
    paths = family(metrics, "core_verify_launches_by_path", ("path",))
    if not paths or not all(p.endswith("+res") and n > 0
                            for p, n in paths.items()):
        raise AssertionError(f"cluster: node {i}'s verify routes {paths}")
    launches = {k: int(v) for k, v in family(
        metrics, "app_cuda_kernel_launches_total", ("kernel",)).items()}
    never = [k for k in (*GRAPH_KERNELS, *SIM_COMBINE_KERNELS,
                         *CL_NODE_KERNELS) if not launches.get(k)]
    if never:
        raise AssertionError(f"cluster: node {i} never launched {never}")
    return launches


def oracle_signs(root: bytes, keys: list[int]) -> list[bytes]:
    """`ref.bls.sign`'s computation for each secret of `keys` over one
    message: [sk]·hash_to_g2(root), the root hashed once."""
    from charon_tpu_torch.tbls.ref import curve as rc
    from charon_tpu_torch.tbls.ref.hash_to_curve import DST_G2, hash_to_g2

    h = hash_to_g2(root, DST_G2)
    return [rc.g2_to_bytes(rc.multiply(h, sk)) for sk in keys]


def cluster_oracle(secrets: list, records: dict) -> int:
    """Every broadcast (kind, slot, validator) → {node: (root, bytes)}
    carries `ref.bls.sign` with the validator's group secret — its
    computation, [sk]·hash_to_g2(root), with each root hashed once (a
    slot's sync messages share one root; `oracle_signs` a root on the
    host's workers) → the signatures computed."""
    by_root: dict = {}
    for (kind, slot, vi), by_node in records.items():
        for node, (root, sig) in by_node.items():
            vis = by_root.setdefault(root, [])
            if vi not in vis:
                vis.append(vi)
    roots = list(by_root)
    want = {(vi, root): sig for root, sigs in zip(roots, host_pool().map(
        oracle_signs, roots, [[secrets[vi] for vi in by_root[r]]
                              for r in roots]))
            for vi, sig in zip(by_root[root], sigs)}
    for (kind, slot, vi), by_node in records.items():
        for node, (root, sig) in by_node.items():
            if sig != want[(vi, root)]:
                raise AssertionError(
                    f"cluster: node {node}'s {kind} of validator {vi} at "
                    f"slot {slot} carries {sig.hex()[:16]}…, not the "
                    f"oracle's {want[(vi, root)].hex()[:16]}…")
    return len(want)


def cluster_create(work: str, v: int, scheme: str,
                   base_port: int) -> tuple[float, list]:
    """In a host worker, during the build: `create cluster` (CL_NODES
    nodes, CL_T-of-CL_NODES, `v` validators, `scheme`) into `work`, mesh
    ports from `base_port` → (its seconds, each validator's group secret
    recombined from CL_T nodes' keystores — with bls, the first and last
    checked against the lock's group keys)."""
    from charon_tpu_torch.cluster.definition import load_json, lock_from_json
    from charon_tpu_torch.cmd import main as cli
    from charon_tpu_torch.eth2util import keystore
    from charon_tpu_torch.tbls import api

    t0 = time.perf_counter()
    api.set_scheme(scheme)
    if cli(["create", "cluster", "--name", "chip-smoke", "--nodes",
            str(CL_NODES), "--threshold", str(CL_T), "--num-validators",
            str(v), "--cluster-dir", work, "--base-port", str(base_port),
            "--tbls-scheme", scheme]):
        raise AssertionError("cluster: create cluster failed")
    create_s = time.perf_counter() - t0
    lock = lock_from_json(load_json(str(Path(work) / "node0" /
                                        "cluster-lock.json")), verify=False)
    # the oracle's group secrets: t nodes' keystores recombined
    shares = [keystore.load_keys(str(Path(work) / f"node{i}" /
                                     "validator_keys"))
              for i in range(CL_T)]
    secrets = [api.privkey_to_int(api.combine_shares(
        {i + 1: shares[i][vi] for i in range(CL_T)})) for vi in range(v)]
    if scheme == "bls":
        from charon_tpu_torch.tbls.ref import bls
        from charon_tpu_torch.tbls.ref import curve as rc

        if any(rc.g1_to_bytes(bls.sk_to_pk(secrets[vi]))
               != lock.validators[vi].public_key for vi in (0, v - 1)):
            raise AssertionError("cluster: recombined secrets are not the "
                                 "lock's group keys")
    return create_s, secrets


def cluster_prepare(pool, scheme: str = "bls",
                    slot_s: float = SIM_SLOT_S) -> dict:
    """Before the build: V by this host's pure-Python signing and the
    mesh's primitive times (measured before the build and the host
    workers load the cores), and `create cluster` handed to `pool`
    (`cluster_create`) → what `cluster_start` takes."""
    import shutil

    sign_s = simnet_sign_seconds()
    v = min(CL_V_FULL, CL_V_CARD, simnet_validators(sign_s, 1))
    log(f"cluster: one pure-Python tbls.sign {sign_s:.4f} s → V = {v} (one "
        f"node's VC signs {v * (1 + 1 / SIM_SPE):.1f} a slot, "
        f"{v * (1 + 1 / SIM_SPE) * sign_s:.2f} s of a {slot_s:.0f} s slot; "
        f"{simnet_validators(sign_s, 1)} by the signing rule, at most "
        f"{CL_V_CARD} on one card; cut from {CL_V_FULL}); `create cluster` "
        f"runs in a host worker during the build")
    costs = crypto_costs()
    log("cluster: the mesh's primitives on this host (median s): "
        + json.dumps({k: round(x, 6) for k, x in costs.items()}))
    work = ROOT / "build" / "cluster_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    return {"work": work, "v": v, "scheme": scheme, "slot_s": slot_s,
            "costs": costs,
            "created": pool.submit(cluster_create, str(work), v, scheme,
                                   quiet_base_port(CL_NODES))}


class ClusterRun:
    """`cluster_run` on a thread and an event loop of its own from the
    spawn on: the nodes boot (lock verify, prewarm, profiler set-up) while
    the chaos phase's runs end on this thread, and the run waits at its
    gate before its waited slots, which start after `finish` opens it."""

    def __init__(self, prep: dict, lock):
        self.prep = prep
        self.gate, self.stop = threading.Event(), threading.Event()
        self.res = self.error = None
        self.thread = threading.Thread(
            target=self._run, name="cluster", daemon=True,
            args=(prep["work"], lock, prep["v"], prep["scheme"],
                  prep["slot_s"]))
        self.thread.start()

    def _run(self, *args) -> None:
        try:
            self.res = asyncio.run(cluster_run(*args, gate=self.gate,
                                               stop=self.stop))
        except BaseException as exc:  # noqa: BLE001 — raised by finish
            self.error = exc

    def abort(self) -> None:
        """An earlier phase failed: stop the processes, wait for them."""
        self.stop.set()
        self.thread.join()

    def finish(self) -> dict:
        """Open the gate, wait for the run → `cluster_report`'s result."""
        self.gate.set()
        self.thread.join()
        if self.error is not None:
            cluster_stderr(self.prep["work"])
            raise self.error
        return cluster_report(self.res, self.prep["secrets"],
                              self.prep["costs"], self.prep["slot_s"])


def cluster_start(prep: dict) -> ClusterRun:
    """`BASELINE.json` config 2's cluster as four node processes on the
    card: `create cluster` written during the build (real BLS,
    `cluster_create`), one `BeaconMockServer` a node in this process over
    one mock, four `python -m charon_tpu_torch run --validator-api-address
    … --simnet-validator-mock` processes boot from the lock (each
    verifies it and prewarms on the card) while the chaos phase's runs
    end, every /readyz polled and 200 before the mock's genesis, CL_GENESIS_S
    after the spawn, and then a VC process a node (`testutil.httpvc`, the
    node's share keys) signs the node's attester duties over HTTP through
    its router, while the node's in-process mock signs its sync messages;
    after the gate (`ClusterRun.finish`), CL_UP_SLOTS slots with every
    node (/debug/profile during the first, /debug/spans of all four after
    the window), node 4 and its VC sent SIGTERM, the next CL_DOWN_SLOTS
    slots (one of them led by node 4 in QBFT's round 1) with the other
    three, and SIGTERM to those.  Checks (`cluster_report`): every waited
    duty at the mock from every live node with the oracle's bytes, each
    node's verifies on the resident route and its kernels launched, every
    down-window consensus duty decided on every live node (node 4's by a
    round change), every VC's attestations served by its router and no
    request shed, a profile whose trace names a kernel of the port, one
    attester duty's trace on all four nodes, every process exit 0 within
    CL_EXIT_TIMEOUT with no traceback; the arrivals past their slot's end
    are counted.  `finish` → the four nodes' launches per kernel (each
    read from its /metrics just before its SIGTERM)."""
    from charon_tpu_torch.cluster.definition import load_json, lock_from_json

    create_s, prep["secrets"] = prep["created"].result()
    log(f"cluster: create cluster ({CL_NODES} nodes, {CL_T}-of-{CL_NODES}, "
        f"V = {prep['v']}, {prep['scheme']}) {create_s:.1f} s, in a host "
        f"worker during the build")
    lock = lock_from_json(load_json(str(prep["work"] / "node0" /
                                        "cluster-lock.json")), verify=False)
    return ClusterRun(prep, lock)


def cluster_phase(scheme: str = "bls", slot_s: float = SIM_SLOT_S) -> dict:
    """`cluster_prepare`, `cluster_start` and `ClusterRun.finish` in one
    call, nothing beside the boot (`main` spawns the nodes during the
    chaos phase's runs instead, `chaos_and_cluster`) → the nodes'
    launches per kernel."""
    return cluster_start(cluster_prepare(host_pool(), scheme,
                                         slot_s)).finish()


def cluster_stderr(work: Path) -> None:
    """On both streams: what a failed run's processes logged — their
    warnings and errors, then their last lines."""
    for name in ("node", "vc"):
        for i in range(1, CL_NODES + 1):
            err = work / f"{name}{i}.stderr"
            if not err.exists():
                continue
            lines = err.read_text(errors="replace").splitlines()
            loud = [ln for ln in lines if any(
                w in ln for w in (" WARNING ", " ERROR ", "ERROR:",
                                  "Traceback", "Error"))]
            text = (f"cluster: {name} {i}'s stderr, {len(loud)} warning and "
                    "error lines (at most 25):\n"
                    + "\n".join(ln[:300] for ln in loud[:25])
                    + "\n… its last lines:\n"
                    + "\n".join(ln[:300] for ln in lines[-12:]))
            log(text)
            print(text, file=sys.stderr, flush=True)


async def cluster_run(work: Path, lock, v: int, scheme: str, slot_s: float,
                      gate: threading.Event,
                      stop: threading.Event) -> dict:
    """The processes' run; its waited slots start after `gate` is set,
    and `stop` ends it (raising) before them → what `cluster_report`
    checks and prints."""
    import os

    from charon_tpu_torch.app.http1 import json_response
    from charon_tpu_torch.core.consensus import duty_leader
    from charon_tpu_torch.core.types import Duty, DutyType, pubkey_from_bytes
    from charon_tpu_torch.eth2util import beaconapi
    from charon_tpu_torch.testutil.beaconmock import BeaconMock
    from charon_tpu_torch.testutil.beaconmock_http import BeaconMockServer

    arrivals: list = []   # (node, wall time, kind, item)

    class NodeServer(BeaconMockServer):
        """A node's own beacon endpoint over the one mock: what reaches
        the mock is stamped with the node and the time."""

        def __init__(self, mock, node: int):
            super().__init__(mock)
            self.node = node

        async def _submit_atts(self, request):
            atts = [beaconapi.attestation_from(d) for d in request.json()]
            t = time.time()
            arrivals.extend((self.node, t, "attestation", a) for a in atts)
            await self.mock.submit_attestations(atts)
            return json_response({})

        async def _submit_sync(self, request):
            msgs = [beaconapi.sync_msg_from(d) for d in request.json()]
            t = time.time()
            arrivals.extend((self.node, t, "sync_message", m) for m in msgs)
            await self.mock.submit_sync_committee_messages(msgs)
            return json_response({})

    # genesis after every node's boot: no slot before the cluster is up
    genesis = time.time() + CL_GENESIS_S
    mock = BeaconMock(slot_duration=slot_s, slots_per_epoch=SIM_SPE,
                      genesis_time=genesis)
    for val in lock.validators:
        mock.add_validator(pubkey_from_bytes(val.public_key))
    mock.overrides["attester_duties"] = cluster_attester_duties(mock)
    servers = [NodeServer(mock, i + 1) for i in range(CL_NODES)]
    for srv in servers:
        await srv.start()
    ports = free_ports(2 * CL_NODES)
    mon, vapi = ports[:CL_NODES], ports[CL_NODES:]
    # the App's auto-profiler (on by default) keeps its captures here
    env = dict(os.environ, OMP_NUM_THREADS="2",
               CHARON_TPU_AUTOPROFILE_DIR=str(work / "autoprofile-{node}"))
    procs, vcs, logs = [], [], []
    t_spawn = time.time()
    for i in range(CL_NODES):
        d = work / f"node{i}"
        out = open(work / f"node{i + 1}.stdout", "wb")
        err = open(work / f"node{i + 1}.stderr", "wb")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "charon_tpu_torch", "run",
             "--lock-file", str(d / "cluster-lock.json"),
             "--identity-key-file", str(d / "charon-enr-private-key"),
             "--beacon-node-endpoints", servers[i].addr,
             "--monitoring-address", f"127.0.0.1:{mon[i]}",
             "--validator-api-address", f"127.0.0.1:{vapi[i]}",
             "--simnet-validator-mock", "--simnet-duties", CL_FLOWS,
             "--tbls-scheme", scheme],
            cwd=str(ROOT), env=env, stdout=out, stderr=err))

    def spawn_vc(i: int) -> None:
        """Node i's VC: `testutil.httpvc` in a process of its own, with
        the node's share keys, speaking HTTP to the node's router; its
        requests may wait two slots (attestation data waits for
        consensus)."""
        out = open(work / f"vc{i}.stdout", "wb")
        err = open(work / f"vc{i}.stderr", "wb")
        logs.append((out, err))
        vcs.append(subprocess.Popen(
            [sys.executable, "-m", "charon_tpu_torch.testutil.httpvc",
             "--vapi-url", f"http://127.0.0.1:{vapi[i - 1]}",
             "--keystore-dir", str(work / f"node{i - 1}" / "validator_keys"),
             "--flows", CL_VC_FLOWS, "--max-slots", "1000",
             "--timeout", str(2 * slot_s), "--tbls-scheme", scheme],
            cwd=str(ROOT), env=env, stdout=out, stderr=err))

    def start(slot: int) -> float:
        return genesis + slot * slot_s

    def stopped() -> None:
        if stop.is_set():
            raise AssertionError("cluster: stopped before its window (an "
                                 "earlier phase failed)")

    def alive(nodes) -> None:
        for i in nodes:
            for name, ps in (("node", procs), ("vc", vcs)):
                if i <= len(ps) and ps[i - 1].poll() is not None:
                    raise AssertionError(
                        f"cluster: {name} {i} exited "
                        f"{ps[i - 1].returncode}:\n"
                        + (work / f"{name}{i}.stderr").read_text()[-3000:])

    async def get(i: int, path: str,
                  timeout: float = 5.0) -> tuple[int, bytes]:
        return await asyncio.to_thread(http_get, mon[i - 1], path, timeout)

    async def profile_check(at: float) -> list:
        """From `at`: /debug/profile?seconds=CL_PROFILE_S on node 1, then
        the next node, until a capture's trace names a kernel of the port
        (at most CL_PROFILE_TRIES captures; a 409 — the node's
        auto-profiler capturing — waits a second and asks again, for at
        most a minute) → each capture's kernels by name."""
        await asyncio.sleep(max(0.0, at - time.time()))
        tries: list = []
        node, busy = 1, 0
        while len(tries) < CL_PROFILE_TRIES:
            status, body = await get(node, f"/debug/profile?seconds="
                                     f"{CL_PROFILE_S}", timeout=120.0)
            if status == 409 and busy < 60:
                busy += 1
                await asyncio.sleep(1.0)
                continue
            if status != 200:
                raise AssertionError(f"cluster: node {node}'s /debug/profile"
                                     f" {status}: {body[:300]!r}")
            names = profile_kernels(body)
            ours = {n: c for n, c in names.items()
                    if any(sym in n for sym in kernel_symbols())}
            tries.append({"node": node, "slot_s": round(
                              (time.time() - genesis) / slot_s, 2),
                          "kernels": len(names), "port_kernels": ours,
                          "bytes": len(body)})
            if ours:
                return tries
            node = node % CL_NODES + 1
        raise AssertionError(f"cluster: no /debug/profile capture named a "
                             f"kernel of the port: {tries}")

    async def spans_check(slot: int) -> dict:
        """/debug/spans of every node, parsed by the port's
        `otlp.parse_export`: the attester duty of `slot` has spans under
        its one deterministic trace ID on all four nodes."""
        from charon_tpu_torch.app import otlp
        from charon_tpu_torch.app.tracing import duty_trace_id

        tid = duty_trace_id(Duty(slot, DutyType.ATTESTER))
        out = {}
        for i in range(1, CL_NODES + 1):
            status, body = await get(i, "/debug/spans", timeout=60.0)
            if status != 200:
                raise AssertionError(f"cluster: node {i}'s /debug/spans "
                                     f"{status}")
            spans = otlp.parse_export(json.loads(body))
            mine = [sp for sp in spans if sp.trace_id == tid]
            out[i] = {"spans": len(spans), "duty_spans": len(mine),
                      "names": sorted({sp.name for sp in mine})}
        if not all(o["duty_spans"] for o in out.values()):
            raise AssertionError(f"cluster: trace {tid} of "
                                 f"{Duty(slot, DutyType.ATTESTER)} not on "
                                 f"every node: {out}")
        return {"trace_id": tid, "nodes": out}

    async def scrape(i: int) -> dict:
        status, body = await get(i, "/metrics")
        if status != 200:
            raise AssertionError(f"cluster: node {i}'s /metrics {status}")
        return parse_metrics(body.decode())

    def attesters(slot: int) -> dict:
        """(committee, position) → validator index at `slot`."""
        k0 = slot % SIM_SPE
        return {((vi // SIM_SPE) % 4, (vi // SIM_SPE) // 4): vi
                for vi in range(k0, v, SIM_SPE)}

    def expected(slots) -> set:
        out = set()
        for s in slots:
            out |= {("attestation", s, vi) for vi in attesters(s).values()}
            out |= {("sync_message", s, vi) for vi in range(v)}
        return out

    from charon_tpu_torch.eth2util.signing import DomainName, signing_root
    from charon_tpu_torch.eth2util.ssz import Bitlist

    recs: dict = {}
    read = [0]   # arrivals already in `recs`

    def records() -> dict:
        """(kind, slot, validator) → {node: (signing root, bytes, seconds
        from slot start)}; a second arrival from one node is kept beside
        the first.  Incremental: the mock servers share this loop, and
        re-reading every arrival each poll would hold their replies."""
        out = recs
        new = arrivals[read[0]:]
        read[0] += len(new)
        for node, t, kind, item in new:
            if kind == "attestation":
                pos = Bitlist.to_bools(item.aggregation_bits).index(True)
                slot = item.data.slot
                vi = attesters(slot).get((item.data.index, pos))
                root = signing_root(DomainName.BEACON_ATTESTER,
                                    item.data.hash_tree_root(), SIM_FORK)
            else:
                slot, vi = item.slot, item.validator_index
                root = signing_root(DomainName.SYNC_COMMITTEE,
                                    item.beacon_block_root, SIM_FORK)
            entry = out.setdefault((kind, slot, vi), {})
            key = node if node not in entry else (node, t)
            entry[key] = (root, item.signature, t - start(slot))
        return out

    def complete(slots, nodes) -> bool:
        got = records()
        return all(set(nodes) <= set(got.get(k, {})) for k in expected(slots))

    async def dump(nodes) -> dict:
        """Each node's /metrics, /debug/qbft and /debug/memory, saved
        beside its logs (what a failed run leaves to read) → each node's
        counts of what can lose a duty: background task errors, the
        router's answers that were not 2xx, failed beacon requests and
        the partial signature sets exchanged."""
        out = {}
        for i in nodes:
            for path, name in (("/metrics", "metrics.txt"),
                               ("/debug/qbft", "qbft.json"),
                               ("/debug/memory", "memory.json")):
                body = (await get(i, path))[1]
                (work / f"node{i}.{name}").write_bytes(body)
                if path != "/metrics":
                    continue
                m = parse_metrics(body.decode())
                out[i] = {
                    "task_errors": family(
                        m, "app_background_task_errors_total", ("task",)),
                    "vapi_not_2xx": {k: n for k, n in family(
                        m, "app_vapi_requests_total",
                        ("endpoint", "code")).items()
                        if not k.endswith("/2xx")},
                    "beacon_errors": family(
                        {k: n for k, n in m.items()
                         if ("result", "error") in k[1]},
                        "app_beacon_requests_total", ("node",)),
                    "parsigex_in": family(
                        m, "core_parsigex_inbound_total", ("duty",)),
                    "parsigex_out": family(
                        m, "core_parsigex_outbound_total", ("duty",))}
        return out

    async def incomplete(slots, nodes, what: str) -> AssertionError:
        """What arrived of `slots` per kind and node, with each live
        node's /metrics and /debug/qbft saved beside its logs."""
        got = records()
        seen: dict = {}
        for kind, slot, vi in expected(slots):
            for n in got.get((kind, slot, vi), {}):
                key = f"{kind}/{slot}"
                seen.setdefault(key, {}).setdefault(str(n), 0)
                seen[key][str(n)] += 1
        counts = await dump(nodes)
        want = {f"{k}/{s}": n for k, s, n in (
            ("attestation", s, len(attesters(s))) for s in slots)}
        return AssertionError(
            f"cluster: {what}: arrivals per duty and node {seen} (each "
            f"slot's attesters {want}, sync messages {v}); by node "
            f"{json.dumps(counts)}")

    res: dict = {"genesis": genesis, "slot_s": slot_s, "mon": mon,
                 "work": work}
    try:
        # readiness: /readyz 200 (quorum of peers, BN synced), the
        # prewarm and the profiler's set-up done (their boot gauges), on
        # every node
        ready: dict = {}
        while len(ready) < CL_NODES:
            stopped()
            alive(range(1, CL_NODES + 1))
            for i in range(1, CL_NODES + 1):
                if i in ready or (await get(i, "/readyz"))[0] != 200:
                    continue
                m = await scrape(i)
                boot = family(m, "app_boot_seconds", ("phase",))
                if "prewarm" in boot and "profiler" in boot:
                    ready[i] = time.time() - t_spawn
            if time.time() > genesis:
                why = {i: (await get(i, "/readyz"))[1].decode()
                       for i in range(1, CL_NODES + 1) if i not in ready}
                await dump(range(1, CL_NODES + 1))
                raise AssertionError(f"cluster: nodes ready {ready} at the "
                                     f"genesis, {genesis - t_spawn:.0f} s "
                                     f"after the spawn; the others' "
                                     f"/readyz: {why}")
            await asyncio.sleep(0.5)
        res["ready_s"] = ready
        res["genesis_s"] = genesis - t_spawn
        # each node's VC, once its router listens (before the genesis)
        for i in range(1, CL_NODES + 1):
            spawn_vc(i)
        # the gate: the phase before this one (its processes booting
        # meanwhile) has ended
        while not gate.is_set():
            stopped()
            alive(range(1, CL_NODES + 1))
            await asyncio.sleep(0.5)
        res["gate_s"] = time.time() - t_spawn
        # the waited slots start after every node is ready (from slot 0,
        # the genesis being later), one of the two after them (node 4
        # down) led by node 4 in round 1
        s0 = max(0, int((time.time() + 1.0 - genesis) // slot_s) + 1)
        while CL_NODES - 1 not in [
                duty_leader(Duty(s, DutyType.ATTESTER), 1, CL_NODES)
                for s in range(s0 + CL_UP_SLOTS,
                               s0 + CL_UP_SLOTS + CL_DOWN_SLOTS)]:
            s0 += 1
        up = list(range(s0, s0 + CL_UP_SLOTS))
        res["up"] = up
        await asyncio.sleep(max(0.0, start(s0) - time.time()))
        res["m_up0"] = {i: await scrape(i) for i in range(1, CL_NODES + 1)}
        all_nodes = list(range(1, CL_NODES + 1))
        # the profile while the up window's first attester duty runs
        prof = asyncio.ensure_future(profile_check(start(s0) + slot_s / 3))
        try:
            while not complete(up, all_nodes):
                alive(all_nodes)
                if time.time() > start(up[-1] + CL_LATE_SLOTS):
                    raise await incomplete(up, all_nodes, f"slots {up} "
                                           "incomplete at slot "
                                           f"{up[-1] + CL_LATE_SLOTS}'s "
                                           "start")
                await asyncio.sleep(0.2)
            res["profile"] = await prof
        finally:
            prof.cancel()
        res["up_done_s"] = time.time() - start(up[-1])
        res["spans"] = await spans_check(up[0])
        res["m_up1"] = {i: await scrape(i) for i in all_nodes}
        res["qbft"] = {}
        # node 4: its launches and instances, then SIGTERM
        res["final"] = {CL_NODES: res["m_up1"][CL_NODES]}
        res["qbft"][CL_NODES] = json.loads((await get(CL_NODES,
                                                      "/debug/qbft"))[1])
        t_kill = time.time()
        procs[-1].send_signal(15)
        vcs[-1].send_signal(15)
        s_down = int((t_kill - genesis) // slot_s) + 1
        down = list(range(s_down, s_down + CL_DOWN_SLOTS))
        while not any(duty_leader(Duty(s, DutyType.ATTESTER), 1, CL_NODES)
                      == CL_NODES - 1 for s in down):
            down.append(down[-1] + 1)
        res["down"] = down
        live = all_nodes[:-1]
        while not complete(down, live):
            alive(live)
            if time.time() > start(down[-1] + CL_LATE_SLOTS):
                raise await incomplete(down, live, f"slots {down} "
                                       f"incomplete with node {CL_NODES} "
                                       "down")
            await asyncio.sleep(0.2)
        await asyncio.sleep(1.0)   # the instances' last messages
        for i in live:
            res["final"][i] = await scrape(i)
            res["qbft"][i] = json.loads((await get(i, "/debug/qbft"))[1])
    finally:
        vc_codes = []
        for p in vcs:
            if p.poll() is None:
                p.send_signal(15)
        for p in vcs:
            try:
                vc_codes.append(await asyncio.to_thread(p.wait,
                                                        CL_EXIT_TIMEOUT))
            except subprocess.TimeoutExpired:
                p.kill()
                vc_codes.append(await asyncio.to_thread(p.wait))
        for p in procs:
            if p.poll() is None:
                p.send_signal(15)
        codes, exit_s = [], []
        t_term = time.time()
        for p in procs:
            try:
                codes.append(await asyncio.to_thread(p.wait,
                                                     CL_EXIT_TIMEOUT))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(await asyncio.to_thread(p.wait))
            exit_s.append(time.time() - t_term)
        for out, err in logs:
            out.close()
            err.close()
        for srv in servers:
            await srv.stop()
    res["codes"], res["exit_s"] = codes, exit_s
    res["vc_codes"] = vc_codes
    res["records"] = records()
    return res


#: the kernels of a node's verify tiles and combines
CL_PROFILED = ("g2_decompress", "miller_loop", "final_exp", "f12_fold",
               "g1_scalar_mul", "g1_tables", "straus_msm", "g2_law",
               "g2_normalize", "g1_decompress")


def kernel_symbols() -> set:
    """CL_PROFILED's kernels by the symbol a profiler trace names them
    with (their compiled functions, without template arguments)."""
    line = line_kernels()
    return {line[k].symbol for k in CL_PROFILED}


def profile_kernels(tarball: bytes) -> dict:
    """A /debug/profile tarball's trace → its kernel events by name."""
    import io
    import tarfile

    with tarfile.open(fileobj=io.BytesIO(tarball), mode="r:gz") as tar:
        member = next((m for m in tar.getmembers()
                       if m.name.endswith("trace.json")), None)
        if member is None:
            raise AssertionError("cluster: /debug/profile's tarball holds "
                                 "no trace.json")
        doc = json.load(tar.extractfile(member))
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    names: dict = {}
    for e in events:
        if str(e.get("cat", "")).lower() == "kernel":
            names[e["name"]] = names.get(e["name"], 0) + 1
    return names


def cluster_serving(res: dict, recs: dict, nodes: list) -> None:
    """The serving layer in the cluster: each node's VC process exited 0
    and submitted at least its node's waited attestations, each one a
    request its router served (``app_vapi_requests_total``); no request
    shed; the router's upstream fetches and the caching beacon client's
    hits and misses; the /debug/profile and /debug/spans checks."""
    work = res["work"]
    waited_atts = {n: sum(1 for (kind, slot, _) in recs
                          if kind == "attestation" and (
                              slot in res["up"] or (slot in res["down"]
                                                    and n < CL_NODES)))
                   for n in nodes}
    for n, code in zip(nodes, res["vc_codes"]):
        lines = (work / f"vc{n}.stdout").read_text().strip().splitlines()
        stats = json.loads(lines[-1]) if lines else {}
        m = res["final"][n]
        reqs = family(m, "app_vapi_requests_total", ("endpoint", "code"))
        shed = family(m, "app_vapi_shed_total", ("endpoint",))
        misses = family(m, "app_serving_cache_misses_total", ("endpoint",))
        hits = family(m, "app_serving_cache_hits_total", ("endpoint",))
        coal = family(m, "app_serving_coalesced_total", ("endpoint",))
        lat_s = family(m, "app_vapi_request_seconds_sum", ("endpoint",))
        lat_n = family(m, "app_vapi_request_seconds_count", ("endpoint",))
        router = {ep: {"requests": sum(v for k, v in reqs.items()
                                       if k.split("/")[0] == ep),
                       "upstream_fetches": misses.get(ep, 0.0),
                       "hits": hits.get(ep, 0.0),
                       "coalesced": coal.get(ep, 0.0),
                       "mean_ms": round(1e3 * lat_s.get(ep, 0.0)
                                        / max(1.0, lat_n.get(ep, 0.0)), 3)}
                  for ep in sorted({k.split("/")[0] for k in reqs})}
        client = {ep: {"hits": hits.get(ep, 0.0),
                       "misses": misses.get(ep, 0.0),
                       "coalesced": coal.get(ep, 0.0)}
                  for ep in sorted(set(hits) | set(misses))
                  if ep.startswith("beacon/")}
        log(f"cluster: node {n}: VC exit {code}, {json.dumps(stats)}; "
            f"app_vapi_requests_total by endpoint/code {json.dumps(reqs)}; "
            f"sheds {json.dumps(shed)}; router requests, upstream "
            f"fetches (for attestation data: DutyDB waits) and mean "
            f"milliseconds a request by endpoint class {json.dumps(router)}; "
            f"the caching "
            f"beacon client's cache {json.dumps(client)}")
        if code != 0 or not stats:
            raise AssertionError(f"cluster: VC {n} exited {code}: " + (
                work / f"vc{n}.stderr").read_text(errors="replace")[-2000:])
        if any(shed.values()):
            raise AssertionError(f"cluster: node {n}'s router shed {shed}")
        if (stats["submitted_atts"] < waited_atts[n]
                or reqs.get("submit/2xx", 0) < waited_atts[n]):
            raise AssertionError(
                f"cluster: node {n}'s VC submitted {stats} through a router "
                f"that served {reqs.get('submit/2xx', 0)} submissions, for "
                f"{waited_atts[n]} waited attestations")
    # the App's auto-profiler (on by default): its captures by reason,
    # and no capture that failed
    auto = {}
    for n in nodes:
        m = res["final"][n]
        le = family(m, "app_event_loop_lag_seconds_bucket", ("le",))
        count = sum(family(m, "app_event_loop_lag_seconds_count", ()).values())
        auto[n] = {"captures": family(m, "app_autoprofile_captures_total",
                                      ("reason",)),
                   "skipped": family(m, "app_autoprofile_skipped_total",
                                     ("reason",)),
                   # the node's loop-lag samples, and those past 0.25 s
                   # and 1 s (a capture's stall shows among them)
                   "loop_lag": [int(count), int(count - le.get("0.25", 0)),
                                int(count - le.get("1", 0))]}
        # each capture's reason and when, in slots from the genesis, and
        # the seconds its profiler's start and stop took (on a worker
        # thread; the set-up paid at boot: app_boot_seconds{profiler})
        auto[n]["at_slot"] = []
        for meta in sorted((work / f"autoprofile-node{n - 1}").glob(
                "cap*/meta.json")):
            d = json.loads(meta.read_text())
            took = d.get("timings", {})
            auto[n]["at_slot"].append([d["reason"], round(
                (d["unix_time"] - res["genesis"]) / res["slot_s"], 2),
                round(took.get("start_s", -1), 4),
                round(took.get("stop_s", -1), 4)])
        err = (work / f"node{n}.stderr").read_text(errors="replace")
        if "auto-profile capture failed" in err:
            raise AssertionError(f"cluster: node {n}'s auto-profiler failed "
                                 f"a capture:\n{err[-2000:]}")
    log("cluster: the auto-profiler by node (app_autoprofile_*, by reason; "
        "loop_lag: [samples, > 0.25 s, > 1 s]; at_slot: each capture's "
        "reason, start in slots from the genesis, and its profiler's start "
        "and stop in seconds) " + json.dumps(auto))
    log("cluster: /debug/profile captures (slot_s: when each ended, in "
        "slots from the genesis; kernel events by name, the port's among "
        "them) " + json.dumps(res["profile"]))
    log("cluster: /debug/spans " + json.dumps(res["spans"]))


def cluster_report(res: dict, secrets: list, costs: dict,
                   slot_s: float) -> dict:
    """Check and print a `cluster_run`: exits, the waited duties from
    every live node with the oracle's bytes, per-node routes and kernels,
    QBFT with node 4 down; each duty's arrival by node, each node's slot
    phases and dispatch stages, decided rounds, boot split and the mesh
    crypto's share of a slot.  → the nodes' launches summed per kernel."""
    from charon_tpu_torch.core.consensus import duty_leader
    from charon_tpu_torch.core.types import Duty, DutyType

    work = res["work"]
    bad = []
    for i, code in enumerate(res["codes"], 1):
        err = (work / f"node{i}.stderr").read_text(errors="replace")
        if code != 0 or "Traceback" in err:
            bad.append((i, code, err[-2000:]))
    log(f"cluster: exit codes {res['codes']}, seconds from SIGTERM to exit "
        f"{[round(x, 2) for x in res['exit_s']]}")
    if bad or max(res["exit_s"]) >= CL_EXIT_TIMEOUT:
        raise AssertionError(f"cluster: processes failed to exit cleanly: "
                             f"{bad}")
    nodes = list(range(1, CL_NODES + 1))
    recs = res["records"]
    by_node = {}
    for (kind, slot, vi), got in recs.items():
        if slot in res["up"] or slot in res["down"]:
            want = nodes if slot in res["up"] else nodes[:-1]
            extra = [k for k in got if k not in want]
            if sorted(k for k in got if k in want) != want or extra:
                raise AssertionError(f"cluster: {kind} of validator {vi} at "
                                     f"slot {slot} from {sorted(map(str, got))}"
                                     f", want one from each of {want}")
            if len({s for _, s, _ in got.values()}) != 1:
                raise AssertionError(f"cluster: nodes broadcast different "
                                     f"bytes for {kind} {slot} {vi}")
            for node, (_, _, dt) in got.items():
                by_node.setdefault((kind, slot), {}).setdefault(
                    node, []).append(dt)
    waited = [k for k in recs if k[1] in res["up"] or k[1] in res["down"]]
    if None in {k[2] for k in waited}:
        raise AssertionError("cluster: an attestation of no known attester")
    signed = cluster_oracle(secrets, {k: {n: x[:2] for n, x in recs[k].items()}
                                      for k in waited})
    log(f"cluster: ready (spawn → /readyz 200 with prewarm and profiler "
        f"set-up done, beside the chaos phase's end) per node "
        + json.dumps({i: round(s, 2) for i, s in res["ready_s"].items()})
        + f"; genesis {res['genesis_s']:.1f} s after the spawn, the gate "
        f"(the chaos phase's end) {res['gate_s']:.1f} s"
        + f"; slots {res['up']} with every node, {res['down']} with node "
        f"{CL_NODES} down; {len(waited)} waited duties, every one from "
        f"every live node, byte-equal to the oracle ({signed} signatures)")
    for (kind, slot), per in sorted(by_node.items()):
        log(f"cluster: {kind} slot {slot}: seconds from slot start to "
            "arrival at the mock, per node [n, min, median, max] "
            + json.dumps({n: [len(ds), round(min(ds), 3),
                              round(statistics.median(ds), 3),
                              round(max(ds), 3)]
                          for n, ds in sorted(per.items())}))
    # a duty is worth nothing after its own slot (a sync committee message
    # goes into the next block): count what arrived past that deadline
    late: dict = {}
    for (kind, slot), per in by_node.items():
        key = f"{kind}/{'up' if slot in res['up'] else 'down'}"
        tot = late.setdefault(key, {"arrivals": 0, "late": 0, "max_s": 0.0})
        for ds in per.values():
            tot["arrivals"] += len(ds)
            tot["late"] += sum(1 for dt in ds if dt > slot_s)
            tot["max_s"] = round(max(tot["max_s"], *ds), 3)
    log(f"cluster: arrivals past their deadline (their slot's end, {slot_s:.0f}"
        f" s from its start), by kind and window (up: {CL_NODES} nodes, "
        f"down: {CL_NODES - 1}) " + json.dumps(late, sort_keys=True))
    # the attestations, each node's signed by its VC process over HTTP,
    # beside the base (the phase with its VCs in the nodes' processes)
    att_up = {n: [round(statistics.median(by_node[("attestation", s)][n]), 3)
                  for s in res["up"]] for n in nodes}
    log("cluster: attestations with every node up, each slot's median "
        "seconds from slot start to arrival, by node — this run / the base "
        f"(VCs in the nodes' processes; V = {len(secrets)}"
        f" / {CL_BASE['v']}) " + json.dumps(
            {n: [ms, CL_BASE["attestation_up"][n]]
             for n, ms in att_up.items()})
        + "; [late, arrivals] by kind and window — this run / the base "
        + json.dumps({k: [[v["late"], v["arrivals"]], CL_BASE["late"].get(k)]
                      for k, v in sorted(late.items())}))
    cluster_serving(res, recs, nodes)
    launches: dict = {}
    for i in nodes:
        m = res["final"][i]
        for k, n in cluster_check_node(i, m).items():
            launches[k] = launches.get(k, 0) + n
        boot = family(m, "app_boot_seconds", ("phase",))
        log(f"cluster: node {i}: boot seconds "
            + json.dumps({k: round(x, 3) for k, x in boot.items()})
            + "; verify routes " + json.dumps(family(
                m, "core_verify_launches_by_path", ("path",)))
            + "; core_slot_phase_seconds [sum, count] " + json.dumps({
                k: [round(x, 3), int(family(
                    m, "core_slot_phase_seconds_count", ("duty", "phase"))
                    .get(k, 0))]
                for k, x in family(m, "core_slot_phase_seconds_sum",
                                   ("duty", "phase")).items()})
            + "; core_dispatch_stage_seconds [sum, count] " + json.dumps({
                k: [round(x, 4), int(family(
                    m, "core_dispatch_stage_seconds_count", ("op", "stage"))
                    .get(k, 0))]
                for k, x in family(m, "core_dispatch_stage_seconds_sum",
                                   ("op", "stage")).items()})
            + "; kernel launches " + json.dumps(
                family(m, "app_cuda_kernel_launches_total", ("kernel",))))
    # QBFT: decided rounds of the waited attester duties
    rounds: dict = {}
    for i, dump in res["qbft"].items():
        for inst in dump["instances"]:
            dec = [m["round"] for m in inst["msgs"]
                   if m["rule"] in ("QUORUM_COMMITS", "JUSTIFIED_DECIDED")]
            rounds.setdefault(inst["duty"], {})[i] = (
                min(dec) if inst["decided"] and dec else None)
    log("cluster: QBFT decided round per attester duty and node "
        + json.dumps({str(Duty(s, DutyType.ATTESTER)): rounds.get(
            str(Duty(s, DutyType.ATTESTER)), {})
            for s in res["up"] + res["down"]}))
    for s in res["down"]:
        duty = Duty(s, DutyType.ATTESTER)
        got = rounds.get(str(duty), {})
        led = duty_leader(duty, 1, CL_NODES) == CL_NODES - 1
        if any(got.get(i) is None for i in nodes[:-1]) or (
                led and any(got[i] < 2 for i in nodes[:-1])):
            raise AssertionError(f"cluster: {duty} with node {CL_NODES} down"
                                 f" (its round-1 leader: {led}): {got}")
    # the mesh's crypto on one node's loop, per slot of the up window
    shares = {}
    for i in nodes:
        a, b = res["m_up0"][i], res["m_up1"][i]

        def delta(name):
            return sum(family(b, name, ("peer",)).values()) - sum(
                family(a, name, ("peer",)).values())
        sent_f, recv_f = delta("app_p2p_peer_sent_frames_total"), delta(
            "app_p2p_peer_recv_frames_total")
        sent_b, recv_b = delta("app_p2p_peer_sent_bytes_total"), delta(
            "app_p2p_peer_recv_bytes_total")
        msgs = [m for inst in res["qbft"].get(i, {}).get("instances", [])
                if int(inst["duty"].split("/")[0]) in res["up"]
                for m in inst["msgs"] if m["msg_type"]]
        signs = sum(1 for m in msgs if m["source"] == i - 1) / len(res["up"])
        verifies = sum(1 for m in msgs if m["source"] != i - 1) / len(
            res["up"])
        slots = len(res["up"]) + (res["up_done_s"] / slot_s)
        per_slot = (signs * costs["ed25519_sign_s"]
                    + verifies * costs["ed25519_verify_s"]
                    + sent_f / slots * frame_cost(
                        costs, "seal", sent_b / max(sent_f, 1))
                    + recv_f / slots * frame_cost(
                        costs, "open", recv_b / max(recv_f, 1)))
        shares[i] = {"frames_out": round(sent_f / slots, 1),
                     "frames_in": round(recv_f / slots, 1),
                     "bytes_out": round(sent_b / slots),
                     "qbft_signs": round(signs, 1),
                     "qbft_verifies": round(verifies, 1),
                     "crypto_s": round(per_slot, 4),
                     "share": round(per_slot / slot_s, 5)}
    log("cluster: the mesh's crypto on each node's loop a slot (frames and "
        "QBFT messages of the up window × this host's primitive times; a "
        "QBFT message's justifications not counted) " + json.dumps(shares))
    return launches


# ---------------------------------------------------------------------------
# Phase 9: the DKG — BASELINE.json config 5's share-proof verify, warm and
# cold, an in-process ceremony, and the ceremony as operator processes
# ---------------------------------------------------------------------------

#: config 5: 1,000 validators' share proofs of a 7-of-10 cluster
DKG_V, DKG_T, DKG_N = 1000, 7, 10
#: timed reps (p50), the corrupted row, oracle-checked rows besides it
DKG_REPS, DKG_BAD_ROW, DKG_ORACLE_ROWS = 5, 500, 8
#: the in-process keycast ceremony whose launches the kernels line counts
DKG_LOOP_N, DKG_LOOP_T, DKG_LOOP_M = 4, 3, 2
#: the ceremony as processes (Pedersen): 1 + m distinct messages in the
#: lock / deposit batch, at least the card's hash batch (H2C_MIN_BATCH);
#: cut from config 5's 1,000 × 7-of-10, whose pure-Python round 2 would
#: take hours a process
DKG_CER_N, DKG_CER_T, DKG_CER_M = 4, 3, 8
#: the seconds the operator processes may take, spawn to last exit
DKG_CER_TIMEOUT = 300.0


def dkg_share_pool(dev) -> tuple[list[int], list[bytes], torch.Tensor]:
    """Config 5's shares, as the root bench.py makes them: a real 7-of-10
    Shamir split a validator on the host, validator v's share the one of
    index (v mod 10) + 1; its pubshare share·G1 made on the card → (shares,
    pubshares, the shares' bits on the card)."""
    from charon_tpu_torch.ops import codec, curve as tcurve
    from charon_tpu_torch.tbls import shamir
    from charon_tpu_torch.tbls.ref import curve as rc
    from charon_tpu_torch.tbls.ref.fields import R

    rng = random.Random(55)
    shares = []
    for v in range(DKG_V):
        split, _ = shamir.split_secret(rng.randrange(1, R), DKG_T, DKG_N,
                                       rng)
        shares.append(split[v % DKG_N + 1])
    bits = torch.from_numpy(np.ascontiguousarray(
        tcurve.scalars_to_bits(shares).T)).to(dev)
    g1 = torch.from_numpy(tcurve.g1_pack([rc.G1_GEN])).to(dev).expand(
        3, NL, DKG_V).contiguous()
    x, y, inf = codec.g1_normalize(tcurve.scalar_mul(tcurve.FP_OPS, g1, bits))
    pks = codec.g1_compress_np(x.cpu().numpy().T, y.cpu().numpy().T,
                               inf.cpu().numpy())
    return shares, [pks[k].tobytes() for k in range(DKG_V)], bits


def dkg_oracle_sample(label: str, items, oks, msg_of, gen,
                      others: int) -> list[int]:
    """The corrupted row and `others` more: each verdict equal to the
    pure-Python oracle's → the rows checked."""
    rest = [r for r in range(len(items)) if r != DKG_BAD_ROW]
    rows = [DKG_BAD_ROW] + sorted(gen.choice(rest, others,
                                             replace=False).tolist())
    for r in rows:
        pk, sig = items[r][0], items[r][1]
        if oracle_verify(pk, msg_of(r), sig) != oks[r]:
            raise AssertionError(f"{label} row {r}: verdict {oks[r]} != "
                                 f"the oracle's")
    return rows


def dkg_warm(dev, backend, shares: list[int], pubshares: list[bytes]
             ) -> dict:
    """Config 5 warm (bench.py `dkg-share-verify-1000v-7of10`): the 1,000
    proofs share·H(transcript) made on the card, verified by
    `keygen.verify_share_proofs` — one `tbls.batch_verify`, one tile —
    once to fill the stores, then DKG_REPS timed; a copy with row 500's
    proof replaced by row 501's must reject that row alone."""
    from charon_tpu_torch.dkg import keygen
    from charon_tpu_torch.tbls.ref import bls
    from charon_tpu_torch.tbls.ref import curve as rc
    from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2

    transcript = b"charon-tpu-torch chip smoke: dkg ceremony transcript"
    msg = keygen.share_proof_msg(transcript)
    t0 = time.perf_counter()
    proofs = sigs_on_card(dev, hash_to_g2(msg), shares)
    t_pool = time.perf_counter() - t0
    for k in (0, DKG_V - 1):
        if pubshares[k] != rc.g1_to_bytes(bls.sk_to_pk(shares[k])) or \
                proofs[k] != rc.g2_to_bytes(bls.sign(shares[k], msg)):
            raise AssertionError(f"dkg pool row {k}: != the oracle's")
    items = list(zip(pubshares, proofs))
    if not all(keygen.verify_share_proofs(items, transcript)):
        raise AssertionError("dkg warm: the first verify rejected a proof")
    walls = []
    for rep in range(DKG_REPS):
        backend.reset_verify_totals()
        reset_all_launches()
        t0 = time.perf_counter()
        oks = keygen.verify_share_proofs(items, transcript)
        walls.append(time.perf_counter() - t0)
        if not all(oks):
            raise AssertionError(f"dkg warm rep {rep}: {oks.count(False)} "
                                 f"rejected")
        if rep == 0:
            check_graph_stage("dkg warm", backend.verify_launch_totals, 1)
            check_no_k1("dkg warm", all_launches())
            stages = dict(backend.verify_totals)
    bad = list(items)
    bad[DKG_BAD_ROW] = (bad[DKG_BAD_ROW][0], proofs[DKG_BAD_ROW + 1])
    oks = keygen.verify_share_proofs(bad, transcript)
    rejected = [r for r, ok in enumerate(oks) if not ok]
    if rejected != [DKG_BAD_ROW]:
        raise AssertionError(f"dkg warm: rows {rejected} rejected, want "
                             f"[{DKG_BAD_ROW}]")
    rows = dkg_oracle_sample("dkg warm", bad, oks, lambda r: msg,
                             np.random.default_rng(5), DKG_ORACLE_ROWS)
    p50 = statistics.median(walls)
    log(f"dkg config 5 warm: {DKG_V:,} share proofs ({DKG_T}-of-{DKG_N}, "
        f"one transcript), pubshares and proofs made on the card "
        f"{t_pool:.2f} s (2 rows oracle-checked); verify_share_proofs "
        f"p50 {p50:.4f} s of {DKG_REPS} ({[round(w, 4) for w in walls]}), "
        f"{DKG_V / p50:,.0f} proofs/s; one tile, one graph replay; stages "
        + json.dumps({k: round(v, 5) for k, v in stages.items()})
        + f"; row {DKG_BAD_ROW} corrupted → only it rejected; rows {rows} "
        f"equal the oracle")
    return {"p50_s": p50, "walls_s": walls}


def dkg_cold(dev, backend, shares: list[int], bits: torch.Tensor,
             pubshares: list[bytes]) -> dict:
    """Config 5 cold (bench.py `dkg-share-verify-1000v-coldcache`): one
    ceremony transcript a validator, H(m) made on the card and signed on
    the card; `keygen.verify_share_proofs_multi` DKG_REPS times, both
    message caches (the host LRU and the device store) emptied before
    each, so every tile hashes its 1,000 messages on the card; one
    corrupted transcript must be the only row rejected."""
    from charon_tpu_torch.dkg import keygen
    from charon_tpu_torch.tbls.ref import bls
    from charon_tpu_torch.tbls.ref import curve as rc

    def empty_message_caches() -> None:
        backend._hm_cache.clear()
        if backend._hm_dev is not None:
            backend._hm_dev.clear()

    transcripts = [b"charon-tpu-torch chip smoke: dkg transcript %d" % v
                   for v in range(DKG_V)]
    msgs = [keygen.share_proof_msg(t) for t in transcripts]
    t0 = time.perf_counter()
    hms = backend._hash_points(msgs, {}, {})
    sigs = sign_on_card(dev, bits, hms)
    t_pool = time.perf_counter() - t0
    for k in (0, DKG_V - 1):
        if sigs[k] != rc.g2_to_bytes(bls.sign(shares[k], msgs[k])):
            raise AssertionError(f"dkg cold pool row {k}: != the oracle's")
    items = [(pubshares[v], sigs[v], transcripts[v]) for v in range(DKG_V)]
    walls, stages = [], None
    for rep in range(DKG_REPS):
        empty_message_caches()
        backend.reset_verify_totals()
        reset_all_launches()
        t0 = time.perf_counter()
        oks = keygen.verify_share_proofs_multi(items)
        walls.append(time.perf_counter() - t0)
        if not all(oks):
            raise AssertionError(f"dkg cold rep {rep}: {oks.count(False)} "
                                 f"rejected")
        st = backend.verify_launch_totals
        check_h2c_launches(f"dkg cold rep {rep}", st.get("h2c_s", {}), 1)
        if rep == 0:
            check_graph_stage("dkg cold", st, 1)
            check_no_k1("dkg cold", all_launches())
            stages = dict(backend.verify_totals)
    bad = list(items)
    bad[DKG_BAD_ROW] = (bad[DKG_BAD_ROW][0], bad[DKG_BAD_ROW][1],
                        b"charon-tpu-torch chip smoke: corrupted transcript")
    empty_message_caches()
    oks = keygen.verify_share_proofs_multi(bad)
    rejected = [r for r, ok in enumerate(oks) if not ok]
    if rejected != [DKG_BAD_ROW]:
        raise AssertionError(f"dkg cold: rows {rejected} rejected, want "
                             f"[{DKG_BAD_ROW}]")
    rows = dkg_oracle_sample(
        "dkg cold", bad, oks,
        lambda r: keygen.share_proof_msg(bad[r][2]),
        np.random.default_rng(6), 2)
    p50 = statistics.median(walls)
    log(f"dkg config 5 cold: {DKG_V:,} share proofs over {DKG_V:,} "
        f"transcripts, H(m) hashed and signed on the card {t_pool:.2f} s "
        f"(2 rows oracle-checked); verify_share_proofs_multi with both "
        f"message caches emptied p50 {p50:.4f} s of {DKG_REPS} "
        f"({[round(w, 4) for w in walls]}), {DKG_V / p50:,.0f} messages/s; "
        f"one device hash batch and one graph replay a rep; stages "
        + json.dumps({k: round(v, 5) for k, v in stages.items()})
        + f"; row {DKG_BAD_ROW}'s transcript corrupted → only it rejected; "
        f"rows {rows} equal the oracle")
    return {"p50_s": p50, "walls_s": walls, "msgs_per_s": DKG_V / p50}


def dkg_loop_ceremony(work: Path) -> dict:
    """A keycast ceremony (n = 4, t = 3, m = 2) of four `run_dkg`s on this
    process's loop over the port's TCP mesh, its verifies and combine on
    the card → its launches per kernel, counted from zero (the kernels
    line's `launches_dkg`).  The locks must be equal and verify."""
    from charon_tpu_torch.cluster import definition as cdef
    from charon_tpu_torch.dkg.ceremony import run_dkg
    from charon_tpu_torch.p2p.transport import (TCPMesh,
                                                mesh_params_from_definition,
                                                new_test_identities)

    n = DKG_LOOP_N
    ids, _ = new_test_identities(n, seed=b"chip-smoke-dkg")
    ports = free_ports(n)
    definition = cdef.Definition(
        name="chip-smoke-dkg",
        operators=tuple(cdef.Operator(address=f"op{i}",
                                      enr=ids[i].enr("127.0.0.1", ports[i]))
                        for i in range(n)),
        threshold=DKG_LOOP_T, num_validators=DKG_LOOP_M,
        dkg_algorithm="keycast")
    for i in range(n):
        definition = cdef.sign_operator(definition, i, ids[i])

    async def main():
        peers, pubs = mesh_params_from_definition(definition)
        meshes = [TCPMesh(i, peers, ids[i], pubs,
                          cluster_hash=cdef.definition_hash(definition))
                  for i in range(n)]
        for mesh in meshes:
            await mesh.start()
        try:
            return await asyncio.gather(*(
                run_dkg(definition, meshes[i], i, str(work / f"loop{i}"))
                for i in range(n)))
        finally:
            for mesh in meshes:
                await mesh.stop()

    reset_all_launches()
    t0 = time.perf_counter()
    locks = asyncio.run(main())
    wall = time.perf_counter() - t0
    counts = all_launches()
    if len({lk.lock_hash for lk in locks}) != 1:
        raise AssertionError("dkg in-process ceremony: the locks differ")
    cdef.verify_lock(locks[0])
    zero = [k for k in GRAPH_KERNELS + COMBINE_PATH_KERNELS if not counts[k]]
    if zero:
        raise AssertionError(f"dkg in-process ceremony: never launched "
                             f"{zero}")
    check_no_k1("dkg in-process ceremony", counts)
    log(f"dkg in-process ceremony (keycast, {n} operators, "
        f"{DKG_LOOP_T}-of-{n}, {DKG_LOOP_M} validators, TCP mesh): "
        f"{wall:.2f} s; lock 0x{locks[0].lock_hash.hex()} verified; "
        "launches " + json.dumps({k: c for k, c in counts.items() if c}))
    return counts


def smi_compute_pids() -> set[int]:
    """The pids nvidia-smi lists as compute apps on the card now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return {int(x) for x in out.stdout.split() if x.strip().isdigit()}


def dkg_processes(work: Path) -> dict:
    """The ceremony as operators run it: `create enr` ×4, `create dkg`
    (Pedersen, t = 3, m = 8), `sign` ×4 on that one file, one after
    another, then four `python -m charon_tpu_torch dkg` processes on the
    card, timed from the spawn to the last exit.  Checks: every process
    exits 0 and reports the verify, hash and combine kernels launched in
    it; the four locks are equal, load with `lock_from_json(verify=True)`
    and pass `verify_lock`; every keystore share's pubkey is its node's
    pubshare; the oracle verifies every deposit signature; `combine` over
    three node directories recombines every group key, over two it exits
    non-zero.  → the ceremony's numbers."""
    import io
    import os
    import shutil
    import threading

    from charon_tpu_torch.cluster.definition import load_json, lock_from_json
    from charon_tpu_torch.cmd import main as cli
    from charon_tpu_torch.eth2util import keystore
    from charon_tpu_torch.eth2util.deposit import deposit_signing_root
    from charon_tpu_torch.tbls import api

    n, t, m = DKG_CER_N, DKG_CER_T, DKG_CER_M
    ports = free_ports(n)
    enrs = []
    t0 = time.perf_counter()
    for i in range(n):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if cli(["create", "enr", "--data-dir", str(work / f"op{i}"),
                    "--host", "127.0.0.1", "--port", str(ports[i])]):
                raise AssertionError("dkg: create enr failed")
        enrs.append(out.getvalue().strip())
    definition = str(work / "cluster-definition.json")
    with contextlib.redirect_stdout(io.StringIO()):
        if cli(["create", "dkg", "--name", "chip-smoke-dkg",
                "--operator-enrs", ",".join(enrs), "--threshold", str(t),
                "--num-validators", str(m), "--dkg-algorithm", "default",
                "--output-file", definition]):
            raise AssertionError("dkg: create dkg failed")
        for i in range(n):
            if cli(["sign", "--definition-file", definition,
                    "--identity-key-file",
                    str(work / f"op{i}" / "charon-enr-private-key")]):
                raise AssertionError(f"dkg: sign {i} failed")
    prep_s = time.perf_counter() - t0

    env = dict(os.environ, OMP_NUM_THREADS="2")
    pids: set[int] = set()
    stop = threading.Event()

    def watch() -> None:
        while not stop.is_set():
            with contextlib.suppress(Exception):
                pids.update(smi_compute_pids())
            stop.wait(0.5)

    watcher = threading.Thread(target=watch, daemon=True)
    procs, files = [], []
    t0 = time.perf_counter()
    for i in range(n):
        out = open(work / f"dkg{i}.stdout", "wb")
        err = open(work / f"dkg{i}.stderr", "wb")
        files += [out, err]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "charon_tpu_torch", "dkg",
             "--definition-file", definition,
             "--identity-key-file",
             str(work / f"op{i}" / "charon-enr-private-key"),
             "--output-dir", str(work / "cluster" / f"node{i}")],
            cwd=str(ROOT), env=env, stdout=out, stderr=err))
    watcher.start()
    exits = [0.0] * n
    try:
        for i, proc in enumerate(procs):
            left = DKG_CER_TIMEOUT - (time.perf_counter() - t0)
            proc.wait(timeout=max(left, 1.0))
            exits[i] = time.perf_counter() - t0
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        raise AssertionError(f"dkg: the operators ran past "
                             f"{DKG_CER_TIMEOUT:.0f} s")
    finally:
        for proc in procs:
            with contextlib.suppress(Exception):
                proc.wait(timeout=10)
        stop.set()
        watcher.join(timeout=35)
        for f in files:
            f.close()
    wall = max(exits)
    hashes, launches = [], []
    for i, proc in enumerate(procs):
        text = (work / f"dkg{i}.stdout").read_text()
        err = (work / f"dkg{i}.stderr").read_text(errors="replace")
        got = re.search(r"dkg complete: lock hash 0x([0-9a-f]{64})", text)
        rep = re.search(r"dkg: kernel launches (\{.*\})", text)
        if proc.returncode != 0 or got is None or rep is None:
            print(f"dkg: operator {i} stderr:\n{err[-3000:]}",
                  file=sys.stderr, flush=True)
            raise AssertionError(f"dkg: operator {i} exited "
                                 f"{proc.returncode}")
        hashes.append(got.group(1))
        launches.append(json.loads(rep.group(1)))
        zero = [k for k in GRAPH_KERNELS + COMBINE_PATH_KERNELS
                + H2C_PATH_KERNELS if not launches[-1].get(k)]
        if zero:
            raise AssertionError(f"dkg: operator {i} never launched {zero}")
    on_smi = sorted(p.pid for p in procs if p.pid in pids)

    t0 = time.perf_counter()
    objs = [load_json(str(work / "cluster" / f"node{i}" /
                          "cluster-lock.json")) for i in range(n)]
    # `run`'s boot check: the load verifies each lock (`verify_lock`)
    locks = [lock_from_json(obj, verify=True) for obj in objs]
    if len({lk.lock_hash.hex() for lk in locks} | set(hashes)) != 1:
        raise AssertionError(f"dkg: lock hashes differ: {hashes}")
    lock = locks[0]
    if len(lock.validators) != m or lock.definition.threshold != t:
        raise AssertionError("dkg: the lock is not the definition's")
    for i in range(n):
        keys = keystore.load_keys(str(work / "cluster" / f"node{i}" /
                                      "validator_keys"))
        if [api.privkey_to_pubkey(sk) for sk in keys] != \
                [v.public_shares[i] for v in lock.validators]:
            raise AssertionError(f"dkg: node {i}'s keystores are not its "
                                 f"pubshares")
    deposits = load_json(str(work / "cluster" / "node0" /
                             "deposit-data.json"))
    for i in range(1, n):
        if load_json(str(work / "cluster" / f"node{i}" /
                         "deposit-data.json")) != deposits:
            raise AssertionError(f"dkg: node {i}'s deposit data differs")
    rows = [(v.public_key, deposit_signing_root(
        v.public_key, bytes.fromhex(d["withdrawal_credentials"]),
        lock.definition.fork_version), bytes.fromhex(d["signature"]))
        for d, v in zip(deposits, lock.validators)]
    if any(bytes.fromhex(d["pubkey"]) != v.public_key
           for d, v in zip(deposits, lock.validators)) or not all(
            oracle_verdicts(rows)):
        raise AssertionError("dkg: a deposit signature fails the oracle")
    check_s = time.perf_counter() - t0

    for k in (3, 2):
        shutil.rmtree(work / f"combine{k}", ignore_errors=True)
        for i in range(k):
            shutil.copytree(work / "cluster" / f"node{i}",
                            work / f"combine{k}" / f"node{i}")
    with contextlib.redirect_stdout(io.StringIO()):
        rc3 = cli(["combine", "--cluster-dir", str(work / "combine3"),
                   "--output-dir", str(work / "combined3")])
    secrets = keystore.load_keys(str(work / "combined3"))
    if rc3 != 0 or [api.privkey_to_pubkey(sk) for sk in secrets] != \
            [v.public_key for v in lock.validators]:
        raise AssertionError(f"dkg: combine over {t} nodes exited {rc3}")
    with contextlib.redirect_stderr(io.StringIO()) as err2:
        rc2 = cli(["combine", "--cluster-dir", str(work / "combine2"),
                   "--output-dir", str(work / "combined2")])
    if rc2 == 0 or "< threshold" not in err2.getvalue():
        raise AssertionError(f"dkg: combine over 2 nodes exited {rc2}")

    log(f"dkg ceremony as processes (Pedersen, {n} operators, {t}-of-{n}, "
        f"{m} validators, real BLS): create enr ×{n}, create dkg, sign ×{n} "
        f"{prep_s:.2f} s; the {n} `dkg` processes {wall:.2f} s from spawn "
        f"to the last exit (exits at "
        f"{', '.join(f'{x:.2f}' for x in exits)} s); lock "
        f"0x{hashes[0]} equal on all {n}, verified on load; keystores, "
        f"{m} deposit signatures (oracle) and the locks checked in "
        f"{check_s:.2f} s; combine over {t} nodes recombined {m} group "
        f"keys, over 2 refused; pids under nvidia-smi's compute apps: "
        f"{len(on_smi)} of {n}; each process's launches: "
        + json.dumps(launches))
    return {"wall_s": wall, "exits_s": exits, "launches": launches,
            "pids_on_smi": len(on_smi)}


def dkg_phase(dev) -> dict:
    """Config 5's share-proof verify warm and cold on a fresh resident
    backend, the in-process keycast ceremony (its launches are the
    kernels line's `launches_dkg`), and the Pedersen ceremony as four
    operator processes → the in-process ceremony's launches."""
    import shutil

    from charon_tpu_torch.tbls import api, backend_cuda

    prev, prev_scheme = api._backend(), api.scheme_name()
    backend = backend_cuda.CUDABackend()
    api.register_backend("cuda", backend)
    api.set_scheme("bls")
    work = ROOT / "build" / "dkg_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        shares, pubshares, bits = dkg_share_pool(dev)
        log(f"dkg config 5 pool: {DKG_V:,} Shamir shares on the host and "
            f"their pubshares on the card {time.perf_counter() - t0:.2f} s")
        dkg_warm(dev, backend, shares, pubshares)
        dkg_cold(dev, backend, shares, bits, pubshares)
        counts = dkg_loop_ceremony(work)
        torch.cuda.empty_cache()
        dkg_processes(work)
    finally:
        api.register_backend("cuda", prev)
    return counts


# ---------------------------------------------------------------------------
# The chaos and race harnesses with real BLS (after the dkg phase)
# ---------------------------------------------------------------------------

#: the fault catalogue's scenarios run on the card at seed 0, with the
#: slots they run: garbage partials reach K12's decompression (a dead row
#: of the batch); validly signed equivocations must verify for the
#: detector to count them.  byzantine_equivocation is cut from the
#: catalogue's 32 slots to 22 for the script's time limit: its longest
#: run at 32 held the phase (PERF.md §6), and 21 is the fewest at
#: which each honest node still counts the ≥ 30 equivocations its own
#: check asks for
CHAOS_SCENARIOS = (("garbage", 24), ("byzantine_equivocation", 22))
#: garbage's replay contract on the card: two runs at this many slots
CHAOS_REPLAY_SLOTS = 8
#: distinct attestations of each scenario held against the oracle
CHAOS_ORACLE_SAMPLES = 8
#: the race stress on the card: dispatch_stress from this seed, twice
CHAOS_RACE_SEED = 5
#: the verify buckets the runs reach (their flushes, the 2 × distinct
#: attestations of the final check), captured on each run's stream
#: before the runs start
CHAOS_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class SignMemo:
    """`tbls.sign` for the chaos runs, each (key, message) signed once:
    the runs share the cluster's keys and the beacon mock's attestation
    data by slot, so a signature one run's mock VC made serves the
    others (a run that asks for one being made waits for it, its virtual
    clock still: the result is the same bytes, only the host's time is
    saved).  `preload` takes the ones made beforehand (`chaos_presign`)."""

    def __init__(self, sign):
        self._sign = sign
        self._lock = threading.Lock()
        self._made: dict = {}
        self.signed = self.served = 0

    def preload(self, made: dict) -> None:
        """Keep `made`'s {(key, message): signature}."""
        for pair, sig in made.items():
            done = threading.Event()
            done.set()
            self._made[pair] = [done, sig]

    def __call__(self, sk: bytes, msg: bytes) -> bytes:
        with self._lock:
            entry = self._made.get((sk, msg))
            mine = entry is None
            if mine:
                entry = self._made[(sk, msg)] = [threading.Event(), None]
                self.signed += 1
            else:
                self.served += 1
        if mine:
            try:
                entry[1] = self._sign(sk, msg)
            finally:
                entry[0].set()
        entry[0].wait()
        if entry[1] is None:
            raise RuntimeError("chaos: a shared signature failed")
        return entry[1]


class ChaosTally:
    """Per thread: a backend's verify tiles, rows, rejected rows, stage
    seconds and stage launches, its combines and validator rows — its
    device stages and `_note_verify`, wrapped for the phase as bound
    methods (the pipeline still finds the backend behind them), counted
    on the thread that ran them, so runs on concurrent threads keep their
    own figures."""

    def __init__(self, backend):
        self._local = threading.local()
        verify, combine = (backend.verify_device_exec,
                           backend.combine_device_exec)
        note = backend._note_verify

        def verify_exec(be, prepared):
            oks = verify(prepared)
            if oks:
                t = self.mine()
                t["tiles"] += 1
                t["rows"] += len(oks)
                bad = len(oks) - sum(oks)
                t["rejected"] += bad
                t["rejecting_tiles"] += bool(bad)
            return oks

        def combine_exec(be, prepared):
            out = combine(prepared)
            t = self.mine()
            t["combines"] += bool(out)
            t["combine_rows"] += len(out)
            return out

        def note_verify(be, stages, launches):
            t = self.mine()
            for k, sec in stages.items():
                t["stages"][k] = t["stages"].get(k, 0.0) + sec
            for k, counts in launches.items():
                mine = t["stage_launches"].setdefault(k, {})
                for name, c in counts.items():
                    mine[name] = mine.get(name, 0) + c
            note(stages, launches)

        backend.verify_device_exec = types.MethodType(verify_exec, backend)
        backend.combine_device_exec = types.MethodType(combine_exec,
                                                       backend)
        backend._note_verify = types.MethodType(note_verify, backend)

    def mine(self) -> dict:
        """The calling thread's figures (zero at its first call)."""
        t = getattr(self._local, "t", None)
        if t is None:
            t = self._local.t = {
                "tiles": 0, "rows": 0, "rejected": 0, "rejecting_tiles": 0,
                "combines": 0, "combine_rows": 0, "stages": {},
                "stage_launches": {}}
        return t


def chaos_oracle(harness, res, label: str, pool) -> int:
    """CHAOS_ORACLE_SAMPLES distinct (message, signature) attestations of
    a run, spread over it: each must verify under the group key the run
    found, by the pure-Python oracle (in `pool`'s worker processes) → how
    many were checked."""
    from charon_tpu_torch.eth2util.signing import DomainName, signing_root
    from charon_tpu_torch.testutil import chaos

    keys = {v.group_pubkey: v.tss.group_pubkey
            for v in harness.cluster.validators}
    distinct: dict = {}
    for att, rec in zip(harness.bmock.attestations, res.attestations):
        distinct.setdefault((att.data.hash_tree_root(), att.signature),
                            (att, rec))
    rows = list(distinct.values())
    step = max(1, len(rows) // CHAOS_ORACLE_SAMPLES)
    sample = rows[::step][:CHAOS_ORACLE_SAMPLES]
    if len(sample) < CHAOS_ORACLE_SAMPLES:
        raise AssertionError(f"chaos {label}: only {len(sample)} distinct "
                             f"attestations")
    if any(pk is None for _, (_, _, _, pk) in sample):
        raise AssertionError(f"chaos {label}: an attestation verified under "
                             f"no group key")
    oks = pool.map(oracle_verify, [keys[rec[3]] for _, rec in sample],
                   [signing_root(DomainName.BEACON_ATTESTER,
                                 att.data.hash_tree_root(), chaos.FORK,
                                 chaos.GVR) for att, _ in sample],
                   [att.signature for att, _ in sample])
    for (_, (slot, _, _, pk)), ok in zip(sample, oks):
        if not ok:
            raise AssertionError(f"chaos {label}: slot {slot}'s attestation "
                                 f"fails the oracle under {pk}")
    return len(sample)


def chaos_sign_pairs(runs) -> set:
    """The (share key, message) pairs the runs' mock VCs and byzantine
    signer sign: the same runs under the insecure-test scheme (the same
    keys, duties and plans; ≈ 1 s a run), recorded."""
    from charon_tpu_torch.tbls import api
    from charon_tpu_torch.testutil import chaos

    pairs: set = set()
    sign = api.sign

    def recorded(sk: bytes, msg: bytes) -> bytes:
        pairs.add((sk, msg))
        return sign(sk, msg)

    api.sign = recorded
    try:
        for name, slots in runs:
            scn = dataclasses.replace(chaos.SCENARIOS[name], slots=slots)
            chaos.ChaosHarness(scn, seed=0, scheme="insecure-test").run()
    finally:
        api.sign = sign
    return pairs


def chaos_runs() -> tuple:
    """The chaos phase's runs: the CHAOS_SCENARIOS, then garbage at
    CHAOS_REPLAY_SLOTS twice."""
    return (*CHAOS_SCENARIOS, ("garbage", CHAOS_REPLAY_SLOTS),
            ("garbage", CHAOS_REPLAY_SLOTS))


def chaos_pairs() -> list:
    """In a host worker: the (key, message) pairs the chaos runs and the
    race stress will sign, sorted."""
    from charon_tpu_torch.testutil import racecheck

    pairs = chaos_sign_pairs(chaos_runs())
    stress, _ = racecheck.stress_inputs(CHAOS_RACE_SEED)
    pairs |= {(racecheck.STRESS_SK, m) for msgs in stress for m in msgs}
    return sorted(pairs)


def chaos_presign(pool) -> Future:
    """The chaos phase's signatures, made on `pool`'s workers from the
    start of the run (the build needs few of the host's cores at its end):
    the pairs recorded in one worker (`chaos_pairs`), then signed with the
    bls scheme's pure-Python `tbls.sign` on all of them → a future of
    ({(key, message): signature}, the seconds to record the pairs, the
    seconds to the last signature)."""
    from charon_tpu_torch.tbls import api

    out: Future = Future()

    def work() -> None:
        try:
            t0 = time.perf_counter()
            pairs = pool.submit(chaos_pairs).result()
            t_pairs = time.perf_counter() - t0
            sigs = pool.map(api.sign, [sk for sk, _ in pairs],
                            [m for _, m in pairs], chunksize=4)
            made = dict(zip(pairs, sigs))
            out.set_result((made, t_pairs, time.perf_counter() - t0))
        except BaseException as exc:  # noqa: BLE001 — raised by result()
            out.set_exception(exc)

    threading.Thread(target=work, name="chaos-presign", daemon=True).start()
    return out


def chaos_run(name: str, slots: int, stream, tally: ChaosTally,
              publish=lambda harness: None) -> dict:
    """One catalogue scenario at seed 0 with the bls scheme on the card,
    on the calling thread and `stream`, `ChaosHarness.check` passed
    (`publish(harness)` before it runs) → {the harness, its result, wall
    seconds, the thread's launches, its tally}."""
    from charon_tpu_torch.ops import launch_count
    from charon_tpu_torch.testutil import chaos

    scn = dataclasses.replace(chaos.SCENARIOS[name], slots=slots)
    n0 = launch_count.this_thread()
    with torch.cuda.stream(stream):
        t0 = time.perf_counter()
        harness = chaos.ChaosHarness(scn, seed=0, scheme="bls")
        publish(harness)
        res = harness.run()
        wall = time.perf_counter() - t0
    n1 = launch_count.this_thread()
    harness.check(res)
    counts = {k: n1.get(k, 0) - n0.get(k, 0) for k in all_launches()}
    return {"harness": harness, "res": res, "wall": wall,
            "counts": counts, "tally": tally.mine()}


@contextlib.contextmanager
def verify_graphs_per_stream(stream_key=None):
    """While open, the resident route keeps a verify bucket per (device,
    padded v, replaying stream) in place of `backend_cuda`'s one per
    (device, padded v): runs on threads and CUDA streams of their own each
    replay their own copy of a bucket, its static buffers included, in
    place of queueing on the one bucket's lock (held from load to
    readback).  The copies are dropped at exit and `backend_cuda`'s own
    buckets are left as they were.  `stream_key(device)` names the
    replaying stream (default: the calling thread's current CUDA
    stream) → the copies by key."""
    from charon_tpu_torch.tbls import backend_cuda

    if stream_key is None:
        def stream_key(device):
            return torch.cuda.current_stream(device).cuda_stream
    shared = backend_cuda._verify_graph
    graphs: dict = {}
    lock = threading.Lock()

    def per_stream(device, v):
        key = (str(device), v, stream_key(device))
        with lock:
            g = graphs.get(key)
            if g is None:
                g = graphs[key] = backend_cuda._VerifyGraph(device, v)
            return g

    backend_cuda._verify_graph = per_stream
    try:
        yield graphs
    finally:
        backend_cuda._verify_graph = shared
        graphs.clear()


def chaos_left(harnesses: list, elapsed: float) -> float | None:
    """Seconds the slowest of the runs still needs for its scenario
    window, from its virtual clock's progress through it so far (None
    before every run is a quarter of the way)."""
    left = 0.0
    for h in harnesses:
        loop = None if h is None else h._loop
        if loop is None:
            return None
        done = min(1.0, loop.time() / (h.scenario.slots * h.dur))
        if done < 0.25:
            return None
        left = max(left, elapsed * (1.0 - done) / done)
    return left


def chaos_concurrent(runs, streams, tally: ChaosTally,
                     beside=lambda left: None) -> list[dict]:
    """`runs` ((name, slots), ...) each on a thread and a stream of its
    own, all at once (a run's virtual clock is its own, so concurrency
    changes no result; their replays overlap on their streams, each with
    its own copy of a verify bucket, `verify_graphs_per_stream`), calling
    `beside(chaos_left(...))` on this thread every half second meanwhile
    → their `chaos_run` results in order, each wall shared with the
    others' host time; the first failure raised.  The runs share the
    process's tbls scheme, which must be bls: each run sets it and puts
    back what it found."""
    from charon_tpu_torch.tbls import api

    if api.scheme_name() != "bls":
        raise AssertionError(f"chaos: the runs would share the "
                             f"{api.scheme_name()!r} scheme, not bls")
    out: list = [None] * len(runs)
    harnesses: list = [None] * len(runs)

    def work(i: int, name: str, slots: int) -> None:
        try:
            out[i] = chaos_run(name, slots, streams[i], tally,
                               lambda h: harnesses.__setitem__(i, h))
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            out[i] = exc

    threads = [threading.Thread(target=work, args=(i, *run),
                                name=f"chaos-{run[0]}-{i}")
               for i, run in enumerate(runs)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        beside(chaos_left(harnesses, time.perf_counter() - t0))
        next(t for t in threads if t.is_alive()).join(0.5)
    for r in out:
        if isinstance(r, BaseException):
            raise r
    return out


def chaos_phase(dev, presigned: Future, beside=lambda left: None) -> dict:
    """The fault catalogue and the race stress with real BLS, on a fresh
    resident backend: the CHAOS_SCENARIOS runs and garbage at
    CHAOS_REPLAY_SLOTS twice, all at once on threads and streams of their
    own (`chaos_concurrent`; each stream's own verify buckets,
    `verify_graphs_per_stream`, captured first; the mock VCs' and the
    stress's signatures made in the host's workers from the start of the
    run, `presigned` from `chaos_presign`, `SignMemo`), each passing
    `ChaosHarness.check` (liveness, safety, telemetry truth) with sampled
    attestations equal to the oracle, the verify tile's and the
    combine's kernels launched and K1 only as a re-check's negation, the
    two replays at one fingerprint; then `testutil.racecheck`'s
    dispatch_stress twice: clean, every entry verified, `CUDABackend.*`
    among the writers, one fingerprint (`beside(left)` called through the
    runs, `chaos_concurrent`) → the CHAOS_SCENARIOS runs' launches summed
    (the kernels line's `launches_chaos`)."""
    from charon_tpu_torch.ops import cuda_fp
    from charon_tpu_torch.tbls import api, backend_cuda
    from charon_tpu_torch.tbls.ref import curve as rc
    from charon_tpu_torch.testutil import chaos, racecheck

    prev, prev_scheme = api._backend(), api.scheme_name()
    backend = backend_cuda.CUDABackend()
    api.register_backend("cuda", backend)
    api.set_scheme("bls")
    t_phase = time.perf_counter()
    total: dict[str, int] = {}
    memo = SignMemo(api.sign)
    # pure-Python BLS (the oracle) on the host's workers
    pool = host_pool()
    try:
        runs = chaos_runs()
        streams = [torch.cuda.Stream(dev) for _ in runs]
        with verify_graphs_per_stream():
            t0 = time.perf_counter()
            pk = rc.g1_to_bytes(rc.G1_GEN)
            inf_sig = backend_cuda._G2_INF_BYTES.tobytes()
            for stream in streams:
                with torch.cuda.stream(stream):
                    for v in CHAOS_BUCKETS:
                        backend.batch_verify_bytes(
                            [(pk, b"chip smoke chaos bucket %d" % k, inf_sig)
                             for k in range(v)])
            t1 = time.perf_counter()
            made, t_pairs, t_made = presigned.result()
            memo.preload(made)
            log(f"chaos: verify buckets {list(CHAOS_BUCKETS)} captured on "
                f"{len(streams)} streams in {t1 - t0:.1f} s; the "
                f"{len(made)} signatures the runs and the stress will ask "
                f"for (recorded from the same runs under insecure-test in "
                f"{t_pairs:.1f} s) made in the host's {HOST_WORKERS} "
                f"workers {t_made:.1f} s after the run's start, in by "
                f"{time.perf_counter() - t0:.1f} s")
            tally = ChaosTally(backend)
            api.sign = memo
            t0 = time.perf_counter()
            done = chaos_concurrent(runs, streams, tally, beside)
        log(f"chaos: {len(runs)} runs at once, each on its own thread and "
            f"CUDA stream: {time.perf_counter() - t0:.1f} s; signatures "
            f"served {memo.served}, made during the runs {memo.signed}; "
            f"each run's wall below shares the host with the other runs "
            f"and, from the cluster's spawn, the card with its booting "
            f"processes")
        for (name, slots), r in zip(runs[:len(CHAOS_SCENARIOS)], done):
            res, counts, t = r["res"], r["counts"], r["tally"]
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
            zero = [k for k in GRAPH_KERNELS + COMBINE_PATH_KERNELS
                    if not counts[k]]
            if zero:
                raise AssertionError(f"chaos {name}: never launched {zero}")
            rechecks = t["stage_launches"].get("recheck_s", {}).get(
                "pp_f12mul", 0)
            k1 = {k: counts[k] for k in cuda_fp.LAUNCHES if counts[k]}
            if k1 != ({"fp_neg": rechecks} if rechecks else {}):
                raise AssertionError(f"chaos {name}: K1 launched {k1} with "
                                     f"{rechecks} re-checks")
            sampled = chaos_oracle(r["harness"], res, name, pool)
            flushes = sum(h.node.verifier.launches
                          for h in r["harness"]._slots)
            full = chaos.SCENARIOS[name].slots
            cut = (f" (cut from the catalogue's {full} for the phase's time)"
                   if slots != full else "")
            stages = {k: round(sec, 4)
                      for k, sec in sorted(t["stages"].items())}
            equiv = {str(n): c for n, c in res.equivocations.items()}
            launched = {k: c for k, c in counts.items() if c}
            log(f"chaos {name} (bls, seed 0, {slots} slots{cut}): "
                f"{r['wall']:.1f} s wall, concurrent; {flushes} verify "
                f"flushes through "
                f"the nodes' verifiers, {t['tiles']} tiles of {t['rows']} "
                f"rows ({t['rejected']} rows rejected in "
                f"{t['rejecting_tiles']} tiles, {rechecks} re-checks); "
                f"{t['combines']} combines of {t['combine_rows']} "
                f"validators; {len(res.attestations)} attestations, "
                f"{len(res.healthy_slots)} healthy slots, {sampled} "
                f"distinct ones equal to the oracle; byzantine "
                f"{json.dumps(res.byz_stats)}, router "
                f"{json.dumps(res.router_stats)}, equivocations counted "
                f"{json.dumps(equiv)}; verify stages (s, summed) "
                f"{json.dumps(stages)}; launches {json.dumps(launched)}; "
                f"fingerprint {res.fingerprint()[:16]}")
        replays = done[len(CHAOS_SCENARIOS):]
        fps = [(r["res"].fingerprint(), round(r["wall"], 1))
               for r in replays]
        if fps[0][0] != fps[1][0]:
            raise AssertionError(f"chaos garbage at {CHAOS_REPLAY_SLOTS} "
                                 f"slots does not replay: {fps}")
        log(f"chaos replay: garbage at {CHAOS_REPLAY_SLOTS} slots, seed 0, "
            f"twice on the card at once: fingerprint {fps[0][0][:16]} both "
            f"times ({fps[0][1]} s, {fps[1][1]} s wall, concurrent)")
        races = []
        for _ in range(2):
            t0 = time.perf_counter()
            rc_ = racecheck.run_scenario(
                "dispatch_stress", seed=CHAOS_RACE_SEED, scheme="bls")
            wall = time.perf_counter() - t0
            if rc_.counters["verified_ok"] != rc_.counters["entries"]:
                raise AssertionError(f"racecheck: {rc_.counters}")
            if not any(k.startswith("CUDABackend.") for k in rc_.writers):
                raise AssertionError(f"racecheck: no CUDABackend attribute "
                                     f"written: {sorted(rc_.writers)}")
            races.append(rc_)
            writers = {k: sorted(v) for k, v in sorted(rc_.writers.items())}
            log(f"racecheck dispatch_stress (bls, seed {CHAOS_RACE_SEED}): "
                f"clean in {wall:.1f} s; {json.dumps(rc_.counters)}; writers "
                f"{json.dumps(writers)}; fingerprint "
                f"{rc_.fingerprint()[:16]}")
        if races[0].fingerprint() != races[1].fingerprint():
            raise AssertionError(
                "racecheck dispatch_stress (bls) does not replay: "
                + json.dumps([r.to_dict() for r in races], default=list))
    finally:
        api.sign = memo._sign
        api.register_backend("cuda", prev)
        api.set_scheme(prev_scheme)
    log(f"chaos: phase {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# The validator-API serving layer under HTTP load (before the dkg phase)
# ---------------------------------------------------------------------------

def serving_phase() -> list:
    """The counterpart of the root bench.py's serving arms, on the port's
    stack (`testutil.serving_load`: the port's `VapiRouter` in front of
    its HTTP beacon mock, `app/http1` clients): coalesce — 64 concurrent
    VCs × 5 rounds of spec, attester duties and the validators snapshot,
    the upstream's duties 20 ms slow: ≥ 5× fewer upstream fetches than
    requests and no 503; overload — the duties class at 2 concurrent + 2
    queued, the upstream 50 ms slow, 32 clients on distinct epochs: sheds
    as 503 + Retry-After.  The arms assert their rules; → both arms'
    results.  No kernel runs here."""
    from charon_tpu_torch.testutil import serving_load

    arms = serving_load.run_serving_arms(n_vc=64, rounds=5)
    for arm in arms:
        log(f"serving: {arm['config']}: " + json.dumps(arm))
    co, ov = arms
    log(f"serving: coalesce {co['requests']} requests, "
        f"{co['upstream_fetches']} upstream fetches "
        f"({co['coalesce_ratio']:.1f}×), {co['rps']:.1f} requests/s, p50 / "
        f"p99 {co['p50_ms']:.3f} / {co['p99_ms']:.3f} ms; overload "
        f"{ov['served']} served, {ov['shed']} shed (503, Retry-After "
        f"{ov['retry_after']}), {ov['rps']:.1f} requests/s")
    return arms


# ---------------------------------------------------------------------------
# The kernel contract (the phase after the build)
# ---------------------------------------------------------------------------

def line_kernels() -> dict:
    """The kernels line's entries, from the kernel registry
    (charon_tpu_torch/analysis/registry.py): launch key → the registered
    instantiation whose figures the entry carries (its `source`, the TPU
    kernel it `replaces`, its compiled function's `name` in the ptxas
    report), so that the line and the audit cannot drift apart."""
    from charon_tpu_torch.analysis import registry

    registry.ensure_populated()
    return registry.line_kernels()


def contract_lints() -> dict:
    """The audit's AST lints (metric names against the port's catalogue,
    lock discipline, event-loop discipline): run in a host worker while
    nvcc builds."""
    from charon_tpu_torch.analysis.audit import run_lints

    return run_lints()


def contract_phase(dev, lints: Future, sms: int) -> dict:
    """The kernel contract on the card (module docstring, phase
    "contract") → launch key → its kernels-line figures (`smem_block`,
    `blocks_per_sm`, each at the instantiation's largest registered
    shape).  Raises on any violation."""
    from charon_tpu_torch.analysis import audit, fixtures, kernel_audit
    from charon_tpu_torch.analysis import registry, residency
    from charon_tpu_torch.ops import build

    t0 = time.perf_counter()
    report = audit.run_audit(
        ptxas_log=build.ptxas_log_path().read_text(),
        ptxas_path=str(build.ptxas_log_path().relative_to(ROOT)),
        lints=lints.result(), sms=sms)
    t_cpu = time.perf_counter() - t0
    shapes = kernel_audit.shape_rows()
    figures = {}
    for k in report.kernels:
        spec = next(s for s in registry.kernels() if s.name == k.name)
        rows = max((r for _, r in shapes.get(k.name, ())),
                   default=max(kernel_audit.DEFAULT_ROWS))
        card = kernel_audit.audit_card(spec, rows, sms, k)
        if spec.replaces is not None:
            figures[spec.launch] = {"smem_block": card["smem_block"],
                                    "blocks_per_sm": card["blocks_per_sm"]}
    t_card = time.perf_counter() - t0 - t_cpu
    report.residency_cases += residency.run_residency_audit(dev)
    bad = fixtures.audit_golden_bad("resident_roundtrip", dev)
    torch.cuda.synchronize(dev)
    t_res = time.perf_counter() - t0 - t_cpu - t_card
    log(report.summary())
    for case in bad.residency_cases:
        log(f"contract: golden-bad {case.name}: "
            + ("; ".join(case.violations) or "NOT FLAGGED"))
    if not bad.residency_cases or bad.ok:
        report.general.append("the golden-bad resident_roundtrip was not "
                              "flagged by the residency pass")
    log("contract: " + json.dumps({
        "kernels": len(report.kernels), "shapes": report.shapes_checked,
        "card": {k.name: k.card for k in report.kernels},
        "residency": [{"name": r.name, "launches": r.launches,
                       "nodes": r.nodes, "kernel_nodes": r.kernel_nodes,
                       "capture_s": r.capture_seconds}
                      for r in report.residency_cases]}))
    log(f"contract: {time.perf_counter() - t0:.2f} s (audit on the host "
        f"{t_cpu:.2f} s, the card's figures {t_card:.2f} s, residency and "
        f"golden-bad {t_res:.2f} s), {len(report.violations)} violations")
    if not report.ok:
        raise AssertionError("kernel contract: "
                             + "; ".join(report.violations))
    return figures


def main() -> int:
    if not (ROOT / "charon_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: charon_tpu_torch/ is not beside this script (run "
              "it from a checkout of the repository)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    try:
        # the host's work that needs no kernel: handed to the workers
        # before the build (the cluster's V by a signature timed first,
        # before the workers load the cores)
        cluster_prep = cluster_prepare(host_pool())
        lints = host_pool().submit(contract_lints)
        presigned = chaos_presign(host_pool())
        return run_phases(dev, t_start, cluster_prep, presigned, lints)
    finally:
        host_pool().shutdown(cancel_futures=True)


def chaos_and_cluster(dev, cluster_prep: dict, presigned: Future,
                      between=lambda: None) -> tuple[dict, dict]:
    """The chaos phase, then the cluster phase, whose processes boot
    beside the end of the chaos phase's runs: spawned once the runs'
    estimated seconds left and the phase's tail fit before the genesis
    (`cluster_start` at the latest after the phase), their waited slots
    after the phase (`between()` then) → (the chaos runs' launches, the
    nodes')."""
    cluster = None
    t0 = time.perf_counter()

    def spawn_beside(left: float | None) -> None:
        nonlocal cluster
        if cluster is None and left is not None and (
                left + CHAOS_TAIL_S <= CL_GENESIS_S - CL_SPAWN_SLACK_S):
            log(f"cluster: spawned {time.perf_counter() - t0:.1f} s into "
                f"the chaos phase, its runs' estimated {left:.1f} s left")
            cluster = cluster_start(cluster_prep)

    try:
        chaos_launches = chaos_phase(dev, presigned, spawn_beside)
    except BaseException:
        if cluster is not None:
            cluster.abort()
        raise
    if cluster is None:
        cluster = cluster_start(cluster_prep)
    between()
    return chaos_launches, cluster.finish()


def run_phases(dev, t_start: float, cluster_prep: dict,
               presigned: Future, lints: Future) -> int:
    """The phases in order (`main`'s, after it handed the host's work to
    its workers)."""
    from charon_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.INFO['build_seconds']:.1f} s) → {build.INFO['path']}")
    log(build.ptxas_report())
    ptxas = {r["name"]: r for r in build.ptxas_rows()}
    line = line_kernels()
    missing = [k for k, spec in line.items() if spec.name not in ptxas]
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

    log(f"phase contract: starts at {time.perf_counter() - t_start:.1f} s")
    contract = contract_phase(dev, lints, sms)

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
    combine_launches, _, pool, sig_sets = combine_phase(dev)
    mark("multichip")
    multichip_launches = multichip_phase(dev, sig_sets)
    del sig_sets
    mark("redesign")
    # K11 at the batch check's 1 row and a re-check tile's rows, K12 at a
    # verify tile, at the combine's padded 10,240 × 7 rows and at the
    # chaos and cluster tiles' 1 and 4 rows
    tile = api.verify_padded_rows(dispatch.VERIFY_TILE)
    redesign = redesign_kernels_phase(dev, pool, tile, VALIDATORS * SHARES,
                                      vrows * SHARES, sm_clocks_per_s, sms)
    # the main path's shapes: K11 at 1 row, K12 at a verify tile; the other
    # shape beside it
    kern["final_exp"] = {**redesign["final_exp@1"],
                         "recheck": redesign[f"final_exp@{tile}"]}
    kern["g2_decompress"] = {**redesign[f"g2_decompress@{tile}"],
                             "combine": redesign[
                                 f"g2_decompress@{vrows * SHARES}"],
                             "tiles": {str(n): redesign[f"g2_decompress@{n}"]
                                       for n in (1, 4)}}
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
    mark("simnet")
    simnet_launches = simnet_phase()
    mark("serving")
    serving_phase()
    mark("dkg")
    dkg_launches = dkg_phase(dev)
    mark("chaos")
    chaos_launches, cluster_launches = chaos_and_cluster(
        dev, cluster_prep, presigned, lambda: mark("cluster"))

    from charon_tpu_torch.tbls import dispatch
    pipe = dispatch.current_pipeline()
    if pipe is not None:
        pipe.shutdown()

    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"charon_tpu_torch/{spec.source}",
         "replaces": spec.replaces,
         "launches": (combine_launches.get(name, 0)
                      + multichip_launches.get(name, 0)
                      + verify_launches[name]
                      + cold_launches[name] + slot_launches[name]
                      + distinct_launches[name]
                      + sum(c[name] for c in resident_launches.values())
                      + simnet_launches[name]
                      + dkg_launches[name]
                      + chaos_launches.get(name, 0)
                      + cluster_launches.get(name, 0)),
         "launches_combine": combine_launches.get(name, 0),
         "launches_multichip": multichip_launches.get(name, 0),
         "launches_verify": verify_launches[name],
         "launches_verify_cold": cold_launches[name],
         "launches_verify_slot_start": slot_launches[name],
         "launches_verify_distinct": distinct_launches[name],
         "launches_resident": {kind: c[name] for kind, c in
                               resident_launches.items()},
         "launches_simnet": simnet_launches[name],
         "launches_dkg": dkg_launches[name],
         "launches_chaos": chaos_launches.get(name, 0),
         "launches_cluster": cluster_launches.get(name, 0),
         **kern[name],
         **{k: ptxas[spec.name][k] for k in ("regs", "stack", "spill")},
         **contract[name],
         "library_ms": None}
        for name, spec in line.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
