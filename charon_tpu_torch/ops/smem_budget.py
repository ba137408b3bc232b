"""Shared-memory and occupancy model of the port's kernels on an H100.

The counterpart of the JAX package's ops/vmem_budget.py.  A TPU kernel
is bounded by the scoped VMEM one grid step holds; a Hopper kernel by
what one block takes of an SM — dynamic shared memory, registers,
threads — and so by how many blocks an SM holds at once.  The program
kernels (K13, K15–K18, K20, K22–K24) keep every intermediate of a row in
shared memory, `slots` Fp elements a row laid out by
csrc/program.cuh's `row_words`, so their shared memory a block is the
rows a block times that; K14's cooperative launch needs every block
resident at once, so its grid is bounded by SMs × blocks an SM.

`blocks_per_sm` follows the CUDA occupancy calculator
(``cuda_occupancy.h``) for compute capability 9.0: registers are
allocated a warp at a time in units of 256 over four sub-partitions,
shared memory in units of 128 bytes plus 1 KB the system reserves a
block.  chip_smoke.py's ``contract`` phase holds this model against the
card's own ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.
"""

from __future__ import annotations

from ..analysis.registry import Geometry

# H100 SXM, compute capability 9.0 (CUDA C++ Programming Guide,
# "Technical Specifications per Compute Capability"; NVIDIA's H100 data
# sheet)
SMS = 132
WARP = 32
#: dynamic shared memory a block may opt into (227 KB)
SMEM_PER_BLOCK_MAX = 232_448
#: shared memory an SM (228 KB), reserved a block, allocation unit
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1_024
SMEM_ALLOC_UNIT = 128
REGS_PER_SM = 65_536
REGS_PER_BLOCK = 65_536
REGS_PER_THREAD_MAX = 255
REG_ALLOC_UNIT = 256              # registers, allocated a warp at a time
REG_SUB_PARTITIONS = 4
THREADS_PER_SM = 2_048
WARPS_PER_SM = THREADS_PER_SM // WARP
BLOCKS_PER_SM = 32

#: csrc/program.cuh: a row's Fp2 pairs are 2·32 + 1 words (one pad word)
PAIR_WORDS = 2 * 32 + 1


def _round_up(x: int, unit: int) -> int:
    return -(-x // unit) * unit


def row_words(slots: int) -> int:
    """csrc/program.cuh's ``row_words``: a row's int32 words for `slots`
    Fp slots — its pairs, rounded up to 8 (mod 32) so that the row groups
    of a warp sit 8 banks apart."""
    words = slots // 2 * PAIR_WORDS
    return words + (8 - words) % 32


def program_rows(lanes: int) -> int:
    """Rows a program kernel's one-warp block covers at `lanes` threads a
    row (the launchers' ``WARP / lanes``)."""
    if lanes <= 0 or WARP % lanes:
        raise ValueError(f"lanes {lanes} does not divide a warp")
    return WARP // lanes


def program_smem_bytes(lanes: int, slots: int) -> int:
    """Dynamic shared memory a program kernel's block takes: its rows ×
    `row_words(slots)` int32 words (the launchers' ``bytes``)."""
    return program_rows(lanes) * row_words(slots) * 4


def blocks_per_sm(regs: int, threads: int, smem: int,
                  static_smem: int = 0) -> dict:
    """Blocks of `threads` threads using `regs` registers a thread and
    `smem` + `static_smem` bytes of shared memory that one SM holds at
    once → {"blocks", "by_regs", "by_smem", "by_threads", "limit"} (the
    smallest limit's name)."""
    warps = -(-threads // WARP)
    by_threads = min(BLOCKS_PER_SM, WARPS_PER_SM // warps)
    per_warp = _round_up(max(regs, 1) * WARP, REG_ALLOC_UNIT)
    assumed = per_warp * _round_up(warps, REG_SUB_PARTITIONS)
    if regs > REGS_PER_THREAD_MAX or assumed > REGS_PER_BLOCK \
            or per_warp * warps > REGS_PER_BLOCK:
        by_regs = 0
    else:
        per_part = REGS_PER_SM // REG_SUB_PARTITIONS // per_warp
        by_regs = per_part * REG_SUB_PARTITIONS // warps
    total = smem + static_smem
    if total > SMEM_PER_BLOCK_MAX:
        by_smem = 0
    else:
        by_smem = SMEM_PER_SM // _round_up(total + SMEM_RESERVED_PER_BLOCK,
                                           SMEM_ALLOC_UNIT)
    limits = {"by_threads": by_threads, "by_regs": by_regs,
              "by_smem": by_smem}
    limit = min(limits, key=limits.get)
    return {"blocks": limits[limit], **limits, "limit": limit}


def cooperative_grid(rows: int, per_sm: int, sms: int = SMS) -> int:
    """K14's persistent grid (csrc/fold.cu's launcher): a block a product
    of the first level, at most every block the card holds at once."""
    return min(per_sm * sms, max(rows // 2, 1))


def per_thread(block: int):
    """The geometry of a kernel launched a thread a row, `block` threads
    a block: (rows, SMs) → `Geometry`."""
    return lambda rows, sms: Geometry(threads=block, rows=block)


def lane_groups(lanes: int):
    """The geometry of a kernel launched a group of `lanes` threads a row
    in one-warp blocks, its shared memory static (K12): (rows, SMs) →
    `Geometry`."""
    rows = program_rows(lanes)
    return lambda n, sms: Geometry(threads=WARP, rows=rows)


def per_block_row(threads: int):
    """The geometry of a kernel launched a block of `threads` threads a
    row, its shared memory static (K11): (rows, SMs) → `Geometry`."""
    return lambda rows, sms: Geometry(threads=threads, rows=1)


def program_geometry(prog):
    """A program kernel's geometry from its scheduled program (the
    `lanes` and `slots` its launcher is passed): a one-warp block of
    `program_rows(lanes)` rows and `program_smem_bytes` of shared memory."""
    return Geometry(threads=WARP, rows=program_rows(prog.lanes),
                    smem=program_smem_bytes(prog.lanes, prog.slots),
                    lanes=prog.lanes, slots=prog.slots)
