"""Kernel-contract registry — the import-light registration API.

The kernel wrapper modules (`ops/cuda_*.py`) register every CUDA kernel
instantiation they launch here at import time, named as the compiler
names it in its ``-Xptxas -v`` report (`ops/build.ptxas_rows`), with its
launch geometry and its register, stack and spill budgets;
`tbls/backend_cuda` registers the workload shapes the main path really
launches, the resident verify graph and the sharded combine.  The audit
passes iterate the registry — a ``__global__`` instantiation in
``csrc/`` that is not registered is itself an audit failure.

This module imports neither torch nor numpy, so registration adds
nothing to the wrappers' import cost and cannot make an import cycle
(ops → analysis.registry ← analysis.audit → ops).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class Geometry:
    """One launch's shape: `threads` a block covering `rows` rows, with
    `smem` bytes of dynamic shared memory a block (`ops/smem_budget`'s
    model for the program kernels).  `lanes` / `slots` are a program
    kernel's threads a row and shared-memory Fp slots a row (0 for the
    others)."""

    threads: int
    rows: int
    smem: int = 0
    lanes: int = 0
    slots: int = 0


@dataclass(frozen=True)
class KernelSpec:
    """One ``__global__`` instantiation of ``csrc/``.

    name     : as `ops/build.ptxas_rows` names it ("fp_ops.cu
               fp_op_kernel<0>", "miller.cu miller_loop_kernel")
    symbol   : the ``__global__`` function in `source`
    source   : its ``.cu`` file, relative to the package
    launch   : the wrapper's `LAUNCHES` key counting its launches
    attr_index : its index in the source's attribute query
               (``charon_<stem>_attrs``, the card-side pass)
    geometry : (rows, SMs) → the `Geometry` the wrapper launches it with
               at that many rows on a card with that many SMs; for a
               program kernel, from the scheduled program's lanes and
               slots (the values the launcher is passed)
    budget   : (registers, stack bytes, spill bytes) a thread: the build's
               figures when the spec was written, so any growth fails
               until the spec is changed with a reason
    replaces : ``file:line`` of the TPU kernel it stands for in
               chip_smoke.py's kernels line, None for an instantiation
               that has no entry there
    perf_rows: the rows of PERF.md's kernel table it serves
    cooperative : launched with ``cudaLaunchCooperativeKernel`` (every
               block resident at once)
    tail     : rows past the last (grid × rows a block − rows) run a
               guarded tail; False where a block covers exactly one row
    """

    name: str
    symbol: str
    source: str
    launch: str
    attr_index: int
    geometry: Callable[[int, int], Geometry]
    budget: tuple
    replaces: str | None = None
    perf_rows: tuple = ()
    cooperative: bool = False
    tail: bool = True


@dataclass(frozen=True)
class WorkloadShape:
    """One shape the main path launches: `rows` per kernel instantiation
    (its `KernelSpec.name`) for one call of `origin`."""

    name: str
    origin: str
    rows: tuple                         # ((spec name, rows), ...)


@dataclass(frozen=True)
class ResidencyProgramSpec:
    """One captured device graph whose residency the auditor checks
    (`analysis.residency`, on the card only).

    ``build(v, device)`` returns the bucket (a
    `tbls.backend_cuda._VerifyGraph`): its ``capture(keep_graph=True)``
    captures the graph into ``.graph`` and the launches recorded inside
    it into ``.launches``; ``stages`` are the wrappers' `LAUNCHES` keys
    the capture must hold, in order, with no host round trip between
    them; ``cases`` the padded buckets v to capture."""

    name: str
    build: Callable[[int, Any], Any]
    stages: tuple = ()
    cases: tuple = ()


@dataclass(frozen=True)
class ShardProgramSpec:
    """One sharded program whose shards the shard pass checks
    (`analysis.shard_audit`).

    ``run(pts_vt, digits_vt, devices, scope=)`` runs it, entering
    ``scope(j, device)`` around shard j's work; ``plan(v, t, devices)`` →
    (v_local, [(lo, hi)]) its split; ``shard_inputs(src_pts, src_digits,
    v_local, device)`` a shard's padded inputs; ``prime(t, nwin,
    devices)`` makes what every shard reads before any shard runs;
    ``rows(v_local, t)`` → {kernel spec name: rows} a shard launches.  The
    plan is checked at every (V, T) of ``cases``; the program runs once
    at the ``small`` (T, nwin) case under the recorder."""

    name: str
    run: Callable[..., Any]
    plan: Callable[..., tuple]
    shard_inputs: Callable[..., tuple]
    prime: Callable[..., None]
    rows: Callable[[int, int], dict]
    cases: tuple = ()
    small: tuple = (2, 2)


_KERNELS: dict[str, KernelSpec] = {}
_SHAPES: dict[str, WorkloadShape] = {}
_SHARD_PROGRAMS: dict[str, ShardProgramSpec] = {}
_RESIDENCY_PROGRAMS: dict[str, ResidencyProgramSpec] = {}


def register_kernel(spec: KernelSpec) -> None:
    _KERNELS[spec.name] = spec


def register_workload_shape(shape: WorkloadShape) -> None:
    _SHAPES[shape.name] = shape


def register_shard_program(spec: ShardProgramSpec) -> None:
    _SHARD_PROGRAMS[spec.name] = spec


def register_residency_program(spec: ResidencyProgramSpec) -> None:
    _RESIDENCY_PROGRAMS[spec.name] = spec


def kernels() -> tuple[KernelSpec, ...]:
    return tuple(_KERNELS[k] for k in sorted(_KERNELS))


def workload_shapes() -> tuple[WorkloadShape, ...]:
    return tuple(_SHAPES[k] for k in sorted(_SHAPES))


def shard_programs() -> tuple[ShardProgramSpec, ...]:
    return tuple(_SHARD_PROGRAMS[k] for k in sorted(_SHARD_PROGRAMS))


def residency_programs() -> tuple[ResidencyProgramSpec, ...]:
    return tuple(_RESIDENCY_PROGRAMS[k] for k in sorted(_RESIDENCY_PROGRAMS))


def line_kernels() -> dict[str, KernelSpec]:
    """chip_smoke.py's kernels line: launch key → the instantiation whose
    figures its entry carries, in the order of PERF.md's kernel table."""
    line = sorted((s for s in _KERNELS.values() if s.replaces is not None),
                  key=lambda s: min(s.perf_rows))
    return {s.launch: s for s in line}


def ensure_populated() -> None:
    """Import the modules that register kernels, shapes and programs.

    Import-light callers (the CLI, tests, chip_smoke.py) call this once
    before reading the registry; the imports are no-ops when already
    loaded."""
    from ..ops import cuda_codec  # noqa: F401
    from ..ops import cuda_final_exp  # noqa: F401
    from ..ops import cuda_fp  # noqa: F401
    from ..ops import cuda_g2  # noqa: F401
    from ..ops import cuda_h2c  # noqa: F401
    from ..ops import cuda_pairing  # noqa: F401
    from ..tbls import backend_cuda  # noqa: F401
