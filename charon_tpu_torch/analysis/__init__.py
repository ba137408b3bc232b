"""Kernel contract auditor — static analysis of the port's CUDA kernels
and of its source, the counterpart of the JAX package's analysis/.

The JAX package's auditor was written after TPU code shipped broken on
hardware (a 17.48 MiB scoped-VMEM overflow, a shard_map carry mismatch)
that the CPU tests structurally could not see.  The port's kernels carry
the same kind of figures that no CPU test sees: registers, stack and
spills from the compiler, shared memory a block from the launchers, the
blocks an SM holds, a cooperative launch whose every block must be
resident.  The passes:

1. **Kernel contract** (`kernel_audit`): the wrappers (`ops/cuda_*.py`)
   register every ``__global__`` instantiation with its launch geometry
   and budgets (`registry`); the pass checks each kernel's device code
   (int32 only: no float, no math function, no console, heap or runtime
   call), its launch arithmetic at every workload shape
   `tbls/backend_cuda` registers against `ops/smem_budget`'s model, and
   — given the compiler's ``-Xptxas -v`` log — its registers, stack and
   spill against its budget.  On the card, chip_smoke.py's ``contract``
   phase adds the runtime's own figures (``cudaFuncGetAttributes``, the
   occupancy API) and the residency pass (`residency`): the resident
   verify tile captures as one CUDA graph of K12, K20, K15, K13, K14 and
   K11.
2. **Metric-name lint** (`metrics_lint`) against the port's catalogue,
   docs/observability_torch.md, in both directions.
3. **Lock discipline** (`concurrency`): every lock declares its guarded
   attributes; no read-modify-write of one outside ``with <lock>``; no
   lock-order cycle.  Its runtime twin is `testutil/racecheck`.
4. **Event-loop discipline** (`asyncio_lint`): no blocking call in an
   ``async def``, device entry points behind `tbls.dispatch`'s
   `assert_off_loop` only through the pipeline.
5. **The shard pass** (`shard_audit`), the JAX package's shard-carry
   pass in the port's terms: the sharded combine's split and pad rows,
   and one run in which no shard reads a tensor another shard made nor
   an operand off its own device.

Run it as ``python -m charon_tpu_torch.analysis`` (exit 0 iff every
contract holds; ``--golden-bad <fixture>`` exits non-zero), in
tests/test_torch_analysis.py, in chip_smoke.py's ``contract`` phase, and
with the shard pass on its devices in `multichip.dryrun_multichip` and
chip_smoke.py's ``multichip`` phase.

This package's ``__init__`` stays import-light on purpose: the wrapper
modules import `analysis.registry` at import time to register their
kernels, so importing the passes here would be circular.
"""

from __future__ import annotations

from . import registry  # noqa: F401  (the import-light registration API)


def run_audit(*args, **kwargs):
    """Lazy forwarder to :func:`charon_tpu_torch.analysis.audit.run_audit`."""
    from .audit import run_audit as _run

    return _run(*args, **kwargs)
