"""Off-loop pipelined device dispatch — the layer between the core services
and the tbls backends.

A copy of the JAX package's stdlib-only pipeline (tbls/dispatch.py),
trimmed to the combine path and wired to this package's `api`.  A device
launch must never run on the asyncio event loop: a multi-hundred-ms
combine would freeze every timer and duty hand-off for its duration.  The
process owns ONE `DispatchPipeline`, a two-stage executor pair:

    caller (event loop)              host-prep thread     launch thread
    await pipeline.threshold_combine ─▶ bytes→limbs packing ─▶ device kernels
                                        Lagrange digits        + result fetch

Both stages are single-thread executors, which makes the pipeline a
double buffer: while the launch thread executes combine *k*, the prep
thread packs combine *k+1*.  The split entry points come from
`tbls.api.combine_stages`.
"""

from __future__ import annotations

import asyncio
import threading
from concurrent.futures import ThreadPoolExecutor


def assert_off_loop(op: str) -> None:
    """Raise if a device entry point runs on a thread with a RUNNING event
    loop (i.e. inline in a coroutine)."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return  # executor / plain thread: exactly where launches belong
    raise RuntimeError(
        f"{op} invoked from the event-loop thread — device work must go "
        "through tbls.dispatch.DispatchPipeline so a multi-hundred-ms launch "
        "cannot stall timers and duty hand-offs")


class DispatchPipeline:
    """Two-stage (host-prep → device-launch) executor pipeline.

    Single-thread stages give strict per-stage FIFO ordering while still
    double-buffering."""

    def __init__(self):
        self._prep_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="charon-cuda-host-prep")
        self._launch_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="charon-cuda-launch")
        #: device-stage runs completed (one per coalesced combine); loops
        #: in several threads may share the pipeline, hence the lock
        self.launches = 0
        self._lock = threading.Lock()

    async def threshold_combine(self, batch) -> list:
        """`tbls.threshold_combine` off-loop: host packing on the prep
        thread, the device work on the launch thread."""
        from . import api

        if not batch:
            return []
        prep_fn, exec_fn = api.combine_stages()
        loop = asyncio.get_running_loop()
        prepared = await loop.run_in_executor(self._prep_pool, prep_fn, batch)
        try:
            return await loop.run_in_executor(self._launch_pool, exec_fn,
                                              prepared)
        finally:
            with self._lock:
                self.launches += 1

    def shutdown(self) -> None:
        self._prep_pool.shutdown(wait=True)
        self._launch_pool.shutdown(wait=True)


_default: DispatchPipeline | None = None


def default_pipeline() -> DispatchPipeline:
    """The process-wide pipeline (lazily created)."""
    global _default
    if _default is None:
        _default = DispatchPipeline()
    return _default


def current_pipeline() -> DispatchPipeline | None:
    """The process-wide pipeline IF it already exists (never creates one)."""
    return _default
