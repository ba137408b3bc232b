"""Off-loop pipelined device dispatch — the layer between the core services
and the tbls backends.

A copy of the JAX package's stdlib-only pipeline (tbls/dispatch.py),
trimmed to the combine and verify paths and the boot prewarm (no metrics
registries, stage histograms or environment knobs) and wired to this
package's `api`.  A device
launch must never run on the asyncio event loop: a multi-hundred-ms
combine would freeze every timer and duty hand-off for its duration.  The
process owns ONE `DispatchPipeline`, a two-stage executor pair:

    caller (event loop)              host-prep thread     launch thread
    await pipeline.threshold_combine ─▶ bytes→limbs packing ─▶ device kernels
    await pipeline.batch_verify         Lagrange digits,       + result fetch
                                        cache lookups, RLC r

Both stages are single-thread executors, which makes the pipeline a
double buffer: while the launch thread executes batch *k*, the prep
thread packs batch *k+1*.  A verify larger than `VERIFY_TILE` entries is
split into tiles that run through the same two stages, so host prep of
tile *i+1* overlaps device execution of tile *i*.  The split entry points
come from `tbls.api.verify_stages` / `combine_stages`.
"""

from __future__ import annotations

import asyncio
import threading
from concurrent.futures import ThreadPoolExecutor

#: verify entries per pipelined tile (the JAX package's default
#: CHARON_TPU_DISPATCH_TILE: its headline 2,048-entry verify bucket)
VERIFY_TILE = 2048


def tile_sizes(n: int, tile: int) -> list[int]:
    """The tile sizes an n-entry verify (n > 0) splits into at `tile`."""
    return [min(tile, n - i) for i in range(0, n, tile)]


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
        #: coalesced calls completed (one per combine or verify flush) and
        #: device-stage runs (one per tile); loops in several threads may
        #: share the pipeline, hence the lock
        self.launches = 0
        self.tiles = 0
        self._lock = threading.Lock()
        #: the report of the last `prewarm`
        self.prewarmed: dict | None = None

    async def _pipelined(self, stages, payloads) -> list:
        """Run each payload through (prep, exec); prep of payload i+1
        overlaps the exec of payload i.  Results in submission order; the
        first stage exception is raised after every submitted exec has
        finished."""
        prep_fn, exec_fn = stages
        loop = asyncio.get_running_loop()
        futs = []
        prep_exc: BaseException | None = None
        try:
            for payload in payloads:
                try:
                    prepared = await loop.run_in_executor(
                        self._prep_pool, prep_fn, payload)
                except BaseException as exc:  # noqa: BLE001 — re-raised
                    prep_exc = exc
                    break
                futs.append(loop.run_in_executor(self._launch_pool, exec_fn,
                                                 prepared))
            results = await asyncio.gather(*futs, return_exceptions=True)
        finally:
            with self._lock:
                self.launches += bool(futs)
                self.tiles += len(futs)
        if prep_exc is not None:
            raise prep_exc
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return list(results)

    def plan_verify(self, n: int) -> list[int]:
        """The tile sizes an n-entry verify runs as."""
        return tile_sizes(n, VERIFY_TILE)

    async def batch_verify(self, entries) -> list:
        """`tbls.batch_verify` off-loop, tiled into pipelined
        sub-launches of at most `VERIFY_TILE` entries."""
        from . import api

        if not entries:
            return []
        payloads, pos = [], 0
        for size in self.plan_verify(len(entries)):
            payloads.append(entries[pos:pos + size])
            pos += size
        per_tile = await self._pipelined(api.verify_stages(), payloads)
        return [ok for part in per_tile for ok in part]

    async def threshold_combine(self, batch) -> list:
        """`tbls.threshold_combine` off-loop: host packing on the prep
        thread, the device work on the launch thread."""
        from . import api

        if not batch:
            return []
        [out] = await self._pipelined(api.combine_stages(), [batch])
        return out

    async def prewarm(self, pubshares, num_validators: int,
                      threshold: int) -> dict:
        """`tbls.prewarm` at boot, on a short-lived thread of its own — not
        the launch pool, where seconds of prewarm queued on the single
        launch thread would hold the first duties' launches behind it.
        The backend's locks order what it shares with the launches."""
        from . import api

        loop = asyncio.get_running_loop()
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="charon-cuda-prewarm")
        try:
            report = await loop.run_in_executor(
                pool, api.prewarm, pubshares, num_validators, threshold)
        finally:
            pool.shutdown(wait=False)
        self.prewarmed = report
        return report

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
