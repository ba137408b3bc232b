"""Off-loop pipelined device dispatch — the layer between the core services
and the tbls backends.

A copy of the JAX package's stdlib-only pipeline (tbls/dispatch.py),
wired to this package's `api`: the combine and verify paths, the boot
prewarm, and the telemetry (the process-global metrics fan-out, the
per-job stages and the overlap gauge).  Left out: the environment knobs
(the tile size, the prewarm switch and the loop guard are fixed here:
`VERIFY_TILE`, prewarm when called, guard always on); the JAX package's
inline mode (``CHARON_TPU_DISPATCH=0``) is the constructor argument
``DispatchPipeline(inline=True)``.  A device
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

An inline pipeline (``inline=True``: the chaos harness's, whose virtual
clock must not move while a flush is in flight) starts no thread: each
payload's prep and then its exec run on the calling thread, in order, and
`prewarm` runs there too.  It keeps the same counters and stage seconds
(its queue waits are zero), and `assert_off_loop` lets a device entry
point through only while one of its stages runs on that thread.

Telemetry: every job is attributed to queue_wait / host_prep /
device_exec / fetch stages (`STAGES`), recorded on the awaiting event
loop (never on the prep or launch thread) into the
``core_dispatch_stage_seconds{stage,op}`` histograms of every registry
registered via :func:`add_metrics_registry` — a process-global fan-out,
exact for one node a process and a shared-series approximation for
in-process multi-node clusters, which share the one pipeline anyway —
folded into cumulative per-(op, stage) seconds (`stage_stats`), and
optionally aggregated into a caller's ``stats`` dict so the
``cuda/batch_verify`` / ``cuda/threshold_combine`` spans carry the same
decomposition.  A verify tile whose device stage captured a CUDA graph
adds that capture's seconds to ``app_cuda_graph_capture_seconds`` (the
port's counterpart of the JAX ``app_xla_compile_seconds``).  A rolling
launch-busy window serves :meth:`DispatchPipeline.overlap_efficiency`.
"""

from __future__ import annotations

import asyncio
import contextlib
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

#: verify entries per pipelined tile (the JAX package's default
#: CHARON_TPU_DISPATCH_TILE: its headline 2,048-entry verify bucket)
VERIFY_TILE = 2048


def tile_sizes(n: int, tile: int) -> list[int]:
    """The tile sizes an n-entry verify (n > 0) splits into at `tile`."""
    return [min(tile, n - i) for i in range(0, n, tile)]


#: per-thread flag: an inline pipeline's stage is running on this thread
_inline_stage = threading.local()


@contextlib.contextmanager
def _inline_stage_running():
    """Mark the body as an inline pipeline's stage on this thread (the one
    place `assert_off_loop` lets a device entry point through on a loop
    thread)."""
    prev = getattr(_inline_stage, "on", False)
    _inline_stage.on = True
    try:
        yield
    finally:
        _inline_stage.on = prev


def assert_off_loop(op: str) -> None:
    """Raise if a device entry point runs on a thread with a RUNNING event
    loop (i.e. inline in a coroutine), unless an inline pipeline's own
    stage is running it."""
    if getattr(_inline_stage, "on", False):
        return
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return  # executor / plain thread: exactly where launches belong
    raise RuntimeError(
        f"{op} invoked from the event-loop thread — device work must go "
        "through tbls.dispatch.DispatchPipeline so a multi-hundred-ms launch "
        "cannot stall timers and duty hand-offs")


# ---------------------------------------------------------------------------
# Process-global metrics fan-out
# ---------------------------------------------------------------------------
#
# The pipeline lives BELOW the app layer, but its per-stage timings belong
# on every node's /metrics.  Node wiring registers monitoring Registries
# here; instrumentation call-sites fan each observation out to all of them
# with LITERAL metric names.  Like the global tracer, this is exact for
# production (one node per process) and an accepted shared-series
# approximation for in-process multi-node clusters (the nodes share the
# one process pipeline anyway).

_metrics_registries: tuple = ()
_metrics_lock = threading.Lock()

#: A first verify at a bucket captures its CUDA graph (one eager run, then
#: the capture: tenths of a second to seconds) — the monitoring default
#: sub-10 s ladder would lose its resolution.  Applied at registration so
#: every registry exports one bucket schema for the family.
GRAPH_CAPTURE_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                         10.0, 30.0)


def add_metrics_registry(registry) -> None:
    """Register a monitoring Registry to receive dispatch observations
    (idempotent)."""
    global _metrics_registries
    try:
        registry.set_buckets("app_cuda_graph_capture_seconds",
                             GRAPH_CAPTURE_BUCKETS)
    except AttributeError:  # duck-typed test registries without buckets
        pass
    with _metrics_lock:
        if registry not in _metrics_registries:
            _metrics_registries = _metrics_registries + (registry,)


def remove_metrics_registry(registry) -> None:
    global _metrics_registries
    with _metrics_lock:
        _metrics_registries = tuple(
            r for r in _metrics_registries if r is not registry)


def metrics_registries() -> tuple:
    """Snapshot of the registered registries (atomic tuple swap, so
    readers never need the lock)."""
    return _metrics_registries


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

#: Per-job pipeline stages, in hand-off order: time waiting in the two
#: executor queues, the host-prep callable, the device stage (kernels +
#: result fetch to host), and the hand-back to the awaiting event loop
#: (future resolution latency — a congested loop shows up HERE, not in
#: device_exec).
STAGES = ("queue_wait", "host_prep", "device_exec", "fetch")

#: Sliding window (seconds) for the live overlap-efficiency gauge.
OVERLAP_WINDOW_S = 60.0


def stage_span_attrs(stats: dict) -> dict:
    """A pipeline ``stats`` aggregate as span attributes: seconds
    rounded for readability, counters (``tiles``) verbatim.  ONE copy —
    both `cuda/batch_verify` and `cuda/threshold_combine` fold through
    here, so the two spans' stage attrs cannot drift."""
    return {k: round(v, 6) if k.endswith("_s") else v
            for k, v in stats.items()}


class DispatchPipeline:
    """Two-stage (host-prep → device-launch) executor pipeline.

    Single-thread stages give strict per-stage FIFO ordering while still
    double-buffering.

    Every shared counter — ``queue_depth`` (loop-thread submit vs
    launch-thread drain), the busy-seconds/stage accumulators (prep
    thread vs launch thread), the rolling launch-busy window and the
    call/tile counts (loops in several threads may share the pipeline) —
    is mutated and snapshotted under ONE ``_lock``.  Per-job stage times
    are written into each job dict by the stage that ran it, and folded
    into the counters and the registries on the awaiting event loop after
    the job completes.

    `inline` runs both stages on the calling thread instead (module
    docstring): no executor, no thread."""

    def __init__(self, inline: bool = False):
        self.inline = bool(inline)
        self._prep_pool = self._launch_pool = None
        if not self.inline:
            self._prep_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="charon-cuda-host-prep")
            self._launch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="charon-cuda-launch")
        self._lock = threading.Lock()
        #: coalesced calls completed (one per combine or verify flush) and
        #: device-stage runs (one per tile)
        self.launches = 0
        self.tiles = 0
        #: device-stage jobs submitted but not yet finished — the
        #: ``app_dispatch_queue_depth`` gauge
        self.queue_depth = 0
        #: cumulative wall seconds per stage thread
        self.prep_busy_s = 0.0
        self.device_busy_s = 0.0
        #: cumulative verify entries submitted
        self.verify_rows = 0
        #: cumulative seconds per (op, stage) — `stage_stats` snapshot of
        #: the same decomposition the histograms serve
        self.stage_seconds: dict[tuple[str, str], float] = {}
        #: rolling (end_ts, busy_s) device-stage samples inside
        #: OVERLAP_WINDOW_S — the live ``core_dispatch_overlap_efficiency``
        #: gauge
        self._busy_window: deque[tuple[float, float]] = deque()
        self._created_at = time.perf_counter()
        #: the report of the last `prewarm`
        self.prewarmed: dict | None = None

    # -- stage plumbing ------------------------------------------------------

    def _run_prep(self, fn, payload, job: dict):
        t0 = time.perf_counter()
        job["prep_wait_s"] = t0 - job["t_submit"]
        try:
            return fn(payload)
        finally:
            dt = time.perf_counter() - t0
            job["host_prep_s"] = dt
            with self._lock:
                self.prep_busy_s += dt

    def _bump_depth(self, delta: int) -> None:
        with self._lock:
            self.queue_depth += delta

    def _run_launch(self, fn, prepared, job: dict):
        t0 = time.perf_counter()
        job["launch_wait_s"] = t0 - job["t_enq_launch"]
        # the backend's stage seconds of THIS call: a fresh `last_stages`
        # dict after the call (a call that launched nothing leaves the
        # previous one in place)
        owner = getattr(fn, "__self__", None)
        before = getattr(owner, "last_stages", None)
        try:
            return fn(prepared)
        finally:
            t1 = time.perf_counter()
            dt = t1 - t0
            job["device_exec_s"] = dt
            job["t_exec_end"] = t1
            after = getattr(owner, "last_stages", None)
            if after is not before and after:
                cap = after.get("graph_capture_s")
                if cap is not None:
                    job["graph_capture_s"] = cap
            with self._lock:
                self.device_busy_s += dt
                self.queue_depth -= 1
                self._busy_window.append((t1, dt))
                self._trim_window_locked(t1)

    def _trim_window_locked(self, now: float) -> None:
        cutoff = now - OVERLAP_WINDOW_S
        while self._busy_window and self._busy_window[0][0] < cutoff:
            self._busy_window.popleft()

    def overlap_efficiency(self) -> float:
        """Launch-thread busy fraction over the sliding window
        (device-busy seconds / wall seconds).  0.0 on an idle pipeline;
        approaching 1.0 means the launch thread never waits on host prep.
        The denominator is the pipeline's LIFETIME while younger than the
        window, so a busy pipeline 10 s after boot reports ~1.0, not
        10/60."""
        now = time.perf_counter()
        with self._lock:
            self._trim_window_locked(now)
            busy = sum(b for _, b in self._busy_window)
        span = max(1e-3, min(OVERLAP_WINDOW_S, now - self._created_at))
        return min(1.0, busy / span)

    async def _finish(self, fut, job: dict):
        """Await one launch future on the loop and stamp the hand-back
        ('fetch') latency: exec-thread completion → loop resumption."""
        try:
            return await fut
        finally:
            end = job.get("t_exec_end")
            if end is not None:
                job["fetch_s"] = time.perf_counter() - end

    def _record_job(self, op: str, job: dict, agg: dict | None) -> None:
        """Fold one finished job's stage timings into the cumulative
        counters, the registered /metrics registries, and the caller's
        span-attr aggregate.  Runs on the awaiting event-loop thread."""
        stages = {
            "queue_wait": (job.get("prep_wait_s", 0.0)
                           + job.get("launch_wait_s", 0.0)),
            "host_prep": job.get("host_prep_s"),
            "device_exec": job.get("device_exec_s"),
            "fetch": job.get("fetch_s"),
        }
        with self._lock:
            for stage, dt in stages.items():
                if dt is None:
                    continue
                key = (op, stage)
                self.stage_seconds[key] = (
                    self.stage_seconds.get(key, 0.0) + dt)
        cap = job.get("graph_capture_s")
        for reg in metrics_registries():
            for stage, dt in stages.items():
                if dt is not None:
                    reg.observe("core_dispatch_stage_seconds", dt,
                                labels={"stage": stage, "op": op})
            if cap is not None:
                reg.observe("app_cuda_graph_capture_seconds", cap)
        if agg is not None:
            for stage, dt in stages.items():
                if dt is not None:
                    agg[stage + "_s"] = agg.get(stage + "_s", 0.0) + dt

    def stage_stats(self) -> dict:
        """Snapshot: cumulative per-(op, stage) seconds, busy totals,
        queue depth, call/tile/row counters and the live overlap gauge."""
        with self._lock:
            stages = {f"{op}/{stage}": round(dt, 6)
                      for (op, stage), dt in sorted(self.stage_seconds.items())}
            snap = {
                "queue_depth": self.queue_depth,
                "prep_busy_s": round(self.prep_busy_s, 6),
                "device_busy_s": round(self.device_busy_s, 6),
                "launches": self.launches,
                "tiles": self.tiles,
                "verify_rows": self.verify_rows,
                "stage_seconds": stages,
            }
        snap["overlap_efficiency"] = round(self.overlap_efficiency(), 4)
        return snap

    async def _pipelined(self, stages, payloads, op: str,
                         stats: dict | None = None) -> list:
        """Run each payload through (prep, exec); prep of payload i+1
        overlaps the exec of payload i.  Results in submission order; the
        first stage exception is raised after every submitted exec has
        finished (a tile failure must not leave orphaned executor jobs
        mutating shared counters)."""
        if self.inline:
            return self._inline_run(stages, payloads, op, stats)
        prep_fn, exec_fn = stages
        loop = asyncio.get_running_loop()
        launch_futs, jobs = [], []
        prep_exc: BaseException | None = None
        try:
            for payload in payloads:
                job = {"t_submit": time.perf_counter()}
                try:
                    prepared = await loop.run_in_executor(
                        self._prep_pool, self._run_prep, prep_fn, payload,
                        job)
                except BaseException as exc:  # noqa: BLE001 — re-raised
                    prep_exc = exc
                    break
                self._bump_depth(+1)
                job["t_enq_launch"] = time.perf_counter()
                fut = loop.run_in_executor(self._launch_pool,
                                           self._run_launch, exec_fn,
                                           prepared, job)
                launch_futs.append(asyncio.ensure_future(
                    self._finish(fut, job)))
                jobs.append(job)
            results = await asyncio.gather(*launch_futs,
                                           return_exceptions=True)
        finally:
            self._count_call(len(launch_futs))
        return self._finish_call(op, jobs, results, prep_exc, stats)

    def _inline_run(self, stages, payloads, op: str,
                    stats: dict | None) -> list:
        """`_pipelined` on the calling thread: each payload's prep, then
        its exec, in order, with the same counters, stage seconds and
        error order."""
        prep_fn, exec_fn = stages
        results, jobs = [], []
        prep_exc: BaseException | None = None
        try:
            for payload in payloads:
                job = {"t_submit": time.perf_counter()}
                try:
                    with _inline_stage_running():
                        prepared = self._run_prep(prep_fn, payload, job)
                except BaseException as exc:  # noqa: BLE001 — re-raised
                    prep_exc = exc
                    break
                self._bump_depth(+1)
                job["t_enq_launch"] = time.perf_counter()
                try:
                    with _inline_stage_running():
                        results.append(self._run_launch(exec_fn, prepared,
                                                        job))
                except BaseException as exc:  # noqa: BLE001 — re-raised
                    results.append(exc)
                job["fetch_s"] = time.perf_counter() - job["t_exec_end"]
                jobs.append(job)
        finally:
            self._count_call(len(jobs))
        return self._finish_call(op, jobs, results, prep_exc, stats)

    def _count_call(self, tiles: int) -> None:
        with self._lock:
            self.launches += bool(tiles)
            self.tiles += tiles

    def _finish_call(self, op: str, jobs: list, results: list,
                     prep_exc: BaseException | None,
                     stats: dict | None) -> list:
        """Record every finished job, then raise the first failure (a
        prep failure before any exec's) or return the results."""
        for job, r in zip(jobs, results):
            if not isinstance(r, BaseException):
                self._record_job(op, job, stats)
        if stats is not None:
            stats["tiles"] = stats.get("tiles", 0) + len(jobs)
        if prep_exc is not None:
            raise prep_exc
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return list(results)

    def plan_verify(self, n: int) -> list[int]:
        """The tile sizes an n-entry verify runs as."""
        return tile_sizes(n, VERIFY_TILE)

    async def batch_verify(self, entries, stats: dict | None = None) -> list:
        """`tbls.batch_verify` off-loop, tiled into pipelined
        sub-launches of at most `VERIFY_TILE` entries.  When a `stats`
        dict is passed, per-stage seconds (summed over tiles) are
        aggregated into it for span attribution."""
        from . import api

        if not entries:
            return []
        with self._lock:
            self.verify_rows += len(entries)
        payloads, pos = [], 0
        for size in self.plan_verify(len(entries)):
            payloads.append(entries[pos:pos + size])
            pos += size
        per_tile = await self._pipelined(api.verify_stages(), payloads,
                                         op="verify", stats=stats)
        return [ok for part in per_tile for ok in part]

    async def threshold_combine(self, batch,
                                stats: dict | None = None) -> list:
        """`tbls.threshold_combine` off-loop: host packing on the prep
        thread, the device work on the launch thread."""
        from . import api

        if not batch:
            return []
        [out] = await self._pipelined(api.combine_stages(), [batch],
                                      op="combine", stats=stats)
        return out

    async def prewarm(self, pubshares, num_validators: int,
                      threshold: int) -> dict:
        """`tbls.prewarm` at boot, on a short-lived thread of its own — not
        the launch pool, where seconds of prewarm queued on the single
        launch thread would hold the first duties' launches behind it.
        The backend's locks order what it shares with the launches.  An
        inline pipeline runs it on the calling thread."""
        from . import api

        if self.inline:
            with _inline_stage_running():
                # the stages of an inline pipeline run on the loop's thread
                # async-ok: by design (module docstring)
                report = api.prewarm(pubshares, num_validators, threshold)
            self.prewarmed = report
            return report
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
        for pool in (self._prep_pool, self._launch_pool):
            if pool is not None:
                pool.shutdown(wait=True)


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
