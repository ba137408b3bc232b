"""Monitoring: the metrics registry (Prometheus text format), readiness,
and the device and loop probes behind the node's `/metrics`.

Mirrors reference app/monitoringapi.go:48-176 (a metrics registry with
cluster-identity labels, app/promauto wrapping; readiness = quorum of
peers reachable AND beacon node synced): fixed-bucket histograms
(``_bucket{le=...}``/``_sum``/``_count``), counters and gauges, rendered
as Prometheus text format 0.0.4.

A copy of the registry half of the JAX package's app/monitoring.py:
`Registry` (with its lock) and `render`, `set_readiness`,
`export_devcache_metrics`, `export_dispatch_metrics` and
`loop_lag_probe`.  Counterparts, not copies:

- the device-memory sampler reads ``torch.cuda.memory_allocated`` of the
  backend's device into the same ``charon_tpu_hbm_live_bytes`` gauge; a
  read that fails on the card is counted in
  ``charon_tpu_hbm_sample_errors_total`` and never written as 0 (the
  JAX sampler's fall-back to summing ``jax.live_arrays`` has no
  counterpart);
- the XLA compile gauges become the port's own: ``app_cuda_build_seconds``
  (the nvcc build, `ops/build.py`) and ``app_cuda_graphs_total`` (the
  resident route's captured verify graphs; each capture's seconds are the
  ``app_cuda_graph_capture_seconds`` histogram, `tbls/dispatch`); beside
  them, each kernel's launches in this process
  (``app_cuda_kernel_launches_total{kernel}``, the wrappers' counts).

`MonitoringAPI` serves ``/metrics``, ``/livez``, ``/readyz``, ``/enr``,
``/debug/qbft``, ``/debug/spans`` (the tracer's recent span ring as one
OTLP/JSON export request, `app/otlp.py`), ``/debug/memory`` and
``/debug/profile?seconds=N`` over the port's HTTP/1.1 server
(`app/http1.py`); ``/debug/memory`` reads ``torch.cuda``'s memory stats
and the backend's cache stats where the JAX package reads
``jax.live_arrays``.  ``/debug/profile`` captures a `torch.profiler`
trace (CPU activity, and CUDA activity where the process has a card: the
kernels every thread of the process launches, the `ctypes` library's
included) where the JAX package captures a ``jax.profiler`` trace, on
a worker thread where the JAX package holds the loop, and sends its
directory back as a gzipped tarball; a capture that fails or holds no
event is a 500, never an empty 200.  The process-global
profiler guard (`profile_guard_acquire` / `profile_guard_release`) is
shared with the SLO-triggered auto-profiler (`app/autoprofile.py`).
"""

from __future__ import annotations

import asyncio
import io
import json
import os
import shutil
import sys
import tarfile
import tempfile
import threading
import time
from collections import defaultdict, deque
from typing import Callable

from .http1 import HTTPServer, Response

#: Default histogram bounds (seconds-scale latency): per-metric overrides
#: via Registry.set_buckets.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


class _Hist:
    """One histogram series: fixed cumulative buckets + sum + count.
    O(1) memory per series regardless of sample volume (the previous
    implementation appended every sample to a list forever)."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple):
        self.bounds = bounds
        self.counts = [0] * len(bounds)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, le in enumerate(self.bounds):
            if value <= le:
                self.counts[i] += 1  # per-bin; render accumulates
                break

    def cumulative(self) -> list:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


class Registry:
    """Minimal Prometheus-style registry: counters + gauges + fixed-bucket
    histograms with cluster-identity constant labels.

    Writes and the render snapshot run under one internal lock: since
    the dispatch stage/compile instrumentation landed, series are
    written from the event loop, the launch thread (compile timers) and
    read from whichever thread serves the scrape — an unlocked
    ``defaultdict`` += or a dict resized mid-render is a lost sample or
    a RuntimeError at exactly the moment an operator is looking."""

    def __init__(self, const_labels: dict | None = None):
        self.const_labels = dict(const_labels or {})
        self._counters: dict[tuple, float] = defaultdict(float)
        self._gauges: dict[tuple, float] = {}
        self._hist: dict[tuple, _Hist] = {}
        self._buckets: dict[str, tuple] = {}
        self._lock = threading.RLock()

    def _key(self, name: str, labels: dict | None) -> tuple:
        merged = {**self.const_labels, **(labels or {})}
        return (name, tuple(sorted(merged.items())))

    def inc(self, name: str, value: float = 1.0,
            labels: dict | None = None) -> None:
        with self._lock:
            self._counters[self._key(name, labels)] += value

    def set_gauge(self, name: str, value: float,
                  labels: dict | None = None) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def set_buckets(self, name: str, bounds) -> None:
        """Per-metric bucket config; applies to series created after the
        call (configure at wiring time, before the first observe)."""
        with self._lock:
            self._buckets[name] = tuple(sorted(float(b) for b in bounds))

    def observe(self, name: str, value: float,
                labels: dict | None = None) -> None:
        with self._lock:
            key = self._key(name, labels)
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = _Hist(
                    self._buckets.get(name, DEFAULT_BUCKETS))
            h.observe(value)

    def render(self) -> str:
        lines = []
        with self._lock:
            for (name, labels), v in sorted(self._counters.items()):
                lines.append(f"{name}{_fmt_labels(labels)} {v}")
            for (name, labels), v in sorted(self._gauges.items()):
                lines.append(f"{name}{_fmt_labels(labels)} {v}")
            typed = set()
            for (name, labels), h in sorted(self._hist.items()):
                if name not in typed:
                    typed.add(name)
                    lines.append(f"# TYPE {name} histogram")
                for le, acc in zip(h.bounds, h.cumulative()):
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels + (('le', _fmt_le(le)),))} "
                        f"{acc}")
                lines.append(
                    f"{name}_bucket"
                    f"{_fmt_labels(labels + (('le', '+Inf'),))} {h.count}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} {h.sum}")
                lines.append(f"{name}_count{_fmt_labels(labels)} {h.count}")
        return "\n".join(lines) + "\n"


def _fmt_le(bound: float) -> str:
    """Prometheus renders integral bounds without the trailing .0."""
    return str(int(bound)) if float(bound).is_integer() else repr(bound)


def _escape_label(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
    return "{" + inner + "}"


#: Prometheus text-format 0.0.4 content type — what real scrapers
#: negotiate for (reference: promhttp's Content-Type).
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4"

#: Readiness reason enum (reference: app/monitoringapi.go readyz error
#: taxonomy).  Exactly one ``app_readiness{reason}`` series is 1 at any
#: time, so "why is this node not ready" is answerable from /metrics
#: alone — not just from a /readyz probe body.
READINESS_REASONS = ("ok", "bn_down", "syncing", "mesh_degraded")


def set_readiness(registry: "Registry", reason: str) -> None:
    """Export the readiness enum gauge: 1 for the active reason, 0 for
    the rest (unknown reasons map to the closest enum slot's 0s plus
    themselves, keeping the family bounded to the enum + at most one
    extra)."""
    for r in READINESS_REASONS:
        registry.set_gauge("app_readiness", 1.0 if r == reason else 0.0,
                           labels={"reason": r})
    if reason not in READINESS_REASONS:
        registry.set_gauge("app_readiness", 1.0, labels={"reason": reason})



def _active_backend():
    """The tbls backend now set, if the api module is loaded and the
    backend exists — never creates one (a /metrics scrape must not build
    kernels or claim a card as a side effect)."""
    api = sys.modules.get("charon_tpu_torch.tbls.api")
    if api is None:
        return None
    return api._BACKENDS.get(api._current_name)


def _host_cache_stats(be) -> dict:
    """The cuda backend's host LRUs in the devcache stats schema."""
    if not hasattr(be, "pk_cache_hits"):
        return {}
    return {
        "pk": {"rows": len(be._pk_cache), "capacity_rows": be.PK_CACHE_MAX,
               "hits": be.pk_cache_hits, "misses": be.pk_cache_misses,
               "evictions": be.pk_cache_evictions},
        "hm": {"rows": len(be._hm_cache), "capacity_rows": be.HM_CACHE_MAX,
               "hits": be.hm_cache_hits, "misses": be.hm_cache_misses,
               "evictions": be.hm_cache_evictions},
    }


def export_devcache_metrics(registry: "Registry") -> None:
    """Export the verify caches' gauges (``charon_tpu_devcache_*``) from
    the active backend's `devcache_stats()` — the resident route's device
    stores when they exist, else the bytes route's host LRUs, in one
    schema.  Refreshed at every scrape, like readiness.  No-op until a
    backend with caches is set."""
    be = _active_backend()
    if be is None or not hasattr(be, "devcache_stats"):
        return
    stats = be.devcache_stats()
    registry.set_gauge("charon_tpu_devcache_resident",
                       1.0 if stats.get("enabled") else 0.0)
    host = _host_cache_stats(be)
    # rolling hit ratio: Δhits / (Δhits + Δmisses) between scrapes —
    # cumulative ratios flatten a sudden thrash into noise; the scrape
    # delta is the live signal the DevCacheThrashing alert wants.  Prev
    # snapshots live on the registry so per-node scrape cadences never
    # interfere.
    prev = registry.__dict__.setdefault("_devcache_prev", {})
    for cache in ("pk", "hm"):
        # one uniform schema whichever residency serves: the device
        # store when it exists, else the host LRU twin
        s = stats.get(cache) or host.get(cache)
        if not s:
            continue
        labels = {"cache": cache}
        registry.set_gauge("charon_tpu_devcache_rows", s["rows"],
                           labels=labels)
        registry.set_gauge("charon_tpu_devcache_capacity_rows",
                           s["capacity_rows"], labels=labels)
        registry.set_gauge("charon_tpu_devcache_bytes",
                           s.get("bytes", 0), labels=labels)
        registry.set_gauge("charon_tpu_devcache_hits_total", s["hits"],
                           labels=labels)
        registry.set_gauge("charon_tpu_devcache_misses_total",
                           s["misses"], labels=labels)
        registry.set_gauge("charon_tpu_devcache_evictions_total",
                           s["evictions"], labels=labels)
        p_hits, p_misses = prev.get(cache, (0, 0))
        d_hits = max(0, s["hits"] - p_hits)
        d_misses = max(0, s["misses"] - p_misses)
        prev[cache] = (s["hits"], s["misses"])
        if d_hits + d_misses:
            ratio = d_hits / (d_hits + d_misses)
        elif s["hits"] + s["misses"]:
            # idle window: fall back to the cumulative ratio rather
            # than flapping the gauge to 0
            ratio = s["hits"] / (s["hits"] + s["misses"])
        else:
            ratio = 0.0
        registry.set_gauge("charon_tpu_devcache_hit_ratio", ratio,
                           labels=labels)


def export_dispatch_metrics(registry: "Registry") -> None:
    """Refresh the build and dispatch gauges at every scrape
    (export_devcache_metrics twin): the nvcc build's seconds in this
    process (``app_cuda_build_seconds``, 0 when the library was already
    built; absent before the first build), the resident route's captured
    verify graphs (``app_cuda_graphs_total``, always served), and the
    process pipeline's cumulative device-stage runs and verify rows."""
    from ..ops import launch_count

    build = sys.modules.get("charon_tpu_torch.ops.build")
    if build is not None and "build_seconds" in build.INFO:
        registry.set_gauge("app_cuda_build_seconds",
                           build.INFO["build_seconds"])
    be = sys.modules.get("charon_tpu_torch.tbls.backend_cuda")
    registry.set_gauge("app_cuda_graphs_total",
                       len(be.resident_graph_keys()) if be is not None
                       else 0)
    dsp = sys.modules.get("charon_tpu_torch.tbls.dispatch")
    pipe = dsp.current_pipeline() if dsp is not None else None
    if pipe is not None:
        # the JAX pipeline's `launches` counts device-stage runs: the
        # port's `tiles`
        registry.set_gauge("core_dispatch_launches_total", pipe.tiles)
        registry.set_gauge("core_dispatch_verify_rows_total",
                           pipe.verify_rows)
    # each kernel's launches in this process, from its wrapper module's
    # counts (a node process's own: another process's never land here)
    for name, n in launch_count.process_launches().items():
        registry.set_gauge("app_cuda_kernel_launches_total", n,
                           labels={"kernel": name})


#: Device-memory sampling cadence (seconds).  The gauge answers the
#: HBMGrowth alert: a leak (tensors pinned by a stale reference, an
#: unbounded device store) shows as monotone growth across samples.
HBM_SAMPLE_INTERVAL = 10.0


def _backend_device():
    """The active backend's device, or None (no backend, or one without
    a device: the pure-Python oracle, the insecure-test scheme's)."""
    be = _active_backend()
    return getattr(be, "device", None) if be is not None else None


def sample_hbm_live_bytes(registry: "Registry", device=None) -> int | None:
    """One sample of the bytes the caching allocator holds for tensors on
    `device` (default: the active backend's) → the
    ``charon_tpu_hbm_live_bytes`` gauge.  A device that is not a card (a
    backend run on the CPU, or none) has no device memory: nothing is
    written and None returned.  A read that fails on the card is counted
    in ``charon_tpu_hbm_sample_errors_total`` and re-raised — never
    written as 0."""
    import torch

    dev = device if device is not None else _backend_device()
    if dev is None or torch.device(dev).type != "cuda":
        return None
    try:
        nbytes = int(torch.cuda.memory_allocated(dev))
    except Exception:
        registry.inc("charon_tpu_hbm_sample_errors_total")
        raise
    registry.set_gauge("charon_tpu_hbm_live_bytes", nbytes)
    return nbytes


async def hbm_sample_loop(registry: "Registry",
                          interval: float = HBM_SAMPLE_INTERVAL,
                          device=None) -> None:
    """Lifecycle background task: sample device-resident bytes into
    ``charon_tpu_hbm_live_bytes`` every `interval` seconds (first sample
    immediately, so short-lived simnet nodes serve the gauge too).  A
    failed read is counted (see `sample_hbm_live_bytes`) and the loop
    goes on.  Runs until cancelled."""
    while True:
        try:
            await asyncio.to_thread(sample_hbm_live_bytes, registry, device)
        except Exception:  # noqa: BLE001 — counted in the sampler
            import logging

            logging.getLogger(__name__).exception(
                "device memory sample failed")
        await asyncio.sleep(interval)


#: Loop-lag probe buckets: the 12 s slot budget makes 1 ms–1 s the band
#: that matters; the alerting threshold (p99 < 50 ms, the dispatch
#: pipeline's acceptance bar) needs resolution around 10–100 ms.
LOOP_LAG_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5)


#: Loop-lag SLO: the dispatch pipeline's acceptance bar (p99 < 50 ms).
LOOP_LAG_SLO_SECONDS = 0.05

#: Rolling lag samples the breach detector evaluates p99 over — at the
#: 50 ms probe interval this is a ~13 s window; breach evaluation needs
#: at least LOOP_LAG_MIN_SAMPLES so one cold tick cannot page.
LOOP_LAG_WINDOW = 256
LOOP_LAG_MIN_SAMPLES = 20


async def loop_lag_probe(registry: "Registry", interval: float = 0.05,
                         dispatcher=None,
                         lag_slo: float = LOOP_LAG_SLO_SECONDS,
                         on_breach: Callable[[str], None] | None = None,
                         ) -> None:
    """Self-timing event-loop health probe: sleep `interval`, measure how
    late the wake-up lands, and export the excess as the
    ``app_event_loop_lag_seconds`` histogram — the witness for the
    off-loop dispatch pipeline (an inline multi-hundred-ms device launch
    shows up here as a multi-hundred-ms lag sample).  When a
    `tbls.dispatch.DispatchPipeline` is passed, its launch backlog is
    exported as the ``app_dispatch_queue_depth`` gauge and its rolling
    launch-busy fraction as ``core_dispatch_overlap_efficiency`` on
    every tick.

    SLO breach hook: when the p99 over the rolling sample window
    exceeds `lag_slo`, `on_breach("loop_lag")` fires once per breached
    tick.  Runs until cancelled."""
    registry.set_buckets("app_event_loop_lag_seconds", LOOP_LAG_BUCKETS)
    loop = asyncio.get_running_loop()
    lags: deque = deque(maxlen=LOOP_LAG_WINDOW)
    while True:
        t0 = loop.time()
        await asyncio.sleep(interval)
        lag = max(0.0, loop.time() - t0 - interval)
        registry.observe("app_event_loop_lag_seconds", lag)
        lags.append(lag)
        if dispatcher is not None:
            registry.set_gauge("app_dispatch_queue_depth",
                               dispatcher.queue_depth)
            registry.set_gauge("core_dispatch_overlap_efficiency",
                               dispatcher.overlap_efficiency())
        if on_breach is not None and len(lags) >= LOOP_LAG_MIN_SAMPLES:
            p99 = sorted(lags)[int(0.99 * (len(lags) - 1))]
            if p99 > lag_slo:
                try:
                    on_breach("loop_lag")
                except Exception:  # noqa: BLE001 — probe must not die
                    pass


PROFILE_MAX_SECONDS = 30.0

#: profiler state is PROCESS-global, so the in-flight guard must be too:
#: with several in-process nodes (simnet), concurrent /debug/profile
#: requests to different nodes' APIs still race one profiler.  The
#: SLO-triggered auto-profiler (app/autoprofile.py) shares THIS guard
#: through acquire/release, so a watchdog capture and a manual
#: /debug/profile can never double-start the profiler.
_PROFILE_ACTIVE = False
_PROFILE_GUARD_LOCK = threading.Lock()

#: the trace file a capture writes into its directory
PROFILE_TRACE_FILE = "trace.json"


def profile_guard_acquire() -> bool:
    """Claim the process-global profiler; False = a capture is already
    running (callers must skip, not queue — profiler state is
    process-wide)."""
    global _PROFILE_ACTIVE
    with _PROFILE_GUARD_LOCK:
        if _PROFILE_ACTIVE:
            return False
        _PROFILE_ACTIVE = True
        return True


def profile_guard_release() -> None:
    global _PROFILE_ACTIVE
    with _PROFILE_GUARD_LOCK:
        _PROFILE_ACTIVE = False


def profile_guard_held() -> bool:
    """Whether a capture holds the process-global profiler."""
    with _PROFILE_GUARD_LOCK:
        return _PROFILE_ACTIVE


def _export_trace(prof, path: str) -> int:
    """Write the capture as a Chrome trace; its event count (0 = an
    empty capture)."""
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    return len(events)


def profile_capture_sync(out_dir: str, seconds: float) -> dict:
    """The capture itself, blocking: a `torch.profiler` trace of CPU
    activity (this thread's operators), and of CUDA activity where the
    process has a card (every kernel the process launches, from any
    thread), over `seconds`, written to `out_dir`/trace.json.  Start,
    stop and export run on the calling thread, as the profiler's
    thread-local state requires → the seconds each took and the trace's
    event count.  Raises when the capture fails or holds no event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    t0 = time.perf_counter()
    prof.start()
    t1 = time.perf_counter()
    try:
        time.sleep(seconds)
        # a token device op so an idle node still yields a non-empty
        # capture (and the device's rows appear)
        token = torch.arange(128, dtype=torch.int32,
                             device="cuda" if on_card else "cpu") + 1
        if on_card:
            torch.cuda.synchronize(token.device)
    finally:
        t2 = time.perf_counter()
        prof.stop()
    t3 = time.perf_counter()
    n = _export_trace(prof, os.path.join(out_dir, PROFILE_TRACE_FILE))
    if n == 0:
        raise RuntimeError("the profiler captured no event")
    return {"start_s": t1 - t0, "stop_s": t3 - t2,
            "export_s": time.perf_counter() - t3, "events": n}


async def run_profile_capture(out_dir: str, seconds: float) -> dict:
    """ONE copy of the capture protocol — shared by the /debug/profile
    handler and the SLO auto-profiler (app/autoprofile.py), so the
    duration and the token device op cannot drift between the two
    surfaces.  The whole capture (`profile_capture_sync`) runs on a
    worker thread: its triggers fire when the loop is already late, and
    nothing of the profiler may ride that loop.  → its phase timings.
    Caller owns the profiler guard and the output directory."""
    return await asyncio.to_thread(profile_capture_sync, out_dir, seconds)


# ---------------------------------------------------------------------------
# The monitoring HTTP API
# ---------------------------------------------------------------------------

class MonitoringAPI:
    """Serves /metrics, /livez, /readyz, /enr and the /debug endpoints
    (reference: app/monitoringapi.go:48-176, :84-88 pprof)."""

    def __init__(self, registry: Registry,
                 readyz: Callable[[], tuple[bool, str]],
                 identity: str = "", qbft_debug: Callable[[], bytes] = None,
                 tracer=None, memory_extra: Callable[[], dict] = None):
        self.registry = registry
        self._readyz = readyz
        self._identity = identity
        self._qbft_debug = qbft_debug  # app.qbftdebug ring renderer
        self._tracer = tracer          # app.tracing.Tracer (/debug/spans)
        self._memory_extra = memory_extra  # app-specific /debug/memory dict
        self._http = HTTPServer()
        for path, fn in (("/metrics", self._metrics),
                         ("/livez", self._livez), ("/readyz", self._ready),
                         ("/enr", self._enr), ("/debug/qbft", self._qbft),
                         ("/debug/spans", self._spans),
                         ("/debug/memory", self._memory),
                         ("/debug/profile", self._profile)):
            self._http.add_get(path, fn)
        self.port: int | None = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> None:
        await self._http.start(host, port)
        self.port = self._http.port

    async def stop(self) -> None:
        await self._http.stop()

    async def _metrics(self, request):
        # refresh readiness on every scrape, not only on /readyz probes:
        # the app's readyz hook exports the app_readiness enum gauge as a
        # side effect, and a node scraped without an external prober must
        # still show CURRENT readiness at /metrics
        for refresh in (self._readyz,
                        lambda: export_devcache_metrics(self.registry),
                        lambda: export_dispatch_metrics(self.registry)):
            try:
                refresh()
            except Exception:  # noqa: BLE001 — scrape must not 500
                pass
        return Response(200, self.registry.render().encode(),
                        METRICS_CONTENT_TYPE)

    async def _livez(self, request):
        return Response(200, b"ok")

    async def _ready(self, request):
        # the body always carries the reason string ("ok" when ready) so a
        # probe log line is self-explanatory without /metrics
        ok, reason = self._readyz()
        return Response(200 if ok else 503, reason.encode())

    async def _enr(self, request):
        return Response(200, self._identity.encode())

    async def _qbft(self, request):
        if self._qbft_debug is None:
            return Response(404, b"404: Not Found")
        # reference: app/qbftdebug.go:35-122 sniffed-instance dump
        return Response(200, self._qbft_debug(), "application/json")

    async def _spans(self, request):
        if self._tracer is None:
            return Response(404, b"404: Not Found")
        return Response(200, self.render_spans(), "application/json")

    def render_spans(self) -> bytes:
        """The recent span ring as one OTLP/JSON export request."""
        from . import otlp

        spans = [s for s in self._tracer.spans if s.end is not None]
        doc = otlp.export_request(spans, resource_attrs={
            **self.registry.const_labels,
            "dropped_spans": self._tracer.dropped})
        return json.dumps(doc).encode()

    async def _profile(self, request):
        """Capture a `torch.profiler` trace for ?seconds=N (default 1,
        capped) and send the capture directory back as a gzipped
        tarball; 409 while another capture runs, 500 when the capture
        fails or is empty."""
        try:
            seconds = float(request.query.get("seconds", "1"))
        except ValueError:
            return Response(400, b"seconds must be a number")
        seconds = min(max(seconds, 0.0), PROFILE_MAX_SECONDS)
        if not profile_guard_acquire():
            return Response(409, b"a profile capture is already running")
        tmp = None
        try:
            # INSIDE the guard's try: a failing mkdtemp (full /tmp,
            # unwritable TMPDIR) must still release the process-global
            # guard, or manual AND SLO-triggered profiling stay dead
            # until restart
            tmp = tempfile.mkdtemp(prefix="charon-tpu-profile-")
            await run_profile_capture(tmp, seconds)
            body = await asyncio.to_thread(_tarball, tmp)
            return Response(200, body, "application/octet-stream")
        except Exception as exc:  # noqa: BLE001 — debug must not crash node
            return Response(500, f"profile capture failed: "
                            f"{type(exc).__name__}: {exc}".encode())
        finally:
            profile_guard_release()
            if tmp is not None:
                await asyncio.to_thread(shutil.rmtree, tmp,
                                        ignore_errors=True)

    async def _memory(self, request):
        return Response(200, self.render_memory(), "application/json")

    def render_memory(self) -> bytes:
        """Device and cache stats: the backend device's
        ``torch.cuda.memory_stats`` (allocated, reserved and peak bytes),
        the verify caches' `devcache_stats` (device stores, or the host
        LRUs on the bytes route), the captured verify graphs, the dispatch
        pipeline's per-stage seconds, and the app's own rows."""
        info: dict = {}
        dev = _backend_device()
        if dev is not None:
            try:
                import torch

                d = torch.device(dev)
                info["device"] = str(d)
                if d.type == "cuda":
                    st = torch.cuda.memory_stats(d)
                    info["memory_stats"] = {
                        k: st.get(k, 0) for k in (
                            "allocated_bytes.all.current",
                            "allocated_bytes.all.peak",
                            "reserved_bytes.all.current",
                            "num_alloc_retries", "num_ooms")}
            except Exception as exc:  # noqa: BLE001 — debug must not 500
                info["error"] = f"{type(exc).__name__}: {exc}"
        be = _active_backend()
        if be is not None and hasattr(be, "devcache_stats"):
            info["devcache"] = be.devcache_stats()
            info["host_caches"] = _host_cache_stats(be)
        cuda_be = sys.modules.get("charon_tpu_torch.tbls.backend_cuda")
        if cuda_be is not None:
            info["resident_graph_keys"] = [
                str(k) for k in cuda_be.resident_graph_keys()]
        dsp = sys.modules.get("charon_tpu_torch.tbls.dispatch")
        pipe = dsp.current_pipeline() if dsp is not None else None
        if pipe is not None:
            info["dispatch"] = pipe.stage_stats()
            info["dispatch"]["prewarmed"] = pipe.prewarmed
        if self._tracer is not None:
            info["tracer"] = {"spans_buffered": len(self._tracer.spans),
                              "dropped_spans": self._tracer.dropped}
        if self._memory_extra is not None:
            try:
                info.update(self._memory_extra())
            except Exception as exc:  # noqa: BLE001 — debug must not 500
                info["extra_error"] = f"{type(exc).__name__}: {exc}"
        return json.dumps(info, indent=1, default=str).encode()


def _tarball(path: str) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        tar.add(path, arcname="profile")
    return buf.getvalue()
