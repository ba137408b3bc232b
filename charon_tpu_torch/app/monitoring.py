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
  ``app_cuda_graph_capture_seconds`` histogram, `tbls/dispatch`).

`MonitoringAPI` (the HTTP endpoints), the profile capture and the OTLP
exporters (`app/otlp.py`) wait for the serving slice.
"""

from __future__ import annotations

import asyncio
import sys
import threading
from collections import defaultdict, deque
from typing import Callable

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
