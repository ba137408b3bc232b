"""Duty tracing — deterministic cross-cluster trace IDs + span-wrapped
wire edges.

Mirrors reference core/tracing.go:34-142 + app/tracer/trace.go:40-151:
every duty derives a DETERMINISTIC 128-bit trace ID from (slot, type), so
when all n nodes export their spans, one cross-cluster trace joins them
without any coordination.  Every core wire edge is wrapped in a span via
the `with_tracing` wire option (composable with with_async_retry, like the
reference's WithTracing).

Spans are collected in a bounded ring (exporters are pluggable sinks);
the monitoring registry gets per-edge latency histograms for free, plus a
``charon_tpu_tracer_dropped_spans_total`` counter for ring evictions.

A copy of the JAX package's app/tracing.py, whole.  The OTLP/JSON file
and HTTP exporters (`app/otlp.py`) and `/debug/spans` wait for the
serving slice; here a sink is any callable.  The device-boundary spans
of the port are named for the device, not the TPU: ``cuda/batch_verify``
and ``cuda/threshold_combine`` (README lists each rename).
"""

from __future__ import annotations

import contextvars
import hashlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..core.types import Duty

_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "charon_tpu_torch_span", default=None)


def duty_trace_id(duty: Duty) -> str:
    """Deterministic 128-bit trace ID shared by all nodes for a duty
    (reference: core/tracing.go:34-51 fnv128(duty))."""
    h = hashlib.sha256(f"duty/{duty.slot}/{int(duty.type)}".encode())
    return h.hexdigest()[:32]


@dataclass
class Span:
    trace_id: str
    span_id: str
    name: str
    parent_id: str | None
    start: float
    end: float | None = None
    attrs: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return (self.end or time.time()) - self.start


class Tracer:
    """Span collector with a bounded ring buffer and pluggable sinks.

    The ring (`max_spans` most recent) serves `/debug/spans` and
    in-process assertions; export happens at span END via sinks, so a
    full ring never loses exports — only the in-memory view rolls over.
    Each eviction increments `dropped` (exported to the registry as
    ``charon_tpu_tracer_dropped_spans_total``), replacing the old
    silent drop-newest-forever behaviour.

    Spans start and end on the prep/launch/prewarm threads (the
    `device_span` hooks) as well as the event loop, so the ring, the
    sequence counter and the drop/sink-error counters are cross-thread
    state: `_lock` guards them (declared in the analysis
    `SharedStateSpec` registry and enforced by the lock-discipline
    pass).  Registry calls happen OUTSIDE the lock — the Registry has
    its own lock and nesting them would put a Tracer→Registry edge in
    the static lock-order graph for no benefit."""

    def __init__(self, registry=None, max_spans: int = 16384):
        self.spans: deque[Span] = deque(maxlen=max_spans)
        self._registry = registry
        self._max = max_spans
        self._seq = 0
        self._lock = threading.Lock()
        self._sinks: list = []
        self.dropped = 0
        self.sink_errors = 0

    def add_sink(self, fn) -> None:
        """fn(span) called at span end (exporter hook)."""
        self._sinks.append(fn)

    def start_span(self, name: str, trace_id: str | None = None,
                   **attrs) -> "SpanHandle":
        parent: Span | None = _current_span.get()
        with self._lock:
            if trace_id is None:
                trace_id = (parent.trace_id if parent is not None
                            else hashlib.sha256(
                                f"root{self._seq}".encode()).hexdigest()[:32])
            self._seq += 1
            span = Span(trace_id=trace_id,
                        span_id=f"{self._seq:016x}",
                        name=name,
                        parent_id=(parent.span_id if parent is not None
                                   else None),
                        start=time.time(), attrs=dict(attrs))
            evicting = len(self.spans) == self._max
            if evicting:
                # deque(maxlen) evicts the oldest span on append
                self.dropped += 1
            self.spans.append(span)
        if evicting and self._registry is not None:
            self._registry.inc("charon_tpu_tracer_dropped_spans_total")
        return SpanHandle(self, span)

    def _finish(self, span: Span) -> None:
        span.end = time.time()
        # A failing exporter (full disk, missing trace dir, dead
        # collector) is a telemetry problem, never a duty problem: the
        # span-wrapped operation — a verify launch, a combine, a wire
        # edge — must not inherit the exception.  Count + log once.
        try:
            if self._registry is not None:
                self._registry.observe("app_span_duration_seconds",
                                       span.duration,
                                       labels={"span": span.name})
        except Exception:
            self._note_sink_error()
        for fn in self._sinks:
            try:
                fn(span)
            except Exception:
                self._note_sink_error()

    def _note_sink_error(self) -> None:
        with self._lock:
            self.sink_errors += 1
            first = self.sink_errors == 1
        if first:
            import logging

            logging.getLogger(__name__).exception(
                "span export sink raised (counted, not re-raised; "
                "further sink errors are logged at this counter only)")

    def end_span(self, span: Span, **attrs) -> None:
        """Finish a span that was started WITHOUT entering its context
        manager — long-lived instance spans (a QBFT consensus instance
        spans its whole lifetime) are ended from another task/callback,
        where ``with`` scoping cannot apply."""
        span.attrs.update(attrs)
        self._finish(span)

    def trace(self, trace_id: str) -> list[Span]:
        return [s for s in self.spans if s.trace_id == trace_id]


class SpanHandle:
    def __init__(self, tracer: Tracer, span: Span):
        self._tracer = tracer
        self.span = span
        self._token = None

    def __enter__(self) -> Span:
        self._token = _current_span.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        _current_span.reset(self._token)
        if exc is not None:
            self.span.attrs["error"] = repr(exc)
        self._tracer._finish(self.span)


# Process-global tracer hook for spans emitted below the app layer (a
# tbls backend's decompress-cache misses): the backend is a process
# singleton, so its spans cannot belong to any one node's tracer — the
# last app to install wins, which is exact for production (one node per
# process) and an accepted approximation for in-process multi-node tests.
_global_tracer: Tracer | None = None


def set_global_tracer(tracer: Tracer | None) -> None:
    global _global_tracer
    _global_tracer = tracer


def global_tracer() -> Tracer | None:
    return _global_tracer


class _NoopHandle:
    """Context manager stand-in when no global tracer is installed."""

    def __enter__(self) -> Span:
        return Span(trace_id="", span_id="", name="", parent_id=None,
                    start=time.time())

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


def device_span(name: str, **attrs):
    """Span on the process-global tracer, or a no-op without one —
    the device-boundary instrumentation hook for modules below app/."""
    t = _global_tracer
    if t is None:
        return _NoopHandle()
    return t.start_span(name, **attrs)


def with_tracing(tracer: Tracer):
    """Wire option: span-wrap every duty-carrying core edge
    (reference: core/tracing.go:64-142 WithTracing wraps each wire edge in
    a span whose trace ID is the duty's deterministic ID)."""

    _EDGES = ["fetcher_fetch", "consensus_propose", "dutydb_store",
              "parsigdb_store_internal", "parsigdb_store_external",
              "parsigex_broadcast", "sigagg_aggregate", "aggsigdb_store",
              "broadcaster_broadcast"]

    def option(w: dict) -> None:
        def wrap(name: str, fn):
            async def traced(duty, *args):
                with tracer.start_span(f"core/{name}",
                                       trace_id=duty_trace_id(duty),
                                       duty=str(duty)):
                    return await fn(duty, *args)

            return traced

        for edge in _EDGES:
            w[edge] = wrap(edge, w[edge])

    return option
