"""OTLP/JSON trace export — the sinks behind `app.tracing.Tracer`.

Mirrors reference app/tracer/trace.go:40-151: the tracer there builds an
OTel SDK pipeline with pluggable exporters (stdout JSON file, OTLP/gRPC);
here the same roles are filled stdlib-only:

- :class:`FileSink` — appends OTLP/JSON ``ExportTraceServiceRequest``
  documents (one per line, JSONL) to a file.  Because every node derives
  the SAME deterministic trace ID for a duty (`tracing.duty_trace_id`),
  concatenating the n nodes' files and grouping by ``traceId`` joins one
  cross-cluster trace per duty with zero coordination.
- :class:`AsyncHTTPSink` — batched OTLP/HTTP(JSON) POSTs to a collector
  endpoint (e.g. ``http://otel:4318/v1/traces``) over plain asyncio.
  The queue is BOUNDED: when full, new spans are counted in
  ``dropped`` (exported as ``app_otlp_dropped_spans_total``) instead of
  growing memory — a slow collector can never wedge the duty pipeline.

The encoding follows the OTLP/JSON mapping (trace/span IDs as lowercase
hex strings, times as unix-nano strings, typed attribute values), and
:func:`parse_export` round-trips it back into `tracing.Span` objects so
tests — and the `/debug/spans` endpoint's consumers — can verify exports
with the same code.

A copy of the JAX package's app/otlp.py (stdlib only there too), with the
same scope name, so both packages write the same documents.
"""

from __future__ import annotations

import asyncio
import json
import logging
import urllib.parse
from collections import deque

from .tracing import Span

_log = logging.getLogger(__name__)

SCOPE_NAME = "charon_tpu"


# ---------------------------------------------------------------------------
# OTLP/JSON encoding
# ---------------------------------------------------------------------------

def _attr_value(v) -> dict:
    """One OTLP AnyValue (the JSON mapping types we emit)."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _attr_decode(value: dict):
    if "boolValue" in value:
        return bool(value["boolValue"])
    if "intValue" in value:
        return int(value["intValue"])
    if "doubleValue" in value:
        return float(value["doubleValue"])
    return value.get("stringValue", "")


def span_to_otlp(span: Span) -> dict:
    """One OTLP/JSON Span object."""
    out = {
        "traceId": span.trace_id,
        "spanId": span.span_id,
        "name": span.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(int(span.start * 1e9)),
        "endTimeUnixNano": str(int((span.end or span.start) * 1e9)),
        "attributes": [{"key": str(k), "value": _attr_value(v)}
                       for k, v in span.attrs.items()],
    }
    if span.parent_id:
        out["parentSpanId"] = span.parent_id
    return out


def export_request(spans, resource_attrs: dict | None = None) -> dict:
    """A full OTLP/JSON ``ExportTraceServiceRequest`` document."""
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": str(k), "value": _attr_value(v)}
            for k, v in (resource_attrs or {}).items()]},
        "scopeSpans": [{
            "scope": {"name": SCOPE_NAME},
            "spans": [span_to_otlp(s) for s in spans],
        }],
    }]}


def parse_export(doc: dict) -> list[Span]:
    """Decode an OTLP/JSON export request back into `tracing.Span`s —
    the round-trip oracle used by tests and `/debug/spans` consumers."""
    out: list[Span] = []
    for rs in doc.get("resourceSpans", []):
        for ss in rs.get("scopeSpans", []):
            for s in ss.get("spans", []):
                out.append(Span(
                    trace_id=s["traceId"],
                    span_id=s["spanId"],
                    name=s["name"],
                    parent_id=s.get("parentSpanId"),
                    start=int(s["startTimeUnixNano"]) / 1e9,
                    end=int(s["endTimeUnixNano"]) / 1e9,
                    attrs={a["key"]: _attr_decode(a["value"])
                           for a in s.get("attributes", [])}))
    return out


def parse_export_lines(text: str) -> list[Span]:
    """Decode a FileSink JSONL file (one export request per line)."""
    out: list[Span] = []
    for line in text.splitlines():
        line = line.strip()
        if line:
            out.extend(parse_export(json.loads(line)))
    return out


# ---------------------------------------------------------------------------
# Sinks (tracer hooks: fn(span) called at span end)
# ---------------------------------------------------------------------------

class FileSink:
    """Append OTLP/JSON export requests to a file, one JSON document per
    line.  Spans are batched (`batch_size`) to keep the write syscall off
    the per-span path; `flush()`/`close()` drain the remainder."""

    def __init__(self, path: str, resource_attrs: dict | None = None,
                 batch_size: int = 64):
        self.path = path
        self._resource = dict(resource_attrs or {})
        self._batch_size = max(1, batch_size)
        self._buf: list[Span] = []
        self.exported = 0

    def __call__(self, span: Span) -> None:
        self._buf.append(span)
        if len(self._buf) >= self._batch_size:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        batch, self._buf = self._buf, []
        with open(self.path, "a") as f:
            f.write(json.dumps(export_request(batch, self._resource)) + "\n")
        self.exported += len(batch)

    def close(self) -> None:
        self.flush()


class BoundedAsyncHTTPExporter:
    """Shared push-exporter discipline: synchronous enqueue into a BOUNDED
    queue, a lazily-started background flush task, batched HTTP/1.0 JSON
    POSTs, and failures counted — never raised into the instrumented
    operation.  `AsyncHTTPSink` (OTLP spans) and `app.log.LokiSink` (log
    records) are the two instances of this discipline.

    Subclasses implement `_encode_batch(batch) -> bytes` and
    `_count_drop()` (the latter so the drop-counter metric name stays a
    literal at its call site for the metrics lint).
    """

    def __init__(self, endpoint: str, registry=None, max_queue: int = 4096,
                 batch_size: int = 512, flush_interval: float = 0.5,
                 timeout: float = 5.0, default_port: int = 4318,
                 default_path: str = "/v1/traces", kind: str = "export"):
        u = urllib.parse.urlsplit(endpoint)
        if u.scheme != "http" or not u.hostname:
            raise ValueError(
                f"{kind} endpoint must be an http:// URL, got {endpoint!r}")
        self._host = u.hostname
        self._port = u.port or default_port
        self._path = u.path or default_path
        self._kind = kind
        self._registry = registry
        self._max_queue = max_queue
        self._batch_size = max(1, batch_size)
        self._flush_interval = flush_interval
        self._timeout = timeout
        self._queue: deque = deque()
        self._task: asyncio.Task | None = None
        self._closed = False
        self.dropped = 0
        self.exported = 0
        self.send_failures = 0

    def _encode_batch(self, batch: list) -> bytes:
        raise NotImplementedError

    def _count_drop(self) -> None:
        self.dropped += 1

    def __call__(self, item) -> None:
        if len(self._queue) >= self._max_queue:
            self._count_drop()
            return
        self._queue.append(item)
        if self._task is None and not self._closed:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return  # no loop: items accumulate until one exists
            self._task = loop.create_task(self._flush_loop())

    async def _flush_loop(self) -> None:
        while not self._closed:
            await asyncio.sleep(self._flush_interval)
            await self._flush_once()

    async def _flush_once(self) -> None:
        while self._queue:
            batch = [self._queue.popleft()
                     for _ in range(min(self._batch_size, len(self._queue)))]
            body = self._encode_batch(batch)
            try:
                await asyncio.wait_for(self._post(body), self._timeout)
                self.exported += len(batch)
            except Exception as exc:  # noqa: BLE001 — exporter must not raise
                self.send_failures += 1
                if self.send_failures == 1:
                    _log.warning("%s push to %s:%s%s failed: %s", self._kind,
                                 self._host, self._port, self._path, exc)

    async def _post(self, body: bytes) -> None:
        reader, writer = await asyncio.open_connection(self._host, self._port)
        try:
            writer.write(
                f"POST {self._path} HTTP/1.0\r\n"
                f"Host: {self._host}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            await writer.drain()
            status = await reader.readline()
            parts = status.decode(errors="replace").split()
            if len(parts) < 2 or not parts[1].startswith("2"):
                raise RuntimeError(f"collector answered {status!r}")
        finally:
            writer.close()

    async def aclose(self) -> None:
        """Final drain: stop the loop task and flush what is queued."""
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        await self._flush_once()


class AsyncHTTPSink(BoundedAsyncHTTPExporter):
    """Batched async OTLP/HTTP(JSON) exporter with a BOUNDED queue.

    Spans are enqueued synchronously at span end; a background task
    drains the queue every `flush_interval` seconds and POSTs one export
    request per batch.  When the queue is full the span is dropped and
    counted (`dropped`, plus ``app_otlp_dropped_spans_total`` on the
    registry if one is wired) — backpressure from a slow collector must
    never block the duty pipeline.  A failed POST drops that batch too
    (counted in `send_failures`); there is deliberately no retry queue.
    """

    def __init__(self, endpoint: str, resource_attrs: dict | None = None,
                 registry=None, max_queue: int = 4096,
                 batch_size: int = 512, flush_interval: float = 0.5,
                 timeout: float = 5.0):
        super().__init__(endpoint, registry=registry, max_queue=max_queue,
                         batch_size=batch_size, flush_interval=flush_interval,
                         timeout=timeout, default_port=4318,
                         default_path="/v1/traces", kind="OTLP")
        self._resource = dict(resource_attrs or {})

    def _encode_batch(self, batch: list) -> bytes:
        return json.dumps(export_request(batch, self._resource)).encode()

    def _count_drop(self) -> None:
        self.dropped += 1
        if self._registry is not None:
            self._registry.inc("app_otlp_dropped_spans_total")


# ---------------------------------------------------------------------------
# Environment-driven configuration (CHARON_TPU_TRACE_*)
# ---------------------------------------------------------------------------

def sinks_from_env(resource_attrs: dict | None = None, registry=None,
                   node_name: str = "", environ=None) -> list:
    """Build export sinks from the ``CHARON_TPU_TRACE_*`` env vars:

    - ``CHARON_TPU_TRACE_FILE``      OTLP JSONL path; ``{node}`` expands
      to the node name so one shared config serves every node.
    - ``CHARON_TPU_TRACE_ENDPOINT``  OTLP/HTTP collector URL
      (``http://host:4318/v1/traces``).
    - ``CHARON_TPU_TRACE_QUEUE``     AsyncHTTPSink bound (default 4096).
    - ``CHARON_TPU_TRACE_FLUSH``     AsyncHTTPSink flush interval seconds
      (default 0.5).
    """
    import os

    env = environ if environ is not None else os.environ
    sinks = []
    path = env.get("CHARON_TPU_TRACE_FILE", "")
    if path:
        sinks.append(FileSink(path.replace("{node}", node_name),
                              resource_attrs=resource_attrs))
    endpoint = env.get("CHARON_TPU_TRACE_ENDPOINT", "")
    if endpoint:
        sinks.append(AsyncHTTPSink(
            endpoint, resource_attrs=resource_attrs, registry=registry,
            max_queue=int(env.get("CHARON_TPU_TRACE_QUEUE", "4096")),
            flush_interval=float(env.get("CHARON_TPU_TRACE_FLUSH", "0.5"))))
    return sinks
