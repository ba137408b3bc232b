"""Structured logging: console/logfmt/JSON encoders with context-carried
fields and topics.

Mirrors reference app/log/ (zap-based structured logging with
context-carried fields, log.go:44-148; config.go:88-141 for encoder
selection) including the Loki push client (app/log/loki/client.go:49-190):
:class:`LokiSink` ships every structured record to a Loki
``/loki/api/v1/push`` endpoint with the same discipline as the OTLP
span exporter — bounded queue, batched async POSTs, drops and send
failures COUNTED, never raised into the logging caller.  Configured via
``CHARON_TPU_LOKI_ENDPOINT`` (``{node}`` expands to the node name).

A copy of the JAX package's app/log.py; its loggers hang under
``charon_tpu_torch`` (the port's package), and a record's topic is its
logger name without that prefix, as the JAX one strips ``charon_tpu``.
"""

from __future__ import annotations

import contextvars
import json
import logging
import sys
import time
from typing import Any

from . import otlp

_ctx_fields: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "log_fields", default={})

_sinks: list = []  # external record sinks (LokiSink et al.)

#: the logger every record of this package hangs under
_ROOT = "charon_tpu_torch"


def with_ctx(**fields) -> contextvars.Token:
    """Attach fields to the current context (reference: log.WithCtx)."""
    merged = {**_ctx_fields.get(), **fields}
    return _ctx_fields.set(merged)


def reset_ctx(token: contextvars.Token) -> None:
    _ctx_fields.reset(token)


def add_sink(fn) -> None:
    """fn(record_dict) — e.g. a LokiSink."""
    _sinks.append(fn)


def remove_sink(fn) -> None:
    """Detach a sink installed with add_sink (app shutdown)."""
    if fn in _sinks:
        _sinks.remove(fn)


class LokiSink(otlp.BoundedAsyncHTTPExporter):
    """Loki push client (reference: app/log/loki/client.go:49-190).

    Installed with :func:`add_sink`; every formatted record is enqueued
    synchronously and a background task batches them into
    ``POST /loki/api/v1/push`` JSON documents::

        {"streams": [{"stream": {<labels>}, "values": [["<ns>", <line>]]}]}

    The queue is BOUNDED: when full, records are dropped and counted
    (``dropped`` + ``app_loki_dropped_records_total`` on the registry) —
    and a dead/slow Loki only ever increments ``send_failures``; logging
    callers never see an exception (same discipline as
    ``otlp.AsyncHTTPSink``, the reference client's WaitGroup+channel
    pattern)."""

    def __init__(self, endpoint: str, labels: dict | None = None,
                 registry=None, max_queue: int = 4096,
                 batch_size: int = 256, flush_interval: float = 0.5,
                 timeout: float = 5.0):
        super().__init__(endpoint, registry=registry, max_queue=max_queue,
                         batch_size=batch_size, flush_interval=flush_interval,
                         timeout=timeout, default_port=3100,
                         default_path="/loki/api/v1/push", kind="Loki")
        self._labels = {str(k): str(v) for k, v in (labels or {}).items()}

    def _encode_batch(self, batch: list) -> bytes:
        values = []
        for rec in batch:
            ts = rec.get("ts", time.time())
            values.append([str(int(float(ts) * 1e9)),
                           json.dumps(rec, sort_keys=True, default=str)])
        return json.dumps({"streams": [{
            "stream": self._labels, "values": values}]}).encode()

    def _count_drop(self) -> None:
        self.dropped += 1
        if self._registry is not None:
            self._registry.inc("app_loki_dropped_records_total")


def loki_sink_from_env(node_name: str = "", labels: dict | None = None,
                       registry=None, environ=None) -> LokiSink | None:
    """Build a LokiSink from the ``CHARON_TPU_LOKI_*`` env vars:

    - ``CHARON_TPU_LOKI_ENDPOINT``  push URL, e.g.
      ``http://loki:3100/loki/api/v1/push``; ``{node}`` expands to the
      node name so one shared config serves every node.
    - ``CHARON_TPU_LOKI_QUEUE``     queue bound (default 4096).
    - ``CHARON_TPU_LOKI_FLUSH``     flush interval seconds (default 0.5).

    Returns None when no endpoint is configured.  The stream labels are
    the caller's `labels` plus ``node`` (the reporting node's identity,
    same convention as the metrics registry const label)."""
    import os

    env = environ if environ is not None else os.environ
    endpoint = env.get("CHARON_TPU_LOKI_ENDPOINT", "")
    if not endpoint:
        return None
    stream = dict(labels or {})
    if node_name:
        stream.setdefault("node", node_name)
    return LokiSink(
        endpoint.replace("{node}", node_name), labels=stream,
        registry=registry,
        max_queue=int(env.get("CHARON_TPU_LOKI_QUEUE", "4096")),
        flush_interval=float(env.get("CHARON_TPU_LOKI_FLUSH", "0.5")))


class _Formatter(logging.Formatter):
    def __init__(self, fmt_kind: str = "console"):
        super().__init__()
        self.kind = fmt_kind

    def format(self, record: logging.LogRecord) -> str:
        fields = {**_ctx_fields.get(),
                  **getattr(record, "fields", {})}
        base = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "topic": record.name.removeprefix(_ROOT + "."),
            "msg": record.getMessage(),
            **fields,
        }
        for sink in _sinks:
            try:
                sink(base)
            except Exception:
                pass
        if self.kind == "json":
            return json.dumps(base, sort_keys=True, default=str)
        if self.kind == "logfmt":
            return " ".join(f"{k}={v}" for k, v in base.items())
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        extras = " ".join(f"{k}={v}" for k, v in fields.items())
        return (f"{ts} {record.levelname[:4]} {base['topic']:<12} "
                f"{record.getMessage()}" + (f" [{extras}]" if extras else ""))


def init(format: str = "console", level: str = "info") -> None:
    """reference: log/config.go InitLogger."""
    root = logging.getLogger(_ROOT)
    root.setLevel(getattr(logging, level.upper()))
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_Formatter(format))
    root.handlers = [handler]


def get(topic: str) -> logging.Logger:
    return logging.getLogger(f"{_ROOT}.{topic}")


def info(topic: str, msg: str, **fields) -> None:
    get(topic).info(msg, extra={"fields": fields})


def warn(topic: str, msg: str, **fields) -> None:
    get(topic).warning(msg, extra={"fields": fields})


def error(topic: str, msg: str, **fields) -> None:
    get(topic).error(msg, extra={"fields": fields})
