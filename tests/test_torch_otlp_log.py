"""The port's OTLP span export (`charon_tpu_torch.app.otlp`), its
structured log with the Loki sink (`app.log`) and `/debug/spans` held
against the JAX package's: the same spans give the same OTLP/JSON lines,
export requests and `/debug/spans` documents, the same log records the
same Loki push bodies and formatted lines, and `parse_export` round-trips
what both write.  Pure asyncio, no device work."""

import asyncio
import json
import logging
import urllib.request

import pytest
import torch

torch.set_num_threads(1)

from charon_tpu.app import log as j_log  # noqa: E402
from charon_tpu.app import monitoring as j_monitoring  # noqa: E402
from charon_tpu.app import otlp as j_otlp  # noqa: E402
from charon_tpu.app import tracing as j_tracing  # noqa: E402
from charon_tpu_torch.app import log as t_log  # noqa: E402
from charon_tpu_torch.app import monitoring as t_monitoring  # noqa: E402
from charon_tpu_torch.app import otlp as t_otlp  # noqa: E402
from charon_tpu_torch.app import tracing as t_tracing  # noqa: E402

PKGS = {"jax": (j_otlp, j_tracing, j_log, j_monitoring),
        "port": (t_otlp, t_tracing, t_log, t_monitoring)}


def spans(tracing_mod) -> list:
    """A fixed set of finished spans: a parent and children with every
    attribute type the OTLP mapping carries."""
    out = [tracing_mod.Span(trace_id="ab" * 16, span_id=f"{1:016x}",
                            name="core/fetcher_fetch", parent_id=None,
                            start=1700000000.125, end=1700000000.5,
                            attrs={"duty": "7/attester"})]
    for i in range(2, 6):
        out.append(tracing_mod.Span(
            trace_id="ab" * 16 if i < 4 else "cd" * 16,
            span_id=f"{i:016x}", name=f"cuda/verify_{i}",
            parent_id=f"{1:016x}" if i < 4 else None,
            start=1700000000.25 + i, end=1700000000.75 + i,
            attrs={"ok": i % 2 == 0, "rows": i * 1024, "ms": i / 3,
                   "path": "bytes+res", "none": None}))
    return out


def test_export_request_and_round_trip():
    docs = {k: m[0].export_request(spans(m[1]), {"service.name": "charon_tpu",
                                                 "peer": "node0", "n": 3})
            for k, m in PKGS.items()}
    assert json.dumps(docs["port"]) == json.dumps(docs["jax"])
    for k, (otlp, _, _, _) in PKGS.items():
        back = t_otlp.parse_export(json.loads(json.dumps(docs[k])))
        want = spans(t_tracing)
        assert [(s.trace_id, s.span_id, s.name, s.parent_id)
                for s in back] == [(s.trace_id, s.span_id, s.name,
                                    s.parent_id) for s in want]
        assert [s.start for s in back] == pytest.approx(
            [s.start for s in want], abs=1e-6)
        assert back[1].attrs == {"ok": True, "rows": 2048,
                                 "ms": pytest.approx(2 / 3),
                                 "path": "bytes+res", "none": "None"}


def test_file_sink_writes_the_same_lines(tmp_path):
    text = {}
    for k, (otlp, tracing, _, _) in PKGS.items():
        path = str(tmp_path / f"{k}.jsonl")
        sink = otlp.FileSink(path, resource_attrs={"peer": "node1"},
                             batch_size=2)
        tr = tracing.Tracer()
        tr.add_sink(sink)
        for sp in spans(tracing):
            sink(sp)
        assert sink.exported == 4       # two batches flushed
        sink.close()
        assert sink.exported == 5
        text[k] = open(path).read()
    assert text["port"] == text["jax"]
    assert len(text["port"].splitlines()) == 3
    assert [s.name for s in t_otlp.parse_export_lines(text["jax"])] == [
        s.name for s in spans(t_tracing)]


def test_async_http_sink_posts_the_same_documents():
    """Batched OTLP/HTTP POSTs: the same export requests reach a collector
    from either package; a full queue drops and counts, and the final
    drain still exports what is queued."""

    async def main(otlp, tracing, monitoring):
        received = []

        async def handle(reader, writer):
            await reader.readline()
            clen = 0
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                if line.lower().startswith(b"content-length"):
                    clen = int(line.split(b":")[1])
            received.append(json.loads(await reader.readexactly(clen)))
            writer.write(b"HTTP/1.0 200 OK\r\nContent-Length: 0\r\n\r\n")
            await writer.drain()
            writer.close()

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            sink = otlp.AsyncHTTPSink(
                f"http://127.0.0.1:{port}/v1/traces",
                resource_attrs={"peer": "n0"}, flush_interval=60.0)
            for sp in spans(tracing):
                sink(sp)
            await sink.aclose()
            reg = monitoring.Registry()
            slow = otlp.AsyncHTTPSink(
                f"http://127.0.0.1:{port}/v1/traces", registry=reg,
                max_queue=2, flush_interval=60.0)
            for sp in spans(tracing):
                slow(sp)
            counts = (slow.dropped, len(slow._queue),
                      reg._counters[("app_otlp_dropped_spans_total", ())])
            await slow.aclose()
            return (received, sink.exported, sink.send_failures, counts,
                    slow.exported)
        finally:
            server.close()

    got = {k: asyncio.run(main(m[0], m[1], m[3])) for k, m in PKGS.items()}
    assert json.dumps(got["port"]) == json.dumps(got["jax"])
    received, exported, failures, counts, slow_exported = got["port"]
    assert exported == 5 and failures == 0
    assert counts == (3, 2, 3) and slow_exported == 2
    assert len(t_otlp.parse_export(received[0])) == 5


def test_sinks_from_env(tmp_path):
    env = {"CHARON_TPU_TRACE_FILE": str(tmp_path / "{node}.jsonl"),
           "CHARON_TPU_TRACE_ENDPOINT": "http://127.0.0.1:9/v1/traces",
           "CHARON_TPU_TRACE_QUEUE": "7", "CHARON_TPU_TRACE_FLUSH": "0.25"}
    out = {}
    for k, (otlp, _, _, _) in PKGS.items():
        sinks = otlp.sinks_from_env(node_name="node3", environ=env)
        out[k] = [(type(s).__name__, getattr(s, "path", None),
                   getattr(s, "_max_queue", None),
                   getattr(s, "_flush_interval", None),
                   getattr(s, "_host", None), getattr(s, "_path", None))
                  for s in sinks]
        assert otlp.sinks_from_env(environ={}) == []
        with pytest.raises(ValueError):
            otlp.AsyncHTTPSink("grpc://nope")
    assert out["port"] == out["jax"]
    assert out["port"][0][1].endswith("node3.jsonl")
    assert out["port"][1][2] == 7


async def _capture_server(received):
    async def handle(reader, writer):
        await reader.readline()
        clen = 0
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            if line.lower().startswith(b"content-length"):
                clen = int(line.split(b":")[1])
        received.append(await reader.readexactly(clen))
        writer.write(b"HTTP/1.0 204 No Content\r\nContent-Length: 0\r\n\r\n")
        await writer.drain()
        writer.close()

    return await asyncio.start_server(handle, "127.0.0.1", 0)


def test_loki_push_bodies_equal():
    """The same records give byte-equal Loki push bodies; a full queue
    drops and counts the same; a dead endpoint is counted, not raised."""

    async def main(log, monitoring):
        received = []
        server = await _capture_server(received)
        port = server.sockets[0].getsockname()[1]
        try:
            sink = log.LokiSink(f"http://127.0.0.1:{port}/loki/api/v1/push",
                                labels={"node": "node0", "cluster": "t"},
                                flush_interval=60.0, batch_size=2)
            for i in range(3):
                sink({"ts": 1000.0 + i, "level": "info", "topic": "bcast",
                      "msg": f"m{i}", "slot": i, "ok": i == 1})
            await sink.aclose()
        finally:
            server.close()
        reg = monitoring.Registry()
        dead = log.LokiSink("http://127.0.0.1:9/loki/api/v1/push",
                            registry=reg, max_queue=2, flush_interval=60.0)
        for i in range(5):
            dead({"ts": float(i), "msg": f"m{i}"})
        counts = (dead.dropped, len(dead._queue),
                  reg._counters[("app_loki_dropped_records_total", ())])
        await dead.aclose()
        return (received, sink.exported, counts, dead.send_failures >= 1,
                dead.exported)

    got = {k: asyncio.run(main(m[2], m[3])) for k, m in PKGS.items()}
    assert got["port"] == got["jax"]
    received, exported, counts, failed, dead_exported = got["port"]
    assert exported == 3 and len(received) == 2
    doc = json.loads(received[0])
    assert doc["streams"][0]["stream"] == {"node": "node0", "cluster": "t"}
    ns, line = doc["streams"][0]["values"][0]
    assert ns == str(int(1000.0 * 1e9)) and json.loads(line)["msg"] == "m0"
    assert counts == (3, 2, 3) and failed and dead_exported == 0


def test_loki_sink_from_env_and_formatted_lines():
    env = {"CHARON_TPU_LOKI_ENDPOINT":
           "http://loki.{node}.svc:3100/loki/api/v1/push",
           "CHARON_TPU_LOKI_QUEUE": "9"}
    sinks = {k: m[2].loki_sink_from_env(node_name="node2", environ=env,
                                        labels={"cluster_name": "c"})
             for k, m in PKGS.items()}
    for k, s in sinks.items():
        assert (s._host, s._port, s._path, s._max_queue, s._labels) == (
            "loki.node2.svc", 3100, "/loki/api/v1/push", 9,
            {"cluster_name": "c", "node": "node2"}), k
        assert PKGS[k][2].loki_sink_from_env(environ={}) is None
    # the same record formats to the same line (the topic is the logger's
    # name under each package's root), and reaches the installed sinks
    lines = {}
    for k, (_, _, log, _) in PKGS.items():
        seen = []
        log.add_sink(seen.append)
        try:
            root = "charon_tpu" if k == "jax" else "charon_tpu_torch"
            rec = logging.LogRecord(f"{root}.bcast", logging.WARNING, "f", 1,
                                    "duty late", None, None)
            rec.created = 1700000000.0
            rec.fields = {"slot": 13, "ok": False}
            lines[k] = [log._Formatter(kind).format(rec)
                        for kind in ("json", "logfmt")]
        finally:
            log.remove_sink(seen.append)
        assert seen and seen[0]["topic"] == "bcast"
        assert log.get("bcast").name == f"{root}.bcast"
    assert lines["port"] == lines["jax"]
    assert json.loads(lines["port"][0])["msg"] == "duty late"


def test_debug_spans_serves_the_same_document():
    """`/debug/spans` of both packages' MonitoringAPI over tracers that
    hold the same finished spans (and one open, left out): one OTLP/JSON
    export request, equal, that `parse_export` reads back."""

    def serve(monitoring, tracing):
        reg = monitoring.Registry(const_labels={"node": "node0",
                                                "cluster_hash": "ab12"})
        tr = tracing.Tracer(reg)
        for sp in spans(tracing):
            tr.spans.append(sp)
        tr.spans.append(tracing.Span(trace_id="ef" * 16, span_id="f" * 16,
                                     name="open", parent_id=None,
                                     start=1.0))

        async def main():
            api = monitoring.MonitoringAPI(reg, readyz=lambda: (True, "ok"),
                                           tracer=tr)
            await api.start()
            try:
                def get():
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{api.port}/debug/spans",
                            timeout=10) as resp:
                        return resp.status, resp.read()
                return await asyncio.to_thread(get)
            finally:
                await api.stop()

        return asyncio.run(main())

    j = serve(j_monitoring, j_tracing)
    t = serve(t_monitoring, t_tracing)
    assert t[0] == j[0] == 200
    assert json.loads(t[1]) == json.loads(j[1])
    back = t_otlp.parse_export(json.loads(t[1]))
    assert [s.name for s in back] == [s.name for s in spans(t_tracing)]
    res = json.loads(t[1])["resourceSpans"][0]["resource"]["attributes"]
    assert {a["key"] for a in res} == {"node", "cluster_hash",
                                       "dropped_spans"}
