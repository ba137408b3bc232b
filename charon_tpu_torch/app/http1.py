"""HTTP/1.1 on asyncio streams: a JSON client and a small routed server.

The port's beacon client (`eth2util/beacon_client.py`), HTTP beacon mock
(`testutil/beaconmock_http.py`) and monitoring API (`app/monitoring.py`)
speak HTTP through this module, in place of the JAX package's aiohttp.
It covers what those peers exchange, and interoperates with aiohttp on
both sides:

- `HTTPClient`: GET/POST with query parameters and a JSON body; response
  bodies by Content-Length, chunked transfer coding, or read to EOF on a
  closing connection; keep-alive connections pooled per host, a stale
  pooled connection retried once on a fresh one; a total timeout per
  request.
- `HTTPServer`: routes by method and path pattern (``{name}`` matches one
  path segment into `Request.match_info`); request bodies by
  Content-Length or chunked; keep-alive unless the client asks to close
  or speaks HTTP/1.0; 404 for an unknown path, 405 for a known path
  under another method, 500 when a handler raises.
"""

from __future__ import annotations

import asyncio
import json
import re
import urllib.parse
from dataclasses import dataclass, field
from typing import Awaitable, Callable

MAX_HEADER_LINES = 100
MAX_BODY = 64 * 1024 * 1024

_REASONS = {200: "OK", 202: "Accepted", 204: "No Content",
            400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 409: "Conflict",
            500: "Internal Server Error", 501: "Not Implemented",
            503: "Service Unavailable"}


class HTTPError(OSError):
    """A malformed message or a connection that closed mid-message."""


async def _read_headers(reader: asyncio.StreamReader) -> dict[str, str]:
    headers: dict[str, str] = {}
    for _ in range(MAX_HEADER_LINES):
        line = await reader.readline()
        if not line:
            raise HTTPError("connection closed in the headers")
        if line in (b"\r\n", b"\n"):
            return headers
        name, sep, value = line.decode("latin-1").partition(":")
        if not sep:
            raise HTTPError(f"malformed header line {line[:40]!r}")
        headers[name.strip().lower()] = value.strip()
    raise HTTPError("too many header lines")


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    out = bytearray()
    while True:
        line = await reader.readline()
        if not line:
            raise HTTPError("connection closed in a chunk size")
        size = int(line.split(b";", 1)[0].strip(), 16)
        if size == 0:
            while True:  # trailers
                t = await reader.readline()
                if t in (b"\r\n", b"\n", b""):
                    return bytes(out)
        if len(out) + size > MAX_BODY:
            raise HTTPError("body too large")
        out += await reader.readexactly(size)
        await reader.readexactly(2)


async def _read_body(reader: asyncio.StreamReader, headers: dict,
                     to_eof: bool) -> bytes:
    if "chunked" in headers.get("transfer-encoding", "").lower():
        return await _read_chunked(reader)
    if "content-length" in headers:
        n = int(headers["content-length"])
        if n > MAX_BODY:
            raise HTTPError("body too large")
        return await reader.readexactly(n)
    return await reader.read(MAX_BODY) if to_eof else b""


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

@dataclass
class ClientResponse:
    status: int
    headers: dict
    body: bytes

    def text(self) -> str:
        return self.body.decode("utf-8", errors="replace")

    def json(self):
        return json.loads(self.body)


class HTTPClient:
    """Keep-alive HTTP/1.1 client for JSON APIs."""

    #: idle keep-alive connections kept a host
    POOL_SIZE = 8

    def __init__(self, timeout: float = 10.0):
        self._timeout = timeout
        self._idle: dict[tuple[str, int], list] = {}
        self._closed = False

    async def close(self) -> None:
        self._closed = True
        for conns in self._idle.values():
            for _, writer in conns:
                writer.close()
        self._idle.clear()

    async def get(self, url: str, params: dict | None = None
                  ) -> ClientResponse:
        return await self.request("GET", url, params=params)

    async def post(self, url: str, json_body=None) -> ClientResponse:
        return await self.request("POST", url, json_body=json_body)

    async def request(self, method: str, url: str,
                      params: dict | None = None,
                      json_body=None) -> ClientResponse:
        return await asyncio.wait_for(
            self._request(method, url, params, json_body), self._timeout)

    async def _request(self, method, url, params, json_body):
        u = urllib.parse.urlsplit(url)
        if u.scheme != "http":
            raise ValueError(f"only http:// URLs are supported: {url}")
        host, port = u.hostname or "127.0.0.1", u.port or 80
        target = u.path or "/"
        query = u.query
        if params:
            query = "&".join(q for q in (query, urllib.parse.urlencode(
                params)) if q)
        if query:
            target += "?" + query
        body = b""
        head = [f"{method} {target} HTTP/1.1",
                f"Host: {host}:{port}", "Accept: application/json",
                "Connection: keep-alive"]
        if json_body is not None or method == "POST":
            body = json.dumps(json_body).encode()
            head.append("Content-Type: application/json")
            head.append(f"Content-Length: {len(body)}")
        msg = ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body
        key = (host, port)
        pooled = self._idle.get(key)
        if pooled:
            reader, writer = pooled.pop()
            try:
                return await self._exchange(key, reader, writer, method, msg)
            except (OSError, asyncio.IncompleteReadError):
                writer.close()  # a stale keep-alive: once more, fresh
            except BaseException:
                writer.close()
                raise
        reader, writer = await asyncio.open_connection(host, port)
        try:
            return await self._exchange(key, reader, writer, method, msg)
        except BaseException:
            writer.close()
            raise

    async def _exchange(self, key, reader, writer, method: str,
                        msg: bytes) -> ClientResponse:
        writer.write(msg)
        await writer.drain()
        status_line = await reader.readline()
        if not status_line:
            raise HTTPError("connection closed before the status line")
        parts = status_line.decode("latin-1").split(None, 2)
        if len(parts) < 2 or not parts[0].startswith("HTTP/"):
            raise HTTPError(f"malformed status line {status_line[:40]!r}")
        status = int(parts[1])
        headers = await _read_headers(reader)
        closing = (headers.get("connection", "").lower() == "close"
                   or parts[0] == "HTTP/1.0"
                   and headers.get("connection", "").lower() != "keep-alive")
        if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
            body = b""
        else:
            body = await _read_body(reader, headers, to_eof=closing)
        if closing or self._closed:
            writer.close()
        else:
            idle = self._idle.setdefault(key, [])
            if len(idle) < self.POOL_SIZE:
                idle.append((reader, writer))
            else:
                writer.close()
        return ClientResponse(status, headers, body)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

@dataclass
class Request:
    method: str
    path: str
    query: dict
    headers: dict
    body: bytes
    match_info: dict = field(default_factory=dict)

    def json(self):
        return json.loads(self.body) if self.body else None


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = "text/plain"


def json_response(data, status: int = 200) -> Response:
    return Response(status, json.dumps(data).encode(), "application/json")


Handler = Callable[[Request], Awaitable[Response]]


class HTTPServer:
    """Routed HTTP/1.1 server; `port` and `addr` after `start()`."""

    def __init__(self):
        self._routes: list[tuple[str, re.Pattern, Handler]] = []
        self._middleware: list[Callable[[Request], None]] = []
        self._server: asyncio.AbstractServer | None = None
        self._writers: set[asyncio.StreamWriter] = set()
        self.host = ""
        self.port: int | None = None
        self.addr = ""

    def add_route(self, method: str, pattern: str, handler: Handler) -> None:
        rx = re.sub(r"\\\{(\w+)\\\}", r"(?P<\1>[^/]+)", re.escape(pattern))
        self._routes.append((method.upper(), re.compile(rx + r"\Z"),
                             handler))

    def add_get(self, pattern: str, handler: Handler) -> None:
        self.add_route("GET", pattern, handler)

    def add_post(self, pattern: str, handler: Handler) -> None:
        self.add_route("POST", pattern, handler)

    def on_request(self, fn: Callable[[Request], None]) -> None:
        """Call `fn(request)` before every routed request (a request log)."""
        self._middleware.append(fn)

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._server = await asyncio.start_server(self._serve, host, port)
        self.host = host
        self.port = self._server.sockets[0].getsockname()[1]
        self.addr = f"http://{host}:{self.port}"

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for w in list(self._writers):
            w.close()
        try:
            await asyncio.wait_for(self._server.wait_closed(), 1.0)
        except asyncio.TimeoutError:
            pass
        self._server = None

    async def _dispatch(self, req: Request) -> Response:
        allowed = False
        for method, rx, handler in self._routes:
            m = rx.match(req.path)
            if m is None:
                continue
            if method != req.method:
                allowed = True
                continue
            req.match_info = m.groupdict()
            for fn in self._middleware:
                fn(req)
            try:
                return await handler(req)
            except Exception as exc:  # noqa: BLE001 — a 500, as aiohttp
                return Response(500, f"500 Internal Server Error: "
                                f"{type(exc).__name__}: {exc}".encode())
        if allowed:
            return Response(405, b"405: Method Not Allowed")
        return Response(404, b"404: Not Found")

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    return
                parts = line.decode("latin-1").split()
                if len(parts) != 3:
                    return
                method, target, version = parts
                headers = await _read_headers(reader)
                body = await _read_body(reader, headers, to_eof=False)
                path, _, qs = target.partition("?")
                query = {}
                for k, v in urllib.parse.parse_qsl(qs,
                                                   keep_blank_values=True):
                    query.setdefault(k, v)
                req = Request(method.upper(), urllib.parse.unquote(path),
                              query, headers, body)
                resp = await self._dispatch(req)
                conn = headers.get("connection", "").lower()
                keep = (conn != "close" if version == "HTTP/1.1"
                        else conn == "keep-alive")
                reason = _REASONS.get(resp.status, "Unknown")
                writer.write(
                    (f"HTTP/1.1 {resp.status} {reason}\r\n"
                     f"Content-Type: {resp.content_type}\r\n"
                     f"Content-Length: {len(resp.body)}\r\n"
                     f"Connection: {'keep-alive' if keep else 'close'}\r\n"
                     "\r\n").encode("latin-1") + resp.body)
                await writer.drain()
                if not keep:
                    return
        except (HTTPError, ValueError, ConnectionError,
                asyncio.IncompleteReadError):
            return
        finally:
            self._writers.discard(writer)
            writer.close()
