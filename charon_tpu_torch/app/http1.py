"""HTTP/1.1 on asyncio streams: a JSON client and a small routed server.

The port's beacon client (`eth2util/beacon_client.py`), HTTP beacon mock
(`testutil/beaconmock_http.py`) and monitoring API (`app/monitoring.py`)
speak HTTP through this module, in place of the JAX package's aiohttp.
It covers what those peers exchange, and interoperates with aiohttp on
both sides:

- `HTTPClient`: any method with query parameters (a dict, or a list of
  pairs for repeated keys), extra headers and a JSON or raw body;
  response bodies by Content-Length, chunked transfer coding, or read to
  EOF on a closing connection; keep-alive connections pooled per host, a
  stale pooled connection retried once on a fresh one; a total timeout
  per request.  `HTTPClient.open` hands back the status and headers with
  the body still on the wire (`StreamedResponse`), read chunk by chunk.
- `HTTPServer`: routes by method (``*`` for any) and path pattern
  (``{name}`` matches one path segment, ``{name:regex}`` the regex, into
  `Request.match_info`); the query's repeated keys kept in order
  (`Request.query_items`, `getall`) beside the first value of each
  (`Request.query`); request bodies by Content-Length or chunked, kept
  raw; a response body whole, or streamed from an async iterator with
  chunked transfer coding (`Response.stream`); extra response headers;
  keep-alive unless the client asks to close or speaks HTTP/1.0; 404 for
  an unknown path, 405 for a known path under another method, 500 when a
  handler raises.

Request bodies are read whole (at most `MAX_BODY`) before the handler
runs; response bodies may stream.
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

#: bytes a streamed body yields at most a read
CHUNK = 1 << 16

_REASONS = {200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
            206: "Partial Content", 304: "Not Modified",
            400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 409: "Conflict",
            500: "Internal Server Error", 501: "Not Implemented",
            502: "Bad Gateway", 503: "Service Unavailable",
            504: "Gateway Timeout"}

#: headers the server writes itself (a handler's copies are dropped)
_FRAMING = {"content-type", "content-length", "transfer-encoding",
            "connection"}


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


async def _iter_body(reader: asyncio.StreamReader, headers: dict,
                     to_eof: bool):
    """The body's bytes as they arrive, at most `CHUNK` a piece."""
    if "chunked" in headers.get("transfer-encoding", "").lower():
        while True:
            line = await reader.readline()
            if not line:
                raise HTTPError("connection closed in a chunk size")
            size = int(line.split(b";", 1)[0].strip(), 16)
            if size == 0:
                while await reader.readline() not in (b"\r\n", b"\n", b""):
                    pass  # trailers
                return
            while size:
                piece = await reader.readexactly(min(size, CHUNK))
                size -= len(piece)
                yield piece
            await reader.readexactly(2)
    elif "content-length" in headers:
        left = int(headers["content-length"])
        while left:
            piece = await reader.read(min(left, CHUNK))
            if not piece:
                raise HTTPError("connection closed in the body")
            left -= len(piece)
            yield piece
    elif to_eof:
        while piece := await reader.read(CHUNK):
            yield piece


async def _read_body(reader: asyncio.StreamReader, headers: dict,
                     to_eof: bool) -> bytes:
    if int(headers.get("content-length", 0)) > MAX_BODY:
        raise HTTPError("body too large")
    out = bytearray()
    async for piece in _iter_body(reader, headers, to_eof):
        out += piece
        if len(out) > MAX_BODY:
            raise HTTPError("body too large")
    return bytes(out)


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


class StreamedResponse:
    """A response whose body is still on the wire: `iter_chunks()` reads
    it piece by piece (or `read()` whole); `release()` hands a fully read
    keep-alive connection back to the pool and closes any other."""

    def __init__(self, client: "HTTPClient", key, reader, writer,
                 status: int, headers: dict, closing: bool, empty: bool):
        self._client, self._key = client, key
        self._reader, self._writer = reader, writer
        self.status, self.headers = status, headers
        self._closing = closing
        self._done = empty
        self._released = False

    async def iter_chunks(self):
        if self._done:
            return
        async for piece in _iter_body(self._reader, self.headers,
                                      to_eof=self._closing):
            yield piece
        self._done = True

    async def read(self) -> bytes:
        return b"".join([piece async for piece in self.iter_chunks()])

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._done and not self._closing:
            self._client._pool(self._key, self._reader, self._writer)
        else:
            self._writer.close()


class HTTPClient:
    """Keep-alive HTTP/1.1 client for JSON APIs."""

    #: idle keep-alive connections kept a host
    POOL_SIZE = 8

    def __init__(self, timeout: float = 10.0, pool_size: int | None = None):
        self._timeout = timeout
        self._pool_size = pool_size or self.POOL_SIZE
        self._idle: dict[tuple[str, int], list] = {}
        self._closed = False

    async def close(self) -> None:
        self._closed = True
        for conns in self._idle.values():
            for _, writer in conns:
                writer.close()
        self._idle.clear()

    async def get(self, url: str, params=None) -> ClientResponse:
        return await self.request("GET", url, params=params)

    async def post(self, url: str, json_body=None) -> ClientResponse:
        return await self.request("POST", url, json_body=json_body)

    async def request(self, method: str, url: str, params=None,
                      json_body=None, headers: dict | None = None,
                      data: bytes | None = None) -> ClientResponse:
        """One exchange, its body read whole.  `params` is a dict or a
        list of (key, value) pairs; `data` a raw body (else `json_body`
        as JSON; a POST always carries a body)."""

        async def whole():
            resp = await self._open(method, url, params, json_body,
                                    headers, data)
            try:
                body = await resp.read()
            finally:
                resp.release()
            return ClientResponse(resp.status, resp.headers, body)

        return await asyncio.wait_for(whole(), self._timeout)

    async def open(self, method: str, url: str, params=None, json_body=None,
                   headers: dict | None = None,
                   data: bytes | None = None) -> StreamedResponse:
        """Send a request and return once the status line and headers are
        in (within the client's timeout), the body left to read; the
        caller releases the response."""
        return await asyncio.wait_for(
            self._open(method, url, params, json_body, headers, data),
            self._timeout)

    def _message(self, method, u, params, json_body, headers, data):
        host, port = u.hostname or "127.0.0.1", u.port or 80
        target = u.path or "/"
        query = u.query
        if params:
            query = "&".join(q for q in (query, urllib.parse.urlencode(
                params)) if q)
        if query:
            target += "?" + query
        # by lower-case name: a caller's header replaces a default
        head = {"host": ("Host", f"{host}:{port}"),
                "accept": ("Accept", "application/json")}
        for k, v in (headers or {}).items():
            if k.lower() not in _FRAMING and k.lower() != "host":
                head[k.lower()] = (k, v)
        head["connection"] = ("Connection", "keep-alive")
        body = b""
        if data is not None:
            body = bytes(data)
        elif json_body is not None or method == "POST":
            body = json.dumps(json_body).encode()
            head["content-type"] = ("Content-Type", "application/json")
        if body or method in ("POST", "PUT", "PATCH"):
            head["content-length"] = ("Content-Length", str(len(body)))
        lines = [f"{method} {target} HTTP/1.1"] + [
            f"{k}: {v}" for k, v in head.values()]
        return (host, port), ("\r\n".join(lines) + "\r\n\r\n").encode(
            "latin-1") + body

    async def _open(self, method, url, params, json_body, headers, data
                    ) -> StreamedResponse:
        u = urllib.parse.urlsplit(url)
        if u.scheme != "http":
            raise ValueError(f"only http:// URLs are supported: {url}")
        key, msg = self._message(method, u, params, json_body, headers, data)
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
        reader, writer = await asyncio.open_connection(*key)
        try:
            return await self._exchange(key, reader, writer, method, msg)
        except BaseException:
            writer.close()
            raise

    async def _exchange(self, key, reader, writer, method: str,
                        msg: bytes) -> StreamedResponse:
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
        empty = (method == "HEAD" or status in (204, 304)
                 or 100 <= status < 200)
        return StreamedResponse(self, key, reader, writer, status, headers,
                                closing, empty)

    def _pool(self, key, reader, writer) -> None:
        idle = self._idle.setdefault(key, [])
        if self._closed or len(idle) >= self._pool_size:
            writer.close()
        else:
            idle.append((reader, writer))


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
    #: every (key, value) of the query string, repeats kept in order
    query_items: list = field(default_factory=list)
    #: the raw query string (the target after ``?``)
    query_string: str = ""
    #: the request target as sent: path and query, still percent-encoded
    path_qs: str = ""

    def getall(self, key: str) -> list[str]:
        return [v for k, v in self.query_items if k == key]

    def json(self):
        return json.loads(self.body) if self.body else None


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = "text/plain"
    #: extra headers (``Retry-After``, a proxied response's own)
    headers: dict = field(default_factory=dict)
    #: an async iterator of the body's pieces, sent chunked in place of
    #: `body`; it is closed (``aclose``) when the exchange ends
    stream: object = None


def json_response(data, status: int = 200,
                  headers: dict | None = None) -> Response:
    return Response(status, json.dumps(data).encode(), "application/json",
                    dict(headers or {}))


Handler = Callable[[Request], Awaitable[Response]]

_PARAM = re.compile(r"\{(\w+)(?::([^{}]+))?\}")


def _route_regex(pattern: str) -> re.Pattern:
    """``/a/{x}/{tail:.*}`` → a regex with the named groups."""
    out, pos = [], 0
    for m in _PARAM.finditer(pattern):
        out.append(re.escape(pattern[pos:m.start()]))
        out.append(f"(?P<{m.group(1)}>{m.group(2) or '[^/]+'})")
        pos = m.end()
    out.append(re.escape(pattern[pos:]))
    return re.compile("".join(out) + r"\Z")


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
        """`method` ``*`` matches any; routes match in the order added,
        and a path matched under another method falls through to later
        routes (a ``*`` catch-all added last serves it)."""
        self._routes.append((method.upper(), _route_regex(pattern), handler))

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
            if method not in ("*", req.method):
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

    async def _write(self, writer: asyncio.StreamWriter, resp: Response,
                     keep: bool, head_only: bool) -> None:
        reason = _REASONS.get(resp.status, "Unknown")
        ctype = resp.content_type
        extra = []
        for k, v in resp.headers.items():
            if k.lower() == "content-type":
                ctype = v
            elif k.lower() not in _FRAMING:
                extra.append(f"{k}: {v}\r\n")
        # a HEAD's answer and a 1xx, 204 or 304 carry no body (RFC 9112
        # §6.3): no chunked framing, and a 1xx, 204 or 304 no length
        no_body_status = resp.status in (204, 304) or resp.status < 200
        empty = head_only or no_body_status
        if no_body_status or empty and resp.stream is not None:
            framing = ""
        elif resp.stream is not None:
            framing = "Transfer-Encoding: chunked\r\n"
        else:
            framing = f"Content-Length: {len(resp.body)}\r\n"
        writer.write(
            (f"HTTP/1.1 {resp.status} {reason}\r\n"
             f"Content-Type: {ctype}\r\n{framing}" + "".join(extra)
             + f"Connection: {'keep-alive' if keep else 'close'}\r\n\r\n"
             ).encode("latin-1"))
        if resp.stream is None:
            if not empty:
                writer.write(resp.body)
            await writer.drain()
            return
        try:
            # a stream that must send no body still runs to its end (its
            # own clean-up, a proxied response's release), as aiohttp
            # drops what such a handler writes
            async for piece in resp.stream:
                if piece and not empty:
                    writer.write(b"%x\r\n%s\r\n" % (len(piece), piece))
                    await writer.drain()
            if not empty:
                writer.write(b"0\r\n\r\n")
            await writer.drain()
        finally:
            await resp.stream.aclose()

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
                items = urllib.parse.parse_qsl(qs, keep_blank_values=True)
                query = {}
                for k, v in items:
                    query.setdefault(k, v)
                req = Request(method.upper(), urllib.parse.unquote(path),
                              query, headers, body, query_items=items,
                              query_string=urllib.parse.unquote(qs),
                              path_qs=target)
                resp = await self._dispatch(req)
                conn = headers.get("connection", "").lower()
                keep = (conn != "close" if version == "HTTP/1.1"
                        else conn == "keep-alive")
                await self._write(writer, resp, keep,
                                  head_only=req.method == "HEAD")
                if not keep:
                    return
        except (HTTPError, ValueError, ConnectionError,
                asyncio.IncompleteReadError):
            return
        finally:
            self._writers.discard(writer)
            writer.close()
