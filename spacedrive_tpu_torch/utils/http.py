"""HTTP/1.1 on asyncio streams: a routed server and a JSON client.

The owned counterpart of the parts of `aiohttp` that the JAX package's
cloud plane stands on (`spacedrive_tpu/cloud/relay.py` serves an
`aiohttp.web.Application`, `cloud/api.py` calls through an
`aiohttp.ClientSession`), written so that the port's relay and client,
and later its API host, need no package beyond the standard library.

Server (:class:`Application` + :class:`Server`): routes by method and
path, ``{name}`` and ``{name:regex}`` captures (percent-decoded into
``request.match_info``), query strings (``request.query``, first value
wins), request bodies by ``Content-Length`` or chunked, read when the
handler asks (``await request.json()``), keep-alive, a middleware chain
(``async def mw(request, handler)``), and :class:`StreamResponse`, a
response written as it goes, with a declared ``Content-Length`` or
chunked, whose connection a handler may close mid-body
(``request.transport.close()``). An unknown path, a known path under
another method, a raised :class:`HTTPException` and a handler that
raises anything else (a bad JSON body, a missing field) answer the
status and body `aiohttp.web` answers; after an unhandled exception the
connection closes, as there.

Client (:class:`HttpClient`): one request at a time per connection,
idle keep-alive connections reused per host, a JSON or bytes body,
responses read by ``Content-Length``, chunked, or to EOF. Every
transport failure raises :class:`ClientError`, the counterpart of
`aiohttp.ClientError`: a refused connection, a reset, a malformed
status line, a body shorter than its ``Content-Length``, a
:meth:`ClientResponse.json` on a body that is not JSON by its type.

No websockets yet.
"""

from __future__ import annotations

import asyncio
import email.utils
import http
import json as _json
import logging
import re
import urllib.parse
from typing import Any, Awaitable, Callable, Iterable

logger = logging.getLogger(__name__)

#: a request or status line, or a header line, longer than this is refused
#: (`aiohttp`'s max_line_size and max_field_size)
MAX_LINE = 8190
MAX_HEADERS = 128
#: the request body a handler may read (`aiohttp.web`'s client_max_size)
CLIENT_MAX_SIZE = 1024 ** 2
#: seconds an idle keep-alive connection is held open (`aiohttp.web`'s)
KEEPALIVE_TIMEOUT = 75.0
#: idle keep-alive connections the client holds per host
MAX_IDLE_PER_HOST = 8
SERVER_NAME = "spacedrive_tpu_torch"

_REASONS = {s.value: s.phrase for s in http.HTTPStatus}
_NO_BODY = frozenset({204, 304})


def reason(status: int) -> str:
    return _REASONS.get(status, "Unknown")


class Headers:
    """Case-insensitive header map keeping each name's first spelling;
    a repeated header's values join with ", "."""

    def __init__(self, items: Iterable[tuple[str, str]] | dict[str, str] = ()):
        self._d: dict[str, tuple[str, str]] = {}
        for k, v in (items.items() if isinstance(items, dict) else items):
            self.add(k, v)

    def add(self, name: str, value: str) -> None:
        key = name.lower()
        if key in self._d:
            self._d[key] = (self._d[key][0], f"{self._d[key][1]}, {value}")
        else:
            self._d[key] = (name, str(value))

    def __setitem__(self, name: str, value: str) -> None:
        self._d[name.lower()] = (name, str(value))

    def __getitem__(self, name: str) -> str:
        return self._d[name.lower()][1]

    def __contains__(self, name: object) -> bool:
        return isinstance(name, str) and name.lower() in self._d

    def get(self, name: str, default: Any = None) -> Any:
        hit = self._d.get(name.lower())
        return default if hit is None else hit[1]

    def items(self) -> list[tuple[str, str]]:
        return list(self._d.values())


def _tokens(value: str | None) -> set[str]:
    return {t.strip().lower() for t in (value or "").split(",") if t.strip()}


async def _read_lines(reader: asyncio.StreamReader, skip_blank: bool = False) -> list[bytes]:
    """The lines of a message head up to its blank line (the request or
    status line not included when the caller read it). ``skip_blank``
    passes over blank lines before the first (RFC 9112 2.2). Raises
    IncompleteReadError at EOF, ValueError on an overlong line or too
    many headers."""
    lines: list[bytes] = []
    while True:
        try:
            line = await reader.readuntil(b"\n")
        except asyncio.LimitOverrunError as e:
            raise ValueError("header line too long") from e
        if len(line) > MAX_LINE + 2:
            raise ValueError("header line too long")
        line = line.rstrip(b"\r\n")
        if not line:
            if lines or not skip_blank:
                return lines
            continue
        lines.append(line)
        if len(lines) > MAX_HEADERS + 1:
            raise ValueError("too many headers")


def _parse_headers(lines: list[bytes]) -> Headers:
    out = Headers()
    for raw in lines:
        name, sep, value = raw.decode("latin-1").partition(":")
        if not sep or not name or name != name.strip():
            raise ValueError(f"malformed header line {raw[:40]!r}")
        out.add(name, value.strip())
    return out


async def _read_chunked(reader: asyncio.StreamReader, limit: int | None = None) -> bytes:
    body = bytearray()
    while True:
        line = await reader.readuntil(b"\n")
        try:
            size = int(line.split(b";", 1)[0].strip(), 16)
        except ValueError as e:
            raise ValueError(f"malformed chunk size {line[:20]!r}") from e
        if size == 0:
            while (await reader.readuntil(b"\n")).strip():  # trailers
                pass
            return bytes(body)
        body += await reader.readexactly(size)
        if limit is not None and len(body) > limit:
            raise _TooLarge(len(body))
        if await reader.readexactly(2) != b"\r\n":
            raise ValueError("malformed chunk terminator")


class _TooLarge(Exception):
    def __init__(self, size: int):
        self.size = size


# --- server: requests, responses, errors -------------------------------------------------


class Request:
    """One parsed request; its body is read when the handler asks."""

    def __init__(self, method: str, target: str, version: str, headers: Headers,
                 reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.method = method
        self.headers = headers
        self.raw_path, _, self.query_string = target.partition("?")
        self.path = urllib.parse.unquote(self.raw_path)
        self.query: dict[str, str] = {}
        for k, v in urllib.parse.parse_qsl(self.query_string, keep_blank_values=True):
            self.query.setdefault(k, v)
        self.match_info: dict[str, str] = {}
        self._reader, self._writer = reader, writer
        self._body: bytes | None = None
        conn = _tokens(headers.get("Connection"))
        self.keep_alive = ("keep-alive" in conn if version == "HTTP/1.0"
                           else "close" not in conn)

    @property
    def transport(self) -> asyncio.BaseTransport | None:
        return self._writer.transport

    @property
    def remote(self) -> str | None:
        peer = self._writer.get_extra_info("peername")
        return peer[0] if isinstance(peer, tuple) else None

    async def read(self) -> bytes:
        if self._body is None:
            self._body = await self._read_body(CLIENT_MAX_SIZE)
        return self._body

    async def _read_body(self, limit: int | None) -> bytes:
        if "chunked" in _tokens(self.headers.get("Transfer-Encoding")):
            try:
                return await _read_chunked(self._reader, limit)
            except _TooLarge as e:
                self.keep_alive = False
                raise HTTPRequestEntityTooLarge(limit, e.size) from None
        n = int(self.headers.get("Content-Length") or 0)
        if limit is not None and n > limit:
            self.keep_alive = False  # the body stays unread on the wire
            raise HTTPRequestEntityTooLarge(limit, n)
        return await self._reader.readexactly(n) if n else b""

    async def text(self) -> str:
        return (await self.read()).decode("utf-8")

    async def json(self) -> Any:
        return _json.loads(await self.text())

    async def _discard_body(self) -> None:
        """Read past a body the handler left unread, so the next request
        on the connection starts where it should."""
        if self._body is None:
            self._body = await self._read_body(None)


class Response:
    """A whole response: status, headers and a bytes body."""

    prepared = False

    def __init__(self, *, status: int = 200, body: bytes | None = None,
                 text: str | None = None, content_type: str | None = None,
                 headers: dict[str, str] | None = None):
        self.status = status
        self.headers = Headers(headers or {})
        if text is not None:
            body = text.encode("utf-8")
            content_type = f"{content_type or 'text/plain'}; charset=utf-8"
        self.body = bytes(body or b"")
        self.force_close = False
        if "Content-Type" not in self.headers and (content_type or body is not None):
            self.headers["Content-Type"] = content_type or "application/octet-stream"

    def encode(self, keep_alive: bool, head_only: bool = False) -> bytes:
        headers = Headers(self.headers.items())
        if self.status not in _NO_BODY:
            headers["Content-Length"] = str(len(self.body))
        return _head(self.status, headers, keep_alive) + (
            b"" if head_only or self.status in _NO_BODY else self.body)


def _head(status: int, headers: Headers, keep_alive: bool) -> bytes:
    if "Date" not in headers:
        headers["Date"] = email.utils.formatdate(usegmt=True)
    if "Server" not in headers:
        headers["Server"] = SERVER_NAME
    if not keep_alive:
        headers["Connection"] = "close"
    lines = [f"HTTP/1.1 {status} {reason(status)}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def json_response(data: Any, *, status: int = 200) -> Response:
    return Response(status=status, text=_json.dumps(data), content_type="application/json")


class StreamResponse:
    """A response written as it goes: ``await prepare(request)`` sends
    the head, ``await write(data)`` the body, with the declared
    ``content_length`` or chunked when it is None. The server ends a
    chunked body after the handler returns; it closes the connection
    when a declared length was not met."""

    def __init__(self, *, status: int = 200):
        self.status = status
        self.headers = Headers()
        self.content_length: int | None = None
        self.prepared = False
        self._writer: asyncio.StreamWriter | None = None
        self._written = 0
        self._eof = False

    async def prepare(self, request: Request) -> None:
        if self.prepared:
            return
        self.prepared = True
        self._writer = request._writer
        if self.content_length is not None:
            self.headers["Content-Length"] = str(self.content_length)
        else:
            self.headers["Transfer-Encoding"] = "chunked"
        self._writer.write(_head(self.status, self.headers, request.keep_alive))
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        if not data:
            return
        w = self._writer
        if self.content_length is None:
            w.write(b"%x\r\n" % len(data) + bytes(data) + b"\r\n")
        else:
            w.write(bytes(data))
        self._written += len(data)
        await w.drain()

    async def write_eof(self) -> None:
        if self._eof:
            return
        self._eof = True
        if self.content_length is None:
            self._writer.write(b"0\r\n\r\n")
            await self._writer.drain()

    @property
    def complete(self) -> bool:
        return self.content_length is None or self._written == self.content_length


class HTTPException(Exception):
    """Raised by a handler (or a middleware) to answer with ``status``:
    the body is ``text``, else "<status>: <reason>", as aiohttp's."""

    status = 500

    def __init__(self, *, text: str | None = None, headers: dict[str, str] | None = None):
        self.text = f"{self.status}: {reason(self.status)}" if text is None else text
        super().__init__(self.text)
        self.headers = headers or {}

    def response(self) -> Response:
        return Response(status=self.status, text=self.text, headers=self.headers)


class HTTPBadRequest(HTTPException):
    status = 400


class HTTPForbidden(HTTPException):
    status = 403


class HTTPNotFound(HTTPException):
    status = 404


class HTTPMethodNotAllowed(HTTPException):
    status = 405

    def __init__(self, allowed: Iterable[str]):
        super().__init__(headers={"Allow": ",".join(sorted(allowed))})


class HTTPRequestEntityTooLarge(HTTPException):
    status = 413

    def __init__(self, max_size: int, actual_size: int):
        super().__init__(text=f"Maximum request body size {max_size} exceeded, "
                              f"actual body size {actual_size}")


def internal_error_response(request: Request) -> Response:
    """aiohttp.web's answer to a handler that raised."""
    title = f"500 {reason(500)}"
    msg = http.HTTPStatus.INTERNAL_SERVER_ERROR.description
    if "text/html" in request.headers.get("Accept", ""):
        resp = Response(status=500, content_type="text/html", text=(
            f"<html><head><title>{title}</title></head><body>\n<h1>{title}</h1>"
            f"\n{msg}\n</body></html>\n"))
    else:
        resp = Response(status=500, text=f"{title}\n\n{msg}")
    resp.force_close = True
    return resp


# --- server: routing, the application, the listener --------------------------------------

Handler = Callable[[Request], Awaitable[Any]]
Middleware = Callable[[Request, Handler], Awaitable[Any]]

_CAPTURE = re.compile(r"\{([A-Za-z_][A-Za-z0-9_]*)(?::(.*?))?\}")
#: what a path segment carries unescaped (RFC 3986 pchar), so a literal
#: part of a route matches the raw path a client sends
_PATH_SAFE = "/:@!$&'()*+,;=-._~"


class Route:
    def __init__(self, method: str, path: str, handler: Handler):
        self.method, self.path, self.handler = method.upper(), path, handler
        parts, pos = [], 0
        for m in _CAPTURE.finditer(path):
            parts.append(re.escape(urllib.parse.quote(path[pos:m.start()], safe=_PATH_SAFE)))
            parts.append(f"(?P<{m.group(1)}>{m.group(2) or '[^{}/]+'})")
            pos = m.end()
        parts.append(re.escape(urllib.parse.quote(path[pos:], safe=_PATH_SAFE)))
        self.pattern = re.compile("".join(parts))

    def match(self, raw_path: str) -> dict[str, str] | None:
        m = self.pattern.fullmatch(raw_path)
        if m is None:
            return None
        return {k: urllib.parse.unquote(v) for k, v in m.groupdict().items()}


def get(path: str, handler: Handler) -> Route:
    return Route("GET", path, handler)


def post(path: str, handler: Handler) -> Route:
    return Route("POST", path, handler)


class Application:
    """Routes plus the middleware chain, outermost first."""

    def __init__(self, middlewares: Iterable[Middleware] = ()):
        self.routes: list[Route] = []
        self.middlewares = list(middlewares)

    def add_routes(self, routes: Iterable[Route]) -> None:
        self.routes.extend(routes)

    def resolve(self, request: Request) -> Handler:
        allowed = set()
        for r in self.routes:
            info = r.match(request.raw_path)
            if info is None:
                continue
            if r.method == request.method or (r.method == "GET" and request.method == "HEAD"):
                request.match_info = info
                return r.handler
            allowed.add(r.method)
        exc: HTTPException = HTTPMethodNotAllowed(allowed) if allowed else HTTPNotFound()

        async def unresolved(_request: Request) -> Any:
            raise exc

        return unresolved

    async def handle(self, request: Request) -> Response | StreamResponse:
        """The handler's response through the middlewares; an
        HTTPException becomes its response, any other exception aiohttp's
        500 (logged)."""
        handler = self.resolve(request)
        for mw in reversed(self.middlewares):
            handler = (lambda mw, inner: lambda req: mw(req, inner))(mw, handler)
        try:
            return await handler(request)
        except HTTPException as e:
            return e.response()
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("Error handling request from %s", request.remote)
            return internal_error_response(request)


class Server:
    """An :class:`Application` on a TCP listener."""

    def __init__(self, app: Application):
        self.app = app
        self._server: asyncio.Server | None = None
        self._conns: dict[asyncio.Task, asyncio.StreamWriter] = {}
        self.port: int | None = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._serve, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def shutdown(self) -> None:
        if self._server is None:
            return
        self._server.close()
        conns, self._conns = dict(self._conns), {}
        for task, writer in conns.items():
            writer.transport.abort()
            task.cancel()
        await asyncio.gather(*conns, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns[task] = writer
        try:
            while not writer.is_closing():
                try:
                    async with asyncio.timeout(KEEPALIVE_TIMEOUT):
                        lines = await _read_lines(reader, skip_blank=True)
                    request = self._parse(lines, reader, writer)
                except (asyncio.IncompleteReadError, TimeoutError, ConnectionError):
                    return
                except ValueError as e:
                    writer.write(Response(status=400, text=f"Bad Request: {e}").encode(False))
                    await writer.drain()
                    return
                if not await self._respond(request, writer):
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.pop(task, None)
            writer.close()

    def _parse(self, lines: list[bytes], reader, writer) -> Request:
        parts = lines[0].decode("latin-1").split(" ")
        if (len(parts) != 3 or not re.fullmatch(r"[A-Z]+", parts[0])
                or parts[2] not in ("HTTP/1.1", "HTTP/1.0") or not parts[1].startswith("/")):
            raise ValueError(f"malformed request line {lines[0][:40]!r}")
        headers = _parse_headers(lines[1:])
        if not re.fullmatch(r"\d*", headers.get("Content-Length") or ""):
            raise ValueError("malformed Content-Length")
        return Request(parts[0], parts[1], parts[2], headers, reader, writer)

    async def _respond(self, request: Request, writer: asyncio.StreamWriter) -> bool:
        """Answer one request; True when the connection stays open."""
        resp = await self.app.handle(request)
        if resp.prepared:
            if writer.is_closing():
                return False
            await resp.write_eof()
            keep = request.keep_alive and resp.complete
        else:
            keep = request.keep_alive and not resp.force_close
            writer.write(resp.encode(keep, head_only=request.method == "HEAD"))
            await writer.drain()
        if keep:
            await request._discard_body()
        return keep


# --- client ------------------------------------------------------------------------------


class ClientError(Exception):
    """A transport failure of :class:`HttpClient`: the counterpart of
    `aiohttp.ClientError`."""


class ClientResponse:
    def __init__(self, status: int, reason_: str, headers: Headers, body: bytes):
        self.status, self.reason, self.headers, self.body = status, reason_, headers, body

    @property
    def content_type(self) -> str:
        return (self.headers.get("Content-Type") or "application/octet-stream").split(";")[0].strip()

    def text(self) -> str:
        m = re.search(r"charset=([\w-]+)", self.headers.get("Content-Type") or "")
        return self.body.decode(m.group(1) if m else "utf-8", errors="replace")

    def json(self) -> Any:
        """The body as JSON, None when it is empty; a body whose type is
        not JSON is a ClientError, as aiohttp's ContentTypeError is."""
        if not self.body.strip():
            return None
        if not _JSON_TYPE.match(self.content_type):
            raise ClientError(f"attempt to decode JSON with unexpected mimetype: "
                              f"{self.content_type}")
        return _json.loads(self.text())


_JSON_TYPE = re.compile(r"^application/(?:[\w.+-]+?\+)?json")
_STATUS_LINE = re.compile(rb"HTTP/1\.([01]) (\d{3})(?: (.*))?")


class _Stale(Exception):
    """A pooled connection the server closed while it sat idle."""


class HttpClient:
    """Requests over pooled keep-alive connections, one request a
    connection at a time."""

    def __init__(self):
        self._idle: dict[tuple[str, int], list[tuple[asyncio.StreamReader,
                                                     asyncio.StreamWriter]]] = {}
        self._closed = False

    async def request(self, method: str, url: str, *, json: Any = None,
                      data: bytes | None = None,
                      headers: dict[str, str] | None = None) -> ClientResponse:
        if self._closed:
            raise ClientError("client is closed")
        method = method.upper()
        u = urllib.parse.urlsplit(url)
        if u.scheme != "http" or not u.hostname:
            raise ClientError(f"unsupported url {url!r}")
        key = (u.hostname, u.port or 80)
        target = (u.path or "/") + (f"?{u.query}" if u.query else "")
        h = Headers({"Host": u.hostname if key[1] == 80 else f"{u.hostname}:{key[1]}",
                     "Accept": "*/*", "User-Agent": SERVER_NAME})
        for k, v in (headers or {}).items():
            h[k] = v
        body = b""
        if json is not None:
            body = _json.dumps(json).encode("utf-8")
            if "Content-Type" not in h:
                h["Content-Type"] = "application/json"
        elif data is not None:
            body = bytes(data)
        if body or method in ("POST", "PUT", "PATCH"):
            h["Content-Length"] = str(len(body))
        lines = [f"{method} {target} HTTP/1.1"] + [f"{k}: {v}" for k, v in h.items()]
        raw = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body
        while True:
            reader, writer, reused = await self._connect(key)
            try:
                resp, keep = await self._exchange(reader, writer, raw, method, reused)
            except _Stale:
                writer.close()
                continue  # once more, on another connection
            except BaseException as e:
                writer.close()
                if isinstance(e, (OSError, EOFError, ValueError, asyncio.LimitOverrunError)):
                    raise ClientError(f"{type(e).__name__}: {e}") from e
                raise
            pool = self._idle.setdefault(key, [])
            if keep and not self._closed and len(pool) < MAX_IDLE_PER_HOST:
                pool.append((reader, writer))
            else:
                writer.close()
            return resp

    async def _connect(self, key: tuple[str, int]):
        pool = self._idle.get(key)
        while pool:
            reader, writer = pool.pop()
            if not writer.is_closing() and not reader.at_eof():
                return reader, writer, True
            writer.close()
        try:
            return (*await asyncio.open_connection(*key), False)
        except OSError as e:
            raise ClientError(f"cannot connect to {key[0]}:{key[1]}: {e}") from e

    async def _exchange(self, reader, writer, raw: bytes, method: str,
                        reused: bool) -> tuple[ClientResponse, bool]:
        try:
            writer.write(raw)
            await writer.drain()
            first = await reader.readuntil(b"\n")
        except (ConnectionError, asyncio.IncompleteReadError) as e:
            if reused and not getattr(e, "partial", b""):
                raise _Stale() from e
            if isinstance(e, asyncio.IncompleteReadError):
                raise ClientError("server disconnected before its response") from e
            raise
        m = _STATUS_LINE.fullmatch(first.rstrip(b"\r\n"))
        if m is None:
            raise ClientError(f"malformed status line {first[:40]!r}")
        status = int(m.group(2))
        headers = _parse_headers(await _read_lines(reader))
        keep = m.group(1) == b"1" and "close" not in _tokens(headers.get("Connection"))
        if method == "HEAD" or status in _NO_BODY:
            body = b""
        elif "chunked" in _tokens(headers.get("Transfer-Encoding")):
            body = await _read_chunked(reader)
        elif headers.get("Content-Length") is not None:
            n = int(headers["Content-Length"])
            try:
                body = await reader.readexactly(n)
            except asyncio.IncompleteReadError as e:
                raise ClientError(f"response payload is not completed: {len(e.partial)} of "
                                  f"{n} bytes") from e
        else:
            body, keep = await reader.read(), False
        return ClientResponse(status, (m.group(3) or b"").decode("latin-1"), headers, body), keep

    async def close(self) -> None:
        self._closed = True
        pools, self._idle = self._idle, {}
        for conns in pools.values():
            for _, writer in conns:
                writer.close()
