"""HTTP/1.1 and websockets on asyncio streams: a routed server and clients.

The owned counterpart of the parts of `aiohttp` that the JAX package's
cloud plane and API host stand on (`spacedrive_tpu/cloud/relay.py` and
`api/server.py` serve an `aiohttp.web.Application`, `cloud/api.py` calls
through an `aiohttp.ClientSession`), written so that the port's relay,
client and API host need no package beyond the standard library.

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
connection closes, as there. A handler may return an unprepared
:class:`StreamResponse` (:class:`FileResponse`): the server prepares it.
``request.route`` is the matched :class:`Route` (its ``canonical`` path
has the captures' regexes stripped, as aiohttp's resource's has),
``request.can_read_body`` and ``request.http_range`` read as aiohttp's.

:class:`FileResponse` answers as `aiohttp.web.FileResponse` does: the
``ETag`` (``"<mtime_ns hex>-<size hex>"``) and ``Last-Modified``,
``If-None-Match`` / ``If-Modified-Since`` (304), ``If-Match`` /
``If-Unmodified-Since`` (412), ``If-Range``, and ``Range`` (206 with
``Content-Range``, suffix ranges, 416 with ``bytes */<size>``);
``Accept-Ranges: bytes`` always.

Websockets (RFC 6455): :class:`WebSocketResponse` is the server side (the
handshake with ``Sec-WebSocket-Accept``, aiohttp's 400s on a request
that is no upgrade, client frames unmasked, fragments joined, pings
answered, the close handshake with the peer's code echoed) and
:func:`ws_connect` the client side (frames masked). Both iterate text
and binary messages until the close, as aiohttp's do; no extension
(permessage-deflate) is negotiated.

Client (:class:`HttpClient`): one request at a time per connection,
idle keep-alive connections reused per host, a JSON or bytes body,
responses read by ``Content-Length``, chunked, or to EOF. Every
transport failure raises :class:`ClientError`, the counterpart of
`aiohttp.ClientError`: a refused connection, a reset, a malformed
status line, a body shorter than its ``Content-Length``, a
:meth:`ClientResponse.json` on a body that is not JSON by its type.
"""

from __future__ import annotations

import asyncio
import base64
import email.utils
import enum
import hashlib
import http
import json as _json
import logging
import math
import mimetypes
import os
import re
import stat as _stat
import struct
import time
import urllib.parse
from typing import Any, Awaitable, Callable, Iterable, NamedTuple

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
        self.route: Route | None = None
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

    @property
    def can_read_body(self) -> bool:
        """True while a body is announced and unread (aiohttp's)."""
        if self._body is not None:
            return False
        if "chunked" in _tokens(self.headers.get("Transfer-Encoding")):
            return True
        return int(self.headers.get("Content-Length") or 0) > 0

    @property
    def http_range(self) -> slice:
        """The ``Range`` header as a slice, as aiohttp's: ``bytes=a-b`` is
        ``slice(a, b + 1)``, ``bytes=a-`` ``slice(a, None)``, ``bytes=-n``
        ``slice(-n, None)``; ValueError on any other form."""
        rng = self.headers.get("Range")
        start = end = None
        if rng is not None:
            m = re.fullmatch(r"bytes=(\d*)-(\d*)", rng, re.ASCII)
            if m is None:
                raise ValueError("range not in acceptable format")
            end = int(m.group(2)) if m.group(2) else None
            start = int(m.group(1)) if m.group(1) else None
            if start is None and end is not None:
                start, end = -end, None
            if start is not None and end is not None:
                end += 1
                if start >= end:
                    raise ValueError("start cannot be after end")
            if start is None and end is None:
                raise ValueError("No start or end of range specified")
        return slice(start, end, 1)

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


def json_response(data: Any, *, status: int = 200, headers: dict[str, str] | None = None,
                  dumps: Callable[[Any], str] = _json.dumps) -> Response:
    return Response(status=status, text=dumps(data), content_type="application/json",
                    headers=headers)


class StreamResponse:
    """A response written as it goes: ``await prepare(request)`` sends
    the head, ``await write(data)`` the body, with the declared
    ``content_length`` or chunked when it is None. The server ends a
    chunked body after the handler returns; it closes the connection
    when a declared length was not met."""

    def __init__(self, *, status: int = 200, headers: dict[str, str] | None = None):
        self.status = status
        self.headers = Headers(headers or {})
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
        if self.status in _NO_BODY:
            self.content_length = 0
        elif self.content_length is not None:
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


class FileResponse(StreamResponse):
    """A file, answered as `aiohttp.web.FileResponse` answers it (the
    module docstring lists the headers and statuses)."""

    def __init__(self, path: str | os.PathLike, *, status: int = 200,
                 headers: dict[str, str] | None = None):
        super().__init__(status=status, headers=headers)
        self.path = os.fspath(path)

    async def prepare(self, request: Request) -> None:
        if self.prepared:
            return
        try:
            fobj, st, verdict = await asyncio.to_thread(self._open, request)
        except PermissionError:
            self.status = 403
            return await self._empty(request)
        except OSError:
            self.status = 404
            return await self._empty(request)
        if verdict in (403, 412):
            self.status = verdict
            return await self._empty(request)
        etag = f"{st.st_mtime_ns:x}-{st.st_size:x}"
        if verdict == 304:
            self.status = 304
            self._validators(etag, st.st_mtime)
            return await super().prepare(request)
        try:
            await self._send(request, fobj, st, etag)
        finally:
            await asyncio.to_thread(fobj.close)

    async def _empty(self, request: Request) -> None:
        """An answer without a body. aiohttp types it (octet-stream) where
        its length was left open: every one but the 412 and a HEAD's."""
        self.content_length = 0
        if self.status != 412 and request.method != "HEAD" and "Content-Type" not in self.headers:
            self.headers["Content-Type"] = "application/octet-stream"
        await super().prepare(request)

    def _validators(self, etag: str, mtime: float) -> None:
        self.headers["ETag"] = f'"{etag}"'
        self.headers["Last-Modified"] = time.strftime(
            "%a, %d %b %Y %H:%M:%S GMT", time.gmtime(math.ceil(mtime)))

    def _open(self, request: Request):
        st = os.stat(self.path)
        if not _stat.S_ISREG(st.st_mode):
            return None, st, 403
        etag = f"{st.st_mtime_ns:x}-{st.st_size:x}"
        if_match = _etags(request.headers.get("If-Match"))
        if if_match is not None and not _etag_match(etag, if_match, weak=False):
            return None, st, 412
        unmod = _http_date(request.headers.get("If-Unmodified-Since"))
        if unmod is not None and if_match is None and st.st_mtime > unmod:
            return None, st, 412
        if_none = _etags(request.headers.get("If-None-Match"))
        if if_none is not None and _etag_match(etag, if_none, weak=True):
            return None, st, 304
        modsince = _http_date(request.headers.get("If-Modified-Since"))
        if modsince is not None and if_none is None and st.st_mtime <= modsince:
            return None, st, 304
        fobj = open(self.path, "rb")
        return fobj, os.fstat(fobj.fileno()), None

    async def _send(self, request: Request, fobj, st: os.stat_result, etag: str) -> None:
        size = st.st_size
        count, start = size, None
        if_range = _http_date(request.headers.get("If-Range"))
        if if_range is None or st.st_mtime <= if_range:
            try:
                rng = request.http_range
            except ValueError:
                self.headers["Content-Range"] = f"bytes */{size}"
                self.status = 416
                return await self._empty(request)
            start, end = rng.start, rng.stop
            if start is not None:
                if start < 0 and end is None:
                    start = max(0, start + size)
                    count = size - start
                else:
                    count = min(end if end is not None else size, size) - start
                if start >= size:
                    self.headers["Content-Range"] = f"bytes */{size}"
                    self.status = 416
                    return await self._empty(request)
                self.status = 206
        if "Content-Type" not in self.headers:
            self.headers["Content-Type"] = (mimetypes.guess_type(self.path)[0]
                                            or "application/octet-stream")
        self._validators(etag, st.st_mtime)
        self.content_length = count
        self.headers["Accept-Ranges"] = "bytes"
        if self.status == 206:
            self.headers["Content-Range"] = f"bytes {start}-{start + count - 1}/{size}"
        await super().prepare(request)
        if request.method == "HEAD" or count == 0:
            self._written = count  # nothing to send: the response is whole
            return
        offset = start or 0
        while count > 0:
            chunk = await asyncio.to_thread(_pread, fobj, offset, min(FILE_CHUNK, count))
            if not chunk:
                break
            await self.write(chunk)
            offset += len(chunk)
            count -= len(chunk)


#: the bytes a FileResponse reads (off the loop) and writes at a time
FILE_CHUNK = 256 * 1024


def _pread(fobj, offset: int, n: int) -> bytes:
    fobj.seek(offset)
    return fobj.read(n)


_ETAG_ITEM = re.compile(r'\s*(W/)?("[^"]*"|\*)\s*(?:,|$)')


def _etags(value: str | None) -> list[tuple[bool, str]] | None:
    """(weak, value) pairs of an If-Match / If-None-Match header."""
    if value is None:
        return None
    out = []
    for m in _ETAG_ITEM.finditer(value):
        if m.group(2) == "*":
            return [(False, "*")]
        out.append((bool(m.group(1)), m.group(2)[1:-1]))
    return out


def _etag_match(etag: str, etags: list[tuple[bool, str]], *, weak: bool) -> bool:
    if len(etags) == 1 and etags[0][1] == "*":
        return True
    return any(v == etag for is_weak, v in etags if weak or not is_weak)


def _http_date(value: str | None) -> float | None:
    if not value:
        return None
    try:
        parsed = email.utils.parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return None
    return parsed.timestamp() if parsed is not None else None


# --- websockets (RFC 6455) ---------------------------------------------------------------

WS_MAGIC = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
#: the largest message either side reads (aiohttp's max_msg_size)
WS_MAX_MSG = 4 * 1024 * 1024


class WSMsgType(enum.IntEnum):
    """aiohttp's message types: the frame opcodes and its own three."""

    CONTINUATION = 0x0
    TEXT = 0x1
    BINARY = 0x2
    PING = 0x9
    PONG = 0xA
    CLOSE = 0x8
    CLOSING = 0x100
    CLOSED = 0x101
    ERROR = 0x102


class WSCloseCode(enum.IntEnum):
    OK = 1000
    PROTOCOL_ERROR = 1002
    ABNORMAL_CLOSURE = 1006
    INVALID_TEXT = 1007
    MESSAGE_TOO_BIG = 1009


class WSMessage(NamedTuple):
    type: WSMsgType
    data: Any
    extra: Any = None


class _WSProtocolError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def ws_accept(key: str) -> str:
    """The ``Sec-WebSocket-Accept`` value for a client's key."""
    return base64.b64encode(hashlib.sha1(key.encode() + WS_MAGIC).digest()).decode()


def _ws_frame(opcode: int, payload: bytes, mask: bool, fin: bool = True) -> bytes:
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    bit = 0x80 if mask else 0
    if n < 126:
        head.append(bit | n)
    elif n < 1 << 16:
        head.append(bit | 126)
        head += struct.pack("!H", n)
    else:
        head.append(bit | 127)
        head += struct.pack("!Q", n)
    if mask:
        key = os.urandom(4)
        head += key
        payload = _ws_mask(payload, key)
    return bytes(head) + payload


def _ws_mask(data: bytes, key: bytes) -> bytes:
    n = len(data)
    if not n:
        return b""
    k = int.from_bytes((key * (n // 4 + 1))[:n], "big")
    return (int.from_bytes(data, "big") ^ k).to_bytes(n, "big")


async def _ws_read_frame(reader: asyncio.StreamReader, limit: int):
    """(fin, opcode, payload) of the next frame, unmasked."""
    b0, b1 = await reader.readexactly(2)
    if b0 & 0x70:
        raise _WSProtocolError(WSCloseCode.PROTOCOL_ERROR, "reserved bits set")
    fin, opcode = bool(b0 & 0x80), b0 & 0x0F
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack("!H", await reader.readexactly(2))
    elif n == 127:
        (n,) = struct.unpack("!Q", await reader.readexactly(8))
    if opcode >= 0x8:
        if not fin or n > 125:
            raise _WSProtocolError(WSCloseCode.PROTOCOL_ERROR, "bad control frame")
        if opcode not in (0x8, 0x9, 0xA):
            raise _WSProtocolError(WSCloseCode.PROTOCOL_ERROR, f"opcode {opcode}")
    elif opcode not in (0x0, 0x1, 0x2):
        raise _WSProtocolError(WSCloseCode.PROTOCOL_ERROR, f"opcode {opcode}")
    if n > limit:
        raise _WSProtocolError(WSCloseCode.MESSAGE_TOO_BIG, f"message of {n} bytes")
    key = await reader.readexactly(4) if b1 & 0x80 else None
    payload = await reader.readexactly(n) if n else b""
    return fin, opcode, _ws_mask(payload, key) if key else payload


class _WebSocket:
    """The message layer both sides share: iteration over text and binary
    messages (pings answered, fragments joined), sends, the close."""

    _mask = False

    def __init__(self) -> None:
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._send_lock = asyncio.Lock()
        self._closing = False  # our close frame is sent
        self._closed = False  # the close handshake ended (or the link died)
        self._reading = False
        self.close_code: int | None = None

    @property
    def closed(self) -> bool:
        return self._closing or self._closed

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        if self._closing or self._closed:
            raise ConnectionResetError("websocket is closing")
        async with self._send_lock:
            self._writer.write(_ws_frame(opcode, payload, self._mask))
            await self._writer.drain()

    async def send_str(self, data: str) -> None:
        await self._send_frame(0x1, data.encode("utf-8"))

    async def send_bytes(self, data: bytes) -> None:
        await self._send_frame(0x2, bytes(data))

    async def _send_close(self, code: int, message: bytes = b"") -> None:
        if self._closing or self._closed:
            return
        self._closing = True
        try:
            async with self._send_lock:
                self._writer.write(_ws_frame(0x8, struct.pack("!H", code) + message,
                                             self._mask))
                await self._writer.drain()
        except (ConnectionError, RuntimeError):
            self._closed = True

    async def receive(self, timeout: float | None = None) -> WSMessage:
        if self._closed:
            return WSMessage(WSMsgType.CLOSED, None)
        if self._reading:
            raise RuntimeError("concurrent call to receive() is not allowed")
        self._reading = True
        try:
            async with asyncio.timeout(timeout):
                return await self._receive()
        finally:
            self._reading = False

    async def _receive(self) -> WSMessage:
        parts: list[bytes] = []
        first = 0
        while True:
            try:
                fin, opcode, payload = await _ws_read_frame(self._reader, WS_MAX_MSG)
            except _WSProtocolError as e:
                await self._fail(e.code)
                return WSMessage(WSMsgType.ERROR, e)
            except (asyncio.IncompleteReadError, ConnectionError) as e:
                self._closed = True
                self.close_code = WSCloseCode.ABNORMAL_CLOSURE
                self._abort()
                return WSMessage(WSMsgType.CLOSED, None, str(e) or None)
            if opcode == 0x9:
                if not self._closing:
                    async with self._send_lock:
                        self._writer.write(_ws_frame(0xA, payload, self._mask))
                        await self._writer.drain()
                continue
            if opcode == 0xA:
                continue
            if opcode == 0x8:
                code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else 1000
                self.close_code = code
                await self._send_close(code)
                self._closed = True
                self._after_close()
                return WSMessage(WSMsgType.CLOSE, code, payload[2:].decode("utf-8", "replace"))
            if opcode == 0x0:
                if not parts:
                    await self._fail(WSCloseCode.PROTOCOL_ERROR)
                    return WSMessage(WSMsgType.ERROR, "continuation without a start")
            elif parts:
                await self._fail(WSCloseCode.PROTOCOL_ERROR)
                return WSMessage(WSMsgType.ERROR, "new message inside a fragmented one")
            else:
                first = opcode
            parts.append(payload)
            if sum(map(len, parts)) > WS_MAX_MSG:
                await self._fail(WSCloseCode.MESSAGE_TOO_BIG)
                return WSMessage(WSMsgType.ERROR, "message too big")
            if not fin:
                continue
            data = b"".join(parts)
            if first == 0x2:
                return WSMessage(WSMsgType.BINARY, data)
            try:
                return WSMessage(WSMsgType.TEXT, data.decode("utf-8"))
            except UnicodeDecodeError:
                await self._fail(WSCloseCode.INVALID_TEXT)
                return WSMessage(WSMsgType.ERROR, "invalid utf-8 text")

    async def _fail(self, code: int) -> None:
        self.close_code = code
        await self._send_close(code)
        self._closed = True
        self._abort()

    def _abort(self) -> None:
        if self._writer is not None:
            self._writer.close()

    def _after_close(self) -> None:
        """The close handshake ended: the client drops its connection;
        the server's ends when its handler returns."""

    async def close(self, *, code: int = WSCloseCode.OK, message: bytes = b"",
                    timeout: float = 10.0) -> bool:
        """Send a close frame and, unless another task is reading, wait
        for the peer's. False when it was already closed."""
        if self._closed:
            return False
        if self._closing:
            return False
        await self._send_close(code, message)
        if self._closed or self._reading:
            return True
        try:
            async with asyncio.timeout(timeout):
                while not self._closed:
                    msg = await self.receive()
                    if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSED, WSMsgType.ERROR):
                        break
        except TimeoutError:
            self._closed = True
            self._abort()
        if self.close_code is None:
            self.close_code = code
        return True

    def __aiter__(self) -> "_WebSocket":
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING, WSMsgType.CLOSED, WSMsgType.ERROR):
            raise StopAsyncIteration
        return msg


class WebSocketResponse(_WebSocket, StreamResponse):
    """The server side: ``await ws.prepare(request)`` answers the upgrade
    (aiohttp's 400 bodies on a request that is none), then the handler
    iterates the client's messages; the connection closes when the
    handler returns."""

    def __init__(self) -> None:
        StreamResponse.__init__(self, status=101)
        _WebSocket.__init__(self)

    async def prepare(self, request: Request) -> None:
        if self.prepared:
            return
        h = request.headers
        if h.get("Upgrade", "").lower().strip() != "websocket":
            raise HTTPBadRequest(text=f'No WebSocket UPGRADE hdr: {h.get("Upgrade")}\n Can '
                                      '"Upgrade" only to "WebSocket".')
        if "upgrade" not in h.get("Connection", "").lower():
            raise HTTPBadRequest(text=f'No CONNECTION upgrade hdr: {h.get("Connection")}')
        version = h.get("Sec-WebSocket-Version", "")
        if version not in ("13", "8", "7"):
            raise HTTPBadRequest(text=f"Unsupported version: {version}")
        key = h.get("Sec-WebSocket-Key")
        try:
            if not key or len(base64.b64decode(key)) != 16:
                raise HTTPBadRequest(text=f"Handshake error: {key!r}")
        except ValueError:
            raise HTTPBadRequest(text=f"Handshake error: {key!r}") from None
        self.prepared = True
        self._reader, self._writer = request._reader, request._writer
        head = Headers({"Upgrade": "websocket", "Connection": "upgrade",
                        "Sec-WebSocket-Accept": ws_accept(key)})
        lines = ["HTTP/1.1 101 Switching Protocols"] + [f"{k}: {v}" for k, v in head.items()]
        self._writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
        await self._writer.drain()

    async def write_eof(self) -> None:
        """The handler returned: close with 1000 unless already closed."""
        if not self._closed and not self._closing and not self._writer.is_closing():
            await self._send_close(WSCloseCode.OK)

    @property
    def complete(self) -> bool:
        return False  # the connection never goes back to HTTP


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


class HTTPRequestRangeNotSatisfiable(HTTPException):
    status = 416


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
        self.canonical = re.sub(r"\{([^}:]+):[^}]*\}", r"{\1}", path)
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
                request.route = r
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
        if isinstance(resp, StreamResponse) and not resp.prepared:
            await resp.prepare(request)
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


# --- websocket client --------------------------------------------------------------------


class WSServerHandshakeError(ClientError):
    """The server refused the upgrade (aiohttp's WSServerHandshakeError)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"{status}, message={message!r}")
        self.status = status


class ClientWebSocket(_WebSocket):
    """The client side of a websocket (frames masked); the connection
    closes once the close handshake ends."""

    _mask = True

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        super().__init__()
        self._reader, self._writer = reader, writer

    def _after_close(self) -> None:
        self._writer.close()

    async def close(self, *, code: int = WSCloseCode.OK, message: bytes = b"",
                    timeout: float = 10.0) -> bool:
        try:
            return await super().close(code=code, message=message, timeout=timeout)
        finally:
            if not self._reading:
                self._writer.close()


async def ws_connect(url: str, *, timeout: float = 10.0) -> ClientWebSocket:
    """Open a websocket to ``url`` (``ws://`` or ``http://``)."""
    u = urllib.parse.urlsplit(url)
    if u.scheme not in ("ws", "http") or not u.hostname:
        raise ClientError(f"unsupported url {url!r}")
    port = u.port or 80
    target = (u.path or "/") + (f"?{u.query}" if u.query else "")
    key = base64.b64encode(os.urandom(16)).decode()
    h = Headers({"Host": u.hostname if port == 80 else f"{u.hostname}:{port}",
                 "Upgrade": "websocket", "Connection": "Upgrade",
                 "Sec-WebSocket-Key": key, "Sec-WebSocket-Version": "13",
                 "User-Agent": SERVER_NAME})
    lines = [f"GET {target} HTTP/1.1"] + [f"{k}: {v}" for k, v in h.items()]
    try:
        async with asyncio.timeout(timeout):
            reader, writer = await asyncio.open_connection(u.hostname, port)
            try:
                writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
                await writer.drain()
                first = await reader.readuntil(b"\n")
                m = _STATUS_LINE.fullmatch(first.rstrip(b"\r\n"))
                if m is None:
                    raise ClientError(f"malformed status line {first[:40]!r}")
                resp_headers = _parse_headers(await _read_lines(reader))
            except BaseException:
                writer.close()
                raise
    except (OSError, EOFError, ValueError, asyncio.IncompleteReadError) as e:
        raise ClientError(f"{type(e).__name__}: {e}") from e
    status = int(m.group(2))
    if status != 101:
        writer.close()
        raise WSServerHandshakeError(status, "Invalid response status")
    if resp_headers.get("Upgrade", "").lower() != "websocket":
        writer.close()
        raise WSServerHandshakeError(status, "Invalid upgrade header")
    if resp_headers.get("Sec-WebSocket-Accept") != ws_accept(key):
        writer.close()
        raise WSServerHandshakeError(status, "Invalid challenge response")
    return ClientWebSocket(reader, writer)
