"""The port's own HTTP/1.1 layer (spacedrive_tpu_torch/utils/http.py).

- its server and client together: routes by method and path, `{name}`
  and `{name:regex}` captures, query strings, JSON bodies, keep-alive
  (one connection for many requests), a middleware chain, a streamed
  response (declared length and chunked), HEAD, and `ClientError` on a
  refused connection, a reset, a malformed status line and a body
  shorter than its Content-Length;
- mixed pairs, where `aiohttp` is installed: the port's client against
  an `aiohttp.web` app and an `aiohttp` client against the port's
  server, each app built from the same handlers. An unknown route, a
  known route under another method, a bad JSON body, a missing field, a
  handler that raises and a raised 400/404 answer the same status and
  body from either server to either client.

Websockets and files (the API host's layer):

- the port's websocket server and client together: the handshake's
  `Sec-WebSocket-Accept` (RFC 6455's own example), text and binary
  messages, a message fragmented across frames, frames of 125, 126,
  65,535 and 65,536 bytes (each length form), pings answered, the close
  handshake with the code echoed, the 400 bodies for a request that is
  no upgrade, a frame with its reserved bits set closed with 1002;
- `FileResponse` against `aiohttp.web.FileResponse` on one file: status,
  body, `Content-Range`, `Accept-Ranges`, `ETag` and `Last-Modified` for
  every `Range` form, `If-None-Match` / `If-Modified-Since` (304),
  `If-Match` (412), `If-Range`, HEAD, a missing file and a directory;
- mixed websocket pairs: `aiohttp`'s client (masked frames, its close
  handshake) against the port's server, and the port's client against
  an `aiohttp.web` websocket handler, the same echo both ways.

Every socket binds 127.0.0.1; every case runs under its own timeout.
"""

import asyncio
import base64
import json
import os
import socket
import struct

import pytest

from spacedrive_tpu_torch.utils import http


def _run(coro, timeout: float = 30.0):
    async def bounded():
        async with asyncio.timeout(timeout):
            return await coro

    return asyncio.run(bounded())


# --- one set of handlers, for either framework -----------------------------------------


def _handlers(web):
    """The same routes on `web` (the port's http module or aiohttp.web)."""

    async def echo(request):
        body = await request.json()
        return web.json_response({"got": body, "q": dict(request.query)})

    async def item(request):
        return web.json_response({"id": request.match_info["id"], "path": request.path})

    async def need_field(request):
        body = await request.json()
        return web.json_response({"uuid": body["uuid"]})

    async def boom(request):
        raise RuntimeError("boom")

    async def missing(request):
        raise web.HTTPNotFound(text="library")

    async def bad(request):
        raise web.HTTPBadRequest(text="unknown instance")

    async def listing(request):
        return web.json_response([{"a": 1}, {"b": "x y"}])

    return [
        web.post("/echo", echo),
        web.get("/items/{id}", item),
        web.post("/need", need_field),
        web.get("/boom", boom),
        web.get("/missing", missing),
        web.get("/bad", bad),
        web.get("/list", listing),
    ]


async def _port_server(middlewares=()):
    app = http.Application(middlewares=middlewares)
    app.add_routes(_handlers(http))
    srv = http.Server(app)
    port = await srv.start()
    return srv, port


# --- the owned server and client -------------------------------------------------------


def test_routes_captures_queries_json_and_keepalive():
    async def run():
        srv, port = await _port_server()
        peers = []
        orig = srv._serve

        async def counting(reader, writer):
            peers.append(writer.get_extra_info("peername"))
            await orig(reader, writer)

        srv._server.close()
        await srv._server.wait_closed()
        srv._server = await asyncio.start_server(counting, "127.0.0.1", port)
        client = http.HttpClient()
        base = f"http://127.0.0.1:{port}"
        try:
            r = await client.request("POST", f"{base}/echo?a=1&b=x%20y&a=2", json={"k": [1, 2]})
            assert r.status == 200 and r.content_type == "application/json"
            assert r.json() == {"got": {"k": [1, 2]}, "q": {"a": "1", "b": "x y"}}
            r = await client.request("GET", f"{base}/items/a%20b")
            assert r.json() == {"id": "a b", "path": "/items/a b"}
            r = await client.request("GET", f"{base}/list")
            assert r.body == b'[{"a": 1}, {"b": "x y"}]'
            r = await client.request("HEAD", f"{base}/list")
            assert r.status == 200 and r.body == b""
            assert r.headers["Content-Length"] == str(len(b'[{"a": 1}, {"b": "x y"}]'))
            r = await client.request("GET", f"{base}/nope")
            assert (r.status, r.body) == (404, b"404: Not Found")
            r = await client.request("GET", f"{base}/echo")
            assert (r.status, r.body, r.headers["Allow"]) == (405, b"405: Method Not Allowed",
                                                                "POST")
            r = await client.request("GET", f"{base}/missing")
            assert (r.status, r.text()) == (404, "library")
            # every request above rode one keep-alive connection
            assert len(peers) == 1
            # a raising handler answers 500 and closes; the next request
            # takes a fresh connection
            r = await client.request("GET", f"{base}/boom")
            assert r.status == 500 and r.headers["Connection"] == "close"
            r = await client.request("GET", f"{base}/list")
            assert r.status == 200 and len(peers) == 2
        finally:
            await client.close()
            await srv.shutdown()

    _run(run())


def test_regex_capture_and_middleware_order():
    async def run():
        seen = []

        async def outer(request, handler):
            seen.append("outer")
            resp = await handler(request)
            resp.headers["X-Outer"] = "1"
            return resp

        async def inner(request, handler):
            seen.append("inner")
            if request.query.get("deny"):
                raise http.HTTPForbidden(text="bad host")
            return await handler(request)

        async def static(request):
            return http.Response(text=request.match_info["path"])

        app = http.Application(middlewares=[outer, inner])
        app.add_routes([http.get("/static/{path:.*}", static)])
        srv = http.Server(app)
        port = await srv.start()
        client = http.HttpClient()
        try:
            r = await client.request("GET", f"http://127.0.0.1:{port}/static/a/b%2Fc.js")
            assert (r.status, r.text(), r.headers["X-Outer"]) == (200, "a/b/c.js", "1")
            assert seen == ["outer", "inner"]
            r = await client.request("GET", f"http://127.0.0.1:{port}/static/x?deny=1")
            assert (r.status, r.text()) == (403, "bad host")
            # middlewares see unknown routes too, as aiohttp's do
            r = await client.request("GET", f"http://127.0.0.1:{port}/other?deny=1")
            assert (r.status, r.text()) == (403, "bad host")
        finally:
            await client.close()
            await srv.shutdown()

    _run(run())


def test_streamed_responses_chunked_and_truncated():
    async def run():
        async def chunks(request):
            out = http.StreamResponse()
            await out.prepare(request)
            for part in (b"abc", b"", b"defgh", b"i" * 5000):
                await out.write(part)
            return out

        async def declared(request):
            out = http.StreamResponse(status=201)
            out.content_length = 6
            await out.prepare(request)
            await out.write(b"abc")
            await out.write(b"def")
            return out

        async def truncated(request):
            out = http.StreamResponse()
            out.content_length = 10
            await out.prepare(request)
            await out.write(b"12345")
            request.transport.close()
            return out

        app = http.Application()
        app.add_routes([http.get("/chunks", chunks), http.get("/declared", declared),
                        http.get("/truncated", truncated)])
        srv = http.Server(app)
        port = await srv.start()
        client = http.HttpClient()
        base = f"http://127.0.0.1:{port}"
        try:
            r = await client.request("GET", f"{base}/chunks")
            assert r.headers["Transfer-Encoding"] == "chunked"
            assert r.body == b"abcdefgh" + b"i" * 5000
            r = await client.request("GET", f"{base}/declared")
            assert (r.status, r.body) == (201, b"abcdef")
            with pytest.raises(http.ClientError, match="5 of 10"):
                await client.request("GET", f"{base}/truncated")
            # the client recovers on a fresh connection
            assert (await client.request("GET", f"{base}/declared")).body == b"abcdef"
        finally:
            await client.close()
            await srv.shutdown()

    _run(run())


def test_request_bodies_chunked_and_too_large():
    async def run():
        srv, port = await _port_server()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            body = json.dumps({"k": "v" * 100}).encode()
            writer.write(b"POST /echo HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n"
                         + b"%x\r\n" % 10 + body[:10] + b"\r\n"
                         + b"%x\r\n" % (len(body) - 10) + body[10:] + b"\r\n0\r\n\r\n")
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            n = int([ln for ln in head.split(b"\r\n") if ln.startswith(b"Content-Length")][0]
                    .split(b":")[1])
            assert json.loads(await reader.readexactly(n))["got"] == {"k": "v" * 100}
            writer.close()
            client = http.HttpClient()
            r = await client.request("POST", f"http://127.0.0.1:{port}/echo",
                                     data=b"[" + b"1," * (http.CLIENT_MAX_SIZE // 2) + b"1]")
            assert r.status == 413 and r.text().startswith(
                f"Maximum request body size {http.CLIENT_MAX_SIZE} exceeded")
            await client.close()
        finally:
            await srv.shutdown()

    _run(run())


async def _raw_server(answer):
    """A listener whose every connection gets `answer(reader, writer)`."""
    async def serve(reader, writer):
        await reader.readuntil(b"\r\n\r\n")
        await answer(reader, writer)

    srv = await asyncio.start_server(serve, "127.0.0.1", 0)
    return srv, srv.sockets[0].getsockname()[1]


async def _reset(reader, writer):
    sock = writer.get_extra_info("socket")
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    writer.transport.abort()


async def _malformed(reader, writer):
    writer.write(b"HTTP/9 200 fine\r\n\r\n")
    await writer.drain()
    writer.close()


async def _short(reader, writer):
    writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                 b"Content-Length: 10\r\n\r\n{\"a\":")
    await writer.drain()
    writer.close()


async def _silent(reader, writer):
    writer.close()


@pytest.mark.parametrize("answer,match", [
    (_reset, "Reset|Incomplete|disconnected"),
    (_malformed, "malformed status line"),
    (_short, "5 of 10"),
    (_silent, "disconnected"),
], ids=["reset", "malformed_status", "short_body", "closed_without_answer"])
def test_transport_failures_raise_client_error(answer, match):
    async def run():
        srv, port = await _raw_server(answer)
        client = http.HttpClient()
        try:
            with pytest.raises(http.ClientError, match=match):
                await client.request("GET", f"http://127.0.0.1:{port}/x")
        finally:
            await client.close()
            srv.close()
            await srv.wait_closed()

    _run(run())


def test_refused_connection_raises_client_error():
    async def run():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()  # nothing listens there now
        client = http.HttpClient()
        with pytest.raises(http.ClientError, match="cannot connect"):
            await client.request("GET", f"http://127.0.0.1:{port}/")
        await client.close()

    _run(run())


def test_json_of_a_non_json_body_is_a_client_error():
    resp = http.ClientResponse(200, "OK", http.Headers({"Content-Type": "text/plain"}), b"{}")
    with pytest.raises(http.ClientError, match="unexpected mimetype"):
        resp.json()
    ok = http.ClientResponse(200, "OK", http.Headers(
        {"Content-Type": "application/vnd.api+json; charset=utf-8"}), b'{"a": 1}')
    assert ok.json() == {"a": 1}
    assert http.ClientResponse(200, "OK", http.Headers(), b"  ").json() is None


def test_shutdown_ends_open_and_busy_connections():
    async def run():
        started = asyncio.Event()

        async def slow(request):
            started.set()
            await asyncio.sleep(60)
            return http.Response(text="late")

        app = http.Application()
        app.add_routes([http.get("/slow", slow)])
        srv = http.Server(app)
        port = await srv.start()
        client = http.HttpClient()
        pending = asyncio.ensure_future(client.request("GET", f"http://127.0.0.1:{port}/slow"))
        await started.wait()
        idle = await asyncio.open_connection("127.0.0.1", port)
        await srv.shutdown()
        with pytest.raises(http.ClientError):
            await pending
        assert await idle[0].read() == b""
        idle[1].close()
        await client.close()

    _run(run(), timeout=10.0)


# --- mixed pairs: the port against aiohttp ---------------------------------------------


MIXED_CASES = [
    ("GET", "/nope", None, None),               # unknown route
    ("GET", "/echo", None, None),               # known route, other method
    ("POST", "/echo", None, b"{bad}"),          # bad JSON
    ("POST", "/echo", None, b""),               # no body where JSON is read
    ("POST", "/need", {}, None),                # a missing field
    ("POST", "/need", [], None),                # the wrong JSON shape
    ("GET", "/boom", None, None),               # a handler that raises
    ("GET", "/missing", None, None),            # a raised 404 with text
    ("GET", "/bad", None, None),                # a raised 400 with text
    ("POST", "/echo", {"k": [1, "x"]}, None),   # and one that works
    ("GET", "/items/a%20b", None, None),
]


@pytest.mark.parametrize("method,path,body,data", MIXED_CASES,
                         ids=[f"{m} {p} {b!r:.10} {d!r:.10}" for m, p, b, d in MIXED_CASES])
def test_mixed_pairs_answer_alike(method, path, body, data):
    aiohttp = pytest.importorskip("aiohttp")
    from aiohttp import web

    async def run():
        app = web.Application()
        app.add_routes(_handlers(web))
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        aio_port = site._server.sockets[0].getsockname()[1]
        srv, port = await _port_server()
        ours = http.HttpClient()
        try:
            seen = {}
            async with aiohttp.ClientSession() as theirs:
                for server, p in (("aiohttp", aio_port), ("port", port)):
                    url = f"http://127.0.0.1:{p}{path}"
                    async with theirs.request(method, url, json=body, data=data) as r:
                        seen[(server, "aiohttp")] = (r.status, await r.read())
                    r = await ours.request(method, url, json=body, data=data)
                    seen[(server, "port")] = (r.status, r.body)
            assert len(set(seen.values())) == 1, seen
        finally:
            await ours.close()
            await srv.shutdown()
            await runner.cleanup()

    _run(run())


# --- websockets ------------------------------------------------------------------------


def _ws_handlers(web, msg_type):
    """An echo websocket on `web` (the port's http module or aiohttp.web):
    text back as "echo:" + text, binary back reversed, "close" closes
    with 4000 from the server."""

    async def ws_echo(request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        async for msg in ws:
            if msg.type == msg_type.TEXT:
                if msg.data == "close":
                    await ws.close(code=4000, message=b"bye")
                    break
                await ws.send_str("echo:" + msg.data)
            elif msg.type == msg_type.BINARY:
                await ws.send_bytes(msg.data[::-1])
        return ws

    return [web.get("/ws", ws_echo)]


async def _port_ws_server():
    app = http.Application()
    app.add_routes(_ws_handlers(http, http.WSMsgType))
    srv = http.Server(app)
    return srv, await srv.start()


def test_ws_accept_is_the_rfc_example():
    assert http.ws_accept("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


@pytest.mark.parametrize("size", [0, 125, 126, 65535, 65536, 300_000])
def test_ws_round_trip_every_length_form(size):
    async def run():
        srv, port = await _port_ws_server()
        ws = await http.ws_connect(f"ws://127.0.0.1:{port}/ws")
        try:
            text = "x" * size
            await ws.send_str(text)
            msg = await ws.receive(timeout=10)
            assert (msg.type, msg.data) == (http.WSMsgType.TEXT, "echo:" + text)
            blob = os.urandom(size)
            await ws.send_bytes(blob)
            msg = await ws.receive(timeout=10)
            assert (msg.type, msg.data) == (http.WSMsgType.BINARY, blob[::-1])
            assert await ws.close() is True
            assert ws.close_code == 1000 and ws.closed
            assert (await ws.receive()).type == http.WSMsgType.CLOSED
        finally:
            await srv.shutdown()

    _run(run())


def test_ws_fragments_pings_and_server_close():
    async def run():
        srv, port = await _port_ws_server()
        ws = await http.ws_connect(f"http://127.0.0.1:{port}/ws")
        try:
            # one text message in three frames, a ping between them
            w = ws._writer
            w.write(http._ws_frame(0x1, b"fr", True, fin=False))
            w.write(http._ws_frame(0x9, b"p!", True))
            w.write(http._ws_frame(0x0, "ag\u00e9".encode(), True, fin=False))
            w.write(http._ws_frame(0x0, b"ment", True))
            await w.drain()
            # the pong comes back first (the server answers pings inline)
            fin, opcode, payload = await http._ws_read_frame(ws._reader, 1 << 20)
            assert (fin, opcode, payload) == (True, 0xA, b"p!")
            msg = await ws.receive(timeout=10)
            assert msg.data == "echo:fragment".replace("fragment", "frag\u00e9ment")
            await ws.send_str("close")
            msg = await ws.receive(timeout=10)
            assert (msg.type, msg.data, msg.extra) == (http.WSMsgType.CLOSE, 4000, "bye")
            assert ws.close_code == 4000
        finally:
            await srv.shutdown()

    _run(run())


def test_ws_refusals_answer_as_aiohttp():
    async def run():
        srv, port = await _port_ws_server()
        client = http.HttpClient()
        try:
            base = f"http://127.0.0.1:{port}/ws"
            r = await client.request("GET", base)
            assert (r.status, r.text()) == (400, 'No WebSocket UPGRADE hdr: None\n Can '
                                                 '"Upgrade" only to "WebSocket".')
            r = await client.request("GET", base, headers={"Upgrade": "websocket"})
            assert (r.status, r.text()) == (400, "No CONNECTION upgrade hdr: None")
            r = await client.request("GET", base, headers={
                "Upgrade": "websocket", "Connection": "Upgrade", "Sec-WebSocket-Version": "12"})
            assert (r.status, r.text()) == (400, "Unsupported version: 12")
            r = await client.request("GET", base, headers={
                "Upgrade": "websocket", "Connection": "Upgrade", "Sec-WebSocket-Version": "13",
                "Sec-WebSocket-Key": "c2hvcnQ="})
            assert (r.status, r.text()) == (400, "Handshake error: 'c2hvcnQ='")
            with pytest.raises(http.WSServerHandshakeError):
                await http.ws_connect(f"ws://127.0.0.1:{port}/nope")
            # a frame with a reserved bit set: the server closes with 1002
            ws = await http.ws_connect(base)
            ws._writer.write(bytes([0xC1, 0x80]) + b"\x00" * 4)
            await ws._writer.drain()
            msg = await ws.receive(timeout=10)
            assert (msg.type, msg.data) == (http.WSMsgType.CLOSE, 1002)
        finally:
            await client.close()
            await srv.shutdown()

    _run(run())


def test_ws_mixed_pairs_echo_alike():
    aiohttp = pytest.importorskip("aiohttp")
    from aiohttp import web

    async def run():
        app = web.Application()
        app.add_routes(_ws_handlers(web, aiohttp.WSMsgType))
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        aio_port = site._server.sockets[0].getsockname()[1]
        srv, port = await _port_ws_server()
        seen = {}
        try:
            async with aiohttp.ClientSession() as session:
                for server, p in (("aiohttp", aio_port), ("port", port)):
                    url = f"http://127.0.0.1:{p}/ws"
                    got = []
                    async with session.ws_connect(url) as ws:
                        for text in ("a", "b" * 70_000):
                            await ws.send_str(text)
                            got.append((await ws.receive(timeout=10)).data)
                        await ws.send_bytes(b"xyz")
                        got.append((await ws.receive(timeout=10)).data)
                        await ws.send_str("close")
                        msg = await ws.receive(timeout=10)
                        got.append((int(msg.type), msg.data, msg.extra))
                    seen[(server, "aiohttp")] = got
                    ws = await http.ws_connect(url)
                    got = []
                    for text in ("a", "b" * 70_000):
                        await ws.send_str(text)
                        got.append((await ws.receive(timeout=10)).data)
                    await ws.send_bytes(b"xyz")
                    got.append((await ws.receive(timeout=10)).data)
                    await ws.send_str("close")
                    msg = await ws.receive(timeout=10)
                    got.append((int(msg.type), msg.data, msg.extra))
                    seen[(server, "port")] = got
                    ws2 = await http.ws_connect(url)
                    await ws2.send_str("a")
                    assert (await ws2.receive(timeout=10)).data == "echo:a"
                    assert await ws2.close() and ws2.close_code == 1000
            assert len({json.dumps(v, default=repr) for v in seen.values()}) == 1, seen
            assert seen[("port", "port")][-1] == (8, 4000, "bye")
        finally:
            await srv.shutdown()
            await runner.cleanup()

    _run(run())


# --- files -----------------------------------------------------------------------------


FILE_CASES = [
    {}, {"Range": "bytes=0-99"}, {"Range": "bytes=100-"}, {"Range": "bytes=-100"},
    {"Range": "bytes=-99999"}, {"Range": "bytes=4999-9999"}, {"Range": "bytes=5000-"},
    {"Range": "bytes=9-3"}, {"Range": "bytes=a-b"}, {"Range": "bytes=0-1,4-5"},
    {"If-None-Match": "ETAG"}, {"If-None-Match": '"nope", ETAG'}, {"If-None-Match": "*"},
    {"If-Match": '"nope"'}, {"If-Match": "ETAG"},
    {"If-Modified-Since": "Fri, 01 Jan 2100 00:00:00 GMT"},
    {"If-Modified-Since": "Thu, 01 Jan 1970 00:00:00 GMT"},
    {"If-Unmodified-Since": "Thu, 01 Jan 1970 00:00:00 GMT"},
    {"If-Range": "Fri, 01 Jan 2100 00:00:00 GMT", "Range": "bytes=0-9"},
    {"If-Range": "Thu, 01 Jan 1970 00:00:00 GMT", "Range": "bytes=0-9"},
]


@pytest.mark.parametrize("method", ["GET", "HEAD"])
def test_file_response_answers_as_aiohttp(tmp_path, method):
    aiohttp = pytest.importorskip("aiohttp")
    from aiohttp import web

    data = os.urandom(5000)
    path = tmp_path / "blob.bin"
    path.write_bytes(data)
    (tmp_path / "dir").mkdir()

    def handlers(mod):
        async def blob(request):
            return mod.FileResponse(str(path), headers={"Content-Type": "application/x-sd"})

        async def plain(request):
            return mod.FileResponse(str(path))

        async def gone(request):
            return mod.FileResponse(str(tmp_path / "missing.bin"))

        async def folder(request):
            return mod.FileResponse(str(tmp_path / "dir"))

        return [mod.get("/blob", blob), mod.get("/plain", plain), mod.get("/gone", gone),
                mod.get("/dir", folder)]

    async def run():
        app = web.Application()
        app.add_routes(handlers(web))
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        aio_port = site._server.sockets[0].getsockname()[1]
        papp = http.Application()
        papp.add_routes(handlers(http))
        srv = http.Server(papp)
        port = await srv.start()
        client = http.HttpClient()
        try:
            etag = (await client.request("GET", f"http://127.0.0.1:{aio_port}/blob")
                    ).headers["ETag"]
            for route in ("/blob", "/plain", "/gone", "/dir"):
                for case in FILE_CASES:
                    headers = {k: v.replace("ETAG", etag) for k, v in case.items()}
                    seen = {}
                    for server, p in (("aiohttp", aio_port), ("port", port)):
                        r = await client.request(method, f"http://127.0.0.1:{p}{route}",
                                                 headers=headers)
                        heads = {h: r.headers.get(h) for h in (
                            "Content-Type", "Content-Range", "Accept-Ranges", "ETag",
                            "Last-Modified")}
                        if r.status in (200, 206):
                            heads["Content-Length"] = r.headers.get("Content-Length")
                        seen[server] = (r.status, heads, r.body)
                    assert seen["port"] == seen["aiohttp"], (route, case)
            r = await client.request(method, f"http://127.0.0.1:{port}/blob",
                                     headers={"Range": "bytes=-100"})
            assert r.status == 206 and r.body == (data[-100:] if method == "GET" else b"")
        finally:
            await client.close()
            await srv.shutdown()
            await runner.cleanup()

    _run(run())


def test_request_range_and_body_properties():
    """`http_range` and `can_read_body` read as aiohttp's request's."""
    aiohttp = pytest.importorskip("aiohttp")
    from aiohttp.test_utils import make_mocked_request

    for rng in (None, "bytes=0-9", "bytes=5-", "bytes=-7", "bytes=9-3", "bytes=x", "bytes=-",
                "bytes=0-1,2-3", "items=1-2"):
        headers = {"Range": rng} if rng else {}
        theirs = make_mocked_request("GET", "/", headers=headers)
        ours = http.Request("GET", "/", "HTTP/1.1", http.Headers(headers), None, _Writer())
        try:
            want = theirs.http_range
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                ours.http_range
        else:
            assert ours.http_range == want, rng
    for headers, want in (({}, False), ({"Content-Length": "0"}, False),
                          ({"Content-Length": "3"}, True),
                          ({"Transfer-Encoding": "chunked"}, True)):
        ours = http.Request("POST", "/", "HTTP/1.1", http.Headers(headers), None, _Writer())
        assert ours.can_read_body is want, headers


class _Writer:
    transport = None

    def get_extra_info(self, name):
        return None
