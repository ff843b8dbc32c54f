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

Every socket binds 127.0.0.1; every case runs under its own timeout.
"""

import asyncio
import json
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
