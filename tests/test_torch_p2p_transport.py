"""The port's p2p transport against the JAX package's.

- tests/test_p2p.py's cases of the transport half pointed at
  `spacedrive_tpu_torch.p2p`: header round trips, the adaptive block
  size, the Noise stream (data, a wrong identity, records spanning a
  large payload), Spaceblock transfers with a range and a cancel, the
  tunnel, discovery by unicast beacons (the ping of that case needs
  the node's operations, which come with the node's p2p), the relay's
  identity proof and resource accounting, a raising event subscriber
  and an accept that fails after its grant;
- `Header.write` bytes equal JAX's for every `HeaderType`, trace and
  telemetry fields included, and each package reads the other's;
- mixed peers in one event loop, each way: discovery, a Spaceblock over
  a Noise stream, and relays of either package splicing a stream
  between a JAX client and a port client;
- the twins of tests/test_chaos.py's `p2p.connect` reset.

Every case runs on 127.0.0.1 under its own asyncio timeout.
"""

import asyncio
import io
import os
import types
import uuid

import pytest

import spacedrive_tpu.p2p.block as j_block
import spacedrive_tpu.p2p.identity as j_identity
import spacedrive_tpu.p2p.mdns as j_mdns
import spacedrive_tpu.p2p.p2p as j_p2p
import spacedrive_tpu.p2p.protocol as j_protocol
import spacedrive_tpu.p2p.relay as j_relay
import spacedrive_tpu.p2p.transport as j_transport
import spacedrive_tpu_torch.p2p.block as p_block
import spacedrive_tpu_torch.p2p.identity as p_identity
import spacedrive_tpu_torch.p2p.mdns as p_mdns
import spacedrive_tpu_torch.p2p.p2p as p_p2p
import spacedrive_tpu_torch.p2p.protocol as p_protocol
import spacedrive_tpu_torch.p2p.relay as p_relay
import spacedrive_tpu_torch.p2p.transport as p_transport
from spacedrive_tpu_torch.p2p import transport
from spacedrive_tpu_torch.p2p.block import (
    BlockSize,
    Range,
    SpaceblockRequest,
    SpaceblockRequests,
    Transfer,
    TransferCancelled,
)
from spacedrive_tpu_torch.p2p.identity import Identity
from spacedrive_tpu_torch.p2p.mdns import MdnsDiscovery
from spacedrive_tpu_torch.p2p.p2p import P2P
from spacedrive_tpu_torch.p2p.protocol import FileRequest, Header, HeaderType
from spacedrive_tpu_torch.p2p.tunnel import Tunnel, TunnelError
from spacedrive_tpu_torch.utils import faults

PKG = {
    name: types.SimpleNamespace(block=b, identity=i, mdns=m, p2p=p, protocol=pr, relay=r,
                                transport=t)
    for name, b, i, m, p, pr, r, t in (
        ("jax", j_block, j_identity, j_mdns, j_p2p, j_protocol, j_relay, j_transport),
        ("port", p_block, p_identity, p_mdns, p_p2p, p_protocol, p_relay, p_transport),
    )
}
MIXED = [("jax", "port"), ("port", "jax")]


def _run(coro, timeout: float = 30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class PipeStream:
    """In-memory stream for wire-format tests."""

    def __init__(self):
        self._buf = bytearray()
        self._event = asyncio.Event()
        self.written = bytearray()

    async def write(self, data: bytes) -> None:
        self._buf += data
        self.written += data
        self._event.set()

    async def read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._event.clear()
            await self._event.wait()
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


class Duplex:
    def __init__(self, rd, wr):
        self._rd, self._wr = rd, wr

    async def write(self, d):
        await self._wr.write(d)

    async def read_exact(self, n):
        return await self._rd.read_exact(n)


# --- tests/test_p2p.py's cases ------------------------------------------------


def test_header_roundtrips():
    async def run():
        reqs = SpaceblockRequests(
            id=uuid.uuid4(),
            block_size=BlockSize.from_file_size(5_000_000),
            requests=[
                SpaceblockRequest(name="a.txt", size=10),
                SpaceblockRequest(name="b.bin", size=99, range=Range(5, 50)),
            ],
        )
        cases = [
            Header(HeaderType.PING),
            Header(HeaderType.SYNC, library_id=uuid.uuid4()),
            Header(HeaderType.SYNC_REQUEST, library_id=uuid.uuid4()),
            Header(HeaderType.SPACEDROP, spacedrop=reqs),
            Header(HeaderType.FILE, file=FileRequest(uuid.uuid4(), uuid.uuid4(), Range(0, 100))),
        ]
        for h in cases:
            pipe = PipeStream()
            await h.write(pipe)
            back = await Header.read(pipe)
            assert back.type == h.type
            if h.library_id:
                assert back.library_id == h.library_id
            if h.spacedrop:
                assert back.spacedrop.to_wire() == h.spacedrop.to_wire()
            if h.file:
                assert back.file.library_id == h.file.library_id
                assert back.file.range.to_wire() == h.file.range.to_wire()

    _run(run())


def test_block_size_adaptive():
    assert BlockSize.from_file_size(0).size == BlockSize.MIN
    assert BlockSize.from_file_size(10**9).size == BlockSize.MAX
    assert BlockSize.MIN < BlockSize.from_file_size(30 * 1024 * 1024).size <= BlockSize.MAX
    with pytest.raises(ValueError):
        BlockSize.dangerously_new(BlockSize.MAX + 1)
    for size in (0, 1, 4096, 4 << 20, 33 << 20, 300 << 20, 10**10):
        assert BlockSize.from_file_size(size).size == j_block.BlockSize.from_file_size(size).size


def test_transport_handshake_and_data():
    async def run():
        server_ident, client_ident = Identity(), Identity()
        got = []

        async def on_stream(stream):
            assert stream.remote_identity == client_ident.to_remote_identity()
            got.append(await stream.read_exact(11))
            await stream.write(b"pong")

        listener = await transport.listen(server_ident, on_stream, host="127.0.0.1")
        stream = await transport.connect(
            ("127.0.0.1", listener.port), client_ident,
            expect=server_ident.to_remote_identity(),
        )
        await stream.write(b"hello world")
        assert await stream.read_exact(4) == b"pong"
        assert got == [b"hello world"]
        await stream.close()
        await listener.close()

    _run(run())


def test_transport_rejects_wrong_identity():
    async def run():
        async def on_stream(stream):  # pragma: no cover
            pass

        listener = await transport.listen(Identity(), on_stream, host="127.0.0.1")
        with pytest.raises(transport.HandshakeError):
            await transport.connect(("127.0.0.1", listener.port), Identity(),
                                    expect=Identity().to_remote_identity())
        await listener.close()

    _run(run())


def test_transport_large_payload_spans_records():
    async def run():
        payload = os.urandom(3 * transport.MAX_RECORD + 12345)

        async def on_stream(stream):
            data = await stream.read_exact(len(payload))
            await stream.write(data)
            await asyncio.sleep(0.5)  # hold until the client has read it all

        listener = await transport.listen(Identity(), on_stream, host="127.0.0.1")
        stream = await transport.connect(("127.0.0.1", listener.port), Identity())
        await stream.write(payload)
        assert await stream.read_exact(len(payload)) == payload
        await stream.close()
        await listener.close()

    _run(run())


def test_spaceblock_transfer_and_cancel():
    async def run():
        data = os.urandom(300_000)
        reqs = SpaceblockRequests(
            id=uuid.uuid4(), block_size=BlockSize(16 * 1024),
            requests=[SpaceblockRequest(name="f", size=len(data))],
        )
        a2b, b2a = PipeStream(), PipeStream()
        pcts = []
        sink = io.BytesIO()
        await asyncio.gather(
            Transfer(reqs, on_progress=pcts.append).send(Duplex(b2a, a2b), [io.BytesIO(data)]),
            Transfer(reqs).receive(Duplex(a2b, b2a), [sink]),
        )
        assert sink.getvalue() == data
        assert pcts[-1] == 100

        # partial range
        reqs2 = SpaceblockRequests(
            id=uuid.uuid4(), block_size=BlockSize(16 * 1024),
            requests=[SpaceblockRequest(name="f", size=len(data), range=Range(100, 5100))],
        )
        a2b, b2a = PipeStream(), PipeStream()
        sink2 = io.BytesIO()
        await asyncio.gather(
            Transfer(reqs2).send(Duplex(b2a, a2b), [io.BytesIO(data)]),
            Transfer(reqs2).receive(Duplex(a2b, b2a), [sink2]),
        )
        assert sink2.getvalue() == data[100:5100]

        # cancel from the receiving side at the first block
        a2b, b2a = PipeStream(), PipeStream()
        cancel = asyncio.Event()
        cancel.set()
        rx = Transfer(reqs, cancelled=cancel)
        from spacedrive_tpu_torch.utils.compat import timeout

        with pytest.raises(TransferCancelled):
            async with timeout(5):
                send_task = asyncio.ensure_future(
                    Transfer(reqs).send(Duplex(b2a, a2b), [io.BytesIO(data)]))
                try:
                    await rx.receive(Duplex(a2b, b2a), [io.BytesIO()])
                finally:
                    send_task.cancel()

    _run(run())


async def _discover(pa, a_mod, pb, b_mod):
    """Start unicast beacons between two P2Ps (listening on 127.0.0.1)
    and wait until each has discovered the other."""
    port_a = await pa.listen(host="127.0.0.1")
    port_b = await pb.listen(host="127.0.0.1")
    da = a_mod.MdnsDiscovery(pa, port_a, bind_port=0, interval=0.05, expiry=1.0)
    await da.start()
    db_ = b_mod.MdnsDiscovery(pb, port_b, bind_port=0, interval=0.05, expiry=1.0,
                              beacon_addrs=[("127.0.0.1", da.bind_port)])
    await db_.start()
    da.beacon_addrs = [("127.0.0.1", db_.bind_port)]
    for _ in range(100):
        if pa.discovered_peers() and pb.discovered_peers():
            break
        await asyncio.sleep(0.05)
    ra, rb = pa.remote_identity.to_bytes(), pb.remote_identity.to_bytes()
    assert [p.identity.to_bytes() for p in pa.discovered_peers()] == [rb]
    assert [p.identity.to_bytes() for p in pb.discovered_peers()] == [ra]


def test_discovery_and_stream():
    """tests/test_p2p.py::test_discovery_and_ping's discovery half; the
    PING header then rides a stream from `P2P.new_stream`."""

    async def run():
        a, b = P2P("spacedrive", Identity()), P2P("spacedrive", Identity())

        async def handler(stream):
            h = await Header.read(stream)
            if h.type == HeaderType.PING:
                from spacedrive_tpu_torch.p2p.wire import Writer

                w = Writer(stream)
                w.u8(0xAA)
                await w.flush()

        b.set_stream_handler(handler)
        try:
            await _discover(a, p_mdns, b, p_mdns)
            stream = await a.new_stream(b.remote_identity)
            await Header(HeaderType.PING).write(stream)
            assert await stream.read_exact(1) == b"\xaa"
            assert a.peers[b.remote_identity].is_connected
            await stream.close()
            assert not a.peers[b.remote_identity].is_connected
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run())


def test_tunnel_auth():
    async def run():
        ident_a, ident_b = Identity(), Identity()
        lib_id = uuid.uuid4()
        inst_a, inst_b = uuid.uuid4(), uuid.uuid4()
        known = {inst_a, inst_b}
        done = asyncio.Event()

        async def on_stream(stream):
            tun = await Tunnel.responder(stream, ident_b, lib_id, inst_b, known)
            assert tun.remote_instance == inst_a
            await tun.write(b"ok")
            done.set()

        listener = await transport.listen(ident_b, on_stream, host="127.0.0.1")
        stream = await transport.connect(("127.0.0.1", listener.port), ident_a)
        tun = await Tunnel.initiator(stream, ident_a, lib_id, inst_a, known)
        assert tun.remote_instance == inst_b
        assert await tun.read_exact(2) == b"ok"
        await done.wait()
        await stream.close()

        stream2 = await transport.connect(("127.0.0.1", listener.port), ident_a)
        with pytest.raises((TunnelError, asyncio.IncompleteReadError)):
            await Tunnel.initiator(stream2, ident_a, lib_id, uuid.uuid4(), known)
        await stream2.close()
        await listener.close()

    _run(run())


def test_relay_listen_requires_identity_proof():
    async def run():
        from spacedrive_tpu_torch.p2p.relay import (
            _LISTEN_CONTEXT, RelayServer, read_frame, write_frame,
        )

        relay = RelayServer()
        await relay.start()
        try:
            victim, attacker = Identity(), Identity()
            r, w = await asyncio.open_connection("127.0.0.1", relay.port)
            write_frame(w, {"cmd": "listen", "identity": str(victim.to_remote_identity()),
                            "meta": {"name": "evil"}})
            await w.drain()
            ch = await read_frame(r)
            write_frame(w, {"sig": attacker.sign(
                _LISTEN_CONTEXT + bytes.fromhex(ch["challenge"])).hex()})
            await w.drain()
            assert await read_frame(r) == {"ok": False, "error": "auth failed"}
            assert str(victim.to_remote_identity()) not in relay._listeners
            w.close()

            r, w = await asyncio.open_connection("127.0.0.1", relay.port)
            write_frame(w, {"cmd": "listen", "identity": str(victim.to_remote_identity()),
                            "meta": {"name": "victim"}})
            await w.drain()
            ch = await read_frame(r)
            write_frame(w, {"sig": victim.sign(
                _LISTEN_CONTEXT + bytes.fromhex(ch["challenge"])).hex()})
            await w.drain()
            assert (await read_frame(r)).get("ok") is True
            w.close()
        finally:
            await relay.shutdown()

    _run(run())


def test_relay_resource_accounting():
    """Per-target pipe caps (reserved at dial time, so a burst cannot
    pass them), per-pipe rate caps, and the `stats` command."""

    async def run():
        from spacedrive_tpu_torch.p2p.relay import (
            _LISTEN_CONTEXT, RelayLimits, RelayServer, read_frame, write_frame,
        )

        RATE = 256 * 1024  # bytes/s per pipe direction
        srv = RelayServer(limits=RelayLimits(
            max_pipes_per_target=2, max_pipes_total=64, pipe_rate_bytes_per_s=RATE))
        port = await srv.start()
        ident = Identity()
        b58 = str(ident.to_remote_identity())
        sunk = {"bytes": 0}
        tasks = []

        async def handle(conn):
            ar, aw = await asyncio.open_connection("127.0.0.1", port)
            write_frame(aw, {"cmd": "accept", "conn": conn})
            await aw.drain()
            if not (await read_frame(ar)).get("ok"):
                return
            mode = await ar.readexactly(1)
            while True:
                chunk = await ar.read(65536)
                if not chunk:
                    break
                if mode == b"S":
                    sunk["bytes"] += len(chunk)
                else:
                    aw.write(chunk)
                    await aw.drain()

        registered = asyncio.Event()

        async def listener():
            r, w = await asyncio.open_connection("127.0.0.1", port)
            write_frame(w, {"cmd": "listen", "identity": b58, "meta": {}})
            await w.drain()
            ch = await read_frame(r)
            write_frame(w, {"sig": ident.sign(
                _LISTEN_CONTEXT + bytes.fromhex(ch["challenge"])).hex()})
            await w.drain()
            assert (await read_frame(r)).get("ok")
            registered.set()
            while True:
                msg = await read_frame(r)
                if msg.get("event") == "incoming":
                    tasks.append(asyncio.create_task(handle(msg["conn"])))

        async def dial():
            r, w = await asyncio.open_connection("127.0.0.1", port)
            write_frame(w, {"cmd": "dial", "target": b58})
            await w.drain()
            return await read_frame(r), r, w

        lt = asyncio.create_task(listener())
        try:
            await asyncio.wait_for(registered.wait(), 5)
            resp, gr, gw = await dial()
            assert resp.get("ok"), resp
            gw.write(b"S" + b"\x00" * (4 << 20))
            greedy = asyncio.create_task(gw.drain())
            tasks.append(greedy)
            await asyncio.sleep(0.1)

            resp, er, ew = await dial()
            assert resp.get("ok"), resp
            ew.write(b"E")
            for _ in range(3):
                t0 = asyncio.get_running_loop().time()
                ew.write(b"ping-payload")
                await ew.drain()
                assert await asyncio.wait_for(er.readexactly(12), 2.0) == b"ping-payload"
                assert asyncio.get_running_loop().time() - t0 < 1.5
            assert not greedy.done() or sunk["bytes"] < (4 << 20)

            await asyncio.sleep(1.0)
            assert sunk["bytes"] <= int(2.5 * RATE) + 65536, sunk["bytes"]

            resp3, _r3, w3 = await dial()
            assert resp3 == {"ok": False, "error": "target pipe cap"}
            w3.close()
            burst = await asyncio.gather(*(dial() for _ in range(4)))
            for respN, _rN, wN in burst:
                assert respN == {"ok": False, "error": "target pipe cap"}
                wN.close()

            sr, sw = await asyncio.open_connection("127.0.0.1", port)
            write_frame(sw, {"cmd": "stats"})
            await sw.drain()
            stats = (await read_frame(sr))["stats"]
            sw.close()
            assert stats["pipes_opened"] == 2
            assert stats["pipes_active"] == 2
            assert stats["pipes_refused_target_cap"] == 5
            assert stats["bytes_relayed"] > 0
        finally:
            lt.cancel()
            for t in tasks:
                t.cancel()
            await srv.shutdown()

    _run(run())


def test_on_stream_connection_count_survives_raising_subscriber():
    async def run():
        p2p = P2P("test")
        calls = []

        def boom(event):
            calls.append(event)
            if event[0] == "PeerConnected":
                raise RuntimeError("subscriber exploded")

        p2p.events.on(boom)

        class FakeStream:
            remote_identity = "peer-a"

        with pytest.raises(RuntimeError):
            await p2p._on_stream(FakeStream())
        peer = p2p.peers["peer-a"]
        assert peer.active_connections == 0
        assert not peer.is_connected
        assert [e[0] for e in calls] == ["PeerConnected", "PeerDisconnected"]

    _run(run())


def test_relay_accept_failure_after_grant_releases_pipe_accounting():
    async def run():
        from spacedrive_tpu_torch.p2p.relay import RelayServer

        srv = RelayServer()
        srv._reserve("tgt")

        class StubWriter:
            def write(self, data):
                pass

            async def drain(self):
                pass

            def close(self):
                pass

        class BoomPipes(set):
            def update(self, *args):
                raise RuntimeError("pipe registry exploded")

        srv._pipes = BoomPipes()
        accepted = asyncio.get_running_loop().create_future()
        srv._pending["c1"] = (None, StubWriter(), accepted, "tgt")
        with pytest.raises(RuntimeError):
            await srv._serve_accept(None, StubWriter(), {"conn": "c1"})
        assert srv.stats.pipes_active == 0
        assert srv._reserved_total == 0

    _run(run())


# --- header bytes against JAX ---------------------------------------------------

LIB, FP = uuid.UUID(int=0x1234), uuid.UUID(int=0xABCDEF)
TRACE = {"trace_id": "0af7651916cd43dd8448eb211c80319c", "span_id": "b7ad6b7169203331"}


def _header(pkg: str, t: int):
    """The same header of type `t` built by either package, every field
    its type carries set."""
    b, pr = PKG[pkg].block, PKG[pkg].protocol
    ht = pr.HeaderType(t)
    if ht in (ht.SYNC, ht.SYNC_REQUEST, ht.WORK):
        return pr.Header(ht, library_id=LIB, trace=TRACE)
    if ht == ht.SPACEDROP:
        reqs = b.SpaceblockRequests(
            id=FP, block_size=b.BlockSize.from_file_size(70 << 20),
            requests=[b.SpaceblockRequest(name="a.bin", size=70 << 20),
                      b.SpaceblockRequest(name="é/b", size=9, range=b.Range(2, 7)),
                      b.SpaceblockRequest(name="c", size=0, range=b.Range(0, None))])
        return pr.Header(ht, spacedrop=reqs, trace=TRACE)
    if ht == ht.FILE:
        return pr.Header(ht, file=pr.FileRequest(LIB, FP, b.Range(100, 5000)))
    if ht == ht.TELEMETRY:
        return pr.Header(ht, trace=TRACE, telemetry_op={"op": "trace_pull",
                                                        "trace_id": TRACE["trace_id"]})
    return pr.Header(ht)


def _fields(h) -> tuple:
    return (int(h.type), h.library_id, h.spacedrop and h.spacedrop.to_wire(),
            h.file and (h.file.library_id, h.file.file_path_pub_id, h.file.range.to_wire()),
            h.trace, h.telemetry_op)


def test_header_types_equal_jax():
    assert [(t.name, int(t)) for t in p_protocol.HeaderType] == \
        [(t.name, int(t)) for t in j_protocol.HeaderType]


@pytest.mark.parametrize("t", [int(t) for t in j_protocol.HeaderType],
                         ids=[t.name for t in j_protocol.HeaderType])
def test_header_bytes_equal_jax_and_read_across(t):
    async def run():
        pipes = {}
        for pkg in ("jax", "port"):
            pipes[pkg] = PipeStream()
            await _header(pkg, t).write(pipes[pkg])
        assert bytes(pipes["port"].written) == bytes(pipes["jax"].written)
        # each package reads the other's bytes back to the same fields
        want = _fields(_header("jax", t))
        assert _fields(await p_protocol.Header.read(pipes["jax"])) == want
        assert _fields(await j_protocol.Header.read(pipes["port"])) == want

    _run(run())


# --- mixed JAX and port peers -------------------------------------------------


@pytest.mark.parametrize("a,b", MIXED)
def test_mixed_discovery(a, b):
    async def run():
        pa = PKG[a].p2p.P2P("spacedrive", PKG[a].identity.Identity())
        pb = PKG[b].p2p.P2P("spacedrive", PKG[b].identity.Identity())
        pa.metadata["name"] = "a"
        pb.metadata["name"] = "b"
        try:
            await _discover(pa, PKG[a].mdns, pb, PKG[b].mdns)
            assert pa.discovered_peers()[0].metadata == {"name": "b"}
            assert pb.discovered_peers()[0].metadata == {"name": "a"}
        finally:
            await pa.shutdown()
            await pb.shutdown()

    _run(run())


@pytest.mark.parametrize("sender,receiver", MIXED)
def test_mixed_spaceblock_over_noise(sender, receiver):
    """A SPACEDROP header with a trace and three files (a range and an
    empty file among them) from one package's `Transfer.send` to the
    other's `Transfer.receive`, over a Noise stream between them."""
    S, R = PKG[sender], PKG[receiver]
    datas = [os.urandom(300_000), os.urandom(9_000), b""]

    async def run():
        got = {}
        done = asyncio.Event()

        async def on_stream(stream):
            h = await R.protocol.Header.read(stream)
            sinks = [io.BytesIO() for _ in h.spacedrop.requests]
            await R.block.Transfer(h.spacedrop).receive(stream, sinks)
            got.update(type=h.type, trace=h.trace, id=h.spacedrop.id,
                       data=[s.getvalue() for s in sinks])
            done.set()

        listener = await R.transport.listen(R.identity.Identity(), on_stream, host="127.0.0.1")
        try:
            stream = await S.transport.connect(("127.0.0.1", listener.port),
                                               S.identity.Identity())
            reqs = S.block.SpaceblockRequests(
                id=uuid.uuid4(), block_size=S.block.BlockSize(16 * 1024),
                requests=[S.block.SpaceblockRequest(name="a", size=len(datas[0])),
                          S.block.SpaceblockRequest(name="b", size=len(datas[1]),
                                                    range=S.block.Range(1000, 8000)),
                          S.block.SpaceblockRequest(name="c", size=0)])
            pcts = []
            await S.protocol.Header(S.protocol.HeaderType.SPACEDROP, spacedrop=reqs,
                                    trace=TRACE).write(stream)
            await S.block.Transfer(reqs, on_progress=pcts.append).send(
                stream, [io.BytesIO(d) for d in datas])
            await asyncio.wait_for(done.wait(), 10)
            await stream.close()
        finally:
            await listener.close()
        assert got["data"] == [datas[0], datas[1][1000:8000], b""]
        assert (int(got["type"]), got["trace"], got["id"]) == (1, TRACE, reqs.id)
        assert pcts[-1] == 100 * (300_000 + 7_000) // (300_000 + 9_000)

    _run(run())


async def _relay_clients(server: str, dialer: str, listener: str, **kw):
    """A relay of package `server` with a registered client of each named
    package; returns when each has seen the other through the relay."""
    srv = PKG[server].relay.RelayServer()
    port = await srv.start()
    echoed = asyncio.Event()

    async def on_stream(stream):
        data = await stream.read_exact(7)
        await stream.write(data[::-1])
        echoed.set()

    out = [srv, echoed]
    for pkg in (dialer, listener):
        p = PKG[pkg].p2p.P2P("sdx")
        rc = PKG[pkg].relay.RelayClient(p, ("127.0.0.1", port), on_stream,
                                        query_interval=0.1, **kw)
        await rc.start()
        out += [p, rc]
    _, _, a, _, b, _ = out
    ida = PKG[listener].identity.RemoteIdentity(a.remote_identity.to_bytes())
    idb = PKG[dialer].identity.RemoteIdentity(b.remote_identity.to_bytes())
    for _ in range(100):
        pa, pb = a.peers.get(idb), b.peers.get(ida)
        if pa is not None and pa.relayed and pb is not None and pb.relayed:
            return out
        await asyncio.sleep(0.05)
    raise TimeoutError("relay clients never saw each other")


@pytest.mark.parametrize("server,dialer,listener", [
    ("jax", "port", "port"), ("jax", "port", "jax"), ("jax", "jax", "port"),
    ("port", "jax", "jax"), ("port", "port", "jax"), ("port", "jax", "port"),
])
def test_mixed_relay_splice(server, dialer, listener):
    """A stream from `P2P.new_stream` falls back to the relay (the peer
    has no direct address) and runs Noise end to end through the splice
    of a relay of either package, between clients of either package."""

    async def run():
        srv, echoed, a, ra, b, rb = await _relay_clients(server, dialer, listener, punch=False)
        try:
            target = PKG[dialer].identity.RemoteIdentity(b.remote_identity.to_bytes())
            stream = await a.new_stream(target, timeout=10)
            assert not getattr(stream, "direct", False)
            assert stream.remote_identity.to_bytes() == b.remote_identity.to_bytes()
            await stream.write(b"relayed")
            assert await asyncio.wait_for(stream.read_exact(7), 10) == b"deyaler"
            await asyncio.wait_for(echoed.wait(), 5)
            await stream.close()
            assert srv.stats.pipes_opened == 1
            assert srv.stats.bytes_relayed > 0
        finally:
            await ra.shutdown()
            await rb.shutdown()
            await srv.shutdown()
            await a.shutdown()
            await b.shutdown()

    _run(run())


# --- tests/test_chaos.py's p2p.connect twin -------------------------------------


def test_p2p_connect_reset_fault():
    async def run():
        p = P2P("chaos-test")
        with faults.active(faults.FaultPlan.parse("p2p.connect:reset:times=1")) as plan:
            with pytest.raises(ConnectionResetError):
                await p.new_stream(p.remote_identity)
            # times=1: the next dial gets past the fault point (and finds
            # no route to an undiscovered peer)
            with pytest.raises(ConnectionError) as exc:
                await p.new_stream(p.remote_identity)
            assert not isinstance(exc.value, ConnectionResetError)
            assert plan.activations() == {"p2p.connect": 1}

    _run(run())
