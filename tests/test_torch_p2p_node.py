"""The node's p2p in the port: twins of the JAX package's gates.

- tests/test_p2p.py's node cases pointed at `spacedrive_tpu_torch`:
  discovery and ping, Spacedrop between nodes (accept and reject),
  library pairing over the mesh, transitive sync through a hub, two-node
  sync with a file request and remote rspc (the HTTP custom-URI leg
  waits for the API server), Spacedrop over the relay's splice, and the
  relay wired from the node config;
- tests/test_punch.py's Spacedrop over a punched path (and its bulk
  twin, `slow` as JAX's);
- tests/test_chaos.py's retryable pull failure and the `p2p.sync_serve`
  vanish;
- a library member's WORK stream answered as JAX's `respond_work`
  answers on a node whose work plane is not running.

Port Nodes run on the CPU; every case binds 127.0.0.1 with unicast
beacons, runs under its own asyncio timeout and shuts its nodes down in
`finally`.
"""

import asyncio
import io
import os
import time
import uuid

import pytest

from spacedrive_tpu_torch.p2p.identity import Identity
from spacedrive_tpu_torch.p2p.mdns import MdnsDiscovery
from spacedrive_tpu_torch.p2p.operations import ping, request_file
from spacedrive_tpu_torch.p2p.p2p import P2P
from spacedrive_tpu_torch.p2p.protocol import Header, HeaderType
from spacedrive_tpu_torch.p2p.relay import RelayClient, RelayServer
from spacedrive_tpu_torch.telemetry.events import ring
from spacedrive_tpu_torch.utils import faults

from test_torch_punch import NattedEndpoint


def _run(coro, timeout: float = 90.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _make_node(tmp_path, name, beacon_addrs=None):
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.p2p.manager import P2PManager

    node = Node(os.path.join(tmp_path, name), device="cpu", with_labeler=False)
    node.config.config.p2p.enabled = False  # start p2p by hand on loopback
    node.config.config.name = name
    await node.start()
    node.p2p = P2PManager(node, beacon_addrs=beacon_addrs or [], bind_host="127.0.0.1")
    return node


async def _link(node_a, node_b):
    """Start both managers and point their beacons at each other."""
    for n in (node_a, node_b):
        n.p2p._beacon_addrs = [("127.0.0.1", 1)]  # placeholder, fixed below
    await node_a.p2p.start()
    await node_b.p2p.start()
    da = node_a.p2p.p2p._discovery[0]
    db_ = node_b.p2p.p2p._discovery[0]
    da.beacon_addrs = [("127.0.0.1", db_.bind_port)]
    db_.beacon_addrs = [("127.0.0.1", da.bind_port)]
    da.interval = db_.interval = 0.05
    for _ in range(200):
        if node_a.p2p.p2p.discovered_peers() and node_b.p2p.p2p.discovered_peers():
            return
        await asyncio.sleep(0.05)
    raise TimeoutError("nodes never discovered each other")


def _offers(node, kind):
    got = []
    node.event_bus.on(lambda ev: got.append(ev[1])
                      if isinstance(ev, tuple) and ev and ev[0] == kind else None)
    return got


async def _answer(got, answer, tries=200):
    for _ in range(tries):
        if got:
            answer(got[0].id)
            return
        await asyncio.sleep(0.05)
    raise TimeoutError("no offer arrived")


async def _scan(lib, node, corpus):
    from spacedrive_tpu_torch.location.locations import LocationCreateArgs, scan_location
    from spacedrive_tpu_torch.sync.ingest import backfill_operations

    loc = LocationCreateArgs(path=corpus).create(lib)
    backfill_operations(lib.sync)
    await scan_location(lib, loc, node.jobs, backend="cpu")
    await node.jobs.wait_idle()
    return loc


def _corpus(root, prefix, sizes):
    os.makedirs(root)
    blobs = {}
    for i, size in enumerate(sizes):
        blobs[f"{prefix}{i}.bin"] = data = os.urandom(size)
        with open(os.path.join(root, f"{prefix}{i}.bin"), "wb") as f:
            f.write(data)
    return blobs


def _cas(lib):
    return {r["name"]: r["cas_id"] for r in lib.db.query(
        "SELECT name, cas_id FROM file_path WHERE is_dir = 0")}


def test_discovery_and_ping():
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
            port_a = await a.listen(host="127.0.0.1")
            port_b = await b.listen(host="127.0.0.1")
            da = MdnsDiscovery(a, port_a, bind_port=0, interval=0.05, expiry=1.0)
            await da.start()
            db_ = MdnsDiscovery(b, port_b, bind_port=0, beacon_addrs=[("127.0.0.1", da.bind_port)],
                                interval=0.05, expiry=1.0)
            await db_.start()
            da.beacon_addrs = [("127.0.0.1", db_.bind_port)]
            for _ in range(100):
                if a.discovered_peers() and b.discovered_peers():
                    break
                await asyncio.sleep(0.05)
            assert any(p.identity == b.remote_identity for p in a.discovered_peers())
            assert any(p.identity == a.remote_identity for p in b.discovered_peers())
            assert await ping(a, b.remote_identity) < 5.0
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run(), 30)


def test_spacedrop_between_nodes(tmp_path):
    async def run():
        a = await _make_node(tmp_path, "alpha")
        b = await _make_node(tmp_path, "beta")
        try:
            await _link(a, b)
            src = os.path.join(tmp_path, "gift.bin")
            payload = os.urandom(123_456)
            with open(src, "wb") as f:
                f.write(payload)
            dest = os.path.join(tmp_path, "inbox")
            offers = _offers(b, "SpacedropRequest")
            ident = b.p2p.p2p.remote_identity
            drop_id, _ = await asyncio.gather(
                a.p2p.spacedrop.send(ident.__class__(ident.to_bytes()), [src]),
                _answer(offers, lambda i: b.p2p.spacedrop.accept(i, dest)),
            )
            with open(os.path.join(dest, "gift.bin"), "rb") as f:
                assert f.read() == payload
            assert offers[0].files == ["gift.bin"]
            assert a.p2p.spacedrop.progress[drop_id] == 100

            offers.clear()
            with pytest.raises(PermissionError):
                await asyncio.gather(
                    a.p2p.spacedrop.send(b.p2p.p2p.remote_identity, [src]),
                    _answer(offers, b.p2p.spacedrop.reject),
                )
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run())


def test_library_pairing_over_mesh(tmp_path):
    """Beta pairs into alpha's library over the mesh (consent on alpha),
    then sync converges the data; a second join of it fails cleanly."""

    async def run():
        a = await _make_node(tmp_path, "alpha")
        b = await _make_node(tmp_path, "beta")
        try:
            lib_a = await a.create_library("family-photos")
            corpus = os.path.join(tmp_path, "corpus")
            _corpus(corpus, "pic", [1500, 1501, 1502])
            await _scan(lib_a, a, corpus)
            await _link(a, b)

            offers = _offers(a, "PairingRequest")
            arg = {"identity": str(a.p2p.p2p.remote_identity), "library_id": str(lib_a.id)}
            lib_b_id, _ = await asyncio.gather(
                b.router.exec(b, "p2p.pairLibrary", arg),
                _answer(offers, a.p2p.pairing.accept, 100),
            )
            assert lib_b_id == str(lib_a.id)
            lib_b = b.libraries.get(lib_a.id)
            assert lib_b is not None and lib_b.name == "family-photos"
            assert lib_a.db.count("instance") == 2 and lib_b.db.count("instance") == 2

            for _ in range(200):
                await a.p2p._alert_peers(lib_a.id)
                if lib_b.db.count("file_path") == lib_a.db.count("file_path"):
                    break
                await asyncio.sleep(0.1)
            assert lib_b.db.count("file_path") == lib_a.db.count("file_path")
            assert lib_b.db.count("location") == 1
            with pytest.raises(Exception):
                await b.router.exec(b, "p2p.pairLibrary", arg)
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run())


def test_three_node_transitive_sync_via_hub(tmp_path):
    """A ↔ hub ↔ B with no direct A–B link: A's ops reach B through the
    hub (alert-on-ingest and third-party op serving)."""

    async def run():
        a = await _make_node(tmp_path, "alpha")
        hub = await _make_node(tmp_path, "hub")
        b = await _make_node(tmp_path, "beta")
        try:
            lib_a = await a.create_library("mesh-lib")
            corpus = os.path.join(tmp_path, "corpus")
            _corpus(corpus, "m", [900, 901, 902])
            await _scan(lib_a, a, corpus)

            for n in (a, hub, b):
                n.p2p._beacon_addrs = [("127.0.0.1", 1)]
                await n.p2p.start()
            da, dh, db_ = (n.p2p.p2p._discovery[0] for n in (a, hub, b))
            da.beacon_addrs = [("127.0.0.1", dh.bind_port)]
            dh.beacon_addrs = [("127.0.0.1", da.bind_port), ("127.0.0.1", db_.bind_port)]
            db_.beacon_addrs = [("127.0.0.1", dh.bind_port)]
            for d in (da, dh, db_):
                d.interval = 0.05
            for _ in range(200):
                if all(n.p2p.p2p.discovered_peers() for n in (a, hub, b)):
                    break
                await asyncio.sleep(0.05)
            assert not any(p.identity == b.p2p.p2p.remote_identity
                           for p in a.p2p.p2p.discovered_peers())

            a.p2p.pairing.auto_accept = True
            hub.p2p.pairing.auto_accept = True
            await hub.router.exec(hub, "p2p.pairLibrary", {
                "identity": str(a.p2p.p2p.remote_identity), "library_id": str(lib_a.id)})
            await b.router.exec(b, "p2p.pairLibrary", {
                "identity": str(hub.p2p.p2p.remote_identity), "library_id": str(lib_a.id)})
            lib_b, lib_h = b.libraries.get(lib_a.id), hub.libraries.get(lib_a.id)
            for _ in range(300):
                await a.p2p._alert_peers(lib_a.id)
                if lib_b.db.count("file_path") == lib_a.db.count("file_path"):
                    break
                await asyncio.sleep(0.1)
            assert lib_h.db.count("file_path") == lib_a.db.count("file_path")
            assert lib_b.db.count("file_path") == lib_a.db.count("file_path")
            assert _cas(lib_a) == _cas(lib_b) and len(_cas(lib_a)) == 3
        finally:
            for n in (a, hub, b):
                await n.shutdown()

    _run(run(), 120)


async def _share_library(a, b):
    """The pairing outcome by file move: `a`'s library on `b` under the
    same id, each DB knowing both instances."""
    import shutil

    lib_a = await a.create_library("shared")
    b.libraries.libraries.clear()
    lib_b_local = b.libraries.create("shared")
    old, d = lib_b_local.id, b.libraries.dir
    for suffix in (".sdlibrary", ".db"):
        shutil.move(os.path.join(d, f"{old}{suffix}"), os.path.join(d, f"{lib_a.id}{suffix}"))
    for s in ("-wal", "-shm"):
        p = os.path.join(d, f"{old}.db{s}")
        if os.path.exists(p):
            shutil.move(p, os.path.join(d, f"{lib_a.id}.db{s}"))
    lib_b_local.close()
    b.libraries.libraries.clear()
    lib_b = b.libraries.load(lib_a.id)
    await b._init_library(lib_b)
    for src, dst in ((lib_a, lib_b), (lib_b, lib_a)):
        inst = src.db.find_one("instance", pub_id=src.instance_uuid.bytes)
        dst.db.insert("instance", **{k: inst[k] for k in (
            "pub_id", "identity", "node_id", "node_name", "node_platform", "last_seen",
            "date_created")})
    return lib_a, lib_b


def test_two_node_sync_convergence_and_file_request(tmp_path):
    async def run():
        from spacedrive_tpu_torch.node.config import BackendFeature
        from spacedrive_tpu_torch.p2p.rspc import RemoteRspcError, remote_exec

        a = await _make_node(tmp_path, "alpha")
        b = await _make_node(tmp_path, "beta")
        try:
            lib_a, lib_b = await _share_library(a, b)
            await _link(a, b)
            a.toggle_feature(BackendFeature.FILES_OVER_P2P, True)
            corpus = os.path.join(tmp_path, "corpus")
            blobs = _corpus(corpus, "doc", [2048, 2049, 2050])
            await _scan(lib_a, a, corpus)
            for _ in range(200):
                await a.p2p._alert_peers(lib_a.id)
                if (lib_b.db.count("file_path") == lib_a.db.count("file_path")
                        and lib_b.db.count("location") == 1):
                    break
                await asyncio.sleep(0.1)
            assert lib_b.db.count("location") == 1
            assert lib_b.db.count("file_path") == lib_a.db.count("file_path")
            assert _cas(lib_a) == _cas(lib_b) and len(_cas(lib_a)) == 3

            # files over p2p: beta pulls doc1's bytes from alpha by pub_id
            row = lib_b.db.find_one("file_path", name="doc1")
            sink = io.BytesIO()
            size = await request_file(b.p2p.p2p, a.p2p.p2p.remote_identity, lib_a.id,
                                      uuid.UUID(bytes=row["pub_id"]), sink)
            assert sink.getvalue() == blobs["doc1.bin"] and size == len(blobs["doc1.bin"])

            # rspc over p2p: refused until alpha opts in; queries only
            them = a.p2p.p2p.remote_identity
            with pytest.raises(RemoteRspcError) as exc:
                await remote_exec(b.p2p.p2p, them, "buildInfo")
            assert exc.value.code == 403
            a.toggle_feature(BackendFeature.REMOTE_RSPC, True)
            with pytest.raises(RemoteRspcError):
                await remote_exec(b.p2p.p2p, them, "tags.create", {"name": "evil"},
                                  library_id=str(lib_a.id))
            assert (await remote_exec(b.p2p.p2p, them, "buildInfo"))["version"]
            remote_paths = await remote_exec(b.p2p.p2p, them, "search.paths", {"take": 10},
                                             library_id=str(lib_a.id))
            assert len(remote_paths["items"]) == lib_a.db.count("file_path")
            with pytest.raises(RemoteRspcError):
                await remote_exec(b.p2p.p2p, them, "nope.nothing")
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run())


def test_spacedrop_over_wan_relay(tmp_path):
    """Two nodes with LAN discovery disabled reach each other only
    through the relay: discovery by its registry, the stream spliced
    through its pipe, the Noise handshake end to end."""

    async def run():
        from spacedrive_tpu_torch.node.config import P2PDiscoveryState

        relay = RelayServer()
        relay_port = await relay.start()
        a = await _make_node(tmp_path, "wan-a")
        b = await _make_node(tmp_path, "wan-b")
        clients = []
        try:
            for n in (a, b):
                n.config.config.p2p.discovery = P2PDiscoveryState.DISABLED
                await n.p2p.start()
                assert not n.p2p.p2p._discovery
                rc = RelayClient(n.p2p.p2p, ("127.0.0.1", relay_port), n.p2p.p2p._on_stream,
                                 query_interval=0.1, punch=False)
                await rc.start()
                clients.append(rc)
            for _ in range(200):
                if a.p2p.p2p.discovered_peers() and b.p2p.p2p.discovered_peers():
                    break
                await asyncio.sleep(0.05)
            else:
                raise TimeoutError("relay discovery never converged")
            peer_b = a.p2p.p2p.discovered_peers()[0]
            assert peer_b.relayed and not peer_b.addrs
            assert peer_b.metadata.get("name") == "wan-b"

            src = os.path.join(tmp_path, "wan-gift.bin")
            payload = os.urandom(200_000)
            with open(src, "wb") as f:
                f.write(payload)
            dest = os.path.join(tmp_path, "wan-inbox")
            offers = _offers(b, "SpacedropRequest")
            drop_id, _ = await asyncio.gather(
                a.p2p.spacedrop.send(peer_b.identity, [src]),
                _answer(offers, lambda i: b.p2p.spacedrop.accept(i, dest)),
            )
            with open(os.path.join(dest, "wan-gift.bin"), "rb") as f:
                assert f.read() == payload
            assert a.p2p.spacedrop.progress[drop_id] == 100
        finally:
            for rc in clients:
                await rc.shutdown()
            await a.shutdown()
            await b.shutdown()
            await relay.shutdown()

    _run(run())


def test_relay_from_node_config(tmp_path):
    """`p2p.relay = "host:port"` in the node config wires the relay
    client at P2P start; a relayed ping crosses the spliced pipe."""

    async def run():
        from spacedrive_tpu_torch.node.config import P2PDiscoveryState

        relay = RelayServer()
        relay_port = await relay.start()
        a = await _make_node(tmp_path, "cfg-a")
        b = await _make_node(tmp_path, "cfg-b")
        try:
            for n in (a, b):
                n.config.config.p2p.discovery = P2PDiscoveryState.DISABLED
                n.config.config.p2p.relay = f"127.0.0.1:{relay_port}"
                await n.p2p.start()
                assert n.p2p.relay_client is not None
            for n in (a, b):
                n.p2p.p2p._discovery[-1]._interval = 0.1
            for _ in range(200):
                if a.p2p.p2p.discovered_peers() and b.p2p.p2p.discovered_peers():
                    break
                await asyncio.sleep(0.05)
            else:
                raise TimeoutError("config-path relay discovery failed")
            assert await ping(a.p2p.p2p, a.p2p.p2p.discovered_peers()[0].identity)
        finally:
            await a.shutdown()
            await b.shutdown()
            await relay.shutdown()

    _run(run())


async def _punched_spacedrop(tmp_path, nbytes):
    """Spacedrop between two bare P2P runtimes behind simulated cone
    NATs: discovery by the relay registry, a punched direct UDP path,
    and the relay splicing nothing. Returns the seconds it took."""
    from spacedrive_tpu_torch.p2p import operations

    srv = RelayServer()
    port = await srv.start()
    a, b = P2P("sdx"), P2P("sdx")
    save_dir = str(tmp_path / "inbox")
    drops_b = operations.SpacedropManager(b, save_dir=save_dir)

    async def on_stream_b(stream):
        header = await Header.read(stream)
        if header.type == HeaderType.SPACEDROP:
            await drops_b.handle_inbound(stream, header.spacedrop)

    async def on_stream_a(stream):
        pass

    ra = RelayClient(a, ("127.0.0.1", port), on_stream_a, query_interval=0.1,
                     udp_factory=lambda: NattedEndpoint("cone"))
    rb = RelayClient(b, ("127.0.0.1", port), on_stream_b, query_interval=0.1,
                     udp_factory=lambda: NattedEndpoint("cone"))
    await ra.start()
    await rb.start()
    try:
        for _ in range(100):
            peer = a.peers.get(b.identity.to_remote_identity())
            if peer and peer.is_discovered:
                break
            await asyncio.sleep(0.05)
        else:
            raise TimeoutError("relay discovery failed")
        src = str(tmp_path / "gift.bin")
        payload = os.urandom(nbytes)
        with open(src, "wb") as f:
            f.write(payload)

        async def auto_accept():
            for _ in range(200):
                if drops_b.pending:
                    drops_b.accept(next(iter(drops_b.pending)), save_dir)
                    return
                await asyncio.sleep(0.05)
            raise TimeoutError("accept never saw a pending request")

        drops_a = operations.SpacedropManager(a)
        t0 = time.perf_counter()
        drop_id, _ = await asyncio.gather(
            drops_a.send(b.identity.to_remote_identity(), [src]), auto_accept())
        dt = time.perf_counter() - t0
        with open(os.path.join(save_dir, "gift.bin"), "rb") as f:
            assert f.read() == payload
        assert drops_a.progress[drop_id] == 100
        assert srv.stats.pipes_opened == 0 and srv.stats.bytes_relayed == 0
        return dt
    finally:
        await ra.shutdown()
        await rb.shutdown()
        await a.shutdown()
        await b.shutdown()
        await srv.shutdown()


def test_spacedrop_rides_punched_path(tmp_path):
    _run(_punched_spacedrop(tmp_path, 300_000), 60)


@pytest.mark.slow
def test_spacedrop_bulk_throughput_over_punched_path(tmp_path):
    nbytes = 8 * 1024 * 1024
    dt = _run(_punched_spacedrop(tmp_path, nbytes), 300)
    assert nbytes / dt / 1e6 > 3.0, f"{nbytes / dt / 1e6:.2f} MB/s"


def test_peer_vanish_mid_sync_is_a_retryable_pull_failure():
    """An IncompleteReadError mid-exchange retries under the sync policy
    and lands as a failed pull, not a crash."""
    from spacedrive_tpu_torch.p2p.manager import SYNC_POLICY

    calls = []

    async def flaky_exchange():
        calls.append(1)
        if len(calls) == 1:
            raise asyncio.IncompleteReadError(b"", 4)
        return (["op"], False)

    ops, has_more = _run(SYNC_POLICY.call("vanishing-peer", flaky_exchange), 30)
    assert ops == ["op"] and len(calls) == 2


class _Stream:
    def __init__(self, remote_identity="test-peer", incoming=b""):
        self.remote_identity = remote_identity
        self.closed = False
        self.wrote = b""
        self._in = bytearray(incoming)

    async def write(self, data):
        self.wrote += data

    async def read_exact(self, n):
        if len(self._in) < n:
            raise asyncio.IncompleteReadError(bytes(self._in), n)
        out = bytes(self._in[:n])
        del self._in[:n]
        return out

    async def close(self):
        self.closed = True


def test_sync_serve_vanish_closes_stream_before_response(tmp_path):
    """The `p2p.sync_serve` fault makes the peer vanish mid-SYNC: stream
    closed, nothing written, the injection on the ring."""

    async def run():
        from spacedrive_tpu_torch.node.node import Node
        from spacedrive_tpu_torch.p2p.manager import P2PManager

        node = Node(os.path.join(tmp_path, "n"), device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            mgr = P2PManager(node)
            stream = _Stream()
            header = Header(HeaderType.SYNC_REQUEST, library_id=uuid.uuid4())
            with faults.active(faults.FaultPlan.parse("p2p.sync_serve:vanish:times=1")):
                await mgr._handle_stream_traced(stream, header, None)
            assert stream.closed and stream.wrote == b""
            assert any(e["fields"]["point"] == "p2p.sync_serve"
                       for e in ring("faults").snapshot() if e["type"] == "injected")
        finally:
            await node.shutdown()

    _run(run(), 60)


def test_work_stream_answered_work_plane_not_running(tmp_path):
    """The port has no work plane yet: a member's WORK stream gets the
    answer JAX's `respond_work` gives without one, a stranger's the
    members-only refusal, and a malformed body JAX's malformed answer."""

    async def run():
        import msgpack

        from spacedrive_tpu_torch.node.node import Node
        from spacedrive_tpu_torch.p2p.manager import P2PManager

        node = Node(os.path.join(tmp_path, "n"), device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            lib = await node.create_library("work")
            member = Identity().to_remote_identity()
            inst = lib.db.find_one("instance", pub_id=lib.instance_uuid.bytes)
            lib.db.insert("instance", pub_id=uuid.uuid4().bytes, identity=member.to_bytes(),
                          node_id=inst["node_id"], node_name="m", node_platform=0,
                          last_seen=inst["last_seen"], date_created=inst["date_created"])
            mgr = P2PManager(node)

            def frame(obj):
                raw = msgpack.packb(obj, use_bin_type=True)
                return len(raw).to_bytes(4, "big") + raw

            header = Header(HeaderType.WORK, library_id=lib.id)
            got = {}
            for who, ident, body in (("member", member, {"op": "claim"}),
                                     ("malformed", member, [1]),
                                     ("stranger", Identity().to_remote_identity(),
                                      {"op": "claim"})):
                stream = _Stream(ident, frame(body))
                await mgr._handle_stream_traced(stream, header, None)
                got[who] = msgpack.unpackb(stream.wrote[4:])
            assert got == {
                "member": {"error": "work plane not running"},
                "malformed": {"error": "malformed WORK request"},
                "stranger": {"error": "the work plane is served to library members only"},
            }
            assert not hasattr(mgr, "work")
        finally:
            await node.shutdown()

    _run(run(), 60)
