"""The node's p2p across packages: a JAX Node and a port Node in one
event loop, and every body this plane writes against JAX's bytes.

- mixed cases, each way: Spacedrop, pairing (a port Node joins a JAX
  library and the reverse), sync convergence by alerts and pulls after
  the join, a TELEMETRY pull, and a JAX worker's WORK stream answered by
  the port with JAX's "work plane not running";
- under pinned randomness (`uuid.uuid4`, the trace context) and the
  same inputs, each operation of the port writes JAX's bytes: ping,
  the sync alert, pull and page, the Spacedrop offer and decision, the
  pairing request, reply and instance frame, the telemetry, trace and
  profile pulls and answers, the remote rspc call and answers, the WORK
  refusal, and the file request and refusal.

Every mixed case binds 127.0.0.1 with unicast beacons, runs under its
own asyncio timeout and shuts its nodes down in `finally`.
"""

import asyncio
import os
import types
import uuid

import msgpack
import pytest

import spacedrive_tpu.p2p.identity as j_identity
import spacedrive_tpu.p2p.operations as j_operations
import spacedrive_tpu.p2p.pairing as j_pairing
import spacedrive_tpu.p2p.rspc as j_rspc
import spacedrive_tpu.p2p.sync as j_sync
import spacedrive_tpu.p2p.work as j_work
import spacedrive_tpu.sync.ingest as j_ingest
import spacedrive_tpu.telemetry.federation as j_federation
import spacedrive_tpu.telemetry.sampler as j_sampler
import spacedrive_tpu.telemetry.trace as j_trace
import spacedrive_tpu_torch.p2p.identity as p_identity
import spacedrive_tpu_torch.p2p.manager as p_manager
import spacedrive_tpu_torch.p2p.operations as p_operations
import spacedrive_tpu_torch.p2p.pairing as p_pairing
import spacedrive_tpu_torch.p2p.rspc as p_rspc
import spacedrive_tpu_torch.p2p.sync as p_sync
import spacedrive_tpu_torch.sync.ingest as p_ingest
import spacedrive_tpu_torch.telemetry.federation as p_federation
import spacedrive_tpu_torch.telemetry.sampler as p_sampler
import spacedrive_tpu_torch.telemetry.trace as p_trace

MIXED = [("jax", "port"), ("port", "jax")]


def _run(coro, timeout: float = 90.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# --- mixed nodes ----------------------------------------------------------


async def _make_node(pkg, root, name):
    if pkg == "jax":
        from spacedrive_tpu.node import Node
        from spacedrive_tpu.p2p.manager import P2PManager

        node = Node(os.path.join(root, name), use_device=False, with_labeler=False)
    else:
        from spacedrive_tpu_torch.node.node import Node
        from spacedrive_tpu_torch.p2p.manager import P2PManager

        node = Node(os.path.join(root, name), device="cpu", with_labeler=False)
    node.config.config.p2p.enabled = False  # start p2p by hand on loopback
    node.config.config.name = name
    await node.start()
    node.p2p = P2PManager(node, beacon_addrs=[("127.0.0.1", 1)], bind_host="127.0.0.1")
    return node


async def _pair_of(tmp_path, a_pkg, b_pkg):
    a = await _make_node(a_pkg, str(tmp_path), f"a-{a_pkg}")
    b = await _make_node(b_pkg, str(tmp_path), f"b-{b_pkg}")
    await a.p2p.start()
    await b.p2p.start()
    da, db_ = a.p2p.p2p._discovery[0], b.p2p.p2p._discovery[0]
    da.beacon_addrs = [("127.0.0.1", db_.bind_port)]
    db_.beacon_addrs = [("127.0.0.1", da.bind_port)]
    da.interval = db_.interval = 0.05
    for _ in range(200):
        if a.p2p.p2p.discovered_peers() and b.p2p.p2p.discovered_peers():
            return a, b
        await asyncio.sleep(0.05)
    raise TimeoutError("nodes never discovered each other")


def _ident(me, peer):
    """`peer`'s identity as `me`'s package spells it."""
    return type(me.p2p.p2p.remote_identity).from_str(str(peer.p2p.p2p.remote_identity))


def _corpus(root, prefix, n, size=1500):
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        with open(os.path.join(root, f"{prefix}{i}.bin"), "wb") as f:
            f.write(os.urandom(size + i))


async def _scan(pkg, lib, node, corpus):
    if pkg == "jax":
        from spacedrive_tpu.location.locations import LocationCreateArgs, scan_location

        kw = {}
    else:
        from spacedrive_tpu_torch.location.locations import LocationCreateArgs, scan_location

        kw = {"backend": "cpu"}
    loc = LocationCreateArgs(path=corpus).create(lib)
    await scan_location(lib, loc, node.jobs, **kw)
    await node.jobs.wait_idle()
    return loc


def _rows(lib):
    return sorted((r["materialized_path"], r["name"], r["extension"], r["is_dir"], r["cas_id"])
                  for r in lib.db.query("SELECT * FROM file_path"))


async def _converge(owner, lib_a, lib_b):
    for _ in range(200):
        await owner.p2p._alert_peers(lib_a.id)
        if _rows(lib_b) == _rows(lib_a):
            return
        await asyncio.sleep(0.1)
    assert _rows(lib_b) == _rows(lib_a)


async def _pair_library(a, b, lib_a):
    """`b` joins `a`'s library through the router, `a` consenting."""
    got = []
    a.event_bus.on(lambda ev: got.append(ev[1])
                   if isinstance(ev, tuple) and ev and ev[0] == "PairingRequest" else None)

    async def consent():
        for _ in range(200):
            if got:
                await a.router.exec(a, "p2p.acceptPairing", str(got[0].id))
                return
            await asyncio.sleep(0.05)
        raise TimeoutError("no pairing offer reached the owner")

    lib_id, _ = await asyncio.gather(
        b.router.exec(b, "p2p.pairLibrary", {"identity": str(a.p2p.p2p.remote_identity),
                                              "library_id": str(lib_a.id)}),
        consent())
    assert lib_id == str(lib_a.id)
    return b.libraries.get(lib_a.id)


@pytest.mark.parametrize("sender,receiver", MIXED)
def test_mixed_spacedrop(tmp_path, sender, receiver):
    async def run():
        a, b = await _pair_of(tmp_path, sender, receiver)
        try:
            src = [str(tmp_path / "gift.bin"), str(tmp_path / "small.txt")]
            payloads = [os.urandom(300_000), b"hello"]
            for p, data in zip(src, payloads):
                with open(p, "wb") as f:
                    f.write(data)
            dest = str(tmp_path / "inbox")
            got = []
            b.event_bus.on(lambda ev: got.append(ev[1])
                           if isinstance(ev, tuple) and ev and ev[0] == "SpacedropRequest"
                           else None)

            async def accept():
                for _ in range(200):
                    if got:
                        await b.router.exec(b, "p2p.acceptSpacedrop",
                                            {"id": str(got[0].id), "target_dir": dest})
                        return
                    await asyncio.sleep(0.05)
                raise TimeoutError("no offer")

            drop_id, _ = await asyncio.gather(
                a.router.exec(a, "p2p.spacedrop", {
                    "identity": str(b.p2p.p2p.remote_identity), "file_paths": src}),
                accept())
            for p, data in zip(src, payloads):
                with open(os.path.join(dest, os.path.basename(p)), "rb") as f:
                    assert f.read() == data
            assert a.p2p.spacedrop.progress[uuid.UUID(drop_id)] == 100
            assert got[0].files == ["gift.bin", "small.txt"]
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run())


@pytest.mark.parametrize("owner,joiner", MIXED)
def test_mixed_pairing(tmp_path, owner, joiner):
    """The joiner of one package joins the other's library: both register
    both instances, and the owner's rows (which predate sync, so the
    owner backfills them while the joiner waits) stream over."""

    async def run():
        a, b = await _pair_of(tmp_path, owner, joiner)
        try:
            lib_a = await a.create_library("family")
            _corpus(str(tmp_path / "c"), "pic", 3)
            await _scan(owner, lib_a, a, str(tmp_path / "c"))
            lib_b = await _pair_library(a, b, lib_a)
            assert lib_b.name == "family"
            assert lib_a.db.count("instance") == 2 and lib_b.db.count("instance") == 2
            await _converge(a, lib_a, lib_b)
            assert lib_b.db.count("location") == 1
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run(), 120)


@pytest.mark.parametrize("owner,joiner", MIXED)
def test_mixed_sync_convergence(tmp_path, owner, joiner):
    """After the join, files the owner indexes reach the joiner by the
    SYNC alert and pull alone, and the joiner's own writes reach the
    owner the same way."""

    async def run():
        a, b = await _pair_of(tmp_path, owner, joiner)
        try:
            lib_a = await a.create_library("shared")
            a.p2p.pairing.auto_accept = True
            lib_b = await b.p2p.pairing.join(b.p2p.p2p, _ident(b, a), lib_a.id)
            _corpus(str(tmp_path / "c"), "doc", 4, 2048)
            await _scan(owner, lib_a, a, str(tmp_path / "c"))
            for _ in range(300):
                if _rows(lib_b) == _rows(lib_a) and lib_b.db.count("file_path") == 4:
                    break
                await asyncio.sleep(0.1)
            assert _rows(lib_b) == _rows(lib_a) and lib_b.db.count("file_path") == 4
            # the reverse direction: a tag created on the joiner
            await b.router.exec(b, "tags.create", {"name": "mixed", "color": "#fff"},
                                library_id=str(lib_b.id))
            for _ in range(300):
                if lib_a.db.count("tag") == 1:
                    break
                await asyncio.sleep(0.1)
            assert [r["name"] for r in lib_a.db.find("tag")] == ["mixed"]
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run(), 120)


@pytest.mark.parametrize("puller,served", MIXED)
def test_mixed_telemetry_pull(tmp_path, puller, served):
    """A library member pulls the other package's snapshot over the
    TELEMETRY wire: fresh, versioned, carrying the shared library."""

    async def run():
        a, b = await _pair_of(tmp_path, served, puller)
        try:
            lib_a = await a.create_library("obs")
            a.p2p.pairing.auto_accept = True
            await b.p2p.pairing.join(b.p2p.p2p, _ident(b, a), lib_a.id)
            mesh = await b.p2p.refresh_federation(force=True)
            entry = mesh["peers"][str(a.p2p.p2p.remote_identity)]
            assert entry["stale"] is False and entry["error"] is None, entry
            snap = entry["snapshot"]
            assert snap["v"] == 1 and str(lib_a.id) in snap["node"]["libraries"]
            assert snap["health"]["status"] in ("healthy", "degraded", "unhealthy", "unknown")
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run(), 120)


def test_mixed_work_stream_refused_by_the_port(tmp_path):
    """A JAX node's WORK exchange with a port node of its library gets
    JAX's "work plane not running" (a PermissionError at the caller); a
    stranger gets the members-only refusal."""

    async def run():
        a, b = await _pair_of(tmp_path, "port", "jax")
        try:
            lib_a = await a.create_library("work")
            a.p2p.pairing.auto_accept = True
            await b.p2p.pairing.join(b.p2p.p2p, _ident(b, a), lib_a.id)
            with pytest.raises(PermissionError, match="work plane not running"):
                await j_work.request_work(b.p2p.p2p, _ident(b, a), lib_a.id,
                                          {"op": "claim", "max_shards": 1})
            with pytest.raises(PermissionError, match="members only"):
                await j_work.request_work(b.p2p.p2p, _ident(b, a), uuid.uuid4(),
                                          {"op": "claim"})
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run(), 120)


# --- every body against JAX's bytes ----------------------------------------


PKG = {
    "jax": types.SimpleNamespace(identity=j_identity, operations=j_operations,
                                 pairing=j_pairing, rspc=j_rspc, sync=j_sync,
                                 ingest=j_ingest, federation=j_federation, sampler=j_sampler,
                                 trace=j_trace),
    "port": types.SimpleNamespace(identity=p_identity, operations=p_operations,
                                  pairing=p_pairing, rspc=p_rspc, sync=p_sync,
                                  ingest=p_ingest, federation=p_federation, sampler=p_sampler,
                                  trace=p_trace),
}
TRACE = {"trace_id": "ab" * 16, "span_id": "cd" * 8}
SEED = bytes(range(32))


class _Stream:
    """Scripted input, recorded output."""

    def __init__(self, incoming=b"", remote_identity=None):
        self._in = bytearray(incoming)
        self.wrote = bytearray()
        self.remote_identity = remote_identity

    async def write(self, data):
        self.wrote += data

    async def read_exact(self, n):
        if len(self._in) < n:
            raise asyncio.IncompleteReadError(bytes(self._in), n)
        out = bytes(self._in[:n])
        del self._in[:n]
        return out

    async def close(self):
        pass


def _frame(obj) -> bytes:
    raw = msgpack.packb(obj, use_bin_type=True)
    return len(raw).to_bytes(4, "big") + raw


def _p2p(stream):
    async def new_stream(identity, timeout=10.0):
        return stream

    return types.SimpleNamespace(new_stream=new_stream)


class _Op:
    def __init__(self, raw):
        self._raw = raw

    def pack(self):
        return self._raw


def _stub_node(pkg, features=(), router=None):
    ident = PKG[pkg].identity.Identity.from_bytes(SEED)
    return types.SimpleNamespace(
        id=uuid.UUID(int=5),
        config=types.SimpleNamespace(config=types.SimpleNamespace(name="node-x", identity=ident)),
        libraries=types.SimpleNamespace(get=lambda _id: None, libraries={}),
        is_feature_enabled=lambda f: f.value in features,
        router=router,
        p2p=types.SimpleNamespace(work=None),
    )


def _stub_library(pkg):
    inserted = []
    row = {"pub_id": bytes(16), "identity": b"\x01" * 32, "node_id": bytes(range(16)),
           "node_name": "owner", "node_platform": 1, "date_created": "2026-01-01T00:00:00Z"}
    db = types.SimpleNamespace(find=lambda table: [row],
                               insert=lambda table, **kw: inserted.append(kw) or 2)
    return types.SimpleNamespace(
        id=uuid.UUID(int=9), db=db,
        config=types.SimpleNamespace(name="family", description="photos"),
        sync=types.SimpleNamespace(timestamps={}))


async def _spacedrop_offer(pkg, tmp):
    ops = PKG[pkg].operations
    src = os.path.join(tmp, "gift.bin")
    with open(src, "wb") as f:
        f.write(b"x" * 300_000)
    stream = _Stream(b"\x00")
    with pytest.raises(PermissionError):
        await ops.SpacedropManager(_p2p(stream)).send("peer", [src])
    return stream


async def _spacedrop_decision(pkg, tmp):
    ops = PKG[pkg].operations
    block = __import__(ops.__name__.rsplit(".", 1)[0] + ".block", fromlist=["x"])
    requests = block.SpaceblockRequests(
        id=uuid.UUID(int=3), block_size=block.BlockSize.from_file_size(10),
        requests=[block.SpaceblockRequest(name="a.bin", size=10)])
    mgr = ops.SpacedropManager(None)
    stream = _Stream(remote_identity="peer")
    task = asyncio.ensure_future(mgr.handle_inbound(stream, requests))
    while not mgr.pending:
        await asyncio.sleep(0)
    assert mgr.reject(uuid.UUID(int=3))
    await task
    return stream


async def _pairing_request(pkg, tmp):
    stream = _Stream(_frame({"ok": False, "error": "pairing rejected"}))
    mgr = PKG[pkg].pairing.PairingManager(_stub_node(pkg))
    with pytest.raises(PermissionError):
        await mgr.join(_p2p(stream), "peer", uuid.UUID(int=9))
    return stream


async def _pairing_reply(pkg, tmp, monkeypatch):
    lib = _stub_library(pkg)
    node = _stub_node(pkg)
    node.libraries = types.SimpleNamespace(get=lambda _id: lib, libraries={lib.id: lib})
    monkeypatch.setattr(PKG[pkg].ingest, "backfill_operations", lambda sync: 0)
    mgr = PKG[pkg].pairing.PairingManager(node)
    mgr.auto_accept = True
    body = {"library_id": lib.id.bytes, "instance": {
        "node_name": "joiner", "node_pub_id": bytes(16), "node_platform": 1,
        "identity": b"\x02" * 32}}
    stream = _Stream(_frame(body) + _frame({"instance_pub_id": b"\x07" * 16}),
                     remote_identity="joiner")
    await mgr.handle_inbound(stream)
    assert len(lib.sync.timestamps) == 1
    return stream


async def _sync_alert(pkg, tmp):
    stream = _Stream(b"\x01")
    await PKG[pkg].sync.alert_new_ops(_p2p(stream), "peer", uuid.UUID(int=9))
    return stream


async def _sync_pull(pkg, tmp):
    stream = _Stream(_frame({"ops": [], "has_more": False}))
    clocks = [(uuid.UUID(int=1), 7 << 32), (uuid.UUID(int=2), 0)]
    got = await PKG[pkg].sync.request_ops_from_peer(_p2p(stream), "peer", uuid.UUID(int=9),
                                                   clocks, 1000)
    assert got == ([], False)
    return stream


async def _sync_page(pkg, tmp):
    calls = []

    def get_ops(count, clocks):
        calls.append((count, [(i, int(t)) for i, t in clocks]))
        return [_Op(b"op-one"), _Op(b"\x00" * 40)]

    stream = _Stream(_frame({"clocks": [[uuid.UUID(int=1).bytes, 99]], "count": 2}))
    await PKG[pkg].sync.respond_sync_request(stream, types.SimpleNamespace(get_ops=get_ops))
    assert calls == [(2, [(uuid.UUID(int=1), 99)])]
    return stream


SNAPSHOT = {"v": 1, "ts": 1.5, "health": {"status": "healthy", "n": [1, 2.5, None]},
            "node": {"id": "x", "libraries": {}}, 3: b"\x01"}


async def _telemetry_pull(pkg, tmp):
    stream = _Stream(_frame({"v": 1, "ts": 1.0}))
    await PKG[pkg].operations.request_telemetry(_p2p(stream), "peer")
    return stream


async def _telemetry_answer(pkg, tmp, monkeypatch):
    monkeypatch.setattr(PKG[pkg].federation, "local_snapshot", lambda node=None: SNAPSHOT)
    stream = _Stream()
    await PKG[pkg].operations.respond_telemetry(stream, None)
    return stream


async def _trace_pull(pkg, tmp):
    stream = _Stream(_frame({"spans": [{"stage": "walk"}, 3]}))
    got = await PKG[pkg].operations.request_trace(_p2p(stream), "peer", "ab" * 16)
    assert got == [{"stage": "walk"}]
    return stream


async def _trace_answer(pkg, tmp, monkeypatch):
    spans = [{"stage": "walk", "t0": 1.0, "attrs": {"n": 3, "p": ("a", b"b")}}] * 3
    monkeypatch.setattr(PKG[pkg].trace, "recent", lambda trace_id=None: spans)
    stream = _Stream()
    await PKG[pkg].operations.respond_trace(stream, "ab" * 16)
    await PKG[pkg].operations.respond_trace(stream, "")
    return stream


async def _profile_pull(pkg, tmp):
    stream = _Stream(_frame({"profile": {"enabled": True}, "folded": "a;b 3"}))
    await PKG[pkg].operations.request_profile(_p2p(stream), "peer")
    return stream


async def _profile_answer(pkg, tmp, monkeypatch):
    monkeypatch.setattr(PKG[pkg].sampler, "SAMPLER", types.SimpleNamespace(
        profile=lambda: {"enabled": True, "samples": 7, "top_groups": [["loop", 0.5]]},
        folded=lambda max_bytes: "mod:fn;mod:g 4\n"))
    stream = _Stream()
    await PKG[pkg].operations.respond_profile(stream)
    return stream


async def _rspc_call(pkg, tmp):
    stream = _Stream(_frame({"ok": True, "result": {"version": "0.1.0"}}))
    got = await PKG[pkg].rspc.remote_exec(_p2p(stream), "peer", "search.paths", {"take": 10},
                                          library_id=str(uuid.UUID(int=9)))
    assert got == {"version": "0.1.0"}
    return stream


async def _rspc_answers(pkg, tmp):
    async def exec_(node, key, arg, library_id):
        if key == "boom":
            raise RuntimeError("kaput")
        return {"a": b"\x01\x02", "n": [1, 2.5, None, (3, "x")], "u": uuid.UUID(int=4)}

    procs = {"q": types.SimpleNamespace(kind="query"), "boom": types.SimpleNamespace(kind="query"),
             "m": types.SimpleNamespace(kind="mutation")}
    router = types.SimpleNamespace(procedures=procs, exec=exec_)
    stream = _Stream()
    for features in ((), ("remoteRspc",)):
        for key in ("q", "m", "boom"):
            s = _Stream(_frame({"key": key, "arg": None, "library_id": None}))
            await PKG[pkg].rspc.respond_rspc(s, _stub_node(pkg, features, router))
            stream.wrote += s.wrote
    return stream


async def _work_refusal(pkg, tmp):
    stream = _Stream()
    for body in ({"op": "claim"}, "junk"):
        s = _Stream(_frame(body))
        if pkg == "jax":
            await j_work.respond_work(s, _stub_node(pkg), None)
        else:
            await p_manager._refuse_work(s)
        stream.wrote += s.wrote
    return stream


async def _file_request(pkg, tmp):
    stream = _Stream(b"\x00" + len(b"file not found").to_bytes(4, "big") + b"file not found")
    with pytest.raises(FileNotFoundError):
        await PKG[pkg].operations.request_file(_p2p(stream), "peer", uuid.UUID(int=9),
                                               uuid.UUID(int=10), None)
    return stream


async def _file_refusal(pkg, tmp):
    block = __import__(PKG[pkg].operations.__name__.rsplit(".", 1)[0] + ".protocol",
                       fromlist=["x"])
    req = block.FileRequest(uuid.UUID(int=9), uuid.UUID(int=10), block.Range())
    stream = _Stream()
    await PKG[pkg].operations.respond_file(stream, req, types.SimpleNamespace(get=lambda i: None))
    return stream


async def _ping(pkg, tmp):
    stream = _Stream(b"\xaa")
    await PKG[pkg].operations.ping(_p2p(stream), "peer")
    return stream


BODIES = {
    "ping": _ping,
    "sync_alert": _sync_alert,
    "sync_pull": _sync_pull,
    "sync_page": _sync_page,
    "spacedrop_offer": _spacedrop_offer,
    "spacedrop_decision": _spacedrop_decision,
    "pairing_request": _pairing_request,
    "pairing_reply": _pairing_reply,
    "telemetry_pull": _telemetry_pull,
    "telemetry_answer": _telemetry_answer,
    "trace_pull": _trace_pull,
    "trace_answer": _trace_answer,
    "profile_pull": _profile_pull,
    "profile_answer": _profile_answer,
    "rspc_call": _rspc_call,
    "rspc_answers": _rspc_answers,
    "work_refusal": _work_refusal,
    "file_request": _file_request,
    "file_refusal": _file_refusal,
}


@pytest.mark.parametrize("body", sorted(BODIES))
def test_bodies_equal_jax_bytes(body, tmp_path, monkeypatch):
    ids = iter(uuid.UUID(int=100 + i) for i in range(1000))
    monkeypatch.setattr(uuid, "uuid4", lambda: next(ids))
    fn = BODIES[body]
    wrote = {}
    for pkg in ("jax", "port"):
        trace = PKG[pkg].trace
        kwargs = {"monkeypatch": monkeypatch} if "monkeypatch" in fn.__code__.co_varnames else {}
        os.makedirs(tmp_path / pkg)

        async def run():
            with trace.use(trace.TraceContext.from_wire(TRACE)):
                return await fn(pkg, str(tmp_path / pkg), **kwargs)

        ids = iter(uuid.UUID(int=100 + i) for i in range(1000))
        wrote[pkg] = bytes(_run(run(), 30).wrote)
    assert wrote["jax"], body
    assert wrote["port"] == wrote["jax"]
