"""Cloud sync in the port: the relay, its client and the sync actors.

- port twins of tests/test_cloud.py (the relay–client round trip, two
  Nodes converging through the relay alone), of tests/test_chaos.py's
  four relay cases (500s absorbed by retries, a timeout bounded by the
  deadline, mid-body EOFs opening the breaker and a half-open probe
  closing it, a 4xx that neither retries nor feeds the breaker) and of
  tests/test_mesh_observability.py's relay telemetry round trip;
- mixed pairs, both ways: JAX's `CloudClient` against the port's
  `CloudRelay` and the port's client against JAX's relay, one script
  over every endpoint with equal JSON bodies (ids, base64 contents, the
  `age_seconds` field); equal statuses and bodies on a list of bad
  requests; the `relay.http` faults seen by JAX's client the same way
  from either relay;
- a JAX Node and a port Node converging through one relay, each way,
  each pushed collection's bytes what JAX's
  `CompressedCRDTOperations.pack()` writes for its ops;
- the federation's relay leg: two port Nodes with discovery disabled,
  `refresh_federation(force=True)` storing the other's snapshot with
  `transport == "relay"`;
- the CLI's `relay` and the router's cloud.* procedures.

Everything binds 127.0.0.1 and runs under its own timeout; Nodes run on
the CPU.
"""

import asyncio
import json
import os
import shutil
import time
import uuid

import pytest

import spacedrive_tpu.cloud as jcloud
import spacedrive_tpu.telemetry as jtelemetry
from spacedrive_tpu.sync.crdt import CompressedCRDTOperations as JCompressed
from spacedrive_tpu.utils import faults as jfaults
from spacedrive_tpu.utils import resilience as jresilience
import spacedrive_tpu_torch.cloud as pcloud
from spacedrive_tpu_torch import cli, telemetry
from spacedrive_tpu_torch.cloud.api import RELAY_POLICY, CloudApiError
from spacedrive_tpu_torch.sync.crdt import CompressedCRDTOperations as PCompressed
from spacedrive_tpu_torch.telemetry import counter_value
from spacedrive_tpu_torch.utils import faults, http, resilience


@pytest.fixture(autouse=True)
def _clean_state():
    for f, r in ((faults, resilience), (jfaults, jresilience)):
        f.clear()
        r.reset_breakers()
    telemetry.reset()
    jtelemetry.reset()
    yield
    for f, r in ((faults, resilience), (jfaults, jresilience)):
        f.clear()
        r.reset_breakers()
    telemetry.reset()
    jtelemetry.reset()


def _run(coro, timeout: float = 60.0):
    async def bounded():
        async with asyncio.timeout(timeout):
            return await coro

    return asyncio.run(bounded())


PKG = {"port": pcloud, "jax": jcloud}


# --- tests/test_cloud.py twins -----------------------------------------------------------


def test_relay_and_client_roundtrip():
    async def run():
        relay = pcloud.CloudRelay()
        port = await relay.start()
        client = pcloud.CloudClient(f"http://127.0.0.1:{port}")
        try:
            lib_id = str(uuid.uuid4())
            inst_a, inst_b = str(uuid.uuid4()), str(uuid.uuid4())
            await client.create_library(lib_id, "cloudlib")
            assert (await client.get_library(lib_id))["name"] == "cloudlib"
            await client.add_instance(lib_id, inst_a)
            await client.add_instance(lib_id, inst_b)
            assert len(await client.list_instances(lib_id)) == 2

            await client.push_ops(lib_id, inst_a, b"packed-ops-1")
            await client.push_ops(lib_id, inst_a, b"packed-ops-2")
            # B pulls: both collections from A, in order
            cols = await client.pull_ops(lib_id, inst_b, {})
            assert [c["contents"] for c in cols] == [b"packed-ops-1", b"packed-ops-2"]
            # cursor resume: nothing new after the last id
            assert await client.pull_ops(lib_id, inst_b, {inst_a: cols[-1]["id"]}) == []
            # A doesn't receive its own collections
            assert await client.pull_ops(lib_id, inst_a, {}) == []
            # unknown instance push rejected
            with pytest.raises(CloudApiError):
                await client.push_ops(lib_id, str(uuid.uuid4()), b"x")
        finally:
            await client.close()
            await relay.shutdown()

    _run(run())


async def _make_node(pkg, root, name):
    if pkg == "jax":
        from spacedrive_tpu.node import Node

        node = Node(os.path.join(root, name), use_device=False, with_labeler=False)
    else:
        from spacedrive_tpu_torch.node.node import Node

        node = Node(os.path.join(root, name), device="cpu", with_labeler=False)
    node.config.config.p2p.enabled = False
    node.config.config.name = name
    await node.start()
    return node


async def _same_library(b, lib_a_id):
    """`b` holds the library `lib_a_id` with its own instance row, as
    tests/test_cloud.py builds it: a library of its own, renamed."""
    tmp = b.libraries.create("shared")
    old = tmp.id
    tmp.close()
    b.libraries.libraries.clear()
    for suffix in (".sdlibrary", ".db", ".db-wal", ".db-shm"):
        src = os.path.join(b.libraries.dir, f"{old}{suffix}")
        if os.path.exists(src):
            shutil.move(src, os.path.join(b.libraries.dir, f"{lib_a_id}{suffix}"))
    lib_b = b.libraries.load(lib_a_id)
    await b._init_library(lib_b)
    return lib_b


async def _scan(pkg, lib, node, corpus):
    if pkg == "jax":
        from spacedrive_tpu.location.locations import LocationCreateArgs, scan_location

        kw = {}
    else:
        from spacedrive_tpu_torch.location.locations import LocationCreateArgs, scan_location

        kw = {"backend": "cpu"}
    loc = LocationCreateArgs(path=str(corpus)).create(lib)
    await scan_location(lib, loc, node.jobs, **kw)
    await node.jobs.wait_idle()


def _backfill(pkg, lib):
    if pkg == "jax":
        from spacedrive_tpu.sync.ingest import backfill_operations
    else:
        from spacedrive_tpu_torch.sync.ingest import backfill_operations
    backfill_operations(lib.sync)


def _cas_map(db):
    return {r["name"]: r["cas_id"]
            for r in db.query("SELECT name, cas_id FROM file_path WHERE is_dir = 0")}


async def _until(cond, what: str, tries: int = 300, step: float = 0.1):
    for _ in range(tries):
        if cond():
            return
        await asyncio.sleep(step)
    raise AssertionError(f"never: {what}")


async def _converge_via_cloud(tmp_path, a_pkg, b_pkg, relay_pkg):
    """tests/test_cloud.py::test_two_nodes_converge_via_cloud on a
    Node of `a_pkg` and one of `b_pkg` through a relay of `relay_pkg`;
    returns the relay's stored collections by pushing instance."""
    relay = PKG[relay_pkg].CloudRelay()
    port = await relay.start()
    origin = f"http://127.0.0.1:{port}"
    a = await _make_node(a_pkg, str(tmp_path), "a")
    b = await _make_node(b_pkg, str(tmp_path), "b")
    try:
        lib_a = await a.create_library("shared")
        lib_b = await _same_library(b, lib_a.id)
        cloud_a = await a.enable_cloud_sync(lib_a, origin)
        cloud_b = await b.enable_cloud_sync(lib_b, origin)
        cloud_a.poll_interval = cloud_b.poll_interval = 0.1

        # alpha indexes; ops flow A → relay → B
        corpus = tmp_path / "corpus"
        corpus.mkdir()
        for i in range(3):
            (corpus / f"f{i}.bin").write_bytes(os.urandom(1024 + i))
        _backfill(a_pkg, lib_a)
        await _scan(a_pkg, lib_a, a, corpus)
        a_cas = _cas_map(lib_a.db)
        await _until(lambda: lib_b.db.count("location") == 1
                     and _cas_map(lib_b.db) == a_cas
                     and cloud_a.sent_ops > 0 and cloud_b.ingested_ops > 0, "A's rows on B")
        assert lib_b.db.count("file_path") == lib_a.db.count("file_path")
        assert len(a_cas) == 3
        # the cache table drains after ingest
        await _until(lambda: lib_b.db.count("cloud_crdt_operation") == 0, "B's cache drained")

        # reverse direction: a synced write on B reaches A
        ops = lib_b.sync.shared_create("tag", os.urandom(16).hex(), [("name", "from-beta")])
        lib_b.sync.write_ops(list(ops))
        await _until(lambda: lib_a.db.find_one("tag", name="from-beta") is not None,
                     "B's tag on A")

        # state over the router
        state = await b.router.exec(b, "cloud.sync.state", library_id=str(lib_b.id))
        assert state["enabled"] and state["ingested_ops"] > 0
        by_instance = {}
        for c in relay.libraries[str(lib_a.id)]["collections"]:
            by_instance.setdefault(c["instance_uuid"], []).append(c["contents"])
        return by_instance, {str(lib_a.sync.instance): a_pkg, str(lib_b.sync.instance): b_pkg}
    finally:
        await a.shutdown()
        await b.shutdown()
        await relay.shutdown()


def test_two_nodes_converge_via_cloud(tmp_path):
    _run(_converge_via_cloud(tmp_path, "port", "port", "port"), timeout=90.0)


# --- tests/test_chaos.py relay twins -----------------------------------------------------


async def _relay_client(pkg="port"):
    relay = PKG[pkg].CloudRelay()
    port = await relay.start()
    client = PKG[pkg].CloudClient(f"http://127.0.0.1:{port}")
    lib = str(uuid.uuid4())
    inst = str(uuid.uuid4())
    await client.create_library(lib, "chaos")
    await client.add_instance(lib, inst)
    return relay, client, lib, inst


def test_relay_500s_absorbed_by_retries():
    async def run():
        relay, client, lib, inst = await _relay_client()
        try:
            before = counter_value("sd_resilience_retries_total")
            with faults.active(faults.FaultPlan.parse("relay.http:500:times=2")):
                out = await client.pull_ops(lib, inst, {})
            assert out == []  # succeeded despite two injected 500s
            assert counter_value("sd_resilience_retries_total") >= before + 2
        finally:
            await client.close()
            await relay.shutdown()

    _run(run())


def test_relay_timeout_fault_bounded_by_deadline():
    async def run():
        relay, client, lib, inst = await _relay_client()
        try:
            t0 = time.monotonic()
            with faults.active(faults.FaultPlan.parse("relay.http:timeout:delay_s=30,times=1")):
                with resilience.deadline_scope(0.3):
                    with pytest.raises(Exception):
                        await client.pull_ops(lib, inst, {})
            assert time.monotonic() - t0 < 5.0
        finally:
            await client.close()
            await relay.shutdown()

    _run(run())


def test_relay_midbody_eof_trips_breaker_then_rearms():
    async def run():
        relay, client, lib, inst = await _relay_client()
        try:
            breaker = RELAY_POLICY.breaker(client.origin)
            with faults.active(faults.FaultPlan.parse("relay.http:truncate:times=20")):
                with pytest.raises(Exception):
                    await client.pull_ops(lib, inst, {})
                assert breaker.failures >= 3  # every EOF counted
                while breaker.state != resilience.OPEN:
                    with pytest.raises(Exception):
                        await client.pull_ops(lib, inst, {})
                with pytest.raises(resilience.BreakerOpen):
                    await client.pull_ops(lib, inst, {})
            # recovery: half-open probe after the reset window
            breaker.reset_timeout = 0.05
            await asyncio.sleep(0.1)
            assert await client.pull_ops(lib, inst, {}) == []
            assert breaker.state == resilience.CLOSED
        finally:
            await client.close()
            await relay.shutdown()

    _run(run())


def test_relay_4xx_neither_retries_nor_feeds_breaker():
    async def run():
        relay, client, lib, inst = await _relay_client()
        try:
            before = counter_value("sd_resilience_retries_total")
            with pytest.raises(CloudApiError) as exc:
                await client.push_telemetry(lib, "not-an-instance", {"v": 1})
            assert exc.value.status == 400
            assert counter_value("sd_resilience_retries_total") == before
            assert RELAY_POLICY.breaker(client.origin).failures == 0
        finally:
            await client.close()
            await relay.shutdown()

    _run(run())


# --- tests/test_mesh_observability.py twin -----------------------------------------------


def test_relay_telemetry_push_pull_roundtrip():
    from spacedrive_tpu_torch.telemetry.federation import local_snapshot

    async def run():
        relay = pcloud.CloudRelay()
        port = await relay.start()
        client = pcloud.CloudClient(f"http://127.0.0.1:{port}")
        try:
            lib_id = str(uuid.uuid4())
            inst_a, inst_b = str(uuid.uuid4()), str(uuid.uuid4())
            await client.create_library(lib_id, "fed")
            await client.add_instance(lib_id, inst_a)
            await client.add_instance(lib_id, inst_b)
            snap = json.loads(json.dumps(local_snapshot(), default=str))
            await client.push_telemetry(lib_id, inst_a, snap)
            # the pusher does not see its own snapshot; the other does
            assert await client.pull_telemetry(lib_id, inst_a) == []
            rows = await client.pull_telemetry(lib_id, inst_b)
            assert len(rows) == 1
            assert rows[0]["instance_uuid"] == inst_a
            assert rows[0]["snapshot"]["v"] == snap["v"]
            assert rows[0]["age_seconds"] >= 0.0
        finally:
            await client.close()
            await relay.shutdown()

    _run(run())


# --- mixed: either client against either relay -------------------------------------------


LIB = "6f1c2a1e-0000-4000-8000-000000000001"
INST_A = "6f1c2a1e-0000-4000-8000-00000000000a"
INST_B = "6f1c2a1e-0000-4000-8000-00000000000b"


async def _script(client) -> list:
    """Every endpoint once or more; the answers, `age_seconds` as its
    type and sign (its value is the relay's clock)."""
    out = [await client.create_library(LIB, "mixed"),
           await client.create_library(LIB, "renamed"),  # a second create keeps the first
           await client.get_library(LIB),
           await client.add_instance(LIB, INST_A, identity="id-a", node_name="alpha"),
           await client.add_instance(LIB, INST_B),
           await client.list_instances(LIB),
           await client.push_ops(LIB, INST_A, b"\x00packed\xffone"),
           await client.push_ops(LIB, INST_A, b"packed-two"),
           await client.push_ops(LIB, INST_B, b"from-b"),
           await client.pull_ops(LIB, INST_B, {}),
           await client.pull_ops(LIB, INST_B, {INST_A: 1}),
           await client.pull_ops(LIB, INST_B, {}, count=1),
           await client.pull_ops(LIB, INST_A, {}),
           await client.push_telemetry(LIB, INST_A, {"v": 1, "health": {"status": "healthy"}}),
           await client.pull_telemetry(LIB, INST_A)]
    rows = await client.pull_telemetry(LIB, INST_B)
    for r in rows:
        age = r.pop("age_seconds")
        r["age_seconds"] = (type(age).__name__, age >= 0.0)
    out.append(rows)
    return out


def test_mixed_clients_and_relays_answer_alike():
    async def run():
        seen = {}
        for relay_pkg in ("port", "jax"):
            for client_pkg in ("port", "jax"):
                relay = PKG[relay_pkg].CloudRelay()
                port = await relay.start()
                client = PKG[client_pkg].CloudClient(f"http://127.0.0.1:{port}")
                try:
                    seen[(relay_pkg, client_pkg)] = await _script(client)
                    seen[(relay_pkg, "stored")] = relay.libraries[LIB]["collections"]
                finally:
                    await client.close()
                    await relay.shutdown()
        want = seen[("jax", "jax")]
        for key in (("port", "jax"), ("jax", "port"), ("port", "port")):
            assert seen[key] == want, key
        # the base64 the relay stores is JAX's
        assert seen[("port", "stored")] == seen[("jax", "stored")]
        assert want[9][0]["contents"] == b"\x00packed\xffone"

    _run(run())


BAD_REQUESTS = [
    ("GET", f"/api/libraries/{uuid.UUID(int=7)}", None, None),                    # unknown library
    ("GET", f"/api/libraries/{uuid.UUID(int=7)}/instances", None, None),
    ("POST", f"/api/libraries/{uuid.UUID(int=7)}/messageCollections",
     {"instance_uuid": INST_A, "contents": ""}, None),
    ("POST", f"/api/libraries/{LIB}/messageCollections",                           # unknown instance
     {"instance_uuid": str(uuid.UUID(int=9)), "contents": "eA=="}, None),
    ("POST", f"/api/libraries/{LIB}/telemetry", {"instance_uuid": "nope", "snapshot": {}}, None),
    ("POST", f"/api/libraries/{LIB}/telemetry", {"instance_uuid": INST_A, "snapshot": [1]},
     None),                                                                        # bad snapshot
    ("POST", "/api/libraries", None, b"{not json"),                                # malformed JSON
    ("POST", f"/api/libraries/{LIB}/instances", None, b""),
    ("POST", f"/api/libraries/{LIB}/messageCollections/get", None, b"[1,"),
    ("POST", "/api/libraries", {"name": "no uuid"}, None),                         # missing fields
    ("POST", f"/api/libraries/{LIB}/instances", {"identity": "x"}, None),
    ("POST", f"/api/libraries/{LIB}/messageCollections", {"contents": "eA=="}, None),
    ("POST", f"/api/libraries/{LIB}/messageCollections/get", {"cursors": {}}, None),
    ("POST", f"/api/libraries/{LIB}/messageCollections/get",
     {"instance_uuid": INST_A, "cursors": {INST_B: "x"}}, None),                   # a bad cursor
    ("GET", "/api/nothing", None, None),                                           # no route
    ("DELETE", "/api/libraries", None, None),                                      # other method
]


@pytest.mark.parametrize("method,path,body,data", BAD_REQUESTS,
                         ids=[f"{i:02d}-{m}" for i, (m, *_r) in enumerate(BAD_REQUESTS)])
def test_mixed_bad_requests_answer_alike(method, path, body, data):
    aiohttp = pytest.importorskip("aiohttp")

    async def run():
        seen = {}
        for relay_pkg in ("port", "jax"):
            relay = PKG[relay_pkg].CloudRelay()
            port = await relay.start()
            setup = PKG[relay_pkg].CloudClient(f"http://127.0.0.1:{port}")
            ours = http.HttpClient()
            try:
                await setup.create_library(LIB, "bad")
                await setup.add_instance(LIB, INST_A)
                url = f"http://127.0.0.1:{port}{path}"
                async with aiohttp.ClientSession() as theirs:
                    async with theirs.request(method, url, json=body, data=data) as r:
                        seen[(relay_pkg, "aiohttp")] = (r.status, await r.read())
                r = await ours.request(method, url, json=body, data=data)
                seen[(relay_pkg, "port")] = (r.status, r.body)
            finally:
                await ours.close()
                await setup.close()
                await relay.shutdown()
        assert len(set(seen.values())) == 1, seen
        assert seen[("jax", "aiohttp")][0] >= 400

    _run(run())


FAULTS = [
    ("relay.http:500:times=1", None),
    ("relay.http:500:times=3", None),
    ("relay.http:truncate:times=1", None),
    ("relay.http:truncate:times=3", None),
    ("relay.http:timeout:delay_s=2,times=1", 0.3),
]


@pytest.mark.parametrize("plan,deadline", FAULTS, ids=[p.split(":", 1)[1] for p, _ in FAULTS])
def test_mixed_relay_faults_seen_alike_by_the_jax_client(plan, deadline):
    """JAX's client, against either relay under one `relay.http` plan
    (installed in the relay's own package): the same result or error
    status, and the same retries on JAX's counter."""

    async def one(relay_pkg):
        relay = PKG[relay_pkg].CloudRelay()
        port = await relay.start()
        client = jcloud.CloudClient(f"http://127.0.0.1:{port}")
        fplane = faults if relay_pkg == "port" else jfaults
        try:
            await client.create_library(LIB, "faults")
            await client.add_instance(LIB, INST_A)
            await client.push_ops(LIB, INST_A, b"one")
            before = jtelemetry.counter_value("sd_resilience_retries_total")
            with fplane.active(fplane.FaultPlan.parse(plan)):
                t0 = time.monotonic()
                try:
                    if deadline is None:
                        got = ("ok", await client.pull_ops(LIB, INST_B, {}))
                    else:
                        with jresilience.deadline_scope(deadline):
                            got = ("ok", await client.pull_ops(LIB, INST_B, {}))
                except jcloud.CloudApiError as e:
                    got = ("CloudApiError", e.status)
                except (TimeoutError, jresilience.DeadlineExceeded) as e:
                    got = ("timeout", type(e).__name__)
                took = time.monotonic() - t0
                fired = fplane.active_plan().activations()
            retries = jtelemetry.counter_value("sd_resilience_retries_total") - before
            return got, retries, fired, took
        finally:
            jresilience.reset_breakers()
            await client.close()
            await relay.shutdown()

    async def run():
        jax_side = await one("jax")
        port_side = await one("port")
        assert port_side[:3] == jax_side[:3], (port_side, jax_side)
        if deadline is not None:
            assert port_side[3] < 5.0

    _run(run())


@pytest.mark.parametrize("owner,joiner,relay_pkg", [
    ("jax", "port", "port"), ("port", "jax", "port"), ("port", "jax", "jax")],
    ids=["jax-owner-port-relay", "port-owner-port-relay", "port-owner-jax-relay"])
def test_mixed_nodes_converge_through_one_relay(tmp_path, owner, joiner, relay_pkg):
    by_instance, pkg_of = _run(_converge_via_cloud(tmp_path, owner, joiner, relay_pkg),
                               timeout=90.0)
    assert set(pkg_of.values()) == {"jax", "port"}
    assert set(by_instance) == set(pkg_of)  # both instances pushed
    for inst, contents in by_instance.items():
        for c in contents:
            raw = pcloud.relay.unb64(c)
            # the bytes each side pushed are what JAX packs for its ops,
            # and the port reads and packs them back the same
            assert JCompressed.compress(JCompressed.unpack(raw).expand()).pack() == raw
            assert PCompressed.compress(PCompressed.unpack(raw).expand()).pack() == raw


# --- the federation's relay leg ----------------------------------------------------------


def test_federation_relay_leg_between_undiscovered_nodes(tmp_path):
    async def run():
        from spacedrive_tpu_torch.node.config import P2PDiscoveryState
        from spacedrive_tpu_torch.p2p.manager import P2PManager

        relay = pcloud.CloudRelay()
        port = await relay.start()
        origin = f"http://127.0.0.1:{port}"
        a = await _make_node("port", str(tmp_path), "fed-a")
        b = await _make_node("port", str(tmp_path), "fed-b")
        try:
            for n in (a, b):
                n.config.config.p2p.discovery = P2PDiscoveryState.DISABLED
                n.p2p = P2PManager(n, beacon_addrs=[], bind_host="127.0.0.1")
                await n.p2p.start()
                assert not n.p2p.p2p._discovery
            lib_a = await a.create_library("fed")
            lib_b = await _same_library(b, lib_a.id)
            for n, lib in ((a, lib_a), (b, lib_b)):
                await n.router.exec(n, "cloud.setApiOrigin", origin)
                got = await n.router.exec(n, "cloud.sync.enable", library_id=str(lib.id))
                assert got == {"instance": str(lib.sync.instance), "enabled": True}
            # B pushes its snapshot; A, reaching no peer directly, pulls it
            # through the relay
            await b.p2p.refresh_federation(force=True)
            assert a.p2p.p2p.discovered_peers() == []
            assert a.p2p.peer_for_instance(lib_b.sync.instance) is None
            mesh = await a.p2p.refresh_federation(force=True)
            pid = f"instance:{lib_b.sync.instance}"
            assert set(mesh["peers"]) == {pid}
            assert mesh["peers"][pid]["transport"] == "relay"
            assert mesh["peers"][pid]["error"] is None
            assert mesh["peers"][pid]["snapshot"]["node"]["name"] == "fed-b"
        finally:
            await a.shutdown()
            await b.shutdown()
            await relay.shutdown()

    _run(run())


# --- the router's cloud.* procedures and the node ----------------------------------------


def test_cloud_procedures_and_enable_cloud_sync(tmp_path):
    async def run():
        relay = pcloud.CloudRelay()
        port = await relay.start()
        origin = f"http://127.0.0.1:{port}"
        node = await _make_node("port", str(tmp_path), "n")
        try:
            lib = await node.create_library("one")
            lid = str(lib.id)
            assert await node.router.exec(node, "cloud.getApiOrigin") is None
            assert await node.router.exec(node, "cloud.library.get", library_id=lid) is None
            assert await node.router.exec(node, "cloud.sync.state", library_id=lid) == {
                "enabled": False}
            with pytest.raises(Exception) as exc:  # no origin: a 400
                await node.router.exec(node, "cloud.sync.enable", library_id=lid)
            assert getattr(exc.value, "code", None) == 400
            with pytest.raises(ValueError):
                await node.enable_cloud_sync(lib)
            await node.router.exec(node, "cloud.setApiOrigin", origin)
            assert await node.router.exec(node, "cloud.getApiOrigin") == origin
            assert node.config.config.preferences["cloud_api_origin"] == origin
            await node.router.exec(node, "cloud.sync.enable", library_id=lid)
            first = lib.cloud_sync
            assert first is not None and "cloudSync" in [f.value for f in
                                                          node.config.config.features]
            assert await node.router.exec(node, "cloud.library.get", library_id=lid) == {
                "uuid": lid, "name": "one"}
            # the same origin keeps the trio; another replaces it
            assert await node.enable_cloud_sync(lib) is first
            relay2 = pcloud.CloudRelay()
            port2 = await relay2.start()
            second = await node.enable_cloud_sync(lib, f"http://127.0.0.1:{port2}/")
            assert second is not first and first._stopped and first.client._session is None
            assert second.client.origin == f"http://127.0.0.1:{port2}"
            # an unreachable relay is a 502
            await relay2.shutdown()
            await node.close_library(lib.id)
            assert second._stopped and lib.cloud_sync is None
            lib2 = await node.create_library("two")
            await node.router.exec(node, "cloud.setApiOrigin", f"http://127.0.0.1:{port2}")
            with pytest.raises(Exception) as exc:
                await node.router.exec(node, "cloud.sync.enable", library_id=str(lib2.id))
            assert getattr(exc.value, "code", None) == 502
            assert lib2.cloud_sync is None
        finally:
            await node.shutdown()
            await relay.shutdown()

    _run(run())


def test_cli_relay_serves_sync_and_rendezvous(capsys):
    async def run():
        args = cli.build_parser().parse_args(
            ["relay", "--host", "127.0.0.1", "--port", "0", "--p2p-port", "0",
             "--stats-interval", "0.05", "--max-pipes", "3"])
        task = asyncio.ensure_future(cli._relay(args))
        lines = []
        while not any(ln.startswith("relay stats:") for ln in lines):
            await asyncio.sleep(0.02)
            lines += capsys.readouterr().out.splitlines()
        url = lines[0].split("sync API on ")[1].split("/api")[0]
        client = pcloud.CloudClient(url)
        try:
            await client.create_library(LIB, "cli")
            assert (await client.get_library(LIB))["name"] == "cli"
        finally:
            await client.close()
        assert lines[1].startswith("relay: p2p rendezvous on 127.0.0.1:")
        assert json.loads(lines[2].split("relay stats: ")[1])["pipes_opened"] == 0
        task.cancel()
        assert await task == 0

    _run(run())
