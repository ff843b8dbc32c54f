"""The federation's peer half in the port: twins of the JAX package's
mesh gates, over the port's loopback pair (`p2p/loopback.py`: two port
Nodes on the CPU, managers linked by the in-process duplex).

- tests/test_profile.py: each side's federated snapshot carries the
  peer's profile summary, a `profile_pull` is redaction-clean, and a
  `p2p.profile_pull` vanish degrades the mesh profile to partial;
- tests/test_slo_history.py: a peer's sustained SLO breach shows on the
  other side's mesh view;
- tests/test_tenants.py: tenant digests ride the TELEMETRY wire onto the
  peer's mesh view and survive a partition as stale (read through the
  router: the HTTP host waits for the API server);
- tests/test_semantic_search.py: a replica's vector index, folded by the
  ingest hook alone, answers semantic search;
- tests/test_mesh_observability.py: the sync verdict corroborated by a
  fresh peer snapshot, the cache's staleness rules, the TELEMETRY header
  round trip; and a trace assembly that pulls the peer's spans.

Every case runs under its own asyncio timeout and shuts its nodes down
in `finally`.
"""

import asyncio
import json
import os
import time
import types
import uuid

import numpy as np

from spacedrive_tpu_torch import telemetry
from spacedrive_tpu_torch.p2p.loopback import Pipe, make_mesh_pair
from spacedrive_tpu_torch.telemetry import sampler
from spacedrive_tpu_torch.telemetry import tenants as tenants_mod
from spacedrive_tpu_torch.telemetry.federation import mesh_status
from spacedrive_tpu_torch.utils import faults

PLANTED_KEY = "sk-profile-plane-super-secret-value-1234567890"


def _run(coro, timeout: float = 90.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def test_mesh_profile_summaries_and_pull(tmp_path):
    telemetry.reset()

    async def run():
        a, b, _lib_a, _lib_b, _tasks = await make_mesh_pair(tmp_path)
        try:
            b.config.config.preferences["cloud_api_token"] = PLANTED_KEY
            deadline = time.monotonic() + 5.0
            while (sampler.SAMPLER.profile().get("samples", 0) < 5
                   and time.monotonic() < deadline):
                await asyncio.sleep(0.05)

            await a.p2p.refresh_federation(force=True)
            peers = mesh_status(a)["mesh"]["peers"]
            assert peers, "peer must be federated"
            for entry in peers.values():
                prof = (entry["snapshot"] or {}).get("profile")
                assert prof is not None and prof.get("enabled")
                assert prof.get("samples", 0) >= 0 and "top_groups" in prof

            profiles, failures = await a.p2p.pull_remote_profiles()
            assert profiles and not failures, (profiles, failures)
            pulled = next(iter(profiles.values()))
            assert pulled["profile"]["enabled"]
            assert PLANTED_KEY not in json.dumps(pulled)
            assert str(tmp_path) not in str(pulled.get("folded", ""))

            mesh_doc = await sampler.mesh_profile(a)
            assert mesh_doc["partial"] is False and mesh_doc["mesh"], mesh_doc

            from spacedrive_tpu_torch.p2p import operations as _ops

            prev_timeout = _ops.TELEMETRY_TIMEOUT
            _ops.TELEMETRY_TIMEOUT = 1.5
            try:
                with faults.active(faults.FaultPlan.parse("p2p.profile_pull:vanish:times=inf")):
                    t0 = time.monotonic()
                    partial = await sampler.mesh_profile(a)
                    elapsed = time.monotonic() - t0
            finally:
                _ops.TELEMETRY_TIMEOUT = prev_timeout
            assert partial["partial"] is True and partial["pull_failures"], partial
            assert partial["local"]["enabled"]
            assert elapsed < 60.0
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run())


def test_slo_breach_visible_on_peer_mesh_view(tmp_path):
    telemetry.reset()

    async def run():
        a, b, _lib_a, _lib_b, _tasks = await make_mesh_pair(tmp_path)
        try:
            a.history._samplers = {"sync_lag_max_s": lambda: 5000.0}
            now = time.time()
            for i in range(12):
                a.history.sample(now=now - 12 + i)
            await b.p2p.refresh_federation(force=True)
            return mesh_status(b)
        finally:
            await a.shutdown()
            await b.shutdown()

    doc = _run(run())
    peers = doc["mesh"]["peers"]
    assert peers, "B pulled no snapshots"
    [entry] = peers.values()
    assert entry["snapshot"]["health"]["subsystems"]["slo"]["status"] == "unhealthy"
    assert entry["verdict"] == "unhealthy"
    telemetry.reset()


def test_two_node_tenant_digests_on_peer_mesh(tmp_path):
    telemetry.reset()

    async def run():
        a, b, lib_a, _lib_b, _tasks = await make_mesh_pair(tmp_path)
        try:
            planted = uuid.uuid4()
            tenants_mod.observe("serve", planted, seconds=0.02)
            tenants_mod.observe("relay_push", str(lib_a.id))
            label = tenants_mod.tenant_label(planted)
            a.p2p.federation.refresh_interval = 0.0
            mesh_doc = await a.router.exec(a, "telemetry.mesh", {})
            tenants_doc = await a.router.exec(a, "telemetry.tenants")

            assert "serve" in mesh_doc["local"]["tenants"]
            b_key = str(b.p2p.p2p.remote_identity)
            entry = mesh_doc["mesh"]["peers"][b_key]
            assert entry["stale"] is False
            peer_digest = entry["snapshot"]["tenants"]
            assert peer_digest["serve"]["total"] >= 1.0
            assert peer_digest["serve"]["top"][0]["tenant"] == label
            everything = json.dumps([mesh_doc, tenants_doc], default=str)
            assert str(planted) not in everything and planted.hex not in everything
            assert str(lib_a.id) not in json.dumps(tenants_doc, default=str)
            assert label in everything

            # partition: stale, then unhealthy, the digest retained
            a.p2p.federation.stale_after = 0.3

            async def refuse(identity, timeout=10.0):
                raise ConnectionError("partitioned")

            a.p2p.p2p.new_stream = refuse
            await asyncio.sleep(0.4)
            entry2 = (await a.p2p.refresh_federation(force=True))["peers"][b_key]
            assert entry2["stale"] is True and entry2["verdict"] == "unhealthy"
            assert "serve" in entry2["snapshot"]["tenants"]
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run())


def _image_corpus(root, n=8, seed=0, dup_of=3):
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        yy, xx = np.mgrid[0:48, 0:48] / 48.0
        a, b, c = rng.uniform(-3, 3, 3)
        img = np.stack([np.sin(a * xx + b * yy + c + k) * 0.5 + 0.5 for k in range(3)], -1)
        Image.fromarray((img * 255).astype(np.uint8)).save(os.path.join(root, f"img{i:02d}.png"))
    src = os.path.join(root, f"img{dup_of:02d}.png")
    Image.open(src).save(os.path.join(root, "dup.jpg"), quality=40)
    return src


def _embedding_count(lib):
    return lib.db.query_one("SELECT COUNT(*) AS n FROM object_embedding")["n"]


def test_replicated_index_answers_semantic_search(tmp_path):
    """Index on A; B converges over the loopback duplex; B's index, kept
    by the ingest hook alone, ranks the probe's image and its planted
    near-duplicate first."""

    async def run():
        from spacedrive_tpu_torch.api.search import search_semantic
        from spacedrive_tpu_torch.location.locations import LocationCreateArgs, scan_location
        from spacedrive_tpu_torch.object.search import index as search_index

        src = _image_corpus(str(tmp_path / "corpus"))
        a, b, lib_a, lib_b, _tasks = await make_mesh_pair(tmp_path)
        try:
            loc = LocationCreateArgs(path=str(tmp_path / "corpus")).create(lib_a)
            await scan_location(lib_a, loc, a.jobs, backend="cpu")
            await a.jobs.wait_idle()
            n_a = _embedding_count(lib_a)
            assert n_a == 9
            deadline = asyncio.get_running_loop().time() + 30.0
            while asyncio.get_running_loop().time() < deadline:
                if _embedding_count(lib_b) >= n_a:
                    break
                if lib_b.ingest is not None:
                    lib_b.ingest.notify()
                await asyncio.sleep(0.1)
            assert _embedding_count(lib_b) == n_a
            idx_b = search_index.get_index(lib_b)
            for _ in range(100):
                if len(idx_b) >= n_a:
                    break
                await asyncio.sleep(0.05)
            assert len(idx_b) == n_a
            out = await asyncio.to_thread(search_semantic, lib_b, {"query": src, "take": 2})
            assert out["resolved"] is True
            names = [n["name"] + "." + n["extension"] for n in out["nodes"]]
            assert names == ["img03.png", "dup.jpg"]
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run(), 180)


def test_health_sync_gap_corroborated_by_federation():
    from spacedrive_tpu_torch.sync.hlc import NTP64
    from spacedrive_tpu_torch.telemetry import health
    from spacedrive_tpu_torch.telemetry.federation import FederationCache

    telemetry.reset()
    lib_id = str(uuid.uuid4())
    now = time.time()

    def _node(our_head, peer_head):
        cache = FederationCache()
        cache.store("peer-x", {
            "v": 1, "ts": now, "health": {"status": "healthy"},
            "node": {"id": "x", "name": "x", "libraries": {
                lib_id: {"instance_label": "cafecafe", "head_seconds": peer_head}}},
        })
        lib = types.SimpleNamespace(id=lib_id, sync=types.SimpleNamespace(
            observe_replication_lag=lambda: {},
            clock=types.SimpleNamespace(peek_last=lambda: NTP64.from_unix(our_head))))
        return types.SimpleNamespace(
            libraries=types.SimpleNamespace(libraries={lib_id: lib}),
            p2p=types.SimpleNamespace(federation=cache))

    assert health.evaluate(_node(now, now))["subsystems"]["sync"]["status"] == health.HEALTHY
    sync = health.evaluate(_node(now - 700, now))["subsystems"]["sync"]
    assert sync["status"] == health.UNHEALTHY and "not yet applied" in sync["reason"]
    telemetry.reset()


def test_federation_cache_staleness_rules():
    from spacedrive_tpu_torch.telemetry.federation import (
        SNAPSHOT_VERSION,
        FederationCache,
        local_snapshot,
        snapshot_compatible,
    )

    telemetry.reset()
    snap = local_snapshot()
    assert snap["v"] == SNAPSHOT_VERSION and snapshot_compatible(snap)
    assert not snapshot_compatible({"v": SNAPSHOT_VERSION + 1})
    assert not snapshot_compatible("nonsense")

    cache = FederationCache(stale_after=0.4, refresh_interval=0.1)
    cache.store("peer-1", snap)
    m = cache.mesh()["peers"]["peer-1"]
    assert m["stale"] is False and m["verdict"] == snap["health"]["status"]
    assert not cache.needs_refresh("peer-1")
    cache.record_failure("peer-1", "connection refused")
    m = cache.mesh()["peers"]["peer-1"]
    assert m["snapshot"] is not None and m["error"] == "connection refused"
    time.sleep(0.45)
    m = cache.mesh()["peers"]["peer-1"]
    assert m["stale"] is True and m["verdict"] == "unhealthy"
    assert cache.needs_refresh("peer-1")
    cache.store("peer-2", snap, transport="relay", age_seconds=999.0)
    m = cache.mesh()["peers"]["peer-2"]
    assert m["stale"] is True and m["transport"] == "relay"
    assert cache.due_relay_peers() == ["peer-2"]
    cache.store("peer-3", snap, transport="p2p")
    cache.store("peer-3", snap, transport="relay", age_seconds=999.0)
    m = cache.mesh()["peers"]["peer-3"]
    assert m["stale"] is False and m["transport"] == "p2p"


def test_telemetry_header_roundtrip():
    from spacedrive_tpu_torch.p2p.protocol import Header, HeaderType

    async def run():
        pipe = Pipe()
        trace = {"trace_id": "ab" * 16, "span_id": "cd" * 8}
        await Header(HeaderType.TELEMETRY, trace=trace).write(pipe)
        back = await Header.read(pipe)
        assert back.type == HeaderType.TELEMETRY and back.trace == trace
        await Header(HeaderType.TELEMETRY).write(pipe)
        back = await Header.read(pipe)
        assert back.type == HeaderType.TELEMETRY and back.trace is None

    _run(run(), 10)


def test_attrib_assembly_pulls_peer_spans(tmp_path):
    """A trace whose spans sit on both nodes: A's assembly pulls B's over
    the `trace_pull` op, tagged with B's peer label; a vanished peer
    makes the report partial."""
    from spacedrive_tpu_torch.telemetry import attrib
    from spacedrive_tpu_torch.telemetry import trace as sdtrace
    from spacedrive_tpu_torch.telemetry.peers import peer_label

    telemetry.reset()

    async def run():
        a, b, _lib_a, _lib_b, _tasks = await make_mesh_pair(tmp_path)
        try:
            tid = "ab" * 16
            ctx = sdtrace.TraceContext.from_wire({"trace_id": tid, "span_id": "cd" * 8})
            with sdtrace.use(ctx):
                with telemetry.span("identify.hash"):
                    await asyncio.sleep(0.01)
            doc = await attrib.assemble(a, tid, refresh=True)
            assert doc["partial"] is False and doc["remote_spans"] >= 1
            label = peer_label(str(b.p2p.p2p.remote_identity))
            from spacedrive_tpu_torch.p2p import operations as _ops

            prev_timeout = _ops.TELEMETRY_TIMEOUT
            _ops.TELEMETRY_TIMEOUT = 1.5
            try:
                with faults.active(faults.FaultPlan.parse("p2p.trace_pull:vanish:times=inf")):
                    partial = await attrib.assemble(a, tid, refresh=True)
            finally:
                _ops.TELEMETRY_TIMEOUT = prev_timeout
            assert partial["partial"] is True and label in partial["pull_failures"]
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run())
