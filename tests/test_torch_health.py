"""The port's health model, the local half of its federation, and what
they read from sync and the journal, against the JAX package's.

- `health.evaluate` over the same registry state (seeded loop lag,
  feeder waits, ladder level, dispatch occupancy, p2p episodes, sync lag
  and delta-guard trips, breakers, tenants, a resource sample and one
  history for the SLOs): equal verdicts, subsystem by subsystem, and the
  thresholds are JAX's (`LOOP_LAG_DEGRADED` among them, which the
  controller reads from here again);
- `local_snapshot` on the same registry: equal but for the node's own
  id, and the evaluation time; `_ring_digests` report drops (the 6.2a
  case that waited for this plane);
- `SyncManager.replication_watermarks` / `observe_replication_lag`,
  `HybridLogicalClock.peek_last` and `IndexJournal.location_stats` on
  one library DB: equal;
- the procedures `telemetry.health`, `slo`, `tenants`, `serve` and
  `mesh` of a port Node beside a JAX Node (`SD_SERVE_GATE=0`) after the
  same scan, and the CLI's `tenants` and `mesh-status`, in-process and
  against a node surface.

Exact comparisons but where a verdict reads the time a run took (the
scans' feeder waits), which is compared by vocabulary.
"""

import asyncio
import http.server
import json
import threading
import time
import uuid

import numpy as np
import pytest

import spacedrive_tpu.telemetry as jtelemetry
from spacedrive_tpu.telemetry import events as jevents
from spacedrive_tpu.telemetry import health as jhealth
from spacedrive_tpu.telemetry import history as jhistory
from spacedrive_tpu.telemetry import metrics as jm
from spacedrive_tpu.telemetry import resources as jresources
from spacedrive_tpu.telemetry import tenants as jtenants
from spacedrive_tpu.utils import resilience as jres
from spacedrive_tpu_torch import cli, telemetry
from spacedrive_tpu_torch.telemetry import events, health, history
from spacedrive_tpu_torch.telemetry import metrics as pm
from spacedrive_tpu_torch.telemetry import resources, tenants
from spacedrive_tpu_torch.utils import resilience as res

PKG = {
    "port": (pm, events, resources, tenants, res, history, health),
    "jax": (jm, jevents, jresources, jtenants, jres, jhistory, jhealth),
}


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    """Both packages' breakers, telemetry and controllers start and end
    each test at rest (the rollup embeds the controller's knobs)."""
    from spacedrive_tpu.parallel import autotune as jautotune
    from spacedrive_tpu_torch.parallel import autotune

    def at_rest():
        for m in (res, jres):
            m.reset_breakers()
        for m in (autotune, jautotune, telemetry, jtelemetry):
            m.reset()

    monkeypatch.setenv("SD_SERVE_GATE", "0")
    at_rest()
    yield
    at_rest()


def test_thresholds_equal_jax_and_the_controller_reads_them():
    from spacedrive_tpu_torch.parallel import autotune

    for name in ("LOOP_LAG_DEGRADED", "LOOP_LAG_UNHEALTHY", "FEEDER_WAIT_DEGRADED",
                 "FEEDER_WAIT_UNHEALTHY", "OCCUPANCY_DEGRADED", "P2P_EPISODES_DEGRADED",
                 "P2P_EPISODES_UNHEALTHY", "P2P_EPISODE_TYPES", "P2P_WINDOW_SECONDS",
                 "SYNC_GAP_DEGRADED", "SYNC_GAP_UNHEALTHY", "DOMINANT_DEGRADED", "_RANK"):
        assert getattr(health, name) == getattr(jhealth, name), name
    assert not hasattr(autotune, "LOOP_LAG_DEGRADED")
    lagging = autotune.Sample(loop_lag_s=health.LOOP_LAG_DEGRADED)
    assert autotune.Controller._loop_lagging(lagging)
    assert not autotune.Controller._loop_lagging(autotune.Sample(loop_lag_s=0.19))


def _plant(pkg, seed, hist_dir):
    """One seeded registry state in one package; returns its fake node."""
    m, ev, rsrc, ten, resil, hist, _ = PKG[pkg]
    rng = np.random.default_rng(seed)
    m.EVENT_LOOP_LAG.set(float(rng.choice([0.0, 0.05, 0.3, 1.5])))
    for w in rng.choice([0.0, 0.2, 0.9, 1.2, 6.0], int(rng.integers(0, 6))):
        m.FEEDER_WAIT_SECONDS.observe(float(w))
    m.DEVICE_DEMOTION.set(float(rng.choice([0, 0, 1, 2])))
    for occ in rng.uniform(0, 1, int(rng.integers(0, 5))):
        m.DEVICE_DISPATCH_OCCUPANCY.observe(float(occ), op="blake3")
    for _ in range(int(rng.choice([0, 10, 40, 130]))):
        ev.P2P_EVENTS.emit(str(rng.choice(["rto_timeout", "bad_ack", "connect"])))
    if rng.random() < 0.5:
        m.SYNC_LAG.set(float(rng.uniform(0, 900)), peer="aabbccdd")
    if rng.random() < 0.3:
        m.HLC_DELTA_GUARD.inc()
    if rng.random() < 0.5:
        resil.ResiliencePolicy("p", failure_threshold=1).breaker("relay").record_failure()
    for i in range(int(rng.choice([0, 3, 60]))):
        ten.observe("serve", uuid.UUID(int=1 if i % 20 else 2))
    with rsrc.SAMPLER._lock:
        rsrc.SAMPLER._last = {"rss_bytes": 1e9, "fds": 40.0, "threads": 9.0}
        rsrc.SAMPLER._samples = 3
    w = hist.HistoryWriter(hist_dir, samplers={})
    w._prime_tail()

    class FakeNode:
        history = w

    return FakeNode


def _strip(doc):
    doc = dict(doc)
    doc.pop("autotune", None)  # the port's controller has no stage plane
    return doc


@pytest.mark.parametrize("seed", range(10))
def test_evaluate_over_the_same_registry_state_equals_jax(seed, tmp_path):
    hist_dir = str(tmp_path / "hist")
    w = history.HistoryWriter(hist_dir, samplers=None)
    rng = np.random.default_rng(1000 + seed)
    now = time.time()
    for i in range(30):
        w._samplers = {"sync_lag_max_s": lambda v=float(rng.uniform(0, 1200)): v,
                       "files_per_s": lambda v=float(rng.choice([0, 30, 90])): v,
                       "protected_sheds_total": lambda: 0.0}
        w.sample(now=now - 300 + i * 10)
    got = health.evaluate(_plant("port", seed, hist_dir))
    want = jhealth.evaluate(_plant("jax", seed, hist_dir))
    assert _strip(got) == _strip(want)
    assert set(got["autotune"]) <= set(want["autotune"]) | {"stages"}
    assert got["autotune"]["policies"] == want["autotune"]["policies"]


def test_a_quiet_process_is_healthy_with_unknowns_as_jax():
    got, want = health.evaluate(), jhealth.evaluate()
    assert _strip(got) == _strip(want)
    subs = got["subsystems"]
    assert got["status"] == health.HEALTHY
    assert subs["serve"] == {"status": "unknown", "reason": "serve gate disabled or absent"}
    assert subs["device"]["status"] == subs["feeder"]["status"] == health.UNKNOWN
    assert list(subs) == ["event_loop", "feeder", "device", "p2p", "sync", "resilience",
                          "serve", "slo", "resources", "tenants"]


class _FakeConfig:
    id = uuid.UUID(int=7)
    name = "fake-node"


class _FakeNode:
    class config:  # noqa: N801 - the Node's attribute name
        config = _FakeConfig

    libraries = None
    history = None


def _declared_rings(ev):
    """The flight-recorder rings a package's events module declares."""
    return {r.name: r for r in vars(ev).values() if isinstance(r, ev.EventRing)}


def test_local_snapshot_equals_jax_but_for_the_node_id(monkeypatch):
    from spacedrive_tpu.telemetry import federation as jfed
    from spacedrive_tpu_torch.telemetry import federation

    # the ring registry is process-wide and keeps every ring ever made:
    # tests/test_telemetry.py's probe rings stay in the JAX package's when
    # that file ran earlier in the same worker, and the digests list them;
    # both packages digest the rings their events modules declare
    assert set(_declared_rings(events)) == set(_declared_rings(jevents))
    for ev in (events, jevents):
        monkeypatch.setattr(ev, "_rings", _declared_rings(ev))
    for m in (pm, jm):
        m.GATE_REQUESTS.inc(klass="control", outcome="admitted")
        m.FEEDER_WAIT_SECONDS.observe(0.25)
    with monkeypatch.context() as mp:
        mp.setattr(time, "time", lambda: 1.8e9)
        for ev in (events, jevents):
            ev.JOB_EVENTS.emit("queued", job="indexer")
    got = federation.local_snapshot(_FakeNode)
    want = jfed.local_snapshot(_FakeNode)
    for doc in (got, want):
        doc.pop("ts")
    assert got["node"] == want["node"] == {"id": str(_FakeConfig.id), "name": "fake-node",
                                           "libraries": {}}
    assert _strip(got["health"]) == _strip(want["health"])
    shared = set(got["metrics"]) & set(want["metrics"])
    assert {k: got["metrics"][k] for k in shared} == {k: want["metrics"][k] for k in shared}
    assert got["rings"] == want["rings"]
    assert got["tenants"] == want["tenants"] == {}
    assert got["profile"] == want["profile"]
    assert federation.snapshot_compatible(got) and not federation.snapshot_compatible({"v": 2})
    assert federation.mesh_status(_FakeNode)["mesh"] == {"peers": {}}


def test_overflowing_ring_reports_drops_in_digests():
    """The `_ring_digests` half of test_telemetry.py's
    test_overflowing_ring_reports_drops_honestly."""
    from spacedrive_tpu_torch.telemetry.federation import _ring_digests

    ring = events.ring("overflow_probe", capacity=8)
    for i in range(20):
        ring.emit("tick", i=i)
    assert ring.dropped == 12
    assert events.drop_counts()["overflow_probe"] == 12
    assert _ring_digests()["overflow_probe"]["dropped"] == 12
    assert _ring_digests()["overflow_probe"]["len"] == 8
    ring.clear()
    assert "dropped" not in _ring_digests()["overflow_probe"]


def test_sync_watermarks_clock_head_and_journal_stats_equal_jax(tmp_path, monkeypatch):
    from spacedrive_tpu.location.indexer import journal as jjournal
    from spacedrive_tpu.sync.manager import SyncManager as JSyncManager
    from spacedrive_tpu_torch.location.indexer import journal
    from spacedrive_tpu_torch.node.library import Libraries
    from spacedrive_tpu_torch.sync.manager import SyncManager

    libs = Libraries(str(tmp_path / "data"))
    lib = libs.create("h", "", node_pub_id=uuid.uuid4().bytes, node_name="n")
    try:
        # a remote instance's ops, as ingest would have applied them
        remote = uuid.UUID(int=99)
        rid = lib.db.insert("instance", pub_id=remote.bytes, identity=b"x", node_id=b"y",
                            node_name="peer", node_platform=0, last_seen="", date_created="")
        for i, ts in enumerate((1 << 40, 3 << 40)):
            lib.db.execute(
                "INSERT INTO crdt_operation (timestamp, model, record_id, kind, data, "
                "instance_id) VALUES (?, 'tag', ?, 'c', x'80', ?)", (ts, bytes([i]), rid))
        monkeypatch.setattr(time, "time", lambda: 1.9e9)
        port = SyncManager(lib.db, lib.sync.instance)
        ref = JSyncManager(lib.db, lib.sync.instance)
        assert port.timestamps == ref.timestamps and remote in port.timestamps
        assert port.replication_watermarks() == ref.replication_watermarks()
        assert port.observe_replication_lag() == ref.observe_replication_lag()
        assert pm.SYNC_LAG.value(peer=telemetry.peers.peer_label(remote)) == \
            jm.SYNC_LAG.value(peer=telemetry.peers.peer_label(remote)) > 0
        monkeypatch.undo()
        for _ in range(3):
            port.clock.new_timestamp()
            ref.clock.new_timestamp()
        assert port.clock.peek_last() > 0 and ref.clock.peek_last() > 0
        ref.clock._last = port.clock.peek_last()
        assert port.clock.peek_last().as_unix() == ref.clock.peek_last().as_unix()
        # the journal's stats: the same lookups through both journals
        loc = lib.db.insert("location", pub_id=uuid.uuid4().bytes, name="l", path=str(tmp_path))
        lib.db.execute(
            "INSERT INTO index_journal (location_id, materialized_path, name, extension, "
            "payload, stale) VALUES (?, '/', 'a', 'txt', x'00', 1)", (loc,))
        pj, jj = journal.IndexJournal(lib.db), jjournal.IndexJournal(lib.db)
        for key in (("/", "b", "txt"), ("/", "c", "txt"), ("/", "d", "bin")):
            assert pj.lookup(loc, key, None)[0] == jj.lookup(loc, key, None)[0]
        pj.bytes_saved(1024, location_id=loc)
        jj.bytes_saved(1024, location_id=loc)
        assert pj.location_stats() == jj.location_stats()
        stats = pj.location_stats()[loc]
        assert stats["entries"] == 1 and stats["bytes_saved"] == 1024 and stats["misses"] == 3
        telemetry.reset()  # drops the runtime counters and the stats cache
        assert journal.IndexJournal(lib.db).location_stats()[loc] == \
            {"entries": 1, "stale_entries": 1}
    finally:
        lib.close()


# --- procedures and the CLI ----------------------------------------------------


def test_procedures_after_a_scan_beside_jax(tmp_path):
    from test_torch_api import _scanned_node, make_corpus

    corpus = make_corpus(str(tmp_path / "corpus"))

    async def run(pkg):
        node, lib, _loc = await _scanned_node(pkg, str(tmp_path / pkg), corpus)
        try:
            r = node.router
            return {k: await r.exec(node, f"telemetry.{k}")
                    for k in ("health", "slo", "tenants", "serve", "mesh")}, str(lib.id)
        finally:
            await node.shutdown()

    (got, lid), (want, jlid) = asyncio.run(run("port")), asyncio.run(run("jax"))
    assert list(got["health"]["subsystems"]) == list(want["health"]["subsystems"])
    for sub in ("device", "p2p", "sync", "resilience", "serve", "tenants"):
        assert got["health"]["subsystems"][sub]["status"] == \
            want["health"]["subsystems"][sub]["status"], sub
    assert [(s["name"], s["kind"], s["objective"]) for s in got["slo"]["slos"]] == \
        [(s["name"], s["kind"], s["objective"]) for s in want["slo"]["slos"]]
    assert got["tenants"] == want["tenants"] == {"enabled": True, "k": 8, "surfaces": {}}
    assert got["serve"] == want["serve"] == {"enabled": False}
    g, w = got["mesh"], want["mesh"]
    assert g["mesh"] == w["mesh"] == {"peers": {}}
    assert set(g["local"]) == set(w["local"])
    assert set(g["local"]["node"]["libraries"]) == {lid}
    assert set(g["local"]["node"]["libraries"][lid]) == \
        set(w["local"]["node"]["libraries"][jlid])
    stats = g["local"]["node"]["libraries"][lid]["index_journal"]
    assert stats == {int(k) if isinstance(k, str) else k: v for k, v in
                     w["local"]["node"]["libraries"][jlid]["index_journal"].items()}


def test_cli_tenants_and_mesh_status_in_process(tmp_path, capsys):
    """Without --url both commands boot a mesh node on the data dir (as
    JAX's do); with discovery off in its config it finds no peer."""
    from spacedrive_tpu_torch.node.config import P2PDiscoveryState
    from spacedrive_tpu_torch.node.node import Node

    data_dir = str(tmp_path / "node")
    node = Node(data_dir, device="cpu", with_labeler=False)
    node.config.config.p2p.discovery = P2PDiscoveryState.DISABLED
    node.config.save()
    assert cli.main(["tenants", "--data-dir", data_dir, "--device", "cpu", "--wait", "0"]) == 0
    assert json.loads(capsys.readouterr().out) == {
        "local": jtenants.snapshot(), "peers": {}}
    out = str(tmp_path / "mesh.json")
    assert cli.main(["mesh-status", "--data-dir", data_dir, "--device", "cpu", "--wait", "0",
                     "--out", out]) == 0
    assert "no peers" in capsys.readouterr().err
    doc = json.load(open(out))
    # the federation cache's view, as JAX's manager gives it: no peers
    assert doc["mesh"]["peers"] == {} and doc["mesh"]["stale_after_seconds"] == 60.0
    assert doc["local"]["v"] == 1
    assert doc["local"]["health"]["subsystems"]["serve"]["status"] == "unknown"
    assert cli.main(["tenants"]) == 1 and cli.main(["mesh-status"]) == 1


class _Surface(http.server.BaseHTTPRequestHandler):
    """A stand-in for a node's `GET /tenants` and `GET /mesh`."""

    def do_GET(self):  # noqa: N802 - the handler's name
        from spacedrive_tpu_torch.telemetry.federation import mesh_status

        path = self.path.partition("?")[0]
        if path == "/tenants":
            doc = tenants.snapshot()
        elif path == "/mesh":
            doc = mesh_status(None) | {"query": self.path.partition("?")[2]}
        else:
            self.send_error(404)
            return
        body = json.dumps(doc).encode()
        self.send_response(200)
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_cli_tenants_and_mesh_status_over_http(capsys):
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Surface)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        tenants.observe("serve", uuid.UUID(int=5))
        assert cli.main(["tenants", "--url", url]) == 0
        assert json.loads(capsys.readouterr().out) == tenants.snapshot()
        assert cli.main(["mesh-status", "--url", url, "--no-refresh"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["query"] == "refresh=0" and doc["mesh"] == {"peers": {}}
    finally:
        server.shutdown()
        server.server_close()
