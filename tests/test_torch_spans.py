"""The port's spans, metric catalog, flight recorder and debug bundle
against the JAX package's (tests/test_telemetry.py pointed at the port).

- `render()` of a fresh registry holding every family of each package's
  `telemetry/metrics.py` is the same text: 101 families;
- spans nest per asyncio task, count their bytes and record errors;
- `telemetry.reset()` clears spans, traces, rings, the sampler's data
  and the journal's counters;
- a Node scan fills the dispatch, feeder, identifier, thumbnail and
  job-phase series and the snapshot's spans (the dry-run case, in
  process: the HTTP host waits for plane 6.9);
- `redact`, `collect_secret_values` and `scrub_values` of the same
  config dict equal JAX's; a Node's debug bundle holds no identity hex
  and no secret-keyed `SD_*` value, and carries versions, libraries and
  the profile section.
"""

import asyncio
import json
import os

import numpy as np
import pytest
from PIL import Image

import spacedrive_tpu.telemetry as jtelemetry
from spacedrive_tpu.telemetry import bundle as jbundle
from spacedrive_tpu.telemetry import metrics as jmetrics
from spacedrive_tpu.telemetry import registry as jregistry
from spacedrive_tpu_torch import telemetry
from spacedrive_tpu_torch.telemetry import bundle, events, metrics, registry, trace

SECRET_ENV = "sk-telemetry-plane-planted-secret-0123456789"


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()
    jtelemetry.reset()
    yield
    telemetry.reset()
    jtelemetry.reset()


def _families(metrics_mod, registry_mod):
    """Each family the metrics module declares, in declaration order."""
    return [v for v in vars(metrics_mod).values()
            if isinstance(v, (registry_mod.Counter, registry_mod.Gauge, registry_mod.Histogram))]


def _fresh_render(metrics_mod, registry_mod):
    reg = registry_mod.MetricsRegistry()
    for fam in _families(metrics_mod, registry_mod):
        make = getattr(reg, fam.kind)
        kw = {"buckets": fam.buckets} if fam.kind == "histogram" else {}
        make(fam.name, fam.help, labels=fam.label_names, **kw)
    return reg.render()


def test_fresh_registry_renders_as_jax_over_every_family():
    port, ref = _families(metrics, registry), _families(jmetrics, jregistry)
    assert len(ref) == 101
    assert [f.name for f in port] == [f.name for f in ref]
    assert _fresh_render(metrics, registry) == _fresh_render(jmetrics, jregistry)


def test_every_family_registers_on_the_process_registry():
    names = {f.name for f in _families(metrics, registry)}
    assert names <= set(metrics.REGISTRY.snapshot())
    for fam in _families(metrics, registry):
        assert metrics.REGISTRY.get(fam.name) is fam


def test_span_nesting_under_asyncio():
    async def run():
        async def pipeline(tag):
            async with telemetry.span(tag):
                await asyncio.sleep(0.01)
                with telemetry.span("inner", nbytes=7) as sp:
                    assert telemetry.current_span() is sp
                    assert sp.path == f"{tag}.inner"

        await asyncio.gather(pipeline("a"), pipeline("b"))

    asyncio.run(run())
    stages = {s["stage"] for s in telemetry.recent_spans()}
    assert {"a", "b", "a.inner", "b.inner"} <= stages
    assert metrics.SPAN_BYTES.value(stage="a.inner") == 7
    assert metrics.SPAN_SECONDS.stats(stage="b")["count"] == 1


def test_span_records_duration_and_error():
    with pytest.raises(RuntimeError):
        with telemetry.span("boom"):
            raise RuntimeError("x")
    rec = telemetry.recent_spans()[-1]
    assert rec["stage"] == "boom" and rec["error"] == "RuntimeError"
    assert rec["seconds"] >= 0


def test_telemetry_reset_clears_spans_trace_rings_sampler_and_journal(tmp_path):
    """The journal's verdicts and bytes saved live in the registry, so
    the reset zeroes them with every other series."""
    from spacedrive_tpu_torch.db.database import LibraryDb
    from spacedrive_tpu_torch.location.indexer import journal

    with telemetry.span("reset_probe"):
        pass
    events.ring("reset_probe_ring").emit("tick")
    db = LibraryDb(os.path.join(tmp_path, "lib.db"))
    j = journal.IndexJournal(db)
    j.lookup(1, ("/", "a", "txt"), None)
    j.bytes_saved(100)
    assert telemetry.counter_value("sd_index_journal_ops_total", result="miss") == 1
    assert telemetry.counter_value("sd_index_journal_bytes_saved_total") == 100
    assert telemetry.recent_spans() and trace.recent()
    telemetry.reset()
    assert telemetry.recent_spans() == [] and trace.recent() == []
    assert events.ring("reset_probe_ring").snapshot() == []
    assert telemetry.counter_value("sd_index_journal_ops_total", result="miss") == 0
    assert telemetry.counter_value("sd_index_journal_bytes_saved_total") == 0
    assert telemetry.sampler.SAMPLER.profile().get("samples", 0) == 0
    db.close()


def test_overflowing_ring_reports_drops_in_the_bundle():
    ring = events.ring("overflow_probe", capacity=8)
    for i in range(20):
        ring.emit("tick", i=i)
    assert ring.dropped == 12
    assert telemetry.counter_value("sd_ring_dropped_total", ring="overflow_probe") == 12
    assert bundle.build_bundle()["ring_drops"]["overflow_probe"] == 12


def test_histogram_recent_and_snapshot_shape():
    metrics.SEARCH_QUERY_SECONDS.observe(0.25)
    assert telemetry.histogram_recent("sd_search_query_seconds") == [0.25]
    assert telemetry.histogram_recent("sd_no_such_family") == []
    snap = telemetry.snapshot()
    assert set(snap) == {"metrics", "spans"}
    assert snap["metrics"]["sd_search_query_seconds"]["series"][0]["count"] == 1


# --- a Node scan fills the series (the dry-run case, in process) ------------


def _corpus(root):
    os.makedirs(root)
    with open(os.path.join(root, "alpha.txt"), "wb") as f:
        f.write(b"a" * 5000)
    with open(os.path.join(root, "beta.bin"), "wb") as f:
        f.write(np.random.default_rng(0).integers(0, 256, 200_000, np.uint8).tobytes())
    Image.new("RGB", (64, 48), (40, 200, 40)).save(os.path.join(root, "real.png"))
    return root


def test_node_scan_populates_dispatch_feeder_identifier_and_phase_metrics(tmp_path):
    from spacedrive_tpu_torch.location.locations import LocationCreateArgs, scan_location
    from spacedrive_tpu_torch.node.node import Node

    corpus = _corpus(os.path.join(tmp_path, "corpus"))

    async def run():
        node = Node(os.path.join(tmp_path, "node"), device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            lib = await node.create_library("telemetry-lib")
            loc = LocationCreateArgs(path=corpus, name="corpus").create(lib)
            await scan_location(lib, loc, node.jobs, backend="cpu")
            await node.jobs.wait_idle()
            await node.thumbnailer.wait_library_batch(str(lib.id))
            text = (await node.router.exec(node, "telemetry.render"))["text"]
            snap = await node.router.exec(node, "telemetry.snapshot")
            evs = await node.router.exec(node, "telemetry.events")
        finally:
            await node.shutdown()
        return text, snap, evs

    text, snap, evs = asyncio.run(run())
    for series in ("sd_feeder_h2d_bytes_total", "sd_task_batch_occupancy_count",
                   "sd_job_phase_seconds_bucket", "sd_identifier_files_total",
                   "sd_thumbnailer_files_total", "sd_udp_retransmits_total"):
        assert series in text, series
    m = snap["metrics"]
    assert m["sd_feeder_h2d_bytes_total"]["series"][0]["value"] > 0
    assert sum(s["count"] for s in m["sd_task_batch_occupancy"]["series"]) > 0
    phases = m["sd_job_phase_seconds"]["series"]
    assert {s["labels"]["job"] for s in phases} >= {"indexer", "file_identifier"}
    assert m["sd_identifier_files_total"]["series"][0]["value"] == 3
    stages = {s["stage"] for s in snap["spans"]}
    assert {"walk", "identify.hash", "identify.db", "thumbnail.decode"} <= stages
    assert [e["type"] for e in evs["jobs"]].count("settled") == 3


# --- the debug bundle -----------------------------------------------------------


CONFIG = {
    "id": "1234", "name": "node", "identity": "ab" * 32,
    "p2p": {"port": 7373, "discovery": "everyone"},
    "preferences": {"cloud_api_token": "tok-" + "9" * 20, "theme": "dark",
                    "nested": [{"password": "hunter2hunter2"}, {"ok": 1}]},
    "features": ["x"], "private_key": "short",
}


def test_redaction_and_scrub_equal_jax():
    assert bundle.redact(CONFIG) == jbundle.redact(CONFIG)
    secrets = bundle.collect_secret_values(CONFIG)
    assert secrets == jbundle.collect_secret_values(CONFIG)
    assert secrets == {"ab" * 32, "tok-" + "9" * 20, "hunter2hunter2"}
    leaky = {"msg": f"failed with {'ab' * 32} and tok-{'9' * 20}", "list": ["hunter2hunter2x"]}
    assert bundle.scrub_values(leaky, secrets) == jbundle.scrub_values(leaky, secrets)
    assert "[redacted]" in bundle.scrub_values(leaky, secrets)["msg"]


def test_node_debug_bundle_is_secret_free(tmp_path, monkeypatch):
    from spacedrive_tpu_torch.node.node import Node

    monkeypatch.setenv("SD_CLOUD_TOKEN", SECRET_ENV)

    async def run():
        node = Node(os.path.join(tmp_path, "node"), device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            await node.create_library("bundle-lib")
            identity_hex = node.config.config.identity.to_bytes().hex()
            # a secret travels through an exception into the error ring
            try:
                raise RuntimeError(f"boom {identity_hex}")
            except RuntimeError as e:
                events.record_error("test", e)
            doc = await node.router.exec(node, "telemetry.debug_bundle")
        finally:
            await node.shutdown()
        return doc, identity_hex

    doc, identity_hex = asyncio.run(run())
    text = json.dumps(doc, default=str)
    assert identity_hex not in text and SECRET_ENV not in text
    assert doc["node_config"]["identity"] == "[redacted]"
    assert doc["env"]["SD_CLOUD_TOKEN"] == "[redacted]"
    assert "torch" in doc["versions"] and "jax" not in doc["versions"]
    assert "torch.version.cuda" in doc["versions"]
    assert doc["libraries"][0]["name"] == "bundle-lib"
    assert set(doc["profile"]) == {"doc", "folded"}
    assert doc["tenants"] == {"enabled": True, "k": 8, "surfaces": {}}
    assert set(doc) == set(jbundle.build_bundle()) | {"libraries"}


def test_offline_bundle_reads_node_json(tmp_path):
    from spacedrive_tpu_torch.node.config import ConfigManager

    data_dir = os.path.join(tmp_path, "d")
    os.makedirs(data_dir)
    cfg = ConfigManager(data_dir).config
    text = bundle.render_bundle(data_dir=data_dir)
    assert cfg.identity.to_bytes().hex() not in text
    assert json.loads(text)["node_config"]["identity"] == "[redacted]"
