"""The port's critical-path attribution against the JAX package's
(tests/test_attrib.py pointed at the port, but for the cross-node
assembly cases, which wait for the mesh identify and the p2p plane).

- `bucket_of` over every span name either package emits (read from both
  packages' sources) and the bucket tables: equal;
- `report` over seeded span forests, with malformed, zero-length,
  orphaned and cyclic records: equal documents; pass markers and
  `last_pass_trace` over the same marker scripts: equal; `assemble` on
  a node without p2p: the JAX document (no remote spans, never partial);
- the JAX gate cases on the port: the vocabulary, the exact partition,
  an uncovered stall blamed on the link, malformed and cyclic records,
  pass markers, reset, the report cache holding only settled passes,
  and the 6.2a case that waited for this plane: the gap bucket
  decomposed into named frame groups;
- a port `Node(device="cpu")` identify pass against a JAX
  `Node(use_device=False)` pass over one seeded corpus: the same bucket
  vocabulary, buckets covering >= 0.9 of each pass's wall time, and an
  injected `feeder.fetch` stall blamed on `link` in both;
- the job manager's pass markers on a router scan, `telemetry.attrib`
  against JAX's procedure, and the CLI's `attrib` against a node
  surface.

Exact comparisons but for the scans, whose seconds are compared by
bucket vocabulary and the stated bars (0.9 coverage, link >= 0.3 s).
"""

import asyncio
import http.server
import json
import os
import re
import threading
import time

import numpy as np
import pytest

import spacedrive_tpu.telemetry as jtelemetry
from spacedrive_tpu.telemetry import attrib as jattrib
from spacedrive_tpu.telemetry import trace as jtrace
from spacedrive_tpu_torch import cli, telemetry
from spacedrive_tpu_torch.telemetry import attrib, sampler
from spacedrive_tpu_torch.telemetry import trace as sdtrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    monkeypatch.setenv("SD_SERVE_GATE", "0")
    telemetry.reset()
    jtelemetry.reset()
    yield
    telemetry.reset()
    jtelemetry.reset()


def _span(stage, t0, dur, span_id, parent=None, trace_id="t", **extra):
    return {"stage": stage, "t0": t0, "seconds": dur, "span_id": span_id,
            "parent_id": parent, "trace_id": trace_id, **extra}


def _emitted_stages():
    """Every literal span stage in either package's sources."""
    names = set()
    pat = re.compile(r'(?:span\(\s*|"stage":\s*)"([a-z_.]+)"')
    for pkg in ("spacedrive_tpu", "spacedrive_tpu_torch"):
        for dirpath, _, files in os.walk(os.path.join(ROOT, pkg)):
            for f in files:
                if f.endswith(".py"):
                    with open(os.path.join(dirpath, f), encoding="utf-8") as fh:
                        names |= set(pat.findall(fh.read()))
    return sorted(names | {"thumbnail.device"})


def test_bucket_tables_and_every_emitted_stage_equal_jax():
    assert attrib.BUCKETS == jattrib.BUCKETS
    assert attrib._PRIORITY == jattrib._PRIORITY
    assert attrib._HEAD_BUCKETS == jattrib._HEAD_BUCKETS
    assert attrib._SEGMENT_BUCKETS == jattrib._SEGMENT_BUCKETS
    stages = _emitted_stages()
    assert {"walk", "identify.hash", "identify.db", "task.dispatch", "feeder.fetch",
            "feeder.wait", "thumbnail.decode", "thumbnail.device", "thumbnail.encode",
            "procpool.thumb_cpu"} <= set(stages)
    for stage in stages + ["", "x", "job.something_new", "a.b.hash", "feeder", "p2p.x.db"]:
        assert attrib.bucket_of(stage) == jattrib.bucket_of(stage), stage


def _forest(seed, n=60):
    """A seeded span forest over the emitted stages, with malformed,
    zero-length, orphaned and cyclic records."""
    rng = np.random.default_rng(seed)
    stages = _emitted_stages() + ["job.other", "orchestrate"]
    spans = []
    for i in range(n):
        parent = f"s{int(rng.integers(0, max(1, i)))}" if i and rng.random() < 0.6 else None
        spans.append(_span(str(rng.choice(stages)), float(np.round(rng.uniform(0, 20), 6)),
                           float(np.round(rng.exponential(1.0), 6)) if rng.random() > 0.05
                           else 0.0, f"s{i}", parent=parent))
    spans.append({"stage": "walk"})                              # no timing
    spans.append({"stage": "walk", "t0": "bad", "seconds": 1.0})  # malformed
    spans.append(_span("identify.db", 3.0, -2.0, "neg"))         # negative duration
    spans.append(_span("walk", 1.0, 1.0, "c1", parent="c2"))     # a cycle
    spans.append(_span("identify.db", 1.5, 1.0, "c2", parent="c1"))
    spans.append(_span("feeder.wait", 2.0, 1.0, "o1", parent="nobody"))
    return spans


@pytest.mark.parametrize("seed", range(8))
def test_report_over_seeded_forests_equals_jax(seed):
    spans = _forest(seed)
    got, want = attrib.report("t", spans), jattrib.report("t", spans)
    assert got == want
    assert abs(sum(got["buckets"].values()) - got["wall_seconds"]) < 1e-4
    assert telemetry.gauge_value("sd_attrib_bucket_seconds", bucket="link") == \
        jtelemetry.gauge_value("sd_attrib_bucket_seconds", bucket="link")


@pytest.mark.parametrize("seed", range(3))
def test_pass_markers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(90):
        job = str(rng.choice(["indexer", "file_identifier", "media_processor"]))
        tid = f"trace-{int(rng.integers(0, 6))}"
        event = str(rng.choice(["started", "settled"]))
        fields = {"status": "COMPLETED"} if event == "settled" else {}
        for mod in (attrib, jattrib):
            mod.mark_pass(job, tid, event, **fields)
        assert attrib.last_pass_trace() == jattrib.last_pass_trace()
        assert attrib._pass_settled(tid) == jattrib._pass_settled(tid)

    def strip(passes):
        return [{k: v for k, v in p.items() if k != "ts"} for p in passes]

    assert strip(attrib.recent_passes()) == strip(jattrib.recent_passes())
    assert len(attrib.recent_passes()) == attrib._PASS_RING


def test_assemble_without_p2p_equals_jax():
    class Bare:
        p2p = None

    spans = [_span("walk", 10.0, 1.0, "a", trace_id="t-as"),
             _span("identify.hash", 11.0, 0.5, "b", parent="a", trace_id="t-as"),
             _span("feeder.wait", 11.5, 2.0, "c", parent="a", trace_id="t-as")]
    for rec in spans:
        sdtrace.record_span(rec)
        jtrace.record_span(rec)
    for mod in (attrib, jattrib):
        mod.mark_pass("file_identifier", "t-as", "started")
        mod.mark_pass("file_identifier", "t-as", "settled", status="COMPLETED")

    async def both():
        return (await attrib.assemble(Bare, None, refresh=True),
                await jattrib.assemble(Bare, None, refresh=True))

    got, want = asyncio.run(both())
    for doc in (got, want):
        for p in doc["passes"]:
            p.pop("ts")
    assert got == want
    assert got["remote_spans"] == 0 and got["partial"] is False and "pull_failures" not in got
    assert asyncio.run(attrib.assemble(Bare)) is attrib.cached_report("t-as")
    telemetry.reset()
    assert asyncio.run(attrib.assemble(Bare))["error"].startswith("no completed pass")


# --- the JAX gate cases on the port ------------------------------------------


def test_bucket_vocabulary():
    assert attrib.bucket_of("identify.hash") == attrib.DEVICE
    assert attrib.bucket_of("mesh.shard_hash") == attrib.DEVICE
    assert attrib.bucket_of("thumbnail.device") == attrib.DEVICE
    assert attrib.bucket_of("identify.db") == attrib.HOST_CPU
    assert attrib.bucket_of("walk") == attrib.HOST_CPU
    assert attrib.bucket_of("thumbnail.decode") == attrib.HOST_CPU
    assert attrib.bucket_of("sync.ingest") == attrib.HOST_CPU
    assert attrib.bucket_of("feeder.fetch") == attrib.LINK
    assert attrib.bucket_of("feeder.wait") == attrib.LINK
    assert attrib.bucket_of("p2p.sync_serve") == attrib.LINK
    assert attrib.bucket_of("relay.push") == attrib.LINK
    assert attrib.bucket_of("task.dispatch") == attrib.QUEUE_WAIT
    assert attrib.bucket_of("job.something_new") == attrib.GAP


def test_report_partitions_window_exactly():
    spans = [
        _span("task.dispatch", 0.0, 1.0, "a"),
        _span("walk", 1.0, 2.0, "b", parent="a"),
        _span("identify.hash", 3.0, 3.0, "c", parent="a"),
        _span("feeder.fetch", 2.5, 3.0, "d", parent="a"),
        _span("identify.db", 7.0, 1.0, "e", parent="a"),
    ]
    doc = attrib.report("t", spans)
    b = doc["buckets"]
    assert abs(doc["wall_seconds"] - 8.0) < 1e-6
    assert abs(sum(b.values()) - doc["wall_seconds"]) < 1e-4
    assert abs(b["queue_wait"] - 1.0) < 1e-6
    assert abs(b["host_cpu"] - 3.0) < 1e-6
    assert abs(b["device"] - 3.0) < 1e-6
    assert abs(b["link"] - 0.0) < 1e-6
    assert abs(b["gap"] - 1.0) < 1e-6
    assert doc["bucket_fractions"]["device"] == pytest.approx(3 / 8, abs=1e-3)


def test_report_blames_uncovered_stall_as_link_when_waiting():
    spans = [_span("identify.hash", 0.0, 0.5, "a"), _span("feeder.wait", 0.5, 4.0, "w"),
             _span("identify.hash", 4.5, 0.5, "b")]
    doc = attrib.report("t", spans)
    assert doc["buckets"]["link"] == pytest.approx(4.0, abs=1e-6)
    assert doc["buckets"]["device"] == pytest.approx(1.0, abs=1e-6)
    top = doc["top_segments"][0]
    assert top["stage"] == "feeder.wait" and top["bucket"] == "link"


def test_report_handles_malformed_and_cyclic_records():
    spans = [{"stage": "walk"}, _span("walk", 0.0, 1.0, "a", parent="b"),
             _span("identify.db", 0.5, 1.0, "b", parent="a")]
    doc = attrib.report("t", spans)
    assert doc["spans"] == 2
    assert abs(sum(doc["buckets"].values()) - doc["wall_seconds"]) < 1e-4


def test_pass_markers_resolve_last_pass():
    attrib.mark_pass("indexer", "trace-1", "started")
    attrib.mark_pass("indexer", "trace-1", "settled", status="COMPLETED")
    attrib.mark_pass("file_identifier", "trace-2", "started")
    assert attrib.last_pass_trace() == "trace-1"
    attrib.mark_pass("file_identifier", "trace-2", "settled", status="COMPLETED")
    assert attrib.last_pass_trace() == "trace-2"
    telemetry.reset()
    assert attrib.last_pass_trace() is None


def test_reset_clears_report_cache():
    attrib._cache_store("t", attrib.report("t", [_span("walk", 0.0, 1.0, "a")]))
    assert attrib.cached_report("t") is not None
    telemetry.reset()
    assert attrib.cached_report("t") is None


def test_assemble_caches_only_settled_complete_reports():
    class Bare:
        p2p = None

    async def run():
        attrib.mark_pass("file_identifier", "t-live", "started")
        sdtrace.record_span(_span("walk", 0.0, 1.0, "a", trace_id="t-live"))
        doc = await attrib.assemble(Bare, "t-live")
        assert doc["spans"] == 1
        assert attrib.cached_report("t-live") is None
        attrib.mark_pass("file_identifier", "t-live", "settled", status="COMPLETED")
        await attrib.assemble(Bare, "t-live")
        assert attrib.cached_report("t-live") is not None
        attrib.mark_pass("media_processor", "t-live", "started")
        assert attrib._pass_settled("t-live") is False

    asyncio.run(run())


def test_gap_bucket_decomposes_into_named_groups(monkeypatch):
    """A real uninstrumented Python burn between two spans yields a gap
    bucket >= 70% decomposed into named frame groups (the 6.2a case)."""
    monkeypatch.setattr(sampler, "HZ", 150.0)
    s = sampler.SAMPLER
    s.start()
    try:
        s.reset()
        t0 = time.time()
        time.sleep(0.05)
        burn_start = time.time()
        x = 0
        while time.time() - burn_start < 0.6:
            for i in range(20000):
                x += i * i
        t_end = time.time()
        spans = [_span("walk", t0, burn_start - t0, "a", trace_id="tgap"),
                 _span("identify.db", t_end, 0.02, "b", trace_id="tgap")]
        time.sleep(0.02)
        doc = attrib.report("tgap", spans)
        assert doc["buckets"]["gap"] >= 0.5, doc["buckets"]
        gd = doc.get("gap_decomposition")
        assert gd is not None and gd["samples"] > 10, doc
        assert gd["coverage"] >= 0.7, gd
        assert gd["groups"]
        assert abs(sum(gd["groups"].values()) - doc["buckets"]["gap"]) < 1e-3
    finally:
        s.stop()


# --- a port Node's identify pass against a JAX Node's ------------------------


def build_corpus(root, n=60, seed=7):
    """Small files from the seed, an empty one and a >100 KiB
    sampled-message file, so the pass crosses the cas size classes."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        with open(os.path.join(root, f"f{i:04d}.bin"), "wb") as f:
            f.write(i.to_bytes(4, "little") + rng.bytes(int(rng.integers(1, 4096))))
    open(os.path.join(root, "empty.bin"), "wb").close()
    with open(os.path.join(root, "large.bin"), "wb") as f:
        f.write(rng.bytes(150 * 1024))


async def _identify_pass(pkg, data_dir, corpus):
    """JAX's `_identify_pass`: index, then identify under ONE fresh trace;
    returns the report of that trace and the identify pass's wall."""
    if pkg == "jax":
        from spacedrive_tpu.jobs.manager import JobBuilder
        from spacedrive_tpu.location.indexer.job import IndexerJob
        from spacedrive_tpu.location.locations import LocationCreateArgs
        from spacedrive_tpu.node import Node
        from spacedrive_tpu.object.file_identifier.job import FileIdentifierJob

        node = Node(data_dir, use_device=False, with_labeler=False)
        node.config.config.p2p.enabled = False
        mod, tr, backend = jattrib, jtrace, "cpu"
    else:
        from spacedrive_tpu_torch.jobs.manager import JobBuilder
        from spacedrive_tpu_torch.location.indexer.job import IndexerJob
        from spacedrive_tpu_torch.location.locations import LocationCreateArgs
        from spacedrive_tpu_torch.node.node import Node
        from spacedrive_tpu_torch.object.file_identifier.job import FileIdentifierJob

        node = Node(data_dir, device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        mod, tr, backend = attrib, sdtrace, "cpu"
    await node.start()
    try:
        lib = await node.create_library("attrib")
        loc = LocationCreateArgs(path=corpus).create(lib)
        await JobBuilder(IndexerJob({"location_id": loc["id"]})).spawn(node.jobs, lib)
        await node.jobs.wait_idle()
        ctx = tr.new_context()
        t0 = time.perf_counter()
        with tr.use(ctx):
            await JobBuilder(FileIdentifierJob(
                {"location_id": loc["id"], "backend": backend})).spawn(node.jobs, lib)
        await node.jobs.wait_idle()
        wall = time.perf_counter() - t0
        return mod.report(ctx.trace_id), wall
    finally:
        await node.shutdown()


@pytest.mark.parametrize("stall", [False, True], ids=["clean", "stalled"])
def test_identify_pass_attribution_beside_jax(stall, tmp_path):
    from spacedrive_tpu.utils import faults as jfaults
    from spacedrive_tpu_torch.utils import faults

    corpus = str(tmp_path / "corpus")
    build_corpus(corpus)
    plan = "feeder.fetch:stall:delay_s=0.4"
    docs = {}
    for pkg, fmod in (("port", faults), ("jax", jfaults)):
        if stall:
            with fmod.active(fmod.FaultPlan.parse(plan)):
                docs[pkg] = asyncio.run(_identify_pass(pkg, str(tmp_path / pkg), corpus))
        else:
            docs[pkg] = asyncio.run(_identify_pass(pkg, str(tmp_path / pkg), corpus))
    for pkg, (doc, wall) in docs.items():
        assert doc["spans"] > 0, pkg
        total = sum(doc["buckets"].values())
        assert total == pytest.approx(doc["wall_seconds"], abs=1e-4)
        assert total >= 0.9 * wall, (pkg, doc, wall)
        assert all(v >= 0 for v in doc["buckets"].values())
        if stall:
            b = doc["buckets"]
            assert b["link"] >= 0.3 and b["link"] > b["device"] and b["link"] > b["host_cpu"], \
                (pkg, b)
    assert list(docs["port"][0]["buckets"]) == list(docs["jax"][0]["buckets"])
    stages = {pkg: {attrib.bucket_of(s) for s in doc["top_stages"] if s != "(gap)"}
              for pkg, (doc, _) in docs.items()}
    assert stages["port"] == stages["jax"]


# --- markers, procedures and the CLI -------------------------------------------


def test_router_scan_marks_passes_and_attrib_matches_jax(tmp_path):
    """A router scan marks each job's pass under its one trace, in the
    JAX job manager's order, and `telemetry.attrib` (no trace id: the
    last settled pass) answers the JAX procedure's keys."""
    from test_torch_api import _scanned_node, make_corpus

    corpus = make_corpus(str(tmp_path / "corpus"))

    async def run(pkg):
        node, _lib, _loc = await _scanned_node(pkg, str(tmp_path / pkg), corpus)
        try:
            await asyncio.sleep(0)
            return await node.router.exec(node, "telemetry.attrib")
        finally:
            await node.shutdown()

    got, want = asyncio.run(run("port")), asyncio.run(run("jax"))
    for doc in (got, want):
        assert "error" not in doc and doc["spans"] > 0
        assert [(p["job"], p["event"]) for p in doc["passes"]] == [
            ("indexer", "started"), ("indexer", "settled"),
            ("file_identifier", "started"), ("file_identifier", "settled"),
            ("media_processor", "started"), ("media_processor", "settled")]
        assert abs(sum(doc["buckets"].values()) - doc["wall_seconds"]) < 1e-4
    # the decompositions appear where the host sampler's samples landed
    assert {k for k in got if not k.endswith("_decomposition")} == \
        {k for k in want if not k.endswith("_decomposition")}
    assert got["partial"] is want["partial"] is False
    assert got["remote_spans"] == want["remote_spans"] == 0


class _Surface(http.server.BaseHTTPRequestHandler):
    """A stand-in for a node's `GET /attrib`: the port's own report."""

    def do_GET(self):  # noqa: N802 - the handler's name
        from urllib.parse import parse_qs, urlparse

        url = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        if url.path != "/attrib":
            self.send_error(404)
            return
        doc = asyncio.run(attrib.assemble(None, q.get("trace_id"), refresh="refresh" in q))
        body = json.dumps(doc).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # quiet
        pass


def test_cli_attrib_over_http(tmp_path, capsys):
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Surface)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert cli.main(["attrib", "--url", url]) == 1  # no pass yet
        assert "no completed pass" in capsys.readouterr().err
        sdtrace.record_span(_span("walk", 5.0, 1.0, "a", trace_id="t-cli"))
        sdtrace.record_span(_span("feeder.wait", 6.0, 2.0, "b", trace_id="t-cli"))
        attrib.mark_pass("file_identifier", "t-cli", "settled", status="COMPLETED")
        out = str(tmp_path / "attrib.json")
        assert cli.main(["attrib", "--url", url, "--refresh", "--out", out]) == 0
        doc = json.load(open(out))
        assert doc["trace_id"] == "t-cli" and doc["buckets"]["link"] == 2.0
        assert "critical path" in capsys.readouterr().err
        assert cli.main(["attrib", "t-cli", "--url", url]) == 0
        assert json.loads(capsys.readouterr().out)["wall_seconds"] == 3.0
    finally:
        server.shutdown()
        server.server_close()
    assert cli.main(["attrib", "--url", url]) == 1  # nothing listens there now
