"""The port's host sampling profiler against the JAX package's
(tests/test_profile.py pointed at the port).

- frame naming, folding and the frame → group classifier: the same
  synthetic stacks name and classify as JAX's once the package name is
  mapped (this package's frames are named relative to it, and `torch`
  takes the place of `jax`/`jaxlib` in `device_dispatch`); the group
  vocabulary is JAX's;
- the sampler accumulates, folds and summarises; `SD_PROFILE=0` is a
  true no-op; triggers open one window per cooldown, re-arm after it
  and refuse unknown reasons; a loop-lag degradation opens one window;
  `reset` clears the data but keeps the thread;
- a port Node scan on the CPU: with the sampler on and off the cas_ids,
  DB rows and webp bytes are equal, and `SD_PROFILE=0` spawns no
  sampler; at the default rate the sampler's self-measured overhead is
  under 5%; a triggered capture rides `trace_export`'s host-profile
  lane; `telemetry.profile` answers through the router;
- the CLI's `trace-export` and `profile` against a node's HTTP surface
  (a local stand-in serving the port's own documents), `debug-bundle`
  offline and `licenses`.

The SLO-breach trigger and the history's profile shares are held in
tests/test_torch_slo_history.py, attribution's gap decomposition in
tests/test_torch_attrib.py. Cases left for later entries: the bench
comparator and `bench_e2e`'s attribution summary (queue 1 entry 4's
`bench_e2e.py` legs), the mesh pull (6.7b), the live HTTP host (6.9).
"""

import asyncio
import http.server
import json
import os
import threading
import time

import numpy as np
import pytest
from PIL import Image

import spacedrive_tpu.telemetry as jtelemetry
from spacedrive_tpu.telemetry import sampler as jsampler
from spacedrive_tpu_torch import cli, telemetry
from spacedrive_tpu_torch.telemetry import sampler


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()
    jtelemetry.reset()
    yield
    telemetry.reset()
    jtelemetry.reset()


# --- naming, folding, classification -----------------------------------------


def test_group_vocabulary_and_table_equal_jax_but_for_torch():
    assert sampler.GROUP_NAMES == jsampler.GROUP_NAMES
    assert sampler.HISTORY_GROUPS == jsampler.HISTORY_GROUPS
    assert sampler.STATES == jsampler.STATES
    assert sampler.TRIGGER_REASONS == jsampler.TRIGGER_REASONS
    port, ref = dict(sampler.FRAME_GROUPS), dict(jsampler.FRAME_GROUPS)
    assert port.pop("device_dispatch") == ("ops.", "torch", "numpy")
    assert ref.pop("device_dispatch") == ("ops.", "jax", "jaxlib", "numpy")
    # the port's own HTTP layer stands where JAX names aiohttp
    assert port.pop("serve") == ("serve.", "api.", "utils.http")
    assert ref.pop("serve") == ("serve.", "api.", "aiohttp")
    assert port == ref


PATHS = [
    "{pkg}/telemetry/sampler.py", "{pkg}/location/indexer/journal.py",
    "{pkg}/ops/cas.py", "{pkg}/object/media/thumbnail/actor.py", "{pkg}/__init__.py",
    "/usr/lib/python3.12/json/encoder.py", "/usr/lib/python3.12/threading.py",
    "/x/site-packages/msgpack/__init__.py", "/x/site-packages/numpy/core/numeric.py",
    "/tmp/whatever/thing.py",
]


@pytest.mark.parametrize("template", PATHS)
def test_module_names_equal_jax_once_the_package_is_mapped(template):
    port = sampler._module_of(template.format(pkg="/home/u/repo/spacedrive_tpu_torch"))
    ref = jsampler._module_of(template.format(pkg="/home/u/repo/spacedrive_tpu"))
    assert port == ref
    assert "/" not in port


STACKS = [
    ["asyncio.base_events:_run_once", "jobs.manager:ingest",
     "location.indexer.journal:consult_many", "sqlite3:execute"],
    ["asyncio.base_events:_run_once", "jobs.manager:ingest", "location.indexer.journal:lookup"],
    ["selectors:select"],
    ["randommod:fn"],
    ["threading:_bootstrap", "threading:_bootstrap_inner", "threading:run", "randommod:fn"],
    ["object.file_identifier.job:execute_step", "ops.cas:cas_ids_begin", "jax:device_put"],
    ["object.media.thumbnail.process:resize_decoded", "jaxlib:compile"],
    ["models.labeler:forward", "modules.conv:forward"],
    ["parallel.feeder:_run", "object.file_identifier.job:_fetch_window", "io:read"],
    ["tasks.system:_execute", "sync.manager:write_ops", "msgpack:packb"],
    ["node.node:start"],
    ["asyncio.base_events:_run_once", "cloud.relay:_push", "aiohttp.web_protocol:_handle_request",
     "streams:readuntil"],
]


def _to_port(names):
    return [n.replace("jaxlib:", "torch:").replace("jax:", "torch:")
            .replace("aiohttp.web_protocol:", "utils.http:") for n in names]


@pytest.mark.parametrize("names", STACKS, ids=lambda s: s[-1])
def test_stacks_classify_as_jax(names):
    assert sampler.classify_stack(_to_port(names)) == jsampler.classify_stack(names)


def test_wait_leaf_heuristics_and_real_frames_fold_as_jax():
    for names in (["threading:_wait_for_tstate_lock"], ["selectors:select"],
                  ["socket:recv_into"], ["location.indexer.journal:record"],
                  ["futures.thread:_worker"]):
        assert sampler._leaf_is_waity(names) == jsampler._leaf_is_waity(names)
    import sys

    frame = sys._getframe()
    assert sampler.fold_stack(frame) == jsampler.fold_stack(frame)
    assert sampler.fold_stack(frame)[-1].endswith(":test_wait_leaf_heuristics_and_real_frames_fold_as_jax")


def test_sampler_accumulates_and_folds(monkeypatch):
    monkeypatch.setattr(sampler, "HZ", 150.0)
    s = sampler.Sampler()
    assert s.start()
    stop = threading.Event()

    def burn():
        x = 0
        while not stop.is_set():
            for i in range(5000):
                x += i * i

    t = threading.Thread(target=burn, name="asyncio_burn", daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 5.0
        while s.profile()["samples"] < 20 and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        stop.set()
        t.join()
        s.stop()
    doc = s.profile()
    assert doc["enabled"] and doc["samples"] >= 20
    assert doc["threads"].get("worker", 0) > 0
    assert sum(doc["states"].values()) == doc["samples"]
    for line in s.folded().strip().splitlines():
        stack, _, count = line.rpartition(" ")
        parts = stack.split(";")
        assert int(count) >= 1 and parts[0] in ("loop", "feeder", "worker", "other")
        assert parts[1] in sampler.STATES and len(parts) >= 3
    assert "telemetry.sampler:_tick" not in s.folded()
    assert s.summary()["samples"] == doc["samples"]


def test_profile_disabled_is_true_noop(monkeypatch):
    monkeypatch.setenv("SD_PROFILE", "0")
    s = sampler.Sampler()
    assert s.start() is False
    assert not s.running()
    assert s.trigger("manual") is False
    assert s.profile() == {"enabled": False}
    assert s.summary() == {"enabled": False}
    s.stop()


# --- trigger hysteresis ----------------------------------------------------------


def test_trigger_opens_exactly_one_window_under_flapping(monkeypatch):
    monkeypatch.setattr(sampler, "CAPTURE_S", 0.2)
    monkeypatch.setattr(sampler, "COOLDOWN_S", 3600.0)
    s = sampler.SAMPLER
    s.start()
    try:
        s.reset()
        opened = [s.trigger("loop_lag") for _ in range(10)]
        assert opened.count(True) == 1
        assert [c["reason"] for c in s.captures_snapshot()] == ["loop_lag"]
        assert s.trigger("manual") is False  # one incident, one window
        assert telemetry.counter_value("sd_profile_captures_total") == 1
    finally:
        s.stop()


def test_trigger_rearms_after_cooldown_and_refuses_unknown_reasons(monkeypatch):
    monkeypatch.setattr(sampler, "CAPTURE_S", 0.1)
    monkeypatch.setattr(sampler, "COOLDOWN_S", 0.3)
    s = sampler.SAMPLER
    s.start()
    try:
        s.reset()
        with pytest.raises(ValueError):
            s.trigger("not_a_reason")
        assert s.trigger("loop_lag") is True
        deadline = time.monotonic() + 5.0
        reopened = False
        while time.monotonic() < deadline and not reopened:
            time.sleep(0.1)
            reopened = s.trigger("loop_lag")
        assert reopened
    finally:
        s.stop()


def test_loop_lag_degradation_opens_one_window(monkeypatch):
    monkeypatch.setattr(sampler, "CAPTURE_S", 30.0)
    monkeypatch.setattr(sampler, "COOLDOWN_S", 3600.0)
    from spacedrive_tpu_torch.telemetry.events import LoopLagMonitor

    s = sampler.SAMPLER
    s.start()
    s.reset()

    async def run():
        mon = LoopLagMonitor(interval=0.01, warn_s=0.0)
        mon.start()
        await asyncio.sleep(0.4)
        await mon.stop()

    try:
        asyncio.run(run())
        caps = s.captures_snapshot()
        assert len(caps) == 1 and caps[0]["reason"] == "loop_lag", caps
    finally:
        s.stop()


def test_reset_clears_sampler_state_but_keeps_the_thread(monkeypatch):
    monkeypatch.setattr(sampler, "CAPTURE_S", 30.0)
    monkeypatch.setattr(sampler, "COOLDOWN_S", 3600.0)
    s = sampler.SAMPLER
    s.start()
    try:
        s.reset()
        deadline = time.monotonic() + 5.0
        while s.profile()["samples"] == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert s.trigger("manual") is True
        assert s.profile()["samples"] > 0 and s.captures_snapshot()
        telemetry.reset()
        assert s.profile()["samples"] == 0
        assert s.folded() == "" and s.captures_snapshot() == []
        assert s.trigger("manual") is True
        assert s.running()
    finally:
        s.stop()


def test_a_capture_rides_the_trace_export(monkeypatch):
    monkeypatch.setattr(sampler, "CAPTURE_S", 0.3)
    monkeypatch.setattr(sampler, "COOLDOWN_S", 3600.0)
    s = sampler.SAMPLER
    s.start()
    try:
        s.reset()
        with telemetry.span("probe") as sp:
            assert s.trigger("manual")
            time.sleep(0.2)
        doc = telemetry.trace_export()
        names = {e.get("name") for e in doc["traceEvents"]}
        assert "capture:manual" in names
        lane = [e for e in doc["traceEvents"] if e.get("tid") == 1 and e.get("ph") == "i"]
        assert lane and all(e["cat"] == "profile" for e in lane)
        # a filter clips the lane to the trace's spans
        only = telemetry.trace_export(sp.trace_id)["traceEvents"]
        lo = min(e["ts"] for e in only if e.get("ph") == "X")
        assert all(e["ts"] >= lo for e in only if e.get("ph") == "i")
    finally:
        s.stop()


# --- a port Node scan with the sampler on and off -------------------------------


def _corpus(root):
    os.makedirs(root)
    rng = np.random.default_rng(3)
    for i in range(12):
        with open(os.path.join(root, f"f{i}.bin"), "wb") as f:
            f.write(rng.integers(0, 256, 120_000 if i % 3 == 0 else 3000, np.uint8).tobytes())
    for i in range(4):
        px = rng.integers(0, 256, (40 + 8 * i, 56, 3), np.uint8)
        Image.fromarray(px).save(os.path.join(root, f"img{i}.png"))
    return root


UNSHARED = {"pub_id", "date_created", "date_modified", "date_indexed", "inode",
            "date_accessed", "location_id", "object_id", "key_id"}


async def _scan(data_dir, corpus):
    from spacedrive_tpu_torch.location.locations import LocationCreateArgs, scan_location
    from spacedrive_tpu_torch.node.node import Node

    node = Node(data_dir, device="cpu", with_labeler=False)
    node.config.config.p2p.enabled = False
    await node.start()
    try:
        lib = await node.create_library("profiled")
        loc = LocationCreateArgs(path=corpus).create(lib)
        await scan_location(lib, loc, node.jobs, backend="cpu")
        await node.jobs.wait_idle()
        await node.thumbnailer.wait_library_batch(str(lib.id))
        rows = sorted(
            ({k: v for k, v in r.items() if k not in UNSHARED}
             for r in lib.db.query("SELECT * FROM file_path WHERE is_dir = 0")),
            key=lambda r: r["name"])
        profile = await node.router.exec(node, "telemetry.profile")
        folded = await node.router.exec(node, "telemetry.profile", {"format": "folded"})
        started = node._profiler_started
        running = sampler.SAMPLER.running()
    finally:
        await node.shutdown()
    webps = {}
    for dirpath, _, files in os.walk(os.path.join(data_dir, "thumbnails")):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                webps[f] = fh.read()
    return rows, webps, profile, folded, started, running


def test_sd_profile_0_is_a_noop_and_a_scan_is_bit_identical(tmp_path, monkeypatch):
    corpus = _corpus(os.path.join(tmp_path, "corpus"))
    rows_on, webps_on, prof, folded, started_on, running_on = asyncio.run(
        _scan(os.path.join(tmp_path, "on"), corpus))
    assert started_on and running_on
    assert prof["enabled"] and prof["samples"] > 0
    assert isinstance(folded["folded"], str)
    monkeypatch.setenv("SD_PROFILE", "0")
    threads_before = {t.name for t in threading.enumerate()}
    rows_off, webps_off, prof_off, _, started_off, running_off = asyncio.run(
        _scan(os.path.join(tmp_path, "off"), corpus))
    assert started_off is False and running_off is False
    assert prof_off == {"enabled": False}
    assert "sd-profiler" not in threads_before
    assert rows_on == rows_off and len(rows_on) == 16
    assert all(r["cas_id"] for r in rows_on)
    assert webps_on == webps_off
    assert len([f for f in webps_on if f.endswith(".webp")]) == 4


def test_overhead_at_default_rate_under_5pct(tmp_path):
    corpus = _corpus(os.path.join(tmp_path, "corpus"))
    _, _, prof, _, _, _ = asyncio.run(_scan(os.path.join(tmp_path, "node"), corpus))
    assert prof["enabled"] and prof["hz"] == sampler.HZ
    assert prof["overhead_ratio"] < 0.05, prof["overhead_ratio"]
    assert telemetry.gauge_value("sd_profile_overhead_ratio") < 0.05


# --- the CLI ---------------------------------------------------------------------


class _NodeSurface(http.server.BaseHTTPRequestHandler):
    """A stand-in for a node's HTTP API: the port's own documents."""

    def do_GET(self):  # noqa: N802 - the handler's name
        path, _, query = self.path.partition("?")
        if path == "/trace":
            body = json.dumps(telemetry.trace_export()).encode()
        elif path == "/profile" and query == "format=folded":
            body = sampler.SAMPLER.folded().encode()
        elif path == "/profile":
            body = json.dumps(sampler.SAMPLER.profile()).encode()
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):  # noqa: N802
        body = json.dumps({"result": telemetry.debug_bundle()}, default=str).encode()
        self.send_response(200)
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture()
def surface():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _NodeSurface)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def test_cli_trace_export_profile_and_bundle_over_http(surface, tmp_path, capsys):
    sampler.SAMPLER.start()
    try:
        with telemetry.span("cli_probe"):
            time.sleep(0.15)
        out = os.path.join(tmp_path, "trace.json")
        assert cli.main(["trace-export", "--url", surface, "--out", out]) == 0
        with open(out) as f:
            doc = json.load(f)
        assert any(e["name"] == "cli_probe" for e in doc["traceEvents"])
        assert cli.main(["profile", "--url", surface]) == 0
        prof = json.loads(capsys.readouterr().out)
        assert prof["enabled"] and "frame_groups" in prof
        assert cli.main(["profile", "--url", surface, "--folded"]) == 0
        capsys.readouterr()
        assert cli.main(["debug-bundle", "--url", surface]) == 0
        bundle = json.loads(capsys.readouterr().out)
        assert {"ring_drops", "profile", "versions"} <= set(bundle)
    finally:
        sampler.SAMPLER.stop()
    # no node there: a message and exit 1, not a traceback
    assert cli.main(["trace-export", "--url", "http://127.0.0.1:9"]) == 1


def test_cli_debug_bundle_offline_and_licenses(tmp_path, capsys):
    from spacedrive_tpu_torch.node.config import ConfigManager

    data_dir = os.path.join(tmp_path, "d")
    os.makedirs(data_dir)
    identity_hex = ConfigManager(data_dir).config.identity.to_bytes().hex()
    assert cli.main(["debug-bundle", "--data-dir", data_dir]) == 0
    text = capsys.readouterr().out
    assert identity_hex not in text
    assert json.loads(text)["node_config"]["identity"] == "[redacted]"
    assert cli.main(["licenses"]) == 0
    doc = json.loads(capsys.readouterr().out)
    names = {p["name"].lower() for p in doc["python"]}
    assert {"torch", "numpy", "pillow"} <= names and "jax" not in names
    assert {n["name"] for n in doc["native"]} >= {"sqlite3", "cudart"}
