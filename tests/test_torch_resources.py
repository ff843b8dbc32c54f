"""The port's resource sampler against the JAX package's
(tests/test_resources.py pointed at the port).

- `sample_once` publishes the same value keys and inventory kinds as
  JAX's, and `node_providers` runs JAX's SQL: over one library DB the
  two packages' providers read equal journal, op-log and history-byte
  counts;
- the JAX gate cases on the port: real /proc figures on the gauges,
  provider registration (unknown kinds refused, a raising provider
  degrading to 0), one refcounted thread, `telemetry.reset()` releasing
  planted leaks, a planted fd leak breaching the trend SLO and turning
  `resources` unhealthy with exactly one capture window, a flat series
  staying healthy, `SD_RESOURCES=0` as a true no-op;
- a port Node on the CPU: the sampler runs while it lives, its gauges
  read above 0, and after `shutdown()` no sampler or history thread is
  left: every thread alive is one that was alive before the Node.

Exact comparisons (tolerance 0) but for /proc figures, which move
between two reads and are compared by key.
"""

import asyncio
import os
import threading
import time
import uuid

import pytest

import spacedrive_tpu.telemetry as jtelemetry
from spacedrive_tpu.telemetry import resources as jresources
from spacedrive_tpu_torch import telemetry
from spacedrive_tpu_torch.telemetry import health, history, resources, slo
from spacedrive_tpu_torch.telemetry import sampler as profiler


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()
    jtelemetry.reset()
    yield
    telemetry.reset()
    jtelemetry.reset()


def _writer(tmp_path, **kw) -> history.HistoryWriter:
    return history.HistoryWriter(os.path.join(tmp_path, "hist"), **kw)


def test_vocabulary_and_sample_keys_equal_jax():
    assert resources.INVENTORY_KINDS == jresources.INVENTORY_KINDS
    assert resources.DEFAULT_INTERVAL_S == jresources.DEFAULT_INTERVAL_S
    got = resources.SAMPLER.sample_once()
    want = jresources.SAMPLER.sample_once()
    assert list(got) == list(want)
    # the same process, read twice: the counts that do not move agree
    assert got["fds"] > 0 and want["fds"] > 0
    assert got["procpool_rss_bytes"] == want["procpool_rss_bytes"] == 0.0


@pytest.mark.parametrize("knob,want", [(None, 5.0), ("0.01", 0.05), ("7", 7.0),
                                       ("99999", 3600.0), ("x", 5.0)])
def test_interval_knob_equals_jax(knob, want, monkeypatch):
    if knob is None:
        monkeypatch.delenv("SD_RESOURCE_INTERVAL_S", raising=False)
    else:
        monkeypatch.setenv("SD_RESOURCE_INTERVAL_S", knob)
    assert resources.interval_s() == jresources.interval_s() == want


def test_node_providers_run_jax_sql_on_one_library(tmp_path):
    """The providers of both packages over one port library DB (op log,
    journal rows) and one history directory read the same numbers."""
    from spacedrive_tpu_torch.node.library import Libraries

    libs = Libraries(str(tmp_path / "data"))
    lib = libs.create("res", "", node_pub_id=uuid.uuid4().bytes, node_name="n")
    try:
        ops = [lib.sync.shared_create("tag", uuid.uuid4().bytes, [("name", f"t{i}")])
               for i in range(5)]
        lib.sync.write_ops([op for group in ops for op in group])
        loc = lib.db.insert("location", pub_id=uuid.uuid4().bytes, name="l", path=str(tmp_path))
        lib.db.execute(
            "INSERT INTO index_journal (location_id, materialized_path, name, extension, "
            "payload) VALUES (?, '/', 'a', 'txt', x'00')", (loc,))
        w = _writer(tmp_path, samplers={"x": lambda: 1.0})
        for i in range(3):
            w.sample(now=1000.0 + i)

        class FakeNode:
            libraries = libs
            history = w

        got = {k: fn() for k, fn in resources.node_providers(FakeNode).items()}
        want = {k: fn() for k, fn in jresources.node_providers(FakeNode).items()}
        assert got == want
        assert got["oplog_rows"] >= 5 and got["history_bytes"] > 0
        assert got["journal_rows"] == 1.0
    finally:
        lib.close()


# --- the JAX gate cases on the port ------------------------------------------


def test_sample_once_reads_real_process_figures():
    vals = resources.SAMPLER.sample_once()
    assert vals["rss_bytes"] > 0
    assert vals["fds"] > 0
    assert vals["threads"] >= 1
    for kind in resources.INVENTORY_KINDS:
        assert kind in vals
    assert telemetry.gauge_value("sd_resource_rss_bytes") == vals["rss_bytes"]
    assert telemetry.gauge_value("sd_resource_fds") == vals["fds"]
    assert resources.SAMPLER.last() == vals
    assert resources.SAMPLER.sample_count() >= 1


def test_provider_registration_feeds_inventory_and_rejects_unknown():
    resources.SAMPLER.register_provider("journal_rows", lambda: 1234.0)
    try:
        vals = resources.SAMPLER.sample_once()
        assert vals["journal_rows"] == 1234.0
        assert telemetry.gauge_value("sd_resource_inventory", kind="journal_rows") == 1234.0
    finally:
        resources.SAMPLER.unregister_provider("journal_rows")
    with pytest.raises(ValueError):
        resources.SAMPLER.register_provider("not_a_kind", lambda: 0.0)
    resources.SAMPLER.register_provider(
        "oplog_rows", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    try:
        vals = resources.SAMPLER.sample_once()
        assert vals["rss_bytes"] > 0 and vals["oplog_rows"] == 0.0
    finally:
        resources.SAMPLER.unregister_provider("oplog_rows")


def test_refcounted_start_stop_spawns_one_thread():
    before = {t.name for t in threading.enumerate()}
    assert "sd-resources" not in before
    assert resources.SAMPLER.start() is True
    assert resources.SAMPLER.start() is True
    try:
        names = [t.name for t in threading.enumerate()]
        assert names.count("sd-resources") == 1
        resources.SAMPLER.stop()
        assert resources.SAMPLER.running()
    finally:
        resources.SAMPLER.stop()
    assert not resources.SAMPLER.running()
    assert "sd-resources" not in {t.name for t in threading.enumerate()}


def test_reset_releases_planted_leaks_and_clears_state():
    baseline = resources.fd_count()
    resources.SAMPLER.leak_for_test(fds=8, mb=1)
    assert resources.fd_count() >= baseline + 8
    resources.SAMPLER.sample_once()
    assert resources.SAMPLER.last()
    telemetry.reset()
    assert resources.fd_count() <= baseline + 1
    assert resources.SAMPLER.last() == {}
    assert resources.SAMPLER.last_ts() is None
    assert resources.SAMPLER.sample_count() == 0


def _plant_fd_leak(tmp_path, slope_per_h: float = 300.0):
    """A history whose resource_fds series climbs at `slope_per_h`: 16
    samples over 15 min, past the 2 min warmup."""
    w = _writer(tmp_path, samplers=None)
    now = time.time()
    per_sample = slope_per_h / 60.0
    for i in range(16):
        fds = 100.0 + per_sample * i
        w._samplers = {"resource_fds": (lambda v=fds: v), "resource_rss_mb": (lambda: 200.0)}
        w.sample(now=now - 900 + i * 60)
    return w


def test_planted_leak_breaches_trend_slo(tmp_path):
    w = _plant_fd_leak(tmp_path)
    docs = {s["name"]: s for s in slo.evaluate(w)["slos"]}
    assert docs["fd_growth"]["status"] == slo.BREACH
    trend = docs["fd_growth"]["windows"]["trend"]
    assert trend["slope_per_h"] > 50.0
    assert trend["warmup_excluded"] >= 1
    assert docs["rss_growth"]["status"] == slo.OK


def test_planted_leak_flips_health_and_captures_once(tmp_path, monkeypatch):
    monkeypatch.setattr(profiler, "CAPTURE_S", 0.2)
    monkeypatch.setattr(profiler, "COOLDOWN_S", 3600.0)
    w = _plant_fd_leak(tmp_path)

    class FakeNode:
        history = w

    profiler.SAMPLER.start()
    try:
        profiler.SAMPLER.reset()
        resources.SAMPLER.sample_once()
        for _ in range(3):
            health._slo(FakeNode)
        verdict = health._resources()
        assert verdict["status"] == health.UNHEALTHY
        assert "fd_growth" in verdict["reason"]
        full = health.evaluate(FakeNode)
        assert full["subsystems"]["resources"]["status"] == health.UNHEALTHY
        assert full["status"] == health.UNHEALTHY
        assert telemetry.counter_value("sd_profile_captures_total") == 1
        caps = profiler.SAMPLER.captures_snapshot()
        assert len(caps) == 1 and caps[0]["reason"] == "slo_breach"
    finally:
        profiler.SAMPLER.stop()


def test_flat_series_stays_healthy(tmp_path):
    w = _writer(tmp_path, samplers={"resource_fds": (lambda: 100.0),
                                    "resource_rss_mb": (lambda: 200.0)})
    now = time.time()
    for i in range(16):
        w.sample(now=now - 900 + i * 60)

    class FakeNode:
        history = w

    resources.SAMPLER.sample_once()
    health._slo(FakeNode)
    verdict = health._resources()
    assert verdict["status"] == health.HEALTHY
    assert verdict["signals"]["trends"]["fd_growth"]["status"] == slo.OK


def test_sd_resources_zero_is_a_true_noop(monkeypatch):
    monkeypatch.setenv("SD_RESOURCES", "0")
    assert not resources.enabled()
    assert resources.SAMPLER.start() is False
    assert not resources.SAMPLER.running()
    assert "sd-resources" not in {t.name for t in threading.enumerate()}
    assert {s.name for s in slo.default_slos()}.isdisjoint({"rss_growth", "fd_growth"})
    assert not any(n.startswith("resource_") for n in history.default_samplers())
    assert health._resources()["status"] == health.UNKNOWN
    assert resources.SAMPLER.summary() == {"enabled": False}


# --- a port Node on the CPU ----------------------------------------------------


def test_node_samples_resources_and_leaves_no_thread(tmp_path, monkeypatch):
    from spacedrive_tpu_torch.node.node import Node

    monkeypatch.setenv("SD_RESOURCE_INTERVAL_S", "0.05")
    monkeypatch.setenv("SD_HISTORY_INTERVAL_S", "0.05")
    before = set(threading.enumerate())

    async def run():
        node = Node(str(tmp_path / "data"), device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            assert node._resources_started and resources.SAMPLER.running()
            await asyncio.sleep(0.4)
            gauges = {g: telemetry.gauge_value(g) for g in (
                "sd_resource_rss_bytes", "sd_resource_fds", "sd_resource_threads")}
            samples = resources.SAMPLER.sample_count()
            tail = len(node.history.tail)
        finally:
            await node.shutdown()
        return gauges, samples, tail

    gauges, samples, tail = asyncio.run(run())
    assert all(v > 0 for v in gauges.values()), gauges
    assert samples >= 2 and tail >= 2
    names = {t.name for t in threading.enumerate()}
    assert not resources.SAMPLER.running() and "sd-resources" not in names
    assert "sd-profiler" not in names
    # every thread alive now was alive before the Node: the count is back
    # (a thread of an earlier test that ends meanwhile cannot fail this)
    assert set(threading.enumerate()) <= before
