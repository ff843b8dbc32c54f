"""The port's telemetry against the JAX package's: the metrics registry
renders the same Prometheus text and snapshot after the same operations
(cardinality overflow and cross-process deltas included), the port's
metric families carry the JAX names, help, labels and buckets, and the
flight-recorder rings keep and drop the same events; `peer_label` gives
the label JAX's gives for every form of peer id."""

import uuid

import pytest

from spacedrive_tpu.telemetry import events as jevents
from spacedrive_tpu.telemetry import peers as jpeers
from spacedrive_tpu.telemetry import metrics as jmetrics
from spacedrive_tpu.telemetry import registry as jregistry
from spacedrive_tpu_torch.telemetry import events, metrics, peers, registry


def _drive(reg_mod):
    """The same operations on a fresh registry of one package."""
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("sd_test_total", "a counter", labels=("kind",))
    g = reg.gauge("sd_test_level", "a gauge")
    h = reg.histogram("sd_test_seconds", "a histogram", labels=("op",),
                      buckets=(0.1, 1.0, 10.0), recent_samples=4)
    u = reg.counter("sd_test_plain_total")
    for i in range(70):  # past MAX_SERIES_PER_FAMILY: folds into __overflow__
        c.inc(i % 3 + 0.5, kind=f"k{i}")
    g.set(2.0)
    g.dec(0.25)
    for v in (0.05, 0.1, 0.5, 3.0, 12.0, 7.5):
        h.observe(v, op="blake3")
    h.observe(1.0, op='we"ird\\name\n')
    u.inc()
    before = reg.delta_capture()
    c.inc(2, kind="k1")
    h.observe(0.2, op="blake3")
    delta = reg_mod.MetricsRegistry.delta_diff(before, reg.delta_capture())
    other = reg_mod.MetricsRegistry()
    other.counter("sd_test_total", "a counter", labels=("kind",))
    other.histogram("sd_test_seconds", "a histogram", labels=("op",),
                    buckets=(0.1, 1.0, 10.0), recent_samples=4)
    other.merge_delta(delta)
    errors = []
    for bad in (lambda: c.inc(-1, kind="x"), lambda: c.inc(kind="x", extra="y"),
                lambda: reg.gauge("sd_test_total")):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    return {
        "render": reg.render(), "snapshot": reg.snapshot(), "delta": delta,
        "merged": other.render(), "value": c.value(kind="k1"), "missing": c.value(kind="nope"),
        "stats": h.stats(op="blake3"), "recent": h.recent(op="blake3"), "errors": errors,
        "after_reset": (reg.reset(), reg.render())[1],
    }


def test_registry_renders_as_jax_after_the_same_operations():
    got, want = _drive(registry), _drive(jregistry)
    for key in want:
        assert got[key] == want[key], key
    assert "__overflow__" in got["render"]


@pytest.mark.parametrize("name", sorted(metrics.REGISTRY.snapshot()))
def test_port_families_equal_the_jax_families(name):
    port, ref = metrics.REGISTRY.get(name), jmetrics.REGISTRY.get(name)
    assert ref is not None, f"{name} is not a JAX family"
    assert (port.kind, port.help, port.label_names) == (ref.kind, ref.help, ref.label_names)
    assert getattr(port, "buckets", None) == getattr(ref, "buckets", None)


def _ring_run(ev_mod):
    ring = ev_mod.EventRing("test-ring", capacity=3)
    for i in range(5):
        ring.emit("step", i=i, name=f"s{i}")
    kept = [(e["type"], e["fields"]) for e in ring.snapshot()]
    dropped = ring.dropped
    size = len(ring)
    ring.clear()
    return kept, dropped, size, len(ring), ring.dropped


def test_ring_keeps_the_newest_and_counts_drops_as_jax():
    before = metrics.RING_DROPPED.value(ring="test-ring")
    assert _ring_run(events) == _ring_run(jevents)
    assert metrics.RING_DROPPED.value(ring="test-ring") == before + 2


def test_named_rings_and_drop_counts():
    assert events.ring("resilience") is events.RESILIENCE_EVENTS
    assert events.ring("faults") is events.FAULT_EVENTS
    r = events.ring("test-drops", capacity=1)
    r.emit("a")
    r.emit("b")
    assert events.drop_counts()["test-drops"] == 1
    assert events.all_events()["test-drops"] == r.snapshot()
    assert [e["type"] for e in r.snapshot()] == ["b"]
    r.clear()
    assert "test-drops" not in events.drop_counts()


def test_record_error_lands_on_the_error_ring():
    events.ERROR_EVENTS.clear()
    try:
        raise RuntimeError("device lost")
    except RuntimeError as exc:
        events.record_error("cas.ladder", exc)
    (e,) = events.ERROR_EVENTS.snapshot()
    assert e["type"] == "exception"
    assert e["fields"]["source"] == "cas.ladder"
    assert e["fields"]["exc_type"] == "RuntimeError"
    assert e["fields"]["message"] == "device lost"
    assert "RuntimeError: device lost" in e["fields"]["traceback"]


#: the families the host execution plane (feeder, pool, controller, loop lag) writes or reads
PLANE_FAMILIES = (
    "sd_feeder_h2d_bytes_total", "sd_feeder_fetch_seconds", "sd_feeder_wait_seconds",
    "sd_feeder_inflight_depth", "sd_feeder_prefetch_total",
    "sd_procpool_workers", "sd_procpool_jobs_total", "sd_procpool_dispatch_seconds",
    "sd_procpool_roundtrip_seconds", "sd_procpool_batch_rows", "sd_procpool_restarts_total",
    "sd_autotune_decisions_total", "sd_autotune_window_scale", "sd_autotune_batch_rung",
    "sd_autotune_depth_extra", "sd_autotune_pool_scale", "sd_event_loop_lag_seconds",
)


def _plane_render(reg_mod, metrics_mod):
    """Each package's plane families copied onto a fresh registry of its
    own, driven by the same operations, rendered."""
    reg = reg_mod.MetricsRegistry()
    fams = {}
    for name in PLANE_FAMILIES:
        src = metrics_mod.REGISTRY.get(name)
        make = getattr(reg, src.kind)
        kw = {"buckets": src.buckets} if src.kind == "histogram" else {}
        fams[name] = make(name, src.help, labels=src.label_names, **kw)
    for name, fam in fams.items():
        labels = {n: v for n, v in zip(fam.label_names, ("identify", "promote"))}
        if fam.kind == "counter":
            fam.inc(3, **labels)
        elif fam.kind == "gauge":
            fam.set(2.5, **labels)
        else:
            for v in (0.001, 0.04, 3.0, 48.0, 700.0):
                fam.observe(v, **labels)
    fams["sd_feeder_prefetch_total"].inc(result="miss")
    fams["sd_procpool_jobs_total"].inc(2, result="retried")
    return reg.render()


def test_plane_families_render_as_jax():
    for name in PLANE_FAMILIES:
        assert metrics.REGISTRY.get(name) is not None, name
    got, want = _plane_render(registry, metrics), _plane_render(jregistry, jmetrics)
    assert got == want
    assert "sd_procpool_batch_rows_bucket" in got


def test_snapshot_point_reads():
    import importlib

    # both packages' telemetry/__init__ export a function of this name
    snapshot = importlib.import_module("spacedrive_tpu_torch.telemetry.snapshot")
    jsnapshot = importlib.import_module("spacedrive_tpu.telemetry.snapshot")

    for mod in (snapshot, jsnapshot):
        assert mod.gauge_value("sd_no_such_family", default=1.5) == 1.5
    metrics.PROCPOOL_WORKERS.set(3)
    assert snapshot.gauge_value("sd_procpool_workers") == 3.0
    metrics.PROCPOOL_WORKERS.set(0)
    before = snapshot.counter_value("sd_procpool_restarts_total")
    metrics.PROCPOOL_RESTARTS.inc()
    assert snapshot.counter_value("sd_procpool_restarts_total") == before + 1


async def test_loop_lag_monitor_sets_the_gauge(monkeypatch):
    """A loop blocked for 0.3 s shows as lag past the 0.2 s warning: the
    gauge takes every sample, that one included, and the loop ring
    records it, as JAX's monitor does."""
    import asyncio
    import time

    seen = []
    real_set = metrics.EVENT_LOOP_LAG.set
    monkeypatch.setattr(metrics.EVENT_LOOP_LAG, "set",
                        lambda v, **kw: (seen.append(v), real_set(v, **kw)))
    events.LOOP_EVENTS.clear()
    monitor = events.LoopLagMonitor(interval=0.02, warn_s=0.2)
    monitor.start()
    monitor.start()  # idempotent while running
    try:
        await asyncio.sleep(0.05)
        time.sleep(0.3)  # block the loop
        await asyncio.sleep(0.05)
        deadline = time.monotonic() + 5
        while not events.LOOP_EVENTS.snapshot() and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
    finally:
        await monitor.stop()
    (ev,) = [e for e in events.LOOP_EVENTS.snapshot() if e["fields"]["seconds"] >= 0.25]
    assert ev["type"] == "lag"
    assert max(seen) >= 0.25 and ev["fields"]["seconds"] == round(max(seen), 4)
    assert metrics.EVENT_LOOP_LAG.value() == seen[-1]
    assert events.ring("autotune") is events.AUTOTUNE_EVENTS
    assert events.ring("loop") is events.LOOP_EVENTS


@pytest.mark.parametrize("peer", [
    uuid.UUID(int=7), b"\x01\x02\x03", bytearray(b"node-key"), "ed25519:abc", 12345,
])
def test_peer_label_equals_jax(peer):
    assert peers.peer_label(peer) == jpeers.peer_label(peer)
    assert len(peers.peer_label(peer)) == peers.PEER_LABEL_HEX_CHARS
