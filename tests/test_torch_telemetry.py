"""The port's telemetry against the JAX package's: the metrics registry
renders the same Prometheus text and snapshot after the same operations
(cardinality overflow and cross-process deltas included), the port's
metric families carry the JAX names, help, labels and buckets, and the
flight-recorder rings keep and drop the same events."""

import pytest

from spacedrive_tpu.telemetry import events as jevents
from spacedrive_tpu.telemetry import metrics as jmetrics
from spacedrive_tpu.telemetry import registry as jregistry
from spacedrive_tpu_torch.telemetry import events, metrics, registry


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
