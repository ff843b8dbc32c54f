"""The port's tenant plane against the JAX package's (tests/test_tenants.py
pointed at the port).

- the same seeded `observe` / `observe_bytes` scripts (zipf-shaped
  tenants over every surface, with and without latencies, at K = 2, 4
  and 8) give equal sketches, snapshots, digests, `fairness_index` and
  `dominant_share` per surface, and the same `sd_tenant_*` series in
  the Prometheus text; `tenant_label` agrees across id spellings and
  packages;
- the JAX gate cases on the port: eviction inherits the floor, Jain's
  index and the dominant share, latency buckets, folding non-residents
  to `other`, `telemetry.reset()`, `SD_TENANT_OBS=0` gating every
  derived surface (SLO, history, federation, health), the `tenants`
  health verdict, and no raw UUID on any read surface (the debug
  bundle's `tenants` key included). The two-node mesh case waits for
  the p2p plane.

Exact comparisons throughout (tolerance 0).
"""

import json
import uuid

import numpy as np
import pytest

import spacedrive_tpu.telemetry as jtelemetry
from spacedrive_tpu.telemetry import tenants as jtenants
from spacedrive_tpu_torch import telemetry
from spacedrive_tpu_torch.telemetry import counter_value, gauge_value
from spacedrive_tpu_torch.telemetry import tenants as tenants_mod
from spacedrive_tpu_torch.telemetry.tenants import OTHER, SpaceSavingSketch, tenant_label


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()
    jtelemetry.reset()
    yield
    telemetry.reset()
    jtelemetry.reset()


def _script(seed, n=400):
    """Zipf-shaped tenants (uuids from the seed) over every surface."""
    rng = np.random.default_rng(seed)
    ids = [uuid.UUID(bytes=rng.bytes(16)) for _ in range(24)]
    ranks = np.minimum(rng.zipf(1.4, n), len(ids)) - 1
    surfaces = rng.choice(tenants_mod.SURFACES, n)
    out = []
    for i in range(n):
        tenant = ids[ranks[i]]
        spelling = int(rng.integers(3))
        tid = tenant if spelling == 0 else (str(tenant) if spelling == 1 else tenant.hex)
        surface = str(surfaces[i])
        if surface.startswith("bytes_"):
            out.append(("bytes", tid, int(rng.integers(1, 1 << 16)), surface == "bytes_out"))
        else:
            secs = None if rng.random() < 0.3 else float(rng.choice([0.002, 0.03, 0.4, 3.0, 20.0]))
            out.append(("observe", surface, tid, float(rng.integers(1, 4)), secs))
    return out


def _play(mod, script):
    for ev in script:
        if ev[0] == "bytes":
            mod.observe_bytes(ev[1], ev[2], outbound=ev[3])
        else:
            mod.observe(ev[1], ev[2], ev[3], seconds=ev[4])
    return {
        "snapshot": mod.snapshot(),
        "digest": mod.digest(),
        "fairness": {s: mod.fairness_index(s) for s in mod.SURFACES},
        "dominant": {s: mod.dominant_share(s) for s in mod.SURFACES},
    }


def _tenant_lines(text):
    return sorted(x for x in text.splitlines() if x.startswith("sd_tenant"))


@pytest.mark.parametrize("topk", ["2", "4", "8"])
@pytest.mark.parametrize("seed", range(4))
def test_seeded_observe_scripts_equal_jax(seed, topk, monkeypatch):
    monkeypatch.setenv("SD_TENANT_TOPK", topk)
    script = _script(seed)
    got = _play(tenants_mod, script)
    want = _play(jtenants, script)
    assert got == want
    assert got["snapshot"]["k"] == int(topk) and got["snapshot"]["surfaces"]
    assert _tenant_lines(telemetry.render()) == _tenant_lines(jtelemetry.render())


@pytest.mark.parametrize("seed", range(4))
def test_sketch_level_scripts_equal_jax(seed):
    rng = np.random.default_rng(seed)
    port, ref = SpaceSavingSketch(3), jtenants.SpaceSavingSketch(3)
    for _ in range(300):
        label = f"t{int(min(rng.zipf(1.3), 12)):02d}"
        n = float(rng.integers(1, 5))
        secs = None if rng.random() < 0.5 else float(rng.exponential(0.5))
        assert port.observe(label, n, secs) == ref.observe(label, n, secs)
        assert (port.counts, port.errs, port.other, port.total, port.evictions) == \
            (ref.counts, ref.errs, ref.other, ref.total, ref.evictions)
    assert port.residents() == ref.residents()
    assert port.fairness_index() == ref.fairness_index()
    assert port.dominant_share() == ref.dominant_share()


def test_tenant_label_equals_jax_across_spellings():
    rng = np.random.default_rng(7)
    for _ in range(16):
        lib = uuid.UUID(bytes=rng.bytes(16))
        for spelling in (lib, str(lib), str(lib).upper(), lib.hex, f"urn:uuid:{lib}"):
            assert tenant_label(spelling) == jtenants.tenant_label(spelling) == tenant_label(lib)
    assert tenant_label("not-a-uuid") == jtenants.tenant_label("not-a-uuid")


# --- the JAX gate cases on the port ------------------------------------------


def test_sketch_eviction_inherits_floor_and_accounts_other():
    sk = SpaceSavingSketch(k=2)
    sk.observe("aa", 5, None)
    sk.observe("bb", 3, None)
    assert sk.errs == {"aa": 0.0, "bb": 0.0}
    sk.observe("cc", 1, None)
    assert set(sk.counts) == {"aa", "cc"}
    assert sk.counts["cc"] == 4.0 and sk.errs["cc"] == 3.0
    assert sk.other == 3.0
    assert sk.total == 9.0
    assert sk.evictions == 1
    rows = sk.residents()
    assert [r["tenant"] for r in rows] == ["aa", "cc"]
    assert rows[0]["err"] == 0.0
    assert sk.counts["cc"] - sk.errs["cc"] <= 1 <= sk.counts["cc"]


def test_sketch_fairness_index_and_dominant_share():
    sk = SpaceSavingSketch(k=4)
    assert sk.fairness_index() == 1.0
    sk.observe("aa", 10, None)
    assert sk.fairness_index() == 1.0
    sk.observe("bb", 10, None)
    assert sk.fairness_index() == pytest.approx(1.0)
    sk.observe("aa", 980, None)
    assert sk.fairness_index() < 0.6
    assert sk.dominant_share() == pytest.approx(990 / 1000)


def test_sketch_latency_buckets_ride_residents():
    sk = SpaceSavingSketch(k=4)
    for _ in range(90):
        sk.observe("aa", 1, 0.002)
    for _ in range(10):
        sk.observe("aa", 1, 8.0)
    row = sk.residents()[0]
    assert row["p50_s"] <= 0.05
    assert row["p99_s"] >= 1.0


def test_observe_folds_nonresidents_to_other(monkeypatch):
    monkeypatch.setenv("SD_TENANT_TOPK", "2")
    t1, t2, t3 = uuid.uuid4(), uuid.uuid4(), uuid.uuid4()
    for _ in range(5):
        tenants_mod.observe("serve", t1, seconds=0.01)
        tenants_mod.observe("serve", t2, seconds=0.01)
    tenants_mod.observe("serve", t3, seconds=0.01)
    assert counter_value("sd_tenant_ops_total", surface="serve", tenant=tenant_label(t1)) == 5.0
    assert counter_value("sd_tenant_ops_total", surface="serve", tenant=OTHER) == 1.0
    assert gauge_value("sd_tenant_sketch_residents", surface="serve") == 2.0


def test_reset_clears_tenant_state():
    tenants_mod.observe("serve", uuid.uuid4(), seconds=0.01)
    tenants_mod.observe_bytes(uuid.uuid4(), 4096, outbound=True)
    snap = tenants_mod.snapshot()
    assert set(snap["surfaces"]) == {"serve", "bytes_out"}
    assert tenants_mod.digest()["serve"]["total"] == 1.0
    telemetry.reset()
    assert tenants_mod.snapshot()["surfaces"] == {}
    assert tenants_mod.digest() == {}
    assert tenants_mod.fairness_index() == 1.0
    assert tenants_mod.dominant_share() == 0.0


def test_disabled_plane_gates_every_derived_surface(monkeypatch):
    from spacedrive_tpu_torch.telemetry import health, history
    from spacedrive_tpu_torch.telemetry.federation import local_snapshot
    from spacedrive_tpu_torch.telemetry.slo import default_slos

    monkeypatch.setenv("SD_TENANT_OBS", "0")
    assert tenants_mod.enabled() is False
    tenants_mod.observe("serve", uuid.uuid4(), seconds=0.01)
    tenants_mod.observe_bytes(uuid.uuid4(), 1024, outbound=False)
    snap = tenants_mod.snapshot()
    assert snap["enabled"] is False and snap["surfaces"] == {}
    assert tenants_mod.fairness_index() == 1.0
    assert tenants_mod.dominant_share() == 0.0
    assert all(s.name != "tenant_fairness" for s in default_slos())
    assert "tenant_fairness_index" not in history.default_samplers()
    assert "tenants" not in local_snapshot()
    v = health.evaluate()
    assert v["subsystems"]["tenants"]["status"] == health.UNKNOWN
    assert v["status"] == health.HEALTHY
    monkeypatch.delenv("SD_TENANT_OBS")
    assert any(s.name == "tenant_fairness" for s in default_slos())
    assert "tenant_fairness_index" in history.default_samplers()
    assert "tenants" in local_snapshot()


def test_health_tenants_unknown_then_degraded_on_dominance():
    from spacedrive_tpu.telemetry import health as jhealth
    from spacedrive_tpu_torch.telemetry import health

    v = health.evaluate()
    assert v["subsystems"]["tenants"]["status"] == health.UNKNOWN
    assert v["status"] == health.HEALTHY
    hog, mouse = uuid.uuid4(), uuid.uuid4()
    for mod in (tenants_mod, jtenants):
        for _ in range(99):
            mod.observe("serve", hog)
        mod.observe("serve", mouse)
    ten = health.evaluate()["subsystems"]["tenants"]
    assert ten["status"] == health.DEGRADED
    assert "dominant" in ten["reason"]
    assert ten == jhealth.evaluate()["subsystems"]["tenants"]


def test_planted_uuid_never_raw_on_any_read_surface():
    from spacedrive_tpu_torch.telemetry.bundle import build_bundle
    from spacedrive_tpu_torch.telemetry.registry import REGISTRY

    planted = uuid.uuid4()
    tenants_mod.observe("serve", planted, seconds=0.01)
    tenants_mod.observe("ingest", planted)
    tenants_mod.observe_bytes(planted, 65536, outbound=True)
    label = tenant_label(planted)
    metrics_text = REGISTRY.render()
    snapshot_doc = json.dumps(tenants_mod.snapshot())
    digest_doc = json.dumps(tenants_mod.digest())
    bundle = build_bundle()
    bundle_doc = json.dumps(bundle)
    for doc in (metrics_text, snapshot_doc, digest_doc, bundle_doc):
        assert str(planted) not in doc
        assert planted.hex not in doc
    assert label in metrics_text
    assert label in snapshot_doc
    assert label in bundle_doc
    # the bundle's tenants key is the plane's snapshot, as in JAX's bundle
    assert bundle["tenants"] == tenants_mod.snapshot()
