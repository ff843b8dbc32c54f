"""The port's autotune controller against the JAX package's.

- the cases of `tests/test_autotune.py`, run against the port: cold
  start, damping, the AIMD directions, the DeviceLadder rung cap, the
  ring and metrics, `SD_AUTOTUNE=0`, and sizes that never change ids;
- parity: the same scripts of hand-built `Sample`s go to JAX's
  `Controller` and to the port's, which must make the same decisions
  and hold the same knobs after every tick; the scripts cover
  starvation, an urgent wait, congestion, low and high occupancy,
  alternating signals, loop lag, the pool's three bands, and the
  one-device `DeviceLadder` event script, after which both cap the
  dispatch rung at 1 (256 rows);
- `SD_AUTOTUNE=0` gives the static sizes for every derived size, equal
  to JAX's;
- `sample()` reads the same deltas from both registries, and the
  controller's tick loop starts and stops refcounted.
"""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from spacedrive_tpu.parallel import autotune as jautotune
from spacedrive_tpu.parallel import mesh as jmesh
from spacedrive_tpu.telemetry import metrics as jtm
from spacedrive_tpu_torch.ops import blake3_ref, cas
from spacedrive_tpu_torch.parallel import autotune, mesh
from spacedrive_tpu_torch.parallel.autotune import (
    BATCH_LADDER,
    CONGESTED_GBPS,
    Controller,
    Sample,
    STARVED_WAIT_S,
    STEP_STREAK,
)
from spacedrive_tpu_torch.parallel.feeder import pipeline_depth
from spacedrive_tpu_torch.telemetry import metrics as tm
from spacedrive_tpu_torch.telemetry.events import AUTOTUNE_EVENTS
from spacedrive_tpu_torch.telemetry.snapshot import counter_value, gauge_value


@pytest.fixture(autouse=True)
def _isolated_autotune(monkeypatch):
    """Each test drives its own Controller; the process-wide ones (and
    both device ladders) come out untouched."""
    monkeypatch.delenv("SD_AUTOTUNE", raising=False)
    monkeypatch.delenv("SD_PROCS_BATCH", raising=False)  # JAX's policy reads it
    for mod in (autotune, jautotune):
        mod.reset()
    for ladder in (mesh.LADDER, jmesh.LADDER):
        ladder.reset()
    yield
    for mod in (autotune, jautotune):
        mod.reset()
    for ladder in (mesh.LADDER, jmesh.LADDER):
        ladder.reset()
        ladder.reset_timeout = 30.0


def starved(cls=Sample) -> Sample:
    return cls(wait_mean_s=STARVED_WAIT_S * 4, wait_n=3, link_gbps=CONGESTED_GBPS * 3)


def congested(cls=Sample) -> Sample:
    s = cls(link_gbps=CONGESTED_GBPS / 10)
    s.occ_mean["blake3"] = 0.3
    s.occ_n["blake3"] = 2
    return s


def clear_sample(occ: float = 0.95, cls=Sample) -> Sample:
    s = cls(link_gbps=CONGESTED_GBPS * 3)
    s.occ_mean["blake3"] = occ
    s.occ_n["blake3"] = 2
    return s


# --- the cases of tests/test_autotune.py, against the port -------------------


def test_cold_start_holds_static_defaults():
    c = Controller(interval=999)
    pol = c.policies["identify"]
    assert pol.identify_window_rows(1) == 1024
    assert pol.identify_window_rows(8) == 8192
    assert pol.feeder_depth(1) == pipeline_depth(1)
    assert pol.dispatch_rows_per_device() == BATCH_LADDER[-1]
    # ticks with no samples: the first primes the baseline, later ones
    # see zero deltas, so nothing may move
    for _ in range(10):
        assert c.tick() == []
    assert pol.snapshot() == {
        "rung": 2, "rows_per_device": 1024,
        "window_scale": 1.0, "depth_extra": 0,
        "pool_scale": 1.0, "pool_quantum": 32,
    }


def test_empty_sample_holds_streaks():
    """An idle tick between two starved ticks does not reset the streak:
    no evidence is not contrary evidence."""
    c = Controller(interval=999)
    c.tick(starved())
    c.tick(Sample())
    decisions = c.tick(starved())
    assert any(d["knob"] == "window_scale" and d["action"] == "promote" for d in decisions)


def test_starvation_widens_window_and_deepens_pipeline():
    c = Controller(interval=999)
    pol = c.policies["identify"]
    for _ in range(STEP_STREAK):
        c.tick(starved())
    assert pol.window_scale == 2.0
    assert pol.depth_extra == 1
    for _ in range(40):
        c.tick(starved())
    assert pol.window_scale <= autotune.SCALE_MAX
    assert pol.feeder_depth(1) <= autotune.FEEDER_DEPTH_CAP
    comfortable = Sample(wait_mean_s=0.0001, wait_n=3, link_gbps=CONGESTED_GBPS * 3)
    for _ in range(60):
        c.tick(comfortable)
    assert pol.window_scale == 1.0
    assert pol.depth_extra == 0


def test_congested_link_demotes_rung():
    c = Controller(interval=999)
    pol = c.policies["identify"]
    for _ in range(6 * STEP_STREAK):
        c.tick(congested())
    assert pol.rung == 0
    assert pol.dispatch_rows_per_device() == BATCH_LADDER[0]
    for _ in range(6 * STEP_STREAK):
        c.tick(clear_sample())
    assert pol.rung == len(BATCH_LADDER) - 1


def test_low_occupancy_demotes_rung_on_clear_link():
    c = Controller(interval=999)
    pol = c.policies["identify"]
    for _ in range(4 * STEP_STREAK):
        c.tick(clear_sample(occ=0.2))
    assert pol.rung < len(BATCH_LADDER) - 1


def test_rung_promotes_on_full_batches_without_link_probe():
    """With no link probe (0.0, as on every production node) full
    batches alone promote the rung back up."""
    c = Controller(interval=999)
    pol = c.policies["identify"]
    low = Sample()
    low.occ_mean["blake3"], low.occ_n["blake3"] = 0.2, 2
    for _ in range(4 * STEP_STREAK):
        c.tick(low)
    assert pol.rung < len(BATCH_LADDER) - 1
    full = Sample()
    full.occ_mean["blake3"], full.occ_n["blake3"] = 0.95, 2
    for _ in range(6 * STEP_STREAK):
        c.tick(full)
    assert pol.rung == len(BATCH_LADDER) - 1


def test_alternating_signals_do_not_thrash():
    c = Controller(interval=999)
    pol = c.policies["identify"]
    before = pol.snapshot()
    decisions = []
    for i in range(50):
        decisions += c.tick(congested() if i % 2 == 0 else clear_sample())
    assert pol.snapshot() == before
    assert decisions == []


def test_sustained_signal_still_steps_after_damping():
    c = Controller(interval=999)
    pol = c.policies["identify"]
    for i in range(STEP_STREAK - 1):
        c.tick(congested())
        assert pol.rung == len(BATCH_LADDER) - 1, f"stepped early at {i}"
    c.tick(congested())
    assert pol.rung == len(BATCH_LADDER) - 2


def test_never_promotes_past_device_ladder_demotion():
    c = Controller(interval=999)
    pol = c.policies["identify"]
    mesh.LADDER._level = mesh.LEVEL_SUBSET
    c.tick(clear_sample())
    assert pol.rung == 1  # the clamp lands on the next tick, undamped
    for _ in range(10 * STEP_STREAK):
        c.tick(clear_sample())
    assert pol.rung <= 1
    assert pol.dispatch_rows_per_device() <= BATCH_LADDER[1]
    mesh.LADDER._level = mesh.LEVEL_HOST
    c.tick(clear_sample())
    assert pol.dispatch_rows_per_device() == BATCH_LADDER[0]
    mesh.LADDER._level = mesh.LEVEL_MESH
    for _ in range(10 * STEP_STREAK):
        c.tick(clear_sample())
    assert pol.rung == len(BATCH_LADDER) - 1


def test_policy_read_clamps_even_between_ticks():
    pol = autotune.policy("identify")
    assert pol.dispatch_rows_per_device() == BATCH_LADDER[-1]
    mesh.LADDER._level = mesh.LEVEL_SUBSET
    assert pol.dispatch_rows_per_device() == BATCH_LADDER[1]


def test_decisions_land_on_ring_and_metrics():
    AUTOTUNE_EVENTS.clear()
    c = Controller(interval=999)
    for _ in range(STEP_STREAK):
        c.tick(starved())
    events = [e for e in AUTOTUNE_EVENTS.snapshot() if e["type"] == "decision"]
    assert events, "decisions must land on the autotune ring"
    ev = events[0]["fields"]
    assert (ev["workload"], ev["action"], ev["reason"]) == ("identify", "promote", "starved")
    assert counter_value("sd_autotune_decisions_total", workload="identify",
                         action="promote") >= 1
    assert gauge_value("sd_autotune_window_scale", workload="identify") == 2.0


def test_snapshot_carries_autotune_state():
    out = autotune.snapshot()
    assert out["enabled"] is True
    assert set(out["policies"]) == {"identify", "thumbnail", "embed"}
    assert out["policies"]["identify"]["rows_per_device"] == 1024


def test_disabled_env_is_static_bit_for_bit(monkeypatch):
    monkeypatch.setenv("SD_AUTOTUNE", "0")
    c = Controller(interval=999)
    pol = c.policies["identify"]
    assert c.tick(starved()) == []
    pol.window_scale, pol.depth_extra, pol.rung = 4.0, 3, 0
    assert pol.identify_window_rows(1) == 1024
    assert pol.identify_window_rows(8) == 8192
    assert pol.thumb_chunk_rows(1) == 32
    assert pol.feeder_depth(1) == pipeline_depth(1)
    assert pol.feeder_depth(8) == pipeline_depth(8)
    assert pol.dispatch_rows_per_device() == 1024
    mesh.LADDER._level = mesh.LEVEL_SUBSET
    assert pol.dispatch_rows_per_device() == 1024


def _msgs(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in sizes]


def test_disabled_env_cas_ids_identical_to_reference(monkeypatch):
    msgs = _msgs(7, (1, 500, 1024, 3000, 40_000, cas.LARGE_MSG_LEN))
    want = [blake3_ref.StreamingBlake3().update(m).hexdigest()[:16] for m in msgs]
    monkeypatch.setenv("SD_AUTOTUNE", "0")
    assert cas.cas_ids(msgs, "cpu") == want


def test_sizing_changes_never_change_bytes(monkeypatch):
    """The same batch through every rung: the ids are identical and the
    rung sets the dispatch step (32, 256 or 1024 rows per part)."""
    msgs = _msgs(9, [700] * 40 + [cas.LARGE_MSG_LEN] * 8)
    want = [blake3_ref.StreamingBlake3().update(m).hexdigest()[:16] for m in msgs]
    pol = autotune.policy("identify")
    parts = []
    real = cas.blake3_torch.hash_batch_begin

    def spy(arr, lens, c, devices):
        parts.append(arr.shape[0])
        return real(arr, lens, c, devices)

    monkeypatch.setattr(cas.blake3_torch, "hash_batch_begin", spy)
    for rung in range(len(BATCH_LADDER)):
        pol.rung = rung
        parts.clear()
        assert cas.cas_ids(msgs, "cpu") == want, f"rung {rung} diverged"
        assert len(parts) == -(-40 // BATCH_LADDER[rung]) + -(-8 // BATCH_LADDER[rung])


# --- parity with JAX's Controller on Sample scripts --------------------------


def _pool(batches, rt, dispatch, rows):
    return {"pool_batches": batches, "pool_roundtrip_s": rt, "pool_dispatch_s": dispatch,
            "pool_rows": rows}


#: each entry is one tick: (fields of Sample, {occupancy op: mean})
SCRIPTS = {
    "starvation_then_decay": [({"wait_mean_s": 0.2, "wait_n": 3}, {})] * 12
    + [({"wait_mean_s": 0.0005, "wait_n": 3, "link_gbps": 2.0}, {})] * 30,
    "urgent_wait": [({"wait_mean_s": 0.9, "wait_n": 1}, {})] * 5
    + [({}, {})] * 2 + [({"wait_mean_s": 0.9, "wait_n": 1}, {})] * 3,
    "congestion_then_clear": [({"link_gbps": 0.05, "wait_mean_s": 0.1, "wait_n": 2},
                               {"blake3": 0.3})] * 8
    + [({"link_gbps": 3.0}, {"blake3": 0.95})] * 10,
    "occupancy_bands": [({}, {"blake3": 0.2, "thumbnail": 0.97, "embed": 0.95})] * 8
    + [({}, {"blake3": 0.7, "thumbnail": 0.3, "embed": 0.2})] * 8
    + [({"link_gbps": 1.0}, {"blake3": 0.7})] * 4
    + [({}, {"blake3": 0.96, "thumbnail": 0.96})] * 8,
    "alternating": [({"link_gbps": 0.05}, {"blake3": 0.3}),
                    ({"link_gbps": 3.0}, {"blake3": 0.95})] * 20,
    "loop_lag": [({"wait_mean_s": 0.1, "wait_n": 2}, {})] * 6
    + [({"wait_mean_s": 0.1, "wait_n": 2, "loop_lag_s": 0.5}, {})] * 6
    + [({"loop_lag_s": 0.19}, {})] * 2,
    "pool_bands": [(_pool(4, 0.04, 0.01, 128), {})] * 8    # ipc tax: grow
    + [(_pool(4, 0.4, 0.001, 16), {})] * 6                 # underfilled: shrink
    + [(_pool(4, 0.04, 0.01, 512), {})] * 4
    + [(_pool(2, 9.0, 0.01, 64), {})] * 6                  # slow roundtrips: shrink
    + [(_pool(3, 0.3, 0.001, 96), {})] * 3                 # neutral
    + [({}, {})] * 2,
}


def _sample(cls, fields, occ):
    s = cls(**fields)
    for op, mean in occ.items():
        s.occ_mean[op] = mean
        s.occ_n[op] = 2
    return s


def _knobs(ctl):
    return {w: (p.rung, p.window_scale, p.depth_extra, p.pool_scale,
                p.dispatch_rows_per_device(), p.identify_window_rows(2), p.thumb_chunk_rows(2),
                p.embed_chunk_rows(2), p.feeder_depth(2), p.procpool_batch_rows())
            for w, p in ctl.policies.items()}


def _workload_decisions(decisions):
    """A tick's workload decisions: the stage plane's lease decisions
    read the process-wide stage rates, which other tests' shards may
    have fed (tests/test_torch_work.py holds the stage plane to JAX's)."""
    return [d for d in decisions if d.get("knob") != "stage_lease"]


def _run_both(script):
    port, ref = Controller(interval=999), jautotune.Controller(interval=999)
    moved = 0
    for i, (fields, occ) in enumerate(script):
        got = _workload_decisions(port.tick(_sample(Sample, fields, occ)))
        want = _workload_decisions(ref.tick(_sample(jautotune.Sample, fields, occ)))
        assert got == want, f"tick {i}"
        assert _knobs(port) == _knobs(ref), f"tick {i}"
        moved += len(got)
    return port, moved


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_controller_decides_as_jax(name):
    port, moved = _run_both(SCRIPTS[name])
    if name != "alternating":
        assert moved > 0, "the script must move a knob"
    else:
        assert moved == 0


#: the "one_device" script of tests/test_torch_mesh.py: a failure at the
#: full set goes straight to the host, the re-arm probe at the subset
#: rung succeeds, every later full-set probe is inconclusive
ONE_DEVICE = ["filter", "inconclusive", "fail", "sleep", "filter", "succeed", "sleep",
              "filter", "inconclusive", "sleep", "filter", "inconclusive", "filter",
              "inconclusive"]


def _walk(ladder, devices, op, last):
    if op == "filter":
        return ladder.filter(devices)
    if op == "fail":
        ladder.record_failure(last[1], last[0])
    elif op == "succeed":
        ladder.record_success(last[1])
    elif op == "inconclusive":
        ladder.probe_inconclusive(last[1])
    else:
        time.sleep(0.3)
    return last


def test_controller_caps_the_rung_at_the_one_device_ladder_level_as_jax():
    """The one-device script on both global ladders: each ends at level
    1, so each controller caps the identify rung at 1 (256 rows per
    dispatch) however full the batches run."""
    sides = [(mesh.LADDER, [torch.device("cpu")]), (jmesh.LADDER, jax.devices()[:1])]
    lasts = [(list(devs), 0) for _, devs in sides]
    for ladder, _ in sides:
        ladder.reset_timeout = 0.2
    for op in ONE_DEVICE:
        lasts = [_walk(ladder, devs, op, last) for (ladder, devs), last in zip(sides, lasts)]
        assert mesh.LADDER.level == jmesh.LADDER.level, op
    assert mesh.LADDER.level == mesh.LEVEL_SUBSET
    _, moved = _run_both([({"link_gbps": 3.0}, {"blake3": 0.97})] * 12)
    assert moved == 1  # the undamped clamp, once
    assert autotune.Controller().policies["identify"].dispatch_rows_per_device() == 256
    assert jautotune.Controller().policies["identify"].dispatch_rows_per_device() == 256


@pytest.mark.parametrize("env", [None, "0"])
@pytest.mark.parametrize("workload", autotune.WORKLOADS)
def test_every_derived_size_equals_jax(monkeypatch, env, workload):
    """With knobs moved, every derived size equals JAX's; under
    SD_AUTOTUNE=0 each is the static size, whatever the knobs say."""
    if env is not None:
        monkeypatch.setenv("SD_AUTOTUNE", env)
    pol, ref = autotune.PipelinePolicy(workload), jautotune.PipelinePolicy(workload)
    for rung, scale, extra, pscale in [(2, 1.0, 0, 1.0), (0, 8.0, 3, 4.0), (1, 0.5, 6, 0.5)]:
        for p in (pol, ref):
            p.rung, p.window_scale, p.depth_extra, p.pool_scale = rung, scale, extra, pscale
        for n in range(1, 9):
            got = (pol.identify_window_rows(n), pol.thumb_chunk_rows(n), pol.embed_chunk_rows(n),
                   pol.feeder_depth(n))
            assert got == (ref.identify_window_rows(n), ref.thumb_chunk_rows(n),
                           ref.embed_chunk_rows(n), ref.feeder_depth(n))
            if env == "0":
                assert got == (1024 * n, 32 * n, 32 * n, pipeline_depth(n))
        assert pol.dispatch_rows_per_device() == ref.dispatch_rows_per_device()
        assert pol.procpool_batch_rows() == ref.procpool_batch_rows()
        assert pol.snapshot() == ref.snapshot()
        if env == "0":
            assert (pol.dispatch_rows_per_device(), pol.procpool_batch_rows()) == (1024, 32)


def test_sample_reads_the_same_deltas_as_jax():
    """The same feeder, occupancy and pool observations into both
    registries between two ticks give the same Sample."""
    port, ref = Controller(interval=999), jautotune.Controller(interval=999)
    port.sample(), ref.sample()  # prime the baselines
    for m in (tm, jtm):
        for v in (0.01, 0.2, 0.09):
            m.FEEDER_WAIT_SECONDS.observe(v)
        m.FEEDER_FETCH_SECONDS.observe(0.3)
        m.FEEDER_H2D_BYTES.inc(57352 * 3)
        m.DEVICE_DISPATCH_OCCUPANCY.observe(0.5, op="blake3")
        m.DEVICE_DISPATCH_OCCUPANCY.observe(1.0, op="blake3")
        m.PROCPOOL_DISPATCH_SECONDS.observe(0.002)
        m.PROCPOOL_ROUNDTRIP_SECONDS.observe(0.05)
        m.PROCPOOL_BATCH_ROWS.observe(32)
    got, want = port.sample(), ref.sample()
    for key in ("wait_mean_s", "wait_n", "fetch_s", "fetch_n", "h2d_bytes", "pool_batches",
                "pool_dispatch_s", "pool_roundtrip_s", "pool_rows", "demotion_level"):
        assert getattr(got, key) == pytest.approx(getattr(want, key)), key
    assert got.occ_mean["blake3"] == pytest.approx(0.75) == want.occ_mean["blake3"]
    assert got.wait_n == 3 and got.occ_n == want.occ_n


async def test_tick_loop_starts_refcounted_and_stops():
    c = Controller(interval=0.02)
    c.start()
    c.start()  # a second node's hold
    deadline = time.monotonic() + 5
    while c.ticks < 3 and time.monotonic() < deadline:
        await asyncio.sleep(0.02)
    assert c.ticks >= 3
    await c.stop()
    assert c._task is not None and not c._task.done(), "the first stop kept the survivor's loop"
    await c.stop()
    assert c._task is None
    ticks = c.ticks
    await asyncio.sleep(0.1)
    assert c.ticks == ticks
    assert gauge_value("sd_autotune_batch_rung", workload="embed") == 2.0
