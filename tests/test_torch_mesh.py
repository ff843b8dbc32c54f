"""The port's device seam against the JAX package's `parallel/mesh.py`.

The degradation ladders of both packages walk the same event scripts
side by side — demotion to a probed subset, all slots dead, the
half-open re-arm, a stale probe, concurrent failures and the one-device
script — and must report the same devices count, level and gauge after
every step. JAX's ladder runs over the conftest's virtual CPU devices,
the port's over a CPU slot list of the same length. The sizing helpers
(`factor3`, `pad_to_multiple`, the cas ladders and packing,
`shard_occupancy`, `pipeline_depth`, the autotune sizes) must equal
JAX's.
"""

import time

import jax
import numpy as np
import pytest
import torch

from spacedrive_tpu.ops import cas as jcas
from spacedrive_tpu.parallel import autotune as jautotune
from spacedrive_tpu.parallel import feeder as jfeeder
from spacedrive_tpu.parallel import mesh as jmesh
from spacedrive_tpu.telemetry import gauge_value
from spacedrive_tpu.utils import faults as jfaults
from spacedrive_tpu_torch.ops import cas
from spacedrive_tpu_torch.parallel import autotune, feeder, mesh
from spacedrive_tpu_torch.telemetry import metrics as tm
from spacedrive_tpu_torch.telemetry.events import RESILIENCE_EVENTS
from spacedrive_tpu_torch.utils import faults

CPU = torch.device("cpu")
RESET = 0.2  # ladder reset window of the scripts
NAP = 0.3    # a sleep past it


@pytest.fixture(autouse=True)
def _clean_state():
    faults.clear()
    jfaults.clear()
    mesh.LADDER.reset()
    mesh.LADDER.reset_timeout = 30.0
    yield
    faults.clear()
    jfaults.clear()
    mesh.LADDER.reset()
    mesh.LADDER.reset_timeout = 30.0


class _Side:
    """One package's ladder and fault plane, driven by a script."""

    def __init__(self, mesh_mod, faults_mod, devices):
        self.ladder = mesh_mod.DeviceLadder(reset_timeout=RESET)
        self.faults = faults_mod
        self.devices = devices
        self.last = (list(devices), 0)  # the last filter's (devices, level)

    def run(self, op, plan):
        with self.faults.active(self.faults.FaultPlan.parse(plan or "", seed=1)):
            if op == "filter":
                self.last = self.ladder.filter(self.devices)
                out = (len(self.last[0]), self.last[1])
            elif op == "fail":
                out = self.ladder.record_failure(self.last[1], self.last[0])
            elif op == "succeed":
                out = self.ladder.record_success(self.last[1])
            elif op == "inconclusive":
                out = self.ladder.probe_inconclusive(self.last[1])
            else:
                assert op == "sleep"
                out = time.sleep(NAP)
        return op, out, self.ladder.level


DEAD = "device.probe:dead:times=inf"
SCRIPTS = {
    "subset_via_dead_probe": (4, [
        ("filter", None), ("fail", "device.probe:dead:arg=3,times=inf"), ("filter", None),
        ("sleep", None), ("filter", None), ("succeed", None), ("filter", None)]),
    "all_dead_to_host": (4, [
        ("filter", None), ("fail", DEAD), ("filter", None), ("fail", None), ("filter", None),
        ("sleep", None), ("filter", DEAD), ("fail", None), ("filter", None)]),
    "half_open_rearm": (4, [
        ("filter", None), ("fail", None), ("filter", None), ("fail", None), ("filter", None),
        ("sleep", None), ("filter", None), ("succeed", None), ("sleep", None),
        ("filter", None), ("fail", None), ("filter", None), ("sleep", None),
        ("filter", None), ("succeed", None), ("filter", None)]),
    "stale_probe": (2, [
        ("filter", None), ("fail", DEAD), ("sleep", None), ("filter", None),
        ("filter", None), ("sleep", None), ("filter", None), ("succeed", None),
        ("filter", None)]),
    "rearm_sweep_with_a_dead_slot": (3, [
        ("filter", None), ("fail", DEAD), ("sleep", None),
        ("filter", "device.probe:dead:arg=0,times=inf"), ("succeed", None), ("filter", None)]),
    "concurrent_failures": (4, [
        ("filter", None), ("fail", None), ("fail", None), ("filter", None),
        ("fail", None), ("fail", None), ("filter", None)]),
    # the one-card machine: a failure at the full set goes straight to
    # the host (one slot cannot demote to a subset); the re-arm probe at
    # the subset rung pins the slot and succeeds; every later full-set
    # probe runs unsharded and is inconclusive, so the ladder stays at 1
    "one_device": (1, [
        ("filter", None), ("inconclusive", None), ("fail", None), ("sleep", None),
        ("filter", None), ("succeed", None), ("sleep", None), ("filter", None),
        ("inconclusive", None), ("sleep", None), ("filter", None), ("inconclusive", None),
        ("filter", None), ("inconclusive", None)]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_ladder_walks_the_jax_level_sequence(name):
    n, script = SCRIPTS[name]
    ref = _Side(jmesh, jfaults, jax.devices()[:n])
    port = _Side(mesh, faults, [CPU] * n)
    for step, (op, plan) in enumerate(script):
        want = ref.run(op, plan)
        got = port.run(op, plan)
        assert got == want, f"{name} step {step}: {op}"
    assert tm.DEVICE_DEMOTION.value() == gauge_value("sd_device_demotion_level")
    if name == "one_device":
        assert port.ladder.level == mesh.LEVEL_SUBSET


def test_subset_keeps_slot_positions():
    """Survivors are slot positions, not device indexes: a slot list of
    one repeated device still loses exactly the dead slot."""
    ladder = mesh.DeviceLadder(reset_timeout=30.0)
    slots = [CPU] * 4
    RESILIENCE_EVENTS.clear()
    with faults.active(faults.FaultPlan.parse("device.probe:dead:arg=1,times=inf")):
        assert ladder.record_failure(mesh.LEVEL_MESH, slots) == mesh.LEVEL_SUBSET
    assert ladder._subset == frozenset({0, 2, 3})
    got, level = ladder.filter(slots)
    assert (len(got), level) == (3, mesh.LEVEL_SUBSET)
    assert tm.DEVICE_DEMOTION.value() == 1.0
    (event,) = RESILIENCE_EVENTS.snapshot()
    assert event["type"] == "device_demote"
    assert event["fields"] == {"level": 1, "survivors": 3, "failed_level": 0}


def test_probe_of_a_broken_device_reads_dead_and_never_raises():
    class Broken:
        type = "cuda"

    assert mesh.DeviceLadder()._probe_device(0, Broken()) is False
    assert mesh.DeviceLadder()._probe_device(0, CPU) is True


def test_dispatch_devices_and_slots_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mesh.dispatch_devices() == []
    assert mesh.auto_slots("cuda") == []
    assert mesh.ladder_devices("cuda") is None
    monkeypatch.setattr(mesh, "dispatch_devices", lambda: [CPU] * 3)
    assert mesh.auto_slots("cpu") == [CPU] * 3
    assert mesh.auto_slots("cuda") == []
    assert mesh.auto_slots("cuda:0") == []  # a pinned device rides no ladder
    assert mesh.ladder_devices("cpu") == ([CPU] * 3, mesh.LEVEL_MESH)


def test_accelerator_count_is_one_without_cuda(monkeypatch):
    monkeypatch.setattr(mesh, "_ACCEL_COUNT", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mesh.accelerator_count() == 1
    assert mesh.device_scale("cuda") == mesh.device_scale("cpu") == 1
    monkeypatch.setattr(mesh, "_ACCEL_COUNT", [4])
    assert (mesh.device_scale("cuda"), mesh.device_scale("cpu")) == (4, 1)


def test_run_on_ladder_picks_the_jax_slots(monkeypatch):
    seen = []

    def call(slots):
        seen.append(list(slots))
        return len(slots)

    # no slots of the type: strict on the device itself
    assert mesh.run_on_ladder("cpu", 8, call, "test") == 1 and seen[-1] == [CPU]
    monkeypatch.setattr(mesh, "dispatch_devices", lambda: [CPU] * 3)
    assert mesh.run_on_ladder("cpu", 3, call, "test") == 3   # one real row per slot
    assert mesh.run_on_ladder("cpu", 2, call, "test") == 1   # too few rows: default
    for level, n_rows in ((0, 5), (0, 2), (1, 5), (1, 1), (2, 5)):
        devs = [CPU] * (3 if level < 2 else 0)
        got = mesh._auto_devices(devs, level, n_rows)
        jdevs = jax.devices()[:len(devs)]
        want = (jdevs if level < 2 and len(jdevs) > 1 and n_rows >= len(jdevs)
                else jdevs[:1] if level == 1 and jdevs else None)
        assert (None if got is None else len(got)) == (None if want is None else len(want))


def test_run_on_ladder_demotes_and_raises_past_the_last_rung(monkeypatch):
    monkeypatch.setattr(mesh, "dispatch_devices", lambda: [CPU] * 2)
    calls = []

    def failing(slots):
        calls.append(len(slots))
        raise RuntimeError("device lost")

    with pytest.raises(RuntimeError, match="device lost"):
        mesh.run_on_ladder("cpu", 4, failing, "test")
    # full set → the (all surviving) subset → the host rung's default device
    assert calls == [2, 2, 1]
    assert mesh.LADDER.level == mesh.LEVEL_HOST


@pytest.mark.parametrize("n", range(1, 17))
def test_factor3_equals_jax(n):
    assert mesh.factor3(n) == jmesh.factor3(n)


@pytest.mark.parametrize("rows,multiple", [(0, 3), (5, 1), (5, 4), (8, 4), (9, 8)])
def test_pad_to_multiple_equals_jax(rows, multiple):
    arr = np.arange(rows * 3, dtype=np.int32).reshape(rows, 3)
    got, want = mesh.pad_to_multiple(arr, multiple), jmesh.pad_to_multiple(arr, multiple)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])


@pytest.mark.parametrize("n", range(1, 9))
def test_batch_ladder_and_device_batch_equal_jax(n):
    assert cas.batch_ladder(n) == jcas.batch_ladder(n)
    assert cas.device_batch(n) == jcas.device_batch(n)


@pytest.mark.parametrize("n_devices,count", [(1, 5), (2, 5), (3, 33), (4, 70), (5, 161)])
def test_pack_canonical_batch_bytes_equal_jax(n_devices, count):
    rng = np.random.default_rng(count)
    msgs = [rng.bytes(int(n)) for n in rng.integers(1, 2048, count)]
    got = cas.pack_canonical_batch(msgs, 2, n_devices)
    want = jcas.pack_canonical_batch(msgs, 2, n_devices)
    assert got[0].tobytes() == want[0].tobytes()
    assert np.array_equal(got[1], want[1])
    with pytest.raises(ValueError):
        cas.pack_canonical_batch([b"x"] * (cas.device_batch(n_devices) + 1), 1, n_devices)


@pytest.mark.parametrize("n_real,n_pad,n_dev", [(5, 32, 1), (5, 64, 2), (33, 96, 3), (70, 128, 4),
                                                (0, 8, 4), (128, 128, 4)])
def test_shard_occupancy_equals_jax(n_real, n_pad, n_dev):
    assert cas.shard_occupancy(n_real, n_pad, n_dev) == jcas.shard_occupancy(n_real, n_pad, n_dev)


def test_pipeline_depth_and_sizes_equal_jax():
    for n in range(0, 40):
        assert feeder.pipeline_depth(n) == jfeeder.pipeline_depth(n)
    for n in range(1, 9):
        assert autotune.identify_window_rows(n) == jautotune.IDENTIFY_DEVICE_WINDOW * n
        assert autotune.thumb_chunk_rows(n) == jautotune.THUMB_DEVICE_BATCH * n
        assert autotune.embed_chunk_rows(n) == jautotune.EMBED_DEVICE_BATCH * n
