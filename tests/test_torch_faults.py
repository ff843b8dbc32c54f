"""The port's fault plane against the JAX package's: the same catalog,
the same parse results and errors, the same firing sequence for a plan
and seed, the same activation bookkeeping; plus the port's CUDA-shaped
device error, its `--faults` flag and the `db.slow` point."""

import time

import pytest
import torch

from spacedrive_tpu.utils import faults as jfaults
from spacedrive_tpu_torch import cli
from spacedrive_tpu_torch.db.database import LibraryDb
from spacedrive_tpu_torch.telemetry import metrics as tm
from spacedrive_tpu_torch.telemetry.events import FAULT_EVENTS
from spacedrive_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _no_plan():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _spec_fields(spec):
    return (spec.point, spec.mode, spec.prob, spec.times, spec.after, spec.delay_s, spec.arg)


def test_catalog_equals_the_jax_catalog():
    assert faults.FAULT_POINTS.keys() == jfaults.FAULT_POINTS.keys()
    for point, (_doc, modes) in jfaults.FAULT_POINTS.items():
        assert faults.FAULT_POINTS[point][1] == modes


@pytest.mark.parametrize("text", [
    "device.blake3:raise:times=2,after=1;feeder.fetch:stall:delay_s=0.5",
    "device.probe:dead:arg=3,times=inf",
    "search.query:xla:prob=0.25,times=",
    " embed.forward:wrong_shape ; thumbnail.persist:crash:after=4 ;",
])
def test_parse_equals_jax(text):
    got = faults.FaultPlan.parse(text, seed=9)
    want = jfaults.FaultPlan.parse(text, seed=9)
    assert [_spec_fields(s) for s in got.specs] == [_spec_fields(s) for s in want.specs]
    assert got.seed == want.seed


def test_parse_counters_and_exhaustion():
    plan = faults.FaultPlan.parse("device.blake3:raise:times=2,after=1")
    # first hit is skipped (after=1), then 2 fire, then exhausted
    assert [plan.hit("device.blake3") is not None for _ in range(4)] == [
        False, True, True, False]
    assert plan.activations() == {"device.blake3": 2}


@pytest.mark.parametrize("text", [
    "not.a.point:raise", "device.blake3:vanish", "device.blake3", "device.probe:dead:bogus=1",
])
def test_bad_plans_are_rejected_like_jax(text):
    with pytest.raises(ValueError):
        jfaults.FaultPlan.parse(text)
    with pytest.raises(ValueError):
        faults.FaultPlan.parse(text)


def test_unregistered_point_is_rejected_at_hit():
    with pytest.raises(ValueError):
        faults.FaultPlan([]).hit("not.a.point")


def test_arg_discrimination():
    plan = faults.FaultPlan.parse("device.probe:dead:arg=3,times=inf")
    assert plan.hit("device.probe", arg="0") is None
    assert plan.hit("device.probe") is None
    assert plan.hit("device.probe", arg="3") is not None
    assert plan.hit("device.probe", arg=3) is not None  # times=inf, str(arg)


@pytest.mark.parametrize("text,points", [
    ("sync.ingest:poison:prob=0.5,times=inf", ["sync.ingest"]),
    ("device.blake3:raise:prob=0.3,times=100,after=7", ["device.blake3"]),
    ("device.blake3:xla:prob=0.2,times=inf;device.blake3:raise:prob=0.6,times=50;"
     "device.probe:dead:arg=2,prob=0.5,times=inf;feeder.fetch:stall:prob=0.9,times=inf",
     ["device.blake3", "device.probe", "feeder.fetch"]),
])
@pytest.mark.parametrize("seed", [0, 7])
def test_same_plan_and_seed_fire_the_same_sequence_as_jax(text, points, seed):
    """1,000 hits, cycling the points (and the probe's slot argument),
    fire the same specs in the same order in both packages."""
    port, ref = faults.FaultPlan.parse(text, seed=seed), jfaults.FaultPlan.parse(text, seed=seed)
    got, want = [], []
    for i in range(1000):
        point = points[i % len(points)]
        arg = str(i % 4) if point == "device.probe" else None
        a, b = port.hit(point, arg), ref.hit(point, arg)
        got.append(None if a is None else (a.point, a.mode, a.fired))
        want.append(None if b is None else (b.point, b.mode, b.fired))
    assert got == want
    assert any(got) and not all(got)
    assert port.activations() == ref.activations()


def test_env_and_fixture_activation():
    assert faults.install_from_env({}) is None
    plan = faults.install_from_env({"SD_FAULTS": "relay.http:500:times=1", "SD_FAULT_SEED": "3"})
    assert plan is not None and faults.active_plan() is plan and plan.seed == 3
    faults.clear()
    assert faults.hit("relay.http") is None
    with faults.active(faults.FaultPlan.parse("relay.http:500")):
        assert faults.hit("relay.http") is not None
    assert faults.active_plan() is None


def test_activation_is_counted_and_lands_on_the_ring():
    before = tm.FAULTS_INJECTED.value()
    FAULT_EVENTS.clear()
    with faults.active(faults.FaultPlan.parse("device.probe:dead:arg=1")):
        faults.hit("device.probe", arg="1")
    assert tm.FAULTS_INJECTED.value() == before + 1
    (event,) = FAULT_EVENTS.snapshot()
    assert event["type"] == "injected"
    assert event["fields"] == {"point": "device.probe", "mode": "dead", "fired": 1, "arg": "1"}


def test_device_error_is_cuda_shaped():
    err = faults.device_error("device.blake3")
    assert isinstance(err, RuntimeError)
    if hasattr(torch, "AcceleratorError"):
        assert isinstance(err, torch.AcceleratorError)
    assert "device.blake3" in str(err)


def test_cli_faults_flag_arms_the_plan(tmp_path, capsys):
    code = cli.main(["--faults", "device.blake3:xla:times=2", "--fault-seed", "5",
                     "labeler", "status", "--data-dir", str(tmp_path)])
    capsys.readouterr()
    assert code in (0, 1)
    plan = faults.active_plan()
    assert plan is not None and plan.seed == 5
    assert [_spec_fields(s) for s in plan.specs] == [
        ("device.blake3", "xla", 1.0, 2, 0, 0.2, None)]


def test_cli_without_flag_reads_the_env(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("SD_FAULTS", "db.slow:stall:times=1")
    cli.main(["labeler", "status", "--data-dir", str(tmp_path)])
    capsys.readouterr()
    assert [s.point for s in faults.active_plan().specs] == ["db.slow"]


def test_db_slow_stalls_every_read(tmp_path):
    db = LibraryDb(str(tmp_path / "lib.db"))
    db.query("SELECT 1")
    with faults.active(faults.FaultPlan.parse("db.slow:stall:delay_s=0.05,times=2")) as plan:
        t0 = time.perf_counter()
        db.query("SELECT 1")
        db.query_one("SELECT 1")
        db.query("SELECT 1")
        elapsed = time.perf_counter() - t0
    assert plan.activations() == {"db.slow": 2}
    assert elapsed >= 0.1
    db.close()
