"""The port's telemetry history and SLO engine against the JAX
package's (tests/test_slo_history.py pointed at the port).

- history bytes: the same seeded samplers under injected timestamps
  write byte-equal segment files (names and bytes) through rotation,
  retention and downsampling, and each package reads the other's
  directory as its own; the default allowlist is JAX's;
- SLO documents: `default_slos` (and their env knobs), `evaluate_slo`
  over seeded sample lists of every kind, and `evaluate` over the same
  history (a live writer and a bare directory) give equal documents;
- the JAX gate cases on the port: round trips, a restart continuing
  one series, rotation and retention, downsampling, a torn tail line,
  the tail and `telemetry.reset()`, the live registry samplers, burn
  rates, warn, idle zeroes, zero tolerance, writer vs directory, the
  CLI's offline `slo` (and against JAX's `sdx slo`), a sustained
  violation turning `slo` unhealthy, an all-ok rollup; and three 6.2a
  cases that waited for this plane: `telemetry.reset()` clearing the
  attribution, SLO and history-tail state, one capture window per SLO
  breach, and the profile-share samplers. The bench comparator's
  history gate waits for the port's `bench_e2e` legs, the peer mesh
  view for the p2p plane.

Exact comparisons throughout (tolerance 0).
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest

import spacedrive_tpu.telemetry as jtelemetry
from spacedrive_tpu.telemetry import history as jhistory
from spacedrive_tpu.telemetry import slo as jslo
from spacedrive_tpu_torch import telemetry
from spacedrive_tpu_torch.telemetry import history, slo
from spacedrive_tpu_torch.telemetry import metrics as tm
from spacedrive_tpu_torch.telemetry import sampler


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()
    jtelemetry.reset()
    yield
    telemetry.reset()
    jtelemetry.reset()


def _writer(tmp_path, **kw) -> history.HistoryWriter:
    return history.HistoryWriter(os.path.join(tmp_path, "hist"), **kw)


def _fixed_samplers(values: dict) -> dict:
    return {name: (lambda v=v: v) for name, v in values.items()}


def _dir_bytes(directory):
    return {n: open(os.path.join(directory, n), "rb").read()
            for n in sorted(os.listdir(directory))}


SERIES = ("files_per_s", "sync_lag_max_s", "interactive_p99_ms", "protected_sheds_total",
          "resource_rss_mb", "resource_fds", "tenant_fairness_index")


def _seeded_run(mod, directory, seed, n, base, step, **kw):
    """`n` samples of the SLO series from the seed, at base + i * step."""
    rng = np.random.default_rng(seed)
    vals = {
        "files_per_s": rng.choice([0.0, 20.0, 80.0, 400.123456789], n),
        "sync_lag_max_s": rng.uniform(0, 900, n),
        "interactive_p99_ms": rng.gamma(2.0, 80.0, n),
        "protected_sheds_total": np.cumsum(rng.random(n) < 0.05).astype(float),
        "resource_rss_mb": 500 + np.cumsum(rng.uniform(-1, 3, n)),
        "resource_fds": 40 + np.cumsum(rng.random(n) < 0.2).astype(float),
        "tenant_fairness_index": rng.uniform(0.3, 1.0, n),
    }
    w = mod.HistoryWriter(directory, samplers=None, **kw)
    for i in range(n):
        w._samplers = {k: (lambda v=float(v[i]): v) for k, v in vals.items()}
        w.sample(now=base + i * step)
    return w


CONFIGS = {
    "plain": {},
    "rotate_retain": {"segment_max_records": 7, "retention_bytes": 3000},
    "downsample": {"segment_max_records": 16, "downsample_after_s": 3600.0},
}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("seed", range(3))
def test_segment_bytes_equal_jax(seed, config, tmp_path):
    base = 1_700_000_000.0 if config == "downsample" else time.time() - 500
    kw = CONFIGS[config]
    _seeded_run(history, str(tmp_path / "port"), seed, 90, base, 5.0, **kw)
    _seeded_run(jhistory, str(tmp_path / "jax"), seed, 90, base, 5.0, **kw)
    got, want = _dir_bytes(tmp_path / "port"), _dir_bytes(tmp_path / "jax")
    assert got == want and got
    if config != "plain":
        assert len(got) > 1
    if config == "downsample":
        assert any(b'"ds":true' in b for b in got.values())
    # each package reads the other's directory as its own
    assert history.read(str(tmp_path / "jax")) == jhistory.read(str(tmp_path / "port"))
    for name in SERIES:
        assert history.series(str(tmp_path / "jax"), name, since=base + 100) == \
            jhistory.series(str(tmp_path / "port"), name, since=base + 100)


def test_allowlist_and_knobs_equal_jax(monkeypatch):
    assert sorted(history.default_samplers()) == sorted(jhistory.default_samplers())
    for knob in ("SD_RESOURCES", "SD_TENANT_OBS"):
        monkeypatch.setenv(knob, "0")
        assert sorted(history.default_samplers()) == sorted(jhistory.default_samplers())
        monkeypatch.delenv(knob)
    for raw in (None, "0.01", "2.5", "bad"):
        if raw is None:
            monkeypatch.delenv("SD_HISTORY_INTERVAL_S", raising=False)
        else:
            monkeypatch.setenv("SD_HISTORY_INTERVAL_S", raw)
        assert history.interval_s() == jhistory.interval_s()
    assert (history.DIR_NAME, history.SEGMENT_MAX_RECORDS, history.RETENTION_BYTES,
            history.DOWNSAMPLE_AFTER_S, history.DOWNSAMPLE_STRIDE, history.TAIL_SAMPLES) == \
        (jhistory.DIR_NAME, jhistory.SEGMENT_MAX_RECORDS, jhistory.RETENTION_BYTES,
         jhistory.DOWNSAMPLE_AFTER_S, jhistory.DOWNSAMPLE_STRIDE, jhistory.TAIL_SAMPLES)


@pytest.mark.parametrize("env", [{}, {"SD_SLO_FILES_PER_S": "120", "SD_SLO_RSS_MB_PER_H": "8",
                                      "SD_RESOURCE_WARMUP_S": "0"},
                                 {"SD_RESOURCES": "0", "SD_TENANT_OBS": "0"}],
                         ids=["defaults", "knobs", "planes_off"])
def test_default_slos_equal_jax(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = [dataclasses.asdict(s) for s in slo.default_slos()]
    want = [dataclasses.asdict(s) for s in jslo.default_slos()]
    assert got == want


@pytest.mark.parametrize("kind", ["upper", "lower", "zero_tolerance", "trend"])
@pytest.mark.parametrize("seed", range(4))
def test_evaluate_slo_equals_jax(kind, seed):
    rng = np.random.default_rng(seed)
    now = 1_800_000_000.0
    n = int(rng.integers(0, 400))
    ts = np.sort(now - rng.uniform(0, 4000, n))
    vals = rng.choice([0.0, 10.0, 60.0, 300.0], n) + np.arange(n) * (kind == "trend")
    pairs = [(float(t), float(v)) for t, v in zip(ts, vals)]

    def samples_for(seconds):
        return [(t, v) for t, v in pairs if t >= now - seconds]

    kw = {"kind": kind, "objective": 50.0, "target": 0.95, "ignore_zero": kind == "lower",
          "min_samples": 4, "min_delta": 5.0}
    got = slo.evaluate_slo(slo.SLO("s", series="x", **kw), samples_for, now=now)
    want = jslo.evaluate_slo(jslo.SLO("s", series="x", **kw), samples_for, now=now)
    assert got == want


@pytest.mark.parametrize("seed", range(6))
def test_evaluate_over_the_same_history_equals_jax(seed, tmp_path):
    now = time.time()
    d = str(tmp_path / "hist")
    w = _seeded_run(history, d, seed, 240, now - 3700, 15.0)
    jw = jhistory.HistoryWriter(d, samplers={})
    jw._prime_tail()
    w.reset_tail()
    w._prime_tail()
    live, jlive = slo.evaluate(w, now=now), jslo.evaluate(jw, now=now)
    assert live == jlive
    assert slo.evaluate(directory=d, now=now) == jslo.evaluate(directory=d, now=now)
    assert {s["status"] for s in live["slos"]} - {slo.NO_DATA}


# --- the JAX gate cases on the port ------------------------------------------


def test_sample_read_roundtrip(tmp_path):
    w = _writer(tmp_path, samplers=_fixed_samplers({"files_per_s": 123.0}))
    for i in range(5):
        w.sample(now=1000.0 + i)
    recs = history.read(w.dir)
    assert len(recs) == 5
    assert [r["ts"] for r in recs] == [1000.0 + i for i in range(5)]
    assert all(r["v"]["files_per_s"] == 123.0 for r in recs)
    assert history.series(w.dir, "files_per_s")[0] == (1000.0, 123.0)


def test_history_survives_restart_as_one_series(tmp_path):
    base = time.time() - 20
    w1 = _writer(tmp_path, samplers=_fixed_samplers({"files_per_s": 100.0}))
    for i in range(4):
        w1.sample(now=base + i)
    del w1
    w2 = _writer(tmp_path, samplers=_fixed_samplers({"files_per_s": 90.0}))
    for i in range(4):
        w2.sample(now=base + 10 + i)
    series = history.series(w2.dir, "files_per_s")
    assert len(series) == 8
    assert [ts for ts, _ in series] == sorted(ts for ts, _ in series)
    assert {v for _, v in series} == {100.0, 90.0}


def test_segment_rotation_and_retention(tmp_path):
    w = _writer(tmp_path, samplers=_fixed_samplers({"x": 1.0}), segment_max_records=4,
                retention_bytes=400)
    for i in range(40):
        w.sample(now=3000.0 + i)
    segs = [n for n in os.listdir(w.dir) if n.startswith("seg-")]
    assert len(segs) > 1
    total = sum(os.path.getsize(os.path.join(w.dir, n)) for n in segs)
    assert total < 400 + 4 * 64
    series = history.series(w.dir, "x")
    assert series[-1][0] == 3039.0
    assert series[0][0] > 3000.0


def test_downsampling_compacts_old_segments(tmp_path):
    w = _writer(tmp_path, samplers=_fixed_samplers({"x": 2.0}), segment_max_records=8,
                downsample_after_s=100.0)
    base = time.time() - 10_000.0
    for i in range(8):
        w.sample(now=base + i)
    for i in range(2):
        w.sample(now=time.time())
    recs = history.read(w.dir, until=base + 100)
    ds = [r for r in recs if r.get("ds")]
    assert ds and ds[0]["v"]["x"] == pytest.approx(2.0)
    assert ds[0]["v"]["x__max"] == pytest.approx(2.0)
    assert ds[0]["n"] > 1


def test_torn_tail_line_is_skipped(tmp_path):
    w = _writer(tmp_path, samplers=_fixed_samplers({"x": 5.0}))
    w.sample(now=4000.0)
    w.sample(now=4001.0)
    seg = [os.path.join(w.dir, n) for n in os.listdir(w.dir)][0]
    with open(seg, "a", encoding="utf-8") as f:
        f.write('{"ts": 4002.0, "v": {"x":')
    assert [r["ts"] for r in history.read(w.dir)] == [4000.0, 4001.0]


def test_recent_prefers_tail_and_reset_clears_only_tail(tmp_path):
    w = _writer(tmp_path, samplers=_fixed_samplers({"x": 7.0}))
    now = time.time()
    for i in range(5):
        w.sample(now=now - 5 + i)
    assert len(w.recent(300.0, now=now)) == 5
    telemetry.reset()
    assert len(w.tail) == 0
    assert len(w.recent(300.0, now=now)) == 5
    assert len(history.read(w.dir)) == 5


def test_default_samplers_read_live_registry(tmp_path):
    tm.SYNC_LAG.set(42.0, peer="aabbccdd")
    tm.GATE_REQUESTS.inc(klass="control", outcome="shed")
    rec = _writer(tmp_path).sample(now=time.time())
    assert rec["v"]["sync_lag_max_s"] == 42.0
    assert rec["v"]["protected_sheds_total"] == 1.0
    assert "interactive_p99_ms" in rec["v"]
    assert rec["v"]["files_per_s"] == 0.0  # no identify yet: recorded as 0


def _samples_fn(pairs):
    return lambda seconds: pairs


def test_upper_slo_burn_and_status():
    s = slo.SLO("p99", series="interactive_p99_ms", objective=250.0, target=0.99)
    now = time.time()
    doc = slo.evaluate_slo(s, _samples_fn([(now - i, 100.0) for i in range(10)]))
    assert doc["status"] == slo.OK and doc["windows"]["fast"]["burn"] == 0.0
    doc = slo.evaluate_slo(s, _samples_fn([(now - i, 400.0) for i in range(10)]))
    assert doc["status"] == slo.BREACH
    assert doc["windows"]["fast"]["burn"] == pytest.approx(100.0)
    assert slo.evaluate_slo(s, _samples_fn([]))["status"] == slo.NO_DATA


def test_warn_needs_only_the_fast_window():
    s = slo.SLO("p99", series="x", objective=1.0, target=0.99)
    now = time.time()

    def samples_for(seconds):
        if seconds == s.fast_window_s:
            return [(now, 5.0)] * 10
        return [(now, 0.5)] * 500 + [(now, 5.0)] * 10

    assert slo.evaluate_slo(s, samples_for)["status"] == slo.WARN


def test_lower_slo_ignores_idle_zeroes():
    s = slo.SLO("throughput", series="files_per_s", objective=50.0, kind="lower",
                target=0.95, ignore_zero=True)
    now = time.time()
    assert slo.evaluate_slo(s, _samples_fn([(now - i, 0.0) for i in range(20)]))["status"] \
        == slo.NO_DATA
    assert slo.evaluate_slo(s, _samples_fn([(now - i, 5.0) for i in range(20)]))["status"] \
        == slo.BREACH


def test_zero_tolerance_counter_semantics():
    s = slo.SLO("sheds", series="protected_sheds_total", objective=0.0, kind="zero_tolerance")
    now = time.time()
    assert slo.evaluate_slo(s, _samples_fn([(now - 2, 3.0), (now - 1, 3.0)]))["status"] == slo.OK
    assert slo.evaluate_slo(s, _samples_fn([(now - 2, 3.0), (now - 1, 4.0)]))["status"] \
        == slo.BREACH
    assert slo.evaluate_slo(s, _samples_fn([(now - 2, 5.0), (now - 1, 2.0)]))["status"] == slo.OK


def test_evaluate_over_writer_and_directory(tmp_path):
    w = _writer(tmp_path, samplers=_fixed_samplers({
        "sync_lag_max_s": 1000.0, "files_per_s": 0.0, "interactive_p99_ms": 10.0,
        "protected_sheds_total": 0.0}))
    now = time.time()
    for i in range(12):
        w.sample(now=now - 12 + i)
    live = slo.evaluate(w, now=now)
    assert live["status"] == slo.BREACH
    by_name = {s["name"]: s for s in live["slos"]}
    assert by_name["sync_lag"]["status"] == slo.BREACH
    assert by_name["interactive_p99"]["status"] == slo.OK
    assert by_name["pass_throughput"]["status"] == slo.NO_DATA
    offline = slo.evaluate(directory=w.dir, now=now)
    assert {s["name"]: s["status"] for s in offline["slos"]} == \
        {s["name"]: s["status"] for s in live["slos"]}
    assert slo.REGISTRY.last_evaluation is not None
    telemetry.reset()
    assert slo.REGISTRY.last_evaluation is None


def _two_generations(data_dir):
    hdir = history.history_dir(data_dir)
    now = time.time()
    w = history.HistoryWriter(hdir, samplers=_fixed_samplers({"sync_lag_max_s": 1000.0}))
    for i in range(6):
        w.sample(now=now - 6 + i)
    del w
    w2 = history.HistoryWriter(hdir, samplers=_fixed_samplers({"sync_lag_max_s": 1000.0}))
    for i in range(6):
        w2.sample(now=now)


def test_cli_slo_reads_history_offline(tmp_path, capsys):
    """The CLI's `slo` without --url evaluates the data dir's history,
    continuous across node generations, as JAX's `sdx slo` does."""
    from spacedrive_tpu.cli import build_parser as jbuild_parser
    from spacedrive_tpu.cli import cmd_slo as jcmd_slo
    from spacedrive_tpu_torch import cli

    data_dir = os.path.join(tmp_path, "node")
    _two_generations(data_dir)
    out = os.path.join(tmp_path, "slo.json")
    assert cli.main(["slo", "--data-dir", data_dir, "--out", out]) == 0
    doc = json.load(open(out))
    by_name = {s["name"]: s for s in doc["slos"]}
    assert by_name["sync_lag"]["status"] == slo.BREACH
    assert by_name["sync_lag"]["windows"]["fast"]["samples"] == 12
    jout = os.path.join(tmp_path, "jslo.json")
    assert jcmd_slo(jbuild_parser().parse_args(["--data-dir", data_dir, "slo", "--out",
                                                 jout])) == 0
    jdoc = json.load(open(jout))
    doc.pop("ts"), jdoc.pop("ts")
    assert doc == jdoc
    assert cli.main(["slo"]) == 2


def test_sustained_violation_flips_slo_health(tmp_path):
    from spacedrive_tpu_torch.telemetry import health

    class FakeNode:
        history = _writer(tmp_path, samplers=_fixed_samplers({"sync_lag_max_s": 2000.0}))

    now = time.time()
    for i in range(12):
        FakeNode.history.sample(now=now - 12 + i)
    verdict = health._slo(FakeNode)
    assert verdict["status"] == health.UNHEALTHY
    assert "sync_lag" in verdict["reason"]
    full = health.evaluate(FakeNode)
    assert full["subsystems"]["slo"]["status"] == health.UNHEALTHY
    assert full["status"] == health.UNHEALTHY


def test_all_ok_rolls_up_ok_not_no_data(tmp_path):
    w = _writer(tmp_path, samplers=_fixed_samplers({
        "sync_lag_max_s": 1.0, "files_per_s": 500.0, "interactive_p99_ms": 10.0,
        "protected_sheds_total": 0.0, "tenant_fairness_index": 1.0}))
    now = time.time()
    for i in range(6):
        w.sample(now=now - 6 + i)
    doc = slo.evaluate(w, now=now)
    assert all(s["status"] == slo.OK for s in doc["slos"] if s["kind"] != "trend")
    assert doc["status"] == slo.OK


# --- 6.2a cases that waited for this plane -------------------------------------


def test_telemetry_reset_clears_attrib_slo_and_history_tails(tmp_path):
    from spacedrive_tpu_torch.telemetry import attrib

    attrib.mark_pass("indexer", "t-reset", "settled", status="COMPLETED")
    attrib._cache_store("t-reset", {"trace_id": "t-reset"})
    w = history.HistoryWriter(str(tmp_path / "hist"), samplers={"x": lambda: 1.0})
    w.sample()
    slo.evaluate(w)
    assert attrib.last_pass_trace() == "t-reset"
    assert slo.REGISTRY.last_evaluation is not None
    assert len(w.tail) == 1
    telemetry.reset()
    assert attrib.last_pass_trace() is None
    assert attrib.cached_report("t-reset") is None
    assert slo.REGISTRY.last_evaluation is None
    assert len(w.tail) == 0
    assert len(history.read(w.dir)) == 1


def test_slo_breach_opens_one_window(monkeypatch):
    monkeypatch.setattr(sampler, "CAPTURE_S", 30.0)
    monkeypatch.setattr(sampler, "COOLDOWN_S", 3600.0)

    class BreachingHistory:
        def recent(self, seconds, now=None):
            now = now or time.time()
            return [{"ts": now - 60, "v": {"protected_sheds_total": 0.0}},
                    {"ts": now - 30, "v": {"protected_sheds_total": 2.0}}]

    s = sampler.SAMPLER
    s.start()
    s.reset()
    try:
        assert slo.evaluate(BreachingHistory())["status"] == slo.BREACH
        slo.evaluate(BreachingHistory())
        slo.evaluate(BreachingHistory())
        caps = s.captures_snapshot()
        assert len(caps) == 1, caps
        assert caps[0]["reason"] == "slo_breach"
    finally:
        s.stop()


def test_history_samplers_include_profile_shares():
    samplers = history.default_samplers()
    for group in sampler.HISTORY_GROUPS:
        v = samplers[f"profile_share_{group}"]()
        assert 0.0 <= v <= 1.0
