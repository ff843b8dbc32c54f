"""The port's resilience layer against the JAX package's
(tests/test_resilience.py's policy, breaker and deadline cases pointed
at the port).

- breaker transitions: the same seeded event scripts (allow, success,
  failure, clock advances) under one injected monotonic clock give the
  same (admitted, state, failures) after every event in both packages,
  and the same transition events on the `resilience` ring;
- jitter: `RetryPolicy.sleeps` over `random.Random(seed)` gives equal
  sequences;
- `ResiliencePolicy.call` over the same seeded failure scripts: equal
  results, attempts, breaker snapshots and retry events;
- the JAX gate cases on the port: jitter bounds, retry then success,
  give-up, PASS classification, open / half-open / recover, an abandoned
  probe never wedges, a PASS during the probe closes, a failed probe
  re-opens, fast-fail and the breaker metrics, deadlines bound calls
  and clip attempt timeouts, scopes nest tightening only, the
  `resilience` health verdict, and the job supervisor's cases (a forced
  abortion settles CANCELED, on the jobs ring and on its pass marker).
  The fault-plan, ladder and feeder cases of that file are held in
  tests/test_torch_faults.py, test_torch_mesh.py and test_torch_feeder.py.

Exact comparisons throughout (tolerance 0).
"""

import asyncio
import random
import time

import numpy as np
import pytest

import spacedrive_tpu.telemetry as jtelemetry
from spacedrive_tpu.telemetry import events as jevents
from spacedrive_tpu.utils import resilience as jres
from spacedrive_tpu_torch import telemetry
from spacedrive_tpu_torch.telemetry import counter_value, events, gauge_value
from spacedrive_tpu_torch.utils import resilience as res
from spacedrive_tpu_torch.utils.resilience import (
    PASS,
    RETRY,
    BreakerOpen,
    CircuitBreaker,
    DeadlineExceeded,
    ResiliencePolicy,
    RetryPolicy,
    deadline_remaining,
    deadline_scope,
)

PKGS = {"jax": jres, "port": res}


@pytest.fixture(autouse=True)
def _clean():
    for m in PKGS.values():
        m.reset_breakers()
    telemetry.reset()
    jtelemetry.reset()
    yield
    for m in PKGS.values():
        m.reset_breakers()
    telemetry.reset()
    jtelemetry.reset()


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _script(seed, n=160):
    """A seeded event script: allow / success / failure / advance."""
    rng = np.random.default_rng(seed)
    ops = rng.choice(["allow", "success", "failure", "advance"], n, p=[0.35, 0.15, 0.3, 0.2])
    dts = rng.choice([0.01, 0.04, 0.06, 0.2], n)
    return list(zip(ops.tolist(), dts.tolist()))


def _run_breaker(mod, script, monkeypatch, threshold, reset_timeout):
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    b = mod.CircuitBreaker("peer-x", failure_threshold=threshold,
                           reset_timeout=reset_timeout, policy="p")
    trace = []
    for op, dt in script:
        got = None
        if op == "allow":
            got = b.allow()
        elif op == "success":
            b.record_success()
        elif op == "failure":
            b.record_failure()
        else:
            clock.t += dt
        trace.append((op, got, b.state, b.failures))
    monkeypatch.undo()
    return trace


@pytest.mark.parametrize("seed", range(8))
def test_breaker_transitions_equal_jax_on_seeded_scripts(seed, monkeypatch):
    script = _script(seed)
    threshold = 1 + seed % 4
    got = _run_breaker(res, script, monkeypatch, threshold, 0.05)
    want = _run_breaker(jres, script, monkeypatch, threshold, 0.05)
    assert got == want
    states = {s for *_, s, _ in got}
    assert res.OPEN in states
    # the same transitions land on each package's resilience ring
    port_ring = [e["fields"] for e in events.RESILIENCE_EVENTS.snapshot() if e["type"] == "breaker"]
    jax_ring = [e["fields"] for e in jevents.RESILIENCE_EVENTS.snapshot() if e["type"] == "breaker"]
    assert port_ring == jax_ring and port_ring


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("policy", [RetryPolicy(), RetryPolicy(max_attempts=50, base_delay=0.05,
                                                               max_delay=2.0),
                                    RetryPolicy(max_attempts=7, base_delay=0.3, max_delay=0.5)],
                         ids=["default", "wide", "capped"])
def test_jitter_sequences_equal_jax(seed, policy):
    jpolicy = jres.RetryPolicy(policy.max_attempts, policy.base_delay, policy.max_delay,
                               policy.attempt_timeout)
    got = list(policy.sleeps(random.Random(seed)))
    want = list(jpolicy.sleeps(random.Random(seed)))
    assert got == want and len(got) == policy.max_attempts - 1


async def _run_policy(mod, seed, outcomes):
    """One seeded policy over a target whose n-th call fails or answers
    as `outcomes` says; returns the results, attempts and snapshots."""
    policy = mod.ResiliencePolicy(
        "script", mod.RetryPolicy(max_attempts=3, base_delay=0.0005, max_delay=0.001),
        failure_threshold=3, reset_timeout=30.0, seed=seed,
        classify=lambda e: mod.PASS if isinstance(e, ValueError) else mod.RETRY,
    )
    calls = iter(outcomes)
    log = []

    async def target():
        kind = next(calls, "ok")
        log.append(kind)
        if kind == "down":
            raise ConnectionError("down")
        if kind == "4xx":
            raise ValueError("404")
        return "ok"

    results = []
    for _ in range(6):
        try:
            results.append(await policy.call("relay-1", target))
        except mod.BreakerOpen:
            results.append("breaker_open")
        except ConnectionError:
            results.append("connection_error")
        except ValueError:
            results.append("value_error")
    ring = jevents.RESILIENCE_EVENTS if mod is jres else events.RESILIENCE_EVENTS
    retries = [{k: v for k, v in e["fields"].items() if k != "sleep_s"}
               for e in ring.snapshot() if e["type"] == "retry"]
    sleeps = [e["fields"]["sleep_s"] for e in ring.snapshot() if e["type"] == "retry"]
    return results, log, mod.breaker_snapshot(), retries, sleeps


@pytest.mark.parametrize("seed", range(6))
def test_policy_call_scripts_equal_jax(seed):
    rng = np.random.default_rng(100 + seed)
    outcomes = rng.choice(["down", "4xx", "ok"], 24, p=[0.6, 0.15, 0.25]).tolist()
    got = asyncio.run(_run_policy(res, seed, outcomes))
    want = asyncio.run(_run_policy(jres, seed, outcomes))
    assert got == want


# --- the JAX gate cases on the port ------------------------------------------


def test_decorrelated_jitter_bounds():
    policy = RetryPolicy(max_attempts=50, base_delay=0.05, max_delay=2.0)
    sleeps = list(policy.sleeps(random.Random(1)))
    assert len(sleeps) == 49
    assert all(0.05 <= s <= 2.0 for s in sleeps)
    assert len({round(s, 6) for s in sleeps}) > 5


@pytest.mark.asyncio
async def test_policy_retries_then_succeeds():
    policy = ResiliencePolicy("t1", RetryPolicy(max_attempts=3, base_delay=0.001, max_delay=0.01))
    calls = []

    async def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("boom")
        return "ok"

    before = counter_value("sd_resilience_retries_total")
    assert await policy.call("target", flaky) == "ok"
    assert len(calls) == 3
    assert counter_value("sd_resilience_retries_total") == before + 2
    assert policy.breaker("target").state == res.CLOSED
    assert policy.breaker("target").failures == 0


@pytest.mark.asyncio
async def test_policy_gives_up_after_max_attempts():
    policy = ResiliencePolicy("t2", RetryPolicy(max_attempts=2, base_delay=0.001, max_delay=0.01))
    calls = []

    async def dead():
        calls.append(1)
        raise ConnectionError("still dead")

    with pytest.raises(ConnectionError):
        await policy.call("target", dead)
    assert len(calls) == 2
    assert policy.breaker("target").failures == 2


@pytest.mark.asyncio
async def test_policy_pass_classification_skips_retry_and_breaker():
    policy = ResiliencePolicy("t3", RetryPolicy(max_attempts=5, base_delay=0.001),
                              classify=lambda e: PASS if isinstance(e, ValueError) else RETRY)
    calls = []

    async def bad_request():
        calls.append(1)
        raise ValueError("a 4xx-shaped error")

    with pytest.raises(ValueError):
        await policy.call("target", bad_request)
    assert len(calls) == 1
    assert policy.breaker("target").failures == 0


def test_breaker_opens_half_opens_and_recovers():
    b = CircuitBreaker("x", failure_threshold=3, reset_timeout=0.05)
    assert b.allow()
    for _ in range(3):
        b.record_failure()
    assert b.state == res.OPEN
    assert not b.allow()
    time.sleep(0.06)
    assert b.allow()
    assert b.state == res.HALF_OPEN
    assert not b.allow()
    b.record_success()
    assert b.state == res.CLOSED and b.allow()


def test_breaker_half_open_never_wedges():
    b = CircuitBreaker("x", failure_threshold=1, reset_timeout=0.05)
    b.record_failure()
    time.sleep(0.06)
    assert b.allow()
    assert not b.allow()
    time.sleep(0.06)
    assert b.allow()
    b.record_success()
    assert b.state == res.CLOSED


@pytest.mark.asyncio
async def test_pass_during_half_open_probe_closes_breaker():
    policy = ResiliencePolicy(
        "t_pass_probe", RetryPolicy(max_attempts=1, base_delay=0.001),
        failure_threshold=1, reset_timeout=0.05,
        classify=lambda e: PASS if isinstance(e, ValueError) else RETRY,
    )

    async def dead():
        raise ConnectionError("down")

    with pytest.raises(ConnectionError):
        await policy.call("t", dead)
    assert policy.breaker("t").state == res.OPEN
    await asyncio.sleep(0.06)

    async def answers_404():
        raise ValueError("404")

    with pytest.raises(ValueError):
        await policy.call("t", answers_404)
    assert policy.breaker("t").state == res.CLOSED


def test_breaker_half_open_failure_reopens():
    b = CircuitBreaker("x", failure_threshold=1, reset_timeout=0.05)
    b.record_failure()
    assert b.state == res.OPEN
    time.sleep(0.06)
    assert b.allow()
    b.record_failure()
    assert b.state == res.OPEN
    assert not b.allow()


@pytest.mark.asyncio
async def test_policy_breaker_open_fast_fails_and_metrics():
    policy = ResiliencePolicy("t4", RetryPolicy(max_attempts=1, base_delay=0.001),
                              failure_threshold=2, reset_timeout=0.1)

    async def dead():
        raise ConnectionError("down")

    for _ in range(2):
        with pytest.raises(ConnectionError):
            await policy.call("relay", dead)
    assert gauge_value("sd_breaker_open") >= 1.0
    calls = []

    async def should_not_run():
        calls.append(1)

    with pytest.raises(BreakerOpen):
        await policy.call("relay", should_not_run)
    assert calls == []
    await asyncio.sleep(0.12)

    async def alive():
        return "ok"

    assert await policy.call("relay", alive) == "ok"
    assert policy.breaker("relay").state == res.CLOSED
    assert gauge_value("sd_breaker_open") == 0.0
    states = [e["fields"]["state"] for e in events.ring("resilience").snapshot()
              if e["type"] == "breaker"]
    assert "open" in states and "half_open" in states and "closed" in states
    # targets leave the node only as peer_label short-hashes
    assert set(res.breaker_snapshot()) == {f"t4:{telemetry.peers.peer_label('relay')}"}


@pytest.mark.asyncio
async def test_deadline_scope_bounds_calls():
    policy = ResiliencePolicy("t5", RetryPolicy(max_attempts=100, base_delay=0.02,
                                                max_delay=0.05))

    async def dead():
        raise ConnectionError("down")

    t0 = time.monotonic()
    with deadline_scope(0.1):
        with pytest.raises((DeadlineExceeded, ConnectionError)):
            await policy.call("x", dead)
    assert time.monotonic() - t0 < 1.0


@pytest.mark.asyncio
async def test_deadline_clips_attempt_timeout():
    policy = ResiliencePolicy("t6", RetryPolicy(max_attempts=1, base_delay=0.001,
                                                attempt_timeout=30.0))

    async def slow():
        await asyncio.sleep(5)

    t0 = time.monotonic()
    with deadline_scope(0.05):
        with pytest.raises((TimeoutError, asyncio.TimeoutError)):
            await policy.call("x", slow)
    assert time.monotonic() - t0 < 1.0


def test_deadline_scopes_nest_tightening_only():
    assert deadline_remaining() is None
    with deadline_scope(10.0):
        outer = deadline_remaining()
        assert outer is not None and outer <= 10.0
        with deadline_scope(99.0):
            inner = deadline_remaining()
            assert inner is not None and inner <= outer + 0.01
    assert deadline_remaining() is None


def test_health_resilience_verdict_equals_jax():
    """An open breaker degrades the `resilience` subsystem, in both
    packages with the same signals but for the snapshot's policy names."""
    from spacedrive_tpu.telemetry import health as jhealth
    from spacedrive_tpu_torch.telemetry import health

    assert health.evaluate()["subsystems"]["resilience"] == \
        jhealth.evaluate()["subsystems"]["resilience"]
    for mod in PKGS.values():
        mod.ResiliencePolicy("t7", failure_threshold=1).breaker("dead-peer").record_failure()
    got = health.evaluate()["subsystems"]["resilience"]
    want = jhealth.evaluate()["subsystems"]["resilience"]
    assert got["status"] == health.DEGRADED and got == want
    assert got["signals"]["open_breakers"] == 1


# --- the job supervisor: cancellation is not a crash -------------------------


def test_status_for_forced_abortion_is_canceled():
    from spacedrive_tpu_torch.jobs.job import status_for_result
    from spacedrive_tpu_torch.jobs.report import JobStatus
    from spacedrive_tpu_torch.tasks import TaskStatus

    assert status_for_result(TaskStatus.FORCED_ABORTION, False) == JobStatus.CANCELED
    assert status_for_result(TaskStatus.ERROR, False) == JobStatus.FAILED


@pytest.mark.asyncio
async def test_shutdown_cancellation_records_no_spurious_failure(tmp_path):
    """A force-aborted job settles CANCELED on the jobs ring and, since
    the pass markers, its `settled` marker carries the same status."""
    from spacedrive_tpu_torch.jobs import JobManager, JobStatus
    from spacedrive_tpu_torch.jobs.job import JobContext, StatefulJob, StepResult
    from spacedrive_tpu_torch.node.library import Libraries
    from spacedrive_tpu_torch.tasks import TaskSystem
    from spacedrive_tpu_torch.telemetry import attrib

    class _Hang(StatefulJob):
        NAME = "hang_job"

        async def init_job(self, ctx: JobContext) -> None:
            self.steps.append({"kind": "hang"})

        async def execute_step(self, ctx, step, step_number) -> StepResult:
            await asyncio.sleep(30)
            return StepResult()

    library = Libraries(tmp_path).create("cancel-lib")
    mgr = JobManager(TaskSystem(1))
    job = _Hang()
    await mgr.ingest(job, library)
    await asyncio.sleep(0.05)
    handle, _ctx = mgr._active[job.id]
    await mgr.system._force_abort(handle.task.id)
    report = await mgr.wait(job.id)
    assert report.status == JobStatus.CANCELED
    settled = [e for e in events.JOB_EVENTS.snapshot()
               if e["type"] == "settled" and e["fields"]["id"] == str(job.id)]
    assert settled and settled[-1]["fields"]["status"] == "CANCELED"
    marks = [(p["job"], p["event"], p.get("status")) for p in attrib.recent_passes()
             if p["trace_id"] == job.trace_ctx.trace_id]
    assert marks == [("hang_job", "started", None), ("hang_job", "settled", "CANCELED")]
    await mgr.system.shutdown()
    library.close()
