"""Port twins of tests/test_serve.py: the serve layer of
`spacedrive_tpu_torch/serve/` — admission gate, read-path cache,
brownout serving, write-combined ingest — case for case, plus its
tables and scripted traces held to the JAX package's.

- gate semantics: budgets, FIFO slot handoff, queue-deadline shed,
  protected classes, brownout hysteresis (an injected clock: no
  sleeps), ``SD_SERVE_GATE=0`` no-op; the same admission script gives
  JAX's snapshots;
- cache correctness: read-your-writes after a local mutation and after
  a sync-applied op (two port Nodes on the loopback duplex),
  stale-while-revalidate strictly in brownout, single-flight collapse
  under a 100-waiter stampede, LRU/weight bounds, failure propagation
  (TTLs on an injected clock); the same cache script gives JAX's states;
- overload: a budget and queue made full on purpose, then requests
  against the real HTTP surface shed 429 with ``Retry-After`` at once
  while ``/health`` (control) answers and ``/metrics`` counts the sheds;
- ``SD_SERVE_GATE=0`` golden: the same data dir re-served ungated
  answers byte-identically, without ``X-SD-Cache``;
- batched vs per-file ``apply_cas_results`` linking and write-combined
  ingest parity (JAX's ``journal.consult_many`` comes with the mesh
  identify, ROADMAP queue 1 entries 5 and 8).

Every async case runs under its own timeout; Nodes run on the CPU and
bind 127.0.0.1.
"""

import asyncio
import functools
import os
import time
import uuid

import pytest

from spacedrive_tpu_torch import telemetry
from spacedrive_tpu_torch.serve import ServeRuntime, Shed
from spacedrive_tpu_torch.serve.cache import ReadCache
from spacedrive_tpu_torch.serve.gate import AdmissionGate
from spacedrive_tpu_torch.serve.policy import ClassBudget, ServePolicy
from spacedrive_tpu_torch.telemetry import counter_value, gauge_value
from spacedrive_tpu_torch.telemetry.events import SERVE_EVENTS
from spacedrive_tpu_torch.utils import http


def _bounded(seconds: float = 60.0):
    """Run the coroutine test under its own timeout."""
    def deco(fn):
        @functools.wraps(fn)
        async def wrapper(*a, **k):
            async with asyncio.timeout(seconds):
                return await fn(*a, **k)
        return wrapper
    return deco


class _Clock:
    """An injected monotonic clock the test moves by hand."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _tight_policy(**over) -> ServePolicy:
    """A policy small enough to saturate deterministically in-test."""
    pol = ServePolicy(budgets={
        "control": ClassBudget(max_inflight=64, sheddable=False),
        "sync": ClassBudget(max_inflight=32, sheddable=False),
        "interactive": ClassBudget(
            max_inflight=2, max_queue=2, queue_deadline_s=0.2),
        "background": ClassBudget(
            max_inflight=1, max_queue=1, queue_deadline_s=0.1),
    })
    for k, v in over.items():
        setattr(pol, k, v)
    return pol


async def _hold(gate: AdmissionGate, klass: str, release: asyncio.Event,
                entered: asyncio.Event):
    async with gate.admit(klass):
        entered.set()
        await release.wait()


# --- admission gate ---------------------------------------------------------


@pytest.mark.asyncio
@_bounded()
async def test_gate_budget_queue_then_shed():
    telemetry.reset()
    gate = AdmissionGate(_tight_policy())
    release = asyncio.Event()
    entered = [asyncio.Event() for _ in range(2)]
    holders = [asyncio.ensure_future(_hold(gate, "interactive", release, e))
               for e in entered]
    for e in entered:
        await e.wait()
    assert gate.inflight["interactive"] == 2

    # budget full, queue empty: the next request parks...
    q1 = asyncio.ensure_future(_hold(gate, "interactive", release,
                                     asyncio.Event()))
    await asyncio.sleep(0.01)
    assert counter_value("sd_gate_requests_total",
                         klass="interactive", outcome="queued") == 1
    # ...and a queued waiter on a full budget IS the saturation signal:
    # everything offered past it fast-fails instead of parking deeper
    with pytest.raises(Shed) as exc:
        async with gate.admit("interactive"):
            pass
    assert "brownout" in exc.value.reason
    assert exc.value.retry_after_s > 0
    assert counter_value("sd_gate_requests_total",
                         klass="interactive", outcome="shed") == 1
    sheds = [e for e in SERVE_EVENTS.snapshot() if e["type"] == "shed"]
    assert sheds and sheds[-1]["fields"]["reason"]

    # releasing the holders hands their slots to the queued waiter
    release.set()
    await asyncio.gather(*holders, q1)
    assert gate.inflight["interactive"] == 0
    assert counter_value("sd_gate_requests_total",
                         klass="interactive", outcome="admitted") == 3
    telemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_gate_queueless_class_sheds_queue_full():
    telemetry.reset()
    pol = _tight_policy()
    pol.budgets["background"] = ClassBudget(
        max_inflight=1, max_queue=0, queue_deadline_s=0.0)
    gate = AdmissionGate(pol)
    release = asyncio.Event()
    entered = asyncio.Event()
    holder = asyncio.ensure_future(
        _hold(gate, "background", release, entered))
    await entered.wait()
    with pytest.raises(Shed) as exc:
        async with gate.admit("background"):
            pass
    assert "queue full" in exc.value.reason
    release.set()
    await holder
    telemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_gate_queue_deadline_sheds():
    telemetry.reset()
    pol = _tight_policy()
    pol.budgets["interactive"] = ClassBudget(
        max_inflight=1, max_queue=4, queue_deadline_s=0.05)
    gate = AdmissionGate(pol)
    release = asyncio.Event()
    entered = asyncio.Event()
    holder = asyncio.ensure_future(
        _hold(gate, "interactive", release, entered))
    await entered.wait()
    t0 = time.monotonic()
    with pytest.raises(Shed) as exc:
        async with gate.admit("interactive"):
            pass
    assert "deadline" in exc.value.reason
    assert time.monotonic() - t0 < 1.0  # shed fast, not after 30 s
    release.set()
    await holder
    telemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_gate_protected_classes_never_queue_or_shed():
    telemetry.reset()
    pol = _tight_policy()
    pol.budgets["sync"] = ClassBudget(max_inflight=2, sheddable=False)
    gate = AdmissionGate(pol)
    release = asyncio.Event()
    entered = [asyncio.Event() for _ in range(10)]
    # 10 concurrent sync holds against a budget of 2: all run anyway
    holders = [asyncio.ensure_future(_hold(gate, "sync", release, e))
               for e in entered]
    for e in entered:
        await asyncio.wait_for(e.wait(), 2.0)
    assert gate.inflight["sync"] == 10  # counted (observability)...
    assert gate.shed["sync"] == 0      # ...but never refused
    release.set()
    await asyncio.gather(*holders)
    telemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_gate_brownout_from_loop_lag_and_hysteresis():
    from spacedrive_tpu_torch.telemetry import metrics

    telemetry.reset()
    pol = _tight_policy(brownout_hold_s=0.2)
    clock = _Clock()
    gate = AdmissionGate(pol, clock=clock)
    assert not gate.in_brownout()
    metrics.EVENT_LOOP_LAG.set(pol.brownout_loop_lag_s + 0.1)
    assert gate.in_brownout()
    assert gauge_value("sd_gate_mode") == 1.0
    modes = [e for e in SERVE_EVENTS.snapshot() if e["type"] == "mode"]
    assert modes and modes[-1]["fields"]["mode"] == "brownout"

    # hysteresis: lag back to 0, brownout persists for the hold window
    metrics.EVENT_LOOP_LAG.set(0.0)
    assert gate.in_brownout()
    clock.advance(pol.brownout_hold_s - 0.01)
    assert gate.in_brownout()  # still inside the hold
    clock.advance(0.02)
    assert not gate.in_brownout()
    assert gauge_value("sd_gate_mode") == 0.0
    telemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_gate_brownout_saturated_fast_fails_instead_of_queueing():
    telemetry.reset()
    gate = AdmissionGate(_tight_policy())
    gate._note_shed()  # the hold a real shed/lag spike would install
    release = asyncio.Event()
    entered = [asyncio.Event() for _ in range(2)]
    holders = [asyncio.ensure_future(_hold(gate, "interactive", release, e))
               for e in entered]
    for e in entered:
        await e.wait()
    with pytest.raises(Shed) as exc:
        async with gate.admit("interactive"):
            pass
    # queue had room (max_queue=2, empty) — brownout refuses to park:
    # nothing was queued, the shed came without a wait
    assert "brownout" in exc.value.reason
    assert len(gate._queues["interactive"]) == 0
    assert counter_value("sd_gate_requests_total",
                         klass="interactive", outcome="queued") == 0
    release.set()
    await asyncio.gather(*holders)
    telemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_gate_cancelled_waiter_does_not_leak_slot():
    """A client disconnect while parked must release (or never take)
    the slot — four leaked disconnects used to wedge the whole
    interactive class forever."""
    telemetry.reset()
    pol = _tight_policy()
    pol.budgets["interactive"] = ClassBudget(
        max_inflight=1, max_queue=4, queue_deadline_s=5.0)
    gate = AdmissionGate(pol)
    release = asyncio.Event()
    entered = asyncio.Event()
    holder = asyncio.ensure_future(
        _hold(gate, "interactive", release, entered))
    await entered.wait()
    # cancel while still parked (future pending)
    parked = asyncio.ensure_future(
        _hold(gate, "interactive", release, asyncio.Event()))
    await asyncio.sleep(0.01)
    parked.cancel()
    with pytest.raises(asyncio.CancelledError):
        await parked
    assert len(gate._queues["interactive"]) == 0  # waiter removed
    release.set()
    await holder
    assert gate.inflight["interactive"] == 0

    # cancel in the same tick the slot is granted: the reservation the
    # releaser made on our behalf must pass to the next waiter
    release = asyncio.Event()
    entered = asyncio.Event()
    holder = asyncio.ensure_future(
        _hold(gate, "interactive", release, entered))
    await entered.wait()
    doomed = asyncio.ensure_future(
        _hold(gate, "interactive", release, asyncio.Event()))
    live_entered = asyncio.Event()
    live = asyncio.ensure_future(
        _hold(gate, "interactive", release, live_entered))
    await asyncio.sleep(0.01)
    release.set()      # holder releases → grants doomed's future...
    doomed.cancel()    # ...in the same tick doomed is cancelled
    with pytest.raises(asyncio.CancelledError):
        await doomed
    await asyncio.wait_for(live_entered.wait(), 2.0)  # live inherited it
    await live
    await holder
    assert gate.inflight["interactive"] == 0
    # the class still works afterwards — no permanent budget loss
    async with gate.admit("interactive"):
        assert gate.inflight["interactive"] == 1
    telemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_gate_failing_bookkeeping_does_not_leak_slot(monkeypatch):
    """Regression (sdlint SD016): the admission bookkeeping (admitted
    counter, gate metrics, queue-wait observation) used to run between
    taking the slot and entering the try/finally — a raising metric
    registry permanently shrank the class budget by one slot per
    failure."""
    telemetry.reset()
    from spacedrive_tpu_torch.serve import gate as gate_mod

    gate = AdmissionGate(_tight_policy())

    class Boom:
        def inc(self, *a, **k):
            raise RuntimeError("metric registry exploded")

    monkeypatch.setattr(gate_mod._tm, "GATE_REQUESTS", Boom())
    for _ in range(3):  # repeated failures must not erode the budget
        with pytest.raises(RuntimeError):
            async with gate.admit("interactive"):
                pass
        assert gate.inflight["interactive"] == 0
    monkeypatch.undo()
    # the class still works at full budget afterwards
    async with gate.admit("interactive"):
        assert gate.inflight["interactive"] == 1
    assert gate.inflight["interactive"] == 0

    # QUEUED path: the queued-outcome metric raising must not leave an
    # orphan waiter behind — _grant_next would hand it a slot nobody
    # consumes, permanently shrinking the budget
    class BoomQueued:
        def inc(self, *a, **k):
            if k.get("outcome") == "queued":
                raise RuntimeError("metric registry exploded")

    pol = _tight_policy()
    pol.budgets["interactive"] = ClassBudget(
        max_inflight=1, max_queue=4, queue_deadline_s=5.0)
    gate = AdmissionGate(pol)
    release = asyncio.Event()
    entered = asyncio.Event()
    holder = asyncio.ensure_future(
        _hold(gate, "interactive", release, entered))
    await entered.wait()
    monkeypatch.setattr(gate_mod._tm, "GATE_REQUESTS", BoomQueued())
    with pytest.raises(RuntimeError):
        async with gate.admit("interactive"):
            pass
    assert len(gate._queues["interactive"]) == 0   # no orphan waiter
    monkeypatch.undo()
    release.set()
    await holder
    assert gate.inflight["interactive"] == 0       # budget intact
    async with gate.admit("interactive"):
        assert gate.inflight["interactive"] == 1
    telemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_gate_unknown_class_degrades_to_background():
    telemetry.reset()
    gate = AdmissionGate(_tight_policy())
    # a mistyped priority= must gate as background, not KeyError → 500
    async with gate.admit("interactiv"):
        assert gate.inflight["background"] == 1
    assert gate.inflight["background"] == 0
    assert gate.admitted["background"] == 1
    telemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_gate_disabled_is_a_no_op(monkeypatch):
    telemetry.reset()
    monkeypatch.setenv("SD_SERVE_GATE", "0")
    gate = AdmissionGate(_tight_policy())
    # way past every budget: nothing counts, nothing sheds
    async with gate.admit("interactive"):
        async with gate.admit("interactive"):
            async with gate.admit("interactive"):
                assert gate.inflight["interactive"] == 0
    assert gate.admitted["interactive"] == 0
    assert counter_value("sd_gate_requests_total",
                         klass="interactive", outcome="admitted") == 0
    telemetry.reset()


def test_health_serve_verdict():
    import types

    from spacedrive_tpu_torch.telemetry import health

    telemetry.reset()
    # no runtime → unknown (counts healthy in the rollup)
    assert health._serve(None)["status"] == health.UNKNOWN

    node = types.SimpleNamespace(serve=ServeRuntime(_tight_policy()))
    assert health._serve(node)["status"] == health.HEALTHY

    node.serve.gate._note_shed()  # brownout hold → degraded
    assert health._serve(node)["status"] == health.DEGRADED

    # a protected-class shed is a serve-layer BUG: unhealthy
    node.serve.gate.shed["control"] = 1
    v = health._serve(node)
    assert v["status"] == health.UNHEALTHY
    assert "never shed" in v["reason"]
    # and it rides the full rollup as the `serve` subsystem
    full = health.evaluate(node)
    assert full["subsystems"]["serve"]["status"] == health.UNHEALTHY
    telemetry.reset()


# --- read cache -------------------------------------------------------------


@pytest.mark.asyncio
@_bounded()
async def test_cache_hit_miss_ttl_and_len():
    clock = _Clock()
    cache = ReadCache("query", default_ttl_s=0.05, clock=clock)
    calls = []

    async def loader():
        calls.append(1)
        return {"rows": len(calls)}

    r1 = await cache.get(("k",), loader)
    assert (r1.state, r1.value) == ("miss", {"rows": 1})
    r2 = await cache.get(("k",), loader)
    assert (r2.state, r2.value) == ("hit", {"rows": 1})
    assert len(cache) == 1
    clock.advance(0.06)  # past TTL, not in brownout → fresh load
    r3 = await cache.get(("k",), loader)
    assert (r3.state, r3.value) == ("miss", {"rows": 2})
    assert len(calls) == 2


@pytest.mark.asyncio
@_bounded()
async def test_cache_single_flight_collapses_100_waiter_stampede():
    telemetry.reset()
    cache = ReadCache("query")
    calls = []
    gate_open = asyncio.Event()

    async def loader():
        calls.append(1)
        await gate_open.wait()
        return "hot-directory-listing"

    waiters = [asyncio.ensure_future(cache.get(("hot",), loader))
               for _ in range(100)]
    await asyncio.sleep(0.02)  # everyone reaches the in-flight check
    gate_open.set()
    results = await asyncio.gather(*waiters)
    assert len(calls) == 1, "stampede must cost ONE loader run"
    assert all(r.value == "hot-directory-listing" for r in results)
    states = {r.state for r in results}
    assert states == {"miss", "coalesced"}
    assert counter_value("sd_serve_cache_ops_total",
                         cache="query", result="coalesced") == 99
    telemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_cache_stale_while_revalidate_only_when_stale_ok():
    clock = _Clock()
    cache = ReadCache("query", default_ttl_s=0.06, stale_max_s=60.0, clock=clock)
    value = ["v1"]

    async def loader():
        return list(value)

    assert (await cache.get(("k",), loader)).value == ["v1"]
    value[0] = "v2"
    clock.advance(0.08)  # entry is now expired

    # stale_ok (brownout): the OLD answer comes back immediately,
    # stamped stale, while a single-flight refresh runs behind it
    r = await cache.get(("k",), loader, stale_ok=True)
    assert (r.state, r.value) == ("stale", ["v1"])
    assert r.age_s > 0.06
    await asyncio.gather(*cache._refreshes)  # the background refresh lands
    r = await cache.get(("k",), loader, stale_ok=True)
    assert (r.state, r.value) == ("hit", ["v2"])

    # NOT stale_ok (normal mode): an expired entry always loads fresh
    value[0] = "v3"
    clock.advance(0.08)
    r = await cache.get(("k",), loader, stale_ok=False)
    assert (r.state, r.value) == ("miss", ["v3"])

    # and past stale_max_s even brownout refuses to serve it
    tight = ReadCache("query", default_ttl_s=0.01, stale_max_s=0.01, clock=clock)
    await tight.get(("k",), loader)
    clock.advance(0.03)
    assert (await tight.get(("k",), loader, stale_ok=True)).state == "miss"


@pytest.mark.asyncio
@_bounded()
async def test_cache_lru_entry_and_weight_bounds():
    cache = ReadCache("thumb", max_entries=100, max_weight=1000)

    async def webp(n):
        return b"x" * n

    for i in range(4):
        await cache.get((i,), lambda i=i: webp(300), weigh=len)
    # 4×300 = 1200 > 1000: the oldest-used entry went
    assert len(cache) == 3
    assert (0,) not in cache._entries
    # touching (1,) promotes it; the next overflow evicts (2,)
    await cache.get((1,), lambda: webp(300), weigh=len)
    await cache.get((9,), lambda: webp(300), weigh=len)
    assert (2,) not in cache._entries and (1,) in cache._entries

    small = ReadCache("query", max_entries=2)

    async def v():
        return 1

    for i in range(3):
        await small.get((i,), v)
    assert len(small) == 2 and (0,) not in small._entries


@pytest.mark.asyncio
@_bounded()
async def test_cache_tag_invalidation_and_source_labels():
    telemetry.reset()
    cache = ReadCache("query")

    async def v():
        return "x"

    lib = ("lib", "L1")
    await cache.get(("a",), v, tags=(lib, ("q", "tags.list", "L1")))
    await cache.get(("b",), v, tags=(lib,))
    await cache.get(("c",), v, tags=(("lib", "L2"),))
    assert cache.invalidate_tag(lib, source="sync") == 2
    assert len(cache) == 1  # L2 untouched
    assert counter_value("sd_serve_cache_invalidations_total",
                         source="sync") == 2
    assert cache.invalidate_tag(lib) == 0  # idempotent, not re-counted
    cache.invalidate_key(("c",), source="local")
    assert counter_value("sd_serve_cache_invalidations_total",
                         source="local") == 1
    telemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_cache_invalidation_mid_load_prevents_stale_store():
    """A load that STARTED before a mutation's invalidation must not
    store its (pre-mutation) result after it — the load/invalidate
    race that used to serve a just-written library its own pre-image
    for a full TTL."""
    cache = ReadCache("query")
    gate_open = asyncio.Event()
    calls = []

    async def loader():
        calls.append(1)
        await gate_open.wait()
        return f"v{len(calls)}"

    t = asyncio.ensure_future(
        cache.get(("k",), loader, tags=(("lib", "L"),)))
    await asyncio.sleep(0.01)
    # the mutation lands while the load is in flight (note: nothing is
    # stored yet — the epoch, not the tag index, must catch this)
    cache.invalidate_tag(("lib", "L"))
    gate_open.set()
    r = await t
    assert r.value == "v1"   # the in-flight caller still gets its read
    assert len(cache) == 0   # ...but the stale result was NOT stored
    r2 = await cache.get(("k",), loader, tags=(("lib", "L"),))
    assert (r2.state, r2.value) == ("miss", "v2")  # fresh load


@pytest.mark.asyncio
@_bounded()
async def test_node_scoped_invalidation_clears_query_cache():
    rt = ServeRuntime(_tight_policy())

    async def v():
        return 1

    await rt.queries.get(("a",), v, tags=(("lib", "x"),))
    await rt.queries.get(("b",), v, tags=(("lib", "y"),))
    # a node-scoped mutation (library create/delete) dirties reads no
    # library tag covers: the whole query cache drops
    assert rt.invalidate_query("library.list", None) == 2
    assert len(rt.queries) == 0


@pytest.mark.asyncio
@_bounded()
async def test_cache_loader_failure_propagates_and_caches_nothing():
    cache = ReadCache("query")
    gate_open = asyncio.Event()
    calls = []

    async def boom():
        calls.append(1)
        await gate_open.wait()
        raise RuntimeError("db on fire")

    first = asyncio.ensure_future(cache.get(("k",), boom))
    await asyncio.sleep(0.01)
    rider = asyncio.ensure_future(cache.get(("k",), boom))
    await asyncio.sleep(0.01)
    gate_open.set()
    for fut in (first, rider):
        with pytest.raises(RuntimeError):
            await fut
    assert len(calls) == 1  # the rider coalesced onto the failing load
    assert len(cache) == 0

    async def ok():
        return "recovered"

    # the failure was not retained: the next read loads clean
    gate_open.set()
    assert (await cache.get(("k",), ok)).value == "recovered"


# --- node integration: read-your-writes + brownout + golden -----------------


def _make_corpus(tmp_path, n=6) -> str:
    d = tmp_path / "corpus"
    d.mkdir()
    for i in range(n):
        (d / f"file{i:02d}.txt").write_bytes(b"sd" * (50 + i))
    return str(d)


async def _scanned_node(tmp_path, corpus, name="serve-lib"):
    from spacedrive_tpu_torch.location.locations import LocationCreateArgs, scan_location
    from spacedrive_tpu_torch.node.node import Node

    node = Node(os.path.join(tmp_path, "node"), device="cpu",
                with_labeler=False)
    node.config.config.p2p.enabled = False
    await node.start()
    lib = await node.create_library(name)
    loc = LocationCreateArgs(path=corpus, name="corpus").create(lib)
    await scan_location(lib, loc, node.jobs, backend="cpu")
    await node.jobs.wait_idle()
    return node, lib, loc


@pytest.mark.asyncio
@_bounded()
async def test_read_your_writes_after_local_mutation(tmp_path):
    telemetry.reset()
    node, lib, _loc = await _scanned_node(tmp_path, _make_corpus(tmp_path))
    try:
        assert node.serve is not None
        # long TTL: if the answer changes below, it is the invalidation
        # plane working, not TTL expiry racing the assertion
        node.serve.queries.default_ttl_s = 300.0
        lid = str(lib.id)
        r1 = await node.router.exec(node, "tags.list", None, lid)
        assert r1["nodes"] == []
        r2 = await node.router.exec(node, "tags.list", None, lid)
        assert r2 == r1
        assert counter_value("sd_serve_cache_ops_total",
                             cache="query", result="hit") >= 1
        await node.router.exec(node, "tags.create",
                               {"name": "urgent", "color": "#f00"}, lid)
        r3 = await node.router.exec(node, "tags.list", None, lid)
        assert [n["name"] for n in r3["nodes"]] == ["urgent"]
        assert counter_value("sd_serve_cache_invalidations_total",
                             source="local") >= 1
        # non-canonical library-id spellings must land on the SAME
        # invalidation tag (a raw-spelling tag would cache pre-images
        # that read-your-writes can never drop)
        loud = lid.upper()
        r4 = await node.router.exec(node, "tags.list", None, loud)
        assert [n["name"] for n in r4["nodes"]] == ["urgent"]
        await node.router.exec(node, "tags.create", {"name": "two"}, loud)
        r5 = await node.router.exec(node, "tags.list", None, loud)
        assert sorted(n["name"] for n in r5["nodes"]) == ["two", "urgent"]
    finally:
        await node.shutdown()
        telemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_http_cache_headers_and_read_your_writes(tmp_path):
    telemetry.reset()
    node, lib, _loc = await _scanned_node(tmp_path, _make_corpus(tmp_path))
    client = http.HttpClient()
    try:
        node.serve.queries.default_ttl_s = 300.0
        port = await node.start_api()
        base = f"http://127.0.0.1:{port}"
        lid = str(lib.id)

        async def post(key, arg=None):
            r = await client.request("POST", f"{base}/rspc/{key}",
                                     json={"library_id": lid, "arg": arg})
            return r.status, r.headers.get("X-SD-Cache"), r.json()

        st, state, body = await post("tags.list")
        assert (st, state) == (200, "miss")
        st, state, body1 = await post("tags.list")
        assert (st, state) == (200, "hit")
        st, _state, _ = await post("tags.create", {"name": "t1"})
        assert st == 200
        st, state, body2 = await post("tags.list")
        assert (st, state) == (200, "miss")  # invalidated, not stale
        assert [n["name"] for n in body2["result"]["nodes"]] == ["t1"]
        # control surface rides the gate too (admitted, never shed)
        r = await client.request("GET", f"{base}/health")
        assert r.status in (200, 503)
        # regex-param routes resolve through the admission middleware
        # too (their canonical path drops the `{path:.*}` regex)
        before = counter_value("sd_gate_requests_total",
                               klass="interactive", outcome="admitted")
        r = await client.request("GET", f"{base}/static/nope.js")
        assert r.status in (200, 404)
        assert counter_value(
            "sd_gate_requests_total",
            klass="interactive", outcome="admitted") == before + 1
        assert counter_value("sd_gate_requests_total",
                             klass="control", outcome="admitted") >= 1
        assert counter_value("sd_gate_requests_total",
                             klass="control", outcome="shed") == 0
    finally:
        await client.close()
        await node.shutdown()
        telemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_read_your_writes_after_sync_applied_op(tmp_path):
    """Two REAL nodes on the loopback duplex: a tag created on A must
    show up through B's CACHED read path once B's ingest applies the
    ops — the sync half of cache invalidation."""
    from spacedrive_tpu_torch.p2p.loopback import make_mesh_pair

    telemetry.reset()
    a, b, lib_a, lib_b, _tasks = await make_mesh_pair(tmp_path)
    try:
        assert b.serve is not None
        # a TTL long enough that only invalidation can change the answer
        b.serve.queries.default_ttl_s = 300.0
        lid = str(lib_a.id)
        warm = await b.router.exec(b, "tags.list", None, lid)
        assert warm["nodes"] == []
        await a.router.exec(a, "tags.create",
                            {"name": "from-a", "color": "#0f0"}, lid)

        names: list = []
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            actor = getattr(lib_b, "ingest", None)
            if actor is not None:
                actor.notify()
            await asyncio.sleep(0.1)
            got = await b.router.exec(b, "tags.list", None, lid)
            names = [n["name"] for n in got["nodes"]]
            if names:
                break
        assert names == ["from-a"]
        assert counter_value("sd_serve_cache_invalidations_total",
                             source="sync") >= 1
    finally:
        await a.shutdown()
        await b.shutdown()
        telemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_brownout_serves_stale_normal_mode_does_not(tmp_path):
    """SWR at the router level: a write that BYPASSES the invalidation
    plane (direct SQL) is invisible while brownout serves the expired
    entry, and visible the moment the mode clears."""
    telemetry.reset()
    node, lib, _loc = await _scanned_node(tmp_path, _make_corpus(tmp_path))
    try:
        lid = str(lib.id)
        warm = await node.router.exec(node, "tags.list", None, lid)
        assert warm["nodes"] == []
        # bypass the mutation plane entirely: no invalidate_query fires
        lib.db.insert("tag", pub_id=os.urandom(16), name="sneaky",
                      date_created="2026-01-01T00:00:00Z")
        # age the entry past TTL but inside the stale-serve window, and
        # hold the gate in brownout (the mechanism a real shed uses)
        for entry in node.serve.queries._entries.values():
            entry.stored_at -= 10.0
        node.serve.gate._note_shed()
        assert node.serve.gate.in_brownout()
        r = await node.router.exec(node, "tags.list", None, lid)
        assert r["nodes"] == [], "brownout must serve the stale answer"
        assert counter_value("sd_serve_cache_ops_total",
                             cache="query", result="stale") >= 1
        # clear brownout; the (refreshed or re-aged) entry now misses
        node.serve.gate._brownout_until = 0.0
        assert not node.serve.gate.in_brownout()
        for entry in node.serve.queries._entries.values():
            entry.stored_at -= 10.0
        deadline = time.monotonic() + 5.0
        names: list = []
        while time.monotonic() < deadline:
            got = await node.router.exec(node, "tags.list", None, lid)
            names = [n["name"] for n in got["nodes"]]
            if names:
                break
            await asyncio.sleep(0.05)
        assert "sneaky" in names
    finally:
        await node.shutdown()
        telemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_serve_gate_0_golden_identical(tmp_path, monkeypatch):
    """The same data dir served gated then ungated: identical rspc
    results and identical HTTP bytes — ``SD_SERVE_GATE=0`` IS the
    ungated path."""
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.sync.ingest import ingest_txn_quantum

    telemetry.reset()
    monkeypatch.delenv("SD_SERVE_GATE", raising=False)
    node, lib, _loc = await _scanned_node(tmp_path, _make_corpus(tmp_path))
    lid = str(lib.id)
    queries = [("buildInfo", None, None),
               ("tags.list", None, lid),
               ("locations.list", None, lid),
               ("search.paths", {"filter": {"search": "file"}, "take": 10},
                lid)]

    async def collect(n):
        out = []
        for key, arg, l in queries:
            out.append(await n.router.exec(n, key, arg, l))
        port = await n.start_api()
        client = http.HttpClient()
        try:
            r = await client.request(
                "POST", f"http://127.0.0.1:{port}/rspc/search.paths",
                json={"library_id": lid,
                      "arg": {"filter": {"search": "file"}, "take": 10}})
        finally:
            await client.close()
        out.append((r.status, r.body))
        return out, r.headers.get("X-SD-Cache")

    assert node.serve is not None
    assert ingest_txn_quantum() > 1
    gated, gated_header = await collect(node)
    assert gated_header in ("miss", "hit")
    await node.shutdown()

    monkeypatch.setenv("SD_SERVE_GATE", "0")
    node2 = Node(os.path.join(tmp_path, "node"), device="cpu",
                 with_labeler=False)
    node2.config.config.p2p.enabled = False
    await node2.start()
    try:
        assert node2.serve is None
        assert ingest_txn_quantum() == 1  # op-per-transaction, as before
        cache_ops_before = {
            r: counter_value("sd_serve_cache_ops_total",
                             cache="query", result=r)
            for r in ("hit", "miss", "stale", "coalesced")}
        gate_before = counter_value("sd_gate_requests_total",
                                    klass="interactive", outcome="admitted")
        ungated, ungated_header = await collect(node2)
        assert ungated_header is None  # no serve layer touched the bytes
        assert ungated == gated
        # and nothing was counted: the serve layer was never consulted
        assert {
            r: counter_value("sd_serve_cache_ops_total",
                             cache="query", result=r)
            for r in ("hit", "miss", "stale", "coalesced")
        } == cache_ops_before
        assert counter_value("sd_gate_requests_total",
                             klass="interactive",
                             outcome="admitted") == gate_before
    finally:
        await node2.shutdown()
        telemetry.reset()


# --- overload: a budget made full on purpose ---------------------------------


@pytest.mark.asyncio
@_bounded()
async def test_overload_chaos_sheds_fast_and_protects_health(tmp_path):
    """The interactive budget and its queue are filled on purpose (held
    slots, parked waiters): every further cache-cold read over HTTP
    fast-fails 429 with Retry-After, without queueing; the control class
    (the /health prober a balancer depends on, the /metrics scrape) is
    never shed and answers during the burst; once the holders release,
    the admitted stream flows again."""
    telemetry.reset()
    node, lib, _loc = await _scanned_node(tmp_path, _make_corpus(tmp_path))
    client = http.HttpClient()
    release = asyncio.Event()
    try:
        gate = node.serve.gate
        # this node's own policy: the default's budgets, with a queue
        # deadline long enough that the parked waiters stay parked
        gate._policy = ServePolicy(brownout_loop_lag_s=float("inf"))
        gate._brownout_until = 0.0  # a hold the scan's loop lag left
        budget = gate.policy.budgets["interactive"]
        budget.queue_deadline_s = 60.0
        port = await node.start_api()
        base = f"http://127.0.0.1:{port}"
        lid = str(lib.id)
        entered = [asyncio.Event() for _ in range(budget.max_inflight)]
        holders = [asyncio.ensure_future(_hold(gate, "interactive", release, e))
                   for e in entered]
        for e in entered:
            await e.wait()
        # half the queue parked with the budget full is the gate's own
        # saturation signal: from here it fast-fails (brownout)
        depth = max(1, budget.max_queue // 2)
        parked = [asyncio.ensure_future(_hold(gate, "interactive", release,
                                              asyncio.Event()))
                  for _ in range(depth)]
        while len(gate._queues["interactive"]) < depth:
            await asyncio.sleep(0)
        shed_before = gate.shed["interactive"]

        statuses, retry_after = [], set()
        for i in range(24):
            # distinct args: cache-cold, each needs an admission slot
            arg = {"filter": {"search": f"file{i}"}, "take": 10}
            r = await client.request("POST", f"{base}/rspc/search.paths",
                                     json={"library_id": lid, "arg": arg})
            statuses.append(r.status)
            retry_after.add(r.headers.get("Retry-After"))
            assert r.json()["error"].startswith("SHED")
            h = await client.request("GET", f"{base}/health")
            assert h.status in (200, 503) and h.status != 429
        assert statuses == [429] * 24
        assert retry_after == {"1"}
        assert gate.shed["interactive"] - shed_before == 24
        assert len(gate._queues["interactive"]) == depth  # none parked more
        metrics = (await client.request("GET", f"{base}/metrics")).text()
        assert 'sd_gate_requests_total{klass="interactive",outcome="shed"} 24' in metrics
        snap = gate.snapshot()["classes"]
        assert snap["control"]["shed_total"] == 0
        assert snap["sync"]["shed_total"] == 0
        ring = [e for e in SERVE_EVENTS.snapshot() if e["type"] == "shed"]
        assert len(ring) >= 24 and all(e["fields"]["reason"] for e in ring)

        release.set()
        await asyncio.gather(*holders, *parked)
        gate._brownout_until = 0.0
        r = await client.request("POST", f"{base}/rspc/search.paths",
                                 json={"library_id": lid,
                                       "arg": {"filter": {"search": "file"}}})
        assert r.status == 200 and r.headers.get("X-SD-Cache") == "miss"
    finally:
        release.set()
        await client.close()
        await node.shutdown()
        telemetry.reset()


# --- batched linking and write-combined ingest ------------------------------


class _SyncInstance:
    """Minimal in-process sync instance (the sync-suite harness)."""

    def __init__(self, name: str):
        from spacedrive_tpu_torch.db import LibraryDb
        from spacedrive_tpu_torch.db.database import now_iso
        from spacedrive_tpu_torch.sync.manager import SyncManager

        self.id = uuid.uuid4()
        self.db = LibraryDb(None, memory=True)
        now = now_iso()
        self.db.insert(
            "instance", pub_id=self.id.bytes, identity=b"", node_id=b"",
            node_name=name, node_platform=0, last_seen=now,
            date_created=now,
        )
        self.sync = SyncManager(self.db, self.id)


def _seed_file_paths(inst: _SyncInstance, pubs: list[bytes]) -> None:
    for i, pub in enumerate(pubs):
        inst.db.insert("file_path", pub_id=pub, name=f"f{i}",
                       extension="bin", is_dir=0)


def test_apply_cas_results_batched_parity(tmp_path):
    """Batched linking (one IN query per table) must produce exactly
    the rows the per-file oracle does — including dedupe topology,
    idempotent re-apply, and garbage tolerance."""
    from spacedrive_tpu_torch.object.file_identifier.link import apply_cas_results

    telemetry.reset()
    pubs = [os.urandom(16) for _ in range(9)]
    results = [
        {"pub_id": pubs[i].hex(),
         # 3 distinct cas values shared across files: dedupe topology
         "cas_id": f"cas-{i % 3}", "ext": "bin"}
        for i in range(8)
    ] + [
        {"pub_id": "zz-not-hex", "cas_id": "cas-9", "ext": "bin"},
        {"pub_id": pubs[8].hex(), "cas_id": None, "ext": "bin"},
    ]

    def state(inst):
        links = {}
        for r in inst.db.query(
            "SELECT fp.pub_id AS fp, fp.cas_id, o.pub_id AS opub "
            "FROM file_path fp LEFT JOIN object o ON o.id = fp.object_id"
        ):
            links[bytes(r["fp"]).hex()] = (
                r["cas_id"],
                bytes(r["opub"]).hex() if r["opub"] is not None else None,
            )
        objs = {bytes(r["pub_id"]).hex(): r["kind"]
                for r in inst.db.query("SELECT pub_id, kind FROM object")}
        return links, objs

    oracle, batched = _SyncInstance("o"), _SyncInstance("b")
    # same library id → same deterministic object pub_ids on both sides
    batched.id = oracle.id
    for inst in (oracle, batched):
        _seed_file_paths(inst, pubs)
    co, lo = apply_cas_results(oracle, results, batched=False)
    cb, lb = apply_cas_results(batched, results, batched=True)
    assert (co, lo) == (cb, lb) and co == 3 and lo == 8
    assert state(oracle) == state(batched)
    # idempotent: a duplicate completion changes nothing on either path
    assert apply_cas_results(oracle, results, batched=False) == (0, 0)
    assert apply_cas_results(batched, results, batched=True) == (0, 0)
    assert state(oracle) == state(batched)
    telemetry.reset()


# --- write-combined sync ingest (satellite: tentpole part 3) ----------------


def _tag_ops(writer: _SyncInstance, n: int):
    ops = []
    for i in range(n):
        ops.extend(writer.sync.shared_create(
            "tag", uuid.uuid4().bytes.hex(),
            [("name", f"t{i}"), ("color", "#00f")],
        ))
    writer.sync.write_ops(ops)
    return writer.sync.get_ops(count=10_000, clocks={})


def test_ingest_batch_write_combined_parity():
    """Chunked transactions (quantum 16) converge to exactly the rows
    op-per-transaction (quantum 1) produces, and the combined counter
    records the transactions avoided."""
    from spacedrive_tpu_torch.sync.ingest import ingest_batch

    telemetry.reset()
    writer = _SyncInstance("w")
    ops = _tag_ops(writer, 40)
    assert len(ops) >= 80  # create + field sets

    per_op, combined = _SyncInstance("p"), _SyncInstance("c")
    r1 = ingest_batch(per_op.sync, list(ops), txn_ops=1)
    before = counter_value("sd_sync_txn_combined_total")
    r2 = ingest_batch(combined.sync, list(ops), txn_ops=16)
    assert r1 == r2 and all(r1)
    assert counter_value("sd_sync_txn_combined_total") - before >= \
        len(ops) - (len(ops) + 15) // 16

    def tags(inst):
        return {r["pub_id"].hex() if isinstance(r["pub_id"], bytes)
                else r["pub_id"]: (r["name"], r["color"])
                for r in inst.db.find("tag")}

    assert tags(per_op) == tags(combined)
    assert len(tags(combined)) == 40
    # watermarks advanced identically (finalized post-commit)
    assert per_op.sync.timestamps == combined.sync.timestamps
    telemetry.reset()


def test_ingest_batch_guarded_op_does_not_poison_chunk():
    """A delta-guarded (far-future) op inside a combined chunk is
    rejected alone; its neighbors still apply and the watermark never
    advances past the guard."""
    from spacedrive_tpu_torch.sync.crdt import CRDTOperation, CRDTOperationData
    from spacedrive_tpu_torch.sync.hlc import NTP64
    from spacedrive_tpu_torch.sync.ingest import ingest_batch

    telemetry.reset()
    writer = _SyncInstance("w")
    ops = _tag_ops(writer, 6)
    poison = CRDTOperation(
        instance=writer.id,
        timestamp=NTP64.from_unix(time.time() + 3600),
        id=uuid.uuid4(), model="tag",
        record_id=uuid.uuid4().bytes.hex(),
        data=CRDTOperationData.create(),
    )
    mixed = ops[:3] + [poison] + ops[3:]
    receiver = _SyncInstance("r")
    results = ingest_batch(receiver.sync, mixed, txn_ops=len(mixed))
    assert results == [True] * 3 + [False] + [True] * (len(ops) - 3)
    assert counter_value("sd_hlc_delta_guard_total") == 1
    assert len(receiver.db.find("tag")) == 6
    assert receiver.sync.timestamps.get(writer.id, NTP64(0)) < \
        poison.timestamp
    telemetry.reset()


# --- federation single-flight (satellite 2) ---------------------------------


@pytest.mark.asyncio
@_bounded()
async def test_mesh_status_single_flight_collapses_dashboards(tmp_path):
    """N concurrent /mesh-shaped reads cost ONE mesh_status computation
    per TTL window (the read-amplification fix)."""
    from spacedrive_tpu_torch.telemetry import federation

    telemetry.reset()
    node, _lib, _loc = await _scanned_node(tmp_path, _make_corpus(tmp_path))
    try:
        calls = []
        real = federation.mesh_status

        def counting(n):
            calls.append(1)
            return real(n)

        federation.mesh_status = counting
        try:
            docs = await asyncio.gather(*(
                federation.mesh_status_cached(node) for _ in range(25)))
        finally:
            federation.mesh_status = real
        assert len(calls) == 1, "25 dashboards must cost one computation"
        assert all(d["local"]["node"]["id"] == docs[0]["local"]["node"]["id"]
                   for d in docs)
        # local_snapshot's sync TTL cache: polls inside the window are
        # one walk (the object IS the cached one)
        s1 = federation.local_snapshot(node)
        s2 = federation.local_snapshot(node)
        assert s1 is s2
    finally:
        await node.shutdown()
        telemetry.reset()


# --- held to the JAX package -------------------------------------------------


def test_policy_tables_and_classes_equal_jax():
    """The policy's defaults, the namespace map, the cacheable allowlist
    and the class every router procedure resolves to are JAX's."""
    import dataclasses

    import spacedrive_tpu.serve as jserve
    from spacedrive_tpu.api.namespaces import mount as jmount
    from spacedrive_tpu_torch import serve as pserve
    from spacedrive_tpu_torch.api.namespaces import mount as pmount

    assert dataclasses.asdict(pserve.ServePolicy()) == dataclasses.asdict(jserve.ServePolicy())
    assert pserve.policy.__module__.endswith("serve.policy")
    import importlib

    jpol = importlib.import_module("spacedrive_tpu.serve.policy")
    ppol = importlib.import_module("spacedrive_tpu_torch.serve.policy")

    assert ppol.NAMESPACE_CLASSES == jpol.NAMESPACE_CLASSES
    assert ppol.CACHEABLE_QUERIES == jpol.CACHEABLE_QUERIES
    assert ppol.CLASSES == jpol.CLASSES
    jr, pr = jmount(), pmount()
    assert set(pr.procedures) == set(jr.procedures)
    for key, proc in pr.procedures.items():
        want = jr.procedures[key]
        assert proc.priority == want.priority, key
        assert pserve.class_for_key(key, proc.priority) == \
            jserve.class_for_key(key, want.priority), key
    for lid in ("0F8FAD5B-D9CB-469F-A165-70867728950E", "urn:uuid:0f8fad5bd9cb469fa16570867728950e",
                "not-a-uuid", 7):
        assert pserve.canonical_library_id(lid) == jserve.canonical_library_id(lid)
        assert pserve.query_cache_key("search.paths", lid, {"b": 1, "a": [2]}) == \
            jserve.query_cache_key("search.paths", lid, {"b": 1, "a": [2]})


async def _admission_script(gate_cls, shed_cls, policy):
    """One admission script: holds, a queued grant, sheds of each kind;
    returns what an operator reads after each step."""
    gate = gate_cls(policy)
    out = []
    release = asyncio.Event()
    entered = [asyncio.Event() for _ in range(2)]
    holders = [asyncio.ensure_future(_hold(gate, "interactive", release, e)) for e in entered]
    for e in entered:
        await e.wait()
    out.append(gate.snapshot())
    parked = asyncio.ensure_future(_hold(gate, "interactive", release, asyncio.Event()))
    while not gate._queues["interactive"]:
        await asyncio.sleep(0)
    out.append(gate.snapshot())
    for klass in ("interactive", "background", "interactiv"):
        try:
            async with gate.admit(klass):
                out.append(("admitted", klass, gate.snapshot()))
        except shed_cls as e:
            out.append(("shed", e.klass, e.reason, e.retry_after_s))
    async with gate.admit("control"):
        async with gate.admit("sync"):
            out.append(gate.snapshot())
    release.set()
    await asyncio.gather(*holders, parked)
    out.append(gate.snapshot())
    return out


@pytest.mark.asyncio
@_bounded()
async def test_gate_script_snapshots_equal_jax():
    import spacedrive_tpu.telemetry as jtelemetry
    from spacedrive_tpu.serve import Shed as JShed
    from spacedrive_tpu.serve.gate import AdmissionGate as JGate
    from spacedrive_tpu.serve.policy import ClassBudget as JBudget
    from spacedrive_tpu.serve.policy import ServePolicy as JPolicy

    def jpolicy():
        pol = JPolicy(budgets={
            "control": JBudget(max_inflight=64, sheddable=False),
            "sync": JBudget(max_inflight=32, sheddable=False),
            "interactive": JBudget(max_inflight=2, max_queue=2, queue_deadline_s=5.0),
            "background": JBudget(max_inflight=1, max_queue=0, queue_deadline_s=0.0),
        })
        return pol

    pol = _tight_policy()
    pol.budgets["interactive"] = ClassBudget(max_inflight=2, max_queue=2, queue_deadline_s=5.0)
    pol.budgets["background"] = ClassBudget(max_inflight=1, max_queue=0, queue_deadline_s=0.0)
    telemetry.reset()
    jtelemetry.reset()
    try:
        got = await _admission_script(AdmissionGate, Shed, pol)
        want = await _admission_script(JGate, JShed, jpolicy())
        assert got == want
        for klass in ("interactive", "background", "control", "sync"):
            for outcome in ("admitted", "queued", "shed"):
                assert counter_value("sd_gate_requests_total", klass=klass, outcome=outcome) == \
                    jtelemetry.counter_value("sd_gate_requests_total", klass=klass,
                                             outcome=outcome), (klass, outcome)
    finally:
        telemetry.reset()
        jtelemetry.reset()


async def _cache_script(cache_cls, clock_kw):
    cache = cache_cls("query", max_entries=3, default_ttl_s=5.0, stale_max_s=60.0, **clock_kw)
    states = []
    value = [0]

    async def loader():
        value[0] += 1
        return {"v": value[0]}

    for key in ("a", "b", "a", "c", "d", "a", "b"):
        r = await cache.get((key,), loader, tags=(("lib", key),))
        states.append((key, r.state, r.value))
    states.append(cache.invalidate_tag(("lib", "a")))
    states.append(cache.snapshot())
    r = await cache.get(("a",), loader, tags=(("lib", "a"),))
    states.append((r.state, r.value))
    return states


@pytest.mark.asyncio
@_bounded()
async def test_cache_script_states_equal_jax():
    import spacedrive_tpu.telemetry as jtelemetry
    from spacedrive_tpu.serve.cache import ReadCache as JCache

    telemetry.reset()
    jtelemetry.reset()
    try:
        got = await _cache_script(ReadCache, {"clock": _Clock()})
        want = await _cache_script(JCache, {})
        assert got == want
        for result in ("hit", "miss"):
            assert counter_value("sd_serve_cache_ops_total", cache="query", result=result) == \
                jtelemetry.counter_value("sd_serve_cache_ops_total", cache="query",
                                         result=result)
    finally:
        telemetry.reset()
        jtelemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_telemetry_serve_and_health_serve_keys_equal_jax(tmp_path):
    """`telemetry.serve` answers `enabled: true` with JAX's keys, and
    health's `serve` verdict is JAX's, on both packages' idle Nodes."""
    import spacedrive_tpu.telemetry as jtelemetry
    from spacedrive_tpu.node import Node as JNode
    from spacedrive_tpu_torch.node.node import Node

    def keys(x):
        if isinstance(x, dict):
            return {k: keys(v) for k, v in x.items()}
        return type(x).__name__

    telemetry.reset()
    jtelemetry.reset()
    docs = {}
    for pkg, node in (("port", Node(str(tmp_path / "p"), device="cpu", with_labeler=False)),
                      ("jax", JNode(str(tmp_path / "j"), use_device=False, with_labeler=False))):
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            serve = await node.router.exec(node, "telemetry.serve")
            health = await node.router.exec(node, "telemetry.health")
            docs[pkg] = (serve, health["subsystems"]["serve"])
        finally:
            await node.shutdown()
    (pserve, phealth), (jserve, jhealth) = docs["port"], docs["jax"]
    assert pserve["enabled"] is True and jserve["enabled"] is True
    assert keys(pserve) == keys(jserve)
    assert pserve["gate"]["classes"] == jserve["gate"]["classes"] or \
        set(pserve["gate"]["classes"]) == set(jserve["gate"]["classes"])
    assert phealth["status"] == jhealth["status"] == "healthy"
    assert keys(phealth) == keys(jhealth)
    telemetry.reset()
    jtelemetry.reset()


@pytest.mark.asyncio
@_bounded()
async def test_locations_create_answers_before_the_indexer_saves(tmp_path, monkeypatch):
    """`locations.create` (interactive) registers the watcher before it
    spawns the scan, so it answers before the indexer's first save, one
    on-loop transaction for the whole batch, and its latency is its own;
    the scan then indexes every file."""
    from spacedrive_tpu_torch.location.indexer.job import IndexerJob
    from spacedrive_tpu_torch.node.node import Node

    corpus = _make_corpus(tmp_path, n=40)
    saves = []
    save = IndexerJob._save_batch

    def counted(self, library, loc_id, entries, update):
        saves.append(len(entries))
        return save(self, library, loc_id, entries, update)

    monkeypatch.setattr(IndexerJob, "_save_batch", counted)
    node = Node(str(tmp_path / "node"), device="cpu", with_labeler=False)
    node.config.config.p2p.enabled = False
    await node.start()
    try:
        lib = await node.create_library("create-lib")
        loc_id = await node.router.exec(node, "locations.create", {"path": corpus},
                                        library_id=str(lib.id))
        assert saves == [] and node.location_manager.is_watched(lib, loc_id)
        await node.jobs.wait_idle()
        assert sum(saves) > 40
        rows = lib.db.query("SELECT name FROM file_path WHERE is_dir = 0 AND location_id = ? "
                            "AND name != '.spacedrive'", (loc_id,))
        assert sorted(r["name"] for r in rows) == [f"file{i:02d}" for i in range(40)]
    finally:
        await node.shutdown()
