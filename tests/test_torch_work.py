"""The work plane's board, lease law and wire in the port, held to JAX's.

- the board cases of tests/test_mesh_indexing.py (lease expiry and
  re-steal, health-gated claims, library scoping and grant history, the
  session clamp), each script run on JAX's `WorkBoard` and the port's
  with the same inputs: the grants, leases, outcomes and counters match;
- the scheduler and lease-law cases of tests/test_continuum.py (the
  stage registry, multi-stage leases, rate preference, sessionless
  claims, the pool quantum and the per-stage lease targets), the stage
  plane's decisions equal to JAX's Controller fed the same samples;
- every WORK body the port writes against JAX's bytes: the announce,
  claim, complete and status requests, and each answer of the
  responder (grant, completion, duplicate, status, errors);
- `parallel/mesh.multihost_init`: False without a cluster environment,
  and two processes joining one `gloo` group with it;
- the pool's three identify stages, pooled and inline, give equal
  output, and a worker that runs them imports no torch.

The board reads an injected clock, so no case sleeps for a lease.
"""

import asyncio
import os
import socket
import subprocess
import sys
import types
import uuid

import msgpack
import numpy as np
import pytest

import spacedrive_tpu.p2p.work as j_work
import spacedrive_tpu.parallel.autotune as j_autotune
import spacedrive_tpu.parallel.scheduler as j_scheduler
import spacedrive_tpu.telemetry as j_telemetry
import spacedrive_tpu.telemetry.trace as j_trace
import spacedrive_tpu_torch.p2p.work as p_work
import spacedrive_tpu_torch.parallel.autotune as p_autotune
import spacedrive_tpu_torch.parallel.scheduler as p_scheduler
import spacedrive_tpu_torch.telemetry as p_telemetry
import spacedrive_tpu_torch.telemetry.trace as p_trace
from spacedrive_tpu.telemetry.peers import peer_label as j_peer_label
from spacedrive_tpu_torch.telemetry.peers import peer_label

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {
    "jax": types.SimpleNamespace(work=j_work, scheduler=j_scheduler, autotune=j_autotune,
                                 telemetry=j_telemetry, trace=j_trace, label=j_peer_label),
    "port": types.SimpleNamespace(work=p_work, scheduler=p_scheduler, autotune=p_autotune,
                                  telemetry=p_telemetry, trace=p_trace, label=peer_label),
}
LIB = uuid.UUID(int=7)
TRACE = {"trace_id": "ab" * 16, "span_id": "cd" * 8}


def _run(coro, timeout: float = 30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(autouse=True)
def _clean():
    for pkg in PKG.values():
        pkg.telemetry.reset()
    yield
    for pkg in PKG.values():
        pkg.telemetry.reset()


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _board(pkg, clock):
    board = PKG[pkg].work.WorkBoard()
    if pkg == "port":
        board.clock = clock
    return board


def _session(pkg, n_shards=4, files_per_shard=8, lease_max_s=60.0, stages=None,
             library_id=LIB, sid="ab" * 16):
    w = PKG[pkg].work
    s = w.WorkSession(id=sid, library_id=library_id, location_pub="00" * 16,
                      lease_max_s=lease_max_s)
    s.created_at = 1.0 if sid == "ab" * 16 else 2.0
    for stage, n in (stages or {"identify.hash": n_shards}).items():
        for i in range(n):
            shard_id = f"{stage}-{i}" if stages else f"s{i}"
            s.shards[shard_id] = w.WorkShard(
                id=shard_id, stage=stage,
                entries=[{"pub_id": f"{i:02x}{j:02x}" * 8, "size": 100}
                         for j in range(files_per_shard)])
    return s


def _grant(got):
    session, shards, lease_s = got
    return (session.id if session else None, [(s.id, s.stage, s.state, s.assignee)
                                              for s in shards], round(lease_s, 9))


def _counters(pkg, *series):
    tv = PKG[pkg].telemetry.counter_value
    return [tv(name, **labels) for name, labels in series]


# --- the board (tests/test_mesh_indexing.py) ---------------------------------


def _expiry_script(pkg, clock):
    w = PKG[pkg].work
    board = _board(pkg, clock)
    session = _session(pkg, n_shards=2)
    board.publish(session)
    out = [_grant(board.claim(session.id, "peer-1", max_shards=2, files_per_s=1000.0))]
    out.append(_grant(board.claim(session.id, "peer-2", max_shards=2)))
    grant = list(session.shards.values())
    if pkg == "port":
        clock.now += 5.0  # the lease law's floor: both leases lapse
    else:
        for s in grant:
            s.lease_deadline = 0.0
    out.append(board.expire_leases(session.id))
    out.append([s.state == w.AVAILABLE for s in grant])
    out.append(_grant(board.claim(session.id, "peer-2", max_shards=2)))
    out += [board.complete(session.id, "s0", "peer-2"), board.complete(session.id, "s0", "peer-1"),
            board.complete(session.id, "s1", "peer-2"), session.all_done()]
    label = PKG[pkg].label
    out.append(_counters(pkg, ("sd_work_shards_total", {"result": "published", "stage": "identify.hash"}),
                         ("sd_work_steals_total", {"peer": label("peer-1"), "stage": "identify.hash"}),
                         ("sd_work_shards_total", {"result": "expired", "stage": "identify.hash"}),
                         ("sd_work_shards_total", {"result": "duplicate", "stage": "identify.hash"})))
    return out


def test_board_lease_expiry_and_resteal():
    clock = _Clock()
    got, want = _expiry_script("port", clock), _expiry_script("jax", clock)
    assert got == want
    assert got[0][1] and got[0][2] >= 5.0 and got[1][1] == []
    assert got[2] == 2 and got[4][1][0][3] == "peer-2"
    assert got[5:9] == ["completed", "duplicate", "completed", True]
    assert got[9] == [2, 2, 2, 1]


def _health_script(pkg, clock):
    board = _board(pkg, clock)
    session = _session(pkg, n_shards=4)
    board.publish(session)
    return [_grant(board.claim(session.id, "sick", max_shards=4, verdict="unhealthy")),
            _grant(board.claim(session.id, "slow", max_shards=4, verdict="degraded")),
            _grant(board.claim(session.id, "fast", max_shards=2, files_per_s=2.0,
                               verdict="healthy")),
            _counters(pkg, ("sd_work_shards_total", {"result": "refused", "stage": "any"}))]


def test_board_health_gated_claims():
    clock = _Clock()
    got = _health_script("port", clock)
    assert got == _health_script("jax", clock)
    assert got[0][1] == [] and got[3] == [1]
    assert len(got[1][1]) == 1 and got[1][2] == p_work.LEASE_MIN_S
    # 16 files / 2 files-per-s * slack(4) = 32 s
    assert len(got[2][1]) == 2 and got[2][2] == pytest.approx(32.0)


def _scoping_script(pkg, clock):
    board = _board(pkg, clock)
    session = _session(pkg, n_shards=2)
    board.publish(session)
    other = uuid.UUID(int=99)
    out = [_grant(board.claim(None, "p", library_id=other)),
           _grant(board.claim(session.id, "p", library_id=other)),
           _grant(board.claim(None, "p", library_id=session.library_id, max_shards=1))]
    shard_id = out[-1][1][0][0]
    out += [board.complete(session.id, shard_id, "stranger"),
            board.complete(session.id, shard_id, "p", library_id=other),
            board.complete(session.id, shard_id, "p", library_id=session.library_id),
            board.status(session.id)]
    board.retire(session.id)
    out += [board.get(session.id), _grant(board.claim(None, "p", library_id=session.library_id))]
    return out


def test_board_library_scoping_and_grant_history():
    clock = _Clock()
    got = _scoping_script("port", clock)
    assert got == _scoping_script("jax", clock)
    assert got[0][:2] == (None, []) and got[1][:2] == (None, [])
    assert got[2][0] == "ab" * 16 and len(got[2][1]) == 1
    assert got[3:6] == ["unknown", "unknown", "completed"]
    assert got[6]["by_state"] == {"done": 1, "available": 1}
    assert got[7] is None and got[8][0] is None


def test_board_lease_clamped_by_session_override():
    clock = _Clock()
    got = {}
    for pkg in PKG:
        board = _board(pkg, clock)
        session = _session(pkg, n_shards=1, files_per_shard=1000, lease_max_s=2.0)
        board.publish(session)
        got[pkg] = _grant(board.claim(session.id, "p", files_per_s=1.0))
    assert got["port"] == got["jax"]
    assert got["port"][1] and got["port"][2] == 2.0


def test_local_leases_never_expire_and_races_double_lease():
    """The coordinator's own in-flight shards are exempt from expiry, and
    the `p2p.steal` race double-leases a shard another peer holds."""
    from spacedrive_tpu.utils import faults as j_faults
    from spacedrive_tpu_torch.utils import faults as p_faults

    clock = _Clock()
    got = {}
    for pkg, faults in (("jax", j_faults), ("port", p_faults)):
        board = _board(pkg, clock)
        session = _session(pkg, n_shards=3)
        board.publish(session)
        out = [_grant(board.claim(session.id, "local", local=True)),
               _grant(board.claim(session.id, "peer", max_shards=1, files_per_s=100.0))]
        clock.now += 1e6
        if pkg == "jax":
            session.shards["s1"].lease_deadline = 0.0
            session.shards["s0"].lease_deadline = 0.0
        out.append(board.expire_leases(session.id))
        out.append(sorted((s.id, s.state, s.assignee) for s in session.shards.values()))
        out.append(_grant(board.claim(session.id, "peer", max_shards=1, files_per_s=100.0)))
        with faults.active(faults.FaultPlan.parse("p2p.steal:race:arg=claim,times=1")):
            out.append(_grant(board.claim(session.id, "other", max_shards=1,
                                          files_per_s=100.0)))
        got[pkg] = out
    assert got["port"] == got["jax"]
    assert got["port"][2] == 1  # the peer's lease lapsed, the local one stays
    assert got["port"][3] == [("s0", "leased", "local"), ("s1", "available", None),
                              ("s2", "available", None)]
    # the race appends a shard another assignee holds to the grant
    assert [s[0] for s in got["port"][5][1]] == ["s2", "s0"]


def test_work_header_roundtrip():
    from spacedrive_tpu_torch.p2p.loopback import Pipe
    from spacedrive_tpu_torch.p2p.protocol import Header, HeaderType

    async def run():
        pipe = Pipe()
        await Header(HeaderType.WORK, library_id=LIB, trace=TRACE).write(pipe)
        back = await Header.read(pipe)
        assert (back.type, back.library_id, back.trace) == (HeaderType.WORK, LIB, TRACE)

    _run(run())


# --- the scheduler and the lease law (tests/test_continuum.py) --------------


def test_stage_registry_and_single_stage_lease_parity():
    s, js = p_scheduler, j_scheduler
    assert list(s.STAGES) == list(js.STAGES) == [
        "identify.hash", "thumb", "media.extract", "phash", "embed"]
    assert {k: tuple(v.__dict__.values()) for k, v in s.STAGES.items()} == \
        {k: tuple(v.__dict__.values()) for k, v in js.STAGES.items()}
    with pytest.raises(KeyError):
        s.spec("no.such.stage")
    for args in (("identify.hash", 16, 2.0, 60.0), ("thumb", 128, 0.0, 120.0),
                 ("embed", 1000, 0.5, 7.0), ("phash", 1, 1e6, 60.0)):
        assert s.lease_seconds_for(*args) == js.lease_seconds_for(*args)
    assert s.lease_seconds_for("identify.hash", 16, 2.0, 60.0) == pytest.approx(
        min(max(p_work.LEASE_MIN_S, 16 / 2.0 * p_work.LEASE_SLACK), 60.0))
    for mod in (s, js):
        mod.RATES.observe("thumb", 100, 2.0)
        mod.RATES.observe("thumb", 30, 1.0)
    assert s.observed_files_per_s("thumb") == js.observed_files_per_s("thumb") == \
        pytest.approx(0.7 * 50.0 + 0.3 * 30.0)
    assert p_telemetry.gauge_value("sd_work_stage_rate_files_per_s", stage="thumb") == \
        pytest.approx(s.RATES.rate("thumb"))
    assert s.snapshot() == js.snapshot()
    p_telemetry.reset()
    assert s.observed_files_per_s("thumb") == 0.0


def test_multi_stage_lease_sums_per_stage_and_clamps():
    clock = _Clock()
    got = {}
    for pkg in PKG:
        board = _board(pkg, clock)
        session = _session(pkg, stages={"thumb": 1, "embed": 1}, files_per_shard=10,
                           lease_max_s=600.0)
        board.publish(session)
        a = _grant(board.claim(session.id, "p", max_shards=2,
                               rates={"thumb": 10.0, "embed": 2.0}, verdict="healthy"))
        board2 = _board(pkg, clock)
        s2 = _session(pkg, stages={"thumb": 1, "embed": 1}, files_per_shard=1000, lease_max_s=7.0)
        board2.publish(s2)
        got[pkg] = (a, _grant(board2.claim(s2.id, "p", max_shards=2, files_per_s=1.0)))
    assert got["port"] == got["jax"]
    assert got["port"][0][2] == pytest.approx(5.0 + 10 / 2.0 * p_work.LEASE_SLACK)
    assert got["port"][1][2] == 7.0


def test_rates_prefer_claimers_fastest_stage():
    clock = _Clock()
    got = {}
    for pkg in PKG:
        board = _board(pkg, clock)
        session = _session(pkg, stages={"thumb": 3, "embed": 3})
        board.publish(session)
        got[pkg] = (_grant(board.claim(session.id, "gpu-peer", max_shards=3,
                                       rates={"embed": 500.0, "thumb": 5.0})),
                    _grant(board.claim(session.id, "plain-peer", max_shards=3)))
    assert got["port"] == got["jax"]
    assert [sh[1] for sh in got["port"][0][1]] == ["embed"] * 3
    assert [sh[1] for sh in got["port"][1][1]] == ["thumb"] * 3


def test_sessionless_claim_not_masked_by_newer_leased_session():
    clock = _Clock()
    got = {}
    for pkg in PKG:
        board = _board(pkg, clock)
        older = _session(pkg, stages={"embed": 2}, sid="ab" * 16)
        newer = _session(pkg, stages={"thumb": 2}, sid="cd" * 16)
        board.publish(older)
        board.publish(newer)
        got[pkg] = [_grant(board.claim(newer.id, "busy", max_shards=99)),
                    _grant(board.claim(None, "idle", library_id=LIB, max_shards=2)),
                    _grant(board.claim(None, "late", library_id=LIB))]
    assert got["port"] == got["jax"]
    assert got["port"][1][0] == "ab" * 16 and [s[1] for s in got["port"][1][1]] == ["embed"] * 2
    assert got["port"][2][:2] == ("cd" * 16, [])


def _pool_knobs(ctl):
    return {w: (p.pool_scale, p.procpool_batch_rows()) for w, p in ctl.policies.items()}


@pytest.mark.parametrize("script", ["taxed_then_slow", "underfilled"])
def test_pool_quantum_decides_as_jax(script):
    """The pool quantum's knob under tests/test_continuum.py's samples:
    IPC tax widens it, slow round trips shrink it, an idle pool holds,
    an underfilled pool decays toward static."""
    samples = {
        "taxed_then_slow": [dict(pool_batches=10, pool_dispatch_s=3.0, pool_roundtrip_s=10.0,
                                 pool_rows=640.0)] * 2
        + [dict(pool_batches=4, pool_dispatch_s=0.1, pool_roundtrip_s=16.0, pool_rows=256.0)] * 2
        + [{}],
        "underfilled": [dict(pool_batches=10, pool_dispatch_s=0.01, pool_roundtrip_s=1.0,
                             pool_rows=80.0)] * 2,
    }[script]
    port, ref = p_autotune.Controller(interval=999), j_autotune.Controller(interval=999)
    if script == "underfilled":
        port.policies["thumbnail"].pool_scale = ref.policies["thumbnail"].pool_scale = 4.0
    moved = 0
    for i, fields in enumerate(samples):
        got = port.tick(p_autotune.Sample(**fields))
        want = ref.tick(j_autotune.Sample(**fields))
        assert got == want, f"tick {i}"
        assert _pool_knobs(port) == _pool_knobs(ref), f"tick {i}"
        moved += len(got)
    assert moved > 0


def test_pool_quantum_disabled_env_is_static(monkeypatch):
    pol = p_autotune.PipelinePolicy("identify")
    pol.pool_scale = 8.0
    monkeypatch.setenv("SD_AUTOTUNE", "0")
    assert pol.procpool_batch_rows() == p_autotune.PROCPOOL_BATCH_ROWS


def test_stage_lease_targets_follow_rates_as_jax():
    """The stage plane folds the per-stage EWMAs into lease targets with
    JAX's hysteresis: the same observations and samples give the same
    decisions, targets, gauges and snapshot, and telemetry.reset()
    clears them in both."""
    from spacedrive_tpu_torch.location.indexer.mesh import shard_files_default

    port, ref = p_autotune.Controller(interval=999), j_autotune.Controller(interval=999)
    files = shard_files_default()
    script = [("embed", int(files / 2.0 * 10), 10.0), (None, 0, 0),
              ("embed", int(files / 2.0 * 11), 10.0), ("thumb", 500, 1.0),
              ("embed", 5, 10.0), ("embed", 5, 10.0), (None, 0, 0)]
    moved = 0
    for i, (stage, n, secs) in enumerate(script):
        if stage is not None:
            p_scheduler.RATES.observe(stage, n, secs)
            j_scheduler.RATES.observe(stage, n, secs)
        got = port.tick(p_autotune.Sample())
        want = ref.tick(j_autotune.Sample())
        assert got == want, f"tick {i}"
        assert port.stage_lease == ref.stage_lease and port.stage_rates == ref.stage_rates
        moved += len(got)
    assert moved >= 3
    assert port.stage_lease["embed"] == ref.stage_lease["embed"]
    assert p_telemetry.gauge_value("sd_work_stage_lease_target_seconds", stage="embed") == \
        pytest.approx(port.stage_lease["embed"])
    assert port.snapshot()["stages"] == ref.snapshot()["stages"]
    assert port.stage_rate("embed") == ref.stage_rate("embed") > 0
    p_telemetry.reset()
    assert p_scheduler.RATES.rate("embed") == 0.0
    assert not [d for d in port.tick(p_autotune.Sample()) if d.get("knob") == "stage_lease"]


def test_process_controller_reset_clears_the_stage_plane():
    p_scheduler.RATES.observe("phash", 10, 1.0)
    decisions = p_autotune.CONTROLLER.tick(p_autotune.Sample())
    assert [d["stage"] for d in decisions if d.get("knob") == "stage_lease"] == ["phash"]
    assert p_autotune.snapshot()["stages"]["lease_targets"]["phash"] > 0
    p_scheduler.reset()
    assert p_autotune.CONTROLLER.stage_rate("phash") == 0.0
    assert p_autotune.snapshot()["stages"]["lease_targets"] == {}


# --- WORK bodies against JAX's bytes ---------------------------------------


class _Stream:
    """Scripted input, recorded output."""

    def __init__(self, incoming=b"", remote_identity="peer-x"):
        self._in = bytearray(incoming)
        self.wrote = bytearray()
        self.remote_identity = remote_identity

    async def write(self, data):
        self.wrote += data

    async def read_exact(self, n):
        if len(self._in) < n:
            raise asyncio.IncompleteReadError(bytes(self._in), n)
        out = bytes(self._in[:n])
        del self._in[:n]
        return out

    async def close(self):
        pass


def _frame(obj) -> bytes:
    raw = msgpack.packb(obj, use_bin_type=True)
    return len(raw).to_bytes(4, "big") + raw


def _p2p(stream):
    async def new_stream(identity, timeout=10.0):
        return stream

    return types.SimpleNamespace(new_stream=new_stream)


REQUESTS = {
    "announce": {"op": "announce", "session": "ab" * 16},
    "claim": {"op": "claim", "session": "ab" * 16, "max_shards": 4, "files_per_s": 12.5,
              "rates": {"identify.hash": 3.25, "thumb": 100.0}},
    "complete": {"op": "complete", "session": "ab" * 16, "shard": "s0", "results": [
        {"pub_id": "0a" * 16, "ext": "bin", "cas_id": "0123456789abcdef",
         "identity": [1, 2, 3 << 40, 4], "chunks": {"len": 9, "dig": [b"\x01" * 16],
                                                   "cvs": None}},
        {"pub_id": "0b" * 16, "mat": "/", "name": "x", "ext": "png", "cas_id": "fe" * 8,
         "webp": b"RIFF\x00", "error": None, "vector": np.float32([0.5, -1.25]).tobytes(),
         "phash": b"\x00\xff" * 4, "cols": {"resolution": b"\x01", "date_taken": None},
         "probed": True, "obj_pub": "0c" * 16}]},
    "status": {"op": "status", "session": "ab" * 16},
}


@pytest.mark.parametrize("op", sorted(REQUESTS))
def test_request_bodies_equal_jax_bytes(op):
    """`request_work` under one trace context writes JAX's header and
    body bytes, and returns the same parsed answer."""
    wrote, answers = {}, {}
    for pkg in PKG:
        trace = PKG[pkg].trace

        async def run():
            stream = _Stream(_frame({"ok": True, "session": None, "lease_s": 5.0}))
            with trace.use(trace.TraceContext.from_wire(TRACE)):
                ans = await PKG[pkg].work.request_work(_p2p(stream), "peer", LIB, REQUESTS[op])
            return stream, ans

        stream, answers[pkg] = _run(run())
        wrote[pkg] = bytes(stream.wrote)
    assert wrote["jax"] and wrote["port"] == wrote["jax"]
    assert answers["port"] == answers["jax"]


@pytest.mark.parametrize("answer,exc", [({"error": "nope"}, PermissionError),
                                        ([1, 2], ValueError)])
def test_request_refusals_raise_as_jax(answer, exc):
    for pkg in PKG:
        async def run():
            await PKG[pkg].work.request_work(_p2p(_Stream(_frame(answer))), "peer", LIB,
                                             {"op": "claim"})

        with pytest.raises(exc):
            _run(run())


def _responder_node(pkg):
    """A stub Node whose manager holds a real WorkPlane, with one session
    of three identify shards published on its board."""
    w = PKG[pkg].work
    manager = types.SimpleNamespace(federation=None, p2p=None,
                                    peers_for_library=lambda _lid: [])
    node = types.SimpleNamespace(libraries=types.SimpleNamespace(get=lambda _id: None),
                                 p2p=manager)
    manager.work = w.WorkPlane(node, manager)
    manager.work.board.publish(_session(pkg, n_shards=3, files_per_shard=2))
    return node


ANSWERS = [
    ("claim", [{"op": "claim", "session": "ab" * 16, "max_shards": 9, "files_per_s": 2.0,
                "rates": {"identify.hash": "x", "thumb": 7}}]),
    ("sessionless", [{"op": "claim", "max_shards": 1}]),
    ("complete", [{"op": "claim", "session": "ab" * 16, "max_shards": 1, "files_per_s": 100.0},
                  {"op": "complete", "session": "ab" * 16, "shard": "s0", "results": []},
                  {"op": "complete", "session": "ab" * 16, "shard": "s0",
                   "results": [{"pub_id": "aa", "cas_id": None}]},
                  {"op": "complete", "session": "ab" * 16, "shard": "s1", "results": None},
                  {"op": "complete", "session": "zz", "shard": "s1"}]),
    ("status", [{"op": "status", "session": "ab" * 16}, {"op": "status", "session": "zz"}]),
    ("errors", [{"op": "claim", "max_shards": "many"}, {"op": "steal"}, "junk", [1]]),
    ("announce", [{"op": "announce", "session": "ab" * 16}]),
]


@pytest.mark.parametrize("name,bodies", ANSWERS, ids=[a[0] for a in ANSWERS])
def test_responder_answers_equal_jax_bytes(name, bodies):
    """`respond_work` on a board of the same state answers each request
    with JAX's bytes: grants (server-side clamp, malformed rates dropped),
    the sessionless claim, completions and duplicates, status and the
    error answers."""
    wrote = {}
    for pkg in PKG:
        async def run():
            node = _responder_node(pkg)
            out = bytearray()
            for body in bodies:
                header = types.SimpleNamespace(library_id=LIB)
                s = _Stream(_frame(body))
                await PKG[pkg].work.respond_work(s, node, header)
                out += s.wrote
            await node.p2p.work.stop()
            return bytes(out)

        wrote[pkg] = _run(run())
    assert wrote["jax"] and wrote["port"] == wrote["jax"]
    if name == "claim":
        got = msgpack.unpackb(wrote["port"][4:])
        assert [s["id"] for s in got["shards"]] == ["s0", "s1", "s2"]  # clamp: 4 of 9 asked
        # 6 files at the claimer's 2 files/s (its malformed rate dropped) x slack 4
        assert got["lease_s"] == pytest.approx(12.0)


# --- multihost_init ---------------------------------------------------------


def test_multihost_init_is_a_no_op_without_a_cluster(monkeypatch):
    from spacedrive_tpu_torch.parallel.mesh import multihost_init

    for var in ("SD_COORDINATOR_ADDRESS", "SD_NUM_PROCESSES", "SD_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert multihost_init() is False


_CHILD = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from spacedrive_tpu_torch.parallel.mesh import multihost_init

assert multihost_init() is True
assert multihost_init() is True  # a second call sees the group
assert dist.get_world_size() == 2 and dist.get_rank() == int(os.environ["SD_PROCESS_ID"])
t = torch.tensor([dist.get_rank() + 1.0])
dist.all_reduce(t)
assert t.item() == 3.0, t
dist.destroy_process_group()
print("ok")
"""


def test_multihost_init_joins_a_gloo_group():
    """Two processes given SD_COORDINATOR_ADDRESS, SD_NUM_PROCESSES and
    SD_PROCESS_ID join one gloo group (no CUDA here) and all-reduce."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = {**os.environ, "SD_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "SD_NUM_PROCESSES": "2", "SD_PROCESS_ID": str(rank), "CUDA_VISIBLE_DEVICES": ""}
        procs.append(subprocess.Popen([sys.executable, "-c", _CHILD, ROOT], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == b"ok", err.decode()[-2000:]


def test_distribute_location_index_calls_multihost_init(monkeypatch, tmp_path):
    """The coordinator joins the group where JAX's does, before it builds
    the session; a joined group changes nothing about where shards hash."""
    import spacedrive_tpu_torch.parallel.mesh as p_mesh
    from spacedrive_tpu_torch.location.indexer import mesh

    calls = []
    monkeypatch.setattr(p_mesh, "multihost_init", lambda *a, **k: calls.append(a) or True)

    async def run():
        from spacedrive_tpu_torch.location.locations import LocationCreateArgs
        from spacedrive_tpu_torch.node.node import Node

        os.makedirs(tmp_path / "c")
        (tmp_path / "c" / "a.bin").write_bytes(b"x" * 100)
        node = Node(str(tmp_path / "n"), device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            lib = await node.create_library("m")
            loc = LocationCreateArgs(path=str(tmp_path / "c")).create(lib)
            return await mesh.distribute_location_index(node, lib, loc["id"])
        finally:
            await node.shutdown()

    stats = _run(run(), 60)
    assert calls == [()] and stats["files"] == 1 and stats["remote_shards"] == 0


# --- the pool's identify stages ----------------------------------------------


def _stage_corpus(root):
    rng = np.random.default_rng(11)
    os.makedirs(root, exist_ok=True)
    entries = []
    for i, size in enumerate([0, 1, 1023, 1024, 5000, 100 * 1024, 100 * 1024 + 1, 300_000]):
        name = f"f{i}"
        with open(os.path.join(root, f"{name}.bin"), "wb") as f:
            f.write(rng.integers(0, 256, size, np.uint8).tobytes())
        entries.append({"pub_id": f"{i:02x}" * 16, "mat": "/", "name": name, "ext": "bin"})
    entries.append({"pub_id": "ff" * 16, "mat": "/", "name": "gone", "ext": "bin"})
    return entries


def test_pool_identify_stages_equal_inline(tmp_path, monkeypatch):
    """`identify.hash_entries`, `journal.match` and `link.prep` on a live
    pool give the inline stage functions' output, the cas_ids are
    blake3_ref's, and the workers that ran them never imported torch."""
    from spacedrive_tpu_torch.location.indexer import journal as pj
    from spacedrive_tpu_torch.object.file_identifier import link
    from spacedrive_tpu_torch.ops import blake3_ref, cas
    from spacedrive_tpu_torch.parallel import procpool, procworker

    root = str(tmp_path / "c")
    entries = _stage_corpus(root)
    hash_payload = {"loc_path": root, "entries": entries}
    inline_hash = procworker._stage_hash_entries(hash_payload)
    for e, rec in zip(entries, inline_hash["results"]):
        path = os.path.join(root, f"{e['name']}.bin")
        if not os.path.exists(path):
            assert rec["identity"] is None and rec["cas_id"] is None
        elif os.path.getsize(path) == 0:
            assert rec["cas_id"] == ""
        else:
            msg = cas.read_message(path)
            assert rec["cas_id"] == blake3_ref.blake3_hex(msg, 8)
            assert rec["chunks"] == cas.build_chunk_cache(msg).to_payload()
    good = pj.JournalEntry(identity=pj.Identity(1, 2, 3, 4), stale=False, cas_id="ab" * 8,
                           thumb=True, phash=b"\x01" * 8,
                           chunks=cas.build_chunk_cache(b"x" * 3000))
    from spacedrive_tpu_torch.utils.msgpack_codec import packb

    rows = [None, {"payload": packb({"v": 1, "chunks": good.chunks.to_payload(), "thumb": True,
                                     "phash": b"\x01" * 8}),
                   "inode": (1).to_bytes(8, "little"), "dev": (2).to_bytes(8, "little"),
                   "mtime_ns": (3).to_bytes(8, "little"), "size": (4).to_bytes(8, "little"),
                   "cas_id": "ab" * 8, "stale": 0},
            {"payload": b"\xc1torn", "inode": None, "cas_id": None, "stale": 0}]
    rows.append(dict(rows[1], stale=1))
    items = [[["/", f"k{i}", "bin"], [1, 2, 3, 4]] for i in range(4)]
    match_payload = {"items": items, "rows": rows}
    inline_match = procworker._stage_journal_match(match_payload)
    assert [v[0] for v in inline_match["verdicts"]] == ["miss", "hit", "bypassed", "invalidated"]
    link_payload = {"library_id": str(LIB), "results": [
        {"pub_id": "0a" * 16, "cas_id": "ab" * 8, "ext": "bin"},
        {"pub_id": None, "cas_id": "ab" * 8}, {"pub_id": "zz", "cas_id": "cd" * 8},
        {"pub_id": "0b" * 16, "cas_id": ""}, {"pub_id": "0c" * 16, "cas_id": "ab" * 8}]}
    inline_link = procworker._stage_link_prep(link_payload)
    assert [u[0] for u in inline_link["usable"]] == [0, 4]
    assert inline_link["usable"][0][3] == link.object_pub_for(LIB, "ab" * 8)

    monkeypatch.setenv("SD_PROCS", "1")
    pool = procpool.ProcPool()
    assert pool.start()
    try:
        assert pool.request("identify.hash_entries", hash_payload, rows=9) == inline_hash
        assert pool.request("journal.match", match_payload, rows=4) == inline_match
        got = pool.request("link.prep", link_payload, rows=5)
        assert [[i, bytes(f), c, bytes(o)] for i, f, c, o in got["usable"]] == \
            [[i, bytes(f), c, bytes(o)] for i, f, c, o in inline_link["usable"]]
        # a worker process running the three stages imports no torch
        code = (
            "import sys\n"
            "from spacedrive_tpu_torch.parallel import procworker\n"
            f"procworker._stage_hash_entries({hash_payload!r})\n"
            f"procworker._stage_journal_match({match_payload!r})\n"
            f"procworker._stage_link_prep({link_payload!r})\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'jaxlib'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                             text=True, timeout=60)
        assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
    finally:
        pool.stop()


def test_journal_consult_many_pooled_equals_inline(tmp_path, monkeypatch):
    """consult_many's verdicts, entries and counters are the same with the
    match half on the pool as inline, and both equal per-key lookups."""
    from spacedrive_tpu_torch.db import LibraryDb
    from spacedrive_tpu_torch.location.indexer import journal as pj
    from spacedrive_tpu_torch.ops import cas
    from spacedrive_tpu_torch.parallel import procpool

    def fill(db):
        db.insert("location", pub_id=uuid.UUID(int=1).bytes, name="l", path=str(tmp_path))
        j = pj.IndexJournal(db)
        recs = []
        for i in range(40):
            ident = pj.Identity(i, 1, 1000 + i, 10 + i)
            recs.append((("/", f"f{i}", "bin"), ident, f"{i:016x}",
                         cas.build_chunk_cache(bytes([i]) * 2500), None))
        j.record_many(1, recs)
        return j

    items = [(("/", f"f{i}", "bin"), pj.Identity(i, 1, 1000 + i + (i % 3 == 0), 10 + i))
             for i in range(44)]
    results = {}
    for mode in ("inline", "pool", "lookup"):
        p_telemetry.reset()
        db = LibraryDb(str(tmp_path / f"{mode}.db"))
        j = fill(db)
        if mode == "pool":
            monkeypatch.setenv("SD_PROCS", "1")
            assert procpool.POOL.start()
        try:
            if mode == "lookup":
                got = {k: j.lookup(1, k, ident) for k, ident in items}
            else:
                got = j.consult_many(1, items)
        finally:
            if mode == "pool":
                procpool.POOL.stop()
                monkeypatch.delenv("SD_PROCS")
        results[mode] = ({k: (v, e) for k, (v, e) in got.items()},
                         {r: p_telemetry.counter_value("sd_index_journal_ops_total", result=r)
                          for r in ("hit", "miss", "invalidated", "bypassed")})
        db.close()
    assert results["pool"] == results["inline"] == results["lookup"]
    assert results["inline"][1] == {"hit": 26, "miss": 4, "invalidated": 14, "bypassed": 0}
