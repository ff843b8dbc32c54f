"""Mesh work stealing: shard dispatch of one location's work across
library peers.

Counterpart of `spacedrive_tpu/p2p/work.py`, with every constant, the
lease law and each WORK body unchanged, so JAX and port Nodes share one
mesh both ways. The coordinating node splits a location's work into
**journal-keyed shards** (the file-path key and the stat identity, so a
peer's own index-journal hits still count), publishes them on a
:class:`WorkBoard`, and idle library peers pull shards over the ``WORK``
header: the pull form of stealing, the one that works across a network
hop.

- **Leases, not assignments.** A claim grants shards for a lease sized
  from the claimer's per-stage throughput and its federated health
  verdict: an unhealthy or stale peer gets none, a degraded one one
  shard. An expired lease returns its shard to the pool.
- **Idempotent execution.** Shard results merge through the HLC/LWW
  sync path, and object pub_ids derive from ``(library, cas_id)``, so a
  twice-executed shard converges instead of corrupting.
- **Resilience.** Every peer-facing leg (announce, claim, complete)
  rides :data:`WORK_POLICY` with a per-peer breaker.

Wire ops (a MessagePack body after ``Header(WORK, library_id)``, served
to members of that library only): ``announce`` (coordinator → peer: a
session has work), ``claim`` (peer → coordinator: lease up to
``max_shards``, with the claimer's rates), ``complete`` (the shard's
results; a duplicate is counted and absorbed) and ``status``.

Fault points: ``p2p.steal`` (``vanish`` at arg ``lease``: the claiming
worker dies mid-lease; ``race`` at arg ``claim``: a shard is
double-leased).
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

from ..parallel import scheduler as _scheduler
from ..parallel.scheduler import stage_label
from ..telemetry import metrics as _tm
from ..telemetry import trace as _trace
from ..telemetry.events import WORK_EVENTS
from ..telemetry.peers import peer_label
from ..utils import faults as _faults
from ..utils.resilience import (
    PASS,
    RETRY,
    BreakerOpen,
    ResiliencePolicy,
    RetryPolicy,
)
from .protocol import Header, HeaderType
from .wire import Reader, Writer

logger = logging.getLogger(__name__)

WORK_TIMEOUT = 30.0          # one wire exchange
CLAIM_POLL_S = 0.2           # worker poll while the board is drained
DEFAULT_FILES_PER_S = 50.0   # lease sizing before any throughput is observed
LEASE_SLACK = 4.0            # lease = slack × estimated shard wall-clock
LEASE_MIN_S = 5.0
LEASE_MAX_S = 120.0
MAX_SHARDS_PER_CLAIM = 4
WORKER_MAX_FAILURES = 5      # consecutive wire failures before giving up

#: shard states
AVAILABLE, LEASED, DONE = "available", "leased", "done"


def _peer_classify(exc: BaseException) -> str:
    """Transport failures retry and count toward the breaker; an answer
    we dislike (refusal, malformed body) passes through untouched."""
    if isinstance(exc, (PermissionError, ValueError)):
        return PASS
    return RETRY


#: One bounded, jittered retry ladder and per-peer breaker for every
#: work-plane exchange: manager.SYNC_POLICY's law in its own breaker
#: namespace (a peer whose sync plane is sick may still be a fine steal
#: target, and the other way round).
WORK_POLICY = ResiliencePolicy(
    "p2p_work",
    RetryPolicy(max_attempts=2, base_delay=0.05, max_delay=0.5,
                attempt_timeout=WORK_TIMEOUT),
    failure_threshold=3,
    reset_timeout=15.0,
    classify=_peer_classify,
)


# --- the board (coordinator side) -----------------------------------------


@dataclass
class WorkShard:
    """One leased unit: a batch of journal-keyed file entries, typed by
    the pipeline stage that executes it (``parallel/scheduler.py`` is
    the stage vocabulary — identify.hash, thumb, media.extract, phash,
    embed). Pre-continuum shards carried no stage; the default keeps
    old wire bodies and tests meaning what they always meant."""

    id: str
    entries: list[dict]  # {pub_id, mat, name, ext, ...} (stage-shaped)
    stage: str = "identify.hash"
    state: str = AVAILABLE
    assignee: str | None = None
    lease_deadline: float = 0.0
    grants: int = 0
    # every peer this shard was EVER leased to: a complete from anyone
    # else is rejected (a member may only report work it was granted)
    granted_to: set = field(default_factory=set)

    def to_wire(self) -> dict:
        return {"id": self.id, "stage": self.stage, "entries": self.entries}


@dataclass
class WorkSession:
    """One location's distributed pass."""

    id: str
    library_id: uuid.UUID
    location_pub: str  # location pub_id hex (peers resolve their local row)
    shards: dict[str, WorkShard] = field(default_factory=dict)
    #: per-session lease clamp override (tests/bench use short leases)
    lease_max_s: float = LEASE_MAX_S
    created_at: float = field(default_factory=time.time)
    completed_by: dict[str, str] = field(default_factory=dict)  # shard -> peer

    def pending(self) -> int:
        return sum(1 for s in self.shards.values() if s.state != DONE)

    def all_done(self) -> bool:
        return self.pending() == 0


class WorkBoard:
    """Session registry + lease bookkeeping on the coordinating node.

    Single-threaded by construction (all calls run on the node's event
    loop: the responder coroutines and the coordinator's local loop),
    so state transitions need no lock — the async boundary IS the
    serialization point.

    Lease deadlines read ``clock`` (``time.monotonic`` by default; JAX's
    board reads it directly), so a test moves a lease past its deadline
    without sleeping.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self.sessions: dict[str, WorkSession] = {}
        self.clock = clock

    def publish(self, session: WorkSession) -> None:
        self.sessions[session.id] = session
        by_stage: dict[str, int] = {}
        for sh in session.shards.values():
            by_stage[sh.stage] = by_stage.get(sh.stage, 0) + 1
        for st, n in by_stage.items():
            _tm.WORK_SHARDS.inc(
                n, result="published",
                stage=stage_label(st),
            )
        WORK_EVENTS.emit(
            "publish", session=session.id, shards=len(session.shards),
            stages=sorted(by_stage), library=str(session.library_id),
        )

    def get(self, session_id: str) -> WorkSession | None:
        return self.sessions.get(session_id)

    def expire_leases(self, session_id: str) -> int:
        """Return expired-lease shards to the steal pool."""
        session = self.sessions.get(session_id)
        if session is None:
            return 0
        now = self.clock()
        n = 0
        expired_by_stage: dict[str, int] = {}
        for shard in session.shards.values():
            if shard.assignee == "local":
                # the coordinator's own in-flight execution: "peer
                # death" is meaningless here (if the coordinator dies
                # the session dies), and expiring it under load just
                # buys a duplicate execution
                continue
            if shard.state == LEASED and now >= shard.lease_deadline:
                shard.state = AVAILABLE
                WORK_EVENTS.emit(
                    "lease_expired", session=session_id, shard=shard.id,
                    peer=peer_label(shard.assignee or "?"),
                )
                shard.assignee = None
                expired_by_stage[shard.stage] = (
                    expired_by_stage.get(shard.stage, 0) + 1)
                n += 1
        for st, cnt in expired_by_stage.items():
            _tm.WORK_SHARDS.inc(
                cnt, result="expired",
                stage=stage_label(st),
            )
        return n

    def claim(
        self,
        session_id: str | None,
        peer_id: str,
        *,
        library_id: uuid.UUID | None = None,
        max_shards: int = 1,
        files_per_s: float = 0.0,
        rates: dict | None = None,
        verdict: str = "unknown",
        local: bool = False,
    ) -> tuple[WorkSession | None, list[WorkShard], float]:
        """Lease up to ``max_shards`` to ``peer_id``. With no session id
        the NEWEST open session FOR ``library_id`` that still has an
        available shard is used (idle peers steal without knowing
        session ids — and a newer fully-leased session must not mask an
        older session's unclaimed shards). A claimer is scoped to the
        library its WORK header named — membership in library X must
        never lease (or even reveal) library Y's shards. ``rates`` is
        the claimer's per-stage files/s self-report: grants prefer the
        stages the claimer is fastest at, and each stage's lease
        contribution is sized from its own rate (heterogeneous-fleet
        scheduling); ``files_per_s`` stays as the stage-blind fallback.
        Returns ``(session, shards, lease_seconds)`` — an empty grant
        with a session means "drained or gated", with ``None`` "no work
        at all"."""
        session = None
        if session_id is not None:
            session = self.sessions.get(session_id)
            if session is not None and library_id is not None \
                    and session.library_id != library_id:
                return None, [], 0.0
            if session is not None:
                self.expire_leases(session.id)
        else:
            open_sessions = sorted(
                (
                    s for s in self.sessions.values()
                    if not s.all_done()
                    and (library_id is None or s.library_id == library_id)
                ),
                key=lambda s: s.created_at, reverse=True,
            )
            for cand in open_sessions:
                # expire before inspecting: a lapsed lease IS an
                # available shard for the next claimer
                self.expire_leases(cand.id)
                if any(sh.state == AVAILABLE
                       for sh in cand.shards.values()):
                    session = cand
                    break
            else:
                # everything in flight: poll against the newest open
                # session (matches the historical behavior when no
                # shard is available anywhere)
                session = open_sessions[0] if open_sessions else None
        if session is None:
            return None, [], 0.0
        if not local:
            # health-gated stealing: a peer the federated mesh view
            # calls unhealthy (or whose snapshot went stale — silence
            # is a symptom) gets nothing; a degraded peer gets one
            # small shard so it can prove itself without hoarding
            if verdict == "unhealthy":
                _tm.WORK_SHARDS.inc(result="refused", stage="any")
                WORK_EVENTS.emit(
                    "claim_refused", session=session.id,
                    peer=peer_label(peer_id), verdict=verdict,
                )
                return session, [], 0.0
            if verdict == "degraded":
                max_shards = 1
        avail = [
            sh for sh in session.shards.values() if sh.state == AVAILABLE
        ]
        if rates:
            # stable sort: the claimer's fastest stages first, board
            # insertion order breaking ties — a CPU-rich peer drains
            # the decode/encode stages, a chip-rich peer the device
            # stages, and rate-less stages keep publish order
            avail.sort(key=lambda sh: -float(rates.get(sh.stage) or 0.0))
        grant: list[WorkShard] = avail[:max(1, max_shards)]
        spec = _faults.hit("p2p.steal", arg="claim")
        if spec is not None and spec.mode == "race":
            # double-lease an already-leased shard: the chaos proof
            # that a raced (twice-executed) shard merges idempotently
            for shard in session.shards.values():
                if shard.state == LEASED and shard.assignee != peer_id:
                    grant.append(shard)
                    break
        by_stage: dict[str, int] = {}
        for sh in grant:
            by_stage[sh.stage] = by_stage.get(sh.stage, 0) + len(sh.entries)
        n_files = sum(by_stage.values())
        # per-stage lease sizing: each stage's contribution is sized
        # from the claimer's rate FOR THAT STAGE (then the Controller's
        # per-stage target, then the static default — inside
        # lease_seconds_for); contributions sum because the claimer
        # executes the grant serially, and the session clamp still caps
        # the total. A single-stage grant reproduces the pre-continuum
        # lease law bit-for-bit.
        stage_leases: dict[str, float] = {}
        for st, files_st in by_stage.items():
            rate_st = float((rates or {}).get(st) or 0.0)
            if rate_st <= 0:
                rate_st = files_per_s
            stage_leases[st] = _scheduler.lease_seconds_for(
                st, files_st, rate_st, session.lease_max_s)
        lease_s = (
            min(sum(stage_leases.values()), session.lease_max_s)
            if stage_leases
            # empty grant: the historical floor (callers only read this
            # when shards were granted, but the reply shape is stable)
            else min(LEASE_MIN_S, session.lease_max_s)
        )
        if verdict == "degraded":
            lease_s = LEASE_MIN_S
        deadline = self.clock() + lease_s
        for shard in grant:
            shard.state = LEASED
            shard.assignee = peer_id
            shard.lease_deadline = deadline
            shard.grants += 1
            shard.granted_to.add(peer_id)
            if not local:
                st = shard.stage
                _tm.WORK_STEALS.inc(
                    peer=peer_label(peer_id),
                    stage=stage_label(st),
                )
        if grant:
            for st, stage_lease in stage_leases.items():
                _tm.WORK_LEASE_SECONDS.observe(
                    stage_lease,
                    stage=stage_label(st),
                )
            WORK_EVENTS.emit(
                "lease", session=session.id, peer=peer_label(peer_id),
                shards=len(grant), files=n_files,
                stages=sorted(by_stage),
                lease_s=round(lease_s, 2), local=local,
            )
        return session, grant, lease_s

    def complete(self, session_id: str, shard_id: str, peer_id: str,
                 *, library_id: uuid.UUID | None = None,
                 local: bool = False) -> str:
        """Mark a shard done. Returns ``completed`` for the first
        completion, ``duplicate`` for a re-stolen/raced repeat (the
        caller already merged idempotently), ``unknown`` otherwise —
        including completes scoped to the wrong library or from a peer
        this shard was never granted to (a member may only report work
        it was leased)."""
        session = self.sessions.get(session_id)
        if session is None:
            return "unknown"
        if library_id is not None and session.library_id != library_id:
            return "unknown"
        shard = session.shards.get(shard_id)
        if shard is None:
            return "unknown"
        if not local and peer_id not in shard.granted_to:
            return "unknown"
        st = shard.stage
        if shard.state == DONE:
            _tm.WORK_SHARDS.inc(
                result="duplicate",
                stage=stage_label(st),
            )
            WORK_EVENTS.emit(
                "duplicate_complete", session=session_id, shard=shard_id,
                peer=peer_label(peer_id),
            )
            return "duplicate"
        shard.state = DONE
        shard.assignee = peer_id
        session.completed_by[shard_id] = peer_id
        _tm.WORK_SHARDS.inc(
            result="completed_local" if local else "completed_remote",
            stage=stage_label(st),
        )
        WORK_EVENTS.emit(
            "complete", session=session_id, shard=shard_id,
            peer=peer_label(peer_id), local=local,
        )
        return "completed"

    def retire(self, session_id: str) -> None:
        """Drop a finished (or abandoned) session: the shard entry
        lists hold per-file metadata for the whole location — a
        long-running coordinator must not accumulate one copy per
        pass. Workers seeing the session gone read ``done`` and stop;
        any in-flight results still arrive through sync."""
        session = self.sessions.pop(session_id, None)
        if session is not None:
            WORK_EVENTS.emit(
                "retire", session=session_id,
                shards=len(session.shards), done=session.all_done(),
            )

    def status(self, session_id: str) -> dict[str, Any] | None:
        session = self.sessions.get(session_id)
        if session is None:
            return None
        by_state: dict[str, int] = {}
        for s in session.shards.values():
            by_state[s.state] = by_state.get(s.state, 0) + 1
        return {
            "session": session.id,
            "library_id": str(session.library_id),
            "location_pub": session.location_pub,
            "shards": len(session.shards),
            "by_state": by_state,
            "done": session.all_done(),
        }


# --- wire halves ----------------------------------------------------------


async def request_work(
    p2p: Any, identity: Any, library_id: uuid.UUID, body: dict,
    timeout: float = WORK_TIMEOUT,
) -> dict:
    """One WORK exchange. Raises ``PermissionError`` on a refusal
    (membership gate), ``ValueError`` on a malformed response — both
    PASS through the policy without feeding the breaker."""
    from ..utils.compat import timeout as _timeout

    stream = await p2p.new_stream(identity)
    try:
        async with _timeout(timeout):
            await Header(
                HeaderType.WORK, library_id=library_id,
                trace=_trace.wire_current(),
            ).write(stream)
            w = Writer(stream)
            w.msgpack(body)
            await w.flush()
            resp = await Reader(stream).msgpack()
    finally:
        await stream.close()
    if isinstance(resp, dict) and resp.get("error"):
        raise PermissionError(str(resp["error"]))
    if not isinstance(resp, dict):
        raise ValueError("malformed WORK response")
    return resp


async def respond_work(stream: Any, node: Any, header: Any) -> None:
    """Server half, dispatched by the manager AFTER the library-member
    gate. ``claim``/``complete`` run against this node's board;
    ``announce`` starts this node's worker loop against the announcer."""
    body = await Reader(stream).msgpack()
    w = Writer(stream)
    if not isinstance(body, dict):
        w.msgpack({"error": "malformed WORK request"})
        await w.flush()
        return
    op = body.get("op")
    peer_id = str(getattr(stream, "remote_identity", "?"))
    plane: "WorkPlane | None" = getattr(node.p2p, "work", None)
    if plane is None:
        w.msgpack({"error": "work plane not running"})
        await w.flush()
        return

    if op == "claim":
        verdict = plane.peer_verdict(peer_id)
        # wire fields are untrusted: a non-numeric ask must get the
        # structured error reply (PASS through the caller's policy),
        # not a responder crash that reads as a transport failure and
        # feeds the healthy coordinator's breaker
        try:
            max_shards = int(body.get("max_shards", 1))
            files_per_s = float(body.get("files_per_s", 0.0))
        except (TypeError, ValueError):
            w.msgpack({"error": "malformed WORK claim fields"})
            await w.flush()
            return
        # the per-stage rate report is advisory (grant preference +
        # lease sizing): a malformed one degrades to the stage-blind
        # scalar instead of erroring the claim
        raw_rates = body.get("rates")
        rates: dict[str, float] = {}
        if isinstance(raw_rates, dict):
            for k, v in raw_rates.items():
                try:
                    rates[str(k)] = float(v)
                except (TypeError, ValueError):
                    continue
        session, shards, lease_s = plane.board.claim(
            body.get("session"), peer_id,
            # scope to the header's library (the one the membership
            # gate verified) and clamp the ask server-side: one slow
            # peer must not hoard a whole session under a single lease
            library_id=header.library_id,
            max_shards=min(max_shards, MAX_SHARDS_PER_CLAIM),
            files_per_s=files_per_s,
            rates=rates or None,
            verdict=verdict,
        )
        w.msgpack({
            "ok": True,
            "session": session.id if session else None,
            "location_pub": session.location_pub if session else None,
            "shards": [s.to_wire() for s in shards],
            "lease_s": lease_s,
            "done": session.all_done() if session else True,
        })
    elif op == "complete":
        # stage BEFORE complete: the shard's stage routes the merge,
        # and the board row is the trusted source (never the wire body)
        session = plane.board.get(str(body.get("session")))
        shard_row = (
            session.shards.get(str(body.get("shard")))
            if session is not None else None
        )
        stage_id = shard_row.stage if shard_row is not None \
            else "identify.hash"
        outcome = plane.board.complete(
            str(body.get("session")), str(body.get("shard")), peer_id,
            library_id=header.library_id,
        )
        applied = 0
        if outcome in ("completed", "duplicate"):
            # merge the shipped results locally (idempotent): the
            # coordinator gets cas rows / webp bytes / vectors +
            # journal vouches even when the peer's own sync ops are
            # still in flight — and a duplicate completion re-applies
            # to the same state
            from ..location.indexer.stages import apply_stage_results

            if session is not None:
                applied = apply_stage_results(
                    node, session, stage_id, body.get("results") or []
                )
        w.msgpack({"ok": True, "outcome": outcome, "applied": applied})
    elif op == "announce":
        session_id = str(body.get("session"))
        plane.worker.on_announce(
            getattr(stream, "remote_identity", None), header.library_id,
            session_id,
        )
        w.msgpack({"ok": True})
    elif op == "status":
        session = plane.board.get(str(body.get("session")))
        if session is not None and session.library_id != header.library_id:
            session = None  # cross-library probe reads as "no session"
        w.msgpack({"ok": True, "status": (
            plane.board.status(session.id) if session is not None else None
        )})
    else:
        w.msgpack({"error": f"unknown WORK op {op!r}"})
    await w.flush()


# --- the worker (stealing side) -------------------------------------------


class MeshWorker:
    """Per-node claim loop: on an announce, steal shards from the
    coordinator until its board reports done. Execution happens against
    this node's own library replica; results additionally ship back in
    ``complete`` so the coordinator can merge without waiting on sync."""

    def __init__(self, node: Any, manager: Any):
        self.node = node
        self.manager = manager
        self._loops: dict[str, asyncio.Task] = {}  # session id -> loop
        self.executed_shards = 0
        self.executed_files = 0
        self._stopped = False

    def on_announce(self, coordinator: Any, library_id: uuid.UUID,
                    session_id: str) -> None:
        if self._stopped or coordinator is None:
            return
        # prune finished loops (a long-lived node steals from many
        # sessions over its lifetime — done tasks must not accumulate)
        for sid in [s for s, t in self._loops.items() if t.done()]:
            del self._loops[sid]
        if session_id in self._loops:
            return
        task = asyncio.get_running_loop().create_task(
            self._work_loop(coordinator, library_id, session_id),
            name=f"mesh-worker-{session_id[:8]}",
        )
        self._loops[session_id] = task

    def observed_files_per_s(self) -> float:
        """This node's stage-blind throughput self-report (the legacy
        claim-sizing scalar, kept as the fallback for stages missing
        from the per-stage report): the identify EWMA the scheduler
        keeps, falling back to the autotune-observed identify rate
        before any shard ran here."""
        return _scheduler.observed_files_per_s(_scheduler.STAGE_IDENTIFY)

    def rates_report(self) -> dict[str, float]:
        """Per-stage files/s self-report shipped with every claim (the
        continuum's heterogeneous-fleet input): the scheduler's EWMAs
        for every stage that has executed anything here."""
        out: dict[str, float] = {}
        for stage_id in _scheduler.STAGES:
            rate = _scheduler.observed_files_per_s(stage_id)
            if rate > 0:
                out[stage_id] = round(rate, 3)
        return out

    async def stop(self) -> None:
        self._stopped = True
        loops = [t for t in self._loops.values() if not t.done()]
        for t in loops:
            t.cancel()
        if loops:
            await asyncio.gather(*loops, return_exceptions=True)
        self._loops.clear()

    async def _work_loop(self, coordinator: Any, library_id: uuid.UUID,
                         session_id: str) -> None:
        from ..location.indexer.stages import execute_stage_shard

        lib = self.node.libraries.get(library_id)
        if lib is None:
            return
        p2p = self.manager.p2p
        pid = str(coordinator)
        failures = 0
        while not self._stopped:
            try:
                resp = await WORK_POLICY.call(
                    pid,
                    lambda: request_work(p2p, coordinator, library_id, {
                        "op": "claim",
                        "session": session_id,
                        "max_shards": MAX_SHARDS_PER_CLAIM,
                        "files_per_s": self.observed_files_per_s(),
                        "rates": self.rates_report(),
                    }),
                )
                failures = 0
            except (BreakerOpen, ConnectionError, OSError, EOFError,
                    asyncio.TimeoutError, PermissionError, ValueError) as e:
                failures += 1
                logger.debug("work claim from %s failed: %s", pid, e)
                if failures >= WORKER_MAX_FAILURES:
                    return
                await asyncio.sleep(CLAIM_POLL_S)
                continue
            shards = resp.get("shards") or []
            if not shards:
                if resp.get("done"):
                    return
                await asyncio.sleep(CLAIM_POLL_S)
                continue
            spec = _faults.hit("p2p.steal", arg="lease")
            if spec is not None and spec.mode == "vanish":
                # the claiming peer dies mid-lease: shards stay leased
                # until the coordinator's deadline re-pools them
                WORK_EVENTS.emit("worker_vanish", session=session_id,
                                 shards=len(shards))
                return
            location_pub = resp.get("location_pub")
            for shard in shards:
                stage_id = str(shard.get("stage") or "identify.hash")
                try:
                    # execute_stage_shard feeds scheduler.RATES — the
                    # per-stage EWMA the next claim's report rides
                    results = await execute_stage_shard(
                        self.node, lib, location_pub, stage_id,
                        shard["entries"],
                    )
                except Exception:  # noqa: BLE001 - a bad shard must not kill the loop
                    logger.exception("shard %s execution failed", shard["id"])
                    continue
                self.executed_shards += 1
                self.executed_files += len(shard["entries"])
                try:
                    await WORK_POLICY.call(
                        pid,
                        lambda shard=shard, results=results: request_work(
                            p2p, coordinator, library_id, {
                                "op": "complete",
                                "session": session_id,
                                "shard": shard["id"],
                                "results": results,
                            }),
                    )
                except (BreakerOpen, ConnectionError, OSError, EOFError,
                        asyncio.TimeoutError, PermissionError,
                        ValueError) as e:
                    # the work itself is durable (our sync ops carry
                    # it); a lost complete only costs the coordinator a
                    # re-steal of an already-converged shard
                    logger.debug("work complete to %s failed: %s", pid, e)


class WorkPlane:
    """The per-node work-stealing surface hung off P2PManager: the
    board (when coordinating) + the worker (when stealing)."""

    def __init__(self, node: Any, manager: Any):
        self.node = node
        self.manager = manager
        self.board = WorkBoard()
        self.worker = MeshWorker(node, manager)

    def peer_verdict(self, peer_id: str) -> str:
        """The federated mesh verdict for a claiming peer: ``unknown``
        when we hold no (fresh) snapshot — never a blocker for a mesh
        that has not exchanged telemetry yet — and ``unhealthy`` when
        the snapshot says so or went stale."""
        federation = getattr(self.manager, "federation", None)
        if federation is None:
            return "unknown"
        entry = federation.mesh()["peers"].get(str(peer_id))
        if entry is None:
            return "unknown"
        return str(entry.get("verdict", "unknown"))

    async def announce(self, session: WorkSession) -> int:
        """Tell every library peer the session has work; returns how
        many peers acknowledged. Announces run CONCURRENTLY — they are
        independent, and the coordinator must not stall its own pass
        behind one hung peer's retry ladder (the per-peer breaker makes
        the fan-out safe)."""
        manager = self.manager

        async def one(peer: Any) -> bool:
            pid = str(peer.identity)
            try:
                await WORK_POLICY.call(
                    pid,
                    lambda: request_work(
                        manager.p2p, peer.identity, session.library_id, {
                            "op": "announce",
                            "session": session.id,
                        }),
                )
                return True
            except (BreakerOpen, ConnectionError, OSError, EOFError,
                    asyncio.TimeoutError, PermissionError, ValueError) as e:
                logger.debug("work announce to %s failed: %s", pid, e)
                return False

        results = await asyncio.gather(
            *(one(p) for p in manager.peers_for_library(session.library_id))
        )
        return sum(results)

    async def stop(self) -> None:
        await self.worker.stop()
