"""Sync ingest actor — applying remote op streams.

Parity: ref:core/crates/sync/src/ingest.rs — a per-library actor with
the state machine WaitingForNotification → RetrievingMessages →
Ingesting (:49-93); `receive_crdt_operation` merges the remote HLC
timestamp, rejects old ops per (model, record, field) LWW, applies the
op and stores it in one transaction (:120-166); `is_operation_old`
(:169-192) consults the stored op log. Backfill parity:
ref:core/crates/sync/src/backfill.rs (generate ops for rows that
predate sync).

The transport is injected: `request_ops(timestamps, count)` is any
async callable — loopback queues in tests, the P2P sync exchange or the
cloud relay in production (ref:core/src/p2p/sync/mod.rs:22-70).

Counterpart of `spacedrive_tpu/sync/ingest.py`: the same ops apply to
the same rows and op log, with the same metrics, spans, flight-recorder
events, tenant counts and `sync.ingest` fault point; the write-combining
quantum is the serve policy's `sync_txn_ops` (serve/policy.py).
"""

from __future__ import annotations

import asyncio
import collections
import enum
import functools
import logging
import os
import time
import uuid
from typing import Any, Awaitable, Callable

from ..telemetry import metrics as _tm
from ..telemetry import span as _span
from ..telemetry import tenants as _tenants
from ..telemetry import trace as _trace
from ..telemetry.events import SYNC_EVENTS
from ..telemetry.peers import peer_label
from .apply import apply_op
from .crdt import CRDTOperation, DELETE
from .hlc import ClockDriftError, NTP64
from .manager import SyncManager, _record_id_blob

logger = logging.getLogger(__name__)

OPS_PER_REQUEST = 1000  # ref:core/src/cloud/sync/ingest.rs:21

# an instance's metric label, once per instance (a pure function of it)
_peer = functools.lru_cache(maxsize=1024)(peer_label)

# request_ops(timestamps, count) -> (ops, has_more)
RequestOps = Callable[
    [list[tuple[uuid.UUID, NTP64]], int],
    Awaitable[tuple[list[CRDTOperation], bool]],
]


# Global LWW order: (HLC timestamp, instance pub_id). is_operation_old and
# the delete re-apply query MUST use the same predicate or equal-timestamp
# delete/update races diverge by arrival order. Bind params:
# (timestamp, timestamp, pub_id).
_LWW_NEWER_SQL = (
    "(co.timestamp > ? OR (co.timestamp = ? AND i.pub_id > ?))"
)


class State(enum.Enum):
    WAITING_FOR_NOTIFICATION = "waiting"
    RETRIEVING_MESSAGES = "retrieving"
    INGESTING = "ingesting"


def is_operation_old(sync: SyncManager, op: CRDTOperation) -> bool:
    """True if a stored op for the same (model, record) supersedes
    `op` — same-field update or any delete that is strictly newer in
    the global LWW order (HLC timestamp, instance pub_id), the same
    order the delete re-apply path and the property-test oracle use
    (ref:ingest.rs:169-192). An exact echo (same timestamp, same
    instance) is not selected and re-applies idempotently."""
    rows = sync.db.query(
        "SELECT co.kind FROM crdt_operation co "
        "JOIN instance i ON i.id = co.instance_id "
        "WHERE co.model = ? AND co.record_id = ? AND " + _LWW_NEWER_SQL,
        (op.model, _record_id_blob(op.record_id), int(op.timestamp),
         int(op.timestamp), op.instance.bytes),
    )
    mine = op.kind()
    for row in rows:
        if row["kind"] == DELETE or row["kind"] == mine:
            return True
    return False


# per-op ingest outcomes (finalized only after the transaction that
# stored them committed)
_APPLIED, _TOMBSTONE, _STALE, _GUARD = "applied", "tombstone", "stale", "guard"


def _guard_op(sync: SyncManager, op: CRDTOperation,
              skew: float) -> str | None:
    """Delta-guard + fault-plane check, NO DB access — returns the
    rejection reason when the op is refused, else None (proceed). A
    guard trip rejects *that op* — counted and flight-recorded by
    :func:`_finalize_guard` — instead of poisoning the whole batch, and
    the watermark deliberately does NOT advance past it."""
    from ..utils import faults as _faults

    if _faults.hit("sync.ingest") is not None:
        # "poison": this op reads as a clock-skew-burst casualty — it is
        # rejected exactly like a real delta-guard trip so the peer's
        # later legitimate ops are re-pulled and convergence survives
        return "injected poisoned op"
    try:
        sync.clock.update(op.timestamp)
    except ClockDriftError as e:
        return str(e)[:200]
    return None


def _receive_into(sync: SyncManager, op: CRDTOperation, conn) -> str:
    """LWW-check + apply + store on the CALLER's transaction — the
    write-combined core. No watermark/metric side effects here: a
    rolled-back transaction must not leave the in-memory view claiming
    ops it never stored (:func:`_finalize_chunk` runs post-commit)."""
    if is_operation_old(sync, op):
        return _STALE
    iid = _ensure_instance_conn(sync, op.instance, conn)
    apply_op(conn, op)
    if op.data.kind == DELETE:
        # Determinism under delete/update races: the row must be
        # a pure function of the op SET, not arrival order. A
        # delete may arrive after updates that are HLC-newer
        # than it (which is_operation_old can't reject — kinds
        # differ); re-applying the stored newer ops rebuilds
        # exactly the state the other arrival order produces.
        # (The reference resurrects-by-upsert and genuinely
        # diverges here; found by tests/test_sync_properties.)
        # "Newer" means the full LWW order (timestamp, instance
        # pub_id) — a same-timestamp op from a higher instance id
        # also supersedes this delete.
        newer = conn.execute(
            "SELECT co.data FROM crdt_operation co "
            "JOIN instance i ON i.id = co.instance_id "
            "WHERE co.model = ? AND co.record_id = ? "
            "AND " + _LWW_NEWER_SQL +
            " ORDER BY co.timestamp ASC, i.pub_id ASC",
            (op.model, _record_id_blob(op.record_id),
             int(op.timestamp), int(op.timestamp),
             op.instance.bytes),
        ).fetchall()
        for row in newer:
            raw = row["data"] if isinstance(row, dict) else row[0]
            apply_op(conn, CRDTOperation.unpack(raw))
    conn.execute(
        "INSERT OR REPLACE INTO crdt_operation "
        "(id, timestamp, model, record_id, kind, data, instance_id) "
        "VALUES (?, ?, ?, ?, ?, ?, ?)",
        (
            op.id.bytes,
            int(op.timestamp),
            op.model,
            _record_id_blob(op.record_id),
            op.kind(),
            op.pack(),
            iid,
        ),
    )
    return _TOMBSTONE if op.data.kind == DELETE else _APPLIED


def _finalize_guard(op: CRDTOperation, skew: float,
                    guard_error: str | None) -> None:
    """Bookkeeping for a guard-rejected op: counted and flight-recorded,
    and the watermark deliberately NOT advanced past it: this path
    carries no commit to vouch for."""
    _tm.HLC_DELTA_GUARD.inc()
    SYNC_EVENTS.emit(
        "delta_guard",
        peer=peer_label(op.instance),
        skew_seconds=round(skew, 3),
        error=guard_error or "delta guard",
    )


def receive_crdt_operation(sync: SyncManager, op: CRDTOperation) -> bool:
    """Merge clock, LWW-check, apply + store atomically; returns True if
    the op was applied (ref:ingest.rs:120-166). One op = one
    transaction — the write-combined batch path is
    :func:`ingest_batch`."""
    # observed skew: remote op's HLC time vs our wall clock (positive =
    # remote ahead)
    skew = op.timestamp.as_unix() - time.time()
    guard_error = _guard_op(sync, op, skew)
    if guard_error is not None:
        outcome = _GUARD
    else:
        with sync.db.transaction() as conn:
            outcome = _receive_into(sync, op, conn)
    _finalize_chunk(sync, [(op, outcome, skew, guard_error)])
    return outcome in (_APPLIED, _TOMBSTONE)


def ingest_txn_quantum() -> int:
    """Ops coalesced per SQLite transaction by the ingest actor. 1 (the
    historical op-per-transaction behavior) when write combining is off
    (``SD_SYNC_WRITE_COMBINE=0``) or the serve layer is disabled
    (``SD_SERVE_GATE=0`` reproduces pre-serve behavior exactly); else
    the serve policy's ``sync_txn_ops``. Results do not depend on it:
    only the number of transactions does."""
    from ..serve import enabled as _serve_enabled
    from ..serve import policy as _serve_policy

    if not _serve_enabled() or os.environ.get(
        "SD_SYNC_WRITE_COMBINE", "1"
    ) == "0":
        return 1
    return max(1, int(_serve_policy().sync_txn_ops))


def ingest_batch(
    sync: SyncManager, ops: list[CRDTOperation], txn_ops: int | None = None,
) -> list[bool]:
    """Write-combined ingest: apply+store ``ops`` in chunks of
    ``txn_ops`` per SQLite transaction instead of one transaction per
    op, so replication keeps converging while interactive reads hammer
    the same file. Per-op outcomes (applied/True, rejected/False) come
    back in order; watermarks/metrics are finalized strictly AFTER each
    chunk's commit, so a rolled-back chunk never advances the in-memory
    view past ops that were not stored.

    Failure isolation: a chunk whose shared transaction raises is
    rolled back and retried op-per-transaction (the pre-combining
    path), so one malformed op costs its own rejection, never its
    neighbors'. ``sd_sync_txn_combined_total`` counts the per-op
    transactions avoided."""
    quantum = ingest_txn_quantum() if txn_ops is None else max(1, txn_ops)
    results: list[bool] = []
    for start in range(0, len(ops), quantum):
        chunk = ops[start:start + quantum]
        if quantum == 1 or len(chunk) == 1:
            for op in chunk:
                results.append(receive_crdt_operation(sync, op))
            continue
        metas: list[tuple[CRDTOperation, str, float, str | None]] = []
        try:
            with sync.db.transaction() as conn:
                for op in chunk:
                    skew = op.timestamp.as_unix() - time.time()
                    guard_error = _guard_op(sync, op, skew)
                    if guard_error is not None:
                        outcome = _GUARD
                    else:
                        outcome = _receive_into(sync, op, conn)
                    metas.append((op, outcome, skew, guard_error))
        except Exception:
            logger.exception(
                "write-combined ingest chunk failed; retrying per-op"
            )
            for op in chunk:
                try:
                    results.append(receive_crdt_operation(sync, op))
                except Exception:
                    logger.exception("op %s rejected after chunk rollback",
                                     op.id)
                    results.append(False)
            continue
        _finalize_chunk(sync, metas)
        results.extend(outcome in (_APPLIED, _TOMBSTONE) for _, outcome, _, _ in metas)
        _tm.SYNC_TXN_COMBINED.inc(len(chunk) - 1)
    return results


def _finalize_chunk(sync: SyncManager,
                    metas: list[tuple[CRDTOperation, str, float, str | None]]) -> None:
    """Post-commit bookkeeping for one committed chunk (a single op is a
    chunk of one), in its order: guard rejections through
    `_finalize_guard`; for the rest the outcome counters, the tenant
    counts and the watermarks, which advance even for stale ops (they
    are *seen*). Callers MUST order this strictly after the transaction
    that stored the chunk committed. Each series is written once a chunk
    with the value JAX's op-by-op writes end on (the skew and watermark
    gauges per peer, the outcome counts), and a run of one instance's
    ops is observed by the tenant plane at once, which leaves its sketch
    as one observation each would."""
    outcomes: collections.Counter[str] = collections.Counter()
    skews: dict[uuid.UUID, float] = {}
    advanced: dict[uuid.UUID, NTP64] = {}
    run, run_n = None, 0
    for op, outcome, skew, guard_error in metas:
        skews[op.instance] = skew
        if outcome == _GUARD:
            _finalize_guard(op, skew, guard_error)
            continue
        outcomes["tombstone" if outcome == _TOMBSTONE
                 else "applied" if outcome == _APPLIED else "stale"] += 1
        if op.instance != run:
            if run_n:
                _tenants.observe("ingest", run, run_n)
            run, run_n = op.instance, 0
        run_n += 1
        if op.timestamp > sync.timestamps.get(op.instance, NTP64(0)):
            sync.timestamps[op.instance] = op.timestamp
            if op.instance != sync.instance:
                advanced[op.instance] = op.timestamp
    if run_n:
        _tenants.observe("ingest", run, run_n)
    for result, n in outcomes.items():
        _tm.SYNC_OPS.inc(n, result=result)
    for inst, ts in advanced.items():
        _tm.SYNC_WATERMARK.set(ts.as_unix(), peer=_peer(inst))
    for inst, skew in skews.items():
        _tm.HLC_CLOCK_SKEW.set(skew, peer=_peer(inst))


def _ensure_instance_conn(sync: SyncManager, instance: uuid.UUID,
                          conn) -> int:
    """Resolve (or placeholder-create) the op's originating instance row
    on the CALLER's open transaction — opening a nested implicit
    transaction from inside a write-combined chunk would commit the
    outer one mid-flight. The pairing flow fills in identity/metadata
    for placeholder rows later."""
    row = conn.execute(
        "SELECT id FROM instance WHERE pub_id = ?", (instance.bytes,)
    ).fetchone()
    if row is not None:
        return row["id"] if isinstance(row, dict) else row[0]
    from ..db.database import now_iso

    now = now_iso()
    cur = conn.execute(
        "INSERT INTO instance (pub_id, identity, node_id, node_name, "
        "node_platform, last_seen, date_created) VALUES (?,?,?,?,?,?,?)",
        (instance.bytes, b"", b"", "", 0, now, now),
    )
    return cur.lastrowid


class IngestActor:
    """One per library; drives the pull side of sync."""

    def __init__(
        self,
        sync: SyncManager,
        request_ops: RequestOps,
        ops_per_request: int = OPS_PER_REQUEST,
        poll_interval: float | None = 30.0,
        on_applied: Callable[[], Any] | None = None,
    ):
        self.sync = sync
        self.request_ops = request_ops
        self.ops_per_request = ops_per_request
        # fired after any batch that APPLIED at least one op — the serve
        # layer's sync-side cache invalidation hook (p2p.manager wires
        # it to drop the library's cached reads)
        self.on_applied = on_applied
        # anti-entropy: tick even without a notification so a lost alert
        # (peer discovered late, dropped datagram) only delays, never
        # strands, convergence; None disables (tests with loopback queues)
        self.poll_interval = poll_interval
        self.state = State.WAITING_FOR_NOTIFICATION
        self.applied = 0
        self.rejected = 0
        # last op outcome, for accept/reject transition events (True so
        # a batch that opens with a reject records the transition)
        self._last_op_accepted = True
        self._notify = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._stopped = False
        self._idle = asyncio.Event()
        self._idle.set()
        # trace of the most recent notifier (a p2p SYNC header): the
        # pull it triggers reports into the initiating node's trace
        self._notify_trace: "_trace.TraceContext | None" = None

    # --- actor API (ref:ingest.rs Event::Notification) ---
    def notify(self, trace_ctx: "_trace.TraceContext | None" = None) -> None:
        if trace_ctx is not None:
            self._notify_trace = trace_ctx
        self._notify.set()
        self._ensure_started()

    def _ensure_started(self) -> None:
        if self._stopped:
            return
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="sync-ingest"
            )

    async def stop(self) -> None:
        self._stopped = True
        self._notify.set()
        if self._task is not None:
            try:
                await asyncio.wait_for(self._task, timeout=10)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                self._task.cancel()

    async def wait_idle(self) -> None:
        """Settle: no notification pending and the tick loop is parked."""
        self._ensure_started()
        while not self._idle.is_set() or self._notify.is_set():
            await self._idle.wait()
            if self._notify.is_set():
                # notification not yet picked up by the loop; yield
                await asyncio.sleep(0.01)

    # --- state machine (ref:ingest.rs:49-93) ---
    async def _run(self) -> None:
        waited = 0.0
        while not self._stopped:
            self.state = State.WAITING_FOR_NOTIFICATION
            try:
                await asyncio.wait_for(self._notify.wait(), timeout=1.0)
            except asyncio.TimeoutError:
                waited += 1.0
                if self.poll_interval is None or waited < self.poll_interval:
                    continue
                # anti-entropy tick: pull despite no notification
            if self._stopped:
                break
            waited = 0.0
            self._notify.clear()
            self._idle.clear()
            tick_trace, self._notify_trace = self._notify_trace, None
            try:
                with _trace.use(tick_trace):
                    await self._tick()
            except Exception:
                logger.exception("sync ingest tick failed")
            finally:
                self._idle.set()

    async def _tick(self) -> None:
        while not self._stopped:
            self.state = State.RETRIEVING_MESSAGES
            timestamps = list(self.sync.timestamps.items())
            with _span("sync.request"):
                ops, has_more = await self.request_ops(
                    timestamps, self.ops_per_request
                )
            self.state = State.INGESTING
            if ops:
                _tm.SYNC_INGEST_BACKLOG.set(len(ops))
                batch_applied = batch_rejected = 0
                quantum = ingest_txn_quantum()
                with _span("sync.ingest"):
                    # write-combined: `quantum` ops share one SQLite
                    # transaction (ingest_batch), and the loop yields
                    # between windows — a 1000-op batch is seconds of
                    # synchronous SQLite work that must not freeze the
                    # event loop the API, the work-stealing plane, and
                    # the loop-lag monitor all share
                    window = max(64, quantum)
                    for start in range(0, len(ops), window):
                        if start:
                            await asyncio.sleep(0)
                        chunk = ops[start:start + window]
                        outcomes = ingest_batch(
                            self.sync, chunk, txn_ops=quantum
                        )
                        for i, (op, ok) in enumerate(
                            zip(chunk, outcomes), start=start
                        ):
                            if ok:
                                self.applied += 1
                                batch_applied += 1
                            else:
                                self.rejected += 1
                                batch_rejected += 1
                            # flight-record accept↔reject TRANSITIONS
                            # (not per-op emits): the ring captures when
                            # a stream of applies turns into rejects and
                            # vice versa
                            if ok != self._last_op_accepted:
                                self._last_op_accepted = ok
                                if ok:
                                    SYNC_EVENTS.emit(
                                        "accept_resume",
                                        peer=peer_label(op.instance),
                                        batch_index=i,
                                    )
                                else:
                                    SYNC_EVENTS.emit(
                                        "reject_start",
                                        peer=peer_label(op.instance),
                                        batch_index=i,
                                    )
                _tm.SYNC_INGEST_BACKLOG.set(0)
                SYNC_EVENTS.emit(
                    "ingest_batch",
                    applied=batch_applied,
                    rejected=batch_rejected,
                    has_more=bool(has_more),
                )
                self.sync.observe_replication_lag()
                if batch_applied and self.on_applied is not None:
                    try:
                        self.on_applied()
                    except Exception:  # noqa: BLE001 - invalidation is best-effort
                        logger.exception("ingest on_applied hook failed")
            if ops and self.sync.event_bus is not None:
                self.sync.event_bus.emit(("SyncMessage", "Ingested"))
            if not has_more:
                break


# --- backfill (ref:core/crates/sync/src/backfill.rs) ---------------------

#: rows examined (and ops flushed) per backfill batch — the whole pass
#: is bounded-memory at any table size: one batch of rows, one covered
#: membership probe, one write_ops flush, repeat
BACKFILL_BATCH = 1024


def backfill_operations(sync: SyncManager) -> int:
    """Emit create+update ops for every syncable row that has no op log
    yet (a library that predates sync, or was seeded directly). Returns
    the number of ops written.

    Bounded-memory by construction: rows stream through a rowid cursor
    in :data:`BACKFILL_BATCH` chunks, coverage is probed per chunk with
    an ``IN (...)`` membership query (never a full DISTINCT set — a
    million-row op log must not materialize in Python), and ops flush
    per chunk. Callers run this off the event loop (``to_thread``); the
    cursor shape keeps each SQLite lock hold short either way."""
    from ..db.sync_registry import SYNC_MODELS, SyncKind

    written = 0
    for model in SYNC_MODELS.values():
        if model.kind is SyncKind.LOCAL:
            continue
        last_rowid = -1
        while True:
            rows = sync.db.query(
                f"SELECT rowid AS _backfill_rid, * FROM {model.name} "
                "WHERE rowid > ? ORDER BY rowid LIMIT ?",
                (last_rowid, BACKFILL_BATCH),
            )
            if not rows:
                break
            last_rowid = rows[-1]["_backfill_rid"]
            pending: list[tuple[Any, Any, dict]] = []
            for row in rows:
                row = {k: v for k, v in row.items()
                       if k != "_backfill_rid"}
                record_id = _row_sync_id(sync, model, row)
                if record_id is None:
                    continue
                pending.append((_record_id_blob(record_id), record_id,
                                row))
            if not pending:
                continue
            # membership probe scoped to THIS chunk's ids — the no-op
            # case (backfill on every pairing accept) stays O(rows
            # scanned), with nothing accumulated across chunks
            qmarks = ",".join("?" for _ in pending)
            covered = {
                r["record_id"]
                for r in sync.db.query(
                    "SELECT record_id FROM crdt_operation "
                    f"WHERE model = ? AND record_id IN ({qmarks})",
                    (model.name, *[blob for blob, _, _ in pending]),
                )
            }
            ops: list[CRDTOperation] = []
            for blob, record_id, row in pending:
                if blob in covered:
                    continue
                values = _row_sync_values(sync, model, row)
                if model.kind is SyncKind.SHARED:
                    ops.extend(
                        sync.shared_create(model.name, record_id, values))
                else:
                    ops.extend(
                        sync.relation_create(model.name, record_id,
                                             values))
            if ops:
                sync.write_ops(ops)
                written += len(ops)
            if len(rows) < BACKFILL_BATCH:
                break
    return written


def _row_sync_id(sync: SyncManager, model, row) -> Any:
    from ..db.sync_registry import SyncKind

    if model.kind is SyncKind.RELATION:
        item = _fk_sync_id(sync, model.item, row[model.item.column])
        group = _fk_sync_id(sync, model.group, row[model.group.column])
        if item is None or group is None:
            return None
        return {"item": item, "group": group}
    if model.id_ref is not None:
        return _fk_sync_id(sync, model.id_ref, row[model.id_ref.column])
    v = row[model.id_field]
    if v is None:
        return None
    return v.hex() if isinstance(v, (bytes, bytearray)) else v


def _fk_sync_id(sync: SyncManager, fr, local_id) -> Any:
    if local_id is None:
        return None
    target = sync.db.find_one(fr.table, id=local_id)
    if target is None:
        return None
    v = target[fr.target_id_field]
    return v.hex() if isinstance(v, (bytes, bytearray)) else v


def _row_sync_values(sync: SyncManager, model, row) -> list[tuple[str, Any]]:
    """Synced (field, wire-value) pairs for a backfilled row."""
    from ..db.database import blob_u64
    from .apply import _U64_COLUMNS

    skip = {"id", model.id_field, *(model.local_fields or ())}
    if model.kind.name == "RELATION":
        skip |= {model.item.column, model.group.column}
    fk_cols = {fr.column: fr for fr in model.foreign_refs}
    if model.id_ref is not None:
        skip.add(model.id_ref.column)
    values = []
    for col, v in row.items():
        if col in skip or v is None:
            continue
        if col in fk_cols:
            v = _fk_sync_id(sync, fk_cols[col], v)
            if v is None:
                continue
        elif col in _U64_COLUMNS.get(model.name, ()):
            v = blob_u64(v)
        elif isinstance(v, (bytes, bytearray)):
            v = bytes(v).hex() if col == "pub_id" else bytes(v)
        values.append((col, v))
    return values
