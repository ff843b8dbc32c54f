"""Mesh-parallel indexing: one location's identify work, partitioned
across library peers.

Counterpart of `spacedrive_tpu/location/indexer/mesh.py`. The
coordinating node walks and saves the location locally (the walk is
metadata only; the bytes are the cost), then splits the orphan
file_paths into **journal-keyed shards**: each entry carries the
file-path key ``(materialized_path, name, ext)`` and the stat identity
``(inode, dev, mtime_ns, size)``, so every executor consults its own
index journal before reading a byte.

Execution is the same on every node (:func:`execute_shard`):

1. one batched journal consult for the shard (a hit reuses the vouched
   cas, no I/O);
2. read and batch-hash the rest on the Node's device: a card Node
   hashes through `ops.cas.cas_ids_begin`, so K1 launches, over the
   device ladder exactly as the identifier's windows do, raising where
   they raise; a CPU Node hashes on the host, through the process pool
   when it is live;
3. link objects with **deterministic pub_ids**
   (`object/file_identifier/link.py`) and write the cas and object sync
   ops, so a twice-executed shard converges;
4. vouch the journal after the sync write committed, and ship
   ``(identity, cas, chunk cache)`` back in ``complete`` so the
   coordinator's journal ends equal to a single-node pass's.

JAX's ``backend`` strings (``"auto"``, ``"cpu"``, ``"tpu"``) are the
port's ``device`` argument (a Node's ``device`` by default); no path
picks the host because the card is missing.

``distribute_location_index`` is the coordinator entry point: publish,
announce, self-steal through the task system, re-pool dead peers'
leases, done when every shard completed. Processes spanning hosts join
through ``parallel.mesh.multihost_init`` (a no-op without a cluster
environment).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
import uuid
from typing import Any

import torch

from ...files.isolated_path import full_path_from_db_row
from ...ops import cas
from ...telemetry import metrics as _tm
from ...telemetry import span
from ...telemetry.events import WORK_EVENTS
from ...tasks.task import ExecStatus, Interrupter, Task
from . import journal as _journal

logger = logging.getLogger(__name__)

#: files per shard — small enough that a slow peer's lease stays short,
#: large enough that one claim amortizes a wire round-trip
SHARD_FILES = 128


def shard_files_default() -> int:
    return int(os.environ.get("SD_WORK_SHARD_FILES", str(SHARD_FILES)))


# --- shard building (coordinator) -----------------------------------------


def build_shard_entries(library: Any, location: dict) -> list[dict]:
    """Journal-keyed entries for every orphan file_path of a location:
    identity captured here (one stat per file) so peers can journal-
    match without trusting our verdicts."""
    rows = library.db.query(
        "SELECT * FROM file_path WHERE object_id IS NULL AND cas_id IS NULL "
        "AND is_dir = 0 AND location_id = ? ORDER BY id",
        (location["id"],),
    )
    entries: list[dict] = []
    for row in rows:
        full = full_path_from_db_row(location["path"], row)
        ident = _journal.stat_identity(full)
        from ...db.database import blob_u64

        entries.append({
            "pub_id": row["pub_id"].hex(),
            "mat": row["materialized_path"],
            "name": row["name"],
            "ext": row["extension"] or "",
            "size": blob_u64(row["size_in_bytes_bytes"]) or 0,
            "identity": (
                [ident.inode, ident.dev, ident.mtime_ns, ident.size]
                if ident is not None else None
            ),
        })
    return entries


def make_session(library: Any, location: dict, *,
                 shard_files: int | None = None,
                 lease_max_s: float | None = None) -> Any:
    """Split a location's orphan entries into a published-ready
    WorkSession."""
    from ...p2p.work import LEASE_MAX_S, WorkSession, WorkShard

    entries = build_shard_entries(library, location)
    n = max(1, shard_files or shard_files_default())
    session = WorkSession(
        id=uuid.uuid4().hex,
        library_id=library.id,
        location_pub=location["pub_id"].hex(),
        lease_max_s=lease_max_s if lease_max_s is not None else LEASE_MAX_S,
    )
    for i in range(0, len(entries), n):
        shard_id = f"{session.id[:8]}-{i // n:04d}"
        session.shards[shard_id] = WorkShard(
            id=shard_id, entries=entries[i:i + n]
        )
    return session


# --- shard execution (any node) -------------------------------------------


def _pool_for_device(device: torch.device) -> Any:
    """The running process pool when this shard's hash leg is on the
    host (the pool never owns the card: a card Node keeps its batched
    dispatch), else None."""
    if device.type != "cpu":
        return None
    from ...parallel import procpool as _procpool

    return _procpool.get()


def _execute_shard_sync(library: Any, location: dict, entries: list[dict],
                        device: torch.device) -> list[dict]:
    """Worker-thread half of shard execution: journal consult → read →
    batch hash → link + vouch. Returns wire-shippable per-file results
    ``{pub_id, cas_id, ext, identity, chunks}``.

    With the multi-process plane live (``SD_PROCS`` > 0, a CPU
    device), the per-entry stat/read/chunk-digest/hash middle ships to
    pool workers in PipelinePolicy-sized quanta instead of running
    under this thread's GIL; journal consults, the sync-write commit,
    and the vouches stay on the owning process. Every pool failure
    degrades that batch to the identical inline stage function — the
    pool can slow a shard, never wrong it."""
    journal = _journal.IndexJournal(library.db)
    loc_id = location["id"]
    loc_path = location["path"]
    results: list[dict] = []
    messages: list[bytes] = []
    msg_results: list[dict] = []  # result dicts awaiting a cas
    to_record: list[tuple] = []   # journal vouches, written post-commit
    pool = _pool_for_device(device)
    # (plain entry, result, key, prior entry) per pool-shipped file
    pool_jobs: list[tuple[dict, dict, tuple, Any]] = []
    pool_bytes = 0  # expected message bytes riding the pool (span size)
    # stat pass first, then ONE batched journal consult for the whole
    # shard (a SELECT a file would be 128 round trips into SQLite for a
    # 128-entry shard)
    stats: list[tuple[dict, "_journal.Identity | None"]] = []
    for e in entries:
        row = {"materialized_path": e["mat"], "name": e["name"],
               "extension": e["ext"], "is_dir": False}
        full = full_path_from_db_row(loc_path, row)
        stats.append((e, _journal.stat_identity(full)))
    consults = journal.consult_many(loc_id, [
        ((e["mat"], e["name"], e["ext"]), ident)
        for e, ident in stats
        if ident is not None and ident.size > 0
    ])
    for e, ident in stats:
        key = (e["mat"], e["name"], e["ext"])
        row = {"materialized_path": e["mat"], "name": e["name"],
               "extension": e["ext"], "is_dir": False}
        full = full_path_from_db_row(loc_path, row)
        result = {
            "pub_id": e["pub_id"], "ext": e["ext"], "cas_id": None,
            "identity": (
                [ident.inode, ident.dev, ident.mtime_ns, ident.size]
                if ident is not None else None
            ),
            "chunks": None,
        }
        results.append(result)
        if ident is None:
            continue  # vanished/unreadable: the next walk removes it
        if ident.size == 0:
            result["cas_id"] = ""
            to_record.append((key, ident, "", None, None))
            continue
        verdict, entry = consults.get(key, (_journal.MISS, None))
        if verdict == _journal.HIT and entry.cas_id:
            result["cas_id"] = entry.cas_id
            result["chunks"] = (
                entry.chunks.to_payload() if entry.chunks is not None
                else None
            )
            journal.bytes_saved(cas.message_len(ident.size),
                                location_id=loc_id)
            continue
        if pool is not None:
            pool_jobs.append((
                {"pub_id": e["pub_id"], "mat": e["mat"],
                 "name": e["name"], "ext": e["ext"]},
                result, key, entry,
            ))
            pool_bytes += cas.message_len(ident.size)
            continue
        try:
            msg = cas.read_message(full, ident.size)
        except OSError as exc:
            logger.debug("mesh shard: unreadable %s: %s", full, exc)
            result["identity"] = None  # no vouch for an unreadable file
            continue
        messages.append(msg)
        msg_results.append(result)
        cache = cas.build_chunk_cache(msg)
        to_record.append((key, ident, result, cache, entry))
        result["chunks"] = cache.to_payload()
    if messages:
        t_hash = time.perf_counter()
        with span("mesh.shard_hash", nbytes=sum(len(m) for m in messages)):
            cas_ids = cas.cas_ids(messages, device)
        # feed the same stage series the identifier job feeds, so
        # autotune.observed_files_per_s (the lease-sizing throughput
        # self-report) stays honest about mesh-executed files too
        _tm.IDENTIFIER_STAGE_SECONDS.observe(
            time.perf_counter() - t_hash, stage="hash")
        _tm.INDEX_BYTES_HASHED.inc(sum(len(m) for m in messages))
        for result, cas_hex in zip(msg_results, cas_ids):
            result["cas_id"] = cas_hex
    if pool_jobs:
        _pool_hash(pool, loc_path, pool_jobs, to_record, pool_bytes)
    _tm.IDENTIFIER_FILES.inc(len(entries))

    # link + sync write FIRST, then the journal vouch (truth discipline:
    # a crash in between costs a redundant rehash, never a lie)
    from ...object.file_identifier.link import apply_cas_results

    t_db = time.perf_counter()
    apply_cas_results(library, results)
    records = []
    for key, ident, cas_or_result, cache, carry in to_record:
        cas_hex = (
            cas_or_result["cas_id"] if isinstance(cas_or_result, dict)
            else cas_or_result
        )
        if cas_hex is not None:  # "" = vouched-empty sentinel
            records.append((key, ident, cas_hex, cache, carry))
    journal.record_many(loc_id, records)
    _tm.IDENTIFIER_STAGE_SECONDS.observe(
        time.perf_counter() - t_db, stage="db")
    return results


def _pool_hash(pool: Any, loc_path: str, jobs: list[tuple],
               to_record: list[tuple], nbytes: int = 0) -> None:
    """Fan the shard's hash-needing entries across the process pool in
    PipelinePolicy-sized quanta, filling each entry's result dict and
    vouch record from the worker's plain reply. A batch whose pool trip
    fails (worker error past the retry budget, pool mid-shutdown) runs
    the SAME stage function inline — output is identical by
    construction, only the parallelism is lost."""
    from ...parallel import autotune as _autotune
    from ...parallel import procpool as _procpool
    from ...parallel import procworker as _procworker

    quanta = max(1, _autotune.policy("identify").procpool_batch_rows())
    batches = [jobs[i:i + quanta] for i in range(0, len(jobs), quanta)]
    futures = []
    for batch in batches:
        plain_entries = [plain for plain, _res, _key, _carry in batch]
        payload = {"loc_path": loc_path, "entries": plain_entries}
        try:
            futures.append(pool.submit(
                "identify.hash_entries", payload, rows=len(batch)))
        except _procpool.ProcPoolError:
            futures.append(None)  # degrade this batch inline below
    t_hash = time.perf_counter()
    with span("procpool.hash_entries", nbytes=nbytes):
        for batch, fut in zip(batches, futures):
            out = None
            if fut is not None:
                try:
                    out = fut.result(_procpool.REQUEST_TIMEOUT_S)["results"]
                except Exception as exc:  # noqa: BLE001 - degrade inline
                    logger.warning(
                        "procpool hash batch failed (%s); inline fallback",
                        exc)
            if out is None:
                out = _procworker._stage_hash_entries({
                    "loc_path": loc_path,
                    "entries": [p for p, _r, _k, _c in batch],
                })["results"]
            for (_plain, result, key, carry), rec in zip(batch, out):
                ident_raw = rec.get("identity")
                result["identity"] = ident_raw
                result["cas_id"] = rec.get("cas_id")
                result["chunks"] = rec.get("chunks")
                if ident_raw is None or rec.get("cas_id") is None:
                    continue  # unreadable/vanished: no vouch
                # the worker already built + validated this cache
                # (build_chunk_cache output shipped verbatim) — direct
                # construction skips a second O(chunks) validation
                cache = None
                if rec.get("chunks") is not None:
                    p = rec["chunks"]
                    cache = cas.ChunkCache(
                        p["len"], list(p["dig"]), p.get("cvs"))
                to_record.append((
                    key, _journal.Identity(*(int(x) for x in ident_raw)),
                    rec["cas_id"], cache, carry,
                ))
    # the hash leg's WALL, observed once owner-side (the worker stage
    # deliberately does not observe this series: concurrent workers'
    # per-batch times would merge to CPU-seconds and make
    # autotune.observed_files_per_s — the lease-sizing throughput
    # self-report — read a pool-accelerated node as unaccelerated)
    _tm.IDENTIFIER_STAGE_SECONDS.observe(
        time.perf_counter() - t_hash, stage="hash")


async def resolve_location(library: Any, location_pub: str | None) -> dict:
    """Wait for a session's location row to exist on this replica. The
    row syncs like any other; a replica that has not ingested it yet
    nudges its ingest actor and waits briefly — a still-missing
    location raises, the caller skips, and the lease expires back to
    the pool. Shared by every stage executor (identify here, the rest
    in ``stages.py``)."""
    location = None
    loc_pub_bytes = bytes.fromhex(location_pub) if location_pub else None
    for attempt in range(20):
        if loc_pub_bytes is not None:
            location = library.db.find_one("location", pub_id=loc_pub_bytes)
        if location is not None and location.get("path"):
            break
        # the location create op may still be in flight: pull now
        actor = getattr(library, "ingest", None)
        if actor is not None:
            actor.notify()
        await asyncio.sleep(0.05)
    if location is None or not location.get("path"):
        raise RuntimeError(f"location {location_pub} not replicated here yet")
    return location


def shard_device(node: Any, device: str | torch.device | None) -> torch.device:
    """The device a shard runs on: the one asked for, else the Node's."""
    return torch.device(device if device is not None else node.device)


async def execute_shard(node: Any, library: Any, location_pub: str | None,
                        entries: list[dict],
                        device: str | torch.device | None = None) -> list[dict]:
    """Execute one identify shard against this node's replica (the
    stage-generic entry point is ``stages.execute_stage_shard``)."""
    location = await resolve_location(library, location_pub)
    return await asyncio.to_thread(
        _execute_shard_sync, library, location, entries, shard_device(node, device)
    )


class ShardTask(Task):
    """Local shard execution as a task-system unit: the coordinator's
    self-steal loop dispatches these so queue-wait/occupancy telemetry
    and priority preemption cover mesh work like any other work. Stage-
    typed: the task routes to its shard's execution leg."""

    def __init__(self, node: Any, library: Any, location_pub: str,
                 entries: list[dict], device: str | torch.device | None = None,
                 stage: str = "identify.hash"):
        super().__init__()
        self.node = node
        self.library = library
        self.location_pub = location_pub
        self.entries = entries
        self.device = device
        self.stage = stage
        self.output: list[dict] | None = None

    async def run(self, interrupter: Interrupter) -> ExecStatus:
        if interrupter.check() is not None:
            return ExecStatus.CANCELED
        from .stages import execute_stage_shard

        self.output = await execute_stage_shard(
            self.node, self.library, self.location_pub, self.stage,
            self.entries, self.device,
        )
        return ExecStatus.DONE


# --- result merge (coordinator, from `complete` bodies) -------------------


def apply_remote_results(node: Any, session: Any, results: list[dict]) -> int:
    """Merge a peer's shipped shard results into this node's replica:
    cas/object rows via the idempotent linker, then journal vouches
    keyed by the identity the executor hashed under — the coordinator's
    journal converges to what a single-node pass would have written,
    without waiting for the peer's sync ops."""
    library = node.libraries.get(session.library_id)
    if library is None:
        return 0
    location = library.db.find_one(
        "location", pub_id=bytes.fromhex(session.location_pub)
    )
    if location is None:
        return 0
    from ...object.file_identifier.link import apply_cas_results

    clean = [r for r in results if isinstance(r, dict)]
    # emit_ops=False: the executing peer already minted the CRDT ops
    # (before its complete) — this is the direct-apply fast path, sync
    # remains the authoritative carrier
    apply_cas_results(library, clean, emit_ops=False)
    journal = _journal.IndexJournal(library.db)
    records = []
    for r in clean:
        ident_raw = r.get("identity")
        cas_hex = r.get("cas_id")
        if ident_raw is None or cas_hex is None:
            continue
        try:
            ident = _journal.Identity(*(int(x) for x in ident_raw))
        except (TypeError, ValueError):
            continue
        chunks = None
        if r.get("chunks") is not None:
            chunks = cas.ChunkCache.from_payload(r["chunks"])
        row = library.db.find_one(
            "file_path", pub_id=bytes.fromhex(str(r["pub_id"]))
        )
        if row is None or row.get("materialized_path") is None:
            continue  # create op not applied yet; peer's vouch suffices
        records.append((_journal.key_of(row), ident, cas_hex, chunks, None))
    journal.record_many(location["id"], records)
    return len(records)


# --- the coordinator loop -------------------------------------------------


async def distribute_location_index(
    node: Any,
    library: Any,
    location_id: int,
    *,
    shard_files: int | None = None,
    lease_max_s: float | None = None,
    device: str | torch.device | None = None,
    run_indexer: bool = True,
    deadline_s: float = 600.0,
) -> dict[str, Any]:
    """Walk locally, partition the identify work, and drive it to
    completion across the mesh. Returns pass stats (shards by executor,
    files, seconds). Degrades to a plain local pass when no peers are
    reachable — announce failures and refused claims only mean every
    shard ends up self-stolen."""
    from ...parallel.mesh import multihost_init

    t0 = time.perf_counter()
    location = library.db.find_one("location", id=location_id)
    if location is None or not location.get("path"):
        raise ValueError(f"location {location_id} not found")

    if run_indexer:
        from ...jobs.manager import JobBuilder
        from .job import IndexerJob

        await JobBuilder(IndexerJob({"location_id": location_id})).spawn(
            node.jobs, library
        )
        await node.jobs.wait_idle()

    # processes spanning hosts join the torch.distributed group the
    # environment names (a no-op on one host); where a shard hashes is
    # still the Node's device
    multihost_init()

    session = make_session(
        library, location, shard_files=shard_files, lease_max_s=lease_max_s
    )
    return await _drive_session(
        node, library, session, device=device, deadline_s=deadline_s,
        t0=t0,
    )


async def distribute_location_stages(
    node: Any,
    library: Any,
    location_id: int,
    stage_ids: list[str],
    *,
    shard_files: int | None = None,
    lease_max_s: float | None = None,
    device: str | torch.device | None = None,
    deadline_s: float = 600.0,
) -> dict[str, Any]:
    """Distribute any set of post-identify pipeline stages for one
    location as ONE multi-stage session (stage ids from
    ``parallel/scheduler.py``). The stage drivers' distribute paths
    (thumbnail actor, media processor, duplicates pHash, embed) are
    thin wrappers over this. Degrades exactly like
    ``distribute_location_index``: with no P2P runtime every stage
    shard runs inline here, which IS today's pure-local pass in shard
    clothing."""
    from .stages import make_stage_session

    t0 = time.perf_counter()
    location = library.db.find_one("location", id=location_id)
    if location is None or not location.get("path"):
        raise ValueError(f"location {location_id} not found")
    session = make_stage_session(
        library, location, stage_ids,
        shard_files=shard_files, lease_max_s=lease_max_s,
    )
    return await _drive_session(
        node, library, session, device=device, deadline_s=deadline_s,
        t0=t0,
    )


async def _drive_session(
    node: Any, library: Any, session: Any, *,
    device: str | torch.device | None, deadline_s: float, t0: float,
) -> dict[str, Any]:
    """Drive a published-ready session to completion: publish →
    announce → self-steal through the task system → retire. Shared by
    the identify pass and the stage-typed distribute paths."""
    from .stages import execute_stage_shard

    manager = getattr(node, "p2p", None)
    plane = getattr(manager, "work", None)
    total_files = sum(len(s.entries) for s in session.shards.values())
    by_stage: dict[str, int] = {}
    for sh in session.shards.values():
        by_stage[sh.stage] = by_stage.get(sh.stage, 0) + 1
    # with the multi-process plane live, the coordinator keeps several
    # shards in flight at once: one shard's owner-side SQL commit
    # overlaps another's worker-side hashing. SD_PROCS=0 keeps today's
    # strictly sequential self-steal (the golden path).
    from ...parallel import procpool as _procpool

    width = _procpool.procs() if _procpool.get() is not None else 1
    if plane is None:
        # no P2P runtime: run every shard inline (still shard-shaped so
        # the journal/link/vouch path is identical)
        if width > 1:
            sem = asyncio.Semaphore(width)

            async def _one_inline(shard: Any) -> None:
                async with sem:
                    await execute_stage_shard(
                        node, library, session.location_pub,
                        shard.stage, shard.entries, device,
                    )

            await asyncio.gather(*(
                _one_inline(s) for s in session.shards.values()
            ))
        else:
            for shard in session.shards.values():
                await execute_stage_shard(
                    node, library, session.location_pub, shard.stage,
                    shard.entries, device,
                )
        return {
            "session": session.id, "shards": len(session.shards),
            "files": total_files, "local_shards": len(session.shards),
            "remote_shards": 0, "peers": {}, "stages": by_stage,
            "seconds": round(time.perf_counter() - t0, 3),
        }

    plane.board.publish(session)
    acks = await plane.announce(session)
    WORK_EVENTS.emit("distribute_start", session=session.id,
                     shards=len(session.shards), peers_acked=acks)

    deadline = time.monotonic() + deadline_s
    local_shards = 0
    try:
        while not session.all_done():
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"mesh session {session.id} incomplete after "
                    f"{deadline_s}s ({session.pending()} shards pending)"
                )
            _session, grant, _lease = plane.board.claim(
                session.id, "local", max_shards=width, local=True,
            )
            if not grant:
                # everything is leased out (or done): wait for completes
                # / lease expiries; expire_leases runs inside claim()
                await asyncio.sleep(0.05)
                continue
            # normally one shard (`width` with the process pool live —
            # the execute leg keeps every pool worker fed); an injected
            # claim race can append a duplicate-leased one — execute
            # everything granted so a shard re-leased to "local"
            # (exempt from expiry) can never strand
            handles = [
                (shard, node.task_system.dispatch(ShardTask(
                    node, library, session.location_pub, shard.entries,
                    device, stage=shard.stage,
                )))
                for shard in grant
            ]
            for shard, handle in handles:
                result = await handle.wait()
                if result.error is not None:
                    raise result.error
                outcome = plane.board.complete(
                    session.id, shard.id, "local", local=True
                )
                if outcome == "completed":
                    local_shards += 1
    finally:
        # success or abandonment: drop the session from the board — the
        # shard entry lists duplicate the location's file metadata, and
        # a nightly coordinator must not accumulate one copy per pass
        # (workers see "done" and stop; late results still ride sync)
        plane.board.retire(session.id)

    by_peer: dict[str, int] = {}
    for shard_id, pid in session.completed_by.items():
        from ...telemetry.peers import peer_label

        label = "local" if pid == "local" else peer_label(pid)
        by_peer[label] = by_peer.get(label, 0) + 1
    stats = {
        "session": session.id,
        "shards": len(session.shards),
        "files": total_files,
        "local_shards": local_shards,
        "remote_shards": len(session.shards) - local_shards,
        "peers": by_peer,
        "stages": by_stage,
        "seconds": round(time.perf_counter() - t0, 3),
    }
    WORK_EVENTS.emit(
        "distribute_done",
        session=stats["session"],
        shards=stats["shards"],
        files=stats["files"],
        remote=stats["remote_shards"],
    )
    return stats
