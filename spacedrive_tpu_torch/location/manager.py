"""Location manager — per-location watchers + event application.

Parity: ref:core/src/location/manager/mod.rs:36-60 — an actor that
(un)registers locations for watching, can pause/resume a location's
watcher (used by fs-ops jobs to ignore their own writes), holds an
ignore-path set, and applies normalized watcher events to the library
DB (watcher/utils.rs, 1,072 LoC):

- RENAME → rewrite the file_path row (and the whole subtree's
  materialized_paths for directories) — precise, no rescan;
- REMOVE → delete the row/subtree;
- CREATE/MODIFY → debounced shallow rescan of the affected parent dirs
  (`light_scan_location`), which batches the new/changed files into the
  indexer → identifier (cas_id on the device) → media pipeline. The reference
  applies per-file inline updates; routing through the shallow-scan job
  chain instead keeps device work batched.

Counterpart of `spacedrive_tpu/location/manager.py`. The rescans run on
the node's device (`backend=str(node.device)`: a Node on "cpu" rescans
on the CPU, one on "cuda:1" on that card). Where it differs from JAX's,
it keeps the watched state equal to a full rescan's:

- a fs-ops job pauses the paths it writes, not the location: their
  events are dropped as the watcher reads them, and `resume` first
  reads what the kernel queued meanwhile (`watcher.drain()`), so the
  eraser's overwrite passes start no rescan while a user's write
  elsewhere in the location is applied; the JAX manager tests the pause
  when the handler task runs, after the job's synchronous step has
  already resumed the location;
- the parent of a directory that appears is walked shallowly by an
  IndexerJob alone, which writes the directory's own row (the deep
  rescan of the directory writes only what lies below it; a full chain
  on the parent would identify the parent's whole subtree beside the
  deep rescan);
- a rename, a remove or a resume (none of which starts a rescan) marks
  the directories it changed, and the flush sets the sizes of those
  directories and their ancestors, each the sum of its children's, and
  the location's from the root's children: what the indexer's full
  roll-up at the end of a scan leaves there;
- a burst's quiet time runs from the end of a rename's apply, so a
  directory of many rows does not split the storm it belongs to;
- a directory's subtree rows are rewritten in one transaction (JAX
  commits each row: seconds on a directory of 16k files, on the event
  loop).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any

from ..db.database import blob_u64, now_iso, u64_blob
from ..files.isolated_path import IsolatedFilePathData
from ..jobs import JobBuilder
from ..telemetry.events import WATCHER_EVENTS
from ..utils.tasks import supervise
from .indexer.job import IndexerJob
from .indexer.journal import IndexJournal, key_of, stat_identity
from .locations import deep_rescan_sub_path, light_scan_location
from .watcher import EventKind, WatchEvent, new_watcher

logger = logging.getLogger(__name__)

DEBOUNCE = 0.2  # event settle window before shallow rescans fire
# Journal-verdict-driven debounce sizing: a burst
# whose events the index journal still vouches for — rename storms
# (vouches MOVE, zero re-work) and touch storms (stat identity
# unchanged) — needs consolidation, not per-event rescans, so the
# settle window widens with the vouched count, up to DEBOUNCE_MAX. A
# burst of real content changes keeps the snappy base window.
DEBOUNCE_MAX = 2.0
DEBOUNCE_WIDEN_MIN = 4  # vouched events before the window starts widening


@dataclass
class _Watched:
    library: Any
    location: dict[str, Any]
    watcher: Any
    paused: list[str] = field(default_factory=list)  # paths paused jobs write, one per pause()
    dirty_dirs: set[str] = field(default_factory=set)  # shallow rescan targets
    deep_dirs: set[str] = field(default_factory=set)  # recursive rescan targets
    dir_parents: set[str] = field(default_factory=set)  # parents of new dirs (their rows)
    size_dirs: set[str] = field(default_factory=set)  # materialized dirs whose sizes moved
    flush_handle: Any = None
    # current-burst accounting (reset at each flush)
    burst_total: int = 0
    burst_vouched: int = 0
    last_event: float = 0.0     # monotonic time of the last counted event
    last_debounce: float = 0.0  # last window emitted on the ring


class LocationManager:
    """One per node (ref:manager/mod.rs `LocationManagerActor`)."""

    def __init__(self, node: Any):
        self.node = node
        self._watched: dict[tuple[str, int], _Watched] = {}
        self.ignore_paths: set[str] = set()
        self.events_applied = 0
        self.rollup_seconds = 0.0  # spent setting directory sizes in flushes
        # debounce sizing (instance attrs so tests can compress time)
        self.debounce = DEBOUNCE
        self.debounce_max = DEBOUNCE_MAX
        # in-flight debounced rescans: retained so they can't be
        # GC-cancelled mid-flush and shutdown can drain them
        self._flush_tasks: set[asyncio.Task] = set()
        self._shutting_down = False

    # --- registration (ref:manager/mod.rs:36-60) -----------------------

    async def add(self, library: Any, location: dict[str, Any],
                  *, force_polling: bool = False, poll_interval: float = 1.0) -> None:
        key = (str(library.id), location["id"])
        if key in self._watched or not os.path.isdir(location["path"]):
            return
        entry = _Watched(library=library, location=location, watcher=None)

        def emit(event: WatchEvent, entry=entry):
            if _within(event.path, entry.paused):
                return None  # a paused fs-ops job's own write (see resume)
            return self._on_event(entry, event)

        entry.watcher = new_watcher(
            location["path"], emit,
            force_polling=force_polling, poll_interval=poll_interval,
        )
        await entry.watcher.start_async()  # tree walk off the event loop
        self._watched[key] = entry

    async def remove(self, library: Any, location_id: int) -> None:
        entry = self._watched.pop((str(library.id), location_id), None)
        if entry is not None:
            entry.watcher.stop()
            if entry.flush_handle is not None:
                entry.flush_handle.cancel()

    def pause(self, library: Any, location_id: int,
              paths: list[str] | None = None) -> None:
        """Temporarily ignore events under `paths` (the whole location
        when none are given): a fs-ops job writing into the location
        (ref:manager/mod.rs stop_watcher/reinit_watcher)."""
        entry = self._watched.get((str(library.id), location_id))
        if entry is not None:
            entry.paused += self._held(entry, paths)

    def resume(self, library: Any, location_id: int,
               paths: list[str] | None = None) -> None:
        entry = self._watched.get((str(library.id), location_id))
        if entry is None:
            return
        drain = getattr(entry.watcher, "drain", None)
        if drain is not None:
            # the job's writes are queued by now: read them while their
            # paths are still held, so they are dropped, not applied
            # after the resume; every other event is applied
            drain()
        for path in self._held(entry, paths):
            if path not in entry.paused:
                continue
            entry.paused.remove(path)
            rel = self._rel(entry, path)
            if rel:
                # what the job removed there moves its directory's size
                entry.size_dirs.add(IsolatedFilePathData.from_relative_str(
                    entry.location["id"], rel.replace(os.sep, "/"), False).materialized_path)
        if entry.size_dirs:
            self._schedule_flush(entry)

    def _held(self, entry: _Watched, paths: list[str] | None) -> list[str]:
        """The absolute paths a pause holds: `paths`, or the location."""
        if paths is None:
            return [os.path.abspath(entry.location["path"])]
        return [os.path.abspath(p) for p in paths]

    def is_watched(self, library: Any, location_id: int) -> bool:
        return (str(library.id), location_id) in self._watched

    async def shutdown(self) -> None:
        self._shutting_down = True
        for entry in self._watched.values():
            entry.watcher.stop()
            if entry.flush_handle is not None:
                entry.flush_handle.cancel()
        self._watched.clear()
        if self._flush_tasks:
            # let in-flight rescans settle rather than strand them
            # half-applied; _flush_done drains the set as they finish
            await asyncio.gather(*list(self._flush_tasks),
                                 return_exceptions=True)

    # --- event application (ref:watcher/utils.rs) ----------------------

    def _rel(self, entry: _Watched, path: str) -> str | None:
        root = os.path.abspath(entry.location["path"])
        ap = os.path.abspath(path)
        if ap == root:
            return ""
        if not ap.startswith(root + os.sep):
            return None
        return ap[len(root) + 1 :]

    async def _on_event(self, entry: _Watched, event: WatchEvent) -> None:
        if _within(event.path, self.ignore_paths):
            return
        rel = self._rel(entry, event.path)
        if rel is None:
            return
        rel = rel.replace(os.sep, "/")
        self.events_applied += 1
        db = entry.library.db
        loc_id = entry.location["id"]
        journal = IndexJournal(db)
        kind = event.kind
        try:
            if kind == EventKind.RENAME:
                old_rel = self._rel(entry, event.old_path or "")
                if old_rel is not None:
                    old_rel = old_rel.replace(os.sep, "/")
                    # a rename moves the journal vouches wholesale — if
                    # the old entry was vouching, this event needs NO
                    # rescan, so it counts toward the vouched burst and
                    # pushes any PENDING rescan out (widened window)
                    # instead of letting it fire mid-storm
                    old_iso = IsolatedFilePathData.from_relative_str(
                        loc_id, old_rel, event.is_dir
                    )
                    _, jentry = journal.lookup(
                        loc_id, key_of(old_iso), None, count=False,
                    )
                    self._count_burst(
                        entry,
                        vouched=jentry is not None and not jentry.stale,
                    )
                    self._apply_rename(db, loc_id, old_rel, rel, event.is_dir)
                    # the burst's quiet time runs from the end of the
                    # apply: a directory of many rows takes seconds, and
                    # must not split the storm it belongs to
                    entry.last_event = time.monotonic()
                    entry.size_dirs.add(old_iso.materialized_path)
                    entry.size_dirs.add(IsolatedFilePathData.from_relative_str(
                        loc_id, rel, event.is_dir).materialized_path)
                    self._schedule_flush(entry)
                    return
                kind = EventKind.CREATE  # renamed in from outside = create
            if kind == EventKind.REMOVE:
                self._apply_remove(db, loc_id, rel, event.is_dir)
                if rel:
                    entry.size_dirs.add(IsolatedFilePathData.from_relative_str(
                        loc_id, rel, event.is_dir).materialized_path)
                    self._schedule_flush(entry)
                return
            vouched = False
            if kind == EventKind.RESCAN:
                # events were lost at unknown depths — full rescan, and
                # the journal stops vouching for the whole subtree (the
                # losses may hide sub-mtime-granularity modifications)
                sub = "/" + rel.strip("/")
                journal.mark_stale_subtree(
                    loc_id, sub if sub.endswith("/") else sub + "/"
                )
                entry.deep_dirs.add(sub)
            elif kind == EventKind.MODIFY and rel == "" and event.is_dir:
                return  # attrib touch on the location root: nothing to do
            elif kind == EventKind.CREATE and event.is_dir:
                # a dir moved/created with pre-existing contents emits no
                # per-child events: recursively scan the dir itself, and
                # its parent shallowly for the dir's own row
                entry.deep_dirs.add("/" + rel.strip("/"))
                entry.dir_parents.add("/" + os.path.dirname(rel).strip("/"))
            else:
                # CREATE/MODIFY file: a TARGETED journal invalidation —
                # the entry stops vouching (its chunk cache stays for
                # the dirty-range rehash) — then a shallow rescan of the
                # parent batches the changed file into the
                # indexer→identifier pipeline; unchanged siblings stay
                # journal-vouched through that rescan
                iso = IsolatedFilePathData.from_relative_str(
                    loc_id, rel, False
                )
                jkey = key_of(iso)
                if kind == EventKind.MODIFY:
                    # burst sizing: a MODIFY whose journal entry still
                    # has the dirty-range fast path (entry present,
                    # size unchanged — a touch/attrib storm, or an
                    # in-place mutation the chunk cache re-vouches in
                    # ~ms) counts as vouched: the rescan it needs is
                    # near-free, so coalescing beats firing per event
                    _, jentry = journal.lookup(
                        loc_id, jkey, None, count=False
                    )
                    st = stat_identity(event.path)
                    vouched = (
                        jentry is not None
                        and jentry.identity is not None
                        and st is not None
                        and st.size == jentry.identity.size
                    )
                journal.mark_stale(loc_id, jkey)
                parent = os.path.dirname(rel)
                entry.dirty_dirs.add("/" + parent.replace(os.sep, "/").strip("/"))
            self._count_burst(entry, vouched=vouched)
            self._schedule_flush(entry)
        except Exception:
            logger.exception("watcher event application failed: %s", event)

    def _apply_rename(
        self, db: Any, loc_id: int, old_rel: str, new_rel: str, is_dir: bool
    ) -> None:
        old_iso = IsolatedFilePathData.from_relative_str(loc_id, old_rel, is_dir)
        # a rename changes no content: the journal entry MOVES with the
        # file, keeping its cas/thumb/media vouches — no re-hash, no
        # re-thumbnail (the cheapest possible "targeted re-index")
        _new_iso = IsolatedFilePathData.from_relative_str(loc_id, new_rel, is_dir)
        IndexJournal(db).rename_path(
            loc_id, key_of(old_iso), key_of(_new_iso),
            *(
                (
                    f"{old_iso.materialized_path}{old_iso.name}/",
                    f"{_new_iso.materialized_path}{_new_iso.name}/",
                )
                if is_dir else (None, None)
            ),
        )
        row = db.find_one(
            "file_path",
            location_id=loc_id,
            materialized_path=old_iso.materialized_path,
            name=old_iso.name,
            extension=old_iso.extension,
            is_dir=int(is_dir),
        )
        new_iso = IsolatedFilePathData.from_relative_str(loc_id, new_rel, is_dir)
        if row is None:
            return  # never indexed; the next rescan picks it up
        db.update(
            "file_path",
            {"id": row["id"]},
            materialized_path=new_iso.materialized_path,
            name=new_iso.name,
            extension=new_iso.extension,
            date_modified=now_iso(),
        )
        if is_dir:
            # rewrite the subtree's materialized paths (ref:utils.rs rename)
            old_prefix = f"{old_iso.materialized_path}{old_iso.name}/"
            new_prefix = f"{new_iso.materialized_path}{new_iso.name}/"
            rows = db.query(
                "SELECT id, materialized_path FROM file_path "
                "WHERE location_id = ? AND substr(materialized_path, 1, ?) = ?",
                (loc_id, len(old_prefix), old_prefix),
            )
            # one transaction: a commit per row costs seconds on a
            # directory of 16k files, on the event loop
            with db.transaction() as conn:
                conn.executemany(
                    "UPDATE file_path SET materialized_path = ? WHERE id = ?",
                    [(new_prefix + child["materialized_path"][len(old_prefix):], child["id"])
                     for child in rows],
                )

    def _apply_remove(self, db: Any, loc_id: int, rel: str, is_dir: bool) -> None:
        # the event's is_dir can be unknowable post-deletion: try file then dir
        journal = IndexJournal(db)
        for as_dir in ([is_dir] if is_dir else [False, True]):
            iso = IsolatedFilePathData.from_relative_str(loc_id, rel, as_dir)
            journal.delete_path(
                loc_id, key_of(iso),
                f"{iso.materialized_path}{iso.name}/" if as_dir else None,
            )
            row = db.find_one(
                "file_path",
                location_id=loc_id,
                materialized_path=iso.materialized_path,
                name=iso.name,
                extension=iso.extension,
                is_dir=int(as_dir),
            )
            if row is None:
                continue
            if as_dir:
                prefix = f"{iso.materialized_path}{iso.name}/"
                db.execute(
                    "DELETE FROM file_path WHERE location_id = ? "
                    "AND substr(materialized_path, 1, ?) = ?",
                    (loc_id, len(prefix), prefix),
                )
            db.delete("file_path", id=row["id"])
            return

    def _roll_up_sizes(self, entry: _Watched, dirs: set[str]) -> None:
        """Sizes of `dirs` and their ancestors, deepest first, each the
        sum of its children's rows; then the location's, the sum of the
        root's children. A scan's full roll-up leaves the same values
        (its other directories did not move), at a query per directory
        on the (location_id, materialized_path) index, not a pass over
        the location."""
        t0 = time.perf_counter()
        db, loc_id = entry.library.db, entry.location["id"]
        chain = set()
        for d in dirs:
            parts = d.strip("/").split("/") if d != "/" else []
            chain.update("/" + "".join(f"{p}/" for p in parts[:i]) for i in range(len(parts) + 1))
        try:
            for d in sorted(chain, key=lambda x: x.count("/"), reverse=True):
                total = u64_blob(sum(blob_u64(r["size_in_bytes_bytes"]) or 0 for r in db.query(
                    "SELECT size_in_bytes_bytes FROM file_path "
                    "WHERE location_id = ? AND materialized_path = ?", (loc_id, d))))
                if d == "/":
                    db.update("location", {"id": loc_id}, size_in_bytes=total)
                    continue
                parent, name = d[:-1].rsplit("/", 1)
                db.execute(
                    "UPDATE file_path SET size_in_bytes_bytes = ? WHERE location_id = ? "
                    "AND materialized_path = ? AND name = ? AND is_dir = 1",
                    (total, loc_id, parent + "/", name),
                )
        except Exception:
            logger.exception("directory sizes of location %s failed", loc_id)
        self.rollup_seconds += time.perf_counter() - t0

    # --- debounced shallow rescan --------------------------------------

    def _count_burst(self, entry: _Watched, vouched: bool) -> None:
        """Accumulate the current burst's journal verdicts (reset at
        each flush): `vouched` events are ones the index journal still
        has a free/near-free path for — rename storms (vouches MOVE)
        and touch storms (size-stable entries the dirty-range rehash
        re-vouches in ~ms)."""
        now = time.monotonic()
        if (
            entry.flush_handle is None
            and now - entry.last_event > self.debounce_max
        ):
            # a rename-only storm schedules no flush, so its counters
            # never reset through _flush — a later lone event must not
            # inherit the stale widened window
            entry.burst_total = 0
            entry.burst_vouched = 0
        entry.last_event = now
        entry.burst_total += 1
        if vouched:
            entry.burst_vouched += 1

    def _debounce_window(self, entry: _Watched) -> float:
        """Journal-verdict-driven settle window: a burst DOMINATED by
        vouched events widens linearly with the vouched count (each
        extra event is more evidence the storm is churn, not content),
        capped at `debounce_max`; real content-change bursts keep the
        snappy base window."""
        if (
            entry.burst_vouched < DEBOUNCE_WIDEN_MIN
            or entry.burst_vouched * 2 < entry.burst_total
        ):
            return self.debounce
        widen = entry.burst_vouched / DEBOUNCE_WIDEN_MIN
        return min(self.debounce_max, self.debounce * widen)

    def _schedule_flush(self, entry: _Watched) -> None:
        if entry.flush_handle is not None:
            entry.flush_handle.cancel()
        loop = asyncio.get_running_loop()
        window = self._debounce_window(entry)
        entry.last_debounce = window
        entry.flush_handle = loop.call_later(
            window, self._spawn_flush, loop, entry
        )

    def _spawn_flush(self, loop: asyncio.AbstractEventLoop,
                     entry: _Watched) -> None:
        if self._shutting_down:
            # the debounce timer may fire in the same tick shutdown()
            # runs: its cancel() no-ops on a fired handle and the drain
            # below would miss a flush spawned after its gather snapshot
            return
        supervise(loop.create_task(self._flush(entry)), self._flush_tasks,
                  logger, "debounced rescan")

    async def _flush(self, entry: _Watched) -> None:
        dirs, entry.dirty_dirs = entry.dirty_dirs, set()
        deep, entry.deep_dirs = entry.deep_dirs, set()
        parents, entry.dir_parents = entry.dir_parents, set()
        sizes, entry.size_dirs = entry.size_dirs, set()
        entry.flush_handle = None
        total, entry.burst_total = entry.burst_total, 0
        vouched, entry.burst_vouched = entry.burst_vouched, 0
        if sizes:
            self._roll_up_sizes(entry, sizes)
        if not (total or dirs or deep or parents):
            return  # sizes alone: no burst to record, nothing to rescan
        # flight-recorder record of the burst: when an index storm hits,
        # "what watcher activity preceded it" is the first question —
        # and the vouched/total split says whether the debounce sizing
        # read the storm right
        WATCHER_EVENTS.emit(
            "burst_flush",
            location=entry.location.get("id"),
            shallow_dirs=len(dirs), deep_dirs=len(deep),
            events=total, vouched=vouched,
            debounce_s=round(entry.last_debounce, 3),
        )
        # a deep scan of an ancestor covers shallow/deep scans below it
        def covered(sub: str, by: str) -> bool:
            return by == "/" or sub == by or sub.startswith(by.rstrip("/") + "/")

        deep = {
            d for d in deep if not any(covered(d, other) for other in deep if other != d)
        }
        dirs = {d for d in dirs if not any(covered(d, dd) for dd in deep)}
        parents = {p for p in parents
                   if p not in dirs and not any(covered(p, dd) for dd in deep)}
        for sub in sorted(parents):
            try:
                job = IndexerJob({"location_id": entry.location["id"], "sub_path": sub,
                                  "shallow": True})
                job.notify_outcome = False
                await JobBuilder(job).spawn(self.node.jobs, entry.library)
            except Exception:
                logger.exception("directory rows of %r failed", sub)
        backend = str(self.node.device)
        for sub in sorted(deep):
            try:
                await deep_rescan_sub_path(
                    entry.library, entry.location, sub or "/", self.node.jobs,
                    backend=backend,
                )
            except Exception:
                logger.exception("deep rescan of %r failed", sub)
        for sub in sorted(dirs):
            try:
                await light_scan_location(
                    entry.library, entry.location, sub or "/", self.node.jobs,
                    backend=backend,
                )
            except Exception:
                logger.exception("shallow rescan of %r failed", sub)



def _within(path: str, roots) -> bool:
    """`path` is one of `roots` (absolute) or lies under one."""
    ap = os.path.abspath(path)
    return any(ap == r or ap.startswith(r + os.sep) for r in roots)
