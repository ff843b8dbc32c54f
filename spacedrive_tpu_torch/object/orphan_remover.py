"""OrphanRemoverActor — deletes objects with no remaining file_paths.

Parity: ref:core/src/object/orphan_remover.rs — invokable actor with a
periodic tick (1 min interval, 10 s debounce, orphan_remover.rs:12-49),
clean-up loop removing ≤512 orphaned objects (and their tag links) per
round until none remain (orphan_remover.rs:57-96).

Counterpart of `spacedrive_tpu/object/orphan_remover.py`: one actor per
library, started by the node; the journal's share is
`location/indexer/journal.prune_orphans`.
"""

from __future__ import annotations

import asyncio
import logging
import time

logger = logging.getLogger(__name__)

TICK_INTERVAL = 60.0  # ref:orphan_remover.rs ONE_MINUTE
DEBOUNCE = 10.0  # ref:orphan_remover.rs TEN_SECONDS
BATCH = 512  # ref:orphan_remover.rs:63


def process_clean_up(db) -> int:
    """One full clean-up pass; returns objects removed. Also prunes
    index-journal rows whose file_path vanished: liveness comes from
    the journal/DB join (location/indexer/journal.prune_orphans), never
    from re-stat'ing paths on disk — a vanished row must not keep a
    stale vouch alive."""
    from ..location.indexer.journal import prune_orphans

    removed = 0
    while True:
        rows = db.query(
            "SELECT o.id FROM object o WHERE NOT EXISTS "
            "(SELECT 1 FROM file_path fp WHERE fp.object_id = o.id) LIMIT ?",
            (BATCH,),
        )
        if not rows:
            pruned = prune_orphans(db)
            if pruned:
                logger.debug("pruned %d orphaned journal rows", pruned)
            return removed
        ids = [r["id"] for r in rows]
        qmarks = ",".join("?" for _ in ids)
        with db.transaction() as conn:
            conn.execute(f"DELETE FROM tag_on_object WHERE object_id IN ({qmarks})", ids)
            conn.execute(f"DELETE FROM label_on_object WHERE object_id IN ({qmarks})", ids)
            conn.execute(f"DELETE FROM object WHERE id IN ({qmarks})", ids)
        removed += len(ids)
        logger.debug("removed %d orphaned objects", len(ids))


async def process_clean_up_async(db) -> int:
    """The actor's clean-up pass: same work as :func:`process_clean_up`
    but yielding to the event loop between every delete batch: a
    million-row clean-up is thousands of short lock holds with
    scheduling points between them, never one loop-freezing scan."""
    from ..location.indexer.journal import (
        PRUNE_BATCH,
        prune_orphans_step,
    )

    removed = 0
    while True:
        rows = db.query(
            "SELECT o.id FROM object o WHERE NOT EXISTS "
            "(SELECT 1 FROM file_path fp WHERE fp.object_id = o.id) LIMIT ?",
            (BATCH,),
        )
        if not rows:
            break
        ids = [r["id"] for r in rows]
        qmarks = ",".join("?" for _ in ids)
        with db.transaction() as conn:
            conn.execute(f"DELETE FROM tag_on_object WHERE object_id IN ({qmarks})", ids)
            conn.execute(f"DELETE FROM label_on_object WHERE object_id IN ({qmarks})", ids)
            conn.execute(f"DELETE FROM object WHERE id IN ({qmarks})", ids)
        removed += len(ids)
        logger.debug("removed %d orphaned objects", len(ids))
        await asyncio.sleep(0)
    pruned = 0
    while True:
        n = prune_orphans_step(db, PRUNE_BATCH)
        pruned += n
        if n < PRUNE_BATCH:
            break
        await asyncio.sleep(0)
    if pruned:
        logger.debug("pruned %d orphaned journal rows", pruned)
    return removed


class OrphanRemoverActor:
    def __init__(self, db, tick_interval: float = TICK_INTERVAL, debounce: float = DEBOUNCE):
        self.db = db
        self.tick_interval = tick_interval
        self.debounce = debounce
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._stopped = False
        self._last_checked = 0.0

    def start(self) -> None:
        if self._task is None:
            self._stopped = False
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        # cooperative flag first (the tick loop has a stop condition of
        # its own), cancel as the fast path
        self._stopped = True
        self._wake.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def invoke(self) -> None:
        self._wake.set()

    async def _run(self) -> None:
        while not self._stopped:
            try:
                await asyncio.wait_for(self._wake.wait(), timeout=self.tick_interval)
            except asyncio.TimeoutError:
                pass
            if self._stopped:
                return
            self._wake.clear()
            if time.monotonic() - self._last_checked > self.debounce:
                try:
                    await process_clean_up_async(self.db)
                except Exception:  # noqa: BLE001 - actor must survive
                    logger.exception("orphan clean-up failed")
                self._last_checked = time.monotonic()
