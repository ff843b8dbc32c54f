"""Polling fallback backend — mtime-snapshot diffing.

Parity role: the reference's notify crate falls back to poll-watching
where native watchers are unavailable (and macOS FSEvents/windows
ReadDirectoryChangesW normalizations live in their own modules,
ref:core/src/location/manager/watcher/{macos,windows}.rs). This backend
is the portable equivalent: it snapshots the tree every `interval`
seconds and diffs (path → (mtime, size, is_dir)); renames are detected
by matching (inode, size) pairs of removed/added entries, like the
reference's inode-based rename resolution (watcher/utils.rs inode
helpers).

Counterpart of `spacedrive_tpu/location/watcher/polling.py`. It has no
`drain`: a paused fs-ops job's writes reach the location manager at the
first tick after the resume, and are applied, as in JAX.
"""

from __future__ import annotations

import asyncio
import os
import stat as stat_mod
from typing import Awaitable, Callable

from .events import EventKind, WatchEvent

Snapshot = dict[str, tuple[float, int, bool, int]]  # mtime, size, is_dir, inode


def take_snapshot(root: str) -> Snapshot:
    snap: Snapshot = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            p = os.path.join(dirpath, name)
            try:
                st = os.stat(p, follow_symlinks=False)
            except OSError:
                continue
            snap[p] = (
                st.st_mtime,
                st.st_size,
                stat_mod.S_ISDIR(st.st_mode),
                st.st_ino,
            )
    return snap


def diff_snapshots(old: Snapshot, new: Snapshot) -> list[WatchEvent]:
    events: list[WatchEvent] = []
    removed = {p: meta for p, meta in old.items() if p not in new}
    added = {p: meta for p, meta in new.items() if p not in old}
    # rename pairing by inode (ref:watcher/utils.rs inode helpers);
    # the kernel reuses freed inodes, so demand the full identity
    # (inode, is_dir, size, mtime) to survive delete+create in one tick
    by_identity = {meta: p for p, meta in removed.items()}
    for p, meta in list(added.items()):
        src = by_identity.get(meta)
        if src is not None:
            events.append(
                WatchEvent(EventKind.RENAME, p, old_path=src, is_dir=meta[2])
            )
            removed.pop(src)
            added.pop(p)
            by_identity.pop(meta)
    for p, meta in removed.items():
        events.append(WatchEvent(EventKind.REMOVE, p, is_dir=meta[2]))
    for p, meta in added.items():
        events.append(WatchEvent(EventKind.CREATE, p, is_dir=meta[2]))
    for p, meta in new.items():
        old_meta = old.get(p)
        if old_meta is not None and (meta[0], meta[1]) != (old_meta[0], old_meta[1]):
            events.append(WatchEvent(EventKind.MODIFY, p, is_dir=meta[2]))
    return events


class PollingWatcher:
    def __init__(
        self,
        root: str,
        emit: Callable[[WatchEvent], Awaitable[None] | None],
        interval: float = 1.0,
    ):
        self.root = os.path.abspath(root)
        self.emit = emit
        self.interval = interval
        self._task: asyncio.Task | None = None
        self._snap: Snapshot = {}

    def start(self) -> None:
        self._snap = take_snapshot(self.root)
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def start_async(self) -> None:
        self._snap = await asyncio.to_thread(take_snapshot, self.root)
        self._task = asyncio.get_running_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            new = await asyncio.to_thread(take_snapshot, self.root)
            for event in diff_snapshots(self._snap, new):
                result = self.emit(event)
                if asyncio.iscoroutine(result):
                    await result
            self._snap = new
