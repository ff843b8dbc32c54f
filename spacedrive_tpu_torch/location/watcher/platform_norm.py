"""macOS/Windows watcher event normalizers.

Parity: ref:core/src/location/manager/watcher/{macos,windows}.rs — the
reference's per-OS watchers are mostly *normalization state machines*
that turn each platform's quirky raw streams into the shared event
vocabulary (`events.WatchEvent`), and those machines are portable even
though the native sources (FSEvents, ReadDirectoryChangesW) only exist
on their hosts. This module implements both machines host-independently:
on a mac/windows host a thin adapter feeds them raw events; everywhere
else the polling backend remains the fallback, and the tests drive the
machines with simulated streams.

macOS quirks handled (ref:macos.rs:1-10,94-97,122-126,168,221-223):
- FSEvents reports renames as bare `RenameMode::Any` per PATH with no
  pairing cookie. The old-path half targets a path that no longer
  exists; the new-path half targets one that does. Halves pair within
  a 100 ms window; an unpaired old half is a move OUT of the location
  (→ REMOVE), an unpaired new half is a move IN (→ CREATE).
- Finder emits a doubled folder-create; the second is deduped against
  the latest created folder (a unique-constraint hit otherwise).
- Data/metadata modifies coalesce per path behind a quiet window; a
  file updated so often it never goes quiet ("reincident") is flushed
  at a longer cap so a long download still shows progress.

Windows quirks handled (ref:windows.rs:1-8,94-95,106-116,171,192,293):
- A move inside the watched tree arrives as REMOVE(old) then
  CREATE(new). Removes are therefore held for a grace window and
  paired by file identity (inode stand-in) with a later create →
  RENAME; only an unpaired remove really deletes.
- `RenameMode::From`/`RenameMode::To` halves pair in either arrival
  order; unpaired halves degrade to REMOVE/CREATE like macOS.
- A create for a file still exclusively locked by its writer is
  retried via the modify path later (the raw adapter reports it
  locked; the machine re-queues rather than emitting a broken create).

Both machines take an injectable clock and existence/identity probes so
the tests are deterministic; `tick(now)` drives expiry exactly like the
reference's 100 ms handler tick loop (mod.rs).

Counterpart of `spacedrive_tpu/location/watcher/platform_norm.py`: the
same machines, pure Python on every host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

from .events import EventKind, WatchEvent

RENAME_WINDOW = 0.1      # ref:macos.rs:168 (100 ms rename pairing)
MODIFY_QUIET = 0.1       # per-path coalescing quiet window
REINCIDENT_CAP = 10.0    # ref: "bigger timeout" for hot files
REMOVE_GRACE = 0.1       # ref:windows.rs remove→create pairing wait


@dataclass
class _Pending:
    path: str
    is_dir: bool
    at: float
    ident: int | None = None  # windows: file identity (inode stand-in)


def _pop_fresh(buf: dict[str, _Pending], now: float,
               path: str | None = None,
               ident: int | None = None) -> _Pending | None:
    """Pop the best-matching buffered half still inside the pairing
    window. Concurrent renames can have several halves buffered at
    once; first-inserted-wins would mispair them, so candidates rank:
    identity match (when both sides have one) > same basename (a MOVE
    keeps its name) > same parent dir (a rename stays put) > FIFO."""
    fresh = [(k, p) for k, p in buf.items() if now - p.at <= RENAME_WINDOW]
    if not fresh:
        return None

    def rank(item):
        _k, p = item
        if ident is not None and p.ident is not None:
            if p.ident == ident:
                return 0
            return 4  # identity known on both sides and DIFFERENT
        if path is not None:
            if os.path.basename(p.path) == os.path.basename(path):
                return 1
            if os.path.dirname(p.path) == os.path.dirname(path):
                return 2
        return 3

    key, p = min(fresh, key=rank)
    if ident is not None and p.ident is not None and p.ident != ident:
        return None  # every candidate has a contradicting identity
    del buf[key]
    return p


class _ModifyCoalescer:
    """Shared modify buffering: repeated modifies reset a quiet timer;
    a path that never goes quiet flushes at REINCIDENT_CAP anyway."""

    def __init__(self) -> None:
        self._last: dict[str, float] = {}
        self._first: dict[str, float] = {}
        self._dirs: set[str] = set()

    def touch(self, path: str, is_dir: bool, now: float) -> None:
        self._last[path] = now
        self._first.setdefault(path, now)
        if is_dir:
            self._dirs.add(path)

    def drop(self, path: str) -> None:
        self._last.pop(path, None)
        self._first.pop(path, None)
        self._dirs.discard(path)

    def due(self, now: float) -> list[WatchEvent]:
        out = []
        for path, last in list(self._last.items()):
            if now - last >= MODIFY_QUIET \
                    or now - self._first[path] >= REINCIDENT_CAP:
                out.append(WatchEvent(EventKind.MODIFY, path,
                                      is_dir=path in self._dirs))
                self.drop(path)
        return out


class MacOsNormalizer:
    """FSEvents-shaped raw stream → normalized WatchEvents.

    Raw kinds: "create_file", "create_dir", "modify_data",
    "modify_meta", "rename_any", "remove_file", "remove_dir".
    """

    def __init__(self, exists: Callable[[str], bool],
                 is_dir: Callable[[str], bool] = lambda p: False,
                 ident: Callable[[str], int | None] = lambda p: None,
                 ident_of_missing: Callable[[str], int | None]
                 = lambda p: None):
        # `ident` stats an existing path (inode); `ident_of_missing`
        # resolves a VANISHED path from the location index (the
        # reference pairs by the indexed inode, macos.rs) — both
        # optional: without them pairing falls back to basename/parent
        # heuristics, with them concurrent renames cannot mispair
        self._exists = exists
        self._is_dir = is_dir
        self._ident = ident
        self._ident_missing = ident_of_missing
        self._old_half: dict[str, _Pending] = {}   # vanished paths
        self._new_half: dict[str, _Pending] = {}   # appeared paths
        self._last_created_dir: tuple[str, float] | None = None
        self._mods = _ModifyCoalescer()

    def on_raw(self, kind: str, path: str, now: float,
               is_dir: bool = False) -> list[WatchEvent]:
        out: list[WatchEvent] = []
        if kind == "create_dir":
            # Finder's doubled folder-create (ref:macos.rs:94-97)
            last = self._last_created_dir
            if last and last[0] == path and now - last[1] <= RENAME_WINDOW:
                return out
            self._last_created_dir = (path, now)
            out.append(WatchEvent(EventKind.CREATE, path, is_dir=True))
        elif kind == "create_file":
            out.append(WatchEvent(EventKind.CREATE, path, is_dir=False))
        elif kind in ("modify_data", "modify_meta"):
            self._mods.touch(path, is_dir, now)
        elif kind == "rename_any":
            if self._exists(path):
                # new half: pair with the best buffered old half
                my_ident = self._ident(path)
                old = _pop_fresh(self._old_half, now, path=path,
                                 ident=my_ident)
                if old is not None:
                    out.append(WatchEvent(EventKind.RENAME, path,
                                          old_path=old.path,
                                          is_dir=self._is_dir(path)))
                else:
                    self._new_half[path] = _Pending(
                        path, self._is_dir(path), now, my_ident)
            else:
                my_ident = self._ident_missing(path)
                new = _pop_fresh(self._new_half, now, path=path,
                                 ident=my_ident)
                if new is not None:
                    out.append(WatchEvent(EventKind.RENAME, new.path,
                                          old_path=path,
                                          is_dir=new.is_dir))
                else:
                    self._old_half[path] = _Pending(path, is_dir, now,
                                                    my_ident)
                self._mods.drop(path)
        elif kind in ("remove_file", "remove_dir"):
            self._mods.drop(path)
            out.append(WatchEvent(EventKind.REMOVE, path,
                                  is_dir=kind == "remove_dir"))
        return out

    def tick(self, now: float) -> list[WatchEvent]:
        """Expire unpaired halves + flush quiet modifies
        (ref:macos.rs:168: >100 ms old halves become removals)."""
        out: list[WatchEvent] = []
        for path, p in list(self._old_half.items()):
            if now - p.at > RENAME_WINDOW:
                del self._old_half[path]
                # moved OUT of the location (ref:macos.rs:7-8)
                out.append(WatchEvent(EventKind.REMOVE, path,
                                      is_dir=p.is_dir))
        for path, p in list(self._new_half.items()):
            if now - p.at > RENAME_WINDOW:
                del self._new_half[path]
                # moved IN from elsewhere (ref:macos.rs:9-10)
                out.append(WatchEvent(EventKind.CREATE, path,
                                      is_dir=p.is_dir))
        out.extend(self._mods.due(now))
        return out


class WindowsNormalizer:
    """ReadDirectoryChangesW-shaped raw stream → normalized events.

    Raw kinds: "create", "modify", "remove", "rename_from", "rename_to".
    `ident` is the file-identity probe result (nFileIndex / inode
    stand-in) where the adapter could stat the path.
    """

    def __init__(self, locked: Callable[[str], bool] = lambda p: False,
                 is_dir: Callable[[str], bool] = lambda p: False,
                 exists: Callable[[str], bool] = lambda p: True):
        # `exists` re-stats a path when its deferred locked-create
        # finally unblocks: a locked file DELETED before release must
        # not yield a spurious CREATE after its REMOVE
        self._locked = locked
        self._is_dir = is_dir
        self._exists = exists
        self._pending_removes: dict[str, _Pending] = {}
        self._from_half: dict[str, _Pending] = {}
        self._to_half: dict[str, _Pending] = {}
        self._locked_creates: dict[str, _Pending] = {}
        self._mods = _ModifyCoalescer()

    def on_raw(self, kind: str, path: str, now: float,
               is_dir: bool = False,
               ident: int | None = None) -> list[WatchEvent]:
        out: list[WatchEvent] = []
        if kind == "create":
            if self._locked(path):
                # writer still holds the handle: defer and RE-PROBE the
                # lock at every tick — emitting before release would be
                # the broken event this exists to prevent
                # (ref:windows.rs:94-95)
                self._locked_creates[path] = _Pending(path, is_dir, now,
                                                      ident)
                return out
            # a recent REMOVE with the same identity = a move
            # (ref:windows.rs:106-116)
            if ident is not None:
                for old, p in list(self._pending_removes.items()):
                    if p.ident == ident and now - p.at <= REMOVE_GRACE:
                        del self._pending_removes[old]
                        out.append(WatchEvent(EventKind.RENAME, path,
                                              old_path=old, is_dir=is_dir))
                        return out
            out.append(WatchEvent(EventKind.CREATE, path, is_dir=is_dir))
        elif kind == "modify":
            self._mods.touch(path, is_dir, now)
        elif kind == "remove":
            self._mods.drop(path)
            # a deferred locked create for a now-removed path is dead:
            # the writer deleted the file before ever releasing it
            self._locked_creates.pop(path, None)
            self._pending_removes[path] = _Pending(path, is_dir, now, ident)
        elif kind == "rename_from":
            self._locked_creates.pop(path, None)
            to = _pop_fresh(self._to_half, now, path=path, ident=ident)
            if to is not None:
                out.append(WatchEvent(EventKind.RENAME, to.path,
                                      old_path=path, is_dir=to.is_dir))
            else:
                self._from_half[path] = _Pending(path, is_dir, now, ident)
            self._mods.drop(path)
        elif kind == "rename_to":
            frm = _pop_fresh(self._from_half, now, path=path, ident=ident)
            if frm is not None:
                out.append(WatchEvent(EventKind.RENAME, path,
                                      old_path=frm.path, is_dir=is_dir))
            else:
                self._to_half[path] = _Pending(path, is_dir, now, ident)
        return out

    def tick(self, now: float) -> list[WatchEvent]:
        out: list[WatchEvent] = []
        for path, p in list(self._locked_creates.items()):
            if not self._locked(path):
                del self._locked_creates[path]
                # re-stat before emitting: "no longer locked" may mean
                # "no longer exists" (deleted while held), and a CREATE
                # for a vanished path would contradict its REMOVE
                if self._exists(path):
                    out.append(WatchEvent(EventKind.CREATE, path,
                                          is_dir=p.is_dir))
        for path, p in list(self._pending_removes.items()):
            if now - p.at > REMOVE_GRACE:
                del self._pending_removes[path]
                out.append(WatchEvent(EventKind.REMOVE, path,
                                      is_dir=p.is_dir))
        for path, p in list(self._from_half.items()):
            if now - p.at > RENAME_WINDOW:
                del self._from_half[path]
                out.append(WatchEvent(EventKind.REMOVE, path,
                                      is_dir=p.is_dir))
        for path, p in list(self._to_half.items()):
            if now - p.at > RENAME_WINDOW:
                del self._to_half[path]
                out.append(WatchEvent(EventKind.CREATE, path,
                                      is_dir=p.is_dir))
        out.extend(self._mods.due(now))
        return out
