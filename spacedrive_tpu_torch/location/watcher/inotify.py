"""Linux inotify backend (ctypes, no external deps).

Parity: ref:core/src/location/manager/watcher/linux.rs — the reference
rides `notify`'s inotify backend and adds rename-cookie pairing and
event normalization on top; this backend speaks inotify directly:
recursive watch registration (new subdirectories are watched as they
appear), MOVED_FROM/MOVED_TO pairing by cookie with a grace window
(unpaired halves degrade to REMOVE/CREATE like the reference's rename
tracker timeout), and CLOSE_WRITE standing in for the final modify.

Counterpart of `spacedrive_tpu/location/watcher/inotify.py`, with the
libc functions' argument and result types declared, plus `drain`: the
location manager's resume reads what the kernel queued while a fs-ops
job held its paths, so the job's own events are dropped then, and the
others are applied.
"""

from __future__ import annotations

import asyncio
import ctypes
import ctypes.util
import errno
import logging
import os
import struct
from typing import Awaitable, Callable

from ...utils.tasks import supervise
from .events import EventKind, WatchEvent

logger = logging.getLogger(__name__)

IN_ACCESS = 0x0001
IN_MODIFY = 0x0002
IN_ATTRIB = 0x0004
IN_CLOSE_WRITE = 0x0008
IN_MOVED_FROM = 0x0040
IN_MOVED_TO = 0x0080
IN_CREATE = 0x0100
IN_DELETE = 0x0200
IN_DELETE_SELF = 0x0400
IN_MOVE_SELF = 0x0800
IN_ISDIR = 0x40000000
IN_Q_OVERFLOW = 0x4000
IN_IGNORED = 0x8000

_MASK = (
    IN_CLOSE_WRITE
    | IN_ATTRIB
    | IN_MOVED_FROM
    | IN_MOVED_TO
    | IN_CREATE
    | IN_DELETE
    | IN_DELETE_SELF
)

RENAME_GRACE = 0.1  # unpaired MOVED_FROM/TO settle window (ref rename tracker)

_libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6", use_errno=True)
if hasattr(_libc, "inotify_init1"):
    _libc.inotify_init1.argtypes = [ctypes.c_int]
    _libc.inotify_init1.restype = ctypes.c_int
    _libc.inotify_add_watch.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32]
    _libc.inotify_add_watch.restype = ctypes.c_int


class InotifyWatcher:
    """One instance per watched root (a location)."""

    def __init__(
        self,
        root: str,
        emit: Callable[[WatchEvent], Awaitable[None] | None],
    ):
        self.root = os.path.abspath(root)
        self.emit = emit
        self._fd: int | None = None
        self._wd_paths: dict[int, str] = {}
        self._path_wds: dict[str, int] = {}
        self._pending_from: dict[int, tuple[str, bool, asyncio.TimerHandle]] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        # async emit-handler tasks: retained so a failing handler surfaces
        # through its done-callback instead of as a GC-time unraisable
        # warning
        self._emit_tasks: set[asyncio.Task] = set()

    # --- lifecycle -----------------------------------------------------

    def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        fd = _libc.inotify_init1(os.O_NONBLOCK)
        if fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        self._fd = fd
        self._watch_tree(self.root)
        self._loop.add_reader(fd, self._on_readable)

    async def start_async(self) -> None:
        """start() with the tree walk (one add_watch syscall per dir —
        seconds on huge locations) off the event loop."""
        self._loop = asyncio.get_running_loop()
        fd = _libc.inotify_init1(os.O_NONBLOCK)
        if fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        self._fd = fd
        await asyncio.to_thread(self._watch_tree, self.root)
        self._loop.add_reader(fd, self._on_readable)

    def stop(self) -> None:
        if self._fd is None:
            return
        if self._loop is not None:
            self._loop.remove_reader(self._fd)
        for _wd, (old, is_dir, handle) in list(self._pending_from.items()):
            handle.cancel()
        self._pending_from.clear()
        os.close(self._fd)
        self._fd = None
        self._wd_paths.clear()
        self._path_wds.clear()

    # --- watch registration --------------------------------------------

    def _watch_tree(self, path: str) -> None:
        self._add_watch(path)
        for dirpath, dirnames, _files in os.walk(path):
            for d in dirnames:
                self._add_watch(os.path.join(dirpath, d))

    def _add_watch(self, path: str) -> None:
        assert self._fd is not None
        wd = _libc.inotify_add_watch(self._fd, os.fsencode(path), _MASK)
        if wd < 0:
            err = ctypes.get_errno()
            if err in (errno.ENOENT, errno.EACCES):
                return
            raise OSError(err, f"inotify_add_watch({path}) failed")
        self._wd_paths[wd] = path
        self._path_wds[path] = wd

    def _rm_watch_under(self, path: str) -> None:
        for p, wd in list(self._path_wds.items()):
            if p == path or p.startswith(path + os.sep):
                self._wd_paths.pop(wd, None)
                self._path_wds.pop(p, None)

    # --- event pump ----------------------------------------------------

    def _on_readable(self) -> int:
        """Read and handle one buffer of events; returns the bytes read
        (0 when the queue was empty)."""
        assert self._fd is not None
        try:
            buf = os.read(self._fd, 1 << 16)
        except BlockingIOError:
            return 0
        except OSError:
            return 0
        offset = 0
        while offset + 16 <= len(buf):
            wd, mask, cookie, length = struct.unpack_from("iIII", buf, offset)
            name = buf[offset + 16 : offset + 16 + length].split(b"\0", 1)[0].decode(
                errors="surrogateescape"
            )
            offset += 16 + length
            self._handle(wd, mask, cookie, name)
        return len(buf)

    def drain(self) -> None:
        """Handle every event the kernel has queued, now."""
        while self._fd is not None and self._on_readable():
            pass

    def _handle(self, wd: int, mask: int, cookie: int, name: str) -> None:
        if mask & IN_Q_OVERFLOW:
            # kernel queue overflow: events lost at unknown depths
            self._emit(WatchEvent(EventKind.RESCAN, self.root, is_dir=True))
            return
        if mask & IN_IGNORED:
            path = self._wd_paths.pop(wd, None)
            if path is not None:
                self._path_wds.pop(path, None)
            return
        base = self._wd_paths.get(wd)
        if base is None:
            return
        path = os.path.join(base, name) if name else base
        is_dir = bool(mask & IN_ISDIR)

        if mask & IN_MOVED_FROM:
            assert self._loop is not None
            handle = self._loop.call_later(
                RENAME_GRACE, self._expire_move_from, cookie
            )
            self._pending_from[cookie] = (path, is_dir, handle)
            return
        if mask & IN_MOVED_TO:
            pending = self._pending_from.pop(cookie, None)
            if pending is not None:
                old, was_dir, handle = pending
                handle.cancel()
                if was_dir:
                    self._rewrite_watches(old, path)
                self._emit(
                    WatchEvent(EventKind.RENAME, path, old_path=old, is_dir=was_dir)
                )
            else:
                # moved in from outside the tree = create
                if is_dir:
                    self._watch_tree(path)
                self._emit(WatchEvent(EventKind.CREATE, path, is_dir=is_dir))
            return
        if mask & IN_CREATE:
            if is_dir:
                self._watch_tree(path)  # watch before children appear
                self._emit(WatchEvent(EventKind.CREATE, path, is_dir=True))
            # file creates are reported at CLOSE_WRITE (content settled)
            return
        if mask & (IN_CLOSE_WRITE | IN_ATTRIB):
            kind = EventKind.MODIFY
            # CLOSE_WRITE on a brand-new file: we suppressed its CREATE
            self._emit(WatchEvent(kind, path, is_dir=is_dir))
            return
        if mask & (IN_DELETE | IN_DELETE_SELF):
            if mask & IN_DELETE_SELF and path == self.root:
                self._emit(WatchEvent(EventKind.REMOVE, path, is_dir=True))
                return
            if is_dir:
                self._rm_watch_under(path)
            self._emit(WatchEvent(EventKind.REMOVE, path, is_dir=is_dir))

    def _expire_move_from(self, cookie: int) -> None:
        """MOVED_FROM with no matching MOVED_TO: moved out of tree = remove."""
        pending = self._pending_from.pop(cookie, None)
        if pending is None:
            return
        old, is_dir, _handle = pending
        if is_dir:
            self._rm_watch_under(old)
        self._emit(WatchEvent(EventKind.REMOVE, old, is_dir=is_dir))

    def _rewrite_watches(self, old: str, new: str) -> None:
        for p, wd in list(self._path_wds.items()):
            if p == old or p.startswith(old + os.sep):
                np = new + p[len(old) :]
                self._path_wds.pop(p)
                self._path_wds[np] = wd
                self._wd_paths[wd] = np

    def _emit(self, event: WatchEvent) -> None:
        result = self.emit(event)
        if asyncio.iscoroutine(result):
            assert self._loop is not None
            supervise(self._loop.create_task(result), self._emit_tasks,
                      logger, "watcher emit handler")


def available() -> bool:
    return hasattr(_libc, "inotify_init1") and os.name == "posix"
