"""Filesystem watching: normalized events + per-platform backends.

Parity: ref:core/src/location/manager/watcher/ — `notify`-based
watchers with per-OS normalization; here an inotify ctypes backend on
Linux and a portable polling backend elsewhere, both emitting the same
`WatchEvent` vocabulary.

Counterpart of `spacedrive_tpu/location/watcher/__init__.py`: inotify
where `available()` says the host has it, polling otherwise (a host
without inotify, not a device fallback), and `force_polling` for tests.
"""

from __future__ import annotations

import platform
from typing import Awaitable, Callable

from .events import EventKind, WatchEvent
from .inotify import InotifyWatcher, available as inotify_available
from .polling import PollingWatcher


def new_watcher(
    root: str,
    emit: Callable[[WatchEvent], "Awaitable[None] | None"],
    *,
    force_polling: bool = False,
    poll_interval: float = 1.0,
):
    """RecommendedWatcher equivalent (ref:watcher/mod.rs:14)."""
    if not force_polling and platform.system() == "Linux" and inotify_available():
        return InotifyWatcher(root, emit)
    return PollingWatcher(root, emit, interval=poll_interval)


__all__ = [
    "EventKind",
    "InotifyWatcher",
    "PollingWatcher",
    "WatchEvent",
    "new_watcher",
]
