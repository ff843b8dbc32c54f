"""In-process event bus.

Parity: the reference's `event_bus` broadcast channel on Node
(ref:core/src/lib.rs:113 `event_bus: broadcast::channel(256)`) carrying
`CoreEvent` (ref:core/src/api/mod.rs:54-58). Here: a synchronous
fan-out bus with bounded per-subscriber queues; async consumers drain
via `subscribe()` queues, and `on()` callbacks run synchronously in the
emitter (a library's sync notifications wake its peers' ingest actors
this way).

Counterpart of `spacedrive_tpu/utils/events.py`.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable


class Subscription:
    def __init__(self, bus: "EventBus", maxlen: int):
        self._bus = bus
        self.queue: collections.deque[Any] = collections.deque(maxlen=maxlen)
        self._cond = threading.Condition()

    def push(self, event: Any) -> None:
        with self._cond:
            self.queue.append(event)
            self._cond.notify_all()

    def poll(self) -> list[Any]:
        with self._cond:
            items = list(self.queue)
            self.queue.clear()
            return items

    def close(self) -> None:
        self._bus.unsubscribe(self)


class EventBus:
    """Broadcast bus: every subscriber sees every event (lossy on overflow,
    like the reference's tokio broadcast channel)."""

    def __init__(self, capacity: int = 256):
        self._capacity = capacity
        self._subs: list[Subscription] = []
        self._callbacks: list[Callable[[Any], None]] = []
        self._lock = threading.Lock()

    def emit(self, event: Any) -> None:
        with self._lock:
            subs = list(self._subs)
            cbs = list(self._callbacks)
        for sub in subs:
            sub.push(event)
        for cb in cbs:
            cb(event)

    def subscribe(self) -> Subscription:
        sub = Subscription(self, self._capacity)
        with self._lock:
            self._subs.append(sub)
        return sub

    def on(self, callback: Callable[[Any], None]) -> Callable[[], None]:
        """Call `callback(event)` on every emit; returns its remover."""
        with self._lock:
            self._callbacks.append(callback)

        def off():
            with self._lock:
                if callback in self._callbacks:
                    self._callbacks.remove(callback)

        return off

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)
