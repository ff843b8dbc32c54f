"""Host→device feeding: overlap disk reads with device compute.

Counterpart of `spacedrive_tpu/parallel/feeder.py`, without its
telemetry, fault hooks and producer restart. On a large library the
sampled reads (~56 KiB a file) dominate wall-clock, so the host must
read window N+1 while the device hashes window N. `WindowPipeline` does
that: a producer thread chains a cursor fetch function back to back
into a bounded buffer of `depth` windows. Each window's fetch also
dispatches its device batch (ops/cas.cas_ids_begin enqueues on a side
stream and returns a finisher), so up to `depth` transfers and kernels
are in flight while the consumer finishes earlier windows.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Generic, TypeVar

from .autotune import FEEDER_BASE_DEPTH

T = TypeVar("T")


class WindowPipeline(Generic[T]):
    """Bounded multi-window producer pipeline.

    `fetch(key)` returns `(next_key, window)`, or `None` when the cursor
    is exhausted. A daemon producer thread chains fetches back to back
    and parks up to `depth` ready windows; `take()` hands them to the
    consumer in order (`None` = end of stream). `close()` stops the
    producer promptly. An exception in `fetch` ends the stream and is
    raised to the consumer by `take()`."""

    def __init__(
        self,
        fetch: Callable[[Any], "tuple[Any, T] | None"],
        start_key: Any,
        depth: int = FEEDER_BASE_DEPTH,
    ):
        # unbounded deque + condition (not a bounded Queue): close()
        # must wake a blocked consumer at once; `depth` only throttles
        # the producer
        self._buf: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._depth = max(1, depth)
        self._stop = threading.Event()
        self._done = False
        self._fetch = fetch
        self._error: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, args=(start_key,), name="sd-window-pipeline",
            daemon=True,
        )
        self._thread.start()

    def _run(self, key: Any) -> None:
        try:
            while not self._stop.is_set():
                item = self._fetch(key)
                if item is None:
                    self._put(None)
                    return
                key, window = item
                if not self._put(window):
                    return
        except BaseException as e:  # surfaced to the consumer, never lost
            # published under the condition BEFORE the sentinel is
            # parked, so the consumer that pops the sentinel sees it
            with self._cond:
                self._error = e
            self._put(None)

    def _put(self, item) -> bool:
        """Park one window (or the end-of-stream sentinel); blocks while
        `depth` windows are parked, aborts when close() is called. The
        sentinel never blocks."""
        with self._cond:
            while (
                item is not None
                and len(self._buf) >= self._depth
                and not self._stop.is_set()
            ):
                self._cond.wait()
            if self._stop.is_set():
                return False
            self._buf.append(item)
            self._cond.notify_all()
            return True

    def take(self) -> T | None:
        """Next window in order; None at end of stream (raises if the
        producer died) or after close(). Once the end-of-stream sentinel
        has been consumed every further take() returns None at once."""
        if self._done:
            with self._cond:
                err = self._error
            if err is not None:
                raise err
            return None
        with self._cond:
            while not self._buf and not self._stop.is_set():
                self._cond.wait()
            if self._buf:
                window = self._buf.popleft()
                self._cond.notify_all()  # free the producer's slot
            else:  # closed
                window = None
            err = self._error
        if window is None:
            self._done = True
            if err is not None:
                raise err
        return window

    def close(self) -> None:
        with self._cond:
            self._stop.set()
            # one notify wakes both sides: a producer blocked on a full
            # buffer and a consumer blocked on an empty one
            self._cond.notify_all()
        self._thread.join(timeout=5)
