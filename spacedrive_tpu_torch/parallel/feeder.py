"""Host→device feeding: overlap disk reads with device compute.

Counterpart of `spacedrive_tpu/parallel/feeder.py`, with its
`feeder.fetch` fault point, its one producer restart, its callable
depth, its five series (fetch and wait seconds, H2D bytes, in-flight
depth, prefetch hits), its `feeder.fetch` and `feeder.wait` spans and
its trace propagation: the producer thread (and its restart) runs under
the trace of the code that built the pipeline. On a
large library the sampled reads (~56 KiB a file) dominate wall-clock,
so the host must read window N+1 while the device hashes window N.
`WindowPipeline` does that: a producer thread chains a cursor fetch
function back to back into a bounded buffer of `depth` windows. Each
window's fetch also dispatches its device batch (ops/cas.cas_ids_begin
enqueues on a side stream and returns a finisher), so up to `depth`
transfers and kernels are in flight while the consumer finishes
earlier windows. The autotune controller reads the series and sizes
`depth` (parallel/autotune.py).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Callable, Generic, TypeVar

from ..telemetry import metrics as _tm
from ..telemetry import span as _span
from ..telemetry import trace as _trace
from ..telemetry.events import RESILIENCE_EVENTS
from ..utils import faults as _faults
from .autotune import FEEDER_BASE_DEPTH

logger = logging.getLogger(__name__)

T = TypeVar("T")


def pipeline_depth(n_devices: int, base: int = FEEDER_BASE_DEPTH, cap: int = 8) -> int:
    """Prefetch depth that keeps an n-device dp dispatch fed: one extra
    in-flight window per doubling of the device count (each window
    drains n× faster, so the producer needs more read-ahead to hide the
    same disk latency), capped so host memory stays bounded. 1→3, 2→4,
    4→5, 8→6."""
    return min(cap, base + max(0, int(n_devices).bit_length() - 1))


class WindowPipeline(Generic[T]):
    """Bounded multi-window producer pipeline.

    `fetch(key)` returns `(next_key, window)`, or `None` when the cursor
    is exhausted. A daemon producer thread chains fetches back to back
    and parks up to `depth` ready windows; `take()` hands them to the
    consumer in order (`None` = end of stream). `close()` stops the
    producer promptly. A producer that crashes (an exception in `fetch`,
    or the `feeder.fetch` fault) is restarted once, resuming at the key
    whose fetch failed (fetches are side-effect-free); a second crash
    ends the stream and is raised to the consumer by `take()`.

    `depth` may be a callable (the autotune policy's live read): it is
    re-read for every parked window, so a mid-job change takes effect on
    the next fetch. `measure(window) -> bytes` attributes each fetched
    window's host→device payload to `sd_feeder_h2d_bytes_total`."""

    def __init__(
        self,
        fetch: Callable[[Any], "tuple[Any, T] | None"],
        start_key: Any,
        depth: "int | Callable[[], int]" = FEEDER_BASE_DEPTH,
        measure: Callable[[T], int] | None = None,
    ):
        # unbounded deque + condition (not a bounded Queue): close()
        # must wake a blocked consumer at once; `depth` only throttles
        # the producer
        self._buf: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._depth_fn = depth if callable(depth) else None
        self._depth = 1 if callable(depth) else max(1, depth)
        self._measure = measure
        self._stop = threading.Event()
        self._done = False
        self._fetch = fetch
        self._error: BaseException | None = None
        self._restarts_left = 1
        # a thread starts with empty contextvars: carry the building
        # task's trace across, so the producer's feeder.fetch spans join it
        self._trace_ctx = _trace.current()
        self._thread = threading.Thread(
            target=self._run, args=(start_key,), name="sd-window-pipeline",
            daemon=True,
        )
        self._thread.start()

    def _run(self, key: Any) -> None:
        # the first producer and its restart both run here
        if self._trace_ctx is not None:
            _trace.set_current(self._trace_ctx)
        try:
            while not self._stop.is_set():
                spec = _faults.hit("feeder.fetch")
                if spec is not None:
                    if spec.mode == "stall":
                        time.sleep(spec.delay_s)
                    elif spec.mode == "crash":
                        raise _faults.InjectedFault("injected feeder producer crash")
                t0 = time.perf_counter()
                with _span("feeder.fetch"):
                    item = self._fetch(key)
                _tm.FEEDER_FETCH_SECONDS.observe(time.perf_counter() - t0)
                if item is None:
                    self._put(None)
                    return
                key, window = item
                if self._measure is not None:
                    try:
                        _tm.FEEDER_H2D_BYTES.inc(self._measure(window))
                    except Exception:  # noqa: BLE001 - measurement must never kill reads
                        pass
                if not self._put(window):
                    return
        except BaseException as e:
            if self._restart(key, e):
                return
            # restart budget spent: surfaced to the consumer on take(),
            # published under the condition BEFORE the sentinel is
            # parked, so the consumer that pops the sentinel sees it
            with self._cond:
                self._error = e
            self._put(None)

    def _restart(self, key: Any, exc: BaseException) -> bool:
        """Re-spawn the producer once after a crash, resuming at the
        window whose fetch failed. Returns False when the budget is
        spent — the caller then surfaces the error."""
        if self._stop.is_set() or self._restarts_left <= 0:
            return False
        self._restarts_left -= 1
        _tm.FEEDER_RESTARTS.inc()
        RESILIENCE_EVENTS.emit("feeder_restart", error=str(exc)[:200])
        logger.warning("window pipeline producer crashed (%r); restarting it once", exc)
        replacement = threading.Thread(
            target=self._run, args=(key,), name="sd-window-pipeline", daemon=True,
        )
        # the handle swap races close()'s join of the old thread: both
        # sides go through the condition, so close() joins the live one
        with self._cond:
            self._thread = replacement
        replacement.start()
        return True

    def _depth_now(self) -> int:
        """Current read-ahead bound; a broken policy callable degrades
        to depth 1 (throttled, never wedged or unbounded)."""
        if self._depth_fn is None:
            return self._depth
        try:
            return max(1, int(self._depth_fn()))
        except Exception:  # noqa: BLE001 - policy reads must never kill reads
            return 1

    def _put(self, item) -> bool:
        """Park one window (or the end-of-stream sentinel); blocks while
        `depth` windows are parked, aborts when close() is called. The
        sentinel never blocks."""
        with self._cond:
            while (
                item is not None
                and len(self._buf) >= self._depth_now()
                and not self._stop.is_set()
            ):
                self._cond.wait()
            if self._stop.is_set():
                return False
            self._buf.append(item)
            _tm.FEEDER_INFLIGHT.set(len(self._buf))
            self._cond.notify_all()
            return True

    def take(self) -> T | None:
        """Next window in order; None at end of stream (raises if the
        producer died) or after close(). The time the consumer spent
        blocked is observed as feeder wait; a handoff under 2 ms counts
        as a prefetch hit. Once the end-of-stream sentinel has been
        consumed every further take() returns None at once."""
        if self._done:
            with self._cond:
                err = self._error
            if err is not None:
                raise err
            return None
        t0 = time.perf_counter()
        with _span("feeder.wait"), self._cond:
            while not self._buf and not self._stop.is_set():
                self._cond.wait()
            if self._buf:
                window = self._buf.popleft()
                self._cond.notify_all()  # free the producer's slot
            else:  # closed
                window = None
            inflight = len(self._buf)
            err = self._error
        waited = time.perf_counter() - t0
        _tm.FEEDER_WAIT_SECONDS.observe(waited)
        _tm.FEEDER_PREFETCH.inc(result="hit" if waited < 0.002 else "miss")
        _tm.FEEDER_INFLIGHT.set(inflight)
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
            # the live producer: _restart swaps the handle under the
            # same condition
            producer = self._thread
        producer.join(timeout=5)
