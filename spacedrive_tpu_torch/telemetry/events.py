"""Flight recorder — bounded per-subsystem rings of structured events.

An owned copy of `spacedrive_tpu/telemetry/events.py`. Metrics answer
"how much"; the flight recorder answers "what happened just before it
went wrong". Each subsystem gets a small always-on ring of structured
events (job state transitions, demotions, feeder restarts, fault
activations, errors with tracebacks, slow-op watchdog firings,
event-loop-lag samples). Rings are bounded deques, so a retry storm can
never grow memory, and they dump wholesale into the debug bundle
(``telemetry.bundle``). An event emitted under an active trace carries
its ``trace_id``; a span slower than ``SLOW_OP_SECONDS`` fires the
watchdog ring; a loop-lag sample past the warning opens one capture
window of the host sampler (``telemetry/sampler.py``).

Cardinality discipline: the event ``type`` is a CONSTANT string and
field *names* are literal keyword arguments. Field *values* may be
dynamic: they are payload inside a bounded ring, not label sets inside
a metrics family.
"""

from __future__ import annotations

import threading
import time
import traceback as _tb
from collections import deque
from typing import Any

from . import metrics, trace

RING_CAPACITY = 512
MAX_TRACEBACK_CHARS = 8192

# spans slower than this fire a watchdog event (see spans.Span.__exit__)
SLOW_OP_SECONDS = 1.0


class EventRing:
    """One subsystem's bounded event log. ``emit`` is safe from any
    thread; events carry a wall-clock timestamp and, when a trace is
    active, the trace id that caused them."""

    def __init__(self, name: str, capacity: int = RING_CAPACITY):
        self.name = name
        self._ring: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        # honest-overflow accounting: a bounded ring that silently
        # displaces its oldest events reads as "nothing else happened";
        # the drop counter says how much story is missing
        self.dropped = 0

    def emit(self, type: str, **fields: Any) -> None:
        ctx = trace.current()
        rec: dict[str, Any] = {"ts": time.time(), "type": type}
        if ctx is not None:
            rec["trace_id"] = ctx.trace_id
        if fields:
            rec["fields"] = fields
        with self._lock:
            overflowed = (
                self._ring.maxlen is not None
                and len(self._ring) >= self._ring.maxlen
            )
            if overflowed:
                self.dropped += 1
            self._ring.append(rec)
        if overflowed:
            # outside the ring lock: the registry has its own
            metrics.RING_DROPPED.inc(ring=self.name)

    def snapshot(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


_rings: dict[str, EventRing] = {}
_rings_lock = threading.Lock()


def ring(name: str, capacity: int = RING_CAPACITY) -> EventRing:
    """Get-or-create a named ring (idempotent, like metric families)."""
    with _rings_lock:
        r = _rings.get(name)
        if r is None:
            r = _rings[name] = EventRing(name, capacity)
        return r


def all_events() -> dict[str, list[dict[str, Any]]]:
    """Every ring's contents."""
    with _rings_lock:
        rings = list(_rings.values())
    return {r.name: r.snapshot() for r in rings}


def drop_counts() -> dict[str, int]:
    """Per-ring overflow drops since the last clear, so a consumer can
    tell a quiet ring from a saturated one."""
    with _rings_lock:
        rings = list(_rings.values())
    return {r.name: r.dropped for r in rings if r.dropped}


def clear_all() -> None:
    with _rings_lock:
        rings = list(_rings.values())
    for r in rings:
        r.clear()


# --- the predeclared subsystem rings -----------------------------------

JOB_EVENTS = ring("jobs")          # job state transitions
P2P_EVENTS = ring("p2p")           # connects, stream opens, retransmits
SYNC_EVENTS = ring("sync")         # ingest accept/reject transitions, delta-guard trips
WATCHER_EVENTS = ring("watcher")   # debounced burst flushes
ERROR_EVENTS = ring("errors")      # caught and uncaught exceptions w/ tracebacks
WATCHDOG_EVENTS = ring("watchdog")  # slow-op firings
LOOP_EVENTS = ring("loop")         # event-loop-lag samples over threshold
FAULT_EVENTS = ring("faults")      # injected-fault activations (utils/faults)
RESILIENCE_EVENTS = ring("resilience")  # demotions, last rungs, feeder restarts
AUTOTUNE_EVENTS = ring("autotune")  # closed-loop tuning decisions (w/ trace_id)
WORK_EVENTS = ring("work")         # mesh work-stealing: publishes, leases, steals, expiries
SERVE_EVENTS = ring("serve")       # admission gate: sheds (w/ trace_id), mode transitions


def record_error(source: str, exc: BaseException | None,
                 exc_info: tuple | None = None) -> None:
    """One caught or uncaught exception into the error ring, traceback
    bounded. ``source`` names the hook that caught it — a fixed
    vocabulary, not a runtime string."""
    if exc_info is None and exc is not None:
        exc_info = (type(exc), exc, exc.__traceback__)
    if exc_info is None:
        return
    tb_text = "".join(_tb.format_exception(*exc_info))[-MAX_TRACEBACK_CHARS:]
    ERROR_EVENTS.emit(
        "exception",
        source=source,
        exc_type=getattr(exc_info[0], "__name__", str(exc_info[0])),
        message=str(exc_info[1])[:500],
        traceback=tb_text,
    )


def watchdog_slow_op(stage: str, seconds: float) -> None:
    """A span exceeded SLOW_OP_SECONDS (called by spans on exit)."""
    WATCHDOG_EVENTS.emit("slow_op", stage=stage, seconds=round(seconds, 4))


class LoopLagMonitor:
    """Samples event-loop scheduling lag: sleeps ``interval`` and
    measures how late the wakeup lands. Every sample updates the
    ``sd_event_loop_lag_seconds`` gauge (the autotune controller's lag
    signal); samples past ``warn_s`` also land in the loop ring and
    trigger one capture window of the host sampler."""

    def __init__(self, interval: float = 0.5, warn_s: float = 0.2):
        self.interval = interval
        self.warn_s = warn_s
        self._task: Any = None
        self._tasks: set = set()
        self._stopped = False

    def start(self) -> None:
        import asyncio
        import logging

        from ..utils.tasks import supervise

        if self._task is not None and not self._task.done():
            return
        self._stopped = False
        self._task = supervise(
            asyncio.get_running_loop().create_task(self._run()),
            self._tasks, logging.getLogger(__name__), "loop-lag monitor",
        )

    async def stop(self) -> None:
        self._stopped = True
        task = self._task
        self._task = None
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            except BaseException:  # noqa: BLE001 - cancellation cleanup
                pass

    async def _run(self) -> None:
        import asyncio

        from . import sampler as _sampler

        while not self._stopped:
            t0 = time.monotonic()
            await asyncio.sleep(self.interval)
            lag = max(0.0, (time.monotonic() - t0) - self.interval)
            metrics.EVENT_LOOP_LAG.set(lag)
            if lag >= self.warn_s:
                LOOP_EVENTS.emit("lag", seconds=round(lag, 4))
                # loop-lag degradation opens a deep-capture window: the
                # sampler names the frames that starved the loop; its
                # cooldown absorbs a sustained-lag train into ONE window
                _sampler.trigger("loop_lag")
