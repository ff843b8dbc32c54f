"""Pipeline spans: per-stage wall time and byte accounting.

An owned copy of `spacedrive_tpu/telemetry/spans.py`. The walk →
identify → hash → thumbnail pipeline reports its stage timings through
spans: a context manager (sync and async; nesting propagates through
``contextvars``, so concurrent asyncio tasks can't cross-contaminate
parentage) that on exit

- observes ``sd_span_seconds{stage=…}`` and, when bytes were attached,
  ``sd_span_bytes_total{stage=…}``;
- appends a record to a bounded in-memory ring the ``telemetry.
  snapshot`` procedure exposes;
- debug-logs through the logging tree (target
  ``spacedrive_tpu_torch.telemetry.spans``).

Stages are dotted paths: a span opened inside another records as
``parent.child`` (e.g. ``identify.hash``).

Every span also carries distributed-trace identity (``trace_id``/
``span_id``/``parent_id``, see ``telemetry.trace``): a nested span
inherits its parent's trace; a root span adopts the ambient
``trace.current()`` context installed by a boundary (task dispatch, job
resume, the feeder's producer thread, a thumbnail batch) or mints a
fresh trace. Completed spans land in the trace ring for Chrome-trace
export, and spans slower than ``events.SLOW_OP_SECONDS`` fire the
slow-op watchdog ring. A span is host wall time: one that covers device
work ends where its body already waited for the result, and a span
re-raises whatever its body raised.
"""

from __future__ import annotations

import contextvars
import logging
import threading
import time
from collections import deque
from typing import Any

from . import events as _events
from . import metrics
from . import trace as _trace

logger = logging.getLogger(__name__)

RECENT_SPANS = 256

_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "sd_current_span", default=None
)
_recent: deque[dict[str, Any]] = deque(maxlen=RECENT_SPANS)
_recent_lock = threading.Lock()


class Span:
    """One timed pipeline stage. Use via ``span(...)``:

        with span("identify.hash", nbytes=len(batch)):
            ...
        async with span("walk"):
            ...
    """

    __slots__ = (
        "stage", "nbytes", "path", "_t0", "_t0_wall", "_token",
        "_trace_token", "duration", "trace_id", "span_id", "parent_id",
        "fields",
    )

    def __init__(self, stage: str, nbytes: int = 0):
        self.stage = stage
        self.nbytes = int(nbytes)
        self.fields: dict[str, Any] | None = None
        self.path = stage  # parent-prefixed on enter
        self._t0 = 0.0
        self._t0_wall = 0.0
        self._token: contextvars.Token | None = None
        self._trace_token: contextvars.Token | None = None
        self.duration: float | None = None
        self.trace_id: str = ""
        self.span_id: str = ""
        self.parent_id: str | None = None

    def add_bytes(self, n: int) -> None:
        """Attribute more bytes mid-span (e.g. per-file in a loop)."""
        self.nbytes += int(n)

    def annotate(self, **fields: Any) -> None:
        """Attach small scalar fields to the span record (ring + trace
        export) — e.g. the index-journal verdict counts of an identify
        window. Keep values to scalars; this is NOT a payload channel."""
        if self.fields is None:
            self.fields = {}
        self.fields.update(fields)

    # -- sync protocol --

    def __enter__(self) -> "Span":
        parent = _current.get()
        if parent is not None:
            self.path = f"{parent.path}.{self.stage}"
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            # no enclosing span: join the ambient trace context a
            # boundary installed (dispatch, resume, wire) or start fresh
            ctx = _trace.current()
            if ctx is not None:
                self.trace_id = ctx.trace_id
                self.parent_id = ctx.span_id
            else:
                self.trace_id = _trace.new_trace_id()
        self.span_id = _trace.new_span_id()
        self._token = _current.set(self)
        self._trace_token = _trace.set_current(
            _trace.TraceContext(self.trace_id, self.span_id)
        )
        self._t0_wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.duration = time.perf_counter() - self._t0
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if self._trace_token is not None:
            _trace.reset_current(self._trace_token)
            self._trace_token = None
        metrics.SPAN_SECONDS.observe(self.duration, stage=self.path)
        if self.nbytes:
            metrics.SPAN_BYTES.inc(self.nbytes, stage=self.path)
        rec = {
            "stage": self.path,
            "seconds": self.duration,
            "bytes": self.nbytes,
            "error": exc_type.__name__ if exc_type is not None else None,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
        }
        if self.fields:
            rec["fields"] = dict(self.fields)
        with _recent_lock:
            _recent.append(rec)
        # pc0: the start on time.perf_counter(), the clock a device trace
        # can be mapped onto, so spans and kernels share one timeline
        _trace.record_span({**rec, "t0": self._t0_wall, "pc0": self._t0})
        if self.duration >= _events.SLOW_OP_SECONDS:
            _events.watchdog_slow_op(self.path, self.duration)
        logger.debug("span %s: %.3fms%s", self.path, self.duration * 1e3,
                     f" {self.nbytes}B" if self.nbytes else "")

    # -- async protocol (same semantics; contextvars carry across await) --

    async def __aenter__(self) -> "Span":
        return self.__enter__()

    async def __aexit__(self, exc_type, exc, tb) -> None:
        self.__exit__(exc_type, exc, tb)


def span(stage: str, nbytes: int = 0) -> Span:
    return Span(stage, nbytes)


def current_span() -> Span | None:
    return _current.get()


def recent_spans() -> list[dict[str, Any]]:
    """Most-recent-last completed spans (bounded ring)."""
    with _recent_lock:
        return list(_recent)


def clear_recent() -> None:
    with _recent_lock:
        _recent.clear()
