"""Distributed trace context: Dapper-style ids over the span layer.

An owned copy of `spacedrive_tpu/telemetry/trace.py`. Spans measure
*where* time goes; this module answers *whose* time it was. Every span
carries ``trace_id``/``span_id``/``parent_id``, and a small
``TraceContext`` travels across the boundaries where ``contextvars``
nesting dies:

- task-system dispatch (``tasks/system.py``): a task executes inside
  the trace of the caller that dispatched it;
- the window pipeline's producer thread (``parallel/feeder.py``);
- job suspend/resume (the context serializes into job state, so a job
  cold-resumed after a crash continues its original trace);
- the thumbnailer actor's batches (the context rides the persisted
  batch, ``object/media/thumbnail/state.py``).

Completed spans land in a bounded ring here; ``export()`` renders it as
Chrome-trace-event JSON (the ``traceEvents`` array format), loadable
directly in Perfetto / ``chrome://tracing``. The process lane keeps the
JAX package's name, so both packages' exports of the same spans are the
same document.

Propagation contract: ``current()`` reflects the innermost *active*
span (every ``Span.__enter__`` publishes itself here) or, absent one,
whatever context a boundary installed via ``use()``. A span opening
with no parent span adopts ``current()`` as its parent; with nothing
ambient it mints a fresh root trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
from collections import deque
from typing import Any, Iterator

TRACE_RING = 4096  # completed spans retained for export


class TraceContext:
    """An addressable point in a trace: (trace_id, span_id)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def to_wire(self) -> dict[str, str]:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_wire(cls, d: Any) -> "TraceContext | None":
        """Tolerant decode: anything that isn't a dict with both ids is
        treated as 'no context' (the wire field is best-effort)."""
        if not isinstance(d, dict):
            return None
        trace_id, span_id = d.get("trace_id"), d.get("span_id")
        if not isinstance(trace_id, str) or not isinstance(span_id, str):
            return None
        return cls(trace_id, span_id)

    def __repr__(self) -> str:
        return f"<TraceContext {self.trace_id[:8]}…/{self.span_id}>"


def new_trace_id() -> str:
    return os.urandom(16).hex()  # 128-bit, W3C-trace-context sized


def new_span_id() -> str:
    return os.urandom(8).hex()


def new_context() -> TraceContext:
    """A fresh root context (the origin point of a new trace)."""
    return TraceContext(new_trace_id(), new_span_id())


_ambient: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "sd_trace_ctx", default=None
)


def current() -> TraceContext | None:
    """The context new spans (and outbound messages) should join."""
    return _ambient.get()


def wire_current() -> dict[str, str] | None:
    ctx = _ambient.get()
    return ctx.to_wire() if ctx is not None else None


def set_current(ctx: TraceContext | None) -> contextvars.Token:
    """Low-level install (spans, boundary shims). Pair with
    ``reset_current``."""
    return _ambient.set(ctx)


def reset_current(token: contextvars.Token) -> None:
    _ambient.reset(token)


@contextlib.contextmanager
def use(ctx: TraceContext | None) -> Iterator[TraceContext | None]:
    """Run a block under ``ctx``; ``use(None)`` is a no-op so call
    sites don't need to branch on 'did the wire carry a context'."""
    if ctx is None:
        yield None
        return
    token = _ambient.set(ctx)
    try:
        yield ctx
    finally:
        _ambient.reset(token)


# --- the completed-span ring -------------------------------------------


_ring: deque[dict[str, Any]] = deque(maxlen=TRACE_RING)
_ring_lock = threading.Lock()


def record_span(rec: dict[str, Any]) -> None:
    """Append one completed span record. Expected keys: ``stage``,
    ``trace_id``, ``span_id``, ``parent_id``, ``t0`` (epoch seconds),
    ``seconds``, plus optional ``bytes``/``error``/extra args. Spans
    call this on exit, adding ``pc0`` (the start on
    ``time.perf_counter()``); boundary shims (task dispatch) record
    synthetic spans directly."""
    with _ring_lock:
        _ring.append(rec)


def recent(trace_id: str | None = None) -> list[dict[str, Any]]:
    """Most-recent-last completed span records, optionally filtered to
    one trace."""
    with _ring_lock:
        recs = list(_ring)
    if trace_id is not None:
        recs = [r for r in recs if r.get("trace_id") == trace_id]
    return recs


def clear() -> None:
    with _ring_lock:
        _ring.clear()


# --- Chrome-trace-event export -----------------------------------------


def _tid_for(trace_id: str) -> int:
    """Stable per-trace lane so Perfetto groups one trace's spans
    together (31-bit to stay a small positive JSON int)."""
    return int(trace_id[:8], 16) & 0x7FFFFFFF


def export(trace_id: str | None = None) -> dict[str, Any]:
    """The ring as Chrome trace JSON: ``{"traceEvents": [...]}`` with
    complete ("X") events, microsecond timestamps, and the trace/span
    ids in ``args`` — loadable as-is in Perfetto."""
    pid = os.getpid()
    events: list[dict[str, Any]] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": "spacedrive_tpu"},
        }
    ]
    for rec in recent(trace_id):
        args: dict[str, Any] = {
            "trace_id": rec.get("trace_id"),
            "span_id": rec.get("span_id"),
            "parent_id": rec.get("parent_id"),
        }
        if rec.get("bytes"):
            args["bytes"] = rec["bytes"]
        if rec.get("error"):
            args["error"] = rec["error"]
        if rec.get("fields"):
            args.update(rec["fields"])  # span.annotate() scalars
        events.append(
            {
                "name": rec.get("stage", "?"),
                "cat": "span",
                "ph": "X",
                "ts": int(float(rec.get("t0", 0.0)) * 1e6),
                "dur": max(1, int(float(rec.get("seconds", 0.0)) * 1e6)),
                "pid": pid,
                "tid": _tid_for(rec.get("trace_id") or "0" * 8),
                "args": args,
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}
