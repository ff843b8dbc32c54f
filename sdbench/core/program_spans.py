"""The program's own spans of a traced window, pass by pass.

The port keeps its completed spans in a ring
(`spacedrive_tpu_torch.telemetry.trace.recent()`, in this process), each
record with its dotted `stage` path, its `seconds` and `pc0`, its start
on `time.perf_counter()`: the clock of the benchmark's own spans and of
the device trace (trace.py). A program without `pc0` gives no records.

The ring drops its oldest records first, in the order the spans ended.
So once the ring is full, a pass is held whole where it started after
the end of the oldest record in the ring; a reader reads only such
passes, and a run whose program overflows the ring loses old passes,
not correctness.
"""

from __future__ import annotations

import math
from typing import Any


def window(ctx: Any) -> tuple[list[dict[str, Any]], int]:
    """(the ring's records that started inside a pass held whole, the
    number of such passes)."""
    from spacedrive_tpu_torch.telemetry import trace

    held = trace.recent()
    ring = [r for r in held if "pc0" in r]
    if not ring:
        return [], 0
    # a ring short of its size has dropped nothing
    cut = ring[0]["pc0"] + ring[0]["seconds"] if len(held) >= trace.TRACE_RING else -math.inf
    passes = sorted((a, b) for a, b in ctx.spans.get("pass", ()) if a > cut)
    recs = [r for r in ring if any(a <= r["pc0"] <= b for a, b in passes)]
    return recs, len(passes)


def per_pass(ctx: Any, stage: str, value=lambda r: r["seconds"]) -> float | None:
    """`value` of the records of `stage`, summed over the passes held
    whole, per pass; None where no such record has it."""
    recs, passes = window(ctx)
    got = [v for v in map(value, (r for r in recs if r["stage"] == stage)) if v is not None]
    if not got:
        return None
    return sum(got) / passes


def self_per_pass(ctx: Any, stage: str) -> float | None:
    """The self time of `stage` a pass: its records' seconds minus those
    of their children."""
    recs, passes = window(ctx)
    own = {r["span_id"]: r["seconds"] for r in recs if r["stage"] == stage}
    if not own:
        return None
    children = sum(r["seconds"] for r in recs if r.get("parent_id") in own)
    return (sum(own.values()) - children) / passes


def spans_of(ctx: Any, stage: str) -> tuple[list[tuple[float, float]], int]:
    """([(start, end)] of `stage`'s records in the passes held whole, the
    number of such passes)."""
    recs, passes = window(ctx)
    return [(r["pc0"], r["pc0"] + r["seconds"]) for r in recs if r["stage"] == stage], passes
