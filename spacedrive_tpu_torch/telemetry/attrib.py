"""Critical-path attribution — where did a pass's wall-clock go?

An owned copy of `spacedrive_tpu/telemetry/attrib.py`, bucket
vocabulary, stage table and sweep unchanged. Given a ``trace_id`` (or
"the last pass", via the job-boundary markers ``jobs/manager.py`` drops
here), it:

1. takes the trace's spans from the local trace ring and, on a node
   with a P2P manager, every reachable peer's executor-side spans of the
   trace (the ``trace_pull`` TELEMETRY op; a failed pull makes the
   report ``partial``);
2. computes the **critical path**: a sweep over span boundaries
   attributes every wall-clock slice of the pass window to the most
   blocking active span (resource priority, then nesting depth) —
   slices no span covers, and slices only orchestration spans cover,
   are the *unattributed gap*;
3. buckets the path's time: ``device`` (spans that end where the code
   waits on the card: the finisher's copy of K1's words, the resize's
   host arrays — host wall time, not the card's busy time),
   ``host_cpu`` (walk, decode, encode, DB linking, journal; the process
   pool's batches), ``link`` (the host→device feeder and every network
   leg), ``queue_wait`` (task-system queue time) and ``gap``.

Buckets partition the pass window exactly, so "buckets sum to ≥ 90% of
the measured wall time" is a statement about span coverage of the
pass. The host profiler's timeline names the code inside the ``gap``
and ``host_cpu`` buckets (``*_decomposition``). Surfaces: rspc
``telemetry.attrib``, the CLI's ``attrib``. Reports of settled passes
are cached per trace (bounded; cleared by ``telemetry.reset()``).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Iterable

from . import metrics as _tm
from . import trace as _trace

#: bucket vocabulary (stable: bench_e2e + bench_compare gate on it)
DEVICE = "device"
HOST_CPU = "host_cpu"
LINK = "link"
QUEUE_WAIT = "queue_wait"
GAP = "gap"
BUCKETS = (DEVICE, HOST_CPU, LINK, QUEUE_WAIT, GAP)

#: when two spans cover the same wall slice, the more "blocking"
#: resource wins: device compute outranks host work outranks transport
#: outranks queueing; orchestration/container spans (GAP) never outrank
#: a real stage. Ties break by nesting depth (innermost span wins).
_PRIORITY = {DEVICE: 4, HOST_CPU: 3, LINK: 2, QUEUE_WAIT: 1, GAP: 0}

#: full-path head → bucket: every network-plane span family
_HEAD_BUCKETS = {
    "p2p": LINK,
    "relay": LINK,
    "cloud": LINK,
    "feeder": LINK,  # H2D staging: producer fetch AND consumer wait
    # batches riding the multi-process execution plane: the pass is
    # waiting on host CPU burned in pool workers (their GIL, not ours)
    "procpool": HOST_CPU,
}

#: last dotted segment → bucket for the pipeline stages
_SEGMENT_BUCKETS = {
    # device compute
    "hash": DEVICE,        # identify.hash, mesh.shard_hash (via last seg)
    "shard_hash": DEVICE,
    "device": DEVICE,      # thumbnail.device
    "resize": DEVICE,
    # host CPU
    "walk": HOST_CPU,
    "db": HOST_CPU,        # identify.db (SQL linking)
    "decode": HOST_CPU,
    "encode": HOST_CPU,
    "ingest": HOST_CPU,    # sync.ingest (op apply is SQLite + Python)
    "request": HOST_CPU,   # sync.request assembly
    "journal": HOST_CPU,
    "store": HOST_CPU,
    # queueing
    "dispatch": QUEUE_WAIT,  # the synthetic task.dispatch queue-wait span
    "queue": QUEUE_WAIT,
    "admit": QUEUE_WAIT,
}

_REPORT_CACHE_MAX = 16
_PASS_RING = 64


def bucket_of(stage: str) -> str:
    """Classify a span stage path. Unknown stages are orchestration:
    their self-time is the unattributed gap."""
    head = stage.split(".", 1)[0]
    got = _HEAD_BUCKETS.get(head)
    if got is not None:
        return got
    return _SEGMENT_BUCKETS.get(stage.rsplit(".", 1)[-1], GAP)


# --- pass boundary markers (jobs/manager.py) -----------------------------

_passes: collections.deque = collections.deque(maxlen=_PASS_RING)
_passes_lock = threading.Lock()


def mark_pass(job: str, trace_id: str, event: str, **fields: Any) -> None:
    """A job-pass boundary: ``started`` at ingest, ``settled`` when the
    supervisor closes it. ``sdx attrib`` with no trace id resolves "the
    last pass" through these markers instead of guessing from the span
    ring."""
    rec = {"ts": time.time(), "job": job, "trace_id": trace_id,
           "event": event}
    if fields:
        rec.update(fields)
    with _passes_lock:
        _passes.append(rec)


def recent_passes() -> list[dict[str, Any]]:
    with _passes_lock:
        return list(_passes)


def last_pass_trace() -> str | None:
    """The most recently *settled* pass's trace id (falling back to the
    most recently started one when nothing settled yet)."""
    started = None
    with _passes_lock:
        for rec in reversed(_passes):
            if rec["event"] == "settled":
                return rec["trace_id"]
            if started is None:
                started = rec["trace_id"]
    return started


def _pass_settled(trace_id: str) -> bool:
    """True when this trace's pass markers prove the pass is over: at
    least one job settled under it and none started after the last
    settle (chained jobs share one trace — a mid-chain read must not
    freeze a half-pass report in the cache)."""
    with _passes_lock:
        last = None
        for rec in _passes:
            if rec["trace_id"] == trace_id:
                last = rec["event"]
    return last == "settled"


# --- the sweep -----------------------------------------------------------


def _span_intervals(spans: Iterable[dict[str, Any]]) -> list[dict[str, Any]]:
    """Normalize raw span records into sweep intervals with bucket,
    priority, and tree depth (via parent links where present)."""
    by_id: dict[str, dict[str, Any]] = {}
    out: list[dict[str, Any]] = []
    for rec in spans:
        try:
            t0 = float(rec["t0"])
            dur = max(0.0, float(rec.get("seconds", 0.0)))
        except (KeyError, TypeError, ValueError):
            continue
        iv = {
            "stage": str(rec.get("stage", "?")),
            "t0": t0,
            "t1": t0 + dur,
            "span_id": rec.get("span_id"),
            "parent_id": rec.get("parent_id"),
            "node": rec.get("node", "local"),
        }
        iv["bucket"] = bucket_of(iv["stage"])
        out.append(iv)
        if iv["span_id"]:
            by_id[iv["span_id"]] = iv
    for iv in out:
        depth = 0
        cur = iv
        seen = set()
        while cur is not None and cur["parent_id"] in by_id:
            pid = cur["parent_id"]
            if pid in seen:  # defensive: a wire-supplied cycle must not hang
                break
            seen.add(pid)
            depth += 1
            cur = by_id[pid]
        iv["depth"] = depth
    return out


def _sweep(intervals: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Partition the pass window into critical-path segments: between
    consecutive span boundaries the active set is constant; each slice
    goes to the active span with the highest (bucket priority, depth,
    start) — or to nobody (a pure gap)."""
    if not intervals:
        return []
    bounds = sorted({iv["t0"] for iv in intervals}
                    | {iv["t1"] for iv in intervals})
    # event sweep: active set maintained across boundaries
    starts = sorted(intervals, key=lambda iv: iv["t0"])
    ends = sorted(intervals, key=lambda iv: iv["t1"])
    active: dict[int, dict[str, Any]] = {}
    si = ei = 0
    segments: list[dict[str, Any]] = []
    for i in range(len(bounds) - 1):
        t, t2 = bounds[i], bounds[i + 1]
        while si < len(starts) and starts[si]["t0"] <= t:
            active[id(starts[si])] = starts[si]
            si += 1
        while ei < len(ends) and ends[ei]["t1"] <= t:
            active.pop(id(ends[ei]), None)
            ei += 1
        if t2 <= t:
            continue
        owner = None
        if active:
            owner = max(active.values(), key=lambda iv: (
                _PRIORITY[iv["bucket"]], iv["depth"], iv["t0"]))
        seg = {
            "t0": t, "t1": t2, "seconds": t2 - t,
            "stage": owner["stage"] if owner else None,
            "bucket": owner["bucket"] if owner else GAP,
            "node": owner["node"] if owner else None,
        }
        # merge with the previous segment when the owner is unchanged
        if segments and segments[-1]["stage"] == seg["stage"] \
                and segments[-1]["bucket"] == seg["bucket"] \
                and segments[-1]["node"] == seg["node"] \
                and abs(segments[-1]["t1"] - seg["t0"]) < 1e-9:
            segments[-1]["t1"] = seg["t1"]
            segments[-1]["seconds"] += seg["seconds"]
        else:
            segments.append(seg)
    return segments


def report(trace_id: str, spans: list[dict[str, Any]] | None = None,
           *, max_path: int = 64) -> dict[str, Any]:
    """The attribution report for one trace over the given spans
    (default: the local trace ring). Pure computation — remote
    assembly lives in :func:`assemble`."""
    if spans is None:
        spans = _trace.recent(trace_id)
    intervals = _span_intervals(spans)
    segments = _sweep(intervals)
    buckets = {b: 0.0 for b in BUCKETS}
    stages: dict[str, float] = {}
    for seg in segments:
        buckets[seg["bucket"]] += seg["seconds"]
        key = seg["stage"] or "(gap)"
        stages[key] = stages.get(key, 0.0) + seg["seconds"]
    wall = sum(buckets.values())
    nodes: dict[str, int] = {}
    for iv in intervals:
        nodes[iv["node"]] = nodes.get(iv["node"], 0) + 1
    origin = min((iv["t0"] for iv in intervals), default=0.0)
    path = [
        {
            "stage": seg["stage"], "bucket": seg["bucket"],
            "node": seg["node"],
            "offset_s": round(seg["t0"] - origin, 6),
            "seconds": round(seg["seconds"], 6),
        }
        for seg in sorted(segments, key=lambda s: s["seconds"],
                          reverse=True)[:max_path]
    ]
    doc = {
        "trace_id": trace_id,
        "spans": len(intervals),
        "nodes": nodes,
        "wall_seconds": round(wall, 6),
        "buckets": {b: round(v, 6) for b, v in buckets.items()},
        "bucket_fractions": {
            b: round(v / wall, 4) if wall > 0 else 0.0
            for b, v in buckets.items()
        },
        "top_segments": path,
        "top_stages": dict(sorted(
            ((k, round(v, 6)) for k, v in stages.items()),
            key=lambda kv: kv[1], reverse=True)[:16]),
    }
    # the host profiler (telemetry/sampler.py) names the code inside
    # the anonymous buckets: every timeline sample landing in a gap
    # (or host_cpu) critical-path segment votes for its frame group,
    # and the bucket's seconds split proportionally. The report keeps
    # the span-derived buckets authoritative — the decomposition only
    # explains them.
    from . import sampler as _sampler

    for bucket, key in ((GAP, "gap_decomposition"),
                        (HOST_CPU, "host_cpu_decomposition")):
        # LOCAL segments only: the timeline is this process's samples,
        # and voting them into a wall window owned by a REMOTE
        # executor's span would name local code for the peer's time
        # (gap segments have no owner and are always local wall)
        segs = [(s["t0"], s["t1"]) for s in segments
                if s["bucket"] == bucket
                and s["node"] in (None, "local")]
        local_seconds = sum(t1 - t0 for t0, t1 in segs)
        decomp = _sampler.decompose_segments(segs, local_seconds)
        if decomp is not None:
            doc[key] = decomp
    _tm.ATTRIB_REPORTS.inc()
    _tm.ATTRIB_BUCKET_SECONDS.set(buckets[DEVICE], bucket="device")
    _tm.ATTRIB_BUCKET_SECONDS.set(buckets[HOST_CPU], bucket="host_cpu")
    _tm.ATTRIB_BUCKET_SECONDS.set(buckets[LINK], bucket="link")
    _tm.ATTRIB_BUCKET_SECONDS.set(buckets[QUEUE_WAIT], bucket="queue_wait")
    _tm.ATTRIB_BUCKET_SECONDS.set(buckets[GAP], bucket="gap")
    return doc


# --- distributed assembly ------------------------------------------------

_report_cache: "collections.OrderedDict[str, dict[str, Any]]" = \
    collections.OrderedDict()
_cache_lock = threading.Lock()


def cached_report(trace_id: str) -> dict[str, Any] | None:
    with _cache_lock:
        return _report_cache.get(trace_id)


def _cache_store(trace_id: str, doc: dict[str, Any]) -> None:
    with _cache_lock:
        _report_cache[trace_id] = doc
        _report_cache.move_to_end(trace_id)
        while len(_report_cache) > _REPORT_CACHE_MAX:
            _report_cache.popitem(last=False)


async def assemble(node: Any, trace_id: str | None = None, *,
                   remote: bool = True,
                   refresh: bool = False) -> dict[str, Any]:
    """The full distributed report: local spans plus executor-side
    spans pulled from every reachable mesh peer for this trace. Pull
    failures degrade the report to ``partial`` (with per-peer errors)
    — they never block or raise. ``refresh`` bypasses the per-trace
    report cache (a settled pass's report is immutable in practice)."""
    if trace_id is None:
        trace_id = last_pass_trace()
    if trace_id is None:
        return {"error": "no completed pass found — pass a trace_id",
                "passes": recent_passes()[-8:]}
    if not refresh:
        got = cached_report(trace_id)
        if got is not None:
            return got
    spans = [dict(r, node="local") for r in _trace.recent(trace_id)]
    pull_failures: dict[str, str] = {}
    remote_n = 0
    manager = getattr(node, "p2p", None)
    if remote and manager is not None:
        remote_spans, pull_failures = await manager.pull_remote_spans(
            trace_id
        )
        remote_n = len(remote_spans)
        spans.extend(remote_spans)
    doc = report(trace_id, spans)
    doc["remote_spans"] = remote_n
    doc["partial"] = bool(pull_failures)
    if pull_failures:
        doc["pull_failures"] = pull_failures
    doc["passes"] = [
        p for p in recent_passes() if p["trace_id"] == trace_id
    ]
    # cache ONLY immutable answers: a settled pass's complete
    # assembly. A still-running pass (more spans coming) or a partial
    # pull (a peer may come back) must be recomputed on the next read
    if not pull_failures and _pass_settled(trace_id):
        _cache_store(trace_id, doc)
    return doc


def reset() -> None:
    """Test isolation (rides ``telemetry.reset()``): drop the report
    cache and the pass-boundary ring."""
    with _cache_lock:
        _report_cache.clear()
    with _passes_lock:
        _passes.clear()
