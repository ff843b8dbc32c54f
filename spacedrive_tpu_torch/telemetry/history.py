"""Persistent telemetry history — sampled time-series that survive
restarts.

An owned copy of `spacedrive_tpu/telemetry/history.py`, segment format
and all: key order, float rounding and the time source are JAX's, so a
history directory written by either package reads in the other.

- a :class:`HistoryWriter` samples an **allowlist** of derived series
  (:func:`default_samplers`: sync lag, observed files/s, interactive
  p99, protected-shed counters, autotune knobs, the host profiler's
  group shares, resource and tenant series) every
  ``SD_HISTORY_INTERVAL_S`` seconds (default 10) into an append-only
  segment store under ``<data_dir>/telemetry_history/``;
- segments are JSON-lines files named by their first sample's epoch-ms
  (``seg-<epoch>.jsonl``), so a crash mid-write costs at most one
  truncated line (the reader skips it);
- **retention** deletes the oldest segments past a byte budget;
  **downsampling** compacts segments older than a horizon K:1 (mean
  over each K-record stripe, min/max preserved);
- the writer keeps a bounded **in-memory tail** of recent samples — the
  SLO evaluator's fast read path. ``telemetry.reset()`` clears tails
  without touching the durable segments.

:func:`read` merges segments in time order, so the CLI's ``slo`` reads
a node's history from outside the node process, and a node restarted
on the same data dir continues the same series. ``SD_HISTORY=0``
starts no sampling.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Iterable

DIR_NAME = "telemetry_history"

DEFAULT_INTERVAL_S = 10.0
SEGMENT_MAX_RECORDS = 512       # rotate after this many samples
RETENTION_BYTES = 4 << 20       # delete oldest segments past this
DOWNSAMPLE_AFTER_S = 24 * 3600.0  # compact segments older than this
DOWNSAMPLE_STRIDE = 8           # K:1 compaction
TAIL_SAMPLES = 720              # in-memory tail (~2 h at 10 s)

#: every live writer, so telemetry.reset() can clear in-memory tails
#: without the registry knowing about node lifecycles
_writers: "weakref.WeakSet[HistoryWriter]" = weakref.WeakSet()


def history_dir(data_dir: str | os.PathLike) -> str:
    return os.path.join(os.fspath(data_dir), DIR_NAME)


def enabled() -> bool:
    return os.environ.get("SD_HISTORY", "1") != "0"


def interval_s() -> float:
    try:
        return max(0.05, float(os.environ.get("SD_HISTORY_INTERVAL_S",
                                              str(DEFAULT_INTERVAL_S))))
    except ValueError:
        return DEFAULT_INTERVAL_S


# --- the default metric allowlist ---------------------------------------


def _p99(samples: list[float]) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, int(0.99 * len(s)))]


def default_samplers() -> dict[str, Callable[[], float]]:
    """The sampled allowlist. Counters are recorded CUMULATIVE (readers
    diff); gauges/derived rates are instantaneous. Every sampler is a
    cheap registry read — the writer must never become the load."""
    from ..parallel import autotune as _autotune
    from .registry import REGISTRY
    from .snapshot import counter_value, gauge_value, histogram_recent

    def sync_lag_max() -> float:
        fam = REGISTRY.get("sd_sync_lag_seconds")
        if fam is None:
            return 0.0
        with fam._lock:
            vals = [s.value for s in fam._series.values()]
        return max(vals, default=0.0)

    def protected_sheds() -> float:
        return (
            counter_value("sd_gate_requests_total",
                          klass="control", outcome="shed")
            + counter_value("sd_gate_requests_total",
                            klass="sync", outcome="shed")
        )

    from . import sampler as _sampler

    def profile_share(group: str) -> Callable[[], float]:
        def read() -> float:
            return _sampler.SAMPLER.group_shares().get(group, 0.0)

        return read

    samplers: dict[str, Callable[[], float]] = {
        # cumulative top-frame-group shares from the host profiler —
        # the continuous record bench_compare gates attribution drift
        # against (a pass whose sql share doubles week-over-week fails
        # even if no bench round ran in between)
        f"profile_share_{g}": profile_share(g)
        for g in _sampler.HISTORY_GROUPS
    }
    samplers.update({
        "files_per_s": lambda: _autotune.observed_files_per_s("identify")
        or 0.0,
        "sync_lag_max_s": sync_lag_max,
        "interactive_p99_ms": lambda: _p99(
            histogram_recent("sd_serve_request_seconds", klass="interactive")
        ) * 1e3,
        "goodput_admitted_total": lambda: sum(
            counter_value("sd_gate_requests_total", klass=k,
                          outcome="admitted")
            for k in ("interactive", "background")
        ),
        "protected_sheds_total": protected_sheds,
        "event_loop_lag_s": lambda: gauge_value("sd_event_loop_lag_seconds"),
        "breaker_open": lambda: gauge_value("sd_breaker_open"),
        "autotune_window_scale": lambda: gauge_value(
            "sd_autotune_window_scale", workload="identify"),
        "autotune_batch_rung": lambda: gauge_value(
            "sd_autotune_batch_rung", workload="identify"),
    })
    from . import resources as _resources

    if _resources.enabled():
        # growth surfaces for the trend SLO class — gated so
        # SD_RESOURCES=0 leaves the sampled allowlist (and every
        # history record) byte-identical to a pre-resources node
        samplers.update({
            "resource_rss_mb": lambda: gauge_value(
                "sd_resource_rss_bytes") / 1e6,
            "resource_fds": lambda: gauge_value("sd_resource_fds"),
            "resource_threads": lambda: gauge_value(
                "sd_resource_threads"),
            "resource_journal_rows": lambda: gauge_value(
                "sd_resource_inventory", kind="journal_rows"),
            "resource_oplog_rows": lambda: gauge_value(
                "sd_resource_inventory", kind="oplog_rows"),
            "resource_history_bytes": lambda: gauge_value(
                "sd_resource_inventory", kind="history_bytes"),
        })
    from . import tenants as _tenants

    if _tenants.enabled():
        # fairness surfaces for the tenant_fairness SLO — gated so
        # SD_TENANT_OBS=0 leaves the sampled allowlist (and every
        # history record) byte-identical to a pre-tenants node
        samplers.update({
            "tenant_fairness_index": _tenants.fairness_index,
            "tenant_dominant_share": _tenants.dominant_share,
        })
    return samplers


# --- the writer ----------------------------------------------------------


class HistoryWriter:
    """Owns one node's history directory: samples on a timer (started/
    stopped with the node), rotates/retains/downsamples segments, and
    keeps the in-memory tail the SLO evaluator reads."""

    def __init__(self, directory: str,
                 samplers: dict[str, Callable[[], float]] | None = None,
                 *,
                 segment_max_records: int = SEGMENT_MAX_RECORDS,
                 retention_bytes: int = RETENTION_BYTES,
                 downsample_after_s: float = DOWNSAMPLE_AFTER_S):
        self.dir = os.fspath(directory)
        self._samplers = samplers
        self.segment_max_records = segment_max_records
        self.retention_bytes = retention_bytes
        self.downsample_after_s = downsample_after_s
        self.tail: deque[dict[str, Any]] = deque(maxlen=TAIL_SAMPLES)
        # short-TTL memo for the disk fallback of recent(): until the
        # in-memory tail spans the asked window (cold start, right
        # after a restart) every /health hit would otherwise re-parse
        # the whole segment store
        self._disk_memo: tuple[float, float, list] | None = None
        self._lock = threading.Lock()
        # the tail is appended from the to_thread sampler and iterated
        # on the event loop (health/SLO reads) — deque iteration during
        # mutation raises, so every touch goes through this cheap lock
        # (separate from _lock, which is held across file writes)
        self._tail_lock = threading.Lock()
        self._seg_path: str | None = None
        self._seg_records = 0
        self._task: Any = None
        self._tasks: set = set()
        self._stopped = False
        _writers.add(self)

    def _sampler_map(self) -> dict[str, Callable[[], float]]:
        if self._samplers is None:
            self._samplers = default_samplers()
        return self._samplers

    # -- sampling ---------------------------------------------------------

    def sample(self, now: float | None = None) -> dict[str, Any]:
        """Take one sample: read every allowlisted series, append the
        record to the current segment, and push it onto the tail.
        Individual sampler failures degrade to absent keys — one broken
        series must not stop the history of the others."""
        rec: dict[str, Any] = {"ts": now if now is not None else time.time()}
        values: dict[str, float] = {}
        for name, fn in self._sampler_map().items():
            try:
                values[name] = round(float(fn()), 6)
            except Exception:  # noqa: BLE001 - samplers degrade, never fail
                continue
        rec["v"] = values
        self._append(rec)
        with self._tail_lock:
            self.tail.append(rec)
        _tm_samples_inc()
        return rec

    def _append(self, rec: dict[str, Any]) -> None:
        with self._lock:
            os.makedirs(self.dir, exist_ok=True)
            if (self._seg_path is None
                    or self._seg_records >= self.segment_max_records):
                self._rotate(rec["ts"])
            assert self._seg_path is not None
            with open(self._seg_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            self._seg_records += 1

    def _rotate(self, ts: float) -> None:
        """Open a fresh segment; then (best-effort) downsample old
        segments and enforce the retention budget. Caller holds the
        lock."""
        self._seg_path = os.path.join(
            self.dir, f"seg-{int(ts * 1000):015d}.jsonl"
        )
        self._seg_records = 0
        try:
            self._downsample()
            self._retain()
        except OSError:  # maintenance must never block sampling
            pass

    def _segments(self) -> list[str]:
        try:
            names = sorted(
                n for n in os.listdir(self.dir)
                if n.startswith("seg-") and n.endswith(".jsonl")
            )
        except OSError:
            return []
        return [os.path.join(self.dir, n) for n in names]

    def _downsample(self) -> None:
        horizon = time.time() - self.downsample_after_s
        for path in self._segments():
            if path == self._seg_path:
                continue
            recs = _read_segment(path)
            if not recs or recs[-1].get("ts", 0.0) > horizon:
                continue
            if all(r.get("ds") for r in recs):
                continue  # already compacted: rewriting it is pure I/O
            out = _downsample_records(recs, DOWNSAMPLE_STRIDE)
            ds_path = path[: -len(".jsonl")] + ".ds.jsonl"
            with open(ds_path, "w", encoding="utf-8") as f:
                for rec in out:
                    f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            os.replace(ds_path, path)

    def _retain(self) -> None:
        paths = self._segments()
        total = sum(os.path.getsize(p) for p in paths if os.path.exists(p))
        # oldest-first deletion, never the live segment
        for path in paths:
            if total <= self.retention_bytes:
                break
            if path == self._seg_path:
                continue
            try:
                size = os.path.getsize(path)
                os.remove(path)
            except OSError:
                continue  # size NOT deducted: the bytes are still there
            total -= size

    # -- read paths -------------------------------------------------------

    def recent(self, seconds: float, now: float | None = None) \
            -> list[dict[str, Any]]:
        """Samples within the window, tail-first (no disk I/O when the
        tail covers it — the per-/health SLO read path), falling back
        to the segment store for windows longer than the tail."""
        now = now if now is not None else time.time()
        since = now - seconds
        with self._tail_lock:
            tail_all = list(self.tail)
        tail = [r for r in tail_all if r.get("ts", 0.0) >= since]
        if tail_all and tail_all[0].get("ts", float("inf")) <= since:
            return tail
        memo = self._disk_memo
        if memo is not None and memo[0] <= since \
                and time.monotonic() - memo[1] < 5.0:
            disk = memo[2]
        else:
            disk = read(self.dir, since=since)
            self._disk_memo = (since, time.monotonic(), disk)
        # merge: disk records from BEFORE the tail's coverage (older
        # generations, pre-reset samples) + the always-fresh tail — a
        # memoized disk read can never hide the newest samples
        tail_start = tail_all[0].get("ts", 0.0) if tail_all \
            else float("inf")
        older = [
            r for r in disk
            if since <= r.get("ts", 0.0) <= now
            and r.get("ts", 0.0) < tail_start
        ]
        return older + tail

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        """Begin periodic sampling on the running loop (Node.start)."""
        import asyncio
        import logging

        from ..utils.tasks import supervise

        if not enabled():
            return
        if self._task is not None and not self._task.done():
            return
        self._stopped = False
        self._task = supervise(
            asyncio.get_running_loop().create_task(self._run()),
            self._tasks, logging.getLogger(__name__), "telemetry history",
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

        # prime the tail from the previous generation's segments (off
        # the loop): without this, every /health or federation read in
        # the first tail-window after a restart would fall back to a
        # synchronous full-store parse on the event loop
        await asyncio.to_thread(self._prime_tail)
        while not self._stopped:
            await asyncio.sleep(interval_s())
            if self._stopped:
                return
            # registry reads are lock-cheap; file append is small — but
            # keep the disk write off the loop anyway (a slow disk is
            # exactly the incident history must survive recording)
            await asyncio.to_thread(self.sample)

    def _prime_tail(self) -> None:
        with self._tail_lock:
            if self.tail:
                return
            recs = read(self.dir)
            for rec in recs[-(self.tail.maxlen or TAIL_SAMPLES):]:
                self.tail.append(rec)

    def reset_tail(self) -> None:
        with self._tail_lock:
            self.tail.clear()


def _tm_samples_inc() -> None:
    from . import metrics as _tm

    _tm.HISTORY_SAMPLES.inc()


# --- reading (process-independent) ---------------------------------------


def _read_segment(path: str) -> list[dict[str, Any]]:
    out: list[dict[str, Any]] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail line from a crash mid-append
                if isinstance(rec, dict) and "ts" in rec:
                    out.append(rec)
    except OSError:
        return []
    return out


def read(directory: str, *, since: float | None = None,
         until: float | None = None,
         names: Iterable[str] | None = None) -> list[dict[str, Any]]:
    """All samples in time order across every segment (restart
    boundaries included — that is the point). ``names`` filters the
    value dict of each record."""
    directory = os.fspath(directory)
    try:
        seg_names = sorted(
            n for n in os.listdir(directory)
            if n.startswith("seg-") and n.endswith(".jsonl")
        )
    except OSError:
        return []
    if since is not None and len(seg_names) > 1:
        # segment names encode their first sample's epoch-ms: a segment
        # whose SUCCESSOR starts before `since` cannot hold any record
        # in the window — skip parsing it (an SLO window read over a
        # mature store touches one or two segments, not all of them)
        def start_of(name: str) -> float:
            try:
                return int(name[len("seg-"):-len(".jsonl")]) / 1000.0
            except ValueError:
                return float("-inf")  # odd name: never pruned

        keep_from = 0
        for i in range(1, len(seg_names)):
            if start_of(seg_names[i]) <= since:
                keep_from = i
        seg_names = seg_names[keep_from:]
    out: list[dict[str, Any]] = []
    keep = set(names) if names is not None else None
    for name in seg_names:
        for rec in _read_segment(os.path.join(directory, name)):
            ts = rec.get("ts", 0.0)
            if since is not None and ts < since:
                continue
            if until is not None and ts > until:
                continue
            if keep is not None:
                rec = dict(rec, v={
                    k: v for k, v in (rec.get("v") or {}).items()
                    if k in keep
                })
            out.append(rec)
    out.sort(key=lambda r: r.get("ts", 0.0))
    return out


def series(directory: str, name: str, *, since: float | None = None,
           until: float | None = None) -> list[tuple[float, float]]:
    """One named series as (ts, value) pairs — the bench_compare read
    path."""
    out: list[tuple[float, float]] = []
    for rec in read(directory, since=since, until=until, names=(name,)):
        v = (rec.get("v") or {}).get(name)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out.append((rec["ts"], float(v)))
    return out


def _downsample_records(recs: list[dict[str, Any]],
                        stride: int) -> list[dict[str, Any]]:
    """K:1 mean compaction preserving per-stripe min/max (so an old
    spike survives downsampling as ``<name>__max``)."""
    out: list[dict[str, Any]] = []
    for i in range(0, len(recs), stride):
        stripe = recs[i:i + stride]
        if not stripe:
            continue
        if len(stripe) == 1 or stripe[0].get("ds"):
            out.extend(stripe)
            continue
        names: set[str] = set()
        for r in stripe:
            names |= set((r.get("v") or {}).keys())
        v: dict[str, float] = {}
        for n in names:
            vals = [
                r["v"][n] for r in stripe
                if isinstance((r.get("v") or {}).get(n), (int, float))
                and not isinstance(r["v"][n], bool)
            ]
            if not vals:
                continue
            v[n] = round(sum(vals) / len(vals), 6)
            v[n + "__min"] = round(min(vals), 6)
            v[n + "__max"] = round(max(vals), 6)
        out.append({
            "ts": stripe[0]["ts"],
            "ts_end": stripe[-1]["ts"],
            "n": len(stripe),
            "ds": True,
            "v": v,
        })
    return out


def reset_tails() -> None:
    """Clear every live writer's in-memory tail (telemetry.reset());
    durable segments are deliberately untouched — they are data-dir
    state, not process state."""
    for w in list(_writers):
        w.reset_tail()
