"""SLO registry + multi-window burn-rate evaluation over history.

An owned copy of `spacedrive_tpu/telemetry/slo.py`, objectives, knobs
and verdict rules unchanged. Each :class:`SLO` declares a good-sample
predicate over one history series (``telemetry/history.py``) and a
target good-fraction; the evaluator computes the multi-window **burn
rate** — the bad fraction over the error budget — over a fast and a
slow window:

- ``burn = bad_fraction / (1 - target)``; **breach** needs the fast AND
  slow windows past their thresholds (14.4 over 5 min, 6.0 over 1 h);
  **warn** is the fast window alone;
- ``zero_tolerance`` SLOs (protected sheds) breach on ANY increase of
  the cumulative counter inside the fast window;
- ``trend`` SLOs bound a least-squares growth slope per hour over a
  sliding window past a warmup prefix (the resource sampler's RSS and
  fd series), with a material ``min_delta``.

The registry is process-global (:data:`REGISTRY`, seeded with
:func:`default_slos`: ``SD_SLO_INTERACTIVE_P99_MS``,
``SD_SLO_FILES_PER_S``, ``SD_SLO_RSS_MB_PER_H``, ``SD_SLO_FD_PER_H``,
``SD_RESOURCE_TREND_WINDOW_S``, ``SD_RESOURCE_WARMUP_S``,
``SD_SLO_TENANT_FAIRNESS``); the last evaluation is cached and cleared
by ``telemetry.reset()``. Read paths: the ``slo`` health subsystem,
rspc ``telemetry.slo``, the CLI's ``slo``. A warn or breach opens one
host-profiler capture window.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

#: SRE-workbook-shaped defaults: (window_seconds, burn_threshold)
FAST_WINDOW_S = 300.0
SLOW_WINDOW_S = 3600.0
FAST_BURN = 14.4
SLOW_BURN = 6.0

#: trend-class defaults: slope judged over a sliding 30 min window,
#: first 2 min excluded as warmup, at least 8 post-warmup samples
TREND_WINDOW_S = 1800.0
TREND_WARMUP_S = 120.0
TREND_MIN_SAMPLES = 8

OK = "ok"
WARN = "warn"
BREACH = "breach"
NO_DATA = "no_data"

_RANK = {OK: 0, NO_DATA: 0, WARN: 1, BREACH: 2}


@dataclass(frozen=True)
class SLO:
    """One declarative objective over a history series.

    ``kind``:
    - ``upper``: a sample is good while ``value <= objective``;
    - ``lower``: good while ``value >= objective`` — with
      ``ignore_zero`` (pass throughput) samples at 0 are idle, not bad;
    - ``zero_tolerance``: the series is a cumulative counter; ANY
      increase inside the fast window breaches;
    - ``trend``: ``objective`` is the max allowed growth slope in
      series-units **per hour** over ``trend_window_s`` (samples inside
      the first ``warmup_s`` of the window are excluded); breach needs
      both the full-window and recent-half slopes over the objective
      AND a total accumulated delta ≥ ``min_delta``.
    """

    name: str
    series: str
    objective: float
    kind: str = "upper"  # upper | lower | zero_tolerance | trend
    target: float = 0.99
    description: str = ""
    ignore_zero: bool = False
    fast_window_s: float = FAST_WINDOW_S
    slow_window_s: float = SLOW_WINDOW_S
    fast_burn: float = FAST_BURN
    slow_burn: float = SLOW_BURN
    trend_window_s: float = TREND_WINDOW_S
    warmup_s: float = TREND_WARMUP_S
    min_samples: int = TREND_MIN_SAMPLES
    min_delta: float = 0.0

    def is_good(self, value: float) -> bool | None:
        """None = the sample doesn't count (idle)."""
        if self.ignore_zero and value == 0:
            return None
        if self.kind == "lower":
            return value >= self.objective
        return value <= self.objective


def default_slos() -> list[SLO]:
    from . import resources as _resources
    from . import tenants as _tenants

    objective = float(os.environ.get("SD_SLO_INTERACTIVE_P99_MS", "250"))
    throughput = float(os.environ.get("SD_SLO_FILES_PER_S", "50"))
    slos = [
        SLO("interactive_p99", series="interactive_p99_ms",
            objective=objective, kind="upper", target=0.99,
            description="serve-layer interactive request p99 under "
                        f"{objective:g} ms"),
        SLO("sync_lag", series="sync_lag_max_s", objective=600.0,
            kind="upper", target=0.99,
            description="worst per-peer replication lag under the sync "
                        "unhealthy bar (600 s)"),
        SLO("pass_throughput", series="files_per_s", objective=throughput,
            kind="lower", target=0.95, ignore_zero=True,
            description=f"observed identify throughput ≥ {throughput:g} "
                        "files/s while a pass is running (idle samples "
                        "don't count)"),
        SLO("protected_sheds", series="protected_sheds_total",
            objective=0.0, kind="zero_tolerance", target=1.0,
            description="control/sync-class sheds are contractually zero "
                        "— any increase is an immediate breach"),
    ]
    if _resources.enabled():
        # gated on the sampler knob so SD_RESOURCES=0 stays a true
        # no-op: no resource_* series, no trend SLOs over them, no new
        # sd_slo_status labels — the pass output is golden-identical
        rss_mb_h = float(os.environ.get("SD_SLO_RSS_MB_PER_H", "64"))
        fd_h = float(os.environ.get("SD_SLO_FD_PER_H", "50"))
        window = float(os.environ.get("SD_RESOURCE_TREND_WINDOW_S",
                                      str(TREND_WINDOW_S)))
        warmup = float(os.environ.get("SD_RESOURCE_WARMUP_S",
                                      str(TREND_WARMUP_S)))
        slos += [
            SLO("rss_growth", series="resource_rss_mb",
                objective=rss_mb_h, kind="trend",
                trend_window_s=window, warmup_s=warmup,
                min_delta=rss_mb_h / 4.0,
                description="process RSS growth slope bounded to "
                            f"{rss_mb_h:g} MB/h after warmup — a "
                            "steeper sustained slope is a leak, not "
                            "load"),
            SLO("fd_growth", series="resource_fds",
                objective=fd_h, kind="trend",
                trend_window_s=window, warmup_s=warmup,
                min_delta=max(8.0, fd_h / 4.0),
                description="open-fd count flat at steady state "
                            f"(slope ≤ {fd_h:g} fds/h) — growth means "
                            "descriptors are being stranded"),
        ]
    if _tenants.enabled():
        # gated on SD_TENANT_OBS so =0 stays a true no-op: no
        # tenant_fairness_index series, no SLO over it, no new
        # sd_slo_status labels — serve output golden-identical
        fairness_floor = float(
            os.environ.get("SD_SLO_TENANT_FAIRNESS", "0.5"))
        slos += [
            SLO("tenant_fairness", series="tenant_fairness_index",
                objective=fairness_floor, kind="lower", target=0.95,
                description="Jain's fairness index over resident "
                            "serve-surface tenants stays ≥ "
                            f"{fairness_floor:g} — sustained burn "
                            "means one library is starving the rest "
                            "(ROADMAP item 4's enforcement signal)"),
        ]
    return slos


class SloRegistry:
    """Named SLOs + the last evaluation (process-global)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._slos: dict[str, SLO] = {}
        self.last_evaluation: dict[str, Any] | None = None
        for s in default_slos():
            self._slos[s.name] = s

    def register(self, slo: SLO) -> None:
        with self._lock:
            self._slos[slo.name] = slo

    def get(self, name: str) -> SLO | None:
        with self._lock:
            return self._slos.get(name)

    def all(self) -> list[SLO]:
        with self._lock:
            return list(self._slos.values())

    def reset(self) -> None:
        """telemetry.reset(): restore defaults, drop evaluation state."""
        with self._lock:
            self._slos = {s.name: s for s in default_slos()}
            self.last_evaluation = None


REGISTRY = SloRegistry()


# --- evaluation ----------------------------------------------------------


def _window_stats(slo: SLO, samples: list[tuple[float, float]]) \
        -> dict[str, Any]:
    good = bad = 0
    for _, v in samples:
        verdict = slo.is_good(v)
        if verdict is None:
            continue
        if verdict:
            good += 1
        else:
            bad += 1
    counted = good + bad
    bad_fraction = (bad / counted) if counted else 0.0
    budget = max(1e-9, 1.0 - slo.target)
    return {
        "samples": counted,
        "bad": bad,
        "bad_fraction": round(bad_fraction, 4),
        "burn": round(bad_fraction / budget, 2),
    }


def _counter_increase(samples: list[tuple[float, float]]) -> float:
    vals = [v for _, v in samples]
    if len(vals) < 2:
        return 0.0
    # cumulative counter: restart resets read as no increase (monotonic
    # re-baselining), increases sum across the window
    inc = 0.0
    prev = vals[0]
    for v in vals[1:]:
        if v > prev:
            inc += v - prev
        prev = v
    return inc


def _slope_per_h(samples: list[tuple[float, float]]) -> float:
    """Least-squares slope of (ts, value) in units per hour."""
    n = len(samples)
    if n < 2:
        return 0.0
    t0 = samples[0][0]
    xs = [t - t0 for t, _ in samples]
    ys = [v for _, v in samples]
    mean_x = sum(xs) / n
    mean_y = sum(ys) / n
    denom = sum((x - mean_x) ** 2 for x in xs)
    if denom <= 0:
        return 0.0
    slope = sum((x - mean_x) * (y - mean_y)
                for x, y in zip(xs, ys)) / denom
    return slope * 3600.0


def _evaluate_trend(slo: SLO,
                    samples: list[tuple[float, float]]) -> dict[str, Any]:
    """Trend verdict over one window of post-warmup samples."""
    kept = samples
    if samples:
        cutoff = samples[0][0] + slo.warmup_s
        kept = [(t, v) for t, v in samples if t >= cutoff]
    doc: dict[str, Any] = {
        "seconds": slo.trend_window_s,
        "samples": len(kept),
        "warmup_excluded": len(samples) - len(kept),
        "min_delta": slo.min_delta,
    }
    if len(kept) < max(2, slo.min_samples):
        doc.update(slope_per_h=0.0, recent_slope_per_h=0.0, delta=0.0,
                   status=NO_DATA)
        return doc
    slope = _slope_per_h(kept)
    recent = _slope_per_h(kept[len(kept) // 2:])
    delta = kept[-1][1] - kept[0][1]
    doc.update(slope_per_h=round(slope, 3),
               recent_slope_per_h=round(recent, 3),
               delta=round(delta, 3))
    material = delta >= slo.min_delta
    if slope > slo.objective and recent > slo.objective and material:
        doc["status"] = BREACH
    elif slope > slo.objective and material:
        # the full window regressed but the recent half flattened —
        # the growth stopped (a filled cache, a completed pass), so
        # surface it without flipping health
        doc["status"] = WARN
    else:
        doc["status"] = OK
    return doc


def evaluate_slo(slo: SLO, samples_for: Callable[[float],
                                                 list[tuple[float, float]]],
                 now: float | None = None) -> dict[str, Any]:
    """One SLO against a window-reader ``samples_for(seconds) ->
    [(ts, value)]``."""
    if slo.kind == "trend":
        window = samples_for(slo.trend_window_s)
        trend = _evaluate_trend(slo, window)
        return {
            "name": slo.name,
            "series": slo.series,
            "kind": slo.kind,
            "objective": slo.objective,
            "target": slo.target,
            "description": slo.description,
            "current": window[-1][1] if window else None,
            "windows": {"trend": {k: v for k, v in trend.items()
                                  if k != "status"}},
            "status": trend["status"],
        }
    fast = samples_for(slo.fast_window_s)
    slow = samples_for(slo.slow_window_s)
    current = fast[-1][1] if fast else (slow[-1][1] if slow else None)
    doc: dict[str, Any] = {
        "name": slo.name,
        "series": slo.series,
        "kind": slo.kind,
        "objective": slo.objective,
        "target": slo.target,
        "description": slo.description,
        "current": current,
    }
    if slo.kind == "zero_tolerance":
        inc = _counter_increase(fast)
        doc["windows"] = {
            "fast": {"seconds": slo.fast_window_s, "samples": len(fast),
                     "increase": inc},
        }
        if not fast:
            doc["status"] = NO_DATA
        else:
            doc["status"] = BREACH if inc > 0 else OK
        return doc
    f, s = _window_stats(slo, fast), _window_stats(slo, slow)
    doc["windows"] = {
        "fast": {"seconds": slo.fast_window_s, **f,
                 "burn_threshold": slo.fast_burn},
        "slow": {"seconds": slo.slow_window_s, **s,
                 "burn_threshold": slo.slow_burn},
    }
    if f["samples"] == 0 and s["samples"] == 0:
        doc["status"] = NO_DATA
    elif f["burn"] >= slo.fast_burn and s["burn"] >= slo.slow_burn:
        doc["status"] = BREACH
    elif f["burn"] >= slo.fast_burn:
        doc["status"] = WARN
    else:
        doc["status"] = OK
    return doc


def evaluate(history: Any = None, *, directory: str | None = None,
             now: float | None = None) -> dict[str, Any]:
    """Every registered SLO against a history source: a live
    :class:`~.history.HistoryWriter` (tail-backed
    fast path — the /health + federation read), or a bare history
    ``directory`` (the CLI's ``slo`` offline / post-restart)."""
    from . import metrics as _tm

    now = now if now is not None else time.time()
    results: list[dict[str, Any]] = []
    worst = NO_DATA
    for slo in REGISTRY.all():
        if history is not None:
            def samples_for(seconds: float, _s=slo) \
                    -> list[tuple[float, float]]:
                recs = history.recent(seconds, now=now)
                return [
                    (r["ts"], float(r["v"][_s.series]))
                    for r in recs
                    if isinstance((r.get("v") or {}).get(_s.series),
                                  (int, float))
                    and not isinstance(r["v"][_s.series], bool)
                ]
        elif directory is not None:
            from .history import series as _series

            def samples_for(seconds: float, _s=slo) \
                    -> list[tuple[float, float]]:
                return _series(directory, _s.series, since=now - seconds,
                               until=now)
        else:
            def samples_for(seconds: float) -> list[tuple[float, float]]:
                return []
        doc = evaluate_slo(slo, samples_for, now=now)
        results.append(doc)
        if _RANK[doc["status"]] > _RANK[worst] or (
            worst == NO_DATA and doc["status"] == OK
        ):
            # rank-0 tie: an evaluated-and-met objective upgrades the
            # rollup from "no data" to "ok"
            worst = doc["status"]
        _tm.SLO_STATUS.set(_RANK[doc["status"]], slo=slo.name)
    evaluation = {"ts": now, "status": worst, "slos": results}
    _tm.SLO_EVALUATIONS.inc()
    REGISTRY.last_evaluation = evaluation
    # a warn/breach opens a host-profiler deep-capture window: the
    # flight recorder gains "what was Python doing when the budget
    # started burning". The sampler's own hysteresis absorbs repeats —
    # health polls re-evaluating a burning SLO open ONE window per
    # cooldown, never a storm.
    from . import sampler as _sampler

    if worst == BREACH:
        _sampler.trigger("slo_breach")
    elif worst == WARN:
        _sampler.trigger("slo_warn")
    return evaluation


def reset() -> None:
    REGISTRY.reset()
