"""In-process metrics registry — counters, gauges, fixed-bucket histograms.

An owned copy of `spacedrive_tpu/telemetry/registry.py`, whole: the
same families render the same Prometheus text in both packages.

The observability spine for the dispatch path (ROADMAP: explain the
bottleneck from inside the system). Prometheus-style semantics without
the client library: every metric is a *family* (name + help + label
names) holding one series per label-value tuple, guarded by one
registry-wide lock so hot-path updates from worker threads (the window
pipeline producer, to_thread hashers) and the event loop never race.

Deliberate deviations from a full Prometheus client, sized for this
process:

- label cardinality is capped per family (``MAX_SERIES_PER_FAMILY``);
  past the cap new label sets fold into a reserved ``__overflow__``
  series instead of growing memory without bound — a hot path must
  never be able to DoS its own telemetry;
- histograms keep a small ring of raw observations (``recent()``) so
  in-process consumers (bench.py, telemetry.snapshot) can compute
  medians/spreads from the same source the /metrics endpoint scrapes —
  one set of numbers, two read paths;
- unlabeled counters/gauges materialize their default series at
  registration, so a metric that has not fired yet still renders as an
  explicit zero (absence means "not wired", zero means "wired, idle").
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Iterable, Sequence

MAX_SERIES_PER_FAMILY = 64
OVERFLOW_LABEL = "__overflow__"
RECENT_SAMPLES = 128

# latency buckets: 1 ms .. 30 s covers queue waits through job phases
TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
# occupancy / fill-ratio buckets: [0, 1] with emphasis near full
RATIO_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0)
# byte-size buckets: 4 KiB .. 1 GiB in powers of ~8
BYTE_BUCKETS = (
    4096.0, 32768.0, 262144.0, 2097152.0, 16777216.0,
    134217728.0, 1073741824.0,
)


class _Series:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0


class _HistogramSeries:
    __slots__ = ("bucket_counts", "sum", "count", "recent")

    def __init__(self, n_buckets: int,
                 recent_samples: int = RECENT_SAMPLES) -> None:
        self.bucket_counts = [0] * (n_buckets + 1)  # +1 = +Inf
        self.sum = 0.0
        self.count = 0
        self.recent: deque[float] = deque(maxlen=recent_samples)


class _Family:
    """Shared family plumbing: label resolution + cardinality cap."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 label_names: Sequence[str]):
        self._registry = registry
        self._lock = registry._lock
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._series: dict[tuple[str, ...], Any] = {}
        if not self.label_names:
            self._series[()] = self._new_series()

    def _new_series(self) -> Any:
        raise NotImplementedError

    def _resolve(self, labels: dict[str, Any]) -> Any:
        """Series for a label set; caller holds the lock. Unknown label
        names are a programming error; cardinality overflow is not —
        it folds into the __overflow__ series."""
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        key = tuple(str(labels[n]) for n in self.label_names)
        series = self._series.get(key)
        if series is None:
            if len(self._series) >= MAX_SERIES_PER_FAMILY:
                key = tuple(OVERFLOW_LABEL for _ in self.label_names)
                series = self._series.get(key)
                if series is None:
                    series = self._new_series()
                    self._series[key] = series
                return series
            series = self._new_series()
            self._series[key] = series
        return series

    def _peek(self, labels: dict[str, Any]) -> Any:
        """Series for a label set WITHOUT creating it; caller holds the
        lock. Read paths must use this: a probing read (dashboard,
        snapshot helper, typo'd label) must not mint a permanent series
        or eat into the family's cardinality cap."""
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        key = tuple(str(labels[n]) for n in self.label_names)
        return self._series.get(key)

    def _reset(self) -> None:
        keep = self._series.keys() if not self.label_names else ()
        fresh = {k: self._new_series() for k in keep}
        self._series = fresh


class Counter(_Family):
    kind = "counter"

    def _new_series(self) -> _Series:
        return _Series()

    def inc(self, n: float = 1.0, **labels: Any) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters are monotonic (inc {n})")
        with self._lock:
            self._resolve(labels).value += n

    def value(self, **labels: Any) -> float:
        with self._lock:
            s = self._peek(labels)
            return s.value if s is not None else 0.0


class Gauge(_Family):
    kind = "gauge"

    def _new_series(self) -> _Series:
        return _Series()

    def set(self, v: float, **labels: Any) -> None:
        with self._lock:
            self._resolve(labels).value = float(v)

    def inc(self, n: float = 1.0, **labels: Any) -> None:
        with self._lock:
            self._resolve(labels).value += n

    def dec(self, n: float = 1.0, **labels: Any) -> None:
        self.inc(-n, **labels)

    def value(self, **labels: Any) -> float:
        with self._lock:
            s = self._peek(labels)
            return s.value if s is not None else 0.0


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 label_names: Sequence[str],
                 buckets: Sequence[float] = TIME_BUCKETS,
                 recent_samples: int = RECENT_SAMPLES):
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or any(not math.isfinite(b) for b in bs):
            raise ValueError(f"{name}: buckets must be finite and non-empty")
        self.buckets = bs
        self.recent_samples = recent_samples
        super().__init__(registry, name, help, label_names)

    def _new_series(self) -> _HistogramSeries:
        return _HistogramSeries(len(self.buckets), self.recent_samples)

    def observe(self, v: float, **labels: Any) -> None:
        v = float(v)
        with self._lock:
            s = self._resolve(labels)
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            s.bucket_counts[i] += 1
            s.sum += v
            s.count += 1
            s.recent.append(v)

    def recent(self, **labels: Any) -> list[float]:
        """Raw recent observations — the in-process read path bench.py
        and telemetry.snapshot share with the scrape endpoint."""
        with self._lock:
            s = self._peek(labels)
            return list(s.recent) if s is not None else []

    def stats(self, **labels: Any) -> dict[str, float]:
        with self._lock:
            s = self._peek(labels)
            if s is None:
                return {"sum": 0.0, "count": 0}
            return {"sum": s.sum, "count": s.count}


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class MetricsRegistry:
    """Create-or-get metric families; render Prometheus text."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}

    def _register(self, cls, name: str, help: str,
                  labels: Sequence[str], **kw) -> Any:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise ValueError(
                        f"{name} already registered as {fam.kind}")
                return fam
            fam = cls(self, name, help, labels, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = TIME_BUCKETS,
                  recent_samples: int = RECENT_SAMPLES) -> Histogram:
        return self._register(Histogram, name, help, labels,
                              buckets=buckets,
                              recent_samples=recent_samples)

    def get(self, name: str) -> _Family | None:
        with self._lock:
            return self._families.get(name)

    def reset(self) -> None:
        """Zero every series (tests / bench isolation). Families and
        their pre-registered default series survive."""
        with self._lock:
            for fam in self._families.values():
                fam._reset()

    # --- render ---------------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: list[str] = []
        with self._lock:
            for name, fam in sorted(self._families.items()):
                if fam.help:
                    out.append(f"# HELP {name} {fam.help}")
                out.append(f"# TYPE {name} {fam.kind}")
                for key, s in fam._series.items():
                    base = _labelstr(fam.label_names, key)
                    if isinstance(fam, Histogram):
                        cum = 0
                        for b, c in zip(fam.buckets, s.bucket_counts):
                            cum += c
                            le = _labelstr(
                                fam.label_names + ("le",),
                                key + (_fmt(b),))
                            out.append(f"{name}_bucket{le} {cum}")
                        cum += s.bucket_counts[-1]
                        le = _labelstr(fam.label_names + ("le",),
                                       key + ("+Inf",))
                        out.append(f"{name}_bucket{le} {cum}")
                        out.append(f"{name}_sum{base} {_fmt(s.sum)}")
                        out.append(f"{name}_count{base} {s.count}")
                    else:
                        out.append(f"{name}{base} {_fmt(s.value)}")
        return "\n".join(out) + "\n"

    # --- cross-process deltas (parallel/procpool.py) --------------------
    #
    # The multi-process execution plane keeps this registry single-
    # writer per process: pool workers accumulate into their OWN
    # registry (same families — both sides import telemetry.metrics)
    # and ship a msgpack-plain delta blob back with each batch result;
    # the owner merges it here. Counters and histograms merge by
    # addition (monotonic / mergeable by construction); gauges are
    # deliberately excluded — they are point-in-time statements only
    # the owning process may make.

    def delta_capture(self) -> dict[str, Any]:
        """Compact additive state: {family: {label-key-tuple-as-list:
        …}} rendered as parallel lists so the blob stays msgpack-plain."""
        with self._lock:
            counters: dict[str, list] = {}
            hists: dict[str, list] = {}
            for name, fam in self._families.items():
                if isinstance(fam, Counter):
                    rows = [
                        [list(key), s.value]
                        for key, s in fam._series.items() if s.value
                    ]
                    if rows:
                        counters[name] = rows
                elif isinstance(fam, Histogram):
                    rows = [
                        [list(key), s.sum, s.count,
                         list(s.bucket_counts), list(s.recent)]
                        for key, s in fam._series.items() if s.count
                    ]
                    if rows:
                        hists[name] = rows
            return {"c": counters, "h": hists}

    @staticmethod
    def delta_diff(before: dict[str, Any],
                   after: dict[str, Any]) -> dict[str, Any]:
        """after − before, per series. New observations in a histogram
        ring are its trailing ``count_after − count_before`` samples
        (the ring may have dropped older ones — then the whole ring is
        the best available tail)."""
        out: dict[str, Any] = {"c": {}, "h": {}}
        prev_c = {
            (name, tuple(key)): value
            for name, rows in before.get("c", {}).items()
            for key, value in rows
        }
        for name, rows in after.get("c", {}).items():
            kept = []
            for key, value in rows:
                d = value - prev_c.get((name, tuple(key)), 0.0)
                if d > 0:
                    kept.append([key, d])
            if kept:
                out["c"][name] = kept
        prev_h = {
            (name, tuple(key)): (s, n, bc)
            for name, rows in before.get("h", {}).items()
            for key, s, n, bc, _recent in rows
        }
        for name, rows in after.get("h", {}).items():
            kept = []
            for key, s, n, bc, recent in rows:
                ps, pn, pbc = prev_h.get((name, tuple(key)), (0.0, 0, None))
                dn = n - pn
                if dn <= 0:
                    continue
                dbc = (
                    [b - p for b, p in zip(bc, pbc)] if pbc is not None
                    else list(bc)
                )
                kept.append([key, s - ps, dn, dbc, recent[-dn:]])
            if kept:
                out["h"][name] = kept
        return out

    def merge_delta(self, delta: dict[str, Any]) -> None:
        """Fold a worker-shipped delta into this registry. Unknown
        families/label shapes are skipped (version drift between owner
        and worker must never corrupt owner series)."""
        with self._lock:
            for name, rows in (delta.get("c") or {}).items():
                fam = self._families.get(name)
                if not isinstance(fam, Counter):
                    continue
                for key, value in rows:
                    if len(key) != len(fam.label_names) or value <= 0:
                        continue
                    fam._resolve(dict(zip(fam.label_names, key))).value += value
            for name, rows in (delta.get("h") or {}).items():
                fam = self._families.get(name)
                if not isinstance(fam, Histogram):
                    continue
                for key, s, n, bc, recent in rows:
                    if len(key) != len(fam.label_names) or n <= 0 \
                            or len(bc) != len(fam.buckets) + 1:
                        continue
                    series = fam._resolve(dict(zip(fam.label_names, key)))
                    series.sum += s
                    series.count += n
                    for i, b in enumerate(bc):
                        series.bucket_counts[i] += b
                    series.recent.extend(recent)

    # --- snapshot (rspc + bench read path) ------------------------------

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            out: dict[str, Any] = {}
            for name, fam in self._families.items():
                series = []
                for key, s in fam._series.items():
                    labels = dict(zip(fam.label_names, key))
                    if isinstance(fam, Histogram):
                        series.append({
                            "labels": labels,
                            "sum": s.sum,
                            "count": s.count,
                            "buckets": {
                                _fmt(b): c for b, c in
                                zip(fam.buckets, s.bucket_counts)
                            },
                            "recent": list(s.recent),
                        })
                    else:
                        series.append({"labels": labels, "value": s.value})
                out[name] = {"type": fam.kind, "help": fam.help,
                             "series": series}
            return out


def _labelstr(names: Iterable[str], values: Iterable[str]) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    return "{" + ",".join(pairs) + "}" if pairs else ""


# The process-wide default registry: hot paths import their metric
# handles from telemetry.metrics, which registers on this instance.
REGISTRY = MetricsRegistry()
