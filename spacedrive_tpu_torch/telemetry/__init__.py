"""Telemetry of the port: metrics registry, pipeline spans, trace
context, flight-recorder rings, the host sampling profiler, snapshot
and scrape APIs, the debug bundle.

Counterpart of `spacedrive_tpu/telemetry/__init__.py` (plane 6.2a:
owned copies of its trace, spans, events, sampler, peers, bundle,
snapshot and metrics modules; plane 6.2b: history, resources, slo,
attrib, tenants, health and the local half of federation). Surface:

- ``REGISTRY`` / ``counter`` / ``gauge`` / ``histogram`` — the
  process-wide metrics registry (Prometheus text via ``render()``);
- ``metrics`` — every predeclared family (the JAX package's catalog);
- ``span(stage, nbytes=0)`` — sync/async context manager recording
  per-stage wall time and bytes under a trace id;
- ``snapshot()`` — the JSON read path (rspc ``telemetry.snapshot``);
- ``trace`` / ``trace_export()`` — the span ring as Chrome-trace JSON,
  with the host sampler's capture windows on a ``host-profile`` lane;
- ``events`` — flight-recorder rings; ``debug_bundle()`` — the redacted
  support artifact; ``sampler`` — the continuous host profiler;
- ``history`` / ``resources`` — the node's persistent history writer and
  its resource sampler; ``slo`` / ``health`` / ``tenants`` — the
  verdicts over them; ``attrib`` — the critical-path attribution of a
  pass; ``federation`` — the node's compact self-snapshot;
- ``reset()`` — test isolation across metrics, spans, traces, rings,
  the sampler, attribution, SLO state, resources, tenants and the
  history tails.

This package imports no torch: process-pool workers import its metrics.
"""

from . import (
    attrib,
    events,
    federation,
    health,
    history,
    metrics,
    resources,
    sampler,
    slo,
    tenants,
    trace,
)
from .registry import (
    BYTE_BUCKETS,
    MAX_SERIES_PER_FAMILY,
    OVERFLOW_LABEL,
    RATIO_BUCKETS,
    REGISTRY,
    TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from .snapshot import counter_value, gauge_value, histogram_recent, snapshot
from .spans import Span, clear_recent, current_span, recent_spans, span


def render() -> str:
    return REGISTRY.render()


def reset() -> None:
    """Test/bench isolation: zero every metric series and clear the
    span ring, the trace ring, every flight-recorder ring, the
    attribution report cache and pass markers, SLO evaluation state,
    the host sampler's accumulators, timeline, capture ring and trigger
    state, the resource sampler's last-sample state and planted test
    leaks, the tenant plane's sketches, every history writer's
    in-memory tail (durable segments are data-dir state and survive)
    and the index journal's per-location runtime counters. Circuit
    breakers survive, as in the JAX package
    (``utils.resilience.reset_breakers`` drops them)."""
    REGISTRY.reset()
    clear_recent()
    trace.clear()
    events.clear_all()
    attrib.reset()
    slo.reset()
    sampler.reset()
    resources.reset()
    tenants.reset()
    history.reset_tails()
    # the journal's per-location counters live like registry series
    # (lazy import: the journal imports metrics)
    from ..location.indexer.journal import reset_runtime

    reset_runtime()


def trace_export(trace_id=None):
    """Chrome-trace-event JSON of the completed-span ring, with the
    host sampler's capture-window samples merged onto a dedicated
    ``host-profile`` lane (the ``telemetry.trace_export`` payload).
    With a ``trace_id`` filter, sampler events are clipped to the
    filtered spans' time range — captures from unrelated incidents
    must not stretch one trace's timeline into a sliver."""
    doc = trace.export(trace_id)
    profile_events = sampler.SAMPLER.chrome_events()
    if trace_id is not None and profile_events:
        spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        if not spans:
            return doc
        lo = min(e["ts"] for e in spans)
        hi = max(e["ts"] + e.get("dur", 0) for e in spans)
        profile_events = [
            e for e in profile_events
            if e.get("ph") == "M" or lo <= e.get("ts", 0) <= hi
        ]
        if all(e.get("ph") == "M" for e in profile_events):
            profile_events = []  # nothing landed in-window: no lane
    doc["traceEvents"].extend(profile_events)
    return doc


def debug_bundle(node=None, data_dir=None):
    """The redacted debug bundle dict (see telemetry.bundle)."""
    from .bundle import build_bundle

    return build_bundle(node, data_dir)


def counter(name: str, help: str = "", labels=()):
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels=()):
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels=(), buckets=TIME_BUCKETS):
    return REGISTRY.histogram(name, help, labels, buckets)


__all__ = [
    "REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "TIME_BUCKETS", "RATIO_BUCKETS", "BYTE_BUCKETS",
    "MAX_SERIES_PER_FAMILY", "OVERFLOW_LABEL",
    "metrics", "span", "Span", "current_span", "recent_spans",
    "clear_recent", "snapshot", "histogram_recent", "gauge_value",
    "counter_value", "render", "counter", "gauge", "histogram",
    "trace", "events", "reset", "trace_export", "debug_bundle",
    "health", "federation", "attrib", "history", "slo", "sampler",
    "resources", "tenants",
]
