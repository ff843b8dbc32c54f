"""Health model — rolls raw telemetry signals into verdicts.

An owned copy of `spacedrive_tpu/telemetry/health.py`, subsystems and
thresholds unchanged. Metrics answer "how much", the health model
answers the on-call question: *is this node OK, and if not, which
subsystem?* Each verdict derives from signals the registry, the flight
recorder, the samplers and the history already collect — a pure read,
cheap enough for every ``telemetry.health`` call and every federation
snapshot.

Verdict vocabulary (ordered): ``healthy`` < ``degraded`` <
``unhealthy``; ``unknown`` means "no signal yet" and never worsens the
rollup (a node that has not dispatched a batch is idle, not sick).

Subsystems: ``event_loop`` (the loop-lag gauge), ``feeder`` (recent
consumer waits), ``device`` (the degradation ladder, then the occupancy
of sharded dispatches: one card dispatches no sharded part, so it reads
``unknown``), ``p2p`` (failure episodes on the p2p ring), ``sync``
(corroborated replication head gaps and delta-guard trips), ``resilience``
(open circuit breakers), ``serve`` (``unknown`` until the serve plane:
a JAX node without a serve runtime answers the same), ``slo`` (burn
rates over the node's history), ``resources`` (trend SLOs over RSS and
fd slopes) and ``tenants`` (the fairness SLO and dominant share). The
autotune controller's knob state rides the rollup. Thresholds are
module constants, deliberately lenient: a verdict that cries wolf gets
ignored.
"""

from __future__ import annotations

import time
from typing import Any

from .registry import REGISTRY
from .snapshot import counter_value, gauge_value, histogram_recent

HEALTHY = "healthy"
DEGRADED = "degraded"
UNHEALTHY = "unhealthy"
UNKNOWN = "unknown"

_RANK = {HEALTHY: 0, UNKNOWN: 0, DEGRADED: 1, UNHEALTHY: 2}

# event-loop scheduling lag (seconds)
LOOP_LAG_DEGRADED = 0.2
LOOP_LAG_UNHEALTHY = 1.0
# feeder consumer wait (seconds, worst recent sample)
FEEDER_WAIT_DEGRADED = 1.0
FEEDER_WAIT_UNHEALTHY = 5.0
# device dispatch occupancy (mean of recent observations)
OCCUPANCY_DEGRADED = 0.25
# p2p failure episodes per minute over the ring window
P2P_EPISODES_DEGRADED = 30.0
P2P_EPISODES_UNHEALTHY = 120.0
P2P_EPISODE_TYPES = ("rto_timeout", "rwnd_stall", "bad_ack", "stream_failed")
P2P_WINDOW_SECONDS = 60.0
# replication head gap (seconds a peer's library head is ahead of ours,
# corroborated by a FRESH federation snapshot — see _sync below)
SYNC_GAP_DEGRADED = 60.0
SYNC_GAP_UNHEALTHY = 600.0
# a resident tenant holding this share of the serve surface (with at
# least one other tenant present) degrades the tenants subsystem even
# before the fairness SLO burns
DOMINANT_DEGRADED = 0.95


def _verdict(status: str, reason: str | None = None,
             **signals: Any) -> dict[str, Any]:
    out: dict[str, Any] = {"status": status}
    if reason:
        out["reason"] = reason
    if signals:
        out["signals"] = signals
    return out


def _event_loop() -> dict[str, Any]:
    lag = gauge_value("sd_event_loop_lag_seconds")
    if lag >= LOOP_LAG_UNHEALTHY:
        return _verdict(UNHEALTHY, f"event-loop lag {lag:.2f}s", lag_seconds=lag)
    if lag >= LOOP_LAG_DEGRADED:
        return _verdict(DEGRADED, f"event-loop lag {lag:.2f}s", lag_seconds=lag)
    return _verdict(HEALTHY, lag_seconds=lag)


def _feeder() -> dict[str, Any]:
    waits = histogram_recent("sd_feeder_wait_seconds")
    if not waits:
        return _verdict(UNKNOWN, "no feeder activity")
    worst = max(waits)
    if worst >= FEEDER_WAIT_UNHEALTHY:
        return _verdict(UNHEALTHY, f"feeder stall {worst:.2f}s",
                        worst_wait_seconds=worst)
    if worst >= FEEDER_WAIT_DEGRADED:
        return _verdict(DEGRADED, f"feeder wait {worst:.2f}s",
                        worst_wait_seconds=worst)
    return _verdict(HEALTHY, worst_wait_seconds=worst)


def _device() -> dict[str, Any]:
    # the degradation ladder outranks occupancy: a node that demoted to
    # a chip subset (or all the way to the host reference path) is still
    # CORRECT, but an operator must see it — it is running at a fraction
    # of its provisioned throughput until the re-arm probe succeeds
    demotion = gauge_value("sd_device_demotion_level")
    if demotion >= 2:
        return _verdict(
            DEGRADED,
            "device dispatch demoted to the host reference path",
            demotion_level=demotion,
        )
    if demotion >= 1:
        return _verdict(
            DEGRADED,
            "device dispatch demoted to a surviving chip subset",
            demotion_level=demotion,
        )
    samples: list[float] = []
    for op in ("blake3", "thumbnail"):
        samples.extend(histogram_recent("sd_device_dispatch_occupancy", op=op))
    if not samples:
        return _verdict(UNKNOWN, "no sharded dispatches")
    mean = sum(samples) / len(samples)
    if mean < OCCUPANCY_DEGRADED:
        return _verdict(
            DEGRADED,
            f"mean dispatch occupancy {mean:.2f} — chips mostly hauling pad rows",
            mean_occupancy=mean,
        )
    return _verdict(HEALTHY, mean_occupancy=mean, demotion_level=demotion)


def _resilience() -> dict[str, Any]:
    """Breaker plane: open circuits mean some target (relay, peer) is
    being fast-failed right now. Degraded — the node itself still
    works, but a dependency is being routed around."""
    from ..utils.resilience import breaker_snapshot

    open_n = gauge_value("sd_breaker_open")
    retries = counter_value("sd_resilience_retries_total")
    signals = {"open_breakers": open_n, "retries_total": retries,
               "breakers": breaker_snapshot()}
    if open_n > 0:
        return _verdict(
            DEGRADED, f"{int(open_n)} circuit breaker(s) open", **signals
        )
    return _verdict(HEALTHY, **signals)


def _p2p() -> dict[str, Any]:
    from .events import P2P_EVENTS

    now = time.time()
    episodes = [
        e for e in P2P_EVENTS.snapshot()
        if e.get("type") in P2P_EPISODE_TYPES
        and now - e.get("ts", 0.0) <= P2P_WINDOW_SECONDS
    ]
    rate = len(episodes) * 60.0 / P2P_WINDOW_SECONDS
    if rate >= P2P_EPISODES_UNHEALTHY:
        return _verdict(UNHEALTHY, f"{rate:.0f} failure episodes/min",
                        episodes_per_min=rate)
    if rate >= P2P_EPISODES_DEGRADED:
        return _verdict(DEGRADED, f"{rate:.0f} failure episodes/min",
                        episodes_per_min=rate)
    return _verdict(HEALTHY, episodes_per_min=rate)


def _replication_gaps(node: Any) -> dict[str, float]:
    """Per-peer head gap, CORROBORATED: how far each fresh federation
    snapshot's library head (latest HLC that peer has seen) is ahead of
    ours. ~0 on a converged mesh — idle or busy — and positive only
    when a peer demonstrably holds ops we have not applied. This is the
    signal verdicts act on; raw wall-clock lag cannot distinguish
    'replica behind' from 'nothing to replicate'."""
    cache = getattr(getattr(node, "p2p", None), "federation", None)
    if cache is None:
        return {}
    our_heads: dict[str, float] = {}
    for lib in getattr(getattr(node, "libraries", None), "libraries",
                       {}).values():
        try:
            our_heads[str(lib.id)] = lib.sync.clock.peek_last().as_unix()
        except Exception:  # noqa: BLE001 - health reads never fail
            continue
    gaps: dict[str, float] = {}
    for pid, snap in cache.fresh_snapshots().items():
        libs = (snap.get("node") or {}).get("libraries") or {}
        worst = 0.0
        seen = False
        for lib_id, entry in libs.items():
            head = entry.get("head_seconds") if isinstance(entry, dict) else None
            ours = our_heads.get(str(lib_id))
            if head is None or ours is None:
                continue
            seen = True
            worst = max(worst, float(head) - ours)
        if seen:
            from .peers import peer_label

            gaps[peer_label(pid)] = worst
    return gaps


def _sync(node: Any = None) -> dict[str, Any]:
    lags: dict[str, float] = {}
    if node is not None:
        # refresh the gauges from live watermarks so dashboards see
        # honest time-since-last-applied-op even while idle (the gauge
        # would otherwise freeze at the last ingest)
        for lib in getattr(getattr(node, "libraries", None), "libraries",
                           {}).values():
            try:
                lags.update(lib.sync.observe_replication_lag())
            except Exception:  # noqa: BLE001 - health reads never fail
                continue
    else:
        fam = REGISTRY.get("sd_sync_lag_seconds")
        if fam is not None:
            with fam._lock:
                lags = {k[0]: s.value for k, s in fam._series.items() if k}
    guard_trips = counter_value("sd_hlc_delta_guard_total")
    gaps = _replication_gaps(node)
    signals = {"lag_seconds": lags, "delta_guard_trips": guard_trips,
               "head_gap_seconds": gaps}
    if not lags and not gaps:
        v = _verdict(UNKNOWN, "no replication peers")
        if guard_trips:
            v = _verdict(DEGRADED, f"{int(guard_trips)} delta-guard trips",
                         delta_guard_trips=guard_trips)
        return v
    # verdicts key off the corroborated head gap ONLY. Raw wall-lag
    # (now − last applied op) grows on a perfectly healthy idle mesh,
    # so it must never flip a node unhealthy — a probe acting on
    # GET /health's 503 would drain idle-but-fine nodes. (The /mesh
    # staleness rule separately covers 'peer gone silent'.)
    if gaps:
        worst_peer, worst = max(gaps.items(), key=lambda kv: kv[1])
        if worst >= SYNC_GAP_UNHEALTHY:
            return _verdict(
                UNHEALTHY,
                f"{worst:.0f}s of peer {worst_peer}'s ops not yet applied",
                **signals)
        if worst >= SYNC_GAP_DEGRADED:
            return _verdict(
                DEGRADED,
                f"{worst:.0f}s of peer {worst_peer}'s ops not yet applied",
                **signals)
    if guard_trips:
        return _verdict(DEGRADED, f"{int(guard_trips)} delta-guard trips",
                        **signals)
    return _verdict(HEALTHY, **signals)


def _serve(node: Any = None) -> dict[str, Any]:
    """Serve layer: the admission gate's overload posture. The port has
    no serve runtime until its plane lands, so the verdict is the one a
    JAX node without a serve runtime gives."""
    return _verdict(UNKNOWN, "serve gate disabled or absent")


def _slo(node: Any = None) -> dict[str, Any]:
    """SLO burn-rate posture (telemetry/slo.py over the node's
    persistent history). A breach — fast AND slow windows burning the
    error budget past their thresholds (or any protected-class shed)
    — is UNHEALTHY: the node is violating its stated contract, not
    merely degraded. A fast-window-only burn is DEGRADED (the warn
    stage of the standard multi-window alert). No history, or no
    samples yet, reads UNKNOWN and never worsens the rollup."""
    from . import slo as _slo_mod

    history = getattr(node, "history", None) if node is not None else None
    if history is None:
        return _verdict(UNKNOWN, "no telemetry history")
    evaluation = _slo_mod.evaluate(history)
    breached = [s["name"] for s in evaluation["slos"]
                if s["status"] == _slo_mod.BREACH]
    warned = [s["name"] for s in evaluation["slos"]
              if s["status"] == _slo_mod.WARN]
    signals = {"slos": {
        s["name"]: {"status": s["status"], "current": s.get("current")}
        for s in evaluation["slos"]
    }}
    if breached:
        return _verdict(
            UNHEALTHY, f"SLO breach: {', '.join(sorted(breached))}",
            **signals)
    if warned:
        return _verdict(
            DEGRADED,
            f"fast-window burn: {', '.join(sorted(warned))}", **signals)
    if evaluation["status"] == _slo_mod.NO_DATA:
        return _verdict(UNKNOWN, "no history samples yet")
    return _verdict(HEALTHY, **signals)


def _resources() -> dict[str, Any]:
    """Resource-growth posture (telemetry/resources.py + the trend SLO
    class). The verdict keys off the trend SLOs' verdicts from the
    evaluation the ``slo`` subsystem just ran — a sustained RSS/fd
    growth slope past its bar is UNHEALTHY (the node is leaking toward
    an OOM, on a schedule), a flattened-but-regressed window is
    DEGRADED. Disabled sampling (SD_RESOURCES=0) or no samples yet
    reads UNKNOWN and never worsens the rollup."""
    from . import resources as _res
    from . import slo as _slo_mod

    if not _res.enabled():
        return _verdict(UNKNOWN, "resource sampling disabled")
    summary = _res.SAMPLER.summary()
    if not summary.get("last"):
        return _verdict(UNKNOWN, "no resource samples yet",
                        running=summary.get("running", False))
    trend_names = {s.name for s in _slo_mod.REGISTRY.all()
                   if s.kind == "trend"}
    evaluation = _slo_mod.REGISTRY.last_evaluation or {}
    trends = {s["name"]: s for s in evaluation.get("slos", ())
              if s["name"] in trend_names}
    breached = sorted(n for n, s in trends.items()
                      if s["status"] == _slo_mod.BREACH)
    warned = sorted(n for n, s in trends.items()
                    if s["status"] == _slo_mod.WARN)
    signals = {
        "last": summary["last"],
        "samples": summary["samples"],
        "trends": {
            n: {"status": s["status"],
                **(s.get("windows", {}).get("trend") or {})}
            for n, s in trends.items()
        },
    }
    if breached:
        return _verdict(
            UNHEALTHY,
            f"resource growth past its slope bar: {', '.join(breached)}",
            **signals)
    if warned:
        return _verdict(
            DEGRADED,
            f"resource growth regressed: {', '.join(warned)}", **signals)
    return _verdict(HEALTHY, **signals)


def _tenants() -> dict[str, Any]:
    """Per-tenant fairness posture (telemetry/tenants.py + the
    ``tenant_fairness`` SLO). A burning fairness SLO is UNHEALTHY —
    one library is starving the rest on the serve surface, the exact
    condition ROADMAP item 4's enforcement loop exists to prevent; a
    fast-window warn or a dominant tenant holding nearly the whole
    surface is DEGRADED. Disabled accounting (SD_TENANT_OBS=0) or an
    idle plane reads UNKNOWN and never worsens the rollup."""
    from . import slo as _slo_mod
    from . import tenants as _ten

    if not _ten.enabled():
        return _verdict(UNKNOWN, "tenant accounting disabled")
    dig = _ten.digest()
    if not dig:
        return _verdict(UNKNOWN, "no tenant observations yet")
    evaluation = _slo_mod.REGISTRY.last_evaluation or {}
    fairness_slo = next(
        (s for s in evaluation.get("slos", ())
         if s["name"] == "tenant_fairness"), None)
    serve = dig.get("serve", {})
    signals = {
        "surfaces": len(dig),
        "serve_fairness": serve.get("fairness"),
        "serve_dominant": serve.get("dominant"),
        "slo": fairness_slo["status"] if fairness_slo else None,
        "digest": dig,
    }
    if fairness_slo and fairness_slo["status"] == _slo_mod.BREACH:
        return _verdict(
            UNHEALTHY,
            "tenant_fairness burning both windows — a tenant is "
            "starving the serve surface", **signals)
    if fairness_slo and fairness_slo["status"] == _slo_mod.WARN:
        return _verdict(
            DEGRADED, "tenant_fairness fast-window burn", **signals)
    if (serve.get("tenants", 0) >= 2
            and (serve.get("dominant") or 0.0) >= DOMINANT_DEGRADED):
        return _verdict(
            DEGRADED,
            f"dominant tenant holds {serve['dominant']:.0%} of the "
            "serve surface", **signals)
    return _verdict(HEALTHY, **signals)


def evaluate(node: Any = None) -> dict[str, Any]:
    """The full health rollup: per-subsystem verdicts plus the overall
    status (worst subsystem; ``unknown`` counts as healthy)."""
    subsystems = {
        "event_loop": _event_loop(),
        "feeder": _feeder(),
        "device": _device(),
        "p2p": _p2p(),
        "sync": _sync(node),
        "resilience": _resilience(),
        "serve": _serve(node),
        "slo": _slo(node),
        # MUST come after "slo": the trend verdicts they read are the
        # ones _slo just computed into REGISTRY.last_evaluation
        "resources": _resources(),
        "tenants": _tenants(),
    }
    overall = HEALTHY
    for v in subsystems.values():
        if _RANK[v["status"]] > _RANK[overall]:
            overall = v["status"]
    out = {"status": overall, "subsystems": subsystems}
    try:
        # the autotuner's knob state rides health (and therefore every
        # federation snapshot → GET /mesh): a node quietly running at a
        # demoted rung or 8× windows is a capacity fact operators need
        from ..parallel.autotune import snapshot as _autotune_snapshot

        out["autotune"] = _autotune_snapshot()
    except Exception:  # noqa: BLE001 - health reads never fail
        pass
    return out
