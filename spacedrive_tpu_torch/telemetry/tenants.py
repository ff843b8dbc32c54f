"""Per-tenant observability plane — bounded-cardinality accounting.

An owned copy of `spacedrive_tpu/telemetry/tenants.py`, sketches,
labels and derived signals unchanged. Every shared surface gets a
**space-saving heavy-hitter sketch** (Metwally et al.): at most ``K``
resident tenants with counters that carry an explicit overestimate
bound ``err`` (the count inherited on eviction-replacement), plus one
aggregated ``other`` bucket, so ``total`` is always exact. Tenant keys
are never raw identifiers: :func:`tenant_label` is the
``peers.peer_label`` discipline applied to library/instance ids.

Surfaces (fixed vocabulary, :data:`SURFACES`): ``serve``, ``cache_hit``,
``cache_miss``, ``relay_push``, ``relay_pull``, ``p2p_sync``,
``p2p_work``, ``p2p_telemetry``, ``ingest``, ``bytes_in``,
``bytes_out``. Their observers are the serve gate and cache, sync
ingest, the relay and the p2p responders, which come with their
planes; until then the plane holds no tenant, as a JAX node without
those planes holds none.

Derived signals: Jain's fairness index and dominant share per surface
(gauges), the ``tenant_fairness_index`` history series feeding the
``tenant_fairness`` SLO, the ``tenants`` health subsystem, the
federation digest, rspc ``telemetry.tenants``, the CLI's ``tenants``
and the debug bundle's ``tenants`` section.

``SD_TENANT_OBS=0`` is a true no-op: no sketches, no tenant history
series, no ``tenant_fairness`` SLO, no health signal, no federation
digest. ``SD_TENANT_TOPK`` sets K (default 8, 1–16).
"""

from __future__ import annotations

import os
import threading
import uuid
from typing import Any

from . import metrics as _tm
from .peers import peer_label
from .registry import TIME_BUCKETS

#: fixed surface vocabulary (see module docstring); tap sites pass
#: these strings as constants so the ``surface`` metric label stays
#: bounded by construction
SURFACES = (
    "serve",
    "cache_hit",
    "cache_miss",
    "relay_push",
    "relay_pull",
    "p2p_sync",
    "p2p_work",
    "p2p_telemetry",
    "ingest",
    "bytes_in",
    "bytes_out",
)

#: the aggregated non-resident bucket label
OTHER = "other"

#: surfaces whose sketch counts contribute to the serve-side fairness
#: posture read by the health subsystem (byte surfaces are weighted
#: by payload size and would drown request fairness)
_FAIRNESS_SURFACE = "serve"


def enabled() -> bool:
    """SD_TENANT_OBS=0 disables the whole plane (true no-op)."""
    return os.environ.get("SD_TENANT_OBS", "1") != "0"


def topk() -> int:
    """Sketch residency K (per surface), bounded to keep the
    per-tenant metric families inside the registry's series cap."""
    try:
        k = int(os.environ.get("SD_TENANT_TOPK", "8"))
    except ValueError:
        k = 8
    return max(1, min(k, 16))


def tenant_label(tenant_id: Any) -> str:
    """Short stable hash of a library/instance id — the only form a
    tenant identity may take on a metric label, ring entry, history
    record, federation digest, or debug bundle (sdlint SD027).

    Same blake2b discipline (and therefore the same label namespace)
    as ``peers.peer_label``: UUIDs hash by their bytes so the DB's
    string form and the wire's UUID form agree — the serve/cache taps
    see the request's *string* library id while p2p/sync taps hold
    ``uuid.UUID`` objects, and one tenant must not split into two
    labels across surfaces (any ``uuid.UUID()``-parsable spelling —
    uppercase, undashed, urn: — folds to the same label).
    """
    if isinstance(tenant_id, str):
        try:
            tenant_id = uuid.UUID(tenant_id)
        except ValueError:
            pass
    return peer_label(tenant_id)


class SpaceSavingSketch:
    """Space-saving top-K heavy hitters with an aggregated tail.

    ``counts[label]`` is an upper bound on the tenant's true count;
    ``errs[label]`` is the slack (the count inherited when the tenant
    replaced the previous minimum resident — 0 means exact). ``other``
    accumulates observations attributed to evicted/non-resident
    tenants so ``total`` is always exact. Residents also carry a
    fixed-bucket latency histogram (TIME_BUCKETS) when the surface
    observes durations.
    """

    __slots__ = ("k", "counts", "errs", "hists", "total", "other",
                 "evictions")

    def __init__(self, k: int) -> None:
        self.k = k
        self.counts: dict[str, float] = {}
        self.errs: dict[str, float] = {}
        self.hists: dict[str, list[int]] = {}
        self.total = 0.0
        self.other = 0.0
        self.evictions = 0

    def observe(self, label: str, n: float,
                seconds: float | None) -> bool:
        """Count ``n`` for ``label``; returns True while the tenant is
        resident after the observation (callers label metric series
        ``other`` otherwise)."""
        self.total += n
        counts = self.counts
        if label in counts:
            counts[label] += n
        elif len(counts) < self.k:
            counts[label] = n
            self.errs[label] = 0.0
        else:
            victim = min(counts, key=counts.__getitem__)
            floor = counts[victim]
            # the victim's observations stay accounted in ``other``;
            # the newcomer inherits the floor as its overestimate
            self.other += floor - self.errs[victim]
            del counts[victim]
            del self.errs[victim]
            self.hists.pop(victim, None)
            counts[label] = floor + n
            self.errs[label] = floor
            self.evictions += 1
        if seconds is not None:
            hist = self.hists.get(label)
            if hist is None:
                hist = self.hists[label] = [0] * (len(TIME_BUCKETS) + 1)
            for i, bound in enumerate(TIME_BUCKETS):
                if seconds <= bound:
                    hist[i] += 1
                    break
            else:
                hist[-1] += 1
        return True

    def fairness_index(self) -> float:
        """Jain's fairness index over resident counts: 1.0 when every
        resident tenant gets an equal share, → 1/n under a single
        dominant tenant. 1.0 when idle or single-tenant (nothing to
        be unfair about)."""
        xs = list(self.counts.values())
        if len(xs) < 2:
            return 1.0
        sq = sum(x * x for x in xs)
        if sq <= 0:
            return 1.0
        s = sum(xs)
        return (s * s) / (len(xs) * sq)

    def dominant_share(self) -> float:
        """Largest resident count over the exact surface total."""
        if not self.counts or self.total <= 0:
            return 0.0
        return max(self.counts.values()) / self.total

    def residents(self) -> list[dict[str, Any]]:
        """Resident rows, largest first, with share + error bound and
        a coarse latency read (p50/p99 from the fixed buckets)."""
        rows = []
        total = self.total or 1.0
        for label, count in sorted(self.counts.items(),
                                   key=lambda kv: -kv[1]):
            row: dict[str, Any] = {
                "tenant": label,
                "count": count,
                "err": self.errs.get(label, 0.0),
                "share": count / total,
            }
            hist = self.hists.get(label)
            if hist is not None and sum(hist) > 0:
                row["p50_s"] = _bucket_quantile(hist, 0.50)
                row["p99_s"] = _bucket_quantile(hist, 0.99)
            rows.append(row)
        return rows


def _bucket_quantile(hist: list[int], q: float) -> float:
    """Upper bucket bound holding the q-quantile (inf bucket reports
    the largest finite bound — a floor, honest enough for a sketch)."""
    n = sum(hist)
    rank = q * n
    seen = 0.0
    for i, c in enumerate(hist):
        seen += c
        if seen >= rank and c:
            return TIME_BUCKETS[i] if i < len(TIME_BUCKETS) \
                else TIME_BUCKETS[-1]
    return TIME_BUCKETS[-1]


class TenantPlane:
    """Per-surface sketches behind one lock (tap sites are hot but
    the work per observation is O(K) dict ops at K ≤ 16)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sketches: dict[str, SpaceSavingSketch] = {}

    def observe(self, surface: str, tenant_id: Any, n: float = 1.0,
                seconds: float | None = None) -> None:
        if tenant_id is None or n <= 0:
            return
        label = tenant_label(tenant_id)
        with self._lock:
            sketch = self._sketches.get(surface)
            if sketch is None:
                sketch = self._sketches[surface] = \
                    SpaceSavingSketch(topk())
            resident_before = (label in sketch.counts
                               or len(sketch.counts) < sketch.k)
            sketch.observe(label, n, seconds)
            fairness = sketch.fairness_index()
            dominant = sketch.dominant_share()
            nres = len(sketch.counts)
        # metric series only ever carry resident labels or ``other``
        # — non-residents fold so cardinality is bounded by K+1 per
        # surface with the registry overflow cap as the backstop
        if not resident_before:
            label = OTHER
        _tm.TENANT_OPS.inc(n, surface=surface, tenant=label)
        if seconds is not None:
            _tm.TENANT_SECONDS.observe(
                seconds, surface=surface, tenant=label)
        _tm.TENANT_FAIRNESS.set(fairness, surface=surface)
        _tm.TENANT_DOMINANT.set(dominant, surface=surface)
        _tm.TENANT_RESIDENTS.set(nres, surface=surface)

    def fairness_index(self, surface: str = _FAIRNESS_SURFACE) -> float:
        with self._lock:
            sketch = self._sketches.get(surface)
            return sketch.fairness_index() if sketch else 1.0

    def dominant_share(self, surface: str = _FAIRNESS_SURFACE) -> float:
        with self._lock:
            sketch = self._sketches.get(surface)
            return sketch.dominant_share() if sketch else 0.0

    def snapshot(self) -> dict[str, Any]:
        """Full read path (``GET /tenants``, rspc, bundle): hashed
        labels only — redaction-clean by construction."""
        doc: dict[str, Any] = {"enabled": enabled(), "k": topk(),
                               "surfaces": {}}
        if not enabled():
            return doc
        with self._lock:
            for surface, sketch in sorted(self._sketches.items()):
                doc["surfaces"][surface] = {
                    "total": sketch.total,
                    "other": sketch.other,
                    "evictions": sketch.evictions,
                    "fairness_index": sketch.fairness_index(),
                    "dominant_share": sketch.dominant_share(),
                    "residents": sketch.residents(),
                }
        return doc

    def digest(self) -> dict[str, Any]:
        """Compact federation digest riding ``_local_snapshot`` — a
        few numbers + top-3 labels per surface, never raw ids."""
        out: dict[str, Any] = {}
        with self._lock:
            for surface, sketch in sorted(self._sketches.items()):
                total = sketch.total or 1.0
                top = sorted(sketch.counts.items(),
                             key=lambda kv: -kv[1])[:3]
                out[surface] = {
                    "total": sketch.total,
                    "tenants": len(sketch.counts),
                    "fairness": round(sketch.fairness_index(), 4),
                    "dominant": round(sketch.dominant_share(), 4),
                    "top": [{"tenant": t, "share": round(c / total, 4)}
                            for t, c in top],
                }
        return out

    def reset(self) -> None:
        with self._lock:
            self._sketches.clear()


PLANE = TenantPlane()


def observe(surface: str, tenant_id: Any, n: float = 1.0,
            seconds: float | None = None) -> None:
    """Record ``n`` observations for a tenant on a surface; the ONE
    tap-site entry point. No-op when the plane is disabled or the
    call site has no tenant identity (``tenant_id is None``)."""
    if not enabled():
        return
    PLANE.observe(surface, tenant_id, n, seconds)


def observe_bytes(tenant_id: Any, n: int, *, outbound: bool) -> None:
    """Payload-byte accounting — a sketch weighted by size, so the
    heavy hitters are the bandwidth hogs, not the chattiest."""
    if not enabled():
        return
    PLANE.observe("bytes_out" if outbound else "bytes_in",
                  tenant_id, float(n))


def fairness_index(surface: str = _FAIRNESS_SURFACE) -> float:
    """History-sampler read: 1.0 when idle/disabled (fair by vacuity
    — the SLO's lower-bound objective never burns on an idle node)."""
    if not enabled():
        return 1.0
    return PLANE.fairness_index(surface)


def dominant_share(surface: str = _FAIRNESS_SURFACE) -> float:
    if not enabled():
        return 0.0
    return PLANE.dominant_share(surface)


def snapshot() -> dict[str, Any]:
    return PLANE.snapshot()


def digest() -> dict[str, Any]:
    return PLANE.digest()


def reset() -> None:
    """telemetry.reset() hook — drop every sketch (the fairness
    gauges and tenant_fairness SLO state are registry/SLO state and
    reset through their own planes)."""
    PLANE.reset()
