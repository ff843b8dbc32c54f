"""Telemetry federation, local half — the compact, versioned snapshot a
node serves about itself.

An owned copy of the local half of `spacedrive_tpu/telemetry/federation.py`:
:func:`local_snapshot` (health verdicts, compact metric values, ring
digests, the host profiler's digest, the tenant digest and each
library's head, watermarks, lag and index-journal stats) and
:func:`mesh_status`. The snapshot carries metric *values*, verdicts and
digests — never raw ring payloads or span bodies, which stay on the
owning node. The per-peer ``FederationCache`` and its pulls come with
the p2p plane; until then ``mesh_status`` gives this node alone, as a
JAX node without a p2p manager does.
"""

from __future__ import annotations

import time
from typing import Any

from .events import all_events
from .peers import peer_label
from .registry import REGISTRY, Histogram

SNAPSHOT_VERSION = 1


# --- the local snapshot (what a node serves about itself) ---------------


def _compact_metrics() -> dict[str, Any]:
    """Counter/gauge values and histogram sum+count per series, keyed
    ``name{label=value,...}`` — the smallest shape that still lets the
    mesh view answer 'how much' questions without shipping buckets."""
    out: dict[str, Any] = {}
    with REGISTRY._lock:
        for name, fam in REGISTRY._families.items():
            series: dict[str, Any] = {}
            for key, s in fam._series.items():
                labelstr = ",".join(
                    f"{n}={v}" for n, v in zip(fam.label_names, key)
                )
                if isinstance(fam, Histogram):
                    series[labelstr] = {"sum": s.sum, "count": s.count}
                else:
                    series[labelstr] = s.value
            out[name] = series
    return out


def _ring_digests() -> dict[str, Any]:
    """Per-ring length, newest timestamp, and type counts — enough to
    see 'the error ring is filling with watcher failures' from across
    the mesh without shipping payloads (which may embed paths or
    messages that only the owning node's bundle redaction may touch)."""
    from .events import drop_counts

    drops = drop_counts()
    out: dict[str, Any] = {}
    for ring_name, events in all_events().items():
        types: dict[str, int] = {}
        for e in events:
            t = str(e.get("type", "?"))
            types[t] = types.get(t, 0) + 1
        out[ring_name] = {
            "len": len(events),
            "last_ts": events[-1].get("ts") if events else None,
            "types": types,
        }
        if drops.get(ring_name):
            # overflow honesty crosses the mesh too: a saturated ring
            # on a peer should read as "suffix", not "quiet"
            out[ring_name]["dropped"] = drops[ring_name]
    return out


def local_snapshot(node: Any = None) -> dict[str, Any]:
    """The compact, versioned self-snapshot a node serves to the mesh
    (the ``local`` half of ``telemetry.mesh``). JAX rides it on the
    serve runtime's short-TTL cache; the port has no serve runtime yet,
    so each call computes it, as a JAX node without one does."""
    from . import health as _health
    from . import sampler as _sampler
    from . import tenants as _tenants

    snap: dict[str, Any] = {
        "v": SNAPSHOT_VERSION,
        "ts": time.time(),
        "health": _health.evaluate(node),
        "metrics": _compact_metrics(),
        "rings": _ring_digests(),
        # host-profiler digest (totals, state split, top frame groups,
        # capture count) — like ring digests, never stacks or payloads:
        # those stay on the owning node behind an explicit profile pull
        "profile": _sampler.SAMPLER.summary(),
    }
    if _tenants.enabled():
        # per-tenant heavy-hitter digest (hashed labels, a few numbers
        # per surface) so every peer's /mesh shows who is spending
        # each shared surface mesh-wide; gated so SD_TENANT_OBS=0
        # keeps the snapshot shape identical to a pre-tenants node
        snap["tenants"] = _tenants.digest()
    if node is not None:
        cfg = node.config.config
        libraries: dict[str, Any] = {}
        for lib in getattr(getattr(node, "libraries", None), "libraries",
                           {}).values():
            try:
                from ..location.indexer.journal import IndexJournal

                libraries[str(lib.id)] = {
                    "name": lib.name,
                    "instance_label": peer_label(lib.sync.instance),
                    # library head: the newest HLC this node has seen
                    # (created or applied) — peers compare it against
                    # their own head to measure real replication gaps
                    # (telemetry.health._replication_gaps)
                    "head_seconds": lib.sync.clock.peek_last().as_unix(),
                    "watermarks": lib.sync.replication_watermarks(),
                    "lag_seconds": lib.sync.observe_replication_lag(),
                    # per-location index-journal effectiveness (entry
                    # counts from the DB, hit rate / bytes saved from
                    # this process) — the warm-pass story, mesh-wide
                    "index_journal": IndexJournal(lib.db).location_stats(),
                }
            except Exception:  # noqa: BLE001 - snapshots degrade, never fail
                libraries[str(lib.id)] = {"name": getattr(lib, "name", "?")}
        snap["node"] = {
            "id": str(cfg.id),
            "name": cfg.name,
            "libraries": libraries,
        }
    return snap


def snapshot_compatible(snap: Any) -> bool:
    """Versioned-decode guard: a peer running a newer wire revision
    may serve a shape we cannot interpret — treat as no snapshot."""
    return isinstance(snap, dict) and snap.get("v") == SNAPSHOT_VERSION


def mesh_status(node: Any) -> dict[str, Any]:
    """The ``telemetry.mesh`` payload: this node's own snapshot and the
    federation cache's view of everyone else — no peers until the p2p
    plane, as for a JAX node without a p2p manager."""
    return {"local": local_snapshot(node), "mesh": {"peers": {}}}
