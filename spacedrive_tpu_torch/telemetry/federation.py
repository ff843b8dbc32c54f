"""Telemetry federation — pull-aggregating peer snapshots across the mesh.

An owned copy of `spacedrive_tpu/telemetry/federation.py`. Each node
serves a **compact, versioned snapshot** of its own health
(:func:`local_snapshot`: health verdicts, compact metric values, ring
digests, the host profiler's digest, the tenant digest and each
library's head, watermarks, lag and index-journal stats) over the P2P
``TELEMETRY`` wire request, and a ``FederationCache`` on the asking node
holds the freshest snapshot per peer with explicit staleness tracking.

Staleness rules (the contract ``telemetry.mesh`` exposes):

- a snapshot is **fresh** while its age is under ``STALE_AFTER``
  seconds; the cache re-pulls a peer only when its snapshot is older
  than ``REFRESH_INTERVAL`` (pull-through, so a burst of reads doesn't
  stampede the mesh);
- past ``STALE_AFTER`` the entry is **stale** and the peer's mesh
  verdict becomes ``unhealthy`` regardless of what the old snapshot
  claimed — a peer we cannot hear from is a peer we must assume sick;
- pull failures keep the last snapshot (aging toward stale) and record
  the error, so the operator sees *both* "last known state" and "we
  can't reach it anymore".

The snapshot carries metric *values*, verdicts and digests — never raw
ring payloads or span bodies, which stay on the owning node. JAX rides
the snapshot and the mesh view on the serve runtime's caches; the port
has no serve runtime yet, so each call computes them, as a JAX node
without one does.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from . import metrics as _tm
from .events import all_events
from .peers import peer_label
from .registry import REGISTRY, Histogram

SNAPSHOT_VERSION = 1
STALE_AFTER = 60.0       # seconds until a cached snapshot counts as stale
REFRESH_INTERVAL = 5.0   # min age before the cache re-pulls a peer


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


# --- the per-peer cache (what a node knows about everyone else) ---------


class FederationCache:
    """Freshest-known snapshot per peer + staleness bookkeeping.

    Keys are opaque peer ids chosen by the puller (the P2P
    ``RemoteIdentity`` string for direct peers, ``instance:<uuid>`` for
    relay-only instances). ``mesh()`` is the read path behind
    rspc ``telemetry.mesh`` and the CLI's ``mesh-status``.
    """

    def __init__(self, stale_after: float = STALE_AFTER,
                 refresh_interval: float = REFRESH_INTERVAL):
        self.stale_after = stale_after
        self.refresh_interval = refresh_interval
        self._lock = threading.Lock()
        self._peers: dict[str, dict[str, Any]] = {}

    def store(self, peer_id: str, snapshot: dict[str, Any],
              transport: str = "p2p", age_seconds: float = 0.0) -> None:
        """A successful pull: remember the snapshot and when we got it.
        ``age_seconds`` backdates relayed copies — a snapshot that sat
        on the relay for a minute is already a minute old, and must go
        stale on the same clock as a direct pull would. A backdated (or
        late-arriving) copy never replaces a FRESHER one: a stale relay
        row must not mark a peer unhealthy seconds after a direct P2P
        pull proved it alive."""
        fetched_at = time.time() - max(0.0, float(age_seconds))
        _tm.FED_PULLS.inc(result="relay" if transport == "relay" else "p2p")
        with self._lock:
            entry = self._peers.setdefault(str(peer_id), {})
            if entry.get("fetched_at", float("-inf")) > fetched_at:
                return
            entry.update(
                snapshot=snapshot,
                fetched_at=fetched_at,
                transport=transport,
                error=None,
            )

    def record_failure(self, peer_id: str, error: str) -> None:
        """A failed pull: keep the last snapshot (aging), note the error."""
        with self._lock:
            entry = self._peers.setdefault(str(peer_id), {})
            entry["error"] = str(error)[:300]
            entry["failed_at"] = time.time()
        _tm.FED_PULLS.inc(result="error")

    def fresh_snapshots(self) -> dict[str, dict[str, Any]]:
        """Snapshot per peer, restricted to entries younger than the
        staleness horizon — the corroboration source for health's
        replication-gap verdicts (a stale snapshot must not vouch for
        anything)."""
        now = time.time()
        with self._lock:
            return {
                pid: entry["snapshot"]
                for pid, entry in self._peers.items()
                if entry.get("snapshot") is not None
                and entry.get("fetched_at") is not None
                and now - entry["fetched_at"] < self.stale_after
            }

    def needs_refresh(self, peer_id: str) -> bool:
        with self._lock:
            entry = self._peers.get(str(peer_id))
            if entry is None or "fetched_at" not in entry:
                return True
            return time.time() - entry["fetched_at"] >= self.refresh_interval

    def due_relay_peers(self) -> list[str]:
        """Peers we only know through the relay whose snapshot has aged
        past the refresh interval — the signal that a relay exchange is
        worth its HTTP round-trips on an otherwise-quiet refresh."""
        with self._lock:
            pids = [
                pid for pid, entry in self._peers.items()
                if entry.get("transport") == "relay"
            ]
        return [pid for pid in pids if self.needs_refresh(pid)]

    def forget(self, peer_id: str) -> None:
        with self._lock:
            self._peers.pop(str(peer_id), None)

    def clear(self) -> None:
        with self._lock:
            self._peers.clear()

    def mesh(self) -> dict[str, Any]:
        """Per-peer view: snapshot + age + staleness + rolled verdict.
        A stale peer is verdict-``unhealthy`` no matter how healthy its
        last snapshot looked — silence is a symptom."""
        from .health import UNHEALTHY, UNKNOWN

        now = time.time()
        with self._lock:
            items = [(pid, dict(entry)) for pid, entry in self._peers.items()]
        peers: dict[str, Any] = {}
        fresh_n = stale_n = 0
        for pid, entry in items:
            snap = entry.get("snapshot")
            fetched_at = entry.get("fetched_at")
            age = (now - fetched_at) if fetched_at is not None else None
            stale = age is None or age >= self.stale_after
            if stale:
                stale_n += 1
            else:
                fresh_n += 1
            if snap is not None:
                own = snap.get("health", {}).get("status", UNKNOWN)
            else:
                own = UNKNOWN
            verdict = UNHEALTHY if stale else own
            label = peer_label(pid)
            # the JOIN KEY between this mesh view and the per-peer sync
            # metric series: sync labels hash the instance pub_id, not
            # the transport identity this cache keys by — surface each
            # snapshot's instance labels so operators (and dashboards)
            # can correlate sd_sync_lag_seconds{peer=...} with a peer
            # entry without reversing any hash
            instance_labels = sorted({
                lib.get("instance_label")
                for lib in ((snap or {}).get("node") or {})
                .get("libraries", {}).values()
                if isinstance(lib, dict) and lib.get("instance_label")
            })
            peers[pid] = {
                "peer_label": label,
                "instance_labels": instance_labels,
                "age_seconds": age,
                "stale": stale,
                "verdict": verdict,
                "transport": entry.get("transport"),
                "error": entry.get("error"),
                "snapshot": snap,
            }
            if age is not None:
                _tm.FED_SNAPSHOT_AGE.set(age, peer=label)
        _tm.FED_PEERS.set(fresh_n, state="fresh")
        _tm.FED_PEERS.set(stale_n, state="stale")
        return {
            "ts": now,
            "stale_after_seconds": self.stale_after,
            "peers": peers,
        }


def mesh_status(node: Any) -> dict[str, Any]:
    """The full ``telemetry.mesh`` payload: this node's own snapshot plus
    the federation cache's view of everyone else."""
    p2p = getattr(node, "p2p", None)
    cache: FederationCache | None = getattr(p2p, "federation", None)
    return {
        "local": local_snapshot(node),
        "mesh": cache.mesh() if cache is not None else {"peers": {}},
    }


async def mesh_status_cached(
    node: Any, *, refresh: bool = True, force: bool = False,
) -> dict[str, Any]:
    """``telemetry.mesh`` read path: the federation refresh (``force``
    re-pulls every peer) and the ``mesh_status`` walk. JAX single-flights
    it through the serve cache; without a serve runtime, as here, this
    is its direct path."""
    p2p = getattr(node, "p2p", None)
    if p2p is not None and refresh:
        await p2p.refresh_federation(force=force)
    return mesh_status(node)
