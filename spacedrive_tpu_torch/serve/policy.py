"""ServePolicy — the serve layer's single tuning seam.

Counterpart of `spacedrive_tpu/serve/policy.py`, its tables and
defaults unchanged.

Every knob the admission gate, the read-path cache, and write-combined
sync ingest consume lives here, the same way ``parallel.autotune``'s
``PipelinePolicy`` owns the pipeline sizing constants: one policy
object, read live at each decision point, so the autotune controller can
later close the loop on serving capacity (shrink interactive budgets
under loop lag, widen them when the node idles) without touching a
consumer.

Priority classes (ordered, highest first — the overload contract):

- ``control`` — health probes, metrics scrapes, diagnostics. Never
  queued, never shed: a load balancer must always learn the truth.
- ``sync`` — replication and P2P serving legs (SYNC/SYNC_REQUEST /
  TELEMETRY / WORK responders, federation). Never shed: a node that
  stops replicating under read pressure diverges exactly when its
  peers most need to offload it.
- ``interactive`` — explorer reads: rspc queries/mutations, thumbnail
  fetches, file serving, search. Queued with a deadline, then shed.
- ``background`` — trace exports, debug bundles, backups, model
  listings. First to shed; in brownout they shed immediately.

``SD_SERVE_GATE=0`` disables the whole serve layer (gate AND caches):
every request takes exactly the pre-serve code path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

#: the priority-class vocabulary (also the metric label values)
CONTROL = "control"
SYNC = "sync"
INTERACTIVE = "interactive"
BACKGROUND = "background"

CLASSES = (CONTROL, SYNC, INTERACTIVE, BACKGROUND)


def enabled() -> bool:
    """The serve layer's master switch (``SD_SERVE_GATE=0`` = off)."""
    return os.environ.get("SD_SERVE_GATE", "1") != "0"


@dataclass
class ClassBudget:
    """One priority class's admission budget.

    ``sheddable=False`` classes (control, sync) are always admitted
    immediately — their budgets exist for observability (the inflight
    gauge), not enforcement. Sheddable classes run up to
    ``max_inflight`` concurrently, park up to ``max_queue`` waiters for
    at most ``queue_deadline_s`` each, and fast-fail everything else.
    """

    max_inflight: int
    max_queue: int = 0
    queue_deadline_s: float = 0.0
    sheddable: bool = True


@dataclass
class ServePolicy:
    """All serve-layer knobs; defaults sized for one node on a small
    host (the budgets bound *concurrency*, not rate — SQLite serializes
    internally, so a handful of in-flight reads already saturates it)."""

    # Interactive sizing rationale: per-library SQLite serializes
    # writes and the GIL serializes the Python row work, so in-flight
    # beyond the host's core count buys zero throughput — concurrent
    # heavy reads only convoy behind each other, multiplying every
    # admitted request's service time. The budget follows the cores
    # (floor 2 so one slow read can never starve the class, cap 8);
    # the queue is deliberately SHORT in time terms (max_queue ×
    # per-read service) because every queued entry adds its full
    # service time to the admitted p99 — the bench bar is "admitted
    # p99 ≤ 5× unloaded p99", not "accept everything".
    budgets: dict[str, ClassBudget] = field(default_factory=lambda: {
        CONTROL: ClassBudget(max_inflight=64, sheddable=False),
        SYNC: ClassBudget(max_inflight=32, sheddable=False),
        INTERACTIVE: ClassBudget(
            max_inflight=max(2, min(8, os.cpu_count() or 4)),
            max_queue=8, queue_deadline_s=0.1,
        ),
        BACKGROUND: ClassBudget(
            max_inflight=2, max_queue=4, queue_deadline_s=0.25,
        ),
    })

    #: advisory deadline installed (utils.resilience.deadline_scope)
    #: around each admitted sheddable request, so downstream awaits are
    #: clipped instead of holding a slot forever
    request_deadline_s: float = 30.0

    #: Retry-After seconds advertised on shed responses
    retry_after_s: float = 1.0

    # --- brownout (degraded serving) -----------------------------------
    #: event-loop lag that flips the gate into brownout (matches the
    #: health model's LOOP_LAG_DEGRADED)
    brownout_loop_lag_s: float = 0.2
    #: brownout persists this long past the last shed / lag spike
    #: (hysteresis: the mode must not flap per request; in brownout a
    #: full sheddable budget fast-fails instead of queueing)
    brownout_hold_s: float = 5.0

    # --- read-path cache ------------------------------------------------
    #: explorer-query cache entries (each one normalised result page)
    query_cache_entries: int = 2048
    #: freshness TTL for cached query results; invalidation (local
    #: mutations + sync-applied batches) is the primary correctness
    #: mechanism — the TTL only bounds staleness against writes that
    #: bypass the invalidation plane entirely
    query_ttl_s: float = 5.0
    #: how far past TTL a stale entry may be served in brownout
    stale_serve_max_s: float = 120.0
    #: thumbnail byte-cache budget (content-addressed entries — a webp
    #: for a cas_id never changes, so eviction is the only invalidation)
    thumb_cache_bytes: int = 32 * 1024 * 1024
    #: /mesh view + local-snapshot micro-TTLs: N concurrent dashboards
    #: cost one computation per window (single-flight collapses the rest)
    mesh_ttl_s: float = 2.0
    snapshot_ttl_s: float = 1.0

    # --- write-combined sync ingest --------------------------------------
    #: remote ops coalesced into one SQLite transaction (also the ingest
    #: actor's yield quantum, replacing the old fixed 64)
    sync_txn_ops: int = 64


#: the process default; tests swap it via `serve.gate.AdmissionGate(policy=…)`
#: or by mutating fields (dataclass, live-read at each decision point)
POLICY = ServePolicy()


def policy() -> ServePolicy:
    return POLICY


# --- the rspc priority map --------------------------------------------------
#
# Every rspc namespace (the key prefix before the first ".", or the full
# key for root procedures) must appear here, or the registration site
# must pass an explicit ``priority=``, so that no procedure silently
# bypasses the gate seam.
NAMESPACE_CLASSES: dict[str, str] = {
    # root procedures
    "buildInfo": "control",
    "nodeState": "control",
    "toggleFeatureFlag": "interactive",
    # interactive explorer surface
    "library": "interactive",
    "locations": "interactive",
    "files": "interactive",
    "ephemeralFiles": "interactive",
    "jobs": "interactive",
    "search": "interactive",
    "tags": "interactive",
    "spaces": "interactive",
    "albums": "interactive",
    "labels": "interactive",
    "volumes": "interactive",
    "keys": "interactive",
    "preferences": "interactive",
    "notifications": "interactive",
    "nodes": "interactive",
    "invalidation": "interactive",
    # replication / mesh planes
    "sync": "sync",
    "p2p": "sync",
    "cloud": "sync",
    # diagnostics (the health/metrics read path). Only the CHEAP
    # answers ride control: the heavyweight members (mesh federation
    # refresh, trace export, debug bundle) carry explicit priority=
    # overrides at their registration — control is unsheddable, so
    # anything expensive under it is an overload hole
    "telemetry": "control",
    # heavyweight maintenance
    "backups": "background",
    "auth": "background",
    "models": "background",
}


def class_for_key(key: str, explicit: str | None = None) -> str:
    """Priority class for an rspc procedure key: the registration's
    explicit class wins, else the namespace map, else interactive."""
    if explicit is not None:
        return explicit
    ns = key.split(".", 1)[0] if "." in key else key
    return NAMESPACE_CLASSES.get(ns, INTERACTIVE)


#: query keys the read-path cache may serve (library-scoped reads whose
#: results are invalidated by the mutation plane AND sync-applied ops).
#: Deliberately an allowlist: a query must be read-only, normalised,
#: and a pure function of DB state to be cacheable — everything else
#: always hits SQLite. (`locations.list` is NOT here: it stamps live
#: per-row path reachability (`online`), which no DB mutation — and
#: therefore no invalidation — tracks; caching it freezes the sidebar
#: dot for a TTL after a volume unmounts.)
CACHEABLE_QUERIES = frozenset({
    "search.paths",
    "search.objects",
    "search.semantic",
    "tags.list",
    "labels.list",
    "library.statistics",
    "library.kindStatistics",
})
