"""Metric families of the port's device seam, fault plane and host
execution plane.

The subset of `spacedrive_tpu/telemetry/metrics.py` that the port
writes so far, with the JAX package's names, help, labels and buckets,
so a scrape of either package reads the same series. The rest of the
catalog comes with the telemetry plane. This module imports no torch:
process-pool workers import it to ship their telemetry deltas.
"""

from __future__ import annotations

from .registry import RATIO_BUCKETS, REGISTRY

# --- semantic search (object/search/index.py) ------------------------------

SEARCH_QUERIES = REGISTRY.counter(
    "sd_search_queries_total",
    "semantic search queries by scoring path (device = jitted matmul "
    "top-k, host = numpy fallback after a device failure)",
    labels=("path",),  # device | host
)

# --- multi-device dp dispatch (ops/blake3_torch, thumbnail_torch, embed_torch)

# rows-per-device of a sharded dispatch: powers of two covering the
# batch ladder (32..1024 per device) with headroom for bigger rungs
ROW_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)

SHARD_BATCH_ROWS = REGISTRY.histogram(
    "sd_device_shard_batch_rows",
    "rows each device receives in a dp-sharded dispatch",
    labels=("op",),  # blake3 | thumbnail | embed
    buckets=ROW_BUCKETS,
)
DEVICE_DISPATCH_OCCUPANCY = REGISTRY.histogram(
    "sd_device_dispatch_occupancy",
    "fraction of a device's shard rows holding real (non-pad) work, "
    "one observation per device per sharded dispatch",
    labels=("op",),  # blake3 | thumbnail | embed
    buckets=RATIO_BUCKETS,
)
CAS_BACKEND_FALLBACK = REGISTRY.counter(
    "sd_cas_backend_fallback_total",
    "cas_ids('auto') device failures that degraded to the host backend",
)

# --- resilience (utils/faults.py, parallel/mesh.py, parallel/feeder.py) ----

FAULTS_INJECTED = REGISTRY.counter(
    "sd_faults_injected_total",
    "fault-plane activations (chaos testing only; 0 in production)",
)
DEVICE_DEMOTION = REGISTRY.gauge(
    "sd_device_demotion_level",
    "device dispatch degradation rung: 0 = full mesh, 1 = surviving "
    "chip subset, 2 = host reference path",
)
FEEDER_RESTARTS = REGISTRY.counter(
    "sd_feeder_restarts_total",
    "window-pipeline producer threads restarted after a crash",
)

# --- host→device feeder (parallel/feeder.py) --------------------------------

FEEDER_H2D_BYTES = REGISTRY.counter(
    "sd_feeder_h2d_bytes_total",
    "bytes staged for host→device transfer by the window pipeline",
)
FEEDER_FETCH_SECONDS = REGISTRY.histogram(
    "sd_feeder_fetch_seconds",
    "producer-side time to read+dispatch one window",
)
FEEDER_WAIT_SECONDS = REGISTRY.histogram(
    "sd_feeder_wait_seconds",
    "consumer-side time blocked waiting for the next window",
)
FEEDER_INFLIGHT = REGISTRY.gauge(
    "sd_feeder_inflight_depth",
    "ready windows parked in the pipeline queue",
)
FEEDER_PREFETCH = REGISTRY.counter(
    "sd_feeder_prefetch_total",
    "window handoffs by outcome",
    labels=("result",),  # hit | miss
)

# --- multi-process execution plane (parallel/procpool.py) -------------------
# Counters/histograms here are OWNER-side series. Workers accumulate
# into their own per-process registry and ship additive deltas back
# with each batch result (registry.merge_delta) — gauges never merge.

PROCPOOL_WORKERS = REGISTRY.gauge(
    "sd_procpool_workers",
    "worker processes currently alive in the multi-process execution "
    "plane (0 = SD_PROCS disabled or pool stopped)",
)
PROCPOOL_JOBS = REGISTRY.counter(
    "sd_procpool_jobs_total",
    "pool batches by outcome: ok (result + telemetry delta merged), "
    "error (worker raised — the call site falls back to its inline "
    "path), retried (re-dispatched after a worker died mid-batch)",
    labels=("result",),  # ok | error | retried
)
PROCPOOL_DISPATCH_SECONDS = REGISTRY.histogram(
    "sd_procpool_dispatch_seconds",
    "owner-side submit cost per batch (msgpack serialization + queue "
    "put — the IPC tax the PipelinePolicy batch quantum amortizes)",
)
PROCPOOL_ROUNDTRIP_SECONDS = REGISTRY.histogram(
    "sd_procpool_roundtrip_seconds",
    "submit-to-result wall time per pool batch",
)
PROCPOOL_BATCH_ROWS = REGISTRY.histogram(
    "sd_procpool_batch_rows",
    "rows per shipped pool batch (sized by the per-workload "
    "PipelinePolicy procpool quantum)",
    buckets=ROW_BUCKETS,
)
PROCPOOL_RESTARTS = REGISTRY.counter(
    "sd_procpool_restarts_total",
    "worker processes restarted after dying mid-batch (each dead "
    "worker's in-flight batches are re-dispatched exactly once)",
)

# --- closed-loop autotuner (parallel/autotune.py) ---------------------------

AUTOTUNE_DECISIONS = REGISTRY.counter(
    "sd_autotune_decisions_total",
    "autotuner knob adjustments, by workload and direction",
    labels=("workload", "action"),  # identify|thumbnail × promote|demote
)
AUTOTUNE_WINDOW_SCALE = REGISTRY.gauge(
    "sd_autotune_window_scale",
    "current multiplier on the static host window / chunk rows",
    labels=("workload",),
)
AUTOTUNE_RUNG = REGISTRY.gauge(
    "sd_autotune_batch_rung",
    "current per-device dispatch rung index into the batch ladder "
    "(0 = smallest, never above the DeviceLadder demotion cap)",
    labels=("workload",),
)
AUTOTUNE_DEPTH_EXTRA = REGISTRY.gauge(
    "sd_autotune_depth_extra",
    "additive adjustment the autotuner applies to the feeder depth",
    labels=("workload",),
)
AUTOTUNE_POOL_SCALE = REGISTRY.gauge(
    "sd_autotune_pool_scale",
    "current multiplier on the static procpool batch quantum (the "
    "Controller grows it when the per-batch dispatch share says the "
    "IPC tax dominates, shrinks it on long roundtrips or underfilled "
    "batches)",
    labels=("workload",),
)

# --- event loop health (telemetry/events.py LoopLagMonitor) -----------------

EVENT_LOOP_LAG = REGISTRY.gauge(
    "sd_event_loop_lag_seconds",
    "latest sampled event-loop scheduling lag",
)

# --- flight recorder (telemetry/events.py) ---------------------------------

RING_DROPPED = REGISTRY.counter(
    "sd_ring_dropped_total",
    "flight-recorder events silently displaced by ring overflow (the "
    "bounded deque dropped its oldest entry to admit a new one) — a "
    "nonzero count means the debug bundle's rings are a suffix, not "
    "the whole story",
    labels=("ring",),
)
