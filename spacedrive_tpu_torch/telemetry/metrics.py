"""Metric families of the port's device seam and fault plane.

The subset of `spacedrive_tpu/telemetry/metrics.py` that the port
writes so far, with the JAX package's names, help, labels and buckets,
so a scrape of either package reads the same series. The rest of the
catalog comes with the telemetry plane.
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

# --- flight recorder (telemetry/events.py) ---------------------------------

RING_DROPPED = REGISTRY.counter(
    "sd_ring_dropped_total",
    "flight-recorder events silently displaced by ring overflow (the "
    "bounded deque dropped its oldest entry to admit a new one) — a "
    "nonzero count means the debug bundle's rings are a suffix, not "
    "the whole story",
    labels=("ring",),
)
