"""Metric families: one definition site.

An owned copy of `spacedrive_tpu/telemetry/metrics.py`, whole: every
family with the JAX package's name, help, labels and buckets, so a
scrape of either package reads the same series and `render()` of a
fresh registry is the same text. Families of planes the port does not
run yet (serve, p2p, sync ingest, tenants, ...) render at zero.

Naming follows Prometheus conventions with an ``sd_`` prefix:
``_total`` counters, ``_seconds`` histograms, base-unit gauges. Label
cardinality stays deliberately tiny (stage/result/job names) — see
registry.MAX_SERIES_PER_FAMILY for the backstop.

Hot paths import these handles directly (module attribute access, no
lookup or allocation per event). This module imports no torch:
process-pool workers import it to ship their telemetry deltas.
"""

from __future__ import annotations

from .registry import (
    BYTE_BUCKETS,
    RATIO_BUCKETS,
    REGISTRY,
    TIME_BUCKETS,
)

# --- task system (tasks/system.py) -----------------------------------------

TASK_QUEUE_WAIT = REGISTRY.histogram(
    "sd_task_queue_wait_seconds",
    "time a task spent queued on a worker before execution started",
)
TASK_DISPATCH_LATENCY = REGISTRY.histogram(
    "sd_task_dispatch_latency_seconds",
    "dispatch() call to first execution start, per task",
)
TASK_BATCH_OCCUPANCY = REGISTRY.histogram(
    "sd_task_batch_occupancy",
    "fraction of workers busy when a task starts executing",
    buckets=RATIO_BUCKETS,
)
TASK_STEALS = REGISTRY.counter(
    "sd_task_steals_total",
    "tasks stolen between local task-system workers (the in-process "
    "mirror of the mesh plane's sd_work_steals_total)",
)
TASKS_DISPATCHED = REGISTRY.counter(
    "sd_tasks_dispatched_total", "tasks handed to the task system",
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

# --- file identifier (object/file_identifier/job.py) ------------------------

IDENTIFIER_FILES = REGISTRY.counter(
    "sd_identifier_files_total",
    "file_paths pushed through cas_id identification",
)
IDENTIFIER_BATCH_FILL = REGISTRY.histogram(
    "sd_identifier_batch_fill_ratio",
    "rows in an identify window relative to the configured chunk size",
    buckets=RATIO_BUCKETS,
)
IDENTIFIER_STAGE_SECONDS = REGISTRY.histogram(
    "sd_identifier_stage_seconds",
    "per-window time split between device hash and DB linking",
    labels=("stage",),  # hash | db
)

# --- thumbnailer (object/media/thumbnail/actor.py) --------------------------

THUMB_FILES = REGISTRY.counter(
    "sd_thumbnailer_files_total",
    "thumbnail outcomes",
    labels=("result",),  # generated | skipped | error
)
THUMB_BATCH_FILL = REGISTRY.histogram(
    "sd_thumbnail_batch_fill_ratio",
    "images in a device chunk relative to the device-count-scaled "
    "chunk size (DEVICE_BATCH × accelerator_count)",
    buckets=RATIO_BUCKETS,
)
THUMB_STAGE_SECONDS = REGISTRY.histogram(
    "sd_thumbnail_stage_seconds",
    "per-chunk time split across the pipelined stages: host decode, "
    "device resize, host webp encode+store",
    labels=("stage",),  # decode | device | encode
)

# --- semantic search (models/embedder.py, object/search/index.py) -----------

EMBED_FILES = REGISTRY.counter(
    "sd_embed_files_total",
    "media-pipeline embedding outcomes per file: embedded (vector "
    "computed and persisted), skipped (journal vouched — unchanged "
    "bytes), error (undecodable image)",
    labels=("result",),  # embedded | skipped | error
)
EMBED_STAGE_SECONDS = REGISTRY.histogram(
    "sd_embed_stage_seconds",
    "per-chunk time split across the embedding stages: host/pool "
    "decode, device forward, DB+sync write",
    labels=("stage",),  # decode | forward | write
)
SEARCH_QUERIES = REGISTRY.counter(
    "sd_search_queries_total",
    "semantic search queries by scoring path (device = jitted matmul "
    "top-k, host = numpy fallback after a device failure)",
    labels=("path",),  # device | host
)
SEARCH_QUERY_SECONDS = REGISTRY.histogram(
    "sd_search_query_seconds",
    "end-to-end semantic query latency: probe embed + index scoring "
    "+ row hydration",
)
SEARCH_INDEX_VECTORS = REGISTRY.gauge(
    "sd_search_index_vectors",
    "vectors in the most recently refreshed per-library search index",
)

# --- udp stream (p2p/udpstream.py) ------------------------------------------

UDP_RETRANSMITS = REGISTRY.counter(
    "sd_udp_retransmits_total",
    "segments re-sent (fast retransmit + RTO bursts)",
)
UDP_RWND_STALLS = REGISTRY.counter(
    "sd_udp_rwnd_stalls_total",
    "zero-window stalls that armed the persist-probe timer",
)
UDP_BAD_ACKS = REGISTRY.counter(
    "sd_udp_bad_acks_total",
    "ACKs ignored because they acknowledged beyond the flight",
)
UDP_ACK_RTT = REGISTRY.histogram(
    "sd_udp_ack_rtt_seconds",
    "clean (Karn-filtered) ACK round-trip samples",
)

# --- jobs (jobs/job.py + jobs/manager.py) -----------------------------------

JOB_PHASE_SECONDS = REGISTRY.histogram(
    "sd_job_phase_seconds",
    "wall time per job phase (phase transitions via ctx.progress)",
    labels=("job", "phase"),
)

# --- bench (bench.py) -------------------------------------------------------

BENCH_LINK_PROBE_GBPS = REGISTRY.gauge(
    "sd_bench_link_probe_gbps",
    "latest host→device link probe (device_put bandwidth)",
)
# bench reads its median/spread back out of these rings, so they must
# hold every sample of the largest plausible SD_BENCH_REPEATS run —
# the default 128-sample ring would silently truncate repeats > 128
BENCH_DEVICE_BATCH_SECONDS = REGISTRY.histogram(
    "sd_bench_device_batch_seconds",
    "marginal device compute per chained batch (bench.py)",
    recent_samples=4096,
)
BENCH_E2E_BATCH_SECONDS = REGISTRY.histogram(
    "sd_bench_e2e_batch_seconds",
    "end-to-end host→device→digest time per batch (bench.py)",
    recent_samples=4096,
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

# --- index journal (location/indexer/journal.py) ----------------------------

INDEX_JOURNAL_OPS = REGISTRY.counter(
    "sd_index_journal_ops_total",
    "index-journal consults by verdict: hit (identity matches, cached "
    "result reused), miss (no usable entry), invalidated (entry present "
    "but stale/identity changed), bypassed (journal disabled or entry "
    "corrupt — degraded to a cold pass)",
    labels=("result",),  # hit | miss | invalidated | bypassed
)
INDEX_JOURNAL_BYTES_SAVED = REGISTRY.counter(
    "sd_index_journal_bytes_saved_total",
    "bytes NOT read/hashed/shipped because the journal vouched for them "
    "(journal hits plus clean chunks of dirty-range rehashes)",
)
INDEX_BYTES_HASHED = REGISTRY.counter(
    "sd_index_bytes_hashed_total",
    "message bytes actually hashed by the identifier (device batches "
    "plus dirty chunks of host dirty-range rehashes)",
)

# --- pipeline device/host split (identify + thumbnail pipelines) ------------

PIPELINE_DEVICE_SECONDS = REGISTRY.histogram(
    "sd_pipeline_device_seconds",
    "per-batch device time (hash materialization / device resize)",
    labels=("pipeline",),  # identify | thumbnail
)
PIPELINE_HOST_SECONDS = REGISTRY.histogram(
    "sd_pipeline_host_seconds",
    "per-batch host time (window wait + DB linking / image decode)",
    labels=("pipeline",),  # identify | thumbnail
)

# --- sync / replication (sync/ingest.py + sync/manager.py) ------------------
# Per-peer series label by telemetry.peers.peer_label (capped stable
# short-hash of the instance pub_id) — NEVER the raw identifier
# (sdlint SD010).

SYNC_OPS = REGISTRY.counter(
    "sd_sync_ops_total",
    "CRDT ops ingested from remote instances, by outcome",
    labels=("result",),  # applied | stale | tombstone
)
SYNC_LAG = REGISTRY.gauge(
    "sd_sync_lag_seconds",
    "replication lag per remote instance: wall-clock now minus the "
    "latest applied HLC timestamp from that peer",
    labels=("peer",),
)
SYNC_WATERMARK = REGISTRY.gauge(
    "sd_sync_watermark_seconds",
    "latest applied HLC timestamp per remote instance (unix seconds)",
    labels=("peer",),
)
HLC_DELTA_GUARD = REGISTRY.counter(
    "sd_hlc_delta_guard_total",
    "remote ops rejected because their HLC timestamp exceeded the "
    "delta guard (clock too far in the future)",
)
HLC_CLOCK_SKEW = REGISTRY.gauge(
    "sd_hlc_clock_skew_seconds",
    "last observed remote-op HLC timestamp minus local wall clock, "
    "per remote instance (positive = remote clock ahead)",
    labels=("peer",),
)
SYNC_INGEST_BACKLOG = REGISTRY.gauge(
    "sd_sync_ingest_backlog",
    "ops fetched by the ingest actor and not yet applied (current batch)",
)

# --- telemetry federation (telemetry/federation.py + p2p) -------------------

FED_PULLS = REGISTRY.counter(
    "sd_federation_pulls_total",
    "peer telemetry-snapshot pulls by outcome and transport",
    labels=("result",),  # p2p | relay | error
)
FED_SNAPSHOT_AGE = REGISTRY.gauge(
    "sd_federation_snapshot_age_seconds",
    "age of the freshest cached snapshot per peer",
    labels=("peer",),
)
FED_PEERS = REGISTRY.gauge(
    "sd_federation_peers",
    "peers currently tracked by the federation cache, by freshness",
    labels=("state",),  # fresh | stale
)

# --- mesh work-stealing (p2p/work.py + location/indexer/mesh.py) ------------

WORK_SHARDS = REGISTRY.counter(
    "sd_work_shards_total",
    "distributed work shards by outcome: published (added to a "
    "session), completed_local / completed_remote (first completion, by "
    "executor side), duplicate (a re-stolen or raced shard completed "
    "again — idempotent merge absorbed it), expired (lease deadline "
    "passed; shard returned to the steal pool), refused (claim denied "
    "by health verdict or breaker). `stage` is the shard's pipeline "
    "stage from the scheduler registry ('any' when the outcome has no "
    "shard context, e.g. a refused claim)",
    labels=("result", "stage"),
)
WORK_STEALS = REGISTRY.counter(
    "sd_work_steals_total",
    "shards leased to remote peers (one increment per shard per grant), "
    "labeled by the claiming peer's short-hash and the shard's stage",
    labels=("peer", "stage"),
)
WORK_LEASE_SECONDS = REGISTRY.histogram(
    "sd_work_lease_seconds",
    "lease durations granted to shard claims (sized per stage from the "
    "claimer's self-reported throughput, the Controller's per-stage "
    "target, or the static default — in that order)",
    labels=("stage",),
    buckets=(1, 5, 10, 30, 60, 120, 300),
)
WORK_STAGE_RATE = REGISTRY.gauge(
    "sd_work_stage_rate_files_per_s",
    "per-stage shard throughput EWMA observed by this node's executors "
    "(the execution continuum's lease-sizing input; see "
    "parallel/scheduler.py)",
    labels=("stage",),
)
WORK_STAGE_LEASE_TARGET = REGISTRY.gauge(
    "sd_work_stage_lease_target_seconds",
    "the Controller's per-stage lease target: the lease a default-sized "
    "shard would get at the stage's observed rate (0 until the stage "
    "has run; the WORK board's fallback when a claimer reports no rate)",
    labels=("stage",),
)

# --- resilience + fault plane (utils/resilience.py + utils/faults.py) -------
# Per-target breaker detail stays on the `resilience` flight ring
# (bounded; values may carry peer_label short-hashes) — the metric
# families here are deliberately label-free so the series space stays
# O(1) no matter how many peers/relays a node talks to.

FAULTS_INJECTED = REGISTRY.counter(
    "sd_faults_injected_total",
    "fault-plane activations (chaos testing only; 0 in production)",
)
RESILIENCE_RETRIES = REGISTRY.counter(
    "sd_resilience_retries_total",
    "backoff sleeps taken by resilience-policy retry ladders",
)
BREAKER_TRANSITIONS = REGISTRY.counter(
    "sd_breaker_transitions_total",
    "circuit-breaker state transitions, by state entered",
    labels=("state",),  # open | half_open | closed
)
BREAKER_OPEN = REGISTRY.gauge(
    "sd_breaker_open",
    "circuit breakers currently open across all policies/targets",
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

# --- serve layer: admission gate + read cache ------------------------------

GATE_REQUESTS = REGISTRY.counter(
    "sd_gate_requests_total",
    "admission-gate outcomes per priority class: admitted (ran), "
    "queued (parked for a slot before running), shed (fast-failed "
    "429/SHED)",
    labels=("klass", "outcome"),  # control|sync|interactive|background
)
GATE_INFLIGHT = REGISTRY.gauge(
    "sd_gate_inflight",
    "requests currently holding an admission slot, per priority class",
    labels=("klass",),
)
GATE_QUEUE_SECONDS = REGISTRY.histogram(
    "sd_gate_queue_seconds",
    "time a request spent parked waiting for an admission slot",
    labels=("klass",),
)
GATE_MODE = REGISTRY.gauge(
    "sd_gate_mode",
    "serve-gate mode: 0 = normal, 1 = brownout (degraded serving — "
    "stale cache answers allowed, background sheds immediately)",
)
SERVE_CACHE_OPS = REGISTRY.counter(
    "sd_serve_cache_ops_total",
    "read-path cache outcomes per region: hit, miss (loaded), stale "
    "(brownout stale-while-revalidate answer), coalesced (rode another "
    "caller's in-flight load), bypass",
    labels=("cache", "result"),  # query|thumb|meta
)
SERVE_CACHE_ENTRIES = REGISTRY.gauge(
    "sd_serve_cache_entries",
    "live entries per cache region",
    labels=("cache",),
)
SERVE_CACHE_INVALIDATIONS = REGISTRY.counter(
    "sd_serve_cache_invalidations_total",
    "cache entries dropped by the invalidation plane, by trigger: "
    "local (mutation via invalidate_query) or sync (remote ops applied "
    "by the ingest actor)",
    labels=("source",),  # local | sync
)
SYNC_TXN_COMBINED = REGISTRY.counter(
    "sd_sync_txn_combined_total",
    "per-op SQLite transactions avoided by write-combined sync ingest "
    "(ops coalesced into a shared transaction, minus the one "
    "transaction that carried them)",
)

# --- flight-recorder drop accounting (telemetry/events.py) ------------------

RING_DROPPED = REGISTRY.counter(
    "sd_ring_dropped_total",
    "flight-recorder events silently displaced by ring overflow (the "
    "bounded deque dropped its oldest entry to admit a new one) — a "
    "nonzero count means the debug bundle's rings are a suffix, not "
    "the whole story",
    labels=("ring",),
)

# --- critical-path attribution (telemetry/attrib.py) ------------------------

ATTRIB_REPORTS = REGISTRY.counter(
    "sd_attrib_reports_total",
    "critical-path attribution reports computed (GET /attrib, rspc "
    "telemetry.attrib, sdx attrib, bench_e2e summaries)",
)
ATTRIB_BUCKET_SECONDS = REGISTRY.gauge(
    "sd_attrib_bucket_seconds",
    "wall-clock seconds per attribution bucket of the most recent "
    "report: device / host_cpu / link / queue_wait / gap (the "
    "unattributed-gap bucket is the GIL signature)",
    labels=("bucket",),
)
ATTRIB_PULL_FAILURES = REGISTRY.counter(
    "sd_attrib_pull_failures_total",
    "remote trace_pull exchanges that failed during distributed trace "
    "assembly (the report degrades to partial, never blocks)",
)

# --- telemetry history + SLO engine (telemetry/history.py, telemetry/slo.py)

HISTORY_SAMPLES = REGISTRY.counter(
    "sd_history_samples_total",
    "samples appended to the persistent telemetry history segment store",
)
SLO_EVALUATIONS = REGISTRY.counter(
    "sd_slo_evaluations_total",
    "SLO registry evaluations (health reads, federation snapshots, "
    "sdx slo)",
)
SLO_STATUS = REGISTRY.gauge(
    "sd_slo_status",
    "latest per-SLO verdict: 0 = ok/no-data, 1 = warn (fast-window "
    "burn), 2 = breach (fast AND slow windows burning)",
    labels=("slo",),
)

# --- serve request latency (api/server.py admission middleware) -------------

SERVE_REQUEST_SECONDS = REGISTRY.histogram(
    "sd_serve_request_seconds",
    "admitted HTTP request wall time per priority class (handler run "
    "under its admission slot) — the interactive series is the "
    "interactive_p99 SLO input",
    labels=("klass",),
)

# --- continuous host profiler (telemetry/sampler.py) ------------------------
# Deliberately label-free: the per-kind / per-state / per-group splits
# live in the profile document and federation summary, not the series
# space — the sampler must stay O(1) registry cost at any stack shape.

PROFILE_SAMPLES = REGISTRY.counter(
    "sd_profile_samples_total",
    "thread-stack samples folded into the continuous host profiler's "
    "collapsed-stack accumulator (one per live thread per tick; the "
    "sampler's own thread is exempt from its own accounting)",
)
PROFILE_CAPTURES = REGISTRY.counter(
    "sd_profile_captures_total",
    "triggered deep-capture windows opened (SLO warn/breach, loop-lag "
    "degradation, brownout entry, manual) — hysteresis guarantees at "
    "most one per cooldown, so a flapping signal cannot storm this",
)
PROFILE_STACKS = REGISTRY.gauge(
    "sd_profile_stacks",
    "distinct collapsed stacks currently tracked by the profiler's "
    "bounded accumulator (cap: 4096; overflow folds into a drop count "
    "reported by the profile document)",
)
PROFILE_OVERHEAD = REGISTRY.gauge(
    "sd_profile_overhead_ratio",
    "the profiler's self-measured duty cycle: cumulative sampling CPU "
    "time over wall time since start — the ≤5% overhead contract's "
    "always-on witness",
)

# --- resource-growth sampler (telemetry/resources.py) -----------------------
# Process-level growth surfaces sampled at low rate; the history store
# turns these gauges into resource_* series and the trend SLO class
# judges their slopes (leaks show up as gated regressions, not OOMs).

RESOURCE_RSS = REGISTRY.gauge(
    "sd_resource_rss_bytes",
    "resident set size of this process from /proc/self/status (VmRSS); "
    "the rss_growth trend SLO bounds its slope in MB/h after warmup",
)
RESOURCE_FDS = REGISTRY.gauge(
    "sd_resource_fds",
    "open file descriptors in this process (/proc/self/fd count); the "
    "fd_growth trend SLO expects this flat at steady state",
)
RESOURCE_THREADS = REGISTRY.gauge(
    "sd_resource_threads",
    "OS threads in this process (/proc/self/status Threads:)",
)
RESOURCE_PROCPOOL_RSS = REGISTRY.gauge(
    "sd_resource_procpool_rss_bytes",
    "summed resident set size of live procpool workers "
    "(/proc/<pid>/statm over the multi-process plane; 0 with SD_PROCS=0)",
)
RESOURCE_INVENTORY = REGISTRY.gauge(
    "sd_resource_inventory",
    "in-process inventory sizes over a fixed kind vocabulary: "
    "journal_rows, oplog_rows (summed over open libraries), "
    "serve_cache_entries, serve_cache_bytes, history_bytes, ring_drops "
    "— journal/oplog rows should track corpus size, not pass count",
    labels=("kind",),
)

# --- event loop health (telemetry/events.py LoopLagMonitor) -----------------

EVENT_LOOP_LAG = REGISTRY.gauge(
    "sd_event_loop_lag_seconds",
    "latest sampled event-loop scheduling lag",
)

# --- spans (telemetry/spans.py) ---------------------------------------------

SPAN_SECONDS = REGISTRY.histogram(
    "sd_span_seconds",
    "pipeline span wall time by stage",
    labels=("stage",),
)
SPAN_BYTES = REGISTRY.counter(
    "sd_span_bytes_total",
    "bytes attributed to pipeline spans by stage",
    labels=("stage",),
)

# --- per-tenant accounting (telemetry/tenants.py) ---------------------------

TENANT_OPS = REGISTRY.counter(
    "sd_tenant_ops_total",
    "per-tenant observations by surface (serve, cache_hit/miss, "
    "relay_push/pull, p2p_sync/work/telemetry, ingest, bytes_in/out — "
    "byte surfaces weight by payload size); tenant labels are blake2b "
    "tenant_label hashes for sketch residents, with every non-resident "
    "folded into the aggregated `other` bucket so a million-library "
    "relay stays inside the series cap",
    labels=("surface", "tenant"),
)
TENANT_SECONDS = REGISTRY.histogram(
    "sd_tenant_request_seconds",
    "request latency for sketch-resident tenants (serve surface), "
    "`other` aggregates the non-resident tail",
    labels=("surface", "tenant"),
)
TENANT_FAIRNESS = REGISTRY.gauge(
    "sd_tenant_fairness_index",
    "Jain's fairness index over resident tenant counts per surface: "
    "1.0 = equal shares, -> 1/n under a single dominant tenant; "
    "feeds the tenant_fairness SLO via the history series",
    labels=("surface",),
)
TENANT_DOMINANT = REGISTRY.gauge(
    "sd_tenant_dominant_share",
    "largest resident tenant's share of the surface total",
    labels=("surface",),
)
TENANT_RESIDENTS = REGISTRY.gauge(
    "sd_tenant_sketch_residents",
    "tenants currently resident in the surface's space-saving sketch "
    "(bounded by SD_TENANT_TOPK)",
    labels=("surface",),
)
