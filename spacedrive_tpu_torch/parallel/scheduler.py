"""The execution continuum's stage registry: one scheduler vocabulary
for the task system's threads, the process pool's stage functions and
the mesh WORK shard plane.

Counterpart of `spacedrive_tpu/parallel/scheduler.py`. Every
distributable unit of pipeline work is a **stage** with a stable id; a
`p2p.work.WorkShard` carries its stage id, so any executor (the
coordinator's self-steal or a remote peer) routes the shard to its leg
in ``location/indexer/stages.py``. The registry also keeps the
**per-stage throughput EWMAs**: executors report ``(files, seconds)``
per shard, the autotune `Controller` folds the rates into per-stage
lease targets each tick (`Controller._tick_stages`), and the WORK board
sizes a lease per stage from the claimer's reported rates, with the
Controller's targets as the fallback.

``RATES`` is process-wide, like the telemetry registry;
``telemetry.reset()`` clears it with every metric series.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any

#: stage ids: the bounded vocabulary of every `stage` metric label and
#: wire shard
STAGE_IDENTIFY = "identify.hash"
STAGE_THUMB = "thumb"
STAGE_MEDIA = "media.extract"
STAGE_PHASH = "phash"
STAGE_EMBED = "embed"

#: EWMA blend for per-stage throughput
EWMA_KEEP = 0.7


@dataclass(frozen=True)
class StageSpec:
    """One distributable pipeline stage.

    ``workload`` names the autotune `PipelinePolicy` whose quanta size
    the stage's legs; ``pool_stage`` is the process-pool stage function
    that is its CPU-bound middle (None: the stage runs inline on the
    executor); ``journal_field`` is the index-journal vouch the executor
    consults before touching a byte."""

    id: str
    workload: str
    pool_stage: str | None
    journal_field: str


#: the stage registry; insertion order is the grant tie-break order
STAGES: dict[str, StageSpec] = {
    STAGE_IDENTIFY: StageSpec(
        STAGE_IDENTIFY, "identify", "identify.hash_entries", "cas_id"),
    STAGE_THUMB: StageSpec(STAGE_THUMB, "thumbnail", "thumb.cpu", "thumb"),
    STAGE_MEDIA: StageSpec(STAGE_MEDIA, "identify", None, "media_digest"),
    STAGE_PHASH: StageSpec(STAGE_PHASH, "thumbnail", "phash.gray", "phash"),
    STAGE_EMBED: StageSpec(STAGE_EMBED, "embed", "embed.decode", "embed"),
}


def spec(stage_id: str) -> StageSpec:
    """The registry entry of a stage id; an unknown stage raises (a
    typo'd wire shard must not execute as the wrong stage)."""
    return STAGES[stage_id]


def stage_label(stage_id: Any) -> str:
    """The bounded `stage` metric label: the registry's ids, ``other``
    for anything else."""
    return stage_id if stage_id in STAGES else "other"


def pool_for(stage_id: str) -> Any:
    """The running process pool for a stage's CPU leg: None when the
    pool is down, SD_PROCS=0, or the stage has no pool leg."""
    if STAGES[stage_id].pool_stage is None:
        return None
    from . import procpool as _procpool

    return _procpool.get()


# --- per-stage throughput EWMAs (the control loop's input) -----------------


class StageRates:
    """Process-wide per-stage files/s EWMAs. Executors call
    :meth:`observe` once per executed shard (any stage, any origin); the
    Controller reads :meth:`rate` each tick. Thread-safe: shard legs run
    in worker threads while the Controller ticks on the event loop."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ewma: dict[str, float] = {}
        self._observed: dict[str, int] = {}

    def observe(self, stage_id: str, files: int, seconds: float) -> None:
        if files <= 0 or seconds <= 0:
            return
        rate = files / seconds
        with self._lock:
            prev = self._ewma.get(stage_id, 0.0)
            self._ewma[stage_id] = (
                rate if prev == 0.0
                else EWMA_KEEP * prev + (1.0 - EWMA_KEEP) * rate
            )
            self._observed[stage_id] = self._observed.get(stage_id, 0) + files
            value = self._ewma[stage_id]
        from ..telemetry import metrics as _tm

        _tm.WORK_STAGE_RATE.set(value, stage=stage_label(stage_id))

    def rate(self, stage_id: str) -> float:
        """Observed files/s EWMA for a stage: 0.0 until the stage has
        executed anything in this process."""
        with self._lock:
            return self._ewma.get(stage_id, 0.0)

    def snapshot(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            return {
                s: {
                    "files_per_s": round(self._ewma[s], 3),
                    "files_observed": self._observed.get(s, 0),
                }
                for s in self._ewma
            }

    def reset(self) -> None:
        with self._lock:
            self._ewma.clear()
            self._observed.clear()


#: the process-wide rate table (telemetry.reset() clears it)
RATES = StageRates()


def observed_files_per_s(stage_id: str) -> float:
    """Best throughput estimate for a stage: the shard-measured EWMA,
    else the telemetry-derived workload rate (identify only), else
    0.0."""
    rate = RATES.rate(stage_id)
    if rate > 0:
        return rate
    if stage_id == STAGE_IDENTIFY:
        from . import autotune as _autotune

        return _autotune.observed_files_per_s("identify") or 0.0
    return 0.0


def lease_seconds_for(stage_id: str, n_files: int, rate: float,
                      lease_max_s: float) -> float:
    """Per-stage lease sizing, the WORK board's one seam. ``rate`` is
    the claimer's reported files/s for this stage; with none, the
    Controller's per-stage target rate stands in, and before any
    evidence the static default holds."""
    from ..p2p import work as _work

    if rate <= 0:
        from . import autotune as _autotune

        rate = _autotune.CONTROLLER.stage_rate(stage_id)
    if rate <= 0:
        rate = _work.DEFAULT_FILES_PER_S
    lease = max(_work.LEASE_MIN_S, n_files / rate * _work.LEASE_SLACK)
    return min(lease, lease_max_s)


def snapshot() -> dict[str, Any]:
    """The continuum's state for ``/mesh`` (rides autotune.snapshot):
    per-stage rates and the registry vocabulary."""
    return {
        "stages": list(STAGES),
        "rates": RATES.snapshot(),
    }


def reset() -> None:
    """Test isolation: clears the per-stage EWMAs and the Controller's
    derived per-stage lease targets (``telemetry.reset()`` calls this)."""
    RATES.reset()
    from . import autotune as _autotune

    _autotune.CONTROLLER.reset_stage_targets()


__all__ = [
    "RATES",
    "STAGES",
    "STAGE_EMBED",
    "STAGE_IDENTIFY",
    "STAGE_MEDIA",
    "STAGE_PHASH",
    "STAGE_THUMB",
    "StageRates",
    "StageSpec",
    "lease_seconds_for",
    "observed_files_per_s",
    "pool_for",
    "reset",
    "snapshot",
    "spec",
    "stage_label",
]
