"""Closed-loop autotuner: telemetry-driven batch, rung and depth control.

Counterpart of `spacedrive_tpu/parallel/autotune.py`, with every
constant and decision rule unchanged. Two pieces:

- :class:`PipelinePolicy`: the one home of the pipeline sizes, one
  policy per workload (``identify`` / ``thumbnail`` / ``embed``). Every
  consumer reads its size through :func:`policy`: the cas dispatch rung
  (`ops/cas.cas_ids_begin`), the identifier's host window and feeder
  depth (`object/file_identifier/job.py`, `index_pass.py`), the
  thumbnailer's and the embed step's chunk rows, the process pool's
  batch quantum (read by the embed decode leg, which splits a chunk
  into jobs of at most that many files; the JAX package's
  ``SD_PROCS_BATCH`` pin is not ported).
- :class:`Controller`: on an interval it samples the registry (feeder
  wait and fetch deltas, H2D bytes, dispatch occupancy, the event-loop
  lag, a bench rig's link probe, the process pool's per-batch deltas,
  the `DeviceLadder` level) and nudges each policy with damped steps: a
  knob moves only after ``STEP_STREAK`` consecutive ticks agree on the
  direction, so alternating signals hold instead of thrashing.
  Decisions land on the ``autotune`` ring and the ``sd_autotune_*``
  series.

The rules: a **starved** consumer (mean feeder wait per take past
``STARVED_WAIT_S``) widens the identify window ×2 and deepens the
feeder +1 (at once past ``URGENT_WAIT_S``); an **overbuffered** one
decays both toward static; a **congested** link probe demotes the
dispatch rung and sheds extra depth; **full** batches promote the rung,
**low occupancy** demotes it; **event-loop lag** past
``health.LOOP_LAG_DEGRADED`` sheds depth; the pool quantum grows on IPC tax
and shrinks on slow or underfilled batches. The rung never exceeds what
the `DeviceLadder` level allows (`_ladder_rung_cap`): full set → top
rung, subset → middle, host → bottom.

The stage plane folds `parallel/scheduler`'s per-stage files/s EWMAs
into per-stage lease targets each tick (`_tick_stages`): the WORK
board's lease fallback when a claimer reports no rate for a stage
(`stage_rate`), carried on the snapshot's ``stages``.
:func:`observed_files_per_s` (the history's ``files_per_s`` series)
reads only the identifier's registry series.

``SD_AUTOTUNE=0`` starts no controller and makes every policy read
return the static size, bit for bit. ``SD_AUTOTUNE_INTERVAL_S`` sets
the tick interval (default 1.0 s).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any

#: per-device cas dispatch pad rungs: a 5-file tail pads to 32 rows,
#: not 1024 (ops/cas.pack_canonical_batch packs against them)
BATCH_LADDER = (32, 256, 1024)

#: identifier host-window rows per device: one window is one hot-bucket
#: dispatch of the top ladder rung
IDENTIFY_DEVICE_WINDOW = BATCH_LADDER[-1]

#: identifier rows per window on the CPU backend: the reference's
#: parity chunk (ref:core/src/object/file_identifier/mod.rs:34)
IDENTIFY_CPU_WINDOW = 100

#: thumbnail images per device resize call
THUMB_DEVICE_BATCH = 32

#: embedding images per device forward
EMBED_DEVICE_BATCH = 32

#: feeder read-ahead: base depth of a single-device pass and hard cap
#: (parallel/feeder.pipeline_depth derives the device scaling)
FEEDER_BASE_DEPTH = 3
FEEDER_DEPTH_CAP = 8

#: rows per process-pool batch (parallel/procpool.py): one round
#: trip's serialize+frame tax amortized over this many entries
PROCPOOL_BATCH_ROWS = 32

#: window-scale bounds: the static base is the floor; ≥8× static stops
#: amortizing anything real and only adds latency and host memory
SCALE_MIN = 1.0
SCALE_MAX = 8.0

#: link probe below this is a congested tunnel
CONGESTED_GBPS = 0.5
#: mean consumer wait per take that counts as starved (a warm handoff
#: is <2 ms; 50 ms of blocking per window means the producer lost)
STARVED_WAIT_S = 0.05
#: an extreme wait widens at once: damping would burn more half-second
#: windows collecting confirmations
URGENT_WAIT_S = 0.5
#: mean wait under which the pipeline is comfortably ahead
OVERBUFFERED_WAIT_S = 0.002
#: dispatch-occupancy bands for rung control
OCC_LOW = 0.5
OCC_HIGH = 0.9

#: damping: a knob steps only after this many consecutive ticks agree
#: on the direction; ticks with no new samples hold the streak
STEP_STREAK = 2

#: pool-quantum bands: dispatch eating this share of the roundtrip is
#: IPC tax (widen); a roundtrip past POOL_RT_SLOW_S hurts latency
#: (shrink)
POOL_DISPATCH_SHARE = 0.15
POOL_RT_SLOW_S = 2.0
POOL_SCALE_MIN = 1.0
POOL_SCALE_MAX = 8.0

#: per-stage lease-target hysteresis: a stage's lease target is
#: republished only when it moved by at least 25%
STAGE_LEASE_HYSTERESIS = 0.25

WORKLOADS = ("identify", "thumbnail", "embed")


def enabled() -> bool:
    """SD_AUTOTUNE=0 → static sizes bit for bit (no controller, no
    policy deviation)."""
    return os.environ.get("SD_AUTOTUNE", "1") != "0"


def identify_window_rows(n_accel: int = 1) -> int:
    """Static identifier cursor-window rows on a device backend: the
    host window that becomes one feeder fetch."""
    return IDENTIFY_DEVICE_WINDOW * max(1, n_accel)


def thumb_chunk_rows(n_accel: int = 1) -> int:
    """Static thumbnailer images per device resize chunk."""
    return THUMB_DEVICE_BATCH * max(1, n_accel)


def embed_chunk_rows(n_accel: int = 1) -> int:
    """Static images per embed step of the media job."""
    return EMBED_DEVICE_BATCH * max(1, n_accel)


def _ladder_rung_cap() -> int:
    """Max rung index the DeviceLadder's level allows: the autotuner may
    never promote batches past the rung the resilience plane demoted
    to."""
    from . import mesh as _mesh

    return max(0, len(BATCH_LADDER) - 1 - int(_mesh.LADDER.level))


@dataclass
class PipelinePolicy:
    """Per-workload tuning state. The static defaults are the constants
    above; the controller nudges the knobs, consumers read the derived
    sizes through the methods below (the one seam)."""

    workload: str
    #: index into BATCH_LADDER: per-device rows per device dispatch
    rung: int = len(BATCH_LADDER) - 1
    #: multiplier on the static host window / chunk rows
    window_scale: float = 1.0
    #: additive adjustment to the feeder read-ahead depth
    depth_extra: int = 0
    #: multiplier on the static process-pool batch quantum
    pool_scale: float = 1.0

    def reset(self) -> None:
        self.rung = len(BATCH_LADDER) - 1
        self.window_scale = 1.0
        self.depth_extra = 0
        self.pool_scale = 1.0

    # ---- derived sizes (the seam every consumer reads) ---------------

    def dispatch_rows_per_device(self) -> int:
        """Per-device rows per cas dispatch (`cas_ids_begin`'s step is
        this × the slot count), clamped to the DeviceLadder's rung cap
        while autotuning."""
        if not enabled():
            return BATCH_LADDER[-1]
        return BATCH_LADDER[min(self.rung, _ladder_rung_cap())]

    def identify_window_rows(self, n_devices: int = 1) -> int:
        """Identifier cursor-window rows (device backends)."""
        base = identify_window_rows(n_devices)
        if not enabled():
            return base
        return max(BATCH_LADDER[0], int(base * self.window_scale))

    def thumb_chunk_rows(self, n_accel: int = 1) -> int:
        """Thumbnailer images per device chunk."""
        base = thumb_chunk_rows(n_accel)
        if not enabled():
            return base
        return max(1, int(base * self.window_scale))

    def embed_chunk_rows(self, n_accel: int = 1) -> int:
        """Embedding images per device chunk."""
        base = embed_chunk_rows(n_accel)
        if not enabled():
            return base
        return max(1, int(base * self.window_scale))

    def procpool_batch_rows(self) -> int:
        """Entries per process-pool job, sized by ``pool_scale``; the
        embed decode leg caps its jobs at it."""
        if not enabled():
            return PROCPOOL_BATCH_ROWS
        return max(8, int(PROCPOOL_BATCH_ROWS * self.pool_scale))

    def feeder_depth(self, n_devices: int = 1) -> int:
        """In-flight feeder windows (read live by WindowPipeline, so a
        mid-job adjustment takes effect on the next fetch)."""
        from .feeder import pipeline_depth

        base = pipeline_depth(max(1, n_devices), base=FEEDER_BASE_DEPTH, cap=FEEDER_DEPTH_CAP)
        if not enabled():
            return base
        return max(2, min(FEEDER_DEPTH_CAP, base + self.depth_extra))

    def snapshot(self) -> dict[str, Any]:
        return {
            "rung": self.rung,
            "rows_per_device": self.dispatch_rows_per_device(),
            "window_scale": round(self.window_scale, 3),
            "depth_extra": self.depth_extra,
            "pool_scale": round(self.pool_scale, 3),
            "pool_quantum": self.procpool_batch_rows(),
        }


@dataclass
class Sample:
    """One tick's telemetry deltas (cumulative reads diffed by the
    controller; tests hand-build one and feed it to tick())."""

    wait_mean_s: float | None = None   # mean feeder wait per take
    wait_n: int = 0
    fetch_s: float = 0.0               # producer fetch time this tick
    fetch_n: int = 0
    h2d_bytes: float = 0.0
    occ_mean: dict[str, float | None] = field(default_factory=dict)
    occ_n: dict[str, int] = field(default_factory=dict)
    link_gbps: float = 0.0             # latest probe; 0 = no probe
    loop_lag_s: float = 0.0
    demotion_level: int = 0
    # process-pool per-batch deltas this tick (owner-side series)
    pool_batches: int = 0
    pool_dispatch_s: float = 0.0
    pool_roundtrip_s: float = 0.0
    pool_rows: float = 0.0


#: which occupancy `op` label feeds each workload's rung control
_OCC_OP = {"identify": "blake3", "thumbnail": "thumbnail", "embed": "embed"}


class Controller:
    """Samples the registry on an interval and nudges the policies.

    ``tick()`` is synchronous and side-effect-complete, so tests drive
    it directly; ``start()``/``stop()`` run it on a supervised asyncio
    task (the Node's lifecycle), refcounted so two in-process nodes
    share one controller."""

    def __init__(self, interval: float | None = None):
        self.interval = interval if interval is not None else float(
            os.environ.get("SD_AUTOTUNE_INTERVAL_S", "1.0")
        )
        self.policies: dict[str, PipelinePolicy] = {w: PipelinePolicy(w) for w in WORKLOADS}
        self._lock = threading.Lock()
        self._prev: dict[str, Any] | None = None
        # (workload, knob) -> signed streak of same-direction wishes
        self._streaks: dict[tuple[str, str], int] = {}
        # the stage plane's outputs: per-stage observed rate (folded from
        # scheduler.RATES each tick) and the derived lease target
        self.stage_rates: dict[str, float] = {}
        self.stage_lease: dict[str, float] = {}
        self._task: Any = None
        self._tasks: set = set()
        self._stopped = False
        self._starts = 0
        self.ticks = 0

    # ---- lifecycle ----------------------------------------------------

    def start(self) -> None:
        import asyncio
        import logging

        from ..utils.tasks import supervise

        if not enabled():
            return
        self._starts += 1
        if self._task is not None and not self._task.done():
            # a never-done task on a closed loop (a node torn down
            # without shutdown) is dropped and the tick loop adopted
            # onto the current loop; one on an open loop ticks for all
            if not self._task.get_loop().is_closed():
                return
            self._task = None
        # surface the knob gauges at once: a quiet controller that never
        # steps is invisible otherwise
        for w, p in self.policies.items():
            self._export_gauges(w, p)
        self._stopped = False
        self._task = supervise(
            asyncio.get_running_loop().create_task(self._run()),
            self._tasks, logging.getLogger(__name__), "autotune controller",
        )

    async def stop(self) -> None:
        self._starts = max(0, self._starts - 1)
        if self._starts > 0:
            return  # another in-process node still depends on the loop
        self._stopped = True
        task = self._task
        self._task = None
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            except BaseException:  # noqa: BLE001 - cancellation cleanup
                pass

    async def _run(self) -> None:
        import asyncio
        import logging

        while not self._stopped:
            await asyncio.sleep(self.interval)
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - a bad tick must not kill the loop
                logging.getLogger(__name__).exception("autotune tick failed")

    def reset(self) -> None:
        with self._lock:
            for p in self.policies.values():
                p.reset()
            self._prev = None
            self._streaks.clear()
            self.ticks = 0
            self.stage_rates.clear()
            self.stage_lease.clear()
        for w, p in self.policies.items():
            self._export_gauges(w, p)

    def stage_rate(self, stage_id: str) -> float:
        """The per-stage rate output (files/s), 0.0 until the stage has
        executed shards here: the WORK board's lease fallback when a
        claimer reports no rate for a stage."""
        return self.stage_rates.get(stage_id, 0.0)

    def reset_stage_targets(self) -> None:
        """Clear the stage plane (``scheduler.reset()`` fans out here;
        ``telemetry.reset()`` zeroes the gauges themselves)."""
        self.stage_rates.clear()
        self.stage_lease.clear()

    # ---- sampling -----------------------------------------------------

    def _cumulative(self) -> dict[str, Any]:
        from ..telemetry import metrics as _tm
        from ..telemetry.snapshot import gauge_value

        return {
            "wait": _tm.FEEDER_WAIT_SECONDS.stats(),
            "fetch": _tm.FEEDER_FETCH_SECONDS.stats(),
            "h2d": _tm.FEEDER_H2D_BYTES.value(),
            "occ": {op: _tm.DEVICE_DISPATCH_OCCUPANCY.stats(op=op) for op in _OCC_OP.values()},
            "link": gauge_value("sd_bench_link_probe_gbps"),
            "lag": gauge_value("sd_event_loop_lag_seconds"),
            "pool_dispatch": _tm.PROCPOOL_DISPATCH_SECONDS.stats(),
            "pool_rt": _tm.PROCPOOL_ROUNDTRIP_SECONDS.stats(),
            "pool_rows": _tm.PROCPOOL_BATCH_ROWS.stats(),
        }

    def sample(self) -> Sample:
        """Diff the registry against the previous tick's cumulative
        snapshot. The first call primes the baseline and returns an
        empty sample (cold start ⇒ static defaults hold)."""
        from . import mesh as _mesh

        cur = self._cumulative()
        prev, self._prev = self._prev, cur
        s = Sample(link_gbps=cur["link"], loop_lag_s=cur["lag"],
                   demotion_level=int(_mesh.LADDER.level))
        if prev is None:
            return s
        dwait_n = int(cur["wait"]["count"] - prev["wait"]["count"])
        dwait_s = cur["wait"]["sum"] - prev["wait"]["sum"]
        if dwait_n > 0:
            s.wait_mean_s = dwait_s / dwait_n
            s.wait_n = dwait_n
        s.fetch_n = int(cur["fetch"]["count"] - prev["fetch"]["count"])
        s.fetch_s = cur["fetch"]["sum"] - prev["fetch"]["sum"]
        s.h2d_bytes = cur["h2d"] - prev["h2d"]
        for op in _OCC_OP.values():
            dn = int(cur["occ"][op]["count"] - prev["occ"][op]["count"])
            ds = cur["occ"][op]["sum"] - prev["occ"][op]["sum"]
            s.occ_n[op] = dn
            s.occ_mean[op] = (ds / dn) if dn > 0 else None
        s.pool_batches = int(cur["pool_rt"]["count"] - prev["pool_rt"]["count"])
        s.pool_dispatch_s = cur["pool_dispatch"]["sum"] - prev["pool_dispatch"]["sum"]
        s.pool_roundtrip_s = cur["pool_rt"]["sum"] - prev["pool_rt"]["sum"]
        s.pool_rows = cur["pool_rows"]["sum"] - prev["pool_rows"]["sum"]
        return s

    # ---- the control law ----------------------------------------------

    def tick(self, sample: Sample | None = None) -> list[dict[str, Any]]:
        """One sampling + adjustment pass; returns the decisions made
        (also recorded on the ``autotune`` ring and the metrics)."""
        if not enabled():
            return []
        with self._lock:
            if sample is None:
                sample = self.sample()
            self.ticks += 1
            decisions: list[dict[str, Any]] = []
            for workload, pol in self.policies.items():
                decisions.extend(self._tick_workload(workload, pol, sample))
            decisions.extend(self._tick_stages(sample))
        return decisions

    def _tick_stages(self, s: Sample) -> list[dict[str, Any]]:
        """Per-stage lease targets: the lease a default-sized shard needs
        at the stage's observed rate, clamped to the board's lease law,
        republished only past the hysteresis band."""
        from ..location.indexer.mesh import shard_files_default
        from ..p2p import work as _work
        from ..telemetry import metrics as _tm
        from ..telemetry.events import AUTOTUNE_EVENTS
        from . import scheduler as _scheduler

        out: list[dict[str, Any]] = []
        try:
            files = shard_files_default()
        except ValueError:  # a malformed SD_WORK_SHARD_FILES
            files = 128
        for stage_id in _scheduler.STAGES:
            rate = _scheduler.RATES.rate(stage_id)
            if rate <= 0:
                continue
            self.stage_rates[stage_id] = rate
            target = min(
                _work.LEASE_MAX_S,
                max(_work.LEASE_MIN_S, files / rate * _work.LEASE_SLACK),
            )
            old = self.stage_lease.get(stage_id)
            if old is not None and old > 0 \
                    and abs(target - old) <= STAGE_LEASE_HYSTERESIS * old:
                continue
            self.stage_lease[stage_id] = target
            AUTOTUNE_EVENTS.emit(
                "stage-lease",
                stage=stage_id,
                rate_files_per_s=round(rate, 3),
                old=None if old is None else round(old, 3),
                new=round(target, 3),
            )
            _tm.WORK_STAGE_LEASE_TARGET.set(
                target, stage=_scheduler.stage_label(stage_id))
            out.append({
                "knob": "stage_lease", "stage": stage_id,
                "from": old, "to": target,
                "rate_files_per_s": round(rate, 3),
            })
        return out

    def _tick_workload(self, workload: str, pol: PipelinePolicy, s: Sample) -> list[dict[str, Any]]:
        """Per-knob wishes are three-valued: ±1 asks for a damped step,
        0 is contrary or neutral evidence (resets the streak), None is no
        evidence (an idle tick holds the streak)."""
        out: list[dict[str, Any]] = []
        congested = 0 < s.link_gbps < CONGESTED_GBPS
        clear = s.link_gbps >= CONGESTED_GBPS
        lagging = self._loop_lagging(s)
        occ = s.occ_mean.get(_OCC_OP[workload])

        # --- window scale (host window / chunk rows); event-loop lag
        # deliberately does not shed it: a wider window means fewer
        # steps and DB commits per file ---
        want: int | None
        urgent = False
        reason = ""
        if congested:
            want = -1 if pol.window_scale > SCALE_MIN else 0
            reason = "congested"
        elif workload == "identify":
            if s.wait_mean_s is None:
                want = 0 if clear else None
            elif s.wait_mean_s >= STARVED_WAIT_S:
                want = +1  # amortize the per-window cost
                urgent = s.wait_mean_s >= URGENT_WAIT_S
                reason = "starved"
            elif s.wait_mean_s <= OVERBUFFERED_WAIT_S and pol.window_scale > 1.0:
                want = -1  # decay toward static
                reason = "overbuffered"
            else:
                want = 0
        else:
            # no feeder on the thumbnail and embed paths: chunk sizing
            # tracks how full the device chunks run
            if occ is None:
                want = 0 if clear else None
            elif occ >= OCC_HIGH and not congested:
                want = +1
                reason = "saturate"
            elif occ < OCC_LOW and pol.window_scale > 1.0:
                want = -1
                reason = "pad-waste"
            else:
                want = 0
        if self._step(workload, "window", want, urgent=urgent):
            new = pol.window_scale * (2.0 if want > 0 else 0.5)
            new = min(SCALE_MAX, max(SCALE_MIN, new))
            if new != pol.window_scale:
                out.append(self._apply(workload, pol, "window_scale", pol.window_scale, new, s,
                                       reason))
                pol.window_scale = new

        # --- feeder depth (identify only) ---
        if workload == "identify":
            if lagging or congested:
                want = -1 if pol.depth_extra > 0 else 0
            elif s.wait_mean_s is None:
                want = 0 if clear else None
            elif s.wait_mean_s >= STARVED_WAIT_S:
                want = +1
            elif s.wait_mean_s <= OVERBUFFERED_WAIT_S and pol.depth_extra > 0:
                want = -1
            else:
                want = 0
            if self._step(workload, "depth", want):
                new_extra = pol.depth_extra + (1 if want > 0 else -1)
                new_extra = max(0, min(FEEDER_DEPTH_CAP, new_extra))
                if new_extra != pol.depth_extra:
                    out.append(self._apply(
                        workload, pol, "depth_extra", pol.depth_extra, new_extra, s,
                        "starved" if want > 0 else
                        ("loop-lag" if lagging else
                         "congested" if congested else "overbuffered"),
                    ))
                    pol.depth_extra = new_extra

        # --- dispatch rung (identify only: the resize pads per size
        # bucket, not the cas ladder) ---
        if workload == "identify":
            cap = _ladder_rung_cap()
            if pol.rung > cap:
                # the demotion clamp applies at once, undamped
                out.append(self._apply(workload, pol, "rung", pol.rung, cap, s,
                                       "device-ladder-demotion"))
                pol.rung = cap
                self._streaks.pop((workload, "rung"), None)
            if congested:
                want = -1 if pol.rung > 0 else 0
            elif occ is not None:
                if occ < OCC_LOW:
                    want = -1 if pol.rung > 0 else 0
                elif occ >= OCC_HIGH:
                    want = +1  # saturate (a no-op step at the cap)
                else:
                    want = 0 if clear else None
            elif clear:
                want = +1 if pol.rung < cap else 0
            else:
                want = None
            if self._step(workload, "rung", want):
                new_rung = max(0, min(cap, pol.rung + (1 if want > 0 else -1)))
                if new_rung != pol.rung:
                    out.append(self._apply(
                        workload, pol, "rung", pol.rung, new_rung, s,
                        "congested" if (congested and want < 0) else
                        ("pad-waste" if want < 0 else "saturate"),
                    ))
                    pol.rung = new_rung

        out.extend(self._tick_pool(workload, pol, s))
        return out

    def _tick_pool(self, workload: str, pol: PipelinePolicy, s: Sample) -> list[dict[str, Any]]:
        """Process-pool quantum control from the owner-side per-batch
        deltas (shared by every workload, each with its own streak):
        slow roundtrips and underfilled batches shrink the scale, an
        IPC tax past ``POOL_DISPATCH_SHARE`` grows it."""
        if s.pool_batches <= 0:
            want: int | None = None  # idle pool: silence, not evidence
            reason = ""
        else:
            rt_mean = s.pool_roundtrip_s / s.pool_batches
            rows_mean = s.pool_rows / s.pool_batches
            share = s.pool_dispatch_s / s.pool_roundtrip_s if s.pool_roundtrip_s > 0 else 0.0
            if rt_mean >= POOL_RT_SLOW_S and pol.pool_scale > POOL_SCALE_MIN:
                want, reason = -1, "slow-roundtrip"
            elif rows_mean < 0.5 * pol.procpool_batch_rows() and pol.pool_scale > POOL_SCALE_MIN:
                want, reason = -1, "underfilled"
            elif share >= POOL_DISPATCH_SHARE and rt_mean < POOL_RT_SLOW_S:
                want, reason = +1, "ipc-tax"
            else:
                want, reason = 0, ""
        if not self._step(workload, "pool", want):
            return []
        new = pol.pool_scale * (2.0 if want > 0 else 0.5)
        new = min(POOL_SCALE_MAX, max(POOL_SCALE_MIN, new))
        if new == pol.pool_scale:
            return []
        decision = self._apply(workload, pol, "pool_scale", pol.pool_scale, new, s, reason)
        pol.pool_scale = new
        return [decision]

    @staticmethod
    def _loop_lagging(s: Sample) -> bool:
        from ..telemetry.health import LOOP_LAG_DEGRADED

        return s.loop_lag_s >= LOOP_LAG_DEGRADED

    def _step(self, workload: str, knob: str, want: int | None, urgent: bool = False) -> bool:
        """Damping: True when `want` (±1) has persisted for STEP_STREAK
        consecutive deciding ticks. None holds the streak; 0 resets it;
        an opposite wish restarts it in the new direction. ``urgent``
        promotions step at once."""
        key = (workload, knob)
        if want is None:
            return False
        if want == 0:
            self._streaks.pop(key, None)
            return False
        if urgent and want > 0:
            self._streaks[key] = 0
            return True
        streak = self._streaks.get(key, 0)
        streak = streak + want if (streak > 0) == (want > 0) or streak == 0 else want
        if abs(streak) >= STEP_STREAK:
            self._streaks[key] = 0
            return True
        self._streaks[key] = streak
        return False

    def _apply(self, workload: str, pol: PipelinePolicy, knob: str,
               old: Any, new: Any, s: Sample, reason: str) -> dict[str, Any]:
        from ..telemetry import metrics as _tm
        from ..telemetry.events import AUTOTUNE_EVENTS

        action = "promote" if (new > old) else "demote"
        decision = {"workload": workload, "knob": knob, "action": action,
                    "from": old, "to": new, "reason": reason}
        AUTOTUNE_EVENTS.emit(
            "decision",
            workload=workload,
            knob=knob,
            action=action,
            old=old,
            new=new,
            reason=reason,
            wait_mean_s=None if s.wait_mean_s is None else round(s.wait_mean_s, 4),
            link_gbps=round(s.link_gbps, 3),
            loop_lag_s=round(s.loop_lag_s, 4),
            demotion_level=s.demotion_level,
        )
        _tm.AUTOTUNE_DECISIONS.inc(workload=workload, action=action)
        self._export_gauges(workload, pol, knob, new)
        return decision

    def _export_gauges(self, workload: str, pol: PipelinePolicy,
                       knob: str | None = None, new: Any = None) -> None:
        from ..telemetry import metrics as _tm

        _tm.AUTOTUNE_WINDOW_SCALE.set(
            float(new if knob == "window_scale" else pol.window_scale), workload=workload)
        _tm.AUTOTUNE_RUNG.set(float(new if knob == "rung" else pol.rung), workload=workload)
        _tm.AUTOTUNE_DEPTH_EXTRA.set(
            float(new if knob == "depth_extra" else pol.depth_extra), workload=workload)
        _tm.AUTOTUNE_POOL_SCALE.set(
            float(new if knob == "pool_scale" else pol.pool_scale), workload=workload)

    def snapshot(self) -> dict[str, Any]:
        """Current knob state, with the stage plane's per-stage rates and
        lease targets."""
        from . import scheduler as _scheduler

        return {
            "enabled": enabled(),
            "ticks": self.ticks,
            "policies": {w: p.snapshot() for w, p in self.policies.items()},
            "stages": {
                **_scheduler.snapshot(),
                "lease_targets": {
                    st: round(v, 3) for st, v in self.stage_lease.items()
                },
            },
        }


#: the process-wide controller and policies every consumer reads
CONTROLLER = Controller()


def policy(workload: str) -> PipelinePolicy:
    """The live policy of a workload: the seam. An unknown workload
    raises (a typo must not mint an untuned policy)."""
    return CONTROLLER.policies[workload]


def snapshot() -> dict[str, Any]:
    return CONTROLLER.snapshot()


def observed_files_per_s(workload: str = "identify") -> float | None:
    """Telemetry-derived throughput for a workload: the identifier's
    files over its hash and db seconds (the history's ``files_per_s``
    series; the mesh work plane's lease sizing reads it too, with its
    plane). None until the workload has processed anything here."""
    from ..telemetry import metrics as _tm

    if workload != "identify":
        return None
    files = _tm.IDENTIFIER_FILES.value()
    secs = (
        _tm.IDENTIFIER_STAGE_SECONDS.stats(stage="hash")["sum"]
        + _tm.IDENTIFIER_STAGE_SECONDS.stats(stage="db")["sum"]
    )
    if not files or secs <= 0:
        return None
    return files / secs


def reset() -> None:
    """Test isolation: static knobs, cleared streaks and baselines."""
    CONTROLLER.reset()
