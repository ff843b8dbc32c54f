"""The device seam: which devices a dispatch uses, and the degradation
ladder it falls down when one of them fails.

Counterpart of `spacedrive_tpu/parallel/mesh.py`. The JAX package builds
`jax.sharding` meshes; the port dispatches over a *slot list* instead:
a list of `torch.device`s, one per share of a batch's rows (cas, resize
and embed split dim 0 into `len(slots)` equal parts, each launched on its
slot's device). A slot list may repeat a device — `[cuda:0] * k` on a
one-card machine, `[cpu] * k` in the CPU tests — which is how both
exercise a k-way dispatch; the ladder therefore keys its survivors by
slot position, never by device index.

Auto dispatch: an op called on a device *type* ("cuda", the default)
rides `LADDER` over `dispatch_devices()` of that type. A device pinned
by index ("cuda:1") or a type with no dispatch device (a CPU-only host
asked for "cuda", where the op then raises) rides no ladder and runs
strict, as do explicit `devices` lists. Only a dispatch that failed at
run time demotes: a failed kernel build or a missing device raises.
Every rung stays on the device type asked for: the last is the
caller's default device alone, strict, and its failure raises (the JAX
cas ladder ends on the host instead).

`make_mesh`, `flat_mesh`, `batch_sharding` and `replicated` build JAX
sharding objects and have no counterpart. `multihost_init` joins a
`torch.distributed` process group where JAX's joins a
`jax.distributed` cluster, under the same contract.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Sequence, TypeVar

import numpy as np
import torch

from ..telemetry import events as _events
from ..telemetry import metrics as _tm
from ..utils import faults as _faults

logger = logging.getLogger(__name__)

T = TypeVar("T")

AXES = ("dp", "fsdp", "tp")


def factor3(n: int) -> tuple[int, int, int]:
    """n devices → (dp, fsdp, tp), preferring tp=2 then fsdp=2 (the
    JAX package's factoring)."""
    tp = 2 if n % 2 == 0 else 1
    rem = n // tp
    fsdp = 2 if rem % 2 == 0 else 1
    return rem // fsdp, fsdp, tp


def pad_to_multiple(arr: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad dim 0 so sharded batches divide evenly; returns (arr, pad)."""
    pad = (-arr.shape[0]) % multiple
    if pad:
        arr = np.concatenate(
            [arr, np.zeros((pad, *arr.shape[1:]), arr.dtype)]
        )
    return arr, pad


_ACCEL_COUNT: list[int] | None = None


def accelerator_count() -> int:
    """Local CUDA device count, 1 when there is none.

    The batch/depth scale factor of a dp dispatch: the identifier's
    window, the thumbnailer's device chunk, the embed step and the
    feeder depth all multiply by it so one host window feeds every
    card. CPU slot lists do not count: they share the same cores."""
    global _ACCEL_COUNT
    if _ACCEL_COUNT is None:
        _ACCEL_COUNT = [torch.cuda.device_count() if torch.cuda.is_available() else 0]
    return max(1, _ACCEL_COUNT[0])


def device_scale(device: str | torch.device) -> int:
    """The scale factor of a job's windows and chunks on `device`:
    `accelerator_count()` on CUDA, 1 on the CPU."""
    return accelerator_count() if torch.device(device).type == "cuda" else 1


def dispatch_devices() -> list[torch.device]:
    """Every visible CUDA device, `cuda:0` .. `cuda:n-1`, for an auto
    dispatch ([] on a host without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def auto_slots(device: str | torch.device) -> list[torch.device]:
    """The slot list an auto dispatch on `device` rides: the dispatch
    devices of its type when `device` names no index, else [] (a pinned
    device, or a type with no dispatch device, runs strict)."""
    device = torch.device(device)
    if device.index is not None:
        return []
    return [d for d in dispatch_devices() if d.type == device.type]


# --- graceful degradation ladder (utils/faults) -----------------------------

LEVEL_MESH = 0      # every slot
LEVEL_SUBSET = 1    # the slots whose probe survived
LEVEL_HOST = 2      # the last rung: the caller's default device alone, strict


class DeviceLadder:
    """Demotion ladder for device dispatch: all slots → surviving slot
    subset → the last rung (LEVEL_HOST, named after the JAX package's
    host reference path; here the caller's default device alone) — a
    failed batch degrades instead of failing the job.

    Callers take ``(devices, level)`` from :meth:`filter` and report
    the dispatch outcome back via :meth:`record_success` /
    :meth:`record_failure`. Demotion probes each slot individually
    (one tiny copy to the device and back, routed through the
    ``device.probe`` fault point so chaos tests pick which slots "die")
    and keeps the survivors. After ``reset_timeout`` the ladder hands
    out ONE half-open probe dispatch at the next level up; its success
    re-arms (promotes), its failure restarts the clock.

    Every transition updates ``sd_device_demotion_level``, lands on the
    ``resilience`` flight ring and, when it demotes, logs a WARNING.
    """

    def __init__(self, reset_timeout: float = 30.0):
        self.reset_timeout = reset_timeout
        self._level = LEVEL_MESH
        self._subset: frozenset[int] | None = None  # surviving slot positions
        self._demoted_at = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0
        self._lock = threading.Lock()

    def reset(self) -> None:
        with self._lock:
            self._level = LEVEL_MESH
            self._subset = None
            self._probe_inflight = False
        self._set_gauge(LEVEL_MESH)

    @property
    def level(self) -> int:
        return self._level

    @staticmethod
    def _set_gauge(level: int) -> None:
        _tm.DEVICE_DEMOTION.set(float(level))

    def _probe_device(self, index: int, dev: torch.device) -> bool:
        """Slot `index` answers a 4-int round trip. Never raises: after a
        sticky CUDA fault every call in the process fails, the probe
        included, and that reads as a dead slot."""
        if _faults.hit("device.probe", arg=str(index)) is not None:
            return False
        try:
            want = torch.arange(4, dtype=torch.int32)
            return bool(torch.equal(want.to(dev).cpu(), want))
        except Exception:  # noqa: BLE001 - a dead device raises anything
            return False

    def _survivors(self, devices: Sequence[torch.device]) -> list[int]:
        return [i for i, d in enumerate(devices) if self._probe_device(i, d)]

    def filter(self, devices: Sequence[torch.device]) -> tuple[list[torch.device], int]:
        """The slot list + ladder level for the next dispatch. An empty
        list means the last rung. When a demoted ladder's reset timeout
        has elapsed, ONE caller gets the promoted level as a half-open
        probe (it must report the outcome)."""
        devices = list(devices)
        now = time.monotonic()
        with self._lock:
            level = self._level
            if (
                level > LEVEL_MESH
                # an in-flight probe older than the reset window was
                # abandoned (its dispatch died without reporting) —
                # don't let it wedge re-arming forever
                and (not self._probe_inflight
                     or now - self._probe_started >= self.reset_timeout)
                and now - self._demoted_at >= self.reset_timeout
            ):
                level -= 1
                self._probe_inflight = True
                self._probe_started = now
            subset = self._subset
        if level == LEVEL_MESH:
            return devices, level
        if level == LEVEL_HOST:
            return [], level
        if subset:
            kept = [d for i, d in enumerate(devices) if i in subset]
        else:
            alive = self._survivors(devices)
            kept = [devices[i] for i in alive]
            if alive:
                # cache the sweep (e.g. after a HOST→SUBSET re-arm left
                # no subset): probing every slot is a blocking round
                # trip each and must not run per dispatch
                with self._lock:
                    if self._subset is None:
                        self._subset = frozenset(alive)
        return (kept or devices[:1]), level

    def record_success(self, level: int) -> None:
        """A dispatch at ``level`` completed — a half-open probe's
        success promotes (re-arms) the ladder to that level. Only the
        probe holder (level below current) touches probe bookkeeping."""
        with self._lock:
            if level >= self._level:
                return
            self._probe_inflight = False
            self._level = level
            if level == LEVEL_MESH:
                self._subset = None
        self._set_gauge(level)
        _events.RESILIENCE_EVENTS.emit("device_promote", level=level)
        logger.info("device ladder promoted to level %d", level)

    def probe_inconclusive(self, level: int) -> None:
        """A dispatch holding the half-open probe finished WITHOUT
        exercising the rung's slots (a tail too small to shard ran on
        the caller's default device) — release the probe slot without
        promoting, so the next real dispatch gets the probe."""
        with self._lock:
            if level < self._level:
                self._probe_inflight = False

    def record_failure(self, level: int, devices: Sequence[torch.device]) -> int:
        """A dispatch at ``level`` failed — demote one rung (probing for
        survivors when leaving the full slot list) and return the new
        level."""
        devices = list(devices)
        if level == LEVEL_MESH and len(devices) > 1:
            alive = self._survivors(devices)
            next_level = LEVEL_SUBSET if alive else LEVEL_HOST
            subset = frozenset(alive)
        else:
            next_level = LEVEL_HOST
            subset = None
        with self._lock:
            if level < self._level:
                self._probe_inflight = False  # the probe itself failed
            if next_level <= self._level:
                # another dispatch already demoted at least this far;
                # just restart the re-arm clock
                self._demoted_at = time.monotonic()
                return self._level
            self._level = next_level
            self._subset = subset
            self._demoted_at = time.monotonic()
        self._set_gauge(next_level)
        survivors = len(subset) if subset is not None else 0
        _events.RESILIENCE_EVENTS.emit(
            "device_demote", level=next_level, survivors=survivors, failed_level=level,
        )
        logger.warning("device dispatch failed at level %d: demoted to level %d%s", level,
                       next_level, f" ({survivors} surviving slots)" if subset else "")
        return next_level


#: the process-wide ladder every auto dispatch consults
LADDER = DeviceLadder()


def ladder_devices(device: str | torch.device = "cuda") -> tuple[list[torch.device], int] | None:
    """`auto_slots(device)` filtered through the degradation ladder:
    (devices, level), an empty list meaning the last rung; None when
    `device` rides no ladder, so the caller runs strict on it. Callers
    MUST report the dispatch outcome back to ``LADDER``."""
    slots = auto_slots(device)
    if not slots:
        return None
    return LADDER.filter(slots)


def _auto_devices(devs: list[torch.device], level: int, n_rows: int) -> list[torch.device] | None:
    """The sharding policy of an auto resize or embed call: every slot
    of the rung once each can hold at least one real row; below that,
    at the subset rung, the first surviving slot (never the possibly
    dead default device); else None, the caller's default device
    (padding whole canvases to feed idle devices is a net loss)."""
    if level < LEVEL_HOST and len(devs) > 1 and n_rows >= len(devs):
        return devs
    if level == LEVEL_SUBSET and devs:
        return devs[:1]
    return None


def run_on_ladder(device: str | torch.device, n_rows: int,
                  call: Callable[[list[torch.device]], T], source: str) -> T:
    """Run one resize or embed dispatch of `n_rows` rows: `call(slots)`
    takes a slot list and returns the validated result.

    A `device` that rides no ladder (`auto_slots` empty) runs strict:
    `call([device])`, whose failure raises. Otherwise the call rides
    `LADDER`, bounded at one attempt per rung plus one half-open probe
    (a tiny reset_timeout must not oscillate probe/demote forever): a
    failure demotes and the call re-runs at the demoted rung, whose
    last step is the caller's default device; a failure there, or on
    the fourth attempt, raises. The math per row is the same at every
    rung, so the result does not depend on where it ran."""
    device = torch.device(device)
    slots = auto_slots(device)
    if not slots:
        return call([device])
    for attempt in range(4):
        devs, level = LADDER.filter(slots)
        use = _auto_devices(devs, level, n_rows)
        try:
            out = call(use or [device])
        except Exception as exc:  # noqa: BLE001 - demote and retry
            # always settle the ladder's bookkeeping (a probe left
            # unreported would block re-arming), THEN decide whether
            # anything is left to demote to
            LADDER.record_failure(level, devs)
            if level >= LEVEL_HOST or attempt == 3:
                raise
            _events.record_error(source, exc)
            continue
        if use is not None:
            LADDER.record_success(level)
        else:
            # ran on the default device: says nothing about the rung's
            # slots, so a held probe is released, never promoted
            LADDER.probe_inconclusive(level)
        return out
    raise RuntimeError("unreachable: the ladder loop ran out of attempts")


#: the bound on joining a process group (every peer must arrive in it)
MULTIHOST_TIMEOUT_S = 300.0


def multihost_init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join a multi-host `torch.distributed` process group: ``gloo`` on
    a host without CUDA, ``nccl`` with a card. The address is
    ``host:port`` (``SD_COORDINATOR_ADDRESS``), the world size and the
    rank come from the arguments or ``SD_NUM_PROCESSES`` and
    ``SD_PROCESS_ID``. Returns False with no address and no process
    count (a single host keeps working untouched) and when joining
    fails; True once this process is in a group. Where a shard hashes
    stays the Node's device: the group decides nothing about it."""
    import datetime

    import torch.distributed as dist

    env = os.environ
    coordinator_address = coordinator_address or env.get("SD_COORDINATOR_ADDRESS")
    if coordinator_address is None and num_processes is None:
        return False
    if dist.is_available() and dist.is_initialized():
        return True
    try:
        world = num_processes if num_processes is not None else int(env["SD_NUM_PROCESSES"])
        rank = process_id if process_id is not None else int(env["SD_PROCESS_ID"])
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=MULTIHOST_TIMEOUT_S),
        )
        return True
    except Exception:  # noqa: BLE001 - JAX's contract: False on any failure
        logger.warning("multihost_init: joining %s failed", coordinator_address, exc_info=True)
        return False
