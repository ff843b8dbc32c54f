"""Fault-injection plane — deterministic, seed-controlled chaos hooks.

An owned copy of `spacedrive_tpu/utils/faults.py`: the same catalog,
spec syntax, seeded firing order and activation bookkeeping, so one
plan and seed fire the same faults in the same order in both packages.
Points whose modules the port does not have yet (the work plane's
`p2p.steal`, the cloud relay's `relay.http`) are cataloged and simply
never hit. The
``xla`` modes raise a CUDA-shaped error here (`device_error`).

The real seams carry named injection points: device dispatch, the H2D
feeder's producer, search scoring, the device probe and the
thumbnailer's store→journal persistence window. Each point is a single
``faults.hit("<point>")`` call that is a no-op (one ``is None`` check
against a module global) unless a :class:`FaultPlan` is installed —
production pays nothing for the plane's existence.

A plan is a list of :class:`FaultSpec` entries — point, mode, and
activation bookkeeping (``prob``/``times``/``after``/``delay_s``) —
seeded so the same plan + seed fires the same faults in the same order.
Plans come from the ``SD_FAULTS`` env var, the CLI's ``--faults`` flag,
or a test fixture via :func:`active`.

Every activation lands on the ``faults`` flight ring and bumps
``sd_faults_injected_total``.

Spec syntax (env/CLI)::

    point:mode[:key=value[,key=value...]][;point:mode[:...]]...
    SD_FAULTS="device.blake3:raise:times=1;relay.http:500:prob=0.5"
    SD_FAULT_SEED=7

Registered points and their modes are cataloged in :data:`FAULT_POINTS`.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
from dataclasses import dataclass, field
from typing import Any, Iterable

#: point name -> (docstring, modes) — the catalog the docs and the
#: chaos suite enumerate; hit() refuses unknown points so a typo'd
#: plan fails loudly instead of silently never firing.
FAULT_POINTS: dict[str, tuple[str, tuple[str, ...]]] = {
    "device.blake3": (
        "cas_id device dispatch (ops/blake3_torch.hash_batch)",
        ("raise", "xla", "wrong_shape"),
    ),
    "device.thumbnail": (
        "thumbnail device resize (ops/thumbnail_torch.resize_batch)",
        ("raise", "xla", "wrong_shape"),
    ),
    "embed.forward": (
        "semantic embedding forward pass (ops/embed_torch.embed_batch)",
        ("raise", "xla", "wrong_shape"),
    ),
    "search.query": (
        "vector-index device scoring (object/search/index.query) — the "
        "device leg fails, scoring must fall back to the host path with "
        "an identical ranking",
        ("raise", "xla"),
    ),
    "device.probe": (
        "per-device health probe (parallel/mesh.DeviceLadder) — arg "
        "selects the device index that reads as dead",
        ("dead",),
    ),
    "feeder.fetch": (
        "H2D window producer (parallel/feeder.WindowPipeline)",
        ("stall", "crash"),
    ),
    "p2p.connect": (
        "outbound stream open (p2p/p2p.P2P.new_stream)",
        ("reset",),
    ),
    "p2p.write": (
        "udp stream write path (p2p/udpstream.UdpStream.write)",
        ("reset", "partial"),
    ),
    "p2p.sync_serve": (
        "inbound SYNC/SYNC_REQUEST responder (p2p/manager) — the peer "
        "vanishes mid-exchange",
        ("vanish",),
    ),
    "p2p.trace_pull": (
        "inbound TELEMETRY trace_pull responder (p2p/manager) — the "
        "peer vanishes before serving its spans; distributed trace "
        "assembly must degrade to a partial report, never block",
        ("vanish",),
    ),
    "p2p.profile_pull": (
        "inbound TELEMETRY profile_pull responder (p2p/manager) — the "
        "peer vanishes before serving its host profile; the mesh "
        "profile view must degrade to a partial answer, never block",
        ("vanish",),
    ),
    "p2p.steal": (
        "work-stealing shard plane (p2p/work.py): `vanish` at arg "
        "'lease' kills the claiming worker after the lease is granted "
        "(peer dies mid-lease; the shard must expire and be re-stolen); "
        "`race` at arg 'claim' double-leases an already-leased shard "
        "(claim race; the twice-executed shard must merge idempotently)",
        ("vanish", "race"),
    ),
    "procpool.worker": (
        "multi-process execution plane (parallel/procpool.py): `crash` "
        "kills the chosen worker process right after its batch ships "
        "(death mid-batch; the pool must restart the worker once and "
        "re-dispatch, and the pass must converge bit-identical); "
        "`stall` delays the batch inside the worker by delay_s",
        ("crash", "stall"),
    ),
    "relay.http": (
        "cloud relay HTTP surface (cloud/relay middleware)",
        ("500", "timeout", "truncate"),
    ),
    "db.slow": (
        "library SQLite read path (db/database.LibraryDb.query/"
        "query_one) — `stall` sleeps delay_s per read, simulating a "
        "slow/contended disk under the whole serve surface",
        ("stall",),
    ),
    "sync.ingest": (
        "remote op ingest (sync/ingest.receive_crdt_operation)",
        ("poison",),
    ),
    "thumbnail.persist": (
        "crash window between chunk store and journal write "
        "(object/media/thumbnail/actor)",
        ("crash",),
    ),
}


class InjectedFault(RuntimeError):
    """An injected failure that production error handling must absorb."""


class InjectedCrash(BaseException):
    """Simulated process death — derives from BaseException so generic
    ``except Exception`` recovery can NOT absorb it; only the chaos
    harness (standing in for a fresh process) catches it."""


def device_error(point: str) -> Exception:
    """A CUDA-shaped exception for ``xla`` fault modes: the
    `torch.AcceleratorError` a real CUDA fault raises (torch >= 2.8),
    RuntimeError where that class cannot be built."""
    try:
        import torch

        return torch.AcceleratorError(f"injected CUDA failure at {point}")
    except Exception:  # noqa: BLE001 - older torch has no AcceleratorError
        return RuntimeError(f"injected CUDA failure at {point}")


@dataclass
class FaultSpec:
    """One armed fault: fire ``mode`` at ``point``.

    ``after`` hits are skipped before arming, then each hit fires with
    probability ``prob`` until ``times`` activations (None = forever).
    ``arg`` narrows the spec to hits carrying the same discriminator
    (e.g. a device index for ``device.probe``). ``delay_s`` parametrizes
    stall/timeout modes.
    """

    point: str
    mode: str
    prob: float = 1.0
    times: int | None = 1
    after: int = 0
    delay_s: float = 0.2
    arg: str | None = None
    # runtime counters (owned by the plan's lock)
    hits: int = field(default=0, repr=False)
    fired: int = field(default=0, repr=False)

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        parts = text.strip().split(":", 2)
        if len(parts) < 2:
            raise ValueError(f"fault spec {text!r} is not point:mode[:k=v,...]")
        point, mode = parts[0].strip(), parts[1].strip()
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r}")
        if mode not in FAULT_POINTS[point][1]:
            raise ValueError(
                f"fault point {point!r} has no mode {mode!r} "
                f"(modes: {', '.join(FAULT_POINTS[point][1])})"
            )
        spec = cls(point=point, mode=mode)
        if len(parts) == 3 and parts[2]:
            for kv in parts[2].split(","):
                k, _, v = kv.partition("=")
                k = k.strip()
                if k == "prob":
                    spec.prob = float(v)
                elif k == "times":
                    spec.times = None if v in ("inf", "") else int(v)
                elif k == "after":
                    spec.after = int(v)
                elif k == "delay_s":
                    spec.delay_s = float(v)
                elif k == "arg":
                    spec.arg = v
                else:
                    raise ValueError(f"unknown fault spec key {k!r} in {text!r}")
        return spec


class FaultPlan:
    """A set of armed specs + the deterministic per-spec RNGs.

    Thread-safe: hits arrive from the event loop, feeder producer
    threads, and ``to_thread`` workers alike.
    """

    def __init__(self, specs: Iterable[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._rngs = [
            random.Random(f"{self.seed}:{i}:{s.point}:{s.mode}")
            for i, s in enumerate(self.specs)
        ]

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        specs = [
            FaultSpec.parse(part)
            for part in text.split(";")
            if part.strip()
        ]
        return cls(specs, seed=seed)

    def hit(self, point: str, arg: str | None = None) -> FaultSpec | None:
        """One pass through an injection point: returns the fired spec
        (recorded on the flight ring) or None. The first matching armed
        spec wins."""
        if point not in FAULT_POINTS:
            raise ValueError(f"unregistered fault point {point!r}")
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.point != point:
                    continue
                if spec.arg is not None and spec.arg != (
                    None if arg is None else str(arg)
                ):
                    continue
                spec.hits += 1
                if spec.hits <= spec.after:
                    continue
                if spec.times is not None and spec.fired >= spec.times:
                    continue
                if spec.prob < 1.0 and self._rngs[i].random() >= spec.prob:
                    continue
                spec.fired += 1
                break
            else:
                return None
        _record_activation(spec, arg)
        return spec

    def activations(self) -> dict[str, int]:
        """Fired count per point (for soak assertions)."""
        with self._lock:
            out: dict[str, int] = {}
            for s in self.specs:
                out[s.point] = out.get(s.point, 0) + s.fired
            return out


def _record_activation(spec: FaultSpec, arg: str | None) -> None:
    # imported lazily: utils must stay importable before telemetry
    from ..telemetry import metrics as _tm
    from ..telemetry.events import FAULT_EVENTS

    _tm.FAULTS_INJECTED.inc()
    FAULT_EVENTS.emit(
        "injected",
        point=spec.point,
        mode=spec.mode,
        fired=spec.fired,
        arg=None if arg is None else str(arg),
    )


# --- the process-wide active plan ----------------------------------------

_active: list[FaultPlan | None] = [None]


def install(plan: FaultPlan | None) -> None:
    _active[0] = plan


def clear() -> None:
    _active[0] = None


def active_plan() -> FaultPlan | None:
    return _active[0]


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Test-fixture activation: install for the block, restore after."""
    prev = _active[0]
    _active[0] = plan
    try:
        yield plan
    finally:
        _active[0] = prev


def install_from_env(environ=os.environ) -> FaultPlan | None:
    """Arm SD_FAULTS (seeded by SD_FAULT_SEED) if set; returns the plan."""
    text = environ.get("SD_FAULTS")
    if not text:
        return None
    plan = FaultPlan.parse(text, seed=int(environ.get("SD_FAULT_SEED", "0")))
    install(plan)
    return plan


def hit(point: str, arg: str | None = None) -> FaultSpec | None:
    """The injection-point call sites' entry: None when no plan is
    active (the common case — one list indexing and an ``is None``)."""
    plan = _active[0]
    if plan is None:
        return None
    return plan.hit(point, arg)
