"""Continuous host sampling profiler — name every frame of the host.

An owned copy of `spacedrive_tpu/telemetry/sampler.py`, stdlib only:

- a daemon thread walks ``sys._current_frames()`` at ``HZ``
  (~19 Hz, deliberately off-beat so it never phase-locks with
  10 Hz samplers or 1 Hz tickers) and folds each thread's stack into a
  bounded **collapsed-stack accumulator**;
- every sample is tagged with a **thread kind** (event loop / feeder /
  to_thread worker / other; the sampler's own thread is exempt from
  its own accounting) and an **execution state** from per-thread
  CPU-time deltas (``time.pthread_getcpuclockid`` +
  ``clock_gettime`` where available, leaf-frame heuristics otherwise):
  ``cpu`` (burning cycles), ``wait`` (parked in a known blocking
  primitive — select/epoll/lock/sleep), or ``gil_wait`` (runnable but
  not running: low CPU with a non-blocking leaf frame — the per-frame
  GIL-wait estimate). A thread blocked in a CUDA synchronize spins on
  the CPU by default, so it reads ``cpu``, not ``wait``;
- a declarative **frame → group classifier** names the code a sample
  sits in (journal consult, SQL prep, msgpack, decode/encode, CRDT
  ingest, device dispatch, …). The group vocabulary is the JAX
  package's; frames of this package are named relative to it, and
  ``torch`` takes the place of ``jax``/``jaxlib`` in ``device_dispatch``;
  a bounded timeline of (ts, kind, state, group) records lets
  ``telemetry/attrib.py`` split its ``gap`` and ``host_cpu`` buckets
  into the code that ate them (:func:`decompose_segments`), and
  ``group_shares()`` feeds the history's ``profile_share_*`` series;
- **triggered deep captures**: a loop-lag degradation or an SLO warn or
  breach (or a manual trigger; the brownout trigger comes with the
  serve plane) opens one
  bounded high-rate capture window (``CAPTURE_HZ`` for
  ``CAPTURE_S``), kept in a ring of recent windows.
  Hysteresis: one window per ``COOLDOWN_S``, so a flapping
  signal can never storm windows.

Exports: ``folded()`` (flamegraph.pl collapsed-stack text),
``profile()`` (the JSON document behind rspc ``telemetry.profile`` and
the CLI's ``profile``), ``summary()`` (a compact digest), and
``chrome_events()`` (capture-window samples merged into the
``telemetry.trace_export`` Chrome-trace document).

Contract: ``SD_PROFILE=0`` is a true no-op — ``start()`` spawns
nothing, ``trigger()`` refuses, every export reports disabled — and
profiling never touches pipeline data, so pass output is bit-identical
either way. The sampler measures its own tick cost and publishes the
duty cycle as ``sd_profile_overhead_ratio``. A sampler thread that
fails to start raises.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Any

# --- knobs ----------------------------------------------------------------

HZ = 19.0                   # base rate, off-beat by design
CAPTURE_HZ = 97.0           # deep-capture rate (also off-beat)
CAPTURE_S = 3.0             # deep-capture window length
COOLDOWN_S = 30.0           # min seconds between capture windows

MAX_STACK_DEPTH = 48        # frames kept per sample (leafward)
MAX_STACKS = 4096           # distinct collapsed stacks tracked
CAPTURE_RING = 8            # recent deep-capture windows retained
CAPTURE_MAX_SAMPLES = 4096  # per-window sample bound
TIMELINE_SAMPLES = 65536    # recent (ts, kind, state, group) records
FOLDED_MAX_BYTES = 256 * 1024  # wire/bundle bound for folded text

#: execution states (fixed vocabulary)
CPU = "cpu"
GIL_WAIT = "gil_wait"
WAIT = "wait"
STATES = (CPU, GIL_WAIT, WAIT)

#: thread kinds (fixed vocabulary; the sampler's own thread is skipped)
KIND_LOOP = "loop"
KIND_FEEDER = "feeder"
KIND_WORKER = "worker"
KIND_OTHER = "other"

#: capture-trigger reasons (fixed vocabulary — trigger() refuses others
#: so the ring's reason field stays auditable)
TRIGGER_REASONS = ("slo_warn", "slo_breach", "loop_lag", "brownout",
                   "manual")

#: CPU duty cycle at/above which a thread counts as on-CPU for the tick
ON_CPU_DUTY = 0.33


def enabled() -> bool:
    return os.environ.get("SD_PROFILE", "1") != "0"


# --- frame naming ---------------------------------------------------------

_PKG_MARKER = os.sep + "spacedrive_tpu_torch" + os.sep


#: parent directories that are filesystem scaffolding, not packages
_NON_PKG_PARENTS = ("site-packages", "dist-packages", "lib", "lib64", "")


def _module_of(filename: str) -> str:
    """Short module-ish name for a code filename: package-relative
    dotted path for our own tree, ``pkg.basename`` for external
    packages (``asyncio.base_events``, ``msgpack.fallback``), bare
    basename for top-level modules — never a user path, so folded
    profiles are redaction-clean by construction."""
    i = filename.rfind(_PKG_MARKER)
    if i >= 0:
        rel = filename[i + len(_PKG_MARKER):]
        if rel.endswith(".py"):
            rel = rel[:-3]
        return rel.replace(os.sep, ".")
    d, base = os.path.split(filename)
    if base.endswith(".py"):
        base = base[:-3]
    parent = os.path.basename(d)
    if parent.startswith("python") or parent in _NON_PKG_PARENTS:
        return base
    return parent if base == "__init__" else f"{parent}.{base}"


#: per-code-object frame-name memo: code objects are immutable and
#: long-lived, so the expensive filename→module derivation runs once
#: per distinct code object instead of once per frame per tick. Keyed
#: by the code object itself (an id() key could alias after GC reuse);
#: the cap bounds both the dict and the code objects it pins.
_CODE_NAMES: dict[Any, str] = {}
_CODE_NAMES_MAX = 8192


def _frame_name(code: Any) -> str:
    name = _CODE_NAMES.get(code)
    if name is None:
        if len(_CODE_NAMES) >= _CODE_NAMES_MAX:
            _CODE_NAMES.clear()
        name = f"{_module_of(code.co_filename)}:{code.co_name}"
        _CODE_NAMES[code] = name
    return name


def fold_stack(frame: Any, max_depth: int = MAX_STACK_DEPTH) -> list[str]:
    """Root-first ``module:function`` names for one thread's stack."""
    names: list[str] = []
    f = frame
    while f is not None and len(names) < max_depth:
        names.append(_frame_name(f.f_code))
        f = f.f_back
    names.reverse()
    return names


# --- frame → group classifier --------------------------------------------

#: declarative (group, module-prefix…) table, leaf-to-root first match.
#: Order matters: the earlier row wins when one stack crosses several
#: families (a journal consult calling sqlite3 names "journal" only if
#: the leafmost matching frame is the journal's — the sqlite3 leaf
#: correctly names "sql").
FRAME_GROUPS: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("journal", ("location.indexer.journal",)),
    ("sql", ("db.database", "db.migrations", "sqlite3")),
    ("walk", ("location.indexer.walk", "location.indexer.rules")),
    ("linking", ("object.file_identifier",)),
    ("crdt_ingest", ("sync.",)),
    ("msgpack", ("msgpack", "p2p.wire", "p2p.protocol")),
    ("decode", ("PIL", "object.media.media_data")),
    ("encode", ("object.media.thumbnail",)),
    ("device_dispatch", ("ops.", "torch", "numpy")),
    ("feeder", ("parallel.feeder",)),
    ("autotune", ("parallel.autotune",)),
    ("task_system", ("tasks.",)),
    ("jobs", ("jobs.",)),
    ("indexer", ("location.",)),
    ("serve", ("serve.", "api.", "aiohttp")),
    ("p2p", ("p2p.", "cloud.")),
    ("telemetry", ("telemetry.",)),
    ("loop_idle", ("selectors", "asyncio.base_events",
                   "asyncio.selector_events")),
    ("asyncio", ("asyncio.",)),
    ("thread_wait", ("threading", "queue", "futures.")),
)

#: the bounded group vocabulary history samplers + /mesh summaries use
GROUP_NAMES = tuple(g for g, _ in FRAME_GROUPS) + ("other",)

#: the curated subset persisted as history series (one float per group
#: per 10 s sample — the full vocabulary would triple every record for
#: groups that rarely move; these are the gap-decomposition movers)
HISTORY_GROUPS = ("journal", "sql", "linking", "crdt_ingest", "msgpack",
                  "decode", "encode", "loop_idle", "other")


#: scaffolding frames every thread carries near its root — they must
#: not name a group, or every worker sample would read "thread_wait"
_SCAFFOLD_FRAMES = frozenset({
    "threading:_bootstrap", "threading:_bootstrap_inner", "threading:run",
    "futures.thread:_worker",
})


def classify_stack(names: list[str]) -> str:
    """Name the frame group of one folded stack. Two passes, both
    leaf→root: the first frame matching a declared module family names
    the group; failing that, the first DOTTED module (a real package —
    our tree or an external one) names it by its top segment (``node``,
    ``json``, …) so project code outside the declared families still
    reads as named code. Only stacks touching no package at all are
    ``other`` (the honesty bucket the ≥70%-decomposed acceptance bar
    measures)."""
    for name in reversed(names):
        if name in _SCAFFOLD_FRAMES:
            continue
        mod = name.split(":", 1)[0]
        for group, prefixes in FRAME_GROUPS:
            for p in prefixes:
                if mod == p or mod.startswith(p):
                    return group
    for name in reversed(names):
        if name in _SCAFFOLD_FRAMES:
            continue
        mod = name.split(":", 1)[0]
        if "." in mod and not mod.startswith("<"):
            return mod.split(".", 1)[0]
    return "other"


#: leaf function names that mark a low-CPU thread as genuinely parked
#: (waiting on IO/locks/timers) rather than runnable-but-not-running
_WAIT_LEAF_FUNCS = frozenset({
    "wait", "_wait", "wait_for", "select", "poll", "epoll", "kqueue",
    "accept", "recv", "recvfrom", "recv_into", "read", "readline",
    "readinto", "sleep", "acquire", "get", "join", "getaddrinfo",
    "_recv_bytes", "settimeout", "flush", "fsync", "connect",
})
#: leaf modules whose presence means "blocked in C below this frame":
#: an idle executor worker's Python leaf is ``futures.thread:_worker``
#: while it sits inside SimpleQueue.get (a C call with no frame)
_WAIT_LEAF_MODULES = ("selectors", "socket", "ssl", "subprocess",
                      "futures.thread", "queue")


def _leaf_is_waity(names: list[str]) -> bool:
    if not names:
        return False
    mod, _, func = names[-1].partition(":")
    bare = func.lstrip("_")
    if bare in _WAIT_LEAF_FUNCS or "wait" in bare:
        # "wait" in the leaf name covers the private variants
        # (_wait_for_tstate_lock, sock_recv's await shims, …)
        return True
    return any(mod == m or mod.startswith(m + ".")
               for m in _WAIT_LEAF_MODULES)


# --- the sampler ----------------------------------------------------------


class CaptureWindow:
    """One bounded high-rate capture: per-sample timeline + its own
    collapsed-stack counts, finalized into the capture ring."""

    __slots__ = ("reason", "opened_ts", "until_monotonic", "hz",
                 "samples", "stack_counts", "closed", "duration_s")

    def __init__(self, reason: str, opened_ts: float,
                 until_monotonic: float, hz: float):
        self.reason = reason
        self.opened_ts = opened_ts
        self.until_monotonic = until_monotonic
        self.hz = hz
        self.samples: list[tuple[float, str, str, str]] = []
        self.stack_counts: dict[str, int] = {}
        self.closed = False
        self.duration_s = 0.0

    def to_doc(self, top_k: int = 8) -> dict[str, Any]:
        groups: dict[str, int] = {}
        for _, _, _, group in self.samples:
            groups[group] = groups.get(group, 0) + 1
        total = max(1, len(self.samples))
        return {
            "reason": self.reason,
            "opened_ts": round(self.opened_ts, 3),
            "duration_s": round(self.duration_s, 3),
            "hz": self.hz,
            "samples": len(self.samples),
            "closed": self.closed,
            "top_groups": [
                {"group": g, "samples": n, "share": round(n / total, 4)}
                for g, n in sorted(groups.items(), key=lambda kv: kv[1],
                                   reverse=True)[:top_k]
            ],
            "top_stacks": [
                {"stack": s, "samples": n}
                for s, n in sorted(self.stack_counts.items(),
                                   key=lambda kv: kv[1], reverse=True)[:top_k]
            ],
        }


class Sampler:
    """The process-wide continuous profiler. One instance per process
    (:data:`SAMPLER`); ``start``/``stop`` are refcounted because two
    in-process nodes (the loopback test mesh) share one interpreter —
    the first stop must not kill the survivor's profile."""

    def __init__(self):
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop_event = threading.Event()
        self._refs = 0
        self._loop_idents: set[int] = set()
        # accumulator state (guarded by _lock)
        self._stacks: dict[tuple[str, str, str], int] = {}
        self._stacks_dropped = 0
        self._group_counts: dict[tuple[str, str], int] = {}
        self._kind_counts: dict[str, int] = {}
        self._state_counts: dict[str, int] = {}
        self._total_samples = 0
        self._started_ts: float | None = None
        self._timeline: deque[tuple[float, str, str, str]] = deque(
            maxlen=TIMELINE_SAMPLES)
        # per-thread CPU clock bookkeeping (sampler thread only)
        self._cpu_prev: dict[int, tuple[float, float]] = {}
        # triggered captures
        self._capture: CaptureWindow | None = None
        self._captures: deque[CaptureWindow] = deque(maxlen=CAPTURE_RING)
        self._last_capture_open = float("-inf")
        # self-accounting
        self._self_seconds = 0.0
        self._ticks = 0

    # -- lifecycle --------------------------------------------------------

    def start(self) -> bool:
        """Add one hold on the sampler; the first hold spawns the
        thread. Returns True when sampling is running after the call
        (False under ``SD_PROFILE=0`` — a true no-op)."""
        if not enabled():
            return False
        with self._lock:
            self._refs += 1
            if self._thread is not None and self._thread.is_alive():
                return True
            self._stop_event.clear()
            if self._started_ts is None:
                self._started_ts = time.time()
            self._thread = threading.Thread(
                target=self._run, name="sd-profiler", daemon=True,
            )
            self._thread.start()
            return True

    def stop(self) -> None:
        """Release one hold; the last release stops the thread."""
        with self._lock:
            self._refs = max(0, self._refs - 1)
            if self._refs > 0:
                return
            thread = self._thread
            self._thread = None
            self._stop_event.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=2.0)

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def register_loop_thread(self) -> None:
        """Tag the CALLING thread as an event-loop thread (Node.start
        runs on its loop). Kind classification reads this set."""
        with self._lock:
            self._loop_idents.add(threading.get_ident())

    def reset(self) -> None:
        """Test isolation (rides ``telemetry.reset()``): clear the
        accumulators, timeline, capture ring, and trigger/cooldown
        state. The thread (and refcounts) survive — reset is about
        *data*, not lifecycle."""
        with self._lock:
            self._stacks.clear()
            self._stacks_dropped = 0
            self._group_counts.clear()
            self._kind_counts.clear()
            self._state_counts.clear()
            self._total_samples = 0
            self._timeline.clear()
            self._cpu_prev.clear()
            self._capture = None
            self._captures.clear()
            self._last_capture_open = float("-inf")
            self._self_seconds = 0.0
            self._ticks = 0
            self._started_ts = time.time() if self.running() else None

    # -- triggered deep captures ------------------------------------------

    def trigger(self, reason: str) -> bool:
        """Open a bounded high-rate capture window for ``reason``
        (fixed vocabulary). Hysteresis: while a window is active, or
        within the cooldown of the last open, the trigger is absorbed —
        a flapping SLO can never storm windows. Returns True when a NEW
        window opened."""
        if not enabled() or not self.running():
            return False
        if reason not in TRIGGER_REASONS:
            raise ValueError(
                f"unknown capture trigger {reason!r} "
                f"(reasons: {', '.join(TRIGGER_REASONS)})"
            )
        now_m = time.monotonic()
        with self._lock:
            if self._capture is not None and not self._capture.closed:
                return False
            if now_m - self._last_capture_open < COOLDOWN_S:
                return False
            self._capture = CaptureWindow(
                reason, time.time(), now_m + CAPTURE_S,
                CAPTURE_HZ,
            )
            self._last_capture_open = now_m
        from . import metrics as _tm

        _tm.PROFILE_CAPTURES.inc()
        return True

    def _close_capture_locked(self, now_m: float) -> None:
        cap = self._capture
        if cap is None:
            return
        cap.closed = True
        cap.duration_s = max(
            0.0, CAPTURE_S - max(0.0, cap.until_monotonic - now_m))
        self._captures.append(cap)
        self._capture = None

    # -- the sampling thread ----------------------------------------------

    def _run(self) -> None:
        while not self._stop_event.is_set():
            t0 = time.monotonic()
            c0 = time.thread_time()
            try:
                self._tick(t0)
            except Exception:  # noqa: BLE001 - a profiler must never crash the host
                pass
            cost = time.monotonic() - t0
            # overhead accounting uses the sampler thread's own CPU
            # time: under load the thread is descheduled mid-tick, and
            # that parked wall time is not cost imposed on the host
            with self._lock:
                self._self_seconds += time.thread_time() - c0
                self._ticks += 1
                in_capture = (self._capture is not None
                              and not self._capture.closed)
            hz = CAPTURE_HZ if in_capture else HZ
            self._publish_overhead()
            self._stop_event.wait(max(0.0, (1.0 / hz) - cost))

    def _publish_overhead(self) -> None:
        if self._ticks % 16 != 0:
            return
        started = self._started_ts
        if started is None:
            return
        elapsed = max(1e-6, time.time() - started)
        from . import metrics as _tm

        _tm.PROFILE_OVERHEAD.set(min(1.0, self._self_seconds / elapsed))
        _tm.PROFILE_STACKS.set(len(self._stacks))

    def _thread_states(self) -> dict[int, tuple[str, float | None]]:
        """(kind, cpu-duty) per live thread ident, sampler excluded.
        Duty is None when the per-thread CPU clock is unavailable (first
        sight of a thread, or no pthread_getcpuclockid)."""
        self_ident = threading.get_ident()
        now_m = time.monotonic()
        out: dict[int, tuple[str, float | None]] = {}
        names = {t.ident: t.name for t in threading.enumerate()
                 if t.ident is not None}
        with self._lock:
            loop_idents = set(self._loop_idents)
        for ident, name in names.items():
            if ident == self_ident:
                continue
            if ident in loop_idents or name == "MainThread":
                kind = KIND_LOOP
            elif name.startswith("sd-window-pipeline"):
                kind = KIND_FEEDER
            elif name.startswith(("asyncio_", "ThreadPoolExecutor")):
                kind = KIND_WORKER
            else:
                kind = KIND_OTHER
            duty: float | None = None
            cpu = _thread_cpu_seconds(ident)
            if cpu is not None:
                prev = self._cpu_prev.get(ident)
                self._cpu_prev[ident] = (now_m, cpu)
                if prev is not None:
                    dt = now_m - prev[0]
                    if dt > 1e-6:
                        duty = max(0.0, (cpu - prev[1]) / dt)
            out[ident] = (kind, duty)
        # forget exited threads so the clock map stays bounded
        for gone in set(self._cpu_prev) - set(out):
            self._cpu_prev.pop(gone, None)
        return out

    def _tick(self, now_m: float) -> None:
        states = self._thread_states()
        frames = sys._current_frames()
        ts = time.time()
        records: list[tuple[str, str, str, str]] = []
        for ident, frame in frames.items():
            meta = states.get(ident)
            if meta is None:
                continue  # the sampler itself, or a thread born mid-tick
            kind, duty = meta
            names = fold_stack(frame)
            if not names:
                continue
            # a stack that is ALL thread scaffolding is a C-extension
            # thread (torch/onnx pools, C waiters) blocked below Python
            # — parked, not GIL-starved
            scaffold_only = all(n in _SCAFFOLD_FRAMES for n in names)
            if duty is not None and duty >= ON_CPU_DUTY:
                state = CPU
            elif scaffold_only or _leaf_is_waity(names):
                state = WAIT
            elif duty is None:
                # no per-thread clock: fall back to the leaf heuristic
                state = CPU
            else:
                state = GIL_WAIT
            group = classify_stack(names)
            records.append((kind, state, ";".join(names), group))
        del frames
        with self._lock:
            cap = self._capture
            if cap is not None and not cap.closed \
                    and now_m >= cap.until_monotonic:
                self._close_capture_locked(now_m)
                cap = None
            for kind, state, stack, group in records:
                key = (kind, state, stack)
                if key in self._stacks:
                    self._stacks[key] += 1
                elif len(self._stacks) < MAX_STACKS:
                    self._stacks[key] = 1
                else:
                    self._stacks_dropped += 1
                gk = (state, group)
                self._group_counts[gk] = self._group_counts.get(gk, 0) + 1
                self._kind_counts[kind] = self._kind_counts.get(kind, 0) + 1
                self._state_counts[state] = \
                    self._state_counts.get(state, 0) + 1
                self._total_samples += 1
                self._timeline.append((ts, kind, state, group))
                if cap is not None and not cap.closed:
                    if len(cap.samples) < CAPTURE_MAX_SAMPLES:
                        cap.samples.append((ts, kind, state, group))
                    cap.stack_counts[stack] = \
                        cap.stack_counts.get(stack, 0) + 1
        from . import metrics as _tm

        _tm.PROFILE_SAMPLES.inc(len(records))

    # -- reads ------------------------------------------------------------

    def samples_between(self, t0: float, t1: float) \
            -> list[tuple[float, str, str, str]]:
        """Timeline records with ``t0 <= ts <= t1`` — the attribution
        engine's gap-decomposition read path."""
        with self._lock:
            recs = list(self._timeline)
        return [r for r in recs if t0 <= r[0] <= t1]

    def folded(self, max_bytes: int = FOLDED_MAX_BYTES) -> str:
        """flamegraph.pl collapsed-stack text. Synthetic
        ``kind;state`` root frames prefix every stack so one flamegraph
        splits by thread kind and execution state; biggest stacks
        first, truncated at ``max_bytes`` (biggest-first means
        truncation drops only the tail of tiny stacks)."""
        with self._lock:
            items = sorted(self._stacks.items(), key=lambda kv: kv[1],
                           reverse=True)
        out: list[str] = []
        size = 0
        for (kind, state, stack), count in items:
            line = f"{kind};{state};{stack} {count}\n"
            size += len(line)
            if size > max_bytes:
                break
            out.append(line)
        return "".join(out)

    def group_shares(self) -> dict[str, float]:
        """Cumulative per-group sample shares over every state (the
        history allowlist's ``profile_share_*`` series)."""
        with self._lock:
            total = self._total_samples
            counts: dict[str, int] = {}
            for (_state, group), n in self._group_counts.items():
                counts[group] = counts.get(group, 0) + n
        if not total:
            return {}
        return {g: round(n / total, 6) for g, n in counts.items()}

    def profile(self, top_k: int = 24) -> dict[str, Any]:
        """The full JSON profile document (``GET /profile``)."""
        if not enabled():
            return {"enabled": False}
        with self._lock:
            total = self._total_samples
            started = self._started_ts
            group_counts = dict(self._group_counts)
            kind_counts = dict(self._kind_counts)
            state_counts = dict(self._state_counts)
            stacks_n = len(self._stacks)
            dropped = self._stacks_dropped
            captures = [c.to_doc() for c in self._captures]
            active = self._capture
            if active is not None and not active.closed:
                captures.append(active.to_doc())
            self_seconds = self._self_seconds
        duration = (time.time() - started) if started else 0.0
        groups: dict[str, dict[str, Any]] = {}
        for (state, group), n in group_counts.items():
            g = groups.setdefault(group, {"samples": 0, "states": {}})
            g["samples"] += n
            g["states"][state] = g["states"].get(state, 0) + n
        top = sorted(groups.items(), key=lambda kv: kv[1]["samples"],
                     reverse=True)[:top_k]
        return {
            "enabled": True,
            "running": self.running(),
            "hz": HZ,
            "started_ts": started,
            "duration_s": round(duration, 3),
            "samples": total,
            "threads": kind_counts,
            "states": state_counts,
            "stacks": stacks_n,
            "dropped_stacks": dropped,
            "overhead_ratio": round(
                self_seconds / duration, 6) if duration > 0 else 0.0,
            "frame_groups": [
                {
                    "group": g,
                    "samples": d["samples"],
                    "share": round(d["samples"] / total, 4) if total else 0.0,
                    "states": d["states"],
                }
                for g, d in top
            ],
            "captures": captures,
        }

    def summary(self, top_k: int = 5) -> dict[str, Any]:
        """The compact digest riding federation snapshots → ``GET
        /mesh``: totals, state split, top frame groups, capture count.
        Never stacks or paths — digests only, like ring digests."""
        if not enabled():
            return {"enabled": False}
        with self._lock:
            total = self._total_samples
            started = self._started_ts
            state_counts = dict(self._state_counts)
            group_counts = dict(self._group_counts)
            captures_n = len(self._captures)
            last = self._captures[-1].reason if self._captures else None
            if self._capture is not None and not self._capture.closed:
                captures_n += 1
                last = self._capture.reason
        counts: dict[str, int] = {}
        for (_state, group), n in group_counts.items():
            counts[group] = counts.get(group, 0) + n
        return {
            "enabled": True,
            "running": self.running(),
            "samples": total,
            "duration_s": round(time.time() - started, 3) if started else 0.0,
            "states": state_counts,
            "top_groups": [
                {"group": g, "share": round(n / total, 4)}
                for g, n in sorted(counts.items(), key=lambda kv: kv[1],
                                   reverse=True)[:top_k]
            ] if total else [],
            "captures": captures_n,
            "last_capture_reason": last,
        }

    def chrome_events(self) -> list[dict[str, Any]]:
        """Capture-window samples as Chrome-trace instant events on a
        dedicated ``host-profile`` lane, merged into ``GET /trace`` so
        Perfetto shows *what Python was doing* beside the span rows."""
        with self._lock:
            caps = list(self._captures)
            if self._capture is not None:
                caps.append(self._capture)
        pid = os.getpid()
        events: list[dict[str, Any]] = []
        if not caps:
            return events
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": 1,
            "args": {"name": "host-profile (triggered captures)"},
        })
        for cap in caps:
            events.append({
                "name": f"capture:{cap.reason}", "cat": "profile",
                "ph": "i", "s": "g",
                "ts": int(cap.opened_ts * 1e6), "pid": pid, "tid": 1,
                "args": {"reason": cap.reason, "hz": cap.hz,
                         "samples": len(cap.samples)},
            })
            for ts, kind, state, group in cap.samples:
                events.append({
                    "name": group, "cat": "profile", "ph": "i", "s": "t",
                    "ts": int(ts * 1e6), "pid": pid, "tid": 1,
                    "args": {"kind": kind, "state": state},
                })
        return events

    def captures_snapshot(self) -> list[dict[str, Any]]:
        with self._lock:
            docs = [c.to_doc() for c in self._captures]
            if self._capture is not None and not self._capture.closed:
                docs.append(self._capture.to_doc())
        return docs


def _thread_cpu_seconds(ident: int) -> float | None:
    """Another thread's cumulative CPU seconds via its pthread CPU
    clock, or None where the platform can't say (non-Linux, exited
    thread). The graceful-fallback half of the on-CPU classifier."""
    getclock = getattr(time, "pthread_getcpuclockid", None)
    if getclock is None:
        return None
    try:
        return time.clock_gettime(getclock(ident))
    except (OverflowError, OSError, ValueError):
        return None


#: the process-wide sampler every consumer reads
SAMPLER = Sampler()


def trigger(reason: str) -> bool:
    """Module-level trigger hook (SLO engine, loop-lag monitor, serve
    gate). No-op unless the sampler is enabled AND running."""
    return SAMPLER.trigger(reason)


def reset() -> None:
    SAMPLER.reset()


async def mesh_profile(node: Any) -> dict[str, Any]:
    """The mesh-wide profile view: this node's full profile plus every
    reachable peer's (pulled over the TELEMETRY wire's ``profile_pull``
    op). A vanished peer degrades the view to ``partial`` with the
    failure recorded — the trace_pull contract, never a block."""
    doc: dict[str, Any] = {
        "local": SAMPLER.profile(),
        "mesh": {},
        "partial": False,
    }
    manager = getattr(node, "p2p", None)
    if manager is not None:
        profiles, failures = await manager.pull_remote_profiles()
        doc["mesh"] = {
            label: p.get("profile") for label, p in profiles.items()
        }
        doc["partial"] = bool(failures)
        if failures:
            doc["pull_failures"] = failures
    return doc


# --- attribution decomposition -------------------------------------------


def decompose_segments(segments: list[tuple[float, float]],
                       bucket_seconds: float) -> dict[str, Any] | None:
    """Decompose one attribution bucket's wall time into named frame
    groups: timeline samples landing inside the bucket's critical-path
    segments vote by group, and the bucket's seconds split
    proportionally. ``coverage`` is the fraction of votes carrying a
    named (non-``other``) group — the honesty figure the ≥70% bar
    gates. Returns None when profiling is off or no sample landed in
    the window (the report simply omits the decomposition)."""
    if not enabled() or not segments:
        return None
    t_lo = min(s[0] for s in segments)
    t_hi = max(s[1] for s in segments)
    recs = SAMPLER.samples_between(t_lo, t_hi)
    if not recs:
        return None
    spans = sorted(segments)
    counts: dict[str, int] = {}
    total = 0
    import bisect

    starts = [s[0] for s in spans]
    for ts, _kind, state, group in recs:
        if state == WAIT:
            # a thread parked in select/locks/queues is not executing
            # the bucket — only runnable samples (on-CPU or GIL-wait)
            # vote, or every idle daemon thread would dilute the split
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i < 0 or ts > spans[i][1]:
            continue
        counts[group] = counts.get(group, 0) + 1
        total += 1
    if not total:
        return None
    named = total - counts.get("other", 0)
    return {
        "samples": total,
        "coverage": round(named / total, 4),
        "groups": {
            g: round(bucket_seconds * n / total, 6)
            for g, n in sorted(counts.items(), key=lambda kv: kv[1],
                               reverse=True)
        },
    }
