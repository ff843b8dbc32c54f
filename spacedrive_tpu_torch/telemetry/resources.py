"""Resource-growth observability — the slow leaks a short run never sees.

An owned copy of `spacedrive_tpu/telemetry/resources.py`. A low-rate
resource sampler (refcounted with the Node like the host profiler in
``telemetry/sampler.py``) reads the process's own growth surfaces and
publishes them as ``sd_resource_*`` gauges:

- ``/proc/self`` facts: RSS bytes, open-fd count, OS thread count
  (portable fallbacks where /proc is absent);
- the process pool's worker RSS, summed over its live workers
  (``/proc/<pid>/statm``);
- in-process inventories over a **fixed kind vocabulary**
  (:data:`INVENTORY_KINDS`): index-journal and op-log row counts,
  serve-cache entries/bytes, history-store bytes — registered by the
  Node as providers (:func:`node_providers`, JAX's SQL) — plus the
  built-in flight-ring drop total.

The history writer samples the gauges into the persistent store
(``resource_*`` series), where the trend SLO class
(``telemetry/slo.py``) judges bounded growth slopes; a trend breach
turns the ``resources`` health subsystem unhealthy.

``SD_RESOURCES=0`` is a true no-op: ``start()`` spawns nothing, no
``resource_*`` history series, no trend SLOs, and pass output is
bit-identical either way. ``SD_RESOURCE_INTERVAL_S`` sets the sampling
interval (default 5 s). ``telemetry.reset()`` clears the last-sample
state and releases test-planted leaks; registered providers are node
lifecycle, not data, and survive it.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable

DEFAULT_INTERVAL_S = 5.0

#: the fixed inventory vocabulary — the ``kind`` label domain of
#: ``sd_resource_inventory`` (SD007: label sets stay enum-like).
#: ``ring_drops`` is built-in; the rest are node-registered providers.
INVENTORY_KINDS = ("journal_rows", "oplog_rows", "serve_cache_entries",
                   "serve_cache_bytes", "history_bytes", "ring_drops")


def enabled() -> bool:
    return os.environ.get("SD_RESOURCES", "1") != "0"


def interval_s() -> float:
    raw = os.environ.get("SD_RESOURCE_INTERVAL_S")
    if raw is None:
        return DEFAULT_INTERVAL_S
    try:
        return min(3600.0, max(0.05, float(raw)))
    except ValueError:
        return DEFAULT_INTERVAL_S


# --- /proc readers (portable fallbacks, never raise) ----------------------


def _proc_status() -> tuple[float, float]:
    """(rss_bytes, thread_count) from ``/proc/self/status``; falls back
    to ``resource.getrusage`` + ``threading.active_count`` off-Linux."""
    rss = 0.0
    threads = 0.0
    try:
        with open("/proc/self/status", encoding="ascii",
                  errors="replace") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = float(line.split()[1]) * 1024.0
                elif line.startswith("Threads:"):
                    threads = float(line.split()[1])
    except OSError:
        pass
    if rss == 0.0:
        try:
            import resource as _resource

            # ru_maxrss is KiB on Linux (peak, not current — an honest
            # upper bound where /proc is missing)
            rss = float(
                _resource.getrusage(_resource.RUSAGE_SELF).ru_maxrss
            ) * 1024.0
        except Exception:  # noqa: BLE001 - resource reads degrade, never fail
            pass
    if threads == 0.0:
        threads = float(threading.active_count())
    return rss, threads


def fd_count() -> float:
    try:
        return float(len(os.listdir("/proc/self/fd")))
    except OSError:
        return 0.0


def _pid_rss_bytes(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/statm", encoding="ascii") as f:
            pages = int(f.read().split()[1])
        return float(pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, IndexError, ValueError):
        return 0.0


def _procpool_rss() -> float:
    """Summed RSS of the multi-process plane's live workers (0 with
    SD_PROCS=0 — the pool spawned nothing)."""
    from ..parallel import procpool as _procpool

    total = 0.0
    for w in list(getattr(_procpool.POOL, "_workers", ())):
        proc = getattr(w, "proc", None)
        pid = getattr(proc, "pid", None)
        if pid is not None and proc.poll() is None:
            total += _pid_rss_bytes(pid)
    return total


def _ring_drops() -> float:
    from . import events as _events

    return float(sum(_events.drop_counts().values()))


# --- the sampler ----------------------------------------------------------


class ResourceSampler:
    """The process-wide resource sampler. One instance per process
    (:data:`SAMPLER`); ``start``/``stop`` are refcounted because two
    in-process nodes (the loopback test mesh) share one address space —
    RSS and fds are process facts, so the first stop must not blind
    the survivor."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop_event = threading.Event()
        self._refs = 0
        #: node-registered inventory readers, name ∈ INVENTORY_KINDS
        self._providers: dict[str, Callable[[], float]] = {}
        #: most recent published sample (health signals read this)
        self._last: dict[str, float] = {}
        self._last_ts: float | None = None
        self._samples = 0
        # test-leak hook state: REAL stranded fds + byte buffers, so
        # the planted-leak test proves the whole chain (kernel fd table
        # → /proc read → gauge → history → trend SLO → health/capture)
        self._leaked_fds: list[int] = []
        self._leaked_blobs: list[bytearray] = []

    # -- lifecycle --------------------------------------------------------

    def start(self) -> bool:
        """Add one hold; the first hold spawns the thread. Returns True
        when sampling is running after the call (False under
        ``SD_RESOURCES=0`` — a true no-op)."""
        if not enabled():
            return False
        with self._lock:
            self._refs += 1
            if self._thread is not None and self._thread.is_alive():
                return True
            self._stop_event.clear()
            self._thread = threading.Thread(
                target=self._run, name="sd-resources", daemon=True,
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

    def _run(self) -> None:
        while not self._stop_event.is_set():
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - a sampler must never crash the host
                pass
            self._stop_event.wait(interval_s())

    # -- providers --------------------------------------------------------

    def register_provider(self, name: str,
                          fn: Callable[[], float]) -> None:
        """Register one inventory reader under a fixed kind. Last
        registration wins (a restarted node re-registers over its own
        previous closure)."""
        if name not in INVENTORY_KINDS:
            raise ValueError(
                f"unknown inventory kind {name!r} "
                f"(kinds: {', '.join(INVENTORY_KINDS)})"
            )
        with self._lock:
            self._providers[name] = fn

    def unregister_provider(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    # -- sampling ---------------------------------------------------------

    def sample_once(self, now: float | None = None) -> dict[str, float]:
        """Take one sample: read /proc + every registered inventory,
        publish the gauges, remember the values. Individual provider
        failures degrade to 0 for that kind — one broken inventory must
        not blind the others. Callable synchronously (tests, the soak
        harness's deterministic clock); the thread calls it on its
        interval."""
        from . import metrics as _tm

        rss, threads = _proc_status()
        fds = fd_count()
        pool_rss = _procpool_rss()
        with self._lock:
            providers = dict(self._providers)
        # every kind always present: absent providers read an explicit
        # 0 in the returned values too, so readers (the soak harness)
        # never key-error on a node that hasn't registered inventories
        inv: dict[str, float] = dict.fromkeys(INVENTORY_KINDS, 0.0)
        inv["ring_drops"] = _ring_drops()
        for name, fn in providers.items():
            try:
                inv[name] = float(fn())
            except Exception:  # noqa: BLE001 - providers degrade, never fail
                inv[name] = 0.0
        _tm.RESOURCE_RSS.set(rss)
        _tm.RESOURCE_FDS.set(fds)
        _tm.RESOURCE_THREADS.set(threads)
        _tm.RESOURCE_PROCPOOL_RSS.set(pool_rss)
        # one literal call site per kind: the label domain is fixed by
        # construction (SD007) and absent providers read an explicit 0
        _tm.RESOURCE_INVENTORY.set(inv.get("journal_rows", 0.0),
                                   kind="journal_rows")
        _tm.RESOURCE_INVENTORY.set(inv.get("oplog_rows", 0.0),
                                   kind="oplog_rows")
        _tm.RESOURCE_INVENTORY.set(inv.get("serve_cache_entries", 0.0),
                                   kind="serve_cache_entries")
        _tm.RESOURCE_INVENTORY.set(inv.get("serve_cache_bytes", 0.0),
                                   kind="serve_cache_bytes")
        _tm.RESOURCE_INVENTORY.set(inv.get("history_bytes", 0.0),
                                   kind="history_bytes")
        _tm.RESOURCE_INVENTORY.set(inv.get("ring_drops", 0.0),
                                   kind="ring_drops")
        values = {
            "rss_bytes": rss,
            "fds": fds,
            "threads": threads,
            "procpool_rss_bytes": pool_rss,
            **inv,
        }
        with self._lock:
            self._last = values
            self._last_ts = now if now is not None else time.time()
            self._samples += 1
        return values

    # -- reads ------------------------------------------------------------

    def last(self) -> dict[str, float]:
        with self._lock:
            return dict(self._last)

    def last_ts(self) -> float | None:
        with self._lock:
            return self._last_ts

    def sample_count(self) -> int:
        with self._lock:
            return self._samples

    def summary(self) -> dict[str, Any]:
        """The compact digest the ``resources`` health subsystem embeds
        (and federation therefore ships): last values + sample count,
        never paths or identifiers."""
        if not enabled():
            return {"enabled": False}
        with self._lock:
            return {
                "enabled": True,
                "running": self.running(),
                "samples": self._samples,
                "last_ts": self._last_ts,
                "last": dict(self._last),
            }

    # -- test-leak hook ----------------------------------------------------

    def leak_for_test(self, fds: int = 0, mb: int = 0) -> None:
        """Strand real resources so the planted-leak test exercises the
        actual /proc read path, not a mock: ``fds`` open descriptors on
        /dev/null, ``mb`` MiB of live bytearray. Released by
        :meth:`release_leaks` (which ``reset()`` calls)."""
        with self._lock:
            for _ in range(fds):
                self._leaked_fds.append(os.open(os.devnull, os.O_RDONLY))
            if mb:
                self._leaked_blobs.append(bytearray(mb << 20))

    def release_leaks(self) -> None:
        with self._lock:
            fds, self._leaked_fds = self._leaked_fds, []
            self._leaked_blobs.clear()
        for fd in fds:
            try:
                os.close(fd)
            except OSError:
                pass

    def reset(self) -> None:
        """Test isolation (rides ``telemetry.reset()``): drop the
        last-sample state and release planted leaks. Providers,
        refcounts and the thread survive — reset is about *data*, not
        lifecycle (the profiler's contract)."""
        self.release_leaks()
        with self._lock:
            self._last = {}
            self._last_ts = None
            self._samples = 0


#: the process-wide resource sampler every consumer reads
SAMPLER = ResourceSampler()


def reset() -> None:
    SAMPLER.reset()


def node_providers(node: Any) -> dict[str, Callable[[], float]]:
    """The inventory readers a Node registers at start (and
    unregisters at shutdown): each needs node state the module can't
    reach on its own. Every closure is defensive — a mid-shutdown
    read returns 0, never raises into the sampler thread."""

    def _sum_over_libraries(sql: str) -> float:
        total = 0.0
        for lib in list(
            getattr(getattr(node, "libraries", None), "libraries",
                    {}).values()
        ):
            try:
                row = lib.db.query_one(sql)
                total += float(next(iter(row.values())) or 0)
            except Exception:  # noqa: BLE001 - inventory reads degrade, never fail
                continue
        return total

    def journal_rows() -> float:
        return _sum_over_libraries(
            "SELECT COUNT(*) AS n FROM index_journal")

    def oplog_rows() -> float:
        return _sum_over_libraries(
            "SELECT COUNT(*) AS n FROM crdt_operation")

    def _serve_snapshots() -> list[dict[str, Any]]:
        serve = getattr(node, "serve", None)
        if serve is None:
            return []
        out = []
        for region in ("queries", "thumbs", "meta"):
            cache = getattr(serve, region, None)
            if cache is not None:
                try:
                    out.append(cache.snapshot())
                except Exception:  # noqa: BLE001 - inventory reads degrade
                    continue
        return out

    def serve_cache_entries() -> float:
        return float(sum(s.get("entries", 0) for s in _serve_snapshots()))

    def serve_cache_bytes() -> float:
        return float(sum(s.get("weight", 0) for s in _serve_snapshots()))

    def history_bytes() -> float:
        directory = getattr(getattr(node, "history", None), "dir", None)
        if not directory:
            return 0.0
        total = 0.0
        try:
            for name in os.listdir(directory):
                try:
                    total += os.path.getsize(os.path.join(directory, name))
                except OSError:
                    continue
        except OSError:
            return 0.0
        return total

    return {
        "journal_rows": journal_rows,
        "oplog_rows": oplog_rows,
        "serve_cache_entries": serve_cache_entries,
        "serve_cache_bytes": serve_cache_bytes,
        "history_bytes": history_bytes,
    }
