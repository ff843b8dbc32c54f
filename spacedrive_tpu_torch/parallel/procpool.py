"""Process pool: host decodes in worker processes, off the GIL.

Counterpart of `spacedrive_tpu/parallel/procpool.py`. The owner-side
half of the plane: a persistent pool of worker processes, each a fresh
``python -m spacedrive_tpu_torch.parallel.procworker`` interpreter
(started through `subprocess`: no fork, so no child inherits a CUDA
context; length-prefixed MessagePack frames over its stdio pipe, built
with the port's codec). The embed step's and the duplicate job's image
decodes ride it (`embed.decode`, `phash.gray`); the device work stays
in the owner.

- **lifecycle**: started with the Node and the task system, refcounted
  so two in-process nodes share one worker set. ``SD_PROCS`` sizes the
  pool (capped at ``MAX_PROCS``); ``SD_PROCS=0``, the default, spawns
  nothing and every call site runs its inline code;
- **shared-nothing jobs**: ``submit()`` packs the payload before it
  crosses the boundary, so a payload that is not MessagePack-plain
  raises `ProcPoolError` at the call site;
- **single-writer telemetry**: each result carries the worker's
  additive counter and histogram delta, merged into the owner's
  registry (`registry.merge_delta`);
- **recovery**: a worker that dies is restarted once and its in-flight
  jobs are re-dispatched once (a twice-fatal job fails its future); a
  watchdog kills a worker that holds a job past ``WEDGE_TIMEOUT_S``.
  Every call site falls back to its inline path on `ProcPoolError`, and
  every failure is counted (``sd_procpool_jobs_total{result="error"}``
  or ``{result="retried"}``, ``sd_procpool_restarts_total``). The
  ``procpool.worker`` fault point (modes ``crash`` and ``stall``)
  drives these paths.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from typing import Any

from ..telemetry import metrics as _tm
from ..telemetry.registry import REGISTRY
from ..utils import faults as _faults
from ..utils import msgpack_codec as _codec
from . import procworker as _wire

logger = logging.getLogger(__name__)

#: hard cap on SD_PROCS: a fat-fingered value must not fork-bomb a host
MAX_PROCS = 64

#: per-job result timeout of the synchronous waiters (seconds); a stalled
#: worker is recovered by the watchdog, not by waiters
REQUEST_TIMEOUT_S = 120.0

#: a worker holding any job older than this is wedged (a hung C call),
#: not slow: the watchdog kills it, and the death path restarts it and
#: re-dispatches its jobs once
WEDGE_TIMEOUT_S = 300.0
#: watchdog poll cadence
_WATCHDOG_INTERVAL_S = 5.0


def procs() -> int:
    """``SD_PROCS`` worker count; 0 (the default) disables the pool."""
    try:
        n = int(os.environ.get("SD_PROCS", "0"))
    except ValueError:
        return 0
    return max(0, min(MAX_PROCS, n))


def enabled() -> bool:
    return procs() > 0


def rig_stamp() -> dict:
    """Host execution-rig facts a bench record carries, so a comparator
    can tell a one-core run from a scaling regression before gating
    any parallelism ratio (JAX `procpool.rig_stamp`)."""
    return {
        "cpu_count": os.cpu_count() or 1,
        "procpool_procs": procs(),
    }


class ProcPoolError(RuntimeError):
    """A pool-side failure (worker error, death past the retry budget,
    pool stopped, an unpackable payload). Call sites catch it and run
    their inline path."""


class _Job:
    __slots__ = ("id", "stage", "blob", "rows", "stall_s", "future", "t_submit", "retried")

    def __init__(self, job_id: int, stage: str, blob: bytes, rows: int):
        self.id = job_id
        self.stage = stage
        self.blob = blob
        self.rows = rows
        self.stall_s = 0.0
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.retried = False


class _Worker:
    """One subprocess, its reader thread and its write lock."""

    __slots__ = ("index", "proc", "reader", "wlock", "inflight", "gen")

    def __init__(self, index: int):
        self.index = index
        self.proc: subprocess.Popen | None = None
        self.reader: threading.Thread | None = None
        self.wlock = threading.Lock()
        self.inflight: set[int] = set()
        self.gen = 0  # bumped per restart so stale readers exit


class ProcPool:
    """The process-wide pool (:data:`POOL`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._refs = 0
        self._running = False
        self._workers: list[_Worker] = []
        self._jobs: dict[int, _Job] = {}
        self._job_seq = itertools.count(1)
        self._size = 0
        self._watchdog: threading.Thread | None = None
        self._stop_event = threading.Event()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> bool:
        """Add one hold; the first hold spawns the workers. Returns True
        when the pool runs after the call (False under ``SD_PROCS=0``,
        which spawns nothing)."""
        n = procs()
        if n <= 0:
            return False
        with self._lock:
            self._refs += 1
            if self._running:
                return True
            self._size = n
            self._workers = [_Worker(i) for i in range(n)]
            self._running = True
            for w in self._workers:
                self._spawn_locked(w)
            self._stop_event.clear()
            self._watchdog = threading.Thread(target=self._watch, name="sd-procpool-watchdog",
                                              daemon=True)
            self._watchdog.start()
            _tm.PROCPOOL_WORKERS.set(n)
            return True

    def _spawn_locked(self, w: _Worker) -> None:
        """(Re)launch one worker subprocess and its reader thread."""
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env.pop("SD_FAULTS", None)  # the owner drives worker faults
        env["CUDA_VISIBLE_DEVICES"] = ""  # a worker never touches a card
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        w.proc = subprocess.Popen(
            [sys.executable, "-m", "spacedrive_tpu_torch.parallel.procworker"],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=None,  # worker logs and tracebacks pass through
            env=env,
        )
        w.gen += 1
        w.reader = threading.Thread(target=self._read_loop, args=(w, w.proc, w.gen),
                                    name=f"sd-procpool-r{w.index}", daemon=True)
        w.reader.start()

    def stop(self) -> None:
        """Release one hold; the last release stops the workers and fails
        every outstanding future (call sites fall back inline)."""
        with self._lock:
            self._refs = max(0, self._refs - 1)
            if self._refs > 0:
                return
            self._running = False
            self._stop_event.set()
            workers, self._workers = self._workers, []
            jobs, self._jobs = dict(self._jobs), {}
        for w in workers:
            proc = w.proc
            if proc is None:
                continue
            try:
                proc.stdin.close()  # EOF = clean worker shutdown
            except OSError:
                pass
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=2.0)
        for w in workers:
            if w.reader is not None and w.reader.is_alive():
                w.reader.join(timeout=2.0)
        watchdog, self._watchdog = self._watchdog, None
        if watchdog is not None and watchdog.is_alive():
            watchdog.join(timeout=2.0)
        for job in jobs.values():
            if not job.future.done():
                job.future.set_exception(ProcPoolError("pool stopped"))
        _tm.PROCPOOL_WORKERS.set(0)

    def running(self) -> bool:
        with self._lock:
            return self._running

    def worker_count(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers if w.proc is not None and w.proc.poll() is None)

    # -- dispatch ---------------------------------------------------------

    def submit(self, stage: str, payload: Any, rows: int = 1) -> Future:
        """Ship one shared-nothing job; returns a concurrent Future of the
        stage's result dict. The payload is packed here (MessagePack-plain
        or `ProcPoolError`); raises `ProcPoolError` when the pool is not
        running."""
        t0 = time.perf_counter()
        try:
            blob = _codec.packb(payload)
        except _codec.MsgpackError as exc:
            raise ProcPoolError(
                f"procpool payload for {stage!r} is not MessagePack-plain: {exc}") from exc
        with self._lock:
            if not self._running:
                raise ProcPoolError("pool not running")
            job = _Job(next(self._job_seq), stage, blob, rows)
            w = self._pick_locked()
            spec = _faults.hit("procpool.worker")
            if spec is not None and spec.mode == "stall":
                job.stall_s = spec.delay_s
            self._jobs[job.id] = job
            w.inflight.add(job.id)
            kill = w.proc if spec is not None and spec.mode == "crash" else None
        self._send(w, job)
        if kill is not None:
            # a simulated death mid-job: the reader sees EOF, restarts
            # the worker once and re-dispatches its jobs
            kill.kill()
        _tm.PROCPOOL_DISPATCH_SECONDS.observe(time.perf_counter() - t0)
        _tm.PROCPOOL_BATCH_ROWS.observe(rows)
        return job.future

    def _pick_locked(self) -> _Worker:
        return min(self._workers, key=lambda w: len(w.inflight))

    def _send(self, w: _Worker, job: _Job) -> None:
        """Frame one job onto a worker's stdin. A write failure means the
        worker is dead or dying: its reader owns the recovery, so the job
        stays in flight until the reaper re-dispatches it."""
        frame = _codec.packb([job.id, job.stage, job.blob, job.stall_s])
        try:
            with w.wlock:
                if w.proc is not None and w.proc.stdin is not None:
                    _wire.write_frame(w.proc.stdin, frame)
        except (OSError, ValueError):
            pass  # the reader's reaper re-dispatches this job

    def request(self, stage: str, payload: Any, rows: int = 1,
                timeout: float | None = None) -> Any:
        """Synchronous round trip (from a worker thread). Raises
        `ProcPoolError` on any pool-side failure or timeout."""
        fut = self.submit(stage, payload, rows)
        try:
            return fut.result(timeout or REQUEST_TIMEOUT_S)
        except ProcPoolError:
            raise
        except Exception as exc:  # noqa: BLE001 - timeout/cancel → pool error
            raise ProcPoolError(f"procpool {stage} failed: {exc!r}") from exc

    async def run(self, stage: str, payload: Any, rows: int = 1) -> Any:
        """Event-loop-side round trip."""
        fut = self.submit(stage, payload, rows)
        try:
            return await asyncio.wrap_future(fut)
        except ProcPoolError:
            raise
        except Exception as exc:  # noqa: BLE001 - normalize for callers
            raise ProcPoolError(f"procpool {stage} failed: {exc!r}") from exc

    # -- per-worker reader (results and recovery) -------------------------

    def _read_loop(self, w: _Worker, proc: subprocess.Popen, gen: int) -> None:
        try:
            while True:
                frame = _wire.read_frame(proc.stdout)
                if frame is None:
                    break  # EOF: the worker exited (or was killed)
                try:
                    parsed = _codec.unpackb(frame)
                except _codec.MsgpackError:
                    parsed = None
                if not isinstance(parsed, list) or len(parsed) != 4:
                    # a torn frame leaves the stream unframed: treat it
                    # as a death, never spin on garbage
                    break
                job_id, ok, body, delta_blob = parsed
                self._finish(w, job_id, ok, body, delta_blob)
        except (EOFError, OSError, ValueError):
            pass
        self._reap(w, proc, gen)

    def _finish(self, w: _Worker, job_id: int, ok: bool, body: bytes, delta_blob: bytes) -> None:
        with self._lock:
            job = self._jobs.pop(job_id, None)
            w.inflight.discard(job_id)
        if job is None:
            return  # a late duplicate of a re-dispatched job
        try:
            REGISTRY.merge_delta(_codec.unpackb(delta_blob))
        except Exception:  # noqa: BLE001 - delta drift must not kill results
            logger.exception("procpool telemetry delta merge failed")
        _tm.PROCPOOL_ROUNDTRIP_SECONDS.observe(time.monotonic() - job.t_submit)
        try:
            result = _codec.unpackb(body)
        except Exception:  # noqa: BLE001 - a torn body is a job error
            result, ok = {"error": "undecodable result"}, False
        if ok:
            _tm.PROCPOOL_JOBS.inc(result="ok")
            if not job.future.done():
                job.future.set_result(result)
        else:
            _tm.PROCPOOL_JOBS.inc(result="error")
            error = result.get("error") if isinstance(result, dict) else result
            logger.warning("procpool worker %d failed %s: %s", w.index, job.stage, error)
            if not job.future.done():
                job.future.set_exception(
                    ProcPoolError(f"worker {w.index} failed {job.stage}: {error}"))

    def _reap(self, w: _Worker, proc: subprocess.Popen, gen: int) -> None:
        """The worker behind ``gen`` is gone: restart it (if the pool is
        still running) and re-dispatch its in-flight jobs, once each."""
        try:
            proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            proc.kill()
        redispatch: list[_Job] = []
        failed: list[_Job] = []
        with self._lock:
            if not self._running or w.gen != gen:
                return  # the pool is stopping, or a newer generation owns `w`
            for job_id in sorted(w.inflight):
                job = self._jobs.get(job_id)
                if job is None:
                    continue
                if job.retried:
                    self._jobs.pop(job_id, None)
                    failed.append(job)
                else:
                    job.retried = True
                    redispatch.append(job)
            w.inflight.clear()
            self._spawn_locked(w)
            _tm.PROCPOOL_RESTARTS.inc()
            _tm.PROCPOOL_WORKERS.set(self._size)
            targets: list[tuple[_Worker, _Job]] = []
            for job in redispatch:
                tgt = self._pick_locked()
                tgt.inflight.add(job.id)
                targets.append((tgt, job))
                _tm.PROCPOOL_JOBS.inc(result="retried")
        logger.warning("procpool worker %d died; restarted (re-dispatching %d, failing %d)",
                       w.index, len(redispatch), len(failed))
        for tgt, job in targets:
            self._send(tgt, job)
        for job in failed:
            if not job.future.done():
                job.future.set_exception(ProcPoolError(f"job {job.stage} died twice; giving up"))

    # -- watchdog (wedged-worker recovery) --------------------------------

    def _watch(self) -> None:
        """Kill any worker that has held a job past WEDGE_TIMEOUT_S: a
        hung C call never returns to the frame loop, so the reader's
        EOF-driven reap cannot see it. Killing turns the wedge into an
        ordinary death (restart, re-dispatch once)."""
        while not self._stop_event.wait(_WATCHDOG_INTERVAL_S):
            now = time.monotonic()
            wedged: list[Any] = []
            with self._lock:
                if not self._running:
                    return
                for w in self._workers:
                    if w.proc is None or w.proc.poll() is not None:
                        continue  # dead already: the reader owns it
                    oldest = min((self._jobs[jid].t_submit for jid in w.inflight
                                  if jid in self._jobs), default=None)
                    if oldest is not None and now - oldest > WEDGE_TIMEOUT_S:
                        wedged.append(w.proc)
            for proc in wedged:
                logger.warning("procpool worker wedged past %.0fs; killing", WEDGE_TIMEOUT_S)
                proc.kill()

    # -- warm-up ----------------------------------------------------------

    def warm(self, timeout: float = 30.0) -> None:
        """Block until every worker answered one echo, so spawn and import
        cost never lands inside a timed window."""
        futs = [self.submit("echo", {"i": i}) for i in range(self._size)]
        for f in futs:
            try:
                f.result(timeout)
            except Exception:  # noqa: BLE001 - a dead worker reaps later
                pass


#: the process-wide pool: Node.start and TaskSystem.start take a
#: refcounted hold; tests may hold it directly
POOL = ProcPool()


def get() -> ProcPool | None:
    """The running pool, or None: the one call-site gate. Every consumer
    does ``pool = procpool.get()`` and runs its inline code when this is
    None (SD_PROCS=0, the pool not started, or stopped)."""
    return POOL if POOL.running() else None
