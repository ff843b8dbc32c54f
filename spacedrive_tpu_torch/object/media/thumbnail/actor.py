"""The node-wide thumbnailer actor.

Counterpart of `spacedrive_tpu/object/media/thumbnail/actor.py`
(ref:core/src/object/media/thumbnail/{actor.rs,worker.rs,process.rs}):
a node-global actor outside the job system; jobs dispatch batches and
only await them. Foreground batches are a LIFO stack, background
batches a FIFO queue (state.rs:23-32); background work is throttled to
`background_percentage`% of the cores (process.rs:105-128; 50 unless
the node sets it, `set_background_percentage`);
each decode gets a 30 s timeout (process.rs:172); queues persist across
crashes (state.rs); `NewThumbnail` events go to the node's event bus.

A batch is processed in chunks of `_device_chunk()` images (the
"thumbnail" policy's `thumb_chunk_rows(cards)`, parallel/autotune.py,
read once per batch; an explicit `chunk_rows` wins) as a 3-deep
pipeline: host decode on
threads → one resize call per chunk on the actor's `device`
(object/media/thumbnail/process.resize_decoded) → webp encode and store
on threads. Images beyond a 4:1 aspect resize on the host
(`process.needs_cpu_fallback`), as in the JAX actor.

On a device that rides the degradation ladder ("cuda", parallel/mesh)
a chunk whose device resize failed past the ladder degrades, as in the
JAX actor: it takes the same resize on the CPU
(`process.resize_decoded` on a `[cpu]` slot list, within one level of
the device's pixels; the JAX actor uses PIL there), emits
`thumbnail_cpu_fallback` on the resilience ring and logs a WARNING. On a pinned device the
failure is the batch's: the actor records it, and the first waiter
that sees it (`wait_batch` for that batch, or `wait_library_batch` for
its namespace) raises `ThumbnailerError` and clears it, so later
batches report only their own failures. A file that fails to decode
only counts in `errors`. The `thumbnail.persist` fault point sits in
the window between a chunk's store and its accounting.

With `use_device=False` (the JAX actor's flag; default true; a Node on
"cpu" sets it, node/node.py) every image takes the software path: decode, the host resize (`resize_cpu`)
and the encode, inline, or as `thumb.cpu` jobs on the process pool
(parallel/procpool.py) when one is up: `generate_one_cpu` in the worker,
one job per image, so the stored bytes are the inline path's. A job
the pool fails (a dead worker, a timeout) is retried inline once. A
device actor never takes that leg: the pool never owns the card.

Every kind the host half decodes (object/media/thumbnail/host.py:
still images, HEIF, video frames, PDF and SVG pages) takes the same
path; a video frame carries its film strip from `finish` and from
`resize_cpu` alike. A failed build of the video frontend
(NativeBuildError) fails the batch instead of counting as a bad file.

Not ported: telemetry and trace context.
`stage_seconds` keeps the decode / device / encode totals the JAX actor
observes into its stage histogram, and the batches' wall time.
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import logging
import os
import secrets
import time
from typing import Any, Sequence

import torch

from ....native.build import NativeBuildError
from ....parallel import autotune as _autotune
from ....parallel import mesh as _mesh
from ....parallel import procpool as _procpool
from ....telemetry.events import RESILIENCE_EVENTS
from ....utils import faults as _faults
from .process import (
    Decoded,
    can_generate,
    decode,
    finish,
    generate_one_cpu,
    needs_cpu_fallback,
    resize_cpu,
    resize_decoded,
)
from .state import Batch, load_state, save_state
from .store import ThumbnailStore, get_shard_hex

logger = logging.getLogger(__name__)

GENERATION_TIMEOUT_S = 30  # ref:process.rs:172


class ThumbnailerError(RuntimeError):
    """A dispatched batch failed (its device resize on a pinned device,
    or the video frontend's build)."""


class Thumbnailer:
    """`Node.thumbnailer`; see the module docstring for the contract."""

    def __init__(
        self,
        data_dir: str | os.PathLike,
        event_bus: Any = None,
        device: str | torch.device = "cuda",
        use_device: bool = True,
    ):
        self.data_dir = os.fspath(data_dir)
        os.makedirs(self.data_dir, exist_ok=True)
        self.store = ThumbnailStore(self.data_dir)
        self.event_bus = event_bus
        self.device = torch.device(device)
        #: False: the software path for every image (module docstring)
        self.use_device = use_device
        cores = os.cpu_count() or 1
        self._fg_parallelism = cores
        self.background_percentage = 50  # ref:actor.rs:98
        self._bg_parallelism = max(1, cores * self.background_percentage // 100)
        #: an explicit images-per-resize-call override; None reads the
        #: live "thumbnail" policy per batch (`_device_chunk`)
        self.chunk_rows: int | None = None
        self._fg: collections.deque[Batch] = collections.deque()  # LIFO
        self._bg: collections.deque[Batch] = collections.deque()  # FIFO
        self._current: Batch | None = None  # in flight (for persistence)
        # random base, so a batch id persisted in a resumed job's state
        # cannot collide with a fresh id of this process
        self._batch_ids = itertools.count((secrets.randbits(40) << 20) | 1)
        self._batch_pending: collections.Counter[int] = collections.Counter()
        self._pending: collections.Counter[str] = collections.Counter()
        # failed batches not yet reported: batch id -> (namespace, error)
        self._failed: dict[int, tuple[str, str]] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._cond: asyncio.Condition | None = None
        self._wake: asyncio.Event | None = None
        self._worker: asyncio.Task | None = None
        self._stopped = False
        self.generated = 0
        self.skipped = 0
        self.errors = 0
        #: seconds in each pipeline stage, summed over chunks (the stages
        #: overlap), and in whole batches ("batch", wall time)
        self.stage_seconds = {"decode": 0.0, "device": 0.0, "encode": 0.0, "batch": 0.0}
        # Crash recovery: queued batches resume as background work and
        # are re-persisted at once. Entries whose thumbnail already
        # landed in the store are dropped: a crash between a chunk's
        # store and its accounting leaves that prefix in the state.
        for b in load_state(self.data_dir):
            kept = [e for e in b.entries if not self.store.exists(b.library_id, e[0])]
            self.skipped += len(b.entries) - len(kept)
            if not kept:
                continue
            b.entries = kept
            b.background = True
            b.id = next(self._batch_ids)
            self._bg.append(b)
            self._pending[self._ns(b.library_id)] += len(kept)
            self._batch_pending[b.id] = len(kept)
        self._save()

    # ---- lifecycle -----------------------------------------------------
    def _ns(self, library_id: str | None) -> str:
        return self.store.namespace(library_id)

    def _save(self) -> None:
        batches = list(self._fg) + list(self._bg)
        if self._current is not None and self._current.entries:
            batches.insert(0, self._current)
        save_state(self.data_dir, batches)

    def _ensure_started(self) -> None:
        """Bind to the running loop and start the worker (actor model:
        one worker). A new loop (one `asyncio.run` per scan) gets fresh
        primitives bound to it."""
        if self._stopped:
            return
        loop = asyncio.get_running_loop()
        if self._loop is not loop:
            self._loop = loop
            self._cond = asyncio.Condition()
            self._wake = asyncio.Event()
            self._worker = None
        if self._worker is None or self._worker.done():
            self._worker = loop.create_task(self._run(), name="thumbnailer")
            if self._fg or self._bg:
                self._wake.set()

    def _kick(self) -> None:
        self._ensure_started()
        self._wake.set()

    def _kick_on_loop(self) -> None:
        try:
            self._kick()
        except RuntimeError:
            pass  # loop shutting down

    async def shutdown(self) -> None:
        """Persist unprocessed batches (the in-flight remainder too) and
        stop (ref:state.rs:47-75)."""
        self._stopped = True
        if self._loop is not asyncio.get_running_loop():
            self._save()  # the worker died with its loop
            return
        self._wake.set()
        if self._worker is not None:
            try:
                await asyncio.wait_for(asyncio.shield(self._worker), timeout=60)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                self._worker.cancel()
                try:
                    await self._worker
                except asyncio.CancelledError:
                    pass
        self._save()
        # unblock rendezvous waiters: with the actor stopped their work
        # will never drain
        if self._cond is not None:
            async with self._cond:
                self._cond.notify_all()

    # ---- dispatch API (ref:actor.rs new_*_thumbnails_batch) ------------
    def set_background_percentage(self, pct: int) -> None:
        """Re-derive background parallelism from a percentage of cores
        (ref:actor.rs:98 `background_processing_percentage` update)."""
        cores = os.cpu_count() or 1
        self.background_percentage = max(0, min(100, pct))
        self._bg_parallelism = max(1, cores * self.background_percentage // 100)

    def new_indexed_thumbnails_batch(
        self,
        library_id: Any,
        entries: Sequence[tuple[str, str] | tuple[str, str, str]],
        background: bool = False,
    ) -> int:
        """entries: (cas_id, path[, extension]); returns a batch id for
        `wait_batch`, or 0 if nothing was queued."""
        return self._enqueue(library_id, entries, background)

    def new_ephemeral_thumbnails_batch(
        self, entries: Sequence[tuple[str, str] | tuple[str, str, str]]
    ) -> int:
        return self._enqueue(None, entries, background=False)

    def _enqueue(self, library_id, entries, background) -> int:
        library_id = str(library_id) if library_id is not None else None
        norm: list[tuple[str, str, str]] = []
        for e in entries:
            cas_id, path = e[0], e[1]
            ext = e[2] if len(e) > 2 else os.path.splitext(path)[1].lstrip(".").lower()
            if not cas_id or not can_generate(ext):
                continue
            if self.store.exists(library_id, cas_id):
                self.skipped += 1
                continue
            norm.append((cas_id, path, ext))
        if not norm:
            return 0
        batch = Batch(library_id=library_id, entries=norm, background=background)
        batch.id = next(self._batch_ids)
        if background:
            self._bg.append(batch)
        else:
            self._fg.appendleft(batch)  # LIFO priority stack
        self._pending[self._ns(library_id)] += len(norm)
        self._batch_pending[batch.id] = len(norm)
        self._save()
        # asyncio.Event.set is only safe on the owning loop: a caller on
        # a worker thread (or a foreign loop) hands the kick over
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        owner = self._loop
        if running is not None and (owner is None or running is owner):
            self._kick()
        elif owner is not None and owner.is_running():
            owner.call_soon_threadsafe(self._kick_on_loop)
        # with no loop bound yet, the batch is persisted and processed
        # on the first wait or start
        return batch.id

    # ---- rendezvous (ref:job.rs WaitThumbnails) ------------------------
    async def wait_batch(self, batch_id: int) -> None:
        """Wait for one dispatched batch (ids are per process; an
        unknown or finished id, e.g. after an actor restart, is done).
        Raises ThumbnailerError if the batch's device resize failed and
        no waiter has reported that yet."""
        if batch_id <= 0:
            return
        self._ensure_started()
        async with self._cond:
            await self._cond.wait_for(
                lambda: self._stopped or self._batch_pending[batch_id] == 0)
        failed = self._failed.pop(batch_id, None)
        if failed is not None:
            raise ThumbnailerError(failed[1])

    async def wait_library_batch(self, library_id: Any) -> None:
        """Wait for a whole namespace to drain (coarser than
        `wait_batch`; unrelated background work counts too). Raises
        ThumbnailerError if a batch of the namespace failed since the
        last report, and clears those failures."""
        self._ensure_started()
        ns = self._ns(str(library_id) if library_id is not None else None)
        async with self._cond:
            await self._cond.wait_for(lambda: self._stopped or self._pending[ns] == 0)
        failed = [self._failed.pop(bid)[1] for bid, (fns, _err) in list(self._failed.items())
                  if fns == ns]
        if failed:
            raise ThumbnailerError(failed[0])

    def pending_count(self, library_id: Any) -> int:
        return self._pending[self._ns(str(library_id) if library_id is not None else None)]

    # ---- worker --------------------------------------------------------
    async def _run(self) -> None:
        while not self._stopped:
            if not self._fg and not self._bg:
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    continue
            if self._stopped:
                break
            if self._fg:
                batch = self._fg.popleft()
            elif self._bg:
                batch = self._bg.popleft()
            else:
                continue
            self._current = batch
            t0 = time.perf_counter()
            try:
                await self._process_batch(batch)
            except asyncio.CancelledError:
                # shutdown cancelled us mid-batch: requeue the remainder
                # so shutdown's _save persists it
                self._current = None
                if batch.entries:
                    self._fg.appendleft(batch)
                raise
            except Exception as exc:  # noqa: BLE001 - the device stage failed; waiters see it
                logger.exception("thumbnail batch failed")
                self._failed[batch.id] = (self._ns(batch.library_id),
                                          f"thumbnail batch failed: {exc!r}")
                self.errors += len(batch.entries)
                await self._account(batch, len(batch.entries))
                batch.entries = []
            self.stage_seconds["batch"] += time.perf_counter() - t0
            self._current = None
            if batch.entries:
                # drained early because _stopped flipped mid-batch
                self._fg.appendleft(batch)
            self._save()

    async def _account(self, batch: Batch, n: int) -> None:
        async with self._cond:
            ns = self._ns(batch.library_id)
            self._pending[ns] -= n
            if self._pending[ns] <= 0:
                del self._pending[ns]
            self._batch_pending[batch.id] -= n
            if self._batch_pending[batch.id] <= 0:
                del self._batch_pending[batch.id]
            self._cond.notify_all()

    async def _process_batch(self, batch: Batch) -> None:
        pool = self._pool()
        if pool is not None:
            await self._process_batch_pool(batch, pool)
        else:
            await self._process_batch_inline(batch)

    def _pool(self) -> _procpool.ProcPool | None:
        """The running process pool, for the software path only; None for
        a device actor and with SD_PROCS=0."""
        return None if self.use_device else _procpool.get()

    async def _process_batch_pool(self, batch: Batch, pool: _procpool.ProcPool) -> None:
        """The software path on the pool: one `thumb.cpu` job per image,
        at most two in flight per worker (a background batch no more than
        its share of the cores); store, events and accounting stay here,
        and entries are consumed strictly in order, as inline."""
        entries = list(batch.entries)
        done = 0
        chunk_rows = self._device_chunk()
        width = 2 * pool.worker_count()
        if batch.background:
            width = min(width, self._bg_parallelism)
        sem = asyncio.Semaphore(max(1, width))

        async def one(entry: tuple[str, str, str]) -> bytes | None:
            _cas_id, path, ext = entry
            async with sem:
                try:
                    reply = await asyncio.wait_for(
                        pool.run("thumb.cpu", {"path": path, "ext": ext}),
                        timeout=GENERATION_TIMEOUT_S)
                except (_procpool.ProcPoolError, asyncio.TimeoutError):
                    # a pool failure is no evidence against the file:
                    # one inline retry
                    try:
                        return await asyncio.wait_for(
                            asyncio.to_thread(generate_one_cpu, path, ext),
                            timeout=GENERATION_TIMEOUT_S)
                    except NativeBuildError:
                        raise
                    except Exception as e:  # noqa: BLE001 - one bad file never fails the batch
                        logger.debug("thumb failed %s: %s", path, e)
                        return None
            if reply.get("webp") is None:
                logger.debug("thumb failed %s: %s", path, reply.get("error"))
            return reply.get("webp")

        def store_chunk(chunk, webps) -> None:
            for (cas_id, _path, _ext), webp in zip(chunk, webps):
                if webp is not None:
                    self.store.write(batch.library_id, cas_id, webp)

        pos = 0
        while pos < len(entries) and not self._stopped:
            chunk = entries[pos:pos + chunk_rows]
            pos += len(chunk)
            t0 = time.perf_counter()
            webps = await asyncio.gather(*(one(e) for e in chunk))
            await asyncio.to_thread(store_chunk, chunk, webps)
            self.stage_seconds["encode"] += time.perf_counter() - t0
            for (cas_id, _path, _ext), webp in zip(chunk, webps):
                if webp is None:
                    self.errors += 1
                else:
                    self._stored(batch.library_id, cas_id)
            if _faults.hit("thumbnail.persist") is not None:
                # the inline pipeline's crash window: the chunk stored,
                # not accounted; a fresh actor must skip the stored prefix
                raise _faults.InjectedCrash(
                    "injected crash between chunk store and journal write")
            done += len(chunk)
            batch.entries = entries[done:]
            await self._account(batch, len(chunk))

    async def _process_batch_inline(self, batch: Batch) -> None:
        """The chunk pipeline: while chunk N rides the device, chunk N+1
        decodes on the thread pool and chunk N-1 encodes and stores.
        Encode tasks are chained (at most one outstanding, awaited
        before the next starts), so entries are consumed strictly in
        order and the persisted remainder only ever loses a prefix whose
        thumbnails are on disk."""
        sem = asyncio.Semaphore(self._bg_parallelism if batch.background else self._fg_parallelism)
        chunk_rows = self._device_chunk()
        entries = list(batch.entries)
        done = 0  # entries stored and accounted (a prefix of `entries`)

        async def decode_one(entry: tuple[str, str, str]) -> Decoded | None:
            _cas_id, path, ext = entry
            async with sem:
                try:
                    return await asyncio.wait_for(asyncio.to_thread(decode, path, ext),
                                                  timeout=GENERATION_TIMEOUT_S)
                except NativeBuildError:
                    raise  # the frontend, not the file: the batch fails
                except Exception as e:  # noqa: BLE001 - one bad file never fails the batch
                    logger.debug("thumb decode failed %s: %s", path, e)
                    return None

        async def decode_chunk(chunk):
            t0 = time.perf_counter()
            decoded = await asyncio.gather(*(decode_one(e) for e in chunk))
            self.stage_seconds["decode"] += time.perf_counter() - t0
            return decoded

        def encode_store(cas_id: str, d: Decoded, resized) -> None:
            webp = resize_cpu(d) if resized is None else finish(d, resized)
            self.store.write(batch.library_id, cas_id, webp)

        async def encode_one(cas_id: str, d: Decoded, resized) -> bool:
            async with sem:
                try:
                    await asyncio.wait_for(asyncio.to_thread(encode_store, cas_id, d, resized),
                                           timeout=GENERATION_TIMEOUT_S)
                except Exception as e:  # noqa: BLE001 - counted, as a decode failure is
                    logger.warning("thumb encode failed %s: %s", cas_id, e)
                    return False
            return True

        async def encode_chunk(chunk, decoded, device_idx, resized):
            """Last stage of one chunk: webp-encode the device outputs
            and the host-path stragglers, store them, account, and drop
            the chunk from the batch's persisted remainder."""
            nonlocal done
            t0 = time.perf_counter()
            by_device = dict(zip(device_idx, resized))
            jobs = [(i, d) for i, d in enumerate(decoded) if d is not None]
            ok = await asyncio.gather(*(encode_one(chunk[i][0], d, by_device.get(i))
                                        for i, d in jobs))
            for (i, _d), stored in zip(jobs, ok):
                if stored:
                    self._stored(batch.library_id, chunk[i][0])
            self.errors += len(chunk) - sum(ok)
            self.stage_seconds["encode"] += time.perf_counter() - t0
            if _faults.hit("thumbnail.persist") is not None:
                # simulated process death between "chunk stored" and
                # "accounted": a BaseException no recovery path absorbs;
                # a fresh actor resumes and must skip the stored prefix
                raise _faults.InjectedCrash(
                    "injected crash between chunk store and journal write")
            done += len(chunk)
            # only now may the resume state drop this chunk
            batch.entries = entries[done:]
            await self._account(batch, len(chunk))

        pos = 0  # decode cursor
        decode_task: asyncio.Future | None = None
        encode_task: asyncio.Future | None = None
        try:
            while pos < len(entries) and not self._stopped:
                chunk = entries[pos:pos + chunk_rows]
                if decode_task is None:
                    decode_task = asyncio.ensure_future(decode_chunk(chunk))
                decoded = await decode_task
                decode_task = None
                pos += len(chunk)
                if pos < len(entries) and not self._stopped:
                    # chunk N+1 decodes while chunk N rides the device
                    decode_task = asyncio.ensure_future(
                        decode_chunk(entries[pos:pos + chunk_rows]))
                device_idx = [i for i, d in enumerate(decoded) if d is not None
                              and self.use_device and not needs_cpu_fallback(d)]
                resized = []
                if device_idx:
                    t0 = time.perf_counter()
                    resized = await self._resize_chunk([decoded[i] for i in device_idx])
                    self.stage_seconds["device"] += time.perf_counter() - t0
                if encode_task is not None:
                    await encode_task  # chunk N-1 finishes storing first
                encode_task = asyncio.ensure_future(
                    encode_chunk(chunk, decoded, device_idx, resized))
            if encode_task is not None:
                await encode_task
                encode_task = None
        finally:
            # cancel the read-ahead and retrieve it so no orphan warns;
            # the trailing encode (started work) must complete so its
            # thumbnails are stored before the remainder persists
            if decode_task is not None:
                decode_task.cancel()
                try:
                    await decode_task
                except asyncio.CancelledError:
                    pass
            while encode_task is not None and not encode_task.done():
                try:
                    await asyncio.shield(encode_task)
                except asyncio.CancelledError:
                    continue
                except Exception:  # noqa: BLE001 - the failure in flight propagates
                    logger.exception("thumbnail encode chunk failed")
                    break

    def _device_chunk(self) -> int:
        """Images per device resize call: the live "thumbnail" policy
        scaled by the card count (a sharded resize gives each card a full
        chunk), read per batch so an autotuner step lands on the next
        one; an explicit `chunk_rows` always wins."""
        if self.chunk_rows is not None:
            return self.chunk_rows
        return _autotune.policy("thumbnail").thumb_chunk_rows(_mesh.device_scale(self.device))

    async def _resize_chunk(self, ds: list[Decoded]) -> list:
        """One chunk's device resize; past the ladder, the CPU resize."""
        try:
            return await asyncio.to_thread(resize_decoded, ds, self.device)
        except Exception as exc:
            if not _mesh.auto_slots(self.device):
                raise  # a pinned device: the batch fails
            # the device resize failed past the degradation ladder: the
            # chunk degrades to the CPU resize instead of erroring
            RESILIENCE_EVENTS.emit("thumbnail_cpu_fallback", entries=len(ds))
            logger.warning("device resize failed past the ladder (%r); %d images "
                           "resize on the CPU", exc, len(ds))
            return await asyncio.to_thread(resize_decoded, ds, devices=[torch.device("cpu")])

    def _stored(self, library_id: str | None, cas_id: str) -> None:
        self.generated += 1
        if self.event_bus is not None:
            self.event_bus.emit({
                "type": "NewThumbnail",
                "thumb_key": (self._ns(library_id), get_shard_hex(cas_id), cas_id),
            })
