"""The indexing pass: walk → sampled read → cas_id → thumbnail → embed.

Counterpart of the path `spacedrive_tpu.cli cmd_index` drives through
the library's jobs (location/locations.scan_location →
object/file_identifier/job.py → object/media/job.py), without the
library DB, the job system, object linking, the index journal or sync:

1. walk the location with its default rules (location/indexer/walker);
2. identify: windows of IDENTIFY_DEVICE_WINDOW files flow through
   `WindowPipeline`, whose producer reads each window's sampled
   messages and dispatches them (`cas.cas_ids_begin`, which enqueues the
   copy and the hash on a side stream) while the consumer finishes the
   windows before it;
3. thumbnails: one per distinct cas_id among decodable images, decoded
   on the host, resized in device batches of THUMB_DEVICE_BATCH, then
   oriented, encoded to webp and written to the thumbnail store;
4. embed: the same images decode to the embedder's input plane and
   embed in device batches of EMBED_DEVICE_BATCH.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .location.indexer.walker import walk
from .models import embedder as _embedder
from .object.media.thumbnail import process
from .object.media.thumbnail.store import ThumbnailStore
from .ops import cas, embed_torch
from .parallel.autotune import EMBED_DEVICE_BATCH, IDENTIFY_DEVICE_WINDOW, THUMB_DEVICE_BATCH
from .parallel.feeder import WindowPipeline


@dataclass
class IndexResult:
    summary: dict  # the CLI's JSON line
    cas_ids: dict[str, str | None]  # file path → cas_id (None: empty or unreadable)
    thumbnails: dict[str, str] = field(default_factory=dict)  # cas_id → webp path
    embeddings: dict[str, np.ndarray] = field(default_factory=dict)  # cas_id → vector
    resized: dict[str, np.ndarray] = field(default_factory=dict)  # cas_id → pre-encode pixels
    timings: dict[str, float] = field(default_factory=dict)  # seconds per stage


def _chunks(items: list, n: int):
    for i in range(0, len(items), n):
        yield items[i:i + n]


def identify(paths_sizes: list[tuple[str, int]], device, timings: dict[str, float]) -> list[str | None]:
    """cas_ids of (path, size) pairs in order; None for empty files (the
    identifier hashes no empty file) and unreadable ones. Accumulates
    `read` (producer: sampled reads), `dispatch` (producer: pack and
    enqueue) and `hash_wait` (consumer: waiting for the device) seconds
    into `timings`."""
    out: list[str | None] = [None] * len(paths_sizes)
    read_s = dispatch_s = 0.0

    def fetch(cursor: int):
        nonlocal read_s, dispatch_s
        if cursor >= len(paths_sizes):
            return None
        t0 = time.perf_counter()
        idx: list[int] = []
        msgs: list[bytes] = []
        for i in range(cursor, min(cursor + IDENTIFY_DEVICE_WINDOW, len(paths_sizes))):
            path, size = paths_sizes[i]
            if size == 0:
                continue
            try:
                msgs.append(cas.read_message(path, size))
            except OSError:
                continue
            idx.append(i)
        t1 = time.perf_counter()
        fin = cas.cas_ids_begin(msgs, device)
        read_s += t1 - t0
        dispatch_s += time.perf_counter() - t1
        return cursor + IDENTIFY_DEVICE_WINDOW, (idx, fin)

    wait_s = 0.0
    pipe = WindowPipeline(fetch, 0)  # FEEDER_BASE_DEPTH windows ahead
    try:
        while (window := pipe.take()) is not None:
            idx, fin = window
            t0 = time.perf_counter()
            ids = fin()
            wait_s += time.perf_counter() - t0
            for i, cas_id in zip(idx, ids):
                out[i] = cas_id
    finally:
        pipe.close()
    timings["read"] = timings.get("read", 0.0) + read_s
    timings["dispatch"] = timings.get("dispatch", 0.0) + dispatch_s
    timings["hash_wait"] = timings.get("hash_wait", 0.0) + wait_s
    return out


def thumbnail(
    items: list[tuple[str, str]],
    store: ThumbnailStore,
    library_id: str | None,
    device,
    resized: dict[str, np.ndarray] | None = None,
) -> dict[str, str]:
    """Thumbnails for (cas_id, path) pairs; returns cas_id → webp path.
    Undecodable images are skipped. `resized`, when given, receives each
    device-resized array before orientation and encode."""
    written: dict[str, str] = {}
    for batch in _chunks(items, THUMB_DEVICE_BATCH):
        on_device: list[tuple[str, process.Decoded]] = []
        for cas_id, path in batch:
            try:
                d = process.decode_image(path)
            except (process.ThumbError, OSError, ValueError):
                continue
            if process.needs_cpu_fallback(d):
                written[cas_id] = store.write(library_id, cas_id, process.resize_cpu(d))
            else:
                on_device.append((cas_id, d))
        if not on_device:
            continue
        arrays = process.resize_decoded([d for _, d in on_device], device)
        for (cas_id, d), arr in zip(on_device, arrays):
            if resized is not None:
                resized[cas_id] = arr
            written[cas_id] = store.write(library_id, cas_id, process.finish(d, arr))
    return written


def embed(items: list[tuple[str, str]], device) -> dict[str, np.ndarray]:
    """Embedding vectors for (cas_id, path) pairs; undecodable images are
    skipped."""
    model = _embedder.PatchPoolEmbedder(device)
    vectors: dict[str, np.ndarray] = {}
    for batch in _chunks(items, EMBED_DEVICE_BATCH):
        keys, planes = [], []
        for cas_id, path in batch:
            plane = _embedder.decode_image(path)
            if plane is not None:
                keys.append(cas_id)
                planes.append(plane)
        if planes:
            for cas_id, vec in zip(keys, embed_torch.embed_batch(np.stack(planes), device, model)):
                vectors[cas_id] = vec
    return vectors


def index_pass(
    path: str | os.PathLike,
    data_dir: str | os.PathLike,
    device: str | torch.device = "cuda",
    library_id: str | None = None,
    keep_pixels: bool = False,
) -> IndexResult:
    """Index `path` on `device` and write thumbnails under `data_dir`.
    `keep_pixels` keeps each device-resized thumbnail array in the
    result (for parity checks)."""
    device = torch.device(device)
    root = os.path.normpath(os.fspath(path))
    t_start = time.perf_counter()
    timings: dict[str, float] = {}
    t0 = time.perf_counter()
    files = [
        (e.iso_file_path.join_on(root), e.metadata.size_in_bytes, e.iso_file_path.extension)
        for e in walk(root).walked
        if not e.iso_file_path.is_dir
    ]
    timings["walk"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ids = identify([(p, size) for p, size, _ in files], device, timings)
    timings["identify"] = time.perf_counter() - t0
    cas_ids = {p: c for (p, _, _), c in zip(files, ids)}

    # one thumbnail and one vector per object (distinct cas_id)
    images: dict[str, str] = {}
    for (p, _, ext), c in zip(files, ids):
        if c is not None and process.can_generate(ext):
            images.setdefault(c, p)
    items = list(images.items())

    result = IndexResult(summary={}, cas_ids=cas_ids, timings=timings)
    t0 = time.perf_counter()
    result.thumbnails = thumbnail(
        items, ThumbnailStore(data_dir), library_id, device,
        result.resized if keep_pixels else None,
    )
    timings["thumbnail"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    result.embeddings = embed(items, device)
    timings["embed"] = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t_start
    result.summary = {
        "files": len(files),
        "objects": len({c for c in ids if c is not None}),
        "bytes": sum(size for _, size, _ in files),
        "thumbnails": len(result.thumbnails),
        "backend": str(device),
        "seconds": round(elapsed, 2),
    }
    return result
