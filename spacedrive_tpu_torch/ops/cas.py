"""Content addressing (cas_id): sampling layout + batched device hashing.

Counterpart of `spacedrive_tpu/ops/cas.py`. Bit-parity with the
reference algorithm (ref:core/src/object/cas.rs:23-62):

    message = u64_le(size) || payload
    payload = whole file                          if size <= 100 KiB
            = file[0:8K]
              || file[8K + k*J : +10K]  k=0..3    J = (size - 16K) // 4
              || file[size-8K : size]             otherwise
    cas_id  = blake3(message).hex()[:16]

Large files therefore produce a fixed 57,352-byte message (57 chunks),
the hot bucket. Small files bucket by chunk count (ragged lengths are
masked per lane).

The host halves (sampling, reads, the dirty-range chunk cache) are owned
copies of the JAX package's; `cas_ids_begin` is the device dispatch,
over one device or a slot list, through the degradation ladder.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Sequence

import numpy as np
import torch

from ..parallel import autotune as _autotune
from ..parallel import mesh as _mesh
from ..parallel.autotune import BATCH_LADDER
from ..telemetry import events as _events
from ..telemetry import metrics as _tm
from . import blake3_cuda, blake3_torch
from .blake3_ref import (
    CHUNK_LEN,  # noqa: F401 - re-exported
    StreamingBlake3,
    chunk_chaining_value,
    parent_chaining_value,
    root_digest_from_pair,
)
from .cas_host import (  # noqa: F401 - the host half, re-exported
    CHUNK_DIGEST_LEN,
    HEADER_OR_FOOTER_SIZE,
    LARGE_CHUNKS,
    LARGE_MSG_LEN,
    MAX_SMALL_MSG_LEN,
    MINIMUM_FILE_SIZE,
    SAMPLE_COUNT,
    SAMPLE_SIZE,
    SMALL_BUCKETS,
    ChunkCache,
    _split_chunks,
    build_chunk_cache,
    cas_ids_host,
    chunk_digests,
    message_from_bytes,
    message_len,
    read_message,
    sample_ranges,
)

DEVICE_BATCH = BATCH_LADDER[-1]  # max rows per dispatch PER DEVICE

logger = logging.getLogger(__name__)


def _build_levels(cvs: list[bytes]) -> list[list[bytes]]:
    levels = [cvs]
    while len(levels[-1]) > 2:
        cur = levels[-1]
        nxt = [
            parent_chaining_value(cur[j], cur[j + 1])
            for j in range(0, len(cur) - 1, 2)
        ]
        if len(cur) % 2:
            nxt.append(cur[-1])
        levels.append(nxt)
    return levels


def _root_cas_id(levels: list[list[bytes]]) -> str:
    top = levels[-1]
    return root_digest_from_pair(top[0], top[1], 8).hex()


def host_rehash_with_cache(message: bytes) -> tuple[str, ChunkCache]:
    """Full host rehash that captures the CV tree, so the next
    modification of this file pays only for its dirty chunks. Only
    valid for multi-chunk messages (single chunks use the ROOT flag)."""
    chunks = _split_chunks(message)
    if len(chunks) < 2:
        raise ValueError("host_rehash_with_cache needs >= 2 chunks")
    cvs = [chunk_chaining_value(c, i) for i, c in enumerate(chunks)]
    levels = _build_levels(cvs)
    cache = ChunkCache(len(message), chunk_digests(message), levels)
    return _root_cas_id(levels), cache


def dirty_range_rehash(
    message: bytes, cache: ChunkCache
) -> tuple[str, ChunkCache, int, int]:
    """Rehash `message` reusing `cache` from its previous version.
    Returns (cas_id, refreshed cache, dirty_chunks, bytes_rehashed); the
    cas_id is bit-identical to a full rehash.

    Requires an unchanged message length (a size change moves every
    sample offset, so the whole message is new: callers full-rehash)."""
    if len(message) != cache.msg_len:
        raise ValueError("message length changed; dirty-range does not apply")
    chunks = _split_chunks(message)
    if len(chunks) < 2:
        raise ValueError("dirty-range needs >= 2 chunks")
    digests = chunk_digests(message)
    dirty = [i for i, d in enumerate(digests) if d != cache.digests[i]]
    if cache.levels is None:
        # no CV tree yet (the cas came off the device): one full host
        # rehash builds it; later modifications pay only dirty chunks
        cas, fresh = host_rehash_with_cache(message)
        return cas, fresh, len(dirty), len(message)
    levels = [list(level) for level in cache.levels]
    hashed = 0
    for i in dirty:
        levels[0][i] = chunk_chaining_value(chunks[i], i)
        hashed += len(chunks[i])
    # bubble the dirty paths up: parent j covers children 2j / 2j+1; an
    # unpaired last node is carried (copied), not compressed
    dirty_nodes = set(dirty)
    for depth in range(len(levels) - 1):
        cur, nxt = levels[depth], levels[depth + 1]
        parents = set()
        for i in dirty_nodes:
            j = i // 2
            if j in parents:
                continue
            if 2 * j + 1 < len(cur):
                nxt[j] = parent_chaining_value(cur[2 * j], cur[2 * j + 1])
            else:
                nxt[j] = cur[2 * j]
            parents.add(j)
        dirty_nodes = parents
    return (
        _root_cas_id(levels),
        ChunkCache(cache.msg_len, digests, levels),
        len(dirty),
        hashed,
    )


def cas_id_cpu(path: str | os.PathLike, size: int | None = None) -> str:
    """Host-only cas_id through the pure-Python reference hash: the
    parity oracle for the device path."""
    msg = read_message(path, size)
    return StreamingBlake3().update(msg).hexdigest()[:16]


# --- batched device hashing -------------------------------------------------


def batch_ladder(n_devices: int = 1) -> tuple[int, ...]:
    """Global pad ladder of an n-device dp dispatch: every rung is the
    per-device rung × device count, so each slot always sees one of the
    same three shapes (32/256/1024 rows) however many slots share the
    batch."""
    n = max(1, n_devices)
    return BATCH_LADDER if n == 1 else tuple(r * n for r in BATCH_LADDER)


def device_batch(n_devices: int = 1) -> int:
    """Max rows per dispatch: DEVICE_BATCH per participating device."""
    return DEVICE_BATCH * max(1, n_devices)


def pack_canonical_batch(
    messages: Sequence[bytes], max_chunks: int, n_devices: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """The one batch-shape policy for device hashing: at most
    device_batch(n_devices) messages pack into a `(ladder_size,
    max_chunks*1024)` uint8 array plus int32 lengths, the ladder scaled
    by `n_devices` (batch_ladder) so a dp-sharded dispatch divides
    evenly with per-device rung shapes. Pad rows hash one zero byte and
    are sliced off by the caller. The array starts uninitialized and
    each row writes its message plus an explicit zero tail: one pass
    over the buffer."""
    n = len(messages)
    cap = device_batch(n_devices)
    if n > cap:
        raise ValueError(f"pack at most {cap} messages, got {n}")
    n_pad = next(s for s in batch_ladder(n_devices) if s >= n)
    arr = np.empty((n_pad, max_chunks * 1024), np.uint8)
    lens = np.ones((n_pad,), np.int32)
    for j, msg in enumerate(messages):
        ln = len(msg)
        arr[j, :ln] = np.frombuffer(msg, np.uint8)
        arr[j, ln:] = 0
        lens[j] = ln
    arr[n:] = 0  # pad rows (length 1) hash a zero byte
    return arr, lens


def _bucket_for(msg_len: int) -> int:
    chunks = max(1, (msg_len + 1023) // 1024)
    for b in SMALL_BUCKETS:
        if chunks <= b:
            return b
    raise ValueError(f"message too large for small buckets: {msg_len}")


def shard_occupancy(n_real: int, n_pad: int, n_dev: int) -> list[float]:
    """Per-device real-row fraction of one sharded dispatch (device d
    owns rows [d*r, (d+1)*r) of the contiguously packed batch)."""
    r = n_pad // n_dev
    return [min(max(n_real - d * r, 0), r) / r for d in range(n_dev)]


def _last_rung(messages: Sequence[bytes], device: torch.device) -> Callable[[], list[str]]:
    """The ladder's last cas rung: the caller's default device, strict.
    The JAX package ends on its host reference path; the port hashes on
    the card it would have used unsharded and raises if that fails, so a
    kernel failure never moves K1's work to the CPU. Counted, logged and
    put on the resilience ring every time it runs."""
    _tm.CAS_BACKEND_FALLBACK.inc()
    _events.RESILIENCE_EVENTS.emit("cas_last_rung", messages=len(messages))
    logger.warning("device ladder at its last rung: hashing %d cas messages on %s alone",
                   len(messages), device)
    return cas_ids_begin(messages, device, devices=[device])


def cas_ids_begin(
    messages: Sequence[bytes], device: str | torch.device = "cuda",
    devices: Sequence[torch.device] | None = None, _depth: int = 0,
) -> Callable[[], list[str]]:
    """Dispatch device hashing without blocking and return the finisher
    that waits and makes the hex ids. Splitting dispatch from completion
    lets a pipeline enqueue window N+1's copy and kernels while window N
    is still in flight (parallel/feeder.WindowPipeline).

    Messages group by chunk bucket (the 57-chunk hot bucket, else the
    smallest small bucket that holds them); each part of at most
    min(device_batch(n), the identify policy's dispatch rung × n) rows
    (parallel/autotune.py: 32, 256 or 1024 rows per slot) packs through
    `pack_canonical_batch` and goes to `blake3_torch.hash_batch_begin`
    on a slot list, so the rung changes the launches, never the ids:

    - explicit `devices` always shard over that list, strict: a failure
      raises;
    - `device` naming a type ("cuda") rides the degradation ladder over
      that type's dispatch devices (parallel/mesh): a part shards when
      it fills half the smallest sharded rung or exceeds DEVICE_BATCH,
      an unsharded part runs on `device` (or, at the subset rung, on the
      first surviving slot), and a dispatch or finish that fails demotes
      the ladder and re-runs the whole call at the demoted rung inside
      the same `finish()` — all slots → surviving slots → the last rung,
      `device` alone and strict (`_last_rung`), whose failure raises;
    - a pinned device ("cuda:0", or a type with no dispatch device) runs
      strict on it, as does every call where the K1 build fails or no
      CUDA device exists: those raise and never enter the ladder."""
    device = torch.device(device)
    level: int | None = None
    if devices is not None:
        devs, explicit = [torch.device(d) for d in devices], True
    elif not (slots := _mesh.auto_slots(device)):
        devs, explicit = [device], True
    elif _depth >= 3:
        # recursion cap: straight to the last rung WITHOUT consulting the
        # ladder, which could hand this doomed call the half-open probe
        return _last_rung(messages, device)
    else:
        explicit = False
        if device.type == "cuda":
            blake3_cuda.build()  # a failed build raises, outside the ladder
        devs, level = _mesh.LADDER.filter(slots)
        if level == _mesh.LEVEL_HOST:
            return _last_rung(messages, device)
    n_dev = len(devs)

    def _retry_demoted(exc: Exception) -> Callable[[], list[str]]:
        _mesh.LADDER.record_failure(level, devs)
        _tm.CAS_BACKEND_FALLBACK.inc()
        _events.record_error("cas.ladder", exc)
        # bounded re-dispatch at the demoted rung
        return cas_ids_begin(messages, device, _depth=_depth + 1)

    buckets: dict[int, list[int]] = {}
    for i, msg in enumerate(messages):
        c = LARGE_CHUNKS if len(msg) == LARGE_MSG_LEN else _bucket_for(len(msg))
        buckets.setdefault(c, []).append(i)

    # the autotuner's current per-device rung × the slot count (the
    # static top rung is device_batch, as before the controller)
    step = min(device_batch(n_dev),
               _autotune.policy("identify").dispatch_rows_per_device() * max(1, n_dev))
    in_flight: list[tuple[list[int], Callable[[], torch.Tensor]]] = []
    used_devices = False  # did any part run on the rung's slots?
    try:
        for c, indices in sorted(buckets.items()):
            for off in range(0, len(indices), step):
                part = indices[off:off + step]
                # a shard-declined part must fit the single-device cap,
                # so anything over it shards regardless of occupancy
                shard = n_dev > 1 and (
                    explicit
                    or len(part) * 2 >= n_dev * BATCH_LADDER[0]
                    or len(part) > DEVICE_BATCH
                )
                # at the subset rung an unsharded part still lands on a
                # surviving slot; elsewhere it runs on the default device
                on_default = not shard and not explicit and level != _mesh.LEVEL_SUBSET
                slots = [device] if on_default else (devs if shard else devs[:1])
                used_devices = used_devices or not on_default
                arr, lens = pack_canonical_batch(
                    [messages[i] for i in part], c, n_devices=n_dev if shard else 1
                )
                if shard:
                    for frac in shard_occupancy(len(part), arr.shape[0], n_dev):
                        _tm.DEVICE_DISPATCH_OCCUPANCY.observe(frac, op="blake3")
                in_flight.append((part, blake3_torch.hash_batch_begin(arr, lens, c, slots)))
    except Exception as exc:  # noqa: BLE001 - a dispatch failure demotes
        if explicit:
            raise
        return _retry_demoted(exc)

    def finish() -> list[str]:
        out: list[str | None] = [None] * len(messages)
        try:
            for part, wait in in_flight:
                words = wait()
                if words.dim() != 2 or words.shape[1] != 8 or words.shape[0] < len(part):
                    raise ValueError(
                        f"device returned wrong-shaped digest batch "
                        f"{tuple(words.shape)} for {len(part)} rows"
                    )
                for i, hx in zip(part, blake3_torch.words_to_hex(words[: len(part)], 16)):
                    out[i] = hx
        except Exception as exc:  # noqa: BLE001 - CUDA faults surface here
            if explicit:
                raise
            return _retry_demoted(exc)()
        if not explicit:
            if used_devices:
                _mesh.LADDER.record_success(level)
            else:
                # the whole call ran unsharded on the default device: it
                # proved nothing about the rung's slots, so a held
                # half-open probe is released, never promoted
                _mesh.LADDER.probe_inconclusive(level)
        return out  # type: ignore[return-value]

    return finish


def cas_ids(messages: Sequence[bytes], device: str | torch.device = "cuda") -> list[str]:
    """cas_ids for pre-assembled messages, batched per chunk bucket and
    hashed on `device` (through the ladder, see `cas_ids_begin`).
    Order-preserving."""
    if not messages:
        return []
    return cas_ids_begin(messages, device)()
