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
copies of the JAX package's; `cas_ids_begin` is the device dispatch.
"""

from __future__ import annotations

import hashlib
import os
import struct
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..parallel.autotune import BATCH_LADDER
from . import blake3_torch
from .blake3_ref import (
    CHUNK_LEN,
    StreamingBlake3,
    chunk_chaining_value,
    parent_chaining_value,
    root_digest_from_pair,
)

SAMPLE_COUNT = 4
SAMPLE_SIZE = 10 * 1024
HEADER_OR_FOOTER_SIZE = 8 * 1024
MINIMUM_FILE_SIZE = 100 * 1024

LARGE_MSG_LEN = 8 + 2 * HEADER_OR_FOOTER_SIZE + SAMPLE_COUNT * SAMPLE_SIZE  # 57,352
LARGE_CHUNKS = (LARGE_MSG_LEN + 1023) // 1024  # 57
MAX_SMALL_MSG_LEN = 8 + MINIMUM_FILE_SIZE  # 102,408
# Small-file buckets by chunk count.
SMALL_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 101)

DEVICE_BATCH = BATCH_LADDER[-1]  # max rows per dispatch


def sample_ranges(size: int) -> list[tuple[int, int]]:
    """(offset, length) reads composing the payload, matching the
    reference's read/seek sequence exactly."""
    if size <= MINIMUM_FILE_SIZE:
        return [(0, size)]
    jump = (size - 2 * HEADER_OR_FOOTER_SIZE) // SAMPLE_COUNT
    ranges = [(0, HEADER_OR_FOOTER_SIZE)]
    for k in range(SAMPLE_COUNT):
        ranges.append((HEADER_OR_FOOTER_SIZE + k * jump, SAMPLE_SIZE))
    ranges.append((size - HEADER_OR_FOOTER_SIZE, HEADER_OR_FOOTER_SIZE))
    return ranges


def message_from_bytes(content: bytes, size: int | None = None) -> bytes:
    """Assemble the hashed message for in-memory content."""
    size = len(content) if size is None else size
    parts = [struct.pack("<Q", size)]
    for off, ln in sample_ranges(size):
        parts.append(content[off:off + ln])
    return b"".join(parts)


def read_message(path: str | os.PathLike, size: int | None = None) -> bytes:
    """Read the sampling layout from disk (one seek + read per range)."""
    if size is None:
        size = os.stat(path).st_size
    parts = [struct.pack("<Q", size)]
    with open(path, "rb", buffering=0) as f:
        for off, ln in sample_ranges(size):
            f.seek(off)
            buf = f.read(ln)
            if len(buf) != ln:
                raise OSError(f"short read at {off} in {path}")
            parts.append(buf)
    return b"".join(parts)


def message_len(size: int) -> int:
    """Length of the hashed message for a file of `size` bytes."""
    return 8 + size if size <= MINIMUM_FILE_SIZE else LARGE_MSG_LEN


# --- dirty-range rehash ---------------------------------------------------
#
# BLAKE3 is a Merkle tree over 1024-byte chunks. Caching a cheap content
# digest per chunk plus the tree's chaining values lets a pass over a
# modified file recompute only the chunks whose bytes changed (and their
# log-depth path of parents), bit-identical to a full rehash.

CHUNK_DIGEST_LEN = 16


def _split_chunks(message: bytes) -> list[bytes]:
    return [message[i:i + CHUNK_LEN] for i in range(0, len(message), CHUNK_LEN)]


def chunk_digests(message: bytes) -> list[bytes]:
    """Cheap per-chunk content digests (blake2b-128): the dirty
    detector, not part of the cas_id itself."""
    return [
        hashlib.blake2b(c, digest_size=CHUNK_DIGEST_LEN).digest()
        for c in _split_chunks(message)
    ]


@dataclass
class ChunkCache:
    """Per-file dirty-range state (the payload the index journal keeps)."""

    msg_len: int
    digests: list[bytes]
    # CV tree: levels[0] = per-chunk CVs, each upper level the pairwise
    # parents (odd node carried up), topmost level exactly 2 nodes.
    # None until the file first takes the host dirty-range path.
    levels: list[list[bytes]] | None = None

    def to_payload(self) -> dict:
        return {"len": self.msg_len, "dig": self.digests, "cvs": self.levels}

    @classmethod
    def from_payload(cls, obj: Any) -> "ChunkCache | None":
        """Strict validation: anything malformed returns None (the
        caller degrades to a full rehash, never a wrong cas_id)."""
        if not isinstance(obj, dict):
            return None
        msg_len, digests, levels = obj.get("len"), obj.get("dig"), obj.get("cvs")
        if not isinstance(msg_len, int) or msg_len <= 0:
            return None
        n = (msg_len + CHUNK_LEN - 1) // CHUNK_LEN
        if (
            not isinstance(digests, list) or len(digests) != n
            or any(
                not isinstance(d, bytes) or len(d) != CHUNK_DIGEST_LEN
                for d in digests
            )
        ):
            return None
        if levels is not None:
            if not isinstance(levels, list) or not levels:
                return None
            want = n
            for level in levels:
                if (
                    not isinstance(level, list) or len(level) != want
                    or any(not isinstance(cv, bytes) or len(cv) != 32 for cv in level)
                ):
                    return None
                want = (want + 1) // 2
            if len(levels[-1]) != 2:
                return None
        return cls(msg_len, list(digests), levels)


def build_chunk_cache(message: bytes) -> ChunkCache:
    """Digest-only cache, recorded beside a device-hashed cas_id so the
    first in-place modification can already diff chunks."""
    return ChunkCache(len(message), chunk_digests(message))


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


def batch_ladder() -> tuple[int, ...]:
    """Pad ladder of a single-device dispatch."""
    return BATCH_LADDER


def pack_canonical_batch(
    messages: Sequence[bytes], max_chunks: int
) -> tuple[np.ndarray, np.ndarray]:
    """The one batch-shape policy for device hashing: at most
    DEVICE_BATCH messages pack into a `(ladder_size, max_chunks*1024)`
    uint8 array plus int32 lengths. Pad rows hash one zero byte and are
    sliced off by the caller. The array starts uninitialized and each
    row writes its message plus an explicit zero tail: one pass over
    the buffer."""
    n = len(messages)
    if n > DEVICE_BATCH:
        raise ValueError(f"pack at most {DEVICE_BATCH} messages, got {n}")
    n_pad = next(s for s in BATCH_LADDER if s >= n)
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


def _dispatch(arr: np.ndarray, lens: np.ndarray, chunks: int, device: torch.device):
    """Start one packed batch on `device` and return a callable that
    waits for it and gives the int32 [rows, 8] root words on the host.

    On CUDA: pin the host words, copy them in non_blocking on a side
    stream, hash there, copy the digests back into pinned memory on the
    same stream and record an event. Nothing here blocks the caller;
    the returned callable waits on the event."""
    words = blake3_torch.host_words(arr)
    if device.type != "cuda":
        out = blake3_torch.hash_batch(words, lens, chunks, device)
        return lambda: out
    stream = torch.cuda.Stream(device)
    # pinned blocks are not reused before the copies recorded on them
    # complete (PyTorch's host allocator records the stream), and device
    # blocks allocated under the side stream are reused only in its order
    with torch.cuda.stream(stream):
        d_words = words.pin_memory().to(device, non_blocking=True)
        d_lens = torch.from_numpy(lens).pin_memory().to(device, non_blocking=True)
        roots = blake3_torch.hash_batch(d_words, d_lens, chunks, device)
        host = torch.empty(roots.shape, dtype=roots.dtype, pin_memory=True)
        host.copy_(roots, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)

    def wait() -> torch.Tensor:
        done.synchronize()
        return host

    return wait


def cas_ids_begin(
    messages: Sequence[bytes], device: str | torch.device = "cuda"
) -> Callable[[], list[str]]:
    """Dispatch device hashing without blocking and return the finisher
    that waits and makes the hex ids. Splitting dispatch from completion
    lets a pipeline enqueue window N+1's copy and kernels while window N
    is still in flight (parallel/feeder.WindowPipeline).

    Messages group by chunk bucket (the 57-chunk hot bucket, else the
    smallest small bucket that holds them), each part of at most
    DEVICE_BATCH rows packs through `pack_canonical_batch`. A failure to
    build, copy or launch raises: there is no host fallback."""
    device = torch.device(device)
    buckets: dict[int, list[int]] = {}
    for i, msg in enumerate(messages):
        c = LARGE_CHUNKS if len(msg) == LARGE_MSG_LEN else _bucket_for(len(msg))
        buckets.setdefault(c, []).append(i)

    in_flight: list[tuple[list[int], Callable[[], torch.Tensor]]] = []
    for c, indices in sorted(buckets.items()):
        for off in range(0, len(indices), DEVICE_BATCH):
            part = indices[off:off + DEVICE_BATCH]
            arr, lens = pack_canonical_batch([messages[i] for i in part], c)
            in_flight.append((part, _dispatch(arr, lens, c, device)))

    def finish() -> list[str]:
        out: list[str | None] = [None] * len(messages)
        for part, wait in in_flight:
            words = wait()
            if words.dim() != 2 or words.shape[1] != 8 or words.shape[0] < len(part):
                raise ValueError(
                    f"device returned wrong-shaped digest batch "
                    f"{tuple(words.shape)} for {len(part)} rows"
                )
            for i, hx in zip(part, blake3_torch.words_to_hex(words[: len(part)], 16)):
                out[i] = hx
        return out  # type: ignore[return-value]

    return finish


def cas_ids(messages: Sequence[bytes], device: str | torch.device = "cuda") -> list[str]:
    """cas_ids for pre-assembled messages, batched per chunk bucket and
    hashed on `device`. Order-preserving."""
    if not messages:
        return []
    return cas_ids_begin(messages, device)()
