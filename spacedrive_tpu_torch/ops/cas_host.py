"""The host halves of content addressing: the sampling layout, the
message reads, the dirty-range chunk cache and the host C hash.

Counterpart of the host half of `spacedrive_tpu/ops/cas.py`. This
module imports no torch: the process pool's ``identify.hash_entries``
stage (`parallel/procworker.py`) runs it in a worker, and `ops/cas.py`
re-exports every name here unchanged.
"""

from __future__ import annotations

import hashlib
import os
import struct
from dataclasses import dataclass
from typing import Any, Sequence

from .blake3_ref import CHUNK_LEN

SAMPLE_COUNT = 4
SAMPLE_SIZE = 10 * 1024
HEADER_OR_FOOTER_SIZE = 8 * 1024
MINIMUM_FILE_SIZE = 100 * 1024

LARGE_MSG_LEN = 8 + 2 * HEADER_OR_FOOTER_SIZE + SAMPLE_COUNT * SAMPLE_SIZE  # 57,352
LARGE_CHUNKS = (LARGE_MSG_LEN + 1023) // 1024  # 57
MAX_SMALL_MSG_LEN = 8 + MINIMUM_FILE_SIZE  # 102,408
# Small-file buckets by chunk count.
SMALL_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 101)


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


def cas_ids_host(messages: Sequence[bytes]) -> list[str]:
    """cas_ids through the host C hasher (`ops/blake3_host.py`), bit for
    bit `blake3_ref`: the pool worker's hash leg. A failed native build
    raises `NativeBuildError`."""
    from .blake3_host import blake3_digest

    return [blake3_digest(m, 8).hex() for m in messages]
