"""Pure-Python BLAKE3 (default hash mode) — the golden reference.

Written from the public BLAKE3 specification. This is the correctness
anchor for the batched torch implementation and its CUDA chunk kernel
(ops/blake3_torch.py, ops/csrc/blake3_chunk.cu), and it holds the host
tree helpers that ops/cas.py's dirty-range rehash uses. The reference framework consumes BLAKE3
for content addressing (ref:core/src/object/cas.rs:3) and full-file
validation (ref:core/src/object/validation/hash.rs).

Only the plain hash mode is implemented (no keyed hash / derive-key):
that is all the indexing pipeline uses.
"""

from __future__ import annotations

import struct

MASK32 = 0xFFFFFFFF
IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

BLOCK_LEN = 64
CHUNK_LEN = 1024


def _g(v: list[int], a: int, b: int, c: int, d: int, mx: int, my: int) -> None:
    v[a] = (v[a] + v[b] + mx) & MASK32
    v[d] ^= v[a]
    v[d] = ((v[d] >> 16) | (v[d] << 16)) & MASK32
    v[c] = (v[c] + v[d]) & MASK32
    v[b] ^= v[c]
    v[b] = ((v[b] >> 12) | (v[b] << 20)) & MASK32
    v[a] = (v[a] + v[b] + my) & MASK32
    v[d] ^= v[a]
    v[d] = ((v[d] >> 8) | (v[d] << 24)) & MASK32
    v[c] = (v[c] + v[d]) & MASK32
    v[b] ^= v[c]
    v[b] = ((v[b] >> 7) | (v[b] << 25)) & MASK32


def _round(v: list[int], m: list[int]) -> None:
    # Columns.
    _g(v, 0, 4, 8, 12, m[0], m[1])
    _g(v, 1, 5, 9, 13, m[2], m[3])
    _g(v, 2, 6, 10, 14, m[4], m[5])
    _g(v, 3, 7, 11, 15, m[6], m[7])
    # Diagonals.
    _g(v, 0, 5, 10, 15, m[8], m[9])
    _g(v, 1, 6, 11, 12, m[10], m[11])
    _g(v, 2, 7, 8, 13, m[12], m[13])
    _g(v, 3, 4, 9, 14, m[14], m[15])


def compress(
    chaining_value: tuple[int, ...] | list[int],
    block_words: list[int],
    counter: int,
    block_len: int,
    flags: int,
) -> list[int]:
    """The BLAKE3 compression function. Returns all 16 output words."""
    v = [
        chaining_value[0], chaining_value[1], chaining_value[2], chaining_value[3],
        chaining_value[4], chaining_value[5], chaining_value[6], chaining_value[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & MASK32, (counter >> 32) & MASK32, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _round(v, m)
        if r < 6:
            m = [m[MSG_PERMUTATION[i]] for i in range(16)]
    for i in range(8):
        v[i] ^= v[i + 8]
        v[i + 8] ^= chaining_value[i]
    return v


def _words_of_block(block: bytes) -> list[int]:
    padded = block + b"\x00" * (BLOCK_LEN - len(block))
    return list(struct.unpack("<16I", padded))


def _chunk_cv(chunk: bytes, counter: int, is_root: bool) -> list[int]:
    """Chaining value (or root words) of one ≤1024-byte chunk."""
    h = list(IV)
    n_blocks = max(1, (len(chunk) + BLOCK_LEN - 1) // BLOCK_LEN)
    for b in range(n_blocks):
        block = chunk[b * BLOCK_LEN:(b + 1) * BLOCK_LEN]
        flags = 0
        if b == 0:
            flags |= CHUNK_START
        if b == n_blocks - 1:
            flags |= CHUNK_END
            if is_root:
                flags |= ROOT
        out = compress(h, _words_of_block(block), counter, len(block), flags)
        h = out[:8] if b < n_blocks - 1 else out
    return h


def _parent(left_cv: list[int], right_cv: list[int], is_root: bool) -> list[int]:
    flags = PARENT | (ROOT if is_root else 0)
    return compress(IV, list(left_cv[:8]) + list(right_cv[:8]), 0, BLOCK_LEN, flags)


def blake3(data: bytes, out_len: int = 32) -> bytes:
    """One-shot BLAKE3 hash (≤64 bytes of output, enough for 64-hex digests)."""
    assert out_len <= 64, "extended XOF output not implemented"
    n_chunks = max(1, (len(data) + CHUNK_LEN - 1) // CHUNK_LEN)
    if n_chunks == 1:
        out = _chunk_cv(data, 0, is_root=True)
        return struct.pack("<16I", *out)[:out_len]

    # Binary-counter chunk stack (spec's incremental tree algorithm): the
    # last chunk is held out; slot d holds the CV of a complete 2^d-chunk
    # subtree.
    stack: list[list[int] | None] = [None] * 64
    for i in range(n_chunks - 1):
        chunk = data[i * CHUNK_LEN:(i + 1) * CHUNK_LEN]
        cv = _chunk_cv(chunk, i, is_root=False)[:8]
        count = i + 1
        d = 0
        while count & 1 == 0:
            cv = _parent(stack[d], cv, is_root=False)[:8]  # type: ignore[arg-type]
            stack[d] = None
            count >>= 1
            d += 1
        stack[d] = cv

    last = data[(n_chunks - 1) * CHUNK_LEN:]
    output = _chunk_cv(last, n_chunks - 1, is_root=False)[:8]
    remaining = n_chunks - 1
    highest = remaining.bit_length() - 1
    for d in range(64):
        if (remaining >> d) & 1:
            out16 = _parent(stack[d], output, is_root=(d == highest))  # type: ignore[arg-type]
            output = out16[:8]
    return struct.pack("<16I", *out16)[:out_len]  # noqa: F821 - n_chunks>1 guarantees a parent


def blake3_hex(data: bytes, out_len: int = 32) -> str:
    return blake3(data, out_len).hex()


# --- chunk-level tree API (incremental / dirty-range rehash) ---------------
#
# BLAKE3 is a Merkle tree over 1024-byte chunks: the root digest is a
# pure function of the per-chunk chaining values. Exposing the chunk CV
# and the CV→root merge lets a caller cache CVs per chunk and, when a
# file changes in place, recompute only the *dirty* chunks' CVs before
# re-merging — bit-identical to a full rehash (ops/cas.py dirty-range).


def chunk_chaining_value(chunk: bytes, counter: int) -> bytes:
    """Interior (non-root) chaining value of chunk number `counter` —
    32 bytes (8 LE u32 words). Only valid for multi-chunk messages: a
    single-chunk message compresses with the ROOT flag instead."""
    return struct.pack("<8I", *_chunk_cv(chunk, counter, is_root=False)[:8])


def parent_chaining_value(left: bytes, right: bytes) -> bytes:
    """Interior parent CV over two packed 32-byte child CVs."""
    out = _parent(
        list(struct.unpack("<8I", left)), list(struct.unpack("<8I", right)),
        is_root=False,
    )
    return struct.pack("<8I", *out[:8])


def root_digest_from_pair(left: bytes, right: bytes, out_len: int = 32) -> bytes:
    """Root digest when the whole tree reduces to two subtree CVs."""
    assert out_len <= 64, "extended XOF output not implemented"
    out = _parent(
        list(struct.unpack("<8I", left)), list(struct.unpack("<8I", right)),
        is_root=True,
    )
    return struct.pack("<16I", *out)[:out_len]


class StreamingBlake3:
    """Incremental hasher for unbounded inputs (validator full-file hash,
    ref:core/src/object/validation/hash.rs:9-25 reads 1MiB blocks).

    Bounded memory over unbounded file size: holds ≤1 chunk + log2 stack.
    """

    def __init__(self) -> None:
        self._stack: list[list[int] | None] = [None] * 64
        self._pending = b""
        self._count = 0  # chunks fully absorbed into the stack

    def update(self, data: bytes) -> "StreamingBlake3":
        # Walk an offset over a memoryview: no quadratic re-slicing of
        # the buffer on large updates.
        buf = self._pending + data if self._pending else data
        mv = memoryview(buf)
        off = 0
        # Keep at least one byte beyond a chunk boundary pending so the
        # final chunk is always held out for the root.
        while len(buf) - off > CHUNK_LEN:
            chunk = bytes(mv[off:off + CHUNK_LEN])
            off += CHUNK_LEN
            cv = _chunk_cv(chunk, self._count, is_root=False)[:8]
            self._count += 1
            count = self._count
            d = 0
            while count & 1 == 0:
                cv = _parent(self._stack[d], cv, is_root=False)[:8]  # type: ignore[arg-type]
                self._stack[d] = None
                count >>= 1
                d += 1
            self._stack[d] = cv
        self._pending = bytes(mv[off:])
        return self

    def digest(self, out_len: int = 32) -> bytes:
        if self._count == 0:
            out = _chunk_cv(self._pending, 0, is_root=True)
            return struct.pack("<16I", *out)[:out_len]
        output = _chunk_cv(self._pending, self._count, is_root=False)[:8]
        highest = self._count.bit_length() - 1
        out16: list[int] = []
        for d in range(64):
            if (self._count >> d) & 1:
                out16 = _parent(self._stack[d], output, is_root=(d == highest))  # type: ignore[arg-type]
                output = out16[:8]
        return struct.pack("<16I", *out16)[:out_len]

    def hexdigest(self, out_len: int = 32) -> str:
        return self.digest(out_len).hex()
