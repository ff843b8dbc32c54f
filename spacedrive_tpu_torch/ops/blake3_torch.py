"""Batched BLAKE3 in PyTorch; bit-exact with `blake3_ref`.

Counterpart of `spacedrive_tpu/ops/blake3_jax.py`. A batch of B messages,
each zero-padded to `C * 1024` bytes, hashes as `N = B*C` independent
chunk lanes: BLAKE3 chunks chain from the IV with only a chunk counter,
so every chunk of every file is parallel. The chunk stage goes through
`blake3_cuda.chunk_cvs` — the CUDA kernel for a CUDA tensor, the plain
torch version `chunk_cvs_plain` below for a CPU tensor. The chunk→root
tree reduction then runs level by level as batched parent compressions
(`_tree_reduce`), as torch ops.

The device carries the uint32 words as int32 (torch's uint32 lacks most
operations). The torch compression works on int64 holding values in
[0, 2**32), masked after every add and shift: on int32, torch's `>>` is
arithmetic and would smear the sign bit into a rotate.
"""

from __future__ import annotations

import numpy as np
import torch

from . import blake3_cuda
from .blake3_ref import CHUNK_END, CHUNK_START, IV, MSG_PERMUTATION, PARENT, ROOT

CHUNK_LEN = 1024
BLOCK_LEN = 64
_MASK = 0xFFFFFFFF
_PERM = list(MSG_PERMUTATION)


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) | ((x << (32 - r)) & _MASK)


def _g(a, b, c, d, mx, my):
    """Four G functions at once: a, b, c, d, mx, my are [4, ...] int64."""
    a = (a + b + mx) & _MASK
    d = _rotr(d ^ a, 16)
    c = (c + d) & _MASK
    b = _rotr(b ^ c, 12)
    a = (a + b + my) & _MASK
    d = _rotr(d ^ a, 8)
    c = (c + d) & _MASK
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def _compress8(
    h: torch.Tensor,
    m: torch.Tensor,
    t_lo: torch.Tensor,
    block_len: torch.Tensor | int,
    flags: torch.Tensor,
) -> torch.Tensor:
    """Vectorized compression; returns the 8 chaining-value words.

    h int64 [8, *L]; m int64 [16, *L]; t_lo, block_len and flags int64
    broadcastable to L. The state is kept as its four rows of 4 words,
    so each half-round is ONE batched G over 4 lanes of rows; the
    diagonal half-round rotates rows b, c, d into place and back."""
    shape = h.shape[1:]
    zeros = torch.zeros(shape, dtype=torch.int64, device=h.device)
    a, b = h[0:4], h[4:8]
    c = torch.tensor(IV[:4], dtype=torch.int64, device=h.device).view(4, *[1] * len(shape)).expand(4, *shape)
    d = torch.stack([zeros + t_lo, zeros, zeros + block_len, zeros + flags])
    for _ in range(7):
        a, b, c, d = _g(a, b, c, d, m[0:8:2], m[1:8:2])
        b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)
        a, b, c, d = _g(a, b, c, d, m[8:16:2], m[9:16:2])
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
        m = m[_PERM]
    return torch.cat([a ^ c, b ^ d])


def _iv8(shape, device) -> torch.Tensor:
    iv = torch.tensor(IV, dtype=torch.int64, device=device)
    return iv.view(8, *[1] * len(shape)).expand(8, *shape)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) → the same bits as int32."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → int64 words in [0, 2**32)."""
    return x.to(torch.int64) & _MASK


def chunk_cvs_plain(
    words: torch.Tensor,
    chunk_len: torch.Tensor,
    is_root: torch.Tensor,
    t_lo: torch.Tensor,
) -> torch.Tensor:
    """Plain torch version of the chunk kernel (same contract as
    `blake3_cuda.chunk_cvs`): words int32 [N, 256], chunk_len / is_root /
    t_lo int32 [N] → chaining values int32 [8, N]. Counterpart of the
    XLA chunk stage in blake3_jax._chunk_cvs: every lane walks the
    blocks with block length, flags and the active mask derived from its
    chunk_len. Blocks past the longest lane change nothing and are
    skipped."""
    n = words.shape[0]
    if n == 0:
        return torch.empty((8, 0), dtype=torch.int32, device=words.device)
    wm = _as_u32(words).view(n, 16, 16).permute(1, 2, 0)  # [blk, word, N]
    cl = chunk_len.to(torch.int64)
    n_blocks = ((cl + BLOCK_LEN - 1) // BLOCK_LEN).clamp(min=1)
    root = is_root != 0
    t = _as_u32(t_lo)
    h = _iv8((n,), words.device)
    for b in range(int(n_blocks.max())):
        block_len = (cl - b * BLOCK_LEN).clamp(0, BLOCK_LEN)
        last = n_blocks == b + 1
        flags = (
            torch.where(last, CHUNK_END, 0)
            | torch.where(last & root, ROOT, 0)
            | (CHUNK_START if b == 0 else 0)
        )
        out = _compress8(h, wm[b], t, block_len, flags)
        h = torch.where(n_blocks > b, out, h)
    return _to_int32(h)


def _parent_cvs(left: torch.Tensor, right: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Batched parent compression. left/right int64 [..., 8]; flags
    int64 [...] → int64 [..., 8]."""
    m = torch.cat([left.movedim(-1, 0), right.movedim(-1, 0)])
    out = _compress8(_iv8(flags.shape, flags.device), m, 0, BLOCK_LEN, flags)
    return out.movedim(0, -1)


def chunk_lanes(
    words: torch.Tensor, lengths: torch.Tensor, max_chunks: int
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """The chunk stage's inputs for a batch: words int32 [B, C*256],
    lengths int32 [B] → ((words [N, 256], chunk_len, is_root, t_lo int32
    [N]), n_chunks int64 [B]) with N = B*C lanes, chunk-major. Single-
    chunk messages get their ROOT flag here."""
    b_dim, wpad = words.shape
    c_dim = max_chunks
    if wpad != c_dim * 256:
        raise ValueError(f"words [{b_dim}, {wpad}] do not hold {c_dim} chunks a row")
    device = words.device
    lens = lengths.to(torch.int64)
    n_chunks = ((lens + CHUNK_LEN - 1) // CHUNK_LEN).clamp(min=1)
    idx = torch.arange(c_dim, dtype=torch.int64, device=device).expand(b_dim, c_dim)
    n = b_dim * c_dim
    chunk_len = (lens[:, None] - idx * CHUNK_LEN).clamp(0, CHUNK_LEN).reshape(n)
    is_root = (n_chunks == 1)[:, None].expand(b_dim, c_dim).reshape(n)
    lanes = (
        words.contiguous().view(n, 256),
        chunk_len.to(torch.int32),
        is_root.to(torch.int32),
        idx.reshape(n).to(torch.int32),
    )
    return lanes, n_chunks


def _tree_reduce(cvs: torch.Tensor, n_chunks: torch.Tensor) -> torch.Tensor:
    """Reduce [B, C, 8] chunk CVs to [B, 8] root words.

    Level d pairs adjacent nodes; a file's leftover at level d exists
    iff bit d of its chunk count is set (binary-counter identity with
    the spec's incremental stack). The right spine then merges saved
    nodes lowest-level-first; the highest merge carries ROOT."""
    b_dim, c_dim, _ = cvs.shape
    if c_dim == 1:
        return cvs[:, 0, :]
    device = cvs.device
    n_d = n_chunks
    saved = []  # (bit_set[B], cv[B, 8]) per level, lowest first
    cur = cvs
    d = 0
    while cur.shape[1] > 1:
        width = cur.shape[1]
        bit = (n_d & 1) == 1
        idx = (n_d - 1).clamp(0, width - 1)
        leftover = torch.gather(cur, 1, idx[:, None, None].expand(b_dim, 1, 8))[:, 0, :]
        saved.append((bit, leftover))
        pairs = width // 2
        left = cur[:, 0:2 * pairs:2, :]
        right = cur[:, 1:2 * pairs + 1:2, :]
        # the j==0 pair is the file's root iff exactly 2 nodes remain
        # here and no leftovers were saved below (n == 2 << d)
        is_root_pair = n_chunks == (2 << d)
        cols = torch.arange(pairs, device=device)
        flags = torch.where(
            (cols[None, :] == 0) & is_root_pair[:, None], PARENT | ROOT, PARENT
        )
        cur = _parent_cvs(left, right, flags)
        n_d = n_d >> 1
        d += 1
    saved.append(((n_d & 1) == 1, cur[:, 0, :]))

    out = torch.zeros((b_dim, 8), dtype=torch.int64, device=device)
    started = torch.zeros((b_dim,), dtype=torch.bool, device=device)
    for d, (bit, cv) in enumerate(saved):
        # ROOT iff no higher bits remain above level d
        is_top = (n_chunks >> (d + 1)) == 0
        flags = torch.where(is_top, PARENT | ROOT, PARENT)
        merged = _parent_cvs(cv, out, flags)
        out = torch.where(
            (bit & ~started)[:, None], cv,
            torch.where((bit & started)[:, None], merged, out),
        )
        started = started | bit
    return out


def host_words(msgs) -> torch.Tensor:
    """int32 [B, C*256] CPU tensor over a host batch, without a copy
    where the input allows: numpy uint8 → `.view(np.uint32)` →
    `.view(np.int32)` → `torch.from_numpy` (the words ARE the
    little-endian byte stream). Torch tensors pass through (uint8 is
    viewed as int32)."""
    if isinstance(msgs, torch.Tensor):
        return msgs.view(torch.int32) if msgs.dtype == torch.uint8 else msgs
    arr = np.asarray(msgs)
    if arr.dtype == np.uint8:
        arr = np.ascontiguousarray(arr).view(np.uint32)
    if arr.dtype != np.uint32 and arr.dtype != np.int32:
        raise ValueError(f"messages must be uint8 bytes or uint32 words, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int32))


def hash_batch(
    msgs, lengths, max_chunks: int | None = None, device="cuda", chunk_stage=None
) -> torch.Tensor:
    """Hash B messages. msgs: uint8 [B, C*1024] (zero-padded) or its
    uint32/int32 [B, C*256] word view, numpy or torch; lengths: int32
    [B] byte counts. Returns int32 [B, 8] on `device`: the first 32
    digest bytes as little-endian uint32 words, carried as int32.

    The chunk stage is `chunk_stage` (default `blake3_cuda.chunk_cvs`:
    the CUDA kernel on a CUDA device, the plain torch version on the
    CPU; parity checks pass `chunk_cvs_plain` to run the plain version
    on the card). Inputs already on `device` are used in place; host
    inputs are copied (non-blocking from pinned memory)."""
    words = host_words(msgs)
    if words.dtype != torch.int32:
        raise ValueError(f"message words must be int32, got {words.dtype}")
    if max_chunks is None:
        max_chunks = words.shape[1] // 256
    words = words.to(device, non_blocking=True)
    lens = torch.as_tensor(lengths, dtype=torch.int32).to(device, non_blocking=True)
    lanes, n_chunks = chunk_lanes(words, lens, max_chunks)
    cv8 = (chunk_stage or blake3_cuda.chunk_cvs)(*lanes)  # [8, N]
    cvs = _as_u32(cv8).T.reshape(words.shape[0], max_chunks, 8)
    return _to_int32(_tree_reduce(cvs, n_chunks))


def words_to_digests(words, out_len: int = 32) -> list[bytes]:
    """Host-side: [B, 8] uint32 LE words (int32 bit patterns, numpy or
    torch) → digest bytes."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(words).astype(np.int32).view(np.uint32).astype("<u4"))
    raw = arr.tobytes()
    return [raw[i * 32:i * 32 + out_len] for i in range(arr.shape[0])]


def words_to_hex(words, hex_chars: int = 64) -> list[str]:
    nbytes = (hex_chars + 1) // 2
    return [d.hex()[:hex_chars] for d in words_to_digests(words, nbytes)]
