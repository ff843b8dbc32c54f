"""Perceptual hashing and all-pairs similarity on the device.

Counterpart of `spacedrive_tpu/ops/phash_jax.py` (BASELINE.json config
5, full-library dedup): a batched 64-bit DCT pHash, then all-pairs
Hamming distance as one ±1 matrix product, in row blocks so that a
million-image library never materialises N × N.

Math: image → grayscale 32×32 → 2-D DCT-II (two matrix products with
the orthonormal DCT basis) → the 8×8 low-frequency block minus the DC
term → threshold at the median of the 63 AC terms → 64 bits, packed
big-endian as `np.packbits` packs them. Similarity: with bits mapped to
±1, G = B @ B.T counts agreements minus disagreements, so
hamming = (64 − G) / 2.

These are torch ops on the caller's device (the JAX package leaves them
to XLA), but for the pair search on a card: there each row block of
`near_pairs` is one hand-written kernel, H1 (`hamming_cuda.py`), an
XOR-popcount over the upper triangle that writes only the pairs; the ±1
product (`plain_block`) is its plain version and the CPU's path.
Precision:

- The DCT runs in float64 on every device. A float32 product on the
  card may run in TF32 under `torch.backends.cuda.matmul.allow_tf32` or
  `torch.set_float32_matmul_precision`, which moves coefficients by
  about 1e-3 and flips bits near the median; no global setting touches
  a float64 product, so the bits do not depend on them. The threshold
  compares float64 coefficients, so a bit can differ from the JAX
  package's float32 DCT only where its coefficient lies within float32
  rounding of the median.
- The gram is exact: ±1 entries and integer sums within ±64 are exact
  in bf16 (the card's operand type here) and in float32 (the CPU's).
"""

from __future__ import annotations

import functools
from collections.abc import Callable, Iterator
from typing import Any, Sequence

import numpy as np
import torch

from ..parallel import mesh as _mesh
from ..telemetry import current_span, span
from . import hamming_cuda
from .phash_gray import DCT_SIZE, to_gray32  # noqa: F401 - re-exported

HASH_BITS = 64
LOW_FREQ = 8
#: rows of one `near_pairs` block; a multiple of 8 and of H1's tile, so
#: one padded array serves as the block's rows and as every column
PAIR_BLOCK = 4096
#: pairs a block's first launch has room for; a block with more is
#: launched once more at its count (~230 a block in a 2^20-image library
#: with 4% of its images in near clusters)
PAIR_CAPACITY = 1 << 16

_BIT_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)  # big-endian, as np.packbits


@functools.lru_cache(maxsize=4)
def _dct_basis(n: int = DCT_SIZE) -> np.ndarray:
    """Orthonormal DCT-II basis matrix [n, n]: X = C @ x @ C.T."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    c = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    c[0] /= np.sqrt(2.0)
    return c.astype(np.float32)


def dct_low(gray: torch.Tensor) -> torch.Tensor:
    """float [B, 32, 32] → float64 [B, 64]: the 8×8 low-frequency block
    of each plane's 2-D DCT-II, row-major, with the DC term set to 0."""
    basis = torch.from_numpy(_dct_basis()).to(gray.device, torch.float64)
    coeffs = basis @ gray.to(torch.float64) @ basis.T
    ac = coeffs[:, :LOW_FREQ, :LOW_FREQ].reshape(-1, LOW_FREQ * LOW_FREQ).clone()
    ac[:, 0] = 0.0  # drop the DC term
    return ac


def phash_bits(gray: torch.Tensor) -> torch.Tensor:
    """float [B, 32, 32] (0..1 grayscale) → bool [B, 64]: AC terms above
    the median of the 63 AC terms (an odd count: the middle one)."""
    ac = dct_low(gray)
    med = ac[:, 1:].median(dim=1, keepdim=True).values
    return ac > med


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool [..., 8k] → uint8 [..., k], big-endian within each byte."""
    grouped = bits.reshape(*bits.shape[:-1], -1, 8)
    out = torch.zeros(grouped.shape[:-1], dtype=torch.uint8, device=bits.device)
    for k, shift in enumerate(_BIT_SHIFTS):
        out |= grouped[..., k].to(torch.uint8) << shift
    return out


def phash_batch(gray: np.ndarray, device: str | torch.device = "cuda") -> np.ndarray:
    """float32[B, 32, 32] → packed uint8[B, 8] hashes (big-endian bits),
    computed on `device`."""
    gray = np.asarray(gray, np.float32)
    if gray.ndim != 3 or gray.shape[1:] != (DCT_SIZE, DCT_SIZE):
        raise ValueError(f"phash input shape {gray.shape} is not [B, 32, 32]")
    if gray.shape[0] == 0:
        return np.zeros((0, HASH_BITS // 8), np.uint8)
    bits = phash_bits(torch.from_numpy(gray).to(device))
    return pack_bits(bits).cpu().numpy()


def phash_one(rgba: np.ndarray, device: str | torch.device = "cuda") -> bytes:
    return phash_batch(to_gray32(rgba)[None], device)[0].tobytes()


def unpack_hashes(hashes: list[bytes]) -> np.ndarray:
    """list of 8-byte hashes → bool[N, 64]."""
    arr = np.frombuffer(b"".join(hashes), np.uint8).reshape(-1, 8)
    return np.unpackbits(arr, axis=1).astype(bool)


def _plus_minus(bits: torch.Tensor) -> torch.Tensor:
    """bool [..., 64] → ±1 in an operand type whose product is exact:
    bf16 on the card, float32 on the CPU (whose bf16 products are slow)."""
    dtype = torch.bfloat16 if bits.device.type == "cuda" else torch.float32
    return bits.to(dtype) * 2 - 1


def hamming_matrix(hashes: list[bytes], device: str | torch.device = "cuda") -> np.ndarray:
    """All-pairs Hamming distances on `device` (uint8[N, N])."""
    if not hashes:
        return np.zeros((0, 0), np.uint8)
    pm = _plus_minus(torch.from_numpy(unpack_hashes(hashes)).to(device))
    gram = (pm @ pm.T).to(torch.int32)  # agreements − disagreements
    return ((HASH_BITS - gram) // 2).to(torch.uint8).cpu().numpy()


def hamming_matrix_sharded(hashes: list[bytes], device: str | torch.device = "cuda",
                           devices: Sequence[torch.device] | None = None) -> np.ndarray:
    """`hamming_matrix` with its rows split over a slot list (`devices`,
    else the dispatch devices of `device`'s type, else `device` alone):
    the rows pad to a multiple of the slot count, each slot holds the
    full ±1 column matrix (64 wide, tiny) and computes its share of rows;
    the shares come back in row order. Exactly `hamming_matrix`."""
    if not hashes:
        return np.zeros((0, 0), np.uint8)
    slots = [torch.device(d) for d in devices] if devices is not None else (
        _mesh.auto_slots(device) or [torch.device(device)])
    bits = unpack_hashes(hashes)
    n = bits.shape[0]
    bits, _pad = _mesh.pad_to_multiple(bits, len(slots))
    r = bits.shape[0] // len(slots)
    shares = []
    for s, dev in enumerate(slots):
        pm = _plus_minus(torch.from_numpy(bits).to(dev))
        gram = (pm[s * r:(s + 1) * r] @ pm.T).to(torch.int32)
        shares.append(((HASH_BITS - gram) // 2).to(torch.uint8))
    return np.concatenate([share.cpu().numpy() for share in shares])[:n, :n]


def match_bitmap(rows: torch.Tensor, cols: torch.Tensor, threshold: int) -> torch.Tensor:
    """±1 [B, 64] × ±1 [P, 64] → packed match bitmap uint8 [B, P/8]:
    bit (r, c) is set iff the Hamming distance is ≤ `threshold`. The
    threshold is applied on the device and only the bitmap comes back,
    8× less than distances. distance ≤ t ⟺ gram ≥ 64 − 2t (the gram is
    64 minus twice the distance, an exact integer)."""
    return pack_bits(rows @ cols.T >= HASH_BITS - 2 * threshold)


def plain_block(pm: torch.Tensor, n: int, off: int, threshold: int) -> np.ndarray:
    """H1's function in torch ops: the pairs (i, j) of the row block at
    `off` (PAIR_BLOCK rows of the padded ±1 operand `pm`, whose first n
    rows are the hashes) with i < j < n within `threshold` bits, on the
    host as int64 (i << 32) | j in row-major order, every one of them."""
    packed = match_bitmap(pm[off:off + PAIR_BLOCK], pm, threshold)  # [B, P/8]
    r, byte = torch.nonzero(packed, as_tuple=True)  # row-major
    shifts = torch.tensor(_BIT_SHIFTS, dtype=torch.uint8, device=pm.device)
    set_bits = ((packed[r, byte][:, None] >> shifts) & 1).bool()  # [M, 8]
    i = (off + r)[:, None].expand(-1, 8)
    c = byte[:, None] * 8 + torch.arange(8, device=pm.device)
    keep = set_bits & (i < c) & (c < n)
    return ((i[keep] << 32) | c[keep]).cpu().numpy()


def decode_pairs(packed: np.ndarray) -> list[tuple[int, int]]:
    """int64 pairs packed as (i << 32) | j, in any order → [(i, j)] in
    row-major order (i, then j, ascending)."""
    packed = np.sort(packed)
    return list(zip((packed >> 32).tolist(), (packed & 0xFFFFFFFF).tolist()))


def block_pairs(launch: Callable[[int, int], tuple[np.ndarray, float | None]], off: int,
                capacity: int) -> tuple[list[tuple[int, int]], int, float | None]:
    """One row block's pairs in row-major order, whether the block took
    a second launch (0 or 1), and the device seconds of its launches
    (None where the launcher times nothing).

    `launch(off, capacity)` returns the block's buffer on the host (H1's
    layout: the count of pairs, then room for at least `capacity` of
    them, the first ones found, in any order) and its device seconds. A
    count past the buffer's room launches the block once more, with the
    exact count as its capacity; a second count that differs raises
    RuntimeError."""
    buf, device_s = launch(off, capacity)
    count = int(buf[0])
    relaunched = 0
    if count > buf.size - 1:
        buf, again_s = launch(off, count)
        relaunched = 1
        if int(buf[0]) != count:
            raise RuntimeError(f"the block at row {off} found {int(buf[0])} pairs on its "
                               f"relaunch, {count} on its first launch")
        if device_s is not None:
            device_s += again_s
    return decode_pairs(buf[1:1 + count]), relaunched, device_s


def _plain_launcher(pm: torch.Tensor, n: int, threshold: int):
    """`block_pairs`' launcher off a card: `plain_block`, untimed, with
    room for every pair it finds, so a block never takes a relaunch."""

    def launch(off: int, capacity: int) -> tuple[np.ndarray, None]:
        found = plain_block(pm, n, off, threshold)
        return np.concatenate(([found.size], found)), None

    return launch


def _card_launcher(table: torch.Tensor, n: int, threshold: int):
    """`block_pairs`' launcher on a card: H1 on the current stream, timed
    by CUDA events around the launch, its buffer copied to the host."""

    def launch(off: int, capacity: int) -> tuple[np.ndarray, float]:
        stream = torch.cuda.current_stream(table.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        buf = hamming_cuda.near_pairs_block(table, n, off, PAIR_BLOCK, threshold, capacity)
        end.record(stream)
        host = buf.cpu().numpy()
        end.synchronize()  # no wait: the copy to the host came after it
        return host, start.elapsed_time(end) / 1e3

    return launch


def near_pairs(hashes: list[bytes], threshold: int,
               device: str | torch.device = "cuda") -> Iterator[tuple[int, int]]:
    """Yield (i, j) index pairs (i < j) within `threshold` bits, in
    row-major order, in blocks of PAIR_BLOCK rows. On a card each block
    is one launch of H1, which writes only the block's pairs (at most
    PAIR_CAPACITY, counting past it; a block with more is launched once
    more at its count): device memory stays O(N + pairs). Elsewhere each
    block is one `plain_block`, O(PAIR_BLOCK × N), which returns all its
    pairs at once. Either way only the pairs come back to the host,
    sorted by `block_pairs`.

    Spans: `prepare` (the pad and the upload: the hashes as int64 on a
    card, the ±1 operand elsewhere), then one `block` a block, closed
    once the block's pairs are a host list: a generator runs in its
    consumer's context, so no span stays open across a yield. Each
    block's span carries `pairs` (the block's pairs) and `relaunched`
    (0 or 1); on a card also `device_s`, the seconds between CUDA events
    recorded before and after its launches."""
    if not hashes:
        return
    with span("prepare"):
        n = len(hashes)
        pad = (-n) % PAIR_BLOCK  # one padded array serves as rows AND columns
        thr = max(0, min(HASH_BITS, int(threshold)))
        if torch.device(device).type == "cuda":
            joined = b"".join(hashes)
            if len(joined) != 8 * n:
                raise ValueError("near_pairs takes 8-byte hashes")
            table = torch.frombuffer(bytearray(joined) + bytes(8 * pad), dtype=torch.int64)
            launch = _card_launcher(table.to(device), n, thr)
        else:
            bits = unpack_hashes(hashes)
            if pad:
                bits = np.concatenate([bits, np.ones((pad, HASH_BITS), bool)])
            launch = _plain_launcher(_plus_minus(torch.from_numpy(bits).to(device)), n, thr)
    for off in range(0, n, PAIR_BLOCK):
        with span("block") as block:
            pairs, relaunched, device_s = block_pairs(launch, off, PAIR_CAPACITY)
            block.annotate(pairs=len(pairs), relaunched=relaunched)
            if device_s is not None:
                block.annotate(device_s=device_s)
        yield from pairs


def duplicate_groups(hashes: list[tuple[Any, bytes]], threshold: int = 8,
                     device: str | torch.device = "cuda") -> list[list[Any]]:
    """Group ids whose pHashes are within `threshold` bits (union-find
    over the blockwise-thresholded pairs; never builds the N×N matrix).
    Each group lists its ids in input order; groups come in the order of
    their first id.

    Spans: `near` the whole grouping, `near_pairs`' spans inside it, and
    `components` the final find of every id and the groups. The number of
    pairs goes on the caller's span as `pairs`, where there is one."""
    caller = current_span()
    with span("near"):
        groups, pairs = _union_find(hashes, threshold, device)
    if caller is not None:
        caller.annotate(pairs=pairs)
    return groups


def _union_find(hashes: list[tuple[Any, bytes]], threshold: int,
                device: str | torch.device) -> tuple[list[list[Any]], int]:
    """`duplicate_groups`' groups and the number of pairs found; its
    million-entry lists are freed on return, inside the caller's span."""
    ids = [i for i, _h in hashes]
    n = len(ids)
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    pairs = 0
    for r, c in near_pairs([h for _i, h in hashes], threshold, device):
        pairs += 1
        ra, rb = find(r), find(c)
        if ra != rb:
            parent[rb] = ra
    with span("components"):
        groups: dict[int, list[Any]] = {}
        for idx in range(n):
            groups.setdefault(find(idx), []).append(ids[idx])
        return [g for g in groups.values() if len(g) > 1], pairs
