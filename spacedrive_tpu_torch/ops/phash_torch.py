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
to XLA); no hand kernel. Precision:

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
from collections.abc import Iterator
from typing import Any

import numpy as np
import torch

HASH_BITS = 64
DCT_SIZE = 32
LOW_FREQ = 8
#: rows of one `near_pairs` block; a multiple of 8, so one padded
#: array serves as the block's rows and as every column
PAIR_BLOCK = 4096

_BIT_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)  # big-endian, as np.packbits


@functools.lru_cache(maxsize=4)
def _dct_basis(n: int = DCT_SIZE) -> np.ndarray:
    """Orthonormal DCT-II basis matrix [n, n]: X = C @ x @ C.T."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    c = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    c[0] /= np.sqrt(2.0)
    return c.astype(np.float32)


def to_gray32(rgba: np.ndarray) -> np.ndarray:
    """HxWx4 uint8 → 32×32 float32 grayscale in 0..1 (PIL bilinear)."""
    from PIL import Image

    img = Image.fromarray(rgba[..., :3]).convert("L").resize(
        (DCT_SIZE, DCT_SIZE), Image.BILINEAR
    )
    return np.asarray(img, np.float32) / 255.0


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


def match_bitmap(rows: torch.Tensor, cols: torch.Tensor, threshold: int) -> torch.Tensor:
    """±1 [B, 64] × ±1 [P, 64] → packed match bitmap uint8 [B, P/8]:
    bit (r, c) is set iff the Hamming distance is ≤ `threshold`. The
    threshold is applied on the device and only the bitmap comes back,
    8× less than distances. distance ≤ t ⟺ gram ≥ 64 − 2t (the gram is
    64 minus twice the distance, an exact integer)."""
    return pack_bits(rows @ cols.T >= HASH_BITS - 2 * threshold)


def near_pairs(hashes: list[bytes], threshold: int,
               device: str | torch.device = "cuda") -> Iterator[tuple[int, int]]:
    """Yield (i, j) index pairs (i < j) within `threshold` bits, in
    row-major order, in blocks of PAIR_BLOCK rows: device memory stays
    O(PAIR_BLOCK × N), and the bitmap's nonzero bytes are decoded on the
    device, so only the pairs come back to the host."""
    if not hashes:
        return
    bits = unpack_hashes(hashes)
    n = bits.shape[0]
    # one padded array serves as rows AND columns; the phantom pad rows
    # (all ones) are dropped on decode
    pad = (-n) % PAIR_BLOCK
    if pad:
        bits = np.concatenate([bits, np.ones((pad, HASH_BITS), bool)])
    pm = _plus_minus(torch.from_numpy(bits).to(device))
    thr = max(0, min(HASH_BITS, int(threshold)))
    shifts = torch.tensor(_BIT_SHIFTS, dtype=torch.uint8, device=pm.device)
    offsets = torch.arange(8, device=pm.device)
    for off in range(0, n, PAIR_BLOCK):
        packed = match_bitmap(pm[off:off + PAIR_BLOCK], pm, thr)  # [B, P/8]
        r, byte = torch.nonzero(packed, as_tuple=True)  # row-major
        set_bits = ((packed[r, byte][:, None] >> shifts) & 1).bool()  # [M, 8]
        i = (off + r)[:, None].expand(-1, 8)
        c = byte[:, None] * 8 + offsets
        keep = set_bits & (i < c) & (c < n)
        pairs = torch.stack([i[keep], c[keep]], dim=1).cpu().tolist()
        yield from ((a, b) for a, b in pairs)


def duplicate_groups(hashes: list[tuple[Any, bytes]], threshold: int = 8,
                     device: str | torch.device = "cuda") -> list[list[Any]]:
    """Group ids whose pHashes are within `threshold` bits (union-find
    over the blockwise-thresholded pairs; never builds the N×N matrix).
    Each group lists its ids in input order; groups come in the order of
    their first id."""
    if not hashes:
        return []
    ids = [i for i, _h in hashes]
    n = len(ids)
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for r, c in near_pairs([h for _i, h in hashes], threshold, device):
        ra, rb = find(r), find(c)
        if ra != rb:
            parent[rb] = ra
    groups: dict[int, list[Any]] = {}
    for idx in range(n):
        groups.setdefault(find(idx), []).append(ids[idx])
    return [g for g in groups.values() if len(g) > 1]
