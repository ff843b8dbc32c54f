"""The plain reference of full-library duplicate detection.

From the generated hashes and cas_ids alone:

- near pairs: every pair of objects whose 64-bit pHashes differ in at
  most `threshold` bits. The distance comes from a product of ±1 bit
  vectors, 64 − 2·distance: float16 on the card (each term ±1 and each
  partial sum an integer of at most 64 in magnitude, exact in float16
  whatever the order of the sums), float32 on the CPU, in blocks of rows
  against the columns to their right, so the N × N matrix never exists;
- near groups: the connected components of those pairs (NumPy hooking
  and pointer jumping);
- exact groups: every cas_id that more than one object carries;
- each group's file rows, from the generator's columns.

`probe_chunks` makes it the control: a pair then counts only where the
two hashes agree exactly on one of `probe_chunks` equal bit chunks, the
candidate filter of a multi-index hash with exact probes, which
guarantees only distances below `probe_chunks`. It breaks the guarantee
that every pair within the threshold is found.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass

import numpy as np
import torch

HASH_BITS = 64
BLOCK_ROWS = 2048
FILE_KEYS = ("name", "extension", "materialized_path", "cas_id", "size_in_bytes")


def plus_minus(phash: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint64 [n] → [n, 64] of ±1, column 0 being bit 63: float16 on the
    card, float32 on the CPU."""
    shifts = np.arange(HASH_BITS - 1, -1, -1, dtype=np.uint64)
    bits = ((phash[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.int8)
    dtype = torch.float16 if device.type == "cuda" else torch.float32
    return torch.from_numpy(bits).to(device).to(dtype) * 2 - 1


def chunks(phash: np.ndarray, k: int, device: torch.device) -> torch.Tensor:
    """int64 [n, k]: the hashes cut into k chunks of 64/k bits."""
    width = HASH_BITS // k
    mask = np.uint64((1 << width) - 1)
    parts = [((phash >> np.uint64(width * j)) & mask).astype(np.int64) for j in range(k)]
    return torch.from_numpy(np.stack(parts, axis=1)).to(device)


def near_pairs(phash: np.ndarray, threshold: int, device: torch.device | str,
               probe_chunks: int | None = None) -> np.ndarray:
    """int64 [M, 2]: every (i, j), i < j, within `threshold` bits."""
    device = torch.device(device)
    n = phash.shape[0]
    if n < 2:
        return np.zeros((0, 2), np.int64)
    pm = plus_minus(phash, device)
    ck = chunks(phash, probe_chunks, device) if probe_chunks else None
    floor = float(HASH_BITS - 2 * int(threshold))
    out = []
    for off in range(0, n, BLOCK_ROWS):
        rows = pm[off:off + BLOCK_ROWS]
        hit = (rows @ pm[off:].T) >= floor  # [b, n - off]; column c is object off + c
        if ck is not None:
            rc, cc = ck[off:off + BLOCK_ROWS], ck[off:]
            cand = rc[:, None, 0] == cc[None, :, 0]
            for j in range(1, probe_chunks):
                cand |= rc[:, None, j] == cc[None, :, j]
            hit &= cand
        r, c = torch.nonzero(hit, as_tuple=True)
        keep = c > r  # right of the diagonal
        out.append(torch.stack([r[keep] + off, c[keep] + off], 1).cpu().numpy())
        del hit
    return np.concatenate(out).astype(np.int64)


def components(n: int, pairs: np.ndarray) -> list[np.ndarray]:
    """The groups (index arrays, each of 2 or more) that `pairs` join."""
    if len(pairs) == 0:
        return []
    a, b = pairs[:, 0], pairs[:, 1]
    parent = np.arange(n, dtype=np.int64)
    while True:
        pa, pb = parent[a], parent[b]
        moved = pa != pb
        if not moved.any():
            break
        lo, hi = np.minimum(pa[moved], pb[moved]), np.maximum(pa[moved], pb[moved])
        np.minimum.at(parent, hi, lo)
        while True:  # pointer jumping to the roots
            nxt = parent[parent]
            if np.array_equal(nxt, parent):
                break
            parent = nxt
    touched = np.unique(pairs.reshape(-1))
    roots = parent[touched]
    order = np.argsort(roots, kind="stable")
    roots, touched = roots[order], touched[order]
    cuts = np.flatnonzero(np.diff(roots)) + 1
    return [g for g in np.split(touched, cuts) if len(g) > 1]


def exact_groups(cas: np.ndarray) -> list[np.ndarray]:
    """Indices of the objects of every cas_id that more than one carries."""
    _u, inv, counts = np.unique(cas, return_inverse=True, return_counts=True)
    shared = np.flatnonzero(counts > 1)
    idx = np.flatnonzero(np.isin(inv, shared))
    order = np.argsort(inv[idx], kind="stable")
    idx = idx[order]
    cuts = np.flatnonzero(np.diff(inv[idx])) + 1
    return [g for g in np.split(idx, cuts) if len(g) > 1]


@dataclass
class Expected:
    """What a duplicates pass over the library should answer."""

    data: object  # gen.library.LibraryData
    near: collections.Counter  # frozenset of object ids → count
    exact: collections.Counter

    def file_row(self, object_id: int) -> tuple | None:
        """The one file row of an object, as the FILE_KEYS tuple (None for
        an id that no object has)."""
        i = int(object_id) - 1
        d = self.data
        if not 0 <= i < d.n:
            return None
        return (d.name(i), d.extension(i), d.materialized_path(i), d.cas_id(i), int(d.size[i]))

    def as_result(self) -> list[dict]:
        """These groups in the program's answer shape (the control's
        answer, when built with `probe_chunks`)."""
        out = []
        for kind, groups in (("near", self.near), ("exact", self.exact)):
            for g, count in groups.items():
                ids = sorted(g)
                files = [dict(zip(FILE_KEYS, self.file_row(o))) for o in ids]
                out.extend({"object_ids": ids, "kind": kind, "files": files}
                           for _ in range(count))
        return out


def expect(data, threshold: int, device: torch.device | str,
           probe_chunks: int | None = None) -> Expected:
    """The reference's answer for `data` (a `gen.library.LibraryData`)."""
    pairs = near_pairs(data.phash, threshold, device, probe_chunks)
    oid = np.arange(1, data.n + 1)
    near = collections.Counter(frozenset(oid[g].tolist()) for g in components(data.n, pairs))
    exact = collections.Counter(frozenset(oid[g].tolist()) for g in exact_groups(data.cas))
    return Expected(data, near, exact)
