"""Full-file BLAKE3 checksums: batched on the device for small files,
streamed on the host for the rest.

Counterpart of `spacedrive_tpu/object/validation/hash.py`
(ref:core/src/object/validation/hash.rs:9-25: 1 MiB read blocks, a
64-hex digest). A validation pass over a library is mostly many small
files: files of 1 B to DEVICE_MAX_BYTES group by power-of-two chunk
bucket (1, 2, 4, ... 256 chunks) and hash as padded batches of at most
`cas.DEVICE_BATCH` rows through `blake3_torch.hash_batch`, whose chunk
stage is the BLAKE3 chunk kernel (K1) on a CUDA device and its plain
torch version on the CPU. A bucket of fewer than _MIN_DEVICE_BATCH
files, an empty file and a file over DEVICE_MAX_BYTES stream through the
host hasher (`ops/blake3_host.py`) in BLOCK_LEN blocks, so memory stays
bounded over unbounded sizes. Every leg gives the same digest.

`device` takes the place of the JAX package's `backend` ("tpu" /
"device" / "auto" / "cpu"): a torch device, "cuda" or "cpu". A CUDA
failure raises; there is no host fallback for a bucket.
"""

from __future__ import annotations

import collections
import os
from collections.abc import Sequence

import torch

from ...ops import blake3_torch, cas
from ...ops.blake3_host import StreamingHasher

BLOCK_LEN = 1 << 20  # ref:hash.rs:9
DEVICE_MAX_BYTES = 256 * 1024  # larger files stream on the host
_MIN_DEVICE_BATCH = 16


def file_checksum(path: str | os.PathLike) -> str:
    """64-hex full BLAKE3 of one file, streamed in 1 MiB blocks on the
    host (ref:hash.rs:11-25)."""
    hasher = StreamingHasher()
    with open(path, "rb") as f:
        while block := f.read(BLOCK_LEN):
            hasher.update(block)
    return hasher.hexdigest(32)


def _bucket(n: int) -> int:
    """Chunks of the power-of-two bucket that holds n bytes."""
    chunks = max(1, (n + 1023) // 1024)
    b = 1
    while b < chunks:
        b *= 2
    return b


def file_checksums(paths: Sequence[str | os.PathLike],
                   device: str | torch.device = "cuda") -> list[str]:
    """Checksum many files; small files hash on `device` as padded
    batches bucketed by size, everything else streams on the host.
    Unreadable files yield "" instead of failing the batch. Adds the
    files of each leg to `file_checksums.device_files` (a Counter by
    bucket chunks) and `file_checksums.host_files`."""
    device = torch.device(device)
    sizes = []
    for p in paths:
        try:
            sizes.append(os.path.getsize(p))
        except OSError:
            sizes.append(-1)

    results: list[str | None] = [None] * len(paths)

    def host_hash(i: int) -> None:
        file_checksums.host_files += 1
        try:
            results[i] = file_checksum(paths[i])
        except OSError:
            results[i] = ""

    buckets: dict[int, list[int]] = {}
    for i, size in enumerate(sizes):
        if size < 0:
            results[i] = ""
        elif 0 < size <= DEVICE_MAX_BYTES:
            buckets.setdefault(_bucket(size), []).append(i)
        else:
            host_hash(i)

    for max_chunks, idxs in sorted(buckets.items()):
        if len(idxs) < _MIN_DEVICE_BATCH:
            for i in idxs:
                host_hash(i)
            continue
        datas: list[bytes] = []
        rows: list[int] = []
        for i in idxs:
            try:
                with open(paths[i], "rb") as f:
                    data = f.read(max_chunks * 1024 + 1)
            except OSError:
                results[i] = ""
                continue
            if len(data) > max_chunks * 1024:  # grew since the size scan
                host_hash(i)
                continue
            datas.append(data)
            rows.append(i)
        for off in range(0, len(rows), cas.DEVICE_BATCH):
            part = rows[off:off + cas.DEVICE_BATCH]
            batch, lens = cas.pack_canonical_batch(datas[off:off + cas.DEVICE_BATCH], max_chunks)
            words = blake3_torch.hash_batch(batch, lens, max_chunks, device)
            for i, h in zip(part, blake3_torch.words_to_hex(words[:len(part)], 64)):
                results[i] = h
        file_checksums.device_files[max_chunks] += len(rows)

    return [r if r is not None else "" for r in results]


#: files hashed by each leg since the last reset (chip_smoke.py reads
#: them around a validator run; reset them to start a count)
file_checksums.device_files = collections.Counter()
file_checksums.host_files = 0
