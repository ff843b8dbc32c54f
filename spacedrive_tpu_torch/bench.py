"""Device leg of the headline benchmark: `hash_batch` at the cas bucket.

    python -m spacedrive_tpu_torch.bench [--files 4096] [--repeats 5] [--device cuda]

The port-side counterpart of the repo's `bench.py` device-compute leg:
`--files` seeded random messages of the large cas bucket
(`cas.LARGE_MSG_LEN` bytes, `cas.LARGE_CHUNKS` chunks each) are placed
on the device once, then hashed by `blake3_torch.hash_batch` (K1 and
the tree reduction) `--repeats` times, each waited for. The first
batch's first eight digests are held against `blake3_ref` first. Prints one
JSON line: device, files, bytes per batch, the median and spread of a
batch's milliseconds, files/s, K1 launches. Timed with CUDA events on
the card, the host clock on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .ops import blake3_cuda, blake3_torch, cas
from .ops.blake3_ref import blake3_hex


def hash_leg(files: int = 4096, repeats: int = 5, device: str = "cuda", seed: int = 0) -> dict:
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 256, size=(files, cas.LARGE_CHUNKS * 1024), dtype=np.uint8)
    msgs[:, cas.LARGE_MSG_LEN:] = 0  # zero pad beyond the message
    lens = np.full((files,), cas.LARGE_MSG_LEN, np.int32)
    words = torch.from_numpy(np.ascontiguousarray(msgs).view(np.int32)).to(device)
    lengths = torch.from_numpy(lens).to(device)

    got = blake3_torch.words_to_hex(
        blake3_torch.hash_batch(words, lengths, cas.LARGE_CHUNKS, device=device).cpu(), 32)
    want = [blake3_hex(bytes(m[:cas.LARGE_MSG_LEN]), 16) for m in msgs[:8]]
    if got[:8] != want:
        raise AssertionError("hash_batch disagrees with blake3_ref")

    launches0 = blake3_cuda.chunk_cvs.launches
    ms = []
    for _ in range(repeats):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            blake3_torch.hash_batch(words, lengths, cas.LARGE_CHUNKS, device=device)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            blake3_torch.hash_batch(words, lengths, cas.LARGE_CHUNKS, device=device)
            ms.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(ms))
    return {
        "device": str(device), "files": files, "batch_bytes": files * cas.LARGE_MSG_LEN,
        "ms_per_batch": med, "spread_ms": [min(ms), max(ms)],
        "files_per_s": files / (med / 1e3), "k1_launches": blake3_cuda.chunk_cvs.launches - launches0,
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m spacedrive_tpu_torch.bench")
    p.add_argument("--files", type=int, default=4096)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(hash_leg(args.files, args.repeats, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
