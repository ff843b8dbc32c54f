"""Host profile of the port's library pass (`index --library`).

    python3 profile_library.py [--files 16384] [--device cuda] [--seed 0] [--top 25]

Writes a seeded tree of small files (1 B-16 KiB, log-uniform sizes, a
quarter repeating another file's bytes, 64 directories) into a
temporary directory, then runs the IndexerJob -> FileIdentifierJob ->
MediaProcessorJob chain twice (cold, then warm) under cProfile (the
tree holds no image, so the media job finds nothing to do). For each run it prints
one JSON line with the wall seconds, files/s and the jobs' stage
seconds, then the `--top` functions by their own time. cProfile adds a
cost to every Python call, so its seconds are larger than an
unprofiled run's; read the shares, not the totals. The device runs
whatever the identifier dispatches (K1 on "cuda"); this profiles the
host around it.
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import io
import json
import os
import pstats
import sys
import tempfile
import time

import numpy as np


def build_tree(root: str, n: int, rng) -> None:
    n_dup = n // 4
    sizes = np.exp(rng.uniform(0, np.log(16 * 1024), n - n_dup)).astype(int)
    datas = [rng.bytes(int(s)) for s in sizes]
    datas += [datas[int(i)] for i in rng.integers(0, len(datas), n_dup)]
    for i, data in enumerate(datas):
        d = os.path.join(root, f"s{i % 64:02d}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"m{i:05d}.dat"), "wb") as f:
            f.write(data)


def job_seconds(data_dir: str) -> dict:
    """Stage seconds of the last indexer and identifier jobs."""
    from spacedrive_tpu_torch.node.library import Libraries
    from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

    (lib,) = Libraries(data_dir).load_all()
    try:
        jobs = lib.db.query("SELECT name, metadata FROM job ORDER BY date_created DESC, "
                            "rowid DESC LIMIT 3")
    finally:
        lib.close()
    meta = {j["name"]: unpackb(j["metadata"]) for j in jobs}
    idx, ident = meta["indexer"], meta["file_identifier"]
    return {
        "indexer_walk_s": idx["scan_read_time"], "indexer_db_s": idx["db_write_time"],
        "identifier_read_s": ident["read_time"], "identifier_dispatch_s": ident["dispatch_time"],
        "identifier_hash_wait_s": ident["hash_wait_time"], "identifier_db_s": ident["db_time"],
        "device_files": ident["device_files"],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--files", type=int, default=16_384)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--top", type=int, default=25)
    args = parser.parse_args()

    import torch

    from spacedrive_tpu_torch.cli import index_library

    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_library: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="sd_profile_library_") as tmp:
        tree, data_dir = os.path.join(tmp, "tree"), os.path.join(tmp, "data")
        build_tree(tree, args.files, np.random.default_rng(args.seed))
        for run in ("cold", "warm"):
            prof = cProfile.Profile()
            t0 = time.perf_counter()
            prof.enable()
            summary = asyncio.run(index_library(tree, data_dir, "profile", args.device,
                                                no_p2p=True))
            prof.disable()
            wall = time.perf_counter() - t0
            print(json.dumps({"run": run, "device": args.device, "files": summary["files"],
                              "seconds": wall, "files_per_s": summary["files"] / wall,
                              **job_seconds(data_dir)}), flush=True)
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(args.top)
            print(out.getvalue(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
