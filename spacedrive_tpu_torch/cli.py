"""Command line of the PyTorch/CUDA package.

    python -m spacedrive_tpu_torch index <path> --data-dir D [--device cuda|cpu]
    python -m spacedrive_tpu_torch index <path> --data-dir D --library NAME [--device cuda|cpu]
    python -m spacedrive_tpu_torch duplicates --data-dir D --library NAME [--threshold 8] [--device ...]
    python -m spacedrive_tpu_torch search QUERY --data-dir D --library NAME [--semantic] [--take 10]
        [--device ...]

Without `--library`: walks <path>, computes every file's cas_id, writes
thumbnails under `D/thumbnails/` and embeds the images, then prints one
JSON line: files, objects (distinct cas_ids), bytes, thumbnails,
backend, seconds.

With `--library NAME`: the library path (counterpart of
`spacedrive_tpu/cli.py cmd_index`). It starts a Node on the device,
opens or creates the library NAME under `D/libraries/`, adds <path> as
a location if it is not one yet, and runs `scan_location` (IndexerJob →
FileIdentifierJob → MediaProcessorJob) on the node's job system: the
identifier hashes through the BLAKE3 chunk kernel on "cuda", the media
job sends the images to the node's thumbnailer and writes media_data
rows, embeddings and the search index. It prints one JSON line:
library, location_id, files, objects, bytes, thumbnails, backend,
seconds (objects and bytes as node/statistics.py counts them). A second
run over an unchanged tree hashes, thumbnails, extracts and embeds
nothing.

`duplicates` (counterpart of `sdx duplicates`) runs DuplicateDetectorJob
on the library (pHashes of the image objects that lack one, on the
device) and prints the near and exact duplicate groups as JSON.
`search` (counterpart of `sdx search`) prints a name search over the
library's files, or with `--semantic` the cosine top-k of the vector
index: QUERY is an image path to embed or a stored label name; a query
that resolves to neither exits 1.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time


def cmd_index(args: argparse.Namespace) -> int:
    if args.library is not None:
        summary = asyncio.run(index_library(args.path, args.data_dir, args.library, args.device))
        print(json.dumps(summary))
        return 0
    from .index_pass import index_pass

    result = index_pass(args.path, args.data_dir, device=args.device)
    print(json.dumps(result.summary))
    return 0


async def _open(node, library: str):
    """Start `node` and return the library called `library` (created if
    absent)."""
    await node.start()
    lib = next((lib for lib in node.libraries.libraries.values() if lib.name == library), None)
    return lib if lib is not None else node.libraries.create(library)


async def index_library(path: str, data_dir: str, library: str, backend: str = "cuda",
                        node=None) -> dict:
    """Scan `path` into the library called `library` (created if absent)
    on a Node on `backend`, wait for the scan's jobs and thumbnails, and
    return the summary line (the JAX package's `sdx index` keys, without
    labels). A caller that reads the node's stage seconds afterwards
    passes its own `node`, built on `data_dir` and `backend`; it is
    started and shut down here all the same. Raises if a job of the
    scan failed."""
    from .db.database import now_iso
    from .jobs import JobStatus
    from .location.locations import LocationCreateArgs, scan_location
    from .node.node import Node
    from .node.statistics import update_statistics

    if node is None:
        node = Node(data_dir, device=backend)
    try:
        lib = await _open(node, library)
        t0 = time.perf_counter()
        started = now_iso()
        loc = lib.db.find_one("location", path=os.path.abspath(path))
        if loc is None:
            loc = LocationCreateArgs(path=path).create(lib)
        await scan_location(lib, loc, node.jobs, backend=node.device.type)
        await node.jobs.wait_idle()
        failed = lib.db.query(
            "SELECT name, errors_text FROM job WHERE status = ? AND date_created >= ?",
            (int(JobStatus.FAILED), started),
        )
        if failed:
            raise RuntimeError(f"scan failed: {failed}")
        await node.thumbnailer.wait_library_batch(lib.id)
        elapsed = time.perf_counter() - t0
        stats = update_statistics(lib.db, node.thumbnailer.data_dir)
        return {
            "library": lib.name,
            "location_id": loc["id"],
            "files": lib.db.count("file_path", "is_dir = 0"),
            "objects": stats["total_object_count"],
            "bytes": int(stats["total_bytes_used"]),
            "thumbnails": node.thumbnailer.generated,
            "backend": node.device.type,
            "seconds": round(elapsed, 2),
        }
    finally:
        await node.shutdown()


async def duplicates_library(data_dir: str, library: str, threshold: int = 8,
                             backend: str = "cuda", node=None) -> list[dict]:
    """Hash the library's image objects that lack a pHash
    (DuplicateDetectorJob on a Node on `backend`) and return
    `find_duplicates`' groups. A caller that reads the node afterwards
    passes its own `node`; it is started and shut down here all the
    same. Raises if the job failed."""
    from .jobs import JobBuilder, JobStatus
    from .node.node import Node
    from .object.duplicates import DuplicateDetectorJob, find_duplicates

    if node is None:
        node = Node(data_dir, device=backend)
    try:
        lib = await _open(node, library)
        job = DuplicateDetectorJob({"threshold": threshold})
        await JobBuilder(job).spawn(node.jobs, lib)
        await node.jobs.wait_idle()
        row = lib.db.query_one("SELECT status, errors_text FROM job WHERE id = ?", (job.id.bytes,))
        if row is None or row["status"] != int(JobStatus.COMPLETED):
            raise RuntimeError(f"duplicate detection failed: {row}")
        return await asyncio.to_thread(find_duplicates, lib, threshold, node.device)
    finally:
        await node.shutdown()


async def search_library(query: str, data_dir: str, library: str, semantic: bool = False,
                         take: int = 10, backend: str = "cuda", node=None) -> dict:
    """`search.paths` by name, or with `semantic` `search.semantic` on a
    Node on `backend`; returns the result (`resolved` False when a
    semantic query names no image path and no stored label)."""
    from .api.search import search_paths, search_semantic
    from .node.node import Node

    if node is None:
        node = Node(data_dir, device=backend)
    try:
        lib = await _open(node, library)
        if semantic:
            return await asyncio.to_thread(search_semantic, lib, {"query": query, "take": take})
        return await asyncio.to_thread(search_paths, lib,
                                       {"filter": {"search": query}, "take": take})
    finally:
        await node.shutdown()


def cmd_duplicates(args: argparse.Namespace) -> int:
    groups = asyncio.run(duplicates_library(args.data_dir, args.library, args.threshold,
                                            args.device))
    print(json.dumps(groups, indent=2))
    return 0


def cmd_search(args: argparse.Namespace) -> int:
    out = asyncio.run(search_library(args.query, args.data_dir, args.library, args.semantic,
                                     args.take, args.device))
    if args.semantic and not out.get("resolved"):
        print("query resolved to no probe vector (not an image path or a stored label name)",
              file=sys.stderr)
        return 1
    print(json.dumps(out, indent=2, default=str))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m spacedrive_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("index", help="index a directory: cas_ids, thumbnails, embeddings")
    p.add_argument("path")
    p.add_argument("--data-dir", required=True,
                   help="where thumbnails/ (and, with --library, libraries/) is written")
    p.add_argument("--library", default=None,
                   help="index into this library (created if absent) through the job chain")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.set_defaults(func=cmd_index)

    du = sub.add_parser("duplicates", help="find duplicate images in a library")
    du.add_argument("--data-dir", required=True)
    du.add_argument("--library", default="default")
    du.add_argument("--threshold", type=int, default=8)
    du.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    du.set_defaults(func=cmd_duplicates)

    se = sub.add_parser("search", help="search an indexed library")
    se.add_argument("query", help="name substring; with --semantic, an image path or a "
                    "stored label name")
    se.add_argument("--data-dir", required=True)
    se.add_argument("--library", default="default")
    se.add_argument("--semantic", action="store_true",
                    help="vector-index cosine top-k instead of a name match")
    se.add_argument("--take", type=int, default=10)
    se.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    se.set_defaults(func=cmd_search)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
