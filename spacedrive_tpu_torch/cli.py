"""Command line of the PyTorch/CUDA package.

    python -m spacedrive_tpu_torch index <path> --data-dir D [--device cuda|cpu]

walks <path>, computes every file's cas_id, writes thumbnails under
`D/thumbnails/` and embeds the images, then prints one JSON line:
files, objects (distinct cas_ids), bytes, thumbnails, backend, seconds.
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_index(args: argparse.Namespace) -> int:
    from .index_pass import index_pass

    result = index_pass(args.path, args.data_dir, device=args.device)
    print(json.dumps(result.summary))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m spacedrive_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("index", help="index a directory: cas_ids, thumbnails, embeddings")
    p.add_argument("path")
    p.add_argument("--data-dir", required=True, help="where thumbnails/ is written")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.set_defaults(func=cmd_index)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
