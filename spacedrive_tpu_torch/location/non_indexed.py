"""Ephemeral (non-indexed) directory browsing.

Parity: ref:core/src/location/non_indexed.rs:1-40 — browse any path
with no DB involvement: stream the directory's entries with kind
resolution, per-file metadata, on-the-fly cas_id for regular files, and
queue *ephemeral* thumbnails (stored under `thumbnails/ephemeral/`)
for the thumbnailable ones. Sorted dirs-first like the reference's
grouped response (`NonIndexedPathItem` listing).

Counterpart of `spacedrive_tpu/location/non_indexed.py`: a listing
hashes each image's and video's cas_id on the host (`cas_id_cpu`, as
JAX does: a page of a directory is no device batch), and its ephemeral
thumbnails go to the node's thumbnailer, which resizes on the node's
device.
"""

from __future__ import annotations

import os
from typing import Any

from ..files.extensions import kind_for_path
from ..files.isolated_path import path_is_hidden
from ..files.kind import ObjectKind
from ..ops.cas import cas_id_cpu


def walk_dir(
    node: Any,
    path: str,
    *,
    with_hidden: bool = False,
    queue_thumbnails: bool = True,
) -> dict[str, Any]:
    """One directory level (the reference streams; we return one page —
    the API layer is free to paginate by slicing)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise NotADirectoryError(path)
    entries: list[dict[str, Any]] = []
    thumb_entries: list[tuple[str, str, str]] = []
    with os.scandir(path) as it:
        for entry in it:
            try:
                hidden = path_is_hidden(entry.path)
                if hidden and not with_hidden:
                    continue
                stat = entry.stat(follow_symlinks=False)
                is_dir = entry.is_dir(follow_symlinks=False)
                ext = (
                    ""
                    if is_dir
                    else os.path.splitext(entry.name)[1].lstrip(".").lower()
                )
                kind = (
                    ObjectKind.Folder
                    if is_dir
                    else kind_for_path(entry.path)
                )
                # cas_id only where it's consumed (thumbnail addressing)
                # — hashing every file would make big listings I/O-bound
                cas_id = None
                if (
                    not is_dir
                    and stat.st_size > 0
                    and kind in (ObjectKind.Image, ObjectKind.Video)
                ):
                    try:
                        cas_id = cas_id_cpu(entry.path, stat.st_size)
                    except OSError:
                        pass
                item = {
                    "path": entry.path,
                    "name": entry.name if is_dir else os.path.splitext(entry.name)[0],
                    "extension": ext,
                    "kind": int(kind),
                    "is_dir": is_dir,
                    "size_in_bytes": 0 if is_dir else stat.st_size,
                    "date_created": stat.st_ctime,
                    "date_modified": stat.st_mtime,
                    "hidden": hidden,
                    "cas_id": cas_id,
                    "has_created_thumbnail": False,
                }
                if (
                    cas_id is not None
                    and kind in (ObjectKind.Image, ObjectKind.Video)
                ):
                    if node.thumbnailer.store.exists(None, cas_id):
                        item["has_created_thumbnail"] = True
                    else:
                        thumb_entries.append((cas_id, entry.path, ext))
                entries.append(item)
            except OSError:
                continue
    if queue_thumbnails and thumb_entries:
        node.thumbnailer.new_ephemeral_thumbnails_batch(thumb_entries)
    entries.sort(key=lambda e: (not e["is_dir"], e["name"].lower()))
    return {"entries": entries, "errors": []}
