"""Sharded on-disk thumbnail storage with a versioned directory layout.

Counterpart of `spacedrive_tpu/object/media/thumbnail/store.py`
(ref:core/src/object/media/thumbnail/{shard.rs,directory.rs}): thumbs
live at `<data>/thumbnails/<library_id | ephemeral>/<cas_id[0..3]>/
<cas_id>.webp`, and the directory carries a version file.
"""

from __future__ import annotations

import os
import threading

THUMBNAIL_DIR_VERSION = 1
_VERSION_FILE = "version.txt"
EPHEMERAL_DIR = "ephemeral"


def get_shard_hex(cas_id: str) -> str:
    """First 3 hex chars → up to 4096 shard dirs (ref:shard.rs:10)."""
    return cas_id[:3]


class ThumbnailStore:
    """The `thumbnails/` tree under a node's data dir."""

    def __init__(self, data_dir: str | os.PathLike):
        self.root = os.path.join(os.fspath(data_dir), "thumbnails")
        os.makedirs(self.root, exist_ok=True)
        self._migrate_directory()

    def _migrate_directory(self) -> None:
        """Versioned layout migration (ref:directory.rs): v0 kept flat
        files at the root; v1 moves them into shard dirs."""
        vfile = os.path.join(self.root, _VERSION_FILE)
        try:
            with open(vfile) as f:
                version = int(f.read().strip() or 0)
        except (OSError, ValueError):
            version = 0
        if version == THUMBNAIL_DIR_VERSION:
            return
        for name in os.listdir(self.root):
            if name.endswith(".webp") and os.path.isfile(os.path.join(self.root, name)):
                cas = name[: -len(".webp")]
                dst = os.path.join(self.root, EPHEMERAL_DIR, get_shard_hex(cas))
                os.makedirs(dst, exist_ok=True)
                os.replace(os.path.join(self.root, name), os.path.join(dst, name))
        # atomic write (tmp + rename), as the version manager saves configs
        with open(vfile + ".tmp", "w") as f:
            f.write(str(THUMBNAIL_DIR_VERSION))
        os.replace(vfile + ".tmp", vfile)

    def namespace(self, library_id) -> str:
        """Namespace dir: the stringified library id, or the ephemeral
        dir (ref:actor.rs:53-62)."""
        return str(library_id) if library_id is not None else EPHEMERAL_DIR

    def path_for(self, library_id: str | None, cas_id: str) -> str:
        return os.path.join(
            self.root, self.namespace(library_id), get_shard_hex(cas_id), f"{cas_id}.webp"
        )

    def exists(self, library_id: str | None, cas_id: str) -> bool:
        return os.path.exists(self.path_for(library_id, cas_id))

    def write(self, library_id: str | None, cas_id: str, webp: bytes) -> str:
        """Publish atomically. The actor encodes and stores on several
        threads, and rows of one cas_id can share a chunk, so each
        writer has its own temporary name."""
        path = self.path_for(library_id, cas_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(webp)
        os.replace(tmp, path)
        return path
