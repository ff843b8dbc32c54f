"""Location CRUD + scan orchestration.

Parity: ref:core/src/location/mod.rs — LocationCreateArgs::create
(:1-200 region), `scan_location` spawning the job chain (:443-475),
and `.spacedrive` metadata markers (location/metadata.rs).

Counterpart of `spacedrive_tpu/location/locations.py`. The chain is
Indexer → FileIdentifier → MediaProcessor, as there, with the
identifier and the media job on an explicit backend ("cuda" or "cpu");
`deep_rescan_sub_path` and `light_scan_location` spawn it over one
subtree. Relinking a moved location waits for the location manager.
"""

from __future__ import annotations

import json
import logging
import os
import uuid
from dataclasses import dataclass
from typing import Any

from ..db.database import blob_u64, new_pub_id, now_iso, u64_blob
from ..jobs import JobBuilder, JobManager
from ..node.library import Library

logger = logging.getLogger(__name__)

SPACEDRIVE_LOCATION_METADATA_FILE = ".spacedrive"


@dataclass
class LocationCreateArgs:
    path: str
    name: str | None = None
    dry_run: bool = False
    indexer_rules_ids: list[int] | None = None

    def create(self, library: Library) -> dict[str, Any] | None:
        path = os.path.abspath(self.path)
        if not os.path.isdir(path):
            raise NotADirectoryError(path)
        existing = library.db.find_one("location", path=path)
        if existing is not None:
            raise FileExistsError(f"location already exists for {path}")
        if self.dry_run:
            return None

        pub_id = new_pub_id()
        name = self.name or os.path.basename(path.rstrip(os.sep)) or path
        date_created = now_iso()
        loc_id = library.db.insert(
            "location",
            pub_id=pub_id,
            name=name,
            path=path,
            date_created=date_created,
            instance_id=library.config.instance_id,
        )
        # default rules attach (ref:location/mod.rs create flow)
        rule_ids = self.indexer_rules_ids
        if rule_ids is None:
            rule_ids = [r["id"] for r in library.db.query(
                'SELECT id FROM indexer_rule WHERE "default" = 1')]
        for rid in rule_ids:
            library.db.insert(
                "indexer_rule_in_location", location_id=loc_id, indexer_rule_id=rid
            )
        # sync ops for the shared location row
        library.sync.write_ops(
            library.sync.shared_create(
                "location",
                pub_id.hex(),
                [("name", name), ("path", path), ("date_created", date_created)],
            )
        )
        # marker file (ref:location/metadata.rs)
        try:
            metadata_path = os.path.join(path, SPACEDRIVE_LOCATION_METADATA_FILE)
            with open(metadata_path, "w", encoding="utf-8") as f:
                json.dump({"location_pub_id": pub_id.hex(), "library_id": str(library.id)}, f)
        except OSError:
            logger.warning("could not write .spacedrive marker in %s", path)
        return library.db.find_one("location", id=loc_id)


async def _spawn_scan_chain(
    library: Library,
    location: dict[str, Any],
    job_manager: JobManager,
    *,
    sub_path: str | None = None,
    shallow: bool = False,
    backend: str = "cuda",
    notify: bool = True,
) -> uuid.UUID:
    """The one Indexer → FileIdentifier → MediaProcessor chain every
    scan variant spawns (ref:location/mod.rs:443-475 JobBuilder chain);
    the identifier and the media job run on `backend`. `notify=False`
    (the watcher-driven rescans) suppresses the chain's outcome
    notification: those fire per filesystem flush."""
    from ..object.file_identifier.job import FileIdentifierJob
    from ..object.media.job import MediaProcessorJob
    from .indexer.job import IndexerJob

    init: dict[str, Any] = {"location_id": location["id"]}
    if sub_path is not None:
        init["sub_path"] = sub_path
    indexer_init = {**init, "shallow": True} if shallow else dict(init)
    jobs = [
        IndexerJob(indexer_init),
        FileIdentifierJob({**init, "backend": backend}),
        MediaProcessorJob({**init, "backend": backend}),
    ]
    for j in jobs:
        j.notify_outcome = notify
    builder = JobBuilder(jobs[0]).queue_next(jobs[1]).queue_next(jobs[2])
    return await builder.spawn(job_manager, library)


async def scan_location(
    library: Library,
    location: dict[str, Any],
    job_manager: JobManager,
    *,
    backend: str = "cuda",
) -> uuid.UUID:
    """Full scan job chain (ref:location/mod.rs:443-475) on `backend`
    ("cuda" or "cpu")."""
    return await _spawn_scan_chain(library, location, job_manager, backend=backend)


async def deep_rescan_sub_path(
    library: Library,
    location: dict[str, Any],
    sub_path: str,
    job_manager: JobManager,
    *,
    backend: str = "cuda",
) -> uuid.UUID:
    """Full (recursive) rescan of one subtree — what a directory moved
    into the location needs (a shallow scan of its parent would index
    only the dir row, not its pre-existing contents)."""
    return await _spawn_scan_chain(
        library, location, job_manager, sub_path=sub_path, backend=backend,
        notify=False,  # watcher-driven; see _spawn_scan_chain
    )


async def light_scan_location(
    library: Library,
    location: dict[str, Any],
    sub_path: str,
    job_manager: JobManager,
    *,
    backend: str = "cuda",
) -> uuid.UUID:
    """Shallow re-scan of one directory (ref:location/mod.rs:517)."""
    return await _spawn_scan_chain(
        library, location, job_manager, sub_path=sub_path, shallow=True, backend=backend,
        notify=False,  # watcher-driven; see _spawn_scan_chain
    )


def update_location_size(library: Library, location_id: int) -> int:
    """Roll directory sizes up into the location row
    (ref:location/mod.rs reverse_update_directories_sizes)."""
    total = sum(
        blob_u64(r["size_in_bytes_bytes"]) or 0
        for r in library.db.query(
            "SELECT size_in_bytes_bytes FROM file_path "
            "WHERE location_id = ? AND is_dir = 0",
            (location_id,),
        )
    )
    library.db.update(
        "location", {"id": location_id},
        size_in_bytes=u64_blob(total),
    )
    return total
