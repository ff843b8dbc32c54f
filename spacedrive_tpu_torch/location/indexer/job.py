"""IndexerJob — walk a location and persist file_path rows in batches.

Parity: ref:core/src/location/indexer/{indexer_job.rs,mod.rs} —
BATCH_SIZE = 1000 paths per step (:47), save/update steps emitting CRDT
ops (`execute_indexer_save_step`), delete of vanished rows, run
metadata with scan/db timings (:76-88), shallow variant (shallow.rs).

The indexer is pure host-side metadata work; its output (orphan
file_paths) is what feeds the device cas_id batches downstream.

Counterpart of `spacedrive_tpu/location/indexer/job.py`. The walk runs
under a `walk` span that carries the journal's verdicts, as in JAX; the
run metadata also keeps them (`journal_hit`, `journal_miss`, ...).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any

from ...db.database import blob_u64, now_iso, u64_blob
from ...files.isolated_path import IsolatedFilePathData
from ...jobs import StatefulJob
from ...jobs.job import JobContext, JobError, StepResult
from ...jobs.manager import register_job
from ...ops.cas import message_len
from ...telemetry import span
from .journal import IndexJournal, Identity, key_of
from .rules import load_rules_for_location
from .walker import walk, walk_single_dir

logger = logging.getLogger(__name__)

BATCH_SIZE = 1000  # ref:indexer_job.rs:47


class _JournalCheck:
    """Per-walk index-journal consult, counting verdicts for the walk
    span (the counters themselves increment inside IndexJournal)."""

    def __init__(self, journal: IndexJournal, loc_id: int):
        self.journal = journal
        self.loc_id = loc_id
        self.counts: dict[str, int] = {}

    def __call__(self, iso, meta) -> str:
        verdict, _entry = self.journal.lookup(
            self.loc_id, key_of(iso), Identity.from_metadata(meta)
        )
        self.counts[verdict] = self.counts.get(verdict, 0) + 1
        if verdict == "hit" and meta.size_in_bytes:
            # a vouched unchanged file: its whole sampled message will
            # never be read, hashed or shipped this pass
            self.journal.bytes_saved(message_len(meta.size_in_bytes))
        return verdict


def _entry_to_step_dict(entry, update: bool = False) -> dict[str, Any]:
    iso = entry.iso_file_path
    meta = entry.metadata
    d = {
        "pub_id": entry.pub_id,
        "materialized_path": iso.materialized_path,
        "name": iso.name,
        "extension": iso.extension,
        "is_dir": iso.is_dir,
        "inode": meta.inode if meta else 0,
        "size": meta.size_in_bytes if meta else 0,
        "created_at": meta.created_at.isoformat(timespec="milliseconds") if meta else None,
        "modified_at": meta.modified_at.isoformat(timespec="milliseconds") if meta else None,
        "hidden": bool(meta.hidden) if meta else False,
        "object_id": entry.object_id,
    }
    if update and not iso.is_dir:
        # a changed row whose identity the journal does NOT vouch for
        # must lose its cas_id/object link so the identifier re-hashes
        # the new content (a journal `hit` here means only metadata —
        # e.g. the hidden flag — changed, so the cas is still current).
        # Without a journal verdict (bypassed/disabled) err on re-hash:
        # a stale cas_id is worse than a redundant one.
        d["clear_cas"] = entry.journal_verdict != "hit"
    return d


@register_job
class IndexerJob(StatefulJob):
    """init: {location_id, sub_path?, shallow?}"""

    NAME = "indexer"
    INVALIDATES = ("search.paths", "locations.list", "library.statistics")

    async def init_job(self, ctx: JobContext) -> None:
        t0 = time.perf_counter()
        library = ctx.library
        location = library.db.find_one("location", id=self.init["location_id"])
        if location is None or not location.get("path"):
            raise JobError(f"location {self.init['location_id']} not found")
        loc_path = location["path"]
        loc_id = location["id"]

        root = loc_path
        if self.init.get("sub_path"):
            root = os.path.join(loc_path, self.init["sub_path"].lstrip("/"))

        self.data["location_id"] = loc_id
        self.data["location_pub_id"] = location["pub_id"].hex()
        self.run_metadata.update(
            total_paths=0, updated_paths=0, removed_paths=0,
            scan_read_time=0.0, db_write_time=0.0, indexing_errors=0,
        )
        if self.init.get("shallow"):
            rules, iso_factory, fetcher, remover, jcheck = self._walk_env(ctx)
            result = walk_single_dir(
                root, rules, iso_factory, fetcher, remover,
                journal_check=jcheck,
            )
            self.steps.extend(self._steps_from_result(result))
        else:
            self.steps.extend(self._run_walk(ctx, root, None))
        self.run_metadata["scan_read_time"] = round(time.perf_counter() - t0, 4)
        ctx.progress(
            message=f"indexed {self.run_metadata['total_paths']} paths",
            phase="indexing",
        )

    def _walk_env(self, ctx: JobContext):
        library = ctx.library
        loc_id = self.data["location_id"]
        location = library.db.find_one("location", id=loc_id)
        loc_path = location["path"]
        rules = load_rules_for_location(library.db, loc_id)

        def iso_factory(p: str, is_dir: bool) -> IsolatedFilePathData:
            return IsolatedFilePathData.new(loc_id, loc_path, p, is_dir)

        def file_paths_fetcher(isos):
            rows = []
            for iso in isos:
                row = library.db.find_one(
                    "file_path",
                    location_id=loc_id,
                    materialized_path=iso.materialized_path,
                    name=iso.name,
                    extension=iso.extension,
                )
                if row is not None:
                    rows.append(row)
            return rows

        def to_remove_fetcher(parent_iso, found_isos):
            found = {(i.materialized_path, i.name, i.extension) for i in found_isos}
            children_mat = parent_iso.materialized_path_for_children() or "/"
            rows = library.db.query(
                "SELECT pub_id, cas_id, object_id, materialized_path, name, extension "
                "FROM file_path WHERE location_id = ? AND materialized_path = ?",
                (loc_id, children_mat),
            )
            return [
                r for r in rows
                if (r["materialized_path"], r["name"], r["extension"]) not in found
            ]

        return (
            rules, iso_factory, file_paths_fetcher, to_remove_fetcher,
            _JournalCheck(IndexJournal(library.db), loc_id),
        )

    def _run_walk(self, ctx: JobContext, root: str, accepted: bool | None) -> list[dict]:
        """One bounded walk; leftover dirs become 'walk' continuation
        steps so arbitrarily large locations index completely."""
        rules, iso_factory, fetcher, remover, jcheck = self._walk_env(ctx)
        with span("walk") as walk_span:
            result = walk(
                root, rules, iso_factory, fetcher, remover,
                update_notifier=lambda p, n: None,
                initial_accepted_by_children=accepted,
                journal_check=jcheck,
            )
            if jcheck.counts:
                walk_span.annotate(**{f"journal_{k}": v for k, v in jcheck.counts.items()})
        # journal verdicts over EVERY walked file (unchanged files
        # included) — the warm-pass hit-rate evidence
        for verdict, n in jcheck.counts.items():
            key = f"journal_{verdict}"
            self.run_metadata[key] = self.run_metadata.get(key, 0) + n
        steps = self._steps_from_result(result)
        for leftover in result.to_walk:
            steps.append(
                {
                    "kind": "walk",
                    "path": leftover.path,
                    "accepted": leftover.parent_dir_accepted_by_its_children,
                }
            )
        return steps

    def _steps_from_result(self, result) -> list[dict]:
        steps: list[dict] = []
        for i in range(0, len(result.walked), BATCH_SIZE):
            steps.append(
                {"kind": "save", "entries": [
                    _entry_to_step_dict(e) for e in result.walked[i:i + BATCH_SIZE]
                ]}
            )
        for i in range(0, len(result.to_update), BATCH_SIZE):
            steps.append(
                {"kind": "update", "entries": [
                    _entry_to_step_dict(e, update=True)
                    for e in result.to_update[i:i + BATCH_SIZE]
                ]}
            )
        removals = [r["pub_id"] for r in result.to_remove]
        for i in range(0, len(removals), BATCH_SIZE):
            steps.append({"kind": "remove", "pub_ids": removals[i:i + BATCH_SIZE]})
        md = self.run_metadata
        md["total_paths"] = md.get("total_paths", 0) + len(result.walked)
        md["updated_paths"] = md.get("updated_paths", 0) + len(result.to_update)
        md["removed_paths"] = md.get("removed_paths", 0) + len(removals)
        md["indexing_errors"] = md.get("indexing_errors", 0) + len(result.errors)
        return steps

    async def execute_step(self, ctx: JobContext, step: dict, step_number: int) -> StepResult:
        t0 = time.perf_counter()
        library = ctx.library
        loc_id = self.data["location_id"]
        kind = step["kind"]

        if kind == "walk":
            t_scan = time.perf_counter()
            more = self._run_walk(ctx, step["path"], step.get("accepted"))
            self.run_metadata["scan_read_time"] = round(
                self.run_metadata.get("scan_read_time", 0.0)
                + time.perf_counter() - t_scan, 4
            )
            return StepResult(more_steps=more)
        if kind == "save":
            self._save_batch(library, loc_id, step["entries"], update=False)
        elif kind == "update":
            self._save_batch(library, loc_id, step["entries"], update=True)
        elif kind == "remove":
            ops = []
            for pub_id in step["pub_ids"]:
                ops.extend([library.sync.shared_delete("file_path", pub_id.hex())])

            def deletes(conn):
                for pub_id in step["pub_ids"]:
                    conn.execute("DELETE FROM file_path WHERE pub_id = ?", (pub_id,))

            library.sync.write_ops(ops, deletes)
        self.run_metadata["db_write_time"] = round(
            self.run_metadata.get("db_write_time", 0.0) + time.perf_counter() - t0, 4
        )
        return StepResult()

    def _save_batch(self, library, loc_id: int, entries: list[dict], update: bool) -> None:
        sync = library.sync
        loc_pub = self.data["location_pub_id"]
        ops = []
        for e in entries:
            rid = e["pub_id"].hex()
            if update:
                # only the fields the local UPDATE below mutates sync —
                # identity fields (path/name/location) can't have changed
                fields = [
                    ("hidden", e["hidden"]),
                    ("size_in_bytes_bytes", e["size"]),
                    ("inode", e["inode"]),
                    ("date_modified", e["modified_at"]),
                ]
                if e.get("clear_cas"):
                    # content changed and the journal doesn't vouch for
                    # the old cas: void it (and the object link) so the
                    # identifier's orphan query re-hashes this row
                    fields.extend([("cas_id", None), ("object_id", None)])
                ops.extend(
                    sync.shared_update("file_path", rid, f, v)
                    for f, v in fields
                )
            else:
                ops.extend(
                    sync.shared_create(
                        "file_path", rid,
                        [
                            # FK columns sync as the target's sync id
                            # (sync/apply.py)
                            ("location_id", loc_pub),
                            ("is_dir", e["is_dir"]),
                            ("materialized_path", e["materialized_path"]),
                            ("name", e["name"]),
                            ("extension", e["extension"]),
                            ("hidden", e["hidden"]),
                            ("size_in_bytes_bytes", e["size"]),
                            ("inode", e["inode"]),
                            ("date_created", e["created_at"]),
                            ("date_modified", e["modified_at"]),
                        ],
                    )
                )

        date_indexed = now_iso()

        def writes(conn):
            for e in entries:
                if update:
                    clear = ", cas_id=NULL, object_id=NULL" if e.get("clear_cas") else ""
                    conn.execute(
                        f"UPDATE file_path SET inode=?, size_in_bytes_bytes=?, "
                        f"date_modified=?, hidden=?, date_indexed=?{clear} "
                        f"WHERE pub_id=?",
                        (
                            u64_blob(e["inode"]), u64_blob(e["size"]),
                            e["modified_at"], int(e["hidden"]), date_indexed,
                            e["pub_id"],
                        ),
                    )
                else:
                    conn.execute(
                        "INSERT INTO file_path (pub_id, is_dir, location_id, "
                        "materialized_path, name, extension, hidden, "
                        "size_in_bytes_bytes, inode, date_created, date_modified, "
                        "date_indexed) VALUES (?,?,?,?,?,?,?,?,?,?,?,?) "
                        "ON CONFLICT (location_id, materialized_path, name, extension) "
                        "DO UPDATE SET inode=excluded.inode, "
                        "size_in_bytes_bytes=excluded.size_in_bytes_bytes, "
                        "date_modified=excluded.date_modified, hidden=excluded.hidden",
                        (
                            e["pub_id"], int(e["is_dir"]), loc_id,
                            e["materialized_path"], e["name"], e["extension"],
                            int(e["hidden"]), u64_blob(e["size"]), u64_blob(e["inode"]),
                            e["created_at"], e["modified_at"], date_indexed,
                        ),
                    )

        sync.write_ops(ops, writes)

    async def finalize(self, ctx: JobContext) -> Any:
        from ..locations import update_location_size

        library = ctx.library
        loc_id = self.data.get("location_id")
        if loc_id is not None:
            self._rollup_directory_sizes(library, loc_id)
            update_location_size(library, loc_id)
        ctx.progress(message="indexing complete", phase="done")
        return dict(self.run_metadata)

    @staticmethod
    def _rollup_directory_sizes(library, loc_id: int) -> None:
        """Directory rows get the sum of their subtree's file sizes
        (ref:location/mod.rs reverse_update_directories_sizes).
        One pass over files accumulating into every ancestor prefix —
        O(files × depth) — then a single executemany."""
        totals: dict[str, int] = {}
        for f in library.db.query(
            "SELECT materialized_path, size_in_bytes_bytes FROM file_path "
            "WHERE location_id = ? AND is_dir = 0",
            (loc_id,),
        ):
            size = blob_u64(f["size_in_bytes_bytes"]) or 0
            mat = f["materialized_path"]  # "/a/b/"
            parts = mat.strip("/").split("/") if mat != "/" else []
            prefix = "/"
            for part in parts:
                prefix = f"{prefix}{part}/"
                totals[prefix] = totals.get(prefix, 0) + size
        dirs = library.db.query(
            "SELECT id, materialized_path, name FROM file_path "
            "WHERE location_id = ? AND is_dir = 1",
            (loc_id,),
        )
        library.db.executemany(
            "UPDATE file_path SET size_in_bytes_bytes = ? WHERE id = ?",
            [
                (
                    u64_blob(totals.get(f"{d['materialized_path']}{d['name']}/", 0)),
                    d["id"],
                )
                for d in dirs
            ],
        )
