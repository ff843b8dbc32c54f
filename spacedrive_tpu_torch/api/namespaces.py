"""api::mount() — the procedure namespaces.

Parity: ref:core/src/api/mod.rs:197-218 — the namespace list mirrors
the reference router merge order: buildInfo/nodeState root procedures,
then library, locations (incl. indexer rules), files, ephemeralFiles,
jobs, search (+ saved searches), tags, spaces, albums, labels, nodes,
volumes, preferences, notifications, backups, auth, models,
invalidation. Handlers are (node[, library][, arg]) per router.py;
mutations fire `invalidate_query` exactly where the reference does.

Counterpart of `spacedrive_tpu/api/namespaces.py`, registering its
procedures in its order but for those in `DEFERRED`, each of which
waits for the plane (a ROADMAP entry) that ports what it drives. The
procedures that scan, validate or search run their jobs and ops on the
node's device. `locations.create` and `locations.delete` start and
stop the location's watcher (the node's location manager), as the JAX
procedures do.
"""

from __future__ import annotations

import asyncio
import os
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, AsyncIterator

from ..db.database import blob_u64, new_pub_id, now_iso
from ..node.config import BackendFeature
from ..node.notifications import Notifications
from ..node.preferences import read_preferences, write_preferences
from ..node.statistics import get_statistics, update_statistics
from ..node.volumes import get_volumes, save_volumes
from .cache import normalise, normalise_one
from .invalidate import install_registry, invalidate_query
from .router import CoreEventKind, Router, RspcError
from .search import search_objects, search_paths, search_semantic

VERSION = "0.1.0"

#: the JAX router's procedures this one does not register yet, each with
#: the ROADMAP plane that brings what it drives
DEFERRED: dict[str, str] = {
    **{f"cloud.{k}": "6.8" for k in (
        "getApiOrigin", "setApiOrigin", "library.get", "sync.enable", "sync.state")},
}


def mount() -> Router:
    """Build the full router (ref:api/mod.rs:124 `mount`)."""
    r = Router()
    _root(r)
    _library(r)
    _locations(r)
    _files(r)
    _ephemeral(r)
    _jobs(r)
    _search(r)
    _tags(r)
    _spaces(r)
    _albums(r)
    _labels(r)
    _sync(r)
    _p2p(r)
    _nodes(r)
    _volumes(r)
    _keys(r)
    _preferences(r)
    _notifications(r)
    _backups(r)
    _auth(r)
    _models(r)
    _telemetry(r)
    _invalidation(r)
    install_registry(r)
    return r


# --- root ----------------------------------------------------------------


def _root(r: Router) -> None:
    @r.query("buildInfo")
    def build_info(node):
        return {"version": VERSION, "commit": "tpu-native"}

    @r.query("nodeState")
    def node_state(node):
        from ..node.hardware import accelerators, hardware_model

        cfg = node.config.config
        accels = accelerators()
        return {
            "id": str(cfg.id),
            "name": cfg.name,
            "identity": str(cfg.identity.to_remote_identity()),
            "data_path": node.data_dir,
            "p2p": cfg.p2p.to_dict(),
            "features": [f.value for f in cfg.features],
            "hardware_model": hardware_model(),
            "device_model": accels[0]["kind"] if accels else "cpu",
            "accelerators": accels,
            "image_labeler_version": cfg.image_labeler_version,
            "thumbnailer_background_percentage": node.thumbnailer.background_percentage,
        }

    @r.mutation("toggleFeatureFlag")
    def toggle_feature(node, arg):
        feature = BackendFeature(arg["feature"])
        node.toggle_feature(feature, bool(arg["enabled"]))
        invalidate_query(node, "nodeState")
        return node.is_feature_enabled(feature)


# --- library -------------------------------------------------------------


def _library(r: Router) -> None:
    @r.query("library.list")
    def list_libraries(node):
        return [
            {
                "uuid": str(lib.id),
                "config": lib.config.to_dict(),
                "instance_id": lib.config.instance_id,
                "instance_public_key": str(lib.instance_uuid),
            }
            for lib in node.libraries.libraries.values()
        ]

    @r.query("library.statistics", library=True)
    def statistics(node, library):
        update_statistics(library.db, node.thumbnailer.data_dir)
        return get_statistics(library.db)

    @r.query("library.kindStatistics", library=True)
    def kind_statistics(node, library):
        """Per-ObjectKind object counts + byte totals for the overview
        page (ref:core/src/api/libraries.rs:132 `kindStatistics`; the
        reference leaves total_bytes at "0" — ours is real)."""
        from ..files.kind import ObjectKind

        counts = {
            row["kind"]: row["count"]
            for row in library.db.query(
                "SELECT kind, COUNT(*) AS count FROM object "
                "WHERE kind IS NOT NULL GROUP BY kind"
            )
        }
        # sizes live only as LE u64 blobs (schema parity) — aggregate
        # host-side; one pass over file_path, same cost class as
        # update_statistics
        totals: dict[int, int] = {}
        for row in library.db.query(
            "SELECT o.kind AS kind, fp.size_in_bytes_bytes AS size "
            "FROM file_path fp JOIN object o ON o.id = fp.object_id "
            "WHERE o.kind IS NOT NULL"
        ):
            totals[row["kind"]] = (
                totals.get(row["kind"], 0) + (blob_u64(row["size"]) or 0)
            )

        def kind_name(k: int) -> str:
            try:
                return ObjectKind(k).name
            except ValueError:
                return f"Kind{k}"

        return {
            "statistics": sorted(
                (
                    {"kind": k, "name": kind_name(k), "count": c,
                     "total_bytes": str(totals.get(k, 0))}
                    for k, c in counts.items()
                ),
                key=lambda s: -s["count"],
            )
        }

    @r.mutation("library.create")
    async def create(node, arg):
        lib = await node.create_library(
            arg["name"], arg.get("description", "")
        )
        invalidate_query(node, "library.list")
        return {"uuid": str(lib.id), "config": lib.config.to_dict()}

    @r.mutation("library.edit")
    def edit(node, arg):
        lib = node.libraries.libraries.get(uuid.UUID(arg["id"]))
        if lib is None:
            raise RspcError.not_found("library")
        if "name" in arg:
            lib.config.name = arg["name"]
        if "description" in arg:
            lib.config.description = arg["description"]
        node.libraries.save_config(lib)
        invalidate_query(node, "library.list")
        return None

    @r.mutation("library.delete")
    async def delete(node, arg):
        lib_id = uuid.UUID(arg if isinstance(arg, str) else arg["id"])
        await node.close_library(lib_id)  # stop actors/jobs before rm
        node.libraries.delete(lib_id)
        invalidate_query(node, "library.list")
        return None


# --- locations -----------------------------------------------------------


# reachability probes get their own tiny pool (see _with_online): a
# hung mount must never occupy the shared default executor
_PROBE_POOL = ThreadPoolExecutor(max_workers=2,
                                 thread_name_prefix="loc-probe")


def _locations(r: Router) -> None:
    from ..location.indexer.rules import (
        IndexerRule,
        RuleKind,
        RulePerKind,
        load_rules_for_location,
    )
    from ..location.locations import (
        LocationCreateArgs,
        light_scan_location,
        relink_location,
        scan_location,
    )

    async def _with_online(library, rows):
        """`online` for LOCALLY-owned locations = the path is reachable
        (unplugged drive / unmounted share); the reference's sidebar
        dot (ref:core/src/location/mod.rs online set + interface
        Sidebar). Rows owned by other instances keep online=None —
        their connectivity rides p2p.state, and a local isdir on a
        remote path would mislabel every synced location offline.
        Probes run on a DEDICATED 2-thread pool with a short timeout: a
        hung network mount must cost this request one bounded probe,
        never the shared to_thread executor the thumbnailer/identifier
        pipelines live on (a blocked isdir per refresh would exhaust it
        node-wide). Timed-out probes report offline — a mount that
        can't answer a stat in a second isn't browsable anyway."""
        rows = [dict(row) for row in rows]
        local = library.config.instance_id
        loop = asyncio.get_running_loop()

        async def probe(path):
            if not path:
                return False
            try:
                return await asyncio.wait_for(
                    loop.run_in_executor(_PROBE_POOL, os.path.isdir, path),
                    timeout=1.0,
                )
            except asyncio.TimeoutError:
                return False

        checks = [
            probe(row.get("path"))
            for row in rows if row.get("instance_id") == local
        ]
        verdicts = iter(await asyncio.gather(*checks))
        for row in rows:
            row["online"] = (next(verdicts)
                             if row.get("instance_id") == local else None)
        return rows

    @r.query("locations.list", library=True)
    async def list_locations(node, library):
        return normalise(
            "location", await _with_online(library, library.db.find("location"))
        )

    @r.query("locations.get", library=True)
    async def get_location(node, library, arg):
        row = library.db.find_one("location", id=int(arg))
        if row is None:
            raise RspcError.not_found("location")
        [row] = await _with_online(library, [row])
        return normalise_one("location", row)

    @r.mutation("locations.create", library=True)
    async def create(node, library, arg):
        args = LocationCreateArgs(
            path=arg["path"],
            name=arg.get("name"),
            dry_run=bool(arg.get("dry_run", False)),
            indexer_rules_ids=arg.get("indexer_rules_ids", []),
        )
        try:
            loc = args.create(library)
        except (NotADirectoryError, PermissionError, FileNotFoundError) as e:
            # a bad/unreadable path is the caller's error, not a crash
            # (ref:api/locations.rs create error variants)
            raise RspcError.bad_request(f"location path: {e}")
        if loc is None:
            return None
        await scan_location(library, loc, node.jobs, backend=str(node.device))
        await node.location_manager.add(library, loc)
        invalidate_query(node, "locations.list", library)
        return loc["id"]

    @r.mutation("locations.update", library=True)
    def update(node, library, arg):
        fields = {
            k: arg[k] for k in ("name", "hidden", "sync_preview_media") if k in arg
        }
        if fields:
            library.db.update("location", {"id": int(arg["id"])}, **fields)
        if "indexer_rules_ids" in arg:
            library.db.delete("indexer_rule_in_location", location_id=int(arg["id"]))
            for rid in arg["indexer_rules_ids"]:
                library.db.insert(
                    "indexer_rule_in_location",
                    location_id=int(arg["id"]),
                    indexer_rule_id=int(rid),
                )
        invalidate_query(node, "locations.list", library)
        return None

    @r.mutation("locations.delete", library=True)
    async def delete(node, library, arg):
        loc_id = int(arg)
        await node.location_manager.remove(library, loc_id)
        with library.db.transaction() as conn:
            conn.execute(
                "DELETE FROM indexer_rule_in_location WHERE location_id = ?",
                (loc_id,),
            )
            conn.execute("DELETE FROM file_path WHERE location_id = ?", (loc_id,))
            conn.execute("DELETE FROM location WHERE id = ?", (loc_id,))
        invalidate_query(node, "locations.list", library)
        return None

    @r.mutation("locations.fullRescan", library=True)
    async def full_rescan(node, library, arg):
        loc = library.db.find_one("location", id=int(arg["location_id"]))
        if loc is None:
            raise RspcError.not_found("location")
        await scan_location(library, loc, node.jobs, backend=str(node.device))
        return None

    @r.mutation("locations.subPathRescan", library=True)
    async def sub_path_rescan(node, library, arg):
        loc = library.db.find_one("location", id=int(arg["location_id"]))
        if loc is None:
            raise RspcError.not_found("location")
        await light_scan_location(library, loc, arg.get("sub_path", "/"), node.jobs,
                                  backend=str(node.device))
        return None

    @r.mutation("locations.relink", library=True)
    def relink(node, library, arg):
        return relink_location(library, arg["path"])

    # indexer rules sub-namespace (ref:api/locations.rs indexer_rules)
    @r.query("locations.indexerRules.list", library=True)
    def rules_list(node, library):
        rows = library.db.find("indexer_rule")
        return [
            {
                "id": row["id"],
                "name": row["name"],
                "default": bool(row["default"]),
                "date_created": row["date_created"],
            }
            for row in rows
        ]

    @r.query("locations.indexerRules.listForLocation", library=True)
    def rules_for_location(node, library, arg):
        return [rule.name for rule in load_rules_for_location(library.db, int(arg))]

    @r.mutation("locations.indexerRules.create", library=True)
    def rules_create(node, library, arg):
        kind = RuleKind[arg["kind"]] if isinstance(arg["kind"], str) else RuleKind(arg["kind"])
        rule = IndexerRule(
            pub_id=new_pub_id(),
            name=arg["name"],
            default=False,
            rules=[RulePerKind(kind=kind, params=list(arg["parameters"]))],
        )
        rid = library.db.insert(
            "indexer_rule",
            pub_id=rule.pub_id,
            name=rule.name,
            rules_per_kind=rule.serialize_rules(),
            date_created=now_iso(),
            date_modified=now_iso(),
            **{"default": 0},
        )
        invalidate_query(node, "locations.indexerRules.list", library)
        return rid

    @r.mutation("locations.indexerRules.delete", library=True)
    def rules_delete(node, library, arg):
        row = library.db.find_one("indexer_rule", id=int(arg))
        if row and row["default"]:
            raise RspcError.bad_request("cannot delete a system rule")
        library.db.delete("indexer_rule_in_location", indexer_rule_id=int(arg))
        library.db.delete("indexer_rule", id=int(arg))
        invalidate_query(node, "locations.indexerRules.list", library)
        return None


# --- files ---------------------------------------------------------------


def _files(r: Router) -> None:
    from ..jobs.manager import JobBuilder
    from ..object.fs.copy import FileCopierJob
    from ..object.fs.cut import FileCutterJob
    from ..object.fs.delete import FileDeleterJob
    from ..object.fs.erase import FileEraserJob
    from ..object.validation.job import ObjectValidatorJob

    @r.query("files.get", library=True)
    def get_file(node, library, arg):
        row = library.db.find_one("file_path", id=int(arg["id"]))
        if row is None:
            raise RspcError.not_found("file_path")
        row["size_in_bytes"] = blob_u64(row.pop("size_in_bytes_bytes", None)) or 0
        obj = (
            library.db.find_one("object", id=row["object_id"])
            if row["object_id"]
            else None
        )
        out = normalise_one("file_path", row)
        out["object"] = obj and {k: v.hex() if isinstance(v, bytes) else v for k, v in obj.items()}
        return out

    @r.mutation("files.setNote", library=True)
    def set_note(node, library, arg):
        _object_update(node, library, int(arg["id"]), note=arg.get("note"))
        return None

    @r.query("files.getMediaData", library=True)
    def get_media_data(node, library, arg):
        """Decoded media_data row for an object id — EXIF capture facts
        for images, stream facts for videos (ref:core/src/api/files.rs:126
        `getMediaData`; blobs are msgpack, decoded here for the
        inspector)."""
        from ..utils.msgpack_codec import unpackb

        row = library.db.find_one("media_data", object_id=int(arg))
        if row is None:
            return None

        def mp(blob):
            if blob is None:
                return None
            try:
                return unpackb(blob)
            except Exception:
                return None

        return {
            "resolution": mp(row["resolution"]),
            "media_date": mp(row["media_date"]),
            "media_location": mp(row["media_location"]),
            "camera_data": mp(row["camera_data"]),
            "artist": row["artist"],
            "description": row["description"],
            "copyright": row["copyright"],
            "exif_version": row["exif_version"],
            "epoch_time": row["epoch_time"],
        }

    @r.mutation("files.setFavorite", library=True)
    def set_favorite(node, library, arg):
        _object_update(node, library, int(arg["id"]), favorite=int(bool(arg["favorite"])))

    @r.mutation("files.updateAccessTime", library=True)
    def update_access_time(node, library, arg):
        """Stamp object.date_accessed = now for the given file_path ids
        (ref:core/src/api/files.rs:298 `updateAccessTime`; the explorer
        calls it on open/preview and the recents route orders by it).
        One timestamp, one transaction, one invalidation for the whole
        batch; ids without an identified object are skipped — access
        stamping is best-effort, like the reference's find_many."""
        from datetime import datetime, timezone

        now = datetime.now(timezone.utc).isoformat()
        object_ids: list[int] = []
        for fp_id in arg["ids"]:
            row = library.db.find_one("file_path", id=int(fp_id))
            if row and row["object_id"]:
                object_ids.append(row["object_id"])
        if not object_ids:
            return None
        ops = []
        for oid in object_ids:
            if pub := _object_pub(library, oid):
                ops.append(library.sync.shared_update(
                    "object", pub, "date_accessed", now))

        def writes(conn):
            conn.execute(
                "UPDATE object SET date_accessed = ? "
                f"WHERE id IN ({','.join('?' * len(object_ids))})",
                (now, *object_ids),
            )

        library.sync.write_ops(ops, db_writes=writes)
        # search.paths too: the recents/favorites routes render object
        # fields joined onto file_path rows, and the explorer's live
        # refresh only listens for path-level invalidations
        invalidate_query(node, "search.objects", library)
        invalidate_query(node, "search.paths", library)
        return None

    @r.mutation("files.renameFile", library=True)
    def rename(node, library, arg):
        from ..files.isolated_path import full_path_from_db_row, separate_name_and_extension

        row = library.db.find_one("file_path", id=int(arg["id"]))
        if row is None:
            raise RspcError.not_found("file_path")
        loc = library.db.find_one("location", id=row["location_id"])
        old_path = full_path_from_db_row(loc["path"], row)
        new_name = arg["new_name"]
        new_path = os.path.join(os.path.dirname(old_path), new_name)
        if os.path.exists(new_path):
            raise RspcError.bad_request("target name already exists")
        os.rename(old_path, new_path)
        name, ext = separate_name_and_extension(new_name)
        rid = row["pub_id"].hex()
        ops = [
            library.sync.shared_update("file_path", rid, "name", name),
            library.sync.shared_update("file_path", rid, "extension", ext),
        ]
        library.sync.write_ops(
            ops,
            lambda conn: conn.execute(
                "UPDATE file_path SET name = ?, extension = ?, date_modified = ? "
                "WHERE id = ?",
                (name, ext, now_iso(), row["id"]),
            ),
        )
        invalidate_query(node, "search.paths", library)
        return None

    @r.mutation("files.deleteFiles", library=True)
    async def delete_files(node, library, arg):
        await JobBuilder(
            FileDeleterJob(
                {
                    "location_id": int(arg["location_id"]),
                    "file_path_ids": [int(i) for i in arg["file_path_ids"]],
                }
            )
        ).spawn(node.jobs, library)
        return None

    @r.mutation("files.eraseFiles", library=True)
    async def erase_files(node, library, arg):
        await JobBuilder(
            FileEraserJob(
                {
                    "location_id": int(arg["location_id"]),
                    "file_path_ids": [int(i) for i in arg["file_path_ids"]],
                    "passes": int(arg.get("passes", 1)),
                }
            )
        ).spawn(node.jobs, library)
        return None

    @r.mutation("files.copyFiles", library=True)
    async def copy_files(node, library, arg):
        await JobBuilder(FileCopierJob(dict(arg))).spawn(node.jobs, library)
        return None

    @r.mutation("files.cutFiles", library=True)
    async def cut_files(node, library, arg):
        await JobBuilder(FileCutterJob(dict(arg))).spawn(node.jobs, library)
        return None

    @r.mutation("files.validate", library=True)
    async def validate(node, library, arg):
        await JobBuilder(ObjectValidatorJob(dict(arg))).spawn(node.jobs, library)
        return None


def _object_update(node: Any, library: Any, file_path_id: int, **fields: Any) -> None:
    row = library.db.find_one("file_path", id=file_path_id)
    if row is None or not row["object_id"]:
        raise RspcError.not_found("object for file_path")
    pub = _object_pub(library, row["object_id"])
    cols = ", ".join(f"{k} = ?" for k in fields)

    def writes(conn):
        conn.execute(
            f"UPDATE object SET {cols} WHERE id = ?",
            (*fields.values(), row["object_id"]),
        )

    library.sync.write_ops(
        [library.sync.shared_update("object", pub, k, v)
         for k, v in fields.items()] if pub else [],
        db_writes=writes,
    )
    invalidate_query(node, "search.objects", library)
    # favorite/note render on file_path rows (favorites route, grid
    # badges) and the explorer live-refreshes on path invalidations
    invalidate_query(node, "search.paths", library)


# --- ephemeralFiles ------------------------------------------------------


def _ephemeral(r: Router) -> None:
    @r.query("ephemeralFiles.list")
    async def list_dir(node, arg):
        """Non-indexed browse (ref:core/src/location/non_indexed.rs);
        hashing/stat work runs off the event loop."""
        from ..location.non_indexed import walk_dir

        return await asyncio.to_thread(
            walk_dir, node, arg["path"], with_hidden=bool(arg.get("with_hidden", False))
        )

    # mutations on non-indexed paths (ref:core/src/api/ephemeral_files.rs)
    @r.mutation("ephemeralFiles.createFolder")
    def create_folder(node, arg):
        name = arg["name"]
        if os.sep in name or "/" in name:
            raise RspcError.bad_request("folder name must not contain separators")
        path = os.path.join(os.path.abspath(arg["path"]), name)
        try:
            os.mkdir(path)  # exactly one level, races surface as EEXIST
        except OSError as e:
            raise RspcError.bad_request(f"create {path}: {e}")
        return path

    @r.mutation("ephemeralFiles.renameFile")
    def rename_file(node, arg):
        src = os.path.abspath(arg["path"])
        dst = os.path.join(os.path.dirname(src), arg["new_name"])
        # lexists: a dangling symlink is still an entry to rename/protect
        if not os.path.lexists(src):
            raise RspcError.not_found("path")
        if os.path.lexists(dst):
            raise RspcError.bad_request("target name already exists")
        try:
            os.rename(src, dst)
        except OSError as e:
            raise RspcError.bad_request(f"rename: {e}")
        return dst

    @r.mutation("ephemeralFiles.deleteFiles")
    def delete_files(node, arg):
        import shutil

        deleted = 0
        errors: list[str] = []
        for p in arg["paths"]:
            p = os.path.abspath(p)
            try:
                if os.path.islink(p) or os.path.isfile(p):
                    os.remove(p)
                elif os.path.isdir(p):
                    shutil.rmtree(p)
                else:
                    continue
                deleted += 1
            except OSError as e:
                errors.append(f"delete {p}: {e}")  # keep going (job parity)
        return {"deleted": deleted, "errors": errors}


# --- jobs ----------------------------------------------------------------


def _jobs(r: Router) -> None:
    from ..jobs.report import JobReport, JobStatus

    @r.query("jobs.reports", library=True)
    def reports(node, library):
        rows = library.db.query(
            "SELECT * FROM job ORDER BY date_created DESC LIMIT 100"
        )
        out = []
        for row in rows:
            rep = JobReport.from_row(row)
            out.append(
                {
                    "id": str(rep.id),
                    "name": rep.name,
                    "action": rep.action,
                    "status": rep.status.name,
                    "task_count": rep.task_count,
                    "completed_task_count": rep.completed_task_count,
                    "errors": rep.errors_text,
                    "created_at": rep.created_at,
                    "completed_at": rep.completed_at,
                    "parent_id": str(rep.parent_id) if rep.parent_id else None,
                }
            )
        return out

    @r.query("jobs.isActive", library=True)
    def is_active(node, library):
        return bool(node.jobs._active)

    @r.mutation("jobs.pause")
    async def pause(node, arg):
        await node.jobs.pause(uuid.UUID(arg))
        return None

    @r.mutation("jobs.resume")
    async def resume(node, arg):
        await node.jobs.resume(uuid.UUID(arg))
        return None

    @r.mutation("jobs.cancel")
    async def cancel(node, arg):
        await node.jobs.cancel(uuid.UUID(arg))
        return None

    @r.mutation("jobs.clear", library=True)
    def clear(node, library, arg):
        library.db.delete("job", id=uuid.UUID(arg).bytes)
        invalidate_query(node, "jobs.reports", library)
        return None

    @r.mutation("jobs.clearAll", library=True)
    def clear_all(node, library):
        library.db.execute(
            "DELETE FROM job WHERE status NOT IN (?, ?)",
            (int(JobStatus.RUNNING), int(JobStatus.PAUSED)),
        )
        invalidate_query(node, "jobs.reports", library)
        return None

    @r.subscription("jobs.progress", library=True)
    async def progress(node, library) -> AsyncIterator[Any]:
        async for event in _bus_events(node):
            if (
                isinstance(event, tuple)
                and event[0] == CoreEventKind.JOB_PROGRESS
            ):
                ev = event[1]
                # the node bus carries every library's jobs; scope to
                # the subscribed library (LibraryArgs semantics)
                ev_lib = getattr(ev, "library_id", None)
                if ev_lib is None or str(ev_lib) == str(library.id):
                    yield ev


# --- search --------------------------------------------------------------


def _search(r: Router) -> None:
    @r.query("search.paths", library=True)
    def paths(node, library, arg):
        return search_paths(library, arg)

    @r.query("search.objects", library=True)
    def objects(node, library, arg):
        return search_objects(library, arg)

    @r.query("search.semantic", library=True)
    async def semantic(node, library, arg):
        """Vector-index top-k (probe embed + device matmul) — runs off
        the event loop like search.duplicates; the serve layer caches
        the byte result until an embedding write invalidates the
        library tag."""
        return await asyncio.to_thread(search_semantic, library, arg)

    @r.query("search.duplicates", library=True)
    async def duplicates(node, library, arg):
        """Near + exact duplicate groups (device pHash; BASELINE cfg 5).
        Runs off the event loop — the matmuls + grouping take seconds on
        big libraries."""
        from ..object.duplicates import find_duplicates

        return await asyncio.to_thread(
            find_duplicates, library, int((arg or {}).get("threshold", 8)), node.device
        )

    @r.mutation("search.detectDuplicates", library=True)
    async def detect_duplicates(node, library, arg):
        from ..jobs.manager import JobBuilder
        from ..object.duplicates import DuplicateDetectorJob

        job_id = await JobBuilder(
            DuplicateDetectorJob(dict(arg or {}))
        ).spawn(node.jobs, library)
        return str(job_id)

    @r.query("search.saved.list", library=True)
    def saved_list(node, library):
        return normalise("saved_search", library.db.find("saved_search"))

    @r.mutation("search.saved.create", library=True)
    def saved_create(node, library, arg):
        sid = library.db.insert(
            "saved_search",
            pub_id=new_pub_id(),
            name=arg.get("name"),
            search=arg.get("search"),
            filters=arg.get("filters"),
            icon=arg.get("icon"),
            description=arg.get("description"),
            date_created=now_iso(),
            date_modified=now_iso(),
        )
        invalidate_query(node, "search.saved.list", library)
        return sid

    @r.mutation("search.saved.delete", library=True)
    def saved_delete(node, library, arg):
        library.db.delete("saved_search", id=int(arg))
        invalidate_query(node, "search.saved.list", library)
        return None


# --- tags ----------------------------------------------------------------


def _tag_pub(library, tag_id: int) -> str | None:
    row = library.db.find_one("tag", id=int(tag_id))
    return row["pub_id"].hex() if row else None


def _object_pub(library, object_id: int) -> str | None:
    row = library.db.find_one("object", id=int(object_id))
    return row["pub_id"].hex() if row else None


def _tags(r: Router) -> None:
    @r.query("tags.list", library=True)
    def list_tags(node, library):
        return normalise("tag", library.db.find("tag"))

    @r.query("tags.getForObject", library=True)
    def for_object(node, library, arg):
        rows = library.db.query(
            "SELECT t.* FROM tag t JOIN tag_on_object tobj ON tobj.tag_id = t.id "
            "WHERE tobj.object_id = ?",
            (int(arg),),
        )
        return normalise("tag", rows)

    @r.mutation("tags.create", library=True)
    def create(node, library, arg):
        # every shared-model write rides sync.write_ops so the domain
        # row and its CRDT ops land in ONE transaction and paired
        # devices converge (ref:manager.rs:70-93; sync.mdx)
        pub = new_pub_id()
        now = now_iso()
        values = [("name", arg["name"]), ("color", arg.get("color")),
                  ("date_created", now), ("date_modified", now)]
        box = {}

        def writes(conn):
            box["id"] = conn.execute(
                "INSERT INTO tag (pub_id, name, color, date_created, "
                "date_modified) VALUES (?, ?, ?, ?, ?)",
                (pub, arg["name"], arg.get("color"), now, now),
            ).lastrowid

        library.sync.write_ops(
            library.sync.shared_create(
                "tag", pub.hex(), [(k, v) for k, v in values if v is not None]
            ),
            db_writes=writes,
        )
        invalidate_query(node, "tags.list", library)
        return box["id"]

    @r.mutation("tags.update", library=True)
    def update(node, library, arg):
        fields = {k: arg[k] for k in ("name", "color") if k in arg}
        pub = _tag_pub(library, arg["id"])
        if not fields:
            return None
        cols = ", ".join(f"{k} = ?" for k in fields)

        def writes(conn):
            conn.execute(
                f"UPDATE tag SET {cols} WHERE id = ?",
                (*fields.values(), int(arg["id"])),
            )

        library.sync.write_ops(
            [library.sync.shared_update("tag", pub, k, v)
             for k, v in fields.items()] if pub else [],
            db_writes=writes,
        )
        invalidate_query(node, "tags.list", library)
        return None

    @r.mutation("tags.delete", library=True)
    def delete(node, library, arg):
        tag_id = int(arg)
        pub = _tag_pub(library, tag_id)
        # link removals must sync too, or peers keep dangling
        # tag_on_object rows that resurrect the tag as a ghost via
        # FK placeholder creation on later relation ops
        links = library.db.query(
            "SELECT o.pub_id AS opub FROM tag_on_object t "
            "JOIN object o ON o.id = t.object_id WHERE t.tag_id = ?",
            (tag_id,),
        )
        ops = []
        if pub:
            ops = [
                library.sync.relation_delete(
                    "tag_on_object", {"item": l["opub"].hex(), "group": pub}
                )
                for l in links
            ] + [library.sync.shared_delete("tag", pub)]

        def writes(conn):
            conn.execute("DELETE FROM tag_on_object WHERE tag_id = ?", (tag_id,))
            conn.execute("DELETE FROM tag WHERE id = ?", (tag_id,))

        library.sync.write_ops(ops, db_writes=writes)
        invalidate_query(node, "tags.list", library)
        return None

    @r.mutation("tags.assign", library=True)
    def assign(node, library, arg):
        tag_id = int(arg["tag_id"])
        tag_pub = _tag_pub(library, tag_id)
        oids = [int(o) for o in arg["object_ids"]]
        qmarks = ",".join("?" * len(oids)) or "NULL"
        pub_by_id = {
            row["id"]: row["pub_id"].hex()
            for row in library.db.query(
                f"SELECT id, pub_id FROM object WHERE id IN ({qmarks})", oids
            )
        }
        unassign = bool(arg.get("unassign"))
        now = now_iso()
        ops = []
        for oid in oids:
            obj_pub = pub_by_id.get(oid)
            if tag_pub and obj_pub:
                rid = {"item": obj_pub, "group": tag_pub}
                if unassign:
                    ops.append(library.sync.relation_delete("tag_on_object", rid))
                else:
                    ops.extend(library.sync.relation_create("tag_on_object", rid))

        def writes(conn):
            for oid in oids:
                if unassign:
                    conn.execute(
                        "DELETE FROM tag_on_object WHERE tag_id = ? AND object_id = ?",
                        (tag_id, oid),
                    )
                else:
                    conn.execute(
                        "INSERT INTO tag_on_object (tag_id, object_id, date_created) "
                        "VALUES (?, ?, ?) ON CONFLICT (tag_id, object_id) DO NOTHING",
                        (tag_id, oid, now),
                    )

        library.sync.write_ops(ops, db_writes=writes)
        invalidate_query(node, "tags.getForObject", library)
        return None


# --- spaces / albums (ref:schema.prisma space/album models) --------------


def _collection_ns(r: Router, ns: str, table: str, link_table: str, link_col: str) -> None:
    """spaces and albums share the same CRUD shape."""

    @r.query(f"{ns}.list", library=True)
    def list_all(node, library):
        return normalise(table, library.db.find(table))

    @r.query(f"{ns}.getObjects", library=True)
    def get_objects(node, library, arg):
        rows = library.db.query(
            f"SELECT o.* FROM object o JOIN {link_table} l ON l.object_id = o.id "
            f"WHERE l.{link_col} = ?",
            (int(arg),),
        )
        return normalise("object", rows)

    @r.mutation(f"{ns}.create", library=True)
    def create(node, library, arg):
        cols = dict(
            pub_id=new_pub_id(),
            name=arg["name"],
            date_created=now_iso(),
            date_modified=now_iso(),
        )
        if table == "space":
            cols["description"] = arg.get("description")
        rid = library.db.insert(table, **cols)
        invalidate_query(node, f"{ns}.list", library)
        return rid

    @r.mutation(f"{ns}.delete", library=True)
    def delete(node, library, arg):
        library.db.delete(link_table, **{link_col: int(arg)})
        library.db.delete(table, id=int(arg))
        invalidate_query(node, f"{ns}.list", library)
        return None

    @r.mutation(f"{ns}.addObjects", library=True)
    def add_objects(node, library, arg):
        for oid in arg["object_ids"]:
            if arg.get("remove"):
                library.db.delete(
                    link_table, **{link_col: int(arg["id"]), "object_id": int(oid)}
                )
            else:
                extra = (
                    {"date_created": now_iso()}
                    if link_table == "object_in_album"  # space link has no column
                    else {}
                )
                library.db.upsert(
                    link_table,
                    {link_col: int(arg["id"]), "object_id": int(oid)},
                    **extra,
                )
        invalidate_query(node, f"{ns}.getObjects", library)
        return None


def _spaces(r: Router) -> None:
    _collection_ns(r, "spaces", "space", "object_in_space", "space_id")


def _albums(r: Router) -> None:
    _collection_ns(r, "albums", "album", "object_in_album", "album_id")


# --- labels --------------------------------------------------------------


def _labels(r: Router) -> None:
    @r.query("labels.list", library=True)
    def list_labels(node, library):
        return normalise("label", library.db.find("label"))

    @r.query("labels.getForObject", library=True)
    def for_object(node, library, arg):
        rows = library.db.query(
            "SELECT l.* FROM label l JOIN label_on_object lo ON lo.label_id = l.id "
            "WHERE lo.object_id = ?",
            (int(arg),),
        )
        return normalise("label", rows)

    @r.query("labels.getWithObjects", library=True)
    def with_objects(node, library, arg):
        if not arg:
            return {}
        rows = library.db.query(
            "SELECT l.id AS label_id, lo.object_id FROM label l "
            "JOIN label_on_object lo ON lo.label_id = l.id "
            f"WHERE l.id IN ({','.join('?' * len(arg))})",
            [int(i) for i in arg],
        )
        out: dict[int, list[int]] = {}
        for row in rows:
            out.setdefault(row["label_id"], []).append(row["object_id"])
        return out

    @r.mutation("labels.delete", library=True)
    def delete(node, library, arg):
        library.db.delete("label_on_object", label_id=int(arg))
        library.db.delete("label", id=int(arg))
        invalidate_query(node, "labels.list", library)
        return None


# --- p2p -----------------------------------------------------------------


def _p2p(r: Router) -> None:
    @r.query("p2p.state")
    def state(node):
        if node.p2p is None:
            return {"enabled": False, "peers": []}
        relay_client = node.p2p.relay_client
        return {
            "enabled": True,
            "port": node.p2p.port,
            "identity": str(node.p2p.p2p.remote_identity),
            # path-selection telemetry: punched-direct vs relayed dials
            "punch": (dict(relay_client.punch_stats)
                      if relay_client is not None else None),
            "peers": [
                {
                    "identity": str(p.identity),
                    "metadata": p.metadata,
                    "addrs": sorted(f"{h}:{pt}" for h, pt in p.addrs),
                    "connected": p.is_connected,
                }
                for p in node.p2p.p2p.peers.values()
            ],
        }

    @r.mutation("p2p.spacedrop")
    async def spacedrop(node, arg):
        from ..p2p.identity import RemoteIdentity

        if node.p2p is None:
            raise RspcError.bad_request("p2p disabled")
        drop_id = await node.p2p.spacedrop.send(
            RemoteIdentity.from_str(arg["identity"]), list(arg["file_paths"])
        )
        return str(drop_id)

    def _require_p2p(node):
        if node.p2p is None:
            raise RspcError.bad_request("p2p disabled")
        return node.p2p

    @r.mutation("p2p.acceptSpacedrop")
    def accept(node, arg):
        ok = _require_p2p(node).spacedrop.accept(
            uuid.UUID(arg["id"]), arg.get("target_dir")
        )
        if not ok:
            raise RspcError.not_found("spacedrop request")
        return None

    @r.mutation("p2p.cancelSpacedrop")
    def cancel(node, arg):
        _require_p2p(node).spacedrop.cancel(uuid.UUID(arg))
        return None

    @r.mutation("p2p.rejectSpacedrop")
    def reject(node, arg):
        _require_p2p(node).spacedrop.reject(uuid.UUID(arg))
        return None

    @r.mutation("p2p.pairLibrary")
    async def pair_library(node, arg):
        """Join a peer's library (joiner side of the pairing flow)."""
        from ..p2p.identity import RemoteIdentity

        mgr = _require_p2p(node)
        lib = await mgr.pairing.join(
            mgr.p2p,
            RemoteIdentity.from_str(arg["identity"]),
            uuid.UUID(arg["library_id"]) if arg.get("library_id") else None,
        )
        invalidate_query(node, "library.list")
        return str(lib.id)

    @r.mutation("p2p.acceptPairing")
    def accept_pairing(node, arg):
        if not _require_p2p(node).pairing.accept(uuid.UUID(arg)):
            raise RspcError.not_found("pairing request")
        return None

    @r.mutation("p2p.rejectPairing")
    def reject_pairing(node, arg):
        _require_p2p(node).pairing.reject(uuid.UUID(arg))
        return None

    @r.subscription("p2p.events")
    async def events(node) -> AsyncIterator[Any]:
        """Peer lifecycle (P2P-internal bus) merged with spacedrop
        offers/progress (node event bus — SpacedropManager emits
        there, p2p/manager.py:37); ref:spacedrop.rs:203."""
        if node.p2p is None:
            return
        queue: asyncio.Queue = asyncio.Queue()
        _SENTINEL = object()

        async def pump(gen):
            try:
                async for ev in gen:
                    await queue.put(ev)
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # close the subscription, don't
                await queue.put((_SENTINEL, exc))  # half-starve it
            else:
                await queue.put((_SENTINEL, None))

        pumps = [
            asyncio.create_task(pump(_bus_events_for(node.p2p.p2p.events))),
            asyncio.create_task(pump(_bus_events(node))),
        ]
        try:
            while True:
                event = await queue.get()
                if isinstance(event, tuple) and event and event[0] is _SENTINEL:
                    if event[1] is not None:
                        raise event[1]
                    return  # a source ended cleanly (p2p torn down)
                kind = event[0] if isinstance(event, tuple) and event else None
                if kind in ("PeerDiscovered", "PeerExpired",
                            "PeerConnected", "PeerDisconnected"):
                    yield {"kind": kind, "identity": str(event[1])}
                elif kind == "SpacedropRequest":
                    req = event[1]  # inbound offer → accept/reject dialog
                    yield {
                        "kind": kind,
                        "id": str(req.id),
                        "peer": str(req.peer),
                        "files": list(req.files),
                        "total_size": req.total_size,
                    }
                elif kind == "SpacedropProgress":
                    yield {
                        "kind": kind, "id": str(event[1]),
                        "percent": event[2],
                    }
        finally:
            for t in pumps:
                t.cancel()


# --- nodes / volumes / preferences / notifications -----------------------


# --- sync ----------------------------------------------------------------


def _sync(r: Router) -> None:
    from ..sync.ingest import backfill_operations

    @r.query("sync.enabled", library=True)
    def enabled(node, library):
        return library.sync.emit_messages

    @r.query("sync.messages", library=True)
    def messages(node, library, arg):
        count = int((arg or {}).get("count", 100))
        return [op.to_wire() for op in library.sync.get_ops(count=count)]

    @r.mutation("sync.backfill", library=True)
    def backfill(node, library):
        return backfill_operations(library.sync)

    @r.subscription("sync.newMessage", library=True)
    async def new_message(node, library) -> AsyncIterator[Any]:
        async for event in _bus_events_for(library.event_bus):
            if event == ("SyncMessage", "Created") or event == (
                "SyncMessage",
                "Ingested",
            ):
                yield event[1]


def _nodes(r: Router) -> None:
    @r.mutation("nodes.edit")
    def edit(node, arg):
        if arg.get("name"):
            node.config.update(name=arg["name"])
        if "p2p_enabled" in arg:
            node.config.config.p2p.enabled = bool(arg["p2p_enabled"])
            node.config.save()
        invalidate_query(node, "nodeState")
        return None

    @r.mutation("nodes.updateThumbnailerPreferences")
    def thumbnailer_prefs(node, arg):
        node.thumbnailer.set_background_percentage(
            int(arg.get("background_processing_percentage", 50))
        )
        return None


def _volumes(r: Router) -> None:
    @r.query("volumes.list")
    def list_volumes(node):
        return [v.to_dict() for v in get_volumes()]

    @r.mutation("volumes.track", library=True)
    def track(node, library):
        return save_volumes(library.db)


def _key_manager(library):
    """Per-library crypto vault (ref:core/src/api/keys.rs — the
    KeyManager the reference's KeyManager/ UI drives). The keystore
    file lives next to the library database."""
    km = library.key_manager
    if km is None:
        from ..crypto.keys import KeyManager

        path = library.db.path
        store = (path[: -len(".db")] if path.endswith(".db") else path) \
            + ".keystore"
        km = KeyManager(store)
        library.key_manager = km
    return km


def _keys(r: Router) -> None:
    """`keys.*` as JAX's, but for `keys.add`: a key added with
    `automount` to an unlocked vault is mounted at once, as the vault
    mounts such keys whenever it unlocks (JAX's mounts it only at the
    next `keys.unlock`, so tests/test_api.py::
    test_keys_unlock_wrong_password_retry_keeps_vault_intact fails there)."""
    from ..crypto.keys import CryptoError

    def guard(fn, *a):
        try:
            return fn(*a)
        except CryptoError as e:
            raise RspcError.bad_request(str(e))

    @r.query("keys.state", library=True)
    def state(node, library):
        km = _key_manager(library)
        mounted = set(km.mounted_uuids())
        return {
            "unlocked": km.unlocked,
            "keys": [
                {"uuid": sk.uuid, "automount": sk.automount,
                 "algorithm": int(sk.algorithm),
                 "mounted": sk.uuid in mounted}
                for sk in km.stored.values()
            ],
        }

    @r.mutation("keys.unlock", library=True)
    def unlock(node, library, arg):
        km = _key_manager(library)
        # snapshot BEFORE clobbering: a wrong-password retry against an
        # already-unlocked vault must restore the working master, not
        # lock the manager and yank every mounted key out from under
        # its consumers
        prev_master = bytes(km._master) if km.unlocked else None
        km.set_master_password(str(arg["password"]).encode())
        if km.stored:
            # VERIFY before committing: decrypting a stored key proves
            # the password. Accepting it unchecked would let a typo'd
            # password "unlock" the vault and encrypt NEW keys under the
            # typo — a keystore needing two different passwords. The
            # probe prefers an unmounted key and never unmounts one that
            # was already mounted (a second unlock must not yank a key
            # out from under its consumers).
            mounted_before = set(km.mounted_uuids())
            probe = next((u for u in km.stored if u not in mounted_before),
                         next(iter(km.stored)))
            try:
                km.mount(probe)
            except CryptoError:
                if prev_master is not None:
                    # mounted keys were never touched (the failed probe
                    # mounts nothing); restoring the master returns the
                    # manager to its exact pre-call state
                    km.set_master_password(prev_master)
                else:
                    km.lock()
                invalidate_query(node, "keys.state", library)
                raise RspcError.bad_request("wrong master password")
            if probe not in mounted_before \
                    and not km.stored[probe].automount:
                km.unmount(probe)
        mounted = guard(km.automount)
        invalidate_query(node, "keys.state", library)
        return {"automounted": mounted}

    @r.mutation("keys.lock", library=True)
    def lock(node, library):
        _key_manager(library).lock()
        invalidate_query(node, "keys.state", library)
        return None

    @r.mutation("keys.add", library=True)
    def add(node, library, arg):
        import secrets as _secrets

        arg = arg or {}
        km = _key_manager(library)
        if arg.get("material"):
            try:
                material = bytes.fromhex(arg["material"])
            except ValueError:
                raise RspcError.bad_request("material must be hex")
        else:
            material = _secrets.token_bytes(32)
        automount = bool(arg.get("automount"))
        key_uuid = guard(lambda: km.add_key(material, automount=automount))
        if automount:
            guard(km.mount, key_uuid)
        invalidate_query(node, "keys.state", library)
        return {"uuid": key_uuid}

    @r.mutation("keys.mount", library=True)
    def mount(node, library, arg):
        guard(_key_manager(library).mount, str(arg))
        invalidate_query(node, "keys.state", library)
        return None

    @r.mutation("keys.unmount", library=True)
    def unmount(node, library, arg):
        guard(_key_manager(library).unmount, str(arg))
        invalidate_query(node, "keys.state", library)
        return None

    @r.mutation("keys.delete", library=True)
    def delete(node, library, arg):
        guard(_key_manager(library).delete_key, str(arg))
        invalidate_query(node, "keys.state", library)
        return None


def _preferences(r: Router) -> None:
    @r.query("preferences.get", library=True)
    def get(node, library):
        return read_preferences(library.db)

    @r.mutation("preferences.update", library=True)
    def update(node, library, arg):
        write_preferences(library.db, arg or {})
        invalidate_query(node, "preferences.get", library)
        return None


def _notifications(r: Router) -> None:
    @r.query("notifications.get")
    def get(node):
        out = [
            {"id": vars(n.id), "data": n.data, "read": n.read}
            for n in node.notifications.list_node()
        ]
        for lib in node.libraries.libraries.values():
            out.extend(
                {"id": vars(n.id), "data": n.data, "read": n.read}
                for n in Notifications.list_library(lib.db, str(lib.id))
            )
        return out

    @r.mutation("notifications.dismiss", library=True)
    def dismiss(node, library, arg):
        Notifications.mark_read(library.db, int(arg))
        return None

    @r.mutation("notifications.dismissAll", library=True)
    def dismiss_all(node, library):
        library.db.execute("UPDATE notification SET read = 1")
        return None

    @r.subscription("notifications.listen")
    async def listen(node) -> AsyncIterator[Any]:
        async for event in _bus_events(node):
            if isinstance(event, tuple) and event and event[0] == "notification":
                n = event[1]
                yield {"id": vars(n.id), "data": n.data}


# --- backups -------------------------------------------------------------


def _backups(r: Router) -> None:
    import json
    import shutil
    import zipfile

    def backups_dir(node) -> str:
        d = os.path.join(node.data_dir, "backups")
        os.makedirs(d, exist_ok=True)
        return d

    @r.query("backups.getAll")
    def get_all(node):
        out = []
        for name in sorted(os.listdir(backups_dir(node))):
            if not name.endswith(".zip"):
                continue
            path = os.path.join(backups_dir(node), name)
            try:
                with zipfile.ZipFile(path) as z:
                    header = json.loads(z.read("header.json"))
            except Exception:
                continue
            header["path"] = path
            out.append(header)
        return out

    @r.mutation("backups.backup", library=True)
    def backup(node, library):
        """Zip the library DB + config with a header
        (ref:core/src/api/backups.rs `start_backup`)."""
        backup_id = str(uuid.uuid4())
        path = os.path.join(backups_dir(node), f"{backup_id}.zip")
        library.db.execute("PRAGMA wal_checkpoint(TRUNCATE)")
        config_path, db_path = node.libraries.paths(library.id)
        with zipfile.ZipFile(path, "w") as z:
            z.writestr(
                "header.json",
                json.dumps(
                    {
                        "id": backup_id,
                        "timestamp": now_iso(),
                        "library_id": str(library.id),
                        "library_name": library.name,
                    }
                ),
            )
            z.write(db_path, "library.db")
            z.write(config_path, "library.sdlibrary")
        return backup_id

    @r.mutation("backups.restore")
    async def restore(node, arg):
        """ref:backups.rs `start_restore` — close, overwrite, reload."""

        def read_header() -> dict:
            with zipfile.ZipFile(arg["path"]) as z:
                return json.loads(z.read("header.json"))

        def overwrite(db_path: str, config_path: str) -> None:
            # bulk DB copy — runs via asyncio.to_thread (sdlint SD001)
            with zipfile.ZipFile(arg["path"]) as z:
                for suffix in ("-wal", "-shm"):
                    if os.path.exists(db_path + suffix):
                        os.remove(db_path + suffix)
                with z.open("library.db") as src, open(db_path, "wb") as dst:
                    shutil.copyfileobj(src, dst)
                with z.open("library.sdlibrary") as src, \
                        open(config_path, "wb") as dst:
                    shutil.copyfileobj(src, dst)

        header = await asyncio.to_thread(read_header)
        lib_id = uuid.UUID(header["library_id"])
        await node.close_library(lib_id)  # full teardown, not just close
        config_path, db_path = node.libraries.paths(lib_id)
        await asyncio.to_thread(overwrite, db_path, config_path)
        lib = node.libraries.load(lib_id)
        await node._init_library(lib)
        invalidate_query(node, "library.list")
        return str(lib_id)

    @r.mutation("backups.delete")
    def delete(node, arg):
        path = arg["path"] if isinstance(arg, dict) else arg
        if os.path.dirname(os.path.abspath(path)) != os.path.abspath(
            backups_dir(node)
        ):
            raise RspcError.bad_request("not a backup path")
        os.remove(path)
        return None


# --- auth / models / invalidation ---------------------------------------


def _auth(r: Router) -> None:
    @r.query("auth.me")
    def me(node):
        # cloud auth is an online service; offline deployments report logged-out
        return None

    @r.mutation("auth.logout")
    def logout(node):
        return None


def _models(r: Router) -> None:
    @r.query("models.imageDetection.list")
    def list_models(node):
        # ref:crates/ai image_labeler/model listing; one built-in model
        return ["labeler-net-v1"]


def _telemetry(r: Router) -> None:
    """The diagnostics read path: the registry, the span ring, the
    flight recorder, the debug bundle and the host profile (plane 6.2a);
    the tenant sketches, the health verdicts, the node's mesh snapshot,
    the pass attribution, the SLOs and the serve posture (plane 6.2b)."""
    from .. import telemetry

    @r.query("telemetry.snapshot")
    def snapshot(node):
        return telemetry.snapshot()

    @r.query("telemetry.render")
    def render(node):
        # the Prometheus text, for copy/paste diagnostics in the UI
        return {"text": telemetry.render()}

    @r.query("telemetry.trace_export")
    def trace_export(node, arg=None):
        # Chrome-trace JSON (Perfetto-loadable); arg {trace_id?} filters
        trace_id = (arg or {}).get("trace_id") if isinstance(arg, dict) else None
        return telemetry.trace_export(trace_id)

    @r.query("telemetry.events")
    def events(node):
        # the flight recorder's rings, most-recent-last
        return telemetry.events.all_events()

    @r.query("telemetry.debug_bundle")
    def debug_bundle(node):
        # the redacted support artifact (see telemetry.bundle)
        return telemetry.debug_bundle(node)

    @r.query("telemetry.tenants")
    def tenants(node):
        # the per-tenant heavy-hitter sketches: hashed tenant labels only
        return telemetry.tenants.snapshot()

    @r.query("telemetry.health")
    def health(node):
        # per-subsystem → per-node verdicts (telemetry.health)
        return telemetry.health.evaluate(node)

    @r.query("telemetry.mesh")
    async def mesh(node, arg=None):
        # this node's snapshot and the federation's peers, freshness-
        # marked; arg {refresh?: bool, force?: bool} steers the refresh
        opts = arg if isinstance(arg, dict) else {}
        return await telemetry.federation.mesh_status_cached(
            node,
            refresh=bool(opts.get("refresh", True)),
            force=bool(opts.get("force")),
        )

    @r.query("telemetry.attrib")
    async def attrib(node, arg=None):
        # critical-path attribution of one trace (default: the last
        # settled pass); arg {trace_id?, refresh?}
        opts = arg if isinstance(arg, dict) else {}
        return await telemetry.attrib.assemble(
            node,
            opts.get("trace_id") or None,
            refresh=bool(opts.get("refresh")),
        )

    @r.query("telemetry.profile")
    async def profile(node, arg=None):
        # the host sampler: frame groups, on-CPU vs GIL-wait split,
        # capture windows; arg {mesh?: bool, format?: "folded"} (the
        # mesh view pulls every peer's profile)
        opts = arg if isinstance(arg, dict) else {}
        if opts.get("format") == "folded":
            return {"folded": telemetry.sampler.SAMPLER.folded()}
        if opts.get("mesh"):
            return await telemetry.sampler.mesh_profile(node)
        return telemetry.sampler.SAMPLER.profile()

    @r.query("telemetry.slo")
    def slo(node):
        # SLO burn-rate posture over the node's persistent history, the
        # evaluation the `slo` health subsystem embeds
        return telemetry.slo.evaluate(getattr(node, "history", None))

    @r.query("telemetry.serve")
    def serve_status(node):
        # the admission gate and read caches come with the serve plane;
        # until then this is JAX's answer without a serve runtime
        return {"enabled": False}


def _invalidation(r: Router) -> None:
    @r.subscription("invalidation.listen")
    async def listen(node) -> AsyncIterator[Any]:
        async for event in _bus_events(node):
            if (
                isinstance(event, tuple)
                and event[0] == CoreEventKind.INVALIDATE_OPERATION
            ):
                yield event[1].to_wire()


# --- helpers -------------------------------------------------------------


async def _bus_events(node: Any) -> AsyncIterator[Any]:
    async for event in _bus_events_for(node.event_bus):
        yield event


async def _bus_events_for(bus: Any) -> AsyncIterator[Any]:
    """Bridge a thread-safe EventBus into an async stream."""
    sub = bus.subscribe()
    try:
        while True:
            for event in sub.poll():
                yield event
            await asyncio.sleep(0.02)
    finally:
        sub.close()
