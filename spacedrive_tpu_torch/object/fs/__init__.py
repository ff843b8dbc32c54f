"""File-operation jobs — copy / cut / delete / erase.

Parity: ref:core/src/object/fs/mod.rs — `FileData` (row + resolved full
path, mod.rs:44-47), `get_many_files_datas` (mod.rs:49-83),
`construct_target_filename` extension handling (mod.rs:132-152),
`" (N)"` duplicate-suffix renaming (DUPLICATE_PATTERN mod.rs:32-34,
`append_digit_to_filename`/`find_available_filename_for_duplicate`
mod.rs:154-200), `fetch_source_and_target_location_paths`
(mod.rs:107-130).

Counterpart of `spacedrive_tpu/object/fs/__init__.py`. `watcher_pause`
reaches the node's location manager through `ctx.library.node` and
pauses only the paths the job writes; `watcher_announce` then hands the
manager what a job wrote under its pause that the library should see
(the crypto jobs' finished files), as the watcher's own events.
"""

from __future__ import annotations

import contextlib
import os
import re
from dataclasses import dataclass

from ...files.isolated_path import full_path_from_db_row
from ...location.watcher.events import EventKind, WatchEvent

DUPLICATE_PATTERN = re.compile(r" \(\d+\)")


class FileSystemJobsError(Exception):
    pass


@dataclass
class FileData:
    """A file_path DB row plus its absolute on-disk path."""

    row: dict
    full_path: str


def _location_manager(ctx):
    node = getattr(ctx.library, "node", None)
    return getattr(node, "location_manager", None) if node is not None else None


@contextlib.contextmanager
def watcher_pause(ctx, location_id: int, paths: list[str] | None = None):
    """Suppress the location watcher under `paths` (the whole location
    when none are given) while a job scribbles there
    (ref:location/manager/mod.rs stop_watcher/reinit_watcher — the
    reference's fs jobs ignore their own write events the same way)."""
    mgr = _location_manager(ctx)
    if mgr is not None:
        mgr.pause(ctx.library, location_id, paths)
    try:
        yield
    finally:
        if mgr is not None:
            mgr.resume(ctx.library, location_id, paths)


async def watcher_announce(ctx, location_id: int, created: list[str] = (),
                           removed: list[str] = ()) -> None:
    """After a pause: apply the files a job finished writing (`created`)
    and removed (`removed`) as the location watcher's events, so they
    reach the library as a user's would."""
    mgr = _location_manager(ctx)
    if mgr is not None:
        await mgr.announce(ctx.library, location_id, [
            *(WatchEvent(EventKind.CREATE, p) for p in created),
            *(WatchEvent(EventKind.REMOVE, p) for p in removed),
        ])


def get_location_path(db, location_id: int) -> str:
    loc = db.find_one("location", id=location_id)
    if loc is None or not loc.get("path"):
        raise FileSystemJobsError(f"location {location_id} not found")
    return loc["path"]


def get_many_files_datas(db, location_path: str, file_path_ids: list[int]) -> list[FileData]:
    out = []
    for fp_id in file_path_ids:
        row = db.find_one("file_path", id=fp_id)
        if row is None:
            raise FileSystemJobsError(f"file_path {fp_id} not found")
        out.append(FileData(row, full_path_from_db_row(location_path, row)))
    return out


def fetch_source_and_target_location_paths(
    db, source_location_id: int, target_location_id: int
) -> tuple[str, str]:
    return get_location_path(db, source_location_id), get_location_path(db, target_location_id)


def construct_target_filename(file_data: FileData) -> str:
    """Directory or extension-less file → bare name; file → name.ext
    (ref:mod.rs:132-152)."""
    row = file_data.row
    if row.get("is_dir") or not row.get("extension"):
        return row["name"]
    return f"{row['name']}.{row['extension']}"


def append_digit_to_filename(file_name: str, ext: str | None, current_int: int) -> str:
    """'photo (2)' handling: strips an existing ' (N)' suffix before
    appending the new counter (ref:mod.rs:154-172)."""
    matches = list(DUPLICATE_PATTERN.finditer(file_name))
    base = file_name[: matches[-1].start()] if matches else file_name
    if ext:
        return f"{base} ({current_int}).{ext}"
    return f"{base} ({current_int})"


def find_available_filename_for_duplicate(target_path: str) -> str:
    """First 'name (N).ext' that does not exist yet
    (ref:mod.rs:174-200)."""
    directory = os.path.dirname(target_path)
    filename = os.path.basename(target_path)
    stem, dot, ext = filename.rpartition(".")
    if not dot or not stem:
        stem, ext = filename, ""
    for i in range(1, 2**32):
        candidate = os.path.join(directory, append_digit_to_filename(stem, ext or None, i))
        if not os.path.exists(candidate):
            return candidate
    raise FileSystemJobsError(f"no available filename for duplicate of {target_path}")
