"""IsolatedFilePathData — the canonical path decomposition stored in the
library DB (behavior parity with
ref:crates/file-path-helper/src/isolated_file_path_data.rs:33-46):

    location_id + materialized_path + name + extension + is_dir

`materialized_path` is the PARENT directory relative to the location
root, always "/"-wrapped (``/a/b/`` for ``<root>/a/b/x.txt``; ``/`` at
the root). `name` excludes the extension for files and is the full name
for directories; the location root row has empty name/extension.

Counterpart of `spacedrive_tpu/files/isolated_path.py`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from datetime import datetime, timezone


class FilePathError(ValueError):
    pass


def separate_name_and_extension(filename: str) -> tuple[str, str]:
    """('archive.tar', 'gz') for 'archive.tar.gz'; hidden files like
    '.env' have no extension."""
    stem, dot, ext = filename.rpartition(".")
    if not dot or not stem or not ext:
        return filename, ""
    return stem, ext


def path_is_hidden(path: str | os.PathLike) -> bool:
    """Unix dotfile convention (ref:crates/file-path-helper/src/lib.rs:132)."""
    name = os.path.basename(os.fspath(path).rstrip("/"))
    return name.startswith(".")


@dataclass(frozen=True)
class FilePathMetadata:
    """Filesystem facts recorded per file_path row
    (ref:crates/file-path-helper/src/lib.rs:124-130)."""

    inode: int
    size_in_bytes: int
    created_at: datetime
    modified_at: datetime
    hidden: bool
    # exact stat identity for the index journal (datetime fields above
    # lose sub-ms precision through float timestamps; the journal's
    # "unchanged" verdict must be lossless)
    mtime_ns: int = 0
    dev: int = 0

    @classmethod
    def from_path(cls, path: str | os.PathLike, stat: os.stat_result | None = None) -> "FilePathMetadata":
        st = stat if stat is not None else os.stat(path)
        return cls(
            inode=st.st_ino,
            size_in_bytes=st.st_size,
            created_at=datetime.fromtimestamp(getattr(st, "st_birthtime", st.st_ctime), timezone.utc),
            modified_at=datetime.fromtimestamp(st.st_mtime, timezone.utc),
            hidden=path_is_hidden(path),
            mtime_ns=st.st_mtime_ns,
            dev=st.st_dev,
        )


@dataclass(frozen=True)
class IsolatedFilePathData:
    location_id: int
    materialized_path: str
    is_dir: bool
    name: str
    extension: str
    relative_path: str = field(default="", compare=False)

    @classmethod
    def new(
        cls,
        location_id: int,
        location_path: str | os.PathLike,
        full_path: str | os.PathLike,
        is_dir: bool,
    ) -> "IsolatedFilePathData":
        loc = os.path.normpath(os.fspath(location_path))
        full = os.path.normpath(os.fspath(full_path))
        if full == loc:
            return cls(location_id, "/", is_dir, "", "", "")
        try:
            rel = os.path.relpath(full, loc)
        except ValueError as e:
            raise FilePathError(f"{full!r} not under location {loc!r}") from e
        if rel.startswith(".."):
            raise FilePathError(f"{full!r} not under location {loc!r}")
        rel = rel.replace(os.sep, "/")
        parent, _, filename = rel.rpartition("/")
        materialized = f"/{parent}/" if parent else "/"
        if is_dir:
            name, ext = filename, ""
        else:
            name, ext = separate_name_and_extension(filename)
        return cls(location_id, materialized, is_dir, name, ext, rel)

    @classmethod
    def from_relative_str(
        cls, location_id: int, relative: str, is_dir: bool | None = None
    ) -> "IsolatedFilePathData":
        """Parse a stored relative path; trailing '/' implies a dir."""
        if is_dir is None:
            is_dir = relative.endswith("/")
        rel = relative.strip("/")
        if not rel:
            return cls(location_id, "/", True, "", "", "")
        parent, _, filename = rel.rpartition("/")
        materialized = f"/{parent}/" if parent else "/"
        if is_dir:
            name, ext = filename, ""
        else:
            name, ext = separate_name_and_extension(filename)
        return cls(location_id, materialized, is_dir, name, ext, rel)

    @classmethod
    def from_db_row(
        cls, location_id: int, materialized_path: str, name: str, extension: str, is_dir: bool
    ) -> "IsolatedFilePathData":
        rel = materialized_path[1:] + name
        if not is_dir and extension:
            rel = f"{rel}.{extension}"
        return cls(location_id, materialized_path, is_dir, name, extension, rel)

    @property
    def is_root(self) -> bool:
        return self.is_dir and self.materialized_path == "/" and not self.name

    def full_name(self) -> str:
        if self.extension and not self.is_dir:
            return f"{self.name}.{self.extension}"
        return self.name

    def parent(self) -> "IsolatedFilePathData":
        if self.materialized_path == "/":
            return IsolatedFilePathData(self.location_id, "/", True, "", "", "")
        trimmed = self.materialized_path.strip("/")
        parent_of_parent, _, dir_name = trimmed.rpartition("/")
        materialized = f"/{parent_of_parent}/" if parent_of_parent else "/"
        return IsolatedFilePathData(
            self.location_id, materialized, True, dir_name, "", trimmed
        )

    def materialized_path_for_children(self) -> str | None:
        """What this row's children store as their materialized_path."""
        if not self.is_dir:
            return None
        if self.is_root:
            return "/"
        return f"{self.materialized_path}{self.name}/"

    def join_on(self, location_path: str | os.PathLike) -> str:
        """Absolute filesystem path of this row under `location_path`."""
        return os.path.join(os.fspath(location_path), self.relative_path.replace("/", os.sep))

    def __str__(self) -> str:
        return self.relative_path


def materialized_prefix(sub_path: str | None) -> str:
    """Materialized-path prefix for a location-relative sub_path; root
    ("", "/") is "/" so `LIKE prefix%` covers the whole location."""
    if not sub_path or sub_path.strip("/") == "":
        return "/"
    return f"/{sub_path.strip('/')}/"


def full_path_from_db_row(location_path: str | os.PathLike, row: dict) -> str:
    """Absolute path of a file_path DB row — the one canonical
    reconstruction used by every pipeline."""
    iso = IsolatedFilePathData.from_db_row(
        row.get("location_id", 0),
        row["materialized_path"],
        row["name"],
        row["extension"] or "",
        bool(row.get("is_dir")),
    )
    return iso.join_on(location_path)
