"""VersionManager — generic versioned-JSON config migration.

Parity: ref:core/src/util/version_manager.rs:62-143. Every on-disk
config (node, library, thumbnailer dir, …) carries a `version` field;
loading walks registered migrations from the stored version to current,
one step at a time, persisting after each step so a crash mid-migration
resumes cleanly.

Counterpart of `spacedrive_tpu/utils/version_manager.py`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

from .errors import VersionManagerError

Migration = Callable[[dict[str, Any]], dict[str, Any]]


class VersionManager:
    """Migrates dict-shaped configs `from_version -> from_version + 1`."""

    def __init__(self, current_version: int, version_field: str = "version"):
        self.current_version = current_version
        self.version_field = version_field
        self._migrations: dict[int, Migration] = {}

    def register(self, from_version: int) -> Callable[[Migration], Migration]:
        def deco(fn: Migration) -> Migration:
            self._migrations[from_version] = fn
            return fn
        return deco

    def migrate(self, data: dict[str, Any], save: Callable[[dict[str, Any]], None] | None = None) -> dict[str, Any]:
        version = int(data.get(self.version_field, 0))
        if version > self.current_version:
            raise VersionManagerError(
                f"config version {version} is newer than supported {self.current_version}"
            )
        while version < self.current_version:
            step = self._migrations.get(version)
            if step is None:
                raise VersionManagerError(f"no migration registered from version {version}")
            data = step(dict(data))
            version += 1
            data[self.version_field] = version
            if save is not None:
                save(data)
        return data

    def load(self, path: str | os.PathLike, default: dict[str, Any] | None = None) -> dict[str, Any]:
        """Load + migrate + persist a JSON config file."""
        path = os.fspath(path)
        if not os.path.exists(path):
            if default is None:
                raise VersionManagerError(f"missing config {path!r} and no default")
            data = dict(default)
            data[self.version_field] = self.current_version
            self.save(path, data)
            return data
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        return self.migrate(data, save=lambda d: self.save(path, d))

    @staticmethod
    def save(path: str | os.PathLike, data: dict[str, Any]) -> None:
        """Atomic write (tmp + rename), the crash-safety the reference
        gets from its write-then-rename config store."""
        path = os.fspath(path)
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
