"""Library — one synced database + its services.

Parity: ref:core/src/library/ — `Library{id, config, db, sync,
instance_uuid, event_bus}` (library.rs:29-54) and the `Libraries`
manager loading `libraries/*.sdlibrary` configs next to per-library
SQLite files (manager/mod.rs:62-130), creating the local Instance row
on create, wiring the sync manager, and cold-resuming jobs.

Counterpart of `spacedrive_tpu/node/library.py`. Each Library also
holds its search index (object/search/index.LibraryIndex), which the JAX
package keeps in a process-wide registry. Its orphan remover, its sync
ingest actor (`ingest`, set by whoever pulls ops for it) and its key
manager (`key_manager`, made at the first `keys.*` call) start unset.
"""

from __future__ import annotations

import os
import platform
import uuid
from dataclasses import dataclass
from typing import Any

from ..db import LibraryDb
from ..db.database import new_pub_id, now_iso
from ..object.search.index import LibraryIndex
from ..sync.manager import SyncManager
from ..utils.events import EventBus
from ..utils.version_manager import VersionManager

LIBRARY_CONFIG_VERSION = 1

_config_vm = VersionManager(LIBRARY_CONFIG_VERSION)


@dataclass
class LibraryConfig:
    """Per-library JSON config (ref:core/src/library/config.rs)."""

    name: str
    description: str = ""
    instance_id: int = 0  # local DB id of this device's Instance row
    version: int = LIBRARY_CONFIG_VERSION

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "description": self.description,
            "instance_id": self.instance_id,
            "version": self.version,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LibraryConfig":
        return cls(
            name=d.get("name", ""),
            description=d.get("description", ""),
            instance_id=d.get("instance_id", 0),
            version=d.get("version", LIBRARY_CONFIG_VERSION),
        )


class Library:
    def __init__(
        self,
        lib_id: uuid.UUID,
        config: LibraryConfig,
        db: LibraryDb,
        instance_uuid: uuid.UUID,
        event_bus: EventBus | None = None,
        node: Any = None,
    ):
        self.id = lib_id
        self.config = config
        self.db = db
        self.instance_uuid = instance_uuid
        self.event_bus = event_bus or EventBus()
        self.node = node
        self.sync = SyncManager(db, instance_uuid, self.event_bus)
        self.search_index = LibraryIndex(self)
        self.orphan_remover: Any = None
        self.ingest: Any = None  # sync/ingest.IngestActor
        self.key_manager: Any = None  # crypto/keys.KeyManager

    @property
    def name(self) -> str:
        return self.config.name

    def close(self) -> None:
        self.db.close()

    def __repr__(self) -> str:
        return f"<Library {self.name!r} {str(self.id)[:8]}>"


class Libraries:
    """Loads/creates libraries under `<data_dir>/libraries/`
    (ref:core/src/library/manager/mod.rs)."""

    def __init__(self, data_dir: str | os.PathLike, node: Any = None):
        self.dir = os.path.join(os.fspath(data_dir), "libraries")
        os.makedirs(self.dir, exist_ok=True)
        self.node = node
        self.libraries: dict[uuid.UUID, Library] = {}

    # --- lifecycle ---

    def load_all(self) -> list[Library]:
        for fname in sorted(os.listdir(self.dir)):
            if fname.endswith(".sdlibrary"):
                lib_id = uuid.UUID(fname[: -len(".sdlibrary")])
                if lib_id not in self.libraries:
                    self.load(lib_id)
        return list(self.libraries.values())

    def _config_path(self, lib_id: uuid.UUID) -> str:
        return os.path.join(self.dir, f"{lib_id}.sdlibrary")

    def _db_path(self, lib_id: uuid.UUID) -> str:
        return os.path.join(self.dir, f"{lib_id}.db")

    def load(self, lib_id: uuid.UUID) -> Library:
        """(Re)load one library from disk (startup and the restore path)."""
        data = _config_vm.load(self._config_path(lib_id))
        config = LibraryConfig.from_dict(data)
        db = LibraryDb(self._db_path(lib_id))
        inst = db.find_one("instance", id=config.instance_id)
        if inst is None:
            raise ValueError(f"library {lib_id} missing local instance row")
        lib = Library(lib_id, config, db, uuid.UUID(bytes=inst["pub_id"]), node=self.node)
        self.libraries[lib_id] = lib
        return lib

    def create(self, name: str, description: str = "",
               node_pub_id: bytes | None = None, node_name: str | None = None) -> Library:
        lib_id = uuid.uuid4()
        db = LibraryDb(self._db_path(lib_id))
        instance_pub = new_pub_id()
        instance_id = db.insert(
            "instance",
            pub_id=instance_pub,
            identity=new_pub_id(),  # replaced by real keypair when p2p enabled
            node_id=node_pub_id or new_pub_id(),
            node_name=node_name or platform.node(),
            node_platform=_platform_int(),
            last_seen=now_iso(),
            date_created=now_iso(),
        )
        config = LibraryConfig(name=name, description=description, instance_id=instance_id)
        data = config.to_dict()
        _config_vm.save(self._config_path(lib_id), data)
        lib = Library(lib_id, config, db, uuid.UUID(bytes=instance_pub), node=self.node)
        self.libraries[lib_id] = lib

        from ..location.indexer.rules import seed_rules

        seed_rules(db)
        return lib

    def get(self, lib_id: uuid.UUID) -> Library | None:
        return self.libraries.get(lib_id)

    def save_config(self, lib: Library) -> None:
        """Persist a library's (possibly edited) config file."""
        _config_vm.save(self._config_path(lib.id), lib.config.to_dict())

    def paths(self, lib_id: uuid.UUID) -> tuple[str, str]:
        """(config_path, db_path) on disk — the backup/restore surface."""
        return self._config_path(lib_id), self._db_path(lib_id)

    def delete(self, lib_id: uuid.UUID) -> None:
        lib = self.libraries.pop(lib_id, None)
        if lib is not None:
            lib.close()
        for path in (self._config_path(lib_id), self._db_path(lib_id)):
            if os.path.exists(path):
                os.remove(path)


def _platform_int() -> int:
    """Platform enum (ref:core/src/node/mod.rs Platform)."""
    return {"Windows": 2, "Darwin": 3, "Linux": 4}.get(platform.system(), 0)
