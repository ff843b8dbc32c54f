"""NodeConfig — the per-device JSON config with versioned migrations.

Parity: ref:core/src/node/config.rs:56-124 — `NodeConfig{id, name,
identity, p2p: {port, discovery}, features, preferences,
image_labeler_version}` stored as `node.json` in the data dir, loaded
through a `VersionManager` (config.rs:171) that applies sequential
migrations. The identity keypair lives in the config exactly as the
reference stores its ed25519 keypair.

Counterpart of `spacedrive_tpu/node/config.py`; a `node.json` either
package writes loads in the other.
"""

from __future__ import annotations

import os
import platform
import threading
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any

from ..p2p.identity import Identity
from ..utils.version_manager import VersionManager

NODE_CONFIG_VERSION = 2

_vm = VersionManager(NODE_CONFIG_VERSION)


@_vm.register(1)
def _v1_to_v2(data: dict[str, Any]) -> dict[str, Any]:
    # v2 added the features list (ref: config.rs migrations add/remove keys)
    data.setdefault("features", [])
    return data


class BackendFeature(str, Enum):
    """Runtime-toggleable features (ref:core/src/api/mod.rs:66-81)."""

    FILES_OVER_P2P = "filesOverP2P"
    CLOUD_SYNC = "cloudSync"
    REMOTE_RSPC = "remoteRspc"  # serve queries to mesh peers (off by default)


class P2PDiscoveryState(str, Enum):
    """ref:core/src/node/config.rs `P2PDiscoveryState`."""

    EVERYONE = "everyone"
    CONTACTS_ONLY = "contactsOnly"
    DISABLED = "disabled"


@dataclass
class NodeConfigP2P:
    """ref:config.rs p2p block: enabled flag, fixed port (0 = random),
    discovery mode."""

    enabled: bool = True
    port: int = 0
    discovery: P2PDiscoveryState = P2PDiscoveryState.EVERYONE
    relay: str | None = None  # "host:port" WAN relay rendezvous (optional)

    def to_dict(self) -> dict[str, Any]:
        return {
            "enabled": self.enabled,
            "port": self.port,
            "discovery": self.discovery.value,
            "relay": self.relay,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "NodeConfigP2P":
        return cls(
            enabled=bool(d.get("enabled", True)),
            port=int(d.get("port", 0)),
            discovery=P2PDiscoveryState(d.get("discovery", "everyone")),
            relay=d.get("relay") or None,
        )


@dataclass
class NodeConfig:
    id: uuid.UUID = field(default_factory=uuid.uuid4)
    name: str = field(default_factory=platform.node)
    identity: Identity = field(default_factory=Identity)
    p2p: NodeConfigP2P = field(default_factory=NodeConfigP2P)
    features: list[BackendFeature] = field(default_factory=list)
    preferences: dict[str, Any] = field(default_factory=dict)
    image_labeler_version: str | None = None
    version: int = NODE_CONFIG_VERSION

    def to_dict(self) -> dict[str, Any]:
        return {
            "version": self.version,
            "id": str(self.id),
            "name": self.name,
            "identity": self.identity.to_bytes().hex(),
            "p2p": self.p2p.to_dict(),
            "features": [f.value for f in self.features],
            "preferences": self.preferences,
            "image_labeler_version": self.image_labeler_version,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "NodeConfig":
        return cls(
            id=uuid.UUID(d["id"]) if "id" in d else uuid.uuid4(),
            name=d.get("name") or platform.node(),
            identity=(
                Identity.from_bytes(bytes.fromhex(d["identity"]))
                if d.get("identity")
                else Identity()
            ),
            p2p=NodeConfigP2P.from_dict(d.get("p2p", {})),
            features=[BackendFeature(f) for f in d.get("features", [])],
            preferences=d.get("preferences", {}),
            image_labeler_version=d.get("image_labeler_version"),
            version=d.get("version", NODE_CONFIG_VERSION),
        )


class ConfigManager:
    """Load-or-init + atomic persist of `node.json`
    (ref:core/src/node/config.rs:293 `config::Manager::new`)."""

    FILENAME = "node.json"

    def __init__(self, data_dir: str | os.PathLike):
        self.path = os.path.join(os.fspath(data_dir), self.FILENAME)
        self._lock = threading.Lock()
        if os.path.exists(self.path):
            data = _vm.load(self.path)
            self.config = NodeConfig.from_dict(data)
            # persist any defaults from_dict filled in (a migrated file
            # missing `identity` must not mint a new keypair every boot)
            if self.config.to_dict() != data:
                self.save()
        else:
            self.config = NodeConfig()
            self.save()

    def save(self) -> None:
        with self._lock:
            _vm.save(self.path, self.config.to_dict())

    def update(self, **fields: Any) -> NodeConfig:
        """Mutate-and-persist (ref:config.rs `Manager::write`)."""
        for k, v in fields.items():
            if not hasattr(self.config, k):
                raise AttributeError(f"NodeConfig has no field {k!r}")
            setattr(self.config, k, v)
        self.save()
        return self.config
