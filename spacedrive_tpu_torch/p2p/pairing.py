"""Library pairing — join a peer's library over the mesh.

Parity role: the reference's device-pairing flow (its `pairing.rs`
iteration; the shipped tree pairs instances through the cloud's
instance registry instead — crates/cloud-api `library::join`). Here
pairing rides the P2P mesh directly:

  joiner → owner: PAIRING header ‖ {library_id?, joiner instance info}
  owner:  user accept/reject (same pending-decision surface as
          Spacedrop, auto-accept flag for headless nodes)
  owner → joiner: {library config, instance registry}
  both:   register each other's instance rows; the joiner creates a
          local library with the SAME id, runs sync backfill-free and
          pulls the owner's op log through the normal sync exchange
          (alert → watermark pull), converging to the full library.

The data plane stays CRDT sync — pairing only moves identity +
membership, never rows, so a million-file library joins in O(instances)
bytes and then streams in the background.

Counterpart of `spacedrive_tpu/p2p/pairing.py`: the same frames and the
same join; the owner backfills through the port's
`sync/ingest.backfill_operations`.
"""

from __future__ import annotations

import asyncio
import logging
import os
import uuid
from dataclasses import dataclass, field
from typing import Any

from ..db.database import now_iso
from ..sync.hlc import NTP64
from .identity import RemoteIdentity
from .protocol import Header, HeaderType
from .wire import Reader, Writer

logger = logging.getLogger(__name__)

PAIRING_TIMEOUT = 60.0


@dataclass
class PairingRequest:
    """An inbound join offer pending user decision."""

    id: uuid.UUID
    peer: RemoteIdentity
    library_id: uuid.UUID | None  # None = "any library you offer"
    node_name: str
    _decision: asyncio.Future = field(repr=False, default=None)  # type: ignore[assignment]


class PairingManager:
    """Hangs off P2PManager (accept/reject mirror SpacedropManager)."""

    def __init__(self, node: Any, event_bus: Any = None):
        self.node = node
        self.event_bus = event_bus
        self.pending: dict[uuid.UUID, PairingRequest] = {}
        self.auto_accept = False  # headless nodes can opt in

    # --- joiner side ---------------------------------------------------

    async def join(
        self,
        p2p: Any,
        identity: RemoteIdentity,
        library_id: uuid.UUID | None = None,
    ) -> Any:
        """Request membership of a peer's library; returns the local
        Library on success."""
        # fail fast (also checked in _create_joined_library): a doomed
        # request must not reach the owner and raise a consent prompt
        if library_id is not None and self.node.libraries.get(library_id) is not None:
            raise FileExistsError(f"library {library_id} already exists here")
        stream = await p2p.new_stream(identity)
        try:
            await Header(HeaderType.PAIRING).write(stream)
            w, r = Writer(stream), Reader(stream)
            from ..node.library import _platform_int

            my_instance = {
                "node_name": self.node.config.config.name,
                "node_pub_id": self.node.id.bytes,
                "node_platform": _platform_int(),
                "identity": self.node.config.config.identity
                .to_remote_identity()
                .to_bytes(),
            }
            w.msgpack(
                {
                    "library_id": library_id.bytes if library_id else None,
                    "instance": my_instance,
                }
            )
            await w.flush()
            # bounded: the owner's user gets PAIRING_TIMEOUT to decide,
            # plus slack — a dead owner must not pin this API call open
            resp = await asyncio.wait_for(r.msgpack(), PAIRING_TIMEOUT + 15)
            if not resp.get("ok"):
                raise PermissionError(resp.get("error", "pairing rejected"))
            lib_id = uuid.UUID(bytes=resp["library_id"])
            config = resp["config"]
            instances = resp["instances"]

            lib = self._create_joined_library(lib_id, config, instances)
            try:
                # tell the owner our instance pub_id so both sides register
                w.msgpack({"instance_pub_id": lib.sync.instance.bytes})
                await w.flush()
                await self.node._init_library(lib)
                if self.node.p2p is not None:
                    self.node.p2p.register_library(lib)
                    # pull the op log right away (normal sync exchange)
                    ingest = self.node.p2p.ingest_actors.get(lib.id)
                    if ingest is not None:
                        ingest.notify()
            except BaseException:
                # roll the half-joined library back so a retry can succeed
                self.node.libraries.libraries.pop(lib.id, None)
                lib.close()
                for path in self.node.libraries.paths(lib.id):
                    for suffix in ("", "-wal", "-shm"):
                        p = path + suffix
                        if os.path.exists(p):
                            os.remove(p)
                raise
            return lib
        finally:
            await stream.close()

    def _create_joined_library(
        self, lib_id: uuid.UUID, config: dict[str, Any], instances: list[dict]
    ) -> Any:
        from ..node.library import Library, LibraryConfig, _platform_int
        from ..db import LibraryDb
        from ..db.database import new_pub_id

        libraries = self.node.libraries
        if libraries.get(lib_id) is not None:
            raise FileExistsError(f"library {lib_id} already exists here")
        db = LibraryDb(libraries._db_path(lib_id))
        try:
            return self._populate_joined_library(
                libraries, db, lib_id, config, instances
            )
        except BaseException:
            # never leave a half-written DB: a stale file with instance
            # rows makes every retry hit UNIQUE(pub_id)
            db.close()
            for path in libraries.paths(lib_id):
                for suffix in ("", "-wal", "-shm"):
                    if os.path.exists(path + suffix):
                        os.remove(path + suffix)
            raise

    def _populate_joined_library(
        self, libraries, db, lib_id: uuid.UUID, config: dict[str, Any],
        instances: list[dict],
    ) -> Any:
        from ..node.library import Library, LibraryConfig, _platform_int
        from ..db.database import new_pub_id
        instance_pub = new_pub_id()
        instance_id = db.insert(
            "instance",
            pub_id=instance_pub,
            identity=self.node.config.config.identity
            .to_remote_identity()
            .to_bytes(),
            node_id=self.node.id.bytes,
            node_name=self.node.config.config.name,
            node_platform=_platform_int(),
            last_seen=now_iso(),
            date_created=now_iso(),
        )
        for inst in instances:  # the existing membership
            db.insert(
                "instance",
                pub_id=inst["pub_id"],
                identity=inst.get("identity") or b"",
                node_id=inst.get("node_id") or b"",
                node_name=inst.get("node_name") or "",
                node_platform=inst.get("node_platform") or 0,
                last_seen=now_iso(),
                date_created=inst.get("date_created") or now_iso(),
            )
        lib_config = LibraryConfig(
            name=config.get("name", "joined"),
            description=config.get("description", ""),
            instance_id=instance_id,
        )
        from ..node.library import _config_vm

        _config_vm.save(libraries._config_path(lib_id), lib_config.to_dict())
        lib = Library(
            lib_id, lib_config, db, uuid.UUID(bytes=instance_pub),
            node=self.node,
        )
        libraries.libraries[lib_id] = lib
        from ..location.indexer.rules import seed_rules

        seed_rules(db)
        return lib

    # --- owner side ----------------------------------------------------

    async def handle_inbound(self, stream: Any) -> None:
        r, w = Reader(stream), Writer(stream)
        req_body = await r.msgpack()
        lib_id = (
            uuid.UUID(bytes=req_body["library_id"])
            if req_body.get("library_id")
            else None
        )
        # resolve the library BEFORE bothering the user: an unsatisfiable
        # request gets a distinct error, no consent prompt
        if lib_id is not None:
            target = self.node.libraries.get(lib_id)
        elif self.node.libraries.libraries:
            target = next(iter(self.node.libraries.libraries.values()))
        else:
            target = None
        if target is None:
            w.msgpack({"ok": False, "error": "library not found on this node"})
            await w.flush()
            return
        # backfill pre-sync rows NOW, overlapping the user's decision —
        # never inside the reply window (a big library would blow the
        # joiner's read deadline)
        from ..sync.ingest import backfill_operations

        backfill_task = asyncio.ensure_future(
            asyncio.to_thread(backfill_operations, target.sync)
        )
        req = PairingRequest(
            id=uuid.uuid4(),
            peer=stream.remote_identity,
            library_id=lib_id,
            node_name=req_body.get("instance", {}).get("node_name", "?"),
            _decision=asyncio.get_running_loop().create_future(),
        )
        if self.auto_accept:
            req._decision.set_result(True)
        else:
            self.pending[req.id] = req
            if self.event_bus is not None:
                self.event_bus.emit(("PairingRequest", req))
        try:
            accepted = await asyncio.wait_for(req._decision, PAIRING_TIMEOUT)
        except asyncio.TimeoutError:
            accepted = False
        finally:
            self.pending.pop(req.id, None)

        lib = target if accepted else None
        if lib is None:
            backfill_task.cancel()
            w.msgpack({"ok": False, "error": "pairing rejected"})
            await w.flush()
            return
        # rows that predate sync must have ops before the joiner pulls
        await backfill_task
        instances = [
            {
                "pub_id": row["pub_id"],
                "identity": row["identity"],
                "node_id": row["node_id"],
                "node_name": row["node_name"],
                "node_platform": row["node_platform"],
                "date_created": row["date_created"],
            }
            for row in lib.db.find("instance")
        ]
        w.msgpack(
            {
                "ok": True,
                "library_id": lib.id.bytes,
                "config": {
                    "name": lib.config.name,
                    "description": lib.config.description,
                },
                "instances": instances,
            }
        )
        await w.flush()
        # register the joiner's new instance on our side; bounded read —
        # a stalled joiner must not pin this handler forever
        joiner = await asyncio.wait_for(r.msgpack(), PAIRING_TIMEOUT)
        inst = req_body.get("instance", {})
        lib.db.insert(
            "instance",
            pub_id=joiner["instance_pub_id"],
            identity=inst.get("identity") or b"",
            node_id=inst.get("node_pub_id") or b"",
            node_name=inst.get("node_name") or "",
            node_platform=inst.get("node_platform") or 0,
            last_seen=now_iso(),
            date_created=now_iso(),
        )
        lib.sync.timestamps.setdefault(
            uuid.UUID(bytes=joiner["instance_pub_id"]), NTP64(0)
        )
        if self.event_bus is not None:
            self.event_bus.emit(("PairingComplete", req.id, str(lib.id)))

    def accept(self, pairing_id: uuid.UUID) -> bool:
        req = self.pending.get(pairing_id)
        if req is None or req._decision.done():
            return False
        req._decision.set_result(True)
        return True

    def reject(self, pairing_id: uuid.UUID) -> bool:
        req = self.pending.get(pairing_id)
        if req is None or req._decision.done():
            return False
        req._decision.set_result(False)
        return True
