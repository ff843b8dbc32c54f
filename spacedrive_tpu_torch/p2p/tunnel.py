"""Tunnel — library-instance authentication on top of a node stream.

Parity: ref:crates/p2p-tunnel/src/tunnel.rs — wraps an established
(already node-authenticated, already encrypted) stream with a second
handshake proving both ends belong to the same *library*: each side
signs a fresh challenge with its node identity and sends the library
instance it claims; the peer checks the claimed instance exists in its
own library DB. The reference's deeper per-instance re-encryption is
WIP/commented out of its workspace (Cargo.toml:7-8); we match the
shipped surface: authenticate, then pass reads/writes through.

Counterpart of `spacedrive_tpu/p2p/tunnel.py`.
"""

from __future__ import annotations

import os
import uuid
from typing import Any

from .identity import Identity, RemoteIdentity
from .wire import Reader, Writer


class TunnelError(Exception):
    pass


class Tunnel:
    """Authenticated pass-through wrapper (ref:tunnel.rs `Tunnel`)."""

    def __init__(self, stream: Any, remote_instance: uuid.UUID):
        self._stream = stream
        self.remote_instance = remote_instance

    async def write(self, data: bytes) -> None:
        await self._stream.write(data)

    async def read_exact(self, n: int) -> bytes:
        return await self._stream.read_exact(n)

    async def close(self) -> None:
        await self._stream.close()

    @property
    def remote_identity(self) -> RemoteIdentity:
        return self._stream.remote_identity

    @classmethod
    async def initiator(
        cls, stream: Any, identity: Identity, library_id: uuid.UUID,
        instance_uuid: uuid.UUID, known_instances: set[uuid.UUID],
    ) -> "Tunnel":
        w, r = Writer(stream), Reader(stream)
        challenge = os.urandom(32)
        w.uuid(library_id).uuid(instance_uuid).raw(challenge)
        w.raw(identity.sign(challenge + library_id.bytes + instance_uuid.bytes))
        await w.flush()
        remote_instance = await r.uuid()
        their_sig = await r.exact(64)
        if not stream.remote_identity.verify(
            their_sig, challenge + library_id.bytes + remote_instance.bytes
        ):
            raise TunnelError("responder signature invalid")
        if remote_instance not in known_instances:
            raise TunnelError(f"unknown remote instance {remote_instance}")
        return cls(stream, remote_instance)

    @classmethod
    async def responder(
        cls, stream: Any, identity: Identity, library_id: uuid.UUID,
        instance_uuid: uuid.UUID, known_instances: set[uuid.UUID],
    ) -> "Tunnel":
        w, r = Writer(stream), Reader(stream)
        claimed_library = await r.uuid()
        remote_instance = await r.uuid()
        challenge = await r.exact(32)
        their_sig = await r.exact(64)
        if claimed_library != library_id:
            raise TunnelError("library mismatch")
        if not stream.remote_identity.verify(
            their_sig, challenge + library_id.bytes + remote_instance.bytes
        ):
            raise TunnelError("initiator signature invalid")
        if remote_instance not in known_instances:
            raise TunnelError(f"unknown remote instance {remote_instance}")
        w.uuid(instance_uuid)
        w.raw(identity.sign(challenge + library_id.bytes + instance_uuid.bytes))
        await w.flush()
        return cls(stream, remote_instance)
