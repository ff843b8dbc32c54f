"""P2P runtime — peer registry, metadata, events, stream dispatch.

Parity: ref:crates/p2p2/src/{p2p.rs,peer.rs,hooks.rs} — `P2P::new(app
name, identity)` owns a peer map keyed by `RemoteIdentity`, a mutable
self-metadata map advertised to the LAN, discovery/connection hooks and
an event stream (`P2P::events`), and dispatches every inbound stream to
the application handler (p2p.rs:23-44). Discovery backends (mdns) and
the listener register themselves onto this object.

Counterpart of `spacedrive_tpu/p2p/p2p.py`, with its `p2p.connect`
fault point.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from ..utils.events import EventBus
from .identity import Identity, RemoteIdentity
from . import transport
from .transport import EncryptedStream, Listener


@dataclass
class Peer:
    """ref:p2p2 `Peer` — identity + discovered metadata/addresses +
    connection state."""

    identity: RemoteIdentity
    metadata: dict[str, str] = field(default_factory=dict)
    addrs: set[tuple[str, int]] = field(default_factory=set)
    discovered_by: set[str] = field(default_factory=set)
    last_seen: float = 0.0
    active_connections: int = 0
    relayed: bool = False  # reachable through the WAN relay (p2p/relay.py)

    @property
    def is_connected(self) -> bool:
        return self.active_connections > 0

    @property
    def is_discovered(self) -> bool:
        return bool(self.addrs) or self.relayed


StreamHandler = Callable[[EncryptedStream], Awaitable[None]]


class P2P:
    """One per node (ref:p2p.rs:23 `P2P`)."""

    def __init__(self, app_name: str, identity: Identity | None = None):
        self.app_name = app_name
        self.identity = identity or Identity()
        self.remote_identity = self.identity.to_remote_identity()
        self.metadata: dict[str, str] = {}
        self.peers: dict[RemoteIdentity, Peer] = {}
        self.events = EventBus()
        self.listener: Listener | None = None
        self._handler: StreamHandler | None = None
        self._discovery: list[Any] = []
        # relayed dialing fallback, set by p2p/relay.py RelayClient
        # (signature: (identity, *, timeout) -> EncryptedStream)
        self.relay_dial: Callable[..., Awaitable[EncryptedStream]] | None = None

    # --- listener ------------------------------------------------------

    async def listen(self, port: int = 0, host: str = "0.0.0.0") -> int:
        """Bind the accept socket; inbound streams go to the registered
        handler (ref:quic/transport.rs listener task)."""
        self.listener = await transport.listen(
            self.identity, self._on_stream, host=host, port=port
        )
        return self.listener.port

    def set_stream_handler(self, handler: StreamHandler) -> None:
        self._handler = handler

    async def _on_stream(self, stream: EncryptedStream) -> None:
        peer = self.touch_peer(stream.remote_identity)
        peer.active_connections += 1
        try:
            # inside the try: a raising event subscriber must not leave
            # active_connections inflated forever (sdlint SD016) — and
            # the Connected/Disconnected pairing survives it
            self.events.emit(("PeerConnected", stream.remote_identity))
            if self._handler is not None:
                await self._handler(stream)
        finally:
            peer.active_connections -= 1
            self.events.emit(("PeerDisconnected", stream.remote_identity))

    # --- registry ------------------------------------------------------

    def touch_peer(self, identity: RemoteIdentity) -> Peer:
        peer = self.peers.get(identity)
        if peer is None:
            peer = Peer(identity=identity)
            self.peers[identity] = peer
        peer.last_seen = time.monotonic()
        return peer

    def discovered(
        self,
        source: str,
        identity: RemoteIdentity,
        addrs: set[tuple[str, int]],
        metadata: dict[str, str],
    ) -> None:
        """A discovery backend saw a peer (ref:hooks.rs discovery hook)."""
        if identity == self.remote_identity:
            return
        peer = self.touch_peer(identity)
        fresh = not peer.is_discovered
        changed = any(peer.metadata.get(k) != v for k, v in metadata.items())
        peer.addrs |= addrs
        peer.metadata.update(metadata)
        peer.discovered_by.add(source)
        if fresh:
            self.events.emit(("PeerDiscovered", identity))
        elif changed:
            # e.g. the peer joined a new library since its last beacon
            self.events.emit(("PeerMetadataChanged", identity))

    def expired(self, source: str, identity: RemoteIdentity) -> None:
        peer = self.peers.get(identity)
        if peer is None:
            return
        peer.discovered_by.discard(source)
        if not peer.discovered_by:
            peer.addrs.clear()
            self.events.emit(("PeerExpired", identity))

    def discovered_peers(self) -> list[Peer]:
        return [p for p in self.peers.values() if p.is_discovered]

    # --- outbound ------------------------------------------------------

    async def new_stream(
        self, identity: RemoteIdentity, timeout: float = 10.0
    ) -> EncryptedStream:
        """Open a fresh authenticated unicast stream to a discovered
        peer: direct LAN addresses first, then the WAN relay fallback
        (ref:p2p2 `Peer::new_stream`; relayed parity with
        quic/transport.rs:212,344)."""
        from ..utils import faults as _faults

        if _faults.hit("p2p.connect") is not None:
            raise ConnectionResetError(
                f"injected connection reset dialing {identity}"
            )
        peer = self.peers.get(identity)
        if peer is None or not peer.is_discovered:
            raise ConnectionError(f"peer {identity} not discovered")

        def adopt(stream: EncryptedStream) -> EncryptedStream:
            peer.active_connections += 1
            orig_close = stream.close

            async def close(_orig=orig_close, _peer=peer):
                _peer.active_connections -= 1
                await _orig()

            stream.close = close  # type: ignore[method-assign]
            return stream

        last_err: Exception | None = None
        for addr in sorted(peer.addrs):
            try:
                return adopt(await transport.connect(
                    addr, self.identity, expect=identity, timeout=timeout
                ))
            except (OSError, transport.HandshakeError, asyncio.TimeoutError) as e:
                last_err = e
        if peer.relayed and self.relay_dial is not None:
            try:
                return adopt(await self.relay_dial(identity, timeout=timeout))
            except (OSError, ConnectionError, transport.HandshakeError,
                    asyncio.TimeoutError) as e:
                last_err = e
        raise ConnectionError(f"all routes failed for {identity}: {last_err}")

    # --- lifecycle -----------------------------------------------------

    def register_discovery(self, backend: Any) -> None:
        self._discovery.append(backend)

    async def shutdown(self) -> None:
        for d in self._discovery:
            await d.shutdown()
        self._discovery.clear()
        if self.listener is not None:
            await self.listener.close()
            self.listener = None
