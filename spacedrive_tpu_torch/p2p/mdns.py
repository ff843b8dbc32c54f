"""LAN discovery — periodic UDP service beacons.

Parity: ref:crates/p2p2/src/mdns.rs — the reference registers a
`_sd._udp.local.` mDNS service via `mdns_sd::ServiceDaemon` whose TXT
records carry the peer metadata, and maps add/remove events into the
P2P registry (mdns.rs:6-53, service expiry included). Python has no
baked-in mDNS stack, so this speaks the same *shape* over a simpler
wire: a JSON beacon datagram `{app, identity, port, metadata}`
multicast every `interval` seconds, with peer expiry after
`expiry` seconds of silence. `beacon_addrs` can be overridden with
unicast addresses (tests use loopback pairs; WAN meshes can seed
static peers the same way).

Counterpart of `spacedrive_tpu/p2p/mdns.py`: the same beacon, so port
and JAX peers discover each other.
"""

from __future__ import annotations

import asyncio
import json
import socket
import time
from typing import Any

from .identity import RemoteIdentity
from .p2p import P2P

MULTICAST_GROUP = "239.255.41.41"
MULTICAST_PORT = 41841
SOURCE = "mdns"


class MdnsDiscovery:
    def __init__(
        self,
        p2p: P2P,
        service_port: int,
        *,
        bind_port: int = MULTICAST_PORT,
        beacon_addrs: list[tuple[str, int]] | None = None,
        interval: float = 1.0,
        expiry: float = 5.0,
    ):
        self.p2p = p2p
        self.service_port = service_port
        self.bind_port = bind_port
        self.beacon_addrs = beacon_addrs or [(MULTICAST_GROUP, MULTICAST_PORT)]
        self.interval = interval
        self.expiry = expiry
        self._sock: socket.socket | None = None
        self._tasks: list[asyncio.Task] = []
        self._seen: dict[RemoteIdentity, float] = {}
        self._stopped = False

    async def start(self) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT"):
            try:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            except OSError:
                pass
        sock.bind(("0.0.0.0", self.bind_port))
        self.bind_port = sock.getsockname()[1]
        try:  # join the multicast group when the env allows it
            mreq = socket.inet_aton(MULTICAST_GROUP) + socket.inet_aton("0.0.0.0")
            sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
            sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        except OSError:
            pass
        sock.setblocking(False)
        self._sock = sock
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._beacon_loop(), name="mdns-beacon"),
            loop.create_task(self._recv_loop(), name="mdns-recv"),
            loop.create_task(self._expiry_loop(), name="mdns-expiry"),
        ]
        self.p2p.register_discovery(self)

    def _payload(self) -> bytes:
        return json.dumps(
            {
                "app": self.p2p.app_name,
                "identity": str(self.p2p.remote_identity),
                "port": self.service_port,
                "metadata": self.p2p.metadata,
            }
        ).encode()

    async def _beacon_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopped:
            payload = self._payload()
            for addr in self.beacon_addrs:
                try:
                    await loop.sock_sendto(self._sock, payload, addr)
                except OSError:
                    pass
            await asyncio.sleep(self.interval)

    async def _recv_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopped:
            try:
                data, addr = await loop.sock_recvfrom(self._sock, 65535)
                msg = json.loads(data)
                if msg.get("app") != self.p2p.app_name:
                    continue
                identity = RemoteIdentity.from_str(msg["identity"])
                if identity == self.p2p.remote_identity:
                    continue
                self._seen[identity] = time.monotonic()
                self.p2p.discovered(
                    SOURCE,
                    identity,
                    {(addr[0], int(msg["port"]))},
                    dict(msg.get("metadata", {})),
                )
            except (json.JSONDecodeError, KeyError, ValueError):
                continue
            except OSError:
                return

    async def _expiry_loop(self) -> None:
        while not self._stopped:
            await asyncio.sleep(self.expiry / 2)
            cutoff = time.monotonic() - self.expiry
            for identity, seen in list(self._seen.items()):
                if seen < cutoff:
                    del self._seen[identity]
                    self.p2p.expired(SOURCE, identity)

    async def shutdown(self) -> None:
        self._stopped = True
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        if self._sock is not None:
            self._sock.close()
