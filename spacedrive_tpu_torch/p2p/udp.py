"""Thin asyncio UDP endpoint with an injectable receive path.

The hole-punching stack (`punch.py`, `udpstream.py`) talks to this
interface instead of raw sockets so the test suite can interpose
simulated NATs (address/port translation + inbound filtering) with real
sockets underneath — the same seam libp2p gets from its transport
abstraction (ref:crates/p2p2/src/quic/transport.rs behind libp2p's
`Transport` trait).

Counterpart of `spacedrive_tpu/p2p/udp.py`.
"""

from __future__ import annotations

import asyncio
from typing import Callable

Receiver = Callable[[bytes, tuple[str, int]], None]


class UdpEndpoint:
    """One bound UDP socket. `receiver` gets every datagram; `sendto`
    sends from the bound port (so NAT mappings stay stable across
    relay-observe and peer traffic — the whole point of punching)."""

    def __init__(self) -> None:
        self._transport: asyncio.DatagramTransport | None = None
        self._receiver: Receiver | None = None
        self.local_addr: tuple[str, int] | None = None

    async def bind(self, host: str = "0.0.0.0", port: int = 0) -> tuple[str, int]:
        loop = asyncio.get_running_loop()
        outer = self

        class _Proto(asyncio.DatagramProtocol):
            def datagram_received(self, data: bytes, addr: tuple[str, int]):
                if outer._receiver is not None:
                    outer._receiver(data, addr[:2])

        self._transport, _ = await loop.create_datagram_endpoint(
            _Proto, local_addr=(host, port)
        )
        # the default ~208 KiB buffers hold <200 MTU-sized datagrams —
        # one paced burst from a large congestion window; ask for 4 MiB
        # (the kernel clamps to {r,w}mem_max, so this is best-effort)
        sock = self._transport.get_extra_info("socket")
        if sock is not None:
            import socket as _socket

            for opt in (_socket.SO_RCVBUF, _socket.SO_SNDBUF):
                try:
                    sock.setsockopt(_socket.SOL_SOCKET, opt, 4 << 20)
                except OSError:
                    pass
        self.local_addr = self._transport.get_extra_info("sockname")[:2]
        return self.local_addr

    def set_receiver(self, receiver: Receiver | None) -> None:
        self._receiver = receiver

    def sendto(self, data: bytes, addr: tuple[str, int]) -> None:
        if self._transport is not None:
            self._transport.sendto(data, tuple(addr))

    def close(self) -> None:
        if self._transport is not None:
            self._transport.close()
            self._transport = None
