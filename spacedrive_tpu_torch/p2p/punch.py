"""NAT hole punching — DCUtR-style UDP simultaneous open via the relay.

Parity: the reference punches through NATs for direct WAN paths using
libp2p DCUtR over its relayed connection, falling back to the relay
when punching fails (ref:crates/p2p2/src/quic/transport.rs:212,344
`open_stream_with_addrs` on a patched libp2p). Same shape here:

1. **observe** — each peer sends a datagram to the relay's UDP port
   from the SAME socket it will punch with; the relay echoes the
   source address it saw (STUN's binding-request role). That address
   is the peer's NAT mapping.
2. **exchange** — observed addresses cross through the peers'
   authenticated relay control channels (`{"cmd":"punch"}` routed to
   the target, `punch_ack` routed back). Addresses are only ever
   disclosed to registered, challenge-authenticated identities.
3. **simultaneous open** — both sides spray small probes at each
   other's observed address. Outbound probes open the cone-NAT
   mapping; the first probe/probe-ack that lands proves the path.
4. **secure channel** — the winner runs the ordinary Noise XX
   handshake (`transport.py`) over a reliable UDP stream
   (`udpstream.py`). Identity binding and channel security are
   exactly the TCP path's; a relay that lies about addresses can only
   prevent the direct path, never impersonate (docs/security.md).

Symmetric NATs allocate a different mapping per destination, so the
observed (relay-facing) address is useless to the peer and the probes
never land: punching times out and the caller falls back to the
relayed TCP pipe. The test suite simulates cone and symmetric NATs
with real translating sockets (tests/test_punch.py).

Counterpart of `spacedrive_tpu/p2p/punch.py`: the same observe, probe
and ack datagrams.
"""

from __future__ import annotations

import asyncio
import json
import secrets

from .udp import UdpEndpoint

OBSERVE_MAGIC = b"SDOB"
PROBE = b"SDPU"
PROBE_ACK = b"SDPA"
PUNCH_TIMEOUT = 3.0
PROBE_INTERVAL = 0.1


class PunchError(ConnectionError):
    pass


async def observe(ep: UdpEndpoint, relay_udp: tuple[str, int],
                  timeout: float = 2.0) -> tuple[tuple[str, int], str]:
    """Learn this socket's public (NAT-mapped) address from the relay's
    UDP echo; returns (address, token). The token names this relay-
    witnessed observation in punch messages — the relay only routes
    addresses it saw itself, so probes cannot be pointed at third
    parties. Retries a few times — a single UDP loss must not kill the
    whole punch attempt."""
    token = secrets.token_hex(8)
    fut: asyncio.Future = asyncio.get_running_loop().create_future()

    def on_dgram(data: bytes, addr: tuple[str, int]) -> None:
        if not data.startswith(OBSERVE_MAGIC):
            return
        try:
            msg = json.loads(data[len(OBSERVE_MAGIC):])
        except ValueError:
            return
        if msg.get("token") == token and not fut.done():
            fut.set_result((msg["addr"][0], int(msg["addr"][1])))

    ep.set_receiver(on_dgram)
    try:
        request = OBSERVE_MAGIC + json.dumps({"token": token}).encode()
        for _ in range(4):
            ep.sendto(request, relay_udp)
            try:
                addr = await asyncio.wait_for(
                    asyncio.shield(fut), timeout / 4
                )
                return addr, token
            except asyncio.TimeoutError:
                continue
        raise PunchError("relay UDP observe timed out")
    finally:
        ep.set_receiver(None)


def observe_reply(token: str, addr: tuple[str, int]) -> bytes:
    """Relay side: the datagram answering an observe request."""
    return OBSERVE_MAGIC + json.dumps(
        {"token": token, "addr": [addr[0], addr[1]]}
    ).encode()


async def simultaneous_open(ep: UdpEndpoint, peer: tuple[str, int],
                            timeout: float = PUNCH_TIMEOUT) -> None:
    """Spray probes at the peer's observed address until traffic flows
    both ways (or raise). Keeps answering probes for a short grace
    period so the slower side also converges."""
    peer = (peer[0], int(peer[1]))
    opened: asyncio.Future = asyncio.get_running_loop().create_future()
    got_ack = False

    def on_dgram(data: bytes, addr: tuple[str, int]) -> None:
        nonlocal got_ack
        if tuple(addr) != peer:
            return
        if data.startswith(PROBE):
            # their probe reached us: our mapping is open their way —
            # ack it so THEY learn the path works
            ep.sendto(PROBE_ACK, peer)
            if not opened.done():
                opened.set_result(None)
        elif data.startswith(PROBE_ACK):
            got_ack = True
            if not opened.done():
                opened.set_result(None)

    ep.set_receiver(on_dgram)
    try:
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            ep.sendto(PROBE, peer)
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                raise PunchError(f"hole punch to {peer} timed out")
            try:
                await asyncio.wait_for(
                    asyncio.shield(opened), min(PROBE_INTERVAL, remaining)
                )
                break
            except asyncio.TimeoutError:
                continue
        # linger briefly: keep acking probes until the peer has seen
        # evidence too (it stops sending once its future resolves)
        linger = asyncio.get_running_loop().time() + 0.5
        while not got_ack and asyncio.get_running_loop().time() < linger:
            ep.sendto(PROBE, peer)
            await asyncio.sleep(PROBE_INTERVAL / 2)
    finally:
        ep.set_receiver(None)
