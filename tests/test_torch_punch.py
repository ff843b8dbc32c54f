"""The port's hole punching against the JAX package's.

tests/test_punch.py's cases pointed at `spacedrive_tpu_torch.p2p` (the
reliable UDP stream under loss and a hostile network, FIN, the relay's
observe, the direct path between cone NATs, the fallback to the relay
on a symmetric NAT or with punching off, the witnessed-address and
rate-limit checks, the client's accept caps) against simulated NATs of
real translating loopback sockets; its two Spacedrop cases need the
node's p2p and come with it. Then mixed punches: a JAX client and a
port client behind cone NATs, on a relay of either package, open a
direct Noise stream over the punched UDP path, each way.

Every case runs on 127.0.0.1 under its own asyncio timeout.
"""

import asyncio
import os

import pytest

import spacedrive_tpu.p2p.identity as j_identity
import spacedrive_tpu.p2p.p2p as j_p2p
import spacedrive_tpu.p2p.relay as j_relay
import spacedrive_tpu_torch.p2p.identity as p_identity
import spacedrive_tpu_torch.p2p.p2p as p_p2p
import spacedrive_tpu_torch.p2p.relay as p_relay

from spacedrive_tpu_torch.p2p import punch
from spacedrive_tpu_torch.p2p.identity import Identity
from spacedrive_tpu_torch.p2p.p2p import P2P
from spacedrive_tpu_torch.p2p.relay import RelayClient, RelayServer
from spacedrive_tpu_torch.p2p.udp import UdpEndpoint
from spacedrive_tpu_torch.p2p.udpstream import UdpStream



def _run(coro, timeout: float = 60.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class NattedEndpoint:
    """UdpEndpoint lookalike living behind a simulated NAT.

    The 'inside' host is in-process; the NAT's PUBLIC side is a real
    loopback socket (one for cone, one per destination for symmetric),
    so every datagram the protocol sends really crosses a translated
    socket with inbound filtering.
    """

    def __init__(self, kind: str = "cone", pool: int = 4):
        assert kind in ("cone", "symmetric")
        self.kind = kind
        self._pool_size = pool
        self._pubs: list[UdpEndpoint] = []       # symmetric: mapping pool
        self._by_dest: dict[tuple, UdpEndpoint] = {}
        self._allowed: dict[int, set[tuple]] = {}  # id(pub) → peers sent-to
        self._receiver = None
        self.local_addr = ("10.77.0.2", 40000)   # fake private address

    async def bind(self, host: str = "0.0.0.0", port: int = 0):
        n = 1 if self.kind == "cone" else self._pool_size
        for _ in range(n):
            pub = UdpEndpoint()
            await pub.bind("127.0.0.1", 0)
            self._allowed[id(pub)] = set()
            pub.set_receiver(self._filtered(pub))
            self._pubs.append(pub)
        return self.local_addr

    def _filtered(self, pub: UdpEndpoint):
        def on_dgram(data: bytes, addr: tuple):
            # restricted NAT: inbound only from peers this mapping
            # has already sent to
            if tuple(addr) not in self._allowed[id(pub)]:
                return
            if self._receiver is not None:
                self._receiver(data, addr)
        return on_dgram

    def _mapping_for(self, addr: tuple) -> UdpEndpoint:
        if self.kind == "cone":
            return self._pubs[0]
        pub = self._by_dest.get(addr)
        if pub is None:
            pub = self._pubs[len(self._by_dest) % len(self._pubs)]
            self._by_dest[addr] = pub
        return pub

    def set_receiver(self, receiver):
        self._receiver = receiver

    def sendto(self, data: bytes, addr: tuple):
        addr = tuple(addr)
        pub = self._mapping_for(addr)
        self._allowed[id(pub)].add(addr)
        pub.sendto(data, addr)

    def close(self):
        for pub in self._pubs:
            pub.close()
        self._pubs.clear()


# --- reliable UDP stream --------------------------------------------------


class LossyEndpoint(UdpEndpoint):
    """Deterministically drops every Nth datagram in each direction —
    retransmission must recover the stream bit-for-bit."""

    def __init__(self, drop_every: int = 5):
        super().__init__()
        self._n = 0
        self._drop_every = drop_every

    def sendto(self, data, addr):
        self._n += 1
        if self._n % self._drop_every == 0:
            return  # eaten by the network
        super().sendto(data, addr)


def test_udpstream_reliable_under_loss():
    async def run():
        a, b = LossyEndpoint(5), LossyEndpoint(4)
        addr_a = await a.bind("127.0.0.1")
        addr_b = await b.bind("127.0.0.1")
        sa = UdpStream(a, addr_b)
        sb = UdpStream(b, addr_a)
        payload = os.urandom(300_000)  # ~260 segments each way
        sa.write(payload)
        await sa.drain()
        sb.write(payload[::-1])
        await sb.drain()
        got_b = await asyncio.wait_for(sb.reader.readexactly(len(payload)), 30)
        got_a = await asyncio.wait_for(sa.reader.readexactly(len(payload)), 30)
        assert got_b == payload
        assert got_a == payload[::-1]
        sa.close()
        sb.close()
        await sa.wait_closed()

    _run(run())


class HostileEndpoint(UdpEndpoint):
    """Seeded random loss, duplication, and reordering — the property
    test drives the ARQ through adversarial network schedules."""

    def __init__(self, seed: int, loss: float = 0.15, dup: float = 0.1,
                 reorder: float = 0.2):
        super().__init__()
        import random

        self._rng = random.Random(seed)
        self._loss, self._dup, self._reorder = loss, dup, reorder
        self._held: list[tuple[bytes, tuple]] = []

    def sendto(self, data, addr):
        r = self._rng.random()
        if r < self._loss:
            return
        if r < self._loss + self._dup:
            super().sendto(data, addr)
        if self._rng.random() < self._reorder:
            self._held.append((bytes(data), tuple(addr)))
            if len(self._held) > 3:
                d, a = self._held.pop(0)
                super().sendto(d, a)
            return
        super().sendto(data, addr)
        while self._held and self._rng.random() < 0.5:
            d, a = self._held.pop(0)
            super().sendto(d, a)


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_udpstream_property_hostile_network(seed):
    """Loss + duplication + reordering in both directions: the stream
    still delivers every byte exactly once, in order."""

    async def run():
        a = HostileEndpoint(seed)
        b = HostileEndpoint(seed + 1000)
        addr_a = await a.bind("127.0.0.1")
        addr_b = await b.bind("127.0.0.1")
        sa, sb = UdpStream(a, addr_b), UdpStream(b, addr_a)
        import random

        rng = random.Random(seed)
        payload = bytes(rng.getrandbits(8) for _ in range(80_000))
        # interleaved variable-size writes exercise segmentation edges
        off = 0
        while off < len(payload):
            n = rng.randint(1, 7000)
            sa.write(payload[off:off + n])
            off += n
        await sa.drain()
        got = await asyncio.wait_for(sb.reader.readexactly(len(payload)), 60)
        assert got == payload
        sa.close()
        sb.close()

    _run(run())


def test_udpstream_fin_delivers_eof():
    async def run():
        a, b = UdpEndpoint(), UdpEndpoint()
        addr_a = await a.bind("127.0.0.1")
        addr_b = await b.bind("127.0.0.1")
        sa, sb = UdpStream(a, addr_b), UdpStream(b, addr_a)
        sa.write(b"tail")
        sa.close()
        assert await asyncio.wait_for(sb.reader.read(), 10) == b"tail"
        sb.close()

    _run(run())


# --- observe (STUN role) --------------------------------------------------


def test_observe_reports_nat_mapping():
    async def run():
        srv = RelayServer()
        await srv.start()
        nat = NattedEndpoint("cone")
        await nat.bind()
        try:
            addr, token = await punch.observe(nat, ("127.0.0.1", srv.udp_port))
            # the relay must see the NAT's PUBLIC mapping, not the
            # (fake) private address
            assert addr == nat._pubs[0].local_addr
            assert addr != nat.local_addr
            # and it remembers the witnessed mapping under the token,
            # consumable exactly once (punch routing relies on this)
            assert srv._witnessed(token) == addr
            assert srv._witnessed(token) is None
        finally:
            nat.close()
            await srv.shutdown()

    _run(run())


# --- end-to-end punch + fallback -----------------------------------------


async def _relay_pair(nat_kind_a, nat_kind_b):
    """Two P2P nodes registered on one relay, each behind its own NAT."""
    srv = RelayServer()
    port = await srv.start()
    a, b = P2P("sdx"), P2P("sdx")
    echoed = asyncio.Event()

    async def on_stream(stream):
        data = await stream.read_exact(7)
        await stream.write(data[::-1])
        echoed.set()

    ra = RelayClient(a, ("127.0.0.1", port), on_stream, query_interval=0.1,
                     udp_factory=lambda: NattedEndpoint(nat_kind_a))
    rb = RelayClient(b, ("127.0.0.1", port), on_stream, query_interval=0.1,
                     udp_factory=lambda: NattedEndpoint(nat_kind_b))
    await ra.start()
    await rb.start()
    for _ in range(100):
        if ra._ctrl is not None and rb._ctrl is not None and \
                ra._relay_udp and rb._relay_udp:
            break
        await asyncio.sleep(0.05)
    return srv, a, b, ra, rb, echoed


def test_punch_direct_path_between_cone_nats():
    """Both peers behind address-restricted cone NATs: the dial must
    come out DIRECT (no relay pipe, zero relayed bytes) and still be
    the same authenticated Noise channel."""

    async def run():
        srv, a, b, ra, rb, echoed = await _relay_pair("cone", "cone")
        try:
            stream = await ra.dial(b.identity.to_remote_identity(), timeout=20)
            assert getattr(stream, "direct", False) is True
            assert stream.remote_identity == b.identity.to_remote_identity()
            await stream.write(b"punched")
            assert await asyncio.wait_for(stream.read_exact(7), 10) \
                == b"dehcnup"
            await asyncio.wait_for(echoed.wait(), 5)
            # the relay never spliced a pipe and never moved a byte
            assert srv.stats.pipes_opened == 0
            assert srv.stats.bytes_relayed == 0
            await stream.close()
        finally:
            await ra.shutdown()
            await rb.shutdown()
            await srv.shutdown()

    _run(run())


def test_punch_falls_back_to_relay_on_symmetric_nat():
    """A symmetric NAT on one side defeats punching (per-destination
    mappings): the SAME dial call must succeed anyway via the relayed
    TCP pipe."""

    async def run():
        srv, a, b, ra, rb, echoed = await _relay_pair("cone", "symmetric")
        try:
            stream = await ra.dial(b.identity.to_remote_identity(), timeout=20)
            assert not getattr(stream, "direct", False)
            assert stream.remote_identity == b.identity.to_remote_identity()
            await stream.write(b"relayed")
            assert await asyncio.wait_for(stream.read_exact(7), 10) \
                == b"deyaler"
            await asyncio.wait_for(echoed.wait(), 5)
            assert srv.stats.pipes_opened == 1  # the fallback pipe
            assert srv.stats.bytes_relayed > 0
            await stream.close()
        finally:
            await ra.shutdown()
            await rb.shutdown()
            await srv.shutdown()

    _run(run())


def test_relay_rejects_unwitnessed_punch_addr():
    """The relay only routes addresses it observed itself: a punch
    carrying a token it never saw is refused, so a client cannot point
    a victim's probes at an arbitrary third party. (One-shot token
    consumption is pinned by test_observe_reports_nat_mapping.)"""

    async def run():
        from spacedrive_tpu_torch.p2p.relay import (
            _LISTEN_CONTEXT, read_frame, write_frame,
        )

        srv = RelayServer()
        port = await srv.start()

        async def register(ident: Identity):
            r, w = await asyncio.open_connection("127.0.0.1", port)
            write_frame(w, {"cmd": "listen",
                            "identity": str(ident.to_remote_identity()),
                            "meta": {}})
            await w.drain()
            ch = await read_frame(r)
            write_frame(w, {"sig": ident.sign(
                _LISTEN_CONTEXT + bytes.fromhex(ch["challenge"])).hex()})
            await w.drain()
            ok = await read_frame(r)
            assert ok.get("ok") and ok.get("udp_port")
            return r, w

        attacker, victim = Identity(), Identity()
        ar, aw = await register(attacker)
        _vr, _vw = await register(victim)
        try:
            write_frame(aw, {"cmd": "punch", "conn": "c1",
                             "target": str(victim.to_remote_identity()),
                             "token": "never-observed"})
            await aw.drain()
            resp = await asyncio.wait_for(read_frame(ar), 5)
            assert resp.get("event") == "punch_addr"
            assert resp.get("ok") is False
            assert "token" in resp.get("error", "")
        finally:
            aw.close()
            _vw.close()
            await srv.shutdown()

    _run(run())


def test_punch_disabled_uses_relay():
    async def run():
        srv, a, b, ra, rb, echoed = await _relay_pair("cone", "cone")
        ra._punch_enabled = False
        try:
            stream = await ra.dial(b.identity.to_remote_identity(), timeout=20)
            assert not getattr(stream, "direct", False)
            await stream.write(b"noshort")
            assert await asyncio.wait_for(stream.read_exact(7), 10) \
                == b"trohson"
            assert srv.stats.pipes_opened == 1
            await stream.close()
        finally:
            await ra.shutdown()
            await rb.shutdown()
            await srv.shutdown()

    _run(run())


def test_relay_rate_limits_punch_per_source():
    """One authenticated keypair spraying punch requests gets refused
    past the per-source window — the victim never sees the overflow
    (punch-accept work is ~5 s of socket spray per event, so unlimited
    routing is an availability DoS)."""

    async def run():
        from spacedrive_tpu_torch.p2p.relay import (
            _LISTEN_CONTEXT, RelayLimits, read_frame, write_frame,
        )

        srv = RelayServer(RelayLimits(punch_per_source_per_minute=3))
        port = await srv.start()

        async def register(ident: Identity):
            r, w = await asyncio.open_connection("127.0.0.1", port)
            write_frame(w, {"cmd": "listen",
                            "identity": str(ident.to_remote_identity()),
                            "meta": {}})
            await w.drain()
            ch = await read_frame(r)
            write_frame(w, {"sig": ident.sign(
                _LISTEN_CONTEXT + bytes.fromhex(ch["challenge"])).hex()})
            await w.drain()
            ok = await read_frame(r)
            assert ok.get("ok")
            return r, w

        attacker, victim = Identity(), Identity()
        ar, aw = await register(attacker)
        _vr, _vw = await register(victim)
        try:
            errors = []
            for i in range(5):
                write_frame(aw, {"cmd": "punch", "conn": f"c{i}",
                                 "target": str(victim.to_remote_identity()),
                                 "token": "never-observed"})
                await aw.drain()
                resp = await asyncio.wait_for(read_frame(ar), 5)
                assert resp.get("event") == "punch_addr"
                assert resp.get("ok") is False
                errors.append(resp.get("error", ""))
            # first 3 hit the (deliberately bogus) token check; the
            # 4th and 5th never get that far — rate limit fires first
            assert all("token" in e for e in errors[:3])
            assert all("rate limited" in e for e in errors[3:])
            assert srv.stats.punches_refused_rate == 2
        finally:
            aw.close()
            _vw.close()
            await srv.shutdown()

    _run(run())


def test_client_caps_concurrent_punch_accepts():
    """Inbound punch events beyond the concurrency cap / per-source
    window are dropped without binding sockets or spraying probes."""

    async def run():
        from spacedrive_tpu_torch.p2p.relay import (
            PUNCH_ACCEPT_MAX, PUNCH_ACCEPT_PER_SOURCE,
        )

        srv, a, b, ra, rb, echoed = await _relay_pair("cone", "cone")
        try:
            # saturate the concurrency gate: events must bounce at the
            # top of _punch_accept, before any endpoint is created
            rb._punch_active = PUNCH_ACCEPT_MAX
            made = []
            orig_make = rb._make_udp
            rb._make_udp = lambda: made.append(1) or orig_make()
            await rb._punch_accept({"conn": "x", "from": "spammer",
                                    "addr": ["127.0.0.1", 1]})
            assert rb.punch_stats["refused"] == 1
            assert made == []
            rb._punch_active = 0

            # per-source sliding window: burst from one identity bounces
            # after PUNCH_ACCEPT_PER_SOURCE entries
            import time as _time
            now = _time.monotonic()
            rb._punch_rate._times["spammer"] = [now] * PUNCH_ACCEPT_PER_SOURCE
            await rb._punch_accept({"conn": "y", "from": "spammer",
                                    "addr": ["127.0.0.1", 1]})
            assert rb.punch_stats["refused"] == 2
            assert made == []
        finally:
            await ra.shutdown()
            await rb.shutdown()
            await srv.shutdown()

    _run(run())


# --- mixed JAX and port clients -------------------------------------------------

PKG = {"jax": (j_identity, j_p2p, j_relay), "port": (p_identity, p_p2p, p_relay)}


@pytest.mark.parametrize("server,dialer,listener", [
    ("port", "jax", "port"), ("port", "port", "jax"), ("jax", "jax", "port"),
    ("jax", "port", "jax"),
])
def test_mixed_punched_stream(server, dialer, listener):
    """A JAX client and a port client behind cone NATs: the dial comes
    out direct (the relay splices nothing) and 256 KiB cross the punched
    UDP path each way under Noise."""

    async def run():
        srv = PKG[server][2].RelayServer()
        port = await srv.start()
        payload = os.urandom(256 * 1024)
        dialer_closed = asyncio.Event()

        async def on_stream(stream):
            data = await stream.read_exact(len(payload))
            await stream.write(data[::-1])
            # close after the dialer: a side whose close completes first
            # shuts its socket, and the other's FIN then waits out its 5 s
            await asyncio.wait_for(dialer_closed.wait(), 10)

        clients = []
        for pkg in (dialer, listener):
            _i, p2p_mod, relay_mod = PKG[pkg]
            p = p2p_mod.P2P("sdx")
            rc = relay_mod.RelayClient(p, ("127.0.0.1", port), on_stream, query_interval=0.1,
                                       udp_factory=lambda: NattedEndpoint("cone"))
            await rc.start()
            clients.append((p, rc))
        (a, ra), (b, rb) = clients
        try:
            for _ in range(100):
                if ra._ctrl and rb._ctrl and ra._relay_udp and rb._relay_udp:
                    break
                await asyncio.sleep(0.05)
            target = PKG[dialer][0].RemoteIdentity(b.remote_identity.to_bytes())
            stream = await ra.dial(target, timeout=20)
            assert getattr(stream, "direct", False) is True
            assert stream.remote_identity.to_bytes() == b.remote_identity.to_bytes()
            await stream.write(payload)
            assert await asyncio.wait_for(stream.read_exact(len(payload)), 20) == payload[::-1]
            assert srv.stats.pipes_opened == 0 and srv.stats.bytes_relayed == 0
            assert ra.punch_stats["direct"] == 1 and rb.punch_stats["accepted"] == 1
            await stream.close()
            dialer_closed.set()
        finally:
            await ra.shutdown()
            await rb.shutdown()
            await srv.shutdown()

    _run(run())
