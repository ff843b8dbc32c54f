"""The port's reliable UDP stream and its congestion controller against
the JAX package's.

- tests/test_udpstream_cc.py's cases pointed at
  `spacedrive_tpu_torch.p2p.udpstream`: integrity across a latency and
  loss grid, the receiver window's stall and resume, the stats surface,
  the received-run index, forged ACKs (a flood of ranges, an ACK beyond
  the flight), the unread accounting and the retained close task;
- in place of its two wall-clock A/B margins, `_RateSeekCC` driven in
  lockstep with JAX's on seeded scripts of RTT samples, deliveries,
  retransmissions and RTOs under one injected clock: the two states are
  equal at every step, the pinned 128-segment budget holds, and on a
  fluid model of a 50 ms path the dynamic budget moves more than 5x the
  pinned one's segments and scales with the path's capacity;
- the segments and ACKs of a port stream are JAX's bytes, and a port
  stream and a JAX stream carry data both ways over lossy sockets;
- the twin of tests/test_chaos.py's `p2p.write` faults.

Every case runs on 127.0.0.1 (or an in-process pipe) under its own
asyncio timeout.
"""

import asyncio
import os
import random
import time

import pytest

import spacedrive_tpu.p2p.udp as JUDP
import spacedrive_tpu.p2p.udpstream as JU
import spacedrive_tpu_torch.p2p.udpstream as PU
from spacedrive_tpu_torch.p2p.udp import UdpEndpoint
from spacedrive_tpu_torch.p2p.udpstream import (
    ACK, DATA, MSS, RECV_WINDOW, UdpStream, _HDR, _RWND,
)


def _run(coro, timeout: float = 90.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class WanPipe:
    """In-process UdpEndpoint lookalike: one-way latency + seeded
    random loss, datagrams delivered straight into the peer's receiver
    via loop timers. A real-socket sim tops out near 5k datagrams/s of
    *kernel* overhead on one event loop — the wire itself would be the
    bottleneck and every throughput assertion would measure the sim,
    not the protocol. (NAT/socket realism is covered by test_punch.py;
    these tests need a fast wire with exact latency/loss control.)"""

    _next_port = [1]

    def __init__(self, delay: float, loss: float, seed: int):
        self._delay = delay
        self._loss = loss
        self._rng = random.Random(seed)
        self._receiver = None
        self.peer: "WanPipe | None" = None
        self.local_addr = ("pipe", WanPipe._next_port[0])
        WanPipe._next_port[0] += 1
        self._closed = False

    async def bind(self, host: str = "", port: int = 0):
        return self.local_addr

    def set_receiver(self, receiver) -> None:
        self._receiver = receiver

    def sendto(self, data, addr) -> None:
        if self._closed or self._rng.random() < self._loss:
            return
        asyncio.get_running_loop().call_later(
            self._delay, self._deliver, bytes(data))

    def _deliver(self, data: bytes) -> None:
        peer = self.peer
        if peer is not None and not peer._closed \
                and peer._receiver is not None:
            peer._receiver(data, self.local_addr)

    def close(self) -> None:
        self._closed = True


def wan_pair(delay: float, loss: float, seed: int):
    a = WanPipe(delay, loss, seed)
    b = WanPipe(delay, loss, seed + 500)
    a.peer, b.peer = b, a
    return a, b


async def _consume(reader: asyncio.StreamReader, n: int) -> bytes:
    """Chunked consumer: drains the reader as data arrives (the shape
    every real consumer above this layer has — the Noise transport
    reads ~16 KiB records). A single readexactly(huge) would park all
    bytes unconsumed in the reader buffer and the advertised window
    would rightly close on it."""
    got = bytearray()
    while len(got) < n:
        chunk = await reader.read(min(1 << 16, n - len(got)))
        if not chunk:
            raise EOFError(f"stream ended at {len(got)}/{n}")
        got.extend(chunk)
    return bytes(got)


async def _timed_transfer(delay: float, loss: float, nbytes: int,
                          fixed_cwnd: int | None = None,
                          timeout: float = 120.0,
                          warmup_bytes: int = 0) -> float:
    """Seconds to move `nbytes` one way across the simulated link.
    `warmup_bytes` flow first on the same stream un-timed, so the
    figure is SUSTAINED throughput (the controller's discovery ramp is
    startup cost, not steady-state capacity)."""
    a, b = wan_pair(delay, loss, seed=fixed_cwnd or 0)
    addr_a = await a.bind()
    addr_b = await b.bind()
    sa, sb = UdpStream(a, addr_b), UdpStream(b, addr_a)
    if fixed_cwnd is not None:
        sa._cc.fixed_cwnd = fixed_cwnd
    loop = asyncio.get_running_loop()
    if warmup_bytes:
        sa.write(os.urandom(warmup_bytes))
        await asyncio.wait_for(_consume(sb.reader, warmup_bytes), timeout)
    payload = os.urandom(nbytes)
    t0 = loop.time()
    sa.write(payload)
    got = await asyncio.wait_for(_consume(sb.reader, nbytes), timeout)
    elapsed = loop.time() - t0
    assert got == payload
    sa.close()
    sb.close()
    await sa.wait_closed()
    return elapsed


@pytest.mark.parametrize("delay,loss", [
    (0.005, 0.0), (0.005, 0.03), (0.025, 0.02), (0.05, 0.01),
])
def test_cc_integrity_across_latency_loss_sweep(delay, loss):
    """Latency/loss grid: every byte arrives exactly once, in order,
    and well inside the no-progress teardown budget."""

    async def run():
        await _timed_transfer(delay, loss, 600_000, timeout=60)

    _run(run())


def test_receiver_window_stalls_and_resumes():
    """A receiver that stops reading must close the advertised window
    (sender buffering stays bounded near RECV_WINDOW segments), then
    window probes must reopen the stream when it drains."""

    async def run():
        a, b = UdpEndpoint(), UdpEndpoint()
        addr_a = await a.bind("127.0.0.1")
        addr_b = await b.bind("127.0.0.1")
        sa, sb = UdpStream(a, addr_b), UdpStream(b, addr_a)
        nbytes = (RECV_WINDOW + 2048) * MSS  # more than the window holds
        payload = os.urandom(nbytes)
        sa.write(payload)
        # nobody reads sb: the sender must stall on rwnd, not blast on
        for _ in range(200):
            await asyncio.sleep(0.05)
            if sa._peer_rwnd == 0 and sa._next_seq == sa._send_base:
                break
        in_flight_bytes = (sa._next_seq - sa._send_base) * MSS
        assert sa._peer_rwnd == 0, sa._peer_rwnd
        assert in_flight_bytes <= (RECV_WINDOW + 64) * MSS
        assert sa._pending_writes  # still queued, not dropped
        # drain the reader: probes must reopen the window and finish
        got = await asyncio.wait_for(_consume(sb.reader, nbytes), 60)
        assert got == payload
        sa.close()
        sb.close()
        await sa.wait_closed()

    _run(run())


def test_stats_surface_for_upper_layers():
    """Spaceblock/p2p.state read path telemetry via get_extra_info."""

    async def run():
        a, b = UdpEndpoint(), UdpEndpoint()
        addr_a = await a.bind("127.0.0.1")
        addr_b = await b.bind("127.0.0.1")
        sa, sb = UdpStream(a, addr_b), UdpStream(b, addr_a)
        sa.write(os.urandom(400_000))
        await asyncio.wait_for(sb.reader.readexactly(400_000), 30)
        stats = sa.get_extra_info("udpstream_stats")
        assert stats["delivered_segments"] >= 300
        assert stats["cwnd"] >= 8
        assert stats["srtt"] is None or stats["srtt"] > 0
        sa.close()
        sb.close()

    _run(run())


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_run_index_property_random_arrivals(seed):
    """The receiver's incremental run index must ALWAYS equal the
    disjoint sorted ranges of the buffered out-of-order seqs — under
    random arrival orders, duplicates, and in-order consumption (the
    SACK blocks sent to the peer are built from it)."""

    async def run():
        a, b = UdpEndpoint(), UdpEndpoint()
        addr_a = await a.bind("127.0.0.1")
        addr_b = await b.bind("127.0.0.1")
        sa, sb = UdpStream(a, addr_b), UdpStream(b, addr_a)

        def expected_runs():
            seqs = sorted(sb._reorder)
            runs = []
            for s in seqs:
                if runs and runs[-1][1] == s:
                    runs[-1][1] = s + 1
                else:
                    runs.append([s, s + 1])
            return runs

        rng = random.Random(seed)
        seqs = list(range(0, 120))
        # the shuffle interleaves in-order consumption (whenever the
        # prefix completes) with out-of-order buffering
        rng.shuffle(seqs)
        for i, seq in enumerate(seqs):
            # deliver straight into the receiver, like the wire would
            sb._on_datagram(_HDR.pack(DATA, seq, 0) + b"x", addr_a)
            if rng.random() < 0.2 and i > 0:  # duplicate an old seq
                dup = seqs[rng.randrange(0, i)]
                sb._on_datagram(_HDR.pack(DATA, dup, 0) + b"x", addr_a)
            assert sb._runs == expected_runs(), (i, seq)
        # everything delivered: fully consumed, no runs left
        assert sb._recv_next == 120
        assert sb._runs == [] and sb._reorder == {}
        sa.close()
        sb.close()
        a.close()
        b.close()

    _run(run())


def test_forged_ack_flood_is_bounded():
    """A spoofed 64 KB ACK packed with thousands of huge SACK ranges
    must cost bounded parse work (at most SACK_MAX ranges, each clamped
    to the LIVE flight — asserted non-trivial at forge time). Security
    posture (docs/transport.md): forgery is availability-only — at
    worst the stream tears down and the punched path falls back to the
    relay; on a clean link delivery still completes."""

    async def run():
        import struct as _struct

        a, b = UdpEndpoint(), UdpEndpoint()
        addr_a = await a.bind("127.0.0.1")
        addr_b = await b.bind("127.0.0.1")
        sa, sb = UdpStream(a, addr_b), UdpStream(b, addr_a)
        payload = os.urandom(400_000)
        sa.write(payload)
        # let the sender task fill the initial window but nothing ack:
        # the flood must hit a NON-TRIVIAL flight or the clamp property
        # is tested against an empty range
        for _ in range(8):
            await asyncio.sleep(0)
        assert sa._next_seq - sa._send_base >= 16, \
            (sa._next_seq, sa._send_base)
        # forge: correct source addr (the only pre-AEAD check), huge
        # ranges far beyond the flight, thousands of them
        evil = _HDR.pack(ACK, 0, 0) + _RWND.pack(4096)
        evil += b"".join(
            _struct.pack("!II", (i * 1_000_003) % (1 << 32), 0xFFFFFFFF)
            for i in range(8100)
        )[: 65_000]
        t0 = time.perf_counter()
        for _ in range(50):
            sa._on_datagram(evil, addr_b)
        cost = time.perf_counter() - t0
        assert cost < 1.0, f"50 forged ACKs cost {cost:.2f}s"
        got = await asyncio.wait_for(_consume(sb.reader, len(payload)), 30)
        assert got == payload
        sa.close()
        sb.close()

    _run(run())


def test_forged_ack_beyond_flight_is_dropped_whole():
    """ADVICE r5: an ACK acknowledging past _next_seq is corrupt or
    forged — processing it used to push _send_base beyond the flight,
    after which honest cumulative ACKs could never retire segments and
    the stream died at MAX_RETRIES. It must be ignored entirely, and
    the transfer must still complete afterwards."""

    async def run():
        a, b = UdpEndpoint(), UdpEndpoint()
        addr_a = await a.bind("127.0.0.1")
        addr_b = await b.bind("127.0.0.1")
        sa, sb = UdpStream(a, addr_b), UdpStream(b, addr_a)
        payload = os.urandom(200_000)
        sa.write(payload)
        for _ in range(8):
            await asyncio.sleep(0)
        assert sa._next_seq > 0
        base_before = sa._send_base
        # forged cumulative ack far beyond anything ever sent
        evil = _HDR.pack(ACK, 0, sa._next_seq + 50_000) + _RWND.pack(4096)
        sa._on_datagram(evil, addr_b)
        assert sa._send_base == base_before  # untouched
        assert sa._send_base <= sa._next_seq
        # sender state stayed coherent: delivery completes normally
        got = await asyncio.wait_for(_consume(sb.reader, len(payload)), 30)
        assert got == payload
        assert sa._send_base <= sa._next_seq
        sa.close()
        sb.close()

    _run(run())


def test_unread_accounting_without_private_buffer():
    """ADVICE r5: the receive-window credit used to reach into
    StreamReader._buffer (CPython-private) and advertised a PERMANENT
    zero window when the attr was absent — stalling transfers forever.
    The counting reader tracks fed-minus-read explicitly, and a
    foreign reader without the counter degrades to full credit
    (bounded-buffering loss, not a wedged stream)."""

    async def run():
        a, b = UdpEndpoint(), UdpEndpoint()
        addr_a = await a.bind("127.0.0.1")
        addr_b = await b.bind("127.0.0.1")
        sa, sb = UdpStream(a, addr_b), UdpStream(b, addr_a)
        # exact fed-minus-read across the read paths the transport uses
        sa.write(b"z" * 10_000)
        await asyncio.sleep(0.2)
        assert sb._unread() == 10_000
        await sb.reader.readexactly(4_000)
        assert sb._unread() == 6_000
        await sb.reader.read(6_000)
        assert sb._unread() == 0
        # full window credit available again — not a zero window
        assert sb._rwnd() > RECV_WINDOW // 2
        # read-all (n=-1) must not double-count: CPython's read(-1)
        # loops over read(limit) internally, and counting both the
        # blocks and the join would inflate bytes_read and pin
        # _unread() at 0 for the rest of the connection
        sa.write(b"w" * 5_000)
        await asyncio.sleep(0.2)
        assert sb._unread() == 5_000
        drain = asyncio.ensure_future(sb.reader.read(-1))
        await asyncio.sleep(0.05)
        sa.close()  # EOF lets read-all return
        got = await asyncio.wait_for(drain, 10)
        assert got == b"w" * 5_000
        assert sb.reader.bytes_read == 10_000 + 5_000  # not double-counted
        assert sb._unread() == 0
        # hostile case: a reader with NO _buffer and NO counter must
        # not advertise rwnd=0 forever (old behavior); it degrades to
        # full credit instead
        class OpaqueReader:
            def feed_data(self, data):
                pass

            def feed_eof(self):
                pass

        sb.reader = OpaqueReader()
        assert sb._unread() == 0
        assert sb._rwnd() > 0
        sa.close()
        sb.close()

    _run(run())


def test_close_task_retained_until_fin_settles():
    """Regression (sdlint SD003): `close()` used to fire-and-forget
    `_graceful_close` — with no reference held, the task could be
    GC-cancelled mid-FIN and the reliable-close handshake silently
    dropped. The handle must be retained and run to completion."""

    async def run():
        a, b = wan_pair(0.001, 0.0, seed=11)
        addr_a = await a.bind()
        addr_b = await b.bind()
        sa, sb = UdpStream(a, addr_b), UdpStream(b, addr_a)
        payload = os.urandom(50_000)
        sa.write(payload)
        got = await asyncio.wait_for(_consume(sb.reader, len(payload)), 30)
        assert got == payload
        sa.close()
        assert sa._close_task is not None  # handle retained
        await asyncio.wait_for(sa.wait_closed(), 10)
        await asyncio.wait_for(sa._close_task, 10)  # ran to completion
        assert sa._close_task.done()
        sb.close()
        await asyncio.wait_for(sb.wait_closed(), 10)

    _run(run())


# --- _RateSeekCC in lockstep with JAX's ------------------------------------------


class _Clock:
    """The `time` both udpstream modules read, advanced by the script."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(JU, "time", c)
    monkeypatch.setattr(PU, "time", c)
    return c


def _state(cc) -> tuple:
    return (cc.cwnd, cc.rtt_min, cc.srtt, cc.delivered, cc.retransmitted, list(cc._bw_window),
            cc._round_start_time, cc._round_start_delivered, cc._round_start_retx,
            cc._rounds_since_probe, cc._slow_samples, cc._cwnd_scale, cc.fixed_cwnd,
            cc.budget(), cc.pacing_rate())


class _Lockstep:
    """One JAX and one port controller fed the same calls, their states
    compared after every one."""

    def __init__(self, fixed: int | None = None):
        self.j, self.p = JU._RateSeekCC(), PU._RateSeekCC()
        self.j.fixed_cwnd = self.p.fixed_cwnd = fixed
        self.steps = 0
        self.check()

    def check(self):
        assert _state(self.p) == _state(self.j), self.steps
        self.steps += 1

    def rtt(self, rtt: float):
        for cc in (self.j, self.p):
            cc.on_rtt_sample(rtt)
            cc.srtt = rtt if cc.srtt is None else 0.875 * cc.srtt + 0.125 * rtt
        self.check()

    def deliver(self, n: int, retx: int, in_flight: int):
        for cc in (self.j, self.p):
            cc.retransmitted += retx
            cc.on_delivered(n, in_flight)
        self.check()

    def rto(self, consecutive: int):
        for cc in (self.j, self.p):
            cc.on_rto(consecutive)
        self.check()

    def budget(self) -> int:
        return self.p.budget()


def _fluid(cc: _Lockstep, clock: _Clock, rng, capacity: float, rtt: float, loss: float,
           rounds: int) -> int:
    """A fluid path: each round of `rtt` seconds delivers min(budget,
    capacity x rtt) segments in 8 ACKs, `loss` of them retransmitted.
    Returns the segments delivered."""
    total = 0
    for _ in range(rounds):
        n = min(cc.budget(), int(capacity * rtt))
        for k in range(8):
            clock.t += rtt / 8
            part = n // 8 + (1 if k < n % 8 else 0)
            retx = sum(rng.random() < loss for _ in range(part))
            cc.rtt(rtt * (1 + 0.2 * rng.random()))
            cc.deliver(part, retx, n - part)
        total += n
    return total


@pytest.mark.parametrize("seed", range(6))
def test_rate_seek_cc_equals_jax_on_seeded_scripts(clock, seed):
    """Random mixes of RTT samples (1-200 ms), deliveries at every clock
    gap, retransmission bursts past the backoff threshold and runs of
    RTOs, pinned and dynamic budgets."""
    rng = random.Random(seed)
    cc = _Lockstep(fixed=128 if seed % 3 == 2 else None)
    consecutive = 0
    for _ in range(3000):
        r = rng.random()
        if r < 0.3:
            cc.rtt(rng.uniform(0.001, 0.2))
        elif r < 0.93:
            clock.t += rng.choice((0.0005, 0.005, 0.02, 0.05, 0.12))
            n = rng.randint(1, 400)
            retx = rng.randint(0, n // 4) if rng.random() < 0.1 else 0
            cc.deliver(n, retx, rng.randint(0, 4096))
            consecutive = 0
        else:
            consecutive += 1
            cc.rto(consecutive)
        if cc.j.fixed_cwnd is not None:
            assert cc.budget() == 128
    assert cc.steps > 3000


def test_rate_seek_cc_beats_fixed_window_on_a_fluid_wan(clock):
    """The A/B of tests/test_udpstream_cc.py without its wall clock: on
    a 50 ms path of 20,000 segments/s with 1% loss, the dynamic budget
    moves more than 5x the segments the pinned 128-segment window does
    over 80 rounds, both controllers equal to JAX's at every step."""
    dyn = _fluid(_Lockstep(), clock, random.Random(1), 20_000, 0.05, 0.01, 80)
    fixed = _fluid(_Lockstep(fixed=128), clock, random.Random(1), 20_000, 0.05, 0.01, 80)
    assert fixed == 80 * 128
    assert dyn > 5 * fixed, (dyn, fixed)


def test_rate_seek_cc_budget_scales_with_capacity(clock):
    """The window sweep without a clock: the converged budget follows
    the path's capacity (not the old 128-segment cap), and never passes
    MAX_CWND."""
    budgets = {}
    for capacity in (2_000, 8_000, 32_000, 200_000):
        cc = _Lockstep()
        _fluid(cc, clock, random.Random(capacity), capacity, 0.05, 0.0, 60)
        budgets[capacity] = cc.budget()
    bdp = {c: c * 0.05 for c in budgets}
    for c in (2_000, 8_000, 32_000):
        assert 2 * bdp[c] <= budgets[c] <= 4 * bdp[c] + 64, budgets
    assert budgets[2_000] > 128, budgets
    assert budgets[2_000] < budgets[8_000] < budgets[32_000] < budgets[200_000], budgets
    assert budgets[200_000] == PU.MAX_CWND, budgets


def test_udpstream_constants_equal_jax():
    names = ("MSS", "RTO_INITIAL", "RTO_MAX", "MAX_RETRIES", "SACK_MAX", "FAST_RETX_BURST",
             "INIT_CWND", "MIN_CWND", "MAX_CWND", "RECV_WINDOW", "ACK_EVERY", "DELAYED_ACK",
             "PACE_BURST", "BW_ROUNDS", "PROBE_EVERY", "DATA", "ACK", "FIN", "WPROBE")
    assert [getattr(PU, n) for n in names] == [getattr(JU, n) for n in names]


# --- segments and ACKs against JAX; mixed streams ---------------------------------


class _Recorder:
    """An endpoint that keeps every datagram and delivers none."""

    local_addr = ("127.0.0.1", 1)

    def __init__(self):
        self.sent = []

    def set_receiver(self, cb):
        self.cb = cb

    def sendto(self, data, addr):
        self.sent.append(bytes(data))

    def close(self):
        pass


def test_segments_and_acks_equal_jax():
    """The first flight of a 200 KB write, and the ACKs (windows and
    SACK ranges) a receiver sends for one seeded out-of-order arrival of
    it, FIN included, are JAX's datagrams."""

    async def run():
        payload = random.Random(5).randbytes(200_000)
        flights, acks = {}, {}
        for name, mod in (("jax", JU), ("port", PU)):
            ep = _Recorder()
            s = mod.UdpStream(ep, ("127.0.0.1", 9))
            s.write(payload)
            for _ in range(8):
                await asyncio.sleep(0)
            flights[name] = ep.sent
            s._fail(mod.UdpStreamError("done"))
        assert flights["port"] == flights["jax"] and len(flights["jax"]) >= 32
        datagrams = flights["jax"] + [JU._HDR.pack(JU.FIN, len(flights["jax"]), 0)]
        order = list(range(len(datagrams)))
        random.Random(7).shuffle(order)
        for name, mod in (("jax", JU), ("port", PU)):
            ep = _Recorder()
            r = mod.UdpStream(ep, ("127.0.0.1", 9))
            for i in order + order[:5]:  # and a few duplicates
                r._on_datagram(datagrams[i], ("127.0.0.1", 9))
            await asyncio.sleep(0.05)  # the delayed ACK's timer
            acks[name] = ep.sent
            assert await r.reader.read() == payload[:len(flights["jax"]) * MSS]
            r._fail(mod.UdpStreamError("done"))
        assert acks["port"] == acks["jax"] and acks["jax"]

    _run(run())


class _Lossy(UdpEndpoint):
    """Drops every `drop_every`-th datagram while `lossy` holds."""

    def __init__(self, drop_every: int):
        super().__init__()
        self._n, self._drop_every, self.lossy = 0, drop_every, True

    def sendto(self, data, addr):
        self._n += 1
        if not self.lossy or self._n % self._drop_every:
            super().sendto(data, addr)


@pytest.mark.parametrize("a_pkg,b_pkg", [("jax", "port"), ("port", "jax")])
def test_mixed_streams_over_lossy_sockets(a_pkg, b_pkg):
    """A port stream and a JAX stream on real sockets that drop every
    7th datagram each way carry 300 KB both ways; then both close at
    once on a clean path (a side whose close completes first shuts its
    socket, so a later FIN would wait out its 5 s), each reading the
    other's FIN as EOF."""
    mods = {"jax": JU, "port": PU}

    async def run():
        a, b = _Lossy(7), _Lossy(7)
        addr_a, addr_b = await a.bind("127.0.0.1"), await b.bind("127.0.0.1")
        sa, sb = mods[a_pkg].UdpStream(a, addr_b), mods[b_pkg].UdpStream(b, addr_a)
        payload = os.urandom(300_000)
        sa.write(payload)
        sb.write(payload[::-1])
        assert await _consume(sb.reader, len(payload)) == payload
        assert await _consume(sa.reader, len(payload)) == payload[::-1]
        assert sa._cc.retransmitted and sb._cc.retransmitted
        a.lossy = b.lossy = False
        sa.close()
        sb.close()
        await asyncio.wait_for(asyncio.gather(sa.wait_closed(), sb.wait_closed()), 3)
        assert await sa.reader.read() == b"" and await sb.reader.read() == b""

    _run(run())


# --- tests/test_chaos.py's p2p.write twin -----------------------------------------


def test_udpstream_write_faults():
    from spacedrive_tpu_torch.telemetry.events import ring
    from spacedrive_tpu_torch.utils import faults

    async def run():
        # reset: write raises, stream fails, reader poisoned
        ep = _Recorder()
        s = UdpStream(ep, ("127.0.0.1", 9))
        with faults.active(faults.FaultPlan.parse("p2p.write:reset:times=1")):
            with pytest.raises(PU.UdpStreamError):
                s.write(b"hello" * 1000)
        with pytest.raises(PU.UdpStreamError):
            await s.reader.read(1)
        assert [e for e in ring("p2p").snapshot() if e["type"] == "stream_failed"]

        # partial: one MSS-sized segment hits the wire, then the stream dies
        ep2 = _Recorder()
        s2 = UdpStream(ep2, ("127.0.0.1", 9))
        with faults.active(faults.FaultPlan.parse("p2p.write:partial:times=1")):
            with pytest.raises(PU.UdpStreamError):
                s2.write(b"x" * 100_000)
        await asyncio.sleep(0.01)
        data_grams = [d for d in ep2.sent if _HDR.unpack_from(d)[0] == DATA]
        assert len(data_grams) == 1
        assert len(data_grams[0]) == _HDR.size + MSS
        assert not s2._pending_writes

    _run(run())
