"""Reliable ordered byte stream over UDP — the punched-path transport.

Parity: the reference's direct WAN paths are QUIC streams over punched
UDP (ref:crates/p2p2/src/quic/transport.rs:212,344). A full QUIC is out
of scope; this is an ARQ with QUIC-class dynamics so bulk Spacedrop
over a punched WAN path is no longer window-capped:

- segments of ≤``MSS`` bytes, 9-byte header ``!BII`` (type, seq, ack)
  — DATA / ACK / FIN / WPROBE;
- ACKs carry a cumulative ack, a **receiver-advertised window** (free
  reassembly+reader buffer, in segments) and up to ``SACK_MAX`` SACK
  ranges from the reorder buffer, so one lost segment never blocks
  the rest of a large flight (selective repeat, not go-back-N);
- a **rate-seeking congestion controller** (`_RateSeekCC`, BBR-
  flavoured) sets the in-flight budget and a token-bucket pacer
  spaces transmissions at 1.25× the measured delivery rate.
  Loss-halving AIMD collapses to ~sqrt(1/p) segments under the 1-2%
  *random* loss real WAN paths show — below even the old fixed
  window — so decrease keys on what congestion actually looks like:
  mass per-round retransmission, repeated RTOs, and delivery-rate
  plateaus (see the class docstring);
- per-ACK fast retransmit of SACK holes (rate-limited per RTT), RTO
  backstop with exponential backoff, give-up after ``MAX_RETRIES``
  (the punched path then falls back to the relay);
- zero-window persist probes (WPROBE) so a receiver that stalls and
  then drains its buffer reopens the stream without waiting for RTO;
- in-order reassembly into an ``asyncio.StreamReader`` + a writer
  facade, so `transport._client_handshake`/`_server_handshake` and
  `EncryptedStream` run over a punched UDP path UNCHANGED — same
  Noise XX, same identity binding, same record framing, just a
  different byte carrier (docs/security.md's argument carries over).

The security posture does not rest on this layer: every byte above it
is AEAD-protected and an attacker who forges/reorders segments can only
cause decrypt failures (= connection teardown), same as TCP injection.

Scope notes: sequence numbers are 32-bit (a single stream tops out at
~4.9 TB — far beyond any Spacedrop session; streams are per-transfer).

Counterpart of `spacedrive_tpu/p2p/udpstream.py`: the same segments
and ACKs, the same congestion controller step for step, the `sd_udp_*`
metrics, the `p2p` event ring and the `p2p.write` fault point.
"""

from __future__ import annotations

import asyncio
import struct
import time
from collections import deque
from typing import Any

from ..telemetry import metrics as _tm
from ..telemetry.events import P2P_EVENTS
from .udp import UdpEndpoint

_HDR = struct.Struct("!BII")
_RWND = struct.Struct("!I")
_RANGE = struct.Struct("!II")
DATA, ACK, FIN, WPROBE = 1, 2, 3, 4
MSS = 1150          # fits the 1280-byte IPv6 minimum MTU with headroom
RTO_INITIAL = 0.25
RTO_MAX = 2.0
MAX_RETRIES = 8
SACK_MAX = 3        # ranges per ACK
FAST_RETX_BURST = 16  # SACK holes re-sent per ACK, at most once per RTT each

INIT_CWND = 32
MIN_CWND = 4
MAX_CWND = 4096     # segments (~4.7 MB in flight) — the safety ceiling
RECV_WINDOW = 4096  # segments of reassembly + unread-reader budget
ACK_EVERY = 8       # in-order segments per cumulative ACK (delayed-ack)
DELAYED_ACK = 0.02  # partial-batch ACK latency bound
PACE_BURST = 64     # segments per pacing quantum — an un-paced flight
# of thousands of datagrams overflows socket buffers (kernel OR far-end
# queue) in one loop iteration, self-inflicting tail-drop the loss
# recovery then has to crawl out of; QUIC paces for the same reason
BW_ROUNDS = 8       # delivery-rate max-filter length (rounds ≈ RTTs)
PROBE_EVERY = 4     # plateau rounds between gentle re-probe rounds


class UdpStreamError(ConnectionError):
    pass


class _CountingReader(asyncio.StreamReader):
    """StreamReader that counts consumed bytes, so the receive-window
    credit never depends on the CPython-private ``_buffer`` attribute
    (whose absence used to advertise a permanent zero window —
    ADVICE r5). Fed bytes are counted by the stream itself at its
    feed_data call sites (per-segment hot path: no extra Python frame
    here); this class counts only the cold per-read side
    (read/readexactly/readuntil/readline)."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes_read = 0

    def _count(self, data) -> None:
        self.bytes_read += len(data)

    async def read(self, n: int = -1) -> bytes:
        if n < 0:
            # CPython implements read-all as a loop over
            # self.read(self._limit) — those inner calls re-enter this
            # override and count every block, so counting the joined
            # result too would double bytes_read and silently disable
            # flow control for the rest of the connection
            return await super().read(n)
        data = await super().read(n)
        self._count(data)
        return data

    async def readexactly(self, n: int) -> bytes:
        try:
            data = await super().readexactly(n)
        except asyncio.IncompleteReadError as e:
            self._count(e.partial)
            raise
        self._count(data)
        return data

    async def readuntil(self, separator: bytes = b"\n") -> bytes:
        # readline() delegates here via self, so this single override
        # covers both without double counting
        try:
            data = await super().readuntil(separator)
        except asyncio.IncompleteReadError as e:
            self._count(e.partial)  # EOF consumed the partial tail
            raise
        self._count(data)
        return data


class _RateSeekCC:
    """Bandwidth-seeking congestion controller (BBR-flavoured).

    The budget (cwnd) doubles each round while the measured delivery
    rate still grows — random 1–2% WAN loss cannot stop the climb the
    way it collapses loss-halving AIMD (whose equilibrium ~sqrt(1/p)
    segments sits BELOW the old fixed window). Congestion is detected
    as what it actually looks like:

    - the *loss rate* over a round exceeding LOSS_DECREASE (a path in
      collapse drops far more than the random-loss regime) → ×0.7;
    - repeated RTOs (a real stall) → relearn from INIT_CWND;
    - a delivery-rate plateau → growth stops (with a gentle ×1.25
      re-probe every PROBE_EVERY rounds to rediscover capacity).

    The budget never falls below 2×BDP (windowed-max delivery rate ×
    smoothed RTT), so ACK-clock jitter can't starve a healthy path.
    Rounds are delimited by delivery catching up with the flight that
    was outstanding at the previous round edge (≈ one ACK-clock RTT).
    """

    INIT_RATE = 4_000.0  # segs/s pacing floor before a bandwidth sample
    # pacing gain over the measured rate: 2× while delivery is still
    # climbing (the headroom each sample needs to exceed the last —
    # discovery at ×2/sample reaches any capacity in log time), a
    # gentle 1.25× once it plateaus
    GAIN_GROW = 2.0
    GAIN_STEADY = 1.25
    GROWTH = 1.15        # sample-over-sample delivery growth that counts
    LOSS_DECREASE = 0.10  # per-sample retransmit fraction → back off

    def __init__(self) -> None:
        self.cwnd = float(INIT_CWND)
        self.rtt_min: float | None = None
        self.srtt: float | None = None  # fed by the stream's estimator
        self.delivered = 0              # total segments delivered
        self.retransmitted = 0          # total retransmissions (stream-fed)
        self._bw_window: deque[float] = deque(maxlen=BW_ROUNDS)
        self._round_start_time = time.monotonic()
        self._round_start_delivered = 0
        self._round_start_retx = 0
        self._rounds_since_probe = 0
        self._slow_samples = 0  # consecutive non-growing rate samples
        self._cwnd_scale = 1.0  # loss-event backoff multiplier
        # test seam: pin the budget (A/B vs the fixed-window design)
        self.fixed_cwnd: int | None = None

    def _srtt_eff(self) -> float:
        """RTT for the BDP: the SMOOTHED estimate (floored), not the
        minimum — on low-RTT paths scheduling jitter and delayed ACKs
        dominate rtt_min, and a BDP computed from a 0.1 ms minimum
        would starve the pipe between ACK batches."""
        return max(self.srtt or 0.0, self.rtt_min or 0.0, 0.005)

    def pacing_rate(self) -> float:
        """Segments/s to feed the wire: 1.25× the windowed-max measured
        delivery rate. Pacing at the *delivered* rate — not cwnd/RTT —
        is what keeps a flight from overflowing the path's (or
        kernel's) buffers on ANY RTT; the 1.25 headroom is what lets
        the next round's measurement exceed the last."""
        if self.fixed_cwnd is not None:
            # pinned-budget mode: the window must be the binding
            # constraint; pacing only smooths (1.25× headroom)
            return 1.25 * self.fixed_cwnd / self._srtt_eff()
        if not self._bw_window:
            return self.INIT_RATE
        gain = self.GAIN_GROW if self._slow_samples < 2 else self.GAIN_STEADY
        return max(gain * max(self._bw_window), self.INIT_RATE)

    def on_rtt_sample(self, rtt: float) -> None:
        if rtt > 0 and (self.rtt_min is None or rtt < self.rtt_min):
            self.rtt_min = rtt

    def on_delivered(self, n: int, in_flight: int) -> None:
        """n segments newly cum-acked or SACKed. Rate sampling is
        TIME-based — one sample per ~RTT of wall clock — not flight-
        drain based: when the budget briefly overshoots the achievable
        rate the flight balloons, and a drain-defined "round" would
        stretch to many RTTs, throttling the very feedback loop that
        corrects the overshoot. (`in_flight` is unused but kept: it is
        the natural hook for a future inflight-vs-BDP drain signal.)"""
        self.delivered += n
        now = time.monotonic()
        dt = now - self._round_start_time
        # clamp the interval to 100 ms: a queue-inflated srtt would
        # slow the very feedback that corrects the queue
        if dt < min(max(self._srtt_eff(), 0.02), 0.1):
            return
        round_delivered = self.delivered - self._round_start_delivered
        round_retx = self.retransmitted - self._round_start_retx
        self._round_start_time = now
        self._round_start_delivered = self.delivered
        self._round_start_retx = self.retransmitted
        bw = round_delivered / dt  # segs/s
        prev_max = max(self._bw_window) if self._bw_window else 0.0
        self._bw_window.append(bw)
        self._advance(bw, prev_max, round_retx / max(1, round_delivered))

    def _advance(self, bw: float, prev_max: float,
                 loss_rate: float) -> None:
        if self.fixed_cwnd is not None:
            self.cwnd = float(self.fixed_cwnd)
            return
        self._rounds_since_probe += 1
        if loss_rate > self.LOSS_DECREASE:
            # a collapsing path shows mass retransmission, far above
            # the random-loss regime the growth rule tolerates
            self._cwnd_scale = max(0.5, self._cwnd_scale * 0.7)
            self._slow_samples += 1
        elif bw >= self.GROWTH * prev_max:
            # delivery still climbing (compared against the windowed
            # max, so a stale early peak can't freeze growth forever)
            self._slow_samples = 0
            self._cwnd_scale = min(1.0, self._cwnd_scale + 0.1)
        else:
            self._slow_samples += 1
            if self._rounds_since_probe >= PROBE_EVERY:
                self._rounds_since_probe = 0
                self._slow_samples = 1  # probe sample: re-allow growth
            self._cwnd_scale = min(1.0, self._cwnd_scale + 0.1)
        # the budget is DERIVED, not walked: N×BDP against the MINIMUM
        # RTT (srtt includes self-made queue — sizing the flight by it
        # is how standing queues, 6× RTT inflation, and repair latency
        # spirals happen) + headroom so low-RTT paths survive ACK-batch
        # scheduling jitter. While discovering, the multiple is 4: on a
        # lossy path SACK-held repairs stretch the effective RTT past
        # 2× the minimum, and a 2×BDP flight would window-limit
        # delivery below the growth threshold — freezing discovery.
        rtt_floor = max(self.rtt_min or 0.05, 0.001)
        mult = 4 if self._slow_samples < 2 else 2
        bdp = mult * max(self._bw_window) * rtt_floor + 64
        self.cwnd = max(MIN_CWND, min(self._cwnd_scale * bdp, MAX_CWND))

    def on_rto(self, consecutive: int) -> None:
        """Timeout reaction in two stages: a single RTO (often ACK-path
        jitter) halves the budget; repeated ones mean a real stall —
        relearn the path from scratch."""
        if self.fixed_cwnd is not None:
            return
        if consecutive < 2:
            self.cwnd = max(self.cwnd / 2, float(INIT_CWND))
            return
        self.cwnd = float(INIT_CWND)
        self._bw_window.clear()

    def budget(self) -> int:
        if self.fixed_cwnd is not None:
            return self.fixed_cwnd
        return int(self.cwnd)


class UdpStream:
    """One reliable bidirectional stream bound to (endpoint, remote).

    Exposes ``reader`` (a real asyncio.StreamReader) and itself as the
    writer facade (``write``/``drain``/``close``/``wait_closed``/
    ``get_extra_info``) — the exact surface the Noise transport uses.
    """

    def __init__(self, endpoint: UdpEndpoint, remote: tuple[str, int],
                 *, owns_endpoint: bool = True):
        self._ep = endpoint
        self.remote = tuple(remote)
        self._owns = owns_endpoint
        self.reader = _CountingReader()
        self._fed_bytes = 0  # bytes handed to the reader (credit side)
        # sender state
        self._next_seq = 0
        # seq → [dgram, first_tx, last_tx, retx_count]
        self._unacked: dict[int, list] = {}
        self._sacked: set[int] = set()
        self._send_base = 0
        self._window_free = asyncio.Event()
        self._window_free.set()
        self._retries = 0
        self._rto = RTO_INITIAL
        self._srtt: float | None = None
        self._rttvar = 0.0
        self._rtt_probe: tuple[int, float] | None = None  # (seq, sent_at)
        self._timer: asyncio.TimerHandle | None = None
        self._cc = _RateSeekCC()
        self._peer_rwnd = RECV_WINDOW
        self._probe_timer: asyncio.TimerHandle | None = None
        self._probe_ivl = RTO_INITIAL
        # receiver state
        self._recv_next = 0
        self._reorder: dict[int, tuple[int, bytes]] = {}  # seq → (type, payload)
        # received-run index over _reorder: disjoint sorted [start, end)
        # pairs, maintained incrementally (len = holes+1, usually tiny)
        # so SACK construction never sorts the reorder buffer
        self._runs: list[list[int]] = []
        self._ack_pending = 0
        self._ack_timer: asyncio.TimerHandle | None = None
        self._fin_sent = False
        self._fin_acked = asyncio.Event()
        self._closed = False
        self._pending_writes: deque[bytes] = deque()
        self._sender_task: asyncio.Task | None = None
        # close() fires _graceful_close in the background; the handle is
        # retained so the task can't be GC-cancelled mid-FIN (sdlint SD003)
        self._close_task: asyncio.Task | None = None
        self._loop = asyncio.get_running_loop()
        endpoint.set_receiver(self._on_datagram)

    # --- receiver ------------------------------------------------------

    def _unread(self) -> int:
        """Bytes fed to the reader but not yet consumed by the app —
        tracked explicitly (our feed counter minus the reader's read
        counter), never via the CPython-private _buffer attribute. A
        foreign reader without the counter degrades to FULL credit
        (correctness over flow control, the pre-rewrite behavior)
        instead of the permanent zero window the old fallback
        advertised (ADVICE r5)."""
        consumed = getattr(self.reader, "bytes_read", None)
        if consumed is None:
            return 0
        return max(0, self._fed_bytes - consumed)

    def _rwnd(self) -> int:
        """Segments of credit: reassembly slots not taken by the
        reorder buffer or by unread reader bytes."""
        used = len(self._reorder) + self._unread() // MSS
        return max(0, RECV_WINDOW - used)

    def _runs_add(self, seq: int) -> bool:
        """Insert `seq` into the run index; True if it STARTED a new
        run (a fresh loss signal — worth an immediate dup-ACK)."""
        rs = self._runs
        for i, r in enumerate(rs):  # linear: len(rs) = holes+1, tiny
            if seq < r[0] - 1:
                rs.insert(i, [seq, seq + 1])
                return True
            if seq == r[0] - 1:
                r[0] = seq
                return False
            if r[0] <= seq < r[1]:
                return False  # duplicate
            if seq == r[1]:
                r[1] = seq + 1
                if i + 1 < len(rs) and rs[i + 1][0] == r[1]:
                    r[1] = rs[i + 1][1]
                    rs.pop(i + 1)
                return False
        rs.append([seq, seq + 1])
        return True

    def _runs_trim(self) -> None:
        """Drop runs consumed by the in-order frontier."""
        rs = self._runs
        while rs and rs[0][1] <= self._recv_next:
            rs.pop(0)
        if rs and rs[0][0] < self._recv_next:
            rs[0][0] = self._recv_next

    def _send_ack(self) -> None:
        parts = [_HDR.pack(ACK, 0, self._recv_next),
                 _RWND.pack(self._rwnd())]
        for a, b in self._runs[:SACK_MAX]:
            parts.append(_RANGE.pack(a, b))
        self._ep.sendto(b"".join(parts), self.remote)

    def _on_datagram(self, data: bytes, addr: tuple[str, int]) -> None:
        if tuple(addr) != self.remote or len(data) < _HDR.size:
            return  # stray traffic on the punched socket
        typ, seq, ack = _HDR.unpack_from(data)
        payload = data[_HDR.size:]
        if typ == ACK:
            self._on_ack(ack, payload)
            return
        if typ == WPROBE:
            self._ack_now()  # fresh window advertisement
            return
        if typ not in (DATA, FIN):
            return
        duplicate = seq < self._recv_next
        fin_seen = False
        new_run = False
        # the in-order segment is ALWAYS accepted — if only out-of-order
        # segments could fill a capped buffer, a hostile peer that
        # stuffed the reorder buffer would wedge the stream permanently
        if seq == self._recv_next:
            # fast path: no reorder/run bookkeeping for in-order data
            # (and no new_run, or every clean segment would defeat the
            # delayed-ACK batching below)
            self._recv_next += 1
            if typ == FIN:
                fin_seen = True
                self.reader.feed_eof()
            elif payload:
                self._fed_bytes += len(payload)
                self.reader.feed_data(payload)
            while self._recv_next in self._reorder:
                t, p = self._reorder.pop(self._recv_next)
                self._recv_next += 1
                if t == FIN:
                    fin_seen = True
                    self.reader.feed_eof()
                elif p:
                    self._fed_bytes += len(p)
                    self.reader.feed_data(p)
            self._runs_trim()
        elif seq > self._recv_next and len(self._reorder) < 2 * RECV_WINDOW:
            if seq not in self._reorder:
                self._reorder[seq] = (typ, payload)
                new_run = self._runs_add(seq)
        # delayed cumulative ACKs: every ACK_EVERY in-order segments, or
        # within DELAYED_ACK. Immediate ACKs where the sender's clock
        # depends on them: duplicates (its ACK was lost), a NEW hole
        # (fast retransmit), FIN (close latency). While holes exist,
        # decimate to every 4th — per-segment dup-ACK storms were the
        # top line of the transfer profile — the 20 ms timer still
        # bounds repair latency.
        if duplicate or fin_seen or new_run:
            self._ack_now()
        else:
            self._ack_pending += 1
            if self._ack_pending >= (4 if self._runs else ACK_EVERY):
                self._ack_now()
            elif self._ack_timer is None:
                self._ack_timer = self._loop.call_later(
                    DELAYED_ACK, self._ack_now)

    def _ack_now(self) -> None:
        self._ack_pending = 0
        if self._ack_timer is not None:
            self._ack_timer.cancel()
            self._ack_timer = None
        if not self._closed:
            self._send_ack()

    # --- ACK processing ------------------------------------------------

    def _on_ack(self, ack: int, payload: bytes) -> None:
        now = time.monotonic()
        if ack > self._next_seq:
            # a corrupt/forged ACK beyond the flight would desync
            # _send_base forever (cumulative ACKs could never retire
            # segments again) — drop it whole; an honest peer cannot
            # ack what was never sent (ADVICE r5)
            _tm.UDP_BAD_ACKS.inc()
            P2P_EVENTS.emit("bad_ack", remote=str(self.remote), ack=ack)
            return
        if len(payload) >= _RWND.size:
            self._peer_rwnd = _RWND.unpack_from(payload)[0]
            if self._peer_rwnd > 0:
                self._cancel_probe()
        delivered = 0
        rtt_sample: float | None = None
        # seqs are contiguous from send_base, so the cum-acked region is
        # a range — O(newly acked), not O(outstanding), per ACK
        for seq in range(self._send_base, min(ack, self._next_seq)):
            entry = self._unacked.pop(seq, None)
            if entry is None:
                continue
            if seq not in self._sacked:
                delivered += 1
            self._sacked.discard(seq)
            # one timed segment per RTT (RFC 6298 discipline): batch
            # ACKs after hole repair would otherwise feed the ages of
            # long-parked segments into srtt. Karn: a probe that got
            # retransmitted is discarded, never sampled.
            if self._rtt_probe is not None and seq == self._rtt_probe[0]:
                if entry[3] == 0:
                    rtt_sample = now - self._rtt_probe[1]
                self._rtt_probe = None
        if ack > self._send_base:
            self._send_base = min(ack, self._next_seq)
            self._retries = 0
            self._rto_backoff_reset()
        # SACK ranges; the gaps BETWEEN them are the peer's exact hole
        # list, so retransmission never scans the whole flight. Hostile-
        # input bounds: at most SACK_MAX ranges are parsed (honest peers
        # never send more) and every range is clamped to the live
        # [send_base, next_seq) flight — a forged 64 KB ACK packed with
        # huge ranges must not buy millions of loop iterations.
        off = _RWND.size
        holes: list[int] = []
        prev_end = max(ack, self._send_base)
        ranges_seen = 0
        while off + _RANGE.size <= len(payload) and ranges_seen < SACK_MAX:
            a, b = _RANGE.unpack_from(payload, off)
            off += _RANGE.size
            ranges_seen += 1
            a = max(a, self._send_base)
            b = min(b, self._next_seq)
            for seq in range(a, b):
                if seq in self._unacked and seq not in self._sacked:
                    self._sacked.add(seq)
                    delivered += 1
            if len(holes) < 2 * FAST_RETX_BURST and a > prev_end:
                holes.extend(range(prev_end, min(a, prev_end + MAX_CWND)))
            prev_end = max(prev_end, b)
        if rtt_sample is not None:
            self._rtt_update(rtt_sample)
            self._cc.on_rtt_sample(rtt_sample)
            _tm.UDP_ACK_RTT.observe(rtt_sample)
        if delivered:
            self._cc.on_delivered(delivered, self._in_flight())
        if holes:
            self._fast_retransmit(now, holes)
        if self._in_flight() < self._effective_window():
            self._window_free.set()
        self._rearm_timer()
        if self._fin_sent and not self._unacked:
            self._fin_acked.set()
        if self._peer_rwnd == 0 and not self._unacked \
                and (self._pending_writes or not self._fin_sent):
            self._arm_probe()

    def _rtt_update(self, sample: float) -> None:
        if self._srtt is None:
            self._srtt = sample
            self._rttvar = sample / 2
        else:
            self._rttvar = 0.75 * self._rttvar + 0.25 * abs(self._srtt - sample)
            self._srtt = 0.875 * self._srtt + 0.125 * sample
        # 200 ms floor: delayed ACKs (20 ms) + loop scheduling jitter
        # make a tighter floor fire spuriously, and every spurious RTO
        # both burns retransmissions and dents the budget model
        self._rto = min(max(self._srtt + max(4 * self._rttvar, 0.01), 0.2),
                        RTO_MAX)
        self._cc.srtt = self._srtt

    def _rto_backoff_reset(self) -> None:
        if self._srtt is not None:
            self._rto = min(max(self._srtt + max(4 * self._rttvar, 0.01),
                                0.2), RTO_MAX)
        else:
            self._rto = RTO_INITIAL

    def _in_flight(self) -> int:
        return len(self._unacked) - len(self._sacked)

    def _effective_window(self) -> int:
        if self._peer_rwnd <= 0:
            return 0
        return max(1, min(self._cc.budget(), self._peer_rwnd, MAX_CWND))

    def _fast_retransmit(self, now: float, holes: list[int]) -> None:
        """Re-send the peer-reported holes, each at most once per
        (bounded) RTT estimate."""
        # repair gap bounded at 100 ms: gating on raw srtt would let a
        # stall-inflated estimate throttle the very repairs that end
        # the stall (observed: srtt 1.5 s → one repair per 1.5 s), and
        # every 50 ms of repair latency is 50 ms of head-of-line hold
        # on the receiver's reorder buffer
        min_gap = max(0.01, min(self._srtt or RTO_INITIAL, 0.1))
        burst = 0
        for seq in holes:
            if burst >= FAST_RETX_BURST:
                break
            entry = self._unacked.get(seq)
            if entry is None or seq in self._sacked:
                continue
            if now - entry[2] >= min_gap:
                entry[2] = now
                entry[3] += 1
                self._cc.retransmitted += 1
                _tm.UDP_RETRANSMITS.inc()
                self._ep.sendto(entry[0], self.remote)
                burst += 1

    # --- zero-window persist -------------------------------------------

    def _arm_probe(self, rearm: bool = False) -> None:
        if self._probe_timer is not None or self._closed:
            return
        if not rearm:
            # count stall EPISODES, not probe re-arms: one long stall
            # re-arms once per backoff step and must still read as one
            _tm.UDP_RWND_STALLS.inc()
            P2P_EVENTS.emit("rwnd_stall", remote=str(self.remote))
        self._probe_timer = self._loop.call_later(
            self._probe_ivl, self._on_probe_timer)

    def _cancel_probe(self) -> None:
        self._probe_ivl = RTO_INITIAL
        if self._probe_timer is not None:
            self._probe_timer.cancel()
            self._probe_timer = None

    def _on_probe_timer(self) -> None:
        self._probe_timer = None
        if self._closed or self._peer_rwnd > 0:
            return
        self._ep.sendto(_HDR.pack(WPROBE, 0, 0), self.remote)
        self._probe_ivl = min(self._probe_ivl * 2, RTO_MAX)
        self._arm_probe(rearm=True)

    # --- sender --------------------------------------------------------

    def _transmit(self, typ: int, payload: bytes) -> None:
        seq = self._next_seq
        self._next_seq += 1
        dgram = _HDR.pack(typ, seq, 0) + payload
        now = time.monotonic()
        self._unacked[seq] = [dgram, now, now, 0]
        if self._rtt_probe is None:
            self._rtt_probe = (seq, now)
        if self._in_flight() >= self._effective_window():
            self._window_free.clear()
        self._ep.sendto(dgram, self.remote)
        self._rearm_timer()

    def _rearm_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self._unacked and not self._closed:
            self._timer = self._loop.call_later(self._rto, self._on_timeout)

    def _on_timeout(self) -> None:
        self._timer = None
        if not self._unacked or self._closed:
            return
        self._retries += 1
        if self._retries > MAX_RETRIES:
            self._fail(UdpStreamError("udp stream: peer unreachable"))
            return
        self._rto = min(self._rto * 2, RTO_MAX)
        self._cc.on_rto(self._retries)
        # episode-level flight-recorder record (per-segment emits would
        # tax the hot path the CC benchmark measures)
        P2P_EVENTS.emit(
            "rto_timeout", remote=str(self.remote),
            retries=self._retries, outstanding=len(self._unacked),
        )
        now = time.monotonic()
        # re-send a burst from the earliest holes — with lossy links
        # (acks drop too) repairing one segment per RTO crawls
        burst = 0
        for seq in range(self._send_base, self._next_seq):
            if burst >= FAST_RETX_BURST * 2:
                break
            entry = self._unacked.get(seq)
            if entry is None or seq in self._sacked:
                continue
            entry[2] = now
            entry[3] += 1
            self._cc.retransmitted += 1
            _tm.UDP_RETRANSMITS.inc()
            self._ep.sendto(entry[0], self.remote)
            burst += 1
        self._rearm_timer()

    def _fail(self, exc: Exception) -> None:
        if self._closed:
            return
        self._closed = True
        P2P_EVENTS.emit("stream_failed", remote=str(self.remote),
                        error=str(exc)[:200])
        self.reader.set_exception(exc)
        self._fin_acked.set()
        # unblock anything parked on a full window (drain/_drain_pending/
        # _graceful_close) — their loops re-check _closed and bail
        self._window_free.set()
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._cancel_probe()
        if self._ack_timer is not None:
            self._ack_timer.cancel()
            self._ack_timer = None
        if self._owns:
            self._ep.close()

    # --- writer facade (what transport.py expects) ---------------------

    def write(self, data: bytes) -> None:
        if self._closed or self._fin_sent:
            raise UdpStreamError("udp stream closed")
        from ..utils import faults as _faults

        spec = _faults.hit("p2p.write")
        if spec is not None:
            if spec.mode == "partial":
                # first segment goes out ON THE WIRE, then the
                # "connection" dies — the peer sees a truncated message,
                # this side an error. Transmitted synchronously: a
                # queued write would be discarded by _fail() below
                # before the sender task ever ran.
                self._transmit(DATA, bytes(memoryview(bytes(data))[:MSS]))
            self._fail(UdpStreamError("injected connection reset"))
            raise UdpStreamError("injected connection reset")
        view = memoryview(bytes(data))
        for off in range(0, max(len(view), 1), MSS):
            self._pending_writes.append(bytes(view[off:off + MSS]))
        self._kick_sender()

    def _kick_sender(self) -> None:
        if self._sender_task is None or self._sender_task.done():
            self._sender_task = self._loop.create_task(self._drain_pending())

    async def _drain_pending(self) -> None:
        # token-bucket pacing: credits accrue at the pacing rate and
        # every transmission spends one. Sleeping a computed interval
        # directly would throttle below the target — the loop oversleeps
        # by its scheduling granularity — but accrued credit absorbs the
        # overshoot, so only the *average* rate is enforced.
        credit = float(PACE_BURST)
        last = self._loop.time()
        while self._pending_writes and not self._closed:
            await self._window_free.wait()
            if self._closed:
                return
            rate = self._cc.pacing_rate()
            now = self._loop.time()
            credit = min(credit + (now - last) * rate, 2.0 * PACE_BURST)
            last = now
            while self._pending_writes and credit >= 1.0 \
                    and self._in_flight() < self._effective_window():
                self._transmit(DATA, self._pending_writes.popleft())
                credit -= 1.0
            if self._in_flight() >= self._effective_window():
                self._window_free.clear()
                if self._peer_rwnd == 0:
                    self._arm_probe()
            elif self._pending_writes and credit < 1.0:
                await asyncio.sleep(max((PACE_BURST - credit) / rate, 0.001))

    async def drain(self) -> None:
        # await the sender task rather than polling _window_free: when
        # the PACER (not the window) is the binding constraint the
        # event stays set and a poll loop would spin a core for the
        # whole paced transmission
        while self._pending_writes and not self._closed:
            task = self._sender_task
            if task is not None and not task.done():
                try:
                    await asyncio.shield(task)
                except Exception:  # noqa: BLE001 - stream failure below
                    pass
            else:
                await asyncio.sleep(0)
        if self._closed and not self._fin_sent:
            raise UdpStreamError("udp stream closed")

    def close(self) -> None:
        if self._closed or self._fin_sent:
            return
        self._fin_sent = True
        self._close_task = self._loop.create_task(self._graceful_close())

    async def _graceful_close(self) -> None:
        try:
            # flush queued writes (paced, same as the sender task),
            # then a reliable FIN
            await self._drain_pending()
            self._transmit(FIN, b"")
            await asyncio.wait_for(self._fin_acked.wait(), 5.0)
        except (asyncio.TimeoutError, Exception):
            pass
        finally:
            self._closed = True
            P2P_EVENTS.emit("stream_closed", remote=str(self.remote),
                            retransmits=self._cc.retransmitted)
            self._fin_acked.set()  # give-up still unblocks wait_closed()
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            self._cancel_probe()
            if self._ack_timer is not None:
                self._ack_timer.cancel()
                self._ack_timer = None
            if self._owns:
                self._ep.close()

    async def wait_closed(self) -> None:
        if self._fin_sent:
            await self._fin_acked.wait()

    def get_extra_info(self, name: str, default: Any = None) -> Any:
        if name == "peername":
            return self.remote
        if name == "sockname":
            return self._ep.local_addr
        if name == "udpstream_stats":
            # path telemetry for upper layers (Spaceblock block sizing,
            # p2p.state): current budget, rtt estimate, delivered segs
            return {
                "cwnd": self._cc.budget(),
                "srtt": self._srtt,
                "rtt_min": self._cc.rtt_min,
                "delivered_segments": self._cc.delivered,
                "peer_rwnd": self._peer_rwnd,
            }
        return default
