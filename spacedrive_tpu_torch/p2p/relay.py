"""WAN P2P via a relay — rendezvous + dumb byte pipe.

Parity: the reference reaches non-LAN peers through relayed libp2p
streams with hole punching layered on top
(ref:crates/p2p2/src/quic/transport.rs:212,344 `Control::
open_stream_with_addrs` over the patched libp2p relay). Here the cloud
relay (cloud/relay.py) doubles as the rendezvous: nodes hold a control
connection (`listen`), dialers ask the relay to splice a fresh TCP pair
(`dial` ↔ `accept`), and from then on the relay copies bytes blindly —
the normal Noise-style handshake (p2p/transport.py) runs END-TO-END
through the pipe, so the relay can neither read nor impersonate
(circuit-v2's trust model).

Control protocol (4-byte BE length + JSON). Registering an identity
requires proving possession of its ed25519 key (challenge signature),
or any client could hijack a victim's relayed reachability and spoof
its metadata:
  node → relay   {"cmd":"listen","identity":b58,"meta":{…}}
  relay → node   {"challenge":hex}
  node → relay   {"sig":hex}                  → {"ok":true}
  node → relay   {"cmd":"query"}              → {"peers":[{identity,meta}]}
  node → relay   {"cmd":"ping"}               → {"ok":true}
  relay → node   {"event":"incoming","conn":tok}
  dialer → relay {"cmd":"dial","target":b58}  → {"ok":true} then raw pipe
  node → relay   {"cmd":"accept","conn":tok}  → {"ok":true} then raw pipe
  any → relay    {"cmd":"stats"}              → {"ok":true,"stats":{…}}

Hole-punch coordination (DCUtR's role, see punch.py) rides the SAME
authenticated listener channels, so observed addresses are only ever
disclosed to registered identities; routing is stateless (the dialer
mints `conn` and both messages carry the routing target):
  A → relay      {"cmd":"punch","conn":tok,"target":B,"token":obs}
  relay → B      {"event":"punch","conn":tok,"from":A,"addr":[h,p]}
  B → relay      {"cmd":"punch_ack","conn":tok,"target":A,"token":obs}
  relay → A      {"event":"punch_addr","conn":tok,"ok":true,"addr":[h,p]}
The relay answers STUN-style observe datagrams on its UDP port
(advertised as `udp_port` in the listen OK) and REMEMBERS each observe
token → source address briefly; punch messages carry the token, and the
relay substitutes the address IT WITNESSED. Peers therefore can only
ever direct each other's probes at a UDP socket the claimant actually
controls — never at an arbitrary third party. Residual disclosure (any
registered identity can learn a peer's NAT mapping by asking) matches
the reference's posture, where libp2p identify/DCUtR exchange observed
addresses with any connected peer; nodes can opt out with punch=False.
`tok` is an unguessable 128-bit token known only to the listener the
incoming event was sent to, so a third party cannot race the accept.

Resource accounting (libp2p circuit-v2's relay limits play this role in
the reference): per-target pipe caps, a global pipe cap, and an optional
per-pipe-direction byte-rate cap enforced in the splice loop, so one
greedy peer can neither hoard all pipes nor saturate the relay's
bandwidth and starve other pipes. Counters ride the `stats` command and
`sdx relay` logs them.
Dialing needs no relay-level auth: the end-to-end handshake pins the
expected identity, so a misrouted pipe just fails to authenticate.

Counterpart of `spacedrive_tpu/p2p/relay.py`: the same control frames,
limits, stats and release paths, so port and JAX clients share one
relay of either package.
"""

from __future__ import annotations

import asyncio
import json
import logging
import secrets
import struct
import time
from dataclasses import dataclass
from typing import Any, Awaitable, Callable

from ..utils.tasks import supervise
from .identity import Identity, RemoteIdentity
from .transport import EncryptedStream, _client_handshake, _server_handshake

logger = logging.getLogger(__name__)

MAX_FRAME = 64 * 1024
PIPE_CHUNK = 64 * 1024
DIAL_TIMEOUT = 15.0
# protocol contract: clients must send SOMETHING on the control socket
# at least every CONTROL_IDLE_TIMEOUT seconds (their query loop does);
# the server evicts silent listeners as half-open after that
CONTROL_IDLE_TIMEOUT = 120.0
_LISTEN_CONTEXT = b"sd-relay-listen-v1"
# inbound punch-accept caps (client side): concurrent accepts, and
# accepts per source identity per sliding window
PUNCH_ACCEPT_MAX = 4
PUNCH_ACCEPT_PER_SOURCE = 4
PUNCH_ACCEPT_WINDOW = 30.0


async def read_frame(reader: asyncio.StreamReader) -> dict[str, Any]:
    hdr = await reader.readexactly(4)
    (length,) = struct.unpack(">I", hdr)
    if length > MAX_FRAME:
        raise ValueError("oversized control frame")
    return json.loads(await reader.readexactly(length))


def write_frame(writer: asyncio.StreamWriter, msg: dict[str, Any]) -> None:
    data = json.dumps(msg).encode()
    writer.write(struct.pack(">I", len(data)) + data)


class _SlidingWindow:
    """Per-identity sliding-window rate limiter with bounded memory:
    identities whose whole window expired are pruned once the table
    reaches `max_idents`."""

    def __init__(self, limit: int, window: float, max_idents: int = 1024):
        self.limit = limit
        self.window = window
        self.max_idents = max_idents
        self._times: dict[str, list[float]] = {}

    def allow(self, ident: str) -> bool:
        now = time.monotonic()
        recent = [t for t in self._times.get(ident, [])
                  if now - t < self.window]
        if len(recent) >= self.limit:
            self._times[ident] = recent
            return False
        recent.append(now)
        self._times[ident] = recent
        if len(self._times) > self.max_idents:
            # hard cap: keypairs are free to mint, so expiry alone
            # can't bound the table — evict the stalest identities
            # (oldest last-seen) down to the cap
            for stale in sorted(
                    self._times, key=lambda i: self._times[i][-1]
            )[: len(self._times) - self.max_idents]:
                del self._times[stale]
        return True


@dataclass
class RelayLimits:
    """Resource caps for a deployed relay (circuit-v2's role). `None`
    rate = unlimited; pipes caps always apply."""
    max_pipes_per_target: int = 8
    max_pipes_total: int = 256
    pipe_rate_bytes_per_s: int | None = None
    # punch coordination is cheap for the relay but triggers ~5 s of
    # socket-binding observe+probe work at the TARGET — rate-limit it
    # per authenticated source so one keypair can't spray a victim
    punch_per_source_per_minute: int = 12


@dataclass
class RelayStats:
    pipes_opened: int = 0
    pipes_active: int = 0
    pipes_refused_target_cap: int = 0
    pipes_refused_total_cap: int = 0
    bytes_relayed: int = 0
    listener_evictions: int = 0
    punches_refused_rate: int = 0

    def snapshot(self) -> dict[str, int]:
        return {k: int(v) for k, v in self.__dict__.items()}


async def _splice(a_r, a_w, b_r, b_w, stats: RelayStats | None = None,
                  rate: int | None = None) -> None:
    """Copy bytes both ways until either side closes. `rate` caps each
    DIRECTION with a token bucket (burst = 1 s of budget) so one
    saturating pipe cannot monopolize the relay's uplink; accounting
    lands in `stats`."""

    async def pump(r, w):
        allowance = float(rate) if rate else 0.0
        last = time.monotonic()
        try:
            while True:
                chunk = await r.read(PIPE_CHUNK)
                if not chunk:
                    break
                if rate:
                    now = time.monotonic()
                    allowance = min(float(rate), allowance + (now - last) * rate)
                    last = now
                    allowance -= len(chunk)
                    if allowance < 0:
                        await asyncio.sleep(-allowance / rate)
                w.write(chunk)
                await w.drain()
                if stats is not None:
                    stats.bytes_relayed += len(chunk)
        except (ConnectionError, asyncio.CancelledError, OSError):
            pass
        finally:
            try:
                w.close()
            except Exception:
                pass

    await asyncio.gather(pump(a_r, b_w), pump(b_r, a_w))


class RelayServer:
    """The rendezvous half that rides on the cloud relay process."""

    def __init__(self, limits: RelayLimits | None = None) -> None:
        self.limits = limits or RelayLimits()
        self.stats = RelayStats()
        # caps are enforced on RESERVATIONS (made at dial time, before
        # any listener work is queued), not on active splices — else a
        # burst of concurrent dials all passes the check before the
        # first accept lands and the caps do nothing (TOCTOU)
        self._reserved_total = 0
        self._reserved_by_target: dict[str, int] = {}
        self._pipes: set[asyncio.StreamWriter] = set()  # active splice ends
        self._listeners: dict[str, asyncio.StreamWriter] = {}
        self._meta: dict[str, dict[str, Any]] = {}
        # conn ids are unguessable tokens: the accept claim arrives on a
        # fresh TCP connection, so a guessable id would let any client
        # race the legitimate listener and steal the pending pipe
        # (killing the dial — availability, not confidentiality, since
        # the end-to-end handshake still prevents impersonation)
        # conn → (dial reader, dial writer, accepted future, target)
        self._pending: dict[str, tuple[asyncio.StreamReader, asyncio.StreamWriter,
                                       "asyncio.Future[None]", str]] = {}
        self._server: asyncio.base_events.Server | None = None
        self.port: int | None = None
        self._udp: "UdpEndpoint | None" = None
        self.udp_port: int | None = None
        # observe token → (witnessed addr, monotonic time); punch
        # routing resolves addrs from here so they are relay-verified
        self._observed: dict[str, tuple[tuple[str, int], float]] = {}
        # authenticated source identity → recent punch-request times
        # (sliding minute window, see RelayLimits.punch_per_source_per_minute)
        self._punch_rate = _SlidingWindow(
            self.limits.punch_per_source_per_minute, 60.0)

    def _punch_rate_ok(self, ident: str) -> bool:
        if not self._punch_rate.allow(ident):
            self.stats.punches_refused_rate += 1
            return False
        return True

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._handle, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        # STUN-style observe endpoint for hole punching (punch.py)
        from .punch import OBSERVE_MAGIC, observe_reply
        from .udp import UdpEndpoint

        self._udp = UdpEndpoint()
        _, self.udp_port = await self._udp.bind(host, 0)

        def on_dgram(data: bytes, addr: tuple[str, int]) -> None:
            if not data.startswith(OBSERVE_MAGIC):
                return
            try:
                token = json.loads(data[len(OBSERVE_MAGIC):]).get("token")
            except ValueError:
                return
            if isinstance(token, str) and len(token) <= 64 \
                    and self._udp is not None:
                now = time.monotonic()
                if len(self._observed) >= 4096:  # bounded: evict stale
                    self._observed = {
                        t: v for t, v in self._observed.items()
                        if now - v[1] < 60.0
                    }
                if len(self._observed) < 4096:
                    self._observed[token] = (tuple(addr), now)
                self._udp.sendto(observe_reply(token, addr), addr)

        self._udp.set_receiver(on_dgram)
        return self.port

    async def shutdown(self) -> None:
        if self._udp is not None:
            self._udp.close()
            self._udp = None
        # close the control connections FIRST: on Python 3.12+
        # Server.wait_closed() blocks until every connection handler
        # returns, and listener handlers loop until their socket dies
        for w in list(self._listeners.values()):
            w.close()
        self._listeners.clear()
        for _r, w, fut, _t in self._pending.values():
            if not fut.done():
                fut.cancel()
            w.close()
        self._pending.clear()
        # force-close active splices: their handlers must return or
        # (3.12+) Server.wait_closed() below blocks forever
        for w in list(self._pipes):
            w.close()
        self._pipes.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            msg = await asyncio.wait_for(read_frame(reader), 30)
        except Exception:
            writer.close()
            return
        cmd = msg.get("cmd")
        try:
            if cmd == "listen":
                await self._serve_listener(reader, writer, msg)
            elif cmd == "dial":
                await self._serve_dial(reader, writer, msg)
            elif cmd == "accept":
                await self._serve_accept(reader, writer, msg)
            elif cmd == "stats":
                write_frame(writer, {"ok": True, "stats": self.stats.snapshot(),
                                     "listeners": len(self._listeners)})
                await writer.drain()
                writer.close()
            else:
                write_frame(writer, {"ok": False, "error": "unknown cmd"})
                writer.close()
        except (ConnectionError, asyncio.IncompleteReadError, OSError,
                asyncio.TimeoutError):
            writer.close()

    async def _serve_listener(self, reader, writer, msg) -> None:
        ident = msg["identity"]
        # challenge-response: only the holder of the ed25519 key may
        # register (and keep re-registering metadata for) an identity
        try:
            pub = RemoteIdentity.from_str(ident)
        except Exception:
            write_frame(writer, {"ok": False, "error": "bad identity"})
            await writer.drain()
            writer.close()
            return
        nonce = secrets.token_bytes(32)
        write_frame(writer, {"challenge": nonce.hex()})
        await writer.drain()
        answer = await asyncio.wait_for(read_frame(reader), 30)
        sig = bytes.fromhex(answer.get("sig", ""))
        if not pub.verify(sig, _LISTEN_CONTEXT + nonce):
            write_frame(writer, {"ok": False, "error": "auth failed"})
            await writer.drain()
            writer.close()
            return
        old = self._listeners.get(ident)
        if old is not None and old is not writer:
            old.close()  # the authenticated newcomer supersedes
        self._listeners[ident] = writer
        self._meta[ident] = msg.get("meta", {})
        write_frame(writer, {"ok": True, "udp_port": self.udp_port})
        await writer.drain()
        try:
            while True:
                # a control connection silent past the contract window
                # is half-open — evict the ghost listener
                try:
                    req = await asyncio.wait_for(read_frame(reader),
                                                 CONTROL_IDLE_TIMEOUT)
                except asyncio.TimeoutError:
                    self.stats.listener_evictions += 1
                    raise
                c = req.get("cmd")
                if c == "query":
                    write_frame(writer, {"event": "peers", "peers": [
                        {"identity": i, "meta": m}
                        for i, m in self._meta.items() if i != ident
                    ]})
                elif c == "listen":  # metadata refresh
                    self._meta[ident] = req.get("meta", {})
                    write_frame(writer, {"ok": True})
                elif c == "ping":
                    write_frame(writer, {"ok": True})
                elif c == "punch":
                    # `from` is OUR authenticated ident, never claimed;
                    # the addr is the one the relay WITNESSED for the
                    # carried observe token — senders cannot point
                    # probes at third parties
                    if not self._punch_rate_ok(ident):
                        # refused BEFORE consuming the one-shot observe
                        # token or touching the target: an explicit error
                        # so the dialer falls back to the relayed pipe
                        # immediately instead of timing out
                        write_frame(writer, {
                            "event": "punch_addr",
                            "conn": req.get("conn"), "ok": False,
                            "error": "punch rate limited",
                        })
                        await writer.drain()
                        continue
                    addr = self._witnessed(req.get("token"))
                    target_w = self._listeners.get(req.get("target"))
                    if target_w is None or addr is None:
                        write_frame(writer, {
                            "event": "punch_addr",
                            "conn": req.get("conn"), "ok": False,
                            "error": "target not registered"
                                     if addr else "unknown observe token",
                        })
                    else:
                        # a dead TARGET channel must not tear down THIS
                        # (innocent) sender's registration
                        try:
                            write_frame(target_w, {
                                "event": "punch", "conn": req.get("conn"),
                                "from": ident, "addr": list(addr),
                            })
                            await target_w.drain()
                        except (ConnectionError, OSError):
                            write_frame(writer, {
                                "event": "punch_addr",
                                "conn": req.get("conn"), "ok": False,
                                "error": "target unreachable",
                            })
                elif c == "punch_ack":
                    # stateless reply routing: back to the dialer named
                    # in `target` (only registered identities reach here)
                    addr = self._witnessed(req.get("token"))
                    dialer_w = self._listeners.get(req.get("target"))
                    if dialer_w is not None and addr is not None:
                        try:
                            write_frame(dialer_w, {
                                "event": "punch_addr",
                                "conn": req.get("conn"), "ok": True,
                                "addr": list(addr),
                            })
                            await dialer_w.drain()
                        except (ConnectionError, OSError):
                            pass  # dialer died; punch simply won't happen
                await writer.drain()
        finally:
            if self._listeners.get(ident) is writer:
                del self._listeners[ident]
                self._meta.pop(ident, None)
            writer.close()

    async def _serve_dial(self, reader, writer, msg) -> None:
        target = msg.get("target")
        host_w = self._listeners.get(target)
        if host_w is None:
            write_frame(writer, {"ok": False, "error": "target not registered"})
            await writer.drain()
            writer.close()
            return
        # resource caps BEFORE work is queued: reservations are taken
        # HERE (synchronously, no await between check and reserve) so a
        # burst of concurrent dials can't all pass the check before the
        # first accept lands
        if self._reserved_total >= self.limits.max_pipes_total:
            self.stats.pipes_refused_total_cap += 1
            write_frame(writer, {"ok": False, "error": "relay at capacity"})
            await writer.drain()
            writer.close()
            return
        if (self._reserved_by_target.get(target, 0)
                >= self.limits.max_pipes_per_target):
            self.stats.pipes_refused_target_cap += 1
            write_frame(writer, {"ok": False, "error": "target pipe cap"})
            await writer.drain()
            writer.close()
            return
        self._reserve(target)
        conn_id = secrets.token_hex(16)
        accepted: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[conn_id] = (reader, writer, accepted, target)
        try:
            write_frame(host_w, {"event": "incoming", "conn": conn_id})
            await host_w.drain()
            await asyncio.wait_for(accepted, DIAL_TIMEOUT)
        except Exception:
            self._pending.pop(conn_id, None)
            self._release(target)
            write_frame(writer, {"ok": False, "error": "accept timeout"})
            try:
                await writer.drain()
            except Exception:
                pass
            writer.close()
        # on success the accept side owns the splice (and releases the
        # reservation when it ends); nothing more here

    def _witnessed(self, token: Any) -> tuple[str, int] | None:
        """Address this relay saw for an observe token (fresh only)."""
        if not isinstance(token, str):
            return None
        entry = self._observed.pop(token, None)
        if entry is None or time.monotonic() - entry[1] > 60.0:
            return None
        return entry[0]

    def _reserve(self, target: str) -> None:
        self._reserved_total += 1
        self._reserved_by_target[target] = (
            self._reserved_by_target.get(target, 0) + 1
        )

    def _release(self, target: str) -> None:
        self._reserved_total = max(0, self._reserved_total - 1)
        left = self._reserved_by_target.get(target, 1) - 1
        if left <= 0:
            self._reserved_by_target.pop(target, None)
        else:
            self._reserved_by_target[target] = left

    async def _serve_accept(self, reader, writer, msg) -> None:
        entry = self._pending.pop(str(msg.get("conn", "")), None)
        if entry is None:
            write_frame(writer, {"ok": False, "error": "unknown conn"})
            await writer.drain()
            writer.close()
            return
        dial_r, dial_w, accepted, target = entry
        # resolve the future FIRST: the dial side's wait_for may cancel
        # it during any await below, and set_result on a cancelled
        # future raises InvalidStateError
        if accepted.cancelled():
            # the dial path released the reservation when it timed out
            write_frame(writer, {"ok": False, "error": "dial gone"})
            await writer.drain()
            writer.close()
            return
        accepted.set_result(None)
        # from here the reservation is THIS handler's to release
        self.stats.pipes_opened += 1
        self.stats.pipes_active += 1
        try:
            # inside the try (sdlint SD016): any failure past this
            # point — including registering the pipe pair — must run
            # the finally, or pipes_active overcounts forever and the
            # reservation never releases
            self._pipes.update((dial_w, writer))
            write_frame(writer, {"ok": True})
            write_frame(dial_w, {"ok": True})
            await writer.drain()
            await dial_w.drain()
            await _splice(dial_r, dial_w, reader, writer, stats=self.stats,
                          rate=self.limits.pipe_rate_bytes_per_s)
        finally:
            self.stats.pipes_active -= 1
            self._release(target)
            self._pipes.difference_update((dial_w, writer))


class RelayClient:
    """Node-side: keeps a control connection registered on the relay,
    accepts relayed inbound streams, dials relayed outbound streams,
    and feeds relay-discovered peers into the P2P registry."""

    def __init__(self, p2p: Any, relay_addr: tuple[str, int],
                 on_stream: Callable[[EncryptedStream], Awaitable[None]],
                 query_interval: float = 5.0,
                 udp_factory: Callable[[], Any] | None = None,
                 punch: bool = True):
        self.p2p = p2p
        self.addr = relay_addr
        self.identity: Identity = p2p.identity
        self._on_stream = on_stream
        # the server evicts listeners silent past CONTROL_IDLE_TIMEOUT;
        # clamp so a tuned-up interval can't violate the contract
        self._interval = min(query_interval, CONTROL_IDLE_TIMEOUT / 4)
        self._task: asyncio.Task | None = None
        self._accepts: set[asyncio.Task] = set()  # keep strong refs
        self._stopped = asyncio.Event()
        # hole punching (punch.py); udp_factory is the NAT-simulation
        # seam — tests hand in translating endpoints
        self._punch_enabled = punch
        self._udp_factory = udp_factory
        self._relay_udp: tuple[str, int] | None = None
        self._ctrl: asyncio.StreamWriter | None = None
        self._punch_waits: dict[str, asyncio.Future] = {}
        # inbound punch-accept guard: each accept binds a socket and runs
        # up to ~5 s of observe+probe spray, so any registered keypair
        # could otherwise exhaust us with punch events (availability DoS)
        self._punch_active = 0
        self._punch_rate = _SlidingWindow(
            PUNCH_ACCEPT_PER_SOURCE, PUNCH_ACCEPT_WINDOW, max_idents=256)
        # path-selection telemetry (surfaced via p2p.state)
        self.punch_stats = {"attempted": 0, "direct": 0, "fallback": 0,
                            "accepted": 0, "refused": 0}

    async def start(self) -> None:
        self._task = asyncio.create_task(self._run())
        # expose relayed dialing to P2P.new_stream's fallback
        self.p2p.relay_dial = self.dial

    async def shutdown(self) -> None:
        self._stopped.set()
        for t in (self._task, *self._accepts):
            if t is None:
                continue
            t.cancel()
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._accepts.clear()
        if getattr(self.p2p, "relay_dial", None) is self.dial:
            self.p2p.relay_dial = None

    # --- control loop ---------------------------------------------------

    async def _run(self) -> None:
        while not self._stopped.is_set():
            try:
                await self._session()
            except asyncio.CancelledError:
                return
            except Exception as e:  # noqa: BLE001 - reconnect loop
                logger.debug("relay session ended: %s", e)
            try:
                await asyncio.wait_for(self._stopped.wait(), 2.0)
            except asyncio.TimeoutError:
                pass

    def _meta(self) -> dict[str, Any]:
        return dict(self.p2p.metadata)

    async def _session(self) -> None:
        reader, writer = await asyncio.open_connection(*self.addr)
        try:
            write_frame(writer, {
                "cmd": "listen",
                "identity": str(self.p2p.remote_identity),
                "meta": self._meta(),
            })
            await writer.drain()
            challenge = await asyncio.wait_for(read_frame(reader), 30)
            if "challenge" not in challenge:
                raise ConnectionError(f"relay refused listen: {challenge}")
            nonce = bytes.fromhex(challenge["challenge"])
            write_frame(writer, {
                "sig": self.identity.sign(_LISTEN_CONTEXT + nonce).hex()
            })
            await writer.drain()
            resp = await asyncio.wait_for(read_frame(reader), 30)
            if not resp.get("ok"):
                raise ConnectionError(f"relay auth failed: {resp}")
            if resp.get("udp_port"):
                self._relay_udp = (self.addr[0], int(resp["udp_port"]))
            self._ctrl = writer

            # dedicated read loop: incoming dials are answered the
            # moment the relay announces them, never a poll-cycle later
            async def reads():
                while True:
                    msg = await read_frame(reader)
                    event = msg.get("event")
                    if event == "incoming":
                        supervise(asyncio.create_task(self._accept(msg["conn"])),
                                  self._accepts, logger, "relayed accept")
                    elif event == "peers":
                        self._ingest_peers(msg.get("peers", []))
                    elif event == "punch":
                        supervise(asyncio.create_task(self._punch_accept(msg)),
                                  self._accepts, logger, "punch accept")
                    elif event == "punch_addr":
                        fut = self._punch_waits.pop(msg.get("conn", ""), None)
                        if fut is not None and not fut.done():
                            fut.set_result(msg)
                    # {"ok":true} replies to refreshes need no action

            read_task = asyncio.create_task(reads())
            try:
                last_meta = self._meta()
                while not self._stopped.is_set():
                    write_frame(writer, {"cmd": "query"})
                    if self._meta() != last_meta:
                        last_meta = self._meta()
                        write_frame(writer, {
                            "cmd": "listen",
                            "identity": str(self.p2p.remote_identity),
                            "meta": last_meta,
                        })
                    await writer.drain()
                    done, _ = await asyncio.wait(
                        [read_task], timeout=self._interval
                    )
                    if done:  # the control socket died → reconnect
                        read_task.result()
                        return
            finally:
                read_task.cancel()
                try:
                    await read_task
                except (asyncio.CancelledError, Exception):
                    pass
        finally:
            self._ctrl = None
            for fut in self._punch_waits.values():
                if not fut.done():
                    fut.cancel()
            self._punch_waits.clear()
            writer.close()

    def _ingest_peers(self, peers: list[dict[str, Any]]) -> None:
        seen = set()
        for entry in peers:
            try:
                ident = RemoteIdentity.from_str(entry["identity"])
            except Exception:
                continue
            seen.add(ident)
            if ident == self.p2p.remote_identity:
                continue
            peer = self.p2p.touch_peer(ident)
            fresh = not peer.is_discovered
            meta = {str(k): str(v) for k, v in (entry.get("meta") or {}).items()}
            changed = any(peer.metadata.get(k) != v for k, v in meta.items())
            peer.metadata.update(meta)
            peer.discovered_by.add("relay")
            peer.relayed = True
            if fresh:
                self.p2p.events.emit(("PeerDiscovered", ident))
            elif changed:
                self.p2p.events.emit(("PeerMetadataChanged", ident))
        for ident, peer in self.p2p.peers.items():
            if peer.relayed and ident not in seen:
                peer.relayed = False
                self.p2p.expired("relay", ident)  # one expiry semantics

    # --- streams --------------------------------------------------------

    async def _accept(self, conn_id: str) -> None:
        """Dial back to the relay, claim the conn, run the SERVER side
        of the Noise handshake through the pipe."""
        try:
            reader, writer = await asyncio.open_connection(*self.addr)
            write_frame(writer, {"cmd": "accept", "conn": conn_id})
            await writer.drain()
            resp = await asyncio.wait_for(read_frame(reader), DIAL_TIMEOUT)
            if not resp.get("ok"):
                writer.close()
                return
            stream = await asyncio.wait_for(
                _server_handshake(reader, writer, self.identity), DIAL_TIMEOUT
            )
        except Exception as e:  # noqa: BLE001 - inbound is best-effort
            logger.debug("relayed accept %s failed: %s", conn_id, e)
            return
        try:
            await self._on_stream(stream)
        finally:
            await stream.close()

    async def dial(self, identity: RemoteIdentity,
                   timeout: float = DIAL_TIMEOUT) -> EncryptedStream:
        """Open a stream to `identity`: try a punched DIRECT UDP path
        first (every byte then bypasses the relay), fall back to the
        relayed TCP pipe — the reference's DCUtR-then-relay order
        (ref:quic/transport.rs:212,344)."""
        if self._punch_enabled and self._relay_udp and self._ctrl:
            # the punch attempt (observe/exchange/open/handshake) runs
            # under the caller's deadline, and the fallback gets only
            # what remains (floored so it always has a fighting chance)
            start = asyncio.get_running_loop().time()
            self.punch_stats["attempted"] += 1
            try:
                stream = await asyncio.wait_for(
                    self.punch_dial(identity, timeout=timeout), timeout
                )
                self.punch_stats["direct"] += 1
                return stream
            except Exception as e:  # noqa: BLE001 - any punch failure → relay
                logger.debug("punch to %s failed (%s); using relay",
                             identity, e)
            self.punch_stats["fallback"] += 1
            timeout = max(
                3.0, timeout - (asyncio.get_running_loop().time() - start)
            )
        return await self.relay_dial_tcp(identity, timeout=timeout)

    async def relay_dial_tcp(self, identity: RemoteIdentity,
                             timeout: float = DIAL_TIMEOUT) -> EncryptedStream:
        """Open a relayed stream to `identity` (CLIENT handshake through
        the spliced pipe)."""
        reader, writer = await asyncio.open_connection(*self.addr)
        try:
            write_frame(writer, {"cmd": "dial", "target": str(identity)})
            await writer.drain()
            resp = await asyncio.wait_for(read_frame(reader), timeout)
            if not resp.get("ok"):
                raise ConnectionError(f"relay dial failed: {resp.get('error')}")
            return await asyncio.wait_for(
                _client_handshake(reader, writer, self.identity, identity),
                timeout,
            )
        except BaseException:
            writer.close()
            raise

    # --- hole punching (punch.py + udpstream.py) ------------------------

    def _make_udp(self):
        if self._udp_factory is not None:
            return self._udp_factory()
        from .udp import UdpEndpoint

        return UdpEndpoint()

    async def punch_dial(self, identity: RemoteIdentity,
                         timeout: float = DIAL_TIMEOUT) -> EncryptedStream:
        """Direct path: observe → exchange via control channel →
        simultaneous open → Noise XX over the reliable UDP stream."""
        from . import punch
        from .udpstream import UdpStream

        ctrl = self._ctrl
        if ctrl is None or self._relay_udp is None:
            raise punch.PunchError("no relay control channel")
        ep = self._make_udp()
        try:
            await ep.bind()
            _my_addr, token = await punch.observe(ep, self._relay_udp)
            conn = secrets.token_hex(8)
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._punch_waits[conn] = fut
            try:
                write_frame(ctrl, {
                    "cmd": "punch", "conn": conn,
                    "target": str(identity), "token": token,
                })
                await ctrl.drain()
                answer = await asyncio.wait_for(fut, punch.PUNCH_TIMEOUT + 2)
            except asyncio.CancelledError:
                if fut.cancelled():
                    # the control channel dropped and cancelled our wait
                    # — a punch failure, not a caller cancellation
                    raise punch.PunchError("control channel lost") from None
                raise
            finally:
                self._punch_waits.pop(conn, None)
            if not answer.get("ok") or not answer.get("addr"):
                raise punch.PunchError(
                    f"peer unreachable for punch: {answer.get('error')}")
            peer_addr = (answer["addr"][0], int(answer["addr"][1]))
            await punch.simultaneous_open(ep, peer_addr)
            stream = UdpStream(ep, peer_addr)
            es = await asyncio.wait_for(
                _client_handshake(stream.reader, stream, self.identity,
                                  identity),
                timeout,
            )
            es.direct = True  # diagnosable path selection
            return es
        except BaseException:
            ep.close()
            raise

    async def _punch_accept(self, msg: dict[str, Any]) -> None:
        """Admission control for an inbound punch event; the actual
        observe/open/handshake work runs in `_punch_accept_inner`."""
        ctrl = self._ctrl
        if ctrl is None or self._relay_udp is None:
            return
        # concurrency cap + per-source sliding window: dropped requests
        # leave the dialer to fall back to the relayed pipe — bounded
        # work here beats availability for a spraying peer. The cap
        # covers only the observe/probe/handshake phase; the slot is
        # released BEFORE the accepted stream is served, so long-lived
        # inbound transfers don't starve new punches.
        src = str(msg.get("from", ""))
        if self._punch_active >= PUNCH_ACCEPT_MAX \
                or not self._punch_rate.allow(src):
            self.punch_stats["refused"] += 1
            logger.debug("punch accept from %s refused (load)", src[:16])
            return
        self._punch_active += 1
        try:
            es = await self._punch_accept_inner(msg, ctrl)
        finally:
            self._punch_active -= 1
        if es is None:
            return
        try:
            await self._on_stream(es)
        finally:
            await es.close()

    async def _punch_accept_inner(self, msg: dict[str, Any],
                                  ctrl) -> "EncryptedStream | None":
        """Answer an admitted punch request: observe, return our
        address, open simultaneously, then run the SERVER side of
        Noise over UDP. Returns the authenticated stream (served by
        the caller, outside the concurrency slot) or None."""
        from . import punch
        from .udpstream import UdpStream

        ep = self._make_udp()
        try:
            await ep.bind()
            _my_addr, token = await punch.observe(ep, self._relay_udp)
            write_frame(ctrl, {
                "cmd": "punch_ack", "conn": msg.get("conn"),
                "target": msg.get("from"), "token": token,
            })
            await ctrl.drain()
            peer_addr = (msg["addr"][0], int(msg["addr"][1]))
            await punch.simultaneous_open(ep, peer_addr)
            stream = UdpStream(ep, peer_addr)
            es = await asyncio.wait_for(
                _server_handshake(stream.reader, stream, self.identity),
                DIAL_TIMEOUT,
            )
            self.punch_stats["accepted"] += 1
            return es
        except Exception as e:  # noqa: BLE001 - inbound is best-effort
            logger.debug("punch accept failed: %s", e)
            ep.close()
            return None
