"""P2PManager — wires the P2P runtime into the Node.

Parity: ref:core/src/p2p/manager.rs:49-118 — builds the P2P runtime
from `NodeConfig.p2p` (port, discovery mode), advertises node metadata
(name/os/version, metadata.rs) plus per-library instances
(libraries.rs) over discovery, dispatches inbound streams by `Header`
(protocol.rs), pushes sync alerts to library peers on every local
`write_ops`, and backs each library's ingest actor with peer pulls.

Counterpart of `spacedrive_tpu/p2p/manager.py` without the work plane:
the port has no `p2p/work.py` yet, so the manager has no `work`, and a
library member's WORK stream gets the answer JAX's `respond_work` gives
on a node whose work plane is not running. Until the serve runtime and
cloud sync are ported, the manager takes JAX's own path for a node
without them: inbound serving is admitted ungated, sync-applied ops
invalidate no serve cache (the search index still folds them in), and
the relay leg of the federation refresh finds no cloud-synced library
(`peer_for_instance`, which the relay leg and the HTTP host's remote
file serving use, comes with them).
"""

from __future__ import annotations

import asyncio
import logging
import platform
import uuid
from typing import Any

from ..node.config import BackendFeature, P2PDiscoveryState
from ..sync.ingest import IngestActor
from ..telemetry import span as _span
from ..telemetry import tenants as _tenants
from ..telemetry import trace as _trace
from ..telemetry.events import P2P_EVENTS
from ..telemetry.federation import FederationCache
from ..utils import faults as _faults
from ..utils.resilience import (
    PASS,
    RETRY,
    BreakerOpen,
    ResiliencePolicy,
    RetryPolicy,
)
from ..utils.tasks import supervise
from .identity import RemoteIdentity
from .mdns import MdnsDiscovery
from .operations import (
    SpacedropManager,
    request_profile,
    request_telemetry,
    request_trace,
    respond_file,
    respond_profile,
    respond_telemetry,
    respond_trace,
)
from .p2p import P2P
from .protocol import Header, HeaderType
from .sync import alert_new_ops, request_ops_from_peer, respond_sync_request
from .wire import Reader, Writer

logger = logging.getLogger(__name__)


def _peer_classify(exc: BaseException) -> str:
    """Retry/breaker classification for peer-facing calls: transport
    failures retry and count; an ANSWER we dislike (refusal, version
    mismatch) passes through untouched — a peer that responds is not a
    peer whose breaker should open."""
    if isinstance(exc, (PermissionError, ValueError)):
        return PASS
    return RETRY


# One bounded, jittered retry ladder + per-peer breaker for every
# sync-plane exchange (alerts, op pulls, telemetry pulls): a flapping
# peer costs one fast BreakerOpen per write instead of a fresh dial +
# timeout, and re-arms itself through the breaker's half-open probe.
SYNC_POLICY = ResiliencePolicy(
    "p2p_sync",
    RetryPolicy(max_attempts=2, base_delay=0.05, max_delay=0.5,
                attempt_timeout=30.0),
    failure_threshold=3,
    reset_timeout=15.0,
    classify=_peer_classify,
)


class P2PManager:
    def __init__(self, node: Any, *, beacon_addrs: list[tuple[str, int]] | None = None,
                 bind_host: str = "0.0.0.0"):
        self.node = node
        self.p2p = P2P("spacedrive", node.config.config.identity)
        self.spacedrop = SpacedropManager(self.p2p, node.event_bus)
        self.relay_client = None  # set when p2p.relay is configured
        from .pairing import PairingManager

        self.pairing = PairingManager(node, node.event_bus)
        self.ingest_actors: dict[uuid.UUID, IngestActor] = {}
        # mesh-wide telemetry: freshest snapshot per peer w/ staleness
        # (telemetry/federation.py; read via GET /mesh, telemetry.mesh)
        self.federation = FederationCache()
        self._beacon_addrs = beacon_addrs
        self._bind_host = bind_host
        self._unsubs: list[Any] = []
        # in-flight sync-alert fan-outs: tracked so shutdown can await
        # them — an orphaned alert coroutine cancelled at loop teardown
        # is exactly the kind of half-sent alert production can't afford
        self._alert_tasks: set[asyncio.Task] = set()
        self._shutting_down = False
        self.port: int | None = None

    def _spawn_alert(self, loop: asyncio.AbstractEventLoop,
                     lib_id: uuid.UUID) -> None:
        if self._shutting_down or not loop.is_running():
            return
        supervise(loop.create_task(self._alert_peers(lib_id)),
                  self._alert_tasks, logger, "sync alert fan-out")

    # --- lifecycle -----------------------------------------------------

    async def start(self) -> None:
        cfg = self.node.config.config
        self._loop = asyncio.get_running_loop()
        self.p2p.set_stream_handler(self._handle_stream)
        # a peer appearing with one of our libraries triggers a pull —
        # discovery often lands after the peer's alerts were sent
        self._unsubs.append(self.p2p.events.on(self._on_p2p_event))
        self.port = await self.p2p.listen(cfg.p2p.port, host=self._bind_host)
        self._advertise()
        if cfg.p2p.discovery != P2PDiscoveryState.DISABLED:
            mdns = MdnsDiscovery(
                self.p2p,
                self.port,
                beacon_addrs=self._beacon_addrs,
                bind_port=0 if self._beacon_addrs is not None else 41841,
            )
            await mdns.start()
        if cfg.p2p.relay:
            host, _, port_s = cfg.p2p.relay.rpartition(":")
            if not host or not port_s.isdigit():
                logger.error(
                    "p2p.relay %r is not \"host:port\" (IPv6: \"[::1]:7000\")"
                    " — WAN relay disabled", cfg.p2p.relay,
                )
            else:
                from .relay import RelayClient

                relay = RelayClient(
                    self.p2p, (host.strip("[]"), int(port_s)),
                    self.p2p._on_stream,
                )
                await relay.start()
                self.p2p.register_discovery(relay)
                self.relay_client = relay  # punch telemetry for p2p.state
        for lib in self.node.libraries.libraries.values():
            self.register_library(lib)

    def _advertise(self) -> None:
        """Node metadata for discovery (ref:p2p/metadata.rs) + the
        instances this node exposes per library (ref:p2p/libraries.rs)."""
        cfg = self.node.config.config
        self.p2p.metadata.update(
            {
                "name": cfg.name,
                "operating_system": platform.system().lower(),
                "device_model": platform.machine(),
                "version": "0.1.0",
                "libraries": ",".join(
                    str(lid) for lid in self.node.libraries.libraries
                ),
                # instance → node mapping for remote file serving
                # (ref:custom_uri/mod.rs ServeFrom::Remote resolution)
                "instances": ",".join(
                    str(lib.sync.instance)
                    for lib in self.node.libraries.libraries.values()
                ),
            }
        )

    def register_library(self, lib: Any) -> None:
        """Wire sync for one library: alert peers on local writes; back
        the ingest actor with peer pulls (ref:p2p/sync/mod.rs)."""
        if lib.id in self.ingest_actors:
            return

        async def request_ops(timestamps, count, lib_id=lib.id):
            for peer in self.peers_for_library(lib_id):
                try:
                    # EOFError covers IncompleteReadError: a peer
                    # vanishing mid-SYNC is a failed (retryable) pull,
                    # not an unhandled ingest-tick crash
                    return await SYNC_POLICY.call(
                        str(peer.identity),
                        lambda peer=peer: request_ops_from_peer(
                            self.p2p, peer.identity, lib_id, timestamps,
                            count,
                        ),
                    )
                except BreakerOpen:
                    continue  # fast-failed: try the next peer
                except (ConnectionError, OSError, EOFError,
                        asyncio.TimeoutError) as e:
                    logger.debug("sync pull from %s failed: %s", peer.identity, e)
            return [], False

        def on_applied(lib=lib):
            # JAX first drops the library's serve-cache tag here; without
            # a serve runtime there is no cache to drop. Replicated
            # object_embedding rows fold into the vector index, so a
            # replica answers search.semantic without ever running the
            # embed stage itself (failure-contained: the hook must never
            # wedge the ingest actor)
            from ..object.search.index import on_embeddings_applied

            on_embeddings_applied(lib)

        actor = IngestActor(lib.sync, request_ops, on_applied=on_applied)
        self.ingest_actors[lib.id] = actor
        lib.ingest = actor

        def on_event(event, lib_id=lib.id):
            # Created: local write. Ingested: ops arrived from a peer —
            # re-alerting turns any connected subgraph into a relay
            # (hub topologies converge transitively; alerts are
            # idempotent nudges, peers pull by watermark)
            if event in (("SyncMessage", "Created"), ("SyncMessage", "Ingested")):
                loop = getattr(self, "_loop", None)
                if loop is not None and loop.is_running():
                    loop.call_soon_threadsafe(self._spawn_alert, loop, lib_id)

        try:
            self._loop = asyncio.get_running_loop()
        except RuntimeError:
            pass  # set at start(); registration before start is fine
        self._unsubs.append(lib.event_bus.on(on_event))
        self._advertise()

    def _on_p2p_event(self, event: Any) -> None:
        if not (
            isinstance(event, tuple)
            and event
            and event[0] in ("PeerDiscovered", "PeerMetadataChanged")
        ):
            return
        peer = self.p2p.peers.get(event[1])
        if peer is None:
            return
        advertised = set(peer.metadata.get("libraries", "").split(","))
        for lib_id, actor in self.ingest_actors.items():
            if str(lib_id) in advertised:
                actor.notify()

    async def _alert_peers(self, library_id: uuid.UUID) -> None:
        for peer in self.peers_for_library(library_id):
            try:
                await SYNC_POLICY.call(
                    str(peer.identity),
                    lambda peer=peer: alert_new_ops(
                        self.p2p, peer.identity, library_id
                    ),
                )
            except BreakerOpen:
                continue  # alerts are idempotent nudges; skip fast
            except (ConnectionError, OSError, EOFError,
                    asyncio.TimeoutError) as e:
                logger.debug("sync alert to %s failed: %s", peer.identity, e)

    def peers_for_library(self, library_id: uuid.UUID) -> list[Any]:
        lid = str(library_id)
        return [
            p
            for p in self.p2p.discovered_peers()
            if lid in p.metadata.get("libraries", "").split(",")
        ]

    def _is_library_member(self, remote_identity: Any,
                           library_id: uuid.UUID | None = None) -> bool:
        """True when the identity belongs to an instance of a loaded
        library — i.e. a peer the pairing flow admitted (instance rows
        store ``RemoteIdentity.to_bytes()``). With ``library_id`` the
        check is scoped to THAT library: membership in library X must
        not open library Y's surfaces (the WORK plane hands out work
        and file metadata per library). The instance table is tiny, so
        the scan is cheap per request."""
        if remote_identity is None:
            return False
        try:
            needle = remote_identity.to_bytes()
        except (AttributeError, ValueError):
            return False
        libs = self.node.libraries.libraries
        if library_id is not None:
            lib = libs.get(library_id)
            scan = [lib] if lib is not None else []
        else:
            scan = list(libs.values())
        for lib in scan:
            for row in lib.db.query("SELECT identity FROM instance"):
                if row["identity"] == needle:
                    return True
        return False

    # --- telemetry federation (telemetry/federation.py) ----------------

    async def refresh_federation(self, force: bool = False) -> dict:
        """Pull fresh snapshots from every discovered peer — direct P2P
        first, the cloud relay as fallback for peers we can't reach —
        and return the refreshed mesh view. Pull-through: a peer whose
        cached snapshot is younger than the cache's refresh interval is
        skipped unless ``force``, so a burst of /mesh hits doesn't
        stampede the mesh."""
        due = [
            peer for peer in self.p2p.discovered_peers()
            if force or self.federation.needs_refresh(str(peer.identity))
        ]

        # pulls are independent — run them concurrently so a mesh with
        # several unreachable peers costs ONE telemetry timeout, not N
        # (EOFError covers IncompleteReadError: a peer closing the
        # stream mid-response is a failed pull, not a /mesh 500)
        async def pull(peer: Any) -> tuple[Any, str] | None:
            try:
                snap = await SYNC_POLICY.call(
                    str(peer.identity),
                    lambda peer=peer: request_telemetry(
                        self.p2p, peer.identity
                    ),
                )
                self.federation.store(str(peer.identity), snap,
                                      transport="p2p")
                return None
            except (ConnectionError, OSError, EOFError,
                    asyncio.TimeoutError, ValueError) as e:
                # BreakerOpen is a ConnectionError: a breaker-gated peer
                # still falls through to the relay leg below
                return (peer, str(e))

        results = await asyncio.gather(*(pull(p) for p in due))
        failed = [r for r in results if r is not None]
        # the relay leg costs real HTTP round-trips per cloud-enabled
        # library — run it only when something needs it (unreached
        # peers, relay-tracked peers due a refresh, or an explicit
        # force), not on every dashboard poll
        if failed or force or self.federation.due_relay_peers():
            await self._relay_federation(failed)
        return self.federation.mesh()

    async def _relay_federation(self, failed: list[tuple[Any, str]]) -> None:
        """The cloud-relay fallback. JAX pushes this node's snapshot and
        pulls every other instance's through each cloud-synced library,
        then marks the peers neither route reached as failed. Until cloud
        sync is ported no library has a relay client, so every peer the
        direct pull missed is marked failed."""
        for peer, err in failed:
            self.federation.record_failure(str(peer.identity), err)

    async def pull_remote_spans(
        self, trace_id: str,
    ) -> tuple[list[dict], dict[str, str]]:
        """Distributed-trace assembly (telemetry/attrib.py): pull every
        discovered peer's completed spans for ``trace_id``. Pulls run
        concurrently under the sync-plane resilience policy (per-peer
        breakers — a vanished peer costs one fast failure, never a
        blocked report). Returns ``(spans, failures)``: spans are
        tagged with the serving peer's short-hash label, failures map
        that label to the error string (the report's ``partial``
        evidence)."""
        from ..telemetry import metrics as _tm2
        from ..telemetry.peers import peer_label

        async def pull(peer: Any) -> tuple[str, list[dict] | None, str]:
            label = peer_label(str(peer.identity))
            try:
                spans = await SYNC_POLICY.call(
                    str(peer.identity),
                    lambda peer=peer: request_trace(
                        self.p2p, peer.identity, trace_id
                    ),
                )
                return label, spans, ""
            except (BreakerOpen, ConnectionError, OSError, EOFError,
                    asyncio.TimeoutError, PermissionError, ValueError) as e:
                return label, None, f"{type(e).__name__}: {e}"

        results = await asyncio.gather(
            *(pull(p) for p in self.p2p.discovered_peers())
        )
        spans: list[dict] = []
        failures: dict[str, str] = {}
        for label, got, err in results:
            if got is None:
                failures[label] = err[:200]
                _tm2.ATTRIB_PULL_FAILURES.inc()
                continue
            for rec in got:
                rec = dict(rec)
                rec["node"] = label
                spans.append(rec)
        return spans, failures

    async def pull_remote_profiles(
        self,
    ) -> tuple[dict[str, dict], dict[str, str]]:
        """Mesh profile view (``GET /profile?mesh=1`` / ``sdx
        profile``): pull every discovered peer's host-profile document
        concurrently under the sync-plane resilience policy — a
        vanished peer costs one fast recorded failure and a *partial*
        view, never a block (the trace_pull contract). Returns
        ``(profiles-by-peer-label, failures-by-peer-label)``."""
        from ..telemetry.peers import peer_label

        async def pull(peer: Any) -> tuple[str, dict | None, str]:
            label = peer_label(str(peer.identity))
            try:
                doc = await SYNC_POLICY.call(
                    str(peer.identity),
                    lambda peer=peer: request_profile(
                        self.p2p, peer.identity
                    ),
                )
                return label, doc, ""
            except (BreakerOpen, ConnectionError, OSError, EOFError,
                    asyncio.TimeoutError, PermissionError, ValueError) as e:
                return label, None, f"{type(e).__name__}: {e}"

        results = await asyncio.gather(
            *(pull(p) for p in self.p2p.discovered_peers())
        )
        profiles: dict[str, dict] = {}
        failures: dict[str, str] = {}
        for label, doc, err in results:
            if doc is None:
                failures[label] = err[:200]
            else:
                profiles[label] = doc
        return profiles, failures

    # --- inbound dispatch (ref:manager.rs stream handler) --------------

    async def _handle_stream(self, stream: Any) -> None:
        header = await Header.read(stream)
        P2P_EVENTS.emit(
            "stream_open",
            header=header.type.name,
            peer=str(getattr(stream, "remote_identity", "?")),
        )
        # join the initiator's trace when the header carried one — the
        # responder's spans (and any ingest work they cause) report
        # into the trace of the node that started the operation
        wire_ctx = _trace.TraceContext.from_wire(header.trace)
        with _trace.use(wire_ctx):
            await self._handle_stream_traced(stream, header, wire_ctx)

    async def _handle_stream_traced(
        self, stream: Any, header: Header,
        wire_ctx: "_trace.TraceContext | None",
    ) -> None:
        if header.type == HeaderType.PING:
            w = Writer(stream)
            w.u8(0xAA)
            await w.flush()
        elif header.type == HeaderType.SPACEDROP:
            with _span("p2p.spacedrop_receive"):
                await self.spacedrop.handle_inbound(stream, header.spacedrop)
        elif header.type == HeaderType.SYNC:
            if _faults.hit("p2p.sync_serve") is not None:
                await stream.close()  # peer "vanishes" before the ack
                return
            with _span("p2p.sync_notify"):
                w = Writer(stream)
                w.u8(0x01)
                await w.flush()
                # responder-side tenant accounting: which library's
                # sync traffic this node is serving (hashed label only)
                _tenants.observe("p2p_sync", header.library_id)
                actor = self.ingest_actors.get(header.library_id)
                if actor is not None:
                    actor.notify(trace_ctx=wire_ctx)
        elif header.type == HeaderType.SYNC_REQUEST:
            if _faults.hit("p2p.sync_serve") is not None:
                await stream.close()  # peer "vanishes" mid-exchange
                return
            lib = self.node.libraries.get(header.library_id)
            if lib is not None:
                _tenants.observe("p2p_sync", header.library_id)
                with _span("p2p.sync_serve"):
                    await respond_sync_request(stream, lib.sync)
        elif header.type == HeaderType.FILE:
            if self.node.is_feature_enabled(BackendFeature.FILES_OVER_P2P):
                await respond_file(stream, header.file, self.node.libraries)
            else:
                w = Writer(stream)
                w.u8(0).string("filesOverP2P disabled")
                await w.flush()
        elif header.type == HeaderType.TELEMETRY:
            # served to LIBRARY MEMBERS only: any LAN node can complete
            # a handshake, but the snapshot names libraries, watermarks,
            # and node metadata — the same trust bar the pairing flow
            # sets (FILE and RSPC gate behind features for the same
            # reason; membership is the natural gate for mesh health)
            if self._is_library_member(
                getattr(stream, "remote_identity", None)
            ):
                # TELEMETRY carries no library id — attribute the
                # responder work to the calling instance's identity
                _tenants.observe(
                    "p2p_telemetry",
                    getattr(stream, "remote_identity", None))
                op = (header.telemetry_op or {}).get("op")
                if op == "trace_pull":
                    if _faults.hit("p2p.trace_pull") is not None:
                        await stream.close()  # peer vanishes mid-pull
                        return
                    with _span("p2p.trace_serve"):
                        await respond_trace(
                            stream,
                            (header.telemetry_op or {}).get("trace_id"),
                        )
                elif op == "profile_pull":
                    if _faults.hit("p2p.profile_pull") is not None:
                        await stream.close()  # peer vanishes mid-pull
                        return
                    with _span("p2p.profile_serve"):
                        await respond_profile(stream)
                elif op not in (None, "snapshot"):
                    w = Writer(stream)
                    w.msgpack({"error": f"unknown TELEMETRY op {op!r}"})
                    await w.flush()
                else:
                    with _span("p2p.telemetry_serve"):
                        await respond_telemetry(stream, self.node)
            else:
                w = Writer(stream)
                w.msgpack(
                    {"error": "telemetry is served to library members only"}
                )
                await w.flush()
        elif header.type == HeaderType.WORK:
            # same trust bar as TELEMETRY but scoped to the NAMED
            # library: shard payloads carry that library's paths and
            # stat identities, and a claim hands out its work — strictly
            # members of that specific library
            if self._is_library_member(
                getattr(stream, "remote_identity", None),
                library_id=header.library_id,
            ):
                _tenants.observe("p2p_work", header.library_id)
                with _span("p2p.work_serve"):
                    await _refuse_work(stream)
            else:
                w = Writer(stream)
                w.msgpack(
                    {"error": "the work plane is served to library "
                              "members only"}
                )
                await w.flush()
        elif header.type == HeaderType.RSPC:
            from .rspc import respond_rspc

            await respond_rspc(stream, self.node)
        elif header.type == HeaderType.PAIRING:
            await self.pairing.handle_inbound(stream)
        else:
            logger.warning("unhandled header type %s", header.type)

    async def shutdown(self) -> None:
        self._shutting_down = True
        for unsub in self._unsubs:
            unsub()
        self._unsubs.clear()
        if self._alert_tasks:
            # drain in-flight alerts (don't interrupt a half-sent one);
            # past the grace window they're cancelled. Our own
            # cancellation propagates out of asyncio.wait untouched.
            done, pending = await asyncio.wait(self._alert_tasks, timeout=5.0)
            for task in pending:
                task.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            for task in done:
                if not task.cancelled() and (exc := task.exception()):
                    logger.warning("sync alert task died: %r", exc)
        self._alert_tasks.clear()
        for actor in self.ingest_actors.values():
            await actor.stop()
        self.ingest_actors.clear()
        await self.p2p.shutdown()


async def _refuse_work(stream: Any) -> None:
    """JAX's `respond_work` on a node whose work plane is not running:
    read the request frame, answer the refusal (a frame that is not a
    map gets JAX's malformed-request answer first)."""
    body = await Reader(stream).msgpack()
    w = Writer(stream)
    if not isinstance(body, dict):
        w.msgpack({"error": "malformed WORK request"})
    else:
        w.msgpack({"error": "work plane not running"})
    await w.flush()
