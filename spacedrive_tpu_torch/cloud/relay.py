"""Cloud relay server — the WAN sync rendezvous.

Counterpart of `spacedrive_tpu/cloud/relay.py`. The reference's
closed-source Spacedrive cloud exposes libraries / instances / sync
*message collections* over REST
(ref:crates/cloud-api/src/lib.rs:35-61,120,203,359-448,485); this relay
ships that surface so WAN sync is self-hostable. It stores, per library,
the registered instances and each instance's append-only op-collection
log. Collections are opaque MessagePack blobs
(CompressedCRDTOperations.pack()) keyed by a monotonically increasing
row id; receivers poll with `from_id` cursors like the reference's
`messageCollections.get(instanceTimestamps)` flow. The HTTP layer is
the port's own (utils/http.py) where JAX serves an `aiohttp.web`
application; statuses and bodies are JAX's.

Endpoints (JSON bodies; op payloads base64):
  POST /api/libraries                         {uuid, name}
  GET  /api/libraries/{lib}
  POST /api/libraries/{lib}/instances         {uuid, identity}
  GET  /api/libraries/{lib}/instances
  POST /api/libraries/{lib}/messageCollections     push one collection
  POST /api/libraries/{lib}/messageCollections/get  pull w/ cursors
  POST /api/libraries/{lib}/telemetry              push a snapshot
  POST /api/libraries/{lib}/telemetry/get          pull the others'
"""

from __future__ import annotations

import asyncio
import base64
import itertools
import json as _json
import time
from typing import Any

from ..telemetry import span as _span
from ..telemetry import tenants as _tenants
from ..telemetry import trace as _trace
from ..utils import faults as _faults
from ..utils import http


async def _fault_middleware(request: http.Request, handler):
    """The ``relay.http`` injection point: 500s, slow responses, and
    truncated bodies, exercised against the CLIENT's retry/breaker
    policy (a production relay never ships with a plan installed)."""
    spec = _faults.hit("relay.http")
    if spec is None:
        return await handler(request)
    if spec.mode == "500":
        return http.Response(status=500, text="injected relay failure")
    if spec.mode == "timeout":
        await asyncio.sleep(spec.delay_s)
        return await handler(request)
    # "truncate": advertise the full body, send half, then drop the
    # connection — the client sees a mid-body EOF
    resp = await handler(request)
    body = resp.body if isinstance(getattr(resp, "body", None), (bytes, bytearray)) else b""
    out = http.StreamResponse(status=resp.status)
    out.content_length = max(len(body), 2)
    await out.prepare(request)
    await out.write(bytes(body[: len(body) // 2]))
    transport = request.transport
    if transport is not None:
        transport.close()
    return out


# HTTP header carrying the telemetry.trace wire dict (JSON) so relay
# spans join the calling node's trace
TRACE_HEADER = "X-SD-Trace"
# HTTP header naming the pushing instance on telemetry federation
# calls (body `instance_uuid` is the fallback)
INSTANCE_HEADER = "X-SD-Instance"


def _request_trace(request: http.Request) -> "_trace.TraceContext | None":
    raw = request.headers.get(TRACE_HEADER)
    if not raw:
        return None
    try:
        return _trace.TraceContext.from_wire(_json.loads(raw))
    except ValueError:
        return None


class CloudRelay:
    def __init__(self, p2p_limits=None) -> None:
        self.libraries: dict[str, dict[str, Any]] = {}
        self._collection_ids = itertools.count(1)
        self.app = http.Application(middlewares=[_fault_middleware])
        self.app.add_routes(
            [
                http.post("/api/libraries", self._create_library),
                http.get("/api/libraries/{lib}", self._get_library),
                http.post("/api/libraries/{lib}/instances", self._add_instance),
                http.get("/api/libraries/{lib}/instances", self._list_instances),
                http.post("/api/libraries/{lib}/messageCollections", self._push),
                http.post("/api/libraries/{lib}/messageCollections/get", self._pull),
                http.post("/api/libraries/{lib}/telemetry", self._telemetry_push),
                http.post("/api/libraries/{lib}/telemetry/get", self._telemetry_pull),
            ]
        )
        self._server: http.Server | None = None
        self.port: int | None = None
        # WAN P2P rendezvous (p2p/relay.py): relayed Spacedrop /
        # files-over-P2P for non-LAN peers, not just sync
        from ..p2p.relay import RelayServer

        self.p2p_relay = RelayServer(limits=p2p_limits)
        self.p2p_port: int | None = None

    async def start(self, host: str = "127.0.0.1", port: int = 0,
                    p2p_port: int = 0) -> int:
        self._server = http.Server(self.app)
        self.port = await self._server.start(host, port)
        self.p2p_port = await self.p2p_relay.start(host, p2p_port)
        return self.port

    async def shutdown(self) -> None:
        await self.p2p_relay.shutdown()
        if self._server is not None:
            await self._server.shutdown()
            self._server = None

    # --- handlers ------------------------------------------------------

    def _lib(self, request: http.Request) -> dict[str, Any]:
        lib = self.libraries.get(request.match_info["lib"])
        if lib is None:
            raise http.HTTPNotFound(text="library")
        return lib

    async def _create_library(self, request: http.Request) -> http.Response:
        body = await request.json()
        lib_id = body["uuid"]
        self.libraries.setdefault(
            lib_id,
            {"uuid": lib_id, "name": body.get("name", ""), "instances": {},
             "collections": []},
        )
        return http.json_response({"uuid": lib_id})

    async def _get_library(self, request: http.Request) -> http.Response:
        lib = self._lib(request)
        return http.json_response({"uuid": lib["uuid"], "name": lib["name"]})

    async def _add_instance(self, request: http.Request) -> http.Response:
        lib = self._lib(request)
        body = await request.json()
        lib["instances"][body["uuid"]] = {
            "uuid": body["uuid"],
            "identity": body.get("identity"),
            "node_name": body.get("node_name", ""),
        }
        return http.json_response({"ok": True})

    async def _list_instances(self, request: http.Request) -> http.Response:
        lib = self._lib(request)
        return http.json_response(list(lib["instances"].values()))

    async def _push(self, request: http.Request) -> http.Response:
        lib = self._lib(request)
        body = await request.json()
        with _trace.use(_request_trace(request)), _span("relay.push"):
            instance = body["instance_uuid"]
            if instance not in lib["instances"]:
                raise http.HTTPBadRequest(text="unknown instance")
            cid = next(self._collection_ids)
            lib["collections"].append(
                {
                    "id": cid,
                    "instance_uuid": instance,
                    "contents": body["contents"],  # base64 packed ops
                }
            )
            # the relay is the one surface every tenant's every device
            # hits — attribute pushes (and their payload weight) to
            # the library so a hot tenant is visible
            tenant = request.match_info.get("lib")
            _tenants.observe("relay_push", tenant)
            _tenants.observe_bytes(tenant, len(body["contents"]),
                                   outbound=False)
            return http.json_response({"id": cid})

    async def _pull(self, request: http.Request) -> http.Response:
        """Collections from OTHER instances after the caller's cursors:
        body {instance_uuid, cursors: {instance_uuid: last_seen_id}}."""
        lib = self._lib(request)
        body = await request.json()
        with _trace.use(_request_trace(request)), _span("relay.pull"):
            me = body["instance_uuid"]
            cursors = {k: int(v) for k, v in body.get("cursors", {}).items()}
            out = [
                c
                for c in lib["collections"]
                if c["instance_uuid"] != me
                and c["id"] > cursors.get(c["instance_uuid"], 0)
            ]
            page = out[: int(body.get("count", 100))]
            tenant = request.match_info.get("lib")
            _tenants.observe("relay_pull", tenant)
            _tenants.observe_bytes(
                tenant, sum(len(c["contents"]) for c in page),
                outbound=True)
            return http.json_response(page)

    # --- telemetry federation fallback (telemetry/federation.py) -------
    # Nodes without a direct P2P route to a peer exchange compact
    # snapshots through here: each instance pushes its latest snapshot
    # (overwrite, not append — only the freshest matters), and pulls
    # every OTHER instance's copy with its relay-side age, so the
    # puller's staleness clock keeps running while a snapshot sits here.

    async def _telemetry_push(self, request: http.Request) -> http.Response:
        lib = self._lib(request)
        body = await request.json()
        with _trace.use(_request_trace(request)), _span("relay.telemetry_push"):
            instance = request.headers.get(INSTANCE_HEADER) \
                or (body.get("instance_uuid") if isinstance(body, dict)
                    else None)
            if instance not in lib["instances"]:
                raise http.HTTPBadRequest(text="unknown instance")
            snapshot = body.get("snapshot") if isinstance(body, dict) else None
            if not isinstance(snapshot, dict):
                # a malformed push is the CLIENT's error — 400, not a
                # 500; the relay stores any dict shape (version checking
                # is the puller's job, snapshot_compatible)
                raise http.HTTPBadRequest(text="snapshot must be an object")
            lib.setdefault("telemetry", {})[instance] = {
                "snapshot": snapshot,
                "pushed_at": time.time(),
            }
            return http.json_response({"ok": True})

    async def _telemetry_pull(self, request: http.Request) -> http.Response:
        lib = self._lib(request)
        body = await request.json()
        with _trace.use(_request_trace(request)), _span("relay.telemetry_pull"):
            me = request.headers.get(INSTANCE_HEADER) \
                or body.get("instance_uuid")
            now = time.time()
            out = [
                {
                    "instance_uuid": inst,
                    "snapshot": entry["snapshot"],
                    "age_seconds": round(now - entry["pushed_at"], 3),
                }
                for inst, entry in lib.get("telemetry", {}).items()
                if inst != me
            ]
            return http.json_response(out)


def b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def unb64(data: str) -> bytes:
    return base64.b64decode(data)
