"""HTTP host — rspc endpoint + custom-URI file/thumbnail serving.

Parity: two reference pieces in one app:
- ref:apps/server/src/main.rs — the Axum host exposing `/rspc` (here:
  `POST /rspc/{key}` with `{library_id?, arg?}` JSON, and
  `GET /rspc/ws` carrying queries/mutations/subscriptions over
  websocket frames like rspc's ws transport);
- ref:core/src/custom_uri/mod.rs:152-190 — `/spacedrive/thumbnail/
  <namespace>/<shard>/<cas_id>.webp` (traversal-guarded) and
  `/spacedrive/file/<library_id>/<location_id>/<path…>` with
  range-aware serving + mime sniffing (serve_file.rs; mod.rs:390).

Counterpart of `spacedrive_tpu/api/server.py` on the port's own HTTP/1.1
and websocket layer (utils/http.py) in place of `aiohttp.web`: the same
routes under the same priority classes, the same host guard and
admission middleware, and the same statuses, bodies and ``X-SD-Cache``
states. The explorer's assets are this package's copy (``static/``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import mimetypes
import os
import time
import uuid
from typing import Any

from .. import telemetry
from ..serve import BACKGROUND, CONTROL, INTERACTIVE, Shed, runtime_for
from ..serve.gate import observe_request_seconds
from ..utils import http as web
from ..utils.http import WSMsgType
from .router import Router, RspcError

logger = logging.getLogger(__name__)

CHUNK = 256 * 1024

#: sentinel class for routes whose admission happens per-procedure
#: inside Router.exec (the rspc transports) — the route-level
#: middleware must not double-admit them
RSPC_DEFERRED = "rspc"

# Host values a browser can only produce for a genuinely-local page.
# Anything else on this localhost-bound server means DNS rebinding: a
# hostile page resolving its own domain to 127.0.0.1 to read
# /spacedrive/local and the ephemeralFiles.* procedures cross-origin.
LOCAL_HOSTNAMES = frozenset({"127.0.0.1", "localhost", "::1"})


def _json_default(o: Any) -> Any:
    if isinstance(o, bytes):
        return o.hex()
    if isinstance(o, uuid.UUID):
        return str(o)
    if hasattr(o, "to_wire"):
        return o.to_wire()
    if hasattr(o, "__dict__"):
        return {k: v for k, v in vars(o).items() if not k.startswith("_")}
    return str(o)


def _dumps(obj: Any) -> str:
    return json.dumps(obj, default=_json_default)


class ApiServer:
    def __init__(self, node: Any, router: Router):
        self.node = node
        self.router = router
        self._allowed_hosts = set(LOCAL_HOSTNAMES)
        self._allow_any_host = False
        self._route_classes: dict[tuple[str, str], str] = {}
        self.app = web.Application(
            middlewares=[self._host_guard, self._admission]
        )
        # every route declares its admission priority class through the
        # _gated seam; rspc transports defer to per-procedure classes
        self.app.add_routes(
            [
                self._gated(web.get("/", self._index), INTERACTIVE),
                self._gated(web.get("/metrics", self._metrics), CONTROL),
                self._gated(web.get("/trace", self._trace), BACKGROUND),
                self._gated(web.get("/attrib", self._attrib), BACKGROUND),
                self._gated(web.get("/profile", self._profile), BACKGROUND),
                self._gated(web.get("/tenants", self._tenants), BACKGROUND),
                self._gated(web.get("/health", self._health), CONTROL),
                self._gated(web.get("/mesh", self._mesh), INTERACTIVE),
                self._gated(web.get("/search", self._search), INTERACTIVE),
                self._gated(
                    web.get("/static/{path:.*}", self._static), INTERACTIVE
                ),
                self._gated(
                    web.get("/rspc/client.js", self._client_js), INTERACTIVE
                ),
                self._gated(
                    web.get("/rspc/manifest", self._manifest), INTERACTIVE
                ),
                self._gated(
                    web.post("/rspc/{key}", self._rspc_http), RSPC_DEFERRED
                ),
                self._gated(web.get("/rspc/ws", self._rspc_ws), RSPC_DEFERRED),
                self._gated(
                    web.get(
                        "/spacedrive/thumbnail/{ns}/{shard}/{name}",
                        self._thumbnail,
                    ),
                    INTERACTIVE,
                ),
                self._gated(
                    web.get(
                        "/spacedrive/file/{library_id}/{location_id}/{path:.*}",
                        self._file,
                    ),
                    INTERACTIVE,
                ),
                self._gated(
                    web.get("/spacedrive/local", self._local_file), INTERACTIVE
                ),
            ]
        )
        self._server: web.Server | None = None
        self._client_js_text: str | None = None
        self.port: int | None = None

    # --- lifecycle -----------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        if host in ("", "0.0.0.0", "::"):
            # a DELIBERATE wildcard bind is LAN exposure: clients
            # legitimately arrive under names we cannot enumerate, so
            # the rebinding guard (scoped to the default localhost
            # bind) stands down rather than 403 everyone
            self._allow_any_host = True
        else:
            # explicit non-local binds stay reachable by their own name
            self._allowed_hosts.add(host)
        # no access log: the telemetry layer already counts every request
        self._server = web.Server(self.app)
        self.port = await self._server.start(host or None, port)
        return self.port

    async def shutdown(self) -> None:
        if self._server is not None:
            await self._server.shutdown()
            self._server = None

    async def _host_guard(self, request: web.Request, handler) -> web.StreamResponse:
        """Reject requests whose Host header names anything but this
        machine — closes the DNS-rebinding read path through
        /spacedrive/local and the ephemeralFiles.* procedures
        An absent Host (HTTP/1.0) is local tooling."""
        host = request.headers.get("Host")
        if host and not self._allow_any_host \
                and _hostname_of(host) not in self._allowed_hosts:
            raise web.HTTPForbidden(text="bad host")
        return await handler(request)

    def _gated(self, route: web.Route, klass: str) -> web.Route:
        """Declare a route's admission priority class (the serve-layer
        seam). Returns the route unchanged — the class lands in the
        table the admission middleware resolves against, keyed by the
        CANONICAL path (the regex stripped from ``{name:regex}`` params,
        so pattern routes like ``/static/{path:.*}`` are gated too)."""
        self._route_classes[(route.method, route.canonical)] = klass
        return route

    async def _admission(
        self, request: web.Request, handler
    ) -> web.StreamResponse:
        """Admission-gate every routed request under its declared
        priority class. Shed → 429/``SHED`` + Retry-After, fast. The
        rspc transports pass through — Router.exec admits them under
        the procedure's own class. No serve runtime = the ungated
        pre-serve path, byte-identical."""
        serve = runtime_for(self.node)
        if serve is None:
            return await handler(request)
        canonical = request.route.canonical if request.route is not None else None
        klass = self._route_classes.get((request.method, canonical or ""))
        if klass is None or klass == RSPC_DEFERRED:
            return await handler(request)
        try:
            async with serve.gate.admit(klass, key=canonical or request.path):
                t0 = time.perf_counter()
                try:
                    return await handler(request)
                finally:
                    # admitted request wall time per class — the
                    # interactive series is the interactive_p99 SLO
                    # input (telemetry/slo.py)
                    observe_request_seconds(
                        klass, time.perf_counter() - t0
                    )
        except Shed as e:
            return _shed_response(e)

    async def _metrics(self, _request: web.Request) -> web.Response:
        """Prometheus scrape endpoint over the process registry."""
        return web.Response(
            text=telemetry.render(),
            content_type="text/plain",
            headers={"X-Prometheus-Format": "0.0.4"},
        )

    async def _trace(self, request: web.Request) -> web.Response:
        """Chrome-trace-event JSON of the completed-span ring — download
        and load straight into Perfetto (ui.perfetto.dev) or
        chrome://tracing. `?trace_id=<hex>` filters to one trace."""
        return web.json_response(
            telemetry.trace_export(request.query.get("trace_id") or None),
            headers={"Content-Disposition": "inline; filename=sd-trace.json"},
        )

    async def _attrib(self, request: web.Request) -> web.Response:
        """Critical-path attribution for one distributed trace (default:
        the last completed pass) — device / host_cpu / link /
        queue_wait / gap bucket split plus the critical-path segments
        (telemetry/attrib.py). `?trace_id=<hex>` picks a trace,
        `?refresh=1` bypasses the per-trace report cache and re-pulls
        peers. Cached through the serve meta cache so dashboard polls
        cost one mesh pull per TTL window."""
        from ..telemetry import attrib as _attrib_mod

        trace_id = request.query.get("trace_id") or None
        refresh = request.query.get("refresh") == "1"

        async def load() -> Any:
            return await _attrib_mod.assemble(
                self.node, trace_id, refresh=refresh
            )

        serve = runtime_for(self.node)
        if serve is None or refresh:
            doc = await load()
        else:
            result = await serve.meta.get(
                ("attrib", trace_id or ""),
                load,
                ttl_s=serve.policy.mesh_ttl_s,
                stale_ok=serve.gate.in_brownout(),
            )
            doc = result.value
        return web.json_response(doc, dumps=_dumps)

    async def _tenants(self, request: web.Request) -> web.Response:
        """Per-tenant accounting snapshot (telemetry/tenants.py): the
        full space-saving sketch read — per-surface totals, resident
        top-K with error bounds and latency buckets, fairness index,
        dominant share. Tenant keys are blake2b hashes; raw library/
        instance UUIDs never appear here. Admission-gated BACKGROUND
        like the other observability reads."""
        from ..telemetry import tenants as _tenants_mod

        return web.json_response(_tenants_mod.snapshot(), dumps=_dumps)

    async def _profile(self, request: web.Request) -> web.Response:
        """The continuous host profiler (telemetry/sampler.py):
        collapsed-stack frame groups, on-CPU vs GIL-wait split, and
        triggered deep-capture windows. `?format=folded` serves
        flamegraph.pl collapsed-stack text (pipe into flamegraph.pl or
        speedscope); `?mesh=1` also pulls every reachable peer's
        profile over the TELEMETRY wire (partial on pull failures,
        never blocking). BACKGROUND class — the mesh leg dials peers,
        so it must never ride the unsheddable control class."""
        from ..telemetry import sampler as _sampler_mod

        if request.query.get("format") == "folded":
            return web.Response(
                text=_sampler_mod.SAMPLER.folded(),
                content_type="text/plain",
            )
        if request.query.get("mesh") == "1":
            return web.json_response(
                await _sampler_mod.mesh_profile(self.node), dumps=_dumps
            )
        return web.json_response(
            _sampler_mod.SAMPLER.profile(), dumps=_dumps
        )

    async def _health(self, _request: web.Request) -> web.Response:
        """Per-subsystem → per-node health rollup (telemetry.health).
        503 when unhealthy so load balancers / probes can act on the
        status code alone; the JSON body carries the verdicts."""
        from ..telemetry import health as _health_mod

        verdict = _health_mod.evaluate(self.node)
        return web.json_response(
            verdict,
            status=503 if verdict["status"] == _health_mod.UNHEALTHY else 200,
            dumps=_dumps,
        )

    async def _mesh(self, request: web.Request) -> web.Response:
        """Mesh-wide telemetry: this node's snapshot + the federation
        cache's per-peer view (freshness-marked). Pull-through — the
        request refreshes peers whose snapshot aged past the cache's
        refresh interval; `?refresh=0` reads the cache as-is,
        `?force=1` re-pulls everyone. N concurrent dashboard polls
        collapse onto one refresh + one snapshot computation through
        the serve cache's single-flight (federation.mesh_status_cached)."""
        from ..telemetry.federation import mesh_status_cached

        return web.json_response(
            await mesh_status_cached(
                self.node,
                refresh=request.query.get("refresh") != "0",
                force=request.query.get("force") == "1",
            ),
            dumps=_dumps,
        )

    async def _index(self, _request: web.Request) -> web.FileResponse:
        """The explorer web UI (role parity: ref:interface/ + apps/web)."""
        return web.FileResponse(
            os.path.join(os.path.dirname(__file__), "static", "explorer.html"),
            headers={"Content-Type": "text/html; charset=utf-8"},
        )

    async def _static(self, request: web.Request) -> web.StreamResponse:
        """Explorer assets (traversal-guarded; .js/.css/.json only)."""
        root = os.path.abspath(os.path.join(os.path.dirname(__file__), "static"))
        rel = request.match_info["path"]
        full = os.path.abspath(os.path.join(root, rel))
        if os.path.commonpath([full, root]) != root:
            raise web.HTTPBadRequest(text="bad path")
        if not os.path.isfile(full):
            raise web.HTTPNotFound()
        ctype = {
            ".js": "application/javascript",
            ".css": "text/css",
            ".html": "text/html; charset=utf-8",
            ".json": "application/json",  # i18n catalogs
        }.get(os.path.splitext(full)[1])
        if ctype is None:
            raise web.HTTPNotFound()
        return web.FileResponse(full, headers={"Content-Type": ctype})

    async def _client_js(self, _request: web.Request) -> web.Response:
        """The generated JS client (ref:packages/client/src/core.ts is
        the same artifact, generated from the Rust router). The router
        is fixed after mount, so generate once and cache."""
        if self._client_js_text is None:
            from .client_gen import generate_js

            self._client_js_text = generate_js(self.router.manifest())
        return web.Response(
            text=self._client_js_text,
            content_type="application/javascript",
        )

    async def _manifest(self, _request: web.Request) -> web.Response:
        return web.json_response(self.router.manifest())

    async def _search(self, request: web.Request) -> web.Response:
        """`GET /search?library_id=…&q=…[&take=N]` — the semantic-search
        plane's plain-HTTP face (curl/dashboards; rspc clients use the
        `search.semantic` procedure). Rides the exact same router
        procedure and therefore the same serve byte-cache and tag
        invalidation as the POST transport."""
        lib_id = request.query.get("library_id")
        q = request.query.get("q", "")
        if not lib_id or not q:
            return web.json_response(
                {"error": "library_id and q are required"}, status=400
            )
        arg: dict[str, Any] = {"query": q}
        if "take" in request.query:
            try:
                arg["take"] = int(request.query["take"])
            except ValueError:
                return web.json_response(
                    {"error": "take must be an integer"}, status=400
                )
        try:
            serve = runtime_for(self.node)
            if serve is not None:
                from ..serve import canonical_library_id, query_cache_key

                async def load_bytes() -> bytes:
                    result = await self.router.exec(
                        self.node, "search.semantic", arg, lib_id
                    )
                    return _dumps({"result": result}).encode()

                lib_key = canonical_library_id(lib_id)
                res = await serve.queries.get(
                    ("http",) + query_cache_key("search.semantic", lib_id, arg),
                    load_bytes,
                    tags=(("lib", lib_key), ("q", "search.semantic", lib_key)),
                    stale_ok=serve.gate.in_brownout(),
                )
                if res.state != "miss":
                    # see _rspc_http: hit attribution for the byte layer
                    from ..telemetry import tenants as _tenants_mod

                    _tenants_mod.observe("cache_hit", lib_key)
                return web.Response(
                    body=res.value,
                    content_type="application/json",
                    headers={"X-SD-Cache": res.state},
                )
            result = await self.router.exec(
                self.node, "search.semantic", arg, lib_id
            )
            return web.json_response({"result": result}, dumps=_dumps)
        except RspcError as e:
            return web.json_response(
                {"error": e.message, "code": e.code}, status=e.code
            )

    # --- rspc ----------------------------------------------------------

    async def _rspc_http(self, request: web.Request) -> web.Response:
        key = request.match_info["key"]
        try:
            body = await request.json() if request.can_read_body else {}
        except json.JSONDecodeError:
            return web.json_response({"error": "invalid json"}, status=400)
        try:
            serve = runtime_for(self.node)
            lib_id = body.get("library_id")
            if serve is not None and lib_id is not None:
                from ..serve import (
                    CACHEABLE_QUERIES,
                    canonical_library_id,
                    query_cache_key,
                )

                if key in CACHEABLE_QUERIES:
                    # byte-level response cache: a hot explorer query is
                    # served as pre-encoded bytes — under a stampede the
                    # loop pays one dict lookup + send per request
                    # instead of re-serializing 50 rows each time. Rides
                    # the same tags (and therefore the same local+sync
                    # invalidation) as the router's object cache.
                    arg = body.get("arg")

                    async def load_bytes() -> bytes:
                        result = await self.router.exec(
                            self.node, key, arg, lib_id
                        )
                        return _dumps({"result": result}).encode()

                    lib_key = canonical_library_id(lib_id)
                    res = await serve.queries.get(
                        ("http",) + query_cache_key(key, lib_id, arg),
                        load_bytes,
                        tags=(("lib", lib_key), ("q", key, lib_key)),
                        stale_ok=serve.gate.in_brownout(),
                    )
                    if res.state != "miss":
                        # byte-cache hits never reach the router (that's
                        # the point), so the tenant attribution the
                        # object-cache tap would have made happens here;
                        # misses fall through to load_bytes and tap once
                        # inside the router's cache
                        from ..telemetry import tenants as _tenants_mod

                        _tenants_mod.observe("cache_hit", lib_key)
                    return web.Response(
                        body=res.value,
                        content_type="application/json",
                        headers={"X-SD-Cache": res.state},
                    )
            result = await self.router.exec(
                self.node, key, body.get("arg"), body.get("library_id")
            )
            return web.json_response({"result": result}, dumps=_dumps)
        except RspcError as e:
            headers = {}
            retry_after = getattr(e, "retry_after_s", None)
            if e.code == 429 and retry_after is not None:
                # admission-gate shed: tell well-behaved clients when
                # to come back instead of letting them hammer
                headers["Retry-After"] = str(max(1, round(retry_after)))
            return web.json_response(
                {"error": e.message, "code": e.code}, status=e.code,
                headers=headers,
            )
        except Exception as e:  # surface like rspc's internal error
            logger.exception("procedure %s failed", key)
            return web.json_response({"error": str(e), "code": 500}, status=500)

    async def _rspc_ws(self, request: web.Request) -> web.WebSocketResponse:
        """rspc ws transport: {id, key, arg?, library_id?, type:
        query|mutation|subscriptionAdd|subscriptionRemove}."""
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        subs: dict[str, asyncio.Task] = {}
        try:
            async for msg in ws:
                if msg.type != WSMsgType.TEXT:
                    continue
                try:
                    req = json.loads(msg.data)
                    mid = req.get("id")
                    kind = req.get("type", "query")
                    if kind in ("query", "mutation"):
                        try:
                            result = await self.router.exec(
                                self.node,
                                req["key"],
                                req.get("arg"),
                                req.get("library_id"),
                            )
                            await ws.send_str(
                                _dumps({"id": mid, "result": result})
                            )
                        except RspcError as e:
                            await ws.send_str(
                                _dumps({"id": mid, "error": e.message, "code": e.code})
                            )
                    elif kind == "subscriptionAdd":
                        try:
                            gen = self.router.subscribe(
                                self.node,
                                req["key"],
                                req.get("arg"),
                                req.get("library_id"),
                            )
                        except RspcError as e:
                            await ws.send_str(
                                _dumps({"id": mid, "error": e.message, "code": e.code})
                            )
                            continue

                        async def pump(gen=gen, mid=mid):
                            async for event in gen:
                                await ws.send_str(
                                    _dumps({"id": mid, "event": event})
                                )

                        prev = subs.pop(mid, None)
                        if prev is not None:
                            prev.cancel()  # duplicate id replaces, not orphans
                        subs[mid] = asyncio.ensure_future(pump())
                    elif kind == "subscriptionRemove":
                        task = subs.pop(mid, None)
                        if task is not None:
                            task.cancel()
                except Exception as e:
                    logger.exception("ws message failed")
                    try:
                        await ws.send_str(_dumps({"error": str(e)}))
                    except Exception:
                        break
        finally:
            for task in subs.values():
                task.cancel()
        return ws

    # --- custom uri ----------------------------------------------------

    async def _thumbnail(self, request: web.Request) -> web.StreamResponse:
        """Traversal-guarded webp serving (ref:custom_uri/mod.rs:152-190)."""
        ns = request.match_info["ns"]
        shard = request.match_info["shard"]
        name = request.match_info["name"]
        if not name.endswith(".webp"):
            raise web.HTTPBadRequest(text="not a webp")
        cas_id = name[: -len(".webp")]
        # the guard: every component must be clean hex/uuid-ish, no traversal
        for part in (ns, shard, cas_id):
            if not part or "/" in part or "\\" in part or ".." in part:
                raise web.HTTPBadRequest(text="bad path")
        store = self.node.thumbnailer.store
        path = os.path.join(store.root, ns, shard, name)
        if os.path.commonpath(
            [os.path.abspath(path), os.path.abspath(store.root)]
        ) != os.path.abspath(store.root):
            raise web.HTTPBadRequest(text="bad path")
        serve = runtime_for(self.node)
        if serve is not None:
            # byte cache: thumbnails are content-addressed (the webp for
            # a cas_id never changes), so a miss loads once and a hot
            # explorer grid stops touching the disk. Absent files are
            # NOT cached — a freshly generated thumbnail appears on the
            # next request.
            async def load() -> bytes:
                def read() -> bytes:
                    with open(path, "rb") as f:
                        return f.read()

                try:
                    return await asyncio.to_thread(read)
                except OSError:
                    raise web.HTTPNotFound()

            # ns is the owning library's id string, so thumb reads
            # attribute to the tenant whose grid is hot
            result = await serve.thumbs.get(
                (ns, shard, name), load, weigh=len, tenant=ns,
            )
            return web.Response(
                body=result.value,
                headers={
                    "Content-Type": "image/webp",
                    "Cache-Control": "max-age=86400",
                    "X-SD-Cache": result.state,
                },
            )
        if not os.path.isfile(path):
            raise web.HTTPNotFound()
        return web.FileResponse(
            path, headers={"Content-Type": "image/webp", "Cache-Control": "max-age=86400"}
        )

    async def _file(self, request: web.Request) -> web.StreamResponse:
        """Range-aware file serving out of a location
        (ref:custom_uri/serve_file.rs + mod.rs:390 mime sniff)."""
        try:
            lib_id = uuid.UUID(request.match_info["library_id"])
        except ValueError:
            raise web.HTTPBadRequest(text="bad library id")
        lib = self.node.libraries.get(lib_id)
        if lib is None:
            raise web.HTTPNotFound(text="library")
        loc = lib.db.find_one("location", id=int(request.match_info["location_id"]))
        if loc is None:
            raise web.HTTPNotFound(text="location")
        rel = request.match_info["path"]
        full = os.path.abspath(os.path.join(loc["path"], rel))
        loc_root = os.path.abspath(loc["path"])
        if os.path.commonpath([full, loc_root]) != loc_root:
            raise web.HTTPBadRequest(text="bad path")
        if not os.path.isfile(full):
            # the file may live on another node: ServeFrom::Remote
            # (ref:custom_uri/mod.rs:240-268 streams it over P2P)
            remote = await self._serve_remote(request, lib, loc, rel)
            if remote is not None:
                return remote
            raise web.HTTPNotFound()
        ctype = mimetypes.guess_type(full)[0] or _sniff_mime(full)
        # FileResponse implements Range (206/Content-Range/416, incl.
        # suffix ranges) correctly — don't re-implement it
        return web.FileResponse(
            full,
            headers={"Content-Type": ctype, "Accept-Ranges": "bytes"},
        )

    async def _local_file(self, request: web.Request) -> web.StreamResponse:
        """Range-aware serving of a NON-INDEXED local path — the
        ephemeral browse's preview source (the reference's custom URI
        serves ephemeral paths the same way for ephemeral.tsx). Trust
        model: identical to the ephemeralFiles.* procedures on the same
        localhost API (which already list/rename/delete arbitrary local
        paths); this route only adds read."""
        raw = request.query.get("path", "")
        full = os.path.abspath(raw)
        if not raw or not os.path.isabs(raw):
            raise web.HTTPBadRequest(text="absolute path required")
        if not os.path.isfile(full):
            raise web.HTTPNotFound()
        ctype = mimetypes.guess_type(full)[0] or _sniff_mime(full)
        return web.FileResponse(
            full,
            headers={"Content-Type": ctype, "Accept-Ranges": "bytes"},
        )


    async def _serve_remote(
        self, request: web.Request, lib: Any, loc: dict[str, Any], rel: str
    ) -> web.StreamResponse | None:
        """Pull a file owned by another instance over P2P and serve it
        (ref:custom_uri/mod.rs ServeFrom::Remote)."""
        import io

        from ..files.isolated_path import IsolatedFilePathData
        from ..node.config import BackendFeature

        p2p = self.node.p2p
        if p2p is None or not self.node.is_feature_enabled(
            BackendFeature.FILES_OVER_P2P
        ):
            return None
        iso = IsolatedFilePathData.from_relative_str(
            loc["id"], rel.replace(os.sep, "/"), False
        )
        row = lib.db.find_one(
            "file_path",
            location_id=loc["id"],
            materialized_path=iso.materialized_path,
            name=iso.name,
            extension=iso.extension,
        )
        if row is None:
            return None
        # owner instance first when known (instance_id is a local-only
        # cache, ref:schema.prisma:126), then every other library peer
        peers = []
        if loc.get("instance_id") is not None:
            inst = lib.db.find_one("instance", id=loc["instance_id"])
            if inst is not None:
                peer = p2p.peer_for_instance(uuid.UUID(bytes=inst["pub_id"]))
                if peer is not None:
                    peers.append(peer)
        for peer in p2p.peers_for_library(lib.id):
            if peer not in peers:
                peers.append(peer)
        from ..p2p.block import Range as BlockRange
        from ..p2p.operations import FILE_POLICY, request_file

        # honor HTTP Range: fetch only the requested span over P2P
        from ..db.database import blob_u64

        total = blob_u64(row.get("size_in_bytes_bytes")) or 0
        try:
            rng = request.http_range
            start, stop = rng.start, rng.stop
        except ValueError:
            raise web.HTTPRequestRangeNotSatisfiable()
        ranged = start is not None or stop is not None
        if ranged:
            start = start if start is not None else 0
            if start < 0:  # suffix range bytes=-N
                start = max(0, total + start)
            stop = min(stop, total) if stop is not None else total
            if total and start >= total:
                raise web.HTTPRequestRangeNotSatisfiable(
                    headers={"Content-Range": f"bytes */{total}"}
                )
            block_range = BlockRange(start, stop)
        else:
            block_range = BlockRange()

        ctype = mimetypes.guess_type(rel)[0] or "application/octet-stream"
        for peer in peers:
            sink = _StreamSink()
            # single-shot policy: the breaker fast-fails a gone peer so
            # the fallthrough tries the next one without a dial timeout
            fetch = asyncio.ensure_future(
                FILE_POLICY.call(
                    str(peer.identity),
                    lambda peer=peer, sink=sink: request_file(
                        p2p.p2p, peer.identity, lib.id,
                        uuid.UUID(bytes=row["pub_id"]), sink,
                        range=block_range,
                    ),
                )
            )
            try:
                # wait for the first block before committing a response,
                # so a failed peer falls through to the next one
                first = await sink.next_chunk(fetch)
            except Exception as e:
                logger.debug("remote fetch from %s failed: %s", peer.identity, e)
                continue
            if ranged:
                resp = web.StreamResponse(
                    status=206,
                    headers={
                        "Content-Type": ctype,
                        "Content-Range": f"bytes {start}-{stop - 1}/{total}",
                        "Accept-Ranges": "bytes",
                    },
                )
            else:
                resp = web.StreamResponse(
                    headers={"Content-Type": ctype, "Accept-Ranges": "bytes"}
                )
            await resp.prepare(request)
            if first is not None:
                await resp.write(first)
                while (chunk := await sink.next_chunk(fetch)) is not None:
                    await resp.write(chunk)
            await fetch
            await resp.write_eof()
            return resp
        return None


class _StreamSink:
    """File-like sink bridging Transfer.receive's synchronous writes
    into an async chunk stream (blocks arrive on the same loop)."""

    def __init__(self) -> None:
        self._chunks: list[bytes] = []
        self._event = asyncio.Event()

    def write(self, data: bytes) -> None:
        self._chunks.append(data)
        self._event.set()

    async def next_chunk(self, fetch: "asyncio.Future") -> bytes | None:
        """Next block, or None when the transfer completed; re-raises
        the fetch task's error (incl. before the first block)."""
        while not self._chunks:
            if fetch.done():
                fetch.result()  # raises on failure
                return None
            self._event.clear()
            done, _pending = await asyncio.wait(
                [fetch, asyncio.ensure_future(self._event.wait())],
                return_when=asyncio.FIRST_COMPLETED,
            )
            for task in _pending:
                if task is not fetch:
                    task.cancel()
        return self._chunks.pop(0)


def _shed_response(e: Shed) -> web.Response:
    """The fast-fail shed answer: 429, machine-readable ``SHED`` body,
    Retry-After so clients back off instead of retrying hot."""
    return web.json_response(
        {"error": "SHED", "class": e.klass, "reason": e.reason},
        status=429,
        headers={"Retry-After": str(max(1, round(e.retry_after_s)))},
    )


def _hostname_of(host: str) -> str:
    """Hostname from a Host header value: strips :port, unwraps IPv6
    brackets, lowercases, drops a trailing FQDN dot."""
    host = host.strip().lower()
    if host.startswith("["):  # [::1]:port
        return host.partition("]")[0].lstrip("[")
    return host.rsplit(":", 1)[0].rstrip(".") if host else host


def _sniff_mime(path: str) -> str:
    """First-bytes sniff fallback (ref:custom_uri/mod.rs:390 infer)."""
    try:
        with open(path, "rb") as f:
            head = f.read(16)
    except OSError:
        return "application/octet-stream"
    if head.startswith(b"\xff\xd8\xff"):
        return "image/jpeg"
    if head.startswith(b"\x89PNG"):
        return "image/png"
    if head.startswith(b"RIFF") and head[8:12] == b"WEBP":
        return "image/webp"
    if head.startswith(b"GIF8"):
        return "image/gif"
    if head[4:8] == b"ftyp":
        return "video/mp4"
    if head.startswith(b"%PDF"):
        return "application/pdf"
    return "application/octet-stream"
