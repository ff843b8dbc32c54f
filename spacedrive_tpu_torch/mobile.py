"""Mobile core bridge — the embedded host the mobile apps link against.

Parity: ref:apps/mobile/modules/sd-core/core/src/lib.rs — the reference
compiles the core INTO the app and exposes exactly two functions to the
JS side: `handle_core_msg(query, data_dir, callback)` (lazy-inits the
node on first use, executes one JSON-RPC request or a batch, answers
through a callback) and `spawn_core_event_listener(callback)` (the
subscription event channel). The platform shims (JNI on Android, ObjC
on iOS — `sd-core/{android,ios}/crate`) are thin marshalling wrappers
around those two calls.

This module is the same surface, TPU-native: a dedicated background
event loop owns ONE Node (the RUNTIME/NODE statics), both entry points
are callable from ANY foreign thread (the platform shims call in from
JS/JNI threads), and callbacks fire off-loop exactly like the
reference's. Message format is JSON-RPC shaped like rspc's:

    request:  {"id": .., "method": "<procedure key>",
               "params": {"arg": .., "library_id": ..}}    (or a list)
    response: {"jsonrpc": "2.0", "id": ..,
               "result": {"type": "response", "data": ..}}
            | {"id": .., "result": {"type": "error",
               "data": {"code": .., "message": ..}}}

Subscriptions: a request whose method is a subscription procedure
upgrades — the immediate response is `{"type": "started"}` and every
yielded value arrives on the event listener as
`{"id": .., "result": {"type": "event", "data": ..}}` until a
`{"method": "subscriptionStop", "params": {"id": ..}}` request or
core shutdown (the reference's SUBSCRIPTIONS map + oneshot cancel).

Embedding note: on-device the platform shim hosts CPython (libpython +
this package) and binds these two functions over the same string/
callback ABI the reference's JNI/ObjC shims use; everything below the
bridge line is identical to the desktop/server hosts — same Router,
same Node, same library data dir.

Counterpart of `spacedrive_tpu/mobile.py`. The Node runs on the card:
``handle_core_msg`` takes a keyword-only ``device`` ("cuda" by default,
"cpu" only when the caller asks), read when the first message builds
the Node, so the two-function ABI stays as it is.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Any, Callable

# the server host's serializer (bytes→hex, UUID→str, to_wire/__dict__
# fallbacks): router payloads are NOT all JSON-native, and a plain
# json.dumps here would kill subscriptions the ws transport serves fine
from .api.server import _dumps

_lock = threading.Lock()
_loop: asyncio.AbstractEventLoop | None = None
_thread: threading.Thread | None = None
_node: Any = None
_init_lock: asyncio.Lock | None = None
_event_cb: Callable[[str], None] | None = None
_subscriptions: dict[Any, asyncio.Task] = {}


def _runtime() -> asyncio.AbstractEventLoop:
    """The RUNTIME static: one background loop thread, lazily started."""
    global _loop, _thread
    with _lock:
        if _loop is not None and _thread is not None and _thread.is_alive():
            return _loop
        loop = asyncio.new_event_loop()

        def run() -> None:
            asyncio.set_event_loop(loop)
            loop.run_forever()

        t = threading.Thread(target=run, name="sdx-mobile-core", daemon=True)
        t.start()
        _loop, _thread = loop, t
        return loop


async def _ensure_node(data_dir: str, device: str):
    """The NODE static: lazy-init on the first message (ref:lib.rs:72-87).
    The lock serializes concurrent FIRST messages — without it two
    early calls would both start Nodes on the same data dir and leak
    one of them."""
    global _node, _init_lock
    if _init_lock is None:
        _init_lock = asyncio.Lock()
    async with _init_lock:
        if _node is not None:
            return _node
        from .node.node import Node

        node = Node(data_dir, device=device)
        await node.start()
        _node = node
        return node


def _error_response(req_id: Any, code: int, message: str) -> dict[str, Any]:
    return {"jsonrpc": "2.0", "id": req_id,
            "result": {"type": "error",
                       "data": {"code": code, "message": message}}}


async def _run_one(node, request: dict[str, Any]) -> dict[str, Any] | None:
    from .api.router import RspcError

    req_id = request.get("id")
    method = str(request.get("method", ""))
    params = request.get("params") or {}
    arg = params.get("arg")
    library_id = params.get("library_id")

    if method == "subscriptionStop":
        task = _subscriptions.pop(params.get("id"), None)
        if task is not None:
            task.cancel()
        return {"jsonrpc": "2.0", "id": req_id,
                "result": {"type": "response", "data": None}}

    proc = node.router.procedures.get(method)
    if proc is None:
        return _error_response(req_id, 404, f"procedure {method!r}")
    if proc.kind == "subscription":
        if _event_cb is None:
            return _error_response(
                req_id, 400,
                "no event listener: call spawn_core_event_listener first")
        if req_id in _subscriptions:
            return _error_response(req_id, 400, f"id {req_id!r} in use")
        try:
            # resolution errors (unknown proc shape, bad library_id)
            # raise HERE, before "started" is promised — the ws
            # transport answers these on the request too
            agen = node.router.subscribe(node, method, arg, library_id)
        except RspcError as e:
            return _error_response(req_id, e.code, e.message)

        async def pump() -> None:
            try:
                async for item in agen:
                    cb = _event_cb
                    if cb is None:
                        break
                    cb(_dumps({
                        "jsonrpc": "2.0", "id": req_id,
                        "result": {"type": "event", "data": item},
                    }))
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - surfaced to the app
                cb = _event_cb
                if cb is not None:
                    cb(_dumps(_error_response(req_id, 500, str(e))))
            finally:
                _subscriptions.pop(req_id, None)

        _subscriptions[req_id] = asyncio.get_running_loop().create_task(pump())
        return {"jsonrpc": "2.0", "id": req_id,
                "result": {"type": "started"}}

    try:
        data = await node.router.exec(node, method, arg, library_id)
        return {"jsonrpc": "2.0", "id": req_id,
                "result": {"type": "response", "data": data}}
    except RspcError as e:
        return _error_response(req_id, e.code, e.message)
    except Exception as e:  # noqa: BLE001 - the app gets a clean error
        return _error_response(req_id, 500, f"{type(e).__name__}: {e}")


def handle_core_msg(query: str, data_dir: str,
                    callback: Callable[[str], None], *, device: str = "cuda") -> None:
    """Entry point #1 (ref:lib.rs:65): execute one request or a batch.
    Callable from any thread; `callback` receives the JSON response
    array (always an array, like the reference's join_all collect).
    ``device`` places the Node the first message builds."""
    loop = _runtime()

    async def work() -> None:
        try:
            await _work_inner()
        except Exception as e:  # noqa: BLE001 - the callback MUST fire:
            # a swallowed exception here leaves the app-side promise
            # waiting forever
            try:
                callback(_dumps([_error_response(None, 500,
                                                 f"bridge: {e}")]))
            except Exception:  # noqa: BLE001 - nothing left to tell
                pass

    async def _work_inner() -> None:
        try:
            parsed = json.loads(query)
        except ValueError:
            # decode failures echo the query back as the error, exactly
            # like the reference (ref:lib.rs:95-99 — which also decodes
            # BEFORE touching the NODE static: garbage input must not
            # pay full core startup)
            callback(_dumps([_error_response(None, 400, query)]))
            return
        try:
            node = await _ensure_node(data_dir, device)
        except Exception as e:  # noqa: BLE001 - init failure → app dialog
            callback(_dumps([_error_response(None, 500,
                                             f"core init: {e}")]))
            return
        reqs = parsed if isinstance(parsed, list) else [parsed]

        async def one(req):
            if not isinstance(req, dict):
                return _error_response(None, 400, "bad request")
            if not isinstance(req.get("id"), (str, int, float, type(None))):
                return _error_response(None, 400,
                                       "id must be a string, number or null")
            return await _run_one(node, req)

        # concurrent like the reference's join_all; gather preserves
        # response order
        responses = await asyncio.gather(*(one(r) for r in reqs))
        callback(_dumps([r for r in responses if r is not None]))

    asyncio.run_coroutine_threadsafe(work(), loop)


def spawn_core_event_listener(callback: Callable[[str], None]) -> None:
    """Entry point #2 (ref:lib.rs:123): register the subscription event
    channel. Last registration wins (hot-reload of the JS side)."""
    global _event_cb
    _event_cb = callback


def shutdown_core(timeout: float = 15.0) -> None:
    """Tear the embedded core down (app background/exit): cancel
    subscriptions, node shutdown, stop the runtime loop. Best-effort
    against in-flight messages: the init lock is awaited so a Node
    whose start() is mid-flight is captured and shut down, not leaked;
    a teardown that overruns `timeout` still stops the loop."""
    global _node, _loop, _thread, _event_cb, _init_lock
    with _lock:
        loop, thread = _loop, _thread
        _loop = _thread = None
        _event_cb = None
    if loop is None or thread is None or not thread.is_alive():
        _node = None
        _init_lock = None
        return

    async def stop() -> None:
        global _node
        for task in list(_subscriptions.values()):
            task.cancel()
        if _subscriptions:
            await asyncio.gather(*_subscriptions.values(),
                                 return_exceptions=True)
        _subscriptions.clear()
        # wait out any in-flight _ensure_node so ITS node is the one we
        # shut down (reading the global, not a pre-teardown snapshot)
        if _init_lock is not None:
            async with _init_lock:
                node, _node = _node, None
        else:
            node, _node = _node, None
        if node is not None:
            await node.shutdown()

    fut = asyncio.run_coroutine_threadsafe(stop(), loop)
    try:
        fut.result(timeout)
    except Exception:  # noqa: BLE001 - teardown is best-effort; the
        pass           # loop still stops below either way
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout)
        if not thread.is_alive():
            # the selector + self-pipe fds leak per background/
            # foreground cycle otherwise
            loop.close()
        _subscriptions.clear()
        _node = None
        _init_lock = None
