"""rspc-over-P2P — drive another node's API across the mesh.

Parity: ref:core/src/p2p/operations/rspc.rs:13 — a `Header::Http`-style
stream that tunnels API requests to a remote node, used by the frontend
to browse *other* devices. Here the frame is msgpack
`{key, arg, library_id}` → `{ok, result | error, code}` over one
authenticated stream per request; query/mutation only (subscriptions
stay local, as in the reference).

Counterpart of `spacedrive_tpu/p2p/rspc.py`: the same frames, the same
`remoteRspc` gate and the same queries-only rule, over the port's
router.
"""

from __future__ import annotations

from typing import Any

from ..api.router import RspcError
from ..utils.resilience import PASS, RETRY, ResiliencePolicy, RetryPolicy
from .identity import RemoteIdentity
from .protocol import Header, HeaderType
from .wire import Reader, Writer


class RemoteRspcError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _classify(exc: BaseException) -> str:
    """A peer that ANSWERED (refusal, bad procedure) must neither retry
    nor feed the breaker; only transport failures count."""
    if isinstance(exc, (RemoteRspcError, PermissionError, ValueError)):
        return PASS
    return RETRY


#: policy for remote-rspc call sites (queries are idempotent by the
#: responder's own restriction, so a bounded retry is safe)
RSPC_POLICY = ResiliencePolicy(
    "p2p_rspc",
    RetryPolicy(max_attempts=2, base_delay=0.05, max_delay=0.5,
                attempt_timeout=30.0),
    failure_threshold=3,
    reset_timeout=15.0,
    classify=_classify,
)


async def remote_exec(
    p2p: Any,
    identity: RemoteIdentity,
    key: str,
    arg: Any = None,
    library_id: str | None = None,
) -> Any:
    """Run one procedure on a remote node (ref:operations/rspc.rs)."""
    stream = await p2p.new_stream(identity)
    try:
        await Header(HeaderType.RSPC).write(stream)
        w = Writer(stream)
        w.msgpack({"key": key, "arg": arg, "library_id": library_id})
        await w.flush()
        resp = await Reader(stream).msgpack()
        if not resp.get("ok"):
            raise RemoteRspcError(
                int(resp.get("code", 500)), str(resp.get("error", "remote error"))
            )
        return resp.get("result")
    finally:
        await stream.close()


async def respond_rspc(stream: Any, node: Any) -> None:
    """Server half: execute against the local router.

    Authorization: feature-gated (`remoteRspc`, off by default) and
    restricted to QUERIES — a peer identity alone must never reach
    mutations like files.eraseFiles or library.delete (the reference
    scopes its remote rspc to device-browsing reads the same way)."""
    from ..node.config import BackendFeature

    req = await Reader(stream).msgpack()
    w = Writer(stream)
    try:
        if not node.is_feature_enabled(BackendFeature.REMOTE_RSPC):
            raise RspcError(403, "remoteRspc disabled on this node")
        proc = node.router.procedures.get(req["key"])
        if proc is not None and proc.kind != "query":
            raise RspcError(403, "only queries are served over p2p")
        result = await node.router.exec(
            node, req["key"], req.get("arg"), req.get("library_id")
        )
        w.msgpack({"ok": True, "result": _wireable(result)})
    except RspcError as e:
        w.msgpack({"ok": False, "error": e.message, "code": e.code})
    except Exception as e:
        w.msgpack({"ok": False, "error": str(e), "code": 500})
    await w.flush()


def _wireable(obj: Any) -> Any:
    """msgpack-encodable projection (bytes→hex like the HTTP layer)."""
    if isinstance(obj, bytes):
        return obj.hex()
    if isinstance(obj, dict):
        return {k: _wireable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_wireable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "to_wire"):
        return _wireable(obj.to_wire())
    return str(obj)
