"""Typed procedure router — the rspc analogue.

Parity: ref:core/src/api/mod.rs — `Router<Ctx = Arc<Node>>` built by
`api::mount()` (:124) out of ~20 namespace routers (:197-218), with
library-scoped procedures taking `LibraryArgs<T>{library_id, arg}`
(api/utils/library.rs) resolved to a `Library` before the handler runs,
and the `CoreEvent` stream (:54-58) feeding subscriptions. Procedures
are query/mutation/subscription keyed "namespace.name" exactly like
rspc's merge naming.

Counterpart of `spacedrive_tpu/api/router.py`. `exec` takes the JAX
router's direct path (`_exec_direct`), the one it takes when the node
has no serve runtime; the admission gate and the read cache come with
the serve layer, which is not ported yet.
"""

from __future__ import annotations

import inspect
import logging
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, AsyncIterator, Awaitable, Callable

logger = logging.getLogger(__name__)


class CoreEventKind(str, Enum):
    """ref:core/src/api/mod.rs:54-58 `CoreEvent`."""

    NEW_THUMBNAIL = "NewThumbnail"
    NEW_IDENTIFIED_OBJECTS = "NewIdentifiedObjects"
    JOB_PROGRESS = "JobProgress"
    INVALIDATE_OPERATION = "InvalidateOperation"


class RspcError(Exception):
    """ref:rspc::Error — code + message surfaced to the client."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message

    @classmethod
    def not_found(cls, what: str) -> "RspcError":
        return cls(404, f"{what} not found")

    @classmethod
    def bad_request(cls, message: str) -> "RspcError":
        return cls(400, message)


@dataclass
class Procedure:
    key: str
    kind: str  # query | mutation | subscription
    fn: Callable[..., Any]
    library_scoped: bool = False


class Router:
    """Procedure registry; namespaces merge by key prefix."""

    def __init__(self) -> None:
        self.procedures: dict[str, Procedure] = {}

    # --- registration (decorators) ---

    def _register(self, key: str, kind: str, library: bool):
        def deco(fn):
            if key in self.procedures:
                raise ValueError(f"duplicate procedure {key}")
            self.procedures[key] = Procedure(key, kind, fn, library)
            return fn

        return deco

    def query(self, key: str, *, library: bool = False):
        return self._register(key, "query", library)

    def mutation(self, key: str, *, library: bool = False):
        return self._register(key, "mutation", library)

    def subscription(self, key: str, *, library: bool = False):
        return self._register(key, "subscription", library)

    # --- execution ---

    async def exec(
        self,
        node: Any,
        key: str,
        arg: Any = None,
        library_id: str | uuid.UUID | None = None,
    ) -> Any:
        """Run a query or mutation: the JAX router's direct path, which it
        takes whenever the node has no serve runtime."""
        proc = self.procedures.get(key)
        if proc is None:
            raise RspcError.not_found(f"procedure {key!r}")
        if proc.kind == "subscription":
            raise RspcError.bad_request(f"{key} is a subscription; use subscribe()")
        return await self._exec_direct(node, proc, key, arg, library_id)

    async def _exec_direct(
        self, node: Any, proc: Procedure, key: str, arg: Any, library_id: Any,
    ) -> Any:
        args = [node]
        if proc.library_scoped:
            lib = self._resolve_library(node, library_id)
            args.append(lib)
        if _wants_arg(proc.fn, proc.library_scoped):
            args.append(arg)
        try:
            result = proc.fn(*args)
            if inspect.isawaitable(result):
                result = await result
        except (KeyError, TypeError, ValueError) as e:
            # Handlers index straight into the caller's arg shape (the
            # rspc style); a wrong shape is the CLIENT's error and must
            # answer 400, not crash to a 500 (ref:rspc BadRequest). But
            # ONLY when the raising frame is the handler body itself —
            # the same exception types from deeper in the call tree are
            # server bugs and must keep their 500 + traceback log.
            tb = e.__traceback__
            innermost = None
            while tb is not None:
                innermost = tb.tb_frame.f_code
                tb = tb.tb_next
            if innermost is not proc.fn.__code__:
                raise
            logger.warning("bad argument for %s: %r", key, e)
            raise RspcError.bad_request(
                f"bad argument for {key}: {type(e).__name__}: {e}")
        return result

    def subscribe(
        self,
        node: Any,
        key: str,
        arg: Any = None,
        library_id: str | uuid.UUID | None = None,
    ) -> AsyncIterator[Any]:
        proc = self.procedures.get(key)
        if proc is None or proc.kind != "subscription":
            raise RspcError.not_found(f"subscription {key!r}")
        args = [node]
        if proc.library_scoped:
            args.append(self._resolve_library(node, library_id))
        if _wants_arg(proc.fn, proc.library_scoped):
            args.append(arg)
        return proc.fn(*args)

    @staticmethod
    def _resolve_library(node: Any, library_id: Any):
        if library_id is None:
            raise RspcError.bad_request("library_id required")
        if not isinstance(library_id, uuid.UUID):
            library_id = uuid.UUID(str(library_id))
        lib = node.libraries.libraries.get(library_id)
        if lib is None:
            raise RspcError.not_found(f"library {library_id}")
        return lib

    # --- introspection (the generated-TS-types analogue) ---

    def manifest(self) -> dict[str, list[dict[str, Any]]]:
        """Procedure manifest, the stand-in for rspc's exported TS types
        (ref: packages/client/src/core.ts is generated the same way)."""
        out: dict[str, list[dict[str, Any]]] = {
            "queries": [],
            "mutations": [],
            "subscriptions": [],
        }
        plural = {
            "query": "queries",
            "mutation": "mutations",
            "subscription": "subscriptions",
        }
        for proc in sorted(self.procedures.values(), key=lambda p: p.key):
            out[plural[proc.kind]].append(
                {"key": proc.key, "library": proc.library_scoped}
            )
        return out

    def keys(self) -> set[str]:
        return set(self.procedures)


def _wants_arg(fn: Callable[..., Any], library_scoped: bool) -> bool:
    """Handlers are (node[, library][, arg]); arg is passed iff declared."""
    params = [
        p
        for p in inspect.signature(fn).parameters.values()
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
    ]
    return len(params) > (2 if library_scoped else 1)
