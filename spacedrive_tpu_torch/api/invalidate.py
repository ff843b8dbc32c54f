"""Query-invalidation system.

Parity: ref:core/src/api/utils/invalidate.rs:23-137 — mutations call
`invalidate_query!(library, "key")` which (a) validates at startup that
"key" names a real query in the router (the reference walks its
registry in a `ctor` and panics in debug on unknown keys) and (b)
emits `CoreEvent::InvalidateOperation{library_id, key, arg}` on the
event bus; the frontend's `invalidation.listen` subscription maps these
to react-query refetches.

Counterpart of `spacedrive_tpu/api/invalidate.py`: the same call also
drops the serve layer's cached reads of the library (read-your-writes).
"""

from __future__ import annotations

import logging
import uuid
from dataclasses import dataclass
from typing import Any

from .router import CoreEventKind, Router

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class InvalidateOperation:
    library_id: str | None
    key: str
    arg: Any = None

    def to_wire(self) -> dict[str, Any]:
        return {"library_id": self.library_id, "key": self.key, "arg": self.arg}


class InvalidationRegistry:
    """Startup-validated key registry (ref:invalidate.rs:23-90)."""

    def __init__(self, router: Router):
        self._valid = {
            key
            for key, proc in router.procedures.items()
            if proc.kind == "query"
        }

    def validate(self, key: str) -> bool:
        if key not in self._valid:
            logger.warning("invalidate_query: unknown query key %r", key)
            return False
        return True


_registry: InvalidationRegistry | None = None


def install_registry(router: Router) -> None:
    global _registry
    _registry = InvalidationRegistry(router)


def invalidate_query(
    node: Any,
    key: str,
    library: Any = None,
    arg: Any = None,
) -> None:
    """The `invalidate_query!` macro (ref:invalidate.rs:137)."""
    if _registry is not None and not _registry.validate(key):
        return
    op = InvalidateOperation(
        library_id=str(library.id) if library is not None else None,
        key=key,
        arg=arg,
    )
    # the serve layer's read-your-writes hook: the same call that tells
    # the frontend to refetch drops the server-side cached results, so
    # a mutation is never answered by its own pre-image
    from ..serve import runtime_for

    serve = runtime_for(node)
    if serve is not None:
        serve.invalidate_query(
            key, library.id if library is not None else None, source="local"
        )
    node.event_bus.emit((CoreEventKind.INVALIDATE_OPERATION, op))
