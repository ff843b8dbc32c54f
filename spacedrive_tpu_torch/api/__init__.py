"""API layer: typed router, normalized cache, invalidation, search.

Parity: ref:core/src/api (rspc router + CoreEvent + invalidation),
crates/cache (normalised results). Counterpart of
`spacedrive_tpu/api/`; the HTTP host (rspc over HTTP and a websocket,
the custom URIs, the explorer's assets) is `server.py`, imported where
a Node starts it (`Node.start_api`).
"""

from .cache import normalise, normalise_one
from .invalidate import InvalidateOperation, invalidate_query
from .namespaces import DEFERRED, mount
from .router import CoreEventKind, Router, RspcError

__all__ = [
    "CoreEventKind",
    "DEFERRED",
    "InvalidateOperation",
    "Router",
    "RspcError",
    "invalidate_query",
    "mount",
    "normalise",
    "normalise_one",
]
