"""API layer: typed router, normalized cache, invalidation, search.

Parity: ref:core/src/api (rspc router + CoreEvent + invalidation),
crates/cache (normalised results). Counterpart of
`spacedrive_tpu/api/`, without the HTTP host (api/server.py) and the
custom-URI serving, which come with the serve layer.
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
