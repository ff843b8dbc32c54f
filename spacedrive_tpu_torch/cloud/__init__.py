"""Cloud relay sync: self-hostable relay server, typed client, actors.

Counterpart of `spacedrive_tpu/cloud/` (ref:core/src/cloud: the sender,
receiver and ingester actors, and crates/cloud-api: the REST client);
the relay server itself replaces the reference's closed-source cloud so
WAN sync works self-hosted. Its HTTP is the port's own (utils/http.py).
"""

from .api import CloudApiError, CloudClient
from .relay import CloudRelay
from .sync import OPS_PER_REQUEST, CloudSync

__all__ = [
    "CloudApiError",
    "CloudClient",
    "CloudRelay",
    "CloudSync",
    "OPS_PER_REQUEST",
]
