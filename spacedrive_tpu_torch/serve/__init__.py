"""The serve layer — overload-safe read path for one node.

Counterpart of `spacedrive_tpu/serve/__init__.py`. Three cooperating
parts:

- :mod:`.gate` — per-priority-class admission with queue-then-shed and
  brownout detection;
- :mod:`.cache` — bounded LRU + single-flight + stale-while-revalidate
  for explorer queries, thumbnail bytes, and the /mesh//snapshot meta
  views;
- write-combined sync ingest (``sync/ingest.py``) reads its transaction
  quantum from :mod:`.policy`.

:class:`ServeRuntime` bundles the per-node state; ``Node`` constructs
one when ``SD_SERVE_GATE`` is not ``0`` and exposes it as
``node.serve`` — every consumer treats a missing/None runtime as "the
ungated pre-serve path".
"""

from __future__ import annotations

import uuid
from typing import Any

from .cache import ReadCache
from .gate import AdmissionGate, Shed
from .policy import (
    BACKGROUND,
    CACHEABLE_QUERIES,
    CLASSES,
    CONTROL,
    INTERACTIVE,
    SYNC,
    ServePolicy,
    class_for_key,
    enabled,
    policy,
)

__all__ = [
    "AdmissionGate", "ReadCache", "ServeRuntime", "Shed",
    "CONTROL", "SYNC", "INTERACTIVE", "BACKGROUND", "CLASSES",
    "CACHEABLE_QUERIES", "ServePolicy", "canonical_library_id",
    "class_for_key", "enabled", "policy", "runtime_for",
]


class ServeRuntime:
    """One node's serve-layer state: the admission gate plus the three
    cache regions (explorer queries, thumbnail bytes, meta views)."""

    def __init__(self, policy_obj: ServePolicy | None = None):
        self._policy = policy_obj
        pol = policy_obj if policy_obj is not None else policy()
        self.gate = AdmissionGate(policy_obj)
        self.queries = ReadCache(
            "query",
            max_entries=pol.query_cache_entries,
            default_ttl_s=pol.query_ttl_s,
            stale_max_s=pol.stale_serve_max_s,
        )
        self.thumbs = ReadCache(
            "thumb",
            max_entries=65536,
            max_weight=pol.thumb_cache_bytes,
            # content-addressed: a cas_id's webp never changes, so the
            # TTL is effectively "until evicted"
            default_ttl_s=86400.0,
            stale_max_s=86400.0,
        )
        self.meta = ReadCache(
            "meta", max_entries=64,
            default_ttl_s=pol.mesh_ttl_s,
            stale_max_s=pol.stale_serve_max_s,
        )

    @property
    def policy(self) -> ServePolicy:
        return self._policy if self._policy is not None else policy()

    # --- invalidation entry points --------------------------------------

    def invalidate_library(self, library_id: Any, source: str = "local") -> int:
        """Every cached read for one library is void — fired by
        sync-applied ingest batches (coarse: remote ops don't say which
        queries they dirty) and by local mutations' invalidate_query."""
        return self.queries.invalidate_tag(
            ("lib", canonical_library_id(library_id)), source=source
        )

    def invalidate_query(self, key: str, library_id: Any = None,
                         source: str = "local") -> int:
        """Local mutation invalidation. The mutation plane names exact
        query keys, but a handler that dirtied ``search.paths`` almost
        always dirtied ``locations.list`` too — read-your-writes beats
        cache retention, so the whole library tag drops. A NODE-scoped
        mutation (library create/delete, config) clears the query cache
        outright: entries carry only library tags, node mutations are
        rare, and a tag nothing ever carries would be a silent no-op."""
        if library_id is not None:
            return self.invalidate_library(library_id, source=source)
        n = len(self.queries)
        self.queries.clear()
        return n

    def snapshot(self) -> dict[str, Any]:
        return {
            "gate": self.gate.snapshot(),
            "caches": {
                "query": self.queries.snapshot(),
                "thumb": self.thumbs.snapshot(),
                "meta": self.meta.snapshot(),
            },
        }


def runtime_for(node: Any) -> ServeRuntime | None:
    """The node's serve runtime, or None when absent/disabled — every
    call site treats None as 'take the ungated pre-serve path'."""
    if not enabled():
        return None
    return getattr(node, "serve", None)


def canonical_library_id(library_id: Any) -> str:
    """One spelling per library for cache keys AND invalidation tags.
    ``_resolve_library`` accepts any ``uuid.UUID()``-parsable form
    (uppercase, undashed, urn:), but invalidation fires with the
    canonical ``str(library.id)`` — without normalizing here, a
    non-canonical client spelling would mint cache entries that
    read-your-writes invalidation can never drop."""
    try:
        return str(uuid.UUID(str(library_id)))
    except (ValueError, AttributeError, TypeError):
        return str(library_id)


def query_cache_key(key: str, library_id: Any, arg: Any) -> tuple:
    """Deterministic cache key for one rspc query execution."""
    import json

    return (
        key,
        canonical_library_id(library_id),
        json.dumps(arg, sort_keys=True, default=str) if arg is not None else "",
    )
