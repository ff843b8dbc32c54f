"""Read-path cache — bounded LRU + single-flight + brownout SWR.

Counterpart of `spacedrive_tpu/serve/cache.py`. Entry ages are read
through ``clock`` (``time.monotonic`` by default), so a test can expire
an entry without sleeping.

Three behaviors, one structure:

- **bounded LRU**: entries are evicted oldest-used first when the
  entry-count or weight budget (thumbnail bytes) is exceeded — a
  traffic burst can grow the cache to its budget and no further;
- **single-flight**: concurrent loads of one key coalesce onto one
  loader call — a stampede of 100 explorer tabs on one hot directory
  issues ONE SQLite query, everyone awaits the same future;
- **stale-while-revalidate brownout**: when the admission gate reports
  brownout, an expired entry is served anyway (stamped ``stale``) while
  a single-flight refresh runs behind it — under overload a slightly
  old listing beats a shed.

Invalidation is tag-based: every entry carries tags like
``("lib", <library-uuid>)`` and ``("q", <query-key>, <library-uuid>)``;
local mutations (``api.invalidate.invalidate_query``) and sync-applied
ingest batches (the ``p2p.manager`` ingest hook) drop the
affected tags. Counted on ``sd_serve_cache_*``.

Asyncio-confined: get/invalidate run on the node's event loop (the only
place the serve surface executes); no internal locking.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import OrderedDict
from typing import Any, Awaitable, Callable, NamedTuple

from ..telemetry import metrics as _tm
from ..telemetry import tenants as _tenants
from ..utils.tasks import supervise

logger = logging.getLogger(__name__)

#: cache read outcomes (the ``result`` label on sd_serve_cache_ops_total)
HIT, MISS, STALE, COALESCED, BYPASS = (
    "hit", "miss", "stale", "coalesced", "bypass",
)

Key = tuple
Tag = tuple


class CacheResult(NamedTuple):
    value: Any
    state: str  # hit | miss | stale | coalesced | bypass
    age_s: float


class _Entry:
    __slots__ = ("value", "stored_at", "ttl_s", "tags", "weight")

    def __init__(self, value: Any, ttl_s: float, tags: tuple[Tag, ...],
                 weight: int, now: float):
        self.value = value
        self.stored_at = now
        self.ttl_s = ttl_s
        self.tags = tags
        self.weight = weight


class ReadCache:
    """One bounded cache region (queries, thumbnail bytes, meta views)."""

    def __init__(
        self,
        name: str,
        *,
        max_entries: int = 1024,
        max_weight: int | None = None,
        default_ttl_s: float = 5.0,
        stale_max_s: float = 120.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self._clock = clock
        self.max_entries = max_entries
        self.max_weight = max_weight
        self.default_ttl_s = default_ttl_s
        self.stale_max_s = stale_max_s
        self._entries: "OrderedDict[Key, _Entry]" = OrderedDict()
        self._tags: dict[Tag, set[Key]] = {}
        self._inflight: dict[Key, "asyncio.Future[Any]"] = {}
        self._refreshes: set[asyncio.Task] = set()
        self._weight = 0
        # invalidation epoch: a load that STARTED before an invalidation
        # must not store its (pre-mutation) result after it — the
        # awaiting callers still get the value, but the next read loads
        # fresh (read-your-writes survives the load/invalidate race)
        self._epoch = 0

    # --- read -----------------------------------------------------------

    async def get(
        self,
        key: Key,
        loader: Callable[[], Awaitable[Any]],
        *,
        ttl_s: float | None = None,
        tags: tuple[Tag, ...] = (),
        stale_ok: bool = False,
        weigh: Callable[[Any], int] | None = None,
        tenant: Any = None,
    ) -> CacheResult:
        """Cached value for ``key``, loading (single-flight) on miss.

        ``ttl_s=0`` stores nothing: pure request coalescing — N
        concurrent callers cost one loader run, and the next caller
        after completion loads fresh (the /mesh refresh shape).
        ``stale_ok`` (brownout) serves an expired entry while a
        background single-flight refresh replaces it. ``tenant`` (the
        owning library id, when the caller has one) feeds the
        per-tenant cache hit/miss sketches — hashed on entry, never
        stored here.
        """
        ttl = self.default_ttl_s if ttl_s is None else ttl_s
        entry = self._entries.get(key)
        now = self._clock()
        if entry is not None:
            age = now - entry.stored_at
            if age < entry.ttl_s:
                self._entries.move_to_end(key)
                _tm.SERVE_CACHE_OPS.inc(
                    cache="query" if self.name == "query"
                    else "thumb" if self.name == "thumb" else "meta",
                    result="hit")
                _tenants.observe("cache_hit", tenant)
                return CacheResult(entry.value, HIT, age)
            if stale_ok and age - entry.ttl_s < self.stale_max_s:
                # brownout: answer stale NOW, refresh behind the response
                self._refresh_in_background(key, loader, ttl, tags, weigh)
                _tm.SERVE_CACHE_OPS.inc(
                    cache="query" if self.name == "query"
                    else "thumb" if self.name == "thumb" else "meta",
                    result="stale")
                _tenants.observe("cache_hit", tenant)
                return CacheResult(entry.value, STALE, age)
            self._evict_key(key)
        fut = self._inflight.get(key)
        if fut is not None:
            _tm.SERVE_CACHE_OPS.inc(
                    cache="query" if self.name == "query"
                    else "thumb" if self.name == "thumb" else "meta",
                    result="coalesced")
            _tenants.observe("cache_hit", tenant)
            value = await asyncio.shield(fut)
            return CacheResult(value, COALESCED, 0.0)
        value = await self._load(key, loader, ttl, tags, weigh)
        _tm.SERVE_CACHE_OPS.inc(
                    cache="query" if self.name == "query"
                    else "thumb" if self.name == "thumb" else "meta",
                    result="miss")
        _tenants.observe("cache_miss", tenant)
        return CacheResult(value, MISS, 0.0)

    def get_sync(
        self,
        key: Key,
        loader: Callable[[], Any],
        *,
        ttl_s: float | None = None,
        tags: tuple[Tag, ...] = (),
    ) -> Any:
        """Synchronous TTL read-through for sync callers (the federation
        responder's local_snapshot). No single-flight — the loop cannot
        interleave a sync loader — but repeated polls inside the TTL
        window still cost one computation."""
        ttl = self.default_ttl_s if ttl_s is None else ttl_s
        entry = self._entries.get(key)
        if entry is not None:
            if self._clock() - entry.stored_at < entry.ttl_s:
                self._entries.move_to_end(key)
                _tm.SERVE_CACHE_OPS.inc(
                    cache="query" if self.name == "query"
                    else "thumb" if self.name == "thumb" else "meta",
                    result="hit")
                return entry.value
            self._evict_key(key)
        value = loader()
        if ttl > 0:
            self._store(key, value, ttl, tags, weight=1)
        _tm.SERVE_CACHE_OPS.inc(
                    cache="query" if self.name == "query"
                    else "thumb" if self.name == "thumb" else "meta",
                    result="miss")
        return value

    async def _load(
        self, key: Key, loader, ttl: float, tags, weigh,
    ) -> Any:
        fut: "asyncio.Future[Any]" = asyncio.get_running_loop().create_future()
        self._inflight[key] = fut
        epoch = self._epoch
        try:
            value = await loader()
        except BaseException as e:
            if not fut.done():
                fut.set_exception(e)
                # awaiting coalesced callers re-raise; nothing retained
                fut.exception()
            raise
        else:
            if not fut.done():
                fut.set_result(value)
            if ttl > 0 and epoch == self._epoch:
                # an invalidation fired mid-load ⇒ this value may be a
                # pre-mutation read: hand it to the waiters, store nothing
                weight = weigh(value) if weigh is not None else 1
                self._store(key, value, ttl, tags, weight)
            return value
        finally:
            self._inflight.pop(key, None)

    def _refresh_in_background(self, key, loader, ttl, tags, weigh) -> None:
        if key in self._inflight:
            return  # a refresh is already running; everyone rides it

        async def refresh() -> None:
            try:
                await self._load(key, loader, ttl, tags, weigh)
            except Exception as e:  # noqa: BLE001 - the stale answer already went out
                # expected under sustained brownout (the refresh load can
                # itself be shed); the NEXT stale read retries
                logger.debug("stale-refresh of %r failed: %r", key, e)

        task = asyncio.ensure_future(refresh())
        supervise(task, self._refreshes, logger,
                  f"serve-cache refresh ({self.name})")

    # --- write / evict --------------------------------------------------

    def _store(self, key: Key, value: Any, ttl: float,
               tags: tuple[Tag, ...], weight: int) -> None:
        self._evict_key(key)
        self._entries[key] = _Entry(value, ttl, tuple(tags), weight, self._clock())
        self._weight += weight
        for tag in tags:
            self._tags.setdefault(tag, set()).add(key)
        while len(self._entries) > self.max_entries or (
            self.max_weight is not None and self._weight > self.max_weight
            and len(self._entries) > 1
        ):
            old_key, _ = next(iter(self._entries.items()))
            self._evict_key(old_key)
        _tm.SERVE_CACHE_ENTRIES.set(
            len(self._entries),
            cache="query" if self.name == "query"
            else "thumb" if self.name == "thumb" else "meta")

    def _evict_key(self, key: Key) -> None:
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        self._weight -= entry.weight
        for tag in entry.tags:
            keys = self._tags.get(tag)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._tags[tag]
        _tm.SERVE_CACHE_ENTRIES.set(
            len(self._entries),
            cache="query" if self.name == "query"
            else "thumb" if self.name == "thumb" else "meta")

    def invalidate_tag(self, tag: Tag, source: str = "local") -> int:
        """Drop every entry carrying ``tag``; returns the count. Bumps
        the epoch even when nothing is stored yet — an IN-FLIGHT load
        for the tag is exactly as stale as a stored entry."""
        self._epoch += 1
        keys = self._tags.get(tag)
        if not keys:
            return 0
        n = 0
        for key in list(keys):
            self._evict_key(key)
            n += 1
        if n:
            _tm.SERVE_CACHE_INVALIDATIONS.inc(
                n, source="sync" if source == "sync" else "local")
        return n

    def invalidate_key(self, key: Key, source: str = "local") -> None:
        self._epoch += 1
        if key in self._entries:
            self._evict_key(key)
            _tm.SERVE_CACHE_INVALIDATIONS.inc(
                source="sync" if source == "sync" else "local")

    def clear(self) -> None:
        self._epoch += 1
        self._entries.clear()
        self._tags.clear()
        self._weight = 0
        _tm.SERVE_CACHE_ENTRIES.set(
            0,
            cache="query" if self.name == "query"
            else "thumb" if self.name == "thumb" else "meta")

    # --- introspection --------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        return {
            "entries": len(self._entries),
            "weight": self._weight,
            "max_entries": self.max_entries,
            "max_weight": self.max_weight,
            "inflight_loads": len(self._inflight),
        }

    def __len__(self) -> int:
        return len(self._entries)
