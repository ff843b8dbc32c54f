"""Sync-model registry — which tables sync, and how.

The reference derives this from schema doc-attributes (`/// @local`,
`/// @shared(id: …)`, `/// @relation(item, group)`) via its
`sync-generator` crate (ref:crates/sync-generator/src/lib.rs:22-36).
Here the registry is explicit data; the sync layer (sync/apply.py,
sync/ingest.py) uses it to apply CRDT operations and backfill the op
log. Counterpart of `spacedrive_tpu/db/sync_registry.py`: the same
models, kinds and references.

Sync kinds (ref:docs/developers/architecture/sync.mdx):
- LOCAL:    never leaves the device (instance, volume, cloud op cache).
- SHARED:   one instance owns writes at a time; LWW per field.
  `id_field` names the column whose value is the record's global sync
  id (usually pub_id; `name` for label, `key` for preference; media_data
  uses its object's pub_id — `id_ref` points through the FK).
- RELATION: link rows identified by (item, group) sync-id pair.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class SyncKind(enum.Enum):
    LOCAL = "local"
    SHARED = "shared"
    RELATION = "relation"


@dataclass(frozen=True)
class ForeignRef:
    """A column that stores a local integer FK but syncs as the target
    row's global sync id (e.g. file_path.object_id syncs as the object's
    pub_id)."""

    column: str          # local column, e.g. "object_id"
    table: str           # target table, e.g. "object"
    target_id_field: str = "pub_id"


@dataclass(frozen=True)
class SyncModel:
    name: str                      # table name; also CRDTOperation.model
    kind: SyncKind
    id_field: str | None = None    # SHARED: column carrying the sync id
    id_ref: ForeignRef | None = None  # SHARED with FK-derived identity (media_data)
    item: ForeignRef | None = None    # RELATION: the item side
    group: ForeignRef | None = None   # RELATION: the group side
    foreign_refs: tuple[ForeignRef, ...] = field(default=())  # synced FK columns
    local_fields: tuple[str, ...] = field(default=())  # @local fields, not synced


SYNC_MODELS: dict[str, SyncModel] = {
    m.name: m
    for m in [
        SyncModel("instance", SyncKind.LOCAL, id_field="pub_id"),
        SyncModel("volume", SyncKind.LOCAL),
        SyncModel("cloud_crdt_operation", SyncKind.LOCAL, id_field="id"),
        SyncModel(
            "location", SyncKind.SHARED, id_field="pub_id",
            local_fields=("instance_id",),  # client-side cache (ref:schema.prisma:126)
        ),
        SyncModel(
            "file_path", SyncKind.SHARED, id_field="pub_id",
            foreign_refs=(
                ForeignRef("location_id", "location"),
                ForeignRef("object_id", "object"),
            ),
        ),
        SyncModel("object", SyncKind.SHARED, id_field="pub_id"),
        SyncModel(
            "media_data", SyncKind.SHARED,
            id_ref=ForeignRef("object_id", "object"),
        ),
        SyncModel(
            "object_embedding", SyncKind.SHARED,
            id_ref=ForeignRef("object_id", "object"),
        ),
        SyncModel("tag", SyncKind.SHARED, id_field="pub_id"),
        SyncModel("label", SyncKind.SHARED, id_field="name"),
        SyncModel("preference", SyncKind.SHARED, id_field="key"),
        SyncModel("saved_search", SyncKind.SHARED, id_field="pub_id"),
        SyncModel(
            "tag_on_object", SyncKind.RELATION,
            item=ForeignRef("object_id", "object"),
            group=ForeignRef("tag_id", "tag"),
        ),
        SyncModel(
            "label_on_object", SyncKind.RELATION,
            item=ForeignRef("object_id", "object"),
            group=ForeignRef("label_id", "label", target_id_field="name"),
        ),
    ]
}


def model_sync_kind(table: str) -> SyncKind | None:
    """None for tables with no sync annotation (purely device-local
    bookkeeping like job/statistics/notification)."""
    m = SYNC_MODELS.get(table)
    return m.kind if m else None
