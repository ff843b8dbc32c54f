"""Per-library KV-flattened preferences.

Parity: ref:core/src/preferences/{mod.rs,kv.rs} — `LibraryPreferences`
is a nested JSON document flattened into dotted-key rows of the
`preference` table (`PreferenceKVs::from_model`, kv.rs), so partial
updates touch only the affected keys; `read` re-nests the rows into the
document (mod.rs:16-55). Values are stored msgpack-encoded like the
reference's rmpv.

Counterpart of `spacedrive_tpu/node/preferences.py`, with the port's
own MessagePack codec (utils/msgpack_codec.py): the rows are
byte-equal to the JAX package's.
"""

from __future__ import annotations

from typing import Any

from ..db.database import LibraryDb
from ..utils.msgpack_codec import packb, unpackb


def _flatten(doc: dict[str, Any], prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in doc.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict) and v and all(isinstance(x, str) for x in v):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _nest(flat: dict[str, Any]) -> dict[str, Any]:
    doc: dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(".")
        cur = doc
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = value
    return doc


def write_preferences(db: LibraryDb, doc: dict[str, Any]) -> int:
    """Flatten `doc` and upsert each dotted key (ref:kv.rs `write`)."""
    flat = _flatten(doc)
    for key, value in flat.items():
        # a key can't be both a leaf and a subtree: drop any ancestor
        # leaves and any children this write shadows
        parts = key.split(".")
        for i in range(1, len(parts)):
            db.delete("preference", key=".".join(parts[:i]))
        db.execute("DELETE FROM preference WHERE key LIKE ?", (key + ".%",))
        db.upsert("preference", {"key": key}, value=packb(value))
    return len(flat)


def read_preferences(db: LibraryDb) -> dict[str, Any]:
    """Load all rows and re-nest (ref:mod.rs:16-55 `read`)."""
    flat = {
        row["key"]: unpackb(row["value"]) if row["value"] is not None else None
        for row in db.query("SELECT key, value FROM preference")
    }
    return _nest(flat)


def clear_preference(db: LibraryDb, key_prefix: str) -> int:
    """Remove a subtree of preferences by dotted-key prefix."""
    return db.execute(
        "DELETE FROM preference WHERE key = ? OR key LIKE ?",
        (key_prefix, key_prefix + ".%"),
    ).rowcount
