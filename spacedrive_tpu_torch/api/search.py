"""Search queries over file_path and object, and the semantic search.

Counterpart of the query half of `spacedrive_tpu/api/search.py`
(ref:core/src/api/search/{mod.rs,file_path.rs,object.rs}):
`search_paths` / `search_objects` take filter args (locationId, search
string, extension, kinds, tags, labels, hidden, favorite...), an
ordering and cursor pagination (`take` + an opaque cursor, the last
row's order value and id) compiled into one SQL query; `search_semantic`
scores the library's vector index. Results come back normalised, as the
JAX package's sd-cache does (api/cache.py): `items` hold references,
`nodes` the rows.
"""

from __future__ import annotations

from typing import Any

from ..db.database import blob_u64, escape_like
from .cache import normalise
from .router import RspcError

MAX_TAKE = 100  # ref:api/search/mod.rs take.clamp


# sizes are LE u64 blobs (reference parity); bytewise blob order is not
# numeric order, so order by the byte-reversed (big-endian) hex, whose
# fixed-width lexicographic order IS numeric order
_SIZE_ORDER = (
    "COALESCE("
    + "||".join(
        f"substr(hex(fp.size_in_bytes_bytes),{i},2)" for i in (15, 13, 11, 9, 7, 5, 3, 1)
    )
    + ", '0000000000000000')"
)

_FILE_PATH_ORDER: dict[str, Any] = {
    "name": "fp.name",
    "sizeInBytes": _SIZE_ORDER,
    "dateCreated": "fp.date_created",
    "dateModified": "fp.date_modified",
    "dateIndexed": "fp.date_indexed",
    # ISO-8601 text sorts chronologically; never-accessed rows sort LAST
    # under BOTH directions: '~' (0x7E) is > any digit so it's a max key
    # for ASC, '' is a min key so it lands last under DESC
    "dateAccessed": {"ASC": "COALESCE(o.date_accessed, '~')",
                     "DESC": "COALESCE(o.date_accessed, '')"},
}

_OBJECT_ORDER: dict[str, Any] = {
    "dateAccessed": {"ASC": "COALESCE(o.date_accessed, '~')",
                     "DESC": "COALESCE(o.date_accessed, '')"},
    "kind": "o.kind",
}


def _clamp_take(arg: dict[str, Any]) -> int:
    take = int(arg.get("take", 50))
    if take < 1:
        raise RspcError.bad_request("take must be >= 1")
    return min(take, MAX_TAKE)


def _in_list(n: int) -> str:
    return ",".join("?" * n)


def search_paths(library: Any, arg: dict[str, Any] | None) -> dict[str, Any]:
    """`search.paths` (ref:api/search/mod.rs:185 + file_path.rs:57-266)."""
    arg = arg or {}
    f = arg.get("filter", {}) or {}
    take = _clamp_take(arg)
    conds: list[str] = []
    params: list[Any] = []

    if (loc := f.get("locationId")) is not None:
        conds.append("fp.location_id = ?")
        params.append(int(loc))
    if (search := f.get("search")) not in (None, ""):
        conds.append("fp.name LIKE ? ESCAPE '\\'")
        params.append(f"%{escape_like(str(search))}%")
    if (ext := f.get("extension")) is not None:
        conds.append("fp.extension = ?")
        params.append(str(ext).lstrip(".").lower())
    if (path := f.get("path")) not in (None, ""):
        conds.append("fp.materialized_path = ?")
        params.append(path)
    if (hidden := f.get("hidden")) is not None:
        conds.append("COALESCE(fp.hidden, 0) = ?")
        params.append(int(bool(hidden)))
    if (kinds := f.get("kinds")):
        conds.append(f"o.kind IN ({_in_list(len(kinds))})")
        params.extend(int(k) for k in kinds)
    if (tags := f.get("tags")):
        conds.append("fp.object_id IN (SELECT object_id FROM tag_on_object "
                     f"WHERE tag_id IN ({_in_list(len(tags))}))")
        params.extend(int(t) for t in tags)
    if (labels := f.get("labels")):
        conds.append("fp.object_id IN (SELECT object_id FROM label_on_object "
                     f"WHERE label_id IN ({_in_list(len(labels))}))")
        params.extend(int(lb) for lb in labels)
    if (fav := f.get("favorite")) is not None:
        conds.append("COALESCE(o.favorite, 0) = ?")
        params.append(int(bool(fav)))
    if (acc := f.get("accessed")) is not None:
        # recents: only rows that were ever opened
        conds.append("o.date_accessed IS NOT NULL" if acc else "o.date_accessed IS NULL")
    if (md := f.get("mediaDate")):
        # EXIF capture-time range over media_data.epoch_time
        if not isinstance(md, dict):
            raise RspcError.bad_request("mediaDate must be {from?, to?}")
        sub = ["md.epoch_time IS NOT NULL"]
        if md.get("from") is not None:
            sub.append("md.epoch_time >= ?")
            params.append(int(md["from"]))
        if md.get("to") is not None:
            sub.append("md.epoch_time <= ?")
            params.append(int(md["to"]))
        conds.append("fp.object_id IN (SELECT md.object_id FROM media_data md "
                     f"WHERE {' AND '.join(sub)})")

    order_field, direction = _ordering(arg, _FILE_PATH_ORDER, default="name")
    _apply_cursor(arg.get("cursor"), order_field, direction, "fp.id", conds, params)

    where = ("WHERE " + " AND ".join(conds)) if conds else ""
    rows = library.db.query(
        f"SELECT fp.*, o.kind AS object_kind, o.favorite AS object_favorite, "
        f"o.note AS object_note, o.date_accessed AS object_date_accessed, "
        f"{order_field} AS __order "
        "FROM file_path fp LEFT JOIN object o ON o.id = fp.object_id "
        f"{where} ORDER BY {order_field} {direction}, fp.id ASC LIMIT ?",
        (*params, take + 1),
    )
    has_more = len(rows) > take
    rows = rows[:take]
    cursor_out = [rows[-1].get("__order"), rows[-1]["id"]] if has_more and rows else None
    for r in rows:
        r.pop("__order", None)
        r["size_in_bytes"] = blob_u64(r.pop("size_in_bytes_bytes", None)) or 0
    out = normalise("file_path", rows)
    out["cursor"] = cursor_out
    return out


def search_objects(library: Any, arg: dict[str, Any] | None) -> dict[str, Any]:
    """`search.objects` (ref:api/search/object.rs)."""
    arg = arg or {}
    f = arg.get("filter", {}) or {}
    take = _clamp_take(arg)
    conds: list[str] = []
    params: list[Any] = []

    if (kinds := f.get("kinds")):
        conds.append(f"o.kind IN ({_in_list(len(kinds))})")
        params.extend(int(k) for k in kinds)
    if (fav := f.get("favorite")) is not None:
        conds.append("COALESCE(o.favorite, 0) = ?")
        params.append(int(bool(fav)))
    if (hidden := f.get("hidden")) is not None:
        conds.append("COALESCE(o.hidden, 0) = ?")
        params.append(int(bool(hidden)))
    if (tags := f.get("tags")):
        conds.append("o.id IN (SELECT object_id FROM tag_on_object "
                     f"WHERE tag_id IN ({_in_list(len(tags))}))")
        params.extend(int(t) for t in tags)
    if (search := f.get("search")) not in (None, ""):
        conds.append("o.id IN (SELECT object_id FROM file_path WHERE name LIKE ? ESCAPE '\\')")
        params.append(f"%{escape_like(str(search))}%")

    order_field, direction = _ordering(arg, _OBJECT_ORDER, default="kind")
    _apply_cursor(arg.get("cursor"), order_field, direction, "o.id", conds, params)

    where = ("WHERE " + " AND ".join(conds)) if conds else ""
    rows = library.db.query(
        f"SELECT o.*, {order_field} AS __order FROM object o {where} "
        f"ORDER BY {order_field} {direction}, o.id ASC LIMIT ?",
        (*params, take + 1),
    )
    has_more = len(rows) > take
    rows = rows[:take]
    cursor_out = [rows[-1].get("__order"), rows[-1]["id"]] if has_more and rows else None
    for r in rows:
        r.pop("__order", None)
    out = normalise("object", rows)
    out["cursor"] = cursor_out
    return out


def search_semantic(library: Any, arg: dict[str, Any] | None) -> dict[str, Any]:
    """`search.semantic`: cosine top-k over the library's embeddings
    (object/search/index.py) on the library's node's device. The query
    string resolves to a probe vector: an existing image path embeds
    through the pipeline's embedder; anything else matches a stored
    label name and probes with the labeled objects' centroid."""
    from ..object.search import index as _index

    arg = arg or {}
    q = arg.get("query")
    if not q or not isinstance(q, str):
        raise RspcError.bad_request("query must be a non-empty string")
    take = _clamp_take(arg)

    probe = _index.probe_for(library, q)
    if probe is None:
        return {"items": [], "nodes": [], "scores": {}, "resolved": False}
    rows: list[dict[str, Any]] = []
    scores: dict[str, float] = {}
    for object_id, score in _index.query(library, probe, k=take):
        fp = library.db.query_one(
            "SELECT fp.* FROM file_path fp WHERE fp.object_id = ? ORDER BY fp.id LIMIT 1",
            (object_id,),
        )
        if fp is None:
            continue
        fp["size_in_bytes"] = blob_u64(fp.pop("size_in_bytes_bytes", None)) or 0
        fp["score"] = float(score)
        rows.append(fp)
        scores[str(fp["id"])] = float(score)
    out = normalise("file_path", rows)
    out["scores"] = scores
    out["resolved"] = True
    return out


def _apply_cursor(cursor: Any, order_field: str, direction: str, id_col: str,
                  conds: list[str], params: list[Any]) -> None:
    """Keyset pagination: the opaque cursor is [last order value, last
    id]; resume strictly after that pair in the requested direction."""
    if cursor is None:
        return
    try:
        order_val, last_id = cursor[0], int(cursor[1])
    except (TypeError, ValueError, IndexError):
        raise RspcError.bad_request("malformed cursor") from None
    if order_val is None:
        # NULL order values sort first in SQLite ASC; resume inside them
        # by id, or past them entirely
        if direction == "ASC":
            conds.append(f"(({order_field} IS NULL AND {id_col} > ?) "
                         f"OR {order_field} IS NOT NULL)")
        else:
            conds.append(f"({order_field} IS NULL AND {id_col} > ?)")
        params.append(last_id)
        return
    cmp = ">" if direction == "ASC" else "<"
    null_tail = f" OR {order_field} IS NULL" if direction == "DESC" else ""
    conds.append(f"({order_field} {cmp} ? OR ({order_field} = ? AND {id_col} > ?){null_tail})")
    params.extend([order_val, order_val, last_id])


def _ordering(arg: dict[str, Any], allowed: dict[str, Any], default: str) -> tuple[str, str]:
    ordering = arg.get("orderBy") or default
    if ordering not in allowed:
        raise RspcError.bad_request(f"unknown orderBy {ordering!r}")
    direction = "DESC" if arg.get("orderDir") == "desc" else "ASC"
    expr = allowed[ordering]
    if isinstance(expr, dict):  # direction-dependent NULL sentinel
        expr = expr[direction]
    return expr, direction
