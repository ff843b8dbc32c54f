"""Normalized query-cache protocol.

Parity: ref:crates/cache/src/lib.rs:13-40 — `Model` gives each row type
a name + unique id; query results are split into `CacheNode`s (the full
records, keyed `(__type, __id)`) and `Reference`s (pointers embedded in
the result shape), packaged as `NormalisedResults{item(s), nodes}` so
the frontend cache can dedupe records shared across queries.

Counterpart of `spacedrive_tpu/api/cache.py`.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

ModelId = Callable[[dict[str, Any]], Any]

# model name -> unique-id extractor (ref `Model::name` + `Model::id`)
_MODELS: dict[str, ModelId] = {}


def register_model(name: str, id_fn: ModelId | None = None) -> None:
    _MODELS[name] = id_fn or (lambda row: row["id"])


for _name in ("location", "file_path", "object", "tag", "label", "volume", "job"):
    register_model(_name)


def _node_id(model: str, row: dict[str, Any]) -> Any:
    if model not in _MODELS:
        register_model(model)
    nid = _MODELS[model](row)
    return nid.hex() if isinstance(nid, bytes) else nid


def reference(model: str, row: dict[str, Any]) -> dict[str, Any]:
    """ref:lib.rs `Reference<T>` wire shape."""
    return {"__type": model, "__id": _node_id(model, row)}


def cache_node(model: str, row: dict[str, Any]) -> dict[str, Any]:
    """ref:lib.rs `CacheNode` wire shape — the record + its key."""
    out = {"__type": model, "__id": _node_id(model, row)}
    for k, v in row.items():
        out[k] = v.hex() if isinstance(v, bytes) else v
    return out


def normalise(model: str, rows: Iterable[dict[str, Any]]) -> dict[str, Any]:
    """`NormalisedResults` for a homogeneous list (ref:lib.rs:31-40)."""
    rows = list(rows)
    return {
        "items": [reference(model, r) for r in rows],
        "nodes": [cache_node(model, r) for r in rows],
    }


def normalise_one(model: str, row: dict[str, Any]) -> dict[str, Any]:
    """`NormalisedResult` for a single record."""
    return {"item": reference(model, row), "nodes": [cache_node(model, row)]}
