"""Labeler checkpoint artifacts: save and load LabelerNet weights.

Owned copy of `spacedrive_tpu/models/checkpoint.py`, numpy only, with
the same `.npz` format: the flattened flax parameter tree (keys such as
`ConvBlock_0/Conv_0/kernel`, kernels in flax's HWIO and [in, out]
layouts) plus a `__meta__` JSON header (`format`
"spacedrive-labeler-v1", classes, image_size, widths, depths), so a
checkpoint written by either package loads in the other.
`models/labeler.params_from_flax` turns the loaded tree into the torch
module's state. Inference never runs from random weights: no artifact,
no labels.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

_META_KEY = "__meta__"


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def save(path: str | os.PathLike, params: Any, *, classes: list[str],
         image_size: int, widths: list[int] | tuple[int, ...],
         depths: list[int] | tuple[int, ...],
         extra: dict[str, Any] | None = None) -> None:
    """Write params + architecture metadata as one .npz artifact."""
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(params)
    meta = {
        "format": "spacedrive-labeler-v1",
        "classes": list(classes),
        "image_size": int(image_size),
        "widths": [int(w) for w in widths],
        "depths": [int(d) for d in depths],
        **(extra or {}),
    }
    flat[_META_KEY] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), np.uint8
    ).copy()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load(path: str | os.PathLike) -> tuple[dict[str, Any], dict[str, Any]]:
    """Read a checkpoint → (params pytree, meta dict)."""
    with np.load(os.fspath(path)) as z:
        flat = {k: z[k] for k in z.files}
    raw = flat.pop(_META_KEY, None)
    if raw is None:
        raise ValueError(f"{path}: not a labeler checkpoint (missing meta)")
    meta = json.loads(bytes(raw.tobytes()).decode("utf-8"))
    if meta.get("format") != "spacedrive-labeler-v1":
        raise ValueError(f"{path}: unknown checkpoint format {meta.get('format')}")
    return _unflatten(flat), meta
