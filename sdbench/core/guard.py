"""The import guard: no JAX, and not the JAX package, in a run.

Names compare whole, by the part before the first dot, so the port
(`spacedrive_tpu_torch`) is not the JAX package (`spacedrive_tpu`).
"""

from __future__ import annotations

import sys
from collections.abc import Iterable

BANNED = frozenset({"jax", "jaxlib", "flax", "spacedrive_tpu"})


def banned_modules(names: Iterable[str] | None = None) -> list[str]:
    """The banned top-level names among `names` (default: `sys.modules`)."""
    tops = {n.split(".", 1)[0] for n in (sys.modules if names is None else names)}
    return sorted(tops & BANNED)
