"""Point reads of the registry by family name.

Counterpart of `spacedrive_tpu/telemetry/snapshot.py`'s `gauge_value`
and `counter_value` (the autotune controller reads the loop lag and a
bench rig's link probe through them); the port has no spans, so no
`snapshot()` of recent spans.
"""

from __future__ import annotations

from typing import Any

from .registry import REGISTRY


def gauge_value(name: str, default: float = 0.0, **labels: Any) -> float:
    """A gauge's (or counter's) value, `default` when the family is not
    registered in this process."""
    fam = REGISTRY.get(name)
    if fam is None or not hasattr(fam, "value"):
        return default
    return fam.value(**labels)


def counter_value(name: str, default: float = 0.0, **labels: Any) -> float:
    return gauge_value(name, default, **labels)
