"""telemetry.snapshot — the JSON read path.

An owned copy of `spacedrive_tpu/telemetry/snapshot.py`: the registry
and the recent spans shaped for rspc consumers (`telemetry.snapshot`),
and point reads of single families (the autotune controller reads the
loop lag and a bench rig's link probe through them).
"""

from __future__ import annotations

from typing import Any

from .registry import REGISTRY
from .spans import recent_spans


def snapshot() -> dict[str, Any]:
    return {
        "metrics": REGISTRY.snapshot(),
        "spans": recent_spans(),
    }


def histogram_recent(name: str, **labels: Any) -> list[float]:
    """Raw recent observations of a histogram series ([] when the
    metric is unknown)."""
    fam = REGISTRY.get(name)
    if fam is None or not hasattr(fam, "recent"):
        return []
    return fam.recent(**labels)


def gauge_value(name: str, default: float = 0.0, **labels: Any) -> float:
    """A gauge's (or counter's) value, `default` when the family is not
    registered in this process."""
    fam = REGISTRY.get(name)
    if fam is None or not hasattr(fam, "value"):
        return default
    return fam.value(**labels)


def counter_value(name: str, default: float = 0.0, **labels: Any) -> float:
    return gauge_value(name, default, **labels)
