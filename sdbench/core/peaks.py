"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM5 data sheet, dense rates (no sparsity), at the 700 W
limit. A card set to a lower power limit runs slower under load: the
run prints the limit beside its numbers. Only the peaks that a metric
reads are listed.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Peaks:
    int8_ops: float
    hbm_bytes_per_s: float


H100_SXM = Peaks(int8_ops=1979e12, hbm_bytes_per_s=3.35e12)


def for_device(kind: str) -> Peaks | None:
    """The peaks of the card `torch.cuda.get_device_name()` names, or
    None for a card not in the table."""
    return H100_SXM if "H100" in kind else None
