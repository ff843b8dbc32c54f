"""The work of an all-pairs Hamming search, counted by the benchmark.

The count reads the same work whatever implements it:

- pairs compared: N(N-1)/2;
- operations: 128 per pair, a 64-term ±1 dot product counting the
  multiply and the add, held against the card's int8 dense peak, its
  highest published exact rate;
- bytes: the 8-byte hashes read once, and 8 bytes for each pair found
  written once, held against the HBM bandwidth.

The bound is the larger of the two times. An implementation that comes
near it (a binary tensor-core product, say) does fewer operations per
pair than this count assumes, and calls for a recount before its share
can be judged.
"""

from __future__ import annotations

from .peaks import Peaks

OPS_PER_PAIR = 128
HASH_BYTES = 8
PAIR_BYTES = 8


def pairs_compared(n: int) -> int:
    return n * (n - 1) // 2


def near_pairs_ops(n: int) -> int:
    return OPS_PER_PAIR * pairs_compared(n)


def near_pairs_bytes(n: int, pairs_found: int) -> int:
    return HASH_BYTES * n + PAIR_BYTES * pairs_found


def near_pairs_bound_s(n: int, pairs_found: int, peaks: Peaks) -> tuple[float, str]:
    """(least seconds, "ops" or "bytes"): the larger of the two times."""
    t_ops = near_pairs_ops(n) / peaks.int8_ops
    t_bytes = near_pairs_bytes(n, pairs_found) / peaks.hbm_bytes_per_s
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
