"""The benchmark's count of an all-pairs Hamming search."""

from __future__ import annotations

import pytest

from sdbench.core import peaks, roofline


@pytest.mark.parametrize("n, pairs, ops, bound_ms", [
    (262_144, 34_359_607_296, 4_398_029_733_888, 2.2223),
    (1_048_576, 549_755_289_600, 70_368_677_068_800, 35.5577),
])
def test_counts(n, pairs, ops, bound_ms):
    assert roofline.pairs_compared(n) == pairs
    assert roofline.near_pairs_ops(n) == ops
    assert roofline.near_pairs_bytes(n, 42_000) == 8 * n + 8 * 42_000
    bound, which = roofline.near_pairs_bound_s(n, 900_000, peaks.H100_SXM)
    assert which == "ops"
    assert bound * 1e3 == pytest.approx(bound_ms, rel=1e-4)


def test_bytes_bound_where_pairs_dominate():
    # nearly every pair found: the writes outweigh the operations
    bound, which = roofline.near_pairs_bound_s(1000, 499_500 * 1000, peaks.H100_SXM)
    assert which == "bytes"


def test_peaks_by_name():
    assert peaks.for_device("NVIDIA H100 80GB HBM3") is peaks.H100_SXM
    assert peaks.for_device("cpu") is None
