"""The plain reference against brute force, and its control."""

from __future__ import annotations

import collections

import numpy as np
import pytest

from sdbench.checks import dedup_groups
from sdbench.gen import library
from sdbench.reference import dedup

from .test_sdbench_gen import popcount, spec


def brute_pairs(phash: np.ndarray, threshold: int) -> set[tuple[int, int]]:
    d = popcount(phash[:, None] ^ phash[None, :]).reshape(phash.size, phash.size)
    i, j = np.nonzero(d <= threshold)
    return {(a, b) for a, b in zip(i.tolist(), j.tolist()) if a < b}


def brute_groups(n: int, pairs) -> set[frozenset]:
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            x = parent[x]
        return x

    for a, b in pairs:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    groups = collections.defaultdict(set)
    for i in range(n):
        groups[find(i)].add(i)
    return {frozenset(g) for g in groups.values() if len(g) > 1}


@pytest.mark.parametrize("threshold", [0, 3, 8, 12])
def test_pairs_and_groups_equal_brute_force(threshold):
    d = library.generate(spec("dense", 2500), 11)
    # more chance pairs at a high threshold: some random hashes close together
    got = dedup.near_pairs(d.phash, threshold, "cpu")
    want = brute_pairs(d.phash, threshold)
    assert {tuple(p) for p in got.tolist()} == want and len(got) == len(want)
    groups = {frozenset(g.tolist()) for g in dedup.components(d.n, got)}
    assert groups == brute_groups(d.n, want)


def test_pairs_across_blocks(monkeypatch):
    monkeypatch.setattr(dedup, "BLOCK_ROWS", 64)
    d = library.generate(spec("photos_1m", 1000), 5)
    d.phash[900] = d.phash[3] ^ np.uint64(0b1011)  # a pair across blocks
    got = {tuple(p) for p in dedup.near_pairs(d.phash, 8, "cpu").tolist()}
    assert got == brute_pairs(d.phash, 8) and (3, 900) in got


def test_exact_groups():
    cas = np.array([5, 7, 5, 9, 7, 7, 1], np.uint64)
    got = {frozenset(g.tolist()) for g in dedup.exact_groups(cas)}
    assert got == {frozenset({0, 2}), frozenset({1, 4, 5})}


def test_reference_judges_itself_sound():
    d = library.generate(spec("dense", 4096), 21)
    exp = dedup.expect(d, 8, "cpu")
    assert dedup_groups.judge(exp.as_result(), exp) == dict.fromkeys(dedup_groups.LIMITS, 0)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", ["photos_1m", "dense"])
def test_control_is_not_correct(name, seed):
    """The control (the reference with a multi-index hash's exact-probe
    filter, four 16-bit chunks) loses pairs above 3 bits and fails."""
    d = library.generate(spec(name, 8192), seed)
    exp = dedup.expect(d, 8, "cpu")
    control = dedup.expect(d, 8, "cpu", probe_chunks=4)
    numbers = dedup_groups.judge(control.as_result(), exp)
    assert any(numbers[k] > lim for k, lim in dedup_groups.LIMITS.items()), numbers


def test_reference_on_the_card_equals_the_cpu(cuda):
    d = library.generate(spec("dense", 65536), 8)
    a = dedup.near_pairs(d.phash, 8, "cpu")
    b = dedup.near_pairs(d.phash, 8, cuda)
    assert np.array_equal(a, b)
