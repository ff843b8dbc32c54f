"""The port's spans inside a duplicates pass.

`object/duplicates.find_duplicates` and `ops/phash_torch` record, under
one pass, the tree

    duplicates                 (fields objects, pairs, groups)
      duplicates.select
      duplicates.near
        duplicates.near.prepare
        duplicates.near.block  (one a PAIR_BLOCK rows; device_s on a card)
        duplicates.near.components
      duplicates.exact
      duplicates.files

each record in the trace ring with `pc0`, its start on
`time.perf_counter()`. The groups are held against a plain reference
(Hamming distances by XOR, union-find in Python); no span stays open
across the pair search's yields. The card's case skips without one (the
condition is a string, evaluated when the test runs), and the file
imports nothing of JAX.
"""

import math
import time
import types

import numpy as np
import pytest
import torch

import spacedrive_tpu_torch.telemetry as telemetry
from spacedrive_tpu_torch.db.database import LibraryDb
from spacedrive_tpu_torch.object.duplicates import find_duplicates
from spacedrive_tpu_torch.ops import phash_torch
from spacedrive_tpu_torch.telemetry import trace

N = 9000  # three blocks of PAIR_BLOCK rows
THRESHOLD = 8
TREE = {
    "duplicates": None,
    "duplicates.select": "duplicates",
    "duplicates.near": "duplicates",
    "duplicates.near.prepare": "duplicates.near",
    "duplicates.near.block": "duplicates.near",
    "duplicates.near.components": "duplicates.near",
    "duplicates.exact": "duplicates",
    "duplicates.files": "duplicates",
}


@pytest.fixture(autouse=True)
def _reset_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


def _bits(n=N, seed=7):
    """Random 64-bit hashes with planted pairs 1-5 bits apart."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n, 64)).astype(bool)
    for c in range(0, n - 10, 13):
        bits[c + 1] = bits[c]
        bits[c + 1, rng.choice(64, int(rng.integers(1, 6)), replace=False)] ^= True
    return bits


def _reference_groups(bits, ids, threshold):
    """Groups by XOR distance and a plain union-find: ids in input
    order, groups in the order of their first id."""
    words = np.packbits(bits, axis=1).view(">u8").ravel()
    parent = list(range(len(ids)))

    def find(x):
        while parent[x] != x:
            x = parent[x]
        return x

    pairs = 0
    for i in range(len(ids)):
        x = words[i] ^ words[i + 1:]
        dist = np.unpackbits(x.view(np.uint8).reshape(-1, 8), axis=1).sum(axis=1)
        for j in np.flatnonzero(dist <= threshold) + i + 1:
            pairs += 1
            ra, rb = find(i), find(int(j))
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
    groups = {}
    for k in range(len(ids)):
        groups.setdefault(find(k), []).append(ids[k])
    return [g for g in groups.values() if len(g) > 1], pairs


def _library(bits):
    """An in-memory library: an object a hash, a file row each, and a
    second object with the file content (cas_id) of every 500th. Returns
    it with its exact groups, sorted."""
    db = LibraryDb(None, memory=True)
    hashes = [h.tobytes() for h in np.packbits(bits, axis=1)]
    db.executemany("INSERT INTO object (id, pub_id, phash) VALUES (?, ?, ?)",
                   [(k + 1, b"o%d" % k, h) for k, h in enumerate(hashes)])
    rows = [(k + 1, b"f%d" % k, f"c{k}", f"n{k}", (k * 11).to_bytes(8, "little"))
            for k in range(len(hashes))]
    copies = range(0, len(hashes) - 1, 500)
    rows += [(k + 2, b"g%d" % k, f"c{k}", f"copy{k}", None) for k in copies]
    db.executemany("INSERT INTO file_path (object_id, pub_id, cas_id, name, extension, "
                   "materialized_path, size_in_bytes_bytes) VALUES (?, ?, ?, ?, 'jpg', '/', ?)",
                   rows)
    return types.SimpleNamespace(db=db), [[k + 1, k + 2] for k in copies]


def _records_of_last_pass():
    root = [r for r in trace.recent() if r["stage"] == "duplicates"][-1]
    return root, trace.recent(root["trace_id"])


def _inside(child, parent):
    return (parent["pc0"] <= child["pc0"]
            and child["pc0"] + child["seconds"] <= parent["pc0"] + parent["seconds"])


def test_a_pass_records_the_tree_on_the_perf_counter_clock():
    bits = _bits()
    library, exact = _library(bits)
    t0 = time.perf_counter()
    out = find_duplicates(library, THRESHOLD, "cpu")
    t1 = time.perf_counter()
    root, recs = _records_of_last_pass()
    stages = [r["stage"] for r in recs]
    assert sorted(set(stages)) == sorted(TREE)
    assert stages.count("duplicates.near.block") == math.ceil(N / phash_torch.PAIR_BLOCK) == 3
    assert all(stages.count(s) == 1 for s in TREE if s != "duplicates.near.block")
    by_id = {r["span_id"]: r for r in recs}
    for r in recs:
        assert t0 <= r["pc0"] and r["pc0"] + r["seconds"] <= t1
        assert "device_s" not in (r.get("fields") or {})
        assert r["error"] is None
        if TREE[r["stage"]] is not None:
            parent = by_id[r["parent_id"]]
            assert parent["stage"] == TREE[r["stage"]] and _inside(r, parent)
    blocks = sorted((r for r in recs if r["stage"] == "duplicates.near.block"),
                    key=lambda r: r["pc0"])
    for a, b in zip(blocks, blocks[1:]):
        assert a["pc0"] + a["seconds"] <= b["pc0"]
    _groups, pairs = _reference_groups(bits, list(range(1, N + 1)), THRESHOLD)
    assert root["fields"] == {"objects": N, "pairs": pairs, "groups": len(out)}
    assert sorted(g["object_ids"] for g in out if g["kind"] == "exact") == exact


def test_the_groups_equal_the_reference():
    bits = _bits()
    library, exact = _library(bits)
    ids = list(range(1, N + 1))
    want, _pairs = _reference_groups(bits, ids, THRESHOLD)
    assert len(want) > 600
    out = find_duplicates(library, THRESHOLD, "cpu")
    assert [g["object_ids"] for g in out if g["kind"] == "near"] == want
    assert sorted(g["object_ids"] for g in out if g["kind"] == "exact") == exact
    for g in out:
        assert sorted(f["name"] for f in g["files"]) == sorted(
            [f"n{k - 1}" for k in g["object_ids"]]
            + [f"copy{k - 2}" for k in g["object_ids"] if k >= 2 and (k - 2) % 500 == 0])


def test_a_direct_grouping_records_its_own_root():
    """The chain case of tests/test_torch_phash.py, with no enclosing span:
    the grouping is a root `near` and annotates nothing outside it."""
    h0 = b"\x00" * 8
    h1 = b"\x01" + b"\x00" * 7
    h2 = b"\x03" + b"\x00" * 7
    far = b"\xff" * 8
    groups = phash_torch.duplicate_groups([("a", h0), ("b", h1), ("c", h2), ("d", far)],
                                          threshold=1, device="cpu")
    assert groups == [["a", "b", "c"]]
    recs = trace.recent()
    near = [r for r in recs if r["stage"] == "near"]
    assert len(near) == 1 and near[0]["parent_id"] is None and "fields" not in near[0]
    assert sorted(r["stage"] for r in recs if r["parent_id"] == near[0]["span_id"]) == [
        "near.block", "near.components", "near.prepare"]
    assert phash_torch.duplicate_groups([], device="cpu") == []


@pytest.mark.parametrize("outer", [None, "consumer"])
def test_a_closed_pair_search_leaves_no_span_open(outer):
    hashes = [h.tobytes() for h in np.packbits(_bits(n=5000), axis=1)]

    def consume():
        pairs = phash_torch.near_pairs(hashes, THRESHOLD, "cpu")
        first = next(pairs)
        assert telemetry.current_span() is consumer  # nothing leaked from the block
        pairs.close()
        return first

    if outer is None:
        consumer = None
        first = consume()
    else:
        with telemetry.span(outer) as consumer:
            first = consume()
    assert first == (0, 1)
    assert telemetry.current_span() is None and trace.current() is None
    prefix = "" if outer is None else f"{outer}."
    assert [r["stage"] for r in trace.recent()] == [
        f"{prefix}prepare", f"{prefix}block"] + ([outer] if outer else [])


def test_every_span_stamps_its_start_on_the_perf_counter():
    t0 = time.perf_counter()
    with telemetry.span("x"):
        with telemetry.span("y"):
            pass
    t1 = time.perf_counter()
    y, x = trace.recent()
    assert t0 <= x["pc0"] <= y["pc0"] <= y["pc0"] + y["seconds"] <= x["pc0"] + x["seconds"] <= t1
    # the span ring's records and the Chrome export stay as they were
    assert all("pc0" not in r for r in telemetry.recent_spans())
    assert all("pc0" not in e["args"] for e in trace.export()["traceEvents"])


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device (CUDA events time the blocks on a card)")
def test_every_block_carries_its_device_time_on_a_card():
    bits = _bits()
    library, exact = _library(bits)
    want, _pairs = _reference_groups(bits, list(range(1, N + 1)), THRESHOLD)
    out = find_duplicates(library, THRESHOLD, "cuda")
    assert [g["object_ids"] for g in out if g["kind"] == "near"] == want
    assert sorted(g["object_ids"] for g in out if g["kind"] == "exact") == exact
    _root, recs = _records_of_last_pass()
    blocks = [r for r in recs if r["stage"] == "duplicates.near.block"]
    assert len(blocks) == 3
    for r in blocks:
        assert 0 < r["fields"]["device_s"] <= r["seconds"]
    assert all("device_s" not in (r.get("fields") or {}) for r in recs if r not in blocks)
