"""The library generator: deterministic per seed, with the planted
clusters and exact-copy shares its configuration states."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from sdbench.gen import library

from .conftest import DENSE, REPO


def spec(name: str, files: int) -> dict:
    """A configuration's `library` block at `files` files; "dense" is
    photos_1m's with the tests' denser clusters and copies."""
    with open(os.path.join(REPO, "sdbench", "configs", "photos_1m.json")) as f:
        lib = json.load(f)["library"]
    if name == "dense":
        lib.update(DENSE)
    lib["files"] = files
    return lib


def popcount(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.astype(">u8").view(np.uint8).reshape(-1, 8), axis=1).sum(1)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3, -5])
def test_same_seed_same_library(seed):
    a = library.generate(spec("photos_1m", 8192), seed)
    b = library.generate(spec("photos_1m", 8192), seed)
    for f in ("phash", "cas", "size", "ext", "cluster", "copy_of"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    c = library.generate(spec("photos_1m", 8192), seed + 1)
    assert not np.array_equal(a.phash, c.phash)


@pytest.mark.parametrize("name", ["photos_1m", "dense"])
def test_planted_shares(name):
    n = 20000
    s = spec(name, n)
    d = library.generate(s, 7)
    lo, hi = s["near_cluster_size"]
    members = d.cluster >= 0
    assert abs(members.sum() - s["near_cluster_share"] * n) <= 1
    sizes = np.bincount(d.cluster[members])
    assert sizes.min() >= 2 and sizes.max() <= hi
    assert (sizes[:-1] >= lo).all()
    # every pair in a cluster lies within twice the radius
    for c in range(0, sizes.size, max(1, sizes.size // 50)):
        h = d.phash[d.cluster == c]
        dist = popcount(h[:, None] ^ h[None, :])
        assert dist.max() <= 2 * s["near_cluster_radius"]
    copies = np.flatnonzero(d.copy_of >= 0)
    assert copies.size == round(s["exact_copy_share"] * n)
    orig = d.copy_of[copies]
    assert (d.copy_of[orig] == -1).all() and np.unique(orig).size == orig.size
    for f in ("phash", "cas", "size", "ext"):
        assert np.array_equal(getattr(d, f)[copies], getattr(d, f)[orig])
    # a cas_id is shared only by a copy and its original
    _u, counts = np.unique(d.cas, return_counts=True)
    assert counts.max() == 2 and (counts == 2).sum() == copies.size


def test_cluster_sizes_cycle():
    assert library.cluster_sizes(20, 2, 4) == [2, 3, 4, 2, 3, 4, 2]
    assert library.cluster_sizes(10, 3, 10) == [3, 4, 3]
    assert library.cluster_sizes(3, 2, 4) == [2]


def test_image_kind_is_the_programs():
    from spacedrive_tpu_torch.files.kind import ObjectKind

    assert library.IMAGE_KIND == int(ObjectKind.Image)


def test_installed_library_loads_and_reads_back(tmp_path):
    """The library goes where a node loads it at start: the program's own
    library manager finds it, and every row reads back as generated."""
    import uuid

    from spacedrive_tpu_torch.db.database import blob_u64
    from spacedrive_tpu_torch.node.library import Libraries
    from spacedrive_tpu_torch.node.node import Node

    config = {"name": "t", "library": spec("dense", 3000)}
    d = library.make(config, 3)
    node = Node(str(tmp_path / "node"), device="cpu")
    lib_id = library.install(node, config, d, 3, str(tmp_path))
    libs = Libraries(node.data_dir)
    libs.load_all()
    db = libs.get(uuid.UUID(lib_id)).db
    try:
        assert db.query("PRAGMA journal_mode")[0]["journal_mode"] == "wal"
        assert db.query("PRAGMA integrity_check")[0]["integrity_check"] == "ok"
        assert db.query("PRAGMA foreign_key_check") == []
        assert db.query("SELECT count(*) AS n FROM instance")[0]["n"] == 1
        assert db.query("SELECT count(*) AS n FROM indexer_rule")[0]["n"] > 0
        names = {r["name"] for r in db.query("SELECT name FROM sqlite_master WHERE type = "
                                             "'index' AND tbl_name = 'file_path'")}
        assert {"idx_file_path_cas", "idx_file_path_object"} <= names
        rows = db.query("SELECT o.id, o.phash, fp.name, fp.extension, fp.materialized_path, "
                        "fp.cas_id, fp.size_in_bytes_bytes FROM object o "
                        "JOIN file_path fp ON fp.object_id = o.id ORDER BY o.id")
    finally:
        db.close()
    assert len(rows) == d.n
    ph = d.phash_bytes()
    for r in rows[::97]:
        i = r["id"] - 1
        assert r["phash"] == ph[i].tobytes()
        assert (r["name"], r["extension"], r["materialized_path"], r["cas_id"]) == (
            d.name(i), d.extension(i), d.materialized_path(i), d.cas_id(i))
        assert blob_u64(r["size_in_bytes_bytes"]) == int(d.size[i])
