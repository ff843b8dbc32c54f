"""The port's search (vector-index query, probes, the search API) against
the JAX package's.

- `LibraryIndex.query` against the JAX one on one matrix with duplicate
  rows: the same ids in the same order, equal scores tied by the lower
  row, scores allclose 1e-5 (float32 sums in another order);
- `probe_for` by image path and by label name: allclose 1e-5;
- `search_paths`, `search_objects` and `search_semantic` over two
  libraries that each package's scan chain built from one seeded tree:
  the same rows (the columns both packages fill alike) in the same
  order, scores allclose 1e-5;
- the query cases of tests/test_semantic_search.py on the port;
- `python -m spacedrive_tpu_torch search [--semantic]` against
  `sdx search [--semantic]`.
"""

import asyncio
import json
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image

import spacedrive_tpu.api.search as japi
import spacedrive_tpu.jobs as jjobs
import spacedrive_tpu.location.locations as jlocations
import spacedrive_tpu.node.library as jlibrary
import spacedrive_tpu.object.media.thumbnail as jthumb
import spacedrive_tpu.object.search.index as jindex
import spacedrive_tpu.tasks as jtasks
import spacedrive_tpu_torch.api.search as papi
import spacedrive_tpu_torch.jobs as pjobs
import spacedrive_tpu_torch.location.locations as plocations
import spacedrive_tpu_torch.node.library as plibrary
import spacedrive_tpu_torch.object.media.thumbnail.actor as pactor
import spacedrive_tpu_torch.object.search.index as pindex
import spacedrive_tpu_torch.tasks as ptasks
from spacedrive_tpu_torch import cli

JAX = types.SimpleNamespace(
    JobManager=jjobs.JobManager, TaskSystem=jtasks.TaskSystem, Libraries=jlibrary.Libraries,
    LocationCreateArgs=jlocations.LocationCreateArgs, scan_location=jlocations.scan_location,
    thumbnailer=lambda d: jthumb.Thumbnailer(d), index=jindex, api=japi,
)
PORT = types.SimpleNamespace(
    JobManager=pjobs.JobManager, TaskSystem=ptasks.TaskSystem, Libraries=plibrary.Libraries,
    LocationCreateArgs=plocations.LocationCreateArgs, scan_location=plocations.scan_location,
    thumbnailer=lambda d: pactor.Thumbnailer(d, device="cpu"), index=pindex, api=papi,
)

#: file_path / object columns each package fills on its own (random
#: pub_ids, the time of the scan)
UNSHARED = {"pub_id", "date_indexed", "date_created"}


def _unit_rows(rng, n):
    m = rng.normal(size=(n, 128)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _index(pkg, matrix):
    """A LibraryIndex of `pkg` over `matrix`, without a library DB."""
    idx = pkg.index.LibraryIndex(types.SimpleNamespace(node=None))
    idx._matrix = matrix
    idx._ids = [1000 + i for i in range(len(matrix))]
    idx._pos = {oid: i for i, oid in enumerate(idx._ids)}
    idx._loaded = True
    return idx


def test_query_matches_jax_with_ties_by_the_lower_row():
    rng = np.random.default_rng(0)
    matrix = _unit_rows(rng, 600)
    # duplicate rows: exact score ties wherever they land in the ranking
    for src, dsts in ((5, (17, 300, 599)), (40, (41,)), (123, (7, 450))):
        for d in dsts:
            matrix[d] = matrix[src]
    port, jax = _index(PORT, matrix), _index(JAX, matrix)
    probes = [matrix[5], matrix[123], matrix[40] * 3.0] + list(rng.normal(size=(5, 128)))
    for probe in probes:
        for k in (1, 4, 10, 600, 1000):
            got = port.query(probe, k=k, device="cpu")
            want = jax.query(probe, k=k)
            assert [i for i, _ in got] == [i for i, _ in want]
            np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                       atol=1e-5, rtol=1e-5)
    # the tie order itself: rows 5, 17, 300, 599 hold one vector
    got = port.query(matrix[5], k=4, device="cpu")
    assert [i - 1000 for i, _ in got] == [5, 17, 300, 599]
    assert len({s for _, s in got}) == 1
    assert port.query(probes[0], k=0, device="cpu") == []


def test_score_top_k_orders_ties_by_row_on_a_shuffled_matrix():
    """Every row tied with several others: the ranking is a stable
    descending sort of the scores (np.argsort(-s, kind="stable"))."""
    rng = np.random.default_rng(1)
    base = _unit_rows(rng, 40)
    matrix = base[rng.integers(0, 40, 1000)]
    probe = torch.from_numpy(base[3])
    scores, rows = pindex.score_top_k(torch.from_numpy(matrix), probe, 200)
    s = (torch.from_numpy(matrix) * probe).sum(dim=1).numpy()
    assert rows.tolist() == np.argsort(-s, kind="stable")[:200].tolist()
    assert np.array_equal(scores.numpy(), s[rows.numpy()])


# --- both packages' libraries ------------------------------------------------


def _gradient_image(rng, size=48):
    """Smooth random sinusoid field, so a q40 JPEG re-encode stays a
    clear nearest neighbour."""
    yy, xx = np.mgrid[0:size, 0:size] / float(size)
    a, b, c = rng.uniform(-3, 3, 3)
    img = np.stack([np.sin(a * xx + b * yy + c + k) * 0.5 + 0.5 for k in range(3)], axis=-1)
    return (img * 255).astype(np.uint8)


def _image_corpus(root, n=12, seed=0, dup_of=3):
    """n structured PNGs, a planted near-duplicate (a q40 JPEG re-encode
    of img<dup_of>), an exact copy and a few non-images. Returns the
    source image's path."""
    os.makedirs(os.path.join(root, "sub"), exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(_gradient_image(rng)).save(os.path.join(root, f"img{i:02d}.png"))
    src = os.path.join(root, f"img{dup_of:02d}.png")
    Image.open(src).save(os.path.join(root, "dup.jpg"), quality=40)
    with open(src, "rb") as f, open(os.path.join(root, "sub", "copy_img.png"), "wb") as g:
        g.write(f.read())
    for i in range(4):
        with open(os.path.join(root, "sub", f"notes{i}.txt"), "wb") as f:
            f.write(rng.bytes(int(rng.integers(10, 5000))))
    return src


class _Node:
    def __init__(self, thumbnailer):
        self.thumbnailer = thumbnailer
        self.image_labeler = None
        self.device = torch.device("cpu")  # the port reads it; the JAX package does not


class _Chain:
    def __init__(self, pkg, data_dir):
        self.pkg = pkg
        self.node = _Node(pkg.thumbnailer(os.path.join(data_dir, "thumbnails")))
        self.lib = pkg.Libraries(data_dir, node=self.node).create("semantic")
        self.mgr = pkg.JobManager(pkg.TaskSystem(2))

    async def scan(self, loc):
        loc_row = self.pkg.LocationCreateArgs(path=str(loc)).create(self.lib)
        await self.pkg.scan_location(self.lib, loc_row, self.mgr, backend="cpu")
        for _ in range(200):
            await self.mgr.wait_idle()
            rows = self.lib.db.query("SELECT status FROM job")
            if len(rows) >= 3 and all(r["status"] in (2, 6) for r in rows):
                break
            await asyncio.sleep(0.02)
        await self.node.thumbnailer.wait_library_batch(str(self.lib.id))

    def label(self, name, file_names):
        lid = self.lib.db.insert("label", name=name)
        for fn in file_names:
            fp = self.lib.db.find_one("file_path", name=fn)
            self.lib.db.insert("label_on_object", label_id=lid, object_id=fp["object_id"])

    async def close(self):
        await self.node.thumbnailer.shutdown()
        await self.mgr.system.shutdown()
        self.lib.close()


def _shared(out):
    """A search result without the columns each package fills alone; the
    scores split off to compare with a tolerance."""
    nodes = [{k: v for k, v in n.items() if k not in UNSHARED and k != "score"}
             for n in out["nodes"]]
    rest = {k: v for k, v in out.items() if k not in ("nodes", "scores")}
    return rest, nodes, [n.get("score") for n in out["nodes"]]


def _same_result(port, jax):
    prest, pnodes, pscores = _shared(port)
    jrest, jnodes, jscores = _shared(jax)
    assert prest == jrest
    assert pnodes == jnodes
    if any(s is not None for s in jscores):
        np.testing.assert_allclose(pscores, jscores, atol=1e-5, rtol=1e-5)


QUERIES = [
    ("paths", {"filter": {"search": "img"}, "take": 5}),
    ("paths", {"filter": {"search": "img"}, "take": 4, "orderBy": "sizeInBytes",
               "orderDir": "desc"}),
    ("paths", {"filter": {"extension": "PNG", "path": "/"}, "take": 100}),
    ("paths", {"filter": {"kinds": [5], "hidden": False}, "orderBy": "dateModified"}),
    ("paths", {"filter": {"labels": [1]}, "take": 10}),
    ("objects", {"take": 6}),
    ("objects", {"filter": {"search": "img0"}, "orderBy": "dateAccessed", "orderDir": "desc"}),
    ("objects", {"filter": {"kinds": [5]}, "take": 3}),
]


async def test_search_api_matches_jax_over_one_tree(tmp_path):
    corpus = tmp_path / "corpus"
    src = _image_corpus(str(corpus))
    jax, port = _Chain(JAX, str(tmp_path / "jax")), _Chain(PORT, str(tmp_path / "port"))
    try:
        for chain in (jax, port):
            await chain.scan(corpus)
            # three objects: a centroid of two scores both exactly alike
            # in exact arithmetic, and float rounding would pick the first
            chain.label("skyline", ["img00", "img01", "img05"])

        for kind, arg in QUERIES:
            fn = "search_paths" if kind == "paths" else "search_objects"
            got = getattr(papi, fn)(port.lib, dict(arg))
            want = getattr(japi, fn)(jax.lib, dict(arg))
            _same_result(got, want)
            assert got["items"], (kind, arg)
            # the next page through the cursor
            if got["cursor"] is not None:
                _same_result(getattr(papi, fn)(port.lib, {**arg, "cursor": got["cursor"]}),
                             getattr(japi, fn)(jax.lib, {**arg, "cursor": want["cursor"]}))

        for query in (src, str(corpus / "dup.jpg"), "skyline"):
            for take in (1, 3, 100):
                got = papi.search_semantic(port.lib, {"query": query, "take": take})
                want = japi.search_semantic(jax.lib, {"query": query, "take": take})
                _same_result(got, want)
                assert got["resolved"] is True

        # probes: by image path and by label centroid
        for query in (src, "skyline"):
            np.testing.assert_allclose(pindex.probe_for(port.lib, query),
                                       jindex.probe_for(jax.lib, query), atol=1e-5, rtol=1e-5)
        assert pindex.probe_for(port.lib, "no-such-label") is None
    finally:
        await jax.close()
        await port.close()


async def test_semantic_search_cases_on_the_port(tmp_path):
    """tests/test_semantic_search.py's query cases: a probe image ranks
    itself first and the planted re-encode second; a label name probes
    with its objects' centroid; an unresolvable query is an empty,
    unresolved result; an empty query is a bad request."""
    corpus = tmp_path / "corpus"
    src = _image_corpus(str(corpus))
    chain = _Chain(PORT, str(tmp_path / "port"))
    try:
        await chain.scan(corpus)
        lib = chain.lib
        out = papi.search_semantic(lib, {"query": src, "take": 3})
        assert out["resolved"] is True
        names = [n["name"] + "." + n["extension"] for n in out["nodes"]]
        assert names[0] == "img03.png" and names[1] == "dup.jpg"
        assert all(s <= 1.0001 for s in out["scores"].values())
        assert abs(out["nodes"][0]["score"] - 1.0) <= 1e-5

        chain.label("skyline", ["img00", "img01"])
        probe = pindex.probe_for(lib, "skyline")
        assert probe is not None and probe.shape == (128,)
        hits = pindex.query(lib, probe, k=2)
        want = {lib.db.find_one("file_path", name=n)["object_id"] for n in ("img00", "img01")}
        assert {h[0] for h in hits} == want

        assert papi.search_semantic(lib, {"query": "no-such-label"}) == \
            {"items": [], "nodes": [], "scores": {}, "resolved": False}
        with pytest.raises(papi.RspcError):
            papi.search_semantic(lib, {"query": ""})
        with pytest.raises(papi.RspcError):
            papi.search_paths(lib, {"take": 0})
        with pytest.raises(papi.RspcError):
            papi.search_paths(lib, {"orderBy": "nope"})
        with pytest.raises(papi.RspcError):
            papi.search_objects(lib, {"cursor": ["x"]})
    finally:
        await chain.close()


@pytest.mark.parametrize("semantic", [False, True])
def test_cli_search_matches_sdx(tmp_path, capsys, semantic):
    from spacedrive_tpu import cli as jcli

    corpus = tmp_path / "corpus"
    src = _image_corpus(str(corpus), n=6)
    pdata, jdata = str(tmp_path / "port"), str(tmp_path / "jax")
    assert cli.main(["index", str(corpus), "--data-dir", pdata, "--library", "L",
                     "--device", "cpu"]) == 0
    assert jcli.main(["--data-dir", jdata, "index", str(corpus), "--library", "L",
                      "--backend", "cpu", "--no-p2p"]) == 0
    capsys.readouterr()
    query, flags = (src, ["--semantic"]) if semantic else ("img0", [])
    assert cli.main(["search", query, "--data-dir", pdata, "--library", "L", "--take", "4",
                     "--device", "cpu", *flags]) == 0
    port = json.loads(capsys.readouterr().out)
    assert jcli.main(["--data-dir", jdata, "search", query, "--library", "L", "--take", "4",
                      *flags]) == 0
    jax = json.loads(capsys.readouterr().out)
    _same_result(port, jax)
    assert len(port["nodes"]) == 4
    if semantic:
        assert port["nodes"][0]["name"] == "img03" and port["resolved"] is True
        np.testing.assert_allclose(sorted(port["scores"].values()),
                                   sorted(jax["scores"].values()), atol=1e-5, rtol=1e-5)
        # a query that names no image and no label: exit 1 in both
        assert cli.main(["search", "nothing", "--semantic", "--data-dir", pdata,
                         "--library", "L", "--device", "cpu"]) == 1
        assert jcli.main(["--data-dir", jdata, "search", "nothing", "--semantic",
                          "--library", "L"]) == 1
        assert "resolved to no probe vector" in capsys.readouterr().err
