"""The port's pHash and duplicate detection against the JAX package's.

`ops/phash_torch.py` against `spacedrive_tpu/ops/phash_jax.py` on the
CPU, on the same seeded inputs:

- `_dct_basis` and `to_gray32` equal;
- pHash bits equal, except where a coefficient lies within
  EPS × max|coefficient| of its row's median (the JAX DCT runs in
  float32, the port's in float64); such flips are counted, and the
  count asserted;
- `hamming_matrix`, `near_pairs` and `duplicate_groups` exact on the
  same packed hashes at N ∈ {1, 7, 4096, 4097} (4097 crosses the
  PAIR_BLOCK pad);
- the JAX package's tests/test_phash.py cases on the port (properties,
  gram against XOR, union-find, the job end to end);
- both packages' scan chain and DuplicateDetectorJob over one seeded
  tree: `object.phash` bytes, journal payloads and `find_duplicates`
  groups equal; and `python -m spacedrive_tpu_torch duplicates` against
  `sdx duplicates` on one seeded library.
"""

import asyncio
import json
import os
import types

import numpy as np
import pytest
from PIL import Image

import spacedrive_tpu.jobs as jjobs
import spacedrive_tpu.location.locations as jlocations
import spacedrive_tpu.node.library as jlibrary
import spacedrive_tpu.object.duplicates as jduplicates
import spacedrive_tpu.object.media.thumbnail as jthumb
import spacedrive_tpu.tasks as jtasks
import spacedrive_tpu_torch.jobs as pjobs
import spacedrive_tpu_torch.location.locations as plocations
import spacedrive_tpu_torch.node.library as plibrary
import spacedrive_tpu_torch.object.duplicates as pduplicates
import spacedrive_tpu_torch.object.media.thumbnail.actor as pactor
import spacedrive_tpu_torch.tasks as ptasks
from spacedrive_tpu.ops import phash_jax
from spacedrive_tpu_torch import cli
from spacedrive_tpu_torch.ops import phash_torch
from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

#: a bit may differ from the JAX package's only where its coefficient
#: lies within EPS × max|coefficient| of the row's median: the JAX DCT
#: rounds to float32 (relative error ~1e-7 of the largest term)
EPS = 1e-5

JAX = types.SimpleNamespace(
    JobManager=jjobs.JobManager, JobBuilder=jjobs.JobBuilder, TaskSystem=jtasks.TaskSystem,
    Libraries=jlibrary.Libraries, LocationCreateArgs=jlocations.LocationCreateArgs,
    scan_location=jlocations.scan_location, thumbnailer=lambda d: jthumb.Thumbnailer(d),
    DuplicateDetectorJob=jduplicates.DuplicateDetectorJob,
    find_duplicates=jduplicates.find_duplicates,
)
PORT = types.SimpleNamespace(
    JobManager=pjobs.JobManager, JobBuilder=pjobs.JobBuilder, TaskSystem=ptasks.TaskSystem,
    Libraries=plibrary.Libraries, LocationCreateArgs=plocations.LocationCreateArgs,
    scan_location=plocations.scan_location,
    thumbnailer=lambda d: pactor.Thumbnailer(d, device="cpu"),
    DuplicateDetectorJob=pduplicates.DuplicateDetectorJob,
    find_duplicates=lambda lib, threshold: pduplicates.find_duplicates(lib, threshold, "cpu"),
)


def _img(color, size=(128, 96), noise=0.0, seed=0):
    """Photo-like fixture: blurred random structure (smooth gradients are
    pathological for pHash: near-zero AC energy makes bits coin flips)."""
    from PIL import ImageFilter

    rng = np.random.default_rng(seed)
    base = (rng.random((size[1], size[0], 3)) * 255).astype(np.uint8)
    img = Image.fromarray(base).filter(ImageFilter.GaussianBlur(6))
    rgb = np.asarray(img).astype(np.float64)
    rgb = np.clip(rgb * 0.6 + np.asarray(color, np.float64) * 0.4, 0, 255)
    if noise:
        rgb = np.clip(rgb + rng.normal(0, noise * 255, rgb.shape), 0, 255)
    return np.dstack([rgb.astype(np.uint8), np.full((size[1], size[0], 1), 255, np.uint8)])


def _hamming(a: bytes, b: bytes) -> int:
    return int((np.unpackbits(np.frombuffer(a, np.uint8))
                ^ np.unpackbits(np.frombuffer(b, np.uint8))).sum())


def _hashes(n: int, seed: int) -> list[bytes]:
    """n seeded hashes: random ones plus planted clusters (a centre and
    copies with 1-4 flipped bits), so pairs exist under any threshold."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n, 64)).astype(bool)
    for c in range(0, n - 3, 11):  # every 11th row seeds a cluster of 3
        for j in (1, 2):
            row = bits[c].copy()
            row[rng.choice(64, int(rng.integers(1, 5)), replace=False)] ^= True
            bits[c + j] = row
    return [h.tobytes() for h in np.packbits(bits, axis=1)]


# --- the op against phash_jax ---------------------------------------------


def test_dct_basis_and_gray_planes_equal_jax():
    assert np.array_equal(phash_torch._dct_basis(), phash_jax._dct_basis())
    rgba = _img((90, 30, 200), size=(211, 97), seed=3)
    assert np.array_equal(phash_torch.to_gray32(rgba), phash_jax.to_gray32(rgba))


def test_phash_bits_equal_jax_except_near_the_median():
    rng = np.random.default_rng(7)
    planes = [rng.random((32, 32), dtype=np.float32) for _ in range(200)]
    planes += [phash_torch.to_gray32(_img((rng.integers(256), 90, 40), seed=s)) for s in range(56)]
    # exact ties in the plane (flat and two-level) put coefficients on the median
    planes += [np.full((32, 32), 0.5, np.float32),
               np.kron(np.eye(2, dtype=np.float32), np.ones((16, 16), np.float32))]
    gray = np.stack(planes)
    port = np.unpackbits(phash_torch.phash_batch(gray, "cpu"), axis=1).astype(bool)
    jax = np.unpackbits(phash_jax.phash_batch(gray), axis=1).astype(bool)
    import torch

    ac = phash_torch.dct_low(torch.from_numpy(gray)).numpy()
    med = np.median(ac[:, 1:], axis=1, keepdims=True)
    near = np.abs(ac - med) <= EPS * np.abs(ac).max(axis=1, keepdims=True)
    flips = port != jax
    assert not (flips & ~near).any(), "a bit away from the median differs from the JAX package"
    # 258 rows x 64 bits: the flips are the near-median bits of the two
    # planes with exact ties, at most, and nowhere else
    assert int(flips.sum()) <= int(near[-2:].sum())
    assert int(flips[:-2].sum()) == 0


@pytest.mark.parametrize("n", [1, 7, 4096, 4097])
def test_hamming_near_pairs_and_groups_exact_on_equal_hashes(n):
    hashes = _hashes(n, seed=n)
    assert np.array_equal(phash_torch.hamming_matrix(hashes, "cpu"),
                          phash_jax.hamming_matrix(hashes))
    for threshold in (0, 4, 10):
        got = list(phash_torch.near_pairs(hashes, threshold, "cpu"))
        assert got == list(phash_jax.near_pairs(hashes, threshold))
        assert all(_hamming(hashes[i], hashes[j]) <= threshold and i < j for i, j in got)
    ids = [f"o{i}" for i in range(n)]
    pairs = list(zip(ids, hashes))
    got = phash_torch.duplicate_groups(pairs, threshold=4, device="cpu")
    assert got == phash_jax.duplicate_groups(pairs, threshold=4)
    assert (len(got) > 0) == (n > 3)


# --- tests/test_phash.py on the port ------------------------------------------


def test_phash_properties():
    base = _img((200, 40, 40))
    same = phash_torch.phash_one(base, "cpu")
    assert len(same) == 8
    assert phash_torch.phash_one(base, "cpu") == same  # deterministic
    small = np.asarray(Image.fromarray(base).resize((64, 48)).convert("RGBA"))
    assert _hamming(same, phash_torch.phash_one(small, "cpu")) <= 6  # resize-invariant-ish
    noisy = _img((200, 40, 40), noise=0.02, seed=0)  # same structure + noise
    assert _hamming(same, phash_torch.phash_one(noisy, "cpu")) <= 10
    other = _img((10, 220, 30), seed=2)  # different random structure
    assert _hamming(same, phash_torch.phash_one(other, "cpu")) > 12


def test_hamming_matmul_matches_xor():
    rng = np.random.default_rng(0)
    hashes = [rng.integers(0, 256, 8, np.uint8).tobytes() for _ in range(17)]
    mat = phash_torch.hamming_matrix(hashes, "cpu")
    assert mat.shape == (17, 17) and mat.dtype == np.uint8
    for i in range(17):
        assert mat[i, i] == 0
        for j in range(17):
            assert mat[i, j] == _hamming(hashes[i], hashes[j])


def test_duplicate_groups_union_find():
    h0 = b"\x00" * 8
    h1 = b"\x01" + b"\x00" * 7  # 1 bit from h0
    h2 = b"\x03" + b"\x00" * 7  # 1 bit from h1, 2 from h0 (chain merge)
    far = b"\xff" * 8
    groups = phash_torch.duplicate_groups([("a", h0), ("b", h1), ("c", h2), ("d", far)],
                                          threshold=1, device="cpu")
    assert sorted(groups[0]) == ["a", "b", "c"] and len(groups) == 1


def _pics(corpus):
    """original.jpg, its recompressed and slightly resized copy, a
    distinct image, and a byte-for-byte copy of the original."""
    corpus.mkdir(parents=True)
    base = _img((180, 80, 40), size=(200, 150))
    Image.fromarray(base).convert("RGB").save(corpus / "original.jpg", quality=95)
    Image.fromarray(base).convert("RGB").resize((190, 142)).save(corpus / "copy.jpg", quality=70)
    Image.fromarray(_img((20, 200, 60), size=(200, 150), seed=5)).convert("RGB").save(
        corpus / "other.jpg")
    Image.fromarray(_img((60, 60, 160), size=(160, 160), seed=9)).save(corpus / "blue.png")
    (corpus / "sub").mkdir()
    (corpus / "sub" / "same.jpg").write_bytes((corpus / "original.jpg").read_bytes())


class _Node:  # the test_e2e_index stub: a thumbnailer and no labeler
    def __init__(self, thumbnailer, device=None):
        self.thumbnailer = thumbnailer
        self.image_labeler = None
        self.device = device


class _Chain:
    """One package's library, job manager and node stub."""

    def __init__(self, pkg, data_dir):
        import torch

        self.pkg = pkg
        self.node = _Node(pkg.thumbnailer(os.path.join(data_dir, "thumbnails")),
                          torch.device("cpu"))
        self.lib = pkg.Libraries(data_dir, node=self.node).create("dups")
        self.mgr = pkg.JobManager(pkg.TaskSystem(2))

    async def scan(self, loc):
        loc_row = self.lib.db.find_one("location", path=str(loc))
        if loc_row is None:
            loc_row = self.pkg.LocationCreateArgs(path=str(loc)).create(self.lib)
        await self.pkg.scan_location(self.lib, loc_row, self.mgr, backend="cpu")
        for _ in range(200):
            await self.mgr.wait_idle()
            rows = self.lib.db.query("SELECT status FROM job")
            if len(rows) >= 3 and all(r["status"] in (2, 6) for r in rows):
                break
            await asyncio.sleep(0.02)
        await self.node.thumbnailer.wait_library_batch(str(self.lib.id))

    async def detect(self, threshold=10):
        job = self.pkg.DuplicateDetectorJob({"threshold": threshold})
        await self.pkg.JobBuilder(job).spawn(self.mgr, self.lib)
        await self.mgr.wait_idle()
        row = self.lib.db.find_one("job", id=job.id.bytes)
        assert row["status"] == 2, row
        return unpackb(row["metadata"])

    def snapshot(self, threshold=10):
        db = self.lib.db
        cas_of = {r["object_id"]: r["cas_id"] for r in db.query(
            "SELECT object_id, cas_id FROM file_path WHERE object_id IS NOT NULL")}
        phash = {cas_of[r["id"]]: bytes(r["phash"]) for r in db.query(
            "SELECT id, phash FROM object WHERE phash IS NOT NULL")}
        journal = {(r["materialized_path"], r["name"], r["extension"]):
                   (bytes(r["payload"]), r["cas_id"]) for r in db.query("SELECT * FROM index_journal")}
        groups = [(g["kind"], [cas_of[o] for o in g["object_ids"]], g["files"])
                  for g in self.pkg.find_duplicates(self.lib, threshold)]
        return phash, journal, groups

    async def close(self):
        await self.node.thumbnailer.shutdown()
        await self.mgr.system.shutdown()
        self.lib.close()


async def test_duplicate_job_end_to_end(tmp_path):
    corpus = tmp_path / "corpus"
    _pics(corpus)
    chain = _Chain(PORT, str(tmp_path / "port"))
    try:
        await chain.scan(corpus)
        meta = await chain.detect()
        assert meta["hashed"] == 4 and meta["duplicate_groups"] == 1
        assert chain.lib.db.count("object", "phash IS NOT NULL") == 4
        groups = PORT.find_duplicates(chain.lib, 10)
        near = [g for g in groups if g["kind"] == "near"]
        assert len(near) == 1 and len(near[0]["object_ids"]) == 2
        other_obj = chain.lib.db.find_one("file_path", name="other")["object_id"]
        assert other_obj not in near[0]["object_ids"]
        # the byte-for-byte copy shares the original's object: 3 files
        assert sorted(f["name"] for f in near[0]["files"]) == ["copy", "original", "same"]
        # a second run finds nothing to hash
        assert (await chain.detect())["hashed"] == 0
    finally:
        await chain.close()


async def test_duplicate_chain_matches_jax(tmp_path):
    """Both packages: scan, DuplicateDetectorJob, find_duplicates; then
    the pHash column cleared and the job run again, which reuses every
    hash from the journal."""
    corpus = tmp_path / "corpus"
    _pics(corpus)
    jax, port = _Chain(JAX, str(tmp_path / "jax")), _Chain(PORT, str(tmp_path / "port"))
    try:
        for chain in (jax, port):
            await chain.scan(corpus)
        jmeta, pmeta = await jax.detect(), await port.detect()
        assert pmeta == jmeta and pmeta["hashed"] == 4
        ps, js = port.snapshot(), jax.snapshot()
        assert ps == js
        assert len(ps[0]) == 4 and sum(1 for g in ps[2] if g[0] == "near") == 1
        assert sum(unpackb(p).get("phash") is not None for p, _ in ps[1].values()) == 4
        for chain in (jax, port):
            chain.lib.db.execute("UPDATE object SET phash = NULL")
        jmeta, pmeta = await jax.detect(), await port.detect()
        assert pmeta == jmeta and pmeta["hashed"] == 0
        assert port.snapshot() == jax.snapshot() == ps
        # the byte-for-byte copy moved onto an object of its own (two
        # devices minting objects for one cas_id before sync merges
        # them): one exact group in both
        for chain in (jax, port):
            fp = chain.lib.db.find_one("file_path", name="same")
            kind = chain.lib.db.find_one("object", id=fp["object_id"])["kind"]
            new = chain.lib.db.insert("object", pub_id=b"split-object-000", kind=kind)
            chain.lib.db.update("file_path", {"id": fp["id"]}, object_id=new)
        ps = port.snapshot()
        assert ps == jax.snapshot()
        exact = [g for g in ps[2] if g[0] == "exact"]
        assert len(exact) == 1 and exact[0][1] == [fp["cas_id"]] * 2
        assert sorted(f["name"] for f in exact[0][2]) == ["original", "same"]
    finally:
        await jax.close()
        await port.close()


def test_cli_duplicates_matches_sdx(tmp_path, capsys):
    """`python -m spacedrive_tpu_torch duplicates` on a library the port
    indexed against `sdx duplicates` on one the JAX package indexed, from
    the same tree: the same groups with the same files."""
    from spacedrive_tpu import cli as jcli

    corpus = tmp_path / "corpus"
    _pics(corpus)
    pdata, jdata = str(tmp_path / "port"), str(tmp_path / "jax")
    assert cli.main(["index", str(corpus), "--data-dir", pdata, "--library", "L",
                     "--device", "cpu"]) == 0
    assert jcli.main(["--data-dir", jdata, "index", str(corpus), "--library", "L",
                      "--backend", "cpu", "--no-p2p"]) == 0
    capsys.readouterr()
    assert cli.main(["duplicates", "--data-dir", pdata, "--library", "L", "--threshold", "10",
                     "--device", "cpu"]) == 0
    port = json.loads(capsys.readouterr().out)
    assert jcli.main(["--data-dir", jdata, "duplicates", "--library", "L",
                      "--threshold", "10"]) == 0
    jax = json.loads(capsys.readouterr().out)
    strip = [(g["kind"], g["files"]) for g in port]
    assert strip == [(g["kind"], g["files"]) for g in jax]
    assert [g["kind"] for g in port] == ["near"] and len(port[0]["files"]) == 3
