"""The port's media half of the scan chain against the JAX package's.

Both packages run `scan_location(backend="cpu")` (IndexerJob →
FileIdentifierJob → MediaProcessorJob) over the same seeded tree: images
of several aspects (one beyond 4:1, which takes the host resize) and
EXIF orientations, EXIF camera, date and GPS tags, a duplicate image,
undecodable files with image extensions and non-images. Each package
gets a node stub holding its own Thumbnailer, as tests/test_e2e_index.py
does. Required, cold and after each rescan:

- the same thumbnail store paths (below each library's namespace) and
  webp dimensions; pixels before encode within 1 uint8 level of the JAX
  resize (`process.resize_decoded`);
- media_data rows equal column for column, packed bytes included;
- object_embedding `dim` and `model` equal, vectors allclose 1e-5
  (float32 matmuls in another order), matched by cas_id;
- crdt_operation counts per (model, kind) equal;
- index_journal rows equal byte for byte (payload, identity, cas_id);
- the media job's run metadata equal;
- the search sidecar's vectors equal per object (allclose 1e-5).

Object pub_ids are random in both packages, so rows join through
cas_id. The tree holds still images only; tests/test_torch_media_kinds.py
holds the chain to the JAX package's on a tree of every kind (video,
PDF, SVG, AVIF).
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
import spacedrive_tpu.object.media.thumbnail as jthumb
import spacedrive_tpu.object.media.thumbnail.process as jprocess
import spacedrive_tpu.tasks as jtasks
import spacedrive_tpu_torch.jobs as pjobs
import spacedrive_tpu_torch.location.locations as plocations
import spacedrive_tpu_torch.node.library as plibrary
import spacedrive_tpu_torch.object.media.thumbnail.actor as pactor
import spacedrive_tpu_torch.object.media.thumbnail.process as pprocess
import spacedrive_tpu_torch.tasks as ptasks
from spacedrive_tpu_torch.utils.msgpack_codec import unpackb
import spacedrive_tpu.telemetry as jtelemetry
import spacedrive_tpu_torch.telemetry as ptelemetry


@pytest.fixture(autouse=True)
def _reset_telemetry():
    """This file's JAX and port scans leave no spans, series or ring
    events to later tests of the worker: both packages' telemetry is
    reset after each test."""
    yield
    jtelemetry.reset()
    ptelemetry.reset()


JAX = types.SimpleNamespace(
    JobManager=jjobs.JobManager, TaskSystem=jtasks.TaskSystem, Libraries=jlibrary.Libraries,
    LocationCreateArgs=jlocations.LocationCreateArgs, scan_location=jlocations.scan_location,
    thumbnailer=lambda d: jthumb.Thumbnailer(d),
)
PORT = types.SimpleNamespace(
    JobManager=pjobs.JobManager, TaskSystem=ptasks.TaskSystem, Libraries=plibrary.Libraries,
    LocationCreateArgs=plocations.LocationCreateArgs, scan_location=plocations.scan_location,
    thumbnailer=lambda d: pactor.Thumbnailer(d, device="cpu"),
)

# (name, w, h, format, EXIF orientation)
IMAGES = [
    ("sq.png", 300, 300, "png", 1),
    ("wide.jpg", 1600, 1200, "jpg", 1),
    ("rot6.jpg", 1200, 900, "jpg", 6),
    ("rot8.jpg", 900, 1200, "jpg", 8),
    ("rot3.jpg", 640, 480, "jpg", 3),
    ("tall.png", 400, 1000, "png", 1),
    ("pano.png", 2200, 400, "png", 1),  # beyond 4:1: the host resize
    ("tiny.png", 16, 12, "png", 1),
    ("sub/deep/big.png", 2400, 1350, "png", 1),
]


def _image(path, w, h, seed, fmt, orientation, exif_tags=False):
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)
    base = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.int16)
    base = base + rng.integers(-12, 13, (h, w, 3))
    img = Image.fromarray(np.clip(base, 0, 255).astype(np.uint8))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if fmt == "jpg":
        exif = Image.Exif()
        exif[0x0112] = orientation
        if exif_tags:
            exif[0x010F] = "Seeded"  # Make
            exif[0x0110] = "Camera 1"  # Model
            exif[0x013B] = "artist"
            exif.get_ifd(0x8769)[0x9003] = "2021:06:01 12:30:00"  # DateTimeOriginal
            exif.get_ifd(0x8825).update({1: "N", 2: (52.0, 31.0, 12.5), 3: "W",
                                         4: (1.0, 2.0, 30.0)})
        img.save(path, "JPEG", quality=90, exif=exif.tobytes())
    else:
        img.save(path, "PNG")


def make_tree(root):
    for i, (name, w, h, fmt, orientation) in enumerate(IMAGES):
        _image(os.path.join(root, name), w, h, 100 + i, fmt, orientation, exif_tags=(i == 1))
    with open(os.path.join(root, "sq.png"), "rb") as f:
        data = f.read()
    with open(os.path.join(root, "sub", "copy_of_sq.png"), "wb") as f:
        f.write(data)
    rng = np.random.default_rng(3)
    for name, payload in (("broken.png", rng.bytes(3000)), ("notes.txt", b"hello media"),
                          ("sub/blob.bin", rng.bytes(150_000)), ("fake.jpg", b"not a jpeg")):
        with open(os.path.join(root, name), "wb") as f:
            f.write(payload)


N_BROKEN = 2  # broken.png, fake.jpg: re-dispatched by every pass of both packages


async def _scan(pkg, lib, mgr, node, loc_path):
    loc = lib.db.find_one("location", path=str(loc_path))
    if loc is None:
        loc = pkg.LocationCreateArgs(path=str(loc_path)).create(lib)
    before = lib.db.count("job")
    job_id = await pkg.scan_location(lib, loc, mgr, backend="cpu")
    await mgr.wait(job_id)
    for _ in range(200):
        await mgr.wait_idle()
        rows = lib.db.query("SELECT status FROM job")
        if len(rows) >= before + 3 and all(r["status"] in (2, 6) for r in rows):
            break
        await asyncio.sleep(0.02)
    await node.thumbnailer.wait_library_batch(str(lib.id))
    jobs = lib.db.query("SELECT name, status, metadata, task_count FROM job "
                        "ORDER BY date_created DESC, rowid DESC LIMIT 3")[::-1]
    assert [j["name"] for j in jobs] == ["indexer", "file_identifier", "media_processor"]
    assert all(j["status"] == 2 for j in jobs), jobs
    return unpackb(jobs[2]["metadata"]), jobs[2]["task_count"]


def _webps(node, lib):
    """{shard/cas.webp: (w, h)} below the library's namespace."""
    base = os.path.join(node.thumbnailer.store.root, str(lib.id))
    out = {}
    for dirpath, _, files in os.walk(base):
        for f in files:
            with Image.open(os.path.join(dirpath, f)) as im:
                out[os.path.relpath(os.path.join(dirpath, f), base)] = im.size
    return out


def snapshot(node, lib):
    db = lib.db
    cas_of_object = {r["object_id"]: r["cas_id"] for r in db.query(
        "SELECT object_id, cas_id FROM file_path WHERE object_id IS NOT NULL")}
    # rows of objects a rescan orphaned (no file_path left) stay in
    # both packages: they are counted, the live ones compared
    media = {"rows": db.count("media_data")}
    for r in db.query("SELECT * FROM media_data"):
        if r["object_id"] in cas_of_object:
            media[cas_of_object[r["object_id"]]] = {
                k: bytes(v) if isinstance(v, (bytes, memoryview)) else v
                for k, v in r.items() if k not in ("id", "object_id")}
    embeddings = {cas_of_object.get(r["object_id"], ("orphan", r["object_id"])):
                  (r["dim"], r["model"], np.frombuffer(r["vector"], "<f4"))
                  for r in db.query("SELECT * FROM object_embedding")}
    journal = {(r["materialized_path"], r["name"], r["extension"]):
               (bytes(r["payload"]), r["cas_id"], r["stale"], r["inode"], r["mtime_ns"], r["size"])
               for r in db.query("SELECT * FROM index_journal")}
    ops = {(r["model"], r["kind"]): r["n"] for r in db.query(
        "SELECT model, kind, COUNT(*) AS n FROM crdt_operation GROUP BY model, kind")}
    sidecar = {}
    d = db.path + ".searchidx"
    if os.path.exists(os.path.join(d, "meta.json")):
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        vecs = np.fromfile(os.path.join(d, "vectors.f32"), "<f4").reshape(len(meta["ids"]), -1)
        sidecar = {cas_of_object.get(oid, ("orphan", oid)): v for oid, v in zip(meta["ids"], vecs)}
    return {"webps": _webps(node, lib), "media": media, "embeddings": embeddings,
            "journal": journal, "ops": ops, "sidecar": sidecar}


def assert_same(port, jax):
    assert port["webps"] == jax["webps"]
    assert port["media"] == jax["media"]
    assert port["journal"] == jax["journal"]
    assert port["ops"] == jax["ops"]
    for key in ("embeddings", "sidecar"):
        assert set(port[key]) == set(jax[key]), key
    for cas_id, (dim, model, vec) in port["embeddings"].items():
        jdim, jmodel, jvec = jax["embeddings"][cas_id]
        assert (dim, model) == (jdim, jmodel)
        np.testing.assert_allclose(vec, jvec, atol=1e-5, rtol=1e-5)
    for cas_id, vec in port["sidecar"].items():
        np.testing.assert_allclose(vec, jax["sidecar"][cas_id], atol=1e-5, rtol=1e-5)


class _Node:  # the test_e2e_index stub: a thumbnailer and no labeler
    def __init__(self, thumbnailer):
        self.thumbnailer = thumbnailer
        self.image_labeler = None


class _Chain:
    """One package's library, job manager and node stub."""

    def __init__(self, pkg, data_dir):
        self.pkg = pkg
        self.node = _Node(pkg.thumbnailer(os.path.join(data_dir, "thumbnails")))
        self.lib = pkg.Libraries(data_dir, node=self.node).create("media")
        self.mgr = pkg.JobManager(pkg.TaskSystem(2))

    async def scan(self, loc):
        return await _scan(self.pkg, self.lib, self.mgr, self.node, loc)

    def snapshot(self):
        return snapshot(self.node, self.lib)

    async def close(self):
        await self.node.thumbnailer.shutdown()
        await self.mgr.system.shutdown()
        self.lib.close()


async def _both(tmp_path):
    loc = tmp_path / "loc"
    make_tree(str(loc))
    return loc, _Chain(JAX, str(tmp_path / "jax")), _Chain(PORT, str(tmp_path / "port"))


async def test_cold_media_pass_matches_jax(tmp_path):
    loc, jax, port = await _both(tmp_path)
    try:
        jmeta, jtasks_n = await jax.scan(loc)
        pmeta, ptasks_n = await port.scan(loc)
        assert pmeta == jmeta and ptasks_n == jtasks_n
        ps, js = port.snapshot(), jax.snapshot()
        assert_same(ps, js)
        # not vacuous: every decodable image (the duplicate shares its
        # object) has a thumbnail, media_data, an embedding and a vector
        n_objects = len(IMAGES)
        assert len(ps["webps"]) == ps["media"]["rows"] == len(ps["embeddings"]) == n_objects
        assert len(ps["sidecar"]) == n_objects
        assert pmeta["thumbnails_dispatched"] == n_objects + 1 + N_BROKEN  # + the duplicate
        assert pmeta["embeddings_written"] == n_objects + 1
        assert ps["ops"][("object_embedding", "c")] == n_objects + 1
        assert port.node.thumbnailer.errors == N_BROKEN
        gps = [unpackb(m["media_location"]) for k, m in ps["media"].items()
               if k != "rows" and m["media_location"]]
        assert len(gps) == 1 and gps[0]["latitude"] > 52 and gps[0]["longitude"] < 0
        vouched = [unpackb(p) for p, *_ in ps["journal"].values()]
        assert sum(bool(v.get("thumb") and v.get("embed") and v.get("media")) for v in vouched) \
            == n_objects + 1
    finally:
        await jax.close()
        await port.close()


def test_resize_pixels_match_jax_before_encode(tmp_path):
    """Every device-path image of the tree, decoded by each package and
    resized through `process.resize_decoded`: decodes equal, dims exact,
    pixels within 1 uint8 level of the JAX resize."""
    loc = tmp_path / "loc"
    make_tree(str(loc))
    paths = [(os.path.join(loc, n), n.rsplit(".", 1)[1]) for n, *_ in IMAGES]
    pdec = [pprocess.decode(p, e) for p, e in paths]
    jdec = [jprocess.decode(p, e) for p, e in paths]
    for p, j in zip(pdec, jdec):
        assert np.array_equal(p.array, j.array) and p.target == j.target
        assert p.orientation == j.orientation
    on_device = [i for i, d in enumerate(pdec) if not pprocess.needs_cpu_fallback(d)]
    assert len(on_device) == len(IMAGES) - 1  # the panorama takes the host path
    got = pprocess.resize_decoded([pdec[i] for i in on_device], "cpu")
    want = jprocess.resize_decoded([jdec[i] for i in on_device])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert int(np.abs(g.astype(np.int16) - np.asarray(w).astype(np.int16)).max()) <= 1


async def test_rescans_match_jax(tmp_path):
    """Warm: nothing is thumbnailed, extracted or embedded (the two
    undecodable files are re-dispatched and fail again in both). Then
    one image added and one rewritten in place: exactly those two."""
    loc, jax, port = await _both(tmp_path)
    try:
        for chain in (jax, port):
            await chain.scan(loc)
        generated = port.node.thumbnailer.generated
        jmeta, _ = await jax.scan(loc)
        pmeta, _ = await port.scan(loc)
        assert pmeta == jmeta == {"media_data_extracted": 0, "media_data_skipped": 0,
                                  "thumbnails_dispatched": N_BROKEN, "embeddings_written": 0}
        assert port.node.thumbnailer.generated == generated
        assert_same(port.snapshot(), jax.snapshot())

        _image(str(loc / "added.jpg"), 800, 600, 7, "jpg", 6)
        _image(str(loc / "rot3.jpg"), 640, 480, 8, "jpg", 3)  # new content, same name
        jmeta, _ = await jax.scan(loc)
        pmeta, _ = await port.scan(loc)
        assert pmeta == jmeta == {"media_data_extracted": 2, "media_data_skipped": 0,
                                  "thumbnails_dispatched": 2 + N_BROKEN, "embeddings_written": 2}
        assert port.node.thumbnailer.generated == generated + 2
        assert_same(port.snapshot(), jax.snapshot())
    finally:
        await jax.close()
        await port.close()


async def test_sd_embed_0_is_a_no_op_in_both(tmp_path, monkeypatch):
    monkeypatch.setenv("SD_EMBED", "0")
    loc, jax, port = await _both(tmp_path)
    try:
        jmeta, jtasks_n = await jax.scan(loc)
        pmeta, ptasks_n = await port.scan(loc)
        assert pmeta == jmeta and pmeta["embeddings_written"] == 0
        # steps: the extract chunks and the thumbnail rendezvous, no embed step
        n_exif = len(IMAGES) + 1 + N_BROKEN
        assert ptasks_n == jtasks_n == -(-n_exif // 10) + 1
        ps, js = port.snapshot(), jax.snapshot()
        assert_same(ps, js)
        assert ps["embeddings"] == {} and ps["sidecar"] == {}
        assert not any(model == "object_embedding" for model, _ in ps["ops"])
        assert not any(unpackb(p).get("embed") for p, *_ in ps["journal"].values())
    finally:
        await jax.close()
        await port.close()


def test_media_data_rows_match_jax(tmp_path):
    """`ImageMetadata.from_path(...).to_row` equal for every file of the
    tree, undecodable ones included (both None), and plus codes equal."""
    from spacedrive_tpu.object.media import media_data as jmedia
    from spacedrive_tpu_torch.object.media import media_data as pmedia

    loc = tmp_path / "loc"
    make_tree(str(loc))
    for dirpath, _, files in os.walk(loc):
        for f in files:
            path = os.path.join(dirpath, f)
            p, j = pmedia.ImageMetadata.from_path(path), jmedia.ImageMetadata.from_path(path)
            assert (p is None) == (j is None), f
            if p is not None:
                assert p.to_row(7) == j.to_row(7), f
    for lat, lon in ((52.52, 13.405), (-33.8688, 151.2093), (90.0, 180.0), (-90.0, -180.0)):
        assert pmedia.encode_plus_code(lat, lon) == jmedia.encode_plus_code(lat, lon)


@pytest.mark.parametrize("bad", [b"", b"\x00" * 64, b"short", None])
def test_index_skips_invalid_vectors_like_jax(tmp_path, bad):
    """A poisoned object_embedding row is skipped alone by both indexes,
    and the sidecars hold the same vectors."""
    from spacedrive_tpu.object.search import index as jindex
    from spacedrive_tpu_torch.object.search import index as pindex

    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((5, 128)).astype(np.float32)
    out = {}
    for name, pkg, index in (("jax", JAX, jindex), ("port", PORT, pindex)):
        lib = pkg.Libraries(tmp_path / name).create("idx")
        try:
            for i, v in enumerate(vecs):
                oid = lib.db.insert("object", pub_id=os.urandom(16))
                lib.db.insert("object_embedding", object_id=oid, dim=128, model="m",
                              vector=bad if i == 2 else v.astype("<f4").tobytes(),
                              date_calculated=f"2024-01-0{i + 1}")
            assert index.refresh(lib) == 4
            assert len(index.get_index(lib)) == 4
            # the sync-apply hook folds a row that sync wrote
            oid = lib.db.insert("object", pub_id=os.urandom(16))
            lib.db.insert("object_embedding", object_id=oid, dim=128, model="m",
                          vector=vecs[0].astype("<f4").tobytes(), date_calculated="2024-02-01")
            index.on_embeddings_applied(lib)
            assert len(index.get_index(lib)) == 5
            with open(lib.db.path + ".searchidx/meta.json") as f:
                meta = json.load(f)
            out[name] = (meta["ids"], meta["watermark"], meta["stamp"],
                         np.fromfile(lib.db.path + ".searchidx/vectors.f32", "<f4"))
        finally:
            lib.close()
    assert out["port"][:3] == out["jax"][:3]
    np.testing.assert_array_equal(out["port"][3], out["jax"][3])
