"""The port's thumbnailer actor, state file, embedding stage and journal
vouches: the JAX package's tests/test_thumbnailer.py,
tests/test_semantic_search.py and tests/test_index_journal.py media
tests, pointed at the port.

Where the JAX tests read telemetry counters (`sd_embed_files_total`,
`sd_index_journal_ops_total`) these read the media job's run metadata
and the walk's `journal_*` verdict counts; where they query the search
index these hold its vectors and length. The JAX thumbnail-persist fault
point is played by a patched `_account` that dies between a chunk's
store and its accounting, as a killed process would. A device resize
that fails is not redone on the host: its batch's waiters raise and the
media job fails.
"""

import asyncio
import os

import numpy as np
import pytest
from PIL import Image

from spacedrive_tpu.location.indexer import journal as jjournal
from spacedrive_tpu.db.database import LibraryDb as JaxDb
from spacedrive_tpu.models import embedder as jembedder
from spacedrive_tpu.object.media.thumbnail import state as jstate
from spacedrive_tpu_torch.db.database import LibraryDb
from spacedrive_tpu_torch.jobs import JobManager
from spacedrive_tpu_torch.location.indexer.journal import (
    HIT, INVALIDATED, Identity, IndexJournal, key_of,
)
from spacedrive_tpu_torch.location.locations import LocationCreateArgs, scan_location
from spacedrive_tpu_torch.models import embedder
from spacedrive_tpu_torch.node.library import Libraries
from spacedrive_tpu_torch.object.media import job as media_job
from spacedrive_tpu_torch.object.media.thumbnail import actor as actor_mod
from spacedrive_tpu_torch.object.media.thumbnail import process
from spacedrive_tpu_torch.object.media.thumbnail.actor import Thumbnailer, ThumbnailerError
from spacedrive_tpu_torch.object.media.thumbnail.state import Batch, load_state, save_state
from spacedrive_tpu_torch.object.search import index as search_index
from spacedrive_tpu_torch.ops import thumbnail_torch as tt
from spacedrive_tpu_torch.tasks import TaskSystem
from spacedrive_tpu_torch.utils.events import EventBus
from spacedrive_tpu_torch.utils.msgpack_codec import unpackb


def _cpu_thumbnailer(data_dir, **kwargs):
    return Thumbnailer(data_dir, device="cpu", **kwargs)


# ---- state file -----------------------------------------------------------


def test_state_roundtrip_and_delete_on_load(tmp_path):
    batches = [
        Batch("lib1", [("c1", "/a.png", "png")], background=False),
        Batch(None, [("c2", "/b.jpg", "jpg"), ("c3", "/c.gif", "gif")], background=True),
    ]
    save_state(tmp_path, batches)
    with open(tmp_path / "thumbs_to_process.bin", "rb") as f:
        port_bytes = f.read()
    # byte-equal to the JAX actor's file for the same batches
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jstate.save_state(jdir, [jstate.Batch(b.library_id, list(b.entries), b.background)
                             for b in batches])
    with open(jdir / "thumbs_to_process.bin", "rb") as f:
        assert f.read() == port_bytes
    loaded = load_state(tmp_path)
    assert [b.to_wire() for b in loaded] == [b.to_wire() for b in batches]
    assert load_state(tmp_path) == []  # file deleted after load
    # a torn file is discarded, not fatal
    (tmp_path / "thumbs_to_process.bin").write_bytes(b"\x93\xa1")
    assert load_state(tmp_path) == []
    assert not (tmp_path / "thumbs_to_process.bin").exists()


# ---- actor ------------------------------------------------------------------


def _make_images(d, n=6):
    entries = []
    rng = np.random.default_rng(1)
    sizes = [(640, 480), (1200, 800), (64, 64), (900, 300), (333, 777), (2000, 100)]
    for i in range(n):
        w, h = sizes[i % len(sizes)]
        path = str(d / f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(path)
        entries.append((f"{i:03x}cas{i:09x}", path, "png"))
    return entries


async def test_actor_generates_sharded_webp_thumbs(tmp_path):
    bus = EventBus()
    events = bus.subscribe()
    th = _cpu_thumbnailer(tmp_path / "data", event_bus=bus)
    th.chunk_rows = 4  # two chunks: the pipeline overlaps them
    entries = _make_images(tmp_path)
    batch_id = th.new_indexed_thumbnails_batch("libA", entries)
    assert batch_id > 0
    await th.wait_batch(batch_id)
    assert th.generated == len(entries) and th.errors == 0
    for cas, path, _ in entries:
        p = th.store.path_for("libA", cas)
        assert p.endswith(os.path.join("libA", cas[:3], f"{cas}.webp"))
        with Image.open(path) as src:
            want = tt.scale_dimensions(*src.size)
        with Image.open(p) as im:
            assert im.format == "WEBP" and im.size == want
    assert len([e for e in events.poll() if e["type"] == "NewThumbnail"]) == len(entries)
    assert all(th.stage_seconds[s] > 0 for s in ("decode", "device", "encode"))
    # re-dispatch: everything already exists → skipped
    assert th.new_indexed_thumbnails_batch("libA", entries) == 0
    assert th.skipped == len(entries)
    await th.shutdown()
    assert load_state(tmp_path / "data") == []


async def test_actor_bad_files_counted_not_fatal(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image at all")
    good = _make_images(tmp_path, n=1)
    th = _cpu_thumbnailer(tmp_path / "data")
    bid = th.new_indexed_thumbnails_batch("libB", [("aaaa000000000001", str(bad), "png")] + good)
    await th.wait_batch(bid)  # does not raise: a decode failure is not a device failure
    await th.wait_library_batch("libB")
    assert th.errors == 1 and th.generated == 1
    await th.shutdown()


async def test_actor_crash_resume_from_state_file(tmp_path):
    data = tmp_path / "data"
    entries = _make_images(tmp_path, n=3)
    # a crashed actor: a pending batch persisted, never processed
    os.makedirs(data, exist_ok=True)
    save_state(data, [Batch("libC", entries, background=False)])
    th = _cpu_thumbnailer(data)
    assert th.pending_count("libC") == 3
    await th.wait_library_batch("libC")
    assert th.generated == 3
    await th.shutdown()


async def test_foreground_priority_over_background(tmp_path):
    th = _cpu_thumbnailer(tmp_path / "data")
    entries = _make_images(tmp_path, n=4)
    order = []
    real = th._process_batch

    async def recording(batch):
        order.append(batch.library_id)
        await real(batch)

    th._process_batch = recording
    # queued before the worker starts: bg first, then two fg batches;
    # the fg stack runs first and newest first
    th.new_indexed_thumbnails_batch("bg", entries[:2], background=True)
    th.new_indexed_thumbnails_batch("fg1", entries[2:3])
    th.new_indexed_thumbnails_batch("fg2", entries[3:])
    await th.wait_library_batch("bg")
    assert order == ["fg2", "fg1", "bg"]
    assert th.generated == 4
    await th.shutdown()


async def test_device_failure_fails_the_batch_without_host_fallback(tmp_path, monkeypatch):
    def broken(batch, device):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(actor_mod, "resize_decoded", broken)
    th = _cpu_thumbnailer(tmp_path / "data")
    entries = _make_images(tmp_path, n=3)
    # two failing batches: each waiter kind sees the one it waits on
    bid = th.new_indexed_thumbnails_batch("libD", entries[:2])
    th.new_indexed_thumbnails_batch("libD", entries[2:])
    with pytest.raises(ThumbnailerError, match="illegal memory access"):
        await th.wait_batch(bid)
    with pytest.raises(ThumbnailerError):
        await th.wait_library_batch("libD")
    # nothing was resized on the host instead
    assert th.generated == 0 and th.errors == 3
    assert not any(th.store.exists("libD", c) for c, _, _ in entries)
    await th.shutdown()


async def test_failure_is_reported_once_and_later_batches_succeed(tmp_path, monkeypatch):
    """A failed batch raises in the first waiter that sees it; a good
    batch after it on the same actor, and the namespace's next drain,
    do not raise."""
    def broken(batch, device):
        raise RuntimeError("device lost")

    th = _cpu_thumbnailer(tmp_path / "data")
    entries = _make_images(tmp_path, n=4)
    monkeypatch.setattr(actor_mod, "resize_decoded", broken)
    bad = th.new_indexed_thumbnails_batch("libF", entries[:2])
    with pytest.raises(ThumbnailerError, match="device lost"):
        await th.wait_batch(bad)
    await th.wait_batch(bad)  # reported already
    monkeypatch.undo()
    good = th.new_indexed_thumbnails_batch("libF", entries[2:])
    await th.wait_batch(good)
    await th.wait_library_batch("libF")
    assert th.generated == 2 and th.errors == 2
    # a failure no batch waiter took is reported by the next drain, once
    monkeypatch.setattr(actor_mod, "resize_decoded", broken)
    th.new_indexed_thumbnails_batch("libF", entries[:2])
    with pytest.raises(ThumbnailerError, match="device lost"):
        await th.wait_library_batch("libF")
    await th.wait_library_batch("libF")
    await th.shutdown()


# ---- the media job on the scan chain -----------------------------------------


class _Node:
    def __init__(self, thumbnailer):
        self.thumbnailer = thumbnailer
        self.image_labeler = None


def _gradient_image(rng, size=48):
    yy, xx = np.mgrid[0:size, 0:size] / float(size)
    a, b, c = rng.uniform(-3, 3, 3)
    img = np.stack([np.sin(a * xx + b * yy + c + k) * 0.5 + 0.5 for k in range(3)], axis=-1)
    return (img * 255).astype(np.uint8)


def _image_corpus(root, n=12, seed=0, dup_of=3):
    """n structured PNGs + a q40 JPEG re-encode of img<dup_of>."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(_gradient_image(rng)).save(os.path.join(root, f"img{i:02d}.png"))
    Image.open(os.path.join(root, f"img{dup_of:02d}.png")).save(os.path.join(root, "dup.jpg"),
                                                                 quality=40)


async def _pipeline(tmp_path):
    node = _Node(_cpu_thumbnailer(tmp_path / "data" / "thumbnails"))
    library = Libraries(tmp_path / "data", node=node).create("media")
    return node, library, JobManager(TaskSystem(2))


async def _scan_chain(library, mgr, loc_path):
    """One chain; returns the (indexer, identifier, media) run metadata
    and the media job's row."""
    loc = library.db.find_one("location", path=str(loc_path))
    if loc is None:
        loc = LocationCreateArgs(path=str(loc_path)).create(library)
    job_id = await scan_location(library, loc, mgr, backend="cpu")
    await mgr.wait(job_id)
    for _ in range(200):
        await mgr.wait_idle()
        rows = library.db.query("SELECT name, status, metadata, errors_text FROM job "
                                "ORDER BY date_created DESC, rowid DESC LIMIT 3")[::-1]
        if [r["name"] for r in rows] == ["indexer", "file_identifier", "media_processor"] and \
                rows[2]["status"] not in (0, 1):
            break
        await asyncio.sleep(0.02)
    thumbnailer = getattr(library.node, "thumbnailer", None)
    if thumbnailer is not None and rows[2]["status"] == 2:
        await thumbnailer.wait_library_batch(library.id)
    return [unpackb(r["metadata"]) if r["metadata"] else {} for r in rows], rows[2]


def _embedding_count(library):
    return library.db.count("object_embedding")


async def test_device_failure_fails_the_media_job(tmp_path, monkeypatch):
    monkeypatch.setattr(actor_mod, "resize_decoded",
                        lambda batch, device: (_ for _ in ()).throw(RuntimeError("device lost")))
    corpus = tmp_path / "corpus"
    _image_corpus(str(corpus), n=4)
    node, library, mgr = await _pipeline(tmp_path)
    try:
        _, media = await _scan_chain(library, mgr, corpus)
        assert media["status"] == 4  # FAILED
        assert "device lost" in media["errors_text"]
        assert node.thumbnailer.generated == 0
        journal = IndexJournal(library.db)
        for r in library.db.query("SELECT * FROM file_path WHERE is_dir = 0"):
            _, entry = journal.lookup(library.db.find_one("location")["id"], key_of(r), None)
            assert entry is not None and not entry.thumb
    finally:
        await node.thumbnailer.shutdown()
        await mgr.system.shutdown()
        library.close()


async def test_pipeline_embeds_indexes_and_warm_skips(tmp_path):
    corpus = tmp_path / "corpus"
    _image_corpus(str(corpus), n=12)
    node, library, mgr = await _pipeline(tmp_path)
    try:
        (_, _, media), _ = await _scan_chain(library, mgr, corpus)
        # one vector per image (12 + the planted dup); shared_create =
        # 1 create + 4 field updates per row
        assert _embedding_count(library) == 13 and media["embeddings_written"] == 13
        n_ops = library.db.query_one("SELECT COUNT(*) AS n FROM crdt_operation "
                                     "WHERE model = 'object_embedding'")["n"]
        assert n_ops == 13 * 5
        # the index holds every vector, normalized, by object id
        idx = search_index.get_index(library)
        ids, vecs = idx.vectors()
        assert len(idx) == 13 and sorted(ids) == sorted(
            r["object_id"] for r in library.db.query("SELECT object_id FROM object_embedding"))
        np.testing.assert_allclose(np.linalg.norm(vecs, axis=1), 1.0, rtol=1e-5)
        for oid, vec in zip(ids, vecs):
            row = library.db.find_one("object_embedding", object_id=oid)
            raw = embedder.blob_to_vector(row["vector"])
            np.testing.assert_allclose(vec, raw / np.linalg.norm(raw), rtol=1e-5, atol=1e-6)
        # the planted re-encode is the nearest neighbour of its source
        src = library.db.find_one("file_path", name="img03")["object_id"]
        dup = library.db.find_one("file_path", name="dup")["object_id"]
        scores = vecs @ vecs[ids.index(src)]
        ranked = [ids[i] for i in np.argsort(-scores, kind="stable")]
        assert ranked[:2] == [src, dup]

        # warm pass: every unchanged byte journal-vouched, ZERO embeds
        (_, _, media), _ = await _scan_chain(library, mgr, corpus)
        assert media["embeddings_written"] == 0 and media["media_data_extracted"] == 0
        assert media["thumbnails_dispatched"] == 0
        assert _embedding_count(library) == 13 and len(idx) == 13
    finally:
        await node.thumbnailer.shutdown()
        await mgr.system.shutdown()
        library.close()


async def test_warm_pass_one_percent_mutation(tmp_path):
    """Mutate 1% of a 100-image corpus: the warm pass embeds ONLY the
    dirty file and the walk counts exactly one invalidation."""
    corpus = tmp_path / "corpus"
    _image_corpus(str(corpus), n=99)  # 99 + dup.jpg = 100 image files
    node, library, mgr = await _pipeline(tmp_path)
    try:
        await _scan_chain(library, mgr, corpus)
        assert _embedding_count(library) == 100
        target = corpus / "img50.png"
        Image.fromarray(_gradient_image(np.random.default_rng(999))).save(target)
        os.utime(target)
        (indexer, _, media), _ = await _scan_chain(library, mgr, corpus)
        assert media["embeddings_written"] == 1 and media["thumbnails_dispatched"] == 1
        assert indexer.get("journal_invalidated") == 1 and indexer.get("journal_hit") == 99
        live = library.db.query_one(
            "SELECT COUNT(*) AS n FROM object_embedding oe WHERE EXISTS "
            "(SELECT 1 FROM file_path fp WHERE fp.object_id = oe.object_id)")["n"]
        assert live == 100
        assert len(search_index.get_index(library)) == 101  # the orphaned row stays indexed
    finally:
        await node.thumbnailer.shutdown()
        await mgr.system.shutdown()
        library.close()


async def test_sd_embed_0_true_noop(tmp_path, monkeypatch):
    """SD_EMBED=0: no embedding rows, no sync ops, no index; the rest of
    the pipeline's output equals an enabled run over the same corpus."""
    corpus = tmp_path / "corpus"
    _image_corpus(str(corpus), n=6)

    async def run(sub, enabled):
        if enabled:
            monkeypatch.delenv("SD_EMBED", raising=False)
        else:
            monkeypatch.setenv("SD_EMBED", "0")
        node, library, mgr = await _pipeline(tmp_path / sub)
        try:
            await _scan_chain(library, mgr, corpus)
            files = {
                (r["materialized_path"], r["name"], r["extension"], r["cas_id"]):
                    library.db.count("media_data", "object_id = ?", (r["object_id"],))
                for r in library.db.query("SELECT * FROM file_path WHERE is_dir = 0")
            }
            ops = library.db.count("crdt_operation", "model = 'object_embedding'")
            return files, _embedding_count(library), ops, len(search_index.get_index(library))
        finally:
            await node.thumbnailer.shutdown()
            await mgr.system.shutdown()
            library.close()

    files_off, n_off, ops_off, idx_off = await run("off", enabled=False)
    assert (n_off, ops_off, idx_off) == (0, 0, 0)
    assert not any(f.endswith(".searchidx") for f in os.listdir(tmp_path / "off" / "data" / "libraries"))
    files_on, n_on, _, idx_on = await run("on", enabled=True)
    assert n_on == idx_on == 7
    assert files_off == files_on


def test_embed_blob_roundtrip_and_strict_decode():
    vec = np.arange(128, dtype=np.float32) / 128.0
    blob = embedder.vector_to_blob(vec)
    assert blob == jembedder.vector_to_blob(vec)
    assert np.array_equal(embedder.blob_to_vector(blob), vec)
    for bad in (b"short", b"\x00" * 64, np.full(128, np.nan, "<f4").tobytes(),
                np.full(128, np.inf, "<f4").tobytes(), None, "x" * 512):
        assert embedder.blob_to_vector(bad) is None
        assert jembedder.blob_to_vector(bad) is None


@pytest.mark.parametrize("value,want", [(None, True), ("1", True), ("0", False)])
def test_embed_switch(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("SD_EMBED", raising=False)
    else:
        monkeypatch.setenv("SD_EMBED", value)
    assert embedder.enabled() is want is jembedder.enabled()


# ---- journal: media vouches ---------------------------------------------------


async def test_thumbnail_persist_crash_keeps_journal_consistent(tmp_path):
    """A process death between a chunk's store and its accounting (the
    media job's rendezvous and its vouches die with it): the journal
    never claims a thumbnail the store does not hold, at the crash and
    after the resume, and a fresh pass converges to all stored and all
    vouched."""
    loc_path = tmp_path / "stuff"
    loc_path.mkdir()
    rng = np.random.default_rng(3)
    for i in range(6):
        Image.fromarray(rng.integers(0, 255, (40, 52, 3), dtype=np.uint8), "RGB").save(
            loc_path / f"p{i}.png")

    # phase 1: index + identify with NO thumbnailer: cas vouches only
    node = _Node(None)
    library = Libraries(tmp_path / "data", node=node).create("crash")
    mgr = JobManager(TaskSystem(2))
    await _scan_chain(library, mgr, loc_path)
    rows = library.db.query("SELECT * FROM file_path WHERE is_dir = 0 AND cas_id IS NOT NULL")
    assert len(rows) == 6
    journal = IndexJournal(library.db)
    loc_id = library.db.find_one("location")["id"]
    lib_id = str(library.id)

    def vouched_thumbs():
        out = set()
        for r in rows:
            _v, entry = journal.lookup(loc_id, key_of(r), None, count_invalidated=False)
            if entry is not None and entry.thumb:
                out.add(r["cas_id"])
        return out

    # phase 2: the "process" dies after the first chunk is stored
    class ProcessDeath(BaseException):
        pass

    thumbs = tmp_path / "data" / "thumbnails"
    t1 = _cpu_thumbnailer(thumbs)
    t1.chunk_rows = 2

    async def die(batch, n):
        raise ProcessDeath

    t1._account = die
    entries = [(r["cas_id"], os.path.join(loc_path, f"{r['name']}.png"), "png") for r in rows]
    t1.new_indexed_thumbnails_batch(lib_id, entries)
    with pytest.raises(ProcessDeath):
        await t1._worker
    stored = {c for c, _p, _e in entries if t1.store.exists(lib_id, c)}
    assert 0 < len(stored) < len(entries)  # a partial prefix landed
    assert vouched_thumbs() <= stored

    # phase 3: a fresh actor resumes the persisted batch, skipping the
    # stored prefix; a fresh media pass vouches only store-verified
    # thumbnails, and everything converges
    node.thumbnailer = _cpu_thumbnailer(thumbs)
    assert node.thumbnailer.skipped == len(stored)
    await _scan_chain(library, mgr, loc_path)
    await node.thumbnailer.wait_library_batch(lib_id)
    await _scan_chain(library, mgr, loc_path)  # vouch pass after the drain
    all_cas = {r["cas_id"] for r in rows}
    assert {c for c in all_cas if node.thumbnailer.store.exists(lib_id, c)} == all_cas
    assert vouched_thumbs() == all_cas
    await node.thumbnailer.shutdown()
    await mgr.system.shutdown()
    library.close()


async def test_warm_media_pass_skips_thumb_and_exif(tmp_path, monkeypatch):
    loc_path = tmp_path / "stuff"
    (loc_path / "docs").mkdir(parents=True)
    (loc_path / "docs" / "a.txt").write_bytes(b"hello journal")
    Image.new("RGB", (32, 24), (10, 200, 10)).save(loc_path / "green.png")
    Image.new("RGB", (64, 48), (200, 10, 10)).save(loc_path / "red.jpg")
    node, library, mgr = await _pipeline(tmp_path)
    try:
        await _scan_chain(library, mgr, loc_path)
        extracts = []
        real = media_job.ImageMetadata.from_path

        def counting(path):
            extracts.append(path)
            return real(path)

        monkeypatch.setattr(media_job.ImageMetadata, "from_path", staticmethod(counting))
        dispatched_before = node.thumbnailer.generated + node.thumbnailer.skipped
        (_, _, media), _ = await _scan_chain(library, mgr, loc_path)
        # warm pass: EXIF not re-extracted, thumbnail not re-dispatched
        assert extracts == []
        assert node.thumbnailer.generated + node.thumbnailer.skipped == dispatched_before
        assert media == {"media_data_extracted": 0, "media_data_skipped": 0,
                         "thumbnails_dispatched": 0, "embeddings_written": 0}
    finally:
        await node.thumbnailer.shutdown()
        await mgr.system.shutdown()
        library.close()


def _seed_location(db):
    db.execute("INSERT INTO location (id, pub_id, path) VALUES (1, ?, ?)", (b"\x01" * 16, "/x"))


def test_journal_amend_refuses_stale_and_foreign_cas(tmp_path):
    db = LibraryDb(tmp_path / "j.db")
    _seed_location(db)
    journal = IndexJournal(db)
    key = ("/", "f", "bin")
    ident = Identity(1, 1, 1, 1)
    journal.record_many(1, [(key, ident, "11" * 8, None, None)])
    journal.vouch_thumb(1, key, "22" * 8)  # against the WRONG cas: refused
    assert not journal.lookup(1, key, ident)[1].thumb
    journal.vouch_embed(1, ("/", "ghost", "bin"), "11" * 8)  # no row: nothing written
    assert db.count("index_journal") == 1
    journal.mark_stale(1, key)
    journal.vouch_thumb(1, key, "11" * 8)  # after staleness: refused
    assert not journal.lookup(1, key, ident)[1].thumb
    db.close()


def test_vouches_match_jax_payload_bytes_and_carry_forward(tmp_path):
    """The same record + vouch sequence gives byte-equal payloads in
    both packages; an mtime-only re-record keeps the vouches, a content
    change voids them."""
    payloads = {}
    for name, mod, db_cls in (("port", None, LibraryDb), ("jax", jjournal, JaxDb)):
        db = db_cls(tmp_path / f"{name}.db")
        _seed_location(db)
        j = IndexJournal(db) if mod is None else mod.IndexJournal(db)
        entry_cls = Identity if mod is None else mod.Identity
        key, ident = ("/", "f", "jpg"), entry_cls(1, 1, 100, 4)
        j.record_many(1, [(key, ident, "aa" * 8, None, None)])
        j.vouch_thumb(1, key, "aa" * 8)
        j.vouch_media(1, key, "aa" * 8, "digest1")
        j.vouch_embed(1, key, "aa" * 8)
        j.vouch_media(1, ("/", "g", "png"), "bb" * 8, "")
        snaps = [bytes(db.query_one("SELECT payload FROM index_journal")["payload"])]
        _, entry = j.lookup(1, key, ident)
        touched = entry_cls(1, 1, 200, 4)  # mtime moved, content didn't
        j.record_many(1, [(key, touched, "aa" * 8, None, entry)])
        verdict, e2 = j.lookup(1, key, touched)
        assert verdict == HIT and e2.thumb and e2.embed and e2.media_digest == "digest1"
        snaps.append(bytes(db.query_one("SELECT payload FROM index_journal")["payload"]))
        changed = entry_cls(1, 1, 300, 4)
        j.record_many(1, [(key, changed, "bb" * 8, None, e2)])
        _, e3 = j.lookup(1, key, changed)
        assert not e3.thumb and not e3.embed and e3.media_digest is None
        payloads[name] = snaps
        db.close()
    assert payloads["port"] == payloads["jax"]
    assert unpackb(payloads["port"][0]) == {"v": 1, "thumb": True, "media": "digest1",
                                            "embed": True}


def test_lookup_counts_and_bytes_saved(tmp_path):
    db = LibraryDb(tmp_path / "j.db")
    _seed_location(db)
    journal = IndexJournal(db)
    key, ident = ("/", "f", "bin"), Identity(1, 1, 1, 1)
    journal.lookup(1, key, ident)  # miss
    journal.record_many(1, [(key, ident, "11" * 8, None, None)])
    journal.lookup(1, key, ident)  # hit
    assert journal.lookup(1, key, Identity(1, 1, 2, 1))[0] == INVALIDATED
    journal.lookup(1, key, Identity(1, 1, 2, 1), count_invalidated=False)  # not counted
    journal.bytes_saved(4096)
    journal.bytes_saved(0)
    assert dict(journal.counts) == {"miss": 1, "hit": 1, "invalidated": 1, "bytes_saved": 4096}
    db.close()


def test_decode_dispatch_and_can_generate(tmp_path):
    path = tmp_path / "a.png"
    Image.new("RGB", (30, 20), (1, 2, 3)).save(path)
    assert process.can_generate("PNG") and not process.can_generate("mp4")
    assert process.decode(str(path), "png").array.shape == (20, 30, 4)
    with pytest.raises(process.ThumbError):
        process.decode(str(path), "mp4")


async def test_rows_of_one_cas_in_one_chunk_store_once_each(tmp_path):
    """Duplicate files (one cas_id) dispatched in one chunk encode and
    store concurrently on the actor's threads: every store lands, none
    collides with another's temporary file."""
    (entry,) = _make_images(tmp_path, n=1)
    th = _cpu_thumbnailer(tmp_path / "data")
    th.chunk_rows = 24
    bid = th.new_indexed_thumbnails_batch("libE", [entry] * 24)
    await th.wait_batch(bid)
    assert th.errors == 0 and th.generated == 24
    shard = os.path.dirname(th.store.path_for("libE", entry[0]))
    assert os.listdir(shard) == [os.path.basename(th.store.path_for("libE", entry[0]))]
    await th.shutdown()
