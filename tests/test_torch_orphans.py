"""The port's orphan remover, thumbnail-store clean-up, relink and
ephemeral browsing against the JAX package's.

- `process_clean_up` and `process_clean_up_async` (batches cut to a few
  rows, so both loops turn) on one seeded library state in each
  package's DB: the same objects, tag and label links, media and
  embedding rows and journal rows remain; the actor's `invoke` does the
  same work; the gates tests/test_validator.py:81 and
  tests/test_index_journal.py:542 on the port.
- The thumbnail store's `remove`, `remove_library` and `cleanup`, and the
  actor's `delete_thumbnails`: the same trees as JAX's
  (tests/test_thumbnailer.py:80 on the port).
- `relink_location`: the same rows after a location's directory moved.
- `walk_dir`: the same entries and the same ephemeral thumbnail batches
  as JAX's on one seeded directory; `ephemeralFiles.list` through each
  package's router writes ephemeral thumbnails of the same dimensions.
"""

import asyncio
import os
import shutil
import time
import types

import numpy as np
import pytest
from PIL import Image

import spacedrive_tpu.telemetry as jtelemetry
from spacedrive_tpu.db.database import LibraryDb as JaxDb
from spacedrive_tpu.location import locations as jlocations
from spacedrive_tpu.location import non_indexed as jnon_indexed
from spacedrive_tpu.location.indexer import journal as jjournal
from spacedrive_tpu.node import Libraries as JaxLibraries
from spacedrive_tpu.object import orphan_remover as jremover
from spacedrive_tpu.object.media.thumbnail.store import ThumbnailStore as JaxStore
from spacedrive_tpu_torch.db.database import LibraryDb
from spacedrive_tpu_torch.location import locations, non_indexed
from spacedrive_tpu_torch.location.indexer import journal
from spacedrive_tpu_torch.node.library import Libraries
from spacedrive_tpu_torch.object import orphan_remover
from spacedrive_tpu_torch.object.media.thumbnail.store import ThumbnailStore

PKGS = {"jax": (JaxDb, jjournal, jremover), "port": (LibraryDb, journal, orphan_remover)}


@pytest.fixture(autouse=True)
def _direct_path(monkeypatch):
    monkeypatch.setenv("SD_SERVE_GATE", "0")
    yield
    jtelemetry.reset()


# --- the orphan clean-up -------------------------------------------------------


def _seed_state(db, mod, seed=9):
    """Objects of which every third has no file_path, tags and labels on
    some of each, media and embedding rows, and journal rows of which
    the ones whose file_path is gone are orphans."""
    rng = np.random.default_rng(seed)
    db.execute("INSERT INTO location (id, pub_id, path) VALUES (1, ?, '/l')", (b"\x01" * 16,))
    db.execute("INSERT INTO tag (id, pub_id, name) VALUES (1, ?, 't')", (b"\x02" * 16,))
    db.execute("INSERT INTO label (id, name) VALUES (1, 'cat')")
    j = mod.IndexJournal(db)
    for i in range(1, 41):
        db.execute("INSERT INTO object (id, pub_id, kind) VALUES (?, ?, 5)",
                   (i, i.to_bytes(16, "big")))
        if i % 4 == 0:
            db.execute("INSERT INTO tag_on_object (tag_id, object_id) VALUES (1, ?)", (i,))
        if i % 5 == 0:
            db.execute("INSERT INTO label_on_object (label_id, object_id) VALUES (1, ?)", (i,))
        if i % 6 == 0:
            db.execute("INSERT INTO media_data (object_id) VALUES (?)", (i,))
            db.execute("INSERT INTO object_embedding (object_id, vector, dim) VALUES (?, ?, 4)",
                       (i, rng.bytes(16)))
        key = ("/", f"f{i:02d}", "bin")
        j.record_many(1, [(key, mod.Identity(i, 1, i, i), f"{i:016x}", None, None)])
        if i % 3:
            db.execute("INSERT INTO file_path (pub_id, location_id, materialized_path, name, "
                       "extension, is_dir, object_id) VALUES (?, 1, ?, ?, ?, 0, ?)",
                       (bytes([i]) * 16, *key, i))


def _state(db):
    q = db.query
    return {
        "objects": [r["id"] for r in q("SELECT id FROM object ORDER BY id")],
        "tags": [r["object_id"] for r in q("SELECT object_id FROM tag_on_object ORDER BY 1")],
        "labels": [r["object_id"] for r in q("SELECT object_id FROM label_on_object ORDER BY 1")],
        "media": [r["object_id"] for r in q("SELECT object_id FROM media_data ORDER BY 1")],
        "vectors": [r["object_id"] for r in q("SELECT object_id FROM object_embedding ORDER BY 1")],
        "journal": sorted((r["name"], r["cas_id"], bytes(r["payload"]))
                          for r in q("SELECT * FROM index_journal")),
    }


@pytest.mark.parametrize("mode", ["sync", "async", "actor"])
def test_clean_up_matches_jax(mode, tmp_path, monkeypatch):
    got = {}
    for pkg, (Db, jmod, rmod) in PKGS.items():
        monkeypatch.setattr(rmod, "BATCH", 3)
        monkeypatch.setattr(jmod, "PRUNE_BATCH", 2)
        db = Db(tmp_path / f"{pkg}.db")
        try:
            _seed_state(db, jmod)
            if mode == "sync":
                removed = rmod.process_clean_up(db)
            elif mode == "async":
                removed = asyncio.run(rmod.process_clean_up_async(db))
            else:
                removed = asyncio.run(asyncio.wait_for(_actor_run(rmod, db), 30))
            got[pkg] = (removed, _state(db))
        finally:
            db.close()
    assert got["port"] == got["jax"]
    removed, state = got["port"]
    assert removed == (13 if mode != "actor" else None)
    assert state["objects"] == [i for i in range(1, 41) if i % 3]
    assert all(n % 3 for n in state["tags"] + state["labels"] + state["media"] + state["vectors"])
    assert [name for name, *_ in state["journal"]] == [f"f{i:02d}" for i in range(1, 41) if i % 3]


async def _actor_run(rmod, db):
    """The actor: started, invoked, stopped once the clean-up is seen."""
    actor = rmod.OrphanRemoverActor(db, tick_interval=3600)
    actor.start()
    try:
        await actor.invoke()
        deadline = time.monotonic() + 20
        while db.query_one("SELECT COUNT(*) AS n FROM object o WHERE NOT EXISTS "
                           "(SELECT 1 FROM file_path fp WHERE fp.object_id = o.id)")["n"]:
            assert time.monotonic() < deadline, "the orphan remover never ran"
            await asyncio.sleep(0.02)
        while db.query_one("SELECT COUNT(*) AS n FROM index_journal ij WHERE NOT EXISTS "
                           "(SELECT 1 FROM file_path fp WHERE fp.name = ij.name)")["n"]:
            assert time.monotonic() < deadline, "the journal was never pruned"
            await asyncio.sleep(0.02)
    finally:
        await actor.stop()
    return None


def test_orphan_remover_gate(tmp_path):
    """tests/test_validator.py:81 on the port."""
    from spacedrive_tpu_torch.db.database import new_pub_id, now_iso

    library = Libraries(tmp_path / "data").create("orphans")
    db = library.db
    try:
        kept = db.insert("object", pub_id=new_pub_id(), kind=5, date_created=now_iso())
        orphan = db.insert("object", pub_id=new_pub_id(), kind=5, date_created=now_iso())
        tag = db.insert("tag", pub_id=new_pub_id(), name="t")
        db.insert("tag_on_object", tag_id=tag, object_id=orphan, date_created=now_iso())
        db.insert("file_path", pub_id=new_pub_id(), name="keepme", extension="",
                  materialized_path="/", object_id=kept)
        assert orphan_remover.process_clean_up(db) == 1
        assert db.find_one("object", id=kept) is not None
        assert db.find_one("object", id=orphan) is None
        assert db.find_one("tag_on_object", object_id=orphan) is None
    finally:
        library.close()


def test_prune_orphans_drops_rows_without_file_path(tmp_path):
    """tests/test_index_journal.py:542 on the port."""
    db = LibraryDb(tmp_path / "p.db")
    try:
        loc_id = db.insert("location", pub_id=os.urandom(16), name="l", path="/tmp/x")
        db.insert("file_path", pub_id=os.urandom(16), location_id=loc_id,
                  materialized_path="/", name="alive", extension="bin", is_dir=0)
        ident = journal.Identity(1, 1, 1, 1)
        journal.IndexJournal(db).record_many(loc_id, [
            (("/", "alive", "bin"), ident, "aa" * 8, None, None),
            (("/", "ghost", "bin"), ident, "bb" * 8, None, None)])
        orphan_remover.process_clean_up(db)
        assert {r["name"] for r in db.query("SELECT name FROM index_journal")} == {"alive"}
        assert journal.prune_orphans(db) == 0  # idempotent
    finally:
        db.close()


# --- the thumbnail store ----------------------------------------------------------


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _store_script(store):
    cas, other = "abcdef0123456789", "fff000111222333a"
    out = [store.write("lib1", cas, b"RIFFxxxx").endswith(
        os.path.join("lib1", "abc", f"{cas}.webp"))]
    store.write(None, cas, b"RIFFyyyy")
    store.write("lib1", other, b"RIFFzzzz")
    store.write("lib2", other, b"RIFFzzzz")
    out += [store.exists("lib1", cas), store.exists(None, cas), store.cleanup("lib1", {cas}),
            store.exists("lib1", cas), store.exists("lib1", other), store.cleanup("nope", set())]
    out += [store.remove("lib1", [cas, other]), store.exists("lib1", cas)]
    store.remove_library("lib2")
    return out, _files(store.root)


def test_store_shard_layout_and_cleanup_match_jax(tmp_path):
    got = _store_script(ThumbnailStore(tmp_path / "port"))
    assert got == _store_script(JaxStore(tmp_path / "jax"))
    assert got[0] == [True, True, True, 1, True, False, 0, 1, False]
    assert got[1] == [os.path.join("ephemeral", "abc", "abcdef0123456789.webp"), "version.txt"]


def test_actor_delete_thumbnails(tmp_path):
    from spacedrive_tpu_torch.object.media.thumbnail.actor import Thumbnailer

    actor = Thumbnailer(str(tmp_path / "thumbs"), device="cpu", use_device=False)
    actor.store.write("lib", "0123456789abcdef", b"RIFF")
    assert actor.delete_thumbnails("lib", ["0123456789abcdef", "ffffffffffffffff"]) == 1
    assert not actor.store.exists("lib", "0123456789abcdef")


# --- relink -------------------------------------------------------------------------


def _relink_script(libs_cls, loc_mod, tmp):
    library = libs_cls(os.path.join(tmp, "data")).create("relink")
    try:
        old = os.path.join(tmp, "old")
        os.makedirs(os.path.join(old, "sub"))
        loc = loc_mod.LocationCreateArgs(path=old, name="moved").create(library)
        new = os.path.join(tmp, "new")
        shutil.move(old, new)
        got = loc_mod.relink_location(library, new)
        none_without_marker = loc_mod.relink_location(library, os.path.join(new, "sub"))
        return ({k: got[k] for k in ("id", "name")}, got["path"].replace(tmp, "<tmp>"),
                got["pub_id"] == loc["pub_id"], none_without_marker)
    finally:
        library.close()


def test_relink_location_matches_jax(tmp_path):
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    got = _relink_script(Libraries, locations, str(tmp_path / "port"))
    assert got == _relink_script(JaxLibraries, jlocations, str(tmp_path / "jax"))
    assert got == ({"id": 1, "name": "moved"}, "<tmp>/new", True, None)


# --- ephemeral browsing --------------------------------------------------------------


def _browse_dir(root, seed=4):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "Zdir"))
    os.makedirs(os.path.join(root, "adir"))
    for i, (w, h) in enumerate([(64, 48), (40, 90), (120, 30)]):
        arr = rng.integers(0, 256, (h, w, 3), np.uint8)
        Image.fromarray(arr).save(os.path.join(root, f"img{i}.{('jpg', 'png', 'jpeg')[i]}"))
    files = {"notes.txt": rng.bytes(300), "clip.mp4": rng.bytes(150_000), ".hidden.jpg": b"x",
             "empty.png": b"", "archive.tar.gz": rng.bytes(500), "README": b"readme"}
    for name, data in files.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(data)
    return root


def _stub_node(stored=()):
    batches = []
    thumbnailer = types.SimpleNamespace(
        store=types.SimpleNamespace(exists=lambda lib, cas: cas in stored),
        new_ephemeral_thumbnails_batch=batches.append)
    return types.SimpleNamespace(thumbnailer=thumbnailer), batches


@pytest.mark.parametrize("with_hidden", [False, True])
def test_walk_dir_matches_jax(with_hidden, tmp_path):
    root = _browse_dir(str(tmp_path / "browse"))
    got = {}
    for pkg, mod in (("jax", jnon_indexed), ("port", non_indexed)):
        node, batches = _stub_node()
        got[pkg] = (mod.walk_dir(node, root, with_hidden=with_hidden), batches)
    assert got["port"] == got["jax"]
    listing, batches = got["port"]
    names = [e["name"] for e in listing["entries"]]
    assert names[:2] == ["adir", "Zdir"] and (".hidden" in names) == with_hidden
    cas = {e["name"]: e["cas_id"] for e in listing["entries"]}
    assert cas["img0"] and cas["clip"] and cas["notes"] is None and cas["empty"] is None
    assert len(batches) == 1
    assert {os.path.basename(p) for _, p, _ in batches[0]} == (
        {"img0.jpg", "img1.png", "img2.jpeg", "clip.mp4"} | ({".hidden.jpg"} if with_hidden else set()))
    # a stored thumbnail is reported, not queued again
    node, again = _stub_node(stored={cas["img0"]})
    listing = non_indexed.walk_dir(node, root, with_hidden=with_hidden)
    assert {e["name"] for e in listing["entries"] if e["has_created_thumbnail"]} == {"img0"}
    assert cas["img0"] not in {c for c, _, _ in again[0]}


def _webp_dims(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            if f.endswith(".webp"):
                with Image.open(os.path.join(d, f)) as im:
                    out[f[:-len(".webp")]] = im.size
    return out


async def _ephemeral_on(pkg, data_dir, root):
    if pkg == "jax":
        from spacedrive_tpu.node import Node

        node = Node(data_dir, use_device=False, with_labeler=False)
        node.config.config.p2p.enabled = False
    else:
        from spacedrive_tpu_torch.node.node import Node

        node = Node(data_dir, device="cpu", with_labeler=False)
    await node.start()
    try:
        listing = await node.router.exec(node, "ephemeralFiles.list", {"path": root})
        await node.thumbnailer.wait_library_batch(None)
        return listing, _webp_dims(os.path.join(node.thumbnailer.store.root, "ephemeral"))
    finally:
        await node.shutdown()


def test_ephemeral_list_thumbnails_match_jax(tmp_path):
    root = _browse_dir(str(tmp_path / "browse"))
    got = {pkg: asyncio.run(asyncio.wait_for(_ephemeral_on(pkg, str(tmp_path / pkg), root), 60))
           for pkg in ("jax", "port")}
    assert got["port"][0] == got["jax"][0]
    dims = got["port"][1]
    assert dims == got["jax"][1]
    cas = {e["name"]: e["cas_id"] for e in got["port"][0]["entries"]}
    assert {cas["img0"], cas["img1"], cas["img2"]} <= set(dims)
