"""The port's watchers and location manager against the JAX package's.

- The path keys a watcher event turns into (`from_relative_str`,
  `full_name`, `parent`) equal JAX's and the indexer's, dotfiles, names
  with several dots and the location root among them.
- The journal's watcher methods (`mark_stale_subtree`, `rename_path`,
  `delete_path`) leave rows equal to JAX's, byte for byte.
- An inotify watcher of each package on one directory sees one scripted
  sequence of file operations: the event lists are equal; so are the
  polling backend's snapshot diffs.
- A JAX manager and a port manager apply one `WatchEvent` script
  (renames of a file and of a directory, a remove, a create, a modify, a
  lost-events rescan) to two copies of one seeded corpus, with the
  debounce compressed: the file_path rows and the journal rows are
  equal. Cut after the remove, the script pins the one difference: the
  port's directory sizes are those JAX's take once rolled up.
- A port Node's live update, as in tests/test_watcher.py:107; a Node on
  "cpu" rescans on "cpu".
- Where the port's manager differs from JAX's (a paused fs-ops job's
  own writes are dropped, and only those; a new directory gets its row;
  removes and renames set the sizes of the directories they change), a
  full rescan leaves the watched rows as they are.

Every test that waits on a watcher has its own deadline and stops its
watchers and nodes in teardown.
"""

import asyncio
import logging
import os
import shutil
import time

import numpy as np
import pytest

import spacedrive_tpu.telemetry as jtelemetry
from spacedrive_tpu.db.database import LibraryDb as JaxDb
from spacedrive_tpu.files.isolated_path import IsolatedFilePathData as JaxIso
from spacedrive_tpu.location.indexer import journal as jjournal
from spacedrive_tpu.location.watcher import new_watcher as jax_new_watcher
from spacedrive_tpu.location.watcher import polling as jpolling
from spacedrive_tpu_torch.db.database import LibraryDb
from spacedrive_tpu_torch.files.isolated_path import IsolatedFilePathData
from spacedrive_tpu_torch.location.indexer import journal
from spacedrive_tpu_torch.location.watcher import EventKind, WatchEvent, new_watcher
from spacedrive_tpu_torch.location.watcher import inotify, polling

DEADLINE_S = 20.0


@pytest.fixture(autouse=True)
def _direct_path(monkeypatch):
    """The JAX node's router and jobs take their direct path, and its
    telemetry is reset after each test."""
    monkeypatch.setenv("SD_SERVE_GATE", "0")
    yield
    jtelemetry.reset()


async def _until(cond, timeout=DEADLINE_S, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if cond():
                return
        except Exception:
            pass
        await asyncio.sleep(0.05)
    raise TimeoutError(f"{what} never became true within {timeout} s")


def _wire(events):
    return [(e.kind.value, e.path, e.old_path, e.is_dir) for e in events]


# --- the keys of a watcher event ----------------------------------------------

RELS = ["", "/", "a.txt", ".hidden", ".config.json", "archive.tar.gz", "noext", "trailing.",
        "dir/", "dir/sub/", "dir/sub/file.JPG", "dir/.env", "a/b/c.d.e", "x/y z.txt",
        "ünï/çødé.txt"]


@pytest.mark.parametrize("rel", RELS)
def test_relative_keys_match_jax_and_the_indexer(rel, tmp_path):
    for is_dir in (None, False, True):
        got = IsolatedFilePathData.from_relative_str(7, rel, is_dir)
        want = JaxIso.from_relative_str(7, rel, is_dir)
        assert vars(got) == vars(want)
        assert journal.key_of(got) == jjournal.key_of(want)
        assert got.full_name() == want.full_name()
        assert vars(got.parent()) == vars(want.parent())
        if rel.strip("/"):
            # the key the indexer writes for the same path on disk
            full = os.path.join(str(tmp_path), rel.strip("/").replace("/", os.sep))
            dir_flag = rel.endswith("/") if is_dir is None else is_dir
            walked = IsolatedFilePathData.new(7, str(tmp_path), full, dir_flag)
            assert journal.key_of(walked) == journal.key_of(got)


# --- the journal's watcher methods --------------------------------------------


def _journal_rows(db):
    return {(r["location_id"], r["materialized_path"], r["name"], r["extension"]):
            (bytes(r["inode"]), bytes(r["dev"]), bytes(r["mtime_ns"]), bytes(r["size"]),
             r["cas_id"], bytes(r["payload"]), r["stale"])
            for r in db.query("SELECT * FROM index_journal")}


def _journal_script(mod, db):
    db.execute("INSERT INTO location (id, pub_id, path) VALUES (1, ?, '/l')", (b"\x01" * 16,))
    j = mod.IndexJournal(db)
    keys = [("/", "a", "txt"), ("/", "b", "bin"), ("/d/", "c", "txt"), ("/d/", "s", ""),
            ("/d/s/", "e", "jpg"), ("/d/s/", "f", ""), ("/e/", "c", "txt"), ("/", "z", "txt")]
    j.record_many(1, [(k, mod.Identity(i + 1, 9, 1000 * (i + 1), 100 + i), f"{i:016x}",
                       None, None) for i, k in enumerate(keys)])
    j.vouch_thumb(1, ("/d/s/", "e", "jpg"), f"{4:016x}")
    steps, snaps = [], [_journal_rows(db)]
    steps.append(j.mark_stale(1, ("/", "a", "txt")))
    steps.append(j.mark_stale_subtree(1, "/d/s/"))
    snaps.append(_journal_rows(db))
    j.rename_path(1, ("/", "b", "bin"), ("/", "b2", "bin"))
    snaps.append(_journal_rows(db))
    # onto an existing key: the old row at the target goes
    j.rename_path(1, ("/", "b2", "bin"), ("/", "z", "txt"))
    snaps.append(_journal_rows(db))
    # a directory: its own key and its subtree move, landing keys cleared
    j.rename_path(1, ("/", "d", ""), ("/", "e", ""), "/d/", "/e/")
    snaps.append(_journal_rows(db))
    j.delete_path(1, ("/", "a", "txt"))
    snaps.append(_journal_rows(db))
    j.delete_path(1, ("/e/", "s", ""), "/e/s/")
    snaps.append(_journal_rows(db))
    return steps, snaps


def test_journal_watcher_methods_match_jax(tmp_path):
    port_db, jax_db = LibraryDb(tmp_path / "p.db"), JaxDb(tmp_path / "j.db")
    try:
        port = _journal_script(journal, port_db)
        jax = _journal_script(jjournal, jax_db)
    finally:
        port_db.close()
        jax_db.close()
    assert port == jax
    steps, snaps = port
    assert steps == [1, 2]
    assert set(snaps[-1]) == {(1, "/", "z", "txt"), (1, "/e/", "c", "txt")}
    # the renamed file kept its identity and cas: nothing to rehash
    assert snaps[-1][(1, "/", "z", "txt")][4] == f"{1:016x}"


def test_journal_methods_write_nothing_when_disabled(tmp_path, monkeypatch):
    db = LibraryDb(tmp_path / "p.db")
    try:
        db.execute("INSERT INTO location (id, pub_id, path) VALUES (1, ?, '/l')", (b"\x01" * 16,))
        j = journal.IndexJournal(db)
        j.record_many(1, [(("/", "a", "txt"), journal.Identity(1, 1, 1, 1), "00" * 8, None,
                           None)])
        monkeypatch.setenv("SD_INDEX_JOURNAL", "0")
        assert j.mark_stale_subtree(1, "/") == 0
        j.rename_path(1, ("/", "a", "txt"), ("/", "b", "txt"))
        j.delete_path(1, ("/", "a", "txt"))
        monkeypatch.delenv("SD_INDEX_JOURNAL")
        assert list(_journal_rows(db)) == [(1, "/", "a", "txt")]
    finally:
        db.close()


# --- the backends ----------------------------------------------------------------


def _needs_inotify():
    if not inotify.available():
        pytest.skip("the host has no inotify")


def test_inotify_events_match_jax(tmp_path):
    """One scripted sequence, seen by a watcher of each package on the
    same directory at once."""
    _needs_inotify()
    root = tmp_path / "watched"
    outside = tmp_path / "outside"
    root.mkdir()
    outside.mkdir()
    (root / "leaves.txt").write_text("bye")
    (outside / "arrives.txt").write_text("hi")

    async def run():
        got = {"jax": [], "port": []}
        watchers = [jax_new_watcher(str(root), got["jax"].append),
                    new_watcher(str(root), got["port"].append)]
        assert isinstance(watchers[1], inotify.InotifyWatcher)
        for w in watchers:
            w.start()
        try:
            (root / "a.txt").write_text("hi")
            sub = root / "sub"
            sub.mkdir()
            await asyncio.sleep(0.05)
            (sub / "inner.txt").write_text("x")
            await asyncio.sleep(0.05)
            os.rename(root / "a.txt", root / "b.txt")
            os.rename(sub, root / "sub2")
            (root / "sub2" / "after.txt").write_text("y")
            os.utime(root / "b.txt", (1, 1))
            os.rename(root / "leaves.txt", outside / "leaves.txt")
            os.rename(outside / "arrives.txt", root / "arrives.txt")
            await asyncio.sleep(0.3)  # > RENAME_GRACE
            os.remove(root / "b.txt")
            shutil.rmtree(root / "sub2")
            await asyncio.sleep(0.3)
        finally:
            for w in watchers:
                w.stop()
        return got

    got = asyncio.run(run())
    assert _wire(got["port"]) == _wire(got["jax"])
    kinds = {(e.kind, os.path.basename(e.path)) for e in got["port"]}
    assert {(EventKind.MODIFY, "a.txt"), (EventKind.CREATE, "sub"),
            (EventKind.MODIFY, "inner.txt"), (EventKind.RENAME, "b.txt"),
            (EventKind.RENAME, "sub2"), (EventKind.MODIFY, "after.txt"),
            (EventKind.REMOVE, "leaves.txt"), (EventKind.CREATE, "arrives.txt"),
            (EventKind.REMOVE, "inner.txt")} <= kinds
    # the watch on the renamed directory follows it
    assert any(e.path == str(root / "sub2" / "after.txt") for e in got["port"])


def test_inotify_async_emit_handler_failure_is_supervised(caplog):
    """A failing async handler is retained, retrieved and logged, never
    orphaned."""
    async def run():
        async def boom(event):
            raise RuntimeError("handler exploded")

        w = inotify.InotifyWatcher("/tmp", boom)
        w._loop = asyncio.get_running_loop()
        w._emit(WatchEvent(EventKind.CREATE, "/tmp/x", is_dir=False))
        assert len(w._emit_tasks) == 1
        for _ in range(10):
            await asyncio.sleep(0)
            if not w._emit_tasks:
                break
        assert not w._emit_tasks

    with caplog.at_level(logging.ERROR, logger="spacedrive_tpu_torch.location.watcher.inotify"):
        asyncio.run(run())
    assert any("emit handler failed" in r.message for r in caplog.records)


def test_polling_diffs_match_jax(tmp_path):
    rng = np.random.default_rng(11)
    root = tmp_path / "tree"
    (root / "d").mkdir(parents=True)
    for name in ("x.txt", "gone.txt", "d/keep.bin", "d/grow.bin"):
        (root / name).write_bytes(rng.bytes(int(rng.integers(1, 4000))))
    ops = [
        lambda: os.rename(root / "x.txt", root / "y.txt"),
        lambda: os.remove(root / "gone.txt"),
        lambda: (root / "new.txt").write_text("hello"),
        lambda: open(root / "d" / "grow.bin", "ab").write(b"more"),
        lambda: os.rename(root / "d", root / "e"),
    ]
    snaps = [(polling.take_snapshot(str(root)), jpolling.take_snapshot(str(root)))]
    for op in ops:
        op()
        snaps.append((polling.take_snapshot(str(root)), jpolling.take_snapshot(str(root))))
    for (p0, j0), (p1, j1) in zip(snaps, snaps[1:]):
        assert p0 == j0 and p1 == j1
        assert _wire(polling.diff_snapshots(p0, p1)) == _wire(jpolling.diff_snapshots(j0, j1))
    diff = polling.diff_snapshots(snaps[0][0], snaps[1][0])
    assert [(e.kind, os.path.basename(e.old_path)) for e in diff
            if e.kind == EventKind.RENAME] == [(EventKind.RENAME, "x.txt")]


def test_polling_5k_files_diff_matches_jax(tmp_path):
    """tests/test_watcher.py's 5k-file polling smoke: an unchanged tree
    diffs to nothing, and sparse changes in the forest come out as JAX's
    events, nothing else invented but parent-directory modifies."""
    root = tmp_path / "big"
    paths = []
    for d in range(25):
        (root / f"d{d:04d}").mkdir(parents=True)
        for i in range(200):
            p = root / f"d{d:04d}" / f"f{i:04d}"
            p.write_bytes(b"x" * 64)
            paths.append(str(p))
    snap = polling.take_snapshot(str(root))
    assert len(snap) >= 5000 and polling.diff_snapshots(snap, polling.take_snapshot(str(root))) == []
    os.unlink(paths[3])
    with open(paths[77], "ab") as f:
        f.write(b"more")
    new_file = root / "d0000" / "brand-new"
    new_file.write_bytes(b"hi")
    os.rename(paths[500], paths[500] + ".moved")
    after = polling.take_snapshot(str(root))
    got = polling.diff_snapshots(snap, after)
    assert _wire(got) == _wire(jpolling.diff_snapshots(snap, after))
    kinds = {(e.kind, e.path) for e in got}
    assert {(EventKind.REMOVE, paths[3]), (EventKind.MODIFY, paths[77]),
            (EventKind.CREATE, str(new_file)), (EventKind.RENAME, paths[500] + ".moved")} <= kinds
    assert all(os.path.isdir(p) for _, p in kinds - {
        (EventKind.REMOVE, paths[3]), (EventKind.MODIFY, paths[77]),
        (EventKind.CREATE, str(new_file)), (EventKind.RENAME, paths[500] + ".moved")})


def test_polling_watcher_emits(tmp_path):
    root = tmp_path / "tree"
    root.mkdir()
    (root / "a.txt").write_text("a")

    async def run():
        events = []
        w = new_watcher(str(root), events.append, force_polling=True, poll_interval=0.05)
        assert isinstance(w, polling.PollingWatcher)
        await w.start_async()
        try:
            (root / "b.txt").write_text("b")
            os.remove(root / "a.txt")
            await _until(lambda: {(EventKind.CREATE, "b.txt"), (EventKind.REMOVE, "a.txt")}
                         <= {(e.kind, os.path.basename(e.path)) for e in events},
                         what="the polling watcher's create and remove")
        finally:
            w.stop()

    asyncio.run(run())


# --- the manager: one WatchEvent script on each package ------------------------


def _corpus(root, seed=3):
    rng = np.random.default_rng(seed)
    files = {"a.txt": 1000, "b.bin": 150_000, "keep.txt": 300, "dir1/c.txt": 700,
             "dir1/d.bin": 2000, "dir1/sub/e.txt": 50, "dir1/sub/f.bin": 120_000}
    for rel, size in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(rng.bytes(size))
        os.utime(path, ns=(1_600_000_000_000_000_000, 1_600_000_000_000_000_000))
    return root


def _write(path, data, mtime_ns):
    with open(path, "wb") as f:
        f.write(data)
    os.utime(path, ns=(mtime_ns, mtime_ns))


def _apply_script(root):
    """The disk operations, each with the event a watcher reports for it;
    the remove is the third."""
    rng = np.random.default_rng(21)
    j = os.path.join
    os.rename(j(root, "a.txt"), j(root, "a2.txt"))
    yield "rename", j(root, "a2.txt"), j(root, "a.txt"), False
    os.rename(j(root, "dir1"), j(root, "dir9"))
    yield "rename", j(root, "dir9"), j(root, "dir1"), True
    os.remove(j(root, "dir9", "c.txt"))
    yield "remove", j(root, "dir9", "c.txt"), None, False
    _write(j(root, "new.txt"), rng.bytes(4096), 1_700_000_000_000_000_000)
    yield "create", j(root, "new.txt"), None, False
    data = bytearray(open(j(root, "dir9", "d.bin"), "rb").read())
    data[100:200] = rng.bytes(100)
    _write(j(root, "dir9", "d.bin"), bytes(data), 1_700_000_000_000_000_000)
    yield "modify", j(root, "dir9", "d.bin"), None, False
    _write(j(root, "dir9", "sub", "g.txt"), rng.bytes(900), 1_700_000_000_000_000_000)
    yield "rescan", j(root, "dir9", "sub"), None, True


def _file_rows(db):
    cols = ("id", "is_dir", "cas_id", "location_id", "materialized_path", "name", "extension",
            "hidden", "size_in_bytes", "size_in_bytes_bytes", "object_id")
    return sorted(tuple(r[c] for c in cols) for r in db.query("SELECT * FROM file_path"))


def _journal_keyed(db):
    return {k: (v[2], v[3], v[4], v[5], v[6]) for k, v in _journal_rows(db).items()}


async def _settled(node, entry):
    mgr = node.location_manager
    await _until(lambda: entry.flush_handle is None and not mgr._flush_tasks,
                 what="the manager's flush")
    await node.jobs.wait_idle()


async def _script_on(pkg, data_dir, root, steps):
    if pkg == "jax":
        from spacedrive_tpu.location.indexer.job import IndexerJob
        from spacedrive_tpu.location.locations import (LocationCreateArgs, scan_location,
                                                       update_location_size)
        from spacedrive_tpu.location.watcher import EventKind as Kind, WatchEvent as Event
        from spacedrive_tpu.node import Node

        node = Node(data_dir, use_device=False, with_labeler=False)
        node.config.config.p2p.enabled = False
        scan_kw = {}
    else:
        from spacedrive_tpu_torch.location.indexer.job import IndexerJob
        from spacedrive_tpu_torch.location.locations import (LocationCreateArgs, scan_location,
                                                             update_location_size)
        from spacedrive_tpu_torch.node.node import Node

        Kind, Event = EventKind, WatchEvent
        node = Node(data_dir, device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        scan_kw = {"backend": "cpu"}
    await node.start()
    try:
        lib = await node.create_library("watched")
        loc = LocationCreateArgs(path=root, name="corpus").create(lib)
        await scan_location(lib, loc, node.jobs, **scan_kw)
        await node.jobs.wait_idle()
        mgr = node.location_manager
        mgr.debounce, mgr.debounce_max = 0.05, 0.2
        # a polling watcher that never ticks: the script's events are the only ones
        await mgr.add(lib, loc, force_polling=True, poll_interval=3600)
        entry = next(iter(mgr._watched.values()))
        for _, (kind, path, old, is_dir) in zip(range(steps), _apply_script(root)):
            await mgr._on_event(entry, Event(Kind(kind), path, old_path=old, is_dir=is_dir))
            await _settled(node, entry)
        def sized():
            return _file_rows(lib.db), lib.db.find_one("location", id=loc["id"])["size_in_bytes"]

        rows = sized()
        # the indexer's full roll-up of the sizes, as a scan ends
        IndexerJob._rollup_directory_sizes(lib, loc["id"])
        update_location_size(lib, loc["id"])
        return {"rows": rows, "rolled_up": sized(), "journal": _journal_keyed(lib.db),
                "applied": mgr.events_applied}
    finally:
        await node.shutdown()


@pytest.mark.parametrize("steps", [6, 3], ids=["whole_script", "ends_on_the_remove"])
def test_manager_script_matches_jax(tmp_path, steps):
    got = {}
    for pkg in ("jax", "port"):
        root = _corpus(str(tmp_path / f"{pkg}_corpus"))
        got[pkg] = asyncio.run(asyncio.wait_for(
            _script_on(pkg, str(tmp_path / f"{pkg}_data"), root, steps), 120))
    assert got["port"]["applied"] == got["jax"]["applied"] == steps
    assert got["port"]["journal"] == got["jax"]["journal"]
    # the port's manager leaves the sizes a scan's roll-up leaves
    assert got["port"]["rows"] == got["port"]["rolled_up"] == got["jax"]["rolled_up"]
    by_name = {r[5]: r for r in got["port"]["rows"][0]}
    assert "a" not in by_name and by_name["a2"][2] is not None
    assert by_name["e"][4] == "/dir9/sub/" and "c" not in by_name
    if steps == 6:
        # the closing rescans roll JAX's sizes up too
        assert got["port"]["rows"] == got["jax"]["rows"]
        assert by_name["new"][2] is not None and by_name["g"][2] is not None
    else:
        # JAX leaves the size of the removed file's directory, and the
        # location's, as they were: only those differ
        (jrows, jsize), (jrolled, jrolled_size) = got["jax"]["rows"], got["jax"]["rolled_up"]
        assert {(r[4], r[5]) for r in set(jrows) ^ set(jrolled)} == {("/", "dir9")}
        assert jsize != jrolled_size


# --- the manager's own behaviour ---------------------------------------------------


def test_rescans_run_on_the_nodes_device(tmp_path, monkeypatch):
    """A Node on "cpu" passes "cpu" to its watcher's shallow and deep
    rescans (the scan chain's own default is "cuda")."""
    from spacedrive_tpu_torch.location import manager as manager_mod
    from spacedrive_tpu_torch.node.node import Node

    seen = []

    async def record(kind, *args, backend="cuda"):
        seen.append((kind, args[2], backend))

    monkeypatch.setattr(manager_mod, "light_scan_location",
                        lambda *a, **k: record("shallow", *a, **k))
    monkeypatch.setattr(manager_mod, "deep_rescan_sub_path",
                        lambda *a, **k: record("deep", *a, **k))

    async def run():
        node = Node(str(tmp_path / "node"), device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            entry = manager_mod._Watched(library=None, location={"id": 1}, watcher=None)
            entry.dirty_dirs, entry.deep_dirs = {"/a"}, {"/b"}
            await node.location_manager._flush(entry)
        finally:
            await node.shutdown()

    asyncio.run(asyncio.wait_for(run(), 60))
    assert seen == [("deep", "/b", "cpu"), ("shallow", "/a", "cpu")]


def test_flush_task_supervised(caplog):
    from spacedrive_tpu_torch.location.manager import LocationManager, _Watched

    async def run():
        mgr = LocationManager(node=None)

        async def failing_flush(entry):
            raise RuntimeError("rescan exploded")

        mgr._flush = failing_flush
        entry = _Watched(library=None, location={}, watcher=None)
        mgr._spawn_flush(asyncio.get_running_loop(), entry)
        assert len(mgr._flush_tasks) == 1
        for _ in range(10):
            await asyncio.sleep(0)
            if not mgr._flush_tasks:
                break
        assert not mgr._flush_tasks
        await mgr.shutdown()

    with caplog.at_level(logging.ERROR, logger="spacedrive_tpu_torch.location.manager"):
        asyncio.run(run())
    assert any("debounced rescan failed" in r.message for r in caplog.records)


# --- a port Node's live update --------------------------------------------------


async def _live_node(tmp_path, corpus):
    from spacedrive_tpu_torch.location.locations import LocationCreateArgs, scan_location
    from spacedrive_tpu_torch.node.node import Node

    node = Node(str(tmp_path / "node"), device="cpu", with_labeler=False)
    node.config.config.p2p.enabled = False
    await node.start()
    lib = await node.create_library("watched")
    loc = LocationCreateArgs(path=str(corpus), name="corpus").create(lib)
    await scan_location(lib, loc, node.jobs, backend="cpu")
    await node.jobs.wait_idle()
    await node.location_manager.add(lib, loc)
    return node, lib, loc


def test_node_live_updates(tmp_path):
    """tests/test_watcher.py:107 on a port Node."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "keep.txt").write_text("keep me")
    (corpus / "old-name.txt").write_text("rename me")
    (corpus / "doomed.txt").write_text("delete me")
    sub = corpus / "drawer"
    sub.mkdir()
    (sub / "inside.txt").write_text("nested")

    async def run():
        node, lib, loc = await _live_node(tmp_path, corpus)
        db = lib.db
        try:
            assert node.location_manager.is_watched(lib, loc["id"])
            base = db.count("file_path")
            row = db.find_one("file_path", name="old-name")
            os.rename(corpus / "old-name.txt", corpus / "new-name.txt")
            await _until(lambda: db.find_one("file_path", name="new-name") is not None)
            assert db.find_one("file_path", name="old-name") is None
            assert db.count("file_path") == base
            moved = db.find_one("file_path", name="new-name")
            assert (moved["id"], moved["object_id"]) == (row["id"], row["object_id"])

            os.rename(sub, corpus / "cabinet")
            await _until(lambda: db.find_one("file_path", name="cabinet", is_dir=1) is not None)
            assert db.find_one("file_path", name="inside")["materialized_path"] == "/cabinet/"

            os.remove(corpus / "doomed.txt")
            await _until(lambda: db.find_one("file_path", name="doomed") is None)

            (corpus / "fresh.bin").write_bytes(os.urandom(4096))
            await _until(lambda: (r := db.find_one("file_path", name="fresh")) is not None
                         and r["cas_id"] is not None)
            assert db.find_one("file_path", name="fresh")["object_id"] is not None

            outside = tmp_path / "incoming"
            (outside / "deep").mkdir(parents=True)
            (outside / "hello.txt").write_text("inside the moved dir")
            (outside / "deep" / "leaf.txt").write_text("leaf")
            os.rename(outside, corpus / "incoming")
            await _until(lambda: (leaf := db.find_one("file_path", name="leaf")) is not None
                         and leaf["cas_id"] is not None)
            assert db.find_one("file_path", name="leaf")["materialized_path"] == (
                "/incoming/deep/")

            node.location_manager.pause(lib, loc["id"])
            (corpus / "invisible.txt").write_text("shh")
            await asyncio.sleep(0.6)
            assert db.find_one("file_path", name="invisible") is None
            node.location_manager.resume(lib, loc["id"])
        finally:
            await node.shutdown()

    asyncio.run(asyncio.wait_for(run(), 90))


def test_resume_drops_what_the_pause_covered(tmp_path):
    """Writes made while a location is paused start no rescan on the
    port, even when the loop only reads them after the resume (a fs-ops
    job's synchronous step); the JAX manager applies them."""

    async def run(pkg):
        corpus = tmp_path / pkg / "corpus"
        corpus.mkdir(parents=True)
        (corpus / "a.txt").write_text("a")
        if pkg == "jax":
            from spacedrive_tpu.location.locations import LocationCreateArgs, scan_location
            from spacedrive_tpu.node import Node

            node = Node(str(tmp_path / pkg / "node"), use_device=False, with_labeler=False)
            node.config.config.p2p.enabled = False
            await node.start()
            lib = await node.create_library("watched")
            loc = LocationCreateArgs(path=str(corpus)).create(lib)
            await scan_location(lib, loc, node.jobs)
            await node.jobs.wait_idle()
            await node.location_manager.add(lib, loc)
        else:
            node, lib, loc = await _live_node(tmp_path / pkg, corpus)
        mgr = node.location_manager
        try:
            applied = mgr.events_applied
            mgr.pause(lib, loc["id"])
            (corpus / "scribble.txt").write_text("x" * 100)  # no await: the loop reads nothing
            os.remove(corpus / "scribble.txt")
            mgr.resume(lib, loc["id"])
            await asyncio.sleep(0.4)
            got = mgr.events_applied - applied
            if pkg == "port":
                entry = next(iter(mgr._watched.values()))
                assert entry.flush_handle is None and not entry.dirty_dirs
                # an unpaused write still reaches the index
                (corpus / "b.txt").write_text("b")
                await _until(lambda: lib.db.find_one("file_path", name="b") is not None)
            await node.jobs.wait_idle()
            return got
        finally:
            await node.shutdown()

    assert asyncio.run(asyncio.wait_for(run("port"), 60)) == 0
    assert asyncio.run(asyncio.wait_for(run("jax"), 60)) > 0


def test_an_erase_drops_only_its_own_writes(tmp_path):
    """An erase step pauses the watcher on its own file: a user's write
    elsewhere in the location during the step is indexed, the erased
    file's overwrite and remove are never applied, and a full rescan
    afterwards changes no row."""
    from spacedrive_tpu_torch.location.locations import scan_location
    from spacedrive_tpu_torch.object.fs.erase import FileEraserJob

    rng = np.random.default_rng(12)
    corpus = tmp_path / "corpus"
    for d in ("vault", "notes"):
        (corpus / d).mkdir(parents=True)
    (corpus / "vault" / "secret.bin").write_bytes(rng.bytes(300_000))
    (corpus / "vault" / "other.bin").write_bytes(rng.bytes(5000))
    (corpus / "notes" / "old.txt").write_bytes(rng.bytes(700))
    user = corpus / "notes" / "user.txt"

    def random_bytes(n):
        if not user.exists():  # the user writes while the step holds its file
            user.write_bytes(rng.bytes(2048))
        return rng.bytes(n)

    async def run():
        node, lib, loc = await _live_node(tmp_path, corpus)
        db, mgr = lib.db, node.location_manager
        entry = next(iter(mgr._watched.values()))
        seen = []
        on_event = mgr._on_event

        def record(entry, event):
            seen.append(event.path)
            return on_event(entry, event)

        mgr._on_event = record
        cols = ("materialized_path", "name", "extension", "is_dir", "size_in_bytes_bytes",
                "cas_id", "object_id")
        try:
            job = FileEraserJob({"location_id": loc["id"], "passes": 2, "file_path_ids": [
                db.find_one("file_path", name="secret")["id"]]})
            job.random_bytes = random_bytes
            await node.jobs.ingest(job, lib)
            assert (await node.jobs.wait(job.id)).status.name == "COMPLETED"
            await _until(lambda: (r := db.find_one("file_path", name="user")) is not None
                         and r["cas_id"] is not None, what="the user's write indexed")
            await _until(lambda: entry.flush_handle is None and not mgr._flush_tasks,
                         what="the manager")
            await node.jobs.wait_idle()
            assert str(user) in seen
            assert not any(p.startswith(str(corpus / "vault")) for p in seen), seen
            assert db.find_one("file_path", name="secret") is None
            before = {tuple(r[c] for c in cols) for r in db.query("SELECT * FROM file_path")}
            await scan_location(lib, loc, node.jobs, backend="cpu")
            await node.jobs.wait_idle()
            assert {tuple(r[c] for c in cols) for r in db.query("SELECT * FROM file_path")} == before
        finally:
            await node.shutdown()

    asyncio.run(asyncio.wait_for(run(), 60))


def test_watched_state_equals_a_full_rescan(tmp_path):
    """What the JAX manager leaves stale, the port's does not: a new
    directory gets its own row (its parent walked by an IndexerJob
    alone), and removes and renames set the sizes of the directories
    they change and of the location. A fullRescan afterwards changes no
    row and no size."""
    rng = np.random.default_rng(8)
    corpus = tmp_path / "corpus"
    for d in ("a", "b"):
        (corpus / d).mkdir(parents=True)
        for i in range(3):
            (corpus / d / f"f{i}.bin").write_bytes(rng.bytes(1000 * (i + 1)))
    cols = ("materialized_path", "name", "extension", "is_dir", "size_in_bytes_bytes", "cas_id",
            "object_id")

    async def run():
        from spacedrive_tpu_torch.location.locations import scan_location

        node, lib, loc = await _live_node(tmp_path, corpus)
        db, mgr = lib.db, node.location_manager
        entry = next(iter(mgr._watched.values()))

        async def settled():
            await _until(lambda: entry.flush_handle is None and not mgr._flush_tasks
                         and not entry.watcher._pending_from, what="the manager")
            await node.jobs.wait_idle()

        def rows():
            return ({tuple(r[c] for c in cols) for r in db.query("SELECT * FROM file_path")},
                    db.find_one("location", id=loc["id"])["size_in_bytes"])

        try:
            os.remove(corpus / "a" / "f2.bin")
            os.rename(corpus / "a" / "f1.bin", corpus / "b" / "moved.bin")
            (corpus / "new" / "deep").mkdir(parents=True)
            (corpus / "new" / "deep" / "x.bin").write_bytes(rng.bytes(500))
            await asyncio.sleep(0.3)
            await settled()
            assert db.find_one("file_path", name="new", is_dir=1) is not None
            assert mgr.rollup_seconds > 0
            before = rows()
            await scan_location(lib, loc, node.jobs, backend="cpu")
            await node.jobs.wait_idle()
            assert rows() == before
        finally:
            await node.shutdown()

    asyncio.run(asyncio.wait_for(run(), 60))


def test_a_slow_rename_does_not_split_its_burst(tmp_path, monkeypatch):
    """The burst's quiet time runs from the end of a rename's apply: a
    directory of many rows takes longer than the widest window to
    rewrite, and the renames after it still count in the same burst."""
    import types

    import torch

    from spacedrive_tpu_torch.location import manager as manager_mod

    root = tmp_path / "loc"
    root.mkdir()
    db = LibraryDb(tmp_path / "p.db")
    try:
        db.execute("INSERT INTO location (id, pub_id, path) VALUES (1, ?, ?)",
                   (b"\x01" * 16, str(root)))
        journal.IndexJournal(db).record_many(1, [
            (("/", f"a{i}", "bin"), journal.Identity(i, 1, i, i), "00" * 8, None, None)
            for i in range(3)])
        mgr = manager_mod.LocationManager(types.SimpleNamespace(device=torch.device("cpu")))
        mgr.debounce, mgr.debounce_max = 0.05, 0.2
        entry = manager_mod._Watched(library=types.SimpleNamespace(db=db, id="lib"),
                                     location={"id": 1, "path": str(root)}, watcher=None)
        monkeypatch.setattr(mgr, "_apply_rename", lambda *a: time.sleep(0.3))

        async def run():
            for i in range(3):
                await mgr._on_event(entry, WatchEvent(
                    EventKind.RENAME, str(root / f"b{i}.bin"), old_path=str(root / f"a{i}.bin")))
            entry.flush_handle.cancel()

        asyncio.run(run())
        assert (entry.burst_total, entry.burst_vouched) == (3, 3)
    finally:
        db.close()
