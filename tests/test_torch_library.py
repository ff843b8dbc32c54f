"""The port's library-backed identify chain against the JAX package's.

Both packages run `JobBuilder(IndexerJob).queue_next(FileIdentifierJob
(backend="cpu"))` on the same tree (the end-to-end fixture of
tests/test_e2e_index.py plus a seeded tree: files over 100 KiB, the
sampling edges, duplicates, empty files, nested dirs; the `.spacedrive`
marker is written by the location create). Exact equality of:

- the (materialized_path, name, extension, is_dir, size) rows;
- each row's cas_id, the object partition of the rows, each object's kind;
- the index journal: key -> identity, cas_id and payload bytes (which
  carry the chunk-cache digests);
- crdt_operation counts per (model, kind);
- directory and location size rollups.

Then the same add / modify-in-place / delete rescan runs on both, with
the same comparisons, and the port's rescan reads no byte of an
unchanged file. Object pub_ids are random in both identifier jobs (the
JAX job mints uuid4s); the deterministic `object_pub_for` and the
`apply_cas_results` link that uses it are held against the JAX package
separately.
"""

import json
import os
import shutil
import types
import uuid

import msgpack
import numpy as np
import pytest

import spacedrive_tpu.jobs as jjobs
import spacedrive_tpu.location.indexer.job as jindexer
import spacedrive_tpu.location.locations as jlocations
import spacedrive_tpu.node.library as jlibrary
import spacedrive_tpu.object.file_identifier.job as jidentifier
import spacedrive_tpu.object.file_identifier.link as jlink
import spacedrive_tpu.tasks as jtasks
import spacedrive_tpu_torch.jobs as pjobs
import spacedrive_tpu_torch.location.indexer.job as pindexer
import spacedrive_tpu_torch.location.locations as plocations
import spacedrive_tpu_torch.node.library as plibrary
import spacedrive_tpu_torch.object.file_identifier.job as pidentifier
import spacedrive_tpu_torch.object.file_identifier.link as plink
import spacedrive_tpu_torch.tasks as ptasks
from spacedrive_tpu_torch import cli
from spacedrive_tpu_torch.db.database import blob_u64
from spacedrive_tpu_torch.ops import cas as pcas


def _pkg(jobs, indexer, identifier, library, locations, tasks):
    return types.SimpleNamespace(
        JobBuilder=jobs.JobBuilder, JobManager=jobs.JobManager,
        IndexerJob=indexer.IndexerJob, FileIdentifierJob=identifier.FileIdentifierJob,
        Libraries=library.Libraries, LocationCreateArgs=locations.LocationCreateArgs,
        TaskSystem=tasks.TaskSystem,
    )


JAX = _pkg(jjobs, jindexer, jidentifier, jlibrary, jlocations, jtasks)
PORT = _pkg(pjobs, pindexer, pidentifier, plibrary, plocations, ptasks)

LARGE = [101 * 1024, 150_000, 300_001, 400_000]
EDGES = [1, 63, 64, 1023, 1024, 1025, 57352, 102399, 102400, 102401]


def _write(path, data):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def make_tree(root):
    """The e2e fixture plus a seeded tree of ~130 files."""
    from PIL import Image

    rng = np.random.default_rng(7)
    _write(os.path.join(root, "docs", "a.txt"), b"hello world")
    _write(os.path.join(root, "docs", "b.txt"), b"hello world")
    _write(os.path.join(root, "big.bin"), rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes())
    _write(os.path.join(root, "empty.txt"), b"")
    Image.new("RGB", (32, 24), (200, 10, 10)).save(os.path.join(root, "red.png"))

    rng = np.random.default_rng(11)
    exts = ["bin", "txt", "jpg", "png", "mp4", "pdf", "", "rs"]
    contents = []
    sizes = LARGE + EDGES + [int(s) for s in rng.integers(1, 20_000, 100)]
    for i, size in enumerate(sizes):
        d = os.path.join(root, "n1", "n2", "n3") if i % 7 == 0 else os.path.join(root, f"d{i % 4}")
        if i % 11 == 0:
            d = os.path.join(d, "deep")
        ext = exts[i % len(exts)]
        name = f"f{i:03d}" + (f".{ext}" if ext else "")
        data = rng.bytes(size)
        _write(os.path.join(d, name), data)
        contents.append(data)
    for i in range(12):  # duplicates of earlier files, large ones included
        _write(os.path.join(root, "dups", f"dup{i:02d}.bin"), contents[(i * 5) % len(contents)])
    for i in range(3):
        _write(os.path.join(root, "d1", f"empty{i}.dat"), b"")
    os.makedirs(os.path.join(root, "n1", "emptydir"))


def mutate_tree(root):
    """Add 4 files, rewrite 2 in place (same length), delete 3."""
    rng = np.random.default_rng(99)
    _write(os.path.join(root, "added", "new0.bin"), rng.bytes(250_000))
    _write(os.path.join(root, "added", "new1.txt"), b"fresh")
    _write(os.path.join(root, "d2", "new2.dat"), rng.bytes(3000))
    with open(os.path.join(root, "docs", "a.txt"), "rb") as f:
        _write(os.path.join(root, "d3", "copy_of_a.txt"), f.read())
    for rel, offset in (("big.bin", 8 * 1024 + 17), ("d1/f001.txt", 100)):
        path = os.path.join(root, rel)
        with open(path, "r+b") as f:
            f.seek(offset)
            old = f.read(8)
            f.seek(offset)
            f.write(bytes(b ^ 0xFF for b in old))
        st = os.stat(path)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 2_000_000_000))
    for rel in ("docs/b.txt", "d2/f002.jpg", "dups/dup03.bin"):
        os.remove(os.path.join(root, rel))


async def run_chain(pkg, lib, loc_id):
    """Indexer → identifier on `pkg`'s job system; returns the two jobs'
    run metadata in order."""
    mgr = pkg.JobManager(pkg.TaskSystem(2))
    try:
        builder = pkg.JobBuilder(pkg.IndexerJob({"location_id": loc_id})).queue_next(
            pkg.FileIdentifierJob({"location_id": loc_id, "backend": "cpu"}))
        first = builder.job.id
        await builder.spawn(mgr, lib)
        await mgr.wait_idle()
    finally:
        await mgr.system.shutdown()
    rows = lib.db.query("SELECT id, name, status, metadata, parent_id FROM job")
    new = [r for r in rows if r["id"] == first.bytes]
    new += [r for r in rows if r["parent_id"] == first.bytes]
    assert [r["name"] for r in new] == ["indexer", "file_identifier"]
    assert all(r["status"] == 2 for r in new), [(r["name"], r["status"]) for r in new]
    return [msgpack.unpackb(r["metadata"]) for r in new]


def snapshot(lib):
    """Everything the two packages must agree on, keyed by row identity."""
    db = lib.db
    rows = db.query(
        "SELECT fp.*, o.kind AS object_kind FROM file_path fp "
        "LEFT JOIN object o ON o.id = fp.object_id")
    key = lambda r: (r["materialized_path"], r["name"], r["extension"])  # noqa: E731
    groups = {}
    for r in rows:
        if r["object_id"] is not None:
            groups.setdefault(r["object_id"], set()).add(key(r))
    journal = {
        key(r): (blob_u64(r["inode"]), blob_u64(r["dev"]), blob_u64(r["mtime_ns"]),
                 blob_u64(r["size"]), r["cas_id"], bytes(r["payload"]), r["stale"])
        for r in db.query("SELECT * FROM index_journal")
    }
    loc = db.query_one("SELECT size_in_bytes FROM location")
    return {
        "rows": {(*key(r), r["is_dir"], blob_u64(r["size_in_bytes_bytes"])) for r in rows},
        "cas_id": {key(r): r["cas_id"] for r in rows},
        "objects": {frozenset(g) for g in groups.values()},
        "object_kind": {key(r): r["object_kind"] for r in rows},
        "journal": journal,
        "ops": {(r["model"], r["kind"]): r["n"] for r in db.query(
            "SELECT model, kind, COUNT(*) AS n FROM crdt_operation GROUP BY model, kind")},
        "location_size": blob_u64(loc["size_in_bytes"]),
        "object_count": db.count("object"),
    }


def assert_same(port, jax):
    for k in jax:
        assert port[k] == jax[k], k


def _libraries(tmp_path):
    loc = tmp_path / "loc"
    make_tree(str(loc))
    jlib = JAX.Libraries(tmp_path / "jax").create("contract")
    plib = PORT.Libraries(tmp_path / "port").create("contract")
    jloc = JAX.LocationCreateArgs(path=str(loc)).create(jlib)
    ploc = PORT.LocationCreateArgs(path=str(loc)).create(plib)
    return loc, (jlib, jloc["id"]), (plib, ploc["id"])


async def test_cold_chain_matches_jax(tmp_path):
    loc, (jlib, jloc), (plib, ploc) = _libraries(tmp_path)
    try:
        jmeta = await run_chain(JAX, jlib, jloc)
        pmeta = await run_chain(PORT, plib, ploc)
        port, jax = snapshot(plib), snapshot(jlib)
        assert_same(port, jax)
        # the comparison is not vacuous: a real tree, real ids, dedup
        files = [k for k in port["rows"] if not k[3]]
        assert len(files) > 130 and len(port["journal"]) == len(files)
        assert all(len(c) == 16 for k, c in port["cas_id"].items() if c)
        assert port["object_count"] < len([c for c in port["cas_id"].values() if c])
        assert not any(k[1] == ".spacedrive" for k in port["cas_id"])
        docs = next(k for k in port["rows"] if k[:3] == ("/", "docs", ""))
        assert docs[4] == 22
        assert pmeta[1]["total_orphan_paths"] == jmeta[1]["total_orphan_paths"]
        assert pmeta[1]["created_objects"] == jmeta[1]["created_objects"]
        assert pmeta[0]["journal_miss"] == len(files)
    finally:
        jlib.close()
        plib.close()


async def test_rescan_matches_jax_and_reads_only_changed_files(tmp_path, monkeypatch):
    loc, (jlib, jloc), (plib, ploc) = _libraries(tmp_path)
    try:
        await run_chain(JAX, jlib, jloc)
        await run_chain(PORT, plib, ploc)
        mutate_tree(str(loc))
        read = []
        real_read = pcas.read_message

        def recording_read(path, size=None):
            read.append(os.path.relpath(path, loc))
            return real_read(path, size)

        monkeypatch.setattr(pcas, "read_message", recording_read)
        await run_chain(JAX, jlib, jloc)
        pmeta = await run_chain(PORT, plib, ploc)
        assert_same(snapshot(plib), snapshot(jlib))
        # the port's rescan read only the rewritten and the added files
        assert sorted(read) == sorted([
            "big.bin", os.path.join("d1", "f001.txt"), os.path.join("added", "new0.bin"),
            os.path.join("added", "new1.txt"), os.path.join("d2", "new2.dat"),
            os.path.join("d3", "copy_of_a.txt")])
        # rewritten files take the dirty-range rehash; new ones the batch
        assert pmeta[1]["journal_dirty_rehash"] == 2 and pmeta[1]["device_files"] == 4
        for rel in ("big.bin", "d1/f001.txt", "added/new0.bin"):
            name, _, ext = os.path.basename(rel).rpartition(".")
            row = plib.db.find_one("file_path", name=name, extension=ext)
            assert row["cas_id"] == pcas.cas_id_cpu(loc / rel)
        for name, ext in (("b", "txt"), ("f002", "jpg"), ("dup03", "bin")):
            assert plib.db.find_one("file_path", name=name, extension=ext) is None
    finally:
        jlib.close()
        plib.close()


async def test_warm_rescan_hashes_nothing(tmp_path):
    loc, _, (plib, ploc) = _libraries(tmp_path)
    try:
        await run_chain(PORT, plib, ploc)
        before = snapshot(plib)
        meta = await run_chain(PORT, plib, ploc)
        after = snapshot(plib)
        files = [k for k in before["rows"] if not k[3]]
        assert meta[0]["journal_hit"] == len(files) and "journal_miss" not in meta[0]
        assert meta[1]["device_files"] == 0 and meta[1]["journal_dirty_rehash"] == 0
        for k in ("rows", "cas_id", "objects", "journal"):
            assert after[k] == before[k], k
    finally:
        plib.close()


def test_object_pub_for_matches_jax():
    lib_id = uuid.UUID(int=12345)
    for cas_id in ("00" * 8, "0123456789abcdef", "ffffffffffffffff"):
        assert plink.object_pub_for(lib_id, cas_id) == jlink.object_pub_for(lib_id, cas_id)
    assert plink.object_pub_for(lib_id, "aa" * 8) != plink.object_pub_for(uuid.uuid4(), "aa" * 8)


async def test_apply_cas_results_matches_jax(tmp_path):
    """Linking shard results through `apply_cas_results` gives each
    object the deterministic pub_id object_pub_for(lib.id, cas_id), and
    the same links and op counts in both packages; a second apply is a
    no-op."""
    loc, (jlib, jloc), (plib, ploc) = _libraries(tmp_path)
    try:
        for pkg, lib, loc_id in ((JAX, jlib, jloc), (PORT, plib, ploc)):
            mgr = pkg.JobManager(pkg.TaskSystem(1))
            await pkg.JobBuilder(pkg.IndexerJob({"location_id": loc_id})).spawn(mgr, lib)
            await mgr.wait_idle()
            await mgr.system.shutdown()
        files = plib.db.query("SELECT * FROM file_path WHERE is_dir = 0 ORDER BY materialized_path, name")
        cas_of = {(r["materialized_path"], r["name"], r["extension"]):
                  pcas.cas_id_cpu(os.path.join(loc, r["materialized_path"].lstrip("/"),
                                               r["name"] + (f".{r['extension']}" if r["extension"] else "")))
                  if blob_u64(r["size_in_bytes_bytes"]) else None for r in files}
        got = {}
        for link, lib in ((jlink, jlib), (plink, plib)):
            results = [{"pub_id": r["pub_id"].hex(), "ext": r["extension"],
                        "cas_id": cas_of[(r["materialized_path"], r["name"], r["extension"])]}
                       for r in lib.db.query("SELECT * FROM file_path WHERE is_dir = 0")]
            created, linked = link.apply_cas_results(lib, results)
            assert link.apply_cas_results(lib, results) == (0, 0)
            for r in lib.db.query("SELECT fp.cas_id, o.pub_id FROM file_path fp "
                                  "JOIN object o ON o.id = fp.object_id"):
                assert bytes(r["pub_id"]) == link.object_pub_for(lib.id, r["cas_id"])
            snap = snapshot(lib)
            got[link] = (created, linked, snap["objects"], snap["cas_id"], snap["object_kind"],
                         snap["ops"])
        assert got[plink] == got[jlink]
        assert got[plink][0] > 0 and got[plink][1] > got[plink][0]
    finally:
        jlib.close()
        plib.close()


@pytest.mark.parametrize("backend", ["auto", "tpu", "device"])
async def test_identifier_rejects_other_backends(tmp_path, backend):
    """Only "cuda" and "cpu": no backend may pick a device on its own or
    fall back to the host."""
    loc = tmp_path / "loc"
    make_tree(str(loc))
    lib = PORT.Libraries(tmp_path / "data").create("x")
    try:
        loc_id = PORT.LocationCreateArgs(path=str(loc)).create(lib)["id"]
        mgr = PORT.JobManager(PORT.TaskSystem(1))
        job = PORT.FileIdentifierJob({"location_id": loc_id, "backend": backend})
        await PORT.JobBuilder(job).spawn(mgr, lib)
        await mgr.wait_idle()
        await mgr.system.shutdown()
        row = lib.db.find_one("job", id=job.id.bytes)
        assert row["status"] == int(pjobs.JobStatus.FAILED)
        assert "backend must be one of" in row["errors_text"]
    finally:
        lib.close()


def test_cli_library_index_twice(tmp_path, capsys):
    """`index --library` prints the JAX CLI's keys (`labeled` 0: no
    labeler model is provisioned); the second run over the unchanged
    tree hashes and thumbnails nothing."""
    loc = tmp_path / "loc"
    make_tree(str(loc))
    args = ["index", str(loc), "--data-dir", str(tmp_path / "data"), "--library", "L",
            "--device", "cpu"]
    assert cli.main(args) == 0
    first = json.loads(capsys.readouterr().out)
    assert set(first) == {"library", "location_id", "files", "objects", "bytes", "thumbnails",
                          "labeled", "backend", "seconds"}
    assert first["labeled"] == 0
    assert first["library"] == "L" and first["backend"] == "cpu" and first["files"] > 130
    assert first["thumbnails"] == 1  # red.png; the tree's other .jpg/.png are random bytes
    assert cli.main(args) == 0
    second = json.loads(capsys.readouterr().out)
    assert {k: second[k] for k in ("files", "objects", "bytes", "location_id")} == \
        {k: first[k] for k in ("files", "objects", "bytes", "location_id")}
    assert second["thumbnails"] == 0
    (lib,) = PORT.Libraries(tmp_path / "data").load_all()
    try:
        rows = lib.db.query("SELECT name, metadata FROM job WHERE name = 'file_identifier'")
        assert len(rows) == 2
        metas = [msgpack.unpackb(r["metadata"]) for r in rows]
        assert sorted(m["device_files"] for m in metas)[0] == 0
    finally:
        lib.close()
    shutil.rmtree(tmp_path / "data")
