"""The port's fs-ops jobs against the JAX package's: each of
tests/test_fs_ops.py's 12 cases runs on a library of each package over
the same seeded location (indexed first by that package's IndexerJob,
on its own job manager, with no node and so no watcher), and the
outcomes must be equal:

- the job's status and error texts (the tree's root a placeholder);
- the disk after the job: every path, file bytes, link targets;
- the file_path rows (ids, keys, kinds, sizes);
- the CRDT ops the job wrote (model, the row a record id names, kind,
  data bytes): the deleter's and the eraser's `shared_delete` ops;
- for the eraser, the bytes each overwrite pass left in the file before
  it was truncated: the port's job draws them from its explicit
  generator, the JAX job from `os.urandom`, both seeded alike.

Each case also keeps its JAX assertions on the port's outcome.
"""

import asyncio
import os
import types

import numpy as np
import pytest

from spacedrive_tpu.jobs import JobManager as JaxJobManager
from spacedrive_tpu.location.indexer.job import IndexerJob as JaxIndexerJob
from spacedrive_tpu.location.locations import LocationCreateArgs as JaxLocationCreateArgs
from spacedrive_tpu.node import Libraries as JaxLibraries
from spacedrive_tpu.object import fs as jfs
from spacedrive_tpu.object.fs import copy as jcopy, cut as jcut, delete as jdelete
from spacedrive_tpu.object.fs import erase as jerase
from spacedrive_tpu.tasks import TaskSystem as JaxTaskSystem
from spacedrive_tpu_torch.jobs import JobManager
from spacedrive_tpu_torch.location.indexer.job import IndexerJob
from spacedrive_tpu_torch.location.locations import LocationCreateArgs
from spacedrive_tpu_torch.node.library import Libraries
from spacedrive_tpu_torch.object import fs as pfs
from spacedrive_tpu_torch.object.fs import copy as pcopy, cut as pcut, delete as pdelete
from spacedrive_tpu_torch.object.fs import erase as perase
from spacedrive_tpu_torch.tasks import TaskSystem
from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

PKGS = {
    "jax": types.SimpleNamespace(
        JobManager=JaxJobManager, TaskSystem=JaxTaskSystem, IndexerJob=JaxIndexerJob,
        LocationCreateArgs=JaxLocationCreateArgs, Libraries=JaxLibraries,
        copy=jcopy.FileCopierJob, cut=jcut.FileCutterJob, delete=jdelete.FileDeleterJob,
        erase=jerase.FileEraserJob, erase_mod=jerase),
    "port": types.SimpleNamespace(
        JobManager=JobManager, TaskSystem=TaskSystem, IndexerJob=IndexerJob,
        LocationCreateArgs=LocationCreateArgs, Libraries=Libraries,
        copy=pcopy.FileCopierJob, cut=pcut.FileCutterJob, delete=pdelete.FileDeleterJob,
        erase=perase.FileEraserJob, erase_mod=perase),
}
ERASE_SEED = 17


# --- the pure helpers -----------------------------------------------------------


@pytest.mark.parametrize("name,ext,n", [("photo", "jpg", 1), ("photo (3)", "jpg", 4),
                                         ("dir", None, 2), ("a (1) (2)", "tar.gz", 9)])
def test_append_digit(name, ext, n):
    assert pfs.append_digit_to_filename(name, ext, n) == jfs.append_digit_to_filename(name, ext, n)
    assert pfs.append_digit_to_filename("photo", "jpg", 1) == "photo (1).jpg"


def test_find_available(tmp_path):
    p = tmp_path / "x.txt"
    p.write_text("hi")
    for _ in range(3):
        got = pfs.find_available_filename_for_duplicate(str(p))
        assert got == jfs.find_available_filename_for_duplicate(str(p))
        open(got, "w").close()
    assert got == str(tmp_path / "x (3).txt")
    assert pfs.DUPLICATE_PATTERN.pattern == jfs.DUPLICATE_PATTERN.pattern


# --- the jobs --------------------------------------------------------------------


def _tree(root):
    """Every path under `root`: file bytes, "dir", a link's target, or
    "marker" for the location's `.spacedrive` file."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            p = os.path.join(dirpath, name)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                out[rel] = "-> " + os.path.relpath(os.readlink(p), root)
            elif os.path.isdir(p):
                out[rel] = "dir"
            elif name == ".spacedrive":
                out[rel] = "marker"  # random location and library ids
            else:
                out[rel] = open(p, "rb").read()
    return out


def _rows(db):
    return sorted((r["id"], r["materialized_path"], r["name"], r["extension"], r["is_dir"],
                   r["size_in_bytes_bytes"]) for r in db.query("SELECT * FROM file_path"))


class _OsProxy:
    """The erase module's `os`, with `urandom` seeded and each `fsync`
    recording the file's bytes (what one overwrite pass left)."""

    def __init__(self, passes: list):
        self.urandom = np.random.default_rng(ERASE_SEED).bytes
        self._passes = passes

    def fsync(self, fd):
        self._passes.append(os.pread(fd, os.fstat(fd).st_size, 0))
        return os.fsync(fd)

    def __getattr__(self, name):
        return getattr(os, name)


def _op(row, keys):
    """An op row without its random ids and clocks: the model, the row
    its record id names, its kind, and its packed fields but for the
    instance, the timestamp and the op id."""
    fields = unpackb(bytes(row["data"]))
    volatile = {"instance", "timestamp", "id"}
    assert volatile <= set(fields), sorted(fields)
    fields = {k: v for k, v in fields.items() if k not in volatile}
    fields["record_id"] = keys.get(fields["record_id"])
    return row["model"], keys.get(unpackb(bytes(row["record_id"]))), row["kind"], fields


def _setup(case, tmp):
    loc_dir = os.path.join(tmp, "stuff")
    if case == "delete_wildcard_dirname_spares_lookalikes":
        os.makedirs(os.path.join(loc_dir, "50% off"))
        os.makedirs(os.path.join(loc_dir, "5000 off"))
        files = {"50% off/in.txt": b"in", "5000 off/keep.txt": b"keep"}
    else:
        os.makedirs(os.path.join(loc_dir, "sub"))
        files = {"a.txt": b"alpha", "b.txt": b"beta", "sub/c.txt": b"gamma"}
    for rel, data in files.items():
        with open(os.path.join(loc_dir, rel), "wb") as f:
            f.write(data)
    return loc_dir


def _job(pkg, case, loc_id, fp, loc_dir, tmp):
    """The case's job, after any change it makes to the disk first."""
    def copier(ids, target):
        return pkg.copy({"source_location_id": loc_id, "target_location_id": loc_id,
                         "sources_file_path_ids": ids, "target_relative_path": target})

    if case == "copy_file_and_dir":
        return copier([fp("a", "txt"), fp("sub")], "sub")
    if case == "copy_same_place_renames":
        return copier([fp("a", "txt")], "")
    if case == "copy_into_descendant_terminates":
        return copier([fp("sub")], "sub/inner")
    if case == "copy_file_creates_target_dir":
        return copier([fp("a", "txt")], "brand/new")
    if case == "cut_moves_and_skips_overwrite":
        with open(os.path.join(loc_dir, "sub", "b.txt"), "wb") as f:
            f.write(b"existing")
        return pkg.cut({"source_location_id": loc_id, "target_location_id": loc_id,
                        "sources_file_path_ids": [fp("a", "txt"), fp("b", "txt")],
                        "target_relative_path": "sub"})
    if case == "delete_removes_disk_and_rows":
        return pkg.delete({"location_id": loc_id, "file_path_ids": [fp("a", "txt"), fp("sub")]})
    if case == "delete_wildcard_dirname_spares_lookalikes":
        return pkg.delete({"location_id": loc_id, "file_path_ids": [fp("50% off")]})
    if case == "erase_overwrites_and_removes":
        return pkg.erase({"location_id": loc_id, "file_path_ids": [fp("a", "txt"), fp("sub")],
                          "passes": 2})
    if case == "erase_never_follows_symlinks":
        outside = os.path.join(tmp, "outside")
        os.makedirs(outside)
        with open(os.path.join(outside, "precious.txt"), "wb") as f:
            f.write(b"do not touch")
        os.symlink(outside, os.path.join(loc_dir, "sub", "link"))
        return pkg.erase({"location_id": loc_id, "file_path_ids": [fp("sub")], "passes": 1})
    if case == "failed_erase_keeps_db_row":
        os.remove(os.path.join(loc_dir, "a.txt"))
        os.mkdir(os.path.join(loc_dir, "a.txt"))  # exists, but cannot be opened r+b
        return pkg.erase({"location_id": loc_id, "file_path_ids": [fp("a", "txt")], "passes": 1})
    raise AssertionError(case)


async def _run(pkg, case, tmp, monkeypatch):
    loc_dir = _setup(case, tmp)
    library = pkg.Libraries(os.path.join(tmp, "data")).create("fs-ops")
    location = pkg.LocationCreateArgs(path=loc_dir).create(library)
    mgr = pkg.JobManager(pkg.TaskSystem(2))
    try:
        index = pkg.IndexerJob({"location_id": location["id"]})
        await mgr.ingest(index, library)
        assert (await mgr.wait(index.id)).status.name == "COMPLETED"
        db = library.db
        keys = {r["pub_id"].hex(): (r["materialized_path"], r["name"], r["extension"])
                for r in db.query("SELECT * FROM file_path")}
        before = db.query_one("SELECT COALESCE(MAX(rowid), 0) AS n FROM crdt_operation")["n"]

        def fp(name, ext=""):
            row = db.find_one("file_path", name=name, extension=ext)
            assert row is not None, f"no file_path row for {name}"
            return row["id"]

        job = _job(pkg, case, location["id"], fp, loc_dir, tmp)
        passes: list[bytes] = []
        monkeypatch.setattr(pkg.erase_mod, "os", _OsProxy(passes))
        if pkg.erase is perase.FileEraserJob and isinstance(job, perase.FileEraserJob):
            job.random_bytes = np.random.default_rng(ERASE_SEED).bytes
        await mgr.ingest(job, library)
        report = await mgr.wait(job.id)
        ops = [_op(r, keys) for r in db.query(
            "SELECT rowid, * FROM crdt_operation WHERE rowid > ? ORDER BY rowid", (before,))]
        return {"status": report.status.name,
                "errors": [e.replace(tmp, "<tmp>") for e in report.errors_text],
                "disk": _tree(tmp.rstrip("/") + "/stuff"),
                "outside": _tree(os.path.join(tmp, "outside")),
                "rows": _rows(db), "ops": ops, "passes": passes}
    finally:
        await mgr.system.shutdown()
        library.close()


CASES = ["copy_file_and_dir", "copy_same_place_renames", "cut_moves_and_skips_overwrite",
         "delete_removes_disk_and_rows", "erase_overwrites_and_removes",
         "copy_into_descendant_terminates", "copy_file_creates_target_dir",
         "delete_wildcard_dirname_spares_lookalikes", "erase_never_follows_symlinks",
         "failed_erase_keeps_db_row"]


def _check_jax_assertions(case, got):
    """tests/test_fs_ops.py's own assertions, on the port's outcome."""
    disk, names = got["disk"], {(r[2], r[3]) for r in got["rows"]}
    if case == "copy_file_and_dir":
        assert got["status"] == "COMPLETED"
        assert disk["sub/a.txt"] == b"alpha" and disk["sub/sub/c.txt"] == b"gamma"
        assert "sub/sub/sub" not in disk
    elif case == "copy_same_place_renames":
        assert disk["a (1).txt"] == b"alpha"
    elif case == "cut_moves_and_skips_overwrite":
        assert got["status"] == "COMPLETED_WITH_ERRORS"
        assert disk["sub/a.txt"] == b"alpha" and "a.txt" not in disk
        assert disk["b.txt"] == b"beta" and disk["sub/b.txt"] == b"existing"
    elif case == "delete_removes_disk_and_rows":
        assert got["status"] == "COMPLETED"
        assert "a.txt" not in disk and "sub" not in disk
        assert ("a", "txt") not in names and ("sub", "") not in names and ("c", "txt") not in names
        assert sum(op[2] == "d" for op in got["ops"]) >= 3
    elif case == "erase_overwrites_and_removes":
        assert got["status"] == "COMPLETED"
        assert "a.txt" not in disk and "sub" not in disk and ("c", "txt") not in names
        assert len(got["passes"]) == 2 * 2  # a.txt and sub/c.txt, two passes each
        assert got["passes"][0] != b"alpha" and len(got["passes"][0]) == len(b"alpha")
    elif case == "copy_into_descendant_terminates":
        assert disk["sub/inner/sub/c.txt"] == b"gamma"
        assert "sub/inner/sub/inner/sub" not in disk
    elif case == "copy_file_creates_target_dir":
        assert disk["brand/new/a.txt"] == b"alpha"
    elif case == "delete_wildcard_dirname_spares_lookalikes":
        assert ("keep", "txt") in names and disk["5000 off/keep.txt"] == b"keep"
        assert ("in", "txt") not in names
    elif case == "erase_never_follows_symlinks":
        assert got["status"] == "COMPLETED"
        assert got["outside"]["precious.txt"] == b"do not touch" and "sub" not in disk
    elif case == "failed_erase_keeps_db_row":
        assert got["status"] == "COMPLETED_WITH_ERRORS"
        assert disk["a.txt"] == "dir" and ("a", "txt") in names


@pytest.mark.parametrize("case", CASES)
def test_job_matches_jax(case, tmp_path, monkeypatch):
    got = {}
    for name, pkg in PKGS.items():
        tmp = str(tmp_path / name)
        os.makedirs(tmp)
        got[name] = asyncio.run(asyncio.wait_for(_run(pkg, case, tmp, monkeypatch), 60))
        monkeypatch.undo()
    assert got["port"] == got["jax"]
    _check_jax_assertions(case, got["port"])
