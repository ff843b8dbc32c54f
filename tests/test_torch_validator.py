"""The port's object validator against the JAX package's.

- `file_checksums` bit-identical to the JAX package's (its host leg: the
  JAX device leg compiles a program per bucket on the CPU, which only
  its slow tier runs) and to `blake3_ref` at 0, 1, 1023, 1024, 1025,
  2048 bytes, 64 KiB, 256 KiB, 256 KiB + 1 and 1 MiB + 3, with every
  device bucket of those sizes forced onto the batched leg (at least
  _MIN_DEVICE_BATCH files each), and an unreadable path giving "";
- the owned C hasher equal to `blake3_ref.StreamingBlake3` over any
  split of the input;
- tests/test_validator.py's checksum and job cases on the port;
- after both packages' `scan_location` over one seeded tree,
  ObjectValidatorJob writes the same `integrity_checksum` rows, the
  same CRDT op counts and the same run metadata as the JAX job.
"""

import asyncio
import os
import types

import numpy as np
import pytest

import spacedrive_tpu.jobs as jjobs
import spacedrive_tpu.location.locations as jlocations
import spacedrive_tpu.node.library as jlibrary
import spacedrive_tpu.tasks as jtasks
import spacedrive_tpu_torch.jobs as pjobs
import spacedrive_tpu_torch.location.locations as plocations
import spacedrive_tpu_torch.node.library as plibrary
import spacedrive_tpu_torch.tasks as ptasks
from spacedrive_tpu.object.validation import file_checksums as jax_file_checksums
from spacedrive_tpu.object.validation.job import ObjectValidatorJob as JaxValidatorJob
from spacedrive_tpu_torch.location.indexer.job import IndexerJob
from spacedrive_tpu_torch.object.validation import file_checksum, file_checksums
from spacedrive_tpu_torch.object.validation import hash as phash_mod
from spacedrive_tpu_torch.object.validation.job import ObjectValidatorJob
from spacedrive_tpu_torch.ops import blake3_host
from spacedrive_tpu_torch.ops.blake3_ref import StreamingBlake3, blake3_hex
from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

KIB = 1024
SIZES = [0, 1, 1023, 1024, 1025, 2048, 64 * KIB, 256 * KIB, 256 * KIB + 1, 1024 * KIB + 3]


def _write(path, data):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def test_host_hasher_equals_streaming_reference():
    rng = np.random.default_rng(0)
    for size in (0, 1, 63, 64, 65, 1023, 1024, 1025, 2049, 4096 * 3 + 5, 70_001):
        data = rng.bytes(size)
        want = StreamingBlake3().update(data).digest(64)
        for pieces in (1, 3, 17):
            h = blake3_host.StreamingHasher()
            cuts = sorted(int(c) for c in rng.integers(0, size + 1, pieces - 1))
            for a, b in zip([0] + cuts, cuts + [size]):
                h.update(data[a:b])
            assert h.digest(64) == want, (size, pieces)
            assert h.digest(32) == want[:32]


def test_file_checksum_matches_reference_impl(tmp_path):
    rng = np.random.default_rng(3)
    for size in (0, 1, 1024, 70_000, 3 * 1024 * 1024 + 17):
        p = tmp_path / f"f{size}"
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        p.write_bytes(data)
        want = blake3_hex(data, 32) if size < 200_000 else \
            blake3_host.StreamingHasher().update(data).hexdigest(32)
        assert file_checksum(p) == want, size


def test_file_checksums_bit_identical_at_every_size(tmp_path):
    """SIZES, each device-bucket size written _MIN_DEVICE_BATCH times
    (so the batched leg runs; the copies differ in their first bytes),
    a few files in buckets too small to batch, an unreadable path."""
    rng = np.random.default_rng(11)
    paths, first_of_size = [], {}
    for size in SIZES:
        copies = phash_mod._MIN_DEVICE_BATCH if 0 < size <= phash_mod.DEVICE_MAX_BYTES else 1
        base = rng.bytes(size)
        for j in range(copies):
            p = str(tmp_path / f"s{size}" / f"c{j}.bin")
            _write(p, bytes([j]) + base[1:] if size else b"")
            first_of_size.setdefault(size, len(paths))
            paths.append(p)
    for size in (5000, 20 * KIB):  # alone in their buckets (8, 32): the host leg
        paths.append(str(tmp_path / f"lone{size}.bin"))
        _write(paths[-1], rng.bytes(size))
    paths.append(str(tmp_path / "missing.bin"))

    file_checksums.device_files.clear()
    file_checksums.host_files = 0
    got = file_checksums(paths, "cpu")
    assert got == jax_file_checksums(paths, backend="cpu")
    assert got[-1] == "" and all(got[:-1])
    # bucket (chunks) -> files: the power-of-two buckets of SIZES
    assert dict(file_checksums.device_files) == {1: 48, 2: 32, 64: 16, 256: 16}
    assert file_checksums.host_files == 5  # 0, 256 KiB + 1, 1 MiB + 3, the two lone files
    for size, i in first_of_size.items():
        with open(paths[i], "rb") as f:
            assert got[i] == blake3_hex(f.read(), 32), size


def test_file_checksums_at_every_bucket_boundary(tmp_path):
    """Every power-of-two bucket boundary through the batched leg
    (k·1024, k·1024 + 1 and 2k·1024 bytes for k = 1..128, so buckets of
    1 to 256 chunks, full and one byte into the next): the digest of
    each equals the host hasher's."""
    rng = np.random.default_rng(5)
    paths = []
    for k in (1, 2, 4, 8, 16, 32, 64, 128):
        for n in [k * KIB] * 8 + [k * KIB + 1] * 8 + [2 * k * KIB] * 8:
            paths.append(str(tmp_path / f"k{k}" / f"{len(paths)}.bin"))
            _write(paths[-1], rng.bytes(n))
    got = file_checksums(paths, "cpu")
    assert got == [file_checksum(p) for p in paths]


def test_checksum_device_must_be_cuda_or_cpu(tmp_path):
    p = tmp_path / "a.bin"
    p.write_bytes(b"x" * 100)
    with pytest.raises(RuntimeError):
        file_checksums([str(p)] * 16, "tpu")


# --- the job ------------------------------------------------------------------


async def test_validator_job(tmp_path):
    """tests/test_validator.py's job case on the port."""
    loc_dir = tmp_path / "stuff"
    loc_dir.mkdir()
    rng = np.random.default_rng(5)
    contents = {}
    for name in ("x.bin", "y.bin", "z.bin"):
        data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        (loc_dir / name).write_bytes(data)
        contents[name] = data

    library = plibrary.Libraries(tmp_path / "data").create("validate")
    mgr = pjobs.JobManager(ptasks.TaskSystem(2))
    try:
        location = plocations.LocationCreateArgs(path=str(loc_dir)).create(library)
        job = IndexerJob({"location_id": location["id"]})
        await mgr.ingest(job, library)
        await mgr.wait(job.id)

        vjob = ObjectValidatorJob({"location_id": location["id"], "backend": "cpu"})
        await mgr.ingest(vjob, library)
        report = await mgr.wait(vjob.id)
        assert report.status == pjobs.JobStatus.COMPLETED
        assert report.metadata["validated"] == 3
        for name, data in contents.items():
            row = library.db.find_one("file_path", name=name.rsplit(".", 1)[0], extension="bin")
            assert row["integrity_checksum"] == blake3_hex(data, 32)
        ops = library.db.query("SELECT * FROM crdt_operation WHERE kind = 'u:integrity_checksum'")
        assert len(ops) == 3
    finally:
        await mgr.system.shutdown()
        library.close()


def _tree(root):
    """Files over every device bucket (a few of them in batches of
    _MIN_DEVICE_BATCH or more), large files for the host leg, empty
    files, a subdirectory for the sub_path case."""
    rng = np.random.default_rng(21)
    sizes = [0, 0, 1, 300 * KIB, 1024 * KIB + 3] + [int(s) for s in rng.integers(1, 3000, 40)]
    sizes += [int(s) for s in rng.integers(100 * KIB, 256 * KIB, 20)]
    for i, size in enumerate(sizes):
        _write(os.path.join(root, f"d{i % 3}", f"f{i:03d}.bin"), rng.bytes(size))
    with open(os.path.join(root, "d1", "f004.bin"), "rb") as f:
        _write(os.path.join(root, "d0", "copy.bin"), f.read())


JAX = types.SimpleNamespace(
    JobManager=jjobs.JobManager, JobBuilder=jjobs.JobBuilder, TaskSystem=jtasks.TaskSystem,
    Libraries=jlibrary.Libraries, LocationCreateArgs=jlocations.LocationCreateArgs,
    scan_location=jlocations.scan_location, ValidatorJob=JaxValidatorJob,
)
PORT = types.SimpleNamespace(
    JobManager=pjobs.JobManager, JobBuilder=pjobs.JobBuilder, TaskSystem=ptasks.TaskSystem,
    Libraries=plibrary.Libraries, LocationCreateArgs=plocations.LocationCreateArgs,
    scan_location=plocations.scan_location, ValidatorJob=ObjectValidatorJob,
)


async def _validate(pkg, data_dir, loc):
    lib = pkg.Libraries(data_dir).create("v")
    mgr = pkg.JobManager(pkg.TaskSystem(2))
    try:
        loc_row = pkg.LocationCreateArgs(path=str(loc)).create(lib)
        await pkg.scan_location(lib, loc_row, mgr, backend="cpu")
        await mgr.wait_idle()
        metas = []
        for init in ({"sub_path": "d1"}, {}):
            job = pkg.ValidatorJob({"location_id": loc_row["id"], "backend": "cpu", **init})
            await pkg.JobBuilder(job).spawn(mgr, lib)
            await mgr.wait_idle()
            row = lib.db.find_one("job", id=job.id.bytes)
            assert row["status"] == 2, row
            metas.append(unpackb(row["metadata"]))
        sums = {(r["materialized_path"], r["name"], r["extension"]): r["integrity_checksum"]
                for r in lib.db.query("SELECT * FROM file_path WHERE is_dir = 0")}
        ops = {(r["model"], r["kind"]): r["n"] for r in lib.db.query(
            "SELECT model, kind, COUNT(*) AS n FROM crdt_operation GROUP BY model, kind")}
        return sums, ops, metas
    finally:
        await mgr.system.shutdown()
        lib.close()


async def test_validator_job_matches_jax(tmp_path):
    loc = tmp_path / "loc"
    _tree(str(loc))
    psums, pops, pmetas = await _validate(PORT, tmp_path / "port", loc)
    jsums, jops, jmetas = await _validate(JAX, tmp_path / "jax", loc)
    assert psums == jsums and pops == jops and pmetas == jmetas
    n = len(psums)
    assert all(psums.values()) and pops[("file_path", "u:integrity_checksum")] == n
    assert pmetas[0]["validated"] + pmetas[1]["validated"] == n
    for (mat, name, ext), digest in list(psums.items())[:8]:
        with open(os.path.join(loc, mat.strip("/"), f"{name}.{ext}"), "rb") as f:
            assert digest == blake3_hex(f.read(), 32)


def test_a_failed_host_hasher_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(blake3_host, "_SRC", str(bad))
    with pytest.raises(blake3_host.NativeBuildError, match="not C|error"):
        blake3_host._compile(str(tmp_path / "out.so"))
    monkeypatch.setattr(blake3_host, "COMPILERS", ("no-such-cc",))
    with pytest.raises(blake3_host.NativeBuildError, match="no C compiler"):
        blake3_host._compile(str(tmp_path / "out.so"))


def test_job_refuses_other_backends(tmp_path):
    async def run():
        lib = plibrary.Libraries(tmp_path / "data").create("x")
        mgr = pjobs.JobManager(ptasks.TaskSystem(1))
        try:
            (tmp_path / "loc").mkdir()
            loc_id = plocations.LocationCreateArgs(path=str(tmp_path / "loc")).create(lib)["id"]
            job = ObjectValidatorJob({"location_id": loc_id, "backend": "auto"})
            await pjobs.JobBuilder(job).spawn(mgr, lib)
            await mgr.wait_idle()
            row = lib.db.find_one("job", id=job.id.bytes)
            assert row["status"] == int(pjobs.JobStatus.FAILED)
            assert "backend must be one of" in row["errors_text"]
        finally:
            await mgr.system.shutdown()
            lib.close()

    asyncio.run(run())
