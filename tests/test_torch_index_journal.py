"""Incremental indexing on the port: index journal + dirty-range rehash.

The JAX package's tests/test_index_journal.py, pointed at the port
package, for the surface this slice ports: the dirty-range rehash, the
chunk-cache validation, the warm / mutated / re-mutated scan chain, the
metadata-only update, the corrupt-journal degrade and the journal's unit
surface. Where the JAX tests read telemetry counters, these read the
jobs' run metadata (the walk's `journal_*` verdict counts, the
identifier's `device_files` and `journal_dirty_rehash`), and the chain
is IndexerJob → FileIdentifierJob (no media job yet).
"""

import os

import numpy as np
import pytest

from spacedrive_tpu_torch.jobs import JobManager
from spacedrive_tpu_torch.location.indexer.journal import Identity, IndexJournal, JournalEntry
from spacedrive_tpu_torch.location.locations import LocationCreateArgs, scan_location
from spacedrive_tpu_torch.node.library import Libraries
from spacedrive_tpu_torch.ops import blake3_ref, cas
from spacedrive_tpu_torch.ops.cas import cas_id_cpu
from spacedrive_tpu_torch.tasks import TaskSystem
from spacedrive_tpu_torch.utils.msgpack_codec import unpackb


def _cas_of_bytes(content: bytes) -> str:
    return blake3_ref.blake3_hex(cas.message_from_bytes(content))[:16]


# --- dirty-range rehash (ops/cas.py) ---------------------------------------


def test_dirty_range_bit_identical_golden():
    """Mutations in and out of sampled ranges, repeated passes, small
    and large files: the dirty-range cas_id always equals the full
    rehash."""
    import random

    rng = random.Random(5)
    for size in (300_000, 150_000, 40_000, 2_000):
        data = bytearray(os.urandom(size))
        msg = cas.message_from_bytes(bytes(data), size)
        cache = cas.build_chunk_cache(msg)
        for _ in range(3):
            off = rng.randrange(0, size)
            data[off] = (data[off] + 1) % 256
            msg = cas.message_from_bytes(bytes(data), size)
            got, cache, _dirty, _hashed = cas.dirty_range_rehash(msg, cache)
            assert got == _cas_of_bytes(bytes(data))


def test_dirty_range_work_proportional_to_change():
    """Steady state (CV tree cached): one mutated byte rehashes exactly
    one 1 KiB chunk of the 57,352-byte large-file message."""
    data = bytearray(os.urandom(300_000))
    msg = cas.message_from_bytes(bytes(data), len(data))
    cas_id, cache = cas.host_rehash_with_cache(msg)
    assert cas_id == _cas_of_bytes(bytes(data))
    data[100] ^= 1  # inside the 8 KiB header sample
    msg = cas.message_from_bytes(bytes(data), len(data))
    got, cache, dirty, hashed = cas.dirty_range_rehash(msg, cache)
    assert got == _cas_of_bytes(bytes(data))
    assert dirty == 1 and hashed == 1024

    # a mutation OUTSIDE every sampled range: zero dirty chunks, cas
    # unchanged (content-invisible to the sampling layout)
    data2 = bytearray(data)
    data2[20_000] ^= 1
    assert not any(o <= 20_000 < o + ln for o, ln in cas.sample_ranges(len(data2)))
    msg2 = cas.message_from_bytes(bytes(data2), len(data2))
    got2, _c, dirty2, hashed2 = cas.dirty_range_rehash(msg2, cache)
    assert got2 == got and dirty2 == 0 and hashed2 == 0


def test_dirty_range_refuses_message_length_change():
    # small file: message = header + whole file, so growing the file
    # changes the message length → dirty-range must refuse
    data = os.urandom(40_000)
    msg = cas.message_from_bytes(data, len(data))
    _, cache = cas.host_rehash_with_cache(msg)
    grown = data + b"x"
    with pytest.raises(ValueError):
        cas.dirty_range_rehash(cas.message_from_bytes(grown, len(grown)), cache)


def test_dirty_range_handles_large_file_size_change():
    # large files keep the FIXED 57,352-byte message across size
    # changes, so dirty-range stays bit-identical even then
    data = os.urandom(200_000)
    msg = cas.message_from_bytes(data, len(data))
    _, cache = cas.host_rehash_with_cache(msg)
    grown = data + os.urandom(1000)
    got, _c, dirty, _h = cas.dirty_range_rehash(cas.message_from_bytes(grown, len(grown)), cache)
    assert got == _cas_of_bytes(grown)
    assert dirty >= 1  # at minimum the size-header chunk changed


def test_chunk_cache_payload_validation():
    """from_payload rejects every malformed shape (torn journal blobs
    must degrade to a cold pass, not a wrong cas)."""
    msg = cas.message_from_bytes(os.urandom(150_000), 150_000)
    _, cache = cas.host_rehash_with_cache(msg)
    good = cache.to_payload()
    assert cas.ChunkCache.from_payload(good) is not None
    bad = [
        None, [], "x", {},
        {**good, "len": -1},
        {**good, "dig": good["dig"][:-1]},               # truncated
        {**good, "dig": [b"short"] * len(good["dig"])},  # wrong width
        {**good, "cvs": [[b"x" * 31] * 2]},              # torn CV
        {**good, "cvs": []},
    ]
    for payload in bad:
        assert cas.ChunkCache.from_payload(payload) is None


# --- scan-chain harness ----------------------------------------------------


def _build_tree(loc):
    rng = np.random.default_rng(9)
    (loc / "docs").mkdir(parents=True)
    (loc / "docs" / "a.txt").write_bytes(b"hello journal")
    (loc / "big.bin").write_bytes(rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes())
    (loc / "small.bin").write_bytes(rng.integers(0, 256, 9_000, dtype=np.uint8).tobytes())
    (loc / "empty.txt").write_bytes(b"")
    from PIL import Image

    Image.new("RGB", (32, 24), (10, 200, 10)).save(loc / "green.png")


async def _scan(library, location, mgr):
    """One IndexerJob → FileIdentifierJob → MediaProcessorJob chain on
    the CPU; returns the indexer's and the identifier's run metadata."""
    job_id = await scan_location(library, location, mgr, backend="cpu")
    await mgr.wait(job_id)
    await mgr.wait_idle()
    rows = library.db.query(
        "SELECT name, status, metadata FROM job ORDER BY date_created DESC, rowid DESC LIMIT 3")
    assert [r["name"] for r in rows] == ["media_processor", "file_identifier", "indexer"]
    assert all(r["status"] == 2 for r in rows)
    return [unpackb(r["metadata"]) for r in rows[:0:-1]]


def _mk_library(tmp_path, name="jlib"):
    return Libraries(tmp_path / "data").create(name)


async def test_warm_pass_reads_nothing_and_rehashes_only_changes(tmp_path, monkeypatch):
    loc_path = tmp_path / "stuff"
    _build_tree(loc_path)
    library = _mk_library(tmp_path)
    mgr = JobManager(TaskSystem(2))
    location = LocationCreateArgs(path=str(loc_path)).create(library)

    reads: list[str] = []
    real_read = cas.read_message

    def counting_read(path, size=None):
        reads.append(os.fspath(path))
        return real_read(path, size)

    monkeypatch.setattr(cas, "read_message", counting_read)

    await _scan(library, location, mgr)
    assert len(reads) >= 3  # every non-empty file was read once
    assert library.db.count("index_journal") >= 5

    # ---- warm pass, nothing changed: ZERO message reads ----
    reads.clear()
    indexer, ident = await _scan(library, location, mgr)
    assert reads == []
    assert indexer["journal_hit"] == 5 and ident["device_files"] == 0

    # ---- mutate the large file in place: only IT is re-read, its new
    # cas is bit-identical to a full rehash, and the object re-links ----
    big = loc_path / "big.bin"
    old_row = library.db.find_one("file_path", name="big", extension="bin")
    with open(big, "r+b") as f:
        f.seek(100)
        f.write(b"MUTATED")
    st = os.stat(big)
    os.utime(big, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    reads.clear()
    _, ident = await _scan(library, location, mgr)
    assert [os.path.basename(p) for p in reads] == ["big.bin"]
    assert ident["journal_dirty_rehash"] == 1 and ident["device_files"] == 0
    row = library.db.find_one("file_path", name="big", extension="bin")
    assert row["cas_id"] == cas_id_cpu(big)
    assert row["cas_id"] != old_row["cas_id"]
    assert row["object_id"] is not None
    assert row["object_id"] != old_row["object_id"]

    # ---- third pass after another in-place mutation: the dirty-range
    # path again, never the device batch ----
    with open(big, "r+b") as f:
        f.seek(50)
        f.write(b"AGAIN")
    st = os.stat(big)
    os.utime(big, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    _, ident = await _scan(library, location, mgr)
    assert ident["journal_dirty_rehash"] == 1 and ident["device_files"] == 0
    row = library.db.find_one("file_path", name="big", extension="bin")
    assert row["cas_id"] == cas_id_cpu(big)

    await mgr.system.shutdown()
    library.close()


async def test_hidden_flag_change_keeps_cas(tmp_path):
    """A metadata-only change (walker update with unchanged identity)
    must NOT clear the cas: the journal hit proves the content is
    untouched."""
    loc_path = tmp_path / "stuff"
    loc_path.mkdir()
    (loc_path / "keep.bin").write_bytes(os.urandom(5000))
    library = _mk_library(tmp_path)
    mgr = JobManager(TaskSystem(2))
    location = LocationCreateArgs(path=str(loc_path)).create(library)
    await _scan(library, location, mgr)
    row = library.db.find_one("file_path", name="keep", extension="bin")
    assert row["cas_id"] is not None

    # force the row into to_update WITHOUT touching the file: flip the
    # DB's hidden flag so the walker sees a difference
    library.db.update("file_path", {"id": row["id"]}, hidden=1)
    indexer, _ = await _scan(library, location, mgr)
    assert indexer["updated_paths"] == 1
    after = library.db.find_one("file_path", name="keep", extension="bin")
    assert after["cas_id"] == row["cas_id"]  # journal hit → cas kept
    assert after["hidden"] == 0
    await mgr.system.shutdown()
    library.close()


async def test_corrupt_journal_degrades_to_cold_pass(tmp_path):
    """Torn/corrupt journal rows (garbage payload) read as `bypassed`,
    are dropped, and the pass produces correct cas_ids the cold way."""
    loc_path = tmp_path / "stuff"
    _build_tree(loc_path)
    library = _mk_library(tmp_path)
    mgr = JobManager(TaskSystem(2))
    location = LocationCreateArgs(path=str(loc_path)).create(library)
    await _scan(library, location, mgr)
    assert library.db.count("index_journal") >= 4

    # tear every payload + identity blob (simulated torn/corrupt file)
    library.db.execute("UPDATE index_journal SET payload = X'DEADBEEF', inode = X'00'")
    indexer, _ = await _scan(library, location, mgr)
    assert indexer["journal_bypassed"] == 5
    for name, ext, p in (
        ("big", "bin", loc_path / "big.bin"),
        ("small", "bin", loc_path / "small.bin"),
        ("a", "txt", loc_path / "docs" / "a.txt"),
    ):
        row = library.db.find_one("file_path", name=name, extension=ext)
        assert row["cas_id"] == cas_id_cpu(p)  # never wrong, never stale
    # corrupt rows were dropped; the empty file is re-journaled fresh
    rows = library.db.query("SELECT payload FROM index_journal")
    assert rows and all(r["payload"] != b"\xde\xad\xbe\xef" for r in rows)
    await mgr.system.shutdown()
    library.close()


# --- journal unit surface --------------------------------------------------


def _memory_journal(tmp_path):
    lib = _mk_library(tmp_path)
    return lib, IndexJournal(lib.db)


def test_journal_lookup_verdicts_and_stale(tmp_path):
    lib, journal = _memory_journal(tmp_path)
    loc_id = lib.db.insert("location", pub_id=os.urandom(16), name="l", path="/tmp/x")
    key = ("/", "f", "bin")
    ident = Identity(1, 2, 3, 4)
    assert journal.lookup(loc_id, key, ident)[0] == "miss"
    journal.record_many(loc_id, [(key, ident, "cafe" * 4, None, None)])
    verdict, entry = journal.lookup(loc_id, key, ident)
    assert verdict == "hit" and entry.cas_id == "cafe" * 4
    # identity drift → invalidated (entry still returned)
    verdict, entry = journal.lookup(loc_id, key, Identity(1, 2, 99, 4))
    assert verdict == "invalidated" and entry is not None
    # targeted invalidation → stale even with a matching identity
    assert journal.mark_stale(loc_id, key) == 1
    verdict, _ = journal.lookup(loc_id, key, ident)
    assert verdict == "invalidated"
    # a fresh record clears the stale bit
    journal.record_many(loc_id, [(key, ident, "beef" * 4, None, None)])
    assert journal.lookup(loc_id, key, ident)[0] == "hit"
    lib.close()


def test_record_many_carries_vouches_for_unchanged_cas(tmp_path):
    """An mtime-only touch re-records the SAME cas: thumb/media/phash
    vouches must carry forward, while a content change (different cas)
    must void them."""
    lib, journal = _memory_journal(tmp_path)
    loc_id = lib.db.insert("location", pub_id=os.urandom(16), name="l", path="/tmp/x")
    key = ("/", "f", "jpg")
    ident = Identity(1, 1, 100, 4)
    vouched = JournalEntry(ident, False, "aa" * 8, thumb=True, media_digest="digest1",
                           phash=b"\x01" * 8)
    journal.record_many(loc_id, [(key, ident, "aa" * 8, None, vouched)])
    _, entry = journal.lookup(loc_id, key, ident)
    assert entry.thumb and entry.media_digest == "digest1"

    touched = Identity(1, 1, 200, 4)  # mtime moved, content didn't
    journal.record_many(loc_id, [(key, touched, "aa" * 8, None, entry)])
    verdict, e2 = journal.lookup(loc_id, key, touched)
    assert verdict == "hit"
    assert e2.thumb and e2.media_digest == "digest1" and e2.phash == b"\x01" * 8

    changed = Identity(1, 1, 300, 4)
    journal.record_many(loc_id, [(key, changed, "bb" * 8, None, e2)])
    _, e3 = journal.lookup(loc_id, key, changed)
    assert not e3.thumb and e3.media_digest is None and e3.phash is None
    lib.close()


def test_journal_disabled_bypasses(tmp_path, monkeypatch):
    monkeypatch.setenv("SD_INDEX_JOURNAL", "0")
    lib, journal = _memory_journal(tmp_path)
    loc_id = lib.db.insert("location", pub_id=os.urandom(16), name="l", path="/tmp/x")
    key = ("/", "f", "bin")
    ident = Identity(1, 1, 1, 1)
    journal.record_many(loc_id, [(key, ident, "11" * 8, None, None)])  # no-op
    assert journal.lookup(loc_id, key, ident)[0] == "bypassed"
    assert lib.db.count("index_journal") == 0
    lib.close()
