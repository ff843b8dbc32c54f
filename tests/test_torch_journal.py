"""The port's index journal against the JAX package's.

One scripted sequence (record, lookup, touch, re-record with carried
vouches, stale, corrupt row, identity-less lookup, journal disabled)
runs on a library DB of each package over the same files; the verdicts
(`hit` / `miss` / `invalidated` / `bypassed`) and every stored payload
must be identical, byte for byte. The dirty-range rehash the journal's
chunk cache feeds is held against the JAX package's too.
"""

import os

import numpy as np
import pytest

from spacedrive_tpu.db.database import LibraryDb as JaxDb
from spacedrive_tpu.location.indexer import journal as jjournal
from spacedrive_tpu.ops import cas as jcas
from spacedrive_tpu_torch.db.database import LibraryDb
from spacedrive_tpu_torch.location.indexer import journal
from spacedrive_tpu_torch.ops import blake3_ref, cas

FILES = {"big.bin": 300_000, "small.txt": 5000, "empty.dat": 0}


def _key(name):
    stem, _, ext = name.rpartition(".")
    return ("/", stem, ext)


def _payloads(db):
    return {(r["materialized_path"], r["name"], r["extension"]):
            (r["cas_id"], bytes(r["payload"]), r["stale"], r["inode"], r["mtime_ns"])
            for r in db.query("SELECT * FROM index_journal")}


def _script(mod, cas_mod, db, root, monkeypatch):
    """The sequence; returns (verdicts, payload snapshots)."""
    db.execute("INSERT INTO location (id, pub_id, path) VALUES (1, ?, ?)", (b"\x01" * 16, root))
    j = mod.IndexJournal(db)
    ident = {n: mod.stat_identity(os.path.join(root, n)) for n in FILES}
    msgs = {n: cas_mod.read_message(os.path.join(root, n)) for n in FILES}
    verdicts, snaps = [], []

    def look(name, identity="current"):
        identity = mod.stat_identity(os.path.join(root, name)) if identity == "current" else identity
        verdict, entry = j.lookup(1, _key(name), identity)
        verdicts.append((name, verdict, None if entry is None else entry.cas_id))
        return entry

    for n in FILES:
        look(n)  # all miss
    cas_big, cache_big = cas_mod.host_rehash_with_cache(msgs["big.bin"])
    j.record_many(1, [
        (_key("big.bin"), ident["big.bin"], cas_big, cache_big, None),
        (_key("small.txt"), ident["small.txt"], "0123456789abcdef",
         cas_mod.build_chunk_cache(msgs["small.txt"]), None),
        (_key("empty.dat"), ident["empty.dat"], "", None, None),
    ])
    snaps.append(_payloads(db))
    for n in FILES:
        look(n)  # all hit
    # touch: same bytes, new mtime → invalidated, chunk cache still there
    path = os.path.join(root, "small.txt")
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    prior = look("small.txt")
    assert prior.chunks is not None and prior.chunks.levels is None
    # re-record with the prior entry carrying thumb/media/phash/embed
    # vouches: kept when the cas is unchanged, dropped when it changed
    carry = mod.JournalEntry(prior.identity, False, "0123456789abcdef", thumb=True,
                             media_digest="m", phash=b"\x00" * 8, embed=True)
    j.record_many(1, [(_key("small.txt"), mod.stat_identity(path), "0123456789abcdef",
                       prior.chunks, carry)])
    snaps.append(_payloads(db))
    j.record_many(1, [(_key("small.txt"), mod.stat_identity(path), "fedcba9876543210",
                       prior.chunks, carry)])
    snaps.append(_payloads(db))
    look("small.txt")
    # stale: a matching identity no longer vouches
    assert j.mark_stale(1, _key("big.bin")) == 1
    look("big.bin")
    look("big.bin", identity=None)
    snaps.append(_payloads(db))
    # corrupt payload: bypassed once, the row is dropped, then a miss
    db.execute("UPDATE index_journal SET payload = ? WHERE name = 'empty'", (b"\xc1",))
    look("empty.dat")
    look("empty.dat")
    # disabled journal: every consult is bypassed, nothing is written
    monkeypatch.setenv("SD_INDEX_JOURNAL", "0")
    look("big.bin")
    j.record_many(1, [(_key("empty.dat"), ident["empty.dat"], "", None, None)])
    monkeypatch.delenv("SD_INDEX_JOURNAL")
    look("empty.dat")
    snaps.append(_payloads(db))
    return verdicts, snaps


@pytest.fixture()
def files(tmp_path):
    rng = np.random.default_rng(5)
    root = tmp_path / "loc"
    root.mkdir()
    for name, size in FILES.items():
        (root / name).write_bytes(rng.bytes(size))
    return str(root)


def test_scripted_sequence_matches_jax(files, tmp_path, monkeypatch):
    port_db, jax_db = LibraryDb(tmp_path / "p.db"), JaxDb(tmp_path / "j.db")
    try:
        port = _script(journal, cas, port_db, files, monkeypatch)
        # the JAX run sees the same touched file: restore its mtime first
        path = os.path.join(files, "small.txt")
        st = os.stat(path)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns - 1_000_000_000))
        jax = _script(jjournal, jcas, jax_db, files, monkeypatch)
    finally:
        port_db.close()
        jax_db.close()
    assert port == jax
    verdicts = [v for _, v, _ in port[0]]
    assert verdicts[:6] == ["miss"] * 3 + ["hit"] * 3
    assert {"hit", "miss", "invalidated", "bypassed"} <= set(verdicts)
    assert verdicts[-4:-1] == ["bypassed", "miss", "bypassed"]


def test_key_of_and_identity_match_jax(files):
    from spacedrive_tpu.files.isolated_path import IsolatedFilePathData as JaxIso
    from spacedrive_tpu_torch.files.isolated_path import IsolatedFilePathData

    for name in FILES:
        full = os.path.join(files, name)
        assert journal.key_of(IsolatedFilePathData.new(1, files, full, False)) == \
            jjournal.key_of(JaxIso.new(1, files, full, False))
        assert tuple(vars(journal.stat_identity(full)).values()) == \
            tuple(vars(jjournal.stat_identity(full)).values())
    row = {"materialized_path": "/a/", "name": "x", "extension": None}
    assert journal.key_of(row) == jjournal.key_of(row) == ("/a/", "x", "")
    assert journal.stat_identity(os.path.join(files, "missing")) is None


@pytest.mark.parametrize("size", [2000, 102401, 300_000])
def test_dirty_range_rehash_matches_jax(size):
    rng = np.random.default_rng(size)
    data = bytearray(rng.bytes(size))
    msg = cas.message_from_bytes(bytes(data))
    jmsg = jcas.message_from_bytes(bytes(data))
    assert msg == jmsg
    cache, jcache = cas.build_chunk_cache(msg), jcas.build_chunk_cache(jmsg)
    data[size // 2] ^= 0xFF
    data[10] ^= 0x0F
    msg2 = cas.message_from_bytes(bytes(data))
    for _ in range(2):  # the first rehash builds the CV tree, the second reuses it
        got = cas.dirty_range_rehash(msg2, cache)
        want = jcas.dirty_range_rehash(msg2, jcache)
        assert got[0] == want[0] == blake3_ref.blake3_hex(msg2)[:16]
        assert got[2:] == want[2:]
        assert got[1].to_payload() == want[1].to_payload()
        cache, jcache = got[1], want[1]
