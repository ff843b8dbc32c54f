"""Data-layer tests: schema integrity, typed helpers, u64 blobs.

The JAX package's tests/test_db.py, pointed at the port package; the
sync-model registry it also tests is not ported.
"""

import sqlite3

import pytest

from spacedrive_tpu_torch.db import LibraryDb
from spacedrive_tpu_torch.db.database import blob_u64, new_pub_id, now_iso, u64_blob


@pytest.fixture()
def db():
    d = LibraryDb(None, memory=True)
    yield d
    d.close()


def test_schema_tables(db):
    tables = {r["name"] for r in db.query("SELECT name FROM sqlite_master WHERE type='table'")}
    expected = {
        "crdt_operation", "cloud_crdt_operation", "node", "instance",
        "statistics", "volume", "location", "file_path", "object",
        "media_data", "tag", "tag_on_object", "label", "label_on_object",
        "space", "object_in_space", "album", "object_in_album", "job",
        "indexer_rule", "indexer_rule_in_location", "preference",
        "notification", "saved_search",
    }
    assert expected <= tables


def test_insert_find_update_delete(db):
    loc_id = db.insert("location", pub_id=new_pub_id(), name="home", path="/data")
    row = db.find_one("location", id=loc_id)
    assert row["name"] == "home"
    assert db.update("location", {"id": loc_id}, name="renamed") == 1
    assert db.find_one("location", id=loc_id)["name"] == "renamed"
    assert db.delete("location", id=loc_id) == 1
    assert db.find_one("location", id=loc_id) is None


def test_file_path_unique_constraints(db):
    loc = db.insert("location", pub_id=new_pub_id(), name="l", path="/l")
    db.insert(
        "file_path", pub_id=new_pub_id(), location_id=loc,
        materialized_path="/", name="a", extension="txt", inode=u64_blob(42),
    )
    with pytest.raises(sqlite3.IntegrityError):
        db.insert(
            "file_path", pub_id=new_pub_id(), location_id=loc,
            materialized_path="/", name="a", extension="txt", inode=u64_blob(43),
        )
    with pytest.raises(sqlite3.IntegrityError):
        db.insert(
            "file_path", pub_id=new_pub_id(), location_id=loc,
            materialized_path="/", name="b", extension="txt", inode=u64_blob(42),
        )


def test_name_collates_nocase(db):
    loc = db.insert("location", pub_id=new_pub_id(), name="l", path="/l")
    db.insert("file_path", pub_id=new_pub_id(), location_id=loc,
              materialized_path="/", name="Readme", extension="md")
    rows = db.query(
        "SELECT * FROM file_path WHERE name = ?", ("readme",)
    )
    assert len(rows) == 1


def test_object_cascade(db):
    obj = db.insert("object", pub_id=new_pub_id(), kind=5)
    db.insert("media_data", object_id=obj, artist="x")
    db.delete("object", id=obj)
    assert db.count("media_data") == 0


def test_u64_blob_roundtrip():
    for v in (0, 1, 2**40, 2**64 - 1):
        assert blob_u64(u64_blob(v)) == v
    assert blob_u64(None) is None


def test_upsert(db):
    db.upsert("preference", {"key": "theme"}, value=b"dark")
    db.upsert("preference", {"key": "theme"}, value=b"light")
    assert db.find_one("preference", key="theme")["value"] == b"light"
    assert db.count("preference") == 1


def test_migration_idempotent(tmp_path):
    p = tmp_path / "lib.db"
    d1 = LibraryDb(p)
    d1.insert("statistics", total_object_count=9)
    d1.close()
    d2 = LibraryDb(p)
    assert d2.query_one("SELECT total_object_count AS n FROM statistics")["n"] == 9
    d2.close()

