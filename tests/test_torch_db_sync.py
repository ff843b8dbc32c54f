"""The port's library DB, MessagePack codec and CRDT ops against the JAX
package's.

Exact: the `sqlite_master` DDL of fresh library DBs, the schema version,
the seeded indexer rules (blob bytes included); the codec's bytes equal
`msgpack.packb` and its decode equals `msgpack.unpackb`; CRDT ops built
from the same inputs with a fixed HLC encode to the same bytes, in the
op log columns too.
"""

import uuid

import msgpack
import numpy as np
import pytest

from spacedrive_tpu.db.database import LibraryDb as JaxDb
from spacedrive_tpu.db.schema import SCHEMA_VERSION as JAX_SCHEMA_VERSION
from spacedrive_tpu.node.library import Libraries as JaxLibraries
from spacedrive_tpu.sync import manager as jmanager
from spacedrive_tpu.sync.factory import OperationFactory as JaxFactory
from spacedrive_tpu.sync.hlc import HybridLogicalClock as JaxClock
from spacedrive_tpu_torch.db.database import LibraryDb
from spacedrive_tpu_torch.db.schema import SCHEMA_VERSION
from spacedrive_tpu_torch.node.library import Libraries
from spacedrive_tpu_torch.sync import crdt
from spacedrive_tpu_torch.sync import manager
from spacedrive_tpu_torch.sync.factory import OperationFactory
from spacedrive_tpu_torch.sync.hlc import NTP64, HybridLogicalClock
from spacedrive_tpu_torch.utils import msgpack_codec


def _ddl(db):
    return sorted((r["type"], r["name"], r["sql"]) for r in db.query(
        "SELECT type, name, sql FROM sqlite_master WHERE name NOT LIKE 'sqlite_%'"))


def test_fresh_library_db_ddl_matches_jax(tmp_path):
    port, jax = LibraryDb(tmp_path / "p.db"), JaxDb(tmp_path / "j.db")
    try:
        assert _ddl(port) == _ddl(jax) and len(_ddl(port)) > 20
        version = "SELECT user_version AS v FROM pragma_user_version"
        assert port.query_one(version)["v"] == jax.query_one(version)["v"] == SCHEMA_VERSION
        assert SCHEMA_VERSION == JAX_SCHEMA_VERSION
    finally:
        port.close()
        jax.close()


def test_created_library_seeds_the_same_rules(tmp_path):
    port = Libraries(tmp_path / "p").create("lib")
    jax = JaxLibraries(tmp_path / "j").create("lib")
    try:
        cols = 'SELECT pub_id, name, "default", rules_per_kind FROM indexer_rule ORDER BY id'
        got = [tuple(r.values()) for r in port.db.query(cols)]
        assert got == [tuple(r.values()) for r in jax.db.query(cols)] and len(got) == 4
        assert _ddl(port.db) == _ddl(jax.db)
        reopened = Libraries(tmp_path / "p").load_all()
        assert [lib.id for lib in reopened] == [port.id]
        assert reopened[0].instance_uuid == port.instance_uuid
        reopened[0].close()
    finally:
        port.close()
        jax.close()


def _values(rng):
    """Seeded values over every type the codec covers, at each width."""
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    ints += [int(x) for x in rng.integers(-2**62, 2**62, 20)]
    strs = ["", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "é" * 40_000, "/a/b/", "ünïcode"]
    bins = [b"", rng.bytes(16), rng.bytes(255), rng.bytes(256), rng.bytes(70_000)]
    return ints + strs + bins + [
        None, True, False, 0.5, -1e300, float(rng.random()),
        [], list(range(15)), list(range(16)), list(range(70_000)),
        {}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
        {"v": 1, "chunks": {"len": 57352, "dig": [rng.bytes(16) for _ in range(57)], "cvs": None}},
        (1, 2, [3, {"a": b"b", "n": None}]),
    ]


@pytest.mark.parametrize("seed", [0, 1])
def test_codec_matches_msgpack(seed):
    for v in _values(np.random.default_rng(seed)):
        want = msgpack.packb(v)
        assert msgpack_codec.packb(v) == want, repr(v)[:60]
        assert msgpack_codec.unpackb(want) == msgpack.unpackb(want, raw=False, strict_map_key=False)


@pytest.mark.parametrize("bad", [b"", b"\x92\x01", b"\xc1", b"\xa3ab", b"\x01\x02",
                                 b"\xc4\x05abc", b"\xa2\xff\xfe"])
def test_codec_rejects_malformed_input(bad):
    with pytest.raises(msgpack_codec.MsgpackError):
        msgpack_codec.unpackb(bad)


class _FixedClock:
    """An HLC whose timestamps are a fixed sequence."""

    def __init__(self, instance, start):
        self.instance_id = instance
        self._next = start

    def new_timestamp(self):
        from spacedrive_tpu_torch.sync.hlc import Timestamp

        self._next += 1
        return Timestamp(NTP64(self._next), self.instance_id)


def _ops(factory_cls, instance, ids):
    fac = factory_cls(_FixedClock(instance, 7 << 32), instance)
    ops = fac.shared_create("file_path", "ab" * 16, [
        ("location_id", "cd" * 16), ("is_dir", False), ("materialized_path", "/a/"),
        ("name", "x"), ("extension", "txt"), ("hidden", False),
        ("size_in_bytes_bytes", 102401), ("inode", 2**40 + 3),
        ("date_created", "2026-01-01T00:00:00.000+00:00"), ("date_modified", None)])
    ops += [fac.shared_update("file_path", "ab" * 16, "cas_id", "0123456789abcdef"),
            fac.shared_update("object", "ef" * 16, "kind", 5),
            fac.shared_delete("file_path", "12" * 16)]
    # fixed op ids: the factory draws uuid4s
    return [type(op)(op.instance, op.timestamp, i, op.model, op.record_id, op.data)
            for op, i in zip(ops, ids)]


def test_crdt_ops_encode_to_jax_bytes():
    instance = uuid.UUID(int=42)
    ids = [uuid.UUID(int=1000 + i) for i in range(14)]
    port, jax = _ops(OperationFactory, instance, ids), _ops(JaxFactory, instance, ids)
    assert [op.pack() for op in port] == [op.pack() for op in jax]
    assert [op.kind() for op in port] == [op.kind() for op in jax]
    assert [manager._record_id_blob(op.record_id) for op in port] == \
        [jmanager._record_id_blob(op.record_id) for op in jax]
    assert [crdt.CRDTOperation.unpack(op.pack()) for op in port] == port


def test_write_ops_commits_rows_and_ops_like_jax(tmp_path):
    """write_ops stores the same op-log columns, in the same
    transaction as the domain write."""
    port = Libraries(tmp_path / "p").create("lib")
    jax = JaxLibraries(tmp_path / "j").create("lib")
    try:
        ids = [uuid.UUID(int=2000 + i) for i in range(14)]
        rows = {}
        for lib, fac in ((port, OperationFactory), (jax, JaxFactory)):
            ops = _ops(fac, lib.instance_uuid, ids)
            lib.sync.write_ops(ops, lambda conn: conn.execute(
                "INSERT INTO tag (pub_id, name) VALUES (?, ?)", (b"\x01" * 16, "t")))
            rows[lib is port] = (
                [(r["id"], r["timestamp"], r["model"], r["record_id"], r["kind"], r["data"])
                 for r in lib.db.query("SELECT * FROM crdt_operation ORDER BY timestamp")],
                lib.db.count("tag"))
            with pytest.raises(ValueError):  # a failing domain write commits no op
                lib.sync.write_ops(ops, lambda conn: (_ for _ in ()).throw(ValueError()))
            assert lib.db.count("crdt_operation") == len(ops)
        instance = {True: port.instance_uuid, False: jax.instance_uuid}
        # the op data embeds each library's instance id; swap it to compare
        port_rows = [r[:5] + (r[5].replace(instance[True].bytes, instance[False].bytes),)
                     for r in rows[True][0]]
        assert port_rows == rows[False][0] and rows[True][1] == rows[False][1] == 1
    finally:
        port.close()
        jax.close()


def test_hlc_is_monotonic_and_merges_remote():
    clock = HybridLogicalClock(uuid.UUID(int=1))
    stamps = [clock.new_timestamp().time for _ in range(1000)]
    assert all(b > a for a, b in zip(stamps, stamps[1:]))
    ahead = NTP64(int(stamps[-1]) + (5 << 32))
    clock.update(ahead)
    assert clock.new_timestamp().time > ahead
    jclock = JaxClock(uuid.UUID(int=1))
    assert abs(jclock.now() - clock.now()) < (5 << 32)
