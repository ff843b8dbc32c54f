"""CRDT vocabulary tests: HLC monotonicity/merge, op wire roundtrips
(the reference's own coverage here is wire roundtrips, e.g.
ref:core/src/p2p/sync/mod.rs:56-70).

The JAX package's tests/test_sync_vocab.py, pointed at the port package,
less its test of the compressed wire batches, which the port does not
have.
"""

import uuid

from spacedrive_tpu_torch.sync import (
    CRDTOperation,
    CRDTOperationData,
    HybridLogicalClock,
    NTP64,
    OperationFactory,
)
import pytest

from spacedrive_tpu_torch.sync.hlc import ClockDriftError


def make_factory(seed: int = 1) -> OperationFactory:
    inst = uuid.UUID(int=seed)
    return OperationFactory(HybridLogicalClock(inst), inst)


def test_hlc_monotonic():
    clock = HybridLogicalClock(uuid.UUID(int=1))
    stamps = [clock.new_timestamp().time for _ in range(1000)]
    assert all(b > a for a, b in zip(stamps, stamps[1:]))


def test_hlc_merge_remote_ahead():
    clock = HybridLogicalClock(uuid.UUID(int=1))
    t0 = clock.new_timestamp().time
    remote = NTP64(t0 + (1 << 32))  # 1 s ahead
    clock.update(remote)
    assert clock.new_timestamp().time > remote


def test_hlc_rejects_big_drift():
    clock = HybridLogicalClock(uuid.UUID(int=1), max_drift_seconds=1.0)
    way_ahead = NTP64.from_unix(clock.now().as_unix() + 3600)
    with pytest.raises(ClockDriftError):
        clock.update(way_ahead)


def test_kind_strings():
    assert CRDTOperationData.create().as_kind_string() == "c"
    assert CRDTOperationData.update("name", "x").as_kind_string() == "u:name"
    assert CRDTOperationData.delete().as_kind_string() == "d"


def test_op_roundtrip():
    f = make_factory()
    op = f.shared_update("location", "deadbeef", "name", "Home")
    back = CRDTOperation.unpack(op.pack())
    assert back == op


def test_shared_create_emits_field_updates():
    f = make_factory()
    ops = f.shared_create("object", "aa", [("kind", 5), ("note", "hi")])
    assert [o.kind() for o in ops] == ["c", "u:kind", "u:note"]
    ts = [o.timestamp for o in ops]
    assert ts == sorted(ts) and len(set(ts)) == 3


def test_relation_ops():
    f = make_factory()
    rid = {"item": "obj-pub", "group": "tag-pub"}
    ops = f.relation_create("tag_on_object", rid, [("date_created", "2024-01-01")])
    assert ops[0].record_id == rid
    back = CRDTOperation.unpack(ops[1].pack())
    assert back.record_id == rid
