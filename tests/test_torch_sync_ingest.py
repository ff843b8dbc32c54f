"""The port's sync ingest against the JAX package's: the cases of
tests/test_sync_ingest.py through port instances, and through meshes
that mix a JAX instance with port instances on one loopback transport.

Every pull crosses the wire: the serving side compresses its page of
`get_ops` and packs it (`CompressedCRDTOperations.pack`), the pulling
side unpacks it with its own package, so a mixed mesh converges only if
both packages read each other's bytes. Also exact: the same ops pack to
the same bytes (`to_wire`, `pack`, the compressed batches) in both
packages; `backfill_operations` writes JAX's op log for the same rows
with the op ids and the clock pinned; the write-combining quantum, the
`sync.ingest` fault point's rejections and the combined-transaction
count equal JAX's; the actor's pull reports into the notifier's trace
(tests/test_trace.py::test_ingest_actor_pull_runs_under_notifier_trace).
"""

import asyncio
import itertools
import os
import time
import uuid

import pytest

import spacedrive_tpu.db as jdb
import spacedrive_tpu.db.database as jdatabase
import spacedrive_tpu.sync.crdt as jcrdt
import spacedrive_tpu.sync.hlc as jhlc
import spacedrive_tpu.sync.ingest as jingest
import spacedrive_tpu.sync.manager as jmanager
import spacedrive_tpu.telemetry as jtelemetry
import spacedrive_tpu.utils.events as jevents
import spacedrive_tpu.utils.faults as jfaults
import spacedrive_tpu_torch.db as pdb
import spacedrive_tpu_torch.db.database as pdatabase
import spacedrive_tpu_torch.sync.crdt as pcrdt
import spacedrive_tpu_torch.sync.hlc as phlc
import spacedrive_tpu_torch.sync.ingest as pingest
import spacedrive_tpu_torch.sync.manager as pmanager
import spacedrive_tpu_torch.telemetry as ptelemetry
import spacedrive_tpu_torch.utils.events as pevents
import spacedrive_tpu_torch.utils.faults as pfaults

PKG = {
    "jax": (jdb, jdatabase, jcrdt, jhlc, jingest, jmanager, jevents),
    "port": (pdb, pdatabase, pcrdt, phlc, pingest, pmanager, pevents),
}


@pytest.fixture(autouse=True)
def _at_rest():
    for t in (jtelemetry, ptelemetry):
        t.reset()
    yield
    for f in (jfaults, pfaults):
        f.clear()
    for t in (jtelemetry, ptelemetry):
        t.reset()


class Instance:
    """tests/test_sync_ingest.py's in-process node in either package: an
    in-memory library DB, its sync manager and one ingest actor pulling
    from every connected peer. A page of ops crosses as the compressed
    wire batch: packed by the serving package, unpacked by this one."""

    def __init__(self, pkg: str, name: str):
        self.pkg = pkg
        db, database, crdt, hlc, ingest, manager, events = PKG[pkg]
        self.crdt, self.hlc, self.ingest = crdt, hlc, ingest
        self.id = uuid.uuid4()
        self.db = db.LibraryDb(None, memory=True)
        now = database.now_iso()
        self.db.insert(
            "instance", pub_id=self.id.bytes, identity=b"", node_id=b"",
            node_name=name, node_platform=0, last_seen=now, date_created=now,
        )
        self.bus = events.EventBus()
        self.sync = manager.SyncManager(self.db, self.id, event_bus=self.bus)
        self.peers: list["Instance"] = []
        self.wire_bytes = 0

        async def request_ops(timestamps, count):
            ops, has_more = [], False
            for peer in self.peers:
                got = peer.serve_ops(timestamps, count)
                has_more = has_more or len(got) == count
                raw = peer.crdt.CompressedCRDTOperations.compress(got).pack()
                self.wire_bytes += len(raw)
                ops.extend(self.crdt.CompressedCRDTOperations.unpack(raw).expand())
            return ops, has_more

        self.actor = ingest.IngestActor(self.sync, request_ops)

    def serve_ops(self, timestamps, count):
        clocks = [(inst, self.hlc.NTP64(int(ts))) for inst, ts in timestamps]
        return self.sync.get_ops(count=count, clocks=clocks)

    def op(self, instance, ts, record_id, data, model="tag"):
        return self.crdt.CRDTOperation(
            instance=instance, timestamp=self.hlc.NTP64(ts), id=uuid.uuid4(),
            model=model, record_id=record_id, data=data)

    def data(self, kind, *args):
        return getattr(self.crdt.CRDTOperationData, kind)(*args)

    def pair(self, other: "Instance") -> None:
        """Register each other's instance rows (the pairing flow)."""
        for a, b in ((self, other), (other, self)):
            if a.db.find_one("instance", pub_id=b.id.bytes) is None:
                now = pdatabase.now_iso()
                a.db.insert(
                    "instance", pub_id=b.id.bytes, identity=b"", node_id=b"",
                    node_name="", node_platform=0, last_seen=now,
                    date_created=now,
                )


def connect(a: Instance, b: Instance) -> None:
    """Loopback transport: each side's writes (and relayed ingests)
    notify the other's actor, which pulls via get_ops."""
    a.pair(b)
    a.peers.append(b)
    b.peers.append(a)
    for src, dst in ((a, b), (b, a)):
        src.bus.on(
            lambda ev, dst=dst: dst.actor.notify()
            if ev in (("SyncMessage", "Created"), ("SyncMessage", "Ingested"))
            else None
        )


async def settle(*instances: Instance) -> None:
    for _ in range(3):  # notifications can cascade one hop
        for inst in instances:
            await inst.actor.wait_idle()
        await asyncio.sleep(0.05)


async def stop(*instances: Instance) -> None:
    for inst in instances:
        await inst.actor.stop()
        inst.db.close()


def rows(inst: Instance, table: str, key: str = "pub_id") -> dict:
    """A table's rows by sync key, without the local integer ids."""
    return {
        (r[key].hex() if isinstance(r[key], bytes) else r[key]):
            {k: v for k, v in r.items() if k != "id"}
        for r in inst.db.find(table)
    }


#: two-instance meshes: all port, and JAX beside the port either way round
PAIRS = [("port", "port"), ("jax", "port"), ("port", "jax")]
TRIOS = [("port", "port", "port"), ("jax", "port", "port"), ("port", "jax", "port")]


# --- tests/test_sync_ingest.py's cases -------------------------------------


@pytest.mark.parametrize("pkgs", PAIRS)
@pytest.mark.asyncio
async def test_create_converges_between_two_instances(pkgs):
    a, b = Instance(pkgs[0], "a"), Instance(pkgs[1], "b")
    connect(a, b)
    tag_pub = uuid.uuid4()
    a.sync.write_ops(
        a.sync.shared_create(
            "tag", tag_pub.bytes.hex(), [("name", "holiday"), ("color", "#ff0000")]
        )
    )
    await settle(a, b)
    row = b.db.find_one("tag", pub_id=tag_pub.bytes)
    assert row is not None
    assert row["name"] == "holiday" and row["color"] == "#ff0000"
    assert b.actor.applied >= 3
    assert rows(a, "tag") == rows(b, "tag")
    await stop(a, b)


@pytest.mark.parametrize("pkgs", PAIRS)
@pytest.mark.asyncio
async def test_lww_concurrent_field_updates(pkgs):
    a, b = Instance(pkgs[0], "a"), Instance(pkgs[1], "b")
    connect(a, b)
    tag_pub = uuid.uuid4().bytes.hex()
    a.sync.write_ops(a.sync.shared_create("tag", tag_pub, [("name", "t0")]))
    await settle(a, b)
    a.sync.write_ops([a.sync.shared_update("tag", tag_pub, "name", "from-a")])
    b.sync.write_ops([b.sync.shared_update("tag", tag_pub, "name", "from-b")])
    await settle(a, b)
    ra = a.db.find_one("tag", pub_id=bytes.fromhex(tag_pub))
    rb = b.db.find_one("tag", pub_id=bytes.fromhex(tag_pub))
    assert ra["name"] == rb["name"]  # converged
    assert ra["name"] in ("from-a", "from-b")
    await stop(a, b)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_old_op_rejected(pkg):
    a = Instance(pkg, "a")
    remote = uuid.uuid4()
    tag_pub = uuid.uuid4().bytes.hex()
    new = a.op(remote, 2000, tag_pub, a.data("update", "name", "newer"))
    old = a.op(remote, 1000, tag_pub, a.data("update", "name", "older"))
    assert a.ingest.receive_crdt_operation(a.sync, new)
    assert a.ingest.is_operation_old(a.sync, old)
    assert not a.ingest.receive_crdt_operation(a.sync, old)
    row = a.db.find_one("tag", pub_id=bytes.fromhex(tag_pub))
    assert row["name"] == "newer"
    # delete dominates older updates for the same record
    mid = a.op(remote, 1500, tag_pub, a.data("update", "color", "#fff"))
    dele = a.op(remote, 3000, tag_pub, a.data("delete"))
    assert a.ingest.receive_crdt_operation(a.sync, dele)
    assert not a.ingest.receive_crdt_operation(a.sync, mid)
    assert a.db.find_one("tag", pub_id=bytes.fromhex(tag_pub)) is None
    a.db.close()


def test_out_of_order_fk_resolution():
    """file_path referencing an object whose Create arrives later gets a
    placeholder that the Create then fills (sync/apply.py)."""
    a = Instance("port", "a")
    remote = uuid.uuid4()
    fp_pub = uuid.uuid4().bytes.hex()
    obj_pub = uuid.uuid4().bytes.hex()
    link = a.op(remote, 10, fp_pub, a.data("update", "object_id", obj_pub), "file_path")
    create_obj = a.op(remote, 20, obj_pub, a.data("update", "kind", 5), "object")
    assert a.ingest.receive_crdt_operation(a.sync, link)
    assert a.ingest.receive_crdt_operation(a.sync, create_obj)
    obj = a.db.find_one("object", pub_id=bytes.fromhex(obj_pub))
    fp = a.db.find_one("file_path", pub_id=bytes.fromhex(fp_pub))
    assert obj["kind"] == 5 and fp["object_id"] == obj["id"]
    a.db.close()


@pytest.mark.parametrize("pkgs", PAIRS)
@pytest.mark.asyncio
async def test_relation_ops_roundtrip(pkgs):
    a, b = Instance(pkgs[0], "a"), Instance(pkgs[1], "b")
    connect(a, b)
    obj_pub = uuid.uuid4().bytes.hex()
    tag_pub = uuid.uuid4().bytes.hex()
    a.sync.write_ops(
        [
            *a.sync.shared_create("object", obj_pub, [("kind", 5)]),
            *a.sync.shared_create("tag", tag_pub, [("name", "x")]),
            *a.sync.relation_create(
                "tag_on_object", {"item": obj_pub, "group": tag_pub},
                [("date_created", "2026-01-01")],
            ),
        ]
    )
    await settle(a, b)
    obj = b.db.find_one("object", pub_id=bytes.fromhex(obj_pub))
    tag = b.db.find_one("tag", pub_id=bytes.fromhex(tag_pub))
    rel = b.db.find_one("tag_on_object", object_id=obj["id"], tag_id=tag["id"])
    assert rel is not None and rel["date_created"] == "2026-01-01"
    # un-tag propagates
    a.sync.write_ops(
        [a.sync.relation_delete("tag_on_object", {"item": obj_pub, "group": tag_pub})]
    )
    await settle(a, b)
    assert b.db.find_one("tag_on_object", object_id=obj["id"]) is None
    await stop(a, b)


@pytest.mark.parametrize("pkgs", PAIRS)
@pytest.mark.asyncio
async def test_backfill_then_sync(pkgs):
    """Rows created without ops (pre-sync library) backfill into the op
    log and then converge to a fresh peer (ref:backfill.rs)."""
    a, b = Instance(pkgs[0], "a"), Instance(pkgs[1], "b")
    tag_pub = uuid.uuid4()
    a.db.insert("tag", pub_id=tag_pub.bytes, name="old-tag", color="#00f")
    assert a.db.count("crdt_operation") == 0
    n = a.ingest.backfill_operations(a.sync)
    assert n >= 3  # create + 2 field updates
    assert a.ingest.backfill_operations(a.sync) == 0  # idempotent
    connect(a, b)
    a.sync.event_bus.emit(("SyncMessage", "Created"))  # kick
    await settle(a, b)
    row = b.db.find_one("tag", pub_id=tag_pub.bytes)
    assert row is not None and row["name"] == "old-tag"
    await stop(a, b)


@pytest.mark.parametrize("pkgs", TRIOS)
@pytest.mark.asyncio
async def test_three_node_mesh_converges(pkgs):
    a, b, c = (Instance(p, n) for p, n in zip(pkgs, "abc"))
    # chain topology: c hears of a's writes relayed through b (ingested
    # ops re-notify downstream peers)
    connect(a, b)
    connect(b, c)
    pubs = []
    for i, inst in enumerate((a, b, c)):
        p = uuid.uuid4().bytes.hex()
        pubs.append(p)
        inst.sync.write_ops(
            inst.sync.shared_create("tag", p, [("name", f"tag-{i}")])
        )
    await settle(a, b, c)
    for inst in (a, b, c):
        for i, p in enumerate(pubs):
            row = inst.db.find_one("tag", pub_id=bytes.fromhex(p))
            assert row is not None and row["name"] == f"tag-{i}", (
                f"{inst.sync.instance} missing tag-{i}"
            )
    await stop(a, b, c)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_equal_timestamp_delete_update_tiebreak_converges(pkg):
    """Equal-HLC delete (instance A) vs update (instance B) converge to
    the same state on both arrival orders, decided by the (timestamp,
    instance pub_id) LWW order — not arrival order; the same state in
    both packages."""
    tag_pub = uuid.uuid4().bytes.hex()

    def build(inst, lo, hi):
        delete = inst.op(lo, 5000, tag_pub, inst.data("delete"))
        update = inst.op(hi, 5000, tag_pub, inst.data("update", "name", "survivor"))
        return delete, update

    ids = sorted([uuid.uuid4(), uuid.uuid4()], key=lambda u: u.bytes)
    for lo, hi, survives in ((ids[0], ids[1], True), (ids[1], ids[0], False)):
        n1, n2 = Instance(pkg, "n1"), Instance(pkg, "n2")
        delete, update = build(n1, lo, hi)
        n1.ingest.receive_crdt_operation(n1.sync, update)
        n1.ingest.receive_crdt_operation(n1.sync, delete)
        n2.ingest.receive_crdt_operation(n2.sync, delete)
        n2.ingest.receive_crdt_operation(n2.sync, update)
        r1 = n1.db.find_one("tag", pub_id=bytes.fromhex(tag_pub))
        r2 = n2.db.find_one("tag", pub_id=bytes.fromhex(tag_pub))
        assert (r1 is None) == (r2 is None), "arrival-order divergence"
        assert (r1 is not None) == survives
        if survives:
            assert r1["name"] == r2["name"] == "survivor"
        n1.db.close()
        n2.db.close()


# --- the wire and the op log, byte for byte --------------------------------


def _same_ops(pkg: str, inst: uuid.UUID, ids):
    """One fixed script of ops in `pkg`: creates, updates, a relation,
    a delete, with the HLC and the op ids pinned."""
    _, _, crdt, hlc, _, _, _ = PKG[pkg]
    D = crdt.CRDTOperationData
    other = uuid.UUID(int=99)
    script = [
        (inst, "object", "aa" * 16, D.create()),
        (inst, "object", "aa" * 16, D.update("kind", 5)),
        (inst, "object", "aa" * 16, D.update("note", "a note")),
        (inst, "tag", "bb" * 16, D.create()),
        (inst, "tag", "bb" * 16, D.update("name", "holiday")),
        (other, "tag", "bb" * 16, D.update("color", "#ff0000")),
        (other, "tag_on_object", {"item": "aa" * 16, "group": "bb" * 16}, D.create()),
        (inst, "file_path", "cc" * 16, D.update("size_in_bytes_bytes", 2**40 + 7)),
        (inst, "label", "cat", D.update("date_created", "2026-01-01")),
        (inst, "object", "aa" * 16, D.delete()),
    ]
    return [crdt.CRDTOperation(i, hlc.NTP64(1_000_000 + 17 * k), next(ids), m, r, d)
            for k, (i, m, r, d) in enumerate(script)]


def test_ops_and_compressed_batches_pack_as_jax():
    inst = uuid.UUID(int=7)
    ids = [uuid.UUID(int=1000 + k) for k in range(10)]
    jops = _same_ops("jax", inst, iter(ids))
    pops = _same_ops("port", inst, iter(ids))
    for j, p in zip(jops, pops):
        assert p.to_wire() == j.to_wire()
        assert p.pack() == j.pack()
        assert pcrdt.CRDTOperation.unpack(j.pack()) == p
    jraw = jcrdt.CompressedCRDTOperations.compress(jops).pack()
    praw = pcrdt.CompressedCRDTOperations.compress(pops).pack()
    assert praw == jraw
    assert pcrdt.CompressedCRDTOperations.unpack(jraw).expand() == pops
    assert [o.pack() for o in jcrdt.CompressedCRDTOperations.unpack(praw).expand()] == \
        [o.pack() for o in jops]
    assert len(pcrdt.CompressedCRDTOperations.unpack(jraw)) == len(jops)


def _seed_rows(pkg: str, db, preference: bool = True) -> None:
    """The same pre-sync rows in either package's DB: every synced model
    (u64 blobs, FKs, an FK-derived identity, relations). A preference
    row backfills, but JAX's `apply_op` cannot apply its ops (it looks
    the row up by an `id` column the `preference` table lacks; the port
    uses the rowid), so a mesh with a JAX puller leaves it out."""
    _, database, *_ = PKG[pkg]
    loc = db.insert("location", pub_id=bytes(range(16)), name="loc", path="/x",
                    size_in_bytes=database.u64_blob(12345), instance_id=1)
    obj = db.insert("object", pub_id=bytes(range(16, 32)), kind=5, note="n")
    db.insert("object", pub_id=bytes(range(32, 48)), kind=7)
    db.insert("file_path", pub_id=bytes(range(48, 64)), location_id=loc, object_id=obj,
              name="a", extension="jpg", is_dir=0, cas_id="0123456789abcdef",
              materialized_path="/", size_in_bytes_bytes=database.u64_blob(2**40 + 3),
              inode=database.u64_blob(99))
    db.insert("media_data", object_id=obj, resolution=b"\x01\x02", camera_data=b"cam")
    tag = db.insert("tag", pub_id=bytes(range(64, 80)), name="t", color="#00f")
    db.insert("tag_on_object", object_id=obj, tag_id=tag, date_created="2026-01-01")
    label = db.insert("label", name="cat", date_created="2026-01-02")
    db.insert("label_on_object", object_id=obj, label_id=label)
    if preference:
        db.insert("preference", key="k", value=b"\x93\x01\x02\x03")


def test_backfill_writes_jax_op_log(monkeypatch):
    """`backfill_operations` over the same rows, op ids and clock pinned:
    the op log's bytes equal JAX's, row for row."""
    inst = uuid.UUID(int=42)
    logs = {}
    for pkg in ("jax", "port"):
        db_mod, database, _, _, ingest, manager, _ = PKG[pkg]
        counter = itertools.count(1)
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter)))
        monkeypatch.setattr(time, "time", lambda: 1.8e9)
        db = db_mod.LibraryDb(None, memory=True)
        db.insert("instance", pub_id=inst.bytes, identity=b"", node_id=b"", node_name="n",
                  node_platform=0, last_seen="t", date_created="t")
        _seed_rows(pkg, db)
        sync = manager.SyncManager(db, inst)
        n = ingest.backfill_operations(sync)
        assert n > 30 and ingest.backfill_operations(sync) == 0
        logs[pkg] = [(r["id"], r["timestamp"], r["model"], r["record_id"], r["kind"], r["data"])
                     for r in db.query("SELECT * FROM crdt_operation ORDER BY rowid")]
        db.close()
        monkeypatch.undo()
    assert logs["port"] == logs["jax"]
    assert {r[2] for r in logs["port"]} == {
        "location", "file_path", "object", "media_data", "tag", "label", "preference",
        "tag_on_object", "label_on_object"}


@pytest.mark.parametrize("pkgs", [("jax", "port"), ("port", "jax")])
@pytest.mark.asyncio
async def test_mixed_mesh_converges_on_every_model(pkgs):
    """A backfilled library of every synced model written in one package
    ingests into the other, writes made there come back, and both DBs
    hold equal rows in every table."""
    a, b = Instance(pkgs[0], "a"), Instance(pkgs[1], "b")
    _seed_rows(a.pkg, a.db, preference=False)
    a.ingest.backfill_operations(a.sync)
    connect(a, b)
    a.sync.event_bus.emit(("SyncMessage", "Created"))
    await settle(a, b)
    obj_pub = bytes(range(16, 32)).hex()
    b.sync.write_ops([
        *b.sync.shared_create("tag", "dd" * 16, [("name", "from-b")]),
        *b.sync.relation_create("tag_on_object", {"item": obj_pub, "group": "dd" * 16}),
        b.sync.shared_update("object", obj_pub, "note", "edited on b"),
    ])
    await settle(a, b)
    for table, key in (("object", "pub_id"), ("file_path", "pub_id"), ("tag", "pub_id"),
                       ("label", "name")):
        assert rows(a, table, key) == rows(b, table, key), table
    # a local-only column never crosses (location.instance_id is @local)
    la, lb = rows(a, "location"), rows(b, "location")
    assert {k: {c: v for c, v in r.items() if c != "instance_id"} for k, r in la.items()} == \
        {k: {c: v for c, v in r.items() if c != "instance_id"} for k, r in lb.items()}
    for inst in (a, b):
        assert inst.db.count("tag_on_object") == 2
        assert inst.db.count("label_on_object") == 1
        assert inst.db.count("media_data") == 1
    assert a.db.find_one("object", pub_id=bytes.fromhex(obj_pub))["note"] == "edited on b"
    assert a.wire_bytes and b.wire_bytes
    # a second pull applies nothing
    before = b.actor.applied
    b.actor.notify()
    await settle(a, b)
    assert b.actor.applied == before
    await stop(a, b)


def test_a_backfilled_preference_applies_in_the_port_and_not_in_jax():
    """The preference table has no `id` column: the port's appliers find
    a shared row by its rowid and apply the backfilled ops; JAX's raise
    (its ingest rejects each op)."""
    owner = Instance("port", "owner")
    owner.db.insert("preference", key="k", value=b"\x93\x01\x02\x03")
    owner.db.insert("tag", pub_id=bytes(16), name="t")
    owner.ingest.backfill_operations(owner.sync)
    ops = owner.sync.get_ops(count=100)
    got = {}
    for pkg in ("port", "jax"):
        inst = Instance(pkg, pkg)
        inst.pair(owner)
        wire = pcrdt.CompressedCRDTOperations.compress(ops).pack()
        pulled = inst.crdt.CompressedCRDTOperations.unpack(wire).expand()
        got[pkg] = (inst.ingest.ingest_batch(inst.sync, pulled),
                    rows(inst, "preference", "key"), rows(inst, "tag"))
        inst.db.close()
    assert all(got["port"][0]) and got["port"][1] == rows(owner, "preference", "key")
    assert got["port"][2] == rows(owner, "tag") == got["jax"][2]
    assert got["jax"][1] == {} and got["jax"][0].count(False) == 2
    owner.db.close()


def test_get_ops_pages_equal_jax(tmp_path):
    """One op log of three instances read by both managers: every page
    of `get_ops` (the port merges the instances' index ranges, JAX sorts
    one OR'ed query) holds the same ops in the same order, under several
    sets of watermarks."""
    import random

    path = str(tmp_path / "lib.db")
    db = pdb.LibraryDb(path)
    insts = [uuid.UUID(int=i + 1) for i in range(3)]
    for inst in insts:
        db.insert("instance", pub_id=inst.bytes, identity=b"", node_id=b"", node_name="",
                  node_platform=0, last_seen="t", date_created="t")
    rng = random.Random(5)
    D = pcrdt.CRDTOperationData
    ops = [pcrdt.CRDTOperation(rng.choice(insts), phlc.NTP64(1000 + 3 * k + rng.randrange(2)),
                               uuid.UUID(int=10_000 + k), "tag", f"{k % 9:032x}",
                               D.update("name", f"v{k}"))
           for k in range(120)]
    pmanager.SyncManager(db, insts[0]).write_ops(ops)
    db.close()
    port = pmanager.SyncManager(pdb.LibraryDb(path), insts[0])
    jax = jmanager.SyncManager(jdb.LibraryDb(path), insts[0])
    for clocks in ([], [(insts[0], 1100)], [(insts[1], 1200), (insts[2], 1050)],
                   [(i, 1300) for i in insts]):
        for count in (1, 7, 1000):
            got = port.get_ops(count, [(i, phlc.NTP64(t)) for i, t in clocks])
            want = jax.get_ops(count, [(i, jhlc.NTP64(t)) for i, t in clocks])
            assert [o.pack() for o in got] == [o.pack() for o in want]
    port.db.close()
    jax.db.close()


# --- write combining, the fault point, the trace ----------------------------


@pytest.mark.parametrize("env", [{}, {"SD_SERVE_GATE": "0"}, {"SD_SYNC_WRITE_COMBINE": "0"}])
def test_txn_quantum_and_combined_count_equal_jax(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert pingest.ingest_txn_quantum() == jingest.ingest_txn_quantum()
    from spacedrive_tpu.serve import policy as jpolicy
    from spacedrive_tpu_torch.serve import policy as ppolicy

    assert ppolicy().sync_txn_ops == jpolicy().sync_txn_ops == 64
    counts = {}
    for pkg, telemetry in (("jax", jtelemetry), ("port", ptelemetry)):
        src, dst = Instance(pkg, "src"), Instance(pkg, "dst")
        src.pair(dst)
        for i in range(150):
            src.sync.write_ops(src.sync.shared_create("tag", f"{i:032x}", [("name", f"t{i}")]))
        ops = src.sync.get_ops(count=1000)
        outcomes = dst.ingest.ingest_batch(dst.sync, ops)
        counts[pkg] = (sum(outcomes), len(outcomes), dst.db.count("tag"),
                       telemetry.counter_value("sd_sync_txn_combined_total"),
                       telemetry.counter_value("sd_sync_ops_total", result="applied"))
        src.db.close()
        dst.db.close()
    assert counts["port"] == counts["jax"]
    assert counts["port"][:3] == (300, 300, 150)


def test_a_combined_chunk_ends_with_jax_metrics_and_tenant_sketch():
    """The write-combined path finalizes each chunk at once: after the
    same ops from two origin instances (runs of each, updates made stale
    by newer ones, deletes, a guard trip), the outcome counters, the
    watermark gauges, the tenant sketch and the watermarks equal JAX's,
    which finalizes op by op."""
    from spacedrive_tpu.telemetry import tenants as jtenants
    from spacedrive_tpu_torch.telemetry import tenants as ptenants

    a, b = uuid.UUID(int=11), uuid.UUID(int=12)
    D = pcrdt.CRDTOperationData
    script, k = [], 0
    for run in range(6):
        inst = (a, b)[run % 2]
        for i in range(13 + run):
            rec = f"{(run * 7 + i) % 23:032x}"
            k += 1
            data = (D.delete() if i % 11 == 10 else
                    D.update("name", f"n{k}") if i % 3 else D.create())
            script.append((inst, 10_000 + k * 5, rec, data))
    # an older update after a newer one for the same field: stale
    script.append((a, 10_001, f"{1:032x}", D.update("name", "old")))
    got = {}
    for pkg, telemetry, tenants, faults in (("jax", jtelemetry, jtenants, jfaults),
                                            ("port", ptelemetry, ptenants, pfaults)):
        telemetry.reset()
        faults.install(faults.FaultPlan.parse("sync.ingest:poison:times=2", seed=0))
        dst = Instance(pkg, "dst")
        ops = [dst.op(i, ts, rec, getattr(dst.crdt.CRDTOperationData, d.kind == "u" and "update"
                                          or d.kind == "d" and "delete" or "create")(
                   *((d.field_name, d.value) if d.kind == "u" else ())))
               for i, ts, rec, d in script]
        outcomes = dst.ingest.ingest_batch(dst.sync, ops, txn_ops=16)
        faults.clear()
        got[pkg] = (outcomes,
                    {r: telemetry.counter_value("sd_sync_ops_total", result=r)
                     for r in ("applied", "tombstone", "stale")},
                    telemetry.counter_value("sd_hlc_delta_guard_total"),
                    {str(i): telemetry.gauge_value("sd_sync_watermark_seconds",
                                                   peer=dst.ingest.peer_label(i))
                     for i in (a, b)},
                    {str(i): int(t) for i, t in dst.sync.timestamps.items()},
                    tenants.snapshot())
        dst.db.close()
    assert got["port"] == got["jax"]
    assert got["port"][1]["stale"] >= 1 and got["port"][1]["tombstone"] >= 1
    assert got["port"][2] == 2 and got["port"][0].count(False) >= 2


@pytest.mark.asyncio
async def test_injected_poison_rejects_an_op_as_jax():
    """`sync.ingest:poison:times=1` on the pulling package: its first op
    (the create) reads as a delta-guard casualty, counted and not
    stored, and the record's updates still build the row; the same
    outcome in either package (the serving side is the other one, whose
    fault plane is not armed)."""
    got = {}
    for pkg, faults, telemetry in (("jax", jfaults, jtelemetry), ("port", pfaults, ptelemetry)):
        a, b = Instance(pkg, "a"), Instance("port" if pkg == "jax" else "jax", "b")
        connect(a, b)
        faults.install(faults.FaultPlan.parse("sync.ingest:poison:times=1", seed=0))
        b.sync.write_ops(b.sync.shared_create("tag", "ee" * 16, [("name", "x"), ("color", "c")]))
        await settle(a, b)
        faults.clear()
        got[pkg] = (a.actor.rejected, telemetry.counter_value("sd_hlc_delta_guard_total"),
                    rows(a, "tag") == rows(b, "tag"), a.db.count("tag"),
                    a.db.count("crdt_operation"))
        await stop(a, b)
    assert got["port"] == got["jax"] == (1, 1.0, True, 1, 2)


@pytest.mark.asyncio
async def test_ingest_actor_pull_runs_under_notifier_trace():
    """The responder's ingest actor pull (notify → request_ops → apply)
    reports into the initiating node's trace."""
    from spacedrive_tpu_torch.telemetry import trace

    db = pdb.LibraryDb(":memory:")
    sync = pmanager.SyncManager(db, uuid.uuid4())
    seen: list[str] = []

    async def request_ops(timestamps, count):
        ctx = trace.current()
        seen.append(ctx.trace_id if ctx else None)
        return [], False

    actor = pingest.IngestActor(sync, request_ops, poll_interval=None)
    initiator = trace.new_context()
    actor.notify(trace_ctx=initiator)
    await actor.wait_idle()
    await actor.stop()
    db.close()
    assert seen == [initiator.trace_id]


@pytest.mark.asyncio
async def test_on_applied_fires_only_for_batches_that_apply():
    a, b = Instance("port", "a"), Instance("port", "b")
    calls = []
    b.actor.on_applied = lambda: calls.append(b.actor.applied)
    connect(a, b)
    a.sync.write_ops(a.sync.shared_create("tag", "ff" * 16, [("name", "x")]))
    await settle(a, b)
    assert calls == [2]
    b.actor.notify()
    await settle(a, b)
    assert calls == [2]
    await stop(a, b)


# --- port-side fixes the replica needs ----------------------------------------


def test_a_replica_index_holds_embeddings_whose_vectors_come_later():
    """The replica's `on_applied` refresh after every page: an embedding
    row created in one page gets its vector in a later one (and its stamp
    may be older than one already read); the index holds every vector in
    the end. (The JAX index skips such a row for good.)"""
    import numpy as np

    from spacedrive_tpu_torch.object.search.index import LibraryIndex, on_embeddings_applied

    class Lib:
        pass

    owner = Instance("port", "owner")
    rng = np.random.default_rng(3)
    ops = []
    for i in range(12):
        obj = f"{i:032x}"
        vec = rng.standard_normal(128).astype("<f4").tobytes()
        ops += owner.sync.shared_create("object", obj, [("kind", 5)])
        ops += owner.sync.shared_create("object_embedding", obj, [
            ("vector", vec), ("dim", 128), ("model", "m"),
            ("date_calculated", f"2026-01-01T00:00:{59 - i:02d}")])
    owner.sync.write_ops(ops)
    joiner = Instance("port", "joiner")
    joiner.pair(owner)
    lib = Lib()
    lib.db, lib.node, lib.id = joiner.db, None, uuid.uuid4()
    lib.search_index = LibraryIndex(lib)
    joiner.actor = pingest.IngestActor(
        joiner.sync, lambda ts, n: _page(owner, ts, n), ops_per_request=5,
        on_applied=lambda: on_embeddings_applied(lib))

    async def run():
        joiner.actor.notify()
        await joiner.actor.wait_idle()
        await joiner.actor.stop()

    asyncio.run(run())
    assert joiner.db.count("object_embedding") == 12
    assert len(lib.search_index) == 12


def test_a_row_whose_vector_never_comes_costs_a_refresh_nothing(tmp_path):
    """One object_embedding row that never gets its vector: later
    refreshes read that row alone, by id, persist nothing, keep the
    matrix on its device, and fold the vector in once it comes."""
    import numpy as np

    from spacedrive_tpu_torch.db import LibraryDb
    from spacedrive_tpu_torch.object.search.index import LibraryIndex

    class Lib:
        pass

    lib = Lib()
    lib.db, lib.node = LibraryDb(str(tmp_path / "lib.db")), None
    rng = np.random.default_rng(5)
    for i in range(6):
        oid = lib.db.insert("object", pub_id=uuid.UUID(int=i + 1).bytes, kind=5)
        vec = None if i == 2 else rng.standard_normal(128).astype("<f4").tobytes()
        lib.db.insert("object_embedding", object_id=oid, vector=vec, dim=128,
                      model="m", date_calculated=f"2026-01-01T00:00:{i:02d}")
    index = LibraryIndex(lib)
    assert index.refresh() == 5
    persisted, read = [], []
    index._persist = lambda: persisted.append(1)
    query = lib.db.query
    lib.db.query = lambda sql, params=(): read.append(params) or query(sql, params)
    index._on_device = ("cpu", object())
    held = index._on_device
    for _ in range(3):
        assert index.refresh() == 5
    # each refresh: the watermark query (no row) and the waiting row by id
    assert len(read) == 6 and read[1::2] == [(3,)] * 3
    assert persisted == [] and index._on_device is held
    (row,) = query("SELECT id, object_id FROM object_embedding WHERE vector IS NULL")
    lib.db.execute("UPDATE object_embedding SET vector = ? WHERE id = ?",
                   (rng.standard_normal(128).astype("<f4").tobytes(), row["id"]))
    assert index.refresh() == 6 and persisted == [1] and index._on_device is None
    assert index._pending == set()
    # a fresh index over the persisted sidecar finds the waiting row too
    lib.db.execute("UPDATE object_embedding SET vector = NULL WHERE id = ?", (row["id"],))
    again = LibraryIndex(lib)
    again.refresh()
    assert again._pending == {row["id"]}


async def _page(peer, timestamps, count):
    ops = peer.sync.get_ops(count=count, clocks=timestamps)
    return ops, len(ops) == count


def test_a_watched_rename_and_remove_reach_a_replica(tmp_path):
    """A port Node's watcher applies a rename (a file and a directory)
    and a remove with their CRDT ops, so a replica that ingests the op
    log holds the same file_path rows (JAX's watcher writes the rows
    alone: a replica keeps the old names and the removed rows)."""
    from spacedrive_tpu_torch.node.node import Node

    root = tmp_path / "loc"
    (root / "dir" / "sub").mkdir(parents=True)
    for name in ("a.txt", "b.txt", "dir/c.txt", "dir/sub/d.txt"):
        (root / name).write_bytes(name.encode() * 100)

    async def run():
        node = Node(str(tmp_path / "node"), device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            r = node.router
            lid = (await r.exec(node, "library.create", {"name": "w"}))["uuid"]
            await r.exec(node, "locations.create", {"path": str(root)}, library_id=lid)
            await node.jobs.wait_idle()
            lib = node.libraries.libraries[uuid.UUID(lid)]
            mgr = node.location_manager
            mgr.debounce, mgr.debounce_max = 0.05, 0.2
            os.rename(root / "a.txt", root / "a2.txt")
            os.rename(root / "dir", root / "dir2")
            os.remove(root / "b.txt")

            def applied():
                names = {(x["materialized_path"], x["name"]) for x in lib.db.find("file_path")}
                return ("/", "a2") in names and ("/dir2/sub/", "d") in names and \
                    ("/", "b") not in names

            deadline = time.monotonic() + 30
            while not applied():
                assert time.monotonic() < deadline, "the watcher never applied the events"
                await asyncio.sleep(0.05)
            await node.jobs.wait_idle()
            replica = Instance("port", "replica")
            replica.db.insert("instance", pub_id=lib.sync.instance.bytes, identity=b"",
                              node_id=b"", node_name="", node_platform=0,
                              last_seen="t", date_created="t")
            ops = lib.sync.get_ops(count=100_000)
            assert all(pingest.ingest_batch(replica.sync, ops))

            def view(db):
                return sorted((x["materialized_path"], x["name"], x["extension"], x["is_dir"])
                              for x in db.find("file_path"))

            assert view(replica.db) == view(lib.db)
            replica.db.close()
        finally:
            await node.shutdown()

    asyncio.run(run())
