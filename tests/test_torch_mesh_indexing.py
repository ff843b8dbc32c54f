"""Mesh-parallel indexing in the port: twins of tests/test_mesh_indexing.py's
two-Node cases and of tests/test_attrib.py's cross-node assembly.

Two port Nodes share one library over the in-process duplex
(`p2p/loopback.py`) and index a location through the real WORK plane:
announce, claim, lease, execute, complete, HLC/LWW merge. The bar is the
observable result: the coordinator ends with the path → cas_id map, the
object grouping and the journal vouches of a solo port pass over the
same seeded corpus, and those equal JAX's solo pass — under a peer that
dies mid-lease and under claim races too (the `p2p.steal` fault point).

A vanished peer's lease is re-pooled by moving the coordinator board's
injected clock past it, so no case waits out a lease. Every case runs
under its own asyncio timeout and shuts its Nodes down in `finally`.
"""

import asyncio
import os
import random
import time
import uuid

import pytest

from spacedrive_tpu_torch import telemetry
from spacedrive_tpu_torch.telemetry import counter_value
from spacedrive_tpu_torch.utils import faults


def _run(coro, timeout: float = 120.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# --- corpus and the observable state ----------------------------------------


def build_corpus(root: str, n: int = 48, seed: int = 7) -> None:
    """Mixed small files, an empty one and a >100 KiB sampled-message
    file, so shards cross the cas_id size classes."""
    rng = random.Random(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        size = rng.randrange(1, 4096)
        with open(os.path.join(root, f"f{i:04d}.bin"), "wb") as f:
            f.write(i.to_bytes(4, "little") + rng.randbytes(size))
    open(os.path.join(root, "empty.bin"), "wb").close()
    with open(os.path.join(root, "large.bin"), "wb") as f:
        f.write(rng.randbytes(150 * 1024))


def _key(r) -> str:
    return f"{r['materialized_path']}{r['name']}.{r['extension'] or ''}"


def content_map(lib, loc_id: int) -> dict:
    return {_key(r): r["cas_id"] for r in lib.db.query(
        "SELECT * FROM file_path WHERE location_id = ? AND is_dir = 0", (loc_id,))}


def object_grouping(lib, loc_id: int) -> dict:
    groups: dict = {}
    for r in lib.db.query(
            "SELECT fp.* FROM file_path fp JOIN object o ON o.id = fp.object_id "
            "WHERE fp.location_id = ? AND fp.is_dir = 0", (loc_id,)):
        groups.setdefault(r["cas_id"], set()).add(_key(r))
    return {cas: frozenset(v) for cas, v in groups.items()}


def journal_map(lib, loc_id: int, pkg: str = "port") -> dict:
    """journal key → (cas_id, chunk digests): the vouches a warm pass
    trusts."""
    if pkg == "jax":
        from spacedrive_tpu.location.indexer.journal import IndexJournal, key_of

        decode = IndexJournal(lib.db)._entry_of
    else:
        from spacedrive_tpu_torch.location.indexer.journal import entry_of_row as decode
        from spacedrive_tpu_torch.location.indexer.journal import key_of
    out = {}
    for row in lib.db.query("SELECT * FROM index_journal WHERE location_id = ?", (loc_id,)):
        entry = decode(row)
        assert entry is not None, "corrupt journal row"
        out[key_of(row)] = (entry.cas_id, tuple(entry.chunks.digests) if entry.chunks else None)
    return out


def _views(lib, loc_id, pkg="port"):
    return (content_map(lib, loc_id), object_grouping(lib, loc_id),
            journal_map(lib, loc_id, pkg))


_JAX_SOLO: dict = {}


async def jax_solo(tmp_path, corpus: str, key) -> tuple:
    """JAX's one-node pass over the corpus (IndexerJob then
    FileIdentifierJob on the CPU), cached per seeded corpus: the maps are
    keyed by path and content, not by where the corpus lies."""
    if key in _JAX_SOLO:
        return _JAX_SOLO[key]
    from spacedrive_tpu.jobs.manager import JobBuilder
    from spacedrive_tpu.location.indexer.job import IndexerJob
    from spacedrive_tpu.location.locations import LocationCreateArgs
    from spacedrive_tpu.node import Node
    from spacedrive_tpu.object.file_identifier.job import FileIdentifierJob

    node = Node(os.path.join(tmp_path, "jax-solo"), use_device=False, with_labeler=False)
    node.config.config.p2p.enabled = False
    await node.start()
    try:
        lib = await node.create_library("solo")
        loc = LocationCreateArgs(path=corpus).create(lib)
        for job_cls, init in ((IndexerJob, {"location_id": loc["id"]}),
                              (FileIdentifierJob, {"location_id": loc["id"], "backend": "cpu"})):
            await JobBuilder(job_cls(init)).spawn(node.jobs, lib)
            await node.jobs.wait_idle()
        _JAX_SOLO[key] = _views(lib, loc["id"], "jax")
        return _JAX_SOLO[key]
    finally:
        await node.shutdown()


async def port_solo(tmp_path, corpus: str) -> tuple:
    """A port Node with p2p off through the same entry point: every shard
    runs locally."""
    from spacedrive_tpu_torch.location.indexer.mesh import distribute_location_index
    from spacedrive_tpu_torch.location.locations import LocationCreateArgs
    from spacedrive_tpu_torch.node.node import Node

    node = Node(os.path.join(tmp_path, "port-solo"), device="cpu", with_labeler=False)
    node.config.config.p2p.enabled = False
    await node.start()
    try:
        lib = await node.create_library("solo")
        loc = LocationCreateArgs(path=corpus).create(lib)
        stats = await distribute_location_index(node, lib, loc["id"])
        assert stats["remote_shards"] == 0 and stats["peers"] == {}
        return _views(lib, loc["id"])
    finally:
        await node.shutdown()


async def references(tmp_path, corpus: str, key) -> tuple:
    """The port's solo pass, checked equal to JAX's."""
    want = await port_solo(tmp_path, corpus)
    assert want == await jax_solo(tmp_path, corpus, key)
    return want


def _vanished_clock():
    """A board clock that runs on time.monotonic until the worker's
    `p2p.steal` vanish shows on the work ring, then a lease past it."""
    from spacedrive_tpu_torch.telemetry.events import WORK_EVENTS

    def clock():
        gone = any(e["type"] == "worker_vanish" for e in WORK_EVENTS.snapshot())
        return time.monotonic() + (1e4 if gone else 0.0)

    return clock


async def distributed_pass(tmp_path, corpus: str, *, lease_max_s=10.0, shard_files=8,
                           clock=None):
    from spacedrive_tpu_torch.location.indexer.mesh import distribute_location_index
    from spacedrive_tpu_torch.location.locations import LocationCreateArgs
    from spacedrive_tpu_torch.p2p.loopback import make_mesh_pair

    a, b, lib_a, lib_b, _tasks = await make_mesh_pair(tmp_path)
    if clock is not None:
        a.p2p.work.board.clock = clock
    loc = LocationCreateArgs(path=corpus).create(lib_a)
    stats = await distribute_location_index(a, lib_a, loc["id"], shard_files=shard_files,
                                            lease_max_s=lease_max_s, deadline_s=90.0)
    return a, b, lib_a, lib_b, loc, stats


async def settle_replica(lib, loc_pub: bytes, expect: int, timeout_s: float = 15.0):
    """Wait until a replica holds every cas its peer's pass wrote."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        loc = lib.db.find_one("location", pub_id=loc_pub)
        if loc is not None and lib.db.query(
                "SELECT COUNT(*) AS n FROM file_path WHERE location_id = ? AND is_dir = 0 "
                "AND cas_id IS NOT NULL AND cas_id != ''", (loc["id"],))[0]["n"] >= expect:
            return loc
        if getattr(lib, "ingest", None) is not None:
            lib.ingest.notify()
        await asyncio.sleep(0.05)
    return lib.db.find_one("location", pub_id=loc_pub)


# --- the two-Node pass ----------------------------------------------------


def test_distributed_index_matches_single_node(tmp_path):
    """The peer steals shards through the WORK plane, and both replicas
    end with the solo pass's rows (the coordinator's object grouping and
    journal too)."""
    corpus = os.path.join(tmp_path, "corpus")
    build_corpus(corpus)

    async def run():
        telemetry.reset()
        ref_content, ref_groups, ref_journal = await references(tmp_path, corpus, (48, 7))
        telemetry.reset()
        a, b, lib_a, lib_b, loc, stats = await distributed_pass(tmp_path, corpus)
        try:
            assert stats["shards"] >= 6 and stats["remote_shards"] > 0, stats
            assert b.p2p.work.worker.executed_shards > 0
            assert counter_value("sd_work_shards_total", result="completed_remote",
                                 stage="identify.hash") > 0
            from spacedrive_tpu_torch.telemetry.peers import peer_label

            assert counter_value("sd_work_steals_total",
                                 peer=peer_label(str(b.p2p.p2p.remote_identity)),
                                 stage="identify.hash") > 0
            assert content_map(lib_a, loc["id"]) == ref_content
            assert object_grouping(lib_a, loc["id"]) == ref_groups
            assert journal_map(lib_a, loc["id"]) == ref_journal
            hashed = {k: v for k, v in ref_content.items() if v}
            b_loc = await settle_replica(lib_b, loc["pub_id"], len(hashed))
            assert b_loc is not None
            assert {k: v for k, v in content_map(lib_b, b_loc["id"]).items() if v} == hashed
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run())
    telemetry.reset()


def test_peer_death_mid_lease_converges(tmp_path):
    """The stealing peer dies after its first lease (`p2p.steal` vanish):
    its lease expires, the coordinator re-pools and re-executes the
    shards, and the result is still the solo pass's."""
    corpus = os.path.join(tmp_path, "corpus")
    build_corpus(corpus, n=32, seed=11)

    async def run():
        telemetry.reset()
        want = await references(tmp_path, corpus, (32, 11))
        telemetry.reset()
        plan = faults.FaultPlan.parse("p2p.steal:vanish:arg=lease,times=1")
        with faults.active(plan):
            a, b, lib_a, _lib_b, loc, stats = await distributed_pass(
                tmp_path, corpus, lease_max_s=5.0, shard_files=4, clock=_vanished_clock())
        try:
            assert plan.activations().get("p2p.steal", 0) == 1
            assert counter_value("sd_work_shards_total", result="expired",
                                 stage="identify.hash") >= 1
            assert _views(lib_a, loc["id"]) == want
            assert stats["local_shards"] + stats["remote_shards"] == stats["shards"]
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run())
    telemetry.reset()


def test_claim_race_double_execution_converges(tmp_path):
    """Every claim also double-leases an in-flight shard (`p2p.steal`
    race): shards run twice on different Nodes, deterministic object
    pub_ids and LWW make both executions write the same rows, and the
    duplicate completion is absorbed."""
    corpus = os.path.join(tmp_path, "corpus")
    build_corpus(corpus, n=32, seed=13)

    async def run():
        telemetry.reset()
        want = await references(tmp_path, corpus, (32, 13))
        telemetry.reset()
        plan = faults.FaultPlan.parse("p2p.steal:race:arg=claim,times=")
        with faults.active(plan):
            a, b, lib_a, _lib_b, loc, _stats = await distributed_pass(tmp_path, corpus)
        try:
            assert plan.activations().get("p2p.steal", 0) >= 1
            assert _views(lib_a, loc["id"]) == want
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run())
    telemetry.reset()


def test_distribute_without_p2p_degrades_to_local(tmp_path):
    """No P2P runtime: the entry point runs every shard locally and
    matches JAX's solo pass (the shard path is the identify path)."""
    corpus = os.path.join(tmp_path, "corpus")
    build_corpus(corpus, n=16, seed=17)

    async def run():
        telemetry.reset()
        await references(tmp_path, corpus, (16, 17))

    _run(run())
    telemetry.reset()


def test_deterministic_object_pub_ids():
    from spacedrive_tpu.object.file_identifier.link import object_pub_for as j_pub
    from spacedrive_tpu_torch.object.file_identifier.link import object_pub_for

    lib = uuid.UUID(int=3)
    cas = "aa" * 8
    assert object_pub_for(lib, cas) == object_pub_for(lib, cas) == j_pub(lib, cas)
    assert object_pub_for(lib, cas) != object_pub_for(lib, "bb" * 8)
    assert object_pub_for(uuid.UUID(int=4), cas) != object_pub_for(lib, cas)
    for i in range(16):
        assert object_pub_for(str(uuid.UUID(int=i)), f"{i:016x}") == \
            j_pub(str(uuid.UUID(int=i)), f"{i:016x}")


def test_pooled_shards_match_single_node(tmp_path, monkeypatch):
    """With the process pool live (SD_PROCS=2) a CPU coordinator hashes
    its shards' entries in pool workers (`identify.hash_entries`), keeps
    two shards in flight, and still ends with the solo pass's rows and
    journal."""
    from spacedrive_tpu_torch.parallel import procpool

    corpus = os.path.join(tmp_path, "corpus")
    build_corpus(corpus, n=48, seed=7)

    async def run():
        telemetry.reset()
        want = await references(tmp_path, corpus, (48, 7))
        monkeypatch.setenv("SD_PROCS", "2")
        assert procpool.POOL.start()
        try:
            telemetry.reset()
            got = await port_solo(tmp_path / "pooled", corpus)
            jobs = counter_value("sd_procpool_jobs_total", result="ok")
        finally:
            procpool.POOL.stop()
        assert got == want
        assert jobs > 0, "no shard entry went through the pool"

    _run(run())
    telemetry.reset()


# --- cross-node attribution (tests/test_attrib.py) --------------------------


def test_cross_node_trace_assembly(tmp_path):
    """A mesh-distributed identify pass is one trace: the coordinator's
    assembled report holds the peer's executor spans under its trace."""
    from spacedrive_tpu_torch.telemetry import attrib
    from spacedrive_tpu_torch.telemetry import trace as sdtrace

    corpus = os.path.join(tmp_path, "corpus")
    build_corpus(corpus, n=40)

    async def run():
        from spacedrive_tpu_torch.location.indexer.mesh import distribute_location_index
        from spacedrive_tpu_torch.location.locations import LocationCreateArgs
        from spacedrive_tpu_torch.p2p.loopback import make_mesh_pair

        a, b, lib_a, _lib_b, _tasks = await make_mesh_pair(tmp_path)
        try:
            loc = LocationCreateArgs(path=corpus).create(lib_a)
            ctx = sdtrace.new_context()
            with sdtrace.use(ctx):
                stats = await distribute_location_index(a, lib_a, loc["id"], shard_files=8,
                                                        lease_max_s=10.0, deadline_s=90.0)
            return stats, await attrib.assemble(a, ctx.trace_id, refresh=True)
        finally:
            await a.shutdown()
            await b.shutdown()

    telemetry.reset()
    stats, doc = _run(run())
    assert stats["remote_shards"] > 0, "the peer stole nothing"
    assert doc["partial"] is False
    assert doc["remote_spans"] > 0, doc
    assert [n for n in doc["nodes"] if n != "local"], doc["nodes"]
    assert doc["wall_seconds"] > 0
    assert sum(doc["buckets"].values()) == pytest.approx(doc["wall_seconds"], abs=1e-4)
    telemetry.reset()


def test_cross_node_assembly_degrades_on_peer_vanish(tmp_path):
    """`p2p.trace_pull` vanish: the peer closes the stream instead of
    serving its spans, and assembly returns a partial report with the
    failure recorded, quickly."""
    from spacedrive_tpu_torch.p2p import operations as _ops
    from spacedrive_tpu_torch.telemetry import attrib
    from spacedrive_tpu_torch.telemetry import trace as sdtrace

    corpus = os.path.join(tmp_path, "corpus")
    build_corpus(corpus, n=24)

    async def run():
        from spacedrive_tpu_torch.location.indexer.mesh import distribute_location_index
        from spacedrive_tpu_torch.location.locations import LocationCreateArgs
        from spacedrive_tpu_torch.p2p.loopback import make_mesh_pair

        a, b, lib_a, _lib_b, _tasks = await make_mesh_pair(tmp_path)
        try:
            loc = LocationCreateArgs(path=corpus).create(lib_a)
            ctx = sdtrace.new_context()
            with sdtrace.use(ctx):
                await distribute_location_index(a, lib_a, loc["id"], shard_files=8,
                                                lease_max_s=10.0, deadline_s=90.0)
            prev = _ops.TELEMETRY_TIMEOUT
            _ops.TELEMETRY_TIMEOUT = 1.5
            try:
                with faults.active(faults.FaultPlan.parse("p2p.trace_pull:vanish:times=inf")):
                    t0 = time.monotonic()
                    doc = await attrib.assemble(a, ctx.trace_id, refresh=True)
                    return doc, time.monotonic() - t0
            finally:
                _ops.TELEMETRY_TIMEOUT = prev
        finally:
            await a.shutdown()
            await b.shutdown()

    telemetry.reset()
    doc, elapsed = _run(run())
    assert doc["partial"] is True and doc["pull_failures"], doc
    assert doc["remote_spans"] == 0 and doc["spans"] > 0
    assert elapsed < 60.0
    assert counter_value("sd_attrib_pull_failures_total") >= 1
    telemetry.reset()


def test_a_card_shard_raises_without_the_card(tmp_path):
    """A shard asked to run on the card hashes through `cas_ids_begin`,
    and an embed stage shard forwards on it: on a host without one both
    raise, and neither writes a cas_id, an object, a vector or a vouch
    from a host fallback."""
    import numpy as np
    from PIL import Image

    from spacedrive_tpu_torch.location.indexer import mesh, stages

    corpus = os.path.join(tmp_path, "corpus")
    build_corpus(corpus, n=4, seed=3)
    Image.fromarray(np.full((20, 30, 3), 90, np.uint8)).save(os.path.join(corpus, "a.png"))

    async def run():
        from spacedrive_tpu_torch.jobs.manager import JobBuilder
        from spacedrive_tpu_torch.location.indexer.job import IndexerJob
        from spacedrive_tpu_torch.location.locations import LocationCreateArgs
        from spacedrive_tpu_torch.node.node import Node

        node = Node(os.path.join(tmp_path, "n"), device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            lib = await node.create_library("card")
            loc = LocationCreateArgs(path=corpus).create(lib)
            await JobBuilder(IndexerJob({"location_id": loc["id"]})).spawn(node.jobs, lib)
            await node.jobs.wait_idle()
            entries = mesh.build_shard_entries(lib, loc)
            with pytest.raises(Exception):
                await stages.execute_stage_shard(node, lib, loc["pub_id"].hex(),
                                                 "identify.hash", entries, "cuda")
            assert lib.db.count("file_path", "cas_id IS NOT NULL") == 0
            assert lib.db.count("object") == 0 and lib.db.count("index_journal") == 0
            await stages.execute_stage_shard(node, lib, loc["pub_id"].hex(), "identify.hash",
                                             entries)
            images = stages.build_stage_entries(lib, loc, "embed")
            assert len(images) == 1
            with pytest.raises(Exception):
                await stages.execute_stage_shard(node, lib, loc["pub_id"].hex(), "embed",
                                                 images, "cuda")
            assert lib.db.count("object_embedding") == 0
            assert lib.db.count("index_journal", "payload IS NOT NULL") >= 1
            from spacedrive_tpu_torch.location.indexer.journal import IndexJournal, key_of

            j = IndexJournal(lib.db)
            row = lib.db.find_one("file_path", name="a")
            assert not j.lookup(loc["id"], key_of(row), None, count=False)[1].embed
        finally:
            await node.shutdown()

    _run(run())
