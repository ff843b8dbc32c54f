"""The execution continuum in the port: twins of tests/test_continuum.py's
two-Node stage sessions, and the stage legs held to JAX's.

- two port Nodes over the in-process duplex (`p2p/loopback.py`) run a
  distributed identify, then one session of thumb, media.extract, phash
  and embed shards: the coordinator ends with the webp bytes, media_data
  rows, pHash bits, vectors and journal vouches of a solo port pass,
  and the peer really executed stage shards; also under a peer that
  dies mid-lease and under claim races (the `p2p.steal` fault point);
- a solo port pass against JAX's solo pass on the same seeded corpus,
  each through its package's `distribute_location_stages`: thumbnail
  dims equal and pixels within one level, media_data rows equal, pHash
  bits equal but for counted flips, vectors within 1e-5 (`PERF.md` §2).

A vanished peer's lease is re-pooled by moving the coordinator board's
injected clock past it. Every case runs under its own asyncio timeout
and shuts its Nodes down in `finally`.
"""

import asyncio
import contextlib
import io
import os
import time

import numpy as np
from PIL import Image

import spacedrive_tpu.telemetry as j_telemetry
from spacedrive_tpu_torch import telemetry
from spacedrive_tpu_torch.telemetry import counter_value
from spacedrive_tpu_torch.utils import faults

STAGES = ["thumb", "media.extract", "phash", "embed"]


def _run(coro, timeout: float = 150.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def build_image_corpus(root: str, n: int = 12, seed: int = 5) -> None:
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        arr = rng.integers(0, 256, (40 + 8 * (i % 5), 64, 3), np.uint8)
        Image.fromarray(arr).save(os.path.join(root, f"img{i:03d}.png"))
    # a smooth JPEG, so the pHash leg meets a real image too
    y, x = np.mgrid[0:96, 0:128]
    smooth = np.stack([x * 2, y * 2, (x + y)], -1).astype(np.uint8)
    Image.fromarray(smooth).save(os.path.join(root, "smooth.jpg"), quality=90)


def stage_views(node, lib, loc_id: int, pkg: str = "port") -> dict:
    """cas_id → webp bytes, media_data row, pHash, vector blob; journal
    key → (cas_id, thumb, media vouched, pHash, embed). A media digest
    covers the replica's own object_id, so only its presence compares."""
    if pkg == "jax":
        from spacedrive_tpu.location.indexer.journal import IndexJournal, key_of

        decode = IndexJournal(lib.db)._entry_of
    else:
        from spacedrive_tpu_torch.location.indexer.journal import entry_of_row as decode
        from spacedrive_tpu_torch.location.indexer.journal import key_of
    rows = lib.db.query(
        "SELECT fp.cas_id, o.phash AS ph, oe.vector AS vec FROM file_path fp "
        "JOIN object o ON o.id = fp.object_id LEFT JOIN object_embedding oe "
        "ON oe.object_id = o.id WHERE fp.location_id = ? AND fp.is_dir = 0", (loc_id,))
    store = node.thumbnailer.store
    webp = {}
    for r in rows:
        path = store.path_for(str(lib.id), r["cas_id"])
        webp[r["cas_id"]] = open(path, "rb").read() if os.path.exists(path) else None
    media = {r["cas_id"]: tuple(sorted((k, v) for k, v in r.items()
                                       if k not in ("id", "object_id", "cas_id")))
             for r in lib.db.query("SELECT fp.cas_id, md.* FROM file_path fp JOIN media_data md "
                                   "ON md.object_id = fp.object_id WHERE fp.location_id = ?",
                                   (loc_id,))}
    vouches = {}
    for row in lib.db.query("SELECT * FROM index_journal WHERE location_id = ?", (loc_id,)):
        e = decode(row)
        assert e is not None, "corrupt journal row"
        vouches[key_of(row)] = (e.cas_id, e.thumb, e.media_digest is not None, e.phash, e.embed)
    return {"webp": webp, "media": media, "phash": {r["cas_id"]: r["ph"] for r in rows},
            "vectors": {r["cas_id"]: r["vec"] for r in rows}, "journal": vouches}


def assert_vectors_close(got: dict, want: dict, atol: float = 1e-5) -> None:
    assert set(got) == set(want)
    for cas, blob in want.items():
        assert blob is not None and got[cas] is not None, cas
        a, b = np.frombuffer(got[cas], np.float32), np.frombuffer(blob, np.float32)
        assert a.shape == b.shape and np.abs(a - b).max() <= atol, cas


def assert_same_result(got: dict, want: dict) -> None:
    for part in ("webp", "media", "phash", "journal"):
        assert got[part] == want[part], part
    assert all(v is not None for v in want["webp"].values())
    assert_vectors_close(got["vectors"], want["vectors"])


async def solo_pass(tmp_path, corpus: str, pkg: str = "port") -> dict:
    """One Node with p2p off: identify, then the four stages, through its
    package's distribute entry points (every shard runs locally)."""
    if pkg == "jax":
        from spacedrive_tpu.location.indexer.mesh import (
            distribute_location_index,
            distribute_location_stages,
        )
        from spacedrive_tpu.location.locations import LocationCreateArgs
        from spacedrive_tpu.node import Node

        node = Node(os.path.join(tmp_path, "jax-solo"), use_device=False, with_labeler=False)
    else:
        from spacedrive_tpu_torch.location.indexer.mesh import (
            distribute_location_index,
            distribute_location_stages,
        )
        from spacedrive_tpu_torch.location.locations import LocationCreateArgs
        from spacedrive_tpu_torch.node.node import Node

        node = Node(os.path.join(tmp_path, "port-solo"), device="cpu", with_labeler=False)
    node.config.config.p2p.enabled = False
    await node.start()
    try:
        lib = await node.create_library("solo")
        loc = LocationCreateArgs(path=corpus).create(lib)
        await distribute_location_index(node, lib, loc["id"])
        stats = await distribute_location_stages(node, lib, loc["id"], STAGES, shard_files=3)
        assert stats["remote_shards"] == 0 and set(stats["stages"]) == set(STAGES)
        return stage_views(node, lib, loc["id"], pkg)
    finally:
        await node.shutdown()


def _vanished_clock():
    from spacedrive_tpu_torch.telemetry.events import WORK_EVENTS

    def clock():
        gone = any(e["type"] == "worker_vanish" for e in WORK_EVENTS.snapshot())
        return time.monotonic() + (1e4 if gone else 0.0)

    return clock


async def two_node_pass(tmp_path, corpus: str, *, lease_max_s=10.0, shard_files=2,
                        fault_plan=None):
    """Distributed identify, then the four-stage session (under
    `fault_plan` when given). The caller shuts the Nodes down."""
    from spacedrive_tpu_torch.location.indexer.mesh import (
        distribute_location_index,
        distribute_location_stages,
    )
    from spacedrive_tpu_torch.location.locations import LocationCreateArgs
    from spacedrive_tpu_torch.p2p.loopback import make_mesh_pair

    a, b, lib_a, _lib_b, _tasks = await make_mesh_pair(tmp_path)
    loc = LocationCreateArgs(path=corpus).create(lib_a)
    await distribute_location_index(a, lib_a, loc["id"], shard_files=shard_files,
                                    deadline_s=90.0)
    a.p2p.work.board.clock = _vanished_clock()
    with faults.active(fault_plan) if fault_plan is not None else contextlib.nullcontext():
        stats = await distribute_location_stages(a, lib_a, loc["id"], STAGES,
                                                 shard_files=shard_files,
                                                 lease_max_s=lease_max_s, deadline_s=90.0)
    return a, b, lib_a, loc, stats


def test_two_node_stages_equal_solo(tmp_path):
    """The continuum's acceptance loop: a two-Node session of the four
    stages ends with the solo pass's webp bytes, media_data rows, pHash
    bits, journal vouches and vectors, and the peer really executed
    stage shards and reports per-stage rates."""
    corpus = os.path.join(tmp_path, "corpus")
    build_image_corpus(corpus)

    async def run():
        telemetry.reset()
        want = await solo_pass(tmp_path, corpus)
        telemetry.reset()
        a, b, lib_a, loc, stats = await two_node_pass(tmp_path, corpus)
        try:
            assert all(stats["stages"][st] >= 2 for st in STAGES), stats
            assert stats["remote_shards"] > 0 and b.p2p.work.worker.executed_shards > 0
            assert sum(counter_value("sd_work_shards_total", result="completed_remote", stage=st)
                       for st in STAGES) > 0
            rates = b.p2p.work.worker.rates_report()
            assert any(rates.get(st, 0) > 0 for st in STAGES), rates
            assert_same_result(stage_views(a, lib_a, loc["id"]), want)
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run())
    telemetry.reset()


def test_stage_peer_death_mid_lease_converges(tmp_path):
    """The stealing peer vanishes after its first stage lease: the lease
    expires, the coordinator re-executes the abandoned stage shards, and
    the result is still the solo pass's."""
    corpus = os.path.join(tmp_path, "corpus")
    build_image_corpus(corpus, n=10, seed=23)

    async def run():
        telemetry.reset()
        want = await solo_pass(tmp_path, corpus)
        telemetry.reset()
        plan = faults.FaultPlan.parse("p2p.steal:vanish:arg=lease,times=1")
        a, b, lib_a, loc, stats = await two_node_pass(tmp_path, corpus, lease_max_s=5.0,
                                                      fault_plan=plan)
        try:
            assert plan.activations().get("p2p.steal", 0) == 1
            assert sum(counter_value("sd_work_shards_total", result="expired", stage=st)
                       for st in STAGES) >= 1
            assert stats["local_shards"] + stats["remote_shards"] == stats["shards"]
            assert_same_result(stage_views(a, lib_a, loc["id"]), want)
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run())
    telemetry.reset()


def test_stage_claim_race_double_execution_converges(tmp_path):
    """Every stage claim double-leases an in-flight shard: stage shards
    run twice on different Nodes, deterministic encoders and the seeded
    forward make both ship the same results, and the duplicate is
    absorbed."""
    corpus = os.path.join(tmp_path, "corpus")
    build_image_corpus(corpus, n=10, seed=29)

    async def run():
        telemetry.reset()
        want = await solo_pass(tmp_path, corpus)
        telemetry.reset()
        plan = faults.FaultPlan.parse("p2p.steal:race:arg=claim,times=")
        a, b, lib_a, loc, _stats = await two_node_pass(tmp_path, corpus, fault_plan=plan)
        try:
            assert plan.activations().get("p2p.steal", 0) >= 1
            assert_same_result(stage_views(a, lib_a, loc["id"]), want)
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run())
    telemetry.reset()


def _pixels(webp: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(webp)) as im:
        return np.asarray(im.convert("RGBA"), np.int16)


def _phash_flips(got: bytes, want: bytes) -> int:
    return int(np.unpackbits(np.frombuffer(bytes(a ^ b for a, b in zip(got, want)),
                                           np.uint8)).sum())


def test_stage_legs_against_jax(tmp_path):
    """A solo port pass of the four stages against JAX's solo pass on the
    same seeded corpus: thumbnail dims equal and pixels within one level,
    media_data rows equal, pHash bits equal but for counted flips, and
    vectors within 1e-5; the journal vouches the same stages."""
    corpus = os.path.join(tmp_path, "corpus")
    build_image_corpus(corpus, n=8, seed=31)

    async def run():
        telemetry.reset()
        got = await solo_pass(tmp_path, corpus)
        want = await solo_pass(tmp_path, corpus, "jax")
        assert set(got["webp"]) == set(want["webp"]) and len(want["webp"]) == 9
        for cas, blob in want["webp"].items():
            a, b = _pixels(got["webp"][cas]), _pixels(blob)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, cas
        assert got["media"] == want["media"] and len(want["media"]) == 9
        flips = sum(_phash_flips(got["phash"][c], want["phash"][c]) for c in want["phash"])
        assert flips <= 1, f"{flips} pHash bits flipped"
        assert_vectors_close(got["vectors"], want["vectors"])
        assert got["journal"] == want["journal"]

    _run(run())
    telemetry.reset()
    j_telemetry.reset()  # JAX's process-wide stage rates, fed by its pass
