"""One mesh of a JAX Node and a port Node: the work plane both ways.

A JAX coordinator with a port worker, and a port coordinator with a JAX
worker, each pair on 127.0.0.1 over Noise TCP with unicast beacons, the
worker joined to the coordinator's library by pairing. The coordinator
distributes a location's identify; the worker claims and executes
shards over the WORK wire and completes them; the coordinator ends with
the rows, object grouping and journal vouches of a solo pass, JAX's and
the port's alike.

A JAX library's own instance row keeps the random identity JAX's
`Libraries.create` writes, so a joiner's membership gate refuses the
JAX owner's announce (the port writes the node's identity there,
`P2PManager.register_library`). Where JAX coordinates, the case writes
the owner's identity into the joiner's instance row, as JAX's own mesh
tests do (`p2p/loopback.make_mesh_pair`).

Every case runs under its own asyncio timeout and shuts its Nodes down
in `finally`.
"""

import asyncio

import pytest

import spacedrive_tpu.telemetry as j_telemetry
import spacedrive_tpu_torch.telemetry as p_telemetry
from test_torch_mesh_indexing import _views, build_corpus, jax_solo, port_solo
from test_torch_p2p_mixed import MIXED, _ident, _pair_of


def _run(coro, timeout: float = 150.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _pkg_of(node) -> str:
    return "port" if type(node).__module__.startswith("spacedrive_tpu_torch") else "jax"


@pytest.mark.parametrize("coordinator,worker", MIXED)
def test_mixed_mesh_identify_equals_solo(tmp_path, coordinator, worker):
    corpus = str(tmp_path / "corpus")
    build_corpus(corpus, n=40, seed=19)

    async def run():
        want = await port_solo(tmp_path, corpus)
        assert want == await jax_solo(tmp_path, corpus, (40, 19))
        a, b = await _pair_of(tmp_path, coordinator, worker)
        try:
            lib_a = await a.create_library("mesh")
            a.p2p.pairing.auto_accept = True
            lib_b = await b.p2p.pairing.join(b.p2p.p2p, _ident(b, a), lib_a.id)
            if coordinator == "jax":
                lib_b.db.execute("UPDATE instance SET identity = ? WHERE pub_id != ?",
                                 (_ident(b, a).to_bytes(), lib_b.instance_uuid.bytes))
                from spacedrive_tpu.location.indexer.mesh import distribute_location_index
                from spacedrive_tpu.location.locations import LocationCreateArgs
            else:
                from spacedrive_tpu_torch.location.indexer.mesh import distribute_location_index
                from spacedrive_tpu_torch.location.locations import LocationCreateArgs
            loc = LocationCreateArgs(path=corpus).create(lib_a)
            for _ in range(400):
                if lib_b.db.find_one("location", pub_id=loc["pub_id"]) is not None:
                    break
                await a.p2p._alert_peers(lib_a.id)
                await asyncio.sleep(0.02)
            stats = await distribute_location_index(a, lib_a, loc["id"], shard_files=4,
                                                    lease_max_s=30.0, deadline_s=120.0)
            assert stats["remote_shards"] > 0, stats
            assert b.p2p.work.worker.executed_shards > 0
            assert _views(lib_a, loc["id"], _pkg_of(a)) == want
        finally:
            await a.shutdown()
            await b.shutdown()

    _run(run())
    p_telemetry.reset()
    j_telemetry.reset()
