"""CRDT property tests of the port's sync ingest: tests/test_sync_properties.py
pointed at port instances, and at meshes of one JAX instance among port
instances (the wire between them is the packed compressed batch; see
tests/test_torch_sync_ingest.py's `Instance`).

Randomized op interleavings over a 3-node mesh: each schedule drives 3
in-process instances (real in-memory SQLite, loopback transport)
through a random interleaving of creates / field updates / deletes /
relation links across random topologies, with partial settles mixed
in, then asserts:

1. convergence — every node materializes identical rows;
2. LWW — for every undeleted (model, record, field) the materialized
   value equals the op-log winner by (HLC timestamp, instance id), the
   exact tiebreak ingest uses (ref:ingest.rs:169-192);
3. delete dominance — records whose op log ends in a globally-latest
   delete materialize on no node.

Default run: 30 schedules each on port meshes and on mixed meshes.
`-m slow` (or SD_CRDT_SCHEDULES=N) runs the full 200 on port meshes.
"""

import asyncio
import os
import random
import uuid

import pytest

from test_torch_sync_ingest import Instance, connect, settle, stop

FIELDS = ("name", "color")

TOPOLOGIES = (
    ((0, 1), (1, 2)),           # chain (relay through the middle)
    ((0, 1), (0, 2)),           # hub
    ((0, 1), (1, 2), (0, 2)),   # full mesh
)


def _op_key(op):
    """Global LWW order: (HLC timestamp, instance id) — ingest's
    tiebreak (ref:ingest.rs is_operation_old)."""
    return (int(op.timestamp), op.instance.bytes)


async def _run_schedule(seed: int, pkgs=("port", "port", "port")) -> None:
    rng = random.Random(seed)
    insts = [Instance(pkg, f"n{i}-{seed}") for i, pkg in enumerate(pkgs)]
    for i, j in rng.choice(TOPOLOGIES):
        connect(insts[i], insts[j])

    records: list[str] = []
    for step in range(rng.randint(12, 24)):
        node = rng.choice(insts)
        roll = rng.random()
        if roll < 0.30 or not records:
            pub = uuid.UUID(int=rng.getrandbits(128)).bytes.hex()
            records.append(pub)
            node.sync.write_ops(
                node.sync.shared_create(
                    "tag", pub, [("name", f"t{step}"), ("color", "#000000")]
                )
            )
        elif roll < 0.72:
            node.sync.write_ops([
                node.sync.shared_update(
                    "tag", rng.choice(records), rng.choice(FIELDS),
                    f"s{step}-{rng.randrange(1000)}",
                )
            ])
        elif roll < 0.82:
            node.sync.write_ops([
                node.sync.shared_delete("tag", rng.choice(records))
            ])
        elif roll < 0.92 and records:
            # relation ops: tag_on_object-style composite record id
            node.sync.write_ops(
                node.sync.relation_create(
                    "tag_on_object",
                    {"tag": rng.choice(records), "object": rng.randrange(4)},
                )
            )
        else:
            # partial settle mid-schedule: one random actor drains
            await rng.choice(insts).actor.wait_idle()
        if rng.random() < 0.2:
            await asyncio.sleep(0)  # vary task interleaving

    await settle(*insts)

    # --- 1. convergence of MATERIALIZED ROWS — the CRDT guarantee.
    # (Op logs may legally differ: like the reference, ingest drops a
    # superseded op — same model/record/kind with a newer stored op —
    # without storing it, ref:ingest.rs:169-192.)
    def materialized(inst):
        return {
            row["pub_id"].hex(): (row["name"], row["color"])
            for row in inst.db.find("tag")
        }

    views = [materialized(inst) for inst in insts]
    assert views[0] == views[1] == views[2], f"rows diverged (seed {seed})"

    # --- 2 + 3. LWW oracle over the UNION of all op logs (each node
    # may hold a different superseded-op subset, but every op that
    # ever existed is in the union since originators keep their own)
    seen: dict = {}
    for inst in insts:
        for o in inst.sync.get_ops(count=100_000):
            seen[(int(o.timestamp), o.instance.bytes, o.model,
                  str(o.record_id), o.kind())] = o
    ops = list(seen.values())
    by_record: dict[str, list] = {}
    for op in ops:
        if op.model == "tag":
            by_record.setdefault(str(op.record_id), []).append(op)
    view = views[0]
    for rec, rec_ops in by_record.items():
        deletes = [o for o in rec_ops if o.kind() == "d"]
        latest_delete = max(map(_op_key, deletes)) if deletes else None
        if latest_delete is not None and latest_delete >= max(
            map(_op_key, rec_ops)
        ):
            assert rec not in view, f"deleted record survived (seed {seed})"
            continue
        if latest_delete is not None:
            continue  # delete/update race: convergence already asserted
        assert rec in view, f"record missing (seed {seed})"
        for idx, fname in enumerate(FIELDS):
            updates = [
                o for o in rec_ops
                if o.kind() == f"u:{fname}"
            ]
            if not updates:
                continue
            winner = max(updates, key=_op_key)
            assert view[rec][idx] == winner.data.value, (
                f"LWW violated for {fname} (seed {seed}): "
                f"have {view[rec][idx]!r}, want {winner.data.value!r}"
            )
    await stop(*insts)


def _n_schedules(default: int) -> int:
    return int(os.environ.get("SD_CRDT_SCHEDULES", default))


def _mixed(seed: int) -> tuple[str, str, str]:
    """One JAX instance among port ones, at a seed-chosen place."""
    pkgs = ["port", "port", "port"]
    pkgs[seed % 3] = "jax"
    return tuple(pkgs)


@pytest.mark.asyncio
async def test_random_schedules_quick():
    for seed in range(_n_schedules(30)):
        await _run_schedule(seed)


@pytest.mark.asyncio
async def test_random_schedules_quick_mixed_mesh():
    for seed in range(_n_schedules(30)):
        await _run_schedule(seed, _mixed(seed))


@pytest.mark.slow
@pytest.mark.asyncio
async def test_random_schedules_full():
    for seed in range(1000, 1000 + _n_schedules(200)):
        await _run_schedule(seed)
