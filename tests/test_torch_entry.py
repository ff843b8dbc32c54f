"""The port-side entry points and the indexed-device scan.

- `entry()`: LabelerNet's forward at tiny shapes, finite logits of the
  80 classes, equal to the same net's forward in a second call;
- `dryrun_multichip(n)`: one training step and one K1 batch over a slot
  list of n (CPU slots, asked for), the step's loss equal to the one-slot
  loss and every digest equal to `blake3_ref`;
- `procpool.rig_stamp` equals the JAX package's under the same
  `SD_PROCS`;
- the bench leg (`python -m spacedrive_tpu_torch.bench`): `hash_batch`
  at the large cas bucket, checked against `blake3_ref`;
- a Node on an indexed device ("cpu:0") hands that device to its scan
  jobs through the router, and the jobs pin it; a backend of another
  type is refused.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

from spacedrive_tpu.parallel import procpool as jprocpool
from spacedrive_tpu_torch import bench, entry
from spacedrive_tpu_torch.parallel import procpool


def test_entry_is_the_labeler_forward_at_tiny_shapes():
    fn, args = entry.entry("cpu")
    (images,) = args
    assert images.shape == (entry.TINY_BATCH, entry.TINY_IMAGE, entry.TINY_IMAGE, 3)
    out = fn(*args)
    assert out.shape == (entry.TINY_BATCH, 80) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    fn2, args2 = entry.entry("cpu")
    assert torch.equal(fn2(*args2), out)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_over_cpu_slots(n):
    assert entry.slot_list(n, "cpu") == [torch.device("cpu")] * n
    done = entry.dryrun_multichip(n, device="cpu")
    assert done["devices"] == ["cpu"] * n
    assert np.isfinite(done["loss"]) and done["hashed_rows"] == 2 * n


@pytest.mark.parametrize("procs", ["0", "3"])
def test_rig_stamp_equals_jax(monkeypatch, procs):
    monkeypatch.setenv("SD_PROCS", procs)
    assert procpool.rig_stamp() == jprocpool.rig_stamp()
    assert procpool.rig_stamp()["procpool_procs"] == int(procs)


def test_bench_leg_hashes_the_large_bucket(capsys):
    assert bench.main(["--files", "8", "--repeats", "2", "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["device"] == "cpu" and doc["files"] == 8
    assert doc["batch_bytes"] == 8 * 57_352
    assert doc["ms_per_batch"] > 0 and doc["files_per_s"] > 0
    assert doc["k1_launches"] == 0  # the plain version on the CPU


def test_dryrun_multichip_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.dryrun_multichip(2)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        entry.slot_list(2, "meta")


# --- a Node on an indexed device -------------------------------------------------


def test_check_backend_accepts_indexed_devices_only_of_its_types():
    from spacedrive_tpu_torch.jobs.job import JobError
    from spacedrive_tpu_torch.object.file_identifier.job import check_backend

    assert check_backend("cpu:0") == "cpu:0"
    assert check_backend("cuda:1") == "cuda:1"
    assert check_backend(torch.device("cuda")) == "cuda"
    for bad in ("tpu", "auto", "meta", "cuda:x", None):
        with pytest.raises(JobError, match="backend must be one of"):
            check_backend(bad)


def test_a_node_on_an_indexed_device_scans_on_it(tmp_path, monkeypatch):
    from spacedrive_tpu_torch.location import locations
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.ops import cas

    corpus = os.path.join(tmp_path, "corpus")
    os.makedirs(corpus)
    rng = np.random.default_rng(1)
    for i in range(5):
        with open(os.path.join(corpus, f"f{i}.bin"), "wb") as f:
            f.write(rng.integers(0, 256, 110_000 if i % 2 else 900, np.uint8).tobytes())

    seen = []
    real_scan = locations.scan_location

    async def recording(library, loc, jobs, backend="cuda", **kw):
        seen.append(backend)
        return await real_scan(library, loc, jobs, backend=backend, **kw)

    # the procedures import it from the module at call time
    monkeypatch.setattr(locations, "scan_location", recording)
    pinned = []
    real_begin = cas.cas_ids_begin

    def begin(messages, device="cuda", *a, **kw):
        pinned.append(str(device))
        return real_begin(messages, device, *a, **kw)

    monkeypatch.setattr(cas, "cas_ids_begin", begin)

    async def run():
        node = Node(os.path.join(tmp_path, "node"), device="cpu:0", with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            r = node.router
            lid = (await r.exec(node, "library.create", {"name": "pinned"}))["uuid"]
            library = next(iter(node.libraries.libraries.values()))
            await r.exec(node, "locations.create", {"path": corpus}, library_id=lid)
            await node.jobs.wait_idle()
            rows = library.db.query("SELECT name, cas_id FROM file_path WHERE is_dir = 0 "
                                    "AND extension = 'bin'")
            reports = {r["name"]: r["status"] for r in library.db.query("SELECT * FROM job")}
        finally:
            await node.shutdown()
        return rows, reports

    rows, reports = asyncio.run(run())
    assert seen == ["cpu:0"]
    assert pinned and set(pinned) == {"cpu:0"}
    assert set(reports) >= {"indexer", "file_identifier", "media_processor"}
    want = {f"f{i}": cas.cas_id_cpu(os.path.join(corpus, f"f{i}.bin")) for i in range(5)}
    assert {r["name"]: r["cas_id"] for r in rows} == want
