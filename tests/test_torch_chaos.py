"""The fault plane driven through the port's seams, on CPU slot lists.

Ports of the JAX package's chaos and resilience tests
(tests/test_chaos.py, tests/test_resilience.py): injected device
failures demote the ladder and the result never changes; the search
query ranks on the host exactly as on the device and as the JAX host
path; the feeder restarts its producer once; the thumbnailer degrades a
chunk that failed past the ladder to the CPU resize; and an indexing
pass under every pipeline fault family gives the clean pass's cas_ids,
pixels and vectors. The ladder paths run on the CPU by pointing
`mesh.dispatch_devices` at a CPU slot list.

The port's counterpart of the red
`tests/test_chaos.py::test_index_pass_bit_identical_under_faults` is
`test_index_pass_under_faults_equals_the_clean_pass`, held to the clean
pass.
"""

import asyncio
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image

from spacedrive_tpu.object.search import index as jindex
from spacedrive_tpu.utils import faults as jfaults
from spacedrive_tpu_torch.index_pass import index_pass
from spacedrive_tpu_torch.object.media.thumbnail import actor as actor_mod
from spacedrive_tpu_torch.object.media.thumbnail.actor import Thumbnailer, ThumbnailerError
from spacedrive_tpu_torch.object.search import index as pindex
from spacedrive_tpu_torch.ops import blake3_cuda, cas, embed_torch
from spacedrive_tpu_torch.parallel import autotune, mesh
from spacedrive_tpu_torch.parallel.feeder import WindowPipeline
from spacedrive_tpu_torch.telemetry import metrics as tm
from spacedrive_tpu_torch.telemetry.events import FAULT_EVENTS, RESILIENCE_EVENTS
from spacedrive_tpu_torch.utils import faults

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_chaos_state():
    faults.clear()
    jfaults.clear()
    mesh.LADDER.reset()
    mesh.LADDER.reset_timeout = 30.0
    yield
    faults.clear()
    jfaults.clear()
    mesh.LADDER.reset()
    mesh.LADDER.reset_timeout = 30.0


def _slots(monkeypatch, k: int) -> None:
    monkeypatch.setattr(mesh, "dispatch_devices", lambda: [CPU] * k)


def _events(kind: str) -> list[dict]:
    return [e for e in RESILIENCE_EVENTS.snapshot() if e["type"] == kind]


# --- the embedder ------------------------------------------------------------


@pytest.mark.parametrize("mode", ["raise", "xla"])
def test_embed_fault_demotes_ladder_and_converges(monkeypatch, mode):
    _slots(monkeypatch, 4)
    imgs = np.random.default_rng(11).random((10, 32, 32, 3)).astype(np.float32)
    clean = embed_torch.embed_batch(imgs, "cpu")
    plan = faults.FaultPlan.parse(f"embed.forward:{mode}:times=2", seed=3)
    with faults.active(plan):
        out = embed_torch.embed_batch(imgs, "cpu")
    assert plan.activations() == {"embed.forward": 2}
    # the host rung ran one unsharded forward: the CPU's matmul blocks
    # by batch size, so allclose at the embedder's tolerance
    np.testing.assert_allclose(out, clean, atol=1e-5, rtol=1e-5)
    # two consecutive failures walked the ladder off the full set
    assert mesh.LADDER.level == mesh.LEVEL_HOST
    assert tm.DEVICE_DEMOTION.value() == float(mesh.LEVEL_HOST)


def test_embed_wrong_shape_trips_the_check_and_converges(monkeypatch):
    _slots(monkeypatch, 4)
    imgs = np.random.default_rng(12).random((6, 32, 32, 3)).astype(np.float32)
    clean = embed_torch.embed_batch(imgs, "cpu")
    with faults.active(faults.FaultPlan.parse("embed.forward:wrong_shape:times=1")):
        out = embed_torch.embed_batch(imgs, "cpu")
    np.testing.assert_allclose(out, clean, atol=1e-5, rtol=1e-5)
    assert mesh.LADDER.level == mesh.LEVEL_SUBSET


def test_embed_fault_on_a_pinned_device_raises():
    imgs = np.zeros((2, 32, 32, 3), np.float32)
    with faults.active(faults.FaultPlan.parse("embed.forward:xla:times=1")):
        with pytest.raises(RuntimeError, match="injected CUDA failure"):
            embed_torch.embed_batch(imgs, "cpu")
    assert mesh.LADDER.level == mesh.LEVEL_MESH


# --- the cas dispatch --------------------------------------------------------


def _msgs(n: int = 70) -> list[bytes]:
    rng = np.random.default_rng(n)
    return [rng.bytes(int(s)) for s in rng.integers(1, 3000, n)]


@pytest.mark.parametrize("mode", ["raise", "xla", "wrong_shape"])
def test_blake3_fault_retries_inside_finish_and_ids_never_change(monkeypatch, mode):
    _slots(monkeypatch, 4)
    msgs = _msgs()
    clean = cas.cas_ids(msgs, "cpu")
    before = tm.CAS_BACKEND_FALLBACK.value()
    plan = faults.FaultPlan.parse(f"device.blake3:{mode}:times=1")
    with faults.active(plan):
        fin = cas.cas_ids_begin(msgs, "cpu")
        ids = fin()
    assert ids == clean
    assert plan.activations() == {"device.blake3": 1}
    assert tm.CAS_BACKEND_FALLBACK.value() == before + 1
    # all four slots answer their probe: the survivors are the full set
    assert mesh.LADDER.level == mesh.LEVEL_SUBSET
    assert _events("device_demote")[-1]["fields"]["survivors"] == 4


def test_blake3_faults_at_every_rung_end_on_the_host_rung(monkeypatch):
    """Two failures walk the ladder to its last rung, where the JAX
    package hashes on the host: the port hashes on the caller's default
    device alone, strict, counted every time, and a failure there
    raises instead of moving the work to the CPU."""
    _slots(monkeypatch, 2)
    msgs = _msgs(40)
    clean = cas.cas_ids(msgs, "cpu")
    before = tm.CAS_BACKEND_FALLBACK.value()
    RESILIENCE_EVENTS.clear()
    seen = []
    real = cas.blake3_torch.hash_batch_begin

    def spy(arr, lens, c, slots):
        seen.append(list(slots))
        return real(arr, lens, c, slots)

    monkeypatch.setattr(cas.blake3_torch, "hash_batch_begin", spy)
    with faults.active(faults.FaultPlan.parse("device.blake3:xla:times=2")):
        assert cas.cas_ids(msgs, "cpu") == clean
    assert mesh.LADDER.level == mesh.LEVEL_HOST
    seen.clear()
    # a later call at the last rung runs on the default device, counted
    assert cas.cas_ids(msgs, "cpu") == clean
    assert seen and all(s == [CPU] for s in seen)
    with faults.active(faults.FaultPlan.parse("device.blake3:xla:times=inf")):
        with pytest.raises(RuntimeError, match="injected CUDA failure"):
            cas.cas_ids(msgs, "cpu")
    assert mesh.LADDER.level == mesh.LEVEL_HOST
    assert len(_events("cas_last_rung")) == 3
    # 2 demotions and 3 last-rung calls
    assert tm.CAS_BACKEND_FALLBACK.value() == before + 5


def test_explicit_devices_and_pinned_devices_stay_strict(monkeypatch):
    msgs = _msgs(8)
    with faults.active(faults.FaultPlan.parse("device.blake3:raise:times=inf")):
        with pytest.raises(faults.InjectedFault):
            cas.cas_ids(msgs, "cpu")  # no dispatch devices of the type: strict
        _slots(monkeypatch, 2)
        with pytest.raises(faults.InjectedFault):
            cas.cas_ids_begin(msgs, "cpu", devices=[CPU] * 2)()
    assert mesh.LADDER.level == mesh.LEVEL_MESH


def test_a_failed_kernel_build_raises_and_never_enters_the_ladder(monkeypatch):
    monkeypatch.setattr(mesh, "dispatch_devices", lambda: [torch.device("cuda", 0)])

    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(blake3_cuda, "build", broken)
    before = tm.CAS_BACKEND_FALLBACK.value()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cas.cas_ids([b"abc"], "cuda")
    assert mesh.LADDER.level == mesh.LEVEL_MESH
    assert tm.CAS_BACKEND_FALLBACK.value() == before


# --- search ------------------------------------------------------------------


def _index(pkg, matrix):
    idx = pkg.LibraryIndex(types.SimpleNamespace(node=None))
    idx._matrix = matrix
    idx._ids = [1000 + i for i in range(len(matrix))]
    idx._pos = {oid: i for i, oid in enumerate(idx._ids)}
    idx._loaded = True
    return idx


@pytest.mark.parametrize("mode", ["raise", "xla"])
def test_search_query_fault_host_fallback_ranks_identically(monkeypatch, mode):
    _slots(monkeypatch, 2)  # "cpu" rides the ladder, as "cuda" does on the card
    rng = np.random.default_rng(5)
    matrix = rng.standard_normal((300, 128)).astype(np.float32)
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    for src, dst in ((3, 40), (3, 41), (77, 200)):  # exact ties
        matrix[dst] = matrix[src]
    port, ref = _index(pindex, matrix), _index(jindex, matrix)
    RESILIENCE_EVENTS.clear()
    for probe in (matrix[3], matrix[77] * 2.0, rng.standard_normal(128).astype(np.float32)):
        device_hits = port.query(probe, k=12, device="cpu")
        host0 = tm.SEARCH_QUERIES.value(path="host")
        with faults.active(faults.FaultPlan.parse(f"search.query:{mode}:times=1")):
            host_hits = port.query(probe, k=12, device="cpu")
        with jfaults.active(jfaults.FaultPlan.parse(f"search.query:{mode}:times=1")):
            jax_host_hits = ref.query(probe, k=12)
        assert tm.SEARCH_QUERIES.value(path="host") == host0 + 1
        assert [h[0] for h in host_hits] == [h[0] for h in device_hits]
        assert [h[0] for h in host_hits] == [h[0] for h in jax_host_hits]
        np.testing.assert_allclose([h[1] for h in host_hits], [h[1] for h in device_hits],
                                   atol=1e-6)
        assert [h[1] for h in host_hits] == [h[1] for h in jax_host_hits]
    assert len(_events("search_host_rank")) == 3


@pytest.mark.parametrize("device", ["cpu", "cuda:0"])
def test_search_query_fault_on_a_pinned_device_raises(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    idx = _index(pindex, np.eye(4, 128, dtype=np.float32))
    host0 = tm.SEARCH_QUERIES.value(path="host")
    with faults.active(faults.FaultPlan.parse("search.query:xla:times=1")):
        with pytest.raises(RuntimeError, match="injected CUDA failure"):
            idx.query(np.ones(128, np.float32), k=2, device=device)
    assert tm.SEARCH_QUERIES.value(path="host") == host0


def test_search_on_missing_cuda_raises_without_a_host_query(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx = _index(pindex, np.eye(4, 128, dtype=np.float32))
    host0 = tm.SEARCH_QUERIES.value(path="host")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        idx.query(np.ones(128, np.float32), k=2, device="cuda")
    assert tm.SEARCH_QUERIES.value(path="host") == host0


# --- the feeder --------------------------------------------------------------


def _fetch(n):
    def fetch(cursor):
        if cursor >= n:
            return None
        return cursor + 1, [cursor]

    return fetch


def _drain(pipe):
    out = []
    while (w := pipe.take()) is not None:
        out.append(w[0])
    pipe.close()
    return out


def test_feeder_restarts_crashed_producer_once():
    before = tm.FEEDER_RESTARTS.value()
    with faults.active(faults.FaultPlan.parse("feeder.fetch:crash:times=1")):
        windows = _drain(WindowPipeline(_fetch(5), 0, depth=2))
    assert windows == [0, 1, 2, 3, 4]  # the crashed window was re-fetched
    assert tm.FEEDER_RESTARTS.value() == before + 1
    assert _events("feeder_restart")


def test_feeder_second_crash_surfaces():
    with faults.active(faults.FaultPlan.parse("feeder.fetch:crash:times=2")):
        pipe = WindowPipeline(_fetch(5), 0, depth=2)
        with pytest.raises(faults.InjectedFault):
            while pipe.take() is not None:
                pass
        pipe.close()


def test_feeder_stall_delays_but_completes():
    with faults.active(faults.FaultPlan.parse("feeder.fetch:stall:delay_s=0.05,times=1")):
        assert _drain(WindowPipeline(_fetch(3), 0, depth=2)) == [0, 1, 2]


# --- the thumbnailer -----------------------------------------------------------


def _make_images(d, n=5):
    entries = []
    rng = np.random.default_rng(2)
    for i, (w, h) in enumerate([(640, 480), (300, 900), (64, 64), (1200, 800), (333, 777)][:n]):
        path = str(d / f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(path)
        entries.append((f"{i:03x}cas{i:09x}", path, "png"))
    return entries


async def _thumbs(data_dir, entries, plan=None):
    th = Thumbnailer(data_dir, device="cpu")
    with faults.active(plan or faults.FaultPlan([])):
        await th.wait_batch(th.new_indexed_thumbnails_batch("lib", entries))
    out = {}
    for c, _, _ in entries:
        with open(th.store.path_for("lib", c), "rb") as f:
            out[c] = f.read()
    counts = (th.generated, th.errors)
    await th.shutdown()
    return out, counts


async def test_actor_degrades_a_chunk_past_the_ladder_to_the_cpu_resize(tmp_path, monkeypatch):
    _slots(monkeypatch, 2)
    entries = _make_images(tmp_path)
    clean, _ = await _thumbs(tmp_path / "clean", entries)
    RESILIENCE_EVENTS.clear()
    plan = faults.FaultPlan.parse("device.thumbnail:raise:times=inf")
    chaos, (generated, errors) = await _thumbs(tmp_path / "chaos", entries, plan)
    assert (generated, errors) == (len(entries), 0)
    assert plan.activations()["device.thumbnail"] >= 3  # every rung failed
    (event,) = _events("thumbnail_cpu_fallback")
    assert event["fields"] == {"entries": len(entries)}
    # the CPU resize is the same resize: the same pixels, the same webp
    assert chaos == clean


async def test_video_frames_keep_their_film_strip_past_the_ladder(tmp_path, monkeypatch):
    """A clip, its rotated copy, cover art and a PDF page through a chunk
    forced past the ladder: the `[cpu]` resize stores the clean run's
    bytes, each the encode of its frame with the film strip on the clips
    only."""
    from test_torch_decoders import _kinds

    from spacedrive_tpu_torch.object.media.thumbnail import process

    _slots(monkeypatch, 2)
    kinds = _kinds(tmp_path)
    names = [n for n in ("clip.mp4", "rot90.mov", "song.mpg", "vector.pdf") if n in kinds]
    entries = [(f"{i:03x}cas{i:09x}", *kinds[n]) for i, n in enumerate(names)]
    clean, _ = await _thumbs(tmp_path / "clean", entries)
    RESILIENCE_EVENTS.clear()
    plan = faults.FaultPlan.parse("device.thumbnail:raise:times=inf")
    chaos, (generated, errors) = await _thumbs(tmp_path / "chaos", entries, plan)
    assert (generated, errors) == (len(entries), 0) and _events("thumbnail_cpu_fallback")
    assert chaos == clean
    for (cas_id, path, ext), name in zip(entries, names):
        d = process.decode(path, ext)
        assert d.is_video == name.endswith((".mp4", ".mov"))
        (frame,) = process.resize_decoded([d], devices=[CPU])
        assert chaos[cas_id] == process.finish(d, frame)
        if d.is_video:
            assert chaos[cas_id] != process.encode_webp(np.ascontiguousarray(frame))


async def test_actor_on_a_pinned_device_still_fails_the_batch(tmp_path):
    entries = _make_images(tmp_path, 2)
    th = Thumbnailer(tmp_path / "data", device="cpu")
    RESILIENCE_EVENTS.clear()
    with faults.active(faults.FaultPlan.parse("device.thumbnail:xla:times=inf")):
        with pytest.raises(ThumbnailerError, match="injected CUDA failure"):
            await th.wait_batch(th.new_indexed_thumbnails_batch("lib", entries))
    assert not _events("thumbnail_cpu_fallback") and th.generated == 0
    await th.shutdown()


async def test_persist_crash_resumes_past_the_stored_prefix(tmp_path, monkeypatch):
    """A crash between a chunk's store and its accounting: a fresh actor
    resumes the persisted batch and skips the chunk already stored."""
    entries = _make_images(tmp_path, 4)
    th = Thumbnailer(tmp_path / "data", device="cpu")
    th.chunk_rows = 2
    crashed = []
    real = actor_mod.Thumbnailer._process_batch

    async def recording(self, batch):
        try:
            await real(self, batch)
        except faults.InjectedCrash:
            crashed.append(batch.id)
            self._save()  # the state a dying process leaves behind
            raise

    monkeypatch.setattr(actor_mod.Thumbnailer, "_process_batch", recording)
    with faults.active(faults.FaultPlan.parse("thumbnail.persist:crash:times=1")):
        th.new_indexed_thumbnails_batch("lib", entries)
        th._ensure_started()
        while not crashed:
            await asyncio.sleep(0.01)
    assert th.generated == 2
    monkeypatch.undo()
    fresh = Thumbnailer(tmp_path / "data", device="cpu")
    assert fresh.skipped == 2  # the stored chunk is not redone
    await fresh.wait_library_batch("lib")
    assert fresh.generated == 2
    assert all(fresh.store.exists("lib", c) for c, _, _ in entries)
    await fresh.shutdown()


# --- the whole pass ------------------------------------------------------------


def _build_corpus(root, seed: int = 7) -> None:
    rng = np.random.default_rng(seed)
    (root / "docs").mkdir(parents=True)
    (root / "docs" / "a.txt").write_bytes(b"hello chaos")
    (root / "docs" / "b.txt").write_bytes(b"hello chaos")
    (root / "big.bin").write_bytes(rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes())
    (root / "mid.bin").write_bytes(rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes())
    (root / "empty.txt").write_bytes(b"")
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (48 + 8 * i, 64, 3), dtype=np.uint8),
                        "RGB").save(root / f"img{i}.png")


FAULT_FAMILIES = ("device.blake3:xla:times=1;device.thumbnail:raise:times=1;"
                  "embed.forward:xla:times=1;feeder.fetch:crash:times=1")


def _webps(result) -> dict[str, bytes]:
    out = {}
    for cas_id, path in result.thumbnails.items():
        with open(path, "rb") as f:
            out[cas_id] = f.read()
    return out


@pytest.mark.parametrize("k", [1, 2])
def test_index_pass_under_faults_equals_the_clean_pass(tmp_path, monkeypatch, k):
    """Every pipeline fault family at once (the plan chip_smoke.py runs on
    the card): the pass completes with the clean pass's cas_ids, pixels
    and vectors. With one slot the ladder ends at the subset rung, the
    one-device script of tests/test_torch_mesh.py."""
    _slots(monkeypatch, k)
    # windows of 3 files: the 9-file corpus feeds the pipeline 3 windows
    monkeypatch.setattr(autotune, "IDENTIFY_DEVICE_WINDOW", 3)
    corpus = tmp_path / "corpus"
    _build_corpus(corpus)
    clean = index_pass(corpus, tmp_path / "clean", device="cpu", keep_pixels=True)
    assert len([c for c in clean.cas_ids.values() if c]) >= 7
    assert len(clean.thumbnails) == 4

    mesh.LADDER.reset_timeout = 0.0
    FAULT_EVENTS.clear()
    fallback0, restarts0 = tm.CAS_BACKEND_FALLBACK.value(), tm.FEEDER_RESTARTS.value()
    plan = faults.FaultPlan.parse(FAULT_FAMILIES, seed=1)
    with faults.active(plan):
        chaos = index_pass(corpus, tmp_path / "chaos", device="cpu", keep_pixels=True)

    assert chaos.cas_ids == clean.cas_ids
    assert chaos.resized.keys() == clean.resized.keys()
    for c, arr in clean.resized.items():
        assert np.array_equal(chaos.resized[c], arr)
    assert _webps(chaos) == _webps(clean)
    assert chaos.embeddings.keys() == clean.embeddings.keys()
    for c, vec in clean.embeddings.items():
        np.testing.assert_allclose(chaos.embeddings[c], vec, atol=1e-5, rtol=1e-5)
    assert plan.activations() == {"device.blake3": 1, "device.thumbnail": 1,
                                  "embed.forward": 1, "feeder.fetch": 1}
    assert len([e for e in FAULT_EVENTS.snapshot() if e["type"] == "injected"]) == 4
    assert tm.FEEDER_RESTARTS.value() == restarts0 + 1
    assert tm.CAS_BACKEND_FALLBACK.value() >= fallback0 + 1
    if k == 1:
        assert mesh.LADDER.level == mesh.LEVEL_SUBSET
    assert os.path.isdir(tmp_path / "chaos")
