"""Sharded dispatch over CPU slot lists, `[cpu] * k` for k = 1..5.

The port splits a batch's rows into one equal share per slot; the hash,
the resize and the embedder compute each row alone, so a k-way split
must give what one device gives:

- cas_ids bit-identical to the single-device path and to the
  pure-Python `blake3_ref`, at row counts that leave pad rows; a row
  count that does not divide over the slots raises;
- resized pixels exactly equal to k = 1, and within one level of the
  JAX single-device resize (the tolerance of tests/test_torch_thumbnail);
- embeddings within 1e-5 of k = 1 and of the JAX embedder (the
  tolerance of tests/test_torch_embed: the CPU's matmul blocks by
  batch size, so the shares round in another order);
- `hamming_matrix_sharded` exactly JAX's `hamming_matrix`.

JAX's own sharded cas path (`tests/test_sharded_ops.py`) is red and is
not used as an oracle.
"""

import jax
import numpy as np
import pytest
import torch

from spacedrive_tpu.ops import embed_jax, phash_jax
from spacedrive_tpu.ops import thumbnail_jax as tj
from spacedrive_tpu_torch.ops import blake3_torch, cas, embed_torch, phash_torch
from spacedrive_tpu_torch.ops import thumbnail_torch as tt
from spacedrive_tpu_torch.ops.blake3_ref import StreamingBlake3
from spacedrive_tpu_torch.parallel import mesh
from spacedrive_tpu_torch.telemetry import metrics as tm

CPU = torch.device("cpu")
SLOTS = [1, 2, 3, 4, 5]
JAX_CPU = [jax.devices("cpu")[0]]


@pytest.fixture(autouse=True)
def _clean_ladder():
    mesh.LADDER.reset()
    yield
    mesh.LADDER.reset()


def _messages(count: int, seed: int) -> list[bytes]:
    """`count` messages over the hot bucket and several small ones."""
    rng = np.random.default_rng(seed)
    sizes = [cas.LARGE_MSG_LEN, 1, 1025, 3000]
    return [rng.bytes(sizes[i % len(sizes)]) for i in range(count)]


def _ref(msg: bytes) -> str:
    return StreamingBlake3().update(msg).hexdigest()[:16]


@pytest.mark.parametrize("count", [5, 33])
def test_sharded_cas_is_bit_identical(count):
    msgs = _messages(count, count)
    single = cas.cas_ids(msgs, "cpu")
    assert single == [_ref(m) for m in msgs]
    for k in SLOTS:
        assert cas.cas_ids_begin(msgs, "cpu", devices=[CPU] * k)() == single, k


def test_sharded_cas_pads_every_bucket_to_the_scaled_rung():
    """A 3-way dispatch of 5 hot-bucket rows packs 96 rows: 32 per slot."""
    before = tm.SHARD_BATCH_ROWS.stats(op="blake3")["count"]
    msgs = _messages(20, 1)[::4]  # 5 hot-bucket messages
    assert cas.cas_ids_begin(msgs, "cpu", devices=[CPU] * 3)() == [_ref(m) for m in msgs]
    assert tm.SHARD_BATCH_ROWS.stats(op="blake3")["count"] == before + 1
    assert tm.SHARD_BATCH_ROWS.recent(op="blake3")[-1] == 32


def test_undividable_rows_raise():
    arr, lens = cas.pack_canonical_batch([b"abc"] * 5, 1)  # 32 rows
    with pytest.raises(ValueError, match="does not divide"):
        blake3_torch.hash_batch_begin(arr[:5], lens[:5], 1, [CPU] * 2)
    with pytest.raises(ValueError, match="does not divide"):
        blake3_torch.hash_batch(arr[:31], lens[:31], 1, devices=[CPU] * 3)
    words = blake3_torch.hash_batch(arr, lens, 1, devices=[CPU] * 4)
    assert torch.equal(words, blake3_torch.hash_batch(arr, lens, 1, "cpu"))


def test_auto_policy_shards_only_batches_that_fill_half_a_rung(monkeypatch):
    """On the ladder a part shards when it fills half the smallest
    sharded rung (32 × slots ÷ 2); a smaller tail stays on the default
    device. Both give the same ids."""
    monkeypatch.setattr(mesh, "dispatch_devices", lambda: [CPU] * 4)
    seen = []
    real = blake3_torch.hash_batch_begin

    def spy(msgs, lengths, max_chunks, devices, *a, **kw):
        seen.append(len(devices))
        return real(msgs, lengths, max_chunks, devices, *a, **kw)

    monkeypatch.setattr(blake3_torch, "hash_batch_begin", spy)
    small = [b"tail-%d" % i for i in range(63)]  # 63 * 2 < 4 * 32
    assert cas.cas_ids(small, "cpu") == [_ref(m) for m in small]
    big = [b"full-%d" % i for i in range(64)]
    assert cas.cas_ids(big, "cpu") == [_ref(m) for m in big]
    assert seen == [1, 4]
    assert mesh.LADDER.level == mesh.LEVEL_MESH


def _images(seed: int):
    rng = np.random.default_rng(seed)
    shapes = [(200, 150, 100, 75), (90, 256, 45, 128), (256, 256, 256, 256), (120, 60, 60, 30),
              (500, 333, 120, 80), (300, 512, 150, 256), (1000, 480, 480, 230)]
    images = []
    for h, w, _, _ in shapes:
        coarse = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 4), dtype=np.uint8)
        up = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:h, :w]
        noise = rng.integers(0, 32, (h, w, 4), dtype=np.uint8)
        images.append(np.clip(up.astype(np.int16) + noise - 16, 0, 255).astype(np.uint8))
    return images, [(th, tw) for _, _, th, tw in shapes]


def test_sharded_resize_pixels_never_change():
    images, targets = _images(3)
    one = tt.resize_batch(images, targets, out_size=512, device="cpu", devices=[CPU])
    want = tj.resize_batch(images, targets, out_size=512, devices=JAX_CPU)
    for g, w in zip(one, want):
        assert g.shape == w.shape
        assert int(np.abs(g.astype(np.int16) - w.astype(np.int16)).max()) <= 1
    for k in SLOTS[1:]:
        got = tt.resize_batch(images, targets, out_size=512, device="cpu", devices=[CPU] * k)
        for g, o in zip(got, one):
            assert np.array_equal(g, o), k


def test_sharded_embed_stays_within_tolerance():
    rng = np.random.default_rng(4)
    x = rng.random((13, 32, 32, 3)).astype(np.float32)
    one = embed_torch.embed_batch(x, "cpu", devices=[CPU])
    np.testing.assert_allclose(one, embed_jax.embed_batch(x, devices=JAX_CPU),
                               atol=1e-5, rtol=1e-5)
    worst = 0.0
    for k in SLOTS[1:]:
        got = embed_torch.embed_batch(x, "cpu", devices=[CPU] * k)
        assert got.shape == one.shape
        np.testing.assert_allclose(got, one, atol=1e-5, rtol=1e-5)
        worst = max(worst, float(np.abs(got - one).max()))
    print(f"worst embedding difference across slot counts: {worst:.3g}")


def test_a_given_embedder_is_copied_to_another_device_once():
    """A model on one device serves a slot on another through one copy
    per device, made on first use, not one per call."""
    from spacedrive_tpu_torch.models.embedder import PatchPoolEmbedder

    model = PatchPoolEmbedder("cpu")
    assert embed_torch._model_on(model, CPU) is model
    meta = torch.device("meta")
    first = embed_torch._model_on(model, meta)
    assert first is not model and first.w1.device == meta
    assert embed_torch._model_on(model, meta) is first
    assert embed_torch._model_on(PatchPoolEmbedder("cpu"), meta) is not first


@pytest.mark.parametrize("n", [1, 37, 64])
def test_hamming_matrix_sharded_equals_jax(n):
    rng = np.random.default_rng(n)
    hashes = [rng.bytes(8) for _ in range(n)]
    want = phash_jax.hamming_matrix(hashes)
    for k in SLOTS:
        got = phash_torch.hamming_matrix_sharded(hashes, "cpu", devices=[CPU] * k)
        assert got.dtype == np.uint8 and np.array_equal(got, want), k
    assert phash_torch.hamming_matrix_sharded([], "cpu").shape == (0, 0)
