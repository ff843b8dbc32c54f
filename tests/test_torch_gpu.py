"""The port on a CUDA device: K1 against its plain version, and each
device leg against the same leg on the CPU.

These tests need the card and skip without one (the condition is a
string, so it is evaluated when the test runs, not at import). They
import nothing of JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Tolerances: K1 and the hashes bit-identical; resize within 1 uint8 level
(float32 sums in another order); embed allclose(atol=1e-5, rtol=1e-5).
"""

import numpy as np
import pytest
import torch

from spacedrive_tpu_torch.ops import blake3_cuda, blake3_ref, blake3_torch, cas, embed_torch
from spacedrive_tpu_torch.ops import thumbnail_torch as tt

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device (the kernel has no CPU mode)")


def _packed(rng, lengths, chunks):
    msgs = [rng.bytes(int(n)) for n in lengths]
    return msgs, cas.pack_canonical_batch(msgs, chunks)


@pytest.mark.parametrize("chunks", cas.SMALL_BUCKETS + (cas.LARGE_CHUNKS,))
def test_k1_matches_plain_and_reference(chunks):
    rng = np.random.default_rng(chunks)
    cap = chunks * 1024
    lengths = sorted({0, 1, 63, 64, 65, 1023, 1024, 1025, cap - 1, cap} & set(range(cap + 1)))
    lengths += [int(x) for x in rng.integers(0, cap + 1, 28 - len(lengths))]
    msgs, (arr, lens) = _packed(rng, lengths, chunks)
    words = blake3_torch.host_words(arr).cuda()
    lanes, _ = blake3_torch.chunk_lanes(words, torch.from_numpy(lens).cuda(), chunks)
    before = blake3_cuda.chunk_cvs.launches
    got = blake3_cuda.chunk_cvs(*lanes)
    assert blake3_cuda.chunk_cvs.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got, blake3_torch.chunk_cvs_plain(*lanes))
    hexes = blake3_torch.words_to_hex(blake3_torch.hash_batch(words, lens, chunks, "cuda"))
    for m, h in zip(msgs, hexes):
        assert h == blake3_ref.blake3_hex(m)


def test_k1_wrapper_rejects_bad_tensors():
    lanes = [torch.zeros((4, 256), dtype=torch.int32, device="cuda")] + [
        torch.zeros(4, dtype=torch.int32, device="cuda") for _ in range(3)]
    with pytest.raises(ValueError):
        blake3_cuda.chunk_cvs(lanes[0].to(torch.int64), *lanes[1:])
    with pytest.raises(ValueError):
        blake3_cuda.chunk_cvs(lanes[0], lanes[1][:3], *lanes[2:])
    with pytest.raises(ValueError):
        blake3_cuda.chunk_cvs(lanes[0].t().contiguous().t(), *lanes[1:])


def test_cas_ids_on_cuda_match_cpu():
    rng = np.random.default_rng(1)
    msgs = [cas.message_from_bytes(rng.bytes(int(s)))
            for s in list(rng.integers(1, 400_000, 60)) + [1, 102400, 102401]]
    assert cas.cas_ids(msgs, device="cuda") == cas.cas_ids(msgs, device="cpu")


def test_resize_on_cuda_within_one_level_of_cpu():
    rng = np.random.default_rng(2)
    shapes = [(900, 600), (600, 900), (2000, 1500), (300, 200), (4000, 3000)]
    images = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for h, w in shapes]
    targets = [tt.scale_dimensions(w, h)[::-1] for h, w in shapes]
    got = tt.resize_batch(images, targets, device="cuda")
    want = tt.resize_batch(images, targets, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert int(np.abs(g.astype(np.int16) - w.astype(np.int16)).max()) <= 1


def test_embed_on_cuda_matches_cpu():
    x = np.random.default_rng(3).random((20, 32, 32, 3), dtype=np.float32)
    np.testing.assert_allclose(embed_torch.embed_batch(x, "cuda"),
                               embed_torch.embed_batch(x, "cpu"), atol=1e-5, rtol=1e-5)
