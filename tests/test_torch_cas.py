"""cas_id in the PyTorch port against the JAX package's cas module.

Tolerance everywhere: bit-identical (messages, packed batches, cas_ids).
Inputs are made with numpy from a seed; the port runs on device="cpu",
where the BLAKE3 chunk stage is its plain torch version.
"""

import numpy as np
import pytest
import torch

from spacedrive_tpu.ops import blake3_ref as jref
from spacedrive_tpu.ops import cas as jcas
from spacedrive_tpu_torch.ops import blake3_ref as ref
from spacedrive_tpu_torch.ops import cas

EDGE_SIZES = [0, 1, 1023, 1024, 1025, 3 * 1024, 57 * 1024, 100 * 1024 - 1,
              102399, 102400, 102401, 150_000, 5 * 1024 * 1024 + 3]


def _content(rng, size):
    return rng.integers(0, 256, size, dtype=np.uint8).tobytes()


def test_constants_match():
    for name in ("SAMPLE_COUNT", "SAMPLE_SIZE", "HEADER_OR_FOOTER_SIZE", "MINIMUM_FILE_SIZE",
                 "LARGE_MSG_LEN", "LARGE_CHUNKS", "MAX_SMALL_MSG_LEN", "SMALL_BUCKETS",
                 "DEVICE_BATCH", "CHUNK_DIGEST_LEN"):
        assert getattr(cas, name) == getattr(jcas, name), name
    assert cas.batch_ladder() == jcas.batch_ladder()


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 256, 257, 1024])
def test_pack_pads_to_the_jax_ladder_rung(n):
    """A batch of n messages pads to the first rung that holds it, the
    same rung as the JAX package's single-device pack; pad rows are one
    zero byte."""
    msgs = [bytes([i % 251]) * (i % 7) for i in range(n)]
    arr, lens = cas.pack_canonical_batch(msgs, 1)
    jarr, jlens = jcas.pack_canonical_batch(msgs, 1)
    rung = next(r for r in cas.batch_ladder() if r >= n)
    assert arr.shape == jarr.shape == (rung, 1024)
    np.testing.assert_array_equal(lens, jlens)
    assert (lens[n:] == 1).all() and not arr[n:].any()


@pytest.mark.parametrize("size", EDGE_SIZES)
def test_sampling_and_message_match_jax(size, tmp_path):
    rng = np.random.default_rng(size)
    content = _content(rng, size)
    assert cas.sample_ranges(size) == jcas.sample_ranges(size)
    assert cas.message_len(size) == jcas.message_len(size)
    msg = cas.message_from_bytes(content)
    assert msg == jcas.message_from_bytes(content)
    assert len(msg) == cas.message_len(size)
    p = tmp_path / "f.bin"
    p.write_bytes(content)
    assert cas.read_message(p) == jcas.read_message(p) == msg
    assert cas.cas_id_cpu(p) == jcas.cas_id_cpu(p)


@pytest.mark.parametrize("chunks", [1, 4, 57, 101])
def test_pack_canonical_batch_matches_jax(chunks):
    rng = np.random.default_rng(chunks)
    cap = chunks * 1024
    for n in (1, 5, 32, 33, 300):
        lens = rng.integers(0, cap + 1, n)
        msgs = [_content(rng, int(k)) for k in lens]
        arr, ln = cas.pack_canonical_batch(msgs, chunks)
        jarr, jln = jcas.pack_canonical_batch(msgs, chunks)
        assert arr.dtype == jarr.dtype and ln.dtype == jln.dtype
        np.testing.assert_array_equal(arr, jarr)
        np.testing.assert_array_equal(ln, jln)
    with pytest.raises(ValueError):
        cas.pack_canonical_batch([b"x"] * (cas.DEVICE_BATCH + 1), 1)


def test_cas_ids_match_jax_cas_id_cpu(tmp_path):
    """cas_ids of a seeded tmp corpus, path for path, against the JAX
    package's host cas_id; the dispatch/finish split gives the same."""
    rng = np.random.default_rng(11)
    sizes = EDGE_SIZES[1:] + [int(s) for s in rng.integers(1, 400_000, 24)]
    paths = []
    for i, size in enumerate(sizes):
        p = tmp_path / f"f{i:03d}.bin"
        p.write_bytes(_content(rng, size))
        paths.append(p)
    msgs = [cas.read_message(p) for p in paths]
    got = cas.cas_ids(msgs, device="cpu")
    assert got == [jcas.cas_id_cpu(p) for p in paths]
    finish = cas.cas_ids_begin(msgs, device="cpu")
    assert finish() == got
    assert cas.cas_ids([], device="cpu") == []


def test_cas_ids_match_jax_device_path():
    """The port's batched hash against the JAX package's own batched
    device path (XLA on the CPU) on the 1- and 2-chunk buckets."""
    rng = np.random.default_rng(12)
    msgs = [cas.message_from_bytes(_content(rng, int(s)))
            for s in [1, 7, 500, 1015, 1016, 1500, 2000]]
    assert cas.cas_ids(msgs, device="cpu") == jcas.cas_ids(msgs, backend="tpu")


def test_chunk_cache_payload_round_trips_from_jax():
    """A ChunkCache payload made by the JAX package's
    host_rehash_with_cache feeds the port's dirty-range rehash, which
    lands on the same cas_id as a full rehash of the modified message."""
    rng = np.random.default_rng(13)
    content = bytearray(_content(rng, 300_000))
    msg = jcas.message_from_bytes(bytes(content))
    j_cas, j_cache = jcas.host_rehash_with_cache(msg)
    p_cas, p_cache = cas.host_rehash_with_cache(msg)
    assert j_cas == p_cas == ref.blake3_hex(msg)[:16]
    assert p_cache.to_payload() == j_cache.to_payload()

    cache = cas.ChunkCache.from_payload(j_cache.to_payload())
    assert cache is not None and cache.levels == j_cache.levels
    content[10] ^= 0xFF  # inside the 8 KiB header sample
    content[-5] ^= 0x01  # inside the footer sample: the message's last, 8-byte chunk
    msg2 = jcas.message_from_bytes(bytes(content))
    cas2, cache2, dirty, hashed = cas.dirty_range_rehash(msg2, cache)
    assert cas2 == jref.blake3_hex(msg2)[:16]
    assert (dirty, hashed) == (2, 1024 + 8)
    j2 = jcas.dirty_range_rehash(msg2, jcas.ChunkCache.from_payload(j_cache.to_payload()))
    assert (cas2, dirty, hashed) == (j2[0], j2[2], j2[3])
    assert cache2.to_payload() == j2[1].to_payload()

    # a digest-only cache (as recorded beside a device-hashed id) takes
    # one full host rehash, which builds the tree
    cas3, cache3, _, hashed3 = cas.dirty_range_rehash(
        msg2, cas.ChunkCache.from_payload(jcas.build_chunk_cache(msg).to_payload()))
    assert cas3 == cas2 and hashed3 == len(msg2) and cache3.levels is not None


@pytest.mark.parametrize("payload", [
    None, [], {"len": 0, "dig": []}, {"len": 2048, "dig": [b"x" * 16]},
    {"len": 2048, "dig": [b"x" * 16] * 2, "cvs": [[b"y" * 32]]},
])
def test_chunk_cache_rejects_malformed_payloads(payload):
    assert cas.ChunkCache.from_payload(payload) is None
    assert jcas.ChunkCache.from_payload(payload) is None


def test_cuda_request_without_cuda_raises():
    """The port never falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        cas.cas_ids([b"\x01\x00\x00\x00\x00\x00\x00\x00x"], device="cuda")
