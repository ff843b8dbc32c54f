"""BLAKE3 in the PyTorch port against the reference and the JAX package.

Tolerance everywhere: bit-identical. Inputs are made with numpy from a
seed and go through both packages; the port runs on device="cpu", where
the chunk stage is its plain torch version (the CUDA kernel itself is
held against that plain version on the card: tests/test_torch_gpu.py and
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from spacedrive_tpu.ops import blake3_jax as bj
from spacedrive_tpu_torch.ops import blake3_cuda, blake3_ref as ref, blake3_torch as bt

DATA = bytes(i % 251 for i in range(110000))


def _batch(rng, lengths, bucket, pad_rows=0):
    """Seeded random messages of `lengths` zero-padded to `bucket`
    chunks, plus `pad_rows` rows of length 1 (the cas pad rows)."""
    rows = len(lengths) + pad_rows
    msgs = np.zeros((rows, bucket * 1024), np.uint8)
    raw = []
    for i, n in enumerate(lengths):
        b = rng.integers(0, 256, n, dtype=np.uint8)
        msgs[i, :n] = b
        raw.append(b.tobytes())
    lens = np.array(list(lengths) + [1] * pad_rows, np.int32)
    return msgs, lens, raw


def _edges(bucket):
    cap = bucket * 1024
    lens = {0, 1, 63, 64, 65, 1023, 1024, 1025, cap // 2, cap - 1, cap, max(0, cap - 1024)}
    return sorted(n for n in lens if n <= cap)


def test_official_vectors():
    assert ref.blake3_hex(b"") == (
        "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262"
    )
    assert ref.blake3_hex(bytes([0])) == (
        "2d3adedff11b61f14c886e35afa036736dcd87a74d27b5c1510225d0f592e213"
    )
    assert ref.blake3_hex(DATA[:1024]) == (
        "42214739f095a406f3fc83deb889744ac00df831c10daa55189b5d121c855af7"
    )
    assert ref.blake3_hex(DATA[:2048]) == (
        "e776b6028c7cd22a4d0ba182a8bf62205d2ef576467e838ed6f2529b85fba24a"
    )
    assert ref.blake3_hex(DATA[:102400]) == (
        "bc3e3d41a1146b069abffad3c0d44860cf664390afce4d9661f7902e7943e085"
    )


def test_streaming_matches_oneshot():
    for n in [0, 1, 64, 65, 1024, 1025, 2048, 2049, 5000, 57352]:
        d = DATA[:n]
        s = ref.StreamingBlake3()
        for off in range(0, n, 700):
            s.update(d[off:off + 700])
        assert s.hexdigest() == ref.blake3_hex(d), n


@pytest.mark.parametrize("bucket", [1, 2])
def test_hash_batch_matches_jax_xla_path(bucket):
    rng = np.random.default_rng(bucket)
    msgs, lens, _ = _batch(rng, _edges(bucket), bucket, pad_rows=3)
    want = np.asarray(bj._hash_batch_impl_modes[None](msgs, lens, max_chunks=bucket))
    got = bt.hash_batch(msgs, lens, bucket, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (len(lens), 8)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
    assert bt.words_to_hex(got) == bj.words_to_hex(want)


@pytest.mark.parametrize("bucket", [16, 57])
def test_hash_batch_matches_reference_ragged(bucket):
    rng = np.random.default_rng(100 + bucket)
    lengths = _edges(bucket) + [int(x) for x in rng.integers(0, bucket * 1024 + 1, 6)]
    msgs, lens, raw = _batch(rng, lengths, bucket, pad_rows=2)
    hexes = bt.words_to_hex(bt.hash_batch(msgs, lens, bucket, device="cpu"))
    for i, m in enumerate(raw):
        assert hexes[i] == ref.blake3_hex(m), f"len={len(m)}"
    for i in range(len(raw), len(lens)):  # pad rows hash one zero byte
        assert hexes[i] == ref.blake3_hex(b"\x00")


def test_hash_batch_input_forms_agree():
    """uint8 numpy, its zero-copy uint32 view, and torch uint8/int32
    tensors all hash the same."""
    rng = np.random.default_rng(7)
    msgs, lens, _ = _batch(rng, [0, 5, 1024, 3000, 4096], 4)
    want = bt.hash_batch(msgs, lens, 4, device="cpu")
    for form in (
        msgs.view(np.uint32),
        torch.from_numpy(msgs),
        torch.from_numpy(msgs.view(np.int32)),
    ):
        assert torch.equal(bt.hash_batch(form, lens, device="cpu"), want)
    words = bt.host_words(msgs)
    assert words.dtype == torch.int32
    assert words.data_ptr() == msgs.ctypes.data  # zero-copy host view


def test_chunk_cvs_plain_matches_reference_chunks():
    """Per-lane CVs against blake3_ref's chunk compression, with the
    ROOT flag for single-chunk messages and the counter in t_lo."""
    rng = np.random.default_rng(3)
    lens = [0, 1, 63, 64, 65, 500, 1023, 1024]
    words = np.zeros((len(lens), 1024), np.uint8)
    chunks = []
    for i, n in enumerate(lens):
        b = rng.integers(0, 256, n, dtype=np.uint8)
        words[i, :n] = b
        chunks.append(b.tobytes())
    is_root = np.array([i % 2 for i in range(len(lens))], np.int32)
    t_lo = np.array([0, 3, 7, 1, 0, 2, 9, 5], np.int32)
    out = bt.chunk_cvs_plain(
        bt.host_words(words), torch.tensor(lens, dtype=torch.int32),
        torch.from_numpy(is_root), torch.from_numpy(t_lo),
    )
    assert out.shape == (8, len(lens)) and out.dtype == torch.int32
    got = out.numpy().T.view(np.uint32)
    for i, c in enumerate(chunks):
        want = ref._chunk_cv(c, int(t_lo[i]), is_root=bool(is_root[i]))[:8]
        assert list(got[i]) == want, f"lane {i} len={lens[i]}"


def test_chunk_cvs_wrapper_uses_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    msgs, lens, _ = _batch(rng, [10, 2000, 4096], 4)
    lanes, _ = bt.chunk_lanes(bt.host_words(msgs), torch.from_numpy(lens), 4)
    before = blake3_cuda.chunk_cvs.launches
    assert torch.equal(blake3_cuda.chunk_cvs(*lanes), bt.chunk_cvs_plain(*lanes))
    assert blake3_cuda.chunk_cvs.launches == before  # no kernel ran


def test_chunk_cvs_wrapper_rejects_other_devices():
    lanes = (
        torch.empty((4, 256), dtype=torch.int32, device="meta"),
        *(torch.empty(4, dtype=torch.int32, device="meta") for _ in range(3)),
    )
    with pytest.raises(ValueError, match="cuda or cpu"):
        blake3_cuda.chunk_cvs(*lanes)


def test_importing_the_kernel_module_builds_nothing():
    assert blake3_cuda._built == []  # the build happens at first CUDA use


@pytest.mark.slow
def test_hash_batch_matches_pallas_interpret(monkeypatch):
    """The sweep of test_blake3.py::test_pallas_chunk_kernel_parity,
    against the Pallas chunk kernel in interpret mode."""
    from spacedrive_tpu.ops import blake3_pallas

    monkeypatch.setenv("SD_BLAKE3_PALLAS", "1")
    assert blake3_pallas.pallas_mode() == "interpret"
    bucket = 16
    lens = [0, 5, 1024, 1025, 4096, 16 * 1024, 9 * 1024 + 321]
    msgs = np.zeros((len(lens), bucket * 1024), np.uint8)
    for i, n in enumerate(lens):
        msgs[i, :n] = np.frombuffer(DATA[:n], np.uint8)
    arr_lens = np.array(lens, np.int32)
    via_pallas = np.asarray(
        bj._hash_batch_impl_modes["interpret"](msgs, arr_lens, max_chunks=bucket)
    )
    got = bt.hash_batch(msgs, arr_lens, bucket, device="cpu")
    np.testing.assert_array_equal(got.numpy(), via_pallas.view(np.int32))
