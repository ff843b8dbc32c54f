"""The port on a CUDA device: K1 against its plain version, and each
device leg against the same leg on the CPU.

These tests need the card and skip without one (the condition is a
string, so it is evaluated when the test runs, not at import). They
import nothing of JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Tolerances: K1 and the hashes bit-identical; resize within 1 uint8 level
(float32 sums in another order); embed allclose(atol=1e-5, rtol=1e-5);
pHash bits equal except within 1e-5 × max|coefficient| of the median
(float64 sums in another order), pair sets exact; search scores
allclose 1e-5 with the same ids in the same order; validator checksums
bit-identical.
With --noconftest no coroutine-test runner is installed, so the library
chain test drives its event loop with asyncio.run itself.
"""

import asyncio
import os

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


async def _scan(data_dir, loc, backend):
    """Index `loc` into a library under `data_dir` twice on `backend`;
    returns ({row key: cas_id} after the first scan, K1 launches of each
    scan, identifier run metadata of the second)."""
    from spacedrive_tpu_torch.jobs import JobManager
    from spacedrive_tpu_torch.location.locations import LocationCreateArgs, scan_location
    from spacedrive_tpu_torch.node.library import Libraries
    from spacedrive_tpu_torch.tasks import TaskSystem
    from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

    lib = Libraries(data_dir).create("gpu")
    mgr = JobManager(TaskSystem(2))
    try:
        location = LocationCreateArgs(path=str(loc)).create(lib)
        launches, ids = [], None
        for _ in range(2):
            before = blake3_cuda.chunk_cvs.launches
            await scan_location(lib, location, mgr, backend=backend)
            await mgr.wait_idle()
            launches.append(blake3_cuda.chunk_cvs.launches - before)
            if ids is None:
                ids = {(r["materialized_path"], r["name"], r["extension"]): r["cas_id"]
                       for r in lib.db.query("SELECT * FROM file_path WHERE is_dir = 0")}
        jobs = lib.db.query("SELECT status, metadata FROM job WHERE name = 'file_identifier' "
                            "ORDER BY date_created")
        assert [j["status"] for j in jobs] == [2, 2]
        return ids, launches, unpackb(jobs[-1]["metadata"])
    finally:
        await mgr.system.shutdown()
        lib.close()


def test_library_chain_on_cuda_matches_cpu_and_warm_scan_launches_nothing(tmp_path):
    rng = np.random.default_rng(4)
    loc = tmp_path / "loc"
    for i, size in enumerate([0, 1, 1024, 5000, 102400, 102401, 300_000] + list(
            rng.integers(1, 400_000, 120))):
        d = loc / f"d{i % 5}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"f{i:03d}.bin").write_bytes(rng.bytes(int(size)))
    (loc / "dup.bin").write_bytes((loc / "d1" / "f006.bin").read_bytes())
    cuda_ids, cuda_launches, warm = asyncio.run(_scan(tmp_path / "cuda", loc, "cuda"))
    cpu_ids, cpu_launches, _ = asyncio.run(_scan(tmp_path / "cpu", loc, "cpu"))
    assert cuda_ids == cpu_ids and len(cuda_ids) == 128
    assert cuda_ids[("/", "dup", "bin")] == cuda_ids[("/d1/", "f006", "bin")]
    assert cuda_launches[0] > 0 and cuda_launches[1] == 0 and cpu_launches == [0, 0]
    assert warm["device_files"] == 0
    for (mat, name, ext), cas_id in list(cuda_ids.items())[:16]:
        path = os.path.join(loc, mat.strip("/"), f"{name}.{ext}")
        assert cas_id == (cas.cas_id_cpu(path) if os.path.getsize(path) else None)


def _media_tree(root):
    """Seeded images of several aspects and EXIF orientations (one
    beyond 4:1), a duplicate, an undecodable .png and a non-image."""
    from PIL import Image

    rng = np.random.default_rng(5)
    root.mkdir(parents=True)
    for i, (w, h, fmt, orientation) in enumerate([
            (1600, 1200, "jpg", 6), (900, 1350, "png", 1), (2400, 1350, "jpg", 8),
            (700, 700, "png", 1), (3000, 500, "png", 1), (33, 20, "jpg", 3)]):
        coarse = rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)
        img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
        if fmt == "jpg":
            exif = Image.Exif()
            exif[0x0112] = orientation
            img.save(root / f"i{i}.jpg", "JPEG", quality=90, exif=exif.tobytes())
        else:
            img.save(root / f"i{i}.png")
    (root / "dup.png").write_bytes((root / "i1.png").read_bytes())
    (root / "broken.png").write_bytes(rng.bytes(2000))
    (root / "notes.txt").write_bytes(b"not an image")


def _media_chain(data_dir, loc, device):
    """The three-job chain (`cli.index_library`) on `device`; returns the
    summary and, by cas_id, each webp's pixels, each media_data row and
    each embedding vector."""
    from PIL import Image

    from spacedrive_tpu_torch.cli import index_library
    from spacedrive_tpu_torch.node.library import Libraries
    from spacedrive_tpu_torch.object.media.thumbnail.store import ThumbnailStore

    summary = asyncio.run(index_library(str(loc), str(data_dir), "gpu-media", device))
    (lib,) = Libraries(data_dir).load_all()
    try:
        store = ThumbnailStore(os.path.join(data_dir, "thumbnails"))
        cas_of = {r["object_id"]: r["cas_id"] for r in lib.db.query(
            "SELECT object_id, cas_id FROM file_path WHERE object_id IS NOT NULL")}
        thumbs = {}
        for cas_id in set(cas_of.values()):
            path = store.path_for(str(lib.id), cas_id)
            if os.path.exists(path):
                with Image.open(path) as im:
                    thumbs[cas_id] = np.asarray(im.convert("RGBA"), np.int16)
        media = {cas_of[r["object_id"]]: {k: v for k, v in r.items() if k not in ("id", "object_id")}
                 for r in lib.db.query("SELECT * FROM media_data")}
        vectors = {cas_of[r["object_id"]]: np.frombuffer(r["vector"], "<f4")
                   for r in lib.db.query("SELECT * FROM object_embedding")}
        return summary, thumbs, media, vectors
    finally:
        lib.close()


def test_media_chain_on_cuda_matches_cpu(tmp_path):
    """IndexerJob → FileIdentifierJob → MediaProcessorJob on "cuda"
    (K1, the device resize, the embed forward) against the same chain on
    "cpu": the same thumbnails at the same dims, within a mean 1 level
    after webp; media_data rows equal; embeddings allclose 1e-5."""
    loc = tmp_path / "loc"
    _media_tree(loc)
    cuda = _media_chain(tmp_path / "cuda", loc, "cuda")
    cpu = _media_chain(tmp_path / "cpu", loc, "cpu")
    assert cuda[0]["thumbnails"] == cpu[0]["thumbnails"] == 7  # 6 images + the duplicate row
    assert set(cuda[1]) == set(cpu[1]) and len(cuda[1]) == 6
    for cas_id, got in cuda[1].items():
        want = cpu[1][cas_id]
        assert got.shape == want.shape
        assert float(np.abs(got - want).mean()) <= 1.0
    assert cuda[2] == cpu[2] and len(cuda[2]) == 6
    assert set(cuda[3]) == set(cpu[3]) and len(cuda[3]) == 6
    for cas_id, vec in cuda[3].items():
        np.testing.assert_allclose(vec, cpu[3][cas_id], atol=1e-5, rtol=1e-5)


def test_phash_on_cuda_matches_cpu_whatever_the_tf32_setting():
    from spacedrive_tpu_torch.ops import phash_torch

    rng = np.random.default_rng(6)
    gray = rng.random((300, 32, 32), dtype=np.float32)
    cpu = phash_torch.phash_batch(gray, "cpu")
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            got = phash_torch.phash_batch(gray, "cuda")
            flips = np.unpackbits(got, axis=1) != np.unpackbits(cpu, axis=1)
            ac = phash_torch.dct_low(torch.from_numpy(gray)).numpy()
            med = np.median(ac[:, 1:], axis=1, keepdims=True)
            near = np.abs(ac - med) <= 1e-5 * np.abs(ac).max(axis=1, keepdims=True)
            assert not (flips & ~near).any(), tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_near_pairs_on_cuda_match_cpu_and_xor():
    from spacedrive_tpu_torch.ops import phash_torch

    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, (9000, 64)).astype(bool)
    for c in range(0, 8990, 13):  # planted pairs 1-5 bits apart
        bits[c + 1] = bits[c]
        bits[c + 1, rng.choice(64, int(rng.integers(1, 6)), replace=False)] ^= True
    hashes = [h.tobytes() for h in np.packbits(bits, axis=1)]
    for threshold in (0, 5, 16):
        got = list(phash_torch.near_pairs(hashes, threshold, "cuda"))
        assert got == list(phash_torch.near_pairs(hashes, threshold, "cpu"))
        for i, j in got[:200]:
            assert int((bits[i] ^ bits[j]).sum()) <= threshold
    sub = hashes[:500]
    assert np.array_equal(phash_torch.hamming_matrix(sub, "cuda"),
                          phash_torch.hamming_matrix(sub, "cpu"))


def test_query_on_cuda_matches_cpu_with_ties():
    import types

    from spacedrive_tpu_torch.object.search import index as search_index

    rng = np.random.default_rng(8)
    m = rng.normal(size=(5000, 128)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    m[[10, 999, 4000]] = m[3]
    idx = search_index.LibraryIndex(types.SimpleNamespace(node=None))
    idx._matrix, idx._ids, idx._loaded = m, list(range(5000)), True
    for probe in (m[3], rng.normal(size=128)):
        got = idx.query(probe, k=50, device="cuda")
        want = idx.query(probe, k=50, device="cpu")
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-5, rtol=1e-5)
    assert [i for i, _ in idx.query(m[3], k=4, device="cuda")] == [3, 10, 999, 4000]


def test_file_checksums_on_cuda_at_256_chunks(tmp_path):
    """Every validator bucket on the card, 256 chunks included: the
    digests equal the CPU path's and the host hasher's, and K1 ran."""
    from spacedrive_tpu_torch.object.validation import file_checksum, file_checksums

    rng = np.random.default_rng(9)
    paths = []
    for chunks in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        cap = chunks * 1024
        for n in [cap, cap - 1, max(1, cap // 2 + 1)] * 6:
            paths.append(str(tmp_path / f"{len(paths)}.bin"))
            with open(paths[-1], "wb") as f:
                f.write(rng.bytes(n))
    before = blake3_cuda.chunk_cvs.launches
    got = file_checksums(paths, "cuda")
    assert blake3_cuda.chunk_cvs.launches > before
    assert got == file_checksums(paths, "cpu")
    assert got == [file_checksum(p) for p in paths]
