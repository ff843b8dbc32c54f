"""The port on a CUDA device: K1 against its plain version, and each
device leg against the same leg on the CPU.

These tests need the card and skip without one (the condition is a
string, so it is evaluated when the test runs, not at import). They
import nothing of JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

H1 (the near-pairs kernel) against the plain path: the same pairs in
the same order, on planted hashes and on equal ones that overflow a
launch's capacity, and one launch a block (plus one a relaunch).

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
import uuid

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
    """The three-job chain (`cli.index_library`) on `device`, the
    thumbnailer on its device path there (a Node on "cpu" would take the
    software path); returns the summary and, by cas_id, each webp's
    pixels, each media_data row and each embedding vector."""
    from PIL import Image

    from spacedrive_tpu_torch.cli import index_library
    from spacedrive_tpu_torch.node.library import Libraries
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.object.media.thumbnail.store import ThumbnailStore

    node = Node(str(data_dir), device=device)
    node.config.config.p2p.enabled = False
    node.thumbnailer.use_device = True
    summary = asyncio.run(index_library(str(loc), str(data_dir), "gpu-media", device, node=node))
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


def _planted_hashes(n: int, seed: int) -> list[bytes]:
    """n random hashes, every 13th followed by a copy 1-5 bits away."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n, 64)).astype(bool)
    for c in range(0, n - 1, 13):
        bits[c + 1] = bits[c]
        bits[c + 1, rng.choice(64, int(rng.integers(1, 6)), replace=False)] ^= True
    return [h.tobytes() for h in np.packbits(bits, axis=1)]


def _plain_pairs_on_the_card(hashes: list[bytes], threshold: int) -> list[tuple[int, int]]:
    """The plain path's pairs (`plain_block`, its ±1 operand in bf16 on
    the card, exact) where the CPU's float32 products would take minutes."""
    from spacedrive_tpu_torch.ops import phash_torch as pt

    n = len(hashes)
    bits = pt.unpack_hashes(hashes)
    bits = np.concatenate([bits, np.ones(((-n) % pt.PAIR_BLOCK, 64), bool)])
    launch = pt._plain_launcher(pt._plus_minus(torch.from_numpy(bits).cuda()), n, threshold)
    pairs = []
    for off in range(0, n, pt.PAIR_BLOCK):
        pairs += pt.block_pairs(launch, off, pt.PAIR_CAPACITY)[0]
    return pairs


# the thresholds at each N: every one up to 4,097 hashes; past that the
# pairs of the dense thresholds (~N²/2 at 64) outgrow the host's lists
H1_CASES = [(n, t) for n in (1, 2, 4095, 4096, 4097) for t in (0, 1, 8, 32, 64)] + [
    (9000, t) for t in (0, 1, 8, 32)] + [(262_144, t) for t in (0, 1, 8)]


@pytest.mark.parametrize("n, threshold", H1_CASES)
def test_h1_pairs_equal_the_plain_path_in_order(n, threshold):
    from spacedrive_tpu_torch.ops import hamming_cuda, phash_torch

    hashes = _planted_hashes(n, seed=n)
    before = hamming_cuda.near_pairs_block.launches
    got = list(phash_torch.near_pairs(hashes, threshold, "cuda"))
    torch.cuda.synchronize()
    assert hamming_cuda.near_pairs_block.launches > before
    if n > 9000:
        want = _plain_pairs_on_the_card(hashes, threshold)
    else:
        want = list(phash_torch.near_pairs(hashes, threshold, "cpu"))
    assert got == want
    assert len(got) > 0 or n < 9 or threshold < 8


def test_h1_relaunches_a_block_past_its_capacity():
    """1,500 equal hashes: 1,124,250 pairs in one block, past the first
    launch's room for PAIR_CAPACITY, so the block is launched again."""
    from spacedrive_tpu_torch.ops import hamming_cuda, phash_torch
    from spacedrive_tpu_torch.telemetry import trace

    n = 1500
    hashes = [b"\x5a\x0f\xf0\x00\xff\x13\x37\x99"] * n
    before = hamming_cuda.near_pairs_block.launches
    got = list(phash_torch.near_pairs(hashes, 0, "cuda"))
    assert hamming_cuda.near_pairs_block.launches == before + 2
    block = [r for r in trace.recent() if r["stage"] == "block"][-1]
    assert block["fields"]["relaunched"] > 0 and block["fields"]["pairs"] == len(got)
    assert 0 < block["fields"]["device_s"] <= block["seconds"]
    assert len(got) == n * (n - 1) // 2 > phash_torch.PAIR_CAPACITY
    assert got == [(i, j) for i in range(n) for j in range(i + 1, n)]
    assert got == list(phash_torch.near_pairs(hashes, 0, "cpu"))


def test_h1_on_no_hashes_launches_nothing():
    from spacedrive_tpu_torch.ops import hamming_cuda, phash_torch

    before = hamming_cuda.near_pairs_block.launches
    assert list(phash_torch.near_pairs([], 8, "cuda")) == []
    assert phash_torch.duplicate_groups([], device="cuda") == []
    assert hamming_cuda.near_pairs_block.launches == before


@pytest.mark.parametrize("equal", [0, 400])
def test_duplicate_groups_on_cuda_launch_h1_once_a_block(equal):
    """One grouping of 9,000 hashes launches H1 once for each of its 3
    blocks, and once more for a block past its capacity (the first, when
    its first `equal` hashes are equal: 79,800 pairs); its groups are
    the CPU's."""
    from spacedrive_tpu_torch.ops import hamming_cuda, phash_torch
    from spacedrive_tpu_torch.telemetry import trace

    n = 9000
    hashes = _planted_hashes(n, seed=11)
    hashes[:equal] = [b"\x01" * 8] * equal
    ids = [f"o{k}" for k in range(n)]
    before = hamming_cuda.near_pairs_block.launches
    got = phash_torch.duplicate_groups(list(zip(ids, hashes)), threshold=8, device="cuda")
    blocks = [r for r in trace.recent() if r["stage"] == "near.block"][-3:]
    relaunched = sum(r["fields"]["relaunched"] for r in blocks)
    assert relaunched == (1 if equal else 0)
    assert hamming_cuda.near_pairs_block.launches == before + 3 + relaunched
    assert got == phash_torch.duplicate_groups(list(zip(ids, hashes)), threshold=8, device="cpu")
    assert len(got) > 600


def test_h1_wrapper_rejects_bad_tables():
    from spacedrive_tpu_torch.ops import hamming_cuda

    table = torch.zeros(8192, dtype=torch.int64, device="cuda")
    hamming_cuda.near_pairs_block(table, 5000, 4096, 4096, 8, 4)  # fits
    for args in ((table.to(torch.int32), 5000, 0, 4096, 8, 4),
                 (table[:5000], 5000, 0, 4096, 8, 4),  # not whole tiles
                 (table[1:1 + 4096], 4096, 0, 4096, 8, 4),  # not 16-byte aligned
                 (table, 5000, 100, 4096, 8, 4),  # off inside a tile
                 (table, 5000, 4096, 8192, 8, 4),  # rows past the table
                 (table, 9000, 0, 4096, 8, 4),  # n past the table
                 (table, 5000, 0, 4096, 65, 4)):
        with pytest.raises(ValueError):
            hamming_cuda.near_pairs_block(*args)


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


# ---- the labeler (slice 5) ---------------------------------------------------
#
# LabelerNet runs in bf16 on both devices (cuDNN against oneDNN, sums in
# another order): probabilities within 0.05 and the label decisions at
# 0.35 equal outside 0.35 ± 0.05, the bound `tests/test_torch_labeler.py`
# states against the JAX forward. ONNX graphs run in float32 with TF32
# off inside each call: within 1e-5 of the CPU whatever the TF32 globals.

LABEL_THRESHOLD, LABEL_BAND = 0.35, 0.05


def _assert_labels_agree(got: np.ndarray, want: np.ndarray) -> None:
    assert np.isfinite(got).all() and got.shape == want.shape
    assert np.abs(got - want).max() <= LABEL_BAND
    outside = np.abs(want - LABEL_THRESHOLD) > LABEL_BAND
    assert np.array_equal((got >= LABEL_THRESHOLD)[outside], (want >= LABEL_THRESHOLD)[outside])


def test_labeler_net_on_cuda_matches_cpu():
    import copy

    from spacedrive_tpu_torch.models import labeler

    cpu = labeler.init_params(torch.Generator().manual_seed(0))  # full width, 80 classes
    gpu = copy.deepcopy(cpu).to("cuda")
    x = torch.rand((8, 96, 96, 3), generator=torch.Generator().manual_seed(1))
    want, want_mask = labeler.infer_step(cpu, x)
    got, got_mask = labeler.infer_step(gpu, x.cuda())
    assert got.device.type == "cuda" and got_mask.dtype == torch.bool
    _assert_labels_agree(got.cpu().numpy(), want.numpy())


def _onnx_graphs():
    from spacedrive_tpu_torch.models import onnx_proto as P

    rng = np.random.default_rng(10)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    cnn = P.make_model([
        P.make_node("Conv", ["x", "w", "b"], ["c"], strides=[2, 2], pads=[1, 1, 1, 1],
                    kernel_shape=[3, 3]),
        P.make_node("BatchNormalization", ["c", "g", "be", "mu", "var"], ["bn"]),
        P.make_node("Sigmoid", ["bn"], ["sig"]),
        P.make_node("Mul", ["bn", "sig"], ["silu"]),
        P.make_node("MaxPool", ["silu"], ["mp"], kernel_shape=[2, 2], strides=[2, 2]),
        P.make_node("Resize", ["mp", "", "sc"], ["up"], mode="cubic"),
        P.make_node("GlobalAveragePool", ["up"], ["gap"]),
        P.make_node("Flatten", ["gap"], ["flat"]),
        P.make_node("Gemm", ["flat", "fw", "fb"], ["out"], transB=1),
    ], [P.make_value_info("x", (4, 3, 64, 64))], [P.make_value_info("out", (4, 10))], {
        "w": f(64, 3, 3, 3), "b": f(64), "g": f(64), "be": f(64), "mu": f(64) * 0.1,
        "var": rng.random(64).astype(np.float32) + 0.5, "sc": np.array([1, 1, 1.5, 1.5],
                                                                       np.float32),
        "fw": f(10, 64), "fb": f(10)})
    # a YOLOv8-layout head: [B, 4 + 80 classes, 256 anchors]
    head = P.make_model([
        P.make_node("Conv", ["x", "w"], ["c"], kernel_shape=[4, 4], strides=[4, 4]),
        P.make_node("Reshape", ["c", "shape"], ["r"]),
        P.make_node("Transpose", ["r"], ["rt"], perm=[0, 2, 1]),
        P.make_node("MatMul", ["rt", "m"], ["mm"]),
        P.make_node("Sigmoid", ["mm"], ["s"]),
        P.make_node("Transpose", ["s"], ["out"], perm=[0, 2, 1]),
    ], [P.make_value_info("x", (4, 3, 64, 64))], [P.make_value_info("out", (4, 84, 256))], {
        "w": f(32, 3, 4, 4), "shape": np.array([4, 32, 256], np.int64), "m": f(32, 84) * 0.2})
    return [P.encode_model(cnn), P.encode_model(head)]


def test_onnx_on_cuda_matches_cpu_whatever_the_tf32_setting():
    from spacedrive_tpu_torch.models import onnx_runtime

    x = np.random.default_rng(11).standard_normal((4, 3, 64, 64)).astype(np.float32)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        for buf in _onnx_graphs():
            want = onnx_runtime.load(buf, "cpu")(torch.from_numpy(x))[0].numpy()
            model = onnx_runtime.load(buf, "cuda")
            for tf32 in (True, False):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                torch.backends.cudnn.allow_tf32 = tf32
                got = model(torch.from_numpy(x).cuda())[0]
                assert got.device.type == "cuda"
                np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5, atol=1e-5)
                # the call restores the caller's flags
                assert torch.backends.cudnn.allow_tf32 is tf32
                assert torch.backends.cuda.matmul.allow_tf32 is tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_labeler_actor_on_cuda_matches_cpu(tmp_path):
    from PIL import Image

    from spacedrive_tpu_torch.models import labeler_actor, provision

    rng = np.random.default_rng(12)
    paths = []
    for i in range(21):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(rng.integers(0, 256, (30 + i, 50, 3), dtype=np.uint8)).save(paths[-1])
    provision.install_bundled(str(tmp_path / "ckpt"))
    onnx_dir = tmp_path / "onnx"
    onnx_dir.mkdir()
    (onnx_dir / "model.onnx").write_bytes(_onnx_graphs()[0])
    for d, agree in ((tmp_path / "ckpt", _assert_labels_agree),
                     (onnx_dir, lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-5,
                                                                         atol=1e-5))):
        probs = {}
        for device in ("cuda", "cpu"):
            actor = labeler_actor.ImageLabeler(str(d), device=device)
            assert actor._ensure_model()
            out = []
            for off in range(0, len(paths), actor.batch_size):
                images = np.stack(actor._decode_chunk(
                    [{"path": p} for p in paths[off:off + actor.batch_size]]))
                out.append(actor._infer_chunk(images))
            probs[device] = np.concatenate(out)
        agree(probs["cuda"], probs["cpu"])


# ---- training (slice 6) ----------------------------------------------------
#
# One full-width training step on the card against the CPU, both bf16
# (cuDNN's weight gradients against oneDNN's, sums in another order and
# not bitwise reproducible run to run): the loss within 0.015, each
# parameter's gradient within 0.25 relative L2 and cosine ≥ 0.97, and
# the parameters after the step within one AdamW step each way (2·lr),
# the bounds `tests/test_torch_train.py` states against the JAX step.

TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_COS, TRAIN_LR = 0.015, 0.25, 0.97, 1e-3


def test_train_step_on_cuda_matches_cpu():
    from spacedrive_tpu_torch.models import labeler

    cpu, cpu_opt = labeler.create_train_state(torch.Generator().manual_seed(0))
    gpu, gpu_opt = labeler.create_train_state(torch.Generator().manual_seed(0),
                                              model=labeler.LabelerNet().to("cuda"))
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.random((8, 96, 96, 3), dtype=np.float32))
    y = torch.zeros((8, labeler.NUM_CLASSES))
    y[torch.arange(8), torch.from_numpy(rng.integers(0, labeler.NUM_CLASSES, 8))] = 1.0
    want = labeler.train_step(cpu, cpu_opt, x, y)
    got = labeler.train_step(gpu, gpu_opt, x.cuda(), y.cuda())
    assert got.device.type == "cuda" and got.dim() == 0
    assert abs(float(got) - float(want)) <= TRAIN_LOSS_ATOL
    for (name, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        g, w = q.grad.cpu().double().ravel(), p.grad.double().ravel()
        rel = float((g - w).norm() / w.norm())
        cos = float(g @ w / (g.norm() * w.norm()))
        assert rel <= TRAIN_GRAD_RTOL and cos >= TRAIN_GRAD_COS, (name, rel, cos)
        assert float((q.detach().cpu() - p.detach()).abs().max()) <= 2 * TRAIN_LR * 1.001 + 1e-6


def test_train_on_cuda_and_reload_on_cpu(tmp_path):
    """A few steps of `train` on the scene corpus with use_device=True;
    its checkpoint, reloaded on the CPU, labels as the card's model does
    (probabilities within 0.05, decisions equal outside 0.35 ± 0.05)."""
    from spacedrive_tpu_torch.models import checkpoint, labeler, train

    cfg = train.TrainConfig(image_size=32, batch_size=16, steps=30, use_device=True)
    x, y = train.scene_dataset(32, per_class=20, seed=4)
    tree, model, metrics = train.train(train.array_batches(x, y, cfg.batch_size),
                                       train.SCENE_CLASSES, cfg, eval_set=(x[:40], y[:40]))
    assert next(model.parameters()).device.type == "cuda"
    assert np.isfinite(metrics["final_loss"]) and 0.0 <= metrics["eval_top1"] <= 1.0
    path = tmp_path / "weights.npz"
    checkpoint.save(path, tree, classes=train.SCENE_CLASSES, image_size=cfg.image_size,
                    widths=cfg.widths, depths=cfg.depths)
    loaded, meta = checkpoint.load(path)
    cpu = labeler.from_flax(loaded, len(meta["classes"]), meta["widths"], meta["depths"], "cpu")
    probe = torch.from_numpy(x[::7].copy())
    want = labeler.infer_step(cpu, probe)[0].numpy()
    got = labeler.infer_step(model, probe.cuda())[0].cpu().numpy()
    _assert_labels_agree(got, want)


def test_float32_paths_hold_their_tolerances_with_tf32_on():
    """The resize (±1 level), the embedder (1e-5) and the scorer (1e-5,
    ties in row order) on the card against the CPU with the TF32 globals
    on and `set_float32_matmul_precision("high")`: each path computes at
    full float32 whatever the caller set, and leaves the caller's setting
    as it found it."""
    import types

    from spacedrive_tpu_torch.object.search import index as search_index

    rng = np.random.default_rng(14)
    shapes = [(900, 600), (600, 900), (2000, 1500), (300, 200)]
    images = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for h, w in shapes]
    targets = [tt.scale_dimensions(w, h)[::-1] for h, w in shapes]
    x = rng.random((20, 32, 32, 3), dtype=np.float32)
    m = rng.normal(size=(5000, 128)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    m[[10, 999, 4000]] = m[3]
    idx = search_index.LibraryIndex(types.SimpleNamespace(node=None))
    idx._matrix, idx._ids, idx._loaded = m, list(range(5000)), True
    want_resize = tt.resize_batch(images, targets, device="cpu")
    want_embed = embed_torch.embed_batch(x, "cpu")
    probes = (m[3], rng.normal(size=128))
    want_query = [idx.query(p, k=50, device="cpu") for p in probes]
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        for g, w in zip(tt.resize_batch(images, targets, device="cuda"), want_resize):
            assert g.shape == w.shape
            assert int(np.abs(g.astype(np.int16) - w.astype(np.int16)).max()) <= 1
        np.testing.assert_allclose(embed_torch.embed_batch(x, "cuda"), want_embed,
                                   atol=1e-5, rtol=1e-5)
        for probe, want in zip(probes, want_query):
            got = idx.query(probe, k=50, device="cuda")
            assert [i for i, _ in got] == [i for i, _ in want]
            np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                       atol=1e-5, rtol=1e-5)
        assert [i for i, _ in idx.query(m[3], k=4, device="cuda")] == [3, 10, 999, 4000]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


# ---- the device seam (slot lists on the one card) -------------------------------


def test_sharded_cas_on_cuda_slots_equals_single_device():
    """[cuda:0] * 2: each slot hashes its share on a side stream of its
    own; the ids equal the single-device path's at the production shape
    and at row counts that leave pad rows."""
    rng = np.random.default_rng(21)
    msgs = [rng.bytes(cas.LARGE_MSG_LEN) for _ in range(2048)] + [
        rng.bytes(int(n)) for n in rng.integers(1, 40_000, 37)]
    single = cas.cas_ids(msgs, "cuda")
    for rows in (len(msgs), 2048, 33, 5):
        assert cas.cas_ids_begin(msgs[:rows], devices=[torch.device("cuda", 0)] * 2)() \
            == single[:rows]
    for i in (0, 2047, len(msgs) - 1):
        assert single[i] == blake3_ref.blake3_hex(msgs[i])[:16]


def test_injected_cuda_fault_retries_inside_finish_with_equal_ids():
    """`device.blake3:xla` on the auto path: the dispatch raises a
    CUDA-shaped error, the ladder demotes (one card: to its last rung)
    and the batch re-runs inside `finish()` on the card, K1 launching;
    the ids do not change, and a later call at the last rung hashes on
    the card too, never on the CPU."""
    from spacedrive_tpu_torch.parallel import mesh
    from spacedrive_tpu_torch.telemetry import metrics as tm
    from spacedrive_tpu_torch.utils import faults

    rng = np.random.default_rng(22)
    msgs = [rng.bytes(int(n)) for n in rng.integers(1, cas.MAX_SMALL_MSG_LEN, 200)] + [
        rng.bytes(cas.LARGE_MSG_LEN) for _ in range(100)]
    clean = cas.cas_ids(msgs, "cuda")
    before = tm.CAS_BACKEND_FALLBACK.value()
    mesh.LADDER.reset()
    try:
        with faults.active(faults.FaultPlan.parse("device.blake3:xla:times=1")) as plan:
            launches = blake3_cuda.chunk_cvs.launches
            assert cas.cas_ids(msgs, "cuda") == clean
            assert blake3_cuda.chunk_cvs.launches > launches
        assert plan.activations() == {"device.blake3": 1}
        assert tm.CAS_BACKEND_FALLBACK.value() >= before + 1
        assert mesh.LADDER.level == mesh.LEVEL_HOST
        launches = blake3_cuda.chunk_cvs.launches
        assert cas.cas_ids(msgs, "cuda") == clean
        assert blake3_cuda.chunk_cvs.launches > launches
        assert mesh.LADDER.level == mesh.LEVEL_HOST
    finally:
        mesh.LADDER.reset()


def test_strict_fp32_under_medium_precision_on_the_card():
    """A caller on "medium": the embedder still computes at full float32
    inside `strict_fp32`, and the caller gets "medium" back."""
    from spacedrive_tpu_torch.utils.precision import precision_state

    x = np.random.default_rng(23).random((20, 32, 32, 3), dtype=np.float32)
    want = embed_torch.embed_batch(x, "cpu")
    try:
        torch.set_float32_matmul_precision("medium")
        before = precision_state()
        np.testing.assert_allclose(embed_torch.embed_batch(x, "cuda"), want,
                                   atol=1e-5, rtol=1e-5)
        assert precision_state() == before
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


# ---- several cards (they skip on a one-card machine) -----------------------------


def _cards() -> list:
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


def _k1_launches_by_card(fn) -> dict:
    """K1 kernels per device index in a torch.profiler trace of `fn()`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts: dict = {}
    for evt in prof.events():
        if "blake3_chunk_cvs_kernel" in evt.name and evt.device_type == torch.autograd.DeviceType.CUDA:
            counts[evt.device_index] = counts.get(evt.device_index, 0) + 1
    return counts


def test_sharded_dispatch_over_every_card_equals_one_card():
    """Each card's share launches K1 on that card (never on cuda:0), and
    the ids, pixels, vectors and Hamming matrix equal one card's."""
    from spacedrive_tpu_torch.ops import phash_torch

    cards = _cards()
    rng = np.random.default_rng(31)
    msgs = [rng.bytes(cas.LARGE_MSG_LEN) for _ in range(1024 * len(cards))] + [
        rng.bytes(int(n)) for n in rng.integers(1, 40_000, 77)]
    one = cas.cas_ids_begin(msgs, devices=cards[:1])()
    counts = _k1_launches_by_card(lambda: cas.cas_ids_begin(msgs, devices=cards)())
    assert sorted(counts) == list(range(len(cards)))
    assert len(set(counts.values())) == 1
    assert cas.cas_ids_begin(msgs, devices=cards)() == one
    assert cas.cas_ids(msgs, "cuda") == one  # auto: every dispatch device
    shapes = [(900, 600), (600, 900), (2000, 1500), (300, 200), (480, 640)] * 2
    images = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for h, w in shapes]
    targets = [tt.scale_dimensions(w, h)[::-1] for h, w in shapes]
    want = tt.resize_batch(images, targets, devices=cards[:1])
    for g, w in zip(tt.resize_batch(images, targets, devices=cards), want):
        assert g.shape == w.shape
        assert int(np.abs(g.astype(np.int16) - w.astype(np.int16)).max()) <= 1
    x = rng.random((20, 32, 32, 3), dtype=np.float32)
    np.testing.assert_allclose(embed_torch.embed_batch(x, devices=cards),
                               embed_torch.embed_batch(x, devices=cards[:1]),
                               atol=1e-5, rtol=1e-5)
    hashes = [rng.bytes(8) for _ in range(1000)]
    assert np.array_equal(phash_torch.hamming_matrix_sharded(hashes, "cuda"),
                          phash_torch.hamming_matrix(hashes, "cuda"))


def test_a_dead_card_leaves_the_ladder_on_the_survivors():
    """A failed dispatch over every card probes each one; with card 1
    reading as dead the ladder keeps the others, the batch re-runs over
    them inside `finish()`, and the ids do not change."""
    from spacedrive_tpu_torch.parallel import mesh
    from spacedrive_tpu_torch.utils import faults

    cards = _cards()
    rng = np.random.default_rng(32)
    msgs = [rng.bytes(cas.LARGE_MSG_LEN) for _ in range(512 * len(cards))]
    clean = cas.cas_ids(msgs, "cuda")
    mesh.LADDER.reset()
    try:
        plan = "device.blake3:xla:times=1;device.probe:dead:arg=1,times=inf"
        with faults.active(faults.FaultPlan.parse(plan)):
            assert cas.cas_ids(msgs, "cuda") == clean
            assert mesh.LADDER.level == mesh.LEVEL_SUBSET
            survivors, level = mesh.LADDER.filter(cards)
            assert level == mesh.LEVEL_SUBSET
            assert survivors == [c for i, c in enumerate(cards) if i != 1]
            counts = _k1_launches_by_card(lambda: cas.cas_ids(msgs, "cuda"))
        assert 1 not in counts and len(counts) == len(cards) - 1
    finally:
        mesh.LADDER.reset()


def test_media_chain_on_cuda_pooled_equals_inline(tmp_path, monkeypatch):
    """The chain on "cuda" with SD_PROCS=2 (the embed decode in workers)
    against SD_PROCS=0: the same webp pixels and media_data rows, the
    embeddings within 1e-5; the pool answered and nothing failed."""
    from spacedrive_tpu_torch.parallel import procpool
    from spacedrive_tpu_torch.telemetry import metrics as tm

    loc = tmp_path / "loc"
    _media_tree(loc)
    monkeypatch.setenv("SD_PROCS", "0")
    inline = _media_chain(tmp_path / "inline", loc, "cuda")
    monkeypatch.setenv("SD_PROCS", "2")
    before = {k: tm.PROCPOOL_JOBS.value(result=k) for k in ("ok", "error", "retried")}
    restarts = tm.PROCPOOL_RESTARTS.value()
    pooled = _media_chain(tmp_path / "pooled", loc, "cuda")
    assert not procpool.POOL.running()
    assert tm.PROCPOOL_JOBS.value(result="ok") > before["ok"]
    assert tm.PROCPOOL_JOBS.value(result="error") == before["error"]
    assert tm.PROCPOOL_JOBS.value(result="retried") == before["retried"]
    assert tm.PROCPOOL_RESTARTS.value() == restarts
    assert pooled[0]["thumbnails"] == inline[0]["thumbnails"]
    assert pooled[1].keys() == inline[1].keys()
    for cas_id, got in pooled[1].items():
        assert np.array_equal(got, inline[1][cas_id])
    assert pooled[2] == inline[2]
    assert pooled[3].keys() == inline[3].keys() and len(pooled[3]) == 6
    for cas_id, vec in pooled[3].items():
        np.testing.assert_allclose(vec, inline[3][cas_id], atol=1e-5, rtol=0)


@pytest.mark.parametrize("rung", [0, 1, 2])
def test_cas_ids_on_cuda_at_every_forced_rung(rung):
    """The identify policy's rung sets the dispatch step (32, 256 or 1024
    rows per part); the ids are the same at each and equal blake3_ref."""
    from spacedrive_tpu_torch.parallel import autotune

    rng = np.random.default_rng(17)
    msgs = [rng.bytes(cas.LARGE_MSG_LEN) for _ in range(40)] + [
        rng.bytes(int(n)) for n in rng.integers(1, cas.MAX_SMALL_MSG_LEN, 24)]
    want = [blake3_ref.blake3_hex(m)[:16] for m in msgs]
    pol = autotune.policy("identify")
    try:
        pol.rung = rung
        assert pol.dispatch_rows_per_device() == autotune.BATCH_LADDER[rung]
        before = blake3_cuda.chunk_cvs.launches
        assert cas.cas_ids(msgs, "cuda") == want
        launches = blake3_cuda.chunk_cvs.launches - before
    finally:
        autotune.reset()
    hot_parts = -(-40 // autotune.BATCH_LADDER[rung])
    assert launches >= hot_parts


def _pdf_page_bytes() -> bytes:
    """A one-page PDF of vector art and a line of text: the cairo
    rasterizer draws it where cairo is found, the reader's typeset-text
    strategy anywhere else."""
    import zlib

    content = zlib.compress(b"0.9 0.1 0.1 rg 50 50 m 250 50 l 150 250 l h f "
                            b"0.1 0.2 0.9 rg 300 500 200 150 re f "
                            b"BT /F1 24 Tf 72 700 Td (a page on the card) Tj ET")
    objs = [b"<< /Type /Catalog /Pages 2 0 R >>", b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
            b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] /Contents 4 0 R "
            b"/Resources << /Font << /F1 5 0 R >> >> >>",
            b"<< /Length " + str(len(content)).encode() + b" /Filter /FlateDecode >>\nstream\n"
            + content + b"\nendstream",
            b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>"]
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, o in enumerate(objs, 1):
        offsets.append(len(out))
        out += str(i).encode() + b" 0 obj\n" + o + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 6\n0000000000 65535 f \n" + b"".join(f"{o:010d} 00000 n \n".encode()
                                                         for o in offsets)
    out += b"trailer\n<< /Size 6 /Root 1 0 R >>\nstartxref\n" + str(xref).encode() + b"\n%%EOF\n"
    return bytes(out)


def test_pdf_page_and_video_frame_resize_on_cuda_within_one_level_of_cpu(tmp_path):
    """The other decoders' frames on the card: a decoded PDF page (always
    decodable) and a frame of the committed clip (native frontend or
    cv2) resize on cuda within 1 uint8 level of the CPU, at the dims the
    host half chose (video: longest side 256 at most)."""
    from spacedrive_tpu_torch.native import video
    from spacedrive_tpu_torch.object.media.thumbnail import process

    pdf = tmp_path / "page.pdf"
    pdf.write_bytes(_pdf_page_bytes())
    decoded = [process.decode(str(pdf), "pdf")]
    try:
        import cv2  # noqa: F401
        have_cv2 = True
    except ImportError:
        have_cv2 = False
    if video.video_available() or have_cv2:
        clip = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                            "torch_clip_128x96.mp4")
        decoded.append(process.decode(clip, "mp4"))
        assert decoded[-1].is_video and decoded[-1].target == (96, 128)
    got = process.resize_decoded(decoded, "cuda")
    want = process.resize_decoded(decoded, "cpu")
    for d, g, w in zip(decoded, got, want):
        assert g.shape == w.shape == d.target + (4,)
        assert int(np.abs(g.astype(np.int16) - w.astype(np.int16)).max()) <= 1
        assert process.finish(d, g)[:4] == b"RIFF"


async def _api_scan(data_dir, loc, device):
    """`locations.create`, `files.validate` and `search.semantic` through
    the router of a Node on `device`; returns cas_ids and checksums by
    path, the ranking and K1's launches over the scan and the
    validation."""
    from spacedrive_tpu_torch.node.node import Node

    node = Node(str(data_dir), device=device, with_labeler=False)
    node.config.config.p2p.enabled = False
    await node.start()
    try:
        r = node.router
        lid = (await r.exec(node, "library.create", {"name": "gpu-api"}))["uuid"]
        blake3_cuda.chunk_cvs.launches = 0
        loc_id = await r.exec(node, "locations.create", {"path": str(loc)}, library_id=lid)
        await node.jobs.wait_idle()
        await r.exec(node, "files.validate", {"location_id": loc_id}, library_id=lid)
        await node.jobs.wait_idle()
        launches = blake3_cuda.chunk_cvs.launches
        lib = node.libraries.libraries.get(uuid.UUID(lid))
        # the location's `.spacedrive` marker holds random ids: left out
        rows = {(row["materialized_path"], row["name"], row["extension"]):
                (row["cas_id"], row["integrity_checksum"])
                for row in lib.db.query("SELECT * FROM file_path WHERE is_dir = 0 "
                                        "AND name != '.spacedrive'")}
        sem = await r.exec(node, "search.semantic",
                           {"query": str(loc / "i1.png"), "take": 10}, library_id=lid)
        reports = await r.exec(node, "jobs.reports", library_id=lid)
        assert all(rep["status"] == "COMPLETED" for rep in reports), reports
        return rows, [(n["name"], n["score"]) for n in sem["nodes"]], launches
    finally:
        await node.shutdown()


def test_router_scan_validate_and_semantic_on_cuda_match_cpu(tmp_path):
    """A port Node on "cuda" through `locations.create`, `files.validate`
    and `search.semantic` against a Node on "cpu": cas_ids and checksums
    equal, the same ranking with scores within 1e-5, K1 launched on the
    card only."""
    loc = tmp_path / "loc"
    _media_tree(loc)
    rng = np.random.default_rng(6)
    for i, size in enumerate([0, 1024, 102401, 300_000, 2_000_000]):
        (loc / f"blob{i}.bin").write_bytes(rng.bytes(size))
    cuda_rows, cuda_hits, cuda_launches = asyncio.run(_api_scan(tmp_path / "cuda", loc, "cuda"))
    cpu_rows, cpu_hits, cpu_launches = asyncio.run(_api_scan(tmp_path / "cpu", loc, "cpu"))
    assert cuda_rows == cpu_rows and len(cuda_rows) == 14
    assert [k for k, (c, _) in cuda_rows.items() if c is None] == [("/", "blob0", "bin")]
    assert all(chk for _, chk in cuda_rows.values())
    assert cuda_launches > 0 and cpu_launches == 0
    # i1.png and its byte copy dup.png are one object, named by its first row
    assert [n for n, _ in cuda_hits] == [n for n, _ in cpu_hits]
    assert cuda_hits[0][0] in ("i1", "dup")
    np.testing.assert_allclose([s for _, s in cuda_hits], [s for _, s in cpu_hits],
                               atol=1e-5, rtol=1e-5)


def _join(joiner, owner_lib):
    """A library joined as JAX's p2p/pairing.py:132-200 writes one (the
    pairing protocol is plane 6.7b): the owner's library id, this node's
    instance row and the owner's, the config file."""
    from spacedrive_tpu_torch.db import LibraryDb
    from spacedrive_tpu_torch.db.database import new_pub_id, now_iso
    from spacedrive_tpu_torch.location.indexer.rules import seed_rules
    from spacedrive_tpu_torch.node.library import Library, LibraryConfig, _config_vm

    db = LibraryDb(joiner.libraries._db_path(owner_lib.id))
    me = new_pub_id()
    iid = db.insert("instance", pub_id=me, identity=b"", node_id=joiner.id.bytes,
                    node_name="joiner", node_platform=0, last_seen=now_iso(),
                    date_created=now_iso())
    for inst in owner_lib.db.find("instance"):
        db.insert("instance", **{k: v for k, v in inst.items() if k != "id"})
    config = LibraryConfig(name=owner_lib.config.name, instance_id=iid)
    _config_vm.save(joiner.libraries._config_path(owner_lib.id), config.to_dict())
    lib = Library(owner_lib.id, config, db, uuid.UUID(bytes=me), node=joiner)
    joiner.libraries.libraries[lib.id] = lib
    seed_rules(db)
    owner_lib.db.insert("instance", pub_id=me, identity=b"", node_id=joiner.id.bytes,
                        node_name="joiner", node_platform=0, last_seen=now_iso(),
                        date_created=now_iso())
    return lib


async def _joined_search(tmp_path, loc):
    """An owner on "cpu" scans `loc`; a joiner on "cuda" and one on "cpu"
    pull its op log (after the owner's backfill) through the loopback
    over `get_ops`, their `on_applied` refreshing their indexes; each
    answers `search.semantic` of one image. Returns both rankings and
    K1's launches over the joins."""
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.object.search.index import on_embeddings_applied
    from spacedrive_tpu_torch.sync.ingest import IngestActor, backfill_operations

    owner = Node(str(tmp_path / "owner"), device="cpu", with_labeler=False)
    owner.config.config.p2p.enabled = False
    await owner.start()
    joiners = {d: Node(str(tmp_path / d), device=d, with_labeler=False) for d in ("cuda", "cpu")}
    for joiner in joiners.values():
        joiner.config.config.p2p.enabled = False
    try:
        lid = (await owner.router.exec(owner, "library.create", {"name": "shared"}))["uuid"]
        await owner.router.exec(owner, "locations.create", {"path": str(loc)}, library_id=lid)
        await owner.jobs.wait_idle()
        olib = owner.libraries.libraries[uuid.UUID(lid)]
        backfill_operations(olib.sync)
        out = {}
        blake3_cuda.chunk_cvs.launches = 0
        for device, node in joiners.items():
            await node.start()
            lib = _join(node, olib)
            await node._init_library(lib)

            async def pull(timestamps, count):
                ops = olib.sync.get_ops(count=count, clocks=timestamps)
                return ops, len(ops) == count

            lib.ingest = IngestActor(lib.sync, pull,
                                     on_applied=lambda lib=lib: on_embeddings_applied(lib))
            lib.ingest.notify()
            await lib.ingest.wait_idle()
            sem = await node.router.exec(node, "search.semantic",
                                         {"query": str(loc / "i1.png"), "take": 10},
                                         library_id=lid)
            out[device] = [(n["name"], n["score"]) for n in sem["nodes"]]
        return out, blake3_cuda.chunk_cvs.launches
    finally:
        for node in (owner, *joiners.values()):
            await node.shutdown()


def test_a_joiner_on_cuda_answers_semantic_search_as_one_on_cpu(tmp_path):
    """Two replicas join one library by its op log, one on the card and
    one on the CPU: the same ranking, scores within 1e-5, and neither
    join launched K1 (the replicas hash nothing)."""
    loc = tmp_path / "loc"
    _media_tree(loc)
    hits, launches = asyncio.run(_joined_search(tmp_path, loc))
    assert hits["cuda"] and [n for n, _ in hits["cuda"]] == [n for n, _ in hits["cpu"]]
    np.testing.assert_allclose([s for _, s in hits["cuda"]], [s for _, s in hits["cpu"]],
                               atol=1e-5, rtol=1e-5)
    assert launches == 0
