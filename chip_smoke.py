"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phase 1 checks for a CUDA device, prints its name and power limit, and
builds the BLAKE3 chunk kernel (K1) from the sources in this checkout.
Phase 2 holds K1 bit for bit against its plain torch version on the
card at every small cas bucket (32 rows) and at the 1024-row x 57-chunk
hot bucket, checks rows against the pure-Python reference, and times K1
and the plain version at the hot shape with CUDA events. Phase 3 builds
a corpus from the seed (4,096 files: 3,072 over 100 KiB, 768 over the
small buckets, 256 JPEG/PNG images), runs the indexing pass
(`index_pass`, device="cuda") and checks its cas_ids against the plain
path on the card and the reference on the host, its thumbnails against
their expected dimensions, and its embeddings. Phase 4 runs the library
path (`python -m spacedrive_tpu_torch index --library`: a Node on the
card, IndexerJob → FileIdentifierJob → MediaProcessorJob on its job
system, K1 launched from the identifier's window pipeline, the images
sent to the node's thumbnailer actor and embedded) over the phase-3
corpus plus 16,384 small files, three times: a cold scan (cas_ids
against phase 3, the plain path and the reference; objects, duplicates
and journal entries checked; each image's webp, media_data row,
embedding, search-index vector and journal vouches checked against
phase 3), a warm rescan of the unchanged tree (K1 must not launch, the
media job must do nothing, no webp may change), and an incremental
rescan after 32 in-place rewrites, 16 additions (4 of them images) and
16 deletions.

Any failed check exits non-zero. Without a CUDA device the script exits
non-zero before any work. The last line of standard output is
{"ok": true, "device": {...}}; the line before it is the card's
`nvidia-smi` name and power limit, and earlier lines carry the kernel
table and the pass's stage times as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM: 132 SMs with 64 INT32 lanes each (NVIDIA Hopper white paper);
# HBM3 at 3.35 TB/s (data sheet). The clock is read from the card.
SMS = 132
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
# 32-bit instructions of one compression on sm_90: 7 rounds x 8 G x 12,
# plus the 8 output xors. Each half of G is a = a+b+m (one three-input
# IADD3), d ^= a, d >>>= 16 or 8 (one PRMT byte permute), c += d,
# b ^= c, b >>>= 12 or 7 (one SHF funnel shift): 6 instructions, all on
# the integer pipe of 64 lanes per SM.
OPS_PER_BLOCK = 7 * 8 * 12 + 8

DEVICE = "cuda"
# the corpus: a 1M-file library cut to 4,096 files for the time limit;
# each hash dispatch keeps the production shape (1024 rows x 57 chunks)
N_LARGE, N_SMALL, N_IMAGES = 3072, 768, 256
LONG_SIDE = (640, 4032)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of `fn` over `reps` runs, each bracketed by
    CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# --- phase 2: K1 against its plain version --------------------------------


def packed_batch(rng, lengths, chunks):
    """Random messages of `lengths` packed as the cas path packs them:
    uint8 [rows, chunks*1024] with zero tails, int32 lengths."""
    from spacedrive_tpu_torch.ops import cas

    msgs = [rng.bytes(n) for n in lengths]
    return msgs, cas.pack_canonical_batch(msgs, chunks)


def phase_kernel(rng, sm_clock_hz: float) -> dict:
    from spacedrive_tpu_torch.ops import blake3_cuda, blake3_ref, blake3_torch, cas

    dev = torch.device(DEVICE)
    shapes = [(32, c) for c in cas.SMALL_BUCKETS] + [(1024, cas.LARGE_CHUNKS)]
    max_err = 0
    for rows, c in shapes:
        cap = c * 1024
        edges = [0, 1, 63, 64, 65, 1023, 1024, 1025, cap - 1, cap, max(0, cap - 1024), cap // 2]
        edges = sorted({n for n in edges if n <= cap})
        n_real = rows - 4  # the last rows stay pad rows (length 1, zero byte)
        lengths = edges + [int(x) for x in rng.integers(0, cap + 1, n_real - len(edges))]
        msgs, (arr, lens) = packed_batch(rng, lengths, c)
        check(arr.shape[0] == rows, f"pack gave {arr.shape[0]} rows, want {rows}")
        words = blake3_torch.host_words(arr).to(dev)
        lanes, _ = blake3_torch.chunk_lanes(words, torch.from_numpy(lens).to(dev), c)
        k1 = blake3_cuda.chunk_cvs(*lanes)
        plain = blake3_torch.chunk_cvs_plain(*lanes)
        torch.cuda.synchronize()
        err = int((k1.to(torch.int64) - plain.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(k1, plain), f"K1 differs from its plain version at {rows}x{c}")
        hexes = blake3_torch.words_to_hex(blake3_torch.hash_batch(words, lens, c, dev), 64)
        for i in sorted(rng.choice(len(msgs), 16, replace=False)):
            check(hexes[i] == blake3_ref.blake3_hex(msgs[i]),
                  f"row {i} (len {len(msgs[i])}) of {rows}x{c} differs from blake3_ref")
        print(f"phase 2: K1 == plain at {rows} rows x {c} chunks; 16 rows == blake3_ref", flush=True)

    # timing at the hot shape with production data: 1024 sampled
    # messages of 57,352 bytes (56 full chunks and one 8-byte chunk)
    rows, c = 1024, cas.LARGE_CHUNKS
    _, (arr, lens) = packed_batch(rng, [cas.LARGE_MSG_LEN] * rows, c)
    words = blake3_torch.host_words(arr).to(dev)
    lanes, _ = blake3_torch.chunk_lanes(words, torch.from_numpy(lens).to(dev), c)
    check(torch.equal(blake3_cuda.chunk_cvs(*lanes), blake3_torch.chunk_cvs_plain(*lanes)),
          "K1 differs from its plain version on the hot batch")
    k1_ms = cuda_ms(lambda: blake3_cuda.chunk_cvs(*lanes), reps=50)
    plain_ms = cuda_ms(lambda: blake3_torch.chunk_cvs_plain(*lanes), reps=20, warmup=1)
    chunk_len = lanes[1].to(torch.int64)
    active_blocks = int(((chunk_len + 63) // 64).clamp(min=1).sum())
    n = lanes[0].shape[0]
    ops = active_blocks * OPS_PER_BLOCK
    nbytes = n * 1024 + 3 * n * 4 + 8 * n * 4  # words + lane vectors in, CVs out
    ops_ms = ops / (SMS * INT32_LANES_PER_SM * sm_clock_hz) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(json.dumps({"hot_shape": {"lanes": n, "active_blocks": active_blocks, "ops": ops,
                                    "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms}}),
          flush=True)
    torch_ops_ms(dev, blake3_torch._as_u32(blake3_cuda.chunk_cvs(*lanes)).T.reshape(rows, c, 8))
    return {
        "name": "blake3_chunk_cvs",
        "route": "cuda",
        "source": "spacedrive_tpu_torch/ops/csrc/blake3_chunk.cu",
        "replaces": "spacedrive_tpu/ops/blake3_pallas.py:165",
        "parity": "bit-identical",
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }


def torch_ops_ms(dev, cvs) -> None:
    """Time the torch ops beside K1 on the main path (the XLA programs
    of the JAX package, ported as torch ops, not kernels) at the pass's
    shapes, for the breakdown: the tree reduce of one hot window, one
    resize call of 32 canvases of the 1024 bucket, one embed forward of
    32 images."""
    from spacedrive_tpu_torch.models import embedder
    from spacedrive_tpu_torch.ops import blake3_torch, thumbnail_torch

    gen = torch.Generator(device=dev).manual_seed(0)
    n_chunks = torch.full((cvs.shape[0],), cvs.shape[1], dtype=torch.int64, device=dev)
    canvases = torch.randint(0, 256, (32, 1024, 1024, 4), dtype=torch.uint8, device=dev,
                             generator=gen)
    scales = torch.full((32, 2), 512 / 1024, dtype=torch.float32, device=dev)
    images = torch.rand((32, embedder.IMAGE_SIZE, embedder.IMAGE_SIZE, 3), device=dev,
                        generator=gen)
    model = embedder.PatchPoolEmbedder(dev)
    with torch.no_grad():
        print(json.dumps({"torch_ops_ms": {
            "tree_reduce_1024x57": cuda_ms(lambda: blake3_torch._tree_reduce(cvs, n_chunks), 20),
            "resize_32x1024x1024_to_512": cuda_ms(
                lambda: thumbnail_torch._resize_canvases(canvases, scales, 512, 512), 10),
            "embed_forward_32": cuda_ms(lambda: model(images), 20),
        }}), flush=True)


# --- phase 3: the indexing pass -------------------------------------------

ASPECTS = [(1, 1), (4, 3), (3, 2), (16, 9)]
WIDE = [(5, 1), (6, 1)]  # beyond 4:1: the host resize path


def _image(args) -> tuple[str, int, int, int]:
    """Write one smooth seeded image (gradients plus coarse noise, so the
    encoders stay fast); returns (path, width, height, exif orientation)."""
    from PIL import Image

    path, w, h, seed, fmt, orientation = args
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    base = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.uint16)
    yy, xx = np.mgrid[0:h, 0:w]
    base[..., 0] += (xx * 64 // w).astype(np.uint16)
    base[..., 1] += (yy * 64 // h).astype(np.uint16)
    img = Image.fromarray(np.clip(base, 0, 255).astype(np.uint8))
    if fmt == "jpg":
        exif = Image.Exif()
        exif[0x0112] = orientation
        img.save(path, "JPEG", quality=90, exif=exif.tobytes())
    else:
        img.save(path, "PNG", compress_level=1)
    return path, w, h, orientation


def build_corpus(root: str, rng) -> tuple[list[tuple[str, int]], list[tuple[str, int, int, int]]]:
    """4,096 files: 3,072 of 101 KiB-512 KiB (log-uniform sizes), 768
    over the small buckets (0-byte and the 102399/102400/102401 edges
    included), 256 images. Returns the (path, size) of the non-images
    and the (path, w, h, orientation) of the images."""
    from spacedrive_tpu_torch.ops import cas

    files = []
    large = np.exp(rng.uniform(np.log(101 * 1024), np.log(512 * 1024), N_LARGE)).astype(int)
    specials = [0, 0, 1, 102399, 102400, 102401, 1023, 1024, 1025, 57352]
    small = list(specials)
    lo = 0
    per = (N_SMALL - len(specials)) // len(cas.SMALL_BUCKETS)
    for c in cas.SMALL_BUCKETS:
        hi = min(c * 1024 - 8, cas.MINIMUM_FILE_SIZE)
        small += [int(x) for x in rng.integers(lo, hi + 1, per)]
        lo = hi + 1
    small += [int(x) for x in rng.integers(0, cas.MINIMUM_FILE_SIZE + 1, N_SMALL - len(small))]
    for i, size in enumerate(list(large) + small):
        d = os.path.join(root, f"d{i % 16:02d}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"f{i:05d}.bin")
        with open(path, "wb") as f:
            f.write(rng.bytes(int(size)))
        files.append((path, int(size)))

    jobs = []
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    for i in range(N_IMAGES):
        if i < 8:
            aw, ah = WIDE[i % 2]
            long_side = int(rng.integers(1280, 2049))
        else:
            aw, ah = ASPECTS[i % 4]
            long_side = int(np.exp(rng.uniform(np.log(LONG_SIDE[0]), np.log(LONG_SIDE[1]))))
        w, h = long_side, max(1, long_side * ah // aw)
        if i % 2:  # portrait form
            w, h = h, w
        fmt = "jpg" if i % 3 else "png"
        orientation = (1, 6, 8, 3)[i % 4] if fmt == "jpg" else 1
        jobs.append((os.path.join(img_dir, f"img{i:03d}.{fmt}"), w, h, int(rng.integers(1 << 30)),
                     fmt, orientation))
    with ThreadPoolExecutor(8) as pool:
        images = list(pool.map(_image, jobs))
    return files, images


def plain_cas_ids(messages: list[bytes]) -> list[str]:
    """cas_ids through the plain torch chunk stage on the card."""
    from spacedrive_tpu_torch.ops import blake3_torch, cas

    out: list[str | None] = [None] * len(messages)
    buckets: dict[int, list[int]] = {}
    for i, m in enumerate(messages):
        c = cas.LARGE_CHUNKS if len(m) == cas.LARGE_MSG_LEN else cas._bucket_for(len(m))
        buckets.setdefault(c, []).append(i)
    for c, idx in buckets.items():
        for off in range(0, len(idx), cas.DEVICE_BATCH):
            part = idx[off:off + cas.DEVICE_BATCH]
            arr, lens = cas.pack_canonical_batch([messages[i] for i in part], c)
            words = blake3_torch.hash_batch(arr, lens, c, DEVICE, blake3_torch.chunk_cvs_plain)
            for i, hx in zip(part, blake3_torch.words_to_hex(words[:len(part)], 16)):
                out[i] = hx
    return out  # type: ignore[return-value]


def phase_pass(rng, tmp: str) -> dict:
    from PIL import Image

    from spacedrive_tpu_torch.index_pass import index_pass
    from spacedrive_tpu_torch.models import embedder
    from spacedrive_tpu_torch.object.media.thumbnail import process
    from spacedrive_tpu_torch.object.media.thumbnail.store import ThumbnailStore
    from spacedrive_tpu_torch.ops import blake3_cuda, cas, embed_torch, thumbnail_torch

    corpus = os.path.join(tmp, "corpus")
    data_dir = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    files, images = build_corpus(corpus, rng)
    print(f"phase 3: corpus of {len(files) + len(images)} files in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    blake3_cuda.chunk_cvs.launches = 0
    result = index_pass(corpus, data_dir, device=DEVICE, keep_pixels=True)
    launches = blake3_cuda.chunk_cvs.launches
    summary = result.summary
    print(json.dumps(summary), flush=True)
    n_files = len(files) + len(images)
    check(summary["files"] == n_files, f"pass saw {summary['files']} files, want {n_files}")
    check(launches > 0, "the pass launched K1 no time")

    # every cas_id against the plain chunk stage on the card
    sized = files + [(p, os.path.getsize(p)) for p, *_ in images]
    hashed = [(p, s) for p, s in sized if s > 0]
    msgs = [cas.read_message(p, s) for p, s in hashed]
    plain = plain_cas_ids(msgs)
    for (p, _), want in zip(hashed, plain):
        check(result.cas_ids[p] == want, f"cas_id of {p} differs from the plain path")
    for p, s in sized:
        if s == 0:
            check(result.cas_ids[p] is None, f"empty file {p} got a cas_id")
    # 64 random files against the pure-Python reference on the host
    for i in rng.choice(len(hashed), 64, replace=False):
        p, s = hashed[i]
        check(result.cas_ids[p] == cas.cas_id_cpu(p, s), f"cas_id of {p} differs from blake3_ref")
    print(f"phase 3: {len(hashed)} cas_ids == plain path on the card; 64 == blake3_ref", flush=True)

    # every image has its thumbnail, at scale_dimensions after orientation
    store = ThumbnailStore(data_dir)
    for path, w, h, orientation in images:
        cas_id = result.cas_ids[path]
        webp = store.path_for(None, cas_id)
        check(os.path.exists(webp), f"no thumbnail for {path}")
        tw, th = thumbnail_torch.scale_dimensions(w, h)
        if orientation in (5, 6, 7, 8):
            tw, th = th, tw
        with Image.open(webp) as im:
            check(im.size == (tw, th), f"thumbnail of {path} is {im.size}, want {(tw, th)}")
    check(summary["thumbnails"] == len(images), "thumbnail count")
    # a few device resizes against the same resize on the host (±1 level)
    small_imgs = sorted(
        (im for im in images if max(im[1], im[2]) <= 4 * min(im[1], im[2])),
        key=lambda im: im[1] * im[2],
    )[8:16]
    decoded = [process.decode_image(p) for p, *_ in small_imgs]
    host = thumbnail_torch.resize_batch([d.array for d in decoded], [d.target for d in decoded],
                                        device="cpu")
    resize_err = 0
    for (p, *_), want in zip(small_imgs, host):
        got = result.resized[result.cas_ids[p]]
        check(got.shape == want.shape, f"resized {p}: {got.shape} vs {want.shape}")
        resize_err = max(resize_err, int(np.abs(got.astype(int) - want.astype(int)).max()))
    check(resize_err <= 1, f"device resize differs from the host by {resize_err} levels")

    # embeddings: [128] float32, finite; a few against the CPU forward
    check(len(result.embeddings) == len(images), "embedding count")
    for vec in result.embeddings.values():
        check(vec.shape == (embedder.EMBED_DIM,) and vec.dtype == np.float32
              and bool(np.isfinite(vec).all()), "embedding is not a finite [128] float32")
    planes = np.stack([embedder.decode_image(p) for p, *_ in small_imgs])
    host_vecs = embed_torch.embed_batch(planes, "cpu")  # the reference forward
    for (p, *_), want in zip(small_imgs, host_vecs):
        check(np.allclose(result.embeddings[result.cas_ids[p]], want, atol=1e-5, rtol=1e-5),
              f"embedding of {p} differs from the CPU forward")
    print(f"phase 3: {len(images)} thumbnails at their dims (resize vs host max |d| "
          f"{resize_err}); {len(result.embeddings)} embeddings finite", flush=True)

    t = result.timings
    seconds = summary["seconds"]
    stages = {
        "files_per_s": n_files / seconds,
        "seconds": seconds,
        "k1_launches": launches,
        "thumbnails": summary["thumbnails"],
        "timings_s": t,
        "identify_read_share": t["read"] / t["identify"],
        "identify_hash_wait_share": t["hash_wait"] / t["identify"],
        "identify_dispatch_share": t["dispatch"] / t["identify"],
    }
    print(json.dumps({"pass": stages}), flush=True)
    return {"launches": launches, "corpus": corpus, "data_dir": data_dir,
            "cas_ids": result.cas_ids, "images": images, "embeddings": result.embeddings,
            "large": [p for p, s in files if s > cas.MINIMUM_FILE_SIZE]}


# --- phase 4: the library path ------------------------------------------------

# a 1M-file library cut to ~20k file_path rows for the time limit; the
# file widths (1 B-16 KiB small files, 101-512 KiB large ones, the
# 1024 x 57-chunk hot dispatch) stay
N_LIB_SMALL = 16_384
LIBRARY_CUT = ("a 1M-file library cut to the phase-3 corpus plus 16,384 small files "
               "(~20.5k file_path rows) for the time limit")


def add_small_files(root: str, rng) -> list[str]:
    """16,384 files of 1 B-16 KiB (log-uniform sizes) in 64 directories;
    a quarter repeat the bytes of another of them."""
    n_dup = N_LIB_SMALL // 4
    sizes = np.exp(rng.uniform(0, np.log(16 * 1024), N_LIB_SMALL - n_dup)).astype(int)
    datas = [rng.bytes(int(s)) for s in sizes]
    datas += [datas[int(i)] for i in rng.integers(0, len(datas), n_dup)]
    paths = []
    for i, data in enumerate(datas):
        d = os.path.join(root, "small", f"s{i % 64:02d}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"m{i:05d}.dat")
        with open(path, "wb") as f:
            f.write(data)
        paths.append(path)
    return paths


def library_rows(data_dir: str) -> dict:
    """The smoke library's file rows, journal rows by key, the last
    indexer, identifier and media job rows, media_data and
    object_embedding rows, and the search sidecar's object ids."""
    from spacedrive_tpu_torch.node.library import Libraries

    (lib,) = Libraries(data_dir).load_all()
    try:
        out = {
            "lib_id": str(lib.id),
            "rows": lib.db.query("SELECT * FROM file_path WHERE is_dir = 0"),
            "journal": {(r["materialized_path"], r["name"], r["extension"]): r
                        for r in lib.db.query("SELECT * FROM index_journal")},
            "jobs": lib.db.query("SELECT * FROM job ORDER BY date_created DESC, rowid DESC "
                                 "LIMIT 3")[::-1],
            "media_data": lib.db.query("SELECT * FROM media_data"),
            "embeddings": lib.db.query("SELECT * FROM object_embedding"),
        }
        with open(lib.db.path + ".searchidx/meta.json", encoding="utf-8") as f:
            out["sidecar_ids"] = json.load(f)["ids"]
    finally:
        lib.close()
    return out


def webp_files(data_dir: str) -> dict[str, tuple[int, int]]:
    """{webp path: (size, mtime_ns)} under the library's thumbnail store."""
    out = {}
    for dirpath, _, files in os.walk(os.path.join(data_dir, "thumbnails")):
        for f in files:
            if f.endswith(".webp"):
                st = os.stat(os.path.join(dirpath, f))
                out[os.path.join(dirpath, f)] = (st.st_size, st.st_mtime_ns)
    return out


def run_library_pass(corpus: str, data_dir: str) -> dict:
    """One `index --library` run on the card (`cli.index_library` on a
    Node on DEVICE, which the smoke builds to read its stage seconds),
    with K1's launch count set to 0 just before it and read just after;
    returns its numbers."""
    import asyncio
    from datetime import datetime

    from spacedrive_tpu_torch.cli import index_library
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.ops import blake3_cuda
    from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

    node = Node(data_dir, device=DEVICE)
    blake3_cuda.chunk_cvs.launches = 0
    t0 = time.perf_counter()
    summary = asyncio.run(index_library(corpus, data_dir, "smoke", DEVICE, node=node))
    wall = time.perf_counter() - t0
    launches = blake3_cuda.chunk_cvs.launches
    th = node.thumbnailer
    actor_s, generated, thumb_errors, job_s = th.stage_seconds, th.generated, th.errors, \
        node.stage_seconds
    got = library_rows(data_dir)
    jobs = got["jobs"]
    check([j["name"] for j in jobs] == ["indexer", "file_identifier", "media_processor"]
          and all(j["status"] == 2 for j in jobs), f"library jobs did not complete: {jobs}")
    meta = [unpackb(j["metadata"]) for j in jobs]
    secs = [(datetime.fromisoformat(j["date_completed"])
             - datetime.fromisoformat(j["date_started"])).total_seconds() for j in jobs]
    ident, media = meta[1], meta[2]
    return {
        **got, "summary": summary, "indexer": meta[0], "identifier": ident, "media": media,
        "launches": launches, "generated": generated,
        "numbers": {
            "files": summary["files"],
            "files_per_s": summary["files"] / wall,
            "seconds": wall,
            "indexer_s": secs[0],
            "indexer_walk_s": meta[0]["scan_read_time"],
            "indexer_db_s": meta[0]["db_write_time"],
            "identifier_s": secs[1],
            "identifier_read_s": ident["read_time"],
            "identifier_rehash_s": ident["rehash_time"],
            "identifier_dispatch_s": ident["dispatch_time"],
            "identifier_hash_wait_s": ident["hash_wait_time"],
            "identifier_db_s": ident["db_time"],
            "media_s": secs[2],
            "thumb_decode_s": actor_s["decode"],
            "thumb_device_s": actor_s["device"],
            "thumb_encode_s": actor_s["encode"],
            "thumb_batch_s": actor_s["batch"],
            "media_data_s": job_s.get("media_data", 0.0),
            "embed_decode_s": job_s.get("embed_decode", 0.0),
            "embed_forward_s": job_s.get("embed_forward", 0.0),
            "embed_write_s": job_s.get("embed_write", 0.0),
            "k1_launches": launches,
            "device_files": ident["device_files"],
            "walk_journal_hits": meta[0].get("journal_hit", 0),
            "identifier_journal_hits": ident["journal_hits"],
            "dirty_range_rehash": ident["journal_dirty_rehash"],
            "thumbnails_dispatched": media["thumbnails_dispatched"],
            "thumbnails_generated": generated,
            "thumbnail_errors": thumb_errors,
            "media_data_extracted": media["media_data_extracted"],
            "embeddings_written": media["embeddings_written"],
        },
    }


def _row_path(corpus: str, r: dict) -> str:
    name = r["name"] + (f".{r['extension']}" if r["extension"] else "")
    return os.path.join(corpus, r["materialized_path"].strip("/"), name)


def rewrite_in_place(path: str) -> None:
    """Flip 64 bytes inside the first sample range (same length) and
    move the mtime on, as an editor saving in place would."""
    from spacedrive_tpu_torch.ops import cas

    off = cas.HEADER_OR_FOOTER_SIZE + 100
    with open(path, "r+b") as f:
        f.seek(off)
        old = f.read(64)
        f.seek(off)
        f.write(bytes(b ^ 0x5A for b in old))
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))


def check_media(cold: dict, p3: dict, data_dir: str, rng) -> None:
    """The cold scan's media job against phase 3: a webp per image at
    `scale_dimensions` after orientation, within a mean 1 level of phase
    3's thumbnail of the same cas_id; a media_data row per image with
    its written resolution; an embedding per image allclose 1e-5 to
    phase 3's (8 also to the CPU forward); the search sidecar; and the
    journal's thumb, embed and media vouches."""
    from PIL import Image

    from spacedrive_tpu_torch.models import embedder
    from spacedrive_tpu_torch.object.media.thumbnail.store import ThumbnailStore
    from spacedrive_tpu_torch.ops import embed_torch, thumbnail_torch
    from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

    images = p3["images"]
    n = len(images)
    by_path = {_row_path(p3["corpus"], r): r for r in cold["rows"]}
    cas_of_object = {r["object_id"]: r["cas_id"] for r in cold["rows"] if r["object_id"]}
    dims_of_cas = {by_path[p]["cas_id"]: (w, h) for p, w, h, _ in images}
    media = cold["media"]
    check(media["thumbnails_dispatched"] == n and cold["generated"] == n,
          f"{media['thumbnails_dispatched']} thumbnails dispatched, {cold['generated']} written, "
          f"want {n}")
    check(media["media_data_extracted"] == n and media["embeddings_written"] == n,
          f"media job metadata {media}, want {n} media_data rows and {n} embeddings")

    store = ThumbnailStore(os.path.join(data_dir, "thumbnails"))
    p3_store = ThumbnailStore(p3["data_dir"])
    mean_d, max_d = 0.0, 0
    for path, w, h, orientation in images:
        row = by_path[path]
        cas_id = row["cas_id"]
        webp = store.path_for(cold["lib_id"], cas_id)
        check(os.path.exists(webp), f"no library thumbnail for {path}")
        tw, th = thumbnail_torch.scale_dimensions(w, h)
        if orientation in (5, 6, 7, 8):
            tw, th = th, tw
        with Image.open(webp) as im:
            check(im.size == (tw, th), f"library thumbnail of {path} is {im.size}, want {(tw, th)}")
            got = np.asarray(im.convert("RGBA"), np.int16)
        with Image.open(p3_store.path_for(None, cas_id)) as im:
            want = np.asarray(im.convert("RGBA"), np.int16)
        d = np.abs(got - want)
        mean_d, max_d = max(mean_d, float(d.mean())), max(max_d, int(d.max()))
        payload = unpackb(cold["journal"][(row["materialized_path"], row["name"],
                                           row["extension"])]["payload"])
        check(payload.get("thumb") is True and payload.get("embed") is True
              and isinstance(payload.get("media"), str) and payload["media"] != "",
              f"journal entry of {path} does not vouch thumb, embed and media: {payload}")
    check(mean_d <= 1.0, f"a library thumbnail differs from phase 3's by mean |d| {mean_d}")

    check(len(cold["media_data"]) == n, f"{len(cold['media_data'])} media_data rows, want {n}")
    for r in cold["media_data"]:
        want = list(dims_of_cas[cas_of_object[r["object_id"]]])
        check(unpackb(r["resolution"]) == want, f"media_data resolution {r['resolution']} != {want}")

    check(len(cold["embeddings"]) == n, f"{len(cold['embeddings'])} embeddings, want {n}")
    vec_of_cas = {}
    for r in cold["embeddings"]:
        cas_id = cas_of_object[r["object_id"]]
        vec = embedder.blob_to_vector(r["vector"])
        check(vec is not None and r["dim"] == embedder.EMBED_DIM
              and r["model"] == embedder.MODEL_NAME, f"malformed embedding row of {cas_id}")
        check(np.allclose(vec, p3["embeddings"][cas_id], atol=1e-5, rtol=1e-5),
              f"library embedding of {cas_id} differs from phase 3's")
        vec_of_cas[cas_id] = vec
    sample = [images[int(i)][0] for i in rng.choice(n, 8, replace=False)]
    host = embed_torch.embed_batch(np.stack([embedder.decode_image(p) for p in sample]), "cpu")
    for p, want in zip(sample, host):
        check(np.allclose(vec_of_cas[by_path[p]["cas_id"]], want, atol=1e-5, rtol=1e-5),
              f"library embedding of {p} differs from the CPU forward")
    ids = cold["sidecar_ids"]
    check(len(ids) == len(set(ids)) == n and set(ids) == {r["object_id"] for r in cold["embeddings"]},
          f"the search sidecar holds {len(ids)} vectors, want the {n} embedded objects")
    print(f"phase 4: cold media job: {n} webps at their dims (vs phase 3: max mean |d| "
          f"{mean_d:.4f}, max |d| {max_d}); {n} media_data rows; {n} embeddings == phase 3 "
          f"(8 == CPU forward); sidecar {len(ids)} vectors; journal vouches thumb/embed/media",
          flush=True)


def phase_library(rng, tmp: str, p3: dict) -> dict:
    from spacedrive_tpu_torch.object.media.thumbnail.store import ThumbnailStore
    from spacedrive_tpu_torch.ops import cas

    corpus = p3["corpus"]
    data_dir = os.path.join(tmp, "library")
    t0 = time.perf_counter()
    small = add_small_files(corpus, rng)
    print(f"phase 4: +{len(small)} small files in {time.perf_counter() - t0:.1f} s; {LIBRARY_CUT}",
          flush=True)

    # cold scan
    cold = run_library_pass(corpus, data_dir)
    rows = cold["rows"]
    print(json.dumps({"library_cold": cold["summary"]}), flush=True)
    check(cold["launches"] > 0, "the cold library scan launched K1 no time")
    check(len(rows) == len(p3["cas_ids"]) + len(small),
          f"library has {len(rows)} files, want {len(p3['cas_ids']) + len(small)}")
    by_path = {_row_path(corpus, r): r for r in rows}
    for path, want in p3["cas_ids"].items():
        check(by_path[path]["cas_id"] == want, f"library cas_id of {path} differs from phase 3")
    sized = [(p, os.path.getsize(p)) for p in by_path]
    hashed = [(p, s) for p, s in sized if s > 0]
    plain = plain_cas_ids([cas.read_message(p, s) for p, s in hashed])
    for (p, _), want in zip(hashed, plain):
        check(by_path[p]["cas_id"] == want, f"library cas_id of {p} differs from the plain path")
    for p, s in sized:
        if s == 0:
            check(by_path[p]["cas_id"] is None and by_path[p]["object_id"] is None,
                  f"empty file {p} got a cas_id or an object")
    for i in rng.choice(len(hashed), 64, replace=False):
        p, s = hashed[i]
        check(by_path[p]["cas_id"] == cas.cas_id_cpu(p, s), f"library cas_id of {p} != blake3_ref")
    objects_of: dict[str, set] = {}
    for r in rows:
        if r["cas_id"] is not None:
            objects_of.setdefault(r["cas_id"], set()).add(r["object_id"])
    check(all(len(o) == 1 and None not in o for o in objects_of.values()),
          "rows of one cas_id do not share one object")
    check(cold["summary"]["objects"] == len(objects_of),
          f"{cold['summary']['objects']} objects for {len(objects_of)} distinct cas_ids")
    check(len(objects_of) < len(hashed), "no duplicates were linked to a shared object")
    keys = {(r["materialized_path"], r["name"], r["extension"]) for r in rows}
    check(keys <= set(cold["journal"]), "a file has no journal entry after the cold scan")
    print(f"phase 4: cold scan {len(rows)} files; {len(hashed)} cas_ids == phase 3 / plain path; "
          f"64 == blake3_ref; {len(objects_of)} objects == distinct cas_ids", flush=True)
    check_media(cold, p3, data_dir, rng)

    # warm rescan of the unchanged tree
    webps = webp_files(data_dir)
    warm = run_library_pass(corpus, data_dir)
    check(warm["launches"] == 0, f"the warm rescan launched K1 {warm['launches']} times")
    # every file the cold scan hashed is a journal hit, and so is every
    # empty file (journaled with the "" sentinel): nothing else
    n_empty = len(sized) - len(hashed)
    check(cold["identifier"]["device_files"] == len(hashed),
          f"cold scan hashed {cold['identifier']['device_files']} files, want {len(hashed)}")
    check(warm["indexer"].get("journal_hit") == len(hashed) + n_empty == len(rows),
          f"warm journal hits {warm['indexer'].get('journal_hit')} != {len(hashed)} hashed "
          f"+ {n_empty} empty files")
    check(warm["identifier"]["device_files"] == 0 and warm["identifier"]["journal_dirty_rehash"] == 0,
          "the warm rescan hashed files")
    check({r["id"]: r["cas_id"] for r in warm["rows"]} == {r["id"]: r["cas_id"] for r in rows},
          "the warm rescan changed cas_ids")
    print(f"phase 4: warm rescan: 0 K1 launches, {len(rows)} journal hits ({len(hashed)} hashed "
          f"+ {n_empty} empty files)", flush=True)
    check(warm["media"] == {"media_data_extracted": 0, "media_data_skipped": 0,
                            "thumbnails_dispatched": 0, "embeddings_written": 0},
          f"the warm rescan's media job did work: {warm['media']}")
    check(warm["generated"] == 0, f"the warm rescan wrote {warm['generated']} thumbnails")
    check(webp_files(data_dir) == webps, "the warm rescan changed a webp file")
    print("phase 4: warm rescan: 0 thumbnails dispatched or written, 0 media_data rows "
          "extracted, 0 embeddings; no webp changed", flush=True)

    # incremental rescan: 32 rewrites in place, 16 additions, 16 deletions
    rewritten = [p3["large"][int(i)] for i in rng.choice(len(p3["large"]), 32, replace=False)]
    for p in rewritten:
        rewrite_in_place(p)
    added = []
    for i, size in enumerate([int(x) for x in rng.integers(1, 400_000, 12)]):
        path = os.path.join(corpus, "added", f"a{i:02d}.bin")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(rng.bytes(size))
        added.append(path)
    added_images = [_image((os.path.join(corpus, "added", f"a{12 + i:02d}.{fmt}"), w, h,
                            int(rng.integers(1 << 30)), fmt, orientation))
                    for i, (w, h, fmt, orientation) in enumerate(
                        [(1600, 1200, "jpg", 6), (900, 1350, "png", 1), (2400, 1350, "jpg", 8),
                         (700, 700, "png", 1)])]
    added += [p for p, *_ in added_images]
    deleted = [small[int(i)] for i in rng.choice(len(small), 16, replace=False)]
    for p in deleted:
        os.remove(p)
    inc = run_library_pass(corpus, data_dir)
    ident = inc["identifier"]
    check(ident["device_files"] == len(added),
          f"incremental rescan hashed {ident['device_files']} files on the card, want {len(added)}")
    check(ident["journal_dirty_rehash"] == len(rewritten),
          f"{ident['journal_dirty_rehash']} dirty-range rehashes, want {len(rewritten)}")
    check(inc["launches"] > 0, "the incremental rescan launched K1 no time")
    by_path = {_row_path(corpus, r): r for r in inc["rows"]}
    check(not any(p in by_path for p in deleted), "deleted files still have rows")
    check(len(inc["rows"]) == len(rows) + len(added) - len(deleted), "row count after rescan")
    for p in rewritten + added:
        check(by_path[p]["cas_id"] == cas.cas_id_cpu(p), f"cas_id of {p} != blake3_ref after rescan")
    print(f"phase 4: incremental rescan: {len(rewritten)} dirty-range rehashes, {len(added)} "
          f"files through K1, {len(deleted)} rows removed", flush=True)
    n_new = len(added_images)
    check(inc["media"] == {"media_data_extracted": n_new, "media_data_skipped": 0,
                           "thumbnails_dispatched": n_new, "embeddings_written": n_new},
          f"the incremental media job did not do exactly the {n_new} new images: {inc['media']}")
    check(inc["generated"] == n_new, f"the incremental rescan wrote {inc['generated']} thumbnails")
    store = ThumbnailStore(os.path.join(data_dir, "thumbnails"))
    for path, w, h, orientation in added_images:
        cas_id = by_path[path]["cas_id"]
        check(store.exists(inc["lib_id"], cas_id), f"no thumbnail for the new image {path}")
        check(inc["journal"][(by_path[path]["materialized_path"], by_path[path]["name"],
                              by_path[path]["extension"])]["cas_id"] == cas_id, "journal cas")
    print(f"phase 4: incremental rescan: the media job thumbnailed, extracted and embedded "
          f"exactly the {n_new} new images", flush=True)

    out = {"cut": LIBRARY_CUT}
    for name, run in (("cold", cold), ("warm", warm), ("incremental", inc)):
        out[name] = run["numbers"]
    print(json.dumps({"library_pass": out}), flush=True)
    return {"launches": {name: run["launches"] for name, run in
                         (("library_cold", cold), ("library_warm", warm),
                          ("library_incremental", inc))}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the GPU", file=sys.stderr)
        return 2
    from spacedrive_tpu_torch.ops import blake3_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    name_power = smi("name,power.limit")
    sm_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    print(f"phase 1: {name_power}, max SM clock {sm_clock_hz / 1e6:.0f} MHz", flush=True)
    t0 = time.perf_counter()
    blake3_cuda.build()
    print(f"phase 1: K1 built in {time.perf_counter() - t0:.1f} s", flush=True)

    kernel = phase_kernel(rng, sm_clock_hz)
    with tempfile.TemporaryDirectory(prefix="sd_chip_smoke_") as tmp:
        got = phase_pass(rng, tmp)
        lib = phase_library(rng, tmp, got)
    # launches on the main paths, each counted from 0 just before it
    kernel["launches_by_path"] = {"index_pass": got["launches"], **lib["launches"]}
    kernel["launches"] = sum(kernel["launches_by_path"].values())
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
