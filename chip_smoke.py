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
their expected dimensions, and its embeddings.

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
    return {"launches": launches}


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
    kernel["launches"] = got["launches"]
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
