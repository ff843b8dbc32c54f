"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phase 1 checks for a CUDA device, prints its name and power limit, and
builds the BLAKE3 chunk kernel (K1) from the sources in this checkout.
Phase 2 holds K1 bit for bit against its plain torch version on the
card at every small cas bucket (32 rows), at the 1024-row x 57-chunk
hot bucket and at the validator's 1024-row x 256-chunk bucket, checks
rows against the pure-Python reference, times K1 and the plain version
with CUDA events, and counts the instructions of K1's block loop in the
built kernel's SASS (`cuobjdump -sass`) for a bound by count. Phase 3 builds
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
16 deletions. Phase 5 runs the library's read side on phase 4's library:
16 near-duplicate images are added and scanned, ObjectValidatorJob
writes every file's integrity_checksum (K1 on buckets of 1-256 chunks,
the host C hasher for the rest; held against the host hasher and the
reference), `duplicates` and `search` run through their CLI helpers
(pHash bits against the plain CPU path, planted pairs grouped, exact
groups against the DB after one object is split in two; semantic, name
and label queries), and
`near_pairs` and the scorer run at 262,144 seeded hashes and vectors
against host references.

Any failed check exits non-zero. Without a CUDA device the script exits
non-zero before any work. The last line of standard output is
{"ok": true, "device": {...}}; the line before it is the card's
`nvidia-smi` name and power limit, and earlier lines carry the kernel
table, the pass's stage times and the read side's numbers as JSON.
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
# the validator's largest bucket: DEVICE_BATCH rows of 256 chunks
VALIDATOR_ROWS, VALIDATOR_CHUNKS = 1024, 256


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

    def hold(rows: int, c: int, lengths: list[int], what: str = "") -> tuple[int, tuple]:
        """K1 against its plain version on messages of `lengths` packed
        into `rows` x `c` chunks, and 16 rows' digests against blake3_ref;
        returns the largest difference and the lanes."""
        msgs, (arr, lens) = packed_batch(rng, lengths, c)
        check(arr.shape[0] == rows, f"pack gave {arr.shape[0]} rows, want {rows}")
        words = blake3_torch.host_words(arr).to(dev)
        lanes, _ = blake3_torch.chunk_lanes(words, torch.from_numpy(lens).to(dev), c)
        k1 = blake3_cuda.chunk_cvs(*lanes)
        plain = blake3_torch.chunk_cvs_plain(*lanes)
        torch.cuda.synchronize()
        err = int((k1.to(torch.int64) - plain.to(torch.int64)).abs().max())
        check(torch.equal(k1, plain), f"K1 differs from its plain version at {rows}x{c}")
        hexes = blake3_torch.words_to_hex(blake3_torch.hash_batch(words, lens, c, dev), 64)
        for i in sorted(rng.choice(len(msgs), 16, replace=False)):
            check(hexes[i] == blake3_ref.blake3_hex(msgs[i]),
                  f"row {i} (len {len(msgs[i])}) of {rows}x{c} differs from blake3_ref")
        print(f"phase 2: K1 == plain at {rows} rows x {c} chunks{what}; 16 rows == blake3_ref",
              flush=True)
        return err, lanes

    max_err = 0
    for rows, c in [(32, c) for c in cas.SMALL_BUCKETS] + [(1024, cas.LARGE_CHUNKS)]:
        cap = c * 1024
        edges = [0, 1, 63, 64, 65, 1023, 1024, 1025, cap - 1, cap, max(0, cap - 1024), cap // 2]
        edges = sorted({n for n in edges if n <= cap})
        n_real = rows - 4  # the last rows stay pad rows (length 1, zero byte)
        lengths = edges + [int(x) for x in rng.integers(0, cap + 1, n_real - len(edges))]
        max_err = max(max_err, hold(rows, c, lengths)[0])

    # the validator's largest shape: 1024 rows x 256 chunks (whole files
    # of up to 256 KiB), random lengths with every 1024*k and 1024*k+1
    rows, c = VALIDATOR_ROWS, VALIDATOR_CHUNKS
    cap = c * 1024
    edges = sorted({n for k in range(c + 1) for n in (1024 * k, 1024 * k + 1) if 0 < n <= cap})
    lengths = edges + [int(x) for x in rng.integers(1, cap + 1, rows - len(edges))]
    err, lanes = hold(rows, c, lengths, f" (the validator's largest bucket; lengths 1024k and "
                                        f"1024k+1 for k = 0..{c})")
    max_err = max(max_err, err)
    validator_ms = cuda_ms(lambda: blake3_cuda.chunk_cvs(*lanes), reps=20)
    validator_plain_ms = cuda_ms(lambda: blake3_torch.chunk_cvs_plain(*lanes), reps=3, warmup=1)
    validator_bound = k1_bound(lanes, sm_clock_hz)

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
    hot = k1_bound(lanes, sm_clock_hz)
    sass = k1_sass_count()
    by_count = hot["active_blocks"] * sass["loop_cycles_per_lane_block"] / (SMS * sm_clock_hz) * 1e3
    print(json.dumps({"hot_shape": hot, "validator_shape": validator_bound, "k1_sass": sass,
                      "k1_bound_by_count_ms": by_count,
                      "k1_share_of_bound_by_count": by_count / k1_ms}), flush=True)
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
        "bound_ms": hot["bound_ms"],
        "bound_by": hot["bound_by"],
        "bound_ms_by_count": by_count,
        "ms_1024x256": validator_ms,
        "plain_ms_1024x256": validator_plain_ms,
        "bound_ms_1024x256": validator_bound["bound_ms"],
        "library_ms": None,
    }


def k1_bound(lanes, sm_clock_hz: float) -> dict:
    """K1's least time for these lanes, derived: the larger of the
    integer operations of the active blocks (OPS_PER_BLOCK each) over the
    card's INT32 lanes and the bytes (words and lane vectors in, CVs
    out) over HBM."""
    chunk_len = lanes[1].to(torch.int64)
    active_blocks = int(((chunk_len + 63) // 64).clamp(min=1).sum())
    n = lanes[0].shape[0]
    ops = active_blocks * OPS_PER_BLOCK
    nbytes = n * 1024 + 3 * n * 4 + 8 * n * 4
    ops_ms = ops / (SMS * INT32_LANES_PER_SM * sm_clock_hz) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"lanes": n, "active_blocks": active_blocks, "ops": ops, "bytes": nbytes,
            "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


# SASS opcodes that issue to the 32-bit integer pipes (64 lanes per SM
# on sm_90, the CUDA programming guide's throughput table)
INT_OPCODES = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "PRMT", "IMAD", "IMUL",
               "LEA", "ISETP", "SEL", "IMNMX", "IABS", "BMSK", "POPC", "FLO", "BREV"}
NON_ISSUE = {"NOP"}


def k1_sass_count() -> dict:
    """Count the instructions of K1's block loop (one compression: 7
    rounds x 8 G plus the output xors) in the built kernel's SASS
    (`cuobjdump -sass` of the extension). The loop is the range closed
    by the kernel's backward branch. Returns the opcode counts, the
    integer-pipe instructions per G, and the cycles one lane-block costs
    an SM: the larger of its integer instructions over 64 lanes and all
    its instructions over the SM's issue rate of 4 warp instructions (128
    lanes) a clock."""
    import glob
    import re
    import shutil

    from spacedrive_tpu_torch.ops import blake3_cuda

    so = sorted(glob.glob(os.path.join(blake3_cuda.BUILD_DIR, "blake3_chunk", "*.so")))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(bool(so), "no built K1 extension to disassemble")
    out = subprocess.run([tool, "-sass", so[0]], capture_output=True, text=True, check=True,
                         timeout=120).stdout
    body = out[out.index("blake3_chunk_cvs_kernel"):]
    end = body.find("Function :", 10)
    body = body if end < 0 else body[:end]
    instrs = []  # (address, opcode, text)
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;/]*?)\s*;", body):
        text = m.group(2).strip()
        tokens = [t for t in text.split() if not t.startswith("@")]
        if tokens:
            instrs.append((int(m.group(1), 16), tokens[0].split(".")[0], text))
    loops = []
    for addr, op, text in instrs:
        target = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)`\s*)?(0x[0-9a-f]+)", text)
        if op == "BRA" and target and int(target.group(1), 16) < addr:
            loops.append((int(target.group(1), 16), addr))
    # the block loop; if the disassembly shows none, the whole kernel
    lo, hi = max(loops, key=lambda r: r[1] - r[0]) if loops else (0, instrs[-1][0])
    ops: dict[str, int] = {}
    for addr, op, _ in instrs:
        if lo <= addr <= hi and op not in NON_ISSUE:
            ops[op] = ops.get(op, 0) + 1
    total = sum(ops.values())
    int_ops = sum(n for op, n in ops.items() if op in INT_OPCODES)
    g_per_block = 7 * 8
    return {"loop_found": bool(loops), "loop_instructions": total, "loop_int_instructions": int_ops,
            "int_per_g": int_ops / g_per_block, "derived_int_per_g": 12,
            "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1])),
            "loop_cycles_per_lane_block": max(int_ops / INT32_LANES_PER_SM, total / 128)}


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
                          ("library_incremental", inc))},
            "corpus": corpus, "data_dir": data_dir,
            "images": [p for p, *_ in p3["images"]] + [p for p, *_ in added_images]}


# --- phase 5: the library's read side ----------------------------------------

# near duplicates planted before phase 5's scan: corpus JPEGs re-encoded
# at another quality, corpus PNGs resized by 0.9
N_NEAR_JPEG, N_NEAR_PNG = 8, 8
NEAR_QUALITY, NEAR_SCALE = 60, 0.9
DUP_THRESHOLD = 8  # the CLI's default
# the image share of a 1M-file library (BASELINE config 5, full-library
# dedup): 262,144 seeded hashes with 1,024 planted clusters, the pair
# set checked against a host all-pairs on the first 16,384
N_PAIR_HASHES, N_PAIR_CLUSTERS, N_PAIR_SUBSET = 262_144, 1024, 16_384
# the search index at the same scale, with planted exact ties
N_SEARCH_VECTORS, SEARCH_K = 262_144, 100
# files held against blake3_ref (pure Python, ~0.5 MB/s): device-leg
# files at random and the smallest host-leg ones
N_REF_DEVICE, N_REF_HOST = 60, 4


def _near_copy(args) -> None:
    from PIL import Image

    src, dst = args
    with Image.open(src) as im:
        if dst.endswith(".jpg"):
            im.convert("RGB").save(dst, "JPEG", quality=NEAR_QUALITY)
        else:
            w, h = im.size
            im.resize((max(1, int(w * NEAR_SCALE)), max(1, int(h * NEAR_SCALE))),
                      Image.BILINEAR).save(dst, "PNG", compress_level=1)


def add_near_duplicates(corpus: str, images: list[str], rng) -> list[tuple[str, str]]:
    """N_NEAR_JPEG corpus JPEGs re-encoded and N_NEAR_PNG corpus PNGs
    resized under corpus/near/; returns (original, copy) pairs."""
    jpgs = [p for p in images if p.endswith(".jpg")]
    pngs = [p for p in images if p.endswith(".png")]
    pairs = []
    for group in (jpgs, pngs):
        n = N_NEAR_JPEG if group is jpgs else N_NEAR_PNG
        for i in sorted(rng.choice(len(group), n, replace=False)):
            src = group[int(i)]
            pairs.append((src, os.path.join(corpus, "near", "n_" + os.path.basename(src))))
    os.makedirs(os.path.join(corpus, "near"), exist_ok=True)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(_near_copy, pairs))
    return pairs


def _open_library(data_dir: str):
    from spacedrive_tpu_torch.node.library import Libraries

    (lib,) = Libraries(data_dir).load_all()
    return lib


def _timed(totals: dict, key: str, fn, sync: bool = False):
    """`fn`, adding its wall seconds to totals[key] (after a device
    synchronize when `sync`, so that its device work counts)."""
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            return out
        finally:
            totals[key] += time.perf_counter() - t0
    return timed


def run_validator(data_dir: str, corpus: str) -> dict:
    """ObjectValidatorJob over the location on a Node on DEVICE, K1's
    launches and the validator's leg counts set to 0 just before it and
    read just after. The job's seconds are split by timing, for this run
    only, the host leg (`file_checksum`: read and C hash of a whole
    file), the packing of device batches, `hash_batch` up to a device
    synchronize (copy in, K1, the tree reduction) and `write_ops`; the
    rest is the device leg's reads, the row queries, op building and the
    job system."""
    import asyncio

    from spacedrive_tpu_torch.jobs import JobBuilder
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.object.validation import file_checksums
    from spacedrive_tpu_torch.object.validation import hash as vhash
    from spacedrive_tpu_torch.object.validation.job import ObjectValidatorJob
    from spacedrive_tpu_torch.ops import blake3_cuda
    from spacedrive_tpu_torch.sync.manager import SyncManager
    from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

    async def run() -> dict:
        node = Node(data_dir, device=DEVICE)
        await node.start()
        try:
            (lib,) = node.libraries.libraries.values()
            loc = lib.db.find_one("location", path=os.path.abspath(corpus))
            job = ObjectValidatorJob({"location_id": loc["id"]})
            await JobBuilder(job).spawn(node.jobs, lib)
            await node.jobs.wait_idle()
            return lib.db.find_one("job", id=job.id.bytes)
        finally:
            await node.shutdown()

    split = dict.fromkeys(("host_hash_s", "pack_s", "device_hash_s", "db_write_s"), 0.0)
    patches = [(vhash, "file_checksum", _timed(split, "host_hash_s", vhash.file_checksum)),
               (vhash.cas, "pack_canonical_batch",
                _timed(split, "pack_s", vhash.cas.pack_canonical_batch)),
               (vhash.blake3_torch, "hash_batch",
                _timed(split, "device_hash_s", vhash.blake3_torch.hash_batch, sync=True)),
               (SyncManager, "write_ops", _timed(split, "db_write_s", SyncManager.write_ops))]
    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    for owner, name, wrapped in patches:
        setattr(owner, name, wrapped)
    file_checksums.device_files.clear()
    file_checksums.host_files = 0
    blake3_cuda.chunk_cvs.launches = 0
    t0 = time.perf_counter()
    try:
        row = asyncio.run(run())
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    seconds = time.perf_counter() - t0
    launches = blake3_cuda.chunk_cvs.launches
    check(row is not None and row["status"] == 2,
          f"the validator job did not complete: {row and row['errors_text']}")
    split["other_s"] = seconds - sum(split.values())
    return {"seconds": seconds, "launches": launches, "metadata": unpackb(row["metadata"]),
            "device_files": dict(sorted(file_checksums.device_files.items())),
            "host_files": file_checksums.host_files, "split_s": split}


def check_validator(data_dir: str, corpus: str, got: dict, rng) -> dict:
    """Every file's integrity_checksum against the host C hasher over the
    whole file; N_REF_DEVICE + N_REF_HOST files against blake3_ref; one
    CRDT op per row; K1 launched."""
    from spacedrive_tpu_torch.object.validation import file_checksum
    from spacedrive_tpu_torch.object.validation.hash import DEVICE_MAX_BYTES
    from spacedrive_tpu_torch.ops import blake3_ref

    lib = _open_library(data_dir)
    try:
        rows = lib.db.query("SELECT * FROM file_path WHERE is_dir = 0")
        n_ops = lib.db.count("crdt_operation", "kind = 'u:integrity_checksum'")
    finally:
        lib.close()
    paths = [_row_path(corpus, r) for r in rows]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:  # the C hasher releases the interpreter lock
        want = list(pool.map(file_checksum, paths))
    host_hasher_s = time.perf_counter() - t0
    for r, p, w in zip(rows, paths, want):
        check(r["integrity_checksum"] == w, f"integrity_checksum of {p} != the host hasher's")
    check(got["metadata"]["validated"] == len(rows), f"validated {got['metadata']} of {len(rows)}")
    check(n_ops == len(rows), f"{n_ops} integrity_checksum ops for {len(rows)} rows")
    check(got["launches"] > 0, "the validator launched K1 no time")
    check(sum(got["device_files"].values()) + got["host_files"] == len(rows),
          f"device {got['device_files']} + host {got['host_files']} files != {len(rows)} rows")
    sizes = [os.path.getsize(p) for p in paths]
    device_leg = [i for i, n in enumerate(sizes) if 0 < n <= DEVICE_MAX_BYTES]
    host_leg = sorted((i for i, n in enumerate(sizes) if n > DEVICE_MAX_BYTES), key=sizes.__getitem__)
    sample = [int(i) for i in rng.choice(device_leg, N_REF_DEVICE, replace=False)] \
        + host_leg[:N_REF_HOST]
    t0 = time.perf_counter()
    for i in sample:
        with open(paths[i], "rb") as f:
            check(rows[i]["integrity_checksum"] == blake3_ref.blake3_hex(f.read(), 32),
                  f"integrity_checksum of {paths[i]} != blake3_ref")
    ref_s = time.perf_counter() - t0
    print(f"phase 5: validator: {len(rows)} integrity_checksums == the host hasher; "
          f"{len(sample)} == blake3_ref; {n_ops} CRDT ops; device files by bucket "
          f"{got['device_files']}, host files {got['host_files']}, K1 launches "
          f"{got['launches']}", flush=True)
    return {"files": len(rows), "bytes": sum(sizes), "check_host_hasher_s": host_hasher_s,
            "check_ref_s": ref_s, "check_ref_bytes": sum(sizes[i] for i in sample)}


def _gray_plane(path: str):
    """The duplicate job's decode: the original, JPEG in draft mode."""
    from PIL import Image

    from spacedrive_tpu_torch.ops import phash_torch

    with Image.open(path) as img:
        if img.format == "JPEG":
            img.draft("RGB", (phash_torch.DCT_SIZE, phash_torch.DCT_SIZE))
        return phash_torch.to_gray32(np.asarray(img.convert("RGBA")))


def _duplicates_run(data_dir: str) -> tuple[list, dict, float]:
    import asyncio

    from spacedrive_tpu_torch.cli import duplicates_library
    from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

    t0 = time.perf_counter()
    groups = asyncio.run(duplicates_library(data_dir, "smoke", DUP_THRESHOLD, DEVICE))
    seconds = time.perf_counter() - t0
    lib = _open_library(data_dir)
    try:
        row = lib.db.query_one("SELECT metadata FROM job WHERE name = 'duplicate_detector' "
                               "ORDER BY date_created DESC, rowid DESC LIMIT 1")
    finally:
        lib.close()
    return groups, unpackb(row["metadata"]), seconds


def split_one_object(data_dir: str) -> None:
    """Move the last file of a non-image object that several files share
    onto a new object of the same kind: the state two devices leave when
    each mints an object for one cas_id before sync merges them, and the
    one exact-duplicate group a scan alone never makes."""
    from spacedrive_tpu_torch.files.kind import ObjectKind

    lib = _open_library(data_dir)
    try:
        row = lib.db.query_one(
            "SELECT fp.id, fp.object_id, o.kind FROM file_path fp "
            "JOIN object o ON o.id = fp.object_id WHERE o.kind != ? AND fp.object_id IN "
            "(SELECT object_id FROM file_path GROUP BY object_id HAVING COUNT(*) > 1) "
            "ORDER BY fp.id DESC LIMIT 1", (int(ObjectKind.Image),))
        check(row is not None, "no object is shared by two files")
        new = lib.db.insert("object", pub_id=b"split-object" + row["object_id"].to_bytes(4, "big"),
                            kind=row["kind"])
        lib.db.update("file_path", {"id": row["id"]}, object_id=new)
    finally:
        lib.close()


def check_duplicates(data_dir: str, corpus: str, pairs: list[tuple[str, str]]) -> dict:
    """`duplicates` through the CLI helper, after `split_one_object`:
    every image object hashed (8 bytes), the bits equal to the plain CPU
    path on the same gray planes but for counted near-median flips,
    every planted pair in one near group, the exact groups equal to the
    DB's cas_id groups (one), and a second run hashing nothing."""
    import torch as _torch

    from spacedrive_tpu_torch.files.kind import ObjectKind
    from spacedrive_tpu_torch.ops import phash_torch

    split_one_object(data_dir)
    groups, meta, seconds = _duplicates_run(data_dir)
    lib = _open_library(data_dir)
    try:
        objs = lib.db.query("SELECT id, phash FROM object WHERE kind = ?", (int(ObjectKind.Image),))
        rows = lib.db.query("SELECT * FROM file_path WHERE is_dir = 0 AND object_id IS NOT NULL")
    finally:
        lib.close()
    check(all(o["phash"] is not None and len(o["phash"]) == 8 for o in objs),
          "an image object has no 8-byte phash")
    check(meta["hashed"] == len(objs), f"the job hashed {meta['hashed']} of {len(objs)} images")
    path_of = {}
    for r in rows:
        path_of.setdefault(r["object_id"], _row_path(corpus, r))
    with ThreadPoolExecutor(8) as pool:
        planes = np.stack(list(pool.map(_gray_plane, [path_of[o["id"]] for o in objs])))
    plain = np.unpackbits(phash_torch.phash_batch(planes, "cpu"), axis=1)
    got = np.unpackbits(np.frombuffer(b"".join(o["phash"] for o in objs), np.uint8)
                        .reshape(-1, 8), axis=1)
    ac = phash_torch.dct_low(_torch.from_numpy(planes)).numpy()
    med = np.median(ac[:, 1:], axis=1, keepdims=True)
    near_median = np.abs(ac - med) <= 1e-5 * np.abs(ac).max(axis=1, keepdims=True)
    flips = got != plain
    check(not (flips & ~near_median).any(), "a pHash bit away from the median differs from "
          "the plain CPU path")

    object_of = {p: oid for oid, p in path_of.items()}
    near = [set(g["object_ids"]) for g in groups if g["kind"] == "near"]
    for a, b in pairs:
        oa, ob = object_of[a], object_of[b]
        check(any(oa in g and ob in g for g in near), f"planted pair {a}, {b} is in no near group")
    by_cas: dict[str, set] = {}
    for r in rows:
        if r["cas_id"] is not None:
            by_cas.setdefault(r["cas_id"], set()).add(r["object_id"])
    want_exact = sorted(sorted(ids) for ids in by_cas.values() if len(ids) > 1)
    got_exact = sorted(sorted(g["object_ids"]) for g in groups if g["kind"] == "exact")
    check(got_exact == want_exact and len(want_exact) == 1,
          f"exact groups {got_exact} != the DB's cas_id groups {want_exact}")

    groups2, meta2, seconds2 = _duplicates_run(data_dir)
    check(meta2["hashed"] == 0, f"the second duplicates run hashed {meta2['hashed']}")
    check([sorted(g["object_ids"]) for g in groups2] == [sorted(g["object_ids"]) for g in groups],
          "the second duplicates run found other groups")
    print(f"phase 5: duplicates: {len(objs)} image objects hashed on the card, {int(flips.sum())} "
          f"bits differ from the plain CPU path (all within 1e-5 of the median); {len(near)} near "
          f"groups hold every one of the {len(pairs)} planted pairs; {len(got_exact)} exact "
          f"groups == the DB's; a second run hashed 0", flush=True)
    return {"images": len(objs), "seconds": seconds, "second_run_s": seconds2,
            "near_groups": len(near), "exact_groups": len(got_exact),
            "flips_near_median": int(flips.sum()), "reused": meta.get("reused", 0)}


def _popcount64(x: np.ndarray) -> np.ndarray:
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x)
    table = np.array([bin(i).count("1") for i in range(256)], np.uint8)
    return table[x.view(np.uint8)].reshape(*x.shape, 8).sum(-1)


def host_pairs(h64: np.ndarray, threshold: int) -> list[tuple[int, int]]:
    """All pairs (i < j) within `threshold` bits, row-major, by XOR and
    popcount on the host."""
    out = []
    for off in range(0, len(h64), 512):
        d = _popcount64(h64[off:off + 512, None] ^ h64[None, :])
        r, c = np.nonzero(d <= threshold)
        keep = off + r < c
        out += list(zip((off + r[keep]).tolist(), c[keep].tolist()))
    return out


def check_near_pairs_at_scale(rng) -> dict:
    """`near_pairs` at N_PAIR_HASHES seeded hashes with N_PAIR_CLUSTERS
    planted clusters (2-4 members, each at most DUP_THRESHOLD/2 bits from
    its centre): every planted pair returned, every returned pair within
    the threshold by host XOR-popcount, and on the first N_PAIR_SUBSET
    hashes the pair set equal to a host all-pairs."""
    from spacedrive_tpu_torch.ops import phash_torch

    bits = rng.integers(0, 2, (N_PAIR_HASHES, 64)).astype(bool)
    members = rng.permutation(N_PAIR_HASHES)[:N_PAIR_CLUSTERS * 4].reshape(N_PAIR_CLUSTERS, 4)
    planted = set()
    for c, row in enumerate(members):
        size = 2 + c % 3
        centre = bits[row[0]].copy()
        for m in row[:size]:
            flip = rng.choice(64, int(rng.integers(0, DUP_THRESHOLD // 2 + 1)), replace=False)
            bits[m] = centre
            bits[m, flip] ^= True
        for i in range(size):
            for j in range(i + 1, size):
                planted.add((int(min(row[i], row[j])), int(max(row[i], row[j]))))
    packed = np.packbits(bits, axis=1)
    hashes = [h.tobytes() for h in packed]
    h64 = packed.view(">u8").reshape(-1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pairs = list(phash_torch.near_pairs(hashes, DUP_THRESHOLD, DEVICE))
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = set(pairs)
    check(len(got) == len(pairs), "near_pairs returned a pair twice")
    check(planted <= got, f"{len(planted - got)} planted pairs missing from near_pairs")
    a = np.array([p[0] for p in pairs])
    b = np.array([p[1] for p in pairs])
    dist = _popcount64(h64[a] ^ h64[b])
    check(bool((dist <= DUP_THRESHOLD).all()), "near_pairs returned a pair beyond the threshold")
    sub = list(phash_torch.near_pairs(hashes[:N_PAIR_SUBSET], DUP_THRESHOLD, DEVICE))
    check(sub == host_pairs(h64[:N_PAIR_SUBSET], DUP_THRESHOLD),
          f"near_pairs on {N_PAIR_SUBSET} hashes != the host all-pairs")
    print(f"phase 5: near_pairs at {N_PAIR_HASHES} hashes: {len(pairs)} pairs in {seconds:.3f} s "
          f"(peak device memory {peak / 2**30:.2f} GiB), all {len(planted)} planted pairs among "
          f"them, all within {DUP_THRESHOLD} bits; the {N_PAIR_SUBSET}-hash subset's {len(sub)} "
          f"pairs == host all-pairs", flush=True)
    return {"hashes": N_PAIR_HASHES, "pairs": len(pairs), "planted_pairs": len(planted),
            "seconds": seconds, "peak_device_bytes": peak, "subset_pairs": len(sub)}


def _search(data_dir: str, query: str, semantic: bool, take: int) -> dict:
    import asyncio

    from spacedrive_tpu_torch.cli import search_library

    return asyncio.run(search_library(query, data_dir, "smoke", semantic, take, DEVICE))


def check_search(data_dir: str, images: list[str], rng) -> dict:
    """`search` through the CLI helper: a corpus image's path ranks its
    own object first at cosine 1 ± 1e-5; a name search equals its SQL;
    a label-name probe is the centroid of the labeled objects' vectors
    and ranks as a host float64 ranking does."""
    from spacedrive_tpu_torch.models import embedder

    probe_path = images[int(rng.integers(len(images)))]
    t0 = time.perf_counter()
    out = _search(data_dir, probe_path, True, 5)
    semantic_s = time.perf_counter() - t0
    check(out["resolved"] and len(out["nodes"]) == 5, f"semantic query by path: {out}")
    first = out["nodes"][0]
    name = os.path.basename(probe_path)
    check(f"{first['name']}.{first['extension']}" == name,
          f"semantic query by {name} ranked {first['name']} first")
    check(abs(first["score"] - 1.0) <= 1e-5, f"self cosine {first['score']}")

    out = _search(data_dir, "img01", False, 10)
    lib = _open_library(data_dir)
    try:
        want = [r["id"] for r in lib.db.query(
            "SELECT id FROM file_path WHERE name LIKE '%img01%' ORDER BY name ASC, id ASC "
            "LIMIT 10")]
        objs = [r["object_id"] for r in lib.db.query(
            "SELECT object_id FROM object_embedding ORDER BY object_id LIMIT 3")]
        lid = lib.db.insert("label", name="smoke-label")
        for oid in objs:
            lib.db.insert("label_on_object", label_id=lid, object_id=oid)
        emb = {r["object_id"]: embedder.blob_to_vector(r["vector"])
               for r in lib.db.query("SELECT object_id, vector FROM object_embedding")}
        fp_of = {r["object_id"]: r["id"] for r in lib.db.query(
            "SELECT object_id, MIN(id) AS id FROM file_path WHERE object_id IS NOT NULL "
            "GROUP BY object_id")}
    finally:
        lib.close()
    check([n["id"] for n in out["nodes"]] == want and want, f"name search != SQL {want}")

    out = _search(data_dir, "smoke-label", True, 10)
    check(out["resolved"] is True, "the label-name probe did not resolve")
    ids = sorted(emb)
    unit = np.stack([emb[i] / np.linalg.norm(emb[i]) for i in ids]).astype(np.float64)
    centroid = unit[[ids.index(o) for o in objs]].mean(0)
    centroid /= np.linalg.norm(centroid)
    scores = unit @ centroid
    order = np.argsort(-scores, kind="stable")[:10]
    check([n["id"] for n in out["nodes"]] == [fp_of[ids[i]] for i in order],
          "the label-name probe ranks otherwise than the host")
    check(np.allclose([n["score"] for n in out["nodes"]], scores[order], atol=1e-5, rtol=1e-5),
          "label-name probe scores differ from the host's")
    print(f"phase 5: search: {name} ranks itself first (cosine {first['score']:.7f}); name "
          f"search == SQL ({len(want)} rows); label probe == host ranking", flush=True)
    return {"semantic_query_s": semantic_s}


def check_query_at_scale(rng) -> dict:
    """The scorer at N_SEARCH_VECTORS seeded vectors with planted exact
    ties: the card's top-k ids equal a host stable ranking of the card's
    scores (np.argsort(-s, kind="stable")), ties included, and the
    scores equal a host float64 product within 1e-5."""
    import types

    from spacedrive_tpu_torch.object.search import index as search_index

    m = rng.standard_normal((N_SEARCH_VECTORS, 128), dtype=np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    probe_row = int(rng.integers(N_SEARCH_VECTORS))
    tied = np.array([t for t in rng.permutation(N_SEARCH_VECTORS)[:513] if t != probe_row][:512])
    m[tied[:8]] = m[probe_row]  # 9 rows tied at the top
    for k in range(8, 512, 4):  # 126 more groups of 4 tied rows
        m[tied[k + 1:k + 4]] = m[tied[k]]
    dev_m = torch.from_numpy(m).to(DEVICE)
    probe = torch.from_numpy(m[probe_row]).to(DEVICE)
    scores, rows = search_index.score_top_k(dev_m, probe, SEARCH_K)
    s = (dev_m * probe).sum(dim=1).cpu().numpy()
    want = np.argsort(-s, kind="stable")[:SEARCH_K]
    check(rows.cpu().numpy().tolist() == want.tolist(), "the card's top-k != the host's stable ranking")
    check(sorted(rows[:9].tolist()) == rows[:9].tolist()
          and set(rows[:9].tolist()) == {probe_row, *tied[:8].tolist()},
          "the tied top rows are not in row order")
    host = m.astype(np.float64) @ m[probe_row].astype(np.float64)
    check(np.allclose(scores.cpu().numpy(), host[want], atol=1e-5, rtol=1e-5),
          "scores differ from the host float64 product")
    query_ms = cuda_ms(lambda: search_index.score_top_k(dev_m, probe, SEARCH_K), reps=20)
    library_ms = cuda_ms(lambda: torch.topk(dev_m @ probe, SEARCH_K), reps=20)
    idx = search_index.LibraryIndex(types.SimpleNamespace(node=None))
    idx._matrix, idx._ids, idx._loaded = m, list(range(N_SEARCH_VECTORS)), True
    idx.query(m[probe_row], SEARCH_K, DEVICE)  # uploads the matrix once
    t0 = time.perf_counter()
    for _ in range(10):
        idx.query(m[probe_row], SEARCH_K, DEVICE)
    host_query_ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f"phase 5: query at {N_SEARCH_VECTORS} vectors: top-{SEARCH_K} == host stable "
          f"ranking, 9 tied top rows in row order; {query_ms:.3f} ms a query on the card "
          f"({host_query_ms:.3f} ms through LibraryIndex.query)", flush=True)
    return {"vectors": N_SEARCH_VECTORS, "k": SEARCH_K, "score_top_k_ms": query_ms,
            "matmul_topk_ms": library_ms, "library_query_ms": host_query_ms}


def read_side_ops_ms(rng) -> dict:
    """The read side's torch programs at the main path's shapes: the DCT
    of 64 planes (one duplicate step), one near_pairs block (4096 rows
    against 262,144 columns)."""
    from spacedrive_tpu_torch.ops import phash_torch

    gray = torch.from_numpy(rng.random((64, 32, 32), dtype=np.float32)).to(DEVICE)
    cols = phash_torch._plus_minus(torch.from_numpy(
        rng.integers(0, 2, (N_PAIR_HASHES, 64)).astype(bool)).to(DEVICE))
    return {
        "phash_64_ms": cuda_ms(lambda: phash_torch.phash_bits(gray), reps=20),
        "near_pairs_block_4096x262144_ms": cuda_ms(
            lambda: phash_torch.match_bitmap(cols[:phash_torch.PAIR_BLOCK], cols, DUP_THRESHOLD),
            reps=10),
    }


def phase_read_side(rng, p4: dict) -> dict:
    corpus, data_dir = p4["corpus"], p4["data_dir"]
    t_phase = time.perf_counter()
    steps_s: dict[str, float] = {}  # wall seconds of each step, its checks included

    def step(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        steps_s[name] = time.perf_counter() - t0
        return out

    pairs = step("near_copies", add_near_duplicates, corpus, p4["images"], rng)
    scan = step("rescan", run_library_pass, corpus, data_dir)
    check(scan["media"]["thumbnails_dispatched"] == len(pairs),
          f"the rescan's media job dispatched {scan['media']['thumbnails_dispatched']} "
          f"thumbnails, want the {len(pairs)} near copies")
    print(f"phase 5: +{len(pairs)} near duplicates scanned in {scan['numbers']['seconds']:.1f} s "
          f"(K1 launches {scan['launches']})", flush=True)

    got = step("validator", run_validator, data_dir, corpus)
    validator = {**step("validator_check", check_validator, data_dir, corpus, got, rng),
                 **{k: got[k] for k in ("seconds", "launches", "device_files", "host_files",
                                        "split_s")}}
    duplicates = step("duplicates", check_duplicates, data_dir, corpus, pairs)
    near_pairs = step("near_pairs_at_scale", check_near_pairs_at_scale, rng)
    search = step("search", check_search, data_dir, p4["images"], rng)
    query = step("query_at_scale", check_query_at_scale, rng)
    ops_ms = step("torch_ops", read_side_ops_ms, rng)
    out = {"cut": LIBRARY_CUT, "near_copies": len(pairs),
           "rescan": {k: scan["numbers"][k] for k in ("seconds", "files_per_s", "k1_launches")},
           "validator": validator, "duplicates": duplicates, "near_pairs": near_pairs,
           "search": {**search, **query}, "torch_ops_ms": ops_ms, "steps_s": steps_s,
           "seconds": time.perf_counter() - t_phase}
    print(json.dumps({"read_side": out}), flush=True)
    return {"launches": {"read_side_rescan": scan["launches"], "validator": got["launches"]}}


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
        read = phase_read_side(rng, lib)
    # launches on the main paths, each counted from 0 just before it
    kernel["launches_by_path"] = {"index_pass": got["launches"], **lib["launches"],
                                  **read["launches"]}
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
