"""Batched thumbnail resize on the device.

Counterpart of `spacedrive_tpu/ops/thumbnail_jax.py`. Parity targets
(behavior): ref:core/src/object/media/thumbnail/process.rs:394-461
(decode → `scale_dimensions` to TARGET_PX=262144 → Triangle-filter
resize → EXIF orientation → webp quality 30) and
ref:crates/images/src/lib.rs:89 (`scale_dimensions`).

Decoded images pad into canvas buckets (squares plus landscape halves;
portraits transpose in, edges replicate into the padding) and each
bucket resizes in one batched call. The JAX package resamples with
`jax.image.scale_and_translate(method="triangle", antialias=True)`, an
XLA program of two weight contractions per image. Here the same triangle
weight matrices (built as in jax/_src/image/scale.py compute_weight_mat:
kernel widened by 1/scale when downsampling, half-pixel sample centres,
columns normalised to sum 1, samples outside the input zeroed) feed two
batched float32 matmuls, then round half to even, clip, and cast to
uint8. TF32 stays off (`torch.backends.cuda.matmul.allow_tf32` is False
by default and is not touched), so the products are full float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

TARGET_PX = 262144  # ref:core/src/object/media/thumbnail/mod.rs:45
WEBP_QUALITY = 30  # ref:thumbnail/mod.rs:49
VIDEO_MAX_DIM = 256  # ref:thumbnail/process.rs:470

# Square input buckets; 4096 is the reference's max decodable dimension
# (ref:crates/images/src/consts.rs:33).
BUCKETS = (256, 512, 1024, 2048, 4096)
# Output canvas: covers aspect ratios up to 4:1 at TARGET_PX; more
# extreme aspects resize on the host (object/media/thumbnail/process.py).
OUT_CANVAS = 1024
MAX_ASPECT = (OUT_CANVAS * OUT_CANVAS) / TARGET_PX  # 4.0

# float32 working set of one resize slice: canvases convert from uint8 a
# slice at a time, so 32 canvases of the 4096 bucket never need 8.6 GB
_SLICE_BYTES = 1 << 30


def scale_dimensions(w: int, h: int, target_px: int = TARGET_PX) -> tuple[int, int]:
    """Aspect-preserving dims with w*h ≈ target_px; never upscales
    (ref:crates/images/src/lib.rs:89)."""
    if w * h <= target_px:
        return w, h
    ratio = math.sqrt(target_px / (w * h))
    return max(1, round(w * ratio)), max(1, round(h * ratio))


def video_dimensions(w: int, h: int, max_dim: int = VIDEO_MAX_DIM) -> tuple[int, int]:
    """Bound the max dimension (video thumbs, ref:sd_ffmpeg size=256)."""
    if max(w, h) <= max_dim:
        return w, h
    ratio = max_dim / max(w, h)
    return max(1, round(w * ratio)), max(1, round(h * ratio))


def bucket_for(h: int, w: int) -> tuple[int, int] | None:
    """Smallest canvas bucket holding (h, w) in its landscape
    orientation; None if over the cap. Buckets are (b, b) squares plus,
    from 1024 up, the (b/2, b) landscape half, which halves the padded
    transfer for the common photo aspects."""
    m = max(h, w)
    b = next((x for x in BUCKETS if m <= x), None)
    if b is None:
        return None
    half = b // 2
    if b >= 1024 and min(h, w) <= half:
        return (half, b)
    return (b, b)


def weight_matrix(
    in_size: int, out_size: int, scale: torch.Tensor
) -> torch.Tensor:
    """Antialiased triangle resampling weights, [B, out_size, in_size]
    float32, for per-image scales `scale` float32 [B] (output / input).
    Row o holds the weights of output sample o over the input pixels."""
    inv_scale = 1.0 / scale  # float32, as jax computes it
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_idx = torch.arange(out_size, dtype=torch.float32, device=scale.device)
    in_idx = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    sample_f = (out_idx[None, :] + 0.5) * inv_scale[:, None] - 0.5  # [B, out]
    x = (sample_f[:, :, None] - in_idx[None, None, :]).abs() / kernel_scale[:, None, None]
    weights = torch.clamp(1.0 - x.abs(), min=0.0)  # [B, out, in]
    total = weights.sum(dim=2, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, 1.0),
        0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, :, None], weights, 0.0)


def _resize_canvases(
    canvases: torch.Tensor, scales: torch.Tensor, th: int, tw: int
) -> torch.Tensor:
    """[B, BH, BW, 4] uint8 canvases, per-image (sy, sx) float32 scales
    → [B, th, tw, 4] uint8: the top-left th x tw of each resampled
    canvas. Converts to float32 a slice of canvases at a time."""
    b, bh, bw, ch = canvases.shape
    out = torch.empty((b, th, tw, ch), dtype=torch.uint8, device=canvases.device)
    step = max(1, _SLICE_BYTES // (bh * bw * ch * 4))
    for s in range(0, b, step):
        sl = slice(s, min(b, s + step))
        wy = weight_matrix(bh, th, scales[sl, 0])  # [k, th, bh]
        wx = weight_matrix(bw, tw, scales[sl, 1])  # [k, tw, bw]
        x = canvases[sl].to(torch.float32).reshape(-1, bh, bw * ch)
        rows = torch.bmm(wy, x).reshape(-1, th, bw, ch)  # [k, th, bw, c]
        res = torch.einsum("kow,khwc->khoc", wx, rows)  # [k, th, tw, c]
        out[sl] = torch.round(res).clamp_(0, 255).to(torch.uint8)
    return out


def resize_batch(
    images: Sequence[np.ndarray],
    targets: Sequence[tuple[int, int]],
    out_size: int = OUT_CANVAS,
    device: str | torch.device = "cuda",
) -> list[np.ndarray]:
    """Resize a batch of HxWx4 uint8 RGBA images to per-image (th, tw).

    Groups by input bucket, packs each bucket's canvases on the host
    (portraits transposed into the landscape half, edges replicated into
    the padding, the batch padded to a power of two), copies them to
    `device` and resamples them in one batched call per bucket. Returns
    the resized uint8 arrays in input order. Images larger than the last
    bucket, or targets beyond `out_size`, must be filtered by the caller
    (process.needs_cpu_fallback)."""
    device = torch.device(device)
    results: list[np.ndarray | None] = [None] * len(images)
    by_bucket: dict[tuple[int, int], list[int]] = {}
    flip = [False] * len(images)
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        b = bucket_for(h, w)
        if b is None:
            raise ValueError(f"image {i} ({h}x{w}) exceeds max bucket")
        th, tw = targets[i]
        if max(th, tw) > out_size:
            raise ValueError(f"image {i} target {th}x{tw} exceeds the {out_size} canvas")
        # portraits ride the landscape half-canvas transposed
        flip[i] = b[0] < b[1] and h > w
        by_bucket.setdefault(b, []).append(i)

    for (bh, bw), idxs in by_bucket.items():
        bpad = 1 << max(0, (len(idxs) - 1).bit_length())
        canv = np.zeros((bpad, bh, bw, 4), np.uint8)
        scales = np.ones((bpad, 2), np.float32)
        th_max = tw_max = 1
        for j, i in enumerate(idxs):
            img = images[i]
            th, tw = targets[i]
            if flip[i]:
                img = np.transpose(img, (1, 0, 2))
                th, tw = tw, th
            h, w = img.shape[:2]
            # edge-replicate into the padding so the antialias window
            # clamps at the image boundary instead of pulling in zeros
            canv[j, :h, :w] = img
            canv[j, h:, :w] = img[h - 1:h, :]
            canv[j, :h, w:] = img[:, w - 1:w]
            canv[j, h:, w:] = img[h - 1, w - 1]
            scales[j] = (th / h, tw / w)
            th_max, tw_max = max(th_max, th), max(tw_max, tw)
        out = _resize_canvases(
            torch.from_numpy(canv).to(device),
            torch.from_numpy(scales).to(device),
            th_max, tw_max,
        ).cpu().numpy()
        if out.shape != (bpad, th_max, tw_max, 4):
            raise ValueError(
                f"device resize returned shape {out.shape}, "
                f"expected {(bpad, th_max, tw_max, 4)}"
            )
        for j, i in enumerate(idxs):
            th, tw = targets[i]
            if flip[i]:
                results[i] = np.transpose(out[j, :tw, :th], (1, 0, 2))
            else:
                results[i] = out[j, :th, :tw]
    return results  # type: ignore[return-value]


def apply_orientation(arr: np.ndarray, orientation: int) -> np.ndarray:
    """EXIF orientation 1-8 → corrected array (host views where
    possible). Parity: ref:crates/media-metadata/src/image/orientation.rs
    applied after the resize (process.rs:421-428)."""
    if orientation == 2:
        return arr[:, ::-1]
    if orientation == 3:
        return arr[::-1, ::-1]
    if orientation == 4:
        return arr[::-1]
    if orientation == 5:
        return np.transpose(arr, (1, 0, 2))
    if orientation == 6:
        return np.transpose(arr[::-1], (1, 0, 2))
    if orientation == 7:
        return np.transpose(arr[::-1, ::-1], (1, 0, 2))
    if orientation == 8:
        return np.transpose(arr[:, ::-1], (1, 0, 2))
    return arr
