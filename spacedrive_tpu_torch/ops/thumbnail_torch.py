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
uint8. The matmuls run inside `utils/precision.strict_fp32`, so they are
full float32 even where the caller turned TF32 on. A bucket's batch can
split over a slot list and rides the device ladder (`resize_batch`);
the `device.thumbnail` fault point sits before every bucket's dispatch
on the ladder's path. The target dims and the orientation live in
`thumbnail_dims.py`, which imports no torch (the process pool's
thumbnail stage runs them), and are re-exported here.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..parallel import mesh as _mesh
from ..telemetry import metrics as _tm
from ..utils import faults as _faults
from ..utils.precision import strict_fp32
from .cas import shard_occupancy
from .thumbnail_dims import (  # noqa: F401 - re-exported: the dims live torch-free
    TARGET_PX,
    VIDEO_MAX_DIM,
    apply_orientation,
    scale_dimensions,
    video_dimensions,
)

WEBP_QUALITY = 30  # ref:thumbnail/mod.rs:49

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
        with strict_fp32(canvases.device):
            rows = torch.bmm(wy, x).reshape(-1, th, bw, ch)  # [k, th, bw, c]
            res = torch.einsum("kow,khwc->khoc", wx, rows)  # [k, th, tw, c]
        out[sl] = torch.round(res).clamp_(0, 255).to(torch.uint8)
    return out


def _resize_bucket(
    images, targets, flip, idxs, bh: int, bw: int, slots: list[torch.device],
    fault_point: bool,
) -> np.ndarray:
    """Pack one bucket's canvases on the host and resample them over the
    slot list `slots` (one equal share of the padded batch per slot,
    launched on every slot before any is read back); returns the
    [bpad, th_max, tw_max, 4] uint8 result, validated: a device that
    returns the wrong shape is an error the caller can demote on, never
    a silent corruption."""
    n_dev = len(slots)
    # pad the batch to a power of two (a few shapes, not one per group
    # size); a sharded call also rounds up to the slot count so rows
    # divide evenly
    bpad = 1 << max(0, (len(idxs) - 1).bit_length())
    if n_dev > 1:
        bpad = max(bpad, n_dev)
        bpad += (-bpad) % n_dev
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
    spec = _faults.hit("device.thumbnail") if fault_point else None
    if spec is not None:
        if spec.mode == "raise":
            raise _faults.InjectedFault("injected device failure (thumbnail)")
        if spec.mode == "xla":
            raise _faults.device_error("device.thumbnail")
    r = bpad // n_dev
    if n_dev > 1:
        _tm.SHARD_BATCH_ROWS.observe(r, op="thumbnail")
        for frac in shard_occupancy(len(idxs), bpad, n_dev):
            _tm.DEVICE_DISPATCH_OCCUPANCY.observe(frac, op="thumbnail")
    shares = [
        _resize_canvases(
            torch.from_numpy(canv[s * r:(s + 1) * r]).to(dev),
            torch.from_numpy(scales[s * r:(s + 1) * r]).to(dev),
            th_max, tw_max,
        )
        for s, dev in enumerate(slots)
    ]
    out = np.concatenate([share.cpu().numpy() for share in shares])
    if spec is not None and spec.mode == "wrong_shape":
        out = out[:, : th_max // 2]
    if out.shape != (bpad, th_max, tw_max, 4):
        raise ValueError(
            f"device resize returned shape {out.shape}, "
            f"expected {(bpad, th_max, tw_max, 4)}"
        )
    return out


def resize_batch(
    images: Sequence[np.ndarray],
    targets: Sequence[tuple[int, int]],
    out_size: int = OUT_CANVAS,
    device: str | torch.device = "cuda",
    devices: Sequence[torch.device] | None = None,
) -> list[np.ndarray]:
    """Resize a batch of HxWx4 uint8 RGBA images to per-image (th, tw).

    Groups by input bucket, packs each bucket's canvases on the host
    (portraits transposed into the landscape half, edges replicated into
    the padding, the batch padded to a power of two), copies them to the
    device and resamples them in one batched call per bucket and slot.
    Returns the resized uint8 arrays in input order. Images larger than
    the last bucket, or targets beyond `out_size`, must be filtered by
    the caller (process.needs_cpu_fallback).

    Explicit `devices` split every bucket's batch over that slot list,
    strict and past the `device.thumbnail` fault point (the thumbnailer's
    CPU fallback is `devices=[cpu]`). Otherwise a bucket rides the
    degradation ladder on `device` (parallel/mesh.run_on_ladder): sharded
    over the dispatch devices when each gets a real image, re-run at the
    demoted rung when it fails. The per-image math is the same at every
    rung and share, so pixels never change."""
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
        def call(slots, idxs=idxs, bh=bh, bw=bw, fault_point=True):
            return _resize_bucket(images, targets, flip, idxs, bh, bw, slots, fault_point)

        if devices is not None:
            out = call([torch.device(d) for d in devices], fault_point=False)
        else:
            out = _mesh.run_on_ladder(device, len(idxs), call, "thumbnail.ladder")
        for j, i in enumerate(idxs):
            th, tw = targets[i]
            if flip[i]:
                results[i] = np.transpose(out[j, :tw, :th], (1, 0, 2))
            else:
                results[i] = out[j, :th, :tw]
    return results  # type: ignore[return-value]
