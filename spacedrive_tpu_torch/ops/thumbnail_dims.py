"""Thumbnail target dimensions and EXIF orientation, without torch.

Counterpart of `scale_dimensions`, `video_dimensions` and
`apply_orientation` of `spacedrive_tpu/ops/thumbnail_jax.py`. They live
apart from `ops/thumbnail_torch.py` (which re-exports them) because the
host half of the thumbnail pipeline (object/media/thumbnail/host.py)
runs in process-pool workers that import neither torch nor jax.
"""

from __future__ import annotations

import math

import numpy as np

TARGET_PX = 262144  # ref:core/src/object/media/thumbnail/mod.rs:45
VIDEO_MAX_DIM = 256  # ref:thumbnail/process.rs:470


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
