"""Thumbnail generation: host decode → batched device resize → webp.

Counterpart of the still-image path of `spacedrive_tpu/object/media/
thumbnail/process.py` (ref:core/src/object/media/thumbnail/process.rs:
394-461). Decode stays on the host; every image whose target fits the
output canvas resamples in batched device calls
(ops/thumbnail_torch.resize_batch); aspects beyond 4:1 resize on the host
(`resize_cpu`). Video and document decode are not part of this package
yet.
"""

from __future__ import annotations

import io
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from ....files.extensions import all_extensions
from ....ops import thumbnail_torch as tt
from ..images import MAXIMUM_FILE_SIZE as MAX_FILE_SIZE

WEBP_QUALITY = 30  # ref:process.rs:440
MAX_DIM = 4096  # ref:crates/images/src/consts.rs:33

_PIL_DECODABLE = {
    "jpg", "jpeg", "png", "gif", "bmp", "tiff", "tif", "webp", "ico", "apng",
}
IMAGE_EXTENSIONS = tuple(e for e in all_extensions("Image") if e in _PIL_DECODABLE)


class ThumbError(Exception):
    pass


@dataclass
class Decoded:
    """One decoded frame ready for the device batch."""

    array: np.ndarray  # HxWx4 uint8 RGBA
    target: tuple[int, int]  # (th, tw) scaled dims
    orientation: int = 1


def shrink_to_max_dim(arr: np.ndarray) -> np.ndarray:
    """Stride-downsample oversized decodes to fit the largest bucket
    (the reference rejects >4096² outright; this degrades instead)."""
    h, w = arr.shape[:2]
    if max(h, w) > MAX_DIM:
        step = math.ceil(max(h, w) / MAX_DIM)
        arr = np.ascontiguousarray(arr[::step, ::step])
    return arr


def can_generate(extension: str | None) -> bool:
    return (extension or "").lower() in IMAGE_EXTENSIONS


def decode_image(path: str) -> Decoded:
    """Decode a still image to RGBA, reading EXIF orientation. JPEGs
    decode in draft mode (DCT scaling to the smallest scale at or above
    the target), so huge photos decode near the target size; the device
    resample still produces exactly `scale_dimensions` dims."""
    from PIL import Image

    if os.path.getsize(path) > MAX_FILE_SIZE:
        raise ThumbError(f"file over {MAX_FILE_SIZE} bytes: {path}")
    with Image.open(path) as img:
        w0, h0 = img.size
        tw, th = tt.scale_dimensions(w0, h0)
        orientation = 1
        try:
            orientation = int(img.getexif().get(0x0112, 1) or 1)
        except (ValueError, TypeError, OSError):
            pass
        if img.format == "JPEG":
            img.draft("RGB", (tw, th))
        arr = np.asarray(img.convert("RGBA"))
    arr = shrink_to_max_dim(arr)
    h, w = arr.shape[:2]
    if min(h, w) < 1:
        raise ThumbError(f"empty image: {path}")
    return Decoded(array=arr, target=(th, tw), orientation=orientation)


def decode(path: str, extension: str | None) -> Decoded:
    """The decoder for `extension` (the JAX package's dispatcher, over
    the still-image formats this package decodes)."""
    if not can_generate(extension):
        raise ThumbError(f"no decoder for extension {extension!r}: {path}")
    return decode_image(path)


def needs_cpu_fallback(d: Decoded) -> bool:
    """Targets beyond the device output canvas (aspect > 4:1) resize on
    the host instead of the batched device path."""
    th, tw = d.target
    return th > tt.OUT_CANVAS or tw > tt.OUT_CANVAS or max(d.array.shape[:2]) > tt.BUCKETS[-1]


def encode_webp(arr: np.ndarray, quality: int = WEBP_QUALITY) -> bytes:
    """RGBA uint8 → webp bytes at the reference's quality 30."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, "RGBA").save(buf, "WEBP", quality=quality)
    return buf.getvalue()


def finish(decoded: Decoded, resized: np.ndarray) -> bytes:
    """Orientation-correct the device output and encode it."""
    arr = tt.apply_orientation(resized, decoded.orientation)
    return encode_webp(np.ascontiguousarray(arr))


def resize_decoded(batch: list[Decoded], device: str | torch.device = "cuda",
                   devices: list[torch.device] | None = None) -> list[np.ndarray]:
    """One device call per bucket for a whole decoded batch (on the slot
    list `devices` when given, see `resize_batch`)."""
    return tt.resize_batch([d.array for d in batch], [d.target for d in batch], device=device,
                           devices=devices)


def resize_cpu(d: Decoded) -> bytes:
    """Host path for extreme aspect ratios: PIL resize with the
    Triangle (bilinear) filter, then the same orientation and encode."""
    from PIL import Image

    th, tw = d.target
    img = Image.fromarray(d.array, "RGBA").resize((tw, th), Image.BILINEAR)
    arr = tt.apply_orientation(np.asarray(img), d.orientation)
    return encode_webp(np.ascontiguousarray(arr))
