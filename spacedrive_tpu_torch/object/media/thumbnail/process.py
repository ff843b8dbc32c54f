"""Thumbnail generation: host decode → batched device resize → webp.

Counterpart of `spacedrive_tpu/object/media/thumbnail/process.py`
(ref:core/src/object/media/thumbnail/process.rs:394-473). The host half
(decode by kind, the film strip, the CPU resize, webp) lives in the
torch-free `host.py` and is re-exported here. This module adds the
device half: every frame whose target fits the output canvas resamples
in batched device calls (ops/thumbnail_torch.resize_batch); aspects
beyond 4:1 resize on the host (`resize_cpu`).
"""

from __future__ import annotations

import numpy as np
import torch

from ....ops import thumbnail_torch as tt
from .host import (  # noqa: F401 - the host half, re-exported
    DOC_EXTENSIONS,
    IMAGE_EXTENSIONS,
    MAX_DIM,
    MAX_FILE_SIZE,
    PDF_EXTENSIONS,
    SVG_EXTENSIONS,
    VIDEO_EXTENSIONS,
    VIDEO_SEEK_FRACTION,
    WEBP_QUALITY,
    Decoded,
    ThumbError,
    apply_film_strip,
    can_generate,
    decode,
    decode_document,
    decode_heif_image,
    decode_image,
    decode_video_frame,
    encode_webp,
    finish,
    generate_one_cpu,
    is_video,
    resize_cpu,
    shrink_to_max_dim,
)


def needs_cpu_fallback(d: Decoded) -> bool:
    """Targets beyond the device output canvas (aspect > 4:1) resize on
    the host instead of the batched device path."""
    th, tw = d.target
    return th > tt.OUT_CANVAS or tw > tt.OUT_CANVAS or max(d.array.shape[:2]) > tt.BUCKETS[-1]


def resize_decoded(batch: list[Decoded], device: str | torch.device = "cuda",
                   devices: list[torch.device] | None = None) -> list[np.ndarray]:
    """One device call per bucket for a whole decoded batch (on the slot
    list `devices` when given, see `resize_batch`)."""
    return tt.resize_batch([d.array for d in batch], [d.target for d in batch], device=device,
                           devices=devices)
