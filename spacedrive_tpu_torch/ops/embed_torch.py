"""Batched image embedding on the device, the semantic-search leg.

Counterpart of `spacedrive_tpu/ops/embed_jax.py`: one forward per call,
the batch padded to a power of two (the JAX package bounds its compiled
shapes that way; here it keeps the device batch on a few sizes), the
products at full float32 (`strict_fp32`, whatever the caller's TF32
flags), the output shape checked before it is returned.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import embedder as _embedder
from ..utils.precision import strict_fp32


def embed_batch(
    images: np.ndarray,
    device: str | torch.device = "cuda",
    model: _embedder.PatchPoolEmbedder | None = None,
) -> np.ndarray:
    """Embed a [N, S, S, 3] float32 batch → [N, EMBED_DIM] float32 on
    `device`. `model` defaults to the seed-derived embedder; a given
    model must live on `device`."""
    s = _embedder.IMAGE_SIZE
    if images.ndim != 4 or images.shape[1:] != (s, s, 3):
        raise ValueError(f"embed input shape {images.shape} is not [N, {s}, {s}, 3]")
    n = images.shape[0]
    if n == 0:
        return np.zeros((0, _embedder.EMBED_DIM), np.float32)
    if model is None:
        model = _embedder.PatchPoolEmbedder(device)
    bpad = 1 << max(0, (n - 1).bit_length())
    batch = torch.zeros((bpad, s, s, 3), dtype=torch.float32, device=device)
    batch[:n] = torch.from_numpy(np.asarray(images, np.float32)).to(device)
    with torch.no_grad(), strict_fp32(batch.device):
        out = model(batch)
    if tuple(out.shape) != (bpad, _embedder.EMBED_DIM):
        raise ValueError(
            f"device embed returned shape {tuple(out.shape)}, "
            f"expected {(bpad, _embedder.EMBED_DIM)}"
        )
    return out[:n].cpu().numpy()
