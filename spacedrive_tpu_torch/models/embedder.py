"""Deterministic patch-pool image embedder, the semantic-search trunk.

Counterpart of `spacedrive_tpu/models/embedder.py`: an 8×8 grid of 4×4
patch means, then a two-layer tanh projection to a 128-wide float32
vector per image. Weights derive from a fixed seed through a pinned
bit generator (PCG64(0), the same numpy stream as the JAX package), so
every node materializes the same projection; `load_jax_params` carries
the JAX package's weights (or an `embedder.npz` checkpoint's tree) into
the module instead.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

#: fixed model vocabulary (vector width on the wire and in the DB)
EMBED_DIM = 128
IMAGE_SIZE = 32
PATCH = 4  # mean-pool patch edge → (IMAGE_SIZE/PATCH)² · 3 features
HIDDEN = 128
MODEL_NAME = "patchpool-v1"

_PARAM_NAMES = ("w1", "b1", "w2", "b2")


def derived_params() -> dict[str, np.ndarray]:
    """Seed-derived projection weights: the PCG64(0) stream, drawn in the
    same order and shapes as the JAX package, so the arrays are
    byte-identical to its `params()` without a checkpoint."""
    rng = np.random.Generator(np.random.PCG64(0))
    feat = (IMAGE_SIZE // PATCH) ** 2 * 3
    return {
        "w1": rng.standard_normal((feat, HIDDEN)).astype(np.float32)
        * np.float32(1.0 / np.sqrt(feat)),
        "b1": np.zeros((HIDDEN,), np.float32),
        "w2": rng.standard_normal((HIDDEN, EMBED_DIM)).astype(np.float32)
        * np.float32(1.0 / np.sqrt(HIDDEN)),
        "b2": np.zeros((EMBED_DIM,), np.float32),
    }


class PatchPoolEmbedder(nn.Module):
    """[B, S, S, 3] float32 in [0, 1] → [B, EMBED_DIM] float32 (the JAX
    package's channels-last layout). Per-row math only: no cross-batch
    reductions, so padding the batch changes no real row."""

    def __init__(self, device: str | torch.device = "cuda"):
        super().__init__()
        feat = (IMAGE_SIZE // PATCH) ** 2 * 3
        self.w1 = nn.Parameter(torch.empty(feat, HIDDEN, device=device), requires_grad=False)
        self.b1 = nn.Parameter(torch.empty(HIDDEN, device=device), requires_grad=False)
        self.w2 = nn.Parameter(torch.empty(HIDDEN, EMBED_DIM, device=device), requires_grad=False)
        self.b2 = nn.Parameter(torch.empty(EMBED_DIM, device=device), requires_grad=False)
        load_jax_params(self, derived_params())

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(torch.float32)
        b = x.shape[0]
        g = IMAGE_SIZE // PATCH
        x = x.reshape(b, g, PATCH, g, PATCH, 3).mean(dim=(2, 4)).reshape(b, g * g * 3)
        h = torch.tanh(x @ self.w1 + self.b1)
        return h @ self.w2 + self.b2


@torch.no_grad()
def load_jax_params(module: PatchPoolEmbedder, params: dict[str, np.ndarray]) -> PatchPoolEmbedder:
    """Load the JAX package's `{w1, b1, w2, b2}` numpy tree
    (`spacedrive_tpu.models.embedder.params()`, or an `embedder.npz`
    checkpoint's tree) into `module` on its device. Shapes must match."""
    for name in _PARAM_NAMES:
        if name not in params:
            raise ValueError(f"embedder params lack {name!r}")
        dst = getattr(module, name)
        src = torch.from_numpy(np.asarray(params[name], np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
        dst.copy_(src)
    return module


def decode_image(path: str, image_size: int = IMAGE_SIZE) -> np.ndarray | None:
    """Decode one image to the embedder's input plane, [S, S, 3] float32
    in [0, 1] (the JAX package's decode: RGBA → RGB → PIL resize);
    None when undecodable."""
    from PIL import Image

    from ..object.media.images import ImageHandlerError, format_image

    try:
        rgba = format_image(path)
    except (OSError, ValueError, ImageHandlerError):
        return None
    img = Image.fromarray(rgba).convert("RGB").resize((image_size, image_size))
    return np.asarray(img, np.float32) / 255.0
