"""The embedder's input decode, without torch.

`decode_image` turns an image file into the embedder's input plane. It
lives apart from `models/embedder.py` (which re-exports it) because the
process pool's `embed.decode` stage runs it in workers that import
neither torch nor jax (parallel/procworker.py); the inline path and the
pooled one run this same function, so their planes are bit-identical.
"""

from __future__ import annotations

import numpy as np

#: the embedder's input edge: [IMAGE_SIZE, IMAGE_SIZE, 3] planes
IMAGE_SIZE = 32


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
