"""The pHash input decode, without torch.

`to_gray32` and `decode_gray` turn an image into the 32×32 grayscale
plane the DCT pHash reads. They live apart from `ops/phash_torch.py`
(which re-exports `to_gray32` and `DCT_SIZE`) because the process
pool's `phash.gray` stage runs them in workers that import neither
torch nor jax (parallel/procworker.py); the duplicate job's inline
decode and the pooled one run the same functions, so their planes are
bit-identical.
"""

from __future__ import annotations

import numpy as np

#: the pHash plane's edge (the DCT's size)
DCT_SIZE = 32


def to_gray32(rgba: np.ndarray) -> np.ndarray:
    """HxWx4 uint8 → 32×32 float32 grayscale in 0..1 (PIL bilinear)."""
    from PIL import Image

    img = Image.fromarray(rgba[..., :3]).convert("L").resize(
        (DCT_SIZE, DCT_SIZE), Image.BILINEAR
    )
    return np.asarray(img, np.float32) / 255.0


def decode_gray(path: str, draft: bool) -> np.ndarray:
    """One file's gray plane; `draft` lets a JPEG decode at 1/8 DCT
    scale (the original's cheap decode; a thumbnail is read in full).
    Raises whatever PIL raises on an undecodable file."""
    from PIL import Image

    with Image.open(path) as img:
        if draft and img.format == "JPEG":
            img.draft("RGB", (DCT_SIZE, DCT_SIZE))
        return to_gray32(np.asarray(img.convert("RGBA")))
