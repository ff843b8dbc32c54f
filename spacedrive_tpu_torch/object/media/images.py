"""Still-image decode through PIL.

Counterpart of the generic handler of `spacedrive_tpu/object/media/
images.py` (ref:crates/images/src/handler.rs:18-60 routes the common
formats to the `image` crate; here PIL). HEIF, SVG and PDF decode are
not part of this package yet.
"""

from __future__ import annotations

import os

import numpy as np

MAXIMUM_FILE_SIZE = 192 * 1024 * 1024  # ref:crates/images/src/consts.rs:9


class ImageHandlerError(Exception):
    pass


def format_image(path: str) -> np.ndarray:
    """Decode a still image to RGBA uint8 [H, W, 4]."""
    from PIL import Image

    if os.path.getsize(path) > MAXIMUM_FILE_SIZE:
        raise ImageHandlerError(f"file over {MAXIMUM_FILE_SIZE} bytes")
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))
