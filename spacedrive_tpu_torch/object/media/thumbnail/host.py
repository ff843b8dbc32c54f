"""The host half of thumbnail generation: decode by kind, CPU resize, webp.

Counterpart of `spacedrive_tpu/object/media/thumbnail/process.py`
(ref:core/src/object/media/thumbnail/process.rs:394-473) minus its
device resize: still images through PIL, HEIC/HEIF/AVIF through
libheif, SVG (render cap 512²) and the first PDF page through the
`format_image` dispatch (ref:crates/images/src/handler.rs:18-60), and
one video frame ~10% in through the native FFmpeg frontend
(native/video.py, ref:crates/ffmpeg/src/movie_decoder.rs), cv2 where
libav is absent. A video frame targets `video_dimensions` (max side
256) and carries the film strip; every other kind targets
`scale_dimensions`.

This module imports neither torch nor jax: the process pool's
`thumb.cpu` stage runs `generate_one_cpu` in workers
(parallel/procworker.py), and the inline path runs the same function,
so both store the same bytes. `process.py` re-exports it beside the
device resize.

The extension sets are decided at import from what loads, as in the
JAX module: HEIF only where libheif loads, SVG only where librsvg does;
video and PDF always (a video file fails alone where neither libav nor
cv2 decodes it).
"""

from __future__ import annotations

import io
import math
import os
from dataclasses import dataclass

import numpy as np

from ....files.extensions import all_extensions
from ....native import video as _video
from ....ops.thumbnail_dims import apply_orientation, scale_dimensions, video_dimensions
from ..images import HEIF_EXTENSIONS as _HEIF_EXTS
from ..images import MAXIMUM_FILE_SIZE as MAX_FILE_SIZE
from ..images import PDF_EXTENSIONS as _PDF_EXTS
from ..images import SVG_EXTENSIONS as _SVG_EXTS
from ..images import ImageHandlerError, format_image, heif_available
from ..svg import svg_available

WEBP_QUALITY = 30  # ref:process.rs:440
MAX_DIM = 4096  # ref:crates/images/src/consts.rs:33
VIDEO_SEEK_FRACTION = 0.1  # ref:movie_decoder.rs seeks ~10% in

_PIL_DECODABLE = {
    "jpg", "jpeg", "png", "gif", "bmp", "tiff", "tif", "webp", "ico", "apng",
}
IMAGE_EXTENSIONS = tuple(e for e in all_extensions("Image") if e in _PIL_DECODABLE) + (
    tuple(e for e in all_extensions("Image") if e in _HEIF_EXTS) if heif_available() else ())
VIDEO_EXTENSIONS = tuple(all_extensions("Video"))
SVG_EXTENSIONS = tuple(sorted(_SVG_EXTS)) if svg_available() else ()
PDF_EXTENSIONS = tuple(sorted(_PDF_EXTS))
DOC_EXTENSIONS = PDF_EXTENSIONS + SVG_EXTENSIONS


class ThumbError(Exception):
    pass


@dataclass
class Decoded:
    """One decoded frame ready for the device batch."""

    array: np.ndarray  # HxWx4 uint8 RGBA
    target: tuple[int, int]  # (th, tw) scaled dims
    orientation: int = 1
    is_video: bool = False  # film strip on finish


def shrink_to_max_dim(arr: np.ndarray) -> np.ndarray:
    """Stride-downsample oversized decodes to fit the largest bucket
    (the reference rejects >4096² outright; this degrades instead)."""
    h, w = arr.shape[:2]
    if max(h, w) > MAX_DIM:
        step = math.ceil(max(h, w) / MAX_DIM)
        arr = np.ascontiguousarray(arr[::step, ::step])
    return arr


def can_generate(extension: str | None) -> bool:
    e = (extension or "").lower()
    return e in IMAGE_EXTENSIONS or e in VIDEO_EXTENSIONS or e in DOC_EXTENSIONS


def is_video(extension: str | None) -> bool:
    return (extension or "").lower() in VIDEO_EXTENSIONS


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
        tw, th = scale_dimensions(w0, h0)
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


def decode_video_frame(path: str) -> Decoded:
    """One frame ~10% into the video through the native frontend (the
    preferred stream, embedded cover art first, the display matrix's
    right-angle rotation applied here; ref:movie_decoder.rs:32-629,
    cover check :352), cv2 where libav is absent. The target bounds the
    longest side to 256 (ref:process.rs:470). Cover art is album art,
    not footage: it gets no film strip. A failed frontend build raises
    NativeBuildError (native/video.py)."""
    if _video.video_available():
        try:
            arr, rotation, is_cover = _video.video_frame(path, seek_fraction=VIDEO_SEEK_FRACTION)
        except ValueError as exc:
            raise ThumbError(str(exc)) from exc
        if rotation % 360 and rotation % 90 == 0:
            # the display matrix rotates clockwise by `rotation`
            arr = np.ascontiguousarray(np.rot90(arr, k=(-rotation // 90) % 4))
        arr = shrink_to_max_dim(arr)
        h, w = arr.shape[:2]
        tw, th = video_dimensions(w, h)
        return Decoded(array=arr, target=(th, tw), is_video=not is_cover)
    try:
        import cv2
    except ImportError as exc:
        raise ThumbError(f"video decode unavailable: {exc}") from exc
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise ThumbError(f"cannot open video: {path}")
        frames = cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0
        if frames > 0:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(frames * VIDEO_SEEK_FRACTION))
        ok, frame = cap.read()
        if not ok:
            # the first frame (a seek can fail near the end)
            cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
            ok, frame = cap.read()
        if not ok or frame is None:
            raise ThumbError(f"no decodable frame: {path}")
    finally:
        cap.release()
    rgb = shrink_to_max_dim(frame[:, :, ::-1])  # BGR → RGB
    h, w = rgb.shape[:2]
    arr = np.dstack([rgb, np.full((h, w, 1), 255, np.uint8)])
    tw, th = video_dimensions(w, h)
    return Decoded(array=np.ascontiguousarray(arr), target=(th, tw), is_video=True)


def decode_heif_image(path: str, extension: str) -> Decoded:
    """HEIC/HEIF/AVIF through libheif (ref:crates/images HEIF handler);
    libheif's transforms bake the orientation in. A file libheif cannot
    read raises ThumbError (the JAX function lets ImageHandlerError
    through)."""
    try:
        arr = format_image(path, extension)
    except ImageHandlerError as exc:
        raise ThumbError(f"heif decode failed ({path}): {exc}") from exc
    arr = shrink_to_max_dim(arr)
    h, w = arr.shape[:2]
    tw, th = scale_dimensions(w, h)
    return Decoded(array=arr, target=(th, tw))


def decode_document(path: str, extension: str) -> Decoded:
    """SVG (ref:svg.rs:14-21, render cap 512²) and the first PDF page
    (ref:pdf.rs:82-83) through the format_image dispatch; a failure is a
    ThumbError, so one bad document never aborts the batch around it."""
    try:
        arr = format_image(path, extension)
    except (ImageHandlerError, OSError) as exc:
        raise ThumbError(f"document decode failed ({path}): {exc}") from exc
    arr = shrink_to_max_dim(arr)
    h, w = arr.shape[:2]
    tw, th = scale_dimensions(w, h)
    return Decoded(array=arr, target=(th, tw))


def decode(path: str, extension: str | None) -> Decoded:
    """The decoder for `extension`."""
    ext = (extension or "").lower()
    if not can_generate(ext):
        raise ThumbError(f"no decoder for extension {extension!r}: {path}")
    if is_video(ext):
        return decode_video_frame(path)
    if ext in _HEIF_EXTS:
        return decode_heif_image(path, ext)
    if ext in DOC_EXTENSIONS:
        return decode_document(path, ext)
    return decode_image(path)


def encode_webp(arr: np.ndarray, quality: int = WEBP_QUALITY) -> bytes:
    """RGBA uint8 → webp bytes at the reference's quality 30
    (ref:process.rs:431-440)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, "RGBA").save(buf, "WEBP", quality=quality)
    return buf.getvalue()


def apply_film_strip(arr: np.ndarray) -> np.ndarray:
    """Sprocket-hole side strips marking video thumbnails
    (ref:crates/ffmpeg/src/film_strip.rs draws the same overlay)."""
    arr = arr.copy()
    h, w = arr.shape[:2]
    strip = max(4, min(w // 10, 20))
    hole_h = max(2, strip // 2)
    hole_w = max(2, strip // 2)
    pitch = hole_h * 3
    for x0, x1 in ((0, strip), (w - strip, w)):
        arr[:, x0:x1, :3] = (arr[:, x0:x1, :3] * 0.2).astype(np.uint8)
        cx0 = x0 + (strip - hole_w) // 2
        for y in range((pitch - hole_h) // 2, h - hole_h, pitch):
            arr[y:y + hole_h, cx0:cx0 + hole_w, :3] = 235
    return arr


def finish(decoded: Decoded, resized: np.ndarray) -> bytes:
    """Orientation-correct a resized frame, overlay the film strip on a
    video frame, and encode."""
    arr = apply_orientation(resized, decoded.orientation)
    if decoded.is_video:
        arr = apply_film_strip(arr)
    return encode_webp(np.ascontiguousarray(arr))


def resize_cpu(d: Decoded) -> bytes:
    """The host path (extreme aspect ratios, the software actor): PIL
    resize with the Triangle (bilinear) filter, then `finish`."""
    from PIL import Image

    th, tw = d.target
    img = Image.fromarray(d.array, "RGBA").resize((tw, th), Image.BILINEAR)
    return finish(d, np.asarray(img))


def generate_one_cpu(path: str, extension: str | None) -> bytes:
    """One file's thumbnail entirely on the host (the `thumb.cpu` stage)."""
    return resize_cpu(decode(path, extension))
