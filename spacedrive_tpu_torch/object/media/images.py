"""Image decode/convert dispatch by extension.

Counterpart of `spacedrive_tpu/object/media/images.py`, whole
(ref:crates/images/src/handler.rs:18-60): `format_image` routes by
extension to the generic handler (PIL), HEIF (a ctypes binding over the
system libheif, the C library the reference links), SVG (librsvg, see
svg.py) and PDF (the bundled reader, see pdf.py); max-size guards
ref:crates/images/src/consts.rs:9,33,39. HEIF decodes through libheif
only, never through PIL: PIL's AVIF decode converts colour another way.
SVG raises `UnsupportedImage` where librsvg is absent.

The module imports neither torch nor jax: the process pool's workers
import it (models/embed_decode.py, object/media/thumbnail/host.py).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os

import numpy as np

MAXIMUM_FILE_SIZE = 192 * 1024 * 1024  # ref:consts.rs:9
SVG_RENDER_SIZE = 512  # ref:consts.rs:33 (SVG render cap 512²)
PDF_RENDER_WIDTH = 1024  # ref:consts.rs:39

HEIF_EXTENSIONS = {"heif", "heifs", "heic", "heics", "avif", "avci", "avcs"}
SVG_EXTENSIONS = {"svg", "svgz"}
PDF_EXTENSIONS = {"pdf"}


class ImageHandlerError(Exception):
    pass


class UnsupportedImage(ImageHandlerError):
    pass


# --- libheif ctypes binding (ref:crates/images HEIF handler) -------------


class _HeifError(ctypes.Structure):
    _fields_ = [
        ("code", ctypes.c_int),
        ("subcode", ctypes.c_int),
        ("message", ctypes.c_char_p),
    ]


_HEIF_COLORSPACE_RGB = 1
_HEIF_CHROMA_INTERLEAVED_RGBA = 11
_HEIF_CHANNEL_INTERLEAVED = 10

_heif: ctypes.CDLL | None = None


def _load_heif() -> ctypes.CDLL | None:
    global _heif
    if _heif is not None:
        return _heif
    name = ctypes.util.find_library("heif") or "libheif.so.1"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.heif_context_alloc.restype = ctypes.c_void_p
    lib.heif_context_read_from_file.restype = _HeifError
    lib.heif_context_read_from_file.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
    ]
    lib.heif_context_get_primary_image_handle.restype = _HeifError
    lib.heif_context_get_primary_image_handle.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.heif_decode_image.restype = _HeifError
    lib.heif_decode_image.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.heif_image_handle_get_width.restype = ctypes.c_int
    lib.heif_image_handle_get_width.argtypes = [ctypes.c_void_p]
    lib.heif_image_handle_get_height.restype = ctypes.c_int
    lib.heif_image_handle_get_height.argtypes = [ctypes.c_void_p]
    lib.heif_image_get_plane_readonly.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.heif_image_get_plane_readonly.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    lib.heif_image_release.argtypes = [ctypes.c_void_p]
    lib.heif_image_handle_release.argtypes = [ctypes.c_void_p]
    lib.heif_context_free.argtypes = [ctypes.c_void_p]
    _heif = lib
    return lib


def heif_available() -> bool:
    return _load_heif() is not None


def decode_heif(path: str) -> np.ndarray:
    """HEIC/HEIF/AVIF → RGBA uint8 via the system libheif (the same C
    library the reference links, ref:crates/images/Cargo.toml:13,32)."""
    lib = _load_heif()
    if lib is None:
        raise UnsupportedImage("libheif not available")

    def check(err: _HeifError, stage: str) -> None:
        if err.code != 0:
            msg = err.message.decode() if err.message else "?"
            raise ImageHandlerError(f"libheif {stage}: {msg} (code {err.code})")

    ctx = lib.heif_context_alloc()
    if not ctx:
        raise ImageHandlerError("heif_context_alloc failed")
    handle = ctypes.c_void_p()
    img = ctypes.c_void_p()
    try:
        check(
            lib.heif_context_read_from_file(ctx, os.fsencode(path), None), "read"
        )
        check(
            lib.heif_context_get_primary_image_handle(
                ctx, ctypes.byref(handle)
            ),
            "primary handle",
        )
        check(
            lib.heif_decode_image(
                handle,
                ctypes.byref(img),
                _HEIF_COLORSPACE_RGB,
                _HEIF_CHROMA_INTERLEAVED_RGBA,
                None,
            ),
            "decode",
        )
        width = lib.heif_image_handle_get_width(handle)
        height = lib.heif_image_handle_get_height(handle)
        stride = ctypes.c_int()
        plane = lib.heif_image_get_plane_readonly(
            img, _HEIF_CHANNEL_INTERLEAVED, ctypes.byref(stride)
        )
        if not plane:
            raise ImageHandlerError("heif: no interleaved plane")
        buf = np.ctypeslib.as_array(plane, shape=(height, stride.value))
        return buf[:, : width * 4].reshape(height, width, 4).copy()
    finally:
        if img:
            lib.heif_image_release(img)
        if handle:
            lib.heif_image_handle_release(handle)
        lib.heif_context_free(ctx)


# --- generic + dispatch ---------------------------------------------------


def decode_generic(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def decode_svg(path: str) -> np.ndarray:
    """SVG/SVGZ via librsvg (ref:handler.rs SVG → resvg). Gzip payloads
    are expanded under the same size cap as the on-disk file."""
    from . import svg as svg_mod

    if not svg_mod.svg_available():
        raise UnsupportedImage(
            "no SVG rasterizer (librsvg unavailable; reference: resvg)"
        )
    with open(path, "rb") as f:
        data = f.read(MAXIMUM_FILE_SIZE + 1)
    if len(data) > MAXIMUM_FILE_SIZE:
        raise ImageHandlerError(f"file over {MAXIMUM_FILE_SIZE} bytes")
    if data[:2] == b"\x1f\x8b":  # svgz
        import gzip
        import io as _io

        try:
            with gzip.GzipFile(fileobj=_io.BytesIO(data)) as gz:
                data = gz.read(MAXIMUM_FILE_SIZE + 1)
        except Exception as exc:
            raise ImageHandlerError(f"svgz decompress failed: {exc}") from exc
        if len(data) > MAXIMUM_FILE_SIZE:
            raise ImageHandlerError("svgz expands past the size cap")
    try:
        return svg_mod.render_svg(data)
    except ImageHandlerError:
        raise
    except Exception as exc:
        raise ImageHandlerError(f"svg render failed: {exc}") from exc


def decode_pdf(path: str) -> np.ndarray:
    """PDF first page (ref:handler.rs PDF → pdfium) via ../pdf.py."""
    from . import pdf as pdf_mod

    try:
        return pdf_mod.render_pdf(path)
    except ImageHandlerError:
        raise
    except Exception as exc:
        raise ImageHandlerError(f"pdf render failed: {exc}") from exc


def format_image(path: str, extension: str | None = None) -> np.ndarray:
    """Decode any supported still image/document to RGBA uint8
    (ref:handler.rs:18-60 `format_image` — the single dispatch)."""
    if os.path.getsize(path) > MAXIMUM_FILE_SIZE:
        raise ImageHandlerError(f"file over {MAXIMUM_FILE_SIZE} bytes")
    ext = (extension or os.path.splitext(path)[1].lstrip(".")).lower()
    if ext in HEIF_EXTENSIONS:
        return decode_heif(path)
    if ext in SVG_EXTENSIONS:
        return decode_svg(path)
    if ext in PDF_EXTENSIONS:
        return decode_pdf(path)
    return decode_generic(path)
