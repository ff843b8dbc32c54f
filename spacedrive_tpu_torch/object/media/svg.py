"""SVG rasterization via ctypes over librsvg + cairo.

Role parity with the reference's resvg handler
(ref:crates/images/src/svg.rs:14-21: render capped at 512², then into
the normal thumbnail pipeline). Same shape here: librsvg (the system C
library GNOME ships) renders the document into a cairo ARGB32 surface
capped at `MAX_RENDER_DIM`², which is returned as an RGBA numpy array
for the batched device resize.

The port's owned copy of `spacedrive_tpu/object/media/svg.py`: the same
code, so a document decodes to the same pixels in both packages.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
from functools import lru_cache

import numpy as np

logger = logging.getLogger(__name__)

MAX_RENDER_DIM = 512  # ref:crates/images/src/consts.rs:33 (SVG cap)

_CAIRO_FORMAT_ARGB32 = 0


class _RsvgRectangle(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_double),
        ("y", ctypes.c_double),
        ("width", ctypes.c_double),
        ("height", ctypes.c_double),
    ]


class _RsvgDimensionData(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("em", ctypes.c_double),
        ("ex", ctypes.c_double),
    ]


@lru_cache(maxsize=1)
def _libs():
    """(rsvg, cairo, gobject) ctypes handles, or None if unavailable."""
    try:
        rsvg = ctypes.CDLL(
            ctypes.util.find_library("rsvg-2") or "librsvg-2.so.2"
        )
        cairo = ctypes.CDLL(
            ctypes.util.find_library("cairo") or "libcairo.so.2"
        )
        gobject = ctypes.CDLL(
            ctypes.util.find_library("gobject-2.0") or "libgobject-2.0.so.0"
        )
        return _bind(rsvg, cairo, gobject)
    except (OSError, AttributeError) as exc:
        # AttributeError = librsvg too old for render_document (< 2.46)
        logger.info("librsvg/cairo unavailable: %s", exc)
        return None


def _bind(rsvg, cairo, gobject):
    rsvg.rsvg_handle_new_from_data.restype = ctypes.c_void_p
    rsvg.rsvg_handle_new_from_data.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
    ]
    rsvg.rsvg_handle_get_dimensions.restype = None
    rsvg.rsvg_handle_get_dimensions.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_RsvgDimensionData),
    ]
    try:
        rsvg.rsvg_handle_get_intrinsic_size_in_pixels.restype = ctypes.c_int
        rsvg.rsvg_handle_get_intrinsic_size_in_pixels.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
    except AttributeError:
        pass
    rsvg.rsvg_handle_render_document.restype = ctypes.c_int
    rsvg.rsvg_handle_render_document.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(_RsvgRectangle), ctypes.c_void_p,
    ]

    cairo.cairo_image_surface_create.restype = ctypes.c_void_p
    cairo.cairo_image_surface_create.argtypes = [ctypes.c_int] * 3
    cairo.cairo_create.restype = ctypes.c_void_p
    cairo.cairo_create.argtypes = [ctypes.c_void_p]
    cairo.cairo_image_surface_get_data.restype = ctypes.POINTER(ctypes.c_ubyte)
    cairo.cairo_image_surface_get_data.argtypes = [ctypes.c_void_p]
    cairo.cairo_image_surface_get_stride.restype = ctypes.c_int
    cairo.cairo_image_surface_get_stride.argtypes = [ctypes.c_void_p]
    cairo.cairo_surface_flush.argtypes = [ctypes.c_void_p]
    cairo.cairo_destroy.argtypes = [ctypes.c_void_p]
    cairo.cairo_surface_destroy.argtypes = [ctypes.c_void_p]
    cairo.cairo_status.restype = ctypes.c_int
    cairo.cairo_status.argtypes = [ctypes.c_void_p]

    gobject.g_object_unref.argtypes = [ctypes.c_void_p]
    return rsvg, cairo, gobject


def svg_available() -> bool:
    return _libs() is not None


def _intrinsic_size(rsvg, handle) -> tuple[float, float]:
    if hasattr(rsvg, "rsvg_handle_get_intrinsic_size_in_pixels"):
        w = ctypes.c_double()
        h = ctypes.c_double()
        if rsvg.rsvg_handle_get_intrinsic_size_in_pixels(
            handle, ctypes.byref(w), ctypes.byref(h)
        ) and w.value > 0 and h.value > 0:
            return w.value, h.value
    dims = _RsvgDimensionData()
    rsvg.rsvg_handle_get_dimensions(handle, ctypes.byref(dims))
    if dims.width > 0 and dims.height > 0:
        return float(dims.width), float(dims.height)
    return float(MAX_RENDER_DIM), float(MAX_RENDER_DIM)


def render_svg(path_or_bytes: str | bytes,
               max_dim: int = MAX_RENDER_DIM) -> np.ndarray:
    """Render an SVG document → RGBA uint8 [H, W, 4], longest side
    scaled to `max_dim` (aspect preserved)."""
    libs = _libs()
    if libs is None:
        raise RuntimeError("librsvg/cairo not available")
    rsvg, cairo, gobject = libs
    if isinstance(path_or_bytes, bytes):
        data = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    handle = rsvg.rsvg_handle_new_from_data(data, len(data), None)
    if not handle:
        raise ValueError("invalid SVG document")
    surface = cr = None
    try:
        iw, ih = _intrinsic_size(rsvg, handle)
        scale = max_dim / max(iw, ih)
        w = max(1, int(round(iw * scale)))
        h = max(1, int(round(ih * scale)))
        surface = cairo.cairo_image_surface_create(_CAIRO_FORMAT_ARGB32, w, h)
        cr = cairo.cairo_create(surface)
        if cairo.cairo_status(cr) != 0:
            raise RuntimeError("cairo context creation failed")
        viewport = _RsvgRectangle(0.0, 0.0, float(w), float(h))
        ok = rsvg.rsvg_handle_render_document(
            handle, cr, ctypes.byref(viewport), None
        )
        if not ok:
            raise ValueError("SVG render failed")
        cairo.cairo_surface_flush(surface)
        stride = cairo.cairo_image_surface_get_stride(surface)
        buf = cairo.cairo_image_surface_get_data(surface)
        raw = np.ctypeslib.as_array(buf, shape=(h, stride))
        px = raw[:, : w * 4].reshape(h, w, 4).copy()
    finally:
        if cr:
            cairo.cairo_destroy(cr)
        if surface:
            cairo.cairo_surface_destroy(surface)
        gobject.g_object_unref(handle)
    # cairo ARGB32 is premultiplied, native-endian (BGRA on LE)
    b, g, r, a = px[..., 0], px[..., 1], px[..., 2], px[..., 3]
    rgba = np.stack([r, g, b, a], axis=-1).astype(np.uint16)
    alpha = np.maximum(rgba[..., 3:4], 1)
    rgba[..., :3] = np.minimum(255, rgba[..., :3] * 255 // alpha)
    out = rgba.astype(np.uint8)
    out[..., 3] = px[..., 3]
    return out
