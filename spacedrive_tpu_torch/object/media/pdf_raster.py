"""PDF page rasterizer — a minimal content-stream interpreter on cairo.

The role PDFium plays in the reference (ref:crates/images/src/pdf.rs:
82-83 renders page 1 into a bitmap). This module interprets the page's
content stream directly: path construction + fill/stroke/clip, colors
(gray/RGB/CMYK + numeric sc/scn), affine transforms (q/Q/cm), text via
cairo's toy font API with the PDF text matrix, image/form XObjects
placed through the CTM (the unit-square mapping), drawn onto a cairo
ARGB32 surface through ctypes (the binding style of svg.py).

Text renders with the EMBEDDED font program when the PDF carries one
(FontFile/FontFile2/FontFile3 via freetype + cairo_show_glyphs —
pdf_fonts.py; the common case for real documents, which subset-embed
their faces), falling back to cairo toy faces otherwise.

Deliberate scope (thumbnails, not print fidelity): no shading/pattern
color spaces (skipped), no blend modes or soft masks. Unsupported
constructs degrade to "skip that operator", never to an exception —
the caller falls back to the image/text strategies.

The port's owned copy of `spacedrive_tpu/object/media/pdf_raster.py`: the same
code, so a document decodes to the same pixels in both packages.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import math
from typing import Any

import numpy as np

logger = logging.getLogger(__name__)

_FORMAT_ARGB32 = 0
_FONT_SLANT_NORMAL, _FONT_SLANT_ITALIC = 0, 1
_FONT_WEIGHT_NORMAL, _FONT_WEIGHT_BOLD = 0, 1
_FILL_RULE_WINDING, _FILL_RULE_EVEN_ODD = 0, 1

_MAX_OPS = 200_000          # content-stream operator budget
_MAX_FORM_DEPTH = 6         # nested Form XObject recursion cap


class _CairoMatrix(ctypes.Structure):
    _fields_ = [(n, ctypes.c_double) for n in ("xx", "yx", "xy", "yy", "x0", "y0")]


class _TextExtents(ctypes.Structure):
    _fields_ = [(n, ctypes.c_double) for n in
                ("x_bearing", "y_bearing", "width", "height",
                 "x_advance", "y_advance")]


_cairo_lib: list[Any] = []  # memoized [handle] or [None]


def _cairo():
    if _cairo_lib:
        return _cairo_lib[0]
    try:
        c = ctypes.CDLL(ctypes.util.find_library("cairo") or "libcairo.so.2")
        V, D, I = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
        c.cairo_image_surface_create.restype = V
        c.cairo_image_surface_create.argtypes = [I, I, I]
        c.cairo_image_surface_create_for_data.restype = V
        c.cairo_image_surface_create_for_data.argtypes = [
            ctypes.c_char_p, I, I, I, I]
        c.cairo_create.restype = V
        c.cairo_create.argtypes = [V]
        c.cairo_status.restype = I
        c.cairo_status.argtypes = [V]
        c.cairo_image_surface_get_data.restype = ctypes.POINTER(ctypes.c_ubyte)
        c.cairo_image_surface_get_data.argtypes = [V]
        c.cairo_image_surface_get_stride.restype = I
        c.cairo_image_surface_get_stride.argtypes = [V]
        for fn, args in {
            "cairo_destroy": [V], "cairo_surface_destroy": [V],
            "cairo_surface_flush": [V],
            "cairo_save": [V], "cairo_restore": [V],
            "cairo_new_path": [V], "cairo_close_path": [V],
            "cairo_move_to": [V, D, D], "cairo_line_to": [V, D, D],
            "cairo_curve_to": [V, D, D, D, D, D, D],
            "cairo_set_source_rgb": [V, D, D, D],
            "cairo_set_line_width": [V, D],
            "cairo_fill": [V], "cairo_fill_preserve": [V],
            "cairo_stroke": [V], "cairo_stroke_preserve": [V],
            "cairo_clip": [V], "cairo_paint": [V],
            "cairo_set_fill_rule": [V, I],
            "cairo_set_matrix": [V, ctypes.POINTER(_CairoMatrix)],
            "cairo_identity_matrix": [V],
            "cairo_set_source_surface": [V, V, D, D],
            "cairo_select_font_face": [V, ctypes.c_char_p, I, I],
            "cairo_set_font_size": [V, D],
            "cairo_show_text": [V, ctypes.c_char_p],
            "cairo_text_extents": [V, ctypes.c_char_p,
                                   ctypes.POINTER(_TextExtents)],
        }.items():
            getattr(c, fn).argtypes = args
            getattr(c, fn).restype = None
        _cairo_lib.append(c)
    except OSError as exc:
        logger.info("cairo unavailable for PDF raster: %s", exc)
        _cairo_lib.append(None)
    return _cairo_lib[0]


def raster_available() -> bool:
    return _cairo() is not None


# --- affine helpers (PDF matrices are [a b c d e f]) -----------------------


def _mat_mul(m, n):
    a, b, c, d, e, f = m
    a2, b2, c2, d2, e2, f2 = n
    return (
        a * a2 + b * c2, a * b2 + b * d2,
        c * a2 + d * c2, c * b2 + d * d2,
        e * a2 + f * c2 + e2, e * b2 + f * d2 + f2,
    )


def _mat_apply(m, x, y):
    a, b, c, d, e, f = m
    return a * x + c * y + e, b * x + d * y + f


def _mat_scale(m) -> float:
    """Geometric-mean scale factor (for line widths / font sizes)."""
    a, b, c, d, _e, _f = m
    det = abs(a * d - b * c)
    return math.sqrt(det) if det > 1e-12 else 1e-6


class _GState:
    __slots__ = ("ctm", "fill", "stroke", "line_width")

    def __init__(self, ctm, fill=(0.0, 0.0, 0.0), stroke=(0.0, 0.0, 0.0),
                 line_width=1.0):
        self.ctm = ctm
        self.fill = fill
        self.stroke = stroke
        self.line_width = line_width

    def copy(self):
        return _GState(self.ctm, self.fill, self.stroke, self.line_width)


def _to_rgb(ops: list, n: int) -> tuple[float, float, float] | None:
    """Color from the last n numeric operands (1=gray, 3=rgb, 4=cmyk)."""
    if len(ops) < n:
        return None
    try:
        vals = [max(0.0, min(1.0, float(v))) for v in ops[-n:]]
    except (TypeError, ValueError):
        return None
    if n == 1:
        return (vals[0],) * 3
    if n == 3:
        return tuple(vals)  # type: ignore[return-value]
    cy, m, y, k = vals
    return ((1 - cy) * (1 - k), (1 - m) * (1 - k), (1 - y) * (1 - k))


class _Raster:
    """One rasterization run over a page's content streams."""

    def __init__(self, doc, cr, base_ctm):
        self.doc = doc
        self.c = _cairo()
        self.cr = cr
        self.base = base_ctm
        self.gs = _GState(base_ctm)
        self.stack: list[_GState] = []
        self.floors = [0]  # per-form gstate-stack floor: inner Q can't
        # pop the caller's states (or underflow cairo's save stack)
        self.ops = 0
        self.painted = 0  # fills/strokes/images actually drawn
        self.pending_clip: int | None = None
        self._keepalive: list[Any] = []  # image buffers cairo reads from
        # text state
        self.tm = None
        self.tlm = None
        self.leading = 0.0
        self.font_size = 12.0
        self.font_face = (b"sans-serif", _FONT_SLANT_NORMAL, _FONT_WEIGHT_NORMAL)
        self.embedded = None        # EmbeddedFont for the current Tf
        self.embedded_glyphs = 0    # glyphs drawn from embedded programs
        self._font_cache: dict[str, Any] = {}  # Tf alias → EmbeddedFont|None

    # --- path + paint ---------------------------------------------------

    def _xy(self, x, y):
        return _mat_apply(self.gs.ctm, float(x), float(y))

    def _paint(self, fill: bool, stroke: bool, evenodd: bool = False) -> None:
        # cairo's clip consumes the path, so with a pending W/W* the
        # paint ops run preserve variants and the clip lands last
        c, cr = self.c, self.cr
        c.cairo_set_fill_rule(
            cr, _FILL_RULE_EVEN_ODD if evenodd else _FILL_RULE_WINDING
        )
        if fill:
            c.cairo_set_source_rgb(cr, *self.gs.fill)
            (c.cairo_fill_preserve if (stroke or self.pending_clip is not None)
             else c.cairo_fill)(cr)
            self.painted += 1
        if stroke:
            c.cairo_set_source_rgb(cr, *self.gs.stroke)
            c.cairo_set_line_width(
                cr, max(0.1, self.gs.line_width * _mat_scale(self.gs.ctm))
            )
            (c.cairo_stroke_preserve if self.pending_clip is not None
             else c.cairo_stroke)(cr)
            self.painted += 1
        if self.pending_clip is not None:
            c.cairo_set_fill_rule(cr, self.pending_clip)
            c.cairo_clip(cr)
            self.pending_clip = None
        c.cairo_new_path(cr)

    # --- text -----------------------------------------------------------

    def _show_text(self, raw: bytes) -> None:
        if self.tm is None:
            return
        if self.embedded is not None and self._show_embedded(raw):
            return
        self._show_toy(raw)

    def _show_embedded(self, raw: bytes) -> bool:
        """Draw a show op with the embedded font program's real glyphs;
        returns False (→ toy fallback) when nothing maps."""
        from .pdf_fonts import CairoGlyph

        font = self.embedded
        codes = font.codes(raw)
        pairs = [(code, font.gid(code)) for code in codes]
        if not any(gid for _c, gid in pairs):
            return False  # font maps nothing here → toy fallback
        c, cr = self.c, self.cr
        m = _mat_mul(self.tm, self.gs.ctm)
        x, y = _mat_apply(m, 0, 0)
        scale = _mat_scale(m)
        size = self.font_size * scale
        if size < 1.0 or size > 2000:
            return True  # suppressed, like the toy path's size guard
        c.cairo_set_font_face(cr, font.cairo_face)
        c.cairo_set_font_size(cr, size)
        c.cairo_set_source_rgb(cr, *self.gs.fill)
        glyphs = (CairoGlyph * len(pairs))()
        n = 0
        adv_text = 0.0  # text-space units for the tm update
        for code, gid in pairs:
            # gid 0 (e.g. subset fonts whose space has no outline)
            # draws nothing but MUST still advance, or words collapse
            probe = CairoGlyph(gid, x, y)
            if gid:
                glyphs[n] = probe
                n += 1
            w = font.width(code)
            if w:
                step = w / 1000.0 * self.font_size  # text space
            elif gid:
                ext = _TextExtents()
                c.cairo_glyph_extents(cr, ctypes.byref(probe), 1,
                                      ctypes.byref(ext))
                step = ext.x_advance / max(scale, 1e-6)
            else:
                step = font.default_width / 1000.0 * self.font_size
            adv_text += step
            x += step * scale  # device-space horizontal advance
        c.cairo_show_glyphs(cr, glyphs, n)
        c.cairo_new_path(cr)
        self.painted += 1
        self.embedded_glyphs += n
        self.tm = _mat_mul((1, 0, 0, 1, adv_text, 0), self.tm)
        return True

    def _show_toy(self, raw: bytes) -> None:
        from .pdf import _printable

        txt = _printable(raw).strip("\x00")
        if not txt:
            return
        c, cr = self.c, self.cr
        m = _mat_mul(self.tm, self.gs.ctm)
        x, y = _mat_apply(m, 0, 0)
        size = self.font_size * _mat_scale(m)
        if size < 1.0 or size > 2000:
            return
        c.cairo_select_font_face(cr, *self.font_face)
        c.cairo_set_font_size(cr, size)
        c.cairo_set_source_rgb(cr, *self.gs.fill)
        data = txt.encode("utf-8")
        c.cairo_move_to(cr, x, y)
        c.cairo_show_text(cr, data)
        c.cairo_new_path(cr)
        self.painted += 1
        ext = _TextExtents()
        c.cairo_text_extents(cr, data, ctypes.byref(ext))
        # advance the text matrix by the device advance mapped back to
        # text space (approximate: divide by the matrix scale)
        adv = ext.x_advance / max(_mat_scale(m), 1e-6)
        self.tm = _mat_mul((1, 0, 0, 1, adv, 0), self.tm)

    def _set_font(self, name: Any, size: Any, resources: dict) -> None:
        try:
            self.font_size = float(size)
        except (TypeError, ValueError):
            return
        # Tf's operand is the resource alias (/F1); the styling lives in
        # the font dict's BaseFont (e.g. Times-BoldItalic)
        base = str(name or "")
        self.embedded = None
        try:
            fonts = self.doc.resolve(resources.get("Font")) or {}
            ref = fonts.get(str(name))  # the UNresolved ref names the
            # object — distinct font dicts sharing a BaseFont (e.g. a
            # form XObject's own /F1) must not collide in the cache
            fdict = self.doc.resolve(ref)
            if isinstance(fdict, dict):
                base = str(self.doc.resolve(fdict.get("BaseFont", base)))
                from .pdf_fonts import load_embedded_font

                key = (f"inline-{id(fdict)}" if isinstance(ref, dict)
                       else repr(ref))
                if key not in self._font_cache:
                    self._font_cache[key] = load_embedded_font(self.doc, fdict)
                self.embedded = self._font_cache[key]
        except Exception:
            pass
        base = base.lower()
        slant = _FONT_SLANT_ITALIC if ("italic" in base or "oblique" in base) \
            else _FONT_SLANT_NORMAL
        weight = _FONT_WEIGHT_BOLD if "bold" in base else _FONT_WEIGHT_NORMAL
        family = b"sans-serif"
        if "times" in base or "serif" in base:
            family = b"serif"
        elif "courier" in base or "mono" in base:
            family = b"monospace"
        self.font_face = (family, slant, weight)

    # --- xobjects -------------------------------------------------------

    def _draw_image(self, arr: np.ndarray) -> None:
        """Place an RGB image through the CTM (PDF maps the image to the
        unit square; rows run top-down)."""
        c, cr = self.c, self.cr
        h, w = arr.shape[:2]
        if h < 1 or w < 1:
            return
        # RGB → premultiplied native-endian ARGB32 (BGRA bytes on LE)
        bgra = np.empty((h, w, 4), np.uint8)
        bgra[..., 0] = arr[..., 2]
        bgra[..., 1] = arr[..., 1]
        bgra[..., 2] = arr[..., 0]
        bgra[..., 3] = 255
        stride = w * 4
        buf = np.ascontiguousarray(bgra).tobytes()
        self._keepalive.append(buf)
        surf = c.cairo_image_surface_create_for_data(
            buf, _FORMAT_ARGB32, w, h, stride
        )
        try:
            # device matrix: unit square → CTM; image pixels → unit
            # square is scale(1/w, -1/h) + translate(0, 1)
            m = _mat_mul((1.0 / w, 0, 0, -1.0 / h, 0, 1), self.gs.ctm)
            cm = _CairoMatrix(m[0], m[1], m[2], m[3], m[4], m[5])
            c.cairo_save(cr)
            c.cairo_set_matrix(cr, ctypes.byref(cm))
            c.cairo_set_source_surface(cr, surf, 0, 0)
            c.cairo_paint(cr)
            c.cairo_restore(cr)
            self.painted += 1
        finally:
            c.cairo_surface_destroy(surf)

    def _do_xobject(self, name: Any, resources: dict, depth: int) -> None:
        from .pdf import Stream, _decode_image_xobject

        xobjects = self.doc.resolve(resources.get("XObject")) or {}
        obj = self.doc.resolve(xobjects.get(str(name)))
        if not isinstance(obj, Stream):
            return
        subtype = str(self.doc.resolve(obj.dict.get("Subtype", "")))
        if subtype == "Image":
            arr = _decode_image_xobject(self.doc, obj)
            if arr is not None:
                self._draw_image(arr)
        elif subtype == "Form" and depth < _MAX_FORM_DEPTH:
            from .pdf import _apply_filters

            try:
                content = _apply_filters(self.doc, obj.dict, obj.raw)
            except Exception:
                return
            sub_res = self.doc.resolve(obj.dict.get("Resources")) or resources
            self.stack.append(self.gs.copy())
            self.c.cairo_save(self.cr)
            floor = len(self.stack)
            self.floors.append(floor)
            mtx = self.doc.resolve(obj.dict.get("Matrix"))
            if isinstance(mtx, list) and len(mtx) == 6:
                try:
                    self.gs.ctm = _mat_mul(
                        tuple(float(v) for v in mtx), self.gs.ctm
                    )
                except (TypeError, ValueError):
                    pass
            try:
                self.run(content, sub_res, depth + 1)
            finally:
                # rebalance any unclosed q's the form content left open
                while len(self.stack) > floor:
                    self.gs = self.stack.pop()
                    self.c.cairo_restore(self.cr)
                self.floors.pop()
                self.c.cairo_restore(self.cr)
                self.gs = self.stack.pop()

    # --- the interpreter ------------------------------------------------

    def run(self, content: bytes, resources: dict, depth: int = 0) -> None:
        from .pdf import PdfError, _Lexer

        c, cr = self.c, self.cr
        lex = _Lexer(content, 0)
        operands: list[Any] = []
        cur = (0.0, 0.0)  # current point in user space (pre-CTM)
        start = cur
        while lex.pos < len(content) and self.ops < _MAX_OPS:
            lex.skip_ws()
            ch = lex.peek()
            if ch == -1:
                break
            try:
                # ASCII digits ONLY: chr(0xB2).isdigit() is True ('²'),
                # and binary residue must not abort the whole render
                if ch in (0x2F, 0x28, 0x3C, 0x5B) or 0x30 <= ch <= 0x39 \
                        or ch in (0x2B, 0x2D, 0x2E):
                    operands.append(lex.parse())
                    self.ops += 1  # operands burn budget too, or a
                    # stream of bare numbers spins outside the cap
                    if len(operands) > 32:
                        del operands[:-32]
                    continue
                op = lex.token()
            except PdfError:
                lex.pos += 1  # skip the bad byte, keep rendering
                operands = []
                self.ops += 1  # binary junk still burns the op budget
                continue
            if not op:
                lex.pos += 1
                continue
            self.ops += 1
            try:
                cur, start = self._exec(
                    op, operands, resources, depth, cur, start
                )
            except Exception:  # noqa: BLE001 - skip busted operators
                pass
            if op == b"ID":  # inline image data: skip to EI
                end = content.find(b"EI", lex.pos)
                lex.pos = len(content) if end < 0 else end + 2
            operands = []

    def _exec(self, op, st, resources, depth, cur, start):
        c, cr = self.c, self.cr
        gs = self.gs
        num = _num
        if op == b"q":
            self.stack.append(gs.copy())
            c.cairo_save(cr)
        elif op == b"Q":
            # never pop past the current form's floor — an excess Q in
            # form content must not consume the caller's states
            if len(self.stack) > self.floors[-1]:
                self.gs = self.stack.pop()
                c.cairo_restore(cr)
        elif op == b"cm" and len(st) >= 6:
            try:
                m = tuple(float(v) for v in st[-6:])
                gs.ctm = _mat_mul(m, gs.ctm)
            except (TypeError, ValueError):
                pass
        elif op == b"w" and st:
            gs.line_width = max(0.0, num(st[-1], 1.0))
        # --- colors
        elif op == b"g":
            gs.fill = _to_rgb(st, 1) or gs.fill
        elif op == b"G":
            gs.stroke = _to_rgb(st, 1) or gs.stroke
        elif op == b"rg":
            gs.fill = _to_rgb(st, 3) or gs.fill
        elif op == b"RG":
            gs.stroke = _to_rgb(st, 3) or gs.stroke
        elif op == b"k":
            gs.fill = _to_rgb(st, 4) or gs.fill
        elif op == b"K":
            gs.stroke = _to_rgb(st, 4) or gs.stroke
        elif op in (b"sc", b"scn", b"SC", b"SCN"):
            nums = [v for v in st if isinstance(v, (int, float))]
            col = _to_rgb(nums, len(nums)) if len(nums) in (1, 3, 4) else None
            if col:
                if op.isupper():
                    gs.stroke = col
                else:
                    gs.fill = col
        # --- path construction
        elif op == b"m" and len(st) >= 2:
            cur = (num(st[-2]), num(st[-1]))
            start = cur
            c.cairo_move_to(cr, *self._xy(*cur))
        elif op == b"l" and len(st) >= 2:
            cur = (num(st[-2]), num(st[-1]))
            c.cairo_line_to(cr, *self._xy(*cur))
        elif op == b"c" and len(st) >= 6:
            p1 = (num(st[-6]), num(st[-5]))
            p2 = (num(st[-4]), num(st[-3]))
            cur = (num(st[-2]), num(st[-1]))
            c.cairo_curve_to(cr, *self._xy(*p1), *self._xy(*p2), *self._xy(*cur))
        elif op == b"v" and len(st) >= 4:
            p2 = (num(st[-4]), num(st[-3]))
            end = (num(st[-2]), num(st[-1]))
            c.cairo_curve_to(cr, *self._xy(*cur), *self._xy(*p2), *self._xy(*end))
            cur = end
        elif op == b"y" and len(st) >= 4:
            p1 = (num(st[-4]), num(st[-3]))
            end = (num(st[-2]), num(st[-1]))
            c.cairo_curve_to(cr, *self._xy(*p1), *self._xy(*end), *self._xy(*end))
            cur = end
        elif op == b"h":
            c.cairo_close_path(cr)
            cur = start
        elif op == b"re" and len(st) >= 4:
            x, y, w_, h_ = (num(v) for v in st[-4:])
            c.cairo_move_to(cr, *self._xy(x, y))
            c.cairo_line_to(cr, *self._xy(x + w_, y))
            c.cairo_line_to(cr, *self._xy(x + w_, y + h_))
            c.cairo_line_to(cr, *self._xy(x, y + h_))
            c.cairo_close_path(cr)
            cur = start = (x, y)
        # --- painting
        elif op == b"f" or op == b"F":
            self._paint(fill=True, stroke=False)
        elif op == b"f*":
            self._paint(fill=True, stroke=False, evenodd=True)
        elif op == b"B":
            self._paint(fill=True, stroke=True)
        elif op == b"B*":
            self._paint(fill=True, stroke=True, evenodd=True)
        elif op in (b"b", b"b*"):
            c.cairo_close_path(cr)
            self._paint(fill=True, stroke=True, evenodd=op == b"b*")
        elif op == b"S":
            self._paint(fill=False, stroke=True)
        elif op == b"s":
            c.cairo_close_path(cr)
            self._paint(fill=False, stroke=True)
        elif op == b"n":
            self._paint(fill=False, stroke=False)
        elif op == b"W":
            self.pending_clip = _FILL_RULE_WINDING
        elif op == b"W*":
            self.pending_clip = _FILL_RULE_EVEN_ODD
        # --- text
        elif op == b"BT":
            self.tm = (1, 0, 0, 1, 0, 0)
            self.tlm = self.tm
        elif op == b"ET":
            self.tm = self.tlm = None
        elif op == b"Tf" and len(st) >= 2:
            self._set_font(st[-2], st[-1], resources)
        elif op == b"TL" and st:
            self.leading = num(st[-1])
        elif op == b"Td" and len(st) >= 2 and self.tlm is not None:
            self.tlm = _mat_mul((1, 0, 0, 1, num(st[-2]), num(st[-1])), self.tlm)
            self.tm = self.tlm
        elif op == b"TD" and len(st) >= 2 and self.tlm is not None:
            self.leading = -num(st[-1])
            self.tlm = _mat_mul((1, 0, 0, 1, num(st[-2]), num(st[-1])), self.tlm)
            self.tm = self.tlm
        elif op == b"Tm" and len(st) >= 6:
            try:
                self.tlm = tuple(float(v) for v in st[-6:])
                self.tm = self.tlm
            except (TypeError, ValueError):
                pass
        elif op == b"T*" and self.tlm is not None:
            self.tlm = _mat_mul((1, 0, 0, 1, 0, -self.leading), self.tlm)
            self.tm = self.tlm
        elif op == b"Tj" and st and isinstance(st[-1], bytes):
            self._show_text(st[-1])
        elif op in (b"'", b'"'):
            if self.tlm is not None:
                self.tlm = _mat_mul((1, 0, 0, 1, 0, -self.leading), self.tlm)
                self.tm = self.tlm
            raw = next((v for v in reversed(st) if isinstance(v, bytes)), None)
            if raw is not None:
                self._show_text(raw)
        elif op == b"TJ" and st and isinstance(st[-1], list):
            for item in st[-1]:
                if isinstance(item, bytes):
                    self._show_text(item)
        # --- xobjects
        elif op == b"Do" and st:
            self._do_xobject(st[-1], resources, depth)
        return cur, start


def _num(v, default: float = 0.0) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def rasterize_page(doc, page: dict, max_dim: int,
                   stats: dict | None = None) -> np.ndarray | None:
    """Render page 1's content stream; None when cairo is missing, the
    page has no content, or nothing got painted. `stats`, when given,
    receives interpreter counters (painted ops, embedded glyphs drawn)."""
    from .pdf import Stream, _apply_filters

    c = _cairo()
    if c is None:
        return None
    contents = doc.resolve(page.get("Contents"))
    if isinstance(contents, Stream):
        contents = [contents]
    elif isinstance(contents, list):
        contents = [doc.resolve(x) for x in contents]
    else:
        return None
    try:
        data = b"\n".join(
            _apply_filters(doc, s.dict, s.raw)
            for s in contents if isinstance(s, Stream)
        )
    except Exception:
        return None
    if not data.strip():
        return None

    box = doc.resolve(page.get("MediaBox")) or [0, 0, 612, 792]
    try:
        x0, y0, x1, y1 = (float(v) for v in box)
    except (TypeError, ValueError):
        x0, y0, x1, y1 = 0.0, 0.0, 612.0, 792.0
    bw, bh = abs(x1 - x0) or 612.0, abs(y1 - y0) or 792.0
    scale = max_dim / max(bw, bh)
    w = max(8, int(round(bw * scale)))
    h = max(8, int(round(bh * scale)))

    surface = c.cairo_image_surface_create(_FORMAT_ARGB32, w, h)
    cr = c.cairo_create(surface)
    if c.cairo_status(cr) != 0:
        c.cairo_destroy(cr)
        c.cairo_surface_destroy(surface)
        return None
    r = None
    try:
        # white page background
        c.cairo_set_source_rgb(cr, 1.0, 1.0, 1.0)
        c.cairo_paint(cr)
        # PDF user space (origin bottom-left) → device pixels
        base = (scale, 0.0, 0.0, -scale, -x0 * scale, y1 * scale)
        r = _Raster(doc, cr, base)
        res = doc.resolve(page.get("Resources")) or {}
        r.run(data, res)
        if stats is not None:
            stats["painted"] = r.painted
            stats["embedded_glyphs"] = r.embedded_glyphs
        if r.painted == 0:
            return None
        c.cairo_surface_flush(surface)
        stride = c.cairo_image_surface_get_stride(surface)
        buf = c.cairo_image_surface_get_data(surface)
        raw = np.ctypeslib.as_array(buf, shape=(h, stride))
        px = raw[:, : w * 4].reshape(h, w, 4).copy()
    finally:
        c.cairo_destroy(cr)
        c.cairo_surface_destroy(surface)
        # native font faces AFTER the context that references them
        if r is not None:
            for font in r._font_cache.values():
                if font is not None:
                    font.release()
    # premultiplied native-endian ARGB → RGB over white
    b, g, rr, a = (px[..., i].astype(np.uint16) for i in range(4))
    inv = (255 - a)
    out = np.stack([
        np.minimum(255, rr + inv), np.minimum(255, g + inv),
        np.minimum(255, b + inv),
    ], axis=-1).astype(np.uint8)
    return out
