"""Embedded PDF font programs → cairo glyphs, via freetype (ctypes).

The reference gets embedded-font text for free from PDFium
(ref:crates/images/src/pdf.rs:82-83); our from-scratch rasterizer
previously substituted cairo toy faces, which mangles any PDF whose
fonts are subset-embedded (most real documents). This module loads the
embedded program (FontFile = Type1, FontFile2 = TrueType, FontFile3 =
CFF/Type1C — freetype parses all three) straight from memory and
renders through `cairo_show_glyphs` with REAL glyph indices, so
subset custom encodings draw the right outlines.

Char-code → glyph-index resolution, in order:
- simple fonts: code → unicode via the base encoding (latin-1 is the
  shared ASCII core of Standard/WinAnsi) patched by /Differences
  (glyph names resolved through a full-ASCII name table), then the
  face cmap; symbol-font fallback probes 0xF000+code (the MS symbol
  convention freetype exposes);
- Type0/CIDFontType2 (Identity-H): 2-byte codes are CIDs mapped
  through /CIDToGIDMap (Identity or the stream form).

Advances prefer the PDF's own /Widths//W arrays (authoritative for
subsets) and fall back to cairo's glyph extents. Every failure path
degrades to the toy-font rendering, never to an exception.

The port's owned copy of `spacedrive_tpu/object/media/pdf_fonts.py`: the same
code, so a document decodes to the same pixels in both packages.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import itertools
import logging
from typing import Any

logger = logging.getLogger(__name__)

FT_LOAD_DEFAULT = 0


class CairoGlyph(ctypes.Structure):
    _fields_ = [("index", ctypes.c_ulong),
                ("x", ctypes.c_double), ("y", ctypes.c_double)]


_ft_lib: list[Any] = []  # [handle, FT_Library] or [None]


def _ft():
    if _ft_lib:
        return _ft_lib[0]
    try:
        ft = ctypes.CDLL(ctypes.util.find_library("freetype")
                         or "libfreetype.so.6")
        ft.FT_Init_FreeType.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        ft.FT_Init_FreeType.restype = ctypes.c_int
        ft.FT_New_Memory_Face.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_void_p)]
        ft.FT_New_Memory_Face.restype = ctypes.c_int
        ft.FT_Get_Char_Index.argtypes = [ctypes.c_void_p, ctypes.c_ulong]
        ft.FT_Get_Char_Index.restype = ctypes.c_uint
        ft.FT_Done_Face.argtypes = [ctypes.c_void_p]
        ft.FT_Done_Face.restype = ctypes.c_int
        lib = ctypes.c_void_p()
        if ft.FT_Init_FreeType(ctypes.byref(lib)) != 0:
            raise OSError("FT_Init_FreeType failed")
        _ft_lib.extend([ft, lib])
    except OSError as exc:
        logger.info("freetype unavailable for embedded PDF fonts: %s", exc)
        _ft_lib.append(None)
    return _ft_lib[0]


_cairo_ft_bound: list[bool] = []


def _cairo_ft():
    """The cairo handle with the FT + glyph entry points bound (they
    live in libcairo itself; bound lazily once)."""
    from .pdf_raster import _TextExtents, _cairo

    c = _cairo()
    if c is None:
        return None
    if not _cairo_ft_bound:
        V, I = ctypes.c_void_p, ctypes.c_int
        c.cairo_ft_font_face_create_for_ft_face.restype = V
        c.cairo_ft_font_face_create_for_ft_face.argtypes = [V, I]
        c.cairo_font_face_destroy.restype = None
        c.cairo_font_face_destroy.argtypes = [V]
        c.cairo_set_font_face.restype = None
        c.cairo_set_font_face.argtypes = [V, V]
        c.cairo_show_glyphs.restype = None
        c.cairo_show_glyphs.argtypes = [V, ctypes.POINTER(CairoGlyph), I]
        c.cairo_glyph_extents.restype = None
        c.cairo_glyph_extents.argtypes = [
            V, ctypes.POINTER(CairoGlyph), I, ctypes.POINTER(_TextExtents)]
        c.cairo_font_face_set_user_data.restype = I
        c.cairo_font_face_set_user_data.argtypes = [V, V, V, V]
        _cairo_ft_bound.append(True)
    return c


# --- FT face lifetime --------------------------------------------------------
#
# cairo's scaled-font holdover cache may keep the font face (and through it
# the FT_Face) alive past cairo_font_face_destroy; cairo's contract for
# cairo_ft_font_face_create_for_ft_face requires the FT_Face to outlive every
# cairo reference. So the FT_Face (and the memory buffer it parses lazily) is
# freed from a cairo user-data destroy hook — invoked only when the LAST
# cairo reference drops — never directly.

class _CairoUserDataKey(ctypes.Structure):
    _fields_ = [("unused", ctypes.c_int)]


_FT_KEY = _CairoUserDataKey()
_DESTROY_T = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
_live_ft_faces: dict[int, tuple] = {}  # token -> (buf, FT_Face)
# PDF decodes run concurrently on worker threads: next() on a count is
# GIL-atomic, so parallel loads can never share a token (a shared token
# would let one face's destroy hook free the OTHER face)
_token_counter = itertools.count(1)


@_DESTROY_T
def _ft_face_destroy_hook(data):
    buf, face = _live_ft_faces.pop(int(data or 0), (None, None))
    ft = _ft_lib[0] if _ft_lib else None
    if ft is not None and face:
        ft.FT_Done_Face(face)


def _bind_ft_lifetime(c, cairo_face, face, buf) -> None:
    """Tie (buf, face) to the cairo face's last-reference drop. On the
    (OOM-only) registration failure the pair stays in the registry
    forever — a bounded leak, never a dangling FT_Face."""
    token = next(_token_counter)
    _live_ft_faces[token] = (buf, face)
    status = c.cairo_font_face_set_user_data(
        cairo_face, ctypes.byref(_FT_KEY), ctypes.c_void_p(token),
        _ft_face_destroy_hook)
    if status != 0:  # CAIRO_STATUS_NO_MEMORY: hook not registered
        logger.warning("cairo_font_face_set_user_data failed (%d); "
                       "leaking FT face rather than risking a UAF", status)


# --- glyph names (full ASCII coverage; AGL's latin core) -------------------

_NAME_TO_UNICODE = {
    "space": 0x20, "exclam": 0x21, "quotedbl": 0x22, "numbersign": 0x23,
    "dollar": 0x24, "percent": 0x25, "ampersand": 0x26, "quotesingle": 0x27,
    "parenleft": 0x28, "parenright": 0x29, "asterisk": 0x2A, "plus": 0x2B,
    "comma": 0x2C, "hyphen": 0x2D, "period": 0x2E, "slash": 0x2F,
    "zero": 0x30, "one": 0x31, "two": 0x32, "three": 0x33, "four": 0x34,
    "five": 0x35, "six": 0x36, "seven": 0x37, "eight": 0x38, "nine": 0x39,
    "colon": 0x3A, "semicolon": 0x3B, "less": 0x3C, "equal": 0x3D,
    "greater": 0x3E, "question": 0x3F, "at": 0x40,
    "bracketleft": 0x5B, "backslash": 0x5C, "bracketright": 0x5D,
    "asciicircum": 0x5E, "underscore": 0x5F, "grave": 0x60,
    "braceleft": 0x7B, "bar": 0x7C, "braceright": 0x7D, "asciitilde": 0x7E,
}


def _glyph_name_to_unicode(name: str) -> int | None:
    if len(name) == 1:
        return ord(name)
    if name in _NAME_TO_UNICODE:
        return _NAME_TO_UNICODE[name]
    if name.startswith("uni") and len(name) == 7:
        try:
            return int(name[3:], 16)
        except ValueError:
            return None
    return None


class EmbeddedFont:
    """A loaded embedded font: freetype face + cairo font face + the
    char-code mapping and width table needed to lay out a show op."""

    def __init__(self, cairo_face: Any, code_to_gid, two_byte: bool,
                 widths: dict[int, float], default_width: float):
        self.cairo_face = cairo_face
        self._code_to_gid = code_to_gid  # callable code → gid
        self.two_byte = two_byte
        self.widths = widths             # code → advance /1000 units
        self.default_width = default_width
        self._released = False

    def release(self) -> None:
        """Drop OUR reference to the cairo face. The FT_Face and its
        backing buffer are freed by the user-data destroy hook when
        cairo drops its LAST reference — which may be later than this
        call if the scaled-font holdover cache still holds the face."""
        if self._released:
            return
        self._released = True
        c = _cairo_ft()
        if c is not None and self.cairo_face:
            c.cairo_font_face_destroy(self.cairo_face)
        self.cairo_face = None

    def codes(self, raw: bytes):
        if self.two_byte:
            return [(raw[i] << 8) | raw[i + 1]
                    for i in range(0, len(raw) - 1, 2)]
        return list(raw)

    def gid(self, code: int) -> int:
        return self._code_to_gid(code)

    def width(self, code: int) -> float:
        """Advance in text-space /1000 units, or the font default."""
        return self.widths.get(code, self.default_width)


def _load_face(data: bytes):
    ft = _ft()
    if ft is None:
        return None, None
    face = ctypes.c_void_p()
    buf = ctypes.create_string_buffer(data, len(data))
    if ft.FT_New_Memory_Face(_ft_lib[1], buf, len(data), 0,
                             ctypes.byref(face)) != 0:
        return None, None
    return face, buf


def _font_program(doc: Any, descriptor: dict) -> bytes | None:
    from .pdf import Stream, _apply_filters

    for key in ("FontFile2", "FontFile3", "FontFile"):
        obj = doc.resolve(descriptor.get(key))
        if isinstance(obj, Stream):
            try:
                data = _apply_filters(doc, obj.dict, obj.raw)
                if isinstance(data, bytes) and data:
                    return data
            except Exception:
                continue
    return None


def _simple_encoding_map(doc: Any, fdict: dict) -> dict[int, int]:
    """code → unicode for a simple font: latin-1 core patched by any
    /Encoding /Differences."""
    mapping = {code: code for code in range(32, 256)}
    enc = doc.resolve(fdict.get("Encoding"))
    if isinstance(enc, dict):
        diffs = doc.resolve(enc.get("Differences"))
        if isinstance(diffs, list):
            code = 0
            for item in diffs:
                item = doc.resolve(item)
                if isinstance(item, (int, float)):
                    code = int(item)
                else:
                    uni = _glyph_name_to_unicode(str(item))
                    if uni is not None:
                        mapping[code] = uni
                    code += 1
    return mapping


def _simple_widths(doc: Any, fdict: dict) -> tuple[dict[int, float], float]:
    widths: dict[int, float] = {}
    try:
        first = int(doc.resolve(fdict.get("FirstChar", 0)))
        arr = doc.resolve(fdict.get("Widths"))
        if isinstance(arr, list):
            for i, w in enumerate(arr):
                w = doc.resolve(w)
                if isinstance(w, (int, float)):
                    widths[first + i] = float(w)
    except Exception:
        pass
    return widths, 500.0


def _cid_widths(doc: Any, d0: dict) -> tuple[dict[int, float], float]:
    """CIDFont /W array: [c [w1 w2 …] | c1 c2 w]*; /DW default."""
    widths: dict[int, float] = {}
    default = 1000.0
    try:
        dw = doc.resolve(d0.get("DW"))
        if isinstance(dw, (int, float)):
            default = float(dw)
        arr = doc.resolve(d0.get("W"))
        if isinstance(arr, list):
            i = 0
            while i < len(arr):
                c1 = doc.resolve(arr[i])
                nxt = doc.resolve(arr[i + 1]) if i + 1 < len(arr) else None
                if isinstance(nxt, list):
                    for j, w in enumerate(nxt):
                        w = doc.resolve(w)
                        if isinstance(w, (int, float)):
                            widths[int(c1) + j] = float(w)
                    i += 2
                elif i + 2 < len(arr):
                    w = doc.resolve(arr[i + 2])
                    # 2-byte codes cap CIDs at 0xFFFF; clamp so a
                    # hostile /W [0 4294967295 w] can't spin/OOM
                    lo = max(0, int(c1))
                    hi = min(int(nxt), 0xFFFF)
                    for code in range(lo, hi + 1):
                        widths[code] = float(w)
                    i += 3
                else:
                    break
    except Exception:
        pass
    return widths, default


def load_embedded_font(doc: Any, fdict: dict) -> EmbeddedFont | None:
    """Build an EmbeddedFont from a resolved PDF font dict, or None
    when there is no usable embedded program (caller keeps toy faces)."""
    c = _cairo_ft()
    ft = _ft()
    if c is None or ft is None:
        return None
    try:
        subtype = str(doc.resolve(fdict.get("Subtype", "")))
        if subtype == "Type0":
            desc = doc.resolve(fdict.get("DescendantFonts"))
            if not isinstance(desc, list) or not desc:
                return None
            d0 = doc.resolve(desc[0])
            if not isinstance(d0, dict):
                return None
            descriptor = doc.resolve(d0.get("FontDescriptor"))
            if not isinstance(descriptor, dict):
                return None
            data = _font_program(doc, descriptor)
            if data is None:
                return None
            face, buf = _load_face(data)
            if face is None:
                return None
            cid2gid = doc.resolve(d0.get("CIDToGIDMap", "Identity"))
            gid_table: bytes | None = None
            from .pdf import Stream, _apply_filters

            if isinstance(cid2gid, Stream):
                try:
                    table = _apply_filters(doc, cid2gid.dict, cid2gid.raw)
                    gid_table = table if isinstance(table, bytes) else None
                except Exception:
                    gid_table = None

            def code_to_gid(code: int, _t=gid_table) -> int:
                if _t is not None:
                    off = code * 2
                    if off + 1 < len(_t):
                        return (_t[off] << 8) | _t[off + 1]
                    return 0
                return code  # Identity: CID == GID

            widths, default = _cid_widths(doc, d0)
            cairo_face = c.cairo_ft_font_face_create_for_ft_face(
                face, FT_LOAD_DEFAULT)
            _bind_ft_lifetime(c, cairo_face, face, buf)
            return EmbeddedFont(cairo_face, code_to_gid, True, widths,
                                default)

        descriptor = doc.resolve(fdict.get("FontDescriptor"))
        if not isinstance(descriptor, dict):
            return None
        data = _font_program(doc, descriptor)
        if data is None:
            return None
        face, buf = _load_face(data)
        if face is None:
            return None
        enc_map = _simple_encoding_map(doc, fdict)
        gid_cache: dict[int, int] = {}

        def code_to_gid(code: int) -> int:
            gid = gid_cache.get(code)
            if gid is None:
                uni = enc_map.get(code, code)
                gid = ft.FT_Get_Char_Index(face, uni)
                if gid == 0:
                    # MS symbol-font convention (freetype maps the
                    # (3,0) cmap into 0xF000..0xF0FF)
                    gid = ft.FT_Get_Char_Index(face, 0xF000 + code)
                gid_cache[code] = gid
            return gid

        widths, default = _simple_widths(doc, fdict)
        cairo_face = c.cairo_ft_font_face_create_for_ft_face(
            face, FT_LOAD_DEFAULT)
        _bind_ft_lifetime(c, cairo_face, face, buf)
        return EmbeddedFont(cairo_face, code_to_gid, False, widths,
                            default)
    except Exception as exc:  # noqa: BLE001 - hostile input; toy fallback
        logger.debug("embedded font load failed: %s", exc)
        return None
