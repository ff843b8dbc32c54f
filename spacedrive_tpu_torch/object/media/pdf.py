"""PDF first-page thumbnails — a bounded, dependency-free PDF reader.

Role parity with the reference's PDFium handler
(ref:crates/images/src/pdf.rs:82-83: render page 1 into a bitmap).
This host has no PDFium/poppler C API, so the frontend is a real (if
bounded) PDF reader implemented here:

strategy 1: the page's embedded `/Thumb` image (PDF's own thumbnail);
strategy 2: the largest image XObject on page 1 (covers scanned
            documents, slides, photo PDFs — the cases where a page
            render is dominated by one raster anyway);
strategy 3: typeset the page's extracted text onto a white canvas with
            the true MediaBox aspect (degraded but honest for
            text-only documents: real content, default font).

Supported plumbing: classic + stream xrefs (PNG predictors), object
streams, Flate/DCT/ASCIIHex/ASCII85/RunLength filters, page-tree
inheritance. Encrypted files raise `PdfUnsupported`.

The port's owned copy of `spacedrive_tpu/object/media/pdf.py`: the same
code, so a document decodes to the same pixels in both packages.
"""

from __future__ import annotations

import io
import logging
import re
import zlib
from dataclasses import dataclass
from typing import Any

import numpy as np

logger = logging.getLogger(__name__)

MAX_RENDER_DIM = 512  # match the SVG cap; thumbnails are ≤512² anyway
MAX_INFLATE = 64 * 1024 * 1024  # hard cap per decoded stream (deflate-bomb guard)


class PdfError(Exception):
    pass


class PdfUnsupported(PdfError):
    pass


class Name(str):
    """A PDF name object (distinct from string literals)."""


@dataclass(frozen=True)
class Ref:
    num: int
    gen: int


_WHITESPACE = b"\x00\t\n\x0c\r "
_DELIMS = b"()<>[]{}/%"


class _Lexer:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def skip_ws(self) -> None:
        d = self.data
        n = len(d)
        while self.pos < n:
            c = d[self.pos]
            if c in _WHITESPACE:
                self.pos += 1
            elif c == 0x25:  # % comment
                while self.pos < n and d[self.pos] not in b"\r\n":
                    self.pos += 1
            else:
                return

    def peek(self) -> int:
        return self.data[self.pos] if self.pos < len(self.data) else -1

    def token(self) -> bytes:
        """Read a bare token (keyword/number)."""
        self.skip_ws()
        start = self.pos
        d = self.data
        n = len(d)
        while self.pos < n and d[self.pos] not in _WHITESPACE and \
                d[self.pos] not in _DELIMS:
            self.pos += 1
        return d[start:self.pos]

    # --- object parsing ---------------------------------------------------

    def parse(self) -> Any:
        self.skip_ws()
        c = self.peek()
        if c == -1:
            raise PdfError("unexpected EOF")
        d = self.data
        if c == 0x2F:  # /Name
            self.pos += 1
            return Name(self._name_chars())
        if c == 0x28:  # (string)
            return self._literal_string()
        if c == 0x3C:  # < or <<
            if d[self.pos:self.pos + 2] == b"<<":
                return self._dict_or_stream()
            return self._hex_string()
        if c == 0x5B:  # [
            self.pos += 1
            arr = []
            while True:
                self.skip_ws()
                if self.peek() == 0x5D:
                    self.pos += 1
                    return arr
                arr.append(self.parse())
        if c == 0x5D:
            raise PdfError("unbalanced ]")
        tok = self.token()
        if tok in (b"true", b"false"):
            return tok == b"true"
        if tok == b"null":
            return None
        # number, possibly an "n g R" reference
        try:
            if b"." in tok:
                return float(tok)
            value = int(tok)
        except ValueError:
            raise PdfError(f"bad token {tok!r} at {self.pos}")
        save = self.pos
        self.skip_ws()
        tok2 = self.token()
        if tok2.isdigit():
            self.skip_ws()
            if self.token() == b"R":
                return Ref(value, int(tok2))
        self.pos = save
        return value

    def _name_chars(self) -> str:
        out = bytearray()
        d = self.data
        n = len(d)
        while self.pos < n:
            c = d[self.pos]
            if c in _WHITESPACE or c in _DELIMS:
                break
            if c == 0x23 and self.pos + 2 < n:  # #xx escape
                try:
                    out.append(int(d[self.pos + 1:self.pos + 3], 16))
                    self.pos += 3
                    continue
                except ValueError:
                    pass
            out.append(c)
            self.pos += 1
        return out.decode("latin-1")

    def _literal_string(self) -> bytes:
        d = self.data
        self.pos += 1  # (
        depth = 1
        out = bytearray()
        n = len(d)
        while self.pos < n:
            c = d[self.pos]
            self.pos += 1
            if c == 0x5C:  # backslash
                if self.pos >= n:
                    break
                e = d[self.pos]
                self.pos += 1
                mapping = {0x6E: 10, 0x72: 13, 0x74: 9, 0x62: 8, 0x66: 12,
                           0x28: 40, 0x29: 41, 0x5C: 92}
                if e in mapping:
                    out.append(mapping[e])
                elif 0x30 <= e <= 0x37:  # octal
                    oct_digits = chr(e)
                    for _ in range(2):
                        if self.pos < n and 0x30 <= d[self.pos] <= 0x37:
                            oct_digits += chr(d[self.pos])
                            self.pos += 1
                    out.append(int(oct_digits, 8) & 0xFF)
                elif e in b"\r\n":
                    if e == 0x0D and self.pos < n and d[self.pos] == 0x0A:
                        self.pos += 1
                else:
                    out.append(e)
            elif c == 0x28:
                depth += 1
                out.append(c)
            elif c == 0x29:
                depth -= 1
                if depth == 0:
                    return bytes(out)
                out.append(c)
            else:
                out.append(c)
        raise PdfError("unterminated string")

    def _hex_string(self) -> bytes:
        self.pos += 1  # <
        d = self.data
        end = d.index(b">", self.pos)
        hx = re.sub(rb"\s", b"", d[self.pos:end])
        self.pos = end + 1
        if len(hx) % 2:
            hx += b"0"
        return bytes.fromhex(hx.decode("ascii"))

    def _dict_or_stream(self) -> Any:
        d = self.data
        self.pos += 2  # <<
        obj: dict[str, Any] = {}
        while True:
            self.skip_ws()
            if d[self.pos:self.pos + 2] == b">>":
                self.pos += 2
                break
            key = self.parse()
            if not isinstance(key, Name):
                raise PdfError(f"dict key not a name: {key!r}")
            obj[str(key)] = self.parse()
        save = self.pos
        self.skip_ws()
        if d[self.pos:self.pos + 6] == b"stream":
            self.pos += 6
            if d[self.pos:self.pos + 2] == b"\r\n":
                self.pos += 2
            elif d[self.pos:self.pos + 1] in (b"\n", b"\r"):
                self.pos += 1
            return _RawStream(obj, self.pos)
        self.pos = save
        return obj


@dataclass
class _RawStream:
    """Stream dict + offset of its data (length resolved lazily)."""
    dict: dict[str, Any]
    data_offset: int


@dataclass
class Stream:
    dict: dict[str, Any]
    raw: bytes  # undecoded (filters still applied)


# --- filters ---------------------------------------------------------------


def _inflate_bounded(data: bytes, cap: int = MAX_INFLATE) -> bytes:
    """zlib inflate with a hard output bound (untrusted-input bomb guard).

    Raises zlib.error for truncated/corrupt streams exactly like
    zlib.decompress did, so callers' fallback paths still trigger."""
    d = zlib.decompressobj()
    out = d.decompress(data, cap)
    if d.unconsumed_tail or (not d.eof and d.decompress(b"", 1)):
        raise PdfUnsupported(f"inflated stream exceeds {cap} byte cap")
    if not d.eof:
        raise zlib.error("incomplete or truncated deflate stream")
    return out


def _png_predictor(data: bytes, colors: int, bpc: int, columns: int) -> bytes:
    bpp = max(1, (colors * bpc) // 8)
    row_len = (columns * colors * bpc + 7) // 8
    n_rows = len(data) // (1 + row_len)
    if n_rows == 0:
        return b""
    # Rows are [filter_type, row_len bytes]; reshape and split.
    arr = np.frombuffer(data[: n_rows * (1 + row_len)], dtype=np.uint8)
    arr = arr.reshape(n_rows, 1 + row_len)
    ftypes = arr[:, 0]
    rows = arr[:, 1:].copy()
    # Sub and Up rows are vectorized (per-lane cumsum within the row /
    # elementwise add of the previous row); Average and Paeth have a
    # sequential left-dependency and stay scalar, but only those rows
    # pay the Python loop.
    prev = np.zeros(row_len, dtype=np.uint8)
    for r in range(n_rows):
        ft = ftypes[r]
        row = rows[r]
        if ft == 0:
            pass
        elif ft == 1:  # Sub: per-lane cumsum along the row (mod 256)
            for lane in range(bpp):
                acc = np.cumsum(row[lane::bpp], dtype=np.uint64)
                row[lane::bpp] = (acc & 0xFF).astype(np.uint8)
        elif ft == 2:  # Up: elementwise add of previous row
            np.add(row, prev, out=row, casting="unsafe")
        elif ft == 3:  # Average (left term is sequential; scalar per row)
            rl = row.tolist()
            pv = prev.tolist()
            for i in range(row_len):
                left = rl[i - bpp] if i >= bpp else 0
                rl[i] = (rl[i] + (left + pv[i]) // 2) & 0xFF
            row[:] = rl
        elif ft == 4:  # Paeth (sequential; scalar per row)
            rl = row.tolist()
            pv = prev.tolist()
            for i in range(row_len):
                a = rl[i - bpp] if i >= bpp else 0
                b = pv[i]
                c = pv[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                rl[i] = (rl[i] + pr) & 0xFF
            row[:] = rl
        prev = row
    return rows.tobytes()


def _apply_filters(doc: "PdfDocument", sdict: dict, raw: bytes,
                   stop_before_dct: bool = False) -> bytes | tuple[bytes, str]:
    """Run the filter chain. With stop_before_dct, returns
    (bytes, 'dct'|'jpx') when an image codec filter is reached."""
    filters = doc.resolve(sdict.get("Filter", []))
    if isinstance(filters, (Name, str)):
        filters = [filters]
    parms = doc.resolve(sdict.get("DecodeParms", sdict.get("DP", [])))
    if isinstance(parms, dict) or parms is None:
        parms = [parms]
    data = raw
    for i, f in enumerate(filters):
        f = str(f)
        p = doc.resolve(parms[i]) if i < len(parms) else None
        p = p or {}
        if f in ("FlateDecode", "Fl"):
            data = _inflate_bounded(data)
            pred = doc.resolve(p.get("Predictor", 1)) or 1
            if pred >= 10:
                data = _png_predictor(
                    data,
                    doc.resolve(p.get("Colors", 1)) or 1,
                    doc.resolve(p.get("BitsPerComponent", 8)) or 8,
                    doc.resolve(p.get("Columns", 1)) or 1,
                )
            elif pred != 1:
                raise PdfUnsupported(f"TIFF predictor {pred}")
        elif f in ("ASCIIHexDecode", "AHx"):
            hx = re.sub(rb"[\s>]", b"", data)
            if len(hx) % 2:
                hx += b"0"
            data = bytes.fromhex(hx.decode("ascii"))
        elif f in ("ASCII85Decode", "A85"):
            txt = data.replace(b"<~", b"")
            end = txt.find(b"~>")
            if end != -1:
                txt = txt[:end]
            import base64

            data = base64.a85decode(re.sub(rb"\s", b"", txt))
        elif f in ("RunLengthDecode", "RL"):
            out = bytearray()
            j = 0
            while j < len(data):
                n = data[j]
                j += 1
                if n == 128:
                    break
                if n < 128:
                    out += data[j:j + n + 1]
                    j += n + 1
                else:
                    out += bytes([data[j]]) * (257 - n)
                    j += 1
            data = bytes(out)
        elif f in ("DCTDecode", "DCT", "JPXDecode"):
            if stop_before_dct:
                return data, ("jpx" if f == "JPXDecode" else "dct")
            raise PdfUnsupported(f"filter {f} outside image context")
        elif f == "Crypt":
            raise PdfUnsupported("Crypt filter")
        else:
            raise PdfUnsupported(f"filter {f}")
    if stop_before_dct:
        return data, "raw"
    return data


# --- document --------------------------------------------------------------


class PdfDocument:
    def __init__(self, data: bytes):
        self.data = data
        self.objects: dict[int, Any] = {}  # cache
        self.offsets: dict[int, int] = {}
        self.in_stream: dict[int, tuple[int, int]] = {}  # num → (objstm, idx)
        self.trailer: dict[str, Any] = {}
        self._load_xref()
        if "Encrypt" in self.trailer:
            raise PdfUnsupported("encrypted PDF")

    # --- xref machinery ---------------------------------------------------

    def _load_xref(self) -> None:
        tail = self.data[-2048:]
        m = None
        for m in re.finditer(rb"startxref\s+(\d+)", tail):
            pass
        if m is None:
            self._brute_force_scan()
            return
        offset = int(m.group(1))
        seen = set()
        try:
            while offset and offset not in seen:
                seen.add(offset)
                offset = self._load_xref_section(offset)
        except (PdfError, ValueError, IndexError, zlib.error) as exc:
            logger.debug("xref parse failed (%s); brute-force scan", exc)
            self._brute_force_scan()

    def _load_xref_section(self, offset: int) -> int | None:
        lex = _Lexer(self.data, offset)
        lex.skip_ws()
        if self.data[lex.pos:lex.pos + 4] == b"xref":
            lex.pos += 4
            while True:
                lex.skip_ws()
                if self.data[lex.pos:lex.pos + 7] == b"trailer":
                    lex.pos += 7
                    trailer = lex.parse()
                    break
                start = int(lex.token())
                count = int(lex.token())
                for i in range(count):
                    off = int(lex.token())
                    int(lex.token())  # generation
                    kind = lex.token()
                    num = start + i
                    if kind == b"n" and num not in self.offsets and \
                            num not in self.in_stream:
                        self.offsets[num] = off
            for k, v in trailer.items():
                self.trailer.setdefault(k, v)
            xref_stm = trailer.get("XRefStm")
            if isinstance(xref_stm, int):
                self._load_xref_section(xref_stm)
            prev = trailer.get("Prev")
            return int(prev) if prev is not None else None
        # xref stream: "n g obj <<...>> stream"
        num = int(lex.token())
        int(lex.token())
        if lex.token() != b"obj":
            raise PdfError("bad xref stream header")
        raw = lex.parse()
        if not isinstance(raw, _RawStream):
            raise PdfError("xref object is not a stream")
        stream = self._materialize_stream(raw)
        self.objects[num] = stream
        sdict = stream.dict
        data = _apply_filters(self, sdict, stream.raw)
        w = [int(self.resolve(x)) for x in self.resolve(sdict["W"])]
        size = int(self.resolve(sdict["Size"]))
        index = self.resolve(sdict.get("Index", [0, size]))
        row_len = sum(w)
        pos = 0

        def field(row: bytes, k: int) -> int:
            s = sum(w[:k])
            chunk = row[s:s + w[k]]
            return int.from_bytes(chunk, "big") if chunk else (
                1 if k == 0 else 0
            )

        for j in range(0, len(index), 2):
            start, count = int(index[j]), int(index[j + 1])
            for i in range(count):
                if pos + row_len > len(data):
                    break
                row = data[pos:pos + row_len]
                pos += row_len
                objnum = start + i
                ftype = field(row, 0) if w[0] else 1
                if objnum in self.offsets or objnum in self.in_stream:
                    continue
                if ftype == 1:
                    self.offsets[objnum] = field(row, 1)
                elif ftype == 2:
                    self.in_stream[objnum] = (field(row, 1), field(row, 2))
        for k, v in sdict.items():
            if k in ("Size", "Root", "Info", "ID", "Encrypt"):
                self.trailer.setdefault(k, v)
        prev = sdict.get("Prev")
        return int(prev) if prev is not None else None

    def _brute_force_scan(self) -> None:
        """Recovery path: regex every `N G obj` in the file."""
        for m in re.finditer(rb"(?m)^\s*(\d+)\s+(\d+)\s+obj\b", self.data):
            self.offsets[int(m.group(1))] = m.start()
        if "Root" not in self.trailer:
            m = re.search(rb"/Root\s+(\d+)\s+(\d+)\s+R", self.data)
            if m:
                self.trailer["Root"] = Ref(int(m.group(1)), int(m.group(2)))

    # --- objects ----------------------------------------------------------

    def _materialize_stream(self, raw: _RawStream) -> Stream:
        length = self.resolve(raw.dict.get("Length"))
        if not isinstance(length, int):
            end = self.data.find(b"endstream", raw.data_offset)
            if end == -1:
                raise PdfError("unterminated stream")
            length = end - raw.data_offset
        data = self.data[raw.data_offset:raw.data_offset + length]
        return Stream(raw.dict, data)

    def get_object(self, num: int) -> Any:
        if num in self.objects:
            return self.objects[num]
        value: Any = None
        if num in self.offsets:
            lex = _Lexer(self.data, self.offsets[num])
            lex.skip_ws()
            got = int(lex.token())
            int(lex.token())
            kw = lex.token()
            if kw != b"obj" or got != num:
                value = None
            else:
                value = lex.parse()
                if isinstance(value, _RawStream):
                    value = self._materialize_stream(value)
        elif num in self.in_stream:
            stm_num, idx = self.in_stream[num]
            value = self._objstm_object(stm_num, idx)
        self.objects[num] = value
        return value

    def _objstm_object(self, stm_num: int, idx: int) -> Any:
        stm = self.get_object(stm_num)
        if not isinstance(stm, Stream):
            raise PdfError("object stream missing")
        data = _apply_filters(self, stm.dict, stm.raw)
        n = int(self.resolve(stm.dict["N"]))
        first = int(self.resolve(stm.dict["First"]))
        head = _Lexer(data, 0)
        pairs = []
        for _ in range(n):
            pairs.append((int(head.token()), int(head.token())))
        if idx >= len(pairs):
            raise PdfError("objstm index out of range")
        _objnum, rel = pairs[idx]
        lex = _Lexer(data, first + rel)
        return lex.parse()

    def resolve(self, obj: Any, depth: int = 0) -> Any:
        while isinstance(obj, Ref) and depth < 32:
            obj = self.get_object(obj.num)
            depth += 1
        return obj

    # --- pages ------------------------------------------------------------

    def first_page(self) -> dict[str, Any]:
        root = self.resolve(self.trailer.get("Root"))
        if not isinstance(root, dict):
            raise PdfError("no document catalog")
        node = self.resolve(root.get("Pages"))
        inherited: dict[str, Any] = {}
        depth = 0
        while isinstance(node, dict) and depth < 64:
            depth += 1
            for key in ("Resources", "MediaBox", "Rotate"):
                if key in node:
                    inherited[key] = node[key]
            if str(node.get("Type", "")) == "Page" or "Contents" in node and \
                    "Kids" not in node:
                page = dict(inherited)
                page.update(node)
                return page
            kids = self.resolve(node.get("Kids"))
            if not kids:
                break
            node = self.resolve(kids[0])
        raise PdfError("no page found")


# --- image extraction ------------------------------------------------------


def _decode_image_xobject(doc: PdfDocument, stream: Stream) -> np.ndarray | None:
    """Image XObject → RGB uint8 array, or None if unsupported."""
    d = stream.dict
    try:
        data, codec = _apply_filters(doc, d, stream.raw, stop_before_dct=True)
    except PdfUnsupported:
        return None
    except Exception:
        return None
    if codec == "jpx":
        return None  # JPEG2000: PIL support is build-dependent; skip
    if codec == "dct":
        from PIL import Image

        try:
            img = Image.open(io.BytesIO(data))
            return np.asarray(img.convert("RGB"))
        except Exception:
            return None
    width = doc.resolve(d.get("Width"))
    height = doc.resolve(d.get("Height"))
    bpc = doc.resolve(d.get("BitsPerComponent", 8))
    cs = doc.resolve(d.get("ColorSpace"))
    if not isinstance(width, int) or not isinstance(height, int):
        return None
    palette = None
    ncomp = None
    if isinstance(cs, list) and cs and str(cs[0]) == "Indexed":
        base = doc.resolve(cs[1])
        lookup = doc.resolve(cs[3])
        if isinstance(lookup, Stream):
            lookup = _apply_filters(doc, lookup.dict, lookup.raw)
        base_n = 3 if "RGB" in str(base) else (1 if "Gray" in str(base) else 3)
        if isinstance(lookup, bytes):
            palette = np.frombuffer(lookup, np.uint8)
            palette = palette[: (len(palette) // base_n) * base_n].reshape(
                -1, base_n
            )
            ncomp = 1
    if ncomp is None:
        name = str(cs if not isinstance(cs, list) else cs[0])
        if "RGB" in name:
            ncomp = 3
        elif "Gray" in name or "G" == name:
            ncomp = 1
        elif "CMYK" in name:
            ncomp = 4
        elif isinstance(cs, list) and str(cs[0]) == "ICCBased":
            icc = doc.resolve(cs[1])
            n = doc.resolve(icc.dict.get("N", 3)) if isinstance(icc, Stream) else 3
            ncomp = int(n)
        else:
            ncomp = 3
    if bpc == 1:
        bits = np.unpackbits(
            np.frombuffer(data, np.uint8).reshape(height, -1), axis=1
        )[:, : width * ncomp]
        arr = (bits * 255).astype(np.uint8).reshape(height, width, ncomp)
    elif bpc == 8:
        need = width * height * ncomp
        if len(data) < need:
            return None
        arr = np.frombuffer(data[:need], np.uint8).reshape(
            height, width, ncomp
        )
    else:
        return None
    if palette is not None:
        arr = palette[np.minimum(arr[..., 0], len(palette) - 1)]
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    elif arr.shape[-1] == 4:  # CMYK → RGB
        c, m, y, k = [arr[..., i].astype(np.int32) for i in range(4)]
        r = 255 - np.minimum(255, c + k)
        gg = 255 - np.minimum(255, m + k)
        b = 255 - np.minimum(255, y + k)
        arr = np.stack([r, gg, b], axis=-1).astype(np.uint8)
    return arr[..., :3]


def _largest_page_image(doc: PdfDocument, page: dict) -> np.ndarray | None:
    res = doc.resolve(page.get("Resources")) or {}
    xobjects = doc.resolve(res.get("XObject")) or {}
    candidates: list[tuple[int, Stream]] = []
    for _name, ref in list(xobjects.items())[:32]:
        obj = doc.resolve(ref)
        if not isinstance(obj, Stream):
            continue
        if str(doc.resolve(obj.dict.get("Subtype", ""))) != "Image":
            continue
        w = doc.resolve(obj.dict.get("Width", 0)) or 0
        h = doc.resolve(obj.dict.get("Height", 0)) or 0
        if w >= 8 and h >= 8:
            candidates.append((w * h, obj))
    # largest declared size first; the first decodable one wins, so a
    # page of many tiles decodes one image, not all of them
    candidates.sort(key=lambda t: -t[0])
    for _px, obj in candidates:
        arr = _decode_image_xobject(doc, obj)
        if arr is not None:
            return arr
    return None


# --- text fallback ---------------------------------------------------------

_TEXT_SHOW = {b"Tj", b"'", b'"'}


def _extract_text(doc: PdfDocument, page: dict, limit: int = 2000) -> list[str]:
    contents = doc.resolve(page.get("Contents"))
    if isinstance(contents, Stream):
        contents = [contents]
    elif isinstance(contents, list):
        contents = [doc.resolve(c) for c in contents]
    else:
        return []
    data = b"\n".join(
        _apply_filters(doc, c.dict, c.raw)
        for c in contents if isinstance(c, Stream)
    )
    lines: list[str] = []
    current: list[str] = []
    lex = _Lexer(data, 0)
    stack: list[Any] = []
    total = 0
    while lex.pos < len(data) and total < limit:
        lex.skip_ws()
        c = lex.peek()
        if c == -1:
            break
        try:
            if c in (0x2F, 0x28, 0x3C, 0x5B) or \
                    chr(c).isdigit() or c in (0x2B, 0x2D, 0x2E):
                stack.append(lex.parse())
                continue
            op = lex.token()
        except PdfError:
            break
        if not op:
            lex.pos += 1
            continue
        if op in _TEXT_SHOW and stack:
            s = stack[-1]
            if isinstance(s, bytes):
                txt = _printable(s)
                if txt:
                    current.append(txt)
                    total += len(txt)
        elif op == b"TJ" and stack and isinstance(stack[-1], list):
            parts = [
                _printable(x) for x in stack[-1] if isinstance(x, bytes)
            ]
            txt = "".join(parts)
            if txt:
                current.append(txt)
                total += len(txt)
        elif op in (b"Td", b"TD", b"T*", b"TL", b"Tm", b"ET"):
            if current:
                lines.append("".join(current).strip())
                current = []
        stack = []
    if current:
        lines.append("".join(current).strip())
    return [ln for ln in lines if ln]


def _printable(raw: bytes) -> str:
    """Simple-font bytes ≈ latin-1; drop strings that are mostly
    unprintable (CID-keyed fonts we can't map)."""
    txt = raw.decode("latin-1", errors="replace")
    printable = sum(1 for ch in txt if ch.isprintable() or ch.isspace())
    if len(txt) == 0 or printable / len(txt) < 0.7:
        return ""
    return "".join(ch if ch.isprintable() or ch == " " else " " for ch in txt)


def _render_text_page(lines: list[str], media_box: list[float],
                      max_dim: int = MAX_RENDER_DIM) -> np.ndarray:
    from PIL import Image, ImageDraw, ImageFont

    try:
        bw = abs(float(media_box[2]) - float(media_box[0])) or 612.0
        bh = abs(float(media_box[3]) - float(media_box[1])) or 792.0
    except Exception:
        bw, bh = 612.0, 792.0
    scale = max_dim / max(bw, bh)
    w = max(64, int(bw * scale))
    h = max(64, int(bh * scale))
    img = Image.new("RGB", (w, h), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    margin = w // 12
    font_px = max(8, h // 42)
    try:
        font = ImageFont.load_default(size=font_px)
    except TypeError:  # older PIL: fixed-size bitmap font
        font = ImageFont.load_default()
    y = margin
    max_chars = max(16, (w - 2 * margin) // max(4, font_px // 2))
    for line in lines:
        while line and y < h - margin:
            draw.text((margin, y), line[:max_chars], fill=(40, 40, 40),
                      font=font)
            line = line[max_chars:]
            y += int(font_px * 1.45)
        if y >= h - margin:
            break
    return np.asarray(img)


# --- public API ------------------------------------------------------------


def render_pdf(path_or_bytes: str | bytes,
               max_dim: int = MAX_RENDER_DIM) -> np.ndarray:
    """First-page thumbnail → RGBA uint8 [H, W, 4].

    Raises PdfError/PdfUnsupported when nothing can be produced.
    """
    if isinstance(path_or_bytes, bytes):
        data = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if not data.startswith(b"%PDF"):
        raise PdfError("not a PDF")
    doc = PdfDocument(data)
    page = doc.first_page()

    # 1. the page's own /Thumb image (PDF's bundled thumbnail)
    thumb = doc.resolve(page.get("Thumb"))
    arr = None
    if isinstance(thumb, Stream):
        arr = _decode_image_xobject(doc, thumb)
    # 2. real page render: content-stream rasterizer over cairo
    # (pdf_raster.py — paths, text, transforms, placed images; the
    # PDFium-role renderer, ref:crates/images/src/pdf.rs:82-83)
    if arr is None:
        from .pdf_raster import rasterize_page

        try:
            arr = rasterize_page(doc, page, max_dim)
        except Exception:
            logger.debug("pdf raster failed; falling back", exc_info=True)
            arr = None
    # 3. largest image on the page (cairo unavailable / nothing painted)
    if arr is None:
        arr = _largest_page_image(doc, page)
    # 4. typeset extracted text
    if arr is None:
        lines = _extract_text(doc, page)
        if not lines:
            raise PdfUnsupported("no renderable content on page 1")
        arr = _render_text_page(
            lines, doc.resolve(page.get("MediaBox")) or [0, 0, 612, 792],
            max_dim,
        )
    rotate = doc.resolve(page.get("Rotate", 0)) or 0
    if rotate % 360:
        arr = np.rot90(arr, k=(-int(rotate) // 90) % 4)
    h, w = arr.shape[:2]
    if max(h, w) > max_dim:  # bound the decode for the batch pipeline
        step = -(-max(h, w) // max_dim)
        arr = np.ascontiguousarray(arr[::step, ::step])
        h, w = arr.shape[:2]
    rgba = np.dstack([arr, np.full((h, w, 1), 255, np.uint8)])
    return rgba


def pdf_available() -> bool:
    return True  # pure python + PIL; always present
