"""The other decoders of the PyTorch port against the JAX package's.

HEIF/AVIF (libheif), SVG/SVGZ (librsvg), the first PDF page (the bundled
reader, every page builder of tests/test_pdf_svg.py and
tests/test_pdf_fonts.py among the inputs) and video frames and facts
(the native FFmpeg frontend, and cv2 with it switched off) go through
both packages on the same files. Required bit for bit: `format_image`'s
arrays (or the same error class and message), `video_frame`,
`video_meta`, `VideoMetadata.to_row`'s bytes, `process.decode`'s
`Decoded` (array, target, orientation, is_video), `apply_film_strip`,
and `generate_one_cpu`'s webp bytes. Where a system library is absent,
its cases skip with the reason, as the JAX package's own tests do.
"""

import gzip
import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image, features
from test_media import _patch_tkhd_rotation
from test_pdf_fonts import DEJAVU, _build_pdf, _font_stream_obj, _page_objs
from test_pdf_svg import (
    SVG_DOC,
    classic_text_pdf_bytes,
    image_pdf_bytes,
    vector_pdf_bytes,
    xref_stream_pdf_bytes,
)

import spacedrive_tpu.native as jnative
from spacedrive_tpu.object.media import images as jimages
from spacedrive_tpu.object.media import media_data as jmedia
from spacedrive_tpu.object.media import pdf_raster as jraster
from spacedrive_tpu.object.media import svg as jsvg
from spacedrive_tpu.object.media.thumbnail import process as jprocess
from spacedrive_tpu_torch.native import video as pvideo
from spacedrive_tpu_torch.object.media import images as pimages
from spacedrive_tpu_torch.object.media import media_data as pmedia
from spacedrive_tpu_torch.object.media import pdf_raster as praster
from spacedrive_tpu_torch.object.media.thumbnail import host as phost
from spacedrive_tpu_torch.object.media.thumbnail import process as pprocess
from spacedrive_tpu_torch.native import build as native_build
from spacedrive_tpu_torch.ops import thumbnail_dims as tdims

CLIP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_clip_128x96.mp4")


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # noqa: BLE001 - the error itself is compared
        return ("error", type(exc).__name__, str(exc))


def assert_same_decode(port_fn, jax_fn, *args):
    """Both return the same array bit for bit, or both raise the same
    error class with the same message. Returns the port's outcome."""
    p, j = _outcome(port_fn, *args), _outcome(jax_fn, *args)
    assert p[0] == j[0], (p[:3] if p[0] == "error" else "ok", j[:3] if j[0] == "error" else "ok")
    if p[0] == "ok":
        assert p[1].dtype == j[1].dtype == np.uint8 and p[1].shape == j[1].shape
        np.testing.assert_array_equal(p[1], j[1])
    else:
        assert p == j
    return p


# --- PDF ------------------------------------------------------------------


def _rotated_text_pdf():
    return classic_text_pdf_bytes().replace(
        b"/Type /Page /Parent 2 0 R", b"/Type /Page /Parent 2 0 R /Rotate 90")


def _hostile_pdf():
    junk = (b"Q Q Q (str) 9999999999 unknownop /X cm w re f "
            + bytes(range(128, 160)) + b" \xb2\xb3 q q ")
    return vector_pdf_bytes(content_prefix=junk)


def _form_q_underflow_pdf():
    form_content = b"Q Q Q 0 0.8 0 rg 10 10 30 30 re f"
    form = (b"<< /Type /XObject /Subtype /Form /BBox [0 0 612 792] "
            b"/Length " + str(len(form_content)).encode()
            + b" >>\nstream\n" + form_content + b"\nendstream")
    base = vector_pdf_bytes(content_prefix=b"q /Fm1 Do Q ").replace(
        b"/Resources << /Font << /F1 5 0 R >> >>",
        b"/Resources << /Font << /F1 5 0 R >> /XObject << /Fm1 6 0 R >> >>")
    at = base.rindex(b"xref\n0 ")
    return base[:at] + b"6 0 obj\n" + form + b"\nendobj\n" + base[at:]


def _flate_bomb_pdf():
    bomb = zlib.compress(b"\x00" * (64 * 1024 * 1024 + 1024), 9)
    objs = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] /Contents 4 0 R >>",
        b"<< /Length " + str(len(bomb)).encode() + b" /Filter /FlateDecode >>\nstream\n"
        + bomb + b"\nendstream",
    ]
    return _build_pdf(objs)


def _needs_fonts():
    from spacedrive_tpu.object.media.pdf_fonts import _cairo_ft, _ft

    if not jraster.raster_available():
        pytest.skip("cairo not available")
    if _ft() is None or _cairo_ft() is None:
        pytest.skip("freetype not available")
    if not DEJAVU.exists():
        pytest.skip("DejaVuSans.ttf not installed")


_DESCRIPTOR = (b"<< /Type /FontDescriptor /FontName /DejaVuSans "
               b"/Flags 32 /FontFile2 7 0 R >>")


def _truetype_differences_pdf(embedded=True):
    _needs_fonts()
    content = b"BT /F1 48 Tf 1 0 0 1 40 80 Tm 0 0 0 rg (\x01\x02\x03) Tj ET"
    font = (b"<< /Type /Font /Subtype /TrueType /BaseFont /DejaVuSans "
            b"/FirstChar 1 /LastChar 3 /Widths [636 636 636] "
            b"/Encoding << /Type /Encoding /Differences [1 /A /B /C] >> "
            + (b"/FontDescriptor 6 0 R >>" if embedded else b">>"))
    extra = [_DESCRIPTOR, _font_stream_obj(DEJAVU.read_bytes())] if embedded else []
    return _build_pdf(_page_objs(content, font, extra))


def _ascii_embedded_pdf(program=None):
    _needs_fonts()
    content = b"BT /F1 36 Tf 1 0 0 1 30 90 Tm 0 0 0 rg (Hello) Tj ET"
    font = (b"<< /Type /Font /Subtype /TrueType /BaseFont /DejaVuSans "
            b"/FirstChar 72 /LastChar 111 /FontDescriptor 6 0 R >>")
    data = DEJAVU.read_bytes() if program is None else program
    return _build_pdf(_page_objs(content, font, [_DESCRIPTOR, _font_stream_obj(data)]))


def _type0_identity_h_pdf():
    _needs_fonts()
    ttlib = pytest.importorskip("fontTools.ttLib")
    tt = ttlib.TTFont(str(DEJAVU))
    order, cmap = tt.getGlyphOrder(), tt.getBestCmap()
    gids = [order.index(cmap[ord(ch)]) for ch in "Hi"]
    codes = b"".join(bytes([g >> 8, g & 0xFF]) for g in gids)
    content = (b"BT /F1 48 Tf 1 0 0 1 40 80 Tm 0 0 0 rg <" + codes.hex().encode() + b"> Tj ET")
    font = (b"<< /Type /Font /Subtype /Type0 /BaseFont /DejaVuSans "
            b"/Encoding /Identity-H /DescendantFonts [6 0 R] >>")
    descendant = (b"<< /Type /Font /Subtype /CIDFontType2 /BaseFont /DejaVuSans /DW 1000 "
                  b"/CIDToGIDMap /Identity /FontDescriptor 7 0 R >>")
    descriptor = (b"<< /Type /FontDescriptor /FontName /DejaVuSans "
                  b"/Flags 32 /FontFile2 8 0 R >>")
    return _build_pdf(_page_objs(content, font, [descendant, descriptor,
                                                 _font_stream_obj(DEJAVU.read_bytes())]))


def _cairo_generated_pdf(tmp_path):
    """A PDF cairo's PDF surface writes (subset-embedded face)."""
    import ctypes
    import ctypes.util

    _needs_fonts()
    c = ctypes.CDLL(ctypes.util.find_library("cairo") or "libcairo.so.2")
    if not hasattr(c, "cairo_pdf_surface_create"):
        pytest.skip("cairo built without PDF surface")
    V, D = ctypes.c_void_p, ctypes.c_double
    c.cairo_pdf_surface_create.restype = V
    c.cairo_pdf_surface_create.argtypes = [ctypes.c_char_p, D, D]
    c.cairo_create.restype = V
    c.cairo_create.argtypes = [V]
    c.cairo_select_font_face.argtypes = [V, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    c.cairo_set_font_size.argtypes = [V, D]
    c.cairo_move_to.argtypes = [V, D, D]
    c.cairo_show_text.argtypes = [V, ctypes.c_char_p]
    c.cairo_destroy.argtypes = [V]
    c.cairo_surface_destroy.argtypes = [V]
    c.cairo_surface_finish.argtypes = [V]
    out = str(tmp_path / "generated.pdf")
    surf = c.cairo_pdf_surface_create(out.encode(), 400, 200)
    cr = c.cairo_create(surf)
    c.cairo_select_font_face(cr, b"DejaVu Sans", 0, 0)
    c.cairo_set_font_size(cr, 24)
    for i, line in enumerate([b"The quick brown fox", b"jumps over the lazy dog"]):
        c.cairo_move_to(cr, 20, 50 + i * 40)
        c.cairo_show_text(cr, line)
    c.cairo_destroy(cr)
    c.cairo_surface_finish(surf)
    c.cairo_surface_destroy(surf)
    with open(out, "rb") as f:
        return f.read()


PDFS = {
    "image": lambda tmp: image_pdf_bytes(),
    "image_portrait": lambda tmp: image_pdf_bytes(120, 340),
    "text": lambda tmp: classic_text_pdf_bytes(),
    "text_wide_box": lambda tmp: classic_text_pdf_bytes(("one line",), (0, 0, 800, 300)),
    "rotate_90": lambda tmp: _rotated_text_pdf(),
    "xref_stream_objstm": lambda tmp: xref_stream_pdf_bytes(),
    "vector": lambda tmp: vector_pdf_bytes(),
    "hostile_stream": lambda tmp: _hostile_pdf(),
    "form_q_underflow": lambda tmp: _form_q_underflow_pdf(),
    "truetype_differences": lambda tmp: _truetype_differences_pdf(),
    "differences_without_program": lambda tmp: _truetype_differences_pdf(embedded=False),
    "embedded_ascii": lambda tmp: _ascii_embedded_pdf(),
    "type0_identity_h": lambda tmp: _type0_identity_h_pdf(),
    "cairo_generated": _cairo_generated_pdf,
    "corrupt_font_program": lambda tmp: _ascii_embedded_pdf(b"\x00garbage" * 100),
    # the failures: the same error class and message from both
    "encrypted": lambda tmp: classic_text_pdf_bytes().replace(
        b"/Root 1 0 R", b"/Root 1 0 R /Encrypt 5 0 R"),
    "garbage": lambda tmp: b"%PDF-1.4\nnot really a pdf",
    "no_page_tree": lambda tmp: b"%PDF-1.4",
    "not_a_pdf": lambda tmp: b"GIF89a not a pdf at all",
    "flate_bomb": lambda tmp: _flate_bomb_pdf(),
}
# (the control bytes of differences_without_program draw nothing
# without the font program: nothing renderable on page 1)
FAILING_PDFS = {"encrypted", "garbage", "no_page_tree", "not_a_pdf", "flate_bomb",
                "differences_without_program"}


@pytest.mark.parametrize("name", sorted(PDFS))
def test_format_image_pdf_matches_jax(tmp_path, name):
    path = tmp_path / f"{name}.pdf"
    path.write_bytes(PDFS[name](tmp_path))
    got = assert_same_decode(pimages.format_image, jimages.format_image, str(path))
    assert (got[0] == "error") == (name in FAILING_PDFS), got[:3]
    if got[0] == "error":
        assert got[1] == "ImageHandlerError"
    else:
        assert got[1].ndim == 3 and got[1].shape[2] == 4 and max(got[1].shape[:2]) <= 512


@pytest.mark.parametrize("name", ["image", "text", "xref_stream_objstm", "rotate_90"])
def test_pdf_fallback_strategies_match_jax(tmp_path, monkeypatch, name):
    """With the rasterizer out of the way (it returns nothing), the
    largest page image and the typeset text take over in both."""
    monkeypatch.setattr(praster, "rasterize_page", lambda *a, **k: None)
    monkeypatch.setattr(jraster, "rasterize_page", lambda *a, **k: None)
    path = tmp_path / f"{name}.pdf"
    path.write_bytes(PDFS[name](tmp_path))
    got = assert_same_decode(pimages.format_image, jimages.format_image, str(path))
    assert got[0] == "ok"


def _one_page_pdf(content: bytes) -> bytes:
    """A one-page PDF with a Helvetica resource whose content stream is
    `content`, flate-compressed."""
    stream = zlib.compress(content)
    objs = [b"<< /Type /Catalog /Pages 2 0 R >>", b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
            b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] /Contents 4 0 R "
            b"/Resources << /Font << /F1 5 0 R >> >> >>",
            b"<< /Length " + str(len(stream)).encode() + b" /Filter /FlateDecode >>\nstream\n"
            + stream + b"\nendstream",
            b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>"]
    out, offsets = bytearray(b"%PDF-1.4\n"), []
    for i, o in enumerate(objs, 1):
        offsets.append(len(out))
        out += str(i).encode() + b" 0 obj\n" + o + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 6\n0000000000 65535 f \n" + b"".join(f"{o:010d} 00000 n \n".encode()
                                                         for o in offsets)
    out += b"trailer\n<< /Size 6 /Root 1 0 R >>\nstartxref\n" + str(xref).encode() + b"\n%%EOF\n"
    return bytes(out)


@pytest.mark.parametrize("with_text", [False, True])
def test_vector_art_alone_needs_cairo_in_both(tmp_path, monkeypatch, with_text):
    """On a host without cairo no strategy of the reader renders a page
    of vector art alone: both packages raise the same error; a line of
    text on the page makes the typeset-text strategy render it, equal in
    both."""
    monkeypatch.setattr(praster, "_cairo_lib", [None])
    monkeypatch.setattr(jraster, "_cairo_lib", [None])
    content = (b"0.9 0.1 0.1 rg 50 50 m 250 50 l 150 250 l h f "
               b"0.1 0.2 0.9 rg 300 500 200 150 re f ")
    if with_text:
        content += b"BT /F1 24 Tf 72 700 Td (a page on the card) Tj ET"
    path = tmp_path / "page.pdf"
    path.write_bytes(_one_page_pdf(content))
    got = assert_same_decode(pimages.format_image, jimages.format_image, str(path))
    assert got[0] == ("ok" if with_text else "error"), got[:3]
    if not with_text:
        assert got[1] == "ImageHandlerError" and "no renderable content" in got[2]


# --- SVG ------------------------------------------------------------------


def _seeded_svg(seed, w=160, h=90):
    rng = np.random.default_rng(seed)
    shapes = []
    for _ in range(8):
        x, y = rng.integers(0, w), rng.integers(0, h)
        r, g, b = rng.integers(0, 256, 3)
        op = rng.uniform(0.3, 1.0)
        shapes.append(f'<circle cx="{x}" cy="{y}" r="{rng.integers(4, 40)}" '
                      f'fill="rgb({r},{g},{b})" fill-opacity="{op:.2f}"/>')
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}" '
            f'viewBox="0 0 {w} {h}">' + "".join(shapes) + "</svg>").encode()


SVGS = {
    "doc.svg": SVG_DOC,
    "seeded.svg": _seeded_svg(1),
    "tall.svg": _seeded_svg(2, 60, 300),
    "gz.svgz": gzip.compress(_seeded_svg(3)),
    "invalid.svg": b"<svg xmlns='oops",
    "torn.svgz": gzip.compress(_seeded_svg(4))[:40],
}


@pytest.mark.parametrize("name", sorted(SVGS))
def test_format_image_svg_matches_jax(tmp_path, name):
    if not jsvg.svg_available():
        pytest.skip("librsvg not present")
    path = tmp_path / name
    path.write_bytes(SVGS[name])
    got = assert_same_decode(pimages.format_image, jimages.format_image, str(path))
    assert (got[0] == "ok") == (name not in ("invalid.svg", "torn.svgz"))
    if got[0] == "ok":
        assert max(got[1].shape[:2]) == 512


# --- HEIF / AVIF ------------------------------------------------------------


def _avif(path, seed, size=(64, 48)):
    if not jimages.heif_available():
        pytest.skip("libheif unavailable")
    if not features.check("avif"):
        pytest.skip("PIL cannot write AVIF")
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (5, 5, 3), dtype=np.uint8)
    img = Image.fromarray(coarse).resize(size, Image.BILINEAR)
    img.save(path, "AVIF", quality=80)


@pytest.mark.parametrize("seed,size", [(0, (64, 48)), (1, (33, 100)), (2, (300, 200))])
def test_format_image_avif_through_libheif_matches_jax(tmp_path, seed, size):
    path = tmp_path / f"photo{seed}.avif"
    _avif(path, seed, size)
    got = assert_same_decode(pimages.format_image, jimages.format_image, str(path))
    assert got[0] == "ok" and got[1].shape == (size[1], size[0], 4)
    # the port reads through libheif, the JAX package's decoder, not PIL
    np.testing.assert_array_equal(got[1], jimages.decode_heif(str(path)))


def test_decode_heif_of_a_non_heif_file_raises_in_both():
    if not pimages.heif_available():
        pytest.skip("libheif unavailable")
    p = _outcome(pimages.decode_heif, "/dev/null")
    j = _outcome(jimages.decode_heif, "/dev/null")
    assert p == j and p[:2] == ("error", "ImageHandlerError")


# --- video ------------------------------------------------------------------


def _cover_mp3(seed=0):
    """An MP3 with an ID3 APIC frame holding seeded JPEG cover art."""
    rng = np.random.default_rng(seed)
    art = Image.fromarray(rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)).resize(
        (64, 48), Image.BILINEAR)
    buf = io.BytesIO()
    art.save(buf, "JPEG")
    apic = b"\x00" + b"image/jpeg\x00" + b"\x03" + b"cover\x00" + buf.getvalue()

    def synchsafe(n):
        return bytes([(n >> 21) & 0x7F, (n >> 14) & 0x7F, (n >> 7) & 0x7F, n & 0x7F])

    body = b"APIC" + struct.pack(">I", len(apic)) + b"\x00\x00" + apic
    id3 = b"ID3\x03\x00\x00" + synchsafe(len(body)) + body
    return id3 + (b"\xff\xfb\x90\x00" + b"\x00" * 413) * 30  # MPEG1 L3 128k/44.1k


def _videos(tmp_path):
    with open(CLIP, "rb") as f:
        clip = f.read()
    # song.mpg: the taxonomy thumbnails video extensions only (mp3 is
    # audio); libav finds the MPEG audio and its cover by content
    files = {"clip.mp4": clip, "rot90.mov": _patch_tkhd_rotation(clip, 90),
             "song.mp3": _cover_mp3(), "song.mpg": _cover_mp3(1), "broken.mp4": clip[:200]}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    return {name: str(tmp_path / name) for name in files}


def _needs_native():
    if not jnative.video_available():
        pytest.skip("libav unavailable")
    assert pvideo.video_available()


@pytest.mark.parametrize("name", ["clip.mp4", "rot90.mov", "song.mp3", "broken.mp4"])
def test_native_video_frame_matches_jax(tmp_path, name):
    _needs_native()
    path = _videos(tmp_path)[name]
    p, j = _outcome(pvideo.video_frame, path), _outcome(jnative.video_frame, path)
    assert p[0] == j[0]
    if p[0] == "error":
        assert name == "broken.mp4" and p == j
        return
    (parr, prot, pcover), (jarr, jrot, jcover) = p[1], j[1]
    np.testing.assert_array_equal(parr, jarr)
    assert (prot, pcover) == (jrot, jcover)
    assert (prot, pcover) == {"clip.mp4": (0, False), "rot90.mov": (90, False),
                              "song.mp3": (0, True)}[name]


@pytest.mark.parametrize("name", ["clip.mp4", "rot90.mov", "song.mp3", "broken.mp4"])
def test_video_meta_and_row_match_jax(tmp_path, name):
    _needs_native()
    path = _videos(tmp_path)[name]
    assert _outcome(pvideo.video_meta, path) == _outcome(jnative.video_meta, path)
    p, j = pmedia.VideoMetadata.from_path(path), jmedia.VideoMetadata.from_path(path)
    assert (p is None) == (j is None)
    if p is not None:
        assert p == pmedia.VideoMetadata(**vars(j))
        assert p.to_row(9) == j.to_row(9)
    if name == "clip.mp4":
        assert (p.resolution, p.frame_count, p.codec) == ((128, 96), 30, "mpeg4")


@pytest.mark.parametrize("name", ["clip.mp4", "rot90.mov", "broken.mp4"])
def test_cv2_video_path_matches_jax(tmp_path, monkeypatch, name):
    """With the native frontend switched off in both packages, frames and
    facts come from cv2, alike."""
    pytest.importorskip("cv2")
    monkeypatch.setattr(pvideo, "video_available", lambda: False)
    monkeypatch.setattr(pvideo, "video_meta", lambda path: None)
    monkeypatch.setattr(jnative, "video_available", lambda: False)
    monkeypatch.setattr(jnative, "video_meta", lambda path: None)
    path = _videos(tmp_path)[name]
    p = _outcome(pprocess.decode_video_frame, path)
    j = _outcome(jprocess.decode_video_frame, path)
    assert p[0] == j[0]
    if p[0] == "ok":
        np.testing.assert_array_equal(p[1].array, j[1].array)
        assert (p[1].target, p[1].is_video) == (j[1].target, j[1].is_video)
        assert p[1].is_video and sorted(p[1].target) == [96, 128]
    else:
        assert name == "broken.mp4" and p[1] == j[1] == "ThumbError"
    pm, jm = pmedia.VideoMetadata.from_path(path), jmedia.VideoMetadata.from_path(path)
    assert (pm is None) == (jm is None)
    if pm is not None:
        assert pm.to_row(3) == jm.to_row(3)


def test_a_failed_frontend_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """Where libav is found, a build failure raises NativeBuildError, on
    the first call and on every later one; where it is not, the frontend
    is simply unavailable and a frame comes from cv2."""
    bad = tmp_path / "movie_decoder.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(pvideo, "_SRC", str(bad))
    monkeypatch.setattr(pvideo, "libav_present", lambda: True)
    monkeypatch.setattr(pvideo, "_outcome", [])
    for _ in range(2):
        with pytest.raises(native_build.NativeBuildError, match="not C|error"):
            pvideo.video_available()
    with pytest.raises(native_build.NativeBuildError):
        phost.decode_video_frame(CLIP)
    with pytest.raises(native_build.NativeBuildError):
        pmedia.VideoMetadata.from_path(CLIP)

    monkeypatch.setattr(pvideo, "libav_present", lambda: False)
    monkeypatch.setattr(pvideo, "_outcome", [])
    assert not pvideo.video_available() and pvideo.video_meta(CLIP) is None
    pytest.importorskip("cv2")
    assert phost.decode_video_frame(CLIP).array.shape == (96, 128, 4)


async def test_a_failed_frontend_build_fails_the_thumbnail_batch(tmp_path, monkeypatch):
    """The actor reports a broken frontend as its batch's failure, not as
    a bad file."""
    from spacedrive_tpu_torch.object.media.thumbnail.actor import Thumbnailer, ThumbnailerError

    def broken():
        raise native_build.NativeBuildError("could not build movie_decoder.c")

    monkeypatch.setattr(pvideo, "video_available", broken)
    th = Thumbnailer(tmp_path / "data", device="cpu")
    try:
        batch = th.new_indexed_thumbnails_batch("lib", [("00aa" * 4, CLIP, "mp4")])
        with pytest.raises(ThumbnailerError, match="could not build"):
            await th.wait_batch(batch)
        assert th.generated == 0
    finally:
        await th.shutdown()


# --- process.decode, the film strip and generate_one_cpu by kind ------------


def _kinds(tmp_path):
    """One file of every kind: {name: (path, ext)}; kinds whose library is
    absent are left out (and counted by the callers' skips)."""
    out = {}
    for name, path in _videos(tmp_path).items():
        if name not in ("broken.mp4", "song.mp3"):
            out[name] = path
    (tmp_path / "vector.pdf").write_bytes(vector_pdf_bytes())
    (tmp_path / "image.pdf").write_bytes(image_pdf_bytes(600, 260))
    out["vector.pdf"] = str(tmp_path / "vector.pdf")
    out["image.pdf"] = str(tmp_path / "image.pdf")
    for name in ("seeded.svg", "gz.svgz"):
        (tmp_path / name).write_bytes(SVGS[name])
        out[name] = str(tmp_path / name)
    if jimages.heif_available() and features.check("avif"):
        _avif(tmp_path / "photo.avif", 5, (900, 700))
        out["photo.avif"] = str(tmp_path / "photo.avif")
    rng = np.random.default_rng(6)
    Image.fromarray(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)).save(
        tmp_path / "img.jpg", quality=90)
    out["img.jpg"] = str(tmp_path / "img.jpg")
    return {name: (path, name.rsplit(".", 1)[1]) for name, path in out.items()}


KINDS = ["clip.mp4", "rot90.mov", "song.mpg", "vector.pdf", "image.pdf", "seeded.svg", "gz.svgz",
         "photo.avif", "img.jpg"]


def _kind(tmp_path, name):
    kinds = _kinds(tmp_path)
    if name not in kinds:
        pytest.skip(f"{name}: its decoder's library is unavailable here")
    ext = kinds[name][1]
    if ext in ("svg", "svgz") and not jsvg.svg_available():
        pytest.skip("librsvg not present")
    if ext in ("mp4", "mov", "mpg") and not jnative.video_available():
        pytest.importorskip("cv2")
        if name == "song.mpg":
            pytest.skip("cover art needs the native frontend (libav unavailable)")
    return kinds[name]


@pytest.mark.parametrize("name", KINDS)
def test_decode_matches_jax(tmp_path, name):
    path, ext = _kind(tmp_path, name)
    p, j = pprocess.decode(path, ext), jprocess.decode(path, ext)
    np.testing.assert_array_equal(p.array, j.array)
    assert (p.target, p.orientation, p.is_video) == (j.target, j.orientation, j.is_video)
    assert p.is_video == (ext in ("mp4", "mov"))
    dims = tdims.video_dimensions if ext in ("mp4", "mov", "mpg") else tdims.scale_dimensions
    h, w = p.array.shape[:2]
    assert p.target == dims(w, h)[::-1]


@pytest.mark.parametrize("name", KINDS)
def test_generate_one_cpu_bytes_match_jax(tmp_path, name):
    path, ext = _kind(tmp_path, name)
    assert pprocess.generate_one_cpu(path, ext) == jprocess.generate_one_cpu(path, ext)


@pytest.mark.parametrize("h,w", [(96, 128), (256, 171), (40, 8), (3, 300), (1, 1)])
def test_apply_film_strip_matches_jax(h, w):
    arr = np.random.default_rng(h * 1000 + w).integers(0, 256, (h, w, 4), dtype=np.uint8)
    before = arr.copy()
    np.testing.assert_array_equal(pprocess.apply_film_strip(arr), jprocess.apply_film_strip(arr))
    np.testing.assert_array_equal(arr, before)  # a copy, the input untouched


def test_finish_strips_video_frames_only():
    rng = np.random.default_rng(7)
    arr = rng.integers(100, 256, (96, 128, 4), dtype=np.uint8)
    for is_video in (False, True):
        d = pprocess.Decoded(array=arr, target=(96, 128), is_video=is_video)
        jd = jprocess.Decoded(array=arr, target=(96, 128), is_video=is_video)
        assert pprocess.finish(d, arr) == jprocess.finish(jd, arr)
        assert pprocess.resize_cpu(d) == jprocess.resize_cpu(jd)
    plain = pprocess.finish(pprocess.Decoded(array=arr, target=(96, 128)), arr)
    assert plain != pprocess.finish(pprocess.Decoded(array=arr, target=(96, 128), is_video=True),
                                     arr)


@pytest.mark.parametrize("side", [906, 333, 1001])
def test_native_frame_of_an_unaligned_width(tmp_path, side):
    """Rows whose byte width is no multiple of swscale's vector width (the
    JAX package's frontend overruns its buffer on them, so only the
    port's runs here): the frame decodes whole, close to PIL's decode of
    the same cover JPEG (another YUV conversion: mean within 4 levels)."""
    if not pvideo.libav_present():
        pytest.skip("libav unavailable")
    rng = np.random.default_rng(side)
    art = Image.fromarray(rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)).resize(
        (side, side * 3 // 4), Image.BILINEAR)
    buf = io.BytesIO()
    art.save(buf, "JPEG", quality=90)
    apic = b"\x00image/jpeg\x00\x03cover\x00" + buf.getvalue()
    n = len(apic) + 10
    body = b"APIC" + struct.pack(">I", len(apic)) + b"\x00\x00" + apic
    tag = b"ID3\x03\x00\x00" + bytes([(n >> 21) & 0x7F, (n >> 14) & 0x7F, (n >> 7) & 0x7F, n & 0x7F])
    path = tmp_path / "song.mpg"
    path.write_bytes(tag + body + (b"\xff\xfb\x90\x00" + b"\x00" * 413) * 30)
    arr, rotation, is_cover = pvideo.video_frame(str(path))
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"), np.int16)
    assert (rotation, is_cover) == (0, True) and arr.shape == want.shape[:2] + (4,)
    assert (arr[..., 3] == 255).all()
    assert float(np.abs(arr[..., :3].astype(np.int16) - want).mean()) < 4
