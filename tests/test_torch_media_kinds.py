"""The port's media chain on a mixed library against the JAX package's.

The tree holds every kind the thumbnailer decodes: JPEG and PNG images,
AVIF (written by PIL, read through libheif; left out where either is
missing), an MPEG-4 clip, its tkhd-rotated copy, cover-art MPEG audio,
PDFs (vector, image and text pages), an SVG and an SVGZ, plus a
truncated clip and a broken PDF that neither package decodes. Both
packages run `scan_location(backend="cpu")` through the node stubs of
tests/test_torch_media.py. Required, cold and warm: the same thumbnail
store paths and webp dimensions, media_data rows byte for byte (video
rows included), journal rows byte for byte, crdt_operation counts, the
media job's run metadata, embeddings (allclose 1e-5) for image rows
only (AVIF among them); a warm rescan extracts, embeds and thumbnails
nothing (the two broken files are re-dispatched and fail again in
both). Pixels before encode are within 1 uint8 level of the JAX resize
(the tolerance of tests/test_torch_thumbnail.py). With the bundled
labeler provisioned, `index --library` labels every image row, AVIF
included, as the JAX forward decides, and no other row. `index_pass`
thumbnails every kind and embeds image rows only.
"""

import os

import numpy as np
import pytest
from PIL import Image, features
from test_pdf_svg import classic_text_pdf_bytes, image_pdf_bytes, vector_pdf_bytes
from test_torch_decoders import CLIP, SVGS, _cover_mp3
from test_media import _patch_tkhd_rotation
from test_torch_labeler_actor import (  # noqa: F401 - no_network is a fixture
    _jax_bundled_probs,
    _label_rows,
    assert_rows_match,
    no_network,
)
from test_torch_media import JAX, PORT, _Chain, assert_same

import spacedrive_tpu.native as jnative
from spacedrive_tpu.object.media.images import heif_available
from spacedrive_tpu.object.media.svg import svg_available
from spacedrive_tpu.object.media.thumbnail import process as jprocess
from spacedrive_tpu_torch import cli
from spacedrive_tpu_torch.index_pass import index_pass
from spacedrive_tpu_torch.object.media.thumbnail import process as pprocess
from spacedrive_tpu_torch.ops import thumbnail_dims as tdims
from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

HAS_AVIF = heif_available() and features.check("avif")
N_BROKEN = 2  # broken.mp4, broken.pdf


def make_mixed_tree(root):
    """{relative name: kind} of the tree written under `root`."""
    os.makedirs(os.path.join(root, "docs"))
    os.makedirs(os.path.join(root, "video"))
    rng = np.random.default_rng(21)
    kinds = {}

    def put(name, data, kind):
        with open(os.path.join(root, name), "wb") as f:
            f.write(data)
        kinds[name] = kind

    for i, (w, h, fmt) in enumerate([(640, 480, "JPEG"), (300, 900, "PNG")]):
        coarse = rng.integers(0, 256, (5, 5, 3), dtype=np.uint8)
        img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
        name = f"img{i}.{'jpg' if fmt == 'JPEG' else 'png'}"
        img.save(os.path.join(root, name), fmt)
        kinds[name] = "image"
    if HAS_AVIF:
        for i, (w, h) in enumerate([(900, 700), (120, 80)]):
            coarse = rng.integers(0, 256, (5, 5, 3), dtype=np.uint8)
            Image.fromarray(coarse).resize((w, h), Image.BILINEAR).save(
                os.path.join(root, f"photo{i}.avif"), "AVIF", quality=80)
            kinds[f"photo{i}.avif"] = "image"
    with open(CLIP, "rb") as f:
        clip = f.read()
    put("video/clip.mp4", clip, "video")
    put("video/rot90.mov", _patch_tkhd_rotation(clip, 90), "video")
    put("video/song.mpg", _cover_mp3(2), "video")
    put("video/broken.mp4", clip[:200], "broken")
    put("docs/vector.pdf", vector_pdf_bytes(), "doc")
    put("docs/image.pdf", image_pdf_bytes(500, 300), "doc")
    put("docs/text.pdf", classic_text_pdf_bytes(), "doc")
    put("docs/broken.pdf", b"%PDF-1.4 nothing here", "broken")
    if svg_available():
        put("docs/art.svg", SVGS["seeded.svg"], "doc")
        put("docs/art.svgz", SVGS["gz.svgz"], "doc")
    put("notes.txt", b"not media", "other")
    return kinds


def _needs_video():
    if not jnative.video_available():
        pytest.skip("libav unavailable: the cover-art and rotation cases need the native frontend")


async def _both(tmp_path):
    loc = tmp_path / "loc"
    kinds = make_mixed_tree(str(loc))
    return loc, kinds, _Chain(JAX, str(tmp_path / "jax")), _Chain(PORT, str(tmp_path / "port"))


async def test_mixed_library_media_job_matches_jax(tmp_path):
    _needs_video()
    loc, kinds, jax, port = await _both(tmp_path)
    try:
        jmeta, jtasks_n = await jax.scan(loc)
        pmeta, ptasks_n = await port.scan(loc)
        assert pmeta == jmeta and ptasks_n == jtasks_n
        ps, js = port.snapshot(), jax.snapshot()
        assert_same(ps, js)
        # not vacuous: a thumbnail per decodable file, media_data for the
        # EXIF images and the videos, vectors for the images only
        n = {k: sum(v == k for v in kinds.values()) for k in ("image", "video", "doc", "broken")}
        assert len(ps["webps"]) == n["image"] + n["video"] + n["doc"]
        assert pmeta["thumbnails_dispatched"] == len(ps["webps"]) + N_BROKEN
        assert port.node.thumbnailer.errors == N_BROKEN
        assert len(ps["embeddings"]) == n["image"] and pmeta["embeddings_written"] == n["image"]
        videos = [unpackb(m["camera_data"]) for k, m in ps["media"].items()
                  if k != "rows" and m["camera_data"] and unpackb(m["camera_data"]).get("video")]
        assert sorted(v["codec"] for v in videos) == ["mjpeg", "mpeg4", "mpeg4"]
        # a vouch for every decodable row, media vouches for the broken clip too
        vouched = {key: unpackb(p) for key, (p, *_) in ps["journal"].items()}
        assert sum(bool(v.get("thumb")) for v in vouched.values()) == len(ps["webps"])
        assert sum(bool(v.get("embed")) for v in vouched.values()) == n["image"]
        assert "media" in vouched[("/video/", "broken", "mp4")]
        assert max(max(d) for d in ps["webps"].values()) <= 1024

        generated = port.node.thumbnailer.generated
        jmeta, _ = await jax.scan(loc)
        pmeta, _ = await port.scan(loc)
        assert pmeta == jmeta == {"media_data_extracted": 0, "media_data_skipped": 0,
                                  "thumbnails_dispatched": N_BROKEN, "embeddings_written": 0}
        assert port.node.thumbnailer.generated == generated
        assert_same(port.snapshot(), jax.snapshot())
    finally:
        await jax.close()
        await port.close()


def test_mixed_resize_pixels_match_jax_before_encode(tmp_path):
    """Every decodable file of the tree, decoded by each package (equal)
    and resized through `process.resize_decoded`: dims exact (video at
    `video_dimensions`, the rest at `scale_dimensions`), pixels within 1
    uint8 level of the JAX resize, and the film strip on clips only."""
    _needs_video()
    loc = tmp_path / "loc"
    kinds = make_mixed_tree(str(loc))
    names = [n for n, k in kinds.items() if k in ("image", "video", "doc")]
    paths = [(os.path.join(loc, n), n.rsplit(".", 1)[1]) for n in names]
    pdec = [pprocess.decode(p, e) for p, e in paths]
    jdec = [jprocess.decode(p, e) for p, e in paths]
    for name, p, j in zip(names, pdec, jdec):
        np.testing.assert_array_equal(p.array, j.array)
        assert (p.target, p.orientation, p.is_video) == (j.target, j.orientation, j.is_video)
        h, w = p.array.shape[:2]
        video = kinds[name] == "video"
        assert p.target == (tdims.video_dimensions if video else tdims.scale_dimensions)(w, h)[::-1]
        assert p.is_video == name.endswith((".mp4", ".mov"))
    assert not any(pprocess.needs_cpu_fallback(d) for d in pdec)
    got = pprocess.resize_decoded(pdec, "cpu")
    want = jprocess.resize_decoded(jdec)
    for d, g, w in zip(pdec, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == d.target + (4,)
        assert int(np.abs(g.astype(np.int16) - w.astype(np.int16)).max()) <= 1


def test_index_pass_thumbnails_every_kind_and_embeds_images_only(tmp_path):
    _needs_video()
    loc = tmp_path / "loc"
    kinds = make_mixed_tree(str(loc))
    res = index_pass(loc, tmp_path / "data", device="cpu", keep_pixels=True)
    by_kind = {}
    for name, kind in kinds.items():
        by_kind.setdefault(kind, set()).add(res.cas_ids[os.path.join(str(loc), name)])
    assert set(res.thumbnails) == by_kind["image"] | by_kind["video"] | by_kind["doc"]
    assert set(res.embeddings) == by_kind["image"]
    assert res.summary["thumbnails"] == len(res.thumbnails)
    for name, kind in kinds.items():
        if kind not in ("image", "video", "doc"):
            continue
        path = os.path.join(str(loc), name)
        d = pprocess.decode(path, name.rsplit(".", 1)[1])
        cas_id = res.cas_ids[path]
        assert res.resized[cas_id].shape == d.target + (4,)
        with Image.open(res.thumbnails[cas_id]) as im:
            assert im.size == d.target[::-1]


def test_index_library_labels_image_rows_only(tmp_path, capsys, no_network):  # noqa: F811
    """The bundled labeler on a mixed library: every image row is
    labelled (AVIF through libheif) as the JAX forward decides; no video,
    PDF or SVG row is."""
    loc = tmp_path / "loc"
    kinds = make_mixed_tree(str(loc))
    data_dir = str(tmp_path / "node")
    assert cli.main(["labeler", "provision", "--bundled", "--data-dir", data_dir]) == 0
    capsys.readouterr()
    assert cli.main(["index", str(loc), "--data-dir", data_dir, "--library", "L",
                     "--device", "cpu", "--no-p2p"]) == 0
    summary = __import__("json").loads(capsys.readouterr().out)
    images = sorted(n for n, k in kinds.items() if k == "image")
    assert summary["labeled"] == len(images)
    rows = _label_rows(data_dir)
    assert set(rows) <= {os.path.basename(n) for n in images}
    probs, classes = _jax_bundled_probs([os.path.join(str(loc), n) for n in images])
    assert_rows_match([rows.get(os.path.basename(n), set()) for n in images], probs, classes)
