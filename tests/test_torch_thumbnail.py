"""Thumbnail resize and store in the PyTorch port against the JAX package.

Tolerance: resized pixels within 1 uint8 level of the JAX resize
(`jax.image.scale_and_translate`, triangle, antialias) with identical
output dims; the two packages sum the same float32 products in another
order, so a value that lands within an ulp of .5 may round the other
way. Everything else (dims, buckets, orientation, store paths) is exact.
Inputs are made with numpy from a seed; the port runs on device="cpu".
"""

import os

import jax
import numpy as np
import pytest
from PIL import Image

from spacedrive_tpu.object.media.thumbnail import process as jprocess
from spacedrive_tpu.object.media.thumbnail.store import ThumbnailStore as JaxStore
from spacedrive_tpu.ops import thumbnail_jax as tj
from spacedrive_tpu_torch.object.media.thumbnail import process
from spacedrive_tpu_torch.object.media.thumbnail.store import ThumbnailStore
from spacedrive_tpu_torch.ops import thumbnail_torch as tt


def _image(rng, h, w):
    """Smooth seeded RGBA content with some texture (so the antialias
    window matters) and a varying alpha channel."""
    coarse = rng.integers(0, 256, (9, 9, 4), dtype=np.uint8)
    base = np.asarray(Image.fromarray(coarse, "RGBA").resize((w, h), Image.BILINEAR))
    noise = rng.integers(0, 48, (h, w, 4), dtype=np.uint8)
    return np.clip(base.astype(np.int16) + noise - 24, 0, 255).astype(np.uint8)


def _assert_within_one(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.uint8
        assert int(np.abs(g.astype(np.int16) - w.astype(np.int16)).max()) <= 1


@pytest.mark.parametrize("w,h", [(1, 1), (100, 80), (640, 480), (4032, 3024), (3000, 700),
                                 (700, 3000), (5000, 1000), (513, 1)])
def test_dimension_helpers_match(w, h):
    assert tt.scale_dimensions(w, h) == tj.scale_dimensions(w, h)
    assert tt.video_dimensions(w, h) == tj.video_dimensions(w, h)
    assert tt.bucket_for(h, w) == tj.bucket_for(h, w)


# (canvas bucket, out_size, [(h, w, th, tw), ...]): the 256 and 512
# squares and one 1024 landscape half, landscape and portrait inputs,
# explicit down-scaled targets so the small output canvases suffice
CASES = [
    ((256, 256), 256, [(200, 150, 100, 75), (90, 256, 45, 128), (256, 256, 256, 256)]),
    ((512, 512), 512, [(500, 333, 120, 80), (300, 512, 150, 256), (512, 400, 511, 399)]),
    ((512, 1024), 512, [(500, 1000, 250, 500), (1000, 480, 480, 230), (400, 900, 77, 99)]),
]


@pytest.mark.parametrize("bucket,out_size,shapes", CASES)
def test_resize_batch_matches_jax(bucket, out_size, shapes):
    rng = np.random.default_rng(out_size + len(shapes) + bucket[0])
    images = [_image(rng, h, w) for h, w, _, _ in shapes]
    targets = [(th, tw) for _, _, th, tw in shapes]
    assert {tt.bucket_for(*im.shape[:2]) for im in images} == {bucket}
    got = tt.resize_batch(images, targets, out_size=out_size, device="cpu")
    want = tj.resize_batch(images, targets, out_size=out_size, devices=[jax.devices("cpu")[0]])
    _assert_within_one(got, want)
    for g, (th, tw) in zip(got, targets):
        assert g.shape == (th, tw, 4)


def test_weight_matrix_rows_are_normalised():
    import torch

    scale = torch.tensor([0.25, 0.5, 1.0], dtype=torch.float32)
    wm = tt.weight_matrix(64, 64, scale)
    sums = wm.sum(dim=2)
    # rows whose sample lies inside the input sum to one; the rest are zero
    for k, s in enumerate((0.25, 0.5, 1.0)):
        inside = int(64 * s)
        np.testing.assert_allclose(sums[k, :inside].numpy(), 1.0, atol=1e-6)
        assert not sums[k, inside:].any()


def test_resize_rejects_what_the_caller_must_filter():
    img = np.zeros((10, 10, 4), np.uint8)
    with pytest.raises(ValueError, match="max bucket"):
        tt.resize_batch([np.zeros((5000, 10, 4), np.uint8)], [(5, 5)], device="cpu")
    with pytest.raises(ValueError, match="canvas"):
        tt.resize_batch([img], [(10, 2000)], device="cpu")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_apply_orientation_matches(orientation):
    arr = np.arange(3 * 5 * 4, dtype=np.uint8).reshape(3, 5, 4)
    np.testing.assert_array_equal(
        tt.apply_orientation(arr, orientation), tj.apply_orientation(arr, orientation))


def _write_images(root, rng):
    paths = {}
    for name, (w, h), fmt, orient in [
        ("a.jpg", (900, 600), "JPEG", 6), ("b.png", (300, 500), "PNG", 1),
        ("c.jpg", (2000, 1500), "JPEG", 3), ("wide.png", (2400, 400), "PNG", 1),
    ]:
        img = Image.fromarray(_image(rng, h, w)[..., :3])
        p = os.path.join(root, name)
        if fmt == "JPEG":
            exif = Image.Exif()
            exif[0x0112] = orient
            img.save(p, fmt, quality=90, exif=exif.tobytes())
        else:
            img.save(p, fmt)
        paths[name] = p
    return paths


def test_decode_and_finish_match_jax(tmp_path):
    """decode_image (JPEG draft mode included), the CPU-fallback test,
    the host resize for wide aspects, and orientation + webp encode."""
    paths = _write_images(str(tmp_path), np.random.default_rng(5))
    for name, p in paths.items():
        d, jd = process.decode_image(p), jprocess.decode_image(p)
        np.testing.assert_array_equal(d.array, jd.array)
        assert (d.target, d.orientation) == (jd.target, jd.orientation), name
        assert process.needs_cpu_fallback(d) == jprocess.needs_cpu_fallback(jd)
        if process.needs_cpu_fallback(d):
            assert name == "wide.png"
            assert process.resize_cpu(d) == jprocess.resize_cpu(jd)
            continue
        (arr,) = process.resize_decoded([d], device="cpu")
        webp = process.finish(d, arr)
        assert webp == jprocess.finish(jd, arr)  # same pixels → same bytes
        th, tw = d.target
        with Image.open(__import__("io").BytesIO(webp)) as im:
            want = (th, tw) if d.orientation in (5, 6, 7, 8) else (tw, th)
            assert im.size == want


def test_can_generate_matches():
    for ext in ("jpg", "JPEG", "png", "gif", "webp", "heic", "svg", "pdf", "mp4", "txt", None):
        assert process.can_generate(ext) == (
            jprocess.can_generate(ext) and (ext or "").lower() in process.IMAGE_EXTENSIONS)
    assert set(process.IMAGE_EXTENSIONS) <= set(jprocess.IMAGE_EXTENSIONS)


def test_store_layout_matches_jax(tmp_path):
    cas_id = "0123456789abcdef"
    store, jstore = ThumbnailStore(tmp_path / "a"), JaxStore(tmp_path / "b")
    for lib in (None, "lib-1"):
        rel = os.path.relpath(store.path_for(lib, cas_id), tmp_path / "a")
        assert rel == os.path.relpath(jstore.path_for(lib, cas_id), tmp_path / "b")
        assert rel.split(os.sep)[-2:] == ["012", f"{cas_id}.webp"]
    p = store.write(None, cas_id, b"RIFF")
    assert store.exists(None, cas_id) and open(p, "rb").read() == b"RIFF"
    with open(os.path.join(store.root, "version.txt")) as f:
        assert f.read() == "1"
    # a v0 flat thumbnail migrates into the shard layout, as in the JAX store
    (tmp_path / "c" / "thumbnails").mkdir(parents=True)
    (tmp_path / "c" / "thumbnails" / f"{cas_id}.webp").write_bytes(b"old")
    assert open(ThumbnailStore(tmp_path / "c").path_for(None, cas_id), "rb").read() == b"old"
