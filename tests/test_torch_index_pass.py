"""The port's indexing pass as a whole against the JAX package.

On a seeded ~40-file corpus (mixed sizes, 6 PNG/JPEG images) the port's
`index_pass(device="cpu")` must give: cas_ids bit-identical to the JAX
package's host `cas_id_cpu`; thumbnails at the JAX store's `path_for`;
device-resized pixels within 1 uint8 level of the JAX resize; vectors
allclose(atol=1e-5, rtol=1e-5) to the JAX embedder.
"""

import json
import os

import jax
import numpy as np
import pytest
from PIL import Image

from spacedrive_tpu.models import embedder as jembedder
from spacedrive_tpu.object.media.thumbnail import process as jprocess
from spacedrive_tpu.object.media.thumbnail.store import ThumbnailStore as JaxStore
from spacedrive_tpu.ops import cas as jcas
from spacedrive_tpu.ops import embed_jax
from spacedrive_tpu.ops import thumbnail_jax as tj
from spacedrive_tpu_torch import cli
from spacedrive_tpu_torch.index_pass import index_pass

SIZES = [0, 0, 1, 1023, 1024, 1025, 4096, 57352, 102399, 102400, 102401]
IMAGES = [  # name, (w, h), exif orientation
    ("p0.png", (300, 200), 1), ("p1.png", (180, 240), 1), ("j0.jpg", (800, 450), 6),
    ("j1.jpg", (450, 800), 1), ("j2.jpg", (960, 720), 3), ("wide.png", (1500, 300), 1),
]


def _make_corpus(root):
    rng = np.random.default_rng(42)
    sizes = SIZES + [int(s) for s in rng.integers(1, 300_000, 22)]
    contents = []
    for i, size in enumerate(sizes):
        d = os.path.join(root, f"d{i % 3}", "sub" if i % 5 == 0 else "")
        os.makedirs(d, exist_ok=True)
        contents.append(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        with open(os.path.join(d, f"f{i:02d}.bin"), "wb") as f:
            f.write(contents[-1])
    with open(os.path.join(root, "dup.bin"), "wb") as f:
        f.write(contents[7])  # a second copy of one file: one object
    img_dir = os.path.join(root, "img")
    os.makedirs(img_dir)
    for name, (w, h), orientation in IMAGES:
        coarse = rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)
        img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
        p = os.path.join(img_dir, name)
        if name.endswith(".jpg"):
            exif = Image.Exif()
            exif[0x0112] = orientation
            img.save(p, "JPEG", quality=85, exif=exif.tobytes())
        else:
            img.save(p, "PNG")
    paths = [os.path.join(dp, f) for dp, _, fs in os.walk(root) for f in fs]
    return sorted(paths)


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    data = str(tmp_path_factory.mktemp("data"))
    paths = _make_corpus(root)
    return paths, data, index_pass(root, data, device="cpu", keep_pixels=True)


def test_cas_ids_match_jax_host_path(indexed):
    paths, _, result = indexed
    assert sorted(result.cas_ids) == paths
    for p in paths:
        size = os.path.getsize(p)
        assert result.cas_ids[p] == (jcas.cas_id_cpu(p, size) if size else None), p
    s = result.summary
    assert s["files"] == len(paths)
    assert s["objects"] == len({c for c in result.cas_ids.values() if c}) == len(paths) - 3
    assert s["bytes"] == sum(os.path.getsize(p) for p in paths)
    assert s["backend"] == "cpu" and s["thumbnails"] == len(IMAGES)


def test_thumbnails_at_jax_store_paths(indexed):
    _, data, result = indexed
    jstore = JaxStore(data)
    images = {p: c for p, c in result.cas_ids.items() if p.endswith((".png", ".jpg"))}
    assert len(images) == len(IMAGES)
    for p, cas_id in images.items():
        path = result.thumbnails[cas_id]
        assert path == jstore.path_for(None, cas_id) and os.path.exists(path)
        d = jprocess.decode_image(p)
        th, tw = d.target
        with Image.open(path) as im:
            assert im.size == ((th, tw) if d.orientation in (5, 6, 7, 8) else (tw, th))


def test_resized_pixels_within_one_level_of_jax(indexed):
    _, _, result = indexed
    images = {p: c for p, c in result.cas_ids.items() if p.endswith((".png", ".jpg"))}
    decoded = {c: jprocess.decode_image(p) for p, c in images.items()}
    on_device = {c: d for c, d in decoded.items() if not jprocess.needs_cpu_fallback(d)}
    assert sorted(result.resized) == sorted(on_device) and len(on_device) == len(IMAGES) - 1
    keys = sorted(on_device)
    want = tj.resize_batch([on_device[c].array for c in keys], [on_device[c].target for c in keys],
                           devices=[jax.devices("cpu")[0]])
    for c, w in zip(keys, want):
        got = result.resized[c]
        assert got.shape == w.shape
        assert int(np.abs(got.astype(np.int16) - w.astype(np.int16)).max()) <= 1


def test_vectors_match_jax_embedder(indexed):
    _, _, result = indexed
    images = {p: c for p, c in result.cas_ids.items() if p.endswith((".png", ".jpg"))}
    assert sorted(result.embeddings) == sorted(images.values())
    keys = sorted(images)
    want = embed_jax.embed_batch(np.stack([jembedder.decode_image(p) for p in keys]),
                                 devices=[jax.devices("cpu")[0]])
    for p, w in zip(keys, want):
        np.testing.assert_allclose(result.embeddings[images[p]], w, atol=1e-5, rtol=1e-5)


def test_cli_index_prints_one_json_line(tmp_path, capsys):
    corpus = tmp_path / "c"
    corpus.mkdir()
    (corpus / "a.bin").write_bytes(b"hello")
    (corpus / "b.bin").write_bytes(b"")
    assert cli.main(["index", str(corpus), "--data-dir", str(tmp_path / "d"),
                     "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    assert "\n" not in line
    out = json.loads(line)
    assert set(out) == {"files", "objects", "bytes", "thumbnails", "backend", "seconds"}
    assert (out["files"], out["objects"], out["bytes"], out["thumbnails"], out["backend"]) == (
        2, 1, 5, 0, "cpu")
