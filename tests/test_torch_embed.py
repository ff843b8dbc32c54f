"""The patch-pool embedder in the PyTorch port against the JAX package.

Tolerance: allclose(atol=1e-5, rtol=1e-5) for vectors (float32 matmul
and tanh in another order of summation); the weights themselves are
byte-identical. Inputs are made with numpy from a seed; the port runs
on device="cpu".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacedrive_tpu.models import embedder as jembedder
from spacedrive_tpu.ops import embed_jax
from spacedrive_tpu_torch.models import embedder
from spacedrive_tpu_torch.ops import embed_torch

ATOL = RTOL = 1e-5


def _batch(seed, n):
    rng = np.random.default_rng(seed)
    return rng.random((n, embedder.IMAGE_SIZE, embedder.IMAGE_SIZE, 3), dtype=np.float32)


def test_derived_params_are_byte_identical():
    mine, theirs = embedder.derived_params(), jembedder._derived_params()
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype == np.float32
        np.testing.assert_array_equal(mine[k], theirs[k])


def test_load_jax_params_and_forward_match():
    params = jembedder.params()
    module = embedder.load_jax_params(embedder.PatchPoolEmbedder("cpu"), params)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_array_equal(getattr(module, k).numpy(), params[k])
    x = _batch(0, 8)
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    want = np.asarray(jembedder.forward({k: jnp.asarray(v) for k, v in params.items()},
                                        jnp.asarray(x)))
    assert got.shape == want.shape == (8, embedder.EMBED_DIM) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_load_jax_params_from_a_checkpoint_tree(tmp_path):
    """A scaled `embedder.npz` checkpoint tree loads through the same
    function and changes the vectors accordingly."""
    from spacedrive_tpu.models import checkpoint

    tree = {k: v * np.float32(0.5) for k, v in jembedder._derived_params().items()}
    path = jembedder.save_artifact(tmp_path, tree)
    loaded, _ = checkpoint.load(path)
    module = embedder.load_jax_params(embedder.PatchPoolEmbedder("cpu"),
                                      {k: np.asarray(loaded[k]) for k in tree})
    x = _batch(1, 4)
    want = np.asarray(jembedder.forward({k: jnp.asarray(v) for k, v in tree.items()},
                                        jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(module(torch.from_numpy(x)).numpy(), want,
                                   atol=ATOL, rtol=RTOL)


def test_load_jax_params_rejects_bad_trees():
    module = embedder.PatchPoolEmbedder("cpu")
    params = embedder.derived_params()
    with pytest.raises(ValueError, match="lack"):
        embedder.load_jax_params(module, {k: v for k, v in params.items() if k != "b2"})
    with pytest.raises(ValueError, match="shape"):
        embedder.load_jax_params(module, {**params, "w1": params["w1"][:10]})


@pytest.mark.parametrize("n", [1, 5, 8])
def test_embed_batch_matches_jax(n):
    x = _batch(10 + n, n)
    got = embed_torch.embed_batch(x, device="cpu")
    want = embed_jax.embed_batch(x, devices=[jax.devices("cpu")[0]])
    assert got.shape == (n, embedder.EMBED_DIM) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_embed_batch_pad_rows_change_no_real_row():
    """Each row embeds alone as it does inside a padded batch (to the
    stated tolerance: the CPU's matmul blocks by batch size)."""
    x = _batch(3, 5)
    full = embed_torch.embed_batch(x, device="cpu")
    for i in range(5):
        np.testing.assert_allclose(embed_torch.embed_batch(x[i:i + 1], device="cpu")[0],
                                   full[i], atol=ATOL, rtol=RTOL)
    assert embed_torch.embed_batch(x[:0], device="cpu").shape == (0, embedder.EMBED_DIM)
    with pytest.raises(ValueError, match="shape"):
        embed_torch.embed_batch(x[:, :16], device="cpu")


def test_decode_image_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    p = str(tmp_path / "x.png")
    Image.fromarray(rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)).save(p)
    np.testing.assert_array_equal(embedder.decode_image(p), jembedder.decode_image(p))
    (tmp_path / "bad.png").write_bytes(b"not an image")
    assert embedder.decode_image(str(tmp_path / "bad.png")) is None
