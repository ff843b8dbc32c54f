"""The port's LabelerNet, checkpoints and bundled artifact against the
JAX package.

Same seeded inputs (numpy) and the same parameters, carried from the
flax tree with `params_from_flax`, go through the flax forward
(`LabelerNet.apply`, jitted on the main thread as the JAX actor jits
it) and the port's module on the CPU, both in bf16.

Tolerance, from bf16: 8 significant bits, rounded after each of the
10-14 conv, GroupNorm and SiLU layers, in another order in each
framework, and amplified where the last stage's GroupNorm normalizes a
1×1 map (31² and 32² inputs). Over 4 seeds × 16 images per case the
largest deviations were 0.42 on logits and 0.033 on probabilities. So:
logits within 0.5 + 0.05·|logit|, probabilities within 0.05, and the
label masks at the actor's 0.35 threshold equal wherever the JAX
probability lies outside 0.35 ± 0.05 (the band).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from spacedrive_tpu.models import checkpoint as jax_checkpoint
from spacedrive_tpu.models import labeler as jax_labeler
from spacedrive_tpu.models.make_bundled import ARTIFACT as JAX_ARTIFACT
from spacedrive_tpu.models.make_bundled import MANIFEST as JAX_MANIFEST
from spacedrive_tpu.models.train import SCENE_CLASSES, digits_demo_dataset, render_scene
from spacedrive_tpu_torch.models import checkpoint, labeler, provision

THRESHOLD = 0.35
BAND = 0.05
LOGIT_ATOL, LOGIT_RTOL = 0.5, 0.05


def _jax_forward(model, params, images: np.ndarray) -> np.ndarray:
    return np.asarray(jax.jit(lambda p, x: model.apply({"params": p}, x))(params, images))


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x.astype(np.float64)))


def assert_labels_agree(want_logits: np.ndarray, got_logits: np.ndarray) -> None:
    np.testing.assert_allclose(got_logits, want_logits, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    pw, pg = _sigmoid(want_logits), _sigmoid(got_logits)
    assert np.abs(pw - pg).max() <= BAND
    outside = np.abs(pw - THRESHOLD) > BAND
    assert np.array_equal((pw >= THRESHOLD)[outside], (pg >= THRESHOLD)[outside])


def _bundled():
    params, meta = jax_checkpoint.load(JAX_ARTIFACT)
    model = jax_labeler.LabelerNet(num_classes=len(meta["classes"]),
                                   widths=tuple(meta["widths"]), depths=tuple(meta["depths"]))
    return model, params, meta


NARROW = dict(num_classes=80, widths=(8, 16, 32, 64, 64), depths=(1, 2, 2, 1))


@pytest.mark.parametrize("config,size", [
    ("bundled", 32),   # the bundled artifact's own size
    ("narrow", 64),    # full topology (depths 1,2,2,1), narrow widths
    ("bundled", 31),   # odd sizes: SAME pads (1, 1) at stride 2
    ("bundled", 33),
    ("narrow", 47),
])
def test_forward_matches_jax(config, size):
    if config == "bundled":
        jmodel, params, meta = _bundled()
        arch = dict(num_classes=len(meta["classes"]), widths=meta["widths"],
                    depths=meta["depths"])
    else:
        jmodel = jax_labeler.LabelerNet(**NARROW)
        params = jax.tree.map(np.asarray, jax_labeler.init_params(
            jax.random.key(3), image_size=size, model=jmodel))
        arch = NARROW
    x = np.random.default_rng(size).random((16, size, size, 3), dtype=np.float32)
    want = _jax_forward(jmodel, params, x)
    model = labeler.from_flax(params, device="cpu", **arch)
    probs, mask = labeler.infer_step(model, torch.from_numpy(x), THRESHOLD)
    got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert_labels_agree(want, got)
    np.testing.assert_array_equal(mask.numpy(), probs.numpy() >= THRESHOLD)
    np.testing.assert_allclose(probs.numpy(), _sigmoid(got), atol=1e-6)


@pytest.mark.parametrize("size", [1, 2, 7, 14, 31, 32, 33, 224])
@pytest.mark.parametrize("stride", [1, 2])
def test_same_pads_match_lax(size, stride):
    from jax import lax

    assert labeler.same_pads(size, stride) == tuple(
        lax.padtype_to_pads((size,), (3,), (stride,), "SAME")[0])


def test_params_from_flax_maps_every_leaf():
    jmodel = jax_labeler.LabelerNet(**NARROW)
    params = jax.tree.map(np.asarray, jax_labeler.init_params(jax.random.key(0), 32, jmodel))
    model = labeler.LabelerNet(**NARROW)
    state = labeler.params_from_flax(params, model)
    assert set(state) == set(model.state_dict())
    n_leaves = len(jax.tree.leaves(params))
    assert len(state) == n_leaves == sum(1 for _ in model.parameters())
    # names in flax's order: stem, stage downsamples, then bottlenecks numbered across stages
    paths = [p for p, _ in model.blocks()]
    assert paths[:4] == ["ConvBlock_0", "ConvBlock_1", "Bottleneck_0/ConvBlock_0",
                         "Bottleneck_0/ConvBlock_1"]
    assert "Bottleneck_5/ConvBlock_1" in paths and "ConvBlock_4" in paths
    k = params["Bottleneck_2"]["ConvBlock_1"]["Conv_0"]["kernel"]  # HWIO
    block = dict(model.blocks())["Bottleneck_2/ConvBlock_1"]
    name = next(n for n, p in model.named_parameters() if p is block.weight)
    np.testing.assert_array_equal(state[name].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["dense1_weight"].numpy(), params["Dense_1"]["kernel"].T)
    np.testing.assert_array_equal(state["dense0_bias"].numpy(), params["Dense_0"]["bias"])
    with pytest.raises(RuntimeError, match="size mismatch"):  # another architecture
        labeler.from_flax(params, 80, labeler.DEFAULT_WIDTHS, labeler.DEFAULT_DEPTHS, "cpu")
    del params["Dense_1"]
    with pytest.raises(KeyError, match="Dense_1"):
        labeler.params_from_flax(params, model)


def test_checkpoints_load_across_packages(tmp_path):
    """A checkpoint written by the JAX package loads in the port and the
    reverse, bit for bit, meta included."""
    jmodel = jax_labeler.LabelerNet(num_classes=3, widths=(8, 8, 8, 8, 8), depths=(1, 1, 1, 1))
    params = jax.tree.map(np.asarray, jax_labeler.init_params(jax.random.key(1), 32, jmodel))
    kw = dict(classes=["a", "b", "c"], image_size=32, widths=(8, 8, 8, 8, 8),
              depths=(1, 1, 1, 1), extra={"metrics": {"x": 1.0}})
    jax_checkpoint.save(tmp_path / "jax.npz", params, **kw)
    checkpoint.save(tmp_path / "port.npz", params, **kw)
    for writer in ("jax.npz", "port.npz"):
        for load in (checkpoint.load, jax_checkpoint.load):
            tree, meta = load(tmp_path / writer)
            assert meta == {"format": "spacedrive-labeler-v1", "classes": ["a", "b", "c"],
                            "image_size": 32, "widths": [8] * 5, "depths": [1] * 4,
                            "metrics": {"x": 1.0}}
            flat_a = jax.tree_util.tree_leaves_with_path(params)
            flat_b = dict(jax.tree_util.tree_leaves_with_path(tree))
            assert len(flat_a) == len(flat_b)
            for path, leaf in flat_a:
                np.testing.assert_array_equal(flat_b[path], leaf)
    # the port's forward from either file equals the JAX forward on the tree
    x = np.random.default_rng(5).random((4, 32, 32, 3), dtype=np.float32)
    tree, meta = checkpoint.load(tmp_path / "jax.npz")
    model = labeler.from_flax(tree, len(meta["classes"]), meta["widths"], meta["depths"], "cpu")
    assert_labels_agree(_jax_forward(jmodel, params, x), model(torch.from_numpy(x)).numpy())
    (tmp_path / "bad.npz").write_bytes((tmp_path / "jax.npz").read_bytes()[:100])
    with pytest.raises(Exception):
        checkpoint.load(tmp_path / "bad.npz")
    np.savez(tmp_path / "nometa.npz", w=np.zeros(3))
    with pytest.raises(ValueError, match="missing meta"):
        checkpoint.load(tmp_path / "nometa.npz")


def test_bundled_artifact_is_the_jax_package_pin():
    with open(JAX_MANIFEST) as f:
        jax_manifest = json.load(f)
    with open(provision.MANIFEST) as f:
        manifest = json.load(f)
    assert manifest == jax_manifest
    assert provision.sha256_file(provision.ARTIFACT) == jax_manifest["sha256"]
    assert os.path.getsize(provision.ARTIFACT) == jax_manifest["bytes"]
    assert os.path.dirname(provision.ARTIFACT).startswith(
        os.path.dirname(os.path.abspath(labeler.__file__)))


def test_bundled_golden_labels_through_the_port():
    """`test_bundled_golden_labels_jax_native`'s bars, through the port's
    forward on the port's copy of the artifact: ≥80% of 12 digit scans
    named, and every scene class on ≥2 of 3 held-out renders, at 0.5."""
    tree, meta = checkpoint.load(provision.ARTIFACT)
    classes = list(meta["classes"])
    model = labeler.from_flax(tree, len(classes), meta["widths"], meta["depths"], "cpu")

    def probs(x: np.ndarray) -> np.ndarray:
        return labeler.infer_step(model, torch.from_numpy(np.ascontiguousarray(x)))[0].numpy()

    _, (ev_x, ev_y), dclasses = digits_demo_dataset(32)
    n_digits = 12
    pr = probs(ev_x[:n_digits])
    hits = sum(dclasses[int(ev_y[i].argmax())] in {classes[j] for j in np.where(pr[i] > 0.5)[0]}
               for i in range(n_digits))
    assert hits >= int(0.8 * n_digits), hits
    rng = np.random.default_rng(987654)
    for kind in SCENE_CLASSES:
        got = 0
        for _rep in range(3):
            pr = probs(render_scene(kind, rng, 32)[None, ...])[0]
            got += kind in {classes[j] for j in np.where(pr > 0.5)[0]}
        assert got >= 2, (kind, got)


def test_init_params_is_seeded_and_flops_count_the_shapes():
    a = labeler.init_params(torch.Generator().manual_seed(0), labeler.LabelerNet(**NARROW))
    b = labeler.init_params(torch.Generator().manual_seed(0), labeler.LabelerNet(**NARROW))
    c = labeler.init_params(torch.Generator().manual_seed(1), labeler.LabelerNet(**NARROW))
    for (n, pa), pb, pc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(pa, pb)
        if pa.dim() > 1:
            assert not torch.equal(pa, pc)
            assert abs(pa.std().item() * pa[0].numel() ** 0.5 - 1.0) < 0.2, n
    full = labeler.LabelerNet()
    assert sum(p.numel() for p in full.parameters()) == 5_358_704  # the flax tree's count
    # 2 × 9 × Cin × Cout × H'W' per conv: 112² stem, then 56², 28², 14², 7² stages
    convs = (112 ** 2 * 3 * 32 + 56 ** 2 * (32 * 64 + 2 * 64 * 64)
             + 28 ** 2 * (64 * 128 + 4 * 128 * 128) + 14 ** 2 * (128 * 256 + 4 * 256 * 256)
             + 7 ** 2 * (256 * 256 + 2 * 256 * 256))
    assert labeler.conv_flops(full, 224) == 2 * 9 * convs + 2 * (256 * 512 + 512 * 80)
    x = torch.rand((2, 40, 40, 3), generator=torch.Generator().manual_seed(2))
    probs, mask = labeler.infer_step(a, x)
    assert probs.shape == (2, 80) and torch.isfinite(probs).all()
    assert torch.equal(mask, probs >= 0.35)
