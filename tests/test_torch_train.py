"""The port's labeler training against the JAX package.

Data streams (the scene renderer, the datasets, the batch streams) are
numpy and PIL in both packages: equal bit for bit, given the same seed.
The flax tree goes into the port and back bit for bit.

One training step starts both packages from one flax tree on one seeded
batch. Both compute in bf16 from float32 parameters, so the loss and
gradients differ by rounding, in another order in each framework.
Measured over 6 seeds × batch 8 at the bundled widths: at 64² the loss
within 5e-4 and every leaf's gradient within 0.11 relative L2 (cosine ≥
0.994); at 32² the last stage's GroupNorm normalizes a 1×1 map of 4
channels per group, which amplifies the rounding. There the loss stays
within 0.0061 and the dense leaves past that norm within 0.071 (cosine ≥
0.9977), but the leaves before it differ by up to 0.99, and each
package's bf16 gradient differs from a float64 one by up to 1.6 (JAX)
and 0.57 (the port). So: loss within 0.015 at both sizes; every leaf
within GRAD_RTOL 0.25 and cosine ≥ GRAD_COS 0.97 at 64²; the dense
leaves within 0.15 and cosine ≥ 0.99 at 32². After the step the
parameters differ by at most one AdamW step each way, 2·lr (an Adam
step moves a parameter by about lr·sign(gradient) when two gradients
disagree in sign). The AdamW update on the same float32 gradients and
parameters equals `optax.adamw` within 1e-6 relative.
"""

import asyncio
import functools
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from spacedrive_tpu.models import checkpoint as jax_checkpoint
from spacedrive_tpu.models import labeler as jax_labeler
from spacedrive_tpu.models import train as jax_train
from spacedrive_tpu_torch.cli import main
from spacedrive_tpu_torch.db.database import LibraryDb
from spacedrive_tpu_torch.models import checkpoint, labeler, make_bundled, provision, train
from spacedrive_tpu_torch.models.labeler_actor import ImageLabeler

BUNDLED = dict(widths=(8, 16, 32, 32, 32), depths=(1, 1, 1, 1))
NARROW = dict(num_classes=80, widths=(8, 16, 32, 64, 64), depths=(1, 2, 2, 1))
LR = 1e-3
LOSS_ATOL = 0.015
GRAD_RTOL, GRAD_COS = 0.25, 0.97
DENSE_RTOL_32, DENSE_COS_32 = 0.15, 0.99
ADAMW_RTOL = 1e-6
THRESHOLD, BAND = 0.35, 0.05


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- data streams, bit for bit ------------------------------------------


@pytest.mark.parametrize("size", [32, 96])
@pytest.mark.parametrize("kind", jax_train.SCENE_CLASSES)
def test_render_scene_matches_jax(kind, size):
    a, b = np.random.default_rng(size), np.random.default_rng(size)
    for _ in range(3):  # and each render consumes the same draws
        got, want = train.render_scene(kind, a, size), jax_train.render_scene(kind, b, size)
        assert got.dtype == want.dtype == np.float32 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown scene kind"):
        train.render_scene("sunset", a)


def test_scene_and_bundled_datasets_match_jax():
    for got, want in zip(train.scene_dataset(32, 5, seed=3), jax_train.scene_dataset(32, 5, seed=3)):
        np.testing.assert_array_equal(got, want)
    got, want = train.bundled_dataset(32, per_scene=10, seed=1), \
        jax_train.bundled_dataset(32, per_scene=10, seed=1)
    assert got[2] == want[2] == [f"digit {d}" for d in range(10)] + train.SCENE_CLASSES
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g, w)


def test_digits_demo_dataset_matches_jax():
    got, want = train.digits_demo_dataset(32), jax_train.digits_demo_dataset(32)
    assert got[2] == want[2]
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,batch", [(50, 8), (5, 8), (16, 16)])
def test_array_batches_match_jax(n, batch):
    x = np.random.default_rng(n).random((n, 4, 4, 3), dtype=np.float32)
    y = np.eye(n, 7, dtype=np.float32)
    got, want = train.array_batches(x, y, batch, seed=5), jax_train.array_batches(x, y, batch, seed=5)
    for _ in range(20):
        for g, w in zip(next(got), next(want)):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="empty"):
        next(train.array_batches(x[:0], y[:0], batch))


def _image_tree(root, per_class=5, size=20, broken=True):
    rng = np.random.default_rng(11)
    for c in ("red", "green", "blue"):
        os.makedirs(root / c)
        for i in range(per_class):
            Image.fromarray(rng.integers(0, 256, (size, size + i, 3), dtype=np.uint8)).save(
                root / c / f"{i}.png")
    (root / "notes.txt").write_text("not a class")
    (root / ".hidden").mkdir()
    if broken:
        (root / "green" / "broken.png").write_bytes(b"not a png")
    (root / "green" / "readme.md").write_text("skipped: not an image")


@pytest.mark.parametrize("batch", [4, 64])
def test_folder_batches_match_jax(tmp_path, batch):
    _image_tree(tmp_path)
    samples, classes = train.scan_folder_dataset(tmp_path)
    assert (samples, classes) == jax_train.scan_folder_dataset(tmp_path)
    assert classes == ["blue", "green", "red"] and len(samples) == 16
    got = train._folder_batches(samples, 3, train.TrainConfig(image_size=12, batch_size=batch),
                                np.random.default_rng(7))
    want = jax_train._folder_batches(samples, 3, jax_train.TrainConfig(image_size=12,
                                                                       batch_size=batch),
                                     np.random.default_rng(7))
    for _ in range(12):  # past the first epoch: the uint8 cache serves the rest
        (gx, gy), (wx, wy) = next(got), next(want)
        assert gx.shape == (min(batch, 16), 12, 12, 3)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no class folders"):
        train.scan_folder_dataset(empty)


# ---- parameters ------------------------------------------------------------


def test_params_to_flax_inverts_params_from_flax():
    tree = _jax_init(jax_labeler.LabelerNet(**NARROW), 4, 32)
    model = labeler.LabelerNet(**NARROW)
    model.load_state_dict(labeler.params_from_flax(tree, model))
    _assert_trees_equal(labeler.params_to_flax(model), tree)
    # and the port's own state survives the trip the other way
    again = labeler.LabelerNet(**NARROW)
    again.load_state_dict(labeler.params_from_flax(labeler.params_to_flax(model), again))
    for (name, p), q in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(p, q), name


def test_create_train_state_draws_flax_init_and_optax_adamw_values():
    model, opt = labeler.create_train_state(torch.Generator().manual_seed(0))
    assert model.num_classes == 80 and model.widths == labeler.DEFAULT_WIDTHS
    assert all(p.requires_grad for p in model.parameters())
    (group,) = opt.param_groups
    assert group["params"] == list(model.parameters())
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == \
        (1e-3, (0.9, 0.999), 1e-8, 1e-4)
    assert not group["amsgrad"] and not group["maximize"]
    jtree = _flat(_jax_init(jax_labeler.LabelerNet(), 0, 32))
    ttree = _flat(labeler.params_to_flax(model))
    assert sorted(jtree) == sorted(ttree)
    for k, want in jtree.items():
        got = ttree[k]
        if k.endswith("scale"):
            assert (got == 1).all() and (want == 1).all()
        elif k.endswith("bias"):
            assert (got == 0).all() and (want == 0).all()
        else:  # flax's truncated LeCun normal: σ = 1/√fan_in, cut at ±2σ/0.8796
            sigma = np.prod(got.shape[:-1]) ** -0.5
            limit = 2 * sigma / 0.87962566103423978
            assert np.abs(got).max() <= limit * (1 + 1e-6) and np.abs(want).max() <= limit * 1.001
            if got.size >= 10_000:
                assert abs(got.std() / sigma - 1) < 0.03, k
                assert abs(got.std() / want.std() - 1) < 0.05, k
                assert np.abs(got).max() > 0.95 * limit, k
    again, _ = labeler.create_train_state(torch.Generator().manual_seed(0))
    other, _ = labeler.create_train_state(torch.Generator().manual_seed(1))
    w = model.stages[2][1].block0.weight
    assert torch.equal(w, again.stages[2][1].block0.weight)
    assert not torch.equal(w, other.stages[2][1].block0.weight)


def test_serving_loaders_return_frozen_models():
    tree = labeler.params_to_flax(labeler.init_params(torch.Generator().manual_seed(0),
                                                      labeler.LabelerNet(3, **BUNDLED)))
    for model in (labeler.from_flax(tree, 3, BUNDLED["widths"], BUNDLED["depths"], "cpu"),
                  labeler.init_params(torch.Generator(), labeler.LabelerNet(3, **BUNDLED))):
        assert not model.training and not any(p.requires_grad for p in model.parameters())
        assert not model(torch.rand(2, 32, 32, 3)).requires_grad


# ---- one training step against JAX ------------------------------------------


def _jax_init(jmodel, seed, size):
    """The flax tree `jax_labeler.init_params` draws, jitted (as the JAX
    `train` runs it), as numpy."""
    init = jax.jit(lambda key: jax_labeler.init_params(key, size, jmodel))
    return jax.tree.map(np.asarray, init(jax.random.key(seed)))


@functools.cache
def _jax_step(jmodel):
    """The JAX package's training step, jitted as its `train` jits it:
    (loss, gradients, parameters after one optax.adamw(LR) update)."""
    tx = optax.adamw(LR)

    def step(tree, x, y):
        loss, grads = jax.value_and_grad(functools.partial(jax_labeler.loss_fn, jmodel))(
            tree, x, y)
        updates, _ = tx.update(grads, tx.init(tree), tree)
        return loss, grads, optax.apply_updates(tree, updates)

    return jax.jit(step)


def _step_inputs(seed, size, n_classes=16):
    jmodel = jax_labeler.LabelerNet(num_classes=n_classes, **BUNDLED)
    tree = _jax_init(jmodel, seed, size)
    rng = np.random.default_rng(seed)
    x = rng.random((8, size, size, 3), dtype=np.float32)
    y = np.zeros((8, n_classes), np.float32)
    y[np.arange(8), rng.integers(0, n_classes, 8)] = 1.0
    return jmodel, tree, x, y


def _grads_tree(model):
    holder = labeler.LabelerNet(model.num_classes, model.widths, model.depths)
    with torch.no_grad():
        for h, p in zip(holder.parameters(), model.parameters()):
            h.copy_(p.grad)
    return _flat(labeler.params_to_flax(holder))


def _rel_cos(got, want):
    got, want = got.astype(np.float64).ravel(), want.astype(np.float64).ravel()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    return rel, got @ want / (np.linalg.norm(got) * np.linalg.norm(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("size", [32, 64])
def test_train_step_matches_jax(size, seed):
    jmodel, tree, x, y = _step_inputs(seed, size)
    loss, grads, stepped = _jax_step(jmodel)(tree, x, y)
    grads, stepped = _flat(grads), _flat(stepped)

    model, opt = labeler.create_train_state(torch.Generator(), size, LR,
                                            labeler.LabelerNet(16, **BUNDLED))
    model.load_state_dict(labeler.params_from_flax(tree, model))
    got = labeler.train_step(model, opt, torch.from_numpy(x), torch.from_numpy(y))
    assert got.dim() == 0 and not got.requires_grad
    assert abs(float(got) - float(loss)) <= LOSS_ATOL
    for k, g in _grads_tree(model).items():
        rel, cos = _rel_cos(g, grads[k])
        if size == 64:
            assert rel <= GRAD_RTOL and cos >= GRAD_COS, (k, rel, cos)
        elif k.startswith("Dense_"):
            assert rel <= DENSE_RTOL_32 and cos >= DENSE_COS_32, (k, rel, cos)
    for k, p in _flat(labeler.params_to_flax(model)).items():
        assert np.abs(p - stepped[k]).max() <= 2 * LR * 1.001 + 1e-6, k


def test_adamw_matches_optax_on_the_same_gradients():
    """Three updates from the same float32 gradients and parameters."""
    _jmodel, tree, _x, _y = _step_inputs(5, 32)
    rng = np.random.default_rng(5)
    grad_trees = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32) * 0.01,
                               tree) for _ in range(3)]
    grad_trees[1] = jax.tree.map(lambda g: g * 1e-6, grad_trees[1])  # |g| near eps
    tx = optax.adamw(LR)
    want, state = tree, tx.init(tree)
    model, opt = labeler.create_train_state(torch.Generator(), 32, LR,
                                            labeler.LabelerNet(16, **BUNDLED))
    model.load_state_dict(labeler.params_from_flax(tree, model))
    holder = labeler.LabelerNet(16, **BUNDLED)
    for g in grad_trees:
        updates, state = tx.update(g, state, want)
        want = optax.apply_updates(want, updates)
        holder.load_state_dict(labeler.params_from_flax(g, holder))
        for p, h in zip(model.parameters(), holder.parameters()):
            p.grad = h.detach().clone()
        opt.step()
    got, want = _flat(labeler.params_to_flax(model)), _flat(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=ADAMW_RTOL, atol=ADAMW_RTOL * 1e-1,
                                   err_msg=k)


def test_group_norm_gradients_match_flax_where_the_variance_clamps():
    """A group of equal values has E[x²] − E[x]² = 0, where both packages
    clamp the variance at 0 (`torch.clamp` / `jnp.maximum`): the
    gradients through the norm still agree with flax's, and stay finite."""
    import flax.linen as nn

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 4, 16)).astype(np.float32) * 3
    x[0, :, :, :4] = 7.0  # group 0 of image 0: constant
    x[1, :, :, 4:8] = 1000.0 + np.arange(4)  # near-constant and large
    x = np.array(jax.numpy.asarray(x, jax.numpy.bfloat16).astype(np.float32))
    ct = rng.normal(size=x.shape).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    bias = (0.1 * rng.normal(size=16)).astype(np.float32)
    gn = nn.GroupNorm(num_groups=4, dtype=jax.numpy.bfloat16)

    def flax_gn(xx, s, b):
        return gn.apply({"params": {"scale": s, "bias": b}}, xx.astype(jax.numpy.bfloat16))

    want_y, vjp = jax.vjp(flax_gn, x, scale, bias)
    want = [np.asarray(g, np.float32) for g in
            vjp(jax.numpy.asarray(ct, jax.numpy.bfloat16))]
    block = labeler.ConvBlock(16, 16)
    with torch.no_grad():
        block.scale.copy_(torch.from_numpy(scale))
        block.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16).requires_grad_(True)
    y = block._group_norm(xt)
    y.backward(torch.from_numpy(ct).permute(0, 3, 1, 2).to(torch.bfloat16))
    np.testing.assert_allclose(y.detach().float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_y, np.float32), atol=0.02, rtol=0.01)
    got = [xt.grad.float().permute(0, 2, 3, 1).numpy(), block.scale.grad.numpy(),
           block.bias.grad.numpy()]
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        rel, cos = _rel_cos(g, w)
        assert rel <= 0.02 and cos >= 0.999, (rel, cos)


# ---- checkpoints, the JAX recipe's bars, the CLI ----------------------------


def test_port_trained_checkpoint_loads_in_jax(tmp_path):
    cfg = train.TrainConfig(image_size=32, batch_size=16, steps=20, use_device=False, **BUNDLED)
    x, y = train.scene_dataset(32, per_class=8, seed=2)
    tree, model, metrics = train.train(train.array_batches(x, y, cfg.batch_size), train.SCENE_CLASSES,
                                       cfg, eval_set=(x[:12], y[:12]))
    assert set(metrics) == {"final_loss", "eval_top1"} and np.isfinite(metrics["final_loss"])
    _assert_trees_equal(labeler.params_to_flax(model), tree)
    path = tmp_path / "weights.npz"
    checkpoint.save(path, tree, classes=train.SCENE_CLASSES, image_size=32, **BUNDLED)
    jtree, meta = jax_checkpoint.load(path)
    _assert_trees_equal(jtree, tree)
    jmodel = jax_labeler.LabelerNet(num_classes=len(meta["classes"]), widths=tuple(meta["widths"]),
                                    depths=tuple(meta["depths"]))
    probe = np.random.default_rng(3).random((16, 32, 32, 3), dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, v: jax.nn.sigmoid(jmodel.apply({"params": p}, v)))(
        jtree, probe))
    served = labeler.from_flax(*checkpoint.load(path)[:1], len(meta["classes"]), meta["widths"],
                               meta["depths"], "cpu")
    got = labeler.infer_step(served, torch.from_numpy(probe))[0].numpy()
    assert np.abs(got - want).max() <= BAND
    outside = np.abs(want - THRESHOLD) > BAND
    assert np.array_equal((got >= THRESHOLD)[outside], (want >= THRESHOLD)[outside])


def _labels_written(db, entries) -> list[set[str]]:
    return [{r["name"] for r in db.query(
        "SELECT l.name FROM label l JOIN label_on_object lo ON lo.label_id = l.id "
        "WHERE lo.object_id = ?", (e["object_id"],))} for e in entries]


def _actor_labels(labeler_dir, paths, threshold=0.5) -> tuple[list[set[str]], int]:
    """The port's actor on the CPU over `paths`: (label names per image,
    images labelled)."""
    async def run():
        db = LibraryDb(None, memory=True)
        lib = type("Lib", (), {"id": "44444444-4444-4444-4444-444444444444", "db": db})()
        entries = [{"file_path_id": i + 1, "path": p,
                    "object_id": db.insert("object", pub_id=os.urandom(16), kind=5)}
                   for i, p in enumerate(paths)]
        actor = ImageLabeler(str(labeler_dir), device="cpu")
        actor.threshold = threshold
        try:
            await asyncio.wait_for(actor.wait_batch(actor.new_batch(lib, entries)), 300)
            return _labels_written(db, entries), actor.labeled
        finally:
            await actor.shutdown()
            db.close()

    return asyncio.run(run())


def _save_pngs(root, images, names) -> list[str]:
    paths = []
    for arr, name in zip(images, names):
        paths.append(str(root / f"{name}.png"))
        Image.fromarray((arr * 255).astype(np.uint8)).save(paths[-1])
    return paths


def test_train_digits_and_label_semantically(tmp_path):
    """`tests/test_labeler_train.py`'s bar on the port: 120 steps on the
    digit scans reach eval top-1 > 0.7 (chance 0.1), and the port's actor,
    loading the saved checkpoint, names ≥ 70% of 12 held-out digits."""
    cfg = train.TrainConfig(image_size=32, batch_size=64, steps=120, learning_rate=2e-3,
                            use_device=False, **BUNDLED)
    (tr_x, tr_y), (ev_x, ev_y), classes = train.digits_demo_dataset(cfg.image_size)
    tree, _model, metrics = train.train(train.array_batches(tr_x, tr_y, cfg.batch_size), classes,
                                        cfg, eval_set=(ev_x, ev_y))
    assert metrics["eval_top1"] > 0.7, metrics
    checkpoint.save(tmp_path / "labeler" / "weights.npz", tree, classes=classes,
                    image_size=cfg.image_size, widths=cfg.widths, depths=cfg.depths,
                    extra={"metrics": metrics})
    n_check = 12
    paths = _save_pngs(tmp_path, ev_x[:n_check], [f"digit{i}" for i in range(n_check)])
    got, labeled = _actor_labels(tmp_path / "labeler", paths)
    assert labeled == n_check
    want = [classes[int(ev_y[i].argmax())] for i in range(n_check)]
    correct = sum(w in names for w, names in zip(want, got))
    assert correct >= int(0.7 * n_check), (correct, got)


def test_train_small_dataset_does_not_hang(tmp_path):
    """Datasets smaller than the batch size must train, not spin."""
    root = tmp_path / "data"
    for cls in ("red", "blue"):
        (root / cls).mkdir(parents=True)
    for i in range(3):
        Image.new("RGB", (16, 16), (200, 10, 10)).save(root / "red" / f"{i}.png")
        Image.new("RGB", (16, 16), (10, 10, 200)).save(root / "blue" / f"{i}.png")
    cfg = train.TrainConfig(image_size=16, widths=(4, 4, 4, 4, 4), depths=(1, 1, 1, 1),
                            batch_size=32, steps=3, use_device=False, eval_fraction=0.34)
    seen = []
    metrics = train.train_folder(root, tmp_path / "out.npz", cfg,
                                 progress=lambda step, loss: seen.append(step))
    assert "final_loss" in metrics and seen == [0, 2]
    _params, meta = jax_checkpoint.load(tmp_path / "out.npz")
    assert meta["classes"] == ["blue", "red"]
    assert meta["metrics"] == metrics and meta["trained_on"] == os.fspath(root)


def test_train_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    cfg = train.TrainConfig(image_size=16, widths=(4, 4, 4, 4, 4), steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train(iter([]), ["a"], cfg)


def test_make_bundled_build_passes_the_golden_bars(tmp_path):
    """The bundled recipe (1,200 CPU steps) into a scratch directory: the
    manifest pins the artifact, and the artifact passes
    `tests/test_bundled_labeler.py`'s bars through the port's forward: ≥
    80% of 12 digit scans named and every scene kind on ≥ 2 of 3
    held-out renders (seed 987654), at 0.5."""
    manifest = make_bundled.build(tmp_path, device="cpu")
    artifact = tmp_path / make_bundled.ARTIFACT_NAME
    with open(tmp_path / make_bundled.MANIFEST_NAME) as f:
        assert json.load(f) == manifest
    assert manifest["sha256"] == provision.sha256_file(str(artifact))
    assert manifest["bytes"] == os.path.getsize(artifact) and manifest["steps"] == 1200
    assert manifest["classes"] == [f"digit {d}" for d in range(10)] + train.SCENE_CLASSES
    assert manifest["metrics"]["eval_top1"] > 0.9
    tree, meta = checkpoint.load(artifact)
    classes = list(meta["classes"])
    model = labeler.from_flax(tree, len(classes), meta["widths"], meta["depths"], "cpu")

    def named(x: np.ndarray) -> list[set[str]]:
        probs = labeler.infer_step(model, torch.from_numpy(np.ascontiguousarray(x)))[0].numpy()
        return [{classes[j] for j in np.where(row > 0.5)[0]} for row in probs]

    _, (ev_x, ev_y), dclasses = train.digits_demo_dataset(32)
    hits = sum(dclasses[int(ev_y[i].argmax())] in names for i, names in enumerate(named(ev_x[:12])))
    assert hits >= int(0.8 * 12), hits
    rng = np.random.default_rng(987654)
    for kind in train.SCENE_CLASSES:
        got = sum(kind in named(train.render_scene(kind, rng, 32)[None])[0] for _ in range(3))
        assert got >= 2, (kind, got)
    with pytest.raises(ValueError, match="pinned"):
        make_bundled.build(provision.BUNDLED_DIR, steps=1, device="cpu")


def test_cli_train_and_train_demo(tmp_path, capsys):
    data = tmp_path / "data"
    _image_tree(data, per_class=4, size=16, broken=False)
    d = str(tmp_path / "node")
    assert main(["labeler", "train", str(data), "--data-dir", d, "--device", "cpu",
                 "--steps", "3", "--image-size", "16", "--batch-size", "4"]) == 0
    out = capsys.readouterr()
    info = json.loads(out.out)
    assert info["checkpoint"] == os.path.join(d, "image_labeler", "weights.npz")
    assert set(info["metrics"]) == {"final_loss", "eval_top1"}
    assert "step 0/3" in out.err and "step 2/3" in out.err
    tree, meta = jax_checkpoint.load(info["checkpoint"])
    assert meta["classes"] == ["blue", "green", "red"] and meta["image_size"] == 16
    assert meta["widths"] == list(train.TrainConfig().widths)
    assert main(["labeler", "status", "--data-dir", d]) == 0
    status = json.loads(capsys.readouterr().out)
    assert status["enabled"] and status["artifact"]["kind"] == "checkpoint"
    assert status["metrics"] == info["metrics"]

    out_path = str(tmp_path / "demo.npz")
    assert main(["labeler", "train-demo", "--data-dir", d, "--out", out_path, "--device", "cpu",
                 "--steps", "2"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["checkpoint"] == out_path
    _tree, meta = checkpoint.load(out_path)
    assert meta["classes"] == [f"digit {d}" for d in range(10)] and meta["image_size"] == 32
    assert meta["trained_on"] == "sklearn-digits" and meta["metrics"] == info["metrics"]
