"""The port's labeler actor, provisioning and labelled library scan
against the JAX package.

The JAX side is held through main-thread calls only (`LabelerNet.apply`
jitted, `OnnxModel`, the JAX package's still-image decode): its actor's
worker thread is never run in this process. Every comparison feeds both
sides the same decoded images: the JAX package's `format_image`, then
PIL's `convert("RGB").resize((s, s))` and /255, as both actors decode.

Tolerance: LabelerNet runs in bf16 on both sides, so a label may differ
only where the JAX probability lies within 0.05 of the 0.35 threshold
(`tests/test_torch_labeler.py` states the bound); ONNX graphs run in
float32, so their probabilities agree within 1e-5.
"""

import asyncio
import json
import os
import sqlite3
import urllib.request

import jax
import msgpack
import numpy as np
import pytest
from PIL import Image

from spacedrive_tpu.models import checkpoint as jax_checkpoint
from spacedrive_tpu.models import labeler as jax_labeler
from spacedrive_tpu.models import onnx_runtime as jax_runtime
from spacedrive_tpu.models.train import SCENE_CLASSES, digits_demo_dataset, render_scene
from spacedrive_tpu.object.media.images import format_image as jax_format_image
from spacedrive_tpu_torch.cli import main
from spacedrive_tpu_torch.db.database import LibraryDb
from spacedrive_tpu_torch.models import labeler_actor, provision
from spacedrive_tpu_torch.models import onnx_proto as P
from spacedrive_tpu_torch.models.labeler_actor import RESUME_FILE, ImageLabeler
from spacedrive_tpu_torch.node.node import Node

THRESHOLD = 0.35
BAND = 0.05


class FakeLib:
    def __init__(self, lib_id: str):
        self.id = lib_id
        self.db = LibraryDb(None, memory=True)


def _decode(path: str, size: int) -> np.ndarray:
    rgba = jax_format_image(path)
    img = Image.fromarray(rgba).convert("RGB").resize((size, size))
    return np.asarray(img, np.float32) / 255.0


def _jax_bundled_probs(paths: list[str]) -> tuple[np.ndarray, list[str]]:
    params, meta = jax_checkpoint.load(provision.ARTIFACT)
    model = jax_labeler.LabelerNet(num_classes=len(meta["classes"]),
                                   widths=tuple(meta["widths"]), depths=tuple(meta["depths"]))
    x = np.stack([_decode(p, meta["image_size"]) for p in paths])
    probs = jax.jit(lambda p, v: jax.nn.sigmoid(model.apply({"params": p}, v)))(params, x)
    return np.asarray(probs), list(meta["classes"])


def assert_rows_match(got: list[set[str]], probs: np.ndarray, classes: list[str]) -> None:
    """Each object's label names equal the JAX forward's decisions, but
    for decisions within the band around the threshold."""
    assert len(got) == len(probs)
    for names, row in zip(got, probs):
        for name, p in zip(classes, row):
            if abs(p - THRESHOLD) > BAND:
                assert (name in names) == (p >= THRESHOLD), (name, p, names)
        assert names <= set(classes)


def _labels_of(db, object_id) -> set[str]:
    return {r["name"] for r in db.query(
        "SELECT l.name FROM label l JOIN label_on_object lo ON lo.label_id = l.id "
        "WHERE lo.object_id = ?", (object_id,))}


def _golden_images(root) -> list[str]:
    """12 digit scans and 3 held-out renders of each scene class, the
    JAX golden test's images, plus 4 seeded noise images."""
    os.makedirs(root, exist_ok=True)
    _, (ev_x, _ev_y), _ = digits_demo_dataset(32)
    paths = []
    for i in range(12):
        p = os.path.join(root, f"digit{i}.png")
        Image.fromarray((ev_x[i] * 255).astype(np.uint8)).save(p)
        paths.append(p)
    rng = np.random.default_rng(987654)
    for kind in SCENE_CLASSES:
        for rep in range(3):
            p = os.path.join(root, f"{kind.replace(' ', '_')}{rep}.png")
            Image.fromarray((render_scene(kind, rng, 32) * 255).astype(np.uint8)).save(p)
            paths.append(p)
    for i in range(4):
        p = os.path.join(root, f"noise{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (40 + 9 * i, 57, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


@pytest.fixture
def no_network(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("provisioning attempted a download")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)


async def test_bundled_actor_rows_equal_the_jax_forward(tmp_path, no_network):
    labeler_dir = str(tmp_path / "labeler")
    info = provision.install_bundled(labeler_dir)
    assert info["kind"] == "checkpoint" and info["classes"] == 16
    paths = _golden_images(str(tmp_path / "pics"))
    lib = FakeLib("55555555-5555-5555-5555-555555555555")
    entries = [{"file_path_id": i + 1,
                "object_id": lib.db.insert("object", pub_id=os.urandom(16), kind=5), "path": p}
               for i, p in enumerate(paths)]
    actor = ImageLabeler(labeler_dir, device="cpu")
    batch_id = actor.new_batch(lib, entries)
    await asyncio.wait_for(actor.wait_batch(batch_id), 120)
    assert actor.labeled == len(entries) and actor.errors == 0
    assert actor.forwards == -(-len(entries) // labeler_actor.DEFAULT_BATCH_SIZE)
    assert set(actor.stage_seconds) == {"decode", "forward", "write"}
    probs, classes = _jax_bundled_probs(paths)
    assert actor.classes == classes and actor.image_size == 32
    assert_rows_match([_labels_of(lib.db, e["object_id"]) for e in entries], probs, classes)
    # a relabel is idempotent: the upserts add no row
    rows = lib.db.count("label_on_object")
    await asyncio.wait_for(actor.wait_batch(actor.new_batch(lib, entries)), 120)
    assert lib.db.count("label_on_object") == rows and rows > 0
    assert not os.path.exists(os.path.join(labeler_dir, RESUME_FILE))
    await actor.shutdown()


async def test_without_artifact_batches_complete_without_rows(tmp_path, caplog):
    lib = FakeLib("33333333-3333-3333-3333-333333333333")
    oid = lib.db.insert("object", pub_id=os.urandom(16), kind=5)
    img = tmp_path / "x.png"
    Image.new("RGB", (32, 32), (10, 20, 30)).save(img)
    actor = ImageLabeler(str(tmp_path / "labeler"), device="cpu")
    assert actor.resolve_artifact() is None
    for _ in range(2):
        batch_id = actor.new_batch(lib, [{"file_path_id": 1, "object_id": oid, "path": str(img)}])
        await asyncio.wait_for(actor.wait_batch(batch_id), 60)
    assert (actor.labeled, actor.skipped, actor.forwards) == (0, 2, 0)
    assert lib.db.count("label") == 0 and lib.db.count("label_on_object") == 0
    assert sum("image labeler disabled" in r.message for r in caplog.records) == 1  # warned once
    assert actor.new_batch(lib, [{"file_path_id": 2, "object_id": None, "path": "y"}]) == 0
    await actor.shutdown()


async def test_resume_file_is_the_jax_format_and_resumes(tmp_path):
    """Batches pending at shutdown persist as `msgpack.packb` of the JAX
    actor's list of {library_id, entries}; the next actor re-queues them
    when their library registers, and a file the JAX format wrote loads."""
    lib = FakeLib("77777777-7777-7777-7777-777777777777")
    entries = [{"file_path_id": 1, "object_id": 5, "path": "/p/ä.png"},
               {"file_path_id": 70000, "object_id": 2 ** 40, "path": "/q.jpg"}]
    d = str(tmp_path / "labeler")
    actor = ImageLabeler(d, device="cpu")
    actor._stopped = True  # no worker: the batch stays pending
    actor.new_batch(lib, entries)
    actor.new_batch(lib, entries[:1])
    want = [{"library_id": lib.id, "entries": entries},
            {"library_id": lib.id, "entries": entries[:1]}]
    with open(os.path.join(d, RESUME_FILE), "rb") as f:
        assert f.read() == msgpack.packb(want, use_bin_type=True)

    other = {"library_id": "88888888-8888-8888-8888-888888888888", "entries": entries}
    with open(os.path.join(d, RESUME_FILE), "wb") as f:
        f.write(msgpack.packb(want[:1] + [other], use_bin_type=True))
    resumed = ImageLabeler(d, device="cpu")
    assert resumed._resume_raw == want[:1] + [other]
    resumed.register_library(lib)
    assert [b.entries for b in resumed._queue] == [entries]
    for b in list(resumed._queue):
        await asyncio.wait_for(resumed.wait_batch(b.id), 60)
    assert resumed.skipped == 2  # no artifact: completed without rows
    with open(os.path.join(d, RESUME_FILE), "rb") as f:  # the unregistered library's stays
        assert msgpack.unpackb(f.read(), raw=False) == [other]
    await resumed.shutdown()


def _onnx_classifier(n_classes=6, batch=2, size=32) -> bytes:
    rng = np.random.default_rng(0)
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)  # noqa: E731
    nodes = [
        P.make_node("Conv", ["x", "w", "b"], ["c"], strides=[2, 2], pads=[1, 1, 1, 1],
                    kernel_shape=[3, 3]),
        P.make_node("Relu", ["c"], ["r"]),
        P.make_node("GlobalAveragePool", ["r"], ["gap"]),
        P.make_node("Flatten", ["gap"], ["f"]),
        P.make_node("Gemm", ["f", "fw", "fb"], ["out"], transB=1),
    ]
    inits = {"w": f(4, 3, 3, 3), "b": f(4), "fw": f(n_classes, 4), "fb": f(n_classes)}
    return P.encode_model(P.make_model(nodes, [P.make_value_info("x", (batch, 3, size, size))],
                                       [P.make_value_info("out", (batch, n_classes))], inits))


def _yolo_head(out_shape) -> bytes:
    """x [1,3,8,8] → Flatten → Gemm → Sigmoid → Reshape to a YOLO layout."""
    n = int(np.prod(out_shape[1:]))
    w = np.random.default_rng(0).normal(size=(n, 192)).astype(np.float32) * 0.1
    nodes = [
        P.make_node("Flatten", ["x"], ["f"]),
        P.make_node("Gemm", ["f", "w"], ["g"], transB=1),
        P.make_node("Sigmoid", ["g"], ["s"]),
        P.make_node("Reshape", ["s", "shape"], ["out"]),
    ]
    return P.encode_model(P.make_model(
        nodes, [P.make_value_info("x", (1, 3, 8, 8))], [P.make_value_info("out", out_shape)],
        {"w": w, "shape": np.asarray(out_shape, np.int64)}))


def _jax_onnx_probs(buf: bytes, images: np.ndarray) -> np.ndarray:
    """The JAX actor's `_load_onnx.run`, on the main thread."""
    out = np.asarray(jax_runtime.load(buf)(images.transpose(0, 3, 1, 2))[0])
    if out.ndim == 3:
        if out.shape[1] < out.shape[2]:
            return out[:, 4:, :].max(-1)
        return (out[:, :, 4:5] * out[:, :, 5:]).max(1)
    return 1.0 / (1.0 + np.exp(-out))


async def test_onnx_artifact_with_classes_json(tmp_path):
    d = tmp_path / "labeler"
    d.mkdir()
    buf = _onnx_classifier()
    (d / "model.onnx").write_bytes(buf)
    names = [f"color {i}" for i in range(6)]
    (d / "classes.json").write_text(json.dumps(names))
    paths = []
    for i, rgb in enumerate([(200, 60, 90), (10, 240, 30), (5, 5, 5)]):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.new("RGB", (48 + i, 40), rgb).save(paths[-1])
    lib = FakeLib("55555555-5555-5555-5555-555555555555")
    entries = [{"file_path_id": i, "object_id": lib.db.insert("object", pub_id=os.urandom(16),
                                                              kind=5), "path": p}
               for i, p in enumerate(paths)]
    actor = ImageLabeler(str(d), device="cpu")
    assert actor.resolve_artifact()[0] == "onnx"
    await asyncio.wait_for(actor.wait_batch(actor.new_batch(lib, entries)), 60)
    assert (actor.image_size, actor.batch_size) == (32, 2)  # from the ONNX input shape
    assert actor.classes == names and actor.labeled == 3 and actor.forwards == 2
    images = np.stack([_decode(p, 32) for p in paths])
    want = np.concatenate([_jax_onnx_probs(buf, images[:2]),
                           _jax_onnx_probs(buf, np.concatenate([images[2:], images[:1] * 0]))[:1]])
    np.testing.assert_allclose(actor._infer_chunk(images[:2]), want[:2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(actor._infer_chunk(images[2:]), want[2:], rtol=1e-5, atol=1e-6)
    for e, row in zip(entries, want):
        assert _labels_of(lib.db, e["object_id"]) == {n for n, p in zip(names, row)
                                                      if p >= THRESHOLD}
    await actor.shutdown()
    (d / "classes.json").write_text(json.dumps(["too", "few"]))
    fresh = ImageLabeler(str(d), device="cpu")  # names that do not fit are ignored
    assert fresh._ensure_model() and fresh.classes == [f"class {i}" for i in range(6)]


@pytest.mark.parametrize("out_shape,n_classes", [((1, 14, 50), 10), ((1, 50, 15), 10)])
def test_yolo_layouts_match_the_jax_actor(tmp_path, out_shape, n_classes):
    """v8 [B, 4+C, anchors] → best anchor of each class; v5 [B, anchors,
    5+C] → best anchor of obj × cls; the class count from the head."""
    buf = _yolo_head(out_shape)
    (tmp_path / "model.onnx").write_bytes(buf)
    actor = ImageLabeler(str(tmp_path), device="cpu")
    assert actor._ensure_model()
    assert actor.classes == [f"class {i}" for i in range(n_classes)]
    assert (actor.image_size, actor.batch_size) == (8, 1)
    x = np.random.default_rng(1).random((1, 8, 8, 3), dtype=np.float32)
    got = actor._infer_chunk(x)
    assert got.shape == (1, n_classes) and np.all((got >= 0) & (got <= 1))
    np.testing.assert_allclose(got, _jax_onnx_probs(buf, x), rtol=1e-5, atol=1e-6)


def test_provision_bundled_is_air_gapped_and_pinned(tmp_path, monkeypatch, no_network):
    d = tmp_path / "labeler"
    d.mkdir()
    (d / "model.onnx").write_bytes(b"stale")  # would shadow the checkpoint
    (d / "classes.json").write_text("[]")
    info = provision.install_bundled(str(d))
    assert info["bundled"]["sha256"] == provision.sha256_file(str(d / "weights.npz"))
    assert sorted(os.listdir(d)) == ["weights.npz"]
    tampered = tmp_path / "MANIFEST.json"
    manifest = json.loads(open(provision.MANIFEST).read())
    tampered.write_text(json.dumps({**manifest, "sha256": "0" * 64}))
    monkeypatch.setattr(provision, "MANIFEST", str(tampered))
    with pytest.raises(provision.ProvisionError, match="sha256 mismatch"):
        provision.install_bundled(str(tmp_path / "other"))
    assert not os.path.exists(tmp_path / "other" / "weights.npz")


def test_provision_rejects_garbage_and_mismatched_classes(tmp_path):
    bad = tmp_path / "model.onnx"
    bad.write_bytes(b"not an onnx file")
    with pytest.raises(Exception):
        provision.import_artifact(str(bad), str(tmp_path / "dir"), device="cpu")
    assert not os.path.exists(tmp_path / "dir" / "model.onnx")  # a bad file never lands
    good = tmp_path / "six.onnx"
    good.write_bytes(_onnx_classifier())
    with pytest.raises(provision.ProvisionError, match="--classes names 2"):
        provision.import_artifact(str(good), str(tmp_path / "dir2"), classes=["a", "b"],
                                  device="cpu")
    assert not os.path.exists(tmp_path / "dir2" / "model.onnx")
    with pytest.raises(provision.ProvisionError, match="embeds"):
        provision.import_artifact("whatever.npz", str(tmp_path / "dir3"), classes=["a"])
    info = provision.import_artifact(str(good), str(tmp_path / "dir4"), device="cpu",
                                     classes=list("abcdef"))
    assert info["kind"] == "onnx" and info["class_names"] == list("abcdef")
    assert json.loads((tmp_path / "dir4" / "classes.json").read_text()) == list("abcdef")
    # a checkpoint import replaces the ONNX model and its names
    provision.import_artifact(provision.ARTIFACT, str(tmp_path / "dir4"))
    assert sorted(os.listdir(tmp_path / "dir4")) == ["weights.npz"]


def test_fetch_with_a_sha256_pin(tmp_path):
    """The pin gates the install before validation; a matching pin lets
    the file through to the validator; a file:// URL stands in for the
    network; a failed download says how to provision offline."""
    src = tmp_path / "artifact.onnx"
    src.write_bytes(b"definitely not the pinned bytes")
    url = "file://" + str(src)
    with pytest.raises(provision.ProvisionError, match="sha256 mismatch"):
        provision.fetch(url, str(tmp_path / "dir"), sha256="ab" * 32, device="cpu")
    assert not os.path.exists(tmp_path / "dir" / "model.onnx")
    pin = provision.sha256_file(str(src)).upper()  # case-insensitive
    with pytest.raises(Exception) as exc:
        provision.fetch(url, str(tmp_path / "dir"), sha256=pin, device="cpu")
    assert "sha256 mismatch" not in str(exc.value)
    with pytest.raises(provision.ProvisionError, match="sha256 mismatch"):
        provision.import_artifact(str(src), str(tmp_path / "dir"), sha256="cd" * 32)
    with pytest.raises(provision.ProvisionError, match="offline deployments"):
        provision.fetch("file://" + str(tmp_path / "missing.onnx"), str(tmp_path / "dir"))
    good = tmp_path / "good.onnx"
    good.write_bytes(_onnx_classifier())
    info = provision.fetch("file://" + str(good), str(tmp_path / "dir"), device="cpu",
                           sha256=provision.sha256_file(str(good)))
    assert info["kind"] == "onnx" and info["classes"] == 6
    assert (tmp_path / "dir" / "model.onnx").read_bytes() == good.read_bytes()


def test_cli_provision_and_status(tmp_path, capsys, no_network):
    data_dir = str(tmp_path / "node")
    assert main(["labeler", "status", "--data-dir", data_dir]) == 0
    assert json.loads(capsys.readouterr().out) == {"artifact": None, "enabled": False}
    assert main(["labeler", "provision", "--bundled", "--from", "x.onnx",
                 "--data-dir", data_dir]) == 1
    assert "cannot combine" in json.loads(capsys.readouterr().out)["error"]
    assert main(["labeler", "provision", "--bundled", "--data-dir", data_dir]) == 0
    assert json.loads(capsys.readouterr().out)["kind"] == "checkpoint"
    assert main(["labeler", "status", "--data-dir", data_dir]) == 0
    status = json.loads(capsys.readouterr().out)
    assert status["enabled"] and status["artifact"]["kind"] == "checkpoint"
    assert status["classes"] == 16 and status["image_size"] == 32
    onnx = tmp_path / "m.onnx"
    onnx.write_bytes(_onnx_classifier())
    names = tmp_path / "names.txt"
    names.write_text("\n".join("abcdef") + "\n")
    assert main(["labeler", "provision", "--from", str(onnx), "--classes", str(names),
                 "--device", "cpu", "--data-dir", data_dir]) == 0
    assert json.loads(capsys.readouterr().out)["class_names"] == list("abcdef")
    assert main(["labeler", "status", "--data-dir", data_dir]) == 0
    assert json.loads(capsys.readouterr().out)["artifact"]["kind"] == "onnx"


def test_labeler_runs_on_the_node_device_and_defaults_to_cuda(tmp_path):
    assert ImageLabeler(str(tmp_path / "a")).device.type == "cuda"
    node = Node(str(tmp_path / "n"))
    assert node.image_labeler.device == node.device and node.device.type == "cuda"
    assert Node(str(tmp_path / "m"), device="cpu", with_labeler=False).image_labeler is None


def _label_rows(data_dir: str) -> dict[str, set[str]]:
    db_path = next(os.path.join(data_dir, "libraries", f)
                   for f in os.listdir(os.path.join(data_dir, "libraries")) if f.endswith(".db"))
    conn = sqlite3.connect(db_path)
    try:
        rows = conn.execute(
            "SELECT fp.name, fp.extension, l.name FROM file_path fp "
            "JOIN label_on_object lo ON lo.object_id = fp.object_id "
            "JOIN label l ON l.id = lo.label_id WHERE fp.is_dir = 0").fetchall()
    finally:
        conn.close()
    got: dict[str, set[str]] = {}
    for name, ext, label in rows:
        got.setdefault(f"{name}.{ext}", set()).add(label)
    return got


def test_index_library_with_the_bundled_model(tmp_path, capsys, no_network):
    """`labeler provision --bundled`, then `index --library` on the CPU:
    every image's label rows equal the JAX forward's decisions on the
    same files (outside the band); a rescan relabels every image and
    adds no row; the label filter of `search.paths` returns exactly a
    label's files; the CLI's search runs without a labeler."""
    data_dir = str(tmp_path / "node")
    corpus = tmp_path / "pics"
    paths = _golden_images(str(corpus))
    (corpus / "notes.txt").write_text("not an image")
    assert main(["labeler", "provision", "--bundled", "--data-dir", data_dir]) == 0
    summaries = []
    for _ in range(2):
        capsys.readouterr()
        assert main(["index", str(corpus), "--data-dir", data_dir, "--library", "L",
                     "--device", "cpu", "--no-p2p"]) == 0
        summaries.append(json.loads(capsys.readouterr().out))
        if not summaries[1:]:
            first = _label_rows(data_dir)
    assert [s["labeled"] for s in summaries] == [len(paths), len(paths)]
    assert _label_rows(data_dir) == first
    probs, classes = _jax_bundled_probs(paths)
    assert_rows_match([first.get(os.path.basename(p), set()) for p in paths], probs, classes)

    from spacedrive_tpu_torch.api.search import search_paths
    from spacedrive_tpu_torch.node.library import Libraries

    libs = Libraries(data_dir)
    lib = libs.load_all()[0]
    try:
        name = max(classes, key=lambda c: sum(c in v for v in first.values()))
        lid = lib.db.find_one("label", name=name)["id"]
        out = search_paths(lib, {"filter": {"labels": [lid]}, "take": 100})
        assert sorted(f"{n['name']}.{n['extension']}" for n in out["nodes"]) == \
            sorted(f for f, v in first.items() if name in v)
    finally:
        lib.close()
    assert main(["search", "digit", "--data-dir", data_dir, "--library", "L",
                 "--device", "cpu"]) == 0
    assert not os.path.exists(os.path.join(data_dir, "image_labeler", RESUME_FILE))
