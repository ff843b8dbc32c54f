"""Labeler model provisioning: the reference's model-download flow.

Counterpart of `spacedrive_tpu/models/provision.py`. The reference
cannot label until it fetches a versioned YOLOv8 `.onnx` from its CDN
(ref:crates/ai/src/image_labeler/model/yolov8.rs:45-88). Here:

- `install_bundled` installs the in-package offline artifact
  (`models/bundled/labeler_offline.npz`, a byte copy of the JAX
  package's trained LabelerNet checkpoint) after checking it against the
  sha256 pin in `MANIFEST.json`: zero egress;
- `import_artifact` installs a local `.onnx` (any classifier or
  YOLO-family head `models/onnx_runtime.py` executes) or a
  `weights.npz` LabelerNet checkpoint;
- `fetch(url)` downloads an ONNX model and imports it.

Every install is validated before it lands. A checkpoint must load; an
ONNX model is loaded by a probe actor on the caller's device and a
zero-image smoke inference runs through the actor's own inference path,
so a broken file never disables labeling at index time. Class names
ride along in `classes.json` next to the model.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import urllib.request

import torch

# The reference pins its model by version name (yolov8.rs:45-60); the
# official ultralytics release asset is the natural default source.
DEFAULT_MODEL_URL = (
    "https://github.com/ultralytics/assets/releases/download/v8.1.0/yolov8n.onnx"
)
FETCH_TIMEOUT_S = 120.0

BUNDLED_DIR = os.path.join(os.path.dirname(__file__), "bundled")
ARTIFACT = os.path.join(BUNDLED_DIR, "labeler_offline.npz")
MANIFEST = os.path.join(BUNDLED_DIR, "MANIFEST.json")


class ProvisionError(Exception):
    pass


def _validate_onnx(path: str, device: str | torch.device) -> dict:
    """Load + smoke-infer through the real actor path; returns info.
    `path` must be named model.onnx: the probe actor resolves it from
    its directory exactly like a provisioned node would."""
    import numpy as np

    from .labeler_actor import ImageLabeler

    actor = ImageLabeler(os.path.dirname(path), device=device)
    if not actor._ensure_model():
        raise ProvisionError("model failed to load")
    probs = actor._infer_chunk(
        np.zeros((1, actor.image_size, actor.image_size, 3), np.float32)
    )
    if probs.ndim != 2 or probs.shape[1] != len(actor.classes):
        raise ProvisionError(
            f"smoke inference returned {probs.shape}, expected "
            f"[B, {len(actor.classes)}]"
        )
    return {
        "classes": len(actor.classes),
        "class_names": list(actor.classes),
        "image_size": actor.image_size,
        "batch_size": actor.batch_size,
    }


def _validate_checkpoint(path: str) -> dict:
    from . import checkpoint

    _params, meta = checkpoint.load(path)
    return {
        "classes": len(meta["classes"]),
        "image_size": meta["image_size"],
    }


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _check_digest(path: str, sha256: str) -> None:
    actual = sha256_file(path)
    if actual.lower() != sha256.lower():
        raise ProvisionError(
            f"sha256 mismatch: artifact is {actual}, "
            f"pinned {sha256.lower()}; refusing to install"
        )


def import_artifact(
    src: str, labeler_dir: str, classes: list[str] | None = None,
    sha256: str | None = None, device: str | torch.device = "cuda",
) -> dict:
    """Validate `src` (.onnx or .npz) and install it as THE labeler
    artifact. Returns an info dict (kind, path, classes, …). A `sha256`
    pin is checked before any validation or install; an ONNX model is
    validated on `device`."""
    if sha256 is not None:
        _check_digest(src, sha256)
    os.makedirs(labeler_dir, exist_ok=True)
    if src.endswith(".npz"):
        if classes:
            raise ProvisionError(
                "--classes applies to ONNX imports; a checkpoint embeds "
                "its own class names"
            )
        info = _validate_checkpoint(src)
        dest = os.path.join(labeler_dir, "weights.npz")
        if os.path.abspath(src) != os.path.abspath(dest):
            shutil.copyfile(src, dest)
        # resolve_artifact prefers model.onnx: a stale one would
        # silently shadow the checkpoint just provisioned
        for stale in ("model.onnx", "classes.json"):
            p = os.path.join(labeler_dir, stale)
            if os.path.exists(p):
                os.unlink(p)
        return {"kind": "checkpoint", "path": dest, **info}

    # ONNX: validate from a scratch dir so a bad file never lands
    with tempfile.TemporaryDirectory(prefix="sd-provision-") as tmp:
        cand = os.path.join(tmp, "model.onnx")
        shutil.copyfile(src, cand)
        if classes:
            with open(os.path.join(tmp, "classes.json"), "w") as f:
                json.dump(classes, f)
        info = _validate_onnx(cand, device)
        if classes and len(classes) != info["classes"]:
            raise ProvisionError(
                f"model has {info['classes']} classes but --classes "
                f"names {len(classes)}"
            )
        dest = os.path.join(labeler_dir, "model.onnx")
        shutil.move(cand, dest)
        cls_dest = os.path.join(labeler_dir, "classes.json")
        if classes:
            with open(cls_dest, "w") as f:
                json.dump(classes, f)
        elif os.path.exists(cls_dest):
            os.unlink(cls_dest)  # stale names from a previous model
    return {"kind": "onnx", "path": dest, **info}


def install_bundled(labeler_dir: str) -> dict:
    """Install the in-package offline artifact (`models/bundled/`), a
    trained LabelerNet checkpoint, verified against its MANIFEST.json
    sha256 pin. Zero egress: the air-gapped answer to the reference's
    CDN download (yolov8.rs:45-88)."""
    if not (os.path.exists(ARTIFACT) and os.path.exists(MANIFEST)):
        raise ProvisionError("bundled artifact missing from the package")
    with open(MANIFEST) as f:
        manifest = json.load(f)
    info = import_artifact(ARTIFACT, labeler_dir, sha256=manifest["sha256"])
    info["bundled"] = {
        "sha256": manifest["sha256"],
        "metrics": manifest.get("metrics", {}),
        "classes": manifest.get("classes", []),
    }
    return info


def fetch(url: str, labeler_dir: str, classes: list[str] | None = None,
          sha256: str | None = None, device: str | torch.device = "cuda") -> dict:
    """Download an ONNX model (the reference's provisioning path) and
    install it via `import_artifact`.

    `sha256` pins the artifact's digest: the download is rejected before
    validation if it does not match, mirroring the reference's
    version-pinned CDN flow. Smoke inference alone proves the file
    works, not that it is the file you meant to install: pin digests
    for any unauthenticated mirror."""
    os.makedirs(labeler_dir, exist_ok=True)
    tmp = tempfile.NamedTemporaryFile(suffix=".onnx", delete=False)
    try:
        try:
            with urllib.request.urlopen(url, timeout=FETCH_TIMEOUT_S) as resp:
                shutil.copyfileobj(resp, tmp)
            tmp.close()
        except Exception as e:  # noqa: BLE001 - network envs vary
            raise ProvisionError(
                f"download failed ({e}); offline deployments can provision "
                "with `labeler provision --bundled` or `labeler provision "
                "--from <model.onnx>`"
            ) from e
        return import_artifact(tmp.name, labeler_dir, classes=classes,
                               sha256=sha256, device=device)
    finally:
        tmp.close()
        os.unlink(tmp.name)
