"""Build an offline labeler artifact: the bundled checkpoint's recipe.

Counterpart of `spacedrive_tpu/models/make_bundled.py`. The reference
cannot label anything until it downloads YOLOv8 from a CDN
(ref:crates/ai/src/image_labeler/model/yolov8.rs:45-88). The bundled
artifact is a LabelerNet trained on two corpora that need no network:
scikit-learn's in-package digit scans (1,797 real 8×8 images) and the
procedurally rendered scene corpus (`train.SCENE_CLASSES`), 32², widths
(8, 16, 32, 32, 32), depths (1, 1, 1, 1), batch 64, seed 0.

    python -m spacedrive_tpu_torch.models.make_bundled OUT_DIR [--device cuda|cpu]

trains 1,200 steps and writes `labeler_offline.npz` and its
`MANIFEST.json` (sha256 pin, size, classes, metrics, provenance) into
OUT_DIR, never into the package's own `models/bundled/`: that
directory is a byte copy of the JAX package's artifact, pinned to the
JAX manifest.
"""

from __future__ import annotations

import argparse
import json
import os

from .provision import BUNDLED_DIR, sha256_file

ARTIFACT_NAME = "labeler_offline.npz"
MANIFEST_NAME = "MANIFEST.json"


def build(out_dir: str | os.PathLike, steps: int = 1200, device: str = "cuda") -> dict:
    """Train the bundled recipe for `steps` steps on `device` and write
    the artifact and its manifest into `out_dir`; returns the manifest."""
    from . import checkpoint
    from .train import TrainConfig, array_batches, bundled_dataset, train

    out_dir = os.fspath(out_dir)
    if os.path.realpath(out_dir) == os.path.realpath(BUNDLED_DIR):
        raise ValueError(f"{out_dir} holds the shipped, pinned artifact; build elsewhere")
    cfg = TrainConfig(
        image_size=32, widths=(8, 16, 32, 32, 32), depths=(1, 1, 1, 1),
        batch_size=64, steps=steps, use_device=device != "cpu", seed=0,
    )
    (tr_x, tr_y), (ev_x, ev_y), classes = bundled_dataset(cfg.image_size)
    params, _model, metrics = train(
        array_batches(tr_x, tr_y, cfg.batch_size, seed=cfg.seed),
        classes, cfg, eval_set=(ev_x, ev_y),
        progress=lambda step, loss: print(f"step {step}  loss {loss:.4f}", flush=True),
    )
    artifact = os.path.join(out_dir, ARTIFACT_NAME)
    checkpoint.save(
        artifact, params, classes=classes, image_size=cfg.image_size,
        widths=cfg.widths, depths=cfg.depths,
        extra={"metrics": metrics,
               "trained_on": "sklearn digits (1,797 8x8 scans) + "
                             "procedural scene corpus (train.py)"},
    )
    manifest = {
        "artifact": ARTIFACT_NAME,
        "sha256": sha256_file(artifact),
        "bytes": os.path.getsize(artifact),
        "classes": classes,
        "image_size": cfg.image_size,
        "steps": steps,
        "metrics": metrics,
        "rebuild": "python -m spacedrive_tpu_torch.models.make_bundled <out_dir>",
    }
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m spacedrive_tpu_torch.models.make_bundled")
    parser.add_argument("out_dir")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    print(json.dumps(build(args.out_dir, device=args.device), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
