"""Labeler training: make a checkpoint the labeler actor loads.

Owned copy of `spacedrive_tpu/models/train.py`. The reference ships
inference only (it downloads a pretrained YOLOv8,
ref:crates/ai/src/image_labeler/model/yolov8.rs:37-41); offline, that
download never happens and labeling stays off. Training LabelerNet on a
labelled image folder and saving a checkpoint makes labeling real
without a download.

Dataset layout: `root/<class_name>/*.jpg|png|…`, one folder per class.
`python -m spacedrive_tpu_torch labeler train <root>` runs `train_folder`.

The data streams (`scan_folder_dataset`, `_folder_batches`,
`array_batches`, `digits_demo_dataset`, the scene corpus and
`bundled_dataset`) are numpy and PIL, and given the same seed yield the
JAX package's arrays in its order, bit for bit. `train` runs
`labeler.train_step` (torch autograd and AdamW with optax.adamw's
values) on "cuda", or on "cpu" when `TrainConfig.use_device` is False,
and returns the flax parameter tree, so the checkpoint loads in either
package. `digits_demo_dataset` imports scikit-learn (its in-package
digits scans), lazily: nothing else here needs it.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from . import checkpoint
from . import labeler as labeler_model

logger = logging.getLogger(__name__)

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp", ".gif", ".tif", ".tiff")


@dataclass
class TrainConfig:
    image_size: int = 96
    widths: tuple[int, ...] = (16, 32, 64, 128, 128)
    depths: tuple[int, ...] = (1, 1, 1, 1)
    batch_size: int = 32
    steps: int = 600
    learning_rate: float = 1e-3
    seed: int = 0
    eval_fraction: float = 0.1
    use_device: bool = True


def scan_folder_dataset(root: str | os.PathLike) -> tuple[list[tuple[str, int]], list[str]]:
    """folder-per-class layout → ([(path, class_idx)], class_names)."""
    root = os.fspath(root)
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)) and not d.startswith(".")
    )
    if not classes:
        raise ValueError(f"{root}: no class folders found")
    samples: list[tuple[str, int]] = []
    for idx, name in enumerate(classes):
        cdir = os.path.join(root, name)
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith(IMAGE_EXTS):
                samples.append((os.path.join(cdir, fn), idx))
    if not samples:
        raise ValueError(f"{root}: class folders contain no images")
    return samples, classes


def _decode(path: str, image_size: int) -> np.ndarray | None:
    from PIL import Image

    try:
        with Image.open(path) as img:
            img = img.convert("RGB").resize((image_size, image_size))
            return np.asarray(img, np.float32) / 255.0
    except Exception:
        logger.warning("train: failed to decode %s", path)
        return None


def _folder_batches(
    samples: list[tuple[str, int]], n_classes: int, cfg: TrainConfig,
    rng: np.random.Generator,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Infinite shuffled FIXED-SHAPE batch stream from disk.

    Every yielded batch has exactly `bs` rows (failed decodes are
    backfilled by repeating rows), the JAX package's stream bit for bit:
    its jitted step compiles once for one shape, and here the card's
    convolutions keep the algorithms chosen for that shape. Decoded
    images are cached as uint8 under a ~512 MB budget; beyond that,
    re-decode.
    """
    bs = min(cfg.batch_size, len(samples))
    cache: dict[str, np.ndarray | None] = {}
    cache_cap = max(1, (512 << 20) // (cfg.image_size * cfg.image_size * 3))

    def fetch(path: str) -> np.ndarray | None:
        if path in cache:
            hit = cache[path]
            return None if hit is None else hit.astype(np.float32) / 255.0
        arr = _decode(path, cfg.image_size)
        if len(cache) < cache_cap:
            cache[path] = None if arr is None else (
                (arr * 255.0).astype(np.uint8)
            )
        return arr

    while True:
        order = rng.permutation(len(samples))
        for off in range(0, max(1, len(order) - bs + 1), bs):
            idxs = order[off:off + bs]
            images, labels = [], []
            for i in idxs:
                path, cls = samples[i]
                arr = fetch(path)
                if arr is None:
                    continue
                images.append(arr)
                row = np.zeros(n_classes, np.float32)
                row[cls] = 1.0
                labels.append(row)
            if not images:
                continue
            while len(images) < bs:  # backfill to a fixed shape
                j = len(images) % len(labels)
                images.append(images[j])
                labels.append(labels[j])
            yield np.stack(images), np.stack(labels)


def _device(use_device: bool) -> torch.device:
    if not use_device:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("training on the device needs CUDA; set use_device=False for the CPU")
    return torch.device("cuda")


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on `device`. To the card it goes through pinned
    memory without blocking: a copy from pageable memory would wait for
    the steps already queued, a host stall each step."""
    tensor = torch.from_numpy(np.ascontiguousarray(array, np.float32))
    if device.type != "cuda":
        return tensor
    return tensor.pin_memory().to(device, non_blocking=True)


EVAL_BATCH = 256


def train(
    batches: Iterator[tuple[np.ndarray, np.ndarray]],
    classes: Sequence[str],
    cfg: TrainConfig,
    *,
    eval_set: tuple[np.ndarray, np.ndarray] | None = None,
    progress: Callable[[int, float], None] | None = None,
) -> tuple[dict, labeler_model.LabelerNet, dict[str, float]]:
    """Run `cfg.steps` optimizer steps on "cuda" (`cfg.use_device`) or
    "cpu"; returns (the flax parameter tree, the model, metrics).

    The loss is read on the host only where `progress` reports it (every
    20 steps and the last), so the device runs ahead of the host
    otherwise. `metrics` holds `final_loss`, and `eval_top1` (argmax of
    the probabilities against the label rows' argmax, under no_grad)
    when there is an eval set."""
    device = _device(cfg.use_device)
    model = labeler_model.LabelerNet(
        num_classes=len(classes), widths=cfg.widths, depths=cfg.depths
    ).to(device)
    model, optimizer = labeler_model.create_train_state(
        torch.Generator().manual_seed(cfg.seed), image_size=cfg.image_size,
        learning_rate=cfg.learning_rate, model=model,
    )
    loss = torch.tensor(float("nan"))
    for step in range(cfg.steps):
        images, labels = next(batches)
        loss = labeler_model.train_step(
            model, optimizer, _to_device(images, device), _to_device(labels, device)
        )
        if progress and (step % 20 == 0 or step == cfg.steps - 1):
            progress(step, float(loss))
    metrics: dict[str, float] = {"final_loss": float(loss)}
    model.eval()
    if eval_set is not None:
        images, labels = eval_set
        with torch.no_grad():
            probs = torch.cat([
                torch.sigmoid(model(_to_device(images[i:i + EVAL_BATCH], device))).cpu()
                for i in range(0, images.shape[0], EVAL_BATCH)
            ]).numpy()
        top1 = (probs.argmax(1) == labels.argmax(1)).mean()
        metrics["eval_top1"] = float(top1)
    return labeler_model.params_to_flax(model), model, metrics


def train_folder(
    root: str | os.PathLike, out_path: str | os.PathLike,
    cfg: TrainConfig | None = None,
    progress: Callable[[int, float], None] | None = None,
) -> dict[str, float]:
    """Train on a folder-per-class dataset and save the checkpoint."""
    cfg = cfg or TrainConfig()
    samples, classes = scan_folder_dataset(root)
    rng = np.random.default_rng(cfg.seed)
    order = rng.permutation(len(samples))
    n_eval = max(1, int(len(samples) * cfg.eval_fraction))
    eval_samples = [samples[i] for i in order[:n_eval]]
    train_samples = [samples[i] for i in order[n_eval:]]
    if not train_samples:
        raise ValueError("dataset too small to split")
    eval_imgs, eval_rows = [], []
    for path, cls in eval_samples:
        arr = _decode(path, cfg.image_size)
        if arr is None:
            continue
        eval_imgs.append(arr)
        row = np.zeros(len(classes), np.float32)
        row[cls] = 1.0
        eval_rows.append(row)
    eval_set = (
        (np.stack(eval_imgs), np.stack(eval_rows)) if eval_imgs else None
    )
    batches = _folder_batches(train_samples, len(classes), cfg, rng)
    params, _model, metrics = train(
        batches, classes, cfg, eval_set=eval_set, progress=progress
    )
    checkpoint.save(
        out_path, params, classes=list(classes), image_size=cfg.image_size,
        widths=cfg.widths, depths=cfg.depths,
        extra={"metrics": metrics, "trained_on": os.fspath(root)},
    )
    return metrics


def digits_demo_dataset(image_size: int = 32) -> tuple[
    tuple[np.ndarray, np.ndarray], tuple[np.ndarray, np.ndarray], list[str]
]:
    """Bundled real dataset (sklearn digits, 1,797 8×8 scans) for the
    self-contained train demo + tests: returns (train, eval, classes)."""
    from sklearn.datasets import load_digits

    digits = load_digits()
    imgs = digits.images.astype(np.float32) / 16.0  # [N, 8, 8] in [0,1]
    n = imgs.shape[0]
    # upscale 8→image_size (nearest) and tile to 3 channels
    reps = image_size // 8
    big = np.repeat(np.repeat(imgs, reps, axis=1), reps, axis=2)
    rgb = np.repeat(big[..., None], 3, axis=-1)
    labels = np.zeros((n, 10), np.float32)
    labels[np.arange(n), digits.target] = 1.0
    rng = np.random.default_rng(0)
    order = rng.permutation(n)
    split = int(n * 0.9)
    tr, ev = order[:split], order[split:]
    classes = [f"digit {d}" for d in range(10)]
    return (rgb[tr], labels[tr]), (rgb[ev], labels[ev]), classes


# --- procedural scene corpus ------------------------------------------------
#
# The only REAL image set available without egress is sklearn's digit
# scans, and "digit 7" is a useless label for a photo library. These
# generators render the coarse visual statistics of
# the content kinds a file manager actually meets — page-like documents,
# flat-chrome screenshots, sparse strokes, low-frequency natural fields,
# axes-and-series charts, dark scenes — so the bundled offline model
# can say something TRUE about real files. They are also the test
# oracle: the golden test renders held-out samples with a different
# seed and demands the bundled artifact classify them.

SCENE_CLASSES = [
    "document scan", "screenshot", "line art", "photo", "chart",
    "dark photo",
]


def _pool2(img: np.ndarray) -> np.ndarray:
    """2×2 average pool (renders at 2× then downsamples: cheap AA)."""
    return (img[0::2, 0::2] + img[1::2, 0::2]
            + img[0::2, 1::2] + img[1::2, 1::2]) / 4.0


def render_scene(kind: str, rng: np.random.Generator,
                 image_size: int = 32) -> np.ndarray:
    """One [S, S, 3] float32 image in [0, 1] of the given scene kind."""
    s = image_size * 2
    img = np.zeros((s, s, 3), np.float32)
    if kind == "document scan":
        img[:] = 0.82 + rng.uniform(0.0, 0.15)
        img += rng.normal(0, 0.02, img.shape).astype(np.float32)
        margin = int(s * rng.uniform(0.08, 0.18))
        line_h = max(1, int(s * rng.uniform(0.03, 0.06)))
        y = margin
        while y < s - margin:
            x = margin
            while x < s - margin:
                w = int(rng.integers(2, max(3, s // 5)))
                if rng.random() < 0.85:  # word; else inter-word gap
                    img[y:y + line_h, x:min(x + w, s - margin)] *= \
                        rng.uniform(0.15, 0.45)
                x += w + int(rng.integers(1, 4))
            y += line_h + int(rng.integers(line_h, 2 * line_h + 1))
    elif kind == "screenshot":
        img[:] = rng.uniform(0.08, 0.95, 3)
        bar_h = int(s * rng.uniform(0.06, 0.14))
        img[:bar_h] = rng.uniform(0, 1, 3)
        if rng.random() < 0.7:  # sidebar
            img[bar_h:, : int(s * rng.uniform(0.12, 0.3))] = \
                rng.uniform(0, 1, 3)
        for _ in range(int(rng.integers(3, 9))):  # flat panels/buttons
            x0 = int(rng.integers(0, s - 8))
            y0 = int(rng.integers(0, s - 8))
            w = int(rng.integers(6, s // 2))
            h = int(rng.integers(4, s // 3))
            img[y0:y0 + h, x0:x0 + w] = rng.uniform(0, 1, 3)
    elif kind == "line art":
        img[:] = rng.uniform(0.92, 1.0)
        for _ in range(int(rng.integers(2, 6))):
            x = rng.uniform(0, s - 1)
            y = rng.uniform(0, s - 1)
            vx, vy = rng.normal(0, 2.5, 2)
            for _ in range(60):
                vx = vx * 0.9 + rng.normal(0, 1.0)
                vy = vy * 0.9 + rng.normal(0, 1.0)
                x = float(np.clip(x + vx, 0, s - 2))
                y = float(np.clip(y + vy, 0, s - 2))
                img[int(y):int(y) + 2, int(x):int(x) + 2] = 0.05
    elif kind == "photo":
        coarse = rng.uniform(0, 1, (4, 4, 3)).astype(np.float32)
        img = np.kron(coarse, np.ones((s // 4, s // 4, 1), np.float32))
        grad = np.linspace(rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                           s, dtype=np.float32)[:, None, None]
        img = img + grad + rng.normal(0, 0.05, img.shape).astype(np.float32)
        for _ in range(3):  # soften edges toward natural statistics
            img = (np.roll(img, 1, 0) + np.roll(img, -1, 0)
                   + np.roll(img, 1, 1) + np.roll(img, -1, 1) + img) / 5.0
        img = np.clip(img, 0, 1)
    elif kind == "chart":
        img[:] = rng.uniform(0.95, 1.0)
        ax = int(s * 0.12)
        img[s - ax - 1: s - ax, ax:, :] = 0.25       # x axis
        img[: s - ax, ax: ax + 1, :] = 0.25          # y axis
        color = rng.uniform(0, 0.8, 3)
        n_bars = int(rng.integers(4, 9))
        bw = (s - 2 * ax) // n_bars
        if rng.random() < 0.5:  # bar chart
            for i in range(n_bars):
                h = int(rng.uniform(0.1, 0.8) * (s - 2 * ax))
                x0 = ax + 2 + i * bw
                img[s - ax - 1 - h: s - ax - 1, x0: x0 + max(1, bw - 2)] = color
        else:  # polyline series
            ys = (s - ax - 1
                  - rng.uniform(0.05, 0.8, n_bars + 1) * (s - 2 * ax))
            for i in range(n_bars):
                x0, x1 = ax + i * bw, ax + (i + 1) * bw
                y0, y1 = ys[i], ys[i + 1]
                for t in np.linspace(0, 1, 2 * bw):
                    xx = int(x0 + t * (x1 - x0))
                    yy = int(y0 + t * (y1 - y0))
                    img[max(yy - 1, 0): yy + 1, xx: xx + 1] = color
        for gy in range(ax, s - ax, max(4, (s - 2 * ax) // 5)):  # gridlines
            img[gy: gy + 1, ax:, :] = np.minimum(img[gy: gy + 1, ax:, :], 0.85)
    elif kind == "dark photo":
        coarse = rng.uniform(0, 0.18, (4, 4, 3)).astype(np.float32)
        img = np.kron(coarse, np.ones((s // 4, s // 4, 1), np.float32))
        for _ in range(int(rng.integers(2, 7))):  # bright sources
            cx = int(rng.integers(2, s - 2))
            cy = int(rng.integers(2, s - 2))
            r = int(rng.integers(1, max(2, s // 12)))
            img[max(cy - r, 0): cy + r, max(cx - r, 0): cx + r] = \
                rng.uniform(0.7, 1.0, 3)
        for _ in range(2):
            img = (np.roll(img, 1, 0) + np.roll(img, -1, 0)
                   + np.roll(img, 1, 1) + np.roll(img, -1, 1) + img) / 5.0
        img = np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1)
    else:
        raise ValueError(f"unknown scene kind {kind!r}")
    return np.clip(_pool2(img), 0, 1).astype(np.float32)


def scene_dataset(image_size: int = 32, per_class: int = 400,
                  seed: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """[N, S, S, 3] images + one-hot-over-SCENE_CLASSES labels."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for ci, kind in enumerate(SCENE_CLASSES):
        for _ in range(per_class):
            xs.append(render_scene(kind, rng, image_size))
            row = np.zeros((len(SCENE_CLASSES),), np.float32)
            row[ci] = 1.0
            ys.append(row)
    return np.stack(xs), np.stack(ys)


def bundled_dataset(image_size: int = 32, per_scene: int = 400,
                    seed: int = 1) -> tuple[
    tuple[np.ndarray, np.ndarray], tuple[np.ndarray, np.ndarray], list[str]
]:
    """Digits + procedural scenes in ONE label space: the bundled
    offline model keeps the real-scan digit head and gains scene/kind
    classes a photo library actually benefits from."""
    (dtr_x, dtr_y), (dev_x, dev_y), digit_classes = \
        digits_demo_dataset(image_size)
    sx, sy = scene_dataset(image_size, per_scene, seed)
    classes = digit_classes + SCENE_CLASSES
    n_d, n_s = len(digit_classes), len(SCENE_CLASSES)

    def widen(y, off, total):
        out = np.zeros((y.shape[0], total), np.float32)
        out[:, off:off + y.shape[1]] = y
        return out

    rng = np.random.default_rng(seed + 1)
    order = rng.permutation(sx.shape[0])
    split = int(sx.shape[0] * 0.9)
    tr_x = np.concatenate([dtr_x, sx[order[:split]]])
    tr_y = np.concatenate([widen(dtr_y, 0, n_d + n_s),
                           widen(sy[order[:split]], n_d, n_d + n_s)])
    ev_x = np.concatenate([dev_x, sx[order[split:]]])
    ev_y = np.concatenate([widen(dev_y, 0, n_d + n_s),
                           widen(sy[order[split:]], n_d, n_d + n_s)])
    return (tr_x, tr_y), (ev_x, ev_y), classes


def array_batches(
    images: np.ndarray, labels: np.ndarray, batch_size: int, seed: int = 0
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n = images.shape[0]
    if n == 0:
        raise ValueError("empty dataset")
    batch_size = min(batch_size, n)
    while True:
        order = rng.permutation(n)
        for off in range(0, n - batch_size + 1, batch_size):
            idx = order[off:off + batch_size]
            yield images[idx], labels[idx]
