"""ImageLabeler actor: batched, resumable labeling of library images.

Counterpart of `spacedrive_tpu/models/labeler_actor.py`
(ref:crates/ai/src/image_labeler/actor.rs): a node-global actor fed
`new_batch(library, entries)` (actor.rs:202) that decodes images on the
host, runs the model in batches on its explicit `device`, and writes
`label` + `label_on_object` rows per object (actor.rs:67-73, 291).
Pending batches persist to `to_resume_batches.bin` across restarts
(actor.rs:73-99), as MessagePack bytes from the port's own codec.

The model is the provisioned artifact in the actor's directory:
`model.onnx` (any classifier or YOLO-family head, run by
`models/onnx_runtime.py`) before `weights.npz` (a LabelerNet checkpoint,
`models/checkpoint.py`), or the paths in `SD_LABELER_ONNX` /
`SD_LABELER_CKPT`. Without an artifact the actor completes batches
without writing rows and warns once: random-weight inference would
write noise labels. Every class whose probability reaches the
threshold becomes a text label. A failed forward (a CUDA error
included) fails its batch: the entries count in `errors`, nothing is
redone on another device.

A batch that wrote labels invalidates `labels.list` on the library's
node, as the JAX actor does. Not ported: its telemetry; `stage_seconds`
keeps the decode / forward / write totals, and `forwards` counts the
model calls.
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import json
import logging
import os
import secrets
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..db.database import now_iso
from ..utils.msgpack_codec import packb, unpackb
from . import labeler as labeler_model

logger = logging.getLogger(__name__)

RESUME_FILE = "to_resume_batches.bin"  # ref:actor.rs:92
DEFAULT_BATCH_SIZE = 16
PENDING_LABELS_THRESHOLD = 0.35


@dataclass
class Batch:
    library_id: str
    entries: list[dict[str, Any]]  # {file_path_id, object_id, path}
    id: int = 0


class ImageLabeler:
    """`Node.image_labeler` (ref:crates/ai `ImageLabeler`)."""

    def __init__(self, data_dir: str | os.PathLike, *, device: str | torch.device = "cuda"):
        self.data_dir = os.fspath(data_dir)
        os.makedirs(self.data_dir, exist_ok=True)
        self.device = torch.device(device)
        # the artifact's input shape replaces these when it loads
        self.batch_size = DEFAULT_BATCH_SIZE
        self.threshold = PENDING_LABELS_THRESHOLD
        self.image_size = labeler_model.DEFAULT_IMAGE_SIZE
        self._queue: collections.deque[Batch] = collections.deque()
        self._work: asyncio.Event | None = None  # set when queue non-empty
        self._batch_ids = itertools.count((secrets.randbits(40) << 20) | 1)
        self._batch_pending: dict[int, int] = {}
        self._libraries: dict[str, Any] = {}
        self._cond: asyncio.Condition | None = None
        self._worker: asyncio.Task | None = None
        self._stopped = False
        self.labeled = 0
        self.errors = 0
        self.skipped = 0  # entries completed with labeling disabled
        self.forwards = 0
        self.stage_seconds: collections.Counter[str] = collections.Counter()
        self.classes: list[str] = list(labeler_model.LABEL_CLASSES)
        self._infer: Callable[[torch.Tensor], torch.Tensor] | None = None
        self._disabled = False
        self._inflight: Batch | None = None
        # crash recovery (ref:actor.rs:73-99): batches persisted at
        # shutdown re-queue, keyed to libraries that re-register; the
        # file stays on disk (re-persisted, never just deleted) so a
        # crash before completion still resumes next boot
        self._resume_raw: list[dict[str, Any]] = []
        path = os.path.join(self.data_dir, RESUME_FILE)
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    self._resume_raw = unpackb(f.read())
            except Exception:
                logger.exception("failed to load %s", RESUME_FILE)
                os.remove(path)

    # --- model ----------------------------------------------------------

    def resolve_artifact(self) -> tuple[str, str] | None:
        """(kind, path) of the provisioned model artifact, or None."""
        onnx_path = os.environ.get("SD_LABELER_ONNX") or os.path.join(
            self.data_dir, "model.onnx"
        )
        if os.path.exists(onnx_path):
            return ("onnx", onnx_path)
        ckpt_path = os.environ.get("SD_LABELER_CKPT") or os.path.join(
            self.data_dir, "weights.npz"
        )
        if os.path.exists(ckpt_path):
            return ("checkpoint", ckpt_path)
        return None

    def _ensure_model(self) -> bool:
        """Load the provisioned artifact; False = labeling disabled.

        Re-resolves on every call while disabled, so an artifact
        provisioned while the node runs enables labeling without a
        restart.
        """
        if self._infer is not None:
            return True
        artifact = self.resolve_artifact()
        if artifact is None:
            if not self._disabled:  # warn once per disabled episode
                logger.warning(
                    "image labeler disabled: no model artifact (weights.npz "
                    "checkpoint or model.onnx) in %s; batches will complete "
                    "without writing labels", self.data_dir,
                )
            self._disabled = True
            return False
        self._disabled = False
        kind, path = artifact
        if kind == "onnx":
            self._load_onnx(path)
        else:
            self._load_checkpoint(path)
        logger.info(
            "image labeler: loaded %s artifact %s (%d classes, %d px) on %s",
            kind, path, len(self.classes), self.image_size, self.device,
        )
        return True

    def _load_checkpoint(self, path: str) -> None:
        from . import checkpoint

        params, meta = checkpoint.load(path)
        self.classes = list(meta["classes"])
        self.image_size = int(meta["image_size"])
        model = labeler_model.from_flax(params, len(self.classes), meta["widths"],
                                        meta["depths"], self.device)

        @torch.no_grad()
        def infer(images: torch.Tensor) -> torch.Tensor:
            return torch.sigmoid(model(images))

        self._infer = infer

    def _load_onnx(self, path: str) -> None:
        from . import onnx_runtime

        model = onnx_runtime.load(path, self.device)
        shapes = model.input_shapes()
        in_shape = shapes.get(model.inputs[0]) if model.inputs else None
        if in_shape and len(in_shape) == 4:
            if in_shape[2] and in_shape[2] > 0:
                self.image_size = int(in_shape[2])
            if in_shape[0] and in_shape[0] > 0:
                self.batch_size = int(in_shape[0])
        self.classes = list(labeler_model.LABEL_CLASSES)

        def run(images: torch.Tensor) -> torch.Tensor:
            """float[B, H, W, 3] in [0,1] → probs float[B, C]."""
            out = model(images.permute(0, 3, 1, 2))[0]  # ONNX vision = NCHW
            out = torch.as_tensor(out, device=self.device)
            if out.ndim == 3:
                # YOLO-family head. Channel dim is far smaller than the
                # anchor dim (e.g. 84 vs 8400); detect the layout from
                # static shapes rather than assuming one export style.
                d1, d2 = int(out.shape[1]), int(out.shape[2])
                if d1 < d2:
                    # v8 export [B, 4+C, anchors]: class scores are
                    # post-sigmoid; a label's confidence is its best
                    # anchor (the reference keeps any class clearing
                    # the threshold, actor.rs:291)
                    return torch.amax(out[:, 4:, :], dim=-1)
                # v5-style export [B, anchors, 5+C]: obj conf at 4,
                # class probs from 5; score = obj * cls, best anchor
                obj = out[:, :, 4:5]
                return torch.amax(obj * out[:, :, 5:], dim=1)
            return torch.sigmoid(out)  # rank-2 classifier logits

        self._infer = run
        # YOLO class count may differ from the default vocabulary: one
        # probe forward on zeros gives it
        probe = torch.zeros((self.batch_size, self.image_size, self.image_size, 3),
                            device=self.device)
        n_classes = int(run(probe).shape[1])
        if n_classes != len(self.classes):
            self.classes = [f"class {i}" for i in range(n_classes)]
        # provisioned class names (models/provision.py) override the
        # positional defaults when the cardinality matches
        names_path = os.path.join(self.data_dir, "classes.json")
        if os.path.exists(names_path):
            try:
                with open(names_path) as f:
                    names = json.load(f)
                if isinstance(names, list) and len(names) == n_classes:
                    self.classes = [str(c) for c in names]
                else:
                    logger.warning(
                        "classes.json has %s names but the model has %d "
                        "classes; ignoring", len(names), n_classes,
                    )
            except Exception:  # noqa: BLE001 - names are advisory
                logger.exception("unreadable classes.json; ignoring")

    # --- API (ref:actor.rs new_batch / resume) --------------------------

    def register_library(self, library: Any) -> None:
        """Libraries announce themselves so resumed batches can bind."""
        self._libraries[str(library.id)] = library
        for raw in [r for r in self._resume_raw if r["library_id"] == str(library.id)]:
            self._resume_raw.remove(raw)
            self.new_batch(library, raw["entries"])

    def new_batch(self, library: Any, entries: list[dict[str, Any]]) -> int:
        entries = [e for e in entries if e.get("object_id") is not None]
        if not entries:
            return 0
        self._libraries[str(library.id)] = library
        batch = Batch(library_id=str(library.id), entries=entries)
        batch.id = next(self._batch_ids)
        self._queue.append(batch)
        self._batch_pending[batch.id] = len(entries)
        self._persist()
        self._ensure_started()
        if self._work is not None:
            self._work.set()
        return batch.id

    async def wait_batch(self, batch_id: int) -> None:
        if batch_id == 0:
            return
        self._ensure_started()
        assert self._cond is not None
        async with self._cond:
            await self._cond.wait_for(
                lambda: self._batch_pending.get(batch_id, 0) == 0
            )

    # --- lifecycle ------------------------------------------------------

    def _ensure_started(self) -> None:
        if self._stopped:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        if self._cond is None:
            self._cond = asyncio.Condition()
        if self._work is None:
            self._work = asyncio.Event()
        if self._queue:
            self._work.set()
        if self._worker is None or self._worker.done():
            self._worker = loop.create_task(self._run(), name="image-labeler")

    async def shutdown(self) -> None:
        self._stopped = True
        if self._worker is not None:
            self._worker.cancel()
            try:
                await self._worker
            except (asyncio.CancelledError, Exception):
                pass
        self._persist()

    def _persist(self) -> None:
        path = os.path.join(self.data_dir, RESUME_FILE)
        batches = list(self._queue)
        if self._inflight is not None:
            batches.insert(0, self._inflight)
        pending = [
            {"library_id": b.library_id, "entries": b.entries}
            for b in batches
        ] + self._resume_raw
        if not pending:
            if os.path.exists(path):
                os.remove(path)
            return
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(packb(pending))
        os.replace(tmp, path)

    # --- worker ---------------------------------------------------------

    async def _run(self) -> None:
        assert self._work is not None
        while not self._stopped:
            if not self._queue:
                self._work.clear()
                await self._work.wait()
                continue
            batch = self._queue.popleft()
            self._inflight = batch  # stays in the resume file until done
            try:
                await self._process(batch)
            except asyncio.CancelledError:
                # shutdown mid-batch: keep it in the resume file
                # (_inflight still set) for the next boot
                self._persist()
                raise
            except Exception:
                logger.exception("labeler batch %d failed", batch.id)
                self.errors += len(batch.entries)
            self._inflight = None
            self._persist()
            assert self._cond is not None
            async with self._cond:
                self._batch_pending.pop(batch.id, None)
                self._cond.notify_all()

    async def _process(self, batch: Batch) -> None:
        library = self._libraries.get(batch.library_id)
        if library is None:
            logger.warning("labeler: unknown library %s", batch.library_id)
            return
        if not await asyncio.to_thread(self._ensure_model):
            # no provisioned model artifact: complete the batch without
            # writing rows (never infer from random weights)
            self.skipped += len(batch.entries)
            self._batch_pending[batch.id] = 0
            return
        wrote = False
        for off in range(0, len(batch.entries), self.batch_size):
            chunk = batch.entries[off : off + self.batch_size]
            decoded = await asyncio.to_thread(self._timed, "decode", self._decode_chunk, chunk)
            ok = [(e, arr) for e, arr in zip(chunk, decoded) if arr is not None]
            self.errors += len(chunk) - len(ok)
            if not ok:
                continue
            images = np.stack([arr for _e, arr in ok])
            probs = await asyncio.to_thread(self._timed, "forward", self._infer_chunk, images)
            await asyncio.to_thread(
                self._timed, "write", self._write_labels, library, [e for e, _ in ok], probs
            )
            wrote = True
            self._batch_pending[batch.id] = max(
                0, self._batch_pending.get(batch.id, 0) - len(chunk)
            )
        # fresh labels must reach live explorers (the sidebar Labels
        # route listens on labels.list invalidations)
        node = getattr(library, "node", None)
        if wrote and node is not None:
            from ..api.invalidate import invalidate_query

            invalidate_query(node, "labels.list", library)

    def _timed(self, stage: str, fn: Callable, *args: Any) -> Any:
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.stage_seconds[stage] += time.perf_counter() - t0

    def _decode_chunk(self, chunk: list[dict[str, Any]]) -> list[np.ndarray | None]:
        """RGB float32 [S, S, 3] in [0, 1] per entry (None when the file
        does not decode): the thumbnailer's decode, then PIL's resize."""
        from PIL import Image

        from ..object.media.images import format_image

        out: list[np.ndarray | None] = []
        for entry in chunk:
            try:
                rgba = format_image(entry["path"])
                img = Image.fromarray(rgba).convert("RGB").resize(
                    (self.image_size, self.image_size)
                )
                out.append(np.asarray(img, np.float32) / 255.0)
            except Exception:
                out.append(None)
        return out

    def _infer_chunk(self, images: np.ndarray) -> np.ndarray:
        """Probabilities float32 [n, C] of n ≤ batch_size images, run on
        the actor's device as one batch_size forward (the ragged tail is
        zero-padded, so every call has one shape)."""
        n = images.shape[0]
        if n < self.batch_size:
            pad = np.zeros(
                (self.batch_size - n, *images.shape[1:]), images.dtype
            )
            images = np.concatenate([images, pad])
        probs = self._infer(torch.from_numpy(images).to(self.device))
        self.forwards += 1
        return probs.float().cpu().numpy()[:n]

    def _write_labels(
        self, library: Any, entries: list[dict[str, Any]], probs: np.ndarray
    ) -> None:
        """label + label_on_object rows (ref:actor.rs:67-73,291)."""
        db = library.db
        for entry, row_probs in zip(entries, probs):
            names = [
                self.classes[i]
                for i in np.nonzero(row_probs >= self.threshold)[0]
            ]
            for name in names:
                label = db.find_one("label", name=name)
                label_id = (
                    label["id"]
                    if label is not None
                    else db.insert(
                        "label",
                        name=name,
                        date_created=now_iso(),
                        date_modified=now_iso(),
                    )
                )
                db.upsert(
                    "label_on_object",
                    {"label_id": label_id, "object_id": entry["object_id"]},
                )
            self.labeled += 1
