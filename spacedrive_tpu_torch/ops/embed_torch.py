"""Batched image embedding on the device, the semantic-search leg.

Counterpart of `spacedrive_tpu/ops/embed_jax.py`: one forward per call
and slot, the batch padded to a power of two (the JAX package bounds its
compiled shapes that way; here it keeps the device batch on a few
sizes), the products at full float32 (`strict_fp32`, whatever the
caller's TF32 flags), the output shape checked before it is returned.
The batch can split over a slot list and rides the device ladder
(`embed_batch`); the `embed.forward` fault point sits before every
forward.
"""

from __future__ import annotations

import copy
import weakref
from typing import Sequence

import numpy as np
import torch

from ..models import embedder as _embedder
from ..parallel import mesh as _mesh
from ..telemetry import metrics as _tm
from ..utils import faults as _faults
from ..utils.precision import strict_fp32
from .cas import shard_occupancy


# a given model's copies on the other slots' devices, made once each
_COPIES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _model_on(model: _embedder.PatchPoolEmbedder | None,
              dev: torch.device) -> _embedder.PatchPoolEmbedder:
    """`model` where it lives on `dev`, else its copy there (made on
    the first call that needs it and kept while the model lives); the
    seed-derived embedder when no model is given."""
    if model is None:
        return _embedder.PatchPoolEmbedder(dev)
    have = model.w1.device
    if have.type == dev.type and (dev.index is None or dev.index == have.index):
        return model
    copies = _COPIES.setdefault(model, {})
    if dev not in copies:
        copies[dev] = copy.deepcopy(model).to(dev)
    return copies[dev]


def _embed_chunk(images: np.ndarray, slots: list[torch.device],
                 model: _embedder.PatchPoolEmbedder | None) -> np.ndarray:
    """Pad one batch, run its forward on each slot's share (launched on
    every slot before any is read back) and return the [bpad,
    EMBED_DIM] float32 result, validated: a device that returns the
    wrong shape is an error the caller can demote on."""
    n, n_dev = images.shape[0], len(slots)
    # power-of-two batch pad; a sharded call also rounds up to the slot
    # count so rows divide evenly
    bpad = 1 << max(0, (n - 1).bit_length())
    if n_dev > 1:
        bpad = max(bpad, n_dev)
        bpad += (-bpad) % n_dev
    batch = np.zeros((bpad, *images.shape[1:]), np.float32)
    batch[:n] = images
    spec = _faults.hit("embed.forward")
    if spec is not None:
        if spec.mode == "raise":
            raise _faults.InjectedFault("injected device failure (embed)")
        if spec.mode == "xla":
            raise _faults.device_error("embed.forward")
    r = bpad // n_dev
    if n_dev > 1:
        _tm.SHARD_BATCH_ROWS.observe(r, op="embed")
        for frac in shard_occupancy(n, bpad, n_dev):
            _tm.DEVICE_DISPATCH_OCCUPANCY.observe(frac, op="embed")
    shares = []
    for s, dev in enumerate(slots):
        part = torch.from_numpy(batch[s * r:(s + 1) * r]).to(dev)
        with torch.no_grad(), strict_fp32(part.device):
            shares.append(_model_on(model, dev)(part))
    out = np.concatenate([share.cpu().numpy() for share in shares])
    if spec is not None and spec.mode == "wrong_shape":
        out = out[:, : _embedder.EMBED_DIM // 2]
    if out.shape != (bpad, _embedder.EMBED_DIM):
        raise ValueError(
            f"device embed returned shape {out.shape}, "
            f"expected {(bpad, _embedder.EMBED_DIM)}"
        )
    return out


def embed_batch(
    images: np.ndarray,
    device: str | torch.device = "cuda",
    model: _embedder.PatchPoolEmbedder | None = None,
    devices: Sequence[torch.device] | None = None,
) -> np.ndarray:
    """Embed a [N, S, S, 3] float32 batch → [N, EMBED_DIM] float32.
    `model` defaults to the seed-derived embedder; a given model is used
    on its device and copied once to any other slot's (its weights are
    frozen, so the copy stays equal).

    Explicit `devices` split the batch over that slot list, strict.
    Otherwise the call rides the degradation ladder on `device`
    (parallel/mesh.run_on_ladder): sharded over the dispatch devices
    when each gets a real row, re-run at the demoted rung when it
    fails."""
    s = _embedder.IMAGE_SIZE
    if images.ndim != 4 or images.shape[1:] != (s, s, 3):
        raise ValueError(f"embed input shape {images.shape} is not [N, {s}, {s}, 3]")
    n = images.shape[0]
    if n == 0:
        return np.zeros((0, _embedder.EMBED_DIM), np.float32)

    def call(slots):
        return _embed_chunk(np.asarray(images, np.float32), slots, model)

    if devices is not None:
        return call([torch.device(d) for d in devices])[:n]
    return _mesh.run_on_ladder(device, n, call, "embed.ladder")[:n]
