"""Entry points: a forward-step check and a multi-device dry run.

Counterpart of the repo's `__graft_entry__.py` for the PyTorch package.
`entry()` returns the flagship model's forward (the image labeler,
models/labeler.py) with example inputs at tiny shapes;
`dryrun_multichip(n)` runs one LabelerNet training step on a slot list
of `n` devices (the first holds the model, the batch splits over all of
them and their gradients are summed back) and one BLAKE3 batch through
K1 split over the same slot list, each checked against its one-device
result. Both run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

#: tiny shapes: 8 images of 64² through a narrow two-stage net
TINY_IMAGE = 64
TINY_BATCH = 8
TINY_WIDTHS = (8, 16, 32)
TINY_DEPTHS = (1, 1)


def _tiny_model(seed: int = 0):
    from .models.labeler import LabelerNet, create_train_state

    model = LabelerNet(widths=TINY_WIDTHS, depths=TINY_DEPTHS)
    return create_train_state(torch.Generator().manual_seed(seed), TINY_IMAGE, model=model)


def entry(device: str | torch.device = "cuda") -> tuple[Callable, tuple]:
    """(fn, example_args): LabelerNet's forward on 8 images of 64² in
    [0, 1] on `device`; `fn(*example_args)` gives float32 logits [8, 80]."""
    model, _ = _tiny_model()
    model = model.to(device).eval().requires_grad_(False)
    images = torch.zeros(TINY_BATCH, TINY_IMAGE, TINY_IMAGE, 3, device=device)

    def fn(images: torch.Tensor) -> torch.Tensor:
        return model(images)

    return fn, (images,)


def slot_list(n: int, device: str = "cuda") -> list[torch.device]:
    """`n` slots of `device`'s type: for "cuda", the visible cards in
    order (one repeated when fewer are visible); for "cpu", `n` CPU
    slots. Raises when "cuda" is asked for and no card is visible."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * n
    if kind != "cuda":
        raise ValueError(f"slot_list: device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("slot_list: 'cuda' asked for and CUDA is not available")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """One training step and one K1 batch over `slot_list(n_devices, device)`.
    The step's loss must be finite and equal the one-slot step's within
    1e-3; every digest of the split hash must equal `blake3_ref`'s.
    Returns what was run."""
    from .models.labeler import NUM_CLASSES, loss_fn
    from .ops import blake3_torch
    from .ops.blake3_ref import blake3_hex

    slots = slot_list(n_devices, device)
    batch = 2 * n_devices
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((batch, TINY_IMAGE, TINY_IMAGE, 3), np.float32))
    labels = torch.from_numpy((rng.random((batch, NUM_CLASSES)) < 0.1).astype(np.float32))

    # --- training step: the model on the first slot, the batch split
    # over the slots, each slot's replica's gradients summed onto it
    home = slots[0]
    model, optimizer = _tiny_model()
    model.to(home)
    reference, _ = _tiny_model()
    reference.to(home)
    with torch.no_grad():
        want = loss_fn(reference, images.to(home), labels.to(home)).item()
    optimizer.zero_grad(set_to_none=True)
    losses = []
    per = batch // n_devices
    for s, dev in enumerate(slots):
        rows = slice(s * per, (s + 1) * per)
        replica = model if dev == home else _replica(model, dev)
        loss = loss_fn(replica, images[rows].to(dev), labels[rows].to(dev)) / n_devices
        loss.backward()
        if replica is not model:
            for p, q in zip(model.parameters(), replica.parameters()):
                p.grad = q.grad.to(home) if p.grad is None else p.grad + q.grad.to(home)
        losses.append(loss.detach().to(home))
    optimizer.step()
    got = float(torch.stack(losses).sum())
    if not np.isfinite(got) or abs(got - want) > 1e-3:
        raise AssertionError(f"split step loss {got} against the one-slot loss {want}")

    # --- compute plane: one BLAKE3 batch through K1, split over the slots
    rows = 2 * n_devices
    msgs = np.zeros((rows, 2 * 1024), np.uint8)
    msgs[:, :64] = np.arange(64, dtype=np.uint8)[None, :]
    lens = np.full((rows,), 100, np.int32)
    words = blake3_torch.hash_batch(msgs, lens, max_chunks=2, devices=slots)
    hexes = blake3_torch.words_to_hex(words.cpu(), 32)
    expect = blake3_hex(bytes(msgs[0, :100]), 16)
    if any(h != expect for h in hexes):
        raise AssertionError("split BLAKE3 batch disagrees with blake3_ref")
    return {"devices": [str(d) for d in slots], "loss": got, "hashed_rows": rows}


def _replica(model, device: torch.device):
    """A trainable copy of `model` on `device`, gradients cleared."""
    import copy

    replica = copy.deepcopy(model).to(device)
    for p in replica.parameters():
        p.grad = None
    return replica
