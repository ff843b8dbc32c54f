"""Crash-resumable pending-thumbnail state.

Counterpart of `spacedrive_tpu/object/media/thumbnail/state.py`
(ref:core/src/object/media/thumbnail/state.rs:23-115): the actor
persists its queued batches to `thumbs_to_process.bin` whenever the
queue changes and on shutdown, reloads them at startup, and deletes the
file after a successful load. The file is the JAX package's bytes for
the same batches; the trace slot is always nil here (the port carries
no trace context).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

from ....utils.msgpack_codec import MsgpackError, packb, unpackb

logger = logging.getLogger(__name__)

STATE_FILE = "thumbs_to_process.bin"


@dataclass
class Batch:
    """One dispatched thumbnail batch."""

    library_id: str | None  # None = ephemeral namespace
    entries: list[tuple[str, str, str]]  # (cas_id, path, extension)
    background: bool = False
    id: int = 0  # process-local rendezvous handle; not persisted

    def to_wire(self) -> dict:
        return {
            "library_id": self.library_id,
            "entries": [list(e) for e in self.entries],
            "background": self.background,
            "trace": None,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "Batch":
        return cls(
            library_id=d.get("library_id"),
            entries=[tuple(e) for e in d.get("entries", [])],
            background=bool(d.get("background", False)),
        )


def save_state(data_dir: str | os.PathLike, batches: list[Batch]) -> None:
    path = os.path.join(os.fspath(data_dir), STATE_FILE)
    if not batches:
        try:
            os.remove(path)
        except FileNotFoundError:
            pass
        return
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb([b.to_wire() for b in batches]))
    os.replace(tmp, path)


def load_state(data_dir: str | os.PathLike) -> list[Batch]:
    """Load and DELETE the state file (ref:state.rs — removed after
    load, so a crash mid-processing re-persists only the remainder). A
    torn or foreign file is discarded."""
    path = os.path.join(os.fspath(data_dir), STATE_FILE)
    try:
        with open(path, "rb") as f:
            raw = f.read()
        os.remove(path)
    except OSError:
        return []
    try:
        return [Batch.from_wire(d) for d in unpackb(raw)]
    except (MsgpackError, TypeError, AttributeError):
        logger.warning("corrupt %s; discarding", STATE_FILE)
        return []
