"""Node — the runtime object that owns the long-lived services.

Counterpart of the part of `spacedrive_tpu/node/node.py` the scan chain
uses (ref:core/src/lib.rs:82-250): the event bus, the task system, the
job manager, the libraries (each `Library.node` points back here) and
the node-wide thumbnailer actor on the node's explicit device, which is
also the default device of the read-side jobs and of the semantic
search. `start` binds the thumbnailer to the running loop, loads the libraries and cold-resumes
their jobs; `shutdown` persists the thumbnailer's queues and stops the
task system. A Node lives within one event loop (one `asyncio.run`).

Not ported: config and identity, the image labeler (`image_labeler`
stays None), P2P, the API server, location watchers, telemetry.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Any

import torch

from ..jobs import JobManager

# each import registers its jobs, so that `start` can cold-resume them
from ..location.indexer import job as _indexer_job  # noqa: F401
from ..object import duplicates as _duplicates_job  # noqa: F401
from ..object.file_identifier import job as _identifier_job  # noqa: F401
from ..object.media import job as _media_job  # noqa: F401
from ..object.validation import job as _validator_job  # noqa: F401

from ..object.media.thumbnail.actor import Thumbnailer
from ..tasks import TaskSystem
from ..utils.events import EventBus
from .library import Libraries


class Node:
    def __init__(self, data_dir: str | os.PathLike, device: str | torch.device = "cuda"):
        self.data_dir = os.fspath(data_dir)
        os.makedirs(self.data_dir, exist_ok=True)
        self.device = torch.device(device)
        self.event_bus = EventBus()
        self.task_system = TaskSystem(2)
        self.jobs = JobManager(self.task_system)
        self.libraries = Libraries(self.data_dir, node=self)
        self.thumbnailer = Thumbnailer(os.path.join(self.data_dir, "thumbnails"),
                                       event_bus=self.event_bus, device=self.device)
        self.image_labeler: Any = None
        #: seconds per media stage of the jobs (media_data, embed_decode,
        #: embed_forward, embed_write); the thumbnailer keeps its own
        self.stage_seconds: collections.Counter[str] = collections.Counter()
        self._stage_lock = threading.Lock()
        self._started = False

    def add_stage_seconds(self, stage: str, seconds: float) -> None:
        with self._stage_lock:
            self.stage_seconds[stage] += seconds

    async def start(self) -> None:
        """Bind the thumbnailer to this loop (enqueues from worker
        threads can only wake it once it knows its loop), then load the
        libraries and cold-resume their jobs (ref:lib.rs:163-177)."""
        if self._started:
            return
        self._started = True
        self.thumbnailer._ensure_started()
        for lib in self.libraries.load_all():
            await self.jobs.cold_resume(lib)

    async def shutdown(self) -> None:
        """Persist the thumbnailer's queues, stop the task system and
        close the libraries (ref:lib.rs:240-250)."""
        await self.thumbnailer.shutdown()
        await self.task_system.shutdown()
        for lib in list(self.libraries.libraries.values()):
            lib.close()
        self._started = False
