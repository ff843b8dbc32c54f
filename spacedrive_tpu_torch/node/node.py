"""Node — the runtime object that owns the long-lived services.

Counterpart of the part of `spacedrive_tpu/node/node.py` the scan chain
uses (ref:core/src/lib.rs:82-250): the event bus, the task system, the
job manager, the libraries (each `Library.node` points back here) and
the node-wide thumbnailer actor on the node's explicit device, which is
also the default device of the read-side jobs and of the semantic
search (a node on "cpu" gives its thumbnailer `use_device=False`, the
software path, as the JAX CLI's `--backend cpu` does,
`spacedrive_tpu/cli.py:30`), and unless `with_labeler=False` the
image-labeler actor on the same device (ref:lib.rs:142, the
reference's `ai` feature gate).
`start` starts the loop-lag monitor, the process-wide autotune
controller (parallel/autotune.py; SD_AUTOTUNE=0 starts nothing) and
the process pool (parallel/procpool.py; SD_PROCS=0, the default,
spawns nothing), binds the thumbnailer to the running loop, loads the
libraries (each registers with the labeler, which re-queues its
persisted batches) and cold-resumes their jobs; `shutdown` stops them,
persists both actors' queues and stops the task system. The
controller and the pool are refcounted, so two nodes in one process
share one controller and one worker set. A Node lives within one event
loop (one `asyncio.run`).

Not ported: config and identity (so no `image_labeler_version`), P2P,
the API server, location watchers, the rest of the telemetry plane.
"""

from __future__ import annotations

import collections
import os
import threading

import torch

from ..jobs import JobManager
from ..models.labeler_actor import ImageLabeler

# each import registers its jobs, so that `start` can cold-resume them
from ..location.indexer import job as _indexer_job  # noqa: F401
from ..object import duplicates as _duplicates_job  # noqa: F401
from ..object.file_identifier import job as _identifier_job  # noqa: F401
from ..object.media import job as _media_job  # noqa: F401
from ..object.validation import job as _validator_job  # noqa: F401

from ..object.media.thumbnail.actor import Thumbnailer
from ..parallel import autotune as _autotune
from ..parallel import procpool as _procpool
from ..tasks import TaskSystem
from ..telemetry.events import LoopLagMonitor
from ..utils.events import EventBus
from .library import Libraries


class Node:
    def __init__(self, data_dir: str | os.PathLike, device: str | torch.device = "cuda",
                 with_labeler: bool = True):
        self.data_dir = os.fspath(data_dir)
        os.makedirs(self.data_dir, exist_ok=True)
        self.device = torch.device(device)
        self.event_bus = EventBus()
        self.task_system = TaskSystem(2)
        self.jobs = JobManager(self.task_system)
        self.libraries = Libraries(self.data_dir, node=self)
        self.thumbnailer = Thumbnailer(os.path.join(self.data_dir, "thumbnails"),
                                       event_bus=self.event_bus, device=self.device,
                                       use_device=self.device.type != "cpu")
        self.image_labeler: ImageLabeler | None = None
        if with_labeler:
            self.image_labeler = ImageLabeler(os.path.join(self.data_dir, "image_labeler"),
                                              device=self.device)
        #: seconds per stage of the jobs (media_data, embed_decode,
        #: embed_forward, embed_write, phash_decode); the thumbnailer
        #: keeps its own
        self.stage_seconds: collections.Counter[str] = collections.Counter()
        self._stage_lock = threading.Lock()
        self.loop_monitor = LoopLagMonitor()
        self.autotuner = _autotune.CONTROLLER
        self.procpool = _procpool.POOL
        self._procpool_started = False
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
        self.loop_monitor.start()
        self.autotuner.start()
        # workers up before any job runs, so the first batch never pays
        # the spawn inside a measured pass
        self._procpool_started = self.procpool.start()
        self.thumbnailer._ensure_started()
        for lib in self.libraries.load_all():
            if self.image_labeler is not None:
                self.image_labeler.register_library(lib)
            await self.jobs.cold_resume(lib)

    async def shutdown(self) -> None:
        """Stop the loop-lag monitor, the controller and the pool (each
        releases its hold), persist the actors' queues, stop the task
        system and close the libraries (ref:lib.rs:240-250)."""
        await self.loop_monitor.stop()
        await self.autotuner.stop()
        if self._procpool_started:
            self.procpool.stop()
            self._procpool_started = False
        await self.thumbnailer.shutdown()
        if self.image_labeler is not None:
            await self.image_labeler.shutdown()
        await self.task_system.shutdown()
        for lib in list(self.libraries.libraries.values()):
            lib.close()
        self._started = False
