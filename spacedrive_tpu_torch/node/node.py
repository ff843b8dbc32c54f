"""Node — the runtime object that owns the long-lived services.

Counterpart of `spacedrive_tpu/node/node.py` (ref:core/src/lib.rs:82-250):
the config manager (`node.json`: id, name, identity keypair, features,
`image_labeler_version`), the event bus, notifications, the task system,
the job manager, the libraries (each `Library.node` points back here),
the named-actor registry, the rspc router (`mount()`, which the
reference's `Node::new` returns beside the node) and the node-wide
thumbnailer actor on the node's explicit device, which is also the
default device of the read-side jobs and of the semantic search (a
node on "cpu" gives its thumbnailer `use_device=False`, the software
path, as the JAX CLI's `--backend cpu` does, `spacedrive_tpu/cli.py:30`),
and unless `with_labeler=False` the image-labeler actor on the same
device (ref:lib.rs:142, the reference's `ai` feature gate), whose
resolved artifact names the config's `image_labeler_version`.
The node's location manager watches every location of its libraries
(location/manager.py; `locations.create` and `locations.delete` add
and remove one), and each library gets an orphan remover
(object/orphan_remover.py) when it loads, stopped when it unloads, as
is the library's sync ingest actor (`Library.ingest`, sync/ingest.py)
where one pulls for it.
`start` starts the loop-lag monitor, the telemetry history writer
(telemetry/history.py, under `<data_dir>/telemetry_history/`;
SD_HISTORY=0 samples nothing), the process-wide autotune controller
(parallel/autotune.py; SD_AUTOTUNE=0 starts nothing), the host sampling
profiler (telemetry/sampler.py; SD_PROFILE=0 starts nothing), the
process pool (parallel/procpool.py; SD_PROCS=0, the default, spawns
nothing) and the resource sampler (telemetry/resources.py, with the
node's inventory providers registered first; SD_RESOURCES=0 starts
nothing), binds the thumbnailer to the running loop, loads the
libraries (each registers with the labeler, which re-queues its
persisted batches) and cold-resumes their jobs; `shutdown` stops them
(joining the samplers' threads and the writer's task), persists both
actors' queues and stops the task system. The controller, the two
samplers and the pool are refcounted, so two nodes in one process share
one controller, one thread per sampler and one worker set. A Node lives
within one event loop (one `asyncio.run`).

When `config.p2p.enabled` (the default), `start` builds and starts the
node's P2P manager (p2p/manager.py: the listener, discovery, and each
library's sync over the mesh, its ingest actor pulling from peers) as
`node.p2p`, after the libraries load; `create_library` registers a new
library with it and `shutdown` stops it. A node with p2p disabled has
`node.p2p` None, as in JAX.

`enable_cloud_sync` starts a library's cloud sync (cloud/sync.py: the
sender, receiver and ingester against a relay's origin, which persists
in the node's preferences, `cloud_api_origin`, as JAX's does), over the
port's own HTTP client (utils/http.py); `close_library` and `shutdown`
stop the trio and close its client.

The node's serve runtime (`node.serve`, serve/: the admission gate and
the read caches) is built with it unless `SD_SERVE_GATE=0`, which leaves
it None: every consumer then takes the ungated path. `start_api` serves
the router and the custom URIs over HTTP and a websocket (api/server.py,
on utils/http.py) as `node.http`; `shutdown` stops it first.
"""

from __future__ import annotations

import asyncio
import collections
import os
import threading
import uuid
from typing import Any

import torch

from ..jobs import JobManager
from ..jobs.manager import shutdown_jobs
from ..models.labeler_actor import ImageLabeler

# each import registers its jobs, so that `start` can cold-resume them
from ..location.indexer import job as _indexer_job  # noqa: F401
from ..object import duplicates as _duplicates_job  # noqa: F401
from ..object.file_identifier import job as _identifier_job  # noqa: F401
from ..object.fs import copy as _copy_job, cut as _cut_job  # noqa: F401
from ..object.fs import delete as _delete_job, erase as _erase_job  # noqa: F401
from ..object.fs import encrypt as _crypto_jobs  # noqa: F401
from ..object.media import job as _media_job  # noqa: F401
from ..object.validation import job as _validator_job  # noqa: F401

from ..location.manager import LocationManager
from ..object.orphan_remover import OrphanRemoverActor

from ..object.media.thumbnail.actor import Thumbnailer
from ..parallel import autotune as _autotune
from ..parallel import procpool as _procpool
from ..tasks import TaskSystem
from ..telemetry import resources as _resources
from ..telemetry import sampler as _sampler
from ..telemetry.history import HistoryWriter, history_dir
from ..telemetry.events import LoopLagMonitor
from ..utils.events import EventBus
from ..utils.tracing import install_loop_excepthook
from .actors import Actors
from .config import BackendFeature, ConfigManager
from .library import Libraries, Library
from .notifications import Notifications


class Node:
    def __init__(self, data_dir: str | os.PathLike, device: str | torch.device = "cuda",
                 with_labeler: bool = True):
        self.data_dir = os.fspath(data_dir)
        os.makedirs(self.data_dir, exist_ok=True)
        self.device = torch.device(device)
        self.config = ConfigManager(self.data_dir)
        self.event_bus = EventBus()
        self.notifications = Notifications(self.event_bus)
        self.task_system = TaskSystem(2)
        self.jobs = JobManager(self.task_system)
        self.libraries = Libraries(self.data_dir, node=self)
        self.actors = Actors()
        self.location_manager = LocationManager(self)
        self.thumbnailer = Thumbnailer(os.path.join(self.data_dir, "thumbnails"),
                                       event_bus=self.event_bus, device=self.device,
                                       use_device=self.device.type != "cpu")
        self.image_labeler: ImageLabeler | None = None
        self.p2p: Any = None  # P2PManager, attached by start() when enabled
        self.http: Any = None  # ApiServer handle from start_api()
        # the serve layer (admission gate + read-path caches): absent
        # entirely under SD_SERVE_GATE=0, and every consumer treats a
        # missing runtime as "take the ungated path"
        from ..serve import ServeRuntime, enabled as _serve_enabled

        self.serve: Any = ServeRuntime() if _serve_enabled() else None
        if with_labeler:
            self.image_labeler = ImageLabeler(os.path.join(self.data_dir, "image_labeler"),
                                              device=self.device)
            # the version names the provisioned artifact, as the
            # reference's image_labeler_version (node/config.rs) does;
            # "none" means no weights yet, so labeling is off
            artifact = self.image_labeler.resolve_artifact()
            version = f"{artifact[0]}:{os.path.basename(artifact[1])}" if artifact else "none"
            if self.config.config.image_labeler_version != version:
                self.config.update(image_labeler_version=version)
        from ..api.namespaces import mount

        self.router = mount()  # ref:lib.rs Node::new returns (node, router)
        #: seconds per stage of the jobs (media_data, embed_decode,
        #: embed_forward, embed_write, phash_decode); the thumbnailer
        #: keeps its own
        self.stage_seconds: collections.Counter[str] = collections.Counter()
        self._stage_lock = threading.Lock()
        self.loop_monitor = LoopLagMonitor()
        # persistent telemetry history: sampled allowlisted series into
        # an append-only segment store under the data dir — constructed
        # unconditionally so offline readers (the CLI's slo) open the
        # same directory; sampling starts with the node, unless
        # SD_HISTORY=0
        self.history = HistoryWriter(history_dir(self.data_dir))
        self.autotuner = _autotune.CONTROLLER
        self.procpool = _procpool.POOL
        self._procpool_started = False
        # the process-wide host sampling profiler (telemetry/sampler.py):
        # a refcounted hold, so two in-process nodes share one sampling
        # thread; SD_PROFILE=0 starts nothing
        self.profiler = _sampler.SAMPLER
        self._profiler_started = False
        # the process-wide resource sampler: refcounted like the
        # profiler; SD_RESOURCES=0 starts nothing. Inventory providers
        # that need node state register at start, unregister at shutdown
        self.resources = _resources.SAMPLER
        self._resources_started = False
        self._started = False

    def add_stage_seconds(self, stage: str, seconds: float) -> None:
        with self._stage_lock:
            self.stage_seconds[stage] += seconds

    # --- identity ------------------------------------------------------

    @property
    def id(self) -> uuid.UUID:
        return self.config.config.id

    @property
    def identity(self):
        return self.config.config.identity

    def is_feature_enabled(self, feature: BackendFeature) -> bool:
        return feature in self.config.config.features

    def toggle_feature(self, feature: BackendFeature, enabled: bool) -> None:
        """ref:core/src/api/mod.rs:66-81 `toggleFeatureFlag`."""
        feats = self.config.config.features
        if enabled and feature not in feats:
            feats.append(feature)
        if not enabled and feature in feats:
            feats.remove(feature)
        self.config.save()

    # --- lifecycle -----------------------------------------------------

    async def start(self) -> None:
        """Bind the thumbnailer to this loop (enqueues from worker
        threads can only wake it once it knows its loop), then load the
        libraries and cold-resume their jobs (ref:lib.rs:163-177)."""
        if self._started:
            return
        self._started = True
        # orphaned-task crashes reach the log and the error ring
        install_loop_excepthook(asyncio.get_running_loop())
        self.loop_monitor.start()
        self.history.start()
        self.autotuner.start()
        # tag this thread as the event loop's, so samples classify as
        # loop vs feeder vs worker, then take a hold on the sampler
        self.profiler.register_loop_thread()
        self._profiler_started = self.profiler.start()
        # workers up before any job runs, so the first batch never pays
        # the spawn inside a measured pass
        self._procpool_started = self.procpool.start()
        # inventories registered before the sampler's hold, so the
        # first tick reads them all
        for name, fn in _resources.node_providers(self).items():
            self.resources.register_provider(name, fn)
        self._resources_started = self.resources.start()
        self.thumbnailer._ensure_started()
        for lib in self.libraries.load_all():
            await self._init_library(lib)
        if self.config.config.p2p.enabled:
            from ..p2p.manager import P2PManager

            self.p2p = P2PManager(self)
            await self.p2p.start()

    async def _init_library(self, lib: Library) -> None:
        """Per-library wiring at load (ref:library/manager/mod.rs:387-535):
        start its orphan remover, register with the labeler, watch its
        locations (the thumbnailer's data dir ignored), then cold-resume
        its jobs."""
        lib.node = self
        lib.orphan_remover = OrphanRemoverActor(lib.db)
        lib.orphan_remover.start()
        self.location_manager.ignore_paths.add(self.thumbnailer.data_dir)
        if self.image_labeler is not None:
            self.image_labeler.register_library(lib)
        for loc in lib.db.find("location"):
            await self.location_manager.add(lib, loc)
        await self.jobs.cold_resume(lib)

    async def create_library(self, name: str, description: str = "") -> Library:
        lib = self.libraries.create(
            name,
            description,
            node_pub_id=self.id.bytes,
            node_name=self.config.config.name,
        )
        await self._init_library(lib)
        if self.p2p is not None:
            self.p2p.register_library(lib)
        return lib

    async def enable_cloud_sync(self, lib: Library, api_origin: str | None = None):
        """Start the cloud sender/receiver/ingester trio for a library
        (ref:core/src/cloud/sync/mod.rs:14 declare_actors; the origin
        persists in node preferences like the reference's sd-cloud-api
        env). Raises ValueError with no origin; an origin that changed
        moves the library's sync to the new relay."""
        from ..cloud.api import CloudClient
        from ..cloud.sync import CloudSync

        prev_origin = self.config.config.preferences.get("cloud_api_origin")
        if api_origin is not None and api_origin != prev_origin:
            self.config.config.preferences["cloud_api_origin"] = api_origin
            self.config.save()
        origin = self.config.config.preferences.get("cloud_api_origin")
        if not origin:
            raise ValueError("no cloud api origin configured")
        existing = lib.cloud_sync
        if existing is not None:
            if existing.client.origin == origin.rstrip("/"):
                return existing
            await _stop_cloud_sync(lib)
        client = CloudClient(origin)
        cloud = CloudSync(lib, client)
        try:
            await cloud.start()
        except BaseException:
            await cloud.shutdown()
            await client.close()
            raise
        lib.cloud_sync = cloud
        if BackendFeature.CLOUD_SYNC not in self.config.config.features:
            self.toggle_feature(BackendFeature.CLOUD_SYNC, True)
        return cloud

    async def close_library(self, lib_id: uuid.UUID) -> None:
        """Tear down one loaded library: stop its cloud sync, persist and
        stop its jobs, close the DB, drop it from the registry (the
        per-library half of shutdown(); used by delete and restore)."""
        lib = self.libraries.libraries.get(lib_id)
        if lib is None:
            return
        await _stop_cloud_sync(lib)
        await shutdown_jobs(self.jobs, lib)
        await _stop_library_actors(lib)
        lib.close()
        self.libraries.libraries.pop(lib_id, None)

    async def start_api(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve /rspc + custom-URI over HTTP (ref:apps/server/src/main.rs)."""
        from ..api.server import ApiServer

        self.http = ApiServer(self, self.router)
        return await self.http.start(host, port)

    async def shutdown(self) -> None:
        """Stop the HTTP API, the libraries' cloud sync, orphan removers and ingest
        actors, the loop-lag monitor, the history writer, the controller,
        the samplers and the pool (each releases its hold), persist the
        actors' queues, stop the watchers (draining their in-flight
        rescans), stop the task system and close the libraries
        (ref:lib.rs:240-250)."""
        if self.http is not None:
            await self.http.shutdown()
            self.http = None
        for lib in list(self.libraries.libraries.values()):
            await _stop_cloud_sync(lib)
            await _stop_library_actors(lib)
        await self.loop_monitor.stop()
        await self.history.stop()
        await self.autotuner.stop()
        if self._profiler_started:
            self.profiler.stop()
            self._profiler_started = False
        if self._procpool_started:
            self.procpool.stop()
            self._procpool_started = False
        if self._resources_started:
            self.resources.stop()
            self._resources_started = False
        if not self.resources.running():
            # last hold released (or sampling disabled): drop the
            # node-state closures so a dead node can't be read. While a
            # sibling in-process node still holds the sampler, its own
            # registrations (last-wins) stay live instead
            for name in _resources.node_providers(self):
                self.resources.unregister_provider(name)
        await self.thumbnailer.shutdown()
        if self.image_labeler is not None:
            await self.image_labeler.shutdown()
        await self.location_manager.shutdown()
        await self.actors.shutdown()
        if self.p2p is not None:
            await self.p2p.shutdown()
        await self.task_system.shutdown()
        for lib in list(self.libraries.libraries.values()):
            lib.close()
        self._started = False


async def _stop_library_actors(lib: Library) -> None:
    for actor in (lib.orphan_remover, lib.ingest):
        if actor is not None:
            await actor.stop()


async def _stop_cloud_sync(lib: Library) -> None:
    cloud, lib.cloud_sync = lib.cloud_sync, None
    if cloud is not None:
        await cloud.shutdown()
        await cloud.client.close()
