"""Command line of the PyTorch/CUDA package.

    python -m spacedrive_tpu_torch index <path> --data-dir D [--device cuda|cpu]
    python -m spacedrive_tpu_torch index <path> --data-dir D --library NAME [--device cuda|cpu]
        [--no-p2p]
    python -m spacedrive_tpu_torch duplicates --data-dir D --library NAME [--threshold 8] [--device ...]
    python -m spacedrive_tpu_torch search QUERY --data-dir D --library NAME [--semantic] [--take 10]
        [--device ...]
    python -m spacedrive_tpu_torch status --data-dir D [--device ...]
    python -m spacedrive_tpu_torch browse PATH --data-dir D [--hidden] [--device ...]
    python -m spacedrive_tpu_torch labeler provision --data-dir D
        [--bundled | --from FILE [--classes FILE] [--sha256 HEX] | --url URL] [--device ...]
    python -m spacedrive_tpu_torch labeler status --data-dir D
    python -m spacedrive_tpu_torch labeler train DATASET --data-dir D [--out F] [--image-size 96]
        [--batch-size 32] [--steps 600] [--lr 1e-3] [--device ...]
    python -m spacedrive_tpu_torch labeler train-demo --data-dir D [--out F] [--steps 300]
        [--device ...]
    python -m spacedrive_tpu_torch trace-export [--url URL] [--trace-id HEX] [--out F]
    python -m spacedrive_tpu_torch profile [--url URL] [--folded] [--out F]
    python -m spacedrive_tpu_torch profile --peer IDENTITY --data-dir D [--folded] [--wait 3]
        [--out F] [--device ...]
    python -m spacedrive_tpu_torch debug-bundle [--data-dir D | --url URL] [--out F]
    python -m spacedrive_tpu_torch debug-bundle --peer IDENTITY --data-dir D [--wait 3] [--out F]
        [--device ...]
    python -m spacedrive_tpu_torch peers --data-dir D [--wait 3] [--device ...]
    python -m spacedrive_tpu_torch pair IDENTITY --data-dir D [--library UUID] [--wait 3]
        [--device ...]
    python -m spacedrive_tpu_torch spacedrop IDENTITY FILE... --data-dir D [--wait 3]
        [--device ...]
    python -m spacedrive_tpu_torch relay [--host 0.0.0.0] [--port 8490] [--p2p-port 8491]
        [--max-pipes-per-target 8] [--max-pipes 256] [--pipe-rate BYTES_PER_S]
        [--stats-interval 60]
    python -m spacedrive_tpu_torch serve --data-dir D [--host 127.0.0.1] [--port 8080]
        [--cloud ORIGIN] [--auto-accept-pairing] [--device ...]
    python -m spacedrive_tpu_torch serve-status [--url URL | --data-dir D] [--out F]
    python -m spacedrive_tpu_torch desktop --data-dir D [--host H] [--port P] [--open-path PATH]
        [--no-open] [--quit] [--register] [--device ...]
    python -m spacedrive_tpu_torch licenses [--out F]
    python -m spacedrive_tpu_torch crypto inspect FILE
    python -m spacedrive_tpu_torch crypto encrypt|decrypt FILE [--password PW]

Before the command, `--faults PLAN [--fault-seed N]` arms the fault
plane for the invocation (chaos testing, utils/faults.py: e.g.
`--faults "device.blake3:xla:times=1"`); without it, `SD_FAULTS` and
`SD_FAULT_SEED` do.

Without `--library`: walks <path>, computes every file's cas_id, writes
thumbnails under `D/thumbnails/` and embeds the images, then prints one
JSON line: files, objects (distinct cas_ids), bytes, thumbnails,
backend, seconds.

With `--library NAME`: the library path (counterpart of
`spacedrive_tpu/cli.py cmd_index`). It starts a Node on the device
(with its P2P manager, as JAX's does, unless `--no-p2p`),
opens or creates the library NAME under `D/libraries/`, adds <path> as
a location if it is not one yet, and runs `scan_location` (IndexerJob →
FileIdentifierJob → MediaProcessorJob) on the node's job system: the
identifier hashes through the BLAKE3 chunk kernel on "cuda", the media
job sends the images to the node's thumbnailer and writes media_data
rows, embeddings and the search index, and sends every image to the
node's labeler actor, which writes `label` and `label_on_object` rows
once a model is provisioned. It prints one JSON line: library,
location_id, files, objects, bytes, thumbnails, labeled, backend,
seconds (objects and bytes as node/statistics.py counts them). A second
run over an unchanged tree hashes, thumbnails, extracts and embeds
nothing; it labels every image again.

`duplicates` (counterpart of `sdx duplicates`) runs DuplicateDetectorJob
on the library (pHashes of the image objects that lack one, on the
device) and prints the near and exact duplicate groups as JSON.
`search` (counterpart of `sdx search`) prints a name search over the
library's files, or with `--semantic` the cosine top-k of the vector
index: QUERY is an image path to embed or a stored label name; a query
that resolves to neither exits 1. Both build their node without the
labeler.

`duplicates`, `search` and `status` build their nodes without p2p, as
the JAX commands do (their `--no-p2p` defaults on).

`status` (counterpart of `sdx status`) starts a Node on the device
(without the labeler), and prints the router's `nodeState` (the card in
`device_model` and `accelerators`) with, for each library, its
file_path and object counts and its five newest `jobs.reports`.

`browse` (counterpart of `sdx browse`) lists one directory without
indexing it (location/non_indexed.walk_dir on a Node on the device,
without the labeler and without queueing thumbnails): a line per entry,
directories first, with its kind, size and name.

`labeler provision` (counterpart of `sdx labeler provision`) installs
the labeler's model under `D/image_labeler/`: `--bundled` the
in-package checkpoint, checked against its sha256 pin with no network;
`--from` a local `.onnx` or `.npz` (an ONNX model is validated by a
smoke inference on `--device`); otherwise a download from `--url`
(default: the YOLOv8n release asset). It prints the install's info as
JSON, or `{"error": ...}` and exits 1. `labeler status` prints the
provisioned artifact and whether labeling is enabled.

`labeler train` (counterpart of `sdx labeler train`) trains a LabelerNet
checkpoint on a folder-per-class dataset (`DATASET/<class>/*.png|jpg|…`)
on `--device`; `labeler train-demo` trains the 32² demo net on
scikit-learn's bundled digit scans. Both write the checkpoint to `--out`
(default `D/image_labeler/weights.npz`, the artifact the node's labeler
loads on its next scan), report progress on stderr and print
`{"checkpoint", "metrics"}` as JSON.

`trace-export`, `profile` and `debug-bundle` (counterparts of the `sdx`
commands) read a running node's HTTP API at `--url`: its span ring as
Chrome-trace JSON (`GET /trace`, loadable in Perfetto), its host
sampler's profile (`GET /profile`; `--folded` gives flamegraph.pl
text), its redacted debug bundle (`POST /rspc/telemetry.debug_bundle`).
A port node serves them once `serve` (or `Node.start_api`) runs;
in-process, its router answers the same procedures
(`telemetry.trace_export`, `telemetry.profile`,
`telemetry.debug_bundle`). Without
`--url`, `debug-bundle` builds the bundle offline from `--data-dir`
(node config redacted, this process's empty rings). `licenses` prints
the dependency and license inventory (utils/deps.py).

`attrib [TRACE_ID]`, `slo`, `tenants` and `mesh-status` (counterparts
of the `sdx` commands) read a running node at `--url`: the critical-path
attribution of the last settled pass or of TRACE_ID (`GET /attrib`;
`--refresh` bypasses the report cache), the SLO evaluation (`POST
/rspc/telemetry.slo`), the tenant sketches (`GET /tenants`) and the
mesh view (`GET /mesh`; `--no-refresh` serves the cached one). Without
`--url`, `slo` evaluates the history under `--data-dir` offline (the
history survives restarts), and `tenants` and `mesh-status` boot a mesh
node on `--data-dir`, let discovery settle for `--wait` seconds, pull
every discovered peer's snapshot and print this node's view and each
peer's, freshness-marked (`tenants --peer LABEL` shows one peer's
federated tenant digest).

The mesh commands (counterparts of `sdx peers`, `pair`, `spacedrop`,
`profile --peer` and `debug-bundle --peer`) boot a node on `--data-dir`
with its P2P manager (exit 1 when p2p is disabled in the node config)
and let discovery settle for `--wait` seconds: `peers` lists the
discovered peers; `pair` joins IDENTITY's library (the peer consents);
`spacedrop` sends files to IDENTITY (the peer accepts or rejects);
`profile --peer` pulls IDENTITY's host profile over the TELEMETRY wire
(library members only); `debug-bundle --peer` pulls IDENTITY's bundle,
redacted on the owning node, by remote rspc (the peer must enable
`remoteRspc`).

`relay` (counterpart of `sdx relay`) runs the standalone self-hosted
relay until interrupted: the cloud sync API over HTTP (cloud/relay.py,
on the port's own HTTP layer) and the p2p rendezvous (p2p/relay.py),
printing both addresses, then the rendezvous's counters every
`--stats-interval` seconds (0: never). A Node syncs a library through
it once `cloud.setApiOrigin` names `http://HOST:PORT` and
`cloud.sync.enable` runs for the library (`Node.enable_cloud_sync`);
its p2p reaches relayed peers with `p2p.relay = "HOST:P2P_PORT"` in its
node config, or once `serve --cloud http://HOST:PORT` names it.

`serve` (counterpart of `sdx serve`) starts a Node on `--device` and
its HTTP API (api/server.py: `POST /rspc/<key>`, the `/rspc/ws`
websocket, `/health`, `/metrics`, `/search`, the custom URIs and the
explorer UI at `/`) until interrupted; `--cloud ORIGIN` persists the
relay's origin and enables every library's cloud sync against it,
`--auto-accept-pairing` lets a headless node accept library joins.
`serve-status` prints the serve layer's posture (admission-gate mode,
per-class inflight/queued/shed counts, read-cache occupancy): a running
node's `telemetry.serve` at `--url`, or an idle node's on `--data-dir`.
`desktop` (counterpart of `sdx desktop`, desktop.py) runs one managed
node per data dir with its API and opens the explorer in the browser;
a second launch forwards `--open-path` to the running one, `--quit`
stops it, `--register` writes the XDG launcher entry.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import sys
import time


def cmd_index(args: argparse.Namespace) -> int:
    if args.library is not None:
        summary = asyncio.run(index_library(args.path, args.data_dir, args.library, args.device,
                                            no_p2p=args.no_p2p))
        print(json.dumps(summary))
        return 0
    from .index_pass import index_pass

    result = index_pass(args.path, args.data_dir, device=args.device)
    print(json.dumps(result.summary))
    return 0


def _node_without_p2p(data_dir: str, backend: str):
    """A Node on `backend` without the labeler or its P2P manager (the
    JAX commands' `--no-p2p`, on by default for status, duplicates and
    search)."""
    from .node.node import Node

    node = Node(data_dir, device=backend, with_labeler=False)
    node.config.config.p2p.enabled = False
    return node


async def _open(node, library: str):
    """Start `node` and return the library called `library` (created if
    absent)."""
    await node.start()
    lib = next((lib for lib in node.libraries.libraries.values() if lib.name == library), None)
    return lib if lib is not None else await node.create_library(library)


async def index_library(path: str, data_dir: str, library: str, backend: str = "cuda",
                        node=None, no_p2p: bool = False) -> dict:
    """Scan `path` into the library called `library` (created if absent)
    on a Node on `backend`, wait for the scan's jobs and thumbnails, and
    return the summary line (the JAX package's `sdx index` keys). A
    caller that reads the node's stage seconds afterwards passes its own
    `node`, built on `data_dir` and `backend`; it is started and shut
    down here all the same. `no_p2p` starts the node without its P2P
    manager. Raises if a job of the scan failed."""
    from .db.database import now_iso
    from .jobs import JobStatus
    from .location.locations import LocationCreateArgs, scan_location
    from .node.node import Node
    from .node.statistics import update_statistics

    if node is None:
        node = Node(data_dir, device=backend)
    if no_p2p:
        node.config.config.p2p.enabled = False
    try:
        lib = await _open(node, library)
        t0 = time.perf_counter()
        started = now_iso()
        loc = lib.db.find_one("location", path=os.path.abspath(path))
        if loc is None:
            loc = LocationCreateArgs(path=path).create(lib)
        await scan_location(lib, loc, node.jobs, backend=str(node.device))
        await node.jobs.wait_idle()
        failed = lib.db.query(
            "SELECT name, errors_text FROM job WHERE status = ? AND date_created >= ?",
            (int(JobStatus.FAILED), started),
        )
        if failed:
            raise RuntimeError(f"scan failed: {failed}")
        await node.thumbnailer.wait_library_batch(lib.id)
        elapsed = time.perf_counter() - t0
        stats = update_statistics(lib.db, node.thumbnailer.data_dir)
        return {
            "library": lib.name,
            "location_id": loc["id"],
            "files": lib.db.count("file_path", "is_dir = 0"),
            "objects": stats["total_object_count"],
            "bytes": int(stats["total_bytes_used"]),
            "thumbnails": node.thumbnailer.generated,
            "labeled": node.image_labeler.labeled if node.image_labeler else 0,
            "backend": node.device.type,
            "seconds": round(elapsed, 2),
        }
    finally:
        await node.shutdown()


async def duplicates_library(data_dir: str, library: str, threshold: int = 8,
                             backend: str = "cuda", node=None) -> list[dict]:
    """Hash the library's image objects that lack a pHash
    (DuplicateDetectorJob on a Node on `backend`) and return
    `find_duplicates`' groups. A caller that reads the node afterwards
    passes its own `node`; it is started and shut down here all the
    same. Raises if the job failed."""
    from .jobs import JobBuilder, JobStatus
    from .object.duplicates import DuplicateDetectorJob, find_duplicates

    if node is None:
        node = _node_without_p2p(data_dir, backend)
    try:
        lib = await _open(node, library)
        job = DuplicateDetectorJob({"threshold": threshold})
        await JobBuilder(job).spawn(node.jobs, lib)
        await node.jobs.wait_idle()
        row = lib.db.query_one("SELECT status, errors_text FROM job WHERE id = ?", (job.id.bytes,))
        if row is None or row["status"] != int(JobStatus.COMPLETED):
            raise RuntimeError(f"duplicate detection failed: {row}")
        return await asyncio.to_thread(find_duplicates, lib, threshold, node.device)
    finally:
        await node.shutdown()


async def search_library(query: str, data_dir: str, library: str, semantic: bool = False,
                         take: int = 10, backend: str = "cuda", node=None) -> dict:
    """`search.paths` by name, or with `semantic` `search.semantic` on a
    Node on `backend`; returns the result (`resolved` False when a
    semantic query names no image path and no stored label)."""
    from .api.search import search_paths, search_semantic

    if node is None:
        node = _node_without_p2p(data_dir, backend)
    try:
        lib = await _open(node, library)
        if semantic:
            return await asyncio.to_thread(search_semantic, lib, {"query": query, "take": take})
        return await asyncio.to_thread(search_paths, lib,
                                       {"filter": {"search": query}, "take": take})
    finally:
        await node.shutdown()


async def node_status(data_dir: str, backend: str = "cuda") -> dict:
    """`nodeState` of a Node on `backend` over `data_dir`, and each
    library's counts and five newest job reports, through the router."""
    node = _node_without_p2p(data_dir, backend)
    await node.start()
    try:
        out = await node.router.exec(node, "nodeState")
        out["libraries"] = []
        for lib in node.libraries.libraries.values():
            reports = await node.router.exec(node, "jobs.reports", library_id=str(lib.id))
            out["libraries"].append({
                "id": str(lib.id),
                "name": lib.name,
                "file_paths": lib.db.count("file_path"),
                "objects": lib.db.count("object"),
                "recent_jobs": reports[:5],
            })
        return out
    finally:
        await node.shutdown()


def cmd_status(args: argparse.Namespace) -> int:
    print(json.dumps(asyncio.run(node_status(args.data_dir, args.device)), indent=2))
    return 0


async def browse(path: str, data_dir: str, with_hidden: bool = False,
                 backend: str = "cuda") -> list[dict]:
    """One directory's non-indexed listing (`walk_dir`) on a Node on
    `backend`, without queueing thumbnails."""
    from .location.non_indexed import walk_dir
    from .node.node import Node

    node = Node(data_dir, device=backend, with_labeler=False)
    try:
        return walk_dir(node, path, with_hidden=with_hidden, queue_thumbnails=False)["entries"]
    finally:
        await node.shutdown()


def cmd_browse(args: argparse.Namespace) -> int:
    for e in asyncio.run(browse(args.path, args.data_dir, args.hidden, args.device)):
        kind = "dir " if e["is_dir"] else "file"
        print(f"{kind}  {e['size_in_bytes']:>12}  {e['name']}"
              + (f".{e['extension']}" if e["extension"] else ""))
    return 0


def cmd_duplicates(args: argparse.Namespace) -> int:
    groups = asyncio.run(duplicates_library(args.data_dir, args.library, args.threshold,
                                            args.device))
    print(json.dumps(groups, indent=2))
    return 0


def cmd_search(args: argparse.Namespace) -> int:
    out = asyncio.run(search_library(args.query, args.data_dir, args.library, args.semantic,
                                     args.take, args.device))
    if args.semantic and not out.get("resolved"):
        print("query resolved to no probe vector (not an image path or a stored label name)",
              file=sys.stderr)
        return 1
    print(json.dumps(out, indent=2, default=str))
    return 0


def cmd_labeler(args: argparse.Namespace) -> int:
    labeler_dir = os.path.join(args.data_dir, "image_labeler")
    if args.labeler_cmd == "provision":
        from .models import provision

        try:
            classes = None
            if args.classes:
                with open(args.classes) as f:
                    classes = [ln.strip() for ln in f if ln.strip()]
            if args.bundled:
                if args.src or args.url or args.sha256 or args.classes:
                    raise ValueError(
                        "--bundled installs the pinned in-package artifact; "
                        "it cannot combine with --from/--url/--sha256/--classes"
                    )
                info = provision.install_bundled(labeler_dir)
            elif args.src:
                info = provision.import_artifact(args.src, labeler_dir, classes=classes,
                                                 sha256=args.sha256, device=args.device)
            else:
                url = args.url or provision.DEFAULT_MODEL_URL
                print(f"downloading {url}…", file=sys.stderr, flush=True)
                info = provision.fetch(url, labeler_dir, classes=classes, sha256=args.sha256,
                                       device=args.device)
        except Exception as e:  # noqa: BLE001 - CLI contract: JSON + rc 1
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
            return 1
        print(json.dumps(info, indent=2))
        return 0
    if args.labeler_cmd in ("train", "train-demo"):
        return _train(args, labeler_dir)
    from .models.labeler_actor import ImageLabeler

    artifact = ImageLabeler(labeler_dir).resolve_artifact()
    info = {"artifact": None, "enabled": False}
    if artifact is not None:
        info = {"artifact": {"kind": artifact[0], "path": artifact[1]}, "enabled": True}
        if artifact[0] == "checkpoint":
            from .models import checkpoint

            _params, meta = checkpoint.load(artifact[1])
            info["classes"] = len(meta["classes"])
            info["image_size"] = meta["image_size"]
            info["metrics"] = meta.get("metrics", {})
    print(json.dumps(info, indent=2))
    return 0


def _train(args: argparse.Namespace, labeler_dir: str) -> int:
    from .models import checkpoint
    from .models.train import TrainConfig, array_batches, digits_demo_dataset, train, train_folder

    def progress(step: int, loss: float) -> None:
        print(f"step {step}/{cfg.steps}  loss {loss:.4f}", file=sys.stderr, flush=True)

    out = args.out or os.path.join(labeler_dir, "weights.npz")
    if args.labeler_cmd == "train":
        cfg = TrainConfig(image_size=args.image_size, batch_size=args.batch_size,
                          steps=args.steps, learning_rate=args.lr,
                          use_device=args.device != "cpu")
        metrics = train_folder(args.dataset, out, cfg, progress=progress)
    else:
        cfg = TrainConfig(image_size=32, widths=(8, 16, 32, 32, 32), depths=(1, 1, 1, 1),
                          batch_size=64, steps=args.steps, use_device=args.device != "cpu")
        (tr_x, tr_y), (ev_x, ev_y), classes = digits_demo_dataset(cfg.image_size)
        params, _model, metrics = train(array_batches(tr_x, tr_y, cfg.batch_size), classes, cfg,
                                        eval_set=(ev_x, ev_y), progress=progress)
        checkpoint.save(out, params, classes=classes, image_size=cfg.image_size,
                        widths=cfg.widths, depths=cfg.depths,
                        extra={"metrics": metrics, "trained_on": "sklearn-digits"})
    print(json.dumps({"checkpoint": out, "metrics": metrics}, indent=2))
    return 0


def _write_or_print(doc: str, out: str | None) -> None:
    if out:
        with open(out, "w") as f:
            f.write(doc + "\n")
        print(f"wrote {out} ({len(doc)} bytes)", file=sys.stderr)
    else:
        print(doc)


def _http_get(url: str, timeout: float = 10.0) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def cmd_trace_export(args: argparse.Namespace) -> int:
    """A running node's Chrome-trace JSON (GET /trace): load the output
    in Perfetto (ui.perfetto.dev) or chrome://tracing."""
    import urllib.error

    url = args.url.rstrip("/") + "/trace"
    if args.trace_id:
        url += f"?trace_id={args.trace_id}"
    try:
        doc = _http_get(url)
    except (urllib.error.URLError, OSError) as e:
        print(f"trace-export: cannot reach {url}: {e}", file=sys.stderr)
        return 1
    # refuse to write a non-trace artifact (a proxy error page, another
    # server on that port), with a message, not a traceback
    try:
        parsed = json.loads(doc)
        events = parsed["traceEvents"]
    except (ValueError, TypeError, KeyError):
        print(f"trace-export: {url} did not return Chrome-trace JSON", file=sys.stderr)
        return 1
    print(f"trace-export: {len(events)} events", file=sys.stderr)
    _write_or_print(json.dumps(parsed, indent=2), args.out)
    return 0


def cmd_profile(args: argparse.Namespace) -> int:
    """A running node's host profile (GET /profile), or a mesh peer's
    (--peer); --folded gives flamegraph.pl collapsed-stack text."""
    if args.peer:
        if not args.data_dir:
            print("profile: --peer needs --data-dir", file=sys.stderr)
            return 1
        return asyncio.run(_profile_peer(args))
    import urllib.error

    url = args.url.rstrip("/") + "/profile"
    if args.folded:
        url += "?format=folded"
    try:
        doc = _http_get(url)
    except (urllib.error.URLError, OSError) as e:
        print(f"profile: cannot reach {url}: {e}", file=sys.stderr)
        return 1
    if args.folded:
        _write_or_print(doc.rstrip("\n"), args.out)
        return 0
    try:
        parsed = json.loads(doc)
    except ValueError:
        print(f"profile: {url} did not return JSON", file=sys.stderr)
        return 1
    _write_or_print(json.dumps(parsed, indent=2), args.out)
    if isinstance(parsed, dict) and parsed.get("enabled"):
        groups = parsed.get("frame_groups") or []
        split = "  ".join(f"{g['group']}={g['share']:.0%}" for g in groups[:5])
        print(f"profile: {parsed.get('samples', 0)} samples over "
              f"{parsed.get('duration_s', 0)}s — {split}", file=sys.stderr)
    return 0


def cmd_debug_bundle(args: argparse.Namespace) -> int:
    """The redacted debug bundle: from a running node (--url), from a
    mesh peer (--peer, redacted on the owning node), or built offline
    from the data dir."""
    from .telemetry.bundle import render_bundle

    if args.peer:
        if not args.data_dir:
            print("debug-bundle: --peer needs --data-dir", file=sys.stderr)
            return 1
        return asyncio.run(_debug_bundle_peer(args))
    if args.url:
        import urllib.error
        import urllib.request

        url = args.url.rstrip("/") + "/rspc/telemetry.debug_bundle"
        req = urllib.request.Request(url, data=b"{}", method="POST",
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                payload = json.loads(resp.read().decode())
        except (urllib.error.URLError, OSError, ValueError) as e:
            print(f"debug-bundle: cannot reach {url}: {e}", file=sys.stderr)
            return 1
        doc = json.dumps(payload.get("result"), indent=2)
    else:
        doc = render_bundle(data_dir=args.data_dir)
    _write_or_print(doc, args.out)
    return 0


def cmd_attrib(args: argparse.Namespace) -> int:
    """A running node's critical-path attribution (GET /attrib): where
    the last pass's (or TRACE_ID's) wall-clock went — device / host_cpu
    / link / queue_wait / gap."""
    import urllib.error
    import urllib.parse

    url = args.url.rstrip("/") + "/attrib"
    query = {}
    if args.trace_id:
        query["trace_id"] = args.trace_id
    if args.refresh:
        query["refresh"] = "1"
    if query:
        url += "?" + urllib.parse.urlencode(query)
    try:
        doc = json.loads(_http_get(url, timeout=30.0))
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"attrib: cannot reach {url}: {e}", file=sys.stderr)
        return 1
    if doc.get("error"):
        print(f"attrib: {doc['error']}", file=sys.stderr)
        return 1
    _write_or_print(json.dumps(doc, indent=2), args.out)
    buckets = doc.get("buckets") or {}
    if buckets:
        wall = doc.get("wall_seconds") or 0.0
        split = "  ".join(f"{k}={v:.2f}s" for k, v in sorted(
            buckets.items(), key=lambda kv: kv[1], reverse=True))
        print(f"attrib: {wall:.2f}s critical path — {split}", file=sys.stderr)
    return 0


def cmd_slo(args: argparse.Namespace) -> int:
    """SLO burn-rate posture: a running node's live evaluation (--url),
    or the data dir's persistent history evaluated offline."""
    if args.url:
        import urllib.error
        import urllib.request

        url = args.url.rstrip("/") + "/rspc/telemetry.slo"
        req = urllib.request.Request(url, data=b"{}", method="POST",
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                payload = json.loads(resp.read().decode())
        except (urllib.error.URLError, OSError, ValueError) as e:
            print(f"slo: cannot reach {url}: {e}", file=sys.stderr)
            return 1
        doc = payload.get("result")
    elif args.data_dir:
        from .telemetry import slo as _slo
        from .telemetry.history import history_dir

        doc = _slo.evaluate(directory=history_dir(args.data_dir))
    else:
        print("slo: give --url or --data-dir", file=sys.stderr)
        return 2
    _write_or_print(json.dumps(doc, indent=2), args.out)
    if isinstance(doc, dict):
        for s in doc.get("slos") or []:
            print(f"slo: {s['name']}: {s['status']}"
                  + (f"  (current {s['current']:g})"
                     if isinstance(s.get("current"), (int, float)) else ""),
                  file=sys.stderr)
    return 0


@contextlib.asynccontextmanager
async def _mesh_node(args: argparse.Namespace):
    """A started Node on --data-dir (without the labeler) with its P2P
    manager up and discovery settled for --wait seconds, or
    SystemExit(1) when p2p is disabled in the node config."""
    from .node.node import Node

    node = Node(args.data_dir, device=args.device, with_labeler=False)
    await node.start()
    try:
        if node.p2p is None:
            print("p2p is disabled in the node config", file=sys.stderr)
            raise SystemExit(1)
        await asyncio.sleep(args.wait)  # let discovery settle
        yield node
    finally:
        await node.shutdown()


def _get_url(args: argparse.Namespace, what: str, path: str) -> object | None:
    """GET `path` of the node at --url as JSON; None after a message."""
    import urllib.error

    url = args.url.rstrip("/") + path
    try:
        return json.loads(_http_get(url, timeout=30.0))
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"{what}: cannot reach {url}: {e}", file=sys.stderr)
        return None


async def _federated_mesh(args: argparse.Namespace) -> dict:
    """`mesh_status` of a mesh node on --data-dir after a forced pull of
    every discovered peer's snapshot."""
    from .telemetry.federation import mesh_status

    async with _mesh_node(args) as node:
        await node.p2p.refresh_federation(force=True)
        return mesh_status(node)


def cmd_tenants(args: argparse.Namespace) -> int:
    """Per-tenant accounting: the heavy-hitter sketches per surface
    (hashed tenant labels, never raw UUIDs): a running node's (--url),
    or this node's and every mesh peer's federated digest (--peer: one
    peer's, by peer_label or identity prefix)."""
    if args.url:
        doc = _get_url(args, "tenants", "/tenants")
        if doc is None:
            return 1
    elif not args.data_dir:
        print("tenants: give --url or --data-dir", file=sys.stderr)
        return 1
    else:
        from .telemetry import tenants as _tenants_mod

        mesh = asyncio.run(_federated_mesh(args))["mesh"]
        peers = {
            pid: {
                "peer_label": p.get("peer_label"),
                "stale": p.get("stale"),
                "tenants": (p.get("snapshot") or {}).get("tenants"),
            }
            for pid, p in mesh.get("peers", {}).items()
        }
        if args.peer:
            want = args.peer
            match = {pid: p for pid, p in peers.items()
                     if want in (pid, p.get("peer_label")) or pid.startswith(want)}
            if not match:
                print(f"tenants: no mesh peer matches {want!r} (known: {sorted(peers)})",
                      file=sys.stderr)
                return 1
            doc = {"peers": match}
        else:
            doc = {"local": _tenants_mod.snapshot(), "peers": peers}
    _write_or_print(json.dumps(doc, indent=2, default=str), args.out)
    return 0


def cmd_mesh_status(args: argparse.Namespace) -> int:
    """The mesh view: this node's snapshot (health, metrics, ring
    digests, libraries) and every peer's, freshness-marked: a running
    node's (--url), or a mesh node's on --data-dir after pulling every
    discovered peer."""
    if args.url:
        doc = _get_url(args, "mesh-status", "/mesh" + ("?refresh=0" if args.no_refresh else ""))
        if doc is None:
            return 1
    elif not args.data_dir:
        print("mesh-status: give --url or --data-dir", file=sys.stderr)
        return 1
    else:
        doc = asyncio.run(_federated_mesh(args))
    _write_or_print(json.dumps(doc, indent=2, default=str), args.out)
    if not args.url and not doc["mesh"]["peers"]:
        print("no peers in the federation cache (none discovered?)", file=sys.stderr)
    return 0


async def _peers(args: argparse.Namespace) -> int:
    async with _mesh_node(args) as node:
        peers = node.p2p.p2p.discovered_peers()
        for p in peers:
            print(json.dumps({
                "identity": str(p.identity),
                "name": p.metadata.get("name"),
                "os": p.metadata.get("operating_system"),
                "libraries": [x for x in p.metadata.get("libraries", "").split(",") if x],
                "addrs": sorted(f"{h}:{pt}" for h, pt in p.addrs),
            }))
        if not peers:
            print("no peers discovered", file=sys.stderr)
        return 0


def cmd_peers(args: argparse.Namespace) -> int:
    """Discover mesh peers for --wait seconds and list them."""
    return asyncio.run(_peers(args))


async def _pair(args: argparse.Namespace) -> int:
    import uuid

    from .p2p.identity import RemoteIdentity

    async with _mesh_node(args) as node:
        try:
            lib = await node.p2p.pairing.join(
                node.p2p.p2p,
                RemoteIdentity.from_str(args.identity),
                uuid.UUID(args.library) if args.library else None,
            )
        except PermissionError as e:
            print(f"rejected: {e}", file=sys.stderr)
            return 1
        except asyncio.TimeoutError:
            print("peer did not respond (offline, or consent timed out)", file=sys.stderr)
            return 1
        except FileExistsError as e:
            print(str(e), file=sys.stderr)
            return 1
        except (ValueError, ConnectionError) as e:
            print(f"pairing failed: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"library": str(lib.id), "name": lib.name}))
        # give the first sync pull a moment before tearing down
        await asyncio.sleep(2)
        return 0


def cmd_pair(args: argparse.Namespace) -> int:
    """Join a peer's library over the mesh (consent happens on the peer)."""
    return asyncio.run(_pair(args))


async def _spacedrop(args: argparse.Namespace) -> int:
    from .p2p.identity import RemoteIdentity

    async with _mesh_node(args) as node:
        try:
            drop_id = await node.p2p.spacedrop.send(
                RemoteIdentity.from_str(args.identity), list(args.files))
        except PermissionError as e:
            print(f"rejected: {e}", file=sys.stderr)
            return 1
        except asyncio.TimeoutError:
            print("peer did not respond", file=sys.stderr)
            return 1
        except (ValueError, ConnectionError, OSError) as e:
            print(f"spacedrop failed: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"drop_id": str(drop_id), "sent": len(args.files)}))
        return 0


def cmd_spacedrop(args: argparse.Namespace) -> int:
    """Send files to a peer (they accept or reject on their end)."""
    return asyncio.run(_spacedrop(args))


async def _profile_peer(args: argparse.Namespace) -> int:
    """Pull a mesh peer's host profile over the TELEMETRY wire
    (profile_pull: library members only, as trace_pull; frame names are
    module:function only, so nothing needing redaction rides the wire)."""
    from .p2p.identity import RemoteIdentity
    from .p2p.manager import SYNC_POLICY
    from .p2p.operations import request_profile
    from .utils.resilience import BreakerOpen

    async with _mesh_node(args) as node:
        try:
            doc = await SYNC_POLICY.call(
                args.peer,
                lambda: request_profile(node.p2p.p2p, RemoteIdentity.from_str(args.peer)),
            )
        except PermissionError as e:
            print(f"profile: peer refused: {e}", file=sys.stderr)
            return 1
        except (BreakerOpen, ValueError, ConnectionError, OSError, EOFError,
                asyncio.TimeoutError) as e:
            print(f"profile: cannot reach peer: {e}", file=sys.stderr)
            return 1
        if args.folded:
            _write_or_print(str(doc.get("folded", "")).rstrip("\n"), args.out)
        else:
            _write_or_print(json.dumps(doc.get("profile"), indent=2), args.out)
        return 0


async def _debug_bundle_peer(args: argparse.Namespace) -> int:
    """Pull a mesh peer's debug bundle, built and redacted by the owning
    node before it rides the wire (the peer must enable remoteRspc)."""
    from .p2p.identity import RemoteIdentity
    from .p2p.rspc import RSPC_POLICY, RemoteRspcError, remote_exec

    async with _mesh_node(args) as node:
        try:
            bundle = await RSPC_POLICY.call(
                args.peer,
                lambda: remote_exec(node.p2p.p2p, RemoteIdentity.from_str(args.peer),
                                    "telemetry.debug_bundle"),
            )
        except RemoteRspcError as e:
            print(f"debug-bundle: peer refused: {e} (code {e.code})", file=sys.stderr)
            if e.code == 403:
                print("the peer must enable the remoteRspc feature (toggleFeature remoteRspc)",
                      file=sys.stderr)
            return 1
        except (ValueError, ConnectionError, OSError, EOFError, asyncio.TimeoutError) as e:
            print(f"debug-bundle: cannot reach peer: {e}", file=sys.stderr)
            return 1
        _write_or_print(json.dumps(bundle, indent=2), args.out)
        return 0


def cmd_crypto(args: argparse.Namespace) -> int:
    """`crypto inspect` prints an encrypted file's header as JSON;
    `crypto encrypt` writes FILE.sdenc and `crypto decrypt` FILE without
    its `.sdenc` (or FILE.decrypted), asking for the password when
    `--password` is absent (counterpart of `sdx crypto`)."""
    from .crypto import FileHeader, decrypt_file, encrypt_file

    if args.crypto_cmd == "inspect":
        # ref:apps/cli/src/main.rs — print header details
        with open(args.file, "rb") as f:
            header, raw = FileHeader.from_reader(f)
        print(
            json.dumps(
                {
                    "version": header.version,
                    "algorithm": header.algorithm.name,
                    "keyslots": [
                        {
                            "hashing": ks.hashing_algorithm.kind,
                            "params": int(ks.hashing_algorithm.params),
                        }
                        for ks in header.keyslots
                    ],
                    "has_metadata": header.metadata is not None,
                    "has_preview_media": header.preview_media is not None,
                    "header_bytes": len(raw),
                },
                indent=2,
            )
        )
    elif args.crypto_cmd == "encrypt":
        import getpass

        pw = args.password or getpass.getpass("password: ")
        encrypt_file(args.file, args.file + ".sdenc", pw.encode())
        print(f"wrote {args.file}.sdenc")
    elif args.crypto_cmd == "decrypt":
        import getpass

        pw = args.password or getpass.getpass("password: ")
        out = (
            args.file[: -len(".sdenc")]
            if args.file.endswith(".sdenc")
            else args.file + ".decrypted"
        )
        meta = decrypt_file(args.file, out, pw.encode())
        print(f"wrote {out}" + (f"  metadata: {meta}" if meta else ""))
    return 0


def cmd_licenses(args: argparse.Namespace) -> int:
    from .utils.deps import collect

    _write_or_print(json.dumps(collect(), indent=2), args.out)
    return 0


async def _relay(args: argparse.Namespace) -> int:
    from .cloud.relay import CloudRelay
    from .p2p.relay import RelayLimits

    relay = CloudRelay(p2p_limits=RelayLimits(
        max_pipes_per_target=args.max_pipes_per_target,
        max_pipes_total=args.max_pipes,
        pipe_rate_bytes_per_s=args.pipe_rate,
    ))
    port = await relay.start(host=args.host, port=args.port, p2p_port=args.p2p_port)
    print(f"relay: sync API on http://{args.host}:{port}/api  "
          f"(point nodes' --cloud at http://{args.host}:{port})", flush=True)
    print(f"relay: p2p rendezvous on {args.host}:{relay.p2p_port}  "
          f"(point nodes' p2p.relay at {args.host}:{relay.p2p_port})", flush=True)
    try:
        while True:
            await asyncio.sleep(args.stats_interval or 3600)
            if args.stats_interval:
                s = relay.p2p_relay.stats.snapshot()
                print(f"relay stats: {json.dumps(s)}", flush=True)
    except asyncio.CancelledError:
        pass
    finally:
        await relay.shutdown()
    return 0


def cmd_relay(args: argparse.Namespace) -> int:
    """Run the standalone self-hosted relay: WAN sync collections over
    HTTP and the P2P rendezvous, the deployable form of what the
    reference's closed cloud provides."""
    try:
        return asyncio.run(_relay(args))
    except KeyboardInterrupt:
        return 0


async def _serve(args: argparse.Namespace) -> int:
    from .node.node import Node

    node = Node(args.data_dir, device=args.device)
    await node.start()
    try:
        port = await node.start_api(host=args.host, port=args.port)
        print(f"serving on http://{args.host}:{port}  (rspc: /rspc/<key>)", flush=True)
        if node.p2p is not None:
            print(f"p2p on port {node.p2p.port}, identity {node.p2p.p2p.remote_identity}",
                  flush=True)
            if args.auto_accept_pairing:
                node.p2p.pairing.auto_accept = True
                print("pairing: auto-accept enabled", flush=True)
        elif args.auto_accept_pairing:
            print("warning: --auto-accept-pairing ignored (p2p disabled)", file=sys.stderr)
        if args.cloud:
            # persist the origin even with zero libraries yet: libraries
            # created later enable against it through cloud.sync.enable
            node.config.config.preferences["cloud_api_origin"] = args.cloud
            node.config.save()
            enabled = 0
            for lib in list(node.libraries.libraries.values()):
                try:
                    await node.enable_cloud_sync(lib)
                    enabled += 1
                except Exception as e:  # noqa: BLE001 - one library's failure is reported
                    print(f"cloud sync for {lib.name!r} failed: {e}", file=sys.stderr)
            print(f"cloud sync: {args.cloud} ({enabled} libraries enabled)", flush=True)
        while True:
            await asyncio.sleep(3600)
    except asyncio.CancelledError:
        pass
    finally:
        await node.shutdown()
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    """Run a node and its HTTP API until interrupted."""
    try:
        return asyncio.run(_serve(args))
    except KeyboardInterrupt:
        return 0


def cmd_serve_status(args: argparse.Namespace) -> int:
    """Serve-layer posture: admission-gate mode, per-class
    inflight/queued/shed counts and read-cache occupancy: a running
    node's rspc telemetry.serve (--url), or an idle node's (--data-dir)."""
    if args.url:
        import urllib.error
        import urllib.request

        url = args.url.rstrip("/") + "/rspc/telemetry.serve"
        req = urllib.request.Request(url, data=b"{}", method="POST",
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                doc = json.loads(resp.read().decode()).get("result")
        except (urllib.error.URLError, OSError, ValueError) as e:
            print(f"serve-status: cannot reach {url}: {e}", file=sys.stderr)
            print("is a node running? start one with `serve`", file=sys.stderr)
            return 1
        _write_or_print(json.dumps(doc, indent=2), args.out)
        return 0
    if not args.data_dir:
        print("serve-status: give --url or --data-dir", file=sys.stderr)
        return 1

    async def idle() -> dict:
        from .node.node import Node
        from .serve import runtime_for

        node = Node(args.data_dir, with_labeler=False)  # never started: no device work
        try:
            serve = runtime_for(node)
            return {"enabled": False} if serve is None else {"enabled": True,
                                                             **serve.snapshot()}
        finally:
            await node.shutdown()

    _write_or_print(json.dumps(asyncio.run(idle()), indent=2, default=str), args.out)
    return 0


def cmd_desktop(args: argparse.Namespace) -> int:
    from . import desktop

    if args.register:
        print(f"registered {desktop.register_xdg()}")
        return 0
    try:
        return asyncio.run(desktop.run_or_forward(
            args.data_dir, open_path=args.open_path, quit_running=args.quit,
            host=args.host, port=args.port, open_browser=not args.no_open,
            device=args.device,
        ))
    except KeyboardInterrupt:
        return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m spacedrive_tpu_torch")
    parser.add_argument(
        "--faults", metavar="PLAN", default=None,
        help="arm the fault-injection plane for this invocation (chaos testing): "
             "\"point:mode[:k=v,...][;...]\" (utils/faults.py); SD_FAULTS and "
             "SD_FAULT_SEED are the env equivalents",
    )
    parser.add_argument("--fault-seed", type=int, default=0,
                        help="deterministic seed for --faults probabilities")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("index", help="index a directory: cas_ids, thumbnails, embeddings")
    p.add_argument("path")
    p.add_argument("--data-dir", required=True,
                   help="where thumbnails/ (and, with --library, libraries/) is written")
    p.add_argument("--library", default=None,
                   help="index into this library (created if absent) through the job chain")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--no-p2p", action="store_true",
                   help="with --library: start the node without its P2P manager")
    p.set_defaults(func=cmd_index)

    du = sub.add_parser("duplicates", help="find duplicate images in a library")
    du.add_argument("--data-dir", required=True)
    du.add_argument("--library", default="default")
    du.add_argument("--threshold", type=int, default=8)
    du.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    du.set_defaults(func=cmd_duplicates)

    se = sub.add_parser("search", help="search an indexed library")
    se.add_argument("query", help="name substring; with --semantic, an image path or a "
                    "stored label name")
    se.add_argument("--data-dir", required=True)
    se.add_argument("--library", default="default")
    se.add_argument("--semantic", action="store_true",
                    help="vector-index cosine top-k instead of a name match")
    se.add_argument("--take", type=int, default=10)
    se.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    se.set_defaults(func=cmd_search)

    su = sub.add_parser("status", help="node state and each library's recent jobs")
    su.add_argument("--data-dir", required=True)
    su.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    su.set_defaults(func=cmd_status)

    br = sub.add_parser("browse", help="ephemeral (non-indexed) listing of a directory")
    br.add_argument("path")
    br.add_argument("--data-dir", required=True)
    br.add_argument("--hidden", action="store_true")
    br.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    br.set_defaults(func=cmd_browse)

    lb = sub.add_parser("labeler", help="image-labeler model artifacts")
    lbs = lb.add_subparsers(dest="labeler_cmd", required=True)
    st = lbs.add_parser("status", help="show the provisioned model artifact")
    st.add_argument("--data-dir", required=True)
    lp = lbs.add_parser("provision", help="install a model: the bundled one, a local file "
                        "or a download")
    lp.add_argument("--data-dir", required=True)
    lp.add_argument("--from", dest="src",
                    help="local .onnx classifier or .npz checkpoint to import")
    lp.add_argument("--bundled", action="store_true",
                    help="install the in-package sha256-pinned checkpoint (no network)")
    lp.add_argument("--url", default=None,
                    help="ONNX download URL (default: the official YOLOv8n release asset)")
    lp.add_argument("--sha256", default=None,
                    help="pin the artifact's sha256; a mismatch aborts before install")
    lp.add_argument("--classes",
                    help="text file of class names, one per line (stored as classes.json)")
    lp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where an ONNX model's smoke inference runs")
    lt = lbs.add_parser("train", help="train a checkpoint on a folder-per-class dataset")
    lt.add_argument("dataset", help="root dir: <root>/<class_name>/*.jpg")
    lt.add_argument("--data-dir", required=True)
    lt.add_argument("--out", help="checkpoint path (default: <data-dir>/image_labeler/weights.npz)")
    lt.add_argument("--image-size", type=int, default=96)
    lt.add_argument("--batch-size", type=int, default=32)
    lt.add_argument("--steps", type=int, default=600)
    lt.add_argument("--lr", type=float, default=1e-3)
    lt.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ld = lbs.add_parser("train-demo", help="self-contained demo: train on bundled digit scans")
    ld.add_argument("--data-dir", required=True)
    ld.add_argument("--out", help="checkpoint path (default: <data-dir>/image_labeler/weights.npz)")
    ld.add_argument("--steps", type=int, default=300)
    ld.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    lb.set_defaults(func=cmd_labeler)

    te = sub.add_parser("trace-export", help="a running node's span ring as Perfetto-loadable "
                        "Chrome-trace JSON")
    te.add_argument("--url", default="http://127.0.0.1:8080", help="the node's HTTP API origin")
    te.add_argument("--trace-id", default=None, help="filter to one trace id (hex)")
    te.add_argument("--out", help="write JSON here instead of stdout")
    te.set_defaults(func=cmd_trace_export)

    pf = sub.add_parser("profile", help="a running node's host profile: frame groups, on-CPU "
                        "vs GIL-wait split, capture windows (flamegraph.pl text with --folded)")
    pf.add_argument("--url", default="http://127.0.0.1:8080", help="the node's HTTP API origin")
    pf.add_argument("--peer", default=None, metavar="IDENTITY",
                    help="pull a mesh peer's profile over the TELEMETRY wire (library "
                         "members only), from a node on --data-dir")
    pf.add_argument("--folded", action="store_true",
                    help="flamegraph.pl collapsed-stack text instead of the JSON document")
    pf.add_argument("--data-dir", default=None, help="with --peer: the dialing node's data dir")
    pf.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    pf.add_argument("--wait", type=float, default=3.0,
                    help="discovery settle time before dialing --peer")
    pf.add_argument("--out", help="write output here instead of stdout")
    pf.set_defaults(func=cmd_profile)

    db = sub.add_parser("debug-bundle", help="redacted diagnostic bundle: config (secrets "
                        "stripped), metrics, spans, flight-recorder rings, profile, versions/env")
    db.add_argument("--data-dir", default=None, help="build offline from this data dir")
    db.add_argument("--url", default=None,
                    help="pull the bundle from a running node instead of building it offline")
    db.add_argument("--peer", default=None, metavar="IDENTITY",
                    help="pull a mesh peer's bundle (redacted on the owning node; the peer "
                         "must have remoteRspc enabled), from a node on --data-dir")
    db.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    db.add_argument("--wait", type=float, default=3.0,
                    help="discovery settle time before dialing --peer")
    db.add_argument("--out", help="write JSON here instead of stdout")
    db.set_defaults(func=cmd_debug_bundle)

    at = sub.add_parser("attrib", help="critical-path attribution: where the last pass's "
                        "wall-clock went (device / host_cpu / link / queue_wait / gap)")
    at.add_argument("trace_id", nargs="?", default=None,
                    help="trace id (hex; default: the last completed pass)")
    at.add_argument("--url", default="http://127.0.0.1:8080", help="the node's HTTP API origin")
    at.add_argument("--refresh", action="store_true", help="bypass the report cache")
    at.add_argument("--out", help="write JSON here instead of stdout")
    at.set_defaults(func=cmd_attrib)

    so = sub.add_parser("slo", help="SLO burn-rate posture: per-objective status over the "
                        "persistent telemetry history (multi-window burn rates)")
    so.add_argument("--url", default=None,
                    help="read a running node's rspc telemetry.slo instead of evaluating "
                         "the data dir's history offline")
    so.add_argument("--data-dir", default=None, help="evaluate this data dir's history")
    so.add_argument("--out", help="write JSON here instead of stdout")
    so.set_defaults(func=cmd_slo)

    tn = sub.add_parser("tenants", help="per-tenant accounting: heavy-hitter sketches per "
                        "surface, fairness index, dominant share (hashed tenant labels)")
    tn.add_argument("--url", default=None,
                    help="read a running node's GET /tenants instead of booting a mesh node")
    tn.add_argument("--peer", default=None, metavar="LABEL",
                    help="show one mesh peer's federated tenant digest (peer_label or "
                         "identity prefix)")
    tn.add_argument("--data-dir", default=None, help="the mesh node's data dir")
    tn.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    tn.add_argument("--wait", type=float, default=3.0, help="discovery settle time")
    tn.add_argument("--out", help="write JSON here instead of stdout")
    tn.set_defaults(func=cmd_tenants)

    ms = sub.add_parser("mesh-status", help="mesh-wide observability: this node's health, "
                        "metrics and ring digests and every peer's snapshot")
    ms.add_argument("--url", default=None,
                    help="read a running node's GET /mesh instead of booting a mesh node")
    ms.add_argument("--no-refresh", action="store_true",
                    help="with --url: serve the cached mesh view without re-pulling peers")
    ms.add_argument("--data-dir", default=None, help="the mesh node's data dir")
    ms.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ms.add_argument("--wait", type=float, default=3.0, help="discovery settle time")
    ms.add_argument("--out", help="write JSON here instead of stdout")
    ms.set_defaults(func=cmd_mesh_status)

    pe = sub.add_parser("peers", help="discover and list mesh peers")
    pa = sub.add_parser("pair", help="join a peer's library")
    pa.add_argument("identity", help="the peer's identity string (see peers)")
    pa.add_argument("--library", help="library uuid (default: the peer's first)")
    sd = sub.add_parser("spacedrop", help="send files to a peer")
    sd.add_argument("identity")
    sd.add_argument("files", nargs="+")
    for sp, fn in ((pe, cmd_peers), (pa, cmd_pair), (sd, cmd_spacedrop)):
        sp.add_argument("--data-dir", required=True)
        sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
        sp.add_argument("--wait", type=float, default=3.0, help="discovery settle time")
        sp.set_defaults(func=fn)

    cr = sub.add_parser("crypto", help="encrypted-file tools")
    crs = cr.add_subparsers(dest="crypto_cmd", required=True)
    for name in ("inspect", "encrypt", "decrypt"):
        c = crs.add_parser(name)
        c.add_argument("file")
        if name != "inspect":
            c.add_argument("--password")
    cr.set_defaults(func=cmd_crypto)

    rl = sub.add_parser("relay", help="run the standalone sync relay + P2P rendezvous")
    rl.add_argument("--host", default="0.0.0.0")
    rl.add_argument("--port", type=int, default=8490)
    rl.add_argument("--p2p-port", type=int, default=8491)
    rl.add_argument("--max-pipes-per-target", type=int, default=8,
                    help="concurrent relayed pipes per listening identity")
    rl.add_argument("--max-pipes", type=int, default=256,
                    help="concurrent relayed pipes across the relay")
    rl.add_argument("--pipe-rate", type=int, default=None, metavar="BYTES_PER_S",
                    help="per-direction byte-rate cap per pipe (default unlimited)")
    rl.add_argument("--stats-interval", type=float, default=60.0,
                    help="seconds between stats log lines (0 disables)")
    rl.set_defaults(func=cmd_relay)

    sv = sub.add_parser("serve", help="run the node and its HTTP API")
    sv.add_argument("--data-dir", required=True)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8080)
    sv.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sv.add_argument("--auto-accept-pairing", action="store_true",
                    help="headless nodes: accept library joins without a prompt")
    sv.add_argument("--cloud", metavar="ORIGIN",
                    help="enable cloud sync for all libraries against this relay")
    sv.set_defaults(func=cmd_serve)

    ss = sub.add_parser("serve-status", help="serve-layer posture: admission-gate mode, "
                        "per-class inflight/shed counts, read-cache occupancy")
    ss.add_argument("--url", default=None,
                    help="read a running node's rspc telemetry.serve")
    ss.add_argument("--data-dir", default=None,
                    help="without --url: an idle node on this data dir")
    ss.add_argument("--out", help="write JSON here instead of stdout")
    ss.set_defaults(func=cmd_serve_status)

    dk = sub.add_parser("desktop", help="managed desktop host: single instance, browser UI, "
                        "deep links, background node")
    dk.add_argument("--data-dir", required=True)
    dk.add_argument("--host", default="127.0.0.1")
    dk.add_argument("--port", type=int, default=0)
    dk.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dk.add_argument("--open-path", default=None, metavar="PATH",
                    help="open the explorer on PATH (targets the running instance if any)")
    dk.add_argument("--no-open", action="store_true", help="don't launch a browser")
    dk.add_argument("--quit", action="store_true",
                    help="stop the running instance for this data dir")
    dk.add_argument("--register", action="store_true",
                    help="write the XDG launcher/'Open with' entry and exit")
    dk.set_defaults(func=cmd_desktop)

    li = sub.add_parser("licenses", help="dependency and license inventory")
    li.add_argument("--out", help="write JSON here instead of stdout")
    li.set_defaults(func=cmd_licenses)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from .utils import faults as _faults

    if args.faults:
        _faults.install(_faults.FaultPlan.parse(args.faults, seed=args.fault_seed))
    else:
        _faults.install_from_env()
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
