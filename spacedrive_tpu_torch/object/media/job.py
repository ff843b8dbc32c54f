"""MediaProcessorJob — thumbnails, media_data rows and embeddings.

Counterpart of `spacedrive_tpu/object/media/job.py`
(ref:core/src/object/media/media_processor/job.rs): init dispatches the
thumbnails to the node-wide thumbnailer actor (:148-170); the steps are
chunks of BATCH_SIZE files of EXIF extraction, a `wait_thumbnails`
rendezvous (:83-88, :199-230), unless SD_EMBED=0 chunks of embedding
forwards on the job's `backend` device ("cuda" or "cpu", or an indexed
device of either, which pins them there), and, when the
node has an image labeler, a `wait_labels` rendezvous with the batch of
every image row init sent it (:176-196). Every thumbnail, media_data
row and embedding is vouched in the index journal after it is durable,
so a warm rescan redoes none of it; labels have no vouch, so every scan
relabels every image row, as in the JAX job.

The embed chunk is the "embed" policy's `embed_chunk_rows(cards)`
(parallel/autotune.py). An embed step's decode rides the process pool
(`embed.decode`, parallel/procpool.py), split one job a worker, when
the pool is up and the chunk holds more than one file, else runs
inline; both run `models/embed_decode.decode_image`, so the planes are
bit-identical, and a pool failure decodes inline.

The job selects every row the thumbnailer can decode
(THUMBNAILABLE_EXTENSIONS: still images, HEIF where libheif loads,
videos, PDFs, SVGs where librsvg loads). EXIF-bearing images and videos
get a media_data row (`ImageMetadata` or `VideoMetadata`,
MEDIA_DATA_EXTENSIONS); only image rows (IMAGE_EXTENSIONS, HEIF among
them) are embedded and labelled, as in the JAX job. A file that fails
to decode is re-dispatched to the thumbnailer by every pass (no
thumbnail, so no vouch), as in the JAX job. Not ported: telemetry. The
stage seconds the JAX job observes into its histograms are added to the
node's totals (`Node.add_stage_seconds`) when the library has a node.
"""

from __future__ import annotations

import asyncio
import hashlib
import time
from typing import Any

import numpy as np
import torch

from ...db.database import blob_u64, escape_like, now_iso
from ...files.isolated_path import full_path_from_db_row as _full_path
from ...files.isolated_path import materialized_prefix
from ...jobs import StatefulJob
from ...jobs.job import JobContext, JobError, StepResult
from ...jobs.manager import register_job
from ...location.indexer import journal as _journal
from ...models import embedder as _embedder
from ...ops import embed_torch
from ...parallel import autotune as _autotune
from ...parallel import procpool as _procpool
from ...parallel.mesh import device_scale
from ..file_identifier.job import check_backend
from ..search import index as _search_index
from .media_data import ImageMetadata, VideoMetadata
from .thumbnail.host import DOC_EXTENSIONS, IMAGE_EXTENSIONS, VIDEO_EXTENSIONS

BATCH_SIZE = 10  # ref:media_processor/job.rs:50

# the decodable subset of the reference's FILTERED_{IMAGE,VIDEO}_
# EXTENSIONS (videos get a keyframe thumbnail, ref:thumbnail/process.rs:463)
THUMBNAILABLE_EXTENSIONS = IMAGE_EXTENSIONS + VIDEO_EXTENSIONS + DOC_EXTENSIONS
EXIF_EXTENSIONS = ("jpg", "jpeg", "png", "tiff", "webp")
# media_data rows: EXIF-bearing images and videos (ref:media_data_extractor.rs)
MEDIA_DATA_EXTENSIONS = EXIF_EXTENSIONS + VIDEO_EXTENSIONS

#: most files in one `embed.decode` job: 64 float32 planes of 224x224x3
#: are 38.5 MB, inside the worker's 64 MiB frame
EMBED_DECODE_JOB_MAX = 64


def _media_digest(cols: dict) -> str:
    """Stable digest of an extracted media_data row — the journal's
    "this metadata is already in the DB" vouch."""
    return hashlib.blake2b(repr(sorted(cols.items())).encode(), digest_size=8).hexdigest()


def _add_seconds(library: Any, stage: str, seconds: float) -> None:
    add = getattr(getattr(library, "node", None), "add_stage_seconds", None)
    if add is not None:
        add(stage, seconds)


def _embed_planes(paths: list[str], fut: Any) -> list[np.ndarray | None]:
    """One `embed.decode` job's planes, or `paths` decoded inline when
    the job could not be shipped (`fut` None) or its round trip tore."""
    if fut is not None:
        try:
            planes = fut.result(_procpool.REQUEST_TIMEOUT_S)["planes"]
            if len(planes) != len(paths):
                raise ValueError("plane count mismatch")
            shape = (_embedder.IMAGE_SIZE, _embedder.IMAGE_SIZE, 3)
            out: list[np.ndarray | None] = []
            for raw in planes:
                if raw is None:
                    out.append(None)
                    continue
                arr = np.frombuffer(raw, np.float32)
                if arr.size != int(np.prod(shape)):
                    raise ValueError("plane size mismatch")
                out.append(arr.reshape(shape))
            return out
        except (_procpool.ProcPoolError, TimeoutError, KeyError, TypeError, ValueError):
            pass  # a torn round trip: the inline leg decodes
    return [_embedder.decode_image(p) for p in paths]


@register_job
class MediaProcessorJob(StatefulJob):
    """init: {location_id, sub_path?, backend?}"""

    NAME = "media_processor"
    INVALIDATES = ("search.paths", "labels.list", "search.semantic")
    IS_BATCHED = True
    _model = None  # runtime-only embedder on the job's device (never serialized)

    async def init_job(self, ctx: JobContext) -> None:
        library = ctx.library
        loc_id = self.init["location_id"]
        location = library.db.find_one("location", id=loc_id)
        if location is None:
            raise JobError(f"location {loc_id} not found")
        backend = check_backend(self.init.get("backend", "cuda"))
        self.data.update(location_id=loc_id, location_path=location["path"], backend=backend)

        qmarks = ",".join("?" for _ in THUMBNAILABLE_EXTENSIONS)
        sub_filter = ""
        params: list[Any] = [loc_id, *THUMBNAILABLE_EXTENSIONS]
        if self.init.get("sub_path"):
            sub_filter = " AND materialized_path LIKE ? ESCAPE '\\'"
            params.append(escape_like(materialized_prefix(self.init["sub_path"])) + "%")
        rows = library.db.query(
            "SELECT id, pub_id, cas_id, object_id, materialized_path, name, "
            "extension, size_in_bytes_bytes "
            "FROM file_path WHERE location_id = ? AND is_dir = 0 "
            "AND object_id IS NOT NULL AND cas_id IS NOT NULL "
            f"AND extension IN ({qmarks}){sub_filter}",
            tuple(params),
        )

        # consult the journal per row BEFORE dispatching work: a fresh
        # entry vouching this exact cas_id skips the thumbnail, the EXIF
        # re-extract and the embed. Off the loop: one stat and one
        # SELECT per media file.
        journal = _journal.IndexJournal(library.db)
        loc_path = self.data["location_path"]

        def consult_all() -> dict[int, _journal.JournalEntry | None]:
            out: dict[int, _journal.JournalEntry | None] = {}
            for r in rows:
                # count_invalidated=False: the walker already judged
                # changed files this pass
                verdict, entry = journal.lookup(
                    loc_id, _journal.key_of(r),
                    _journal.stat_identity(_full_path(loc_path, r)),
                    count_invalidated=False,
                )
                out[r["id"]] = (entry if verdict == _journal.HIT and entry is not None
                                and entry.cas_id == r["cas_id"] else None)
            return out

        vouched = await asyncio.to_thread(consult_all)

        def skip(r: dict) -> None:
            journal.bytes_saved(blob_u64(r["size_in_bytes_bytes"]) or 0, location_id=loc_id)

        # the thumbnails go to the node's actor up front
        # (ref:job.rs:148-156); the job only awaits them later
        thumbnailer = getattr(getattr(library, "node", None), "thumbnailer", None)
        dispatched = 0
        thumb_batch_id = 0
        thumb_vouch: list[list] = []  # keys to vouch after the rendezvous
        if thumbnailer is not None and rows:
            batch = []
            for r in rows:
                entry = vouched[r["id"]]
                if entry is not None and entry.thumb:
                    skip(r)
                    continue
                batch.append((r["cas_id"], _full_path(loc_path, r)))
                thumb_vouch.append([*_journal.key_of(r), r["cas_id"]])
            if batch:
                thumb_batch_id = thumbnailer.new_indexed_thumbnails_batch(
                    library.id, batch, background=False)
            dispatched = len(batch)
        self.data["thumbs_dispatched"] = dispatched

        exif_rows = []
        for r in rows:
            if (r["extension"] or "").lower() not in MEDIA_DATA_EXTENSIONS:
                continue
            entry = vouched[r["id"]]
            if entry is not None and entry.media_digest is not None:
                skip(r)
                continue
            exif_rows.append(r)
        for i in range(0, len(exif_rows), BATCH_SIZE):
            chunk = exif_rows[i:i + BATCH_SIZE]
            self.steps.append({"kind": "extract_media_data",
                               "ids": [(r["id"], r["object_id"]) for r in chunk]})
        if dispatched:
            self.steps.append({
                "kind": "wait_thumbnails",
                "count": dispatched,
                "batch_id": thumb_batch_id,
                # vouched AFTER the rendezvous, and only for thumbnails
                # verifiably in the store: the journal never claims a
                # thumbnail a crash swallowed
                "vouch": thumb_vouch,
            })
        # SD_EMBED=0: no steps, no DB writes, no sync ops
        if _embedder.enabled():
            embed_rows = []
            for r in rows:
                if (r["extension"] or "").lower() not in IMAGE_EXTENSIONS:
                    continue
                entry = vouched[r["id"]]
                if entry is not None and entry.embed:
                    skip(r)  # unchanged bytes are never re-read or re-embedded
                    continue
                embed_rows.append(r)
            chunk_rows = _autotune.policy("embed").embed_chunk_rows(device_scale(backend))
            for i in range(0, len(embed_rows), chunk_rows):
                chunk = embed_rows[i:i + chunk_rows]
                self.steps.append({"kind": "embed",
                                   "ids": [(r["id"], r["object_id"]) for r in chunk]})

        # every image row goes to the node's labeler actor on every scan
        # (no journal vouch, as in the JAX job: the label_on_object
        # upserts make a relabel idempotent); a step awaits the batch
        labeler = getattr(getattr(library, "node", None), "image_labeler", None)
        label_rows = [r for r in rows if (r["extension"] or "").lower() in IMAGE_EXTENSIONS]
        if labeler is not None and label_rows:
            batch_id = labeler.new_batch(library, [
                {"file_path_id": r["id"], "object_id": r["object_id"],
                 "path": _full_path(loc_path, r)}
                for r in label_rows
            ])
            self.steps.append({"kind": "wait_labels", "batch_id": batch_id})

        self.run_metadata.update(
            media_data_extracted=0, media_data_skipped=0,
            thumbnails_dispatched=dispatched, embeddings_written=0,
        )
        ctx.progress(message=f"processing media for {len(rows)} files", phase="media")

    async def execute_step(self, ctx: JobContext, step: dict, step_number: int) -> StepResult:
        kind = step["kind"]
        if kind == "extract_media_data":
            return await asyncio.to_thread(self._extract_media_data, ctx, step)
        if kind == "embed":
            # decode, device forward and commit all block; the loop
            # keeps serving the thumbnailer meanwhile
            return await asyncio.to_thread(self._embed_files, ctx, step)
        if kind == "wait_thumbnails":
            return await self._wait_thumbnails(ctx, step)
        if kind == "wait_labels":
            return await self._wait_labels(ctx, step)
        raise JobError(f"unknown media step {kind!r}")

    def _extract_media_data(self, ctx: JobContext, step: dict) -> StepResult:
        t0 = time.perf_counter()
        library = ctx.library
        loc_path = self.data["location_path"]
        loc_id = self.data["location_id"]
        journal = _journal.IndexJournal(library.db)
        extracted = skipped = 0
        for fp_id, object_id in step["ids"]:
            row = library.db.find_one("file_path", id=fp_id)
            if row is None or object_id is None:
                skipped += 1
                continue
            full = _full_path(loc_path, row)
            if (row["extension"] or "").lower() in VIDEO_EXTENSIONS:
                meta = VideoMetadata.from_path(full)
            else:
                meta = ImageMetadata.from_path(full)
            if meta is None:
                skipped += 1
                # still a vouch: "probed, nothing extractable" — stops
                # warm passes from re-reading EXIF-less files forever
                journal.vouch_media(loc_id, _journal.key_of(row), row["cas_id"], "")
                continue
            cols = meta.to_row(object_id)
            library.db.upsert("media_data", {"object_id": object_id},
                              **{k: v for k, v in cols.items() if k != "object_id"})
            extracted += 1
            # vouched after the media_data upsert committed
            journal.vouch_media(loc_id, _journal.key_of(row), row["cas_id"], _media_digest(cols))
        _add_seconds(library, "media_data", time.perf_counter() - t0)
        md = self.run_metadata
        return StepResult(metadata={
            "media_data_extracted": md["media_data_extracted"] + extracted,
            "media_data_skipped": md["media_data_skipped"] + skipped,
        })

    def _embed_files(self, ctx: JobContext, step: dict) -> StepResult:
        """One embedding chunk: decode inline → one device forward on the
        job's backend → object_embedding rows and their CRDT ops in ONE
        `sync.write_ops` transaction → journal vouches, strictly after
        that commit → search index refresh."""
        library = ctx.library
        loc_path = self.data["location_path"]
        loc_id = self.data["location_id"]

        t0 = time.perf_counter()
        found: list[tuple[dict, int]] = []
        for fp_id, object_id in step["ids"]:
            row = library.db.find_one("file_path", id=fp_id)
            if row is not None and object_id is not None:
                found.append((row, object_id))
        planes = self._decode_for_embed([_full_path(loc_path, row) for row, _ in found])
        batch_rows: list[tuple[dict, int]] = []
        batch_imgs: list[np.ndarray] = []
        for (row, object_id), img in zip(found, planes):
            if img is not None:
                batch_rows.append((row, object_id))
                batch_imgs.append(img)
        _add_seconds(library, "embed_decode", time.perf_counter() - t0)
        if not batch_imgs:
            return StepResult()

        t0 = time.perf_counter()
        device = torch.device(self.data["backend"])
        if self._model is None:
            self._model = _embedder.PatchPoolEmbedder(device)
        vectors = embed_torch.embed_batch(np.stack(batch_imgs), device, self._model)
        _add_seconds(library, "embed_forward", time.perf_counter() - t0)

        t0 = time.perf_counter()
        sync = library.sync
        stamp = now_iso()
        ops = []
        writes: list[tuple[int, bytes]] = []
        for (_row, object_id), vec in zip(batch_rows, vectors):
            obj = library.db.find_one("object", id=object_id)
            if obj is None:
                continue
            blob = _embedder.vector_to_blob(vec)
            writes.append((object_id, blob))
            ops.extend(sync.shared_create(
                "object_embedding", obj["pub_id"].hex(),
                [("vector", blob), ("dim", _embedder.EMBED_DIM),
                 ("model", _embedder.MODEL_NAME), ("date_calculated", stamp)],
            ))

        def db_writes(conn) -> None:
            conn.executemany(
                "INSERT INTO object_embedding (object_id, vector, dim, model, date_calculated) "
                "VALUES (?,?,?,?,?) ON CONFLICT (object_id) DO UPDATE SET "
                "vector=excluded.vector, dim=excluded.dim, model=excluded.model, "
                "date_calculated=excluded.date_calculated",
                [(object_id, blob, _embedder.EMBED_DIM, _embedder.MODEL_NAME, stamp)
                 for object_id, blob in writes],
            )

        if writes:
            sync.write_ops(ops, db_writes)
            # vouches after the durable commit: a crash in between
            # re-embeds once, never vouches a missing row
            journal = _journal.IndexJournal(library.db)
            for row, _object_id in batch_rows:
                journal.vouch_embed(loc_id, _journal.key_of(row), row["cas_id"])
            _search_index.refresh(library)
        _add_seconds(library, "embed_write", time.perf_counter() - t0)
        return StepResult(metadata={
            "embeddings_written": self.run_metadata.get("embeddings_written", 0) + len(writes),
        })

    @staticmethod
    def _decode_for_embed(paths: list[str]) -> list[np.ndarray | None]:
        """The embed decode leg: pooled when the process pool is up and
        there is more than one path (stage `embed.decode`), else inline;
        both run `decode_image`, so the planes are bit-identical. The
        chunk is split into one job per worker, each of at most the
        embed policy's pool quantum and EMBED_DECODE_JOB_MAX files, so
        the workers decode it side by side. A job whose round trip tears
        decodes its files inline (the pool counts the failure)."""
        pool = _procpool.get()
        if pool is None or len(paths) <= 1:
            return [_embedder.decode_image(p) for p in paths]
        per = min(-(-len(paths) // max(1, pool.worker_count())),
                  _autotune.policy("embed").procpool_batch_rows(), EMBED_DECODE_JOB_MAX)
        parts = [paths[i:i + per] for i in range(0, len(paths), per)]
        futs = []
        for part in parts:
            try:
                futs.append(pool.submit("embed.decode", {"paths": part}, rows=len(part)))
            except _procpool.ProcPoolError:
                futs.append(None)
        out: list[np.ndarray | None] = []
        for part, fut in zip(parts, futs):
            out.extend(_embed_planes(part, fut))
        return out

    async def _wait_thumbnails(self, ctx: JobContext, step: dict) -> StepResult:
        """Rendezvous with the thumbnailer actor for this job's batch
        (ref:job.rs:83-88 WaitThumbnails). A batch that failed on a
        pinned device raises here and fails the job (on an auto device a
        failed chunk degrades to the CPU resize in the actor). After a resume the id is from a
        dead process; `wait_batch` treats unknown ids as done (the actor
        re-queues persisted work on its own).

        Then each dispatched thumbnail that is verifiably in the store
        (`store.exists`, never the actor's counters) is vouched: the
        vouch is ordered after the webp landed on disk."""
        thumbnailer = getattr(getattr(ctx.library, "node", None), "thumbnailer", None)
        if thumbnailer is not None:
            await thumbnailer.wait_batch(step.get("batch_id", 0))
            journal = _journal.IndexJournal(ctx.library.db)
            loc_id = self.data["location_id"]
            lib_id = str(ctx.library.id)
            for mat, name, ext, cas_hex in step.get("vouch", []):
                if thumbnailer.store.exists(lib_id, cas_hex):
                    journal.vouch_thumb(loc_id, (mat, name, ext), cas_hex)
        return StepResult()

    async def _wait_labels(self, ctx: JobContext, step: dict) -> StepResult:
        """Rendezvous with the labeler actor for this job's batch; after a
        resume the id is from a dead process and counts as done (the
        actor re-queues persisted batches on its own)."""
        labeler = getattr(getattr(ctx.library, "node", None), "image_labeler", None)
        if labeler is not None:
            await labeler.wait_batch(step["batch_id"])
        return StepResult()

    async def finalize(self, ctx: JobContext) -> Any:
        ctx.progress(message="media processing complete", phase="done")
        return dict(self.run_metadata)
