"""Stage-typed shard execution: the per-stage legs of the execution
continuum (``parallel/scheduler.py``).

Counterpart of `spacedrive_tpu/location/indexer/stages.py`.
``location/indexer/mesh.py`` runs the identify stage; this module runs
the others (thumbnails, media extraction, duplicates pHash, semantic
embeddings), so a WORK shard of any stage executes the same way on
every node:

1. **journal first**: every executor consults its own index journal
   before touching a byte (a warm peer serves its vouched thumb, pHash
   or vector from its own store or DB);
2. **pool middle**: the stage's CPU leg (webp encode, gray decode,
   embed decode) ships to the executor's process pool, and any pool
   failure runs the same function inline;
3. **device legs on the Node's device**: the pHash DCT through
   `ops/phash_torch` and one padded embed forward through
   `ops/embed_torch`;
4. **idempotent results**: per-file results ship back in ``complete``
   and merge through :func:`apply_stage_results`; deterministic content
   (the same webp encoder, seed-derived embed weights, the same DCT)
   makes a re-stolen or double-leased shard converge;
5. **vouch last**: journal vouches follow the durable commit.

The embed stage also writes the CRDT ops a local pass would
(``sync.shared_create``), so vectors reach peers that took no part.
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid
from typing import Any, Callable

import torch

from ...files.isolated_path import full_path_from_db_row
from ...parallel import scheduler as _scheduler
from ...telemetry import span
from . import journal as _journal

logger = logging.getLogger(__name__)


# --- shard building (coordinator) -----------------------------------------


_THUMBABLE: tuple[str, ...] | None = None
_MEDIA_EXTS: tuple[str, ...] | None = None
_IMAGE_EXTS: tuple[str, ...] | None = None


def _ext_sets() -> tuple[tuple[str, ...], tuple[str, ...], tuple[str, ...]]:
    global _THUMBABLE, _MEDIA_EXTS, _IMAGE_EXTS
    if _THUMBABLE is None:
        from ...object.media.job import (
            MEDIA_DATA_EXTENSIONS,
            THUMBNAILABLE_EXTENSIONS,
        )
        from ...object.media.thumbnail.host import IMAGE_EXTENSIONS

        _THUMBABLE = tuple(THUMBNAILABLE_EXTENSIONS)
        _MEDIA_EXTS = tuple(MEDIA_DATA_EXTENSIONS)
        _IMAGE_EXTS = tuple(IMAGE_EXTENSIONS)
    return _THUMBABLE, _MEDIA_EXTS, _IMAGE_EXTS


def build_stage_entries(library: Any, location: dict,
                        stage_id: str) -> list[dict]:
    """Journal-keyed entries for one stage of a location — the same
    work-list the stage's local job would build (identified rows with
    the stage's input available), each entry carrying everything an
    executor needs without waiting on row sync: the file-path key, the
    cas, and the deterministic object pub."""
    if stage_id == _scheduler.STAGE_IDENTIFY:
        from .mesh import build_shard_entries

        return build_shard_entries(library, location)
    thumbable, media_exts, image_exts = _ext_sets()
    exts = {
        _scheduler.STAGE_THUMB: thumbable,
        _scheduler.STAGE_MEDIA: media_exts,
        _scheduler.STAGE_PHASH: image_exts,
        _scheduler.STAGE_EMBED: image_exts,
    }[stage_id]
    extra = ""
    if stage_id == _scheduler.STAGE_PHASH:
        # mirror DuplicateDetectorJob's work-list: only objects still
        # missing a pHash (vouched reuse happens executor-side)
        extra = " AND o.phash IS NULL"
    qmarks = ",".join("?" for _ in exts)
    rows = library.db.query(
        f"SELECT fp.pub_id, fp.materialized_path, fp.name, fp.extension, "
        f"fp.cas_id, o.pub_id AS obj_pub "
        f"FROM file_path fp JOIN object o ON fp.object_id = o.id "
        f"WHERE fp.location_id = ? AND fp.is_dir = 0 "
        f"AND fp.cas_id IS NOT NULL AND fp.extension IN ({qmarks})"
        f"{extra} ORDER BY fp.id",
        (location["id"], *exts),
    )
    return [
        {
            "pub_id": r["pub_id"].hex(),
            "mat": r["materialized_path"],
            "name": r["name"],
            "ext": r["extension"] or "",
            "cas_id": r["cas_id"],
            "obj_pub": r["obj_pub"].hex(),
        }
        for r in rows
    ]


def make_stage_session(library: Any, location: dict, stage_ids: list[str], *,
                       shard_files: int | None = None,
                       lease_max_s: float | None = None) -> Any:
    """ONE multi-stage WorkSession covering every requested stage of a
    location: shards carry their stage id, and a single announce fans
    the whole pass out (peers steal whichever stage they are fastest
    at — the board's per-stage rate preference does the matching)."""
    from ...p2p.work import LEASE_MAX_S, WorkSession, WorkShard
    from .mesh import shard_files_default

    n = max(1, shard_files or shard_files_default())
    session = WorkSession(
        id=uuid.uuid4().hex,
        library_id=library.id,
        location_pub=location["pub_id"].hex(),
        lease_max_s=lease_max_s if lease_max_s is not None else LEASE_MAX_S,
    )
    for stage_id in stage_ids:
        spec = _scheduler.spec(stage_id)  # loud on a typo'd stage
        if stage_id == _scheduler.STAGE_EMBED:
            from ...models import embedder as _embedder

            if not _embedder.enabled():
                continue  # SD_EMBED=0: the stage simply publishes nothing
        entries = build_stage_entries(library, location, stage_id)
        for i in range(0, len(entries), n):
            shard_id = f"{session.id[:8]}-{spec.id}-{i // n:04d}"
            session.shards[shard_id] = WorkShard(
                id=shard_id, entries=entries[i:i + n], stage=stage_id,
            )
    return session


# --- per-stage execution (any node) ----------------------------------------


async def execute_stage_shard(
    node: Any, library: Any, location_pub: str | None, stage_id: str,
    entries: list[dict], device: str | torch.device | None = None,
) -> list[dict]:
    """Execute one stage-typed shard against this node's replica —
    the dispatch seam both the mesh worker and the coordinator's
    self-steal ride. Observes the per-stage throughput EWMA the
    control loop sizes leases from."""
    from .mesh import execute_shard, resolve_location, shard_device

    t0 = time.monotonic()
    if stage_id == _scheduler.STAGE_IDENTIFY:
        results = await execute_shard(
            node, library, location_pub, entries, device)
    else:
        fn = _SYNC_EXECUTORS[stage_id]
        location = await resolve_location(library, location_pub)
        results = await asyncio.to_thread(fn, node, library, location,
                                          entries, shard_device(node, device))
    _scheduler.RATES.observe(stage_id, len(entries),
                             time.monotonic() - t0)
    return results


def _consult(journal: Any, loc_id: int, loc_path: str,
             entry: dict) -> tuple[str, Any, str]:
    """One executor-side journal consult for a stage entry. Returns
    ``(verdict, journal_entry, full_path)`` — callers check the
    stage's own vouch field AND that the vouch is for this exact cas
    (count_invalidated=False: the walker already judged changed files
    this pass)."""
    row = {"materialized_path": entry["mat"], "name": entry["name"],
           "extension": entry["ext"], "is_dir": False}
    full = full_path_from_db_row(loc_path, row)
    verdict, jentry = journal.lookup(
        loc_id, (entry["mat"], entry["name"], entry["ext"]),
        _journal.stat_identity(full), count_invalidated=False,
    )
    return verdict, jentry, full


def _object_by_pub(library: Any, obj_pub_hex: str) -> dict | None:
    try:
        return library.db.find_one(
            "object", pub_id=bytes.fromhex(str(obj_pub_hex)))
    except ValueError:
        return None


# --- thumb ------------------------------------------------------------------


def _store_of(node: Any) -> Any:
    return getattr(getattr(node, "thumbnailer", None), "store", None)


def _read_webp(store: Any, lib_id: str, cas_id: str) -> bytes | None:
    path = store.path_for(lib_id, cas_id)
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def _execute_thumb_sync(node: Any, library: Any, location: dict,
                        entries: list[dict], device: torch.device) -> list[dict]:
    """The thumbnail stage leg: journal/store consult → webp generate →
    store write → vouch → ship the webp bytes so the coordinator's store
    converges bit-identical without re-decoding anything.

    The webp comes from the thumbnailer's software path, ``thumb.cpu``
    on the process pool or the same function inline, on every executor
    and whatever its device: that is the stage's design in the JAX
    package too (its leg never reaches the device resize), not a
    fallback, and it keeps every executor's bytes equal."""
    journal = _journal.IndexJournal(library.db)
    loc_id, loc_path = location["id"], location["path"]
    lib_id = str(library.id)
    store = _store_of(node)
    results: list[dict] = []
    pending: list[tuple[dict, dict, tuple, str]] = []  # entry, result, key, path
    for e in entries:
        verdict, jentry, full = _consult(journal, loc_id, loc_path, e)
        key = (e["mat"], e["name"], e["ext"])
        result = {"pub_id": e["pub_id"], "mat": e["mat"], "name": e["name"],
                  "ext": e["ext"], "cas_id": e["cas_id"], "webp": None,
                  "error": None}
        results.append(result)
        if (verdict == _journal.HIT and jentry is not None and jentry.thumb
                and jentry.cas_id == e["cas_id"] and store is not None):
            webp = _read_webp(store, lib_id, e["cas_id"])
            if webp is not None:
                # warm-peer hit: vouched AND verifiably in the store —
                # serve the stored bytes, zero decode work
                result["webp"] = webp
                continue
        pending.append((e, result, key, full))
    if pending:
        pool = _scheduler.pool_for(_scheduler.STAGE_THUMB)
        futures: list[Any] = []
        if pool is not None:
            from ...parallel import procpool as _procpool

            for _e, _r, _k, full in pending:
                ext = _e["ext"]
                try:
                    futures.append(pool.submit(
                        "thumb.cpu", {"path": full, "ext": ext}, rows=1))
                except _procpool.ProcPoolError:
                    futures.append(None)
        else:
            futures = [None] * len(pending)
        from ...object.media.thumbnail.host import (
            ThumbError,
            generate_one_cpu,
        )

        with span("continuum.thumb", nbytes=0):
            for (e, result, key, full), fut in zip(pending, futures):
                webp = err = None
                if fut is not None:
                    try:
                        from ...parallel import procpool as _procpool

                        out = fut.result(_procpool.REQUEST_TIMEOUT_S)
                        webp, err = out.get("webp"), out.get("error")
                    except Exception as exc:  # noqa: BLE001 - degrade inline
                        logger.debug("thumb pool leg failed (%s); inline",
                                     exc)
                        fut = None
                if fut is None and err is None and webp is None:
                    try:
                        webp = generate_one_cpu(full, e["ext"])
                    except (ThumbError, OSError) as exc:
                        err = f"{type(exc).__name__}: {exc}"
                if webp is None:
                    result["error"] = err or "undecodable"
                    continue
                if store is not None:
                    store.write(lib_id, e["cas_id"], webp)
                    # vouch strictly AFTER the webp landed in the store
                    journal.vouch_thumb(loc_id, key, e["cas_id"])
                result["webp"] = webp
    return results


def _apply_thumb(node: Any, library: Any, location: dict,
                 results: list[dict]) -> int:
    """Coordinator merge: land the shipped webp bytes in OUR store and
    vouch — idempotent (same deterministic bytes every execution), so
    duplicate completions re-write identical content."""
    journal = _journal.IndexJournal(library.db)
    loc_id = location["id"]
    lib_id = str(library.id)
    store = _store_of(node)
    applied = 0
    for r in results:
        webp, cas_id = r.get("webp"), r.get("cas_id")
        if not isinstance(webp, (bytes, bytearray)) or not cas_id \
                or store is None:
            continue
        store.write(lib_id, str(cas_id), bytes(webp))
        journal.vouch_thumb(
            loc_id, (r.get("mat", ""), r.get("name", ""), r.get("ext", "")),
            str(cas_id),
        )
        applied += 1
    return applied


# --- media.extract ----------------------------------------------------------


def _commit_media(library: Any, journal: Any, loc_id: int, key: tuple,
                  cas_id: str, obj_pub: str, cols: dict | None) -> None:
    """Land one extracted media row locally + vouch. The digest is
    computed NODE-LOCALLY (cols + this replica's object_id) so each
    node's journal carries exactly what its own local pass would have
    written. ``cols=None`` = probed-nothing-extractable: still a vouch
    (empty digest), so warm passes stop re-probing."""
    from ...object.media.job import _media_digest

    if cols is None:
        journal.vouch_media(loc_id, key, cas_id, "")
        return
    obj = _object_by_pub(library, obj_pub)
    if obj is None:
        return  # object row not replicated yet: the peer's vouch stands
    library.db.upsert("media_data", {"object_id": obj["id"]}, **cols)
    journal.vouch_media(
        loc_id, key, cas_id,
        _media_digest({**cols, "object_id": obj["id"]}),
    )


def _execute_media_sync(node: Any, library: Any, location: dict,
                        entries: list[dict], device: torch.device) -> list[dict]:
    """The media-extraction leg: journal consult → EXIF/video probe →
    local media_data upsert + vouch → ship the extracted columns (the
    row is a local-only table, so results are the ONLY carrier)."""
    from ...object.media.media_data import ImageMetadata, VideoMetadata
    from ...object.media.thumbnail.host import VIDEO_EXTENSIONS

    journal = _journal.IndexJournal(library.db)
    loc_id, loc_path = location["id"], location["path"]
    results: list[dict] = []
    for e in entries:
        verdict, jentry, full = _consult(journal, loc_id, loc_path, e)
        key = (e["mat"], e["name"], e["ext"])
        result = {"pub_id": e["pub_id"], "mat": e["mat"], "name": e["name"],
                  "ext": e["ext"], "cas_id": e["cas_id"],
                  "obj_pub": e["obj_pub"], "cols": None, "probed": False}
        results.append(result)
        if (verdict == _journal.HIT and jentry is not None
                and jentry.media_digest is not None
                and jentry.cas_id == e["cas_id"]):
            # warm hit: serve the already-extracted row from OUR db
            obj = _object_by_pub(library, e["obj_pub"])
            row = (
                library.db.find_one("media_data", object_id=obj["id"])
                if obj is not None else None
            )
            if row is not None:
                result["cols"] = {
                    k: row[k] for k in row.keys()
                    if k not in ("id", "object_id")
                }
                result["probed"] = True
                continue
            if jentry.media_digest == "":
                result["probed"] = True
                continue  # vouched "nothing extractable": nothing to ship
        ext = (e["ext"] or "").lower()
        meta = (
            VideoMetadata.from_path(full) if ext in VIDEO_EXTENSIONS
            else ImageMetadata.from_path(full)
        )
        result["probed"] = True
        if meta is None:
            _commit_media(library, journal, loc_id, key, e["cas_id"],
                          e["obj_pub"], None)
            continue
        cols = {k: v for k, v in meta.to_row(0).items() if k != "object_id"}
        result["cols"] = cols
        _commit_media(library, journal, loc_id, key, e["cas_id"],
                      e["obj_pub"], cols)
    return results


def _apply_media(node: Any, library: Any, location: dict,
                 results: list[dict]) -> int:
    journal = _journal.IndexJournal(library.db)
    loc_id = location["id"]
    applied = 0
    for r in results:
        if not r.get("probed"):
            continue
        key = (r.get("mat", ""), r.get("name", ""), r.get("ext", ""))
        cols = r.get("cols")
        _commit_media(library, journal, loc_id, key, str(r.get("cas_id")),
                      str(r.get("obj_pub", "")),
                      dict(cols) if isinstance(cols, dict) else None)
        applied += 1
    return applied


# --- phash ------------------------------------------------------------------


def _inline_gray(full: str | None, thumb_path: str | None) -> Any:
    """Inline fallback: the EXACT decode the pool stage runs
    (procworker._stage_phash_gray is pure), so pooled and inline grays
    are bit-identical."""
    import numpy as np

    from ...ops.phash_gray import DCT_SIZE
    from ...parallel.procworker import _stage_phash_gray

    blob = _stage_phash_gray(
        {"path": full, "thumb_path": thumb_path})["gray"]
    if blob is None:
        return None
    return np.frombuffer(blob, np.float32).reshape(
        DCT_SIZE, DCT_SIZE).copy()


def _commit_phash(library: Any, journal: Any, loc_id: int, key: tuple,
                  cas_id: str, obj_pub: str, ph: bytes) -> None:
    obj = _object_by_pub(library, obj_pub)
    if obj is None:
        # no object row on this replica (op ingest still in flight):
        # don't vouch what wasn't committed — the stage recomputes on
        # a replica that can land it
        return
    library.db.execute(
        "UPDATE object SET phash = ? WHERE id = ?", (ph, obj["id"]))
    # vouch after the phash row committed
    journal.record_phash(loc_id, key, cas_id, ph)


def _execute_phash_sync(node: Any, library: Any, location: dict,
                        entries: list[dict], device: torch.device) -> list[dict]:
    """The duplicates-pHash leg: journal-vouched reuse → gray decode
    (procpool ``phash.gray``, inline fallback) → ONE device DCT batch →
    local object.phash update + vouch → ship the 8-byte hashes."""
    import numpy as np

    from ...ops import phash_torch
    from ...ops.phash_gray import DCT_SIZE

    journal = _journal.IndexJournal(library.db)
    loc_id, loc_path = location["id"], location["path"]
    lib_id = str(library.id)
    store = _store_of(node)
    results: list[dict] = []
    to_hash: list[tuple[dict, dict, tuple, Any]] = []
    pool = _scheduler.pool_for(_scheduler.STAGE_PHASH)
    futures: list[Any] = []
    pend: list[tuple[dict, dict, tuple, str, str | None]] = []
    for e in entries:
        verdict, jentry, full = _consult(journal, loc_id, loc_path, e)
        key = (e["mat"], e["name"], e["ext"])
        result = {"pub_id": e["pub_id"], "mat": e["mat"], "name": e["name"],
                  "ext": e["ext"], "cas_id": e["cas_id"],
                  "obj_pub": e["obj_pub"], "phash": None}
        results.append(result)
        if (verdict == _journal.HIT and jentry is not None
                and jentry.phash is not None
                and jentry.cas_id == e["cas_id"]):
            result["phash"] = jentry.phash
            _commit_phash(library, journal, loc_id, key, e["cas_id"],
                          e["obj_pub"], jentry.phash)
            continue
        thumb_path = (
            store.path_for(lib_id, e["cas_id"]) if store is not None else None
        )
        pend.append((e, result, key, full, thumb_path))
    if pool is not None:
        from ...parallel import procpool as _procpool

        for _e, _r, _k, full, thumb_path in pend:
            try:
                futures.append(pool.submit(
                    "phash.gray", {"path": full, "thumb_path": thumb_path},
                    rows=1))
            except _procpool.ProcPoolError:
                futures.append(None)
    else:
        futures = [None] * len(pend)
    for (e, result, key, full, thumb_path), fut in zip(pend, futures):
        gray = None
        if fut is not None:
            try:
                from ...parallel import procpool as _procpool

                blob = fut.result(_procpool.REQUEST_TIMEOUT_S)["gray"]
                if blob is not None:
                    gray = np.frombuffer(blob, np.float32).reshape(
                        DCT_SIZE, DCT_SIZE).copy()
            except Exception:  # noqa: BLE001 - degrade inline
                gray = _inline_gray(full, thumb_path)
        else:
            gray = _inline_gray(full, thumb_path)
        if gray is not None:
            to_hash.append((e, result, key, gray))
    if to_hash:
        with span("continuum.phash", nbytes=0):
            hashes = phash_torch.phash_batch(
                np.stack([g for _e, _r, _k, g in to_hash]), device)
        for (e, result, key, _g), h in zip(to_hash, hashes):
            ph = h.tobytes()
            result["phash"] = ph
            _commit_phash(library, journal, loc_id, key, e["cas_id"],
                          e["obj_pub"], ph)
    return results


def _apply_phash(node: Any, library: Any, location: dict,
                 results: list[dict]) -> int:
    journal = _journal.IndexJournal(library.db)
    loc_id = location["id"]
    applied = 0
    for r in results:
        ph = r.get("phash")
        if not isinstance(ph, (bytes, bytearray)):
            continue
        _commit_phash(
            library, journal, loc_id,
            (r.get("mat", ""), r.get("name", ""), r.get("ext", "")),
            str(r.get("cas_id")), str(r.get("obj_pub", "")), bytes(ph),
        )
        applied += 1
    return applied


# --- embed ------------------------------------------------------------------


def _commit_embed(library: Any, journal: Any, loc_id: int, key: tuple,
                  cas_id: str, obj_pub: str, blob: bytes, *,
                  emit_ops: bool) -> bool:
    """Land one embedding vector locally. The EXECUTING node mints the
    CRDT ops (emit_ops=True) exactly like the local embed stage; the
    complete-receiving coordinator applies directly (emit_ops=False) —
    the executor's ops still arrive through sync and LWW-apply over
    identical bytes (mesh.apply_remote_results precedent)."""
    from ...db.database import now_iso
    from ...models import embedder as _embedder

    obj = _object_by_pub(library, obj_pub)
    if obj is None:
        return False
    stamp = now_iso()

    def db_write(conn) -> None:
        conn.execute(
            "INSERT INTO object_embedding (object_id, vector, dim, "
            "model, date_calculated) VALUES (?,?,?,?,?) "
            "ON CONFLICT (object_id) DO UPDATE SET "
            "vector=excluded.vector, dim=excluded.dim, "
            "model=excluded.model, "
            "date_calculated=excluded.date_calculated",
            (obj["id"], blob, _embedder.EMBED_DIM, _embedder.MODEL_NAME,
             stamp),
        )

    if emit_ops:
        sync = library.sync
        ops = sync.shared_create(
            "object_embedding", obj["pub_id"].hex(),
            [
                ("vector", blob),
                ("dim", _embedder.EMBED_DIM),
                ("model", _embedder.MODEL_NAME),
                ("date_calculated", stamp),
            ],
        )
        sync.write_ops(ops, db_write)
    else:
        with library.db.transaction() as conn:
            db_write(conn)
    # vouch strictly AFTER the durable commit
    journal.vouch_embed(loc_id, key, cas_id)
    return True


def _execute_embed_sync(node: Any, library: Any, location: dict,
                        entries: list[dict], device: torch.device) -> list[dict]:
    """The semantic-embedding leg: journal-vouched reuse → decode
    (procpool ``embed.decode``, inline fallback — same decode_image
    body) → ONE padded device forward → object_embedding rows + CRDT
    ops in one transaction → vouch → ship the vector blobs (derived
    model params are seed-deterministic, so every executor's forward is
    bit-identical)."""
    import numpy as np

    from ...models import embedder as _embedder
    from ...ops import embed_torch

    journal = _journal.IndexJournal(library.db)
    loc_id, loc_path = location["id"], location["path"]
    results: list[dict] = []
    pend: list[tuple[dict, dict, tuple, str]] = []
    for e in entries:
        verdict, jentry, full = _consult(journal, loc_id, loc_path, e)
        key = (e["mat"], e["name"], e["ext"])
        result = {"pub_id": e["pub_id"], "mat": e["mat"], "name": e["name"],
                  "ext": e["ext"], "cas_id": e["cas_id"],
                  "obj_pub": e["obj_pub"], "vector": None}
        results.append(result)
        if (verdict == _journal.HIT and jentry is not None and jentry.embed
                and jentry.cas_id == e["cas_id"]):
            obj = _object_by_pub(library, e["obj_pub"])
            row = (
                library.db.find_one("object_embedding", object_id=obj["id"])
                if obj is not None else None
            )
            if row is not None and row.get("vector"):
                result["vector"] = row["vector"]  # warm hit: serve stored
                continue
        pend.append((e, result, key, full))
    if not pend:
        return results
    # decode leg: pooled in one quantum-shaped batch, inline fallback
    paths = [full for _e, _r, _k, full in pend]
    planes: list[Any] = []
    pool = _scheduler.pool_for(_scheduler.STAGE_EMBED)
    if pool is not None and len(paths) > 1:
        try:
            from ...parallel import procpool as _procpool

            reply = pool.request(
                "embed.decode", {"paths": list(paths)}, rows=len(paths))
            raw_planes = reply["planes"]
            if len(raw_planes) != len(paths):
                raise ValueError("plane count mismatch")
            shape = (_embedder.IMAGE_SIZE, _embedder.IMAGE_SIZE, 3)
            for raw in raw_planes:
                if raw is None:
                    planes.append(None)
                    continue
                arr = np.frombuffer(raw, np.float32)
                if arr.size != int(np.prod(shape)):
                    raise ValueError("plane size mismatch")
                planes.append(arr.reshape(shape))
        except Exception:  # noqa: BLE001 - degrade inline
            planes = []
    if not planes:
        planes = [_embedder.decode_image(p) for p in paths]
    batch: list[tuple[dict, dict, tuple]] = []
    imgs: list[Any] = []
    for (e, result, key, _full), img in zip(pend, planes):
        if img is None:
            continue
        batch.append((e, result, key))
        imgs.append(img)
    if not imgs:
        return results
    with span("continuum.embed", nbytes=0):
        vectors = embed_torch.embed_batch(np.stack(imgs), device)
    for (e, result, key), vec in zip(batch, vectors):
        blob = _embedder.vector_to_blob(vec)
        # ship regardless of the local commit: the executor's replica
        # may not have ingested the object row yet — the coordinator's
        # apply leg owns durability, the local commit + ops are the
        # executor-replica bonus
        result["vector"] = blob
        _commit_embed(library, journal, loc_id, key, e["cas_id"],
                      e["obj_pub"], blob, emit_ops=True)
    from ...object.search import index as _search_index

    _search_index.refresh(library)
    return results


def _apply_embed(node: Any, library: Any, location: dict,
                 results: list[dict]) -> int:
    journal = _journal.IndexJournal(library.db)
    loc_id = location["id"]
    applied = 0
    for r in results:
        blob = r.get("vector")
        if not isinstance(blob, (bytes, bytearray)):
            continue
        if _commit_embed(
            library, journal, loc_id,
            (r.get("mat", ""), r.get("name", ""), r.get("ext", "")),
            str(r.get("cas_id")), str(r.get("obj_pub", "")), bytes(blob),
            emit_ops=False,
        ):
            applied += 1
    if applied:
        from ...object.search import index as _search_index

        _search_index.refresh(library)
    return applied


_SYNC_EXECUTORS: dict[str, Callable] = {
    _scheduler.STAGE_THUMB: _execute_thumb_sync,
    _scheduler.STAGE_MEDIA: _execute_media_sync,
    _scheduler.STAGE_PHASH: _execute_phash_sync,
    _scheduler.STAGE_EMBED: _execute_embed_sync,
}


# --- result merge (coordinator, from `complete` bodies) --------------------


def apply_stage_results(node: Any, session: Any, stage_id: str,
                        results: list[dict]) -> int:
    """Merge a peer's shipped stage-shard results into this node's
    replica — the stage-typed generalization of
    ``mesh.apply_remote_results`` (which still handles identify)."""
    if stage_id == _scheduler.STAGE_IDENTIFY:
        from .mesh import apply_remote_results

        return apply_remote_results(node, session, results)
    library = node.libraries.get(session.library_id)
    if library is None:
        return 0
    location = library.db.find_one(
        "location", pub_id=bytes.fromhex(session.location_pub))
    if location is None:
        return 0
    clean = [r for r in results if isinstance(r, dict)]
    apply_fn = {
        _scheduler.STAGE_THUMB: _apply_thumb,
        _scheduler.STAGE_MEDIA: _apply_media,
        _scheduler.STAGE_PHASH: _apply_phash,
        _scheduler.STAGE_EMBED: _apply_embed,
    }.get(stage_id)
    if apply_fn is None:
        return 0
    return apply_fn(node, library, location, clean)
