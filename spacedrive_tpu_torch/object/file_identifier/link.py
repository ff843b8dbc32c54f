"""Object linking shared by the identifier job and the mesh shard plane.

Two call shapes exist over one invariant (same content ⇒ same object):

- :func:`kind_for_row` — extension → ObjectKind resolution (moved out
  of ``job.py`` so shard execution resolves kinds identically);
- :func:`object_pub_for` — **deterministic** object pub_id derived
  from ``(library_id, cas_id)``. The single-node identifier can mint
  random pub_ids because its own DB query is the dedupe point; a mesh
  pass has no such point — two peers executing a re-stolen shard
  concurrently would each mint a fresh object for the same cas. A
  uuid5 over the library+cas makes both executions emit byte-identical
  ``shared_create("object", …)`` ops, so the HLC/LWW merge converges
  to ONE object row no matter how many times a shard ran;
- :func:`apply_cas_results` — idempotent upsert of shard results
  (cas_id + object link per file_path) through the sync factory:
  rows already carrying the cas are skipped without emitting ops, so
  duplicate completions cost nothing and never bump HLC clocks.

Counterpart of `spacedrive_tpu/object/file_identifier/link.py`, with
its process-pool prep (`link.prep`).
"""

from __future__ import annotations

import uuid
from typing import Any

from ...db.database import now_iso
from ...files.extensions import from_str as ext_from_str
from ...files.kind import ObjectKind

#: uuid5 namespace for deterministic object pub_ids (mesh shard plane)
OBJECT_NS = uuid.UUID("5d0b5e1f-c45e-4a8a-9b7e-8f3a2d6c0001")


def kind_for_row(row: dict) -> ObjectKind:
    """Extension → ObjectKind (full magic-sniff happens in the media
    pipeline where bytes are read)."""
    if row.get("is_dir"):
        return ObjectKind.Folder
    ext = row.get("extension") or ""
    if not ext:
        return ObjectKind.Unknown
    poss = ext_from_str(ext)
    if poss is None:
        return ObjectKind.Unknown
    if poss.known is not None:
        return poss.known.kind
    # conflicting extension: prefer the first conflict's kind
    return poss.conflicts[0].kind


def object_pub_for(library_id: Any, cas_id: str) -> bytes:
    """Deterministic object pub_id for ``(library, cas_id)`` — every
    executor of the same content mints the same object identity."""
    return uuid.uuid5(OBJECT_NS, f"{library_id}:{cas_id}").bytes


#: pub_ids per IN query — one 16-byte blob bind each; stays well under
#: SQLite's default 999-variable limit
_LINK_CHUNK = 400

#: smallest result batch worth a pool round trip for the prep leg
_PREP_POOL_MIN = 32


def prep_inline(lib_id: Any, results: list[dict]) -> list[tuple[int, bytes, str, bytes]]:
    """``(index, fp_pub, cas, deterministic obj_pub)`` per linkable
    result: the prep the pool's ``link.prep`` stage runs too, so pooled
    and inline prep agree by construction."""
    usable: list[tuple[int, bytes, str, bytes]] = []
    for i, res in enumerate(results):
        cas = res.get("cas_id")
        if not cas or not isinstance(cas, str):
            continue  # empty/unreadable files carry no cas to link
        try:
            fp_pub = bytes.fromhex(str(res["pub_id"]))
        except (KeyError, ValueError):
            continue
        usable.append((i, fp_pub, cas, object_pub_for(lib_id, cas)))
    return usable


def _prep_results(lib_id: Any, results: list[dict]) \
        -> list[tuple[dict, bytes, str, bytes]]:
    """``(result, fp_pub, cas, deterministic obj_pub)`` per linkable
    result: apply_cas_results' pure prep, on the process pool (stage
    ``link.prep``) when it is live and the batch is big enough, else
    inline; a failed pool trip runs inline."""
    if len(results) >= _PREP_POOL_MIN:
        from ...parallel import procpool as _procpool

        pool = _procpool.get()
        if pool is not None:
            wire = [{"pub_id": r.get("pub_id"), "cas_id": r.get("cas_id"),
                     "ext": r.get("ext")} for r in results]
            try:
                reply = pool.request(
                    "link.prep", {"library_id": str(lib_id), "results": wire},
                    rows=len(results),
                )
                return [(results[i], bytes(fp_pub), cas, bytes(obj_pub))
                        for i, fp_pub, cas, obj_pub in reply["usable"]]
            except (_procpool.ProcPoolError, KeyError, TypeError,
                    ValueError, IndexError):
                pass  # the inline prep below
    return [(results[i], fp_pub, cas, obj_pub)
            for i, fp_pub, cas, obj_pub in prep_inline(lib_id, results)]


def _rows_by_pub(
    db: Any, table: str, columns: str, pubs: list[bytes], batched: bool,
) -> dict[bytes, dict]:
    """``{pub_id: row}`` for the pubs that exist. ``batched`` fetches
    with chunked ``IN`` queries (one per ~400 pubs); the per-file path
    issues one ``find_one`` per pub — kept as the parity oracle."""
    out: dict[bytes, dict] = {}
    if not batched:
        for pub in pubs:
            row = db.find_one(table, pub_id=pub)
            if row is not None:
                out[bytes(row["pub_id"])] = row
        return out
    for start in range(0, len(pubs), _LINK_CHUNK):
        chunk = pubs[start:start + _LINK_CHUNK]
        placeholders = ",".join("?" for _ in chunk)
        for row in db.query(
            f"SELECT {columns} FROM {table} "
            f"WHERE pub_id IN ({placeholders})",
            chunk,
        ):
            out[bytes(row["pub_id"])] = row
    return out


def apply_cas_results(
    library: Any, results: list[dict], *, emit_ops: bool = True,
    batched: bool = True,
) -> tuple[int, int]:
    """Apply shard results (``{"pub_id": hex, "cas_id": str, "ext":
    str}`` per file) to this replica: create deterministic objects,
    link file_paths, and (for the EXECUTING node) emit the sync ops
    that carry both to the mesh.

    ``emit_ops=False`` is the complete-receiver's mode: the executor
    already minted the authoritative CRDT ops (they are written before
    the ``complete`` is ever sent), so the coordinator applies the same
    values directly — re-emitting them would double the mesh's op
    volume and make every other replica ingest the work twice. The
    executor's ops still arrive through sync and LWW-apply over the
    identical values, so the op log stays the source of truth.

    Idempotent by construction — (a) rows already carrying the cas and
    an object link are skipped entirely, (b) object/file_path rows are
    upserted (placeholder-friendly, like ``sync/apply.py``), so results
    may land before the file_path create ops have synced here, and a
    twice-applied batch emits ops only the first time.

    Returns ``(created_objects, linked_paths)``.
    """
    sync = library.sync
    lib_id = getattr(library, "id", None)
    ops: list = []
    date_created = now_iso()
    to_link: list[tuple[bytes, str, bytes]] = []  # (fp pub, cas, obj pub)
    new_objects: dict[bytes, int] = {}  # obj pub -> kind
    created = linked = 0
    # normalize first, then ONE batched fetch per table
    usable = _prep_results(lib_id, results)
    fp_rows = _rows_by_pub(
        library.db, "file_path", "pub_id, cas_id, object_id",
        [fp for _res, fp, _cas, _obj in usable], batched,
    )
    obj_rows = _rows_by_pub(
        library.db, "object", "pub_id",
        sorted({obj for _res, _fp, _cas, obj in usable}), batched,
    )
    for res, fp_pub, cas, obj_pub in usable:
        row = fp_rows.get(fp_pub)
        if row is not None and row.get("cas_id") == cas \
                and row.get("object_id") is not None:
            continue  # already converged (duplicate completion)
        obj_row = obj_rows.get(obj_pub)
        if obj_row is None and obj_pub not in new_objects:
            kind = kind_for_row(
                {"extension": res.get("ext"), "is_dir": False}
            )
            new_objects[obj_pub] = int(kind)
            if emit_ops:
                ops.extend(sync.shared_create(
                    "object", obj_pub.hex(),
                    [("kind", int(kind)), ("date_created", date_created)],
                ))
            created += 1
        rid = fp_pub.hex()
        if emit_ops:
            ops.append(sync.shared_update("file_path", rid, "cas_id", cas))
            ops.append(
                sync.shared_update("file_path", rid, "object_id",
                                   obj_pub.hex())
            )
        to_link.append((fp_pub, cas, obj_pub))
        linked += 1

    if not to_link:
        return 0, 0

    def writes(conn):
        for obj_pub, kind in new_objects.items():
            conn.execute(
                "INSERT OR IGNORE INTO object (pub_id, kind, date_created) "
                "VALUES (?,?,?)",
                (obj_pub, kind, date_created),
            )
        obj_ids: dict[bytes, int | None] = {}
        if batched:
            needed = sorted({obj_pub for _fp, _cas, obj_pub in to_link})
            for start in range(0, len(needed), _LINK_CHUNK):
                chunk = needed[start:start + _LINK_CHUNK]
                placeholders = ",".join("?" for _ in chunk)
                for r in conn.execute(
                    "SELECT id, pub_id FROM object "
                    f"WHERE pub_id IN ({placeholders})",
                    chunk,
                ).fetchall():
                    obj_ids[bytes(r["pub_id"])] = r["id"]
        for fp_pub, cas, obj_pub in to_link:
            obj_id = obj_ids.get(obj_pub)
            if obj_id is None and obj_pub not in obj_ids:
                r = conn.execute(
                    "SELECT id FROM object WHERE pub_id = ?", (obj_pub,)
                ).fetchone()
                obj_id = obj_ids[obj_pub] = r["id"] if r is not None else None
            # placeholder-friendly: the file_path create op may not
            # have synced to this replica yet (sync/apply.py fills the
            # fields in when it arrives)
            conn.execute(
                "INSERT OR IGNORE INTO file_path (pub_id) VALUES (?)",
                (fp_pub,),
            )
            conn.execute(
                "UPDATE file_path SET cas_id = ?, object_id = ? "
                "WHERE pub_id = ?",
                (cas, obj_id, fp_pub),
            )

    sync.write_ops(ops, writes)
    return created, linked
