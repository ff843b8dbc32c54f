"""Slim worker-process runtime of the process pool.

Counterpart of `spacedrive_tpu/parallel/procworker.py`. One of these
runs in every `parallel/procpool.py` worker, started as
``python -m spacedrive_tpu_torch.parallel.procworker`` (a fresh
interpreter: no forked locks, no inherited CUDA context). Requests and
responses are length-prefixed MessagePack frames over the worker's own
stdio pipe, built with the port's codec (`utils/msgpack_codec.py`); the
worker points fd 1 at stderr first, so a stray ``print`` can never
corrupt the framing. The contract:

- **import-light**: no torch, no jax, no Node, no event loop. The
  module-level imports are stdlib; a stage imports the torch-free
  modules it needs (`models/embed_decode.py`, `ops/phash_gray.py`,
  `object/media/thumbnail/host.py`) on its first call;
- **shared-nothing**: payloads and results are MessagePack-plain
  (dicts, lists, str, bytes, numbers, None); no DB connection or device
  tensor crosses the boundary, and every device op and SQLite write
  stays in the owner;
- **single-writer telemetry**: a worker feeds its own registry and
  ships the additive delta of each job with its result; the owner
  merges it (`registry.merge_delta`). A job that dies with its worker
  never shipped a delta, so a retried job counts once.

Stages run the same functions as the inline paths, so ``SD_PROCS=0``
and the pool give identical output. The mesh identify's three stages
(`identify.hash_entries`, `journal.match`, `link.prep`) hash through
the host C hasher (`ops/cas_host.cas_ids_host`), never through pure
Python, and import no torch either.

Wire frames (owner → worker): ``[job_id, stage, payload_blob,
stall_s]``; (worker → owner): ``[job_id, ok, body_blob, delta_blob]``.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Any

#: frame header: little-endian u32 byte length
_HDR = struct.Struct("<I")
#: a single frame is bounded: a runaway payload fails loudly instead of
#: exhausting the worker's memory
MAX_FRAME = 64 << 20


def read_frame(fp: Any) -> bytes | None:
    """One length-prefixed frame; None on clean EOF."""
    hdr = fp.read(_HDR.size)
    if not hdr:
        return None
    if len(hdr) < _HDR.size:
        raise EOFError("torn frame header")
    (n,) = _HDR.unpack(hdr)
    if n > MAX_FRAME:
        raise ValueError(f"frame of {n} bytes exceeds {MAX_FRAME}")
    body = fp.read(n)
    if len(body) < n:
        raise EOFError("torn frame body")
    return body


def write_frame(fp: Any, blob: bytes) -> None:
    if len(blob) > MAX_FRAME:
        raise ValueError(f"frame of {len(blob)} bytes exceeds {MAX_FRAME}")
    fp.write(_HDR.pack(len(blob)))
    fp.write(blob)
    fp.flush()


# --- stages ----------------------------------------------------------------
#
# Every stage is a pure function payload(dict) -> result(dict), both
# MessagePack-plain.


def _stage_echo(payload: dict) -> dict:
    """Round-trip probe (tests and pool warm-up)."""
    return payload


def _stage_hash_entries(payload: dict) -> dict:
    """The mesh shard's host hash leg: stat, sampled read, chunk-cache
    digests and host cas_ids for journal-keyed entries
    (location/indexer/mesh.py `_execute_shard_sync`'s read and hash).

    payload: {"loc_path": str, "entries": [{"pub_id", "mat", "name",
    "ext"}, ...]}
    result:  {"results": [{"pub_id", "cas_id" | None, "identity" |
    None, "chunks" | None, "error" | None}, ...]}
    """
    from ..files.isolated_path import full_path_from_db_row
    from ..location.indexer.journal import stat_identity
    from ..ops import cas_host
    from ..telemetry import metrics as _tm

    loc_path = payload["loc_path"]
    out: list[dict] = []
    messages: list[bytes] = []
    msg_idx: list[int] = []
    for e in payload["entries"]:
        row = {"materialized_path": e["mat"], "name": e["name"],
               "extension": e["ext"], "is_dir": False}
        full = full_path_from_db_row(loc_path, row)
        ident = stat_identity(full)
        rec: dict[str, Any] = {
            "pub_id": e["pub_id"],
            "identity": (
                [ident.inode, ident.dev, ident.mtime_ns, ident.size]
                if ident is not None else None
            ),
            "cas_id": None, "chunks": None, "error": None,
        }
        out.append(rec)
        if ident is None:
            continue  # vanished or unreadable: the next walk removes it
        if ident.size == 0:
            rec["cas_id"] = ""  # the vouched-empty sentinel
            continue
        try:
            msg = cas_host.read_message(full, ident.size)
        except OSError:
            rec["identity"] = None  # no vouch for an unreadable file
            rec["error"] = "unreadable"
            continue
        rec["chunks"] = cas_host.build_chunk_cache(msg).to_payload()
        messages.append(msg)
        msg_idx.append(len(out) - 1)
    if messages:
        for i, cas_hex in zip(msg_idx, cas_host.cas_ids_host(messages)):
            out[i]["cas_id"] = cas_hex
        # bytes add up across workers; the hash leg's wall is observed
        # once by the owner (mesh._pool_hash)
        _tm.INDEX_BYTES_HASHED.inc(sum(len(m) for m in messages))
    return {"results": out}


def _stage_journal_match(payload: dict) -> dict:
    """consult_many's match half: the payload decode, strict validation
    and identity compare of each pre-fetched journal row (the SQL, the
    counting and the corrupt-row deletes stay in the owner).

    payload: {"items": [[[mat, name, ext], identity | None], ...],
              "rows": [row | None, aligned with items]}
    result:  {"verdicts": [[verdict, entry | None, corrupt], ...]}
    """
    from ..location.indexer import journal as _journal

    verdicts: list[list] = []
    for (_key, ident_raw), row in zip(payload["items"], payload["rows"]):
        if row is None:
            verdicts.append([_journal.MISS, None, False])
            continue
        entry = _journal.entry_of_row(row)
        if entry is None:
            verdicts.append([_journal.BYPASSED, None, True])
            continue
        ident = (_journal.Identity(*(int(x) for x in ident_raw))
                 if ident_raw is not None else None)
        hit = not entry.stale and ident is not None and entry.identity == ident
        verdicts.append([_journal.HIT if hit else _journal.INVALIDATED,
                         _journal.entry_to_plain(entry), False])
    return {"verdicts": verdicts}


def _stage_link_prep(payload: dict) -> dict:
    """apply_cas_results' pure prep: pub_id validation and the
    deterministic (library, cas) object pub_id per result
    (object/file_identifier/link.py `prep_inline`, the inline path).

    payload: {"library_id": str, "results": [{"pub_id", "cas_id",
    "ext"}, ...]}
    result:  {"usable": [[idx, fp_pub, cas, obj_pub], ...]}
    """
    from ..object.file_identifier.link import prep_inline

    return {"usable": [list(u) for u in prep_inline(payload["library_id"], payload["results"])]}


def _stage_phash_gray(payload: dict) -> dict:
    """The duplicate job's decode leg: the original first (JPEG draft
    decode), the thumbnail as the fallback, to the 32×32 gray plane
    (object/duplicates.py's inline decode, without the DB lookups).

    payload: {"path": str | None, "thumb_path": str | None}
    result:  {"gray": bytes | None}  (float32 DCT_SIZE² plane)
    """
    import numpy as np

    from ..ops.phash_gray import decode_gray

    for path, draft in ((payload.get("path"), True), (payload.get("thumb_path"), False)):
        if not path or not os.path.exists(path):
            continue
        try:
            return {"gray": decode_gray(path, draft).astype(np.float32).tobytes()}
        except Exception:  # noqa: BLE001 - undecodable → next source
            continue
    return {"gray": None}


def _stage_embed_decode(payload: dict) -> dict:
    """The embed step's decode leg: image files → the embedder's input
    planes (models/embed_decode.decode_image, the function the inline
    path runs). Undecodable files return None slots.

    payload: {"paths": [str, ...]}
    result:  {"planes": [bytes | None, ...]}  (float32 S·S·3 planes)
    """
    from ..models.embed_decode import decode_image

    planes: list[bytes | None] = []
    for path in payload["paths"]:
        img = decode_image(path)
        planes.append(None if img is None else img.tobytes())
    return {"planes": planes}


def _stage_thumb_cpu(payload: dict) -> dict:
    """The thumbnailer's software path for one file: decode by kind, the
    host resize, orientation and film strip, webp
    (object/media/thumbnail/host.generate_one_cpu, the function the
    inline path runs, so the bytes are identical). A file that fails to
    decode returns ``{"webp": None, "error": ...}`` instead of raising:
    the actor counts it without a second, equally doomed, inline decode.

    payload: {"path": str, "ext": str}
    result:  {"webp": bytes | None, "error": str | None}
    """
    from ..object.media.thumbnail.host import ThumbError, generate_one_cpu

    try:
        return {"webp": generate_one_cpu(payload["path"], payload["ext"]), "error": None}
    except (ThumbError, OSError) as exc:
        return {"webp": None, "error": f"{type(exc).__name__}: {exc}"}


STAGES = {
    "echo": _stage_echo,
    "identify.hash_entries": _stage_hash_entries,
    "journal.match": _stage_journal_match,
    "link.prep": _stage_link_prep,
    "phash.gray": _stage_phash_gray,
    "embed.decode": _stage_embed_decode,
    "thumb.cpu": _stage_thumb_cpu,
}


# --- the worker main loop --------------------------------------------------


def main() -> None:
    """Serve stage requests over stdio until EOF (the owner closing our
    stdin is the clean shutdown)."""
    # claim the framing pipe privately, then point fd 1 at stderr so
    # library prints can never interleave with frames
    out = os.fdopen(os.dup(1), "wb", buffering=0)
    os.dup2(2, 1)
    inp = os.fdopen(os.dup(0), "rb", buffering=0)
    # a worker never re-arms the owner's fault plan in its own process
    os.environ.pop("SD_FAULTS", None)

    from ..telemetry import metrics as _tm  # mint the families for deltas
    from ..telemetry.registry import REGISTRY
    from ..utils import msgpack_codec as _codec

    del _tm
    while True:
        frame = read_frame(inp)
        if frame is None:
            return
        job_id, stage, blob, stall_s = _codec.unpackb(frame)
        before = REGISTRY.delta_capture()
        try:
            if stall_s:
                # armed by the owner when the procpool.worker `stall`
                # fault fires: the job is delayed inside the worker
                time.sleep(stall_s)
            fn = STAGES.get(stage)
            if fn is None:
                raise KeyError(f"unknown procpool stage {stage!r}")
            body = _codec.packb(fn(_codec.unpackb(blob)))
            if len(body) > MAX_FRAME // 2:
                raise ValueError(f"{stage} result of {len(body)} bytes is over the frame budget")
            ok = True
        except BaseException as exc:  # noqa: BLE001 - errors are data
            body = _codec.packb({"error": f"{type(exc).__name__}: {exc}"})
            ok = False
        delta = REGISTRY.delta_diff(before, REGISTRY.delta_capture())
        write_frame(out, _codec.packb([job_id, ok, body, _codec.packb(delta)]))


if __name__ == "__main__":
    main()
