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
and the pool give identical output. The stages of the JAX worker that
serve the mesh identify (`identify.hash_entries`, `journal.match`,
`link.prep`) are not ported.

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
