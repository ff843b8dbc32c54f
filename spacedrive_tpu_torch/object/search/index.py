"""Per-library vector index: a memmap-backed matrix of embeddings and
its cosine top-k query.

Counterpart of `spacedrive_tpu/object/search/index.py`. One
L2-normalized float32 [N, EMBED_DIM] matrix plus an aligned object-id
list, built from `object_embedding` rows and kept up to date
incrementally: the media job's embed step calls `refresh` after its
`sync.write_ops` commit, and `on_embeddings_applied` is the hook for
rows that sync applies.

Maintenance keys off (id watermark, date_calculated stamp): new rows
append, rows updated in place overwrite their slot, and a table that
shrank (object deletes cascade) triggers a full rebuild. A row whose
vector blob fails strict validation is skipped alone.

The matrix persists next to the library DB (`<db>.searchidx/`:
`vectors.f32`, little-endian float32 rows, and `meta.json` with dim,
ids, watermark and stamp; the JAX package's format) and is memmapped
back on load.

A query scores the whole matrix against the probe on the device
(`score_top_k`: an elementwise product and a row sum in float32, which
no TF32 setting touches) and ranks it by a stable descending sort, so
equal scores keep the lower row first, as `lax.top_k` orders them in
the JAX package. The matrix stays on the device until a refresh changes
it. The query's device is the caller's, else the library's node's, else
"cuda". As in the JAX index, a device failure (or the `search.query`
fault) on a device that rides the degradation ladder (a device type
with dispatch devices, parallel/mesh) degrades the query to the host: a
stable descending sort of the numpy product, ties by the lower row, the
same ranking; each such query is counted in
`sd_search_queries_total{path="host"}`, logged and put on the
resilience ring. On a pinned device ("cuda:0", "cpu") the failure
raises, and a missing CUDA device is not a failure: it raises too.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any

import numpy as np
import torch

from ...models import embedder as _embedder
from ...parallel import mesh as _mesh
from ...telemetry import metrics as _tm
from ...telemetry.events import RESILIENCE_EVENTS
from ...utils import faults as _faults

logger = logging.getLogger(__name__)


def _normalize(vec: np.ndarray) -> np.ndarray:
    n = float(np.linalg.norm(vec))
    if n <= 0.0 or not np.isfinite(n):
        return np.zeros_like(vec)
    return (vec / np.float32(n)).astype(np.float32)


def device_of(library: Any, device: str | torch.device | None = None) -> torch.device:
    """`device` when given, else the library's node's device, else "cuda"."""
    if device is not None:
        return torch.device(device)
    return torch.device(getattr(getattr(library, "node", None), "device", None) or "cuda")


def score_top_k(matrix: torch.Tensor, probe: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Cosine scores of the k best rows of `matrix` [N, D] against
    `probe` [D] (both normalized, float32, on one device) and their row
    indices, best first; equal scores keep the lower row first."""
    # a product and a sum, not a matmul: TF32 globals never reach it
    scores = (matrix * probe).sum(dim=1)
    rows = torch.sort(scores, descending=True, stable=True).indices[:k]
    return scores[rows], rows


class LibraryIndex:
    """The per-library matrix and id map. Thread-safe: the media job's
    embed step refreshes it from a worker thread."""

    def __init__(self, library: Any):
        self._library = library
        self._lock = threading.Lock()
        self._matrix: np.ndarray = np.zeros((0, _embedder.EMBED_DIM), np.float32)
        self._ids: list[int] = []
        self._pos: dict[int, int] = {}
        self._watermark = 0  # max object_embedding.id folded in
        self._stamp = ""  # max date_calculated folded in (ISO text)
        #: rows read before their vector arrived: read again by id
        self._pending: set[int] = set()
        self._loaded = False
        #: the matrix on the last query's device, until a refresh changes it
        self._on_device: tuple[str, torch.Tensor] | None = None

    # ---- persistence ---------------------------------------------------

    def _dir(self) -> str | None:
        path = self._library.db.path
        return None if path == ":memory:" else path + ".searchidx"

    def _load_persisted(self) -> None:
        d = self._dir()
        if d is None:
            return
        try:
            with open(os.path.join(d, "meta.json"), encoding="utf-8") as f:
                meta = json.load(f)
            ids = [int(i) for i in meta["ids"]]
            dim = int(meta.get("dim", 0))
            if dim != _embedder.EMBED_DIM:
                return  # model width changed: rebuilt from the DB
            self._matrix = np.memmap(os.path.join(d, "vectors.f32"), dtype="<f4", mode="r",
                                     shape=(len(ids), dim))
            self._ids = ids
            self._pos = {oid: i for i, oid in enumerate(ids)}
            self._watermark = int(meta.get("watermark", 0))
            self._stamp = str(meta.get("stamp", ""))
        except (OSError, ValueError, KeyError, TypeError):
            pass  # torn sidecar: rebuilt from the DB

    def _persist(self) -> None:
        d = self._dir()
        if d is None:
            return
        try:
            os.makedirs(d, exist_ok=True)
            vec_p = os.path.join(d, "vectors.f32")
            tmp = vec_p + ".tmp"
            np.ascontiguousarray(self._matrix, dtype="<f4").tofile(tmp)
            os.replace(tmp, vec_p)
            meta = {"dim": _embedder.EMBED_DIM, "ids": self._ids,
                    "watermark": self._watermark, "stamp": self._stamp}
            tmp = os.path.join(d, "meta.json.tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(meta, f)
            os.replace(tmp, os.path.join(d, "meta.json"))
            # memmapped again, so steady-state reads hit the page cache
            self._matrix = np.memmap(vec_p, dtype="<f4", mode="r",
                                     shape=(len(self._ids), _embedder.EMBED_DIM))
        except OSError:
            logger.exception("search index persist failed (non-fatal)")

    # ---- maintenance ---------------------------------------------------

    def refresh(self) -> int:
        """Fold new and updated `object_embedding` rows in; returns the
        vector count. Only rows past the (id, stamp) watermarks, and the
        rows still waiting for their vector, are read on a warm call."""
        with self._lock:
            db = self._library.db
            if not self._loaded:
                self._load_persisted()
                self._pending = {int(r["id"]) for r in db.query(
                    "SELECT id FROM object_embedding WHERE vector IS NULL AND id <= ?",
                    (self._watermark,))}
                self._loaded = True
            total = db.query_one("SELECT COUNT(*) AS n FROM object_embedding")["n"]
            if total < len(self._ids):
                # shrink (object deletes cascade): rebuild from scratch
                self._matrix = np.zeros((0, _embedder.EMBED_DIM), np.float32)
                self._ids, self._pos, self._pending = [], {}, set()
                self._watermark, self._stamp = 0, ""
                self._on_device = None
            rows = db.query(
                "SELECT id, object_id, vector, date_calculated "
                "FROM object_embedding WHERE id > ? "
                "OR (date_calculated IS NOT NULL AND date_calculated > ?) "
                "ORDER BY id",
                (self._watermark, self._stamp),
            )
            # a row without its vector yet is read again by id: sync
            # applies a row's create before its vector, possibly in a
            # later batch, and the vector's stamp may be older than one
            # already read (JAX's refresh passes such a row for good)
            seen = {int(r["id"]) for r in rows}
            waiting = sorted(self._pending - seen)
            for i in range(0, len(waiting), 500):
                part = waiting[i:i + 500]
                rows += [r for r in db.query(
                    "SELECT id, object_id, vector, date_calculated FROM object_embedding "
                    f"WHERE vector IS NOT NULL AND id IN ({','.join('?' * len(part))})",
                    tuple(part))]
            if not rows:
                return len(self._ids)
            fresh: list[np.ndarray] = []
            fresh_ids: list[int] = []
            matrix = np.asarray(self._matrix)
            for r in rows:
                self._watermark = max(self._watermark, int(r["id"]))
                if r["date_calculated"]:
                    self._stamp = max(self._stamp, str(r["date_calculated"]))
                if r["vector"] is None:
                    self._pending.add(int(r["id"]))
                    continue
                self._pending.discard(int(r["id"]))
                vec = _embedder.blob_to_vector(r["vector"])
                if vec is None:
                    logger.warning("object_embedding row %s has an invalid vector; skipped",
                                   r["id"])
                    continue
                vec = _normalize(vec)
                pos = self._pos.get(r["object_id"])
                if pos is not None:
                    if matrix.base is not None or not matrix.flags.writeable:
                        matrix = matrix.copy()
                    matrix[pos] = vec
                else:
                    self._pos[r["object_id"]] = len(self._ids) + len(fresh_ids)
                    fresh_ids.append(int(r["object_id"]))
                    fresh.append(vec)
            if fresh:
                matrix = (np.concatenate([matrix, np.stack(fresh)], axis=0)
                          if matrix.size else np.stack(fresh))
                self._ids.extend(fresh_ids)
            self._matrix = matrix.astype(np.float32, copy=False)
            self._on_device = None
            self._persist()
            return len(self._ids)

    # ---- scoring -------------------------------------------------------

    def query(self, probe: np.ndarray, k: int = 10,
              device: str | torch.device | None = None) -> list[tuple[int, float]]:
        """Top-k (object_id, cosine) for a probe vector, scored on
        `device` (see `device_of`); a device failure on a device that
        rides the ladder ranks on the host instead, identically."""
        device = device_of(self._library, device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("search query on cuda, but no CUDA device is available")
        with self._lock:
            n = len(self._ids)
        k = min(int(k), n)
        if k <= 0:
            return []
        probe = _normalize(np.asarray(probe, np.float32))
        try:
            spec = _faults.hit("search.query")
            if spec is not None:
                if spec.mode == "raise":
                    raise _faults.InjectedFault("injected device failure (search)")
                if spec.mode == "xla":
                    raise _faults.device_error("search.query")
            with self._lock:
                ids = list(self._ids)
                if self._on_device is None or self._on_device[0] != str(device):
                    self._on_device = (str(device), torch.from_numpy(
                        np.array(self._matrix, np.float32)).to(device))
                matrix = self._on_device[1]
            scores, rows = score_top_k(matrix, torch.from_numpy(probe).to(device), k)
            hits = [(ids[i], v) for i, v in zip(rows.tolist(), scores.tolist())]
        except Exception as exc:  # noqa: BLE001 - the host ranks identically
            if not _mesh.auto_slots(device):
                raise  # a pinned device never degrades
            with self._lock:
                ids, matrix = list(self._ids), np.array(self._matrix, np.float32)
            s = matrix @ probe
            # a stable sort on -s keeps ties in row order, as the device
            # query does
            rows = np.argsort(-s, kind="stable")[:k]
            _tm.SEARCH_QUERIES.inc(path="host")
            RESILIENCE_EVENTS.emit("search_host_rank", error=repr(exc)[:200])
            logger.warning("device search query failed (%r); ranked on the host", exc)
            return [(ids[int(i)], float(s[i])) for i in rows]
        _tm.SEARCH_QUERIES.inc(path="device")
        return hits

    def vectors(self) -> tuple[list[int], np.ndarray]:
        """(object ids, their normalized vectors [N, EMBED_DIM]), a copy."""
        with self._lock:
            return list(self._ids), np.array(self._matrix, np.float32)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ids)


def get_index(library: Any) -> LibraryIndex:
    """The library's index (one per Library object; a reloaded library
    starts from the persisted sidecar)."""
    return library.search_index


def refresh(library: Any) -> int:
    return get_index(library).refresh()


def on_embeddings_applied(library: Any) -> None:
    """Sync-apply hook: fold embedding rows that sync applied into the
    replica's index. Failures are contained — index maintenance must
    never wedge the caller."""
    try:
        get_index(library).refresh()
    except Exception:  # noqa: BLE001 - maintenance is best-effort
        logger.exception("search index refresh after sync apply failed")


def query(library: Any, probe: np.ndarray, k: int = 10,
          device: str | torch.device | None = None) -> list[tuple[int, float]]:
    idx = get_index(library)
    idx.refresh()
    return idx.query(probe, k=k, device=device)


def probe_for(library: Any, text: str,
              device: str | torch.device | None = None) -> np.ndarray | None:
    """Resolve a query string to a probe vector: an existing image path
    embeds on `device` (see `device_of`); otherwise the string is
    matched against stored label names and the probe is the centroid of
    the labeled objects' vectors. None = unresolvable."""
    if os.path.exists(text):
        img = _embedder.decode_image(text)
        if img is None:
            return None
        from ...ops import embed_torch

        return embed_torch.embed_batch(img[None, ...], device_of(library, device))[0]
    row = library.db.query_one("SELECT id FROM label WHERE name = ?", (text,))
    if row is None:
        return None
    obj_ids = [r["object_id"] for r in library.db.query(
        "SELECT object_id FROM label_on_object WHERE label_id = ?", (row["id"],))]
    if not obj_ids:
        return None
    idx = get_index(library)
    idx.refresh()
    with idx._lock:
        vecs = [np.asarray(idx._matrix)[idx._pos[oid]] for oid in obj_ids if oid in idx._pos]
    if not vecs:
        return None
    return _normalize(np.mean(np.stack(vecs), axis=0))
