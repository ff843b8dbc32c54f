"""Data layer — per-library SQLite database and the sync-model registry
(counterpart of `spacedrive_tpu/db/`)."""

from .database import LibraryDb, dict_row
from .schema import SCHEMA_VERSION
from .sync_registry import SYNC_MODELS, SyncKind, model_sync_kind

__all__ = [
    "LibraryDb",
    "dict_row",
    "SCHEMA_VERSION",
    "SyncKind",
    "SYNC_MODELS",
    "model_sync_kind",
]
