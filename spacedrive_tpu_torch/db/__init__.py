"""Data layer — per-library SQLite database (counterpart of
`spacedrive_tpu/db/`, without its sync-model registry)."""

from .database import LibraryDb, dict_row
from .schema import SCHEMA_VERSION

__all__ = ["LibraryDb", "dict_row", "SCHEMA_VERSION"]
