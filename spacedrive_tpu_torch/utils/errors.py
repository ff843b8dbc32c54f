"""Error taxonomy (parity: ref:crates/utils/src/error.rs).

Counterpart of `spacedrive_tpu/utils/errors.py`.
"""

from __future__ import annotations


class SpacedriveError(Exception):
    """Base class for all framework errors."""


class VersionManagerError(SpacedriveError):
    """Config migration failure (parity: ref:core/src/util/version_manager.rs)."""

