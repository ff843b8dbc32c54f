"""Object validation — full-file integrity checksums
(ref:core/src/object/validation/)."""

from .hash import file_checksum, file_checksums
from .job import ObjectValidatorJob

__all__ = ["file_checksum", "file_checksums", "ObjectValidatorJob"]
