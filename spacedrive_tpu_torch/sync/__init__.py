"""Sync layer — HLC-ordered last-write-wins CRDT replication.

Parity targets: the reference's `sd-sync` vocabulary crate
(ref:crates/sync/src/{crdt.rs,factory.rs,compressed.rs}) and the
`sd-core-sync` manager/ingest (ref:core/crates/sync/src/) — see
manager.py and ingest.py. Counterpart of `spacedrive_tpu/sync/`.
"""

from .hlc import NTP64, HybridLogicalClock, Timestamp
from .crdt import (
    CRDTOperation,
    CRDTOperationData,
    CompressedCRDTOperation,
    CompressedCRDTOperations,
)
from .factory import OperationFactory

__all__ = [
    "NTP64",
    "HybridLogicalClock",
    "Timestamp",
    "CRDTOperation",
    "CRDTOperationData",
    "CompressedCRDTOperation",
    "CompressedCRDTOperations",
    "OperationFactory",
]
