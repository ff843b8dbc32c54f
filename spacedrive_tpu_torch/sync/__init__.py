"""Sync layer — HLC-ordered last-write-wins CRDT replication.

Parity targets: the reference's `sd-sync` vocabulary crate
(ref:crates/sync/src/{crdt.rs,factory.rs,compressed.rs}) and the
`sd-core-sync` manager (ref:core/crates/sync/src/). Counterpart of
`spacedrive_tpu/sync/`, without ingest and the compressed wire batches
(no peer exchanges ops with the port yet).
"""

from .hlc import NTP64, HybridLogicalClock, Timestamp
from .crdt import CRDTOperation, CRDTOperationData
from .factory import OperationFactory

__all__ = [
    "NTP64",
    "HybridLogicalClock",
    "Timestamp",
    "CRDTOperation",
    "CRDTOperationData",
    "OperationFactory",
]
