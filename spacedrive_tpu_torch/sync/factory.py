"""OperationFactory — building CRDT ops for local writes.

Parity: ref:crates/sync/src/factory.rs. A create emits one Create op
plus one Update op per non-null field (so late-joining peers converge
field-wise under LWW); updates are per-field; deletes are singular.

Counterpart of `spacedrive_tpu/sync/factory.py`.
"""

from __future__ import annotations

import uuid
from typing import Any, Iterable

from .crdt import CRDTOperation, CRDTOperationData
from .hlc import HybridLogicalClock


class OperationFactory:
    """Mixin/impl over a clock + instance id. The sync manager subclasses
    this; unit tests use it standalone."""

    def __init__(self, clock: HybridLogicalClock, instance: uuid.UUID):
        self.clock = clock
        self.instance = instance

    def new_op(self, model: str, record_id: Any, data: CRDTOperationData) -> CRDTOperation:
        return CRDTOperation(
            instance=self.instance,
            timestamp=self.clock.new_timestamp().time,
            id=uuid.uuid4(),
            model=model,
            record_id=record_id,
            data=data,
        )

    def shared_create(
        self, model: str, record_id: Any, values: Iterable[tuple[str, Any]] = ()
    ) -> list[CRDTOperation]:
        return [self.new_op(model, record_id, CRDTOperationData.create())] + [
            self.new_op(model, record_id, CRDTOperationData.update(f, v))
            for f, v in values
        ]

    def shared_update(self, model: str, record_id: Any, field: str, value: Any) -> CRDTOperation:
        return self.new_op(model, record_id, CRDTOperationData.update(field, value))

    def shared_delete(self, model: str, record_id: Any) -> CRDTOperation:
        return self.new_op(model, record_id, CRDTOperationData.delete())

    # Relations share the same op shapes; the record id is the
    # {item, group} composite (ref:crates/sync/src/factory.rs:71-105).
    relation_create = shared_create
    relation_update = shared_update
    relation_delete = shared_delete
