"""CRDT operation vocabulary.

Parity: ref:crates/sync/src/crdt.rs:25-61 (CRDTOperation / Create,
Update{field,value}, Delete; kind strings "c" / "u:<field>" / "d") and
ref:crates/sync/src/compressed.rs (nested grouping for wire batches).

Values are JSON-compatible Python values; whole operations serialize
with MessagePack (utils/msgpack_codec) for the wire and the
`crdt_operation` table's `data` BLOB. Counterpart of
`spacedrive_tpu/sync/crdt.py`: the same ops, and the same compressed
batches, encode to the same bytes.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Iterable

from ..utils.msgpack_codec import packb, unpackb
from .hlc import NTP64

CREATE = "c"
UPDATE = "u"
DELETE = "d"


@dataclass(frozen=True)
class CRDTOperationData:
    kind: str                       # CREATE | UPDATE | DELETE
    field_name: str | None = None   # UPDATE only
    value: Any = None               # UPDATE only

    @classmethod
    def create(cls) -> "CRDTOperationData":
        return cls(CREATE)

    @classmethod
    def update(cls, field_name: str, value: Any) -> "CRDTOperationData":
        return cls(UPDATE, field_name, value)

    @classmethod
    def delete(cls) -> "CRDTOperationData":
        return cls(DELETE)

    def as_kind_string(self) -> str:
        """'c' / 'u:<field>' / 'd' — the `kind` column of
        crdt_operation rows (ref:crates/sync/src/crdt.rs:15-22)."""
        if self.kind == UPDATE:
            return f"u:{self.field_name}"
        return self.kind

    def to_wire(self) -> dict[str, Any]:
        if self.kind == UPDATE:
            return {"u": {"field": self.field_name, "value": self.value}}
        return {self.kind: None}

    @classmethod
    def from_wire(cls, obj: dict[str, Any]) -> "CRDTOperationData":
        if "u" in obj:
            return cls.update(obj["u"]["field"], obj["u"]["value"])
        if "c" in obj:
            return cls.create()
        if "d" in obj:
            return cls.delete()
        raise ValueError(f"bad CRDTOperationData wire form: {obj!r}")


@dataclass(frozen=True)
class CRDTOperation:
    instance: uuid.UUID       # originating instance pub_id
    timestamp: NTP64          # HLC time
    id: uuid.UUID             # unique op id
    model: str                # table name (sync registry key)
    record_id: Any            # JSON sync id (e.g. hex pub_id or composite)
    data: CRDTOperationData

    def kind(self) -> str:
        return self.data.as_kind_string()

    def to_wire(self) -> dict[str, Any]:
        return {
            "instance": self.instance.bytes,
            "timestamp": int(self.timestamp),
            "id": self.id.bytes,
            "model": self.model,
            "record_id": self.record_id,
            "data": self.data.to_wire(),
        }

    @classmethod
    def from_wire(cls, obj: dict[str, Any]) -> "CRDTOperation":
        return cls(
            instance=uuid.UUID(bytes=obj["instance"]),
            timestamp=NTP64(obj["timestamp"]),
            id=uuid.UUID(bytes=obj["id"]),
            model=obj["model"],
            record_id=obj["record_id"],
            data=CRDTOperationData.from_wire(obj["data"]),
        )

    def pack(self) -> bytes:
        """The op's MessagePack bytes; an op read from bytes (`unpack`)
        keeps them, so storing a pulled op does not encode it again."""
        raw = self.__dict__.get("_packed")
        if raw is None:
            raw = packb(self.to_wire())
            object.__setattr__(self, "_packed", raw)
        return raw

    @classmethod
    def unpack(cls, raw: bytes) -> "CRDTOperation":
        op = cls.from_wire(unpackb(raw))
        object.__setattr__(op, "_packed", bytes(raw))
        return op


@dataclass(frozen=True)
class CompressedCRDTOperation:
    timestamp: NTP64
    id: uuid.UUID
    data: CRDTOperationData

    @classmethod
    def from_op(cls, op: CRDTOperation) -> "CompressedCRDTOperation":
        return cls(op.timestamp, op.id, op.data)

    def to_wire(self) -> dict[str, Any]:
        return {
            "timestamp": int(self.timestamp),
            "id": self.id.bytes,
            "data": self.data.to_wire(),
        }

    @classmethod
    def from_wire(cls, obj: dict[str, Any]) -> "CompressedCRDTOperation":
        return cls(
            NTP64(obj["timestamp"]),
            uuid.UUID(bytes=obj["id"]),
            CRDTOperationData.from_wire(obj["data"]),
        )


@dataclass
class CompressedCRDTOperations:
    """Adjacent-run grouping instance → model → record for wire batches
    (ref:crates/sync/src/compressed.rs): shared prefixes are sent once.
    """

    groups: list[tuple[uuid.UUID, list[tuple[str, list[tuple[Any, list[CompressedCRDTOperation]]]]]]] = field(
        default_factory=list
    )

    @classmethod
    def compress(cls, ops: Iterable[CRDTOperation]) -> "CompressedCRDTOperations":
        out = cls()
        for op in ops:
            if not out.groups or out.groups[-1][0] != op.instance:
                out.groups.append((op.instance, []))
            models = out.groups[-1][1]
            if not models or models[-1][0] != op.model:
                models.append((op.model, []))
            records = models[-1][1]
            if not records or records[-1][0] != op.record_id:
                records.append((op.record_id, []))
            records[-1][1].append(CompressedCRDTOperation.from_op(op))
        return out

    def expand(self) -> list[CRDTOperation]:
        ops = []
        for instance, models in self.groups:
            for model, records in models:
                for record_id, compressed in records:
                    for c in compressed:
                        ops.append(CRDTOperation(instance, c.timestamp, c.id, model, record_id, c.data))
        return ops

    def __len__(self) -> int:
        return sum(
            len(compressed)
            for _, models in self.groups
            for _, records in models
            for _, compressed in records
        )

    def pack(self) -> bytes:
        return packb([
            [
                inst.bytes,
                [
                    [model, [[rid, [c.to_wire() for c in comp]] for rid, comp in records]]
                    for model, records in models
                ],
            ]
            for inst, models in self.groups
        ])

    @classmethod
    def unpack(cls, raw: bytes) -> "CompressedCRDTOperations":
        out = cls()
        for inst_b, models in unpackb(raw):
            out.groups.append(
                (
                    uuid.UUID(bytes=inst_b),
                    [
                        (
                            model,
                            [
                                (rid, [CompressedCRDTOperation.from_wire(c) for c in comp])
                                for rid, comp in records
                            ],
                        )
                        for model, records in models
                    ],
                )
            )
        return out
