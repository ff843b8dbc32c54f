"""CRDT operation vocabulary.

Parity: ref:crates/sync/src/crdt.rs:25-61 (CRDTOperation / Create,
Update{field,value}, Delete; kind strings "c" / "u:<field>" / "d").

Values are JSON-compatible Python values; whole operations serialize
with MessagePack (utils/msgpack_codec) for the wire and the
`crdt_operation` table's `data` BLOB. Counterpart of
`spacedrive_tpu/sync/crdt.py`: the same ops encode to the same bytes.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Any

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
        return packb(self.to_wire())

    @classmethod
    def unpack(cls, raw: bytes) -> "CRDTOperation":
        return cls.from_wire(unpackb(raw))
