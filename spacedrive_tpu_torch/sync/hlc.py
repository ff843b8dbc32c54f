"""Hybrid logical clock with NTP64 timestamps.

The reference uses the `uhlc` crate (ref:core/crates/sync/src/
manager.rs:49 `HLCBuilder::new().with_id(instance).build()`); its
timestamps are NTP64: a u64 fixed-point count of seconds since the Unix
epoch, 32 integer bits . 32 fraction bits (~233 ps resolution). The HLC
guarantees strictly monotonic timestamps per instance and merges remote
timestamps on ingest so causality is never inverted.

Counterpart of `spacedrive_tpu/sync/hlc.py`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from uuid import UUID

MASK64 = (1 << 64) - 1


class NTP64(int):
    """u64 NTP-format timestamp (seconds * 2^32)."""

    def __new__(cls, value: int = 0) -> "NTP64":
        return super().__new__(cls, value & MASK64)

    @classmethod
    def from_unix(cls, seconds: float) -> "NTP64":
        return cls(int(seconds * (1 << 32)))

    def as_unix(self) -> float:
        return self / (1 << 32)

    def __str__(self) -> str:
        return f"{self.as_unix():.9f}"


@dataclass(frozen=True, order=True)
class Timestamp:
    """(time, id) pair — total order: time first, instance id tiebreak
    (uhlc's Timestamp shape)."""

    time: NTP64
    id: UUID


class HybridLogicalClock:
    """Monotonic HLC for one instance.

    `new_timestamp` returns max(wall_clock, last + 1); `update` folds a
    remote timestamp in so subsequent local events order after it.
    A remote timestamp more than `max_drift_seconds` ahead of the wall
    clock is rejected (uhlc's delta guard, default 100 ms there; we are
    more lenient because file-manager peers have worse clocks).
    """

    def __init__(self, instance_id: UUID, max_drift_seconds: float = 60.0):
        self.instance_id = instance_id
        self.max_drift = NTP64.from_unix(max_drift_seconds)
        self._last = NTP64(0)
        self._lock = threading.Lock()

    def now(self) -> NTP64:
        return NTP64.from_unix(time.time())

    def new_timestamp(self) -> Timestamp:
        with self._lock:
            phys = self.now()
            self._last = phys if phys > self._last else NTP64(self._last + 1)
            return Timestamp(self._last, self.instance_id)

    def update(self, remote_time: NTP64) -> None:
        """Merge a remote op's timestamp (ingest path,
        ref:core/crates/sync/src/ingest.rs:120-131). Raises ClockDriftError
        when the remote clock is unacceptably far in the future."""
        phys = self.now()
        if remote_time > phys + self.max_drift:
            raise ClockDriftError(
                f"remote timestamp {NTP64(remote_time)} is "
                f"{NTP64(remote_time).as_unix() - phys.as_unix():.1f}s ahead"
            )
        with self._lock:
            if remote_time > self._last:
                self._last = NTP64(remote_time)


class ClockDriftError(Exception):
    pass
