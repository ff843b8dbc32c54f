"""One call of the window, as the loop that sent it records it."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Call:
    index: int  # order in which the calls started
    client: int
    start: float  # perf_counter seconds
    end: float
    error: str | None = None

    @property
    def seconds(self) -> float:
        return self.end - self.start
