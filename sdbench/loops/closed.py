"""A closed loop of calls through the node's router.

`clients` clients (the traffic file's) each send their next call when
the last one has answered. A client starts no call that its last call's
time says would end after the window closes, `seconds` after it opened:
the window holds whole calls, and a run lasts its window, not a call
longer. Every call that started counts, its whole time with it, however
late it ends.
"""

from __future__ import annotations

import asyncio
import time
from collections.abc import Awaitable, Callable
from typing import Any

from sdbench.core.calls import Call


async def run(send: Callable[[Any], Awaitable[Any]], arg: Callable[[int], Any],
              traffic: dict, seconds: float, keep: Callable[[int, Any, Any], None]) -> list[Call]:
    """Send `arg(i)` as call `i` while the calls fit in `seconds`; hand
    each answer to `keep(i, arg, answer)`. Returns every call."""
    calls: list[Call] = []
    deadline = time.perf_counter() + seconds

    async def client(k: int) -> None:
        last = 0.0  # the client's last call's seconds
        while time.perf_counter() + last < deadline:
            index = len(calls)
            a = arg(index)
            call = Call(index, k, time.perf_counter(), 0.0)
            calls.append(call)
            try:
                answer = await send(a)
            except Exception as e:  # noqa: BLE001 - a failed call is counted, not fatal
                call.end = time.perf_counter()
                call.error = f"{type(e).__name__}: {e}"
                last = call.seconds
                continue
            call.end = time.perf_counter()
            last = call.seconds
            keep(index, a, answer)

    await asyncio.gather(*(client(k) for k in range(int(traffic["clients"]))))
    return calls
