"""Named-actor registry.

Parity: ref:crates/actors/src/lib.rs — `Actors::declare(name, factory)`
registers a named async actor that can be started/stopped/restarted at
runtime, with an invalidation broadcast so UIs can re-query actor state
(lib.rs:20-38). Used per-library by the sync ingest and cloud-sync
actors. Here actors are asyncio tasks created from a factory coroutine
function; `stop` cancels, `start` re-creates.

Counterpart of `spacedrive_tpu/node/actors.py`.
"""

from __future__ import annotations

import asyncio
from typing import Any, Awaitable, Callable

ActorFactory = Callable[[], Awaitable[Any]]


class Actors:
    def __init__(self) -> None:
        self._factories: dict[str, ActorFactory] = {}
        self._tasks: dict[str, asyncio.Task] = {}
        self.invalidate = asyncio.Event()

    def declare(self, name: str, factory: ActorFactory, *, autostart: bool = False) -> None:
        """Register a named actor (ref:lib.rs:20-38). `autostart` mirrors
        the reference's immediate `start` after declare in sync setup."""
        self._factories[name] = factory
        if autostart:
            self.start(name)

    def start(self, name: str) -> bool:
        if name not in self._factories:
            return False
        task = self._tasks.get(name)
        # a just-cancelled task isn't done() until the loop runs; treat it
        # as stopped so restart() can hand the name to a replacement
        if task is not None and not task.done() and not task.cancelling():
            return False
        self._tasks[name] = asyncio.get_running_loop().create_task(
            self._factories[name](), name=f"actor:{name}"
        )
        self._notify()
        return True

    def stop(self, name: str) -> bool:
        task = self._tasks.get(name)
        if task is None or task.done():
            return False
        task.cancel()
        self._notify()
        return True

    def restart(self, name: str) -> bool:
        self.stop(name)
        return self.start(name)

    def is_running(self, name: str) -> bool:
        task = self._tasks.get(name)
        return task is not None and not task.done()

    def states(self) -> dict[str, bool]:
        """name -> running? for every declared actor (UI listing)."""
        return {name: self.is_running(name) for name in self._factories}

    async def shutdown(self) -> None:
        for task in self._tasks.values():
            if not task.done():
                task.cancel()
        for task in self._tasks.values():
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()

    def _notify(self) -> None:
        self.invalidate.set()
        self.invalidate = asyncio.Event()
