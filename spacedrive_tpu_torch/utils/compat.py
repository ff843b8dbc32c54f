"""Cross-version asyncio shims.

An owned copy of `spacedrive_tpu/utils/compat.py`: ``timeout(delay)`` is
the 3.11 ``asyncio.timeout`` context manager when available, otherwise a
small backport built on the same cancel-then-translate mechanism: arm a
``call_later`` that cancels the current task, and translate that
specific cancellation into ``TimeoutError`` on exit. The backport covers
``async with timeout(s):`` around awaits in the current task; without
3.11's ``uncancel()`` counting, an external ``task.cancel()`` that lands
in the window the timer fired surfaces as ``TimeoutError``.
"""

from __future__ import annotations

import asyncio
import sys

__all__ = ["timeout"]


if sys.version_info >= (3, 11):
    timeout = asyncio.timeout
else:

    class _Timeout:
        def __init__(self, delay: float | None):
            self._delay = delay
            self._handle: asyncio.TimerHandle | None = None
            self._task: asyncio.Task | None = None
            self._timed_out = False

        async def __aenter__(self) -> "_Timeout":
            self._task = asyncio.current_task()
            if self._task is None:
                raise RuntimeError("timeout() must be used inside a task")
            if self._delay is not None:
                self._handle = asyncio.get_running_loop().call_later(
                    self._delay, self._on_timeout
                )
            return self

        def _on_timeout(self) -> None:
            self._timed_out = True
            assert self._task is not None
            self._task.cancel()

        async def __aexit__(self, exc_type, exc, tb) -> bool:
            if self._handle is not None:
                self._handle.cancel()
                self._handle = None
            if self._timed_out and exc_type is asyncio.CancelledError:
                # our own cancellation: surface as TimeoutError, and
                # clear the pending-cancel state the cancel() left on
                # the task so callers can keep awaiting afterwards
                if hasattr(self._task, "uncancel"):
                    self._task.uncancel()  # pragma: no cover (3.11+)
                raise TimeoutError from exc
            return False

    def timeout(delay: float | None) -> "_Timeout":
        """Backport of ``asyncio.timeout`` for Python < 3.11."""
        return _Timeout(delay)
