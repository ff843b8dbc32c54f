"""Retained-task supervision — the remedy for an orphaned
``create_task``.

A spawned task whose handle is dropped is GC-cancellable at any moment,
and an exception it raises surfaces only as an unraisable warning at
collection time (which pytest.ini escalates to a failure). The fix is
always the same three moves: retain the handle in a set, discard it on
completion, and RETRIEVE the exception so it gets logged instead of
lost. This helper is that pattern, once.

Counterpart of `spacedrive_tpu/utils/tasks.py`.
"""

from __future__ import annotations

import asyncio
import logging


def supervise(
    task: asyncio.Task,
    tasks: set,
    logger: logging.Logger,
    what: str,
) -> asyncio.Task:
    """Retain ``task`` in ``tasks`` until it completes; on completion,
    discard it and log any exception (cancellation is not an error).
    Returns the task for further chaining."""
    tasks.add(task)

    def _done(t: asyncio.Task) -> None:
        tasks.discard(t)
        if not t.cancelled() and t.exception() is not None:
            logger.error("%s failed: %r", what, t.exception())

    task.add_done_callback(_done)
    return task
