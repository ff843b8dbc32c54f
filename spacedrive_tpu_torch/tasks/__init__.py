"""Execution plane: the interruptible task system.

Parity contract (ref:crates/task-system/src/task.rs:81-148,
system.rs:38-461, worker/): `Task.run(interrupter)` returning
Done/Paused/Canceled, pause/cancel/force-abort, priority tasks that
suspend running non-priority ones, round-robin + least-loaded dispatch,
work stealing, and shutdown that hands unfinished tasks back for
persistence.

Device-first design: workers are asyncio tasks on the host — their job
in this framework is to *assemble fixed-shape batches* and await device
steps, so cooperative scheduling (not OS threads) is the right model;
CPU-bound work (decode, IO) goes through executors.

Counterpart of `spacedrive_tpu/tasks/__init__.py`.
"""

from .task import (
    ExecStatus,
    Interrupter,
    InterruptionKind,
    Task,
    TaskHandle,
    TaskStatus,
)
from .system import TaskSystem

__all__ = [
    "ExecStatus",
    "Interrupter",
    "InterruptionKind",
    "Task",
    "TaskHandle",
    "TaskStatus",
    "TaskSystem",
]
