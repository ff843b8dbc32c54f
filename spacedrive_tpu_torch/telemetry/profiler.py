"""Optional `torch.profiler` hooks around the identify pipeline.

Counterpart of `spacedrive_tpu/telemetry/profiler.py`. When
``SD_TORCH_PROFILE=<logdir>`` is set, the identify pipeline wraps its
run in a `torch.profiler` session (host ops, and CUDA kernels and copies
when a card is present) and writes it as a Chrome trace,
``<logdir>/<tag>/<pid>.<ns>.pt.trace.json``, loadable in Perfetto or
``chrome://tracing``. Everything here is no-op-safe: an unset variable
or a profiler that refuses to start or to write degrades to "no
profile", never to a failed job. Start/stop is refcounted so
overlapping jobs share one session, whose trace is named by the tag
that opened it.
"""

from __future__ import annotations

import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

ENV_VAR = "SD_TORCH_PROFILE"

_lock = threading.Lock()
_depth = 0
_session: tuple | None = None  # (profiler, trace path) while active


def profile_start(tag: str = "pipeline") -> bool:
    """Begin (or join) a profile session. Returns True when a session
    is active after the call."""
    global _depth, _session
    logdir = os.environ.get(ENV_VAR)
    if not logdir:
        return False
    with _lock:
        if _depth > 0:
            _depth += 1
            return True
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:  # noqa: BLE001 - profiling is best-effort
            logger.debug("torch profiler start failed: %s", e)
            return False
        path = os.path.join(logdir, tag, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
        _depth = 1
        _session = (prof, path)
        logger.info("torch profiler tracing into %s", path)
        return True


def profile_stop() -> None:
    """Release one hold on the session; the last release stops it and
    writes the trace."""
    global _depth, _session
    with _lock:
        if _depth == 0:
            return
        _depth -= 1
        if _depth > 0:
            return
        prof, path = _session
        _session = None
        try:
            prof.stop()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            prof.export_chrome_trace(path)
        except Exception as e:  # noqa: BLE001 - profiling is best-effort
            logger.debug("torch profiler stop failed: %s", e)


def profiling_active() -> bool:
    with _lock:
        return _depth > 0
