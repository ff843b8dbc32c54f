"""Tracing/logging setup.

Parity: the reference's `Node::init_logger` (ref:core/src/lib.rs:183-238)
— rolling file appender + stdout layer + env-filtered levels + a panic
hook recording file/line. Here: stdlib logging with a size-rotating file
handler, `SD_LOG`/`RUST_LOG`-style per-target filters, and an excepthook
that logs uncaught exceptions before the process dies.

Counterpart of `spacedrive_tpu/utils/tracing.py`; every hook also
records the exception in the error ring of `telemetry/events.py`.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys
import threading


DEFAULT_FILTER = "info,spacedrive_tpu_torch=debug"


def _parse_filter(spec: str) -> tuple[int, dict[str, int]]:
    base = logging.INFO
    per_target: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            target, _, lvl = part.partition("=")
            per_target[target] = logging.getLevelName(lvl.strip().upper())
        else:
            base = logging.getLevelName(part.upper())
    return base, per_target


def init_logger(data_dir: str | os.PathLike | None = None, spec: str | None = None) -> None:
    """Set up stdout + rolling-file logging (4 files × 8 MiB, matching
    the reference's 4 rolled daily files)."""
    spec = spec or os.environ.get("SD_LOG") or DEFAULT_FILTER
    base, per_target = _parse_filter(spec)

    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    for h in list(root.handlers):
        root.removeHandler(h)

    fmt = logging.Formatter(
        "%(asctime)s %(levelname).1s %(name)s %(message)s", "%H:%M:%S"
    )
    out = logging.StreamHandler(sys.stderr)
    out.setFormatter(fmt)
    out.setLevel(base)
    root.addHandler(out)

    if data_dir is not None:
        log_dir = os.path.join(os.fspath(data_dir), "logs")
        os.makedirs(log_dir, exist_ok=True)
        fileh = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, "sd.log"), maxBytes=8 << 20, backupCount=4
        )
        fileh.setFormatter(fmt)
        fileh.setLevel(logging.DEBUG)
        root.addHandler(fileh)

    for target, lvl in per_target.items():
        logging.getLogger(target).setLevel(lvl)

    install_excepthooks()


def _record_error_ring(source: str, exc_info) -> None:
    """Mirror an uncaught exception into the flight recorder's error
    ring (lazy import: logging setup must work even if telemetry is
    mid-import)."""
    try:
        from ..telemetry.events import record_error

        record_error(source, None, exc_info=exc_info)
    except Exception:  # noqa: BLE001 - recording must never mask the crash
        pass


def install_excepthooks() -> None:
    """Route every crash surface into the rolling log + error ring:

    - ``sys.excepthook``: main-thread crashes (as before);
    - ``threading.excepthook``: a worker thread (window-pipeline
      producer, to_thread hasher) dying must not vanish into a silent
      default stderr print that rotates away with the terminal;
    - the asyncio side is per-loop — see ``install_loop_excepthook``,
      called by ``Node.start`` on its running loop.
    """

    def hook(exc_type, exc, tb):
        logging.getLogger("panic").critical(
            "uncaught exception", exc_info=(exc_type, exc, tb)
        )
        _record_error_ring("excepthook", (exc_type, exc, tb))
        sys.__excepthook__(exc_type, exc, tb)

    sys.excepthook = hook

    def thread_hook(args: "threading.ExceptHookArgs") -> None:
        if args.exc_type is SystemExit:
            return
        info = (args.exc_type, args.exc_value, args.exc_traceback)
        logging.getLogger("panic").critical(
            "uncaught exception in thread %s",
            getattr(args.thread, "name", "?"), exc_info=info,
        )
        _record_error_ring("thread", info)

    threading.excepthook = thread_hook


def install_loop_excepthook(loop=None) -> None:
    """Asyncio's 'exception was never retrieved' reports go to the
    loop's exception handler, not ``sys.excepthook`` — orphaned-task
    crashes would never reach the rolling log or the error ring without
    this. Installed by ``Node.start`` on its own loop."""
    import asyncio

    if loop is None:
        loop = asyncio.get_event_loop()

    def handler(loop_, context: dict) -> None:
        exc = context.get("exception")
        if exc is not None:
            info = (type(exc), exc, exc.__traceback__)
            logging.getLogger("panic").critical(
                "uncaught asyncio exception: %s",
                context.get("message", ""), exc_info=info,
            )
            _record_error_ring("loop", info)
        else:
            logging.getLogger("panic").critical(
                "asyncio loop error: %s", context.get("message", "")
            )
        loop_.default_exception_handler(context)

    loop.set_exception_handler(handler)
