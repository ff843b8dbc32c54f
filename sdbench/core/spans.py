"""Host spans and counters that the benchmark records around the
program's calls, from its own files.

The traced run replaces module attributes of the port for the length of
its window, as the traffic file lists them; the program looks them up at
call time, so the wrappers see every call. The untraced run wraps
nothing. Two kinds of wrapper:

- ``call``: one span per call.
- ``each_next``: the call returns an iterator. One span covers the whole
  iteration; the seconds spent inside ``next()`` and the items it gave
  are counters (``<name>.inside_s``, ``<name>.items``); and each
  ``next()`` that lasts ``BLOCK_MIN_S`` or more is a span of its own
  (``<name>.block``). Those are the calls that do a block's work; the
  per-item yields between them are summed, not stored.

Times are `time.perf_counter()` seconds.
"""

from __future__ import annotations

import collections
import functools
import importlib
import threading
import time
from collections.abc import Iterator
from typing import Any, Callable

BLOCK_MIN_S = 50e-6
_END = object()


class Spans:
    """Spans by name (lists of (start, end)) and counters by name."""

    def __init__(self) -> None:
        self.spans: dict[str, list[tuple[float, float]]] = collections.defaultdict(list)
        self.counters: collections.Counter[str] = collections.Counter()
        self._lock = threading.Lock()
        self._undo: list[Callable[[], None]] = []

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.spans[name].append((t0, t1))

    def count(self, name: str, value: float) -> None:
        with self._lock:
            self.counters[name] += value

    # --- wrapping ---------------------------------------------------------

    def _wrap_call(self, name: str, fn: Callable[..., Any]) -> Callable[..., Any]:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(name, t0, time.perf_counter())

        return wrapper

    def _wrap_each_next(self, name: str, fn: Callable[..., Any]) -> Callable[..., Any]:
        block = f"{name}.block"

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Iterator[Any]:
            clock = time.perf_counter
            start = clock()
            inside = 0.0
            items = 0
            it = iter(fn(*args, **kwargs))
            try:
                while True:
                    t0 = clock()
                    item = next(it, _END)
                    t1 = clock()
                    inside += t1 - t0
                    if t1 - t0 >= BLOCK_MIN_S:
                        self.add(block, t0, t1)
                    if item is _END:
                        return
                    items += 1
                    yield item
            finally:
                self.add(name, start, clock())
                self.count(f"{name}.inside_s", inside)
                self.count(f"{name}.items", items)

        return wrapper

    def wrap(self, target: str, name: str, mode: str = "call") -> None:
        """Replace `module:attr` (`target`) with a recording wrapper until
        `unwrap()`."""
        mod_name, _, attr = target.partition(":")
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)
        if mode == "call":
            new = self._wrap_call(name, orig)
        elif mode == "each_next":
            new = self._wrap_each_next(name, orig)
        else:
            raise ValueError(f"unknown span mode {mode!r}")
        setattr(mod, attr, new)
        self._undo.append(lambda: setattr(mod, attr, orig))

    def unwrap(self) -> None:
        while self._undo:
            self._undo.pop()()
