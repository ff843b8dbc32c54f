"""Resolve a cell of `BENCHMARK.json` to its files, by name.

A configuration lives at the `file` its entry names and a traffic mix
at `sdbench/traffic/<traffic>.json`. The code they name is a module of
its own, found by kind and name at `sdbench/<kind>/<name>.py`:

- `gen`: the configuration's `gen`, which makes its data from the seed,
  installs it where the node finds it and, once the node has started,
  sets it as the host would have it;
- `args`: the traffic's `args.gen`, which gives each call its argument;
- `warm`: the traffic's `warm`, which warms the window's shapes;
- `loops`: the traffic's `loop`, which drives the calls in the window;
- `checks`: the traffic's `check`, which compares answers with the
  plain reference;
- `metrics`: a per-layer metric's reader, by the metric's name.

The root is the directory that holds `BENCHMARK.json`, so a copy of the
tree with more files in it resolves the same way.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import Any, Callable

PACKAGE = "sdbench"


class SpecError(Exception):
    """A name that the spec does not resolve."""


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


def _load_module(path: str, qualname: str) -> ModuleType:
    if not os.path.isfile(path):
        raise SpecError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(qualname, path)
    if spec is None or spec.loader is None:
        raise SpecError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[qualname] = mod  # a dataclass looks its module up there
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """`BENCHMARK.json` under `root`, and the files it names."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.doc: dict[str, Any] = json.load(f)

    def path(self, *parts: str) -> str:
        return os.path.join(self.root, *parts)

    def cell(self, name: str) -> Cell:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return Cell(w["name"], w["config"], w["traffic"], int(w["chips"]))
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict[str, Any]:
        for c in self.doc["configs"]:
            if c["name"] == name:
                with open(self.path(c["file"])) as f:
                    return json.load(f)
        raise SpecError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict[str, Any]:
        path = self.path(PACKAGE, "traffic", f"{name}.json")
        if not os.path.isfile(path):
            raise SpecError(f"no traffic file {path}")
        with open(path) as f:
            return json.load(f)

    def _applies(self, metric: dict[str, Any], cell: Cell) -> bool:
        return "workloads" not in metric or cell.name in metric["workloads"]

    def end_to_end(self, cell: Cell) -> list[dict[str, Any]]:
        """The end-to-end metrics that `cell` reports."""
        return [m for m in self.doc["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: Cell, reported: set[str]) -> list[dict[str, Any]]:
        """The per-layer metrics that `cell` reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        out = []
        for m in self.doc["per_layer"]:
            if "workloads" in m:
                if cell.name in m["workloads"]:
                    out.append(m)
            elif m["moves"] in reported:
                out.append(m)
        return out

    def module(self, kind: str, name: str) -> ModuleType:
        """`sdbench/<kind>/<name>.py`, loaded from this root."""
        return _load_module(self.path(PACKAGE, kind, f"{name}.py"),
                            f"{PACKAGE}_{kind}_{name.replace('.', '_')}")

    def reader(self, metric: str) -> Callable[[Any], float | None]:
        """`read(ctx)` of `sdbench/metrics/<metric>.py`."""
        return self.module("metrics", metric).read
