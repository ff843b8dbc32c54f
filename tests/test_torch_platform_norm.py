"""The port's macOS and Windows watcher normalisers against the JAX
package's: each of tests/test_platform_norm.py's 15 cases runs once on
the JAX machines and once on the port's, with its own assertions, and
every event list either package's `on_raw` and `tick` returned (kind,
path, old path, is_dir, in order) must be equal."""

import importlib.util
import os

import pytest

from spacedrive_tpu.location.watcher import events as jevents
from spacedrive_tpu.location.watcher import platform_norm as jnorm
from spacedrive_tpu_torch.location.watcher import events as pevents
from spacedrive_tpu_torch.location.watcher import platform_norm as pnorm

_spec = importlib.util.spec_from_file_location(
    "jax_platform_norm_cases",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_platform_norm.py"))
cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cases)

CASES = sorted(n for n in vars(cases) if n.startswith("test_"))
PACKAGES = {"jax": (jnorm, jevents), "port": (pnorm, pevents)}


def _wire(events):
    return [(e.kind.value, e.path, e.old_path, e.is_dir) for e in events]


def _recording(cls, log):
    class Recording(cls):
        def on_raw(self, kind, path, now, *args, **kwargs):
            out = super().on_raw(kind, path, now, *args, **kwargs)
            log.append(("raw", cls.__name__, kind, path, now, _wire(out)))
            return out

        def tick(self, now):
            out = super().tick(now)
            log.append(("tick", cls.__name__, now, _wire(out)))
            return out

    return Recording


def test_fifteen_cases():
    assert len(CASES) == 15


@pytest.mark.parametrize("case", CASES)
def test_case_matches_jax(case, monkeypatch):
    logs = {}
    for pkg, (norm, events) in PACKAGES.items():
        log: list = []
        monkeypatch.setattr(cases, "MacOsNormalizer", _recording(norm.MacOsNormalizer, log))
        monkeypatch.setattr(cases, "WindowsNormalizer", _recording(norm.WindowsNormalizer, log))
        monkeypatch.setattr(cases, "EventKind", events.EventKind)
        getattr(cases, case)()
        logs[pkg] = log
    assert logs["jax"], "the case drove no normaliser"
    assert logs["port"] == logs["jax"]
