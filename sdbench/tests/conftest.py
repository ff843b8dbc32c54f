"""Fixtures of the benchmark's own tests (CPU; `python -m pytest sdbench/tests`).

`tiny_root` is a copy of the benchmark's data files beside a
`BENCHMARK.json` that adds, as new files and entries only, a small
configuration (`tiny`, 4,096 files cut from `photos_1m`, with the denser
clusters and copies of `DENSE`) and its cell `tiny.dedup`: what a later
change that adds a configuration does.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SUBDIRS = ("configs", "traffic", "gen", "args", "warm", "loops", "metrics", "checks")
TINY_FILES = 4096
#: a denser library than photos_1m's, for the tests: more groups and
#: pairs at small sizes
DENSE = {"near_cluster_share": 0.25, "near_cluster_size": [3, 10], "exact_copy_share": 0.05}


def make_tiny_root(dest: str, files: int = TINY_FILES) -> str:
    os.makedirs(os.path.join(dest, "sdbench"), exist_ok=True)
    for sub in SUBDIRS:
        shutil.copytree(os.path.join(REPO, "sdbench", sub), os.path.join(dest, "sdbench", sub))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(REPO, "sdbench", "configs", "photos_1m.json")) as f:
        tiny = json.load(f)
    tiny["name"] = "tiny"
    tiny["library"].update(DENSE, files=files)
    with open(os.path.join(dest, "sdbench", "configs", "tiny.json"), "w") as f:
        json.dump(tiny, f)
    bench["configs"].append({"name": "tiny", "source": "photos_1m, cut for a CPU test",
                             "file": "sdbench/configs/tiny.json", "reduced": ["library"],
                             "why": "a CPU test's size"})
    bench["workloads"].append({"name": "tiny.dedup", "config": "tiny", "traffic": "dedup",
                               "chips": 1, "why": "a CPU test's size"})
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path / "root"))


@pytest.fixture
def cuda():
    """The card, where there is one; the test skips here otherwise."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
