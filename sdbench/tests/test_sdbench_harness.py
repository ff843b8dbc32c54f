"""The harness: names resolve to files, a new configuration, traffic mix
or metric comes as new files, the result line's shape, the refusals."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from sdbench.core import guard, harness
from sdbench.core.spec import Spec, SpecError

from .conftest import REPO, SUBDIRS


def test_names_resolve_to_files():
    spec = Spec(REPO)
    for w in spec.doc["workloads"]:
        cell = spec.cell(w["name"])
        assert spec.config(cell.config)["name"] == cell.config
        traffic = spec.traffic(cell.traffic)
        check = spec.module("checks", traffic["check"])
        assert set(check.LIMITS) and all(v == 0 for v in check.LIMITS.values())
        config = spec.config(cell.config)
        gen = spec.module("gen", config["gen"])
        assert callable(gen.make) and callable(gen.install) and callable(gen.started)
        assert callable(spec.module("args", traffic["args"]["gen"]).make)
        assert callable(spec.module("loops", traffic["loop"]).run)
        assert callable(spec.module("warm", traffic["warm"]).run)
        names = {m["name"] for m in spec.end_to_end(cell)}
        assert {"setup_s", "dedup_s"} <= names
        assert set(traffic["end_to_end"]) <= names
        for m in spec.per_layer(cell, names):
            assert callable(spec.reader(m["name"]))
    with pytest.raises(SpecError):
        spec.cell("no_such.cell")


def test_every_config_and_metric_has_its_file():
    spec = Spec(REPO)
    doc = spec.doc
    for c in doc["configs"]:
        assert c["file"].startswith("sdbench/") and os.path.isfile(spec.path(c["file"]))
        with open(spec.path(c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for m in doc["per_layer"]:
        assert os.path.isfile(spec.path("sdbench", "metrics", f"{m['name']}.py"))
        assert m["moves"] in {e["name"] for e in doc["end_to_end"]}


def _write(root: str, rel: str, text: str) -> None:
    path = os.path.join(root, rel)
    assert not os.path.exists(path), rel
    with open(path, "w") as f:
        f.write(text)


def _add_entries(root: str, **lists) -> None:
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    for key, entries in lists.items():
        bench[key].extend(entries)
    with open(path, "w") as f:
        json.dump(bench, f)


def test_additions_are_new_files_only(tiny_root):
    """A configuration with its own generator, a traffic mix with its own
    argument generator and a per-layer metric, each added as new files
    and entries, every existing file left as it is, run through the
    harness."""
    for sub in SUBDIRS:
        for name in os.listdir(os.path.join(REPO, "sdbench", sub)):
            src = os.path.join(REPO, "sdbench", sub, name)
            if os.path.isfile(src):
                with open(src, "rb") as a, open(os.path.join(tiny_root, "sdbench", sub, name),
                                                "rb") as b:
                    assert a.read() == b.read()
    # a generator of its own: no near clusters, only exact copies
    _write(tiny_root, "sdbench/gen/copies_only.py",
           "from sdbench.gen import library\n"
           "install, started = library.install, library.started\n"
           "def make(config, seed):\n"
           "    data = library.generate(dict(config['library'], near_cluster_share=0), seed)\n"
           "    data.rows = library.build_rows(data, seed)\n"
           "    return data\n")
    with open(os.path.join(tiny_root, "sdbench", "configs", "tiny.json")) as f:
        config = json.load(f)
    config.update(name="copies", gen="copies_only")
    _write(tiny_root, "sdbench/configs/copies.json", json.dumps(config))
    # an argument generator of its own: the threshold changes call by call
    _write(tiny_root, "sdbench/args/threshold_cycle.py",
           "def make(params, data, seed):\n"
           "    return lambda i: {'threshold': params['thresholds'][i % len(params['thresholds'])]}\n")
    with open(os.path.join(tiny_root, "sdbench", "traffic", "dedup.json")) as f:
        traffic = json.load(f)
    traffic["args"] = {"gen": "threshold_cycle", "thresholds": [8, 3]}
    _write(tiny_root, "sdbench/traffic/dedup_cycle.json", json.dumps(traffic))
    _write(tiny_root, "sdbench/metrics/passes_in_window.py",
           "def read(ctx):\n    return float(ctx.calls) if ctx.calls else None\n")
    _add_entries(
        tiny_root,
        configs=[{"name": "copies", "source": "a test", "file": "sdbench/configs/copies.json",
                  "reduced": ["library"], "why": "a test"}],
        workloads=[{"name": "tiny.dedup_cycle", "config": "tiny", "traffic": "dedup_cycle",
                    "chips": 1, "why": "a test"},
                   {"name": "copies.dedup", "config": "copies", "traffic": "dedup",
                    "chips": 1, "why": "a test"}],
        per_layer=[{"name": "passes_in_window", "unit": "calls", "better": "higher",
                    "source": "program_counter", "layer": "router and serve gate",
                    "moves": "dedup_s", "workloads": ["tiny.dedup_cycle"]}])
    spec = Spec(tiny_root)
    r = harness.run_cell(spec, spec.cell("tiny.dedup_cycle"), 2**31 + 101, 1.0, True, "cpu")
    assert r["correct"] is True
    assert r["metrics"]["passes_in_window"]["value"] >= 1
    for name in ("router_s", "dup_sql_s", "group_s", "near_pairs_s"):
        assert r["metrics"][name]["value"] >= 0
    # no device on the CPU: the device's metrics find nothing to read
    assert "near_pairs_roofline" not in r["metrics"] and "device_idle_pct" not in r["metrics"]
    r = harness.run_cell(spec, spec.cell("copies.dedup"), 5, 0.5, False, "cpu")
    assert r["correct"] is True and set(r["metrics"]) == {"dedup_s", "setup_s"}


def test_a_wrong_answer_to_another_argument_is_caught(tiny_root, monkeypatch):
    """Each judged answer is held against the reference for its own
    call's argument: an answer to threshold 8 given for threshold 3 is
    not correct."""
    from spacedrive_tpu_torch.object import duplicates

    _write(tiny_root, "sdbench/args/threshold_cycle.py",
           "def make(params, data, seed):\n    return lambda i: {'threshold': 3}\n")
    with open(os.path.join(tiny_root, "sdbench", "traffic", "dedup.json")) as f:
        traffic = json.load(f)
    traffic["args"] = {"gen": "threshold_cycle"}
    _write(tiny_root, "sdbench/traffic/dedup_cycle.json", json.dumps(traffic))
    _add_entries(tiny_root, workloads=[{"name": "tiny.dedup_cycle", "config": "tiny",
                                        "traffic": "dedup_cycle", "chips": 1, "why": "a test"}])
    orig = duplicates.find_duplicates
    monkeypatch.setattr(duplicates, "find_duplicates",
                        lambda library, threshold=8, device="cuda": orig(library, 8, device))
    spec = Spec(tiny_root)
    r = harness.run_cell(spec, spec.cell("tiny.dedup_cycle"), 17, 0.5, False, "cpu")
    assert r["correct"] is False and r["checks"]["near_groups_diff"]["value"] > 0


def test_result_line_shape(tiny_root):
    spec = Spec(tiny_root)
    r = harness.run_cell(spec, spec.cell("tiny.dedup"), 2**32 + 9, 0.5, False, "cpu")
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(r)
    r = harness.run_cell(spec, spec.cell("tiny.dedup"), 3, 0.5, True, "cpu")
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "checks"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_import_guard_compares_whole_top_level_names():
    assert guard.banned_modules(["spacedrive_tpu_torch", "spacedrive_tpu_torch.ops.cas"]) == []
    assert guard.banned_modules(["spacedrive_tpu.ops.cas", "numpy"]) == ["spacedrive_tpu"]
    assert guard.banned_modules(["jax.numpy", "jaxlib", "flax.linen", "jaxtyping"]) == [
        "flax", "jax", "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    code = (
        "import sys; sys.path.insert(0, {repo!r});"
        "from sdbench.core import guard, harness; from sdbench.core.spec import Spec;"
        "s = Spec({root!r}); r = harness.run_cell(s, s.cell('tiny.dedup'), 1, 0.3, True, 'cpu');"
        "print(r['correct'], guard.banned_modules())"
    ).format(repo=REPO, root=tiny_root)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_cli_refuses_without_the_cells_cards(tmp_path):
    """No CUDA device here: the command exits non-zero and prints no result,
    in the repository and in a tree of BENCHMARK.json and sdbench/ alone."""
    bare = tmp_path / "bare"
    shutil.copytree(os.path.join(REPO, "sdbench"), bare / "sdbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), bare / "BENCHMARK.json")
    for cwd in (REPO, str(bare)):
        out = subprocess.run(
            [sys.executable, "sdbench/run.py", "--workload", "photos_1m.dedup", "--seed", "7",
             "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, timeout=300, cwd=cwd)
        assert out.returncode != 0 and out.stdout.strip() == "", (cwd, out.stdout, out.stderr)


def test_cli_names_an_unknown_cell(tmp_path):
    out = subprocess.run(
        [sys.executable, "sdbench/run.py", "--workload", "nope.dedup", "--seed", "1",
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
