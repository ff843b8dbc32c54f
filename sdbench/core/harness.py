"""One run of one cell: set-up, the measured window, the check, the line.

Everything that belongs to one configuration or traffic mix is found by
name (spec.py): the configuration's `gen` makes its data from the seed
and installs it where a node finds it; the traffic's `args` gives each
call its argument, its `loop` drives the calls, its `check` judges the
answers against the plain reference.

Set-up makes the data, installs it under a new node's data directory,
starts the Node as the desktop host starts it (`Node(data_dir, device)`,
`start()`, the HTTP API on 127.0.0.1; peer-to-peer off, since a run has
no network), so that it loads the library from disk, lets the generator
set the library's connection as the host would have it, and warms every
shape the window uses by the traffic's `warm` module.
The window then runs the traffic's loop through `node.router.exec`, the
in-process rspc path behind the admission gate. Once the window has
closed and the node has shut down, the plain reference works the answer
out again from the generated data and the check judges a sample of the
window's answers drawn from the seed: the first or the second call's,
and the last call's.

With trace on, the window also runs under `torch.profiler`, and the
program's functions that the traffic file lists are wrapped in spans
(spans.py); the line then carries the per-layer metrics, read by
`sdbench/metrics/<name>.py`, instead of the end-to-end ones.
"""

from __future__ import annotations

import asyncio
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any

from . import guard
from .peaks import Peaks, for_device
from .spans import Spans
from .spec import Cell, Spec
from .trace import DeviceTrace, TraceSummary


@dataclass
class ReadContext:
    """What a per-layer metric's reader reads."""

    spans: dict[str, list[tuple[float, float]]]
    counters: collections.Counter
    calls: int  # completed calls in the window
    trace: TraceSummary | None
    items: int  # the data's `n`: the items the configuration holds (hashes, here)
    peaks: Peaks | None


@dataclass
class Window:
    """What the measured window left behind."""

    calls: list = field(default_factory=list)
    answers: dict[int, tuple[Any, Any]] = field(default_factory=dict)  # (arg, answer)
    setup_s: float = 0.0
    peak_setup: int = 0
    peak_window: int = 0
    closed: float = 0.0  # perf_counter when the window's last call ended
    spans: Spans = field(default_factory=Spans)
    trace: TraceSummary | None = None


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def early_judged(seed: int) -> int:
    """The early call whose answer is judged beside the last one: the
    first or the second, drawn from the seed."""
    import numpy as np

    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 2]))
    return int(rng.integers(0, 2))


async def _window(spec: Spec, config: dict, traffic: dict, gen: Any, data: Any, seed: int,
                  seconds: float, trace: bool, device: str, tmp: str, t0: float) -> Window:
    import torch

    from spacedrive_tpu_torch.node.node import Node

    cuda = device == "cuda"
    out = Window()
    node = Node(os.path.join(tmp, "node"), device=device)
    node.config.config.p2p.enabled = False
    node.config.save()
    t_gen = time.perf_counter()
    library_id = gen.install(node, config, data, seed, tmp)
    t_install = time.perf_counter()
    await node.start()
    try:
        await node.start_api("127.0.0.1", 0)
        await gen.started(node, config, library_id)
        t_node = time.perf_counter()
        procedure = traffic["procedure"]
        arg = spec.module("args", traffic["args"]["gen"]).make(traffic["args"], data, seed)
        loop = spec.module("loops", traffic["loop"])

        def send(a: Any):
            return node.router.exec(node, procedure, a, library_id=library_id)

        await spec.module("warm", traffic["warm"]).run(node, library_id, data, arg(0))
        t_warm = time.perf_counter()
        print(f"sdbench: set-up: imports and data {t_gen - t0:.3f} s, install "
              f"{t_install - t_gen:.3f} s, node {t_node - t_install:.3f} s, "
              f"warm-up {t_warm - t_node:.3f} s", file=sys.stderr, flush=True)
        if cuda:
            torch.cuda.synchronize()
            out.peak_setup = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        early = early_judged(seed)

        def keep(index: int, a: Any, answer: Any) -> None:
            """Hold the early call's answer and the latest one."""
            for old in [i for i in out.answers if i != early]:
                del out.answers[old]
            out.answers[index] = (a, answer)

        out.setup_s = time.perf_counter() - t0
        prof = None
        if trace:
            for s in traffic.get("spans", ()):
                out.spans.wrap(s["target"], s["name"], s.get("mode", "call"))
            prof = DeviceTrace(cuda)
            prof.__enter__()
        try:
            out.calls = await loop.run(send, arg, traffic, seconds, keep)
        finally:
            out.closed = time.perf_counter()
            if prof is not None:
                prof.__exit__(None, None, None)
            out.spans.unwrap()
        if cuda:
            torch.cuda.synchronize()
            out.peak_window = torch.cuda.max_memory_allocated()
        for c in out.calls:
            out.spans.add("pass", c.start, c.end)
        print("sdbench: window calls (s): " + ", ".join(f"{c.seconds:.3f}" for c in out.calls),
              file=sys.stderr, flush=True)
        if prof is not None and out.calls:
            t_read = time.perf_counter()
            out.trace = prof.summary((min(c.start for c in out.calls),
                                      max(c.end for c in out.calls)))
            print(f"sdbench: the trace: stopped in {t_read - out.closed:.3f} s, read in "
                  f"{time.perf_counter() - t_read:.3f} s", file=sys.stderr, flush=True)
    finally:
        await node.shutdown()
    return out


def _e2e_value(stat: str, w: Window) -> float | None:
    done = [c for c in w.calls if c.error is None]
    if stat == "setup_s":
        return w.setup_s
    if not done:
        return None
    if stat == "mean_call_s":
        return sum(c.seconds for c in done) / len(done)
    raise ValueError(f"unknown end-to-end statistic {stat!r}")


def run_cell(spec: Spec, cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None,
             made: Future | None = None) -> dict[str, Any]:
    """Run `cell` once and return the result line's object (without the
    exit-time import check). `made` is the configuration's `make` for
    this seed, already started (`make_in_background`)."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    config = spec.config(cell.config)
    traffic = spec.traffic(cell.traffic)
    check = spec.module("checks", traffic["check"])
    gen = spec.module("gen", config["gen"])
    data = made.result() if made is not None else gen.make(config, seed)
    tmp = tempfile.mkdtemp(prefix="sdbench-")
    try:
        w = asyncio.run(_window(spec, config, traffic, gen, data, seed, seconds, trace, device,
                                tmp, t0))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cuda = device == "cuda"
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    dev: dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": kind,
        "count": cell.chips,
        "memory_peak_bytes": max(w.peak_setup, w.peak_window),
    }
    if cuda:
        torch.cuda.empty_cache()

    metrics: dict[str, dict[str, Any]] = {}
    e2e = spec.end_to_end(cell)
    stats = dict(traffic["end_to_end"], setup_s="setup_s")
    if not trace:
        for m in e2e:
            v = _e2e_value(stats[m["name"]], w)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        done = [c for c in w.calls if c.error is None]
        ctx = ReadContext(dict(w.spans.spans), w.spans.counters, len(done), w.trace,
                          data.n, for_device(kind))
        for m in spec.per_layer(cell, {m["name"] for m in e2e}):
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if w.trace is not None:
            dev["busy_s"] = w.trace.busy_s
            dev["window_s"] = w.trace.window_s

    t_ref = time.perf_counter()
    worst = {name: 0 for name in check.LIMITS}
    expected: dict[str, Any] = {}
    for a, answer in w.answers.values():
        key = json.dumps(a, sort_keys=True)
        if key not in expected:
            expected[key] = check.expect(data, a, device)
        for name, v in check.judge(answer, expected[key]).items():
            worst[name] = max(worst[name], v)
    print(f"sdbench: after the window: node down {t_ref - w.closed:.3f} s, reference and "
          f"check {time.perf_counter() - t_ref:.3f} s", file=sys.stderr, flush=True)
    failed = sum(1 for c in w.calls if c.error is not None)
    correct = (bool(w.calls) and failed == 0 and bool(w.answers)
               and all(worst[n] <= lim for n, lim in check.LIMITS.items()))
    result: dict[str, Any] = {
        "correct": correct,
        "attempted": len(w.calls),
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if trace and w.trace is not None:
        layers = [(label, w.spans.spans.get(name, [])) for label, name in traffic["layers"]]
        result["breakdown"] = {"device_ops": w.trace.device_ops(),
                               "idle_gaps": w.trace.idle_gaps(layers)}
    errors = [c.error for c in w.calls if c.error is not None]
    if errors:
        print(f"sdbench: {failed} calls failed, the first: {errors[0]}", file=sys.stderr)
    result["checks"] = {n: {"value": worst[n], "limit": lim} for n, lim in check.LIMITS.items()}
    return result


def make_in_background(spec: Spec, cell: Cell, seed: int) -> Future:
    """Start the configuration's `make` for `seed` on a thread of its own,
    so that it runs while torch, the program and the card start."""
    config = spec.config(cell.config)
    gen = spec.module("gen", config["gen"])
    made: Future = Future()

    def body() -> None:
        try:
            made.set_result(gen.make(config, seed))
        except BaseException as e:  # noqa: BLE001 - handed to the waiting thread
            made.set_exception(e)

    threading.Thread(target=body, name="sdbench-make", daemon=True).start()
    return made


def main(args: Any, root: str, t0: float) -> int:
    """The command line's run: refuse without the cards the cell asks
    for, run it, refuse a run that loaded JAX, print the line."""
    spec = Spec(root)
    cell = spec.cell(args.workload)
    made = make_in_background(spec, cell, args.seed)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"sdbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")  # the card's context, while `make` runs
    import spacedrive_tpu_torch.node.node  # noqa: F401 - the program, likewise

    result = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace), "cuda", t0, made)
    print(f"sdbench: card {card_line()}", file=sys.stderr, flush=True)
    found = guard.banned_modules()
    if found:
        print(f"sdbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"sdbench: check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
