"""Read the control's numbers at a cell's own size, several seeds in one
process.

    python3 sdbench/calibrate.py --workload photos_1m.dedup --seeds 11 12 13

The control is the plain reference put in the program's place with one
guarantee broken: the pair search keeps only pairs whose hashes agree
exactly on one of four 16-bit chunks (a multi-index hash's candidate
filter with exact probes, which finds every pair within 3 bits and
misses others within the threshold). Its answer goes through the cell's
own check against the full reference, and each seed prints one JSON
line with the numbers beside their limits; the control has to exceed a
limit on every seed. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_CHUNKS = 4  # the multi-index hash's chunks: exact to 3 bits


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from sdbench.core.spec import Spec
    from sdbench.reference import dedup

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    config = spec.config(cell.config)
    traffic = spec.traffic(cell.traffic)
    check = spec.module("checks", traffic["check"])
    gen = spec.module("gen", config["gen"])
    args_gen = spec.module("args", traffic["args"]["gen"])
    failed_everywhere = True
    for seed in args.seeds:
        data = gen.make(config, seed)
        arg = args_gen.make(traffic["args"], data, seed)(0)
        t0 = time.perf_counter()
        expected = check.expect(data, arg, "cuda")
        t1 = time.perf_counter()
        control = dedup.expect(data, int(arg["threshold"]), "cuda", probe_chunks=PROBE_CHUNKS)
        t2 = time.perf_counter()
        numbers = check.judge(control.as_result(), expected)
        fails = any(numbers[k] > lim for k, lim in check.LIMITS.items())
        failed_everywhere &= fails
        print(json.dumps({
            "workload": cell.name, "seed": seed, "control": f"probe_chunks={PROBE_CHUNKS}",
            "numbers": {k: {"value": v, "limit": check.LIMITS[k]} for k, v in numbers.items()},
            "control_fails": fails, "near_groups": sum(expected.near.values()),
            "exact_groups": sum(expected.exact.values()),
            "reference_s": t1 - t0, "control_s": t2 - t1,
        }), flush=True)
    return 0 if failed_everywhere else 1


if __name__ == "__main__":
    sys.exit(main())
