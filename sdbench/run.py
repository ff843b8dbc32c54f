"""Run one cell of the benchmark on the card it is started on.

    python3 sdbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the card's name and power limit,
and the checks with their limits, on standard error, and one JSON line
last on standard output. Exits with another code than 0, and prints no
result, where the cell's CUDA devices are missing or the run loaded JAX
or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # kernel and build caches at fixed paths inside the checkout, so that
    # only a checkout's first run builds
    cache = os.path.join(ROOT, ".sdbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)
    from sdbench.core import harness

    return harness.main(args, ROOT, T0)


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # the node is down, its directory gone and every thread done: end here,
    # without the interpreter's and the CUDA libraries' teardown, which
    # after a profiled window takes seconds of its own
    os._exit(rc)
