"""The benchmark of `spacedrive_tpu_torch` on an NVIDIA H100.

`run.py` runs one cell of `BENCHMARK.json`. Everything that belongs to
one configuration, traffic mix or per-layer metric is a file of its own,
found by the name that `BENCHMARK.json` or the file before it gives:
`configs/` and `traffic/` hold the data files; `gen/` makes a
configuration's data, `args/` each call's argument, `warm/` the warm-up,
`loops/` the calls of the window, `metrics/` the per-layer readers and
`checks/` the comparisons that decide `correct`; `reference/` holds the
plain reference and `core/` the harness that ties them together.
"""
