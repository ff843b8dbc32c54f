"""Per-layer metric readers, one file each, named as the metric.

Each module has `read(ctx) -> float | None`, where `ctx` is a
`core.harness.ReadContext`: the spans and counters of the traced window,
its completed calls, its device trace, the configuration's row count and
the card's peaks. A reader that finds nothing to read returns None, and
the metric is left out of the line.
"""
