"""Seconds per pass inside `near_pairs`' next() calls: the ±1 product,
the threshold, the pack, the decode on the device and the pairs to the
host (each block ends in a copy to the host)."""


def read(ctx):
    if not ctx.calls or not ctx.spans.get("near_pairs"):
        return None
    return ctx.counters.get("near_pairs.inside_s", 0.0) / ctx.calls
