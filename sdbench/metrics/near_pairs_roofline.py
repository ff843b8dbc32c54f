"""`near_pairs`' share of its roofline, in %: the benchmark's least time
for a pass's pair search (core/roofline.py, at the configuration's row
count and the pairs the pass found) over the device's busy time inside
the block spans of a pass."""

from sdbench.core.roofline import near_pairs_bound_s


def read(ctx):
    blocks = ctx.spans.get("near_pairs.block")
    if not ctx.calls or ctx.trace is None or ctx.peaks is None or not blocks:
        return None
    busy = ctx.trace.busy_within(blocks) / ctx.calls
    if busy <= 0:
        return None
    pairs = ctx.counters.get("near_pairs.items", 0) / ctx.calls
    bound, _which = near_pairs_bound_s(ctx.items, int(pairs), ctx.peaks)
    return 100.0 * bound / busy
