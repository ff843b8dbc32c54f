"""Seconds per pass in which the card is idle inside the pair search's
blocks: the program's `duplicates.near.block` spans' length minus the
device trace's busy time within them. None where the trace saw no
device activity."""

from sdbench.core.program_spans import spans_of


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    blocks, passes = spans_of(ctx, "duplicates.near.block")
    if not blocks:
        return None
    return (sum(b - a for a, b in blocks) - ctx.trace.busy_within(blocks)) / passes
