"""Seconds per pass in the pair search's blocks (the product, the
threshold and pack, nonzero, the decode and the pairs to the host): the
program's `duplicates.near.block` spans, summed."""

from sdbench.core.program_spans import per_pass


def read(ctx):
    return per_pass(ctx, "duplicates.near.block")
