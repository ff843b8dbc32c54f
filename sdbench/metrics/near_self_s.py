"""Seconds per pass in the grouping's own code (the id and parent lists,
the union of each pair and the hand-over of each pair from the pair
search): the self time of the program's `duplicates.near` span."""

from sdbench.core.program_spans import self_per_pass


def read(ctx):
    return self_per_pass(ctx, "duplicates.near")
