"""Seconds per pass in the grouping's final find of every id and its
groups: the program's `duplicates.near.components` span."""

from sdbench.core.program_spans import per_pass


def read(ctx):
    return per_pass(ctx, "duplicates.near.components")
