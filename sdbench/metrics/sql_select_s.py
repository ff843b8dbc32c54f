"""Seconds per pass in the duplicates query's pHash SELECT and its
`(id, phash)` list: the program's `duplicates.select` span."""

from sdbench.core.program_spans import per_pass


def read(ctx):
    return per_pass(ctx, "duplicates.select")
