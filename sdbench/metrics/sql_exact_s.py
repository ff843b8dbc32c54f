"""Seconds per pass in the duplicates query's cas_id GROUP BY and its
exact groups: the program's `duplicates.exact` span."""

from sdbench.core.program_spans import per_pass


def read(ctx):
    return per_pass(ctx, "duplicates.exact")
