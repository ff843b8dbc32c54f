"""Seconds per pass in the groups' file rows (the IN queries of 900 and
each group's `files`): the program's `duplicates.files` span."""

from sdbench.core.program_spans import per_pass


def read(ctx):
    return per_pass(ctx, "duplicates.files")
