"""Seconds per pass in the pair search before its first block (the
unpack, the pad, the upload, the ±1 operand): the program's
`duplicates.near.prepare` span."""

from sdbench.core.program_spans import per_pass


def read(ctx):
    return per_pass(ctx, "duplicates.near.prepare")
