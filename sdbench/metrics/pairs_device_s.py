"""Seconds per pass on the card inside the pair search's blocks, by the
program's CUDA events: the `device_s` field of the
`duplicates.near.block` spans, summed. None without the field (the
CPU)."""

from sdbench.core.program_spans import per_pass


def read(ctx):
    return per_pass(ctx, "duplicates.near.block",
                    lambda r: (r.get("fields") or {}).get("device_s"))
