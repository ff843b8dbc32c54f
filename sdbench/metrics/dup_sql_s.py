"""Seconds per pass in the duplicates query outside the grouping: the
`find_duplicates` span minus the `duplicate_groups` span (the pHash
SELECT, the exact GROUP BY, the file rows)."""


def read(ctx):
    if not ctx.calls or not ctx.spans.get("duplicate_groups"):
        return None
    outer = sum(b - a for a, b in ctx.spans.get("find_duplicates", ()))
    inner = sum(b - a for a, b in ctx.spans["duplicate_groups"])
    return (outer - inner) / ctx.calls
