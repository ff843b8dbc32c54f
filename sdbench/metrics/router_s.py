"""Seconds per pass in the router and the serve gate: the pass's wall
time (the client's) minus the `find_duplicates` span."""


def read(ctx):
    if not ctx.calls or not ctx.spans.get("find_duplicates"):
        return None
    total = sum(b - a for a, b in ctx.spans["pass"])
    inner = sum(b - a for a, b in ctx.spans["find_duplicates"])
    return (total - inner) / ctx.calls
