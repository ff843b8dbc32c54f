"""Seconds per pass in the grouping outside the pair search: the
`duplicate_groups` span minus the time inside `near_pairs`' next()
calls (the union-find, the ids, the hash list)."""


def read(ctx):
    if not ctx.calls or not ctx.spans.get("duplicate_groups"):
        return None
    outer = sum(b - a for a, b in ctx.spans["duplicate_groups"])
    return (outer - ctx.counters.get("near_pairs.inside_s", 0.0)) / ctx.calls
