"""Device milliseconds of card-to-card copies a call (the scatter, the
halo exchanges, the gather), summed over the cards in the traced stretch
and divided by its calls."""


def read(ctx):
    t, calls = ctx.trace, ctx.traced
    if t is None or calls is None or not calls.calls:
        return None
    from portbench.harness.trace import copy_kind
    s = sum(e.end - e.start for e in t.events if copy_kind(e.name) == "PtoP")
    return 1e3 * s / len(calls.calls) if s > 0 else None
