"""Share of the traced stretch in which no kernel, copy or set ran on the
device (mean over the cell's cards), from the profiler's trace."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.events:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
