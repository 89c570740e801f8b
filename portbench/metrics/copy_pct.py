"""Share of the traced stretch in which the device ran a copy (host to
device, device to host, device to device, peer), from the profiler's
trace; nothing where no copy ran."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    share = 100.0 * t.copy_s() / t.window_s
    return share if share > 0 else None
