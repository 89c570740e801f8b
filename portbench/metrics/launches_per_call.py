"""Kernel launches a call: the program's ``Kernel.launches`` counters
(the ``xla`` route's among them) over the window, divided by the calls
submitted in it."""


def read(ctx):
    n = ctx.window.attempted
    return sum(ctx.launches.values()) / n if n else None
