"""Set-up seconds: process start (before torch is imported) to the window's
start, the kernels' build, the inputs and the warm-up of every shape
included (host clock)."""


def read(ctx):
    return ctx.setup_s
