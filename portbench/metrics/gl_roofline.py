"""The gl stage's least time (stages/gl.py at the peaks of
harness/yardstick.py) over its kernels' device time in the traced stretch
(stages/gl.json)."""


def read(ctx):
    return ctx.roofline_pct("gl")
