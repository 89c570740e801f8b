"""The phase_encode stage's least time (stages/phase_encode.py at the peaks of
harness/yardstick.py) over its kernels' device time in the traced stretch
(stages/phase_encode.json)."""


def read(ctx):
    return ctx.roofline_pct("phase_encode")
