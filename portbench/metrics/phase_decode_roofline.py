"""The phase_decode stage's least time (stages/phase_decode.py at the peaks of
harness/yardstick.py) over its kernels' device time in the traced stretch
(stages/phase_decode.json)."""


def read(ctx):
    return ctx.roofline_pct("phase_decode")
