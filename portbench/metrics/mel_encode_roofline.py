"""The mel_encode stage's least time (stages/mel_encode.py at the peaks of
harness/yardstick.py) over its kernels' device time in the traced stretch
(stages/mel_encode.json)."""


def read(ctx):
    return ctx.roofline_pct("mel_encode")
