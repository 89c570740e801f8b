"""True audio seconds of every call completed in the window, over the
window's seconds (host clock)."""


def read(ctx):
    return sum(c.audio_s for c in ctx.window.calls) / ctx.window.seconds
