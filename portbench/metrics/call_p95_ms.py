"""95th percentile of the latencies of every call completed in the window:
submission to the end of its last operation, on the device's clock
(harness/loop.py)."""
import numpy as np


def read(ctx):
    lat = [c.latency_ms for c in ctx.window.calls]
    return float(np.percentile(lat, 95)) if lat else None
