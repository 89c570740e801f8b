"""Work of a call's phase decode: the uint8 planes, the extrema and the
window read once, the int16 samples and finite flags written once; 3
operations a plane value (de-quantize), an inverse real FFT and the window
product a frame, and an add a sample a frame it overlaps plus 5 (the
window-sum division and PCM-16)."""
import math

from portbench.harness.yardstick import fft_ops


def work(shape: dict, cfg: dict) -> tuple[float, float]:
    c = cfg["codec"]
    n, hop, nf = c["resolut"], c["window"], c["num_freqs"]
    rows, frames, out = shape["rows"], shape["frames"], shape["out_len"]
    planes = rows * frames * nf * 2
    n_bytes = planes + 16.0 * rows + 4.0 * n + 2.0 * rows * out + rows
    ops = (3 * planes + rows * frames * (fft_ops(n) + n)
           + rows * out * (math.ceil(n / hop) + 5))
    return n_bytes, float(ops)
