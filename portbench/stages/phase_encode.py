"""Work of a call's phase encode: the int16 samples and the window read
once, the uint8 planes and the extrema written once; one conversion a
sample, a real FFT and the window product a frame, and 6 operations a
plane value (extrema, scale, truncate)."""
from portbench.harness.yardstick import fft_ops


def work(shape: dict, cfg: dict) -> tuple[float, float]:
    c = cfg["codec"]
    n, nf = c["resolut"], c["num_freqs"]
    rows, frames = shape["rows"], shape["frames"]
    planes = rows * frames * nf * 2
    n_bytes = 2.0 * rows * shape["samples"] + 4.0 * n + planes + 16.0 * rows
    ops = (rows * shape["samples"] + rows * frames * (fft_ops(n) + n)
           + 6 * planes)
    return n_bytes, float(ops)
