"""Work of a call's Griffin-Lim iterations: the start signal and the
magnitudes read once, the samples (int16, or ``out_bytes`` each) and finite
flags written once; each
iteration two real FFTs, two window products and 12 operations a bin a
frame (projection), and one add a sample a frame it overlaps
(overlap-add)."""
import math

from portbench.harness.yardstick import fft_ops


def work(shape: dict, cfg: dict) -> tuple[float, float]:
    c = cfg["codec"]
    n, hop = c["resolut"], c["window"]
    rows, frames, out = shape["rows"], shape["frames"], shape["out_len"]
    iters = shape["iterations"]
    n_bytes = (4.0 * rows * out + 4.0 * rows * frames * (n // 2 + 1)
               + 4.0 * n + shape.get("out_bytes", 2) * rows * out + rows)
    ops = iters * (rows * frames * (2 * fft_ops(n) + 2 * n + 12 * (n // 2 + 1))
                   + rows * out * math.ceil(n / hop))
    return n_bytes, float(ops)
