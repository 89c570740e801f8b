"""Work of the mel encode of one call: the float32 signal read once, the
window and the band table read once, the log-mel written once; a real FFT,
the window product, the magnitudes (3 a bin), two operations a band tap
of each channel and two a band for the log, every frame."""
import functools

import numpy as np

from portbench.harness.yardstick import fft_ops
from portbench.reference import dsp


@functools.lru_cache(maxsize=4)
def band_taps(n_bins: int, mels: int, fmin: float, fmax: float) -> int:
    """Summed widths of the bands' spans (first to last non-zero bin)."""
    nz = dsp.mel_weights(n_bins, mels, fmin, fmax) != 0
    any_nz = nz.any(axis=1)
    lo = np.where(any_nz, nz.argmax(axis=1), 0)
    hi = np.where(any_nz, n_bins - nz[:, ::-1].argmax(axis=1), 0)
    return int((hi - lo).sum())


def work(shape: dict, cfg: dict) -> tuple[float, float]:
    c = cfg["codec"]
    n, mels = c["resolut"], c["num_mels"]
    rows, frames = shape["rows"], shape["frames"]
    taps = 2 * band_taps(n // 2, mels, c["mel_fmin"], c["mel_fmax"])
    n_bytes = 4.0 * (rows * shape["samples"] + n + 2 * taps
                     + rows * frames * mels * 2)
    ops = rows * frames * (fft_ops(n) + n + 3 * (n // 2 + 1) + 2 * taps
                           + 2 * mels)
    return n_bytes, float(ops)
