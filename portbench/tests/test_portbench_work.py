"""The stage work formulas against shapes worked by hand (n = 8, hop 4:
a real FFT of 8 points is 2.5 * 8 * 3 = 60 operations)."""
import numpy as np
import pytest

from portbench.harness import yardstick
from portbench.harness.manifest import Manifest
from portbench.reference import dsp

CFG = {"codec": {"resolut": 8, "window": 4, "num_mels": 2, "mel_fmin": 0.0,
                 "mel_fmax": 8000.0, "num_freqs": 3}}


def work(stage, shape):
    return Manifest().stage(stage)[1].work(shape, CFG)


def test_fft_ops():
    assert yardstick.fft_ops(8) == 60.0
    assert yardstick.fft_ops(4096) == 122880.0


def test_least_seconds_takes_the_larger_bound():
    assert yardstick.least_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert yardstick.least_seconds(0.0, 67e12) == pytest.approx(1.0)
    assert yardstick.least_seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_mel_encode_work():
    w = dsp.mel_weights(4, 2, 0.0, 8000.0)
    taps = 0
    for row in w:
        nz = np.flatnonzero(row)
        taps += (nz[-1] + 1 - nz[0]) if nz.size else 0
    taps *= 2     # both channels
    shape = {"rows": 2, "samples": 16, "frames": 3}
    n_bytes, ops = work("mel_encode", shape)
    assert n_bytes == 4 * (2 * 16 + 8 + 2 * taps + 2 * 3 * 2 * 2)
    assert ops == 2 * 3 * (60 + 8 + 3 * 5 + 2 * taps + 2 * 2)


def test_gl_work():
    shape = {"rows": 1, "frames": 2, "out_len": 12, "iterations": 2}
    n_bytes, ops = work("gl", shape)
    # start signal, magnitudes [2, 5], window; int16 samples, one flag
    assert n_bytes == 4 * 12 + 4 * 2 * 5 + 4 * 8 + 2 * 12 + 1
    # per iteration: 2 frames x (2 FFTs, 2 window products, 12 a bin),
    # 12 samples x 2 overlapping frames
    assert ops == 2 * (2 * (120 + 16 + 60) + 12 * 2)


def test_phase_encode_work():
    shape = {"rows": 1, "samples": 12, "frames": 2, "out_len": 12}
    n_bytes, ops = work("phase_encode", shape)
    assert n_bytes == 2 * 12 + 4 * 8 + 12 + 16
    assert ops == 12 + 2 * (60 + 8) + 6 * 12


def test_phase_decode_work():
    shape = {"rows": 1, "samples": 12, "frames": 2, "out_len": 12}
    n_bytes, ops = work("phase_decode", shape)
    assert n_bytes == 12 + 16 + 4 * 8 + 2 * 12 + 1
    assert ops == 3 * 12 + 2 * (60 + 8) + 12 * (2 + 5)
