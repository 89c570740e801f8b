"""Frozen host arithmetic of the gomel codecs: padding, frame counts, the
Hann window and the two mel filterbanks, all in float64 numpy.

A copy, made once, of the public reference's rules (neurlang/gomel
mel/impl.go:298-384, :429-455, gossp's framing) as the port states them,
so that the yardstick does not move when the program does. It imports
nothing of the program.
"""
from __future__ import annotations

import functools
import math

import numpy as np

_BREAK_HZ = 700.0
_HIGH_Q = 1127.0


def pad_length(n: int, hop: int) -> int:
    """Padded length of ``n`` samples (mel/impl.go:429-455): at least
    15 hops, above that the next multiple of ``hop`` minus one sample."""
    least = 15 * hop
    if n >= least:
        rem = (n - least) % hop
        return n + ((hop - rem - 1) if rem else 0)
    return least - 1


def num_frames(length: int, n: int, hop: int) -> int:
    """``(L - n) // hop + 1`` frames (0 when shorter than a frame)."""
    return (length - n) // hop + 1 if length >= n else 0


def out_length(frames: int, n: int, hop: int) -> int:
    """Length of the overlap-add of ``frames`` frames."""
    return n + (frames - 1) * hop


def hann(n: int) -> np.ndarray:
    """Symmetric Hann window: 0.5 - 0.5 cos(2 pi k / (n - 1))."""
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / (n - 1))


def _mel(hz: float) -> float:
    return _HIGH_Q * math.log(1.0 + hz / _BREAK_HZ)


def _hz(mel: float) -> float:
    return _BREAK_HZ * (math.exp(mel / _HIGH_Q) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_weights(n_bins: int, n_mels: int, fmin: float, fmax: float
                ) -> np.ndarray:
    """Forward filterbank [n_mels, n_bins] of ``domel`` (mel/impl.go:310-345):
    two fractional taps where a band spans two bins, else the sum over
    [lo, hi) divided by hi - lo + 1."""
    step = _mel(fmax) / n_mels
    w = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        vlo = n_bins * (fmin + _hz(step * i)) / (fmax + fmin)
        vhi = n_bins * (fmin + _hz(step * (i + 1))) / (fmax + fmin)
        frac, lo = math.modf(vlo)
        hi = math.floor(vhi)
        if lo < 0:
            lo, frac, hi = 0.0, 0.0, 0
        lo, hi = int(lo), int(hi)
        if lo + 1 == hi:
            w[i, lo] += 1.0 - frac
            w[i, hi] += frac
        else:
            w[i, lo:hi] += 1.0 / (hi - lo + 1)
    return w


@functools.lru_cache(maxsize=8)
def inverse_mel_weights(n_bins: int, n_mels: int, fmin: float, fmax: float
                        ) -> np.ndarray:
    """Inverse filterbank [n_bins, n_mels] of ``undomel``
    (mel/impl.go:347-384): one tap, two fractional taps, or the sum over
    [lo, hi) divided by hi - lo + 1."""
    step = _mel(fmax) / n_mels
    u = np.zeros((n_bins, n_mels))

    def mel_or_inf(hz: float) -> float:
        arg = 1.0 + hz / _BREAK_HZ
        return _HIGH_Q * math.log(arg) if arg > 0 else float("-inf")

    for i in range(n_bins):
        vlo = mel_or_inf(i * (fmax + fmin) / n_bins - fmin) / step
        vhi = mel_or_inf((i + 1) * (fmax + fmin) / n_bins - fmin) / step
        frac, lo = math.modf(vlo) if math.isfinite(vlo) else (0.0, vlo)
        hi = math.floor(vhi) if math.isfinite(vhi) else vhi
        if lo < 0:
            lo, frac, hi = 0.0, 0.0, 0
        lo, hi = int(lo), int(hi)
        if lo == hi:
            u[i, lo] += 1.0
        elif lo + 1 == hi and hi < n_mels:
            u[i, lo] += 1.0 - frac
            u[i, hi] += frac
        else:
            u[i, lo:hi] += 1.0 / (hi - lo + 1.0)
    return u
