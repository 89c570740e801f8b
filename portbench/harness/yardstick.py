"""The peaks and the work arithmetic the roofline shares are measured against.

A frozen copy of ``chip_smoke.py``'s ``bound`` and ``fft_ops`` and its
peaks: NVIDIA's published H100 SXM figures (dense, no sparsity, at the
card's full 700 W). A share is stated beside the card's power limit. Bytes
are counted by the stage formulas (stages/*.py): each input byte read once,
each output byte written once.
"""
from __future__ import annotations

import math

HBM_BYTES_S = 3.35e12      # HBM3 bandwidth
FP32_FLOP_S = 67e12        # float32 outside the tensor cores


def fft_ops(n: int) -> float:
    """Operations of one real FFT of n points (the usual 2.5 n log2 n)."""
    return 2.5 * n * math.log2(n)


def least_seconds(n_bytes: float, ops: float) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the float32 rate: the least time the card could take."""
    return max(n_bytes / HBM_BYTES_S, ops / FP32_FLOP_S)
