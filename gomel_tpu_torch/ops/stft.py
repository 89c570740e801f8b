"""Hann window and frame gathering.

Counterpart of ``gomel_tpu/ops/stft.py`` (``hann_window``, ``frame_signal``).
On the card the frames are never gathered: the STFT-magnitude kernel reads
them straight from the signal (ops/rfft_mag.py). ``frame_signal`` serves the
plain versions, as a strided view that copies nothing.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.framing import num_frames


@functools.lru_cache(maxsize=16)
def hann_window(frame_len: int) -> np.ndarray:
    """Symmetric Hann window of length ``frame_len``, float64.

    Matches ``np.hanning`` / gossp's Hanning: 0.5 - 0.5*cos(2*pi*n/(N-1))
    (reference port: phase.py:123)."""
    n = np.arange(frame_len, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (frame_len - 1))


def num_frames_of(length: int, frame_len: int, hop: int) -> int:
    """Frame count ``(L - N)//hop + 1``; raises when the signal is too short
    for one frame."""
    frames = num_frames(length, frame_len, hop)
    if frames <= 0:
        raise ValueError(
            f"signal too short for framing: L={length}, frame_len={frame_len}")
    return frames


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """Overlapping frames: x [..., L] -> [..., F, frame_len] with
    F = (L - frame_len)//hop + 1 (a view of ``x``)."""
    num_frames_of(x.shape[-1], frame_len, hop)
    return x.unfold(-1, frame_len, hop)


def window_like(window, frame_len: int, like: torch.Tensor) -> torch.Tensor:
    """``window`` ([frame_len] array or tensor; None: Hann) as a tensor in
    ``like``'s dtype on its device."""
    if window is None:
        window = hann_window(frame_len)
    return torch.as_tensor(window, dtype=like.dtype, device=like.device)
