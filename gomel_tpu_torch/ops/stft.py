"""Hann window, frame gathering and frame chunking.

Counterpart of ``gomel_tpu/ops/stft.py`` (``hann_window``, ``frame_signal``,
``stft``, ``auto_frame_chunk``, ``map_frame_chunks``). On the card the
frames are never gathered: the STFT kernels read them straight from the
signal (ops/rfft_mag.py). ``frame_signal`` serves the plain versions, as a
strided view that copies nothing.
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


def stft(x: torch.Tensor, frame_len: int, hop: int,
         window=None) -> torch.Tensor:
    """Real STFT: x [..., L] -> complex [..., F, frame_len//2 + 1], the rfft
    bins of the hop-spaced frames times ``window`` ([frame_len] array or
    tensor; None: Hann), as gomel_tpu/ops/stft.py:57 ``stft``. On a CUDA
    tensor the bins come from the forward FFT kernel KE
    (ops/rfft_mag.stft_planes: the hand kernels for every size
    ops/fftbackend.ct_supported takes, the xla route for the rest)."""
    from .rfft_mag import stft_planes
    window = window_like(window, frame_len, x)
    pairs = stft_planes(x.contiguous(), window, frame_len, hop, 0,
                        frame_len // 2 + 1)
    return torch.complex(pairs[..., 1], pairs[..., 0])


def auto_frame_chunk(n_frames: int, threshold: int = 3072,
                     chunk: int = 1024) -> int | None:
    """Chunk size policy for the frame-local analysis kernels (copied from
    gomel_tpu/ops/stft.py:77): ``chunk`` once a signal has ``threshold``
    frames or more, else None (no chunking)."""
    return chunk if n_frames >= threshold else None


def map_frame_chunks(x: torch.Tensor, frame_len: int, hop: int, chunk: int,
                     per_chunk_fn) -> torch.Tensor:
    """Run a frame-local analysis over ``chunk``-frame slices of a signal
    [..., L] (gomel_tpu/ops/stft.py:88, K18): ``per_chunk_fn`` maps a
    segment of ``chunk*hop + frame_len - hop`` samples to ``[..., chunk,
    ...]`` frame-wise outputs. The signal is zero-padded so every chunk is
    full, and the result is cut back to the true frame count. The JAX
    program maps over the chunks in one dispatch to keep each chunk's frames
    in a TPU core's fast memory; here it is a host loop that launches the
    kernels once per chunk, on a contiguous copy of each segment."""
    if chunk < 1:
        raise ValueError(f"chunk {chunk} must be >= 1")
    L = x.shape[-1]
    F = num_frames_of(L, frame_len, hop)
    n_chunks = -(-F // chunk)
    seg_len = chunk * hop + frame_len - hop
    need = (n_chunks - 1) * chunk * hop + seg_len
    if need > L:
        x = torch.nn.functional.pad(x, (0, need - L))
    lead = x.ndim - 1
    outs = [per_chunk_fn(x[..., c * chunk * hop: c * chunk * hop + seg_len]
                         .contiguous()) for c in range(n_chunks)]
    return torch.cat(outs, dim=lead).narrow(lead, 0, F)
