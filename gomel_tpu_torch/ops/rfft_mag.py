"""Framed, windowed real FFTs: kernels KB (csrc/rfft_mag.cu) and KE
(csrc/phase_encode.cu), which share one float32 FFT body (csrc/fft_core.cuh).

``stft_mag(x, window, n, hop)`` maps a signal [..., L] to
|rfft_n(frame * window)| [..., F, n/2 + 1] with F = (L - n)//hop + 1. It
replaces the TPU's ``frame_signal`` x Hann -> ``mxu_fft.rfft_mag`` pipeline
(gomel_tpu/ops/stft.py:35, gomel_tpu/ops/mxu_fft.py:140).
``stft_planes(x, window, n, hop, first, count)`` gives the (imag, real)
pairs of bins first..first+count-1 instead, [..., F, count, 2]: the phase
encode (gomel_tpu/ops/phase_ops.py:27) and, on framed input, rfft_planes.
On a CUDA tensor each launches its hand-written kernel, which reads every
frame straight from the signal; on a CPU tensor it runs its plain version.
``backend`` picks the route first (ops/fftbackend.resolve): a size the
kernels do not take goes by the xla route (``torch.fft`` on the card), and
the name ``mm`` by the matmul DFT (ops/dft_mm, kernel KN).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _cuda, dft_mm, fftbackend
from .stft import frame_signal, num_frames_of

KERNEL = _cuda.Kernel("stft_mag", "gomel_tpu_torch/csrc/rfft_mag.cu",
                      "gomel_tpu/ops/mxu_fft.py:140")
PLANES_KERNEL = _cuda.Kernel("phase_encode",
                             "gomel_tpu_torch/csrc/phase_encode.cu",
                             "gomel_tpu/ops/phase_ops.py:27")
supported = fftbackend.ct_supported     # the sizes the FFT kernels take


def _twiddles_np(n: int) -> np.ndarray:
    """exp(-2 pi i j / n) for j < n/2, computed in float64 and rounded to
    float32, as interleaved (re, im) pairs."""
    ang = -2.0 * np.pi * np.arange(n // 2, dtype=np.float64) / n
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    return tw.astype(np.float32)


# (n, device) -> the twiddle table on that device, uploaded once
_TWIDDLES: dict[tuple[int, torch.device], torch.Tensor] = {}


def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    key = (n, device)
    if key not in _TWIDDLES:
        _TWIDDLES[key] = torch.from_numpy(_twiddles_np(n)).to(device)
    return _TWIDDLES[key]


def stft_mag_plain(x: torch.Tensor, window: torch.Tensor | None, n: int,
                   hop: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in ``x``'s dtype."""
    frames = frame_signal(x, n, hop)
    if window is not None:
        frames = frames * window
    return torch.fft.rfft(frames, dim=-1).abs()


def _check(name: str, x: torch.Tensor, window: torch.Tensor | None,
           n: int) -> torch.device:
    """Device, dtype and window checks of the CUDA routes."""
    tensors = (x,) if window is None else (x, window)
    dev = _cuda.check_cuda(name, *tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes float32 tensors")
    if window is not None and window.shape != (n,):
        raise ValueError(f"{name}: window shape {tuple(window.shape)} != ({n},)")
    return dev


def stft_mag(x: torch.Tensor, window: torch.Tensor | None, n: int,
             hop: int, backend: str = "auto", precision=None) -> torch.Tensor:
    """|rfft_n| of the hop-spaced frames of ``x`` [..., L], each multiplied by
    ``window`` [n] (None: no window) -> [..., F, n/2 + 1]; ``precision``
    applies to the ``mm`` route only."""
    route = fftbackend.resolve(backend, n, x.device.type)
    if route == "mm":
        return dft_mm.stft_mag(x, n, hop, window, precision)
    if x.device.type == "cpu":
        return stft_mag_plain(x, window, n, hop)
    dev = _check("stft_mag", x, window, n)
    if route == "xla":
        fftbackend.XLA_ROUTE.launches += 1
        return stft_mag_plain(x, window, n, hop)
    lead, length = x.shape[:-1], x.shape[-1]
    frames = num_frames_of(length, n, hop)
    batch = int(np.prod(lead, dtype=np.int64))
    out = torch.empty(lead + (frames, n // 2 + 1), dtype=torch.float32,
                      device=dev)
    if batch == 0:
        return out
    win_ptr = None if window is None else window.data_ptr()
    _cuda.launch("gomel_stft_mag", dev, x.data_ptr(), win_ptr,
                 _twiddles(n, dev).data_ptr(), out.data_ptr(), batch, frames,
                 length, hop, n)
    KERNEL.launches += 1
    return out


def stft_planes_plain(x: torch.Tensor, window: torch.Tensor | None, n: int,
                      hop: int, first: int, count: int) -> torch.Tensor:
    """Plain PyTorch version of the planes kernel, in ``x``'s dtype."""
    frames = frame_signal(x, n, hop)
    if window is not None:
        frames = frames * window
    spec = torch.fft.rfft(frames, dim=-1)[..., first:first + count]
    return torch.stack([spec.imag, spec.real], dim=-1)


def stft_planes(x: torch.Tensor, window: torch.Tensor | None, n: int,
                hop: int, first: int, count: int, backend: str = "auto",
                precision=None) -> torch.Tensor:
    """(imag, real) of rfft_n bins ``first``..``first + count - 1`` of the
    hop-spaced frames of ``x`` [..., L], each multiplied by ``window`` [n]
    (None: no window) -> [..., F, count, 2]; ``precision`` applies to the
    ``mm`` route only."""
    if not (0 <= first and count > 0 and first + count <= n // 2 + 1):
        raise ValueError(f"stft_planes: bins {first}..{first + count - 1} "
                         f"outside 0..{n // 2}")
    route = fftbackend.resolve(backend, n, x.device.type)
    if route == "mm":
        return dft_mm.stft_pairs(x, n, hop, window, first, count, precision)
    if x.device.type == "cpu":
        return stft_planes_plain(x, window, n, hop, first, count)
    dev = _check("stft_planes", x, window, n)
    if route == "xla":
        fftbackend.XLA_ROUTE.launches += 1
        return stft_planes_plain(x, window, n, hop, first, count)
    lead, length = x.shape[:-1], x.shape[-1]
    frames = num_frames_of(length, n, hop)
    batch = int(np.prod(lead, dtype=np.int64))
    out = torch.empty(lead + (frames, count, 2), dtype=torch.float32,
                      device=dev)
    if batch == 0:
        return out
    win_ptr = None if window is None else window.data_ptr()
    _cuda.launch("gomel_stft_planes", dev, x.data_ptr(), win_ptr,
                 _twiddles(n, dev).data_ptr(), out.data_ptr(), batch, frames,
                 length, hop, n, first, count)
    PLANES_KERNEL.launches += 1
    return out
