"""Real-FFT dispatch for already-framed input.

Counterpart of ``gomel_tpu/ops/fftbackend.py`` (``rfft_planes`` :50,
``rfft_mag`` :65, ``irfft_planes`` :76). The JAX package picks among XLA's
FFT, the matrix-unit FFT and a DFT matmul by a backend name; here the
tensor's device decides: a CUDA tensor goes to a hand-written kernel (frames
laid end to end: hop = n, no window), a CPU tensor to ``torch.fft``.

- ``rfft_mag``: kernel KB (ops/rfft_mag.stft_mag);
- ``rfft_planes``: kernel KE (ops/rfft_mag.stft_planes, bins 0..n/2);
- ``irfft_planes``: kernel KG (ops/istft.irfft_window, no window), which
  ignores the imaginary parts of DC and Nyquist as ``torch.fft.irfft`` does.
"""
from __future__ import annotations

import torch

from .istft import irfft_window
from .rfft_mag import stft_mag, stft_planes


def _check_n(name: str, x: torch.Tensor, n: int) -> None:
    if x.shape[-1] != n:
        raise ValueError(f"{name}: last dimension {x.shape[-1]} != n={n}")


def rfft_mag(x: torch.Tensor, n: int) -> torch.Tensor:
    """Real [..., n] -> |rfft| [..., n//2 + 1]."""
    _check_n("rfft_mag", x, n)
    if x.device.type == "cpu":
        return torch.fft.rfft(x, dim=-1).abs()
    mags = stft_mag(x.reshape(-1), None, n, n)
    return mags.reshape(x.shape[:-1] + (n // 2 + 1,))


def rfft_planes(x: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Real [..., n] -> (re, im) half-spectrum planes [..., n//2 + 1]."""
    _check_n("rfft_planes", x, n)
    if x.device.type == "cpu":
        spec = torch.fft.rfft(x, dim=-1)
        return spec.real, spec.imag
    pairs = stft_planes(x.reshape(-1), None, n, n, 0, n // 2 + 1)
    pairs = pairs.reshape(x.shape[:-1] + (n // 2 + 1, 2))
    return pairs[..., 1], pairs[..., 0]


def irfft_planes(re: torch.Tensor, im: torch.Tensor, n: int) -> torch.Tensor:
    """(re, im) half-spectrum [..., n//2 + 1] -> real [..., n]."""
    return irfft_window(re, im, n, None)
