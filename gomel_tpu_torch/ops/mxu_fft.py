"""The JAX package's matrix-unit FFT module, by name: ``supported``, ``rfft``,
``rfft_mag`` and ``irfft`` with the signatures of ``gomel_tpu/ops/mxu_fft.py``.

The TPU program is a Cooley-Tukey n = n1 x n2 split whose two small DFT
stages run as matmuls on the systolic array (K16 in PERF.md). Its Hopper
counterparts are the register-resident FFT kernels (csrc/fft_core.cuh) that
ops/fftbackend reaches by the backend name ``mxu``: the forward transform is
KE (planes) or KB (magnitudes), the inverse KG. This module adds no kernel;
it routes each call through ops/fftbackend with that name. On a CPU tensor
each runs its plain version (``torch.fft``).

``precision`` is accepted for the JAX signature and changes nothing: the JAX
module lowers it to bf16 passes of the matmuls, the port's FFTs are exact
float32 (anything upstream of ``log()`` stays exact).
"""
from __future__ import annotations

import torch

from . import fftbackend


def supported(n: int) -> bool:
    """Whether the JAX module takes an n-point transform: n = n1 x n2 with
    both factors <= 128 (its split rule, copied into ops/fftbackend). The
    answer is the JAX module's for every n. On the card the hand kernels
    run the even ones of these sizes (ops/fftbackend.ct_supported); an odd
    n goes by the library FFT (the xla route)."""
    return fftbackend.mxu_supported(n)


def rfft(x: torch.Tensor, n: int, precision=None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Real [..., n] -> (re, im) each [..., n//2 + 1]; ValueError where
    :func:`supported` is false. Kernel KE on a CUDA tensor."""
    del precision
    return fftbackend.rfft_planes(x, n, "mxu")


def rfft_mag(x: torch.Tensor, n: int, precision=None) -> torch.Tensor:
    """Real [..., n] -> |rfft| [..., n//2 + 1]. Kernel KB on a CUDA
    tensor."""
    del precision
    return fftbackend.rfft_mag(x, n, "mxu")


def irfft(re_h: torch.Tensor, im_h: torch.Tensor, n: int,
          precision=None) -> torch.Tensor:
    """(re, im) half-spectrum [..., n//2 + 1] -> real signal [..., n], as
    ``torch.fft.irfft(re + i*im, n)``: the imaginary parts of DC and Nyquist
    drop out. Kernel KG on a CUDA tensor."""
    del precision
    return fftbackend.irfft_planes(re_h, im_h, n, "mxu")
