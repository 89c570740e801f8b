"""FFT backend dispatch (K19): the JAX package's backend names on every
transform.

Counterpart of ``gomel_tpu/ops/fftbackend.py``. :func:`resolve` maps a name,
the transform size and the tensor's device to a route, before anything
launches:

| name | CPU tensor | CUDA tensor |
|---|---|---|
| ``auto`` | ``torch.fft`` | the hand-written FFT kernels KB/KE/KG/KJ ("mxu") where :func:`ct_supported`, else the xla route |
| ``auto_lowp`` | as ``auto`` | as ``auto``, exact |
| ``xla`` | ``torch.fft`` | the xla route: ``torch.fft`` (cuFFT) with the steps around the transform |
| ``mxu`` | ``torch.fft``; raises where :func:`mxu_supported` is false | the hand kernels (the xla route for odd n) |
| ``mm`` | the matmul plain version (ops/dft_mm) | the DFT as one product, kernels KN/KO |

On a TPU the JAX package's ``auto`` takes its matrix-unit FFT for every n
that ``mxu_fft._split`` factors into n1 * n2 with both factors <= 128, and
the library FFT for the rest. The hand kernels take the even ones of those
sizes (:func:`ct_supported`): radix 2 when n/2 is a power of two, else mixed
radix over the prime factors of n/2 (csrc/fft_core.cuh). So on the card the
xla route runs only the sizes the TPU also gives its library FFT (514 =
2 x 257, for one), and odd n, which no codec configuration admits.

``auto_lowp`` is exact on the card, as the JAX package resolves it on every
backend that is not a TPU: its bf16 DFT is reached by the name ``mm``.
Whether the card's ``auto_lowp`` should take KN/KO is open (ROADMAP.md).
``mxu`` and ``auto`` give the same exact float32 transform on the card; the
inverse of the ``mxu`` name (the JAX package's K16, ``mxu_fft.irfft``) is KG.

The xla route is the counterpart of the JAX package's ``jnp.fft`` fallback:
on a CUDA tensor it is chosen by :func:`resolve`, never after a failed
launch. It runs the plain version of the site's kernel (``torch.fft``), and
each of its calls adds one to ``XLA_ROUTE.launches`` at that site.
"""
from __future__ import annotations

import math

import torch

from . import _cuda, dft_mm

XLA_ROUTE = _cuda.Kernel("xla_route", "gomel_tpu_torch/ops/fftbackend.py",
                         "gomel_tpu/ops/fftbackend.py:61")

# the matrix-unit FFT's split rule, copied from gomel_tpu/ops/mxu_fft.py:46-64
# and :106-111 (pinned by tests/test_torch_host.py)
_SPLIT_OVERRIDES = {4096: (32, 128)}


def _split(n: int) -> tuple[int, int]:
    """Pick N1*N2 = n with both factors <= 128: a measured override when we
    have one, else as square as possible."""
    if n in _SPLIT_OVERRIDES:
        return _SPLIT_OVERRIDES[n]
    best = None
    r = int(math.isqrt(n))
    for n1 in range(min(128, n), 0, -1):
        if n % n1 == 0 and n // n1 <= 128:
            n2 = n // n1
            score = abs(n1 - r) + abs(n2 - r)
            if best is None or score < best[0]:
                best = (score, n1, n2)
    if best is None:
        raise ValueError(f"no MXU split for N={n}")
    return best[1], best[2]


def mxu_supported(n: int) -> bool:
    """The sizes the JAX package's ``mxu`` name takes."""
    try:
        _split(n)
        return True
    except ValueError:
        return False


def ct_supported(n: int) -> bool:
    """The sizes of the hand-written FFT kernels: the even sizes the ``mxu``
    name takes. Each runs an n/2-point complex FFT whose prime factors are
    all below 128, and n <= 16384, so two complex buffers of n/2 fit one
    block's shared memory."""
    return n % 2 == 0 and mxu_supported(n)


def resolve(backend: str, n: int, device_type: str = "cpu") -> str:
    """The route of ``backend`` for an n-point transform of a tensor on
    ``device_type``: "mxu" (the hand kernels; ``torch.fft`` on the CPU),
    "xla" or "mm". Unknown names and sizes a name does not take raise
    ``ValueError`` with the JAX package's text."""
    cuda = device_type == "cuda"
    if backend in ("auto", "auto_lowp"):
        return "mxu" if cuda and ct_supported(n) else "xla"
    if backend not in ("xla", "mxu", "mm"):
        raise ValueError(f"unknown fft backend {backend!r}")
    if backend == "mm" and not dft_mm.supported(n):
        raise ValueError(f"fft backend 'mm' does not support n={n} "
                         f"(need even n <= {dft_mm.MAX_N})")
    if backend == "mxu":
        if not mxu_supported(n):
            raise ValueError(f"fft backend 'mxu' does not support n={n}")
        if cuda and not ct_supported(n):
            return "xla"
    return backend


# -- the JAX module's transforms on framed input ([..., n] rows) --------------

def _check_n(name: str, x: torch.Tensor, n: int) -> None:
    if x.shape[-1] != n:
        raise ValueError(f"{name}: last dimension {x.shape[-1]} != n={n}")


# ops/rfft_mag and ops/istft route through resolve, so they are imported
# where they are used


def rfft_planes(x: torch.Tensor, n: int, backend: str = "auto",
                precision=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Real [..., n] -> (re, im) half-spectrum planes [..., n//2 + 1].
    ``precision`` applies to the ``mm`` route only (the FFTs are exact
    float32)."""
    _check_n("rfft_planes", x, n)
    route = resolve(backend, n, x.device.type)
    if route == "mm":
        return dft_mm.rfft(x, n, precision)
    if x.device.type == "cpu":
        spec = torch.fft.rfft(x, dim=-1)
        return spec.real, spec.imag
    from .rfft_mag import stft_planes
    pairs = stft_planes(x.reshape(-1), None, n, n, 0, n // 2 + 1, route)
    pairs = pairs.reshape(x.shape[:-1] + (n // 2 + 1, 2))
    return pairs[..., 1], pairs[..., 0]


def rfft_mag(x: torch.Tensor, n: int, backend: str = "auto",
             precision=None) -> torch.Tensor:
    """Real [..., n] -> |rfft| [..., n//2 + 1]."""
    _check_n("rfft_mag", x, n)
    from .rfft_mag import stft_mag
    mags = stft_mag(x.reshape(-1), None, n, n, backend, precision)
    return mags.reshape(x.shape[:-1] + (n // 2 + 1,))


def irfft_planes(re: torch.Tensor, im: torch.Tensor, n: int,
                 backend: str = "auto", precision=None) -> torch.Tensor:
    """(re, im) half-spectrum [..., n//2 + 1] -> real [..., n]; the
    imaginary parts of DC and Nyquist are ignored, as ``torch.fft.irfft``
    does."""
    from .istft import irfft_window
    return irfft_window(re, im, n, None, backend=backend, precision=precision)
