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
When n/2 is a power of two the kernels run the register-resident forward
core (csrc/fft_core.cuh, fwd_frame_pow2) on the plan :func:`fwd_plan` gives
and the per-pass twiddles of :func:`_pass_twiddles_np`; the other sizes run
the shared-memory mixed radix. The inverse kernels KG (ops/istft.py) and KJ
(ops/griffinlim.py) run the same core's inverse on the same plan and
tables (:func:`_core_args`).
``backend`` picks the route first (ops/fftbackend.resolve): a size the
kernels do not take goes by the xla route (``torch.fft`` on the card), and
the name ``mm`` by the matmul DFT (ops/dft_mm, kernel KN).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

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


# the register-resident core's launch: points a thread holds, and the
# threads a block aims at while a frame takes fewer
REG_POINTS = 16
BLOCK_THREADS = 128


class FwdPlan(NamedTuple):
    """How KB and KE run an n-point transform when n/2 is a power of two."""
    radices: tuple[int, ...]    # of the Stockham passes, the first first
    threads: int                # a frame: n/2 = threads x points a thread
    frames_per_block: int
    smem_bytes: int             # dynamic shared memory a block

    @property
    def code(self) -> int:
        """log2 of each radix, 4 bits a pass, the first pass in the low
        bits: the kernels' ``radices`` argument."""
        return sum((r.bit_length() - 1) << (4 * i)
                   for i, r in enumerate(self.radices))


@functools.lru_cache(maxsize=None)
def fwd_plan(n: int, points: int = REG_POINTS) -> FwdPlan:
    """The plan of the register-resident core (both directions) for an n
    whose half m is a power of two (n = 4 ... 16384): 16 complex points a
    thread, so m/16 threads a frame (1 below m = 16) and 128 threads a
    block while a frame takes fewer; a first pass of radix 8 (its float4
    loads cover two butterflies), then radix 16 while it fits, then what is
    left (m <= 8: one pass of radix m). The kernels hold the same plan at
    compile time (FwdPlan in csrc/fft_core.cuh) and refuse a launch whose
    plan differs; ``points`` other than REG_POINTS is for builds of the
    core with another kRegPoints (tools/profile_fft.py)."""
    m = n // 2
    if n % 2 or m < 2 or m & (m - 1):
        raise ValueError(f"fwd_plan: n/2 = {n / 2} is not a power of two >= 2")
    p, lp = m.bit_length() - 1, points.bit_length() - 1
    if m < points:
        logs = [p]
    else:
        q = p - (lp - 1)
        logs = [lp - 1] + [lp] * (q // lp) + ([q % lp] if q % lp else [])
    threads = m // min(points, m)
    per_block = max(1, BLOCK_THREADS // threads)
    return FwdPlan(tuple(1 << r for r in logs), threads, per_block,
                   per_block * 2 * m * 4)


def _pass_twiddles_np(n: int, points: int = REG_POINTS) -> np.ndarray:
    """The per-pass twiddles of :func:`fwd_plan`'s passes after the first:
    for a pass of radix R after passes of product ns, exp(-2 pi i t k /
    (ns R)) at (t - 1) ns + k (1 <= t < R, k < ns), the passes one after
    another; computed in float64 and rounded to float32, as interleaved
    (re, im) pairs. One zero pair when the plan has a single pass."""
    plan = fwd_plan(n, points)
    ns, rows = plan.radices[0], []
    for r in plan.radices[1:]:
        t = np.arange(1, r, dtype=np.float64)[:, None]
        k = np.arange(ns, dtype=np.float64)[None, :]
        ang = (-2.0 * np.pi * (t * k) / (ns * r)).reshape(-1)
        rows.append(np.stack([np.cos(ang), np.sin(ang)], axis=-1))
        ns *= r
    if not rows:
        return np.zeros((1, 2), np.float32)
    return np.concatenate(rows).astype(np.float32)


# (kind, n, device) -> a table on that device, uploaded once
_TABLES: dict[tuple[str, int, torch.device], torch.Tensor] = {}


def _table(kind: str, n: int, device: torch.device) -> torch.Tensor:
    key = (kind, n, device)
    if key not in _TABLES:
        make = _twiddles_np if kind == "tw" else _pass_twiddles_np
        _TABLES[key] = torch.from_numpy(make(n)).to(device)
    return _TABLES[key]


def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    return _table("tw", n, device)


def _core_args(n: int, device: torch.device) -> tuple:
    """The FFT kernels' (tw_pass, radices, threads, frames_per_block), KB,
    KE, KG and KJ alike: the register core's per-pass table (the inverse
    conjugates its roots) and plan when n/2 is a power of two, nothing for
    the mixed radix."""
    m = n // 2
    if m < 2 or m & (m - 1):
        return None, 0, 0, 0
    plan = fwd_plan(n)
    return (_table("pass", n, device).data_ptr(), plan.code, plan.threads,
            plan.frames_per_block)


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
    tw_pass, *plan = _core_args(n, dev)
    _cuda.launch("gomel_stft_mag", dev, x.data_ptr(), win_ptr,
                 _twiddles(n, dev).data_ptr(), tw_pass, out.data_ptr(), batch,
                 frames, length, hop, n, *plan)
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
    tw_pass, *plan = _core_args(n, dev)
    _cuda.launch("gomel_stft_planes", dev, x.data_ptr(), win_ptr,
                 _twiddles(n, dev).data_ptr(), tw_pass, out.data_ptr(), batch,
                 frames, length, hop, n, first, count, *plan)
    PLANES_KERNEL.launches += 1
    return out
