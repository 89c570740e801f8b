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
and the per-pass twiddles of :func:`_pass_twiddles_np`; at the other sizes
the mixed-radix register core (fwd_frame_mixed) on the plan
:func:`mixed_plan` gives and the table of :func:`_mixed_twiddles_np`. The
inverse kernels KG (ops/istft.py) and KJ (ops/griffinlim.py) run the same
cores' inverses on the same plans and tables; :func:`fft_tables` and
:func:`fft_plan_args` hand all four the tables and plan of their size.
``backend`` picks the route first (ops/fftbackend.resolve): a size the
kernels do not take goes by the xla route (``torch.fft`` on the card), and
the name ``mm`` by the matmul DFT (ops/dft_mm, kernel KN).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import annotate
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
    """How the FFT kernels (KB, KE, KG, KJ) run an n-point transform when
    n/2 is a power of two."""
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


# the mixed-radix register core (csrc/fft_core.cuh, MixedPlan): the radices
# it computes in registers (2^a 3^b 5^c 7^d up to 16: small DFTs with
# literal roots, composites as prime-factor nests; radix 20, 24 and 30 cost
# the kernels 128 registers instead of 64 and 20-35% of their time,
# tools/profile_fft.py), the most complex points a thread does a pass, the
# threads a block may have, the most passes a plan may have (the radices go
# 8 bits a pass into one int64), and the registers ptxas gives the kernels
MIXED_RADICES = (2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 15, 16)
MIXED_MAX_POINTS = 64
MIXED_BLOCK_THREADS = 256
MIXED_MAX_PASSES = 8
MIXED_REGISTERS = 64
MAX_SMEM_BYTES = 232_448    # dynamic shared memory a block can have
SM_SMEM_BYTES = 233_472     # shared memory an SM (each block reserves 1 KB)
_WIDE_COST = 0.6    # a plan's cost of more than 32 points a thread


class MixedPlan(NamedTuple):
    """How the FFT kernels (KB, KE, KG, KJ) run an n-point transform when
    n/2 is not a power of two."""
    radices: tuple[int, ...]    # of the passes, the first first
    points: int                 # complex points a thread does a pass
    threads: int                # a frame: n/2 = threads x points
    frames_per_block: int
    smem_bytes: int             # dynamic shared memory a block
    # each pass: in registers (its radix one of the build's MIXED_RADICES,
    # dividing points), else a generic shared-memory pass, a thread an
    # output
    in_registers: tuple[bool, ...]

    @property
    def code(self) -> int:
        """Each radix in 8 bits, the first pass in the low bits: the
        kernels' ``radices`` argument."""
        return sum(r << (8 * i) for i, r in enumerate(self.radices))


def _frames_per_block(threads: int, stride: int) -> int:
    """The frames a block of the mixed core that keep the most threads
    resident on an SM, the larger on a tie: a block's threads at most
    MIXED_BLOCK_THREADS, its shared memory (stride float2 a frame) at most
    MAX_SMEM_BYTES; an SM holds SM_SMEM_BYTES of shared memory (1 KB of it
    a block), 65,536 registers (MIXED_REGISTERS a thread, whole warps), 64
    warps and 32 blocks."""
    best = (0, 1)
    for frames in range(1, max(1, MIXED_BLOCK_THREADS // threads) + 1):
        smem = frames * stride * 8
        if smem > MAX_SMEM_BYTES:
            break
        warps = -(-threads * frames // 32)
        blocks = min(32, SM_SMEM_BYTES // (smem + 1024), 64 // warps,
                     65_536 // (MIXED_REGISTERS * 32 * warps))
        best = max(best, (blocks * threads * frames, frames))
    return best[1]


def _divisors(m: int) -> list[int]:
    return [d for d in range(1, m + 1) if m % d == 0]


@functools.lru_cache(maxsize=None)
def mixed_plan(n: int, radices: tuple[int, ...] = MIXED_RADICES) -> MixedPlan:
    """The plan of the mixed-radix register core (both directions) for an n
    that the FFT kernels take (``supported``) whose half m is not a power of
    two. For each count of points a thread, P (a divisor of m up to
    MIXED_MAX_POINTS, leaving at most MIXED_BLOCK_THREADS threads a frame),
    m is split into radices at the least cost: 1 a register pass (a radix
    of MIXED_RADICES that divides P, so every thread of the frame does P/R
    butterflies of every such pass), 1 + R/4 a generic pass (any other
    factor R, up to 127: one thread an output, R reads of shared memory
    each), and _WIDE_COST more for P above 32. The cheapest P wins (the
    smaller on a tie). The register passes go first, from the largest
    radix down, the generic passes last. Frames a block:
    :func:`_frames_per_block`. m = 1500 (n = 3000) is 15 x 10 x 10 with 30
    points a thread, 50 threads a frame and 3 frames a block; no m takes
    more passes than the one-prime-a-pass route the core
    replaced. ``radices`` other than MIXED_RADICES is for builds of the core
    with other register radices (tools/profile_fft.py)."""
    m = n // 2
    if n % 2 or m < 2 or not m & (m - 1) or not supported(n):
        raise ValueError(f"mixed_plan: n = {n} is not a size of the mixed "
                         f"core (even, n/2 not a power of two, split n1 x n2 "
                         f"<= 128)")
    best = None
    for points in _divisors(m):
        if points > MIXED_MAX_POINTS or m // points > MIXED_BLOCK_THREADS:
            continue
        regs = {r for r in radices if points % r == 0}

        @functools.lru_cache(maxsize=None)
        def split(rest: int) -> tuple[float, tuple[int, ...]]:
            if rest == 1:
                return 0.0, ()
            options = []
            for r in range(2, min(rest, 127) + 1):
                if rest % r == 0:
                    cost, tail = split(rest // r)
                    options.append((cost + (1.0 if r in regs else 1 + r / 4),
                                    (r,) + tail))
            return min(options)

        cost, factors = split(m)
        cost += _WIDE_COST if points > 32 else 0.0
        if best is None or (cost, points) < best[:2]:
            best = (cost, points, factors)
    _, points, split_m = best
    regs = sorted((r for r in split_m if r in radices and points % r == 0),
                  reverse=True)
    generic = sorted(r for r in split_m if r not in regs)
    threads = m // points
    # a generic pass after the first writes a second buffer of m
    stride = 2 * m if generic and (regs or len(generic) > 1) else m
    per_block = _frames_per_block(threads, stride)
    plan = MixedPlan(tuple(regs + generic), points, threads, per_block,
                     per_block * stride * 8,
                     (True,) * len(regs) + (False,) * len(generic))
    if len(plan.radices) > MIXED_MAX_PASSES:
        raise ValueError(f"mixed_plan: n = {n} needs {len(plan.radices)} "
                         f"passes")
    return plan


def _mixed_twiddles_np(n: int,
                       radices: tuple[int, ...] = MIXED_RADICES) -> np.ndarray:
    """The per-pass table of :func:`mixed_plan`'s passes, one after another:
    a register pass after the first (radix R after passes of product ns)
    has exp(-2 pi i t k / (ns R)) at (t - 1) ns + k (1 <= t < R, k < ns),
    the first none; a generic pass has the ns R roots exp(-2 pi i j /
    (ns R)), j < ns R. Computed in float64 and rounded to float32, as
    interleaved (re, im) pairs; one zero pair when the table is empty."""
    plan = mixed_plan(n, radices)
    ns, rows = 1, []
    for p, r in enumerate(plan.radices):
        if plan.in_registers[p]:
            if p > 0:
                t = np.arange(1, r, dtype=np.float64)[:, None]
                k = np.arange(ns, dtype=np.float64)[None, :]
                ang = (-2.0 * np.pi * (t * k) / (ns * r)).reshape(-1)
                rows.append(np.stack([np.cos(ang), np.sin(ang)], axis=-1))
        else:
            ang = -2.0 * np.pi * np.arange(ns * r, dtype=np.float64) / (ns * r)
            rows.append(np.stack([np.cos(ang), np.sin(ang)], axis=-1))
        ns *= r
    if not rows:
        return np.zeros((1, 2), np.float32)
    return np.concatenate(rows).astype(np.float32)


# (kind, n, device) -> a table on that device, uploaded once
_TABLES: dict[tuple[str, int, torch.device], torch.Tensor] = {}
_MAKERS = {"tw": _twiddles_np, "pass": _pass_twiddles_np,
           "mixed": _mixed_twiddles_np}


def _table(kind: str, n: int, device: torch.device) -> torch.Tensor:
    key = (kind, n, device)
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(_MAKERS[kind](n)).to(device)
    return _TABLES[key]


def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    return _table("tw", n, device)


def _pow2(n: int) -> bool:
    m = n // 2
    return m >= 2 and not m & (m - 1)


def fft_plan_args(n: int) -> tuple[int, int, int]:
    """The FFT kernels' (radices, threads, frames_per_block), KB, KE, KG and
    KJ alike: the power-of-two core's plan (:func:`fwd_plan`) when n/2 is a
    power of two, else the mixed-radix register core's (:func:`mixed_plan`,
    which raises for a size the kernels do not take)."""
    plan = fwd_plan(n) if _pow2(n) else mixed_plan(n)
    return plan.code, plan.threads, plan.frames_per_block


def fft_tables(n: int, device: torch.device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The FFT kernels' two tables on ``device``: the twiddles of
    :func:`_twiddles_np` and the per-pass table of the plan
    (:func:`_pass_twiddles_np` or :func:`_mixed_twiddles_np`; the inverse
    conjugates its roots)."""
    return (_twiddles(n, device),
            _table("pass" if _pow2(n) else "mixed", n, device))


def _fft_args(n: int, device: torch.device) -> tuple:
    """The FFT kernels' (tw_pass, radices, threads, frames_per_block): the
    per-pass table's address, then :func:`fft_plan_args`."""
    return (fft_tables(n, device)[1].data_ptr(), *fft_plan_args(n))


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
    kernel = fftbackend.XLA_ROUTE if route == "xla" else KERNEL
    with annotate(kernel.span):
        dev = _check("stft_mag", x, window, n)
        if route == "xla":
            kernel.launches += 1
            return stft_mag_plain(x, window, n, hop)
        return launch_stft_mag(x, window, *fft_tables(n, dev),
                               fft_plan_args(n), n, hop)


def launch_stft_mag(x: torch.Tensor, window: torch.Tensor | None,
                    tw: torch.Tensor, tw_pass: torch.Tensor,
                    plan: tuple[int, int, int], n: int,
                    hop: int) -> torch.Tensor:
    """Launch KB on checked CUDA tensors (:func:`_check`) with the FFT
    tables and plan of n (:func:`fft_tables`, :func:`fft_plan_args`)."""
    dev = x.device
    lead, length = x.shape[:-1], x.shape[-1]
    frames = num_frames_of(length, n, hop)
    batch = int(np.prod(lead, dtype=np.int64))
    out = torch.empty(lead + (frames, n // 2 + 1), dtype=torch.float32,
                      device=dev)
    if batch == 0:
        return out
    win_ptr = None if window is None else window.data_ptr()
    _cuda.launch("gomel_stft_mag", dev, x.data_ptr(), win_ptr, tw.data_ptr(),
                 tw_pass.data_ptr(), out.data_ptr(), batch, frames, length,
                 hop, n, *plan)
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
    kernel = fftbackend.XLA_ROUTE if route == "xla" else PLANES_KERNEL
    with annotate(kernel.span):
        dev = _check("stft_planes", x, window, n)
        if route == "xla":
            kernel.launches += 1
            return stft_planes_plain(x, window, n, hop, first, count)
        return launch_stft_planes(x, window, *fft_tables(n, dev),
                                  fft_plan_args(n), n, hop, first, count)


def launch_stft_planes(x: torch.Tensor, window: torch.Tensor | None,
                       tw: torch.Tensor, tw_pass: torch.Tensor,
                       plan: tuple[int, int, int], n: int, hop: int,
                       first: int, count: int) -> torch.Tensor:
    """Launch KE on checked CUDA tensors (:func:`_check`) with the FFT
    tables and plan of n."""
    dev = x.device
    lead, length = x.shape[:-1], x.shape[-1]
    frames = num_frames_of(length, n, hop)
    batch = int(np.prod(lead, dtype=np.int64))
    out = torch.empty(lead + (frames, count, 2), dtype=torch.float32,
                      device=dev)
    if batch == 0:
        return out
    win_ptr = None if window is None else window.data_ptr()
    _cuda.launch("gomel_stft_planes", dev, x.data_ptr(), win_ptr,
                 tw.data_ptr(), tw_pass.data_ptr(), out.data_ptr(), batch,
                 frames, length, hop, n, first, count, *plan)
    PLANES_KERNEL.launches += 1
    return out
