"""The real DFT as one matrix product: kernels KN (forward) and KO (inverse),
csrc/dft_mm.cu.

Counterpart of ``gomel_tpu/ops/dft_mm.py`` (K14): the whole transform as one
[frames, N] x [N, 2(N/2+1)] product, or one [frames, 2(N/2+1)] x
[2(N/2+1), N] product for the inverse, with the window folded into the
weights. The float64 weight masters (``_fwd_np``, ``_inv_np``,
``_fold_fwd``, ``_fold_inv``) are copied from the JAX module and pinned to
it by tests/test_torch_host.py.

``precision``: None, "highest" or "high" is the exact float32 transform;
"default" is bf16 operands with float32 accumulation, what a single-pass
DEFAULT matmul is on a TPU. On a CPU tensor every function runs its plain
version, a ``torch.matmul`` against the master cast to the input's dtype, as
the JAX module runs on XLA's CPU backend, where every precision is exact. On
a CUDA tensor "default" launches the kernels' bf16 mode (``wgmma`` on the
tensor cores) and the other three their float32 mode (a SIMT float32
product: the card has no 3-pass bf16 product, so "high" is exact there).

The weights for the kernels are laid out on the host (:func:`_kernel_layout`:
KN's interleaved (re, im) columns, KO's re block then im block, padded to
the tiles and stages, the bf16 contraction permuted within each 16 as the
kernel's register fragments read it: csrc/dft_mm.cu) and cached with their
TMA tensor map per (direction, n, window, mode, device), the window keyed by
its host values as the JAX module folds a host window: at n = 4096 one
direction takes 34.6 MB in bf16, 69.2 MB in float32.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda
from .stft import frame_signal, hann_window, num_frames_of

# the weights are [N, 2(N/2+1)]: cap N so a cached pair stays ~O(100 MB)
MAX_N = 8192
PRECISIONS = (None, "highest", "high", "default")

_SRC = "gomel_tpu_torch/csrc/dft_mm.cu"
FWD_KERNEL = _cuda.Kernel("dft_fwd_bf16", _SRC, "gomel_tpu/ops/dft_mm.py:114")
FWD_F32_KERNEL = _cuda.Kernel("dft_fwd_f32", _SRC,
                              "gomel_tpu/ops/dft_mm.py:114")
INV_KERNEL = _cuda.Kernel("dft_inv_bf16", _SRC, "gomel_tpu/ops/dft_mm.py:126")
INV_F32_KERNEL = _cuda.Kernel("dft_inv_f32", _SRC,
                              "gomel_tpu/ops/dft_mm.py:126")

# KN's epilogues (csrc/dft_mm.cu)
_EPILOGUES = {"planes": 0, "mag": 1, "pairs": 2, "project": 3}
# csrc/dft_mm.cu's tile: 128 x 128 outputs; stage depth 64 (bf16 mode) or
# 32 (float32 mode); a fresh accumulator every 64 of the bf16 contraction
TILE = 128
DEPTH = {"bf16": 64, "f32": 32}
PROMOTE = 64
# the bf16 contraction within each 16: position p of the layout holds sample
# PERM16[p], so the wgmma fragment's k = 2t, 2t+1, 2t+8, 2t+9 are samples
# 4t .. 4t+3, adjacent in the A stage
PERM16 = np.array([0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15])
LOW_ALIGN = 8    # bins a row of KN's bf16 planes is padded to (16 bytes)


def supported(n: int) -> bool:
    return n % 2 == 0 and 2 <= n <= MAX_N


@functools.lru_cache(maxsize=4)
def _fwd_np(n: int) -> np.ndarray:
    """[n, 2*(n//2+1)]: x @ W -> [re | im] rfft planes (float64 master)."""
    k = np.arange(n // 2 + 1)
    nn = np.arange(n)
    ang = 2.0 * np.pi * np.outer(nn, k) / n
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)


@functools.lru_cache(maxsize=4)
def _inv_np(n: int) -> np.ndarray:
    """[2*(n//2+1), n]: [re | im] @ W -> real signal, matching
    ``torch.fft.irfft`` semantics (imag parts of DC/Nyquist ignored)."""
    half = n // 2 + 1
    k = np.arange(half)
    nn = np.arange(n)
    c = np.full(half, 2.0)
    c[0] = 1.0
    c[-1] = 1.0
    ang = 2.0 * np.pi * np.outer(k, nn) / n
    wr = (c[:, None] / n) * np.cos(ang)
    wi = -(c[:, None] / n) * np.sin(ang)
    wi[0] = 0.0   # irfft ignores imag(DC)
    wi[-1] = 0.0  # and imag(Nyquist)
    return np.concatenate([wr, wi], axis=0)


@functools.lru_cache(maxsize=4)
def _fwd_hann_np(n: int) -> np.ndarray:
    return _fwd_np(n) * hann_window(n)[:, None]


@functools.lru_cache(maxsize=4)
def _inv_hann_np(n: int) -> np.ndarray:
    return _inv_np(n) * hann_window(n)[None, :]


def _fold_fwd(n: int, window_np: np.ndarray) -> np.ndarray:
    if window_np is hann_window(n):  # hann_window is lru-cached -> identity
        return _fwd_hann_np(n)
    return _fwd_np(n) * np.asarray(window_np, np.float64)[:, None]


def _fold_inv(n: int, window_np: np.ndarray) -> np.ndarray:
    if window_np is hann_window(n):
        return _inv_hann_np(n)
    return _inv_np(n) * np.asarray(window_np, np.float64)[None, :]


def _check_n(n: int) -> None:
    if not supported(n):
        raise ValueError(f"fft backend 'mm' does not support n={n} "
                         f"(need even n <= {MAX_N})")


def _low(precision, device: torch.device) -> bool:
    """True for the bf16 mode: "default" on a CUDA tensor."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return precision == "default" and device.type == "cuda"


def _master(direction: str, n: int, window_np) -> np.ndarray:
    """The float64 master of ``direction`` ("fwd" [n, 2h], "inv" [2h, n]),
    with the host window ``window_np`` (None: no window) folded in."""
    if window_np is None:
        return _fwd_np(n) if direction == "fwd" else _inv_np(n)
    return (_fold_fwd if direction == "fwd" else _fold_inv)(n, window_np)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _kernel_layout(direction: str, master: np.ndarray, n: int,
                   bf16: bool) -> np.ndarray:
    """The master as the kernel's TMA reads it, float64 -> float32 (the bf16
    mode rounds it to bf16 on its way to the card). KN's output columns
    interleave (cos k, -sin k); KO's contraction is the re block then the im
    block, each zero-padded to a multiple of the stage depth; columns are
    padded to the tile. bf16 mode: [columns, depth], the contraction
    contiguous and permuted within each 16 by ``PERM16``; float32 mode:
    [depth, columns]."""
    half = n // 2 + 1
    d = DEPTH["bf16" if bf16 else "f32"]
    m32 = master.astype(np.float32)
    if direction == "fwd":        # master [n, 2h] -> [depth, cols]
        w = np.zeros((_round_up(n, d), _round_up(2 * half, TILE)), np.float32)
        w[:n, 0:2 * half:2] = m32[:, :half]
        w[:n, 1:2 * half:2] = m32[:, half:]
    else:                         # master [2h, n] -> [depth, cols]
        kh = _round_up(half, d)
        w = np.zeros((2 * kh, _round_up(n, TILE)), np.float32)
        w[:half, :n] = m32[:half]
        w[kh:kh + half, :n] = m32[half:]
    if not bf16:
        return w
    cols, depth = w.shape[1], w.shape[0]
    return np.ascontiguousarray(
        w.T.reshape(cols, depth // 16, 16)[:, :, PERM16].reshape(cols, depth))


class KernelWeights(NamedTuple):
    """A kernel weight layout on the card and its TMA tensor map."""
    w: torch.Tensor          # bf16 [cols, depth] or float32 [depth, cols]
    tmap: ctypes.Array       # 128 bytes: csrc/dft_mm.cu gomel_dft_weight_map
    depth: int               # the padded contraction
    cols: int                # the padded output columns


def kernel_weights_tensor(direction: str, master: np.ndarray, n: int,
                          bf16: bool) -> torch.Tensor:
    """The kernels' layout of ``master`` as a host tensor: bf16 or float32
    (:func:`_kernel_layout`)."""
    w = torch.from_numpy(_kernel_layout(direction, master, n, bf16))
    return w.to(torch.bfloat16) if bf16 else w


def kernel_weights(w: torch.Tensor) -> KernelWeights:
    """A kernel layout already on the card (:func:`kernel_weights_tensor`)
    with its TMA tensor map, built here."""
    bf16 = w.dtype == torch.bfloat16
    tmap = ctypes.create_string_buffer(128)
    _cuda.launch("gomel_dft_weight_map", w.device, ctypes.addressof(tmap),
                 w.data_ptr(), int(bf16), w.shape[0], w.shape[1])
    depth, cols = (w.shape[1], w.shape[0]) if bf16 else w.shape
    return KernelWeights(w, tmap, int(depth), int(cols))


def _kernel_weights(direction: str, master: np.ndarray, n: int, bf16: bool,
                    device: torch.device) -> KernelWeights:
    return kernel_weights(kernel_weights_tensor(direction, master, n, bf16)
                          .to(device))


# (direction, n, window key, kind, device) -> weights; at most 8 entries
# (~0.55 GB at n = 4096 if all were float32 kernel layouts)
_WEIGHTS: dict[tuple, torch.Tensor | KernelWeights] = {}
_WEIGHTS_MAX = 8


def _window_key(window_np: np.ndarray | None, n: int):
    """The host window's cache key, as the JAX module tells its windows
    apart: None (no window), "hann" for the cached Hann array, else a hash
    of the float64 values."""
    if window_np is None:
        return None
    if window_np is hann_window(n):
        return "hann"
    return hashlib.sha1(
        np.ascontiguousarray(window_np, np.float64).tobytes()).hexdigest()


def _weights(direction: str, n: int, window, kind, device: torch.device):
    """The weights of ``direction`` on ``device``: for ``kind`` a dtype, the
    master cast to it (the plain versions); "bf16" or "f32", the kernels'
    layout with its tensor map (:class:`KernelWeights`, CUDA only).
    ``window`` is None, a host array, or a tensor, which is copied to the
    host on every call (pass the host array where there is one)."""
    if isinstance(window, torch.Tensor):
        window = window.detach().to("cpu", torch.float64).numpy()
    key = (direction, n, _window_key(window, n), kind, device)
    w = _WEIGHTS.get(key)
    if w is not None:
        return w
    master = _master(direction, n, window)
    if isinstance(kind, torch.dtype):
        w = torch.from_numpy(master).to(kind).to(device)
    else:
        w = _kernel_weights(direction, master, n, kind == "bf16", device)
    if len(_WEIGHTS) >= _WEIGHTS_MAX:
        _WEIGHTS.clear()
    _WEIGHTS[key] = w
    return w


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def unit_project(re: torch.Tensor, im: torch.Tensor, mag: torch.Tensor):
    """The Griffin-Lim projection of (re, im): the unit phase with angle 0 ->
    1 and 1/|X| times (gomel_tpu/ops/griffinlim.py:177-181), times ``mag``."""
    a = torch.sqrt(re * re + im * im)
    pos = a > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, a, 1.0), 0.0)
    return mag * torch.where(pos, re * inv, 1.0), mag * (im * inv)


def dft_fwd_plain(x: torch.Tensor, n: int, hop: int, window=None, *,
                  kind: str = "planes", mag: torch.Tensor | None = None,
                  first: int = 0, count: int = 0,
                  bf16_operands: bool = False):
    """Plain PyTorch version of KN on the hop-spaced frames of ``x``
    [..., L], in ``x``'s dtype: (re, im) planes [..., F, n/2+1] (``kind``
    "planes"), magnitudes ("mag"), (imag, real) pairs of bins first..first +
    count - 1 [..., F, count, 2] ("pairs"), or the projection with ``mag``
    ("project", planes). ``bf16_operands`` rounds the frames and the
    float32 weights through bfloat16 first, as the bf16 mode does, and
    accumulates in ``x``'s dtype."""
    return dft_fwd_weights_plain(
        x, _weights("fwd", n, window, x.dtype, x.device), n, hop, kind=kind,
        mag=mag, first=first, count=count, bf16_operands=bf16_operands)


def dft_fwd_weights_plain(x: torch.Tensor, w: torch.Tensor, n: int,
                          hop: int, *, kind: str = "planes",
                          mag: torch.Tensor | None = None, first: int = 0,
                          count: int = 0, bf16_operands: bool = False):
    """:func:`dft_fwd_plain` given its weights ``w`` [n, 2(n/2+1)] in
    ``x``'s dtype on its device (the master with the window folded in)."""
    frames = frame_signal(x, n, hop)
    if bf16_operands:
        frames, w = _bf16_round(frames), _bf16_round(w)
    out = torch.matmul(frames, w)
    half = n // 2 + 1
    re, im = out[..., :half], out[..., half:]
    if kind == "mag":
        return torch.sqrt(re * re + im * im)
    if kind == "pairs":
        return torch.stack([im[..., first:first + count],
                            re[..., first:first + count]], dim=-1)
    if kind == "project":
        return unit_project(re, im, mag)
    return re, im


def dft_inv_plain(re: torch.Tensor, im: torch.Tensor, n: int, window=None,
                  *, real_frames: int | None = None,
                  bf16_operands: bool = False) -> torch.Tensor:
    """Plain PyTorch version of KO: half-spectrum planes [..., F, n/2+1]
    (bf16 planes are widened to float32) -> irfft_n x window [..., F, n];
    frames at or past ``real_frames`` are zeros."""
    dtype = torch.float32 if re.dtype == torch.bfloat16 else re.dtype
    return dft_inv_weights_plain(
        re, im, _weights("inv", n, window, dtype, re.device),
        real_frames=real_frames, bf16_operands=bf16_operands)


def dft_inv_weights_plain(re: torch.Tensor, im: torch.Tensor,
                          w: torch.Tensor, *,
                          real_frames: int | None = None,
                          bf16_operands: bool = False) -> torch.Tensor:
    """:func:`dft_inv_plain` given its weights ``w`` [2(n/2+1), n] in the
    planes' dtype (float32 for bf16 planes) on their device."""
    dtype = torch.float32 if re.dtype == torch.bfloat16 else re.dtype
    z = torch.cat([re, im], dim=-1).to(dtype)
    if bf16_operands:
        z, w = _bf16_round(z), _bf16_round(w)
    frames = torch.matmul(z, w)
    if real_frames is not None:
        frames[..., real_frames:, :] = 0.0
    return frames


def _launch_fwd(x: torch.Tensor, n: int, hop: int, window, bf16: bool,
                kind: str, mag: torch.Tensor | None, first: int, count: int,
                final: bool):
    wt = _weights("fwd", n, window, "bf16" if bf16 else "f32", x.device)
    return launch_fwd(x, wt, n, hop, bf16, kind, mag, first, count, final)


def launch_fwd(x: torch.Tensor, wt: KernelWeights, n: int, hop: int,
               bf16: bool, kind: str, mag: torch.Tensor | None, first: int,
               count: int, final: bool, padded: bool = False):
    """Launch KN on contiguous CUDA tensors with the weights ``wt`` of
    ``bf16``'s mode (see :func:`dft_fwd_plain` for ``kind``); ``final``
    False in the bf16 projection returns bf16 planes, views of rows padded
    to ``LOW_ALIGN`` bins (``padded``: the padded rows themselves)."""
    tensors = (x,) if mag is None else (x, mag)
    dev = _cuda.check_cuda("dft_fwd", *tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("dft_fwd: the CUDA kernel takes float32 tensors")
    lead, length = tuple(x.shape[:-1]), x.shape[-1]
    frames = num_frames_of(length, n, hop)
    batch = int(np.prod(lead, dtype=np.int64))
    half = n // 2 + 1
    shape = lead + (frames, half)
    if mag is not None and tuple(mag.shape) != shape:
        raise ValueError(f"dft_fwd: magnitudes {tuple(mag.shape)} != {shape}")
    low = kind == "project" and bf16 and not final
    f32 = torch.float32
    out1 = None
    ld_low = _round_up(half, LOW_ALIGN)
    if kind == "pairs":
        out0 = torch.empty(lead + (frames, count, 2), dtype=f32, device=dev)
    elif kind == "mag":
        out0 = torch.empty(shape, dtype=f32, device=dev)
    elif low:    # rows padded to 16 bytes, so KO copies them 16 at a time
        out0, out1 = (torch.empty(lead + (frames, ld_low),
                                  dtype=torch.bfloat16, device=dev)
                      for _ in range(2))
    else:
        out0 = torch.empty(shape, dtype=f32, device=dev)
        out1 = torch.empty(shape, dtype=f32, device=dev)
    # the bf16 mode reads a bf16 copy of the signal in 16-byte aligned rows
    # (half the bytes of float32) when every frame starts 16 bytes in
    x_low = torch.empty((batch, _round_up(length, LOW_ALIGN)),
                        dtype=torch.bfloat16, device=dev) if (
        bf16 and hop % LOW_ALIGN == 0) else None
    if batch * frames > 0:
        _cuda.launch("gomel_dft_fwd", dev, int(bf16), x.data_ptr(),
                     None if x_low is None else x_low.data_ptr(),
                     ctypes.addressof(wt.tmap),
                     None if mag is None else mag.data_ptr(),
                     out0.data_ptr(), None if out1 is None else out1.data_ptr(),
                     int(low), ld_low, batch, frames, length, hop, n,
                     wt.depth, wt.cols, _EPILOGUES[kind], first, count)
        (FWD_KERNEL if bf16 else FWD_F32_KERNEL).launches += 1
    if low and not padded:
        return out0[..., :half], out1[..., :half]
    return out0 if out1 is None else (out0, out1)


def _fwd(x: torch.Tensor, n: int, hop: int, window, precision, kind: str,
         mag: torch.Tensor | None = None, first: int = 0, count: int = 0,
         final: bool = True):
    """KN on a CUDA tensor, its plain version on a CPU tensor."""
    _check_n(n)
    bf16 = _low(precision, x.device)
    if x.device.type == "cpu":
        return dft_fwd_plain(x, n, hop, window, kind=kind, mag=mag,
                             first=first, count=count)
    return _launch_fwd(x.contiguous(), n, hop, window, bf16, kind,
                       None if mag is None else mag.contiguous(), first,
                       count, final)


def stft(x: torch.Tensor, n: int, hop: int, window=None, precision=None):
    """(re, im) rfft planes [..., F, n/2+1] of the hop-spaced frames of
    ``x`` [..., L], each multiplied by ``window`` (None: no window)."""
    return _fwd(x, n, hop, window, precision, "planes")


def stft_mag(x: torch.Tensor, n: int, hop: int, window=None,
             precision=None) -> torch.Tensor:
    """|rfft| [..., F, n/2+1] of the windowed hop-spaced frames of ``x``."""
    return _fwd(x, n, hop, window, precision, "mag")


def stft_pairs(x: torch.Tensor, n: int, hop: int, window, first: int,
               count: int, precision=None) -> torch.Tensor:
    """(imag, real) of bins first..first + count - 1 [..., F, count, 2] of
    the windowed hop-spaced frames of ``x`` (the phase encode's layout)."""
    if not (0 <= first and count > 0 and first + count <= n // 2 + 1):
        raise ValueError(f"stft_pairs: bins {first}..{first + count - 1} "
                         f"outside 0..{n // 2}")
    return _fwd(x, n, hop, window, precision, "pairs", first=first,
                count=count)


def gl_spectrum(sig: torch.Tensor, mag_half: torch.Tensor, n: int, hop: int,
                window=None, precision="default", final: bool = False):
    """The forward half of a Griffin-Lim projection: the windowed frames of
    ``sig`` [..., L] -> rfft -> unit phase x ``mag_half`` [..., F, n/2+1],
    as (re, im) planes. On the card in the bf16 mode the planes of an
    interior iteration (``final`` False) are bf16: they only feed the bf16
    inverse, and are views of rows padded to 8 bins, which
    :func:`istft_frames` reads in place."""
    return _fwd(sig, n, hop, window, precision, "project", mag=mag_half,
                final=final)


def istft_frames(re: torch.Tensor, im: torch.Tensor, n: int, window=None,
                 precision=None, real_frames: int | None = None
                 ) -> torch.Tensor:
    """Half-spectrum planes [..., F, n/2+1] -> irfft_n x window [..., F, n]
    (imag(DC), imag(Nyquist) ignored); frames at or past ``real_frames`` are
    zeros. KO on a CUDA tensor (float32 planes, or bf16 planes in the bf16
    mode). The planes' rows may lie any stride apart (the views
    :func:`gl_spectrum` returns); bf16 planes whose rows are not 16-byte
    aligned are copied into padded rows first."""
    _check_n(n)
    if re.shape != im.shape or re.shape[-1] != n // 2 + 1:
        raise ValueError(f"istft_frames: planes {tuple(re.shape)}, "
                         f"{tuple(im.shape)} do not hold n/2 + 1 = "
                         f"{n // 2 + 1} bins")
    bf16 = _low(precision, re.device)
    if re.device.type == "cpu":
        return dft_inv_plain(re, im, n, window, real_frames=real_frames)
    wt = _weights("inv", n, window, "bf16" if bf16 else "f32", re.device)
    return launch_inv(re, im, wt, n, bf16, real_frames)


def launch_inv(re: torch.Tensor, im: torch.Tensor, wt: KernelWeights,
               n: int, bf16: bool,
               real_frames: int | None = None) -> torch.Tensor:
    """Launch KO with the weights ``wt`` of ``bf16``'s mode on CUDA planes
    [..., F, n/2 + 1] (see :func:`istft_frames`)."""
    ld = _row_stride(re)
    if ld is None or _row_stride(im) != ld:
        re, im = re.contiguous(), im.contiguous()
        ld = n // 2 + 1
    dev = re.device
    if dev.type != "cuda" or im.device != dev:
        raise ValueError(f"dft_inv: expected planes on one CUDA device, got "
                         f"{re.device}, {im.device}")
    planes_bf16 = re.dtype == torch.bfloat16
    if re.dtype != im.dtype or re.dtype not in (torch.float32,
                                                torch.bfloat16) or (
            planes_bf16 and not bf16):
        raise ValueError("dft_inv: the CUDA kernel takes float32 planes, or "
                         "bf16 planes at precision 'default'")
    *lead, frames, _ = re.shape
    if real_frames is not None and not 0 <= real_frames <= frames:
        raise ValueError(f"dft_inv: real_frames {real_frames} outside "
                         f"0..{frames}")
    rows = int(np.prod(lead, dtype=np.int64)) * frames
    out = torch.empty(tuple(lead) + (frames, n), dtype=torch.float32,
                      device=dev)
    if rows > 0:
        if planes_bf16 and (ld % LOW_ALIGN or any(
                t.data_ptr() % 16 for t in (re, im))):
            re, im, ld = (*(_padded_rows(t, rows) for t in (re, im)),
                          _round_up(n // 2 + 1, LOW_ALIGN))
        _cuda.launch("gomel_dft_inv", dev, int(bf16), int(planes_bf16),
                     re.data_ptr(), im.data_ptr(), ld,
                     ctypes.addressof(wt.tmap), out.data_ptr(), rows, frames,
                     frames if real_frames is None else real_frames, n,
                     wt.depth, wt.cols)
        (INV_KERNEL if bf16 else INV_F32_KERNEL).launches += 1
    return out


def _row_stride(t: torch.Tensor) -> int | None:
    """The distance in elements between the rows of ``t`` [..., rows, bins]
    when its bins are contiguous and its rows lie one stride apart (a
    contiguous tensor, or a view of the first bins of padded rows); None
    otherwise."""
    if t.dim() < 2 or t.stride(-1) != 1:
        return None
    if t.is_contiguous():
        return t.shape[-1]
    ld, span = t.stride(-2), t.stride(-2) * t.shape[-2]
    if t.shape[-2] < 2 or ld < t.shape[-1]:
        return None
    for size, stride in zip(reversed(t.shape[:-2]), reversed(t.stride()[:-2])):
        if size != 1 and stride != span:
            return None
        span *= size
    return ld


def _padded_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """bf16 planes as rows padded to ``LOW_ALIGN`` bins (16 bytes)."""
    half = t.shape[-1]
    out = torch.zeros((rows, _round_up(half, LOW_ALIGN)), dtype=t.dtype,
                      device=t.device)
    out[:, :half] = t.reshape(rows, half)
    return out


# -- the JAX module's names (gomel_tpu/ops/dft_mm.py:105-145) ----------------

def _framed(x: torch.Tensor):
    """[..., n] frames as one signal read at hop n."""
    return x.reshape(-1), tuple(x.shape[:-1])


def rfft(x: torch.Tensor, n: int, precision=None):
    """Real [..., n] -> (re, im) half-spectrum planes [..., n//2+1]."""
    flat, lead = _framed(x)
    re, im = stft(flat, n, n, None, precision)
    return re.reshape(lead + (n // 2 + 1,)), im.reshape(lead + (n // 2 + 1,))


def rfft_windowed(x: torch.Tensor, n: int, window_np, precision=None):
    """rfft of ``x * window`` with the window folded into the weights."""
    flat, lead = _framed(x)
    re, im = stft(flat, n, n, window_np, precision)
    return re.reshape(lead + (n // 2 + 1,)), im.reshape(lead + (n // 2 + 1,))


def irfft_windowed(re_h: torch.Tensor, im_h: torch.Tensor, n: int,
                   window_np, precision=None) -> torch.Tensor:
    """``irfft(re, im) * window`` with the window folded into the weights."""
    return istft_frames(re_h, im_h, n, window_np, precision)


def rfft_mag(x: torch.Tensor, n: int, precision=None) -> torch.Tensor:
    flat, lead = _framed(x)
    return stft_mag(flat, n, n, None, precision).reshape(lead + (n // 2 + 1,))


def irfft(re_h: torch.Tensor, im_h: torch.Tensor, n: int,
          precision=None) -> torch.Tensor:
    """(re, im) half-spectrum [..., n//2+1] -> real signal [..., n]."""
    return istft_frames(re_h, im_h, n, None, precision)
