"""PCM-16 ingest with the zero-stuff upsample (kernel KA, csrc/ingest.cu),
the mel PNG quantizer (kernel KD) and the phase plane quantizer (kernel KF,
both csrc/quantize.cu), the long-form de-quantizer ``dequantize_raw``
(kernel KL, csrc/dequantize.cu), and the plain de-quantizers and PCM-16
conversion of the single-file decodes.

Counterparts of ``gomel_tpu/ops/quantize.py`` ``pcm16_ingest``,
``quantize_mel_plane(_batch)``, ``quantize_planes(_batch)`` (the batch forms
with the per-row ``frames`` mask of length-bucketed batches too),
``dequantize_planes(_batch)``, ``dequantize_mel_plane(_batch)`` and
``pcm16_encode``, ``dequantize_raw``, and of the batch CLIs' ingest with a
divisor per row
(gomel_tpu/parallel/batch.py:289). On the file paths only int16 samples go
to the device and only integer planes plus extrema come back (encode), and
only integer planes go up and int16 samples come back (decode).

``dequantize_planes``, ``dequantize_mel_plane`` and ``pcm16_encode`` are
plain PyTorch on any device: on the card's decode paths their work is the
prologue of kernel KG (ops/istft.py) or KI (ops/mel_ops.py) and the
epilogue of kernel KH or KK (ops/griffinlim.py), and these functions are
those kernels' plain versions.

KD and KF are one two-pass design (csrc/quantize.cu): KD takes one global
max and min a row over both channels, KF one a channel.

Byte parity: the host writer quantizes in float64, these in float32; the
truncation can flip one step where the two roundings straddle an integer
(rare; gomel_tpu/ops/quantize.py:10-14). KA and KD, and KF without IHS,
equal their plain versions, and the JAX programs, bit for bit on the same
float32 input.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.config import PAD_SHIFT_TABLE
from ..core.framing import zero_stuff_output_length
from ..utils.profiling import annotate, transfer
from . import _cuda
from .resample import zero_stuff_upsample

INGEST_KERNEL = _cuda.Kernel("pcm16_ingest", "gomel_tpu_torch/csrc/ingest.cu",
                             "gomel_tpu/ops/quantize.py:105")
# KA's zero-stuff form: a tally of its own beside INGEST_KERNEL's (or
# INGEST_ROWS_KERNEL's), which counts the same launch
INGEST_ZERO_STUFF_KERNEL = _cuda.Kernel("pcm16_ingest zero-stuff",
                                        "gomel_tpu_torch/csrc/ingest.cu",
                                        "gomel_tpu/ops/resample.py:17")
INGEST_ROWS_KERNEL = _cuda.Kernel("pcm16_ingest_rows",
                                  "gomel_tpu_torch/csrc/ingest.cu",
                                  "gomel_tpu/parallel/batch.py:289")
QUANTIZE_KERNEL = _cuda.Kernel("quantize_mel_plane",
                               "gomel_tpu_torch/csrc/quantize.cu",
                               "gomel_tpu/ops/quantize.py:63")
QUANTIZE_MASKED_KERNEL = _cuda.Kernel("quantize_mel_plane_masked",
                                      "gomel_tpu_torch/csrc/quantize.cu",
                                      "gomel_tpu/ops/quantize.py:176")
PLANES_KERNEL = _cuda.Kernel("quantize_planes",
                             "gomel_tpu_torch/csrc/quantize.cu",
                             "gomel_tpu/ops/quantize.py:30")
PLANES_MASKED_KERNEL = _cuda.Kernel("quantize_planes_masked",
                                    "gomel_tpu_torch/csrc/quantize.cu",
                                    "gomel_tpu/ops/quantize.py:164")
DEQUANTIZE_RAW_KERNEL = _cuda.Kernel("dequantize_raw",
                                     "gomel_tpu_torch/csrc/dequantize.cu",
                                     "gomel_tpu/ops/quantize.py:88")

# the (zp, zs) pairs KA is built for (a kernel each: csrc/ingest.cu), the
# pad-shift table's, (0, 0) among them
ZERO_STUFF_PAIRS = frozenset(PAD_SHIFT_TABLE.values())

# (device index, stream) -> uint32 tickets of KD's and KF's per-row fold,
# zero between calls: each call's last block of a row wraps its ticket back
# to 0, and calls on one stream run in order, so KD and KF share them
_PLANES_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _planes_tickets(dev: torch.device, rows: int) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    tickets = _PLANES_TICKETS.get(key)
    if tickets is None or tickets.numel() < rows:
        tickets = torch.zeros(max(rows, 64), dtype=torch.int32, device=dev)
        _PLANES_TICKETS[key] = tickets
    return tickets


def pcm16_ingest_plain(pcm: torch.Tensor, dtype: torch.dtype, scale,
                       pad_to: int = 0, batched: bool = False, zp: int = 0,
                       zs: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the ingest kernel (see :func:`pcm16_ingest`;
    ``batched``: [B, L] mono rows instead of one [L, 2] stereo signal, and
    ``scale`` may then be a [B] tensor of per-row divisors)."""
    x = pcm.to(dtype)
    if x.ndim == 2 and not batched:
        x = x.mean(dim=1)
    if isinstance(scale, torch.Tensor):
        x = x / scale.to(device=x.device, dtype=dtype)[:, None]
    else:
        x = x / float(scale)
    if zp > 0:
        x = (torch.stack([zero_stuff_upsample(r, zp, zs) for r in x])
             if batched else zero_stuff_upsample(x, zp, zs))
    if pad_to > x.shape[-1]:
        x = torch.nn.functional.pad(x, (0, pad_to - x.shape[-1]))
    return x


def _ingest_layout(pcm: torch.Tensor, batched: bool) -> tuple[int, int, int]:
    """(rows, samples, channels) of an int16 [L], [L, 2] or batched [B, L]."""
    if batched:
        if pcm.ndim != 2:
            raise ValueError(f"pcm16_ingest_batch takes [B, L] (got {tuple(pcm.shape)})")
        return pcm.shape[0], pcm.shape[1], 1
    if pcm.ndim == 1:
        return 1, pcm.shape[0], 1
    if pcm.ndim == 2 and pcm.shape[1] == 2:
        return 1, pcm.shape[0], 2
    raise ValueError(f"pcm16_ingest takes [L] or [L, 2] (got {tuple(pcm.shape)})")


def _ingest(pcm: torch.Tensor, dtype: torch.dtype, scale, pad_to: int,
            batched: bool, zp: int, zs: int) -> torch.Tensor:
    rows, n_in, channels = _ingest_layout(pcm, batched)
    if zp < 0 or zs < 0 or (zp == 0 and zs != 0):
        raise ValueError(f"pcm16_ingest: bad zero-stuff (zp={zp}, zs={zs})")
    per_row = (scale.ndim > 0 if isinstance(scale, torch.Tensor)
               else np.ndim(scale) > 0)
    if per_row:
        with transfer(scale, pcm.device):
            scale = torch.as_tensor(scale, dtype=torch.float32,
                                    device=pcm.device)
        if not batched or tuple(scale.shape) != (rows,):
            raise ValueError(f"pcm16_ingest: per-row scales {tuple(scale.shape)}"
                             f" need a [B, L] batch of {rows} rows")
    if pcm.device.type == "cpu":
        return pcm16_ingest_plain(pcm, dtype, scale, pad_to, batched, zp, zs)
    kernel = INGEST_ROWS_KERNEL if per_row else INGEST_KERNEL
    with annotate(kernel.span):
        tensors = (pcm, scale.contiguous()) if per_row else (pcm,)
        dev = _cuda.check_cuda("pcm16_ingest", *tensors)
        if pcm.dtype != torch.int16 or dtype != torch.float32:
            raise ValueError("pcm16_ingest: the CUDA kernel maps int16 to "
                             "float32")
        if (zp, zs) not in ZERO_STUFF_PAIRS:
            raise ValueError(f"pcm16_ingest: the CUDA kernel takes the (zp, "
                             f"zs) pairs of PAD_SHIFT_TABLE, not ({zp}, {zs})")
        n_out = max(zero_stuff_output_length(n_in, zp, zs), pad_to)
        out = torch.empty((rows, n_out) if batched else (n_out,),
                          dtype=torch.float32, device=dev)
        if out.numel() == 0:
            return out
        _cuda.launch("gomel_pcm16_ingest", dev, pcm.data_ptr(),
                     out.data_ptr(), rows, n_in, n_out, channels,
                     0.0 if per_row else float(scale),
                     tensors[1].data_ptr() if per_row else None, zp, zs)
        kernel.launches += 1
        if zp > 0:
            INGEST_ZERO_STUFF_KERNEL.launches += 1
    return out


def pcm16_ingest(pcm: torch.Tensor, dtype: torch.dtype, scale: float,
                 pad_to: int = 0, zp: int = 0, zs: int = 0) -> torch.Tensor:
    """int16 [L] or [L, 2] -> float [max(L', pad_to)]: convert, stereo mean
    (exact: the float32 sum of two int16 is exact), divide by ``scale`` (a
    power of two, so exact), zero-stuff upsample (``zp`` kept, ``zs`` zeros,
    kept samples times 1 + zs; L' = L + ceil(L/zp)*zs, L' = L for zp = 0),
    zero-pad to ``pad_to``. Bit-identical to the host float path."""
    return _ingest(pcm, dtype, scale, pad_to, False, zp, zs)


def pcm16_ingest_batch(pcm: torch.Tensor, dtype: torch.dtype, scale,
                       pad_to: int = 0, zp: int = 0, zs: int = 0
                       ) -> torch.Tensor:
    """Batched mono :func:`pcm16_ingest`: int16 [B, L] -> float
    [B, max(L', pad_to)]. ``scale`` is one divisor, or one per row (a [B]
    tensor or array: the batch CLIs mix WAV rows, 32768, with mel-scaled
    FLAC rows, 65536, in one bucket); powers of two keep it exact."""
    return _ingest(pcm, dtype, scale, pad_to, True, zp, zs)


def _masked_extrema(spec2: torch.Tensor, frames, dims):
    """Per-row extrema of [B, F, X, 2] over each row's first ``frames[b]``
    frames, as gomel_tpu/ops/quantize.py:151 takes them: the pad frames hold
    the -+finfo.max sentinels, so a row with frames = 0 gets (-max, +max)."""
    frames = torch.as_tensor(frames, device=spec2.device).reshape(-1, 1)
    mask = (torch.arange(spec2.shape[-3], device=spec2.device)
            < frames)[:, :, None, None]
    big = torch.finfo(spec2.dtype).max
    return (torch.where(mask, spec2, -big).amax(dim=dims),
            torch.where(mask, spec2, big).amin(dim=dims))


def quantize_mel_plane_plain(spec2: torch.Tensor, max_val: int = 255,
                             frames=None):
    """Plain PyTorch version of the quantizer kernel: [..., F, M, 2] ->
    (img2 [..., M, F, 2] uint8, max [...], min [...]); with ``frames`` [B]
    (a [B, F, M, 2] batch) the masked form. The extrema propagate NaN, as
    JAX's do."""
    dims = (-3, -2, -1)
    if frames is None:
        mgc_max = spec2.amax(dim=dims)
        mgc_min = spec2.amin(dim=dims)
    else:
        mgc_max, mgc_min = _masked_extrema(spec2, frames, dims)
    mx = mgc_max[..., None, None, None]
    mn = mgc_min[..., None, None, None]
    rng = mx - mn
    norm = torch.where(rng > 0,
                       (spec2 - mn) / torch.where(rng > 0, rng, 1.0), 0.5)
    q = torch.clip(torch.trunc(max_val * norm), 0, max_val)
    return q.transpose(-3, -2).to(torch.uint8), mgc_max, mgc_min


def _true_frames(frames, batch: int, device: torch.device):
    """``frames`` as an int32 [batch] tensor on ``device`` (None stays)."""
    if frames is None:
        return None
    with transfer(frames, device):
        frames = torch.as_tensor(frames, dtype=torch.int32, device=device)
    if tuple(frames.shape) != (batch,):
        raise ValueError(f"frames has shape {tuple(frames.shape)} for a "
                         f"{batch}-row batch")
    return frames.contiguous()


def _quantize(spec2: torch.Tensor, max_val: int, batched: bool, frames=None):
    if spec2.ndim != (4 if batched else 3) or spec2.shape[-1] != 2:
        raise ValueError(f"expected {'[B, F, M, 2]' if batched else '[F, M, 2]'} "
                         f"(got {tuple(spec2.shape)})")
    true_frames = _true_frames(frames, spec2.shape[0], spec2.device)
    if spec2.device.type == "cpu":
        return quantize_mel_plane_plain(spec2, max_val, true_frames)
    with annotate((QUANTIZE_KERNEL if true_frames is None
                   else QUANTIZE_MASKED_KERNEL).span):
        return launch_quantize_mel(spec2, max_val, batched, true_frames)


def launch_quantize_mel(spec2: torch.Tensor, max_val: int, batched: bool,
                        true_frames: torch.Tensor | None = None):
    """Launch KD on a CUDA spectrogram [B, F, M, 2] (``batched``) or
    [F, M, 2], with the int32 frame counts [B] of the masked form; pass 1's
    partials and the per-row tickets are the kernel's own scratch."""
    dev = _cuda.check_cuda("quantize_mel_plane", spec2,
                           *(() if true_frames is None else (true_frames,)))
    if spec2.dtype != torch.float32:
        raise ValueError("quantize_mel_plane: the CUDA kernel takes float32")
    if not 0 < max_val <= 255:
        raise ValueError(f"quantize_mel_plane: max_val {max_val} exceeds uint8")
    batch = spec2.shape[0] if batched else 1
    n_frames, mels = spec2.shape[-3], spec2.shape[-2]
    if spec2.numel() == 0:
        raise ValueError("quantize_mel_plane: empty spectrogram has no extrema")
    lead = (batch,) if batched else ()
    img2 = torch.empty(lead + (mels, n_frames, 2), dtype=torch.uint8,
                       device=dev)
    mx = torch.empty(lead, dtype=torch.float32, device=dev)
    mn = torch.empty(lead, dtype=torch.float32, device=dev)
    # KF's two passes with global extrema: pass 1's blocks a row are the
    # card's resident blocks shared by the rows
    parts = ctypes.c_longlong()
    _cuda.launch("gomel_quantize_mel_parts", dev, batch, n_frames, mels,
                 ctypes.addressof(parts))
    partial = torch.empty((batch, parts.value, 4), dtype=torch.float32,
                          device=dev)
    _cuda.launch("gomel_quantize_mel", dev, spec2.data_ptr(),
                 None if true_frames is None else true_frames.data_ptr(),
                 partial.data_ptr(), _planes_tickets(dev, batch).data_ptr(),
                 img2.data_ptr(), mx.data_ptr(), mn.data_ptr(), batch,
                 n_frames, mels, parts.value, float(max_val))
    (QUANTIZE_KERNEL if true_frames is None
     else QUANTIZE_MASKED_KERNEL).launches += 1
    return img2, mx, mn


def quantize_mel_plane(spec2: torch.Tensor, max_val: int = 255):
    """Mel quantizer: GLOBAL (not per-channel) min/max (mel/impl.go:138-152).

    [F, M, 2] -> (img2 [M, F, 2] uint8, mgc_max scalar, mgc_min scalar).
    Degenerate range pins norm at 0.5 like the host writer; a NaN makes the
    extrema NaN and every pixel 127, as in the JAX program."""
    return _quantize(spec2, max_val, batched=False)


def quantize_mel_plane_batch(spec2b: torch.Tensor, max_val: int = 255,
                             frames=None):
    """Batched :func:`quantize_mel_plane`: [B, F, M, 2] -> (img2 [B, M, F, 2]
    uint8, mgc_max [B], mgc_min [B]), each row with its own global extrema
    (one file per row). ``frames`` [B]: each row's true frame count in a
    length-bucketed batch; the extrema then exclude the pad frames, which
    are quantized all the same (gomel_tpu/ops/quantize.py:176)."""
    return _quantize(spec2b, max_val, batched=True, frames=frames)


def quantize_planes_plain(spec2: torch.Tensor, max_val: int,
                          ihs_passes: int = 0, frames=None):
    """Plain PyTorch version of the phase quantizer kernel: [..., F, nf, 2] ->
    (img2 [..., nf, F, 2] uint8|uint16, maxs [..., 2], mins [..., 2]); with
    ``frames`` [B] (a [B, F, nf, 2] batch) the masked form."""
    for _ in range(ihs_passes):
        spec2 = torch.asinh(spec2)
    if frames is None:
        maxs = spec2.amax(dim=(-3, -2))
        mins = spec2.amin(dim=(-3, -2))
    else:
        maxs, mins = _masked_extrema(spec2, frames, (-3, -2))
    mx = maxs[..., None, None, :]
    mn = mins[..., None, None, :]
    rng = mx - mn
    norm = torch.where(rng > 0,
                       (spec2 - mn) / torch.where(rng > 0, rng, 1.0), 0.5)
    q = torch.clip(torch.trunc(max_val * norm), 0, max_val)
    dtype = torch.uint16 if max_val > 255 else torch.uint8
    return q.transpose(-3, -2).to(dtype), maxs, mins


def _quantize_planes(spec2: torch.Tensor, max_val: int, ihs_passes: int,
                     batched: bool, frames=None):
    if spec2.ndim != (4 if batched else 3) or spec2.shape[-1] != 2:
        raise ValueError(f"expected {'[B, F, nf, 2]' if batched else '[F, nf, 2]'} "
                         f"(got {tuple(spec2.shape)})")
    true_frames = _true_frames(frames, spec2.shape[0], spec2.device)
    if spec2.device.type == "cpu":
        return quantize_planes_plain(spec2, max_val, ihs_passes, true_frames)
    with annotate((PLANES_KERNEL if true_frames is None
                   else PLANES_MASKED_KERNEL).span):
        return launch_quantize_planes(spec2, max_val, ihs_passes, batched,
                                      true_frames)


def launch_quantize_planes(spec2: torch.Tensor, max_val: int,
                           ihs_passes: int, batched: bool,
                           true_frames: torch.Tensor | None = None):
    """Launch KF on a CUDA spectrogram [B, F, nf, 2] (``batched``) or
    [F, nf, 2], with the int32 frame counts [B] of the masked form; pass 1's
    partials and the per-row tickets are the kernel's own scratch."""
    dev = _cuda.check_cuda("quantize_planes", spec2,
                           *(() if true_frames is None else (true_frames,)))
    if spec2.dtype != torch.float32:
        raise ValueError("quantize_planes: the CUDA kernel takes float32")
    if not 0 < max_val <= 65535:
        raise ValueError(f"quantize_planes: max_val {max_val} exceeds uint16")
    if spec2.numel() == 0:
        raise ValueError("quantize_planes: empty spectrogram has no extrema")
    batch = spec2.shape[0] if batched else 1
    n_frames, bins = spec2.shape[-3], spec2.shape[-2]
    lead = (batch,) if batched else ()
    dtype = torch.uint16 if max_val > 255 else torch.uint8
    img2 = torch.empty(lead + (bins, n_frames, 2), dtype=dtype, device=dev)
    maxs = torch.empty(lead + (2,), dtype=torch.float32, device=dev)
    mins = torch.empty(lead + (2,), dtype=torch.float32, device=dev)
    # pass 1's blocks a row: the card's resident blocks shared by the rows
    parts = ctypes.c_longlong()
    _cuda.launch("gomel_quantize_planes_parts", dev, batch, n_frames, bins,
                 ctypes.addressof(parts))
    partial = torch.empty((batch, parts.value, 4), dtype=torch.float32,
                          device=dev)
    _cuda.launch("gomel_quantize_planes", dev, spec2.data_ptr(),
                 None if true_frames is None else true_frames.data_ptr(),
                 partial.data_ptr(), _planes_tickets(dev, batch).data_ptr(),
                 img2.data_ptr(), maxs.data_ptr(), mins.data_ptr(), batch,
                 n_frames, bins, parts.value, float(max_val),
                 int(ihs_passes))
    (PLANES_KERNEL if true_frames is None
     else PLANES_MASKED_KERNEL).launches += 1
    return img2, maxs, mins


def quantize_planes(spec2: torch.Tensor, max_val: int, ihs_passes: int = 0):
    """Quantize a phase spectrogram [F, nf, 2] to image planes.

    Returns (img2 [nf, F, 2] uint8|uint16 in image (row = bin) layout,
    maxs [2], mins [2]): the PER-CHANNEL extrema after ``ihs_passes`` asinh
    passes, exactly what the PNG metadata stores (phase/impl.go:198-222).
    Degenerate range pins norm at 0.5 like the host writer; a NaN makes its
    channel's extrema NaN and that channel's pixels the midpoint."""
    return _quantize_planes(spec2, max_val, ihs_passes, batched=False)


def quantize_planes_batch(spec2b: torch.Tensor, max_val: int,
                          ihs_passes: int = 0, frames=None):
    """Batched :func:`quantize_planes`: [B, F, nf, 2] -> (img2 [B, nf, F, 2],
    maxs [B, 2], mins [B, 2]), each row with its own per-channel extrema (one
    file per row). ``frames`` [B]: per-row true frame counts; the extrema
    (after the asinh passes) exclude the pad frames
    (gomel_tpu/ops/quantize.py:164)."""
    return _quantize_planes(spec2b, max_val, ihs_passes, batched=True,
                            frames=frames)


def dequantize_planes(img2: torch.Tensor, maxs, mins, max_val: int,
                      ihs_passes: int = 0) -> torch.Tensor:
    """Inverse of :func:`quantize_planes`: integer planes [..., nf, F, 2] +
    per-channel extrema [..., 2] -> spectrogram [..., F, nf, 2] float32
    (rescale per channel, then sinh IHS undo; phase/impl.go:109-147).

    Plain PyTorch on any device; the card's decode path runs this as the
    prologue of kernel KG. The divisor is a tensor, so the division is a
    true division on every device, as in the kernel."""
    dev = img2.device
    f32 = torch.float32
    maxs = torch.as_tensor(maxs, dtype=f32, device=dev)
    mins = torch.as_tensor(mins, dtype=f32, device=dev)
    # a device scalar made by a fill, not a host copy, so a call can be
    # queued behind running work
    spec = img2.to(f32).transpose(-3, -2) / torch.full(
        (), float(max_val), dtype=f32, device=dev)
    spec = spec * (maxs - mins)[..., None, None, :] + mins[..., None, None, :]
    for _ in range(ihs_passes):
        spec = torch.sinh(spec)
    return spec


def dequantize_planes_batch(img2b: torch.Tensor, maxs, mins, max_val: int,
                            ihs_passes: int = 0) -> torch.Tensor:
    """Batched :func:`dequantize_planes`: [B, nf, F, 2] + [B, 2] extrema ->
    [B, F, nf, 2] float32."""
    if img2b.ndim != 4:
        raise ValueError(f"expected [B, nf, F, 2] (got {tuple(img2b.shape)})")
    return dequantize_planes(img2b, maxs, mins, max_val, ihs_passes)


def dequantize_raw_plain(img: torch.Tensor, maxs, mins, max_val: int,
                         ihs_passes: int = 0, boost: float = 0.0,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of KL (see :func:`dequantize_raw`). Every
    scalar is a tensor made by a fill, so each division is a true division
    on every device, as in the kernel."""
    dev = img.device

    def scalar(v):
        return torch.full((), float(v), dtype=dtype, device=dev)

    maxs = torch.as_tensor(maxs, device=dev).to(torch.float32)
    mins = torch.as_tensor(mins, device=dev).to(torch.float32)
    s = img.to(dtype) / scalar(max_val)
    s = s * (maxs - mins).to(dtype) + mins.to(dtype)
    for _ in range(ihs_passes):
        s = torch.sinh(s)
    if boost != 0.0:
        s = s + scalar(boost)
    return s


def dequantize_raw(img: torch.Tensor, maxs, mins, max_val: int,
                   ihs_passes: int = 0, boost: float = 0.0,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Layout-agnostic de-quantization (gomel_tpu/ops/quantize.py:88): an
    integer array (uint8 or uint16) -> ``dtype``, rescaled by the extrema
    broadcast against its trailing axis (per-channel [C] for phase planes,
    scalars for mel), ``ihs_passes`` x sinh, then + ``boost`` when it is
    non-zero (the additive log-domain VolumeBoost). Kernel KL on a CUDA
    tensor (float32 only)."""
    if img.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"dequantize_raw: img must be uint8 or uint16 (got "
                         f"{img.dtype})")
    if img.device.type == "cpu":
        return dequantize_raw_plain(img, maxs, mins, max_val, ihs_passes,
                                    boost, dtype)
    with annotate(DEQUANTIZE_RAW_KERNEL.span):
        f32 = torch.float32
        with transfer(maxs, img.device):
            mx = torch.as_tensor(maxs, dtype=f32, device=img.device)
        with transfer(mins, img.device):
            mn = torch.as_tensor(mins, dtype=f32, device=img.device)
        mx, mn = mx.contiguous(), mn.contiguous()
        if mx.shape != mn.shape or mx.ndim > 1 or (
                mx.ndim == 1 and (img.ndim == 0
                                  or mx.shape[0] != img.shape[-1])):
            raise ValueError(f"dequantize_raw: extrema {tuple(mx.shape)}, "
                             f"{tuple(mn.shape)} do not broadcast over the "
                             f"trailing axis of {tuple(img.shape)}")
        img = img.contiguous()
        dev = _cuda.check_cuda("dequantize_raw", img, mx, mn)
        if dtype != f32:
            raise ValueError("dequantize_raw: the CUDA kernel writes float32")
        out = torch.empty(img.shape, dtype=f32, device=dev)
        if img.numel() > 0:
            _cuda.launch("gomel_dequantize_raw", dev, img.data_ptr(),
                         mx.data_ptr(), mn.data_ptr(), out.data_ptr(),
                         img.numel(), img.element_size(), max(1, mx.numel()),
                         float(max_val), int(ihs_passes), float(boost))
            DEQUANTIZE_RAW_KERNEL.launches += 1
    return out


def dequantize_mel_plane(img2: torch.Tensor, mgc_max, mgc_min,
                         max_val: int = 255) -> torch.Tensor:
    """Inverse of :func:`quantize_mel_plane`: integer planes [..., M, F, 2]
    + GLOBAL extrema [...] -> log-mel [..., F, M, 2] float32
    (mel/impl.go:109-116), as (v / max_val) * (max - min) + min.

    Plain PyTorch on any device; the card's mel decode runs this as the
    prologue of kernel KI (ops/mel_ops.mel_to_magnitudes). The divisor is a
    tensor, so the division is a true division on every device."""
    dev = img2.device
    f32 = torch.float32
    mx = torch.as_tensor(mgc_max, dtype=f32, device=dev)[..., None, None, None]
    mn = torch.as_tensor(mgc_min, dtype=f32, device=dev)[..., None, None, None]
    spec = img2.to(f32).transpose(-3, -2) / torch.full(
        (), float(max_val), dtype=f32, device=dev)
    return spec * (mx - mn) + mn


def dequantize_mel_plane_batch(img2b: torch.Tensor, mgc_max, mgc_min,
                               max_val: int = 255) -> torch.Tensor:
    """Batched :func:`dequantize_mel_plane`: [B, M, F, 2] + [B] extrema ->
    [B, F, M, 2] float32."""
    if img2b.ndim != 4:
        raise ValueError(f"expected [B, M, F, 2] (got {tuple(img2b.shape)})")
    return dequantize_mel_plane(img2b, mgc_max, mgc_min, max_val)


def pcm16_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Float audio -> (int16 PCM, all-finite flag): io.audio.save_wav's
    conversion (clip to [-1, 1], round half to even of x*32768, saturate).
    *32768 is exact, so it equals the host conversion of the same wave bit
    for bit; NaN converts to 0, as in the JAX program. Plain PyTorch on any
    device; the card's decode path runs it as the epilogue of kernel KH."""
    finite = torch.isfinite(x).all()
    x = torch.clip(x.nan_to_num(nan=0.0), -1.0, 1.0)
    pcm = torch.clip(torch.round(x * 32768.0), -32768.0, 32767.0)
    return pcm.to(torch.int16), finite
