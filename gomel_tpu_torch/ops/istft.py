"""Overlap-add iSTFT: kernels KG (inverse rFFT x window, with an optional
real-frame count) and KH (overlap-add + window-sum normalisation + boost +
PCM-16), both csrc/phase_decode.cu, and KM (csrc/shard_epilogue.cu), the
epilogue of a frame shard's synthesis (halo add, then the global window-sum
normalisation, the Griffin-Lim momentum step or PCM-16).

Counterpart of ``gomel_tpu/ops/istft.py`` (reference phase/phase.go:93-133):
``overlap_add``, ``window_sum``, ``normalize_by_window_sum``,
``istft_direct_planes``, ``istft_direct`` and ``chunked_irfft_overlap_add``,
and of the halo add and normalisation of gomel_tpu/parallel/sharded.py
(``shard_epilogue``).
On a CPU tensor each runs its plain PyTorch version (the JAX program's order
of operations, so float32 results match it bit for bit where the JAX
program is exact); on a CUDA tensor ``irfft_window`` launches KG (or, by
ops/fftbackend.resolve, takes the xla route or the matmul DFT KO),
``overlap_add`` / ``overlap_normalize`` launch KH and ``shard_epilogue``
launches KM.

KH takes the window sum from a [K, hop] prefix table (K = ceil(N/hop)) built
on the host exactly as :func:`window_sum` builds it: the prefix is summed row
after row in float32 (``torch.cumsum`` on the CPU accumulates float32 in
float64, which the JAX program does not), so the kernel's window sum, and
the 0.5 * max threshold taken from the same table, equal the JAX program's
bit for bit. ``window_sum`` and ``normalize_by_window_sum`` are plain
PyTorch on any device.

KH and KM walk hop-rows (csrc/overlap_add.cuh): a thread owns 4 adjacent
samples of a hop-row on the vector path, which the kernels' entry points
take when the shapes are multiples of 4 and the pointers 16-byte aligned,
and one sample on the scalar path otherwise; both give the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import annotate
from . import _cuda, dft_mm, fftbackend
from .quantize import pcm16_encode
from .rfft_mag import fft_plan_args, fft_tables, supported

SYNTH_KERNEL = _cuda.Kernel("irfft_window",
                            "gomel_tpu_torch/csrc/phase_decode.cu",
                            "gomel_tpu/ops/istft.py:137")
OLA_KERNEL = _cuda.Kernel("overlap_normalize",
                          "gomel_tpu_torch/csrc/phase_decode.cu",
                          "gomel_tpu/ops/istft.py:22")
# KG launched with a real-frame count (the masked synthesis of K10)
SYNTH_MASKED_KERNEL = _cuda.Kernel("irfft_window_masked",
                                   "gomel_tpu_torch/csrc/phase_decode.cu",
                                   "gomel_tpu/ops/istft.py:75")
SHARD_KERNEL = _cuda.Kernel("shard_epilogue",
                            "gomel_tpu_torch/csrc/shard_epilogue.cu",
                            "gomel_tpu/parallel/sharded.py:229")

# KG's sources (csrc/phase_decode.cu), and the alignment in bytes each needs
# (the kernel reads float, float2, uchar2 and ushort2 elements)
MODE_PLANES, MODE_SPEC, MODE_QUANT8, MODE_QUANT16 = 0, 1, 2, 3
_ALIGN = {MODE_PLANES: 4, MODE_SPEC: 8, MODE_QUANT8: 2, MODE_QUANT16: 4}


def overlap_add_plain(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Plain PyTorch overlap-add: [..., F, N] -> [..., N + (F-1)*hop], as K
    shifted adds of hop-rows in the JAX program's order (istft.py:22-38)."""
    *lead, F, N = frames.shape
    K = -(-N // hop)
    fp = torch.nn.functional.pad(frames, (0, K * hop - N)).reshape(
        *lead, F, K, hop)
    rows_out = F + K - 1
    acc = frames.new_zeros((*lead, rows_out, hop))
    for k in range(K):
        acc = acc + torch.nn.functional.pad(fp[..., k, :],
                                            (0, 0, k, rows_out - F - k))
    return acc.reshape(*lead, -1)[..., : N + (F - 1) * hop]


def _prefix_rows(window: torch.Tensor, hop: int) -> torch.Tensor:
    """S[k] = sum_{j <= k} of the hop-rows of window**2, [K, hop], summed
    row after row in the window's dtype."""
    w2 = window * window
    N = w2.shape[0]
    K = -(-N // hop)
    rows = torch.nn.functional.pad(w2, (0, K * hop - N)).reshape(K, hop)
    prefix = [rows[0]]
    for k in range(1, K):
        prefix.append(prefix[-1] + rows[k])
    return torch.stack(prefix)


def _window_sum_rows(prefix: torch.Tensor, n_frames: int
                     ) -> tuple[torch.Tensor, bool]:
    """The distinct hop-rows of the window sum (istft.py:58-71) and whether
    the signal is short. Short: all F + K - 1 rows. Otherwise the K - 1 head
    rows, the one periodic middle row, and the K - 1 tail rows."""
    K = prefix.shape[0]
    rows_out = n_frames + K - 1
    if rows_out <= 2 * (K - 1):
        idx = torch.arange(rows_out, device=prefix.device)
        top = prefix[torch.clamp(idx, max=K - 1)]
        sub_idx = idx - n_frames
        sub = torch.where((sub_idx >= 0)[:, None],
                          prefix[torch.clamp(sub_idx, 0, K - 1)], 0.0)
        return top - sub, True
    full = prefix[-1]
    return torch.cat([prefix[: K - 1], full[None], full - prefix[: K - 1]]), False


def window_sum(window: torch.Tensor, n_frames: int, hop: int) -> torch.Tensor:
    """Overlap-added sum of squared windows [N + (F-1)*hop] (reference:
    phase/phase.go:109), built from the K = ceil(N/hop) prefix rows."""
    N = window.shape[0]
    prefix = _prefix_rows(window, hop)
    rows, short = _window_sum_rows(prefix, n_frames)
    if not short:
        K = prefix.shape[0]
        mid = n_frames + K - 1 - 2 * (K - 1)
        rows = torch.cat([rows[: K - 1], rows[K - 1:K].expand(mid, hop),
                          rows[K:]])
    return rows.reshape(-1)[: N + (n_frames - 1) * hop]


def normalize_by_window_sum(sig: torch.Tensor, wsum: torch.Tensor,
                            threshold: torch.Tensor) -> torch.Tensor:
    """Stability-thresholded window-sum normalisation (reference:
    phase/phase.go:121-130): sig / wsum where wsum > threshold, the fade
    sig / threshold where 1e-21 < wsum <= threshold, else sig untouched."""
    safe = torch.where(wsum > 1e-21, wsum, 1.0)
    normalized = sig / safe
    faded = sig / threshold
    return torch.where(wsum > threshold, normalized,
                       torch.where(wsum > 1e-21, faded, sig))


# (id(window), hop, device) -> (window, its version, prefix table on device,
# prefix table on the CPU); the window is kept so its id cannot be recycled,
# and its version counter invalidates the entry after an in-place write
_TABLES: dict[tuple, tuple] = {}
_TABLES_MAX = 16


def _window_table(window: torch.Tensor, hop: int):
    """KH's float32 prefix table for ``window``, on the window's device and
    on the CPU, built once per window and hop."""
    key = (id(window), hop, window.device)
    entry = _TABLES.get(key)
    if entry is not None and entry[0] is window and entry[1] == window._version:
        return entry[2], entry[3]
    prefix = _prefix_rows(window.detach().to("cpu", torch.float32), hop)
    if len(_TABLES) >= _TABLES_MAX:
        _TABLES.clear()
    value = (prefix.to(window.device), prefix)
    _TABLES[key] = (window, window._version, *value)
    return value


def window_sum_threshold(prefix: torch.Tensor, n_frames: int) -> float:
    """0.5 * max(window_sum): the maximum over the distinct rows equals the
    maximum over the whole sum (the columns the last row drops are exact
    zeros, S[K-1] - S[K-2] of the window's zero padding)."""
    rows, _ = _window_sum_rows(prefix, n_frames)
    return float(0.5 * rows.max())


def irfft_window_plain(re: torch.Tensor, im: torch.Tensor, n: int,
                       window: torch.Tensor | None,
                       real_frames: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of KG on half-spectrum planes: irfft_n (the
    imaginary parts of DC and Nyquist are ignored) times the window; frames
    at or past ``real_frames`` are zeros."""
    frames = torch.fft.irfft(torch.complex(re, im), n=n, dim=-1)
    frames = frames if window is None else frames * window
    if real_frames is not None:
        frames = frames.clone()
        frames[..., real_frames:, :] = 0.0
    return frames


def launch_irfft_window(mode: int, src: torch.Tensor,
                        aux: tuple[torch.Tensor, ...], n: int, frames: int,
                        nf: int, window: torch.Tensor | None,
                        lead: tuple[int, ...], max_val: float = 0.0,
                        ihs_passes: int = 0,
                        real_frames: int | None = None,
                        fft: tuple | None = None) -> torch.Tensor:
    """Launch KG on ``src`` (see csrc/phase_decode.cu for the modes) ->
    frames_w [*lead, frames, n] float32; with ``real_frames`` the frames at
    or past that count in each row are zeros (K10's frame mask).
    ``fft``: (twiddles, per-pass table, plan) of n on the device (None:
    rfft_mag's, :func:`~gomel_tpu_torch.ops.rfft_mag.fft_tables` and
    :func:`~gomel_tpu_torch.ops.rfft_mag.fft_plan_args`)."""
    tensors = (src, *aux) + (() if window is None else (window,))
    dev = _cuda.check_cuda("irfft_window", *tensors)
    if any(t.dtype != torch.float32 for t in aux) or (
            window is not None and window.dtype != torch.float32):
        raise ValueError("irfft_window: the CUDA kernel takes float32")
    if not supported(n):
        raise ValueError(f"irfft_window: n={n} unsupported (need even "
                         f"n = n1 * n2 with n1, n2 <= 128)")
    if window is not None and window.shape != (n,):
        raise ValueError(f"irfft_window: window shape {tuple(window.shape)} "
                         f"!= ({n},)")
    if src.data_ptr() % _ALIGN[mode] or (
            window is not None and window.data_ptr() % 8):
        raise ValueError("irfft_window: misaligned source or window")
    if real_frames is not None and not 0 <= real_frames <= frames:
        raise ValueError(f"irfft_window: real_frames {real_frames} outside "
                         f"0..{frames}")
    batch = int(np.prod(lead, dtype=np.int64))
    out = torch.empty(lead + (frames, n), dtype=torch.float32, device=dev)
    if batch * frames == 0:
        return out
    ptrs = [t.data_ptr() for t in aux] + [None] * (2 - len(aux))
    tw, tw_pass, plan = ((*fft_tables(n, dev), fft_plan_args(n))
                         if fft is None else fft)
    _cuda.launch("gomel_irfft_window", dev, mode, src.data_ptr(), *ptrs,
                 None if window is None else window.data_ptr(),
                 tw.data_ptr(), tw_pass.data_ptr(), out.data_ptr(), batch,
                 frames, frames if real_frames is None else real_frames, nf, n,
                 float(max_val), int(ihs_passes), *plan)
    synth_kernel(real_frames).launches += 1
    return out


def synth_kernel(real_frames: int | None) -> _cuda.Kernel:
    """KG's tally for a launch with (or without) a real-frame count."""
    return SYNTH_KERNEL if real_frames is None else SYNTH_MASKED_KERNEL


def irfft_window(re: torch.Tensor, im: torch.Tensor, n: int,
                 window: torch.Tensor | None = None,
                 real_frames: int | None = None, backend: str = "auto",
                 precision=None) -> torch.Tensor:
    """Half-spectrum planes [..., F, n/2 + 1] -> irfft_n x window
    [..., F, n] (``window`` None: no window); frames at or past
    ``real_frames`` are zeros. ``backend`` picks the route
    (ops/fftbackend.resolve): KG, the xla route or the matmul DFT KO;
    ``precision`` applies to the ``mm`` route only."""
    if re.shape != im.shape or re.shape[-1] != n // 2 + 1:
        raise ValueError(f"irfft_window: planes {tuple(re.shape)}, "
                         f"{tuple(im.shape)} do not hold n/2 + 1 = "
                         f"{n // 2 + 1} bins")
    route = fftbackend.resolve(backend, n, re.device.type)
    if route == "mm":
        return dft_mm.istft_frames(re, im, n, window, precision, real_frames)
    if re.device.type == "cpu":
        return irfft_window_plain(re, im, n, window, real_frames)
    if re.dtype != torch.float32:
        raise ValueError("irfft_window: the CUDA kernel takes float32")
    if route == "xla":
        with annotate(fftbackend.XLA_ROUTE.span):
            re, im = re.contiguous(), im.contiguous()
            _cuda.check_cuda("irfft_window", re, im,
                             *(() if window is None else (window,)))
            fftbackend.XLA_ROUTE.launches += 1
            return irfft_window_plain(re, im, n, window, real_frames)
    *lead, frames, _ = re.shape
    with annotate(synth_kernel(real_frames).span):
        return launch_irfft_window(MODE_PLANES, re.contiguous(),
                                   (im.contiguous(),), n, frames, n // 2 + 1,
                                   window, tuple(lead),
                                   real_frames=real_frames)


def check_frame_chunk(chunk: int, hop: int, n: int) -> None:
    """The JAX program's rule for a synthesis chunk (gomel_tpu/ops/istft.py
    ``chunked_irfft_overlap_add``): a tail of N - hop samples must not span
    two chunk bodies, so ``chunk * hop >= N - hop``; ValueError with its
    text otherwise."""
    if chunk * hop < n - hop:
        raise ValueError(f"chunk {chunk} too small: need chunk*hop >= "
                         f"N - hop = {n - hop}")


def chunked_irfft_overlap_add(re: torch.Tensor, im: torch.Tensor, hop: int,
                              window_arr: torch.Tensor, chunk: int,
                              fft_backend: str = "xla", frame_mask=None, *,
                              real_frames: int | None = None) -> torch.Tensor:
    """Un-normalised windowed overlap-add synthesis: [..., F, N/2 + 1]
    planes -> [..., N + (F-1)*hop] (gomel_tpu/ops/istft.py:75).

    ``frame_mask`` (optional bool [F], array or tensor): frames masked False
    contribute nothing. A prefix mask (the sharded decode's padded frames)
    becomes KG's real-frame count; any other mask zeroes the masked frames'
    planes before the one KG launch. ``real_frames`` gives the prefix as a
    count instead (frames at or past it contribute nothing); pass one or
    the other.

    The JAX program scans over ``chunk``-frame slices and carries each
    overlap-add tail, to keep a slice's frames in a TPU core's fast memory.
    Here one KG launch writes every frame and one KH launch without a window
    sums them, one owner per output sample, so no tail is carried: the result
    equals the JAX program's up to the order of the adds at slice edges.
    ``chunk`` is validated as the JAX program does (:func:`check_frame_chunk`).
    ``fft_backend`` as in :func:`irfft_window` (the JAX default, ``xla``, is
    the library FFT)."""
    n = (re.shape[-1] - 1) * 2
    check_frame_chunk(chunk, hop, n)
    if frame_mask is not None:
        if real_frames is not None:
            raise TypeError("chunked_irfft_overlap_add: pass frame_mask or "
                            "real_frames, not both")
        mask = torch.as_tensor(frame_mask, device="cpu").to(torch.bool)
        frames = re.shape[-2]
        if mask.shape != (frames,):
            raise ValueError(f"chunked_irfft_overlap_add: frame_mask "
                             f"{tuple(mask.shape)} for {frames} frames")
        real_frames = int(mask.sum())
        if not bool(mask[:real_frames].all()):
            keep = mask.to(re.device)[:, None]
            re = torch.where(keep, re, 0.0)
            im = torch.where(keep, im, 0.0)
            real_frames = None
    return overlap_add(irfft_window(re, im, n, window_arr, real_frames,
                                    fft_backend), hop)


def overlap_normalize_plain(frames_w: torch.Tensor, hop: int,
                            window: torch.Tensor, volume_boost: float = 0.0,
                            pcm16: bool = False):
    """Plain PyTorch version of KH: overlap-add, window-sum normalisation,
    boost when non-zero, then float32 or (int16 PCM, per-row finite flag)."""
    sig = overlap_add_plain(frames_w, hop)
    wsum = window_sum(window.to(frames_w.dtype), frames_w.shape[-2], hop)
    sig = normalize_by_window_sum(sig, wsum, 0.5 * wsum.max())
    if volume_boost != 0.0:
        sig = sig * float(volume_boost)
    if not pcm16:
        return sig
    finite = torch.isfinite(sig).all(dim=-1)
    return pcm16_encode(sig)[0], finite


def window_sum_short(taps: int, n_frames: int) -> bool:
    """Whether the window sum of ``n_frames`` frames is short: all its
    F + K - 1 hop-rows are distinct (:func:`_window_sum_rows`)."""
    return n_frames + taps - 1 <= 2 * (taps - 1)


def _launch_ola(frames_w: torch.Tensor, hop: int,
                window: torch.Tensor | None, volume_boost: float,
                pcm16: bool):
    with annotate(OLA_KERNEL.span):
        *_, frames, n = frames_w.shape
        table, threshold, short = None, 0.0, False
        if window is not None:
            if window.shape != (n,):
                raise ValueError(f"overlap_normalize: window shape "
                                 f"{tuple(window.shape)} != ({n},)")
            table, prefix = _window_table(window, hop)
            table = table.to(frames_w.device)
            threshold = window_sum_threshold(prefix, frames)
            short = window_sum_short(prefix.shape[0], frames)
        return launch_ola(frames_w, hop, table, threshold, short,
                          volume_boost, pcm16)


def launch_ola(frames_w: torch.Tensor, hop: int, table: torch.Tensor | None,
               threshold: float, short: bool, volume_boost: float,
               pcm16: bool):
    """Launch KH on CUDA frames [..., F, N]: the overlap-add, and with the
    window's prefix table [K, hop] on that device (:func:`_prefix_rows`) the
    normalisation under ``threshold`` (:func:`window_sum_threshold`) and
    ``short`` (:func:`window_sum_short`) of F frames."""
    dev = _cuda.check_cuda("overlap_normalize", frames_w)
    if frames_w.dtype != torch.float32:
        raise ValueError("overlap_normalize: the CUDA kernel takes float32")
    *lead, frames, n = frames_w.shape
    if frames < 1 or hop < 1:
        raise ValueError(f"overlap_normalize: {frames} frames, hop {hop}")
    lead = tuple(lead)
    batch = int(np.prod(lead, dtype=np.int64))
    length = n + (frames - 1) * hop
    out_f = out_pcm = None
    if pcm16:
        out_pcm = torch.empty(lead + (length,), dtype=torch.int16, device=dev)
    else:
        out_f = torch.empty(lead + (length,), dtype=torch.float32, device=dev)
    finite = torch.ones(lead, dtype=torch.int32, device=dev)
    if batch > 0:
        _cuda.launch("gomel_overlap_normalize", dev, frames_w.data_ptr(),
                     None if table is None else table.data_ptr(),
                     None if out_f is None else out_f.data_ptr(),
                     None if out_pcm is None else out_pcm.data_ptr(),
                     finite.data_ptr(), batch, frames, n, hop, int(short),
                     threshold, float(volume_boost))
        OLA_KERNEL.launches += 1
    if pcm16:
        return out_pcm, finite.bool()
    return out_f


def overlap_normalize(frames_w: torch.Tensor, hop: int, window: torch.Tensor,
                      volume_boost: float = 0.0, pcm16: bool = False):
    """Windowed frames [..., F, N] -> normalised signal [..., N + (F-1)*hop]:
    overlap-add, divide by the window sum (istft.py:189 branches), multiply
    by ``volume_boost`` when it is non-zero. With ``pcm16``, returns
    (int16 PCM [..., L], all-finite flag [...]) instead (quantize.py:124)."""
    if frames_w.device.type == "cpu":
        return overlap_normalize_plain(frames_w, hop, window, volume_boost,
                                       pcm16)
    return _launch_ola(frames_w.contiguous(), hop, window, volume_boost,
                       pcm16)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Sum overlapping frames: [..., F, N] -> [..., N + (F-1)*hop] (KH with
    no normalisation on a CUDA tensor)."""
    if frames.device.type == "cpu":
        return overlap_add_plain(frames, hop)
    return _launch_ola(frames.contiguous(), hop, None, 0.0, False)


def istft_direct_planes(re: torch.Tensor, im: torch.Tensor, hop: int,
                        window, fft_backend: str = "auto",
                        frame_chunk: int | None = None) -> torch.Tensor:
    """Direct (0-iteration) iSTFT with window-sum normalisation: real/imag
    planes [..., F, N/2 + 1] -> signal [..., N + (F-1)*hop] (reference:
    phase/phase.go:93-133). ``window``: [N] numpy array or tensor.
    ``fft_backend`` as in :func:`irfft_window`: ``auto`` is exact on every
    device, as the JAX program's ``auto`` -> ``xla``. ``frame_chunk``: the
    JAX program's per-chunk synthesis, checked as it checks it
    (:func:`check_frame_chunk`); KH owns each output sample once and carries
    no tail, so the synthesis stays one KG and one KH launch, and the
    result is the unchunked one."""
    n = (re.shape[-1] - 1) * 2
    if frame_chunk:
        check_frame_chunk(frame_chunk, hop, n)
    window = torch.as_tensor(window, dtype=re.dtype, device=re.device)
    return overlap_normalize(irfft_window(re, im, n, window,
                                          backend=fft_backend), hop, window)


def istft_direct(half_spec: torch.Tensor, hop: int, window,
                 fft_backend: str = "auto") -> torch.Tensor:
    """Complex-input wrapper over :func:`istft_direct_planes`
    (gomel_tpu/ops/istft.py:182): half spectrum [..., F, N/2 + 1] -> signal
    [..., N + (F-1)*hop]."""
    return istft_direct_planes(half_spec.real.contiguous(),
                               half_spec.imag.contiguous(), hop, window,
                               fft_backend)


def _window_sum_span(prefix: torch.Tensor, n_frames: int, hop: int,
                     start: int, length: int) -> torch.Tensor:
    """Samples ``start .. start + length - 1`` of the window sum of
    ``n_frames`` frames (:func:`window_sum`, 0 past its end), read from the
    distinct rows as KM reads them from the prefix table."""
    K = prefix.shape[0]
    rows_out = n_frames + K - 1
    rows, short = _window_sum_rows(prefix, n_frames)
    p = torch.arange(start, start + length, device=prefix.device)
    i, c = p // hop, p % hop
    if short:
        r = i
    else:
        r = torch.where(i < K - 1, i, torch.where(
            i < rows_out - (K - 1), K - 1, i - (rows_out - (K - 1)) + K))
    w = rows[torch.clamp(r, 0, rows.shape[0] - 1), c]
    return torch.where(i < rows_out, w, 0.0)


def shard_epilogue_plain(sig_ext: torch.Tensor, recv: torch.Tensor | None,
                         chunk: int, *, window: torch.Tensor | None = None,
                         hop: int = 0, start: int = 0, n_frames: int = 0,
                         volume_boost: float = 0.0,
                         t_prev: torch.Tensor | None = None,
                         momentum: float = 0.0, pcm16: bool = False,
                         extend: bool = False):
    """Plain PyTorch version of KM (see :func:`shard_epilogue`)."""
    table, threshold = None, 0.0
    if window is not None:
        table, prefix = _window_table(window, hop)
        threshold = window_sum_threshold(prefix, n_frames)
    return shard_epilogue_table_plain(
        sig_ext, recv, chunk, table, threshold, hop=hop, start=start,
        n_frames=n_frames, volume_boost=volume_boost, t_prev=t_prev,
        momentum=momentum, pcm16=pcm16, extend=extend)


def shard_epilogue_table_plain(sig_ext: torch.Tensor,
                               recv: torch.Tensor | None, chunk: int,
                               table: torch.Tensor | None, threshold: float,
                               *, hop: int = 0, start: int = 0,
                               n_frames: int = 0, volume_boost: float = 0.0,
                               t_prev: torch.Tensor | None = None,
                               momentum: float = 0.0, pcm16: bool = False,
                               extend: bool = False):
    """:func:`shard_epilogue_plain` given the window's prefix table
    (:func:`_prefix_rows`; None: no normalisation) and the global
    threshold (:func:`window_sum_threshold`)."""
    halo = sig_ext.shape[-1] - chunk
    t = sig_ext[..., :chunk].clone()
    if recv is not None:
        t[..., :halo] = t[..., :halo] + recv.to(t.device)
    y = t
    if table is not None:
        # the table already on the device: a copy from the host would wait
        # for the work queued before it
        wsum = _window_sum_span(table.to(t.device), n_frames, hop, start,
                                chunk)
        threshold = torch.full((), threshold, dtype=t.dtype, device=t.device)
        y = normalize_by_window_sum(t, wsum, threshold)
        if volume_boost != 0.0:
            y = y * torch.full((), float(volume_boost), dtype=y.dtype,
                               device=y.device)
    if t_prev is not None:
        y = t + momentum * (t - t_prev)
    finite = torch.isfinite(y).all(dim=-1)
    if pcm16:
        return pcm16_encode(y)[0], finite
    if extend:
        y = torch.nn.functional.pad(y, (0, halo))
    return (y, t) if t_prev is not None else y


def check_shard_epilogue(sig_ext: torch.Tensor, recv: torch.Tensor | None,
                         chunk: int, normalize: bool, hop: int, start: int,
                         n_frames: int, t_prev: torch.Tensor | None,
                         pcm16: bool) -> None:
    """The shapes and modes :func:`shard_epilogue` takes."""
    if sig_ext.ndim != 2 or not 0 < chunk <= sig_ext.shape[1]:
        raise ValueError(f"shard_epilogue: signal {tuple(sig_ext.shape)}, "
                         f"chunk {chunk}")
    b, ext_len = sig_ext.shape
    halo = ext_len - chunk
    if recv is not None and tuple(recv.shape) != (b, halo):
        raise ValueError(f"shard_epilogue: recv {tuple(recv.shape)} != "
                         f"{(b, halo)}")
    if t_prev is not None and (normalize or pcm16
                               or tuple(t_prev.shape) != (b, chunk)):
        raise ValueError("shard_epilogue: the momentum step takes t_prev "
                         "[B, chunk] and no window or PCM-16")
    if normalize and (hop < 1 or n_frames < 1):
        raise ValueError(f"shard_epilogue: hop {hop}, {n_frames} frames")
    if start < 0:
        raise ValueError(f"shard_epilogue: start {start} < 0")


def shard_epilogue(sig_ext: torch.Tensor, recv: torch.Tensor | None,
                   chunk: int, *, window: torch.Tensor | None = None,
                   hop: int = 0, start: int = 0, n_frames: int = 0,
                   volume_boost: float = 0.0,
                   t_prev: torch.Tensor | None = None, momentum: float = 0.0,
                   pcm16: bool = False, extend: bool = False):
    """The shard epilogue of the frame-sharded synthesis (kernel KM on a
    CUDA tensor): a shard's un-normalised overlap-add ``sig_ext``
    [B, chunk + halo] plus the tail ``recv`` [B, halo] its left neighbour
    spilled into it (None on shard 0) -> the shard's [B, chunk] samples t.

    With ``window`` (and ``hop``): divide by the window sum of a signal of
    ``n_frames`` real frames at each sample's global position ``start + j``
    under the global threshold 0.5 * max of that sum, with the branches of
    :func:`normalize_by_window_sum`, then x ``volume_boost`` when non-zero
    (gomel_tpu/parallel/sharded.py:503-508). With ``t_prev`` [B, chunk]:
    the momentum step, returning (c = t + momentum * (t - t_prev), t)
    (:423-426). Else t. ``pcm16`` returns (int16 [B, chunk], per-row finite
    flags) instead of the float result; ``extend`` returns the float result
    (c in the momentum step) in a [B, chunk + halo] buffer whose last halo
    columns are for the caller to fill (the next Griffin-Lim iteration's
    extended signal)."""
    check_shard_epilogue(sig_ext, recv, chunk, window is not None, hop,
                         start, n_frames, t_prev, pcm16)
    if sig_ext.device.type == "cpu":
        return shard_epilogue_plain(
            sig_ext, recv, chunk, window=window, hop=hop, start=start,
            n_frames=n_frames, volume_boost=volume_boost, t_prev=t_prev,
            momentum=momentum, pcm16=pcm16, extend=extend)
    with annotate(SHARD_KERNEL.span):
        table, threshold = None, 0.0
        if window is not None:
            table, prefix = _window_table(window, hop)
            table = table.to(sig_ext.device)
            threshold = window_sum_threshold(prefix, n_frames)
        return launch_shard_epilogue(
            sig_ext, recv, chunk, table, threshold, hop=hop, start=start,
            n_frames=n_frames, volume_boost=volume_boost, t_prev=t_prev,
            momentum=momentum, pcm16=pcm16, extend=extend)


def launch_shard_epilogue(sig_ext: torch.Tensor, recv: torch.Tensor | None,
                          chunk: int, table: torch.Tensor | None,
                          threshold: float, *, hop: int = 0, start: int = 0,
                          n_frames: int = 0, volume_boost: float = 0.0,
                          t_prev: torch.Tensor | None = None,
                          momentum: float = 0.0, pcm16: bool = False,
                          extend: bool = False):
    """Launch KM on CUDA tensors (see :func:`shard_epilogue`), given the
    window's prefix table on that device (None: no normalisation) and the
    global threshold (:func:`window_sum_threshold`)."""
    b, ext_len = sig_ext.shape
    halo = ext_len - chunk
    sig_ext = sig_ext.contiguous()
    if t_prev is not None:
        t_prev = t_prev.contiguous()
    dev = _cuda.check_cuda("shard_epilogue", sig_ext,
                           *(() if t_prev is None else (t_prev,)))
    if recv is not None and (recv.device != dev or recv.stride(-1) != 1
                             or recv.dtype != torch.float32):
        recv = recv.to(dev, torch.float32).contiguous()
    if sig_ext.dtype != torch.float32 or (
            t_prev is not None and t_prev.dtype != torch.float32):
        raise ValueError("shard_epilogue: the CUDA kernel takes float32")
    short, taps = False, 1
    if table is not None:
        taps = table.shape[0]
        short = window_sum_short(taps, n_frames)
    out_f = out_t = out_pcm = None
    stride = chunk + halo if extend else chunk
    if pcm16:
        out_pcm = torch.empty((b, chunk), dtype=torch.int16, device=dev)
    else:
        out_f = torch.empty((b, stride), dtype=torch.float32, device=dev)
    if t_prev is not None:
        out_t = torch.empty((b, chunk), dtype=torch.float32, device=dev)
    finite = torch.ones(b, dtype=torch.int32, device=dev)
    if b > 0:
        _cuda.launch("gomel_shard_epilogue", dev, sig_ext.data_ptr(), ext_len,
                     None if recv is None else recv.data_ptr(),
                     0 if recv is None else recv.stride(0), halo,
                     None if table is None else table.data_ptr(), start,
                     n_frames, hop, taps, int(short), threshold,
                     float(volume_boost),
                     None if t_prev is None else t_prev.data_ptr(),
                     float(momentum),
                     None if out_f is None else out_f.data_ptr(), stride,
                     None if out_t is None else out_t.data_ptr(),
                     None if out_pcm is None else out_pcm.data_ptr(),
                     finite.data_ptr(), b, chunk)
        SHARD_KERNEL.launches += 1
    if pcm16:
        return out_pcm, finite.bool()
    if t_prev is not None:
        return out_f, out_t
    return out_f
