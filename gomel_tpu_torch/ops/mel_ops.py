"""Mel spectrogram codec: the encode's filterbank + log is kernel KC
(csrc/mel_log.cu, on magnitudes in device memory) or, where KB's
power-of-two kernel takes the transform, the fused KB + KC launch
(csrc/rfft_mag.cu ``gomel_stft_mel_log``; from int16 PCM its int16 mode,
``gomel_stft_mel_log_pcm16``, which folds in KA's mono ingest), both on the
band table of :func:`mel_band_plan` (csrc/mel_bands.cuh); the decode's dequantize + exp +
inverse filterbank + magnitudes is kernel KI (csrc/mel_decode.cu), and its
Griffin-Lim is kernels KJ and KK (ops/griffinlim.py).

Counterpart of ``gomel_tpu/ops/mel_ops.py``. Encode (reference
mel/mel.go:46-74): for real input ``|S[j]|`` (ch0) and ``|S[N-j-1]| =
|S[j+1]|`` (ch1) for j in [0, N/2), so the two channels are the rfft
magnitude vector offset by one bin, and one extended weight matrix
[N/2 + 1, 2M] with interleaved columns maps the magnitudes to both. Decode
(mel/mel.go:142-152): exp, the ``undomel`` matrix U [N/2, M], the TuneMul /
TuneAdd undo, then Griffin-Lim on the fixed magnitudes.

Layout: [..., frames, num_mels, 2] channel-last, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _cuda, fftbackend, rfft_mag
from .griffinlim import griffin_lim, griffin_lim_magnitudes
from .quantize import (dequantize_mel_plane, pcm16_ingest,
                       pcm16_ingest_batch, pcm16_ingest_plain)
from .rfft_mag import stft_mag, stft_mag_plain
from .stft import map_frame_chunks, num_frames_of, window_like

KERNEL = _cuda.Kernel("mel_log", "gomel_tpu_torch/csrc/mel_log.cu",
                      "gomel_tpu/ops/mel_ops.py:98")
FUSED_KERNEL = _cuda.Kernel("stft_mel_log", "gomel_tpu_torch/csrc/rfft_mag.cu",
                            "gomel_tpu/ops/mxu_fft.py:140 + "
                            "gomel_tpu/ops/mel_ops.py:98")
# the fused launch's int16 mode: a tally of its own (FUSED_KERNEL counts the
# float launch only)
FUSED_PCM16_KERNEL = _cuda.Kernel("stft_mel_log pcm16",
                                  "gomel_tpu_torch/csrc/rfft_mag.cu",
                                  "gomel_tpu/ops/quantize.py:105 + "
                                  "gomel_tpu/ops/mxu_fft.py:140 + "
                                  "gomel_tpu/ops/mel_ops.py:98")
MAG_KERNEL = _cuda.Kernel("mel_to_magnitudes",
                          "gomel_tpu_torch/csrc/mel_decode.cu",
                          "gomel_tpu/ops/mel_ops.py:152")

# the band table's groups: 16 bands a group (a warp's 32 lanes, two
# channels a band), balanced over 4 warps (csrc/mel_bands.cuh kMelBands,
# kMelWarps)
KC_BANDS = 16
KC_WARPS = 4


class MelBandPlan(NamedTuple):
    """The band table of KC and the fused launch (csrc/mel_bands.cuh)."""
    slots: np.ndarray     # int32 [groups * 16, 4]: lo, width, column, offset
    weights: np.ndarray   # float32, each group's weights t-major
    groups: int           # a multiple of KC_WARPS


def band_spans(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each row's first non-zero column and the width of its span up to the
    last (0, 0 for an all-zero row): for [M, N/2] forward weights, each
    band's bins."""
    nz = w != 0
    any_nz = nz.any(axis=1)
    lo = np.where(any_nz, nz.argmax(axis=1), 0)
    hi = np.where(any_nz, w.shape[1] - nz[:, ::-1].argmax(axis=1), 0)
    return lo, hi - lo


def mel_band_plan(w: np.ndarray) -> MelBandPlan:
    """[M, N/2] forward weights -> the packed band table. Bands sorted by
    span width (stable) are cut into groups of 16; the groups, padded with
    empty ones to a multiple of 4, are dealt to 4 warps, widest first, each
    to the warp with the least work so far among those with room (a
    group's work is its widest span), and warp w's k-th group sits at
    position w + 4 k. Slot i of the group at position p is band b's
    {lo, width, 2 b, base + i} (empty: {0, 0, -1, 0}), with its weights
    w[b, lo + t] at base + 16 t + i, zero past its width; base runs over the
    positions in order. Column 2b + 1, band b one bin up, reads the same
    weights from bin lo + 1."""
    w = np.asarray(w, dtype=np.float32)
    lo, width = band_spans(w)
    order = np.argsort(width, kind="stable")
    bands = [order[i:i + KC_BANDS] for i in range(0, len(order), KC_BANDS)]
    groups = -(-len(bands) // KC_WARPS) * KC_WARPS
    bands += [order[:0]] * (groups - len(bands))
    cost = [int(width[g].max()) if len(g) else 0 for g in bands]
    per_warp = groups // KC_WARPS
    dealt: list[list[int]] = [[] for _ in range(KC_WARPS)]
    load = [0] * KC_WARPS
    for g in sorted(range(groups), key=lambda i: -cost[i]):
        warp = min((v for v in range(KC_WARPS) if len(dealt[v]) < per_warp),
                   key=lambda v: (load[v], v))
        dealt[warp].append(g)
        load[warp] += cost[g]
    slots = np.zeros((groups * KC_BANDS, 4), np.int32)
    slots[:, 2] = -1
    chunks, base = [], 0
    for p in range(groups):
        gi = dealt[p % KC_WARPS][p // KC_WARPS]
        block = np.zeros((cost[gi], KC_BANDS), np.float32)
        for i, b in enumerate(bands[gi]):
            block[:width[b], i] = w[b, lo[b]:lo[b] + width[b]]
            slots[p * KC_BANDS + i] = (lo[b], width[b], 2 * b, base + i)
        chunks.append(block.reshape(-1))
        base += block.size
    weights = (np.concatenate(chunks) if base else np.zeros(1, np.float32))
    return MelBandPlan(slots, weights, groups)


# id(weights) -> (pinned weights, their version, value), one entry per
# filterbank in use: W_ext and its spans, KC's band table, and (below) KI's
_EXT_WEIGHT_CACHE: dict[int, tuple[torch.Tensor, int, tuple]] = {}
_BAND_PLAN_CACHE: dict[int, tuple[torch.Tensor, int, tuple]] = {}
_EXT_WEIGHT_CACHE_MAX = 16


def _memoized(cache: dict, weights: torch.Tensor, make):
    """``make(weights as numpy)``, kept in ``cache`` for these weights. The
    source tensor is kept in the entry so its id cannot be recycled, and its
    version counter (bumped by every in-place write, unlike the JAX
    package's immutable arrays) invalidates the entry."""
    entry = cache.get(id(weights))
    if (entry is not None and entry[0] is weights
            and entry[1] == weights._version):
        return entry[2]
    value = make(weights.detach().cpu().numpy())
    if len(cache) >= _EXT_WEIGHT_CACHE_MAX:
        cache.clear()
    cache[id(weights)] = (weights, weights._version, value)
    return value


def extended_weights_np(w: np.ndarray) -> np.ndarray:
    """[M, N/2] weights -> W_ext [N/2+1, 2M]: column 2j holds band j on
    bins [0, N/2), column 2j+1 the same band one bin up."""
    num_mels, n_bins = w.shape
    we = np.zeros((n_bins + 1, 2 * num_mels), dtype=w.dtype)
    we[:-1, 0::2] = w.T
    we[1:, 1::2] = w.T
    return we


def _extended_weights(fwd_weights: torch.Tensor) -> tuple:
    """Memoized (W_ext, lo, hi) on the weights' device: the plain version's
    dense product, and [lo[c], hi[c]) the span of column c's non-zeros (lo =
    hi = 0 for an all-zero column), the bins the kernels sum."""
    def make(w):
        lo, width = band_spans(w)
        lo2 = np.stack([lo, lo + (width > 0)], axis=1).reshape(-1)
        dev = fwd_weights.device
        return (torch.from_numpy(extended_weights_np(w)).to(dev),
                torch.from_numpy(lo2.astype(np.int32)).to(dev),
                torch.from_numpy((lo2 + np.repeat(width, 2)).astype(np.int32))
                .to(dev))
    return _memoized(_EXT_WEIGHT_CACHE, fwd_weights, make)


def _mel_band_table(fwd_weights: torch.Tensor) -> tuple:
    """Memoized (slots, weights, groups) of :func:`mel_band_plan` on the
    weights' device (float32 weights only: the kernels' type)."""
    if fwd_weights.dtype != torch.float32:
        raise ValueError("mel_log: the CUDA kernels take float32 weights")

    def make(w):
        plan = mel_band_plan(w)
        dev = fwd_weights.device
        return (torch.from_numpy(plan.slots).to(dev),
                torch.from_numpy(plan.weights).to(dev), plan.groups)
    return _memoized(_BAND_PLAN_CACHE, fwd_weights, make)


def spectral_normalize(x: torch.Tensor) -> torch.Tensor:
    """clamp below at 1e-5, then natural log (reference: mel/impl.go:410-419)."""
    return torch.log(torch.clamp_min(x, 1e-5))


def mel_from_mags_plain(mags: torch.Tensor,
                        fwd_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a dense product with W_ext, then
    the log."""
    return mel_from_ext_plain(mags, _extended_weights(fwd_weights)[0])


def mel_from_ext_plain(mags: torch.Tensor, we: torch.Tensor) -> torch.Tensor:
    """:func:`mel_from_mags_plain` given W_ext [N/2+1, 2M]
    (:func:`extended_weights_np`)."""
    y = mags @ we.to(mags.dtype)
    return spectral_normalize(y.reshape(*y.shape[:-1], we.shape[1] // 2, 2))


def _mel_from_mags(mags: torch.Tensor, fwd_weights: torch.Tensor) -> torch.Tensor:
    """|rfft| [..., N/2+1] -> log-mel [..., num_mels, 2]."""
    if mags.device.type == "cpu":
        return mel_from_mags_plain(mags, fwd_weights)
    slots, weights, groups = _mel_band_table(fwd_weights)
    bins = fwd_weights.shape[1] + 1
    if mags.shape[-1] != bins:
        raise ValueError(f"mel_log: {mags.shape[-1]} bins, weights expect {bins}")
    return launch_mel_log(mags, slots, weights, groups, fwd_weights.shape[0])


def launch_mel_log(mags: torch.Tensor, slots: torch.Tensor,
                   weights: torch.Tensor, groups: int,
                   mels: int) -> torch.Tensor:
    """Launch KC on CUDA magnitudes [..., N/2+1] with the band table of
    :func:`mel_band_plan` -> [..., mels, 2]."""
    dev = _cuda.check_cuda("mel_log", mags, slots, weights)
    if mags.dtype != torch.float32:
        raise ValueError("mel_log: the CUDA kernel takes float32 tensors")
    bins, cols = mags.shape[-1], 2 * mels
    rows = mags.numel() // bins
    out = torch.empty(mags.shape[:-1] + (mels, 2), dtype=torch.float32,
                      device=dev)
    if rows == 0:
        return out
    _cuda.launch("gomel_mel_log", dev, mags.data_ptr(), slots.data_ptr(),
                 weights.data_ptr(), groups, weights.numel(), out.data_ptr(),
                 rows, bins, cols)
    KERNEL.launches += 1
    return out


def fused_route(n: int, backend: str, device_type: str) -> bool:
    """Whether the mel encode of an n-point transform runs the fused KB + KC
    launch: on a CUDA tensor whose transform resolves to the hand kernels
    (ops/fftbackend.resolve: "mxu") at an n whose half is a power of two,
    where KB runs its register-resident kernel. Never on the CPU."""
    if device_type != "cuda":
        return False
    m = n // 2
    return (fftbackend.resolve(backend, n, device_type) == "mxu"
            and n % 2 == 0 and m >= 2 and m & (m - 1) == 0)


def stft_mel_log_plain(x: torch.Tensor, window: torch.Tensor | None, n: int,
                       hop: int, fwd_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fused launch: KB's plain version, then
    KC's."""
    return mel_from_mags_plain(stft_mag_plain(x, window, n, hop), fwd_weights)


def stft_mel_log(x: torch.Tensor, window: torch.Tensor | None, n: int,
                 hop: int, fwd_weights: torch.Tensor) -> torch.Tensor:
    """The log-mel [..., F, M, 2] of the hop-spaced frames of ``x`` [..., L]
    times ``window``, in one launch (KB's transform with KC's band sum in
    its epilogue) when n/2 is a power of two; raises at any other n on a
    CUDA tensor. The plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return stft_mel_log_plain(x, window, n, hop, fwd_weights)
    m = n // 2
    if n % 2 or m < 2 or m & (m - 1):
        raise ValueError(f"stft_mel_log: n/2 = {n / 2} is not a power of two")
    if 2 * fwd_weights.shape[1] != n:
        raise ValueError(f"stft_mel_log: weights {tuple(fwd_weights.shape)} "
                         f"do not match n={n}")
    dev = rfft_mag._check("stft_mel_log", x, window, n)
    slots, weights, groups = _mel_band_table(fwd_weights)
    return launch_stft_mel_log(x, window, *rfft_mag.fft_tables(n, dev),
                               rfft_mag.fft_plan_args(n), slots, weights,
                               groups, fwd_weights.shape[0], n, hop)


def launch_stft_mel_log(x: torch.Tensor, window: torch.Tensor | None,
                        tw: torch.Tensor, tw_pass: torch.Tensor,
                        plan: tuple[int, int, int], slots: torch.Tensor,
                        weights: torch.Tensor, groups: int, mels: int,
                        n: int, hop: int) -> torch.Tensor:
    """Launch the fused KB + KC on a checked CUDA signal (rfft_mag._check)
    with the FFT tables and plan of n (a power of two at n/2) and the band
    table of :func:`mel_band_plan`."""
    dev = _cuda.check_cuda("stft_mel_log", x, slots, weights)
    lead, length = x.shape[:-1], x.shape[-1]
    frames = num_frames_of(length, n, hop)
    batch = int(np.prod(lead, dtype=np.int64))
    out = torch.empty(lead + (frames, mels, 2), dtype=torch.float32,
                      device=dev)
    if batch == 0 or frames == 0:
        return out
    win_ptr = None if window is None else window.data_ptr()
    _cuda.launch("gomel_stft_mel_log", dev, x.data_ptr(), win_ptr,
                 tw.data_ptr(), tw_pass.data_ptr(), slots.data_ptr(),
                 weights.data_ptr(), groups, out.data_ptr(), 2 * mels, batch,
                 frames, length, hop, n, *plan)
    FUSED_KERNEL.launches += 1
    return out


def stft_mel_log_pcm16_plain(pcm: torch.Tensor, scale, pad_to: int,
                             window: torch.Tensor | None, n: int, hop: int,
                             fwd_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fused launch's int16 mode: KA's plain
    version (to float32), then the fused launch's."""
    x = pcm16_ingest_plain(pcm, torch.float32, scale, pad_to,
                           batched=pcm.ndim == 2)
    return stft_mel_log_plain(x, window, n, hop, fwd_weights)


def stft_mel_log_pcm16(pcm: torch.Tensor, scale, pad_to: int,
                       window: torch.Tensor | None, n: int, hop: int,
                       fwd_weights: torch.Tensor) -> torch.Tensor:
    """The log-mel [..., F, M, 2] of mono int16 PCM [L] or [B, L] read as KA
    reads it (ops/quantize.pcm16_ingest: each sample divided by ``scale``,
    one divisor or a [B] tensor or array of per-row ones, powers of two in
    [2^-100, 2^100] on the card; zero-padded to max(L, pad_to), which sets
    F), in one launch of the fused KB + KC in its int16 mode, bit-equal to
    KA followed by :func:`stft_mel_log`. n/2 must be a power of two on a
    CUDA tensor; there is no fallback to KA. Rows already padded to the
    frames' end (L >= pad_to) take the kernel's build without a test a
    load. The plain version on a CPU tensor."""
    if pcm.dtype != torch.int16 or pcm.ndim not in (1, 2):
        raise ValueError(f"stft_mel_log_pcm16 takes int16 [L] or [B, L] "
                         f"(got {pcm.dtype}, {tuple(pcm.shape)})")
    per_row = (scale.ndim > 0 if isinstance(scale, torch.Tensor)
               else np.ndim(scale) > 0)
    if per_row:
        scale = torch.as_tensor(scale, dtype=torch.float32)
        if pcm.ndim != 2 or tuple(scale.shape) != (pcm.shape[0],):
            raise ValueError(f"stft_mel_log_pcm16: per-row scales "
                             f"{tuple(scale.shape)} need a [B, L] batch of "
                             f"{pcm.shape[0] if pcm.ndim == 2 else 1} rows")
    if pcm.device.type == "cpu":
        return stft_mel_log_pcm16_plain(pcm, scale, pad_to, window, n, hop,
                                        fwd_weights)
    # the kernel divides by one exact FMA: powers of two only (a table on
    # the card is read back once to check)
    values = (scale.detach().cpu().double().numpy() if per_row
              else np.array([float(scale)]))
    mant, exp = np.frexp(values)
    if not ((mant == 0.5) & (exp >= -99) & (exp <= 101)).all():
        raise ValueError(f"stft_mel_log_pcm16: scales must be powers of two "
                         f"in [2^-100, 2^100] (got {values.tolist()})")
    if per_row:
        scale = scale.to(pcm.device)
    m = n // 2
    if n % 2 or m < 2 or m & (m - 1):
        raise ValueError(f"stft_mel_log_pcm16: n/2 = {n / 2} is not a power "
                         f"of two")
    if 2 * fwd_weights.shape[1] != n:
        raise ValueError(f"stft_mel_log_pcm16: weights "
                         f"{tuple(fwd_weights.shape)} do not match n={n}")
    tensors = [pcm] + ([scale.contiguous()] if per_row else [])
    if window is not None:
        tensors.append(window)
        if window.dtype != torch.float32 or window.shape != (n,):
            raise ValueError(f"stft_mel_log_pcm16: the window must be float32 "
                             f"({n},)")
    dev = _cuda.check_cuda("stft_mel_log_pcm16", *tensors)
    slots, weights, groups = _mel_band_table(fwd_weights)
    tw, tw_pass = rfft_mag.fft_tables(n, dev)
    n_in, mels = pcm.shape[-1], fwd_weights.shape[0]
    rows = pcm.shape[0] if pcm.ndim == 2 else 1
    frames = num_frames_of(max(n_in, pad_to), n, hop)
    out = torch.empty(pcm.shape[:-1] + (frames, mels, 2), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    _cuda.launch("gomel_stft_mel_log_pcm16", dev, pcm.data_ptr(),
                 0.0 if per_row else float(scale),
                 tensors[1].data_ptr() if per_row else None, n_in,
                 None if window is None else window.data_ptr(), tw.data_ptr(),
                 tw_pass.data_ptr(), slots.data_ptr(), weights.data_ptr(),
                 groups, out.data_ptr(), 2 * mels, rows, frames, hop, n,
                 *rfft_mag.fft_plan_args(n))
    FUSED_PCM16_KERNEL.launches += 1
    return out


def mel_encode(x_padded: torch.Tensor, num_mels: int, frame_len: int, hop: int,
               fwd_weights: torch.Tensor,
               window: torch.Tensor | None = None,
               fft_backend: str = "auto",
               frame_chunk: int | None = None, *,
               pcm_scale=32768.0) -> torch.Tensor:
    """Audio [..., L] -> log-mel [..., F, num_mels, 2].

    fwd_weights: [num_mels, N/2] filterbank matrix (core.filterbank.mel_weights).
    window: [frame_len] analysis window, Hann when None.
    fft_backend: the transform's route (ops/fftbackend.resolve); ``auto`` is
    KB on the card, or the xla route for a size KB does not take. Where
    :func:`fused_route` holds (and the signal is float32) one fused KB + KC
    launch runs instead of KB then KC, with the same bits; it raises if it
    fails, with no fallback to the two launches.
    frame_chunk: launch the kernels once per chunk of that many frames
    (ops/stft.map_frame_chunks); the frames are independent, so the result
    is the same.
    pcm_scale: an int16 ``x_padded`` is mono PCM-16 [L] or [B, L], each
    sample divided by ``pcm_scale`` (one divisor, or for [B, L] one per row,
    a [B] tensor or array; powers of two keep it exact) into ``window``'s
    float dtype (float32 without a tensor window). Where the fused launch
    runs, its int16 mode reads the samples itself
    (:func:`stft_mel_log_pcm16`); else kernel KA converts them first
    (ops/quantize.pcm16_ingest). The same bits either way.
    """
    if fwd_weights.shape[0] != num_mels:
        raise ValueError(f"fwd_weights has {fwd_weights.shape[0]} rows, "
                         f"num_mels={num_mels}")
    pcm = x_padded.dtype == torch.int16
    dtype = ((window.dtype if isinstance(window, torch.Tensor)
              else torch.float32) if pcm else x_padded.dtype)
    window = window_like(window, frame_len, x_padded.new_empty(0, dtype=dtype))
    fused = (fused_route(frame_len, fft_backend, x_padded.device.type)
             and dtype == torch.float32)
    if pcm and not fused:
        ingest = pcm16_ingest_batch if x_padded.ndim == 2 else pcm16_ingest
        x_padded = ingest(x_padded, dtype, pcm_scale)
        pcm = False
    if frame_chunk:
        return map_frame_chunks(
            x_padded, frame_len, hop, frame_chunk,
            lambda seg: mel_encode(seg, num_mels, frame_len, hop, fwd_weights,
                                   window, fft_backend, pcm_scale=pcm_scale))
    if pcm:
        return stft_mel_log_pcm16(x_padded, pcm_scale, 0, window, frame_len,
                                  hop, fwd_weights)
    if fused:
        return stft_mel_log(x_padded, window, frame_len, hop, fwd_weights)
    # [..., F, N/2+1]
    mags = stft_mag(x_padded, window, frame_len, hop, fft_backend)
    return _mel_from_mags(mags, fwd_weights)


def mel_encode_batch(xb: torch.Tensor, num_mels: int, frame_len: int, hop: int,
                     fwd_weights: torch.Tensor,
                     window: torch.Tensor | None = None,
                     fft_backend: str = "auto",
                     frame_chunk: int | None = None, *,
                     pcm_scale=32768.0) -> torch.Tensor:
    """Batched audio [B, L] -> log-mel [B, F, num_mels, 2]: one kernel launch
    each for the whole batch, or with ``frame_chunk`` one per chunk of that
    many frames; an int16 ``xb`` and its ``pcm_scale`` as in
    :func:`mel_encode`, the same bits."""
    if xb.ndim != 2:
        raise ValueError(f"mel_encode_batch takes [B, L] (got {tuple(xb.shape)})")
    return mel_encode(xb, num_mels, frame_len, hop, fwd_weights, window,
                      fft_backend, frame_chunk, pcm_scale=pcm_scale)


# id(inv_weights) -> (pinned weights, their version, (first, count, taps))
_BAND_CACHE: dict[int, tuple[torch.Tensor, int, tuple]] = {}


def _band_table(inv_weights: torch.Tensor):
    """U [N/2, M] -> memoized KI table on U's device: per bin the first mel
    of its non-zero run (int32 [N/2]), the run's length (int32 [N/2]) and
    its weights as float32 [N/2, max run], zero-padded. Runs are contiguous
    (core/filterbank.inverse_mel_weights fills one branch per bin)."""
    def make(u):
        dev = inv_weights.device
        return tuple(torch.from_numpy(t).to(dev) for t in mel_runs_np(u))
    return _memoized(_BAND_CACHE, inv_weights, make)


def mel_runs_np(u: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """KI's table of U [N/2, M] (see :func:`_band_table`) in numpy."""
    first, count = band_spans(u)
    t = np.arange(max(1, int(count.max())))
    idx = np.minimum(first[:, None] + t, u.shape[1] - 1)
    taps = np.where(t < count[:, None], np.take_along_axis(u, idx, axis=1),
                    0.0).astype(np.float32)
    return first.astype(np.int32), count.astype(np.int32), taps


def spectral_denormalize(x: torch.Tensor) -> torch.Tensor:
    """exp (reference: mel/impl.go:421-427)."""
    return torch.exp(x)


def mel_to_linear(logmel: torch.Tensor, inv_weights: torch.Tensor,
                  tune_mul: float = 1.0, tune_add: float = 0.0) -> torch.Tensor:
    """log-mel [..., F, num_mels, 2] -> linear 2-channel spectrum
    [..., F, N/2, 2]: exp -> ``undomel`` product with U [N/2, num_mels] ->
    (v - TuneAdd) / TuneMul when they are not (0, 1) (reference
    mel/mel.go:142-147, mel/impl.go:386-408). Plain PyTorch on any device
    (kernel KI runs it on the card, :func:`mel_to_magnitudes`)."""
    mel = spectral_denormalize(logmel)
    lin = torch.einsum("...mc,bm->...bc", mel, inv_weights.to(mel.dtype))
    if tune_add != 0.0 or tune_mul != 1.0:
        def scalar(v):
            return torch.full((), v, dtype=lin.dtype, device=lin.device)
        lin = (lin - scalar(tune_add)) / scalar(tune_mul)
    return lin


def mel_to_magnitudes_plain(src: torch.Tensor, inv_weights: torch.Tensor,
                            tune_mul: float = 1.0, tune_add: float = 0.0,
                            boost: float = 0.0, mgc_max=None, mgc_min=None,
                            max_val: int = 255) -> torch.Tensor:
    """Plain PyTorch version of KI: dequantize_mel_plane (uint8 ``src``),
    + ``boost`` when it is non-zero, mel_to_linear, griffin_lim_magnitudes."""
    logmel = src
    if src.dtype == torch.uint8:
        logmel = dequantize_mel_plane(src, mgc_max, mgc_min, max_val)
    if boost != 0.0:
        logmel = logmel + torch.full((), boost, dtype=logmel.dtype,
                                     device=logmel.device)
    return griffin_lim_magnitudes(mel_to_linear(logmel, inv_weights, tune_mul,
                                                tune_add))


def mel_to_magnitudes(src: torch.Tensor, inv_weights: torch.Tensor,
                      tune_mul: float = 1.0, tune_add: float = 0.0,
                      boost: float = 0.0, mgc_max=None, mgc_min=None,
                      max_val: int = 255) -> torch.Tensor:
    """The fixed Griffin-Lim magnitudes of a mel spectrogram: mag_half
    [..., F, N/2 + 1] float, from float log-mel [..., F, M, 2] or from uint8
    PNG planes [..., M, F, 2] with their global extrema ``mgc_max``,
    ``mgc_min`` [...] (dequantized first, in float32). ``boost`` is added in
    the log domain (the VolumeBoost of gomel_tpu/pipelines/mel.py:152-154);
    ``inv_weights`` is U [N/2, M]."""
    quantized = src.dtype == torch.uint8
    mels = src.shape[-3] if quantized else src.shape[-2]
    if src.ndim < 3 or src.shape[-1] != 2 or inv_weights.shape[1] != mels:
        raise ValueError(f"mel_to_magnitudes: source {tuple(src.shape)} does "
                         f"not match U {tuple(inv_weights.shape)}")
    if quantized and (mgc_max is None or mgc_min is None):
        raise ValueError("mel_to_magnitudes: uint8 planes need mgc_max and "
                         "mgc_min")
    if src.device.type == "cpu":
        return mel_to_magnitudes_plain(src, inv_weights, tune_mul, tune_add,
                                       boost, mgc_max, mgc_min, max_val)
    mx = mn = None
    if quantized:
        f32 = torch.float32
        mx = torch.as_tensor(mgc_max, dtype=f32, device=src.device)
        mn = torch.as_tensor(mgc_min, dtype=f32, device=src.device)
        mx, mn = mx.reshape(-1).contiguous(), mn.reshape(-1).contiguous()
    first, count, taps = _band_table(inv_weights)
    return launch_mel_to_mag(src, mx, mn, first.to(src.device),
                             count.to(src.device), taps.to(src.device),
                             max_val, boost, tune_mul, tune_add)


def launch_mel_to_mag(src: torch.Tensor, mx: torch.Tensor | None,
                      mn: torch.Tensor | None, first: torch.Tensor,
                      count: torch.Tensor, taps: torch.Tensor, max_val: int,
                      boost: float, tune_mul: float,
                      tune_add: float) -> torch.Tensor:
    """Launch KI on CUDA uint8 planes with their extrema [rows], or on
    float32 log-mel (``mx``, ``mn`` None), with the KI table of U on that
    device (:func:`_band_table`: first [N/2], count [N/2], taps)."""
    quantized = mx is not None
    if quantized:
        *lead, mels, frames, _ = src.shape
        dev = _cuda.check_cuda("mel_to_magnitudes", src, mx, mn)
        if not 0 < max_val <= 255:
            raise ValueError(f"mel_to_magnitudes: max_val {max_val} exceeds "
                             f"uint8")
    else:
        *lead, frames, mels, _ = src.shape
        dev = _cuda.check_cuda("mel_to_magnitudes", src)
        if src.dtype != torch.float32:
            raise ValueError("mel_to_magnitudes: the CUDA kernel takes "
                             "float32 or uint8")
    batch = int(np.prod(lead, dtype=np.int64))
    if quantized and mx.numel() != batch:
        raise ValueError(f"mel_to_magnitudes: {mx.numel()} extrema for "
                         f"{batch} rows")
    bins = first.shape[0]
    out = torch.empty(tuple(lead) + (frames, bins + 1), dtype=torch.float32,
                      device=dev)
    if batch * frames == 0:
        return out
    _cuda.launch("gomel_mel_to_mag", dev, int(quantized), src.data_ptr(),
                 None if mx is None else mx.data_ptr(),
                 None if mn is None else mn.data_ptr(), first.data_ptr(),
                 count.data_ptr(), taps.data_ptr(), out.data_ptr(), batch,
                 frames, mels, bins, taps.shape[1], float(max_val),
                 float(boost), float(tune_mul), float(tune_add))
    MAG_KERNEL.launches += 1
    return out


def mel_decode(logmel: torch.Tensor, frame_len: int, hop: int,
               inv_weights: torch.Tensor, n_iter: int,
               key: np.ndarray | None = None,
               tune_mul: float = 1.0, tune_add: float = 0.0,
               window: torch.Tensor | None = None, fft_backend: str = "auto",
               momentum: float = 0.0, *, init=None) -> torch.Tensor:
    """log-mel [..., F, num_mels, 2] -> audio [..., N + (F-1)*hop] via
    Griffin-Lim (reference mel/mel.go:142-152), with the un-normalised
    overlap-add amplitude of the reference. The initial signal is drawn from
    ``key`` (ops/prng.key; ops/griffinlim.griffin_lim) unless ``init`` is given;
    ``fft_backend`` as in ops/griffinlim.griffin_lim; ``momentum`` > 0 opts
    into fast Griffin-Lim."""
    if 2 * inv_weights.shape[0] != frame_len:
        raise ValueError(f"inv_weights has {inv_weights.shape[0]} rows, "
                         f"frame_len={frame_len} needs {frame_len // 2}")
    mag = mel_to_magnitudes(logmel.contiguous(), inv_weights, tune_mul,
                            tune_add)
    return griffin_lim(mag, hop, n_iter, key, window, init, fft_backend,
                       momentum)
