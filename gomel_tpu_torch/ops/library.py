"""The hand-written kernels of the serving paths as ``torch.library`` custom
ops, so that ``torch.export`` can trace a codec into an artifact
(gomel_tpu_torch/serving.py).

The kernels' wrappers launch through ``ctypes`` with raw device pointers
and build host tables from tensor values, which neither tracing nor fake
tensors can follow. Each op here is one launch site, in the
``gomel_tpu_torch`` namespace, with two kernels and a fake:

- the ``cuda`` kernel is the wrapper's launch code (the ``launch_*``
  functions of ops/*.py): it checks its tensors, owns its scratch (KD's and
  KF's partials and tickets, the stream, the pointers) and adds one to its
  kernel's launch tally, as the eager wrapper does;
- the ``cpu`` kernel is the kernel's plain PyTorch version;
- the fake gives the outputs' shapes and dtypes from the inputs' shapes and
  the static arguments, so a symbolic batch traces.

Neither kernel falls back to the other: the dispatcher picks one by the
tensors' device, and a failed build or launch raises. Every table an op
reads is a tensor argument (FFT twiddles, band tables, W_ext, KI's band
runs, the window's prefix rows, key tables), which an exported module holds
as buffers: its baked constants. Plans that depend only on static sizes
(radices, threads and frames a block of the FFT kernels; the window-sum
threshold of a fixed frame count) are plain numbers in the schema.

| op | kernel | launch symbol |
|---|---|---|
| ``stft_mel_log`` | fused KB + KC | ``gomel_stft_mel_log`` |
| ``stft_mag`` | KB | ``gomel_stft_mag`` |
| ``mel_log`` | KC | ``gomel_mel_log`` |
| ``quantize_mel`` | KD | ``gomel_quantize_mel(_parts)`` |
| ``stft_planes`` | KE | ``gomel_stft_planes`` |
| ``quantize_planes`` | KF | ``gomel_quantize_planes(_parts)`` |
| ``irfft_window`` | KG | ``gomel_irfft_window`` |
| ``overlap_normalize`` | KH | ``gomel_overlap_normalize`` |
| ``mel_to_mag`` | KI | ``gomel_mel_to_mag`` |
| ``gl_project`` | KJ | ``gomel_gl_project`` |
| ``gl_overlap_add`` | KK | ``gomel_gl_overlap_add`` |
| ``shard_epilogue`` | KM | ``gomel_shard_epilogue`` |
| ``threefry_uniform`` | KP | ``gomel_threefry_uniform`` |
| ``dft_fwd``, ``dft_inv`` | KN, KO | ``gomel_dft_fwd``, ``gomel_dft_inv`` |

Ops with two results return a pair; where a mode has one result the second
is an empty tensor. Importing this module registers the ops; it builds and
loads nothing.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from . import (_cuda, dft_mm, griffinlim, istft, mel_ops, phase_ops, prng,
               quantize, rfft_mag)
from .stft import num_frames_of

NS = "gomel_tpu_torch"


def _empty(like: Tensor) -> Tensor:
    """The second result of a one-result mode."""
    return like.new_empty((0,))


def _dense(out):
    """A plain version's result as the fake lays it out: contiguous (a
    plain version may return a transposed view)."""
    if isinstance(out, tuple):
        return tuple(t.contiguous() for t in out)
    return out.contiguous()


def _unreachable_msg(name: str, *tensors: Tensor) -> str:
    return (f"{NS}::{name} has kernels for cuda and cpu tensors only (got "
            f"{sorted({str(t.device) for t in tensors})})")


# -- fused KB + KC, KB, KC: the mel encode -----------------------------------

@torch.library.custom_op(f"{NS}::stft_mel_log", mutates_args=())
def stft_mel_log(x: Tensor, window: Tensor, ext_weights: Tensor,
                 twiddles: Tensor, tw_pass: Tensor, slots: Tensor,
                 band_weights: Tensor, n: int, hop: int, mels: int,
                 groups: int, radices: int, threads: int,
                 frames_per_block: int) -> Tensor:
    """Log-mel [..., F, mels, 2] of the windowed hop-spaced frames of ``x``
    [..., L]: the fused KB + KC launch (n/2 a power of two) on the band
    table (``slots``, ``band_weights``, ``groups``); the plain version takes
    W_ext (``ext_weights``)."""
    raise NotImplementedError(_unreachable_msg("stft_mel_log", x))


@stft_mel_log.register_kernel("cpu")
def _(x, window, ext_weights, twiddles, tw_pass, slots, band_weights, n, hop,
      mels, groups, radices, threads, frames_per_block):
    return _dense(mel_ops.mel_from_ext_plain(
        rfft_mag.stft_mag_plain(x, window, n, hop), ext_weights))


@stft_mel_log.register_kernel("cuda")
def _(x, window, ext_weights, twiddles, tw_pass, slots, band_weights, n, hop,
      mels, groups, radices, threads, frames_per_block):
    rfft_mag._check("stft_mel_log", x, window, n)
    _cuda.check_cuda("stft_mel_log", x, twiddles, tw_pass)
    return mel_ops.launch_stft_mel_log(
        x, window, twiddles, tw_pass, (radices, threads, frames_per_block),
        slots, band_weights, groups, mels, n, hop)


def _frames_shape(x: Tensor, n: int, hop: int) -> tuple:
    return (*x.shape[:-1], num_frames_of(x.shape[-1], n, hop))


@stft_mel_log.register_fake
def _(x, window, ext_weights, twiddles, tw_pass, slots, band_weights, n, hop,
      mels, groups, radices, threads, frames_per_block):
    return x.new_empty(_frames_shape(x, n, hop) + (mels, 2))


@torch.library.custom_op(f"{NS}::stft_mag", mutates_args=())
def stft_mag(x: Tensor, window: Tensor, twiddles: Tensor, tw_pass: Tensor,
             n: int, hop: int, radices: int, threads: int,
             frames_per_block: int) -> Tensor:
    """|rfft_n| [..., F, n/2 + 1] of the windowed hop-spaced frames of
    ``x`` [..., L]: KB."""
    raise NotImplementedError(_unreachable_msg("stft_mag", x))


@stft_mag.register_kernel("cpu")
def _(x, window, twiddles, tw_pass, n, hop, radices, threads,
      frames_per_block):
    return _dense(rfft_mag.stft_mag_plain(x, window, n, hop))


@stft_mag.register_kernel("cuda")
def _(x, window, twiddles, tw_pass, n, hop, radices, threads,
      frames_per_block):
    rfft_mag._check("stft_mag", x, window, n)
    _cuda.check_cuda("stft_mag", x, twiddles, tw_pass)
    return rfft_mag.launch_stft_mag(x, window, twiddles, tw_pass,
                                    (radices, threads, frames_per_block), n,
                                    hop)


@stft_mag.register_fake
def _(x, window, twiddles, tw_pass, n, hop, radices, threads,
      frames_per_block):
    return x.new_empty(_frames_shape(x, n, hop) + (n // 2 + 1,))


@torch.library.custom_op(f"{NS}::mel_log", mutates_args=())
def mel_log(mags: Tensor, ext_weights: Tensor, slots: Tensor,
            band_weights: Tensor, mels: int, groups: int) -> Tensor:
    """|rfft| [..., N/2 + 1] -> log-mel [..., mels, 2]: KC on the band
    table; the plain version takes W_ext."""
    raise NotImplementedError(_unreachable_msg("mel_log", mags))


@mel_log.register_kernel("cpu")
def _(mags, ext_weights, slots, band_weights, mels, groups):
    return _dense(mel_ops.mel_from_ext_plain(mags, ext_weights))


@mel_log.register_kernel("cuda")
def _(mags, ext_weights, slots, band_weights, mels, groups):
    return mel_ops.launch_mel_log(mags, slots, band_weights, groups, mels)


@mel_log.register_fake
def _(mags, ext_weights, slots, band_weights, mels, groups):
    return mags.new_empty((*mags.shape[:-1], mels, 2))


@torch.library.custom_op(f"{NS}::quantize_mel", mutates_args=())
def quantize_mel(spec2: Tensor, max_val: int
                 ) -> tuple[Tensor, Tensor, Tensor]:
    """Log-mel [B, F, M, 2] -> (planes uint8 [B, M, F, 2], max [B],
    min [B]), one global max and min a row: KD."""
    raise NotImplementedError(_unreachable_msg("quantize_mel", spec2))


@quantize_mel.register_kernel("cpu")
def _(spec2, max_val):
    return _dense(quantize.quantize_mel_plane_plain(spec2, max_val))


@quantize_mel.register_kernel("cuda")
def _(spec2, max_val):
    return quantize.launch_quantize_mel(spec2, max_val, batched=True)


@quantize_mel.register_fake
def _(spec2, max_val):
    b, f, m, _ = spec2.shape
    return (spec2.new_empty((b, m, f, 2), dtype=torch.uint8),
            spec2.new_empty((b,)), spec2.new_empty((b,)))


# -- KE, KF: the phase encode ------------------------------------------------

@torch.library.custom_op(f"{NS}::stft_planes", mutates_args=())
def stft_planes(x: Tensor, window: Tensor, twiddles: Tensor, tw_pass: Tensor,
                n: int, hop: int, first: int, count: int, radices: int,
                threads: int, frames_per_block: int) -> Tensor:
    """(imag, real) of rfft_n bins first .. first + count - 1 of the
    windowed hop-spaced frames of ``x`` [..., L] -> [..., F, count, 2]:
    KE."""
    raise NotImplementedError(_unreachable_msg("stft_planes", x))


@stft_planes.register_kernel("cpu")
def _(x, window, twiddles, tw_pass, n, hop, first, count, radices, threads,
      frames_per_block):
    return _dense(rfft_mag.stft_planes_plain(x, window, n, hop, first,
                                             count))


@stft_planes.register_kernel("cuda")
def _(x, window, twiddles, tw_pass, n, hop, first, count, radices, threads,
      frames_per_block):
    rfft_mag._check("stft_planes", x, window, n)
    _cuda.check_cuda("stft_planes", x, twiddles, tw_pass)
    return rfft_mag.launch_stft_planes(x, window, twiddles, tw_pass,
                                       (radices, threads, frames_per_block),
                                       n, hop, first, count)


@stft_planes.register_fake
def _(x, window, twiddles, tw_pass, n, hop, first, count, radices, threads,
      frames_per_block):
    return x.new_empty(_frames_shape(x, n, hop) + (count, 2))


@torch.library.custom_op(f"{NS}::quantize_planes", mutates_args=())
def quantize_planes(spec2: Tensor, max_val: int, ihs_passes: int
                    ) -> tuple[Tensor, Tensor, Tensor]:
    """Phase spectrogram [B, F, nf, 2] -> (planes uint8 or uint16
    [B, nf, F, 2], maxs [B, 2], mins [B, 2]), per-channel extrema after
    ``ihs_passes`` asinh passes: KF."""
    raise NotImplementedError(_unreachable_msg("quantize_planes", spec2))


@quantize_planes.register_kernel("cpu")
def _(spec2, max_val, ihs_passes):
    return _dense(quantize.quantize_planes_plain(spec2, max_val,
                                                 ihs_passes))


@quantize_planes.register_kernel("cuda")
def _(spec2, max_val, ihs_passes):
    return quantize.launch_quantize_planes(spec2, max_val, ihs_passes,
                                           batched=True)


@quantize_planes.register_fake
def _(spec2, max_val, ihs_passes):
    b, f, nf, _ = spec2.shape
    dtype = torch.uint16 if max_val > 255 else torch.uint8
    return (spec2.new_empty((b, nf, f, 2), dtype=dtype),
            spec2.new_empty((b, 2)), spec2.new_empty((b, 2)))


# -- KG, KH: the phase decode ------------------------------------------------

def _synth_layout(mode: int, src: Tensor, n: int) -> tuple[tuple, int, int]:
    """(lead, frames, nf) of KG's source in ``mode``."""
    if mode == istft.MODE_PLANES:
        return tuple(src.shape[:-2]), src.shape[-2], n // 2 + 1
    if mode == istft.MODE_SPEC:
        return tuple(src.shape[:-3]), src.shape[-3], src.shape[-2]
    return tuple(src.shape[:-3]), src.shape[-2], src.shape[-3]


@torch.library.custom_op(f"{NS}::irfft_window", mutates_args=())
def irfft_window(mode: int, src: Tensor, aux0: Optional[Tensor],
                 aux1: Optional[Tensor], window: Tensor, twiddles: Tensor,
                 tw_pass: Tensor, n: int, max_val: float, ihs_passes: int,
                 real_frames: int, radices: int, threads: int,
                 frames_per_block: int) -> Tensor:
    """irfft_n x window of each frame -> [..., F, n] (frames at or past
    ``real_frames`` zeros; -1: none): KG. ``mode`` (ops/istft.MODE_*): re
    planes [..., F, n/2 + 1] with im planes ``aux0``; a phase spectrogram
    [..., F, nf, 2] (grown); integer planes [..., nf, F, 2] with their
    extrema ``aux0``, ``aux1`` [..., 2] (dequantized, ``ihs_passes`` sinh,
    grown)."""
    raise NotImplementedError(_unreachable_msg("irfft_window", src))


@irfft_window.register_kernel("cpu")
def _(mode, src, aux0, aux1, window, twiddles, tw_pass, n, max_val,
      ihs_passes, real_frames, radices, threads, frames_per_block):
    rf = None if real_frames < 0 else real_frames
    if mode == istft.MODE_PLANES:
        re, im = src, aux0
    else:
        if mode != istft.MODE_SPEC:
            src = quantize.dequantize_planes(src, aux0, aux1, max_val,
                                             ihs_passes)
        re, im = phase_ops.grow_half_planes(src, n // 2)
    return _dense(istft.irfft_window_plain(re, im, n, window, rf))


@irfft_window.register_kernel("cuda")
def _(mode, src, aux0, aux1, window, twiddles, tw_pass, n, max_val,
      ihs_passes, real_frames, radices, threads, frames_per_block):
    lead, frames, nf = _synth_layout(mode, src, n)
    aux = tuple(t for t in (aux0, aux1) if t is not None)
    _cuda.check_cuda("irfft_window", src, twiddles, tw_pass)
    return istft.launch_irfft_window(
        mode, src, aux, n, frames, nf, window, lead, max_val, ihs_passes,
        None if real_frames < 0 else real_frames,
        fft=(twiddles, tw_pass, (radices, threads, frames_per_block)))


@irfft_window.register_fake
def _(mode, src, aux0, aux1, window, twiddles, tw_pass, n, max_val,
      ihs_passes, real_frames, radices, threads, frames_per_block):
    lead, frames, _ = _synth_layout(mode, src, n)
    quantized = mode in (istft.MODE_QUANT8, istft.MODE_QUANT16)
    return src.new_empty(lead + (frames, n),
                         dtype=torch.float32 if quantized else src.dtype)


@torch.library.custom_op(f"{NS}::overlap_normalize", mutates_args=())
def overlap_normalize(frames_w: Tensor, table: Optional[Tensor],
                      window: Optional[Tensor], hop: int, threshold: float,
                      short: bool, volume_boost: float, pcm16: bool
                      ) -> tuple[Tensor, Tensor]:
    """Windowed frames [..., F, N] -> overlap-add [..., N + (F-1) hop]: KH.
    With the window's prefix rows ``table`` (KH) and the ``window`` (the
    plain version), divided by the window sum under ``threshold`` (and
    ``short``, ops/istft.window_sum_short), times ``volume_boost`` when it
    is non-zero; ``pcm16``: (int16 PCM, per-row finite flags), else (the
    signal, an empty tensor)."""
    raise NotImplementedError(_unreachable_msg("overlap_normalize",
                                               frames_w))


@overlap_normalize.register_kernel("cpu")
def _(frames_w, table, window, hop, threshold, short, volume_boost, pcm16):
    if window is None:
        return _dense(istft.overlap_add_plain(frames_w, hop)), _empty(frames_w)
    out = istft.overlap_normalize_plain(frames_w, hop, window, volume_boost,
                                        pcm16)
    return _dense(out if pcm16 else (out, _empty(frames_w)))


@overlap_normalize.register_kernel("cuda")
def _(frames_w, table, window, hop, threshold, short, volume_boost, pcm16):
    frames_w = frames_w.contiguous()
    if table is not None:
        _cuda.check_cuda("overlap_normalize", frames_w, table)
    out = istft.launch_ola(frames_w, hop, table, threshold, short,
                           volume_boost, pcm16)
    return out if pcm16 else (out, _empty(frames_w))


@overlap_normalize.register_fake
def _(frames_w, table, window, hop, threshold, short, volume_boost, pcm16):
    *lead, frames, n = frames_w.shape
    shape = (*lead, n + (frames - 1) * hop)
    if pcm16:
        return (frames_w.new_empty(shape, dtype=torch.int16),
                frames_w.new_empty(tuple(lead), dtype=torch.bool))
    return frames_w.new_empty(shape), _empty(frames_w)


# -- KI, KJ, KK, KP: the mel decode ------------------------------------------

@torch.library.custom_op(f"{NS}::mel_to_mag", mutates_args=())
def mel_to_mag(src: Tensor, mgc_max: Optional[Tensor],
               mgc_min: Optional[Tensor], inv_weights: Tensor, first: Tensor,
               count: Tensor, taps: Tensor, max_val: int, boost: float,
               tune_mul: float, tune_add: float) -> Tensor:
    """The fixed Griffin-Lim magnitudes [..., F, N/2 + 1] of float log-mel
    [..., F, M, 2], or of uint8 planes [..., M, F, 2] with their extrema
    [...]: KI on its band runs (``first``, ``count``, ``taps``); the plain
    version takes U (``inv_weights``)."""
    raise NotImplementedError(_unreachable_msg("mel_to_mag", src))


@mel_to_mag.register_kernel("cpu")
def _(src, mgc_max, mgc_min, inv_weights, first, count, taps, max_val, boost,
      tune_mul, tune_add):
    return _dense(mel_ops.mel_to_magnitudes_plain(
        src, inv_weights, tune_mul, tune_add, boost, mgc_max, mgc_min,
        max_val))


@mel_to_mag.register_kernel("cuda")
def _(src, mgc_max, mgc_min, inv_weights, first, count, taps, max_val, boost,
      tune_mul, tune_add):
    _cuda.check_cuda("mel_to_mag", src, first, count, taps)
    mx = mn = None
    if src.dtype == torch.uint8:
        mx = mgc_max.reshape(-1).contiguous()
        mn = mgc_min.reshape(-1).contiguous()
    return mel_ops.launch_mel_to_mag(src, mx, mn, first, count, taps,
                                     max_val, boost, tune_mul, tune_add)


@mel_to_mag.register_fake
def _(src, mgc_max, mgc_min, inv_weights, first, count, taps, max_val, boost,
      tune_mul, tune_add):
    bins = inv_weights.shape[0] + 1
    if src.dtype == torch.uint8:
        return src.new_empty((*src.shape[:-3], src.shape[-2], bins),
                             dtype=torch.float32)
    return src.new_empty((*src.shape[:-2], bins))


@torch.library.custom_op(f"{NS}::gl_project", mutates_args=())
def gl_project(sig: Tensor, mag_half: Tensor, window: Tensor,
               twiddles: Tensor, tw_pass: Tensor, n: int, hop: int,
               radices: int, threads: int, frames_per_block: int) -> Tensor:
    """One Griffin-Lim projection up to the overlap-add: signal
    [..., N + (F-1) hop] and magnitudes [..., F, n/2 + 1] -> windowed frames
    [..., F, n]: KJ."""
    raise NotImplementedError(_unreachable_msg("gl_project", sig))


@gl_project.register_kernel("cpu")
def _(sig, mag_half, window, twiddles, tw_pass, n, hop, radices, threads,
      frames_per_block):
    return _dense(griffinlim.gl_project_plain(sig, mag_half, window, n, hop))


@gl_project.register_kernel("cuda")
def _(sig, mag_half, window, twiddles, tw_pass, n, hop, radices, threads,
      frames_per_block):
    sig, mag_half, window = (t.contiguous() for t in (sig, mag_half, window))
    _cuda.check_cuda("gl_project", sig, mag_half, window, twiddles,
                     tw_pass)
    if any(t.dtype != torch.float32 for t in (sig, mag_half, window)):
        raise ValueError("gl_project: the CUDA kernel takes float32 tensors")
    return griffinlim.launch_gl_project(sig, mag_half, window, twiddles,
                                        tw_pass,
                                        (radices, threads, frames_per_block),
                                        n, hop)


@gl_project.register_fake
def _(sig, mag_half, window, twiddles, tw_pass, n, hop, radices, threads,
      frames_per_block):
    return mag_half.new_empty((*mag_half.shape[:-1], n), dtype=sig.dtype)


@torch.library.custom_op(f"{NS}::gl_overlap_add", mutates_args=())
def gl_overlap_add(frames_w: Tensor, t_prev: Optional[Tensor], hop: int,
                   momentum: float, pcm16: bool) -> tuple[Tensor, Tensor]:
    """Overlap-add of windowed frames [..., F, N] with no normalisation:
    KK. With ``t_prev``: the momentum step (c, t); with ``pcm16``: (int16
    PCM, per-row finite flags); else (t, an empty tensor)."""
    raise NotImplementedError(_unreachable_msg("gl_overlap_add", frames_w))


@gl_overlap_add.register_kernel("cpu")
def _(frames_w, t_prev, hop, momentum, pcm16):
    out = griffinlim.gl_overlap_add_plain(frames_w, hop, t_prev, momentum,
                                          pcm16)
    return _dense(out if isinstance(out, tuple) else (out, _empty(frames_w)))


@gl_overlap_add.register_kernel("cuda")
def _(frames_w, t_prev, hop, momentum, pcm16):
    out = griffinlim.launch_gl_overlap_add(frames_w, hop, t_prev, momentum,
                                           pcm16)
    return out if isinstance(out, tuple) else (out, _empty(frames_w))


@gl_overlap_add.register_fake
def _(frames_w, t_prev, hop, momentum, pcm16):
    *lead, frames, n = frames_w.shape
    shape = (*lead, n + (frames - 1) * hop)
    if pcm16:
        return (frames_w.new_empty(shape, dtype=torch.int16),
                frames_w.new_empty(tuple(lead), dtype=torch.bool))
    if t_prev is not None:
        return frames_w.new_empty(shape), frames_w.new_empty(shape)
    return frames_w.new_empty(shape), _empty(frames_w)


@torch.library.custom_op(f"{NS}::threefry_uniform", mutates_args=())
def threefry_uniform(keys: Tensor, per_key: int,
                     dtype: torch.dtype) -> Tensor:
    """Uniform [0, 1) samples, ``jax.random.uniform``'s bits: int32 key
    words [R, 2] (uint32 bits) -> [R, per_key], row r from key r: KP."""
    raise NotImplementedError(_unreachable_msg("threefry_uniform", keys))


@threefry_uniform.register_kernel("cpu")
def _(keys, per_key, dtype):
    return _dense(prng.uniform_table_plain(keys, per_key, dtype))


@threefry_uniform.register_kernel("cuda")
def _(keys, per_key, dtype):
    keys = keys.contiguous()
    _cuda.check_cuda("uniform", keys)
    if dtype != torch.float32 or keys.dtype != torch.int32:
        raise ValueError("uniform: the CUDA kernel draws float32 from int32 "
                         "key words")
    return prng.launch_uniform(keys, per_key)


@threefry_uniform.register_fake
def _(keys, per_key, dtype):
    return keys.new_empty((keys.shape[0], per_key), dtype=dtype)


# -- KM: the long-form synthesis's shard epilogue ----------------------------

@torch.library.custom_op(f"{NS}::shard_epilogue", mutates_args=())
def shard_epilogue(sig_ext: Tensor, recv: Optional[Tensor],
                   table: Optional[Tensor], t_prev: Optional[Tensor],
                   chunk: int, hop: int, start: int, n_frames: int,
                   threshold: float, volume_boost: float, momentum: float,
                   pcm16: bool) -> tuple[Tensor, Tensor]:
    """A frame shard's overlap-add [B, chunk + halo] plus its left
    neighbour's tail ``recv`` [B, halo] -> its [B, chunk] samples: KM (see
    ops/istft.shard_epilogue). With the window's prefix rows ``table``:
    the global normalisation under ``threshold``; with ``t_prev``: the
    momentum step (c, t); ``pcm16``: (int16, per-row finite flags); else
    (the samples, an empty tensor). (The wrapper's ``extend`` buffer, whose
    halo columns the caller fills, is not a mode of the op: its results are
    whole tensors.)"""
    raise NotImplementedError(_unreachable_msg("shard_epilogue", sig_ext))


def _epilogue_args(hop, start, n_frames, volume_boost, t_prev, momentum,
                   pcm16) -> dict:
    return dict(hop=hop, start=start, n_frames=n_frames,
                volume_boost=volume_boost, t_prev=t_prev, momentum=momentum,
                pcm16=pcm16)


@shard_epilogue.register_kernel("cpu")
def _(sig_ext, recv, table, t_prev, chunk, hop, start, n_frames, threshold,
      volume_boost, momentum, pcm16):
    istft.check_shard_epilogue(sig_ext, recv, chunk, table is not None, hop,
                               start, n_frames, t_prev, pcm16)
    out = istft.shard_epilogue_table_plain(
        sig_ext, recv, chunk, table, threshold,
        **_epilogue_args(hop, start, n_frames, volume_boost, t_prev,
                         momentum, pcm16))
    return _dense(out if isinstance(out, tuple) else (out, _empty(sig_ext)))


@shard_epilogue.register_kernel("cuda")
def _(sig_ext, recv, table, t_prev, chunk, hop, start, n_frames, threshold,
      volume_boost, momentum, pcm16):
    istft.check_shard_epilogue(sig_ext, recv, chunk, table is not None, hop,
                               start, n_frames, t_prev, pcm16)
    if table is not None:
        _cuda.check_cuda("shard_epilogue", sig_ext.contiguous(), table)
    out = istft.launch_shard_epilogue(
        sig_ext, recv, chunk, table, threshold,
        **_epilogue_args(hop, start, n_frames, volume_boost, t_prev,
                         momentum, pcm16))
    return out if isinstance(out, tuple) else (out, _empty(sig_ext))


@shard_epilogue.register_fake
def _(sig_ext, recv, table, t_prev, chunk, hop, start, n_frames, threshold,
      volume_boost, momentum, pcm16):
    b = sig_ext.shape[0]
    if pcm16:
        return (sig_ext.new_empty((b, chunk), dtype=torch.int16),
                sig_ext.new_empty((b,), dtype=torch.bool))
    out = sig_ext.new_empty((b, chunk))
    if t_prev is not None:
        return out, sig_ext.new_empty((b, chunk))
    return out, _empty(sig_ext)


# -- KN, KO: the DFT as one product (the "mm" route) --------------------------

DFT_KINDS = ("planes", "mag", "pairs", "project")   # dft_fwd's ``kind``
# (data_ptr, shape, dtype, device) -> (weights, their KernelWeights): the
# TMA tensor map of a kernel layout, built at its first launch; the entry
# holds the weights, so their memory is not reused while it lives
_TMAPS: dict[tuple, tuple] = {}
_TMAPS_MAX = 8


def _kernel_weights(w: Tensor) -> dft_mm.KernelWeights:
    _cuda.check_cuda("dft_mm", w)
    key = (w.data_ptr(), tuple(w.shape), w.dtype, w.device)
    entry = _TMAPS.get(key)
    if entry is None:
        if len(_TMAPS) >= _TMAPS_MAX:
            _TMAPS.clear()
        entry = _TMAPS[key] = (w, dft_mm.kernel_weights(w))
    return entry[1]


def _require(name: str, t: Optional[Tensor], what: str) -> Tensor:
    if t is None:
        raise ValueError(f"{NS}::{name}: no {what} (an artifact built for "
                         f"the other device)")
    return t


@torch.library.custom_op(f"{NS}::dft_fwd", mutates_args=())
def dft_fwd(x: Tensor, mag: Optional[Tensor], w_plain: Optional[Tensor],
            w_kernel: Optional[Tensor], n: int, hop: int, kind: int,
            first: int, count: int, bf16: bool, final: bool
            ) -> tuple[Tensor, Tensor]:
    """The windowed hop-spaced frames of ``x`` [..., L] times the forward
    DFT weights: KN with the kernels' layout ``w_kernel`` (bf16 operands
    when ``bf16``), the plain version with the master ``w_plain`` [n,
    2(n/2+1)]. ``kind`` (DFT_KINDS): (re, im) planes; magnitudes; (imag,
    real) pairs of bins first .. first + count - 1; the Griffin-Lim
    projection with ``mag``. One-result kinds pair with an empty tensor.
    The bf16 projection (``final`` False) returns bf16 planes in rows
    padded to dft_mm.LOW_ALIGN bins."""
    raise NotImplementedError(_unreachable_msg("dft_fwd", x))


@dft_fwd.register_kernel("cpu")
def _(x, mag, w_plain, w_kernel, n, hop, kind, first, count, bf16, final):
    out = dft_mm.dft_fwd_weights_plain(
        x, _require("dft_fwd", w_plain, "plain weights"), n, hop,
        kind=DFT_KINDS[kind], mag=mag, first=first, count=count)
    return _dense(out if isinstance(out, tuple) else (out, _empty(x)))


@dft_fwd.register_kernel("cuda")
def _(x, mag, w_plain, w_kernel, n, hop, kind, first, count, bf16, final):
    wt = _kernel_weights(_require("dft_fwd", w_kernel, "kernel weights"))
    dft_mm._check_n(n)
    out = dft_mm.launch_fwd(x.contiguous(), wt, n, hop, bf16,
                            DFT_KINDS[kind],
                            None if mag is None else mag.contiguous(), first,
                            count, final, padded=True)
    return out if isinstance(out, tuple) else (out, _empty(x))


@dft_fwd.register_fake
def _(x, mag, w_plain, w_kernel, n, hop, kind, first, count, bf16, final):
    shape = _frames_shape(x, n, hop)
    half = n // 2 + 1
    name = DFT_KINDS[kind]
    if name == "mag":
        return x.new_empty(shape + (half,)), _empty(x)
    if name == "pairs":
        return x.new_empty(shape + (count, 2)), _empty(x)
    if (name == "project" and bf16 and not final
            and x.device.type == "cuda"):
        ld = -(-half // dft_mm.LOW_ALIGN) * dft_mm.LOW_ALIGN
        return tuple(x.new_empty(shape + (ld,), dtype=torch.bfloat16)
                     for _ in range(2))
    return x.new_empty(shape + (half,)), x.new_empty(shape + (half,))


@torch.library.custom_op(f"{NS}::dft_inv", mutates_args=())
def dft_inv(re: Tensor, im: Tensor, w_plain: Optional[Tensor],
            w_kernel: Optional[Tensor], n: int, bf16: bool,
            real_frames: int) -> Tensor:
    """Half-spectrum planes [..., F, n/2 + 1] (float32, or bf16 in the bf16
    mode; rows any stride apart) times the inverse DFT weights -> frames
    [..., F, n], those at or past ``real_frames`` zeros (-1: none): KO with
    ``w_kernel``, the plain version with the master ``w_plain``."""
    raise NotImplementedError(_unreachable_msg("dft_inv", re))


@dft_inv.register_kernel("cpu")
def _(re, im, w_plain, w_kernel, n, bf16, real_frames):
    return _dense(dft_mm.dft_inv_weights_plain(
        re, im, _require("dft_inv", w_plain, "plain weights"),
        real_frames=None if real_frames < 0 else real_frames))


@dft_inv.register_kernel("cuda")
def _(re, im, w_plain, w_kernel, n, bf16, real_frames):
    wt = _kernel_weights(_require("dft_inv", w_kernel, "kernel weights"))
    dft_mm._check_n(n)
    return dft_mm.launch_inv(re, im, wt, n, bf16,
                             None if real_frames < 0 else real_frames)


@dft_inv.register_fake
def _(re, im, w_plain, w_kernel, n, bf16, real_frames):
    dtype = torch.float32 if re.dtype == torch.bfloat16 else re.dtype
    return re.new_empty((*re.shape[:-1], n), dtype=dtype)
