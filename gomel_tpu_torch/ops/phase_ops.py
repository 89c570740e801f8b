"""Phase-preserving spectrogram codec: device ops.

Counterpart of ``gomel_tpu/ops/phase_ops.py`` (reference phase/phase.go:41-153,
shrink/grow phase/impl.go:383-403). For a real frame the reference's stored
channel pair per bin j is ``[imag(S[j+1]), real(S[j+1])]``: exactly the rfft
bins 1..N/2, so encode and decode both run in rfft space.

On a CUDA tensor the encode is kernel KE (ops/rfft_mag.stft_planes) and the
decode is kernel KG, which dequantizes (for PNG planes), grows and inverts
each frame, then kernel KH, which overlap-adds, normalises and, for the file
path, converts to PCM-16 (ops/istft.py). On a CPU tensor each runs its plain
PyTorch version: ``grow_half_planes``, ``dequantize_planes`` and the plain
iSTFT, composed in the JAX program's order.

``fft_backend`` takes the JAX package's names (ops/fftbackend.resolve). A
size KE/KG do not take goes by the xla route (``torch.fft`` on the card),
and ``mm`` by the matmul DFT (KN, KO): the decode then grows the planes
(``grow_half_planes``; for PNG planes after KL, quantize.dequantize_raw)
before the route's inverse.

Layout: [..., frames, num_freqs, 2] channel-last, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..utils.profiling import annotate, transfer
from . import fftbackend, istft, quantize
from .quantize import dequantize_planes
from .rfft_mag import stft_planes
from .stft import map_frame_chunks, window_like


def phase_encode(x_padded: torch.Tensor, num_freqs: int, frame_len: int,
                 hop: int, window: torch.Tensor | None = None,
                 fft_backend: str = "auto",
                 frame_chunk: int | None = None) -> torch.Tensor:
    """Audio [..., L] -> phase spectrogram [..., F, num_freqs, 2]: (imag, real)
    of rfft bins 1..num_freqs of each Hann-windowed frame (reference
    phase/phase.go:50-64 then shrink, phase/impl.go:383-391).
    ``frame_chunk``: one launch per chunk of that many frames
    (ops/stft.map_frame_chunks); the frames are independent, so the result
    is the same."""
    if not 0 < num_freqs <= frame_len // 2:
        raise ValueError(f"num_freqs {num_freqs} outside (0, {frame_len // 2}]")
    window = window_like(window, frame_len, x_padded)
    if frame_chunk:
        return map_frame_chunks(
            x_padded, frame_len, hop, frame_chunk,
            lambda seg: stft_planes(seg, window, frame_len, hop, 1,
                                    num_freqs, fft_backend))
    return stft_planes(x_padded, window, frame_len, hop, 1, num_freqs,
                       fft_backend)


def phase_encode_batch(xb: torch.Tensor, num_freqs: int, frame_len: int,
                       hop: int, window: torch.Tensor | None = None,
                       fft_backend: str = "auto",
                       frame_chunk: int | None = None) -> torch.Tensor:
    """Batched audio [B, L] -> phase spectrogram [B, F, num_freqs, 2]: one
    kernel launch for the whole batch, or with ``frame_chunk`` one per chunk
    of that many frames (:func:`phase_encode`; the result is the same bits).
    An int16 ``xb`` is PCM-16, converted by kernel KA
    (ops/quantize.pcm16_ingest_batch: each sample divided by 32768) into
    ``window``'s float dtype (float32 without a tensor window) first."""
    if xb.ndim != 2:
        raise ValueError(f"phase_encode_batch takes [B, L] (got {tuple(xb.shape)})")
    if xb.dtype == torch.int16:
        xb = quantize.pcm16_ingest_batch(
            xb, window.dtype if isinstance(window, torch.Tensor)
            else torch.float32, 32768.0)
    return phase_encode(xb, num_freqs, frame_len, hop, window, fft_backend,
                        frame_chunk)


def _grow(spec2: torch.Tensor, n_bins: int) -> torch.Tensor:
    """grow (phase/impl.go:392-403): replicate the last kept bin up to
    n_bins."""
    pad_cnt = n_bins - spec2.shape[-2]
    if pad_cnt > 0:
        last = spec2[..., -1:, :]
        spec2 = torch.cat([spec2, last.expand(*last.shape[:-2], pad_cnt, 2)],
                          dim=-2)
    return spec2


def grow_half_planes(spec2: torch.Tensor, n_bins: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """grow + the Hermitian half spectrum in separate planes:
    re = [0, realm0[0..N/2-1]], im = [0, realn1[0..N/2-2], 0]
    ([..., F, nf, 2] -> two [..., F, N/2 + 1]; the Nyquist imaginary part is
    dropped, as the reference's conjugate write order leaves it)."""
    spec2 = _grow(spec2, n_bins)
    realn1 = spec2[..., 0]
    realm0 = spec2[..., 1]
    zero = realm0.new_zeros(realm0.shape[:-1] + (1,))
    re = torch.cat([zero, realm0], dim=-1)
    im = torch.cat([zero, realn1[..., :-1], zero], dim=-1)
    return re, im


def grow_half_spectrum(spec2: torch.Tensor, n_bins: int) -> torch.Tensor:
    """:func:`grow_half_planes` as one complex [..., F, N/2 + 1] array."""
    return torch.complex(*grow_half_planes(spec2, n_bins))


def shrink(spec2_full: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """Keep the first num_freqs bins: [..., F, N/2, 2] -> [..., F, num_freqs, 2]
    (reference: phase/impl.go:383-391)."""
    return spec2_full[..., :num_freqs, :]


def phase_decode_plain(spec2: torch.Tensor, frame_len: int, hop: int,
                       volume_boost: float = 0.0,
                       window: torch.Tensor | None = None,
                       pcm16: bool = False):
    """Plain PyTorch version of KG + KH on a spectrogram: grow, irfft x
    window, overlap-add and normalise, boost, optionally PCM-16."""
    window = window_like(window, frame_len, spec2)
    re, im = grow_half_planes(spec2, frame_len // 2)
    frames_w = istft.irfft_window_plain(re, im, frame_len, window)
    return istft.overlap_normalize_plain(frames_w, hop, window, volume_boost,
                                         pcm16)


def _synthesize(spec2: torch.Tensor, frame_len: int, window: torch.Tensor,
                route: str, real_frames: int | None = None) -> torch.Tensor:
    """grow + irfft x window of a spectrogram [..., F, nf, 2] -> frames_w
    [..., F, frame_len] by ``route`` (ops/fftbackend.resolve): KG's
    spectrogram mode for "mxu" on a CUDA tensor, else the half-spectrum
    planes through that route's inverse."""
    if route == "mxu" and spec2.device.type == "cuda":
        *lead, frames, nf, _ = spec2.shape
        with annotate(istft.synth_kernel(real_frames).span):
            return istft.launch_irfft_window(
                istft.MODE_SPEC, spec2.contiguous(), (), frame_len, frames,
                nf, window, tuple(lead), real_frames=real_frames)
    re, im = grow_half_planes(spec2, frame_len // 2)
    return istft.irfft_window(re, im, frame_len, window, real_frames, route)


def phase_decode(spec2: torch.Tensor, frame_len: int, hop: int,
                 volume_boost: float = 0.0,
                 window: torch.Tensor | None = None,
                 fft_backend: str = "auto",
                 frame_chunk: int | None = None) -> torch.Tensor:
    """Phase spectrogram [..., F, num_freqs, 2] -> audio
    [..., N + (F-1)*hop]: grow, direct iSTFT with window-sum normalisation,
    then the volume boost when it is non-zero (reference
    phase/phase.go:136-153). ``fft_backend``: ``auto`` is exact on every
    device, as the JAX program's ``auto`` -> ``xla``. ``frame_chunk`` as in
    ops/istft.istft_direct_planes: checked as the JAX program checks it,
    and the synthesis stays one KG and one KH launch."""
    if spec2.ndim < 3 or spec2.shape[-1] != 2 or spec2.shape[-2] > frame_len // 2:
        raise ValueError(f"phase_decode: bad spectrogram shape "
                         f"{tuple(spec2.shape)} for frame_len {frame_len}")
    if frame_chunk:
        istft.check_frame_chunk(frame_chunk, hop, frame_len)
    route = fftbackend.resolve(fft_backend, frame_len, spec2.device.type)
    if spec2.device.type == "cpu" and route != "mm":
        return phase_decode_plain(spec2, frame_len, hop, volume_boost, window)
    if spec2.device.type == "cuda" and spec2.dtype != torch.float32:
        raise ValueError("phase_decode: the CUDA kernels take float32")
    window = window_like(window, frame_len, spec2)
    frames_w = _synthesize(spec2, frame_len, window, route)
    return istft.overlap_normalize(frames_w, hop, window, volume_boost)


def phase_synthesize(spec2: torch.Tensor, frame_len: int, hop: int,
                     window: torch.Tensor | None = None,
                     real_frames: int | None = None) -> torch.Tensor:
    """Phase spectrogram [..., F, num_freqs, 2] -> the un-normalised
    windowed overlap-add [..., N + (F-1)*hop]: grow, irfft x window with
    the frames at or past ``real_frames`` zero, overlap-add with no
    window-sum normalisation (the shard-local synthesis of
    gomel_tpu/parallel/sharded.py:487-502). Kernel KG with its real-frame
    count, then KH without a window, on a CUDA tensor."""
    if spec2.ndim < 3 or spec2.shape[-1] != 2 or spec2.shape[-2] > frame_len // 2:
        raise ValueError(f"phase_synthesize: bad spectrogram shape "
                         f"{tuple(spec2.shape)} for frame_len {frame_len}")
    window = window_like(window, frame_len, spec2)
    if spec2.device.type == "cpu":
        re, im = grow_half_planes(spec2, frame_len // 2)
        return istft.overlap_add_plain(istft.irfft_window_plain(
            re, im, frame_len, window, real_frames), hop)
    if spec2.dtype != torch.float32:
        raise ValueError("phase_synthesize: the CUDA kernels take float32")
    route = fftbackend.resolve("auto", frame_len, "cuda")
    return istft.overlap_add(_synthesize(spec2, frame_len, window, route,
                                         real_frames), hop)


def dequantize_decode_plain(planes: torch.Tensor, maxs, mins, max_val: int,
                            ihs_passes: int, frame_len: int, hop: int,
                            volume_boost: float = 0.0,
                            window: torch.Tensor | None = None,
                            pcm16: bool = False):
    """Plain PyTorch version of the file decode: dequantize_planes, then
    :func:`phase_decode_plain` in float32."""
    spec = dequantize_planes(planes, maxs, mins, max_val, ihs_passes)
    return phase_decode_plain(spec, frame_len, hop, volume_boost, window,
                              pcm16)


def _extrema_window(maxs, mins, planes: torch.Tensor, lead: list,
                    frame_len: int, window):
    """The per-channel extrema [*lead, 2] as float32 on the planes' card
    (each a blocking upload from host memory) and the window there."""
    dev = planes.device
    with transfer(maxs, dev):
        maxs = torch.as_tensor(maxs, dtype=torch.float32, device=dev)
    with transfer(mins, dev):
        mins = torch.as_tensor(mins, dtype=torch.float32, device=dev)
    maxs, mins = maxs.contiguous(), mins.contiguous()
    if maxs.shape != tuple(lead) + (2,) or mins.shape != maxs.shape:
        raise ValueError(f"dequantize_decode: extrema {tuple(maxs.shape)}, "
                         f"{tuple(mins.shape)} for planes {tuple(planes.shape)}")
    return maxs, mins, window_like(window, frame_len, maxs)


def dequantize_decode(planes: torch.Tensor, maxs, mins, max_val: int,
                      ihs_passes: int, frame_len: int, hop: int,
                      volume_boost: float = 0.0,
                      window: torch.Tensor | None = None,
                      pcm16: bool = False):
    """Integer PNG planes [..., nf, F, 2] + per-channel extrema [..., 2] ->
    float32 audio [..., N + (F-1)*hop], or with ``pcm16`` (int16 PCM,
    all-finite flag [...]): the fused file decode
    (gomel_tpu/pipelines/phase.py:99-110), always in float32 like the JAX
    program."""
    if planes.ndim < 3 or planes.shape[-1] != 2 or \
            planes.shape[-3] > frame_len // 2:
        raise ValueError(f"dequantize_decode: bad planes shape "
                         f"{tuple(planes.shape)} for frame_len {frame_len}")
    if planes.device.type == "cpu":
        return dequantize_decode_plain(planes, maxs, mins, max_val,
                                       ihs_passes, frame_len, hop,
                                       volume_boost, window, pcm16)
    modes = {torch.uint8: istft.MODE_QUANT8, torch.uint16: istft.MODE_QUANT16}
    if planes.dtype not in modes:
        raise ValueError(f"dequantize_decode: planes must be uint8 or uint16 "
                         f"(got {planes.dtype})")
    *lead, nf, frames, _ = planes.shape
    route = fftbackend.resolve("auto", frame_len, "cuda")
    if route == "mxu":
        with annotate(istft.SYNTH_KERNEL.span):
            maxs, mins, window = _extrema_window(maxs, mins, planes, lead,
                                                 frame_len, window)
            frames_w = istft.launch_irfft_window(
                modes[planes.dtype], planes.contiguous(), (maxs, mins),
                frame_len, frames, nf, window, tuple(lead), float(max_val),
                ihs_passes)
    else:
        maxs, mins, window = _extrema_window(maxs, mins, planes, lead,
                                             frame_len, window)
        # KL row by row (its extrema are per channel), then the planes
        rows = planes.reshape((-1, nf, frames, 2))
        spec = torch.stack([quantize.dequantize_raw(
            p, a, b, max_val, ihs_passes) for p, a, b in zip(
                rows, maxs.reshape(-1, 2), mins.reshape(-1, 2))])
        spec = spec.reshape(tuple(lead) + (nf, frames, 2)).transpose(-3, -2)
        frames_w = _synthesize(spec, frame_len, window, route)
    return istft.overlap_normalize(frames_w, hop, window, volume_boost, pcm16)

