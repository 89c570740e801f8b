"""Plain PyTorch reference of the mel and phase codecs at a stated precision.

``"f64"`` computes every step in float64: the yardstick the program's
float32 outputs are held to. ``"bf16"`` is the control: every operand and
every intermediate is rounded to bfloat16, the arithmetic in float32 (as a
bf16 tensor-core or storage path would run it); the benchmark's check must
call its outputs incorrect.

Encode (mel/mel.go:46-74, phase/phase.go:41-64): Hann-windowed frames of
``n`` samples at hop ``hop``, the rFFT; mel: the magnitudes of bins
0..n/2-1 (channel 0) and 1..n/2 (channel 1) through the ``domel``
filterbank, then ``log(max(v, 1e-5))``; phase: (imag, real) of bins
1..nf. Quantizers (mel/impl.go:138-152, phase/impl.go:198-222):
``trunc(255 (v - min) / (max - min))``, one extremum pair a row (mel) or a
channel (phase). Mel decode (mel/mel.go:76-152): de-quantize, ``exp``, the
``undomel`` filterbank, the half-spectrum magnitudes, then Griffin-Lim from
a Threefry start with no window-sum normalisation. Phase decode
(phase/phase.go:96-153): de-quantize, grow the kept bins to n/2, inverse
rFFT times the window, overlap-add, divided by the window-sum where it
exceeds half its peak (the edge fade below). PCM-16: clip to [-1, 1],
round half to even of x * 32768, saturate.

It imports nothing of the program and takes nothing the program made: the
filterbanks and windows are built here (reference/dsp.py).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import dsp, threefry

PRECISIONS = ("f64", "bf16")


class Arith:
    """The compute dtype and the rounding applied after each step."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.lowp = precision == "bf16"
        self.dtype = torch.float32 if self.lowp else torch.float64

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.dtype)
        return t.to(torch.bfloat16).to(self.dtype) if self.lowp else t

    def const(self, a: np.ndarray, device) -> torch.Tensor:
        return self(torch.as_tensor(a, device=device))

    def rfft(self, frames: torch.Tensor) -> torch.Tensor:
        spec = torch.fft.rfft(frames, dim=-1)
        return torch.complex(self(spec.real), self(spec.imag))

    def irfft(self, re: torch.Tensor, im: torch.Tensor, n: int):
        return self(torch.fft.irfft(torch.complex(re, im), n=n, dim=-1))

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return self(a @ b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32


def _frames(x: torch.Tensor, win: torch.Tensor, n: int, hop: int, ar: Arith):
    return ar(x.unfold(-1, n, hop) * win)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[..., F, n] -> [..., n + (F - 1) hop], the frames summed in place."""
    *lead, nf, n = frames.shape
    length = dsp.out_length(nf, n, hop)
    cols = frames.reshape(-1, nf, n).transpose(1, 2)
    out = F.fold(cols, (1, length), (1, n), stride=(1, hop))
    return out.reshape(*lead, length)


def pcm16(x: torch.Tensor) -> torch.Tensor:
    """float -> int16 as the codec writes WAV (NaN to 0)."""
    x = torch.clip(torch.nan_to_num(x, nan=0.0), -1.0, 1.0)
    return torch.clip(torch.round(x * 32768.0), -32768, 32767).to(torch.int16)


def mel_encode(x: torch.Tensor, cfg: dict, precision: str = "f64",
               block: int = 16384) -> torch.Tensor:
    """Padded audio [B, L] -> log-mel [B, F, mels, 2]; frames in blocks of
    ``block``."""
    ar = Arith(precision)
    n, hop, mels = cfg["resolut"], cfg["window"], cfg["num_mels"]
    w = ar.const(dsp.mel_weights(n // 2, mels, cfg["mel_fmin"],
                                 cfg["mel_fmax"]).T, x.device)
    win = ar.const(dsp.hann(n), x.device)
    out = []
    for f0 in range(0, dsp.num_frames(x.shape[-1], n, hop), block):
        seg = ar(x[..., f0 * hop:(f0 + block - 1) * hop + n])
        mag = ar(ar.rfft(_frames(seg, win, n, hop, ar)).abs())
        ch0 = ar.matmul(mag[..., : n // 2], w)
        ch1 = ar.matmul(mag[..., 1:], w)
        out.append(ar(torch.log(torch.clamp_min(torch.stack([ch0, ch1], -1),
                                                1e-5))))
    return torch.cat(out, dim=-3)


def quantize(spec: torch.Tensor, dims: tuple, ar: Arith):
    """(uint8 planes [..., X, F, 2] from [..., F, X, 2], max, min): the
    extrema over ``dims``."""
    mx = spec.amax(dim=dims, keepdim=True)
    mn = spec.amin(dim=dims, keepdim=True)
    rng = mx - mn
    norm = torch.where(rng > 0, ar((spec - mn) / torch.where(rng > 0, rng, 1)),
                       0.5)
    q = torch.clip(torch.trunc(ar(255 * norm)), 0, 255)
    return (q.transpose(-3, -2).to(torch.uint8),
            mx.reshape(mx.shape[0], -1).squeeze(-1),
            mn.reshape(mn.shape[0], -1).squeeze(-1))


def mel_quantize(logmel: torch.Tensor, precision: str = "f64"):
    """log-mel [B, F, mels, 2] -> (uint8 [B, mels, F, 2], max [B], min [B])."""
    return quantize(logmel, (1, 2, 3), Arith(precision))


def mel_magnitudes(logmel: torch.Tensor, cfg: dict, ar: Arith
                   ) -> torch.Tensor:
    """log-mel [B, F, mels, 2] -> the fixed Griffin-Lim magnitudes
    [B, F, n/2 + 1]: exp, ``undomel``, |channel 0| on bins 0..n/2-1 and
    |channel 1| of the top bin for bin n/2."""
    n, mels = cfg["resolut"], cfg["num_mels"]
    u = ar.const(dsp.inverse_mel_weights(n // 2, mels, cfg["mel_fmin"],
                                         cfg["mel_fmax"]).T, logmel.device)
    mel = ar(torch.exp(ar(logmel)))
    lin0 = ar.matmul(mel[..., 0], u)
    lin1_top = ar.matmul(mel[..., 1], u[:, -1:])
    return torch.cat([lin0.abs(), lin1_top.abs()], dim=-1)


def griffin_lim(mag: torch.Tensor, start: torch.Tensor, cfg: dict,
                ar: Arith, block: int = 8192) -> torch.Tensor:
    """Griffin-Lim from ``start`` [B, n + (F - 1) hop] on the fixed
    magnitudes [B, F, n/2 + 1], ``griffin_lim_iterations`` times, with no
    window-sum normalisation; frames in blocks of ``block``."""
    n, hop = cfg["resolut"], cfg["window"]
    win = ar.const(dsp.hann(n), mag.device)
    sig = ar(start)
    frames = mag.shape[1]
    for _ in range(cfg["griffin_lim_iterations"]):
        out = torch.zeros_like(sig)
        for f0 in range(0, frames, block):
            f1 = min(frames, f0 + block)
            seg = sig[..., f0 * hop:(f1 - 1) * hop + n]
            spec = ar.rfft(_frames(seg, win, n, hop, ar))
            a = ar(spec.abs())
            pos = a > 0
            inv = torch.where(pos, 1.0 / torch.where(pos, a, 1.0), 0.0)
            unit_re = torch.where(pos, ar(spec.real * inv), 1.0)
            unit_im = ar(spec.imag * inv)
            m = mag[:, f0:f1]
            rec = ar.irfft(ar(m * unit_re), ar(m * unit_im), n)
            ola = overlap_add(ar(rec * win), hop)
            out[..., f0 * hop:f0 * hop + ola.shape[-1]] += ola
        sig = ar(out)
    return sig


def mel_decode(planes: torch.Tensor, mx, mn, keys: np.ndarray, cfg: dict,
               precision: str = "f64"):
    """uint8 planes [B, mels, F, 2], extrema [B], Griffin-Lim row keys
    uint32 [B, 2] -> (float signal [B, out_len] before PCM-16, int16 PCM,
    per-row finite flags)."""
    ar = Arith(precision)
    dev = planes.device
    n, hop = cfg["resolut"], cfg["window"]
    mx = torch.as_tensor(mx, device=dev).to(ar.dtype)[:, None, None, None]
    mn = torch.as_tensor(mn, device=dev).to(ar.dtype)[:, None, None, None]
    logmel = ar(planes.transpose(-3, -2).to(ar.dtype) / 255 * (mx - mn) + mn)
    mag = mel_magnitudes(logmel, cfg, ar)
    start = threefry.uniform(keys, dsp.out_length(mag.shape[1], n, hop), dev)
    sig = griffin_lim(mag, start, cfg, ar)
    return sig, pcm16(sig), torch.isfinite(sig).all(dim=-1)


def phase_encode(pcm: torch.Tensor, cfg: dict, precision: str = "f64"):
    """int16 PCM [B, L] -> (uint8 planes [B, nf, F, 2], maxs [B, 2],
    mins [B, 2])."""
    ar = Arith(precision)
    n, hop, nf = cfg["resolut"], cfg["window"], cfg["num_freqs"]
    win = ar.const(dsp.hann(n), pcm.device)
    x = ar(pcm.to(ar.dtype) / 32768.0)
    spec = ar.rfft(_frames(x, win, n, hop, ar))[..., 1:nf + 1]
    planes = torch.stack([spec.imag, spec.real], dim=-1)   # [B, F, nf, 2]
    return quantize(planes, (1, 2), ar)


def window_sum(win: torch.Tensor, frames: int, hop: int) -> torch.Tensor:
    """The overlap-added squared window of ``frames`` frames."""
    sq = (win * win).expand(frames, -1)
    return overlap_add(sq, hop)


def phase_decode(planes: torch.Tensor, maxs, mins, cfg: dict,
                 precision: str = "f64"):
    """uint8 planes [B, nf, F, 2] + per-channel extrema [B, 2] ->
    (float signal [B, out_len] before PCM-16, int16 PCM, finite flags)."""
    ar = Arith(precision)
    dev = planes.device
    n, hop = cfg["resolut"], cfg["window"]
    win = ar.const(dsp.hann(n), dev)
    mx = torch.as_tensor(maxs, device=dev).to(ar.dtype)[:, None, None, :]
    mn = torch.as_tensor(mins, device=dev).to(ar.dtype)[:, None, None, :]
    spec = ar(planes.transpose(-3, -2).to(ar.dtype) / 255 * (mx - mn) + mn)
    grow = n // 2 - spec.shape[-2]
    if grow > 0:
        spec = torch.cat([spec, spec[..., -1:, :].expand(
            *spec.shape[:-2], grow, 2)], dim=-2)
    zero = spec.new_zeros(spec.shape[:-2] + (1,))
    re = torch.cat([zero, spec[..., 1]], dim=-1)
    im = torch.cat([zero, spec[..., :-1, 0], zero], dim=-1)
    frames = spec.shape[1]
    sig = ar(overlap_add(ar(ar.irfft(re, im, n) * win), hop))
    wsum = ar(window_sum(win, frames, hop))
    thr = 0.5 * wsum.max()
    sig = torch.where(wsum > thr, sig / torch.where(wsum > 0, wsum, 1.0),
                      torch.where(wsum > 1e-21, sig / thr, sig))
    sig = ar(sig)
    return sig, pcm16(sig), torch.isfinite(sig).all(dim=-1)
