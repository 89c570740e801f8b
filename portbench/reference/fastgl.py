"""Plain PyTorch reference of the mel decode with fast Griffin-Lim, at a
stated precision (``codecs.Arith``: ``"f64"`` the yardstick, ``"bf16"`` the
control).

Fast Griffin-Lim (Perraudin, Balazs and Sondergaard, "A fast Griffin-Lim
algorithm", WASPAA 2013) in the signal domain, as the codec runs it: with
G one Griffin-Lim projection and overlap-add (``codecs.griffin_lim`` of one
iteration: no window-sum normalisation), ``n - 1`` interior iterations

    t_k = G(c_k),  c_{k+1} = t_k + m (t_k - t_{k-1}),

from (c, t) = (start, start), then one plain final iteration G(c). With
m = 0 this is ``codecs.griffin_lim`` itself. The chain of a decode: uint8
planes and extrema, the dequantize of ``codecs.mel_decode``,
``codecs.mel_magnitudes``, the Threefry start of the row keys, the
iterations (frames in blocks), ``codecs.pcm16``.

It imports nothing of the program and takes nothing the program made.
"""
from __future__ import annotations

import torch

from . import codecs, dsp, threefry


def fast_griffin_lim(mag: torch.Tensor, start: torch.Tensor, cfg: dict,
                     momentum: float, ar: codecs.Arith,
                     block: int = 8192) -> torch.Tensor:
    """Fast Griffin-Lim from ``start`` [B, n + (F - 1) hop] on the fixed
    magnitudes [B, F, n/2 + 1], ``griffin_lim_iterations`` in all (the
    last one plain), rounded by ``ar`` after every step."""
    once = dict(cfg, griffin_lim_iterations=1)

    def project(s: torch.Tensor) -> torch.Tensor:
        return codecs.griffin_lim(mag, s, once, ar, block)

    n_iter = cfg["griffin_lim_iterations"]
    c = t_prev = ar(start)
    if n_iter < 1:
        return c
    for _ in range(n_iter - 1):
        t = project(c)
        c = ar(t + ar(momentum * ar(t - t_prev)))
        t_prev = t
    return project(c)


def magnitudes(planes: torch.Tensor, mx, mn, cfg: dict, ar: codecs.Arith
               ) -> torch.Tensor:
    """uint8 planes [B, mels, F, 2] and extrema [B] -> the Griffin-Lim
    magnitudes [B, F, n/2 + 1]: ``codecs.mel_decode``'s dequantize, then
    ``codecs.mel_magnitudes``."""
    dev = planes.device
    mx = torch.as_tensor(mx, device=dev).to(ar.dtype)[:, None, None, None]
    mn = torch.as_tensor(mn, device=dev).to(ar.dtype)[:, None, None, None]
    logmel = ar(planes.transpose(-3, -2).to(ar.dtype) / 255 * (mx - mn) + mn)
    return codecs.mel_magnitudes(logmel, cfg, ar)


def mel_decode(planes: torch.Tensor, mx, mn, keys, cfg: dict,
               momentum: float, precision: str = "f64"):
    """uint8 planes [B, mels, F, 2], extrema [B], row keys uint32 [B, 2]
    -> (float signal [B, out_len] before PCM-16, int16 PCM, per-row finite
    flags), by fast Griffin-Lim with ``momentum``."""
    ar = codecs.Arith(precision)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        mag = magnitudes(planes, mx, mn, cfg, ar)
        start = threefry.uniform(keys, dsp.out_length(
            mag.shape[1], cfg["resolut"], cfg["window"]), planes.device)
        sig = fast_griffin_lim(mag, start, cfg, momentum, ar)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return sig, codecs.pcm16(sig), torch.isfinite(sig).all(dim=-1)
