"""Seeded test audio made on the device.

The recipe of ``chip_smoke.seeded_pcm`` (four tones of 80-4000 Hz at
speech-like levels, light noise, a one-second stretch 60 dB down so the
log-mel spans a wide range), drawn for all rows at once from a
``torch.Generator`` on the given device.
"""
from __future__ import annotations

import math

import torch

TONES = 4


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded by ``seed`` (any int up to 2**64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def audio(gen: torch.Generator, rows: int, n: int, sample_rate: int,
          device: torch.device) -> torch.Tensor:
    """float32 [rows, n], peak below 0.85."""
    def uni(lo, hi):
        return lo + (hi - lo) * torch.rand((rows, TONES, 1), generator=gen,
                                           device=device, dtype=torch.float64)
    freq, amp, phase = uni(80.0, 4000.0), uni(0.02, 0.2), uni(0.0, 2 * math.pi)
    t = torch.arange(n, device=device, dtype=torch.float64) / sample_rate
    x = 0.01 * torch.randn((rows, n), generator=gen, device=device)
    for k in range(TONES):
        x += (amp[:, k] * torch.sin(2 * math.pi * freq[:, k] * t
                                    + phase[:, k])).to(torch.float32)
    quiet = slice(n // 3, n // 3 + sample_rate)
    x[:, quiet] *= 1e-3
    return x


def pcm16(x: torch.Tensor) -> torch.Tensor:
    """float audio -> int16, rounded and saturated."""
    return torch.clip(torch.round(x * 32768.0), -32768, 32767).to(torch.int16)
