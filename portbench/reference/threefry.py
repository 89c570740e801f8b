"""Threefry-2x32 (20 rounds; Salmon et al., SC'11) under JAX's partitionable
rule, the generator of the Griffin-Lim start: keys from a seed, ``fold_in``,
the rows of ``split``, and uniform float32 draws in [0, 1).

A frozen copy of the rules the codec's start follows (JAX's
``PRNGKey``/``split``/``uniform``), written on int64 tensors masked to 32
bits. It imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rounds(k0, k1, x0, x1):
    """20 rounds on int64 tensors (or ints) masked to 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """``PRNGKey(seed)`` with 64-bit integers: the high and low words of
    the seed as a two's-complement int64."""
    seed = int(seed) & ((1 << 64) - 1)
    return seed >> 32, seed & _M32


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """``fold_in(key, data)``, which is also row ``data`` of ``split``."""
    return _rounds(k[0], k[1], 0, int(data))


def row_keys(seed: int, rows: int) -> np.ndarray:
    """``split(PRNGKey(seed), rows)``: uint32 [rows, 2]."""
    k = key(seed)
    return np.array([fold_in(k, r) for r in range(rows)], dtype=np.uint32)


def uniform(keys: np.ndarray, count: int, device) -> torch.Tensor:
    """Row r of the result is ``uniform(keys[r], (count,))`` in float32:
    element i from counter (0, i), its bits ``(x0 ^ x1) >> 9`` under the
    exponent of 1.0, minus 1."""
    kt = torch.as_tensor(np.asarray(keys, dtype=np.int64), device=device)
    i = torch.arange(count, dtype=torch.int64, device=device)[None, :]
    x0, x1 = _rounds(kt[:, :1], kt[:, 1:], torch.zeros_like(i), i)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
