"""The Griffin-Lim start's random draw: Threefry-2x32 uniform [0, 1), kernel
KP (csrc/threefry.cu) on a CUDA device and its plain PyTorch version on the
CPU, both giving the JAX package's bits.

Counterpart of the draws of ``gomel_tpu/ops/griffinlim.py:144``
(``jax.random.uniform(key, (out_len,))``), ``gomel_tpu/parallel/sharded.py:
308-316`` (``fold_in(key, shard_id)``) and ``gomel_tpu/parallel/batch.py:
201-210`` (``split(PRNGKey(seed), n)``). JAX's generator is the
counter-based Threefry-2x32 with 20 rounds (Salmon, Moraes, Dror and Shaw,
"Parallel Random Numbers: As Easy as 1, 2, 3", SC'11) under its
partitionable rule (``jax_threefry_partitionable``, JAX's default):

- a key is two 32-bit words; element ``i`` of a draw (the row-major flat
  index over the draw's whole shape) is one block of counter
  ``(i >> 32, i & 0xffffffff)``, and its random bits are ``x0 ^ x1`` of
  that block's output (float32) or ``(x0 << 32) | x1`` (float64);
- float32 is ``bitcast((bits >> 9) | 0x3F800000) - 1``, float64
  ``bitcast((bits >> 12) | 0x3FF0000000000000) - 1``, both in [0, 1);
- ``PRNGKey(seed)`` is the (high, low) words of the seed as a
  two's-complement int64, ``fold_in(key, d)`` and row ``r`` of
  ``split(key, n)`` are the block of counter ``(0, d)`` or ``(0, r)``.

So a seeded decode of the port starts from the same samples as the JAX
package's on every device. Keys are made on the host (a few words per call)
as ``numpy`` ``uint32`` arrays: ``[2]`` is one key, ``[R, 2]`` a table of R
row keys. tests/test_torch_prng.py pins every rule to the JAX package bit
for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import annotate, transfer
from . import _cuda

KERNEL = _cuda.Kernel("threefry_uniform", "gomel_tpu_torch/csrc/threefry.cu",
                      "gomel_tpu/ops/griffinlim.py:144")

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """One Threefry-2x32 block of 20 rounds on Python integers: key words
    ``k0, k1``, counter words ``x0, x1`` -> two output words."""
    ks = (k0 & _M32, k1 & _M32, (k0 ^ k1 ^ _PARITY) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _words(words) -> np.ndarray:
    return np.array(words, dtype=np.uint32)


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit integers enabled: the
    (high, low) 32-bit words of ``seed`` as a two's-complement int64. A seed
    outside the int64 range raises OverflowError, as JAX does. (With 64-bit
    integers disabled JAX drops the high word; the two rules agree on every
    seed in [0, 2^32).)"""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"seed {seed} does not fit in an int64")
    seed &= (1 << 64) - 1
    return _words([seed >> 32, seed & _M32])


def _one_key(k) -> tuple[int, int]:
    k = np.asarray(k)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise ValueError(f"expected one key, uint32 [2] (got {k.dtype} "
                         f"{k.shape})")
    return int(k[0]), int(k[1])


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for ``data`` in [0, 2^32)."""
    if not 0 <= int(data) <= _M32:
        raise ValueError(f"fold_in: data {data} outside [0, 2^32)")
    return _words(threefry2x32(*_one_key(k), 0, int(data)))


def split_row(k: np.ndarray, row: int) -> np.ndarray:
    """Row ``row`` of ``jax.random.split(key, n)``, which does not depend
    on ``n``."""
    return fold_in(k, row)


def split_rows(k: np.ndarray, rows: int) -> np.ndarray:
    """``jax.random.split(key, rows)``: the key table [rows, 2]."""
    return np.stack([split_row(k, r) for r in range(rows)]).reshape(rows, 2)


def _check(keys, shape, dtype):
    """-> (key table [R, 2], the result's shape, samples per key)."""
    keys = np.asarray(keys)
    if keys.dtype != np.uint32 or keys.ndim not in (1, 2) or \
            keys.shape[-1] != 2:
        raise ValueError(f"uniform: keys must be uint32 [2] or [R, 2] (got "
                         f"{keys.dtype} {keys.shape})")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"uniform: dtype must be float32 or float64 (got "
                         f"{dtype})")
    shape = tuple(int(s) for s in shape)
    per_key = int(np.prod(shape, dtype=object)) if shape else 1
    if per_key >= 1 << 32:
        raise ValueError(f"uniform: {per_key} samples from one key; the "
                         f"counter's high word stays 0, so a key draws fewer "
                         f"than 2^32")
    out_shape = shape if keys.ndim == 1 else (keys.shape[0],) + shape
    return keys.reshape(-1, 2), out_shape, per_key


# (key table's bytes, device) -> the table on that device, so a repeated
# draw (a file decoded again, the next chunk of a batch) uploads nothing: a
# copy from pageable host memory would wait for the device's queue to drain
_KEY_TABLES: dict[tuple, torch.Tensor] = {}
_KEY_TABLES_MAX = 16


def _device_keys(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """The key table uint32 [R, 2] as an int32 tensor on ``device``."""
    table = np.ascontiguousarray(table)
    entry = (table.tobytes(), device)
    kt = _KEY_TABLES.get(entry)
    if kt is None:
        if len(_KEY_TABLES) >= _KEY_TABLES_MAX:
            _KEY_TABLES.clear()
        with transfer(table, device):
            kt = _KEY_TABLES[entry] = torch.tensor(
                table.view(np.int32), dtype=torch.int32, device=device)
    return kt


def uniform_plain(keys, shape, dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """Plain PyTorch version of KP: the same arithmetic on ``int64`` tensors
    masked to 32 bits (PyTorch has no full ``uint32`` arithmetic, and ``>>``
    on ``int32`` is arithmetic), float32 or float64. See :func:`uniform`."""
    table, out_shape, per_key = _check(keys, shape, dtype)
    device = torch.device(device)
    kt = _device_keys(table, device)
    return uniform_table_plain(kt, per_key, dtype).reshape(out_shape)


def _rounds(kt: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32's 20 rounds on int64 tensors masked to 32 bits: the
    key table ``kt`` [R, 2] against counters ``x0``, ``x1`` [R, C] (or
    broadcasting to it) -> the two output words."""
    kt = kt.to(torch.int64) & _M32
    k0, k1 = kt[:, 0:1], kt[:, 1:2]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in_table(kt: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """:func:`fold_in` on the device: int32 key words [R, 2] (uint32 bits)
    and ``data`` int64 [D] -> int32 keys [R, D, 2], key r folded with
    data[d]."""
    x0, x1 = _rounds(kt, torch.zeros_like(data)[None, :], data[None, :])
    return torch.stack([x0, x1], dim=-1).to(torch.int32)


def uniform_table_plain(kt: torch.Tensor, per_key: int,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of KP on a key table: int32 [R, 2] (uint32
    bits) on the result's device -> [R, per_key] in ``dtype``."""
    i64 = torch.int64
    rows = kt.shape[0]
    # fewer than 2^32 samples from a key: the counter's high word is 0
    x0, x1 = _rounds(kt, torch.zeros((rows, per_key), dtype=i64,
                                     device=kt.device),
                     torch.arange(per_key, dtype=i64, device=kt.device))
    if dtype == torch.float32:
        mant = ((x0 ^ x1) >> 9) | 0x3F800000
        out = mant.to(torch.int32).view(torch.float32) - 1.0
    else:
        mant = (x0 << 20) | (x1 >> 12) | 0x3FF0000000000000
        out = mant.view(torch.float64) - 1.0
    return out


def uniform(keys, shape, dtype: torch.dtype = torch.float32,
            device: torch.device | str = "cuda") -> torch.Tensor:
    """Uniform [0, 1) samples, the bits of ``jax.random.uniform``.

    ``keys`` uint32 [2] is one key: the result has ``shape``, element ``i``
    (row-major flat index) from counter ``i``. ``keys`` uint32 [R, 2] is a
    table of row keys: the result is [R, *shape], row ``r`` the draw of
    ``shape`` from key ``r`` (``jax.vmap`` of the draw over the keys). One
    key draws fewer than 2^32 samples (a day of audio at 48 kHz), so the
    counter's high word is 0; more raises ValueError.

    The samples are made on ``device``: kernel KP in one launch on a CUDA
    device (float32 only), the plain version on the CPU. ``device`` defaults
    to the card, as ``jax.random.uniform`` draws on the default (accelerator)
    device; without one it raises RuntimeError: pass ``device="cpu"``."""
    device = _cuda.require_device(device, "uniform")
    if device.type == "cpu":
        return uniform_plain(keys, shape, dtype, device)
    with annotate(KERNEL.span):
        table, out_shape, per_key = _check(keys, shape, dtype)
        if device.type != "cuda":
            raise ValueError(f"uniform: device {device} is neither cuda nor "
                             f"cpu")
        if dtype != torch.float32:
            raise ValueError("uniform: the CUDA kernel draws float32")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        kt = _device_keys(table, device)
        return launch_uniform(kt, per_key).reshape(out_shape)


def launch_uniform(kt: torch.Tensor, per_key: int) -> torch.Tensor:
    """Launch KP on a CUDA key table int32 [R, 2] (uint32 bits) -> float32
    [R, per_key]."""
    device = kt.device
    rows = kt.shape[0]
    out = torch.empty((rows, per_key), dtype=torch.float32, device=device)
    if rows * per_key == 0:
        return out
    _cuda.launch("gomel_threefry_uniform", device, kt.data_ptr(),
                 out.data_ptr(), rows, per_key)
    KERNEL.launches += 1
    return out
