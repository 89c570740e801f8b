"""Throughput and scaling-efficiency metrics, and the Griffin-Lim quality
metric.

Counterpart of ``gomel_tpu/utils/metrics.py``: the headline metric is
audio-seconds/s per device, and a multi-device run's scaling efficiency.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_leaves


@dataclasses.dataclass
class ThroughputResult:
    audio_seconds: float
    wall_seconds: float
    iters: int
    n_devices: int

    @property
    def audio_seconds_per_second(self) -> float:
        return self.audio_seconds / self.wall_seconds

    @property
    def per_chip(self) -> float:
        return self.audio_seconds_per_second / max(self.n_devices, 1)

    def json(self) -> dict:
        return {
            "audio_seconds_per_second": round(self.audio_seconds_per_second, 1),
            "per_chip": round(self.per_chip, 1),
            "iters": self.iters,
            "n_devices": self.n_devices,
            "wall_seconds": round(self.wall_seconds, 4),
        }


def _force(out) -> None:
    """Wait for the work behind ``out``: synchronise the device of each CUDA
    tensor among its leaves (calls on a CUDA tensor return once they are
    queued); CPU work has ended when the call returns."""
    devices = {t.device for t in tree_leaves(out)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def measure_throughput(fn: Callable, args: tuple, audio_seconds_per_call: float,
                       n_devices: int = 1, warmup: int = 2,
                       min_seconds: float = 1.0, max_iters: int = 100,
                       trials: int = 3, alt_args: Optional[tuple] = None
                       ) -> ThroughputResult:
    """Steady-state throughput of ``fn(*args)`` on the host clock: the best
    of ``trials`` batches of ``iters`` back-to-back calls, each batch ended
    by a synchronise (:func:`_force`), after ``warmup`` calls (kernel builds
    and first-call setup excluded). ``alt_args``: a second argument tuple,
    alternated with ``args``."""
    argsets = [args] if alt_args is None else [args, alt_args]
    out = None
    for a in argsets:
        for _ in range(max(warmup, 1)):
            out = fn(*a)
    _force(out)
    t0 = time.perf_counter()
    _force(fn(*args))
    once = time.perf_counter() - t0
    iters = max(3, min(max_iters, int(min_seconds / max(once, 1e-5))))
    best = float("inf")
    for _ in range(max(trials, 1)):
        t0 = time.perf_counter()
        for i in range(iters):
            out = fn(*argsets[i % len(argsets)])
        _force(out)
        best = min(best, time.perf_counter() - t0)
    return ThroughputResult(audio_seconds=audio_seconds_per_call * iters,
                            wall_seconds=best, iters=iters,
                            n_devices=n_devices)


def scaling_efficiency(single: ThroughputResult, multi: ThroughputResult
                       ) -> float:
    """Throughput(N devices) / (N * throughput(1 device))."""
    base = single.audio_seconds_per_second
    return multi.audio_seconds_per_second / (multi.n_devices * base)


def spectral_convergence(signal, mag_target, frame_len: int, hop: int,
                         window=None, scale_invariant: bool = True) -> float:
    """Reconstruction quality: the relative L2 distance between the
    windowed-STFT magnitudes of ``signal`` [..., L] and the target
    magnitudes ``mag_target`` [..., F, frame_len/2 + 1] over their common
    frames (lower is better), in the signal's dtype on its device.

    ``scale_invariant`` (the default) factors out the least-squares gain c,
    as the reference's Griffin-Lim overlap-add is not normalised by the
    window sum and carries a constant gain; a gain of 0 (an all-zero or
    uncorrelated signal) falls back to c = 1."""
    from ..ops.rfft_mag import stft_mag_plain
    from ..ops.stft import window_like

    signal = torch.as_tensor(signal)
    window = window_like(window, frame_len, signal)
    a = stft_mag_plain(signal, window, frame_len, hop)
    mag = torch.as_tensor(mag_target).to(device=a.device)
    n_f = min(a.shape[-2], mag.shape[-2])
    a, mag = a[..., :n_f, :], mag[..., :n_f, :]
    c = torch.ones((), dtype=a.dtype, device=a.device)
    if scale_invariant:
        denom = (mag * mag).sum()
        if denom > 0:
            c = (a * mag).sum() / denom
        if not c.abs() > 1e-12:
            c = torch.ones_like(c)
    return float((a - c * mag).norm() / (c.abs() * mag.norm()))
