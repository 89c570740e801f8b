"""Profiling helpers: ``torch.profiler`` traces, named regions and a
host-side stage timer.

Counterpart of ``gomel_tpu/utils/profiling.py``: a trace of any pipeline
call (Chrome trace JSON, viewable in Perfetto or chrome://tracing), regions
that show up in it (and in an NVTX timeline on the card), and an
accumulating timer whose stages end when the card's work has.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Trace the host and, when there is a card, its kernels and copies, and
    write the trace to ``logdir/trace_<pid>_<ns>.json`` on exit."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in device traces: ``torch.profiler.record_function``,
    plus an NVTX range when a card is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StageTimer:
    """Accumulating host-clock stage timer (one writer). A stage ends with a
    synchronise of the card, when one is in use, so it counts the device
    work it queued."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, dict]:
        return {
            k: {"total_s": round(v, 6), "count": self.counts[k],
                "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3)}
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }
