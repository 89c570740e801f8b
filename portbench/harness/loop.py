"""The closed loop that drives a cell's entry calls.

An entry's ``submit(i, span)`` enqueues call ``i`` and returns a
:class:`Call`. The loop keeps ``in_flight`` calls outstanding: it submits
until that many are out, then waits for the oldest. A call's latency runs
from its submission to the end of its last operation (outputs where its
consumer takes them), read from the device's clock: an event on an idle
side stream at submission, one on the working stream after the call's last
operation. Completion is the host's observation of the second event. The
window counts every call the host saw complete by its end.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass
class Call:
    """What an entry's ``submit`` returns."""
    audio_s: float                 # true audio seconds the call carries
    shape: dict                    # sizes the stage work formulas read
    outputs: Any                   # what the check compares
    flags: Any = None              # per-row finite flags (None: none)
    finish: Callable | None = None   # run once the host sees it done
    keep: Callable | None = None     # run when the check samples it
    index: int = -1
    latency_ms: float = 0.0
    enqueue_s: float = 0.0
    marks: tuple = ()


def failed(flags) -> bool:
    """Whether a call's flags say a row came out non-finite."""
    if flags is None:
        return False
    if isinstance(flags, torch.Tensor):
        flags = flags.cpu().numpy()
    return not bool(np.asarray(flags).all())


class CudaClock:
    """Events on ``device``, the card that holds the call's outputs;
    ``drain`` waits for every card in ``devices``."""

    def __init__(self, device: torch.device, devices=()):
        self.device = device
        self.devices = list(devices) or [device]
        self.side = torch.cuda.Stream(device)

    def submitted(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record(self.side)
        return e

    def done(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(self.device))
        return e

    def wait(self, e) -> None:
        e.synchronize()

    @staticmethod
    def latency_ms(start, end) -> float:
        return start.elapsed_time(end)

    def drain(self) -> None:
        for d in self.devices:
            torch.cuda.synchronize(d)


class Spans:
    """``span(name)``: a ``record_function`` named ``pb.<name>`` while a
    stretch is traced, else nothing."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function("pb." + name)


class Reservoir:
    """A uniform sample of ``k`` of the calls offered, drawn from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.calls = k, rng, 0, []

    def offer(self, call: Call) -> None:
        j = self.seen
        self.seen += 1
        slot = j if j < self.k else int(self.rng.integers(0, j + 1))
        if slot < self.k:
            if call.keep is not None:
                call.keep()
            if slot < len(self.calls):
                self.calls[slot] = call
            else:
                self.calls.append(call)


@dataclasses.dataclass
class Done:
    """A completed call, without its outputs."""
    audio_s: float
    latency_ms: float
    enqueue_s: float
    shape: dict


@dataclasses.dataclass
class Window:
    seconds: float
    calls: list            # Done, of the calls completed inside the window
    attempted: int         # submitted while the window was open
    flags: list            # each submitted call's flags


def run(submit, clock, in_flight: int, seconds: float, spans: Spans,
        first: int = 0, max_calls: int | None = None,
        on_complete: Callable[[Call], None] | None = None) -> Window:
    """Drive calls ``first``, ``first + 1``, ... for ``seconds`` (or until
    ``max_calls`` completed), ``in_flight`` outstanding; then wait for the
    rest."""
    pending: collections.deque = collections.deque()
    done: list[Call] = []
    flags: list = []
    i = first
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        while len(pending) < in_flight and time.perf_counter() < end and (
                max_calls is None or i - first < max_calls):
            start = clock.submitted()
            h0 = time.perf_counter()
            with spans("submit"):
                call = submit(i, spans)
            call.enqueue_s = time.perf_counter() - h0
            call.marks = (start, clock.done())
            call.index = i
            i += 1
            pending.append(call)
        if not pending:
            break
        call = pending.popleft()
        with spans("wait"):
            clock.wait(call.marks[1])
        t = time.perf_counter()
        if call.finish is not None:
            call.finish()
        flags.append(call.flags)
        call.latency_ms = clock.latency_ms(*call.marks)
        call.marks = ()
        if t <= end:
            done.append(Done(call.audio_s, call.latency_ms, call.enqueue_s,
                             call.shape))
            if on_complete is not None:
                on_complete(call)
    clock.drain()
    return Window(seconds, done, i - first, flags)
