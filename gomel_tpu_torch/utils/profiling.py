"""Profiling: the program's spans and counters, and ``torch.profiler`` traces.

Counterpart of ``gomel_tpu/utils/profiling.py``. :func:`annotate` is the
program's one span. It records while a torch profiler records
(``torch.autograd.profiler._is_profiler_enabled``, which
``torch.profiler.profile.start()`` sets: :func:`device_trace`, or a
caller's own profiler) and is a flag check otherwise. A recording span is a
range of the profiler's host timeline, beside the card's kernels and copies
and around the operators it ran, carrying the call id and its parent's name
(in an exported trace where the profiler records shapes). It also adds its
count, its inclusive host seconds and its self seconds (its duration less
its child spans') to an in-memory record per span name. :func:`count` adds
to a counter under the same switch; :func:`recorded` returns both and
:func:`reset` clears them.

The range is ``torch.profiler``'s fast record function in its operator
scope, not a ``record_function`` user annotation: the profiler mirrors each
user annotation on the card's timeline over the kernels launched inside it,
and a trace reader that counts the card's events as its busy time (as the
benchmark's harness, portbench/harness/trace.py, does for every name but
its own ``pb.*`` spans) would count those copies as work.

The program's spans are named ``gomel.<layer>.<what>``: the API calls
(``gomel.batch.*``, ``gomel.longform.*``), the batch codecs' glue
(``gomel.rows.*``), the op wrappers (``gomel.op.<kernel>``, one a launch),
the mesh and its halos (``gomel.mesh.*``, ``gomel.halo.*``) and the host's
waits on the card (``gomel.sync``, counted in ``host_syncs.<kind>``).
Copies between two cards count their bytes in ``peer_bytes``.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler

_clock = time.perf_counter_ns
_record_function = torch._C._profiler._RecordFunctionFast
_call_ids = itertools.count(1)
_lock = threading.Lock()
_stacks = threading.local()
# span name -> [count, inclusive ns, self ns]
_spans: dict[str, list[int]] = {}
_counters: dict[str, int] = {}


class _Off:
    """The one context every span site gets while nothing records."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_stacks, "spans", None)
    if stack is None:
        stack = _stacks.spans = []
    return stack


class _Span:
    """A recording span: a profiler range whose keyword values carry the
    call id (taken by the outermost program span on the thread), the parent
    span's name and the span's ``attrs``, timed on the host clock around
    it."""

    __slots__ = ("name", "attrs", "call", "range", "start", "children")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "_Span":
        self.start = _clock()
        stack = _stack()
        if stack:
            self.call = stack[-1].call
            args = {"call": self.call, "parent": stack[-1].name}
        else:
            self.call = next(_call_ids)
            args = {"call": self.call}
        args.update(self.attrs)
        self.range = _record_function(self.name, (), args)
        self.range.__enter__()
        self.children = 0
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        stack = _stack()
        stack.pop()
        self.range.__exit__(*exc)
        ns = _clock() - self.start
        if stack:
            stack[-1].children += ns
        with _lock:
            rec = _spans.get(self.name)
            if rec is None:
                rec = _spans[self.name] = [0, 0, 0]
            rec[0] += 1
            rec[1] += ns
            rec[2] += ns - self.children
        return False


def annotate(name: str, **attrs):
    """The program's span ``name`` (``with annotate(...):``), its keyword
    ``attrs`` passed to the trace with the call id and the parent's name.
    While no profiler records: one shared no-op context, no allocation, no
    clock read, no lock."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def sync(kind: str):
    """The span of a place where the host waits for the card: ``gomel.sync``
    with its ``kind`` ("upload": a blocking copy from host memory;
    "read_back": ``.cpu()``, ``bool()`` of a card tensor; "exchange_wait":
    a halo exchange's ``work.wait()``), counted in
    ``host_syncs.<kind>``."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    count("host_syncs." + kind)
    return _Span("gomel.sync", {"kind": kind})


_HOST = torch.device("cpu")


def transfer(src, dst: torch.device):
    """The span of a copy of ``src`` (a tensor, or a host value such as a
    numpy array) to device ``dst``: a blocking upload or read back is a
    :func:`sync`; a copy between two CUDA devices adds its bytes to
    ``peer_bytes``; anything else records nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    on = src.device if isinstance(src, torch.Tensor) else _HOST
    if dst.type == "cuda":
        if on.type != "cuda":
            return sync("upload")
        if dst.index is not None and on.index != dst.index:
            count("peer_bytes", src.nbytes)
    elif on.type == "cuda":
        return sync("read_back")
    return _OFF


def recorded() -> dict:
    """What the spans and counters recorded since the last :func:`reset`:
    ``{"spans": {name: {"count", "total_s", "self_s"}}, "counters": {name:
    value}}``."""
    with _lock:
        spans = {name: {"count": c, "total_s": t * 1e-9, "self_s": s * 1e-9}
                 for name, (c, t, s) in _spans.items()}
        return {"spans": spans, "counters": dict(_counters)}


def reset() -> None:
    """Clear the record."""
    with _lock:
        _spans.clear()
        _counters.clear()


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Trace the host and, when there is a card, its kernels and copies, and
    write the trace to ``logdir/trace_<pid>_<ns>.json`` on exit. The record
    is reset on entry, so :func:`recorded` after the block holds the
    program's spans and counters of this trace."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
