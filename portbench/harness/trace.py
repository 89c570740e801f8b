"""The traced stretch: ``torch.profiler`` over a bounded run of calls, kept
in memory and reduced to device intervals, copies and host spans.

The method is ``chip_smoke.busy_share``'s (CPU and CUDA activity), read as
a timeline: the device events' intervals (kernels, copies, sets) are merged
per device, and the harness's own spans (``record_function`` names that
start with ``pb.``) name what the host was doing in each idle gap. No trace
file is written.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

SPAN_PREFIX = "pb."
STRETCH = SPAN_PREFIX + "stretch"


def merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def total(intervals) -> float:
    return sum(e - s for s, e in intervals)


def gaps(busy, lo: float, hi: float):
    """The idle intervals of [lo, hi) around the merged ``busy`` ones."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


COPY_KINDS = ("HtoD", "DtoH", "DtoD", "PtoP", "other")


def copy_kind(name: str) -> str | None:
    """"HtoD", "DtoH", "DtoD" or "PtoP" for a copy's trace name, else
    None."""
    if not name.startswith("Memcpy"):
        return None
    for kind in ("HtoD", "DtoH", "DtoD", "PtoP"):
        if kind in name:
            return kind
    return "other"


@dataclasses.dataclass
class DeviceEvent:
    name: str
    device: int
    start: float     # seconds from the trace's start
    end: float


@dataclasses.dataclass
class Summary:
    """The reduced trace of one stretch (times in seconds)."""
    window: tuple[float, float]
    devices: list[int]
    events: list[DeviceEvent]
    spans: list[tuple[str, float, float]]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self, device: int, kinds=None) -> list[tuple[float, float]]:
        """Merged intervals on ``device`` inside the window; ``kinds`` keeps
        only copies of those kinds."""
        iv = [(e.start, e.end) for e in self.events if e.device == device
              and (kinds is None or copy_kind(e.name) in kinds)]
        return clip(merge(iv), *self.window)

    def _mean(self, per_device) -> float:
        if not self.devices:
            return 0.0
        return sum(per_device(d) for d in self.devices) / len(self.devices)

    def busy_s(self) -> float:
        """Seconds in which an operation ran, averaged over the devices."""
        return self._mean(lambda d: total(self.busy(d)))

    def copy_s(self) -> float:
        """Seconds in which a copy ran, averaged over the devices."""
        return self._mean(lambda d: total(self.busy(d, COPY_KINDS)))

    def seconds_by_name(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for e in self.events:
            out[e.name] = out.get(e.name, 0.0) + (e.end - e.start)
        return out

    def idle_by_span(self) -> dict[str, float]:
        """Idle seconds of each device summed by the innermost harness span
        open on the host at the gap's midpoint ("host_other" if none),
        averaged over the devices."""
        out: dict[str, float] = {}
        for d in self.devices:
            for s, e in gaps(self.busy(d), *self.window):
                mid = 0.5 * (s + e)
                open_ = [(se - ss, n) for n, ss, se in self.spans
                         if ss <= mid < se and n != STRETCH]
                name = min(open_)[1] if open_ else "host_other"
                out[name] = out.get(name, 0.0) + (e - s) / len(self.devices)
        return out


class Tracer:
    """Profiles the stretch run inside :meth:`stretch`; :meth:`summary`
    reduces it."""

    def __init__(self, devices: list[int]):
        self.devices = devices
        self.prof = None

    @contextlib.contextmanager
    def stretch(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        try:
            with torch.profiler.record_function(STRETCH):
                yield
        finally:
            self.prof.stop()

    def summary(self) -> Summary:
        cuda = torch.autograd.DeviceType.CUDA
        events, spans, window = [], [], None
        for e in self.prof.events():
            s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type == cuda and not e.name.startswith(SPAN_PREFIX):
                events.append(DeviceEvent(e.name, e.device_index, s, t))
            elif e.device_type != cuda and e.name.startswith(SPAN_PREFIX):
                spans.append((e.name, s, t))
                if e.name == STRETCH:
                    window = (s, t)
        if window is None:
            raise RuntimeError("the trace holds no stretch span")
        return Summary(window, self.devices, events, spans)
