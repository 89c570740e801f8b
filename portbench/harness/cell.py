"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line."""
from __future__ import annotations

import dataclasses
import gc
import glob
import math
import os
import re
import sys
import time

import numpy as np
import torch

from . import counters, loop, yardstick
from .manifest import Manifest
from .trace import Summary, Tracer


@dataclasses.dataclass
class Context:
    """What a metric reader (metrics/<name>.py ``read(ctx)``) reads."""
    manifest: Manifest
    workload: dict
    config: dict
    traffic: dict
    setup_s: float
    window: loop.Window
    launches: dict            # counter -> launches during the window
    trace: Summary | None = None
    traced: loop.Window | None = None   # the calls of the traced stretch

    def stage_seconds(self, stage: str) -> float:
        """Device seconds of the kernels mapped to ``stage`` in the traced
        stretch."""
        kmap, _ = self.manifest.stage(stage)
        pats = [re.compile(p) for p in kmap["kernels"]]
        lo, hi = self.trace.window
        return sum(min(e.end, hi) - max(e.start, lo)
                   for e in self.trace.events
                   if any(p.search(e.name) for p in pats)
                   and min(e.end, hi) > max(e.start, lo))

    def roofline_pct(self, stage: str) -> float | None:
        """100 x the stage's least time over its kernels' device time in the
        traced stretch; None when none of its kernels ran."""
        if self.trace is None or self.traced is None:
            return None
        device_s = self.stage_seconds(stage)
        if device_s <= 0:
            return None
        _, work = self.manifest.stage(stage)
        least = sum(yardstick.least_seconds(*work.work(c.shape, self.config))
                    for c in self.traced.calls)
        return 100.0 * least / device_s


def stage_of(manifest: Manifest, name: str) -> str:
    """The stage whose kernel map matches a device operation, else
    "unmapped"."""
    for path in sorted(glob.glob(os.path.join(manifest.pkg, "stages",
                                              "*.json"))):
        stage = os.path.basename(path)[:-5]
        kmap, _ = manifest.stage(stage)
        if any(re.search(p, name) for p in kmap["kernels"]):
            return stage
    return "unmapped"


def short_name(name: str) -> str:
    """A device operation's name without its namespace, template arguments
    and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return (re.split(r"[<(]", name, maxsplit=1)[0].strip() or name)[:120]


def breakdown(manifest: Manifest, summary: Summary) -> dict:
    """The device operations that took most time (each named by its stage)
    and the idle seconds by what the host was doing, 10 of each."""
    ops = sorted(summary.seconds_by_name().items(), key=lambda kv: -kv[1])
    device_ops = [[f"{stage_of(manifest, n)}: {short_name(n)}", s]
                  for n, s in ops[:10]]
    idle = sorted(summary.idle_by_span().items(), key=lambda kv: -kv[1])
    return {"device_ops": device_ops, "idle_gaps": [[n, s] for n, s in
                                                     idle[:10]]}


def _memory_peak(devices: list[torch.device]) -> int:
    return max(torch.cuda.max_memory_allocated(d) for d in devices)


def judge(ent, calls: list[loop.Call], limits: dict) -> tuple[dict, bool]:
    """The entry's numbers for the sampled ``calls``, each beside its limit,
    and whether every one is within it (no call sampled: not correct)."""
    numbers = ent.check(calls) if calls else {}
    checks = {name: {"value": numbers.get(name, math.nan), "limit": limit}
              for name, limit in limits.items()}
    return checks, bool(calls) and all(c["value"] <= c["limit"]
                                       for c in checks.values())


def report(ctx: Context, trace: bool) -> dict:
    """The cell's ``end_to_end`` metrics, or with ``trace`` its
    ``per_layer`` ones, each that its reader finds."""
    metrics = {}
    for m in ctx.manifest.metrics(ctx.workload["name"],
                                  "per_layer" if trace else "end_to_end"):
        value = ctx.manifest.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float | None = None) -> dict:
    """Run ``workload`` once on the card(s); return the result line's
    object, whose last key ``checks`` holds the numbers compared."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = Manifest()
    cell = man.workload(workload)
    cfg = man.config(cell["config"])
    tr = man.traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    t_import = time.perf_counter()
    ent = man.entry(tr["entry"]).Entry(cfg, tr, seed, device)
    t_inputs = time.perf_counter()
    # an entry over several cards names them; its outputs are on the first
    devices = getattr(ent, "devices", [device])
    clock = loop.CudaClock(device, devices)
    ent.warm()
    clock.drain()
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    print(f"setup_s {setup_s:.3f}: imports {t_import - t_start:.3f}, "
          f"program and inputs {t_inputs - t_import:.3f}, warm-up "
          f"{t_warm - t_inputs:.3f}", file=sys.stderr)

    spans = loop.Spans()
    sample = loop.Reservoir(tr["check"]["sample_calls"],
                            np.random.default_rng([seed % (1 << 64), 1]))
    before = counters.launches()
    window = loop.run(ent.submit, clock, tr["in_flight"], seconds, spans,
                      on_complete=sample.offer)
    launched = counters.delta(before, counters.launches())
    summary = traced = None
    if trace:
        tracer = Tracer(sorted({d.index for d in devices}))
        spans.on = True
        with tracer.stretch():
            traced = loop.run(ent.submit, clock, tr["in_flight"],
                              tr["trace"]["seconds"], spans,
                              first=window.attempted,
                              max_calls=tr["trace"]["calls"])
        spans.on = False
        summary = tracer.summary()
    peak = _memory_peak(devices)
    failed = sum(loop.failed(f) for f in window.flags)

    ent.release()
    gc.collect()
    torch.cuda.empty_cache()
    checks, correct = judge(ent, sample.calls, tr["limits"])
    metrics = report(Context(man, cell, cfg, tr, setup_s, window, launched,
                             summary, traced), trace)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": len(set(devices)), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": window.attempted,
              "failed": int(failed), "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s()
        dev["window_s"] = summary.window_s
        result["breakdown"] = breakdown(man, summary)
    result["checks"] = checks
    return result
