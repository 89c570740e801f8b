"""The benchmark's own tests: run on the CPU (the port's plain versions);
tests marked ``cuda`` need the card and skip without one."""
import dataclasses
import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# tiny traffic of each cell for runs on the CPU
TINY = {
    "mel-encode-dev": {"rows": 2, "clip_s": 1.0, "pool": 2},
    "phase-roundtrip-dev": {"rows": 2, "clip_s": 1.0, "pool": 2},
    "mel-longform-4card": {"file_s": 3.0, "files": 1},
}
CPU_SEED = 2_147_483_659
CPU_WINDOW_S = 600.0   # far past the few calls a CPU run makes


class HostClock:
    """The CPU path's clock: every call is done when it returns."""

    def submitted(self):
        return time.perf_counter()

    done = submitted

    def wait(self, e) -> None:
        pass

    @staticmethod
    def latency_ms(start, end) -> float:
        return (end - start) * 1e3

    def drain(self) -> None:
        pass


@dataclasses.dataclass
class CpuRun:
    """What ``drive`` returns: the pieces of a run that ``harness/cell.run``
    puts together on the card."""
    ent: object
    window: object
    checks: dict
    correct: bool
    context: object


def drive(manifest, workload: str, traffic: dict, seed: int = CPU_SEED,
          calls: int = 4, patch=None) -> CpuRun:
    """A run of ``workload`` on the CPU at ``traffic``'s size, the card's
    look and clock left out: ``calls`` entry calls in the harness's loop
    (a count, not a window, so a slow host still completes them), the
    sampled calls judged, and the context its metric readers read.
    ``patch(entry)`` breaks the timed path before the loop."""
    import torch

    from portbench.harness import cell, loop
    w = manifest.workload(workload)
    cfg = manifest.config(w["config"])
    ent = manifest.entry(traffic["entry"]).Entry(cfg, traffic, seed,
                                                    torch.device("cpu"))
    if patch is not None:
        patch(ent)
    ent.warm()
    sample = loop.Reservoir(traffic["check"]["sample_calls"],
                            np.random.default_rng([seed, 1]))
    window = loop.run(ent.submit, HostClock(), traffic["in_flight"],
                      CPU_WINDOW_S, loop.Spans(), max_calls=calls,
                      on_complete=sample.offer)
    ent.release()
    checks, correct = cell.judge(ent, sample.calls, traffic["limits"])
    ctx = cell.Context(manifest, w, cfg, traffic, 0.0, window, {})
    return CpuRun(ent, window, checks, correct, ctx)


@pytest.fixture
def tiny():
    """``tiny(manifest, workload)``: the cell's traffic cut to a CPU run."""
    def traffic(manifest, workload: str) -> dict:
        tr = manifest.traffic(manifest.workload(workload)["traffic"])
        tr.update(TINY[workload])
        tr["trace"] = {"seconds": 0.2, "calls": 4}
        return tr
    return traffic
