"""The cell mel-towav-gl32 (configuration gomel-mel-fastgl32) driven through
the rest of a run on the CPU at a tiny cut of its traffic: the program
passes the check; the control (the bf16 reference in the program's place)
and each fault planted in the timed path fail it; its readers of the
program's Griffin-Lim spans and counters read nothing from a program
without them."""
import dataclasses
import json
import sys
import types

import pytest
import torch
from conftest import CPU_SEED, HostClock, drive

from gomel_tpu_torch.core.config import MelConfig
from gomel_tpu_torch.parallel import batch
from portbench import calibrate
from portbench.harness import cell
from portbench.harness.manifest import Manifest

CELL = "mel-towav-gl32"
CPU = torch.device("cpu")
# 3 rows of 1 s (35 frames) from 2 batches, the cell's codec and momentum
TINY = {"rows": 3, "clip_s": 1.0, "pool": 2}
# The end-to-end metrics the cell reports: the benchmark keeps them per cell,
# and this cell reports mel-encode-dev's pair, whose bounds (0.03 and 0.025)
# fit its spread; a pair of its own name needs a change to the benchmark's
# end-to-end list.
E2E = {"audio_s_per_s.mel-encode-dev", "call_p95_ms.mel-encode-dev",
       "setup_s"}


def tiny_traffic(man: Manifest) -> dict:
    tr = man.traffic(man.workload(CELL)["traffic"])
    tr.update(TINY)
    tr["trace"] = {"seconds": 0.2, "calls": 4}
    return tr


def run(patch=None):
    man = Manifest()
    return drive(man, CELL, tiny_traffic(man), patch=patch)


def test_configuration_is_towav_at_fast_griffin_lim_defaults():
    man = Manifest()
    cfg = man.config(man.workload(CELL)["config"])
    assert cfg["name"] == "gomel-mel-fastgl32"
    assert MelConfig(**cfg["codec"]) == dataclasses.replace(
        MelConfig.cli_default(), griffin_lim_iterations=32)
    assert cfg["gl_momentum"] == 0.99 and cfg["sample_rate_hz"] == 48000
    entry = next(c for c in man.bench["configs"]
                 if c["name"] == "gomel-mel-fastgl32")
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]


def test_program_is_correct():
    r = run()
    assert r.correct, r.checks
    assert r.window.attempted > 0
    assert all(bool(f.all()) for f in r.window.flags)
    assert set(cell.report(r.context, False)) == E2E
    shape = r.window.calls[0].shape
    assert shape == {"rows": 3, "frames": 35, "out_len": 4096 + 34 * 1280,
                     "iterations": 32, "out_bytes": 2}


def test_control_is_not_correct():
    man = Manifest()
    tr = tiny_traffic(man)
    ent = man.entry(tr["entry"]).Entry(man.config("gomel-mel-fastgl32"), tr,
                                       CPU_SEED, CPU)
    numbers = calibrate.control_numbers(ent, HostClock(),
                                        tr["check"]["sample_calls"])
    assert any(not numbers[k] <= v for k, v in tr["limits"].items()), numbers


def _plain_griffin_lim(ent, monkeypatch):
    ent.codec.gl_momentum = 0.0


def _one_iteration_fewer(ent, monkeypatch):
    c = ent.codec.config
    ent.codec.config = dataclasses.replace(
        c, griffin_lim_iterations=c.griffin_lim_iterations - 1)


def _row_keys_shifted(ent, monkeypatch):
    real = batch.row_keys
    monkeypatch.setattr(batch, "row_keys",
                        lambda seed, rows: real(seed, rows + 1)[1:])


FAULTS = [_plain_griffin_lim, _one_iteration_fewer, _row_keys_shifted]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
def test_fault_is_not_correct(fault, monkeypatch):
    r = run(patch=lambda ent: fault(ent, monkeypatch))
    assert not r.correct, r.checks
    assert r.checks["nonfinite_rows"]["value"] == 0


def test_nonfinite_row_is_not_correct():
    """A row the program flags non-finite fails the check by itself."""
    def flag_a_row(ent):
        real = ent.codec.decode_quantized

        def broken(*args, **kwargs):
            pcm, fin = real(*args, **kwargs)
            fin = fin.clone()
            fin[1] = False
            return pcm, fin
        ent.codec.decode_quantized = broken
    r = run(patch=flag_a_row)
    assert not r.correct
    assert r.checks["nonfinite_rows"]["value"] > 0
    assert r.checks["pcm_rms_rel"]["value"] <= \
        r.checks["pcm_rms_rel"]["limit"]


RECORD = {"spans": {"gomel.gl.iteration": {"count": 128, "total_s": 0.012,
                                           "self_s": 0.004}},
          "counters": {"gl_iterations.momentum": 124,
                       "gl_iterations.final": 4}}


@pytest.mark.parametrize("metric, value", [
    (f"gl_iter_host_ms.{CELL}", 3.0),
    (f"gl_momentum_iters_per_call.{CELL}", 31.0),
])
def test_readers_of_the_griffin_lim_record(monkeypatch, metric, value):
    reader = Manifest().reader(metric)
    ctx = types.SimpleNamespace(traced=types.SimpleNamespace(attempted=4),
                                trace=object())
    monkeypatch.setitem(sys.modules, "gomel_tpu_torch.utils.profiling",
                        types.SimpleNamespace(recorded=lambda: json.loads(
                            json.dumps(RECORD))))
    assert reader.read(ctx) == pytest.approx(value)
    monkeypatch.setitem(sys.modules, "gomel_tpu_torch.utils.profiling",
                        types.SimpleNamespace(recorded=lambda: {
                            "spans": {}, "counters": {}}))
    assert reader.read(ctx) is None


def test_cell_metrics_are_the_cells_own():
    """Its per-layer metrics are its own; its end-to-end ones are E2E."""
    man = Manifest()
    e2e = {m["name"] for m in man.metrics(CELL, "end_to_end")}
    assert e2e == E2E
    per_layer = {m["name"] for m in man.metrics(CELL, "per_layer")}
    assert per_layer == {f"{q}.{CELL}" for q in (
        "host_enqueue_ms", "launches_per_call", "wrapper_host_ms",
        "device_idle_pct", "copy_pct", "host_syncs_per_call", "sync_wait_ms",
        "gl_roofline", "gl_iter_host_ms", "gl_momentum_iters_per_call")}


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(card):
    """The control at the cell's own size on the card, three seeds."""
    man = Manifest()
    limits = man.traffic(man.workload(CELL)["traffic"])["limits"]
    for k in range(3):
        numbers = calibrate.control_at(CELL, CPU_SEED + k)
        assert any(not numbers[n] <= v for n, v in limits.items()), numbers
