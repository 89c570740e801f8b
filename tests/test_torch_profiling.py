"""The port's spans and counters (gomel_tpu_torch/utils/profiling.py): off
at the cost of a flag check, on while a torch profiler records, on the
profiler's timeline, one call id a call, self times, counters, and the
benchmark's readers of them (portbench/metrics)."""
import conftest  # noqa: F401  (forces CPU)

import json
import os
import sys
import tracemalloc
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gomel_tpu_torch.core.config import MelConfig, PhaseConfig
from gomel_tpu_torch.parallel.batch import BatchedMel, BatchedPhase
from gomel_tpu_torch.parallel.mesh import make_mesh
from gomel_tpu_torch.utils import profiling
from portbench.harness.manifest import Manifest

CPU = torch.device("cpu")
SMALL_MEL = MelConfig(window=256, resolut=1024, num_mels=32, mel_fmax=8000)


@pytest.fixture(autouse=True)
def _fresh_record():
    profiling.reset()
    yield
    profiling.reset()


def _mel_encode():
    BatchedMel(SMALL_MEL, device="cpu").encode(torch.randn(2, 256 * 20))


def _phase_round_trip():
    """An encode and a decode of the phase codec over a (2, 1) CPU mesh:
    the batch codecs' ingest per data block and their assembly."""
    mesh = make_mesh(data=2, frame=1, devices=[CPU] * 2)
    codec = BatchedPhase(PhaseConfig(), mesh=mesh, device="cpu")
    pcm = (torch.randn(2, 4096 * 4) * 1000).to(torch.int16)
    planes, mx, mn = codec.encode_quantized(pcm, np.array([3, 2]))
    codec.decode_quantized(planes, mx.numpy(), mn.numpy(), pcm16=True)


def _record_names(rec):
    return {name: s["count"] for name, s in rec["spans"].items()}


def test_no_profiler_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    _mel_encode()
    profiling.count("peer_bytes", 10)
    with profiling.sync("upload"):
        pass
    assert profiling.recorded() == {"spans": {}, "counters": {}}
    off = profiling.annotate("gomel.batch.encode")
    assert profiling.annotate("gomel.sync", kind="upload") is off
    assert profiling.sync("read_back") is off
    assert profiling.transfer(np.zeros(3), torch.device("cuda", 0)) is off


def _held_bytes(fn, n: int = 10_000) -> int:
    """Traced bytes still live after ``n`` calls of ``fn`` whose results
    are all kept: a new object a call would stay."""
    held = [None] * (2 * n)
    fn("gomel.op.stft_mel_log")
    fn("gomel.sync", kind="upload")
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        for i in range(n):
            held[2 * i] = fn("gomel.op.stft_mel_log")
            held[2 * i + 1] = fn("gomel.sync", kind="upload")
        after, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return after - before


def test_off_allocates_nothing_and_reads_no_clock(monkeypatch):
    def clock():
        raise AssertionError("a span read the clock with nothing recording")
    monkeypatch.setattr(profiling, "_clock", clock)
    with profiling.annotate("gomel.batch.encode"):
        with profiling.annotate("gomel.sync", kind="upload"):
            pass
    _mel_encode()
    # a fresh object a call would hold 16 bytes or more each
    assert _held_bytes(profiling.annotate) < 1024
    assert _held_bytes(lambda name, **attrs: object()) > 16 * 10_000


def test_spans_lie_on_the_profiler_timeline_inside_the_caller():
    """As portbench/harness/trace.Tracer starts it: the program's spans are
    CPU events of the profiler, inside the caller's range, with the names
    and counts of ``recorded()``."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert torch.autograd.profiler._is_profiler_enabled
        with record_function("pb.caller"):
            _mel_encode()
            _phase_round_trip()
    finally:
        prof.stop()
    assert not torch.autograd.profiler._is_profiler_enabled
    events = list(prof.events())
    caller = next(e for e in events if e.name == "pb.caller")
    ours = [e for e in events if e.name.startswith("gomel.")]
    assert ours
    for e in ours:
        assert caller.time_range.start <= e.time_range.start
        assert e.time_range.end <= caller.time_range.end
    seen: dict = {}
    for e in ours:
        seen[e.name] = seen.get(e.name, 0) + 1
    rec = profiling.recorded()
    assert seen == _record_names(rec)
    assert {"gomel.batch.encode", "gomel.batch.encode_quantized",
            "gomel.batch.decode_quantized", "gomel.rows.ingest",
            "gomel.rows.assemble"} <= set(seen)
    # the encode's ingest; on the mesh, per call one for the padding and
    # one a data block
    assert seen["gomel.rows.ingest"] == 1 + 2 * (1 + 2)
    # the record's self times add up to the API spans' inclusive times
    api = sum(s["total_s"] for name, s in rec["spans"].items()
              if name.startswith("gomel.batch."))
    assert sum(s["self_s"] for s in rec["spans"].values()) == \
        pytest.approx(api, rel=1e-9, abs=1e-9)


class _Ranges:
    """A stand-in for the profiler's range: keeps each range's name, its
    keyword values and the name of the range open around it."""

    def __init__(self):
        self.seen, self.open = [], []

    def __call__(self, name, inputs=(), args=None):
        ranges = self

        class Range:
            def __enter__(self):
                ranges.seen.append((name, args, ranges.open[-1]
                                    if ranges.open else None))
                ranges.open.append(name)

            def __exit__(self, *exc):
                ranges.open.pop()
        return Range()


def test_every_span_of_a_call_carries_its_call_id_and_parent(monkeypatch):
    ranges = _Ranges()
    monkeypatch.setattr(profiling, "_record_function", ranges)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    _phase_round_trip()
    assert [n for n, _, p in ranges.seen if p is None] == [
        "gomel.batch.encode_quantized", "gomel.batch.decode_quantized"]
    calls = []
    for name, a, parent in ranges.seen:
        if parent is None:
            assert "parent" not in a
            calls.append(a["call"])
        else:
            assert a["parent"] == parent
            assert a["call"] == calls[-1]
    assert len(set(calls)) == 2
    assert len(ranges.seen) > 2


def test_self_time_is_the_duration_less_the_children(monkeypatch):
    ticks = iter([0, 10, 15, 40, 100, 100, 130, 200])
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    monkeypatch.setattr(profiling, "_record_function", _Ranges())
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    # outer [0, 200): a [10, 100) holding b [15, 40); c [100, 130)
    with profiling.annotate("outer"):
        with profiling.annotate("a"):
            with profiling.annotate("b"):
                pass
        with profiling.annotate("c"):
            pass
    spans = profiling.recorded()["spans"]
    ns = {k: (v["count"], round(v["total_s"] * 1e9), round(v["self_s"] * 1e9))
          for k, v in spans.items()}
    assert ns == {"outer": (1, 200, 200 - 90 - 30), "a": (1, 90, 90 - 25),
                  "b": (1, 25, 25), "c": (1, 30, 30)}


def test_count_reset_and_device_trace_resets_on_entry(tmp_path, monkeypatch):
    profiling.count("peer_bytes", 7)
    assert profiling.recorded()["counters"] == {}
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    profiling.count("peer_bytes", 7)
    profiling.count("peer_bytes")
    with profiling.sync("upload"):
        pass
    rec = profiling.recorded()
    assert rec["counters"] == {"peer_bytes": 8, "host_syncs.upload": 1}
    assert rec["spans"]["gomel.sync"]["count"] == 1
    profiling.reset()
    assert profiling.recorded() == {"spans": {}, "counters": {}}
    profiling.count("host_syncs.read_back", 3)
    monkeypatch.undo()
    with profiling.device_trace(str(tmp_path / "trace")):
        assert profiling.recorded() == {"spans": {}, "counters": {}}
        _mel_encode()
    assert _record_names(profiling.recorded()) == {
        "gomel.batch.encode": 1, "gomel.rows.ingest": 1}


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on card 1 (only ``transfer`` reads
    its device)."""

    @property
    def device(self):
        return torch.device("cuda", 1)


def test_transfer_names_uploads_read_backs_and_peer_copies(monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    card1 = torch.Tensor._make_subclass(_OnCard, torch.empty(6))
    for src, dst in ((torch.ones(3), CPU), (np.ones(3), CPU),
                     (card1, torch.device("cuda", 1))):
        with profiling.transfer(src, dst):
            pass
    assert profiling.recorded() == {"spans": {}, "counters": {}}
    with profiling.transfer(np.ones(3), torch.device("cuda", 0)):
        pass
    with profiling.transfer(torch.ones(3), torch.device("cuda", 0)):
        pass
    with profiling.transfer(card1, CPU):
        pass
    with profiling.transfer(card1, torch.device("cuda", 0)):
        pass
    rec = profiling.recorded()
    assert rec["counters"] == {"host_syncs.upload": 2,
                               "host_syncs.read_back": 1, "peer_bytes": 24}
    assert rec["spans"]["gomel.sync"]["count"] == 3


STAND_IN = {
    "spans": {
        "gomel.batch.encode": {"count": 4, "total_s": 0.004, "self_s": 0.001},
        "gomel.op.stft_mel_log": {"count": 4, "total_s": 0.0012,
                                  "self_s": 0.0008},
        "gomel.op.quantize_planes_masked": {"count": 4, "total_s": 0.0004,
                                            "self_s": 0.0004},
        "gomel.sync": {"count": 12, "total_s": 0.0024, "self_s": 0.0024},
        "gomel.mesh.scatter": {"count": 4, "total_s": 0.0002,
                               "self_s": 0.0001},
        "gomel.halo.pull": {"count": 8, "total_s": 0.0004, "self_s": 0.0003},
    },
    "counters": {"host_syncs.upload": 8, "host_syncs.read_back": 4,
                 "peer_bytes": 2_000_000},
}


@pytest.mark.parametrize("metric, value", [
    ("host_syncs_per_call.phase-roundtrip-dev", 3.0),
    ("sync_wait_ms.mel-longform-4card", 0.6),
    ("wrapper_host_ms.mel-encode-dev", 0.3),
    ("mesh_host_ms.mel-longform-4card", 0.1),
    ("peer_mb_per_call", 0.5),
])
def test_readers_of_the_record(monkeypatch, metric, value):
    """Each reader divides the record by the traced stretch's submitted
    calls; a count of 0 reads 0; no trace, or a program without the
    record (the parent of this change), reads nothing."""
    reader = Manifest().reader(metric)
    stand_in = types.SimpleNamespace(recorded=lambda: json.loads(
        json.dumps(STAND_IN)))
    monkeypatch.setitem(sys.modules, "gomel_tpu_torch.utils.profiling",
                        stand_in)
    traced = types.SimpleNamespace(attempted=4)
    assert reader.read(types.SimpleNamespace(traced=traced, trace=object())
                       ) == pytest.approx(value)
    assert reader.read(types.SimpleNamespace(traced=None, trace=None)) is None
    empty = types.SimpleNamespace(recorded=lambda: {"spans": {},
                                                    "counters": {}})
    monkeypatch.setitem(sys.modules, "gomel_tpu_torch.utils.profiling",
                        empty)
    assert reader.read(types.SimpleNamespace(traced=traced,
                                             trace=object())) == 0
    monkeypatch.setitem(sys.modules, "gomel_tpu_torch.utils.profiling",
                        types.SimpleNamespace())
    assert reader.read(types.SimpleNamespace(traced=traced,
                                             trace=object())) is None


def test_every_new_reader_is_in_the_manifest():
    names = {m["name"] for m in Manifest().bench["per_layer"]}
    for quantity in ("host_syncs_per_call", "sync_wait_ms",
                     "wrapper_host_ms", "mesh_host_ms", "peer_mb_per_call"):
        assert any(n.split(".", 1)[0] == quantity for n in names)
        assert os.path.exists(Manifest().reader_path(quantity))
