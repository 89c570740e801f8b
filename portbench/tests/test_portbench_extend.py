"""A new cell and a new per-layer metric are taken up from added files
alone: a copy of the benchmark gains a traffic file, a metric reader and
their manifest entries, and a run of the new cell reports the new metric."""
import json
import os
import shutil

from conftest import drive

from portbench.harness import cell
from portbench.harness.manifest import PKG, ROOT, Manifest

READER = '''"""Calls completed in the window (a test's metric)."""


def read(ctx):
    return len(ctx.window.calls)
'''


def test_added_cell_and_metric_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    traffic = json.load(open(os.path.join(
        PKG, "traffic", "encode-dev-64x10s.json")))
    traffic.update({"rows": 1, "clip_s": 0.5, "pool": 1,
                    "trace": {"seconds": 0.1, "calls": 2}})
    (root / "portbench" / "traffic" / "encode-tiny.json").write_text(
        json.dumps(traffic))
    (root / "portbench" / "metrics" / "calls_done.py").write_text(READER)
    bench["workloads"].append({"name": "mel-encode-tiny",
                               "config": "gomel-mel-cli",
                               "traffic": "encode-tiny", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "calls_done", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "batch codecs and op wrappers",
                               "moves": "audio_s_per_s.mel-encode-tiny",
                               "workloads": ["mel-encode-tiny"]})
    # a new cell's share of a quantity reads with the quantity's reader
    bench["end_to_end"].append({"name": "audio_s_per_s.mel-encode-tiny",
                                "unit": "audio-s/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["mel-encode-tiny"]})
    bench["per_layer"].append({"name": "host_enqueue_ms.mel-encode-tiny",
                               "unit": "ms", "better": "lower",
                               "source": "host_clock",
                               "layer": "batch codecs and op wrappers",
                               "moves": "audio_s_per_s.mel-encode-tiny",
                               "workloads": ["mel-encode-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    man = Manifest(str(root / "portbench"))
    assert man.workload("mel-encode-tiny")["traffic"] == "encode-tiny"
    r = drive(man, "mel-encode-tiny", man.traffic("encode-tiny"), seed=9,
              calls=2)
    assert r.correct, r.checks
    assert set(cell.report(r.context, False)) == {
        "audio_s_per_s.mel-encode-tiny", "setup_s"}
    per_layer = cell.report(r.context, True)
    assert set(per_layer) == {"calls_done", "host_enqueue_ms.mel-encode-tiny"}
    assert per_layer["calls_done"]["value"] >= 1
