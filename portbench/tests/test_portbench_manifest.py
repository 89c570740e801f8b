"""BENCHMARK.json and the files it names, against the benchmark's rules:
key sets, names, units, lengths, bounds, and that every named file is
there."""
import json
import os
import re

import pytest

from portbench.harness.manifest import PKG, ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and os.path.isdir(os.path.join(ROOT, p))
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and _line(cfg["source"])
    assert _line(cfg["why"]) and len(cfg["reduced"]) <= 16
    assert any(cfg["file"].startswith(p + "/") for p in BENCH["paths"])
    body = json.load(open(os.path.join(ROOT, cfg["file"])))
    assert body["name"] == cfg["name"] and "codec" in body
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload(cell):
    man = Manifest()
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    traffic = man.traffic(cell["traffic"])
    assert os.path.exists(os.path.join(PKG, "entries",
                                       traffic["entry"] + ".py"))
    e2e = [m["name"] for m in man.metrics(cell["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert man.metrics(cell["name"], "per_layer")
    assert traffic["limits"] and traffic["check"]["sample_calls"] >= 1


def test_unique_names_and_pairs():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert os.path.exists(Manifest().reader_path(m["name"]))


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    assert _line(m["layer"])
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in m.get("workloads", cells):
        assert w in cells
        assert "workloads" not in e2e[m["moves"]] or \
            w in e2e[m["moves"]]["workloads"]
    assert os.path.exists(Manifest().reader_path(m["name"]))
    quantity = m["name"].split(".", 1)[0]
    if quantity.endswith("_roofline"):
        stage = quantity[:-len("_roofline")]
        assert m["unit"] == "%"
        for ext in (".json", ".py"):
            assert os.path.exists(os.path.join(PKG, "stages", stage + ext))


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for layer in layers:
        assert layer == layer.strip()


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_a_cells_share_lists_that_cell_alone(m):
    """``<quantity>.<cell>`` names one cell's share of a quantity: it lists
    that cell and no other, and moves (or is) one of that cell's own."""
    cells = {w["name"] for w in BENCH["workloads"]}
    suffix = m["name"].split(".", 1)[-1]
    if suffix in cells:
        assert m["workloads"] == [suffix]
        if "moves" in m:
            assert m["moves"].endswith("." + suffix)
