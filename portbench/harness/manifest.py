"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the checkout's root lists the cells. Everything that
belongs to one configuration, traffic mix, entry, metric or stage
sits in a file of its own under ``portbench/``, found by its name:

- ``configs/<config>.json`` (the manifest's ``file``): the codec's widths;
- ``traffic/<traffic>.json``: the mix's parameters, the ``entry`` that
  plays it and the ``limits`` of the numbers its check compares;
- ``entries/<entry>.py``: the entry calls, their inputs and the check;
- ``metrics/<metric>.py``: ``read(ctx)``, the metric's value or None; a
  metric ``<quantity>.<cell>`` (one cell's share of a quantity, with a
  bound or an end-to-end metric of its own) reads with
  ``metrics/<quantity>.py`` unless it has a file of its own;
- ``stages/<stage>.json`` + ``stages/<stage>.py``: a roofline stage's
  kernels and its work formula.

A later cell or metric is added by adding such files and manifest entries.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the Python file at ``path`` as module ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def _tag(kind: str, name: str, pkg: str) -> str:
    safe = "".join(c if c.isalnum() else "_" for c in name)
    return f"portbench_{kind}_{safe}_{abs(hash(pkg)) % 10**8}"


class Manifest:
    """``BENCHMARK.json`` of the checkout whose benchmark folder is
    ``pkg`` (default: this one)."""

    def __init__(self, pkg: str = PKG):
        self.pkg = pkg
        self.root = os.path.dirname(pkg)
        self.bench = load_json(os.path.join(self.root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{[w['name'] for w in self.bench['workloads']]})")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.pkg, "traffic", name + ".json"))

    def entry(self, name: str):
        return load_module(os.path.join(self.pkg, "entries", name + ".py"),
                           _tag("entry", name, self.pkg))

    def metrics(self, workload: str, section: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a workload reports:
        those that list it, and those that list no workloads."""
        return [m for m in self.bench[section]
                if "workloads" not in m or workload in m["workloads"]]

    def reader_path(self, metric: str) -> str:
        """The reader of ``metric``: its own file, else its quantity's (the
        name before the first dot)."""
        own = os.path.join(self.pkg, "metrics", metric + ".py")
        if os.path.exists(own):
            return own
        return os.path.join(self.pkg, "metrics",
                            metric.split(".", 1)[0] + ".py")

    def reader(self, metric: str):
        path = self.reader_path(metric)
        return load_module(path, _tag("metric", os.path.basename(path)[:-3],
                                      self.pkg))

    def stage(self, name: str) -> tuple[dict, object]:
        """(the stage's kernel map, its work module)."""
        base = os.path.join(self.pkg, "stages", name)
        return (load_json(base + ".json"),
                load_module(base + ".py", _tag("stage", name, self.pkg)))
