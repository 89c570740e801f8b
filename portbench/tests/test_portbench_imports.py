"""What the benchmark may load: never JAX or the JAX package (compared by
whole top-level name, so ``gomel_tpu_torch`` is not ``gomel_tpu``), and
nothing of the program in the reference."""
import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import run as run_py
from portbench.harness.manifest import PKG, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gomel_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(top):
    for base, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


@pytest.mark.parametrize("path", sorted(_sources(PKG)),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted(_sources(os.path.join(PKG, "reference"))),
    ids=lambda p: os.path.relpath(p, PKG))
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & (FORBIDDEN | {"gomel_tpu_torch"})


def test_forbidden_modules_compares_whole_top_level_names():
    fake = ["gomel_tpu_torch", "gomel_tpu_torch.ops", "gomel_tpux", "jaxfoo",
            "gomel_tpu", "gomel_tpu.ops", "jax.numpy"]
    saved = {n: sys.modules.get(n) for n in fake}
    try:
        for n in fake:
            sys.modules.setdefault(n, object())
        found = run_py.forbidden_modules()
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
    assert "gomel_tpu" in found and "gomel_tpu.ops" in found
    assert "jax.numpy" in found
    assert not {"gomel_tpu_torch", "gomel_tpu_torch.ops", "gomel_tpux",
                "jaxfoo"} & set(found)


CHILD = """
import json, sys, torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from portbench import calibrate, run
from portbench.harness import cell
from portbench.harness.manifest import Manifest
from conftest import TINY, drive
man = Manifest()
for w in TINY:
    tr = man.traffic(man.workload(w)["traffic"])
    tr.update(TINY[w])
    r = drive(man, w, tr, seed=5, calls=2)
    cell.report(r.context, False)
    cell.report(r.context, True)
print(json.dumps(run.forbidden_modules()))
"""


def test_a_run_loads_no_forbidden_module():
    code = CHILD.format(root=ROOT, tests=os.path.dirname(__file__))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_without_a_card_exits_1_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mel-encode-dev",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 1 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr
