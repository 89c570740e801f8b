"""The long-form serving artifacts over processes, on the CPU: gloo groups
of real processes.

The ``serve_1x4`` and ``serve_2x2`` scenarios of tests/torch_mp_worker.py
(torch and the port only) build the four long-form builders' artifacts
(the mel decoder twice: exact, and ``interior_mm`` with momentum 0.99) on a
mesh that spans the processes: 1 x 4 over 2 and over 4 processes, 2 x 2
over 2 (the data axis across processes). Each worker calls them, runs the
eager sharded functions beside them, saves them (rank 0) and loads and
calls them again, then runs the artifacts another process or group saved.
This process holds every process's shards bit-equal to the port's artifact
on a CPU mesh of the same shape in one process (its single program), and
assembled within tests/test_torch_serving.py's bounds (``assert_near``) of
the JAX package's ``call_longform`` on a JAX mesh of the same shape
(tests/conftest.py's eight virtual CPU devices). One worker set runs for
each layout, each with its own time limit and free port.
"""
import conftest  # noqa: F401  (forces CPU, 8 virtual devices)

import os

import jax
import numpy as np
import pytest
import torch

import torch_mp_worker as W
from gomel_tpu import MelConfig as JMelConfig
from gomel_tpu import PhaseConfig as JPhaseConfig
from gomel_tpu import serving as js
from gomel_tpu.parallel.mesh import make_mesh as jmake_mesh
from gomel_tpu_torch import make_mesh
from gomel_tpu_torch import serving as ts
from test_torch_multiprocess import _check_bits_and_assemble, _finish, _start
from test_torch_serving import assert_near

CPU = torch.device("cpu")
SHAPES = ((1, 4), (2, 2))
# layout -> (scenario, processes, mesh shape)
LAYOUTS = {"1x4-over-2": ("serve_1x4", 2, (1, 4)),
           "1x4-over-4": ("serve_1x4", 4, (1, 4)),
           "2x2-over-2": ("serve_2x2", 2, (2, 2))}
# the bound of each artifact's output against JAX (tests/test_torch_serving
# .py's BOUNDS of the long-form builders)
BOUND = {"mel-enc": "logmel", "mel-dec": "f32", "mel-dec-mm": "f32",
         "phase-enc": "f32", "phase-dec": "sharded_decode"}
CASES = [(layout, name) for layout in LAYOUTS for name in W.SV_NAMES]


def _case_id(case) -> str:
    return "-".join(case)


def _jax_call(name, shape):
    """JAX's ``call_longform`` of builder ``name`` (its own defaults: exact
    float32 off the TPU) on a JAX mesh of ``shape``."""
    jm = jmake_mesh(data=shape[0], frame=shape[1], devices=jax.devices()[:4])
    kw = dict(n_frames=W.SV_FRAMES[name], batch=2, platforms=("cpu",))
    mel = JMelConfig(**{k: getattr(W.SV_MEL, k) for k in (
        "num_mels", "resolut", "window", "griffin_lim_iterations")})
    phase = JPhaseConfig(**{k: getattr(W.SV_PHASE, k) for k in (
        "sample_rate", "resolut", "window", "num_freqs", "volume_boost")})
    if name == "mel-enc":
        exp = js.export_longform_mel_encoder(mel, jm, **kw)
    elif name == "phase-enc":
        exp = js.export_longform_phase_encoder(phase, jm, **kw)
    elif name == "phase-dec":
        exp = js.export_longform_phase_decoder(phase, jm, **kw)
    else:
        exp = js.export_longform_mel_decoder(
            mel, jm, momentum=W.SV_MOMENTUM[name], **kw)
    return np.asarray(js.call_longform(exp, jm, *W.sv_inputs(name, shape)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every worker set at once: 1 x 4 over 2 processes and 2 x 2 over 2
    load the one-process artifacts this process then builds on a CPU mesh
    of each shape and saves, 1 x 4 over 4 loads what the 2-process 1 x 4
    group saved (each waits for its folder's ``COMPLETE`` marker); JAX's
    results are made while they run."""
    base = tmp_path_factory.mktemp("serving_mp")

    def folder(name):
        os.makedirs(base / name)
        return str(base / name)
    one_dir = {shape: folder(f"one_{shape[0]}x{shape[1]}")
               for shape in SHAPES}
    out = {layout: folder(f"out_{layout}") for layout in LAYOUTS}
    saved = {layout: folder(f"saved_{layout}") for layout in LAYOUTS}
    procs = {}
    for layout, (scenario, world, shape) in LAYOUTS.items():
        load = (saved["1x4-over-2"] if layout == "1x4-over-4"
                else one_dir[shape])
        procs[layout] = _start(scenario, world, out[layout], saved[layout],
                               load)
    one = {}
    for shape in SHAPES:
        mesh = make_mesh(data=shape[0], frame=shape[1], devices=[CPU] * 4)
        for name in W.SV_NAMES:
            exp = W.sv_build(name, mesh)
            ts.save_exported(exp, os.path.join(one_dir[shape], name))
            one[shape, name] = ts.call_longform(
                exp, mesh, *W.sv_inputs(name, shape)).gather()
        open(os.path.join(one_dir[shape], "COMPLETE"), "w").close()
    jax_out = {(shape, name): _jax_call(name, shape)
               for shape in SHAPES for name in W.SV_NAMES}
    ranks = {layout: _finish(p, out[layout]) for layout, p in procs.items()}
    return ranks, one, jax_out, saved


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_each_process_owns_its_cells(runs, layout):
    world = LAYOUTS[layout][1]
    per = 4 // world
    assert [r["local"].tolist() for r in runs[0][layout]] == [
        list(range(r * per, (r + 1) * per)) for r in range(world)]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_shards_bit_equal_to_one_process_and_eager(runs, case):
    """The artifact built on the mesh over processes, the same saved by
    rank 0 and loaded by every rank, and the eager sharded functions over
    the processes: each process's shards bit-equal to the one-process
    artifact's (its single program on a CPU mesh of the same shape), every
    element held by exactly one process."""
    layout, name = case
    ranks, one = runs[0][layout], runs[1][LAYOUTS[layout][2], name]
    for tag in ("built", "loaded", "eager"):
        _check_bits_and_assemble(ranks, f"{tag}:{name}", one)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_assembled_within_bounds_of_jax(runs, case):
    """The shards of every process assembled: within tests/test_torch_
    serving.py's bound of the JAX package's call_longform on a JAX mesh of
    the same shape."""
    layout, name = case
    shape = LAYOUTS[layout][2]
    got = _check_bits_and_assemble(runs[0][layout], f"built:{name}",
                                   runs[1][shape, name])
    assert_near(BOUND[name], got, runs[2][shape, name])


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[0] != "1x4-over-4"], ids=_case_id)
def test_one_process_artifact_runs_over_processes(runs, case):
    """An artifact built and saved in one process (its single program and
    its pieces) loaded by every process of a group and run over the
    processes: its pieces give the single program's bits."""
    layout, name = case
    _check_bits_and_assemble(runs[0][layout], f"foreign:{name}",
                             runs[1][LAYOUTS[layout][2], name])


@pytest.mark.parametrize("name", W.SV_NAMES)
def test_artifact_saved_by_one_group_runs_in_another(runs, name):
    """Saved by rank 0 of the 2-process group (its pieces alone), loaded by
    a fresh group of 4 processes on the same 1 x 4 shape: the same bits."""
    _check_bits_and_assemble(runs[0]["1x4-over-4"], f"foreign:{name}",
                             runs[1][(1, 4), name])


@pytest.mark.parametrize("name", W.SV_NAMES)
def test_group_artifact_runs_in_one_process(runs, name):
    """An artifact a group built on a mesh over processes holds no single
    program: its header has the one-process artifact's shapes and a
    ``tables`` section, and in one process on a CPU mesh its pieces give
    the single program's bits."""
    path = os.path.join(runs[3]["1x4-over-2"], name)
    exp = ts.load_exported(path)
    assert exp.program is None
    meta = ts.read_artifact_meta(path)
    assert [s[0] for s in meta["sections"]][0] == "tables"
    mesh = make_mesh(data=1, frame=4, devices=[CPU] * 4)
    single = W.sv_build(name, mesh)
    for key in ("in_shapes", "in_dtypes", "out_shapes"):
        assert meta[key] == getattr(single, key), key
    got = ts.call_longform(exp, mesh, *W.sv_inputs(name, (1, 4))).gather()
    assert torch.equal(got, runs[1][(1, 4), name])
    with pytest.raises(ValueError, match="holds no single program"):
        exp.module()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_other_shape_and_batch_are_refused(runs, layout):
    """A mesh over the processes of another (data, frame) shape, and a
    batch of 3 rows, raise in every process."""
    want = str(LAYOUTS[layout][2])
    for r in runs[0][layout]:
        assert f"exported for a {want}" in str(r["refused_shape"])
        assert ("does not split" in str(r["refused_batch"])
                or "the artifact takes" in str(r["refused_batch"]))


def test_export_refuses_a_batch_the_data_axis_does_not_divide(runs):
    for r in runs[0]["2x2-over-2"]:
        assert "multiple of the mesh's data axis" in str(r["refused_export"])


def test_pieces_move_to_another_device():
    """A piece runs on another device of the artifact's type as a copy
    moved there: on the meta device here, every device the graph names is
    the new one and the KP key fold runs."""
    mesh = make_mesh(data=1, frame=4, devices=[CPU] * 4)
    lf = W.sv_build("mel-dec", mesh).longform
    meta = torch.device("meta")
    for key in lf.keys:
        graph = lf._module(key, meta)[0].graph
        named = {str(n.kwargs["device"]) for n in graph.nodes
                 if "device" in n.kwargs}
        assert named <= {"meta"}, (key, named)
    keys = lf._run("fold", torch.zeros(2, dtype=torch.int32, device=meta))
    assert keys.device == meta and tuple(keys.shape) == (4, 2)
