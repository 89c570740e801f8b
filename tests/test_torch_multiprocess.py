"""The port's multi-process form on the CPU: gloo groups of real processes.

Each scenario of tests/torch_mp_worker.py runs in 2 or 4 worker processes
(torch and the port only), each on its own shards of a mesh that spans the
processes, with the halos between processes over ``batch_isend_irecv``.
This process makes the same seeded inputs and holds every process's shards
bit-equal to the port on one controller (a mesh of the same shape over CPU
entries) and, assembled, within the tolerances of
tests/test_torch_longform.py and tests/test_torch_batch.py against the JAX
package on a JAX mesh of the same shape (tests/conftest.py's eight virtual
CPU devices). Every worker set has its own time limit; free ports come from
this process.
"""
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mp_worker as W
from gomel_tpu.core.config import MelConfig as JMelConfig
from gomel_tpu.core.config import PhaseConfig as JPhaseConfig
from gomel_tpu.parallel import batch as jbatch
from gomel_tpu.parallel import mesh as jmesh
from gomel_tpu.parallel import sharded as jsh
from gomel_tpu.pipelines import longform as jlf
from gomel_tpu_torch.io import _native
from gomel_tpu_torch.parallel import mesh as pm
from gomel_tpu_torch.parallel.batch import BatchedMel
from gomel_tpu_torch.pipelines import longform as tlf
from gomel_tpu_torch import LongFormMel, LongFormPhase

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_mp_worker.py")
TIMEOUT_S = 120
CPU = torch.device("cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(scenario: str, world: int, out_dir: str, *extra: str) -> list:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["GLOO_SOCKET_IFNAME"] = "lo"
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, WORKER, scenario, str(r), str(world), port, out_dir,
         *extra], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=REPO) for r in range(world)]


def _finish(procs: list, out_dir: str) -> list[dict]:
    """Wait for every worker (TIMEOUT_S each), fail on any non-zero exit,
    and load each rank's arrays."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = []
    for r in range(len(procs)):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _pieces(ranks: list[dict], name: str) -> list:
    """[(rank, (rows, cols), array)] of result ``name`` in every rank."""
    out = []
    for r, arrays in enumerate(ranks):
        for key, value in arrays.items():
            head, _, where = key.partition("|")
            if head != name or where == "finite":
                continue
            (r0, r1), (c0, c1) = (tuple(int(v) for v in p.split("-"))
                                  for p in where.split(","))
            out.append((r, (slice(r0, r1), slice(c0, c1)), value))
    return out


def _whole(value) -> np.ndarray:
    """A one-controller result as a host array."""
    if isinstance(value, tuple):
        value = value[0]
    return (value.gather() if isinstance(value, pm.Sharded) else value
            ).numpy()


def _check_bits_and_assemble(ranks, name, one) -> np.ndarray:
    """Every rank's pieces of ``name`` bit-equal to the one-controller
    ``one``; returns the pieces assembled (each element exactly once)."""
    full = _whole(one)
    got = np.zeros_like(full)
    seen = np.zeros(full.shape[:2], np.int64)
    for _, index, value in _pieces(ranks, name):
        np.testing.assert_array_equal(value, full[index], err_msg=name)
        got[index] = value
        seen[index] += 1
    assert (seen == 1).all(), name
    if isinstance(one, tuple):
        for arrays in ranks:
            np.testing.assert_array_equal(arrays[f"{name}|finite"],
                                          one[1].numpy())
    return got


def _peak_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _pcm_near(pcm, wave, tol):
    """int16 samples within ``tol`` of a float wave, in LSB units of its
    PCM-16 scale (the float tolerance times 32768, plus the rounding)."""
    want = np.clip(np.rint(np.asarray(wave, np.float64) * 32768.0),
                   -32768, 32767)
    assert np.abs(pcm.astype(np.float64) - want).max() <= tol * 32768 + 1


# -- two processes, a 1 x 4 mesh -----------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The ``pair`` scenario in 2 processes, and the same calls on one
    controller over make_mesh(data=1, frame=4, devices=[cpu] * 4)."""
    out_dir = str(tmp_path_factory.mktemp("pair"))
    procs = _start("pair", 2, out_dir)
    inp = W.inputs()
    mesh = pm.make_mesh(data=1, frame=4, devices=[CPU] * 4)
    one = {**W.sharded_items(mesh, inp), **W.longform_items(mesh, inp)}
    lp = LongFormPhase(W.phase_config(), mesh)
    one["lf_phase_roundtrip"] = lp.decode(lp.encode(inp["audio"]))
    return _finish(procs, out_dir), one, inp


@pytest.fixture(scope="module")
def jax_mesh_1x4():
    return jmesh.make_mesh(data=1, frame=4, devices=jax.devices()[:4])


def test_pair_owns_two_frame_shards_each(pair):
    ranks, _, _ = pair
    assert [r["local"].tolist() for r in ranks] == [[0, 1], [2, 3]]


def _jax_sharded(name, inp, jm):
    """The JAX program of sharded item ``name`` (a float result)."""
    p = jsh.plan_frame_sharding(W.FRAMES, W.FRAME_LEN, W.HOP, W.N_SHARDS)
    if name in ("stft_re", "stft_im"):
        re, im = jsh.sharded_stft_fn(jm, p)(jnp.asarray(inp["x"]))
        return re if name == "stft_re" else im
    if name == "istft":
        return jsh.sharded_istft_fn(jm, p)(jnp.asarray(inp["spec"]))
    if name == "phase_encode":
        return jsh.sharded_phase_encode_fn(jm, p, W.NUM_FREQS)(
            jnp.asarray(inp["x"]))
    if name.startswith("phase_decode"):
        return jsh.sharded_phase_decode_fn(jm, p, 1.5)(
            jnp.asarray(inp["spec2"]))
    n_iter, mom, final, _ = W.GL_CASES[name]
    return jsh.sharded_griffin_lim_fn(jm, p, n_iter, momentum=mom,
                                      final_iteration=final)(
        jnp.asarray(inp["mag"]), jnp.asarray(inp["sig0"]))


@pytest.mark.parametrize("name", ["stft_re", "stft_im", "istft",
                                  "phase_encode", "phase_decode",
                                  "phase_decode_pcm16", *W.GL_CASES])
def test_pair_sharded_programs(pair, jax_mesh_1x4, name):
    """Each process's shards of the sharded program bit-equal to one
    controller's; assembled, the STFT planes within 1e-4 of the peak, the
    phase encode within 1e-4 and the syntheses within 1e-3 of the JAX
    program (tests/test_torch_longform.py), a PCM-16 result within that
    bound in LSB, its per-row finite flags the one controller's."""
    ranks, one, inp = pair
    got = _check_bits_and_assemble(ranks, name, one[name])
    want = np.asarray(_jax_sharded(name, inp, jax_mesh_1x4))
    if name.startswith("stft"):
        _peak_close(got, want, 1e-4)
    elif name == "phase_encode":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    elif got.dtype == np.int16:
        _pcm_near(got, want, 1e-3)
        assert one[name][1].all()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def _jax_longform(name, inp, jm):
    jp = jlf.LongFormPhase(JPhaseConfig(num_freqs=W.NUM_FREQS,
                                        volume_boost=1.5, **W.CFG), jm)
    jl = jlf.LongFormMel(JMelConfig(num_mels=W.NUM_MELS,
                                    griffin_lim_iterations=2, **W.CFG), jm)
    if name == "lf_phase_encode":
        return jp.encode(inp["audio"]), 1e-4
    if name == "lf_phase_decode":
        return jp.decode(inp["phase_spec"]), 1e-3
    if name == "lf_phase_roundtrip":
        return jp.decode(np.asarray(jp.encode(inp["audio"]))), 1e-3
    if name == "lf_mel_encode":
        return jl.encode(inp["audio"]), 1e-4
    return jl.decode(inp["logmel"], seed=2), 1e-3


@pytest.mark.parametrize("name", ["lf_phase_encode", "lf_phase_decode",
                                  "lf_phase_roundtrip", "lf_mel_encode",
                                  "lf_mel_decode"])
def test_pair_longform(pair, jax_mesh_1x4, name):
    """LongFormPhase / LongFormMel encode and decode (the round trip takes
    the encode's Sharded result as it is) on 2 processes: each process's
    trimmed shards bit-equal to one controller's, the whole within 1e-4
    (encodes) or 1e-3 (decodes, the mel one from the same seed) of the JAX
    package's."""
    ranks, one, inp = pair
    got = _check_bits_and_assemble(ranks, name, one[name])
    want, tol = _jax_longform(name, inp, jax_mesh_1x4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# -- four processes, a 2 x 2 mesh ------------------------------------------------

@pytest.fixture(scope="module")
def quad(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("quad"))
    procs = _start("quad", 4, out_dir)
    inp = W.inputs()
    mesh = pm.make_mesh(data=2, frame=2, devices=[CPU] * 4)
    one = LongFormMel(W.mel_config(), mesh).encode(inp["audio"])
    return _finish(procs, out_dir), one, inp, mesh


def test_quad_ingest_groups(quad):
    """Processes {0, 1} and {2, 3} co-own the data blocks: ingest groups 0
    and 1 of 2, each given every second file by shard_files_for_group."""
    ranks = quad[0]
    assert [r["group"].tolist() for r in ranks] == [[0, 2], [0, 2], [1, 2],
                                                    [1, 2]]
    assert [r["mine"].tolist() for r in ranks] == [[0, 2], [0, 2], [1, 3],
                                                   [1, 3]]


def test_quad_longform_mel_encode(quad):
    """LongFormMel.encode on a 2 x 2 mesh whose both axes cross processes:
    shards bit-equal to one controller's, within 1e-4 of the JAX package's
    on a 2 x 2 JAX mesh."""
    ranks, one, inp, _ = quad
    got = _check_bits_and_assemble(ranks, "lf_mel_encode_2x2", one)
    jm = jmesh.make_mesh(data=2, frame=2, devices=jax.devices()[:4])
    want = jlf.LongFormMel(JMelConfig(num_mels=W.NUM_MELS,
                                      griffin_lim_iterations=2, **W.CFG),
                           jm).encode(inp["audio"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def _group_rows(g: int) -> np.ndarray:
    return W.file_rows(W.files()[g::2])


def test_quad_batch_encode_process_local(quad):
    """BatchedMel.encode(input_mode="process_local"): each process's rows
    (its group's) bit-equal to the one-device BatchedMel on those rows, and
    within 1e-5 of the peak energy of the JAX BatchedMel's
    (tests/test_torch_batch.py)."""
    ranks = quad[0]
    cfg = W.mel_config()
    jb = jbatch.BatchedMel(JMelConfig(num_mels=W.NUM_MELS,
                                      griffin_lim_iterations=2, **W.CFG))
    for r, arrays in enumerate(ranks):
        rows = _group_rows(r // 2)
        want = BatchedMel(cfg, device=CPU).encode(rows).numpy()
        np.testing.assert_array_equal(arrays["batch_encode"], want)
        j = np.asarray(jb.encode(rows))
        np.testing.assert_allclose(np.exp(arrays["batch_encode"]), np.exp(j),
                                   rtol=0, atol=1e-5 * float(np.exp(j).max()))


def test_quad_batch_decode_process_local(quad):
    """BatchedMel.decode(input_mode="process_local") keys each row by its
    global index: each process's rows bit-equal to one controller's
    BatchedMel over a 2 x 2 mesh of the CPU on the groups' rows in group
    order, within 1e-4 relative L2 a row of the JAX BatchedMel on them
    (tests/test_torch_batch.py)."""
    ranks, _, _, mesh = quad
    cfg = W.mel_config()
    enc = np.concatenate([BatchedMel(cfg, device=CPU).encode(
        _group_rows(g)).numpy() for g in (0, 1)])
    one = BatchedMel(cfg, device=CPU, mesh=mesh).decode(enc, seed=4).numpy()
    jb = jbatch.BatchedMel(JMelConfig(num_mels=W.NUM_MELS,
                                      griffin_lim_iterations=2, **W.CFG))
    want = np.asarray(jb.decode(enc, seed=4), np.float64)
    rel = (np.linalg.norm(one - want, axis=-1)
           / np.linalg.norm(want, axis=-1))
    assert rel.max() < 1e-4
    for r, arrays in enumerate(ranks):
        g = r // 2
        np.testing.assert_array_equal(arrays["batch_decode"],
                                      one[2 * g:2 * g + 2])


# -- sharded checkpoints -------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """decode_resumable over 2 processes with a sharded checkpoint after each
    of 4 segments (pruned to the newest 2); then iter 4 made partial (no
    COMPLETE.p1) and a fresh pair of processes that loads and resumes."""
    base = tmp_path_factory.mktemp("ckpt")
    ckpt_dir, save_out, resume_out = (str(base / d) for d in
                                      ("dir", "save", "resume"))
    for d in (save_out, resume_out):
        os.makedirs(d)
    saved = _finish(_start("ckpt_save", 2, save_out, ckpt_dir), save_out)
    listing = {name: sorted(os.listdir(os.path.join(ckpt_dir, name)))
               for name in sorted(os.listdir(ckpt_dir))}
    os.remove(os.path.join(ckpt_dir, "iter_00000004", "COMPLETE.p1"))
    resumed = _finish(_start("ckpt_resume", 2, resume_out, ckpt_dir),
                      resume_out)
    mesh = pm.make_mesh(data=1, frame=4, devices=[CPU] * 4)
    one = LongFormMel(W.mel_config(W.CKPT_ITERS), mesh).decode(
        W.inputs()["logmel"], seed=3)
    return saved, resumed, listing, ckpt_dir, one


def test_checkpoint_resume_bit_equal(ckpt):
    """The segmented run and the resumed run (from the last iteration every
    process completed) give the one-call decode's bits."""
    saved, resumed, _, _, one = ckpt
    _check_bits_and_assemble(saved, "decode", one)
    _check_bits_and_assemble(resumed, "decode", one)


def test_checkpoint_partial_iteration_skipped(ckpt):
    """iter 4 lacks COMPLETE.p1: the MIN all-reduce agrees on iter 3 in
    both processes."""
    resumed = ckpt[1]
    assert [int(r["resumed_from"]) for r in resumed] == [3, 3]


def test_prune_keeps_newest(ckpt):
    """prune_gl_checkpoints(keep_last=2) after each save: iter 3 and 4 are
    complete in both processes; iter 1 and 2 keep neither markers nor shard
    files (each process drops its own on several processes)."""
    listing = ckpt[2]
    assert sorted(listing) == [f"iter_{i:08d}" for i in (1, 2, 3, 4)]
    for i in (1, 2):
        assert listing[f"iter_{i:08d}"] == ["META.npz"]
    for i in (3, 4):
        names = listing[f"iter_{i:08d}"]
        assert {"COMPLETE.p0", "COMPLETE.p1", "META.npz"} <= set(names)
        assert sum(n.startswith("shard_") for n in names) == 4


def test_mixed_done_stamp_raises(ckpt, tmp_path):
    """A shard file stamped with another iteration fails the load; a
    directory without a complete checkpoint fails too."""
    src = os.path.join(ckpt[3], "iter_00000003")
    dst = tmp_path / "iter_00000003"
    shutil.copytree(src, dst)
    name = next(n for n in sorted(os.listdir(dst)) if n.startswith("shard_"))
    with np.load(dst / name) as z:
        data = z["data"]
    with open(dst / name, "wb") as f:
        np.savez(f, data=data, done=2)
    mesh = pm.make_mesh(data=1, frame=4, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="stamps done=2"):
        tlf.load_gl_checkpoint_sharded(str(tmp_path), mesh)
    with pytest.raises(ValueError, match="no complete checkpoint"):
        tlf.load_gl_checkpoint_sharded(str(tmp_path / "empty"), mesh)


def _layout(ckpt_dir: str, done: int):
    sub = os.path.join(ckpt_dir, f"iter_{done:08d}")
    names = sorted(n for n in os.listdir(sub)
                   if not n.startswith("COMPLETE."))
    with np.load(os.path.join(sub, "META.npz")) as z:
        meta = {k: z[k].tolist() for k in z.files}
    return names, meta


@pytest.mark.parametrize("data,frame", [(1, 4), (2, 4)])
def test_checkpoint_layout_equals_jax(ckpt, tmp_path, data, frame):
    """File names, slice keys and META fields equal what the JAX package's
    save_gl_checkpoint_sharded writes for the same carry shape on its CPU
    mesh of the same shape: the 2-process run's iter 4 (1 x 4), and one
    controller's save on a 2 x 4 mesh."""
    shape = (2, 2048)
    jm = jmesh.make_mesh(data=data, frame=frame,
                         devices=jax.devices()[:data * frame])
    carry = jmesh.host_to_global(np.zeros(shape, np.float32), jm,
                                 jax.sharding.PartitionSpec(jmesh.DATA_AXIS,
                                                            jmesh.FRAME_AXIS))
    jdir = str(tmp_path / "jax")
    jlf.save_gl_checkpoint_sharded(jdir, 4, carry)
    if data == 1:
        got = _layout(ckpt[3], 4)
    else:
        mesh = pm.make_mesh(data=data, frame=frame, devices=[CPU] * 8)
        tdir = str(tmp_path / "port")
        tlf.save_gl_checkpoint_sharded(tdir, 4, pm.shard_array(
            np.zeros(shape, np.float32), mesh))
        got = _layout(tdir, 4)
        assert os.listdir(os.path.join(tdir, "iter_00000004")).count(
            "COMPLETE.p0") == 1
    assert got == _layout(jdir, 4)


# -- the native build across processes ------------------------------------------------

def test_native_build_two_processes_at_once(tmp_path):
    """Two processes build the PNG filter into an empty directory at the same
    moment: the build lock lets one compile (the only one that runs g++),
    and both load the library."""
    go = tmp_path / "go"
    code = (
        "import os, subprocess, sys, time\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from gomel_tpu_torch.io import _native\n"
        "_native.BUILD_DIR = sys.argv[1]\n"
        "lib = _native.NativeLib('pngfilter.cpp', '_pngfilter.so', "
        "_native._configure_pngfilter)\n"
        "compiles, run = [], subprocess.run\n"
        "def counted(cmd, *a, **k):\n"
        "    compiles.append(cmd[0])\n"
        "    return run(cmd, *a, **k)\n"
        "subprocess.run = counted\n"
        "while not os.path.exists(sys.argv[2]):\n"
        "    time.sleep(0.01)\n"
        "assert lib.get() is not None\n"
        "print('built' if compiles == ['g++'] else 'loaded')\n")
    build_dir = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", code, build_dir, str(go)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    go.touch()
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    assert sorted(log.split()[-1] for log in logs) == ["built", "loaded"]
    assert os.path.exists(os.path.join(build_dir, "_pngfilter.so"))
    assert _native.get_lib() is not None
