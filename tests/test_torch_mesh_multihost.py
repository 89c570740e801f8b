"""The port's multi-process mesh helpers in one process (parallel/mesh.py).

No process group can come up here for NCCL, so the bring-up's argument and
environment assembly runs against a monkeypatched
``torch.distributed.init_process_group``, and the layouts of several
processes are built from constructed rank grids (the process index and
count monkeypatched) and held against the JAX package's functions on the
same device-to-process maps. tests/test_torch_multiprocess.py runs real
gloo groups.
"""
import datetime
import types

import jax
import numpy as np
import pytest
import torch

from gomel_tpu.io import dataset as jds
from gomel_tpu.parallel import mesh as jmesh
from gomel_tpu_torch import LongFormMel, LongFormPhase, MelConfig, PhaseConfig
from gomel_tpu_torch.io import dataset as tds
from gomel_tpu_torch.parallel import mesh as pm
from gomel_tpu_torch.parallel.batch import BatchedMel, BatchedPhase, local_rows
from gomel_tpu_torch.pipelines import longform as tlf

CPU = torch.device("cpu")


# -- initialize_multihost -----------------------------------------------------

@pytest.fixture
def captured(monkeypatch):
    got = {}
    monkeypatch.setattr(pm.dist, "init_process_group",
                        lambda **kw: got.update(kw))
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    return got


def test_initialize_multihost_kwarg_assembly(captured):
    pm.initialize_multihost("10.0.0.1:1234", 4, 2, backend="gloo",
                            timeout_s=30)
    assert captured == {"backend": "gloo",
                        "init_method": "tcp://10.0.0.1:1234",
                        "world_size": 4, "rank": 2,
                        "timeout": datetime.timedelta(seconds=30)}


def test_initialize_multihost_env_fallback(captured, monkeypatch):
    """Omitted arguments come from the launcher's environment; a missing
    one raises, naming it."""
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        pm.initialize_multihost(backend="gloo")
    monkeypatch.setenv("MASTER_ADDR", "host")
    monkeypatch.setenv("MASTER_PORT", "99")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        pm.initialize_multihost(backend="gloo")
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="RANK"):
        pm.initialize_multihost(backend="gloo")
    monkeypatch.setenv("RANK", "1")
    pm.initialize_multihost(backend="gloo")
    assert captured["init_method"] == "tcp://host:99"
    assert (captured["world_size"], captured["rank"]) == (3, 1)
    assert captured["timeout"] == datetime.timedelta(seconds=300)
    pm.initialize_multihost(process_id=0, backend="gloo")
    assert captured["rank"] == 0
    with pytest.raises(ValueError, match="not in"):
        pm.initialize_multihost(process_id=3, backend="gloo")


def test_initialize_multihost_default_backend(captured, monkeypatch):
    """NCCL by default, which needs CUDA: without it the call raises and
    says to name gloo; nothing falls back on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        pm.initialize_multihost("h:1", 2, 0)
    assert captured == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    pm.initialize_multihost("h:1", 2, 0)
    assert captured["backend"] == "nccl"


def test_single_process_queries():
    assert pm.is_multihost() is False
    assert (pm.process_index(), pm.process_count()) == (0, 1)
    assert pm.backend() is None
    assert pm.local_device_count() == torch.cuda.device_count()


# -- layouts of several processes ------------------------------------------------

def _as_process(monkeypatch, index: int, count: int) -> None:
    """This process as rank ``index`` of ``count``, for the port and JAX."""
    monkeypatch.setattr(pm, "process_index", lambda: index)
    monkeypatch.setattr(pm, "process_count", lambda: count)
    monkeypatch.setattr(jax, "process_index", lambda: index)
    monkeypatch.setattr(jax, "process_count", lambda: count)


def _meshes(ranks):
    """The port's mesh of the rank grid and a stand-in JAX mesh whose
    devices carry the same process indices."""
    ranks = np.asarray(ranks)
    mesh = pm.Mesh([[CPU] * ranks.shape[1]] * ranks.shape[0], ranks.tolist())
    devices = np.empty(ranks.shape, object)
    for idx, r in np.ndenumerate(ranks):
        devices[idx] = types.SimpleNamespace(process_index=int(r))
    jm = types.SimpleNamespace(
        shape={jmesh.DATA_AXIS: ranks.shape[0],
               jmesh.FRAME_AXIS: ranks.shape[1]},
        axis_names=(jmesh.DATA_AXIS, jmesh.FRAME_AXIS), devices=devices)
    return mesh, jm


GROUPABLE = {
    "2x2 over 4": [[0, 1], [2, 3]],
    "2x4 over 2": [[0, 0, 0, 0], [1, 1, 1, 1]],
    "4x2 over 2": [[0, 0], [0, 0], [1, 1], [1, 1]],
    "1x4 over 2": [[0, 0, 1, 1]],
    "2x2 over 2, by column": [[0, 1], [0, 1]],
    "4x1 over 4": [[0], [1], [2], [3]],
}


@pytest.mark.parametrize("axis", [pm.DATA_AXIS, pm.FRAME_AXIS])
@pytest.mark.parametrize("layout", list(GROUPABLE))
def test_data_group_and_batch_multiple_vs_jax(monkeypatch, layout, axis):
    """data_group_for_process, process_local_batch_multiple and
    shard_files_for_group return what the JAX functions return for the same
    device-to-process map, in every process."""
    ranks = GROUPABLE[layout]
    count = 1 + max(max(r) for r in ranks)
    mesh, jm = _meshes(ranks)
    files = [f"f{i}" for i in range(7)]
    for p in range(count):
        _as_process(monkeypatch, p, count)
        assert pm.data_group_for_process(mesh, axis) == \
            jmesh.data_group_for_process(jm, axis)
        assert pm.process_local_batch_multiple(mesh, axis) == \
            jmesh.process_local_batch_multiple(jm, axis)
        if axis == pm.DATA_AXIS:
            assert tds.shard_files_for_group(files, mesh) == \
                jds.shard_files_for_group(files, jm)


@pytest.mark.parametrize("ranks", [[[0], [1], [0], [1]], [[0], [0], [1]],
                                   [[0, 0], [1, 2], [1, 2]]])
def test_data_group_raises_on_non_contiguous_layouts(monkeypatch, ranks):
    """Coordinate sets that are not equal contiguous blocks raise, in the
    port as in JAX."""
    mesh, jm = _meshes(ranks)
    count = 1 + max(max(r) for r in ranks)
    _as_process(monkeypatch, 0, count)
    with pytest.raises(ValueError, match="do not partition"):
        jmesh.data_group_for_process(jm)
    with pytest.raises(ValueError, match="do not partition"):
        pm.data_group_for_process(mesh)
    with pytest.raises(ValueError, match="do not partition"):
        pm.process_local_batch_multiple(mesh)


def test_one_process_defaults():
    """Without a group: group (0, 1), the data axis as the multiple, and
    shard_files_for_process the identity (JAX's single process too)."""
    mesh = pm.make_mesh(data=2, frame=4, devices=[CPU] * 8)
    assert pm.data_group_for_process(mesh) == (0, 1)
    assert pm.process_local_batch_multiple(mesh) == 2
    files = [f"f{i}" for i in range(5)]
    assert tds.shard_files_for_process(files) == files
    assert tds.shard_files_for_group(files, mesh) == files


def test_shard_files_for_process_defaults_from_the_group(monkeypatch):
    files = [f"f{i}" for i in range(7)]
    _as_process(monkeypatch, 1, 3)
    assert tds.shard_files_for_process(files) == files[1::3] == \
        jds.shard_files_for_process(files)


def test_local_rows_to_global_takes_the_group_block(monkeypatch):
    """On a 2 x 2 mesh over 4 processes, process 3 (group 1 of 2) passes its
    group's 2 rows: they are global rows 2-3, on its cell (1, 1) only; a
    replicated host array uploads this process's cell alone."""
    mesh, _ = _meshes([[0, 1], [2, 3]])
    _as_process(monkeypatch, 3, 4)
    rows = np.arange(2 * 6, dtype=np.float32).reshape(2, 6)
    got = pm.local_rows_to_global(rows, mesh)
    assert got.shape == (4, 6) and got.spec == (pm.DATA_AXIS,)
    assert [s is None for s in got.shards] == [True, True, True, False]
    np.testing.assert_array_equal(got.shard(3).numpy(), rows)
    assert got.addressable_shards[0].index[:2] == (slice(2, 4), slice(0, 6))
    split = pm.local_rows_to_global(rows, mesh, (pm.DATA_AXIS,
                                                 pm.FRAME_AXIS))
    np.testing.assert_array_equal(split.shard(3).numpy(), rows[:, 3:])
    whole = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)
    rep = pm.host_to_global(whole, mesh)
    np.testing.assert_array_equal(rep.shard(3).numpy(), whole[2:, 3:])
    with pytest.raises(ValueError, match="does not split"):
        pm.local_rows_to_global(np.zeros((2, 5)), mesh,
                                (pm.DATA_AXIS, pm.FRAME_AXIS))
    with pytest.raises(ValueError, match="layout"):
        pm.host_to_global(whole, mesh, (pm.FRAME_AXIS,))


# -- make_mesh across processes and the NCCL rule ------------------------------------

def _group_of(monkeypatch, rank: int, world: int, backend: str,
              visible: int, devices_of_others=None):
    """This process as ``rank`` of a ``world`` on one host with ``backend``
    and ``visible`` cards; the gather of the layouts answers for the other
    ranks with ``devices_of_others`` (None: their defaults)."""
    _as_process(monkeypatch, rank, world)
    monkeypatch.setattr(pm, "backend", lambda: backend)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: visible > 0)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(pm.dist, "barrier", lambda *a, **k: None)

    def gather(mine):
        return [("host", None, mine[2] if r == rank else devices_of_others,
                 visible) for r in range(world)]
    monkeypatch.setattr(pm, "_all_gather_host", gather)


def test_make_mesh_across_processes_in_rank_order(monkeypatch):
    """Every rank's devices in rank order: rank 1 of 2 with two CPU entries
    owns cells 2 and 3 of a 1 x 4 mesh."""
    _group_of(monkeypatch, 1, 2, "gloo", 0, ["cpu", "cpu"])
    mesh = pm.make_mesh(data=1, frame=4, devices=[CPU] * 2)
    assert mesh.ranks == [[0, 0, 1, 1]] and mesh.local_indices == [2, 3]
    assert mesh.spans_processes and mesh.first_local_device == CPU
    with pytest.raises(ValueError, match="without a cell"):
        pm.make_mesh(data=1, frame=2, devices=[CPU] * 2)


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    """On NCCL a mesh that puts two ranks on one card raises and says to
    pass backend='gloo': a local rank at or beyond the visible card count
    (default devices), or two ranks naming the same card. gloo takes the
    same layout."""
    _group_of(monkeypatch, 1, 2, "nccl", 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        pm.make_mesh(frame=2)
    _group_of(monkeypatch, 0, 2, "nccl", 1)
    with pytest.raises(ValueError, match="no card of its own"):
        pm.make_mesh(frame=2)
    card = torch.device("cuda", 0)
    _group_of(monkeypatch, 0, 2, "nccl", 1, ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="both name cuda:0.*backend='gloo'"):
        pm.make_mesh(frame=4, devices=[card] * 2)
    _group_of(monkeypatch, 0, 2, "gloo", 1, ["cuda:0", "cuda:0"])
    mesh = pm.make_mesh(frame=4, devices=[card] * 2)
    assert mesh.ranks == [[0, 0, 1, 1]]
    assert all(d == card for row in mesh.devices for d in row)
    _group_of(monkeypatch, 0, 2, "nccl", 2)
    assert pm.make_mesh(frame=2).devices == [[card, torch.device("cuda", 1)]]


def test_chip_smoke_nccl_workers_each_own_a_card(monkeypatch):
    """chip_smoke.py phase 3j's NCCL run (2 long-form workers, 2 cards
    visible) gives each rank its own card, so make_mesh's NCCL check passes
    on every rank and the grid is [cuda:0, cuda:0, cuda:1, cuda:1]; the gloo
    run's shared card would be refused under NCCL."""
    import chip_smoke
    world = 2

    def devices(backend, rank):
        dev = torch.device(chip_smoke.worker_device(backend, "cuda", rank))
        return chip_smoke.longform_mesh_devices(dev, world)

    for rank in range(world):
        other = [str(d) for d in devices("nccl", 1 - rank)]
        _group_of(monkeypatch, rank, world, "nccl", 2, other)
        mesh = pm.make_mesh(data=1, frame=chip_smoke.N_SHARDS,
                            devices=devices("nccl", rank))
        assert mesh.devices == [[torch.device("cuda", 0)] * 2
                                + [torch.device("cuda", 1)] * 2]
        assert mesh.ranks == [[0, 0, 1, 1]]
    _group_of(monkeypatch, 0, world, "nccl", 2,
              [str(d) for d in devices("gloo", 1)])
    with pytest.raises(ValueError, match="both name cuda:0"):
        pm.make_mesh(data=1, frame=chip_smoke.N_SHARDS,
                     devices=devices("gloo", 0))


# -- results on a mesh over processes --------------------------------------------

def _split_mesh(n_frame=4):
    return pm.Mesh([[CPU] * n_frame], [[0] * (n_frame // 2)
                                       + [1] * (n_frame // 2)])


def test_sharded_gather_raises_across_processes():
    """This process holds its own shards: gather() raises (JAX forbids
    eager reads of arrays it cannot address), shard(i) of another's raises,
    addressable_shards and shard(i) of its own read them."""
    mesh = _split_mesh()
    x = np.arange(2 * 8, dtype=np.float32).reshape(2, 8)
    s = pm.shard_array(x, mesh)
    assert [t is None for t in s.shards] == [False, False, True, True]
    assert s.shape == (2, 8)
    with pytest.raises(ValueError, match="spans processes"):
        s.gather()
    with pytest.raises(ValueError, match="belongs to process 1"):
        s.shard(2)
    np.testing.assert_array_equal(s.shard(1).numpy(), x[:, 2:4])
    trimmed = pm.Sharded(mesh, s.shards, trim=(1, 3))
    assert trimmed.shape == (1, 3)
    parts = trimmed.addressable_shards
    assert [p.index[:2] for p in parts] == [(slice(0, 1), slice(0, 2)),
                                            (slice(0, 1), slice(2, 3))]
    np.testing.assert_array_equal(parts[1].data.numpy(), x[:1, 2:3])
    with pytest.raises(ValueError, match="full carry"):
        tlf.save_gl_checkpoint("unused.npz", 1, s)


CFG = dict(window=64, resolut=256)


@pytest.mark.parametrize("call", [
    ("phase", "to_phase_wav"), ("phase", "to_phase_flac"),
    ("phase", "to_wav_png"), ("mel", "to_mel_wav"), ("mel", "to_mel_flac"),
    ("mel", "to_wav_png")])
def test_longform_file_calls_refuse_a_mesh_over_processes(tmp_path, call):
    """The file calls assemble one host file: on a mesh over processes
    they raise before reading anything."""
    kind, name = call
    mesh = _split_mesh()
    lf = (LongFormPhase(PhaseConfig(num_freqs=96, **CFG), mesh) if
          kind == "phase" else LongFormMel(MelConfig(num_mels=24, **CFG),
                                           mesh))
    with pytest.raises(ValueError, match="assembles the full file"):
        getattr(lf, name)(str(tmp_path / "missing"), str(tmp_path / "out"))


# -- the batched codecs over a mesh in one process ----------------------------------

def test_batched_codecs_over_a_mesh_in_one_process():
    """With ``mesh=`` on one process every data block runs on its device and
    the result is the whole batch, trimmed: bit-equal to one device on the
    same rows for an odd batch (padded to the data axis, then trimmed), in
    both input modes; ``local_rows`` reads a result on the host."""
    cfg = MelConfig(num_mels=24, griffin_lim_iterations=1, **CFG)
    rows = np.random.default_rng(3).standard_normal((3, 1280)).astype(
        np.float32)
    mesh = pm.make_mesh(data=2, frame=4, devices=[CPU] * 8)
    one = BatchedMel(cfg, device=CPU)
    want = one.encode(rows).numpy()
    for mode in ("replicated", "process_local"):
        bm = BatchedMel(cfg, mesh=mesh, input_mode=mode)
        assert bm.device == CPU
        got = bm.encode(rows)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(local_rows(got, 2), want[:2])
    frames = np.array([17, 9, 0])
    q = BatchedMel(cfg, mesh=mesh).encode_quantized(rows, frames)
    for g, w in zip(q, one.encode_quantized(rows, frames)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    pcfg = PhaseConfig(num_freqs=96, **CFG)
    bp = BatchedPhase(pcfg, mesh=mesh)
    np.testing.assert_array_equal(
        bp.encode(rows).numpy(),
        BatchedPhase(pcfg, device=CPU).encode(rows).numpy())
    with pytest.raises(ValueError, match="requires a mesh"):
        BatchedMel(cfg, device=CPU, input_mode="process_local")
    with pytest.raises(ValueError, match="unknown input_mode"):
        BatchedMel(cfg, device=CPU, mesh=mesh, input_mode="global")

