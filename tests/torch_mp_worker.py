"""One process of the multi-process tests of the port (gloo on the CPU).

    python tests/torch_mp_worker.py SCENARIO RANK WORLD PORT OUT_DIR [ARG...]

Each process joins a gloo group of WORLD processes at 127.0.0.1:PORT
through ``parallel.mesh.initialize_multihost``, runs SCENARIO on its own
shards and writes them to ``OUT_DIR/rank<RANK>.npz``. It imports torch and
the port only; tests/test_torch_multiprocess.py starts the processes,
makes the same inputs (the functions below) and holds every shard against
the port on one controller and against the JAX package. Scenarios:

- ``pair``: a 1 x 4 mesh over 2 processes, 2 frame shards each: the
  sharded STFT, iSTFT, phase encode and decode (boost, PCM-16),
  Griffin-Lim (momentum 0 and 0.99, final iteration or not, PCM-16), and
  LongFormPhase / LongFormMel encode and decode;
- ``quad``: a 2 x 2 mesh over 4 processes, both axes crossing processes:
  LongFormMel.encode and BatchedMel encode and decode with
  ``input_mode="process_local"``, each ingest group's rows picked by
  ``io.dataset.shard_files_for_group``;
- ``ckpt_save`` / ``ckpt_resume``: ``LongFormMel.decode_resumable`` over
  a 1 x 4 mesh of 2 processes with a sharded checkpoint after every
  segment (``ARG``: the checkpoint directory), then a fresh set of
  processes that loads the newest complete one and resumes;
- ``serve_1x4`` / ``serve_2x2``: the long-form serving artifacts
  (``serving.export_longform_*``: the mel and phase encoders and decoders,
  the mel decoder also with ``interior_mm`` and momentum) built on a 1 x 4
  mesh over WORLD processes or a 2 x 2 mesh over 2, each called, held
  beside the eager sharded functions on the same mesh, saved by rank 0
  into the first ARG (then its ``COMPLETE`` marker) and loaded and called
  by every rank; then, once the second ARG holds its ``COMPLETE`` marker,
  the artifacts another process or group saved there loaded and called;
  then a mesh of another shape and a batch the mesh does not take, each
  refused.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from gomel_tpu_torch import (LongFormMel, LongFormPhase, MelConfig,  # noqa: E402
                             PhaseConfig, serving)
from gomel_tpu_torch.core.filterbank import (inverse_mel_weights,  # noqa: E402
                                             mel_weights)
from gomel_tpu_torch.ops import prng  # noqa: E402
from gomel_tpu_torch.io.dataset import shard_files_for_group  # noqa: E402
from gomel_tpu_torch.parallel import mesh as pm  # noqa: E402
from gomel_tpu_torch.parallel import sharded as sh  # noqa: E402
from gomel_tpu_torch.parallel.batch import BatchedMel  # noqa: E402
from gomel_tpu_torch.pipelines import longform as lf  # noqa: E402

CPU = torch.device("cpu")
# FFT 512, hop 128: 4 frames a shard over 4 frame shards (the plan of 13
# frames pads to 16)
FRAME_LEN, HOP, N_SHARDS, FRAMES = 512, 128, 4, 13
CFG = dict(window=HOP, resolut=FRAME_LEN)
NUM_FREQS, NUM_MELS = 96, 24
GL_CASES = {  # name: (n_iter, momentum, final_iteration, pcm16)
    "gl_m0_final": (3, 0.0, True, False),
    "gl_m99_final": (3, 0.99, True, False),
    "gl_m0_interior": (2, 0.0, False, False),
    "gl_m99_interior": (2, 0.99, False, False),
    "gl_m0_pcm16": (3, 0.0, True, True),
    "gl_m99_interior_pcm16": (2, 0.99, False, True)}
N_FILES = 4           # the 'files' of the 2 x 2 batch, 2 a group
ROW_LEN = 1536
CKPT_ITERS = 4


def plan() -> sh.FrameShardPlan:
    return sh.plan_frame_sharding(FRAMES, FRAME_LEN, HOP, N_SHARDS)


def inputs() -> dict[str, np.ndarray]:
    """The seeded inputs of every scenario (numpy, float32)."""
    p = plan()
    rng = np.random.default_rng(20)
    f32 = np.float32
    x = rng.standard_normal((2, p.sharded_signal_len)).astype(f32)
    spec = (rng.standard_normal((2, p.n_frames_padded, FRAME_LEN // 2 + 1))
            + 1j * rng.standard_normal((2, p.n_frames_padded,
                                        FRAME_LEN // 2 + 1)))
    return {
        "x": x,
        "spec": spec.astype(np.complex64),
        "spec2": rng.standard_normal((2, p.n_frames_padded, NUM_FREQS, 2)
                                     ).astype(f32),
        "mag": rng.random((2, p.n_frames_padded, FRAME_LEN // 2 + 1)
                          ).astype(f32),
        "sig0": rng.random((2, p.sharded_signal_len)).astype(f32),
        "audio": rng.standard_normal((2, 1700)).astype(f32),
        "phase_spec": rng.standard_normal((2, FRAMES, NUM_FREQS, 2)
                                          ).astype(f32),
        "logmel": (rng.standard_normal((2, FRAMES, NUM_MELS, 2)) - 3.0
                   ).astype(f32)}


def file_rows(names) -> np.ndarray:
    """The rows the 'files' ``names`` ("utt<k>") decode to."""
    return np.stack([np.random.default_rng(100 + int(n[3:])).standard_normal(
        ROW_LEN).astype(np.float32) for n in names])


def files() -> list[str]:
    return [f"utt{k}" for k in range(N_FILES)]


def phase_config() -> PhaseConfig:
    return PhaseConfig(num_freqs=NUM_FREQS, volume_boost=1.5, **CFG)


def mel_config(iters: int = 2) -> MelConfig:
    return MelConfig(num_mels=NUM_MELS, griffin_lim_iterations=iters, **CFG)


def sharded_items(mesh, inp: dict) -> dict:
    """Every sharded program of the ``pair`` scenario on ``mesh``: name ->
    a Sharded result (or (Sharded, finite flags))."""
    p = plan()
    a = pm.shard_array
    out = {}
    re, im = sh.sharded_stft_fn(mesh, p)(a(inp["x"], mesh))
    out["stft_re"], out["stft_im"] = re, im
    out["istft"] = sh.sharded_istft_fn(mesh, p)(
        a(inp["spec"], mesh, torch.complex64))
    out["phase_encode"] = sh.sharded_phase_encode_fn(mesh, p, NUM_FREQS)(
        a(inp["x"], mesh))
    out["phase_decode"] = sh.sharded_phase_decode_fn(mesh, p, 1.5)(
        a(inp["spec2"], mesh))
    out["phase_decode_pcm16"] = sh.sharded_phase_decode_fn(
        mesh, p, 1.5, pcm16=True)(a(inp["spec2"], mesh))
    for name, (n_iter, mom, final, pcm16) in GL_CASES.items():
        out[name] = sh.sharded_griffin_lim_fn(
            mesh, p, n_iter, momentum=mom, final_iteration=final,
            pcm16=pcm16)(a(inp["mag"], mesh), a(inp["sig0"], mesh))
    return out


def longform_items(mesh, inp: dict) -> dict:
    """LongFormPhase and LongFormMel encode and decode on ``mesh``."""
    lp = LongFormPhase(phase_config(), mesh)
    lm = LongFormMel(mel_config(), mesh)
    return {"lf_phase_encode": lp.encode(inp["audio"]),
            "lf_phase_decode": lp.decode(inp["phase_spec"]),
            "lf_mel_encode": lm.encode(inp["audio"]),
            "lf_mel_decode": lm.decode(inp["logmel"], seed=2)}


# the serving scenarios: tests/test_torch_serving.py's small sizes
SV_MEL = MelConfig(num_mels=8, resolut=64, window=16,
                   griffin_lim_iterations=2)
SV_PHASE = PhaseConfig(sample_rate=8000, resolut=64, window=16,
                       num_freqs=24, volume_boost=1.5)
SV_FRAMES = {"mel-enc": 37, "mel-dec": 25, "mel-dec-mm": 25,
             "phase-enc": 33, "phase-dec": 33}
SV_NAMES = tuple(SV_FRAMES)
SV_LAYOUTS = {"serve_1x4": (1, 4), "serve_2x2": (2, 2)}
SV_SEED = 7
SV_MOMENTUM = {"mel-dec": 0.0, "mel-dec-mm": 0.99}


def sv_config(name: str):
    return SV_PHASE if name.startswith("phase") else SV_MEL


def sv_build(name: str, mesh):
    """Artifact ``name`` at batch 2 on ``mesh``."""
    cfg, kw = sv_config(name), dict(n_frames=SV_FRAMES[name], batch=2)
    if name == "mel-enc":
        return serving.export_longform_mel_encoder(cfg, mesh, **kw)
    if name == "phase-enc":
        return serving.export_longform_phase_encoder(cfg, mesh, **kw)
    if name == "phase-dec":
        return serving.export_longform_phase_decoder(cfg, mesh, **kw)
    return serving.export_longform_mel_decoder(
        cfg, mesh, momentum=SV_MOMENTUM[name],
        interior_mm=name == "mel-dec-mm", **kw)


def sv_inputs(name: str, shape: tuple) -> tuple:
    """Seeded numpy inputs of artifact ``name`` on a mesh of ``shape``
    (data, frame): audio, a phase spectrogram, or a log-mel and key."""
    plan = sh.plan_frame_sharding(SV_FRAMES[name], 64, 16, shape[1])
    rng = np.random.default_rng(30 + SV_NAMES.index(name))
    if name.endswith("-enc"):
        return (rng.standard_normal((2, plan.sharded_signal_len))
                .astype(np.float32),)
    if name == "phase-dec":
        return (rng.standard_normal((2, plan.n_frames_padded,
                                     SV_PHASE.num_freqs, 2))
                .astype(np.float32),)
    return ((rng.standard_normal((2, plan.n_frames_padded, SV_MEL.num_mels,
                                  2)) - 3.0).astype(np.float32),
            prng.key(SV_SEED))


def sv_eager(name: str, mesh, args: tuple):
    """The eager sharded function artifact ``name`` was traced from, on
    ``mesh``."""
    cfg = sv_config(name)
    plan = serving.longform_plan(cfg, mesh, SV_FRAMES[name])
    x = pm.shard_array(args[0], mesh)
    if name == "mel-enc":
        return sh.sharded_mel_encode_fn(mesh, plan, cfg.num_mels, mel_weights(
            cfg.n_bins, cfg.num_mels, cfg.mel_fmin, cfg.mel_fmax))(x)
    if name == "phase-enc":
        return sh.sharded_phase_encode_fn(mesh, plan, cfg.num_freqs)(x)
    if name == "phase-dec":
        return sh.sharded_phase_decode_fn(mesh, plan, cfg.volume_boost)(x)
    inv = inverse_mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin,
                              cfg.mel_fmax)
    return sh.sharded_mel_decode_fn(
        mesh, plan, inv, cfg.griffin_lim_iterations, cfg.tune_mul,
        cfg.tune_add, momentum=SV_MOMENTUM[name],
        interior_mm=name == "mel-dec-mm")(x, SV_SEED)


def _wait_for(path: str, timeout_s: float = 100.0) -> None:
    """Wait until ``path`` exists (another process's marker)."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"{path} did not appear in {timeout_s} s")
        time.sleep(0.05)


def _refusal(fn) -> str:
    """The ValueError ``fn`` raises ("" when it raises none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def serve(scenario: str, world: int, rank: int, save_dir: str,
          load_dir: str) -> dict:
    data, frame = SV_LAYOUTS[scenario]
    mesh = pm.make_mesh(data=data, frame=frame,
                        devices=[CPU] * (data * frame // world))
    out: dict[str, np.ndarray] = {"local": np.asarray(mesh.local_indices)}
    built = {}
    for name in SV_NAMES:
        args = sv_inputs(name, (data, frame))
        built[name] = exp = sv_build(name, mesh)
        _store(out, f"built:{name}", serving.call_longform(exp, mesh, *args))
        _store(out, f"eager:{name}", sv_eager(name, mesh, args))
        if rank == 0:
            serving.save_exported(exp, os.path.join(save_dir, name),
                                  serving.artifact_meta(
                                      exp, sv_config(name), kind=name))
    if rank == 0:
        open(os.path.join(save_dir, "COMPLETE"), "w").close()
    torch.distributed.barrier()
    for tag, where in (("loaded", save_dir), ("foreign", load_dir)):
        _wait_for(os.path.join(where, "COMPLETE"))
        for name in SV_NAMES:
            exp = serving.load_exported(os.path.join(where, name))
            _store(out, f"{tag}:{name}", serving.call_longform(
                exp, mesh, *sv_inputs(name, (data, frame))))
    # a mesh of another shape, a batch of 3 rows, and (on the 2 x 2 mesh)
    # an artifact at a batch the data axis does not divide
    o_data, o_frame = (2, 2) if (data, frame) == (1, 4) else (1, 4)
    other = pm.make_mesh(data=o_data, frame=o_frame,
                         devices=[CPU] * (4 // world))
    x = sv_inputs("phase-enc", (data, frame))[0]
    out["refused_shape"] = np.asarray(_refusal(
        lambda: serving.call_longform(built["phase-enc"], other, x)))
    out["refused_batch"] = np.asarray(_refusal(
        lambda: serving.call_longform(built["phase-enc"], mesh,
                                      np.concatenate([x, x[:1]]))))
    if data > 1:
        out["refused_export"] = np.asarray(_refusal(
            lambda: serving.export_longform_phase_encoder(
                SV_PHASE, mesh, n_frames=33, batch=3)))
    return out


def _store(out: dict, name: str, value) -> None:
    """A result's local shards (and flags) into ``out``."""
    if isinstance(value, tuple):
        value, flags = value
        out[f"{name}|finite"] = flags.numpy()
    for shard in value.addressable_shards:
        key = ",".join(f"{s.start}-{s.stop}" for s in shard.index[:2])
        out[f"{name}|{key}"] = shard.data.numpy()


def run(scenario: str, world: int, rank: int, extra: list[str]) -> dict:
    if scenario in SV_LAYOUTS:
        return serve(scenario, world, rank, *extra)
    inp = inputs()
    out: dict[str, np.ndarray] = {}
    if scenario == "pair":
        mesh = pm.make_mesh(data=1, frame=4, devices=[CPU] * 2)
        for name, value in {**sharded_items(mesh, inp),
                            **longform_items(mesh, inp)}.items():
            _store(out, name, value)
        lp = LongFormPhase(phase_config(), mesh)
        _store(out, "lf_phase_roundtrip", lp.decode(lp.encode(inp["audio"])))
        out["local"] = np.asarray(mesh.local_indices)
    elif scenario == "quad":
        mesh = pm.make_mesh(data=2, frame=2, devices=[CPU])
        _store(out, "lf_mel_encode_2x2",
               LongFormMel(mel_config(), mesh).encode(inp["audio"]))
        mine = shard_files_for_group(files(), mesh)
        rows = file_rows(mine)
        bm = BatchedMel(mel_config(), device=CPU, mesh=mesh,
                        input_mode="process_local")
        out["group"] = np.asarray(pm.data_group_for_process(mesh))
        out["mine"] = np.asarray([int(n[3:]) for n in mine])
        out["batch_encode"] = bm.encode(rows).numpy()
        out["batch_decode"] = bm.decode(bm.encode(rows), seed=4).numpy()
    elif scenario in ("ckpt_save", "ckpt_resume"):
        mesh = pm.make_mesh(data=1, frame=4, devices=[CPU] * 2)
        lm = LongFormMel(mel_config(CKPT_ITERS), mesh)
        if scenario == "ckpt_save":
            def save(done, carry):
                lf.save_gl_checkpoint_sharded(extra[0], done, carry)
                lf.prune_gl_checkpoints(extra[0], keep_last=2)
            result = lm.decode_resumable(inp["logmel"], seed=3,
                                         segment_iters=1, callback=save)
        else:
            done, carry = lf.load_gl_checkpoint_sharded(extra[0], mesh)
            out["resumed_from"] = np.asarray(done)
            result = lm.decode_resumable(inp["logmel"], seed=3,
                                         segment_iters=1,
                                         resume=(done, carry))
        _store(out, "decode", result)
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    return out


def main(argv: list[str]) -> int:
    scenario, rank, world, port, out_dir = argv[:5]
    pm.initialize_multihost(f"127.0.0.1:{port}", int(world), int(rank),
                            backend="gloo", timeout_s=60)
    try:
        out = run(scenario, int(world), int(rank), argv[5:])
    finally:
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
