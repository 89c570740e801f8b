"""One process of the multi-process tests of the port (gloo on the CPU).

    python tests/torch_mp_worker.py SCENARIO RANK WORLD PORT OUT_DIR [ARG]

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
  processes that loads the newest complete one and resumes.
"""
from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from gomel_tpu_torch import (LongFormMel, LongFormPhase, MelConfig,  # noqa: E402
                             PhaseConfig)
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


def _store(out: dict, name: str, value) -> None:
    """A result's local shards (and flags) into ``out``."""
    if isinstance(value, tuple):
        value, flags = value
        out[f"{name}|finite"] = flags.numpy()
    for shard in value.addressable_shards:
        key = ",".join(f"{s.start}-{s.stop}" for s in shard.index[:2])
        out[f"{name}|{key}"] = shard.data.numpy()


def run(scenario: str, extra: str | None) -> dict:
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
                lf.save_gl_checkpoint_sharded(extra, done, carry)
                lf.prune_gl_checkpoints(extra, keep_last=2)
            result = lm.decode_resumable(inp["logmel"], seed=3,
                                         segment_iters=1, callback=save)
        else:
            done, carry = lf.load_gl_checkpoint_sharded(extra, mesh)
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
    extra = argv[5] if len(argv) > 5 else None
    pm.initialize_multihost(f"127.0.0.1:{port}", int(world), int(rank),
                            backend="gloo", timeout_s=60)
    try:
        out = run(scenario, extra)
    finally:
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
