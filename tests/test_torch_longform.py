"""The port's long-form frame-sharded path against the JAX package's.

The same seeded numpy inputs go through ``gomel_tpu`` on its ('data',
'frame') = (2, 4) mesh of eight virtual CPU devices (tests/conftest.py) and
through ``gomel_tpu_torch`` on a mesh of the same shape over eight CPU
entries, where each kernel runs its plain PyTorch version. The kernels
themselves are held to those plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py. Each tolerance is stated where
it is checked.
"""
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gomel_tpu.core.config import MelConfig as JMelConfig
from gomel_tpu.core.config import PhaseConfig as JPhaseConfig
from gomel_tpu.io import imagecodec as jimg
from gomel_tpu.ops import istft as jistft
from gomel_tpu.ops import mel_ops as jmel
from gomel_tpu.ops import phase_ops as jphase
from gomel_tpu.ops import quantize as jquant
from gomel_tpu.ops import stft as jstft
import gomel_tpu.parallel as jparallel
from gomel_tpu.parallel import mesh as jmesh_mod
from gomel_tpu.parallel import sharded as jsh
from gomel_tpu.pipelines import longform as jlf
from gomel_tpu_torch import (LongFormMel, LongFormPhase, MelConfig,
                             PhaseConfig, make_mesh)
import gomel_tpu_torch.parallel as tparallel
from gomel_tpu_torch.io import flac as tflac
from gomel_tpu_torch.io import wavcodec
from gomel_tpu_torch.io.pngcodec import read_png
from gomel_tpu_torch.ops import istft, mel_ops, phase_ops, quantize
from gomel_tpu_torch.ops import stft as tstft
from gomel_tpu_torch.parallel import sharded as tsh
from gomel_tpu_torch.parallel.batch import BatchedMel, BatchedPhase
from gomel_tpu_torch.parallel.mesh import shard_array
from gomel_tpu_torch.pipelines import longform as tlf
from gomel_tpu_torch.pipelines.mel import Mel
from gomel_tpu_torch.pipelines.phase import Phase

CFG = dict(window=64, resolut=256)
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def meshes():
    return (jmesh_mod.make_mesh(data=2, frame=4),
            make_mesh(data=2, frame=4, devices=CPU8))


def _plans(f, frame_len=256, hop=64, n_shards=4):
    return (jsh.plan_frame_sharding(f, frame_len, hop, n_shards),
            tsh.plan_frame_sharding(f, frame_len, hop, n_shards))


def _run(fn, x, tmesh, dtype=torch.float32):
    """A port sharded fn on a whole host array, gathered back to numpy."""
    return fn(shard_array(x, tmesh, dtype)).gather().numpy()


def _peak_close(got, want, tol):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# the JAX package's parallel names that build JAX shardings (a
# NamedSharding has no counterpart: a Sharded array carries its layout)
LATER = {"data_sharding", "batch_frame_sharding", "replicated"}
# gomel_tpu/parallel/__init__.py:30-43, the frame-sharded programs
SHARDED = ("FrameShardPlan", "plan_frame_sharding", "pad_signal_for_plan",
           "pad_frames_for_plan", "sharded_stft_fn", "sharded_istft_fn",
           "sharded_gl_noise_fn", "sharded_griffin_lim_fn",
           "sharded_mel_encode_fn", "sharded_mel_decode_fn",
           "sharded_phase_encode_fn", "sharded_phase_decode_fn")
PLAN_FIELDS = ("frame_len", "hop", "n_shards", "n_frames", "n_frames_padded",
               "out_len", "halo", "frames_per_shard", "chunk",
               "sharded_signal_len")


def test_parallel_exports_the_frame_sharded_programs():
    """Every name of gomel_tpu.parallel.__all__ but the JAX-sharding helpers
    (the multi-process ones included) is in gomel_tpu_torch.parallel.__all__ and
    importable from it; the frame-sharded ones are parallel/sharded.py's,
    each taking the JAX function's parameters in the JAX order (the port
    adds ``pcm16`` after them)."""
    want = set(jparallel.__all__) - LATER
    assert want <= set(tparallel.__all__)
    for name in want:
        assert getattr(tparallel, name) is not None
    for name in SHARDED:
        assert name in want
        assert getattr(tparallel, name) is getattr(tsh, name)
        jp = list(inspect.signature(getattr(jparallel, name)).parameters)
        tp = list(inspect.signature(getattr(tparallel, name)).parameters)
        assert tp[:len(jp)] == jp and set(tp[len(jp):]) <= {"pcm16"}, name


@pytest.mark.parametrize("frames,frame_len,hop,shards", [
    (67497, 4096, 1280, 4), (9, 256, 64, 4), (1, 64, 16, 3)])
def test_parallel_plan_and_pads_vs_jax(frames, frame_len, hop, shards):
    """The plan and the two pads through the package names equal the JAX
    package's, field by field and sample by sample."""
    got = tparallel.plan_frame_sharding(frames, frame_len, hop, shards)
    want = jparallel.plan_frame_sharding(frames, frame_len, hop, shards)
    assert [getattr(got, f) for f in PLAN_FIELDS] == [
        getattr(want, f) for f in PLAN_FIELDS]
    rng = np.random.default_rng(frames)
    x = rng.standard_normal((2, frame_len + (frames - 1) * hop))
    np.testing.assert_array_equal(
        tparallel.pad_signal_for_plan(torch.from_numpy(x), got).numpy(),
        np.asarray(jparallel.pad_signal_for_plan(jnp.asarray(x), want)))
    spec = rng.standard_normal((2, frames, 5, 2))
    np.testing.assert_array_equal(
        tparallel.pad_frames_for_plan(torch.from_numpy(spec), got).numpy(),
        np.asarray(jparallel.pad_frames_for_plan(jnp.asarray(spec), want)))


# -- the global threshold ------------------------------------------------------

@pytest.mark.parametrize("f,frame_len,hop", [(12, 256, 64), (59, 256, 64),
                                             (5, 128, 32), (30, 100, 30)])
def test_host_threshold_equals_jax_pmax(meshes, f, frame_len, hop):
    """0.5 * max of the window sum, computed once per plan on the host,
    equals the JAX program's pmax over the shards' masked window sums
    (sharded.py:300-302) to 1 ulp: the two sum the squared-window rows of a
    sample in another order at shard boundaries."""
    jm, _ = meshes
    jplan, plan = _plans(f, frame_len, hop)
    window = jnp.asarray(jstft.hann_window(frame_len), jnp.float32)

    @functools.partial(shard_map, mesh=jm,
                       in_specs=(P(jmesh_mod.DATA_AXIS, jmesh_mod.FRAME_AXIS),),
                       out_specs=P(jmesh_mod.DATA_AXIS, jmesh_mod.FRAME_AXIS))
    def thresholds(x):
        mask = jsh._local_frame_mask(jplan.frames_per_shard, jplan.n_frames,
                                     jmesh_mod.FRAME_AXIS)
        wsum = jsh._local_window_sum(window, mask, jplan)
        return (0.5 * jax.lax.pmax(jnp.max(wsum), jmesh_mod.FRAME_AXIS)
                + 0.0 * x[:, :1])

    want = np.asarray(thresholds(jnp.zeros((2, 4), jnp.float32)))
    assert np.all(want == want.flat[0])      # one global value
    _, prefix = istft._window_table(
        torch.tensor(tstft.hann_window(frame_len), dtype=torch.float32), hop)
    got = np.float32(istft.window_sum_threshold(prefix, f))
    assert abs(got - want.flat[0]) <= np.spacing(np.float32(want.flat[0]))


# -- the ops: KL, K10, K18 -----------------------------------------------------

@pytest.mark.parametrize("dtype,max_val", [(np.uint8, 255), (np.uint16, 65535)])
@pytest.mark.parametrize("per_channel", [True, False])
def test_dequantize_raw_vs_jax(dtype, max_val, per_channel):
    """Bit-exact against the JAX op without IHS and boost; within 1e-6
    relative (1e-6 absolute near 0) with 2 sinh passes and a boost, as
    XLA's and PyTorch's sinh differ by a few ulp. The extrema stay within
    |2|, the range of two asinh passes over a spectrogram's values up to
    ~13; the second pass multiplies the first's relative error by x coth x
    (at most 3.6 there)."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, max_val + 1, (2, 9, 7, 2), dtype=dtype)
    if per_channel:
        maxs = np.array([2.0, 0.75], np.float32)
        mins = np.array([-1.75, -1.5], np.float32)
    else:
        maxs, mins = np.float32(1.75), np.float32(-2.0)
    t = torch.from_numpy(img)
    got = quantize.dequantize_raw(t, maxs, mins, max_val).numpy()
    want = np.asarray(jquant.dequantize_raw(jnp.asarray(img), maxs, mins,
                                            max_val))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    got = quantize.dequantize_raw(t, maxs, mins, max_val, 2, 1.25).numpy()
    want = np.asarray(jquant.dequantize_raw(jnp.asarray(img), maxs, mins,
                                            max_val, 2, 1.25))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_dequantize_raw_rejects_bad_input():
    with pytest.raises(ValueError, match="uint8 or uint16"):
        quantize.dequantize_raw(torch.zeros(4), 1.0, 0.0, 255)


@pytest.mark.parametrize("real", [0, 5, 17])
def test_chunked_irfft_overlap_add_vs_jax(real):
    """The masked synthesis (frames past ``real`` contribute nothing) within
    1e-5 of the peak of the JAX program's chunked scan (chunk 4, with its
    tail carry), for counts 0, partial and full."""
    rng = np.random.default_rng(2)
    f, n, hop = 17, 256, 64
    re = rng.standard_normal((f, n // 2 + 1)).astype(np.float32)
    im = rng.standard_normal((f, n // 2 + 1)).astype(np.float32)
    win = jstft.hann_window(n).astype(np.float32)
    want = np.asarray(jistft.chunked_irfft_overlap_add(
        jnp.asarray(re), jnp.asarray(im), hop, jnp.asarray(win), 4,
        frame_mask=jnp.arange(f) < real))
    got = istft.chunked_irfft_overlap_add(
        torch.from_numpy(re), torch.from_numpy(im), hop,
        torch.from_numpy(win), 4, real_frames=real).numpy()
    if real == 0:
        np.testing.assert_array_equal(got, want)
        assert not got.any()
    else:
        _peak_close(got, want, 1e-5)
    with pytest.raises(ValueError, match="too small"):
        istft.chunked_irfft_overlap_add(torch.from_numpy(re),
                                        torch.from_numpy(im), hop,
                                        torch.from_numpy(win), 2)


@pytest.mark.parametrize("chunk", [4, 5, 6, 7, 8])
def test_map_frame_chunks_equals_unchunked(chunk):
    """K18 on the mel and phase encodes: each frame is computed alone, so
    the chunked result equals the unchunked one within 1e-6 (float32 FFT
    rounding of the shorter segments' frames is the same), and the JAX
    chunked encode within 1e-6 of its peak."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(64 * 40 + 256 - 64 + 11).astype(np.float32)
    t = torch.from_numpy(x)
    fwd = MelConfig(num_mels=24, **CFG)
    w = Mel(fwd, device="cpu").fwd_weights
    base = mel_ops.mel_encode(t, 24, 256, 64, w)
    got = mel_ops.mel_encode(t, 24, 256, 64, w, frame_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=0, atol=1e-6)
    want = np.asarray(jmel.mel_encode(jnp.asarray(x), 24, 256, 64,
                                      np.asarray(w.numpy()),
                                      frame_chunk=chunk))
    _peak_close(got.numpy(), want, 1e-6)
    base = phase_ops.phase_encode(t, 96, 256, 64)
    got = phase_ops.phase_encode(t, 96, 256, 64, frame_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=0,
                               atol=1e-6 * float(base.abs().max()))
    want = np.asarray(jphase.phase_encode(jnp.asarray(x), 96, 256, 64,
                                          frame_chunk=chunk))
    _peak_close(got.numpy(), want, 1e-6)


# -- the sharded programs ------------------------------------------------------

@pytest.mark.parametrize("frame_chunk", ["auto", None, 4])
def test_sharded_encodes_vs_jax(meshes, frame_chunk):
    """sharded_phase_encode_fn and sharded_mel_encode_fn within 1e-4 (the
    tolerance of tests/test_longform.py:30-31) of the JAX programs."""
    jm, tm = meshes
    jplan, plan = _plans(75)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, plan.sharded_signal_len)).astype(np.float32)
    want = np.asarray(jsh.sharded_phase_encode_fn(
        jm, jplan, 96, frame_chunk=frame_chunk)(jnp.asarray(x)))
    got = _run(tsh.sharded_phase_encode_fn(tm, plan, 96,
                                           frame_chunk=frame_chunk), x, tm)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    fwd = Mel(MelConfig(num_mels=24, **CFG), device="cpu").fwd_weights.numpy()
    want = np.asarray(jsh.sharded_mel_encode_fn(
        jm, jplan, 24, fwd, frame_chunk=frame_chunk)(jnp.asarray(x)))
    got = _run(tsh.sharded_mel_encode_fn(tm, plan, 24, fwd,
                                         frame_chunk=frame_chunk), x, tm)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_sharded_stft_istft_vs_jax(meshes):
    """The sharded STFT planes within 1e-4 of the peak, and the sharded
    iSTFT (masked frames, global threshold) within 1e-3, as
    tests/test_longform.py:33-34 holds the decodes."""
    jm, tm = meshes
    jplan, plan = _plans(30)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, plan.sharded_signal_len)).astype(np.float32)
    jre, jim = jsh.sharded_stft_fn(jm, jplan)(jnp.asarray(x))
    tre, tim = tsh.sharded_stft_fn(tm, plan)(shard_array(x, tm))
    _peak_close(tre.gather().numpy(), np.asarray(jre), 1e-4)
    _peak_close(tim.gather().numpy(), np.asarray(jim), 1e-4)
    spec = np.asarray(jre) + 1j * np.asarray(jim)
    want = np.asarray(jsh.sharded_istft_fn(jm, jplan)(
        jnp.asarray(spec.astype(np.complex64))))
    got = _run(tsh.sharded_istft_fn(tm, plan), spec.astype(np.complex64), tm,
               torch.complex64)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("boost,f", [(0.0, 30), (1.5, 30), (0.0, 7)])
def test_sharded_phase_decode_vs_jax(meshes, boost, f):
    """Within 1e-3 of the JAX program (tests/test_longform.py:33-34), with
    and without a boost, and for a signal whose last shards hold no real
    frame (F = 7 of F_pad = 12 on 4 shards)."""
    jm, tm = meshes
    jplan, plan = _plans(f)
    rng = np.random.default_rng(6)
    spec = rng.standard_normal((2, plan.n_frames_padded, 96, 2)).astype(
        np.float32)
    want = np.asarray(jsh.sharded_phase_decode_fn(jm, jplan, boost)(
        jnp.asarray(spec)))
    got = _run(tsh.sharded_phase_decode_fn(tm, plan, boost), spec, tm)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    # frame_chunk in the JAX position changes nothing (float audio still)
    np.testing.assert_array_equal(_run(tsh.sharded_phase_decode_fn(
        tm, plan, boost, torch.float32, 4), spec, tm), got)
    pcm, finite = tsh.sharded_phase_decode_fn(tm, plan, boost, pcm16=True)(
        shard_array(spec, tm))
    assert finite.tolist() == [True, True]
    np.testing.assert_array_equal(pcm.gather().numpy(), quantize.pcm16_encode(
        torch.from_numpy(got))[0].numpy())


@pytest.mark.parametrize("momentum,final,n_iter", [
    (0.0, True, 3), (0.9, True, 3), (0.0, False, 2), (0.9, False, 2),
    (0.0, True, 1)])
def test_sharded_griffin_lim_vs_jax(meshes, momentum, final, n_iter):
    """From the same start, with and without momentum, interior-only and
    with the final iteration: within 1e-3 of the JAX program
    (tests/test_longform.py:33-34). The magnitudes of pad frames are zeroed
    inside (sharded.py:390), so the input carries non-zero pad frames."""
    jm, tm = meshes
    jplan, plan = _plans(21)
    rng = np.random.default_rng(7)
    mag = rng.random((2, plan.n_frames_padded, 129)).astype(np.float32)
    sig0 = rng.random((2, plan.sharded_signal_len)).astype(np.float32)
    want = np.asarray(jsh.sharded_griffin_lim_fn(
        jm, jplan, n_iter, momentum=momentum, final_iteration=final)(
            jnp.asarray(mag), jnp.asarray(sig0)))
    got = tsh.sharded_griffin_lim_fn(tm, plan, n_iter, momentum=momentum,
                                     final_iteration=final)(
        shard_array(mag, tm), shard_array(sig0, tm)).gather().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_sharded_griffin_lim_interior_mm_not_ported(meshes):
    """interior_mm=True (K14, ported): every forward transform and the
    interior inverses as the matmul DFT, the final inverse exact, with and
    without momentum, within 1e-3 of the JAX program from the same start
    (tests/test_longform.py:33-34); None and False are the exact program."""
    jm, tm = meshes
    jplan, plan = _plans(21)
    rng = np.random.default_rng(17)
    mag = rng.random((2, plan.n_frames_padded, 129)).astype(np.float32)
    sig0 = rng.random((2, plan.sharded_signal_len)).astype(np.float32)
    for momentum in (0.0, 0.9):
        want = np.asarray(jsh.sharded_griffin_lim_fn(
            jm, jplan, 3, momentum=momentum, interior_mm=True)(
                jnp.asarray(mag), jnp.asarray(sig0)))
        got = tsh.sharded_griffin_lim_fn(tm, plan, 3, momentum=momentum,
                                         interior_mm=True)(
            shard_array(mag, tm), shard_array(sig0, tm)).gather().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    exact = [tsh.sharded_griffin_lim_fn(tm, plan, 2, interior_mm=mm)(
        shard_array(mag, tm), shard_array(sig0, tm)).gather()
        for mm in (None, False)]
    assert torch.equal(exact[0], exact[1])
    with pytest.raises(ValueError, match="does not support"):
        tsh.sharded_griffin_lim_fn(tm, tsh.plan_frame_sharding(
            21, 8194, 2048, 4), 2, interior_mm=True)


def test_sharded_mel_decode_interior_mm_vs_jax(meshes):
    """sharded_mel_decode_fn(interior_mm=True) from the same seed, so the
    JAX program's per-shard starts: within 1e-3 of it."""
    jm, tm = meshes
    jplan, plan = _plans(21)
    rng = np.random.default_rng(18)
    logmel = (rng.standard_normal((2, plan.n_frames_padded, 24, 2)) - 3.0
              ).astype(np.float32)
    inv = Mel(MelConfig(num_mels=24, **CFG), device="cpu").inv_weights.numpy()
    want = np.asarray(jsh.sharded_mel_decode_fn(jm, jplan, inv, 2,
                                                interior_mm=True)(
        jnp.asarray(logmel), jax.random.PRNGKey(5)))
    got = tsh.sharded_mel_decode_fn(tm, plan, inv, 2, interior_mm=True)(
        shard_array(logmel, tm), 5).gather().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", ["mm", "xla"])
def test_sharded_encodes_fft_backend_vs_jax(meshes, name):
    """sharded_stft_fn, sharded_phase_encode_fn and sharded_mel_encode_fn
    with an explicit fft_backend within 1e-4 of the JAX programs."""
    jm, tm = meshes
    jplan, plan = _plans(30)
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, plan.sharded_signal_len)).astype(np.float32)
    jre, jim = jsh.sharded_stft_fn(jm, jplan, fft_backend=name)(
        jnp.asarray(x))
    tre, tim = tsh.sharded_stft_fn(tm, plan, fft_backend=name)(
        shard_array(x, tm))
    _peak_close(tre.gather().numpy(), np.asarray(jre), 1e-4)
    _peak_close(tim.gather().numpy(), np.asarray(jim), 1e-4)
    want = np.asarray(jsh.sharded_phase_encode_fn(
        jm, jplan, 96, fft_backend=name, frame_chunk=None)(jnp.asarray(x)))
    got = _run(tsh.sharded_phase_encode_fn(tm, plan, 96, fft_backend=name),
               x, tm)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    fwd = Mel(MelConfig(num_mels=24, **CFG), device="cpu").fwd_weights.numpy()
    want = np.asarray(jsh.sharded_mel_encode_fn(
        jm, jplan, 24, fwd, fft_backend=name, frame_chunk=None)(
            jnp.asarray(x)))
    got = _run(tsh.sharded_mel_encode_fn(tm, plan, 24, fwd,
                                         fft_backend=name), x, tm)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_sharded_mel_decode_vs_jax_from_jax_starts(meshes):
    """sharded_mel_decode_fn from the same seed, so the JAX program's
    per-shard starts (the port draws them itself): within 1e-3 of it."""
    jm, tm = meshes
    jplan, plan = _plans(21)
    rng = np.random.default_rng(8)
    logmel = (rng.standard_normal((2, plan.n_frames_padded, 24, 2)) - 3.0
              ).astype(np.float32)
    inv = Mel(MelConfig(num_mels=24, **CFG), device="cpu").inv_weights.numpy()
    want = np.asarray(jsh.sharded_mel_decode_fn(jm, jplan, inv, 2)(
        jnp.asarray(logmel), jax.random.PRNGKey(5)))
    got = tsh.sharded_mel_decode_fn(tm, plan, inv, 2)(
        shard_array(logmel, tm), 5).gather().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_shard_starts_are_the_jax_draw(meshes, dtype):
    """sharded_gl_noise_fn(seed) equals the JAX program's
    sharded_gl_noise_fn(PRNGKey(seed)) on the same mesh shape bit for bit:
    shard (d, f) draws [b_loc, chunk] from fold_in(key, d * n_frame + f)."""
    jm, tm = meshes
    jplan, plan = _plans(21)
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    for seed, batch in ((5, 2), (-1, 4), (2 ** 32 + 3, 2)):
        want = np.asarray(jsh.sharded_gl_noise_fn(jm, jplan, batch, jd)(
            jax.random.PRNGKey(seed)))
        got = tsh.sharded_gl_noise_fn(tm, plan, batch, dtype)(seed).gather()
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_longform_mel_zero_iterations_is_the_jax_start(meshes):
    """With 0 iterations LongFormMel.decode returns the per-shard starts:
    the JAX package's for the same seed on the same mesh shape, bit for
    bit, and decode_resumable's too."""
    jm, tm = meshes
    cfg = dict(num_mels=24, griffin_lim_iterations=0, **CFG)
    jl = jlf.LongFormMel(JMelConfig(**cfg), jm)
    tl = LongFormMel(MelConfig(**cfg), tm)
    logmel = np.random.default_rng(21).uniform(
        -11.0, 2.0, (3, 21, 24, 2)).astype(np.float32)
    want = np.asarray(jl.decode(logmel, seed=6))
    np.testing.assert_array_equal(tl.decode(logmel, seed=6).numpy(), want)
    np.testing.assert_array_equal(
        tl.decode_resumable(logmel, seed=6).numpy(), want)


# -- the pipelines ---------------------------------------------------------

def test_longform_phase_roundtrip_vs_jax(meshes):
    """Encode within 1e-4 and decode within 1e-3 of the JAX package's
    LongFormPhase (tests/test_longform.py:30-34), 2 rows and one row."""
    jm, tm = meshes
    cfg = dict(num_freqs=96, **CFG)
    jl = jlf.LongFormPhase(JPhaseConfig(**cfg), jm)
    tl = LongFormPhase(PhaseConfig(**cfg), tm)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5000)).astype(np.float32)
    want = np.asarray(jl.encode(x))
    got = tl.encode(x)
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tl.decode(want).numpy(),
                               np.asarray(jl.decode(want)), rtol=1e-3,
                               atol=1e-3)
    one = tl.encode(x[0])
    assert one.shape == (1,) + want.shape[1:]
    np.testing.assert_allclose(tl.decode(want.tolist()).numpy(),
                               tl.decode(want).numpy(), atol=1e-6)


def test_longform_mel_vs_jax(meshes):
    """LongFormMel encode within 1e-4; decode from the same seed within
    1e-3; an odd batch pads to the data axis and is trimmed."""
    jm, tm = meshes
    cfg = dict(num_mels=24, griffin_lim_iterations=2, **CFG)
    jl = jlf.LongFormMel(JMelConfig(**cfg), jm)
    tl = LongFormMel.from_numpy(MelConfig(**cfg), tm, jl._fwd, jl._inv)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((3, 4000)).astype(np.float32)
    want = np.asarray(jl.encode(x))
    got = tl.encode(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tl.decode(want, seed=2).numpy(),
                               np.asarray(jl.decode(want, seed=2)),
                               rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError):
        LongFormMel.from_numpy(MelConfig(**cfg), tm, jl._fwd[:3], jl._inv)


def test_longform_mel_seed_semantics(meshes):
    """Per-shard starts: one seed gives one result, another seed another."""
    _, tm = meshes
    tl = LongFormMel(MelConfig(num_mels=24, griffin_lim_iterations=2, **CFG),
                     tm)
    logmel = tl.encode(np.random.default_rng(11).standard_normal(
        (2, 4000)).astype(np.float32))
    a, b, c = (tl.decode(logmel, seed=s).numpy() for s in (0, 0, 1))
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0


def test_decode_cache_not_stale_across_frame_counts(meshes):
    """F = 12, 13, 14 can pad to one n_frames_padded; each decode keeps its
    own real-frame counts: within 1e-3 of the single-file decode
    (tests/test_longform.py:83-96)."""
    _, tm = meshes
    cfg = PhaseConfig(num_freqs=64, window=32, resolut=128)
    tl = LongFormPhase(cfg, tm)
    single = Phase(cfg, device="cpu")
    rng = np.random.default_rng(12)
    for f in (12, 13, 14):
        spec = rng.standard_normal((2, f, 64, 2)).astype(np.float32)
        got = tl.decode(spec).numpy()
        for i in range(2):
            want = single.decode(spec[i]).numpy()
            np.testing.assert_allclose(got[i][:len(want)], want, atol=1e-3,
                                       rtol=1e-3)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_decode_resumable(meshes, momentum):
    """With momentum 0, every segment length gives decode's output bit for
    bit (tests/test_longform.py:99-112); with momentum it runs and is
    finite."""
    _, tm = meshes
    tl = LongFormMel(MelConfig(num_mels=24, griffin_lim_iterations=7, **CFG),
                     tm)
    logmel = tl.encode(np.random.default_rng(13).standard_normal(
        (2, 4000)).astype(np.float32))
    want = tl.decode(logmel, seed=3, momentum=momentum).numpy()
    for seg in (1, 3, 7, 100):
        got = tl.decode_resumable(logmel, seed=3, momentum=momentum,
                                  segment_iters=seg).numpy()
        if momentum == 0.0:
            np.testing.assert_array_equal(got, want)
        assert np.isfinite(got).all()
    with pytest.raises(ValueError):
        tl.decode_resumable(logmel, segment_iters=0)


def test_decode_resumable_checkpoint_roundtrip(meshes, tmp_path):
    """Run 4 of 6 iterations, persist, resume in a new object: bit-equal to
    the uninterrupted run."""
    _, tm = meshes
    cfg = MelConfig(num_mels=24, griffin_lim_iterations=6, **CFG)
    tl = LongFormMel(cfg, tm)
    logmel = tl.encode(np.random.default_rng(14).standard_normal(
        (2, 4000)).astype(np.float32))
    want = tl.decode_resumable(logmel, seed=0, segment_iters=2).numpy()
    ckpt = str(tmp_path / "gl.npz")
    seen = []

    def cb(done, carry):
        seen.append(done)
        if done == 4:
            tlf.save_gl_checkpoint(ckpt, done, carry)

    out = LongFormMel(cfg, tm).decode_resumable(logmel, seed=0,
                                                segment_iters=2, callback=cb)
    assert seen == [2, 4, 6]
    resumed = LongFormMel(cfg, tm).decode_resumable(
        logmel, seed=0, segment_iters=2,
        resume=tlf.load_gl_checkpoint(ckpt)).numpy()
    np.testing.assert_array_equal(resumed, want)
    np.testing.assert_array_equal(out.numpy(), want)


# -- the file API ------------------------------------------------------------

def _audio_file(tmp_path, sr, kind, seed, secs=0.5, name="in"):
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * sr)) / sr
    a = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.shape)
    pcm = np.clip(np.rint(a * 32768.0), -32768, 32767).astype(np.int16)
    path = str(tmp_path / f"{name}.{kind}")
    if kind == "flac":
        tflac.write_flac(path, pcm, sr)
    else:
        wavcodec.write_wav(path, pcm, sr)
    return path


def _png_near(a, b, loader):
    """At most 1 step at a flip rate < 2e-3 (wrap-aware on the derived B
    channel), and equal metadata."""
    x, y = read_png(a).astype(np.int64), read_png(b).astype(np.int64)
    assert x.shape == y.shape
    d = np.abs(x - y)
    d = np.minimum(d, 256 - d)
    assert d.max() <= 1 and (d > 0).mean() < 2e-3, (d.max(), (d > 0).mean())
    for u, v in zip(loader(a)[1:], loader(b)[1:]):
        np.testing.assert_array_equal(u, v)


def _wav_near(a, b, lsb):
    wa, sa = wavcodec.read_wav(a)
    wb, sb = wavcodec.read_wav(b)
    assert sa == sb and wa.shape == wb.shape
    d = np.abs(wa.astype(np.int64) - wb.astype(np.int64))
    assert d.max() <= lsb and (d > 0).mean() < 5e-2, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("kind,sr", [("wav", 48000), ("wav", 24000),
                                     ("flac", 48000)])
@pytest.mark.parametrize("device_quantize", [True, False])
def test_longform_phase_files_vs_jax(meshes, tmp_path, kind, sr,
                                     device_quantize):
    """to_phase_wav / to_phase_flac PNGs within 1 step at < 2e-3 with equal
    metadata, and to_wav_png of the JAX package's PNG within 1 LSB at < 5e-2
    differing, in both quantize modes (48 kHz: raw int16 ingest with device
    quantize; 24 kHz: the zero-stuffed family)."""
    jm, tm = meshes
    cfg = dict(num_freqs=96, ihs=device_quantize, **CFG)
    audio = _audio_file(tmp_path, sr, kind, seed=15)
    jl = jlf.LongFormPhase(JPhaseConfig(**cfg), jm,
                           device_quantize=device_quantize)
    tl = LongFormPhase(PhaseConfig(**cfg), tm,
                       device_quantize=device_quantize)
    enc = "to_phase_flac" if kind == "flac" else "to_phase_wav"
    a, b = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    getattr(jl, enc)(audio, a)
    getattr(tl, enc)(audio, b)
    _png_near(a, b, lambda p: jimg.load_phase_image_raw(p, cfg_y(cfg), False))
    wa, wb = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    assert jl.to_wav_png(a, wa) == tl.to_wav_png(a, wb)
    _wav_near(wa, wb, 1)


def cfg_y(cfg):
    return PhaseConfig(**cfg).y_reverse


@pytest.mark.parametrize("kind", ["wav", "flac"])
@pytest.mark.parametrize("device_quantize", [True, False])
def test_longform_mel_files_vs_jax(meshes, tmp_path, kind, device_quantize):
    """to_mel_wav / to_mel_flac PNGs within 1 step at < 2e-3 with equal
    metadata; to_wav_png of the JAX package's PNG (boost 1.0, GL-2) from
    the same seed within 2 LSB at < 5e-2 differing (the JAX
    package's float32 Griffin-Lim bound, tests/test_device_quantize_mel.py)."""
    jm, tm = meshes
    cfg = dict(num_mels=24, griffin_lim_iterations=2, volume_boost=1.0, **CFG)
    audio = _audio_file(tmp_path, 48000, kind, seed=16)
    jl = jlf.LongFormMel(JMelConfig(**cfg), jm,
                         device_quantize=device_quantize)
    tl = LongFormMel(MelConfig(**cfg), tm, device_quantize=device_quantize)
    enc = "to_mel_flac" if kind == "flac" else "to_mel_wav"
    a, b = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    getattr(jl, enc)(audio, a)
    getattr(tl, enc)(audio, b)
    y = MelConfig(**cfg).y_reverse
    _png_near(a, b, lambda p: jimg.load_mel_image_raw(p, y))
    wa, wb = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    assert jl.to_wav_png(a, wa, seed=3) == tl.to_wav_png(a, wb, seed=3)
    _wav_near(wa, wb, 2)


def test_longform_mel_file_mismatched_mels_raises(meshes, tmp_path):
    from gomel_tpu_torch.core.config import ConfigError
    _, tm = meshes
    audio = _audio_file(tmp_path, 48000, "wav", seed=17)
    png = str(tmp_path / "m.png")
    LongFormMel(MelConfig(num_mels=24, **CFG), tm).to_mel_wav(audio, png)
    for dq in (True, False):
        bad = LongFormMel(MelConfig(num_mels=16, **CFG), tm,
                          device_quantize=dq)
        with pytest.raises(ConfigError, match="mel bins"):
            bad.to_wav_png(png, str(tmp_path / "o.wav"))


def test_longform_phase_pcm_ingest_matches_float(meshes, tmp_path):
    """The raw int16 ingest (KA per shard) writes the byte-identical PNG as
    the float ingest of the same file."""
    _, tm = meshes
    audio = _audio_file(tmp_path, 48000, "wav", seed=18)
    tl = LongFormPhase(PhaseConfig(num_freqs=96, **CFG), tm,
                       device_quantize=True)
    a, b = str(tmp_path / "pcm.png"), str(tmp_path / "flt.png")
    tl.to_phase_wav(audio, a)
    from gomel_tpu_torch.io.audio import load_wav
    buf, sr = load_wav(audio, mono="left")
    tl._encode_file(buf, sr, b)
    assert open(a, "rb").read() == open(b, "rb").read()


# -- entry points default to the card ----------------------------------------

@pytest.mark.parametrize("make", [
    lambda: Mel(),
    lambda: Mel.from_numpy(MelConfig(), np.zeros((160, 1024)),
                           np.zeros(2048)),
    lambda: Phase(),
    lambda: Phase.from_numpy(PhaseConfig(), np.zeros(4096)),
    lambda: BatchedMel(),
    lambda: BatchedPhase(),
    lambda: make_mesh(frame=4),
    lambda: LongFormPhase(PhaseConfig()),
    lambda: LongFormMel(MelConfig()),
], ids=["Mel", "Mel.from_numpy", "Phase", "Phase.from_numpy", "BatchedMel",
        "BatchedPhase", "make_mesh", "LongFormPhase", "LongFormMel"])
def test_entry_points_default_to_cuda(monkeypatch, make):
    """Without CUDA each entry point raises an error naming the device and
    saying how to run on the CPU; none falls back to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"'cuda' is not available.*cpu"):
        make()


def test_make_mesh_shapes():
    m = make_mesh(data=2, frame=4, devices=CPU8)
    assert m.shape == {"data": 2, "frame": 4} and m.size == 8
    assert make_mesh(frame=2, devices=CPU8).shape == {"data": 4, "frame": 2}
    with pytest.raises(ValueError, match="must divide"):
        make_mesh(frame=3, devices=CPU8)
    with pytest.raises(ValueError, match="needs"):
        make_mesh(data=3, frame=4, devices=CPU8)
