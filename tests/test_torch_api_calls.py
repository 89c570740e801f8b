"""JAX-style calls of the port's public functions, on the CPU against the JAX
package (the behaviour beside tests/test_torch_api_parity.py's signatures).

The same numpy inputs, made from a seed, go through the JAX function and the
port's; small sizes (n = 64-512, a few dozen frames). Tolerances are stated
at each comparison: the decodes use tests/test_torch_phase.py's (float64 1e-9,
float32 1e-5 of the peak), the chunked encodes are bit-equal to the
unchunked ones.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gomel_tpu.ops import griffinlim as jgl
from gomel_tpu.ops import istft as jistft
from gomel_tpu.ops import mel_ops as jmel
from gomel_tpu.ops import mxu_fft as jmxu
from gomel_tpu.ops import phase_ops as jphase
from gomel_tpu_torch import pipelines
from gomel_tpu_torch.core.config import MelConfig, PhaseConfig
from gomel_tpu_torch.core.filterbank import mel_weights
from gomel_tpu_torch.ops import griffinlim as tgl
from gomel_tpu_torch.ops import istft as tistft
from gomel_tpu_torch.ops import mel_ops as tmel
from gomel_tpu_torch.ops import mxu_fft as tmxu
from gomel_tpu_torch.ops import phase_ops as tphase
from gomel_tpu_torch.ops.stft import hann_window
from gomel_tpu_torch.parallel import batch as tbatch
from gomel_tpu_torch.parallel.mesh import make_mesh

SIZES = [(64, 16), (256, 64), (512, 128)]
DTYPES = {"f64": (np.float64, torch.float64, jnp.float64),
       "f32": (np.float32, torch.float32, jnp.float32)}


def _peak_close(got, want, tol):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _mel_close(got, want):
    """tests/test_torch_mel.py's float32 encode tolerance: the magnitudes
    (exp of the log-mel) within 1e-5 of their peak."""
    got, want = np.exp(np.asarray(got, np.float64)), \
        np.exp(np.asarray(want, np.float64))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())


def _decode_close(got, want, dt):
    """tests/test_torch_phase.py's decode tolerance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-9 if dt == "f64" else 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _signal(rows, n, hop, frames, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, n + (frames - 1) * hop + 5)) \
        .astype(dtype)


def _pcm(rows, n, hop, frames, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, size=(rows, n + (frames - 1) * hop + 5),
                        dtype=np.int16)


# -- frame_chunk on the batch encodes -------------------------------------------

@pytest.mark.parametrize("chunk", [1, 3, 7, 64])
@pytest.mark.parametrize("n,hop", SIZES)
def test_mel_encode_batch_frame_chunk(n, hop, chunk):
    """Chunked equals unchunked bit for bit (each frame is computed alone);
    the JAX chunked encode within tests/test_torch_mel.py's tolerance."""
    x = _signal(3, n, hop, 23, seed=n + chunk)
    w = mel_weights(n // 2, 24, 0.0, 4000.0).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    base = tmel.mel_encode_batch(tx, 24, n, hop, tw)
    got = tmel.mel_encode_batch(tx, 24, n, hop, tw, None, "auto", chunk)
    assert torch.equal(got, base)
    want = np.asarray(jmel.mel_encode_batch(jnp.asarray(x), 24, n, hop,
                                            jnp.asarray(w), frame_chunk=chunk))
    _mel_close(got.numpy(), want)


@pytest.mark.parametrize("scale", ["one", "per_row"])
@pytest.mark.parametrize("chunk", [1, 5, 64])
@pytest.mark.parametrize("n,hop", SIZES)
def test_mel_encode_batch_frame_chunk_int16(n, hop, chunk, scale):
    """An int16 batch: chunked equals unchunked bit for bit, and both equal
    the float encode of the rows divided by their scales (powers of two, so
    exact); the JAX chunked encode of those floats within
    tests/test_torch_mel.py's tolerance."""
    pcm = _pcm(3, n, hop, 19, seed=n + chunk)
    scales = (np.float32(32768.0) if scale == "one"
              else np.array([32768.0, 65536.0, 32768.0], np.float32))
    w = torch.from_numpy(mel_weights(n // 2, 24, 0.0, 4000.0)
                         .astype(np.float32))
    tp = torch.from_numpy(pcm)
    base = tmel.mel_encode_batch(tp, 24, n, hop, w, pcm_scale=scales)
    got = tmel.mel_encode_batch(tp, 24, n, hop, w, frame_chunk=chunk,
                                pcm_scale=scales)
    assert torch.equal(got, base)
    x = pcm.astype(np.float32) / np.reshape(scales, (-1, 1))
    assert torch.equal(got, tmel.mel_encode_batch(torch.from_numpy(x), 24, n,
                                                  hop, w, frame_chunk=chunk))
    want = np.asarray(jmel.mel_encode_batch(jnp.asarray(x), 24, n, hop,
                                            jnp.asarray(w.numpy()),
                                            frame_chunk=chunk))
    _mel_close(got.numpy(), want)


@pytest.mark.parametrize("chunk", [None, 5])
@pytest.mark.parametrize("n,hop", SIZES)
def test_mel_encode_int16_row(n, hop, chunk):
    """The single-row encode of an int16 [L] equals the encode of the row
    divided by 65536 (a power of two, so exact), bit for bit, chunked or
    not; the JAX encode of those floats within tests/test_torch_mel.py's
    tolerance."""
    pcm = _pcm(1, n, hop, 17, seed=3 * n)[0]
    w = torch.from_numpy(mel_weights(n // 2, 24, 0.0, 4000.0)
                         .astype(np.float32))
    got = tmel.mel_encode(torch.from_numpy(pcm), 24, n, hop, w,
                          frame_chunk=chunk, pcm_scale=65536.0)
    x = pcm.astype(np.float32) / np.float32(65536.0)
    assert torch.equal(got, tmel.mel_encode(torch.from_numpy(x), 24, n, hop,
                                            w))
    want = np.asarray(jmel.mel_encode(jnp.asarray(x), 24, n, hop,
                                      jnp.asarray(w.numpy())))
    _mel_close(got.numpy(), want)


@pytest.mark.parametrize("source", ["float", "int16"])
@pytest.mark.parametrize("chunk", [1, 3, 7, 64])
@pytest.mark.parametrize("n,hop", SIZES)
def test_phase_encode_batch_frame_chunk(n, hop, chunk, source):
    """Chunked equals unchunked bit for bit, from float rows and from int16
    rows (KA's 1/32768, exact); the JAX chunked encode within 1e-6 of its
    peak."""
    nf = n // 2 - 3
    if source == "int16":
        pcm = _pcm(2, n, hop, 21, seed=n + chunk)
        tx = torch.from_numpy(pcm)
        x = pcm.astype(np.float32) / np.float32(32768.0)
    else:
        x = _signal(2, n, hop, 21, seed=n + chunk)
        tx = torch.from_numpy(x)
    base = tphase.phase_encode_batch(tx, nf, n, hop)
    got = tphase.phase_encode_batch(tx, nf, n, hop, None, "auto", chunk)
    assert torch.equal(got, base)
    want = np.asarray(jphase.phase_encode_batch(jnp.asarray(x), nf, n, hop,
                                                frame_chunk=chunk))
    _peak_close(got.numpy(), want, 1e-6)


# -- frame_chunk on the decodes -------------------------------------------------

@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("chunk", [3, 4, 9])
@pytest.mark.parametrize("n,hop", SIZES)
def test_phase_decode_frame_chunk(n, hop, chunk, dt):
    """phase_decode with frame_chunk (JAX positional order) against the
    unchunked decode and the JAX chunked decode, within the decode
    tolerance."""
    np_dt, t_dt, j_dt = DTYPES[dt]
    rng = np.random.default_rng(n + chunk)
    spec = rng.standard_normal((17, n // 2 - 2, 2)).astype(np_dt)
    ts = torch.from_numpy(spec)
    got = tphase.phase_decode(ts, n, hop, 1.5, None, "auto", chunk)
    _decode_close(got.numpy(), tphase.phase_decode(ts, n, hop, 1.5).numpy(),
                  dt)
    want = np.asarray(jphase.phase_decode(jnp.asarray(spec, j_dt), n, hop, 1.5,
                                          frame_chunk=chunk))
    _decode_close(got.numpy(), want, dt)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("chunk", [3, 4, 9])
@pytest.mark.parametrize("n,hop", SIZES)
def test_istft_direct_planes_frame_chunk(n, hop, chunk, dt):
    """istft_direct_planes with frame_chunk against the unchunked call and
    the JAX chunked call, within the decode tolerance."""
    np_dt, _, _ = DTYPES[dt]
    rng = np.random.default_rng(2 * n + chunk)
    re = rng.standard_normal((15, n // 2 + 1)).astype(np_dt)
    im = rng.standard_normal((15, n // 2 + 1)).astype(np_dt)
    w = hann_window(n).astype(np_dt)
    tre, tim = torch.from_numpy(re), torch.from_numpy(im)
    got = tistft.istft_direct_planes(tre, tim, hop, w, "auto", chunk)
    _decode_close(got.numpy(),
                  tistft.istft_direct_planes(tre, tim, hop, w).numpy(), dt)
    want = np.asarray(jistft.istft_direct_planes(
        jnp.asarray(re), jnp.asarray(im), hop, w, frame_chunk=chunk))
    _decode_close(got.numpy(), want, dt)


@pytest.mark.parametrize("where", ["phase_decode", "istft_direct_planes",
                                   "chunked_irfft_overlap_add"])
@pytest.mark.parametrize("n,hop", SIZES)
def test_frame_chunk_too_small_raises_jax_error(n, hop, where):
    """A chunk with chunk * hop < N - hop raises the JAX program's
    ValueError, with its text."""
    chunk = (n - hop) // hop - 1
    rng = np.random.default_rng(0)
    spec = rng.standard_normal((9, n // 2, 2))
    re, im = jphase.grow_half_planes(jnp.asarray(spec), n // 2)
    re, im = np.asarray(re), np.asarray(im)
    w = hann_window(n)
    calls = {
        "phase_decode": (
            lambda: jphase.phase_decode(jnp.asarray(spec), n, hop,
                                        frame_chunk=chunk),
            lambda: tphase.phase_decode(torch.from_numpy(spec), n, hop,
                                        frame_chunk=chunk)),
        "istft_direct_planes": (
            lambda: jistft.istft_direct_planes(jnp.asarray(re),
                                               jnp.asarray(im), hop, w,
                                               frame_chunk=chunk),
            lambda: tistft.istft_direct_planes(torch.from_numpy(re),
                                               torch.from_numpy(im), hop, w,
                                               frame_chunk=chunk)),
        "chunked_irfft_overlap_add": (
            lambda: jistft.chunked_irfft_overlap_add(
                jnp.asarray(re), jnp.asarray(im), hop, jnp.asarray(w), chunk),
            lambda: tistft.chunked_irfft_overlap_add(
                torch.from_numpy(re), torch.from_numpy(im), hop,
                torch.from_numpy(w), chunk)),
    }
    jax_call, port_call = calls[where]
    with pytest.raises(ValueError) as j:
        jax_call()
    with pytest.raises(ValueError) as t:
        port_call()
    assert str(t.value) == str(j.value)


# -- chunked_irfft_overlap_add's frame_mask --------------------------------------

@pytest.mark.parametrize("mask", ["prefix", "scattered", "none", "empty"])
@pytest.mark.parametrize("n,hop", SIZES)
def test_chunked_irfft_overlap_add_frame_mask(n, hop, mask):
    """The JAX names and order (window_arr, chunk, fft_backend, frame_mask)
    with a prefix mask (KG's real-frame count), a scattered one (the masked
    frames' planes zeroed), none and all False: within 1e-9 of the JAX scan
    (float64)."""
    f = 13
    rng = np.random.default_rng(n)
    re = rng.standard_normal((f, n // 2 + 1))
    im = rng.standard_normal((f, n // 2 + 1))
    w = hann_window(n)
    m = {"prefix": np.arange(f) < 8,
         "scattered": rng.random(f) < 0.5,
         "none": None, "empty": np.zeros(f, bool)}[mask]
    chunk = -(-(n - hop) // hop) + 1
    want = np.asarray(jistft.chunked_irfft_overlap_add(
        jnp.asarray(re), jnp.asarray(im), hop, jnp.asarray(w), chunk, "xla",
        None if m is None else jnp.asarray(m)))
    got = tistft.chunked_irfft_overlap_add(
        torch.from_numpy(re), torch.from_numpy(im), hop,
        window_arr=torch.from_numpy(w), chunk=chunk, fft_backend="xla",
        frame_mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    if m is not None and mask == "prefix":
        by_count = tistft.chunked_irfft_overlap_add(
            torch.from_numpy(re), torch.from_numpy(im), hop,
            torch.from_numpy(w), chunk, real_frames=8)
        assert torch.equal(got, by_count)


def test_chunked_irfft_overlap_add_mask_checks():
    """A mask of the wrong length raises ValueError; a mask and a count
    together raise TypeError."""
    re = torch.zeros((5, 33), dtype=torch.float64)
    w = torch.from_numpy(hann_window(64))
    with pytest.raises(ValueError, match="frame_mask"):
        tistft.chunked_irfft_overlap_add(re, re, 16, w, 4,
                                         frame_mask=np.ones(4, bool))
    with pytest.raises(TypeError, match="not both"):
        tistft.chunked_irfft_overlap_add(re, re, 16, w, 4,
                                         frame_mask=np.ones(5, bool),
                                         real_frames=3)


# -- griffin_lim in the JAX order ------------------------------------------------

@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("n_iter", [0, 2])
@pytest.mark.parametrize("n,hop", SIZES)
def test_griffin_lim_jax_positional_key(n, hop, n_iter, dt):
    """griffin_lim(mag, hop, n_iter, key) with a JAX PRNGKey: the JAX
    start's bits at 0 iterations; at 2, the JAX result within the decode
    tolerance. The window by position after the key gives the same."""
    np_dt, t_dt, j_dt = DTYPES[dt]
    rng = np.random.default_rng(n)
    mag = np.abs(rng.standard_normal((11, n // 2 + 1))).astype(np_dt)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jgl.griffin_lim(jnp.asarray(mag, j_dt), hop, n_iter,
                                      key))
    got = tgl.griffin_lim(torch.from_numpy(mag), hop, n_iter, key)
    assert got.dtype == t_dt
    if n_iter == 0:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _decode_close(got.numpy(), want, dt)
    w = hann_window(n).astype(np_dt)
    assert torch.equal(tgl.griffin_lim(torch.from_numpy(mag), hop, n_iter,
                                       key, w), got)


@pytest.mark.parametrize("window", ["numpy", "tensor"])
def test_griffin_lim_stale_positional_window_raises(window):
    """The old order (window fourth) raises TypeError naming window=."""
    mag = torch.ones((4, 33), dtype=torch.float64)
    w = hann_window(64)
    w = torch.from_numpy(w) if window == "tensor" else w
    with pytest.raises(TypeError, match="window="):
        tgl.griffin_lim(mag, 16, 1, w, init=torch.zeros(112,
                                                        dtype=torch.float64))


def test_mel_decode_passes_the_key_in_order():
    """mel_decode (which calls griffin_lim in the JAX order) from a JAX
    PRNGKey: the JAX decode's bits at 0 iterations."""
    n, hop, mels = 256, 64, 24
    inv = np.linalg.pinv(mel_weights(n // 2, mels, 0.0, 4000.0))
    logmel = np.random.default_rng(3).standard_normal((9, mels, 2)) * 0.1
    key = jax.random.PRNGKey(11)
    want = np.asarray(jmel.mel_decode(jnp.asarray(logmel), n, hop,
                                      jnp.asarray(inv), 0, key))
    got = tmel.mel_decode(torch.from_numpy(logmel), n, hop,
                          torch.from_numpy(inv), 0, key)
    np.testing.assert_array_equal(got.numpy(), want)


# -- the batch codecs' JAX order and local_rows -----------------------------------

def test_batched_codecs_take_the_jax_order():
    """BatchedMel(config, mesh, dtype, gl_momentum, input_mode) and
    BatchedPhase(config, mesh, dtype, input_mode) by position."""
    mc = MelConfig(window=64, resolut=256, num_mels=24, mel_fmax=4000.0)
    bm = tbatch.BatchedMel(mc, None, torch.float32, device="cpu")
    assert bm.mesh is None and bm.dtype == torch.float32
    bm = tbatch.BatchedMel(mc, None, torch.float64, 0.5, "replicated",
                           device="cpu")
    assert bm.gl_momentum == 0.5 and bm.dtype == torch.float64
    assert bm.input_mode == "replicated"
    bp = tbatch.BatchedPhase(PhaseConfig(), None, device="cpu")
    assert bp.mesh is None and bp.dtype == torch.float32
    mesh = make_mesh(data=2, frame=4, devices=[torch.device("cpu")] * 8)
    bm = tbatch.BatchedMel(mc, mesh)
    assert bm.mesh is mesh and bm.device == torch.device("cpu")
    bp = tbatch.BatchedPhase(PhaseConfig(), mesh, torch.float64)
    assert bp.mesh is mesh and bp.dtype == torch.float64
    x = _signal(2, 256, 64, 5, seed=1)
    np.testing.assert_array_equal(
        tbatch.local_rows(global_arr=bm.encode(x), n_rows=1),
        tbatch.BatchedMel(mc, device="cpu").encode(x).numpy()[:1])


# -- pipelines exports -------------------------------------------------------------

PIPELINE_NAMES = ["Mel", "Phase", "LongFormMel", "LongFormPhase",
                  "StreamingMel", "StreamingPhase", "save_gl_checkpoint",
                  "load_gl_checkpoint", "save_gl_checkpoint_sharded",
                  "load_gl_checkpoint_sharded", "prune_gl_checkpoints"]


@pytest.mark.parametrize("name", PIPELINE_NAMES)
def test_pipelines_exports(name):
    """``from gomel_tpu_torch.pipelines import <name>`` gives the module's
    own object, and ``__all__`` is the JAX package's."""
    import gomel_tpu.pipelines as jpipes
    assert pipelines.__all__ == jpipes.__all__
    module = {"Mel": "mel", "Phase": "phase", "StreamingMel": "streaming",
              "StreamingPhase": "streaming"}.get(name, "longform")
    own = getattr(importlib.import_module(
        f"gomel_tpu_torch.pipelines.{module}"), name)
    assert getattr(pipelines, name) is own


# -- ops/mxu_fft ----------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("n", [64, 256, 4096])
def test_mxu_fft_matches_jax(n, dt):
    """rfft, rfft_mag and irfft against the JAX module's matmul FFT run on
    the CPU: float64 within 1e-9 of the peak, float32 within 1e-5."""
    np_dt, t_dt, j_dt = DTYPES[dt]
    tol = 1e-9 if dt == "f64" else 1e-5
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)).astype(np_dt)
    jre, jim = jmxu.rfft(jnp.asarray(x), n)
    tre, tim = tmxu.rfft(torch.from_numpy(x), n)
    assert tre.dtype == t_dt and tre.shape == (3, n // 2 + 1)
    _peak_close(tre.numpy(), jre, tol)
    _peak_close(tim.numpy(), jim, tol)
    _peak_close(tmxu.rfft_mag(torch.from_numpy(x), n, None).numpy(),
                jmxu.rfft_mag(jnp.asarray(x), n), tol)
    re = rng.standard_normal((3, n // 2 + 1)).astype(np_dt)
    im = rng.standard_normal((3, n // 2 + 1)).astype(np_dt)
    _peak_close(tmxu.irfft(torch.from_numpy(re), torch.from_numpy(im), n,
                           jax.lax.Precision.DEFAULT).numpy(),
                jmxu.irfft(jnp.asarray(re), jnp.asarray(im), n), tol)


@pytest.mark.parametrize("start", range(2, 8193, 1024))
def test_mxu_fft_supported_matches_jax(start):
    """supported(n) is the JAX module's answer for every n in 2..8192, and
    an n it refuses raises ValueError in rfft, as in the JAX module."""
    for n in range(start, min(start + 1024, 8193)):
        assert tmxu.supported(n) == jmxu.supported(n), n
    refused = next(n for n in range(start, 8193) if not jmxu.supported(n))
    with pytest.raises(ValueError):
        jmxu.rfft(jnp.zeros((refused,)), refused)
    with pytest.raises(ValueError):
        tmxu.rfft(torch.zeros(refused), refused)
