"""Each kernel module of the port (plain version, on the CPU) against the JAX
function it replaces.

The same numpy inputs, made from a seed, go through the JAX op (on the CPU;
for the FFT also through the TPU kernel's own matrix-unit math, backend
"mxu", run on the CPU) and through the port's wrapper, which runs its plain
PyTorch version because the tensor lies on the CPU. Tolerances are stated
at each comparison. The CUDA kernels themselves are held to these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gomel_tpu.core.config import PAD_SHIFT_TABLE
from gomel_tpu.core.filterbank import mel_weights
from gomel_tpu.ops import fftbackend as jfft
from gomel_tpu.ops import istft as jistft
from gomel_tpu.ops import mel_ops as jmel
from gomel_tpu.ops import phase_ops as jphase
from gomel_tpu.ops import quantize as jq
from gomel_tpu.ops import resample as jres
from gomel_tpu.ops import stft as jstft
from gomel_tpu_torch.ops import fftbackend as tfft
from gomel_tpu_torch.ops import istft as tistft
from gomel_tpu_torch.ops import mel_ops as tmel
from gomel_tpu_torch.ops import phase_ops as tphase
from gomel_tpu_torch.ops import quantize as tq
from gomel_tpu_torch.ops import resample as tres
from gomel_tpu_torch.ops import rfft_mag as trfft
from gomel_tpu_torch.ops import stft as tstft

DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "f64": (np.float64, torch.float64, jnp.float64)}


@pytest.mark.parametrize("shape,scale,pad_to", [
    ((3001,), 32768.0, 0), ((3001,), 65536.0, 5119), ((2999, 2), 32768.0, 4000),
    ((2999, 2), 65536.0, 100)])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_pcm16_ingest_bit_exact(shape, scale, pad_to, dt):
    np_dt, t_dt, j_dt = DTYPES[dt]
    pcm = np.random.default_rng(0).integers(-32768, 32768, size=shape,
                                            dtype=np.int16)
    ref = np.asarray(jq.pcm16_ingest(jnp.asarray(pcm), j_dt, scale, pad_to))
    out = tq.pcm16_ingest(torch.from_numpy(pcm), t_dt, scale, pad_to).numpy()
    assert out.dtype == ref.dtype == np_dt
    np.testing.assert_array_equal(out, ref)   # exact: every step is exact


def test_pcm16_ingest_batch_rows_equal_single():
    pcm = np.random.default_rng(1).integers(-32768, 32768, size=(3, 1000),
                                            dtype=np.int16)
    out = tq.pcm16_ingest_batch(torch.from_numpy(pcm), torch.float32,
                                32768.0, 1500).numpy()
    for r in range(3):
        ref = np.asarray(jq.pcm16_ingest(jnp.asarray(pcm[r]), jnp.float32,
                                         32768.0, 1500))
        np.testing.assert_array_equal(out[r], ref)


def test_ingest_rejects_unknown_layouts():
    with pytest.raises(ValueError):
        tq.pcm16_ingest(torch.zeros((10, 3), dtype=torch.int16),
                        torch.float32, 32768.0)
    with pytest.raises(ValueError):
        tq.pcm16_ingest_batch(torch.zeros(10, dtype=torch.int16),
                              torch.float32, 32768.0)


@pytest.mark.parametrize("n,hop,length", [(4096, 1280, 30 * 1280 + 4095),
                                          (512, 128, 5000), (16, 5, 61)])
def test_frame_signal_and_window_equal(n, hop, length):
    x = np.random.default_rng(2).standard_normal(length)
    ref = np.asarray(jstft.frame_signal(jnp.asarray(x), n, hop))
    out = tstft.frame_signal(torch.from_numpy(x), n, hop).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(tstft.hann_window(n), jstft.hann_window(n))


def test_frame_signal_too_short():
    with pytest.raises(ValueError):
        tstft.frame_signal(torch.zeros(100), 128, 32)


def _jax_stft_mag(x, n, hop, backend, j_dt):
    xj = jnp.asarray(x, j_dt)
    win = jnp.asarray(jstft.hann_window(n), j_dt)
    frames = jstft.frame_signal(xj, n, hop) * win
    return np.asarray(jfft.rfft_mag(frames, n, backend))


@pytest.mark.parametrize("backend", ["mxu", "xla"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("n,hop", [(4096, 1280), (512, 128)])
def test_stft_mag_vs_jax(backend, dt, n, hop):
    np_dt, t_dt, j_dt = DTYPES[dt]
    x = np.random.default_rng(3).standard_normal(8 * hop + n - 1).astype(np_dt)
    ref = _jax_stft_mag(x, n, hop, backend, j_dt)
    win = torch.tensor(tstft.hann_window(n), dtype=t_dt)
    out = trfft.stft_mag(torch.from_numpy(x), win, n, hop).numpy()
    assert out.shape == ref.shape == (8, n // 2 + 1)
    assert out.dtype == np_dt
    # f64: both exact to rounding; f32: two float32 FFTs, ~1e-6 of the peak
    tol = 1e-9 if dt == "f64" else 1e-5
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * float(ref.max()))


def test_stft_mag_batch_rows_equal_single():
    x = np.random.default_rng(4).standard_normal((2, 5000))
    win = torch.tensor(tstft.hann_window(512))
    both = trfft.stft_mag(torch.from_numpy(x), win, 512, 128)
    for r in range(2):
        one = trfft.stft_mag(torch.from_numpy(x[r]), win, 512, 128)
        torch.testing.assert_close(both[r], one, rtol=0, atol=1e-12)


def test_fftbackend_rfft_mag_vs_jax():
    frames = np.random.default_rng(5).standard_normal((3, 7, 256))
    ref = np.asarray(jfft.rfft_mag(jnp.asarray(frames), 256, "xla"))
    out = tfft.rfft_mag(torch.from_numpy(frames), 256).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9 * float(ref.max()))
    with pytest.raises(ValueError):
        tfft.rfft_mag(torch.from_numpy(frames), 512)


def test_twiddles_are_rounded_float64():
    tw = trfft._twiddles_np(4096)
    assert tw.shape == (2048, 2) and tw.dtype == np.float32
    ref = np.exp(-2j * np.pi * np.arange(2048) / 4096)
    np.testing.assert_array_equal(tw[:, 0], ref.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], ref.imag.astype(np.float32))
    # the even sizes of the TPU's n1 * n2 split (both factors <= 128):
    # 4094 = 46 x 89 and 3000 = 24 x 125 run the kernels' mixed radix
    assert trfft.supported(4096) and trfft.supported(4) and trfft.supported(16384)
    assert trfft.supported(4094) and trfft.supported(3000)
    assert not (trfft.supported(514) or trfft.supported(32768)
                or trfft.supported(4097))


@pytest.mark.parametrize("n_bins,n_mels,fmax", [(2048, 192, 16000.0),
                                                (256, 40, 8000.0)])
def test_mel_from_mags_vs_jax_f64(n_bins, n_mels, fmax):
    rng = np.random.default_rng(6)
    mags = rng.standard_normal((2, 9, n_bins + 1)) ** 2 * 30.0
    mags[0, 0] = 0.0          # a silent frame: every band clamps to 1e-5
    w = mel_weights(n_bins, n_mels, 0.0, fmax)
    ref = np.asarray(jmel._mel_from_mags(jnp.asarray(mags), jnp.asarray(w)))
    out = tmel._mel_from_mags(torch.from_numpy(mags), torch.from_numpy(w)).numpy()
    assert out.shape == ref.shape == (2, 9, n_mels, 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10)


def test_extended_weight_bands_cover_every_nonzero():
    """The CUDA kernel sums column c over bins [lo[c], hi[c]) only; that is
    the dense product exactly when no non-zero lies outside the band."""
    w = mel_weights(2048, 192, 0.0, 16000.0)
    we, lo, hi = tmel._extended_weights(torch.from_numpy(w))
    we, lo, hi = we.numpy(), lo.numpy(), hi.numpy()
    np.testing.assert_array_equal(
        we, jmel._extended_weights(jnp.asarray(w)))
    rows = np.arange(we.shape[0])[:, None]
    inside = (rows >= lo[None, :]) & (rows < hi[None, :])
    assert not np.any(we[~inside])
    assert np.all(hi >= lo)
    mags = np.random.default_rng(7).random((4, we.shape[0]))
    banded = np.stack([[mags[r, lo[c]:hi[c]] @ we[lo[c]:hi[c], c]
                        for c in range(we.shape[1])] for r in range(4)])
    np.testing.assert_allclose(banded, mags @ we, rtol=1e-13, atol=0)


def test_extended_weights_follow_in_place_writes():
    w = torch.from_numpy(mel_weights(256, 40, 0.0, 8000.0))
    mags = torch.rand(3, 257, dtype=torch.float64)
    before = tmel._mel_from_mags(mags, w)
    w.mul_(2.0)
    after = tmel._mel_from_mags(mags, w)
    live = before > np.log(1e-4)
    torch.testing.assert_close(after[live], before[live] + np.log(2.0),
                               rtol=0, atol=1e-12)


def test_spectral_normalize_vs_jax():
    x = np.array([0.0, 1e-7, 1e-5, 0.5, 3.0, np.nan])
    ref = np.asarray(jmel.spectral_normalize(jnp.asarray(x)))
    out = tmel.spectral_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, ref)


def _log_mel_like(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 2.5 - 4.0).astype(np.float32)


@pytest.mark.parametrize("shape", [(110, 192, 2), (7, 40, 2), (1, 1, 2)])
def test_quantize_mel_plane_bit_exact(shape):
    spec = _log_mel_like(shape, 8)
    img_j, mx_j, mn_j = jq.quantize_mel_plane(jnp.asarray(spec), 255)
    img, mx, mn = tq.quantize_mel_plane(torch.from_numpy(spec), 255)
    assert img.dtype == torch.uint8 and img.shape == (shape[1], shape[0], 2)
    np.testing.assert_array_equal(img.numpy(), np.asarray(img_j))
    assert float(mx) == float(mx_j) and float(mn) == float(mn_j)


def test_quantize_mel_plane_batch_bit_exact():
    spec = _log_mel_like((3, 50, 64, 2), 9)
    spec[1] = -2.0            # a constant row: degenerate range -> 0.5 -> 127
    img_j, mx_j, mn_j = jq.quantize_mel_plane_batch(jnp.asarray(spec), 255)
    img, mx, mn = tq.quantize_mel_plane_batch(torch.from_numpy(spec), 255)
    np.testing.assert_array_equal(img.numpy(), np.asarray(img_j))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(mx_j))
    np.testing.assert_array_equal(mn.numpy(), np.asarray(mn_j))
    assert np.all(img.numpy()[1] == 127)
    with pytest.raises(ValueError):
        tq.quantize_mel_plane_batch(torch.from_numpy(spec[0]), 255)


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Only a CPU tensor takes the plain version; any other device must reach
    a kernel or raise, never fall back."""
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        tq.pcm16_ingest(torch.zeros(16, dtype=torch.int16, device=meta),
                        torch.float32, 32768.0)
    with pytest.raises(ValueError):
        trfft.stft_mag(torch.zeros(64, device=meta), None, 16, 4)
    with pytest.raises(ValueError):
        tq.quantize_mel_plane(torch.zeros((4, 3, 2), device=meta))
    w = torch.from_numpy(mel_weights(8, 2, 0.0, 8000.0)).float()
    with pytest.raises(ValueError):
        tmel._mel_from_mags(torch.zeros((3, 9), device=meta), w)
    with pytest.raises(ValueError):
        tq.pcm16_ingest(torch.zeros(16, dtype=torch.int16, device=meta),
                        torch.float32, 32768.0, 0, 1, 2)
    with pytest.raises(ValueError):
        trfft.stft_planes(torch.zeros(64, device=meta), None, 16, 4, 1, 8)
    with pytest.raises(ValueError):
        tq.quantize_planes(torch.zeros((4, 3, 2), device=meta), 255)
    with pytest.raises(ValueError):
        tistft.irfft_window(torch.zeros((3, 9), device=meta),
                            torch.zeros((3, 9), device=meta), 16)
    with pytest.raises(ValueError):
        tistft.overlap_add(torch.zeros((3, 16), device=meta), 4)
    with pytest.raises(ValueError):
        tphase.dequantize_decode(
            torch.zeros((8, 3, 2), dtype=torch.uint8, device=meta),
            [1.0, 1.0], [0.0, 0.0], 255, 0, 16, 4)


# -- phase codec ops ------------------------------------------------------------

RATES = sorted(PAD_SHIFT_TABLE)


@pytest.mark.parametrize("sr", RATES)
def test_zero_stuff_upsample_bit_exact(sr):
    zp, zs = PAD_SHIFT_TABLE[sr]
    x = np.random.default_rng(sr).standard_normal(1001).astype(np.float32)
    ref = np.asarray(jres.zero_stuff_upsample(jnp.asarray(x), zp, zs))
    out = tres.zero_stuff_upsample(torch.from_numpy(x), zp, zs).numpy()
    host = tres.zero_stuff_upsample(x, zp, zs)
    np.testing.assert_array_equal(out, ref)      # exact: one product each
    np.testing.assert_array_equal(host, jres.zero_stuff_upsample(x, zp, zs))
    assert len(out) == (1001 if zp == 0 else 1001 + -(-1001 // zp) * zs)


@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("shape", [(3001,), (2999, 2)])
def test_pcm16_ingest_zero_stuff_bit_exact(sr, shape):
    zp, zs = PAD_SHIFT_TABLE[sr]
    pcm = np.random.default_rng(sr + len(shape)).integers(
        -32768, 32768, size=shape, dtype=np.int16)
    ref = np.asarray(jq.pcm16_ingest(jnp.asarray(pcm), jnp.float32, 32768.0,
                                     20479, zp, zs))
    out = tq.pcm16_ingest(torch.from_numpy(pcm), torch.float32, 32768.0,
                          20479, zp, zs).numpy()
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)   # bit-exact in float32
    mono = pcm[:, 0].copy() if pcm.ndim == 2 else pcm
    rows = tq.pcm16_ingest_batch(torch.from_numpy(np.stack([mono, mono])),
                                 torch.float32, 32768.0, 20479, zp, zs).numpy()
    ref1 = np.asarray(jq.pcm16_ingest(jnp.asarray(mono), jnp.float32, 32768.0,
                                      20479, zp, zs))
    np.testing.assert_array_equal(rows[1], ref1)
    with pytest.raises(ValueError):
        tq.pcm16_ingest(torch.from_numpy(pcm), torch.float32, 32768.0, 0, 0, 1)


def _signal(n, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("n,hop,nf", [(4096, 1280, 1536), (4096, 1280, 2048),
                                      (512, 128, 100)])
def test_phase_encode_vs_jax(dt, n, hop, nf):
    np_dt, t_dt, j_dt = DTYPES[dt]
    x = _signal(9 * hop + n, n + nf, np_dt)
    win = jstft.hann_window(n).astype(np_dt)
    ref = np.asarray(jphase.phase_encode(jnp.asarray(x), nf, n, hop,
                                         jnp.asarray(win)))
    out = tphase.phase_encode(torch.from_numpy(x), nf, n, hop,
                              torch.from_numpy(win)).numpy()
    assert out.shape == ref.shape == (10, nf, 2) and out.dtype == np_dt
    peak = np.abs(ref).max(axis=(1, 2), keepdims=True)
    if dt == "f64":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9)
    else:   # two float32 FFTs: within 1e-5 of each frame's peak
        assert np.all(np.abs(out - ref) <= 1e-5 * peak)
    xb = np.stack([x, x[::-1].copy()])
    refb = np.asarray(jphase.phase_encode_batch(jnp.asarray(xb), nf, n, hop,
                                                jnp.asarray(win)))
    outb = tphase.phase_encode_batch(torch.from_numpy(xb), nf, n, hop,
                                     torch.from_numpy(win)).numpy()
    np.testing.assert_allclose(outb, refb, rtol=0,
                               atol=(1e-9 if dt == "f64" else 1e-5 * float(
                                   np.abs(refb).max())))


def test_fftbackend_planes_vs_jax():
    frames = np.random.default_rng(9).standard_normal((3, 7, 256))
    re_j, im_j = jfft.rfft_planes(jnp.asarray(frames), 256, "xla")
    re, im = tfft.rfft_planes(torch.from_numpy(frames), 256)
    np.testing.assert_allclose(re.numpy(), np.asarray(re_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(im.numpy(), np.asarray(im_j), rtol=0, atol=1e-12)
    back_j = np.asarray(jfft.irfft_planes(re_j, im_j, 256, "xla"))
    back = tfft.irfft_planes(re, im, 256).numpy()
    np.testing.assert_allclose(back, back_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(back, frames, rtol=0, atol=1e-12)


@pytest.mark.parametrize("ihs,max_val", [(0, 255), (2, 255), (0, 65535)])
def test_quantize_planes_vs_jax(ihs, max_val):
    spec = (np.random.default_rng(10).standard_normal((3, 50, 64, 2)) * 40
            ).astype(np.float32)
    spec[1, :, :, 0] = 2.5    # a constant channel: degenerate range -> 0.5
    img_j, mx_j, mn_j = jq.quantize_planes_batch(jnp.asarray(spec), max_val, ihs)
    img, mx, mn = tq.quantize_planes_batch(torch.from_numpy(spec), max_val, ihs)
    assert img.dtype == (torch.uint16 if max_val > 255 else torch.uint8)
    assert img.shape == (3, 64, 50, 2)
    # extrema within 1 ulp (asinh is a libm call on each side)
    np.testing.assert_array_max_ulp(mx.numpy(), np.asarray(mx_j), maxulp=1)
    np.testing.assert_array_max_ulp(mn.numpy(), np.asarray(mn_j), maxulp=1)
    d = np.abs(img.numpy().astype(np.int64) - np.asarray(img_j).astype(np.int64))
    # at most 1 step (2 for 16 bits), rarely (tests/test_device_quantize.py)
    assert d.max() <= (2 if max_val > 255 else 1) and (d > 0).mean() < 2e-3
    assert np.all(img.numpy()[1, :, :, 0] == max_val // 2)
    one = tq.quantize_planes(torch.from_numpy(spec[0]), max_val, ihs)
    assert torch.equal(one[0], img[0]) and torch.equal(one[1], mx[0])


@pytest.mark.parametrize("ihs,max_val", [(0, 255), (2, 255), (0, 65535)])
def test_dequantize_planes_vs_jax(ihs, max_val):
    rng = np.random.default_rng(11)
    dt = np.uint16 if max_val > 255 else np.uint8
    img = rng.integers(0, max_val + 1, size=(2, 300, 40, 2)).astype(dt)
    mx = np.array([[3.0, 2.5], [1.0, 2.0]])
    mn = np.array([[-2.0, -3.5], [-1.0, 0.5]])
    ref = np.asarray(jq.dequantize_planes_batch(
        jnp.asarray(img), jnp.asarray(mx, jnp.float32),
        jnp.asarray(mn, jnp.float32), max_val, ihs))
    out = tq.dequantize_planes_batch(torch.from_numpy(img), mx, mn, max_val,
                                     ihs).numpy()
    assert out.dtype == np.float32 and out.shape == (2, 40, 300, 2)
    if ihs == 0:
        np.testing.assert_array_equal(out, ref)   # the same float32 steps
        return
    # sinh(sinh(.)) amplifies a libm ulp of the inner sinh about tenfold here
    # (XLA's and PyTorch's sinh differ by up to 5 ulp): hold both to float64
    lin = tq.dequantize_planes_batch(torch.from_numpy(img), mx, mn, max_val,
                                     0).numpy().astype(np.float64)
    exact = np.sinh(np.sinh(lin))
    scale = np.maximum(np.abs(exact), 1e-30)
    assert (np.abs(out - exact) / scale).max() <= 2e-6
    assert (np.abs(out - ref) / scale).max() <= 4e-6


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("nf,n", [(1536, 4096), (2048, 4096), (5, 16)])
def test_grow_half_planes_exact(dt, nf, n):
    np_dt, _, _ = DTYPES[dt]
    spec = np.random.default_rng(nf).standard_normal((7, nf, 2)).astype(np_dt)
    re_j, im_j = jphase.grow_half_planes(jnp.asarray(spec), n // 2)
    re, im = tphase.grow_half_planes(torch.from_numpy(spec), n // 2)
    np.testing.assert_array_equal(re.numpy(), np.asarray(re_j))
    np.testing.assert_array_equal(im.numpy(), np.asarray(im_j))
    np.testing.assert_array_equal(
        tphase.grow_half_spectrum(torch.from_numpy(spec), n // 2).numpy(),
        np.asarray(jphase.grow_half_spectrum(jnp.asarray(spec), n // 2)))
    np.testing.assert_array_equal(
        tphase.shrink(torch.from_numpy(spec), 3).numpy(),
        np.asarray(jphase.shrink(jnp.asarray(spec), 3)))


@pytest.mark.parametrize("n,hop", [(4096, 1280), (1024, 1024), (1000, 300),
                                   (16, 5)])
@pytest.mark.parametrize("frames", [1, 2, 3, 4, 7, 40])
def test_window_sum_and_normalize_bit_exact(n, hop, frames):
    win = jstft.hann_window(n).astype(np.float32)
    ref = np.asarray(jistft.window_sum(jnp.asarray(win), frames, hop))
    out = tistft.window_sum(torch.from_numpy(win), frames, hop).numpy()
    np.testing.assert_array_equal(out, ref)   # the same float32 formula
    prefix = tistft._prefix_rows(torch.from_numpy(win), hop)
    assert tistft.window_sum_threshold(prefix, frames) == float(
        np.float32(0.5) * ref.max())
    sig = np.random.default_rng(n).standard_normal(ref.shape).astype(np.float32)
    thr = np.float32(0.5) * ref.max()
    nj = np.asarray(jistft.normalize_by_window_sum(
        jnp.asarray(sig), jnp.asarray(ref), jnp.asarray(thr)))
    nt = tistft.normalize_by_window_sum(torch.from_numpy(sig),
                                        torch.from_numpy(out),
                                        torch.tensor(thr)).numpy()
    np.testing.assert_array_equal(nt, nj)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_overlap_add_bit_exact(dt):
    np_dt, _, _ = DTYPES[dt]
    fw = np.random.default_rng(12).standard_normal((9, 1000)).astype(np_dt)
    ref = np.asarray(jistft.overlap_add(jnp.asarray(fw), 300))
    out = tistft.overlap_add(torch.from_numpy(fw), 300).numpy()
    np.testing.assert_array_equal(out, ref)
    both = tistft.overlap_add(torch.from_numpy(np.stack([fw, 2 * fw])), 300)
    np.testing.assert_array_equal(both[0].numpy(), out)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("boost", [0.0, 1.7])
def test_phase_decode_vs_jax(dt, boost):
    np_dt, _, _ = DTYPES[dt]
    n, hop, nf = 4096, 1280, 1536
    spec = (np.random.default_rng(13).standard_normal((12, nf, 2)) * 5
            ).astype(np_dt)
    win = jstft.hann_window(n)
    ref = np.asarray(jphase.phase_decode(jnp.asarray(spec), n, hop, boost,
                                         jnp.asarray(win.astype(np_dt))))
    out = tphase.phase_decode(torch.from_numpy(spec), n, hop, boost,
                              torch.from_numpy(win.astype(np_dt))).numpy()
    assert out.shape == ref.shape == (n + 11 * hop,) and out.dtype == np_dt
    # f64: both exact to rounding; f32: two float32 irffts, 1e-5 of the peak
    tol = 1e-9 if dt == "f64" else 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    re, im = jphase.grow_half_planes(jnp.asarray(spec), n // 2)
    ref_i = np.asarray(jistft.istft_direct_planes(re, im, hop,
                                                  win.astype(np_dt)))
    out_i = tistft.istft_direct_planes(
        torch.from_numpy(np.array(re)), torch.from_numpy(np.array(im)),
        hop, win).numpy()
    np.testing.assert_allclose(out_i, ref_i, rtol=0, atol=tol)
    b = tphase.phase_decode(torch.from_numpy(np.stack([spec, spec])), n, hop,
                            boost, torch.from_numpy(win.astype(np_dt)))
    np.testing.assert_array_equal(b[1].numpy(), out)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("n,hop,window", [(4096, 1280, "hann"),
                                          (512, 128, "rand"),
                                          (3000, 750, None)])
def test_stft_complex_vs_jax(dt, n, hop, window):
    """ops/stft.stft, the complex STFT (gomel_tpu/ops/stft.py:57): within
    1e-5 of each frame's peak of the JAX function in float32 (two float32
    FFTs), 1e-12 in float64; a row of a batch equals the row alone."""
    np_dt, _, _ = DTYPES[dt]
    rng = np.random.default_rng(n + hop)
    x = rng.standard_normal((2, n + 6 * hop + 13)).astype(np_dt)
    w = {"hann": jstft.hann_window(n).astype(np_dt), None: None,
         "rand": rng.uniform(0.1, 1.0, n).astype(np_dt)}[window]
    ref = np.asarray(jstft.stft(jnp.asarray(x[1]), n, hop,
                                None if w is None else jnp.asarray(w)))
    out = tstft.stft(torch.from_numpy(x), n, hop, w).numpy()
    assert out.shape == (2,) + ref.shape and out.dtype == ref.dtype
    peak = np.abs(ref).max(axis=-1, keepdims=True)
    tol = 1e-5 if dt == "f32" else 1e-12
    assert (np.abs(out[1] - ref) <= tol * peak).all()
    np.testing.assert_array_equal(
        tstft.stft(torch.from_numpy(x[1]), n, hop, w).numpy(), out[1])
    with pytest.raises(ValueError, match="too short"):
        tstft.stft(torch.zeros(n - 1), n, hop)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("n,hop,frames", [(1024, 320, 9), (512, 128, 3),
                                          (4096, 1280, 1)])
def test_istft_direct_vs_jax(dt, n, hop, frames):
    """ops/istft.istft_direct, the complex-input iSTFT
    (gomel_tpu/ops/istft.py:182), against the JAX function: 1e-5 of the
    peak in float32 (two float32 irffts), 1e-12 in float64."""
    np_dt, _, _ = DTYPES[dt]
    rng = np.random.default_rng(n + frames)
    spec = (rng.standard_normal((frames, n // 2 + 1))
            + 1j * rng.standard_normal((frames, n // 2 + 1))).astype(
        np.complex64 if dt == "f32" else np.complex128)
    win = jstft.hann_window(n).astype(np_dt)
    ref = np.asarray(jistft.istft_direct(jnp.asarray(spec), hop, win))
    out = tistft.istft_direct(torch.from_numpy(spec), hop, win).numpy()
    assert out.shape == ref.shape == (n + (frames - 1) * hop,)
    assert out.dtype == np_dt
    tol = 1e-12 if dt == "f64" else 1e-5
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))
    np.testing.assert_array_equal(out, tistft.istft_direct_planes(
        torch.from_numpy(spec.real.copy()), torch.from_numpy(spec.imag.copy()),
        hop, win).numpy())


def test_dequantize_decode_is_dequantize_then_decode():
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, size=(1536, 9, 2)).astype(np.uint8)
    mx, mn = np.array([2.0, 3.0]), np.array([-1.0, -4.0])
    ref_pcm, ref_ok = jq.pcm16_encode(jphase.phase_decode(
        jq.dequantize_planes(jnp.asarray(img), jnp.asarray(mx, jnp.float32),
                             jnp.asarray(mn, jnp.float32), 255, 0),
        4096, 1280, 0.0, None))
    pcm, ok = tphase.dequantize_decode(torch.from_numpy(img), mx, mn, 255, 0,
                                       4096, 1280, pcm16=True)
    d = np.abs(pcm.numpy().astype(np.int64) - np.asarray(ref_pcm))
    # float32 irfft differences under PCM-16: at most 1 LSB, rarely
    assert d.max() <= 1 and (d > 0).mean() < 5e-2
    assert bool(ok) == bool(ref_ok)


def test_pcm16_encode_bit_exact_with_nonfinite():
    x = np.array([0.1, -0.2, 0.5 / 32768, 1.5 / 32768, 2.5 / 32768, 1.0, -1.0,
                  1.7, -3.0, -0.0, np.nan, np.inf, -np.inf], np.float32)
    for sl in (slice(0, 10), slice(None)):
        pj, fj = jq.pcm16_encode(jnp.asarray(x[sl]))
        pt, ft = tq.pcm16_encode(torch.from_numpy(x[sl]))
        assert pt.dtype == torch.int16
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        assert bool(ft) == bool(fj)
    assert not bool(tq.pcm16_encode(torch.from_numpy(x))[1])


def test_overlap_normalize_plain_flags_per_row():
    fw = torch.zeros((2, 5, 64))
    fw[1, 0, 3] = float("nan")
    win = torch.from_numpy(jstft.hann_window(64).astype(np.float32))
    pcm, ok = tistft.overlap_normalize(fw, 16, win, pcm16=True)
    assert ok.tolist() == [True, False] and pcm.dtype == torch.int16
    assert np.all(pcm.numpy()[1] == 0)


# -- NaN, the masked batch quantizers and per-row ingest scales --------------

def _nan_plane(np_dt):
    """The [6, 4, 2] plane with one NaN of the repair's report."""
    x = (np.random.default_rng(20).standard_normal((6, 4, 2)) * 3 - 1)
    x[2, 1, 0] = np.nan
    return x.astype(np_dt)


def _same(port: torch.Tensor, ref) -> None:
    """Bit-equal, NaN where the JAX op has NaN."""
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_quantize_nan_plane_vs_jax(dt):
    """A NaN reaches the extrema (JAX's max propagates it) and pins every
    pixel of the row, or of the channel for the phase quantizer, at the
    midpoint."""
    np_dt = DTYPES[dt][0]
    x = _nan_plane(np_dt)
    ref = jq.quantize_mel_plane(jnp.asarray(x))
    out = tq.quantize_mel_plane(torch.from_numpy(x))
    for o, r in zip(out, ref):
        _same(o, r)
    assert np.isnan(float(out[1])) and bool((out[0] == 127).all())
    for max_val in (255, 65535):
        ref = jq.quantize_planes(jnp.asarray(x), max_val)
        out = tq.quantize_planes(torch.from_numpy(x), max_val)
        for o, r in zip(out, ref):
            _same(o, r)
        assert np.isnan(float(out[1][0])) and not np.isnan(float(out[1][1]))
        assert bool((out[0][..., 0] == max_val // 2).all())


def _masked_batch(np_dt, bins=6, scale=3.0):
    """[4, 9, bins, 2] with a NaN in a counted frame of row 1 and one in a
    pad frame of row 2; frames: full, partial, partial, 0."""
    x = np.random.default_rng(21).standard_normal((4, 9, bins, 2)) * scale - 1
    x[1, 2, 3, 0] = np.nan
    x[2, 8, 1, 1] = np.nan
    return x.astype(np_dt), np.array([9, 5, 4, 0], np.int32)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_quantize_mel_masked_vs_jax(dt):
    x, frames = _masked_batch(DTYPES[dt][0])
    ref = jq.quantize_mel_plane_batch(jnp.asarray(x), 255,
                                      frames=jnp.asarray(frames))
    out = tq.quantize_mel_plane_batch(torch.from_numpy(x), 255, frames=frames)
    for o, r in zip(out, ref):
        _same(o, r)   # bit-equal in both dtypes
    mx, mn = out[1].numpy(), out[2].numpy()
    big = np.finfo(DTYPES[dt][0]).max
    assert (mx[3], mn[3]) == (-big, big)     # frames = 0: the sentinels
    assert bool((out[0][3] == 127).all())
    assert np.isnan(mx[1]) and not np.isnan(mx[2])   # counted vs pad NaN


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("max_val,ihs", [(255, 0), (65535, 0), (255, 2),
                                         (65535, 2)])
def test_quantize_planes_masked_vs_jax(dt, max_val, ihs):
    x, frames = _masked_batch(DTYPES[dt][0], bins=40, scale=30.0)
    ref = [np.asarray(r) for r in jq.quantize_planes_batch(
        jnp.asarray(x), max_val, ihs, frames=jnp.asarray(frames))]
    out = [t.numpy() for t in tq.quantize_planes_batch(
        torch.from_numpy(x), max_val, ihs, frames=frames)]
    if ihs == 0:
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o, r)   # bit-equal
    else:
        # XLA's and PyTorch's asinh differ in the last bit (up to 1 ulp in
        # float64): extrema within 4 ulp, planes within 1 step, rarely
        d = np.abs(out[0].astype(np.int64) - ref[0].astype(np.int64))
        assert d.max() <= 1 and (d > 0).mean() < 2e-3
        for o, r in zip(out[1:], ref[1:]):
            np.testing.assert_allclose(o, r, rtol=4 * np.finfo(o.dtype).eps)
    big = np.finfo(DTYPES[dt][0]).max
    assert out[1][3].tolist() == [-big, -big]
    assert bool((out[0][3] == max_val // 2).all())


def test_masked_quantizers_need_one_frame_count_per_row():
    x = torch.zeros((3, 5, 4, 2))
    with pytest.raises(ValueError):
        tq.quantize_mel_plane_batch(x, frames=[5, 5])
    with pytest.raises(ValueError):
        tq.quantize_planes_batch(x, 255, frames=[5, 5, 5, 5])


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_pcm16_ingest_per_row_scales_vs_jax(dt):
    """KA's per-row form against the JAX package's per-row ingest: each row
    as pcm16_ingest alone, and the batch CLIs' multiply by the float32
    reciprocal (gomel_tpu/parallel/batch.py:299), bit for bit."""
    _, t_dt, j_dt = DTYPES[dt]
    pcm = np.random.default_rng(22).integers(-32768, 32768, size=(4, 999),
                                             dtype=np.int16)
    scales = np.array([32768.0, 65536.0, 65536.0, 32768.0], np.float32)
    out = tq.pcm16_ingest_batch(torch.from_numpy(pcm), t_dt, scales,
                                1280).numpy()
    for r in range(4):
        ref = np.asarray(jq.pcm16_ingest(jnp.asarray(pcm[r]), j_dt,
                                         float(scales[r]), 1280))
        np.testing.assert_array_equal(out[r], ref)
    recip = (1.0 / scales.astype(np.float64)).astype(np.float32)
    ref = np.asarray(jnp.asarray(pcm).astype(j_dt) * jnp.asarray(recip)[:, None])
    np.testing.assert_array_equal(out[:, :999], ref)
    with pytest.raises(ValueError):
        tq.pcm16_ingest_batch(torch.from_numpy(pcm), t_dt, scales[:3])
    with pytest.raises(ValueError):
        tq.pcm16_ingest(torch.from_numpy(pcm[0]), t_dt, scales)


# -- KA's zero-stuff at ragged lengths; the fused launch's int16 mode --------
def _ragged_lengths(zp: int) -> list[int]:
    """Input lengths that leave a partial last group: 1, zp - 1, zp + 1 and
    an odd count (for zp = 1 every length is whole groups)."""
    return sorted({n for n in (1, zp - 1, zp + 1, 2 * zp + 1, 1001) if n > 0})


ZERO_STUFF_CASES = [(zp, zs, n)
                    for zp, zs in sorted({p for p in PAD_SHIFT_TABLE.values()
                                          if p[0] > 0})
                    for n in _ragged_lengths(zp)]


@pytest.mark.parametrize("zp,zs,n", ZERO_STUFF_CASES)
def test_pcm16_ingest_zero_stuff_ragged_lengths_vs_jax(zp, zs, n):
    """KA's plain version with the zero-stuff upsample at every pad-shift
    pair of the table and lengths whose last group is partial, mono, stereo
    and a batch of mono rows, with and without padding past the upsampled
    length, against the JAX package bit for bit."""
    rng = np.random.default_rng(100 * zp + 10 * zs + n)
    up = n + -(-n // zp) * zs
    for shape, pad_to in (((n,), 0), ((n, 2), 0), ((n,), up + 7),
                          ((n, 2), up + 3)):
        pcm = rng.integers(-32768, 32768, size=shape, dtype=np.int16)
        ref = np.asarray(jq.pcm16_ingest(jnp.asarray(pcm), jnp.float32,
                                         32768.0, pad_to, zp, zs))
        out = tq.pcm16_ingest(torch.from_numpy(pcm), torch.float32, 32768.0,
                              pad_to, zp, zs).numpy()
        assert out.shape == ref.shape == (max(up, pad_to),)
        np.testing.assert_array_equal(out, ref)   # bit-exact
    rows = rng.integers(-32768, 32768, size=(3, n), dtype=np.int16)
    out = tq.pcm16_ingest_batch(torch.from_numpy(rows), torch.float32,
                                np.array([32768.0, 65536.0, 32768.0]), 0,
                                zp, zs).numpy()
    for r, scale in enumerate((32768.0, 65536.0, 32768.0)):
        np.testing.assert_array_equal(out[r], np.asarray(jq.pcm16_ingest(
            jnp.asarray(rows[r]), jnp.float32, scale, 0, zp, zs)))


def test_pcm16_ingest_cuda_pairs_are_the_table():
    """KA's kernel is built for the table's (zp, zs) pairs and (0, 0)."""
    assert tq.ZERO_STUFF_PAIRS == frozenset(PAD_SHIFT_TABLE.values())
    assert (0, 0) in tq.ZERO_STUFF_PAIRS


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("layout", ["row", "row short", "batch"])
def test_stft_mel_log_pcm16_plain_vs_jax(n, layout):
    """The fused launch's int16 mode (its plain version, on the CPU) against
    the JAX package's pcm16_ingest followed by its mel encode, row by row:
    a single row whose length is not a multiple of the hop, padded; a row
    shorter than one frame, padded to one; a batch with per-row scales
    mixing 32768 and 65536 and an empty (all-zero) row. KC's tolerance: 1e-5
    in the log domain, over every value (the empty row's clamp too)."""
    hop, mels = n // 4, 16
    rng = np.random.default_rng(n + len(layout))
    w = mel_weights(n // 2, mels, 0.0, 8000.0).astype(np.float32)
    win = tstft.hann_window(n).astype(np.float32)
    if layout == "batch":
        pcm = rng.integers(-32768, 32768, size=(3, 23 * hop), dtype=np.int16)
        pcm[1] = 0
        scales = np.array([32768.0, 65536.0, 32768.0], np.float32)
        pad_to = 0
    else:
        length = 23 * hop + 5 if layout == "row" else n // 2 + 3
        pcm = rng.integers(-32768, 32768, size=(length,), dtype=np.int16)
        scales = 65536.0
        pad_to = (length // hop + 2) * hop if layout == "row" else n
    got = tmel.stft_mel_log_pcm16(torch.from_numpy(pcm),
                                  torch.from_numpy(scales)
                                  if np.ndim(scales) else scales, pad_to,
                                  torch.from_numpy(win), n, hop,
                                  torch.from_numpy(w)).numpy()
    rows = pcm if pcm.ndim == 2 else pcm[None]
    for r in range(rows.shape[0]):
        scale = float(scales[r]) if np.ndim(scales) else scales
        x = jq.pcm16_ingest(jnp.asarray(rows[r]), jnp.float32, scale, pad_to)
        ref = np.asarray(jmel.mel_encode(x, mels, n, hop, jnp.asarray(w),
                                         jnp.asarray(win)))
        out = got[r] if pcm.ndim == 2 else got
        assert out.shape == ref.shape and out.dtype == np.float32
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_stft_mel_log_pcm16_checks_its_inputs():
    """int16 [L] or [B, L] only; per-row scales need a batch of as many
    rows; on the CPU the wrapper is its plain version."""
    n, hop = 64, 16
    w = torch.from_numpy(mel_weights(n // 2, 8, 0.0, 8000.0).astype(np.float32))
    win = torch.from_numpy(tstft.hann_window(n).astype(np.float32))
    pcm = torch.from_numpy(np.random.default_rng(5).integers(
        -32768, 32768, size=(2, 300), dtype=np.int16))
    got = tmel.stft_mel_log_pcm16(pcm, [32768.0, 65536.0], 0, win, n, hop, w)
    assert torch.equal(got, tmel.stft_mel_log_pcm16_plain(
        pcm, torch.tensor([32768.0, 65536.0]), 0, win, n, hop, w))
    with pytest.raises(ValueError):
        tmel.stft_mel_log_pcm16(pcm.float(), 32768.0, 0, win, n, hop, w)
    with pytest.raises(ValueError):
        tmel.stft_mel_log_pcm16(pcm[0], [32768.0], 0, win, n, hop, w)
    with pytest.raises(ValueError):
        tmel.stft_mel_log_pcm16(pcm, [32768.0] * 3, 0, win, n, hop, w)
