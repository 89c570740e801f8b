"""The FFT backend names (K19) and the matmul DFT (K14) of the port against
the JAX package, on the CPU.

The same seeded numpy inputs go through ``gomel_tpu`` and through
``gomel_tpu_torch``, whose kernels run their plain PyTorch versions on CPU
tensors (the matmul DFT: ``torch.matmul`` against the float64 master, as
XLA's CPU backend runs the JAX module at every precision). Float64 unless a
test says otherwise; each tolerance is stated where it is checked. The
kernels KN and KO themselves are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gomel_tpu.core.config import MelConfig as JMelConfig
from gomel_tpu.core.config import PhaseConfig as JPhaseConfig
from gomel_tpu.ops import dft_mm as jdft
from gomel_tpu.ops import fftbackend as jfb
from gomel_tpu.ops import griffinlim as jgl
from gomel_tpu.ops import istft as jistft
from gomel_tpu.ops import mel_ops as jmel
from gomel_tpu.ops import phase_ops as jphase
from gomel_tpu.ops.stft import hann_window as jhann
from gomel_tpu.pipelines.mel import Mel as JMel
from gomel_tpu.pipelines.phase import Phase as JPhase
from gomel_tpu_torch.core.config import MelConfig, PhaseConfig
from gomel_tpu_torch.ops import dft_mm, fftbackend, griffinlim, istft
from gomel_tpu_torch.ops import mel_ops, phase_ops, rfft_mag
from gomel_tpu_torch.ops.stft import hann_window
from gomel_tpu_torch.pipelines.mel import Mel
from gomel_tpu_torch.pipelines.phase import Phase

NAMES = ("auto", "auto_lowp", "xla", "mxu", "mm")


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- K14: the matmul DFT -------------------------------------------------------

@pytest.mark.parametrize("n", [2, 64, 256, 3000, 4096])
def test_dft_mm_vs_jax(n):
    """rfft, rfft_windowed (Hann and another window), rfft_mag, irfft and
    irfft_windowed within 1e-9 * n of the JAX module (the bound of
    tests/test_dft_mm.py), with non-zero imag(DC) and imag(Nyquist) fed to
    the inverses."""
    rng = np.random.default_rng(n)
    half = n // 2 + 1
    x = rng.standard_normal((2, 3, n))
    re = rng.standard_normal((3, half))
    im = rng.standard_normal((3, half))
    other = rng.random(n)
    tol = dict(rtol=0, atol=1e-9 * n)
    for got, want in zip(dft_mm.rfft(_t(x), n), jdft.rfft(jnp.asarray(x), n)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(dft_mm.rfft_mag(_t(x), n).numpy(),
                               np.asarray(jdft.rfft_mag(jnp.asarray(x), n)),
                               **tol)
    np.testing.assert_allclose(
        dft_mm.irfft(_t(re), _t(im), n).numpy(),
        np.asarray(jdft.irfft(jnp.asarray(re), jnp.asarray(im), n)), **tol)
    for tw, jw in ((hann_window(n), jhann(n)), (other, other)):
        for got, want in zip(dft_mm.rfft_windowed(_t(x), n, tw),
                             jdft.rfft_windowed(jnp.asarray(x), n, jw)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
        np.testing.assert_allclose(
            dft_mm.irfft_windowed(_t(re), _t(im), n, tw).numpy(),
            np.asarray(jdft.irfft_windowed(jnp.asarray(re), jnp.asarray(im),
                                           n, jw)), **tol)


def test_dft_mm_f32_vs_jax():
    """float32 at n = 4096, every precision name (all exact on the CPU):
    within 1e-5 of each frame's peak of the JAX module in float32, and the
    inverse within 1e-5 of the frame peak."""
    n = 4096
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, n)).astype(np.float32)
    re = rng.standard_normal((4, n // 2 + 1)).astype(np.float32)
    im = rng.standard_normal((4, n // 2 + 1)).astype(np.float32)
    want = np.asarray(jdft.rfft_mag(jnp.asarray(x), n), np.float64)
    want_i = np.asarray(jdft.irfft(jnp.asarray(re), jnp.asarray(im), n),
                        np.float64)
    for precision in dft_mm.PRECISIONS:
        got = dft_mm.rfft_mag(_t(x), n, precision).numpy()
        assert got.dtype == np.float32
        peak = want.max(axis=-1, keepdims=True)
        assert np.all(np.abs(got - want) <= 1e-5 * peak)
        got_i = dft_mm.irfft(_t(re), _t(im), n, precision).numpy()
        peak_i = np.abs(want_i).max(axis=-1, keepdims=True)
        assert np.all(np.abs(got_i - want_i) <= 1e-5 * peak_i)
    with pytest.raises(ValueError, match="precision"):
        dft_mm.rfft(_t(x), n, "fast")


def _bf16_np(a: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 -> float32, round to nearest even, by bits."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("n,hop", [(512, 128), (3000, 750)])
def test_bf16_operand_plain_versions_vs_numpy(n, hop):
    """The bf16-operand plain versions equal an independent numpy reference
    (the frames and the float32 weights rounded to bf16 by bits, products
    summed in float64) within 1e-5 of each frame's peak: float32
    accumulation only. The rounding itself moves the result by more than
    1e-4 of the peak, so the flag did round."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n + 6 * hop).astype(np.float32)
    w = hann_window(n)
    frames = np.lib.stride_tricks.sliding_window_view(x, n)[::hop]
    wf = (jdft._fwd_np(n) * w[:, None]).astype(np.float32)
    want = _bf16_np(frames).astype(np.float64) @ _bf16_np(wf).astype(
        np.float64)
    re, im = dft_mm.dft_fwd_plain(_t(x), n, hop, w, bf16_operands=True)
    got = torch.cat([re, im], -1).double().numpy()
    peak = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * peak)
    exact = torch.cat(dft_mm.dft_fwd_plain(_t(x), n, hop, w), -1).numpy()
    assert np.abs(exact - want).max() > 1e-4 * peak.min()
    half = n // 2 + 1
    zr = rng.standard_normal((5, half)).astype(np.float32)
    zi = rng.standard_normal((5, half)).astype(np.float32)
    wi = (jdft._inv_np(n) * w[None, :]).astype(np.float32)
    want = _bf16_np(np.concatenate([zr, zi], -1)).astype(np.float64) \
        @ _bf16_np(wi).astype(np.float64)
    got = dft_mm.dft_inv_plain(_t(zr), _t(zi), n, w,
                               bf16_operands=True).double().numpy()
    peak = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * peak)


def test_weights_cached_by_host_window_values():
    """The folded weights are cached by the host window's values, as the
    JAX module tells host windows apart: a copy of a window, or a tensor of
    the same float64 values, finds the same entry; other values do not; a
    Griffin-Lim decode with a numpy window adds no entry when run again."""
    n, cpu, f64 = 64, torch.device("cpu"), torch.float64
    dft_mm._WEIGHTS.clear()
    w = np.random.default_rng(0).random(n)
    a = dft_mm._weights("fwd", n, w, f64, cpu)
    assert dft_mm._weights("fwd", n, w.copy(), f64, cpu) is a
    assert dft_mm._weights("fwd", n, _t(w.copy()), f64, cpu) is a
    other = w.copy()
    other[3] += 1.0
    assert dft_mm._weights("fwd", n, other, f64, cpu) is not a
    h = dft_mm._weights("inv", n, None, f64, cpu)
    assert dft_mm._weights("inv", n, None, f64, cpu) is h
    np.testing.assert_array_equal(
        dft_mm._weights("inv", n, hann_window(n), f64, cpu).numpy(),
        jdft._fold_inv(n, jhann(n)))
    mag, init, hop = _gl_inputs(2, n=n, hop=16)
    dft_mm._WEIGHTS.clear()
    for _ in range(2):
        griffinlim.griffin_lim(_t(mag), hop, 2, window=np.hanning(n),
                               init=_t(init),
                               fft_backend="mm")
        assert len(dft_mm._WEIGHTS) == 2


def test_dft_mm_rejects_sizes_as_jax_resolve_does():
    for n in (3, 8194, 0):
        with pytest.raises(ValueError, match="does not support") as e:
            dft_mm.rfft(torch.zeros(4, 8194), n)
        with pytest.raises(ValueError) as j:
            jfb.resolve("mm", n)
        assert str(e.value) == str(j.value)


# -- K19: the backend names ----------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 64, 514, 3000, 4096, 8192, 8194, 16384,
                               16386])
@pytest.mark.parametrize("name", NAMES + ("fft", "MM"))
def test_resolve_vs_jax_on_cpu(name, n):
    """On the CPU the port resolves every (name, n) as the JAX package does
    off a TPU: the same result, or ValueError with the same text."""
    try:
        want = jfb.resolve(name, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fftbackend.resolve(name, n, "cpu")
        assert str(got.value) == str(e)
        return
    assert fftbackend.resolve(name, n, "cpu") == want
    assert fftbackend.resolve(name, n) == want


def test_resolve_on_cuda_is_a_pure_function():
    """The card's routes, decided from (name, n) alone: the hand FFT
    kernels ("mxu") for every even n the JAX package's TPU gives its
    matrix-unit FFT (n = n1 * n2, both factors <= 128), the xla route for
    the sizes the TPU gives its library FFT, and auto_lowp exact (never
    "mm")."""
    r = fftbackend.resolve
    assert r("auto", 4096, "cuda") == "mxu"
    assert r("auto", 3000, "cuda") == "mxu"     # 24 x 125: mixed radix
    assert r("auto", 514, "cuda") == "xla"      # 2 x 257: no split
    assert r("auto_lowp", 4096, "cuda") == "mxu"
    assert r("auto_lowp", 3000, "cuda") == "mxu"
    assert r("auto_lowp", 514, "cuda") == "xla"
    assert r("auto_lowp", 8192, "cuda") != "mm"
    assert r("mxu", 4096, "cuda") == "mxu"
    assert r("mxu", 3000, "cuda") == "mxu"
    assert r("mxu", 15, "cuda") == "xla"        # odd: no real split
    assert r("xla", 4096, "cuda") == "xla"
    assert r("mm", 3000, "cuda") == "mm"
    assert r("auto", 32768, "cuda") == "xla"    # above 128 x 128
    with pytest.raises(ValueError, match="'mxu' does not support n=514"):
        r("mxu", 514, "cuda")
    with pytest.raises(ValueError, match="unknown fft backend"):
        r("cufft", 4096, "cuda")


@pytest.mark.parametrize("n", [4096, 3000])
@pytest.mark.parametrize("name", NAMES)
def test_transforms_vs_jax(name, n):
    """fftbackend.rfft_planes, rfft_mag and irfft_planes for each name
    against the JAX dispatch within 1e-9 * n; irfft_planes(..., "mxu") is
    the JAX package's K16 (mxu_fft.irfft)."""
    rng = np.random.default_rng(n + len(name))
    half = n // 2 + 1
    x = rng.standard_normal((2, 3, n))
    re = rng.standard_normal((3, half))
    im = rng.standard_normal((3, half))
    tol = dict(rtol=0, atol=1e-9 * n)
    for got, want in zip(fftbackend.rfft_planes(_t(x), n, name),
                         jfb.rfft_planes(jnp.asarray(x), n, name)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(
        fftbackend.rfft_mag(_t(x), n, name).numpy(),
        np.asarray(jfb.rfft_mag(jnp.asarray(x), n, name)), **tol)
    np.testing.assert_allclose(
        fftbackend.irfft_planes(_t(re), _t(im), n, name).numpy(),
        np.asarray(jfb.irfft_planes(jnp.asarray(re), jnp.asarray(im), n,
                                    name)), **tol)


# -- Griffin-Lim and the decodes with every name -------------------------------

def _gl_inputs(seed, frames=9, n=256, hop=96):
    rng = np.random.default_rng(seed)
    mag = np.abs(rng.standard_normal((frames, n // 2 + 1)))
    init = rng.random(n + (frames - 1) * hop)
    return mag, init, hop


@pytest.mark.parametrize("n_iter,momentum", [(0, 0.0), (1, 0.0), (3, 0.0),
                                             (3, 0.9)])
@pytest.mark.parametrize("name", NAMES)
def test_griffin_lim_vs_jax(name, n_iter, momentum):
    """griffin_lim with each backend name from one start, within 1e-8 of the
    JAX program (the bound of tests/test_dft_mm.py): with ``mm`` every
    forward transform and the interior inverses are the matmul DFT, the
    final inverse exact, on both sides."""
    mag, init, hop = _gl_inputs(3)
    want = np.asarray(jgl.griffin_lim(
        jnp.asarray(mag), hop, n_iter, jax.random.PRNGKey(0),
        init=jnp.asarray(init), fft_backend=name, momentum=momentum))
    got = griffinlim.griffin_lim(_t(mag), hop, n_iter, init=_t(init),
                                 fft_backend=name, momentum=momentum)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-8)


def test_griffin_lim_rejects_names_as_jax():
    mag, init, hop = _gl_inputs(4)
    for name, mag_n in (("fast", mag), ("mm", np.zeros((2, 4098)))):
        with pytest.raises(ValueError) as j:
            jgl.griffin_lim(jnp.asarray(mag_n), hop, 1, jax.random.PRNGKey(0),
                            fft_backend=name)
        with pytest.raises(ValueError) as t:
            griffinlim.griffin_lim(_t(mag_n), hop, 1, fft_backend=name)
        assert str(t.value) == str(j.value)


def test_griffin_lim_bf16_interior_cost():
    """What the card's bf16 interior costs Griffin-Lim, on the CPU: the mm
    route with the bf16-operand plain versions (forward and interior
    inverses bf16, final inverse exact) reaches a spectral convergence
    within 1.05 x the exact route's + 1e-3 (chip_smoke.py's bound) after 8
    iterations from one start, in float32 at n = 1024."""
    n, hop, frames = 1024, 256, 48
    rng = np.random.default_rng(5)
    t = np.arange(n + (frames - 1) * hop) / 16000.0
    x = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1700 * t)
         + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
    win = torch.from_numpy(hann_window(n).astype(np.float32))
    target = rfft_mag.stft_mag_plain(_t(x), win, n, hop)
    init = _t(rng.random(t.shape).astype(np.float32))

    def sc(sig):
        a = rfft_mag.stft_mag_plain(sig.double(), win.double(), n, hop)
        c = float((a * target).sum() / (target * target).sum())
        return float((a - c * target).norm() / (abs(c) * target.norm()))

    sig = init
    for it in range(8):
        yr, yi = dft_mm.dft_fwd_plain(sig, n, hop, win, kind="project",
                                      mag=target, bf16_operands=True)
        if it < 7:
            fw = dft_mm.dft_inv_plain(yr, yi, n, win, bf16_operands=True)
        else:
            fw = istft.irfft_window_plain(yr, yi, n, win)
        sig = istft.overlap_add_plain(fw, hop)
    exact = griffinlim.griffin_lim(target, hop, 8, window=win, init=init)
    assert sc(sig) <= 1.05 * sc(exact) + 1e-3, (sc(sig), sc(exact))


MCFG = dict(num_mels=24, window=64, resolut=256)


@pytest.mark.parametrize("name", NAMES)
def test_mel_decode_vs_jax(name):
    """mel_decode with each name, 2 iterations with momentum 0.99, from one
    start: within 1e-8 of the JAX program (its mel_decode draws its own
    start, so the JAX side is the body of jmel.mel_decode with ``init=``)."""
    rng = np.random.default_rng(6)
    logmel = rng.standard_normal((7, 24, 2)) - 3.0
    inv = Mel(MelConfig(**MCFG), dtype=torch.float64,
              device="cpu").inv_weights.numpy()
    init = rng.random(256 + 6 * 64)
    mag = jmel.griffin_lim_magnitudes(jmel.mel_to_linear(
        jnp.asarray(logmel), jnp.asarray(inv)))
    want = np.asarray(jgl.griffin_lim(mag, 64, 2, jax.random.PRNGKey(0),
                                      init=jnp.asarray(init),
                                      fft_backend=name, momentum=0.99))
    got = mel_ops.mel_decode(_t(logmel), 256, 64, _t(inv), 2,
                             fft_backend=name, momentum=0.99, init=_t(init))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-8)


@pytest.mark.parametrize("name", ["mm", "mxu"])
def test_codec_ops_vs_jax(name):
    """phase_encode, phase_decode, istft_direct_planes and mel_encode with
    ``mm`` and ``mxu`` within 1e-9 of the JAX ops (float64)."""
    n, hop, nf = 256, 64, 96
    rng = np.random.default_rng(7)
    x = rng.standard_normal(n + 20 * hop)
    tol = dict(rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        phase_ops.phase_encode(_t(x), nf, n, hop, fft_backend=name).numpy(),
        np.asarray(jphase.phase_encode(jnp.asarray(x), nf, n, hop,
                                       fft_backend=name)), **tol)
    xb = np.stack([x, x[::-1].copy()])
    np.testing.assert_allclose(
        phase_ops.phase_encode_batch(_t(xb), nf, n, hop,
                                     fft_backend=name).numpy(),
        np.asarray(jphase.phase_encode_batch(jnp.asarray(xb), nf, n, hop,
                                             fft_backend=name)), **tol)
    spec = rng.standard_normal((21, nf, 2))
    np.testing.assert_allclose(
        phase_ops.phase_decode(_t(spec), n, hop, 1.5,
                               fft_backend=name).numpy(),
        np.asarray(jphase.phase_decode(jnp.asarray(spec), n, hop, 1.5,
                                       fft_backend=name)), **tol)
    re = rng.standard_normal((21, n // 2 + 1))
    im = rng.standard_normal((21, n // 2 + 1))
    w = jhann(n)
    np.testing.assert_allclose(
        istft.istft_direct_planes(_t(re), _t(im), hop, w, name).numpy(),
        np.asarray(jistft.istft_direct_planes(jnp.asarray(re), jnp.asarray(im),
                                              hop, w, name)), **tol)
    fwd = Mel(MelConfig(**MCFG), dtype=torch.float64,
              device="cpu").fwd_weights
    np.testing.assert_allclose(
        mel_ops.mel_encode(_t(x), 24, n, hop, fwd, fft_backend=name).numpy(),
        np.asarray(jmel.mel_encode(jnp.asarray(x), 24, n, hop, fwd.numpy(),
                                   fft_backend=name)), **tol)


def test_chunked_irfft_overlap_add_backends_vs_jax():
    """chunked_irfft_overlap_add with its JAX default (xla) and with mm, a
    frame mask as a real-frame count: within 1e-9 of the JAX scan."""
    n, hop, f = 256, 64, 13
    rng = np.random.default_rng(8)
    re = rng.standard_normal((f, n // 2 + 1))
    im = rng.standard_normal((f, n // 2 + 1))
    w = jhann(n)
    for name in ("xla", "mm"):
        want = np.asarray(jistft.chunked_irfft_overlap_add(
            jnp.asarray(re), jnp.asarray(im), hop, jnp.asarray(w), 4, name,
            frame_mask=jnp.arange(f) < 9))
        got = istft.chunked_irfft_overlap_add(_t(re), _t(im), hop, _t(w), 4,
                                              name, real_frames=9)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


# -- every size on every device: Mel and Phase at resolut = 3000 --------------

def _audio(secs, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * 48000)) / 48000
    return (0.3 * np.sin(2 * np.pi * 440.0 * t)
            + 0.02 * rng.standard_normal(t.shape))


def test_mel_and_phase_resolut_3000_vs_jax():
    """A size whose half is not a power of two: Mel's encode and Phase's
    encode and decode at resolut = 3000 within 1e-9 of the JAX package
    (float64; the card runs this size on the FFT kernels' mixed radix)."""
    x = _audio(1.0, 9)
    mcfg = dict(num_mels=64, window=750, resolut=3000)
    want = np.asarray(JMel(JMelConfig(**mcfg), dtype=jnp.float64).encode(x))
    got = Mel(MelConfig(**mcfg), dtype=torch.float64, device="cpu").encode(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    pcfg = dict(num_freqs=1000, window=750, resolut=3000)
    jp = JPhase(JPhaseConfig(**pcfg), dtype=jnp.float64)
    tp = Phase(PhaseConfig(**pcfg), dtype=torch.float64, device="cpu")
    spec_j = np.asarray(jp.encode(x))
    spec_t = tp.encode(x)
    np.testing.assert_allclose(spec_t.numpy(), spec_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tp.decode(spec_j).numpy(),
                               np.asarray(jp.decode(spec_j)), rtol=0,
                               atol=1e-9)
