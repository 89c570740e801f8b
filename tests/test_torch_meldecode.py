"""The port's mel decode slice (dequantize -> mel_to_linear -> Griffin-Lim ->
PCM-16, ``towav``) against the JAX package, on the CPU.

Seeded numpy inputs go through gomel_tpu's ops, Mel and towav and through
gomel_tpu_torch's (which runs the kernels' plain versions on CPU tensors).
Griffin-Lim starts from a given ``init``, or from a seed: the port draws the
JAX package's ``jax.random.uniform(PRNGKey(seed), ...)`` samples itself
(ops/prng.py), so the seeded decodes are held against each other directly.
Tolerances are stated at each comparison.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gomel_tpu.cli import tools as jtools
from gomel_tpu.core.config import MelConfig as JMelConfig
from gomel_tpu.io.audio import save_wav
from gomel_tpu.io.wavcodec import read_wav
from gomel_tpu.ops import griffinlim as jgl
from gomel_tpu.ops import mel_ops as jmel
from gomel_tpu.ops import quantize as jq
from gomel_tpu.pipelines.mel import Mel as JMel
from gomel_tpu_torch import ConfigError, Mel, MelConfig
from gomel_tpu_torch.cli import tools as ttools
from gomel_tpu_torch.core.filterbank import inverse_mel_weights
from gomel_tpu_torch.ops import griffinlim as tgl
from gomel_tpu_torch.ops import mel_ops as tmel
from gomel_tpu_torch.ops import prng
from gomel_tpu_torch.ops import quantize as tq

from test_mel import oracle_griffin_lim

SR = 48000
CFG = MelConfig.cli_default()


def _audio(secs=1.0, seed=0):
    """Tones plus noise, with a near-silent stretch."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.1 * np.sin(2 * np.pi * 2900.0 * t)
         + 0.02 * rng.standard_normal(t.shape))
    x[len(x) // 3: len(x) // 3 + SR // 8] *= 1e-3
    return x


def _inv(cfg=CFG):
    return inverse_mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin,
                               cfg.mel_fmax)


def _logmel(frames, seed, cfg=CFG):
    """Log-mel values over the range a real file spans (about -11.5 to 3)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-11.5, 3.0, size=(frames, cfg.num_mels, 2))


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """A 1 s 48 kHz WAV through the JAX tomel, device- and host-quantized."""
    d = tmp_path_factory.mktemp("mel")
    wav = str(d / "in.wav")
    save_wav(wav, _audio(), SR)
    out = {}
    for mode in ("--device-quantize", "--host-quantize"):
        out[mode] = str(d / f"{mode[2:]}.png")
        assert jtools.tomel([wav, "-o", out[mode], mode]) == 0
    out["wav"] = wav
    return out


def _lsb(a_path, b_path):
    wa, sa = read_wav(a_path)
    wb, sb = read_wav(b_path)
    assert sa == sb and wa.shape == wb.shape
    return np.abs(wa.astype(np.int64) - wb.astype(np.int64)), sb


# -- the ops -------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
def test_dequantize_mel_plane_bit_exact(batched):
    rng = np.random.default_rng(1)
    lead = (3,) if batched else ()
    img = rng.integers(0, 256, size=lead + (192, 37, 2), dtype=np.uint8)
    mx = rng.uniform(0.0, 4.0, size=lead).astype(np.float32)
    mn = rng.uniform(-11.5, -5.0, size=lead).astype(np.float32)
    if batched:
        ref = jq.dequantize_mel_plane_batch(jnp.asarray(img), jnp.asarray(mx),
                                            jnp.asarray(mn))
        out = tq.dequantize_mel_plane_batch(torch.from_numpy(img),
                                            torch.from_numpy(mx),
                                            torch.from_numpy(mn))
    else:
        ref = jq.dequantize_mel_plane(jnp.asarray(img), jnp.asarray(mx),
                                      jnp.asarray(mn))
        out = tq.dequantize_mel_plane(torch.from_numpy(img), float(mx),
                                      float(mn))
    assert out.dtype == torch.float32
    # float32 on both sides, the same order of operations: bit for bit
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("tune", [(1.0, 0.0), (1.5, 0.25)])
def test_mel_to_linear_f64_matches_jax(tune):
    logmel = _logmel(6, 2)
    ref = np.asarray(jmel.mel_to_linear(jnp.asarray(logmel), jnp.asarray(_inv()),
                                        *tune))
    out = tmel.mel_to_linear(torch.from_numpy(logmel), torch.from_numpy(_inv()),
                             *tune)
    assert out.shape == ref.shape == (6, CFG.n_bins, 2)
    # float64 products over 192 mels summed in another order (test_mel.py:123)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10, atol=1e-12)


def test_griffin_lim_magnitudes_matches_jax():
    rng = np.random.default_rng(3)
    lin2 = rng.standard_normal((2, 5, CFG.n_bins, 2))
    ref = np.stack([np.asarray(jgl.griffin_lim_magnitudes(jnp.asarray(r)))
                    for r in lin2])
    out = tgl.griffin_lim_magnitudes(torch.from_numpy(lin2)).numpy()
    np.testing.assert_array_equal(out, ref)
    # the Nyquist magnitude is channel 1's last bin, not channel 0's
    np.testing.assert_array_equal(out[..., -1], np.abs(lin2[..., -1, 1]))
    assert not np.array_equal(out[..., -1], np.abs(lin2[..., -1, 0]))


@pytest.mark.parametrize("quantized", [False, True])
def test_mel_to_magnitudes_matches_jax(quantized):
    """KI's plain version against the JAX program's dequantize + boost +
    mel_to_linear + magnitudes in float32 (gomel_tpu/pipelines/mel.py:151-
    158): the products are summed in another order, so within 1e-6 of each
    frame's peak."""
    rng = np.random.default_rng(4)
    inv32 = _inv().astype(np.float32)
    boost = 1.5 if quantized else 0.0
    if quantized:
        img = rng.integers(0, 256, size=(CFG.num_mels, 9, 2), dtype=np.uint8)
        mx, mn = np.float32(2.5), np.float32(-11.0)
        lm = jq.dequantize_mel_plane(jnp.asarray(img), jnp.asarray(mx),
                                     jnp.asarray(mn))
        lm = lm + jnp.asarray(boost, lm.dtype)
        out = tmel.mel_to_magnitudes(torch.from_numpy(img),
                                     torch.from_numpy(inv32), boost=boost,
                                     mgc_max=float(mx), mgc_min=float(mn))
    else:
        lm = jnp.asarray(_logmel(9, 5).astype(np.float32))
        out = tmel.mel_to_magnitudes(torch.from_numpy(np.array(lm)),
                                     torch.from_numpy(inv32))
    ref = np.asarray(jgl.griffin_lim_magnitudes(
        jmel.mel_to_linear(lm, jnp.asarray(inv32))))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    peak = ref.max(axis=-1, keepdims=True)
    assert np.all(np.abs(out.numpy() - ref) <= 1e-6 * peak)


def _gl_inputs(seed, F=5, N=512, hop=160):
    rng = np.random.default_rng(seed)
    lin2 = rng.standard_normal((F, N // 2, 2))
    init = rng.random(N + (F - 1) * hop)
    return lin2, init, np.hanning(N), hop


@pytest.mark.parametrize("n_iter", [0, 1, 2, 3])
def test_griffin_lim_f64_matches_jax_and_oracle(n_iter):
    lin2, init, w, hop = _gl_inputs(6)
    mag_j = jgl.griffin_lim_magnitudes(jnp.asarray(lin2))
    ref = np.asarray(jgl.griffin_lim(mag_j, hop, n_iter, jax.random.PRNGKey(0),
                                     jnp.asarray(w), init=jnp.asarray(init)))
    out = tgl.griffin_lim(tgl.griffin_lim_magnitudes(torch.from_numpy(lin2)),
                          hop, n_iter, window=torch.from_numpy(w),
                          init=torch.from_numpy(init))
    assert out.dtype == torch.float64 and out.shape == ref.shape
    # float64 FFTs on both sides, and the reference's full-FFT loop
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-9)
    full = np.zeros((lin2.shape[0], len(w)), dtype=np.complex128)
    full[:, :len(w) // 2] = lin2[..., 0]
    full[:, len(w) // 2:] = lin2[:, ::-1, 1]
    expect = oracle_griffin_lim(full, w, hop, n_iter, init)
    np.testing.assert_allclose(out.numpy(), expect, rtol=0, atol=1e-9)


def test_griffin_lim_momentum_f64_matches_jax():
    """Momentum 0.99 at 6 iterations: 5 accelerated, then one plain."""
    lin2, init, w, hop = _gl_inputs(7)
    mag_j = jgl.griffin_lim_magnitudes(jnp.asarray(lin2))
    ref = np.asarray(jgl.griffin_lim(mag_j, hop, 6, jax.random.PRNGKey(0),
                                     jnp.asarray(w), init=jnp.asarray(init),
                                     momentum=0.99))
    out = tgl.griffin_lim(tgl.griffin_lim_magnitudes(torch.from_numpy(lin2)),
                          hop, 6, window=torch.from_numpy(w),
                          init=torch.from_numpy(init), momentum=0.99)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-9)
    plain = tgl.griffin_lim(tgl.griffin_lim_magnitudes(torch.from_numpy(lin2)),
                            hop, 6, window=torch.from_numpy(w),
                            init=torch.from_numpy(init))
    assert float((out - plain).abs().max()) > 1e-3   # momentum took effect


def test_griffin_lim_zero_frame_takes_unit_phase():
    """A frame of zeros has angle 0 everywhere, so its bins take the unit
    phase 1 (gomel_tpu/ops/griffinlim.py:177-181)."""
    lin2, init, w, hop = _gl_inputs(8)
    init[: len(w) + hop] = 0.0       # frames 0 and 1 are all zeros
    mag_j = jgl.griffin_lim_magnitudes(jnp.asarray(lin2))
    ref = np.asarray(jgl.griffin_lim(mag_j, hop, 1, jax.random.PRNGKey(0),
                                     jnp.asarray(w), init=jnp.asarray(init)))
    mag = tgl.griffin_lim_magnitudes(torch.from_numpy(lin2))
    out = tgl.griffin_lim(mag, hop, 1, window=torch.from_numpy(w),
                          init=torch.from_numpy(init))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)
    frames = tgl.gl_project(torch.from_numpy(init), mag, torch.from_numpy(w),
                            len(w), hop)
    expect = torch.fft.irfft(mag[0].to(torch.complex128), n=len(w)) \
        * torch.from_numpy(w)
    torch.testing.assert_close(frames[0], expect, rtol=0, atol=1e-15)


def test_gl_ops_check_shapes_and_devices():
    lin2, init, w, hop = _gl_inputs(9)
    mag = tgl.griffin_lim_magnitudes(torch.from_numpy(lin2))
    sig, win = torch.from_numpy(init), torch.from_numpy(w)
    # out_len = N + (F-1)*hop holds exactly F frames; one sample more does not
    assert tgl.gl_project(sig, mag, win, len(w), hop).shape == (5, len(w))
    with pytest.raises(ValueError, match="frames"):
        tgl.gl_project(torch.cat([sig, sig[:1]]), mag, win, len(w), hop)
    with pytest.raises(ValueError):
        tgl.griffin_lim(mag, hop, 2, window=win, init=sig[:-1])
    fw = tgl.gl_project(sig, mag, win, len(w), hop)
    with pytest.raises(ValueError):
        tgl.gl_overlap_add(fw, hop, t_prev=sig, momentum=0.5, pcm16=True)
    # a tensor on neither the CPU nor CUDA reaches the kernel's checks, not
    # a plain fallback
    with pytest.raises(ValueError, match="CUDA"):
        tgl.gl_project(sig.to("meta"), mag.to("meta"), win.to("meta"),
                       len(w), hop)
    with pytest.raises(ValueError, match="CUDA"):
        tgl.gl_overlap_add(fw.to("meta"), hop)
    with pytest.raises(ValueError, match="CUDA"):
        tmel.mel_to_magnitudes(torch.zeros((3, CFG.num_mels, 2), device="meta"),
                               torch.from_numpy(_inv()))


@pytest.mark.parametrize("cfg", [
    CFG, MelConfig(), MelConfig(num_mels=40, resolut=512, window=128),
    MelConfig(num_mels=80, resolut=128, window=32)])
def test_ki_band_table_holds_u(cfg):
    """KI's host-built table (first mel, tap count, taps per bin) holds every
    non-zero of U exactly, so the kernel's banded sum skips only zeros."""
    u = _inv(cfg).astype(np.float32)
    first, count, taps = (t.numpy() for t in tmel._band_table(
        torch.from_numpy(u)))
    dense = np.zeros_like(u)
    for k in range(u.shape[0]):
        dense[k, first[k]:first[k] + count[k]] = taps[k, :count[k]]
    np.testing.assert_array_equal(dense, u)
    assert np.all(taps[np.arange(taps.shape[1]) >= count[:, None]] == 0)


def test_griffin_lim_zero_iterations_pcm16():
    """n_iter = 0 returns the initial signal (mel/mel.go:85), converted by
    pcm16_encode when the file path asks for PCM-16."""
    lin2, init, w, hop = _gl_inputs(11)
    mag = tgl.griffin_lim_magnitudes(torch.from_numpy(lin2)).float()
    sig = torch.from_numpy(init).float()
    pcm, finite = tgl.griffin_lim(mag, hop, 0, window=torch.from_numpy(w), init=sig,
                                  pcm16=True)
    assert bool(finite)
    assert torch.equal(pcm, tq.pcm16_encode(sig)[0])


def test_gl_overlap_add_epilogues():
    """The momentum step t + m * (t - t_prev) and the PCM-16 conversion with
    a per-row finite flag, on the plain overlap-add."""
    rng = np.random.default_rng(10)
    fw = torch.from_numpy(rng.standard_normal((2, 6, 512)) * 0.4).float()
    t = tgl.gl_overlap_add(fw, 160)
    prev = torch.from_numpy(rng.standard_normal(t.shape)).float()
    c, t2 = tgl.gl_overlap_add(fw, 160, prev, 0.99)
    assert torch.equal(t2, t) and torch.equal(c, t + 0.99 * (t - prev))
    fw[1, 2, 9] = float("nan")
    pcm, finite = tgl.gl_overlap_add(fw, 160, pcm16=True)
    assert pcm.dtype == torch.int16 and finite.tolist() == [True, False]
    np.testing.assert_array_equal(pcm[0].numpy(), np.asarray(
        jq.pcm16_encode(jnp.asarray(t[0].numpy()))[0]))


def test_recommended_gl_matches_jax():
    assert tgl.GL_EQUAL_QUALITY_PAIRS == jgl.GL_EQUAL_QUALITY_PAIRS
    for n in (1, 2, 3, 8, 15, 16, 17, 32, 63, 64, 100, 128):
        assert tgl.recommended_gl(n) == jgl.recommended_gl(n)
    with pytest.raises(ValueError):
        tgl.recommended_gl(0)


def test_mel_decode_f32_matches_jax():
    """cli_default widths, 6 frames, float32 on both sides from one init."""
    logmel = _logmel(6, 11).astype(np.float32)
    inv = _inv().astype(np.float32)
    out_len = CFG.resolut + 5 * CFG.window
    init = np.random.default_rng(12).random(out_len).astype(np.float32)
    mag = jmel.griffin_lim_magnitudes(jmel.mel_to_linear(jnp.asarray(logmel),
                                                         jnp.asarray(inv)))
    ref = np.asarray(jgl.griffin_lim(mag, CFG.window, 2, jax.random.PRNGKey(0),
                                     init=jnp.asarray(init)), np.float64)
    out = tmel.mel_decode(torch.from_numpy(logmel), CFG.resolut, CFG.window,
                          torch.from_numpy(inv), 2, init=torch.from_numpy(init))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    rel = np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref)
    print(f"mel_decode f32 relative L2 vs JAX: {rel:.3e}")
    assert rel <= 1e-4


def test_mel_decode_takes_batch_dims():
    logmel = torch.from_numpy(np.stack([_logmel(4, 13), _logmel(4, 14)]))
    inv = torch.from_numpy(_inv())
    out_len = CFG.resolut + 3 * CFG.window
    init = torch.from_numpy(np.random.default_rng(15).random((2, out_len)))
    both = tmel.mel_decode(logmel, CFG.resolut, CFG.window, inv, 2, init=init,
                           momentum=0.99)
    for r in range(2):
        one = tmel.mel_decode(logmel[r], CFG.resolut, CFG.window, inv, 2,
                              init=init[r], momentum=0.99)
        torch.testing.assert_close(both[r], one, rtol=0, atol=1e-12)
    # one key draws over the whole [2, out_len]; a key per row draws each
    # row from its own
    a = tmel.mel_decode(logmel, CFG.resolut, CFG.window, inv, 1,
                        key=prng.key(5))
    b = tmel.mel_decode(logmel, CFG.resolut, CFG.window, inv, 1,
                        init=prng.uniform(prng.key(5), (2, out_len),
                                          torch.float64, "cpu"))
    assert a.shape == (2, out_len) and torch.equal(a, b)
    keys = prng.split_rows(prng.key(5), 2)
    rows = tmel.mel_decode(logmel, CFG.resolut, CFG.window, inv, 1, key=keys)
    for r in range(2):
        one = tmel.mel_decode(logmel[r], CFG.resolut, CFG.window, inv, 1,
                              key=keys[r])
        torch.testing.assert_close(rows[r], one, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="row keys"):
        tmel.mel_decode(logmel, CFG.resolut, CFG.window, inv, 1,
                        key=prng.split_rows(prng.key(5), 3))
    with pytest.raises(ValueError, match="key"):
        tmel.mel_decode(logmel, CFG.resolut, CFG.window, inv, 1)


# -- Mel and the CLI -------------------------------------------------------------

def test_decode_and_from_mel_f64_match_jax():
    x = _audio(0.5, seed=16)
    jm = JMel(JMelConfig.cli_default(), dtype=jnp.float64)
    tm = Mel(CFG, dtype=torch.float64, device="cpu")
    flat = jm.to_mel(x)
    ref = jm.from_mel(flat, seed=4)
    out = tm.from_mel(flat, seed=4)
    assert out.dtype == np.float64 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9)
    spec = flat.reshape(-1, CFG.num_mels, 2)
    ref_m = np.asarray(jm.decode(spec, seed=4, momentum=0.99))
    out_m = tm.decode(spec, seed=4, momentum=0.99)
    np.testing.assert_allclose(out_m.numpy(), ref_m, rtol=0, atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", [0, 7, -3, 2 ** 32 + 3])
def test_mel_zero_iterations_is_the_jax_start(dtype, seed):
    """With 0 iterations the decode returns the start (mel/mel.go:85): the
    port's equals the JAX package's for the same seed bit for bit, from
    ``decode`` and through the PCM-16 file path's conversion."""
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    spec = _logmel(3, 17)
    jm = JMel(JMelConfig.cli_default(griffin_lim_iterations=0), dtype=jd)
    tm = Mel(MelConfig.cli_default(griffin_lim_iterations=0), dtype=dtype,
             device="cpu")
    ref = np.asarray(jm.decode(spec, seed=seed))
    out = tm.decode(spec, seed=seed)
    assert out.dtype == dtype and ref.dtype == np.dtype(
        "float64" if dtype == torch.float64 else "float32")
    np.testing.assert_array_equal(out.numpy(), ref)
    planes = np.zeros((CFG.num_mels, 3, 2), np.uint8)
    pcm, finite = tm.decode_quantized_pcm16(planes, 1.0, -1.0, seed=seed)
    start = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                          ref.shape, jnp.float32))
    assert bool(finite)
    np.testing.assert_array_equal(
        pcm.numpy(), np.asarray(jq.pcm16_encode(jnp.asarray(start))[0]))


def test_from_numpy_carries_inverse_weights():
    jm = JMel(JMelConfig.cli_default())
    fwd, inv = jm._weights()
    port = Mel.from_numpy(CFG, np.asarray(fwd), np.asarray(jm._win()),
                          np.asarray(inv), device="cpu")
    own = Mel(CFG, device="cpu")
    assert torch.equal(port.inv_weights, own.inv_weights)
    assert port.inv_weights.dtype == torch.float32
    with pytest.raises(ValueError):
        Mel.from_numpy(CFG, np.asarray(fwd), np.asarray(jm._win()),
                       np.asarray(inv)[:10], device="cpu")


@pytest.mark.parametrize("device_quantize,momentum", [
    (True, 0.0), (False, 0.0), (True, 0.99)])
def test_to_wav_png_matches_jax(pngs, tmp_path, device_quantize, momentum):
    """The same PNG through both Mel.to_wav_png from the same seed, float32
    on both sides: at most 2 LSB at a differing-sample rate < 5e-2 (the
    bound of tests/test_device_quantize_mel.py:110-113)."""
    png = pngs["--device-quantize" if device_quantize else "--host-quantize"]
    cfg = dict(volume_boost=1.5)
    a, b = str(tmp_path / "jax.wav"), str(tmp_path / "port.wav")
    sr_a = JMel(JMelConfig.cli_default(**cfg), device_quantize=device_quantize
                ).to_wav_png(png, a, seed=7, momentum=momentum)
    sr_b = Mel(MelConfig.cli_default(**cfg), device_quantize=device_quantize,
               device="cpu").to_wav_png(png, b, seed=7, momentum=momentum)
    lsb, sr = _lsb(a, b)
    assert sr_a == sr_b == sr == SR
    assert lsb.max() <= 2 and (lsb > 0).mean() < 5e-2, (lsb.max(),
                                                        (lsb > 0).mean())


@pytest.mark.parametrize("mode", ["--device-quantize", "--host-quantize"])
def test_towav_cli_matches_jax(pngs, tmp_path, mode):
    a, b = str(tmp_path / "jax.wav"), str(tmp_path / "port.wav")
    assert jtools.towav([pngs[mode], "44100", "-o", a, "--seed", "3", mode]) == 0
    assert ttools.main(["towav", pngs[mode], "44100", "-o", b, "--seed", "3",
                        mode, "--device", "cpu"]) == 0
    lsb, sr = _lsb(a, b)
    assert sr == 44100
    assert lsb.max() <= 2 and (lsb > 0).mean() < 5e-2, (lsb.max(),
                                                        (lsb > 0).mean())


def test_towav_default_output_and_seed(pngs, tmp_path):
    """towav writes <png>.wav at the default 44100 Hz; another seed starts
    from another signal."""
    png = str(tmp_path / "m.png")
    with open(pngs["--device-quantize"], "rb") as f, open(png, "wb") as g:
        g.write(f.read())
    assert ttools.towav([png, "--device", "cpu"]) == 0
    w0, sr = read_wav(png + ".wav")
    assert sr == 44100 and w0.dtype == np.int16
    other = str(tmp_path / "s1.wav")
    assert ttools.towav([png, "-o", other, "--seed", "1", "--device", "cpu"]) == 0
    assert not np.array_equal(read_wav(other)[0], w0)


def test_mel_bin_mismatch_raises_config_error(pngs, tmp_path):
    out = str(tmp_path / "o.wav")
    for dq in (True, False):
        with pytest.raises(ConfigError, match="mel bins"):
            Mel(device_quantize=dq, device="cpu").to_wav_png(pngs["--device-quantize"], out)
    with pytest.raises(ConfigError, match="mel bins"):
        Mel(CFG, device="cpu").decode(np.zeros((4, 160, 2)))
    assert ttools.towav([pngs["--device-quantize"], "-o", out, "--num-mels",
                         "160", "--device", "cpu"]) == 1
    assert not os.path.exists(out)


def test_towav_without_cuda_exits_1(pngs, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    out = str(tmp_path / "x.wav")
    assert ttools.towav([pngs["--device-quantize"], "-o", out]) == 1
    assert ttools.towav([pngs["--device-quantize"], "-o", out, "--device",
                         "cuda"]) == 1
    assert not os.path.exists(out)
    assert "'cuda' is not available" in capsys.readouterr().err


@pytest.mark.parametrize("tool,png_input", [("tomel", False), ("towav", True)])
def test_mel_parser_has_the_jax_flags(tool, png_input):
    def options(parser):
        return {s for a in parser._actions for s in a.option_strings}

    jax_opts = options(jtools._mel_parser(tool, png_input))
    port_opts = options(ttools._mel_parser(tool, png_input))
    assert port_opts == jax_opts | {"--device"}


def test_tomel_accepts_the_shared_flags(pngs, tmp_path):
    """tomel takes --volume-boost and --griffin-lim-iterations, as the JAX
    tomel does; they do not change the encode."""
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    assert ttools.tomel([pngs["wav"], "-o", a, "--device", "cpu"]) == 0
    assert ttools.tomel([pngs["wav"], "-o", b, "--volume-boost", "0",
                         "--griffin-lim-iterations", "4", "--device",
                         "cpu"]) == 0
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
