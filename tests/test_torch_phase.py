"""The port's phase codec slice against the JAX package, end to end on the CPU.

Seeded numpy audio goes through gomel_tpu's Phase / tophase / fromphase and
through gomel_tpu_torch's (which runs the kernels' plain versions on CPU
tensors). Tolerances are stated at each comparison.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gomel_tpu.cli import tools as jtools
from gomel_tpu.core.config import PhaseConfig as JPhaseConfig
from gomel_tpu.io.audio import load_wav, save_wav
from gomel_tpu.io.pngcodec import read_png
from gomel_tpu.io.wavcodec import read_wav
from gomel_tpu.ops.stft import hann_window as j_hann_window
from gomel_tpu.pipelines.phase import Phase as JPhase
from gomel_tpu_torch import Phase, PhaseConfig
from gomel_tpu_torch.cli import tools as ttools
from gomel_tpu_torch.io import imagecodec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48000


def _audio(secs=2.0, sr=SR, seed=0):
    """Band-limited tones plus a little noise, with a near-silent stretch."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * sr)) / sr
    x = (0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.1 * np.sin(2 * np.pi * 2333.0 * t)
         + 0.01 * rng.standard_normal(t.shape))
    x[len(x) // 3: len(x) // 3 + sr // 4] *= 1e-3
    return x


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("wav") / "in.wav")
    save_wav(path, _audio(), SR)
    return path


@pytest.fixture(scope="module")
def wav16k(tmp_path_factory):
    """A 16 kHz file: the device ingest zero-stuffs it (zp, zs = 1, 2)."""
    path = str(tmp_path_factory.mktemp("wav16") / "in16.wav")
    save_wav(path, _audio(1.5, 16000, seed=1), 16000)
    return path


def _png_step_diff(a_path, b_path, max_val=255):
    """Per-pixel steps between two PNGs, wrap-aware on the derived B channel
    (-1 vs 0 wraps to max_val; tests/test_device_quantize.py)."""
    a, b = read_png(a_path).astype(np.int64), read_png(b_path).astype(np.int64)
    assert a.shape == b.shape
    d = np.abs(a - b)
    return np.minimum(d, (max_val + 1) - d)


def test_encode_f64_matches_jax():
    x = _audio(1.0)
    ref = np.asarray(JPhase(JPhaseConfig.cli_default(), dtype=jnp.float64).encode(x))
    out = Phase(PhaseConfig.cli_default(), dtype=torch.float64, device="cpu").encode(x)
    assert out.dtype == torch.float64 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-9)


def test_encode_f32_matches_jax():
    x = _audio(1.0)
    ref = np.asarray(JPhase(JPhaseConfig.cli_default()).encode(x), np.float64)
    out = Phase(PhaseConfig.cli_default(), device="cpu").encode(x).numpy().astype(np.float64)
    # two float32 FFTs: within 1e-5 of each frame's peak
    peak = np.abs(ref).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(out - ref) <= 1e-5 * peak)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_decode_matches_jax(dt):
    t_dt, j_dt = ((torch.float64, jnp.float64) if dt == "f64"
                  else (torch.float32, jnp.float32))
    spec = np.asarray(JPhase(JPhaseConfig.cli_default(), dtype=jnp.float64)
                      .encode(_audio(1.0, seed=2)))
    ref = np.asarray(JPhase(JPhaseConfig.cli_default(), dtype=j_dt).decode(spec),
                     np.float64)
    out = Phase(PhaseConfig.cli_default(), dtype=t_dt, device="cpu").decode(spec)
    assert out.dtype == t_dt and out.shape == ref.shape
    # f64: exact to rounding; f32: two float32 irffts, 1e-5 of the peak
    tol = 1e-9 if dt == "f64" else 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(out.numpy().astype(np.float64), ref, rtol=0,
                               atol=tol)


def test_reference_layout_api_matches_jax():
    x = _audio(1.0, seed=3)
    jp = JPhase(JPhaseConfig.cli_default(), dtype=jnp.float64)
    tp = Phase(PhaseConfig.cli_default(), dtype=torch.float64, device="cpu")
    flat = tp.to_phase(x)
    assert flat.dtype == np.float64
    np.testing.assert_allclose(flat, jp.to_phase(x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tp.from_phase(flat), jp.from_phase(flat),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tp.image(flat), jp.image(flat))
    x24 = _audio(0.5, 24000, seed=4)
    np.testing.assert_allclose(tp.to_tensor(x24, 24000).numpy(),
                               np.asarray(jp.to_tensor(x24, 24000)),
                               rtol=0, atol=1e-9)
    with pytest.raises(ValueError):
        tp.encode(np.zeros((2, 50000)))


@pytest.mark.parametrize("hdr,ihs", [(False, False), (False, True), (True, False)])
def test_encode_quantized_matches_jax(hdr, ihs):
    x = _audio(1.0, seed=5)
    cfg = dict(hdr=hdr, ihs=ihs)
    img_j, mx_j, mn_j = JPhase(JPhaseConfig.cli_default(**cfg)).encode_quantized(x)
    img, mx, mn = Phase(PhaseConfig.cli_default(**cfg), device="cpu").encode_quantized(x)
    a, b = np.asarray(img_j).astype(np.int64), img.numpy().astype(np.int64)
    assert a.shape == b.shape and img.dtype == (torch.uint16 if hdr else torch.uint8)
    d = np.abs(a - b)
    # float32 FFTs on both sides: 1 step (2 for 16 bits) at most, rarely
    assert d.max() <= (2 if hdr else 1) and (d > 0).mean() < 2e-3
    np.testing.assert_array_max_ulp(mx.numpy(), np.asarray(mx_j), maxulp=1)
    np.testing.assert_array_max_ulp(mn.numpy(), np.asarray(mn_j), maxulp=1)


@pytest.mark.parametrize("layout", ["go", "py"])
def test_host_quantize_png_byte_equal_f64(wav, tmp_path, layout):
    """The host-quantize path in float64 on both sides writes the same bytes."""
    a, b = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    JPhase(JPhaseConfig.cli_default(), dtype=jnp.float64,
           metadata_layout=layout).to_phase_wav(wav, a)
    Phase(PhaseConfig.cli_default(), dtype=torch.float64,
          metadata_layout=layout, device="cpu").to_phase_wav(wav, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_tophase_cli_host_quantize_matches_jax(wav, tmp_path):
    """Both CLIs with --host-quantize: the port's float32 encode against the
    JAX package's float32 encode, quantized on the host in float64."""
    a, b = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    assert jtools.tophase([wav, "-o", a, "--host-quantize"]) == 0
    assert ttools.tophase([wav, "-o", b, "--host-quantize", "--device", "cpu"]) == 0
    d = _png_step_diff(a, b)
    assert d.max() <= 1 and (d > 0).mean() < 2e-3


def _check_device_pngs(a, b, hdr=False):
    """Device-quantize PNGs: at most 1 step at a flip rate < 2e-3, and equal
    metadata."""
    d = _png_step_diff(a, b, 65535 if hdr else 255)
    assert d.max() <= (2 if hdr else 1), f"max pixel diff {d.max()}"
    assert (d > 0).mean() < 2e-3
    ma = imagecodec.load_phase_image_raw(a, True, hdr)[1:]
    mb = imagecodec.load_phase_image_raw(b, True, hdr)[1:]
    for x, y in zip(ma, mb):
        np.testing.assert_array_equal(x, y)


def test_tophase_cli_matches_jax(wav, tmp_path):
    """Both CLIs at their defaults (device quantize in float32)."""
    a, b = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    assert jtools.tophase([wav, "-o", a]) == 0
    assert ttools.tophase([wav, "-o", b, "--device", "cpu"]) == 0
    _check_device_pngs(a, b)


def test_tophase_cli_16k_matches_jax(wav16k, tmp_path):
    a, b = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    assert jtools.tophase([wav16k, "-o", a]) == 0
    assert ttools.tophase([wav16k, "-o", b, "--device", "cpu"]) == 0
    _check_device_pngs(a, b)
    assert imagecodec.load_phase_image_raw(b, True)[4] == 16000.0


@pytest.mark.parametrize("layout,length_mode,hdr,ihs", [
    ("py", "py", False, False), ("go", "go", False, True),
    ("go", "py", True, False)])
def test_device_quantize_layouts_match_jax(wav16k, tmp_path, layout,
                                           length_mode, hdr, ihs):
    a, b = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    kw = dict(metadata_layout=layout, length_mode=length_mode,
              device_quantize=True)
    JPhase(JPhaseConfig.cli_default(hdr=hdr, ihs=ihs), **kw).to_phase_wav(wav16k, a)
    Phase(PhaseConfig.cli_default(hdr=hdr, ihs=ihs), **kw, device="cpu").to_phase_wav(wav16k, b)
    _check_device_pngs(a, b, hdr)


def test_py_layout_reconfigures_sample_rate(wav16k, tmp_path):
    """A py-layout Phase with no rate adopts the file's (phase.py:49-61)."""
    a, b = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    jp = JPhase(metadata_layout="py", device_quantize=True)
    tp = Phase(metadata_layout="py", device_quantize=True, device="cpu")
    jp.to_phase_wav(wav16k, a)
    tp.to_phase_wav(wav16k, b)
    assert tp.config.__dict__ == jp.config.__dict__
    _check_device_pngs(a, b)


@pytest.mark.parametrize("hdr,ihs", [(False, False), (False, True), (True, False)])
def test_fromphase_matches_jax(wav, tmp_path, hdr, ihs):
    """Device-dequantize decode of the same PNG: at most 1 LSB, at a
    differing-sample rate < 5e-2 (tests/test_device_quantize.py:141-143)."""
    png = str(tmp_path / "p.png")
    flags = (["--hdr"] if hdr else []) + (["--ihs"] if ihs else [])
    assert jtools.tophase([wav, "-o", png] + flags) == 0
    a, b = str(tmp_path / "jax.wav"), str(tmp_path / "port.wav")
    assert jtools.fromphase([png, "-o", a] + flags) == 0
    assert ttools.fromphase([png, "-o", b, "--device", "cpu"] + flags) == 0
    wa, sa = read_wav(a)
    wb, sb = read_wav(b)
    assert sa == sb == SR and wa.shape == wb.shape
    lsb = np.abs(wa.astype(np.int64) - wb.astype(np.int64))
    assert lsb.max() <= 1 and (lsb > 0).mean() < 5e-2


def test_fromphase_host_dequantize_matches_jax(wav, tmp_path):
    png = str(tmp_path / "p.png")
    assert jtools.tophase([wav, "-o", png, "--host-quantize"]) == 0
    a, b = str(tmp_path / "jax.wav"), str(tmp_path / "port.wav")
    assert jtools.fromphase([png, "-o", a, "--host-quantize"]) == 0
    assert ttools.fromphase([png, "-o", b, "--host-quantize", "--device",
                             "cpu"]) == 0
    wa, wb = read_wav(a)[0], read_wav(b)[0]
    lsb = np.abs(wa.astype(np.int64) - wb.astype(np.int64))
    assert lsb.max() <= 1 and (lsb > 0).mean() < 5e-2


def test_cli_round_trip_correlation(wav, tmp_path):
    """WAV -> PNG -> WAV through the port's CLIs: correlation > 0.99 for
    band-limited input (content above num_freqs/resolut * sr is dropped by
    design)."""
    png, out = str(tmp_path / "p.png"), str(tmp_path / "out.wav")
    assert ttools.tophase([wav, "-o", png, "--device", "cpu"]) == 0
    assert ttools.fromphase([png, "-o", out, "--device", "cpu"]) == 0
    x, _ = load_wav(wav)
    y, sr = load_wav(out)
    assert sr == SR
    n = min(len(x), len(y))   # the decode ends at N + (F-1)*hop samples
    corr = np.corrcoef(x[4096:n - 4096], y[4096:n - 4096])[0, 1]
    assert corr > 0.99, corr


def test_decode_quantized_pcm16_is_save_wav_conversion(wav):
    """The fused PCM-16 conversion equals save_wav's float64 conversion of
    the float32 decode, bit for bit."""
    p = Phase(PhaseConfig.cli_default(), device_quantize=True, device="cpu")
    img, mx, mn = p.encode_quantized(_audio(1.0, seed=6))
    x = p.decode_quantized(img, mx, mn).numpy().astype(np.float64)
    host = np.clip(np.rint(np.clip(x, -1, 1) * 32768.0), -32768, 32767
                   ).astype(np.int16)
    pcm, finite = p.decode_quantized_pcm16(img, mx, mn)
    assert bool(finite)
    np.testing.assert_array_equal(pcm.numpy(), host)


def test_from_numpy_with_jax_window():
    cfg = PhaseConfig.cli_default()
    win = j_hann_window(cfg.resolut).astype(np.float32)
    port = Phase.from_numpy(cfg, win, device="cpu")
    own = Phase(cfg, device="cpu")
    assert port.dtype == own.dtype == torch.float32
    assert torch.equal(port.window, own.window)
    x = _audio(0.5)
    assert torch.equal(port.encode(x), own.encode(x))
    with pytest.raises(ValueError):
        Phase.from_numpy(cfg, win[:10], device="cpu")
    assert Phase.from_numpy(cfg, win.astype(np.float64), device="cpu").dtype == torch.float64


def test_cli_without_cuda_exits_1(wav, tmp_path, capsys):
    """With no CUDA device and no --device cpu, every tool exits 1, names
    the missing device and writes nothing (no silent CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    png = str(tmp_path / "x.png")
    assert ttools.tomel([wav, "-o", png]) == 1
    assert ttools.tophase([wav, "-o", png]) == 1
    assert not os.path.exists(png)
    assert ttools.tophase([wav, "-o", png, "--device", "cpu"]) == 0
    out = str(tmp_path / "x.wav")
    assert ttools.fromphase([png, "-o", out]) == 1
    assert not os.path.exists(out)
    assert "'cuda' is not available" in capsys.readouterr().err


def test_flac_input_not_ported(tmp_path, capsys):
    """FLAC input is ported now: a missing FLAC fails with the loader's
    error and tophase exits 1; a 16-bit FLAC encodes (its parity with the
    JAX package is tests/test_torch_batch.py::test_to_phase_flac_vs_jax)."""
    from gomel_tpu_torch.core.config import FileNotLoadedError
    from gomel_tpu_torch.io.flac import write_flac
    flac = str(tmp_path / "x.flac")
    with pytest.raises(FileNotLoadedError):
        Phase(PhaseConfig.cli_default(), device="cpu").to_phase_flac(flac, flac + ".png")
    assert ttools.tophase([flac, "--device", "cpu"]) == 1
    assert "could not load flac" in capsys.readouterr().err
    write_flac(flac, np.sin(np.arange(9000) / 7.0) * 0.3, 48000)
    assert ttools.tophase([flac, "--device", "cpu"]) == 0
    assert read_png(flac + ".png").shape[0] == 1536
    assert ttools.fromphase([str(tmp_path / "missing.png"), "--device",
                             "cpu"]) == 1


def test_cli_module_entry_point(wav, tmp_path):
    png = str(tmp_path / "m.png")
    proc = subprocess.run(
        [sys.executable, "-m", "gomel_tpu_torch.cli.tools", "tophase", wav,
         "-o", png, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert read_png(png).shape[:2] == (1536, 72)
