"""The port's mel-encode slice against the JAX package, end to end on the CPU.

Seeded numpy audio goes through gomel_tpu's Mel / tomel and through
gomel_tpu_torch's (which runs the kernels' plain versions on CPU tensors).
Tolerances are stated at each comparison.
"""
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gomel_tpu.cli import tools as jtools
from gomel_tpu.core.config import MelConfig as JMelConfig
from gomel_tpu.io.audio import save_wav
from gomel_tpu.io.pngcodec import read_png
from gomel_tpu.ops import mel_ops as jmel
from gomel_tpu.pipelines.mel import Mel as JMel
from gomel_tpu_torch.cli import tools as ttools
from gomel_tpu_torch.core.config import MelConfig
from gomel_tpu_torch.io import imagecodec
from gomel_tpu_torch.io.float16meta import pack_floats
from gomel_tpu_torch.ops import mel_ops as tmel
from gomel_tpu_torch.pipelines.mel import Mel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48000


def _audio(secs=3.0, seed=0):
    """Tones plus noise, with a near-silent stretch (quiet bins stress the
    log)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.1 * np.sin(2 * np.pi * 3100.0 * t)
         + 0.02 * rng.standard_normal(t.shape))
    x[len(x) // 3: len(x) // 3 + SR // 2] *= 1e-3
    return x


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("wav") / "in.wav")
    save_wav(path, _audio(), SR)
    return path


def test_encode_f64_matches_jax():
    x = _audio()
    ref = np.asarray(JMel(JMelConfig.cli_default(), dtype=jnp.float64).encode(x))
    out = Mel(MelConfig.cli_default(), dtype=torch.float64, device="cpu").encode(x)
    assert out.dtype == torch.float64 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-9)


def test_encode_f32_matches_jax():
    x = _audio()
    ref = np.asarray(JMel(JMelConfig.cli_default()).encode(x), np.float64)
    out = Mel(MelConfig.cli_default(), device="cpu").encode(x).numpy().astype(np.float64)
    assert out.shape == ref.shape
    # two float32 FFTs differ by ~1e-6 of the peak, which is large in log
    # on quiet bins: compare the mel energies, within 1e-5 of their peak
    e_ref, e_out = np.exp(ref), np.exp(out)
    np.testing.assert_allclose(e_out, e_ref, rtol=0, atol=1e-5 * e_ref.max())


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_mel_encode_batch_matches_jax(dt):
    cfg = MelConfig.cli_default()
    xb = np.stack([_audio(2.0, seed=1), _audio(2.0, seed=2)])
    w = Mel(cfg, device="cpu").fwd_weights.double().numpy()
    np_dt, t_dt, j_dt = ((np.float64, torch.float64, jnp.float64) if dt == "f64"
                         else (np.float32, torch.float32, jnp.float32))
    ref = np.asarray(jmel.mel_encode_batch(
        jnp.asarray(xb, j_dt), cfg.num_mels, cfg.resolut, cfg.window,
        jnp.asarray(w, j_dt)), np.float64)
    out = tmel.mel_encode_batch(
        torch.tensor(xb, dtype=t_dt), cfg.num_mels, cfg.resolut, cfg.window,
        torch.tensor(w, dtype=t_dt)).numpy().astype(np.float64)
    assert out.shape == ref.shape and out.shape[0] == 2
    if dt == "f64":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9)
    else:
        np.testing.assert_allclose(np.exp(out), np.exp(ref), rtol=0,
                                   atol=1e-5 * np.exp(ref).max())
    with pytest.raises(ValueError):
        tmel.mel_encode_batch(torch.zeros(100000), cfg.num_mels, cfg.resolut,
                              cfg.window, torch.tensor(w))


def test_from_numpy_matches_own_construction():
    cfg = MelConfig.cli_default()
    jm = JMel(JMelConfig.cli_default())
    fwd, _ = jm._weights()
    port = Mel.from_numpy(cfg, np.asarray(fwd), np.asarray(jm._win()), device="cpu")
    own = Mel(cfg, device="cpu")
    assert port.dtype == own.dtype == torch.float32
    assert torch.equal(port.fwd_weights, own.fwd_weights)
    assert torch.equal(port.window, own.window)
    x = _audio(1.0)
    assert torch.equal(port.encode(x), own.encode(x))
    with pytest.raises(ValueError):
        Mel.from_numpy(cfg, np.asarray(fwd)[:10], np.asarray(jm._win()), device="cpu")


def test_reference_layout_api_matches_jax(wav):
    x = _audio(1.0, seed=3)
    jm = JMel(JMelConfig.cli_default(), dtype=jnp.float64)
    tm = Mel(MelConfig.cli_default(), dtype=torch.float64, device="cpu")
    flat = tm.to_mel(x)
    assert flat.dtype == np.float64
    np.testing.assert_allclose(flat, jm.to_mel(x), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tm.image(flat), jm.image(flat))
    np.testing.assert_allclose(tm.to_tensor_wav(wav).numpy(),
                               np.asarray(jm.to_tensor_wav(wav)),
                               rtol=0, atol=1e-9)
    torch.testing.assert_close(tm.to_tensor(x), tm.encode(x), rtol=0, atol=0)
    with pytest.raises(ValueError):
        tm.encode(np.zeros((2, 50000)))


def test_encode_quantized_matches_jax():
    x = _audio(2.0, seed=4)
    img_j, mx_j, mn_j = JMel(JMelConfig.cli_default()).encode_quantized(x)
    img, mx, mn = Mel(MelConfig.cli_default(), device="cpu").encode_quantized(x)
    a, b = np.asarray(img_j).astype(np.int64), img.numpy().astype(np.int64)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff > 0).mean() < 2e-3   # f32 trunc flips
    assert pack_floats([float(mx), float(mn)]) == pack_floats([float(mx_j),
                                                               float(mn_j)])


def test_host_quantize_png_byte_equal_f64(wav, tmp_path):
    """The host-quantize path in float64 on both sides writes the same bytes."""
    a, b = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    JMel(JMelConfig.cli_default(), dtype=jnp.float64).to_mel_wav(wav, a)
    Mel(MelConfig.cli_default(), dtype=torch.float64, device="cpu").to_mel_wav(wav, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_tomel_cli_matches_jax(wav, tmp_path):
    """Both CLIs at their defaults (device quantize in float32)."""
    a, b = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    assert jtools.tomel([wav, "-o", a]) == 0
    assert ttools.tomel([wav, "-o", b, "--device", "cpu"]) == 0
    ia, ib = read_png(a).astype(np.int64), read_png(b).astype(np.int64)
    assert ia.shape == ib.shape
    diff = np.abs(ia - ib)
    assert diff.max() <= 1, f"max pixel diff {diff.max()}"
    assert (diff > 0).mean() < 2e-3
    # metadata (float16-packed extrema, samples, rate) equal
    ma = imagecodec.load_mel_image_raw(a, True)[1:]
    mb = imagecodec.load_mel_image_raw(b, True)[1:]
    assert ma == mb


def _write_float32_wav(path, x, sr):
    """A mono 32-bit float WAV (format code 3): not int16, so the
    device-quantize path takes its float branch."""
    payload = np.asarray(x, "<f4").tobytes()
    header = (b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
              + b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, sr, sr * 4, 4, 32)
              + b"data" + struct.pack("<I", len(payload)))
    with open(path, "wb") as f:
        f.write(header + payload)


def test_tomel_float_wav_takes_float_branch(tmp_path):
    wav = str(tmp_path / "f.wav")
    _write_float32_wav(wav, _audio(1.5, seed=5), SR)
    a, b = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    JMel(JMelConfig.cli_default(), device_quantize=True).to_mel_wav(wav, a)
    Mel(MelConfig.cli_default(), device_quantize=True, device="cpu").to_mel_wav(wav, b)
    ia, ib = read_png(a).astype(np.int64), read_png(b).astype(np.int64)
    assert ia.shape == ib.shape
    diff = np.abs(ia - ib)
    assert diff.max() <= 1 and (diff > 0).mean() < 2e-3   # f32 trunc flips


def test_tomel_host_quantize_and_routing(wav, tmp_path):
    out = str(tmp_path / "h.png")
    assert ttools.tomel([wav, "-o", out, "--host-quantize", "--device", "cpu"]) == 0
    spec, samples, sr = imagecodec.load_mel_image(out, True)
    assert spec.shape[1:] == (192, 2) and sr == SR
    assert ttools._route_audio_input("a") == ("a.wav", "wav")
    assert ttools._route_audio_input("a.flac") == ("a.flac", "flac")


def test_flac_input_not_ported(tmp_path, capsys):
    """FLAC input is ported now: a missing FLAC fails with the loader's
    error and tomel exits 1; a 16-bit FLAC encodes (its parity with the JAX
    package is tests/test_torch_batch.py::test_to_mel_flac_vs_jax)."""
    from gomel_tpu_torch.core.config import FileNotLoadedError
    from gomel_tpu_torch.io.flac import write_flac
    flac = str(tmp_path / "x.flac")
    with pytest.raises(FileNotLoadedError):
        Mel(MelConfig.cli_default(), device="cpu").to_mel_flac(flac, flac + ".png")
    assert ttools.tomel([flac, "--device", "cpu"]) == 1
    assert "could not load flac" in capsys.readouterr().err
    write_flac(flac, np.sin(np.arange(9000) / 7.0) * 0.3, 48000)
    assert ttools.tomel([flac, "--device", "cpu"]) == 0
    assert read_png(flac + ".png").shape[0] == 192
    assert ttools.tomel([str(tmp_path / "missing.wav"), "--device", "cpu"]) == 1


def test_cli_module_entry_point(wav, tmp_path):
    out = str(tmp_path / "m.png")
    proc = subprocess.run(
        [sys.executable, "-m", "gomel_tpu_torch.cli.tools", "tomel", wav,
         "-o", out, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert read_png(out).shape[:2] == (192, 110)
    assert ttools.main([]) == 1
