"""The port's copied host modules (core/, io/) against the JAX package's.

gomel_tpu_torch cannot import gomel_tpu (its package __init__ imports JAX),
so it carries copies of the numpy-only host code it needs. These tests pin
each copy to its original, and check that the port's import pulls in
neither JAX nor gomel_tpu.
"""
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

from gomel_tpu.core import config as jcfg
from gomel_tpu.core import filterbank as jfb
from gomel_tpu.core import framing as jfr
from gomel_tpu.io import audio as jaudio
from gomel_tpu.io import float16meta as jf16
from gomel_tpu.io import imagecodec as jimg
from gomel_tpu.io import pngcodec as jpng
from gomel_tpu.io import wavcodec as jwav
from gomel_tpu_torch.core import config as tcfg
from gomel_tpu_torch.core import filterbank as tfb
from gomel_tpu_torch.core import framing as tfr
from gomel_tpu_torch.io import audio as taudio
from gomel_tpu_torch.io import float16meta as tf16
from gomel_tpu_torch.io import imagecodec as timg
from gomel_tpu_torch.io import pngcodec as tpng
from gomel_tpu_torch.io import wavcodec as twav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_bins,n_mels,fmin,fmax", [
    (2048, 192, 0.0, 16000.0),   # MelConfig.cli_default()
    (2048, 192, 0.0, 22050.0),   # 44.1 kHz full band
    (1024, 160, 0.0, 8000.0),    # bare MelConfig() (NewMel defaults)
    (256, 40, 20.0, 4000.0),
])
def test_mel_weights_equal(n_bins, n_mels, fmin, fmax):
    w_jax = jfb.mel_weights(n_bins, n_mels, fmin, fmax)
    w_port = tfb.mel_weights(n_bins, n_mels, fmin, fmax)
    assert w_port.dtype == w_jax.dtype == np.float64
    np.testing.assert_array_equal(w_port, w_jax)
    np.testing.assert_array_equal(
        tfb.inverse_mel_weights(n_bins, n_mels, fmin, fmax),
        jfb.inverse_mel_weights(n_bins, n_mels, fmin, fmax))


def test_configs_equal():
    assert (tcfg.MelConfig.cli_default().__dict__
            == jcfg.MelConfig.cli_default().__dict__)
    assert tcfg.MelConfig().__dict__ == jcfg.MelConfig().__dict__
    for sr in tcfg.SUPPORTED_SAMPLE_RATES:
        assert tcfg.pad_shift(sr) == jcfg.pad_shift(sr)
        assert (tcfg.num_freqs_for_sample_rate(sr)
                == jcfg.num_freqs_for_sample_rate(sr))
    with pytest.raises(tcfg.ConfigError):
        tcfg.MelConfig(resolut=4095)


def test_framing_equal_over_sweep():
    for window in (1, 7, 128, 256, 1280):
        for n in list(range(0, 40 * window, max(1, window // 3))) + [1440000]:
            assert tfr.pad_length(n, window) == jfr.pad_length(n, window)
            for frame_len in (window, 4 * window, 4096):
                assert (tfr.num_frames(n, frame_len, window)
                        == jfr.num_frames(n, frame_len, window))
                assert (tfr.frames_for_padded(n, window, frame_len)
                        == jfr.frames_for_padded(n, window, frame_len))


@pytest.mark.parametrize("shape,dtype", [
    ((37, 53, 4), np.uint8), ((20, 31, 3), np.uint8), ((16, 9), np.uint16),
    ((1, 5, 4), np.uint8)])
def test_write_png_bytes_equal(tmp_path, shape, dtype):
    rng = np.random.default_rng(0)
    img = rng.integers(0, np.iinfo(dtype).max + 1, size=shape, dtype=dtype)
    a, b = tmp_path / "jax.png", tmp_path / "port.png"
    jpng.write_png(str(a), img)
    tpng.write_png(str(b), img)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(tpng.read_png(str(a)), img)
    jpng.write_png(str(a), img, compress_level=6,
                   compress_strategy=zlib.Z_DEFAULT_STRATEGY)
    np.testing.assert_array_equal(tpng.read_png(str(a)), img)


def test_wav_read_equal(tmp_path):
    rng = np.random.default_rng(1)
    stereo = rng.integers(-32768, 32768, size=(4001, 2), dtype=np.int16)
    path = str(tmp_path / "s.wav")
    jwav.write_wav(path, stereo, 44100)
    a, sr_a = jwav.read_wav(path)
    b, sr_b = twav.read_wav(path)
    np.testing.assert_array_equal(a, b)
    assert sr_a == sr_b == 44100
    for mono in ("mean", "left"):
        np.testing.assert_array_equal(taudio.load_wav(path, mono)[0],
                                      jaudio.load_wav(path, mono)[0])
        for raw in (False, True):
            x, _ = taudio.load_wav_any(path, mono, raw_pcm16=raw)
            y, _ = jaudio.load_wav_any(path, mono, raw_pcm16=raw)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    with pytest.raises(tcfg.FileNotLoadedError):
        taudio.load_wav(str(tmp_path / "missing.wav"))


def test_mel_image_codec_equal(tmp_path):
    rng = np.random.default_rng(2)
    spec = rng.standard_normal((23, 40, 2)) * 3.0 - 2.0
    a, b = tmp_path / "jax.png", tmp_path / "port.png"
    jimg.save_mel_image(str(a), spec, True, 1280.0, 48000.0)
    timg.save_mel_image(str(b), spec, True, 1280.0, 48000.0)
    assert a.read_bytes() == b.read_bytes()
    for x, y in zip(timg.load_mel_image(str(a), True),
                    jimg.load_mel_image(str(a), True)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(timg.load_mel_image_raw(str(a), True),
                    jimg.load_mel_image_raw(str(a), True)):
        np.testing.assert_array_equal(x, y)
    planes = rng.integers(0, 256, size=(40, 23, 2), dtype=np.uint8)
    jimg.save_mel_image_quantized(str(a), planes, 1.5, -3.0, True, 1280.0, 48000.0)
    timg.save_mel_image_quantized(str(b), planes, 1.5, -3.0, True, 1280.0, 48000.0)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(timg.dump_buffer_u16(spec),
                                  jimg.dump_buffer_u16(spec))
    assert tf16.pack_floats([1.5, -3.0, 1e4]) == jf16.pack_floats([1.5, -3.0, 1e4])


@pytest.mark.parametrize("layout,hdr,ihs", [
    ("go", False, 0), ("py", False, 0), ("go", True, 0), ("py", True, 0),
    ("go", False, 2), ("py", False, 2)])
def test_phase_image_codec_equal(tmp_path, layout, hdr, ihs):
    rng = np.random.default_rng(3)
    spec = rng.standard_normal((21, 64, 2)) * 30.0
    a, b = tmp_path / "jax.png", tmp_path / "port.png"
    jimg.save_phase_image(str(a), spec, True, 1280.5, 48000.0, ihs, hdr,
                          layout=layout)
    timg.save_phase_image(str(b), spec, True, 1280.5, 48000.0, ihs, hdr,
                          layout=layout)
    assert a.read_bytes() == b.read_bytes()
    for lay in (layout, "auto"):
        for x, y in zip(timg.load_phase_image(str(a), True, ihs, hdr, lay),
                        jimg.load_phase_image(str(a), True, ihs, hdr, lay)):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(timg.load_phase_image_raw(str(a), True, hdr, lay),
                        jimg.load_phase_image_raw(str(a), True, hdr, lay)):
            np.testing.assert_array_equal(x, y)
    img = tpng.read_png(str(a))
    assert timg._detect_phase_layout(img[::-1]) == \
        jimg._detect_phase_layout(img[::-1]) == layout
    np.testing.assert_array_equal(timg._quantize_wrap(-spec[..., 0] / 40, 255),
                                  jimg._quantize_wrap(-spec[..., 0] / 40, 255))
    assert (timg.GO_PHASE_META_BYTES, timg.PY_PHASE_META_BYTES) == \
        (jimg.GO_PHASE_META_BYTES, jimg.PY_PHASE_META_BYTES)


@pytest.mark.parametrize("layout,hdr", [("go", False), ("py", False),
                                        ("go", True)])
def test_phase_image_quantized_round_trip(tmp_path, layout, hdr):
    rng = np.random.default_rng(4)
    max_val = 65535 if hdr else 255
    dtype = np.uint16 if hdr else np.uint8
    planes = rng.integers(0, max_val + 1, size=(40, 23, 2)).astype(dtype)
    maxs, mins = np.array([2.5, 3.0], np.float32), np.array([-1.5, -4.0],
                                                            np.float32)
    a, b = tmp_path / "jax.png", tmp_path / "port.png"
    jimg.save_phase_image_quantized(str(a), planes, maxs, mins, True, 1280.0,
                                    16000.0, hdr, layout=layout)
    timg.save_phase_image_quantized(str(b), planes, maxs, mins, True, 1280.0,
                                    16000.0, hdr, layout=layout)
    assert a.read_bytes() == b.read_bytes()
    got = timg.load_phase_image_raw(str(b), True, hdr)
    np.testing.assert_array_equal(got[0], planes)
    np.testing.assert_array_equal(got[1], maxs)
    np.testing.assert_array_equal(got[2], mins)
    assert got[3:] == (1280.0 * 23, 16000.0, 40)
    with pytest.raises(ValueError):
        timg.save_phase_image_quantized(str(b), planes.astype(np.int32), maxs,
                                        mins, True, 1.0, 1.0, hdr)


def test_save_wav_equal(tmp_path):
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.standard_normal(3001) * 0.4, [1.5, -2.0, 0.5 / 32768,
                                                          1.5 / 32768]])
    for stereo in (False, True):
        a, b = tmp_path / "jax.wav", tmp_path / "port.wav"
        jaudio.save_wav(str(a), x, 24000, stereo=stereo)
        taudio.save_wav(str(b), x, 24000, stereo=stereo)
        assert a.read_bytes() == b.read_bytes()
        pcm = twav.read_wav(str(b))[0]
        pcm = pcm if pcm.ndim == 1 else pcm[:, 0]
        jaudio.save_wav_pcm16(str(a), pcm, 24000, stereo=stereo)
        taudio.save_wav_pcm16(str(b), pcm, 24000, stereo=stereo)
        assert a.read_bytes() == b.read_bytes()
    with pytest.raises(ValueError):
        taudio.save_wav(str(b), np.array([0.1, np.nan]), 24000)
    with pytest.raises(ValueError):
        taudio.save_wav_pcm16(str(b), np.zeros(4, np.int32), 24000)


def test_phase_configs_equal():
    assert (tcfg.PhaseConfig.cli_default().__dict__
            == jcfg.PhaseConfig.cli_default().__dict__)
    assert tcfg.PhaseConfig().__dict__ == jcfg.PhaseConfig().__dict__
    for sr in tcfg.SUPPORTED_SAMPLE_RATES:
        for hdr in (False, True):
            assert (tcfg.PhaseConfig.for_sample_rate(sr, hdr=hdr).__dict__
                    == jcfg.PhaseConfig.for_sample_rate(sr, hdr=hdr).__dict__)
        for n in (0, 1, 999, 1000, 1001):
            zp, zs = tcfg.pad_shift(sr)
            assert (tfr.zero_stuff_output_length(n, zp, zs)
                    == jfr.zero_stuff_output_length(n, zp, zs))


def test_port_imports_no_jax():
    code = ("import sys; import gomel_tpu_torch, gomel_tpu_torch.cli.tools, "
            "gomel_tpu_torch.ops.fftbackend, gomel_tpu_torch.ops.phase_ops; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'gomel_tpu' or m.startswith('gomel_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax():
    """No module of the port imports jax or gomel_tpu, on any code path."""
    pkg = os.path.join(REPO, "gomel_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    for line in fh:
                        s = line.strip()
                        assert not s.startswith(("import jax", "from jax")), f
                        assert not s.startswith(("import gomel_tpu ",
                                                 "import gomel_tpu.",
                                                 "from gomel_tpu ",
                                                 "from gomel_tpu.")), f
