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
from gomel_tpu.io import dataset as jds
from gomel_tpu.io import flac as jflac
from gomel_tpu.io import float16meta as jf16
from gomel_tpu.io import imagecodec as jimg
from gomel_tpu.io import pngcodec as jpng
from gomel_tpu.io import wavcodec as jwav
from gomel_tpu.ops import dft_mm as jdft
from gomel_tpu.ops import mxu_fft as jmxu
from gomel_tpu.ops import stft as jstft
from gomel_tpu.parallel import batch as jbatch
from gomel_tpu.parallel import sharded as jsharded
from gomel_tpu_torch.core import config as tcfg
from gomel_tpu_torch.core import filterbank as tfb
from gomel_tpu_torch.core import framing as tfr
from gomel_tpu_torch.io import _native as tnative
from gomel_tpu_torch.io import audio as taudio
from gomel_tpu_torch.io import dataset as tds
from gomel_tpu_torch.io import flac as tflac
from gomel_tpu_torch.io import float16meta as tf16
from gomel_tpu_torch.io import imagecodec as timg
from gomel_tpu_torch.io import pngcodec as tpng
from gomel_tpu_torch.io import wavcodec as twav
from gomel_tpu_torch.ops import dft_mm as tdft
from gomel_tpu_torch.ops import fftbackend as tfft
from gomel_tpu_torch.ops import stft as tstft
from gomel_tpu_torch.parallel import batch as tbatch
from gomel_tpu_torch.parallel import sharded as tsharded

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


@pytest.mark.parametrize("mono", ["mean", "left"])
def test_load_wav_pcm16_equal(tmp_path, mono):
    """io/audio.load_wav_pcm16 (gomel_tpu/io/audio.py:100): (int16, rate)
    for a 16-bit file, mono and stereo, None for a file that needs the
    float path (three channels averaged), exactly as the original."""
    rng = np.random.default_rng(2)
    for name, buf, rate in (
            ("m16", rng.integers(-32768, 32768, 3001, dtype=np.int16), 16000),
            ("s16", rng.integers(-32768, 32768, (2001, 2), dtype=np.int16),
             48000),
            ("c3", rng.integers(-32768, 32768, (999, 3), dtype=np.int16),
             22050)):
        path = str(tmp_path / f"{name}.wav")
        jwav.write_wav(path, buf, rate)
        got, want = taudio.load_wav_pcm16(path, mono), \
            jaudio.load_wav_pcm16(path, mono)
        if want is None:
            assert got is None and name == "c3" and mono == "mean"
            continue
        assert got[1] == want[1] == rate and got[0].dtype == want[0].dtype
        np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(tcfg.FileNotLoadedError):
        taudio.load_wav_pcm16(str(tmp_path / "missing.wav"))


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
            "gomel_tpu_torch.cli.batch, gomel_tpu_torch.parallel, "
            "gomel_tpu_torch.io.flac, gomel_tpu_torch.io.dataset, "
            "gomel_tpu_torch.ops.fftbackend, gomel_tpu_torch.ops.phase_ops, "
            "gomel_tpu_torch.ops.dft_mm; "
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


# -- FLAC, the dataset loader and the bucketer (the batch slice) -------------

def _flac_pcm(n, ch, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    tone = 8000 * np.sin(2 * np.pi * 440 * t)[:, None] + rng.integers(
        -300, 300, size=(n, ch))
    return np.clip(tone, -32768, 32767).astype(np.int64).squeeze()


def _source_body(path):
    """A C++ source below its header comment (the ``//`` lines before the
    first line of code)."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return b"\n".join(lines[next(i for i, ln in enumerate(lines)
                                 if not ln.startswith(b"//")):])


def test_flacdec_source_equal():
    """The C++ decoder is the JAX package's, byte for byte below its header
    comment (which names the port's paths)."""
    assert _source_body(os.path.join(REPO, "gomel_tpu_torch", "native",
                                     "flacdec.cpp")) == \
        _source_body(os.path.join(REPO, "gomel_tpu", "native", "flacdec.cpp"))


@pytest.mark.parametrize("mode", ["verbatim", "fixed"])
@pytest.mark.parametrize("ch", [1, 2])
def test_read_flac_equal(tmp_path, mode, ch):
    pcm = _flac_pcm(9000 + 123, ch, seed=ch)
    path = str(tmp_path / "a.flac")
    tflac.write_flac(path, pcm, 16000, mode=mode)
    with open(path, "rb") as f:
        data = f.read()
    jflac.write_flac(str(tmp_path / "j.flac"), pcm, 16000, mode=mode)
    assert (tmp_path / "j.flac").read_bytes() == data
    for layout in ("interleaved", "go_concat"):
        got, sr = tflac.read_flac(path, layout=layout)
        want, sr_j = jflac.read_flac(path, layout=layout)
        assert sr == sr_j == 16000 and got.dtype == want.dtype == np.int16
        np.testing.assert_array_equal(got, want)
        lay = 1 if layout == "go_concat" else 0
        for x, y in zip(tflac._decode_python(data, lay),
                        jflac._decode_python(data, lay)):
            np.testing.assert_array_equal(x, y)
    # the native and the pure-Python decoders agree
    arr, nch, sr, bps = tflac._decode_python(data)
    np.testing.assert_array_equal(arr.reshape(-1, nch).squeeze(),
                                  tflac.read_flac(path)[0])
    assert tflac.decoder() == "native"


def test_native_flac_builds_outside_the_sources():
    lib = tflac._get_lib()
    assert lib is not None
    assert os.path.dirname(tflac._flaclib._so) == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.startswith(os.path.join(REPO, "build"))
    assert not [f for f in os.listdir(os.path.join(REPO, "gomel_tpu_torch",
                                                   "native"))
                if f.endswith(".so")]


# -- the native PNG scanline filter (native/pngfilter.cpp) --------------------

def test_pngfilter_source_equal():
    """The PNG filter is the JAX package's, byte for byte below its header
    comment."""
    assert _source_body(os.path.join(REPO, "gomel_tpu_torch", "native",
                                     "pngfilter.cpp")) == \
        _source_body(os.path.join(REPO, "gomel_tpu", "native",
                                  "pngfilter.cpp"))


def test_native_png_builds_outside_the_sources():
    assert tnative.get_lib() is not None
    assert os.path.dirname(tnative._pngfilter._so) == tnative.BUILD_DIR
    assert os.path.exists(os.path.join(tnative.BUILD_DIR, "_pngfilter.so"))
    assert not [f for f in os.listdir(os.path.join(REPO, "gomel_tpu_torch",
                                                   "native"))
                if f.endswith(".so")]


# (shape, dtype): color types 0, 4, 2 and 6 at odd widths, and one row
_PNG_CASES = [((7, 13), np.uint8), ((5, 11, 2), np.uint8),
              ((6, 9, 3), np.uint8), ((9, 31, 4), np.uint8),
              ((1, 17, 4), np.uint8), ((7, 13), np.uint16),
              ((5, 11, 2), np.uint16), ((6, 9, 3), np.uint16),
              ((9, 31, 4), np.uint16), ((1, 5, 3), np.uint16)]


@pytest.mark.parametrize("shape,dtype", _PNG_CASES)
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4],
                                     [0, 1, 2, 3, 4], [4, 3, 1]])
def test_read_png_native_and_numpy_equal(tmp_path, shape, dtype, filters):
    """Rows carrying each filter type (tools/png_filters.py): the native
    unfilter, the numpy path and the JAX package's reader give the image."""
    from tools.png_filters import numpy_path, png_bytes
    img = np.random.default_rng(len(shape) * 7 + shape[-1]).integers(
        0, np.iinfo(dtype).max + 1, size=shape, dtype=dtype)
    want = img[..., 0] if img.ndim == 3 and img.shape[2] == 1 else img
    path = tmp_path / "f.png"
    path.write_bytes(png_bytes(img, filters))
    got = tpng.read_png(str(path))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        numpy_path(lambda: tpng.read_png(str(path)))(), want)
    np.testing.assert_array_equal(jpng.read_png(str(path)), want)


@pytest.mark.parametrize("shape,dtype", [c for c in _PNG_CASES
                                         if len(c[0]) == 2
                                         or c[0][2] in (3, 4)])
def test_write_png_native_and_numpy_equal(tmp_path, shape, dtype):
    from tools.png_filters import numpy_path
    img = np.random.default_rng(shape[1]).integers(
        0, np.iinfo(dtype).max + 1, size=shape, dtype=dtype)
    a, b = tmp_path / "native.png", tmp_path / "numpy.png"
    tpng.write_png(str(a), img)
    numpy_path(lambda: tpng.write_png(str(b), img))()
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(tpng.read_png(str(a)), img)


def test_png_invalid_filter_raises(tmp_path):
    from tools.png_filters import numpy_path, png_bytes
    data = bytearray(png_bytes(np.zeros((3, 4, 3), np.uint8), [0]))
    raw = bytearray(zlib.decompress(bytes(data[41:data.index(b"IEND") - 8])))
    raw[1 + 12] = 5                                 # row 1's filter byte
    idat = zlib.compress(bytes(raw))
    body = b"IDAT" + idat
    crc = zlib.crc32(body).to_bytes(4, "big")
    png = (bytes(data[:33]) + len(idat).to_bytes(4, "big") + body + crc
           + b"\x00\x00\x00\x00IEND\xaeB`\x82")
    path = tmp_path / "bad.png"
    path.write_bytes(png)
    with pytest.raises(ValueError, match="filter type"):
        tpng.read_png(str(path))
    with pytest.raises(ValueError, match="filter type"):
        numpy_path(lambda: tpng.read_png(str(path)))()


def test_pngfilter_argtypes_match_declarations():
    """``_configure_pngfilter``'s ctypes lists against the C declarations of
    png_unfilter and png_filter_up (a list that drifts passes garbage)."""
    import ctypes
    import re
    import types
    with open(os.path.join(REPO, "gomel_tpu_torch", "native",
                           "pngfilter.cpp")) as f:
        text = f.read()
    kinds = {"int": ctypes.c_int, "long": ctypes.c_long, "void": None}
    lib = types.SimpleNamespace(png_unfilter=types.SimpleNamespace(),
                                png_filter_up=types.SimpleNamespace())
    tnative._configure_pngfilter(lib)
    decls = re.findall(r"^(int|void) (png_\w+)\(([^)]*)\)", text, re.M)
    assert sorted(d[1] for d in decls) == ["png_filter_up", "png_unfilter"]
    for ret, name, params in decls:
        fn = getattr(lib, name)
        assert fn.restype is kinds[ret]
        want = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
                for p in params.split(",")]
        assert fn.argtypes == want, name


@pytest.mark.parametrize("mono", ["mean", "left", "go_concat"])
def test_load_flac_equal(tmp_path, mono):
    path = str(tmp_path / "s.flac")
    tflac.write_flac(path, _flac_pcm(5001, 2, seed=3), 16000)
    for scaling in ("phase", "mel"):
        x, sr = taudio.load_flac(path, mono, scaling)
        y, sr_j = jaudio.load_flac(path, mono, scaling)
        assert sr == sr_j
        np.testing.assert_array_equal(x, y)
        for raw in (False, True):
            x, _ = taudio.load_flac_any(path, mono, scaling, raw_pcm16=raw)
            y, _ = jaudio.load_flac_any(path, mono, scaling, raw_pcm16=raw)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    got = taudio.load_flac_pcm16(path, mono)
    want = jaudio.load_flac_pcm16(path, mono)
    np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(tcfg.FileNotLoadedError):
        taudio.load_flac(str(tmp_path / "missing.flac"))


@pytest.fixture
def audio_dir(tmp_path):
    """Five files, WAV and FLAC alternating, plus a file to ignore."""
    rng = np.random.default_rng(6)
    paths = []
    for i in range(5):
        buf = rng.uniform(-0.5, 0.5, 1000 + 500 * i)
        p = tmp_path / (f"u{i}.wav" if i % 2 == 0 else f"u{i}.flac")
        if i % 2 == 0:
            jaudio.save_wav(str(p), buf, 16000)
        else:
            jflac.write_flac(str(p), buf, 16000)
        paths.append(str(p))
    (tmp_path / "notes.txt").write_text("ignore me")
    return tmp_path, sorted(paths)


def test_dataset_equal(audio_dir, tmp_path):
    d, paths = audio_dir
    assert tds.list_audio_files(str(d)) == jds.list_audio_files(str(d)) \
        == paths
    assert tds.list_audio_files(str(d), recursive=False) == paths
    for p in paths:
        for raw in (False, True):
            for scaling in ("phase", "mel"):
                x, sr = tds.load_audio(p, "go_concat", scaling, raw)
                y, sr_j = jds.load_audio(p, "go_concat", scaling, raw)
                assert sr == sr_j and x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
                assert tds.pcm_scale_for(p, x, scaling) == \
                    jds.pcm_scale_for(p, y, scaling)
    # order, prefetch, skip and raise, as tests/test_dataset.py
    got = [(p, b) for p, b, _ in tds.AudioDataset(paths, num_workers=3,
                                                   prefetch=2)]
    want = [(p, b) for p, b, _ in jds.AudioDataset(paths)]
    assert [p for p, _ in got] == [p for p, _ in want] == paths
    for (_, x), (_, y) in zip(got, want):
        np.testing.assert_array_equal(x, y)
    bad = str(tmp_path / "bad.flac")
    with open(bad, "wb") as f:
        f.write(b"garbage")
    ds = tds.AudioDataset([paths[0], bad, paths[1]], on_error="skip")
    assert [p for p, _, _ in ds] == [paths[0], paths[1]]
    with pytest.raises(tcfg.GomelError):
        list(tds.AudioDataset([bad], on_error="raise"))
    batches = list(tds.batched_buffers(tds.AudioDataset(paths), 2))
    assert [len(b) for b in batches] == [2, 2, 1]


def test_wav_and_flac_agree(tmp_path):
    """The same content as WAV and as FLAC decodes alike (to 2 LSB: the two
    writers round differently)."""
    buf = np.clip(np.random.default_rng(7).standard_normal(4000) * 0.3,
                  -0.999, 0.999)
    wav_p, flac_p = str(tmp_path / "same.wav"), str(tmp_path / "same.flac")
    taudio.save_wav(wav_p, buf, 16000)
    tflac.write_flac(flac_p, buf, 16000)
    (w, sr_w), (f, sr_f) = tds.load_audio(wav_p), tds.load_audio(flac_p)
    assert sr_w == sr_f == 16000
    np.testing.assert_allclose(w, f, atol=2.0 / 32768)


def test_shard_files_for_process_equal():
    files = [f"f{i}" for i in range(10)]
    for count in (1, 3, 4):
        for index in range(count):
            assert tds.shard_files_for_process(files, index, count) == \
                jds.shard_files_for_process(files, index, count)
    assert tds.shard_files_for_process(files) == files   # rank 0 of 1
    with pytest.raises(ValueError):
        tds.shard_files_for_process(files, 3, 3)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("max_batch", [1, 2, 64])
def test_make_buckets_equal(dtype, max_batch):
    rng = np.random.default_rng(8)
    utts = [(rng.standard_normal(n) * 1000).astype(dtype)
            for n in (100, 5000, 120, 5100, 30000, 0, 777)]
    got = tbatch.make_buckets(utts, hop=64, max_batch=max_batch, dtype=dtype)
    want = jbatch.make_buckets(utts, hop=64, max_batch=max_batch, dtype=dtype)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("audio", "lengths", "indices"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
            assert getattr(g, field).dtype == getattr(w, field).dtype
        assert g.padded_len == w.padded_len
        for multiple in (1, 3, 4):
            gp = tbatch.pad_batch_to_multiple(g, multiple)
            wp = jbatch.pad_batch_to_multiple(w, multiple)
            for field in ("audio", "lengths", "indices"):
                np.testing.assert_array_equal(getattr(gp, field),
                                              getattr(wp, field))
    bounds = [64 * 20, 64 * 100]
    got = tbatch.make_buckets(utts, 64, 4, bucket_boundaries=bounds)
    want = jbatch.make_buckets(utts, 64, 4, bucket_boundaries=bounds)
    assert [b.padded_len for b in got] == [b.padded_len for b in want]


# -- the frame-sharded plan (the long-form slice) ----------------------------

def _plan_fields(plan):
    return (plan.frame_len, plan.hop, plan.n_shards, plan.n_frames,
            plan.n_frames_padded, plan.out_len, plan.halo,
            plan.frames_per_shard, plan.chunk, plan.sharded_signal_len)


@pytest.mark.parametrize("frame_len,hop", [(4096, 1280), (256, 64),
                                           (128, 32), (100, 30), (64, 64)])
def test_plan_frame_sharding_equal(frame_len, hop):
    for n_shards in (1, 2, 3, 4, 8):
        for f in (1, 2, 3, 7, 12, 13, 14, 59, 75, 1000, 67501):
            assert _plan_fields(tsharded.plan_frame_sharding(
                f, frame_len, hop, n_shards)) == _plan_fields(
                    jsharded.plan_frame_sharding(f, frame_len, hop, n_shards))
    for bad in (0, -3):
        for mod in (tsharded, jsharded):
            with pytest.raises(ValueError, match="at least one frame"):
                mod.plan_frame_sharding(bad, frame_len, hop, 4)


def test_pads_for_plan_equal():
    rng = np.random.default_rng(5)
    for f, n_shards in ((12, 4), (13, 4), (59, 8), (3, 2)):
        plan = tsharded.plan_frame_sharding(f, 256, 64, n_shards)
        jplan = jsharded.plan_frame_sharding(f, 256, 64, n_shards)
        target = plan.sharded_signal_len
        # shorter, equal, and reference-padded past the buffer (truncated),
        # in int16 and float, 1-D and batched; type-preserving on numpy
        for length in (plan.out_len - 10, target, plan.out_len + 63):
            for x in (rng.standard_normal(length).astype(np.float32),
                      rng.integers(-9, 9, (2, length)).astype(np.int16)):
                got = tsharded.pad_signal_for_plan(x, plan)
                want = jsharded.pad_signal_for_plan(x, jplan)
                assert type(got) is np.ndarray and got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
                import torch
                np.testing.assert_array_equal(
                    tsharded.pad_signal_for_plan(torch.from_numpy(x),
                                                 plan).numpy(), want)
        for mod, pl in ((tsharded, plan), (jsharded, jplan)):
            with pytest.raises(ValueError, match="inconsistent with plan"):
                mod.pad_signal_for_plan(
                    np.zeros(max(target, plan.out_len) + 64), pl)
        spec = rng.standard_normal((2, f, 5, 2)).astype(np.float32)
        np.testing.assert_array_equal(
            tsharded.pad_frames_for_plan(spec, plan),
            jsharded.pad_frames_for_plan(spec, jplan))
        np.testing.assert_array_equal(
            tsharded.pad_frames_for_plan(spec[0], plan, axis=0),
            jsharded.pad_frames_for_plan(spec[0], jplan, axis=0))


def test_auto_frame_chunk_equal():
    for n in (0, 1, 1023, 3071, 3072, 3073, 16880, 67501):
        assert tstft.auto_frame_chunk(n) == jstft.auto_frame_chunk(n)
        assert (tstft.auto_frame_chunk(n, 100, 7)
                == jstft.auto_frame_chunk(n, 100, 7))


@pytest.mark.parametrize("n", [2, 64, 256, 3000, 4096])
def test_dft_mm_masters_equal(n):
    """The copied float64 weight masters of the matmul DFT equal the JAX
    module's bit for bit, folded with Hann (the cached identity path) and
    with another window, and the inverse keeps imag(DC) = imag(Nyquist) = 0;
    the size rule and MAX_N are the same."""
    np.testing.assert_array_equal(tdft._fwd_np(n), jdft._fwd_np(n))
    inv = tdft._inv_np(n)
    np.testing.assert_array_equal(inv, jdft._inv_np(n))
    half = n // 2 + 1
    assert not inv[half].any() and not inv[-1].any()
    np.testing.assert_array_equal(tdft._fold_fwd(n, tstft.hann_window(n)),
                                  jdft._fold_fwd(n, jstft.hann_window(n)))
    np.testing.assert_array_equal(tdft._fold_inv(n, tstft.hann_window(n)),
                                  jdft._fold_inv(n, jstft.hann_window(n)))
    w = np.random.default_rng(n).random(n)
    np.testing.assert_array_equal(tdft._fold_fwd(n, w), jdft._fold_fwd(n, w))
    np.testing.assert_array_equal(tdft._fold_inv(n, w), jdft._fold_inv(n, w))
    assert tdft.MAX_N == jdft.MAX_N
    for m in (n - 1, n, n + 1, 8192, 8193, 8194):
        assert tdft.supported(m) == jdft.supported(m)


def test_mxu_size_rule_equal():
    """The copied split rule of the matrix-unit FFT (the ``mxu`` name's
    sizes) equals the JAX module's, the same split or the same error."""
    assert tfft._SPLIT_OVERRIDES == jmxu._SPLIT_OVERRIDES
    for n in list(range(1, 700)) + [3000, 4096, 8192, 8194, 16384, 16386,
                                    32768]:
        assert tfft.mxu_supported(n) == jmxu.supported(n), n
        if jmxu.supported(n):
            assert tfft._split(n) == jmxu._split(n), n


def test_fft_kernel_sizes_are_the_even_mxu_sizes():
    """The hand FFT kernels take every even size the JAX package's TPU
    gives its matrix-unit FFT, and "auto" sends exactly the other sizes to
    the xla route on the card. Each such n/2 factors into primes below 128
    (the kernels' direct-DFT radices) and fits two shared buffers."""
    for n in list(range(1, 1200)) + [3000, 4094, 4096, 16000, 16384, 16386]:
        even_mxu = n % 2 == 0 and jmxu.supported(n)
        assert tfft.ct_supported(n) == even_mxu, n
        if n % 2 == 0:
            want = "mxu" if even_mxu else "xla"
            assert tfft.resolve("auto", n, "cuda") == want, n
        if even_mxu:
            m, p = n // 2, 2
            while m > 1:
                while m % p:
                    p += 1
                assert p < 128, n
                m //= p
            assert n // 2 <= 8192
