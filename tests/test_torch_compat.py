"""The port's compat drop-ins against the JAX package's, on the CPU.

``gomel_tpu_torch.compat`` (the reference Python port's ``phase`` module and
the ``pypng`` shim) is held to ``gomel_tpu.compat`` with the same seeded numpy
inputs. Both run float32: the port's ``Phase`` on the plain versions of its
kernels (``device="cpu"``), the JAX package's on its CPU backend. Each
comparison states its tolerance.
"""
import inspect
import io
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from gomel_tpu import compat as jcompat
from gomel_tpu.compat import phase as jphase
from gomel_tpu.compat import pypng as jpypng
from gomel_tpu_torch import compat as tcompat
from gomel_tpu_torch.compat import phase as tphase
from gomel_tpu_torch.compat import pypng as tpypng
from gomel_tpu_torch.io import flac as tflac
from gomel_tpu_torch.io import imagecodec
from gomel_tpu_torch.io import pngcodec
from gomel_tpu_torch.io import wavcodec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATES = [8000, 16000, 24000, 32000, 48000, 11025, 22050, 44100]
MODES = ["8bit", "ihs", "hdr"]
PAD_SHIFTS = [(0, 0), (2, 1), (1, 1), (1, 2), (1, 5), (1, 3)]


def _synth(rng, length, sr):
    """Two tones below 0.4 sr plus noise, in (-1, 1)."""
    t = np.arange(length) / sr
    f1, f2 = rng.uniform(50.0, 0.4 * sr, size=2)
    a = (0.5 * np.sin(2 * np.pi * f1 * t)
         + 0.3 * np.sin(2 * np.pi * f2 * t + 1.0)
         + 0.1 * rng.standard_normal(length))
    return np.clip(a, -0.99, 0.99)


def _phases(sr=48000, **kw):
    return (tphase.Phase(sample_rate=sr, device="cpu", **kw),
            jphase.Phase(sample_rate=sr, **kw))


def _png_steps(a_path, b_path, max_val):
    """Per-pixel steps between two PNGs, wrap-aware on the derived B channel
    (-1 vs 0 wraps to max_val)."""
    a = pngcodec.read_png(a_path).astype(np.int64)
    b = pngcodec.read_png(b_path).astype(np.int64)
    assert a.shape == b.shape
    d = np.abs(a - b)
    return np.minimum(d, (max_val + 1) - d)


def _check_pngs(a_path, b_path, hdr):
    """1 step (2 at 16 bits) at a flip rate < 2e-3, and equal metadata in
    the "py" layout (extrema, samples, rate, bins)."""
    d = _png_steps(a_path, b_path, 65535 if hdr else 255)
    assert d.max() <= (2 if hdr else 1) and (d > 0).mean() < 2e-3, \
        (int(d.max()), float((d > 0).mean()))
    meta_a = imagecodec.load_phase_image_raw(a_path, True, hdr, "py")[1:]
    meta_b = imagecodec.load_phase_image_raw(b_path, True, hdr, "py")[1:]
    for u, v in zip(meta_a, meta_b):
        np.testing.assert_array_equal(u, v)


def _check_wavs(a_path, b_path):
    """1 LSB at < 5e-2 of the samples differing, equal rates and lengths."""
    (wa, sa), (wb, sb) = wavcodec.read_wav(a_path), wavcodec.read_wav(b_path)
    assert sa == sb and wa.shape == wb.shape
    d = np.abs(wa.astype(np.int64) - wb.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() < 5e-2, \
        (int(d.max()), float((d > 0).mean()))


# -- buffer-level API ---------------------------------------------------------

@pytest.mark.parametrize("sr,hdr", [(48000, False), (44100, False),
                                    (16000, True)])
def test_to_phase_matches_jax(sr, hdr):
    tp, jp = _phases(sr, HDR=hdr)
    assert tp.num_freqs == jp.num_freqs
    audio = tphase.pad(_synth(np.random.default_rng(sr), 30000, sr), 1280)
    got, want = tp.to_phase(audio), jp.to_phase(audio)
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    # two float32 FFTs: within 1e-5 of each frame's peak
    g = got.reshape(-1, tp.num_freqs, 2)
    w = want.reshape(-1, tp.num_freqs, 2)
    peak = np.abs(w).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(g - w) <= 1e-5 * peak)


@pytest.mark.parametrize("boost", [0.0, 1.5, -0.5])
def test_from_phase_matches_jax(boost):
    """float32 inverse FFTs and overlap-add on both sides: each sample within
    1e-5 of the peak of the frames that cover it. A negative volume_boost
    is ignored (the port applies it only when > 0)."""
    tp, jp = _phases(volume_boost=boost)
    audio = tphase.pad(_synth(np.random.default_rng(3), 40000, 48000), 1280)
    spec = jp.to_phase(audio)
    got, want = tp.from_phase(spec), jp.from_phase(spec)
    assert got.dtype == np.float64 and got.shape == want.shape
    hop, n = tp.window, tp.resolut
    frame_peak = np.array([np.abs(want[s:s + n]).max()
                           for s in range(0, len(want) - n + 1, hop)])
    cover = np.zeros(len(want))
    for f, pk in enumerate(frame_peak):
        np.maximum(cover[f * hop:f * hop + n], pk,
                   out=cover[f * hop:f * hop + n])
    assert np.all(np.abs(got - want) <= 1e-5 * cover)
    if boost <= 0:
        np.testing.assert_allclose(got, _phases()[0].from_phase(spec),
                                   rtol=0, atol=0)


# -- module-level helpers: bit-equal -------------------------------------------

def test_pad_and_is_padded_equal():
    buf = _synth(np.random.default_rng(0), 5000, 48000)
    for window in (64, 1280):
        np.testing.assert_array_equal(tphase.pad(buf, window),
                                      jphase.pad(buf, window))
    for orig in (0, 100, 959, 960, 961, 15 * 64, 15 * 64 + 1):
        for padded in (orig, len(tphase.pad(np.zeros(orig), 64)), orig + 64):
            assert tphase.is_padded(orig, padded, 64) == \
                jphase.is_padded(orig, padded, 64)


def test_spectral_normalize_denormalize_equal():
    s = np.random.default_rng(1).standard_normal((1024, 2)) - 0.3
    np.testing.assert_array_equal(tphase.spectral_normalize(np.abs(s)),
                                  jphase.spectral_normalize(np.abs(s)))
    np.testing.assert_array_equal(tphase.spectral_normalize(s),
                                  jphase.spectral_normalize(s))
    np.testing.assert_array_equal(tphase.spectral_denormalize(s),
                                  jphase.spectral_denormalize(s))


@pytest.mark.parametrize("resolut,num_freqs", [(1024, 96), (4096, 768),
                                               (4096, 2048)])
def test_shrink_grow_equal(resolut, num_freqs):
    rng = np.random.default_rng(resolut + num_freqs)
    flat = rng.standard_normal((6 * (resolut // 2), 2))
    np.testing.assert_array_equal(tphase.shrink(flat, resolut, num_freqs),
                                  jphase.shrink(flat, resolut, num_freqs))
    small = rng.standard_normal((6 * num_freqs, 2))
    np.testing.assert_array_equal(tphase.grow(small, resolut, num_freqs),
                                  jphase.grow(small, resolut, num_freqs))


@pytest.mark.parametrize("zp,zs", PAD_SHIFTS)
@pytest.mark.parametrize("n", [1, 999, 1000, 1001])
def test_zero_stuff_upsample_equal(zp, zs, n):
    x = np.random.default_rng(n).standard_normal(n)
    got = tphase.zero_stuff_upsample(x, zp, zs)
    want = jphase.zero_stuff_upsample(x, zp, zs)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # a list goes in as the reference port's callers pass it
    np.testing.assert_array_equal(tphase.zero_stuff_upsample(list(x), zp, zs),
                                  want)


def test_float16_pack_unpack_equal():
    for v in (0.0, 1.0, -2.5, 1e-4, 65504.0, 123.456, 2.0 ** -24):
        b = tphase.pack_float16_to_bytes(v)
        assert b == jphase.pack_float16_to_bytes(v)
        assert tphase.unpack_bytes_to_float64(b) == \
            jphase.unpack_bytes_to_float64(b)


@pytest.mark.parametrize("mode", MODES)
def test_save_load_image_equal(tmp_path, mode):
    hdr, ihs = mode == "hdr", 2 if mode == "ihs" else 0
    nf = 1536 if hdr else 768
    spec = np.random.default_rng(5).standard_normal((9 * nf, 2)) * 40.0
    a, b = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    tphase.save_image(a, spec, nf, 2.5, 48000, True, hdr, ihs)
    jphase.save_image(b, spec, nf, 2.5, 48000, True, hdr, ihs)
    assert open(a, "rb").read() == open(b, "rb").read()
    got, want = tphase.load_image(a, True, hdr, ihs), \
        jphase.load_image(a, True, hdr, ihs)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1:] == want[1:] and isinstance(got[2], int)


def test_audio_helpers_equal(tmp_path):
    rng = np.random.default_rng(6)
    stereo = rng.integers(-20000, 20000, size=(7001, 2), dtype=np.int16)
    wav, flac = str(tmp_path / "s.wav"), str(tmp_path / "s.flac")
    wavcodec.write_wav(wav, stereo, 22050)
    tflac.write_flac(flac, stereo, 22050)
    for t_fn, j_fn, path in ((tphase.load_wav, jphase.load_wav, wav),
                             (tphase.load_flac, jphase.load_flac, flac)):
        np.testing.assert_array_equal(t_fn(path), j_fn(path))
    for t_fn, j_fn, path in (
            (tphase.load_wav_with_sr, jphase.load_wav_with_sr, wav),
            (tphase.load_flac_with_sr, jphase.load_flac_with_sr, flac)):
        (x, sx), (y, sy) = t_fn(path), j_fn(path)
        np.testing.assert_array_equal(x, y)
        assert sx == sy == 22050
    # stereo collapses by the channel mean
    np.testing.assert_array_equal(
        tphase.load_wav(wav), stereo.astype(np.float64).mean(axis=1) / 32768)
    x = 1.3 * _synth(rng, 5000, 16000)               # clips at +-1
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    tphase.save_wav(a, x, 16000)
    jphase.save_wav(b, x, 16000)
    assert open(a, "rb").read() == open(b, "rb").read()


# -- configuration ------------------------------------------------------------

@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("hdr", [False, True])
def test_config_equal(sr, hdr):
    tp, jp = _phases(sr, HDR=hdr, IHS=True)
    for attr in ("num_freqs", "family", "IHS", "sample_rate", "window",
                 "resolut", "y_reverse", "volume_boost", "HDR"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    for rate in RATES:
        for fn in ("pad_shift", "zero_pad", "zero_shift"):
            try:
                want = getattr(jp, fn)(rate)
            except ValueError:
                with pytest.raises(ValueError):
                    getattr(tp, fn)(rate)
            else:
                assert getattr(tp, fn)(rate) == want


def test_unsupported_rate_raises(tmp_path):
    for cls in (jphase.Phase, tphase.Phase):
        kw = {} if cls is jphase.Phase else {"device": "cpu"}
        with pytest.raises(ValueError):
            cls(sample_rate=12345, **kw)
        p = cls(**kw)
        assert p.num_freqs == 0
        with pytest.raises(ValueError):
            p.to_phase(np.zeros(4096))
        with pytest.raises(ValueError):
            p.reconfigure_sr(12000)
    wav = str(tmp_path / "odd.wav")
    wavcodec.write_wav(wav, np.zeros(4000, np.int16), 12345)
    for dq in (False, True):
        for p in (tphase.Phase(device="cpu", device_quantize=dq),
                  jphase.Phase(device_quantize=dq)):
            with pytest.raises(ValueError):
                p.to_phase_wav(wav, str(tmp_path / "x.png"))


def test_device_defaults_to_cuda():
    """Like every entry point of the port, the drop-in runs on the card
    unless told otherwise, and raises where there is none."""
    assert inspect.signature(tphase.Phase).parameters["device"].default \
        == "cuda"
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not available"):
            tphase.Phase(sample_rate=48000)
    assert tphase.Phase(sample_rate=48000, device="cpu").device.type == "cpu"


# -- file level -----------------------------------------------------------------

@pytest.mark.parametrize("device_quantize", [False, True])
def test_stereo_files_mean_mixed(tmp_path, device_quantize):
    """A stereo WAV: the drop-in's PNG is the JAX package's (the step and
    metadata bounds) and the one of the channel mean written as mono."""
    rng = np.random.default_rng(7)
    left = np.rint(_synth(rng, 24000, 48000) * 20000).astype(np.int16)
    right = np.rint(_synth(rng, 24000, 48000) * 20000).astype(np.int16)
    stereo, mono = str(tmp_path / "st.wav"), str(tmp_path / "mono.wav")
    wavcodec.write_wav(stereo, np.stack([left, right], axis=1), 48000)
    both = left.astype(np.int32) + right.astype(np.int32)
    if np.any(both % 2):                  # an odd sum has no int16 mean
        right = right.copy()
        right[both % 2 != 0] += 1
        wavcodec.write_wav(stereo, np.stack([left, right], axis=1), 48000)
        both = left.astype(np.int32) + right.astype(np.int32)
    wavcodec.write_wav(mono, (both // 2).astype(np.int16), 48000)
    tp, jp = _phases(device_quantize=device_quantize)
    paths = {k: str(tmp_path / f"{k}.png") for k in ("t", "j", "m")}
    tp.to_phase_wav(stereo, paths["t"])
    jp.to_phase_wav(stereo, paths["j"])
    tp.to_phase_wav(mono, paths["m"])
    _check_pngs(paths["t"], paths["j"], False)
    assert open(paths["t"], "rb").read() == open(paths["m"], "rb").read()


def _flac_rate_rescale(tmp_path, sr, device_quantize):
    """to_phase_flac on a zero-stuffed rate records sr x the upsample."""
    x = _synth(np.random.default_rng(8), 6000, sr)
    flac = str(tmp_path / "in.flac")
    tflac.write_flac(flac, x, sr)
    tp, jp = _phases(sr, device_quantize=device_quantize)
    a, b = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    tp.to_phase_flac(flac, a)
    jp.to_phase_flac(flac, b)
    _check_pngs(a, b, False)
    return imagecodec.load_phase_image_raw(a, True, False, "py")[4]


@pytest.mark.parametrize("device_quantize", [False, True])
def test_flac_rate_rescale(tmp_path, device_quantize):
    zp, zs = tphase.Phase(sample_rate=16000, device="cpu").pad_shift(16000)
    rate = _flac_rate_rescale(tmp_path, 16000, device_quantize)
    n_up = 6000 + -(-6000 // zp) * zs
    assert rate == pytest.approx(int(16000 * n_up / 6000), rel=1e-3)


def test_to_tensor_flac_matches_jax(tmp_path):
    x = _synth(np.random.default_rng(9), 9000, 24000)
    flac = str(tmp_path / "in.flac")
    tflac.write_flac(flac, x, 24000)
    tp, jp = _phases(24000)
    got, want = tp.to_tensor_flac(flac), jp.to_tensor_flac(flac)
    assert got.shape == want.shape
    g, w = got.reshape(-1, tp.num_freqs, 2), want.reshape(-1, tp.num_freqs, 2)
    assert np.all(np.abs(g - w)
                  <= 1e-5 * np.abs(w).max(axis=(1, 2), keepdims=True))


@settings(max_examples=36, deadline=None, derandomize=True)
@given(sr=st.sampled_from(RATES), mode=st.sampled_from(MODES),
       device_quantize=st.booleans(), seed=st.integers(0, 2**31 - 1),
       length=st.integers(2_000, 16_000))
def test_file_level_differential(sr, mode, device_quantize, seed, length):
    """The file calls of both drop-ins on one seeded file: ``to_phase_wav``
    and ``to_phase_flac`` PNGs within 1 step (2 at 16 bits) at a flip rate
    < 2e-3 with equal "py" metadata; ``to_wav_png`` of the JAX package's
    PNG within 1 LSB at < 5e-2 differing, at the same rate."""
    hdr, ihs = mode == "hdr", mode == "ihs"
    audio = _synth(np.random.default_rng(seed), length, sr)
    kw = dict(HDR=hdr, IHS=ihs, device_quantize=device_quantize)
    with tempfile.TemporaryDirectory() as d:
        wav, flac = os.path.join(d, "in.wav"), os.path.join(d, "in.flac")
        jphase.save_wav(wav, audio, sr)
        tflac.write_flac(flac, audio, sr)
        tp, jp = _phases(sr, **kw)
        assert (tp.num_freqs, tp.IHS) == (jp.num_freqs, jp.IHS)
        for call, src in (("to_phase_wav", wav), ("to_phase_flac", flac)):
            a, b = os.path.join(d, "t.png"), os.path.join(d, "j.png")
            getattr(tp, call)(src, a)
            getattr(jp, call)(src, b)
            _check_pngs(a, b, hdr)
        # the WAV call's PNG decoded by both
        jp.to_phase_wav(wav, b)
        wa, wb = os.path.join(d, "t.wav"), os.path.join(d, "j.wav")
        rate_t = _phases(sr, **kw)[0].to_wav_png(b, wa)
        rate_j = _phases(sr, **kw)[1].to_wav_png(b, wb)
        assert rate_t == rate_j == sr
        _check_wavs(wa, wb)


def test_round_trip_correlation(tmp_path):
    """WAV -> PNG -> WAV through the port's drop-in keeps the signal."""
    sr = 48000
    t = np.arange(2 * sr) / sr
    audio = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(
        2 * np.pi * 1628 * t)
    wav, png, out = (str(tmp_path / n) for n in ("in.wav", "p.png", "o.wav"))
    tphase.save_wav(wav, audio, sr)
    for dq in (False, True):
        tphase.Phase(sample_rate=sr, device="cpu",
                     device_quantize=dq).to_phase_wav(wav, png)
        assert tphase.Phase(sample_rate=sr, device="cpu",
                            device_quantize=dq).to_wav_png(png, out) == sr
        rec = tphase.load_wav(out)
        n = min(len(rec), len(audio))
        assert np.corrcoef(audio[4096:n - 4096],
                           rec[4096:n - 4096])[0, 1] > 0.99


# -- the pypng shim -------------------------------------------------------------

@pytest.mark.parametrize("bitdepth", [8, 16])
@pytest.mark.parametrize("greyscale,alpha", [(True, False), (True, True),
                                             (False, False), (False, True)])
def test_pypng_writer_reader_equal(tmp_path, bitdepth, greyscale, alpha):
    ch = (1 if greyscale else 3) + (1 if alpha else 0)
    w, h = 7, 5
    rows = np.random.default_rng(ch + bitdepth).integers(
        0, 1 << bitdepth, size=(h, w * ch)).tolist()
    a, b = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    with open(a, "wb") as f:
        tpypng.Writer(w, h, bitdepth=bitdepth, greyscale=greyscale,
                      alpha=alpha).write(f, rows)
    with open(b, "wb") as f:
        jpypng.Writer(w, h, bitdepth=bitdepth, greyscale=greyscale,
                      alpha=alpha).write(f, rows)
    data = open(a, "rb").read()
    assert data == open(b, "rb").read()
    for kw in (dict(filename=a), dict(file=io.BytesIO(data)),
               dict(bytes=data)):
        tw, th, trows, tinfo = tpypng.Reader(**kw).read()
        jkw = dict(kw, file=io.BytesIO(data)) if "file" in kw else kw
        jw, jh, jrows, jinfo = jpypng.Reader(**jkw).read()
        assert (tw, th, tinfo) == (jw, jh, jinfo)
        trows, jrows = list(trows), list(jrows)
        assert len(trows) == len(jrows) == h
        for u, v in zip(trows, jrows):
            np.testing.assert_array_equal(u, v)


def test_pypng_writer_refuses_bad_input(tmp_path):
    with pytest.raises(ValueError):
        tpypng.Writer(4, 4, bitdepth=4)
    with pytest.raises(ValueError):
        tpypng.Writer(4, 2).write(io.BytesIO(), [[0] * 12])


# -- the module surface -----------------------------------------------------------

def _public(module):
    """Public functions and classes defined in ``module``."""
    return {n: v for n, v in vars(module).items()
            if not n.startswith("_") and callable(v)
            and getattr(v, "__module__", None) == module.__name__}


@pytest.mark.parametrize("pair", ["phase", "pypng", "package"])
def test_signatures_equal(pair):
    """Every public name has the JAX compat's signature; ``Phase.__init__``
    has ``device`` appended."""
    t_mod, j_mod = {"phase": (tphase, jphase), "pypng": (tpypng, jpypng),
                    "package": (tcompat, jcompat)}[pair]
    t_pub, j_pub = _public(t_mod), _public(j_mod)
    assert sorted(t_pub) == sorted(j_pub) and t_pub
    for name, obj in j_pub.items():
        tobj = t_pub[name]
        if inspect.isclass(obj):
            t_meth = {n for n in vars(tobj) if not n.startswith("_")}
            assert t_meth == {n for n in vars(obj) if not n.startswith("_")}
            for m in t_meth | {"__init__"}:
                ts = inspect.signature(getattr(tobj, m))
                js = inspect.signature(getattr(obj, m))
                if (name, m) == ("Phase", "__init__"):
                    params = list(ts.parameters.values())
                    assert params[-1].name == "device"
                    assert params[-1].default == "cuda"
                    ts = ts.replace(parameters=params[:-1])
                assert ts == js, (name, m)
        else:
            assert inspect.signature(tobj) == inspect.signature(obj), name


def test_install_imports_neither_jax_nor_gomel_tpu():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gomel_tpu'] = None\n"
        "import gomel_tpu_torch.compat as c\n"
        "c.install()\n"
        "from phase import Phase\n"
        "import png\n"
        "assert png is c.pypng and sys.modules['phase'] is c.phase\n"
        "assert Phase(sample_rate=48000, device='cpu').num_freqs == 768\n"
        "bad = [m for m in sys.modules if (m == 'jax' or m.startswith('jax.')"
        " or m == 'gomel_tpu' or m.startswith('gomel_tpu.'))"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr


def test_install_keeps_existing_modules():
    """``install`` registers with setdefault: a module already named
    ``phase`` or ``png`` stays."""
    saved = {k: sys.modules.get(k) for k in ("phase", "png")}
    try:
        for k in saved:
            sys.modules.pop(k, None)
        tcompat.install(register_pypng=False)
        assert sys.modules["phase"] is tphase and "png" not in sys.modules
        sys.modules["png"] = jpypng
        tcompat.install()
        assert sys.modules["png"] is jpypng
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
