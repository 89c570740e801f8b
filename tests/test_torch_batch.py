"""The batched path of the port (parallel/batch.py, cli/batch.py, FLAC ingest)
against the JAX package's, on the CPU.

Seeded numpy inputs go through gomel_tpu's BatchedMel / BatchedPhase, its
batch CLIs and its FLAC file paths, and through gomel_tpu_torch's, which run
the kernels' plain versions on CPU tensors. Griffin-Lim rows start from a
seed on both sides: the port draws the JAX package's samples itself,
``jax.random.uniform`` of ``split(PRNGKey(seed), n)[row]`` (the same key for
every n; ``parallel.batch.row_keys``, ops/prng.py). Tolerances are
stated at each comparison: the device quantizer truncates in float32 on both
sides, so a pixel may flip by one step, rarely; the Griffin-Lim decodes are
held to 2 LSB as tests/test_torch_meldecode.py holds ``towav``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gomel_tpu.cli import batch as jcli
from gomel_tpu.core.config import MelConfig as JMelConfig
from gomel_tpu.core.config import PhaseConfig as JPhaseConfig
from gomel_tpu.io import imagecodec as jimg
from gomel_tpu.parallel import batch as jbatch
from gomel_tpu.pipelines.mel import Mel as JMel
from gomel_tpu.pipelines.phase import Phase as JPhase
from gomel_tpu_torch.cli import batch as tcli
from gomel_tpu_torch.core.config import MelConfig, PhaseConfig
from gomel_tpu_torch.core.framing import frames_for_padded
from gomel_tpu_torch.io import audio as taudio
from gomel_tpu_torch.io import flac as tflac
from gomel_tpu_torch.io import wavcodec
from gomel_tpu_torch.io.pngcodec import read_png
from gomel_tpu_torch.ops import prng
from gomel_tpu_torch.parallel import batch as tbatch
from gomel_tpu_torch.pipelines.mel import Mel
from gomel_tpu_torch.pipelines.phase import Phase

MEL = dict(num_mels=24, window=256, resolut=1024, mel_fmax=8000.0)
PHASE = dict(num_freqs=96, window=256, resolut=1024)
MEL_CLI = ["--window", "256", "--resolut", "1024", "--num-mels", "32",
           "--fmax", "8000"]


def _steps(got, want):
    """(largest step, share of differing values) between integer arrays."""
    d = np.abs(np.asarray(got).astype(np.int64)
               - np.asarray(want).astype(np.int64))
    return int(d.max()), float((d > 0).mean())


def _near(got, want, step=1, rate=2e-3):
    assert np.shape(got) == np.shape(want)
    worst, share = _steps(got, want)
    assert worst <= step and share < rate, (worst, share)


def _utterances(lengths, seed, pcm=False):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        t = np.arange(n) / 16000.0
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(200, 3000) * t) \
            + 0.05 * rng.standard_normal(n)
        out.append(np.clip(np.rint(x * 32767), -32768, 32767).astype(np.int16)
                   if pcm else x.astype(np.float32))
    return out


def _frames(bucket, window, resolut):
    return np.asarray([frames_for_padded(int(n), window, resolut)
                       for n in bucket.lengths], np.int32)


# -- encode: the masked quantizers in the batch ------------------------------

@pytest.mark.parametrize("pcm", [False, True])
def test_batched_mel_encode_quantized_vs_jax_and_single(pcm):
    """Against the JAX package's BatchedMel (extrema rtol 1e-5, planes within
    1 step at < 2e-3, pad frames included), and each row, sliced to its
    frames, against the port's single-file encode with the same bounds."""
    utts = _utterances([3000, 7000, 9100, 6000, 1500], seed=1, pcm=pcm)
    jb = jbatch.BatchedMel(JMelConfig(**MEL))
    # the JAX package's float32 filterbank and window, carried across
    tb = tbatch.BatchedMel(mel=Mel.from_numpy(MelConfig(**MEL), jb._fwd,
                                              jb._window, device="cpu"))
    single = Mel(MelConfig(**MEL), device_quantize=True, device="cpu")
    for bucket in tbatch.make_buckets(utts, 256, max_batch=4,
                                      dtype=np.int16 if pcm else np.float32):
        frames = _frames(bucket, 256, 1024)
        kw = {}
        if pcm:   # WAV rows 1/32768 and mel-scaled FLAC rows 1/65536 mixed
            kw["scales"] = np.resize([32768.0, 65536.0],
                                     len(frames)).astype(np.float32)
        got = [t.numpy() for t in tb.encode_quantized(bucket.audio, frames,
                                                      **kw)]
        want = [np.asarray(t) for t in jb.encode_quantized(bucket.audio,
                                                           frames, **kw)]
        _near(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-5)
        for row, i in enumerate(bucket.indices):
            x = utts[i].astype(np.float32)
            if pcm:
                x = x / np.float32(kw["scales"][row])
            img, mx, mn = single.encode_quantized(x)
            f = int(frames[row])
            assert img.shape[1] == f
            _near(got[0][row][:, :f], img.numpy())
            np.testing.assert_allclose([got[1][row], got[2][row]],
                                       [float(mx), float(mn)], rtol=1e-5)


@pytest.mark.parametrize("pcm,ihs,hdr", [(False, False, False),
                                         (True, True, False),
                                         (False, True, False),
                                         (True, False, True)])
def test_batched_phase_encode_quantized_vs_jax_and_single(pcm, ihs, hdr):
    cfg = dict(PHASE, ihs=ihs, hdr=hdr)
    utts = _utterances([2500, 6000, 4000], seed=2, pcm=pcm)
    jb = jbatch.BatchedPhase(JPhaseConfig(**cfg))
    tb = tbatch.BatchedPhase(phase=Phase.from_numpy(PhaseConfig(**cfg),
                                                    jb._window, device="cpu"))
    single = Phase(PhaseConfig(**cfg), device_quantize=True, device="cpu")
    for bucket in tbatch.make_buckets(utts, 256, max_batch=4,
                                      dtype=np.int16 if pcm else np.float32):
        frames = _frames(bucket, 256, 1024)
        got = [t.numpy() for t in tb.encode_quantized(bucket.audio, frames)]
        want = [np.asarray(t) for t in jb.encode_quantized(bucket.audio,
                                                           frames)]
        assert got[0].dtype == want[0].dtype
        # the two packages' float32 FFTs round apart; a 16-bit step is 256
        # times finer than an 8-bit one, so HDR flips more often
        _near(got[0], want[0], *((2, 5e-3) if hdr else (1, 2e-3)))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-5)
        for row, i in enumerate(bucket.indices):
            x = utts[i].astype(np.float32)
            if pcm:
                x = x / np.float32(32768.0)
            img, mxs, mns = single.encode_quantized(x)
            f = int(frames[row])
            _near(got[0][row][:, :f], img.numpy())
            np.testing.assert_allclose(got[1][row], mxs.numpy(), rtol=1e-5)
            np.testing.assert_allclose(got[2][row], mns.numpy(), rtol=1e-5)


def test_batched_encode_vs_jax():
    """The float encodes (the --host-quantize CLI path): float32 within
    1e-5 of each row's peak."""
    utts = _utterances([3000, 4500], seed=3)
    bucket = tbatch.make_buckets(utts, 256, max_batch=4)[0]
    got = tbatch.BatchedMel(MelConfig(**MEL), device="cpu").encode(bucket.audio).numpy()
    want = np.asarray(jbatch.BatchedMel(JMelConfig(**MEL)).encode(
        bucket.audio))
    np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=0,
                               atol=1e-5 * float(np.exp(want).max()))
    got = tbatch.BatchedPhase(PhaseConfig(**PHASE), device="cpu").encode(bucket.audio)
    want = np.asarray(jbatch.BatchedPhase(JPhaseConfig(**PHASE)).encode(
        bucket.audio))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_encode_quantized_checks_rows():
    tb = tbatch.BatchedMel(MelConfig(**MEL), device="cpu")
    pcm = np.zeros((2, 2560), np.int16)
    with pytest.raises(ValueError):
        tb.encode_quantized(pcm, np.array([5, 5], np.int32))   # no scales
    with pytest.raises(ValueError):
        tb.encode_quantized(pcm, np.array([5], np.int32),
                            scales=np.array([32768.0, 32768.0]))
    with pytest.raises(ValueError):
        tb.encode_quantized(pcm, np.array([5, 5], np.int32),
                            scales=np.array([32768.0]))


# -- decode ----------------------------------------------------------------

def test_batched_phase_decode_quantized_vs_jax():
    """PCM-16 rows within 1 LSB at < 5e-2 differing, per-row finite flags
    equal, with one row made non-finite by NaN extrema."""
    utts = _utterances([6000, 6000, 6000], seed=4)
    xb = np.stack(utts)
    frames = np.full(3, frames_for_padded(6000, 256, 1024), np.int32)
    jb = jbatch.BatchedPhase(JPhaseConfig(**PHASE))
    img, mx, mn = (np.array(t) for t in jb.encode_quantized(xb, frames))
    mx[1] = np.nan
    tb = tbatch.BatchedPhase(PhaseConfig(**PHASE), device="cpu")
    pcm, ok = tb.decode_quantized(img, mx, mn, pcm16=True)
    j_pcm, j_ok = jb.decode_quantized(img, mx, mn, pcm16=True)
    assert ok.tolist() == np.asarray(j_ok).tolist() == [True, False, True]
    for row in (0, 2):
        _near(pcm[row].numpy(), np.asarray(j_pcm)[row], step=1, rate=5e-2)
    wave = tb.decode_quantized(img, mx, mn).numpy()
    j_wave = np.asarray(jb.decode_quantized(img, mx, mn))
    np.testing.assert_allclose(wave[[0, 2]], j_wave[[0, 2]], rtol=0,
                               atol=1e-5 * float(np.abs(j_wave[0]).max()))
    spec = jb.encode(xb)
    np.testing.assert_allclose(tb.decode(np.asarray(spec)).numpy(),
                               np.asarray(jb.decode(spec)), rtol=0,
                               atol=1e-5 * float(np.abs(j_wave[0]).max()))


@pytest.mark.parametrize("momentum,boost", [(0.0, 0.0), (0.99, 0.7)])
def test_batched_mel_decode_quantized_vs_jax(momentum, boost):
    """From the same seed, so the JAX package's per-row starts: PCM-16 within 2 LSB at < 5e-2
    differing, flags equal; float decode within 1e-4 relative L2."""
    cfg = dict(MEL, griffin_lim_iterations=3)
    utts = _utterances([5000] * 3, seed=5)
    xb = np.stack(utts)
    frames = np.full(3, frames_for_padded(5000, 256, 1024), np.int32)
    jb = jbatch.BatchedMel(JMelConfig(**cfg), gl_momentum=momentum)
    tb = tbatch.BatchedMel(gl_momentum=momentum, mel=Mel.from_numpy(
        MelConfig(**cfg), jb._fwd, jb._window, jb._inv, device="cpu"))
    img, mx, mn = (np.array(t) for t in jb.encode_quantized(xb, frames))
    pcm, ok = tb.decode_quantized(img, mx, mn, seed=7, boost=boost,
                                  pcm16=True)
    j_pcm, j_ok = jb.decode_quantized(img, mx, mn, seed=7, boost=boost,
                                      pcm16=True)
    assert ok.tolist() == np.asarray(j_ok).tolist() == [True] * 3
    _near(pcm.numpy(), j_pcm, step=2, rate=5e-2)
    logmel = np.asarray(jb.encode(xb))
    got = tb.decode(logmel, seed=3).numpy().astype(np.float64)
    want = np.asarray(jb.decode(logmel, seed=3), np.float64)
    rel = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
    assert rel.max() < 1e-4


def test_row_start_rule():
    """Row r's start depends on (seed, r) alone: the same for B = 1, 2 and 4,
    different across rows and seeds, and the JAX package's row keys."""
    for b in (1, 2, 4):
        np.testing.assert_array_equal(
            tbatch.row_keys(11, b),
            np.asarray(jax.random.split(jax.random.PRNGKey(11), b)))
    starts = {b: prng.uniform(tbatch.row_keys(11, b), (3000,), device="cpu")
              for b in (1, 2, 4)}
    for b in (2, 4):
        for r in range(min(b, 2)):
            assert torch.equal(starts[b][r], starts[2 if r else 1][r])
    assert torch.equal(starts[4][:2], starts[2])
    assert not torch.equal(starts[4][0], starts[4][1])
    assert not torch.equal(prng.uniform(tbatch.row_keys(12, 1), (3000,),
                                        device="cpu")[0], starts[1][0])
    # the decode draws them: row 0 decodes alike alone and in a batch of 4
    tb = tbatch.BatchedMel(MelConfig(**MEL), device="cpu")
    xb = np.stack(_utterances([4000] * 4, seed=6))
    frames = np.full(4, frames_for_padded(4000, 256, 1024), np.int32)
    img, mx, mn = (t.numpy() for t in tb.encode_quantized(xb, frames))
    four = tb.decode_quantized(img, mx, mn, seed=2, pcm16=True)[0]
    one = tb.decode_quantized(img[:1], mx[:1], mn[:1], seed=2,
                              pcm16=True)[0]
    _near(four[0].numpy(), one[0].numpy(), step=1, rate=1e-3)


@pytest.mark.parametrize("rows", [1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_mel_zero_iterations_is_the_jax_start(rows, dtype):
    """With 0 iterations a batched decode returns its rows' starts: the JAX
    package's for the same seed bit for bit, and row r the same whatever the
    batch size."""
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    cfg = dict(MEL, griffin_lim_iterations=0)
    jb = jbatch.BatchedMel(JMelConfig(**cfg), dtype=jd)
    tb = tbatch.BatchedMel(MelConfig(**cfg), dtype=dtype, device="cpu")
    logmel = np.random.default_rng(8).uniform(-11.0, 2.0, (rows, 7, 24, 2))
    want = np.asarray(jb.decode(logmel, seed=9))
    got = tb.decode(logmel, seed=9)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tb.decode(logmel[:1], seed=9).numpy()[0], want[0])
    if dtype == torch.float32:
        img = np.zeros((rows, 24, 7, 2), np.uint8)
        ext = np.ones(rows, np.float32)
        np.testing.assert_array_equal(
            tb.decode_quantized(img, ext, -ext, seed=9).numpy(),
            np.asarray(jb.decode_quantized(img, ext, -ext, seed=9)))


# -- the batch CLIs ---------------------------------------------------------

def _tone(n, sr, seed, stereo=False):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = 0.35 * np.sin(2 * np.pi * rng.uniform(200, 2000) * t) \
        + 0.03 * rng.standard_normal(n)
    if stereo:
        x = np.stack([x, 0.5 * x[::-1]], axis=1)
    return np.clip(np.rint(x * 32767), -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def mixed_dir(tmp_path_factory):
    """48 kHz WAVs (mono, stereo), 16-bit FLACs (mono, stereo) and two 16 kHz
    WAVs, all under 0.5 s."""
    d = tmp_path_factory.mktemp("mixed")
    wavcodec.write_wav(str(d / "a.wav"), _tone(19000, 48000, 1), 48000)
    wavcodec.write_wav(str(d / "b.wav"), _tone(9000, 48000, 2, True), 48000)
    tflac.write_flac(str(d / "c.flac"), _tone(15000, 48000, 3), 48000)
    tflac.write_flac(str(d / "d.flac"), _tone(7000, 48000, 4, True), 48000,
                     mode="fixed")
    wavcodec.write_wav(str(d / "e.wav"), _tone(5000, 16000, 5), 16000)
    wavcodec.write_wav(str(d / "f.wav"), _tone(3000, 16000, 6), 16000)
    return d


def _pngs_near(port_dir, jax_dir, names, mel):
    for name in names:
        a, b = read_png(str(port_dir / name)), read_png(str(jax_dir / name))
        assert a.shape == b.shape
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        d = np.minimum(d, 256 - d)   # the wrapped conjugate-hint channel
        assert d.max() <= 1 and (d > 0).mean() < 2e-3, name
        load = (lambda p: jimg.load_mel_image_raw(p, True)[1:]) if mel else \
            (lambda p: jimg.load_phase_image_raw(p, True)[1:])
        for x, y in zip(load(str(port_dir / name)), load(str(jax_dir / name))):
            np.testing.assert_array_equal(x, y)


def _wavs_near(port_dir, jax_dir, names, step):
    for name in names:
        a, sr_a = wavcodec.read_wav(str(port_dir / name))
        b, sr_b = wavcodec.read_wav(str(jax_dir / name))
        assert sr_a == sr_b and a.shape == b.shape
        _near(a, b, step=step, rate=5e-2)


def test_batch_tomel_and_towav_vs_jax(mixed_dir, tmp_path):
    """batch-tomel on mixed WAV and FLAC (per-row 1/32768 and 1/65536), then
    batch-towav on its PNGs, against the JAX CLIs."""
    names = sorted(os.listdir(mixed_dir))
    for tool, out in ((tcli.batch_tomel, "t"), (jcli.batch_tomel, "j")):
        extra = ["--device", "cpu"] if out == "t" else []
        assert tool([str(mixed_dir), "--out-dir", str(tmp_path / out),
                     "--max-batch", "2", *MEL_CLI, *extra]) == 0
    pngs = [n + ".png" for n in names]
    assert sorted(os.listdir(tmp_path / "t")) == pngs
    _pngs_near(tmp_path / "t", tmp_path / "j", pngs, mel=True)
    for tool, out in ((tcli.batch_towav, "tw"), (jcli.batch_towav, "jw")):
        extra = ["--device", "cpu"] if out == "tw" else []
        assert tool([str(tmp_path / "t"), "--out-dir", str(tmp_path / out),
                     "--seed", "4", "--max-batch", "2", *MEL_CLI,
                     *extra]) == 0
    wavs = [n + ".wav" for n in pngs]
    assert sorted(os.listdir(tmp_path / "tw")) == wavs
    _wavs_near(tmp_path / "tw", tmp_path / "jw", wavs, step=2)


def test_batch_tophase_and_fromphase_vs_jax(mixed_dir, tmp_path):
    """Two sample-rate families (48 kHz and 16 kHz, zero-stuffed on the
    host), WAV and FLAC; then batch-fromphase, within 1 LSB."""
    names = sorted(os.listdir(mixed_dir))
    for tool, out in ((tcli.batch_tophase, "t"), (jcli.batch_tophase, "j")):
        extra = ["--device", "cpu"] if out == "t" else []
        assert tool([str(mixed_dir), "--out-dir", str(tmp_path / out),
                     *extra]) == 0
    pngs = [n + ".png" for n in names]
    assert sorted(os.listdir(tmp_path / "t")) == pngs
    _pngs_near(tmp_path / "t", tmp_path / "j", pngs, mel=False)
    for tool, out in ((tcli.batch_fromphase, "tw"),
                      (jcli.batch_fromphase, "jw")):
        extra = ["--device", "cpu"] if out == "tw" else []
        assert tool([str(tmp_path / "t"), "--out-dir", str(tmp_path / out),
                     *extra]) == 0
    wavs = [n + ".wav" for n in pngs]
    assert sorted(os.listdir(tmp_path / "tw")) == wavs
    _wavs_near(tmp_path / "tw", tmp_path / "jw", wavs, step=1)


def test_batch_cli_process_shard_and_host_quantize(mixed_dir, tmp_path):
    """--process-shard 1 3 writes the same files as the JAX CLI's shard;
    --host-quantize writes the JAX package's host-quantized PNGs."""
    for tool, out in ((tcli.batch_tomel, "t"), (jcli.batch_tomel, "j")):
        extra = ["--device", "cpu"] if out == "t" else []
        assert tool([str(mixed_dir), "--out-dir", str(tmp_path / out),
                     "--process-shard", "1", "3", "--host-quantize",
                     *MEL_CLI, *extra]) == 0
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        n + ".png" for n in sorted(os.listdir(mixed_dir))[1::3]]
    _pngs_near(tmp_path / "t", tmp_path / "j", names, mel=True)
    assert tcli.batch_tomel([str(mixed_dir), "--process-shard", "5", "9",
                             "--device", "cpu", *MEL_CLI]) == 0   # empty
    with pytest.raises(SystemExit):
        tcli.batch_tomel([str(mixed_dir), "--process-shard", "3", "3",
                          "--device", "cpu"])


def test_batch_clis_without_cuda_exit_1(mixed_dir, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for tool in (tcli.batch_tomel, tcli.batch_tophase, tcli.batch_fromphase,
                 tcli.batch_towav):
        assert tool([str(mixed_dir), "--out-dir", str(tmp_path)]) == 1
        assert "not available" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_overlap_writes_in_order_and_flushes():
    """_Overlap writes call i when call i+1 is pushed, and the last one on
    flush (the partial-output guarantee); CPU tensors pass through."""
    written = []
    ov = tcli._Overlap()
    ov.push((torch.arange(3), torch.ones(2)), lambda a, b: written.append(
        ("first", a.tolist(), b.tolist())))
    assert written == []
    ov.push((torch.zeros(1),), lambda a: written.append(("second",
                                                         a.tolist())))
    assert written == [("first", [0, 1, 2], [1.0, 1.0])]
    ov.flush()
    ov.flush()
    assert written[-1] == ("second", [0.0]) and len(written) == 2


# -- FLAC through the single-file pipelines ---------------------------------

@pytest.mark.parametrize("device_quantize", [True, False])
def test_to_mel_flac_vs_jax(mixed_dir, tmp_path, device_quantize):
    """The mel 1/65536 FLAC scaling through KA (device quantize) or the host
    path: PNGs within 1 step at < 2e-3, metadata equal."""
    for name in ("c.flac", "d.flac"):
        t_png, j_png = tmp_path / ("t" + name), tmp_path / ("j" + name)
        Mel(MelConfig(**MEL), device_quantize=device_quantize, device="cpu").to_mel_flac(
            str(mixed_dir / name), str(t_png))
        JMel(JMelConfig(**MEL), device_quantize=device_quantize).to_mel_flac(
            str(mixed_dir / name), str(j_png))
        a, b = read_png(str(t_png)), read_png(str(j_png))
        _near(a, b)
        assert jimg.load_mel_image_raw(str(t_png), False)[1:] == \
            jimg.load_mel_image_raw(str(j_png), False)[1:]
    got = Mel(MelConfig(**MEL), device="cpu").to_tensor_flac(str(mixed_dir / "d.flac"))
    want = np.asarray(JMel(JMelConfig(**MEL)).to_tensor_flac(
        str(mixed_dir / "d.flac")))
    np.testing.assert_allclose(np.exp(got.numpy()), np.exp(want), rtol=0,
                               atol=1e-5 * float(np.exp(want).max()))


@pytest.mark.parametrize("name", ["c.flac", "d.flac"])
def test_to_phase_flac_vs_jax(mixed_dir, tmp_path, name):
    for dq in (True, False):
        t_png, j_png = tmp_path / f"t{dq}.png", tmp_path / f"j{dq}.png"
        Phase(sample_rate=48000, device_quantize=dq, device="cpu").to_phase_flac(
            str(mixed_dir / name), str(t_png))
        JPhase(sample_rate=48000, device_quantize=dq).to_phase_flac(
            str(mixed_dir / name), str(j_png))
        a, b = read_png(str(t_png)), read_png(str(j_png))
        assert a.shape == b.shape
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        d = np.minimum(d, 256 - d)
        assert d.max() <= 1 and (d > 0).mean() < 2e-3
    got = Phase(sample_rate=48000, device="cpu").to_tensor_flac(str(mixed_dir / name))
    want = JPhase(sample_rate=48000).to_tensor_flac(str(mixed_dir / name))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_flac_16k_phase_and_tomel_cli(tmp_path):
    """A 16 kHz FLAC through to_phase_flac (zero-stuffed by KA) against the
    JAX package, and through the port's tomel CLI."""
    from gomel_tpu_torch.cli.tools import tomel
    path = str(tmp_path / "s.flac")
    tflac.write_flac(path, _tone(6000, 16000, 9), 16000)
    Phase(device_quantize=True, device="cpu").to_phase_flac(path, str(tmp_path / "t.png"))
    JPhase(device_quantize=True).to_phase_flac(path, str(tmp_path / "j.png"))
    a, b = read_png(str(tmp_path / "t.png")), read_png(str(tmp_path / "j.png"))
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert np.minimum(d, 256 - d).max() <= 1
    assert tomel([path, "--device", "cpu", *MEL_CLI]) == 0
    assert os.path.exists(path + ".png")
    assert taudio.load_flac(path, scaling="mel")[0].max() <= 0.5
