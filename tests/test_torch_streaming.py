"""The port's streaming pipelines (pipelines/streaming.py) on the CPU.

Every case of tests/test_streaming.py runs against the port's own ``Phase``
and ``Mel`` at that file's tolerances, and the port's ``StreamingPhase`` and
``StreamingMel`` run against the JAX package's on the same numpy inputs:
float64 within 1e-9; float32 encodes within 1e-5 of each frame's peak (the
mel energies for mel) and decodes within 2e-4 absolute / 2e-3 relative (the
float32 FFTs differ, as in tests/test_torch_phase.py). On CPU tensors each
chunk runs the kernels' plain versions; tests/test_torch_cuda.py and
chip_smoke.py run the kernels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gomel_tpu.core.config import MelConfig as JMelConfig
from gomel_tpu.core.config import PhaseConfig as JPhaseConfig
from gomel_tpu.pipelines import streaming as jstream
from gomel_tpu.pipelines.phase import Phase as JPhase
from gomel_tpu_torch import (Mel, MelConfig, Phase, PhaseConfig, StreamingMel,
                             StreamingPhase)
from gomel_tpu_torch.core.framing import pad_length

CFG = dict(num_freqs=96, window=64, resolut=256)
MEL = dict(num_mels=24, window=64, resolut=256)
DTYPES = [(torch.float64, jnp.float64), (torch.float32, jnp.float32)]


def _sig(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float64)


def _phase(chunk_frames, dtype=torch.float32, **over):
    return StreamingPhase(PhaseConfig(**{**CFG, **over}), chunk_frames, dtype,
                          device="cpu")


def _batch(dtype=torch.float32, **over):
    return Phase(PhaseConfig(**{**CFG, **over}), dtype=dtype, device="cpu")


def _jax_decode(pieces, chunk_frames, jdtype, **over):
    """The JAX package's stream decode of ``pieces``, as a list of blocks.
    Its float64 ``decode_iter`` adds the carry into the array it read back
    from the device, which numpy refuses when no copy was made (same dtype),
    so the float64 reference is the JAX package's whole-file
    ``Phase.decode`` of the concatenated spectrogram, which a stream equals
    for every length, cut at the block boundaries."""
    cfg = JPhaseConfig(**{**CFG, **over})
    if jdtype != jnp.float64:
        return list(jstream.StreamingPhase(cfg, chunk_frames, jdtype
                                           ).decode_iter(pieces))
    spec = np.concatenate([np.asarray(p).reshape(-1, cfg.num_freqs, 2)
                           for p in pieces])
    whole = np.asarray(JPhase(cfg, dtype=jdtype).decode(spec))
    full = spec.shape[0] // chunk_frames
    cuts = [i * chunk_frames * cfg.window for i in range(1, full + 1)]
    return np.split(whole, cuts)


def _frame_peak_close(got, want, tol):
    """|got - want| <= tol * each frame's peak |want|."""
    assert got.shape == want.shape
    peak = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    err = np.abs(got - want).reshape(want.shape[0], -1).max(axis=1)
    assert np.all(err <= tol * peak), float((err / peak).max())


# -- the cases of tests/test_streaming.py, against the port's own pipelines ----

@pytest.mark.parametrize("n", [5000, 12345, 64 * 15 - 1])
def test_streaming_encode_matches_batch(n):
    audio = _sig(n)
    want = _batch().encode(audio).numpy()
    got = _phase(16).encode(audio)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_streaming_encode_from_pieces():
    audio = _sig(20000, seed=1)
    s = _phase(32)
    pieces = np.array_split(audio, 7)
    got = np.concatenate(list(s.encode_iter(pieces)), axis=0)
    want = s.encode(audio)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("frames", [40, 97, 16])
def test_streaming_decode_matches_batch(frames):
    spec = np.random.default_rng(2).standard_normal((frames, 96, 2))
    want = _batch().decode(spec).numpy()
    got = _phase(16).decode(spec)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


def test_streaming_roundtrip_correlation():
    sr = 48000
    cfg = PhaseConfig(num_freqs=768, window=1280, resolut=4096)
    t = np.arange(pad_length(2 * sr, 1280)) / sr
    audio = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 2000 * t)
    s = StreamingPhase(cfg, chunk_frames=24, device="cpu")
    rec = s.decode(s.encode(audio))
    n = min(len(rec), len(audio))
    corr = np.corrcoef(audio[4096:n - 4096], rec[4096:n - 4096])[0, 1]
    assert corr > 0.999


def test_streaming_memory_is_bounded():
    # the streamer never holds more than about a chunk of samples
    s = _phase(8)
    total = 0
    for out in s.encode_iter(_sig(300) for _ in range(200)):
        assert out.shape[0] <= 8
        total += out.shape[0]
    padded = pad_length(300 * 200, 64)
    assert total == (padded - 256) // 64 + 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_streaming_mel_matches_batch(dtype):
    """float64 at the tolerance of tests/test_streaming.py. In float32 the
    CPU FFT library rounds a frame differently with the batch's size and
    alignment, about 1e-6 of the frame's peak, which is large in log on a
    quiet narrow band: there the mel energies are held within 1e-5 of each
    frame's peak, as tests/test_torch_mel.py holds the encode."""
    cfg = MelConfig(**MEL)
    audio = _sig(13000, seed=4)
    want = Mel(cfg, dtype=dtype, device="cpu").encode(audio).numpy()
    s = StreamingMel(cfg, chunk_frames=16, dtype=dtype, device="cpu")
    got = np.concatenate(list(s.encode_iter(np.array_split(audio, 5))), axis=0)
    assert got.shape == want.shape
    if dtype == torch.float64:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        _frame_peak_close(np.exp(got), np.exp(want), 1e-5)


def test_streaming_tail_larger_than_chunk_regression():
    # the reference padding can push the final tail past one chunk when
    # resolut % window != 0 (4096/1280), and short streams with tiny chunks
    # hit the same path
    s = StreamingPhase(PhaseConfig(num_freqs=768, window=1280, resolut=4096),
                       chunk_frames=512, device="cpu")
    out = s.encode(np.random.default_rng(0).standard_normal(658175))
    padded = pad_length(658175, 1280)
    assert out.shape[0] == (padded - 4096) // 1280 + 1

    out2 = _phase(4).encode(np.random.default_rng(1).standard_normal(100))
    want = _batch().encode(np.random.default_rng(1).standard_normal(100))
    assert out2.shape == tuple(want.shape)


@pytest.mark.parametrize("frames", [1, 2, 3, 4, 5])
def test_short_stream_threshold_boundary(frames):
    """Single-block streams shorter than K = ceil(resolut/hop) frames have a
    whole-signal window-sum maximum BELOW the periodic-interior maximum
    (1.0 / 1.2096 / 1.2097 for F = 1 / 2 / 3 against 1.2098 here), so they
    take the exact per-length threshold: equality with the whole-file
    decoder must hold for EVERY stream length, F < K included."""
    spec = np.random.default_rng(10 + frames).standard_normal((frames, 96, 2))
    want = _batch().decode(spec).numpy()
    got = _phase(16).decode(spec)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


def test_chunk_frames_below_k_rejected():
    """chunk_frames < K would let a multi-chunk stream normalise its first
    block with an interior threshold the short total stream never reaches;
    the constructor forbids the geometry instead."""
    with pytest.raises(ValueError, match="chunk_frames"):
        _phase(3)
    with pytest.raises(ValueError, match="chunk_frames"):
        _phase(0)
    with pytest.raises(ValueError, match="chunk_frames"):
        StreamingMel(MelConfig(**MEL), chunk_frames=0, device="cpu")
    assert _phase(4).chunk_frames == 4


def test_decode_iter_applies_volume_boost():
    spec = np.random.default_rng(3).standard_normal((40, 96, 2))
    s = _phase(16, volume_boost=2.0)
    via_iter = np.concatenate(list(s.decode_iter([spec])))
    want = _batch(volume_boost=2.0).decode(spec).numpy()
    np.testing.assert_allclose(via_iter, want, atol=5e-4, rtol=2e-3)
    plain = _phase(16).decode(spec)
    np.testing.assert_allclose(via_iter, 2.0 * plain, atol=1e-12)


# -- against the JAX package's streaming classes ---------------------------------

@pytest.mark.parametrize("dtype,jdtype", DTYPES)
@pytest.mark.parametrize("n,chunk_frames", [(12345, 16), (64 * 15 - 1, 16),
                                            (100, 4), (20000, 32)])
def test_streaming_phase_encode_vs_jax(dtype, jdtype, n, chunk_frames):
    audio = _sig(n, seed=5)
    want = jstream.StreamingPhase(JPhaseConfig(**CFG), chunk_frames,
                                  jdtype).encode(audio)
    got = _phase(chunk_frames, dtype).encode(audio)
    assert got.dtype == want.dtype
    if dtype == torch.float64:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    else:
        _frame_peak_close(got, want, 1e-5)


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_streaming_phase_pieces_vs_jax(dtype, jdtype):
    """The same ragged pieces (an empty one among them) give the same chunk
    boundaries and values; without the padding the tail frames drop."""
    audio = _sig(9000, seed=6)
    cuts = [0, 1, 700, 700, 4097, 8999, 9000]
    pieces = [audio[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    for pad in (True, False):
        want = list(jstream.StreamingPhase(JPhaseConfig(**CFG), 16, jdtype
                                           ).encode_iter(pieces, pad=pad))
        got = list(_phase(16, dtype).encode_iter(pieces, pad=pad))
        assert [g.shape for g in got] == [w.shape for w in want]
        tol = 1e-9 if dtype == torch.float64 else 1e-5
        _frame_peak_close(np.concatenate(got), np.concatenate(want), tol)
    whole = _phase(16, dtype).encode(audio)
    np.testing.assert_allclose(
        np.concatenate(list(_phase(16, dtype).encode_iter(pieces))), whole,
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
@pytest.mark.parametrize("frames", [1, 2, 3, 4, 5, 16, 40, 97])
def test_streaming_phase_decode_vs_jax(dtype, jdtype, frames):
    """F = 1..5 crosses the threshold boundary K = 4; 16 is one full block
    with an empty flush, 40 and 97 carry tails across blocks."""
    spec = np.random.default_rng(20 + frames).standard_normal((frames, 96, 2))
    want = np.concatenate(_jax_decode([spec], 16, jdtype))
    got = _phase(16, dtype).decode(spec)
    assert got.shape == want.shape and got.dtype == np.float64
    if dtype == torch.float64:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    else:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_streaming_phase_decode_pieces_and_boost_vs_jax(dtype, jdtype):
    """Spectrogram pieces of uneven sizes, one flattened to [F * nf, 2], with
    a volume boost: the same blocks as the JAX class emits."""
    spec = np.random.default_rng(7).standard_normal((53, 96, 2))
    pieces = [spec[:5], spec[5:30].reshape(-1, 2), spec[30:]]
    want = _jax_decode(pieces, 16, jdtype, volume_boost=1.5)
    got = list(_phase(16, dtype, volume_boost=1.5).decode_iter(pieces))
    assert [g.shape for g in got] == [w.shape for w in want]
    atol, rtol = (1e-9, 0) if dtype == torch.float64 else (3e-4, 2e-3)
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               atol=atol, rtol=rtol)
    assert list(_phase(16, dtype).decode_iter([])) == []


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_streaming_mel_vs_jax(dtype, jdtype):
    audio = _sig(13000, seed=8)
    pieces = np.array_split(audio, 5)
    want = np.concatenate(list(jstream.StreamingMel(
        JMelConfig(**MEL), 16, jdtype).encode_iter(pieces)), axis=0)
    s = StreamingMel(MelConfig(**MEL), 16, dtype, device="cpu")
    got = np.concatenate(list(s.encode_iter(pieces)), axis=0)
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == torch.float64:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    else:
        # two float32 FFTs differ by about 1e-6 of the peak, which is large
        # in log on quiet bands: the mel energies, within 1e-5 of each
        # frame's peak (tests/test_torch_mel.py)
        _frame_peak_close(np.exp(got), np.exp(want), 1e-5)
    np.testing.assert_allclose(s.encode(audio), got, rtol=0, atol=1e-6)


def test_thresholds_equal_the_jax_class():
    js = jstream.StreamingPhase(JPhaseConfig(**CFG), 16)
    ts = _phase(16)
    assert ts._threshold == js._threshold
    np.testing.assert_array_equal(ts._wsum_ext, js._wsum_ext)
    for f in (1, 2, 3, 4):
        np.testing.assert_array_equal(ts._np_window_sum(f),
                                      js._np_window_sum(f))
    with pytest.raises(ValueError, match="chunk_frames"):
        jstream.StreamingPhase(JPhaseConfig(**CFG), 3)


@pytest.mark.parametrize("cls,config", [(StreamingPhase, PhaseConfig(**CFG)),
                                        (StreamingMel, MelConfig(**MEL))])
def test_streaming_defaults_to_cuda_and_raises_without_a_card(monkeypatch, cls,
                                                              config):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda' is not available"):
        cls(config, 16)
    with pytest.raises(RuntimeError, match="is not available"):
        cls(config, 16, device="cuda:0")
    assert cls(config, 16, device="cpu").device == torch.device("cpu")


def test_streaming_classes_are_exported():
    import gomel_tpu
    import gomel_tpu_torch
    for name in ("StreamingPhase", "StreamingMel"):
        assert name in gomel_tpu.__all__ and name in gomel_tpu_torch.__all__
        assert getattr(gomel_tpu_torch, name).__module__ == \
            "gomel_tpu_torch.pipelines.streaming"
