"""The plain reference against the port's CPU path at tiny sizes: the frozen
host arithmetic equal, the float64 codecs within float32 rounding of the
port's float32 outputs."""
import numpy as np
import pytest
import torch

from gomel_tpu_torch.core import filterbank, framing
from gomel_tpu_torch.core.config import MelConfig, PhaseConfig
from gomel_tpu_torch.ops import prng
from gomel_tpu_torch.ops.stft import hann_window
from gomel_tpu_torch.parallel.batch import BatchedMel, BatchedPhase, row_keys
from portbench.harness import signals
from portbench.harness.manifest import Manifest
from portbench.reference import codecs, compare, dsp, threefry

MEL = Manifest().config("gomel-mel-cli")["codec"]
PHASE = Manifest().config("gomel-phase-cli")["codec"]
CPU = torch.device("cpu")


def test_config_files_are_the_cli_defaults():
    assert MelConfig(**MEL) == MelConfig.cli_default()
    assert PhaseConfig(**PHASE) == PhaseConfig.cli_default()


@pytest.mark.parametrize("bins,mels,fmax", [(2048, 192, 16000.0),
                                            (1024, 160, 8000.0)])
def test_filterbanks_equal_the_port(bins, mels, fmax):
    np.testing.assert_array_equal(
        dsp.mel_weights(bins, mels, 0.0, fmax),
        filterbank.mel_weights(bins, mels, 0.0, fmax))
    np.testing.assert_array_equal(
        dsp.inverse_mel_weights(bins, mels, 0.0, fmax),
        filterbank.inverse_mel_weights(bins, mels, 0.0, fmax))


def test_framing_and_window_equal_the_port():
    for n in [1, 5000, 19199, 19200, 19201, 480000, 721234]:
        assert dsp.pad_length(n, 1280) == framing.pad_length(n, 1280)
        length = dsp.pad_length(n, 1280)
        assert dsp.num_frames(length, 4096, 1280) == framing.num_frames(
            length, 4096, 1280)
    np.testing.assert_array_equal(dsp.hann(4096), hann_window(4096))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 9_000_000_001])
def test_threefry_equals_the_port(seed):
    keys = threefry.row_keys(seed, 5)
    np.testing.assert_array_equal(keys, row_keys(seed, 5))
    got = threefry.uniform(keys, 1001, CPU)
    want = prng.uniform_plain(keys, (1001,), torch.float32, CPU)
    assert torch.equal(got, want)


def _audio(seed, rows, n):
    return signals.audio(signals.generator(seed, CPU), rows, n, 48000, CPU)


def test_mel_encode_matches_the_port():
    x = _audio(3, 2, dsp.pad_length(30000, 1280))
    ref = codecs.mel_encode(x, MEL)
    got = BatchedMel(MelConfig(**MEL), device="cpu").encode(x)
    assert compare.logmel_gap(got, ref) < 1e-5
    got64 = BatchedMel(MelConfig(**MEL), dtype=torch.float64,
                       device="cpu").encode(x.double())
    assert compare.logmel_gap(got64, ref) < 1e-10


def test_mel_decode_matches_the_port():
    x = _audio(4, 2, dsp.pad_length(40000, 1280))
    planes, mx, mn = codecs.mel_quantize(codecs.mel_encode(x, MEL))
    mx, mn = mx.float().numpy(), mn.float().numpy()
    sig, pcm, fin = codecs.mel_decode(planes, mx, mn,
                                      threefry.row_keys(11, 2), MEL)
    got, got_fin = BatchedMel(MelConfig(**MEL), device="cpu").decode_quantized(
        planes, mx, mn, 11, pcm16=True)
    assert compare.pcm_gap_lsb(got, sig) < 1.0
    assert torch.equal(got_fin, fin)
    assert compare.pcm_gap_lsb(pcm, sig) <= 0.5


def test_phase_round_trip_matches_the_port():
    length = dsp.pad_length(30000, 1280)
    pcm = signals.pcm16(_audio(5, 2, length))
    frames = dsp.num_frames(length, 4096, 1280)
    ref_p, ref_mx, ref_mn = codecs.phase_encode(pcm, PHASE)
    codec = BatchedPhase(PhaseConfig(**PHASE), device="cpu")
    planes, mx, mn = codec.encode_quantized(pcm, np.full(2, frames))
    step, share = compare.plane_steps(planes, ref_p)
    assert step <= 1 and share < 2e-3
    assert compare.extrema_gap(mx, mn, ref_mx, ref_mn) < 1e-6
    sig, _, fin = codecs.phase_decode(planes, mx, mn, PHASE)
    out, out_fin = codec.decode_quantized(planes, mx.numpy(), mn.numpy(),
                                          pcm16=True)
    assert compare.pcm_gap_lsb(out, sig) < 1.0
    assert torch.equal(out_fin, fin)
