"""The batched mel decode with fast Griffin-Lim against the benchmark's plain
float64 reference (portbench/reference/fastgl.py) at a tiny size on the CPU:
3 rows, n = 64, hop 16, 8 mels, 4 iterations, seeded uint8 planes and
extrema; with momentum 0.99 and with 0.0 (then also against
``codecs.mel_decode``, the plain Griffin-Lim reference)."""
import conftest  # noqa: F401  (forces CPU)

import numpy as np
import pytest
import torch

from gomel_tpu_torch.core.config import MelConfig
from gomel_tpu_torch.parallel.batch import BatchedMel
from portbench.reference import codecs, compare, dsp, fastgl, threefry

CFG = {"num_mels": 8, "mel_fmin": 0.0, "mel_fmax": 8000.0, "tune_mul": 1.0,
       "tune_add": 0.0, "window": 16, "resolut": 64, "y_reverse": True,
       "griffin_lim_iterations": 4, "volume_boost": 0.0, "sample_rate": 0}
ROWS, FRAMES = 3, 30
SEEDS = [0, 7, 2**31 + 5]

# Tolerances, from the float32 rounding of the port's CPU path (eps 6e-8 of
# signals some 6,000 PCM-16 steps in RMS), carried through 4 iterations,
# each momentum step scaling the last change by 1.99; measured over 60
# seeds at this size: float signal within 0.32 steps of PCM-16 (0.15
# without momentum) and an RMS gap of 8.4e-6 of the signal's RMS.
SIGNAL_GAP_LSB = 1.0
SIGNAL_RMS_REL = 5e-5
# int16 output: the exact value's rounding (0.5 step) plus the above
PCM_GAP_LSB = 1.0


def _planes(seed):
    rng = np.random.default_rng(seed)
    planes = torch.from_numpy(rng.integers(0, 256, (ROWS, 8, FRAMES, 2),
                                           dtype=np.uint8))
    mx = rng.uniform(0.5, 2.0, ROWS).astype(np.float32)
    mn = rng.uniform(-11.5, -6.0, ROWS).astype(np.float32)
    return planes, mx, mn


def _port(momentum, planes, mx, mn, seed, pcm16):
    codec = BatchedMel(MelConfig(**CFG), gl_momentum=momentum, device="cpu")
    return codec.decode_quantized(planes, mx, mn, seed, pcm16=pcm16)


@pytest.mark.parametrize("momentum", [0.99, 0.0])
@pytest.mark.parametrize("seed", SEEDS)
def test_port_matches_the_fast_griffin_lim_reference(seed, momentum):
    planes, mx, mn = _planes(seed)
    sig, pcm_ref, fin_ref = fastgl.mel_decode(
        planes, mx, mn, threefry.row_keys(seed, ROWS), CFG, momentum)
    assert sig.dtype == torch.float64
    assert sig.shape == (ROWS, dsp.out_length(FRAMES, 64, 16))
    got = _port(momentum, planes, mx, mn, seed, False)
    assert compare.signal_gap_lsb(got, sig) < SIGNAL_GAP_LSB
    assert compare.signal_rms_rel(got, sig) < SIGNAL_RMS_REL
    pcm, fin = _port(momentum, planes, mx, mn, seed, True)
    assert compare.pcm_gap_lsb(pcm, sig) < PCM_GAP_LSB
    assert torch.equal(fin, fin_ref) and bool(fin.all())
    assert compare.pcm_gap_lsb(pcm_ref, sig) <= 0.5


@pytest.mark.parametrize("seed", SEEDS)
def test_port_without_momentum_matches_the_plain_reference(seed):
    planes, mx, mn = _planes(seed)
    sig, _, fin_ref = codecs.mel_decode(planes, mx, mn,
                                        threefry.row_keys(seed, ROWS), CFG)
    pcm, fin = _port(0.0, planes, mx, mn, seed, True)
    assert compare.pcm_gap_lsb(pcm, sig) < PCM_GAP_LSB
    assert torch.equal(fin, fin_ref)


@pytest.mark.parametrize("iterations", [0, 1, 2, 4])
def test_reference_without_momentum_is_plain_griffin_lim(iterations):
    """m = 0 makes each step c = t: the same arithmetic, bit for bit."""
    planes, mx, mn = _planes(3)
    cfg = dict(CFG, griffin_lim_iterations=iterations)
    ar = codecs.Arith("f64")
    mag = fastgl.magnitudes(planes, mx, mn, cfg, ar)
    start = threefry.uniform(threefry.row_keys(3, ROWS),
                             dsp.out_length(FRAMES, 64, 16), planes.device)
    assert torch.equal(fastgl.fast_griffin_lim(mag, start, cfg, 0.0, ar),
                       codecs.griffin_lim(mag, start, cfg, ar))
    sig, _, _ = fastgl.mel_decode(planes, mx, mn, threefry.row_keys(3, ROWS),
                                  cfg, 0.0)
    assert torch.equal(sig, codecs.mel_decode(
        planes, mx, mn, threefry.row_keys(3, ROWS), cfg)[0])


def test_momentum_changes_the_result_and_bf16_fails():
    """The momentum step is not a no-op at this size, and the bf16 control
    lies far outside the tolerances above."""
    planes, mx, mn = _planes(11)
    keys = threefry.row_keys(11, ROWS)
    fast, _, _ = fastgl.mel_decode(planes, mx, mn, keys, CFG, 0.99)
    plain, _, _ = fastgl.mel_decode(planes, mx, mn, keys, CFG, 0.0)
    assert compare.signal_rms_rel(plain, fast) > 100 * SIGNAL_RMS_REL
    _, pcm_bf16, _ = fastgl.mel_decode(planes, mx, mn, keys, CFG, 0.99,
                                       "bf16")
    assert compare.pcm_gap_lsb(pcm_bf16, fast) > 100 * PCM_GAP_LSB
