"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The tests import
neither JAX nor gomel_tpu, so they also run where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Shapes are small and deliberately ragged (odd lengths, sizes that are not
multiples of the kernels' tiles, several FFT sizes); chip_smoke.py covers the
main path's full shapes.
"""
import math
import os

import numpy as np
import pytest
import torch

from gomel_tpu_torch.core.config import PAD_SHIFT_TABLE, MelConfig, PhaseConfig
from gomel_tpu_torch.core.filterbank import mel_weights
from gomel_tpu_torch.ops import (fftbackend, istft, mel_ops, phase_ops,
                                 quantize, rfft_mag)
from gomel_tpu_torch.ops.stft import frame_signal, hann_window
from gomel_tpu_torch.pipelines.mel import Mel
from gomel_tpu_torch.pipelines.phase import Phase

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _pcm(shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(-32768, 32768, size=shape, dtype=np.int16))


@pytest.mark.parametrize("shape,pad_to,scale", [
    ((1001,), 0, 32768.0), ((1001,), 4099, 32768.0), ((999, 2), 2000, 65536.0),
    ((5000, 2), 100, 32768.0)])
def test_pcm16_ingest_bit_exact(cuda, shape, pad_to, scale):
    pcm = _pcm(shape)
    before = quantize.INGEST_KERNEL.launches
    out = quantize.pcm16_ingest(pcm.to(cuda), torch.float32, scale, pad_to)
    assert quantize.INGEST_KERNEL.launches == before + 1
    ref = quantize.pcm16_ingest_plain(pcm, torch.float32, scale, pad_to)
    assert torch.equal(out.cpu(), ref)


def test_pcm16_ingest_batch_bit_exact(cuda):
    pcm = _pcm((3, 777), seed=1)
    out = quantize.pcm16_ingest_batch(pcm.to(cuda), torch.float32, 32768.0, 1280)
    ref = quantize.pcm16_ingest_plain(pcm, torch.float32, 32768.0, 1280,
                                      batched=True)
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("n,hop,lead,length,windowed", [
    (4096, 1280, (2,), 1280 * 20 + 4095, True),
    (4096, 1280, (), 30001, False),
    (512, 128, (3,), 5001, True),
    (64, 16, (1, 2), 333, True),
    (4, 1, (), 9, True),
    (16384, 4096, (), 16384 * 3 + 7, True),   # > 48 KB shared memory
    # mixed radix: n/2 = 1500 = 4 x 3 x 5^3, 127 (a prime: the generic
    # pass), 8000 = 4^3 x 5^3, 539 = 7^2 x 11, 6 = 2 x 3
    (3000, 750, (2,), 3000 + 750 * 7 + 3, True),
    (254, 64, (), 2001, True),
    (16000, 4000, (), 16000 * 2 + 5, False),
    (1078, 256, (), 5001, True),
    (12, 4, (3,), 101, True),
])
def test_stft_mag_vs_plain(cuda, n, hop, lead, length, windowed):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal(lead + (length,)).astype(np.float32))
    win = torch.from_numpy(hann_window(n).astype(np.float32)) if windowed else None
    out = rfft_mag.stft_mag(x.to(cuda), None if win is None else win.to(cuda),
                            n, hop)
    ref = rfft_mag.stft_mag_plain(x.double(), None if win is None
                                  else win.double(), n, hop)
    assert out.shape == ref.shape
    # float32 FFT against float64: 1e-5 of each frame's peak
    err = (out.cpu().double() - ref).abs()
    assert bool((err <= 1e-5 * ref.amax(dim=-1, keepdim=True)).all())


POW2_SIZES = [4 << i for i in range(13)]     # n = 4 ... 16384: the register core


def _peak_close(got, want, dims, tol=1e-5):
    err = (got.cpu().double() - want).abs()
    peak = want.abs().amax(dim=dims, keepdim=True)
    assert bool((err <= tol * peak).all()), float((err / peak).max())


@pytest.mark.parametrize("n", POW2_SIZES)
def test_fwd_core_every_pow2_size(cuda, n):
    """KB and KE run the register-resident core at every power-of-two n/2:
    3 rows whose frame count is no multiple of the frames a block, within
    1e-5 of each frame's peak of float64, one launch each."""
    plan = rfft_mag.fwd_plan(n)
    hop = max(1, n // 4)
    frames = 2 * plan.frames_per_block + 3
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal(
        (3, n + (frames - 1) * hop + 1)).astype(np.float32))
    win = torch.from_numpy(hann_window(n).astype(np.float32))
    assert (3 * frames) % plan.frames_per_block or plan.frames_per_block == 1
    before = (rfft_mag.KERNEL.launches, rfft_mag.PLANES_KERNEL.launches)
    mags = rfft_mag.stft_mag(x.to(cuda), win.to(cuda), n, hop)
    pairs = rfft_mag.stft_planes(x.to(cuda), win.to(cuda), n, hop, 1, n // 2)
    assert (rfft_mag.KERNEL.launches, rfft_mag.PLANES_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    _peak_close(mags, rfft_mag.stft_mag_plain(x.double(), win.double(), n,
                                              hop), (-1,))
    _peak_close(pairs, rfft_mag.stft_planes_plain(x.double(), win.double(), n,
                                                  hop, 1, n // 2), (-2, -1))


MIXED_SIZES = [6, 254, 400, 960, 1200, 2400, 3000, 4094, 6000, 12000]


def _kg_modes(rng, frames, n, nf):
    """KG's four sources for 3 rows of ``frames`` frames: (mode, source,
    extrema, max_val, IHS passes) and the float64 half-spectrum planes of
    each, as irfft_window_plain takes them."""
    m = n // 2
    re, im = (torch.from_numpy(rng.standard_normal(
        (3, frames, m + 1)).astype(np.float32)) for _ in range(2))
    spec = torch.from_numpy((rng.standard_normal((3, frames, nf, 2))
                             * 20).astype(np.float32))
    mx = torch.tensor([[3.0, 2.5], [1.0, 4.0], [2.0, 2.0]])
    mn = torch.tensor([[-2.0, -3.5], [-1.0, 0.5], [-1.0, -1.0]])
    out = [(istft.MODE_PLANES, re, (im,), 0.0, 0, (re.double(), im.double())),
           (istft.MODE_SPEC, spec, (), 0.0, 0,
            phase_ops.grow_half_planes(spec.double(), m))]
    for mode, dt, max_val, ihs in ((istft.MODE_QUANT8, np.uint8, 255, 0),
                                   (istft.MODE_QUANT16, np.uint16, 65535, 2)):
        planes = torch.from_numpy(rng.integers(0, max_val + 1,
                                               (3, nf, frames, 2), dtype=dt))
        deq = quantize.dequantize_planes_batch(planes, mx, mn, max_val, ihs)
        out.append((mode, planes, (mx, mn), float(max_val), ihs,
                    phase_ops.grow_half_planes(deq.double(), m)))
    return out


@pytest.mark.parametrize("n", MIXED_SIZES)
def test_mixed_core_sizes(cuda, n):
    """KB, KE, KG and KJ run the mixed-radix register core where n/2 is not
    a power of two (a prime m at 254, generic passes at 4094): 3 rows whose
    frame count is no multiple of the frames a block, one launch each; KB
    and KE (bins 1..nf with the window, 0..n/2 of framed input without)
    within 1e-5 of each frame's peak of float64 (the last row quiet); KG in
    its four source modes within 1e-5 of each frame's peak of float64, and
    with a real-frame count (blocks straddling rows) its masked frames exact
    zeros and the rest bit-equal to the unmasked launch; KJ within 1e-4
    relative L2 a frame; KB's and KE's scalar-load route (a base 4 bytes
    off 16) bit-equal to their vector route; a frame alone bit-equal to
    itself in the batch (KB, KE, KG, KJ)."""
    from gomel_tpu_torch.ops import griffinlim
    plan = rfft_mag.mixed_plan(n)
    hop = max(4, n // 16 * 4)
    frames = 2 * plan.frames_per_block + 3
    nf = max(1, n // 2 * 768 // 1000)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n + (frames - 1) * hop)).astype(np.float32)
    x[2] *= 1e-3
    x = torch.from_numpy(x)
    win = torch.from_numpy(hann_window(n).astype(np.float32))
    sig = torch.from_numpy(rng.random(x.shape).astype(np.float32))
    sig[0, :n] = 0.0
    mag = torch.from_numpy(
        (rng.random((3, frames, n // 2 + 1)) * 3).astype(np.float32))
    kinds = (rfft_mag.KERNEL, rfft_mag.PLANES_KERNEL,
             griffinlim.PROJECT_KERNEL)
    before = [k.launches for k in kinds]
    mags = rfft_mag.stft_mag(x.to(cuda), win.to(cuda), n, hop)
    pairs = rfft_mag.stft_planes(x.to(cuda), win.to(cuda), n, hop, 1, nf)
    proj = griffinlim.gl_project(sig.to(cuda), mag.to(cuda), win.to(cuda), n,
                                 hop)
    assert [k.launches - b for k, b in zip(kinds, before)] == [1, 1, 1]
    _peak_close(mags, rfft_mag.stft_mag_plain(x.double(), win.double(), n,
                                              hop), (-1,))
    full = rfft_mag.stft_planes_plain(x.double(), win.double(), n, hop, 0,
                                      n // 2 + 1)
    peak = full.abs().amax(dim=(-2, -1), keepdim=True)
    assert bool(((pairs.cpu().double() - full[..., 1:1 + nf, :]).abs()
                 <= 1e-5 * peak).all())
    laid = frame_signal(x, n, hop).contiguous()
    every = rfft_mag.stft_planes(laid.reshape(3, -1).to(cuda), None, n, n, 0,
                                 n // 2 + 1)
    _peak_close(every, rfft_mag.stft_planes_plain(
        laid.reshape(3, -1).double(), None, n, n, 0, n // 2 + 1), (-2, -1))
    ref = griffinlim.gl_project_plain(sig.double(), mag.double(),
                                      win.double(), n, hop)
    rel = (proj.cpu().double() - ref).norm(dim=-1) / ref.norm(dim=-1)
    assert float(rel.max()) <= 1e-4
    off = torch.cat([torch.zeros(1), x.reshape(-1)]).to(cuda)[1:]
    assert off.data_ptr() % 16 == 4
    assert torch.equal(rfft_mag.stft_mag(off.reshape(x.shape), win.to(cuda),
                                         n, hop), mags)
    assert torch.equal(rfft_mag.stft_planes(off.reshape(x.shape),
                                            win.to(cuda), n, hop, 1, nf),
                       pairs)
    one = x[1, hop:hop + n].contiguous().to(cuda)
    assert torch.equal(rfft_mag.stft_mag(one, win.to(cuda), n, hop)[0],
                       mags[1, 1])
    assert torch.equal(rfft_mag.stft_planes(one, win.to(cuda), n, hop, 1,
                                            nf)[0], pairs[1, 1])
    alone = griffinlim.gl_project(sig[2, 2 * hop:2 * hop + n].to(cuda),
                                  mag[2, 2:3].to(cuda), win.to(cuda), n, hop)
    assert torch.equal(alone[0], proj[2, 2])
    real = 1 if plan.frames_per_block > 1 else frames // 2
    for mode, src, aux, max_val, ihs, (re64, im64) in _kg_modes(
            rng, frames, n, nf):
        args = (mode, src.to(cuda), tuple(a.to(cuda) for a in aux), n,
                frames, nf, win.to(cuda), (3,), max_val, ihs)
        before = (istft.SYNTH_KERNEL.launches,
                  istft.SYNTH_MASKED_KERNEL.launches)
        out = istft.launch_irfft_window(*args)
        masked = istft.launch_irfft_window(*args, real_frames=real)
        assert (istft.SYNTH_KERNEL.launches - before[0],
                istft.SYNTH_MASKED_KERNEL.launches - before[1]) == (1, 1)
        want = istft.irfft_window_plain(re64, im64, n, None)
        peak_g = want.abs().amax(-1, keepdim=True)
        assert bool(((out.cpu().double() - want * win.double()).abs()
                     <= 1e-5 * peak_g).all()), mode
        assert torch.equal(masked[:, :real], out[:, :real])
        assert not masked[:, real:].any()
        if mode == istft.MODE_PLANES:
            lone = istft.irfft_window(src[2, 2:3].to(cuda),
                                      aux[0][2, 2:3].to(cuda), n,
                                      win.to(cuda))
            assert torch.equal(lone[0], out[2, 2])


@pytest.mark.parametrize("n", [486, 1458, 4374])
def test_mixed_core_plans_of_five_to_seven_passes(cuda, n):
    """Plans of 5, 6 and 7 passes (radices 8 bits a pass: 40 to 56 bits)
    reach all four kernels whole: KB, KE and KG within 1e-5 of each frame's
    peak of float64, KJ within 1e-4 relative L2 a frame."""
    from gomel_tpu_torch.ops import griffinlim
    plan = rfft_mag.mixed_plan(n)
    assert plan.code >= 1 << 32 and 5 <= len(plan.radices) <= 7
    hop, frames = n // 4, 2 * plan.frames_per_block + 1
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal(
        (2, n + (frames - 1) * hop)).astype(np.float32))
    win = torch.from_numpy(hann_window(n).astype(np.float32))
    xc, wc = x.to(cuda), win.to(cuda)
    _peak_close(rfft_mag.stft_mag(xc, wc, n, hop), rfft_mag.stft_mag_plain(
        x.double(), win.double(), n, hop), (-1,))
    _peak_close(rfft_mag.stft_planes(xc, wc, n, hop, 0, n // 2 + 1),
                rfft_mag.stft_planes_plain(x.double(), win.double(), n, hop,
                                           0, n // 2 + 1), (-2, -1))
    re, im = (torch.from_numpy(rng.standard_normal(
        (2, frames, n // 2 + 1)).astype(np.float32)) for _ in range(2))
    _peak_close(istft.irfft_window(re.to(cuda), im.to(cuda), n),
                istft.irfft_window_plain(re.double(), im.double(), n, None),
                (-1,))
    mag = torch.from_numpy((rng.random((2, frames, n // 2 + 1)) * 3)
                           .astype(np.float32))
    ref = griffinlim.gl_project_plain(x.double(), mag.double(), win.double(),
                                      n, hop)
    got = griffinlim.gl_project(xc, mag.to(cuda), wc, n, hop).cpu().double()
    assert float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max()) <= 1e-4


def test_mixed_core_refuses_a_wrong_plan(cuda):
    """A plan the kernels do not take (radices that do not multiply to n/2,
    threads that do not divide it, a block over 256 threads) launches
    nothing and raises, in KB, KE and KG alike: there is no fallback."""
    from gomel_tpu_torch.ops import _cuda
    n, hop = 3000, 750
    x = torch.randn((1, n + 4 * hop), device=cuda)
    out = torch.empty((1, 5, n // 2 + 1), device=cuda)
    pairs = torch.empty((1, 5, n // 2 + 1, 2), device=cuda)
    re = torch.randn((1, 5, n // 2 + 1), device=cuda)
    frames_w = torch.empty((1, 5, n), device=cuda)
    tw = rfft_mag._twiddles(n, cuda)
    tw_pass, code, threads, per_block = rfft_mag._fft_args(n, cuda)
    for bad in ((code + 1, threads, per_block), (code, threads + 1, per_block),
                (code, threads, 256 // threads + 1)):
        with pytest.raises(RuntimeError):
            _cuda.launch("gomel_stft_mag", cuda, x.data_ptr(), None,
                         tw.data_ptr(), tw_pass, out.data_ptr(), 1, 5,
                         x.shape[1], hop, n, *bad)
        with pytest.raises(RuntimeError):
            _cuda.launch("gomel_stft_planes", cuda, x.data_ptr(), None,
                         tw.data_ptr(), tw_pass, pairs.data_ptr(), 1, 5,
                         x.shape[1], hop, n, 0, n // 2 + 1, *bad)
        with pytest.raises(RuntimeError):
            _cuda.launch("gomel_irfft_window", cuda, istft.MODE_PLANES,
                         re.data_ptr(), re.data_ptr(), None, None,
                         tw.data_ptr(), tw_pass, frames_w.data_ptr(), 1, 5,
                         5, n // 2 + 1, n, 0.0, 0, *bad)


@pytest.mark.parametrize("n,hop,lead,extra", [
    (4096, 1279, (2,), 0),      # hop not a multiple of 4
    (4096, 1280, (2,), 3),      # row length not a multiple of 4
    (512, 130, (3,), 1), (64, 6, (), 2), (4, 3, (2,), 1)])
def test_fwd_core_scalar_route_equals_vector_route(cuda, n, hop, lead, extra):
    """Frames whose addresses rule out float4 loads (the scalar route) give
    the bits the float4 route gives for the same frames laid out one after
    another (hop = n), and so does a signal starting 4 bytes off 16."""
    rng = np.random.default_rng(n + hop)
    frames = 7
    x = torch.from_numpy(rng.standard_normal(
        lead + (n + (frames - 1) * hop + extra,)).astype(np.float32)).to(cuda)
    win = torch.from_numpy(hann_window(n).astype(np.float32)).to(cuda)
    laid = frame_signal(x, n, hop).contiguous().reshape(lead + (-1,))
    for scalar, vector in (
            (rfft_mag.stft_mag(x, win, n, hop),
             rfft_mag.stft_mag(laid, win, n, n)),
            (rfft_mag.stft_planes(x, win, n, hop, 0, n // 2 + 1),
             rfft_mag.stft_planes(laid, win, n, n, 0, n // 2 + 1))):
        assert scalar.shape == vector.shape
        assert torch.equal(scalar, vector)
    flat = torch.cat([torch.zeros(1, device=cuda), laid.reshape(-1)])[1:]
    assert flat.data_ptr() % 16 == 4
    assert torch.equal(rfft_mag.stft_mag(flat, win, n, n),
                       rfft_mag.stft_mag(laid.reshape(-1), win, n, n))


@pytest.mark.parametrize("n", [4, 16, 512, 4096])
def test_fwd_core_bin_ranges(cuda, n):
    """KE's first/count at bin 0, at the Nyquist bin and over every bin,
    against float64 (1e-5 of each frame's peak of the full spectrum)."""
    rng = np.random.default_rng(n)
    hop = max(1, n // 2)
    x = torch.from_numpy(rng.standard_normal((2, n + 9 * hop)).astype(
        np.float32))
    win = torch.from_numpy(hann_window(n).astype(np.float32))
    full = rfft_mag.stft_planes_plain(x.double(), win.double(), n, hop, 0,
                                      n // 2 + 1)
    peak = full.abs().amax(dim=(-2, -1), keepdim=True)
    for first, count in ((0, 1), (n // 2, 1), (0, n // 2 + 1),
                         (max(0, n // 2 - 2), min(3, n // 2 + 1))):
        got = rfft_mag.stft_planes(x.to(cuda), win.to(cuda), n, hop, first,
                                   count).cpu().double()
        want = full[..., first:first + count, :]
        assert got.shape == want.shape
        assert bool(((got - want).abs() <= 1e-5 * peak).all())
    nyq = rfft_mag.stft_planes(x.to(cuda), win.to(cuda), n, hop, n // 2, 1)
    assert not nyq[..., 0].any()             # Im of the Nyquist bin is 0


def test_fwd_core_frame_alone_equals_frame_in_batch(cuda):
    """A frame computed alone equals, bit for bit, the same frame inside
    the bench batch of 2 x 1122 = 2244 frames (KB and KE)."""
    n, hop, frames = 4096, 1280, 1122
    rng = np.random.default_rng(41)
    x = torch.from_numpy((rng.standard_normal((2, n + (frames - 1) * hop))
                          * 0.2).astype(np.float32)).to(cuda)
    win = torch.from_numpy(hann_window(n).astype(np.float32)).to(cuda)
    mags = rfft_mag.stft_mag(x, win, n, hop)
    pairs = rfft_mag.stft_planes(x, win, n, hop, 1, 1536)
    for b, f in ((0, 0), (1, 700), (1, frames - 1)):
        one = x[b, f * hop:f * hop + n].contiguous()
        assert torch.equal(rfft_mag.stft_mag(one, win, n, hop)[0], mags[b, f])
        assert torch.equal(rfft_mag.stft_planes(one, win, n, hop, 1, 1536)[0],
                           pairs[b, f])


# -- the inverse register core: KG and KJ at every power-of-two n ----------

@pytest.mark.parametrize("n", [4 << i for i in range(13)])
def test_inv_core_every_pow2_size(cuda, n):
    """KG (planes, with and without the window, real-frame counts 0, partial
    and all) and KJ run the register core's inverse at every power-of-two
    n/2, on 3 rows whose frame count is no multiple of the frames a block:
    KG within 1e-5 of each (unwindowed) frame's peak of float64, its masked
    frames exact zeros and the rest bit-equal to the unmasked launch; KJ
    within 1e-4 relative L2 a frame of float64; one launch each."""
    from gomel_tpu_torch.ops import griffinlim
    plan = rfft_mag.fwd_plan(n)
    frames = 2 * plan.frames_per_block + 3
    assert (3 * frames) % plan.frames_per_block or plan.frames_per_block == 1
    rng = np.random.default_rng(n + 1)
    re, im = (torch.from_numpy(rng.standard_normal(
        (3, frames, n // 2 + 1)).astype(np.float32)) for _ in range(2))
    win = torch.from_numpy(hann_window(n).astype(np.float32))
    ref = istft.irfft_window_plain(re.double(), im.double(), n, None)
    peak = ref.abs().amax(-1, keepdim=True)
    for w in (None, win):
        wc = None if w is None else w.to(cuda)
        before = istft.SYNTH_KERNEL.launches
        out = istft.irfft_window(re.to(cuda), im.to(cuda), n, wc)
        assert istft.SYNTH_KERNEL.launches == before + 1
        want = ref if w is None else ref * w.double()
        assert bool(((out.cpu().double() - want).abs() <= 1e-5 * peak).all())
        for real in (0, frames // 2, frames):
            before = istft.SYNTH_MASKED_KERNEL.launches
            got = istft.irfft_window(re.to(cuda), im.to(cuda), n, wc, real)
            assert istft.SYNTH_MASKED_KERNEL.launches == before + 1
            assert torch.equal(got[:, :real], out[:, :real])
            assert not got[:, real:].any()
    hop = max(1, n // 4)
    sig = torch.from_numpy(rng.random((3, n + (frames - 1) * hop))
                           .astype(np.float32))
    sig[0, :n] = 0.0                             # a silent frame: unit phase 1
    mag = torch.from_numpy((rng.random((3, frames, n // 2 + 1)) * 3)
                           .astype(np.float32))
    before = griffinlim.PROJECT_KERNEL.launches
    out = griffinlim.gl_project(sig.to(cuda), mag.to(cuda), win.to(cuda), n,
                                hop).cpu().double()
    assert griffinlim.PROJECT_KERNEL.launches == before + 1
    ref = griffinlim.gl_project_plain(sig.double(), mag.double(), win.double(),
                                      n, hop)
    rel = (out - ref).norm(dim=-1) / ref.norm(dim=-1)
    assert float(rel.max()) <= 1e-4, float(rel.max())


@pytest.mark.parametrize("n,frames", [(4096, 1122), (256, 37)])
def test_inv_core_frame_alone_equals_frame_in_batch(cuda, n, frames):
    """A frame computed alone equals, bit for bit, the same frame inside a
    batch of 2 rows (KG on planes, KJ), at the bench shape (one frame a
    block) and where a block holds several frames."""
    from gomel_tpu_torch.ops import griffinlim
    hop = n * 5 // 16
    rng = np.random.default_rng(n + 43)
    re, im = (torch.from_numpy(rng.standard_normal(
        (2, frames, n // 2 + 1)).astype(np.float32)).to(cuda)
        for _ in range(2))
    sig = torch.from_numpy((rng.standard_normal((2, n + (frames - 1) * hop))
                            * 0.2).astype(np.float32)).to(cuda)
    mag = torch.from_numpy((rng.random((2, frames, n // 2 + 1)) * 3)
                           .astype(np.float32)).to(cuda)
    win = torch.from_numpy(hann_window(n).astype(np.float32)).to(cuda)
    synth = istft.irfft_window(re, im, n, win)
    proj = griffinlim.gl_project(sig, mag, win, n, hop)
    for b, f in ((0, 0), (1, frames // 2 + 1), (1, frames - 1)):
        assert torch.equal(istft.irfft_window(re[b, f:f + 1], im[b, f:f + 1],
                                              n, win)[0], synth[b, f])
        one = sig[b, f * hop:f * hop + n]
        assert torch.equal(griffinlim.gl_project(one, mag[b, f:f + 1], win, n,
                                                 hop)[0], proj[b, f])


def test_fftbackend_rfft_mag_vs_torch_fft(cuda):
    x = torch.randn(5, 7, 2048, generator=torch.Generator().manual_seed(0))
    out = fftbackend.rfft_mag(x.to(cuda), 2048).cpu().double()
    ref = torch.fft.rfft(x.double(), dim=-1).abs()
    assert out.shape == ref.shape
    assert bool(((out - ref).abs() <= 1e-5 * ref.amax(-1, keepdim=True)).all())


def test_stft_mag_rejects_unsupported(cuda):
    """float64 is refused; n = 3000 (n/2 not a power of two) runs KB's
    mixed-radix register core, and n = 514 (2 x 257: no n1 * n2 split with both factors
    <= 128) goes by the xla route, each chosen by fftbackend.resolve and
    within 1e-5 of the frame peak of the CPU path."""
    x = torch.randn(10000, generator=torch.Generator().manual_seed(3))
    with pytest.raises(ValueError):
        rfft_mag.stft_mag(x.to(cuda).double(), None, 4096, 100)  # float64
    for n, moved in ((3000, (0, 1)), (514, (1, 0))):
        before = (fftbackend.XLA_ROUTE.launches, rfft_mag.KERNEL.launches)
        out = rfft_mag.stft_mag(x.to(cuda), None, n, 100).cpu().double()
        assert (fftbackend.XLA_ROUTE.launches - before[0],
                rfft_mag.KERNEL.launches - before[1]) == moved
        ref = rfft_mag.stft_mag_plain(x.double(), None, n, 100)
        assert out.shape == ref.shape
        assert bool(((out - ref).abs()
                     <= 1e-5 * ref.amax(-1, keepdim=True)).all())


@pytest.mark.parametrize("cfg", [MelConfig.cli_default(),
                                 MelConfig(num_mels=40, resolut=512, window=128),
                                 MelConfig(resolut=3000, window=750)])
def test_mel_log_vs_plain(cuda, cfg):
    rng = np.random.default_rng(1)
    mags = torch.from_numpy(
        (rng.standard_normal((2, 37, cfg.n_bins + 1)) ** 2 * 50).astype(np.float32))
    fwd = torch.tensor(mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin,
                                   cfg.mel_fmax), dtype=torch.float32)
    out = mel_ops._mel_from_mags(mags.to(cuda), fwd.to(cuda)).cpu()
    ref = mel_ops.mel_from_mags_plain(mags.double(), fwd.double())
    assert out.shape == ref.shape == (2, 37, cfg.num_mels, 2)
    live = ref > math.log(1e-4)
    assert float((out.double() - ref).abs()[live].max()) <= 1e-5


def _nan_frames(x, n, hop, frames):
    """x with NaNs in the samples of the given frames."""
    x = x.clone()
    for b, f in frames:
        x[b, f * hop + n // 3] = float("nan")
    return x


@pytest.mark.parametrize("n,hop,mels,length", [
    (4096, 1280, 192, 48000), (8192, 2048, 128, 40000), (512, 128, 40, 9001),
    (64, 16, 8, 1500), (16, 4, 4, 203), (16384, 4096, 64, 50000)])
def test_stft_mel_log_equals_kb_then_kc(cuda, n, hop, mels, length):
    """The fused launch is KB followed by KC bit for bit, NaN frames too,
    and mel_encode takes it (one fused launch, neither KB nor KC)."""
    rng = np.random.default_rng(40)
    x = torch.from_numpy(rng.standard_normal((3, length)).astype(np.float32))
    x = _nan_frames(x, n, hop, [(1, 0), (2, 3)]).to(cuda)
    win = torch.tensor(hann_window(n), dtype=torch.float32, device=cuda)
    fwd = torch.tensor(mel_weights(n // 2, mels, 0.0, 8000.0),
                       dtype=torch.float32, device=cuda)
    want = mel_ops._mel_from_mags(rfft_mag.stft_mag(x, win, n, hop), fwd)
    before = (mel_ops.FUSED_KERNEL.launches, mel_ops.KERNEL.launches,
              rfft_mag.KERNEL.launches)
    got = mel_ops.mel_encode(x, mels, n, hop, fwd, win)
    assert (mel_ops.FUSED_KERNEL.launches - before[0],
            mel_ops.KERNEL.launches - before[1],
            rfft_mag.KERNEL.launches - before[2]) == (1, 0, 0)
    assert got.shape == want.shape
    assert bool(got[1, 0].isnan().any()) and bool(got[2, 3].isnan().any())
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))
    ref = mel_ops.mel_from_mags_plain(
        rfft_mag.stft_mag_plain(x.double(), win.double(), n, hop),
        fwd.double())
    # against float64: the mel values within 1e-5 of their frame's peak
    e_got, e_ref = got.double().exp(), ref.exp()
    peak = e_ref.nan_to_num(0.0).amax(dim=(-2, -1), keepdim=True)
    ok = ((e_got - e_ref).abs() <= 1e-5 * peak) | ref.isnan()
    assert bool(ok.all())


def test_stft_mel_log_routes(cuda):
    """Where the fused launch does not run: the mixed radix (n = 3000) and
    the mm route go through KB's site and KC; the fused wrapper raises at
    an n it does not take, with no fallback."""
    rng = np.random.default_rng(41)
    x = torch.from_numpy(rng.standard_normal((2, 12000)).astype(np.float32))
    x = x.to(cuda)
    fwd = torch.tensor(mel_weights(1500, 80, 0.0, 8000.0),
                       dtype=torch.float32, device=cuda)
    before = (mel_ops.FUSED_KERNEL.launches, mel_ops.KERNEL.launches)
    got = mel_ops.mel_encode(x, 80, 3000, 750, fwd)
    assert (mel_ops.FUSED_KERNEL.launches - before[0],
            mel_ops.KERNEL.launches - before[1]) == (0, 1)
    win = torch.tensor(hann_window(3000), dtype=torch.float32, device=cuda)
    assert torch.equal(got, mel_ops._mel_from_mags(
        rfft_mag.stft_mag(x, win, 3000, 750), fwd))
    with pytest.raises(ValueError, match="power of two"):
        mel_ops.stft_mel_log(x, win, 3000, 750, fwd)
    fwd4 = torch.tensor(mel_weights(2048, 64, 0.0, 8000.0),
                        dtype=torch.float32, device=cuda)
    before = mel_ops.FUSED_KERNEL.launches
    mel_ops.mel_encode(x, 64, 4096, 1024, fwd4, fft_backend="mm")
    assert mel_ops.FUSED_KERNEL.launches == before


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 2049 + 5])
def test_mel_log_offset_views(cuda, offset):
    """KC on magnitudes that start at any 4-byte boundary (a view into a
    larger tensor) gives the bits of a contiguous copy, and a frame alone
    the bits of the batch."""
    cfg = MelConfig.cli_default()
    rng = np.random.default_rng(42)
    bins = cfg.n_bins + 1
    flat = torch.from_numpy((rng.standard_normal(offset + 37 * bins) ** 2 * 50)
                            .astype(np.float32)).to(cuda)
    mags = flat[offset:].reshape(37, bins)
    fwd = torch.tensor(mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin,
                                   cfg.mel_fmax), dtype=torch.float32,
                       device=cuda)
    out = mel_ops._mel_from_mags(mags, fwd)
    assert torch.equal(out, mel_ops._mel_from_mags(mags.clone(), fwd))
    assert torch.equal(out[5], mel_ops._mel_from_mags(mags[5:6], fwd)[0])


@pytest.mark.parametrize("shape", [(37, 45, 2), (1, 1, 2), (3, 70, 33, 2),
                                   (2, 1122, 192, 2), (4, 1122, 192, 2),
                                   (2, 131, 97, 2), (1, 4001, 192, 2)])
def test_quantize_mel_plane_bit_exact(cuda, shape):
    rng = np.random.default_rng(2)
    spec = torch.from_numpy((rng.standard_normal(shape) * 3 - 4).astype(np.float32))
    fn = quantize.quantize_mel_plane_batch if len(shape) == 4 \
        else quantize.quantize_mel_plane
    img, mx, mn = fn(spec.to(cuda))
    ref = quantize.quantize_mel_plane_plain(spec)
    assert torch.equal(img.cpu(), ref[0])
    assert torch.equal(mx.cpu(), ref[1]) and torch.equal(mn.cpu(), ref[2])


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("shape", [(2, 67, 192, 2), (3, 41, 37, 2),
                                   (1, 300, 193, 2)])
def test_quantize_mel_plane_offset_views(cuda, shape, offset):
    """KD on KF's passes from a base 4, 8 or 12 bytes past a 16-byte
    boundary (pass 1's head swaps the quads' channels at an odd offset;
    pass 2 takes float loads), at even and odd mel counts: bit-equal to the
    plain version, one launch a call."""
    spec = _spec(shape, 30 + offset)
    flat = torch.empty(spec.numel() + offset, device=cuda)
    flat[offset:].copy_(spec.reshape(-1).to(cuda))
    view = flat[offset:].view(shape)
    assert view.data_ptr() % 16 == 4 * offset
    before = quantize.QUANTIZE_KERNEL.launches
    got = quantize.quantize_mel_plane_batch(view)
    assert quantize.QUANTIZE_KERNEL.launches == before + 1
    ref = quantize.quantize_mel_plane_plain(spec)
    assert all(_equal(g, r) for g, r in zip(got, ref))


def test_quantize_mel_and_planes_share_tickets(cuda):
    """KD and KF on one stream share the per-row fold's tickets: calls of
    both in turn, masked and not, of other batch sizes, keep giving the
    plain versions' bits."""
    for seed, shape, frames in ((1, (4, 300, 64, 2), [300, 7, 0, 200]),
                                (2, (1, 2000, 192, 2), None),
                                (3, (6, 50, 33, 2), [50, 1, 2, 3, 49, 0]),
                                (4, (4, 300, 64, 2), None)):
        spec = _spec(shape, seed)
        tf = None if frames is None else torch.tensor(frames)
        for _ in range(2):
            got = quantize.quantize_mel_plane_batch(spec.to(cuda), 255,
                                                    frames)
            ref = quantize.quantize_mel_plane_plain(spec, 255, tf)
            assert all(_equal(g, r) for g, r in zip(got, ref))
            got = quantize.quantize_planes_batch(spec.to(cuda), 255, 0,
                                                 frames)
            ref = quantize.quantize_planes_plain(spec, 255, 0, tf)
            assert all(_equal(g, r) for g, r in zip(got, ref))


def test_quantize_mel_plane_degenerate_range(cuda):
    spec = torch.full((2, 9, 40, 2), -3.25)
    img, mx, mn = quantize.quantize_mel_plane_batch(spec.to(cuda))
    assert torch.equal(img.cpu(), torch.full((2, 40, 9, 2), 127, dtype=torch.uint8))
    assert mx.tolist() == mn.tolist() == [-3.25, -3.25]


def test_mel_encode_cuda_vs_cpu(cuda):
    rng = np.random.default_rng(3)
    x = 0.3 * rng.standard_normal(48000 * 2)
    cfg = MelConfig.cli_default()
    gpu = Mel(cfg, device=cuda).encode(x).cpu()
    cpu = Mel(cfg, dtype=torch.float64, device="cpu").encode(x)
    assert gpu.shape == cpu.shape
    # compare magnitudes: exp(log-mel) within 1e-5 of its peak
    e_gpu, e_cpu = gpu.double().exp(), cpu.exp()
    assert float((e_gpu - e_cpu).abs().max()) <= 1e-5 * float(e_cpu.max())


# -- phase codec kernels: KA's zero-stuff, KE, KF, KG, KH ---------------------

@pytest.mark.parametrize("sr", sorted(PAD_SHIFT_TABLE))
@pytest.mark.parametrize("shape", [(1001,), (999, 2)])
def test_pcm16_ingest_zero_stuff_bit_exact(cuda, sr, shape):
    zp, zs = PAD_SHIFT_TABLE[sr]
    pcm = _pcm(shape, seed=sr)
    before = (quantize.INGEST_KERNEL.launches,
              quantize.INGEST_ZERO_STUFF_KERNEL.launches)
    out = quantize.pcm16_ingest(pcm.to(cuda), torch.float32, 32768.0, 7001,
                                zp, zs)
    # the zero-stuff form's own tally counts the launch with KA's
    assert (quantize.INGEST_KERNEL.launches,
            quantize.INGEST_ZERO_STUFF_KERNEL.launches) == (
                before[0] + 1, before[1] + (zp > 0))
    ref = quantize.pcm16_ingest_plain(pcm, torch.float32, 32768.0, 7001,
                                      zp=zp, zs=zs)
    assert torch.equal(out.cpu(), ref)


def test_pcm16_ingest_batch_zero_stuff_bit_exact(cuda):
    pcm = _pcm((2, 1003), seed=5)
    out = quantize.pcm16_ingest_batch(pcm.to(cuda), torch.float32, 32768.0, 0,
                                      2, 1)
    ref = quantize.pcm16_ingest_plain(pcm, torch.float32, 32768.0, 0,
                                      batched=True, zp=2, zs=1)
    assert out.shape == ref.shape == (2, 1003 + 502)
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("n,hop,lead,first,count", [
    (4096, 1280, (2,), 1, 1536),     # the phase CLI width
    (4096, 1280, (), 1, 2048),       # up to the Nyquist bin
    (512, 128, (3,), 0, 257),        # every bin
    (64, 16, (1, 2), 5, 7),
])
def test_stft_planes_vs_plain(cuda, n, hop, lead, first, count):
    rng = np.random.default_rng(n + first)
    x = torch.from_numpy(rng.standard_normal(lead + (hop * 9 + n + 3,))
                         .astype(np.float32))
    win = torch.from_numpy(hann_window(n).astype(np.float32))
    before = rfft_mag.PLANES_KERNEL.launches
    out = rfft_mag.stft_planes(x.to(cuda), win.to(cuda), n, hop, first, count)
    assert rfft_mag.PLANES_KERNEL.launches == before + 1
    ref = rfft_mag.stft_planes_plain(x.double(), win.double(), n, hop, first,
                                     count)
    assert out.shape == ref.shape
    # float32 FFT against float64: 1e-5 of each frame's peak
    err = (out.cpu().double() - ref).abs()
    peak = ref.abs().amax(dim=(-2, -1), keepdim=True)
    assert bool((err <= 1e-5 * peak).all())


def test_fftbackend_planes_vs_torch_fft(cuda):
    x = torch.randn(3, 5, 1024, generator=torch.Generator().manual_seed(1))
    re, im = fftbackend.rfft_planes(x.to(cuda), 1024)
    ref = torch.fft.rfft(x.double(), dim=-1)
    peak = ref.abs().amax(-1, keepdim=True)
    assert bool(((re.cpu().double() - ref.real).abs() <= 1e-5 * peak).all())
    assert bool(((im.cpu().double() - ref.imag).abs() <= 1e-5 * peak).all())
    back = fftbackend.irfft_planes(ref.real.float().to(cuda),
                                   ref.imag.float().to(cuda), 1024).cpu()
    assert float((back.double() - x.double()).abs().max()) <= 1e-5 * float(
        x.abs().max())


@pytest.mark.parametrize("shape,max_val", [
    ((37, 45, 2), 255), ((2, 70, 33, 2), 255), ((3, 19, 65, 2), 65535),
    ((1, 1, 2), 255), ((2, 1122, 1536, 2), 255), ((2, 1122, 1536, 2), 65535),
    ((3, 131, 97, 2), 255), ((2, 129, 64, 2), 65535), ((1, 4001, 130, 2), 255)])
def test_quantize_planes_bit_exact(cuda, shape, max_val):
    rng = np.random.default_rng(3)
    spec = torch.from_numpy((rng.standard_normal(shape) * 40).astype(np.float32))
    fn = quantize.quantize_planes_batch if len(shape) == 4 \
        else quantize.quantize_planes
    before = quantize.PLANES_KERNEL.launches
    img, mx, mn = fn(spec.to(cuda), max_val, 0)
    assert quantize.PLANES_KERNEL.launches == before + 1
    ref = quantize.quantize_planes_plain(spec, max_val, 0)
    assert img.dtype == ref[0].dtype
    assert torch.equal(img.cpu(), ref[0])
    assert torch.equal(mx.cpu(), ref[1]) and torch.equal(mn.cpu(), ref[2])


@pytest.mark.parametrize("max_val", [255, 65535])
def test_quantize_planes_ihs_within_one_step(cuda, max_val):
    rng = np.random.default_rng(4)
    spec = torch.from_numpy((rng.standard_normal((2, 60, 96, 2)) * 300)
                            .astype(np.float32))
    img, mx, mn = quantize.quantize_planes_batch(spec.to(cuda), max_val, 2)
    ref = quantize.quantize_planes_plain(spec.to(cuda), max_val, 2)
    d = (img.int() - ref[0].int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 2e-3
    torch.testing.assert_close(mx, ref[1], rtol=2e-7, atol=0)
    torch.testing.assert_close(mn, ref[2], rtol=2e-7, atol=0)


@pytest.mark.parametrize("max_val", [255, 65535])
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("shape", [(2, 67, 96, 2), (3, 41, 37, 2)])
def test_quantize_planes_offset_views(cuda, shape, offset, max_val):
    """A base 4, 8 or 12 bytes past a 16-byte boundary (pass 1's head
    swaps the quads' channels at an odd offset; pass 2 takes float loads),
    even and odd nf, bit-equal to the plain version."""
    spec = _spec(shape, 20 + offset)
    flat = torch.empty(spec.numel() + offset, device=cuda)
    flat[offset:].copy_(spec.reshape(-1).to(cuda))
    view = flat[offset:].view(shape)
    assert view.data_ptr() % 16 == 4 * offset
    got = quantize.quantize_planes_batch(view, max_val, 0)
    ref = quantize.quantize_planes_plain(spec, max_val, 0)
    assert all(_equal(g, r) for g, r in zip(got, ref))


def test_quantize_planes_calls_in_turn(cuda):
    """The per-row fold's tickets return to 0 after every call: calls of
    other batch sizes, grids and masks in turn keep giving the plain
    version's bits."""
    for seed, shape, frames in ((1, (4, 300, 64, 2), [300, 7, 0, 200]),
                                (2, (1, 2000, 96, 2), None),
                                (3, (6, 50, 33, 2), [50, 1, 2, 3, 49, 0]),
                                (4, (4, 300, 64, 2), None)):
        spec = _spec(shape, seed)
        got = quantize.quantize_planes_batch(spec.to(cuda), 255, 0, frames)
        ref = quantize.quantize_planes_plain(
            spec, 255, 0, None if frames is None else torch.tensor(frames))
        assert all(_equal(g, r) for g, r in zip(got, ref))


def test_quantize_planes_degenerate_channel(cuda):
    spec = torch.zeros((5, 8, 2))
    spec[:, :, 1] = torch.linspace(0, 1, 40).reshape(5, 8)
    img, _, _ = quantize.quantize_planes(spec.to(cuda), 255)
    img = img.cpu()
    assert bool((img[:, :, 0] == 127).all())
    assert int(img[:, :, 1].min()) == 0 and int(img[:, :, 1].max()) == 255


# -- NaN, the masked batch forms of KD and KF, KA's per-row scales ------------

def _equal(got, want) -> bool:
    """Bit-equal, NaN equal to NaN."""
    got = got.cpu()
    if got.dtype.is_floating_point:
        return bool(torch.equal(torch.isnan(got), torch.isnan(want))
                    and torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0)))
    return torch.equal(got, want)


def test_quantize_nan_plane_matches_plain(cuda):
    """A NaN makes the row's (KF: the channel's) extrema NaN and its pixels
    127, as JAX's max does; fmaxf would have dropped it."""
    spec = _spec((6, 4, 2), 11)
    spec[2, 1, 0] = float("nan")
    img, mx, mn = quantize.quantize_mel_plane(spec.to(cuda))
    ref = quantize.quantize_mel_plane_plain(spec)
    assert _equal(img, ref[0]) and _equal(mx, ref[1]) and _equal(mn, ref[2])
    assert bool(torch.isnan(mx.cpu())) and bool((img.cpu() == 127).all())
    for max_val in (255, 65535):
        got = quantize.quantize_planes(spec.to(cuda), max_val)
        ref = quantize.quantize_planes_plain(spec, max_val)
        assert all(_equal(g, r) for g, r in zip(got, ref))
        assert bool(torch.isnan(got[1][0].cpu()))
        assert not bool(torch.isnan(got[1][1].cpu()))
        assert bool((got[0][..., 0].cpu() == max_val // 2).all())


_MASK_FRAMES = [23, 11, 0, 30]   # full, partial, none, beyond F


def _masked_spec(seed, bins):
    """[4, 23, bins, 2] with a NaN in a counted frame of row 3 and one in a
    pad frame of row 1."""
    spec = _spec((4, 23, bins, 2), seed)
    spec[3, 5, 1, 0] = float("nan")
    spec[1, 17, 2, 1] = float("nan")
    return spec


def test_quantize_mel_masked_matches_plain(cuda):
    spec = _masked_spec(12, 33)
    before = quantize.QUANTIZE_MASKED_KERNEL.launches
    got = quantize.quantize_mel_plane_batch(spec.to(cuda), frames=_MASK_FRAMES)
    assert quantize.QUANTIZE_MASKED_KERNEL.launches == before + 1
    ref = quantize.quantize_mel_plane_plain(spec, 255, torch.tensor(_MASK_FRAMES))
    assert all(_equal(g, r) for g, r in zip(got, ref))
    mx, mn = got[1].cpu(), got[2].cpu()
    assert (float(mx[2]), float(mn[2])) == (-3.4028234663852886e38,
                                            3.4028234663852886e38)
    assert bool((got[0][2].cpu() == 127).all())
    assert not bool(torch.isnan(mx[1])) and bool(torch.isnan(mx[3]))


@pytest.mark.parametrize("max_val,ihs", [(255, 0), (65535, 0), (255, 2),
                                         (65535, 2)])
def test_quantize_planes_masked_matches_plain(cuda, max_val, ihs):
    spec = _masked_spec(13, 65) * 10
    before = quantize.PLANES_MASKED_KERNEL.launches
    got = quantize.quantize_planes_batch(spec.to(cuda), max_val, ihs,
                                         frames=_MASK_FRAMES)
    assert quantize.PLANES_MASKED_KERNEL.launches == before + 1
    # the plain version on the card, so asinh comes from the same library
    ref = [t.cpu() for t in quantize.quantize_planes_plain(
        spec.to(cuda), max_val, ihs, torch.tensor(_MASK_FRAMES, device=cuda))]
    if ihs == 0:
        assert all(_equal(g, r) for g, r in zip(got, ref))
    else:
        d = (got[0].cpu().int() - ref[0].int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 2e-3
        assert torch.equal(torch.isnan(got[1].cpu()), torch.isnan(ref[1]))
    assert got[1].cpu()[2].tolist() == [-3.4028234663852886e38] * 2
    assert bool((got[0][2].cpu() == max_val // 2).all())


@pytest.mark.parametrize("bins,offset", [(64, 0), (64, 1), (65, 3), (1536, 0)])
def test_quantize_planes_masked_views(cuda, bins, offset):
    """Masked rows with counts 0, partial, full and past F, a NaN in a
    counted frame (row 3) and in a pad frame (row 1), on even and odd nf and
    a base off 16 bytes (a count that ends mid-quad)."""
    spec = _masked_spec(14, bins) * 10
    flat = torch.empty(spec.numel() + offset, device=cuda)
    flat[offset:].copy_(spec.reshape(-1).to(cuda))
    view = flat[offset:].view(spec.shape)
    for max_val in (255, 65535):
        got = quantize.quantize_planes_batch(view, max_val, 0,
                                             frames=_MASK_FRAMES)
        ref = quantize.quantize_planes_plain(spec, max_val, 0,
                                             torch.tensor(_MASK_FRAMES))
        assert all(_equal(g, r) for g, r in zip(got, ref))
        assert bool(torch.isnan(got[1][3].cpu())[0])
        assert not bool(torch.isnan(got[1][1].cpu()).any())


def test_pcm16_ingest_per_row_scales_bit_exact(cuda):
    pcm = _pcm((4, 1001), seed=7)
    scales = torch.tensor([32768.0, 65536.0, 65536.0, 32768.0])
    before = quantize.INGEST_ROWS_KERNEL.launches
    out = quantize.pcm16_ingest_batch(pcm.to(cuda), torch.float32, scales, 1280)
    assert quantize.INGEST_ROWS_KERNEL.launches == before + 1
    ref = quantize.pcm16_ingest_plain(pcm, torch.float32, scales, 1280,
                                      batched=True)
    assert torch.equal(out.cpu(), ref)
    # JAX multiplies by the float32 reciprocal: equal for powers of two
    recip = (1.0 / scales.double()).float()
    assert torch.equal(out.cpu()[:, :1001], pcm.float() * recip[:, None])


def _offset_pcm(pcm, offset, dev):
    """``pcm`` as a view ``offset`` int16 past the start of a card buffer
    (a base off 16 bytes unless offset is a multiple of 8)."""
    flat = torch.zeros(pcm.numel() + offset + 8, dtype=torch.int16, device=dev)
    view = flat[offset:offset + pcm.numel()].view(pcm.shape)
    view.copy_(pcm.to(dev))
    return view


@pytest.mark.parametrize("offset", [0, 1, 3, 4])
@pytest.mark.parametrize("mode", ["mono", "stereo", "per-row"]
                         + [f"zero-stuff {p}" for p in sorted(
                             {v for v in PAD_SHIFT_TABLE.values() if v[0]})])
@pytest.mark.parametrize("n", [1, 7, 8, 1001, 4099])
def test_pcm16_ingest_modes_odd_bit_exact(cuda, mode, n, offset):
    """KA in every mode at odd lengths, lengths under one slot, rows whose
    starts fall off 16 bytes and a base off 16 bytes (the scalar heads,
    tails and loads), padded and not, bit-equal to its plain version."""
    zp, zs = ((int(mode[12]), int(mode[15])) if mode.startswith("zero")
              else (0, 0))
    rows = 3 if mode == "per-row" or zp else 1
    shape = (n, 2) if mode == "stereo" else (rows, n)
    pcm = _pcm(shape, seed=n + offset)
    scales = torch.tensor([32768.0, 65536.0, 32768.0])
    scale = scales if mode == "per-row" else 65536.0
    src = _offset_pcm(pcm, offset, cuda)
    for pad in (0, 13):
        pad_to = (n + -(-n // zp) * zs if zp else n) + pad
        if mode == "stereo":
            out = quantize.pcm16_ingest(src, torch.float32, scale, pad_to)
            ref = quantize.pcm16_ingest_plain(pcm, torch.float32, scale,
                                              pad_to)
        else:
            out = quantize.pcm16_ingest_batch(src, torch.float32, scale,
                                              pad_to, zp, zs)
            ref = quantize.pcm16_ingest_plain(pcm, torch.float32, scale,
                                              pad_to, batched=True, zp=zp,
                                              zs=zs)
        assert torch.equal(out.cpu(), ref)


def test_pcm16_ingest_refuses_pairs_off_the_table(cuda):
    """KA's kernel is built for the pad-shift table's pairs only."""
    with pytest.raises(ValueError, match="PAD_SHIFT_TABLE"):
        quantize.pcm16_ingest(_pcm((100,)).to(cuda), torch.float32, 32768.0,
                              0, 3, 1)


@pytest.mark.parametrize("n,hop,rows,length,pad_to,scales,offset", [
    (4096, 1280, 2, 48000, 48640, [32768.0], 0),         # the CLI widths
    (4096, 1280, 4, 51200, 0, [32768.0, 65536.0, 32768.0, 65536.0], 0),
    (64, 16, 1, 1001, 1024, [65536.0], 0),                # L % hop != 0
    (64, 16, 1, 40, 64, [32768.0], 0),                    # L < n
    (256, 64, 3, 2002, 2100, [65536.0, 32768.0, 65536.0], 0),
    (256, 50, 2, 1999, 0, [32768.0], 0),                  # hop % 4: scalar
    (512, 128, 2, 9000, 0, [32768.0], 1),                 # base off 8 bytes
    (16384, 4096, 1, 50000, 53248, [65536.0], 0),         # > 48 KB shared
])
def test_stft_mel_log_pcm16_equals_ka_then_fused(cuda, n, hop, rows, length,
                                                 pad_to, scales, offset):
    """The fused launch's int16 mode is KA followed by the float launch bit
    for bit, with one launch of its own tally and none of KA's; a batch's
    empty (all-zero) row and per-row scales too."""
    pcm = _pcm((rows, length), seed=n + rows)
    if rows > 2:
        pcm[1] = 0
    sc = (torch.tensor(scales) if len(scales) > 1 else scales[0])
    src = _offset_pcm(pcm, offset, cuda)
    if rows == 1:
        src = src[0]
    win = torch.tensor(hann_window(n), dtype=torch.float32, device=cuda)
    fwd = torch.tensor(mel_weights(n // 2, 32, 0.0, 8000.0),
                       dtype=torch.float32, device=cuda)
    x = quantize.pcm16_ingest_batch(pcm.to(cuda), torch.float32, sc, pad_to)
    want = mel_ops.stft_mel_log(x if rows > 1 else x[0], win, n, hop, fwd)
    before = (mel_ops.FUSED_PCM16_KERNEL.launches,
              mel_ops.FUSED_KERNEL.launches,
              quantize.INGEST_KERNEL.launches,
              quantize.INGEST_ROWS_KERNEL.launches)
    got = mel_ops.stft_mel_log_pcm16(src, sc, pad_to, win, n, hop, fwd)
    assert (mel_ops.FUSED_PCM16_KERNEL.launches - before[0],
            mel_ops.FUSED_KERNEL.launches - before[1],
            quantize.INGEST_KERNEL.launches - before[2],
            quantize.INGEST_ROWS_KERNEL.launches - before[3]) == (1, 0, 0, 0)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    # against float64: the mel values within 1e-5 of their frame's peak
    x64 = quantize.pcm16_ingest_plain(pcm, torch.float64, sc, pad_to,
                                      batched=True)
    ref = mel_ops.mel_from_mags_plain(
        rfft_mag.stft_mag_plain(x64, win.cpu().double(), n, hop),
        fwd.cpu().double())
    ref = ref if rows > 1 else ref[0]
    e_got, e_ref = got.cpu().double().exp(), ref.exp()
    peak = e_ref.amax(dim=(-2, -1), keepdim=True)
    assert bool(((e_got - e_ref).abs() <= 1e-5 * peak).all())


def test_stft_mel_log_pcm16_raises_off_its_route(cuda):
    """The int16 mode takes n/2 a power of two and power-of-two scales on the
    card; otherwise it raises, with no fallback to KA."""
    pcm = _pcm((12000,)).to(cuda)
    fwd = torch.tensor(mel_weights(1500, 80, 0.0, 8000.0),
                       dtype=torch.float32, device=cuda)
    before = quantize.INGEST_KERNEL.launches
    with pytest.raises(ValueError, match="power of two"):
        mel_ops.stft_mel_log_pcm16(pcm, 32768.0, 0, None, 3000, 750, fwd)
    assert quantize.INGEST_KERNEL.launches == before
    # its one FMA a sample takes powers of two only, a table's too
    fwd4 = torch.tensor(mel_weights(2048, 64, 0.0, 8000.0),
                        dtype=torch.float32, device=cuda)
    rows = _pcm((2, 12000)).to(cuda)
    for scale in (3.0, [32768.0, 30000.0], torch.tensor([2.0 ** 101, 1.0],
                                                        device=cuda)):
        with pytest.raises(ValueError, match="powers of two"):
            mel_ops.stft_mel_log_pcm16(rows, scale, 0, None, 4096, 1024, fwd4)


def test_mel_file_encodes_take_the_int16_launch(cuda, tmp_path):
    """Mel.to_mel_wav with device quantize launches the int16 mode and no
    KA, and writes the bytes of KA followed by the float launch; at
    resolut 3000 (the mixed route) it keeps KA."""
    from gomel_tpu_torch.io import wavcodec
    from gomel_tpu_torch.io.pngcodec import read_png
    rng = np.random.default_rng(11)
    wav = str(tmp_path / "in.wav")
    wavcodec.write_wav(wav, rng.integers(-9000, 9000, 30001).astype(np.int16),
                       48000)
    cfg = MelConfig(num_mels=40, window=256, resolut=1024, mel_fmax=8000.0)
    m = Mel(cfg, device_quantize=True, device=cuda)
    before = (mel_ops.FUSED_PCM16_KERNEL.launches,
              quantize.INGEST_KERNEL.launches)
    m.to_mel_wav(wav, str(tmp_path / "new.png"))
    assert (mel_ops.FUSED_PCM16_KERNEL.launches - before[0],
            quantize.INGEST_KERNEL.launches - before[1]) == (1, 0)
    buf = wavcodec.read_wav(wav)[0]
    pcm = torch.from_numpy(buf.copy()).to(cuda)
    from gomel_tpu_torch.core.framing import pad_length
    x = quantize.pcm16_ingest(pcm, torch.float32, 32768.0,
                              pad_length(len(buf), cfg.window))
    m._save_quantized(str(tmp_path / "old.png"),
                      quantize.quantize_mel_plane(m._encode_padded(x), 255),
                      len(buf), 48000)
    with open(tmp_path / "new.png", "rb") as a, \
            open(tmp_path / "old.png", "rb") as b:
        assert a.read() == b.read()
    m3k = Mel(MelConfig(resolut=3000, window=750, num_mels=40),
              device_quantize=True, device=cuda)
    before = (mel_ops.FUSED_PCM16_KERNEL.launches,
              quantize.INGEST_KERNEL.launches)
    m3k.to_mel_wav(wav, str(tmp_path / "m3k.png"))
    assert (mel_ops.FUSED_PCM16_KERNEL.launches - before[0],
            quantize.INGEST_KERNEL.launches - before[1]) == (0, 1)
    assert read_png(str(tmp_path / "m3k.png")).size > 0


def test_batched_encode_quantized_cuda_vs_cpu(cuda):
    """BatchedMel and BatchedPhase on the card against the CPU path, int16
    rows with mixed scales and masked frames."""
    from gomel_tpu_torch.core.framing import frames_for_padded
    from gomel_tpu_torch.parallel.batch import BatchedMel, BatchedPhase
    rng = np.random.default_rng(8)
    lengths = [9000, 5000, 12000]
    pcm = np.zeros((3, 12800), np.int16)
    for r, n in enumerate(lengths):
        pcm[r, :n] = rng.integers(-8000, 8000, n)
    frames = np.asarray([frames_for_padded(n, 256, 1024) for n in lengths],
                        np.int32)
    scales = np.asarray([32768.0, 65536.0, 32768.0], np.float32)
    mcfg = MelConfig(num_mels=32, window=256, resolut=1024, mel_fmax=8000.0)
    got = BatchedMel(mcfg, device=cuda).encode_quantized(pcm, frames, scales)
    want = BatchedMel(mcfg, device="cpu").encode_quantized(pcm, frames, scales)
    d = (got[0].cpu().int() - want[0].int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 2e-3
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=0)
    pcfg = PhaseConfig(num_freqs=200, window=256, resolut=1024)
    got = BatchedPhase(pcfg, device=cuda).encode_quantized(pcm, frames)
    want = BatchedPhase(pcfg, device="cpu").encode_quantized(pcm, frames)
    d = (got[0].cpu().int() - want[0].int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 2e-3
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=0)


def _spec(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 20).astype(np.float32))


@pytest.mark.parametrize("n,nf,lead,frames", [
    (4096, 1536, (), 23), (4096, 2048, (2,), 9), (512, 100, (3,), 17),
    (16384, 8192, (), 3)])
def test_irfft_window_spec_vs_plain(cuda, n, nf, lead, frames):
    spec = _spec(lead + (frames, nf, 2), n + nf)
    win = torch.from_numpy(hann_window(n).astype(np.float32))
    before = istft.SYNTH_KERNEL.launches
    out = istft.launch_irfft_window(istft.MODE_SPEC, spec.to(cuda), (), n,
                                    frames, nf, win.to(cuda), lead).cpu()
    assert istft.SYNTH_KERNEL.launches == before + 1
    re, im = phase_ops.grow_half_planes(spec.double(), n // 2)
    ref = istft.irfft_window_plain(re, im, n, win.double())
    peak = ref.abs().amax(-1, keepdim=True)
    assert bool(((out.double() - ref).abs() <= 1e-5 * peak).all())


def test_irfft_window_ignores_dc_nyquist_imag(cuda):
    rng = np.random.default_rng(6)
    re = torch.from_numpy(rng.standard_normal((4, 257)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((4, 257)).astype(np.float32))
    out = istft.irfft_window(re.to(cuda), im.to(cuda), 512).cpu().double()
    ref = torch.fft.irfft(torch.complex(re.double(), im.double()), n=512)
    im0 = im.clone()
    im0[:, 0] = 0
    im0[:, -1] = 0
    assert torch.equal(out, istft.irfft_window(
        re.to(cuda), im0.to(cuda), 512).cpu().double())
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("hdr,ihs", [(False, 0), (False, 2), (True, 0)])
def test_dequantize_decode_vs_plain(cuda, hdr, ihs):
    max_val = 65535 if hdr else 255
    rng = np.random.default_rng(7)
    planes = torch.from_numpy(rng.integers(
        0, max_val + 1, size=(2, 300, 40, 2)).astype(np.uint16 if hdr else np.uint8))
    maxs = torch.tensor([[3.0, 2.5], [1.0, 4.0]])
    mins = torch.tensor([[-2.0, -3.5], [-1.0, 0.5]])
    win = torch.from_numpy(hann_window(1024).astype(np.float32))
    out = phase_ops.dequantize_decode(planes.to(cuda), maxs.to(cuda),
                                      mins.to(cuda), max_val, ihs, 1024, 320,
                                      0.0, win.to(cuda)).cpu().double()
    ref = phase_ops.dequantize_decode_plain(planes, maxs, mins, max_val, ihs,
                                            1024, 320, 0.0, win).double()
    assert out.shape == ref.shape == (2, 1024 + 39 * 320)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("n,hop,frames,boost", [
    (4096, 1280, 40, 0.0), (4096, 1280, 2, 0.0), (4096, 1280, 4, 1.5),
    (1024, 1024, 5, 0.0), (1000, 300, 13, -2.0),
    # the shapes of tests/test_torch_ola_plan.py: one frame, the short
    # window-sum form, n < hop, hop not a multiple of 4 and n % 4 == 2
    # (scalar path), hop 1 (32 hop-rows a block), hop 4 with 64 taps
    (4096, 1280, 1, 0.0), (64, 16, 3, -2.0), (256, 320, 6, 0.0),
    (4096, 1279, 9, 0.0), (514, 128, 20, 0.0), (6, 1, 9, 0.5),
    (256, 4, 70, 0.0)])
def test_overlap_normalize_bit_exact(cuda, n, hop, frames, boost):
    """KH against its plain versions bit for bit, on the vector path
    (n and hop multiples of 4) and the scalar path."""
    rng = np.random.default_rng(n + frames)
    fw = torch.from_numpy((rng.standard_normal((2, frames, n)) * 0.3)
                          .astype(np.float32)).to(cuda)
    win = torch.from_numpy(hann_window(n).astype(np.float32)).to(cuda)
    before = istft.OLA_KERNEL.launches
    out = istft.overlap_normalize(fw, hop, win, boost)
    pcm, finite = istft.overlap_normalize(fw, hop, win, boost, pcm16=True)
    assert istft.OLA_KERNEL.launches == before + 2
    ref = istft.overlap_normalize_plain(fw, hop, win, boost)
    ref_pcm, ref_finite = istft.overlap_normalize_plain(fw, hop, win, boost,
                                                        pcm16=True)
    assert torch.equal(out, ref)
    assert torch.equal(pcm, ref_pcm) and torch.equal(finite, ref_finite)
    assert torch.equal(istft.overlap_add(fw, hop),
                       istft.overlap_add_plain(fw, hop))


def test_overlap_normalize_finite_flag(cuda):
    fw = torch.zeros((3, 6, 512), device=cuda)
    fw[1, 2, 100] = float("nan")
    fw[2, 0, 7] = float("inf")
    win = torch.from_numpy(hann_window(512).astype(np.float32)).to(cuda)
    pcm, finite = istft.overlap_normalize(fw, 128, win, pcm16=True)
    assert finite.tolist() == [True, False, False]
    _, ref_finite = istft.overlap_normalize_plain(fw, 128, win, pcm16=True)
    assert torch.equal(finite, ref_finite)


@pytest.mark.parametrize("ihs,hdr", [(False, False), (True, False), (False, True)])
def test_phase_roundtrip_cuda_vs_cpu(cuda, ihs, hdr):
    rng = np.random.default_rng(8)
    t = np.arange(48000) / 48000
    x = 0.3 * np.sin(2 * np.pi * 330 * t) + 0.02 * rng.standard_normal(t.shape)
    cfg = PhaseConfig.cli_default(ihs=ihs, hdr=hdr)
    gpu, cpu = Phase(cfg, device=cuda), Phase(cfg, device="cpu")
    img_g, mx_g, mn_g = gpu.encode_quantized(x)
    img_c, mx_c, mn_c = cpu.encode_quantized(x)
    d = (img_g.cpu().int() - img_c.int()).abs()
    assert int(d.max()) <= (2 if hdr else 1)
    assert float((d > 0).float().mean()) < 2e-3
    pcm_g, ok_g = gpu.decode_quantized_pcm16(img_c, mx_c, mn_c)
    pcm_c, ok_c = cpu.decode_quantized_pcm16(img_c, mx_c, mn_c)
    assert bool(ok_g) and bool(ok_c)
    lsb = (pcm_g.cpu().int() - pcm_c.int()).abs()
    assert int(lsb.max()) <= 1 and float((lsb > 0).float().mean()) < 5e-2
    sig_g = gpu.decode(cpu.encode(x)).cpu().double()
    sig_c = cpu.decode(cpu.encode(x)).double()
    assert float((sig_g - sig_c).abs().max()) <= 1e-5 * float(sig_c.abs().max())


# -- mel decode kernels: KI, KJ, KK ----------------------------------------------

def _inv(cfg):
    from gomel_tpu_torch.core.filterbank import inverse_mel_weights
    return torch.tensor(inverse_mel_weights(cfg.n_bins, cfg.num_mels,
                                            cfg.mel_fmin, cfg.mel_fmax),
                        dtype=torch.float32)


@pytest.mark.parametrize("cfg,quantized,tune", [
    (MelConfig.cli_default(), True, (1.0, 0.0)),
    (MelConfig.cli_default(), False, (1.0, 0.0)),
    (MelConfig(num_mels=40, resolut=512, window=128, tune_mul=1.5,
               tune_add=0.25), False, (1.5, 0.25)),
    (MelConfig(num_mels=40, resolut=512, window=128), True, (1.0, 0.0))])
def test_mel_to_magnitudes_vs_plain(cuda, cfg, quantized, tune):
    rng = np.random.default_rng(cfg.num_mels)
    inv = _inv(cfg)
    if quantized:
        src = torch.from_numpy(rng.integers(0, 256, size=(2, cfg.num_mels, 37, 2),
                                            dtype=np.uint8))
        ext = dict(mgc_max=torch.tensor([2.5, 0.75]),
                   mgc_min=torch.tensor([-11.0, -9.5]), boost=1.5)
    else:
        src = torch.from_numpy(rng.uniform(-11.5, 3.0, size=(2, 37, cfg.num_mels, 2))
                               .astype(np.float32))
        ext = {}
    before = mel_ops.MAG_KERNEL.launches
    out = mel_ops.mel_to_magnitudes(
        src.to(cuda), inv.to(cuda), *tune,
        **{k: (v.to(cuda) if isinstance(v, torch.Tensor) else v)
           for k, v in ext.items()}).cpu()
    assert mel_ops.MAG_KERNEL.launches == before + 1
    ref = mel_ops.mel_to_magnitudes_plain(src, inv, *tune, **ext)
    assert out.shape == ref.shape == (2, 37, cfg.n_bins + 1)
    # float32 exp and products in another order: 1e-5 of each frame's peak
    peak = ref.amax(dim=-1, keepdim=True)
    assert bool(((out - ref).abs() <= 1e-5 * peak).all())


@pytest.fixture(scope="module")
def earlier_ki():
    """The earlier KI (tools/quant_earlier.cu), built for these tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from gomel_tpu_torch.ops import _cuda
    from tools import profile_quant
    return profile_quant.earlier(profile_quant.start_earlier(
        os.path.join(_cuda.BUILD_DIR, "test_earlier")))


@pytest.mark.parametrize("cfg,frames,tune,boost", [
    (MelConfig.cli_default(), 1122, (1.0, 0.0), 0.0),
    (MelConfig.cli_default(), 37, (1.5, 0.25), 1.5),
    (MelConfig.cli_default(), 1, (1.0, 0.0), -0.5),
    (MelConfig.cli_default(), 5, (1.0, 0.0), 0.0),
    (MelConfig(resolut=3000, window=750), 61, (1.0, 0.0), 0.0),
    (MelConfig(resolut=3000, window=750), 9, (0.75, -0.5), 2.0),
    (MelConfig(num_mels=40, resolut=512, window=128), 23, (1.0, 0.0), 0.0),
    (MelConfig(num_mels=512), 13, (1.0, 0.0), 0.5),
    (MelConfig(num_mels=128, resolut=16384, window=4096), 10, (1.0, 0.0), 0.0)])
@pytest.mark.parametrize("quantized", [True, False])
def test_mel_to_magnitudes_equals_earlier(cuda, earlier_ki, cfg, frames, tune,
                                          boost, quantized):
    """The frame-run KI bit-equal to the block-a-frame form it replaced,
    and within 1e-5 of each frame's peak of the plain version: CLI widths,
    resolut 3000 (1500 bins, 160 mels), 3 taps a bin (512 mels), 8192 bins
    (several sweeps), runs cut short (F not a multiple of the run, F = 1,
    F below one run), tune and boost."""
    from tools.profile_quant import old_mel_to_magnitudes
    rng = np.random.default_rng(frames + cfg.num_mels)
    inv = _inv(cfg).to(cuda)
    if quantized:
        src = torch.from_numpy(rng.integers(0, 256, (2, cfg.num_mels, frames,
                                                     2), dtype=np.uint8))
        ext = dict(mgc_max=torch.tensor([2.5, 0.75], device=cuda),
                   mgc_min=torch.tensor([-11.0, -9.5], device=cuda))
    else:
        src = torch.from_numpy(rng.uniform(-11.5, 3.0, (2, frames,
                                                        cfg.num_mels, 2))
                               .astype(np.float32))
        ext = {}
    src = src.to(cuda)
    got = mel_ops.mel_to_magnitudes(src, inv, *tune, boost=boost, **ext)
    old = old_mel_to_magnitudes(earlier_ki, src, inv, *tune, boost=boost,
                                **ext)
    ref = mel_ops.mel_to_magnitudes_plain(src, inv, *tune, boost=boost, **ext)
    assert torch.equal(got, old)
    peak = ref.amax(dim=-1, keepdim=True)
    assert bool(((got - ref).abs() <= 1e-5 * peak).all())


@pytest.mark.parametrize("n,hop,lead,frames", [
    (4096, 1280, (2,), 11), (512, 128, (3,), 17), (64, 16, (1, 2), 5),
    (16384, 4096, (), 3)])          # > 48 KB shared memory
def test_gl_project_vs_plain(cuda, n, hop, lead, frames):
    from gomel_tpu_torch.ops import griffinlim
    rng = np.random.default_rng(n + frames)
    length = n + (frames - 1) * hop
    sig = torch.from_numpy(rng.random(lead + (length,)).astype(np.float32))
    sig[(0,) * len(lead)][:n] = 0.0            # frame 0 is silent: unit phase 1
    mag = torch.from_numpy((rng.random(lead + (frames, n // 2 + 1)) * 3)
                           .astype(np.float32))
    win = torch.from_numpy(hann_window(n).astype(np.float32))
    before = griffinlim.PROJECT_KERNEL.launches
    out = griffinlim.gl_project(sig.to(cuda), mag.to(cuda), win.to(cuda), n,
                                hop).cpu()
    assert griffinlim.PROJECT_KERNEL.launches == before + 1
    ref = griffinlim.gl_project_plain(sig.double(), mag.double(), win.double(),
                                      n, hop)
    assert out.shape == ref.shape == lead + (frames, n)
    # float32 FFTs against float64: relative L2 per frame <= 1e-4 (the phase
    # of a near-zero bin is rounding noise in both)
    rel = (out.double() - ref).norm(dim=-1) / ref.norm(dim=-1)
    assert float(rel.max()) <= 1e-4, float(rel.max())


@pytest.mark.parametrize("n,hop,frames,momentum,pcm16", [
    (4096, 1280, 40, 0.0, False), (4096, 1280, 40, 0.99, False),
    (4096, 1280, 40, 0.0, True), (1024, 1024, 5, 0.5, False),
    (1000, 300, 13, 0.0, True)])
def test_gl_overlap_add_bit_exact(cuda, n, hop, frames, momentum, pcm16):
    from gomel_tpu_torch.ops import griffinlim
    rng = np.random.default_rng(n + frames)
    fw = torch.from_numpy((rng.standard_normal((2, frames, n)) * 0.4)
                          .astype(np.float32)).to(cuda)
    length = n + (frames - 1) * hop
    prev = None
    if momentum:
        prev = torch.from_numpy(rng.standard_normal((2, length))
                                .astype(np.float32)).to(cuda)
    before = griffinlim.OLA_KERNEL.launches
    out = griffinlim.gl_overlap_add(fw, hop, prev, momentum, pcm16)
    assert griffinlim.OLA_KERNEL.launches == before + 1
    ref = griffinlim.gl_overlap_add_plain(fw, hop, prev, momentum, pcm16)
    if not isinstance(out, tuple):
        out, ref = (out,), (ref,)
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and torch.equal(o, r)


def test_gl_overlap_add_finite_flag(cuda):
    from gomel_tpu_torch.ops import griffinlim
    fw = torch.zeros((3, 6, 512), device=cuda)
    fw[1, 2, 100] = float("nan")
    fw[2, 0, 7] = float("inf")
    _, finite = griffinlim.gl_overlap_add(fw, 128, pcm16=True)
    assert finite.tolist() == [True, False, False]


@pytest.mark.parametrize("momentum", [0.0, 0.99])
def test_mel_decode_cuda_vs_cpu(cuda, momentum):
    from gomel_tpu_torch.ops import griffinlim
    cfg = MelConfig.cli_default()
    rng = np.random.default_rng(9)
    logmel = torch.from_numpy(rng.uniform(-11.5, 3.0, size=(2, 12, 192, 2))
                              .astype(np.float32))
    inv = _inv(cfg)
    init = torch.from_numpy(rng.random((2, 4096 + 11 * 1280)).astype(np.float32))
    counts = [k.launches for k in (mel_ops.MAG_KERNEL, griffinlim.PROJECT_KERNEL,
                                   griffinlim.OLA_KERNEL)]
    gpu = mel_ops.mel_decode(logmel.to(cuda), 4096, 1280, inv.to(cuda), 3,
                             init=init.to(cuda), momentum=momentum).cpu()
    assert [k.launches - c for k, c in zip(
        (mel_ops.MAG_KERNEL, griffinlim.PROJECT_KERNEL, griffinlim.OLA_KERNEL),
        counts)] == [1, 3, 3]
    cpu = mel_ops.mel_decode(logmel.double(), 4096, 1280, inv.double(), 3,
                             init=init.double(), momentum=momentum)
    rel = float((gpu.double() - cpu).norm() / cpu.norm())
    assert rel <= 1e-4, rel


def test_mel_decode_quantized_cuda_vs_cpu(cuda):
    rng = np.random.default_rng(10)
    t = np.arange(48000) / 48000
    x = 0.3 * np.sin(2 * np.pi * 330 * t) + 0.02 * rng.standard_normal(t.shape)
    cfg = MelConfig.cli_default(volume_boost=0.5)
    img, mx, mn = Mel(cfg, device="cpu").encode_quantized(x)
    pcm_g, ok_g = Mel(cfg, device=cuda).decode_quantized_pcm16(img, mx, mn,
                                                               seed=2)
    pcm_c, ok_c = Mel(cfg, device="cpu").decode_quantized_pcm16(img, mx, mn, seed=2)
    assert bool(ok_g) and bool(ok_c) and pcm_g.shape == pcm_c.shape
    lsb = (pcm_g.cpu().int() - pcm_c.int()).abs()
    assert int(lsb.max()) <= 2 and float((lsb > 0).float().mean()) < 5e-2


# -- the long-form slice: KL, KG's real-frame count, KM ----------------------

@pytest.mark.parametrize("dtype,max_val,ext,passes,boost", [
    (np.uint8, 255, 2, 0, 0.0), (np.uint16, 65535, 2, 0, 0.0),
    (np.uint8, 255, 1, 0, 1.5), (np.uint16, 65535, 2, 2, 0.0),
    (np.uint8, 255, 2, 1, -0.5)])
def test_dequantize_raw_vs_plain(cuda, dtype, max_val, ext, passes, boost):
    """KL bit-exact against its plain version without IHS; with sinh passes
    within 2 ulp (CUDA's sinhf and PyTorch's may round apart)."""
    rng = np.random.default_rng(20)
    img = torch.from_numpy(rng.integers(0, max_val + 1, (1, 301, 37, 2),
                                        dtype=dtype))
    maxs = torch.tensor([2.0, 1.25])[:ext].reshape((2,) if ext == 2 else ())
    mins = torch.tensor([-1.75, -0.5])[:ext].reshape((2,) if ext == 2 else ())
    before = quantize.DEQUANTIZE_RAW_KERNEL.launches
    out = quantize.dequantize_raw(img.to(cuda), maxs, mins, max_val, passes,
                                  boost)
    assert quantize.DEQUANTIZE_RAW_KERNEL.launches == before + 1
    ref = quantize.dequantize_raw_plain(img.to(cuda), maxs, mins, max_val,
                                        passes, boost)
    if passes == 0:
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out, ref, rtol=2.5e-7, atol=1e-7)
    with pytest.raises(ValueError, match="broadcast"):
        quantize.dequantize_raw(img.to(cuda), torch.zeros(3), torch.zeros(3),
                                max_val)


@pytest.mark.parametrize("dtype,max_val", [(np.uint8, 255),
                                           (np.uint16, 65535)])
@pytest.mark.parametrize("offset,n", [(0, 4099), (1, 4097), (2, 35),
                                      (3, 4096), (5, 7), (7, 100003)])
def test_dequantize_raw_offset_views(cuda, dtype, max_val, offset, n):
    """KL on views that start anywhere (its scalar head and tail, and the
    scalar stores where the head leaves the output unaligned) equals its
    plain version bit for bit, per-channel and scalar extrema."""
    rng = np.random.default_rng(21)
    flat = torch.from_numpy(rng.integers(0, max_val + 1, offset + n + 3,
                                         dtype=dtype)).to(cuda)
    for ext in (1, 2):
        img = flat[offset:offset + n - n % ext].reshape(-1, ext) if ext == 2 \
            else flat[offset:offset + n]
        maxs = torch.tensor([2.0, 1.25])[:ext].reshape((2,) if ext == 2 else ())
        mins = torch.tensor([-1.75, -0.5])[:ext].reshape((2,) if ext == 2 else ())
        out = quantize.dequantize_raw(img, maxs, mins, max_val, 0, 0.5)
        ref = quantize.dequantize_raw_plain(img, maxs, mins, max_val, 0, 0.5)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("mode", ["planes", "spec", "quant8"])
@pytest.mark.parametrize("real", [0, 7, 23])
def test_irfft_window_real_frames(cuda, mode, real):
    """KG with a real-frame count: frames at or past it are exact zeros,
    the others equal KG without the count bit for bit."""
    n, nf, frames = 1024, 300, 23
    rng = np.random.default_rng(21)
    win = torch.from_numpy(hann_window(n).astype(np.float32)).to(cuda)
    if mode == "planes":
        re = torch.from_numpy(rng.standard_normal((2, frames, n // 2 + 1))
                              .astype(np.float32)).to(cuda)
        im = torch.from_numpy(rng.standard_normal((2, frames, n // 2 + 1))
                              .astype(np.float32)).to(cuda)
        full = istft.irfft_window(re, im, n, win)
        before = istft.SYNTH_MASKED_KERNEL.launches
        out = istft.irfft_window(re, im, n, win, real)
    else:
        if mode == "spec":
            src, aux, m = _spec((2, frames, nf, 2), 22).to(cuda), (), \
                istft.MODE_SPEC
        else:
            src = torch.from_numpy(rng.integers(0, 256, (2, nf, frames, 2),
                                                dtype=np.uint8)).to(cuda)
            aux = (torch.tensor([[1.0, 2.0], [3.0, 0.5]], device=cuda),
                   torch.tensor([[-1.0, -2.0], [0.0, -0.5]], device=cuda))
            m = istft.MODE_QUANT8
        full = istft.launch_irfft_window(m, src, aux, n, frames, nf, win, (2,),
                                         255.0, 0)
        before = istft.SYNTH_MASKED_KERNEL.launches
        out = istft.launch_irfft_window(m, src, aux, n, frames, nf, win, (2,),
                                        255.0, 0, real_frames=real)
    assert istft.SYNTH_MASKED_KERNEL.launches == before + 1
    assert torch.equal(out[:, :real], full[:, :real])
    assert not out[:, real:].any()


@pytest.mark.parametrize("start_shard,n_frames,offset,hop", [
    (0, 40, 0, 1280), (1, 40, 0, 1280), (3, 40, 0, 1280), (2, 9, 0, 1280),
    (1, 3, 0, 1280),
    # a start past shard * chunk that is not a multiple of hop (vector:
    # 640; scalar: 2, 1283), and hop not a multiple of 4 (scalar)
    (1, 40, 640, 1280), (1, 40, 2, 1280), (2, 40, 1283, 1280),
    (1, 40, 0, 1279)])
@pytest.mark.parametrize("pcm16,boost", [(False, 0.0), (True, 1.5)])
def test_shard_epilogue_decode_bit_exact(cuda, start_shard, n_frames, offset,
                                         hop, pcm16, boost):
    """KM's decode mode (halo add, global window sum at the global sample,
    threshold, boost, float32 or PCM-16) equals its plain version bit for
    bit, on shards inside, at the end of and past the real frames, on the
    vector and the scalar path."""
    n, f_loc = 4096, 12
    chunk, halo = f_loc * hop, n - hop
    rng = np.random.default_rng(23 + start_shard + offset)
    sig = torch.from_numpy((rng.standard_normal((2, chunk + halo)) * 0.3)
                           .astype(np.float32)).to(cuda)
    recv = None if start_shard == 0 else torch.from_numpy(
        (rng.standard_normal((2, halo)) * 0.3).astype(np.float32)).to(cuda)
    win = torch.from_numpy(hann_window(n).astype(np.float32)).to(cuda)
    kw = dict(window=win, hop=hop, start=start_shard * chunk + offset,
              n_frames=n_frames, volume_boost=boost, pcm16=pcm16)
    before = istft.SHARD_KERNEL.launches
    got = istft.shard_epilogue(sig, recv, chunk, **kw)
    assert istft.SHARD_KERNEL.launches == before + 1
    want = istft.shard_epilogue_plain(sig, recv, chunk, **kw)
    got, want = (got, want) if pcm16 else ((got,), (want,))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("momentum,pcm16,extend", [
    (0.99, False, True), (0.0, False, True), (0.0, True, False),
    (0.0, False, False)])
@pytest.mark.parametrize("chunk", [5 * 320, 5 * 320 + 1])
def test_shard_epilogue_gl_bit_exact(cuda, momentum, pcm16, extend, chunk):
    """KM's Griffin-Lim modes: the momentum step (c, t) into an extended
    carry, the plain interior carry, and the final iteration's float32 or
    PCM-16, each bit-exact against the plain version (the halo columns of
    an extended carry are the caller's to fill and are not compared), on
    the vector path and, with an odd chunk, the scalar path."""
    halo = 1024 - 320
    rng = np.random.default_rng(24)
    sig = torch.from_numpy(rng.standard_normal((3, chunk + halo))
                           .astype(np.float32)).to(cuda)
    recv_src = torch.from_numpy(rng.standard_normal((3, chunk + halo))
                                .astype(np.float32)).to(cuda)
    recv = recv_src[:, chunk:]           # a strided view, as the halo push
    kw = dict(pcm16=pcm16, extend=extend)
    if momentum:
        kw.update(momentum=momentum, t_prev=torch.from_numpy(
            rng.standard_normal((3, chunk)).astype(np.float32)).to(cuda))
    got = istft.shard_epilogue(sig, recv, chunk, **kw)
    want = istft.shard_epilogue_plain(sig, recv, chunk, **kw)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        assert torch.equal(a[..., :chunk], b[..., :chunk])


def test_longform_cuda_vs_cpu(cuda):
    """The long-form codecs on four frame shards of one card against the
    same on four CPU entries: phase encode within 1e-5 of the peak, decode
    within 1e-5, mel GL-3 from the same per-shard starts within 1e-4, with
    every kernel of the path launched."""
    from gomel_tpu_torch import LongFormMel, LongFormPhase, make_mesh
    from gomel_tpu_torch.ops import griffinlim
    g = make_mesh(data=1, frame=4, devices=[cuda] * 4)
    c = make_mesh(data=1, frame=4, devices=[torch.device("cpu")] * 4)
    rng = np.random.default_rng(25)
    x = rng.standard_normal((2, 48000)).astype(np.float32) * 0.1
    pc = PhaseConfig(num_freqs=384, window=320, resolut=1024)
    spec_g = LongFormPhase(pc, g).encode(x).cpu()
    spec_c = LongFormPhase(pc, c).encode(x)
    peak = float(spec_c.abs().max())
    assert float((spec_g - spec_c).abs().max()) <= 1e-5 * peak
    before = (istft.SYNTH_MASKED_KERNEL.launches, istft.SHARD_KERNEL.launches)
    dec_g = LongFormPhase(pc, g).decode(spec_c).cpu()
    assert istft.SYNTH_MASKED_KERNEL.launches == before[0] + 4
    assert istft.SHARD_KERNEL.launches == before[1] + 4
    dec_c = LongFormPhase(pc, c).decode(spec_c)
    assert float((dec_g - dec_c).abs().max()) <= 1e-5 * float(
        dec_c.abs().max())
    mc = MelConfig(num_mels=64, window=320, resolut=1024, mel_fmax=8000.0,
                   griffin_lim_iterations=3)
    logmel = LongFormMel(mc, c).encode(x)
    before = griffinlim.PROJECT_KERNEL.launches
    wav_g = LongFormMel(mc, g).decode(logmel, seed=1, momentum=0.9).cpu()
    assert griffinlim.PROJECT_KERNEL.launches == before + 12
    wav_c = LongFormMel(mc, c).decode(logmel, seed=1, momentum=0.9)
    assert float((wav_g - wav_c).abs().max()) <= 1e-4 * float(
        wav_c.abs().max())


# -- K14 and K19: the matmul DFT (KN, KO) and the xla route ------------------

def _frame_peak_close(got, want, tol, dims=(-1,)):
    """|got - want| <= tol * the peak of each frame of ``want`` (its values
    over ``dims``)."""
    got, want = got.cpu().double(), want.cpu().double()
    assert got.shape == want.shape
    peak = want.abs().amax(dim=dims, keepdim=True)
    err = (got - want).abs()
    assert bool((err <= tol * peak).all()), float((err / peak).max())


@pytest.mark.parametrize("n,hop,lead,length", [
    (4096, 1280, (2,), 1280 * 20 + 4095), (3000, 700, (), 3000 + 700 * 9 + 5),
    (512, 128, (3,), 5001), (8192, 8192, (), 8192 * 3),   # framed: hop = n
    (2, 1, (1, 2), 9),
    # rows that are not a multiple of the 128-row tile, length % 4 of 0-3
    (512, 512, (), 512), (64, 16, (1,), 64 + 16 * 62 + 2),
    (4096, 1280, (5,), 4096 + 1280 * 12 + 1),
    (4096, 1280, (2,), 4096 + 1280 * 1121 + 3)])
@pytest.mark.parametrize("kind", ["planes", "mag", "pairs"])
def test_dft_fwd_vs_plain(cuda, n, hop, lead, length, kind):
    """KN in each mode against its plain version on the same card: the bf16
    mode within 2e-5 of each frame's peak of the bf16-operand plain version
    (summation order only) and within 1e-2 of float64; the float32 mode
    within 1e-5 of float64 (KB's bound). Rows 1, 63, 65, 2244 and every
    length % 4 (the bf16 signal copy where hop % 8 == 0, the float32
    signal's 16-byte and 4-byte copies elsewhere)."""
    from gomel_tpu_torch.ops import dft_mm
    rng = np.random.default_rng(n + hop)
    x = torch.from_numpy(rng.standard_normal(lead + (length,))
                         .astype(np.float32)).to(cuda)
    win = torch.from_numpy(hann_window(n).astype(np.float32)).to(cuda)
    first, count = (1, max(1, n // 3)) if kind == "pairs" else (0, 0)
    kw = dict(kind=kind, first=first, count=count)
    dims = (-2, -1) if kind == "pairs" else (-1,)
    ref64 = dft_mm.dft_fwd_plain(x.cpu().double(), n, hop, win.cpu(), **kw)
    for precision, tally in (("default", dft_mm.FWD_KERNEL),
                             (None, dft_mm.FWD_F32_KERNEL)):
        before = tally.launches
        got = dft_mm._fwd(x, n, hop, win, precision, kind, first=first,
                          count=count)
        assert tally.launches == before + 1
        got = got if isinstance(got, tuple) else (got,)
        want64 = ref64 if isinstance(ref64, tuple) else (ref64,)
        if precision == "default":
            want = dft_mm.dft_fwd_plain(x, n, hop, win, bf16_operands=True,
                                        **kw)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                _frame_peak_close(g, w, 2e-5, dims)
            for g, w in zip(got, want64):
                _frame_peak_close(g, w, 1e-2, dims)
        else:
            for g, w in zip(got, want64):
                _frame_peak_close(g, w, 1e-5, dims)


@pytest.mark.parametrize("n,frames,lead,real", [
    (4096, 11, (2,), None), (3000, 7, (), 4), (512, 17, (3,), 0),
    (8192, 3, (), None), (2, 5, (1, 2), 2),
    # rows 1, 63, 65, 2244; real-frame counts 0, partial and full
    (512, 1, (), 1), (3000, 63, (), 40), (64, 13, (5,), 13),
    (4096, 1122, (2,), 0), (4096, 1122, (2,), 561), (4096, 1122, (2,), 1122)])
def test_dft_inv_vs_plain(cuda, n, frames, lead, real):
    """KO in each mode against its plain version, with non-zero imag(DC)
    and imag(Nyquist), which it must ignore, and a real-frame count: the
    bf16 mode within 2e-5 of each frame's peak of the bf16-operand plain
    version, the float32 mode within 1e-5 of float64; bf16 planes, copied
    into rows padded to 8 bins, give the float32 planes' bits."""
    from gomel_tpu_torch.ops import dft_mm
    rng = np.random.default_rng(n + frames)
    shape = lead + (frames, n // 2 + 1)
    re = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    win = torch.from_numpy(hann_window(n).astype(np.float32))
    im0 = im.clone()
    im0[..., 0] = 0.0
    im0[..., -1] = 0.0
    ref64 = dft_mm.dft_inv_plain(re.double(), im0.double(), n, win,
                                 real_frames=real)
    re, im, win = re.to(cuda), im.to(cuda), win.to(cuda)
    for precision, tally in (("default", dft_mm.INV_KERNEL),
                             ("highest", dft_mm.INV_F32_KERNEL)):
        before = tally.launches
        got = dft_mm.istft_frames(re, im, n, win, precision, real)
        assert tally.launches == before + 1
        if real is not None:
            assert not got[..., real:, :].any()
        if precision == "default":
            want = dft_mm.dft_inv_plain(re, im, n, win, real_frames=real,
                                        bf16_operands=True)
            _frame_peak_close(got, want, 2e-5)
            _frame_peak_close(got, ref64, 1e-2)
            low = dft_mm.istft_frames(re.bfloat16(), im.bfloat16(), n, win,
                                      "default", real)
            assert torch.equal(low, got)     # bf16 planes: the same operand
        else:
            _frame_peak_close(got, ref64, 1e-5)


@pytest.mark.parametrize("n,hop,frames", [(4096, 1280, 1122), (512, 96, 65),
                                          (3000, 1500, 3)])
def test_dft_bf16_planes_in_place(cuda, n, hop, frames):
    """KN's interior projection writes bf16 planes as views of rows padded
    to 8 bins, and KO reads them in place: the frames equal those from
    contiguous copies of the same planes bit for bit, within 2e-5 of the
    bf16-operand plain version, with real-frame counts 0, partial and
    full."""
    from gomel_tpu_torch.ops import dft_mm
    rng = np.random.default_rng(n + frames)
    sig = torch.from_numpy(rng.random((2, n + (frames - 1) * hop))
                           .astype(np.float32)).to(cuda)
    mag = torch.from_numpy((rng.random((2, frames, n // 2 + 1)) * 3)
                           .astype(np.float32)).to(cuda)
    win = torch.from_numpy(hann_window(n).astype(np.float32)).to(cuda)
    lr, li = dft_mm.gl_spectrum(sig, mag, n, hop, win, "default")
    assert lr.shape == mag.shape and not lr.is_contiguous()
    assert lr.stride(-2) % dft_mm.LOW_ALIGN == 0
    for real in (0, frames // 2, frames):
        got = dft_mm.istft_frames(lr, li, n, win, "default", real)
        same = dft_mm.istft_frames(lr.contiguous(), li.contiguous(), n, win,
                                   "default", real)
        assert torch.equal(got, same)
        assert not got[..., real:, :].any()
        want = dft_mm.dft_inv_plain(lr, li, n, win, real_frames=real,
                                    bf16_operands=True)
        if real:
            _frame_peak_close(got[..., :real, :], want[..., :real, :], 2e-5)


@pytest.mark.parametrize("precision", ["default", None])
@pytest.mark.parametrize("n,hop", [(4096, 1280), (3000, 700), (512, 100)])
def test_dft_frame_alone_matches_batch(cuda, n, hop, precision):
    """A frame alone gives the same bits as the same frame inside a batch of
    600 rows (another tile and row of it), in each mode: KN on the frame
    read as framed input against the batch's row, KO on its planes alone
    against the batch's frames."""
    from gomel_tpu_torch.ops import dft_mm
    frames = 300
    rng = np.random.default_rng(n + hop)
    x = torch.from_numpy(rng.standard_normal((2, n + (frames - 1) * hop))
                         .astype(np.float32)).to(cuda)
    win = torch.from_numpy(hann_window(n).astype(np.float32)).to(cuda)
    re, im = dft_mm.stft(x, n, hop, win, precision)
    for b, f in ((0, 0), (1, 37), (1, frames - 1)):
        frame = x[b, f * hop:f * hop + n].contiguous()
        r1, i1 = dft_mm.stft(frame, n, n, win, precision)
        assert torch.equal(r1[0], re[b, f]) and torch.equal(i1[0], im[b, f])
    back = dft_mm.istft_frames(re, im, n, win, precision)
    for b, f in ((0, 0), (1, 37), (1, frames - 1)):
        one = dft_mm.istft_frames(re[b, f:f + 1], im[b, f:f + 1], n, win,
                                  precision)
        assert torch.equal(one[0], back[b, f])


@pytest.mark.parametrize("n,hop,frames", [(4096, 1280, 9), (3000, 750, 6)])
def test_dft_project_vs_plain(cuda, n, hop, frames):
    """KN's Griffin-Lim projection: float32 planes (the final iteration)
    within 1e-4 relative L2 per frame of the bf16-operand plain version (the
    phase of a near-zero bin is rounding noise), and the bf16 planes of an
    interior iteration within one bf16 rounding of those."""
    from gomel_tpu_torch.ops import dft_mm
    rng = np.random.default_rng(n)
    sig = torch.from_numpy(rng.random(n + (frames - 1) * hop)
                           .astype(np.float32)).to(cuda)
    mag = torch.from_numpy((rng.random((frames, n // 2 + 1)) * 3)
                           .astype(np.float32)).to(cuda)
    win = torch.from_numpy(hann_window(n).astype(np.float32)).to(cuda)
    yr, yi = dft_mm.gl_spectrum(sig, mag, n, hop, win, "default", final=True)
    wr, wi = dft_mm.dft_fwd_plain(sig, n, hop, win, kind="project", mag=mag,
                                  bf16_operands=True)
    got, want = torch.cat([yr, yi], -1), torch.cat([wr, wi], -1)
    rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(rel.max()) <= 1e-4, float(rel.max())
    lr, li = dft_mm.gl_spectrum(sig, mag, n, hop, win, "default")
    assert lr.dtype == li.dtype == torch.bfloat16
    low = torch.cat([lr, li], -1).float()
    assert bool(((low - got).abs() <= 2.0 ** -8 * got.abs() + 1e-30).all())


@pytest.mark.parametrize("n,hop,nf,routed", [(3000, 750, 1000, False),
                                              (514, 128, 171, True)])
def test_fft_sites_vs_plain(cuda, n, hop, nf, routed):
    """Every FFT kernel site at a size n/2 that is not a power of two
    matches its plain version: KB's and KE's sites within 1e-5 of the frame
    peak, KG's (planes, spectrogram, uint8 and uint16 planes, with a
    real-frame count) within 1e-5, KJ's within 1e-4 relative L2 per frame.
    n = 3000 runs the kernels' mixed radix (their tallies move, the xla
    route's does not); n = 514, which has no n1 * n2 split with both
    factors <= 128, goes by the xla route (the other way round)."""
    from gomel_tpu_torch.ops import griffinlim
    frames = 9
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((2, n + (frames - 1) * hop))
                         .astype(np.float32))
    win = torch.from_numpy(hann_window(n).astype(np.float32))
    xc, wc = x.to(cuda), win.to(cuda)
    kernels = (rfft_mag.KERNEL, rfft_mag.PLANES_KERNEL, istft.SYNTH_KERNEL,
               istft.SYNTH_MASKED_KERNEL, griffinlim.PROJECT_KERNEL)
    counts = [k.launches for k in kernels]
    route = fftbackend.XLA_ROUTE.launches
    _frame_peak_close(rfft_mag.stft_mag(xc, wc, n, hop),
                      rfft_mag.stft_mag_plain(x, win, n, hop), 1e-5)
    spec = phase_ops.phase_encode_batch(xc, nf, n, hop, wc)
    spec_ref = rfft_mag.stft_planes_plain(x, win, n, hop, 1, nf)
    peak = spec_ref.abs().amax(dim=(-2, -1), keepdim=True)
    assert bool(((spec.cpu() - spec_ref).abs() <= 1e-5 * peak).all())
    re, im = phase_ops.grow_half_planes(spec_ref, n // 2)
    for real in (None, 4):
        _frame_peak_close(istft.irfft_window(re.to(cuda), im.to(cuda), n, wc,
                                             real),
                          istft.irfft_window_plain(re, im, n, win, real), 1e-5)
    sig = phase_ops.phase_decode(spec_ref.to(cuda), n, hop, 0.0, wc).cpu()
    sig_ref = phase_ops.phase_decode_plain(spec_ref, n, hop, 0.0, win)
    assert float((sig - sig_ref).abs().max()) <= 1e-5 * float(
        sig_ref.abs().max())
    syn = phase_ops.phase_synthesize(spec_ref.to(cuda), n, hop, wc, 5).cpu()
    syn_ref = phase_ops.phase_synthesize(spec_ref, n, hop, win, 5)
    assert float((syn - syn_ref).abs().max()) <= 1e-5 * float(
        syn_ref.abs().max())
    for max_val, dt in ((255, np.uint8), (65535, np.uint16)):
        planes = torch.from_numpy(rng.integers(0, max_val + 1, (2, nf, frames,
                                                                2), dtype=dt))
        mx = torch.tensor([[3.0, 2.5], [1.0, 4.0]])
        mn = torch.tensor([[-2.0, -3.5], [-1.0, 0.5]])
        for ihs in (0, 2):
            out = phase_ops.dequantize_decode(
                planes.to(cuda), mx.to(cuda), mn.to(cuda), max_val, ihs, n,
                hop, 0.0, wc).cpu()
            ref = phase_ops.dequantize_decode_plain(planes, mx, mn, max_val,
                                                    ihs, n, hop, 0.0, win)
            assert float((out - ref).abs().max()) <= 1e-5 * float(
                ref.abs().max())
    mag = torch.from_numpy((rng.random((2, frames, n // 2 + 1)) * 3)
                           .astype(np.float32))
    fw = griffinlim.gl_project(xc, mag.to(cuda), wc, n, hop).cpu().double()
    fw_ref = griffinlim.gl_project_plain(x.double(), mag.double(),
                                         win.double(), n, hop)
    rel = (fw - fw_ref).norm(dim=-1) / fw_ref.norm(dim=-1)
    assert float(rel.max()) <= 1e-4
    moved = sum(k.launches for k in kernels) - sum(counts)
    assert (fftbackend.XLA_ROUTE.launches - route, moved) == (
        (11, 0) if routed else (0, 11))


@pytest.mark.parametrize("momentum", [0.0, 0.99])
def test_mel_decode_mm_launches_and_converges(cuda, momentum):
    """mel_decode(fft_backend="mm") at the CLI widths: KN and KO on each
    interior iteration, KN + KG + KK on the final one, and a spectral
    convergence within 1.05 x the exact route's + 1e-3 from one start."""
    from gomel_tpu_torch.ops import dft_mm, griffinlim
    cfg = MelConfig.cli_default()
    rng = np.random.default_rng(32)
    t = np.arange(48000 * 2) / 48000
    x = 0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * np.sin(2 * np.pi * 1234 * t)
    mel = Mel(cfg, device=cuda)
    logmel = mel.encode(x)
    frames = logmel.shape[0]
    init = torch.from_numpy(rng.random(4096 + (frames - 1) * 1280)
                            .astype(np.float32)).to(cuda)
    tallies = (dft_mm.FWD_KERNEL, dft_mm.INV_KERNEL, istft.SYNTH_KERNEL,
               griffinlim.OLA_KERNEL, griffinlim.PROJECT_KERNEL)
    before = [k.launches for k in tallies]
    mm = mel_ops.mel_decode(logmel, 4096, 1280, mel.inv_weights, 3,
                            window=mel.window, fft_backend="mm", init=init,
                            momentum=momentum)
    assert [k.launches - b for k, b in zip(tallies, before)] == [3, 2, 1, 3, 0]
    exact = mel_ops.mel_decode(logmel, 4096, 1280, mel.inv_weights, 3,
                               window=mel.window, init=init,
                               momentum=momentum)
    target = mel_ops.mel_to_magnitudes_plain(logmel.cpu(),
                                             mel.inv_weights.cpu()).double()
    w64 = torch.from_numpy(hann_window(4096))

    def sc(sig):
        a = rfft_mag.stft_mag_plain(sig.cpu().double(), w64, 4096, 1280)
        c = float((a * target).sum() / (target * target).sum())
        return float((a - c * target).norm() / (abs(c) * target.norm()))

    assert sc(mm) <= 1.05 * sc(exact) + 1e-3, (sc(mm), sc(exact))


# -- KP (the Griffin-Lim start's Threefry draw) and the streaming codecs -----

@pytest.mark.parametrize("rows,shape", [
    (None, (1,)), (None, (12345,)), (None, (3, 777)), (None, (2, 70001)),
    (1, (1001,)), (4, (4097,)), (3, (7, 111)), (70000, (3,)), (3, (1001,)),
    (5, (1000,)), (5, (1002,)), (5, (1003,)), (70000, (5,)),
    (None, (2, 1438976))])
def test_threefry_uniform_bit_exact(cuda, rows, shape):
    """KP against its plain version on the card and on the CPU, one key and
    row keys (more rows than the grid's second dimension holds), ragged
    sizes (samples a key of every residue mod 4, so rows start off 16
    bytes and end in a tail), the bench shape: bit for bit, one launch a
    draw."""
    from gomel_tpu_torch.ops import prng
    one = prng.key(2 ** 32 + 11)
    if rows is None:
        keys = one
    else:
        # row keys without 70,000 host blocks: any uint32 words are keys
        keys = np.random.default_rng(rows).integers(
            0, 2 ** 32, size=(rows, 2), dtype=np.uint32)
        keys[0] = prng.split_row(one, 0)
    before = prng.KERNEL.launches
    got = prng.uniform(keys, shape, torch.float32, cuda)
    assert prng.KERNEL.launches == before + 1
    assert got.device == cuda and got.dtype == torch.float32
    assert torch.equal(got, prng.uniform_plain(keys, shape, torch.float32,
                                               cuda))
    assert torch.equal(got.cpu(), prng.uniform(keys, shape, torch.float32,
                                               "cpu"))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


def test_threefry_uniform_known_answer_and_checks(cuda):
    from gomel_tpu_torch.ops import prng
    got = prng.uniform(np.zeros(2, np.uint32), (4,), torch.float32, cuda)
    bits = np.array([0x6b200159 ^ 0x99ba4efe], np.uint32)
    want = ((bits >> 9) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    assert got.cpu().numpy()[0] == want[0]
    before = prng.KERNEL.launches
    assert prng.uniform(prng.key(1), (0,), torch.float32, cuda).shape == (0,)
    assert prng.KERNEL.launches == before        # nothing to draw: no launch
    with pytest.raises(ValueError, match="float32"):
        prng.uniform(prng.key(1), (4,), torch.float64, cuda)
    with pytest.raises(ValueError, match="2\\^32"):
        prng.uniform(prng.key(1), (2 ** 32,), torch.float32, cuda)


def test_seeded_decodes_draw_on_the_card(cuda):
    """Mel, BatchedMel and LongFormMel with 0 iterations return their starts:
    drawn by KP on the card (1 launch a call, 1 a shard), equal to the CPU's
    bit for bit."""
    from gomel_tpu_torch import LongFormMel, make_mesh
    from gomel_tpu_torch.ops import prng
    from gomel_tpu_torch.parallel.batch import BatchedMel
    mc = MelConfig(num_mels=64, window=320, resolut=1024, mel_fmax=8000.0,
                   griffin_lim_iterations=0)
    logmel = np.random.default_rng(31).uniform(
        -11.0, 2.0, (2, 47, 64, 2)).astype(np.float32)
    cpu = torch.device("cpu")
    for make, args, launches in (
            (lambda d: Mel(mc, device=d), (logmel[0],), 1),
            (lambda d: BatchedMel(mc, device=d), (logmel,), 1),
            (lambda d: LongFormMel(mc, make_mesh(data=1, frame=4,
                                                 devices=[d] * 4)),
             (logmel,), 4)):
        before = prng.KERNEL.launches
        on_card = make(cuda).decode(*args, seed=5)
        assert prng.KERNEL.launches == before + launches
        assert on_card.device.type == "cuda"
        assert torch.equal(on_card.cpu(), make(cpu).decode(*args, seed=5))


def test_streaming_cuda_vs_whole_and_cpu(cuda):
    """StreamingPhase and StreamingMel on the card at the CLI widths, 24
    frames a chunk, pieces of uneven sizes: the encodes within 1e-5 of each
    frame's peak of Phase / Mel on the whole signal on the card (the mel
    energies for mel), the decode within 2e-4 of Phase.decode, the CPU
    stream within the same bounds; KE, the fused KB + KC (and neither KB
    nor KC alone), KG + KH once a chunk."""
    from gomel_tpu_torch import StreamingMel, StreamingPhase
    rng = np.random.default_rng(32)
    t = np.arange(3 * 48000 + 777) / 48000
    x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.shape)
    pieces = np.array_split(x, 11)
    pc, mc = PhaseConfig.cli_default(), MelConfig.cli_default()
    sp = StreamingPhase(pc, 24, device=cuda)
    before = rfft_mag.PLANES_KERNEL.launches
    chunks = list(sp.encode_iter(pieces))
    assert rfft_mag.PLANES_KERNEL.launches == before + len(chunks)
    got = np.concatenate(chunks)
    want = Phase(pc, device=cuda).encode(x)
    _frame_peak_close(torch.from_numpy(got), want, 1e-5, (-2, -1))
    on_cpu = StreamingPhase(pc, 24, device="cpu").encode(x)
    _frame_peak_close(torch.from_numpy(got), torch.from_numpy(on_cpu), 1e-5,
                      (-2, -1))

    before = (istft.SYNTH_MASKED_KERNEL.launches, istft.OLA_KERNEL.launches)
    blocks = list(sp.decode_iter(chunks))
    assert len(blocks) == got.shape[0] // 24 + 1
    assert istft.SYNTH_MASKED_KERNEL.launches == before[0] + len(blocks)
    assert istft.OLA_KERNEL.launches == before[1] + len(blocks)
    sig = np.concatenate(blocks)
    ref = Phase(pc, device=cuda).decode(want).cpu().numpy()
    assert sig.shape == ref.shape
    assert float(np.abs(sig - ref).max()) <= 2e-4
    sig_cpu = StreamingPhase(pc, 24, device="cpu").decode(got)
    assert float(np.abs(sig - sig_cpu).max()) <= 2e-4

    sm = StreamingMel(mc, 24, device=cuda)
    before = (mel_ops.FUSED_KERNEL.launches, rfft_mag.KERNEL.launches,
              mel_ops.KERNEL.launches)
    m_chunks = list(sm.encode_iter(pieces))
    assert mel_ops.FUSED_KERNEL.launches == before[0] + len(m_chunks)
    assert (rfft_mag.KERNEL.launches, mel_ops.KERNEL.launches) == before[1:]
    mel = torch.from_numpy(np.concatenate(m_chunks))
    _frame_peak_close(mel.exp(), Mel(mc, device=cuda).encode(x).exp(), 1e-5,
                      (-2, -1))
    _frame_peak_close(mel.exp(), torch.from_numpy(
        StreamingMel(mc, 24, device="cpu").encode(x)).exp(), 1e-5, (-2, -1))
