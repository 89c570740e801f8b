"""The serving artifacts' custom ops and small artifacts on the card.

Every test here needs an NVIDIA GPU and skips without one; they import
neither JAX nor gomel_tpu:

    python -m pytest --noconftest -q tests/test_torch_serving_cuda.py

Each op's CUDA kernel passes ``torch.library.opcheck`` on card tensors and
gives its eager wrapper's bits with one launch of its kernel; each
builder's card artifact at a small shape gives the eager path's bits on the
card (chip_smoke.py phase 3h does the same at the bench shape).
"""
import numpy as np
import pytest
import torch

from gomel_tpu_torch import MelConfig, PhaseConfig, make_mesh, serving
from gomel_tpu_torch.core.filterbank import inverse_mel_weights, mel_weights
from gomel_tpu_torch.ops import (dft_mm, griffinlim, istft, library,
                                 mel_ops, phase_ops, prng, quantize,
                                 rfft_mag)
from gomel_tpu_torch.ops.stft import hann_window
from gomel_tpu_torch.parallel import sharded as tsh
from gomel_tpu_torch.parallel.mesh import shard_array

pytestmark = pytest.mark.cuda
OPS = torch.ops.gomel_tpu_torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _cases(dev):
    """(label, op, args, the eager call, its kernel tally) at small,
    ragged shapes on the card."""
    rng = np.random.default_rng(0)
    n, hop, m = 256, 64, 24
    f32 = torch.float32
    x = torch.tensor(rng.standard_normal((2, hop * 9 + n + 7)), dtype=f32,
                     device=dev)
    win = torch.tensor(hann_window(n), dtype=f32, device=dev)
    tw, tw_pass = rfft_mag.fft_tables(n, dev)
    plan = rfft_mag.fft_plan_args(n)
    w = torch.tensor(mel_weights(n // 2, m, 0.0, 4000.0), dtype=f32,
                     device=dev)
    we = torch.from_numpy(mel_ops.extended_weights_np(w.cpu().numpy())).to(dev)
    band = mel_ops.mel_band_plan(w.cpu().numpy())
    slots = torch.from_numpy(band.slots).to(dev)
    bw = torch.from_numpy(band.weights).to(dev)
    mags = rfft_mag.stft_mag_plain(x, win, n, hop).contiguous()
    lm = mel_ops.mel_from_ext_plain(mags, we).contiguous()
    sp = rfft_mag.stft_planes_plain(x, win, n, hop, 1, 100).contiguous()
    img, mx, mn = quantize.quantize_planes_batch(sp, 255, 0)
    img16, mx16, mn16 = quantize.quantize_planes_batch(sp, 65535, 1)
    re = torch.randn(2, 10, n // 2 + 1, device=dev)
    im = torch.randn(2, 10, n // 2 + 1, device=dev)
    fw = istft.irfft_window_plain(re, im, n, win).contiguous()
    prefix = istft._prefix_rows(win.cpu(), hop).to(dev)
    thr = istft.window_sum_threshold(prefix.cpu(), 10)
    short = istft.window_sum_short(prefix.shape[0], 10)
    inv = torch.tensor(inverse_mel_weights(n // 2, m, 0.0, 4000.0),
                       dtype=f32, device=dev)
    first, count, taps = (torch.from_numpy(t).to(dev)
                          for t in mel_ops.mel_runs_np(inv.cpu().numpy()))
    lmq = quantize.quantize_mel_plane_batch(lm)
    mag = mel_ops.mel_to_magnitudes_plain(lm, inv).contiguous()
    sig = torch.rand(2, n + (mag.shape[1] - 1) * hop, device=dev)
    gfw = griffinlim.gl_project_plain(sig, mag, win, n, hop).contiguous()
    keys_np = np.stack([prng.key(1), prng.key(2)])
    keys = torch.from_numpy(keys_np.view(np.int32)).to(dev)
    ext = torch.randn(2, 640 + n - hop, device=dev)
    recv = torch.randn(2, n - hop, device=dev)
    t_prev = torch.randn(2, 640, device=dev)
    hann = hann_window(n)
    w_fwd = {b: dft_mm.kernel_weights_tensor(
        "fwd", dft_mm._master("fwd", n, hann), n, b).to(dev)
        for b in (False, True)}
    w_inv = {b: dft_mm.kernel_weights_tensor(
        "inv", dft_mm._master("inv", n, hann), n, b).to(dev)
        for b in (False, True)}
    epi = dict(hop=hop, start=640, n_frames=30)
    return [
        ("stft_mel_log", OPS.stft_mel_log.default,
         (x, win, we, tw, tw_pass, slots, bw, n, hop, m, band.groups, *plan),
         lambda: mel_ops.stft_mel_log(x, win, n, hop, w),
         mel_ops.FUSED_KERNEL),
        ("stft_mag", OPS.stft_mag.default,
         (x, win, tw, tw_pass, n, hop, *plan),
         lambda: rfft_mag.stft_mag(x, win, n, hop), rfft_mag.KERNEL),
        ("mel_log", OPS.mel_log.default,
         (mags, we, slots, bw, m, band.groups),
         lambda: mel_ops._mel_from_mags(mags, w), mel_ops.KERNEL),
        ("quantize_mel", OPS.quantize_mel.default, (lm, 255),
         lambda: quantize.quantize_mel_plane_batch(lm),
         quantize.QUANTIZE_KERNEL),
        ("stft_planes", OPS.stft_planes.default,
         (x, win, tw, tw_pass, n, hop, 1, 100, *plan),
         lambda: rfft_mag.stft_planes(x, win, n, hop, 1, 100),
         rfft_mag.PLANES_KERNEL),
        ("quantize_planes", OPS.quantize_planes.default, (sp, 65535, 1),
         lambda: quantize.quantize_planes_batch(sp, 65535, 1),
         quantize.PLANES_KERNEL),
        ("irfft_window planes", OPS.irfft_window.default,
         (istft.MODE_PLANES, re, im, None, win, tw, tw_pass, n, 0.0, 0, 7,
          *plan),
         lambda: istft.irfft_window(re, im, n, win, 7),
         istft.SYNTH_MASKED_KERNEL),
        ("irfft_window spectrogram", OPS.irfft_window.default,
         (istft.MODE_SPEC, sp, None, None, win, tw, tw_pass, n, 0.0, 0, -1,
          *plan),
         lambda: phase_ops._synthesize(sp, n, win, "mxu"),
         istft.SYNTH_KERNEL),
        ("irfft_window uint8", OPS.irfft_window.default,
         (istft.MODE_QUANT8, img, mx, mn, win, tw, tw_pass, n, 255.0, 0, -1,
          *plan),
         lambda: istft.launch_irfft_window(istft.MODE_QUANT8, img, (mx, mn),
                                           n, img.shape[2], 100, win, (2,),
                                           255.0, 0), istft.SYNTH_KERNEL),
        ("irfft_window uint16", OPS.irfft_window.default,
         (istft.MODE_QUANT16, img16, mx16, mn16, win, tw, tw_pass, n,
          65535.0, 1, -1, *plan),
         lambda: istft.launch_irfft_window(
             istft.MODE_QUANT16, img16, (mx16, mn16), n, img16.shape[2], 100,
             win, (2,), 65535.0, 1), istft.SYNTH_KERNEL),
        ("overlap_normalize", OPS.overlap_normalize.default,
         (fw, prefix, win, hop, thr, short, 1.5, False),
         lambda: (istft.overlap_normalize(fw, hop, win, 1.5),),
         istft.OLA_KERNEL),
        ("overlap_normalize pcm16", OPS.overlap_normalize.default,
         (fw, prefix, win, hop, thr, short, 0.0, True),
         lambda: istft.overlap_normalize(fw, hop, win, pcm16=True),
         istft.OLA_KERNEL),
        ("overlap_normalize overlap-add", OPS.overlap_normalize.default,
         (fw, None, None, hop, 0.0, False, 0.0, False),
         lambda: (istft.overlap_add(fw, hop),), istft.OLA_KERNEL),
        ("mel_to_mag", OPS.mel_to_mag.default,
         (lm, None, None, inv, first, count, taps, 255, 0.0, 1.0, 0.0),
         lambda: mel_ops.mel_to_magnitudes(lm, inv), mel_ops.MAG_KERNEL),
        ("mel_to_mag uint8", OPS.mel_to_mag.default,
         (lmq[0], lmq[1], lmq[2], inv, first, count, taps, 255, 1.5, 1.5,
          0.25),
         lambda: mel_ops.mel_to_magnitudes(lmq[0], inv, 1.5, 0.25, 1.5,
                                           lmq[1], lmq[2]),
         mel_ops.MAG_KERNEL),
        ("gl_project", OPS.gl_project.default,
         (sig, mag, win, tw, tw_pass, n, hop, *plan),
         lambda: griffinlim.gl_project(sig, mag, win, n, hop),
         griffinlim.PROJECT_KERNEL),
        ("gl_overlap_add", OPS.gl_overlap_add.default,
         (gfw, None, hop, 0.0, False),
         lambda: (griffinlim.gl_overlap_add(gfw, hop),),
         griffinlim.OLA_KERNEL),
        ("gl_overlap_add momentum", OPS.gl_overlap_add.default,
         (gfw, sig, hop, 0.99, False),
         lambda: griffinlim.gl_overlap_add(gfw, hop, sig, 0.99),
         griffinlim.OLA_KERNEL),
        ("gl_overlap_add pcm16", OPS.gl_overlap_add.default,
         (gfw, None, hop, 0.0, True),
         lambda: griffinlim.gl_overlap_add(gfw, hop, pcm16=True),
         griffinlim.OLA_KERNEL),
        ("threefry_uniform", OPS.threefry_uniform.default,
         (keys, 1001, torch.float32),
         lambda: prng.uniform(keys_np, (1001,), torch.float32, dev),
         prng.KERNEL),
        ("shard_epilogue normalize", OPS.shard_epilogue.default,
         (ext, recv, prefix, None, 640, hop, 640, 30, thr, 1.5, 0.0, False),
         lambda: (istft.shard_epilogue(ext, recv, 640, window=win,
                                       volume_boost=1.5, **epi),),
         istft.SHARD_KERNEL),
        ("shard_epilogue momentum", OPS.shard_epilogue.default,
         (ext, None, None, t_prev, 640, hop, 0, 0, 0.0, 0.0, 0.99, False),
         lambda: istft.shard_epilogue(ext, None, 640, t_prev=t_prev,
                                      momentum=0.99),
         istft.SHARD_KERNEL),
        ("shard_epilogue pcm16", OPS.shard_epilogue.default,
         (ext, recv, prefix, None, 640, hop, 640, 30, thr, 0.0, 0.0, True),
         lambda: istft.shard_epilogue(ext, recv, 640, window=win, pcm16=True,
                                      **epi), istft.SHARD_KERNEL),
        ("dft_fwd f32 pairs", OPS.dft_fwd.default,
         (x, None, None, w_fwd[False], n, hop, 2, 1, 100, False, True),
         lambda: (dft_mm.stft_pairs(x, n, hop, hann, 1, 100),),
         dft_mm.FWD_F32_KERNEL),
        ("dft_fwd bf16 project", OPS.dft_fwd.default,
         (sig, mag, None, w_fwd[True], n, hop, 3, 0, 0, True, False),
         lambda: tuple(t._base for t in dft_mm.gl_spectrum(
             sig, mag, n, hop, hann, "default", False)),
         dft_mm.FWD_KERNEL),
        ("dft_inv f32", OPS.dft_inv.default,
         (re, im, None, w_inv[False], n, False, 7),
         lambda: dft_mm.istft_frames(re, im, n, hann, None, 7),
         dft_mm.INV_F32_KERNEL),
        ("dft_inv bf16", OPS.dft_inv.default,
         (re.bfloat16(), im.bfloat16(), None, w_inv[True], n, True, -1),
         lambda: dft_mm.istft_frames(re.bfloat16(), im.bfloat16(), n, hann,
                                     "default"), dft_mm.INV_KERNEL),
    ]


_LABELS = [c[0] for c in _cases(torch.device("cpu"))]


def _case(dev, label):
    return next(c for c in _cases(dev) if c[0] == label)


@pytest.mark.parametrize("label", _LABELS)
def test_op_opcheck_on_the_card(cuda, label):
    _, op, args, _, _ = _case(cuda, label)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("label", _LABELS)
def test_op_cuda_kernel_is_the_wrapper(cuda, label):
    """One launch of the kernel, the eager wrapper's bits."""
    _, op, args, eager, kernel = _case(cuda, label)
    want = eager()
    want = want if isinstance(want, tuple) else (want,)
    before = kernel.launches
    got = op(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), label


CFG = MelConfig(num_mels=32, resolut=256, window=64, griffin_lim_iterations=3)
PCFG = PhaseConfig(sample_rate=8000, resolut=256, window=64, num_freqs=100)


@pytest.mark.parametrize("backend", ["auto", "mm"])
def test_card_artifacts_give_the_eager_bits(cuda, backend, tmp_path):
    f32 = torch.float32
    x = torch.randn(3, 64 * 20 + 256, device=cuda)
    win = torch.tensor(hann_window(256), dtype=f32, device=cuda)
    fwd = torch.tensor(mel_weights(CFG.n_bins, 32, 0.0, 8000.0), dtype=f32,
                       device=cuda)
    inv = torch.tensor(inverse_mel_weights(CFG.n_bins, 32, 0.0, 8000.0),
                       dtype=f32, device=cuda)
    sec = dict(seconds=x.shape[1] / 8000, sample_rate=8000)
    enc = serving.export_mel_encoder(CFG, **sec, fft_backend=backend)
    assert int(enc.in_shapes[0][1]) == x.shape[1]
    p = str(tmp_path / "enc.gmexp")
    serving.save_exported(enc, p)
    enc = serving.load_exported(p)
    lm = enc.call(x)
    assert torch.equal(lm, mel_ops.mel_encode_batch(x, 32, 256, 64, fwd, win,
                                                    backend))
    keys_np = prng.split_rows(prng.key(4), 3)
    keys = torch.from_numpy(keys_np.view(np.int32)).to(cuda)
    dec = serving.export_mel_decoder(CFG, n_frames=lm.shape[1],
                                     fft_backend=backend, momentum=0.99)
    wave = mel_ops.mel_decode(lm, 256, 64, inv, 3, key=keys_np,
                              fft_backend=backend, momentum=0.99,
                              window=win if backend == "auto" else None)
    assert torch.equal(dec.call(lm, keys), wave)
    pe = serving.export_phase_encoder(PCFG, seconds=x.shape[1] / 8000,
                                      fft_backend=backend)
    spec = pe.call(x)
    assert torch.equal(spec, phase_ops.phase_encode_batch(
        x, 100, 256, 64, win, backend))
    pd = serving.export_phase_decoder(PCFG, n_frames=spec.shape[1],
                                      fft_backend=backend)
    assert torch.equal(pd.call(spec), phase_ops.phase_decode(
        spec, 256, 64, fft_backend=backend))


def test_card_quantized_and_longform_artifacts(cuda):
    x = torch.randn(2, 64 * 20 + 256, device=cuda)
    peq = serving.export_phase_encoder_quantized(PCFG,
                                                 seconds=x.shape[1] / 8000)
    planes, mx, mn = peq.call(x)
    want = quantize.quantize_planes_batch(phase_ops.phase_encode_batch(
        x, 100, 256, 64), 255, 0)
    assert all(torch.equal(a, b) for a, b in zip((planes, mx, mn), want))
    pdq = serving.export_phase_decoder_quantized(PCFG,
                                                 n_frames=planes.shape[2])
    got = pdq.call(planes, mx, mn)
    want = phase_ops.dequantize_decode(planes, mx, mn, 255, 0, 256, 64,
                                       pcm16=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    mesh = make_mesh(data=1, frame=4, devices=[cuda] * 4)
    plan = serving.longform_plan(PCFG, mesh, 37)
    xl = torch.randn(1, plan.sharded_signal_len, device=cuda)
    lf = serving.export_longform_phase_encoder(PCFG, mesh, n_frames=37)
    got = serving.call_longform(lf, mesh, xl)
    want = tsh.sharded_phase_encode_fn(mesh, plan, 100)(shard_array(xl, mesh))
    assert all(torch.equal(a, b) for a, b in zip(got.shards, want.shards))
    lfd = serving.export_longform_phase_decoder(PCFG, mesh, n_frames=37)
    got = serving.call_longform(lfd, mesh, want.gather())
    ref = tsh.sharded_phase_decode_fn(mesh, plan)(want)
    assert all(torch.equal(a, b) for a, b in zip(got.shards, ref.shards))
    assert library.NS == "gomel_tpu_torch"
