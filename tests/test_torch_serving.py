"""The port's serving artifacts (gomel_tpu_torch/serving.py) and the custom
ops they call (gomel_tpu_torch/ops/library.py), on the CPU.

Every builder's CPU artifact is held to the JAX builder's CPU artifact on
the same seeded numpy inputs and keys (the long-form ones on the (2, 4)
mesh of eight virtual CPU devices, tests/conftest.py), and bit for bit to
the port's eager CPU path. Bounds, port against JAX: float64 1e-9
absolute; float32 1e-5 of the output's peak; the log-mel 1e-5 in the log
domain; uint8 planes one step at a flip rate < 2e-3; int16 PCM 1 LSB
(phase) or 2 (mel) with < 5e-2 of the samples differing; finite flags
equal. The JAX builders run with their own defaults (``"mxu"`` encodes,
``"mm"`` Griffin-Lim, ``interior_mm`` in the long-form decode): off the TPU
each is exact float32, as the port's ``"auto"`` is.
"""
import conftest  # noqa: F401  (forces CPU, 8 virtual devices)

import dataclasses
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gomel_tpu import MelConfig as JMelConfig
from gomel_tpu import PhaseConfig as JPhaseConfig
from gomel_tpu import serving as js
from gomel_tpu.parallel.mesh import make_mesh as jmake_mesh
from gomel_tpu_torch import MelConfig, PhaseConfig, make_mesh
from gomel_tpu_torch import serving as ts
from gomel_tpu_torch.core.filterbank import inverse_mel_weights, mel_weights
from gomel_tpu_torch.ops import (griffinlim, istft, library, mel_ops,
                                 phase_ops, prng, quantize, rfft_mag)
from gomel_tpu_torch.ops.stft import hann_window
from gomel_tpu_torch.parallel import sharded as tsh
from gomel_tpu_torch.parallel.mesh import Sharded, shard_array

MEL = dict(num_mels=32, resolut=256, window=64, griffin_lim_iterations=2)
PH = dict(sample_rate=8000, resolut=256, window=64, num_freqs=100)
CFG, JCFG = MelConfig(**MEL), JMelConfig(**MEL)
PCFG, JPCFG = PhaseConfig(**PH), JPhaseConfig(**PH)
CPU = ("cpu",)
CPU8 = [torch.device("cpu")] * 8
OPS = torch.ops.gomel_tpu_torch


def _audio(batch, n, seed=0):
    return np.random.RandomState(seed).randn(batch, n).astype(np.float32)


def _keys(batch):
    return np.asarray(jax.random.split(jax.random.PRNGKey(3), batch),
                      np.uint32)


# -- the builders, each with its inputs ---------------------------------------

def _enc_kw(jax_side):
    return dict(seconds=0.05, sample_rate=8000,
                **({"platforms": CPU} if jax_side else {"device": "cpu"}))


def _build(name, jax_side):
    """The JAX (``jax_side``) or port CPU artifact of builder ``name``."""
    s, c, p = ((js, JCFG, JPCFG) if jax_side else (ts, CFG, PCFG))
    dev = {"platforms": CPU} if jax_side else {"device": "cpu"}
    if name == "mel-enc":
        return s.export_mel_encoder(c, **_enc_kw(jax_side))
    if name == "mel-enc-q":
        return s.export_mel_encoder_quantized(c, **_enc_kw(jax_side))
    if name == "mel-dec":
        return s.export_mel_decoder(c, n_frames=11, **dev)
    if name == "mel-dec-q":
        return s.export_mel_decoder_quantized(c, n_frames=11, momentum=0.99,
                                              **dev)
    if name == "phase-enc":
        return s.export_phase_encoder(p, seconds=0.1, **dev)
    if name == "phase-enc-q":
        return s.export_phase_encoder_quantized(p, seconds=0.1, **dev)
    if name == "phase-rt":
        return s.export_phase_roundtrip(p, seconds=0.1, **dev)
    if name == "phase-dec":
        return s.export_phase_decoder(p, n_frames=10, **dev)
    if name == "phase-dec-q":
        return s.export_phase_decoder_quantized(p, n_frames=10, **dev)
    mesh = (jmake_mesh(data=2, frame=4) if jax_side
            else make_mesh(data=2, frame=4, devices=CPU8))
    kw = ({"platforms": CPU} if jax_side else {}) | {"batch": 2}
    if name == "longform-mel-enc":
        return s.export_longform_mel_encoder(c, mesh, n_frames=37, **kw)
    if name == "longform-mel-dec":
        return s.export_longform_mel_decoder(c, mesh, n_frames=25, **kw)
    if name == "longform-phase-enc":
        return s.export_longform_phase_encoder(p, mesh, n_frames=33, **kw)
    if name == "longform-phase-dec":
        return s.export_longform_phase_decoder(p, mesh, n_frames=33, **kw)
    raise KeyError(name)


SINGLE = ("mel-enc", "mel-dec", "phase-enc", "phase-dec", "phase-rt",
          "phase-enc-q", "phase-dec-q", "mel-enc-q", "mel-dec-q")
LONG = ("longform-mel-enc", "longform-mel-dec", "longform-phase-enc",
        "longform-phase-dec")
# each output's bound, port against JAX
BOUNDS = {"mel-enc": ("logmel",), "mel-dec": ("f32",),
          "phase-enc": ("f32",), "phase-dec": ("f32",), "phase-rt": ("f32",),
          "phase-enc-q": ("planes", "f32", "f32"),
          "phase-dec-q": ("pcm", "finite"),
          "mel-enc-q": ("planes", "f32", "f32"),
          "mel-dec-q": ("pcm_mel", "finite"),
          "longform-mel-enc": ("logmel",), "longform-mel-dec": ("f32",),
          "longform-phase-enc": ("f32",),
          "longform-phase-dec": ("sharded_decode",)}

_CACHE: dict = {}


def artifact(name, jax_side=False):
    key = (name, jax_side)
    if key not in _CACHE:
        _CACHE[key] = _build(name, jax_side)
    return _CACHE[key]


def inputs(name):
    """Seeded numpy inputs of builder ``name``: audio, or the encoders'
    outputs (through the port's eager CPU path) for the decoders."""
    fwd = torch.tensor(mel_weights(CFG.n_bins, 32, CFG.mel_fmin,
                                   CFG.mel_fmax), dtype=torch.float32)
    win = torch.tensor(hann_window(256), dtype=torch.float32)
    if name in ("mel-enc", "mel-enc-q", "phase-enc", "phase-enc-q",
                "phase-rt"):
        n = int(artifact(name).in_shapes[0][1])
        return (_audio(2, n, seed=len(name)),)
    if name in ("mel-dec", "mel-dec-q"):
        x = torch.from_numpy(_audio(2, 64 * 10 + 256, seed=11))
        lm = mel_ops.mel_encode_batch(x, 32, 256, 64, fwd, win)
        if name == "mel-dec":
            return lm.numpy(), _keys(2)
        planes, mx, mn = quantize.quantize_mel_plane_batch(lm)
        return planes.numpy(), mx.numpy(), mn.numpy(), _keys(2)
    if name in ("phase-dec", "phase-dec-q"):
        x = torch.from_numpy(_audio(2, 64 * 9 + 256, seed=12))
        spec = phase_ops.phase_encode_batch(x, 100, 256, 64, win)
        if name == "phase-dec":
            return (spec.numpy(),)
        return tuple(t.numpy() for t in quantize.quantize_planes_batch(
            spec, 255, 0))
    plan = tsh.plan_frame_sharding(
        {"longform-mel-enc": 37, "longform-mel-dec": 25}.get(name, 33), 256,
        64, 4)
    if name.endswith("-enc"):
        return (_audio(2, plan.sharded_signal_len, seed=13),)
    if name == "longform-mel-dec":
        lm = np.random.RandomState(14).randn(2, plan.n_frames_padded, 32, 2)
        return lm.astype(np.float32), np.asarray(jax.random.PRNGKey(5),
                                                 np.uint32)
    x = torch.from_numpy(_audio(2, plan.sharded_signal_len, seed=15))
    spec = tsh.sharded_phase_encode_fn(make_mesh(data=2, frame=4,
                                                 devices=CPU8), plan, 100)(
        shard_array(x, make_mesh(data=2, frame=4, devices=CPU8)))
    return (spec.gather().numpy(),)


def run_port(name, args):
    exp = artifact(name)
    if name.startswith("longform"):
        mesh = make_mesh(data=2, frame=4, devices=CPU8)
        return (ts.call_longform(exp, mesh, *args).gather(),)
    out = exp.call(*(torch.from_numpy(_int32_bits(a)) for a in args))
    return out if isinstance(out, tuple) else (out,)


def _int32_bits(a):
    """An input as the port's artifacts take it: keys' uint32 bits as
    int32."""
    a = np.array(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def run_jax(name, args):
    exp = artifact(name, jax_side=True)
    if name.startswith("longform"):
        out = js.call_longform(exp, jmake_mesh(data=2, frame=4), *args)
    else:
        out = exp.call(*(jnp.asarray(a) for a in args))
    return tuple(np.asarray(o) for o in (out if isinstance(out, (tuple, list))
                                         else (out,)))


def assert_near(kind, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    if kind == "finite":
        np.testing.assert_array_equal(got, want)
    elif kind == "f64":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    elif kind == "f32":
        peak = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * peak)
    elif kind == "sharded_decode":
        # the JAX program's float32 window sum is off by up to 1.2e-4 in the
        # last frame's fade (the port's is within 4e-7 of float64 there:
        # test_longform_phase_decoder_against_float64), so the sharded
        # decode is held to JAX at the bound tests/test_torch_longform.py
        # holds the same program to
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    elif kind == "logmel":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    elif kind == "planes":
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert d.max() <= 1 and (d > 0).mean() < 2e-3, (d.max(),
                                                        (d > 0).mean())
    else:
        lsb = 2 if kind == "pcm_mel" else 1
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert d.max() <= lsb and (d > 0).mean() < 5e-2, (d.max(),
                                                          (d > 0).mean())


@pytest.mark.parametrize("name", SINGLE + LONG)
def test_artifact_matches_jax(name):
    args = inputs(name)
    got, want = run_port(name, args), run_jax(name, args)
    assert len(got) == len(want)
    for kind, g, w in zip(BOUNDS[name], got, want):
        assert_near(kind, g.numpy(), w)


def _live(name, args):
    """The port's eager CPU path on ``args``."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    fwd = torch.tensor(mel_weights(CFG.n_bins, 32, CFG.mel_fmin,
                                   CFG.mel_fmax), dtype=torch.float32)
    inv = torch.tensor(inverse_mel_weights(CFG.n_bins, 32, CFG.mel_fmin,
                                           CFG.mel_fmax), dtype=torch.float32)
    win = torch.tensor(hann_window(256), dtype=torch.float32)
    mesh = make_mesh(data=2, frame=4, devices=CPU8)
    if name == "mel-enc":
        return mel_ops.mel_encode_batch(t[0], 32, 256, 64, fwd, win)
    if name == "mel-enc-q":
        return quantize.quantize_mel_plane_batch(
            mel_ops.mel_encode_batch(t[0], 32, 256, 64, fwd, win))
    if name == "mel-dec":
        return mel_ops.mel_decode(t[0], 256, 64, inv, 2, key=args[1])
    if name == "mel-dec-q":
        mag = mel_ops.mel_to_magnitudes(t[0], inv, mgc_max=t[1],
                                        mgc_min=t[2])
        return griffinlim.griffin_lim(mag, 64, 2, key=args[3], momentum=0.99,
                                      pcm16=True)
    if name == "phase-enc":
        return phase_ops.phase_encode_batch(t[0], 100, 256, 64)
    if name == "phase-enc-q":
        return quantize.quantize_planes_batch(
            phase_ops.phase_encode_batch(t[0], 100, 256, 64), 255, 0)
    if name == "phase-rt":
        return phase_ops.phase_decode(
            phase_ops.phase_encode_batch(t[0], 100, 256, 64), 256, 64)
    if name == "phase-dec":
        return phase_ops.phase_decode(t[0], 256, 64)
    if name == "phase-dec-q":
        return phase_ops.dequantize_decode(t[0], t[1], t[2], 255, 0, 256, 64,
                                           pcm16=True)
    plan = ts.longform_plan(CFG, mesh, {"longform-mel-enc": 37,
                                        "longform-mel-dec": 25}.get(name, 33))
    if name == "longform-mel-enc":
        fn = tsh.sharded_mel_encode_fn(mesh, plan, 32, fwd.numpy())
    elif name == "longform-phase-enc":
        fn = tsh.sharded_phase_encode_fn(mesh, plan, 100)
    elif name == "longform-phase-dec":
        fn = tsh.sharded_phase_decode_fn(mesh, plan)
    else:
        fn = tsh.sharded_mel_decode_fn(mesh, plan, inv.numpy(), 2)
        seed = (int(args[1][0]) << 32) | int(args[1][1])
        return fn(shard_array(t[0], mesh), seed).gather()
    return fn(shard_array(t[0], mesh)).gather()


def test_longform_phase_decoder_against_float64():
    """The long-form phase decoder's artifact within 1e-5 of the peak of the
    port's float64 sharded program (the exact result), where the JAX
    program's float32 result is not."""
    args = inputs("longform-phase-dec")
    mesh = make_mesh(data=2, frame=4, devices=CPU8)
    plan = tsh.plan_frame_sharding(33, 256, 64, 4)
    ref = tsh.sharded_phase_decode_fn(mesh, plan, dtype=torch.float64)(
        shard_array(torch.from_numpy(args[0]).double(), mesh)).gather()
    got = run_port("longform-phase-dec", args)[0].double()
    peak = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * peak


@pytest.mark.parametrize("name", SINGLE + LONG)
def test_artifact_bit_equal_to_live_path(name):
    args = inputs(name)
    got = run_port(name, args)
    want = _live(name, args)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("name", SINGLE + LONG)
def test_header_matches_jax(name, tmp_path):
    cfg, jcfg = ((CFG, JCFG) if "mel" in name else (PCFG, JPCFG))
    p, jp = str(tmp_path / "port.gmexp"), str(tmp_path / "jax.jaxexp")
    ts.save_exported(artifact(name), p,
                     ts.artifact_meta(artifact(name), cfg, kind=name))
    js.save_exported(artifact(name, True), jp,
                     js.artifact_meta(artifact(name, True), jcfg, kind=name))
    meta, jmeta = ts.read_artifact_meta(p), js.read_artifact_meta(jp)
    # the keys' uint32 bits go in as int32 (serving.py's docstring)
    jmeta["in_dtypes"] = ["int32" if d == "uint32" else d
                          for d in jmeta["in_dtypes"]]
    for key in jmeta:
        assert meta[key] == jmeta[key], key
    loaded = ts.load_exported(p)
    assert loaded.in_shapes == meta["in_shapes"]
    assert loaded.out_shapes == meta["out_shapes"]
    assert loaded.in_dtypes == meta["in_dtypes"]


@pytest.mark.parametrize("builder, kw, bound", [
    ("export_mel_encoder", dict(seconds=0.05, sample_rate=8000), "f64"),
    ("export_phase_encoder", dict(seconds=0.1), "f64"),
    ("export_phase_decoder", dict(n_frames=10), "f64"),
])
def test_float64_artifact_matches_jax(builder, kw, bound):
    cfg, jcfg = (CFG, JCFG) if "mel" in builder else (PCFG, JPCFG)
    port = getattr(ts, builder)(cfg, dtype=torch.float64, device="cpu", **kw)
    jexp = getattr(js, builder)(jcfg, dtype=jnp.float64, platforms=CPU, **kw)
    shape = [2 if d == "b" else int(d) for d in port.in_shapes[0]]
    x = np.random.RandomState(21).randn(*shape)
    got = port.call(torch.from_numpy(x))
    assert got.dtype == torch.float64
    assert_near(bound, got.numpy(), np.asarray(jexp.call(jnp.asarray(x))))


def test_symbolic_batch_serves_two_sizes_and_pinned_rejects_a_third(tmp_path):
    p = str(tmp_path / "enc.gmexp")
    ts.save_exported(artifact("mel-enc"), p)
    art = ts.load_exported(p)
    n = int(art.in_shapes[0][1])
    fwd = torch.tensor(mel_weights(CFG.n_bins, 32, CFG.mel_fmin,
                                   CFG.mel_fmax), dtype=torch.float32)
    for b in (1, 3):
        x = torch.from_numpy(_audio(b, n, seed=b))
        want = mel_ops.mel_encode_batch(x, 32, 256, 64, fwd)
        assert torch.equal(art.call(x), want)
    pinned = ts.export_mel_encoder(CFG, seconds=0.05, sample_rate=8000,
                                   batch=2, device="cpu")
    assert pinned.in_shapes[0][0] == "2"
    pinned.call(torch.from_numpy(_audio(2, n)))
    with pytest.raises(ValueError, match="has shape"):
        pinned.call(torch.from_numpy(_audio(3, n)))
    with pytest.raises(ValueError, match="float32"):
        art.call(torch.zeros((2, n), dtype=torch.float64))


def test_loaded_module_composes_inside_a_larger_module():
    art = artifact("mel-enc")
    n = int(art.in_shapes[0][1])
    x = torch.from_numpy(_audio(2, n, seed=4))

    class Pooled(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.enc = art.module()

        def forward(self, v):
            return self.enc(v).mean(dim=(1, 3))

    got = Pooled()(x)
    torch.testing.assert_close(got, art.call(x).mean(dim=(1, 3)), rtol=0,
                               atol=0)


def _saved(tmp_path, name="mel-enc"):
    p = tmp_path / "a.gmexp"
    ts.save_exported(artifact(name), str(p),
                     ts.artifact_meta(artifact(name), CFG, kind=name))
    return p


def test_load_rejects_a_jax_artifact(tmp_path):
    jp = str(tmp_path / "jax.jaxexp")
    jexp = artifact("mel-enc", jax_side=True)
    js.save_exported(jexp, jp, js.artifact_meta(jexp, JCFG, kind="mel-enc"))
    with pytest.raises(ValueError, match="JAX"):
        ts.load_exported(jp)
    # the header of a JAX artifact reads as the JAX package reads it
    assert ts.read_artifact_meta(jp) == js.read_artifact_meta(jp)


def test_jax_v1_artifact_is_rejected_and_has_an_empty_header(tmp_path):
    p = str(tmp_path / "v1.jaxexp")
    with open(p, "wb") as f:
        f.write(b"GMTPUEXP1\n")
        f.write(artifact("mel-enc", jax_side=True).serialize())
    assert ts.read_artifact_meta(p) == {}
    with pytest.raises(ValueError, match="JAX"):
        ts.load_exported(p)


def test_load_rejects_a_foreign_file(tmp_path):
    p = tmp_path / "not_an_artifact.bin"
    p.write_bytes(b"PNG\x00junk")
    with pytest.raises(ValueError, match="not a gomel_tpu_torch serving"):
        ts.load_exported(str(p))
    with pytest.raises(ValueError, match="not a gomel_tpu_torch serving"):
        ts.read_artifact_meta(str(p))


@pytest.mark.parametrize("cut", ["length", "header", "program"])
def test_load_rejects_a_truncated_file(tmp_path, cut):
    p = _saved(tmp_path)
    data = p.read_bytes()
    (hlen,) = struct.unpack("<I", data[len(ts.MAGIC):len(ts.MAGIC) + 4])
    end = {"length": len(ts.MAGIC) + 2,
           "header": len(ts.MAGIC) + 4 + hlen // 2,
           "program": len(data) - 1000}[cut]
    p.write_bytes(data[:end])
    match = "truncated or corrupt program" if cut == "program" else (
        "truncated artifact header")
    with pytest.raises(ValueError, match=match):
        ts.load_exported(str(p))


def test_loading_a_card_artifact_without_a_card_raises(tmp_path):
    p = _saved(tmp_path)
    data = p.read_bytes()
    start = len(ts.MAGIC) + 4
    (hlen,) = struct.unpack("<I", data[len(ts.MAGIC):start])
    header = json.loads(data[start:start + hlen])
    header.update(device="cuda:0", platforms=["cuda"])
    head = json.dumps(header).encode()
    p.write_bytes(ts.MAGIC + struct.pack("<I", len(head)) + head
                  + data[start + hlen:])
    assert ts.read_artifact_meta(str(p))["platforms"] == ["cuda"]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="not available"):
        ts.load_exported(str(p))
    with pytest.raises(RuntimeError, match="not available"):
        ts.export_mel_encoder(CFG, seconds=0.05, sample_rate=8000)


def test_phase_artifacts_reconstruct_band_limited_audio(tmp_path):
    """Encode then decode through saved and loaded artifacts: tones well
    inside the kept bins (100 of 128) come back with correlation > 0.99."""
    enc = artifact("phase-enc")
    n = int(enc.in_shapes[0][1])
    t = np.arange(n) / PCFG.sample_rate
    x = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                  0.3 * np.sin(2 * np.pi * 660 * t)]).astype(np.float32)
    spec = enc.call(torch.from_numpy(x))
    dec = ts.export_phase_decoder(PCFG, n_frames=spec.shape[1], batch=2,
                                  device="cpu")
    p = str(tmp_path / "pd.gmexp")
    ts.save_exported(dec, p)
    wav = ts.load_exported(p).call(spec).numpy()
    m = PCFG.resolut
    for i in range(2):
        c = np.corrcoef(x[i][m:n - m], wav[i][m:n - m])[0, 1]
        assert c > 0.99, f"row {i}: corr {c}"


def test_phase_encoder_cli_preset_requires_explicit_sample_rate():
    cfg = PhaseConfig.cli_default(resolut=256, window=64, num_freqs=100)
    with pytest.raises(ValueError, match="sample_rate must be set"):
        ts.export_phase_encoder(cfg, seconds=0.1, device="cpu")
    exp = ts.export_phase_encoder(cfg, seconds=0.1, sample_rate=8000,
                                  batch=1, device="cpu")
    assert int(exp.in_shapes[0][1]) >= int(0.1 * 8000)


def test_longform_batch_must_match_data_axis():
    mesh = make_mesh(data=2, frame=4, devices=CPU8)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        ts.export_longform_mel_encoder(CFG, mesh, n_frames=20, batch=3)


def test_call_longform_rejects_a_mesh_of_another_size():
    small = make_mesh(data=1, frame=4, devices=CPU8[:4])
    exp = artifact("longform-phase-enc")
    with pytest.raises(ValueError, match="exported for 8"):
        ts.call_longform(exp, small, *inputs("longform-phase-enc"))
    with pytest.raises(ValueError, match="not a long-form artifact"):
        ts.call_longform(artifact("phase-enc"), small, np.zeros((2, 10)))


def test_longform_encoder_at_a_chunked_shard_size():
    """The shard size at which the JAX program chunks its analysis
    (frame_chunk "auto", 3072 frames a shard and more): the port's program
    runs one launch a shard, the same values."""
    mesh = make_mesh(data=2, frame=4, devices=CPU8)
    cfg = MelConfig(num_mels=8, resolut=64, window=16)
    n_frames = 4 * 3100
    exp = ts.export_longform_mel_encoder(cfg, mesh, n_frames=n_frames,
                                         batch=2)
    plan = ts.longform_plan(cfg, mesh, n_frames)
    assert plan.frames_per_shard >= 3072
    x = _audio(2, plan.sharded_signal_len, seed=5)
    got = ts.call_longform(exp, mesh, x).gather()
    w = mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin, cfg.mel_fmax)
    want = tsh.sharded_mel_encode_fn(mesh, plan, 8, w)(shard_array(x, mesh))
    assert torch.equal(got, want.gather())
    jw = js.export_longform_mel_encoder(JMelConfig(num_mels=8, resolut=64,
                                                   window=16),
                                        jmake_mesh(data=2, frame=4),
                                        n_frames=n_frames, batch=2,
                                        platforms=CPU)
    ref = np.asarray(js.call_longform(jw, jmake_mesh(data=2, frame=4), x))
    # at 32 bins two float32 FFTs differ by up to 6e-3 in the log of a few
    # quiet bands: the mel energies within 1e-5 of their peak
    # (tests/test_torch_mel.py's rule)
    e_got, e_ref = np.exp(got.double().numpy()), np.exp(ref.astype(np.float64))
    np.testing.assert_allclose(e_got, e_ref, rtol=0, atol=1e-5 * e_ref.max())


MM = {"mel-enc": "export_mel_encoder", "mel-dec": "export_mel_decoder",
      "phase-enc": "export_phase_encoder",
      "phase-dec": "export_phase_decoder",
      "mel-dec-q": "export_mel_decoder_quantized"}


@pytest.mark.parametrize("name", list(MM))
def test_mm_route_matches_jax_and_the_live_path(name):
    """fft_backend="mm" (the matmul DFT, kernels KN/KO on the card): the
    artifact against the JAX builder's "mm" and bit for bit against the
    port's eager "mm" path; off the TPU both run it in exact float32."""
    kw = {"mel-enc": dict(seconds=0.05, sample_rate=8000),
          "phase-enc": dict(seconds=0.1)}.get(name, dict(n_frames=11))
    if name == "phase-dec":
        kw = dict(n_frames=10)
    cfg, jcfg = (CFG, JCFG) if "mel" in name else (PCFG, JPCFG)
    port = getattr(ts, MM[name])(cfg, fft_backend="mm", device="cpu", **kw)
    jexp = getattr(js, MM[name])(jcfg, fft_backend="mm", platforms=CPU,
                                 **kw)
    args = inputs(name)
    if name in ("mel-enc", "phase-enc"):
        args = (_audio(2, int(port.in_shapes[0][1]), seed=31),)
    got = port.call(*(torch.from_numpy(_int32_bits(a)) for a in args))
    got = got if isinstance(got, tuple) else (got,)
    want = jexp.call(*(jnp.asarray(a) for a in args))
    want = want if isinstance(want, (tuple, list)) else (want,)
    for kind, g, w in zip(BOUNDS[name], got, want):
        assert_near(kind, g.numpy(), np.asarray(w))
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    inv = torch.tensor(inverse_mel_weights(CFG.n_bins, 32, CFG.mel_fmin,
                                           CFG.mel_fmax), dtype=torch.float32)
    fwd = torch.tensor(mel_weights(CFG.n_bins, 32, CFG.mel_fmin,
                                   CFG.mel_fmax), dtype=torch.float32)
    if name == "mel-enc":
        live = (mel_ops.mel_encode_batch(t[0], 32, 256, 64, fwd,
                                         fft_backend="mm"),)
    elif name == "phase-enc":
        live = (phase_ops.phase_encode_batch(t[0], 100, 256, 64,
                                             fft_backend="mm"),)
    elif name == "phase-dec":
        live = (phase_ops.phase_decode(t[0], 256, 64, fft_backend="mm"),)
    elif name == "mel-dec":
        live = (mel_ops.mel_decode(t[0], 256, 64, inv, 2, key=args[1],
                                   fft_backend="mm"),)
    else:
        mag = mel_ops.mel_to_magnitudes(t[0], inv, mgc_max=t[1],
                                        mgc_min=t[2])
        live = griffinlim.griffin_lim(mag, 64, 2, key=args[3],
                                      fft_backend="mm", pcm16=True)
    for g, w in zip(got, live):
        assert torch.equal(g, w)


def test_longform_interior_mm_matches_the_live_program():
    mesh = make_mesh(data=2, frame=4, devices=CPU8)
    exp = ts.export_longform_mel_decoder(CFG, mesh, n_frames=25, batch=2,
                                         interior_mm=True, momentum=0.99)
    lm, key = inputs("longform-mel-dec")
    got = ts.call_longform(exp, mesh, lm, key).gather()
    plan = ts.longform_plan(CFG, mesh, 25)
    inv = inverse_mel_weights(CFG.n_bins, 32, CFG.mel_fmin, CFG.mel_fmax)
    want = tsh.sharded_mel_decode_fn(mesh, plan, inv, 2, momentum=0.99,
                                     interior_mm=True)(
        shard_array(lm, mesh), (int(key[0]) << 32) | int(key[1])).gather()
    assert torch.equal(got, want)
    jexp = js.export_longform_mel_decoder(JCFG, jmake_mesh(data=2, frame=4),
                                          n_frames=25, batch=2,
                                          momentum=0.99, platforms=CPU)
    ref = np.asarray(js.call_longform(jexp, jmake_mesh(data=2, frame=4), lm,
                                      key))
    assert_near("f32", got.numpy(), ref)


@pytest.mark.parametrize("name", LONG)
def test_longform_artifact_keeps_its_bits_through_save_and_load(name,
                                                                tmp_path):
    """A one-device long-form artifact's file holds its single program, then
    its per-shard pieces: loaded, the single program (call_longform on the
    mesh it was built on) and the pieces both give the built artifact's
    bits."""
    args = inputs(name)
    want = run_port(name, args)[0]
    p = str(tmp_path / "a.gmexp")
    ts.save_exported(artifact(name), p)
    sections = [s[0] for s in ts.read_artifact_meta(p)["sections"]]
    assert sections[0] == "program" and all(
        s.startswith("piece:") for s in sections[1:])
    loaded = ts.load_exported(p)
    mesh = make_mesh(data=2, frame=4, devices=CPU8)
    assert torch.equal(ts.call_longform(loaded, mesh, *args).gather(), want)
    flat = [shard_array(args[0], mesh)]
    if len(args) > 1:
        flat.append(torch.from_numpy(_int32_bits(args[1])))
    pieces = Sharded(mesh, loaded.longform.run(mesh, flat)).gather()
    assert torch.equal(pieces, want)


def test_artifact_records_the_jax_fields_and_its_device(tmp_path):
    p = _saved(tmp_path)
    meta = ts.read_artifact_meta(str(p))
    assert meta["kind"] == "mel-enc" and meta["device"] == "cpu"
    assert meta["config"] == dataclasses.asdict(CFG)
    assert meta["config_class"] == "MelConfig"
    assert p.read_bytes().startswith(ts.MAGIC)


# -- the custom ops -----------------------------------------------------------

def _op_cases():
    """(label, op, args) at a small shape: every op, each mode."""
    rng = np.random.default_rng(0)
    n, hop, m = 64, 16, 8
    x = torch.tensor(rng.standard_normal((2, hop * 10 + n)),
                     dtype=torch.float32)
    win = torch.tensor(hann_window(n), dtype=torch.float32)
    tw, tw_pass = rfft_mag.fft_tables(n, torch.device("cpu"))
    plan = rfft_mag.fft_plan_args(n)
    w = torch.tensor(mel_weights(n // 2, m, 0.0, 4000.0), dtype=torch.float32)
    we = torch.from_numpy(mel_ops.extended_weights_np(w.numpy()))
    band = mel_ops.mel_band_plan(w.numpy())
    slots, bw = torch.from_numpy(band.slots), torch.from_numpy(band.weights)
    mags = rfft_mag.stft_mag_plain(x, win, n, hop)
    lm = mel_ops.mel_from_ext_plain(mags, we)
    sp = rfft_mag.stft_planes_plain(x, win, n, hop, 1, 20)
    img, mx, mn = quantize.quantize_planes_plain(sp, 255, 0)
    img16 = quantize.quantize_planes_plain(sp, 65535, 1)
    re, im = torch.randn(2, 10, n // 2 + 1), torch.randn(2, 10, n // 2 + 1)
    fw = istft.irfft_window_plain(re, im, n, win)
    prefix = istft._prefix_rows(win, hop)
    thr = istft.window_sum_threshold(prefix, 10)
    short = istft.window_sum_short(prefix.shape[0], 10)
    inv = torch.tensor(inverse_mel_weights(n // 2, m, 0.0, 4000.0),
                       dtype=torch.float32)
    runs = tuple(torch.from_numpy(t) for t in mel_ops.mel_runs_np(
        inv.numpy()))
    lmq = quantize.quantize_mel_plane_plain(lm)
    mag = mel_ops.mel_to_magnitudes_plain(lm, inv)
    sig = torch.rand(2, n + (mag.shape[1] - 1) * hop)
    gfw = griffinlim.gl_project_plain(sig, mag, win, n, hop)
    keys = torch.from_numpy(np.stack([prng.key(1), prng.key(2)])
                            .view(np.int32))
    ext, recv = torch.randn(2, 160 + n - hop), torch.randn(2, n - hop)
    return [
        ("stft_mel_log", OPS.stft_mel_log.default,
         (x, win, we, tw, tw_pass, slots, bw, n, hop, m, band.groups, *plan)),
        ("stft_mag", OPS.stft_mag.default, (x, win, tw, tw_pass, n, hop,
                                            *plan)),
        ("mel_log", OPS.mel_log.default, (mags, we, slots, bw, m,
                                          band.groups)),
        ("quantize_mel", OPS.quantize_mel.default, (lm, 255)),
        ("stft_planes", OPS.stft_planes.default,
         (x, win, tw, tw_pass, n, hop, 1, 20, *plan)),
        ("quantize_planes", OPS.quantize_planes.default, (sp, 255, 0)),
        ("quantize_planes uint16 ihs", OPS.quantize_planes.default,
         (sp, 65535, 1)),
        ("irfft_window planes", OPS.irfft_window.default,
         (istft.MODE_PLANES, re, im, None, win, tw, tw_pass, n, 0.0, 0, 7,
          *plan)),
        ("irfft_window spectrogram", OPS.irfft_window.default,
         (istft.MODE_SPEC, sp, None, None, win, tw, tw_pass, n, 0.0, 0, -1,
          *plan)),
        ("irfft_window uint8", OPS.irfft_window.default,
         (istft.MODE_QUANT8, img, mx, mn, win, tw, tw_pass, n, 255.0, 0, -1,
          *plan)),
        ("irfft_window uint16", OPS.irfft_window.default,
         (istft.MODE_QUANT16, *img16, win, tw, tw_pass, n, 65535.0, 1, -1,
          *plan)),
        ("overlap_normalize", OPS.overlap_normalize.default,
         (fw, prefix, win, hop, thr, short, 1.5, False)),
        ("overlap_normalize pcm16", OPS.overlap_normalize.default,
         (fw, prefix, win, hop, thr, short, 0.0, True)),
        ("overlap_normalize overlap-add", OPS.overlap_normalize.default,
         (fw, None, None, hop, 0.0, False, 0.0, False)),
        ("mel_to_mag", OPS.mel_to_mag.default,
         (lm, None, None, inv, *runs, 255, 0.0, 1.0, 0.0)),
        ("mel_to_mag uint8", OPS.mel_to_mag.default,
         (lmq[0], lmq[1], lmq[2], inv, *runs, 255, 1.5, 1.5, 0.25)),
        ("gl_project", OPS.gl_project.default,
         (sig, mag, win, tw, tw_pass, n, hop, *plan)),
        ("gl_overlap_add", OPS.gl_overlap_add.default,
         (gfw, None, hop, 0.0, False)),
        ("gl_overlap_add momentum", OPS.gl_overlap_add.default,
         (gfw, sig, hop, 0.99, False)),
        ("gl_overlap_add pcm16", OPS.gl_overlap_add.default,
         (gfw, None, hop, 0.0, True)),
        ("threefry_uniform", OPS.threefry_uniform.default,
         (keys, 100, torch.float32)),
        ("threefry_uniform float64", OPS.threefry_uniform.default,
         (keys, 33, torch.float64)),
        ("shard_epilogue normalize", OPS.shard_epilogue.default,
         (ext, recv, prefix, None, 160, hop, 160, 30, thr, 1.5, 0.0,
          False)),
        ("shard_epilogue momentum", OPS.shard_epilogue.default,
         (ext, None, None, torch.randn(2, 160), 160, hop, 0, 0, 0.0, 0.0,
          0.99, False)),
        ("shard_epilogue pcm16", OPS.shard_epilogue.default,
         (ext, recv, prefix, None, 160, hop, 160, 30, thr, 0.0, 0.0,
          True)),
    ]


_OP_CASES = _op_cases()


@pytest.mark.parametrize("case", range(len(_OP_CASES)),
                         ids=[c[0] for c in _OP_CASES])
def test_opcheck(case):
    _, op, args = _OP_CASES[case]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("case", range(len(_OP_CASES)),
                         ids=[c[0] for c in _OP_CASES])
def test_op_cpu_kernel_is_the_plain_version(case):
    """Each op's CPU kernel gives its eager wrapper's CPU result, the plain
    version's, bit for bit."""
    label, op, args = _OP_CASES[case]
    got = op(*args)
    name = label.split()[0]
    want = _PLAIN[name](*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(g, w), label


def _plain_irfft(mode, src, aux0, aux1, window, tw, tw_pass, n, max_val,
                 ihs, real_frames, *plan):
    rf = None if real_frames < 0 else real_frames
    if mode == istft.MODE_PLANES:
        return istft.irfft_window_plain(src, aux0, n, window, rf)
    if mode != istft.MODE_SPEC:
        src = quantize.dequantize_planes(src, aux0, aux1, max_val, ihs)
    return istft.irfft_window_plain(*phase_ops.grow_half_planes(src, n // 2),
                                    n, window, rf)


def _plain_ola(fw, table, window, hop, thr, short, boost, pcm16):
    if window is None:
        return istft.overlap_add_plain(fw, hop), None
    out = istft.overlap_normalize_plain(fw, hop, window, boost, pcm16)
    return out if pcm16 else (out, None)


def _plain_gl_ola(fw, t_prev, hop, momentum, pcm16):
    return griffinlim.gl_overlap_add(fw, hop, t_prev, momentum, pcm16)


def _plain_epilogue(ext, recv, table, t_prev, chunk, hop, start, n_frames,
                    thr, boost, momentum, pcm16):
    window = None if table is None else torch.tensor(hann_window(64),
                                                     dtype=torch.float32)
    return istft.shard_epilogue(ext, recv, chunk, window=window, hop=hop,
                                start=start, n_frames=n_frames,
                                volume_boost=boost, t_prev=t_prev,
                                momentum=momentum, pcm16=pcm16)


_PLAIN = {
    "stft_mel_log": lambda x, win, we, *a: mel_ops.mel_from_ext_plain(
        rfft_mag.stft_mag(x, win, a[4], a[5]), we),
    "stft_mag": lambda x, win, tw, twp, n, hop, *p: rfft_mag.stft_mag(
        x, win, n, hop),
    "mel_log": lambda mags, we, *a: mel_ops.mel_from_ext_plain(mags, we),
    "quantize_mel": lambda s, v: quantize.quantize_mel_plane_batch(s, v),
    "stft_planes": lambda x, win, tw, twp, n, hop, first, count, *p:
        rfft_mag.stft_planes(x, win, n, hop, first, count),
    "quantize_planes": quantize.quantize_planes_batch,
    "irfft_window": _plain_irfft,
    "overlap_normalize": _plain_ola,
    "mel_to_mag": lambda src, mx, mn, inv, f, c, t, v, boost, tm, ta:
        mel_ops.mel_to_magnitudes(src, inv, tm, ta, boost, mx, mn, v),
    "gl_project": lambda sig, mag, win, tw, twp, n, hop, *p:
        griffinlim.gl_project(sig, mag, win, n, hop),
    "gl_overlap_add": _plain_gl_ola,
    "threefry_uniform": lambda k, per_key, dtype: prng.uniform(
        k.numpy().view(np.uint32), (per_key,), dtype, "cpu"),
    "shard_epilogue": _plain_epilogue,
}


def test_ops_have_both_kernels_and_a_fake():
    """Every op of ops/library.py registers a CUDA kernel, a CPU kernel and
    a fake."""
    names = ("stft_mel_log", "stft_mag", "mel_log", "quantize_mel",
             "stft_planes", "quantize_planes", "irfft_window",
             "overlap_normalize", "mel_to_mag", "gl_project",
             "gl_overlap_add", "threefry_uniform", "shard_epilogue")
    for name in names:
        op = getattr(library, name)
        kernels = op._backend_fns
        assert {"cpu", "cuda"} <= set(kernels), (name, kernels)
        assert op._abstract_fn is not None, name
