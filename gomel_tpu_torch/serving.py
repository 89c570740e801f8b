"""Serving artifacts: the codecs as ``torch.export`` programs with their
tables baked in.

Counterpart of ``gomel_tpu/serving.py``. A serving fleet wants the codec
without the package's graph-building code and without its host-side table
building at process start. Each builder here traces one codec entry point
into a ``torch.export.ExportedProgram`` whose buffers are the codec's
tables (filterbank, window, FFT twiddles, band tables, the window's prefix
rows), saves it with a self-describing header, and loads it back for
``call``:

    from gomel_tpu_torch import serving, MelConfig
    exp = serving.export_mel_encoder(MelConfig.cli_default(), seconds=30.0,
                                     sample_rate=48000, batch=None)
    serving.save_exported(exp, "mel_enc_b.gmexp", serving.artifact_meta(
        exp, MelConfig.cli_default(), kind="mel-enc"))
    # ... on the serving host:
    enc = serving.load_exported("mel_enc_b.gmexp")
    logmel = enc.call(audio)              # [B, 1440000] -> [B, F, 192, 2]

The programs call the hand-written kernels as ``torch.library`` custom ops
(ops/library.py): on the card each op launches its CUDA kernel, on the CPU
its plain PyTorch version, so an artifact computes what the eager path
computes on its device, bit for bit.

Decisions:
- **Static audio length per artifact** (``seconds`` / ``n_frames``),
  rounded up to the reference padding grid (``padded_samples``), as in the
  JAX package: serving fleets bucket by length anyway.
- **Symbolic batch by default** (``batch=None``): one artifact serves every
  batch size >= 1; an int pins it, and a call at another batch raises
  ``ValueError``.
- **``fft_backend`` defaults to ``"auto"`` in every builder**, and takes
  every JAX name. The JAX defaults (``"mxu"`` to encode, ``"mm"`` for the
  Griffin-Lim decode) were chosen on a TPU. ``"auto"`` resolves as on the
  card (ops/fftbackend.resolve with ``"cuda"``), whatever device the
  artifact is built for: the hand FFT kernels (the fused KB + KC for the
  mel encode where n/2 is a power of two, KJ + KK for Griffin-Lim) at every
  size they take, the xla route (``torch.fft``, traced into the program) at
  the others; ``"mm"`` is the matmul DFT (KN, KO; in bf16 inside
  Griffin-Lim, whose interior iteration takes 6.6x the time of KJ + KK on
  the H100, PERF.md section 5). The CPU artifact follows the card's route
  with the plain versions, which is what the eager CPU path computes.
- **``platforms`` becomes ``device``**: ``"cuda"`` by default (raises
  without a card); the tests pass ``device="cpu"``. The header records it
  (``"platforms": ["cuda"]``), and :func:`load_exported` runs an artifact
  on the device it was built for and raises when that is absent: it never
  moves a card artifact to the CPU.
- **Keys are inputs**: the mel decoders take keys [B, 2] with the JAX
  package's uint32 bits (row r draws its Griffin-Lim start from key r,
  ops/prng.uniform on a key table) and the long-form mel decoder one key
  [2] that each shard folds its index into, as the JAX program does. The
  inputs are int32 holding those bits (``keys.view(np.int32)``): the
  ``torch.export`` serializer of PyTorch 2.11 has no uint32, so
  the header's ``in_dtypes`` says ``int32`` where the JAX one says
  ``uint32``; :func:`call_longform` views a uint32 key itself.
- **The artifact file** is ``GMTORCHEXP1\\n``, a little-endian u32 header
  length, the JSON header (:func:`artifact_meta`: the JAX fields ``kind``,
  ``platforms``, ``nr_devices``, ``in_shapes`` with ``"b"`` for the symbolic
  batch, ``in_dtypes``, ``out_shapes``, ``config``, ``config_class``), then
  the ``torch.export.save`` bytes. :func:`read_artifact_meta` reads only the
  header, also of a JAX artifact (the same layout after ``GMTPUEXP2\\n``);
  :func:`load_exported` raises ``ValueError`` for a JAX artifact, a foreign
  file or a truncated one, and says which.
- **Long form** (``export_longform_*``): the program takes one tensor a
  shard of ``mesh`` (``make_mesh``; a key [2] last for the mel decoder)
  and returns one a shard, the port's sharded functions
  (parallel/sharded.py) traced at one plan; :func:`call_longform` shards
  host inputs and returns ``Sharded`` results. The artifact records the
  mesh's size and shape and runs on a mesh of that size whose shards share
  the artifact's device (four frame shards of one card, or of the CPU).
  The window-sum threshold is one global value of the plan.

A loaded artifact composes: ``exp.module()`` is an ``nn.Module`` to call
inside a larger one.
"""
from __future__ import annotations

import dataclasses
import inspect
import io
import json
import struct

import numpy as np
import torch
from torch.export import Dim

from .core.config import MelConfig, PhaseConfig
from .core.filterbank import inverse_mel_weights, mel_weights
from .core.framing import pad_length
from .ops import (_cuda, dft_mm, fftbackend, istft, library, mel_ops, prng,
                  rfft_mag)
from .ops.griffinlim import gl_project_plain
from .ops.phase_ops import grow_half_planes
from .ops.quantize import pcm16_encode
from .ops.stft import hann_window, num_frames_of

OPS = getattr(torch.ops, library.NS)
DEFAULT_DEVICE = "cuda"
MAGIC = b"GMTORCHEXP1\n"
_JAX_MAGICS = (b"GMTPUEXP2\n", b"GMTPUEXP1\n")


# -- shapes -------------------------------------------------------------------

def padded_samples(seconds: float, sample_rate: int, hop: int) -> int:
    """Audio length an artifact accepts: ``seconds`` rounded up to the
    reference padding grid (core/framing.pad_length)."""
    return pad_length(int(round(seconds * sample_rate)), hop)


def _device(device) -> torch.device:
    dev = _cuda.require_device(device, "serving")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"serving: device {dev} is neither cuda nor cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _batch(batch) -> tuple[int, Dim | None]:
    """(the example batch, the symbolic dimension or None when pinned)."""
    if batch is None:
        return 2, Dim("b", min=1)
    if int(batch) <= 0:
        raise ValueError(f"batch must be positive or None, got {batch}")
    return int(batch), None


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _sample_rate(config: PhaseConfig, sample_rate: int) -> int:
    sr = int(sample_rate) or config.sample_rate
    if sr <= 0:
        raise ValueError("sample_rate must be set (argument or config) to "
                         "size the artifact's audio input")
    return sr


# -- the artifact -------------------------------------------------------------

def _dims(shape) -> list[str]:
    return [str(d) if isinstance(d, int) else "b" for d in shape]


class Exported:
    """A built or loaded artifact: the program, its device and its input
    layout. ``call(*args)`` checks the inputs against the program's and
    runs it; ``module()`` is the program as an ``nn.Module``."""

    def __init__(self, program: torch.export.ExportedProgram,
                 device: torch.device, nr_devices: int = 1,
                 mesh_shape: tuple[int, int] | None = None,
                 sharded: tuple[bool, ...] | None = None):
        self.program = program
        self.device = torch.device(device)
        self.nr_devices = int(nr_devices)
        self.mesh_shape = None if mesh_shape is None else tuple(mesh_shape)
        self.sharded = None if sharded is None else tuple(sharded)
        self._module = None
        names = set(program.graph_signature.user_inputs)
        self._flat_in = [n.meta["val"] for n in program.graph.nodes
                         if n.op == "placeholder" and n.name in names]
        out = next(n for n in program.graph.nodes if n.op == "output")
        self._flat_out = [v.meta["val"] for v in out.args[0]]

    @property
    def platforms(self) -> list[str]:
        return [self.device.type]

    def _global(self, vals, sharded) -> list[list[str]]:
        """Shapes of the logical inputs or outputs: a long-form artifact's
        shards joined over its mesh."""
        if self.mesh_shape is None:
            return [_dims(v.shape) for v in vals]
        n_data, n_frame = self.mesh_shape
        shapes, i = [], 0
        for s in sharded:
            shape = _dims(vals[i].shape)
            if s:
                shape[0] = str(int(shape[0]) * n_data)
                shape[1] = str(int(shape[1]) * n_frame)
                i += self.nr_devices
            else:
                i += 1
            shapes.append(shape)
        return shapes

    @property
    def in_shapes(self) -> list[list[str]]:
        return self._global(self._flat_in, self.sharded or ())

    @property
    def in_dtypes(self) -> list[str]:
        if self.mesh_shape is None:
            return [_dtype_name(v.dtype) for v in self._flat_in]
        idx = np.cumsum([0] + [self.nr_devices if s else 1
                               for s in self.sharded])[:-1]
        return [_dtype_name(self._flat_in[i].dtype) for i in idx]

    @property
    def out_shapes(self) -> list[list[str]]:
        n_out = (len(self._flat_out) if self.mesh_shape is None
                 else len(self._flat_out) // self.nr_devices)
        return self._global(self._flat_out, (True,) * n_out)

    def module(self) -> torch.nn.Module:
        if self._module is None:
            self._module = self.program.module()
        return self._module

    def check_args(self, args) -> None:
        """Raise ValueError unless ``args`` are the program's inputs: count,
        device, dtype, rank, static sizes, and one batch size >= 1."""
        specs = self._flat_in
        if len(args) != len(specs):
            raise ValueError(f"artifact takes {len(specs)} inputs "
                             f"{[_dims(v.shape) for v in specs]}, got "
                             f"{len(args)}")
        batch = None
        for i, (a, v) in enumerate(zip(args, specs)):
            want = _dims(v.shape)
            if not isinstance(a, torch.Tensor):
                raise ValueError(f"input {i}: expected a tensor, got "
                                 f"{type(a).__name__}")
            if a.device != self.device:
                raise ValueError(f"input {i} is on {a.device}; the artifact "
                                 f"runs on {self.device}")
            if a.dtype != v.dtype:
                raise ValueError(f"input {i} is {_dtype_name(a.dtype)}; the "
                                 f"artifact takes {_dtype_name(v.dtype)}")
            got = [str(d) for d in a.shape]
            if len(got) != len(want) or any(
                    w != "b" and w != g for w, g in zip(want, got)):
                raise ValueError(f"input {i} has shape {got}; the artifact "
                                 f"takes {want}")
            for w, g in zip(want, a.shape):
                if w == "b":
                    if batch is not None and g != batch:
                        raise ValueError(f"inputs disagree on the batch: "
                                         f"{batch} and {g}")
                    batch = g
        if batch is not None and batch < 1:
            raise ValueError("the batch must be at least 1")

    def call(self, *args):
        self.check_args(args)
        return self.module()(*args)


def _export(module: torch.nn.Module, example: tuple, b_dim: Dim | None,
            device: torch.device, **layout) -> Exported:
    """Trace ``module`` at ``example`` with dimension 0 of every input
    symbolic when ``b_dim`` is given."""
    dynamic = None
    if b_dim is not None:
        dynamic = tuple({0: b_dim} for _ in example)
        params = inspect.signature(module.forward).parameters.values()
        if any(p.kind is p.VAR_POSITIONAL for p in params):
            dynamic = (dynamic,)    # a forward(*args) takes one tuple
    program = torch.export.export(module.eval(), example,
                                  dynamic_shapes=dynamic)
    program.example_inputs = None   # else saved with the artifact
    return Exported(program, device, **layout)


# -- the programs -------------------------------------------------------------

class _Codec(torch.nn.Module):
    """Buffers and steps shared by the programs: the window, the tables of
    n on the card's route (``route``: ops/fftbackend.resolve of
    ``fft_backend`` on "cuda"), and one method a kernel, each on the route
    of the eager wrapper. On the ``mm`` route the DFT weights of the
    directions ``dft`` names are the device's: the kernels' layout on the
    card, the float master on the CPU (``w_*_k``, ``w_*_p``; the other
    None)."""

    def __init__(self, n: int, hop: int, dtype: torch.dtype,
                 device: torch.device, fft_backend: str = "auto",
                 gl: bool = False, dft: tuple[str, ...] = ("fwd", "inv")):
        super().__init__()
        self.n, self.hop = n, hop
        self.route = fftbackend.resolve(
            "auto_lowp" if gl and fft_backend == "auto" else fft_backend, n,
            "cuda")
        self.register_buffer("window", self._t(hann_window(n), dtype,
                                               device))
        # the hand FFT kernels' route: the transforms', or on the mm route
        # the Griffin-Lim's final exact inverse (ops/griffinlim.gl_project)
        self.fft_route = (fftbackend.resolve("auto", n, "cuda")
                          if self.route == "mm" else self.route)
        if self.fft_route == "mxu" and (self.route != "mm" or gl):
            tw, tw_pass = rfft_mag.fft_tables(n, torch.device("cpu"))
            self.register_buffer("tw", tw.clone().to(device))
            self.register_buffer("tw_pass", tw_pass.clone().to(device))
            self.plan = rfft_mag.fft_plan_args(n)
        if self.route == "mm":
            # Griffin-Lim folds the float64 Hann window into bf16 weights,
            # the encodes and the phase decode their window tensor into
            # float32 ones (dft_mm._weights)
            self.bf16 = gl
            fold = (hann_window(n) if gl else
                    self.window.detach().to("cpu", torch.float64).numpy())
            for direction in dft:
                plain = kernel = None
                master = dft_mm._master(direction, n, fold)
                if device.type == "cuda":
                    kernel = dft_mm.kernel_weights_tensor(
                        direction, master, n, gl).to(device)
                else:
                    plain = torch.from_numpy(master).to(dtype).to(device)
                # the other device's weights are a plain None, not a
                # buffer (torch.export miscounts None buffers)
                for name, w in ((f"w_{direction}_p", plain),
                                (f"w_{direction}_k", kernel)):
                    if w is None:
                        setattr(self, name, None)
                    else:
                        self.register_buffer(name, w)

    @staticmethod
    def _t(value, dtype, device) -> torch.Tensor:
        return torch.tensor(np.asarray(value), dtype=dtype, device=device)

    def _fft(self) -> tuple:
        return (self.tw, self.tw_pass)

    def _ola_tables(self, frames: int) -> None:
        """KH's prefix rows of the window, and the threshold and shortness
        of ``frames`` frames (ops/istft._window_table's values)."""
        prefix = istft._prefix_rows(torch.tensor(hann_window(self.n),
                                                 dtype=torch.float32),
                                    self.hop)
        self.register_buffer("prefix", prefix.to(self.window.device))
        self.threshold = istft.window_sum_threshold(prefix, frames)
        self.short = istft.window_sum_short(prefix.shape[0], frames)

    def _dft(self, x, kind: str, mag=None, first: int = 0, count: int = 0,
             final: bool = True):
        return OPS.dft_fwd(x, mag, self.w_fwd_p, self.w_fwd_k, self.n,
                           self.hop, library.DFT_KINDS.index(kind), first,
                           count, self.bf16, final)

    def stft_mag(self, x):
        if self.route == "xla":
            return rfft_mag.stft_mag_plain(x, self.window, self.n, self.hop)
        if self.route == "mm":
            return self._dft(x, "mag")[0]
        return OPS.stft_mag(x, self.window, *self._fft(), self.n, self.hop,
                            *self.plan)

    def stft_planes(self, x, first: int, count: int):
        if self.route == "xla":
            return rfft_mag.stft_planes_plain(x, self.window, self.n,
                                              self.hop, first, count)
        if self.route == "mm":
            return self._dft(x, "pairs", first=first, count=count)[0]
        return OPS.stft_planes(x, self.window, *self._fft(), self.n,
                               self.hop, first, count, *self.plan)

    def synth_spec(self, spec2, real_frames: int = -1):
        """grow + irfft x window of a phase spectrogram (KG's spectrogram
        mode)."""
        if self.route in ("xla", "mm"):
            re, im = grow_half_planes(spec2, self.n // 2)
            if self.route == "mm":
                return OPS.dft_inv(re, im, self.w_inv_p, self.w_inv_k,
                                   self.n, False, real_frames)
            return istft.irfft_window_plain(
                re, im, self.n, self.window,
                None if real_frames < 0 else real_frames)
        return OPS.irfft_window(istft.MODE_SPEC, spec2, None, None,
                                self.window, *self._fft(), self.n, 0.0, 0,
                                real_frames, *self.plan)

    def normalize(self, frames_w, boost: float, pcm16: bool):
        return OPS.overlap_normalize(frames_w, self.prefix, self.window,
                                     self.hop, self.threshold, self.short,
                                     boost, pcm16)

    def _irfft_planes(self, re, im):
        if self.fft_route == "xla":
            return istft.irfft_window_plain(re, im, self.n, self.window)
        return OPS.irfft_window(istft.MODE_PLANES, re, im, None, self.window,
                                *self._fft(), self.n, 0.0, 0, -1, *self.plan)

    def project(self, sig, mag, final: bool = False):
        """One Griffin-Lim projection (ops/griffinlim.gl_project): KJ; on
        the mm route KN's projection, then KO (``final`` False, bf16) or the
        exact inverse (KG)."""
        if self.route == "xla":
            return gl_project_plain(sig, mag, self.window, self.n, self.hop)
        if self.route == "mm":
            yr, yi = self._dft(sig, "project", mag, final=final)
            if final:
                return self._irfft_planes(yr, yi)
            half = self.n // 2 + 1
            return OPS.dft_inv(yr[..., :half], yi[..., :half],
                               self.w_inv_p, self.w_inv_k, self.n, True, -1)
        return OPS.gl_project(sig, mag, self.window, *self._fft(), self.n,
                              self.hop, *self.plan)

    def griffin_lim(self, mag, sig, n_iter: int, momentum: float,
                    pcm16: bool):
        """ops/griffinlim.griffin_lim from ``sig``: KJ + KK an iteration,
        the momentum step in KK, PCM-16 in the last KK."""
        interior = max(n_iter - 1, 0)
        if momentum != 0.0:
            t_prev = sig
            for _ in range(interior):
                sig, t_prev = OPS.gl_overlap_add(self.project(sig, mag),
                                                 t_prev, self.hop,
                                                 float(momentum), False)
        else:
            for _ in range(interior):
                sig = OPS.gl_overlap_add(self.project(sig, mag), None,
                                         self.hop, 0.0, False)[0]
        if n_iter >= 1:
            out = OPS.gl_overlap_add(self.project(sig, mag, True), None,
                                     self.hop, 0.0, pcm16)
            return out if pcm16 else out[0]
        if pcm16:
            return pcm16_encode(sig)[0], torch.isfinite(sig).all(dim=-1)
        return sig


class _MelTables(_Codec):
    """The mel encode's tables: W_ext (the plain version's) and the band
    table (KC's and the fused launch's), from the float32 filterbank; and
    the mel decode's U and KI's band runs."""

    def __init__(self, c: MelConfig, dtype, device, fft_backend="auto",
                 encode: bool = True, gl: bool = False):
        super().__init__(c.resolut, c.window, dtype, device, fft_backend, gl,
                         ("fwd", "inv") if gl else ("fwd",))
        self.mels = c.num_mels
        if encode:
            fwd = torch.tensor(mel_weights(c.n_bins, c.num_mels, c.mel_fmin,
                                           c.mel_fmax), dtype=dtype)
            self.register_buffer("ext", torch.from_numpy(
                mel_ops.extended_weights_np(fwd.numpy())).to(device))
            band = mel_ops.mel_band_plan(fwd.float().numpy())
            self.register_buffer("slots", torch.from_numpy(band.slots)
                                 .to(device))
            self.register_buffer("band_w", torch.from_numpy(band.weights)
                                 .to(device))
            self.groups = band.groups
            self.fused = mel_ops.fused_route(self.n, fft_backend, "cuda")
        else:
            inv = torch.tensor(inverse_mel_weights(
                c.n_bins, c.num_mels, c.mel_fmin, c.mel_fmax), dtype=dtype)
            self.register_buffer("inv", inv.to(device))
            for name, t in zip(("first", "count", "taps"),
                               mel_ops.mel_runs_np(inv.numpy())):
                self.register_buffer(name, torch.from_numpy(t).to(device))

    def encode(self, x):
        """mel_encode: the fused KB + KC, or KB (or the xla route) then
        KC."""
        if self.fused:
            return OPS.stft_mel_log(x, self.window, self.ext, *self._fft(),
                                    self.slots, self.band_w, self.n,
                                    self.hop, self.mels, self.groups,
                                    *self.plan)
        return OPS.mel_log(self.stft_mag(x), self.ext, self.slots,
                           self.band_w, self.mels, self.groups)

    def magnitudes(self, src, mx, mn, boost: float, c: MelConfig):
        return OPS.mel_to_mag(src, mx, mn, self.inv, self.first, self.count,
                              self.taps, 255, float(boost),
                              float(c.tune_mul), float(c.tune_add))


class _MelEncoder(_MelTables):
    def __init__(self, c, dtype, device, fft_backend, quantized):
        super().__init__(c, dtype, device, fft_backend)
        self.quantized = quantized

    def forward(self, x):
        spec = self.encode(x)
        return OPS.quantize_mel(spec, 255) if self.quantized else spec


class _MelDecoder(_MelTables):
    def __init__(self, c, dtype, device, fft_backend, momentum, n_frames,
                 quantized):
        dtype = torch.float32 if quantized else dtype
        super().__init__(c, dtype, device, fft_backend, encode=False,
                         gl=True)
        self.c, self.momentum, self.quantized = c, float(momentum), quantized
        self.out_len = self.n + (n_frames - 1) * self.hop
        self.dtype = dtype

    def forward(self, *args):
        if self.quantized:
            planes, mx, mn, keys = args
            mag = self.magnitudes(planes, mx, mn, self.c.volume_boost, self.c)
        else:
            logmel, keys = args
            mag = self.magnitudes(logmel, None, None, 0.0, self.c)
        sig = OPS.threefry_uniform(keys, self.out_len, self.dtype)
        return self.griffin_lim(mag, sig, self.c.griffin_lim_iterations,
                                self.momentum, self.quantized)


class _PhaseEncoder(_Codec):
    def __init__(self, c, dtype, device, fft_backend, quantized):
        super().__init__(c.resolut, c.window, dtype, device, fft_backend,
                         dft=("fwd",))
        self.nf, self.quantized = c.num_freqs, quantized
        self.max_val, self.ihs = (65535 if c.hdr else 255), c.ihs_passes

    def forward(self, x):
        spec = self.stft_planes(x, 1, self.nf)
        if self.quantized:
            return OPS.quantize_planes(spec, self.max_val, self.ihs)
        return spec


class _PhaseDecoder(_Codec):
    """Spectrogram (or PNG planes) -> audio (or PCM-16); the round trip
    takes audio and runs the encoder's KE first."""

    def __init__(self, c, dtype, device, fft_backend, n_frames, quantized,
                 encode_fft_backend: str | None = None):
        super().__init__(c.resolut, c.window,
                         torch.float32 if quantized else dtype, device,
                         fft_backend, dft=("inv",))
        self.c, self.quantized = c, quantized
        self.max_val, self.ihs = (65535 if c.hdr else 255), c.ihs_passes
        self.encoder = None
        if encode_fft_backend is not None:
            self.encoder = _PhaseEncoder(c, dtype, device, encode_fft_backend,
                                         False)
        self._ola_tables(n_frames)

    def forward(self, *args):
        boost = float(self.c.volume_boost)
        if self.quantized:
            planes, maxs, mins = args
            mode = (istft.MODE_QUANT16 if planes.dtype == torch.uint16
                    else istft.MODE_QUANT8)
            frames_w = OPS.irfft_window(mode, planes, maxs, mins,
                                        self.window, *self._fft(), self.n,
                                        float(self.max_val), self.ihs, -1,
                                        *self.plan)
            return self.normalize(frames_w, boost, True)
        spec2 = args[0] if self.encoder is None else self.encoder(args[0])
        return self.normalize(self.synth_spec(spec2), boost, False)[0]


# -- builders -----------------------------------------------------------------

def _signal(batch: int, n: int, dtype, device) -> torch.Tensor:
    return torch.zeros((batch, n), dtype=dtype, device=device)


def export_mel_encoder(config: MelConfig, *, seconds: float,
                       sample_rate: int, batch=None,
                       dtype: torch.dtype = torch.float32,
                       fft_backend: str = "auto",
                       device=DEFAULT_DEVICE) -> Exported:
    """[B, n_samples] audio -> [B, F, num_mels, 2] log-mel, ``n_samples =
    padded_samples(seconds, sample_rate, config.window)`` (callers pad with
    zeros to it, the reference padding content)."""
    dev = _device(device)
    n = padded_samples(seconds, sample_rate, config.window)
    b, b_dim = _batch(batch)
    module = _MelEncoder(config, dtype, dev, fft_backend, False)
    return _export(module, (_signal(b, n, dtype, dev),), b_dim, dev)


def export_mel_decoder(config: MelConfig, *, n_frames: int, batch=None,
                       dtype: torch.dtype = torch.float32,
                       fft_backend: str = "auto", momentum: float = 0.0,
                       device=DEFAULT_DEVICE) -> Exported:
    """([B, F, num_mels, 2] log-mel, [B, 2] int32 keys) -> [B, L] audio,
    L = resolut + (F - 1) * window: Griffin-Lim with the config's iteration
    count from the keys' starts (ops/griffinlim.griffin_lim with a key
    table); ``momentum`` > 0 bakes in fast Griffin-Lim (for a plain-GL(n)
    quality class, ops.griffinlim.recommended_gl(n))."""
    dev = _device(device)
    b, b_dim = _batch(batch)
    c = config
    module = _MelDecoder(c, dtype, dev, fft_backend, momentum, n_frames,
                         False)
    example = (torch.zeros((b, n_frames, c.num_mels, 2), dtype=dtype,
                           device=dev),
               torch.zeros((b, 2), dtype=torch.int32, device=dev))
    return _export(module, example, b_dim, dev)


def export_phase_encoder(config: PhaseConfig, *, seconds: float,
                         sample_rate: int = 0, batch=None,
                         dtype: torch.dtype = torch.float32,
                         fft_backend: str = "auto",
                         device=DEFAULT_DEVICE) -> Exported:
    """[B, n_samples] audio -> [B, F, num_freqs, 2] phase spectrogram (KE).
    ``sample_rate`` (else ``config.sample_rate``) sizes the input."""
    dev = _device(device)
    n = padded_samples(seconds, _sample_rate(config, sample_rate),
                       config.window)
    b, b_dim = _batch(batch)
    module = _PhaseEncoder(config, dtype, dev, fft_backend, False)
    return _export(module, (_signal(b, n, dtype, dev),), b_dim, dev)


def export_phase_decoder(config: PhaseConfig, *, n_frames: int, batch=None,
                         dtype: torch.dtype = torch.float32,
                         fft_backend: str = "auto",
                         device=DEFAULT_DEVICE) -> Exported:
    """[B, F, num_freqs, 2] phase spectrogram -> [B, L] audio: the direct
    iSTFT (KG's spectrogram mode, then KH's overlap-add, window-sum
    normalisation and boost)."""
    dev = _device(device)
    b, b_dim = _batch(batch)
    module = _PhaseDecoder(config, dtype, dev, fft_backend, n_frames, False)
    example = torch.zeros((b, n_frames, config.num_freqs, 2), dtype=dtype,
                          device=dev)
    return _export(module, (example,), b_dim, dev)


def export_phase_roundtrip(config: PhaseConfig, *, seconds: float,
                           sample_rate: int = 0, batch=None,
                           dtype: torch.dtype = torch.float32,
                           encode_fft_backend: str = "auto",
                           decode_fft_backend: str = "auto",
                           device=DEFAULT_DEVICE) -> Exported:
    """[B, n_samples] audio -> [B, L] audio in one program: KE, then KG and
    KH, the spectrogram never leaving the device (reference ToPhase ->
    FromPhase)."""
    dev = _device(device)
    c = config
    n = padded_samples(seconds, _sample_rate(c, sample_rate), c.window)
    b, b_dim = _batch(batch)
    module = _PhaseDecoder(c, dtype, dev, decode_fft_backend,
                           num_frames_of(n, c.resolut, c.window), False,
                           encode_fft_backend=encode_fft_backend)
    return _export(module, (_signal(b, n, dtype, dev),), b_dim, dev)


def export_phase_encoder_quantized(config: PhaseConfig, *, seconds: float,
                                   sample_rate: int = 0, batch=None,
                                   dtype: torch.dtype = torch.float32,
                                   fft_backend: str = "auto",
                                   device=DEFAULT_DEVICE) -> Exported:
    """[B, n_samples] audio -> (planes [B, nf, F, 2] uint8|uint16, maxs
    [B, 2], mins [B, 2]): KE, then KF with the config's IHS passes, each
    row its own per-channel extrema."""
    dev = _device(device)
    n = padded_samples(seconds, _sample_rate(config, sample_rate),
                       config.window)
    b, b_dim = _batch(batch)
    module = _PhaseEncoder(config, dtype, dev, fft_backend, True)
    return _export(module, (_signal(b, n, dtype, dev),), b_dim, dev)


def export_phase_decoder_quantized(config: PhaseConfig, *, n_frames: int,
                                   batch=None,
                                   dtype: torch.dtype = torch.float32,
                                   fft_backend: str = "auto",
                                   device=DEFAULT_DEVICE) -> Exported:
    """(planes [B, nf, F, 2] uint8|uint16, maxs [B, 2], mins [B, 2]) ->
    (int16 PCM [B, L], finite [B]): KG's dequantize mode, then KH with the
    PCM-16 epilogue, in float32 whatever ``dtype`` is (as the JAX
    program). ``fft_backend`` is checked as a name: the fused decode is
    KG's dequantize mode on every route, as ops/phase_ops.dequantize_decode
    runs it, and a size KG does not take raises."""
    dev = _device(device)
    b, b_dim = _batch(batch)
    c = config
    fftbackend.resolve(fft_backend, c.resolut, "cuda")
    module = _PhaseDecoder(c, dtype, dev, "auto", n_frames, True)
    if module.route != "mxu":
        raise ValueError(f"serving: the quantized phase decode runs KG's "
                         f"dequantize mode, which n={c.resolut} does not "
                         f"take")
    pdt = torch.uint16 if c.hdr else torch.uint8
    ext = torch.zeros((b, 2), dtype=torch.float32, device=dev)
    example = (torch.zeros((b, c.num_freqs, n_frames, 2), dtype=pdt,
                           device=dev), ext, ext.clone())
    return _export(module, example, b_dim, dev)


def export_mel_encoder_quantized(config: MelConfig, *, seconds: float,
                                 sample_rate: int, batch=None,
                                 dtype: torch.dtype = torch.float32,
                                 fft_backend: str = "auto",
                                 device=DEFAULT_DEVICE) -> Exported:
    """[B, n_samples] audio -> (planes [B, mels, F, 2] uint8, mgc_max [B],
    mgc_min [B]): the mel encode, then KD with one global max and min a
    row (mel/impl.go:138-152)."""
    dev = _device(device)
    n = padded_samples(seconds, int(sample_rate), config.window)
    b, b_dim = _batch(batch)
    module = _MelEncoder(config, dtype, dev, fft_backend, True)
    return _export(module, (_signal(b, n, dtype, dev),), b_dim, dev)


def export_mel_decoder_quantized(config: MelConfig, *, n_frames: int,
                                 batch=None,
                                 dtype: torch.dtype = torch.float32,
                                 fft_backend: str = "auto",
                                 momentum: float = 0.0,
                                 device=DEFAULT_DEVICE) -> Exported:
    """(planes [B, mels, F, 2] uint8, mgc_max [B], mgc_min [B], keys
    [B, 2] int32) -> (int16 PCM [B, L], finite [B]): KI's dequantize mode
    with the VolumeBoost, KP's starts, Griffin-Lim (KJ + KK) and KK's PCM-16
    epilogue, in float32."""
    dev = _device(device)
    b, b_dim = _batch(batch)
    c = config
    module = _MelDecoder(c, dtype, dev, fft_backend, momentum, n_frames,
                         True)
    ext = torch.zeros((b,), dtype=torch.float32, device=dev)
    example = (torch.zeros((b, c.num_mels, n_frames, 2), dtype=torch.uint8,
                           device=dev), ext, ext.clone(),
               torch.zeros((b, 2), dtype=torch.int32, device=dev))
    return _export(module, example, b_dim, dev)


# -- long form ----------------------------------------------------------------

def longform_plan(config, mesh, n_frames: int):
    """The FrameShardPlan an exported long-form artifact was built with:
    callers pad inputs with it (parallel/sharded.pad_signal_for_plan,
    pad_frames_for_plan) and trim outputs (``plan.n_frames``,
    ``plan.out_len``)."""
    from .parallel import sharded as sh
    from .parallel.mesh import FRAME_AXIS
    return sh.plan_frame_sharding(n_frames, config.resolut, config.window,
                                  mesh.shape[FRAME_AXIS])


def _longform_device(mesh) -> torch.device:
    """The one device every shard of ``mesh`` sits on."""
    dev = _device(mesh.first_device)
    if any(torch.device(d) != mesh.first_device
           for row in mesh.devices for d in row):
        raise NotImplementedError(
            "serving: a long-form artifact runs its shards on one device "
            "(four frame shards of one card); a mesh over several devices "
            "is the multi-process slice")
    return dev


def _longform_batch(batch, mesh) -> int:
    from .parallel.mesh import DATA_AXIS
    n_data = mesh.shape[DATA_AXIS]
    b = n_data if batch is None else int(batch)
    if b <= 0 or b % n_data != 0:
        raise ValueError(f"batch {b} must be a multiple of the mesh's "
                         f"data axis ({n_data}): every shard takes even rows")
    return b


class _Shards(torch.nn.Module):
    """The shard geometry of a plan on a mesh: the halo steps of
    parallel/sharded.py on a list of shard tensors, row-major over the
    (data, frame) grid."""

    def __init__(self, mesh, plan):
        super().__init__()
        from .parallel.mesh import FRAME_AXIS
        self.size, self.n_frame = mesh.size, mesh.shape[FRAME_AXIS]
        self.chunk, self.halo, self.plan = plan.chunk, plan.halo, plan

    def f_index(self, i: int) -> int:
        """The 'frame' coordinate of shard i (sharded._frame_index)."""
        return i % self.n_frame

    def real_frames(self, i: int) -> int:
        from .parallel.sharded import _local_frame_count
        return _local_frame_count(self.plan, self.f_index(i))

    def extend(self, shards: list, width: int) -> list:
        """Each shard's first ``width`` samples joined with the first halo
        samples of its right neighbour (zeros on the last frame shard):
        sharded._local_signal_ext and _pull_right_halo."""
        out = []
        for i, s in enumerate(shards):
            if self.f_index(i) + 1 < self.n_frame:
                head = shards[i + 1][:, :self.halo]
            else:
                head = s.new_zeros((s.shape[0], self.halo))
            out.append(torch.cat([s[:, :width], head], dim=1))
        return out

    def recv(self, sig_exts: list, i: int):
        """sharded._push_tail_right: the left neighbour's tail, None on
        frame shard 0."""
        if self.f_index(i) == 0:
            return None
        return sig_exts[i - 1][:, self.chunk:]


class _LongformEncoder(torch.nn.Module):
    def __init__(self, codec, shards: _Shards, mel: bool):
        super().__init__()
        self.codec, self.shards, self.mel = codec, shards, mel

    def forward(self, *xs):
        exts = self.shards.extend(list(xs), self.shards.chunk)
        if self.mel:
            return tuple(self.codec.encode(e) for e in exts)
        return tuple(self.codec.stft_planes(e, 1, self.codec.nf)
                     for e in exts)


class _LongformPhaseDecoder(torch.nn.Module):
    """sharded_phase_decode_fn: KG with each shard's real-frame count, KH
    without a window, then KM's halo add and global normalisation."""

    def __init__(self, codec: "_Codec", shards: _Shards, boost: float):
        super().__init__()
        self.codec, self.shards, self.boost = codec, shards, float(boost)

    def forward(self, *specs):
        c, sh = self.codec, self.shards
        sig_exts = [OPS.overlap_normalize(
            c.synth_spec(s, sh.real_frames(i)), None, None, c.hop, 0.0,
            False, 0.0, False)[0] for i, s in enumerate(specs)]
        return tuple(OPS.shard_epilogue(
            s, sh.recv(sig_exts, i), c.prefix, None, sh.chunk, c.hop,
            sh.f_index(i) * sh.chunk, sh.plan.n_frames, c.threshold,
            self.boost, 0.0, False)[0]
            for i, s in enumerate(sig_exts))


class _LongformMelDecoder(torch.nn.Module):
    """sharded_mel_decode_fn: KI a shard, each shard's start from the key
    folded with its index (KP), Griffin-Lim on the extended carries (KJ +
    KK, then KM's halo add and momentum step)."""

    def __init__(self, codec: "_MelTables", shards: _Shards, c: MelConfig,
                 b_loc: int, dtype, momentum: float):
        super().__init__()
        self.codec, self.shards, self.c = codec, shards, c
        self.b_loc, self.dtype, self.momentum = b_loc, dtype, float(momentum)

    def _epilogue(self, sig_exts, t_prev):
        sh, mom = self.shards, self.momentum
        outs = [OPS.shard_epilogue(
            s, sh.recv(sig_exts, i), None,
            None if t_prev is None else t_prev[i], sh.chunk, self.codec.hop,
            0, 0, 0.0, 0.0, mom, False)
            for i, s in enumerate(sig_exts)]
        return [o[0] for o in outs], [o[1] for o in outs]

    def forward(self, *args):
        *logmels, key = args
        c, sh, codec = self.c, self.shards, self.codec
        mags = []
        for i, m in enumerate(logmels):
            mag = codec.magnitudes(m, None, None, 0.0, c)
            real = sh.real_frames(i)
            if real < mag.shape[1]:
                mag = torch.cat([mag[:, :real], mag.new_zeros(
                    (mag.shape[0], mag.shape[1] - real, mag.shape[2]))], 1)
            mags.append(mag)
        keys = prng.fold_in_table(
            key.reshape(1, 2),
            torch.arange(sh.size, dtype=torch.int64, device=key.device))[0]
        sig0 = [OPS.threefry_uniform(keys[i:i + 1], self.b_loc * sh.chunk,
                                     self.dtype).reshape(self.b_loc,
                                                         sh.chunk)
                for i in range(sh.size)]
        exts = sh.extend(sig0, sh.chunk)
        n_iter = c.griffin_lim_iterations
        t_prev = sig0 if self.momentum != 0.0 else None
        for _ in range(max(n_iter - 1, 0)):
            sig_exts = [OPS.gl_overlap_add(codec.project(e, m), None,
                                           codec.hop, 0.0, False)[0]
                        for e, m in zip(exts, mags)]
            outs, ts = self._epilogue(sig_exts, t_prev)
            if t_prev is not None:
                t_prev = ts
            exts = sh.extend(outs, sh.chunk)
        if n_iter < 1:
            return tuple(e[:, :sh.chunk] for e in exts)
        sig_exts = [OPS.gl_overlap_add(codec.project(e, m, True), None,
                                       codec.hop, 0.0, False)[0]
                    for e, m in zip(exts, mags)]
        return tuple(self._epilogue(sig_exts, None)[0])


def _export_longform(module, example: list, mesh, sharded) -> Exported:
    from .parallel.mesh import DATA_AXIS, FRAME_AXIS
    dev = example[0].device
    return _export(module, tuple(example), None, dev, nr_devices=mesh.size,
                   mesh_shape=(mesh.shape[DATA_AXIS], mesh.shape[FRAME_AXIS]),
                   sharded=sharded)


def _shard_zeros(mesh, shape, dtype, dev) -> list:
    return [torch.zeros(shape, dtype=dtype, device=dev)
            for _ in range(mesh.size)]


def export_longform_mel_encoder(config: MelConfig, mesh, *, n_frames: int,
                                batch=None,
                                dtype: torch.dtype = torch.float32,
                                fft_backend: str = "auto") -> Exported:
    """Frame-sharded [B, F_pad * hop] audio -> [B, F_pad, num_mels, 2]
    log-mel over ``mesh`` (parallel/sharded.sharded_mel_encode_fn at the
    plan of ``n_frames`` real frames, :func:`longform_plan`): the fused
    KB + KC (or KB then KC) on each shard's extended signal."""
    from .parallel.mesh import DATA_AXIS
    dev = _longform_device(mesh)
    plan = longform_plan(config, mesh, n_frames)
    b_loc = _longform_batch(batch, mesh) // mesh.shape[DATA_AXIS]
    module = _LongformEncoder(_MelTables(config, dtype, dev, fft_backend),
                              _Shards(mesh, plan), True)
    return _export_longform(module, _shard_zeros(mesh, (b_loc, plan.chunk),
                                                 dtype, dev), mesh, (True,))


def export_longform_mel_decoder(config: MelConfig, mesh, *, n_frames: int,
                                batch=None,
                                dtype: torch.dtype = torch.float32,
                                momentum: float = 0.0,
                                interior_mm: bool | None = None) -> Exported:
    """Frame-sharded Griffin-Lim decode: ([B, F_pad, num_mels, 2] log-mel,
    [2] int32 key) -> [B, F_pad * hop] audio (parallel/sharded.
    sharded_mel_decode_fn); shard i starts from ``fold_in(key, i)``'s draw,
    as the JAX program's. ``interior_mm`` as in sharded_griffin_lim_fn:
    True runs the interior iterations on the matmul DFT in bf16 (KN's
    projection + KO, the JAX package's TPU default), None (the default) and
    False the exact iteration (KJ + KK)."""
    from .parallel.mesh import DATA_AXIS
    dev = _longform_device(mesh)
    plan = longform_plan(config, mesh, n_frames)
    b_loc = _longform_batch(batch, mesh) // mesh.shape[DATA_AXIS]
    codec = _MelTables(config, dtype, dev, "mm" if interior_mm else "auto",
                       encode=False, gl=True)
    module = _LongformMelDecoder(codec, _Shards(mesh, plan), config, b_loc,
                                 dtype, momentum)
    example = _shard_zeros(mesh, (b_loc, plan.frames_per_shard,
                                  config.num_mels, 2), dtype, dev)
    example.append(torch.zeros((2,), dtype=torch.int32, device=dev))
    return _export_longform(module, example, mesh, (True, False))


def export_longform_phase_encoder(config: PhaseConfig, mesh, *,
                                  n_frames: int, batch=None,
                                  dtype: torch.dtype = torch.float32,
                                  fft_backend: str = "auto") -> Exported:
    """Frame-sharded [B, F_pad * hop] audio -> [B, F_pad, num_freqs, 2]
    (parallel/sharded.sharded_phase_encode_fn): KE on each shard's extended
    signal."""
    from .parallel.mesh import DATA_AXIS
    dev = _longform_device(mesh)
    plan = longform_plan(config, mesh, n_frames)
    b_loc = _longform_batch(batch, mesh) // mesh.shape[DATA_AXIS]
    codec = _PhaseEncoder(config, dtype, dev, fft_backend, False)
    module = _LongformEncoder(codec, _Shards(mesh, plan), False)
    return _export_longform(module, _shard_zeros(mesh, (b_loc, plan.chunk),
                                                 dtype, dev), mesh, (True,))


def export_longform_phase_decoder(config: PhaseConfig, mesh, *,
                                  n_frames: int, batch=None,
                                  dtype: torch.dtype = torch.float32
                                  ) -> Exported:
    """Frame-sharded direct iSTFT: [B, F_pad, num_freqs, 2] -> [B, F_pad *
    hop] audio (parallel/sharded.sharded_phase_decode_fn), normalised by
    the window sum of the whole signal under one global threshold."""
    from .parallel.mesh import DATA_AXIS
    dev = _longform_device(mesh)
    plan = longform_plan(config, mesh, n_frames)
    b_loc = _longform_batch(batch, mesh) // mesh.shape[DATA_AXIS]
    codec = _Codec(config.resolut, config.window, dtype, dev)
    codec._ola_tables(plan.n_frames)
    module = _LongformPhaseDecoder(codec, _Shards(mesh, plan),
                                   config.volume_boost)
    example = _shard_zeros(mesh, (b_loc, plan.frames_per_shard,
                                  config.num_freqs, 2), dtype, dev)
    return _export_longform(module, example, mesh, (True,))


def call_longform(exp: Exported, mesh, *args):
    """Run a long-form artifact on ``mesh``: each host or device input cut
    the way the port's sharded functions take it (a sharded input [B, T,
    ...] over (data, frame) by parallel/mesh.shard_array; the key as it
    is), the program called once, and its shards returned as a
    ``Sharded``."""
    from .parallel.mesh import DATA_AXIS, FRAME_AXIS, Sharded, shard_array
    if exp.mesh_shape is None:
        raise ValueError("call_longform: not a long-form artifact")
    if mesh.spans_processes:
        raise ValueError("call_longform: an artifact is one program over "
                         "every shard, so it runs on a mesh that one "
                         "process owns")
    if mesh.size != exp.nr_devices:
        raise ValueError(f"artifact was exported for {exp.nr_devices} "
                         f"devices; mesh has {mesh.size}")
    shape = (mesh.shape[DATA_AXIS], mesh.shape[FRAME_AXIS])
    if shape != exp.mesh_shape:
        raise ValueError(f"artifact was exported for a {exp.mesh_shape} "
                         f"(data, frame) mesh; mesh is {shape}")
    if any(torch.device(d) != exp.device
           for row in mesh.devices for d in row):
        raise ValueError(f"artifact runs its shards on {exp.device}; mesh "
                         f"has {mesh.devices}")
    if len(args) != len(exp.sharded):
        raise ValueError(f"artifact takes {len(exp.sharded)} inputs "
                         f"{exp.in_shapes}, got {len(args)}")
    flat = []
    for a, sharded in zip(args, exp.sharded):
        if sharded:
            flat.extend(shard_array(a, mesh).shards)
        else:
            a = torch.as_tensor(a)
            if a.dtype == torch.uint32:     # a key's bits
                a = a.view(torch.int32)
            flat.append(a.to(exp.device))
    return Sharded(mesh, list(exp.call(*flat)))


# -- persistence --------------------------------------------------------------

def artifact_meta(exp: Exported, config=None, kind: str = "",
                  **extra) -> dict:
    """The self-description header of :func:`save_exported`: what a serving
    fleet needs to route inputs without parsing file names (the JAX
    package's fields; long-form artifacts add their ``mesh`` shape)."""
    meta = {
        "kind": kind,
        "platforms": exp.platforms,
        "nr_devices": exp.nr_devices,
        "in_shapes": exp.in_shapes,
        "in_dtypes": exp.in_dtypes,
        "out_shapes": exp.out_shapes,
    }
    if exp.mesh_shape is not None:
        meta["mesh"] = list(exp.mesh_shape)
        meta["sharded_inputs"] = list(exp.sharded)
    if config is not None:
        meta["config"] = dataclasses.asdict(config)
        meta["config_class"] = type(config).__name__
    meta.update(extra)
    return meta


def save_exported(exp: Exported, path: str, meta: dict | None = None
                  ) -> None:
    """Write an artifact: magic, u32 header length, JSON header (``meta``,
    else :func:`artifact_meta` of ``exp``; the device and the long-form
    layout are always recorded), the ``torch.export.save`` bytes."""
    header = dict(meta) if meta is not None else artifact_meta(exp)
    header.setdefault("platforms", exp.platforms)
    header.setdefault("nr_devices", exp.nr_devices)
    header["device"] = str(exp.device)
    if exp.mesh_shape is not None:
        header.setdefault("mesh", list(exp.mesh_shape))
        header.setdefault("sharded_inputs", list(exp.sharded))
    blob = io.BytesIO()
    torch.export.save(exp.program, blob)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(head)))
        f.write(head)
        f.write(blob.getvalue())


def _read_artifact(path: str, with_blob: bool) -> tuple[dict, bytes | None]:
    """(header, program bytes or None). Reads only the header unless
    ``with_blob``; a JAX artifact's header too (``with_blob`` False).
    Malformed or truncated headers raise ValueError."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        jax = next((m for m in _JAX_MAGICS if magic.startswith(m)), None)
        if magic != MAGIC and jax is None:
            raise ValueError(f"{path} is not a gomel_tpu_torch serving "
                             f"artifact")
        if jax == b"GMTPUEXP1\n":
            if with_blob:
                raise ValueError(f"{path} is a JAX (gomel_tpu) serving "
                                 f"artifact; load it with gomel_tpu.serving")
            return {}, None
        if jax is not None:     # its magic is two bytes shorter than ours
            f.seek(len(jax))
        lenb = f.read(4)
        if len(lenb) < 4:
            raise ValueError(f"{path}: truncated artifact header")
        (hlen,) = struct.unpack("<I", lenb)
        head = f.read(hlen)
        if len(head) < hlen:
            raise ValueError(f"{path}: truncated artifact header")
        try:
            header = json.loads(head or b"{}")
        except ValueError as e:
            raise ValueError(f"{path}: corrupt artifact header ({e})"
                             ) from None
        if jax is not None and with_blob:
            raise ValueError(f"{path} is a JAX (gomel_tpu) serving artifact; "
                             f"load it with gomel_tpu.serving")
        return header, (f.read() if with_blob else None)


def load_exported(path: str) -> Exported:
    """Load an artifact written by :func:`save_exported` onto the device it
    was built for (raises RuntimeError when that device is absent)."""
    header, blob = _read_artifact(path, with_blob=True)
    device = torch.device(header.get("device", "cpu"))
    _cuda.require_device(device, "load_exported",
                         hint="load it where its device is")
    try:
        program = torch.export.load(io.BytesIO(blob))
    except Exception as e:      # a cut or damaged archive
        raise ValueError(f"{path}: truncated or corrupt program "
                         f"({type(e).__name__}: {e})") from None
    mesh = header.get("mesh")
    return Exported(program, device, header.get("nr_devices", 1),
                    None if mesh is None else tuple(mesh),
                    None if mesh is None else tuple(header["sharded_inputs"]))


def read_artifact_meta(path: str) -> dict:
    """The JSON header (an empty dict for a header-less JAX v1 artifact);
    reads only the header bytes."""
    return _read_artifact(path, with_blob=False)[0]
