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
- **Long form** (``export_longform_*``): the port's sharded functions
  (parallel/sharded.py) at one plan, on any mesh ``make_mesh`` builds
  (one device, several cards of one process, or the processes of a
  ``torch.distributed`` group), run with :func:`call_longform` on any
  mesh of the same (data, frame) shape on devices of the artifact's type:
  every process passes the same whole inputs and gets a ``Sharded`` of
  its own shards. An artifact holds per-shard pieces, each one shard's
  work between two halo exchanges (its frame index fixes the real-frame
  count, the window sum's start and the open boundaries), traced once
  with the codec's tables as inputs; ``call_longform`` runs them on this
  process's shards and does the exchanges between them on the host with
  parallel/sharded.py's (copies, or one ``batch_isend_irecv`` over the
  group), so every placement gives the eager sharded path's bits. Built
  where one process holds every shard on one device (four frame shards of
  one card, or of the CPU), the artifact also holds the single program
  over every shard (a tensor a shard in, a key [2] last for the mel
  decoder, a tensor a shard out), which runs on that placement and whose
  buffers are the pieces' tables. The window-sum threshold is one global
  value of the plan, and shard i's Griffin-Lim start is drawn from the key
  folded with its global row-major index i.

A loaded artifact composes: ``exp.module()`` is an ``nn.Module`` to call
inside a larger one.
"""
from __future__ import annotations

import copy
import dataclasses
import inspect
import io
import json
import struct

import numpy as np
import torch
import torch.utils._pytree as pytree
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
    runs it; ``module()`` is the program as an ``nn.Module``. A long-form
    artifact also carries ``longform``, its per-shard form; built on a mesh
    over several devices it has that alone (``program`` None)."""

    def __init__(self, program: torch.export.ExportedProgram | None,
                 device: torch.device, nr_devices: int = 1,
                 mesh_shape: tuple[int, int] | None = None,
                 sharded: tuple[bool, ...] | None = None,
                 longform: "_Longform | None" = None,
                 flat: tuple[list, list] | None = None):
        self.program = program
        self.device = torch.device(device)
        self.nr_devices = int(nr_devices)
        self.mesh_shape = None if mesh_shape is None else tuple(mesh_shape)
        self.sharded = None if sharded is None else tuple(sharded)
        self.longform = longform
        self._module = None
        if program is None:     # a long-form artifact of pieces alone
            self._flat_in, self._flat_out = flat
            return
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
        if self.program is None:
            raise ValueError("this long-form artifact was built on a mesh "
                             "over several devices and holds no single "
                             "program: run it with call_longform")
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


def _mesh_devices(mesh) -> list[torch.device]:
    return [_device(d) for row in mesh.devices for d in row]


def _on_one_device(mesh, dev: torch.device) -> bool:
    """Whether this process holds every shard of ``mesh``, all on ``dev``:
    the placement the single program of a long-form artifact runs on."""
    return (not mesh.spans_processes
            and all(d == dev for d in _mesh_devices(mesh)))


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


# One shard's steps between two halo exchanges: the single program of an
# artifact runs them on every shard, its per-shard pieces (_Piece) one each.

def _encode(codec, ext):
    """The mel (fused KB + KC, or KB then KC) or phase (KE) encode of a
    shard's extended signal."""
    if isinstance(codec, _MelTables):
        return codec.encode(ext)
    return codec.stft_planes(ext, 1, codec.nf)


def _synth(codec, spec, real: int):
    """KG with the shard's real-frame count, then KH without a window: its
    un-normalised overlap-add [B, chunk + halo]."""
    return OPS.overlap_normalize(codec.synth_spec(spec, real), None, None,
                                 codec.hop, 0.0, False, 0.0, False)[0]


def _phase_epilogue(codec, sig_ext, recv, chunk: int, start: int,
                    n_frames: int, boost: float):
    """KM: the left neighbour's tail added, the window sum of the whole
    signal at the shard's global ``start`` under the one global threshold,
    the boost."""
    return OPS.shard_epilogue(sig_ext, recv, codec.prefix, None, chunk,
                              codec.hop, start, n_frames, codec.threshold,
                              boost, 0.0, False)[0]


def _gl_magnitudes(codec, c: MelConfig, logmel, real: int):
    """KI, the shard's pad frames zero."""
    mag = codec.magnitudes(logmel, None, None, 0.0, c)
    if real < mag.shape[1]:
        mag = torch.cat([mag[:, :real], mag.new_zeros(
            (mag.shape[0], mag.shape[1] - real, mag.shape[2]))], 1)
    return mag


def _gl_keys(key, size: int):
    """The key folded with each shard's global row-major index [size, 2]."""
    return prng.fold_in_table(
        key.reshape(1, 2),
        torch.arange(size, dtype=torch.int64, device=key.device))[0]


def _gl_start(key_row, b_loc: int, chunk: int, dtype):
    """KP: the shard's Griffin-Lim start from its folded key [1, 2]."""
    return OPS.threefry_uniform(key_row, b_loc * chunk, dtype).reshape(
        b_loc, chunk)


def _gl_project(codec, ext, mag, final: bool):
    """KJ + KK (KN + KO on the mm route's interior iterations)."""
    return OPS.gl_overlap_add(codec.project(ext, mag, final), None,
                              codec.hop, 0.0, False)[0]


def _gl_epilogue(codec, sig_ext, recv, t_prev, chunk: int, momentum: float):
    """KM: the left neighbour's tail added, with ``t_prev`` the momentum
    step; (samples, momentum carry or an empty tensor)."""
    return OPS.shard_epilogue(sig_ext, recv, None, t_prev, chunk, codec.hop,
                              0, 0, 0.0, 0.0, momentum, False)


class _LongformEncoder(torch.nn.Module):
    def __init__(self, codec, shards: _Shards):
        super().__init__()
        self.codec, self.shards = codec, shards

    def forward(self, *xs):
        exts = self.shards.extend(list(xs), self.shards.chunk)
        return tuple(_encode(self.codec, e) for e in exts)


class _LongformPhaseDecoder(torch.nn.Module):
    """sharded_phase_decode_fn: KG with each shard's real-frame count, KH
    without a window, then KM's halo add and global normalisation."""

    def __init__(self, codec: "_Codec", shards: _Shards, boost: float):
        super().__init__()
        self.codec, self.shards, self.boost = codec, shards, float(boost)

    def forward(self, *specs):
        c, sh = self.codec, self.shards
        sig_exts = [_synth(c, s, sh.real_frames(i))
                    for i, s in enumerate(specs)]
        return tuple(_phase_epilogue(
            c, s, sh.recv(sig_exts, i), sh.chunk, sh.f_index(i) * sh.chunk,
            sh.plan.n_frames, self.boost) for i, s in enumerate(sig_exts))


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
        sh = self.shards
        outs = [_gl_epilogue(self.codec, s, sh.recv(sig_exts, i),
                             None if t_prev is None else t_prev[i], sh.chunk,
                             self.momentum)
                for i, s in enumerate(sig_exts)]
        return [o[0] for o in outs], [o[1] for o in outs]

    def forward(self, *args):
        *logmels, key = args
        c, sh, codec = self.c, self.shards, self.codec
        mags = [_gl_magnitudes(codec, c, m, sh.real_frames(i))
                for i, m in enumerate(logmels)]
        keys = _gl_keys(key, sh.size)
        sig0 = [_gl_start(keys[i:i + 1], self.b_loc, sh.chunk, self.dtype)
                for i in range(sh.size)]
        exts = sh.extend(sig0, sh.chunk)
        n_iter = c.griffin_lim_iterations
        t_prev = sig0 if self.momentum != 0.0 else None
        for _ in range(max(n_iter - 1, 0)):
            sig_exts = [_gl_project(codec, e, m, False)
                        for e, m in zip(exts, mags)]
            outs, ts = self._epilogue(sig_exts, t_prev)
            if t_prev is not None:
                t_prev = ts
            exts = sh.extend(outs, sh.chunk)
        if n_iter < 1:
            return tuple(e[:, :sh.chunk] for e in exts)
        sig_exts = [_gl_project(codec, e, m, True)
                    for e, m in zip(exts, mags)]
        return tuple(self._epilogue(sig_exts, None)[0])


# -- long form: the per-shard pieces --------------------------------------------

class _Piece(torch.nn.Module):
    """One shard's step between two halo exchanges, as a program of its
    own: ``step(codec, *data)`` with the codec's tables as its first
    inputs, so the pieces of an artifact share one copy of them and carry
    no tensor of their own. The codec is held outside the module tree (its
    buffers are not this module's) and rebound to the inputs a call."""

    def __init__(self, codec: _Codec, step):
        super().__init__()
        self.step = step
        self.__dict__["_codec"] = codec

    def forward(self, *args):
        names = list(self._codec._buffers)
        codec = copy.copy(self._codec)
        codec._buffers = dict(zip(names, args[:len(names)]))
        return self.step(codec, *args[len(names):])


def _piece_specs(program: str, codec, config, p: dict,
                 dev: torch.device) -> dict:
    """key -> (step, example data) of every piece of a long-form program of
    the plan ``p``. A key names what sets a piece apart: the frame shard's
    real-frame count (KG, KI), its start (KM's window sum), whether it has
    a left neighbour (KM's tail) and a momentum carry."""
    from .parallel.sharded import _local_frame_count
    plan = _plan(p)
    b, chunk, halo = p["b_loc"], plan.chunk, plan.halo
    dtype = getattr(torch, p["dtype"])

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)
    ext = zeros(b, chunk + halo)
    if program == "encode":
        return {"encode": (_encode, (ext,))}
    specs = {}
    frames = plan.frames_per_shard
    for f in range(plan.n_shards):
        real = _local_frame_count(plan, f)
        recv = (zeros(b, halo),) if f else ()
        if program == "phase-dec":
            specs[f"synth/{real}"] = (
                lambda c, s, real=real: _synth(c, s, real),
                (zeros(b, frames, config.num_freqs, 2),))
            specs[f"epilogue/{f}"] = (
                lambda c, s, *r, f=f: _phase_epilogue(
                    c, s, r[0] if r else None, chunk, f * chunk,
                    plan.n_frames, p["boost"]), (ext,) + recv)
            continue
        specs[f"start/{real}"] = (
            lambda c, logmel, key_row, real=real: (
                _gl_magnitudes(c, config, logmel, real),
                _gl_start(key_row, b, chunk, dtype)),
            (zeros(b, frames, config.num_mels, 2),
             zeros(1, 2, dt=torch.int32)))
        carries = {p["momentum"] != 0.0} if p["n_iter"] >= 2 else set()
        for carry in carries | ({False} if p["n_iter"] >= 1 else set()):
            specs[_gl_epilogue_key(f, carry)] = (
                lambda c, s, *r, f=f, carry=carry: _gl_epilogue(
                    c, s, r[0] if f else None, r[-1] if carry else None,
                    chunk, p["momentum"]),
                (ext,) + recv + ((zeros(b, chunk),) if carry else ()))
    if program == "mel-dec":
        specs["fold"] = (lambda c, key: _gl_keys(key, p["size"]),
                         (zeros(2, dt=torch.int32),))
        mag = zeros(b, frames, codec.n // 2 + 1)
        for final in (False, True):
            specs[f"project/{int(final)}"] = (
                lambda c, e, m, final=final: _gl_project(c, e, m, final),
                (ext, mag))
    return specs


def _gl_epilogue_key(f: int, carry: bool) -> str:
    return f"epilogue/{int(f > 0)}{int(carry)}"


def _plan(p: dict):
    from .parallel.sharded import plan_frame_sharding
    return plan_frame_sharding(p["n_frames"], p["frame_len"], p["hop"],
                               p["n_shards"])


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    """A shape and dtype with no storage: an input or output spec."""
    return torch.empty(shape, dtype=dtype, device="meta")


class _Longform:
    """The per-shard form every long-form artifact carries: its pieces
    (``_piece_specs``), each traced once on the artifact's device, the
    codec's tables they take, and the host loop (:meth:`run`) that runs
    them on this process's shards of a mesh with parallel/sharded.py's halo
    exchanges between them (local copies, or ``batch_isend_irecv`` across
    processes), so an artifact gives the eager sharded path's bits on any
    placement of its (data, frame) shape. A loaded piece is deserialised
    at its first call on a device; on another device than the artifact's
    it runs as a copy moved there (``torch.export.passes.
    move_to_device_pass``). The tables are copied to each device once."""

    def __init__(self, params: dict, names: list[str], tables: list,
                 device: torch.device, pieces: dict | None = None,
                 blobs: dict[str, bytes] | None = None, path: str = ""):
        self.params, self.names, self.tables = params, names, tables
        self.device, self.path = device, path
        self._pieces = dict(pieces or {})
        self._blobs = dict(blobs or {})
        self.keys = list(self._pieces or self._blobs)
        self._tables_on: dict = {}
        self._modules: dict = {}

    @classmethod
    def build(cls, program: str, codec, config, params: dict,
              dev: torch.device) -> "_Longform":
        params = dict(params, program=program)
        names = list(codec._buffers)
        tables = list(codec._buffers.values())
        pieces = {}
        for key, (step, data) in _piece_specs(program, codec, config,
                                              params, dev).items():
            ep = torch.export.export(_Piece(codec, step),
                                     tuple(tables) + data, strict=False)
            ep.example_inputs = None
            pieces[key] = ep
        return cls(params, names, tables, dev, pieces=pieces)

    def blob(self, key: str) -> bytes:
        """The ``torch.export.save`` bytes of piece ``key``."""
        if key not in self._blobs:
            if key not in self._pieces:
                raise ValueError(f"call_longform: the artifact has no piece "
                                 f"{key!r}")
            self._blobs[key] = _program_bytes(self._pieces[key])
        return self._blobs[key]

    def tables_blob(self) -> bytes:
        buf = io.BytesIO()
        torch.save(dict(zip(self.names, self.tables)), buf)
        return buf.getvalue()

    def _on(self, device: torch.device) -> tuple:
        if device not in self._tables_on:
            self._tables_on[device] = tuple(t.to(device)
                                            for t in self.tables)
        return self._tables_on[device]

    def _module(self, key: str, device: torch.device) -> tuple:
        """Piece ``key`` on ``device``: its graph, whose inputs are the
        tables and the data (a piece lifts no tensor of its own), and its
        outputs' structure. The graph is called as it is: the data are
        checked once, at ``call_longform``'s door, and every piece's input
        between two exchanges is a piece's output."""
        if (key, device) not in self._modules:
            if device == self.device and key in self._pieces:
                ep = self._pieces[key]
            else:
                ep = _load_program(self.path, self.blob(key))
                if device != self.device:
                    from torch.export.passes import move_to_device_pass
                    ep = move_to_device_pass(ep, str(device))
                    # the pass rewrites the graph's nodes, not its code
                    ep.graph_module.recompile()
            self._modules[key, device] = (ep.graph_module,
                                          ep.call_spec.out_spec)
        return self._modules[key, device]

    def _run(self, key: str, *data):
        dev = data[0].device
        graph, out_spec = self._module(key, dev)
        return pytree.tree_unflatten(list(graph(*self._on(dev), *data)),
                                     out_spec)

    def run(self, mesh, inputs: list) -> list:
        """This process's output shards (None for other processes') of the
        program on ``inputs``: a ``Sharded`` for each sharded input, the key
        as a tensor."""
        from .parallel import sharded as sh
        from .parallel.mesh import Sharded
        p, plan = self.params, _plan(self.params)
        local = sh._local

        def real(i):
            return sh._local_frame_count(plan, sh._frame_index(mesh, i))

        def tail(recv, i):
            return () if sh._frame_index(mesh, i) == 0 else (recv[i],)

        if p["program"] == "encode":
            return local(sh._local_signal_ext(inputs[0], plan),
                         lambda _, e: self._run("encode", e))
        if p["program"] == "phase-dec":
            sig_exts = local(inputs[0].shards, lambda i, s: self._run(
                f"synth/{real(i)}", s))
            recv = sh._push_tail_right(sig_exts, mesh, plan)
            return local(sig_exts, lambda i, s: self._run(
                f"epilogue/{sh._frame_index(mesh, i)}", s, *tail(recv, i)))
        keys: dict = {}

        def key_row(i, device):
            """KP's key of shard ``i``: the key folded with its global
            index, on its device."""
            if device not in keys:
                keys[device] = self._run("fold", inputs[1].to(device))
            return keys[device][i:i + 1]
        starts = local(inputs[0].shards, lambda i, m: self._run(
            f"start/{real(i)}", m, key_row(i, m.device)))
        mags = local(starts, lambda _, s: s[0])
        sig0 = local(starts, lambda _, s: s[1])
        exts = sh._local_signal_ext(Sharded(mesh, sig0), plan)
        carry = p["momentum"] != 0.0
        t_prev = sig0
        for _ in range(max(p["n_iter"] - 1, 0)):
            sig_exts = local(exts, lambda i, e: self._run(
                "project/0", e, mags[i]))
            recv = sh._push_tail_right(sig_exts, mesh, plan)
            outs = local(sig_exts, lambda i, s: self._run(
                _gl_epilogue_key(sh._frame_index(mesh, i), carry), s,
                *tail(recv, i), *((t_prev[i],) if carry else ())))
            if carry:
                t_prev = local(outs, lambda _, o: o[1])
            exts = sh._local_signal_ext(
                Sharded(mesh, local(outs, lambda _, o: o[0])), plan)
        if p["n_iter"] < 1:
            return local(exts, lambda _, e: e[:, :plan.chunk])
        sig_exts = local(exts, lambda i, e: self._run("project/1", e,
                                                      mags[i]))
        recv = sh._push_tail_right(sig_exts, mesh, plan)
        return local(sig_exts, lambda i, s: self._run(
            _gl_epilogue_key(sh._frame_index(mesh, i), False), s,
            *tail(recv, i))[0])


def _export_longform(module, pieces: _Longform, example: list, mesh,
                     sharded, out_shard: tuple) -> Exported:
    """A long-form artifact: the single program of ``module`` when this
    process holds every shard of ``mesh`` on one device (else None), and
    the per-shard pieces."""
    from .parallel.mesh import DATA_AXIS, FRAME_AXIS
    dev = example[0].device
    layout = dict(nr_devices=mesh.size,
                  mesh_shape=(mesh.shape[DATA_AXIS], mesh.shape[FRAME_AXIS]),
                  sharded=sharded, longform=pieces)
    if _on_one_device(mesh, dev):
        return _export(module, tuple(example), None, dev, **layout)
    return Exported(None, dev, flat=([_meta(t.shape, t.dtype)
                                      for t in example],
                                     [_meta(*out_shard)] * mesh.size),
                    **layout)


def _shard_zeros(mesh, shape, dtype, dev) -> list:
    return [torch.zeros(shape, dtype=dtype, device=dev)
            for _ in range(mesh.size)]


def _longform_setup(config, mesh, n_frames: int, batch, dtype):
    """(trace device, plan, rows a shard, the pieces' plan parameters)."""
    from .parallel.mesh import DATA_AXIS
    dev = _device(mesh.first_local_device)
    plan = longform_plan(config, mesh, n_frames)
    b_loc = _longform_batch(batch, mesh) // mesh.shape[DATA_AXIS]
    params = dict(n_frames=plan.n_frames, frame_len=plan.frame_len,
                  hop=plan.hop, n_shards=plan.n_shards, size=mesh.size,
                  b_loc=b_loc, dtype=_dtype_name(dtype))
    return dev, plan, b_loc, params


def export_longform_mel_encoder(config: MelConfig, mesh, *, n_frames: int,
                                batch=None,
                                dtype: torch.dtype = torch.float32,
                                fft_backend: str = "auto") -> Exported:
    """Frame-sharded [B, F_pad * hop] audio -> [B, F_pad, num_mels, 2]
    log-mel over ``mesh`` (parallel/sharded.sharded_mel_encode_fn at the
    plan of ``n_frames`` real frames, :func:`longform_plan`): the fused
    KB + KC (or KB then KC) on each shard's extended signal."""
    dev, plan, b_loc, params = _longform_setup(config, mesh, n_frames, batch,
                                               dtype)
    codec = _MelTables(config, dtype, dev, fft_backend)
    return _export_longform(
        _LongformEncoder(codec, _Shards(mesh, plan)),
        _Longform.build("encode", codec, config, params, dev),
        _shard_zeros(mesh, (b_loc, plan.chunk), dtype, dev), mesh, (True,),
        ((b_loc, plan.frames_per_shard, config.num_mels, 2), dtype))


def export_longform_mel_decoder(config: MelConfig, mesh, *, n_frames: int,
                                batch=None,
                                dtype: torch.dtype = torch.float32,
                                momentum: float = 0.0,
                                interior_mm: bool | None = None) -> Exported:
    """Frame-sharded Griffin-Lim decode: ([B, F_pad, num_mels, 2] log-mel,
    [2] int32 key) -> [B, F_pad * hop] audio (parallel/sharded.
    sharded_mel_decode_fn); shard i starts from ``fold_in(key, i)``'s draw,
    as the JAX program's, with ``i`` its global row-major index.
    ``interior_mm`` as in sharded_griffin_lim_fn: True runs the interior
    iterations on the matmul DFT in bf16 (KN's projection + KO, the JAX
    package's TPU default), None (the default) and False the exact
    iteration (KJ + KK)."""
    dev, plan, b_loc, params = _longform_setup(config, mesh, n_frames, batch,
                                               dtype)
    codec = _MelTables(config, dtype, dev, "mm" if interior_mm else "auto",
                       encode=False, gl=True)
    module = _LongformMelDecoder(codec, _Shards(mesh, plan), config, b_loc,
                                 dtype, momentum)
    pieces = _Longform.build("mel-dec", codec, config, dict(
        params, n_iter=config.griffin_lim_iterations,
        momentum=float(momentum)), dev)
    example = _shard_zeros(mesh, (b_loc, plan.frames_per_shard,
                                  config.num_mels, 2), dtype, dev)
    example.append(torch.zeros((2,), dtype=torch.int32, device=dev))
    return _export_longform(module, pieces, example, mesh, (True, False),
                            ((b_loc, plan.chunk), dtype))


def export_longform_phase_encoder(config: PhaseConfig, mesh, *,
                                  n_frames: int, batch=None,
                                  dtype: torch.dtype = torch.float32,
                                  fft_backend: str = "auto") -> Exported:
    """Frame-sharded [B, F_pad * hop] audio -> [B, F_pad, num_freqs, 2]
    (parallel/sharded.sharded_phase_encode_fn): KE on each shard's extended
    signal."""
    dev, plan, b_loc, params = _longform_setup(config, mesh, n_frames, batch,
                                               dtype)
    codec = _PhaseEncoder(config, dtype, dev, fft_backend, False)
    return _export_longform(
        _LongformEncoder(codec, _Shards(mesh, plan)),
        _Longform.build("encode", codec, config, params, dev),
        _shard_zeros(mesh, (b_loc, plan.chunk), dtype, dev), mesh, (True,),
        ((b_loc, plan.frames_per_shard, config.num_freqs, 2), dtype))


def export_longform_phase_decoder(config: PhaseConfig, mesh, *,
                                  n_frames: int, batch=None,
                                  dtype: torch.dtype = torch.float32
                                  ) -> Exported:
    """Frame-sharded direct iSTFT: [B, F_pad, num_freqs, 2] -> [B, F_pad *
    hop] audio (parallel/sharded.sharded_phase_decode_fn), normalised by
    the window sum of the whole signal under one global threshold."""
    dev, plan, b_loc, params = _longform_setup(config, mesh, n_frames, batch,
                                               dtype)
    codec = _Codec(config.resolut, config.window, dtype, dev)
    codec._ola_tables(plan.n_frames)
    module = _LongformPhaseDecoder(codec, _Shards(mesh, plan),
                                   config.volume_boost)
    pieces = _Longform.build("phase-dec", codec, config, dict(
        params, boost=float(config.volume_boost)), dev)
    example = _shard_zeros(mesh, (b_loc, plan.frames_per_shard,
                                  config.num_freqs, 2), dtype, dev)
    return _export_longform(module, pieces, example, mesh, (True,),
                            ((b_loc, plan.chunk), dtype))


def _check_shards(exp: Exported, inputs: list) -> None:
    """Each of this process's shards of each input against the artifact's
    (the single program checks its own in ``Exported.call``)."""
    k = 0
    for j, (x, sharded) in enumerate(zip(inputs, exp.sharded)):
        want = exp._flat_in[k]
        k += exp.nr_devices if sharded else 1
        for t in (x.shards if sharded else [x]):
            if t is not None and (tuple(t.shape) != tuple(want.shape)
                                  or t.dtype != want.dtype):
                raise ValueError(
                    f"input {j}: a shard is {_dtype_name(t.dtype)} "
                    f"{list(t.shape)}; the artifact takes "
                    f"{_dtype_name(want.dtype)} {list(want.shape)}")


def call_longform(exp: Exported, mesh, *args):
    """Run a long-form artifact on ``mesh``, any placement of its (data,
    frame) shape on devices of its type: every process passes the same
    whole host or device inputs (the replicated-input model), cut the way
    the port's sharded functions take them (a sharded input [B, T, ...]
    over (data, frame) by parallel/mesh.shard_array; the key as it is).
    Where this process holds every shard on the artifact's own device the
    artifact's single program runs; elsewhere its per-shard pieces, with
    the halo exchanges between them on the host, over the process group
    where neighbours live in two processes. Returns a ``Sharded`` of this
    process's shards (None for other processes')."""
    from .parallel.mesh import DATA_AXIS, FRAME_AXIS, Sharded, shard_array
    if exp.mesh_shape is None:
        raise ValueError("call_longform: not a long-form artifact")
    if mesh.size != exp.nr_devices:
        raise ValueError(f"artifact was exported for {exp.nr_devices} "
                         f"devices; mesh has {mesh.size}")
    shape = (mesh.shape[DATA_AXIS], mesh.shape[FRAME_AXIS])
    if shape != exp.mesh_shape:
        raise ValueError(f"artifact was exported for a {exp.mesh_shape} "
                         f"(data, frame) mesh; mesh is {shape}")
    if any(d.type != exp.device.type for d in _mesh_devices(mesh)):
        raise ValueError(f"artifact runs on {exp.device.type} devices; mesh "
                         f"has {mesh.devices}")
    if len(args) != len(exp.sharded):
        raise ValueError(f"artifact takes {len(exp.sharded)} inputs "
                         f"{exp.in_shapes}, got {len(args)}")
    inputs = []
    for a, sharded in zip(args, exp.sharded):
        if sharded:
            inputs.append(shard_array(a, mesh))
        else:
            a = torch.as_tensor(a)
            if a.dtype == torch.uint32:     # a key's bits
                a = a.view(torch.int32)
            inputs.append(a)
    if exp.program is not None and _on_one_device(mesh, exp.device):
        flat = []
        for x, sharded in zip(inputs, exp.sharded):
            flat.extend(x.shards if sharded else [x.to(exp.device)])
        return Sharded(mesh, list(exp.call(*flat)))
    if exp.longform is None:
        raise ValueError(f"call_longform: the artifact holds its single "
                         f"program alone, which runs where this process "
                         f"holds every shard on {exp.device}")
    _check_shards(exp, inputs)
    return Sharded(mesh, exp.longform.run(mesh, inputs))


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


def _program_bytes(program: torch.export.ExportedProgram) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def _shard_specs(exp: Exported) -> tuple[list, list]:
    """[shape, dtype] of one shard of each input and each output."""
    ins, k = [], 0
    for sharded in exp.sharded:
        v = exp._flat_in[k]
        ins.append([list(v.shape), _dtype_name(v.dtype)])
        k += exp.nr_devices if sharded else 1
    outs = [[list(v.shape), _dtype_name(v.dtype)]
            for v in exp._flat_out[::exp.nr_devices]]
    return ins, outs


def save_exported(exp: Exported, path: str, meta: dict | None = None
                  ) -> None:
    """Write an artifact: magic, u32 header length, JSON header (``meta``,
    else :func:`artifact_meta` of ``exp``; the device and the long-form
    layout are always recorded), the ``torch.export.save`` bytes. A
    long-form artifact's header also lists its ``sections``, written one
    after another: its single program where it has one (which holds the
    tables), else its ``tables`` (``torch.save`` of a dict), then each
    piece's program."""
    header = dict(meta) if meta is not None else artifact_meta(exp)
    header.setdefault("platforms", exp.platforms)
    header.setdefault("nr_devices", exp.nr_devices)
    header["device"] = str(exp.device)
    if exp.mesh_shape is not None:
        header.setdefault("mesh", list(exp.mesh_shape))
        header.setdefault("sharded_inputs", list(exp.sharded))
    if exp.longform is None:
        blobs = [("program", _program_bytes(exp.program))]
    else:
        lf = exp.longform
        blobs = ([("program", _program_bytes(exp.program))]
                 if exp.program is not None
                 else [("tables", lf.tables_blob())])
        blobs += [(f"piece:{k}", lf.blob(k)) for k in lf.keys]
        shard_in, shard_out = _shard_specs(exp)
        header["longform"] = dict(lf.params, tables=lf.names,
                                  shard_in=shard_in, shard_out=shard_out)
        header["sections"] = [[name, len(b)] for name, b in blobs]
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(head)))
        f.write(head)
        for _, b in blobs:
            f.write(b)


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


def _load_program(path: str, blob: bytes) -> torch.export.ExportedProgram:
    try:
        return torch.export.load(io.BytesIO(blob))
    except Exception as e:      # a cut or damaged archive
        raise ValueError(f"{path}: truncated or corrupt program "
                         f"({type(e).__name__}: {e})") from None


def _sections(path: str, header: dict, blob: bytes) -> dict[str, bytes]:
    """The file's sections by name (one ``program`` to the end of the file
    where the header lists none)."""
    sections = header.get("sections", [["program", len(blob)]])
    if sum(n for _, n in sections) != len(blob):
        raise ValueError(f"{path}: truncated or corrupt program (the "
                         f"sections take {sum(n for _, n in sections)} "
                         f"bytes, the file holds {len(blob)})")
    out, at = {}, 0
    for name, n in sections:
        out[name] = blob[at:at + n]
        at += n
    return out


def _load_longform(path: str, header: dict, parts: dict, program,
                   device: torch.device) -> tuple["_Longform", tuple]:
    """The per-shard form of a long-form artifact, and its inputs' and
    outputs' flat specs (read off its single program where it has one)."""
    lf = header["longform"]
    names = lf["tables"]
    if program is not None:
        tables = [program.state_dict[f"codec.{n}"] for n in names]
    else:
        try:
            held = torch.load(io.BytesIO(parts["tables"]),
                              map_location=device, weights_only=True)
        except Exception as e:
            raise ValueError(f"{path}: truncated or corrupt tables "
                             f"({type(e).__name__}: {e})") from None
        tables = [held[n] for n in names]
    blobs = {name.removeprefix("piece:"): b for name, b in parts.items()
             if name.startswith("piece:")}
    params = {k: v for k, v in lf.items()
              if k not in ("tables", "shard_in", "shard_out")}
    n = header["nr_devices"]
    flat_in = []
    for (shape, dtype), sharded in zip(lf["shard_in"],
                                       header["sharded_inputs"]):
        flat_in += [_meta(shape, getattr(torch, dtype))] * (
            n if sharded else 1)
    flat_out = [_meta(shape, getattr(torch, dtype))
                for shape, dtype in lf["shard_out"] for _ in range(n)]
    return (_Longform(params, names, tables, device, blobs=blobs, path=path),
            (flat_in, flat_out))


def load_exported(path: str) -> Exported:
    """Load an artifact written by :func:`save_exported` onto the device it
    was built for (raises RuntimeError when that device is absent)."""
    header, blob = _read_artifact(path, with_blob=True)
    device = torch.device(header.get("device", "cpu"))
    _cuda.require_device(device, "load_exported",
                         hint="load it where its device is")
    parts = _sections(path, header, blob)
    program = (_load_program(path, parts["program"]) if "program" in parts
               else None)
    mesh = header.get("mesh")
    longform = flat = None
    if "longform" in header:
        longform, flat = _load_longform(path, header, parts, program, device)
    return Exported(program, device, header.get("nr_devices", 1),
                    None if mesh is None else tuple(mesh),
                    None if mesh is None else tuple(header["sharded_inputs"]),
                    longform, flat)


def read_artifact_meta(path: str) -> dict:
    """The JSON header (an empty dict for a header-less JAX v1 artifact);
    reads only the header bytes."""
    return _read_artifact(path, with_blob=False)[0]
