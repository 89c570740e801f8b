"""Long-form frame-sharded pipelines: the user-facing API over
parallel/sharded.py.

Counterpart of ``gomel_tpu/pipelines/longform.py``. Hour-scale audio is cut into runs of
frames over the mesh's 'frame' axis with a one-window halo, composed with
the 'data' batch axis; this module hides the plan, padding and trim behind
the encode/decode shapes of pipelines.mel / pipelines.phase and gives the
same file API.

Typical use::

    mesh = make_mesh(data=1, frame=4, devices=[torch.device("cuda", 0)] * 4)
    lf = LongFormPhase(PhaseConfig.cli_default(), mesh)
    spec = lf.encode(batch_of_long_audio)   # [B, F, num_freqs, 2]
    wav = lf.decode(spec)                   # [B, out_len]

On a mesh that one process owns, results are tensors on the mesh's first
device. On a mesh over several processes (parallel/mesh.py) every process
passes the same whole host input (the replicated-input model: each read the
same file), uploads only its own shards, and gets back its own shards, not
gathered: a :class:`parallel.mesh.Sharded` trimmed to the result's shape
(read it with ``addressable_shards``), which ``decode`` also takes as its
input. The file calls need the whole file on one host and refuse such a
mesh; :func:`save_gl_checkpoint_sharded` and
:func:`load_gl_checkpoint_sharded` persist a ``decode_resumable`` carry
shard by shard, each process its own. On the file paths with
``device_quantize``, only int16 samples go to the shards (converted there by
kernel KA) and the quantizer (KD / KF) runs on the trimmed global
spectrogram gathered on the mesh's first device, so its extrema are the
whole file's; the decodes upload integer planes, de-quantize them per shard
(kernel KL) and read back int16 samples (KM's PCM-16 epilogue).
"""
from __future__ import annotations

import dataclasses
import os
import shutil

import numpy as np
import torch

from ..core.config import ConfigError, MelConfig, PhaseConfig, pad_shift
from ..core.filterbank import inverse_mel_weights, mel_weights
from ..core.framing import is_padded, num_frames, pad_length
from ..io import audio as audio_io
from ..io import imagecodec
from ..ops._cuda import require_device
from ..ops.quantize import (dequantize_raw, pcm16_ingest_batch,
                            quantize_mel_plane, quantize_planes)
from ..ops.resample import zero_stuff_upsample
from ..parallel import sharded as sh
from ..parallel.mesh import (_CPU_MESH_HINT, DATA_AXIS, FRAME_AXIS, Mesh,
                             Sharded, all_reduce_min_host, make_mesh,
                             process_count, process_index, shard_array)
from ..utils.profiling import annotate, transfer


def _default_mesh(what: str) -> Mesh:
    """Every CUDA device on the 'frame' axis (with a process group of
    several processes, each process's card); raises without CUDA."""
    require_device("cuda", what, hint=_CPU_MESH_HINT)
    n = process_count() if process_count() > 1 else torch.cuda.device_count()
    return make_mesh(data=1, frame=n)


def _as_array(x):
    """A tensor or a Sharded array stays; anything else becomes a numpy
    array."""
    return x if isinstance(x, (torch.Tensor, Sharded)) else np.asarray(x)


class _LongFormBase:
    """Shared plumbing: plan and function cache, batch padding to the data
    axis, signal and frame prep, trim, raw int16 ingest."""

    def __init__(self, mesh: Mesh | None, window: int, resolut: int,
                 dtype: torch.dtype):
        self.mesh = _default_mesh(type(self).__name__) if mesh is None \
            else mesh
        self.n_frame_shards = self.mesh.shape[FRAME_AXIS]
        self._hop = window
        self._frame_len = resolut
        self.dtype = dtype
        self._fn_cache: dict = {}

    def _plan(self, n_samples: int) -> sh.FrameShardPlan:
        padded = pad_length(n_samples, self._hop)
        f = num_frames(padded, self._frame_len, self._hop)
        return sh.plan_frame_sharding(f, self._frame_len, self._hop,
                                      self.n_frame_shards)

    def _plan_for_frames(self, f: int) -> sh.FrameShardPlan:
        return sh.plan_frame_sharding(f, self._frame_len, self._hop,
                                      self.n_frame_shards)

    def _get(self, key, builder):
        if key not in self._fn_cache:
            self._fn_cache[key] = builder()
        return self._fn_cache[key]

    def _pad_batch(self, x):
        """Pad the batch dim to a multiple of the data-axis size (zero rows
        are sliced off by the caller via the returned true row count)."""
        n_data = self.mesh.shape[DATA_AXIS]
        b = x.shape[0]
        target = -(-b // n_data) * n_data
        if target != b:
            pad = [(0, target - b)] + [(0, 0)] * (x.ndim - 1)
            x = sh._pad_last(x, pad)
        return x, b

    def _prep_signal(self, x, plan: sh.FrameShardPlan, raw: bool = False
                     ) -> tuple[Sharded, int]:
        """[B, L] (or [L]) audio -> the padded batch sharded over the mesh,
        in the working dtype (``raw``: as it is, int16 samples)."""
        x = _as_array(x)
        if x.ndim == 1:
            x = x[None, :]
        x, b = self._pad_batch(x)
        return shard_array(sh.pad_signal_for_plan(x, plan), self.mesh,
                           None if raw else self.dtype), b

    def _prep_frames(self, spec, plan: sh.FrameShardPlan, raw: bool = False
                     ) -> tuple[Sharded, int]:
        """Pad a [B, F, ...] spectrogram to (batch multiple, F_pad) and shard
        it, in the working dtype (``raw``: as it is, integer planes). A
        :class:`Sharded` result of this object's encode on the same mesh
        passes through as it is (its pad frames are the plan's)."""
        if isinstance(spec, Sharded):
            if (spec.mesh is not self.mesh
                    or spec.padded_shape[1] != plan.n_frames_padded):
                raise ValueError(
                    f"a Sharded spectrogram of {spec.padded_shape[1]} frames "
                    f"on another mesh or plan (this one pads to "
                    f"{plan.n_frames_padded} frames)")
            dtype = None if raw else self.dtype
            return Sharded(self.mesh, [None if s is None else s.to(dtype)
                                       for s in spec.shards]), spec.shape[0]
        spec, b = self._pad_batch(sh.pad_frames_for_plan(_as_array(spec),
                                                         plan))
        return shard_array(spec, self.mesh, None if raw else self.dtype), b

    def _trim(self, result: Sharded, b: int, n: int):
        """The [:b, :n] result: gathered on one controller, this process's
        shards (a trimmed :class:`Sharded`) on a mesh over processes."""
        if self.mesh.spans_processes:
            return Sharded(self.mesh, result.shards, trim=(b, n))
        return result.gather()[:b, :n]

    def _require_single_controller(self, what: str) -> None:
        """The file calls read or write one host file: they need the whole
        array in this process, so a mesh over several processes is refused
        (gomel_tpu/pipelines/longform.py:152)."""
        if self.mesh.spans_processes:
            raise ValueError(
                f"{what} assembles the full file on one host; on "
                f"multi-process meshes use the buffer-level encode/decode "
                f"with per-shard I/O (save_gl_checkpoint_sharded)")

    def _pcm_convert(self, xg: Sharded, scale: float) -> Sharded:
        """Raw int16 shards -> float shards, each through kernel KA (exact:
        ``scale`` is a power of two; gomel_tpu/pipelines/longform.py:147)."""
        return Sharded(self.mesh, [pcm16_ingest_batch(s, self.dtype, scale)
                                   for s in xg.shards])

    def _dequantize(self, planes: np.ndarray, maxs, mins, max_val: int,
                    ihs_passes: int, boost: float
                    ) -> tuple[Sharded, sh.FrameShardPlan]:
        """Integer image planes [bins, F, 2] -> the frame-padded [1, F_pad,
        bins, 2] float spectrogram, sharded, de-quantized per shard by
        kernel KL (the plan derives from the TRUE frame count: the sharded
        decoders' real-frame counts depend on it)."""
        plan = self._plan_for_frames(planes.shape[1])
        planes_g, _ = self._prep_frames(planes.transpose(1, 0, 2)[None], plan,
                                        raw=True)
        return Sharded(self.mesh, [
            dequantize_raw(s, maxs, mins, max_val, ihs_passes, boost,
                           self.dtype) for s in planes_g.shards]), plan


def _finite_pcm(result, out_len: int) -> np.ndarray:
    """(Sharded int16, finite [B]) -> row 0's int16 samples on the host;
    raises on a non-finite sample."""
    pcm, finite = result
    pcm = pcm.gather()[0, :out_len]
    host = torch.device("cpu")
    with transfer(pcm, host):
        wave = pcm.cpu().numpy()   # int16: half the bytes
    with transfer(finite, host):
        ok = bool(finite[0])
    if not ok:
        raise ValueError("audio contains NaN/Inf samples")
    return wave


class LongFormPhase(_LongFormBase):
    """Frame-sharded phase codec for long audio (reference
    phase/phase.go buffer APIs, scaled out). ``mesh`` defaults to every CUDA
    device on the 'frame' axis."""

    def __init__(self, config: PhaseConfig | None = None,
                 mesh: Mesh | None = None, dtype: torch.dtype = torch.float32,
                 device_quantize: bool = False):
        self.config = config or PhaseConfig()
        self.device_quantize = device_quantize
        super().__init__(mesh, self.config.window, self.config.resolut, dtype)

    def _encode_fn(self, plan: sh.FrameShardPlan):
        return self._get(("enc", plan.n_frames_padded, plan.n_frames),
                         lambda: sh.sharded_phase_encode_fn(
                             self.mesh, plan, self.config.num_freqs,
                             self.dtype))

    def _decode_fn(self, plan: sh.FrameShardPlan, pcm16: bool = False):
        boost = float(self.config.volume_boost)
        return self._get(("dec", plan.n_frames_padded, plan.n_frames, boost,
                          pcm16), lambda: sh.sharded_phase_decode_fn(
                              self.mesh, plan, boost, self.dtype,
                              pcm16=pcm16))

    def encode(self, x) -> torch.Tensor | Sharded:
        """[B, L] (or [L]) -> [B, F, num_freqs, 2] (F = real frame count;
        this process's shards of it on a mesh over processes)."""
        with annotate("gomel.longform.encode"):
            plan = self._plan(_as_array(x).shape[-1])
            xp, b = self._prep_signal(x, plan)
            return self._trim(self._encode_fn(plan)(xp), b, plan.n_frames)

    def decode(self, spec) -> torch.Tensor | Sharded:
        """[B, F, num_freqs, 2] -> [B, out_len] (this process's shards on a
        mesh over processes)."""
        with annotate("gomel.longform.decode"):
            spec = _as_array(spec)
            plan = self._plan_for_frames(spec.shape[1])
            spec_p, b = self._prep_frames(spec, plan)
            return self._trim(self._decode_fn(plan)(spec_p), b, plan.out_len)

    # -- file API (reference surface: phase/phase.go:195-275) ---------------
    def _write_spec(self, spec: torch.Tensor, original: int, sr: int,
                    output_file: str) -> None:
        """Quantize (device) or pull (host) the encoded [1, F, nf, 2]
        spectrogram and write the PNG (Go metadata layout)."""
        c = self.config
        samples_in_mel = float(original) / float(spec.shape[1])
        if self.device_quantize:
            img2, maxs, mins = quantize_planes(
                spec[0].contiguous(), 65535 if c.hdr else 255, c.ihs_passes)
            imagecodec.save_phase_image_quantized(
                output_file, img2.cpu().numpy(), maxs.cpu().numpy(),
                mins.cpu().numpy(), c.y_reverse, samples_in_mel, float(sr),
                c.hdr, layout="go")
            return
        imagecodec.save_phase_image(
            output_file, spec[0].cpu().numpy().astype(np.float64),
            c.y_reverse, samples_in_mel, float(sr), c.ihs_passes, c.hdr,
            layout="go")

    def _encode_file(self, buf: np.ndarray, sr: int,
                     output_file: str) -> None:
        original = len(buf)  # Go samples_in_mel numerator: PRE-upsample
        zp, zs = pad_shift(int(sr))
        if zp > 0:
            buf = zero_stuff_upsample(buf, zp, zs)
        self._write_spec(self.encode(buf), original, sr, output_file)

    def _encode_file_pcm(self, pcm: np.ndarray, sr: int,
                         output_file: str) -> None:
        """zp = 0 raw int16 ingest: int16 shards go up (half the bytes) and
        KA converts them on their devices, then the sharded encode."""
        plan = self._plan(len(pcm))
        xg, b = self._prep_signal(pcm, plan, raw=True)
        spec = self._trim(self._encode_fn(plan)(self._pcm_convert(
            xg, 32768.0)), b, plan.n_frames)
        self._write_spec(spec, len(pcm), sr, output_file)

    def _encode_loaded(self, buf: np.ndarray, sr: int,
                       output_file: str) -> None:
        if buf.dtype == np.int16:
            if pad_shift(int(sr))[0] == 0:
                self._encode_file_pcm(buf, sr, output_file)
                return
            # upsampled family: convert in memory, no second file decode
            buf = buf.astype(np.float64) / 32768.0
        self._encode_file(buf, sr, output_file)

    def to_phase_wav(self, input_file: str, output_file: str) -> None:
        """WAV -> phase PNG, frame-sharded over the mesh (upsample,
        samples_in_mel, Go metadata layout; phase/phase.go:221-244)."""
        self._require_single_controller("LongFormPhase.to_phase_wav")
        buf, sr = audio_io.load_wav_any(input_file, mono="left",
                                        raw_pcm16=self.device_quantize)
        self._encode_loaded(buf, sr, output_file)

    def to_phase_flac(self, input_file: str, output_file: str) -> None:
        """FLAC -> phase PNG, frame-sharded (phase/phase.go:195-218; 1/32768
        scaling)."""
        self._require_single_controller("LongFormPhase.to_phase_flac")
        buf, sr = audio_io.load_flac_any(input_file, mono="go_concat",
                                         scaling="phase",
                                         raw_pcm16=self.device_quantize)
        self._encode_loaded(buf, sr, output_file)

    def to_wav_png(self, input_file: str, output_file: str,
                   layout: str = "auto") -> int:
        """phase PNG -> WAV, frame-sharded decode (phase/phase.go:246-275).
        Returns the sample rate written."""
        self._require_single_controller("LongFormPhase.to_wav_png")
        c = self.config
        if self.device_quantize:
            planes, maxs, mins, samples, sr, nf = \
                imagecodec.load_phase_image_raw(input_file, c.y_reverse,
                                                c.hdr, layout=layout)
            if nf != c.num_freqs:
                self.config = c = dataclasses.replace(c, num_freqs=nf)
            spec_g, plan = self._dequantize(planes, maxs, mins,
                                            65535 if c.hdr else 255,
                                            c.ihs_passes, 0.0)
            wave = _finite_pcm(self._decode_fn(plan, pcm16=True)(spec_g),
                               plan.out_len)
        else:
            spec, samples, sr, nf = imagecodec.load_phase_image(
                input_file, c.y_reverse, c.ihs_passes, c.hdr, layout=layout)
            if nf != c.num_freqs:
                self.config = c = dataclasses.replace(c, num_freqs=nf)
            wave = self.decode(spec[None])[0].cpu().numpy().astype(np.float64)
        samples_i = int(samples)
        if samples_i > 0 and is_padded(samples_i, len(wave), c.window) \
                and len(wave) > samples_i:
            wave = wave[:samples_i]
        out_sr = c.sample_rate
        if sr != 0 and out_sr == 0:
            out_sr = c.family_main_rate
        if self.device_quantize:
            audio_io.save_wav_pcm16(output_file, wave, out_sr)
        else:
            audio_io.save_wav(output_file, wave, out_sr)
        return out_sr


class LongFormMel(_LongFormBase):
    """Frame-sharded mel codec with sharded Griffin-Lim (reference
    mel/mel.go buffer APIs, scaled out). ``mesh`` defaults to every CUDA
    device on the 'frame' axis."""

    def __init__(self, config: MelConfig | None = None,
                 mesh: Mesh | None = None, dtype: torch.dtype = torch.float32,
                 device_quantize: bool = False):
        self.config = config or MelConfig()
        self.device_quantize = device_quantize
        super().__init__(mesh, self.config.window, self.config.resolut, dtype)
        c = self.config
        self._fwd = mel_weights(c.n_bins, c.num_mels, c.mel_fmin, c.mel_fmax)
        self._inv = inverse_mel_weights(c.n_bins, c.num_mels, c.mel_fmin,
                                        c.mel_fmax)

    @classmethod
    def from_numpy(cls, config: MelConfig, mesh: Mesh | None,
                   fwd_weights: np.ndarray, inv_weights: np.ndarray,
                   **kwargs) -> "LongFormMel":
        """A ``LongFormMel`` whose filterbanks are the given arrays (for
        example the JAX package's ``LongFormMel._fwd`` and ``_inv``)."""
        fwd, inv = np.asarray(fwd_weights), np.asarray(inv_weights)
        if fwd.shape != (config.num_mels, config.n_bins) or \
                inv.shape != (config.n_bins, config.num_mels):
            raise ValueError(f"filterbanks {fwd.shape}, {inv.shape} do not "
                             f"match {config.num_mels} mels x "
                             f"{config.n_bins} bins")
        lf = cls(config, mesh, **kwargs)
        lf._fwd, lf._inv = fwd, inv
        return lf

    def _encode_fn(self, plan: sh.FrameShardPlan):
        return self._get(("enc", plan.n_frames_padded, plan.n_frames),
                         lambda: sh.sharded_mel_encode_fn(
                             self.mesh, plan, self.config.num_mels,
                             self._fwd, self.dtype))

    def _decode_fn(self, plan: sh.FrameShardPlan, momentum: float,
                   pcm16: bool = False):
        c = self.config
        return self._get(("dec", plan.n_frames_padded, plan.n_frames,
                          c.griffin_lim_iterations, momentum, pcm16),
                         lambda: sh.sharded_mel_decode_fn(
                             self.mesh, plan, self._inv,
                             c.griffin_lim_iterations, c.tune_mul, c.tune_add,
                             self.dtype, momentum=momentum, pcm16=pcm16))

    def _check_mels(self, mels: int) -> None:
        if mels != self.config.num_mels:
            raise ConfigError(
                f"spectrogram has {mels} mel bins but config.num_mels="
                f"{self.config.num_mels}; decode with the same config the "
                f"image was written with")

    def encode(self, x) -> torch.Tensor | Sharded:
        """[B, L] (or [L]) -> [B, F, num_mels, 2] log-mel (this process's
        shards on a mesh over processes)."""
        with annotate("gomel.longform.encode"):
            plan = self._plan(_as_array(x).shape[-1])
            xp, b = self._prep_signal(x, plan)
            return self._trim(self._encode_fn(plan)(xp), b, plan.n_frames)

    def decode(self, logmel, seed: int = 0,
               momentum: float = 0.0) -> torch.Tensor | Sharded:
        """[B, F, num_mels, 2] -> [B, out_len] (this process's shards on a
        mesh over processes) via sharded Griffin-Lim from
        per-shard starts, each drawn on its shard's device from the key
        ``fold_in(key(seed), shard)`` (parallel/sharded._shard_noise): the
        JAX package's starts for that seed on the same mesh shape.
        ``momentum`` > 0 opts into fast Griffin-Lim."""
        with annotate("gomel.longform.decode"):
            logmel = _as_array(logmel)
            plan = self._plan_for_frames(logmel.shape[1])
            logmel_p, b = self._prep_frames(logmel, plan)
            return self._trim(self._decode_fn(plan, float(momentum))(
                logmel_p, seed), b, plan.out_len)

    # -- file API (reference surface: mel/mel.go:176-238) -------------------
    def _write_spec(self, spec: torch.Tensor, input_len: int, sr: int,
                    output_file: str) -> None:
        c = self.config
        samples_in_mel = float(input_len) / float(spec.shape[1])
        if self.device_quantize:
            img2, mx, mn = quantize_mel_plane(spec[0].contiguous(), 255)
            imagecodec.save_mel_image_quantized(
                output_file, img2.cpu().numpy(), float(mx), float(mn),
                c.y_reverse, samples_in_mel, float(sr))
            return
        imagecodec.save_mel_image(
            output_file, spec[0].cpu().numpy().astype(np.float64),
            c.y_reverse, samples_in_mel, float(sr))

    def _encode_file_pcm(self, pcm: np.ndarray, sr: int, output_file: str,
                         scale: float) -> None:
        """Raw int16 ingest (see LongFormPhase._encode_file_pcm); mel has no
        upsample, so every 16-bit file qualifies. ``scale``: 32768 for WAV,
        65536 for mel-scaled FLAC."""
        plan = self._plan(len(pcm))
        xg, b = self._prep_signal(pcm, plan, raw=True)
        spec = self._trim(self._encode_fn(plan)(self._pcm_convert(xg, scale)),
                          b, plan.n_frames)
        self._write_spec(spec, len(pcm), sr, output_file)

    def to_mel_wav(self, input_file: str, output_file: str) -> None:
        """WAV -> mel PNG, frame-sharded over the mesh (mel/mel.go:194-209)."""
        self._require_single_controller("LongFormMel.to_mel_wav")
        buf, sr = audio_io.load_wav_any(input_file, mono="left",
                                        raw_pcm16=self.device_quantize)
        if buf.dtype == np.int16:
            self._encode_file_pcm(buf, sr, output_file, 32768.0)
            return
        self._write_spec(self.encode(buf), len(buf), sr, output_file)

    def to_mel_flac(self, input_file: str, output_file: str) -> None:
        """FLAC -> mel PNG, frame-sharded (mel/mel.go:176-191; mel 1/65536
        FLAC scaling)."""
        self._require_single_controller("LongFormMel.to_mel_flac")
        buf, sr = audio_io.load_flac_any(input_file, mono="go_concat",
                                         scaling="mel",
                                         raw_pcm16=self.device_quantize)
        if buf.dtype == np.int16:
            self._encode_file_pcm(buf, sr, output_file, 65536.0)
            return
        self._write_spec(self.encode(buf), len(buf), sr, output_file)

    def to_wav_png(self, input_file: str, output_file: str, seed: int = 0,
                   momentum: float = 0.0) -> int:
        """mel PNG -> WAV via the frame-sharded Griffin-Lim decoder
        (mel/mel.go:211-238). VolumeBoost is added in the log domain before
        the decode; trim and embedded-rate rules match the single-file
        path. Returns the sample rate written."""
        self._require_single_controller("LongFormMel.to_wav_png")
        c = self.config
        if self.device_quantize:
            planes, mx, mn, samples, sr = imagecodec.load_mel_image_raw(
                input_file, c.y_reverse)
            self._check_mels(planes.shape[0])
            logmel_g, plan = self._dequantize(planes, mx, mn, 255, 0,
                                              float(c.volume_boost))
            wave = _finite_pcm(self._decode_fn(plan, float(momentum),
                                               pcm16=True)(logmel_g, seed),
                               plan.out_len)
        else:
            spec, samples, sr = imagecodec.load_mel_image(input_file,
                                                          c.y_reverse)
            self._check_mels(spec.shape[1])
            if c.volume_boost != 0.0:
                spec = spec + c.volume_boost
            wave = self.decode(spec[None], seed=seed, momentum=momentum
                               )[0].cpu().numpy().astype(np.float64)
        samples_i = int(samples)
        if samples_i > 0 and is_padded(samples_i, len(wave), c.window) \
                and len(wave) > samples_i:
            wave = wave[:samples_i]
        out_sr = c.sample_rate
        if sr != 0 and out_sr == 0:
            out_sr = int(sr)
        if self.device_quantize:
            audio_io.save_wav_pcm16(output_file, wave, out_sr)
        else:
            audio_io.save_wav(output_file, wave, out_sr)
        return out_sr

    # -- resumable decode -----------------------------------------------------
    def decode_resumable(self, logmel, seed: int = 0, momentum: float = 0.0,
                         segment_iters: int = 8, callback=None,
                         resume: tuple[int, object] | None = None
                         ) -> torch.Tensor | Sharded:
        """``decode`` split into segments of ``segment_iters`` Griffin-Lim
        iterations; after each, ``callback(done_iters, carry)`` may persist
        the signal carry (a Sharded [B, F_pad*hop]; :func:`save_gl_checkpoint`,
        or on a mesh over processes :func:`save_gl_checkpoint_sharded`) and
        ``resume=(done_iters, carry)`` restarts from one (a whole host array,
        or a Sharded carry such as :func:`load_gl_checkpoint_sharded`
        returns). With
        ``momentum == 0`` the segments run the same iterations as
        ``decode`` from the same per-shard starts: bit-for-bit equal output.
        With momentum the extrapolation restarts at segment boundaries."""
        if segment_iters < 1:
            raise ValueError("segment_iters must be >= 1")
        logmel = _as_array(logmel)
        plan = self._plan_for_frames(logmel.shape[1])
        c = self.config
        total = c.griffin_lim_iterations
        logmel_p, b = self._prep_frames(logmel, plan)
        mags = self._get(("mags",), lambda: sh.sharded_mel_magnitudes_fn(
            self.mesh, self._inv, c.tune_mul, c.tune_add, self.dtype))
        mag = mags(logmel_p)
        if resume is None:
            sig = sh.sharded_gl_noise_fn(self.mesh, plan, logmel_p.shape[0],
                                         self.dtype)(seed)
            done = 0
        else:
            done, sig = resume
            if not isinstance(sig, Sharded):
                sig = shard_array(_as_array(sig), self.mesh, self.dtype)
        while done < total:
            step = min(segment_iters, total - done)
            last = done + step == total
            # the key includes n_frames: two inputs with different real frame
            # counts can pad to the same n_frames_padded
            gl = self._get(("glseg", plan.n_frames_padded, plan.n_frames,
                            step, last, momentum),
                           lambda: sh.sharded_griffin_lim_fn(
                               self.mesh, plan, step, self.dtype,
                               momentum=momentum, final_iteration=last))
            sig = gl(mag, sig)
            done += step
            if callback is not None:
                callback(done, sig)
        return self._trim(sig, b, plan.out_len)


# ---------------------------------------------------------------------------
# Checkpoint persistence for decode_resumable
# ---------------------------------------------------------------------------

def save_gl_checkpoint(path: str, done: int, carry) -> None:
    """Persist a ``decode_resumable`` checkpoint (iteration count + signal
    carry, a Sharded or a whole array) to ``path`` (.npz). A mesh over
    several processes holds no whole carry in one of them: there use
    :func:`save_gl_checkpoint_sharded`."""
    if isinstance(carry, Sharded):
        if carry.mesh.spans_processes:
            raise ValueError(
                "save_gl_checkpoint needs the full carry on one host; on "
                "multi-process meshes persist it shard by shard with "
                "save_gl_checkpoint_sharded from the decode_resumable "
                "callback")
        carry = carry.gather()
    if isinstance(carry, torch.Tensor):
        carry = carry.cpu().numpy()
    with open(path, "wb") as f:
        np.savez(f, done=int(done), carry=np.asarray(carry))


def load_gl_checkpoint(path: str) -> tuple[int, np.ndarray]:
    """Load a checkpoint written by :func:`save_gl_checkpoint`; pass the
    result as ``decode_resumable(..., resume=...)``."""
    with open(path, "rb") as f:
        z = np.load(f)
        return int(z["done"]), z["carry"]


# -- multi-process checkpoints: each process persists its own shards --------

def _index_key(index, shape) -> str:
    """Canonical string for a shard's global slice (device independent,
    stable across restarts): ``start-stop`` of each axis, joined by ``_``
    (gomel_tpu/pipelines/longform.py:626)."""
    parts = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        parts.append(f"{start}-{stop}")
    return "_".join(parts)


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float32"), as the JAX package's META
    records it."""
    return str(dtype).removeprefix("torch.")


def save_gl_checkpoint_sharded(ckpt_dir: str, done: int,
                               carry: Sharded) -> None:
    """Checkpoint of a ``decode_resumable`` carry on any mesh, over several
    processes too: every process writes the shards it owns, one .npz per
    global slice, and no process needs the whole carry (the JAX package's
    layout, gomel_tpu/pipelines/longform.py:637).

    Each iteration count gets its own ``iter_<done>/`` directory; a file
    lands under a temporary name and is renamed into place; every shard file
    stamps ``done``; ``META.npz`` (done, shape, dtype) is written alike by
    every process; a process writes its ``COMPLETE.p<rank>`` marker last,
    after all its files. A save cut short leaves a directory that
    :func:`load_gl_checkpoint_sharded` skips, and files are keyed by global
    slice, so a restart on a mesh of the same shape reassembles them
    whatever its devices."""
    if carry.trim is not None:
        raise ValueError("save_gl_checkpoint_sharded takes the untrimmed "
                         "carry that decode_resumable's callback receives")
    shape = carry.padded_shape
    sub = os.path.join(ckpt_dir, f"iter_{int(done):08d}")
    os.makedirs(sub, exist_ok=True)
    pid = process_index()
    for shard in carry.addressable_shards:
        fname = os.path.join(sub, f"shard_{_index_key(shard.index, shape)}"
                                  f".npz")
        tmp = fname + f".tmp{pid}"
        with open(tmp, "wb") as f:
            np.savez(f, data=shard.data.cpu().numpy(), done=int(done))
        os.replace(tmp, fname)
    meta = os.path.join(sub, "META.npz")
    tmp = meta + f".tmp{pid}"
    with open(tmp, "wb") as f:
        np.savez(f, done=int(done), shape=np.asarray(shape),
                 dtype=_dtype_name(carry.dtype))
    os.replace(tmp, meta)
    with open(os.path.join(sub, f"COMPLETE.p{pid}"), "w"):
        pass


def _complete_checkpoints(ckpt_dir: str) -> list[int]:
    """Iteration counts with META and this process's completeness marker,
    ascending."""
    pid = process_index()
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return []
    out = []
    for name in names:
        sub = os.path.join(ckpt_dir, name)
        if (name.startswith("iter_")
                and os.path.exists(os.path.join(sub, f"COMPLETE.p{pid}"))
                and os.path.exists(os.path.join(sub, "META.npz"))):
            out.append(int(name[5:]))
    return sorted(out)


def prune_gl_checkpoints(ckpt_dir: str, keep_last: int = 2) -> None:
    """Drop old checkpoint iterations, keeping the newest ``keep_last``
    complete ones (by this process's markers). One process removes whole
    directories; on several, each drops its own marker first, then the
    shard files. Call it from the ``decode_resumable`` callback right after
    a save, in every process at the same point, so no marker outlives its
    shard files (a stale marker would make a later load fail on a missing
    file, never reassemble wrong data: the stamps are checked)."""
    if keep_last < 1:
        raise ValueError("keep_last must be >= 1")
    for done in _complete_checkpoints(ckpt_dir)[:-keep_last]:
        sub = os.path.join(ckpt_dir, f"iter_{done:08d}")
        if process_count() == 1:
            shutil.rmtree(sub, ignore_errors=True)
            continue
        try:
            os.remove(os.path.join(sub, f"COMPLETE.p{process_index()}"))
        except FileNotFoundError:
            pass
        for name in os.listdir(sub):
            if name.startswith("shard_"):
                try:
                    os.remove(os.path.join(sub, name))
                except FileNotFoundError:
                    pass   # another process's, already gone


def load_gl_checkpoint_sharded(ckpt_dir: str, mesh: Mesh,
                               done: int | None = None
                               ) -> tuple[int, Sharded]:
    """Reassemble a :func:`save_gl_checkpoint_sharded` checkpoint on a mesh
    of the same shape: each process loads only its own shards' files.
    Returns ``(done, carry)`` for ``decode_resumable(resume=...)``.

    ``done=None`` takes the newest checkpoint every process completed: the
    processes agree on the least of their newest by a MIN all-reduce, so a
    preemption that cut some processes' saves short rolls every process
    back to the last iteration all of them finished."""
    if done is None:
        local = _complete_checkpoints(ckpt_dir)
        done = all_reduce_min_host(local[-1] if local else -1)
        if done < 0:
            raise ValueError(f"no complete checkpoint in {ckpt_dir!r} "
                             f"(in every process)")
        if done not in local:
            raise ValueError(
                f"globally-agreed checkpoint iter_{done} is not complete "
                f"on process {process_index()}")
    sub = os.path.join(ckpt_dir, f"iter_{int(done):08d}")
    with open(os.path.join(sub, "META.npz"), "rb") as f:
        z = np.load(f)
        meta_done = int(z["done"])
        shape = tuple(int(d) for d in z["shape"])
        dtype = str(z["dtype"])
    if meta_done != done:
        raise ValueError(f"checkpoint {sub!r} META stamps done={meta_done}")
    n_data, n_frame = mesh.shape[DATA_AXIS], mesh.shape[FRAME_AXIS]
    if shape[0] % n_data or shape[1] % n_frame:
        raise ValueError(f"checkpoint shape {shape} does not split over "
                         f"mesh {mesh.shape}")
    b, t = shape[0] // n_data, shape[1] // n_frame
    shards: list = [None] * mesh.size
    for i in mesh.local_indices:
        d, f = divmod(i, n_frame)
        index = (slice(d * b, (d + 1) * b), slice(f * t, (f + 1) * t))
        fname = os.path.join(sub, f"shard_{_index_key(index, shape)}.npz")
        with open(fname, "rb") as fh:
            z = np.load(fh)
            if int(z["done"]) != done:   # the mixed-iteration guard
                raise ValueError(f"shard {fname!r} stamps done="
                                 f"{int(z['done'])}, expected {done}")
            data = z["data"].astype(dtype)
        shards[i] = torch.from_numpy(data).to(mesh.device(i))
    return done, Sharded(mesh, shards)
