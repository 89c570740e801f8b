"""High-level phase codec pipeline.

Counterpart of ``gomel_tpu/pipelines/phase.py`` (reference ``Phase`` API,
phase/phase.go and the Python port phase.py): host-side orchestration (audio
files, PNG codec, length math) around the device ops (ops/phase_ops.py,
ops/quantize.py), which run the hand-written CUDA kernels on a CUDA device
and their plain PyTorch versions on the CPU.

Reference method map:
- ToPhase        -> Phase.to_phase / Phase.encode    (phase/phase.go:41-70)
- FromPhase      -> Phase.from_phase / Phase.decode  (phase/phase.go:136-153)
- ToPhaseWav     -> Phase.to_phase_wav               (phase/phase.go:221-244)
- ToPhaseFlac    -> Phase.to_phase_flac              (phase/phase.go:195-218)
- ToWavPng       -> Phase.to_wav_png                 (phase/phase.go:246-275)

Behavioral switches where Go and the Python port disagree:
- ``metadata_layout``: "go" = 16-byte phase metadata (canonical), "py" = the
  port's incompatible 12-byte layout.
- ``length_mode``: the samples_in_mel numerator uses the PRE-upsample length
  in Go (phase/phase.go:202-215) but the POST-upsample length in the port
  (phase.py:239-249). "go" is the default.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import PhaseConfig, num_freqs_for_sample_rate, pad_shift
from ..core.framing import is_padded, pad_length, zero_stuff_output_length
from ..io import audio as audio_io
from ..io import imagecodec
from ..ops import _cuda
from ..ops.phase_ops import dequantize_decode, phase_decode, phase_encode
from ..ops.quantize import pcm16_ingest, quantize_planes
from ..ops.resample import zero_stuff_upsample
from ..ops.stft import hann_window


class Phase(torch.nn.Module):
    """Phase-preserving spectrogram codec (reference parity: phase/phase.go,
    phase.py).

    The Hann window [resolut] is a buffer on ``device`` in ``dtype``; the
    codec has no other parameters. ``device_quantize`` fuses the PNG
    quantizer into the device work on file paths: raw int16 samples go up
    and integer planes plus extrema come back (encode), integer planes go up
    and int16 samples come back (decode). Its float32 truncation can flip a
    pixel by one step against the float64 host quantizer, rarely
    (ops/quantize.py). The quantized decode runs in float32 whatever
    ``dtype`` is, as in the JAX program.
    """

    def __init__(self, config: PhaseConfig | None = None,
                 dtype: torch.dtype = torch.float32,
                 metadata_layout: str = "go", length_mode: str = "go",
                 sample_rate: int | None = None,
                 device_quantize: bool = False,
                 device: torch.device | str = "cuda", **overrides):
        super().__init__()
        device = _cuda.require_device(device, "Phase")
        if config is None:
            if sample_rate is not None:
                config = PhaseConfig.for_sample_rate(sample_rate, **overrides)
            else:
                config = PhaseConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.metadata_layout = metadata_layout
        self.length_mode = length_mode
        self.device_quantize = device_quantize
        self.register_buffer(
            "window", torch.tensor(hann_window(config.resolut), dtype=dtype,
                                   device=device))

    @classmethod
    def from_numpy(cls, config: PhaseConfig, window: np.ndarray,
                   device: torch.device | str = "cuda", **kwargs) -> "Phase":
        """A ``Phase`` whose window is the given array (for example the JAX
        package's ``hann_window(resolut)`` cast to its working dtype), in its
        dtype, on ``device``."""
        win = torch.tensor(np.asarray(window))
        if win.shape != (config.resolut,):
            raise ValueError(f"window shape {tuple(win.shape)} != "
                             f"({config.resolut},)")
        p = cls(config, dtype=win.dtype, device=device, **kwargs)
        p.window.copy_(win)
        return p

    @property
    def device(self) -> torch.device:
        return self.window.device

    @property
    def dtype(self) -> torch.dtype:
        return self.window.dtype

    @property
    def _max_val(self) -> int:
        return 65535 if self.config.hdr else 255

    def reconfigure_sr(self, sample_rate: int) -> None:
        """Re-derive num_freqs from a sample rate (reference: phase.py:49-61).
        Raises UnsupportedSampleRateError outside the two families."""
        nf = num_freqs_for_sample_rate(sample_rate, hdr=self.config.hdr)
        self.config = dataclasses.replace(
            self.config, num_freqs=nf, sample_rate=sample_rate)

    def _pad(self, x, name: str) -> torch.Tensor:
        """[L] audio (numpy or tensor) -> reference-padded [L'] tensor in
        ``dtype`` on ``device`` (phase/impl.go:424-450)."""
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x))
        if x.ndim != 1:
            # a [B, L] batch would silently pad to pad_length(B) — refuse
            raise ValueError(f"Phase.{name} takes a single [L] signal (got "
                             f"shape {tuple(x.shape)}); use ops.phase_ops."
                             f"phase_encode_batch for [B, L] batches")
        x = x.to(device=self.device, dtype=self.dtype)
        padded = pad_length(x.shape[0], self.config.window)
        return torch.nn.functional.pad(x, (0, padded - x.shape[0]))

    # -- device-level API ----------------------------------------------------
    def _encode_padded(self, x: torch.Tensor) -> torch.Tensor:
        c = self.config
        return phase_encode(x, c.num_freqs, c.resolut, c.window, self.window)

    def encode(self, x) -> torch.Tensor:
        """Audio -> phase spectrogram [F, num_freqs, 2] on ``device``; applies
        reference padding first (phase/impl.go:424-450)."""
        return self._encode_padded(self._pad(x, "encode"))

    def encode_quantized(self, x):
        """Audio -> (img2 [nf, F, 2] uint8|uint16, maxs [2], mins [2]) on
        ``device``: the encode with the PNG quantizer fused in
        (ops/quantize.quantize_planes). IHS/HDR follow the config."""
        spec = self._encode_padded(self._pad(x, "encode_quantized"))
        return quantize_planes(spec, self._max_val, self.config.ihs_passes)

    def decode(self, spec2) -> torch.Tensor:
        """Phase spectrogram [F, num_freqs, 2] -> audio on ``device``."""
        c = self.config
        if not isinstance(spec2, torch.Tensor):
            spec2 = torch.from_numpy(np.array(spec2))
        spec2 = spec2.to(device=self.device, dtype=self.dtype)
        return phase_decode(spec2, c.resolut, c.window, float(c.volume_boost),
                            self.window)

    def _decode_quantized(self, planes, maxs, mins, pcm16: bool):
        c = self.config
        planes = torch.from_numpy(np.ascontiguousarray(planes)) \
            if isinstance(planes, np.ndarray) else planes
        return dequantize_decode(
            planes.to(self.device), maxs, mins, self._max_val, c.ihs_passes,
            c.resolut, c.window, float(c.volume_boost), self.window, pcm16)

    def decode_quantized(self, planes, maxs, mins) -> torch.Tensor:
        """Integer PNG planes [nf, F, 2] + per-channel extrema -> float32
        audio: dequantize (+sinh IHS undo), decode and VolumeBoost in one
        device pass (kernels KG and KH on a card). Only the integer planes
        and two extrema pairs are uploaded
        (imagecodec.load_phase_image_raw)."""
        return self._decode_quantized(planes, maxs, mins, pcm16=False)

    def decode_quantized_pcm16(self, planes, maxs, mins):
        """:meth:`decode_quantized` with the PCM-16 conversion fused in:
        returns (int16 PCM tensor, all-finite flag). Bit-identical to
        converting the float result through io.audio.save_wav; the readback
        is half the bytes."""
        return self._decode_quantized(planes, maxs, mins, pcm16=True)

    # -- reference-layout API --------------------------------------------------
    def to_phase(self, buf) -> np.ndarray:
        """Audio -> flattened [F*num_freqs, 2] float64
        (reference ToPhase, phase/phase.go:41-70)."""
        return self.encode(buf).cpu().numpy().astype(np.float64).reshape(-1, 2)

    def from_phase(self, ospectrum) -> np.ndarray:
        """Flattened [F*num_freqs, 2] -> audio float64
        (reference FromPhase, phase/phase.go:136-153)."""
        spec = np.asarray(ospectrum, dtype=np.float64).reshape(
            -1, self.config.num_freqs, 2)
        return self.decode(spec).cpu().numpy().astype(np.float64)

    def image(self, buf) -> np.ndarray:
        """uint16 R|G<<8 preview image (reference Image/dumpbuffer,
        phase/impl.go:15-43)."""
        spec = np.asarray(buf, dtype=np.float64).reshape(
            -1, self.config.num_freqs, 2)
        return imagecodec.dump_buffer_u16(spec)

    # -- file API ----------------------------------------------------------------
    def _save_quantized(self, output_file: str, quantized, original: int,
                        sr: int) -> None:
        img2, maxs, mins = (t.cpu().numpy() for t in quantized)
        c = self.config
        # float64(originalLength*NumFreqs)/float64(len(ospectrum)) with the
        # flattened spectrogram (phase/phase.go:215,241) == original/n_frames
        samples_in_mel = float(original * c.num_freqs) / float(
            img2.shape[1] * c.num_freqs)
        imagecodec.save_phase_image_quantized(
            output_file, img2, maxs, mins, c.y_reverse, samples_in_mel,
            float(sr), c.hdr, layout=self.metadata_layout)

    def _encode_file(self, buf: np.ndarray, sr: int, output_file: str,
                     update_sr_after_upsample: bool = False) -> None:
        original_pre = len(buf)
        zp, zs = pad_shift(int(sr))
        if zp > 0:
            buf = zero_stuff_upsample(buf, zp, zs)
            if update_sr_after_upsample:
                sr = int(sr * len(buf) / original_pre)
        original = original_pre if self.length_mode == "go" else len(buf)
        if self.device_quantize:
            self._save_quantized(output_file, self.encode_quantized(buf),
                                 original, sr)
            return
        c = self.config
        spec = self.encode(buf).cpu().numpy().astype(np.float64)
        samples_in_mel = float(original * c.num_freqs) / float(
            spec.shape[0] * c.num_freqs)
        imagecodec.save_phase_image(
            output_file, spec, c.y_reverse, samples_in_mel, float(sr),
            c.ihs_passes, c.hdr, layout=self.metadata_layout)

    def _encode_file_pcm(self, pcm: np.ndarray, sr: int, output_file: str,
                         update_sr_after_upsample: bool = False,
                         scale: float = 32768.0) -> None:
        """Device-quantize file encode from RAW int16 PCM: the int16->float
        conversion, stereo mean, zero-stuff upsample and padding (kernel KA),
        the encode (KE) and the PNG quantizer (KF) all run on the device;
        only int16 samples go up."""
        c = self.config
        original_pre = pcm.shape[0]
        zp, zs = pad_shift(int(sr))
        up_len = zero_stuff_output_length(original_pre, zp, zs)
        if zp > 0 and update_sr_after_upsample:
            sr = int(sr * up_len / original_pre)
        original = original_pre if self.length_mode == "go" else up_len
        padded = pad_length(up_len, c.window)
        if not pcm.flags.writeable:
            pcm = pcm.copy()
        x = pcm16_ingest(torch.from_numpy(pcm).to(self.device), self.dtype,
                         scale, padded, zp, zs)
        spec = self._encode_padded(x)
        self._save_quantized(
            output_file, quantize_planes(spec, self._max_val, c.ihs_passes),
            original, sr)

    def to_phase_wav(self, input_file: str, output_file: str) -> None:
        """WAV -> phase PNG with zero-stuff upsampling
        (reference ToPhaseWav, phase/phase.go:221-244)."""
        mono = "left" if self.metadata_layout == "go" else "mean"
        buf, sr = audio_io.load_wav_any(input_file, mono=mono,
                                        raw_pcm16=self.device_quantize)
        if self.config.sample_rate == 0 and self.metadata_layout == "py":
            self.reconfigure_sr(sr)
        if buf.dtype == np.int16:
            self._encode_file_pcm(buf, sr, output_file)
            return
        self._encode_file(buf, sr, output_file)

    def to_phase_flac(self, input_file: str, output_file: str) -> None:
        """FLAC -> phase PNG (reference ToPhaseFlac, phase/phase.go:195-218;
        phase FLAC scaling is 1/32768, phase/impl.go:375). With
        ``device_quantize`` a 16-bit file goes to the device as raw int16
        (kernel KA). With ``length_mode="py"`` the recorded rate is scaled by
        the upsample, as the Python port does for FLAC (phase.py:274-275)."""
        mono = "go_concat" if self.metadata_layout == "go" else "mean"
        buf, sr = audio_io.load_flac_any(input_file, mono=mono,
                                         scaling="phase",
                                         raw_pcm16=self.device_quantize)
        if self.config.sample_rate == 0 and self.metadata_layout == "py":
            self.reconfigure_sr(sr)
        update_sr = self.length_mode == "py"
        if buf.dtype == np.int16:
            self._encode_file_pcm(buf, sr, output_file,
                                  update_sr_after_upsample=update_sr)
            return
        self._encode_file(buf, sr, output_file,
                          update_sr_after_upsample=update_sr)

    def to_tensor(self, buf, sr: int) -> torch.Tensor:
        """Audio buffer + rate -> spectrogram [F, num_freqs, 2] on ``device``:
        the ML-pipeline hook (phase.py:291-318), upsample + encode, no PNG
        round trip."""
        zp, zs = pad_shift(int(sr))
        if zp > 0:
            buf = zero_stuff_upsample(np.asarray(buf), zp, zs)
        return self.encode(buf)

    def to_tensor_flac(self, input_file: str) -> np.ndarray:
        """FLAC -> flattened [F*num_freqs, 2] float64 spectrogram (the
        Python port's ML hook, phase.py:291-318): channel mean, phase
        scaling, the rate adopted when none is configured."""
        buf, sr = audio_io.load_flac(input_file, mono="mean", scaling="phase")
        if self.config.sample_rate == 0:
            self.reconfigure_sr(sr)
        return self.to_tensor(buf, sr).cpu().numpy().astype(
            np.float64).reshape(-1, 2)

    def to_wav_png(self, input_file: str, output_file: str,
                   layout: str = "auto") -> int:
        """phase PNG -> WAV (reference ToWavPng, phase/phase.go:246-275).

        Returns the sample rate written. Output rate is the family main rate
        (48000/44100) when the object has none configured. ``layout`` picks
        the metadata layout of the input image ("go"/"py"; "auto" detects,
        imagecodec._detect_phase_layout)."""
        c = self.config
        if self.device_quantize:
            planes, maxs, mins, samples, sr, nf = \
                imagecodec.load_phase_image_raw(input_file, c.y_reverse,
                                                c.hdr, layout=layout)
        else:
            spec, samples, sr, nf = imagecodec.load_phase_image(
                input_file, c.y_reverse, c.ihs_passes, c.hdr, layout=layout)
        if nf != c.num_freqs:
            # adopt the image's bin count (port behavior, phase.py:329)
            self.config = dataclasses.replace(c, num_freqs=nf)
        if self.device_quantize:
            pcm, finite = self.decode_quantized_pcm16(planes, maxs, mins)
            wave = pcm.cpu().numpy()   # int16 readback: half the bytes
            if not bool(finite):
                raise ValueError("audio contains NaN/Inf samples")
        else:
            wave = self.decode(spec).cpu().numpy().astype(np.float64)
        samples_i = int(samples)
        if samples_i > 0 and is_padded(samples_i, len(wave),
                                       self.config.window) \
                and len(wave) > samples_i:
            wave = wave[:samples_i]
        out_sr = self.config.sample_rate
        if sr != 0 and out_sr == 0:
            out_sr = self.config.family_main_rate
        if self.device_quantize:
            audio_io.save_wav_pcm16(output_file, wave, out_sr)
        else:
            audio_io.save_wav(output_file, wave, out_sr)
        return out_sr
