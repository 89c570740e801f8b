"""High-level mel codec pipeline.

Counterpart of ``gomel_tpu/pipelines/mel.py`` (reference ``Mel`` API,
mel/mel.go): host-side orchestration (audio files, PNG codec, length math)
around the device ops (ops/mel_ops.py, ops/griffinlim.py, ops/quantize.py),
which run the hand-written CUDA kernels on a CUDA device and their plain
PyTorch versions on the CPU.

Reference method map:
- ToMel        -> Mel.to_mel / Mel.encode        (mel/mel.go:46-74)
- FromMel      -> Mel.from_mel / Mel.decode      (mel/mel.go:142-152)
- ToMelWav     -> Mel.to_mel_wav                 (mel/mel.go:194-209)
- ToMelFlac    -> Mel.to_mel_flac                (mel/mel.go:176-191)
- ToWavPng     -> Mel.to_wav_png                 (mel/mel.go:211-238)
- Image        -> Mel.image                      (mel/mel.go:171-173, impl.go:16-44)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import ConfigError, MelConfig
from ..core.filterbank import inverse_mel_weights, mel_weights
from ..core.framing import is_padded, pad_length
from ..io import audio as audio_io
from ..io import imagecodec
from ..ops import _cuda, prng
from ..ops.griffinlim import griffin_lim
from ..ops.mel_ops import mel_decode, mel_encode, mel_to_magnitudes
from ..ops.quantize import quantize_mel_plane
from ..ops.stft import hann_window


class Mel(torch.nn.Module):
    """Mel spectrogram codec (reference parity: mel/mel.go).

    The forward filterbank [num_mels, N/2], the inverse filterbank U
    [N/2, num_mels] and the Hann window [N] are buffers on ``device`` in
    ``dtype``. ``device_quantize`` fuses the PNG (de)quantizer into the
    device work on file paths: only uint8 planes and two extrema cross to
    or from the device, and int16 samples come back from the decode. Its
    float32 truncation can flip a pixel by one step against the float64
    host quantizer, rarely (ops/quantize.py); the quantized decode runs in
    float32 whatever ``dtype`` is, as in the JAX program.
    """

    def __init__(self, config: MelConfig | None = None,
                 dtype: torch.dtype = torch.float32,
                 device_quantize: bool = False,
                 device: torch.device | str = "cuda", **overrides):
        super().__init__()
        device = _cuda.require_device(device, "Mel")
        if config is None:
            config = MelConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.device_quantize = device_quantize
        c = config
        fwd = mel_weights(c.n_bins, c.num_mels, c.mel_fmin, c.mel_fmax)
        self.register_buffer(
            "fwd_weights", torch.tensor(fwd, dtype=dtype, device=device))
        inv = inverse_mel_weights(c.n_bins, c.num_mels, c.mel_fmin, c.mel_fmax)
        self.register_buffer(
            "inv_weights", torch.tensor(inv, dtype=dtype, device=device))
        self.register_buffer(
            "window", torch.tensor(hann_window(c.resolut), dtype=dtype,
                                   device=device))

    @classmethod
    def from_numpy(cls, config: MelConfig, fwd_weights: np.ndarray,
                   window: np.ndarray, inv_weights: np.ndarray | None = None,
                   device: torch.device | str = "cuda") -> "Mel":
        """A ``Mel`` whose filterbank, window and (when given) inverse
        filterbank are the given arrays (for example the JAX package's
        ``Mel._weights()`` and ``Mel._win()``), in their dtype, on
        ``device``."""
        fwd = torch.tensor(np.asarray(fwd_weights))
        win = torch.tensor(np.asarray(window))
        if fwd.shape != (config.num_mels, config.n_bins):
            raise ValueError(f"fwd_weights shape {tuple(fwd.shape)} != "
                             f"{(config.num_mels, config.n_bins)}")
        if win.shape != (config.resolut,) or win.dtype != fwd.dtype:
            raise ValueError("window must be [resolut] in the weights' dtype")
        m = cls(config, dtype=fwd.dtype, device=device)
        m.fwd_weights.copy_(fwd)
        m.window.copy_(win)
        if inv_weights is not None:
            inv = torch.tensor(np.asarray(inv_weights))
            if inv.shape != (config.n_bins, config.num_mels) or \
                    inv.dtype != fwd.dtype:
                raise ValueError(f"inv_weights must be "
                                 f"{(config.n_bins, config.num_mels)} in the "
                                 f"weights' dtype (got {tuple(inv.shape)}, "
                                 f"{inv.dtype})")
            m.inv_weights.copy_(inv)
        return m

    @property
    def device(self) -> torch.device:
        return self.fwd_weights.device

    @property
    def dtype(self) -> torch.dtype:
        return self.fwd_weights.dtype

    def _encode_padded(self, x: torch.Tensor) -> torch.Tensor:
        c = self.config
        return mel_encode(x, c.num_mels, c.resolut, c.window,
                          self.fwd_weights, self.window)

    def _pad(self, x) -> torch.Tensor:
        """[L] audio (numpy or tensor) -> reference-padded [L'] tensor in
        ``dtype`` on ``device`` (mel/impl.go:429-455)."""
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x))
        x = x.to(device=self.device, dtype=self.dtype)
        if x.ndim != 1:
            # a [B, L] batch would silently pad to pad_length(B) — refuse
            raise ValueError(f"Mel takes a single [L] signal (got shape "
                             f"{tuple(x.shape)}); use ops.mel_ops."
                             f"mel_encode_batch for [B, L] batches")
        padded = pad_length(x.shape[0], self.config.window)
        return torch.nn.functional.pad(x, (0, padded - x.shape[0]))

    # -- device-level API ---------------------------------------------------
    def encode(self, x) -> torch.Tensor:
        """Padded-or-raw audio [L] -> log-mel [F, num_mels, 2] on ``device``.

        Applies reference padding (mel/impl.go:429-455) first."""
        return self._encode_padded(self._pad(x))

    def encode_quantized(self, x):
        """Audio -> (img2 [mels, F, 2] uint8, mgc_max, mgc_min) on
        ``device``: the encode with the PNG quantizer fused in (GLOBAL
        min/max like the reference writer, mel/impl.go:138-152)."""
        return quantize_mel_plane(self.encode(x), 255)

    def _check_mels(self, mels: int) -> None:
        if mels != self.config.num_mels:
            # the reference has the same footgun (NewMel defaults to 160
            # mels, mel/mel.go:32, the CLI bakes 192, cmd/tomel/main.go:28):
            # fail with the cause instead of a shape error in the product
            raise ConfigError(
                f"spectrogram has {mels} mel bins but config.num_mels="
                f"{self.config.num_mels}; decode with the same config the "
                f"image was written with (the CLI preset "
                f"MelConfig.cli_default() uses 192 mels, bare MelConfig() "
                f"uses the NewMel default 160)")

    def decode(self, logmel, seed: int = 0, momentum: float = 0.0
               ) -> torch.Tensor:
        """log-mel [..., F, num_mels, 2] -> audio [..., N + (F-1)*hop] on
        ``device``, by Griffin-Lim with ``config.griffin_lim_iterations``.

        The reference starts Griffin-Lim from unseeded global rand
        (mel/mel.go:81-83); here the start is uniform [0, 1) drawn on
        ``device`` from the Threefry key of ``seed`` (ops/prng.key): the
        samples the JAX package draws for that seed, on every device. A
        [..., F, num_mels, 2] batch draws from the one key over its whole
        shape. ``momentum`` > 0 opts into fast Griffin-Lim; 0.0 is exact
        reference behaviour."""
        c = self.config
        if not isinstance(logmel, torch.Tensor):
            logmel = torch.from_numpy(np.array(logmel))
        logmel = logmel.to(device=self.device, dtype=self.dtype)
        if logmel.ndim >= 2:
            self._check_mels(logmel.shape[-2])
        return mel_decode(logmel, c.resolut, c.window, self.inv_weights,
                          c.griffin_lim_iterations, prng.key(seed),
                          c.tune_mul, c.tune_add, self.window,
                          momentum=float(momentum))

    def decode_quantized_pcm16(self, planes, mgc_max, mgc_min, seed: int = 0,
                               momentum: float = 0.0):
        """uint8 PNG planes [..., num_mels, F, 2] + global extrema [...] ->
        (int16 PCM [..., N + (F-1)*hop], all-finite flag [...]): dequantize,
        + ``config.volume_boost`` in the log domain, Griffin-Lim and the
        PCM-16 conversion on ``device`` in float32 (kernels KI, then KJ and
        KK per iteration, on a card). Only the planes and the extrema go up
        (imagecodec.load_mel_image_raw); only int16 comes back."""
        c = self.config
        if isinstance(planes, np.ndarray):
            planes = torch.from_numpy(np.ascontiguousarray(planes))
        planes = planes.to(self.device)
        if planes.ndim >= 3:
            self._check_mels(planes.shape[-3])
        mag = mel_to_magnitudes(planes.contiguous(), self.inv_weights,
                                c.tune_mul, c.tune_add, float(c.volume_boost),
                                mgc_max, mgc_min)
        return griffin_lim(mag, c.window, c.griffin_lim_iterations,
                           prng.key(seed), self.window.to(torch.float32),
                           momentum=float(momentum), pcm16=True)

    # -- reference-layout API ------------------------------------------------
    def to_mel(self, buf) -> np.ndarray:
        """Audio buffer -> flattened [F*num_mels, 2] float64 log-mel
        (reference ToMel, mel/mel.go:46-74)."""
        out = self.encode(buf).cpu().numpy().astype(np.float64)
        return out.reshape(-1, 2)

    def from_mel(self, ospectrum, seed: int = 0,
                 momentum: float = 0.0) -> np.ndarray:
        """Flattened [F*num_mels, 2] log-mel -> audio float64
        (reference FromMel, mel/mel.go:142-152)."""
        spec = np.asarray(ospectrum, dtype=np.float64).reshape(
            -1, self.config.num_mels, 2)
        return self.decode(spec, seed=seed, momentum=momentum
                           ).cpu().numpy().astype(np.float64)

    def image(self, buf) -> np.ndarray:
        """In-memory uint16 image R | G<<8 with per-channel min/max
        (reference Image/dumpbuffer, mel/impl.go:16-44). Returns [F*num_mels]
        uint16 in the reference's y+x*mels order."""
        spec = np.asarray(buf, dtype=np.float64).reshape(
            -1, self.config.num_mels, 2)
        return imagecodec.dump_buffer_u16(spec)

    # -- file API -------------------------------------------------------------
    def _samples_in_mel(self, input_len: int, n_frames: int) -> float:
        # float64(len(buf)*NumMels)/float64(len(ospectrum)) with the flattened
        # spectrogram (mel/mel.go:188,206) == len(buf)/n_frames
        return float(input_len * self.config.num_mels) / float(
            n_frames * self.config.num_mels)

    def _save_quantized(self, output_file: str, quantized, input_len: int,
                        sr: int) -> None:
        img2, mx, mn = quantized
        img2 = img2.cpu().numpy()
        imagecodec.save_mel_image_quantized(
            output_file, img2, float(mx), float(mn), self.config.y_reverse,
            self._samples_in_mel(input_len, img2.shape[1]), float(sr))

    def _to_mel_file(self, buf: np.ndarray, sr: int, output_file: str) -> None:
        if self.device_quantize:
            self._save_quantized(output_file, self.encode_quantized(buf),
                                 len(buf), sr)
            return
        spec = self.encode(buf).cpu().numpy().astype(np.float64)
        imagecodec.save_mel_image(
            output_file, spec, self.config.y_reverse,
            self._samples_in_mel(len(buf), spec.shape[0]), float(sr))

    def _to_mel_pcm(self, buf: np.ndarray, sr: int, output_file: str,
                    scale: float) -> None:
        """Device-quantize file encode from raw int16 [L]: the conversion
        (dividing by the power-of-two ``scale``), the encode and the PNG
        quantizer run on the device, on a copy zero-padded on the host to
        the reference length (so every frame lies inside the row). The
        int16 encode (ops/mel_ops.mel_encode) reads the samples in the fused
        KB + KC's int16 mode where that launch takes the encode, else kernel
        KA converts them first; the same bits either way."""
        c = self.config
        host = np.zeros(pad_length(buf.shape[0], c.window), np.int16)
        host[:buf.shape[0]] = buf
        spec = mel_encode(torch.from_numpy(host).to(self.device), c.num_mels,
                          c.resolut, c.window, self.fwd_weights, self.window,
                          pcm_scale=scale)
        self._save_quantized(output_file, quantize_mel_plane(spec, 255),
                             buf.shape[0], sr)

    def to_mel_wav(self, input_file: str, output_file: str) -> None:
        """WAV -> mel PNG (reference ToMelWav, mel/mel.go:194-209). With
        ``device_quantize`` a 16-bit file goes to the device as raw int16
        (ops/quantize.pcm16_ingest)."""
        if self.device_quantize:
            buf, sr = audio_io.load_wav_any(input_file, mono="left",
                                            raw_pcm16=True)
            if buf.dtype == np.int16:
                self._to_mel_pcm(buf, sr, output_file, 32768.0)
                return
            self._to_mel_file(buf, sr, output_file)
            return
        buf, sr = audio_io.load_wav(input_file, mono="left")
        self._to_mel_file(buf, sr, output_file)

    def to_mel_flac(self, input_file: str, output_file: str) -> None:
        """FLAC -> mel PNG (reference ToMelFlac, mel/mel.go:176-191), with
        the mel package's 1/65536 FLAC scaling (mel/impl.go:290) and the
        reference's channel order (each FLAC frame's channels appended as
        one stream, io/flac.read_flac ``go_concat``). With
        ``device_quantize`` a 16-bit file goes to the device as raw int16
        and kernel KA divides by 65536 (a power of two: exact)."""
        if self.device_quantize:
            buf, sr = audio_io.load_flac_any(input_file, mono="go_concat",
                                             scaling="mel", raw_pcm16=True)
            if buf.dtype == np.int16:
                self._to_mel_pcm(buf, sr, output_file, 65536.0)
                return
            self._to_mel_file(buf, sr, output_file)
            return
        buf, sr = audio_io.load_flac(input_file, mono="go_concat",
                                     scaling="mel")
        self._to_mel_file(buf, sr, output_file)

    def to_tensor(self, buf) -> torch.Tensor:
        """Audio buffer -> log-mel [F, num_mels, 2] on ``device``: the
        ML-pipeline hook (file -> tensor with no PNG round trip)."""
        return self.encode(buf)

    def to_tensor_wav(self, input_file: str) -> torch.Tensor:
        """WAV file -> log-mel [F, num_mels, 2] on ``device``."""
        buf, _ = audio_io.load_wav(input_file, mono="left")
        return self.encode(buf)

    def to_tensor_flac(self, input_file: str) -> torch.Tensor:
        """FLAC file -> log-mel [F, num_mels, 2] on ``device``, with the mel
        1/65536 scaling and the ``go_concat`` channel order of
        :meth:`to_mel_flac`, so both routes see the same signal."""
        buf, _ = audio_io.load_flac(input_file, mono="go_concat",
                                    scaling="mel")
        return self.encode(buf)

    def to_wav_png(self, input_file: str, output_file: str, seed: int = 0,
                   momentum: float = 0.0) -> int:
        """mel PNG -> WAV (reference ToWavPng, mel/mel.go:211-238).

        VolumeBoost is added to the LOG-domain values before decoding
        (mel/mel.go:218-221); the output is trimmed by the padding detector,
        and the rate embedded in the image is used when none is configured.
        Returns the sample rate written. With ``device_quantize`` the uint8
        planes go to the device and int16 samples come back
        (:meth:`decode_quantized_pcm16`); otherwise the host dequantizes in
        float64, adds the boost there and :meth:`decode` runs in ``dtype``.
        """
        c = self.config
        if self.device_quantize:
            planes, mx, mn, samples, sr = imagecodec.load_mel_image_raw(
                input_file, c.y_reverse)
            pcm, finite = self.decode_quantized_pcm16(planes, mx, mn, seed,
                                                      momentum)
            wave = pcm.cpu().numpy()   # int16 readback: half the bytes
            if not bool(finite):
                raise ValueError("audio contains NaN/Inf samples")
        else:
            spec, samples, sr = imagecodec.load_mel_image(input_file,
                                                          c.y_reverse)
            if c.volume_boost != 0.0:
                spec = spec + c.volume_boost
            wave = self.decode(spec, seed=seed, momentum=momentum
                               ).cpu().numpy().astype(np.float64)
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
