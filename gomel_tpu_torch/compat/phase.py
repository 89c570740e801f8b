"""Drop-in replacement for the reference Python port (``import phase``).

Counterpart of ``gomel_tpu/compat/phase.py``: the module surface of the
reference port (the PyPI ``phase-spectrogram`` package), class ``Phase`` and
the module-level helpers with their signatures, while the compute runs on the
port's ``Phase`` (pipelines/phase.py): the hand-written CUDA kernels on a
card, their plain PyTorch versions on the CPU. ``Phase`` takes one keyword
beyond the reference's, ``device`` (default ``"cuda"``, as every entry point
of the port; it raises without a card, pass ``device="cpu"`` there).

Kernels on its paths (on a card): ``to_phase`` KE; ``from_phase`` KG + KH;
the file encodes KE, with ``device_quantize`` KA (the int16 ingest,
zero-stuffing at 8-32 kHz and 11.025/22.05 kHz) + KE + KF; the file decode KG
+ KH, with ``device_quantize`` KG's quantized read and KH's PCM-16
epilogue. The float paths quantize the PNG on the host in float64.

Behavioral parity choices (the reference port, not Go):
- PNG metadata uses the port's 12-byte layout (phase.py:676-686), NOT the Go
  16-byte layout (the native pipelines default to Go; this module is the
  "py" personality).
- Stereo collapses by channel mean (phase.py:488-489).
- ``volume_boost`` applies only when > 0 (phase.py:216; Go uses != 0).
- ``to_phase_flac`` rescales the recorded sample rate after zero-stuffing
  (phase.py:274-275).

Usage: ``from gomel_tpu_torch.compat import phase`` then use exactly like the
reference module, or ``gomel_tpu_torch.compat.install()`` and ``import
phase``.
"""
from __future__ import annotations

import numpy as np

from ..core import framing as _framing
from ..core.config import PhaseConfig
from ..io import audio as _audio
from ..io import float16meta as _f16
from ..io import imagecodec as _imagecodec
from ..ops import _cuda
from ..ops import resample as _resample
from ..pipelines.phase import Phase as _TorchPhase


class Phase:
    """Reference-port-compatible phase codec (phase.py:16-349); ``device``
    is where the port's ``Phase`` runs ("cuda" by default)."""

    def __init__(self, sample_rate=None, num_freqs=None, window=1280,
                 resolut=4096, y_reverse=True, volume_boost=0.0, HDR=False,
                 IHS=False, device_quantize=False, device="cuda"):
        self.device = _cuda.require_device(device, "compat.phase.Phase")
        self.sample_rate = sample_rate
        self.window = window
        self.resolut = resolut
        self.y_reverse = y_reverse
        self.volume_boost = volume_boost
        self.HDR = HDR
        # the port stores IHS as a pass count (phase.py:41)
        self.IHS = 0 if HDR else 2 if IHS else 0
        # EXTENSION beyond the port surface (default off = exact port
        # behavior): fuse the PNG (de)quantizer into the device work on the
        # file paths (kernels KA, KF and KG's quantized read) — byte-near,
        # not byte-identical (tests/test_torch_compat.py)
        self.device_quantize = device_quantize
        self.num_freqs = 0
        self.family = None
        if sample_rate is not None:
            self.reconfigure_sr(sample_rate)
        if num_freqs is not None:
            self.num_freqs = num_freqs

    # -- configuration (phase.py:49-111) ----------------------------------
    def reconfigure_sr(self, sample_rate):
        if sample_rate in [8000, 16000, 24000, 32000, 48000]:
            self.num_freqs = 768 * 2 if self.HDR else 768
            self.family = True
        elif sample_rate in [11025, 22050, 44100]:
            self.num_freqs = 836 * 2 if self.HDR else 836
            self.family = False
        else:
            raise ValueError(
                f"Unsupported sample rate: {sample_rate}. "
                f"Supported rates are: 8000, 16000, 24000, 32000, 48000, "
                f"11025, 22050, 44100")
        self.sample_rate = sample_rate

    def pad_shift(self, sample_rate):
        table_48 = {48000: (0, 0), 32000: (2, 1), 24000: (1, 1),
                    16000: (1, 2), 8000: (1, 5)}
        table_44 = {44100: (0, 0), 22050: (1, 1), 11025: (1, 3)}
        table = table_48 if self.family else table_44
        if sample_rate in table:
            return table[sample_rate]
        raise ValueError("Unsupported sample_rate"
                         "Please configure sample_rate to Phase")

    def zero_pad(self, sr):
        return self.pad_shift(sr)[0]

    def zero_shift(self, sr):
        return self.pad_shift(sr)[1]

    # -- core transforms (phase.py:113-220) --------------------------------
    def _engine(self) -> _TorchPhase:
        key = (self.num_freqs, self.window, self.resolut, self.y_reverse,
               self.volume_boost, self.HDR, self.IHS, self.device_quantize,
               self.device)
        cached = getattr(self, "_engine_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        cfg = PhaseConfig(
            num_freqs=self.num_freqs, window=self.window,
            resolut=self.resolut, y_reverse=self.y_reverse,
            volume_boost=self.volume_boost if self.volume_boost > 0 else 0.0,
            hdr=self.HDR, ihs=self.IHS > 0)
        eng = _TorchPhase(cfg, metadata_layout="py", length_mode="py",
                          device_quantize=self.device_quantize,
                          device=self.device)
        self._engine_cache = (key, eng)
        return eng

    def to_phase(self, audio_buffer):
        """audio -> flattened [frames*num_freqs, 2] float64 (phase.py:113-142)."""
        if self.num_freqs == 0:
            raise ValueError("num_freqs not configured; pass sample_rate")
        return self._engine().to_phase(np.asarray(audio_buffer, np.float64))

    def from_phase(self, spectrogram):
        """flattened [frames*num_freqs, 2] -> audio float64 (phase.py:144-220)."""
        if self.num_freqs == 0:
            raise ValueError("num_freqs not configured; pass sample_rate")
        return self._engine().from_phase(np.asarray(spectrogram, np.float64))

    # -- file API (phase.py:222-349) ---------------------------------------
    def _encode_common(self, audio, sample_rate, rescale_sr: bool):
        self.reconfigure_sr(sample_rate=sample_rate)
        zp, zs = self.pad_shift(sample_rate)
        if zp > 0:
            original_len = len(audio)
            audio = zero_stuff_upsample(audio, zp, zs)
            if rescale_sr:
                sample_rate = int(sample_rate * len(audio) / original_len)
        original_length = len(audio)
        spectrogram = self.to_phase(audio)
        samples_in_mel = float(original_length * self.num_freqs) / float(
            len(spectrogram))
        return spectrogram, samples_in_mel, sample_rate

    def _encode_file(self, audio, sample_rate, output_file,
                     rescale_sr: bool):
        if not self.device_quantize:
            spec, simel, sr = self._encode_common(audio, sample_rate,
                                                  rescale_sr)
            save_image(output_file, spec, self.num_freqs, simel, sr,
                       self.y_reverse, self.HDR, self.IHS)
            return
        # device path: same orchestration, but the encode and the PNG
        # quantizer run on the device (pipelines.Phase.encode_quantized: KE
        # then KF) and only integer planes cross the host boundary
        self.reconfigure_sr(sample_rate=sample_rate)
        zp, zs = self.pad_shift(sample_rate)
        if zp > 0:
            original_len = len(audio)
            audio = zero_stuff_upsample(audio, zp, zs)
            if rescale_sr:
                sample_rate = int(sample_rate * len(audio) / original_len)
        img2, maxs, mins = self._engine().encode_quantized(
            np.asarray(audio, np.float64))
        img2, maxs, mins = (t.cpu().numpy() for t in (img2, maxs, mins))
        samples_in_mel = float(len(audio)) / img2.shape[1]
        _imagecodec.save_phase_image_quantized(
            output_file, img2, maxs, mins,
            self.y_reverse, samples_in_mel, float(sample_rate), self.HDR,
            layout="py")

    def to_phase_wav(self, input_file, output_file):
        if self.device_quantize:
            buf, sample_rate = _audio.load_wav_any(input_file, mono="mean",
                                                   raw_pcm16=True)
            self.reconfigure_sr(sample_rate)
            if buf.dtype == np.int16:
                # the engine is the "py" personality (12-byte metadata,
                # post-upsample samples_in_mel) — its PCM path runs the
                # conversion and the upsample on the device (KA),
                # bit-identical prep
                self._engine()._encode_file_pcm(buf, sample_rate,
                                                output_file)
                return
            self._encode_file(buf, sample_rate, output_file,
                              rescale_sr=False)
            return
        audio, sample_rate = load_wav_with_sr(input_file)
        self._encode_file(audio, sample_rate, output_file, rescale_sr=False)

    def to_phase_flac(self, input_file, output_file):
        if self.device_quantize:
            buf, sample_rate = _audio.load_flac_any(
                input_file, mono="mean", scaling="phase", raw_pcm16=True)
            self.reconfigure_sr(sample_rate)
            if buf.dtype == np.int16:
                self._engine()._encode_file_pcm(
                    buf, sample_rate, output_file,
                    update_sr_after_upsample=True)
                return
            self._encode_file(buf, sample_rate, output_file,
                              rescale_sr=True)
            return
        audio, sample_rate = load_flac_with_sr(input_file)
        self._encode_file(audio, sample_rate, output_file, rescale_sr=True)

    def to_tensor_flac(self, input_file):
        audio, sample_rate = load_flac_with_sr(input_file)
        spec, _, _ = self._encode_common(audio, sample_rate, rescale_sr=True)
        return spec

    def to_wav_png(self, input_file, output_file):
        if self.device_quantize:
            planes, maxs, mins, samples, embedded_sample_rate, nf = \
                _imagecodec.load_phase_image_raw(
                    input_file, self.y_reverse, self.HDR, layout="py")
            self.num_freqs = nf
            embedded_sample_rate = int(embedded_sample_rate)
            pcm_dev, finite = self._engine().decode_quantized_pcm16(
                planes, maxs, mins)
            audio = pcm_dev.cpu().numpy()  # int16 readback (save_wav-exact)
            if not bool(finite):
                raise ValueError("audio contains NaN/Inf samples")
        else:
            spectrogram, samples, embedded_sample_rate, self.num_freqs = \
                load_image(input_file, self.y_reverse, self.HDR, self.IHS)
            audio = self.from_phase(spectrogram)
        main_rate = 48000 if self.num_freqs in [768, 768 * 2] else 44100
        standard_rates = [8000, 11025, 16000, 22050, 24000, 32000, 44100, 48000]
        sample_rate = min(standard_rates,
                          key=lambda x: abs(x - embedded_sample_rate))
        original_length = int(samples)
        if len(audio) > original_length > 0:
            audio = audio[:original_length]
        if self.device_quantize:
            _audio.save_wav_pcm16(output_file, audio, main_rate)
        else:
            save_wav(output_file, audio, main_rate)
        return sample_rate


# ---------------------------------------------------------------------------
# Module-level helpers (same names/signatures as the reference port)
# ---------------------------------------------------------------------------

def pad(audio_buffer, window):
    """Reference padding (phase.py:352-377; Go mel/impl.go:429-455)."""
    audio_buffer = np.asarray(audio_buffer)
    target = _framing.pad_length(len(audio_buffer), window)
    if target > len(audio_buffer):
        return np.pad(audio_buffer, (0, target - len(audio_buffer)))
    return audio_buffer


def is_padded(original_length, padded_length, window):
    """phase.py:380-404."""
    return _framing.is_padded(original_length, padded_length, window)


def spectral_normalize(spectrogram):
    """log2 with 1e-10 clamp (phase.py:407-421) — dead code in the pipeline
    but part of the public module surface."""
    s = np.asarray(spectrogram, dtype=np.float64)
    return np.log2(np.where(s < 1e-10, 1e-10, s))


def spectral_denormalize(spectrogram):
    """exp2 (phase.py:424-435)."""
    return np.exp2(np.asarray(spectrogram, dtype=np.float64))


def shrink(spectrogram, resolut, num_freqs):
    """phase.py:438-443."""
    original_bins = resolut // 2
    time_frames = len(spectrogram) // original_bins
    return np.asarray(spectrogram).reshape(
        time_frames, original_bins, 2)[:, :num_freqs, :].reshape(-1, 2)


def grow(spectrogram, resolut, num_freqs):
    """phase.py:446-472: replicate the last kept bin to refill each frame."""
    spectrogram = np.asarray(spectrogram)
    target_bins = resolut // 2
    frames = spectrogram.reshape(-1, num_freqs, 2)
    last = np.repeat(frames[:, -1:, :], target_bins - num_freqs, axis=1)
    return np.concatenate([frames, last], axis=1).reshape(-1, 2)


def load_wav(file_path):
    buf, _ = _audio.load_wav(file_path, mono="mean")
    return buf


def load_flac(file_path):
    buf, _ = _audio.load_flac(file_path, mono="mean", scaling="phase")
    return buf


def load_wav_with_sr(file_path):
    return _audio.load_wav(file_path, mono="mean")


def load_flac_with_sr(file_path):
    return _audio.load_flac(file_path, mono="mean", scaling="phase")


def save_wav(file_path, audio_buffer, sample_rate):
    """Clip to [-1,1], 16-bit PCM (phase.py:592-605)."""
    _audio.save_wav(file_path, audio_buffer, sample_rate, clip=True)


def zero_stuff_upsample(audio, zero_pad, zero_shift):
    """phase.py:513-549 (Go phase/impl.go:506-529)."""
    return np.asarray(_resample.zero_stuff_upsample(
        np.asarray(audio, dtype=np.float64), zero_pad, zero_shift))


def pack_float16_to_bytes(value):
    """phase.py:608-623."""
    return _f16.pack_float16(value)


def unpack_bytes_to_float64(byte_data):
    """phase.py:626-640."""
    return _f16.unpack_float16(byte_data)


def save_image(file_path, spectrogram, num_freqs, samples_in_mel, sample_rate,
               y_reverse=True, hdr=False, ihs=0):
    """Port-layout PNG writer (12-byte metadata; phase.py:643-747)."""
    spec = np.asarray(spectrogram, dtype=np.float64).reshape(-1, num_freqs, 2)
    _imagecodec.save_phase_image(
        file_path, spec, y_reverse, float(samples_in_mel), float(sample_rate),
        ihs, hdr, layout="py")


def load_image(file_path, y_reverse=True, hdr=False, ihs=0):
    """Port-layout PNG reader -> (spectrogram, samples, sample_rate,
    num_freqs) (phase.py:750-852)."""
    spec, samples, sr, nf = _imagecodec.load_phase_image(
        file_path, y_reverse, ihs, hdr, layout="py")
    # the port returns int(metadata[5]) (phase.py:821)
    return spec.reshape(-1, 2), samples, int(sr), nf
