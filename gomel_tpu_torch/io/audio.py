"""Host WAV and FLAC loading, WAV saving.

Copy of ``gomel_tpu/io/audio.py``: the port cannot import ``gomel_tpu``,
whose package __init__ imports JAX. tests/test_torch_host.py pins the copy to
the original.

Replaces the reference's Go codecs: WAV by faiface/beep (mel/impl.go:195-264),
channel-0 extraction on load with ``mono="left"``, the Python port's
channel-MEAN for stereo (phase.py:488-489) with ``mono="mean"``; FLAC by
mewkiz/flac (io/flac.py here) with two different integer scalings: mel
divides by 65536 (mel/impl.go:290), phase by 32768 (phase/impl.go:375), so
``scaling="mel"`` halves the standard full-scale value.
"""
from __future__ import annotations

import struct

import numpy as np

from ..core.config import FileNotLoadedError
from . import wavcodec


def _to_mono(audio: np.ndarray, mono: str) -> np.ndarray:
    if audio.ndim > 1:
        if mono == "mean":
            return np.mean(audio, axis=1)
        return audio[:, 0].astype(np.float64)
    return audio


def _to_float(audio: np.ndarray) -> np.ndarray:
    """Integer PCM -> float64 full-scale [-1, 1) (libsndfile convention)."""
    if audio.dtype == np.int16:
        return audio.astype(np.float64) / 32768.0
    if audio.dtype == np.int32:
        return audio.astype(np.float64) / 2147483648.0
    if audio.dtype == np.uint8:
        return (audio.astype(np.float64) - 128.0) / 128.0
    return audio.astype(np.float64)


def load_wav(path: str, mono: str = "mean") -> tuple[np.ndarray, int]:
    """Load a WAV file -> (float64 mono samples, sample_rate).

    Raises FileNotLoadedError on failure (parity with LoadWavSampleRate,
    phase/phase.go:177-183).
    """
    try:
        audio, sr = wavcodec.read_wav(path)
    except (OSError, ValueError, struct.error) as e:
        raise FileNotLoadedError(f"could not load wav {path!r}: {e}") from e
    audio = _to_mono(_to_float(audio), mono)
    if audio.size == 0 or sr == 0:
        raise FileNotLoadedError(f"empty or invalid wav: {path!r}")
    return audio, int(sr)


def _raw_or_none(audio: np.ndarray, mono: str):
    """Raw int16 view for the device-quantize fast paths, or None when the
    stream needs the float fallback: non-16-bit dtypes, and 3+-channel
    means (the device f32 mean is only exact — equal to the host f64
    mean — for the 2-channel sum; more channels double-round)."""
    if audio.dtype != np.int16:
        return None
    if audio.ndim > 1:
        if mono != "mean":
            audio = audio[:, 0]  # mirror _to_mono: non-"mean" = channel 0
        elif audio.shape[1] > 2:
            return None
    return np.ascontiguousarray(audio)


def load_wav_any(path: str, mono: str = "mean", raw_pcm16: bool = False
                 ) -> tuple[np.ndarray, int]:
    """One-decode loader: with ``raw_pcm16`` and a 16-bit stream returns
    RAW int16 samples ([L], or [L, C] for mono="mean" — the device means
    and converts, bit-identically to the host float path); otherwise the
    usual float64 mono buffer. Callers branch on the returned dtype."""
    try:
        audio, sr = wavcodec.read_wav(path)
    except (OSError, ValueError, struct.error) as e:
        raise FileNotLoadedError(f"could not load wav {path!r}: {e}") from e
    if audio.size == 0 or sr == 0:
        raise FileNotLoadedError(f"empty or invalid wav: {path!r}")
    if raw_pcm16:
        raw = _raw_or_none(audio, mono)
        if raw is not None:
            return raw, int(sr)
    return _to_mono(_to_float(audio), mono), int(sr)


def load_wav_pcm16(path: str, mono: str = "mean"):
    """RAW-only variant of :func:`load_wav_any`: (int16, sr) or None when
    the file needs the float path (it decodes the file either way; a caller
    that would fall back to :func:`load_wav` should take
    :func:`load_wav_any`, which decodes once)."""
    buf, sr = load_wav_any(path, mono=mono, raw_pcm16=True)
    if buf.dtype != np.int16:
        return None
    return buf, sr


def load_flac_any(path: str, mono: str = "mean", scaling: str = "phase",
                  raw_pcm16: bool = False) -> tuple[np.ndarray, int]:
    """FLAC counterpart of :func:`load_wav_any`. For the float fallback
    the ``scaling`` applies (phase 1/32768, mel 1/65536); raw int16 results
    leave the power-of-two scale to the device ingest
    (``io.dataset.pcm_scale_for``)."""
    from . import flac as flacdec
    try:
        audio, sr = flacdec.read_flac(
            path, layout="go_concat" if mono == "go_concat" else "interleaved")
    except FileNotFoundError as e:
        raise FileNotLoadedError(f"could not load flac {path!r}: {e}") from e
    except Exception as e:
        raise FileNotLoadedError(f"could not decode flac {path!r}: {e}") from e
    if audio.size == 0 or sr == 0:
        raise FileNotLoadedError(f"empty or invalid flac: {path!r}")
    if raw_pcm16:
        raw = _raw_or_none(audio, mono)
        if raw is not None:
            return raw, int(sr)
    out = _to_mono(_to_float(audio), mono)
    if scaling == "mel":
        out = out * 0.5
    return out, int(sr)


def load_flac_pcm16(path: str, mono: str = "mean"):
    """RAW-only variant of :func:`load_flac_any`: (int16, sr) or None when
    the file needs the float path (it decodes the file either way)."""
    buf, sr = load_flac_any(path, mono=mono, raw_pcm16=True)
    if buf.dtype != np.int16:
        return None
    return buf, sr


def load_flac(path: str, mono: str = "mean", scaling: str = "phase"
              ) -> tuple[np.ndarray, int]:
    """Load a FLAC file -> (float64 mono samples, sample_rate).

    scaling="phase": 1/32768 integer scaling for 16-bit content (reference
    phase/impl.go:375). scaling="mel": 1/65536 (reference mel/impl.go:290).
    Streams deeper than 16 bits are normalized to full scale, as in the JAX
    package (its docs/PARITY.md: the reference's fixed divisors leave 24-bit
    content at +/-256 amplitude, judged a bug and not reproduced)."""
    from . import flac as flacdec
    try:
        audio, sr = flacdec.read_flac(
            path, layout="go_concat" if mono == "go_concat" else "interleaved")
    except FileNotFoundError as e:
        raise FileNotLoadedError(f"could not load flac {path!r}: {e}") from e
    except Exception as e:
        raise FileNotLoadedError(f"could not decode flac {path!r}: {e}") from e
    audio = _to_mono(_to_float(audio), mono)
    if audio.size == 0 or sr == 0:
        raise FileNotLoadedError(f"empty or invalid flac: {path!r}")
    if scaling == "mel":
        audio = audio * 0.5
    return audio, int(sr)


def save_wav_pcm16(path: str, pcm: np.ndarray, sample_rate: int,
                   stereo: bool = False) -> None:
    """Write ALREADY-CONVERTED int16 PCM — the landing pad for the
    device-side conversion (ops/quantize.pcm16_encode, kernel KH), which is
    bit-identical to :func:`save_wav`'s float path on the same wave."""
    pcm = np.asarray(pcm)
    if pcm.dtype != np.int16:
        raise ValueError(f"expected int16 PCM, got {pcm.dtype}")
    if stereo and pcm.ndim == 1:
        pcm = np.stack([pcm, pcm], axis=1)
    wavcodec.write_wav(path, pcm, int(sample_rate))


def save_wav(path: str, audio: np.ndarray, sample_rate: int,
             clip: bool = True, stereo: bool = False) -> None:
    """Save 16-bit PCM WAV. Clips to [-1, 1] like the port (phase.py:592-605);
    float->int16 uses libsndfile's scale-by-32768 with saturation. Non-finite
    samples raise (the reference design doc's error contract).

    ``stereo=True`` duplicates mono into two identical channels — the Go
    ``dumpwav`` container layout (mel/impl.go:195-232); default mono matches
    the Python port."""
    audio = np.asarray(audio, dtype=np.float64)
    if not np.isfinite(audio).all():
        raise ValueError("audio contains NaN/Inf samples")
    if clip:
        audio = np.clip(audio, -1.0, 1.0)
    pcm = np.clip(np.rint(audio * 32768.0), -32768, 32767).astype(np.int16)
    if stereo and pcm.ndim == 1:
        pcm = np.stack([pcm, pcm], axis=1)
    wavcodec.write_wav(path, pcm, int(sample_rate))
