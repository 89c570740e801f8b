"""Length-bucketed batching and the batched codec pipelines, on one device.

Counterpart of ``gomel_tpu/parallel/batch.py``. Variable-length audio is
grouped into length buckets and padded with the reference's own padding
scheme (mel/impl.go:429-455); each row keeps its true length, and the
quantized encodes take each row's true frame count, so a row's PNG equals
the one its file gives alone (the masked quantizers, ops/quantize.py).

``Bucket``, ``make_buckets`` and ``pad_batch_to_multiple`` are host code,
copied from the JAX package and pinned to it by tests/test_torch_host.py.
``BatchedMel`` and ``BatchedPhase`` run a whole batch on one explicit
``device`` through the port's kernels (their plain versions on the CPU).
The mesh of the JAX package (the 'data' axis, ``input_mode``,
``local_rows``, ``process_local``) waits for the multi-process slice.

Griffin-Lim starts. The JAX package gives row r of every decode call the key
``split(PRNGKey(seed), B)[r]``, and so does the port (:func:`row_keys`,
ops/prng.py): all rows' starts are one draw on the device (kernel KP on a
card), row r from its own key, the samples the JAX package draws. A row's
start depends on the seed and the row index alone, never on the batch size or
the other rows, and is the same on every device.
Each chunk of ``batch-towav`` reuses rows 0..B-1, as the JAX CLI reuses its
keys.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.config import MelConfig, PhaseConfig
from ..core.framing import pad_length
from ..ops import prng
from ..ops.griffinlim import griffin_lim
from ..ops.mel_ops import (fused_route, mel_decode, mel_encode_batch,
                           mel_to_magnitudes, stft_mel_log_pcm16)
from ..ops.phase_ops import dequantize_decode, phase_decode, phase_encode_batch
from ..ops.quantize import (pcm16_ingest_batch, quantize_mel_plane_batch,
                            quantize_planes_batch)
from ..pipelines.mel import Mel
from ..pipelines.phase import Phase


# ---------------------------------------------------------------------------
# Length-bucketed batcher (copied from the JAX package)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Bucket:
    """One fixed-shape batch: [B, padded_len] plus true lengths."""
    audio: np.ndarray            # [B, L_pad] float32
    lengths: np.ndarray          # [B] original sample counts
    indices: np.ndarray          # [B] positions in the input sequence
    padded_len: int


def make_buckets(utterances: Sequence[np.ndarray], hop: int,
                 max_batch: int = 64,
                 bucket_boundaries: Optional[Sequence[int]] = None,
                 dtype=np.float32) -> List[Bucket]:
    """Group variable-length utterances into fixed-shape padded batches.

    Each utterance is first padded with the reference formula
    (``pad_length``); utterances mapping to the same bucket boundary are
    stacked. Default boundaries: powers-of-two multiples of ``15*hop``.
    ``dtype``: bucket storage dtype — np.int16 for the raw-PCM ingest
    (device converts), default float32.
    """
    if bucket_boundaries is None:
        base = pad_length(1, hop)
        bucket_boundaries = [base]
        longest = max((len(u) for u in utterances), default=base)
        while bucket_boundaries[-1] < longest:
            bucket_boundaries.append(
                pad_length(bucket_boundaries[-1] * 2, hop))
    else:
        bucket_boundaries = sorted(bucket_boundaries)
    groups: dict[int, list[int]] = {}
    for i, u in enumerate(utterances):
        ref_len = pad_length(len(u), hop)
        b = next((bb for bb in bucket_boundaries if bb >= ref_len), ref_len)
        groups.setdefault(b, []).append(i)

    buckets: List[Bucket] = []
    for b, idxs in sorted(groups.items()):
        for s in range(0, len(idxs), max_batch):
            chunk = idxs[s:s + max_batch]
            audio = np.zeros((len(chunk), b), dtype=dtype)
            lengths = np.zeros(len(chunk), dtype=np.int64)
            for row, i in enumerate(chunk):
                u = np.asarray(utterances[i], dtype=dtype)
                audio[row, :len(u)] = u
                lengths[row] = len(u)
            buckets.append(Bucket(audio=audio, lengths=lengths,
                                  indices=np.asarray(chunk), padded_len=b))
    return buckets


def pad_batch_to_multiple(bucket: Bucket, multiple: int) -> Bucket:
    """Pad the batch dimension up to a multiple; padded rows have length 0
    and index -1."""
    b = bucket.audio.shape[0]
    target = -(-b // multiple) * multiple
    if target == b:
        return bucket
    pad = target - b
    return Bucket(
        audio=np.pad(bucket.audio, ((0, pad), (0, 0))),
        lengths=np.pad(bucket.lengths, (0, pad)),
        indices=np.pad(bucket.indices, (0, pad), constant_values=-1),
        padded_len=bucket.padded_len)


# ---------------------------------------------------------------------------
# Per-row Griffin-Lim starts
# ---------------------------------------------------------------------------

def row_keys(seed: int, rows: int) -> np.ndarray:
    """The Griffin-Lim keys of rows 0..rows-1 for a decode ``seed``, uint32
    [rows, 2]: ``jax.random.split(PRNGKey(seed), rows)``, whose row r depends
    on (seed, r) alone (gomel_tpu/parallel/batch.py:201-210)."""
    return prng.split_rows(prng.key(seed), rows)


def _rows(batch, dtype: torch.dtype | None, device: torch.device
          ) -> torch.Tensor:
    """A host or device batch as a contiguous tensor on ``device`` (in
    ``dtype`` unless None)."""
    if not isinstance(batch, torch.Tensor):
        batch = torch.from_numpy(np.require(batch, requirements=["C", "W"]))
    return batch.to(device=device, dtype=dtype).contiguous()


def _is_pcm(batch) -> bool:
    dtype = batch.dtype
    return dtype == torch.int16 if isinstance(batch, torch.Tensor) \
        else np.dtype(dtype) == np.int16


def _check_rows(name: str, values, rows: int) -> None:
    n = len(values) if not isinstance(values, torch.Tensor) else values.shape[0]
    if n != rows:
        raise ValueError(f"{name} has {n} rows for a {rows}-row batch")


# ---------------------------------------------------------------------------
# Batched codec pipelines
# ---------------------------------------------------------------------------

class BatchedMel:
    """Batched mel codec on one device: one kernel launch of each kind per
    batch. Per-row results equal :class:`pipelines.mel.Mel`'s (same
    kernels). ``gl_momentum`` > 0 opts every decode into fast Griffin-Lim;
    0.0 is the reference's plain Griffin-Lim. ``mel`` supplies the
    filterbanks and window (for example ``Mel.from_numpy`` of the JAX
    package's arrays) in place of ``config``, ``dtype`` and ``device``."""

    def __init__(self, config: MelConfig | None = None,
                 dtype: torch.dtype = torch.float32, gl_momentum: float = 0.0,
                 device: torch.device | str = "cuda", *,
                 mel: Mel | None = None):
        self.mel = mel if mel is not None else Mel(
            config or MelConfig(), dtype=dtype, device=device)
        self.config = self.mel.config
        self.gl_momentum = float(gl_momentum)

    @property
    def device(self) -> torch.device:
        return self.mel.device

    @property
    def dtype(self) -> torch.dtype:
        return self.mel.dtype

    def encode(self, audio_batch) -> torch.Tensor:
        """[B, L_pad] -> [B, F, num_mels, 2] log-mel on ``device``."""
        c, m = self.config, self.mel
        return mel_encode_batch(_rows(audio_batch, self.dtype, self.device),
                                c.num_mels, c.resolut, c.window,
                                m.fwd_weights, m.window)

    def encode_quantized(self, audio_batch, frames, scales=None):
        """[B, L_pad] + per-row TRUE frame counts [B] -> (img2 [B, mels,
        F_pad, 2] uint8, mgc_max [B], mgc_min [B]) on ``device``: the batched
        encode with the masked PNG quantizer (kernel KD's masked form). Each
        row's extrema come from its true frames only, the grid of the file
        quantized alone (mel/impl.go:138-152); slice each row's planes to
        ``[:, :frames[i]]`` before writing.

        An int16 ``audio_batch`` goes up as int16 and is converted on the
        device; ``scales`` [B] then gives each row's divisor (32768 for WAV,
        65536 for mel-scaled FLAC: io.dataset.pcm_scale_for), powers of
        two, so the conversion is exact. Where the fused KB + KC takes the
        encode (ops/mel_ops.fused_route) its int16 mode reads the rows
        itself, in one launch; else kernel KA converts them first."""
        c, m = self.config, self.mel
        rows = audio_batch.shape[0]
        _check_rows("frames", frames, rows)
        if _is_pcm(audio_batch):
            if scales is None:
                raise ValueError("int16 audio_batch requires per-row scales")
            _check_rows("scales", scales, rows)
            pcm = _rows(audio_batch, None, self.device)
            divisors = torch.as_tensor(np.asarray(scales, np.float32))
            if (fused_route(c.resolut, "auto", pcm.device.type)
                    and self.dtype == torch.float32):
                spec = stft_mel_log_pcm16(pcm, divisors, 0, m.window,
                                          c.resolut, c.window, m.fwd_weights)
                return quantize_mel_plane_batch(spec, 255, frames=frames)
            x = pcm16_ingest_batch(pcm, self.dtype, divisors)
        else:
            x = _rows(audio_batch, self.dtype, self.device)
        spec = mel_encode_batch(x, c.num_mels, c.resolut, c.window,
                                m.fwd_weights, m.window)
        return quantize_mel_plane_batch(spec, 255, frames=frames)

    def decode(self, logmel_batch, seed: int = 0) -> torch.Tensor:
        """[B, F, num_mels, 2] -> [B, out_len] by Griffin-Lim, row r from
        the key :func:`row_keys` (seed)[r]."""
        c, m = self.config, self.mel
        lm = _rows(logmel_batch, self.dtype, self.device)
        m._check_mels(lm.shape[-2])
        return mel_decode(lm, c.resolut, c.window, m.inv_weights,
                          c.griffin_lim_iterations,
                          row_keys(seed, lm.shape[0]), c.tune_mul,
                          c.tune_add, m.window, momentum=self.gl_momentum)

    def decode_quantized(self, img2_batch, mgc_max, mgc_min, seed: int = 0,
                         boost: float = 0.0, pcm16: bool = False):
        """uint8 PNG planes [B, mels, F, 2] + per-row extrema [B] ->
        [B, out_len] float32: dequantize, + ``boost`` in the log domain
        (mel/mel.go:218-221), Griffin-Lim (kernels KI, then KJ and KK per
        iteration) from the key :func:`row_keys` (seed)[r] for row r. ``pcm16``
        fuses the PCM-16 conversion and returns (int16 [B, out_len], per-row
        finite flags [B]): one bad row does not spoil its batch."""
        c, m = self.config, self.mel
        planes = _rows(img2_batch, None, self.device)
        m._check_mels(planes.shape[-3])
        mag = mel_to_magnitudes(planes, m.inv_weights, c.tune_mul, c.tune_add,
                                float(boost), mgc_max, mgc_min)
        return griffin_lim(mag, c.window, c.griffin_lim_iterations,
                           m.window.to(torch.float32),
                           key=row_keys(seed, planes.shape[0]),
                           momentum=self.gl_momentum, pcm16=pcm16)

    def encode_buckets(self, utterances: Sequence[np.ndarray],
                       max_batch: int = 64):
        """Variable-length utterances -> generator of (bucket, logmel), one
        batch at a time; input order is recoverable via bucket.indices."""
        for bucket in make_buckets(utterances, self.config.window, max_batch):
            yield bucket, self.encode(bucket.audio)


class BatchedPhase:
    """Batched phase codec on one device; ``phase`` (for example
    ``Phase.from_numpy``) supplies the window in place of ``config``,
    ``dtype`` and ``device``."""

    def __init__(self, config: PhaseConfig | None = None,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda", *,
                 phase: Phase | None = None):
        self.phase = phase if phase is not None else Phase(
            config or PhaseConfig(), dtype=dtype, device=device)
        self.config = self.phase.config

    @property
    def device(self) -> torch.device:
        return self.phase.device

    @property
    def dtype(self) -> torch.dtype:
        return self.phase.dtype

    @property
    def _max_val(self) -> int:
        return 65535 if self.config.hdr else 255

    def encode(self, audio_batch) -> torch.Tensor:
        """[B, L_pad] -> [B, F, num_freqs, 2] on ``device``."""
        c = self.config
        return phase_encode_batch(_rows(audio_batch, self.dtype, self.device),
                                  c.num_freqs, c.resolut, c.window,
                                  self.phase.window)

    def encode_quantized(self, audio_batch, frames):
        """[B, L_pad] + per-row TRUE frame counts [B] -> (img2 [B, nf,
        F_pad, 2] uint8|uint16, maxs [B, 2], mins [B, 2]) on ``device``: the
        batched encode with the masked plane quantizer (IHS passes included;
        kernel KF's masked form). Per-row extrema come from the row's true
        frames only (phase/impl.go:198-222); slice planes to
        ``[:, :frames[i]]`` before writing.

        An int16 ``audio_batch`` (rows already upsampled, or zp = 0) goes
        up as int16 and is converted on the device at the phase 1/32768
        scaling (kernel KA)."""
        c = self.config
        _check_rows("frames", frames, audio_batch.shape[0])
        if _is_pcm(audio_batch):
            x = pcm16_ingest_batch(_rows(audio_batch, None, self.device),
                                   self.dtype, 32768.0)
        else:
            x = _rows(audio_batch, self.dtype, self.device)
        spec = phase_encode_batch(x, c.num_freqs, c.resolut, c.window,
                                  self.phase.window)
        return quantize_planes_batch(spec, self._max_val, c.ihs_passes,
                                     frames=frames)

    def decode(self, spec_batch) -> torch.Tensor:
        """[B, F, num_freqs, 2] -> [B, out_len]."""
        c = self.config
        return phase_decode(_rows(spec_batch, self.dtype, self.device),
                            c.resolut, c.window, float(c.volume_boost),
                            self.phase.window)

    def decode_quantized(self, img2_batch, maxs, mins, pcm16: bool = False):
        """Integer PNG planes [B, nf, F, 2] + per-row extrema [B, 2] ->
        [B, out_len] float32: dequantize (+ sinh IHS undo) and decode in one
        device pass (kernels KG and KH). ``pcm16`` fuses the PCM-16
        conversion and returns (int16 [B, out_len], per-row finite flags
        [B])."""
        c = self.config
        return dequantize_decode(
            _rows(img2_batch, None, self.device), maxs, mins, self._max_val,
            c.ihs_passes, c.resolut, c.window, float(c.volume_boost),
            self.phase.window, pcm16)

    def encode_buckets(self, utterances: Sequence[np.ndarray],
                       max_batch: int = 64):
        """Variable-length utterances -> generator of (bucket, spec)."""
        for bucket in make_buckets(utterances, self.config.window, max_batch):
            yield bucket, self.encode(bucket.audio)
