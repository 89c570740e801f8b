"""Streaming (bounded-memory) codec pipelines for a single device.

Counterpart of ``gomel_tpu/pipelines/streaming.py``. ``Mel``/``Phase`` hold
a whole file on the device, and the long-form classes
(pipelines/longform.py) shard its frames across devices. This module covers
the third regime: arbitrarily long audio on ONE device in O(chunk) memory,
with the overlap-carry algebra of the halo exchange: a chunk's overlap-add
tail (frame_len - hop samples) is carried into the next chunk on the host
instead of being sent to a neighbour.

Each chunk is one call of the ops the whole-file classes run: the encode is
ops/phase_ops.phase_encode (kernel KE) or ops/mel_ops.mel_encode (KB + KC),
the decode ops/phase_ops.phase_synthesize (KG, then KH without a window), on
a CUDA device; their plain PyTorch versions on the CPU. The window-sum
bookkeeping, the normalisation and the boost run on the host in float64.

Streaming results equal the whole-file pipelines for EVERY stream length:
the iSTFT's global 0.5 * max window-sum threshold uses the
periodic-interior maximum, which is exact whenever the stream spans at least
K = ceil(frame_len / hop) frames (the constructor's ``chunk_frames >= K``
guarantees that for multi-chunk streams), and single-block streams below
that get the exact per-length threshold instead.

Parity targets: phase/phase.go:41-153 buffer semantics, chunked.
"""
from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from ..core.config import MelConfig, PhaseConfig
from ..core.filterbank import mel_weights
from ..core.framing import pad_length
from ..ops import _cuda
from ..ops.mel_ops import mel_encode
from ..ops.phase_ops import phase_encode, phase_synthesize
from ..ops.stft import hann_window


def _stream_encode(samples, enc, chunk_samples, halo, frame_len, hop, pad):
    """Shared chunked-encode loop: O(1) buffer handling (parts accumulate
    in a list, one copy per chunk) and a multi-chunk final flush (the
    reference padding can push the tail past one chunk when
    frame_len % hop != 0). ``enc`` maps a float64 host array
    [chunk_samples + halo] to a host array [chunk_frames, ...]."""
    need = chunk_samples + halo
    parts: list = []
    buffered = 0   # total samples across parts
    offset = 0     # consumed samples within parts[0]
    total = 0

    def drain(k):
        nonlocal parts, buffered, offset
        out = np.empty(k, dtype=np.float64)
        got = 0
        while got < k:
            head = parts[0]
            take = min(len(head) - offset, k - got)
            out[got:got + take] = head[offset:offset + take]
            got += take
            offset += take
            if offset == len(head):
                parts.pop(0)
                offset = 0
        buffered -= k
        return out

    def peek(k):
        # copy of the first k samples without consuming
        nonlocal parts, buffered, offset
        saved = (list(parts), buffered, offset)
        out = drain(k)
        parts, buffered, offset = saved
        return out

    for part in samples:
        part = np.asarray(part, dtype=np.float64).reshape(-1)
        if len(part) == 0:
            continue
        total += len(part)
        parts.append(part)
        buffered += len(part)
        while buffered >= need:
            yield enc(peek(need))
            drain(chunk_samples)
    extra = (pad_length(total, hop) - total) if pad else 0
    tail = np.concatenate(
        [drain(buffered) if buffered else np.zeros(0), np.zeros(extra)])
    while len(tail) >= need:
        yield enc(tail[:need])
        tail = tail[chunk_samples:]
    n_frames = (len(tail) - frame_len) // hop + 1
    if n_frames > 0:
        x = np.zeros(need)
        x[: len(tail)] = tail
        yield enc(x)[:n_frames]


class _ChunkGeometry:
    """What both streaming codecs derive from (config, chunk_frames)."""

    def __init__(self, config, chunk_frames: int, dtype: torch.dtype,
                 device, what: str):
        if chunk_frames < 1:
            raise ValueError("chunk_frames must be >= 1")
        self.config = config
        self.chunk_frames = chunk_frames
        self.dtype = dtype
        self.device = _cuda.require_device(device, what)
        self._hop = config.window
        self._frame_len = config.resolut
        self._halo = config.resolut - config.window
        self._chunk_samples = chunk_frames * self._hop
        self._window = torch.tensor(hann_window(config.resolut), dtype=dtype,
                                    device=self.device)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(device=self.device, dtype=self.dtype)

    def encode_iter(self, samples: Iterable[np.ndarray],
                    pad: bool = True) -> Iterator[np.ndarray]:
        """Stream of sample arrays -> stream of host arrays
        [<=chunk_frames, bins, 2].

        With ``pad=True`` the reference padding (pad to >= 15*hop, then to a
        multiple-of-hop minus one) is applied to the TOTAL stream, matching
        the whole-file encoder on the concatenated signal."""
        yield from _stream_encode(
            samples, lambda x: self._enc(self._to_device(x)).cpu().numpy(),
            self._chunk_samples, self._halo, self._frame_len, self._hop, pad)

    def encode(self, audio: np.ndarray) -> np.ndarray:
        """Whole-array convenience wrapper (still chunked device calls)."""
        return np.concatenate(list(self.encode_iter([audio])), axis=0)


class StreamingPhase(_ChunkGeometry):
    """Chunked phase codec: encode and decode arbitrarily long audio in
    fixed device memory, ``chunk_frames`` frames per device call, on
    ``device`` in ``dtype``. Streams and results are host arrays."""

    def __init__(self, config: PhaseConfig | None = None,
                 chunk_frames: int = 512,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        super().__init__(config or PhaseConfig(), chunk_frames, dtype, device,
                         "StreamingPhase")
        # The interior window-sum maximum equals the whole-signal maximum
        # exactly when the signal spans >= K = ceil(frame_len/hop) frames
        # (for the Hann window: equality from F = K on,
        # tests/test_torch_streaming.py::test_short_stream_threshold_boundary).
        # Single-block streams below that get an exact per-length threshold
        # in decode; multi-block streams are guaranteed F > chunk_frames, so
        # requiring chunk_frames >= K makes the interior threshold exact for
        # every stream this class can produce.
        k = -(-self._frame_len // self._hop)
        if chunk_frames < k:
            raise ValueError(
                f"chunk_frames must be >= ceil(resolut/window) = {k} so the "
                f"periodic-interior window-sum threshold is exact for "
                f"multi-chunk streams (got {chunk_frames})")
        # window-sum of one interior chunk (constant across chunks)
        self._wsum_ext = self._np_window_sum(chunk_frames)
        # global threshold: periodic-interior maximum (== whole-signal max
        # for any stream of >= K frames)
        self._threshold = 0.5 * float(self._np_window_sum(4 * k).max())

    def _enc(self, x: torch.Tensor) -> torch.Tensor:
        # x: [cf*hop + frame_len - hop] -> [cf, num_freqs, 2]
        return phase_encode(x, self.config.num_freqs, self._frame_len,
                            self._hop, self._window)

    def _dec(self, spec2: torch.Tensor, real_frames: int) -> torch.Tensor:
        # spec2: [cf, num_freqs, 2], zero past real_frames -> the
        # un-normalised overlap-add extension [cf*hop + halo]
        return phase_synthesize(spec2, self._frame_len, self._hop,
                                self._window, real_frames)

    def _np_window_sum(self, n_frames: int) -> np.ndarray:
        """float64 overlap-added squared-window sum for n_frames frames."""
        w2 = hann_window(self._frame_len) ** 2
        out = np.zeros(self._frame_len + (n_frames - 1) * self._hop)
        for i in range(n_frames):
            out[i * self._hop: i * self._hop + self._frame_len] += w2
        return out

    def decode_iter(self, specs: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Stream of [F_i, nf, 2] chunks -> stream of float64 audio arrays.

        Concatenated output equals the whole-file ``phase_decode`` of the
        concatenated spectrogram (same overlap-add, window-sum
        normalisation and threshold semantics), emitted with one-chunk
        latency."""
        cf, nf = self.chunk_frames, self.config.num_freqs
        carry_sig = np.zeros(self._halo)
        carry_w = np.zeros(self._halo)
        pending = np.zeros((0, nf, 2))
        started = False

        def flush_block(block, last: bool):
            nonlocal carry_sig, carry_w
            f = block.shape[0]
            x = np.zeros((cf, nf, 2))
            x[:f] = block
            sig_ext = self._dec(self._to_device(x), f).cpu().numpy().astype(
                np.float64)[: f * self._hop + self._halo]
            # the window-sum tail depends on the block's REAL frame count
            wsum_ext = (self._wsum_ext.copy() if f == cf
                        else self._np_window_sum(f))
            sig_ext[: self._halo] += carry_sig
            wsum_ext[: self._halo] += carry_w
            body_n = f * self._hop
            out_sig, carry_sig = sig_ext[:body_n], sig_ext[body_n:].copy()
            out_w, carry_w = wsum_ext[:body_n], wsum_ext[body_n:].copy()
            if last:
                out_sig = np.concatenate([out_sig, carry_sig])
                out_w = np.concatenate([out_w, carry_w])
            # single-block stream: the interior threshold can overestimate
            # for F < K frames, so use the exact whole-signal threshold (the
            # whole-file decoder's 0.5*max rule, phase/phase.go:118-121)
            threshold = self._threshold
            if last and not started:
                threshold = 0.5 * float(self._np_window_sum(max(f, 1)).max())
            # phase/phase.go:121-130: divide where the sum is above the
            # threshold, fade by the threshold below it, leave exact zeros
            out = np.where(
                out_w > threshold, out_sig / np.where(out_w > 1e-21, out_w, 1.0),
                np.where(out_w > 1e-21, out_sig / threshold, out_sig))
            if self.config.volume_boost != 0.0:
                out = out * self.config.volume_boost
            return out

        for spec in specs:
            spec = np.asarray(spec, dtype=np.float64)
            if spec.ndim == 2:
                spec = spec.reshape(-1, nf, 2)
            pending = np.concatenate([pending, spec], axis=0)
            while pending.shape[0] >= cf:
                yield flush_block(pending[:cf], last=False)
                pending = pending[cf:]
                started = True
        if pending.shape[0] > 0 or started:
            yield flush_block(pending, last=True)

    def decode(self, spec: np.ndarray) -> np.ndarray:
        """Whole-array convenience wrapper (still chunked device calls)."""
        return np.concatenate(list(self.decode_iter([spec])))


class StreamingMel(_ChunkGeometry):
    """Chunked mel ENCODER: log-mel features for arbitrarily long audio in
    O(chunk) device memory (the feature-extraction side of the mel codec;
    Griffin-Lim decoding iterates over the whole signal, so
    pipelines.longform.LongFormMel scales the decode instead)."""

    def __init__(self, config: MelConfig | None = None,
                 chunk_frames: int = 512,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        super().__init__(config or MelConfig(), chunk_frames, dtype, device,
                         "StreamingMel")
        c = self.config
        self._fwd = torch.tensor(
            mel_weights(c.n_bins, c.num_mels, c.mel_fmin, c.mel_fmax),
            dtype=dtype, device=self.device)

    def _enc(self, x: torch.Tensor) -> torch.Tensor:
        # x: [cf*hop + frame_len - hop] -> [cf, num_mels, 2]
        c = self.config
        return mel_encode(x, c.num_mels, c.resolut, c.window, self._fwd,
                          self._window)
