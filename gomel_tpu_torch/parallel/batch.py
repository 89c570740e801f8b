"""Length-bucketed batching and the batched codec pipelines, on one device
or data-parallel over a mesh's 'data' axis.

Counterpart of ``gomel_tpu/parallel/batch.py``. Variable-length audio is
grouped into length buckets and padded with the reference's own padding
scheme (mel/impl.go:429-455); each row keeps its true length, and the
quantized encodes take each row's true frame count, so a row's PNG equals
the one its file gives alone (the masked quantizers, ops/quantize.py).

``Bucket``, ``make_buckets`` and ``pad_batch_to_multiple`` are host code,
copied from the JAX package and pinned to it by tests/test_torch_host.py.
``BatchedMel`` and ``BatchedPhase`` run a whole batch on one explicit
``device`` through the port's kernels (their plain versions on the CPU), or
with ``mesh=`` split its rows over the mesh's 'data' axis: each data block
runs the same kernels on the device of its row's first cell that this
process owns (the JAX program replicates a block over 'frame'; one owner
computes it here). ``input_mode`` picks the multi-process ingest, as in the
JAX package: "replicated" (every process passes the same global batch) or
"process_local" (every process passes its own rows, padded to
:func:`parallel.mesh.process_local_batch_multiple`; the global batch is the
ingest groups' rows in group order, parallel/mesh.py
``data_group_for_process``). On a mesh that spans processes a result is
this process's rows, padding included (its data blocks, in order; in
"process_local" mode its own padded rows): read them with
:func:`local_rows`. Elsewhere it is the whole batch, trimmed.

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
from ..ops.mel_ops import mel_decode, mel_encode_batch, mel_to_magnitudes
from ..ops.phase_ops import dequantize_decode, phase_decode, phase_encode_batch
from ..ops.quantize import quantize_mel_plane_batch, quantize_planes_batch
from ..pipelines.mel import Mel
from ..pipelines.phase import Phase
from .mesh import (DATA_AXIS, FRAME_AXIS, Mesh, data_group_for_process,
                   process_local_batch_multiple)


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


def local_rows(global_arr, n_rows: int | None = None) -> np.ndarray:
    """This process's rows of a batched result, on the host: the inverse of
    the ``input_mode="process_local"`` ingest, trimmed to ``n_rows`` (the
    process's true row count) when given. On a mesh that spans processes a
    result already is this process's rows (padding included); elsewhere it
    is the whole batch."""
    if isinstance(global_arr, torch.Tensor):
        global_arr = global_arr.cpu().numpy()
    rows = np.asarray(global_arr)
    return rows if n_rows is None else rows[:n_rows]


class _MeshRows:
    """The 'data' axis of the batched codecs (gomel_tpu/parallel/batch.py
    ``_BatchedBase``): row padding to the ingest's multiple, the blocks of
    each data row this process owns, the per-row keys by GLOBAL row index,
    and the assembly and trim of the result."""

    def __init__(self, mesh: Mesh | None, input_mode: str):
        if input_mode not in ("replicated", "process_local"):
            raise ValueError(f"unknown input_mode {input_mode!r}")
        self.mesh = mesh
        self.input_mode = input_mode
        if input_mode == "process_local":
            if mesh is None:
                raise ValueError("input_mode='process_local' requires a mesh")
            self.row_multiple = process_local_batch_multiple(mesh)
        else:
            self.row_multiple = 1 if mesh is None else mesh.shape[DATA_AXIS]
        self.multiproc = mesh is not None and mesh.spans_processes
        self._on: dict = {}

    def const(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        """A filterbank or window, copied once to each block's device."""
        key = (id(t), device)
        if key not in self._on:
            self._on[key] = (t, t.to(device))
        return self._on[key][1]

    def _pad(self, arr, dtype, value):
        """Pad the leading axis to the row multiple with ``value``."""
        if isinstance(arr, torch.Tensor):
            t = arr if dtype is None else arr.to(dtype)
        else:
            t = torch.from_numpy(np.require(np.asarray(arr),
                                            requirements=["C", "W"]))
            t = t if dtype is None else t.to(dtype)
        b = t.shape[0]
        target = -(-b // self.row_multiple) * self.row_multiple
        if target == b:
            return t
        pad = t.new_full((target - b,) + tuple(t.shape[1:]), value)
        return torch.cat([t.to(pad.device), pad])

    def run(self, device: torch.device, fn, inputs, host=(), seed=None):
        """``fn(device, *blocks, *host blocks[, keys])`` on the whole batch
        (no mesh), or on each data block this process owns, on its device.
        ``inputs`` go to the device: (array [rows, ...], dtype or None, pad
        value) each; ``host`` inputs (per-row counts, scales, extrema) stay
        on the host as CPU tensors, in the same form; ``seed`` adds the
        blocks' Griffin-Lim keys (:func:`row_keys` of the global row
        index)."""
        rows = inputs[0][0].shape[0]
        if self.mesh is None:
            args = [_rows(a, dt, device) for a, dt, _ in inputs]
            args += [_rows(a, dt, torch.device("cpu")) for a, dt, _ in host]
            if seed is not None:
                args.append(row_keys(seed, rows))
            return fn(device, *args)
        mesh = self.mesh
        padded = [self._pad(a, dt, v) for a, dt, v in inputs]
        host_rows = [self._pad(a, dt, v) for a, dt, v in host]
        n_local = padded[0].shape[0]
        n_global, off = n_local, 0
        if self.input_mode == "process_local" and self.multiproc:
            gi, ng = data_group_for_process(mesh)
            n_global, off = n_local * ng, gi * n_local
        keys = None if seed is None else row_keys(seed, n_global)
        b_loc = n_global // mesh.shape[DATA_AXIS]
        n_frame = mesh.shape[FRAME_AXIS]
        outs = []
        for d in range(mesh.shape[DATA_AXIS]):
            cells = [c for c in range(d * n_frame, (d + 1) * n_frame)
                     if mesh.is_local(c)]
            if not cells:
                continue
            r0, r1 = d * b_loc, (d + 1) * b_loc
            if r0 < off or r1 > off + n_local:
                raise ValueError(
                    f"data block {d} needs global rows [{r0}, {r1}) outside "
                    f"this process's rows [{off}, {off + n_local})")
            # the block goes to its first local cell only: one copy a block
            dev = mesh.device(cells[0])
            args = [p[r0 - off:r1 - off].to(dev).contiguous() for p in padded]
            args += [h[r0 - off:r1 - off] for h in host_rows]
            if keys is not None:
                args.append(keys[r0:r1])
            outs.append(fn(dev, *args))
        return self._assemble(outs, rows, device)

    def _assemble(self, outs: list, rows: int, device: torch.device):
        """The blocks' results in data order on ``device``, trimmed to the
        true ``rows`` unless the mesh spans processes."""
        def cat(parts):
            out = torch.cat([p.to(device) for p in parts])
            return out if self.multiproc else out[:rows]
        if isinstance(outs[0], tuple):
            return tuple(cat([o[k] for o in outs])
                         for k in range(len(outs[0])))
        return cat(outs)


def _default_device(device, mesh: Mesh | None) -> torch.device | str:
    """``device``, else the mesh's first device of this process, else the
    card."""
    if device is not None:
        return device
    return "cuda" if mesh is None else mesh.first_local_device


# ---------------------------------------------------------------------------
# Batched codec pipelines
# ---------------------------------------------------------------------------

class BatchedMel:
    """Batched mel codec: one kernel launch of each kind per batch, or per
    data block of ``mesh``. Per-row results equal
    :class:`pipelines.mel.Mel`'s (same kernels). ``gl_momentum`` > 0 opts
    every decode into fast Griffin-Lim; 0.0 is the reference's plain
    Griffin-Lim. ``mel`` supplies the filterbanks and window (for example
    ``Mel.from_numpy`` of the JAX package's arrays) in place of ``config``,
    ``dtype`` and ``device``. ``device`` defaults to the card, or with
    ``mesh`` to this process's first cell's device; ``mesh`` and
    ``input_mode`` as in the module docstring. The positional parameters
    are the JAX class's, in its order."""

    def __init__(self, config: MelConfig | None = None,
                 mesh: Mesh | None = None,
                 dtype: torch.dtype = torch.float32, gl_momentum: float = 0.0,
                 input_mode: str = "replicated", *,
                 device: torch.device | str | None = None,
                 mel: Mel | None = None):
        self._rowsplit = _MeshRows(mesh, input_mode)
        self.mel = mel if mel is not None else Mel(
            config or MelConfig(), dtype=dtype,
            device=_default_device(device, mesh))
        self.config = self.mel.config
        self.gl_momentum = float(gl_momentum)

    @property
    def mesh(self) -> Mesh | None:
        return self._rowsplit.mesh

    @property
    def input_mode(self) -> str:
        return self._rowsplit.input_mode

    @property
    def device(self) -> torch.device:
        return self.mel.device

    @property
    def dtype(self) -> torch.dtype:
        return self.mel.dtype

    def _run(self, fn, *inputs, host=(), seed=None):
        return self._rowsplit.run(self.device, fn, inputs, host, seed)

    def _weights(self, dev: torch.device):
        m, on = self.mel, self._rowsplit.const
        return on(m.fwd_weights, dev), on(m.inv_weights, dev), \
            on(m.window, dev)

    def encode(self, audio_batch) -> torch.Tensor:
        """[B, L_pad] -> [B, F, num_mels, 2] log-mel on ``device``."""
        c = self.config

        def fn(dev, x):
            fwd, _, win = self._weights(dev)
            return mel_encode_batch(x, c.num_mels, c.resolut, c.window, fwd,
                                    win)
        return self._run(fn, (audio_batch, self.dtype, 0))

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
        c = self.config
        rows = audio_batch.shape[0]
        _check_rows("frames", frames, rows)
        frames_in = (np.asarray(frames, np.int64), None, 0)
        if _is_pcm(audio_batch):
            if scales is None:
                raise ValueError("int16 audio_batch requires per-row scales")
            _check_rows("scales", scales, rows)

            def fn_pcm(dev, pcm, divisors, fr):
                fwd, _, win = self._weights(dev)
                spec = mel_encode_batch(pcm, c.num_mels, c.resolut, c.window,
                                        fwd, win, pcm_scale=divisors)
                return quantize_mel_plane_batch(spec, 255, frames=fr)
            # padding rows divide by 32768: any power of two converts them
            return self._run(fn_pcm, (audio_batch, None, 0), host=(
                (np.asarray(scales, np.float32), None, 32768.0), frames_in))

        def fn(dev, x, fr):
            fwd, _, win = self._weights(dev)
            spec = mel_encode_batch(x, c.num_mels, c.resolut, c.window, fwd,
                                    win)
            return quantize_mel_plane_batch(spec, 255, frames=fr)
        return self._run(fn, (audio_batch, self.dtype, 0),
                         host=(frames_in,))

    def decode(self, logmel_batch, seed: int = 0) -> torch.Tensor:
        """[B, F, num_mels, 2] -> [B, out_len] by Griffin-Lim, row r from
        the key :func:`row_keys` (seed)[r] (r the global row index)."""
        c = self.config
        self.mel._check_mels(logmel_batch.shape[-2])

        def fn(dev, lm, keys):
            _, inv, win = self._weights(dev)
            return mel_decode(lm, c.resolut, c.window, inv,
                              c.griffin_lim_iterations, keys, c.tune_mul,
                              c.tune_add, win, momentum=self.gl_momentum)
        return self._run(fn, (logmel_batch, self.dtype, 0), seed=seed)

    def decode_quantized(self, img2_batch, mgc_max, mgc_min, seed: int = 0,
                         boost: float = 0.0, pcm16: bool = False):
        """uint8 PNG planes [B, mels, F, 2] + per-row extrema [B] ->
        [B, out_len] float32: dequantize, + ``boost`` in the log domain
        (mel/mel.go:218-221), Griffin-Lim (kernels KI, then KJ and KK per
        iteration) from the key :func:`row_keys` (seed)[r] for row r. ``pcm16``
        fuses the PCM-16 conversion and returns (int16 [B, out_len], per-row
        finite flags [B]): one bad row does not spoil its batch."""
        c = self.config
        self.mel._check_mels(img2_batch.shape[-3])

        def fn(dev, planes, mx, mn, keys):
            _, inv, win = self._weights(dev)
            mag = mel_to_magnitudes(planes, inv, c.tune_mul, c.tune_add,
                                    float(boost), mx, mn)
            return griffin_lim(mag, c.window, c.griffin_lim_iterations,
                               keys, win.to(torch.float32),
                               momentum=self.gl_momentum, pcm16=pcm16)
        return self._run(fn, (img2_batch, None, 0), host=(
            (np.asarray(mgc_max, np.float32), None, 0),
            (np.asarray(mgc_min, np.float32), None, 0)), seed=seed)

    def encode_buckets(self, utterances: Sequence[np.ndarray],
                       max_batch: int = 64):
        """Variable-length utterances -> generator of (bucket, logmel), one
        batch at a time; input order is recoverable via bucket.indices."""
        for bucket in make_buckets(utterances, self.config.window, max_batch):
            yield bucket, self.encode(bucket.audio)


class BatchedPhase:
    """Batched phase codec on one device or over ``mesh``'s 'data' axis;
    ``phase`` (for example ``Phase.from_numpy``) supplies the window in
    place of ``config``, ``dtype`` and ``device``. ``device``, ``mesh`` and
    ``input_mode`` as in :class:`BatchedMel`; the positional parameters are
    the JAX class's, in its order."""

    def __init__(self, config: PhaseConfig | None = None,
                 mesh: Mesh | None = None,
                 dtype: torch.dtype = torch.float32,
                 input_mode: str = "replicated", *,
                 device: torch.device | str | None = None,
                 phase: Phase | None = None):
        self._rowsplit = _MeshRows(mesh, input_mode)
        self.phase = phase if phase is not None else Phase(
            config or PhaseConfig(), dtype=dtype,
            device=_default_device(device, mesh))
        self.config = self.phase.config

    @property
    def mesh(self) -> Mesh | None:
        return self._rowsplit.mesh

    @property
    def input_mode(self) -> str:
        return self._rowsplit.input_mode

    @property
    def device(self) -> torch.device:
        return self.phase.device

    @property
    def dtype(self) -> torch.dtype:
        return self.phase.dtype

    @property
    def _max_val(self) -> int:
        return 65535 if self.config.hdr else 255

    def _run(self, fn, *inputs, host=()):
        return self._rowsplit.run(self.device, fn, inputs, host)

    def _window(self, dev: torch.device) -> torch.Tensor:
        return self._rowsplit.const(self.phase.window, dev)

    def encode(self, audio_batch) -> torch.Tensor:
        """[B, L_pad] -> [B, F, num_freqs, 2] on ``device``."""
        c = self.config
        return self._run(lambda dev, x: phase_encode_batch(
            x, c.num_freqs, c.resolut, c.window, self._window(dev)),
            (audio_batch, self.dtype, 0))

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
        pcm = _is_pcm(audio_batch)

        def fn(dev, x, fr):
            spec = phase_encode_batch(x, c.num_freqs, c.resolut, c.window,
                                      self._window(dev))
            return quantize_planes_batch(spec, self._max_val, c.ihs_passes,
                                         frames=fr)
        return self._run(fn, (audio_batch, None if pcm else self.dtype, 0),
                         host=((np.asarray(frames, np.int64), None, 0),))

    def decode(self, spec_batch) -> torch.Tensor:
        """[B, F, num_freqs, 2] -> [B, out_len]."""
        c = self.config
        return self._run(lambda dev, s: phase_decode(
            s, c.resolut, c.window, float(c.volume_boost), self._window(dev)),
            (spec_batch, self.dtype, 0))

    def decode_quantized(self, img2_batch, maxs, mins, pcm16: bool = False):
        """Integer PNG planes [B, nf, F, 2] + per-row extrema [B, 2] ->
        [B, out_len] float32: dequantize (+ sinh IHS undo) and decode in one
        device pass (kernels KG and KH). ``pcm16`` fuses the PCM-16
        conversion and returns (int16 [B, out_len], per-row finite flags
        [B])."""
        c = self.config
        return self._run(lambda dev, planes, mx, mn: dequantize_decode(
            planes, mx, mn, self._max_val, c.ihs_passes, c.resolut, c.window,
            float(c.volume_boost), self._window(dev), pcm16),
            (img2_batch, None, 0), host=(
                (np.asarray(maxs, np.float32), None, 0),
                (np.asarray(mins, np.float32), None, 0)))

    def encode_buckets(self, utterances: Sequence[np.ndarray],
                       max_batch: int = 64):
        """Variable-length utterances -> generator of (bucket, spec)."""
        for bucket in make_buckets(utterances, self.config.window, max_batch):
            yield bucket, self.encode(bucket.audio)
