"""Frame-sharded STFT / overlap-add / Griffin-Lim on one controller: the halo
layer of the long-form pipelines.

Counterpart of ``gomel_tpu/parallel/sharded.py``. Frames are independent in
analysis and couple only across one analysis window in synthesis, so a long
signal is cut into contiguous runs of frames, one per shard of the mesh's
'frame' axis (utterances over 'data'), and the shards exchange a halo of
``frame_len - hop`` samples:

- analysis: shard f reads the first ``halo`` samples of shard f+1's chunk
  (:func:`_pull_right_halo`; the last shard reads zeros);
- synthesis: shard f's last frames spill ``halo`` samples into shard f+1's
  span, added into its head (:func:`_push_tail_right`; shard 0 receives
  zeros) by kernel KM (ops/istft.shard_epilogue);
- the window-sum threshold of the iSTFT is GLOBAL, 0.5 * max over the whole
  signal. The sum depends on the plan alone, so the host computes it once
  (ops/istft.window_sum_threshold) where the JAX program takes a ``pmax``
  over the shards, and KM divides each sample by the window sum at its
  global position.

One process drives every shard (the mesh's devices may repeat: four frame
shards on one card). The halo "collectives" are copies between shard
tensors, peer copies when two shards sit on different cards. Each shard's
work runs the port's kernels on its device: KA (file ingest), KB + KC or KE
(encode; K18's chunk loop when asked), KD / KF (file quantize), KL (file
dequantize), KG with a real-frame count + KH without a window (decode), KI +
KJ + KK (Griffin-Lim; KN + KO on the interior iterations with
``interior_mm``), and KM after every synthesis.

The host plan (``FrameShardPlan``, ``plan_frame_sharding``,
``pad_signal_for_plan``, ``pad_frames_for_plan``) is copied from the JAX
package and pinned to it by tests/test_torch_host.py. The multi-process form
(NCCL halos, process-local ingest) is a later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import fftbackend, istft
from ..ops import prng
from ..ops.griffinlim import gl_overlap_add, gl_project
from ..ops.mel_ops import mel_encode, mel_to_magnitudes
from ..ops.phase_ops import phase_encode, phase_synthesize
from ..ops.quantize import pcm16_encode
from ..ops.rfft_mag import stft_planes
from ..ops.stft import auto_frame_chunk, hann_window
from .mesh import DATA_AXIS, FRAME_AXIS, Mesh, Sharded


# ---------------------------------------------------------------------------
# Host-side sharding plan (copied from the JAX package)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FrameShardPlan:
    """Static geometry of a frame-sharded run."""
    frame_len: int
    hop: int
    n_shards: int
    n_frames: int        # real frames F
    n_frames_padded: int # F_pad (multiple of n_shards)
    out_len: int         # real output length frame_len + (F-1)*hop

    @property
    def halo(self) -> int:
        return self.frame_len - self.hop

    @property
    def frames_per_shard(self) -> int:
        return self.n_frames_padded // self.n_shards

    @property
    def chunk(self) -> int:
        """Signal samples owned per shard."""
        return self.frames_per_shard * self.hop

    @property
    def sharded_signal_len(self) -> int:
        return self.n_frames_padded * self.hop


def plan_frame_sharding(n_frames: int, frame_len: int, hop: int,
                        n_shards: int) -> FrameShardPlan:
    """Compute the padded frame count for an even, halo-local sharding."""
    if n_frames <= 0:
        raise ValueError("need at least one frame")
    k = -(-frame_len // hop)  # ceil
    min_frames = max(n_frames + k - 1, n_shards * (k - 1), n_shards)
    f_pad = -(-min_frames // n_shards) * n_shards
    return FrameShardPlan(
        frame_len=frame_len, hop=hop, n_shards=n_shards,
        n_frames=n_frames, n_frames_padded=f_pad,
        out_len=frame_len + (n_frames - 1) * hop,
    )


def _pad_last(x, widths):
    if isinstance(x, np.ndarray):
        return np.pad(x, widths)
    flat = [v for w in reversed(widths) for v in w]
    return torch.nn.functional.pad(x, flat)


def pad_signal_for_plan(x, plan: FrameShardPlan):
    """Zero-pad (or tail-truncate) a [..., L] signal to the sharded buffer.

    Samples past ``(n_frames-1)*hop + frame_len`` are read by no frame — the
    reference's pad-to-multiple-minus-one scheme (mel/impl.go:437-446) leaves
    up to hop-1 such samples — so truncating to the buffer is lossless;
    anything beyond that is an inconsistent plan. Type-preserving: numpy in,
    numpy out; a tensor in, a tensor out.
    """
    L = x.shape[-1]
    target = plan.sharded_signal_len
    if L > target:
        if L > target + plan.hop - 1 or L > plan.out_len + plan.hop - 1:
            raise ValueError(
                f"signal length {L} inconsistent with plan (buffer {target})")
        return x[..., :target]
    return _pad_last(x, [(0, 0)] * (x.ndim - 1) + [(0, target - L)])


def pad_frames_for_plan(spec, plan: FrameShardPlan, axis: int = 1):
    """Zero-pad the frame axis of a spectrogram to n_frames_padded
    (type-preserving, like pad_signal_for_plan)."""
    f = spec.shape[axis]
    pad = [(0, 0)] * spec.ndim
    pad[axis] = (0, plan.n_frames_padded - f)
    return _pad_last(spec, pad)


# ---------------------------------------------------------------------------
# Halo exchange and shard-local steps
# ---------------------------------------------------------------------------

def _frame_index(mesh: Mesh, index: int) -> int:
    """The 'frame' coordinate of shard ``index`` (row-major grid)."""
    return index % mesh.shape[FRAME_AXIS]


def _local_frame_count(plan: FrameShardPlan, f: int) -> int:
    """Real frames of frame shard ``f``: ``clamp(F - f * F_loc, 0, F_loc)``.
    The JAX program's ``_local_frame_mask`` (global index < F) is always a
    prefix of a shard's frames, so its length carries it."""
    return min(max(plan.n_frames - f * plan.frames_per_shard, 0),
               plan.frames_per_shard)


def _pull_right_halo(exts: list, mesh: Mesh, plan: FrameShardPlan) -> None:
    """Fill the last ``halo`` columns of each extended buffer [B, chunk +
    halo] with the first ``halo`` samples of its right neighbour's chunk;
    the last frame shard reads zeros (open boundary). In place."""
    chunk, halo = plan.chunk, plan.halo
    for i, e in enumerate(exts):
        if _frame_index(mesh, i) + 1 < mesh.shape[FRAME_AXIS]:
            e[:, chunk:].copy_(exts[i + 1][:, :halo])
        else:
            e[:, chunk:].zero_()


def _push_tail_right(sig_exts: list, mesh: Mesh,
                     plan: FrameShardPlan) -> list:
    """The overlap-add tail each shard receives from its LEFT neighbour:
    that neighbour's last ``halo`` samples [B, halo], on this shard's device
    (a view when both sit on one device); None for frame shard 0 (open
    boundary: it receives zeros)."""
    recv = []
    for i, s in enumerate(sig_exts):
        if _frame_index(mesh, i) == 0:
            recv.append(None)
        else:
            recv.append(sig_exts[i - 1][:, plan.chunk:].to(s.device))
    return recv


def _local_signal_ext(x: Sharded, plan: FrameShardPlan) -> list:
    """[B, chunk] shards -> [B, chunk + halo] extended signals with the
    right neighbour's head pulled in: the buffer every analysis frames from
    (the single definition of the halo protocol)."""
    exts = []
    for s in x.shards:
        e = s.new_empty((s.shape[0], plan.chunk + plan.halo))
        e[:, :plan.chunk].copy_(s)
        exts.append(e)
    _pull_right_halo(exts, x.mesh, plan)
    return exts


def _local_overlap_add(sig_exts: list, mesh: Mesh, plan: FrameShardPlan,
                       **epilogue) -> list:
    """Each shard's un-normalised overlap-add [B, chunk + halo] -> its
    [B, chunk] samples: the left neighbour's tail added into its head, then
    ``epilogue`` (ops/istft.shard_epilogue: the global window-sum
    normalisation, the momentum step or PCM-16), kernel KM on the card."""
    recv = _push_tail_right(sig_exts, mesh, plan)
    decode = epilogue.get("window") is not None
    t_prev = epilogue.pop("t_prev", None)
    out = []
    for i, (s, r) in enumerate(zip(sig_exts, recv)):
        kw = dict(epilogue)
        if decode:
            kw["start"] = _frame_index(mesh, i) * plan.chunk
        if t_prev is not None:
            kw["t_prev"] = t_prev[i]
        out.append(istft.shard_epilogue(s, r, plan.chunk, **kw))
    return out


def _rows_finite(flags: list, mesh: Mesh) -> torch.Tensor:
    """Per-shard [B_loc] finite flags -> [B] on the mesh's first device: a
    row is finite when every frame shard of it is."""
    n_frame = mesh.shape[FRAME_AXIS]
    dev = mesh.first_device
    rows = []
    for d in range(mesh.shape[DATA_AXIS]):
        ok = flags[d * n_frame].to(dev)
        for f in range(1, n_frame):
            ok = ok & flags[d * n_frame + f].to(dev)
        rows.append(ok)
    return torch.cat(rows)


def _pcm16_result(outs: list, mesh: Mesh):
    """[(int16 [B_loc, chunk], finite [B_loc])] per shard -> (Sharded int16,
    finite [B])."""
    return (Sharded(mesh, [p for p, _ in outs]),
            _rows_finite([f for _, f in outs], mesh))


class _PerDevice:
    """A host array as a tensor on each device that asks for it (the
    filterbanks and the window are replicated on every shard's device)."""

    def __init__(self, value, dtype: torch.dtype):
        self._host = torch.as_tensor(np.asarray(value)).to(dtype)
        self._on: dict[torch.device, torch.Tensor] = {}

    def __call__(self, device: torch.device) -> torch.Tensor:
        if device not in self._on:
            self._on[device] = self._host.to(device)
        return self._on[device]


def _frame_chunk(plan: FrameShardPlan, frame_chunk):
    """``frame_chunk`` with "auto" resolved (ops/stft.auto_frame_chunk of
    the shard's frame count)."""
    return (auto_frame_chunk(plan.frames_per_shard)
            if frame_chunk == "auto" else frame_chunk)


# ---------------------------------------------------------------------------
# Sharded STFT / iSTFT
# ---------------------------------------------------------------------------

def sharded_stft_fn(mesh: Mesh, plan: FrameShardPlan,
                    dtype: torch.dtype = torch.float32,
                    fft_backend: str = "auto"):
    """Sharded STFT: a Sharded [B, F_pad*hop] signal -> (re, im) planes,
    each a Sharded [B, F_pad, N/2+1] (kernel KE with every bin, or the route
    ``fft_backend`` names: ops/fftbackend.resolve)."""
    window = _PerDevice(hann_window(plan.frame_len), dtype)
    bins = plan.frame_len // 2 + 1

    def fn(x: Sharded) -> tuple[Sharded, Sharded]:
        re, im = [], []
        for e in _local_signal_ext(x, plan):
            sp = stft_planes(e, window(e.device), plan.frame_len, plan.hop, 0,
                             bins, fft_backend)
            re.append(sp[..., 1].contiguous())
            im.append(sp[..., 0].contiguous())
        return Sharded(mesh, re), Sharded(mesh, im)

    return fn


def sharded_istft_fn(mesh: Mesh, plan: FrameShardPlan,
                     dtype: torch.dtype = torch.float32):
    """Sharded direct iSTFT with the GLOBAL window-sum threshold: a complex
    Sharded [B, F_pad, N/2+1] -> Sharded [B, F_pad*hop] (reference
    phase/phase.go:93-133): KG with each shard's real-frame count, KH
    without a window, then KM's halo add and normalisation."""
    window = _PerDevice(hann_window(plan.frame_len), dtype)

    def fn(half_spec: Sharded) -> Sharded:
        sig_exts = []
        for i, h in enumerate(half_spec.shards):
            real = _local_frame_count(plan, _frame_index(mesh, i))
            frames_w = istft.irfft_window(
                h.real.contiguous(), h.imag.contiguous(), plan.frame_len,
                window(h.device), real)
            sig_exts.append(istft.overlap_add(frames_w, plan.hop))
        return Sharded(mesh, _local_overlap_add(
            sig_exts, mesh, plan, window=window(mesh.first_device),
            hop=plan.hop, n_frames=plan.n_frames))

    return fn


# ---------------------------------------------------------------------------
# Griffin-Lim
# ---------------------------------------------------------------------------

def _shard_noise(seed: int, plan: FrameShardPlan, b_loc: int,
                 dtype: torch.dtype, shard_id: int,
                 device: torch.device) -> torch.Tensor:
    """Shard ``shard_id``'s Griffin-Lim start: uniform [0, 1) [b_loc,
    chunk] drawn on ``device`` (the shard's) from the key
    ``fold_in(key(seed), shard_id)``, ``shard_id = data_index * n_frame +
    frame_index``: the samples the JAX program draws on that shard
    (gomel_tpu/parallel/sharded.py:308-316), one launch of kernel KP on a
    card. The SINGLE definition shared by the ``noise_init`` path and
    :func:`sharded_gl_noise_fn`, so a resumable run reproduces the one-call
    run bit for bit."""
    return prng.uniform(prng.fold_in(prng.key(seed), shard_id),
                        (b_loc, plan.chunk), dtype, device)


def sharded_gl_noise_fn(mesh: Mesh, plan: FrameShardPlan, batch: int,
                        dtype: torch.dtype = torch.float32):
    """seed -> Sharded [batch, F_pad*hop] per-shard uniform Griffin-Lim
    start, drawn as ``sharded_griffin_lim_fn(noise_init=True)`` draws it."""
    n_data = mesh.shape[DATA_AXIS]
    if batch % n_data != 0:
        raise ValueError(f"batch {batch} must be a multiple of the data "
                         f"axis ({n_data})")
    b_loc = batch // n_data

    def fn(seed: int) -> Sharded:
        return Sharded(mesh, [
            _shard_noise(seed, plan, b_loc, dtype, i, mesh.device(i))
            for i in range(mesh.size)])

    return fn


def sharded_griffin_lim_fn(mesh: Mesh, plan: FrameShardPlan, n_iter: int,
                           dtype: torch.dtype = torch.float32,
                           momentum: float = 0.0, noise_init: bool = False,
                           final_iteration: bool = True,
                           interior_mm: bool | None = None,
                           pcm16: bool = False):
    """Sharded Griffin-Lim: (mag Sharded [B, F_pad, N/2+1], sig0 Sharded
    [B, F_pad*hop]) -> Sharded [B, F_pad*hop], un-normalised overlap-add
    (reference mel/mel.go:111-135).

    Per iteration and shard: KJ on the extended carry [B, chunk + halo]
    with the magnitudes (zero on the pad frames), KK's overlap-add, then
    KM: the left neighbour's tail, and the momentum step when ``momentum``
    > 0, written straight into the next extended carry, whose halo columns
    are then pulled from the right neighbour. ``noise_init=True`` takes a
    seed in place of sig0 (:func:`_shard_noise`). ``final_iteration=False``
    runs all ``n_iter`` iterations as interior ones and returns the carry
    (the building block of ``decode_resumable``); with ``pcm16`` the final
    iteration returns (Sharded int16, per-row finite flags [B]).

    ``interior_mm`` pins the transforms as the JAX program does
    (gomel_tpu/parallel/sharded.py:392-418): True runs every forward
    transform as the matmul DFT at "default" (KN, bf16 operands on the
    card, the window folded into its weights) and the interior inverses as
    KO at "default", with the final inverse exact; False runs every
    iteration exact (KJ, or the xla route); None resolves ``auto_lowp``,
    which is exact on every device of the port."""
    n, hop = plan.frame_len, plan.hop
    if interior_mm is None:
        interior_mm = fftbackend.resolve(
            "auto_lowp", n, mesh.first_device.type) == "mm"
    backend = "mm" if interior_mm else "auto"
    fftbackend.resolve(backend, n, mesh.first_device.type)
    window = _PerDevice(hann_window(plan.frame_len), dtype)
    mom = float(momentum)

    def project(exts, mags, final=False):
        return [gl_overlap_add(gl_project(e, m, window(e.device), n, hop,
                                          backend, final, hann_window(n)),
                               hop)
                for e, m in zip(exts, mags)]

    def fn(mag: Sharded, sig0):
        if noise_init:
            sig0 = sharded_gl_noise_fn(
                mesh, plan, mag.shape[0], dtype)(sig0)
        mags = []
        for i, m in enumerate(mag.shards):
            real = _local_frame_count(plan, _frame_index(mesh, i))
            if real < m.shape[1]:
                m = m.clone()
                m[:, real:] = 0.0
            mags.append(m)
        exts = _local_signal_ext(sig0, plan)
        n_interior = n_iter if not final_iteration else max(n_iter - 1, 0)
        t_prev = list(sig0.shards)
        for _ in range(n_interior):
            sig_exts = project(exts, mags)
            if mom != 0.0:
                outs = _local_overlap_add(sig_exts, mesh, plan, t_prev=t_prev,
                                          momentum=mom, extend=True)
                exts, t_prev = [c for c, _ in outs], [t for _, t in outs]
            else:
                exts = _local_overlap_add(sig_exts, mesh, plan, extend=True)
            _pull_right_halo(exts, mesh, plan)
        if final_iteration and n_iter >= 1:
            outs = _local_overlap_add(project(exts, mags, final=True), mesh,
                                      plan, pcm16=pcm16)
            return _pcm16_result(outs, mesh) if pcm16 else Sharded(mesh, outs)
        sig = [e[:, :plan.chunk].contiguous() for e in exts]
        if pcm16:
            return _pcm16_result(
                [(pcm16_encode(s)[0], torch.isfinite(s).all(dim=-1))
                 for s in sig], mesh)
        return Sharded(mesh, sig)

    return fn


# ---------------------------------------------------------------------------
# Codec-level sharded pipelines
# ---------------------------------------------------------------------------

def sharded_phase_encode_fn(mesh: Mesh, plan: FrameShardPlan, num_freqs: int,
                            dtype: torch.dtype = torch.float32,
                            fft_backend: str = "auto", frame_chunk=None):
    """Sharded [B, F_pad*hop] audio -> Sharded [B, F_pad, num_freqs, 2]
    phase spectrogram (reference phase/phase.go:41-70): kernel KE (or the
    route ``fft_backend`` names) on each shard's extended signal.
    ``frame_chunk`` (an int, or "auto" for
    ops/stft.auto_frame_chunk of the shard's frame count) launches it once
    per chunk of frames, as the JAX program's default does; on the H100
    that was slower than one launch per shard (PERF.md, K18), hence None."""
    window = _PerDevice(hann_window(plan.frame_len), dtype)
    fc = _frame_chunk(plan, frame_chunk)

    def fn(x: Sharded) -> Sharded:
        return Sharded(mesh, [
            phase_encode(e, num_freqs, plan.frame_len, plan.hop,
                         window(e.device), fft_backend, frame_chunk=fc)
            for e in _local_signal_ext(x, plan)])

    return fn


def sharded_phase_decode_fn(mesh: Mesh, plan: FrameShardPlan,
                            volume_boost: float = 0.0,
                            dtype: torch.dtype = torch.float32,
                            frame_chunk="auto", *, pcm16: bool = False):
    """Sharded [B, F_pad, num_freqs, 2] -> Sharded [B, F_pad*hop] audio
    (reference phase/phase.go:136-153): per shard KG (grow + irfft x window,
    pad frames zero) and KH's un-normalised overlap-add, then KM's halo add,
    global window-sum normalisation and boost; with ``pcm16``, (Sharded
    int16, per-row finite flags [B]). ``frame_chunk`` is taken in the JAX
    program's place and has no effect: its per-chunk synthesis with a
    carried tail (ops/istft.chunked_irfft_overlap_add) bounds on-chip
    memory, and one owner per output sample needs neither."""
    del frame_chunk
    window = _PerDevice(hann_window(plan.frame_len), dtype)

    def fn(spec2: Sharded):
        sig_exts = []
        for i, s in enumerate(spec2.shards):
            real = _local_frame_count(plan, _frame_index(mesh, i))
            sig_exts.append(phase_synthesize(s, plan.frame_len, plan.hop,
                                             window(s.device), real))
        outs = _local_overlap_add(
            sig_exts, mesh, plan, window=window(mesh.first_device),
            hop=plan.hop, n_frames=plan.n_frames,
            volume_boost=float(volume_boost), pcm16=pcm16)
        return _pcm16_result(outs, mesh) if pcm16 else Sharded(mesh, outs)

    return fn


def sharded_mel_encode_fn(mesh: Mesh, plan: FrameShardPlan, num_mels: int,
                          fwd_weights, dtype: torch.dtype = torch.float32,
                          fft_backend: str = "auto", frame_chunk=None):
    """Sharded [B, F_pad*hop] audio -> Sharded [B, F_pad, num_mels, 2]
    log-mel (reference mel/mel.go:46-74): kernels KB (or the route
    ``fft_backend`` names) + KC on each shard's extended signal
    (``frame_chunk`` as in sharded_phase_encode_fn). The filterbank is
    replicated on every shard's device."""
    window = _PerDevice(hann_window(plan.frame_len), dtype)
    fwd = _PerDevice(fwd_weights, dtype)
    fc = _frame_chunk(plan, frame_chunk)

    def fn(x: Sharded) -> Sharded:
        return Sharded(mesh, [
            mel_encode(e, num_mels, plan.frame_len, plan.hop, fwd(e.device),
                       window(e.device), fft_backend, frame_chunk=fc)
            for e in _local_signal_ext(x, plan)])

    return fn


def sharded_mel_magnitudes_fn(mesh: Mesh, inv_weights, tune_mul: float = 1.0,
                              tune_add: float = 0.0,
                              dtype: torch.dtype = torch.float32):
    """Sharded log-mel [B, F_pad, M, 2] -> Sharded Griffin-Lim magnitudes
    [B, F_pad, N/2+1] (exp, inverse filterbank, tune; kernel KI per
    shard). Frame-local: no halo."""
    inv = _PerDevice(inv_weights, dtype)

    def fn(logmel: Sharded) -> Sharded:
        return Sharded(mesh, [
            mel_to_magnitudes(s.contiguous(), inv(s.device), tune_mul,
                              tune_add) for s in logmel.shards])

    return fn


def sharded_mel_decode_fn(mesh: Mesh, plan: FrameShardPlan, inv_weights,
                          n_iter: int, tune_mul: float = 1.0,
                          tune_add: float = 0.0,
                          dtype: torch.dtype = torch.float32,
                          momentum: float = 0.0,
                          interior_mm: bool | None = None,
                          pcm16: bool = False):
    """Sharded [B, F_pad, num_mels, 2] log-mel + seed -> Sharded
    [B, F_pad*hop] audio by sharded Griffin-Lim from per-shard starts
    (reference mel/mel.go:142-152); with ``pcm16``, (Sharded int16, per-row
    finite flags [B]). ``interior_mm`` as in sharded_griffin_lim_fn."""
    mags = sharded_mel_magnitudes_fn(mesh, inv_weights, tune_mul, tune_add,
                                     dtype)
    gl = sharded_griffin_lim_fn(mesh, plan, n_iter, dtype, momentum=momentum,
                                noise_init=True, interior_mm=interior_mm,
                                pcm16=pcm16)

    def fn(logmel: Sharded, seed: int):
        return gl(mags(logmel), seed)

    return fn
