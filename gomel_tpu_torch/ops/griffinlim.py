"""Griffin-Lim phase reconstruction: one iteration is kernel KJ (frame x
window -> rFFT -> unit phase x magnitude -> inverse rFFT x window) then
kernel KK (overlap-add, with the momentum step or the PCM-16 conversion as
its epilogue), both csrc/griffinlim.cu.

Counterpart of ``gomel_tpu/ops/griffinlim.py`` (reference mel/mel.go:76-139):
the magnitudes are fixed across iterations, ``mag[k] = |ch0[k]|`` for
k < N/2 and ``mag[N/2] = |ch1[N/2-1]|``, and each iteration is
``signal <- overlap_add(irfft(mag * e^{i phase(rfft(window * frames))}) *
window)`` with no window-sum normalisation (mel/mel.go:127-132).

``fft_backend`` takes the JAX package's names (ops/fftbackend.py). Its
default, ``auto``, resolves as ``auto_lowp``, which is exact on the card as
on every backend of the JAX package but a TPU: every iteration is KJ + KK
(or the xla route, ``torch.fft``, for a size KJ does not take). ``mm`` runs
the reduced-precision DFT of the JAX package's TPU default
(gomel_tpu/ops/griffinlim.py:146-193): every forward transform, the final
one too, is KN at "default" (bf16 operands) with the window folded into
its weights and the projection as its epilogue; the interior inverses are
KO at "default"; the final inverse is exact (KG, or the xla route), then
KK. On a CPU tensor each step runs its plain PyTorch version (the JAX
program's order of operations, and the matmul DFT in full precision, as
XLA's CPU backend runs it); on a CUDA tensor it launches its kernel.

The random initial signal is drawn on the magnitudes' device from a
Threefry key (ops/prng.uniform: kernel KP on a card, its plain version on
the CPU): the samples ``jax.random.uniform`` draws from the same key, so a
seed gives the JAX package's start on every device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import annotate, count
from . import _cuda, dft_mm, fftbackend, istft, prng
from .istft import overlap_add_plain
from .quantize import pcm16_encode
from .rfft_mag import fft_plan_args, fft_tables
from .stft import frame_signal, hann_window, window_like

PROJECT_KERNEL = _cuda.Kernel("gl_project", "gomel_tpu_torch/csrc/griffinlim.cu",
                              "gomel_tpu/ops/griffinlim.py:98")
OLA_KERNEL = _cuda.Kernel("gl_overlap_add",
                          "gomel_tpu_torch/csrc/griffinlim.cu",
                          "gomel_tpu/ops/griffinlim.py:196")

# Measured equal-quality serving pairs of the JAX package
# (benchmarks/exp_gl_frontier.py; benchmarks/RESULTS.md "GL momentum"):
# plain-GL(n) quality class -> (momentum, iterations) matching or beating it.
# Per-iteration cost is unchanged by momentum.
GL_EQUAL_QUALITY_PAIRS: dict[int, tuple[float, int]] = {
    2: (0.99, 2),     # momentum needs 2 iterations of history: equal cost
    16: (0.99, 8),
    32: (0.99, 16),
    64: (0.99, 24),
}


def recommended_gl(plain_iters: int) -> tuple[float, int]:
    """(momentum, iterations) matching plain-GL(``plain_iters``) quality at
    the least measured cost (gomel_tpu/ops/griffinlim.py:68-87): momentum
    at equal iterations below 16, n/2 from 16, 3n/8 from 64."""
    if plain_iters < 1:
        raise ValueError("plain_iters must be >= 1")
    if plain_iters < 2:
        return (0.0, plain_iters)
    if plain_iters < 16:
        return (0.99, plain_iters)
    if plain_iters < 64:
        return (0.99, -(-plain_iters // 2))
    return (0.99, -(-plain_iters * 3 // 8))


def griffin_lim_magnitudes(linear2: torch.Tensor) -> torch.Tensor:
    """Half-spectrum magnitudes [..., F, N/2 + 1] from a 2-channel linear
    spectrogram [..., F, N/2, 2]: |ch0| for bins 0..N/2-1, and bin N/2 =
    |ch1[N/2-1]| (the ``undospectrum`` layout, mel/impl.go:386-408)."""
    return torch.cat([linear2[..., 0].abs(), linear2[..., -1:, 1].abs()],
                     dim=-1)


def gl_project_plain(sig: torch.Tensor, mag_half: torch.Tensor,
                     window: torch.Tensor, n: int, hop: int) -> torch.Tensor:
    """Plain PyTorch version of KJ: frames of ``sig`` x window -> rfft ->
    unit phase (angle 0 -> 1, times 1/|X|, gomel_tpu/ops/griffinlim.py:
    177-181) x ``mag_half`` -> irfft x window, in ``sig``'s dtype."""
    spec = torch.fft.rfft(frame_signal(sig, n, hop) * window, dim=-1)
    re, im = spec.real, spec.imag
    a = torch.sqrt(re * re + im * im)
    pos = a > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, a, 1.0), 0.0)
    unit_re = torch.where(pos, re * inv, 1.0)
    unit_im = im * inv
    rec = torch.fft.irfft(torch.complex(mag_half * unit_re, mag_half * unit_im),
                          n=n, dim=-1)
    return rec * window


def gl_project(sig: torch.Tensor, mag_half: torch.Tensor,
               window: torch.Tensor, n: int, hop: int, backend: str = "auto",
               final: bool = False, window_host=None) -> torch.Tensor:
    """One Griffin-Lim projection up to the overlap-add: signal
    [..., N + (F-1)*hop] and magnitudes [..., F, n/2 + 1] -> windowed frames
    [..., F, n] (the body of gomel_tpu/ops/griffinlim.py:171-195). The route
    is ``backend``'s (ops/fftbackend.resolve): KJ, the xla route, or, for
    ``mm``, KN's projection at "default" then KO at "default" (``final``
    False) or the exact inverse (``final``). ``window_host``, the window as
    a host array, is what ``mm`` folds into its weights (None: ``window``,
    copied to the host)."""
    *lead, frames, bins = mag_half.shape
    if bins != n // 2 + 1:
        raise ValueError(f"gl_project: {bins} magnitude bins, n={n} needs "
                         f"{n // 2 + 1}")
    if tuple(sig.shape) != tuple(lead) + (n + (frames - 1) * hop,):
        raise ValueError(f"gl_project: signal {tuple(sig.shape)} does not hold "
                         f"{frames} frames of {n} at hop {hop} for magnitudes "
                         f"{tuple(mag_half.shape)}")
    route = fftbackend.resolve(backend, n, sig.device.type)
    if route == "mm":
        fold = window if window_host is None else window_host
        yr, yi = dft_mm.gl_spectrum(sig, mag_half, n, hop, fold, "default",
                                    final)
        if final:
            return istft.irfft_window(yr, yi, n, window)
        return dft_mm.istft_frames(yr, yi, n, fold, "default")
    if sig.device.type == "cpu":
        return gl_project_plain(sig, mag_half, window, n, hop)
    kernel = fftbackend.XLA_ROUTE if route == "xla" else PROJECT_KERNEL
    with annotate(kernel.span):
        sig, mag_half, window = (t.contiguous()
                                 for t in (sig, mag_half, window))
        dev = _cuda.check_cuda("gl_project", sig, mag_half, window)
        if any(t.dtype != torch.float32 for t in (sig, mag_half, window)):
            raise ValueError("gl_project: the CUDA kernel takes float32 "
                             "tensors")
        if route == "xla":
            kernel.launches += 1
            return gl_project_plain(sig, mag_half, window, n, hop)
        return launch_gl_project(sig, mag_half, window, *fft_tables(n, dev),
                                 fft_plan_args(n), n, hop)


def launch_gl_project(sig: torch.Tensor, mag_half: torch.Tensor,
                      window: torch.Tensor, tw: torch.Tensor,
                      tw_pass: torch.Tensor, plan: tuple[int, int, int],
                      n: int, hop: int) -> torch.Tensor:
    """Launch KJ on contiguous float32 CUDA tensors of matching shapes
    (:func:`gl_project`'s checks) with the FFT tables and plan of n."""
    *lead, frames, _ = mag_half.shape
    if window.shape != (n,) or window.data_ptr() % 8:
        raise ValueError(f"gl_project: window shape {tuple(window.shape)} "
                         f"!= ({n},) or misaligned (the kernel reads float2)")
    batch = int(np.prod(lead, dtype=np.int64))
    out = torch.empty(tuple(lead) + (frames, n), dtype=torch.float32,
                      device=sig.device)
    if batch * frames == 0:
        return out
    _cuda.launch("gomel_gl_project", sig.device, sig.data_ptr(),
                 mag_half.data_ptr(), window.data_ptr(), tw.data_ptr(),
                 tw_pass.data_ptr(), out.data_ptr(), batch, frames,
                 sig.shape[-1], hop, n, *plan)
    PROJECT_KERNEL.launches += 1
    return out


def gl_overlap_add_plain(frames_w: torch.Tensor, hop: int,
                         t_prev: torch.Tensor | None = None,
                         momentum: float = 0.0, pcm16: bool = False):
    """Plain PyTorch version of KK: overlap-add (no normalisation), then
    the momentum step t + m * (t - t_prev) returning (c, t), or (int16 PCM,
    per-row finite flag), or the float signal t."""
    t = overlap_add_plain(frames_w, hop)
    if pcm16:
        return pcm16_encode(t)[0], torch.isfinite(t).all(dim=-1)
    if t_prev is None:
        return t
    return t + momentum * (t - t_prev), t


def gl_overlap_add(frames_w: torch.Tensor, hop: int,
                   t_prev: torch.Tensor | None = None, momentum: float = 0.0,
                   pcm16: bool = False):
    """Overlap-add windowed frames [..., F, N] -> t [..., N + (F-1)*hop]
    with no window-sum normalisation (gomel_tpu/ops/griffinlim.py:196).

    With ``t_prev`` (an interior momentum iteration) returns
    (c = t + momentum * (t - t_prev), t); with ``pcm16`` (the final
    iteration of a file decode) returns (int16 PCM, per-row all-finite
    flag [...]) as gomel_tpu/ops/quantize.py:124 converts; else t."""
    if pcm16 and t_prev is not None:
        raise ValueError("gl_overlap_add: the momentum step and PCM-16 are "
                         "separate iterations")
    *lead, frames, n = frames_w.shape
    length = n + (frames - 1) * hop
    if t_prev is not None and tuple(t_prev.shape) != tuple(lead) + (length,):
        raise ValueError(f"gl_overlap_add: t_prev {tuple(t_prev.shape)} != "
                         f"{tuple(lead) + (length,)}")
    if frames_w.device.type == "cpu":
        return gl_overlap_add_plain(frames_w, hop, t_prev, momentum, pcm16)
    with annotate(OLA_KERNEL.span):
        return launch_gl_overlap_add(frames_w, hop, t_prev, momentum, pcm16)


def launch_gl_overlap_add(frames_w: torch.Tensor, hop: int,
                          t_prev: torch.Tensor | None, momentum: float,
                          pcm16: bool):
    """Launch KK on CUDA tensors (see :func:`gl_overlap_add`)."""
    *lead, frames, n = frames_w.shape
    length = n + (frames - 1) * hop
    frames_w = frames_w.contiguous()
    if t_prev is not None:
        t_prev = t_prev.contiguous()
    tensors = (frames_w,) if t_prev is None else (frames_w, t_prev)
    dev = _cuda.check_cuda("gl_overlap_add", *tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("gl_overlap_add: the CUDA kernel takes float32")
    if frames < 1 or hop < 1:
        raise ValueError(f"gl_overlap_add: {frames} frames, hop {hop}")
    lead = tuple(lead)
    batch = int(np.prod(lead, dtype=np.int64))
    out_t = out_c = out_pcm = None
    if pcm16:
        out_pcm = torch.empty(lead + (length,), dtype=torch.int16, device=dev)
    else:
        out_t = torch.empty(lead + (length,), dtype=torch.float32, device=dev)
    if t_prev is not None:
        out_c = torch.empty_like(out_t)
    finite = torch.ones(lead, dtype=torch.int32, device=dev)
    if batch > 0:
        _cuda.launch("gomel_gl_overlap_add", dev, frames_w.data_ptr(),
                     None if t_prev is None else t_prev.data_ptr(),
                     None if out_t is None else out_t.data_ptr(),
                     None if out_c is None else out_c.data_ptr(),
                     None if out_pcm is None else out_pcm.data_ptr(),
                     finite.data_ptr(), batch, frames, n, hop,
                     float(momentum))
        OLA_KERNEL.launches += 1
    if pcm16:
        return out_pcm, finite.bool()
    if t_prev is not None:
        return out_c, out_t
    return out_t


def griffin_lim(mag_half: torch.Tensor, hop: int, n_iter: int, key=None,
                window=None, init=None, fft_backend: str = "auto",
                momentum: float = 0.0, *, pcm16: bool = False):
    """Iterative phase reconstruction (gomel_tpu/ops/griffinlim.py:98).

    mag_half: [..., F, N/2 + 1] fixed half-spectrum magnitudes. Returns the
    signal [..., N + (F-1)*hop] in ``mag_half``'s dtype, or with ``pcm16``
    (int16 PCM, per-row all-finite flag). ``n_iter`` = 0 returns the
    initial signal (mel/mel.go:85: the loop never runs). The initial signal
    is uniform [0, 1) drawn on ``mag_half``'s device from ``key``
    (ops/prng.uniform): anything ``np.asarray`` makes uint32 [2] or [B, 2]
    (ops/prng.key, or a JAX ``PRNGKey``). One key draws the whole
    [..., out_len] as ``jax.random.uniform(key, shape)`` does; a table of
    row keys [B, 2] for magnitudes [B, F, N/2 + 1] draws row r from key r,
    as the JAX package's batched decode does under ``vmap``. ``init``
    overrides the draw; ``window`` is Hann when None. The parameters come
    in the JAX function's order; a floating-point array where the key goes
    is a window passed by position, and raises TypeError (pass
    ``window=``).

    ``momentum`` 0.0 is the reference's plain Griffin-Lim; a value in
    (0, 1] runs fast Griffin-Lim in the signal domain, as the JAX package
    does: ``n_iter - 1`` iterations t_n = G(c_n), c_{n+1} = t_n +
    momentum * (t_n - t_{n-1}) from (c, t) = (init, init), then one plain
    final iteration.

    ``fft_backend``: ``auto`` resolves as ``auto_lowp`` (exact on every
    device); ``mm`` is the JAX package's TPU default (see the module
    docstring); ``xla`` and ``mxu`` are exact.

    Each iteration is a ``gomel.gl.iteration`` span (its ``kind``
    "momentum", "plain" or "final"; the op wrappers' spans nest inside)
    counted in ``gl_iterations.<kind>``, while a profiler records
    (utils/profiling.py).
    """
    if key is not None:
        key = np.asarray(key.cpu() if isinstance(key, torch.Tensor) else key)
        if key.dtype.kind == "f":
            raise TypeError("griffin_lim: a floating-point key is a window "
                            "passed by position; the JAX order is (mag_half, "
                            "hop, n_iter, key, window, ...): pass window=")
    *lead, frames, bins = mag_half.shape
    n = (bins - 1) * 2
    dtype, dev = mag_half.dtype, mag_half.device
    backend = fftbackend.resolve(
        "auto_lowp" if fft_backend == "auto" else fft_backend, n, dev.type)
    # the host window the mm route folds into its weights, as the JAX
    # program takes it (a tensor window is copied to the host instead)
    window_host = (hann_window(n) if window is None else
                   window if isinstance(window, np.ndarray) else None)
    window = window_like(window, n, mag_half)
    out_len = n + (frames - 1) * hop
    shape = tuple(lead) + (out_len,)
    if init is not None:
        sig = torch.as_tensor(init, dtype=dtype, device=dev)
        if tuple(sig.shape) != shape:
            raise ValueError(f"griffin_lim: init {tuple(sig.shape)} != {shape}")
    elif key is None:
        raise ValueError("griffin_lim: give the start's key (ops/prng.key) "
                         "or init=")
    elif np.ndim(key) == 2:
        if tuple(lead) != (len(key),):
            raise ValueError(f"griffin_lim: {len(key)} row keys for "
                             f"magnitudes {tuple(mag_half.shape)}")
        sig = prng.uniform(key, (out_len,), dtype, dev)
    else:
        sig = prng.uniform(key, shape, dtype, dev)

    def project(s, final=False):
        return gl_project(s, mag_half, window, n, hop, backend, final,
                          window_host)

    interior = max(n_iter - 1, 0)
    kind = "momentum" if momentum != 0.0 else "plain"
    t_prev = sig
    for _ in range(interior):
        with annotate("gomel.gl.iteration", kind=kind):
            count("gl_iterations." + kind)
            if momentum != 0.0:
                sig, t_prev = gl_overlap_add(project(sig), hop, t_prev,
                                             float(momentum))
            else:
                sig = gl_overlap_add(project(sig), hop)
    if n_iter >= 1:
        with annotate("gomel.gl.iteration", kind="final"):
            count("gl_iterations.final")
            return gl_overlap_add(project(sig, final=True), hop, pcm16=pcm16)
    if pcm16:
        return pcm16_encode(sig)[0], torch.isfinite(sig).all(dim=-1)
    return sig
