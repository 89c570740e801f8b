"""Smoke run of the PyTorch/CUDA port (gomel_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from gomel_tpu_torch/csrc, checks each
against its plain PyTorch version on the card at the shapes of the bench
(2 x 30 s of 48 kHz audio at MelConfig.cli_default() and
PhaseConfig.cli_default(); for the batch forms, 4 rows of 30 s with masked
frame counts, NaNs and mixed per-row scales), drives the main paths through
the user's entry points (the ``tomel`` CLI, then ``tophase`` and
``fromphase``, on a 30 s 48 kHz WAV and, for the zero-stuff ingest, a short
16 kHz WAV, then ``towav`` on the ``tomel`` PNG; then the four batch CLIs on
a directory of 12 WAV and FLAC files of 2-45 s; then LongFormPhase and
LongFormMel on a 30-minute WAV over four frame shards of the card; then the
streaming codecs on that signal) and holds
their PNGs and WAVs against the port's CPU path and its single-file tools,
checks that every kernel of each path was launched on it, and times each
kernel against its plain version, its bound and, where one exists, the one
PyTorch call of the same function, each batch CLI against the single-file
tool, and each long-form call step by step. KH and KM walk hop-rows, 4
samples a thread where the shapes allow: phase 2b holds KH on that vector
path and on its scalar path (an odd hop), phase 2e KH's plain overlap-add
at one long-form shard and KM's modes on both paths (a shard start 2
samples on), and phase 4 also times KH's overlap-add at the shard and KM's
momentum step, each beside its bound. Phase 2f holds the matmul
DFT's kernels KN and KO (bf16 and float32 modes, every epilogue) against
their plain versions at the bench shape and at ragged shapes, KO reading
KN's padded bf16 planes in place against contiguous copies, and a frame
alone against the batch, bit for bit; it also holds the
FFT kernels' mixed radix at n = 3000 at every site, and the xla route
(torch.fft for a size without the TPU's n1 * n2 split, which the TPU also
gives its library FFT) at n = 514 at every site; 3f drives
mel_decode(fft_backend="mm") at GL-2 and recommended_gl(64) against the
exact route, the phase codec with "mm", tomel/towav and Phase at resolut
3000 and Phase at resolut 514 against the CPU, and (in 3e)
sharded_mel_decode_fn(interior_mm=True) on the 30-minute file; phase 4 times
KN and KO in each mode beside torch.matmul on the same operands and on
operands padded to aligned widths, one interior Griffin-Lim iteration on
them against KJ, KB and KJ at n = 3000, and the xla route at n = 514. The
Griffin-Lim
start is drawn on the card by KP (Threefry-2x32, the JAX package's samples):
phase 2g holds it bit for bit against its plain version at the bench shape
(one key and row keys), the batch shape, one shard of the 30-minute file and
ragged sizes, and against the known answers; towav, batch-towav and
LongFormMel.to_wav_png count its launches; phase 3g streams the 30-minute
signal in one-second pieces through StreamingPhase and StreamingMel (512
frames a chunk) against Phase and Mel on the whole signal. KB and KE run a
register-resident FFT at every power-of-two n/2: phase 2 holds them at every
such n from 4 to 16384, on the scalar-load route, at KE's bin ranges and for
bench frames computed alone against the batch (fwd_core_checks). KG and KJ
run the same core's inverse at those sizes: phase 2 holds KG on planes with
and without the window and with real-frame counts, KJ, and bench frames
computed alone against the batch (inv_core_checks). KB, KE, KG and KJ run
a mixed-radix register core where n/2 is not a power of two: phase 2 holds
them at n = 6 ... 12000 (prime and generic-pass sizes too) against float64,
KG in its four source modes and with a real-frame count (masked frames
zeros), KB's and KE's scalar-load route and a frame alone against the batch
(mixed_core_checks); phase 4 times them at n = 3000 beside the rows PERF.md
recorded before (EARLIER_MS). On KB's power-of-two
route the mel encode is one fused launch (KB's transform with KC's band sum
in its epilogue): phase 2 holds it bit-equal to KB followed by KC at the
bench shape (also with a NaN frame), and KC within 1e-5 of its plain
version in the log domain at n = 4096 and 3000; the mel encode paths
(tomel, batch-tomel, the long-form shards, the stream) must launch it, the
stream once a chunk and neither KB nor KC alone. Phase 2e also holds KL
bit-equal on a shard's planes read one byte off 16-byte alignment. KF runs
pass 1 on a grid sized to the card with one fold of the partials a row, and
KI on runs of frames: phase 2b holds KF bit-equal also at an odd nf and on
a base one float past 16 bytes (its scalar paths), phase 2c holds KI
bit-equal to the form it replaced (tools/quant_earlier.cu, built beside the
kernels) in both modes, with tune and boost and at the resolut 3000 widths,
phase 2e holds KF and KD at the long-form gathered shapes ([67500, 1536, 2]
and [67500, 192, 2]), and phase 4 times them there. KD runs KF's two passes
with one global max and min a row: phase 2 holds it bit-equal also on a
base one float past 16 bytes and at an odd mel count (its scalar paths),
phase 2d masked with NaN rows, phase 2e at the long-form shape. KP draws 4
samples a thread on a grid of the card's resident blocks: phase 2g also
holds it on a table of 3 keys x 1001 samples (rows off 16 bytes, heads and
tails).
Phase 4 prints each kernel's time beside the one PERF.md last recorded
(EARLIER_MS).

KA (PCM-16 ingest) stores a float4 of output a thread, from one 8-byte load
of 4 mono int16 or one 16-byte load of 4 stereo frames where the row allows:
phase 2 also holds its three modes (mono and stereo, zero-stuff at every
pad-shift pair, per-row scales) bit-exact at odd lengths and on bases 1 and
3 int16 off 16 bytes. On the mel encode from PCM (tomel, batch-tomel) the
fused KB + KC reads the int16 samples itself in its int16 mode: phase 2
holds it bit-equal to KA followed by the float launch (the bench shape, a
row not a multiple of the hop, a row shorter than a frame, per-row scales,
the batch with its empty row), phase 3 holds tomel's PNG byte-equal to the
KA route's, those two paths must launch it and no KA, and phase 4 times it
and both PCM chains (to the log-mel, and with KD) against KA followed by the
float launch.

Phase 3i drives the compat drop-in (gomel_tpu_torch.compat.phase, the
reference Python port's ``import phase``) on the card: to_phase_wav and
to_wav_png on phase 3's 30 s WAV in 8-bit, IHS and HDR, to_phase_flac and
to_wav_png on a 30 s 16 kHz FLAC, each with device quantize off and on,
against the same calls on the CPU, with the launches each must show; then
the native PNG scanline filter (native/pngfilter.cpp): loaded, write_png's
bytes and read_png's arrays equal to the numpy path's on all five filter
types, and read_png's host time, native against numpy, on the 30 s phase
PNG with Up, Sub and Paeth rows.

Phase 2h holds the JAX call surface on the card at the bench shape
(``call_surface``): ``frame_chunk`` on mel_encode_batch and
phase_encode_batch from float32 and int16 rows (bit-equal to the unchunked
call, one launch a chunk), on phase_decode (one KG and one KH launch, within
1e-5 of the unchunked decode's peak; a chunk under N - hop raises),
chunked_irfft_overlap_add with a prefix and a scattered ``frame_mask``, and
ops/mxu_fft's transforms on KE, KB and KG.

The last three lines of standard output are the card's name and power limit
(nvidia-smi), a JSON object with one entry per kernel, and
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero; so
does a machine without CUDA. Imports nothing of JAX or gomel_tpu.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
SAMPLE_RATE = 48000
SECONDS = 30.0
BATCH = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def seeded_pcm(rng: np.random.Generator, rows: int, n: int) -> np.ndarray:
    """int16 [rows, n]: a few tones plus noise at speech-like levels, with a
    quiet stretch so the log-mel spans a wide range."""
    t = np.arange(n) / SAMPLE_RATE
    out = np.empty((rows, n), dtype=np.int16)
    for r in range(rows):
        f = rng.uniform(80.0, 4000.0, size=4)
        a = rng.uniform(0.02, 0.2, size=4)
        x = sum(ai * np.sin(2 * np.pi * fi * t) for ai, fi in zip(a, f))
        x = x + 0.01 * rng.standard_normal(n)
        x[n // 3: n // 3 + SAMPLE_RATE] *= 1e-3
        out[r] = np.clip(np.rint(x * 32768.0), -32768, 32767)
    return out


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call: CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls. A sleep kernel first keeps the
    card busy while the host enqueues the timed calls, so the events time the
    device work, not the Python wrappers' launch overhead. If the card still
    caught up with the host, the sleep was too short, or the calls' many small
    kernels filled the launch queue (about a thousand entries; a full queue
    blocks the host until the sleep ends): the sleep doubles, the number of
    calls halves, and the run repeats."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    for _ in range(8):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue_s = time.perf_counter() - t0
        end.record()
        if not start.query():       # still sleeping: no gap between calls
            end.synchronize()
            return start.elapsed_time(end) / iters
        cycles *= 2
        iters = max(2, iters // 2)
    raise RuntimeError(f"could not enqueue the timed calls ahead of the card "
                       f"(the last {iters} took {enqueue_s:.3f} s to enqueue)")


def host_us(fn, iters: int = 50) -> float:
    """Host microseconds to enqueue one call (wrapper overhead)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def wall_ms(fn, iters: int = 50) -> float:
    """Host-clock milliseconds per call over back-to-back calls ending in a
    synchronise: what a Python caller sees, launch overhead included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def seeded_pcm_rate(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    """int16 [n] at rate ``sr``: tones below 4 kHz plus light noise."""
    t = np.arange(n) / sr
    f = rng.uniform(80.0, 3500.0, size=4)
    a = rng.uniform(0.05, 0.2, size=4)
    x = sum(ai * np.sin(2 * np.pi * fi * t) for ai, fi in zip(a, f))
    x = x + 0.005 * rng.standard_normal(n)
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)


def png_steps(a_path: str, b_path: str, read_png) -> np.ndarray:
    """Per-pixel steps between two PNGs of one bit depth, wrap-aware on the
    derived B channel (-1 vs 0 wraps to the top level: 255 or 65535)."""
    a, b = read_png(a_path), read_png(b_path)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"PNGs differ in form: {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return np.minimum(d, int(np.iinfo(a.dtype).max) + 1 - d)


def towav_split(png: str, out: str, dev: torch.device, runs: int
                ) -> dict[str, float]:
    """Milliseconds of each step of ``towav --device cuda`` (the steps of
    Mel.to_wav_png with device quantize), each ended by a synchronise;
    medians of ``runs``."""
    from gomel_tpu_torch.cli import tools
    from gomel_tpu_torch.core.framing import is_padded
    from gomel_tpu_torch.io import audio as audio_io
    from gomel_tpu_torch.io import imagecodec
    from gomel_tpu_torch.ops import griffinlim, mel_ops, prng

    steps: dict[str, list[float]] = {}

    def step(name, fn):
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        steps.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
        return value

    for _ in range(runs):
        def setup():
            a = tools._mel_parser("towav", True).parse_args(
                [png, str(SAMPLE_RATE), "--seed", "1", "-o", out, "--device",
                 str(dev)])
            return tools._mel_from_args(a, a.sample_rate), a
        m, a = step("setup (argparse + Mel)", setup)
        c = m.config
        planes, mx, mn, samples, sr = step(
            "PNG read", lambda: imagecodec.load_mel_image_raw(png, True))
        planes = step("H2D planes", lambda: torch.from_numpy(planes).to(dev))
        gl_len = c.resolut + (planes.shape[1] - 1) * c.window
        init = step("GL start drawn on the card (KP)", lambda: prng.uniform(
            prng.key(a.seed), (gl_len,), torch.float32, dev))

        def kernels():
            mag = mel_ops.mel_to_magnitudes(planes, m.inv_weights, c.tune_mul,
                                            c.tune_add, c.volume_boost, mx, mn)
            return griffinlim.griffin_lim(mag, c.window,
                                          c.griffin_lim_iterations,
                                          window=m.window, init=init,
                                          pcm16=True)
        pcm, finite = step("KI + GL kernels", kernels)
        wave = step("D2H int16 + flag", lambda: (pcm.cpu().numpy(),
                                                bool(finite)))[0]

        def write():
            w = wave
            if int(samples) > 0 and is_padded(int(samples), len(w), c.window) \
                    and len(w) > int(samples):
                w = w[:int(samples)]
            audio_io.save_wav_pcm16(out, w, c.sample_rate)
        step("WAV write", write)
    return {k: float(np.median(v)) for k, v in steps.items()}


def graph(fn):
    """``fn`` captured once in a CUDA graph (after warmup calls on a side
    stream); returns a function that replays it: one launch per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g.replay


def race(kernel_fn, plain_fn, name: str = "", iters: int = 20,
         warmup: int = 3) -> tuple[float, float]:
    """(kernel ms, plain ms), each the lower of two runs taken in the order
    plain, kernel, kernel, plain."""
    try:
        p1 = cuda_ms(plain_fn, iters, warmup)
        k1 = cuda_ms(kernel_fn, iters, warmup)
        k2 = cuda_ms(kernel_fn, iters, warmup)
        p2 = cuda_ms(plain_fn, iters, warmup)
    except RuntimeError as e:
        raise RuntimeError(f"timing {name}: {e}") from e
    return min(k1, k2), min(p1, p2)


def busy_share(fn) -> tuple[float, float, float]:
    """(wall ms, device-busy ms, busy share) of one call of ``fn`` under
    torch.profiler: the device time of every kernel and copy it traced,
    over the host-clock wall of the call (ended by a synchronise)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return 1e3 * wall, busy_us / 1e3, busy_us / 1e6 / wall


def pngs_near(a: str, b: str, mel: bool) -> tuple[int, float]:
    """(max step, flip rate) between two PNGs of the mel (or phase) codec;
    raises beyond 1 step, a flip rate of 2e-3, or unequal metadata."""
    from gomel_tpu_torch.io import imagecodec
    from gomel_tpu_torch.io.pngcodec import read_png
    d = png_steps(a, b, read_png)
    load = (lambda p: imagecodec.load_mel_image_raw(p, True)[1:]) if mel \
        else (lambda p: imagecodec.load_phase_image_raw(p, True)[1:])
    meta_eq = all(np.array_equal(u, v) for u, v in zip(load(a), load(b)))
    if d.max() > 1 or float((d > 0).mean()) >= 2e-3 or not meta_eq:
        raise AssertionError(f"{a} vs {b}: max step {int(d.max())}, flip "
                             f"rate {float((d > 0).mean()):.2e}, metadata "
                             f"equal {meta_eq}")
    return int(d.max()), float((d > 0).mean())


def wavs_near(a: str, b: str, lsb_bound: int) -> tuple[int, float]:
    """(max LSB, differing share) between two WAVs; raises beyond
    ``lsb_bound`` or 5e-2 differing, or on unequal rates or lengths."""
    from gomel_tpu_torch.io import wavcodec
    (wa, sa), (wb, sb) = wavcodec.read_wav(a), wavcodec.read_wav(b)
    if sa != sb or wa.shape != wb.shape:
        raise AssertionError(f"{a} vs {b}: {wa.shape} @ {sa} vs "
                             f"{wb.shape} @ {sb}")
    d = np.abs(wa.astype(np.int64) - wb.astype(np.int64))
    if d.max() > lsb_bound or float((d > 0).mean()) >= 5e-2:
        raise AssertionError(f"{a} vs {b}: {int(d.max())} LSB, "
                             f"{float((d > 0).mean()):.2e} differing")
    return int(d.max()), float((d > 0).mean())


LONG_SECONDS = 1800.0   # the long-form phase's file: 30 minutes at 48 kHz
N_SHARDS = 4            # frame shards of that phase, all on one card
# H100 SXM peaks for bound_ms (NVIDIA's data sheet): HBM bytes/s, float32
# SIMT FLOP/s (every kernel but KN/KO's bf16 mode) and dense bf16 tensor-core
# FLOP/s (KN/KO's bf16 mode)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
# instructions/s the card can dispatch (KP): 4 warp instructions a clock an SM,
# the 128 lanes the float32 peak counts with a fused multiply-add as two
# operations. The 64 int32 lanes an SM are no ceiling for KP: the compiler
# sends its round adds to the FMA pipe (IMAD.IADD, tools/sass_opcodes.py)
# beside the integer pipe's shifts and xors
INSTR_RATE_S = FP32_FLOP_S / 2
# KP's integer instructions a sample: 20 rounds of add, funnel shift, xor;
# 12 key-schedule adds; the xor of the two words, the shift and the or
THREEFRY_OPS = 20 * 3 + 12 + 3


# each kernel's phase-4 device ms as PERF.md recorded it before KD's, KP's
# and KA's redesign, and the n = 3000 rows before the mixed-radix register
# core took them (KB's and KJ's, then KE's and KG's; NVIDIA H100 80GB HBM3,
# 700.00 W; the last run PERF.md names for each), printed beside this run's
# to read the controls off
EARLIER_MS = {
    "pcm16_ingest": 0.0086, "pcm16_ingest zero-stuff": 0.0160,
    "pcm16_ingest_rows": 0.0169, "stft_mag": 0.0256, "mel_log": 0.0143,
    "stft_mel_log": 0.0304, "quantize_mel_plane": 0.0125,
    "quantize_mel_plane_masked": 0.0128,
    "quantize_mel_plane (long form)": 0.6949, "phase_encode": 0.0258,
    "quantize_planes": 0.0322, "quantize_planes_masked": 0.0521,
    "quantize_planes (long form)": 0.6365, "irfft_window": 0.0453,
    "irfft_window_masked": 0.2016, "overlap_normalize": 0.0211,
    "overlap_normalize (shard overlap-add)": 0.1245,
    "mel_to_magnitudes": 0.0146, "gl_project": 0.0528,
    "gl_overlap_add": 0.0254, "dequantize_raw": 0.1019,
    "shard_epilogue": 0.0669, "shard_epilogue (momentum)": 0.1257,
    "dft_fwd_bf16": 0.2970, "dft_fwd_f32": 2.0040, "dft_inv_bf16": 0.2719,
    "dft_inv_f32": 2.1178, "threefry_uniform": 0.0130,
    "threefry_uniform one shard": 0.0752,
    "mixed radix stft_mag (KB's site)": 0.1197,
    "mixed radix gl_project (KJ's site)": 0.2333,
    "mixed radix phase_encode (KE's site)": 0.1255,
    "mixed radix irfft_window (KG's site)": 0.1262}


def bound(n_bytes: float, flops: float,
          peak: float = FP32_FLOP_S) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over ``peak``."""
    t_b, t_f = n_bytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def nbytes(*tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


def vector_path(*extents, tensors=()) -> bool:
    """The path KH's and KM's entry points take (csrc/overlap_add.cuh
    ola_vector): 4 samples a thread when every extent is a multiple of 4
    and every tensor starts on 16 bytes, else one."""
    return (all(e % 4 == 0 for e in extents)
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def fft_ops(n: int) -> float:
    """Operations of one real FFT of n points (the usual 2.5 n log2 n)."""
    return 2.5 * n * math.log2(n)


def long_plan(pcfg):
    """The frame-shard plan of the 30-minute file at the CLI widths."""
    from gomel_tpu_torch.core.framing import num_frames, pad_length
    from gomel_tpu_torch.parallel import sharded as sh
    n = int(SAMPLE_RATE * LONG_SECONDS)
    f = num_frames(pad_length(n, pcfg.window), pcfg.resolut, pcfg.window)
    return sh.plan_frame_sharding(f, pcfg.resolut, pcfg.window, N_SHARDS)


def longform_kernels(dev: torch.device, errs: dict) -> dict:
    """Phase 2e: KL, KG with its real-frame count (counts 0, partial and
    full) and KM's three modes against their plain versions, at the shapes
    of the last shard of the 30-minute long-form phase decode (PNG planes
    [1, F_loc, 1536, 2]), and KF and KD at the 30-minute file's gathered
    shapes; returns phase 4's closures and work counts."""
    from gomel_tpu_torch.core.config import MelConfig, PhaseConfig
    from gomel_tpu_torch.ops import istft, phase_ops, quantize
    from gomel_tpu_torch.ops.stft import hann_window
    from gomel_tpu_torch.parallel import sharded as sh

    pcfg = PhaseConfig.cli_default()
    n, hop, nf = pcfg.resolut, pcfg.window, pcfg.num_freqs
    plan = long_plan(pcfg)
    f_loc, chunk, halo = plan.frames_per_shard, plan.chunk, plan.halo
    last = N_SHARDS - 1
    real = sh._local_frame_count(plan, last)
    g = torch.Generator(device=dev).manual_seed(SEED)
    planes = torch.randint(0, 256, (1, f_loc, nf, 2), generator=g,
                           device=dev, dtype=torch.uint8)
    maxs = torch.tensor([41.5, 37.25], device=dev)
    mins = torch.tensor([-40.75, -38.5], device=dev)
    spec = quantize.dequantize_raw(planes, maxs, mins, 255)
    spec_ref = quantize.dequantize_raw_plain(planes, maxs, mins, 255)
    rng16 = np.random.default_rng(SEED)
    p16 = torch.from_numpy(rng16.integers(0, 65536, (1, 2048, nf, 2),
                                          dtype=np.uint16)).to(dev)
    small = (torch.tensor([2.0, 1.5], device=dev),
             torch.tensor([-1.75, -2.0], device=dev))
    d16 = quantize.dequantize_raw(p16, *small, 65535, 2, 0.5)
    r16 = quantize.dequantize_raw_plain(p16, *small, 65535, 2, 0.5)
    # the same planes one byte off a 16-byte boundary (KL's scalar head and
    # stores), and the uint16 planes one element off
    off = torch.empty(planes.numel() + 1, dtype=torch.uint8, device=dev)
    off[1:].copy_(planes.reshape(-1))
    off8 = off[1:].reshape(planes.shape)
    off16 = torch.empty(p16.numel() + 1, dtype=torch.uint16, device=dev)
    off16[1:].copy_(p16.reshape(-1))
    off16 = off16[1:].reshape(p16.shape)
    torch.cuda.synchronize()
    if not (torch.equal(spec, spec_ref) and torch.equal(
            quantize.dequantize_raw(off8, maxs, mins, 255), spec_ref)
            and torch.equal(quantize.dequantize_raw(off16, *small, 65535),
                            quantize.dequantize_raw_plain(p16, *small,
                                                          65535))):
        raise AssertionError("dequantize_raw differs from its plain version")
    rel16 = float(((d16 - r16).abs() / r16.abs().clamp_min(1e-6)).max())
    errs["dequantize_raw"] = float((d16 - r16).abs().max())
    log(f"KL dequantize_raw u8 {tuple(planes.shape)}: bit-exact, also one "
        f"byte off 16 (u16: one element off); u16 with 2 "
        f"sinh passes and boost 0.5 {tuple(p16.shape)}: max|d| "
        f"{errs['dequantize_raw']:.3e}, relative {rel16:.3e} (bound 1e-6)")
    if rel16 > 1e-6:
        raise AssertionError("dequantize_raw (IHS) outside its bound")

    win = torch.tensor(hann_window(n), dtype=torch.float32, device=dev)
    full = istft.launch_irfft_window(istft.MODE_SPEC, spec, (), n, f_loc, nf,
                                     win, (1,))
    re, im = phase_ops.grow_half_planes(spec, n // 2)
    peak = istft.irfft_window_plain(re, im, n, None).abs().amax(-1, keepdim=True)
    errs["irfft_window_masked"] = 0.0
    for count in (0, real, f_loc):
        fw = istft.launch_irfft_window(istft.MODE_SPEC, spec, (), n, f_loc,
                                       nf, win, (1,), real_frames=count)
        ref = istft.irfft_window_plain(re, im, n, win, count)
        torch.cuda.synchronize()
        d = (fw - ref).abs()
        ok = bool((d <= 1e-5 * peak).all()) and torch.equal(
            fw[:, :count], full[:, :count]) and not bool(fw[:, count:].any())
        errs["irfft_window_masked"] = max(errs["irfft_window_masked"],
                                          float(d.max()))
        log(f"KG irfft_window, real frames {count} of {f_loc}: max|d| vs "
            f"torch.fft f32 {float(d.max()):.3e}, / unwindowed frame peak "
            f"{float((d / peak.clamp_min(1e-30)).max()):.3e} (bound 1e-5); "
            f"real frames bit-equal to the unmasked launch, the rest zero: "
            f"{ok}")
        if not ok:
            raise AssertionError(f"irfft_window with {count} real frames "
                                 f"outside its bound")
    fw_last = istft.launch_irfft_window(istft.MODE_SPEC, spec, (), n, f_loc,
                                        nf, win, (1,), real_frames=real)
    # KH without a window (the shard's plain overlap-add) on its vector path
    if not vector_path(n, hop, tensors=(fw_last,)):
        raise AssertionError("KH at the shard shape is not on its vector path")
    sig_ext = istft.overlap_add(fw_last, hop)
    left = istft.overlap_add(full, hop)
    torch.cuda.synchronize()
    if not (torch.equal(sig_ext, istft.overlap_add_plain(fw_last, hop))
            and torch.equal(left, istft.overlap_add_plain(full, hop))):
        raise AssertionError("overlap_add (shard) differs from its plain "
                             "version")
    log(f"KH overlap_add {tuple(fw_last.shape)} -> {tuple(sig_ext.shape)} "
        f"({real} and {f_loc} real frames), vector path: bit-exact")
    recv = left[:, chunk:]
    t_prev = torch.rand((1, chunk), generator=g, device=dev)
    decode = dict(window=win, hop=hop, start=last * chunk,
                  n_frames=plan.n_frames)
    # a start 2 samples on (not a multiple of 4, nor of hop) takes the
    # scalar path
    shifted = dict(decode, start=last * chunk + 2)
    extents = (hop, sig_ext.shape[1], chunk, recv.stride(0), chunk)
    if vector_path(*extents, shifted["start"] % hop) or not vector_path(
            *extents, decode["start"] % hop, tensors=(sig_ext, recv, t_prev)):
        raise AssertionError("KM's path choice")
    errs["shard_epilogue"] = 0.0
    for label, kw in (
            ("decode, boost 1.5, PCM-16", dict(decode, volume_boost=1.5,
                                                pcm16=True)),
            ("decode, float32", decode),
            ("decode, start + 2 (scalar path), PCM-16",
             dict(shifted, pcm16=True)),
            ("decode, start + 2 (scalar path), float32", shifted),
            ("GL momentum 0.99, extended carry",
             dict(t_prev=t_prev, momentum=0.99, extend=True)),
            ("GL final, PCM-16", dict(pcm16=True)),
            ("GL final, float32", {})):
        got = istft.shard_epilogue(sig_ext, recv, chunk, **kw)
        want = istft.shard_epilogue_plain(sig_ext, recv, chunk, **kw)
        torch.cuda.synchronize()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        if not all(torch.equal(a[..., :chunk], b[..., :chunk])
                   for a, b in zip(got, want)):
            raise AssertionError(f"shard_epilogue ({label}) differs from its "
                                 f"plain version")
        for a, b in zip(got, want):
            if a.dtype.is_floating_point:
                errs["shard_epilogue"] = max(errs["shard_epilogue"], float(
                    (a[..., :chunk] - b[..., :chunk]).abs().max()))
    log(f"KM shard_epilogue [1, {chunk} + {halo}] (shard {last}, {real} real "
        f"frames): decode with and without boost, float32 and PCM-16, on the "
        f"vector and the scalar path, GL momentum and final: bit-exact")

    # KF and KD at the long-form gathered shapes: the 30-minute file's
    # phase spectrogram [67500, 1536, 2] and log-mel [67500, 192, 2]
    # (pipelines/longform.py _write_spec; frames padded to the shards)
    mcfg = MelConfig.cli_default()
    long_spec = torch.randn((plan.n_frames_padded, nf, 2), generator=g,
                            device=dev) * 40.0
    long_mel = torch.randn((plan.n_frames_padded, mcfg.num_mels, 2),
                           generator=g, device=dev) - 4.0
    long_p = quantize.quantize_planes(long_spec, 255)
    long_m = quantize.quantize_mel_plane(long_mel)
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(
            long_p, quantize.quantize_planes_plain(long_spec, 255)))
            and all(torch.equal(a, b) for a, b in zip(
                long_m, quantize.quantize_mel_plane_plain(long_mel)))):
        raise AssertionError("quantize_planes or quantize_mel_plane at the "
                             "long-form shape differs from its plain version")
    log(f"KF quantize_planes {tuple(long_spec.shape)} and KD "
        f"quantize_mel_plane {tuple(long_mel.shape)} (the long-form gathered "
        f"shapes): bit-exact")

    prefix = istft._window_table(win, hop)[1]
    spec_c = torch.complex(re, im)
    return {
        "quantize_planes (long form)": dict(
            kernel=lambda: quantize.quantize_planes(long_spec, 255),
            plain=lambda: quantize.quantize_planes_plain(long_spec, 255),
            work=(nbytes(long_spec, *long_p), 6.0 * long_spec.numel()),
            library=None),
        "quantize_mel_plane (long form)": dict(
            kernel=lambda: quantize.quantize_mel_plane(long_mel),
            plain=lambda: quantize.quantize_mel_plane_plain(long_mel),
            work=(nbytes(long_mel, *long_m), 6.0 * long_mel.numel()),
            library=None),
        "dequantize_raw": dict(
            kernel=lambda: quantize.dequantize_raw(planes, maxs, mins, 255),
            plain=lambda: quantize.dequantize_raw_plain(planes, maxs, mins,
                                                        255),
            work=(nbytes(planes, maxs, mins, spec), 4.0 * planes.numel()),
            library=None),
        "irfft_window_masked": dict(
            kernel=lambda: istft.launch_irfft_window(
                istft.MODE_SPEC, spec, (), n, f_loc, nf, win, (1,),
                real_frames=real),
            plain=lambda: istft.irfft_window_plain(
                *phase_ops.grow_half_planes(spec, n // 2), n, win, real),
            work=(nbytes(spec, win, fw_last),
                  real * (fft_ops(n) + n) + 3.0 * spec.numel()),
            library=lambda: torch.fft.irfft(spec_c, n=n)),
        "shard_epilogue": dict(
            kernel=lambda: istft.shard_epilogue(sig_ext, recv, chunk,
                                                pcm16=True, **decode),
            plain=lambda: istft.shard_epilogue_plain(sig_ext, recv, chunk,
                                                     pcm16=True, **decode),
            work=(nbytes(sig_ext, recv, prefix) + 2.0 * chunk, 8.0 * chunk),
            library=None),
        # timed beside the rows above: KH's plain overlap-add at the shard
        # (276 MB read, 86 MB written), with F.fold's overlap-add of the same
        # frames, and KM's momentum step
        "overlap_normalize (shard overlap-add)": dict(
            kernel=lambda: istft.overlap_add(fw_last, hop),
            plain=lambda: istft.overlap_add_plain(fw_last, hop),
            work=(nbytes(fw_last, sig_ext),
                  float(sig_ext.numel()) * -(-n // hop)),
            library=lambda: torch.nn.functional.fold(
                fw_last.transpose(1, 2), (1, sig_ext.shape[-1]), (1, n),
                stride=(1, hop))),
        "shard_epilogue (momentum)": dict(
            kernel=lambda: istft.shard_epilogue(
                sig_ext, recv, chunk, t_prev=t_prev, momentum=0.99,
                extend=True),
            plain=lambda: istft.shard_epilogue_plain(
                sig_ext, recv, chunk, t_prev=t_prev, momentum=0.99,
                extend=True),
            work=(nbytes(sig_ext[:, :chunk], recv, t_prev) + 8.0 * chunk,
                  4.0 * chunk),
            library=None),
    }


def frame_peak_err(got: torch.Tensor, want: torch.Tensor,
                   peak: torch.Tensor) -> tuple[float, float]:
    """(max |got - want| / the frame's peak, max |got - want|)."""
    d = (got.double() - want.double()).abs()
    return float((d / peak.clamp_min(1e-30)).max()), float(d.max())


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest relative L2 distance of a frame (the last dimension)."""
    got, want = got.double(), want.double()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)
                  .clamp_min(1e-30)).max())


def dft_kernels(dev: torch.device, errs: dict, x: torch.Tensor,
                win: torch.Tensor, n: int, hop: int, mag: torch.Tensor,
                sig0: torch.Tensor) -> dict:
    """Phase 2f, K14: KN (planes, magnitudes, (imag, real) pairs and the
    Griffin-Lim projection) and KO, each mode against its plain version at
    the bench shape and at ragged shapes (n 4096, 3000, 512, 8192 and 2,
    signal and framed input, several leads): the bf16 mode within 2e-5 of
    each frame's peak of the bf16-operand plain version and within 1e-2 of
    torch.fft in float64, the float32 mode within 1e-5 of float64 (KB's
    bound); KO ignores imag(DC) and imag(Nyquist) and zeroes the frames past
    a real-frame count. Returns phase 4's closures and work counts."""
    from gomel_tpu_torch.ops import dft_mm
    from gomel_tpu_torch.ops.stft import frame_signal, hann_window

    f64 = torch.float64

    def forward_refs(xs, w, nn, hh):
        spec = torch.fft.rfft(frame_signal(xs.double(), nn, hh) * w.double(),
                              dim=-1)
        return spec.real, spec.imag

    def check(label, rel, limit):
        if not rel <= limit:
            raise AssertionError(f"{label}: {rel:.3e} of the frame peak, "
                                 f"bound {limit}")

    def forward_case(label, xs, w, nn, hh, kinds):
        """KN's epilogues ``kinds`` in both modes on (xs, w, nn, hh)."""
        re64, im64 = forward_refs(xs, w, nn, hh)
        peak = torch.sqrt(re64 * re64 + im64 * im64).amax(-1, keepdim=True)
        half = nn // 2 + 1
        first, count = 1, max(1, (nn // 2) * 3 // 4)
        want64 = {"planes": (re64, im64),
                  "mag": (torch.sqrt(re64 * re64 + im64 * im64),),
                  "pairs": (torch.stack([im64[..., first:first + count],
                                         re64[..., first:first + count]],
                                        -1),)}
        worst = {}
        for kind in kinds:
            kw = dict(first=first, count=count) if kind == "pairs" else {}
            pk = peak[..., None] if kind == "pairs" else peak
            for precision, mode in (("default", "bf16"), (None, "f32")):
                got = dft_mm._fwd(xs, nn, hh, w, precision, kind, **kw)
                got = got if isinstance(got, tuple) else (got,)
                r64 = max(frame_peak_err(g, r, pk)[0]
                          for g, r in zip(got, want64[kind]))
                if mode == "bf16":
                    plain = dft_mm.dft_fwd_plain(xs, nn, hh, w, kind=kind,
                                                 bf16_operands=True, **kw)
                    plain = plain if isinstance(plain, tuple) else (plain,)
                    pe = [frame_peak_err(g, r, pk) for g, r in zip(got, plain)]
                    rel = max(e[0] for e in pe)
                    errs["dft_fwd_bf16"] = max(errs.get("dft_fwd_bf16", 0.0),
                                               max(e[1] for e in pe))
                    check(f"KN bf16 {kind} {label} vs plain", rel, 2e-5)
                    check(f"KN bf16 {kind} {label} vs float64", r64, 1e-2)
                    worst[f"{kind} bf16"] = (rel, r64)
                else:
                    errs["dft_fwd_f32"] = max(
                        errs.get("dft_fwd_f32", 0.0),
                        max(frame_peak_err(g, r, pk)[1]
                            for g, r in zip(got, want64[kind])))
                    check(f"KN f32 {kind} {label} vs float64", r64, 1e-5)
                    worst[f"{kind} f32"] = (0.0, r64)
        torch.cuda.synchronize()
        log(f"KN {label} (rows {tuple(re64.shape[:-1])}, {half} bins): " +
            "; ".join(f"{k} {a:.2e} / {b:.2e}" if k.endswith("bf16") else
                      f"{k} {b:.2e}" for k, (a, b) in worst.items()) +
            " of the frame peak (bf16: vs its plain version, bound 2e-5 / "
            "vs float64, bound 1e-2; f32: vs float64, bound 1e-5)")
        return re64, im64

    def inverse_case(label, re64, im64, w, nn, real):
        """KO in both modes from float32 planes with imag(DC), imag(Nyquist)
        set, against float64 and its plain version."""
        re, im = re64.float(), im64.float().clone()
        im[..., 0], im[..., -1] = 3.0, -2.0
        im0 = im.clone()
        im0[..., 0] = im0[..., -1] = 0.0
        want = torch.fft.irfft(torch.complex(re.double(), im0.double()), n=nn,
                               dim=-1)
        peak = want.abs().amax(-1, keepdim=True)
        want = want * w.double()
        out = {}
        for precision, mode in (("default", "bf16"), ("highest", "f32")):
            got = dft_mm.istft_frames(re, im, nn, w, precision)
            same = dft_mm.istft_frames(re, im0, nn, w, precision)
            masked = dft_mm.istft_frames(re, im, nn, w, precision, real)
            r64, a64 = frame_peak_err(got, want, peak)
            if not (torch.equal(got, same) and torch.equal(
                    masked[..., :real, :], got[..., :real, :])
                    and not bool(masked[..., real:, :].any())):
                raise AssertionError(f"KO {mode} {label}: imag(DC/Nyquist) "
                                     f"not ignored or the real-frame count "
                                     f"not kept")
            if mode == "bf16":
                plain = dft_mm.dft_inv_plain(re, im, nn, w,
                                             bf16_operands=True)
                rel, a = frame_peak_err(got, plain, peak)
                errs["dft_inv_bf16"] = max(errs.get("dft_inv_bf16", 0.0), a)
                check(f"KO bf16 {label} vs plain", rel, 2e-5)
                check(f"KO bf16 {label} vs float64", r64, 1e-2)
                out[mode] = f"{rel:.2e} / {r64:.2e}"
            else:
                errs["dft_inv_f32"] = max(errs.get("dft_inv_f32", 0.0), a64)
                check(f"KO f32 {label} vs float64", r64, 1e-5)
                out[mode] = f"{r64:.2e}"
        torch.cuda.synchronize()
        log(f"KO {label}: bf16 {out['bf16']}, f32 {out['f32']} of the "
            f"unwindowed frame peak (bounds as KN); imag(DC), imag(Nyquist) "
            f"ignored, frames past {real} zero, the rest bit-equal")

    re64, im64 = forward_case(f"bench [{x.shape[0]}, {x.shape[1]}]", x, win,
                              n, hop, ("planes", "mag", "pairs"))
    inverse_case(f"bench [{x.shape[0]}, {re64.shape[1]} frames]", re64, im64,
                 win, n, re64.shape[1] // 2)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    for nn, hh, lead, framed in ((4096, 1280, (3,), False),
                                 (3000, 3000, (2, 5), True),
                                 (512, 100, (), False),
                                 (8192, 2048, (1,), False),
                                 (2, 1, (4,), False)):
        length = nn * 7 if framed else nn + hh * 9 + 11
        xs = torch.randn(lead + (length,), generator=g, device=dev)
        # the symmetric Hann window of 2 points is zero: take none there
        w = torch.tensor(hann_window(nn) if nn > 2 else np.ones(nn),
                         dtype=torch.float32, device=dev)
        label = f"n {nn} hop {hh} lead {lead} {'framed' if framed else 'signal'}"
        r, i = forward_case(label, xs, w, nn, hh,
                            ("planes", "mag", "pairs"))
        inverse_case(label, r, i, w, nn, r.shape[-2] - 1)

    # the projection epilogue at the bench shape: float32 planes (the final
    # iteration) against the bf16-operand plain version, bf16 planes (an
    # interior one) within one bf16 rounding of those
    yr, yi = dft_mm.gl_spectrum(sig0, mag, n, hop, win, "default", final=True)
    pr, pi = dft_mm.dft_fwd_plain(sig0, n, hop, win, kind="project", mag=mag,
                                  bf16_operands=True)
    lr, li = dft_mm.gl_spectrum(sig0, mag, n, hop, win, "default")
    torch.cuda.synchronize()
    proj = rel_l2(torch.cat([yr, yi], -1), torch.cat([pr, pi], -1))
    low = torch.cat([lr, li], -1).float()
    full = torch.cat([yr, yi], -1)
    one_rounding = bool(((low - full).abs() <= 2.0 ** -8 * full.abs()).all())
    log(f"KN projection epilogue {tuple(yr.shape)}: float32 planes vs the "
        f"bf16-operand plain version, relative L2 per frame max {proj:.3e} "
        f"(bound 1e-4); bf16 planes within one bf16 rounding: "
        f"{one_rounding}")
    if proj > 1e-4 or not one_rounding:
        raise AssertionError("KN projection epilogue outside its bound")
    # KO reads KN's bf16 planes (views of rows padded to 8 bins) in place;
    # a frame alone gives the batch's bits in each mode
    in_place = dft_mm.istft_frames(lr, li, n, win, "default")
    copied = dft_mm.istft_frames(lr.contiguous(), li.contiguous(), n, win,
                                 "default")
    alone = {}
    for precision, mode in (("default", "bf16"), (None, "f32")):
        br, bi = dft_mm.stft(sig0, n, hop, win, precision)
        f = br.shape[-2] // 3
        one = dft_mm.stft(sig0[1, f * hop:f * hop + n].contiguous(), n, n,
                          win, precision)
        frames_b = dft_mm.istft_frames(br, bi, n, win, precision)
        one_b = dft_mm.istft_frames(br[1, f:f + 1], bi[1, f:f + 1], n, win,
                                    precision)
        alone[mode] = (torch.equal(one[0][0], br[1, f])
                       and torch.equal(one[1][0], bi[1, f])
                       and torch.equal(one_b[0], frames_b[1, f]))
    torch.cuda.synchronize()
    log(f"KO on KN's padded bf16 planes in place, bit-equal to contiguous "
        f"copies: {torch.equal(in_place, copied)}; a frame alone bit-equal "
        f"to the batch's (KN, KO): {alone}")
    if not torch.equal(in_place, copied) or not all(alone.values()):
        raise AssertionError("KN/KO: padded planes or a frame alone differ")

    # phase 4: the main-path calls of each mode at the bench shape, with the
    # host window (a tensor window is copied to the host on every call,
    # which would stall the timed queue)
    win_np = hann_window(n)
    rows = yr.shape[0] * yr.shape[1]
    half = n // 2 + 1
    frames32 = (frame_signal(sig0, n, hop) * win).reshape(rows, n)
    frames16 = frames32.to(torch.bfloat16)
    w_f16 = dft_mm._weights("fwd", n, win_np, torch.float32, dev).to(
        torch.bfloat16)
    w_f32 = dft_mm._weights("fwd", n, win_np, torch.float32, dev)
    z32 = torch.cat([yr, yi], -1).reshape(rows, 2 * half)
    z16 = z32.to(torch.bfloat16)
    w_i16 = dft_mm._weights("inv", n, win_np, torch.float32, dev).to(
        torch.bfloat16)
    w_i32 = dft_mm._weights("inv", n, win_np, torch.float32, dev)
    # the second yardstick: the same products with the 4098-wide dimension
    # padded with zeros to an aligned width (4224 forward columns, a
    # contraction of 4128), where cuBLAS may take faster kernels
    cols_a, depth_a = -(-2 * half // 128) * 128, -(-2 * half // 32) * 32
    w_f32a = torch.zeros((n, cols_a), device=dev)
    w_f32a[:, :2 * half] = w_f32
    z32a = torch.zeros((rows, depth_a), device=dev)
    z32a[:, :2 * half] = z32
    w_i32a = torch.zeros((depth_a, n), device=dev)
    w_i32a[:2 * half] = w_i32
    w_f16a, z16a, w_i16a = (t.to(torch.bfloat16)
                            for t in (w_f32a, z32a, w_i32a))
    products = 2.0 * rows * n * 2 * half
    sig_frames = nbytes(sig0)
    weights = float(n * 2 * half)     # each direction's weights, unpadded
    return {
        "dft_fwd_bf16": dict(
            kernel=lambda: dft_mm.gl_spectrum(sig0, mag, n, hop, win_np,
                                              "default"),
            plain=lambda: dft_mm.dft_fwd_plain(sig0, n, hop, win_np,
                                               kind="project", mag=mag,
                                               bf16_operands=True),
            work=(sig_frames + nbytes(mag) + 2.0 * weights
                  + 4.0 * rows * half, products, BF16_FLOP_S),
            library=lambda: torch.matmul(frames16, w_f16),
            aligned=lambda: torch.matmul(frames16, w_f16a)),
        "dft_fwd_f32": dict(
            kernel=lambda: dft_mm.stft(x, n, hop, win_np),
            plain=lambda: dft_mm.dft_fwd_plain(x, n, hop, win_np),
            work=(nbytes(x, yr, yi) + 4.0 * weights, products),
            library=lambda: torch.matmul(frames32, w_f32),
            aligned=lambda: torch.matmul(frames32, w_f32a)),
        "dft_inv_bf16": dict(
            kernel=lambda: dft_mm.istft_frames(lr, li, n, win_np, "default"),
            plain=lambda: dft_mm.dft_inv_plain(lr, li, n, win_np,
                                               bf16_operands=True),
            work=(4.0 * rows * half + 2.0 * weights + 4.0 * rows * n,
                  products, BF16_FLOP_S),
            library=lambda: torch.matmul(z16, w_i16),
            aligned=lambda: torch.matmul(z16a, w_i16a)),
        "dft_inv_f32": dict(
            kernel=lambda: dft_mm.istft_frames(yr, yi, n, win_np),
            plain=lambda: dft_mm.dft_inv_plain(yr, yi, n, win_np),
            work=(nbytes(yr, yi) + 4.0 * weights + 4.0 * rows * n, products),
            library=lambda: torch.matmul(z32, w_i32),
            aligned=lambda: torch.matmul(z32a, w_i32a)),
    }


def fft_size_checks(dev: torch.device, x: torch.Tensor, n: int, hop: int,
                    nf: int, routed: bool) -> dict:
    """Phase 2f, K19's repair: every FFT kernel site at a size n whose half
    is not a power of two, on the route fftbackend.resolve picks: n = 3000
    (24 x 125 on the TPU's split) runs the kernels' mixed-radix register
    core, so their tallies move and the xla route's does not; n = 514
    (2 x 257, no split: the TPU's library FFT) goes by the xla route
    (``routed``), the other way round. KB's and KE's sites within 1e-5 of
    each frame's peak of their plain versions, KG's (planes with and
    without a real-frame count, the spectrogram, uint8 and uint16 planes
    with and without IHS, the masked synthesis) within 1e-5, KJ's within
    1e-4 relative L2 per frame.
    Returns phase 4's rows of the size (with KE's and KG's where the hand
    kernels run it), each with its work for the bound."""
    from gomel_tpu_torch.ops import (fftbackend, griffinlim, istft,
                                     phase_ops, rfft_mag)
    from gomel_tpu_torch.ops.stft import frame_signal, hann_window

    win = torch.tensor(hann_window(n), dtype=torch.float32, device=dev)
    hand = (rfft_mag.KERNEL, rfft_mag.PLANES_KERNEL, istft.SYNTH_KERNEL,
            istft.SYNTH_MASKED_KERNEL, griffinlim.PROJECT_KERNEL)
    before = [k.launches for k in hand]
    route0 = fftbackend.XLA_ROUTE.launches
    worst = {}
    what = "xla route" if routed else "mixed radix"

    def peak_check(label, got, want, dims=(-1,)):
        rel = frame_peak_err(got, want, want.double().abs().amax(
            dim=dims, keepdim=True))[0]
        worst[label] = rel
        if rel > 1e-5:
            raise AssertionError(f"{what} n {n} {label}: {rel:.3e} > 1e-5")

    mags = rfft_mag.stft_mag(x, win, n, hop)
    peak_check("KB stft_mag", mags, rfft_mag.stft_mag_plain(x, win, n, hop))
    spec = phase_ops.phase_encode_batch(x, nf, n, hop, win)
    spec_ref = rfft_mag.stft_planes_plain(x, win, n, hop, 1, nf)
    peak_check("KE phase_encode", spec, spec_ref, (-2, -1))
    re, im = phase_ops.grow_half_planes(spec_ref, n // 2)
    frames = spec.shape[1]
    for real in (None, frames // 3):
        peak_check(f"KG planes, real frames {real}",
                   istft.irfft_window(re, im, n, win, real),
                   istft.irfft_window_plain(re, im, n, win, real))
    peak_check("KG spectrogram (phase_decode)",
               phase_ops.phase_decode(spec_ref, n, hop, 0.0, win),
               phase_ops.phase_decode_plain(spec_ref, n, hop, 0.0, win))
    peak_check("KG masked synthesis",
               phase_ops.phase_synthesize(spec_ref, n, hop, win, frames - 5),
               phase_ops.phase_synthesize(spec_ref.cpu(), n, hop, win.cpu(),
                                          frames - 5).to(dev))
    rng = np.random.default_rng(SEED + 8)
    mx = torch.tensor([[3.0, 2.5], [1.0, 4.0]], device=dev)
    mn = torch.tensor([[-2.0, -3.5], [-1.0, 0.5]], device=dev)
    for max_val, dt in ((255, np.uint8), (65535, np.uint16)):
        planes = torch.from_numpy(rng.integers(
            0, max_val + 1, (2, nf, frames, 2), dtype=dt)).to(dev)
        for ihs in (0, 2):
            peak_check(f"KG uint{8 if max_val == 255 else 16} ihs {ihs}",
                       phase_ops.dequantize_decode(planes, mx, mn, max_val,
                                                   ihs, n, hop, 0.0, win),
                       phase_ops.dequantize_decode_plain(
                           planes, mx, mn, max_val, ihs, n, hop, 0.0, win))
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    sig = torch.rand((x.shape[0], n + (frames - 1) * hop), generator=g,
                     device=dev)
    mag = mags * 0.5
    fw = griffinlim.gl_project(sig, mag, win, n, hop)
    kj = rel_l2(fw, griffinlim.gl_project_plain(sig, mag, win, n, hop))
    torch.cuda.synchronize()
    moved = sum(k.launches - b for k, b in zip(hand, before))
    routed_calls = fftbackend.XLA_ROUTE.launches - route0
    log(f"{what}, n {n} hop {hop}, [{x.shape[0]}, {frames} frames]: " +
        ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) +
        f" of the frame peak (bound 1e-5); KJ gl_project relative L2 per "
        f"frame {kj:.2e} (bound 1e-4); xla route calls {routed_calls}, FFT "
        f"kernel launches {moved}")
    want = (11, 0) if routed else (0, 11)
    if kj > 1e-4 or (routed_calls, moved) != want:
        raise AssertionError(f"{what} at n {n}: KJ {kj:.3e}, (route calls, "
                             f"kernel launches) {(routed_calls, moved)}, "
                             f"expected {want}")
    frames_c = (frame_signal(x, n, hop) * win).contiguous()
    spec_c = torch.complex(re, im)
    f2 = x.shape[0] * frames
    fw = griffinlim.gl_project_plain(sig, mag, win, n, hop)
    synth = istft.irfft_window_plain(re, im, n, win)
    rows = {
        f"{what} stft_mag (KB's site)": dict(
            n=n, kernel=lambda: rfft_mag.stft_mag(x, win, n, hop),
            plain=lambda: rfft_mag.stft_mag_plain(x, win, n, hop),
            library=lambda: torch.fft.rfft(frames_c, dim=-1),
            work=(nbytes(x, win, mags),
                  f2 * (fft_ops(n) + n + 3 * (n // 2 + 1)))),
        f"{what} gl_project (KJ's site)": dict(
            n=n, kernel=lambda: griffinlim.gl_project(sig, mag, win, n, hop),
            plain=lambda: griffinlim.gl_project_plain(sig, mag, win, n, hop),
            library=lambda: torch.fft.irfft(spec_c, n=n),
            work=(nbytes(sig, mag, win, fw),
                  f2 * (2 * fft_ops(n) + 2 * n + 12 * (n // 2 + 1)))),
    }
    if not routed:
        rows[f"{what} phase_encode (KE's site)"] = dict(
            n=n, kernel=lambda: phase_ops.phase_encode_batch(x, nf, n, hop,
                                                             win),
            plain=lambda: rfft_mag.stft_planes_plain(x, win, n, hop, 1, nf),
            library=lambda: torch.fft.rfft(frames_c, dim=-1),
            work=(nbytes(x, win, spec), f2 * (fft_ops(n) + n)))
        rows[f"{what} irfft_window (KG's site)"] = dict(
            n=n, kernel=lambda: istft.irfft_window(re, im, n, win),
            plain=lambda: istft.irfft_window_plain(re, im, n, win),
            library=lambda: torch.fft.irfft(spec_c, n=n),
            work=(nbytes(re, im, win, synth), f2 * (fft_ops(n) + n)))
    return rows


def fwd_core_checks(dev: torch.device, x: torch.Tensor, win: torch.Tensor,
                    n_fft: int, hop: int, nf: int) -> None:
    """Phase 2, KB and KE's register-resident core at the card tests'
    shapes: every power-of-two n from 4 to 16384 (3 rows, a frame count no
    multiple of the frames a block) within 1e-5 of each frame's peak of
    float64; the scalar-load route (hop 1279; a row length 3 past a
    multiple of 4; a base 4 bytes off 16) bit-equal to the float4 route on
    the same frames laid out one after another; KE's first/count at bin 0,
    the Nyquist bin and every bin; bench frames computed alone bit-equal to
    themselves inside the 2 x 1122-frame batch."""
    from gomel_tpu_torch.ops import rfft_mag
    from gomel_tpu_torch.ops.stft import frame_signal, hann_window

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    worst = 0.0
    for n in (4 << i for i in range(13)):
        plan = rfft_mag.fwd_plan(n)
        h = max(1, n // 4)
        frames = 2 * plan.frames_per_block + 3
        xs = torch.randn((3, n + (frames - 1) * h + 1), generator=g,
                         device=dev)
        w = torch.tensor(hann_window(n), dtype=torch.float32, device=dev)
        x64, w64 = xs.double(), w.double()
        full = rfft_mag.stft_planes_plain(x64, w64, n, h, 0, n // 2 + 1)
        peak = full.abs().amax(dim=(-2, -1), keepdim=True)
        checks = [(rfft_mag.stft_mag(xs, w, n, h),
                   rfft_mag.stft_mag_plain(x64, w64, n, h))]
        for first, count in ((1, n // 2), (0, 1), (n // 2, 1),
                             (0, n // 2 + 1)):
            checks.append((rfft_mag.stft_planes(xs, w, n, h, first, count),
                           full[..., first:first + count, :]))
        for got, want in checks:
            p = peak if got.dim() == 4 else want.amax(dim=-1, keepdim=True)
            rel = float(((got.double() - want).abs() / p).max())
            worst = max(worst, rel)
            if rel > 1e-5:
                raise AssertionError(f"register core n {n}: {rel:.3e} of the "
                                     f"frame peak > 1e-5")
    routes = 0
    for h, extra in ((1279, 0), (1280, 3)):
        xs = torch.randn((2, n_fft + 6 * h + extra), generator=g, device=dev)
        laid = frame_signal(xs, n_fft, h).contiguous().reshape(2, -1)
        off = torch.cat([torch.zeros(1, device=dev), laid.reshape(-1)])[1:]
        same = (torch.equal(rfft_mag.stft_mag(xs, win, n_fft, h),
                            rfft_mag.stft_mag(laid, win, n_fft, n_fft))
                and torch.equal(
                    rfft_mag.stft_planes(xs, win, n_fft, h, 1, nf),
                    rfft_mag.stft_planes(laid, win, n_fft, n_fft, 1, nf))
                and torch.equal(rfft_mag.stft_mag(off, win, n_fft, n_fft),
                                rfft_mag.stft_mag(laid.reshape(-1), win,
                                                  n_fft, n_fft)))
        if not same:
            raise AssertionError(f"register core: the scalar route (hop {h}, "
                                 f"row + {extra}) differs from the float4 "
                                 f"route")
        routes += 1
    mags = rfft_mag.stft_mag(x, win, n_fft, hop)
    pairs = rfft_mag.stft_planes(x, win, n_fft, hop, 1, nf)
    frames = mags.shape[1]
    for b, f in ((0, 0), (1, 700), (1, frames - 1)):
        one = x[b, f * hop:f * hop + n_fft].contiguous()
        if not (torch.equal(rfft_mag.stft_mag(one, win, n_fft, hop)[0],
                            mags[b, f])
                and torch.equal(rfft_mag.stft_planes(one, win, n_fft, hop, 1,
                                                     nf)[0], pairs[b, f])):
            raise AssertionError(f"register core: frame ({b}, {f}) alone "
                                 f"differs from it in the batch")
    torch.cuda.synchronize()
    log(f"KB/KE register core: n 4..16384 (3 rows, frames past a block "
        f"multiple; KE bins 1..n/2, 0, n/2 and all) worst {worst:.3e} of the "
        f"frame peak vs float64 (bound 1e-5); scalar route bit-equal to "
        f"float4 route ({routes} shapes + a 4-byte offset base); 3 bench "
        f"frames alone bit-equal to the {mags.shape[0] * frames}-frame batch")


def inv_core_checks(dev: torch.device, x: torch.Tensor, win: torch.Tensor,
                    n_fft: int, hop: int) -> None:
    """Phase 2, KG and KJ's register-resident inverse at the card tests'
    shapes: every power-of-two n from 4 to 16384 (3 rows, a frame count no
    multiple of the frames a block), KG on planes with and without the
    window within 1e-5 of each unwindowed frame's peak of float64, with
    real-frame counts 0, partial and all (masked frames exact zeros, the
    rest bit-equal to the unmasked launch), KJ within 1e-4 relative L2 a
    frame of float64; bench frames computed alone bit-equal to themselves
    inside the 2 x 1122-frame batch (KG planes, KJ)."""
    from gomel_tpu_torch.ops import griffinlim, istft, rfft_mag
    from gomel_tpu_torch.ops.stft import hann_window

    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    worst_g = worst_j = 0.0
    for n in (4 << i for i in range(13)):
        plan = rfft_mag.fwd_plan(n)
        frames = 2 * plan.frames_per_block + 3
        re, im = (torch.randn((3, frames, n // 2 + 1), generator=g,
                              device=dev) for _ in range(2))
        w = torch.tensor(hann_window(n), dtype=torch.float32, device=dev)
        ref = istft.irfft_window_plain(re.double(), im.double(), n, None)
        peak = ref.abs().amax(-1, keepdim=True)
        for wc in (None, w):
            out = istft.irfft_window(re, im, n, wc)
            want = ref if wc is None else ref * wc.double()
            rel = frame_peak_err(out, want, peak)[0]
            worst_g = max(worst_g, rel)
            ok = rel <= 1e-5
            for real in (0, frames // 2, frames):
                got = istft.irfft_window(re, im, n, wc, real)
                ok = ok and torch.equal(got[:, :real], out[:, :real]) and not \
                    bool(got[:, real:].any())
            if not ok:
                raise AssertionError(f"inverse core KG n {n}: {rel:.3e} of the "
                                     f"frame peak, or a masked launch wrong")
        h = max(1, n // 4)
        sig = torch.rand((3, n + (frames - 1) * h), generator=g, device=dev)
        sig[0, :n] = 0.0
        mag = torch.rand((3, frames, n // 2 + 1), generator=g, device=dev) * 3
        rel = rel_l2(griffinlim.gl_project(sig, mag, w, n, h),
                     griffinlim.gl_project_plain(sig.double(), mag.double(),
                                                 w.double(), n, h))
        worst_j = max(worst_j, rel)
        if rel > 1e-4:
            raise AssertionError(f"inverse core KJ n {n}: relative L2 "
                                 f"{rel:.3e} > 1e-4")
    frames = (x.shape[1] - n_fft) // hop + 1
    x = x[:, :n_fft + (frames - 1) * hop].contiguous()
    re, im = (torch.randn((2, frames, n_fft // 2 + 1), generator=g,
                          device=dev) for _ in range(2))
    mag = torch.rand((2, frames, n_fft // 2 + 1), generator=g, device=dev)
    synth = istft.irfft_window(re, im, n_fft, win)
    proj = griffinlim.gl_project(x, mag, win, n_fft, hop)
    for b, f in ((0, 0), (1, 700), (1, frames - 1)):
        one = x[b, f * hop:f * hop + n_fft]
        if not (torch.equal(istft.irfft_window(re[b, f:f + 1], im[b, f:f + 1],
                                               n_fft, win)[0], synth[b, f])
                and torch.equal(griffinlim.gl_project(
                    one, mag[b, f:f + 1], win, n_fft, hop)[0], proj[b, f])):
            raise AssertionError(f"inverse core: frame ({b}, {f}) alone "
                                 f"differs from it in the batch")
    torch.cuda.synchronize()
    log(f"KG/KJ register inverse core: n 4..16384 (3 rows, frames past a "
        f"block multiple; KG planes with and without the window, real frames "
        f"0, half and all) KG worst {worst_g:.3e} of the frame peak vs "
        f"float64 (bound 1e-5), KJ worst relative L2 {worst_j:.3e} (bound "
        f"1e-4); masked frames zero, the rest bit-equal to the unmasked "
        f"launch; 3 bench frames alone bit-equal to the "
        f"{2 * frames}-frame batch (KG, KJ)")


# the sizes of the mixed-radix register core's sweep: those of its CPU replay
# (tests/test_torch_fft_mixed_plan.py), among them a prime m (254) and two
# generic primes (4094 = 2 x 23 x 89)
MIXED_SIZES = (6, 254, 400, 960, 1200, 2400, 3000, 4094, 6000, 12000)


def mixed_core_checks(dev: torch.device) -> None:
    """Phase 2, the mixed-radix register core (csrc/fft_core.cuh,
    fwd_frame_mixed and inv_frame_mixed) of KB, KE, KG and KJ at
    MIXED_SIZES: 3 rows, a frame count no multiple of the frames a block,
    the last row quiet; KB within 1e-5 of each frame's peak of float64 with
    and without the window, KE's bins 1..nf with the window and 0..n/2 of
    framed input without within 1e-5, KG on planes, the spectrogram and
    uint8 and uint16 PNG planes (IHS 2) within 1e-5 of each frame's peak and,
    with a real-frame count whose live frames start a block's second row,
    its masked frames exact zeros and the rest bit-equal to the unmasked
    launch; KJ within 1e-4 relative L2 a frame of float64 (row 0's first
    frame silent); KB's and KE's scalar-load route (the same rows from a
    base 4 bytes off 16) bit-equal to their vector route; a frame alone
    bit-equal to itself inside the batch (KB, KE, KG and KJ)."""
    from gomel_tpu_torch.ops import (griffinlim, istft, phase_ops, quantize,
                                     rfft_mag)
    from gomel_tpu_torch.ops.stft import frame_signal, hann_window

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    rng = np.random.default_rng(SEED + 11)
    worst_b = worst_e = worst_g = worst_j = 0.0
    plans = []
    for n in MIXED_SIZES:
        m = n // 2
        plan = rfft_mag.mixed_plan(n)
        plans.append(f"{n}: {'x'.join(map(str, plan.radices))}")
        frames = 2 * plan.frames_per_block + 3
        h = max(4, n // 16 * 4)
        nf = max(1, m * 768 // 1000)
        xs = torch.randn((3, n + (frames - 1) * h), generator=g, device=dev)
        xs[2] *= 1e-3
        w = torch.tensor(hann_window(n), dtype=torch.float32, device=dev)
        mags = {}
        for wc in (w, None):
            mags[wc is None] = rfft_mag.stft_mag(xs, wc, n, h)
            want = rfft_mag.stft_mag_plain(
                xs.double(), None if wc is None else wc.double(), n, h)
            rel = frame_peak_err(mags[wc is None], want,
                                 want.amax(-1, keepdim=True))[0]
            worst_b = max(worst_b, rel)
            if rel > 1e-5:
                raise AssertionError(f"mixed core KB n {n}: {rel:.3e} of the "
                                     f"frame peak > 1e-5")
        pairs = rfft_mag.stft_planes(xs, w, n, h, 1, nf)
        laid = frame_signal(xs, n, h).contiguous().reshape(3, -1)
        for got, (xr, wr, hr, first, count) in (
                (pairs, (xs, w, h, 1, nf)),
                (rfft_mag.stft_planes(laid, None, n, n, 0, m + 1),
                 (laid, None, n, 0, m + 1))):
            full = rfft_mag.stft_planes_plain(
                xr.double(), None if wr is None else wr.double(), n, hr, 0,
                m + 1)
            rel = frame_peak_err(got, full[..., first:first + count, :],
                                 full.abs().amax((-2, -1), keepdim=True))[0]
            worst_e = max(worst_e, rel)
            if rel > 1e-5:
                raise AssertionError(f"mixed core KE n {n} bins {first}.."
                                     f"{first + count - 1}: {rel:.3e} of the "
                                     f"frame peak > 1e-5")
        off = torch.cat([torch.zeros(1, device=dev), xs.reshape(-1)])[1:]
        one = xs[1, h:h + n].contiguous()
        same = (torch.equal(rfft_mag.stft_mag(off.reshape(xs.shape), w, n, h),
                            mags[False])
                and torch.equal(rfft_mag.stft_mag(one, w, n, h)[0],
                                mags[False][1, 1])
                and torch.equal(rfft_mag.stft_planes(off.reshape(xs.shape), w,
                                                     n, h, 1, nf), pairs)
                and torch.equal(rfft_mag.stft_planes(one, w, n, h, 1, nf)[0],
                                pairs[1, 1]))
        sig = torch.rand((3, n + (frames - 1) * h), generator=g, device=dev)
        sig[0, :n] = 0.0
        mag = torch.rand((3, frames, m + 1), generator=g, device=dev) * 3
        proj = griffinlim.gl_project(sig, mag, w, n, h)
        rel = rel_l2(proj, griffinlim.gl_project_plain(
            sig.double(), mag.double(), w.double(), n, h))
        worst_j = max(worst_j, rel)
        alone = griffinlim.gl_project(sig[2, 2 * h:2 * h + n].contiguous(),
                                      mag[2, 2:3], w, n, h)[0]
        if rel > 1e-4 or not same or not torch.equal(alone, proj[2, 2]):
            raise AssertionError(f"mixed core n {n}: KJ relative L2 "
                                 f"{rel:.3e} (bound 1e-4), or the scalar "
                                 f"route or a frame alone differs")
        # KG: each source mode, unmasked and with a real-frame count
        re, im = (torch.randn((3, frames, m + 1), generator=g, device=dev)
                  for _ in range(2))
        spec = torch.randn((3, frames, nf, 2), generator=g, device=dev) * 20
        mx = torch.tensor([[3.0, 2.5], [1.0, 4.0], [2.0, 2.0]], device=dev)
        mn = torch.tensor([[-2.0, -3.5], [-1.0, 0.5], [-1.0, -1.0]],
                          device=dev)
        sources = [(istft.MODE_PLANES, re, (im,), 0.0, 0, (re, im)),
                   (istft.MODE_SPEC, spec, (), 0.0, 0,
                    phase_ops.grow_half_planes(spec.double(), m))]
        for mode, dt, max_val, ihs in (
                (istft.MODE_QUANT8, np.uint8, 255, 0),
                (istft.MODE_QUANT16, np.uint16, 65535, 2)):
            planes = torch.from_numpy(rng.integers(
                0, max_val + 1, (3, nf, frames, 2), dtype=dt)).to(dev)
            deq = quantize.dequantize_planes_batch(planes, mx, mn, max_val,
                                                   ihs)
            sources.append((mode, planes, (mx, mn), float(max_val), ihs,
                            phase_ops.grow_half_planes(deq.double(), m)))
        real = 1 if plan.frames_per_block > 1 else frames // 2
        for mode, src, aux, max_val, ihs, (re64, im64) in sources:
            args = (mode, src, aux, n, frames, nf, w, (3,), max_val, ihs)
            out = istft.launch_irfft_window(*args)
            masked = istft.launch_irfft_window(*args, real_frames=real)
            want = istft.irfft_window_plain(re64.double(), im64.double(), n,
                                            None)
            rel = frame_peak_err(out, want * w.double(),
                                 want.abs().amax(-1, keepdim=True))[0]
            worst_g = max(worst_g, rel)
            if (rel > 1e-5 or not torch.equal(masked[:, :real],
                                              out[:, :real])
                    or bool(masked[:, real:].any())):
                raise AssertionError(f"mixed core KG n {n} mode {mode}: "
                                     f"{rel:.3e} of the frame peak (bound "
                                     f"1e-5), or a masked launch wrong")
            if mode == istft.MODE_PLANES and not torch.equal(
                    istft.irfft_window(re[2, 2:3], im[2, 2:3], n, w)[0],
                    out[2, 2]):
                raise AssertionError(f"mixed core KG n {n}: a frame alone "
                                     f"differs from it in the batch")
    torch.cuda.synchronize()
    log(f"KB/KE/KG/KJ mixed-radix register core: n {', '.join(plans)} (3 "
        f"rows, frames past a block multiple): KB worst {worst_b:.3e}, KE "
        f"{worst_e:.3e}, KG (planes, spectrogram, uint8, uint16 IHS 2) "
        f"{worst_g:.3e} of the frame peak vs float64 (bound 1e-5), KJ worst "
        f"relative L2 {worst_j:.3e} (bound 1e-4); KG's masked frames zero "
        f"and the rest bit-equal to the unmasked launch; KB's and KE's "
        f"scalar route bit-equal to their vector route; a frame alone "
        f"bit-equal to the batch's (KB, KE, KG, KJ)")


def new_paths(tmp: str, drive, dev: torch.device, wav: str,
              logmel: torch.Tensor, inv: torch.Tensor, sig0: torch.Tensor,
              win: torch.Tensor, x: torch.Tensor, nf: int) -> None:
    """Phase 3f, the paths this slice adds: mel_decode(fft_backend="mm") at
    the bench shape (GL-2 and recommended_gl(64)) against the exact route
    from the same start, with KN and KO on each interior iteration and
    KN + KG + KK on the final one; the phase codec with fft_backend="mm"
    (KN and KO in float32) against the exact route; resolut 3000 (the FFT
    kernels' mixed radix) through tomel and towav and through Phase, and
    resolut 514 (the xla route) through Phase, on the card against the
    CPU."""
    from gomel_tpu_torch import Phase, PhaseConfig
    from gomel_tpu_torch.cli.tools import tomel, towav
    from gomel_tpu_torch.ops import griffinlim, mel_ops, phase_ops
    from gomel_tpu_torch.utils.metrics import spectral_convergence

    n_fft, hop = 4096, 1280
    target = mel_ops.mel_to_magnitudes_plain(logmel, inv)
    mom24, it24 = griffinlim.recommended_gl(64)
    for label, n_iter, mom in (("GL-2", 2, 0.0),
                               (f"recommended_gl(64) = momentum {mom24} x "
                                f"{it24}", it24, mom24)):
        out = {}
        for backend in ("mm", "auto"):
            must = (("dft_fwd_bf16", "dft_inv_bf16", "irfft_window",
                     "gl_overlap_add") if backend == "mm"
                    else ("gl_project", "gl_overlap_add"))

            def run(backend=backend):
                out[backend] = mel_ops.mel_decode(
                    logmel, n_fft, hop, inv, n_iter, window=win,
                    fft_backend=backend, momentum=mom, init=sig0)
                return 0
            _, counts = drive(f"mel_decode(fft_backend={backend!r}) {label}, "
                              f"[{logmel.shape[0]}, {logmel.shape[1]} "
                              f"frames]", run, must)
            want = ({"mel_to_magnitudes": 1, "dft_fwd_bf16": n_iter,
                     "dft_inv_bf16": n_iter - 1, "irfft_window": 1,
                     "gl_overlap_add": n_iter, "gl_project": 0}
                    if backend == "mm" else
                    {"mel_to_magnitudes": 1, "gl_project": n_iter,
                     "gl_overlap_add": n_iter, "dft_fwd_bf16": 0})
            if {k: counts.get(k, 0) for k in want} != want:
                raise AssertionError(f"mel_decode {backend} {label} "
                                     f"launches {counts}, expected {want}")
        sc_mm = spectral_convergence(out["mm"], target, n_fft, hop, win)
        sc_ex = spectral_convergence(out["auto"], target, n_fft, hop, win)
        log(f"  mel_decode {label} from one start: spectral convergence mm "
            f"{sc_mm:.6f}, exact {sc_ex:.6f} (bound: mm <= 1.05 x exact + "
            f"1e-3 = {1.05 * sc_ex + 1e-3:.6f})")
        if not (math.isfinite(sc_mm) and sc_mm <= 1.05 * sc_ex + 1e-3):
            raise AssertionError(f"mel_decode mm {label}: spectral "
                                 f"convergence {sc_mm} against {sc_ex}")

    res = {}

    def phase_mm():
        res["spec"] = phase_ops.phase_encode_batch(x, nf, n_fft, hop, win,
                                                   fft_backend="mm")
        res["sig"] = phase_ops.phase_decode(res["spec"], n_fft, hop, 0.0, win,
                                            fft_backend="mm")
        return 0
    drive("phase_encode_batch + phase_decode (fft_backend='mm'), bench shape",
          phase_mm, ("dft_fwd_f32", "dft_inv_f32", "overlap_normalize"))
    spec = phase_ops.phase_encode_batch(x, nf, n_fft, hop, win)
    sig = phase_ops.phase_decode(res["spec"], n_fft, hop, 0.0, win)
    rel_e = frame_peak_err(res["spec"], spec, spec.abs().amax(
        dim=(-2, -1), keepdim=True))[0]
    rel_d = float((res["sig"] - sig).abs().max() / sig.abs().max())
    log(f"  phase codec with mm (KN, KO float32) vs the exact route (KE, KG): "
        f"encode {rel_e:.3e} of the frame peak, decode {rel_d:.3e} of the "
        f"peak (bounds 1e-5)")
    if rel_e > 1e-5 or rel_d > 1e-5:
        raise AssertionError("the mm phase codec is outside its bound")

    def path(name):
        return os.path.join(tmp, "r_" + name)

    m_args = ["--resolut", "3000"]
    for device in ("cuda", "cpu"):
        fn = lambda d=device: tomel([wav, "--device", d, "-o",
                                     path(f"{d}.png")] + m_args)
        if device == "cuda":
            drive("tomel --resolut 3000 --device cuda", fn,
                  ("pcm16_ingest", "stft_mag", "mel_log",
                   "quantize_mel_plane"))
        elif fn() != 0:
            raise AssertionError("tomel --resolut 3000 on cpu failed")
    w = pngs_near(path("cuda.png"), path("cpu.png"), True)
    log(f"  tomel --resolut 3000 PNG, cuda vs cpu: max step {w[0]}, flip rate "
        f"{w[1]:.2e} (bounds 1, 2e-3), metadata equal")
    for device in ("cuda", "cpu"):
        fn = lambda d=device: towav([path("cuda.png"), str(SAMPLE_RATE),
                                     "--seed", "1", "--device", d, "-o",
                                     path(f"{d}.wav")] + m_args)
        if device == "cuda":
            drive("towav --resolut 3000 --device cuda", fn,
                  ("mel_to_magnitudes", "gl_project", "gl_overlap_add"))
        elif fn() != 0:
            raise AssertionError("towav --resolut 3000 on cpu failed")
    w = wavs_near(path("cuda.wav"), path("cpu.wav"), 2)
    log(f"  towav --resolut 3000 WAV of the same PNG, cuda vs cpu: max {w[0]} "
        f"LSB, differing {w[1]:.2e} (bounds 2, 5e-2)")

    # resolut 3000 on the FFT kernels' mixed radix, resolut 514 (2 x 257,
    # no n1 * n2 split) on the xla route
    for n, nf, hop, fft, ifft, routed in (
            (3000, 1152, 1280, "phase_encode", "irfft_window", False),
            (514, 200, 128, "xla_route", "xla_route", True)):
        pcfg = PhaseConfig.cli_default(resolut=n, num_freqs=nf, window=hop)
        runs = (("to_phase_wav", lambda p: p.to_phase_wav(wav, path(
                    f"{n}_{p.device.type}_p.png")),
                 ("pcm16_ingest", fft, "quantize_planes")),
                ("to_wav_png", lambda p: p.to_wav_png(
                    path(f"{n}_cuda_p.png"),
                    path(f"{n}_{p.device.type}_p.wav")),
                 (ifft, "overlap_normalize")))
        for label, call, must in runs:
            for device in ("cuda", "cpu"):
                codec = Phase(pcfg, device_quantize=True, device=device)
                if device == "cuda":
                    drive(f"Phase(resolut={n}).{label} --device cuda",
                          lambda: (call(codec), 0)[1], must, route_ok=routed)
                else:
                    call(codec)
        w = pngs_near(path(f"{n}_cuda_p.png"), path(f"{n}_cpu_p.png"), False)
        log(f"  Phase(resolut={n}) PNG, cuda vs cpu: max step {w[0]}, flip "
            f"rate {w[1]:.2e} (bounds 1, 2e-3), metadata equal")
        w = wavs_near(path(f"{n}_cuda_p.wav"), path(f"{n}_cpu_p.wav"), 1)
        log(f"  Phase(resolut={n}) WAV of the same PNG, cuda vs cpu: max "
            f"{w[0]} LSB, differing {w[1]:.2e} (bounds 1, 5e-2)")


def long_pcm(n: int, dev: torch.device) -> np.ndarray:
    """int16 [n] at 48 kHz, made on the card from the seed: four tones
    whose levels drift slowly, light noise and a quiet stretch."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    f64 = torch.float64
    t = torch.arange(n, device=dev, dtype=f64) / SAMPLE_RATE
    f = torch.rand(4, generator=g, device=dev, dtype=f64) * 3920.0 + 80.0
    a = torch.rand(4, generator=g, device=dev, dtype=f64) * 0.15 + 0.02
    x = 0.01 * torch.randn(n, generator=g, device=dev, dtype=f64)
    for k in range(4):
        x += a[k] * (1.0 + 0.5 * torch.sin(2 * math.pi * t / (97.0 + 31 * k))
                     ) * torch.sin(2 * math.pi * f[k] * t)
    x[n // 3: n // 3 + SAMPLE_RATE] *= 1e-3
    pcm = torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(torch.int16)
    return pcm.cpu().numpy()


def longform_split(lp, lm, wav: str, pngs: dict, outs: dict, runs: int
                   ) -> dict[str, dict[str, float]]:
    """Host-clock milliseconds of each step of the four long-form file calls
    with device quantize (the steps of LongFormPhase / LongFormMel
    to_*_wav and to_wav_png), each ended by a synchronise; medians of
    ``runs``."""
    from gomel_tpu_torch.io import audio as audio_io
    from gomel_tpu_torch.io import imagecodec
    from gomel_tpu_torch.ops.quantize import quantize_mel_plane, quantize_planes
    from gomel_tpu_torch.parallel import sharded as sh
    from gomel_tpu_torch.pipelines import longform as lf

    result: dict[str, dict[str, list[float]]] = {}

    def step(call, name, fn):
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        result.setdefault(call, {}).setdefault(name, []).append(
            1e3 * (time.perf_counter() - t0))
        return value

    for _ in range(runs):
        for call, codec in (("LongFormPhase.to_phase_wav", lp),
                            ("LongFormMel.to_mel_wav", lm)):
            c = codec.config
            buf, sr = step(call, "WAV read", lambda: audio_io.load_wav_any(
                wav, mono="left", raw_pcm16=True))
            plan = codec._plan(len(buf))
            xg, b = step(call, "pad + H2D int16", lambda: codec._prep_signal(
                buf, plan, raw=True))

            def device():
                spec = codec._trim(codec._encode_fn(plan)(
                    codec._pcm_convert(xg, 32768.0)), b, plan.n_frames)
                if codec is lp:
                    return quantize_planes(spec[0].contiguous(), 255,
                                           c.ihs_passes)
                return quantize_mel_plane(spec[0].contiguous(), 255)
            q = step(call, "device (KA, encode, gather, quantize)", device)
            img2, mx, mn = step(call, "D2H planes + extrema", lambda: tuple(
                t.cpu().numpy() for t in q))
            if codec is lp:
                step(call, "PNG write", lambda: imagecodec.save_phase_image_quantized(
                    pngs["split"], img2, mx, mn, c.y_reverse,
                    float(len(buf)) / img2.shape[1], float(sr), c.hdr,
                    layout="go"))
            else:
                step(call, "PNG write", lambda: imagecodec.save_mel_image_quantized(
                    pngs["split"], img2, float(mx), float(mn), c.y_reverse,
                    float(len(buf)) / img2.shape[1], float(sr)))
        call = "LongFormPhase.to_wav_png"
        c = lp.config
        planes, maxs, mins, samples, sr, nf = step(
            call, "PNG read", lambda: imagecodec.load_phase_image_raw(
                pngs["phase"], c.y_reverse, c.hdr))
        plan = lp._plan_for_frames(planes.shape[1])
        pg, _ = step(call, "pad + H2D planes", lambda: lp._prep_frames(
            planes.transpose(1, 0, 2)[None], plan, raw=True))

        def phase_device():
            spec = sh.Sharded(lp.mesh, [lf.dequantize_raw(
                s, maxs, mins, 255, c.ihs_passes) for s in pg.shards])
            return lp._decode_fn(plan, pcm16=True)(spec)
        res = step(call, "device (KL, KG, KH, KM, gather)", phase_device)
        wave = step(call, "D2H int16 + flag", lambda: lf._finite_pcm(
            res, plan.out_len))
        step(call, "WAV write", lambda: audio_io.save_wav_pcm16(
            outs["split"], wave[:int(samples)], c.family_main_rate))

        call = "LongFormMel.to_wav_png"
        c = lm.config
        planes, mx, mn, samples, sr = step(
            call, "PNG read", lambda: imagecodec.load_mel_image_raw(
                pngs["mel"], c.y_reverse))
        plan = lm._plan_for_frames(planes.shape[1])
        pg, _ = step(call, "pad + H2D planes", lambda: lm._prep_frames(
            planes.transpose(1, 0, 2)[None], plan, raw=True))
        sig0 = step(call, "GL start drawn on the card (KP, one launch a "
                    "shard)",
                    lambda: sh.sharded_gl_noise_fn(lm.mesh, plan, 1)(1))

        def mel_device():
            logmel = sh.Sharded(lm.mesh, [lf.dequantize_raw(
                s, mx, mn, 255, 0, float(c.volume_boost)) for s in pg.shards])
            mag = sh.sharded_mel_magnitudes_fn(lm.mesh, lm._inv, c.tune_mul,
                                               c.tune_add)(logmel)
            return sh.sharded_griffin_lim_fn(
                lm.mesh, plan, c.griffin_lim_iterations, pcm16=True)(mag,
                                                                      sig0)
        res = step(call, "device (KL, KI, KJ, KK, KM, gather)", mel_device)
        wave = step(call, "D2H int16 + flag", lambda: lf._finite_pcm(
            res, plan.out_len))
        step(call, "WAV write", lambda: audio_io.save_wav_pcm16(
            outs["split"], wave[:int(samples)], int(sr)))
    return {call: {k: float(np.median(v)) for k, v in steps.items()}
            for call, steps in result.items()}


def longform(tmp: str, drive, card: str, dev: torch.device) -> None:
    """Phase 3e: the long-form path on one seeded 30-minute 48 kHz mono WAV
    through LongFormPhase and LongFormMel with device quantize, on four frame
    shards of one card (about 16,900 frames a shard, which K18's
    auto_frame_chunk would cut into 1024-frame chunks): to_phase_wav then
    to_wav_png, to_mel_wav then to_wav_png at the
    config's GL-2. Checks the launches of KA-KM on these paths, the PNGs and
    WAVs against the single-file Phase / Mel on the same file, the GL
    against ops/griffinlim.griffin_lim from the concatenated per-shard start,
    sharded_mel_decode_fn with interior_mm (KN, KO on the interior
    iterations) against the exact program by spectral convergence, and
    decode_resumable against decode; then the host-clock split of each
    call, the time of the GL start's draw on the card (KP, one launch a
    shard), and K18's race (chunked against unchunked encodes)."""
    from gomel_tpu_torch import (LongFormMel, LongFormPhase, Mel, MelConfig,
                                 Phase, PhaseConfig, make_mesh)
    from gomel_tpu_torch.core.framing import is_padded
    from gomel_tpu_torch.io import imagecodec, wavcodec
    from gomel_tpu_torch.io.pngcodec import read_png
    from gomel_tpu_torch.ops import griffinlim, mel_ops
    from gomel_tpu_torch.ops.stft import hann_window
    from gomel_tpu_torch.parallel import sharded as sh
    from gomel_tpu_torch.pipelines import longform as lf
    from gomel_tpu_torch.utils.metrics import spectral_convergence

    def path(name):
        return os.path.join(tmp, "long_" + name)

    n = int(SAMPLE_RATE * LONG_SECONDS)
    t0 = time.perf_counter()
    pcm = long_pcm(n, dev)
    wav = path("in.wav")
    wavcodec.write_wav(wav, pcm, SAMPLE_RATE)
    log(f"long-form file: {LONG_SECONDS:.0f} s at {SAMPLE_RATE} Hz mono, "
        f"{n} samples, made and written in {time.perf_counter() - t0:.2f} s")
    mesh = make_mesh(data=1, frame=N_SHARDS, devices=[dev] * N_SHARDS)
    pcfg, mcfg = PhaseConfig.cli_default(), MelConfig.cli_default()
    lp = LongFormPhase(pcfg, mesh, device_quantize=True)
    lm = LongFormMel(mcfg, mesh, device_quantize=True)
    plan = lp._plan(n)
    log(f"plan: {plan.n_frames} frames, {plan.n_frames_padded} padded, "
        f"{plan.frames_per_shard} a shard over {N_SHARDS} shards "
        f"(auto_frame_chunk: {sh._frame_chunk(plan, 'auto')})")
    pngs = {"phase": path("p.png"), "mel": path("m.png"),
            "split": path("split.png")}
    outs = {"phase": path("p.wav"), "mel": path("m.wav"),
            "split": path("split.wav")}
    letters = {"pcm16_ingest": "A", "stft_mag": "B", "mel_log": "C",
               "stft_mel_log": "BC",
               "quantize_mel_plane": "D", "phase_encode": "E",
               "quantize_planes": "F", "irfft_window_masked": "G",
               "overlap_normalize": "H", "mel_to_magnitudes": "I",
               "gl_project": "J", "gl_overlap_add": "K",
               "dequantize_raw": "L", "shard_epilogue": "M",
               "threefry_uniform": "P"}
    runs = (
        ("LongFormPhase.to_phase_wav", lambda: lp.to_phase_wav(
            wav, pngs["phase"]), ("pcm16_ingest", "phase_encode",
                                  "quantize_planes")),
        ("LongFormPhase.to_wav_png", lambda: lp.to_wav_png(
            pngs["phase"], outs["phase"]), ("dequantize_raw",
                                            "irfft_window_masked",
                                            "overlap_normalize",
                                            "shard_epilogue")),
        ("LongFormMel.to_mel_wav", lambda: lm.to_mel_wav(
            wav, pngs["mel"]), ("pcm16_ingest", "stft_mel_log",
                                "quantize_mel_plane")),
        ("LongFormMel.to_wav_png", lambda: lm.to_wav_png(
            pngs["mel"], outs["mel"], seed=1), (
                "dequantize_raw", "mel_to_magnitudes", "gl_project",
                "gl_overlap_add", "shard_epilogue", "threefry_uniform")))
    seen = set()
    for label, fn, must in runs:
        _, counts = drive(f"{label}, {LONG_SECONDS / 60:g} min, {N_SHARDS} "
                          f"frame shards on one card (first call)",
                          lambda: (fn(), 0)[1], must)
        seen |= {c for k in counts if k in letters for c in letters[k]}
        # the GL start: one KP launch a shard, on the mel decode alone
        want_p = N_SHARDS if "threefry_uniform" in must else 0
        if counts.get("threefry_uniform", 0) != want_p:
            raise AssertionError(f"{label}: {counts.get('threefry_uniform', 0)}"
                                 f" KP launches, expected {want_p}")
    missing = sorted(set("ABCDEFGHIJKLMP") - seen)
    if missing:
        raise AssertionError(f"kernels never launched on the long-form "
                             f"paths: {['K' + m for m in missing]}")
    log(f"long-form paths launched every kernel KA-KM and KP "
        f"({''.join(sorted(seen))})")

    sp = Phase(pcfg, device_quantize=True, device=dev)
    sm = Mel(mcfg, device_quantize=True, device=dev)
    single_p, single_m = path("ps.png"), path("ms.png")
    sp.to_phase_wav(wav, single_p)
    sm.to_mel_wav(wav, single_m)
    w = pngs_near(pngs["phase"], single_p, False)
    log(f"long-form phase PNG {read_png(single_p).shape} vs Phase on the same "
        f"file: max step {w[0]}, flip rate {w[1]:.2e} (bounds 1, 2e-3), "
        f"metadata equal")
    w = pngs_near(pngs["mel"], single_m, True)
    log(f"long-form mel PNG {read_png(single_m).shape} vs Mel on the same "
        f"file: max step {w[0]}, flip rate {w[1]:.2e} (bounds 1, 2e-3), "
        f"metadata equal")
    sp.to_wav_png(pngs["phase"], path("ps.wav"))
    w = wavs_near(outs["phase"], path("ps.wav"), 1)
    log(f"long-form phase WAV vs Phase.to_wav_png of the same PNG: max {w[0]} "
        f"LSB, differing {w[1]:.2e} (bounds 1, 5e-2)")

    c = mcfg
    planes, mx, mn, samples, _ = imagecodec.load_mel_image_raw(pngs["mel"],
                                                               c.y_reverse)
    mplan = lm._plan_for_frames(planes.shape[1])
    start = sh.sharded_gl_noise_fn(mesh, mplan, 1)(1).gather()[
        0, :mplan.out_len].contiguous()
    mag = mel_ops.mel_to_magnitudes(
        torch.from_numpy(planes.copy()).to(dev), sm.inv_weights, c.tune_mul,
        c.tune_add, float(c.volume_boost), mx, mn)
    pcm1, ok1 = griffinlim.griffin_lim(mag, c.window, c.griffin_lim_iterations,
                                       window=sm.window, init=start,
                                       pcm16=True)
    wave1 = pcm1.cpu().numpy()
    if not bool(ok1):
        raise AssertionError("single-path GL gave non-finite samples")
    if int(samples) > 0 and is_padded(int(samples), len(wave1), c.window) \
            and len(wave1) > int(samples):
        wave1 = wave1[:int(samples)]
    wavcodec.write_wav(path("ms.wav"), wave1,
                       wavcodec.read_wav(outs["mel"])[1])
    w = wavs_near(outs["mel"], path("ms.wav"), 2)
    log(f"long-form mel WAV (GL-{c.griffin_lim_iterations}) vs "
        f"ops/griffinlim.griffin_lim from the concatenated per-shard start: "
        f"max {w[0]} LSB, differing {w[1]:.2e} (bounds 2, 5e-2)")

    # interior_mm on the four frame shards at GL-2, from the same per-shard
    # starts as the exact program
    pg, _ = lm._prep_frames(planes.transpose(1, 0, 2)[None], mplan, raw=True)
    logmel_s = sh.Sharded(mesh, [lf.dequantize_raw(
        s, mx, mn, 255, 0, float(c.volume_boost)) for s in pg.shards])
    target = sh.sharded_mel_magnitudes_fn(mesh, lm._inv, c.tune_mul,
                                          c.tune_add)(logmel_s).gather()[
        0, :mplan.n_frames]
    decoded = {}
    for mm in (True, False):
        dec = sh.sharded_mel_decode_fn(mesh, mplan, lm._inv, 2, c.tune_mul,
                                       c.tune_add, interior_mm=mm)
        must = ("mel_to_magnitudes", "gl_overlap_add", "shard_epilogue") + (
            ("dft_fwd_bf16", "dft_inv_bf16", "irfft_window") if mm
            else ("gl_project",))

        def run(dec=dec, mm=mm):
            decoded[mm] = dec(logmel_s, 1).gather()[0, :mplan.out_len]
            return 0
        drive(f"sharded_mel_decode_fn(interior_mm={mm}) GL-2, "
              f"{LONG_SECONDS / 60:g} min, {N_SHARDS} frame shards", run, must)
    win = torch.tensor(hann_window(c.resolut), dtype=torch.float32,
                       device=dev)
    sc = {mm: spectral_convergence(decoded[mm], target, c.resolut, c.window,
                                   win) for mm in (True, False)}
    log(f"sharded mel decode GL-2 from the same per-shard starts: spectral "
        f"convergence interior_mm=True {sc[True]:.6f}, False {sc[False]:.6f} "
        f"(bound: True <= 1.05 x False + 1e-3)")
    if not (math.isfinite(sc[True]) and sc[True] <= 1.05 * sc[False] + 1e-3):
        raise AssertionError("sharded interior_mm outside its bound")

    x60 = pcm[:60 * SAMPLE_RATE].astype(np.float64) / 32768.0
    lm_f = LongFormMel(mcfg, mesh)
    logmel = lm_f.encode(x60)
    a = lm_f.decode(logmel, seed=2)
    b = lm_f.decode_resumable(logmel, seed=2, segment_iters=1)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("decode_resumable differs from decode")
    log(f"decode_resumable (1 iteration a segment) vs decode, 60 s "
        f"{tuple(a.shape)}: bit-equal")

    for call, steps in longform_split(lp, lm, wav, pngs, outs, 3).items():
        log(f"  {call} split on {card} (host clock, each step ended by a "
            f"synchronise, median of 3): " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in steps.items()))
    draw = []
    for _ in range(3):
        t0 = time.perf_counter()
        sh.sharded_gl_noise_fn(mesh, plan, 1)(1)
        torch.cuda.synchronize()
        draw.append(time.perf_counter() - t0)
    log(f"  GL start of the {LONG_SECONDS / 60:g}-minute file, {N_SHARDS} "
        f"shards drawn on the card by KP (one launch a shard), host clock "
        f"to the synchronise: {1e3 * float(np.median(draw)):.3f} ms (median "
        f"of 3)")

    xg, _ = lp._prep_signal(pcm, plan, raw=True)
    xf = lp._pcm_convert(xg, 32768.0)
    for label, make in (
            ("mel encode (KB + KC)", lambda fc: sh.sharded_mel_encode_fn(
                mesh, plan, mcfg.num_mels, lm._fwd, frame_chunk=fc)),
            ("phase encode (KE)", lambda fc: sh.sharded_phase_encode_fn(
                mesh, plan, pcfg.num_freqs, frame_chunk=fc))):
        auto, flat = make("auto"), make(None)
        a_ms, f_ms = race(lambda: auto(xf), lambda: flat(xf), label,
                          iters=4, warmup=1)
        log(f"  K18 race, {label} of the {LONG_SECONDS / 60:g}-minute file "
            f"over {N_SHARDS} "
            f"shards, device ms (lower of two, order flat-chunked-chunked-"
            f"flat): frame_chunk auto ({sh._frame_chunk(plan, 'auto')} "
            f"frames) {a_ms:.4f} ms, None {f_ms:.4f} ms")


def batch_clis(tmp: str, rng: np.random.Generator, drive, card: str) -> None:
    """Phase 3d: the four batch CLIs with --device cuda on a directory of 12
    files of 2-45 s (48 kHz WAV, mono and stereo, four of them of one length
    so that the decodes run a batch of 4 rows of equal frames; two 16-bit
    FLACs; two 16 kHz WAVs, the second phase family), against --device cpu
    on a subset of 7 and against the single-file tools (tomel / tophase
    PNGs, fromphase WAVs of the batch PNGs) for every file; then the wall
    per file of each batch CLI against the single-file tool, and the busy
    share of one batch-tomel run."""
    from gomel_tpu_torch.cli.batch import (batch_fromphase, batch_tomel,
                                           batch_tophase, batch_towav)
    from gomel_tpu_torch.cli.tools import fromphase, tomel, tophase, towav
    from gomel_tpu_torch.core.config import num_freqs_for_sample_rate
    from gomel_tpu_torch.io import flac, imagecodec, wavcodec
    from gomel_tpu_torch.io.pngcodec import read_png

    def path(*parts):
        return os.path.join(tmp, *parts)

    src, sub = path("batch_in"), path("batch_sub")
    os.makedirs(src)
    os.makedirs(sub)
    # (name, seconds, rate, stereo, in the CPU subset)
    spec = [("w02.wav", 2, SAMPLE_RATE, False, True),
            ("w09a.wav", 9, SAMPLE_RATE, False, True),
            ("w09b.wav", 9, SAMPLE_RATE, False, True),
            ("s09a.wav", 9, SAMPLE_RATE, True, True),
            ("s09b.wav", 9, SAMPLE_RATE, True, True),
            ("w30.wav", 30, SAMPLE_RATE, False, False),
            ("w45.wav", 45, SAMPLE_RATE, False, False),
            ("s38.wav", 38, SAMPLE_RATE, True, False),
            ("f03.flac", 3, SAMPLE_RATE, False, True),
            ("f06.flac", 6, SAMPLE_RATE, True, False),
            ("k03.wav", 3, 16000, False, True),
            ("k10.wav", 10, 16000, False, False)]
    t0 = time.perf_counter()
    for name, secs, sr, stereo, in_sub in spec:
        n = int(secs * sr)
        x = seeded_pcm_rate(rng, n, sr)
        if stereo:
            x = np.stack([x, seeded_pcm_rate(rng, n, sr)], axis=1)
        out = os.path.join(src, name)
        if name.endswith(".flac"):
            flac.write_flac(out, x, sr)
        else:
            wavcodec.write_wav(out, x, sr)
        if in_sub:
            shutil.copy(out, os.path.join(sub, name))
    names = [n for n, *_ in spec]
    audio_s = float(sum(secs for _, secs, *_ in spec))
    log(f"batch directory: {len(spec)} files, {audio_s:.0f} s of audio, "
        f"written in {time.perf_counter() - t0:.2f} s; FLAC decoder: "
        f"{flac.decoder()}")
    if flac.decoder() != "native":
        raise AssertionError("the native FLAC decoder did not build or load")

    runs = {
        "batch-tomel": (batch_tomel, [src], "bm", (
            "stft_mel_log pcm16", "quantize_mel_plane_masked")),
        "batch-towav": (batch_towav, [path("bm_cuda"), "--seed", "1"], "bw",
                        ("mel_to_magnitudes", "gl_project", "gl_overlap_add",
                         "threefry_uniform")),
        "batch-tophase": (batch_tophase, [src], "bp", (
            "pcm16_ingest", "phase_encode", "quantize_planes_masked")),
        "batch-fromphase": (batch_fromphase, [path("bp_cuda")], "bf",
                            ("irfft_window", "overlap_normalize")),
    }
    first = {}
    for label, (tool, args, out, must) in runs.items():
        first[label], counts = drive(
            f"{label} --device cuda, {len(spec)} files (first call)",
            lambda: tool(args + ["--out-dir", path(out + "_cuda"),
                                 "--device", "cuda"]), must)
        # one KP launch draws every row's start of a decode call
        want_p = counts.get("mel_to_magnitudes", 0) \
            if label == "batch-towav" else 0
        if counts.get("threefry_uniform", 0) != want_p:
            raise AssertionError(f"{label}: {counts.get('threefry_uniform', 0)}"
                                 f" KP launches, expected {want_p}")
        # the mel encode from PCM reads the int16 rows in the fused launch:
        # no KA, no float fused launch
        if label == "batch-tomel" and any(counts.get(k) for k in (
                "pcm16_ingest", "pcm16_ingest_rows", "stft_mel_log")):
            raise AssertionError(f"batch-tomel ran KA or the float fused "
                                 f"launch: {counts}")
        if len(os.listdir(path(out + "_cuda"))) != len(spec):
            raise AssertionError(f"{label} wrote {os.listdir(path(out + '_cuda'))}")

    # the encodes on the CPU subset: a file's PNG does not depend on its
    # bucket (masked extrema), so the 12-file cuda run compares file by file
    sub_names = sorted(os.listdir(sub))
    for tool, out, mel in ((batch_tomel, "bm", True),
                           (batch_tophase, "bp", False)):
        if tool([sub, "--out-dir", path(out + "_cpu"), "--device", "cpu"]):
            raise AssertionError(f"{out} on the CPU failed")
        worst = [pngs_near(path(out + "_cuda", n + ".png"),
                           path(out + "_cpu", n + ".png"), mel)
                 for n in sub_names]
        log(f"{'batch-tomel' if mel else 'batch-tophase'} PNGs, cuda (12-file "
            f"run) vs cpu (subset of {len(sub_names)}): max step "
            f"{max(w[0] for w in worst)}, flip rate <= "
            f"{max(w[1] for w in worst):.2e} (bounds 1, 2e-3), metadata equal")
    # the decodes of the same PNGs on both devices (a batch-towav row's
    # start depends on its row, so both runs see the same directory)
    for tool, enc, dec, extra, lsb in (
            (batch_towav, "bm", "bw", ["--seed", "1"], 2),
            (batch_fromphase, "bp", "bf", [], 1)):
        pngdir = path(enc + "_sub")
        os.makedirs(pngdir)
        for n in sub_names:
            shutil.copy(path(enc + "_cuda", n + ".png"), pngdir)
        for device in ("cuda", "cpu"):
            if tool([pngdir, "--out-dir", path(f"{dec}_sub_{device}"),
                     "--device", device] + extra):
                raise AssertionError(f"{dec} on {device} failed")
        worst = [wavs_near(path(f"{dec}_sub_cuda", n + ".png.wav"),
                           path(f"{dec}_sub_cpu", n + ".png.wav"), lsb)
                 for n in sub_names]
        log(f"{'batch-towav' if dec == 'bw' else 'batch-fromphase'} WAVs of "
            f"the same {len(sub_names)} PNGs, cuda vs cpu: max "
            f"{max(w[0] for w in worst)} LSB, differing <= "
            f"{max(w[1] for w in worst):.2e} (bounds {lsb}, 5e-2)")

    # every batch PNG against the single-file tool's PNG of its file
    single = {"tomel": [], "tophase": [], "towav": [], "fromphase": []}
    os.makedirs(path("single"))
    worst = {"tomel": (0, 0.0), "tophase": (0, 0.0)}
    for rep in range(2):     # the second pass is timed
        for n, _, sr, _, _ in spec:
            stem = path("single", n)
            # the batch tool takes each file's bin count from its rate
            nf = str(num_freqs_for_sample_rate(sr))
            for label, tool, args, out in (
                    ("tomel", tomel, [path("batch_in", n)], stem + ".m.png"),
                    ("tophase", tophase, [path("batch_in", n), "--num-freqs",
                                          nf], stem + ".p.png"),
                    ("towav", towav, [stem + ".m.png", "44100", "--seed",
                                      "1"], stem + ".m.wav"),
                    ("fromphase", fromphase, [path("bp_cuda", n + ".png")],
                     stem + ".p.wav")):
                t0 = time.perf_counter()
                if tool(args + ["--device", "cuda", "-o", out]):
                    raise AssertionError(f"{label} {n} failed")
                torch.cuda.synchronize()
                if rep:
                    single[label].append(time.perf_counter() - t0)
                elif label in worst:
                    batch = path("bm_cuda" if label == "tomel" else "bp_cuda",
                                 n + ".png")
                    w = pngs_near(batch, out, label == "tomel")
                    worst[label] = (max(worst[label][0], w[0]),
                                    max(worst[label][1], w[1]))
    log(f"batch PNGs vs the single-file tools' PNGs of all {len(names)} files: "
        f"tomel max step {worst['tomel'][0]}, flip rate <= "
        f"{worst['tomel'][1]:.2e}; tophase max step {worst['tophase'][0]}, "
        f"flip rate <= {worst['tophase'][1]:.2e} (bounds 1, 2e-3), metadata "
        f"equal")
    worst = [wavs_near(path("bf_cuda", n + ".png.wav"),
                       path("single", n + ".p.wav"), 1) for n in names]
    log(f"batch-fromphase WAVs (rows of up to 4) vs fromphase of the same PNG "
        f"alone, all {len(names)} files: max {max(w[0] for w in worst)} LSB, "
        f"differing <= {max(w[1] for w in worst):.2e} (bounds 1, 5e-2)")

    # wall per file, warm: each batch CLI once more, against the single tool
    log(f"batch CLIs on {card}, {len(names)} files ({audio_s:.0f} s of audio), "
        f"host clock, warm (first call in parentheses):")
    singles = {"batch-tomel": "tomel", "batch-towav": "towav",
               "batch-tophase": "tophase", "batch-fromphase": "fromphase"}
    for label, (tool, args, out, _) in runs.items():
        t0 = time.perf_counter()
        if tool(args + ["--out-dir", path(out + "_warm"), "--device",
                        "cuda"]):
            raise AssertionError(f"{label} (warm) failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        one = single[singles[label]]
        log(f"  {label}: {1e3 * wall / len(names):.4f} ms per file "
            f"({1e3 * first[label] / len(names):.3f}), "
            f"{audio_s / wall:.1f} audio-s/s; {singles[label]} one file at a "
            f"time: {1e3 * float(np.mean(one)):.4f} ms per file, "
            f"{audio_s / float(np.sum(one)):.1f} audio-s/s")
    wall, busy, share = busy_share(lambda: batch_tomel(
        [src, "--out-dir", path("bm_prof"), "--device", "cuda"]))
    log(f"  batch-tomel under torch.profiler: {wall:.3f} ms wall, "
        f"{busy:.3f} ms of device kernels and copies: busy share "
        f"{100 * share:.2f}%")


def prng_kernel(dev: torch.device, errs: dict, gl_len: int) -> dict:
    """Phase 2g: KP against its plain version, bit for bit, at the bench
    shape ([2, gl_len] from one key and from two row keys), the batch shape
    (4 row keys), one shard of the 30-minute mel decode ([1, chunk]) and
    ragged sizes; the plain version on the CPU against the card; and the
    Random123 known answers: on the host's block function, and through the
    launch path on the three vectors' keys (the kernel's counter has a zero
    high word by design, so the first vector's block is sample 0 of its key
    and the other keys' samples are held to the host function). Returns
    phase 4's closures and work counts."""
    from gomel_tpu_torch.core.config import MelConfig
    from gomel_tpu_torch.ops import prng

    f32 = torch.float32
    vectors = (((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
               ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
                (0x1cb996fc, 0xbb002be7)),
               ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
                (0xc4923a9c, 0x483df7a0)))
    for k, counter, want in vectors:
        if prng.threefry2x32(*k, *counter) != want:
            raise AssertionError(f"threefry2x32{k + counter} is not {want}")
        got = prng.uniform(np.array(k, np.uint32), (1024,), f32, dev)
        bits = np.array([np.bitwise_xor(*prng.threefry2x32(*k, 0, j))
                         for j in range(1024)], dtype=np.uint32)
        ref = ((bits >> 9) | np.uint32(0x3F800000)).view(np.float32) \
            - np.float32(1.0)
        if not np.array_equal(got.cpu().numpy(), ref):
            raise AssertionError(f"KP with key {k} differs from the host's "
                                 f"block function")
    log("KP threefry_uniform: the three Random123 known answers hold on the "
        "host's block function; 1024 samples of each vector's key through "
        "the launch path equal it bit for bit (sample 0 of key (0, 0) is the "
        "first vector's block)")

    chunk = long_plan(MelConfig.cli_default()).chunk
    one = prng.key(SEED)
    cases = ((f"bench, one key [{BATCH}, {gl_len}]", one, (BATCH, gl_len)),
             (f"bench, {BATCH} row keys x [{gl_len}]",
              prng.split_rows(one, BATCH), (gl_len,)),
             (f"batch, 4 row keys x [{gl_len}]", prng.split_rows(one, 4),
              (gl_len,)),
             (f"one long-form shard [1, {chunk}]", prng.fold_in(one, 3),
              (1, chunk)),
             ("ragged [1]", one, (1,)),
             ("ragged [12345]", prng.key(-7), (12345,)),
             ("ragged, 3 row keys x [7, 111]", prng.split_rows(one, 3),
              (7, 111)),
             ("3 row keys x [1001] (rows off 16 bytes, heads and tails)",
              prng.split_rows(one, 3), (1001,)))
    worst = 0.0
    for label, keys, shape in cases:
        got = prng.uniform(keys, shape, f32, dev)
        want = prng.uniform_plain(keys, shape, f32, dev)
        torch.cuda.synchronize()
        worst = max(worst, float((got - want).abs().max()))
        inside = bool((got >= 0).all() and (got < 1).all())
        log(f"KP threefry_uniform {label} -> {tuple(got.shape)}: bit-exact "
            f"{torch.equal(got, want)}, in [0, 1) {inside}, mean "
            f"{float(got.double().mean()):.6f}")
        if not (torch.equal(got, want) and inside):
            raise AssertionError(f"KP ({label}) differs from its plain version")
    errs["threefry_uniform"] = worst
    on_cpu = prng.uniform(prng.key(-7), (12345,), f32, "cpu")
    if not torch.equal(on_cpu, prng.uniform(prng.key(-7), (12345,), f32,
                                            dev).cpu()):
        raise AssertionError("KP on the card differs from the CPU's draw")
    log("KP threefry_uniform: the card's draw equals the CPU's bit for bit")

    g = torch.Generator(device=dev).manual_seed(SEED)
    shard_key = prng.fold_in(one, 3)

    def entry(keys, shape):
        samples = float(np.prod(shape))
        return dict(
            kernel=lambda: prng.uniform(keys, shape, f32, dev),
            plain=lambda: prng.uniform_plain(keys, shape, f32, dev),
            work=(4.0 * samples + 8.0, THREEFRY_OPS * samples, INSTR_RATE_S),
            # another stream: the same distribution, not the same samples
            library=lambda: torch.rand(shape, generator=g, device=dev))
    return {"threefry_uniform": entry(one, (BATCH, gl_len)),
            "threefry_uniform one shard": entry(shard_key, (1, chunk))}


def streaming(drive, card: str, dev: torch.device) -> None:
    """Phase 3g: StreamingPhase and StreamingMel at the CLI widths, 512
    frames a chunk, on the 30-minute 48 kHz signal of phase 3e fed in
    one-second pieces. The concatenated encode chunks against Phase.encode /
    Mel.encode of the whole signal on the card, within 1e-5 of each frame's
    peak (the log domain for mel); StreamingPhase.decode_iter of that
    spectrogram against Phase.decode, within 2e-4 absolute on a unit-scale
    signal; one launch of KE, of the fused KB + KC (and none of KB or KC
    alone), of KG + KH per chunk; audio-s/s of wall
    and the peak device memory of each stream against the whole-file call."""
    from gomel_tpu_torch import (Mel, MelConfig, Phase, PhaseConfig,
                                 StreamingMel, StreamingPhase)
    from gomel_tpu_torch.core.framing import num_frames, pad_length

    cf = 512
    n = int(SAMPLE_RATE * LONG_SECONDS)
    x = long_pcm(n, dev).astype(np.float64) / 32768.0
    pcfg, mcfg = PhaseConfig.cli_default(), MelConfig.cli_default()
    frames = num_frames(pad_length(n, pcfg.window), pcfg.resolut, pcfg.window)
    chunks = -(-frames // cf)
    peaks: dict[str, float] = {}

    def pieces():
        return (x[i:i + SAMPLE_RATE] for i in range(0, n, SAMPLE_RATE))

    def run(label, fn, must):
        """``fn`` through ``drive`` with its peak device memory above what
        was resident before it; returns (result, wall seconds, counts)."""
        out = {}

        def call():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out["value"] = fn()
            torch.cuda.synchronize()
            peaks[label] = (torch.cuda.max_memory_allocated() - base) / 1e6
            return 0
        seconds, counts = drive(label, call, must)
        return out["value"], seconds, counts

    def report(label, stream_s, whole_s, stream_label, whole_label):
        log(f"  {label} on {card}: stream {LONG_SECONDS / stream_s:.1f} "
            f"audio-s/s of wall ({stream_s:.3f} s), whole file "
            f"{LONG_SECONDS / whole_s:.1f} ({whole_s:.3f} s); peak device "
            f"memory above what was resident: stream "
            f"{peaks[stream_label]:.1f} MB, whole file "
            f"{peaks[whole_label]:.1f} MB")

    def per_chunk(label, counts, names):
        got = {k: counts.get(k, 0) for k in names}
        if any(v != chunks for v in got.values()):
            raise AssertionError(f"{label}: launches {got}, expected "
                                 f"{chunks} of each (one per chunk)")

    size = f"{LONG_SECONDS / 60:g} min in 1 s pieces, {cf} frames a chunk"
    sp = StreamingPhase(pcfg, cf, device=dev)
    whole_p = Phase(pcfg, device=dev)
    label = f"StreamingPhase.encode_iter, {size}"
    p_chunks, t_s, counts = run(label, lambda: list(sp.encode_iter(pieces())),
                                ("phase_encode",))
    per_chunk(label, counts, ("phase_encode",))
    if len(p_chunks) != chunks or sum(len(c) for c in p_chunks) != frames:
        raise AssertionError(f"{label}: {len(p_chunks)} chunks of "
                             f"{sum(len(c) for c in p_chunks)} frames, "
                             f"expected {chunks} of {frames}")
    want, t_w, _ = run("Phase.encode, the whole signal",
                       lambda: whole_p.encode(x), ("phase_encode",))
    got = torch.from_numpy(np.concatenate(p_chunks)).to(dev)
    rel, _ = frame_peak_err(got, want, want.abs().amax(dim=(-2, -1),
                                                       keepdim=True))
    log(f"streaming phase encode {tuple(got.shape)} vs Phase.encode: "
        f"{rel:.3e} of the frame peak (bound 1e-5), bit-equal "
        f"{torch.equal(got, want)}")
    if not rel <= 1e-5:
        raise AssertionError("the streaming phase encode is outside its bound")
    report("phase encode", t_s, t_w, label, "Phase.encode, the whole signal")
    del got

    label = f"StreamingPhase.decode_iter, {size}"
    blocks, t_s, counts = run(label, lambda: list(sp.decode_iter(p_chunks)),
                              ("irfft_window_masked", "overlap_normalize"))
    per_chunk(label, counts, ("irfft_window_masked", "overlap_normalize"))
    sig_w, t_w, _ = run("Phase.decode, the whole spectrogram",
                        lambda: whole_p.decode(want),
                        ("irfft_window", "overlap_normalize"))
    sig = np.concatenate(blocks)
    ref = sig_w.cpu().numpy().astype(np.float64)
    if sig.shape != ref.shape:
        raise AssertionError(f"streaming decode {sig.shape} vs {ref.shape}")
    err = float(np.abs(sig - ref).max())
    m = min(n, len(sig))
    corr = float(np.corrcoef(x[4096:m - 4096], sig[4096:m - 4096])[0, 1])
    log(f"streaming phase decode {sig.shape} vs Phase.decode: max|d| "
        f"{err:.3e} (bound 2e-4) on a signal of peak "
        f"{float(np.abs(ref).max()):.3f}; correlation with the input "
        f"{corr:.6f} (bound 0.99)")
    if not (err <= 2e-4 and corr > 0.99):
        raise AssertionError("the streaming phase decode is outside its bound")
    report("phase decode", t_s, t_w, label,
           "Phase.decode, the whole spectrogram")
    del want, sig_w, p_chunks, blocks, sig, ref

    sm = StreamingMel(mcfg, cf, device=dev)
    whole_m = Mel(mcfg, device=dev)
    label = f"StreamingMel.encode_iter, {size}"
    m_chunks, t_s, counts = run(label, lambda: list(sm.encode_iter(pieces())),
                                ("stft_mel_log",))
    per_chunk(label, counts, ("stft_mel_log",))
    if counts.get("stft_mag", 0) or counts.get("mel_log", 0):
        raise AssertionError(f"{label}: standalone KB or KC launched "
                             f"({counts}); the fused launch runs each chunk")
    want, t_w, _ = run("Mel.encode, the whole signal",
                       lambda: whole_m.encode(x), ("stft_mel_log",))
    got = torch.from_numpy(np.concatenate(m_chunks)).to(dev)
    if got.shape != want.shape:
        raise AssertionError(f"streaming mel {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    rel, _ = frame_peak_err(got, want, want.abs().amax(dim=(-2, -1),
                                                       keepdim=True))
    log(f"streaming mel encode {tuple(got.shape)} vs Mel.encode: {rel:.3e} of "
        f"the frame's peak in the log domain (bound 1e-5), bit-equal "
        f"{torch.equal(got, want)}")
    if not rel <= 1e-5:
        raise AssertionError("the streaming mel encode is outside its bound")
    report("mel encode", t_s, t_w, label, "Mel.encode, the whole signal")


def serving_phase(tmp: str, drive, card: str, dev: torch.device,
                  x: torch.Tensor) -> None:
    """Phase 3h: the serving artifacts (gomel_tpu_torch/serving.py). The
    nine single-device builders at the bench shape (the CLI widths, 30 s at
    48 kHz) on the card with a symbolic batch, each saved, its header read
    and loaded back, called at B = 2 and B = 1 through ``drive`` (so each
    proves its hand kernels ran), bit-equal to the port's eager path on the
    card and within the CPU bounds of its CPU artifact (float32 1e-5 of the
    frame's or row's peak, the log-mel's energies 1e-5 of the frame's peak,
    planes 1 step at < 2e-3, PCM
    1 LSB for phase and 2 for mel at < 5e-2, equal finite flags); then the
    four long-form builders on four frame shards of the card at the
    30-minute file's 67,497 frames, each called once and held bit-equal to
    the sharded program phase 3e's file calls run; then the ``export`` and
    ``info`` tools. Prints each artifact's build and load seconds, device ms
    and host us per call beside the eager path's."""
    from gomel_tpu_torch import MelConfig, PhaseConfig, make_mesh, serving
    from gomel_tpu_torch.cli.tools import main as tools_main
    from gomel_tpu_torch.core.filterbank import (inverse_mel_weights,
                                                 mel_weights)
    from gomel_tpu_torch.ops import (griffinlim, mel_ops, phase_ops, prng,
                                     quantize)
    from gomel_tpu_torch.ops.stft import hann_window
    from gomel_tpu_torch.parallel import sharded as sh
    from gomel_tpu_torch.parallel.mesh import shard_array

    cpu = torch.device("cpu")
    f32 = torch.float32
    mcfg, pcfg = MelConfig.cli_default(), PhaseConfig.cli_default()
    n_fft, hop, nf = mcfg.resolut, mcfg.window, pcfg.num_freqs
    fwd = torch.tensor(mel_weights(mcfg.n_bins, mcfg.num_mels, mcfg.mel_fmin,
                                   mcfg.mel_fmax), dtype=f32, device=dev)
    inv = torch.tensor(inverse_mel_weights(mcfg.n_bins, mcfg.num_mels,
                                           mcfg.mel_fmin, mcfg.mel_fmax),
                       dtype=f32, device=dev)
    win = torch.tensor(hann_window(n_fft), dtype=f32, device=dev)
    keys_np = prng.split_rows(prng.key(SEED + 7), BATCH)
    # the artifacts take the keys' uint32 bits as int32
    keys = torch.from_numpy(keys_np.view(np.int32)).to(dev)
    max_val, ihs = 255, pcfg.ihs_passes
    n_gl = mcfg.griffin_lim_iterations

    def host_keys(k):
        """The eager path's host keys of an artifact's key rows (the first
        rows of ``keys``), with no copy from the card."""
        return keys_np[:k.shape[0]]

    def live_mel_dec(lm, k, backend="auto"):
        # the window on the card (a host window is copied each call, which
        # waits for the queue); "mm" folds the host Hann window into its
        # weights, as the artifact does, and copies it to the card
        return mel_ops.mel_decode(lm, n_fft, hop, inv, n_gl,
                                  key=host_keys(k), fft_backend=backend,
                                  window=win if backend == "auto" else None)

    def live_mel_dec_q(planes, mx, mn, k):
        mag = mel_ops.mel_to_magnitudes(planes, inv, mcfg.tune_mul,
                                        mcfg.tune_add, mcfg.volume_boost, mx,
                                        mn, 255)
        return griffinlim.griffin_lim(mag, hop, n_gl, host_keys(k), win,
                                      pcm16=True)

    def frame_rel(got, want, dims):
        peak = want.abs().amax(dim=dims, keepdim=True)
        return float(((got.double() - want.double()).abs()
                      / torch.clamp(peak.double(), min=1e-30)).max())

    def near(kind, got, want):
        """The CPU bound of ``kind``; returns its measure for the log."""
        if kind == "logmel":    # the mel energies, 1e-5 of the frame's peak
            return near("frames", got.double().exp(), want.double().exp())
        if kind in ("frames", "signal"):
            d = frame_rel(got, want, (-2, -1) if kind == "frames" else (-1,))
            return d, d <= 1e-5
        if kind == "planes":
            d = (got.long() - want.long()).abs()
            return (int(d.max()), float((d > 0).float().mean())), (
                int(d.max()) <= 1 and float((d > 0).float().mean()) < 2e-3)
        if kind in ("pcm", "pcm_mel"):
            lsb = 2 if kind == "pcm_mel" else 1
            d = (got.long() - want.long()).abs()
            return (int(d.max()), float((d > 0).float().mean())), (
                int(d.max()) <= lsb and float((d > 0).float().mean()) < 5e-2)
        if kind == "extrema":
            d = float(((got - want).abs() / want.abs().clamp(min=1e-6)).max())
            return d, d <= 1e-5
        if kind == "finite":
            return bool(torch.equal(got, want)), bool(torch.equal(got, want))
        raise ValueError(kind)

    bench = {}
    # name, builder, kwargs, inputs (card), live path, must-run kernels,
    # each output's CPU bound
    sig_s = dict(seconds=SECONDS, sample_rate=SAMPLE_RATE)
    enc_m = mel_ops.mel_encode_batch(x, mcfg.num_mels, n_fft, hop, fwd, win)
    spec_p = phase_ops.phase_encode_batch(x, nf, n_fft, hop, win)
    planes_p, mx_p, mn_p = quantize.quantize_planes_batch(spec_p, max_val,
                                                          ihs)
    planes_m, mx_m, mn_m = quantize.quantize_mel_plane_batch(enc_m)
    frames = enc_m.shape[1]
    cases = (
        ("mel-enc", serving.export_mel_encoder, (mcfg, sig_s), (x,),
         lambda a: mel_ops.mel_encode_batch(a, mcfg.num_mels, n_fft, hop, fwd,
                                            win),
         ("stft_mel_log",), ("logmel",)),
        ("mel-dec", serving.export_mel_decoder, (mcfg, dict(n_frames=frames)),
         (enc_m, keys), live_mel_dec,
         ("mel_to_magnitudes", "threefry_uniform", "gl_project",
          "gl_overlap_add"), ("pcm_mel",)),
        ("phase-enc", serving.export_phase_encoder, (pcfg, sig_s), (x,),
         lambda a: phase_ops.phase_encode_batch(a, nf, n_fft, hop, win),
         ("phase_encode",), ("frames",)),
        ("phase-dec", serving.export_phase_decoder,
         (pcfg, dict(n_frames=frames)), (spec_p,),
         lambda s: phase_ops.phase_decode(s, n_fft, hop, pcfg.volume_boost,
                                          win),
         ("irfft_window", "overlap_normalize"), ("signal",)),
        ("phase-rt", serving.export_phase_roundtrip, (pcfg, sig_s), (x,),
         lambda a: phase_ops.phase_decode(phase_ops.phase_encode_batch(
             a, nf, n_fft, hop, win), n_fft, hop, pcfg.volume_boost, win),
         ("phase_encode", "irfft_window", "overlap_normalize"), ("signal",)),
        ("phase-enc-q", serving.export_phase_encoder_quantized,
         (pcfg, sig_s), (x,),
         lambda a: quantize.quantize_planes_batch(phase_ops.phase_encode_batch(
             a, nf, n_fft, hop, win), max_val, ihs),
         ("phase_encode", "quantize_planes"),
         ("planes", "extrema", "extrema")),
        ("phase-dec-q", serving.export_phase_decoder_quantized,
         (pcfg, dict(n_frames=frames)), (planes_p, mx_p, mn_p),
         lambda p, a, b: phase_ops.dequantize_decode(
             p, a, b, max_val, ihs, n_fft, hop, pcfg.volume_boost, win,
             pcm16=True),
         ("irfft_window", "overlap_normalize"), ("pcm", "finite")),
        ("mel-enc-q", serving.export_mel_encoder_quantized, (mcfg, sig_s),
         (x,),
         lambda a: quantize.quantize_mel_plane_batch(mel_ops.mel_encode_batch(
             a, mcfg.num_mels, n_fft, hop, fwd, win)),
         ("stft_mel_log", "quantize_mel_plane"),
         ("planes", "extrema", "extrema")),
        ("mel-dec-q", serving.export_mel_decoder_quantized,
         (mcfg, dict(n_frames=frames)), (planes_m, mx_m, mn_m, keys),
         live_mel_dec_q,
         ("mel_to_magnitudes", "threefry_uniform", "gl_project",
          "gl_overlap_add"), ("pcm_mel", "finite")),
        # the mm route: bf16 KN + KO inside Griffin-Lim (no CPU bound: the
        # CPU runs it exact; phase 3f holds it by spectral convergence),
        # float32 KN + KO in the phase codec
        ("mel-dec mm", serving.export_mel_decoder,
         (mcfg, dict(n_frames=frames, fft_backend="mm")), (enc_m, keys),
         lambda lm, k: live_mel_dec(lm, k, "mm"),
         ("mel_to_magnitudes", "threefry_uniform", "dft_fwd_bf16",
          "dft_inv_bf16", "irfft_window", "gl_overlap_add"), ()),
        ("phase-rt mm", serving.export_phase_roundtrip,
         (pcfg, dict(sig_s, encode_fft_backend="mm",
                     decode_fft_backend="mm")), (x,),
         lambda a: phase_ops.phase_decode(phase_ops.phase_encode_batch(
             a, nf, n_fft, hop, win, "mm"), n_fft, hop, pcfg.volume_boost,
             win, fft_backend="mm"),
         ("dft_fwd_f32", "dft_inv_f32", "overlap_normalize"), ("signal",)),
    )
    for name, builder, (cfg, kw), args, live, must, bounds in cases:
        t0 = time.perf_counter()
        exp = builder(cfg, **kw, device=dev)
        build_s = time.perf_counter() - t0
        path = os.path.join(tmp, name.replace(" ", "_") + ".gmexp")
        serving.save_exported(exp, path, serving.artifact_meta(
            exp, cfg, kind=name.split()[0], **kw))
        meta = serving.read_artifact_meta(path)
        if (meta["kind"], meta["platforms"], meta["in_shapes"][0][0]) != (
                name.split()[0], ["cuda"], "b"):
            raise AssertionError(f"{name}: header {meta}")
        t0 = time.perf_counter()
        art = serving.load_exported(path)
        load_s = time.perf_counter() - t0
        out = {}
        for b in (BATCH, 1):
            sub = tuple(a[:b] for a in args)

            def call():
                out[b] = art.call(*sub)
                return 0
            _, counts = drive(f"serving {name} artifact, B = {b}", call, must)
            got = out[b] if isinstance(out[b], tuple) else (out[b],)
            want = live(*sub)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            if len(got) != len(want) or not all(
                    torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} artifact at B = {b} differs "
                                     f"from the eager path on the card")
        if name in ("mel-dec", "mel-dec-q"):
            want_counts = {"mel_to_magnitudes": 1, "threefry_uniform": 1,
                           "gl_project": n_gl, "gl_overlap_add": n_gl}
            if {k: counts.get(k, 0) for k in want_counts} != want_counts:
                raise AssertionError(f"{name}: launches {counts}, expected "
                                     f"{want_counts}")
        # the CPU artifact of the same builder on the same inputs
        got = out[BATCH] if isinstance(out[BATCH], tuple) else (out[BATCH],)
        got_cpu = ()
        if bounds:
            got_cpu = builder(cfg, **kw, device=cpu).call(
                *(a.cpu() for a in args))
            got_cpu = got_cpu if isinstance(got_cpu, tuple) else (got_cpu,)
        if name == "mel-dec":       # the float wave as the PCM-16 of towav
            got = (quantize.pcm16_encode(got[0])[0],)
            got_cpu = (quantize.pcm16_encode(got_cpu[0])[0],)
        measures = []
        for kind, g, c in zip(bounds, got, got_cpu):
            m, ok = near(kind, g.cpu(), c)
            measures.append(f"{kind} {m}")
            if not ok:
                raise AssertionError(f"{name}: the card artifact against the "
                                     f"CPU artifact, {kind} {m}, is outside "
                                     f"its bound")
        # the eager "mm" decodes copy their window between the host and
        # the card each call, which waits for the queue: both sides on the
        # host clock there
        timer = wall_ms if name.endswith(" mm") else cuda_ms
        a_ms = timer(lambda: art.call(*args))
        l_ms = timer(lambda: live(*args))
        a_us, l_us = host_us(lambda: art.call(*args)), host_us(
            lambda: live(*args))
        bench[name] = (a_ms, l_ms, a_us, l_us, timer.__name__)
        log(f"serving {name}: {meta['in_shapes']} -> {meta['out_shapes']}, "
            f"{os.path.getsize(path) / 1e6:.1f} MB; built in {build_s:.2f} s,"
            f" loaded in {load_s:.2f} s; bit-equal to the eager path at B = "
            f"{BATCH} and 1; launches at B = 1 {counts}; against the CPU "
            f"artifact: {', '.join(measures)}")
    log(f"serving artifacts on {card}: device ms per call (CUDA events) and "
        f"host us to enqueue one call, artifact against the eager path, "
        f"[{BATCH}, {x.shape[1]}] audio or its spectrogram")
    for name, (a_ms, l_ms, a_us, l_us, timer) in bench.items():
        clock = "device" if timer == "cuda_ms" else "host clock (wall_ms)"
        log(f"  {name}: {clock} {a_ms:.4f} ms (eager {l_ms:.4f}, ratio "
            f"{a_ms / l_ms:.3f}); host enqueue {a_us:.1f} us (eager "
            f"{l_us:.1f})")

    # the long-form artifacts: four frame shards of the card, 30 minutes
    n = int(SAMPLE_RATE * LONG_SECONDS)
    mesh = make_mesh(data=1, frame=N_SHARDS, devices=[dev] * N_SHARDS)
    n_frames = long_plan(pcfg).n_frames
    plan = serving.longform_plan(pcfg, mesh, n_frames)
    xl = torch.from_numpy(long_pcm(n, dev).astype(np.float32) / 32768.0)
    xl = sh.pad_signal_for_plan(xl[None].to(dev), plan)
    fwd_np = fwd.cpu().numpy()
    inv_np = inv.cpu().numpy()
    live_lf = {
        "longform-mel-enc": sh.sharded_mel_encode_fn(mesh, plan,
                                                     mcfg.num_mels, fwd_np),
        "longform-phase-enc": sh.sharded_phase_encode_fn(mesh, plan, nf),
        "longform-phase-dec": sh.sharded_phase_decode_fn(
            mesh, plan, pcfg.volume_boost),
        "longform-mel-dec": sh.sharded_mel_decode_fn(
            mesh, plan, inv_np, n_gl, mcfg.tune_mul, mcfg.tune_add)}
    x_sh = shard_array(xl, mesh)
    spec_l = live_lf["longform-phase-enc"](x_sh)
    logmel_l = live_lf["longform-mel-enc"](x_sh)
    lf_cases = (
        ("longform-mel-enc", serving.export_longform_mel_encoder, mcfg,
         (xl,), (x_sh,), ("stft_mel_log",)),
        ("longform-phase-enc", serving.export_longform_phase_encoder, pcfg,
         (xl,), (x_sh,), ("phase_encode",)),
        ("longform-phase-dec", serving.export_longform_phase_decoder, pcfg,
         (spec_l.gather(),), (spec_l,),
         ("irfft_window_masked", "overlap_normalize", "shard_epilogue")),
        ("longform-mel-dec", serving.export_longform_mel_decoder, mcfg,
         (logmel_l.gather(), torch.from_numpy(prng.key(1).view(np.int32))
          .to(dev)), (logmel_l, 1),
         ("mel_to_magnitudes", "threefry_uniform", "gl_project",
          "gl_overlap_add", "shard_epilogue")))
    for name, builder, cfg, args, live_args, must in lf_cases:
        t0 = time.perf_counter()
        exp = builder(cfg, mesh, n_frames=n_frames, batch=1)
        build_s = time.perf_counter() - t0
        path = os.path.join(tmp, name + ".gmexp")
        serving.save_exported(exp, path, serving.artifact_meta(
            exp, cfg, kind=name, n_frames=n_frames))
        t0 = time.perf_counter()
        art = serving.load_exported(path)
        load_s = time.perf_counter() - t0
        out = {}

        def call():
            out["got"] = serving.call_longform(art, mesh, *args)
            return 0
        _, counts = drive(f"serving {name} artifact, {LONG_SECONDS / 60:g} "
                          f"min over {N_SHARDS} frame shards", call, must)
        want = live_lf[name](*live_args)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(out["got"].shards,
                                                     want.shards)):
            raise AssertionError(f"{name} artifact differs from the sharded "
                                 f"program on the card")
        del out, want
        # warm calls, each from the whole input: the artifact with
        # call_longform's sharding, the sharded program with shard_array's
        live_fn = live_lf[name]
        a_ms = cuda_ms(lambda: serving.call_longform(art, mesh, *args), 5, 1)
        l_ms = cuda_ms(lambda: live_fn(shard_array(args[0], mesh),
                                       *live_args[1:]), 5, 1)
        a_us = host_us(lambda: serving.call_longform(art, mesh, *args), 5)
        l_us = host_us(lambda: live_fn(shard_array(args[0], mesh),
                                       *live_args[1:]), 5)
        log(f"serving {name}: {exp.in_shapes} -> {exp.out_shapes}, built in "
            f"{build_s:.2f} s, loaded in {load_s:.2f} s; bit-equal to the "
            f"sharded program; launches {counts}; device {a_ms:.4f} ms a call "
            f"(the sharded program {l_ms:.4f}, ratio {a_ms / l_ms:.3f}); host "
            f"enqueue {a_us:.1f} us (the sharded program {l_us:.1f})")
    del spec_l, logmel_l, x_sh, xl

    # the export tool and its header reader
    path = os.path.join(tmp, "cli_mel_enc.gmexp")
    t0 = time.perf_counter()
    if tools_main(["export", "mel-enc", path, "--seconds", str(SECONDS),
                   "--sample-rate", str(SAMPLE_RATE)]) != 0:
        raise AssertionError("export mel-enc failed")
    cli_s = time.perf_counter() - t0
    if tools_main(["info", path]) != 0:
        raise AssertionError("info failed")
    art = serving.load_exported(path)
    got = art.call(x)
    torch.cuda.synchronize()
    if not torch.equal(got, enc_m):
        raise AssertionError("the export tool's mel-enc artifact differs from "
                             "the eager path")
    log(f"export mel-enc (the CLI, {cli_s:.2f} s) and info: header "
        f"{serving.read_artifact_meta(path)['in_shapes']}, bit-equal to the "
        f"eager path")

def median_s(fn, runs: int = 3) -> float:
    """Median host-clock seconds of ``runs`` calls, each ended by a
    synchronise."""
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return float(np.median(out))


def native_png_checks(tmp: str, phase_png: str) -> None:
    """The native PNG scanline filter (native/pngfilter.cpp) on this host:
    it loaded (a failed build logs a warning and leaves ``get_lib()`` None);
    ``write_png`` through ``png_filter_up`` gives the numpy path's bytes on
    the 30 s phase image; PNGs whose rows carry each of the five filter
    types (tools/png_filters.py) at 8 and 16 bits, color types 0, 2, 4, 6,
    odd widths and one row read back as their image through ``png_unfilter``
    and through the numpy path. Prints ``read_png``'s host time, native
    against numpy, on the 30 s phase PNG (Up rows) and on the same image
    with Sub rows and with Paeth rows, medians of 3."""
    from gomel_tpu_torch.io import _native, pngcodec
    from tools.png_filters import numpy_path, png_bytes

    if _native.get_lib() is None:
        raise AssertionError("the native PNG filter did not build or load")

    img = pngcodec.read_png(phase_png)
    a, b = os.path.join(tmp, "up_native.png"), os.path.join(tmp, "up_np.png")
    pngcodec.write_png(a, img)
    numpy_path(lambda: pngcodec.write_png(b, img))()
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError("write_png: png_filter_up's bytes differ "
                                 "from the numpy path's")
    rng = np.random.default_rng(SEED + 19)
    path = os.path.join(tmp, "filters.png")
    cases = 0
    for dtype in (np.uint8, np.uint16):
        for shape in ((7, 13), (5, 11, 2), (6, 9, 3), (9, 31, 4), (1, 17, 4)):
            src = rng.integers(0, np.iinfo(dtype).max + 1, size=shape,
                               dtype=dtype)
            for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
                with open(path, "wb") as f:
                    f.write(png_bytes(src, filters))
                got = pngcodec.read_png(path)
                ref = numpy_path(lambda: pngcodec.read_png(path))()
                if not (np.array_equal(got, ref)
                        and np.array_equal(got, src)):
                    raise AssertionError(f"read_png {shape} {dtype.__name__} "
                                         f"filters {filters}: native and "
                                         f"numpy paths differ")
                cases += 1
    log(f"native PNG filter: loaded ({_native._pngfilter._so}); write_png of "
        f"the 30 s phase image {img.shape} byte-equal to the numpy path; "
        f"{cases} PNGs with each filter type (8 and 16 bits, color types 0, "
        f"2, 4, 6, odd widths, one row) equal on both paths and to their "
        f"image")
    times = []
    for label, filters in (("Up (the port's writer)", None), ("Sub", [1]),
                           ("Paeth", [4])):
        p = phase_png
        if filters is not None:
            p = os.path.join(tmp, f"phase_{filters[0]}.png")
            with open(p, "wb") as f:
                f.write(png_bytes(img, filters))
        nat = median_s(lambda: pngcodec.read_png(p))
        ref = median_s(numpy_path(lambda: pngcodec.read_png(p)))
        if not np.array_equal(pngcodec.read_png(p), img):
            raise AssertionError(f"read_png of the {label} rows")
        times.append(f"{label} native {1e3 * nat:.3f} ms, numpy "
                     f"{1e3 * ref:.3f} ms ({ref / nat:.1f}x)")
    log(f"  read_png of the 30 s phase PNG {img.shape} {img.dtype} "
        f"({os.path.getsize(phase_png) / 1e6:.2f} MB), host clock, median of "
        f"3: " + "; ".join(times))


def compat_phase(tmp: str, drive, card: str, wav: str,
                 walls: dict[str, float], device: str = "cuda") -> None:
    """Phase 3i: the compat drop-in (``gomel_tpu_torch.compat.phase``, the
    reference Python port's ``import phase``) on ``device``.
    ``Phase(sample_rate=48000)`` runs ``to_phase_wav`` then ``to_wav_png``
    on phase 3's 30 s 48 kHz WAV with device quantize off and on, in 8-bit,
    IHS and HDR; ``to_phase_flac`` then ``to_wav_png`` run on a 30 s 16 kHz
    FLAC (the zero-stuff ingest and the rate rescale) in both quantize
    modes. Each call goes through ``drive`` with the kernels it must launch:
    KA, KE, KF on a device-quantize encode (KA's zero-stuff kernel on the
    FLAC), KE on a float encode, KG and KH on every decode. Each PNG is
    held to the same call with ``device="cpu"`` (1 step, 2 at 16 bits, at a
    flip rate < 2e-3, equal metadata in the "py" layout), each WAV to the
    CPU decode of the same PNG (1 LSB at < 5e-2 differing), and the 48 kHz
    round trip to its input (correlation > 0.99). Then the native PNG
    filter (``native_png_checks``). Prints each file call's wall (median of
    3) beside phase 3b's ``tophase`` / ``fromphase`` walls."""
    from gomel_tpu_torch.compat import phase as compat
    from gomel_tpu_torch.io import audio as audio_io
    from gomel_tpu_torch.io import flac, imagecodec, wavcodec
    from gomel_tpu_torch.io.pngcodec import read_png

    def rc0(fn, *args):
        """``drive`` wants a return code: the file calls return None or the
        rate written."""
        return lambda: (fn(*args), 0)[1]

    flac16 = os.path.join(tmp, "compat16k.flac")
    rng = np.random.default_rng(SEED + 20)
    flac.write_flac(flac16, seeded_pcm_rate(rng, 30 * 16000, 16000), 16000)
    x_in, _ = audio_io.load_wav(wav)
    rows = []
    cases = [(label, dq, src) for dq in (False, True)
             for label, src in (("8bit", wav), ("ihs", wav), ("hdr", wav),
                                ("flac 16 kHz", flac16))]
    for label, dq, src in cases:
        hdr, ihs = label == "hdr", label == "ihs"
        is_flac = src == flac16
        tag = f"compat.phase {label}, device quantize {dq}"
        stem = os.path.join(tmp, f"compat_{label.split()[0]}_{int(dq)}")
        png_g, png_c = stem + "_gpu.png", stem + "_cpu.png"
        out_g, out_c = stem + "_gpu.wav", stem + "_cpu.wav"
        enc_name = "to_phase_flac" if is_flac else "to_phase_wav"

        def make(dev):
            return compat.Phase(sample_rate=48000, HDR=hdr, IHS=ihs,
                                device_quantize=dq, device=dev)

        if dq:
            ingest = "pcm16_ingest zero-stuff" if is_flac else "pcm16_ingest"
            must = (ingest, "phase_encode", "quantize_planes")
        else:
            must = ("phase_encode",)
        t_enc, _ = drive(f"{tag}: {enc_name}",
                         rc0(getattr(make(device), enc_name), src, png_g),
                         must)
        rate = []
        t_dec, _ = drive(f"{tag}: to_wav_png",
                         rc0(lambda: rate.append(make(device).to_wav_png(
                             png_g, out_g))),
                         ("irfft_window", "overlap_normalize"))
        getattr(make("cpu"), enc_name)(src, png_c)
        rate_c = make("cpu").to_wav_png(png_g, out_c)
        d = png_steps(png_g, png_c, read_png)
        flips = float((d > 0).mean())
        meta_g = imagecodec.load_phase_image_raw(png_g, True, hdr, "py")[1:]
        meta_c = imagecodec.load_phase_image_raw(png_c, True, hdr, "py")[1:]
        meta_eq = all(np.array_equal(u, v) for u, v in zip(meta_g, meta_c))
        wg, sr_g = wavcodec.read_wav(out_g)
        wc, sr_c = wavcodec.read_wav(out_c)
        lsb = np.abs(wg.astype(np.int64) - wc.astype(np.int64))
        steps = 2 if hdr else 1
        log(f"{tag}: PNG {read_png(png_g).shape} {device} vs cpu max step "
            f"{int(d.max())}, flip rate {flips:.2e} (bounds {steps}, 2e-3), "
            f"metadata equal {meta_eq} (rate {float(meta_g[3])}); WAV "
            f"{wg.shape} @ {sr_g} Hz against the cpu decode of the same PNG "
            f"max {int(lsb.max())} LSB, differing "
            f"{float((lsb > 0).mean()):.2e} (bounds 1, 5e-2); returned rate "
            f"{rate[0]}")
        if d.max() > steps or flips >= 2e-3 or not meta_eq:
            raise AssertionError(f"{tag}: PNG differs from the CPU path")
        if sr_g != sr_c or wg.shape != wc.shape or lsb.max() > 1 \
                or float((lsb > 0).mean()) >= 5e-2 or rate[0] != rate_c:
            raise AssertionError(f"{tag}: WAV differs from the CPU path")
        if is_flac:
            # 16 kHz zero-stuffed x3: the recorded rate is rescaled to 48 kHz
            if float(meta_g[3]) != 48000.0 or rate[0] != 48000:
                raise AssertionError(f"{tag}: rate {meta_g[3]}, returned "
                                     f"{rate[0]}; expected 48000")
        else:
            y_out, _ = audio_io.load_wav(out_g)
            n_c = min(len(x_in), len(y_out))
            corr = float(np.corrcoef(x_in[4096:n_c - 4096],
                                     y_out[4096:n_c - 4096])[0, 1])
            log(f"  WAV -> PNG -> WAV correlation {corr:.6f} (bound 0.99)")
            if corr <= 0.99:
                raise AssertionError(f"{tag}: round-trip correlation {corr}")
        enc_s = median_s(lambda: getattr(make(device), enc_name)(src, png_g))
        dec_s = median_s(lambda: make(device).to_wav_png(png_g, out_g))
        rows.append(f"{label} dq {int(dq)}: {enc_name} {1e3 * enc_s:.3f} ms, "
                    f"to_wav_png {1e3 * dec_s:.3f} ms (first calls "
                    f"{1e3 * t_enc:.3f}, {1e3 * t_dec:.3f})")
    log(f"compat.phase file calls on {card}, host clock, median of 3 after "
        f"the driven call (30 s of audio each): " + "; ".join(rows))
    log(f"  beside phase 3b on the same 30 s WAV (device quantize, the go "
        f"layout): tophase {walls['tophase']:.3f} ms, fromphase "
        f"{walls['fromphase']:.3f} ms")
    native_png_checks(tmp, os.path.join(tmp, "compat_8bit_1_gpu.png"))


def offset_view(t: torch.Tensor, offset: int) -> torch.Tensor:
    """``t`` copied into a card buffer ``offset`` elements past its start (a
    base off 16 bytes unless offset is a multiple of 16 bytes)."""
    flat = torch.zeros(t.numel() + offset + 8, dtype=t.dtype, device=t.device)
    view = flat[offset:offset + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def ka_odd_checks(dev: torch.device, pcm: torch.Tensor) -> None:
    """KA in its three modes (mono and stereo, zero-stuff at every pair of
    the pad-shift table, per-row scales) on the bench rows cut to odd
    lengths, with bases 1 and 3 int16 off 16 bytes and rows whose starts
    fall off 16 bytes, padded and not: bit-equal to the plain version."""
    from gomel_tpu_torch.core.config import PAD_SHIFT_TABLE
    from gomel_tpu_torch.ops import quantize
    f32 = torch.float32
    scales = torch.tensor([32768.0, 65536.0], device=dev)
    checked = 0
    for n in (pcm.shape[1] - 1, 48001, 7):
        rows = pcm[:, :n].contiguous()
        for offset in (1, 3):
            src = offset_view(rows, offset)
            st = offset_view(rows.reshape(-1)[:2 * (n // 2)].reshape(-1, 2)
                             .contiguous(), offset)
            for pad in (0, 1283):
                cases = [("mono", quantize.pcm16_ingest_batch(
                              src, f32, 32768.0, n + pad),
                          quantize.pcm16_ingest_plain(
                              rows, f32, 32768.0, n + pad, batched=True)),
                         ("stereo", quantize.pcm16_ingest(
                             st, f32, 65536.0, n + pad),
                          quantize.pcm16_ingest_plain(
                              st, f32, 65536.0, n + pad)),
                         ("per-row", quantize.pcm16_ingest_batch(
                             src, f32, scales, n + pad),
                          quantize.pcm16_ingest_plain(
                              rows, f32, scales, n + pad, batched=True))]
                for zp, zs in sorted({p for p in PAD_SHIFT_TABLE.values()
                                      if p[0]}):
                    up = n + -(-n // zp) * zs
                    cases.append((f"zero-stuff ({zp}, {zs})",
                                  quantize.pcm16_ingest_batch(
                                      src, f32, 32768.0, up + pad, zp, zs),
                                  quantize.pcm16_ingest_plain(
                                      rows, f32, 32768.0, up + pad,
                                      batched=True, zp=zp, zs=zs)))
                torch.cuda.synchronize()
                for label, got, want in cases:
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"pcm16_ingest ({label}, n {n}, base {offset} "
                            f"int16 off, pad {pad}) differs from its plain "
                            f"version")
                    checked += 1
    log(f"KA pcm16_ingest at odd lengths ({pcm.shape[1] - 1}, 48001, 7), "
        f"bases 1 and 3 int16 off 16 bytes, padded and not: mono, stereo, "
        f"per-row scales and zero-stuff at every pad-shift pair bit-exact "
        f"({checked} cases)")


def pcm16_fused_checks(dev: torch.device, pcm: torch.Tensor,
                       pcm4: torch.Tensor, scales4: torch.Tensor,
                       win: torch.Tensor, fwd: torch.Tensor, n: int,
                       hop: int, padded: int) -> None:
    """The fused launch's int16 mode bit-equal to KA followed by the float
    fused launch: the bench shape, a row whose length is not a multiple of
    the hop, a row shorter than one frame, per-row scales, and the batch
    shape with its empty row (all zeros)."""
    from gomel_tpu_torch.ops import mel_ops, quantize
    f32 = torch.float32
    empty = pcm4.clone()
    empty[3] = 0
    cases = (
        ("the bench shape", pcm, 32768.0, padded),
        ("L = 100,001, not a multiple of the hop", pcm[0, :100001].contiguous(),
         65536.0, (100001 // hop + 1) * hop),
        ("L = 3,000 < n", pcm[1, :3000].contiguous(), 32768.0, n),
        ("per-row scales", pcm4, scales4, 0),
        ("the batch shape with its empty row", empty, scales4, 0),
    )
    for label, src, scale, pad_to in cases:
        before = (mel_ops.FUSED_PCM16_KERNEL.launches,
                  quantize.INGEST_KERNEL.launches)
        got = mel_ops.stft_mel_log_pcm16(src, scale, pad_to, win, n, hop, fwd)
        if (mel_ops.FUSED_PCM16_KERNEL.launches - before[0],
                quantize.INGEST_KERNEL.launches - before[1]) != (1, 0):
            raise AssertionError(f"stft_mel_log_pcm16 ({label}): not one "
                                 f"launch of its own")
        batched = src.ndim == 2
        x = quantize.pcm16_ingest_plain(src, f32, scale, pad_to,
                                        batched=batched)
        want = mel_ops.stft_mel_log(x, win, n, hop, fwd)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"stft_mel_log_pcm16 ({label}) differs from "
                                 f"KA followed by the fused launch")
        log(f"fused KB + KC int16 mode, {label} {tuple(src.shape)} -> "
            f"{tuple(got.shape)}: bit-equal to KA then the float launch")


# -- phase 3j: the multi-process form --------------------------------------

MP_TIMEOUT_S = 600      # each worker's limit, and the group's collectives'
MP_RUNS = 7             # timed runs of each call, after one untimed
HALO_RUNS = 50          # timed halo exchanges of each direction
# the host link of the card (PCIe Gen5 x16, one direction): the byte bound
# of a halo staged through host memory, a D2H and an H2D of its bytes
PCIE_BYTES_S = 64e9
# NVLink between two cards of a host, one direction: the byte bound of a
# halo that NCCL moves card to card
NVLINK_BYTES_S = 450e9
# kernels each worker's call must launch (from its own tallies)
MP_MUST = {
    "LongFormPhase.encode": ("phase_encode",),
    "LongFormPhase.decode": ("irfft_window_masked", "overlap_normalize",
                             "shard_epilogue"),
    "LongFormMel.encode": ("stft_mel_log",),
    "LongFormMel.decode": ("mel_to_magnitudes", "gl_project",
                           "gl_overlap_add", "shard_epilogue",
                           "threefry_uniform"),
    "decode_resumable, saved at iteration 1": (
        "mel_to_magnitudes", "gl_project", "gl_overlap_add",
        "shard_epilogue", "threefry_uniform"),
    "decode_resumable, resumed": ("mel_to_magnitudes", "gl_project",
                                  "gl_overlap_add", "shard_epilogue"),
    "BatchedMel.encode(process_local)": ("stft_mel_log",),
    "BatchedMel.decode(process_local)": ("mel_to_magnitudes", "gl_project",
                                         "gl_overlap_add",
                                         "threefry_uniform")}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sha(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _piece_hashes(value) -> dict[str, str]:
    """sha256 of each of this process's pieces of a long-form result, keyed
    by its global rows and columns."""
    return {",".join(f"{s.start}-{s.stop}" for s in p.index[:2]): _sha(p.data)
            for p in value.addressable_shards}


def _ref_hashes(full: torch.Tensor, keys) -> dict[str, str]:
    """sha256 of the same pieces of a one-controller result."""
    out = {}
    for key in keys:
        (r0, r1), (c0, c1) = (tuple(int(v) for v in p.split("-"))
                              for p in key.split(","))
        out[key] = _sha(full[r0:r1, c0:c1])
    return out


class _MpRun:
    """One worker's record: each call's walls between barriers (``runs``
    timed runs after an untimed one, or one run when ``warm`` is False) and
    its launches (the last run's), its results' hashes."""

    def __init__(self, tallies: dict, dev: torch.device):
        self.tallies, self.dev = tallies, dev
        self.report: dict = {"calls": {}, "hashes": {}}

    def call(self, label: str, fn, warm: bool = True):
        import torch.distributed as dist
        walls = []
        for _ in range(1 + MP_RUNS if warm else 1):
            for k in self.tallies.values():
                k.launches = 0
            dist.barrier()
            t0 = time.perf_counter()
            value = fn()
            _sync(self.dev)
            dist.barrier()
            walls.append(time.perf_counter() - t0)
        self.report["calls"][label] = {
            "s": walls[1:] if warm else walls,
            "launches": {n: k.launches for n, k in self.tallies.items()
                         if k.launches}}
        return value


def _one_controller_walls(fn, dev: torch.device):
    """``fn``'s value and its walls: MP_RUNS timed runs after an untimed
    one."""
    walls = []
    for _ in range(1 + MP_RUNS):
        t0 = time.perf_counter()
        value = fn()
        _sync(dev)
        walls.append(time.perf_counter() - t0)
    return value, walls[1:]


def _spread(seconds: list) -> str:
    """Median (min-max) of walls in seconds, as ms."""
    ms = 1e3 * np.asarray(seconds)
    return (f"{np.median(ms):.3f} ({ms.min():.3f}-{ms.max():.3f})"
            if len(ms) > 1 else f"{ms[0]:.3f}")


def worker_device(backend: str, device: str, rank: int) -> str:
    """A phase 3j worker's device: its own card on NCCL (NCCL drives one
    card a process), else ``device``, shared by every worker."""
    return f"cuda:{rank}" if backend == "nccl" else device


def longform_mesh_devices(dev: torch.device, world: int) -> list:
    """A long-form worker's devices of the 1 x N_SHARDS mesh."""
    return [dev] * (N_SHARDS // world)


def _gather_keys(report: dict) -> list:
    import torch.distributed as dist
    from gomel_tpu_torch.parallel import mesh as pm
    keys = {name: sorted(h) for name, h in report["hashes"].items()}
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, keys, group=pm.host_group())
    return out


def mp_longform(rank: int, world: int, dev: torch.device, seconds: float,
                out_dir: str, tallies: dict) -> dict:
    """The long-form calls of phase 3j on a 1 x 4 mesh over ``world``
    processes, frame shards 4 / world a process on ``dev``; rank 0 then runs
    the same calls on one controller (a 1 x 4 mesh of ``dev``) and hashes
    every process's pieces of them."""
    import torch.distributed as dist
    from gomel_tpu_torch import (LongFormMel, LongFormPhase, MelConfig,
                                 Mesh, PhaseConfig, make_mesh)
    from gomel_tpu_torch.parallel import sharded as sh
    from gomel_tpu_torch.pipelines import longform as lf

    n = int(SAMPLE_RATE * seconds)
    x = (long_pcm(n, dev).astype(np.float32) / np.float32(32768.0))[None]
    mesh = make_mesh(data=1, frame=N_SHARDS,
                     devices=longform_mesh_devices(dev, world))
    pcfg, mcfg = PhaseConfig.cli_default(), MelConfig.cli_default()
    lp, lm = LongFormPhase(pcfg, mesh), LongFormMel(mcfg, mesh)
    run = _MpRun(tallies, dev)
    hashes = run.report["hashes"]
    spec = run.call("LongFormPhase.encode", lambda: lp.encode(x))
    hashes["phase spectrogram"] = _piece_hashes(spec)
    hashes["phase audio"] = _piece_hashes(run.call(
        "LongFormPhase.decode", lambda: lp.decode(spec)))
    del spec
    logmel = run.call("LongFormMel.encode", lambda: lm.encode(x))
    hashes["log-mel"] = _piece_hashes(logmel)
    hashes["mel audio"] = _piece_hashes(run.call(
        "LongFormMel.decode", lambda: lm.decode(logmel, seed=1)))
    ckpt = os.path.join(out_dir, "ckpt")

    def save(done, carry):
        if done == 1:
            lf.save_gl_checkpoint_sharded(ckpt, done, carry)
    hashes["mel audio, resumable"] = _piece_hashes(run.call(
        "decode_resumable, saved at iteration 1", lambda: lm.decode_resumable(
            logmel, seed=1, segment_iters=1, callback=save), warm=False))
    done, carry = lf.load_gl_checkpoint_sharded(ckpt, mesh)
    run.report["resumed_from"] = done
    hashes["mel audio, resumed"] = _piece_hashes(run.call(
        "decode_resumable, resumed", lambda: lm.decode_resumable(
            logmel, seed=1, segment_iters=1, resume=(done, carry)),
        warm=False))

    # one halo exchange of each direction at the 30-minute plan
    plan = lp._plan(n)
    exts = [torch.zeros((1, plan.chunk + plan.halo), device=mesh.device(i))
            if mesh.is_local(i) else None for i in range(mesh.size)]
    halo = {}
    for name, fn in (("pull", lambda: sh._pull_right_halo(exts, mesh, plan)),
                     ("push", lambda: sh._push_tail_right(exts, mesh, plan))):
        times = []
        for _ in range(HALO_RUNS):
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            times.append(time.perf_counter() - t0)
        halo[name] = times
    crossing = sum(1 for i in range(mesh.size - 1)
                   if mesh.rank(i) != mesh.rank(i + 1))
    run.report["halo"] = {"s": halo, "bytes": crossing * plan.halo * 4,
                          "messages": crossing}
    keys = _gather_keys(run.report)
    if rank == 0:   # one controller: this process owns every cell
        mesh1 = Mesh([[dev] * N_SHARDS])
        lp1, lm1 = LongFormPhase(pcfg, mesh1), LongFormMel(mcfg, mesh1)
        walls, ref = {}, {}
        spec1, walls["LongFormPhase.encode"] = _one_controller_walls(
            lambda: lp1.encode(x), dev)
        wave1, walls["LongFormPhase.decode"] = _one_controller_walls(
            lambda: lp1.decode(spec1), dev)
        logmel1, walls["LongFormMel.encode"] = _one_controller_walls(
            lambda: lm1.encode(x), dev)
        mel1, walls["LongFormMel.decode"] = _one_controller_walls(
            lambda: lm1.decode(logmel1, seed=1), dev)
        for name, full in (("phase spectrogram", spec1),
                           ("phase audio", wave1), ("log-mel", logmel1),
                           ("mel audio", mel1),
                           ("mel audio, resumable", mel1),
                           ("mel audio, resumed", mel1)):
            ref[name] = _ref_hashes(full, {k for r in keys for k in r[name]})
        exts1 = [torch.zeros((1, plan.chunk + plan.halo), device=dev)
                 for _ in range(N_SHARDS)]
        times = []
        for _ in range(HALO_RUNS):
            t0 = time.perf_counter()
            sh._pull_right_halo(exts1, mesh1, plan)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        run.report["one_controller"] = {
            "walls": walls, "hashes": ref, "halo_pull_s": times}
    dist.barrier()
    return run.report


def batch_row(k: int, n: int) -> np.ndarray:
    """The 'file' utt<k> of phase 3j's batch: n samples, 48 kHz float32."""
    return (seeded_pcm(np.random.default_rng(SEED + 100 + k), 1, n)[0]
            .astype(np.float32) / np.float32(32768.0))


def mp_batch(rank: int, world: int, dev: torch.device, seconds: float,
             out_dir: str, tallies: dict) -> dict:
    """BatchedMel(input_mode="process_local") on a 2 x 2 mesh over 4
    processes (both axes crossing processes, one cell each on ``dev``), two
    rows of ``seconds`` a group picked by shard_files_for_group; rank 0 then
    runs the same on one controller over a 2 x 2 mesh of ``dev``."""
    from gomel_tpu_torch import MelConfig, Mesh, make_mesh
    from gomel_tpu_torch.core.framing import pad_length
    from gomel_tpu_torch.io.dataset import shard_files_for_group
    from gomel_tpu_torch.parallel import mesh as pm
    from gomel_tpu_torch.parallel.batch import BatchedMel
    del out_dir
    cfg = MelConfig.cli_default()
    n = pad_length(int(SAMPLE_RATE * seconds), cfg.window)
    mesh = make_mesh(data=2, frame=2, devices=[dev])
    files = [f"utt{k}" for k in range(4)]
    mine = shard_files_for_group(files, mesh)
    gi, ng = pm.data_group_for_process(mesh)
    rows = np.stack([batch_row(int(f[3:]), n) for f in mine])
    bm = BatchedMel(cfg, mesh=mesh, input_mode="process_local")
    run = _MpRun(tallies, dev)
    key = f"{gi * len(mine)}-{(gi + 1) * len(mine)},0-0"
    enc = run.call("BatchedMel.encode(process_local)", lambda: bm.encode(rows))
    dec = run.call("BatchedMel.decode(process_local)",
                   lambda: bm.decode(enc, seed=1))
    run.report["hashes"] = {"log-mel rows": {key: _sha(enc)},
                            "audio rows": {key: _sha(dec)}}
    run.report["group"] = [gi, ng, mine]
    keys = _gather_keys(run.report)
    if rank == 0:   # one controller: this process owns every cell
        mesh1 = Mesh([[dev] * 2] * 2)
        bm1 = BatchedMel(cfg, mesh=mesh1)
        everyone = np.stack([batch_row(int(f[3:]), n)
                             for g in range(ng) for f in files[g::ng]])
        walls, ref = {}, {}
        enc1, walls["BatchedMel.encode(process_local)"] = \
            _one_controller_walls(lambda: bm1.encode(everyone), dev)
        dec1, walls["BatchedMel.decode(process_local)"] = \
            _one_controller_walls(lambda: bm1.decode(enc1, seed=1), dev)
        for name, full in (("log-mel rows", enc1), ("audio rows", dec1)):
            ref[name] = {}
            for k in {k for r in keys for k in r[name]}:
                r0, r1 = (int(v) for v in k.split(",")[0].split("-"))
                ref[name][k] = _sha(full[r0:r1])
        run.report["one_controller"] = {"walls": walls, "hashes": ref}
    import torch.distributed as dist
    dist.barrier()
    return run.report


def mp_worker(argv: list[str]) -> int:
    """One process of phase 3j: ``chip_smoke.py --mp-worker SCENARIO RANK
    WORLD PORT OUT_DIR BACKEND DEVICE SECONDS``. Loads the kernels phase 1
    built, joins the group, runs SCENARIO and writes its report to
    OUT_DIR/rank<RANK>.json."""
    scenario, rank, world, port, out_dir, backend, device, seconds = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, HERE)
    import torch.distributed as dist
    from gomel_tpu_torch.ops import _cuda
    from gomel_tpu_torch.parallel import mesh as pm
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is not None:   # NCCL: this worker's own card
            torch.cuda.set_device(dev)
        _cuda.library()
    _, tallies = kernel_tallies()
    pm.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                            backend=backend, timeout_s=MP_TIMEOUT_S)
    try:
        fn = mp_longform if scenario == "longform" else mp_batch
        report = fn(rank, world, dev, float(seconds), out_dir, tallies)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(tmp: str, scenario: str, world: int, backend: str,
                device: str, seconds: float) -> list[dict]:
    """Start ``world`` workers of ``scenario`` together, wait for all (each
    within MP_TIMEOUT_S), kill any left, fail on any non-zero exit; return
    their reports in rank order."""
    out_dir = os.path.join(tmp, f"mp_{scenario}_{backend}")
    os.makedirs(out_dir, exist_ok=True)
    port = str(_free_port())
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--mp-worker",
         scenario, str(r), str(world), port, out_dir, backend,
         worker_device(backend, device, r), str(seconds)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        for r in failed:
            print(f"--- phase 3j worker {r} of {scenario} ({backend}) exit "
                  f"code {procs[r].returncode}:\n{logs[r][-4000:]}",
                  file=sys.stderr)
        raise AssertionError(f"phase 3j {scenario} ({backend}): workers "
                             f"{failed} failed")
    reports = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def check_workers(label: str, reports: list[dict], card: str,
                  launches: dict, backend: str) -> None:
    """Phase 3j's checks of one run: every worker's pieces bit-equal to
    rank 0's one-controller result (by sha256), the kernels of each call
    launched in every worker, and the walls and halo times printed."""
    ref = reports[0]["one_controller"]
    for r, rep in enumerate(reports):
        for name, pieces in rep["hashes"].items():
            for key, h in pieces.items():
                if ref["hashes"][name][key] != h:
                    raise AssertionError(f"{label}: rank {r}'s {name} "
                                         f"[{key}] differs from one "
                                         f"controller's")
        for call, info in rep["calls"].items():
            missing = [k for k in MP_MUST.get(call, ())
                       if not info["launches"].get(k)]
            if missing:
                raise AssertionError(f"{label}: {call} in rank {r} never "
                                     f"launched {missing}")
            for k, c in info["launches"].items():
                if k in launches:
                    launches[k] += c
    n_pieces = sum(len(p) for rep in reports for p in rep["hashes"].values())
    log(f"{label}: all {n_pieces} pieces of {len(reports)} processes "
        f"bit-equal to one controller's (sha256); every call launched its "
        f"kernels in every process")
    log(f"  walls on {card}, ms (host clock between barriers, rank 0; median "
        f"(min-max) of {MP_RUNS} runs after an untimed one; then one "
        f"controller's, the same calls in one process, and the ratio of the "
        f"medians):")
    for c, info in reports[0]["calls"].items():
        line = f"    {c}: {_spread(info['s'])}"
        if c in ref["walls"]:
            one = ref["walls"][c]
            line += (f"; one controller {_spread(one)}; ratio "
                     f"{np.median(info['s']) / np.median(one):.3f}")
        log(line)
    for r, rep in enumerate(reports):
        log(f"  rank {r} launches: " + "; ".join(
            f"{c}: {info['launches']}" for c, info in rep["calls"].items()))
    if "halo" in reports[0]:
        h = reports[0]["halo"]
        if backend == "nccl":
            how, rate = "NCCL card to card", NVLINK_BYTES_S
            bound = h["bytes"] / rate * 1e3
            link = f"one copy at {rate / 1e9:.0f} GB/s (NVLink)"
        else:
            how, rate = "gloo over host memory (D2H, send/recv, H2D)", \
                PCIE_BYTES_S
            bound = 2 * h["bytes"] / rate * 1e3
            link = f"a D2H and an H2D at {rate / 1e9:.0f} GB/s"
        log(f"  one halo exchange on {card}, {how}, ms, median (min-max) of "
            f"{HALO_RUNS}: pull {_spread(h['s']['pull'])}, push "
            f"{_spread(h['s']['push'])}, {h['bytes']} bytes in "
            f"{h['messages']} message(s) across processes; byte bound "
            f"({link}) {bound:.6f} ms; one controller's pull (device "
            f"copies) {_spread(ref['halo_pull_s'])}")
        log(f"  decode_resumable resumed from iteration "
            f"{reports[0]['resumed_from']} of the sharded checkpoint")


def multiprocess(tmp: str, card: str, launches: dict, device: str = "cuda",
                 seconds: float = LONG_SECONDS,
                 batch_seconds: float = SECONDS) -> None:
    """Phase 3j: the multi-process form on the card. LongFormPhase and
    LongFormMel encode and decode (GL-2) of the 30-minute signal on a 1 x 4
    mesh over 2 processes (2 frame shards each on the card, gloo: the halos
    staged through host memory), decode_resumable through a sharded
    checkpoint saved at iteration 1, loaded and resumed; BatchedMel
    (input_mode="process_local") encode and decode of two 30 s rows a group
    on a 2 x 2 mesh over 4 processes. Every process's pieces bit-equal to
    the same calls on one controller; their kernels' launches added to
    ``launches``. The NCCL route (one card a process) runs only where the
    card count reaches the processes."""
    log(f"phase 3j: the multi-process form on {card}")
    reports = run_workers(tmp, "longform", 2, "gloo", device, seconds)
    check_workers(f"long form, {seconds / 60:g} min, 1 x {N_SHARDS} mesh "
                  f"over 2 processes (gloo)", reports, card, launches, "gloo")
    reports = run_workers(tmp, "batch", 4, "gloo", device, batch_seconds)
    check_workers(f"BatchedMel(process_local), 2 x {batch_seconds:g} s a "
                  f"group, 2 x 2 mesh over 4 processes (gloo)", reports, card,
                  launches, "gloo")
    visible = torch.cuda.device_count() if device == "cuda" else 0
    if visible >= 2:
        reports = run_workers(tmp, "longform", 2, "nccl", device, seconds)
        check_workers("long form over 2 processes on 2 cards (NCCL)",
                      reports, card, launches, "nccl")
    else:
        log(f"  NCCL route not run: {visible} card(s) visible, and NCCL "
            f"refuses two ranks on one card (make_mesh raises); it runs "
            f"where the card count reaches the process count")


def call_surface(dev: torch.device, tallies: dict, x: torch.Tensor,
                 pcm: torch.Tensor, win: torch.Tensor, fwd: torch.Tensor,
                 mels: int, nf: int, n: int, hop: int) -> None:
    """Phase 2h: the JAX call surface of the encodes and decodes on the card,
    at the bench shape. ``frame_chunk`` on mel_encode_batch and
    phase_encode_batch (float32 rows ``x`` and int16 rows ``pcm``) gives the
    unchunked call's bits with one launch of the encode's kernel a chunk;
    phase_decode with ``frame_chunk`` stays one KG and one KH launch within
    1e-5 of the unchunked decode's peak, and a chunk under N - hop raises
    the JAX program's ValueError; chunked_irfft_overlap_add with a prefix
    frame_mask gives the real-frame count's bits, and with a scattered one
    is within 1e-5 of the peak of its plain version (torch.fft, the masked
    frames zeroed, the plain overlap-add); ops/mxu_fft's three transforms
    launch KE, KB and KG within 1e-5 of the peak of torch.fft. These
    launches do not count as the main path's."""
    from gomel_tpu_torch.ops import istft, mel_ops, mxu_fft, phase_ops

    def counted(fn):
        for k in tallies.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {name: k.launches for name, k in tallies.items()
                     if k.launches}

    def near(got, want, label):
        err = float((got - want).abs().max())
        peak = float(want.abs().max())
        if not err <= 1e-5 * peak:
            raise AssertionError(f"{label}: max|d| {err:.3e} > 1e-5 of the "
                                 f"peak {peak:.3e}")
        return err, peak

    encodes = (
        ("mel_encode_batch float32", "stft_mel_log", lambda c:
         mel_ops.mel_encode_batch(x, mels, n, hop, fwd, win, "auto", c)),
        ("mel_encode_batch int16", "stft_mel_log pcm16", lambda c:
         mel_ops.mel_encode_batch(pcm, mels, n, hop, fwd, win, "auto", c,
                                  pcm_scale=32768.0)),
        ("phase_encode_batch float32", "phase_encode", lambda c:
         phase_ops.phase_encode_batch(x, nf, n, hop, win, "auto", c)),
        ("phase_encode_batch int16", "phase_encode", lambda c:
         phase_ops.phase_encode_batch(pcm, nf, n, hop, win, "auto", c)))
    for label, kernel, fn in encodes:
        base, base_counts = counted(lambda: fn(None))
        frames = base.shape[1]
        for chunk in (512, 333):
            got, counts = counted(lambda: fn(chunk))
            want = -(-frames // chunk)
            log(f"{label} frame_chunk {chunk}, {tuple(base.shape)}: "
                f"bit-equal {torch.equal(got, base)}; launches {counts} "
                f"(unchunked {base_counts})")
            if not torch.equal(got, base):
                raise AssertionError(f"{label} frame_chunk {chunk} differs "
                                     f"from the unchunked call")
            if counts.get(kernel) != want:
                raise AssertionError(f"{label} frame_chunk {chunk}: {kernel} "
                                     f"launched {counts.get(kernel)} times, "
                                     f"not {want}")
            if label == "mel_encode_batch int16" and any(
                    k.startswith("pcm16_ingest") for k in counts):
                raise AssertionError(f"{label}: KA ran beside the fused "
                                     f"launch's int16 mode")

    spec = phase_ops.phase_encode_batch(x, nf, n, hop, win)
    base, _ = counted(lambda: phase_ops.phase_decode(spec, n, hop, 0.0, win))
    for chunk in (512, 333, 3):
        got, counts = counted(lambda: phase_ops.phase_decode(
            spec, n, hop, 0.0, win, "auto", chunk))
        err, peak = near(got, base, f"phase_decode frame_chunk {chunk}")
        log(f"phase_decode frame_chunk {chunk}, {tuple(got.shape)}: max|d| "
            f"{err:.3e} of peak {peak:.3e} (bound 1e-5 of it), bit-equal "
            f"{torch.equal(got, base)}; launches {counts}")
        if counts != {"irfft_window": 1, "overlap_normalize": 1}:
            raise AssertionError(f"phase_decode frame_chunk {chunk}: "
                                 f"launches {counts}, not one KG and one KH")
    try:
        phase_ops.phase_decode(spec, n, hop, 0.0, win, frame_chunk=1)
    except ValueError as e:
        log(f"phase_decode frame_chunk 1: ValueError {e}")
    else:
        raise AssertionError("phase_decode frame_chunk 1 did not raise")

    re, im = (p.contiguous() for p in phase_ops.grow_half_planes(
        spec[0], n // 2))
    frames = re.shape[0]
    gen = torch.Generator().manual_seed(SEED)
    scattered = torch.rand(frames, generator=gen) < 0.5
    prefix = torch.arange(frames) < frames * 2 // 3
    by_count, _ = counted(lambda: istft.chunked_irfft_overlap_add(
        re, im, hop, win, 512, "auto", real_frames=int(prefix.sum())))
    for label, mask in (("prefix", prefix), ("scattered", scattered)):
        got, counts = counted(lambda: istft.chunked_irfft_overlap_add(
            re, im, hop, win, 512, "auto", mask))
        keep = mask.to(dev)[:, None]
        plain = istft.overlap_add_plain(
            istft.irfft_window_plain(re, im, n, win) * keep, hop)
        err, peak = near(got, plain, f"chunked_irfft_overlap_add {label}")
        log(f"chunked_irfft_overlap_add, {label} frame_mask "
            f"({int(mask.sum())} of {frames} frames): max|d| {err:.3e} of "
            f"peak {peak:.3e} against its plain version (bound 1e-5 of it); "
            f"launches {counts}")
        if label == "prefix" and not torch.equal(got, by_count):
            raise AssertionError("chunked_irfft_overlap_add: a prefix mask "
                                 "differs from its real-frame count")
        synth = "irfft_window_masked" if label == "prefix" else "irfft_window"
        if counts != {synth: 1, "overlap_normalize": 1}:
            raise AssertionError(f"chunked_irfft_overlap_add {label}: "
                                 f"launches {counts}")

    rows = x[:, :64 * n].reshape(-1, n)
    ref = torch.fft.rfft(rows)
    for label, kernel, fn, want in (
            ("rfft re", "phase_encode", lambda: mxu_fft.rfft(rows, n)[0],
             ref.real),
            ("rfft_mag", "stft_mag", lambda: mxu_fft.rfft_mag(rows, n),
             ref.abs()),
            ("irfft", "irfft_window",
             lambda: mxu_fft.irfft(ref.real.contiguous(),
                                   ref.imag.contiguous(), n),
             torch.fft.irfft(ref, n))):
        got, counts = counted(fn)
        err, peak = near(got, want, f"mxu_fft.{label}")
        log(f"ops/mxu_fft.{label}, {tuple(rows.shape)}: max|d| {err:.3e} of "
            f"peak {peak:.3e} against torch.fft; launches {counts}")
        if counts != {kernel: 1}:
            raise AssertionError(f"mxu_fft.{label}: launches {counts}, not "
                                 f"one {kernel}")


def kernel_tallies() -> tuple[dict, dict]:
    """Every kernel of the port by name, and the same with the xla route's
    tally (torch.fft on the card, for the sizes the hand FFT kernels do not
    take; not a kernel of the port)."""
    from gomel_tpu_torch.ops import (dft_mm, fftbackend, griffinlim, istft,
                                     mel_ops, prng, quantize, rfft_mag)
    kernels = {k.name: k for k in (quantize.INGEST_KERNEL,
                                   quantize.INGEST_ZERO_STUFF_KERNEL,
                                   rfft_mag.KERNEL,
                                   mel_ops.KERNEL, mel_ops.FUSED_KERNEL,
                                   mel_ops.FUSED_PCM16_KERNEL,
                                   quantize.QUANTIZE_KERNEL,
                                   rfft_mag.PLANES_KERNEL,
                                   quantize.PLANES_KERNEL,
                                   istft.SYNTH_KERNEL, istft.OLA_KERNEL,
                                   mel_ops.MAG_KERNEL,
                                   griffinlim.PROJECT_KERNEL,
                                   griffinlim.OLA_KERNEL,
                                   quantize.INGEST_ROWS_KERNEL,
                                   quantize.QUANTIZE_MASKED_KERNEL,
                                   quantize.PLANES_MASKED_KERNEL,
                                   quantize.DEQUANTIZE_RAW_KERNEL,
                                   istft.SYNTH_MASKED_KERNEL,
                                   istft.SHARD_KERNEL, dft_mm.FWD_KERNEL,
                                   dft_mm.FWD_F32_KERNEL, dft_mm.INV_KERNEL,
                                   dft_mm.INV_F32_KERNEL, prng.KERNEL)}
    return kernels, dict(kernels, xla_route=fftbackend.XLA_ROUTE)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from gomel_tpu_torch.cli.tools import fromphase, tomel, tophase, towav
    from gomel_tpu_torch.core.config import MelConfig, PhaseConfig, pad_shift
    from gomel_tpu_torch.core.filterbank import inverse_mel_weights, mel_weights
    from gomel_tpu_torch.core.framing import pad_length
    from gomel_tpu_torch.io import audio as audio_io
    from gomel_tpu_torch.io import imagecodec, wavcodec
    from gomel_tpu_torch.io.pngcodec import read_png
    from gomel_tpu_torch.ops import (_cuda, dft_mm, fftbackend, griffinlim,
                                     istft, mel_ops, phase_ops, prng,
                                     quantize, rfft_mag)
    from gomel_tpu_torch.ops.stft import hann_window
    from gomel_tpu_torch.utils.metrics import spectral_convergence

    # the plain references run in full float32 (no TF32 anywhere)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: card and build ------------------------------------------
    card = card_line()
    log(card)
    log(f"torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    from tools import profile_quant
    earlier_job = profile_quant.start_earlier(
        os.path.join(_cuda.BUILD_DIR, "quant_earlier"))
    build_s = _cuda.build()
    _cuda.library()
    log(f"kernel build: {build_s:.2f} s (0 = library already current)")
    with open(os.path.join(_cuda.BUILD_DIR, "build.log")) as f:
        print(f.read(), file=sys.stderr)

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    cfg = MelConfig.cli_default()
    n_fft, hop = cfg.resolut, cfg.window
    length = int(SAMPLE_RATE * SECONDS)
    padded = pad_length(length, hop)
    rng = np.random.default_rng(SEED)
    kernels, tallies = kernel_tallies()
    errs: dict[str, float] = {}
    # launches of each kernel summed over the main-path runs (the CLIs, the
    # batch CLIs, the long-form calls and phase 3f's paths), each read with
    # every count set to 0 just before it
    launches = {name: 0 for name in tallies}

    def drive(label: str, fn, must_run: tuple[str, ...],
              route_ok: bool = False) -> tuple[float, dict[str, int]]:
        """Run one main-path call with the counts at 0; return its wall
        seconds and its launch counts; fail if a kernel of that path did not
        launch, or if the xla route ran on a path whose sizes the hand
        kernels take (``route_ok`` False)."""
        for k in tallies.values():
            k.launches = 0
        t0 = time.perf_counter()
        rc = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {name: k.launches for name, k in tallies.items()
                  if k.launches}
        if rc != 0:
            raise AssertionError(f"{label} returned {rc}")
        log(f"{label}: {seconds:.3f} s wall, launches {counts}")
        missing = [name for name in must_run if counts.get(name, 0) < 1]
        if missing:
            raise AssertionError(f"{label}: kernels of the path never ran: "
                                 f"{missing}")
        if not route_ok and counts.get("xla_route"):
            raise AssertionError(f"{label}: the xla route ran at a size the "
                                 f"hand kernels take")
        for name, c in counts.items():
            launches[name] += c
        return seconds, counts

    # -- phase 2: each kernel against its plain version, bench shape -------
    pcm = torch.from_numpy(seeded_pcm(rng, BATCH, length)).to(dev)
    x = quantize.pcm16_ingest_batch(pcm, f32, 32768.0, padded)
    x_ref = quantize.pcm16_ingest_plain(pcm, f32, 32768.0, padded, batched=True)
    stereo = pcm[:, :length // 2].reshape(-1, 2).contiguous()
    st = quantize.pcm16_ingest(stereo, f32, 65536.0, padded)
    st_ref = quantize.pcm16_ingest_plain(stereo, f32, 65536.0, padded)
    torch.cuda.synchronize()
    if not (torch.equal(x, x_ref) and torch.equal(st, st_ref)):
        raise AssertionError("pcm16_ingest differs from its plain version")
    errs["pcm16_ingest"] = max(float((x - x_ref).abs().max()),
                               float((st - st_ref).abs().max()))
    log(f"KA pcm16_ingest [{BATCH}, {length}] -> {tuple(x.shape)}: "
        f"bit-exact, max|d| {errs['pcm16_ingest']}")
    ka_odd_checks(dev, pcm)

    win = torch.tensor(hann_window(n_fft), dtype=f32, device=dev)
    mags = rfft_mag.stft_mag(x, win, n_fft, hop)
    mags_ref = rfft_mag.stft_mag_plain(x, win, n_fft, hop)
    mags_64 = rfft_mag.stft_mag_plain(x.double(), win.double(), n_fft, hop)
    torch.cuda.synchronize()
    row_max = mags_ref.amax(dim=-1, keepdim=True)
    d32 = (mags - mags_ref).abs()
    rel32 = float((d32 / row_max).max())
    rel32_ref64 = float(((mags_ref.double() - mags_64).abs()
                         / mags_64.amax(dim=-1, keepdim=True)).max())
    rel_k64 = float(((mags.double() - mags_64).abs()
                     / mags_64.amax(dim=-1, keepdim=True)).max())
    errs["stft_mag"] = float(d32.max())
    log(f"KB stft_mag -> {tuple(mags.shape)}: max|d| vs torch.fft f32 "
        f"{errs['stft_mag']:.3e}, / row max {rel32:.3e} (bound 1e-5); vs "
        f"float64: kernel {rel_k64:.3e}, torch.fft f32 {rel32_ref64:.3e} "
        f"of row max")
    if not bool((d32 <= 1e-5 * row_max).all()):
        raise AssertionError(f"stft_mag error {rel32:.3e} of row max > 1e-5")

    fwd = torch.tensor(mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin,
                                   cfg.mel_fmax), dtype=f32, device=dev)
    logmel = mel_ops._mel_from_mags(mags_ref, fwd)
    logmel_ref = mel_ops.mel_from_mags_plain(mags_ref, fwd)
    torch.cuda.synchronize()
    live = logmel_ref > math.log(1e-4)
    d_log = (logmel - logmel_ref).abs()
    errs["mel_log"] = float(d_log[live].max())
    log(f"KC mel_log -> {tuple(logmel.shape)}: max|d log| {errs['mel_log']:.3e} "
        f"where plain mel > 1e-4 ({float(live.float().mean()):.4f} of values; "
        f"bound 1e-5), {float(d_log.max()):.3e} overall")
    if errs["mel_log"] > 1e-5:
        raise AssertionError(f"mel_log error {errs['mel_log']:.3e} > 1e-5")
    # KC at n = 3000 (the mixed radix's magnitudes, 1501 bins a row)
    win3k = torch.tensor(hann_window(3000), dtype=f32, device=dev)
    fwd3k = torch.tensor(mel_weights(1500, cfg.num_mels, cfg.mel_fmin,
                                     cfg.mel_fmax), dtype=f32, device=dev)
    mags3k = rfft_mag.stft_mag_plain(x, win3k, 3000, 750)
    ref3k = mel_ops.mel_from_mags_plain(mags3k, fwd3k)
    got3k = mel_ops._mel_from_mags(mags3k, fwd3k)
    torch.cuda.synchronize()
    d3k = float((got3k - ref3k).abs()[ref3k > math.log(1e-4)].max())
    log(f"KC mel_log at n = 3000 -> {tuple(got3k.shape)}: max|d log| "
        f"{d3k:.3e} where plain mel > 1e-4 (bound 1e-5)")
    if d3k > 1e-5:
        raise AssertionError(f"mel_log error at n = 3000 {d3k:.3e} > 1e-5")
    errs["mel_log"] = max(errs["mel_log"], d3k)
    # the fused KB + KC launch: KB followed by KC bit for bit, NaN frames too
    xn = x.clone()
    xn[1, 7 * hop + 100] = float("nan")
    fused = mel_ops.stft_mel_log(x, win, n_fft, hop, fwd)
    fused_n = mel_ops.stft_mel_log(xn, win, n_fft, hop, fwd)
    two_n = mel_ops._mel_from_mags(rfft_mag.stft_mag(xn, win, n_fft, hop), fwd)
    torch.cuda.synchronize()
    if not (torch.equal(fused, mel_ops._mel_from_mags(mags, fwd))
            and torch.equal(fused_n.isnan(), two_n.isnan())
            and bool(fused_n.isnan().any())
            and torch.equal(fused_n.nan_to_num(0.0), two_n.nan_to_num(0.0))):
        raise AssertionError("the fused KB + KC launch differs from KB "
                             "followed by KC")
    fused_ref = mel_ops.stft_mel_log_plain(x, win, n_fft, hop, fwd)
    errs["stft_mel_log"] = float((fused - fused_ref).abs()[
        fused_ref > math.log(1e-4)].max())
    log(f"fused KB + KC stft_mel_log -> {tuple(fused.shape)}: bit-equal to "
        f"KB then KC (also with a NaN frame); max|d log| against the plain "
        f"versions {errs['stft_mel_log']:.3e} where plain mel > 1e-4")
    fused16 = mel_ops.stft_mel_log_pcm16(pcm, 32768.0, padded, win, n_fft,
                                         hop, fwd)
    fused16_ref = mel_ops.stft_mel_log_pcm16_plain(pcm, 32768.0, padded, win,
                                                   n_fft, hop, fwd)
    torch.cuda.synchronize()
    errs["stft_mel_log pcm16"] = float((fused16 - fused16_ref).abs()[
        fused16_ref > math.log(1e-4)].max())
    if not torch.equal(fused16, fused):
        raise AssertionError("the fused launch's int16 mode differs from KA "
                             "followed by the float launch")
    log(f"fused KB + KC int16 mode -> {tuple(fused16.shape)}: bit-equal to KA "
        f"then the float launch; max|d log| against its plain version "
        f"{errs['stft_mel_log pcm16']:.3e} where plain mel > 1e-4 (the float "
        f"launch's: torch.fft's rounding on quiet bins)")

    img, mx, mn = quantize.quantize_mel_plane_batch(logmel_ref)
    img_ref, mx_ref, mn_ref = quantize.quantize_mel_plane_plain(logmel_ref)
    torch.cuda.synchronize()
    if not (torch.equal(img, img_ref) and torch.equal(mx, mx_ref)
            and torch.equal(mn, mn_ref)):
        raise AssertionError("quantize_mel_plane differs from its plain version")
    errs["quantize_mel_plane"] = float(
        (img.int() - img_ref.int()).abs().max())
    log(f"KD quantize_mel_plane -> {tuple(img.shape)}: bit-exact, extrema "
        f"{mx.tolist()} / {mn.tolist()}")
    # KD's scalar paths: a base one float past 16 bytes (pass 1's head and
    # channel swap, pass 2's float loads) and an odd mel count
    flat = torch.empty(logmel_ref.numel() + 1, device=dev)
    flat[1:].copy_(logmel_ref.reshape(-1))
    for label, src in (
            ("a base one float past 16 bytes",
             flat[1:].view(logmel_ref.shape)),
            (f"{cfg.num_mels - 1} mels",
             logmel_ref[..., 1:, :].contiguous())):
        got = quantize.quantize_mel_plane_batch(src)
        ref = quantize.quantize_mel_plane_plain(src)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"quantize_mel_plane on {label} differs "
                                 f"from its plain version")
        log(f"KD quantize_mel_plane {tuple(src.shape)}, {label}: bit-exact")

    # -- phase 2b: the phase codec's kernels, bench shape --------------------
    pcfg = PhaseConfig.cli_default()
    nf = pcfg.num_freqs
    if (pcfg.resolut, pcfg.window) != (n_fft, hop):
        raise AssertionError("the phase and mel CLI widths share n and hop")
    frames = (padded - n_fft) // hop + 1
    zp, zs = pad_shift(16000)
    n16 = length // 3                           # 30 s at 16 kHz
    pcm16k = torch.from_numpy(np.stack([seeded_pcm_rate(rng, n16, 16000)
                                        for _ in range(BATCH)])).to(dev)
    padded16 = pad_length(n16 + n16 * zs, hop)
    x16 = quantize.pcm16_ingest_batch(pcm16k, f32, 32768.0, padded16, zp, zs)
    x16_ref = quantize.pcm16_ingest_plain(pcm16k, f32, 32768.0, padded16,
                                          batched=True, zp=zp, zs=zs)
    torch.cuda.synchronize()
    if not torch.equal(x16, x16_ref):
        raise AssertionError("pcm16_ingest (zero-stuff) differs from its "
                             "plain version")
    errs["pcm16_ingest zero-stuff"] = float((x16 - x16_ref).abs().max())
    log(f"KA pcm16_ingest zp={zp} zs={zs} [{BATCH}, {n16}] -> "
        f"{tuple(x16.shape)}: bit-exact")

    spec = phase_ops.phase_encode_batch(x, nf, n_fft, hop, win)
    spec_ref = rfft_mag.stft_planes_plain(x, win, n_fft, hop, 1, nf)
    spec_64 = rfft_mag.stft_planes_plain(x.double(), win.double(), n_fft, hop,
                                         1, nf)
    torch.cuda.synchronize()
    peak = spec_ref.abs().amax(dim=(-2, -1), keepdim=True)
    peak_64 = spec_64.abs().amax(dim=(-2, -1), keepdim=True)
    d_e = (spec - spec_ref).abs()
    errs["phase_encode"] = float(d_e.max())
    log(f"KE phase_encode -> {tuple(spec.shape)}: max|d| vs torch.fft f32 "
        f"{errs['phase_encode']:.3e}, / frame peak "
        f"{float((d_e / peak).max()):.3e} (bound 1e-5); vs float64: kernel "
        f"{float(((spec.double() - spec_64).abs() / peak_64).max()):.3e}, "
        f"torch.fft f32 "
        f"{float(((spec_ref.double() - spec_64).abs() / peak_64).max()):.3e} "
        f"of frame peak")
    if not bool((d_e <= 1e-5 * peak).all()):
        raise AssertionError("phase_encode error > 1e-5 of the frame peak")
    fwd_core_checks(dev, x, win, n_fft, hop, nf)
    inv_core_checks(dev, x, win, n_fft, hop)
    mixed_core_checks(dev)

    img_p, mx_p, mn_p = quantize.quantize_planes_batch(spec_ref, 255, 0)
    ref_p = quantize.quantize_planes_plain(spec_ref, 255, 0)
    img_i, mx_i, mn_i = quantize.quantize_planes_batch(spec_ref, 255, 2)
    ref_i = quantize.quantize_planes_plain(spec_ref, 255, 2)
    torch.cuda.synchronize()
    if not (torch.equal(img_p, ref_p[0]) and torch.equal(mx_p, ref_p[1])
            and torch.equal(mn_p, ref_p[2])):
        raise AssertionError("quantize_planes differs from its plain version")
    d_i = (img_i.int() - ref_i[0].int()).abs()
    flips_i = float((d_i > 0).float().mean())
    ext_i = float(torch.cat([(mx_i - ref_i[1]).abs(),
                             (mn_i - ref_i[2]).abs()]).max())
    errs["quantize_planes"] = float(d_i.max())
    log(f"KF quantize_planes -> {tuple(img_p.shape)}: ihs 0 bit-exact; ihs 2 "
        f"max step {int(d_i.max())}, flip rate {flips_i:.2e} (bounds 1, 2e-3),"
        f" extrema max|d| {ext_i:.3e}")
    if int(d_i.max()) > 1 or flips_i >= 2e-3:
        raise AssertionError("quantize_planes (ihs 2) outside its bound")
    # KF's scalar paths: an odd nf (pass 2's float loads; pass 1's rows end
    # mid-quad) and a base one float past 16 bytes (pass 1's odd head)
    flat = torch.empty(spec_ref.numel() + 1, device=dev)
    flat[1:].copy_(spec_ref.reshape(-1))
    for label, src in (("nf - 1 bins", spec_ref[:, :, :nf - 1].contiguous()),
                       ("a base 4 bytes past 16",
                        flat[1:].view(spec_ref.shape))):
        for max_val in (255, 65535):
            got_s = quantize.quantize_planes_batch(src, max_val, 0)
            ref_s = quantize.quantize_planes_plain(src, max_val, 0)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got_s, ref_s)):
                raise AssertionError(f"quantize_planes ({label}, max_val "
                                     f"{max_val}) differs from its plain "
                                     f"version")
        log(f"KF quantize_planes, {label} {tuple(src.shape)}: uint8 and "
            f"uint16 bit-exact")

    fw = istft.launch_irfft_window(istft.MODE_QUANT8, img_p, (mx_p, mn_p),
                                   n_fft, frames, nf, win, (BATCH,), 255.0, 0)
    deq = quantize.dequantize_planes_batch(img_p, mx_p, mn_p, 255, 0)
    halves = phase_ops.grow_half_planes(deq, n_fft // 2)
    fw_ref = istft.irfft_window_plain(*halves, n_fft, win)
    fw_64 = istft.irfft_window_plain(
        *phase_ops.grow_half_planes(deq.double(), n_fft // 2), n_fft,
        win.double())
    torch.cuda.synchronize()
    # the FFT's rounding scales with the frame before the window: a frame
    # whose energy sits where the Hann window is near 0 (a flat spectrum is
    # an impulse at sample 0) keeps its absolute error but loses its peak
    peak = istft.irfft_window_plain(*halves, n_fft, None).abs().amax(
        dim=-1, keepdim=True)
    peak_64 = peak.double()
    d_g = (fw - fw_ref).abs()
    errs["irfft_window"] = float(d_g.max())
    log(f"KG irfft_window (dequantize + grow + irfft x window) -> "
        f"{tuple(fw.shape)}: max|d| vs torch.fft f32 "
        f"{errs['irfft_window']:.3e}, / peak of the unwindowed frame "
        f"{float((d_g / peak).max()):.3e} (bound 1e-5); vs float64: kernel "
        f"{float(((fw.double() - fw_64).abs() / peak_64).max()):.3e}, "
        f"torch.fft f32 "
        f"{float(((fw_ref.double() - fw_64).abs() / peak_64).max()):.3e} "
        f"of that peak")
    if not bool((d_g <= 1e-5 * peak).all()):
        raise AssertionError("irfft_window error > 1e-5 of the frame peak")

    pcm_k, ok_k = istft.overlap_normalize(fw_ref, hop, win, pcm16=True)
    pcm_r, ok_r = istft.overlap_normalize_plain(fw_ref, hop, win, pcm16=True)
    sig_k = istft.overlap_normalize(fw_ref, hop, win)
    sig_r = istft.overlap_normalize_plain(fw_ref, hop, win)
    torch.cuda.synchronize()
    if not (torch.equal(pcm_k, pcm_r) and torch.equal(ok_k, ok_r)
            and torch.equal(sig_k, sig_r)):
        raise AssertionError("overlap_normalize differs from its plain version")
    errs["overlap_normalize"] = float((sig_k - sig_r).abs().max())
    log(f"KH overlap_normalize -> {tuple(sig_k.shape)}: float32 and PCM-16 "
        f"bit-exact, finite {ok_k.tolist()}")
    # the scalar path: the same frames at an odd hop (the vector path needs n
    # and hop multiples of 4)
    if vector_path(n_fft, hop - 1) or not vector_path(n_fft, hop,
                                                      tensors=(fw_ref,)):
        raise AssertionError("KH's path choice")
    pcm_s, ok_s = istft.overlap_normalize(fw_ref, hop - 1, win, pcm16=True)
    pcm_sr, ok_sr = istft.overlap_normalize_plain(fw_ref, hop - 1, win,
                                                  pcm16=True)
    sig_s = istft.overlap_normalize(fw_ref, hop - 1, win, 1.5)
    sig_sr = istft.overlap_normalize_plain(fw_ref, hop - 1, win, 1.5)
    torch.cuda.synchronize()
    if not (torch.equal(pcm_s, pcm_sr) and torch.equal(ok_s, ok_sr)
            and torch.equal(sig_s, sig_sr)):
        raise AssertionError("overlap_normalize (scalar path) differs from "
                             "its plain version")
    log(f"KH overlap_normalize, hop {hop - 1} (scalar path) -> "
        f"{tuple(sig_s.shape)}: float32 with boost 1.5 and PCM-16 bit-exact")

    # -- phase 2c: the mel decode's kernels, bench shape ---------------------
    # sources: phase 2's log-mel and its uint8 planes (KD)
    inv = torch.tensor(inverse_mel_weights(cfg.n_bins, cfg.num_mels,
                                           cfg.mel_fmin, cfg.mel_fmax),
                       dtype=f32, device=dev)
    ki_rel = []
    for label, src, ext in (("uint8 planes", img, dict(mgc_max=mx, mgc_min=mn)),
                            ("float log-mel", logmel_ref, {})):
        mag_k = mel_ops.mel_to_magnitudes(src, inv, **ext)
        mag_r = mel_ops.mel_to_magnitudes_plain(src, inv, **ext)
        torch.cuda.synchronize()
        peak = mag_r.amax(dim=-1, keepdim=True)
        d_i = (mag_k - mag_r).abs()
        ki_rel.append(float((d_i / peak).max()))
        errs["mel_to_magnitudes"] = max(errs.get("mel_to_magnitudes", 0.0),
                                        float(d_i.max()))
        log(f"KI mel_to_magnitudes ({label}) -> {tuple(mag_k.shape)}: max|d| "
            f"{float(d_i.max()):.3e}, / frame peak {ki_rel[-1]:.3e} "
            f"(bound 1e-5)")
    if max(ki_rel) > 1e-5:
        raise AssertionError("mel_to_magnitudes error > 1e-5 of the frame peak")
    # the frame-run KI against the block-a-frame form it replaced, bit for
    # bit: both modes, tune and boost, the resolut 3000 widths (1500 bins,
    # 160 mels); 1122 frames are not a whole number of runs
    old_ki = profile_quant.earlier(earlier_job)
    cfg3k = MelConfig(resolut=3000, window=750)
    inv3k = torch.tensor(inverse_mel_weights(cfg3k.n_bins, cfg3k.num_mels,
                                             cfg3k.mel_fmin, cfg3k.mel_fmax),
                         dtype=f32, device=dev)
    log3k = torch.from_numpy(np.random.default_rng(SEED + 3).uniform(
        -11.5, 3.0, (BATCH, frames,
                     cfg3k.num_mels, 2)).astype(np.float32)).to(dev)
    img3k, mx3k, mn3k = quantize.quantize_mel_plane_batch(log3k)
    for label, src, u, kw in (
            ("uint8 planes", img, inv, dict(mgc_max=mx, mgc_min=mn)),
            ("float log-mel", logmel_ref, inv, {}),
            ("uint8, tune (1.5, 0.25), boost 1.5", img, inv,
             dict(mgc_max=mx, mgc_min=mn, tune_mul=1.5, tune_add=0.25,
                  boost=1.5)),
            ("float, resolut 3000, tune (0.75, -0.5), boost -0.5", log3k,
             inv3k, dict(tune_mul=0.75, tune_add=-0.5, boost=-0.5)),
            ("uint8, resolut 3000", img3k, inv3k,
             dict(mgc_max=mx3k, mgc_min=mn3k))):
        got = mel_ops.mel_to_magnitudes(src, u, **kw)
        old = profile_quant.old_mel_to_magnitudes(old_ki, src, u, **kw)
        ref = mel_ops.mel_to_magnitudes_plain(src, u, **kw)
        torch.cuda.synchronize()
        rel = float(((got - ref).abs() / ref.amax(dim=-1, keepdim=True))
                    .max())
        log(f"KI mel_to_magnitudes ({label}) -> {tuple(got.shape)}: "
            f"bit-equal to the earlier form {torch.equal(got, old)}; / frame "
            f"peak {rel:.3e} (bound 1e-5)")
        if not torch.equal(got, old) or rel > 1e-5:
            raise AssertionError(f"mel_to_magnitudes ({label}) differs from "
                                 f"the earlier form or its plain version")
    mag = mel_ops.mel_to_magnitudes_plain(img, inv, mgc_max=mx, mgc_min=mn)
    gl_len = n_fft + (frames - 1) * hop
    sig0 = prng.uniform(prng.key(SEED), (BATCH, gl_len), f32, dev)
    fw_j = {}
    kj_rel = []
    for label, sig in (("random init", sig0),
                       ("after one iteration", None)):
        if sig is None:
            sig = griffinlim.gl_overlap_add_plain(fw_j["random init"], hop)
        fw_k = griffinlim.gl_project(sig, mag, win, n_fft, hop)
        fw_r = griffinlim.gl_project_plain(sig, mag, win, n_fft, hop)
        fw_64 = griffinlim.gl_project_plain(sig.double(), mag.double(),
                                            win.double(), n_fft, hop)
        torch.cuda.synchronize()
        fw_j[label] = fw_r
        norm = fw_r.norm(dim=-1)
        kj_rel.append(float(((fw_k - fw_r).norm(dim=-1) / norm).max()))
        errs["gl_project"] = max(errs.get("gl_project", 0.0),
                                 float((fw_k - fw_r).abs().max()))
        log(f"KJ gl_project ({label}) -> {tuple(fw_k.shape)}: relative L2 "
            f"per frame vs torch.fft f32 max {kj_rel[-1]:.3e} (bound 1e-4); "
            f"vs float64: kernel "
            f"{float(((fw_k.double() - fw_64).norm(dim=-1) / fw_64.norm(dim=-1)).max()):.3e}, "
            f"torch.fft f32 "
            f"{float(((fw_r.double() - fw_64).norm(dim=-1) / fw_64.norm(dim=-1)).max()):.3e}")
    if max(kj_rel) > 1e-4:
        raise AssertionError("gl_project relative L2 per frame > 1e-4")
    fw_gl = fw_j["random init"]
    for momentum, pcm16 in ((0.0, False), (0.99, False), (0.0, True)):
        prev = sig0 if momentum else None
        out_k = griffinlim.gl_overlap_add(fw_gl, hop, prev, momentum, pcm16)
        out_r = griffinlim.gl_overlap_add_plain(fw_gl, hop, prev, momentum,
                                                pcm16)
        torch.cuda.synchronize()
        if not isinstance(out_k, tuple):
            out_k, out_r = (out_k,), (out_r,)
        if not all(torch.equal(a, b) for a, b in zip(out_k, out_r)):
            raise AssertionError(f"gl_overlap_add (momentum {momentum}, "
                                 f"pcm16 {pcm16}) differs from its plain "
                                 f"version")
        if not pcm16:
            errs["gl_overlap_add"] = max(
                errs.get("gl_overlap_add", 0.0),
                max(float((a - b).abs().max()) for a, b in zip(out_k, out_r)))
    log(f"KK gl_overlap_add -> {tuple(out_k[0].shape)}: momentum 0 and 0.99, "
        f"float32 and PCM-16 bit-exact, finite {out_k[1].tolist()}")

    # -- phase 2d: the batch forms, 4 rows of 30 s, masked frames ---------
    rows4 = 4
    frames4 = torch.tensor([frames, min(843, frames - 1),
                            min(562, frames // 2 + 1), 0], dtype=torch.int32,
                           device=dev)
    pcm4 = torch.from_numpy(seeded_pcm(rng, rows4, padded)).to(dev)
    scales4 = torch.tensor([32768.0, 65536.0, 32768.0, 65536.0], device=dev)
    x4 = quantize.pcm16_ingest_batch(pcm4, f32, scales4)
    x4_ref = quantize.pcm16_ingest_plain(pcm4, f32, scales4, batched=True)
    torch.cuda.synchronize()
    if not torch.equal(x4, x4_ref):
        raise AssertionError("pcm16_ingest (per-row scales) differs from its "
                             "plain version")
    errs["pcm16_ingest_rows"] = float((x4 - x4_ref).abs().max())
    log(f"KA pcm16_ingest per-row scales {scales4.tolist()} [{rows4}, "
        f"{padded}]: bit-exact")
    pcm16_fused_checks(dev, pcm, pcm4, scales4, win, fwd, n_fft, hop, padded)

    def nan_rows(t):
        """A NaN in a counted frame of row 1 and in a pad frame of row 2."""
        t = t.clone()
        t[1, 10, 5, 0] = float("nan")
        t[2, (int(frames4[2]) + frames) // 2, 7, 1] = float("nan")
        return t

    def same(a, b) -> bool:
        """Bit-equal, NaN where the other has NaN."""
        if a.dtype.is_floating_point:
            return bool(torch.equal(a.isnan(), b.isnan())
                        and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))
        return torch.equal(a, b)

    big = torch.finfo(f32).max

    def masked_rows_ok(img_m, mx_m, max_val) -> bool:
        """Row 3 (frames 0): the -+FLT_MAX sentinels and all midpoint
        pixels; row 1 (a NaN counted in channel 0): NaN extrema, midpoint
        pixels in that channel; row 2 (NaN in a pad frame): finite
        extrema."""
        mid = max_val // 2
        return bool((img_m[3] == mid).all() and (img_m[1][..., 0] == mid).all()
                    and mx_m[1].isnan().any() and torch.isfinite(mx_m[2]).all()
                    and (mx_m[3] == -big).all())

    logmel4 = nan_rows(mel_ops._mel_from_mags(rfft_mag.stft_mag(
        x4, win, n_fft, hop), fwd))
    got_m = quantize.quantize_mel_plane_batch(logmel4, 255, frames4)
    ref_m = quantize.quantize_mel_plane_plain(logmel4, 255, frames4)
    torch.cuda.synchronize()
    if not all(same(a, b) for a, b in zip(got_m, ref_m)):
        raise AssertionError("quantize_mel_plane (masked) differs from its "
                             "plain version")
    if not (masked_rows_ok(got_m[0], got_m[1], 255)
            and bool((got_m[2][3] == big).all())):
        raise AssertionError("quantize_mel_plane (masked): wrong sentinel, "
                             "NaN or pad-frame rows")
    errs["quantize_mel_plane_masked"] = 0.0
    log(f"KD quantize_mel_plane masked, frames {frames4.tolist()} -> "
        f"{tuple(got_m[0].shape)}: bit-exact with NaN rows; extrema "
        f"{got_m[1].tolist()} / {got_m[2].tolist()}")

    spec4 = nan_rows(phase_ops.phase_encode_batch(x4, nf, n_fft, hop, win))
    errs["quantize_planes_masked"] = 0.0
    for max_val, ihs in ((255, 0), (65535, 0), (255, 2), (65535, 2)):
        got_p = quantize.quantize_planes_batch(spec4, max_val, ihs, frames4)
        ref_p = quantize.quantize_planes_plain(spec4, max_val, ihs, frames4)
        torch.cuda.synchronize()
        d_p = (got_p[0].int() - ref_p[0].int()).abs()
        flips_p = float((d_p > 0).float().mean())
        exact = all(same(a, b) for a, b in zip(got_p, ref_p))
        log(f"KF quantize_planes masked, max_val {max_val}, ihs {ihs} -> "
            f"{tuple(got_p[0].shape)}: max step {int(d_p.max())}, flip rate "
            f"{flips_p:.2e}, bit-exact {exact} (bound: bit-exact without "
            f"IHS, else 1 step at < 2e-3)")
        errs["quantize_planes_masked"] = max(errs["quantize_planes_masked"],
                                             float(d_p.max()))
        if (ihs == 0 and not exact) or int(d_p.max()) > 1 or flips_p >= 2e-3:
            raise AssertionError(f"quantize_planes (masked, max_val "
                                 f"{max_val}, ihs {ihs}) outside its bound")
        if not masked_rows_ok(got_p[0], got_p[1], max_val):
            raise AssertionError("quantize_planes (masked): wrong sentinel, "
                                 "NaN or pad-frame rows")

    # -- phase 2e: the long-form kernels, one shard of the 30-minute file ---
    long_k = longform_kernels(dev, errs)

    # -- phase 2f: KN, KO and the xla route ----------------------------------
    dft_k = dft_kernels(dev, errs, x, win, n_fft, hop, mag, sig0)
    route_k = (fft_size_checks(dev, x, 3000, 750, 1152, False)
               | fft_size_checks(dev, x, 514, 128, 200, True))

    # -- phase 2g: KP, the Griffin-Lim start's Threefry draw ------------------
    prng_k = prng_kernel(dev, errs, gl_len)

    # -- phase 2h: the JAX call surface (frame_chunk, frame_mask, mxu_fft) ---
    log(f"phase 2h: the JAX call surface on {card}")
    call_surface(dev, tallies, x, pcm, win, fwd, cfg.num_mels, nf, n_fft, hop)

    # -- phase 3: the main path, tomel on a 30 s WAV ----------------------
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "speech.wav")
        wavcodec.write_wav(wav, seeded_pcm(rng, 1, length)[0], SAMPLE_RATE)
        png_gpu = os.path.join(tmp, "gpu.png")
        png_cpu = os.path.join(tmp, "cpu.png")
        _, counts = drive("tomel --device cuda (first call)",
                          lambda: tomel([wav, "--device", "cuda", "-o",
                                         png_gpu]),
                          ("stft_mel_log pcm16", "quantize_mel_plane"))
        if counts.get("pcm16_ingest") or counts.get("stft_mel_log"):
            raise AssertionError(f"tomel ran KA or the float fused launch: "
                                 f"{counts}")
        # the route before the int16 mode (KA, the float fused launch, KD)
        # on the same file, through the CLI's Mel: the same PNG bytes
        from gomel_tpu_torch.cli import tools as cli_tools
        m_cli = cli_tools._mel_from_args(cli_tools._mel_parser(
            "tomel", False).parse_args([wav, "--device", "cuda"]))
        buf, sr_w = audio_io.load_wav_any(wav, mono="left", raw_pcm16=True)
        x_ka = quantize.pcm16_ingest(torch.from_numpy(buf.copy()).to(dev),
                                     f32, 32768.0,
                                     pad_length(len(buf), m_cli.config.window))
        png_ka = os.path.join(tmp, "ka_route.png")
        m_cli._save_quantized(png_ka, quantize.quantize_mel_plane(
            m_cli._encode_padded(x_ka), 255), len(buf), sr_w)
        with open(png_gpu, "rb") as fa, open(png_ka, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError("tomel's PNG differs from the KA route's")
        log("tomel PNG (the int16 fused launch) byte-equal to the KA + float "
            "fused launch route's")
        if tomel([wav, "--device", "cpu", "-o", png_cpu]) != 0:
            raise AssertionError("tomel on cpu failed")
        a = read_png(png_gpu).astype(np.int64)
        b = read_png(png_cpu).astype(np.int64)
        if a.shape != b.shape:
            raise AssertionError(f"PNG shapes differ: {a.shape} vs {b.shape}")
        diff = np.abs(a - b)
        flips = float((diff > 0).mean())
        _, mx_g, mn_g, samples_g, sr_g = imagecodec.load_mel_image_raw(png_gpu, True)
        _, mx_c, mn_c, samples_c, sr_c = imagecodec.load_mel_image_raw(png_cpu, True)
        log(f"tomel PNG {a.shape}: cuda vs cpu max step {int(diff.max())}, "
            f"flip rate {flips:.2e} (bounds 1, 2e-3); metadata cuda "
            f"{(mx_g, mn_g, samples_g, sr_g)} cpu {(mx_c, mn_c, samples_c, sr_c)}")
        if diff.max() > 1 or flips >= 2e-3:
            raise AssertionError("tomel PNG differs from the CPU path")
        if (mx_g, mn_g, samples_g, sr_g) != (mx_c, mn_c, samples_c, sr_c):
            raise AssertionError("tomel PNG metadata differs from the CPU path")

        # -- phase 3b: the phase round trip, tophase then fromphase --------
        for label, wav_in, sr_in in (
                ("48 kHz 30 s", wav, SAMPLE_RATE),
                ("16 kHz 3 s", os.path.join(tmp, "16k.wav"), 16000)):
            if sr_in != SAMPLE_RATE:
                wavcodec.write_wav(wav_in, seeded_pcm_rate(rng, 3 * sr_in,
                                                           sr_in), sr_in)
            stem = os.path.join(tmp, f"p{sr_in}")
            png_g, png_c = stem + "_gpu.png", stem + "_cpu.png"
            out_g, out_c = stem + "_gpu.wav", stem + "_cpu.wav"
            t_enc, _ = drive(f"tophase --device cuda, {label} (first call)",
                             lambda: tophase([wav_in, "--device", "cuda",
                                              "-o", png_g]),
                             ("pcm16_ingest", "phase_encode",
                              "quantize_planes"))
            t_dec, _ = drive(f"fromphase --device cuda, {label} (first call)",
                             lambda: fromphase([png_g, "--device", "cuda",
                                                "-o", out_g]),
                             ("irfft_window", "overlap_normalize"))
            if tophase([wav_in, "--device", "cpu", "-o", png_c]) != 0:
                raise AssertionError("tophase on cpu failed")
            if fromphase([png_g, "--device", "cpu", "-o", out_c]) != 0:
                raise AssertionError("fromphase on cpu failed")
            d = png_steps(png_g, png_c, read_png)
            flips = float((d > 0).mean())
            meta_g = imagecodec.load_phase_image_raw(png_g, True)[1:]
            meta_c = imagecodec.load_phase_image_raw(png_c, True)[1:]
            meta_eq = all(np.array_equal(u, v) for u, v in zip(meta_g, meta_c))
            wg, sr_g = wavcodec.read_wav(out_g)
            wc, sr_c = wavcodec.read_wav(out_c)
            lsb = np.abs(wg.astype(np.int64) - wc.astype(np.int64))
            log(f"phase round trip {label}: PNG {read_png(png_g).shape} cuda "
                f"vs cpu max step {int(d.max())}, flip rate {flips:.2e} "
                f"(bounds 1, 2e-3), metadata equal {meta_eq}; WAV "
                f"{wg.shape} @ {sr_g} Hz cuda vs cpu decode of the same PNG "
                f"max {int(lsb.max())} LSB, differing {float((lsb > 0).mean()):.2e}"
                f" (bounds 1, 5e-2)")
            if d.max() > 1 or flips >= 2e-3 or not meta_eq:
                raise AssertionError(f"tophase PNG ({label}) differs from the "
                                     f"CPU path")
            if sr_g != sr_c or wg.shape != wc.shape or lsb.max() > 1 \
                    or float((lsb > 0).mean()) >= 5e-2:
                raise AssertionError(f"fromphase WAV ({label}) differs from "
                                     f"the CPU path")
            if sr_in == SAMPLE_RATE:
                # the 16 kHz file comes back at 48 kHz, zero-stuffed, so
                # only the 48 kHz one compares sample by sample
                x_in, _ = audio_io.load_wav(wav_in)
                y_out, _ = audio_io.load_wav(out_g)
                n_c = min(len(x_in), len(y_out))
                corr = float(np.corrcoef(x_in[4096:n_c - 4096],
                                         y_out[4096:n_c - 4096])[0, 1])
                log(f"  WAV -> PNG -> WAV correlation {corr:.6f} (bound 0.99)")
                if corr <= 0.99:
                    raise AssertionError(f"round-trip correlation {corr}")
                runs_enc, runs_dec = [t_enc], [t_dec]
                for _ in range(4):
                    t0 = time.perf_counter()
                    tophase([wav_in, "--device", "cuda", "-o", png_g])
                    torch.cuda.synchronize()
                    runs_enc.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    fromphase([png_g, "--device", "cuda", "-o", out_g])
                    torch.cuda.synchronize()
                    runs_dec.append(time.perf_counter() - t0)
                walls3b = {"tophase": 1e3 * float(np.median(runs_enc[1:])),
                           "fromphase": 1e3 * float(np.median(runs_dec[1:]))}
                log(f"  30 s file wall, median of 4 after the first: tophase "
                    f"{1e3 * float(np.median(runs_enc[1:])):.3f} ms, fromphase "
                    f"{1e3 * float(np.median(runs_dec[1:])):.3f} ms (first "
                    f"{1e3 * t_enc:.3f}, {1e3 * t_dec:.3f} ms)")

        # -- phase 3c: the mel decode, towav on the tomel PNG ----------------
        wav_g = os.path.join(tmp, "towav_gpu.wav")
        wav_c = os.path.join(tmp, "towav_cpu.wav")
        towav_args = [png_gpu, str(SAMPLE_RATE), "--seed", "1"]
        t_wav, counts = drive(
            "towav --device cuda (first call)",
            lambda: towav(towav_args + ["-o", wav_g, "--device", "cuda"]),
            ("mel_to_magnitudes", "gl_project", "gl_overlap_add",
             "threefry_uniform"))
        n_gl = cfg.griffin_lim_iterations
        want = {"mel_to_magnitudes": 1, "gl_project": n_gl,
                "gl_overlap_add": n_gl, "threefry_uniform": 1}
        if {k: counts.get(k, 0) for k in want} != want:
            raise AssertionError(f"towav launches {counts}, expected {want}")
        if towav(towav_args + ["-o", wav_c, "--device", "cpu"]) != 0:
            raise AssertionError("towav on cpu failed")
        wg, sr_g = wavcodec.read_wav(wav_g)
        wc, sr_c = wavcodec.read_wav(wav_c)
        if sr_g != sr_c or wg.shape != wc.shape:
            raise AssertionError(f"towav WAVs differ in form: {wg.shape} @ "
                                 f"{sr_g} Hz vs {wc.shape} @ {sr_c} Hz")
        lsb = np.abs(wg.astype(np.int64) - wc.astype(np.int64))
        planes, p_mx, p_mn, _, _ = imagecodec.load_mel_image_raw(png_gpu, True)
        target = mel_ops.mel_to_magnitudes_plain(
            torch.from_numpy(planes.copy()), inv.cpu(), mgc_max=p_mx,
            mgc_min=p_mn).double()
        win64 = torch.tensor(hann_window(n_fft), dtype=torch.float64)
        # each wave at unit scale, zero-padded back to the frames' span
        # (towav trims the reference padding)
        span = n_fft + (target.shape[0] - 1) * hop
        sc_g, sc_c = (spectral_convergence(torch.nn.functional.pad(
            torch.from_numpy(w[:span].astype(np.float64) / 32768.0),
            (0, max(span - len(w), 0))), target, n_fft, hop, win64)
            for w in (wg, wc))
        log(f"towav WAV {wg.shape} @ {sr_g} Hz: cuda vs cpu (same --seed) max "
            f"{int(lsb.max())} LSB, differing {float((lsb > 0).mean()):.2e} "
            f"(bounds 2, 5e-2); scale-invariant spectral convergence against "
            f"the target magnitudes: cuda {sc_g:.6f}, cpu {sc_c:.6f} (differ "
            f"by {abs(sc_g - sc_c):.2e}, bound 1e-3)")
        if lsb.max() > 2 or float((lsb > 0).mean()) >= 5e-2:
            raise AssertionError("towav WAV differs from the CPU path")
        if not (math.isfinite(sc_g) and abs(sc_g - sc_c) <= 1e-3):
            raise AssertionError("towav spectral convergence differs from the "
                                 "CPU path")
        runs_wav = [t_wav]
        for _ in range(4):
            t0 = time.perf_counter()
            towav(towav_args + ["-o", wav_g, "--device", "cuda"])
            torch.cuda.synchronize()
            runs_wav.append(time.perf_counter() - t0)
        log(f"  towav 30 s file wall, median of 4 after the first: "
            f"{1e3 * float(np.median(runs_wav[1:])):.3f} ms (first "
            f"{1e3 * t_wav:.3f} ms)")
        log(f"  towav split (host clock, each step ended by a synchronise, "
            f"median of 10): " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in towav_split(
                    png_gpu, wav_g, dev, 10).items()))

        # -- phase 3d: the batch CLIs on a directory of WAV and FLAC -------
        batch_clis(tmp, rng, drive, card)

        # -- phase 3e: the long-form path, a 30-minute file, 4 shards ------
        longform(tmp, drive, card, dev)

        # -- phase 3f: the mm Griffin-Lim, the mm phase codec, resolut 3000
        new_paths(tmp, drive, dev, wav, logmel_ref, inv, sig0, win, x, nf)

        # -- phase 3g: the streaming codecs on the 30-minute signal ---------
        streaming(drive, card, dev)

        # -- phase 3h: the serving artifacts ---------------------------------
        serving_phase(tmp, drive, card, dev, x)

        # -- phase 3i: the compat drop-in and the native PNG filter -----------
        compat_phase(tmp, drive, card, wav, walls3b)

        # -- phase 3j: the multi-process form ---------------------------------
        multiprocess(tmp, card, launches)

    # -- phase 4: times at the bench shape ---------------------------------
    log(f"timing on {card}: device ms per call (CUDA events over up to 20 "
        f"calls queued behind a sleep kernel, after 3 warmup; lower of two "
        f"runs, order plain-kernel-kernel-plain); host enqueue us per call")
    kernel_fns = {
        "pcm16_ingest": lambda: quantize.pcm16_ingest_batch(pcm, f32, 32768.0,
                                                            padded),
        "stft_mag": lambda: rfft_mag.stft_mag(x, win, n_fft, hop),
        "mel_log": lambda: mel_ops._mel_from_mags(mags_ref, fwd),
        "stft_mel_log": lambda: mel_ops.stft_mel_log(x, win, n_fft, hop, fwd),
        "stft_mel_log pcm16": lambda: mel_ops.stft_mel_log_pcm16(
            pcm, 32768.0, padded, win, n_fft, hop, fwd),
        "quantize_mel_plane": lambda: quantize.quantize_mel_plane_batch(
            logmel_ref),
        "phase_encode": lambda: phase_ops.phase_encode_batch(x, nf, n_fft, hop,
                                                             win),
        "quantize_planes": lambda: quantize.quantize_planes_batch(spec_ref,
                                                                  255, 0),
        "irfft_window": lambda: istft.launch_irfft_window(
            istft.MODE_QUANT8, img_p, (mx_p, mn_p), n_fft, frames, nf, win,
            (BATCH,), 255.0, 0),
        "overlap_normalize": lambda: istft.overlap_normalize(
            fw_ref, hop, win, pcm16=True),
        "pcm16_ingest zero-stuff": lambda: quantize.pcm16_ingest_batch(
            pcm16k, f32, 32768.0, padded16, zp, zs),
        "mel_to_magnitudes": lambda: mel_ops.mel_to_magnitudes(
            img, inv, mgc_max=mx, mgc_min=mn),
        "gl_project": lambda: griffinlim.gl_project(sig0, mag, win, n_fft,
                                                    hop),
        "gl_overlap_add": lambda: griffinlim.gl_overlap_add(fw_gl, hop),
        "pcm16_ingest_rows": lambda: quantize.pcm16_ingest_batch(
            pcm4, f32, scales4),
        "quantize_mel_plane_masked": lambda: quantize.quantize_mel_plane_batch(
            logmel4, 255, frames4),
        "quantize_planes_masked": lambda: quantize.quantize_planes_batch(
            spec4, 255, 0, frames4),
    }
    plain_fns = {
        "pcm16_ingest": lambda: quantize.pcm16_ingest_plain(
            pcm, f32, 32768.0, padded, batched=True),
        "stft_mag": lambda: rfft_mag.stft_mag_plain(x, win, n_fft, hop),
        "mel_log": lambda: mel_ops.mel_from_mags_plain(mags_ref, fwd),
        "stft_mel_log": lambda: mel_ops.stft_mel_log_plain(x, win, n_fft, hop,
                                                           fwd),
        "stft_mel_log pcm16": lambda: mel_ops.stft_mel_log_pcm16_plain(
            pcm, 32768.0, padded, win, n_fft, hop, fwd),
        "quantize_mel_plane": lambda: quantize.quantize_mel_plane_plain(
            logmel_ref),
        "phase_encode": lambda: rfft_mag.stft_planes_plain(x, win, n_fft, hop,
                                                           1, nf),
        "quantize_planes": lambda: quantize.quantize_planes_plain(spec_ref,
                                                                  255, 0),
        "irfft_window": lambda: istft.irfft_window_plain(
            *phase_ops.grow_half_planes(quantize.dequantize_planes_batch(
                img_p, mx_p, mn_p, 255, 0), n_fft // 2), n_fft, win),
        "overlap_normalize": lambda: istft.overlap_normalize_plain(
            fw_ref, hop, win, pcm16=True),
        "pcm16_ingest zero-stuff": lambda: quantize.pcm16_ingest_plain(
            pcm16k, f32, 32768.0, padded16, batched=True, zp=zp, zs=zs),
        "mel_to_magnitudes": lambda: mel_ops.mel_to_magnitudes_plain(
            img, inv, mgc_max=mx, mgc_min=mn),
        "gl_project": lambda: griffinlim.gl_project_plain(sig0, mag, win,
                                                          n_fft, hop),
        "gl_overlap_add": lambda: griffinlim.gl_overlap_add_plain(fw_gl, hop),
        "pcm16_ingest_rows": lambda: quantize.pcm16_ingest_plain(
            pcm4, f32, scales4, batched=True),
        "quantize_mel_plane_masked": lambda: quantize.quantize_mel_plane_plain(
            logmel4, 255, frames4),
        "quantize_planes_masked": lambda: quantize.quantize_planes_plain(
            spec4, 255, 0, frames4),
    }
    # KC at n = 3000 (1501 bins a frame, the mixed radix's magnitudes; the
    # fused route takes only power-of-two n/2)
    slots3k, band_w3k, _ = mel_ops._mel_band_table(fwd3k)
    nnz3k = 2.0 * float(slots3k[:, 1][slots3k[:, 2] >= 0].sum())
    we3k = mel_ops._extended_weights(fwd3k)[0]
    kc3k = {"mel_log (n 3000)": dict(
        kernel=lambda: mel_ops._mel_from_mags(mags3k, fwd3k),
        plain=lambda: mel_ops.mel_from_mags_plain(mags3k, fwd3k),
        library=lambda: torch.matmul(mags3k, we3k),
        work=(nbytes(mags3k, slots3k, band_w3k, ref3k),
              mags3k.shape[0] * mags3k.shape[1]
              * (2 * nnz3k + 2 * cfg.num_mels)))}
    extra_k = long_k | dft_k | prng_k | kc3k
    for name, entry in extra_k.items():
        kernel_fns[name], plain_fns[name] = entry["kernel"], entry["plain"]
    times = {name: race(kernel_fns[name], plain_fns[name], name)
             for name in kernel_fns}
    for name, (k_ms, p_ms) in times.items():
        log(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; wrapper "
            f"enqueue {host_us(kernel_fns[name]):.1f} us")
    for name, (k_ms, _) in times.items():
        if name in EARLIER_MS:
            log(f"  {name}: {k_ms:.4f} ms against {EARLIER_MS[name]:.4f} "
                f"recorded in PERF.md, ratio {k_ms / EARLIER_MS[name]:.3f}")

    # bound_ms: bytes each input read once and each output written once, and
    # operations, at the timed inputs; library_ms: one PyTorch call of the
    # same function where there is one
    taps = -(-n_fft // hop)
    f2 = BATCH * frames
    we = mel_ops._extended_weights(fwd)[0]
    # KC's terms a frame: the band table's spans (W_ext's non-zero spans)
    slots, band_w, _ = mel_ops._mel_band_table(fwd)
    nnz = 2.0 * float(slots[:, 1][slots[:, 2] >= 0].sum())
    kb_ops = fft_ops(n_fft) + n_fft + 3 * (n_fft // 2 + 1)
    work = {
        "pcm16_ingest": (nbytes(pcm, x), float(x.numel())),
        "stft_mag": (nbytes(x, win, mags_ref), f2 * kb_ops),
        "stft_mel_log": (nbytes(x, win, slots, band_w, logmel_ref),
                         f2 * (kb_ops + 2 * nnz + 2 * cfg.num_mels)),
        # the int16 signal in (5.75 MB, not 11.5), one division a sample
        "stft_mel_log pcm16": (nbytes(pcm, win, slots, band_w, logmel_ref),
                               f2 * (kb_ops + 2 * nnz + 2 * cfg.num_mels)
                               + float(x.numel())),
        "mel_log": (nbytes(mags_ref, slots, band_w, logmel_ref),
                    f2 * (2 * nnz + 2 * cfg.num_mels)),
        "quantize_mel_plane": (nbytes(logmel_ref, img, mx, mn),
                               6.0 * logmel_ref.numel()),
        "phase_encode": (nbytes(x, win, spec_ref),
                         f2 * (fft_ops(n_fft) + n_fft)),
        "quantize_planes": (nbytes(spec_ref, img_p, mx_p, mn_p),
                            6.0 * spec_ref.numel()),
        "irfft_window": (nbytes(img_p, mx_p, mn_p, win, fw_ref),
                         f2 * (fft_ops(n_fft) + n_fft) + 3.0 * img_p.numel()),
        "overlap_normalize": (nbytes(fw_ref, pcm_k),
                              float(pcm_k.numel()) * (taps + 5)),
        "mel_to_magnitudes": (nbytes(img, inv, mag),
                              f2 * (8 * cfg.num_mels + 10 * (n_fft // 2))),
        "gl_project": (nbytes(sig0, mag, win, fw_gl),
                       f2 * (2 * fft_ops(n_fft) + 2 * n_fft
                             + 12 * (n_fft // 2 + 1))),
        "gl_overlap_add": (nbytes(fw_gl, sig0),
                           float(sig0.numel()) * taps),
        "pcm16_ingest zero-stuff": (nbytes(pcm16k, x16), float(x16.numel())),
        "pcm16_ingest_rows": (nbytes(pcm4, scales4, x4), float(x4.numel())),
        "quantize_mel_plane_masked": (nbytes(logmel4, frames4, *got_m),
                                      6.0 * logmel4.numel()),
        "quantize_planes_masked": (nbytes(spec4, frames4) + spec4.numel()
                                   + 16.0 * rows4, 6.0 * spec4.numel()),
    }
    frames_kb = (rfft_mag.frame_signal(x, n_fft, hop) * win).contiguous()
    spec_c = torch.complex(*halves)
    mel_lin = logmel_ref.transpose(-1, -2).contiguous()
    inv_t = inv.t().contiguous()
    # KK's overlap-add as one F.fold of the frames (the same sums in
    # another order)
    fw_cols = fw_gl.transpose(1, 2)

    def fold():
        return torch.nn.functional.fold(fw_cols, (1, gl_len), (1, n_fft),
                                        stride=(1, hop)).reshape(BATCH, gl_len)

    fold_d = float((fold() - griffinlim.gl_overlap_add(fw_gl, hop)).abs().max())
    log(f"  gl_overlap_add's library call, F.fold of the frames: max|d| "
        f"{fold_d:.3e} against KK")
    # KH's: the overlap-add of its windowed frames as one F.fold (KH also
    # divides by the window-sum and converts to PCM-16)
    fw_ref_cols = fw_ref.transpose(1, 2)

    def fold_kh():
        return torch.nn.functional.fold(
            fw_ref_cols, (1, gl_len), (1, n_fft),
            stride=(1, hop)).reshape(BATCH, gl_len)

    fold_kh_d = float((fold_kh() - istft.overlap_add_plain(fw_ref, hop))
                      .abs().max())
    log(f"  overlap_normalize's library call, F.fold of the frames: max|d| "
        f"{fold_kh_d:.3e} against the plain overlap-add")
    # KA's library call: the one division of the int16 tensor (its mono
    # and per-row modes without the padding)
    library = {"pcm16_ingest": lambda: pcm / 32768.0,
               "pcm16_ingest_rows": lambda: pcm4 / scales4[:, None],
               "stft_mag": lambda: torch.fft.rfft(frames_kb, dim=-1),
               "phase_encode": lambda: torch.fft.rfft(frames_kb, dim=-1),
               "irfft_window": lambda: torch.fft.irfft(spec_c, n=n_fft),
               "gl_project": lambda: torch.fft.irfft(spec_c, n=n_fft),
               "gl_overlap_add": fold,
               "overlap_normalize": fold_kh,
               "mel_log": lambda: torch.matmul(mags_ref, we),
               "mel_to_magnitudes": lambda: torch.matmul(mel_lin, inv_t)}
    for name, entry in extra_k.items():
        work[name] = entry["work"]
        if entry["library"] is not None:
            library[name] = entry["library"]
    library_ms = {name: min(cuda_ms(fn), cuda_ms(fn))
                  for name, fn in library.items()}
    for name, entry in dft_k.items():
        aligned = min(cuda_ms(entry["aligned"]), cuda_ms(entry["aligned"]))
        log(f"  {name}: torch.matmul on the same operands "
            f"{library_ms[name]:.4f} ms, on operands padded to aligned "
            f"widths {aligned:.4f} ms; kernel {times[name][0]:.4f} ms")
    bounds = {name: bound(*w) for name, w in work.items()}
    for name in times:
        b_ms, b_by = bounds[name]
        log(f"  {name}: bound {b_ms:.4f} ms ({b_by}; "
            f"{work[name][0] / 1e6:.1f} MB, {work[name][1] / 1e9:.3f} G "
            f"operations), "
            f"kernel at {100 * b_ms / times[name][0]:.1f}% of it; library "
            f"call {'none' if name not in library_ms else f'{library_ms[name]:.4f} ms'}")

    def encode_kernels():
        spec = mel_ops.mel_encode_batch(x, cfg.num_mels, n_fft, hop, fwd, win)
        return quantize.quantize_mel_plane_batch(spec)

    def encode_plain():
        m = rfft_mag.stft_mag_plain(x, win, n_fft, hop)
        return quantize.quantize_mel_plane_plain(
            mel_ops.mel_from_mags_plain(m, fwd))

    e2e_k, e2e_p = race(encode_kernels, encode_plain)
    audio_s = BATCH * padded / SAMPLE_RATE
    log(f"  mel_encode_batch + quantize, [{BATCH}, {padded}], device: kernels "
        f"{e2e_k:.4f} ms = {audio_s / (e2e_k / 1e3):.1f} audio-s/s; plain "
        f"{e2e_p:.4f} ms = {audio_s / (e2e_p / 1e3):.1f} audio-s/s")
    called = wall_ms(encode_kernels)
    log(f"  the same, called back to back from Python (host clock): kernels "
        f"{called:.4f} ms = {audio_s / (called / 1e3):.1f} audio-s/s")

    # the mel encode from PCM: the int16 mode (one launch) against KA then
    # the float launch, both to the log-mel and with KD after
    def pcm_logmel_int16():
        return mel_ops.stft_mel_log_pcm16(pcm, 32768.0, padded, win, n_fft,
                                          hop, fwd)

    def pcm_logmel_ka():
        return mel_ops.stft_mel_log(quantize.pcm16_ingest_batch(
            pcm, f32, 32768.0, padded), win, n_fft, hop, fwd)

    for label, a_fn, b_fn in (
            ("PCM -> log-mel", pcm_logmel_int16, pcm_logmel_ka),
            ("PCM -> mel encode + quantize",
             lambda: quantize.quantize_mel_plane_batch(pcm_logmel_int16()),
             lambda: quantize.quantize_mel_plane_batch(pcm_logmel_ka()))):
        a_ms, b_ms = race(a_fn, b_fn, label)
        log(f"  {label}, [{BATCH}, {length}] int16, device: the int16 fused "
            f"launch {a_ms:.4f} ms = {audio_s / (a_ms / 1e3):.1f} audio-s/s; "
            f"KA + the float launch {b_ms:.4f} ms = "
            f"{audio_s / (b_ms / 1e3):.1f} audio-s/s; ratio {a_ms / b_ms:.3f}"
            f"; called back to back (host clock) {wall_ms(a_fn):.4f} and "
            f"{wall_ms(b_fn):.4f} ms")

    def phase_encode_kernels():
        sp = phase_ops.phase_encode_batch(x, nf, n_fft, hop, win)
        return quantize.quantize_planes_batch(sp, 255, 0)

    def phase_encode_plain():
        return quantize.quantize_planes_plain(
            rfft_mag.stft_planes_plain(x, win, n_fft, hop, 1, nf), 255, 0)

    def phase_decode_kernels():
        return phase_ops.dequantize_decode(img_p, mx_p, mn_p, 255, 0, n_fft,
                                           hop, 0.0, win, pcm16=True)

    def phase_decode_plain():
        return phase_ops.dequantize_decode_plain(img_p, mx_p, mn_p, 255, 0,
                                                 n_fft, hop, 0.0, win,
                                                 pcm16=True)

    out_s = BATCH * (n_fft + (frames - 1) * hop) / SAMPLE_RATE
    for label, kfn, pfn, secs in (
            ("phase_encode_batch + quantize_planes", phase_encode_kernels,
             phase_encode_plain, audio_s),
            ("dequantize + phase decode + PCM-16", phase_decode_kernels,
             phase_decode_plain, out_s)):
        k_ms, p_ms = race(kfn, pfn, label)
        c_ms = wall_ms(kfn)
        log(f"  {label}, [{BATCH}, {frames} frames], device: kernels "
            f"{k_ms:.4f} ms = {secs / (k_ms / 1e3):.1f} audio-s/s; plain "
            f"{p_ms:.4f} ms = {secs / (p_ms / 1e3):.1f} audio-s/s; called back "
            f"to back (host clock) {c_ms:.4f} ms = "
            f"{secs / (c_ms / 1e3):.1f} audio-s/s")

    def gl_plain(m_half, n_iter: int, momentum: float, pcm16: bool):
        """Griffin-Lim from sig0 through the plain versions."""
        sig, t_prev = sig0, sig0
        for _ in range(n_iter - 1):
            fw = griffinlim.gl_project_plain(sig, m_half, win, n_fft, hop)
            if momentum:
                sig, t_prev = griffinlim.gl_overlap_add_plain(fw, hop, t_prev,
                                                              momentum)
            else:
                sig = griffinlim.gl_overlap_add_plain(fw, hop)
        fw = griffinlim.gl_project_plain(sig, m_half, win, n_fft, hop)
        return griffinlim.gl_overlap_add_plain(fw, hop, pcm16=pcm16)

    def decode_kernels():
        m_half = mel_ops.mel_to_magnitudes(img, inv, mgc_max=mx, mgc_min=mn)
        return griffinlim.griffin_lim(m_half, hop, 2, window=win, init=sig0,
                                      pcm16=True)

    def decode_plain():
        return gl_plain(mel_ops.mel_to_magnitudes_plain(
            img, inv, mgc_max=mx, mgc_min=mn), 2, 0.0, True)

    mom24, it24 = griffinlim.recommended_gl(64)
    gl_out_s = BATCH * gl_len / SAMPLE_RATE
    for label, kfn, pfn in (
            ("dequantize + KI + GL-2 + PCM-16 (the towav device work)",
             decode_kernels, decode_plain),
            ("one GL iteration (KJ + KK)",
             lambda: griffinlim.gl_overlap_add(griffinlim.gl_project(
                 sig0, mag, win, n_fft, hop), hop),
             lambda: gl_plain(mag, 1, 0.0, False))):
        k_ms, p_ms = race(kfn, pfn, label)
        c_ms = wall_ms(kfn)
        log(f"  {label}, [{BATCH}, {frames} frames], device: kernels "
            f"{k_ms:.4f} ms = {gl_out_s / (k_ms / 1e3):.1f} audio-s/s; plain "
            f"{p_ms:.4f} ms = {gl_out_s / (p_ms / 1e3):.1f} audio-s/s; called "
            f"back to back (host clock) {c_ms:.4f} ms = "
            f"{gl_out_s / (c_ms / 1e3):.1f} audio-s/s")
    # recommended_gl(64): the plain version's ~35 small kernels an iteration
    # would fill the launch queue behind the sleep, so both run as CUDA graphs
    k_ms, p_ms = race(
        graph(lambda: griffinlim.griffin_lim(mag, hop, it24, window=win,
                                             init=sig0, momentum=mom24)),
        graph(lambda: gl_plain(mag, it24, mom24, False)), "recommended_gl(64)")
    log(f"  recommended_gl(64) = momentum {mom24} x {it24} iterations, "
        f"[{BATCH}, {frames} frames], device (CUDA graph replays): kernels "
        f"{k_ms:.4f} ms = {gl_out_s / (k_ms / 1e3):.1f} audio-s/s; plain "
        f"{p_ms:.4f} ms = {gl_out_s / (p_ms / 1e3):.1f} audio-s/s")

    # the race of this slice: one interior Griffin-Lim iteration on the
    # tensor cores (KN's projection + KO, bf16 operands) against the exact
    # one (KJ), each with KK's momentum step
    def iteration(backend):
        return lambda: griffinlim.gl_overlap_add(griffinlim.gl_project(
            sig0, mag, win, n_fft, hop, backend,
            window_host=hann_window(n_fft)), hop, sig0, 0.99)
    mm_ms, kj_ms = race(iteration("mm"), iteration("auto"),
                        "interior GL iteration")
    log(f"  one interior GL iteration with momentum, [{BATCH}, {frames} "
        f"frames], device: mm (KN + KO + KK) {mm_ms:.4f} ms = "
        f"{gl_out_s / (mm_ms / 1e3):.1f} audio-s/s; exact (KJ + KK) "
        f"{kj_ms:.4f} ms = {gl_out_s / (kj_ms / 1e3):.1f} audio-s/s; mm / "
        f"exact {mm_ms / kj_ms:.3f}")
    for name, entry in route_k.items():
        k_ms, p_ms = race(entry["kernel"], entry["plain"], name)
        lib = min(cuda_ms(entry["library"]), cuda_ms(entry["library"]))
        b_ms, b_by = bound(*entry["work"])
        earlier = (f"; {EARLIER_MS[name]:.4f} recorded in PERF.md, ratio "
                   f"{k_ms / EARLIER_MS[name]:.3f}" if name in EARLIER_MS
                   else "")
        log(f"  {name}, n {entry['n']}, [{BATCH}, {x.shape[1]}]: "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, its torch.fft call alone "
            f"{lib:.4f} ms; bound {b_ms:.4f} ms ({b_by}; "
            f"{entry['work'][0] / 1e6:.1f} MB, {entry['work'][1] / 1e9:.3f} G "
            f"operations), kernel at {100 * b_ms / k_ms:.1f}% of it{earlier}")
    log(f"  xla route calls on the main-path drives: "
        f"{launches['xla_route']} (all sites)")

    rows = [{"name": name, "route": "cuda", "source": k.source,
             "replaces": k.replaces, "launches": launches[name],
             "max_abs_err": errs[name], "ms": times[name][0],
             "plain_ms": times[name][1], "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1],
             "library_ms": library_ms.get(name)}
            for name, k in kernels.items()]
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-worker"]:
        sys.exit(mp_worker(sys.argv[2:]))
    sys.exit(main())
