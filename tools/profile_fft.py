"""The FFT kernels' register-resident core against the radix-2 form it
replaced, and where the core spends its time, by ablation: the forward
kernels KB and KE, and the inverse kernels KJ (Griffin-Lim projection) and
KG (phase synthesis).

    python3 tools/profile_fft.py [--iters 20]

Needs one NVIDIA GPU and nvcc. Builds gomel_tpu_torch/csrc/rfft_mag.cu,
phase_encode.cu, griffinlim.cu and phase_decode.cu (with fft_core.cuh) as
shipped, each with the shared-memory form of its kernel that the register
cores replaced (tools/fft_earlier.cuh, built only here: entry points
prof_earlier_stft_mag, _stft_planes, _gl_project, _irfft_window; radix-2
Stockham, log2(n/2) passes through two shared buffers, one barrier each, or
the mixed radix over n/2's prime factors; one block a frame), and in
variants that each take work out of the register core. Then, on one card
and in turns (radix-2, core, core, radix-2), times both forms at the bench
shape of chip_smoke.py (2 x 1122 frames of 4096,
hop 1280, Hann) and at one shard of its 30-minute long-form file (1 x 16,875
frames): KB (magnitudes) and KE (bins 1..1536 as (im, re)) beside
``torch.fft.rfft`` of the same frames laid out in memory; KJ beside
``torch.fft.irfft`` of laid-out spectra (half its work) and ``rfft`` +
``irfft`` (two calls); KG on uint8 PNG planes (the bench's fromphase
decode) and, at the shard, on the spectrogram with its real-frame count
(the long-form decode's masked synthesis), beside ``torch.fft.irfft``. Each
row has the byte bound (each input and output moved once at 3.35 TB/s). The
variants' outputs are wrong by construction, only their times mean
anything:

  shipped             the kernels as the port builds them
  load_only           KB/KE: the first pass's loads and shared-memory writes
                      (no DFT), no later pass, the epilogue's arithmetic but
                      no store
  transform_only      KB/KE: no device-memory reads (registers from the
                      thread index), every pass and the epilogue's
                      arithmetic, no store
  store_only          KB/KE: no loads, DFTs or later passes: the first pass
                      writes index values, the epilogue reads, splits and
                      stores
  no_passes           KB/KE: everything but the passes after the first
  min_blocks_8        KB/KE: __launch_bounds__ asking for 8 blocks an SM
  points_8            KB/KE: 8 complex points a thread: radices 4, 8, 8, 8
                      at n = 4096, 256 threads a frame (its own plan)
  signal_ldcs         KB/KE: the signal loaded with the streaming hint
  inv_load_only       KJ/KG: everything before the inverse passes (KG: the
                      prologue's loads, pair split and shared writes; KJ: the
                      forward transform, the magnitudes and the projection),
                      no inverse pass and no store
  inv_transform_only  KJ/KG: no signal, magnitude or spectrum reads (values
                      from the thread index), every pass, no store
  inv_store_only      KJ/KG: no such reads, no forward passes, no DFTs: the
                      inverse's last pass alone reads the buffer and stores

The mixed-radix register core (KB, KE, KJ and KG where n/2 is not a power
of two) is raced the same way against the shared-memory mixed radix it
replaced (tools/fft_earlier.cuh) at n = 400, 1200, 3000 and 6000, hop n/4,
on the bench signal (2 rows of 30 s at 48 kHz): KB, KE (bins 1..0.384 n, as
the phase encode at 3000), KJ, and KG on half-spectrum planes, beside
``torch.fft.rfft`` / ``irfft`` (and KJ's ``rfft`` + ``irfft``) of the same
frames, each also with one frame a block; KB and KJ with the ablations:

  mixed_dense         the R x R product in place of each compile-time
                      butterfly, its roots constants of a table (the
                      earlier core's arithmetic in the new layout)
  mixed_scalar        the frames read by scalar loads (never 8-byte)
  mixed_radix30       register radices 20, 24 and 30 too (their own
                      plans: fewer passes, more registers)
  mixed_min_blocks_3  __launch_bounds__ asking for 3 blocks of 256 threads
                      an SM (a register cap of 85; the shipped build has 64)
  mixed_unroll_2      the butterfly loops unrolled by 2 (two butterflies'
                      loads in flight)
  mixed_linear_banks  every pass's shared accesses at j + t m/R, free of
                      bank conflicts and of the digit reversal (the wrong
                      points: what the conflicts cost)

Prints the card's name and power limit, ptxas's registers, shared memory
and spills of each kernel at n = 4096, of the radix-2 forms and of the
mixed kernels, and one line per measurement: device ms per call (CUDA
events over calls queued behind a sleep kernel, chip_smoke.cuda_ms, lower
of two runs; ``--mixed-only``: the mixed section alone). The same numbers, and
ptxas's lines for every kernel, go to chiprun_out/profile_fft.json. Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402
from gomel_tpu_torch.ops import _cuda, rfft_mag  # noqa: E402
from gomel_tpu_torch.ops.stft import frame_signal, hann_window  # noqa: E402

N, HOP, NF = 4096, 1280, 1536
SHAPES = {"bench": (2, 1122), "shard": (1, 16875)}
SHARD_REAL = 16872          # the last shard's real frames (67,497 in all)
FWD = ("rfft_mag.cu", "phase_encode.cu")
INV = ("griffinlim.cu", "phase_decode.cu")
MIX = ("rfft_mag.cu", "griffinlim.cu")      # KB and KJ: the mixed core
SOURCES = ("fft_core.cuh",) + FWD + INV
MIXED_N = (400, 1200, 3000, 6000)
RADIX30 = rfft_mag.MIXED_RADICES + (20, 24, 30)

# the earlier shared-memory forms (tools/fft_earlier.cuh), built into each
# variant's copy of their kernel's source
TOOLS = os.path.join(HERE, "tools")
_EARLIER = {"rfft_mag.cu": "KB", "phase_encode.cu": "KE",
            "griffinlim.cu": "KJ", "phase_decode.cu": "KG"}


def _dense_roots() -> str:
    """A constant table of exp(-2 pi i r / R), r < R, for every register
    radix R (float32 roundings), and dft_mixed as the R x R product with
    them, its outputs where the shipped butterfly leaves them."""
    import numpy as np
    rows = []
    for r in range(31):
        ang = -2.0 * np.pi * np.arange(30) / max(r, 1)
        vals = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
        rows.append("{" + ", ".join(f"{{{float(a)!r}f, {float(b)!r}f}}"
                                    for a, b in vals) + "}")
    return ("static __constant__ float2 kDenseRoots[31][30] = {\n" +
            ",\n".join(rows) + "};\n\n" + """
template <int R, bool kInverse>
__device__ __forceinline__ void dft_mixed(float2* v) {
  float2 x[R];
#pragma unroll
  for (int t = 0; t < R; ++t) x[t] = v[t];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    float re = 0.0f, im = 0.0f;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      float2 w = kDenseRoots[R][(t * s) % R];
      if (kInverse) w.y = -w.y;
      re += x[t].x * w.x - x[t].y * w.y;
      im += x[t].x * w.y + x[t].y * w.x;
    }
    v[out_pos<R>(s)] = make_float2(re, im);
  }
}

""")


_MIXED_DFT = ("template <int R, bool kInverse>\n"
              "__device__ __forceinline__ void dft_mixed(float2* v) {")
_MIXED_DENSE = ("fft_core.cuh", _MIXED_DFT, None)   # filled in by build()
_MIXED_SCALAR = [
    ("rfft_mag.cu", "const auto s = static_cast<cudaStream_t>(stream);\n"
     "  const bool vec = frames_vec_aligned(x, window, batch_stride, hop);",
     "const auto s = static_cast<cudaStream_t>(stream);\n"
     "  const bool vec = false;"),
    ("griffinlim.cu",
     "const bool vec = frames_vec_aligned(sig, window, length, hop);",
     "const bool vec = false;"),
]
_MIXED_RADIX30 = ("fft_core.cuh", "X(15) X(16)", "X(15) X(16) X(20) X(24) X(30)")
_MIXED_MIN_BLOCKS = [(f, "__launch_bounds__(kMixedBlockThreads)",
                      "__launch_bounds__(kMixedBlockThreads, 3)") for f in MIX]
# every pass's shared-memory accesses at j + t m/R, the earlier core's
# conflict-free read pattern (the wrong points: a timing of the same work
# with no bank conflicts and no digit reversal)
_MIXED_LINEAR = [
    ("fft_core.cuh", "    float2* a = z + mixed_rev(j, pl) * R;\n#pragma unroll\n"
     "    for (int s = 0; s < R; ++s) a[s] = v[out_pos<R>(s)];",
     "#pragma unroll\n"
     "    for (int s = 0; s < R; ++s) z[j + s * stride] = v[out_pos<R>(s)];"),
    ("fft_core.cuh", "    float2* a = z + g * ns * R + k;",
     "    float2* a = z + b + 0 * g;"),
    ("fft_core.cuh", "v[t] = a[t * ns];", "v[t] = a[t * (pl.m / R)];"),
    ("fft_core.cuh", "a[s * ns] = v[out_pos<R>(s)];",
     "a[s * (pl.m / R)] = v[out_pos<R>(s)];"),
    ("fft_core.cuh", "        a[t * ns] = cmul<true>(",
     "        a[t * (pl.m / R)] = cmul<true>("),
    ("fft_core.cuh", "    const float2* a = z + mixed_rev(j, pl) * R;\n    float2 v[R];\n"
     "#pragma unroll\n    for (int s = 0; s < R; ++s) v[s] = a[s];",
     "    float2 v[R];\n#pragma unroll\n"
     "    for (int s = 0; s < R; ++s) v[s] = z[j + s * stride];"),
]
_MIXED_UNROLL = [("fft_core.cuh", loop, "#pragma unroll 2\n" + loop) for loop in (
    "  for (int u = 0; u < nb; ++u) {\n    const int j = th + u * pl.threads;\n"
    "    float2 v[R];",
    "  for (int u = 0; u < nb; ++u) {\n    const int b = th + u * pl.threads;",
    "  for (int u = 0; u < nb; ++u) {\n    const int j = th + u * pl.threads;\n"
    "    const float2* a = z + mixed_rev(j, pl) * R;")]

# (file, text, replacement) edits; a text not found exactly once fails
_NO_LOAD = ("fft_core.cuh", "valid ? load_pair(src, window, off, vec)",
            "valid ? make_float4(th, c, off, 1.0f)")
_NO_DFT1 = ("fft_core.cuh",
            "    dft_regs<R, kInverse>(&v[u * R]);\n"
            "    store_dft<R, 1>(z, &v[u * R], swz((B * th + u) * R));",
            "    store_dft<R, 1>(z, &v[u * R], swz((B * th + u) * R));")
_NO_PASSES = ("fft_core.cuh", "  later_passes<kLogM, 1, r0, false>(z, twp, th);",
              "")
_NO_STORE = [
    ("rfft_mag.cu",
     "  dst[k] = sqrtf(a.x * a.x + a.y * a.y);\n"
     "  if (2 * k != m) dst[m - k] = sqrtf(b.x * b.x + b.y * b.y);",
     "  const float g = sqrtf(a.x * a.x + a.y * a.y) +\n"
     "                  sqrtf(b.x * b.x + b.y * b.y);\n"
     "  if (__float_as_uint(g) == 0xdeadbeefu) dst[k] = g;"),
    ("phase_encode.cu",
     "    if (k >= first && k <= last) dst[k - first] = make_float2(a.y, a.x);\n"
     "    if (2 * k != m && m - k >= first && m - k <= last) {\n"
     "      dst[m - k - first] = make_float2(b.y, b.x);\n"
     "    }",
     "    if (__float_as_uint(a.x + b.x) == 0xdeadbeefu) dst[k - first] = a;"),
]
# the inverse kernels: no reads of the magnitudes (KJ) or spectrum (KG)
_INV_NO_LOAD = [
    ("griffinlim.cu", "const float mk = mg[k], mq = mg[m - k];",
     "const float mk = 1.0f + k, mq = 2.0f + m;"),
    ("phase_decode.cu",
     "    const float2 p = half_bin<kMode>(src, aux0, frame, bi, fi, k, m, frames,\n"
     "                                     nf, max_val, ext, ihs_passes);\n"
     "    const float2 q = half_bin<kMode>(src, aux0, frame, bi, fi, m - k, m,\n"
     "                                     frames, nf, max_val, ext, ihs_passes);",
     "    const float2 p = make_float2(k, th), q = make_float2(th, ext.x + k);"),
]
_INV_CALL = "  inv_passes<kLogM, 0, 1>(z, twp, th, dst, w2, inv_n, zero);"
_INV_NO_PASSES = ("fft_core.cuh", _INV_CALL,
                  "  if (dst != nullptr && __float_as_uint(z[swz(th)].x) == "
                  "0xdeadbeefu) dst[th] = z[th];")
_INV_LAST_ONLY = ("fft_core.cuh", _INV_CALL, """\
  using P = FwdPlan<kLogM>;
  constexpr int kR = 1 << P::pass_log(P::num_passes() - 1);
  inv_pass<kR, P::m, P::m / kR, P::threads, true>(z, twp, th, dst, w2, inv_n,
                                                  zero);""")
_INV_NO_DFT = ("fft_core.cuh", "    dft_regs<R, true>(&v[u * R]);", "")
_INV_NO_STORE = ("fft_core.cuh",
                 "dst[i] = zero ? make_float2(0.0f, 0.0f) : make_float2(x0, x1);",
                 "if (__float_as_uint(x0 + x1) == 0xdeadbeefu) dst[i] = y;")


def _min_blocks(n: int) -> list[tuple[str, str, str]]:
    """__launch_bounds__ asking for n blocks an SM (a register cap) of KB's
    and KE's kernels (not the fused KB + KC launch beside KB's)."""
    old = "FwdPlan<kLogM>::frames_per_block)\n"
    return [(f, old + k, old[:-2] + f", {n})\n" + k)
            for f, k in zip(FWD, ("stft_mag_pow2_kernel(",
                                  "stft_planes_pow2_kernel("))]


_P8 = ("fft_core.cuh", "constexpr int kRegPoints = 16;",
       "constexpr int kRegPoints = 8;")
# name -> (complex points a thread, edits, the sources built)
VARIANTS = {
    "shipped": (16, [], FWD + INV),
    "load_only": (16, [_NO_DFT1, _NO_PASSES, *_NO_STORE], FWD),
    "transform_only": (16, [_NO_LOAD, *_NO_STORE], FWD),
    "store_only": (16, [_NO_LOAD, _NO_DFT1, _NO_PASSES], FWD),
    "no_passes": (16, [_NO_PASSES], FWD),
    "min_blocks_8": (16, _min_blocks(8), FWD),
    "points_8": (16 // 2, [_P8], FWD),
    "signal_ldcs": (16, [("fft_core.cuh",
                          "x = __ldg(reinterpret_cast<const float4*>(src + off));",
                          "x = __ldcs(reinterpret_cast<const float4*>(src + off));")],
                    FWD),
    "inv_load_only": (16, [_INV_NO_PASSES], INV),
    "inv_transform_only": (16, [_NO_LOAD, *_INV_NO_LOAD, _INV_NO_STORE], INV),
    "inv_store_only": (16, [_NO_LOAD, _NO_DFT1, _NO_PASSES, *_INV_NO_LOAD,
                            _INV_LAST_ONLY, _INV_NO_DFT], INV),
    "mixed_dense": (16, [_MIXED_DENSE], MIX),
    "mixed_scalar": (16, _MIXED_SCALAR, MIX),
    "mixed_radix30": (16, [_MIXED_RADIX30], MIX),
    "mixed_min_blocks_3": (16, _MIXED_MIN_BLOCKS, MIX),
    "mixed_unroll_2": (16, _MIXED_UNROLL, MIX),
    "mixed_linear_banks": (16, _MIXED_LINEAR, MIX),
}
# the kernels each group of sources holds
KINDS = {FWD: ("KB", "KE"), INV: ("KJ", "KG"), MIX: ()}


def build(work: str) -> dict[str, tuple[ctypes.CDLL, str]]:
    """One nvcc per variant (its sources into one library), all started
    together; returns the loaded libraries with ptxas's report."""
    texts = {}
    for name in SOURCES:
        with open(os.path.join(_cuda.CSRC_DIR, name)) as f:
            texts[name] = f.read()
    jobs = {}
    for variant, (_, edits, units) in VARIANTS.items():
        d = os.path.join(work, variant)
        os.makedirs(d, exist_ok=True)
        files = dict(texts)
        for name, old, new in edits:
            if new is None:     # the dense butterfly before the shipped one
                new = _dense_roots() + old.replace("dft_mixed(",
                                                   "dft_mixed_nested(")
            if files[name].count(old) != 1:
                raise RuntimeError(f"variant {variant}: {old!r} is not in "
                                   f"{name} exactly once")
            files[name] = files[name].replace(old, new)
        for name, kind in _EARLIER.items():
            files[name] += (f"\n#define GOMEL_EARLIER_{kind}\n"
                            f"#include \"fft_earlier.cuh\"\n")
        for name, text in files.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        lib = os.path.join(d, "lib.so")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I",
               _cuda.CSRC_DIR, "-I", TOOLS, "-o", lib,
               *(os.path.join(d, u) for u in units)]
        log = open(os.path.join(d, "build.log"), "w")
        jobs[variant] = (subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT), lib, log)
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    earlier = {
        "prof_earlier_stft_mag": [i32, p, p, p, p, i64, i64, i64, i64, i64],
        "prof_earlier_stft_planes": [i32, p, p, p, p, i64, i64, i64, i64, i64,
                                     i32, i32],
        "prof_earlier_gl_project": [i32, p, p, p, p, p, i64, i64, i64, i64,
                                    i64],
        "prof_earlier_irfft_window": [i32, i32, p, p, p, p, p, p, i64, i64,
                                      i64, i64, i64, f32, i32],
    }
    libs = {}
    for variant, (proc, lib, log) in jobs.items():
        proc.wait()
        log.close()
        with open(log.name) as f:
            report = f.read()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{report}")
        handle = ctypes.CDLL(lib)
        units = VARIANTS[variant][2]
        symbols = [s for s in ("gomel_stft_mag", "gomel_stft_planes",
                               "gomel_gl_project", "gomel_irfft_window")
                   if hasattr(handle, s)]
        for pair in [symbols]:
            for symbol in pair:
                fn = getattr(handle, symbol)
                fn.argtypes = [*_cuda._SIGNATURES[symbol], i32, p]
                fn.restype = i32
        for symbol, args in earlier.items():
            if hasattr(handle, symbol):
                getattr(handle, symbol).argtypes = [*args, i32, p]
                getattr(handle, symbol).restype = i32
        libs[variant] = (handle, report)
    return libs


def ptxas_lines(report: str) -> list[str]:
    """ptxas's spill and register lines of each kernel entry."""
    out, entry, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), ""
        m = re.search(r"\d+ bytes stack frame.*", line)
        if m and entry:
            spill = m.group(0).strip()
        m = re.search(r"Used \d+ registers.*", line)
        if m and entry:
            out.append(f"{entry}: {m.group(0).strip()}; {spill}")
            entry = None
    return out


def _at_n(line: str) -> bool:
    """A ptxas line of a register-core kernel at n = N, or of a radix-2
    form (the earlier kernels built with kPow2 true)."""
    return f"Li{N.bit_length() - 2}E" in line or "Lb1E" in line


def mixed_race(libs, dev, iters: int, record) -> None:
    """The mixed-radix register core against the shared-memory mixed radix
    it replaced at MIXED_N on the bench signal, beside torch.fft: KB, KE
    (bins 1..0.384 n, the phase encode's share at 3000), KJ and KG (on
    half-spectrum planes, as phase 4 times it), and KB's and KJ's mixed
    ablations."""
    g = torch.Generator(device=dev).manual_seed(1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    length = 1_440_000 + 2 * 1280          # the bench rows, padded
    x = torch.rand((2, length), generator=g, device=dev) - 0.5
    shipped = libs["shipped"][0]
    for n in MIXED_N:
        hop, nf = n // 4, n * 384 // 1000
        frames = (length - n) // hop + 1
        sig = x[:, :n + (frames - 1) * hop].contiguous()
        win = torch.tensor(hann_window(n), dtype=torch.float32, device=dev)
        tw = rfft_mag._twiddles(n, dev)
        mag = torch.empty((2, frames, n // 2 + 1), device=dev)
        pairs = torch.empty((2, frames, nf, 2), device=dev)
        target = torch.rand((2, frames, n // 2 + 1), generator=g,
                            device=dev) * 3
        re, im = (torch.randn((2, frames, n // 2 + 1), generator=g,
                              device=dev) for _ in range(2))
        fw = torch.empty((2, frames, n), device=dev)
        plans = {}
        for name, radices in (("shipped", rfft_mag.MIXED_RADICES),
                              ("radix30", RADIX30)):
            pl = rfft_mag.mixed_plan(n, radices)
            table = torch.from_numpy(rfft_mag._mixed_twiddles_np(
                n, radices)).to(dev)
            plans[name] = (pl, table)

        def kb(lib, plan="shipped", per_block=None):
            pl, table = plans[plan]
            return lambda: lib.gomel_stft_mag(
                x.data_ptr(), win.data_ptr(), tw.data_ptr(), table.data_ptr(),
                mag.data_ptr(), 2, frames, length, hop, n, pl.code,
                pl.threads, per_block or pl.frames_per_block, dev.index,
                stream)

        def ke(lib, plan="shipped", per_block=None):
            pl, table = plans[plan]
            return lambda: lib.gomel_stft_planes(
                x.data_ptr(), win.data_ptr(), tw.data_ptr(), table.data_ptr(),
                pairs.data_ptr(), 2, frames, length, hop, n, 1, nf, pl.code,
                pl.threads, per_block or pl.frames_per_block, dev.index,
                stream)

        def kj(lib, plan="shipped", per_block=None):
            pl, table = plans[plan]
            return lambda: lib.gomel_gl_project(
                sig.data_ptr(), target.data_ptr(), win.data_ptr(),
                tw.data_ptr(), table.data_ptr(), fw.data_ptr(), 2, frames,
                sig.shape[1], hop, n, pl.code, pl.threads,
                per_block or pl.frames_per_block, dev.index, stream)

        def kg(lib, plan="shipped", per_block=None):
            pl, table = plans[plan]
            return lambda: lib.gomel_irfft_window(
                0, re.data_ptr(), im.data_ptr(), None, win.data_ptr(),
                tw.data_ptr(), table.data_ptr(), fw.data_ptr(), 2, frames,
                frames, n // 2 + 1, n, 0.0, 0, pl.code, pl.threads,
                per_block or pl.frames_per_block, dev.index, stream)

        old = {"KB": lambda: shipped.prof_earlier_stft_mag(
                   0, x.data_ptr(), win.data_ptr(), tw.data_ptr(),
                   mag.data_ptr(), 2, frames, length, hop, n, dev.index,
                   stream),
               "KE": lambda: shipped.prof_earlier_stft_planes(
                   0, x.data_ptr(), win.data_ptr(), tw.data_ptr(),
                   pairs.data_ptr(), 2, frames, length, hop, n, 1, nf,
                   dev.index, stream),
               "KJ": lambda: shipped.prof_earlier_gl_project(
                   0, sig.data_ptr(), target.data_ptr(), win.data_ptr(),
                   tw.data_ptr(), fw.data_ptr(), 2, frames, sig.shape[1], hop,
                   n, dev.index, stream),
               "KG": lambda: shipped.prof_earlier_irfft_window(
                   0, 0, re.data_ptr(), im.data_ptr(), None, win.data_ptr(),
                   tw.data_ptr(), fw.data_ptr(), 2, frames, frames,
                   n // 2 + 1, n, 0.0, 0, dev.index, stream)}
        framed = (frame_signal(x, n, hop) * win).contiguous()
        spec = torch.fft.rfft(framed, dim=-1)
        half = torch.complex(re, im)
        rfft_ms = min(chip_smoke.cuda_ms(
            lambda: torch.fft.rfft(framed, dim=-1), iters) for _ in range(2))
        irfft_ms = min(chip_smoke.cuda_ms(
            lambda: torch.fft.irfft(spec, n=n), iters) for _ in range(2))
        lib_ms = {
            "KB": {"rfft_ms": rfft_ms}, "KE": {"rfft_ms": rfft_ms},
            "KJ": {"irfft_ms": irfft_ms,
                   "rfft_irfft_ms": min(chip_smoke.cuda_ms(
                       lambda: torch.fft.irfft(torch.fft.rfft(
                           framed, dim=-1), n=n), iters) for _ in range(2))},
            "KG": {"irfft_ms": min(chip_smoke.cuda_ms(
                lambda: torch.fft.irfft(half, n=n), iters)
                for _ in range(2))}}
        inputs = {"KB": (x, win, mag), "KE": (x, win, pairs),
                  "KJ": (sig, target, win, fw), "KG": (re, im, win, fw)}
        for kind, make, out in (("KB", kb, mag), ("KE", ke, pairs),
                                ("KJ", kj, fw), ("KG", kg, fw)):
            new_fn, old_fn = make(shipped), old[kind]
            for fn in (new_fn, old_fn):
                if fn() != 0:
                    raise RuntimeError(f"{kind} n {n}: launch failed")
            torch.cuda.synchronize()
            new_out = out.clone()
            old_fn()
            torch.cuda.synchronize()
            if kind == "KJ":
                rel = chip_smoke.rel_l2(new_out, out)
            else:
                dims = tuple(range(2, out.dim()))
                rel = float(((new_out - out).abs() / out.abs().amax(
                    dims, keepdim=True).clamp_min(1e-30)).max())
            if rel > (1e-4 if kind == "KJ" else 1e-5):
                raise AssertionError(f"{kind} n {n}: the mixed core against "
                                     f"the earlier form {rel:.3e}")
            new_ms, old_ms = chip_smoke.race(new_fn, old_fn, kind, iters)
            b_ms = chip_smoke.bound(chip_smoke.nbytes(*inputs[kind]), 0.0)[0]
            pl = plans["shipped"][0]
            record(kernel=kind, n=n, frames=2 * frames,
                   plan=f"{'x'.join(map(str, pl.radices))} P {pl.points} "
                        f"T {pl.threads} F {pl.frames_per_block}",
                   mixed_core_ms=new_ms, earlier_ms=old_ms,
                   speedup=old_ms / new_ms, bound_ms=b_ms,
                   bound_share=b_ms / new_ms, **lib_ms[kind],
                   core_vs_library=new_ms / next(iter(lib_ms[kind].values())),
                   core_vs_earlier_rel_err=rel)
            runs = {"one frame a block": make(shipped, per_block=1)}
            if kind in ("KB", "KJ"):
                for variant in ("mixed_dense", "mixed_scalar",
                                "mixed_radix30", "mixed_min_blocks_3",
                                "mixed_unroll_2", "mixed_linear_banks"):
                    runs[variant] = make(libs[variant][0], "radix30" if
                                         variant == "mixed_radix30"
                                         else "shipped")
            for variant, fn in runs.items():
                if fn() != 0:
                    raise RuntimeError(f"{kind} n {n} {variant}: launch "
                                       f"failed")
                ms = min(chip_smoke.cuda_ms(fn, iters) for _ in range(2))
                record(kernel=kind, n=n, variant=variant, ms=ms,
                       share_of_shipped=ms / new_ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--mixed-only", action="store_true",
                    help="only the mixed-radix section")
    ap.add_argument("--sass", action="store_true",
                    help="also write the shipped build's SASS (cuobjdump) to "
                         "chiprun_out/profile_fft.sass")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fft: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = build(os.path.join(_cuda.BUILD_DIR, "profile_fft"))
    if args.sass:
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
        with open(os.path.join(HERE, "chiprun_out", "profile_fft.sass"),
                  "w") as f:
            subprocess.run([cuobjdump, "-sass", os.path.join(
                _cuda.BUILD_DIR, "profile_fft", "shipped", "lib.so")],
                stdout=f, check=True, timeout=120)
    ptxas = ptxas_lines(libs["shipped"][1])
    for line in ptxas:
        if _at_n(line):
            print(f"  ptxas {line}")
    for variant, (_, report) in libs.items():
        for line in ptxas_lines(report):
            if "mixed" in line or (variant != "shipped" and "pow2" in line
                                   and _at_n(line)):
                print(f"  ptxas, {variant}: {line}")
    plan = rfft_mag.fwd_plan(N)
    print(f"  plan n {N}: radices {plan.radices}, {plan.threads} threads a "
          f"frame, {plan.frames_per_block} frames a block, "
          f"{plan.smem_bytes} bytes of shared memory a block")
    win = torch.tensor(hann_window(N), dtype=torch.float32, device=dev)
    tw = rfft_mag._twiddles(N, dev)
    plans = {}
    for points in {v[0] for v in VARIANTS.values()}:
        pl = rfft_mag.fwd_plan(N, points)
        table = torch.from_numpy(rfft_mag._pass_twiddles_np(N, points)).to(dev)
        plans[points] = (table, pl.code, pl.threads, pl.frames_per_block)
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    results = []

    def record(**row):
        results.append(row)
        print("  " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                               else f"{k} {v}" for k, v in row.items()),
              flush=True)

    def peak_rel(a, b):
        """max |a - b| / b's frame peak."""
        peak = b.abs().amax(dim=tuple(range(2, b.dim())), keepdim=True)
        return float(((a - b).abs() / peak.clamp_min(1e-30)).max())

    for shape, (batch, frames) in ({} if args.mixed_only else SHAPES).items():
        length = N + (frames - 1) * HOP
        x = torch.rand((batch, length), generator=g, device=dev) - 0.5
        mag = torch.empty((batch, frames, N // 2 + 1), device=dev)
        pairs = torch.empty((batch, frames, NF, 2), device=dev)
        fw = torch.empty((batch, frames, N), device=dev)
        common = (batch, frames, length, HOP, N)
        target = torch.rand((batch, frames, N // 2 + 1), generator=g,
                            device=dev) * 3
        if shape == "bench":        # the fromphase decode: uint8 PNG planes
            mode, real = 2, frames
            src = torch.randint(0, 256, (batch, NF, frames, 2), generator=g,
                                device=dev, dtype=torch.uint8)
            aux = (torch.tensor([[41.5, 37.25]] * batch, device=dev),
                   torch.tensor([[-40.75, -38.5]] * batch, device=dev))
            max_val = 255.0
        else:                       # the long-form decode's masked synthesis
            mode, real = 1, SHARD_REAL
            src = torch.randn((batch, frames, NF, 2), generator=g, device=dev)
            aux, max_val = (), 0.0
        aux_ptrs = [t.data_ptr() for t in aux] + [None] * (2 - len(aux))
        kg_args = (src.data_ptr(), *aux_ptrs, win.data_ptr(), tw.data_ptr())
        kg_dims = (batch, frames, real, NF, N, max_val, 0)

        def core(lib, kind, points=16):
            table, code, threads, per_block = plans[points]
            tw_pass, plan_args = table.data_ptr(), (code, threads, per_block)
            if kind == "KB":
                return lambda: lib.gomel_stft_mag(
                    x.data_ptr(), win.data_ptr(), tw.data_ptr(), tw_pass,
                    mag.data_ptr(), *common, *plan_args, dev.index, stream)
            if kind == "KE":
                return lambda: lib.gomel_stft_planes(
                    x.data_ptr(), win.data_ptr(), tw.data_ptr(), tw_pass,
                    pairs.data_ptr(), *common, 1, NF, *plan_args, dev.index,
                    stream)
            if kind == "KJ":
                return lambda: lib.gomel_gl_project(
                    x.data_ptr(), target.data_ptr(), win.data_ptr(),
                    tw.data_ptr(), tw_pass, fw.data_ptr(), *common,
                    *plan_args, dev.index, stream)
            return lambda: lib.gomel_irfft_window(
                mode, *kg_args, tw_pass, fw.data_ptr(), *kg_dims, *plan_args,
                dev.index, stream)

        def radix2(lib, kind):
            if kind == "KB":
                return lambda: lib.prof_earlier_stft_mag(
                    1, x.data_ptr(), win.data_ptr(), tw.data_ptr(),
                    mag.data_ptr(), *common, dev.index, stream)
            if kind == "KE":
                return lambda: lib.prof_earlier_stft_planes(
                    1, x.data_ptr(), win.data_ptr(), tw.data_ptr(),
                    pairs.data_ptr(), *common, 1, NF, dev.index, stream)
            if kind == "KJ":
                return lambda: lib.prof_earlier_gl_project(
                    1, x.data_ptr(), target.data_ptr(), win.data_ptr(),
                    tw.data_ptr(), fw.data_ptr(), *common, dev.index, stream)
            return lambda: lib.prof_earlier_irfft_window(
                1, mode, *kg_args, fw.data_ptr(), *kg_dims, dev.index, stream)

        framed = (frame_signal(x, N, HOP) * win).contiguous()
        spec = torch.complex(torch.randn_like(target), torch.randn_like(target))
        rfft_ms = min(chip_smoke.cuda_ms(lambda: torch.fft.rfft(framed, dim=-1),
                                         args.iters) for _ in range(2))
        irfft_ms = min(chip_smoke.cuda_ms(lambda: torch.fft.irfft(spec, n=N),
                                          args.iters) for _ in range(2))
        both_ms = min(chip_smoke.cuda_ms(lambda: torch.fft.irfft(
            torch.fft.rfft(framed, dim=-1), n=N), args.iters)
            for _ in range(2))
        inputs = {"KB": (x, win), "KE": (x, win), "KJ": (x, target, win),
                  "KG": (src, *aux, win)}
        library = {"KB": {"rfft_ms": rfft_ms}, "KE": {"rfft_ms": rfft_ms},
                   "KJ": {"irfft_ms": irfft_ms, "rfft_irfft_ms": both_ms},
                   "KG": {"irfft_ms": irfft_ms}}
        shipped = libs["shipped"][0]
        for kind, out in (("KB", mag), ("KE", pairs), ("KJ", fw), ("KG", fw)):
            new_fn, old_fn = core(shipped, kind), radix2(shipped, kind)
            for fn in (new_fn, old_fn):
                if fn() != 0:
                    raise RuntimeError(f"{kind} {shape}: launch failed")
            torch.cuda.synchronize()
            new_out = out.clone()
            old_fn()
            torch.cuda.synchronize()
            if kind == "KJ":
                rel, limit = chip_smoke.rel_l2(new_out, out), 1e-4
            else:
                rel, limit = peak_rel(new_out, out), 1e-5
            if rel > limit:
                raise AssertionError(f"{kind} {shape}: core against radix-2 "
                                     f"{rel:.3e} > {limit}")
            if kind == "KG" and real < frames and new_out[:, real:].any():
                raise AssertionError(f"KG {shape}: masked frames not zero")
            new_ms, old_ms = chip_smoke.race(new_fn, old_fn, kind, args.iters)
            b_ms = chip_smoke.bound(chip_smoke.nbytes(*inputs[kind], out),
                                    0.0)[0]
            lib_ms = library[kind]
            first_lib = next(iter(lib_ms.values()))
            record(kernel=kind, shape=shape, frames=batch * frames,
                   core_ms=new_ms, radix2_ms=old_ms, speedup=old_ms / new_ms,
                   bound_ms=b_ms, bound_share=b_ms / new_ms, **lib_ms,
                   core_vs_library=new_ms / first_lib,
                   core_vs_radix2_rel_err=rel)
            if shape != "bench":
                continue
            base = new_ms
            for variant, (lib, _) in libs.items():
                points, _, units = VARIANTS[variant]
                if variant == "shipped" or kind not in KINDS[units]:
                    continue
                fn = core(lib, kind, points)
                if fn() != 0:
                    raise RuntimeError(f"{kind} {variant}: launch failed")
                ms = min(chip_smoke.cuda_ms(fn, args.iters) for _ in range(2))
                record(kernel=kind, shape=shape, variant=variant, ms=ms,
                       share_of_shipped=ms / base)
    mixed_race(libs, dev, args.iters, record)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile_fft.json"), "w") as f:
        json.dump({"card": card, "ptxas": ptxas, "plan": plan._asdict(),
                   "results": results}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
