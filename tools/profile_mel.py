"""KC (the mel filterbank + log), the fused KB + KC launch and KL (the
long-form dequantize) against the forms they replaced, and where their time
goes, by ablation.

    python3 tools/profile_mel.py [--iters 20] [--cases LABEL ...]

Needs one NVIDIA GPU and nvcc. Builds gomel_tpu_torch/csrc/mel_log.cu (KC),
rfft_mag.cu (KB and the fused launch) and dequantize.cu (KL) as shipped,
together with tools/mel_dequant_earlier.cu (the earlier KC: a block a frame
over the dense W_ext; the earlier KL: one element a thread; KL with 16
bytes of input and 4 float4 stores a thread, "wide"; and the shipped KL's
walk with a per-channel lookup table for uint8 in place of the division,
"lut"), and once more for each ablation, a source edit a build:

  kc_copy_only      one term a column and no log: KC's copy and stores
                    (the bytes' achievable time)
  kc_table_shared   KC's band table staged in shared memory once a block,
                    not read through L1
  kc_tile_2/4/8     KC's tiles of 2, 4 or 8 frames at n = 4096 (shipped: 1)
  kc_t128           KC's blocks of 128 threads, not 256
  kc_rows_2_tile_2, kc_rows_4_tile_4
                    each lane summing its column for 2 or 4 frames at once,
                    in tiles of as many frames
  fused_no_sums     the fused launch without the band sums (KB's transform
                    and the magnitudes into shared memory)
  fused_load_only, fused_transform_only, fused_sums_only
                    the fused launch's split: the first pass's loads with
                    the split (no DFT, later pass or sums); every pass and
                    the split with no signal read and no sums; the split
                    and the sums with no signal read, DFT or later pass
  fused_store_mags  the fused launch also storing the magnitudes to device
                    memory, as KB does
  fused_min_blocks_10
                    the fused launch asking for 10 blocks an SM (48
                    registers; shipped: 9 at 56)
  sums_items_divided
                    the band sums' items found by a division an item, as
                    before the carried walk (mel_bands.cuh mel_next_item)
  fused_sums_no_conflict
                    the per-frame sums reading a lane's own bins (wrong
                    values, no bank conflict): what the conflicts cost
  kl_copy_only      KL converts and stores each value, no arithmetic

Then, on one card and in turns (old, new, new, old; chip_smoke.race):

  KC bench     [2, 1122, 2049] magnitudes of the bench signal, CLI widths
  KC n = 3000  the same signal's [2, 1497, 1501] magnitudes (mixed radix)
  fused bench  the bench signal: the fused launch against KB then KC, KB
               then the earlier KC, and KB alone
  fused cell   the cell mel-encode-dev's calls: 64 rows of 10 s (372
               frames a row) from 8 batches cycled past L2, the fused
               launch against KB then KC, and KB alone
  KL shard     one shard of the 30-minute phase decode: uint8 [1, 16875,
               1536, 2], per-channel extrema
  KL offset    the same shard read from one byte on (narrow loads)

each as new, old and every variant, with its byte bound (each input read
once, each output written once, at 3.35 TB/s) and share of it. New and old
(and the exact variants: the tiles, the shared table, the lookup table, the
divided walk, the register cap) are held bit-equal before they are timed
(KB alone is timed only). Prints the card's name and power limit, ptxas's
registers and spills and the occupancy query's blocks an SM of each kernel
at n = 4096, and one line per measurement: device ms per call (CUDA events
over calls queued behind a sleep kernel, chip_smoke.cuda_ms, lower of two
runs). The same numbers go to chiprun_out/profile_mel.json. Imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402
from gomel_tpu_torch.core.config import MelConfig  # noqa: E402
from gomel_tpu_torch.core.filterbank import mel_weights  # noqa: E402
from gomel_tpu_torch.ops import _cuda, mel_ops, rfft_mag  # noqa: E402
from gomel_tpu_torch.ops.stft import hann_window  # noqa: E402
from tools.profile_fft import (_NO_DFT1, _NO_LOAD, _NO_PASSES,  # noqa: E402
                               ptxas_lines)

OLD = os.path.join(HERE, "tools", "mel_dequant_earlier.cu")
SOURCES = ("mel_bands.cuh", "fft_core.cuh", "mel_log.cu", "rfft_mag.cu",
           "dequantize.cu")
UNITS = ("mel_log.cu", "rfft_mag.cu", "dequantize.cu")
SHARD = (1, 16875, 1536, 2)      # one of 4 shards of the 30-minute file
# the cell mel-encode-dev (portbench/traffic/encode-dev-64x10s.json): 64 rows
# of 10 s at 48 kHz a call (480,000 samples, the codec's padded length), and
# 8 batches cycled so that no call reads its signal from L2
CELL_ROWS, CELL_SAMPLES, POOL = 64, 480000, 8

_TILE = "constexpr int kMelTileBytes = 9 * 1024;"
_NO_SUMS = ("rfft_mag.cu",
            "  mel_band_sums<false, 1>(reinterpret_cast<const float*>(sbuf), "
            "2 * m,",
            "  if (false) mel_band_sums<false, 1>("
            "reinterpret_cast<const float*>(sbuf), 2 * m,")
_FUSED_STORE = ("      mag[k] = mag_k[i];\n"
                "      if (2 * k != m) mag[m - k] = mag_mk[i];\n")


def _kc(threads: int = 256, tile_kb: int = 9, rows: int = 1):
    """KC's launch: threads a block, bytes of magnitudes a tile, frames a
    lane sums at once."""
    return ("mel_log.cu",), [
        ("mel_log.cu", "constexpr int kMelLogThreads = 256;",
         f"constexpr int kMelLogThreads = {threads};"),
        ("mel_log.cu", _TILE, f"constexpr int kMelTileBytes = {tile_kb} * 1024;"),
        ("mel_log.cu", "constexpr int kMelRows = 1;",
         f"constexpr int kMelRows = {rows};")]


# name -> (the units it builds, the edits)
VARIANTS = {
    "shipped": (UNITS, []),
    # one term a column and no log: KC's copy and stores
    "kc_copy_only": (("mel_log.cu",), [
        ("mel_bands.cuh", "  for (int t = 0; t < width; ++t) {",
         "  for (int t = 0; t < (width > 0 ? 1 : 0); ++t) {"),
        ("mel_bands.cuh", "    acc[r] = logf(a);", "    acc[r] = a;")]),
    "kc_table_shared": (("mel_log.cu",), [
        ("mel_log.cu", "constexpr bool kTableShared = false;",
         "constexpr bool kTableShared = true;")]),
    "kc_tile_2": _kc(tile_kb=18),
    "kc_tile_4": _kc(tile_kb=36),
    "kc_tile_8": _kc(tile_kb=72),
    "kc_t128": _kc(threads=128),
    "kc_rows_2_tile_2": _kc(tile_kb=18, rows=2),
    "kc_rows_4_tile_4": _kc(tile_kb=36, rows=4),
    "fused_no_sums": (("rfft_mag.cu",), [_NO_SUMS]),
    # the split of the fused launch (PERF.md: its phases' shares of a call):
    # the first pass's loads and shared writes, the split and magnitudes,
    # no DFT, no later pass, no band sums
    "fused_load_only": (("rfft_mag.cu",), [_NO_DFT1, _NO_PASSES, _NO_SUMS]),
    # no signal read (registers from the thread index), every pass, the
    # split and magnitudes, no band sums
    "fused_transform_only": (("rfft_mag.cu",), [_NO_LOAD, _NO_SUMS]),
    # no signal read, DFT or later pass: the first pass writes index values,
    # then the split, the magnitudes, the band sums and their stores
    "fused_sums_only": (("rfft_mag.cu",), [_NO_LOAD, _NO_DFT1, _NO_PASSES]),
    # the magnitudes after the log-mel rows of ``out``
    "fused_store_mags": (("rfft_mag.cu",), [("rfft_mag.cu", _FUSED_STORE,
                                             _FUSED_STORE + (
        "      if (valid) {\n"
        "        float* g = out + total * table.cols + frame * (m + 1);\n"
        "        g[k] = mag_k[i];\n"
        "        if (2 * k != m) g[m - k] = mag_mk[i];\n"
        "      }\n"))]),
    "kl_copy_only": (("dequantize.cu",), [
        ("dequantize.cu",
         "  float x = __fadd_rn(__fmul_rn(__fdiv_rn(v, max_val), rng), mn);\n"
         "  for (int p = 0; p < ihs_passes; ++p) x = sinhf(x);\n"
         "  if (boost != 0.0f) x = __fadd_rn(x, boost);\n"
         "  return x;",
         "  return v;")]),
}
EXACT = ("kc_table_shared", "kc_tile_2", "kc_tile_4", "kc_tile_8", "kc_t128",
         "kc_rows_2_tile_2", "kc_rows_4_tile_4", "fused_store_mags",
         "sums_items_divided", "fused_min_blocks_10")

# the per-frame fused kernel with __launch_bounds__ asking for 10 blocks an
# SM (a register cap: 9 blocks of 128 threads at its 56 registers)
_MIN_BLOCKS = "FwdPlan<kLogM>::frames_per_block)\nstft_mel_log_pow2_kernel("
VARIANTS["fused_min_blocks_10"] = (("rfft_mag.cu",), [(
    "rfft_mag.cu", _MIN_BLOCKS,
    _MIN_BLOCKS.replace("frames_per_block)", "frames_per_block, 10)"))])
# the band sums' items as the walk before this one found them: a division
# an item (what the division costs)
VARIANTS["sums_items_divided"] = (("rfft_mag.cu",), [("mel_bands.cuh", """\
  if (t.groups < 1) return;
  int rb = 0, p = warp;
  while (p >= t.groups) {
    p -= t.groups;
    ++rb;
  }
  for (; rb * kRows < rows; mel_next_item(p, rb, warps, t.groups)) {""", """\
  const int items = (rows + kRows - 1) / kRows * t.groups;
  for (int i = warp; i < items; i += warps) {
    const int rb = i / t.groups;
    const int p = i - rb * t.groups;""")])
# the per-frame sums reading a lane's own bins (wrong values, no bank
# conflict): what the conflicts of the band sums' reads cost
VARIANTS["fused_sums_no_conflict"] = (("rfft_mag.cu",), [(
    "mel_bands.cuh",
    "    for (int r = 0; r < kRows; ++r) "
    "acc[r] = fmaf(m[r * stride + t], wt, acc[r]);",
    "    for (int r = 0; r < kRows; ++r) "
    "acc[r] = fmaf(mags[(threadIdx.x & 31) + t], wt, acc[r]);")])

# appended to each build: the occupancy query of each kernel at n = 4096,
# blocks an SM at its launch's threads and dynamic shared memory
_OCCUPANCY = {
    "rfft_mag.cu": """
GOMEL_API int prof_occupancy_rfft(int* out) {
  const size_t smem = FwdPlan<11>::m * sizeof(float2);
  cudaFuncSetAttribute(stft_mag_pow2_kernel<11>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, 64 * 1024);
  cudaFuncSetAttribute(stft_mel_log_pow2_kernel<11, FloatSignal>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, 64 * 1024);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], stft_mag_pow2_kernel<11>, 128, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], stft_mel_log_pow2_kernel<11, FloatSignal>, 128, smem);
  return gomel_status();
}
""",
    "mel_log.cu": """
GOMEL_API int prof_occupancy_mel_log(int* out, int smem) {
  cudaFuncSetAttribute(mel_log_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], mel_log_kernel,
                                                kMelLogThreads, smem);
  return gomel_status();
}
""",
    "dequantize.cu": """
GOMEL_API int prof_occupancy_dequantize(int* out) {
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], dequantize_raw_kernel<uint8_t, true>, kDequantThreads, 0);
  return gomel_status();
}
""",
}


def build(work: str) -> dict[str, tuple[ctypes.CDLL, str]]:
    """One nvcc per variant, all started together; returns the loaded
    libraries with ptxas's report."""
    texts = {}
    for name in SOURCES:
        with open(os.path.join(_cuda.CSRC_DIR, name)) as f:
            texts[name] = f.read()
    jobs = {}
    for variant, (units, edits) in VARIANTS.items():
        d = os.path.join(work, variant)
        os.makedirs(d, exist_ok=True)
        files = dict(texts)
        for name, old, new in edits:
            if files[name].count(old) != 1:
                raise RuntimeError(f"variant {variant}: {old!r} is not in "
                                   f"{name} exactly once")
            files[name] = files[name].replace(old, new)
        for name, extra in _OCCUPANCY.items():
            files[name] += extra
        for name, text in files.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        units = [os.path.join(d, u) for u in units]
        if variant == "shipped":
            units.append(OLD)
        lib = os.path.join(d, "lib.so")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", d, "-I",
               _cuda.CSRC_DIR, "-o", lib, *units]
        log = open(os.path.join(d, "build.log"), "w")
        jobs[variant] = (subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT), lib, log)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    extra = {
        "prof_old_mel_log": [p, p, p, p, p, ctypes.c_longlong,
                             ctypes.c_longlong, ctypes.c_longlong],
        "prof_old_dequantize_raw": _cuda._SIGNATURES["gomel_dequantize_raw"],
        "prof_wide_dequantize_raw": _cuda._SIGNATURES["gomel_dequantize_raw"],
        "prof_lut_dequantize_raw": _cuda._SIGNATURES["gomel_dequantize_raw"],
        "prof_occupancy_rfft": [p],
        "prof_occupancy_mel_log": [p, i32],
        "prof_occupancy_dequantize": [p],
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
        for symbol in ("gomel_mel_log", "gomel_stft_mel_log", "gomel_stft_mag",
                       "gomel_dequantize_raw"):
            if hasattr(handle, symbol):
                fn = getattr(handle, symbol)
                fn.argtypes = [*_cuda._SIGNATURES[symbol], i32, p]
                fn.restype = i32
        for symbol, args in extra.items():
            if hasattr(handle, symbol):
                fn = getattr(handle, symbol)
                fn.argtypes = ([*args, i32, p] if symbol.startswith("prof_old")
                               or "dequantize_raw" in symbol else args)
                fn.restype = i32
        libs[variant] = (handle, report)
    return libs


def occupancy(lib) -> dict[str, int]:
    """Blocks an SM the occupancy query gives for KB, the fused launch (128
    threads, 16 KB), KC (256 threads, its two stages of a frame at n = 4096)
    and KL (256 threads)."""
    out = (ctypes.c_int * 2)()
    if lib.prof_occupancy_rfft(out) != 0:
        raise RuntimeError("occupancy query failed")
    kb, fused = out[0], out[1]
    stage = (2049 + 8 + 3) // 4 * 4
    if lib.prof_occupancy_mel_log(out, 2 * stage * 4) != 0:
        raise RuntimeError("occupancy query failed")
    kc = out[0]
    if lib.prof_occupancy_dequantize(out) != 0:
        raise RuntimeError("occupancy query failed")
    return {"stft_mag (KB)": kb, "stft_mel_log (fused)": fused,
            "mel_log (KC)": kc, "dequantize_raw (KL)": out[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cases", nargs="*", default=None,
                    help="run only these cases (labels as printed)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_mel: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = build(os.path.join(_cuda.BUILD_DIR, "profile_mel"))
    keys = ("mel_log", "stft_mag_pow2_kernelILi11E",
            "stft_mel_log_pow2_kernelILi11E", "dequantize_raw")
    ptxas = {v: [line for line in ptxas_lines(report)
                 if any(k in line for k in keys)]
             for v, (_, report) in libs.items()}
    for variant, lines in ptxas.items():
        for line in lines:
            print(f"  ptxas, {variant}: {line}")
    shipped = libs["shipped"][0]
    occ = occupancy(shipped)
    print(f"  occupancy query, blocks an SM: {occ}", flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = []

    def record(**row):
        results.append(row)
        print("  " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                               else f"{k} {v}" for k, v in row.items()),
              flush=True)

    def timed(fn):
        if fn() != 0:
            raise RuntimeError("launch failed")
        return min(chip_smoke.cuda_ms(fn, args.iters) for _ in range(2))

    # the bench signal and its magnitudes, at the CLI widths
    cfg = MelConfig.cli_default()
    n, hop = cfg.resolut, cfg.window
    rng = np.random.default_rng(chip_smoke.SEED)
    length = int(chip_smoke.SAMPLE_RATE * chip_smoke.SECONDS)
    padded = length + (-length) % hop + n
    pcm = chip_smoke.seeded_pcm(rng, chip_smoke.BATCH, padded)
    x = torch.from_numpy(pcm.astype(np.float32) / 32768.0).to(dev)

    def kc_case(n_fft, kc_hop, fused):
        """The shipped and earlier KC (or the fused launch and KB + KC) at
        n_fft on the bench signal; returns make(lib, kind), the outputs by
        (lib, kind), the bound."""
        win = torch.tensor(hann_window(n_fft), dtype=torch.float32,
                           device=dev)
        fwd = torch.tensor(mel_weights(n_fft // 2, cfg.num_mels,
                                       cfg.mel_fmin, cfg.mel_fmax),
                           dtype=torch.float32, device=dev)
        mags = rfft_mag.stft_mag(x, win, n_fft, kc_hop)
        rows, bins = mags.numel() // mags.shape[-1], mags.shape[-1]
        cols = 2 * cfg.num_mels
        slots, weights, groups = mel_ops._mel_band_table(fwd)
        we, lo, hi = mel_ops._extended_weights(fwd)
        frames = mags.shape[1]
        tw = rfft_mag._twiddles(n_fft, dev).data_ptr()
        tw_pass, *plan = rfft_mag._fft_args(n_fft, dev)
        outs = {}

        def make(lib, kind):
            # room for fused_store_mags' magnitudes after the log-mel rows
            out = torch.empty(rows * (cols + bins), device=dev)
            out_m = torch.empty_like(mags)
            outs[(id(lib), kind)] = out[:rows * cols]
            if kind == "new" and not fused:
                return lambda: lib.gomel_mel_log(
                    mags.data_ptr(), slots.data_ptr(), weights.data_ptr(),
                    groups, weights.numel(), out.data_ptr(), rows, bins,
                    cols, dev.index, stream)
            if kind == "old" and not fused:
                return lambda: lib.prof_old_mel_log(
                    mags.data_ptr(), we.data_ptr(), lo.data_ptr(),
                    hi.data_ptr(), out.data_ptr(), rows, bins, cols,
                    dev.index, stream)
            if kind == "new":
                return lambda: lib.gomel_stft_mel_log(
                    x.data_ptr(), win.data_ptr(), tw, tw_pass,
                    slots.data_ptr(), weights.data_ptr(), groups,
                    out.data_ptr(), cols, chip_smoke.BATCH, frames,
                    x.shape[1], kc_hop, n_fft, *plan, dev.index, stream)

            def kb():
                return lib.gomel_stft_mag(
                    x.data_ptr(), win.data_ptr(), tw, tw_pass,
                    out_m.data_ptr(), chip_smoke.BATCH, frames, x.shape[1],
                    kc_hop, n_fft, *plan, dev.index, stream)

            def two():  # KB then KC ("old"), or then the earlier KC
                if kind == "two_earlier":
                    return kb() or lib.prof_old_mel_log(
                        out_m.data_ptr(), we.data_ptr(), lo.data_ptr(),
                        hi.data_ptr(), out.data_ptr(), rows, bins, cols,
                        dev.index, stream)
                return kb() or lib.gomel_mel_log(
                    out_m.data_ptr(), slots.data_ptr(), weights.data_ptr(),
                    groups, weights.numel(), out.data_ptr(), rows, bins,
                    cols, dev.index, stream)
            return kb if kind == "kb" else two
        table = chip_smoke.nbytes(slots, weights)
        logmel = 4.0 * rows * cols
        if fused:
            b_ms = chip_smoke.bound(chip_smoke.nbytes(x, win) + table
                                    + logmel, 0.0)[0]
        else:
            b_ms = chip_smoke.bound(chip_smoke.nbytes(mags) + table + logmel,
                                    0.0)[0]
        return make, outs, b_ms

    def kl_case(offset):
        """The shipped and earlier KL on one shard's uint8 planes, read from
        ``offset`` bytes on."""
        g = torch.Generator(device=dev).manual_seed(1)
        count = int(np.prod(SHARD))
        flat = torch.randint(0, 256, (count + offset,), generator=g,
                             device=dev, dtype=torch.uint8)
        img = flat[offset:]
        maxs = torch.tensor([3.25, 2.5], device=dev)
        mins = torch.tensor([-3.0, -1.5], device=dev)
        outs = {}

        def make(lib, kind):
            out = torch.empty(count, device=dev)
            outs[(id(lib), kind)] = out
            symbol = {"new": "gomel_dequantize_raw",
                      "old": "prof_old_dequantize_raw",
                      "wide": "prof_wide_dequantize_raw",
                      "lut": "prof_lut_dequantize_raw"}[kind]
            fn = getattr(lib, symbol)
            return lambda: fn(img.data_ptr(), maxs.data_ptr(),
                              mins.data_ptr(), out.data_ptr(), count, 1, 2,
                              255.0, 0, 0.0, dev.index, stream)
        b_ms = chip_smoke.bound(count * 5.0 + 16.0, 0.0)[0]
        return make, outs, b_ms

    def cell_case():
        """The fused launch at the cell mel-encode-dev's shape: 64 rows of
        10 s at 48 kHz (372 frames a row), from a pool of POOL batches
        (983 MB, past the card's 50 MB L2) cycled call by call; the forms as
        kc_case's fused ones."""
        rows, length = CELL_ROWS, CELL_SAMPLES
        g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
        t = torch.arange(length, device=dev, dtype=torch.float32) / 48000.0
        pool = []
        for _ in range(POOL):
            f = 80.0 + 3920.0 * torch.rand(rows, 1, generator=g, device=dev)
            pool.append((0.1 * torch.sin(2 * math.pi * f * t)
                         + 0.01 * torch.randn(rows, length, generator=g,
                                              device=dev)).contiguous())
        win = torch.tensor(hann_window(n), dtype=torch.float32, device=dev)
        fwd = torch.tensor(mel_weights(n // 2, cfg.num_mels, cfg.mel_fmin,
                                       cfg.mel_fmax),
                           dtype=torch.float32, device=dev)
        frames = (length - n) // hop + 1
        bins, cols, f_all = n // 2 + 1, 2 * cfg.num_mels, rows * frames
        slots, weights, groups = mel_ops._mel_band_table(fwd)
        tw = rfft_mag._twiddles(n, dev).data_ptr()
        tw_pass, *plan = rfft_mag._fft_args(n, dev)
        mags = torch.empty(f_all * bins, device=dev)
        outs = {}

        def make(lib, kind):
            out = torch.empty(f_all * (cols + bins), device=dev)
            outs[(id(lib), kind)] = out[:f_all * cols]
            calls = [0]

            def signal():
                x = pool[calls[0] % POOL]
                calls[0] += 1
                return x.data_ptr()

            def kb(xp):
                return lib.gomel_stft_mag(
                    xp, win.data_ptr(), tw, tw_pass, mags.data_ptr(), rows,
                    frames, length, hop, n, *plan, dev.index, stream)

            if kind == "new":
                return lambda: lib.gomel_stft_mel_log(
                    signal(), win.data_ptr(), tw, tw_pass, slots.data_ptr(),
                    weights.data_ptr(), groups, out.data_ptr(), cols, rows,
                    frames, length, hop, n, *plan, dev.index, stream)
            if kind == "kb":
                return lambda: kb(signal())
            return lambda: kb(signal()) or lib.gomel_mel_log(
                mags.data_ptr(), slots.data_ptr(), weights.data_ptr(),
                groups, weights.numel(), out.data_ptr(), f_all, bins, cols,
                dev.index, stream)
        b_ms = chip_smoke.bound(4.0 * rows * length
                                + chip_smoke.nbytes(win, slots, weights)
                                + 4.0 * f_all * cols, 0.0)[0]
        return make, outs, b_ms

    # label -> (setup, variant builds, other forms held bit-equal, other
    # forms timed only)
    kc_variants = tuple(v for v in VARIANTS if v.startswith("kc_"))
    cases = {
        "KC bench": (lambda: kc_case(n, hop, False), kc_variants, (), ()),
        "KC n = 3000": (lambda: kc_case(3000, 750, False), (), (), ()),
        "fused bench": (lambda: kc_case(n, hop, True),
                        ("fused_no_sums", "fused_store_mags"),
                        ("two_earlier",), ("kb",)),
        "fused cell": (cell_case, ("fused_no_sums", "fused_load_only",
                                   "fused_transform_only", "fused_sums_only",
                                   "sums_items_divided",
                                   "fused_sums_no_conflict",
                                   "fused_min_blocks_10"),
                       (), ("kb",)),
        "KL shard": (lambda: kl_case(0), ("kl_copy_only",), ("wide", "lut"),
                     ()),
        "KL offset": (lambda: kl_case(1), (), ("wide",), ()),
    }
    for label, (setup, variants, kinds, timed_only) in cases.items():
        if args.cases and label not in args.cases:
            continue
        make, outs, b_ms = setup()
        new_fn, old_fn = make(shipped, "new"), make(shipped, "old")
        fns = {v: make(libs[v][0], "new") for v in variants}
        fns.update({k: make(shipped, k) for k in kinds + timed_only})
        for fn in (new_fn, old_fn, *fns.values()):
            if fn() != 0:
                raise RuntimeError(f"{label}: launch failed")
        torch.cuda.synchronize()
        ref = outs[(id(shipped), "old")]
        exact = [(id(shipped), "new")] + [
            (id(libs[v][0]), "new") for v in variants if v in EXACT] + [
            (id(shipped), k) for k in kinds]
        same = all(torch.equal(outs[key], ref) for key in exact)
        if not same:
            raise AssertionError(f"{label}: the forms' outputs differ")
        new_ms, old_ms = chip_smoke.race(new_fn, old_fn, label, args.iters)
        record(case=label, new_ms=new_ms, old_ms=old_ms,
               speedup=old_ms / new_ms, bound_ms=b_ms,
               bound_share=b_ms / new_ms, bit_equal=same,
               new_enqueue_us=chip_smoke.host_us(new_fn),
               old_enqueue_us=chip_smoke.host_us(old_fn))
        for variant, fn in fns.items():
            ms = timed(fn)
            record(case=label, variant=variant, ms=ms,
                   share_of_new=ms / new_ms, share_of_old=ms / old_ms,
                   bound_share=b_ms / ms)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile_mel.json"), "w") as f:
        json.dump({"card": card, "ptxas": ptxas, "occupancy": occ,
                   "results": results}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
