"""KD (the mel PNG quantizer), KF (the phase PNG quantizer) and KI (the mel
decode front end) against the forms they replaced, and where their time
goes, by ablation.

    python3 tools/profile_quant.py [--iters 20]

Needs one NVIDIA GPU and nvcc. Builds gomel_tpu_torch/csrc/quantize.cu (KD
and KF, one two-pass design) and mel_decode.cu (KI) as shipped,
tools/quant_earlier.cu (the earlier KD, KF and KI, as they shipped before
their redesign), and once more for each ablation, with that ablation's
edits of the sources (VARIANTS; the quantize.cu ones act on KD and KF
alike):

  pass1_only        the entry points return after pass 1 (the grid sized to
                    the card, the quads, the fold once a row)
  pass2_only        without pass 1: pass 2 alone, on the true extrema
  parts_64          pass 1 held to 64 blocks a row, the earlier grid
  tile_64           pass 2 in 64-frame tiles (two 4-frame groups a warp),
                    KF's tile before this revision, not 32
  copy_only         pass 2 stores each value's top byte in place of its
                    quantized pixel: no asinh, division or clip (the bytes'
                    achievable time)
  ki_run_1/2/8      KI's runs of 1, 2 or 8 frames (shipped: 4)
  ki_vec_stores     KI storing each row's 16-byte aligned chunks as float4
                    through a staging row a warp (a head of up to 3 floats
                    first), not a float a lane (a warp's 128 contiguous
                    bytes at any alignment); four edits
  ki_table_l1       KI reading each output's table entry from global memory
                    through L1, as the earlier form did, not from the
                    block's shared-memory copy (no table staged, the taps'
                    planes never picked); eight edits
  ki_no_register_cap KI without its 64-register cap (78 registers for the
                    uint8 source, 3 blocks an SM, not 4)
  ki_copy_only      KI writes zeros: its table staging, prologue and stores
                    only
  ki_no_prologue    KI without the runs' prologue (the exps' buffers keep
                    what they held): the table staging, sums and stores

Then, on one card and in turns (old, new, new, old; chip_smoke.race):

  KF bench       the bench signal's phase spectrogram [2, 1122, 1536, 2],
                 uint8, IHS 0
  KF masked      [4, 1122, 1536, 2] (the bench rows twice), frames [1122,
                 843, 562, 0]
  KF HDR         the bench spectrogram, uint16
  KF IHS 2       the bench spectrogram, uint8, 2 asinh passes
  KF long form   one gathered 30-minute spectrogram [67500, 1536, 2]
  KD bench       the bench signal's log-mel [2, 1122, 192, 2]
  KD masked      [4, 1122, 192, 2] (the bench rows twice), frames [1122,
                 843, 562, 0]
  KD long form   a 30-minute log-mel [67500, 192, 2]
  KI uint8       the bench signal's uint8 planes [2, 192, 1122, 2] (KD's)
  KI float       its log-mel [2, 1122, 192, 2]
  KI long-form shard  one shard of the 30-minute mel decode over 4 frame
                 shards: log-mel [1, 16875, 192, 2] (the bench log-mel's
                 frames repeated), the CLI's tune

each as new, old and every variant of its kernel, with its byte bound (each
input read once, each output written once, at 3.35 TB/s) and share of it.
New and old (and the exact variants: parts_64, tile_64, KI's runs, its L1
table, its 16-byte stores and its register cap) are held
bit-equal before they are timed. Each case
also times torch's zero_ of the new form's output (the achievable rate of
the output's bytes), and each KD case torch.aminmax over the rows (the
extrema alone: pass 1's yardstick, not the same function). At the bench
shape KF is also timed behind a 256 MB write that evicts its input from L2
(pass 2 alone too): the write's own time is taken off. Prints the card's
name and power limit, ptxas's registers and spills, the occupancy query's
blocks an SM of each kernel, and one line per measurement: device ms per
call (CUDA events over calls queued behind a sleep kernel,
chip_smoke.cuda_ms, lower of two runs). The same numbers go to
chiprun_out/profile_quant.json. Imports nothing of JAX.

``start_earlier``, ``earlier`` and ``old_mel_to_magnitudes`` also serve
chip_smoke.py and tests/test_torch_cuda.py, which hold the new KI bit-equal
to the earlier form.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from gomel_tpu_torch.ops import _cuda, mel_ops  # noqa: E402

OLD = os.path.join(HERE, "tools", "quant_earlier.cu")
SOURCES = ("quantize.cu", "mel_decode.cu")
LONG_FRAMES = 67500               # the 30-minute file's frames, padded
OLD_PARTS = 64                    # the earlier forms' pass-1 blocks a row

_PASS1_RETURN = ("  if (err != 0) return err;\n"
                 "  const bool vec = aligned16(src) && bins % 2 == 0;")


def _ki_run(t: int):
    return [("mel_decode.cu", "constexpr int kMelRun = 4;",
             f"constexpr int kMelRun = {t};")]


# KI storing each row's 16-byte aligned chunks as float4 through a staging
# row a warp: a head of up to 3 floats first, then lane l stores outputs
# 4l .. 4l + 3 of each chunk
_KI_VEC_STORES = [
    ("mel_decode.cu",
     "  return (2 * static_cast<size_t>(kMelRun)",
     "  return (kMagThreads / 32 * kMagChunk +\n"
     "          2 * static_cast<size_t>(kMelRun)"),
    ("mel_decode.cu",
     "  float* e2 = reinterpret_cast<float*>(smem4);\n",
     "  float* stage = reinterpret_cast<float*>(smem4);\n"
     "  float* e2 = stage + (kMagThreads / 32) * kMagChunk;\n"),
    ("mel_decode.cu",
     "    for (int j0 = part * kMagChunk; j0 <= bins; j0 += kParts * "
     "kMagChunk) {\n",
     "    float* st = stage + warp * kMagChunk;\n"
     "    int h = static_cast<int>((4 - (row * (bins + 1)) % 4) % 4);\n"
     "    if (h > bins + 1) h = bins + 1;\n"
     "    if (part == 0 && lane < h) {\n"
     "      o[lane] = mag_value<kTaps>(lane, er, hdr, wt, taps, bins,\n"
     "                                 max_taps, tune, tune_mul, tune_add);\n"
     "    }\n"
     "    for (int j0 = h + part * kMagChunk; j0 <= bins;\n"
     "         j0 += kParts * kMagChunk) {\n"),
    ("mel_decode.cu",
     "#pragma unroll\n"
     "      for (int u = 0; u < kMagChunk / 32; ++u) {\n"
     "        const int j = j0 + lane + 32 * u;\n"
     "        if (j <= bins) o[j] = v[u];\n"
     "      }\n",
     "#pragma unroll\n"
     "      for (int u = 0; u < kMagChunk / 32; ++u) st[lane + 32 * u] = "
     "v[u];\n"
     "      __syncwarp();\n"
     "      const int j = j0 + 4 * lane;\n"
     "      if (j + 3 <= bins) {\n"
     "        *reinterpret_cast<float4*>(o + j) =\n"
     "            *reinterpret_cast<const float4*>(st + 4 * lane);\n"
     "      } else {\n"
     "        for (int q = 0; q < 4 && j + q <= bins; ++q) {\n"
     "          o[j + q] = st[4 * lane + q];\n"
     "        }\n"
     "      }\n"
     "      __syncwarp();\n"),
]

# KI reading each output's table entry (first mel, count, taps) from global
# memory through L1, as the earlier form did: no table in shared memory
_KI_TABLE_L1 = [
    ("mel_decode.cu",
     "    const float* __restrict__ wt, const float* __restrict__ taps,",
     "    const float* __restrict__ wt, const int* __restrict__ first,\n"
     "    const int* __restrict__ count, const float* __restrict__ taps,"),
    ("mel_decode.cu",
     "  const unsigned h = hdr[k];\n"
     "  const int at = static_cast<int>(h & 0xffffu) + j - k;",
     "  const int at = 2 * first[k] + j - k;"),
    ("mel_decode.cu",
     "  const int cnt = static_cast<int>(h >> 16);",
     "  const int cnt = count[k];"),
    ("mel_decode.cu",
     "mag_value<kTaps>(j, er, hdr, wt, taps, bins,",
     "mag_value<kTaps>(j, er, hdr, wt, first, count, taps, bins,"),
    ("mel_decode.cu",
     "  for (int k0 = tid; k0 < bins; k0 += kMagBatch * threads) {",
     "  for (int k0 = tid; false; k0 += kMagBatch * threads) {"),
    ("mel_decode.cu", "(2 * mels + 2) + bins) *", "(2 * mels + 2)) *"),
    ("mel_decode.cu",
     "  if (max_taps <= 2 && base + 2 * plane <= kMagSmemMax) {",
     "  if (false) {"),
    ("mel_decode.cu",
     "  if (max_taps <= 4 && base + 4 * plane <= kMagSmemMax) {",
     "  if (false) {"),
]


# name -> the edits (file, old text, new text)
VARIANTS = {
    "shipped": [],
    "pass1_only": [("quantize.cu", _PASS1_RETURN,
                    _PASS1_RETURN.replace("if (err != 0)", "if (true)"))],
    "pass2_only": [("quantize.cu", "  planes_minmax_kernel<kGlobal><<<dim3(",
                    "  if (false) planes_minmax_kernel<kGlobal><<<dim3(")],
    "parts_64": [("quantize.cu",
                  "  long long parts = (resident + batch - 1) / batch;",
                  "  long long parts = 64;")],
    "tile_64": [("quantize.cu", "constexpr int kTileF = 32;",
                 "constexpr int kTileF = 64;")],
    "copy_only": [("quantize.cu",
                      "  return quantize_one(ihs_forward(v0, ihs_passes), mn0, "
                      "rng0, max_val) |\n"
                      "         (quantize_one(ihs_forward(v1, ihs_passes), "
                      "mn1, rng1, max_val)\n"
                      "          << kShift);",
                      "  return (__float_as_uint(v0) >> 24) |\n"
                      "         ((__float_as_uint(v1) >> 24) << kShift);")],
    "ki_run_1": _ki_run(1),
    "ki_run_2": _ki_run(2),
    "ki_run_8": _ki_run(8),
    "ki_vec_stores": _KI_VEC_STORES,
    "ki_table_l1": _KI_TABLE_L1,
    "ki_no_register_cap": [("mel_decode.cu",
                            "__launch_bounds__(kMagThreads, 4)",
                            "__launch_bounds__(kMagThreads)")],
    "ki_copy_only": [("mel_decode.cu", "  return fabsf(acc);",
                      "  return 0.0f;")],
    "ki_no_prologue": [("mel_decode.cu", "    run_prologue<kMode>(src,",
                        "    if (false) run_prologue<kMode>(src,")],
}
EXACT = ("parts_64", "tile_64", "ki_run_1",
         "ki_run_2", "ki_run_8", "ki_vec_stores", "ki_table_l1",
         "ki_no_register_cap")

# appended to each build: blocks an SM of each kernel at its launch's
# threads and shared memory, and the SM count
_OCCUPANCY = {
    "quantize.cu": """
GOMEL_API int prof_occupancy_quant(int* out) {
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], planes_minmax_kernel<false>, kPlanesThreads, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], planes_quantize_kernel<2, true, false>, kPlanesThreads, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], planes_quantize_kernel<4, true, false>, kPlanesThreads, 0);
  cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], planes_minmax_kernel<true>, kPlanesThreads, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[5], planes_quantize_kernel<2, true, true>, kPlanesThreads, 0);
  return gomel_status();
}
""",
    "mel_decode.cu": """
GOMEL_API int prof_occupancy_mag(int* out, int mels) {
  const int smem = static_cast<int>(mag_base_smem(mels, 2048) +
                                    2 * 2048 * sizeof(float));
  auto k = mel_to_mag_kernel<kQuant8, 2>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], k, kMagThreads,
                                                smem);
  return gomel_status();
}
""",
}

_OLD_SIGNATURES = {
    "prof_old_quantize_planes": [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3
    + [ctypes.c_int, ctypes.c_float, ctypes.c_int],
    "prof_old_quantize_mel": [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3
    + [ctypes.c_int, ctypes.c_float],
    "prof_old_mel_to_mag": _cuda._SIGNATURES["gomel_mel_to_mag"],
}


def _bind(handle: ctypes.CDLL, symbol: str, args: list) -> None:
    fn = getattr(handle, symbol)
    fn.argtypes = [*args, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def start_earlier(work: str) -> tuple[subprocess.Popen, str, str]:
    """Start nvcc on tools/quant_earlier.cu (the earlier KD, KF and KI) into
    ``work``; returns (process, library path, log path) for
    :func:`earlier`."""
    os.makedirs(work, exist_ok=True)
    lib = os.path.join(work, "quant_earlier.so")
    log = os.path.join(work, "quant_earlier.log")
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", _cuda.CSRC_DIR,
           "-o", lib, OLD]
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
    return proc, lib, log


def earlier(job) -> ctypes.CDLL:
    """Wait for :func:`start_earlier`'s build and load it."""
    proc, lib, log = job
    proc.wait()
    if proc.returncode != 0:
        with open(log) as f:
            raise RuntimeError(f"nvcc failed for {OLD}:\n{f.read()}")
    handle = ctypes.CDLL(lib)
    for symbol, args in _OLD_SIGNATURES.items():
        _bind(handle, symbol, args)
    return handle


def old_mel_to_magnitudes(lib, src: torch.Tensor, inv_weights: torch.Tensor,
                          tune_mul: float = 1.0, tune_add: float = 0.0,
                          boost: float = 0.0, mgc_max=None, mgc_min=None,
                          max_val: int = 255) -> torch.Tensor:
    """The earlier KI on the card, with mel_ops.mel_to_magnitudes's
    arguments (a contiguous CUDA ``src``)."""
    quantized = src.dtype == torch.uint8
    dev = src.device
    if quantized:
        *lead, mels, frames, _ = src.shape
        f32 = torch.float32
        mx = torch.as_tensor(mgc_max, dtype=f32, device=dev).reshape(-1)
        mn = torch.as_tensor(mgc_min, dtype=f32, device=dev).reshape(-1)
        mx, mn = mx.contiguous(), mn.contiguous()
    else:
        *lead, frames, mels, _ = src.shape
        mx = mn = None
    first, count, taps = mel_ops._band_table(inv_weights)
    bins = inv_weights.shape[0]
    out = torch.empty(tuple(lead) + (frames, bins + 1), dtype=torch.float32,
                      device=dev)
    batch = int(np.prod(lead, dtype=np.int64))
    rc = lib.prof_old_mel_to_mag(
        int(quantized), src.data_ptr(), None if mx is None else mx.data_ptr(),
        None if mn is None else mn.data_ptr(), first.data_ptr(),
        count.data_ptr(), taps.data_ptr(), out.data_ptr(), batch, frames,
        mels, bins, taps.shape[1], float(max_val), float(boost),
        float(tune_mul), float(tune_add), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"prof_old_mel_to_mag failed ({rc})")
    return out


def build(work: str) -> dict[str, tuple[ctypes.CDLL, str]]:
    """One nvcc per variant, all started together (and the earlier forms');
    returns the loaded libraries with ptxas's report."""
    texts = {}
    for name in SOURCES:
        with open(os.path.join(_cuda.CSRC_DIR, name)) as f:
            texts[name] = f.read()
    jobs = {}
    for variant, edits in VARIANTS.items():
        d = os.path.join(work, variant)
        os.makedirs(d, exist_ok=True)
        files = dict(texts)
        for name, old, new in edits:
            if files[name].count(old) != 1:
                raise RuntimeError(f"variant {variant}: {old!r} is not in "
                                   f"{name} exactly once")
            files[name] = files[name].replace(old, new)
        units = []
        for name, text in files.items():
            units.append(os.path.join(d, name))
            with open(units[-1], "w") as f:
                f.write(text + _OCCUPANCY[name])
        lib = os.path.join(d, "lib.so")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I",
               _cuda.CSRC_DIR, "-o", lib, *units]
        log = open(os.path.join(d, "build.log"), "w")
        jobs[variant] = (subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT), lib, log)
    old_job = start_earlier(os.path.join(work, "earlier"))
    libs = {}
    for variant, (proc, lib, log) in jobs.items():
        proc.wait()
        log.close()
        with open(log.name) as f:
            report = f.read()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{report}")
        handle = ctypes.CDLL(lib)
        for symbol in ("gomel_quantize_planes", "gomel_quantize_planes_parts",
                       "gomel_quantize_mel", "gomel_quantize_mel_parts",
                       "gomel_mel_to_mag"):
            _bind(handle, symbol, _cuda._SIGNATURES[symbol])
        handle.prof_occupancy_quant.argtypes = [ctypes.c_void_p]
        handle.prof_occupancy_mag.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[variant] = (handle, report)
    old = earlier(old_job)
    with open(old_job[2]) as f:
        libs["earlier"] = (old, f.read())
    return libs


def occupancy(lib, mels: int) -> dict[str, int]:
    """Blocks an SM the occupancy query gives for KF's and KD's two passes
    (256 threads) and KI (256 threads, its run's shared memory at
    ``mels``), and the card's SMs."""
    out = (ctypes.c_int * 6)()
    if lib.prof_occupancy_quant(out) != 0:
        raise RuntimeError("occupancy query failed")
    got = {"KF pass 1": out[0], "KF pass 2 uint8": out[1],
           "KF pass 2 uint16": out[2], "SMs": out[3], "KD pass 1": out[4],
           "KD pass 2": out[5]}
    if lib.prof_occupancy_mag(out, mels) != 0:
        raise RuntimeError("occupancy query failed")
    got["KI"] = out[0]
    return got


def main(argv=None) -> int:
    import chip_smoke
    from gomel_tpu_torch.core.config import MelConfig, PhaseConfig
    from gomel_tpu_torch.core.filterbank import inverse_mel_weights, mel_weights
    from gomel_tpu_torch.ops import phase_ops, quantize, rfft_mag
    from gomel_tpu_torch.ops.stft import hann_window
    from tools.profile_fft import ptxas_lines

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_quant: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = build(os.path.join(_cuda.BUILD_DIR, "profile_quant"))
    keys = ("planes_", "mel_to_mag", "quantize_planes_kernel",
            "minmax_planes_partial", "minmax_partial", "quantize_mel_kernel",
            "threefry")
    ptxas = {v: [line for line in ptxas_lines(report)
                 if any(k in line for k in keys)]
             for v, (_, report) in libs.items()}
    for variant in ("shipped", "earlier"):
        for line in ptxas[variant]:
            print(f"  ptxas, {variant}: {line}")
    shipped, old = libs["shipped"][0], libs["earlier"][0]
    cfg, pcfg = MelConfig.cli_default(), PhaseConfig.cli_default()
    occ = occupancy(shipped, cfg.num_mels)
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

    # the bench signal, its phase spectrogram, log-mel and uint8 planes
    n, hop = cfg.resolut, cfg.window
    rng = np.random.default_rng(chip_smoke.SEED)
    length = int(chip_smoke.SAMPLE_RATE * chip_smoke.SECONDS)
    padded = length + (-length) % hop + n
    pcm = chip_smoke.seeded_pcm(rng, chip_smoke.BATCH, padded)
    x = torch.from_numpy(pcm.astype(np.float32) / 32768.0).to(dev)
    win = torch.tensor(hann_window(n), dtype=torch.float32, device=dev)
    spec = phase_ops.phase_encode_batch(x, pcfg.num_freqs, n, hop, win)
    fwd = torch.tensor(mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin,
                                   cfg.mel_fmax), dtype=torch.float32,
                       device=dev)
    inv = torch.tensor(inverse_mel_weights(cfg.n_bins, cfg.num_mels,
                                           cfg.mel_fmin, cfg.mel_fmax),
                       dtype=torch.float32, device=dev)
    logmel = mel_ops.mel_from_mags_plain(rfft_mag.stft_mag(x, win, n, hop),
                                         fwd)
    img, mgc_mx, mgc_mn = quantize.quantize_mel_plane_batch(logmel)
    first, count, taps = mel_ops._band_table(inv)
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    tickets = torch.zeros(64, dtype=torch.int32, device=dev)

    def kf_case(src, max_val, ihs, frames=None):
        """new / old / variant launchers of KF on ``src`` [B, F, nf, 2]."""
        batch, n_frames, bins = src.shape[0], src.shape[1], src.shape[2]
        dtype = torch.uint16 if max_val > 255 else torch.uint8
        tf = (None if frames is None else
              torch.tensor(frames, dtype=torch.int32, device=dev))
        # the true extrema in every output's extrema, so a build without
        # pass 1 (pass2_only) quantizes with them, as the real call does
        true_ext = torch.stack(quantize.quantize_planes_plain(
            src, max_val, ihs, tf)[1:])
        outs = {}

        def make(lib, kind):
            img2 = torch.empty((batch, bins, n_frames, 2), dtype=dtype,
                               device=dev)
            ext = true_ext.clone()
            outs[(id(lib), kind)] = (img2, ext)
            fr = None if tf is None else tf.data_ptr()
            if kind == "old":
                part = torch.empty((batch, OLD_PARTS, 4), device=dev)
                return lambda: lib.prof_old_quantize_planes(
                    src.data_ptr(), fr, part.data_ptr(), img2.data_ptr(),
                    ext[0].data_ptr(), ext[1].data_ptr(), batch, n_frames,
                    bins, OLD_PARTS, float(max_val), ihs, dev.index, stream)
            n = ctypes.c_longlong()
            if lib.gomel_quantize_planes_parts(batch, n_frames, bins,
                                               ctypes.addressof(n), dev.index,
                                               stream) != 0:
                raise RuntimeError("gomel_quantize_planes_parts failed")
            parts = n.value
            part = torch.empty((batch, parts, 4), device=dev)
            return lambda: lib.gomel_quantize_planes(
                src.data_ptr(), fr, part.data_ptr(), tickets.data_ptr(),
                img2.data_ptr(), ext[0].data_ptr(), ext[1].data_ptr(), batch,
                n_frames, bins, parts, float(max_val), ihs, dev.index,
                stream)
        counted = src.numel() if frames is None else sum(
            min(max(f, 0), n_frames) for f in frames) * bins * 2
        # bound: the input once (pass 2 quantizes every frame), the planes
        # once, the extrema; the floor of two passes reads pass 1's counted
        # frames once more
        out_b = src.numel() * dtype.itemsize
        b_ms = chip_smoke.bound(4.0 * src.numel() + out_b + 16.0 * batch,
                                0.0)[0]
        floor_ms = chip_smoke.bound(4.0 * (counted + src.numel()) + out_b,
                                    0.0)[0]
        return make, outs, b_ms, floor_ms

    def kd_case(src, frames=None):
        """new / old / variant launchers of KD on ``src`` [B, F, M, 2]."""
        batch, n_frames, mels = src.shape[0], src.shape[1], src.shape[2]
        tf = (None if frames is None else
              torch.tensor(frames, dtype=torch.int32, device=dev))
        true_ext = torch.stack(quantize.quantize_mel_plane_plain(
            src, 255, tf)[1:])
        outs = {}

        def make(lib, kind):
            img2 = torch.empty((batch, mels, n_frames, 2), dtype=torch.uint8,
                               device=dev)
            ext = true_ext.clone()
            outs[(id(lib), kind)] = (img2, ext)
            fr = None if tf is None else tf.data_ptr()
            if kind == "old":
                part = torch.empty((batch, OLD_PARTS, 2), device=dev)
                return lambda: lib.prof_old_quantize_mel(
                    src.data_ptr(), fr, part.data_ptr(), img2.data_ptr(),
                    ext[0].data_ptr(), ext[1].data_ptr(), batch, n_frames,
                    mels, OLD_PARTS, 255.0, dev.index, stream)
            n = ctypes.c_longlong()
            if lib.gomel_quantize_mel_parts(batch, n_frames, mels,
                                            ctypes.addressof(n), dev.index,
                                            stream) != 0:
                raise RuntimeError("gomel_quantize_mel_parts failed")
            part = torch.empty((batch, n.value, 4), device=dev)
            return lambda: lib.gomel_quantize_mel(
                src.data_ptr(), fr, part.data_ptr(), tickets.data_ptr(),
                img2.data_ptr(), ext[0].data_ptr(), ext[1].data_ptr(), batch,
                n_frames, mels, n.value, 255.0, dev.index, stream)
        counted = src.numel() if frames is None else sum(
            min(max(f, 0), n_frames) for f in frames) * mels * 2
        b_ms = chip_smoke.bound(5.0 * src.numel() + 8.0 * batch, 0.0)[0]
        floor_ms = chip_smoke.bound(4.0 * (counted + src.numel())
                                    + src.numel(), 0.0)[0]
        return make, outs, b_ms, floor_ms

    def ki_case(quantized, src=None, tune=(1.0, 0.0)):
        """new / old / variant launchers of KI on ``src`` (the bench's
        planes or log-mel by default)."""
        outs = {}
        if src is None:
            src = img if quantized else logmel
        batch = src.shape[0]
        frames = src.shape[2] if quantized else src.shape[1]
        bins = inv.shape[0]

        def make(lib, kind):
            out = torch.empty((batch, frames, bins + 1), device=dev)
            outs[(id(lib), kind)] = (out,)
            fn = (lib.prof_old_mel_to_mag if kind == "old"
                  else lib.gomel_mel_to_mag)
            return lambda: fn(
                int(quantized), src.data_ptr(),
                mgc_mx.data_ptr() if quantized else None,
                mgc_mn.data_ptr() if quantized else None, first.data_ptr(),
                count.data_ptr(), taps.data_ptr(), out.data_ptr(), batch,
                frames, cfg.num_mels, bins, taps.shape[1], 255.0, 0.0,
                tune[0], tune[1], dev.index, stream)
        b_ms = chip_smoke.bound(
            chip_smoke.nbytes(src, first, count, taps)
            + 4.0 * batch * frames * (bins + 1), 0.0)[0]
        return make, outs, b_ms, None

    spec4 = torch.cat([spec, spec])
    long_spec = (torch.randn((1, LONG_FRAMES, pcfg.num_freqs, 2),
                             generator=g, device=dev) * 40.0)
    # one shard of the 30-minute mel decode over 4 frame shards: the bench
    # log-mel's frames repeated to LONG_FRAMES / 4
    shard = LONG_FRAMES // 4
    reps = -(-shard // (logmel.shape[0] * logmel.shape[1]))
    long_mel_shard = logmel.reshape(-1, cfg.num_mels, 2).repeat(
        reps, 1, 1)[None, :shard].contiguous()
    kf_vars = kd_vars = ("pass1_only", "pass2_only", "parts_64", "tile_64",
                         "copy_only")
    logmel4 = torch.cat([logmel, logmel])
    long_mel = torch.randn((1, LONG_FRAMES, cfg.num_mels, 2), generator=g,
                           device=dev) - 4.0
    ki_vars = ("ki_run_1", "ki_run_2", "ki_run_8", "ki_vec_stores",
               "ki_table_l1", "ki_no_register_cap", "ki_copy_only",
               "ki_no_prologue")
    cases = {
        "KF bench": (lambda: kf_case(spec, 255, 0), kf_vars),
        "KF masked": (lambda: kf_case(spec4, 255, 0, [1122, 843, 562, 0]),
                      kf_vars),
        "KF HDR": (lambda: kf_case(spec, 65535, 0), ("parts_64", "tile_64")),
        "KF IHS 2": (lambda: kf_case(spec, 255, 2), ("parts_64", "tile_64")),
        "KF long form": (lambda: kf_case(long_spec, 255, 0), kf_vars),
        "KD bench": (lambda: kd_case(logmel), kd_vars),
        "KD masked": (lambda: kd_case(logmel4, [1122, 843, 562, 0]),
                      kd_vars),
        "KD long form": (lambda: kd_case(long_mel), kd_vars),
        "KI uint8": (lambda: ki_case(True), ki_vars),
        "KI float": (lambda: ki_case(False), ki_vars),
        "KI long-form shard": (
            lambda: ki_case(False, long_mel_shard,
                            (cfg.tune_mul, cfg.tune_add)),
            ("ki_run_2", "ki_run_8", "ki_copy_only")),
    }
    setup_src = {"KD bench": logmel, "KD masked": logmel4,
                 "KD long form": long_mel}
    flush = torch.empty(64 * 1024 * 1024, device=dev)   # 256 MB

    def after_flush(fn):
        def run():
            flush.fill_(1.0)
            return fn()
        return run
    flush_ms = min(chip_smoke.cuda_ms(lambda: flush.fill_(1.0), args.iters)
                   for _ in range(2))
    record(case="256 MB fill (L2 eviction)", ms=flush_ms)
    for label, (setup, variants) in cases.items():
        make, outs, b_ms, floor_ms = setup()
        new_fn, old_fn = make(shipped, "new"), make(old, "old")
        fns = {v: make(libs[v][0], "new") for v in variants}
        for fn in (new_fn, old_fn, *fns.values()):
            if fn() != 0:
                raise RuntimeError(f"{label}: launch failed")
        torch.cuda.synchronize()
        ref = outs[(id(old), "old")]
        exact = [(id(shipped), "new")] + [
            (id(libs[v][0]), "new") for v in variants if v in EXACT]
        same = all(torch.equal(a, b) for key in exact
                   for a, b in zip(outs[key], ref))
        if not same:
            raise AssertionError(f"{label}: the forms' outputs differ")
        new_ms, old_ms = chip_smoke.race(new_fn, old_fn, label, args.iters)
        row = dict(case=label, new_ms=new_ms, old_ms=old_ms,
                   speedup=old_ms / new_ms, bound_ms=b_ms,
                   bound_share=b_ms / new_ms, bit_equal=same)
        if floor_ms is not None:
            row.update(two_pass_floor_ms=floor_ms,
                       floor_share=floor_ms / new_ms)
        record(**row)
        fill = outs[(id(shipped), "new")][0]
        fill_ms = min(chip_smoke.cuda_ms(fill.zero_, args.iters)
                      for _ in range(2))
        record(case=label, variant="torch zero_ of the output", ms=fill_ms,
               bound_share=chip_smoke.bound(chip_smoke.nbytes(fill), 0.0)[0]
               / fill_ms)
        if label.startswith("KD"):
            rows_in = setup_src[label].reshape(setup_src[label].shape[0], -1)
            am_ms = min(chip_smoke.cuda_ms(
                lambda: torch.aminmax(rows_in, dim=1), args.iters)
                for _ in range(2))
            record(case=label, variant="torch.aminmax over the rows "
                   "(the extrema alone)", ms=am_ms,
                   bound_share=chip_smoke.bound(chip_smoke.nbytes(rows_in),
                                                0.0)[0] / am_ms)
        for variant, fn in fns.items():
            ms = timed(fn)
            record(case=label, variant=variant, ms=ms,
                   share_of_new=ms / new_ms, share_of_old=ms / old_ms,
                   bound_share=b_ms / ms)
        if label == "KF bench":
            for name, fn in (("new, input evicted from L2", new_fn),
                             ("old, input evicted from L2", old_fn),
                             ("pass2_only, input evicted from L2",
                              fns["pass2_only"])):
                ms = timed(after_flush(fn)) - flush_ms
                record(case=label, variant=name, ms=ms, bound_share=b_ms / ms)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile_quant.json"),
              "w") as f:
        json.dump({"card": card, "ptxas": ptxas, "occupancy": occ,
                   "results": results}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
