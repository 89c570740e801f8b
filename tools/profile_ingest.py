"""Kernel KA (PCM-16 ingest) against the form it replaced, and where its time
goes, by ablation.

    python3 tools/profile_ingest.py [--iters 20]

Needs one NVIDIA GPU and nvcc. Builds gomel_tpu_torch/csrc/ingest.cu and
rfft_mag.cu as shipped, together with tools/ingest_earlier.cu (KA's earlier
form: one sample a thread, scalar accesses, a 64-bit division a sample in
the zero-stuff mode, a grid sized by the output), and once more for each
ablation:

  unroll_2, unroll_4   2 or 4 slots in flight a thread, a grid of half or
                       a quarter as many blocks (shipped: one slot)
  mono_v8              mono slots of 8 samples: one 16-byte load and two
                       float4 stores 32 bytes apart a thread (shipped: 4,
                       one 8-byte load and one float4 store, so a warp's
                       stores are 512 contiguous bytes)
  resident_grid        the grid capped at the card's resident blocks, the
                       threads walking on by grid strides (shipped: a grid
                       of the slots, one trip)
  divide               the division by the scale always a division (shipped:
                       a power of two by its exact reciprocal, same bits)
  convert              KA and the fused KB + KC's int16 mode with the
                       int16 -> float conversion instruction (I2F) in place
                       of the bias trick (common.cuh pcm_biased)
  fused_checked        the int16 mode's build with a test against the row's
                       end a load (and its scalar route) at every shape
                       (shipped: a build without, where every frame lies
                       inside its row)

every one of which must give the shipped bits. Then, on one card and in
turns (earlier, new, new, earlier), KA's times at these shapes:

  mono         [2, 1,440,000] int16 -> float32 (the bench rows, 30 s at
               48 kHz, whole hops: no padding; the phase encode's ingest)
  stereo       [1,440,000, 2] int16 -> [1,440,000]
  zero-stuff   16 kHz [2, 480,000] (zp 1, zs 2) and 32 kHz [2, 960,000]
               (zp 2, zs 1) -> [2, 1,440,000]
  per-row      [4, 1,440,000] with scales 32768 and 65536 (a batch bucket)
  small rows   [4, 230,400] per-row (a bucket of 4.8 s files)
  long form    [1, 21,602,816] (one shard of the 30-minute file)

each as: new, earlier, the ablations, and the one PyTorch call ``pcm /
scale`` where it computes the same function (the mono and per-row
modes); each row with its byte bound (each input read once, each output
written once, at 3.35 TB/s). New and earlier are held bit-equal to the
plain version before they are timed, and each entry point's host time a
call is measured (chip_smoke.host_us). Last, the fused KB + KC's int16 mode
at the bench shape, the batch bucket (per-row scales) and one row that
ends inside its last frames (the tested build), shipped, ``convert`` and
``fused_checked``, against the float launch alone and KA followed by it
(the route it replaces), bit-equal first, with the SASS instruction counts
by pipe of the n = 4096 kernels (tools/sass_opcodes).

Prints the card's name and power limit, ptxas's registers of each kernel,
the SASS instruction counts by pipe of KA's 32-bit kernels and of the
earlier form, and one line per measurement: device ms per call (CUDA events over calls
queued behind a sleep kernel, chip_smoke.cuda_ms, lower of two runs). The
same numbers go to chiprun_out/profile_ingest.json. Imports nothing of
JAX.
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
from gomel_tpu_torch.core.framing import pad_length  # noqa: E402
from gomel_tpu_torch.ops import _cuda, quantize  # noqa: E402
from tools.profile_fft import ptxas_lines  # noqa: E402

HOP = 1280
EARLIER = os.path.join(HERE, "tools", "ingest_earlier.cu")
SOURCES = ("ingest.cu", "common.cuh", "rfft_mag.cu", "fft_core.cuh",
           "mel_bands.cuh")
KA, FUSED = ("ingest.cu",), ("rfft_mag.cu",)

# the int16 sample made a float by the conversion instruction (I2F) and an
# add of the bias, in place of the bias trick's LOP3: the same bits
_CONVERT = [("common.cuh",
             "  return __uint_as_float((h & 0xffffu) ^ 0x4b008000u);",
             "  return __fadd_rn(static_cast<float>(static_cast<int>(h << 16)"
             " >> 16),\n                   kPcmBias);")]

# name -> (the units it builds, the edits (file, old, new)); every variant
# gives the shipped bits
VARIANTS = {
    "shipped": (KA + FUSED, []),
    "unroll_2": (KA, [("ingest.cu", "constexpr int kIngestUnroll = 1;",
                       "constexpr int kIngestUnroll = 2;")]),
    "unroll_4": (KA, [("ingest.cu", "constexpr int kIngestUnroll = 1;",
                       "constexpr int kIngestUnroll = 4;")]),
    "mono_v8": (KA, [("ingest.cu", "constexpr int kMonoSlot = 4;",
                      "constexpr int kMonoSlot = 8;")]),
    "resident_grid": (KA, [(
        "ingest.cu",
        "  const long long blocks = need < kMaxBlocks ? need : kMaxBlocks;",
        "  const long long resident = resident_blocks(\n"
        "      reinterpret_cast<const void*>(kernel), kIngestThreads, 0, "
        "device);\n"
        "  const long long blocks = need < resident ? need : resident;")]),
    "divide": (KA, [("common.cuh",
                     "  const bool pow2 = (b & 0x7fffffu) == 0u && e >= 27u "
                     "&& e <= 227u;",
                     "  const bool pow2 = false;")]),
    "convert": (KA + FUSED, _CONVERT),
    # the int16 mode's build with a row-end test a load, also where every
    # frame lies inside its row
    "fused_checked": (FUSED, [("rfft_mag.cu",
                               "  if (vec && n_in >= (frames - 1) * hop + n) {",
                               "  if (false) {")]),
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
        for name, text in files.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        paths = [os.path.join(d, u) for u in units]
        if variant == "shipped":
            paths.append(EARLIER)
        lib = os.path.join(d, "lib.so")
        # the variant's own headers first, then the shipped ones
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", d, "-I",
               _cuda.CSRC_DIR, "-o", lib, *paths]
        log = open(os.path.join(d, "build.log"), "w")
        jobs[variant] = (subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT), lib, log)
    libs = {}
    for variant, (proc, lib, log) in jobs.items():
        proc.wait()
        log.close()
        with open(log.name) as f:
            report = f.read()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{report}")
        handle = ctypes.CDLL(lib)
        for symbol, sig in (
                ("gomel_pcm16_ingest", "gomel_pcm16_ingest"),
                ("prof_earlier_pcm16_ingest", "gomel_pcm16_ingest"),
                ("gomel_stft_mel_log", "gomel_stft_mel_log"),
                ("gomel_stft_mel_log_pcm16", "gomel_stft_mel_log_pcm16")):
            if hasattr(handle, symbol):
                fn = getattr(handle, symbol)
                fn.argtypes = [*_cuda._SIGNATURES[sig], ctypes.c_int,
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
        libs[variant] = (handle, report)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_ingest: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = build(os.path.join(_cuda.BUILD_DIR, "profile_ingest"))
    ptxas = {v: [line for line in ptxas_lines(report)
                 if "ingest" in line or "Pcm16Signal" in line]
             for v, (_, report) in libs.items()}
    for variant, lines in ptxas.items():
        for line in lines:
            print(f"  ptxas, {variant}: {line}")
    # KA's 32-bit kernels and the earlier form, instructions by pipe (the
    # whole kernel: its walk loop counted once)
    from tools import sass_opcodes
    shipped_so = os.path.join(_cuda.BUILD_DIR, "profile_ingest", "shipped",
                              "lib.so")
    for kernel, count in sass_opcodes.binary_opcodes(shipped_so).items():
        m = re.search(r"pcm16_ingest_kernelILi(\d)ELi(\d)ELi(\d)EiE", kernel)
        if m or "pcm16_ingest_kernelEPKs" in kernel:
            label = (f"C {m.group(1)}, zp {m.group(2)}, zs {m.group(3)}" if m
                     else "earlier form")
            print(f"  sass, KA {label}: {sum(count.values())} instructions, "
                  f"by pipe {sass_opcodes.pipes(count)}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    f32 = torch.float32
    results = []

    def record(**row):
        results.append(row)
        print("  " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                               else f"{k} {v}" for k, v in row.items()),
              flush=True)

    def pcm_of(shape):
        return torch.randint(-32768, 32768, shape, generator=g, device=dev,
                             dtype=torch.int32).to(torch.int16)

    bench = 1_440_000
    padded = pad_length(bench, HOP)
    scales4 = torch.tensor([32768.0, 65536.0, 32768.0, 65536.0], device=dev)
    shard = 16_875 * HOP + 4096 - HOP
    # label -> (pcm, channels, scale, n_out, zp, zs)
    cases = {
        "mono [2, 1,440,000]": (pcm_of((2, bench)), 1, 32768.0, padded, 0, 0),
        "stereo [1,440,000, 2]": (pcm_of((bench, 2)), 2, 65536.0, padded, 0,
                                  0),
        "zero-stuff 16 kHz [2, 480,000]": (pcm_of((2, bench // 3)), 1,
                                           32768.0, padded, 1, 2),
        "zero-stuff 32 kHz [2, 960,000]": (pcm_of((2, 2 * bench // 3)), 1,
                                           32768.0, padded, 2, 1),
        "per-row [4, 1,440,000]": (pcm_of((4, padded)), 1, scales4, padded,
                                   0, 0),
        "per-row small rows [4, 230,400]": (pcm_of((4, 230_400)), 1, scales4,
                                            230_400, 0, 0),
        "long-form shard [1, 21,602,816]": (pcm_of((1, shard)), 1, 32768.0,
                                            shard, 0, 0),
    }

    shipped = libs["shipped"][0]
    for label, (pcm, ch, scale, n_out, zp, zs) in cases.items():
        rows, n_in = (1, pcm.shape[0]) if ch == 2 else pcm.shape
        # the one PyTorch call of the mono modes (none of them pads here)
        library = None
        if ch == 1 and zp == 0:
            div = scale[:, None] if isinstance(scale, torch.Tensor) else scale
            library = lambda p=pcm, d=div: p / d   # noqa: E731
        per_row = isinstance(scale, torch.Tensor)
        outs = {}

        def make(lib, symbol, key):
            out = torch.empty((rows, n_out), dtype=f32, device=dev)
            outs[key] = out
            fn = getattr(lib, symbol)
            head = (pcm.data_ptr(), out.data_ptr(), rows, n_in, n_out, ch,
                    0.0 if per_row else float(scale),
                    scale.data_ptr() if per_row else None, zp, zs)
            return lambda: fn(*head, dev.index, stream)

        new_fn = make(shipped, "gomel_pcm16_ingest", "new")
        old_fn = make(shipped, "prof_earlier_pcm16_ingest", "old")
        fns = {v: make(libs[v][0], "gomel_pcm16_ingest", v)
               for v, (units, _) in VARIANTS.items()
               if v != "shipped" and "ingest.cu" in units}
        for fn in (new_fn, old_fn, *fns.values()):
            if fn() != 0:
                raise RuntimeError(f"{label}: launch failed")
        torch.cuda.synchronize()
        if ch == 2:
            ref = quantize.pcm16_ingest_plain(pcm, f32, scale, n_out, zp=zp,
                                              zs=zs)[None]
        else:
            ref = quantize.pcm16_ingest_plain(pcm, f32, scale, n_out,
                                              batched=True, zp=zp, zs=zs)
        bad = [key for key, out in outs.items() if not torch.equal(out, ref)]
        if bad:
            raise AssertionError(f"{label}: {bad} differ from the plain "
                                 f"version")
        moved = chip_smoke.nbytes(pcm) + 4.0 * rows * n_out + (
            chip_smoke.nbytes(scale) if per_row else 0.0)
        b_ms = chip_smoke.bound(moved, 0.0)[0]
        new_ms, old_ms = chip_smoke.race(new_fn, old_fn, label, args.iters)
        lib_ms = (None if library is None else
                  min(chip_smoke.cuda_ms(library, args.iters)
                      for _ in range(2)))
        record(case=label, new_ms=new_ms, old_ms=old_ms,
               speedup=old_ms / new_ms, bound_ms=b_ms,
               bound_share=b_ms / new_ms, old_bound_share=b_ms / old_ms,
               library_ms=lib_ms, bit_equal=True,
               new_enqueue_us=chip_smoke.host_us(new_fn),
               old_enqueue_us=chip_smoke.host_us(old_fn))
        for variant, fn in fns.items():
            ms = min(chip_smoke.cuda_ms(fn, args.iters) for _ in range(2))
            record(case=label, variant=variant, ms=ms,
                   share_of_new=ms / new_ms, bound_share=b_ms / ms)
    fused_cases(libs, dev, stream, pcm_of, scales4, record, args.iters)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile_ingest.json"),
              "w") as f:
        json.dump({"card": card, "ptxas": ptxas, "results": results}, f,
                  indent=1)
    print(card)
    return 0


def fused_cases(libs, dev, stream, pcm_of, scales4, record, iters) -> None:
    """The fused KB + KC's int16 mode at the bench shape and the batch
    bucket, shipped and with the conversion instruction (``convert``),
    against the float launch on KA's output and KA + the float launch."""
    from gomel_tpu_torch.core.config import MelConfig
    from gomel_tpu_torch.core.filterbank import mel_weights
    from gomel_tpu_torch.ops import mel_ops, rfft_mag
    from gomel_tpu_torch.ops.stft import hann_window, num_frames_of
    cfg = MelConfig.cli_default()
    n, hop, mels = cfg.resolut, cfg.window, cfg.num_mels
    win = torch.tensor(hann_window(n), dtype=torch.float32, device=dev)
    fwd = torch.tensor(mel_weights(cfg.n_bins, mels, cfg.mel_fmin,
                                   cfg.mel_fmax), dtype=torch.float32,
                       device=dev)
    slots, weights, groups = mel_ops._mel_band_table(fwd)
    tw, tw_pass = rfft_mag.fft_tables(n, dev)
    plan = rfft_mag.fft_plan_args(n)
    shipped, convert = libs["shipped"][0], libs["convert"][0]
    checked = libs["fused_checked"][0]
    from tools import sass_opcodes
    for variant in ("shipped", "convert"):
        lib_path = os.path.join(_cuda.BUILD_DIR, "profile_ingest", variant,
                                "lib.so")
        for kernel, count in sass_opcodes.binary_opcodes(lib_path).items():
            if "stft_mel_log_pow2_kernelILi11E" in kernel:
                record(sass=variant,
                       kernel=("float" if "Pcm16" not in kernel else
                               "int16 whole" if "ILb1E" in kernel
                               else "int16 tested"),
                       instructions=sum(count.values()),
                       **sass_opcodes.pipes(count))
    for label, pcm, scale in (
            ("fused int16 [2, 1,440,000]", pcm_of((2, 1_440_000)), 32768.0),
            ("fused int16 per-row [4, 1,440,000]", pcm_of((4, 1_440_000)),
             scales4),
            ("fused int16 one row of 1,438,000 padded to 1,440,000 (the "
             "tested build)", pcm_of((1, 1_438_000)), 65536.0)):
        rows, n_in = pcm.shape
        per_row = isinstance(scale, torch.Tensor)
        length = 1_440_000
        frames = num_frames_of(length, n, hop)
        x = torch.empty((rows, length), device=dev)
        outs = {}

        def int16(lib, key):
            out = torch.empty((rows, frames, mels, 2), device=dev)
            outs[key] = out
            return lambda: lib.gomel_stft_mel_log_pcm16(
                pcm.data_ptr(), 0.0 if per_row else float(scale),
                scale.data_ptr() if per_row else None, n_in, win.data_ptr(),
                tw.data_ptr(), tw_pass.data_ptr(), slots.data_ptr(),
                weights.data_ptr(), groups, out.data_ptr(), 2 * mels, rows,
                frames, hop, n, *plan, dev.index, stream)

        def ka():
            return shipped.gomel_pcm16_ingest(
                pcm.data_ptr(), x.data_ptr(), rows, n_in, length, 1,
                0.0 if per_row else float(scale),
                scale.data_ptr() if per_row else None, 0, 0, dev.index,
                stream)

        out_f = torch.empty((rows, frames, mels, 2), device=dev)

        def float_launch():
            return shipped.gomel_stft_mel_log(
                x.data_ptr(), win.data_ptr(), tw.data_ptr(),
                tw_pass.data_ptr(), slots.data_ptr(), weights.data_ptr(),
                groups, out_f.data_ptr(), 2 * mels, rows, frames, length, hop,
                n, *plan, dev.index, stream)

        new_fn, conv_fn = int16(shipped, "new"), int16(convert, "convert")
        checked_fn = int16(checked, "checked")
        for fn in (new_fn, conv_fn, checked_fn, ka, float_launch):
            if fn() != 0:
                raise RuntimeError(f"{label}: launch failed")
        torch.cuda.synchronize()
        if not all(torch.equal(o, out_f) for o in outs.values()):
            raise AssertionError(f"{label}: the int16 mode differs from KA "
                                 f"then the float launch")
        new_ms, chain_ms = chip_smoke.race(
            new_fn, lambda: (ka(), float_launch())[1], label, iters)
        float_ms = min(chip_smoke.cuda_ms(float_launch, iters)
                       for _ in range(2))
        conv_ms = min(chip_smoke.cuda_ms(conv_fn, iters) for _ in range(2))
        checked_ms = min(chip_smoke.cuda_ms(checked_fn, iters)
                         for _ in range(2))
        moved = (chip_smoke.nbytes(pcm, win, slots, weights, out_f)
                 + (chip_smoke.nbytes(scale) if per_row else 0.0))
        record(case=label, int16_ms=new_ms, ka_then_float_ms=chain_ms,
               float_launch_ms=float_ms, int16_convert_ms=conv_ms,
               int16_checked_ms=checked_ms,
               int16_over_float=new_ms / float_ms,
               int16_over_chain=new_ms / chain_ms,
               byte_bound_ms=chip_smoke.bound(moved, 0.0)[0], bit_equal=True)


if __name__ == "__main__":
    sys.exit(main())
