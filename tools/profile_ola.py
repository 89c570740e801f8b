"""The overlap-add epilogues KH and KM on their hop-row walk against the
one-thread-a-sample form they replaced, and where their time goes, by
ablation.

    python3 tools/profile_ola.py [--iters 20]

Needs one NVIDIA GPU and nvcc. Builds gomel_tpu_torch/csrc/phase_decode.cu
(KH) and shard_epilogue.cu (KM) as shipped, together with
tools/ola_one_thread.cu (the earlier forms: one thread a sample, a 64-bit
division of each sample's position by the hop), and once more with the
arithmetic taken out (``copy_only``: KH's tap adds become bit xors, the
normalisation returns its input, the momentum step and the PCM-16
conversion become bit moves; what is left reads and writes what the
shipped kernels read and write), with the divisions by the window sum as
multiplies (``mul_not_div``), with the entry points held to the scalar
path (``scalar``: one sample a thread), and with a register cap that lets
more blocks stay on an SM (``min_blocks_3``, ``min_blocks_4``: 42 and 32
registers; these three must give the shipped bits). Then, on one card and in
turns (old, new, new, old), times at the shapes of chip_smoke.py:

  KH bench   [2, 1122, 4096] frames, hop 1280, Hann, PCM-16 (the fromphase
             decode's epilogue)
  KH shard   [1, 16875, 4096] frames, no window (the long-form decode's
             per-shard overlap-add)
  KM decode  one shard of the 30-minute decode: [1, 21,600,000 + 2816]
             and a halo, the last shard's window sum, PCM-16
  KM momentum the same shard in the Griffin-Lim momentum step into an
             extended carry

each as: new (the shipped vector path), old, old with the index precomputed
(the division replaced by a multiply by the hop's reciprocal: the
division's share), and each variant (the copy-only one gives the bytes'
achievable time on this card). Every row has
its byte
bound (each input read once, each output written once, at 3.35 TB/s). New
and old are held bit-equal before they are timed, and each entry point's
host time a call is measured (chip_smoke.host_us).

Prints the card's name and power limit, ptxas's registers and spills of each
kernel, and one line per measurement: device ms per call (CUDA events over
calls queued behind a sleep kernel, chip_smoke.cuda_ms, lower of two runs).
The same numbers go to chiprun_out/profile_ola.json. Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402
from gomel_tpu_torch.ops import _cuda, istft  # noqa: E402
from gomel_tpu_torch.ops.stft import hann_window  # noqa: E402
from tools.profile_fft import ptxas_lines  # noqa: E402

N, HOP = 4096, 1280
BENCH = (2, 1122)
SHARD_FRAMES, N_SHARDS = 16875, 4
N_FRAMES = 67497                  # the 30-minute file's real frames
OLD = os.path.join(HERE, "tools", "ola_one_thread.cu")
SOURCES = ("overlap_add.cuh", "shard_epilogue.cu", "phase_decode.cu")

# copy_only: the edits that take the arithmetic out of the shipped form
_COPY_ONLY = [
    ("overlap_add.cuh",
     "  return ws > threshold ? __fdiv_rn(t, ws)\n"
     "                        : (ws > 1e-21f ? __fdiv_rn(t, threshold) : t);",
     "  return t;"),
    ("overlap_add.cuh",
     "  float q = isnan(y) ? 0.0f : fminf(fmaxf(y, -1.0f), 1.0f);\n"
     "  q = fminf(fmaxf(rintf(q * 32768.0f), -32768.0f), 32767.0f);\n"
     "  return static_cast<int16_t>(q);",
     "  return static_cast<int16_t>(__float_as_int(y) >> 16);"),
    ("phase_decode.cu",
     "              acc.v[l] = __fadd_rn(acc.v[l], v[u].v[l]);",
     "              acc.v[l] = __int_as_float(__float_as_int(acc.v[l]) ^\n"
     "                                        __float_as_int(v[u].v[l]));"),
    ("shard_epilogue.cu",
     "        for (int l = 0; l < kV; ++l) t.v[l] = __fadd_rn(t.v[l], h.v[l]);",
     "        for (int l = 0; l < kV; ++l) t.v[l] = h.v[l];"),
    ("shard_epilogue.cu",
     "          y.v[l] = __fadd_rn(t.v[l],\n"
     "                             __fmul_rn(momentum, __fsub_rn(t.v[l], tp.v[l])));",
     "          y.v[l] = tp.v[l];"),
]


def _min_blocks(k: int) -> list[tuple[str, str, str]]:
    """__launch_bounds__ asking for k blocks of 512 threads an SM: a cap of
    65536 / (512 k) registers a thread, so more 320-thread blocks fit."""
    old = "__launch_bounds__(kOlaMaxThreads)"
    return [(f, old, f"__launch_bounds__(kOlaMaxThreads, {k})")
            for f in ("shard_epilogue.cu", "phase_decode.cu")]


# scalar: the entry points' path choice (overlap_add.cuh ola_vector) taken
# out, so every shape runs one sample a thread
_SCALAR = [
    ("phase_decode.cu", "  if (ola_vector({n, hop}, {src, tb, of, op})) {",
     "  if (false) {"),
    ("shard_epilogue.cu",
     "  if (ola_vector({hop, ext_len, chunk, recv_stride, out_stride, col0},\n"
     "                 {sig, rv, tb, tp, of, ot, op})) {",
     "  if (false) {"),
]

# name -> the edits; the exact variants give the shipped bits
VARIANTS = {
    "shipped": [],
    "copy_only": _COPY_ONLY,
    "scalar": _SCALAR,
    "min_blocks_3": _min_blocks(3),
    "min_blocks_4": _min_blocks(4),
    # the division by the window sum (or the threshold) as a multiply: the
    # share of KM's and KH's IEEE divisions
    "mul_not_div": [("overlap_add.cuh",
                     "  return ws > threshold ? __fdiv_rn(t, ws)\n"
                     "                        : (ws > 1e-21f ? __fdiv_rn(t, threshold) : t);",
                     "  return ws > threshold ? __fmul_rn(t, ws)\n"
                     "                        : (ws > 1e-21f ? __fmul_rn(t, threshold) : t);")],
}
EXACT = ("scalar", "min_blocks_3", "min_blocks_4")


def build(work: str) -> dict[str, tuple[ctypes.CDLL, str]]:
    """One nvcc per variant, all started together; returns the loaded
    libraries with ptxas's report."""
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
        for name, text in files.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        units = [os.path.join(d, "shard_epilogue.cu"),
                 os.path.join(d, "phase_decode.cu")]
        if variant == "shipped":
            units.append(OLD)
        lib = os.path.join(d, "lib.so")
        # the variant's own overlap_add.cuh first, then the shipped headers
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", d, "-I",
               _cuda.CSRC_DIR, "-o", lib, *units]
        log = open(os.path.join(d, "build.log"), "w")
        jobs[variant] = (subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT), lib, log)
    p, i64, i32, f32, u64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_float, ctypes.c_ulonglong)
    old = {
        "prof_old_overlap_normalize": [p, p, p, p, p, i64, i64, i64, i64, i32,
                                       f32, f32, u64],
        "prof_old_shard_epilogue": [p, i64, p, i64, i64, p, i64, i64, i64,
                                    i64, i32, f32, f32, p, f32, p, i64, p, p,
                                    p, i64, i64, u64],
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
        for symbol in ("gomel_overlap_normalize", "gomel_shard_epilogue"):
            fn = getattr(handle, symbol)
            fn.argtypes = [*_cuda._SIGNATURES[symbol], i32, p]
            fn.restype = i32
        for symbol, args in old.items():
            if hasattr(handle, symbol):
                getattr(handle, symbol).argtypes = [*args, i32, p]
                getattr(handle, symbol).restype = i32
        libs[variant] = (handle, report)
    return libs


def magic(hop: int) -> int:
    """The reciprocal of hop the old form's ablation multiplies by:
    p // hop == (p * magic) >> 64 for p < 2^32, hop < 2^16."""
    return (1 << 64) // hop + 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_ola: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = build(os.path.join(_cuda.BUILD_DIR, "profile_ola"))
    ptxas = {v: [line for line in ptxas_lines(report)
                 if "overlap_normalize" in line or "shard_epilogue" in line]
             for v, (_, report) in libs.items()}
    for variant, lines in ptxas.items():
        for line in lines:
            print(f"  ptxas, {variant}: {line}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    win = torch.tensor(hann_window(N), dtype=torch.float32, device=dev)
    table, prefix = istft._window_table(win, HOP)
    taps = prefix.shape[0]
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

    # -- KH: [B, F, n] frames -> float32 or PCM-16 ----------------------------
    def kh_case(batch, frames, normalise):
        fw = torch.rand((batch, frames, N), generator=g, device=dev) - 0.5
        length = N + (frames - 1) * HOP
        threshold = istft.window_sum_threshold(prefix, frames)
        short = int(frames + taps - 1 <= 2 * (taps - 1))
        tb = table.data_ptr() if normalise else None
        outs = {}

        def make(lib, kind):
            pcm = torch.empty((batch, length), dtype=torch.int16, device=dev)
            out = torch.empty((batch, length), device=dev)
            fin = torch.ones(batch, dtype=torch.int32, device=dev)
            outs[(id(lib), kind)] = pcm if normalise else out
            o_f = None if normalise else out.data_ptr()
            o_p = pcm.data_ptr() if normalise else None
            head = (fw.data_ptr(), tb, o_f, o_p, fin.data_ptr(), batch,
                    frames, N, HOP, short, threshold, 0.0)
            if kind == "new":
                return lambda: lib.gomel_overlap_normalize(
                    *head, dev.index, stream)
            m = magic(HOP) if kind == "old_magic" else 0
            return lambda: lib.prof_old_overlap_normalize(*head, m, dev.index,
                                                          stream)
        out_bytes = batch * length * (2 if normalise else 4)
        b_ms = chip_smoke.bound(chip_smoke.nbytes(fw) + out_bytes
                                + (chip_smoke.nbytes(table) if normalise
                                   else 0), 0.0)[0]
        return make, outs, b_ms

    # -- KM: one shard's sig_ext + halo -> decode PCM-16 or momentum ----------
    chunk = SHARD_FRAMES * HOP
    halo = N - HOP
    ext = chunk + halo

    def km_case(mode):
        sig = torch.rand((1, ext), generator=g, device=dev) - 0.5
        left = torch.rand((1, ext), generator=g, device=dev) - 0.5
        recv = left[:, chunk:]               # a strided view, as the halo push
        start = (N_SHARDS - 1) * chunk
        t_prev = torch.rand((1, chunk), generator=g, device=dev) - 0.5
        outs = {}
        decode = mode == "decode"
        threshold = istft.window_sum_threshold(prefix, N_FRAMES)

        def make(lib, kind):
            pcm = torch.empty((1, chunk), dtype=torch.int16, device=dev)
            out_f = torch.empty((1, ext), device=dev)
            out_t = torch.empty((1, chunk), device=dev)
            fin = torch.ones(1, dtype=torch.int32, device=dev)
            outs[(id(lib), kind)] = pcm if decode else out_t
            if not decode:
                outs[(id(lib), kind, "c")] = out_f
            common = dict(
                tb=table.data_ptr() if decode else None,
                tp=None if decode else t_prev.data_ptr(),
                of=None if decode else out_f.data_ptr(),
                ot=None if decode else out_t.data_ptr(),
                op=pcm.data_ptr() if decode else None,
                stride=chunk if decode else ext)
            if kind == "new":
                return lambda: lib.gomel_shard_epilogue(
                    sig.data_ptr(), ext, recv.data_ptr(), recv.stride(0),
                    halo, common["tb"], start, N_FRAMES, HOP, taps, 0,
                    threshold, 0.0, common["tp"], 0.99, common["of"],
                    common["stride"], common["ot"], common["op"],
                    fin.data_ptr(), 1, chunk, dev.index, stream)
            m = magic(HOP) if kind == "old_magic" else 0
            return lambda: lib.prof_old_shard_epilogue(
                sig.data_ptr(), ext, recv.data_ptr(), recv.stride(0), halo,
                common["tb"], start, N_FRAMES, HOP, taps, 0, threshold, 0.0,
                common["tp"], 0.99, common["of"], common["stride"],
                common["ot"], common["op"], fin.data_ptr(), 1, chunk, m,
                dev.index, stream)
        moved = chip_smoke.nbytes(sig[:, :chunk], recv) + (
            2.0 * chunk + chip_smoke.nbytes(table) if decode
            else chip_smoke.nbytes(t_prev) + 8.0 * chunk)
        return make, outs, chip_smoke.bound(moved, 0.0)[0]

    shipped = libs["shipped"][0]
    cases = {
        "KH bench PCM-16": lambda: kh_case(*BENCH, True),
        "KH shard overlap-add": lambda: kh_case(1, SHARD_FRAMES, False),
        "KM decode PCM-16": lambda: km_case("decode"),
        "KM momentum": lambda: km_case("momentum"),
    }
    for label, setup in cases.items():
        make, outs, b_ms = setup()
        new_fn, old_fn = make(shipped, "new"), make(shipped, "old")
        fns = {"old_magic": make(shipped, "old_magic")}
        for variant in VARIANTS:
            if variant != "shipped":
                fns[variant] = make(libs[variant][0], "new")
        for fn in (new_fn, old_fn, *fns.values()):
            if fn() != 0:
                raise RuntimeError(f"{label}: launch failed")
        torch.cuda.synchronize()
        exact = [(id(shipped), "new"), (id(shipped), "old_magic")] + [
            (id(libs[v][0]), "new") for v in EXACT]
        ref = outs[(id(shipped), "old")]
        same = all(torch.equal(outs[key], ref) for key in exact)
        if "KM momentum" == label:
            c_ref = outs[(id(shipped), "old", "c")][:, :chunk]
            same = same and all(
                torch.equal(outs[key + ("c",)][:, :chunk], c_ref)
                for key in exact)
        if not same:
            raise AssertionError(f"{label}: the forms' outputs differ")
        new_ms, old_ms = chip_smoke.race(new_fn, old_fn, label, args.iters)
        # the C entry points' host time a call (the new one sizes its grid
        # from the SM count and the kernel's occupancy, asked once and kept)
        new_us, old_us = chip_smoke.host_us(new_fn), chip_smoke.host_us(old_fn)
        record(case=label, new_ms=new_ms, old_ms=old_ms,
               speedup=old_ms / new_ms, bound_ms=b_ms,
               bound_share=b_ms / new_ms, bit_equal=same,
               new_enqueue_us=new_us, old_enqueue_us=old_us)
        for variant, fn in fns.items():
            ms = timed(fn)
            record(case=label, variant=variant, ms=ms,
                   share_of_new=ms / new_ms, share_of_old=ms / old_ms,
                   bound_share=b_ms / ms)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile_ola.json"), "w") as f:
        json.dump({"card": card, "ptxas": ptxas, "results": results}, f,
                  indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
