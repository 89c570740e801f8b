"""Where the matmul DFT kernels KN and KO spend their time, by ablation.

    python3 tools/profile_dft_mm.py [--iters 20]

Needs one NVIDIA GPU and nvcc. Builds gomel_tpu_torch/csrc/dft_mm.cu as
shipped and in variants that each take one piece of work out of the
kernels' main loop, then times every variant on the card at the
Griffin-Lim bench shape of chip_smoke.py (2 x 1122 frames of 4096, hop
1280, Hann folded into the weights). The variants' outputs are wrong by
construction: only their times mean anything. Variants:

  shipped    the kernels as the port builds them
  a_once     the A operand (frames for KN, planes for KO) loaded from device
             memory in the first 32-deep stage only: no later global loads,
             bounds branches or conversions of A
  b_once     the B operand (the weights) loaded in the first stage only
  ab_once    both: the main loop keeps its barriers and its math
  no_math    the main loop's products replaced by integer XORs of the
             fragments (bf16: no mma.sync) or one add a row and a column
             (float32: 15 adds for 64 fmas), which keep every load, store
             and shared-memory read live

Prints the card's name and power limit, ptxas's register and shared-memory
report of each kernel, and one line per (kernel, mode, variant): device ms
per call (CUDA events over --iters back-to-back calls after 3 warmup, lower
of two runs) and its share of the shipped kernel's time. The same numbers go
to chiprun_out/profile_dft_mm.json. Imports nothing of JAX.
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

from gomel_tpu_torch.ops import _cuda, dft_mm  # noqa: E402
from gomel_tpu_torch.ops.stft import hann_window  # noqa: E402

N, HOP, FRAMES, BATCH = 4096, 1280, 1122, 2

# (text in dft_mm.cu, its replacement) per variant; a missing text fails
_A_BF16 = "for (int e = tid; e < kTileM * kDepth16; e += kThreads) {"
_B_BF16 = "for (int e = tid; e < kTileN * (kDepth16 / 8); e += kThreads) {"
_A_F32 = "for (int e = tid; e < kTileM * kDepth32; e += kThreads) {"
_B_F32 = "for (int e = tid; e < kTileN * kDepth32; e += kThreads) {"
_MMA = ("        mma_bf16(part, a[0][i], b[0][j]);\n"
        "        mma_bf16(part, a[1][i], b[1][j]);\n")
_FMA = "acc[i][j] = fmaf(a[i], b[j], acc[i][j]);"
_NO_MMA = ("        part[0] = __uint_as_float(\n"
           "            (a[0][i][0] ^ a[0][i][1] ^ a[0][i][2] ^ a[0][i][3] ^\n"
           "             a[1][i][0] ^ a[1][i][1] ^ a[1][i][2] ^ a[1][i][3] ^\n"
           "             b[0][j][0] ^ b[0][j][1] ^ b[1][j][0] ^ b[1][j][1]) &\n"
           "            0x3f800000u);\n")
_NO_FMA = ("if (j == 0) acc[i][j] += a[i];"
           " else if (i == 0) acc[i][j] += b[j];")


def _once(loop: str) -> tuple[str, str]:
    return loop, loop.replace("e < ", "k0 == 0 && e < ", 1)


VARIANTS = {
    "shipped": [],
    "a_once": [_once(_A_BF16), _once(_A_F32)],
    "b_once": [_once(_B_BF16), _once(_B_F32)],
    "ab_once": [_once(_A_BF16), _once(_A_F32), _once(_B_BF16),
                _once(_B_F32)],
    "no_math": [(_MMA, _NO_MMA), (_FMA, _NO_FMA)],
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def build(work: str) -> dict[str, tuple[ctypes.CDLL, str]]:
    """One nvcc per variant, all started together; returns the loaded
    libraries with ptxas's report of each."""
    with open(os.path.join(_cuda.CSRC_DIR, "dft_mm.cu")) as f:
        source = f.read()
    os.makedirs(work, exist_ok=True)
    jobs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in dft_mm.cu")
            text = text.replace(old, new)
        src = os.path.join(work, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(work, f"{name}.so")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared",
               "-I", _cuda.CSRC_DIR, "-o", lib, src]
        log = open(os.path.join(work, f"{name}.log"), "w")
        jobs[name] = (subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT), lib, log)
    libs = {}
    for name, (proc, lib, log) in jobs.items():
        proc.wait()
        log.close()
        with open(log.name) as f:
            report = f.read()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        handle = ctypes.CDLL(lib)
        for symbol in ("gomel_dft_fwd", "gomel_dft_inv"):
            fn = getattr(handle, symbol)
            fn.argtypes = [*_cuda._SIGNATURES[symbol], ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = (handle, report)
    return libs


def ptxas_lines(report: str) -> list[str]:
    """ptxas's register and shared-memory line of each kernel entry."""
    out, entry = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used \d+ registers.*", line)
        if m and entry:
            out.append(f"{entry}: {m.group(0).strip()}")
            entry = None
    return out


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_dft_mm: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = build(os.path.join(_cuda.BUILD_DIR, "profile_dft_mm"))
    for line in ptxas_lines(libs["shipped"][1]):
        print(f"  ptxas, shipped {line}")

    g = torch.Generator(device=dev).manual_seed(0)
    length = N + (FRAMES - 1) * HOP
    rows, half = BATCH * FRAMES, N // 2 + 1
    x = torch.rand((BATCH, length), generator=g, device=dev) - 0.5
    mag = torch.rand((rows, half), generator=g, device=dev)
    win = hann_window(N)
    weights = {(d, m): dft_mm._weights(d, N, win, m, dev)
               for d in ("fwd", "inv") for m in ("bf16", "f32")}
    f32 = torch.float32
    re32 = torch.randn((rows, half), generator=g, device=dev)
    im32 = torch.randn((rows, half), generator=g, device=dev)
    re16, im16 = re32.bfloat16(), im32.bfloat16()
    out_f = [torch.empty((rows, half), dtype=f32, device=dev)
             for _ in range(2)]
    out_b = [torch.empty((rows, half), dtype=torch.bfloat16, device=dev)
             for _ in range(2)]
    frames_w = torch.empty((rows, N), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def fwd(lib, mode):
        w = weights[("fwd", mode)]
        bf16 = mode == "bf16"
        outs = out_b if bf16 else out_f
        # bf16: the interior Griffin-Lim projection into bf16 planes;
        # float32: (re, im) planes
        epilogue = 3 if bf16 else 0
        return lambda: lib.gomel_dft_fwd(
            int(bf16), x.data_ptr(), w.data_ptr(), mag.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(), int(bf16), BATCH,
            FRAMES, length, HOP, N, w.shape[1], w.shape[0], epilogue, 0, 0,
            dev.index, stream)

    def inv(lib, mode):
        w = weights[("inv", mode)]
        bf16 = mode == "bf16"
        re, im = (re16, im16) if bf16 else (re32, im32)
        return lambda: lib.gomel_dft_inv(
            int(bf16), int(bf16), re.data_ptr(), im.data_ptr(), w.data_ptr(),
            frames_w.data_ptr(), rows, FRAMES, FRAMES, N, w.shape[1],
            w.shape[0], dev.index, stream)

    results = []
    for kernel, make in (("KN", fwd), ("KO", inv)):
        for mode in ("bf16", "f32"):
            base = None
            for variant, (lib, _) in libs.items():
                call = make(lib, mode)
                rc = call()
                if rc != 0:
                    raise RuntimeError(f"{kernel} {mode} {variant}: launch "
                                       f"failed ({rc})")
                ms = cuda_ms(call, args.iters)
                base = ms if variant == "shipped" else base
                results.append(dict(kernel=kernel, mode=mode, variant=variant,
                                    ms=ms, share=ms / base))
                print(f"  {kernel} {mode} {variant}: {ms:.4f} ms "
                      f"({100 * ms / base:.1f}% of shipped)", flush=True)
    flops = 2.0 * rows * N * 2 * half
    print(f"  work: {flops / 1e9:.1f} GFLOP a product; shapes rows {rows}, "
          f"n {N}, weights {tuple(weights[('fwd', 'bf16')].shape)} (fwd), "
          f"{tuple(weights[('inv', 'bf16')].shape)} (inv)")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile_dft_mm.json"),
              "w") as f:
        json.dump({"card": card, "ptxas": ptxas_lines(libs["shipped"][1]),
                   "results": results}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
