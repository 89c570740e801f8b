"""Where the matmul DFT kernels KN and KO spend their time, by ablation.

    python3 tools/profile_dft_mm.py [--iters 20]

Needs one NVIDIA GPU and nvcc. Builds gomel_tpu_torch/csrc/dft_mm.cu as
shipped and in variants that each change one piece of the kernels' main
loop, then times every variant on the card at the Griffin-Lim bench shape of
chip_smoke.py (2 x 1122 frames of 4096, hop 1280, Hann folded into the
weights): KN's bf16 mode as the interior Griffin-Lim projection into padded
bf16 planes, its float32 mode as (re, im) planes, KO's bf16 mode from those
bf16 planes and its float32 mode from float32 planes. Variants:

  shipped     the kernels as the port builds them
  a_once      the producer copies the A operand (frames for KN, planes for
              KO) in the first stage of a tile only
  b_once      the producer loads the weights (TMA) in the first stage of a
              tile only
  no_math     no wgmma (bf16: the A fragments are XORed into the partial
              accumulator, so their loads and conversions stay live) and one
              add a row and a column for the 64 fused multiply-adds (float32)
  no_promote  bf16: every product accumulates into the running sum on the
              tensor cores, no fresh accumulator and no rounded adds
  promote32   bf16: a fresh accumulator every 32 of the contraction, not 64

The shipped kernels' two A routes of the bf16 mode are raced too: KN on the
bf16 copy of the signal (hop % 8 == 0, as shipped) against KN reading the
float32 signal and rounding in registers, KO on bf16 planes against KO on
float32 planes.

The timed outputs of a_once, b_once and no_math are wrong by construction;
no_promote and promote32 are real designs, so their bf16 outputs are also
held to the bf16-operand plain version at n = 4096 (the bench shape) and
n = 8192 (the bound: 2e-5 of each frame's peak). The tool also builds
tools/dft_mm_mma_sync.cu, the earlier mma.sync tile, and races it against the
shipped kernels on the same operands, beside torch.matmul on the bf16 and
float32 operands as they are (4098 columns or rows) and padded to aligned
widths (4224 forward columns, a contraction of 4128).

Prints the card's name and power limit, ptxas's registers, spills and shared
memory of each kernel, and one line per (kernel, mode, variant): device ms
per call (CUDA events over --iters back-to-back calls after 3 warmup, lowest
of three runs) and its share of the shipped kernel's time. The same numbers
go to chiprun_out/profile_dft_mm.json. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from gomel_tpu_torch.ops import _cuda, dft_mm  # noqa: E402
from gomel_tpu_torch.ops.stft import frame_signal, hann_window  # noqa: E402

N, HOP, FRAMES, BATCH = 4096, 1280, 1122, 2
OLD_SRC = os.path.join(HERE, "tools", "dft_mm_mma_sync.cu")

# (text in dft_mm.cu, its replacement) per variant; a missing text fails
_LOAD_A = ("      load_a<C::kDepth, TA>(op, rowbase, asm_ + s * C::kABytes, "
           "k0, p, vec);\n")
_LOAD_B = ("      if (p == 0) {\n"
           "        mbar_expect_tx(&full[s], C::kBBytes);\n")
_WGMMA = ("      wgmma_rs(part, a[j], desc_sw128(bs + (g * kSteps + j) * 32), "
          "j);\n")
_ADD = ("    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], "
        "part[i]);\n")
_FMA = "for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);"
_PROMOTE = "constexpr int kPromote = 64;"

VARIANTS = {
    "shipped": [],
    "a_once": [(_LOAD_A, "      if (ks == 0)\n  " + _LOAD_A)],
    # past the first stage thread 0 arrives without the weights' bytes
    "b_once": [(_LOAD_B, "      if (p == 0 && ks != 0) mbar_arrive(&full[s]);"
                         "\n      if (p == 0 && ks == 0) {\n"
                         "        mbar_expect_tx(&full[s], C::kBBytes);\n")],
    "no_math": [(_WGMMA, "      part[j] = __uint_as_float(a[j][0] ^ a[j][1] ^ "
                         "a[j][2] ^ a[j][3]);\n"),
                (_FMA, "for (int j = 0; j < 8; ++j) { if (j == 0) acc[i][j] "
                       "+= av; else if (i == 0) acc[i][j] += b[j]; }")],
    "no_promote": [(_WGMMA, "      wgmma_rs(acc, a[j], desc_sw128(bs + (g * "
                            "kSteps + j) * 32), 1);\n"),
                   (_ADD, "    for (int i = 0; i < 64; ++i) part[i] = "
                          "acc[i];\n")],
    "promote32": [(_PROMOTE, "constexpr int kPromote = 32;")],
}
REAL_DESIGNS = ("shipped", "no_promote", "promote32")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _argtypes(symbol: str, old: bool) -> list:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if not old:
        return _cuda._SIGNATURES[symbol]
    return {"gomel_dft_fwd": [i32, p, p, p, p, p, i32, i64, i64, i64, i64,
                              i64, i64, i64, i32, i32, i32],
            "gomel_dft_inv": [i32, i32, p, p, p, p, i64, i64, i64, i64, i64,
                              i64]}[symbol]


def build(work: str) -> dict[str, tuple[ctypes.CDLL, str]]:
    """One nvcc per variant and one for the earlier tile, all started
    together; returns the loaded libraries with ptxas's report of each."""
    with open(os.path.join(_cuda.CSRC_DIR, "dft_mm.cu")) as f:
        source = f.read()
    os.makedirs(work, exist_ok=True)
    texts = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in dft_mm.cu")
            text = text.replace(old, new)
        texts[name] = text
    with open(OLD_SRC) as f:
        texts["mma_sync"] = f.read()
    jobs = {}
    for name, text in texts.items():
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
            fn.argtypes = [*_argtypes(symbol, name == "mma_sync"),
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = (handle, report)
    return libs


def ptxas_lines(report: str) -> list[str]:
    """ptxas's register, spill and shared-memory lines of each kernel."""
    out, entry = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry and re.search(r"registers|spill|smem", line):
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return out


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(3):
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


def old_layout(direction: str, master: np.ndarray, n: int,
               bf16: bool, dev) -> torch.Tensor:
    """The earlier tile's weights: one row per output column, the
    contraction interleaved and padded to 32, columns to 128."""
    half = n // 2 + 1
    up = lambda v, m: -(-v // m) * m   # noqa: E731
    m32 = master.astype(np.float32)
    if direction == "fwd":
        w = np.zeros((up(2 * half, 128), up(n, 32)), np.float32)
        w[0:2 * half:2, :n] = m32[:, :half].T
        w[1:2 * half:2, :n] = m32[:, half:].T
    else:
        w = np.zeros((up(n, 128), up(2 * half, 32)), np.float32)
        w[:n, 0:2 * half:2] = m32[:half].T
        w[:n, 1:2 * half:2] = m32[half:].T
    t = torch.from_numpy(w)
    return (t.to(torch.bfloat16) if bf16 else t).to(dev)


class Operands:
    """The bench-shape operands and outputs of one run (n, hop, frames)."""

    def __init__(self, dev, n: int, hop: int, frames: int, seed: int):
        g = torch.Generator(device=dev).manual_seed(seed)
        self.n, self.hop, self.frames = n, hop, frames
        self.half = half = n // 2 + 1
        self.length = n + (frames - 1) * hop
        self.rows = rows = BATCH * frames
        self.x = torch.rand((BATCH, self.length), generator=g,
                            device=dev) - 0.5
        self.x_low = torch.empty((BATCH, -(-self.length // 8) * 8),
                                 dtype=torch.bfloat16, device=dev)
        self.mag = torch.rand((rows, half), generator=g, device=dev)
        self.win = hann_window(n)
        self.re32 = torch.randn((rows, half), generator=g, device=dev)
        self.im32 = torch.randn((rows, half), generator=g, device=dev)
        self.ld = -(-half // dft_mm.LOW_ALIGN) * dft_mm.LOW_ALIGN
        pad = [torch.zeros((rows, self.ld), dtype=torch.bfloat16, device=dev)
               for _ in range(2)]
        pad[0][:, :half] = self.re32.bfloat16()
        pad[1][:, :half] = self.im32.bfloat16()
        self.re16, self.im16 = pad
        self.out_f = [torch.empty((rows, half), device=dev) for _ in range(2)]
        self.out_b = [torch.empty((rows, self.ld), dtype=torch.bfloat16,
                                  device=dev) for _ in range(2)]
        self.frames_w = torch.empty((rows, n), device=dev)
        self.w = {(d, m): dft_mm._weights(d, n, self.win, m, dev)
                  for d in ("fwd", "inv") for m in ("bf16", "f32")}


def calls(lib, ops: Operands, dev, stream, old: bool = False,
          planes: bool = False):
    """{(kernel, mode): a launch} on ``lib``: KN bf16 the interior
    projection into bf16 planes (``planes``: float32 (re, im) planes), KN
    float32 (re, im) planes, KO bf16 from bf16 planes, KO float32 from
    float32 planes. ``old``: the earlier tile's signatures and layouts."""
    out = {}
    o = ops
    for mode in ("bf16", "f32"):
        bf16 = mode == "bf16"
        low = bf16 and not planes
        epilogue = 3 if low else 0
        outs = o.out_b if low else o.out_f
        if old:
            w = old_layout("fwd", dft_mm._master("fwd", o.n, o.win), o.n,
                           bf16, dev)
            out[("KN", mode)] = (lambda w=w, bf16=bf16, outs=outs,
                                 low=low, epilogue=epilogue:
                                 lib.gomel_dft_fwd(
                int(bf16), o.x.data_ptr(), w.data_ptr(), o.mag.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), int(low), BATCH,
                o.frames, o.length, o.hop, o.n, w.shape[1], w.shape[0],
                epilogue, 0, 0, dev.index, stream), w)
            wi = old_layout("inv", dft_mm._master("inv", o.n, o.win), o.n,
                            bf16, dev)
            re, im = ((o.re16[:, :o.half].contiguous(),
                       o.im16[:, :o.half].contiguous()) if bf16
                      else (o.re32, o.im32))
            out[("KO", mode)] = (lambda wi=wi, bf16=bf16, re=re, im=im:
                                 lib.gomel_dft_inv(
                int(bf16), int(bf16), re.data_ptr(), im.data_ptr(),
                wi.data_ptr(), o.frames_w.data_ptr(), o.rows, o.frames,
                o.frames, o.n, wi.shape[1], wi.shape[0], dev.index, stream),
                wi, re, im)
            continue
        kw = o.w[("fwd", mode)]
        out[("KN", mode)] = (lambda kw=kw, bf16=bf16, outs=outs, low=low,
                             epilogue=epilogue: lib.gomel_dft_fwd(
            int(bf16), o.x.data_ptr(),
            o.x_low.data_ptr() if bf16 else None, ctypes.addressof(kw.tmap),
            o.mag.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            int(low), o.ld, BATCH, o.frames, o.length, o.hop, o.n, kw.depth,
            kw.cols, epilogue, 0, 0, dev.index, stream),)
        ki = o.w[("inv", mode)]
        re, im, ld = ((o.re16, o.im16, o.ld) if bf16
                      else (o.re32, o.im32, o.half))
        out[("KO", mode)] = (lambda ki=ki, bf16=bf16, re=re, im=im, ld=ld:
                             lib.gomel_dft_inv(
            int(bf16), int(bf16), re.data_ptr(), im.data_ptr(), ld,
            ctypes.addressof(ki.tmap), o.frames_w.data_ptr(), o.rows,
            o.frames, o.frames, o.n, ki.depth, ki.cols, dev.index, stream),)
    return {k: v[0] for k, v in out.items()}, out


def accuracy(lib, ops: Operands, dev, stream) -> dict:
    """The bf16 mode's largest error over each frame's peak against the
    bf16-operand plain version: KN's (re, im) planes, KO's frames."""
    fns, keep = calls(lib, ops, dev, stream, planes=True)
    o = ops
    for key in (("KN", "bf16"), ("KO", "bf16")):
        if fns[key]() != 0:
            raise RuntimeError(f"{key}: launch failed")
    torch.cuda.synchronize()
    wr, wi = dft_mm.dft_fwd_plain(o.x, o.n, o.hop, o.win,
                                  bf16_operands=True)
    peak = torch.sqrt(wr * wr + wi * wi).amax(-1, keepdim=True).reshape(
        o.rows, 1).double()
    kn = max(float(((g.double() - w.reshape(o.rows, -1).double()).abs()
                    / peak).max())
             for g, w in zip(o.out_f, (wr, wi)))
    want = dft_mm.dft_inv_plain(o.re16[:, :o.half], o.im16[:, :o.half], o.n,
                                o.win, bf16_operands=True).double()
    ko = float(((o.frames_w.double() - want).abs()
                / want.abs().amax(-1, keepdim=True)).max())
    return {"KN": kn, "KO": ko}


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
    ptxas = {name: ptxas_lines(report) for name, (_, report) in libs.items()}
    for name in ("shipped", "mma_sync", "promote32", "no_promote"):
        for line in ptxas[name]:
            print(f"  ptxas, {name} {line}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ops = Operands(dev, N, HOP, FRAMES, 0)

    results, base = [], {}
    for variant, (lib, _) in libs.items():
        if variant == "mma_sync":
            continue
        fns, _keep = calls(lib, ops, dev, stream)
        for key, fn in fns.items():
            if fn() != 0:
                raise RuntimeError(f"{key} {variant}: launch failed")
            ms = cuda_ms(fn, args.iters)
            base.setdefault(key, ms)
            results.append(dict(kernel=key[0], mode=key[1], variant=variant,
                                ms=ms, share=ms / base[key]))
            print(f"  {key[0]} {key[1]} {variant}: {ms:.4f} ms "
                  f"({100 * ms / base[key]:.1f}% of shipped)", flush=True)

    # the race: the earlier tile against the shipped kernels, in turns
    race = []
    new, _keep_new = calls(libs["shipped"][0], ops, dev, stream)
    old, _keep_old = calls(libs["mma_sync"][0], ops, dev, stream, old=True)
    for key in new:
        if old[key]() != 0:
            raise RuntimeError(f"{key} mma_sync: launch failed")
        times = [cuda_ms(fn, args.iters) for fn in (old[key], new[key],
                                                    new[key], old[key])]
        race.append(dict(kernel=key[0], mode=key[1], mma_sync_ms=min(
            times[0], times[3]), shipped_ms=min(times[1], times[2])))
        print(f"  race {key[0]} {key[1]}: mma_sync tile "
              f"{race[-1]['mma_sync_ms']:.4f} ms, shipped "
              f"{race[-1]['shipped_ms']:.4f} ms", flush=True)

    # the bf16 mode's A routes on the shipped kernels: bf16 A (as shipped at
    # the bench shape) against float32 A rounded in registers
    lib = libs["shipped"][0]
    o = ops
    kw, ki = o.w[("fwd", "bf16")], o.w[("inv", "bf16")]

    def kn(x_low):
        return lambda: lib.gomel_dft_fwd(
            1, o.x.data_ptr(), x_low, ctypes.addressof(kw.tmap),
            o.mag.data_ptr(), o.out_b[0].data_ptr(), o.out_b[1].data_ptr(), 1,
            o.ld, BATCH, o.frames, o.length, o.hop, o.n, kw.depth, kw.cols, 3,
            0, 0, dev.index, stream)

    def ko(re, im, ld, planes_bf16):
        return lambda: lib.gomel_dft_inv(
            1, planes_bf16, re.data_ptr(), im.data_ptr(), ld,
            ctypes.addressof(ki.tmap), o.frames_w.data_ptr(), o.rows,
            o.frames, o.frames, o.n, ki.depth, ki.cols, dev.index, stream)
    routes = {}
    for label, fn in (
            ("KN bf16 A (signal copy)", kn(o.x_low.data_ptr())),
            ("KN float32 A", kn(None)),
            ("KO bf16 planes", ko(o.re16, o.im16, o.ld, 1)),
            ("KO float32 planes", ko(o.re32, o.im32, o.half, 0))):
        if fn() != 0:
            raise RuntimeError(f"{label}: launch failed")
        routes[label] = ms = cuda_ms(fn, args.iters)
        print(f"  bf16 mode, {label}: {ms:.4f} ms", flush=True)

    # torch.matmul on the same operands, as they are and padded to aligned
    # widths (4224 forward columns; a contraction of 4128)
    rows, half = ops.rows, ops.half
    frames = (frame_signal(ops.x, N, HOP) * torch.from_numpy(
        ops.win.astype(np.float32)).to(dev)).reshape(rows, N)
    wf = dft_mm._weights("fwd", N, ops.win, torch.float32, dev)
    wi = dft_mm._weights("inv", N, ops.win, torch.float32, dev)
    z = torch.cat([ops.re32, ops.im32], -1)
    wf_a = torch.zeros((N, 4224), device=dev)
    wf_a[:, :2 * half] = wf
    z_a = torch.zeros((rows, 4128), device=dev)
    z_a[:, :2 * half] = z
    wi_a = torch.zeros((4128, N), device=dev)
    wi_a[:2 * half] = wi
    library = {}
    for label, a, b in (("KN", frames, wf), ("KN aligned", frames, wf_a),
                        ("KO", z, wi), ("KO aligned", z_a, wi_a)):
        for mode in ("bf16", "f32"):
            aa, bb = ((a.bfloat16(), b.bfloat16()) if mode == "bf16"
                      else (a, b))
            library[f"{label} {mode}"] = ms = cuda_ms(
                lambda aa=aa, bb=bb: torch.matmul(aa, bb), args.iters)
            print(f"  torch.matmul {label} {mode} {tuple(aa.shape)} x "
                  f"{tuple(bb.shape)}: {ms:.4f} ms", flush=True)

    # the promotion depth: each real design's bf16 error at n = 4096, 8192
    acc = {}
    big = Operands(dev, 8192, 2048, 300, 1)
    for variant in REAL_DESIGNS:
        lib = libs[variant][0]
        acc[variant] = {n: accuracy(lib, o, dev, stream)
                        for n, o in ((N, ops), (8192, big))}
        print(f"  bf16 error, {variant}: " + "; ".join(
            f"n {n}: KN {e['KN']:.3e}, KO {e['KO']:.3e}"
            for n, e in acc[variant].items()) +
            " of the frame peak vs the bf16-operand plain version "
            "(bound 2e-5)", flush=True)
    flops = 2.0 * rows * N * 2 * half
    print(f"  work: {flops / 1e9:.1f} GFLOP a product; rows {rows}, n {N}")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile_dft_mm.json"),
              "w") as f:
        json.dump({"card": card, "ptxas": ptxas, "results": results,
                   "race": race, "a_routes_ms": routes,
                   "library_ms": library,
                   "bf16_error": {v: {str(n): e for n, e in d.items()}
                                  for v, d in acc.items()}}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
