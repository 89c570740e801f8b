"""The forward FFT kernels KB and KE: the register-resident core against the
radix-2 form it replaced, and where the core spends its time, by ablation.

    python3 tools/profile_fft.py [--iters 20]

Needs one NVIDIA GPU and nvcc. Builds gomel_tpu_torch/csrc/rfft_mag.cu and
phase_encode.cu (with fft_core.cuh) as shipped, plus one entry point each
that launches the earlier radix-2 Stockham form still in those files
(stft_mag_kernel<true>, stft_planes_kernel<true>: log2(n/2) passes through
two shared buffers, one barrier each, one block a frame), and in variants
that each take work out of the register core. Then, on one card and in
turns (radix-2, core, core, radix-2), times both forms of KB (magnitudes)
and KE (bins 1..1536 as (im, re)) at the bench shape of chip_smoke.py (2 x
1122 frames of 4096, hop 1280, Hann) and at one shard of its 30-minute
long-form file (1 x 16,875 frames), beside ``torch.fft.rfft`` of the same
frames laid out in memory and the byte bound (the signal, window and output
each moved once at 3.35 TB/s). The variants' outputs are wrong by
construction, only their times mean anything:

  shipped         the kernels as the port builds them
  load_only       the first pass's loads and shared-memory writes (no DFT),
                  no later pass, the epilogue's arithmetic but no store
  transform_only  no device-memory reads (registers from the thread index),
                  every pass and the epilogue's arithmetic, no store
  store_only      no loads, DFTs or later passes: the first pass writes
                  index values, the epilogue reads, splits and stores
  no_passes       everything but the passes after the first
  min_blocks_8    __launch_bounds__ asking for 8 blocks an SM (64 registers)
  points_8        8 complex points a thread: radices 4, 8, 8, 8 at n = 4096,
                  256 threads a frame (its own plan and twiddle table)
  signal_ldcs     the signal loaded with the streaming cache hint (__ldcs)

Prints the card's name and power limit, ptxas's registers, shared memory
and spills of each kernel, and one line per measurement: device ms per call
(CUDA events over calls queued behind a sleep kernel, chip_smoke.cuda_ms,
lower of two runs). The same numbers go to chiprun_out/profile_fft.json.
Imports nothing of JAX.
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
SOURCES = ("fft_core.cuh", "rfft_mag.cu", "phase_encode.cu")

# the earlier radix-2 form, launched from an entry point added to each file
_RADIX2 = {
    "rfft_mag.cu": """
GOMEL_API int prof_radix2_stft_mag(const void* x, const void* window,
    const void* tw, void* out, long long batch, long long frames,
    long long batch_stride, long long hop, long long n, int device,
    void* stream) {
  cudaSetDevice(device);
  const int m = static_cast<int>(n / 2);
  launch_frames(stft_mag_kernel<true>, batch * frames, m,
                2 * static_cast<size_t>(m) * sizeof(float2),
                static_cast<cudaStream_t>(stream),
                static_cast<const float*>(x), static_cast<const float*>(window),
                static_cast<const float2*>(tw), static_cast<float*>(out),
                static_cast<int>(frames), batch_stride, hop, m);
  return gomel_status();
}
""",
    "phase_encode.cu": """
GOMEL_API int prof_radix2_stft_planes(const void* x, const void* window,
    const void* tw, void* out, long long batch, long long frames,
    long long batch_stride, long long hop, long long n, int first, int count,
    int device, void* stream) {
  cudaSetDevice(device);
  const int m = static_cast<int>(n / 2);
  launch_frames(stft_planes_kernel<true>, batch * frames, m,
                2 * static_cast<size_t>(m) * sizeof(float2),
                static_cast<cudaStream_t>(stream),
                static_cast<const float*>(x), static_cast<const float*>(window),
                static_cast<const float2*>(tw), static_cast<float2*>(out),
                static_cast<int>(frames), batch_stride, hop, m, first, count);
  return gomel_status();
}
""",
}

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
     "    dst[k] = sqrtf(a.x * a.x + a.y * a.y);\n"
     "    if (2 * k != m) dst[m - k] = sqrtf(b.x * b.x + b.y * b.y);",
     "    const float g = sqrtf(a.x * a.x + a.y * a.y) +\n"
     "                    sqrtf(b.x * b.x + b.y * b.y);\n"
     "    if (__float_as_uint(g) == 0xdeadbeefu) dst[k] = g;"),
    ("phase_encode.cu",
     "    if (k >= first && k <= last) dst[k - first] = make_float2(a.y, a.x);\n"
     "    if (2 * k != m && m - k >= first && m - k <= last) {\n"
     "      dst[m - k - first] = make_float2(b.y, b.x);\n"
     "    }",
     "    if (__float_as_uint(a.x + b.x) == 0xdeadbeefu) dst[k - first] = a;"),
]


def _min_blocks(n: int) -> list[tuple[str, str, str]]:
    """__launch_bounds__ asking for n blocks an SM (a register cap)."""
    old = "FwdPlan<kLogM>::frames_per_block)"
    return [(f, old, old[:-1] + f", {n})")
            for f in ("rfft_mag.cu", "phase_encode.cu")]


_P8 = ("fft_core.cuh", "constexpr int kRegPoints = 16;",
       "constexpr int kRegPoints = 8;")
# name -> (complex points a thread, edits)
VARIANTS = {
    "shipped": (16, []),
    "load_only": (16, [_NO_DFT1, _NO_PASSES, *_NO_STORE]),
    "transform_only": (16, [_NO_LOAD, *_NO_STORE]),
    "store_only": (16, [_NO_LOAD, _NO_DFT1, _NO_PASSES]),
    "no_passes": (16, [_NO_PASSES]),
    "min_blocks_8": (16, _min_blocks(8)),
    "points_8": (8, [_P8]),
    "signal_ldcs": (16, [("fft_core.cuh",
                          "x = __ldg(reinterpret_cast<const float4*>(src + off));",
                          "x = __ldcs(reinterpret_cast<const float4*>(src + off));")]),
}


def build(work: str) -> dict[str, tuple[ctypes.CDLL, str]]:
    """One nvcc per variant (both kernels' sources into one library), all
    started together; returns the loaded libraries with ptxas's report."""
    texts = {}
    for name in SOURCES:
        with open(os.path.join(_cuda.CSRC_DIR, name)) as f:
            texts[name] = f.read()
    jobs = {}
    for variant, (_, edits) in VARIANTS.items():
        d = os.path.join(work, variant)
        os.makedirs(d, exist_ok=True)
        files = dict(texts)
        for name, old, new in edits:
            if files[name].count(old) != 1:
                raise RuntimeError(f"variant {variant}: {old!r} is not in "
                                   f"{name} exactly once")
            files[name] = files[name].replace(old, new)
        for name, extra in _RADIX2.items():
            files[name] += extra
        for name, text in files.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        lib = os.path.join(d, "lib.so")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I",
               _cuda.CSRC_DIR, "-o", lib, os.path.join(d, "rfft_mag.cu"),
               os.path.join(d, "phase_encode.cu")]
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
        for symbol in ("gomel_stft_mag", "gomel_stft_planes"):
            fn = getattr(handle, symbol)
            fn.argtypes = [*_cuda._SIGNATURES[symbol], ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        handle.prof_radix2_stft_mag.argtypes = [p, p, p, p, i64, i64, i64,
                                                i64, i64, i32, p]
        handle.prof_radix2_stft_planes.argtypes = [p, p, p, p, i64, i64, i64,
                                                   i64, i64, i32, i32, i32, p]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
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
        print(f"  ptxas {line}")
    for variant, (_, report) in libs.items():
        if variant != "shipped":
            for line in ptxas_lines(report):
                if "pow2" in line and f"ILi{N.bit_length() - 2}E" in line:
                    print(f"  ptxas, {variant}: {line.split(': ', 1)[1]}")
    plan = rfft_mag.fwd_plan(N)
    print(f"  plan n {N}: radices {plan.radices}, {plan.threads} threads a "
          f"frame, {plan.frames_per_block} frames a block, "
          f"{plan.smem_bytes} bytes of shared memory a block")
    win = torch.tensor(hann_window(N), dtype=torch.float32, device=dev)
    tw = rfft_mag._twiddles(N, dev)
    plans = {}
    for points in {p for p, _ in VARIANTS.values()}:
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

    for shape, (batch, frames) in SHAPES.items():
        length = N + (frames - 1) * HOP
        x = torch.rand((batch, length), generator=g, device=dev) - 0.5
        mag = torch.empty((batch, frames, N // 2 + 1), device=dev)
        pairs = torch.empty((batch, frames, NF, 2), device=dev)
        common = (batch, frames, length, HOP, N)

        def core(lib, kind, points=16):
            table, code, threads, per_block = plans[points]
            tw_pass = table.data_ptr()
            if kind == "KB":
                return lambda: lib.gomel_stft_mag(
                    x.data_ptr(), win.data_ptr(), tw.data_ptr(), tw_pass,
                    mag.data_ptr(), *common, code, threads, per_block,
                    dev.index, stream)
            return lambda: lib.gomel_stft_planes(
                x.data_ptr(), win.data_ptr(), tw.data_ptr(), tw_pass,
                pairs.data_ptr(), *common, 1, NF, code, threads, per_block,
                dev.index, stream)

        def radix2(lib, kind):
            if kind == "KB":
                return lambda: lib.prof_radix2_stft_mag(
                    x.data_ptr(), win.data_ptr(), tw.data_ptr(),
                    mag.data_ptr(), *common, dev.index, stream)
            return lambda: lib.prof_radix2_stft_planes(
                x.data_ptr(), win.data_ptr(), tw.data_ptr(),
                pairs.data_ptr(), *common, 1, NF, dev.index, stream)

        shipped = libs["shipped"][0]
        framed = (frame_signal(x, N, HOP) * win).contiguous()
        lib_ms = min(chip_smoke.cuda_ms(lambda: torch.fft.rfft(framed, dim=-1),
                                        args.iters) for _ in range(2))
        for kind, out in (("KB", mag), ("KE", pairs)):
            new_fn, old_fn = core(shipped, kind), radix2(shipped, kind)
            for fn in (new_fn, old_fn):
                if fn() != 0:
                    raise RuntimeError(f"{kind} {shape}: launch failed")
            torch.cuda.synchronize()
            new_out = out.clone()
            old_fn()
            torch.cuda.synchronize()
            peak = out.abs().amax(dim=tuple(range(2, out.dim())), keepdim=True)
            rel = float(((new_out - out).abs() / peak).max())
            if rel > 1e-5:
                raise AssertionError(f"{kind} {shape}: core against radix-2 "
                                     f"{rel:.3e} of the frame peak")
            new_ms, old_ms = chip_smoke.race(new_fn, old_fn, kind, args.iters)
            b_ms = chip_smoke.bound(chip_smoke.nbytes(x, win, out), 0.0)[0]
            record(kernel=kind, shape=shape, frames=batch * frames,
                   core_ms=new_ms, radix2_ms=old_ms, speedup=old_ms / new_ms,
                   bound_ms=b_ms, bound_share=b_ms / new_ms,
                   rfft_ms=lib_ms, core_vs_rfft=new_ms / lib_ms,
                   core_vs_radix2_rel_err=rel)
            if shape != "bench":
                continue
            base = new_ms
            for variant, (lib, _) in libs.items():
                if variant == "shipped":
                    continue
                fn = core(lib, kind, VARIANTS[variant][0])
                if fn() != 0:
                    raise RuntimeError(f"{kind} {variant}: launch failed")
                ms = min(chip_smoke.cuda_ms(fn, args.iters) for _ in range(2))
                record(kernel=kind, shape=shape, variant=variant, ms=ms,
                       share_of_shipped=ms / base)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile_fft.json"), "w") as f:
        json.dump({"card": card, "ptxas": ptxas, "plan": plan._asdict(),
                   "results": results}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
