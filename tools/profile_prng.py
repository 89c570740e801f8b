"""KP (the Griffin-Lim start's Threefry-2x32 draw) against the form it
replaced, and where its time goes, by ablation.

    python3 tools/profile_prng.py [--iters 20]

Needs one NVIDIA GPU and nvcc. Builds gomel_tpu_torch/csrc/threefry.cu as
shipped, tools/threefry_earlier.cu (KP as it shipped before its redesign),
and once more for each ablation, with that ablation's edits of the source
(VARIANTS):

  samples_1/2/8   a thread draws 1, 2 or 8 consecutive samples at once
                  (shipped: 4; 1 is one 4-byte store a sample, 2 one 8-byte)
  wide            each rotation the OR of the 64-bit product x * 2^r's words
                  (IMAD.WIDE.U32 on the FMA pipe; the multipliers from
                  __constant__ memory, so the compiler cannot turn the
                  product back into shifts), not a funnel shift (SHF, the
                  integer pipe): one integer-pipe instruction a round, not 2
  imad_hi         each rotation __umulhi(x, 2^r) + x * 2^r (IMAD.HI and
                  IMAD, the FMA pipe), the xor the one integer-pipe
                  instruction of the round
  int_adds        the key injections as x + k (IADD3 on the integer pipe),
                  not x * one + k with a 1 passed at launch (IMAD on the FMA
                  pipe), and the exponent ORed into the shifted bits, not
                  added
  even_split      a grid of as few trips as the resident blocks allow with
                  the groups split evenly over them (fewer blocks than the
                  card holds), not the resident blocks
  one_trip        a grid of every group in one trip (waves of blocks)

Then, on one card and in turns (old, new, new, old; chip_smoke.race):

  KP bench       one key, [2, 1438976] (the bench's GL start)
  KP rows        two row keys x [1438976] (the batch decode's starts)
  KP one shard   one folded key, [1, 21600000] (a shard of the 30-minute
                 mel decode)
  KP 3 x 1001    three row keys x 1001 samples (rows off 16 bytes, a tail)

each as new, old and every variant, all held bit-equal to the plain version
(ops/prng.uniform_plain) first, with the bound (the larger of the bytes
written at 3.35 TB/s and 75 integer instructions a sample at the card's
dispatch rate, chip_smoke.THREEFRY_OPS / INSTR_RATE_S) and share of it,
and torch.rand of the same shape on a CUDA generator (other bits: Philox,
not Threefry; a yardstick). Prints the card's name and power limit,
ptxas's registers, the occupancy query's blocks an SM and each build's SASS
opcode counts by pipe (tools/sass_opcodes.py), and one line per
measurement: device ms per call (CUDA events over calls queued behind a
sleep kernel, chip_smoke.cuda_ms, lower of two runs). The same numbers go
to chiprun_out/profile_prng.json. Imports nothing of JAX.
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

from gomel_tpu_torch.ops import _cuda, prng  # noqa: E402

SOURCE = os.path.join(_cuda.CSRC_DIR, "threefry.cu")
OLD = os.path.join(HERE, "tools", "threefry_earlier.cu")

_FUNNEL = ("    x1[u] = __funnelshift_l(x1[u], x1[u], rotate_amount(i)) ^ "
           "x0[u];\n")
_ROUND = "// Round i % 4 of a block of four rounds"
_MUL = ("__constant__ uint32_t kMul[8] = {1u << 13, 1u << 15, 1u << 26, "
        "1u << 6,\n                                1u << 17, 1u << 29, "
        "1u << 16, 1u << 24};\n\n")
_GRID = ("  long long bx = resident / by;\n"
         "  if (bx > one_trip) bx = one_trip;\n")


def _samples(n: int):
    return [("constexpr int kSamples = 4;", f"constexpr int kSamples = {n};")]


# name -> the edits (old text, new text) of threefry.cu
VARIANTS = {
    "shipped": [],
    "samples_1": _samples(1),
    "samples_2": _samples(2),
    "samples_8": _samples(8),
    "wide": [(_ROUND, _MUL + _ROUND),
             (_FUNNEL, "    const uint64_t p = static_cast<uint64_t>(x1[u]) "
                       "* kMul[i];\n    x1[u] = (static_cast<uint32_t>(p) | "
                       "static_cast<uint32_t>(p >> 32)) ^ x0[u];\n")],
    "imad_hi": [(_ROUND, _MUL + _ROUND),
                (_FUNNEL, "    x1[u] = (__umulhi(x1[u], kMul[i]) + x1[u] * "
                          "kMul[i]) ^ x0[u];\n")],
    "int_adds": [("    x0[u] = x0[u] * one + a;\n"
                  "    x1[u] = x1[u] * one + b;\n",
                  "    x0[u] += a;\n    x1[u] += b;\n"),
                 ("(bits >> 9) + 0x3F800000u", "(bits >> 9) | 0x3F800000u")],
    "even_split": [(_GRID, "  long long cap = resident / by;\n"
                           "  if (cap < 1) cap = 1;\n"
                           "  const long long trips = (one_trip + cap - 1) / "
                           "cap;\n"
                           "  long long bx = trips > 0 ? (one_trip + trips - 1)"
                           " / trips : 1;\n")],
    "one_trip": [(_GRID, "  long long bx = one_trip;\n")],
}

# appended to each build: blocks an SM of the kernel at 256 threads
_OCCUPANCY = """
GOMEL_API int prof_occupancy_prng(int* out) {
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], threefry_uniform_kernel, 256, 0);
  return gomel_status();
}
"""


def _bind(handle: ctypes.CDLL, symbol: str) -> None:
    fn = getattr(handle, symbol)
    fn.argtypes = [*_cuda._SIGNATURES["gomel_threefry_uniform"], ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int


def build(work: str) -> dict[str, tuple[ctypes.CDLL, str, str]]:
    """One nvcc per variant and one for the earlier form, all started
    together; returns {name: (library, ptxas report, library path)}."""
    with open(SOURCE) as f:
        text = f.read()
    jobs = {}
    for variant, edits in VARIANTS.items():
        d = os.path.join(work, variant)
        os.makedirs(d, exist_ok=True)
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {variant}: {old!r} is not in "
                                   f"threefry.cu exactly once")
            src = src.replace(old, new)
        unit = os.path.join(d, "threefry.cu")
        with open(unit, "w") as f:
            f.write(src + _OCCUPANCY)
        jobs[variant] = unit
    jobs["earlier"] = OLD
    procs = {}
    for variant, unit in jobs.items():
        d = os.path.join(work, variant)
        os.makedirs(d, exist_ok=True)
        lib = os.path.join(d, "lib.so")
        log = open(os.path.join(d, "build.log"), "w")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I",
               _cuda.CSRC_DIR, "-o", lib, unit]
        procs[variant] = (subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT), lib, log)
    libs = {}
    for variant, (proc, lib, log) in procs.items():
        proc.wait()
        log.close()
        with open(log.name) as f:
            report = f.read()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{report}")
        handle = ctypes.CDLL(lib)
        if variant == "earlier":
            _bind(handle, "prof_old_threefry_uniform")
        else:
            _bind(handle, "gomel_threefry_uniform")
            handle.prof_occupancy_prng.argtypes = [ctypes.c_void_p]
        libs[variant] = (handle, report, lib)
    return libs


def main(argv=None) -> int:
    import chip_smoke
    from tools.profile_fft import ptxas_lines
    from tools.sass_opcodes import binary_opcodes, pipes

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_prng: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = build(os.path.join(_cuda.BUILD_DIR, "profile_prng"))
    ptxas, sass, occupancy = {}, {}, {}
    for variant, (handle, report, path) in libs.items():
        ptxas[variant] = [line for line in ptxas_lines(report)
                          if "threefry" in line]
        kernels = {k: dict(v) for k, v in binary_opcodes(path).items()
                   if "threefry" in k}
        sass[variant] = {k: {"total": sum(v.values()),
                             "pipes": pipes(v), "opcodes": v}
                         for k, v in kernels.items()}
        for line in ptxas[variant]:
            print(f"  ptxas, {variant}: {line}")
        for k, v in sass[variant].items():
            print(f"  SASS, {variant}: {v['total']} instructions, by pipe "
                  f"{v['pipes']}; IMAD.WIDE.U32 "
                  f"{v['opcodes'].get('IMAD.WIDE.U32', 0)}, SHF "
                  f"{sum(n for o, n in v['opcodes'].items() if o.startswith('SHF'))}"
                  f", LOP3 {v['opcodes'].get('LOP3.LUT', 0)}, IADD3 "
                  f"{v['opcodes'].get('IADD3', 0)}, IMAD.IADD "
                  f"{v['opcodes'].get('IMAD.IADD', 0)}, VIADD "
                  f"{v['opcodes'].get('VIADD', 0)}", flush=True)
        if variant != "earlier":
            out = (ctypes.c_int * 1)()
            if handle.prof_occupancy_prng(out) != 0:
                raise RuntimeError("occupancy query failed")
            occupancy[variant] = out[0]
    print(f"  occupancy query, blocks an SM: {occupancy}", flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = []

    def record(**row):
        results.append(row)
        print("  " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                               else f"{k} {v}" for k, v in row.items()),
              flush=True)

    one = prng.key(chip_smoke.SEED)
    gl_len = 1438976
    cases = {
        "KP bench": (one, (2, gl_len)),
        "KP rows": (prng.split_rows(one, 2), (gl_len,)),
        "KP one shard": (prng.fold_in(one, 3), (1, 21600000)),
        "KP 3 x 1001": (prng.split_rows(one, 3), (1001,)),
    }
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    for label, (keys, shape) in cases.items():
        want = prng.uniform_plain(keys, shape, torch.float32, dev)
        table = np.asarray(keys).reshape(-1, 2)
        rows = table.shape[0]
        per_key = want.numel() // rows
        kt = prng._device_keys(table, dev)
        outs = {}

        def make(variant):
            handle = libs[variant][0]
            fn = (handle.prof_old_threefry_uniform if variant == "earlier"
                  else handle.gomel_threefry_uniform)
            out = torch.empty_like(want)
            outs[variant] = out
            return lambda: fn(kt.data_ptr(), out.data_ptr(), rows, per_key,
                              dev.index, stream)
        fns = {v: make(v) for v in libs}
        for v, fn in fns.items():
            if fn() != 0:
                raise RuntimeError(f"{label}: {v} failed to launch")
        torch.cuda.synchronize()
        for v, out in outs.items():
            if not torch.equal(out, want):
                raise AssertionError(f"{label}: {v} differs from the plain "
                                     f"version")
        samples = float(want.numel())
        b_ms, b_by = chip_smoke.bound(4.0 * samples + 8.0 * rows,
                                      chip_smoke.THREEFRY_OPS * samples,
                                      chip_smoke.INSTR_RATE_S)
        new_ms, old_ms = chip_smoke.race(fns["shipped"], fns["earlier"],
                                         label, args.iters)
        record(case=label, new_ms=new_ms, old_ms=old_ms,
               speedup=old_ms / new_ms, bound_ms=b_ms, bound_by=b_by,
               bound_share=b_ms / new_ms, bit_equal=True)
        rand_ms = min(chip_smoke.cuda_ms(
            lambda: torch.rand(want.shape, generator=g, device=dev),
            args.iters) for _ in range(2))
        record(case=label, variant="torch.rand (Philox, other bits)",
               ms=rand_ms, bound_share=b_ms / rand_ms)
        for v, fn in fns.items():
            if v in ("shipped", "earlier"):
                continue
            if fn() != 0:
                raise RuntimeError(f"{label}: {v} failed to launch")
            ms = min(chip_smoke.cuda_ms(fn, args.iters) for _ in range(2))
            record(case=label, variant=v, ms=ms, share_of_new=ms / new_ms,
                   share_of_old=ms / old_ms, bound_share=b_ms / ms)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile_prng.json"),
              "w") as f:
        json.dump({"card": card, "ptxas": ptxas, "sass": sass,
                   "occupancy": occupancy, "results": results}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
