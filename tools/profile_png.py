"""The PNG codec's host time with the native scanline filter
(gomel_tpu_torch/native/pngfilter.cpp) against its numpy path, on the
long-form PNGs of chip_smoke.py phase 3e.

    python3 tools/profile_png.py [--rounds 2]

Needs one NVIDIA GPU. Makes the seeded 30-minute 48 kHz WAV of phase 3e
(chip_smoke.long_pcm), writes its phase and mel PNGs with LongFormPhase and
LongFormMel (device quantize, four frame shards of the card), then times on
this host, in turns (numpy, native, native, numpy, ``--rounds`` times):

  read     io/pngcodec.read_png of each PNG (inflate + unfilter)
  step     imagecodec.load_phase_image_raw / load_mel_image_raw: the
           "PNG read" step of phase 3e's split (read_png + the planes and
           metadata)
  write    io/pngcodec.write_png of each PNG's image (Up filter + deflate)

The numpy path is the parent commit's codec (the same bytes and arrays:
both are held equal before timing), so the pair is the PR's effect on one
host, which the runs of phase 3e on different hosts cannot show. Each
number is host-clock ms of one call; the line gives the median of each
path and every run. Prints the card's name and power limit; the same
numbers go to chiprun_out/profile_png.json. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402
from gomel_tpu_torch import (LongFormMel, LongFormPhase, MelConfig,  # noqa: E402
                             PhaseConfig, make_mesh)
from gomel_tpu_torch.io import _native, imagecodec, pngcodec, wavcodec  # noqa: E402
from tools.png_filters import numpy_path  # noqa: E402


def one_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def pair(fn, rounds: int) -> dict:
    """Host ms of ``fn`` on the numpy path and the native path, in turns
    numpy, native, native, numpy, ``rounds`` times."""
    runs = {"numpy": [], "native": []}
    for _ in range(rounds):
        for path in ("numpy", "native", "native", "numpy"):
            runs[path].append(one_ms(numpy_path(fn) if path == "numpy"
                                     else fn))
    return {"numpy_ms": float(np.median(runs["numpy"])),
            "native_ms": float(np.median(runs["native"])), "runs": runs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_png: no CUDA device", file=sys.stderr)
        return 2
    if _native.get_lib() is None:
        print("profile_png: the native PNG filter did not build",
              file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        n = int(chip_smoke.SAMPLE_RATE * chip_smoke.LONG_SECONDS)
        wav = os.path.join(tmp, "long.wav")
        wavcodec.write_wav(wav, chip_smoke.long_pcm(n, dev),
                           chip_smoke.SAMPLE_RATE)
        mesh = make_mesh(data=1, frame=chip_smoke.N_SHARDS,
                         devices=[dev] * chip_smoke.N_SHARDS)
        pngs = {"phase": os.path.join(tmp, "p.png"),
                "mel": os.path.join(tmp, "m.png")}
        LongFormPhase(PhaseConfig.cli_default(), mesh,
                      device_quantize=True).to_phase_wav(wav, pngs["phase"])
        LongFormMel(MelConfig.cli_default(), mesh,
                    device_quantize=True).to_mel_wav(wav, pngs["mel"])
        steps = {"phase": lambda p: imagecodec.load_phase_image_raw(p, True),
                 "mel": lambda p: imagecodec.load_mel_image_raw(p, True)}
        for kind, png in pngs.items():
            img = pngcodec.read_png(png)
            if not np.array_equal(numpy_path(lambda: pngcodec.read_png(png))(),
                                  img):
                raise AssertionError(f"{kind}: read_png paths differ")
            out = os.path.join(tmp, f"{kind}_w.png")
            pngcodec.write_png(out, img)
            with open(out, "rb") as f:
                native_bytes = f.read()
            numpy_path(lambda: pngcodec.write_png(out, img))()
            with open(out, "rb") as f:
                if native_bytes != f.read():
                    raise AssertionError(f"{kind}: write_png paths differ")
            row = {"shape": list(img.shape), "dtype": str(img.dtype),
                   "png_mb": os.path.getsize(png) / 1e6}
            row["read"] = pair(lambda: pngcodec.read_png(png), args.rounds)
            row["step"] = pair(lambda: steps[kind](png), args.rounds)
            row["write"] = pair(lambda: pngcodec.write_png(out, img),
                                args.rounds)
            results[kind] = row
            for what in ("read", "step", "write"):
                r = row[what]
                print(f"{kind} PNG {tuple(img.shape)} {img.dtype} "
                      f"({row['png_mb']:.2f} MB), {what}: native "
                      f"{r['native_ms']:.3f} ms, numpy {r['numpy_ms']:.3f} ms "
                      f"(native / numpy {r['native_ms'] / r['numpy_ms']:.3f}); "
                      f"runs native {[round(v, 3) for v in r['runs']['native']]}"
                      f", numpy {[round(v, 3) for v in r['runs']['numpy']]}",
                      flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile_png.json"), "w") as f:
        json.dump({"card": card, "results": results}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
