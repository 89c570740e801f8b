"""Batched mel decode with fast Griffin-Lim, the device steps of
``batch-towav`` on PNG planes already on the card:
``BatchedMel(config, gl_momentum=m).decode_quantized(planes, maxs, mins,
seed, pcm16=True)`` -> int16 samples [B, out_len] and per-row finite flags
on the card (kernel KI, the start's KP, then KJ + KK each iteration, the
last KK with the PCM-16 epilogue). The extrema stay host arrays, as the PNG
header carries them.

Traffic keys: ``rows``, ``clip_s``, ``pool``, ``in_flight``,
``check.sample_calls`` as in entries/mel_encode.py. The planes and their
extrema are made in set-up by the reference encoder and quantizer (float64)
from the seeded audio. Every call decodes with one Griffin-Lim seed, as
``batch-towav --seed`` does; the configuration's ``gl_momentum`` is the
momentum.
"""
from __future__ import annotations

import math

import torch

from portbench.harness import loop, signals
from portbench.reference import codecs, compare, dsp, fastgl, threefry

# rows of a reference block (the float64 frames of 16 rows of 10 s: 195 MB)
BLOCK_ROWS = 16


class Entry:
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        from gomel_tpu_torch.core.config import MelConfig
        from gomel_tpu_torch.parallel.batch import BatchedMel
        self.cfg, self.device = cfg["codec"], device
        self.momentum = cfg["gl_momentum"]
        self.codec = BatchedMel(MelConfig(**self.cfg),
                                gl_momentum=self.momentum, device=device)
        sr, n_fft, hop = (cfg["sample_rate_hz"], self.cfg["resolut"],
                          self.cfg["window"])
        rows, n = traffic["rows"], round(traffic["clip_s"] * sr)
        length = dsp.pad_length(n, hop)
        frames = dsp.num_frames(length, n_fft, hop)
        gen = signals.generator(seed, device)
        self.pool = []
        for _ in range(traffic["pool"]):
            x = torch.nn.functional.pad(
                signals.audio(gen, rows, n, sr, device), (0, length - n))
            parts = [codecs.mel_quantize(codecs.mel_encode(
                x[r0:r0 + BLOCK_ROWS], self.cfg))
                for r0 in range(0, rows, BLOCK_ROWS)]
            planes = torch.cat([p for p, _, _ in parts]).contiguous()
            mx = torch.cat([m for _, m, _ in parts]).float().cpu().numpy()
            mn = torch.cat([m for _, _, m in parts]).float().cpu().numpy()
            self.pool.append((planes, mx, mn))
            del x, parts
        self.gl_seed = seed % (1 << 31)
        self.keys = threefry.row_keys(self.gl_seed, rows)
        self.audio_s = rows * n / sr
        self.shape = {"rows": rows, "frames": frames,
                      "out_len": dsp.out_length(frames, n_fft, hop),
                      "iterations": self.cfg["griffin_lim_iterations"],
                      "out_bytes": 2}

    def warm(self) -> None:
        for k in range(len(self.pool)):
            self.submit(k, loop.Spans())

    def submit(self, i: int, span) -> loop.Call:
        k = i % len(self.pool)
        planes, mx, mn = self.pool[k]
        pcm, fin = self.codec.decode_quantized(planes, mx, mn, self.gl_seed,
                                               pcm16=True)
        return loop.Call(self.audio_s, self.shape, (k, pcm, fin), flags=fin)

    def release(self) -> None:
        self.codec = None

    def _reference(self, k: int, rows: slice, precision: str):
        planes, mx, mn = self.pool[k]
        return fastgl.mel_decode(planes[rows], mx[rows], mn[rows],
                                 self.keys[rows], self.cfg, self.momentum,
                                 precision)

    def _blocks(self):
        return [slice(r0, r0 + BLOCK_ROWS)
                for r0 in range(0, self.shape["rows"], BLOCK_ROWS)]

    def control(self, call: loop.Call) -> loop.Call:
        """The call with the bf16 reference in the program's place."""
        k = call.outputs[0]
        parts = [self._reference(k, rows, "bf16") for rows in self._blocks()]
        pcm = torch.cat([p for _, p, _ in parts])
        fin = torch.cat([f for _, _, f in parts])
        return loop.Call(call.audio_s, call.shape, (k, pcm, fin), flags=fin)

    def check(self, calls: list[loop.Call]) -> dict[str, float]:
        """Each call's PCM-16 against the exact values of the float64
        reference from the same planes, extrema and row keys: the RMS gap
        over the reference's RMS, over all its rows (the worst call), and
        the rows the program flags non-finite."""
        rms = 0.0
        bad = 0
        for call in calls:
            k, pcm, fin = call.outputs
            bad += int((~fin.bool()).sum())
            gap_sq = ref_sq = 0.0
            for rows in self._blocks():
                sig, _, _ = self._reference(k, rows, "f64")
                exact = torch.clip(sig * 32768.0, -32768.0, 32767.0)
                gap_sq += float((pcm[rows].double() - exact).pow(2).sum())
                ref_sq += float(exact.pow(2).sum())
            rms = compare.worst(rms, math.sqrt(gap_sq / ref_sq)
                                if ref_sq > 0 else math.nan)
        return {"pcm_rms_rel": rms, "nonfinite_rows": float(bad)}
