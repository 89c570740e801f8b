"""Batched mel encode of float32 waveforms already on the card:
``BatchedMel.encode`` -> log-mel [B, F, mels, 2] on the card.

Traffic keys: ``rows`` a call, ``clip_s`` each row's seconds (true audio;
the rows are padded by the codec's rule), ``pool`` distinct batches kept
on the card and cycled in order, ``in_flight``, ``check.sample_calls``.
"""
from __future__ import annotations

import torch

from portbench.harness import loop, signals
from portbench.reference import codecs, compare, dsp


class Entry:
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        from gomel_tpu_torch.core.config import MelConfig
        from gomel_tpu_torch.parallel.batch import BatchedMel
        self.cfg, self.device = cfg["codec"], device
        self.codec = BatchedMel(MelConfig(**self.cfg), device=device)
        sr = cfg["sample_rate_hz"]
        rows, n = traffic["rows"], round(traffic["clip_s"] * sr)
        length = dsp.pad_length(n, self.cfg["window"])
        gen = signals.generator(seed, device)
        self.pool = []
        for _ in range(traffic["pool"]):
            x = signals.audio(gen, rows, n, sr, device)
            self.pool.append(torch.nn.functional.pad(x, (0, length - n)))
        self.audio_s = rows * n / sr
        self.shape = {"rows": rows, "samples": length,
                      "frames": dsp.num_frames(length, self.cfg["resolut"],
                                               self.cfg["window"])}

    def warm(self) -> None:
        for x in self.pool:
            self.codec.encode(x)

    def submit(self, i: int, span) -> loop.Call:
        k = i % len(self.pool)
        return loop.Call(self.audio_s, self.shape,
                         (k, self.codec.encode(self.pool[k])))

    def release(self) -> None:
        self.codec = None

    def control(self, call: loop.Call) -> loop.Call:
        """The call with the bf16 reference in the program's place."""
        k, _ = call.outputs
        return loop.Call(call.audio_s, call.shape,
                         (k, codecs.mel_encode(self.pool[k], self.cfg,
                                               "bf16").float()))

    def check(self, calls: list[loop.Call]) -> dict[str, float]:
        gap = log_gap = share = 0.0
        for call in calls:
            k, out = call.outputs
            for r0 in range(0, out.shape[0], 16):
                ref = codecs.mel_encode(self.pool[k][r0:r0 + 16], self.cfg)
                got = out[r0:r0 + 16]
                gap = compare.worst(gap, compare.logmel_gap(got, ref))
                log_gap = compare.worst(log_gap,
                                        compare.logmel_log_gap(got, ref))
                share = compare.worst(share,
                                      compare.logmel_step_share(got, ref))
        return {"logmel_gap": gap, "logmel_log_gap": log_gap,
                "logmel_step_share": share}
