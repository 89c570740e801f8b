"""Phase round trip of int16 PCM already on the card, the device steps of
``batch-tophase`` then ``batch-fromphase``:
``BatchedPhase.encode_quantized(pcm, frames)`` -> uint8 planes and per-row
extrema on the card; the extrema to the host (``decode_quantized`` takes
them as host arrays, as the PNG header carries them); then
``BatchedPhase.decode_quantized(planes, maxs, mins, pcm16=True)`` -> int16
samples and finite flags on the card.

Traffic keys: ``rows``, ``clip_s``, ``pool``, ``in_flight``,
``check.sample_calls`` as in entries/mel_encode.py.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.harness import loop, signals
from portbench.reference import codecs, compare, dsp


class Entry:
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        from gomel_tpu_torch.core.config import PhaseConfig
        from gomel_tpu_torch.parallel.batch import BatchedPhase
        self.cfg, self.device = cfg["codec"], device
        self.codec = BatchedPhase(PhaseConfig(**self.cfg), device=device)
        sr = cfg["sample_rate_hz"]
        rows, n = traffic["rows"], round(traffic["clip_s"] * sr)
        length = dsp.pad_length(n, self.cfg["window"])
        frames = dsp.num_frames(length, self.cfg["resolut"],
                                self.cfg["window"])
        self.frames = np.full(rows, frames, dtype=np.int64)
        gen = signals.generator(seed, device)
        self.pool = [signals.pcm16(torch.nn.functional.pad(
            signals.audio(gen, rows, n, sr, device), (0, length - n)))
            for _ in range(traffic["pool"])]
        self.audio_s = rows * n / sr
        self.shape = {"rows": rows, "samples": length, "frames": frames,
                      "out_len": dsp.out_length(frames, self.cfg["resolut"],
                                                self.cfg["window"])}

    def warm(self) -> None:
        for k in range(len(self.pool)):
            self.submit(k, loop.Spans())

    def submit(self, i: int, span) -> loop.Call:
        k = i % len(self.pool)
        with span("encode"):
            planes, mx, mn = self.codec.encode_quantized(self.pool[k],
                                                         self.frames)
        with span("extrema_to_host"):
            mx, mn = mx.cpu().numpy(), mn.cpu().numpy()
        with span("decode"):
            pcm, fin = self.codec.decode_quantized(planes, mx, mn, pcm16=True)
        return loop.Call(self.audio_s, self.shape, (k, planes, mx, mn, pcm),
                         flags=fin)

    def release(self) -> None:
        self.codec = None

    def control(self, call: loop.Call) -> loop.Call:
        """The call with the bf16 reference in the program's place."""
        k = call.outputs[0]
        planes, mx, mn = codecs.phase_encode(self.pool[k], self.cfg, "bf16")
        _, pcm, _ = codecs.phase_decode(planes, mx, mn, self.cfg, "bf16")
        return loop.Call(call.audio_s, call.shape,
                         (k, planes, mx.float().cpu().numpy(),
                          mn.float().cpu().numpy(), pcm))

    def check(self, calls: list[loop.Call]) -> dict[str, float]:
        """The encode against the reference's encode of the same PCM, and
        the decode against the reference's decode of the program's own
        planes and extrema: each stage by itself."""
        step = share = ext = gap = 0.0
        for call in calls:
            k, planes, mx, mn, pcm = call.outputs
            for r0 in range(0, planes.shape[0], 16):
                rows = slice(r0, r0 + 16)
                ref_p, ref_mx, ref_mn = codecs.phase_encode(
                    self.pool[k][rows], self.cfg)
                s, f = compare.plane_steps(planes[rows], ref_p)
                step = compare.worst(step, s)
                share = compare.worst(share, f)
                ext = compare.worst(ext, compare.extrema_gap(
                    mx[rows], mn[rows], ref_mx, ref_mn))
                sig, _, _ = codecs.phase_decode(planes[rows], mx[rows],
                                                mn[rows], self.cfg)
                gap = compare.worst(gap, compare.pcm_gap_lsb(pcm[rows], sig))
        return {"plane_max_step": step, "plane_flip_share": share,
                "extrema_gap": ext, "pcm_gap_lsb": gap}
