"""Griffin-Lim inversion of one long recording cut over the frame shards of
several cards: ``LongFormMel(config, make_mesh(data=1, frame=S))`` over
cards 0..S-1 in one process, then ``.decode(logmel, seed)`` on a float32
log-mel [1, F, mels, 2] resident on card 0; the float signal comes back
gathered on card 0.

Traffic keys: ``frame_shards`` S, ``file_s`` the recording's seconds,
``files`` distinct recordings (their log-mel made in set-up by the
reference encoder, float64, from seeded audio), ``in_flight``,
``check.sample_calls``. Every call decodes with one Griffin-Lim seed.
"""
from __future__ import annotations

import torch

from portbench.harness import loop, signals
from portbench.reference import codecs, compare, dsp, threefry


class Entry:
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        from gomel_tpu_torch.core.config import MelConfig
        from gomel_tpu_torch.parallel.mesh import make_mesh
        from gomel_tpu_torch.pipelines.longform import LongFormMel
        self.cfg = cfg["codec"]
        shards = traffic["frame_shards"]
        self.devices = ([torch.device("cuda", i) for i in range(shards)]
                        if device.type == "cuda" else [device] * shards)
        self.device = self.devices[0]
        self.codec = LongFormMel(MelConfig(**self.cfg),
                                 make_mesh(data=1, frame=shards,
                                           devices=self.devices))
        sr, n, hop = (cfg["sample_rate_hz"], self.cfg["resolut"],
                      self.cfg["window"])
        m = round(traffic["file_s"] * sr)
        length = dsp.pad_length(m, hop)
        frames = dsp.num_frames(length, n, hop)
        gen = signals.generator(seed, self.device)
        self.inputs = []
        for _ in range(traffic["files"]):
            x = torch.nn.functional.pad(
                signals.audio(gen, 1, m, sr, self.device), (0, length - m))
            self.inputs.append(codecs.mel_encode(x, self.cfg).float())
            del x
        self.gl_seed, self.shards = seed % (1 << 31), shards
        self.audio_s = m / sr
        # the plan of parallel/sharded.plan_frame_sharding
        k = -(-n // hop)
        least = max(frames + k - 1, shards * (k - 1), shards)
        self.chunk = -(-least // shards) * hop
        self.shape = {"rows": 1, "frames": frames,
                      "out_len": dsp.out_length(frames, n, hop),
                      "iterations": self.cfg["griffin_lim_iterations"],
                      "out_bytes": 4}

    def warm(self) -> None:
        for j in range(len(self.inputs)):
            self.codec.decode(self.inputs[j], self.gl_seed)

    def submit(self, i: int, span) -> loop.Call:
        j = i % len(self.inputs)
        return loop.Call(self.audio_s, self.shape,
                         (j, self.codec.decode(self.inputs[j], self.gl_seed)))

    def release(self) -> None:
        self.codec = None

    def _reference(self, j: int, precision: str) -> torch.Tensor:
        """The whole recording's Griffin-Lim from the shards' starts: shard
        s draws ``chunk`` samples from ``fold_in(key(seed), s)``, laid end
        to end; the padded frames past the recording have no magnitude, so
        the halos make the sharded decode this one."""
        ar = codecs.Arith(precision)
        k = threefry.key(self.gl_seed)
        keys = [threefry.fold_in(k, s) for s in range(self.shards)]
        start = threefry.uniform(keys, self.chunk, self.device).reshape(1, -1)
        mag = codecs.mel_magnitudes(self.inputs[j], self.cfg, ar)
        return codecs.griffin_lim(mag, start[:, :self.shape["out_len"]],
                                  self.cfg, ar)

    def control(self, call: loop.Call) -> loop.Call:
        """The call with the bf16 reference in the program's place."""
        j = call.outputs[0]
        return loop.Call(call.audio_s, call.shape,
                         (j, self._reference(j, "bf16").float()))

    def check(self, calls: list[loop.Call]) -> dict[str, float]:
        gap = rms = 0.0
        for call in calls:
            j, out = call.outputs
            ref = self._reference(j, "f64")
            gap = compare.worst(gap, compare.signal_gap_lsb(out, ref))
            rms = compare.worst(rms, compare.signal_rms_rel(out, ref))
        return {"signal_gap_lsb": gap, "signal_rms_rel": rms}
