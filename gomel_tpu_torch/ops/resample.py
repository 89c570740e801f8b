"""Zero-stuffing upsampler.

Counterpart of ``gomel_tpu/ops/resample.py`` (reference phase/impl.go:506-529):
after every ``zero_pad`` input samples insert ``zero_shift`` zeros; kept
samples are multiplied by ``1 + zero_shift`` (energy compensation). The
trailing partial group still reserves ``zero_shift`` zeros of output length
(Go allocates ``n + ceil(n/zero_pad)*zero_shift`` and leaves the tail at
zero).

Works on numpy arrays (the host float path) and on torch tensors (the plain
version of the upsample inside kernel KA, ops/quantize.pcm16_ingest).
"""
from __future__ import annotations

import numpy as np
import torch


def zero_stuff_upsample(audio, zero_pad: int, zero_shift: int):
    """Insert zeros; returns an array of length n + ceil(n/zero_pad)*zero_shift."""
    if zero_pad == 0:
        return audio
    n = audio.shape[0]
    num_groups = (n + zero_pad - 1) // zero_pad
    boost = float(1 + zero_shift)
    if isinstance(audio, torch.Tensor):
        padded = torch.nn.functional.pad(
            audio, (0, num_groups * zero_pad - n)) * boost
        zeros = audio.new_zeros((num_groups, zero_shift))
        out = torch.cat([padded.reshape(num_groups, zero_pad), zeros], dim=1)
    else:
        padded = np.pad(audio, (0, num_groups * zero_pad - n)) * boost
        zeros = np.zeros((num_groups, zero_shift), dtype=audio.dtype)
        out = np.concatenate([padded.reshape(num_groups, zero_pad), zeros],
                             axis=1)
    return out.reshape(-1)[: n + num_groups * zero_shift]
