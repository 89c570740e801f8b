"""The ``('data', 'frame')`` device mesh of the frame-sharded pipelines.

Counterpart of ``gomel_tpu/parallel/mesh.py`` on one controller: one process
drives every shard. A :class:`Mesh` is a ``[data, frame]`` grid of
``torch.device``; a device may repeat, so ``make_mesh(data=1, frame=4,
devices=[torch.device("cuda", 0)] * 4)`` runs four frame shards on one card,
and the CPU tests use ``[torch.device("cpu")] * 8`` as the JAX package's
tests use eight virtual CPU devices. Utterance batches split over ``data``,
the frames of each utterance over ``frame`` (parallel/sharded.py).

A :class:`Sharded` array is the per-shard tensors of a ``[B, T, ...]`` array,
held row-major over the grid: shard ``(d, f)`` holds rows
``d*B/n_data:(d+1)*B/n_data`` and positions ``f*T/n_frame:(f+1)*T/n_frame``
of axis 1, on ``mesh.devices[d][f]``.

The multi-process form (``torch.distributed`` process groups, process-local
ingest, ``host_to_global``'s callback form) is a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops._cuda import require_device

DATA_AXIS = "data"
FRAME_AXIS = "frame"
_CPU_MESH_HINT = 'pass devices=[torch.device("cpu")] * n'


class Mesh:
    """A ``[data, frame]`` grid of torch devices (devices may repeat)."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty [data, frame] grid")
        self.devices = rows

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), FRAME_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def first_device(self) -> torch.device:
        return self.devices[0][0]

    def device(self, index: int) -> torch.device:
        """The device of shard ``index`` (row-major: d * n_frame + f)."""
        n_frame = len(self.devices[0])
        return self.devices[index // n_frame][index % n_frame]


def make_mesh(data: Optional[int] = None, frame: int = 1,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Build a ``(data, frame)`` mesh over ``devices`` (default: every CUDA
    device; raises without CUDA). ``data=None`` uses every device not
    consumed by the ``frame`` axis; the frame axis is innermost."""
    if devices is None:
        require_device("cuda", "make_mesh", hint=_CPU_MESH_HINT)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [require_device(d, "make_mesh", hint=_CPU_MESH_HINT)
                   for d in devices]
    n = len(devices)
    if frame <= 0 or n % frame != 0:
        raise ValueError(f"frame axis size {frame} must divide device count {n}")
    if data is None:
        data = n // frame
    if data * frame > n:
        raise ValueError(f"mesh {data}x{frame} needs {data * frame} devices, have {n}")
    return Mesh([devices[d * frame:(d + 1) * frame] for d in range(data)])


def single_device_mesh(device: torch.device | str = "cuda") -> Mesh:
    """1x1 mesh on one device (runs the sharded code paths unchanged on one
    card)."""
    return make_mesh(data=1, frame=1, devices=[torch.device(device)])


@dataclasses.dataclass
class Sharded:
    """A ``[B, T, ...]`` array as per-shard tensors over ``mesh``: rows over
    'data', axis 1 over 'frame', row-major over the grid."""
    mesh: Mesh
    shards: list

    def __post_init__(self):
        if len(self.shards) != self.mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of "
                             f"{self.mesh.size}")

    @property
    def shape(self) -> tuple[int, ...]:
        s = self.shards[0].shape
        return ((s[0] * self.mesh.shape[DATA_AXIS],
                 s[1] * self.mesh.shape[FRAME_AXIS]) + tuple(s[2:]))

    def gather(self, device: torch.device | None = None) -> torch.Tensor:
        """The whole array on ``device`` (default: the mesh's first)."""
        device = self.mesh.first_device if device is None else device
        n_data, n_frame = (self.mesh.shape[DATA_AXIS],
                           self.mesh.shape[FRAME_AXIS])
        rows = [torch.cat([s.to(device) for s in
                           self.shards[d * n_frame:(d + 1) * n_frame]], dim=1)
                for d in range(n_data)]
        return torch.cat(rows, dim=0)


def shard_array(x, mesh: Mesh, dtype: torch.dtype | None = None) -> Sharded:
    """Cut a host (numpy) or device ``[B, T, ...]`` array over ``mesh`` and
    move each block to its device (in ``dtype`` unless None). B must divide
    by the data axis and T by the frame axis."""
    n_data, n_frame = mesh.shape[DATA_AXIS], mesh.shape[FRAME_AXIS]
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.require(x, requirements=["C", "W"]))
    if x.ndim < 2 or x.shape[0] % n_data or x.shape[1] % n_frame:
        raise ValueError(f"array {tuple(x.shape)} does not split over mesh "
                         f"{mesh.shape}")
    b, t = x.shape[0] // n_data, x.shape[1] // n_frame
    shards = []
    for d in range(n_data):
        for f in range(n_frame):
            block = x[d * b:(d + 1) * b, f * t:(f + 1) * t]
            shards.append(block.to(device=mesh.devices[d][f], dtype=dtype)
                          .contiguous())
    return Sharded(mesh, shards)
