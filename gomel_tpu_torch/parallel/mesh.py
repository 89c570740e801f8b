"""The ``('data', 'frame')`` device mesh of the frame-sharded pipelines, on
one controller or across processes.

Counterpart of ``gomel_tpu/parallel/mesh.py``. A :class:`Mesh` is a
``[data, frame]`` grid of ``torch.device`` and of the process rank that owns
each cell. A device may repeat, so ``make_mesh(data=1, frame=4,
devices=[torch.device("cuda", 0)] * 4)`` runs four frame shards on one card,
and the CPU tests use ``[torch.device("cpu")] * 8`` as the JAX package's
tests use eight virtual CPU devices. Utterance batches split over ``data``,
the frames of each utterance over ``frame`` (parallel/sharded.py).

Across processes. :func:`initialize_multihost` brings up a
``torch.distributed`` process group (NCCL by default where CUDA is, gloo when
named). With a group up, :func:`make_mesh` builds the same global grid in
every process, each rank's devices in rank order, and each process holds and
computes only its own cells: the halos between cells of two processes go
over the group (parallel/sharded.py). NCCL drives one card a rank, so a mesh
that puts two NCCL ranks on one card raises (pass ``backend="gloo"`` there;
gloo stages device tensors through host memory). Nothing falls back to gloo
or to the CPU on its own.

A :class:`Sharded` array is the per-cell tensors of a ``[B, T, ...]`` array,
held row-major over the grid: with the default layout ``(data, frame)``,
cell ``(d, f)`` holds rows ``d*B/n_data:(d+1)*B/n_data`` and positions
``f*T/n_frame:(f+1)*T/n_frame`` of axis 1 on ``mesh.devices[d][f]``; with
``(data,)`` it holds the whole of axis 1 of its rows (replicated over
'frame'). A cell of another process holds None.

:func:`host_to_global`, :func:`local_rows_to_global`,
:func:`data_group_for_process` and :func:`process_local_batch_multiple`
keep the JAX functions' contracts and errors, with the ``PartitionSpec``
reduced to the two layouts above.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops._cuda import require_device
from ..utils.profiling import annotate, transfer

DATA_AXIS = "data"
FRAME_AXIS = "frame"
_CPU_MESH_HINT = 'pass devices=[torch.device("cpu")] * n'
_LAYOUTS = ((DATA_AXIS,), (DATA_AXIS, FRAME_AXIS))


# ---------------------------------------------------------------------------
# The process group
# ---------------------------------------------------------------------------

def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the process group (0 without one)."""
    return dist.get_rank() if _group_up() else 0


def process_count() -> int:
    """The process group's size (1 without one)."""
    return dist.get_world_size() if _group_up() else 1


def backend() -> str | None:
    """The process group's backend ("nccl", "gloo"), None without one."""
    return str(dist.get_backend()) if _group_up() else None


def is_multihost() -> bool:
    return process_count() > 1


def local_device_count() -> int:
    """The CUDA cards this process sees."""
    return torch.cuda.device_count()


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         timeout_s: float = 300.0) -> None:
    """Multi-process bring-up: ``torch.distributed.init_process_group`` with
    the launcher's environment as the fallback of each argument
    (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), on the model of
    ``jax.distributed.initialize`` (gomel_tpu/parallel/mesh.py:186-202).

    ``backend`` defaults to "nccl" and needs CUDA; name "gloo" for the CPU
    or for several ranks on one card. ``timeout_s`` bounds every
    collective's wait. Call it once per process before :func:`make_mesh`.
    """
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("initialize_multihost: pass coordinator_address "
                             "or set MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        if "WORLD_SIZE" not in env:
            raise ValueError("initialize_multihost: pass num_processes or set "
                             "WORLD_SIZE")
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        if "RANK" not in env:
            raise ValueError("initialize_multihost: pass process_id or set "
                             "RANK")
        process_id = int(env["RANK"])
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_multihost: the default backend "
                               "'nccl' needs CUDA (torch.cuda.is_available() "
                               "is False); pass backend='gloo' to run on the "
                               "CPU")
        backend = "nccl"
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} not in [0, "
                         f"{num_processes})")
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)))


_HOST_GROUPS: dict = {}


def host_group():
    """The group for host-side exchanges (mesh layouts, checkpoint
    agreement, staged halos): the default group on gloo (None), else a gloo
    group over the same ranks, made the first time, which every process
    must reach together (make_mesh does)."""
    if backend() == "gloo":
        return None
    key = id(dist.group.WORLD)
    if key not in _HOST_GROUPS:
        _HOST_GROUPS[key] = dist.new_group(backend="gloo")
    return _HOST_GROUPS[key]


def _all_gather_host(obj) -> list:
    """``obj`` of every rank, in rank order, over the host group."""
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=host_group())
    return out


def all_reduce_min_host(value: int) -> int:
    """The least of ``value`` over every process (a MIN all-reduce over the
    host group); ``value`` itself without a group."""
    if process_count() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=host_group())
    return int(t.item())


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

class Mesh:
    """A ``[data, frame]`` grid of torch devices (devices may repeat) and of
    the rank that owns each cell (default: this process, for every cell)."""

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 ranks: Sequence[Sequence[int]] | None = None):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty [data, frame] grid")
        if ranks is None:
            ranks = [[process_index()] * len(r) for r in rows]
        ranks = [[int(x) for x in row] for row in ranks]
        if [len(r) for r in ranks] != [len(r) for r in rows]:
            raise ValueError("ranks must have the devices' [data, frame] shape")
        self.devices = rows
        self.ranks = ranks

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
        """The device of cell ``index`` (row-major: d * n_frame + f)."""
        n_frame = len(self.devices[0])
        return self.devices[index // n_frame][index % n_frame]

    def rank(self, index: int) -> int:
        """The process that owns cell ``index``."""
        n_frame = len(self.devices[0])
        return self.ranks[index // n_frame][index % n_frame]

    def is_local(self, index: int) -> bool:
        """Whether this process owns cell ``index``."""
        return self.rank(index) == process_index()

    @property
    def local_indices(self) -> list[int]:
        """This process's cells, in row-major order."""
        return [i for i in range(self.size) if self.is_local(i)]

    @property
    def first_local_device(self) -> torch.device:
        local = self.local_indices
        if not local:
            raise ValueError(f"process {process_index()} owns no cell of the "
                             f"mesh")
        return self.device(local[0])

    @property
    def processes(self) -> list[int]:
        return sorted({r for row in self.ranks for r in row})

    @property
    def spans_processes(self) -> bool:
        return len(self.processes) > 1


def _card(dev: torch.device) -> int:
    return 0 if dev.index is None else dev.index


def _check_nccl_layout(layout: list) -> None:
    """Each NCCL rank drives one card of its own. ``layout``: per rank
    (host, local rank, device strings or None, visible cards). Raises when
    two ranks of one host would share a card (NCCL refuses it: "Duplicate
    GPU detected") or a rank has no card of its own."""
    hint = ("NCCL drives one card a process; for several processes on one "
            "card pass backend='gloo' to initialize_multihost (with "
            "devices=[torch.device('cuda', i)] * n to make_mesh)")
    used: dict[tuple[str, int], int] = {}
    for r, (host, local_rank, devs, visible) in enumerate(layout):
        if devs is None:
            if local_rank >= visible:
                raise ValueError(
                    f"make_mesh: rank {r} (local rank {local_rank} on "
                    f"{host}) has no card of its own ({visible} visible), so "
                    f"two ranks would share one; {hint}")
            cards = {local_rank}
        else:
            devices = [torch.device(d) for d in devs]
            if any(d.type != "cuda" for d in devices):
                raise ValueError(f"make_mesh: rank {r}'s devices {devs} are "
                                 f"not all CUDA; NCCL moves CUDA tensors")
            cards = {_card(d) for d in devices}
            if len(cards) != 1:
                raise ValueError(f"make_mesh: rank {r} names cards "
                                 f"{sorted(cards)}; {hint}")
        for c in cards:
            other = used.setdefault((host, c), r)
            if other != r:
                raise ValueError(f"make_mesh: ranks {other} and {r} on "
                                 f"{host} both name cuda:{c}; {hint}")


def _multiprocess_devices(devices) -> list[tuple[torch.device, int]]:
    """Every rank's (device, rank) cells in rank order, gathered over the
    host group; checks the layout when the backend is NCCL and makes this
    rank's card current there."""
    mine = None
    if devices is not None:
        mine = [str(require_device(d, "make_mesh", hint=_CPU_MESH_HINT))
                for d in devices]
        if not mine:
            raise ValueError("make_mesh: devices is empty")
    layout = _all_gather_host((socket.gethostname(),
                               os.environ.get("LOCAL_RANK"), mine,
                               torch.cuda.device_count()))
    full = []
    for r, (host, local_rank, devs, visible) in enumerate(layout):
        if local_rank is None:   # this rank's place among its host's ranks
            local_rank = sum(1 for h, *_ in layout[:r] if h == host)
        full.append((host, int(local_rank), devs, visible))
    if backend() == "nccl":
        _check_nccl_layout(full)
    cells = []
    for r, (_, local_rank, devs, _) in enumerate(full):
        if devs is None:
            devs = [f"cuda:{local_rank}"]
        cells.extend((torch.device(d), r) for d in devs)
    own = [d for d, r in cells if r == process_index()]
    if devices is None:
        require_device(own[0], "make_mesh", hint=_CPU_MESH_HINT)
    if backend() == "nccl":
        torch.cuda.set_device(own[0])
        # every rank in NCCL's first collective: the halos' point-to-point
        # batches may leave a rank out
        dist.barrier()
    return cells


def make_mesh(data: Optional[int] = None, frame: int = 1,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Build a ``(data, frame)`` mesh over ``devices`` (default: every CUDA
    device; raises without CUDA). ``data=None`` uses every device not
    consumed by the ``frame`` axis; the frame axis is innermost.

    With a process group of several processes up, ``devices`` are this
    process's (default: ``cuda:<local rank>``), the grid is every rank's
    devices in rank order, built alike in every process (every process
    calls it together), and every rank must own a cell."""
    multi = process_count() > 1
    if multi:
        cells = _multiprocess_devices(devices)
    else:
        if devices is None:
            require_device("cuda", "make_mesh", hint=_CPU_MESH_HINT)
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [require_device(d, "make_mesh", hint=_CPU_MESH_HINT)
                       for d in devices]
        cells = [(d, process_index()) for d in devices]
    n = len(cells)
    if frame <= 0 or n % frame != 0:
        raise ValueError(f"frame axis size {frame} must divide device count {n}")
    if data is None:
        data = n // frame
    if data * frame > n:
        raise ValueError(f"mesh {data}x{frame} needs {data * frame} devices, have {n}")
    cells = cells[:data * frame]
    if multi:
        idle = sorted(set(range(process_count())) - {r for _, r in cells})
        if idle:
            raise ValueError(f"mesh {data}x{frame} leaves processes {idle} "
                             f"without a cell; every process of the group "
                             f"must own one")
    grid = [cells[d * frame:(d + 1) * frame] for d in range(data)]
    return Mesh([[c for c, _ in row] for row in grid],
                [[r for _, r in row] for row in grid])


def single_device_mesh(device: torch.device | str = "cuda") -> Mesh:
    """1x1 mesh on one device (runs the sharded code paths unchanged on one
    card)."""
    return make_mesh(data=1, frame=1, devices=[torch.device(device)])


# ---------------------------------------------------------------------------
# Sharded arrays
# ---------------------------------------------------------------------------

def _layout(spec) -> tuple[str, ...]:
    spec = (spec,) if isinstance(spec, str) else tuple(spec)
    if spec not in _LAYOUTS:
        raise ValueError(f"layout {spec} is not one of {_LAYOUTS}")
    return spec


class Shard(NamedTuple):
    """One cell's part of a :class:`Sharded` array: its global slice of
    every axis and its tensor (as ``jax.Array.addressable_shards``)."""
    index: tuple
    data: torch.Tensor


@dataclasses.dataclass
class Sharded:
    """A ``[B, T, ...]`` array as per-cell tensors over ``mesh``, row-major
    over the grid: rows over 'data', axis 1 over 'frame' (``spec`` ``(data,
    frame)``) or whole (``(data,)``). ``shards[i]`` is None for a cell of
    another process. ``trim`` (rows, length), when set, makes the array the
    leading ``[:rows, :length]`` of the grid's (a pipeline's result)."""
    mesh: Mesh
    shards: list
    trim: tuple[int, int] | None = None
    spec: tuple[str, ...] = (DATA_AXIS, FRAME_AXIS)

    def __post_init__(self):
        self.spec = _layout(self.spec)
        if len(self.shards) != self.mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of "
                             f"{self.mesh.size}")
        if all(s is None for s in self.shards):
            raise ValueError("a Sharded array needs at least one local shard")

    @property
    def _frame_split(self) -> bool:
        return FRAME_AXIS in self.spec

    @property
    def padded_shape(self) -> tuple[int, ...]:
        """The grid's shape, before ``trim``."""
        s = next(t for t in self.shards if t is not None).shape
        n_frame = self.mesh.shape[FRAME_AXIS] if self._frame_split else 1
        return ((s[0] * self.mesh.shape[DATA_AXIS], s[1] * n_frame)
                + tuple(s[2:]))

    @property
    def shape(self) -> tuple[int, ...]:
        shape = self.padded_shape
        if self.trim is None:
            return shape
        return (self.trim[0], self.trim[1]) + shape[2:]

    @property
    def dtype(self) -> torch.dtype:
        return next(t for t in self.shards if t is not None).dtype

    def index(self, i: int) -> tuple:
        """Cell ``i``'s global slices of every axis of the padded grid."""
        shape = self.padded_shape
        n_frame = self.mesh.shape[FRAME_AXIS]
        d, f = divmod(i, n_frame)
        b = shape[0] // self.mesh.shape[DATA_AXIS]
        rows = slice(d * b, (d + 1) * b)
        if self._frame_split:
            t = shape[1] // n_frame
            cols = slice(f * t, (f + 1) * t)
        else:
            cols = slice(0, shape[1])
        return (rows, cols) + tuple(slice(0, n) for n in shape[2:])

    def shard(self, i: int) -> torch.Tensor:
        """Cell ``i``'s tensor (raises for a cell of another process)."""
        if self.shards[i] is None:
            raise ValueError(f"shard {i} belongs to process "
                             f"{self.mesh.rank(i)}, not to process "
                             f"{process_index()}")
        return self.shards[i]

    @property
    def addressable_shards(self) -> list[Shard]:
        """This process's cells, each clipped to ``trim``: (global index,
        tensor)."""
        out = []
        for i, t in enumerate(self.shards):
            if t is None:
                continue
            index = self.index(i)
            if self.trim is not None:
                clipped = []
                for sl, n in zip(index[:2], self.trim):
                    clipped.append(slice(min(sl.start, n), min(sl.stop, n)))
                t = t[:clipped[0].stop - clipped[0].start,
                      :clipped[1].stop - clipped[1].start]
                index = tuple(clipped) + index[2:]
            out.append(Shard(index, t))
        return out

    def gather(self, device: torch.device | None = None) -> torch.Tensor:
        """The whole array on ``device`` (default: the mesh's first); raises
        on a mesh that spans processes, where this process holds its own
        shards only (read those with ``addressable_shards``)."""
        if self.mesh.spans_processes:
            raise ValueError(
                f"Sharded.gather: the mesh spans processes "
                f"{self.mesh.processes}; process {process_index()} holds "
                f"shards {self.mesh.local_indices} only (read them with "
                f"addressable_shards or shard(i))")
        with annotate("gomel.mesh.gather"):
            device = torch.device(self.mesh.first_device if device is None
                                  else device)
            n_data, n_frame = (self.mesh.shape[DATA_AXIS],
                               self.mesh.shape[FRAME_AXIS])
            if self._frame_split:
                rows = [torch.cat([_moved(s, device) for s in
                                   self.shards[d * n_frame:(d + 1) * n_frame]],
                                  dim=1) for d in range(n_data)]
            else:
                rows = [_moved(self.shards[d * n_frame], device)
                        for d in range(n_data)]
            out = torch.cat(rows, dim=0)
            return out if self.trim is None else out[:self.trim[0],
                                                     :self.trim[1]]


def _moved(t: torch.Tensor, device: torch.device,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """``t`` on ``device`` (in ``dtype`` unless None), the copy traced
    (utils/profiling.transfer)."""
    with transfer(t, device):
        return t.to(device=device, dtype=dtype)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.require(np.asarray(x), requirements=["C", "W"]))


def shard_array(x, mesh: Mesh, dtype: torch.dtype | None = None,
                spec=(DATA_AXIS, FRAME_AXIS)) -> Sharded:
    """Cut a host (numpy) or device ``[B, T, ...]`` array over ``mesh`` and
    move each of this process's blocks to its device (in ``dtype`` unless
    None). B must divide by the data axis and, with the ``(data, frame)``
    layout, T by the frame axis. On a mesh over several processes every
    process passes the same whole array (the replicated-input model)."""
    with annotate("gomel.mesh.scatter"):
        spec = _layout(spec)
        n_data, n_frame = mesh.shape[DATA_AXIS], mesh.shape[FRAME_AXIS]
        split = FRAME_AXIS in spec
        x = _as_tensor(x)
        if x.ndim < 2 or x.shape[0] % n_data or (split
                                                 and x.shape[1] % n_frame):
            raise ValueError(f"array {tuple(x.shape)} does not split over "
                             f"mesh {mesh.shape}")
        b = x.shape[0] // n_data
        t = x.shape[1] // n_frame if split else x.shape[1]
        shards: list = [None] * mesh.size
        for i in mesh.local_indices:
            d, f = divmod(i, n_frame)
            cols = slice(f * t, (f + 1) * t) if split else slice(None)
            shards[i] = _moved(x[d * b:(d + 1) * b, cols], mesh.device(i),
                               dtype).contiguous()
        return Sharded(mesh, shards, spec=spec)


def host_to_global(arr, mesh: Mesh, spec=(DATA_AXIS, FRAME_AXIS)) -> Sharded:
    """A host array as a :class:`Sharded` over ``mesh`` in layout ``spec``
    (``(data, frame)`` or ``(data,)``), on meshes over several processes
    too: every process holds the same full host copy (the replicated-input
    model, e.g. each read the same file) and uploads only its own cells."""
    return shard_array(arr, mesh, None, spec)


def data_group_for_process(mesh: Mesh, axis: str = DATA_AXIS
                           ) -> tuple[int, int]:
    """(group_index, num_groups) for the process-local ingest.

    Processes whose cells own the SAME set of ``axis`` coordinates form an
    ingest GROUP: each group supplies its own rows (identical within the
    group, e.g. the same file list, io.dataset.shard_files_for_group) and
    the global batch is the concatenation of the groups in coordinate
    order. On the usual layouts each process owns distinct coordinates and
    every group has one member; on a mesh whose OTHER axis also spans
    processes (a 2x2 ``(data, frame)`` mesh over four single-device
    processes) two processes co-own each data block and form a two-member
    group.

    Raises when the layout is not groupable: coordinate sets must partition
    ``[0, n_axis)`` into equal-size CONTIGUOUS blocks (so each group's rows
    map to one contiguous global slice).
    """
    n_axis = mesh.shape[axis]
    if process_count() == 1:
        return 0, 1
    ranks = np.asarray(mesh.ranks)
    if axis == FRAME_AXIS:
        ranks = ranks.T
    coords_by_proc: dict[int, set[int]] = {}
    for c in range(n_axis):
        for r in ranks[c].flat:
            coords_by_proc.setdefault(int(r), set()).add(c)
    my = coords_by_proc.get(process_index())
    if my is None:
        raise ValueError(
            f"process {process_index()} owns no device in the mesh")
    keys = sorted({tuple(sorted(s)) for s in coords_by_proc.values()})
    size = len(keys[0])
    flat = [c for k in keys for c in k]
    if (any(len(k) != size for k in keys)
            or flat != list(range(n_axis))
            or any(k != tuple(range(k[0], k[0] + size)) for k in keys)):
        raise ValueError(
            f"'{axis}' axis coordinates {keys} do not partition into "
            "equal contiguous per-group blocks; use the replicated-input "
            "model (host_to_global)")
    return keys.index(tuple(sorted(my))), len(keys)


def process_local_batch_multiple(mesh: Mesh, axis: str = DATA_AXIS) -> int:
    """Rows-per-process granularity for :func:`local_rows_to_global`: each
    process's local batch must pad to a multiple of the ``axis`` positions
    its ingest GROUP owns, so every cell gets whole rows."""
    n_axis = mesh.shape[axis]
    if process_count() == 1:
        return n_axis
    _, ng = data_group_for_process(mesh, axis)
    return n_axis // ng


def local_rows_to_global(local_rows, mesh: Mesh,
                         spec=(DATA_AXIS,)) -> Sharded:
    """Assemble a global batch from each process's OWN leading-axis rows
    (the process-local-input model, fed by
    ``io.dataset.shard_files_for_process`` / ``shard_files_for_group``).

    One process: the rows are the batch (:func:`host_to_global`). Several:
    the global batch is the groups' rows in group order
    (:func:`data_group_for_process`), and each of this process's cells gets
    the slice of its group's rows that its global index selects (group
    members pass identical rows). Every process passes the same row count.
    """
    spec = _layout(spec)
    if process_count() == 1:
        return host_to_global(local_rows, mesh, spec)
    local = _as_tensor(local_rows)
    gi, ng = data_group_for_process(mesh, DATA_AXIS)
    n_data, n_frame = mesh.shape[DATA_AXIS], mesh.shape[FRAME_AXIS]
    n_global = local.shape[0] * ng
    if n_global % n_data:
        raise ValueError(f"{n_global} global rows do not split over the "
                         f"data axis ({n_data})")
    b = n_global // n_data
    off = gi * local.shape[0]
    split = FRAME_AXIS in spec
    if split and local.shape[1] % n_frame:
        raise ValueError(f"array {tuple(local.shape)} does not split over "
                         f"mesh {mesh.shape}")
    t = local.shape[1] // n_frame if split else local.shape[1]
    shards: list = [None] * mesh.size
    for i in mesh.local_indices:
        d, f = divmod(i, n_frame)
        r0, r1 = d * b, (d + 1) * b
        if r0 < off or r1 > off + local.shape[0]:
            raise ValueError(
                f"device {mesh.device(i)} needs global rows [{r0}, {r1}) "
                f"outside this process's group block [{off}, "
                f"{off + local.shape[0]})")
        cols = slice(f * t, (f + 1) * t) if split else slice(None)
        shards[i] = local[r0 - off:r1 - off, cols].to(
            mesh.device(i)).contiguous()
    return Sharded(mesh, shards, spec=spec)
