"""The ('data', 'model') mesh of the port: the counterpart of
``h2o3_tpu/parallel/mesh.py``.

A mesh is an explicit ``[n_data, n_model]`` grid of shard devices and,
when it spans processes, a ``torch.distributed`` process group. Rows
shard over ``data`` (contiguous padded blocks, one a data shard); the
split search shards its features over ``model``. Shards may share a
device: a CPU mesh is as many shards of the host as asked for (the
counterpart of XLA's forced host device count), and a card can hold
several virtual shards (``make_mesh(4, devices=["cuda:0"] * 4)``).

Multi-shard execution is the default whenever more than one card is
visible: the lazy mesh spans every visible card on the data axis.
``H2O3_SPMD=0`` collapses that default to one device; an explicit
shape or device list always wins. On a one-card host, and on the CPU,
the default mesh is (1, 1), and a train on a one-shard mesh is the
port's single-device train, bit for bit: its rows are not padded and
its collectives are the identity.

Across processes (``h2o3_tpu_torch.init(distributed=True)``), the mesh
spans every process's local devices, data shards in process order: each
process owns ``n_data / world`` contiguous data shards and every model
shard of them, so the model axis never crosses a process.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

_MESH: Optional["Mesh"] = None


def spmd_enabled() -> bool:
    """Whether the DEFAULT mesh may span devices (``H2O3_SPMD``, on
    unless "0", "false" or empty); also gates the model-axis split
    search, as in the JAX package."""
    return os.environ.get("H2O3_SPMD", "1") not in ("0", "false", "")


def _world():
    """(process group, rank, world size) of an initialised
    ``torch.distributed``, else (None, 0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    return None, 0, 1


class Mesh:
    """A ``[n_data, n_model]`` grid of shard devices (``devices``, an
    object array of ``torch.device``), its process group (None in one
    process) and this process's rank. ``shape`` maps the axis names to
    their sizes, as a JAX mesh's does. In a mesh across processes the
    devices of other processes' shards are written as this process's
    devices at the same local position: every process of the port runs
    the same program on the same local layout."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices, group=None, rank: int = 0, world: int = 1):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2:
            raise ValueError("mesh devices must be an [n_data, n_model] grid")
        self.group = group
        self.rank = int(rank)
        self.world = int(world)
        nd = self.devices.shape[0]
        if nd % self.world:
            raise ValueError(f"{nd} data shards do not split over "
                             f"{self.world} processes")
        per = nd // self.world
        self.local_shards = list(range(self.rank * per, (self.rank + 1) * per))

    @property
    def shape(self):
        return {DATA_AXIS: self.devices.shape[0],
                MODEL_AXIS: self.devices.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, shard: int, model: int = 0) -> torch.device:
        return self.devices[shard, model]

    @property
    def lead_device(self) -> torch.device:
        """Where this process's reductions land: its first data shard's
        primary device."""
        return self.devices[self.local_shards[0], 0]

    def __repr__(self):
        return (f"Mesh(shape=({self.shape[DATA_AXIS]}, "
                f"{self.shape[MODEL_AXIS]}), devices="
                f"{[str(d) for d in self.devices.reshape(-1)]}, "
                f"world={self.world})")


def on_device(dev: torch.device):
    """A shard's device as the current CUDA device around its launches
    (a no-op on the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _check_device(d: torch.device) -> torch.device:
    """A mesh device that exists here; a card that is not there raises."""
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {d}: no CUDA device is "
                               f"available")
        idx = 0 if d.index is None else d.index
        if idx >= torch.cuda.device_count():
            raise RuntimeError(f"mesh device {d}: only "
                               f"{torch.cuda.device_count()} CUDA devices "
                               f"are visible")
        return torch.device("cuda", idx)
    if d.type != "cpu":
        raise ValueError(f"unsupported mesh device {d}; use 'cuda' or 'cpu'")
    return torch.device("cpu")


def _default_type() -> str:
    """The device type of the default mesh: ``init``'s device where one
    was set, else cuda where a card is visible, else the CPU."""
    from h2o3_tpu_torch import _device
    if _device._default is not None:
        return _device._default.type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('data', 'model') mesh over this process's devices (and,
    under ``torch.distributed``, every process's).

    ``devices`` lists the local shard devices in shard order (a device
    may repeat: virtual shards). Without it: every visible card, or on
    the CPU as many host shards as the shape asks for (one without a
    shape). With ``H2O3_SPMD=0`` and no explicit shape or devices the
    mesh collapses to one device. A shape that needs more devices than
    there are raises the JAX package's ``ValueError``."""
    group, rank, world = _world()
    if devices is None:
        kind = _default_type()
        if kind == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            want = (n_data or 1) * n_model
            devices = [torch.device("cpu")] * max(1, -(-want // world))
        if n_data is None and n_model == 1 and not spmd_enabled():
            devices = devices[:1]
    devices = [_check_device(torch.device(d)) for d in devices]
    n = len(devices) * world
    if n_data is None:
        n_data = max(1, n // n_model)
    if n_data * n_model > n:
        raise ValueError(
            f"mesh shape ({n_data},{n_model}) needs {n_data * n_model} "
            f"devices, have {n}")
    if n_data % world:
        raise ValueError(f"mesh shape ({n_data},{n_model}): {n_data} data "
                         f"shards do not split over {world} processes")
    per = n_data // world
    local = np.empty((per, n_model), dtype=object)
    for j in range(per):
        for m in range(n_model):
            local[j, m] = devices[j * n_model + m]
    grid = np.concatenate([local] * world, axis=0)
    return Mesh(grid, group, rank, world)


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Set the process-wide mesh (None: the lazy default is rebuilt at
    the next ``current_mesh``)."""
    global _MESH
    _MESH = mesh


def current_mesh() -> Mesh:
    """The global mesh, made lazily over the default devices (pure data
    axis)."""
    global _MESH
    if _MESH is None:
        _MESH = make_mesh()
    return _MESH


def n_data_shards(mesh: Optional[Mesh] = None) -> int:
    return (mesh or current_mesh()).shape[DATA_AXIS]


def n_model_shards(mesh: Optional[Mesh] = None) -> int:
    return (mesh or current_mesh()).shape[MODEL_AXIS]


class Sharding:
    """The port's stand-in for a JAX ``NamedSharding``: a mesh and a
    partition spec (a tuple of axis names or None). ``place`` puts an
    array on this process's shards."""

    def __init__(self, mesh: Mesh, spec: Tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    def place(self, arr) -> List[torch.Tensor]:
        part = DataParallelPartitioner(self.mesh)
        if self.spec and self.spec[0] == DATA_AXIS:
            return part.shard_rows(arr)
        return part.replicate(arr)


def data_sharding(mesh: Optional[Mesh] = None) -> Sharding:
    """Row-partitioned placement (rows on 'data')."""
    return Sharding(mesh or current_mesh(), (DATA_AXIS,))


def replicated_sharding(mesh: Optional[Mesh] = None) -> Sharding:
    return Sharding(mesh or current_mesh(), ())


# logical -> physical axis rules, highest priority first (the JAX
# package's rules): 'rows' shard on data, 'features' on model, the rest
# replicate
_AXIS_RULES = (
    ("rows", DATA_AXIS),
    ("features", MODEL_AXIS),
    ("trees", None),
    ("bins", None),
    ("classes", None),
)


def logical_to_physical(logical_axes) -> Tuple:
    """Resolve logical axis names to a partition spec (a tuple) by rule
    priority; a physical axis is consumed by the first logical axis that
    claims it."""
    used = set()
    out = []
    for ax in logical_axes:
        phys = None
        for lname, pname in _AXIS_RULES:
            if lname == ax and pname is not None and pname not in used:
                phys = pname
                used.add(pname)
                break
        out.append(phys)
    return tuple(out)


def _as_tensor(arr) -> torch.Tensor:
    return arr if isinstance(arr, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(arr))


class DataParallelPartitioner:
    """Row partitioning between a padded array and the mesh: every
    padded row block has one home data shard (the counterpart of the
    JAX package's partitioner and of the reference's chunk homes).
    Placement returns this process's blocks, one a local data shard, on
    each shard's primary device; a block already on its device is a view,
    not a copy."""

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh or current_mesh()

    @property
    def n_data(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    # -- row placement --------------------------------------------------

    def shard_rows(self, arr, global_rows: Optional[int] = None
                   ) -> List[torch.Tensor]:
        """This process's row blocks of a padded array (rows divisible
        by n_data), each on its shard's device. With ``global_rows``,
        ``arr`` holds only this process's rows (the multi-process
        worker's shape); without it, ``arr`` is the global array that
        every process holds (the single-program path) and each process
        keeps the blocks it owns."""
        t = _as_tensor(arr)
        total = global_rows if global_rows is not None else t.shape[0]
        if total % self.n_data:
            raise ValueError(
                f"padded row count {total} is not divisible by the "
                f"{self.n_data}-shard data axis")
        per = total // self.n_data
        first = self.mesh.local_shards[0]
        out = []
        for j, s in enumerate(self.mesh.local_shards):
            lo = (s - first) * per if global_rows is not None else s * per
            out.append(t[lo:lo + per].to(self.mesh.device(s)))
        return out

    def replicate(self, arr) -> List[torch.Tensor]:
        """``arr`` on each local data shard's device (the same tensor
        where devices repeat)."""
        t = _as_tensor(arr)
        return [t.to(self.mesh.device(s)) for s in self.mesh.local_shards]

    # -- chunk homing ----------------------------------------------------

    def shard_devices(self, shard: int) -> List[torch.device]:
        """The devices of data shard ``shard`` (one a model position;
        index 0 is its primary home)."""
        return list(self.mesh.devices[shard])

    def home_device(self, shard: int) -> torch.device:
        return self.shard_devices(shard)[0]

    def chunk_home(self, chunk_idx: int, n_chunks: int) -> int:
        """Home data shard of byte-range chunk ``chunk_idx`` of
        ``n_chunks``: chunks map to shards in row order."""
        n_chunks = max(n_chunks, 1)
        return min(chunk_idx * self.n_data // n_chunks, self.n_data - 1)

    def row_bounds(self, padded_rows: int):
        """[(start, end)) row range of each data shard of a padded
        array."""
        per = padded_rows // self.n_data
        return [(d * per, (d + 1) * per) for d in range(self.n_data)]

    def shard_process(self, shard: int, nproc: Optional[int] = None) -> int:
        """The process owning data shard ``shard``: on the mesh, its
        process's rank; under a simulated process count ``nproc``, the
        shards split evenly and contiguously over ``nproc``."""
        if nproc is None or nproc == self.mesh.world:
            return shard * self.mesh.world // self.n_data
        return shard * nproc // self.n_data

    # -- per-shard step observation ---------------------------------------

    def observe_step(self, marks, *, algo: str = "train"):
        """Per-shard completion and collective-wait metrics of one step
        (``parallel/shardstats.py``) from its ``shardstats.StepMarks``;
        None on a one-shard mesh or with telemetry off."""
        if self.n_data <= 1:
            return None
        from h2o3_tpu_torch.parallel.shardstats import observe_sharded_step
        return observe_sharded_step(marks, algo=algo)


def partitioner(mesh: Optional[Mesh] = None) -> DataParallelPartitioner:
    return DataParallelPartitioner(mesh or current_mesh())


def padded_len(nrow: int, mesh: Optional[Mesh] = None,
               multiple: int = 8) -> int:
    """Rows padded so that every data shard has the same length, a
    multiple of ``multiple`` (the JAX package's rule: its shapes are
    static and its sublanes eight rows)."""
    nd = n_data_shards(mesh)
    q = multiple * nd
    return max(q, int(math.ceil(nrow / q)) * q)
