"""Device resolution for the PyTorch/CUDA port.

Every entry point runs on ``cuda`` unless the caller asks for the CPU:
``h2o3_tpu_torch.init(device=...)`` sets the process default and
``Frame.from_numpy(..., device=...)`` overrides it per frame. Without a
CUDA device and without an explicit ``"cpu"`` the entry points raise —
they never carry on quietly on the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_default: Optional[torch.device] = None


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the argument, else the
    ``init`` default, else ``cuda``. Raises when that is a CUDA device
    and no CUDA device is present."""
    dev = torch.device(device) if device is not None else (
        _default if _default is not None else torch.device("cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "h2o3_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' (or h2o3_tpu_torch.init("
            "device='cpu')) to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def init(device: DeviceLike = None, n_data=None, n_model: int = 1,
         distributed: bool = False, coordinator_address=None,
         num_processes=None, process_id=None, port=None,
         backend: Optional[str] = None) -> torch.device:
    """Initialise the port: the process-wide default device (``None`` =
    ``cuda``) and the global ('data', 'model') mesh (the JAX package's
    ``init``). Returns the default device, resolved.

    ``n_data``/``n_model`` shape the mesh over the default device's
    devices (``parallel/mesh.make_mesh``: every visible card, or as many
    CPU shards as asked for). ``distributed=True`` first forms the
    process group, every process running the same program:
    ``torch.distributed.init_process_group`` over
    ``tcp://<coordinator_address>`` with ``num_processes`` ranks, this
    one ``process_id``, NCCL on cuda and gloo on the CPU unless
    ``backend`` names one (gloo on cuda: several processes on one card,
    which NCCL refuses); the mesh then spans every process's devices.
    ``port`` (the REST server on the
    coordinator) is not ported: it raises, naming ROADMAP item 20."""
    global _default
    if port is not None:
        raise NotImplementedError(
            "init(port=...) starts the REST server, which is not ported "
            "yet: ROADMAP.md queue 1, item 20 (api/)")
    dev = resolve(device)
    _default = dev
    if distributed:
        import torch.distributed as dist
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError("init(distributed=True) needs "
                             "coordinator_address, num_processes and "
                             "process_id")
        dist.init_process_group(
            backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
    from h2o3_tpu_torch.parallel.mesh import make_mesh, set_mesh
    set_mesh(make_mesh(n_data=n_data, n_model=n_model))
    return dev


def is_coordinator() -> bool:
    """True on process 0 of a mesh across processes (and in a single
    process): the process that would answer the REST port."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0
