"""Collectives over the mesh's axes: the port's counterparts of the
JAX package's inline ``jax.lax.psum``, ``pmax``, ``pmin`` and
``all_gather``.

Every collective takes this process's per-shard tensors as a list, one
a local data shard in shard order, and returns the reduced tensor once
for each of them, on that shard's device. Each has one implementation a
layout, and the layout picks it:

- one process: the shards' tensors are combined on the lead shard's
  device in shard order (``acc = s0; acc = acc + s1; ...``) and the
  result is copied back to each shard's device; where shards share a
  device the copies are no-ops. The order is fixed, so a virtual mesh
  repeats bit for bit;
- several processes (``mesh.group``): each process first combines its
  local shards in shard order, then ``torch.distributed.all_reduce``
  combines the processes' partials. NCCL reduces CUDA tensors in place;
  under gloo a CUDA partial is copied to the host, reduced there and
  copied back, an explicit copy (gloo's CUDA support varies by build).

There is no fallback: a collective that fails raises, and nothing
carries on with one shard's sums.

A one-shard list without a process group is returned as it is: the
single-device train pays nothing. ``timing()`` records each data-axis
reduction's time (CUDA events on the card, the host clock on the CPU)
for the harness.
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Sequence

import torch

from h2o3_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

_COMBINE = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}

# the active timing record of ``timing()``, or None
_TIMING: Optional[list] = None


@contextlib.contextmanager
def timing():
    """Record every data-axis reduction in the block: yields a list of
    (start, end) pairs (CUDA events on a card, perf_counter readings on
    the CPU); ``elapsed_ms`` reads them after the block."""
    global _TIMING
    prev, _TIMING = _TIMING, []
    try:
        yield _TIMING
    finally:
        _TIMING = prev


def elapsed_ms(record) -> List[float]:
    """The milliseconds of each reduction of a ``timing()`` record."""
    out = []
    for a, b in record:
        if isinstance(a, float):
            out.append((b - a) * 1e3)
        else:
            b.synchronize()
            out.append(a.elapsed_time(b))
    return out


def _mark(dev: torch.device):
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        return ev
    return time.perf_counter()


def _backend(mesh: Mesh) -> str:
    import torch.distributed as dist
    return dist.get_backend(mesh.group)


def _all_reduce(acc: torch.Tensor, op: str, mesh: Mesh) -> torch.Tensor:
    import torch.distributed as dist
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    if acc.device.type == "cuda" and _backend(mesh) == "gloo":
        host = acc.to("cpu")
        dist.all_reduce(host, op=rop, group=mesh.group)
        return host.to(acc.device)
    acc = acc.contiguous().clone()
    dist.all_reduce(acc, op=rop, group=mesh.group)
    return acc


def _spread(acc: torch.Tensor, devices) -> List[torch.Tensor]:
    return [acc if d == acc.device else acc.to(d) for d in devices]


def preduce(xs: Sequence[torch.Tensor], op: str, mesh: Optional[Mesh] = None,
            axis: str = DATA_AXIS, lead_only: bool = False
            ) -> List[torch.Tensor]:
    """``op`` ("sum", "max" or "min") over the data axis of this
    process's per-shard tensors ``xs``; returns the result on each
    shard's device, or with ``lead_only`` once, on the lead shard's (the
    growers search the reduced histogram once and send each shard only
    the next level's tables)."""
    if axis != DATA_AXIS:
        raise ValueError(f"preduce runs over the '{DATA_AXIS}' axis; the "
                         f"'{MODEL_AXIS}' axis gathers (all_gather)")
    xs = list(xs)
    group = mesh.group if mesh is not None else None
    if len(xs) == 1 and group is None:
        return xs
    if not xs:
        raise ValueError("a collective needs at least one shard's tensor")
    devices = [x.device for x in xs]
    lead = devices[0]
    t0 = _mark(lead) if _TIMING is not None else None
    combine = _COMBINE[op]
    acc = xs[0]
    for x in xs[1:]:
        acc = combine(acc, x.to(lead))
    if group is not None:
        acc = _all_reduce(acc, op, mesh)
    if t0 is not None:
        _TIMING.append((t0, _mark(lead)))
    return [acc] if lead_only else _spread(acc, devices)


def psum(xs, mesh: Optional[Mesh] = None, axis: str = DATA_AXIS,
         lead_only: bool = False):
    return preduce(xs, "sum", mesh, axis, lead_only)


def pmax(xs, mesh: Optional[Mesh] = None, axis: str = DATA_AXIS,
         lead_only: bool = False):
    return preduce(xs, "max", mesh, axis, lead_only)


def pmin(xs, mesh: Optional[Mesh] = None, axis: str = DATA_AXIS,
         lead_only: bool = False):
    return preduce(xs, "min", mesh, axis, lead_only)


def all_gather(xs: Sequence[torch.Tensor], mesh: Optional[Mesh] = None,
               axis: str = DATA_AXIS) -> List[torch.Tensor]:
    """Every shard's tensor along ``axis``, in shard order, on the lead
    device. Over ``model`` (always inside a process) that is the local
    list moved to the lead device; over ``data`` across processes each
    process's tensors (equal shapes: rows are padded) come from
    ``torch.distributed.all_gather``, through the host under gloo."""
    xs = list(xs)
    lead = xs[0].device
    local = [x.to(lead) for x in xs]
    group = mesh.group if mesh is not None else None
    if axis == MODEL_AXIS or group is None:
        return local
    import torch.distributed as dist
    via_host = lead.type == "cuda" and _backend(mesh) == "gloo"
    mine = torch.stack(local).contiguous()
    if via_host:
        mine = mine.to("cpu")
    parts = [torch.empty_like(mine) for _ in range(mesh.world)]
    dist.all_gather(parts, mine, group=group)
    out = []
    for p in parts:
        out.extend(p.to(lead).unbind(0))
    return out
