"""The compute combinator, the port's counterpart of
``h2o3_tpu/parallel/map_reduce.py`` (the reference's MRTask).

``map_fn`` runs once a data shard on the shard's rows (the "chunk"), on
the shard's device; the per-shard results are combined by a collective
over the data axis (``parallel/collectives``). Two shapes, as there:

- ``map_reduce``: map, then an associative reduce ("sum", "max", "min")
  to a result every shard holds (MRTask with a ``reduce()``);
- ``map_cols``: an elementwise map producing new row-sharded columns
  (MRTask with NewChunk outputs).

``arrays`` is a pytree (a tensor or numpy array, or a dict, list or
tuple of them) of global arrays whose leading axis is rows, padded to a
multiple of the data axis (``mesh.padded_len``). Every process of a
mesh across processes passes the same global arrays and maps only the
shards it owns. No model calls these: the growers reduce inline, as the
JAX ones do; the combinator is the parity point with the reference's
one-primitive compute model.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from h2o3_tpu_torch.parallel import collectives
from h2o3_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, current_mesh,
                                          on_device, partitioner)

_REDUCERS = ("sum", "max", "min")


def _flatten(tree):
    """(leaves, rebuild) of a pytree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]

        def rebuild(leaves):
            out, at = {}, 0
            for k, (lv, rb) in zip(keys, parts):
                out[k] = rb(leaves[at:at + len(lv)])
                at += len(lv)
            return out
        return [x for lv, _ in parts for x in lv], rebuild
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(t) for t in tree]
        kind = type(tree)

        def rebuild(leaves):
            out, at = [], 0
            for lv, rb in parts:
                out.append(rb(leaves[at:at + len(lv)]))
                at += len(lv)
            return kind(out)
        return [x for lv, _ in parts for x in lv], rebuild
    return [tree], lambda leaves: leaves[0]


def _shard_inputs(arrays, mesh: Mesh):
    """Per local shard, the pytree of its row blocks."""
    leaves, rebuild = _flatten(arrays)
    part = partitioner(mesh)
    blocks = [part.shard_rows(x) for x in leaves]
    return [rebuild([b[j] for b in blocks])
            for j in range(len(mesh.local_shards))]


def _shard_device(x) -> torch.device:
    return _flatten(x)[0][0].device


def _map(map_fn, shard_trees) -> List[Any]:
    outs = []
    for st in shard_trees:
        with on_device(_shard_device(st)):
            outs.append(map_fn(st))
    return outs


def map_reduce(map_fn: Callable, arrays, reduce_op: str = "sum",
               mesh: Optional[Mesh] = None, donate: bool = False):
    """Run ``map_fn`` over each data shard of ``arrays`` and reduce the
    per-shard results (a pytree of tensors) with ``reduce_op``. Returns
    the reduced pytree on the lead shard's device. ``donate`` is the
    JAX signature's and changes nothing here."""
    mesh = mesh or current_mesh()
    if reduce_op not in _REDUCERS:
        raise ValueError(f"reduce_op must be one of {_REDUCERS}, got "
                         f"{reduce_op!r}")
    outs = _map(map_fn, _shard_inputs(arrays, mesh))
    per_shard = [_flatten(o)[0] for o in outs]
    rebuild = _flatten(outs[0])[1]
    reduced = [collectives.preduce([p[i] for p in per_shard], reduce_op,
                                   mesh, lead_only=True)[0]
               for i in range(len(per_shard[0]))]
    return rebuild(reduced)


def map_cols(map_fn: Callable, arrays, out_specs=None,
             mesh: Optional[Mesh] = None):
    """Elementwise map over the data shards producing new row-sharded
    outputs (a pytree of [rows_shard, ...] tensors), returned as global
    arrays in row order on the lead shard's device. ``out_specs`` as in
    the JAX signature: only the row sharding (``('data',)``) is
    served."""
    mesh = mesh or current_mesh()
    if out_specs not in (None, (DATA_AXIS,), DATA_AXIS):
        raise ValueError(f"map_cols produces row-sharded outputs; "
                         f"out_specs {out_specs!r} is not served")
    outs = _map(map_fn, _shard_inputs(arrays, mesh))
    per_shard = [_flatten(o)[0] for o in outs]
    rebuild = _flatten(outs[0])[1]
    cols = []
    for i in range(len(per_shard[0])):
        blocks = collectives.all_gather([p[i] for p in per_shard], mesh)
        cols.append(torch.cat(blocks, dim=0))
    return rebuild(cols)
