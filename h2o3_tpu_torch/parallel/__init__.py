"""The mesh, its collectives and the compute combinator (ROADMAP item
14): the port's counterpart of ``h2o3_tpu/parallel``."""
from h2o3_tpu_torch.parallel.map_reduce import map_cols, map_reduce
from h2o3_tpu_torch.parallel.mesh import (current_mesh, data_sharding,
                                          make_mesh, replicated_sharding,
                                          set_mesh)

__all__ = [
    "current_mesh",
    "data_sharding",
    "make_mesh",
    "replicated_sharding",
    "set_mesh",
    "map_reduce",
    "map_cols",
]
