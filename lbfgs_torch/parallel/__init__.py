"""Sharding for the giant-vector regime over ``torch.distributed``
(``lbfgs_tpu/parallel``): see ``sharding``.  A generic objective runs on
the mesh under the local contract (``local_objective``; ``ops.collective``):
it gets this rank's shard and returns the whole fx, reduced with
``mesh_sum``, and the shard's gradient; ``shard_vector`` of a design
matrix is its column block for such an objective."""

from ..ops.collective import keeps_local_contract, local_objective, mesh_sum
from ..ops.fused import kernels_on_mesh
from .sharding import (
    AXIS,
    Mesh,
    gather_state,
    gather_vector,
    init_distributed,
    make_mesh,
    shard_state,
    shard_vector,
)

__all__ = [
    "AXIS",
    "Mesh",
    "gather_state",
    "gather_vector",
    "init_distributed",
    "keeps_local_contract",
    "kernels_on_mesh",
    "local_objective",
    "make_mesh",
    "mesh_sum",
    "shard_state",
    "shard_vector",
]
