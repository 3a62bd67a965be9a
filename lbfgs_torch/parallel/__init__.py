"""Sharding for the giant-vector regime over ``torch.distributed``
(``lbfgs_tpu/parallel``): see ``sharding``."""

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
    "kernels_on_mesh",
    "make_mesh",
    "shard_state",
    "shard_vector",
]
