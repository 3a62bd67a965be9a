"""BLAS-1 vector primitives (reference ``src/math.rs:4-82``).

The reference implements 8 sequential scalar ops over ``[f64]`` slices;
here each is one torch expression on the tensors' device.  The solver's
hot path does not call them (the fused kernels compute what it needs);
they serve the composed and generic-objective paths.  On a mesh
(``collective.kernels_on_mesh``) the vectors are this rank's shards, and
``dot`` (with ``norm2`` and ``norm2inv``) adds the shards' products over
the ranks in one collective, as GSPMD partitions the JAX package's
reductions (``tests/test_sharding.py::test_sharded_dot_reduction``);
``dots`` takes several products in one.
"""

from __future__ import annotations

import torch

from .collective import mesh_sum


def axpy(y: torch.Tensor, x: torch.Tensor, c) -> torch.Tensor:
    """y + c*x  (reference ``vecadd``, src/math.rs:33-37)."""
    return y + c * x


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x . y  (reference ``vecdot``, src/math.rs:40-42)."""
    return mesh_sum(torch.dot(x, y))[0]


def dots(*pairs: tuple) -> tuple:
    """The dot products of the (x, y) ``pairs``, summed over the mesh in one
    collective."""
    return mesh_sum(*(torch.dot(x, y) for x, y in pairs))


def scale(y: torch.Tensor, c) -> torch.Tensor:
    """c*y  (reference ``vecscale``, src/math.rs:45-49)."""
    return y * c


def copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of x (reference ``veccpy``, src/math.rs:52-56)."""
    return x.clone()


def ncopy(x: torch.Tensor) -> torch.Tensor:
    """-x  (reference ``vecncpy``, src/math.rs:59-63)."""
    return -x


def diff(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x - y  (reference ``vecdiff``, src/math.rs:66-70)."""
    return x - y


def norm2(x: torch.Tensor) -> torch.Tensor:
    """||x||_2  (reference ``vec2norm``, src/math.rs:73-76)."""
    return torch.sqrt(dot(x, x))


def norm2inv(x: torch.Tensor) -> torch.Tensor:
    """1/||x||_2  (reference ``vec2norminv``, src/math.rs:79-81)."""
    return 1.0 / norm2(x)
