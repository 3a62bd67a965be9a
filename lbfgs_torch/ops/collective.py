"""The mesh the kernels run on, and the one collective of a launch.

Under ``kernels_on_mesh(mesh)`` (``lbfgs_tpu/ops/fused.py:397-429``) every
[n] vector a kernel wrapper is handed is this process's contiguous shard
of the whole vector (``parallel.shard_vector``), and every [m, n] ring its
[m, n_local] slice; every rank holds a shard of the same length.  Each
wrapper runs its kernel (or its plain version) on the shard, sums its
partials locally in their fixed order, and hands the launch's scalars to
``mesh_sum``, which adds them across the ranks in ONE all-reduce: the
counterpart of the JAX package's psum inside ``shard_map``.  The [m]-sized
algebra and the host's line search then run replicated, and bit for bit
the same on every rank, since every rank reads the same reduced bits.

A generic objective (one without the factory's fused kernels) runs on a
mesh under the LOCAL CONTRACT, which it declares with ``local_objective``
(the ``__lbfgs_local__`` marker): handed this rank's shard of x, it returns
the whole vector's fx, the same bits on every rank (its shard's partial
added over the ranks, e.g. by ``mesh_sum``), and this shard's gradient.
The solver then treats that fx as it treats a kernel's reduced scalars.
An objective without the marker is refused on a mesh: a function of the
whole vector handed a shard would return a wrong fx silently.

With no mesh active every helper here is the identity, so a run outside
``kernels_on_mesh`` is the single-process run bit for bit.  The mesh
object is duck-typed (``parallel.sharding.Mesh``): ``size``, ``rank`` and
``all_reduce(tensor)``, which reduces in place and counts the call.

This module imports torch only, so every other module of the package
(``vecmath``, ``orthantwise``) can reach the mesh without a cycle.
"""

from __future__ import annotations

import torch

_ACTIVE_MESH: list = []


class kernels_on_mesh:
    """Context manager: the kernels and the solver's reductions run on the
    shards of ``mesh`` inside.  ::

        with kernels_on_mesh(mesh):
            st = minimize_jit(params, shard_vector(x0, mesh), objective)
    """

    def __init__(self, mesh):
        self._mesh = mesh

    def __enter__(self):
        _ACTIVE_MESH.append(self._mesh)
        return self._mesh

    def __exit__(self, *exc):
        _ACTIVE_MESH.pop()
        return False


def active_mesh():
    """The mesh the kernels run on, or None."""
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else None


def shard_offset(n_local: int) -> int:
    """The global index of this rank's first element, for a shard of
    ``n_local`` elements (0 with no mesh)."""
    mesh = active_mesh()
    return 0 if mesh is None else mesh.rank * n_local


def global_length(n_local: int) -> int:
    """The whole vector's length, for a shard of ``n_local`` elements."""
    mesh = active_mesh()
    return n_local if mesh is None else mesh.size * n_local


def local_window(start: int, end: int, n_local: int) -> tuple[int, int]:
    """The global OWL-QN window [start, end) in the shard's own indices
    (``start - off``, ``end - off``, clipped to the shard), as the JAX
    dispatchers translate it (``lbfgs_tpu/ops/fused.py:537-539``); it may
    be empty.  The window itself with no mesh."""
    off = shard_offset(n_local)
    if not off:
        return int(start), int(end)
    return min(max(start - off, 0), n_local), min(max(end - off, 0), n_local)


def mesh_sum(*vals: torch.Tensor) -> tuple:
    """The sums over the ranks of a launch's scalars (0-d or small
    tensors, bool counts for "any"), in one collective: they are packed
    into one tensor (float64 where any of them is, else float32, which
    holds every float32 value and count exactly), all-reduced, and handed
    back each in its own shape and dtype, a bool as "true on any rank".
    With no mesh the values come back as they are."""
    mesh = active_mesh()
    if mesh is None:
        return vals
    wide = any(v.dtype == torch.float64 for v in vals)
    dt = torch.float64 if wide else torch.float32
    flat = torch.cat([v.reshape(-1).to(dt) for v in vals])
    mesh.all_reduce(flat)
    out, i = [], 0
    for v in vals:
        piece = flat[i:i + v.numel()].reshape(v.shape)
        out.append(piece > 0 if v.dtype == torch.bool else piece.to(v.dtype))
        i += v.numel()
    return tuple(out)


#: the marker of an objective that keeps the local contract
LOCAL = "__lbfgs_local__"


def local_objective(fn):
    """Declare that the value-and-grad objective ``fn`` keeps the local
    contract on a mesh: called on this rank's shard of x (every [n] vector
    a kernel sees is one), it returns (fx, g) with fx the WHOLE vector's
    objective, the same bits on every rank (e.g. its shard's partial summed
    by ``mesh_sum``, which is the identity with no mesh), and g this
    shard's gradient.  Returns ``fn`` itself, marked (``__lbfgs_local__``)
    and taken as a value-and-grad function, or a marked wrapper where
    ``fn`` takes no attributes.  Usable as a decorator."""
    try:
        setattr(fn, LOCAL, True)
        fn.__lbfgs_value_and_grad__ = True
        return fn
    except AttributeError:
        def wrapped(x):
            return fn(x)

        wrapped.__qualname__ = getattr(fn, "__qualname__", repr(fn))
        return local_objective(wrapped)


def keeps_local_contract(fn) -> bool:
    """Whether ``fn`` declared the local contract (``local_objective``)."""
    return bool(getattr(fn, LOCAL, False))
