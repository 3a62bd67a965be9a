"""The giant-vector regime over ``torch.distributed``
(``lbfgs_tpu/parallel/sharding.py``).

One process per GPU (SPMD), launched by ``torchrun`` or
``torch.multiprocessing.spawn``; there is no single controller.  Each rank
holds a contiguous slice of every [n] vector and the matching [m,
n_local] slice of both history rings, and runs the same kernels on its
slice; each launch's scalar partials are combined by one all-reduce
(``ops.collective.mesh_sum``).  The [m]-sized algebra and the host line
search then run replicated, bit for bit the same on every rank.

Usage (one process per GPU, e.g. ``torchrun --nproc_per_node=4 run.py``)::

    init_distributed()                     # NCCL on GPUs, gloo on the CPU
    mesh = make_mesh()
    x0 = shard_vector(x0_full, mesh)       # this rank's [n / size] slice
    with kernels_on_mesh(mesh):
        report = lbfgs().minimize_jit(x0, objective)
    x = gather_vector(report.x, mesh)      # for a report only

A generic objective runs there under the local contract
(``ops.collective.local_objective``): it gets this rank's shard and returns
the whole vector's fx, the same on every rank, and the shard's gradient.
Checkpoints save and load on the mesh, each rank its own element range
(``utils.checkpoint``).

The whole vector is never gathered inside a run: ``gather_vector`` counts
its calls on the mesh (``Mesh.gathers``) beside the collectives
(``Mesh.collectives``, ``Mesh.collective_bytes``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..core import SolverState, as_ring, ring_zeros

AXIS = "shard"


def init_distributed(backend: Optional[str] = None, device=None, **kwargs) -> None:
    """``torch.distributed.init_process_group`` for a mesh: NCCL where CUDA
    is present, gloo on the CPU, ``init_method="env://"`` (what
    ``torchrun`` sets) unless ``kwargs`` name another.  Sets the rank's
    CUDA device first, ``device`` or ``cuda:LOCAL_RANK``, where CUDA is
    present.  A failed NCCL init raises: nothing falls back to the CPU."""
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        torch.cuda.set_device(torch.device(device) if device is not None
                              else torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))))
    kwargs.setdefault("init_method", "env://")
    dist.init_process_group(backend=backend, **kwargs)


@dataclasses.dataclass(eq=False)
class Mesh:
    """A 1-D mesh of ranks over the vector axis (``AXIS``): the process
    group, its size, this rank and the rank's device, with counts of the
    collectives run through it."""

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int
    device: torch.device
    #: all-reduces, and the bytes they carried
    collectives: int = 0
    collective_bytes: int = 0
    #: [n]-vector gathers (``gather_vector``): none may run inside a run
    gathers: int = 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks in place (one collective, counted)."""
        self.collectives += 1
        self.collective_bytes += t.numel() * t.element_size()
        dist.all_reduce(t, group=self.group)
        return t

    def reset_counts(self) -> None:
        self.collectives = self.collective_bytes = self.gathers = 0


def make_mesh(group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The mesh of ``group`` (the default group when None) after
    ``init_distributed``, on the current CUDA device where CUDA is
    present, else on the CPU."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(group=group, size=dist.get_world_size(group), rank=dist.get_rank(group),
                device=device)


def _split(n: int, mesh: Mesh) -> int:
    if n % mesh.size:
        raise ValueError(f"n={n} does not split evenly over {mesh.size} ranks")
    return n // mesh.size


def shard_vector(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along its last axis (an [n]
    vector, an [m, n] ring, or an [nrow, n] design matrix, whose column
    block multiplies this rank's shard of an [n] vector: the Poisson
    regression's X under the local contract), as a contiguous tensor of its
    own on the mesh's device.  n must split evenly over the ranks (pad
    upstream)."""
    k = _split(x.shape[-1], mesh)
    return x.narrow(-1, mesh.rank * k, k).to(mesh.device, copy=True).contiguous()


def gather_vector(x_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole vector from every rank's shard, on every rank: for
    reports and tests only, never inside an iteration (counted in
    ``mesh.gathers``)."""
    mesh.gathers += 1
    # as raw bytes, so any dtype (a bfloat16 ring too) travels as it is
    raw = x_local.contiguous().view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(mesh.size)]
    dist.all_gather(parts, raw, group=mesh.group)
    return torch.cat(parts, dim=-1).view(x_local.dtype)


#: the state's fields split over the ranks on their last (n) axis: the [n]
#: vectors of ``ProblemState`` and the rings of ``History``; everything else
#: is replicated
VECTORS, RINGS = ("x", "gx", "xp", "gp", "pg", "d"), ("s", "y")


def _map_state(st: SolverState, vec, ring) -> SolverState:
    """``st`` with ``vec`` applied to its [n] vectors (a slot that is None
    stays None) and ``ring`` to its rings; the [m] stacks, the [m, m] Gram
    blocks and the host scalars are kept (the counterpart of
    ``state_shardings``, ``lbfgs_tpu/parallel/sharding.py:71-92``)."""
    p, h = st.prob, st.hist
    opt = lambda t: None if t is None else vec(t)
    prob = p._replace(**{f: opt(getattr(p, f)) for f in VECTORS})
    return st._replace(prob=prob, hist=h._replace(**{f: ring(getattr(h, f)) for f in RINGS}))


def shard_ring(R: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of an [m, n] ring on the mesh's device, in the
    ring's padded layout for the shard's own width k (``core.ring_zeros``),
    copied once."""
    k = _split(R.shape[-1], mesh)
    return ring_zeros((*R.shape[:-1], k), R.dtype, mesh.device).copy_(
        R.narrow(-1, mesh.rank * k, k))


def shard_state(st: SolverState, mesh: Mesh) -> SolverState:
    """This rank's shard of a whole ``SolverState``: the [n] fields and the
    ring rows sliced on the n axis, onto the mesh's device (the rings in
    their padded layout for the shard's width); the [m] stacks, the Gram
    blocks and the scalars replicated (moved with it)."""
    st = _map_state(st, lambda t: shard_vector(t, mesh), lambda R: shard_ring(R, mesh))
    h = st.hist
    rep = lambda t: t.to(mesh.device)
    return st._replace(hist=h._replace(ys=rep(h.ys), alpha=rep(h.alpha), sy=rep(h.sy),
                                       yy=rep(h.yy)))


def gather_state(st: SolverState, mesh: Mesh) -> SolverState:
    """The whole ``SolverState`` from every rank's shard (on every rank),
    for reports, checkpoints and tests; the rings in the padded layout of
    the whole width (``core.as_ring``)."""
    return _map_state(st, lambda t: gather_vector(t, mesh),
                      lambda R: as_ring(gather_vector(R, mesh)))
