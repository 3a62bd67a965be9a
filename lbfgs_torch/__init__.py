"""lbfgs_torch — limited-memory quasi-Newton on PyTorch, with hand-written
kernels for NVIDIA Hopper.

A port of ``lbfgs_tpu`` (same builder API, same module names, the same
status codes and reference semantics as the Rust crate rust-lbfgs).  The
solver runs on whatever device the starting point lies on: on a CUDA
tensor every fused pass of an iteration is a hand-written kernel (Triton
for the objective-bearing passes, CUDA C++ for the direction combine), on
a CPU tensor the kernels' plain torch versions run.

Quick start (mirrors the reference crate doc-example, ``src/lib.rs:8-53``)::

    import torch
    from lbfgs_torch import lbfgs, default_evaluate, default_progress
    from lbfgs_torch.models.rosenbrock import initial_point

    x0 = initial_point(100, device="cuda")
    report = (
        lbfgs()
        .with_max_iterations(5)
        .minimize(x0, default_evaluate(), default_progress())
    )
    print(report.fx)

OWL-QN (L1 on a window of the vector) runs the same way, through the
backtracking search and its own kernels::

    report = lbfgs().with_orthantwise(1.0, 0, 99).minimize(x0, default_evaluate())

Powell damping (also under OWL-QN, and with ``with_damping_fixed()``) and
the gradient-only mode of the chemistry workload::

    report = lbfgs().with_damping(True).minimize_jit(x0, default_evaluate())

    from lbfgs_torch.models import lennard_jones
    report = lbfgs().with_gradient_only().minimize(
        lennard_jones.lj38_positions(device="cuda"), lennard_jones.make_objective())

L1-regularized Poisson regression (the reference's OWL-QN workload), a
generic objective whose two products with X are ``torch.matmul``, and
the wide objective scalar, which carries fx in float64 over float32
vectors where float32 cannot resolve the line search's decrease::

    from lbfgs_torch.models import logistic
    X, y = logistic.synthetic(2048, 1 << 20, seed=0, device="cuda")
    report = (lbfgs().with_fx_wide().with_orthantwise(1.0, 1, 1 << 20)
              .with_linesearch_algorithm("BacktrackingArmijo")
              .minimize_jit(torch.zeros(1 << 20, device="cuda"),
                            logistic.make_objective(X, y)))

Wherever the step is not capped (``with_constrain_step_size(False)``), a
factory objective's direction combine also probes the next search at its
entry step (the combine+probe fusion K15, under OWL-QN K16), so that
search's first trip costs no launch and no read.  The adaptive entry
step enters each uncapped search near the last accepted step::

    report = (lbfgs().with_orthantwise(1.0, 0, 99).with_constrain_step_size(False)
              .with_adaptive_entry_step(2.0).minimize(x0, default_evaluate()))

The models' data constructors make their tensors on the card unless
``device`` names another (``initial_point(100, device="cpu")`` runs the
plain versions on the CPU).

Ported so far: plain L-BFGS with the More-Thuente and the three
backtracking searches (Armijo, Wolfe, strong Wolfe), OWL-QN (through the
one-pass epilogue for factory objectives, through the composed kernels
for generic ones), Powell damping and gradient-only mode on every solver
branch, the wide objective scalar, the adaptive entry step, the
combine+probe fusions, the compact two-loop and the literal scan
two-loop (``with_compact_two_loop(False)``), bfloat16, float32 and
float16 histories (float16 through the composed pair + Gram pass and
combine, as the JAX package runs it), the step-at-a-time (``minimize``,
``LbfgsState``) and whole-run (``minimize_jit``) loops, the native C++
core (``minimize(..., backend="native")``, ``native``), checkpoints
(``utils.checkpoint``) and the pytree front end (``pytree_api``).  The
Poisson regression takes a bfloat16 X over float32 vectors.  Their CPU
tests hold each to ``lbfgs_tpu`` (``tests/test_torch_parity_slice.py``).
The speculative K-way backtracking search
(``with_speculative_linesearch(K)``, ``linesearch.backtracking_speculative``)
runs on every entry point, plain and under OWL-QN: each round one K-lane
candidate pass (K2 s, K8 s; on a generic objective ``torch.func.vmap``)
and one read, each search ending as the sequential Armijo ladder on the
same inputs.  The one-pass epilogue is off under it (K5's s = stp*d for
K4's x - xp), so in float32 its iterates are not the default sequential
run's.  Only fp8 histories raise ``NotImplementedError``.

Giant vectors shard over ``torch.distributed`` (``parallel``): one process
per GPU, each holding a contiguous slice of every [n] vector and of the
history rings, every kernel run on its slice with one all-reduce per
launch for its scalars::

    # torchrun --nproc_per_node=4 run.py
    from lbfgs_torch.parallel import (init_distributed, kernels_on_mesh, make_mesh,
                                      shard_vector)
    init_distributed()                  # NCCL on GPUs (gloo on the CPU)
    mesh = make_mesh()
    with kernels_on_mesh(mesh):
        report = lbfgs().minimize_jit(shard_vector(initial_point(1 << 26), mesh),
                                      default_evaluate())
    # report.x is this rank's slice; fx, the norms and the counts are global

The objectives built by ``ops.factory.make_fused_objective`` run sharded
(Rosenbrock and the separable models), and so does a generic objective
that keeps the local contract (``parallel.local_objective``): handed this
rank's shard, it returns the whole vector's fx, the same bits on every rank
(its partial summed with ``parallel.mesh_sum``), and the shard's gradient.
``models.rosenbrock.generic_value_and_grad`` and the Poisson regression
(``models.logistic.make_objective`` over this rank's column block of X,
``parallel.shard_vector``) keep it.  Checkpoints save and load on a mesh,
each rank its own element range, and move between world sizes
(``utils.checkpoint``).  On a mesh a generic objective without the
contract, the native backend and the batched runner raise
``NotImplementedError``.

The user programs are ``examples/*_torch.py`` (the sample run, LJ38, the
OWL-QN Poisson fit, wide-fx OWL-QN, the factory's separable objectives and
the sharded giant vector, under ``torchrun``): each runs on the card, or
on the CPU with ``--device cpu``.

Scenario batches (``Lbfgs.minimize_batched``, ``batched``): B independent
instances of one objective as a [B, n] tensor, advanced together
with one batched launch per pass (K2 b, K4 b, K3 b; under OWL-QN K8 b,
K14 b, K13 b and K10 b at the init; with the step uncapped the
combine+probe fusions K15 b and K16 b in place of K3 b and K13 b; damped,
K4 b and K14 b with their . gp columns and K6 b or K15 b's fix form)::

    out = lbfgs().minimize_batched(x0_batch, rosenbrock.value_and_grad)
    out["fx"], out["niter"], out["x"]
    out = lbfgs().with_orthantwise(1.0, 0, None).minimize_batched(x0_batch, fn)
    out = lbfgs().with_constrain_step_size(False).with_adaptive_entry_step(2.0) \
        .minimize_batched(x0_batch, fn)
    out = lbfgs().with_gradient_only().minimize_batched(x0_batch, fn)

It runs plain L-BFGS with More-Thuente or the backtracking searches, and
OWL-QN with backtracking (More-Thuente routed to it), the step capped or
not, with the literal or the adaptive entry step, at any history depth
(above ``ops.factory.MAX_M`` ring rows the deep forms of K4 b, K14 b,
K15 b and K16 b), with Powell damping (``damping_fixed`` too) and in the
gradient-only mode, on factory objectives and on generic ones.  A
generic objective (value-and-grad or scalar, e.g. the Poisson
regression) is evaluated over the batch by ``torch.func.vmap``: each
trip materializes the trial points (K9 b under OWL-QN), each iteration
takes K12 b (under OWL-QN) or a torch pass for the pair and K3 b or K13 b
for the combine, and the OWL-QN init K11 b::

    out = lbfgs().with_orthantwise(1.0, 1, ncol).minimize_batched(
        torch.zeros(16, ncol, device="cuda"), logistic.make_objective(X, y))

A mutating closure ``f(x, g)`` and an objective ``torch.func.vmap``
cannot trace raise ``ValueError``, as the JAX package's vmap refuses
them.  The wide objective scalar (fx float64 [B]; the init one K1 b, under
OWL-QN K7 b), the scan two-loop and a float16 history run batched too,
with OWL-QN and without, damped or not: where no batched epilogue runs
(the scan, a float16 ring, an objective with a fused trial but no
epilogue) each iteration materializes the accepted points with one K1 b
(K7 b), then the scan's torch recursion, the composed torch pair + Gram
pass and combine of a float16 ring, or K5 b (K12 b under OWL-QN) and the
combine kernels.  The speculative search runs batched as the JAX runner
runs it: one K2 b s (K8 b s) a round over the running instances, then
that route (K1 b or K7 b, K5 b or K12 b).  Only a mesh raises
``NotImplementedError`` there.
"""

from __future__ import annotations

from .core import ProblemDef, Progress, Report
from .orthantwise import Orthantwise
from .params import Lbfgs, LbfgsParams, LineSearchAlgorithm, LineSearchParams, lbfgs
from .status import LbfgsError, Status

__version__ = "0.1.0"


def default_evaluate():
    """Extended-Rosenbrock objective (reference ``default_evaluate``,
    ``src/lib.rs:79-94``)."""
    from .models.rosenbrock import value_and_grad

    return value_and_grad


def default_progress():
    """Printing progress monitor (reference ``default_progress``,
    ``src/lib.rs:102-112``). Returning True cancels the optimization."""

    def progress(prgr: Progress) -> bool:
        print(f"Iteration {prgr.niter}, Evaluation {prgr.neval}:")
        print(
            f" fx = {prgr.fx:-12.6f} xnorm = {prgr.xnorm:-12.6f}, "
            f"gnorm = {prgr.gnorm:-12.6f}, ls = {prgr.ncall}, step = {prgr.step}"
        )
        return False

    return progress


__all__ = [
    "Lbfgs",
    "LbfgsError",
    "LbfgsParams",
    "LineSearchAlgorithm",
    "LineSearchParams",
    "Orthantwise",
    "ProblemDef",
    "Progress",
    "Report",
    "Status",
    "default_evaluate",
    "default_progress",
    "lbfgs",
]
