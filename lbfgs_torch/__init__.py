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

Ported so far: plain L-BFGS with the More-Thuente and the three
backtracking searches (Armijo, Wolfe, strong Wolfe), OWL-QN (through the
one-pass epilogue for factory objectives, through the composed kernels
for generic ones), Powell damping and gradient-only mode on every solver
branch, the wide objective scalar, the compact two-loop, the
step-at-a-time (``minimize``, ``LbfgsState``) and whole-run
(``minimize_jit``) loops.  The scan two-loop, the speculative search, the
adaptive entry step, fp8 and float16 histories, and the batched and
native runners raise ``NotImplementedError``.
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
