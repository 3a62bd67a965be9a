"""Solver state and the objective-evaluation boundary.

The reference ``Problem`` (``src/core.rs:10-218``) owns seven mutable
``f64`` vectors and an eval closure; here the vectors are tensors on the
run's device and the scalars the host decides on (fx, the carried norms,
the step, the counters and the status) are numpy scalars of the vectors'
dtype on the host (fx is float64 over float32 vectors under the wide
objective scalar, ``params.fx_wide``).  The line search runs on the host,
so keeping its inputs there costs no device reads; the few reads the
solver needs go through ``to_host``, which counts them.

The user-objective boundary (``Problem::evaluate``, ``src/core.rs:119-132``)
supports three shapes:

  * ``fn(x) -> (fx, gx)``        value-and-grad (canonical, fastest)
  * ``fn(x) -> fx``              scalar; gradient via ``torch.autograd``
  * ``fn(x, gx) -> fx``          reference-style closure that writes the
                                 gradient into ``gx`` in place
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import orthantwise as ow_ops
from .orthantwise import Orthantwise


class ProblemState(NamedTuple):
    """Optimization vectors (reference ``Problem``, ``src/core.rs:10-52``)."""

    x: torch.Tensor        #: current point                      [n]
    #: objective at x (host): the vectors' dtype, or float64 under the
    #: wide objective scalar (``params.fx_wide``)
    fx: np.floating
    gx: torch.Tensor       #: gradient at x                      [n]
    #: previous point / gradient.  ``None`` in the LEAN state of the
    #: whole-run loop, where a line-search failure is terminal, so the
    #: previous point is never observed and the epilogue kernel may write
    #: the accepted point over it in place.  The step-at-a-time loop
    #: keeps them for the reference's revert (``src/core.rs:201-210``).
    xp: Optional[torch.Tensor]
    gp: Optional[torch.Tensor]
    #: OWL-QN pseudo-gradient at x; ``None`` whenever OWL-QN is off (the
    #: reference keeps pg == gx then, ``src/core.rs:95-101``)
    pg: Optional[torch.Tensor]
    d: torch.Tensor        #: search direction                   [n]
    neval: int             #: total objective evaluations
    #: carried squared norms of the current gradient (pg under OWL-QN)
    #: and point, so the stop test (src/lbfgs.rs:714-722) reads no vector
    gnorm2: np.floating
    xnorm2: np.floating


class History(NamedTuple):
    """Circular (s, y) correction history, stored ``[m, n]``.

    ``sy``/``yy`` cache the Gram blocks of the Byrd-Nocedal-Schnabel
    compact representation (sy[i, j] = s_i . y_j in ring-slot indexing),
    updated by the epilogue's 6m products each iteration, so the compact
    two-loop never recomputes O(m^2 n) products.
    """

    s: torch.Tensor      #: position differences   [m, n]
    y: torch.Tensor      #: gradient differences   [m, n]
    ys: torch.Tensor     #: y_j . s_j              [m]
    alpha: torch.Tensor  #: two-loop alpha         [m]
    sy: torch.Tensor     #: Gram cache s_i . y_j   [m, m]
    yy: torch.Tensor     #: Gram cache y_i . y_j   [m, m]


class SolverState(NamedTuple):
    """Full resumable solver state (reference ``LbfgsState``,
    ``src/lbfgs.rs:424-439``)."""

    prob: ProblemState
    hist: History
    end: int              #: ring index of the newest correction pair
    step: np.floating     #: line-search entry step of the next iteration
    step_ls: np.floating  #: step accepted by the last line search
    k: int                #: iteration counter
    ncall: int            #: evaluations used by the last line search
    status: int           #: Status code
    #: internal status of the last line search (LS_* code, or 0)
    ls_status: int = 0
    #: fx ring of the (flag-gated) past/delta plateau test, [past] on the
    #: host; see ``solver.fx_delta_step``
    pf: Optional[np.ndarray] = None
    #: dginit = g . d of the next line search (src/core.rs:78-92), a free
    #: byproduct of the combine kernel
    dg0: Optional[np.floating] = None
    #: damped runs: how many iterations took no damping, case 1 and case 2
    #: (counted where the literal reference drops case 2's write-back too)
    damping_cases: tuple = (0, 0, 0)


def np_type(dtype: torch.dtype) -> type:
    """The numpy scalar type of a torch dtype (host scalars of a run)."""
    return np.dtype(str(dtype).removeprefix("torch.")).type


def to_host(*values: torch.Tensor) -> tuple:
    """Read 0-d device tensors to the host in ONE transfer, each as a
    numpy scalar of its own dtype (under the wide objective scalar fx is
    float64 beside float32 step scalars).  The transfer carries the
    widest floating dtype among them, which holds every value exactly (a
    bool as 0 or 1).  ``to_host.reads`` counts the transfers: each is a
    synchronisation point of the run."""
    to_host.reads += 1
    floats = {v.dtype for v in values if v.dtype.is_floating_point}
    dt = max(floats, key=lambda t: t.itemsize) if floats else torch.float64
    host = torch.stack([v.reshape(()).to(dt) for v in values]).cpu().numpy()
    return tuple(np_type(v.dtype)(h) for v, h in zip(values, host))


to_host.reads = 0


# ---------------------------------------------------------------------------
# Objective normalization
# ---------------------------------------------------------------------------

EvalFn = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class ProblemDef:
    """Problem definition handed to the solver."""

    value_and_grad: EvalFn
    owlqn: Optional[Orthantwise] = None

    @property
    def orthantwise(self) -> bool:
        return self.owlqn is not None


def _required_positional(fn: Callable) -> int:
    try:
        # REQUIRED positional parameters only: a 1-arg objective with
        # optional kwargs (def f(x, verbose=False)) must not be mistaken
        # for the reference-style mutating closure f(x, gx)
        return sum(
            1
            for p in inspect.signature(fn).parameters.values()
            if p.default is inspect.Parameter.empty
            and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        )
    except (TypeError, ValueError):
        return 1


def normalize_objective(fn: Callable) -> EvalFn:
    """Accept any of the three supported objective shapes; return an
    ``x -> (fx, gx)`` function."""
    if getattr(fn, "__lbfgs_value_and_grad__", False):
        return fn
    if _required_positional(fn) >= 2:
        def closure_vag(x):
            g = torch.zeros_like(x)
            fx = fn(x, g)
            return torch.as_tensor(fx, dtype=x.dtype, device=x.device), g

        return closure_vag

    # 1-arg: a scalar objective or a value-and-grad one, told apart by
    # what the first call returns
    kind = []

    def vag(x):
        if kind == ["value_and_grad"]:
            return fn(x)
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            out = fn(xg)
            if isinstance(out, (tuple, list)):
                kind[:] = ["value_and_grad"]
                fx, g = out
                return fx.detach(), g.detach()
            kind[:] = ["scalar"]
            (g,) = torch.autograd.grad(out, xg)
        return out.detach(), g

    return vag


def evaluate(pdef: ProblemDef, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One objective evaluation with the OWL-QN L1 term folded into fx
    (``Problem::evaluate``, src/core.rs:119-132, minus the
    pseudo-gradient, which callers compute only where needed).  Under the
    wide objective scalar fx comes back float64 (``lbfgs_tpu/core.py:
    251-272``)."""
    from .ops import fused

    fx, gx = pdef.value_and_grad(x)
    if isinstance(fx, torch.Tensor):
        fx = fused.obj_lift(fx, x.dtype)
    if pdef.owlqn is not None:
        fx = fx + ow_ops.x1norm(pdef.owlqn, x)
    return fx, gx


def pseudo_gradient_and_norm(pdef: ProblemDef, x: torch.Tensor,
                             gx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(pg, pg . pg) under OWL-QN in one pass: the objective's
    ``__lbfgs_pseudo_gradient_norm__`` when it has one (its ``.plain``
    twin runs the plain version), else K10 (``fused.pseudo_gradient_norm``)."""
    from .ops import fused

    fn = getattr(pdef.value_and_grad, "__lbfgs_pseudo_gradient_norm__",
                 fused.pseudo_gradient_norm)
    start, end = pdef.owlqn.start_end(x.shape[0])
    return fn(x, gx, pdef.owlqn.c, start, end)


def pseudo_gradient(pdef: ProblemDef, x: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """pg under OWL-QN, or gx itself otherwise (``src/core.rs:123-126``):
    the objective's ``__lbfgs_pseudo_gradient__`` when it has one, else
    K11 (``fused.pseudo_gradient``)."""
    if pdef.owlqn is None:
        return gx
    from .ops import fused

    fn = getattr(pdef.value_and_grad, "__lbfgs_pseudo_gradient__", fused.pseudo_gradient)
    start, end = pdef.owlqn.start_end(x.shape[0])
    return fn(x, gx, pdef.owlqn.c, start, end)


def gnorm_of(prob: ProblemState) -> np.floating:
    """||pg|| under OWL-QN, else ||gx||, from the carried squared norm
    (``src/core.rs:183-189``): the solver carries ||pg||^2 under OWL-QN."""
    return np.sqrt(prob.gnorm2)


def xnorm_of(prob: ProblemState) -> np.floating:
    """||x|| from the carried squared norm."""
    return np.sqrt(prob.xnorm2)


# ---------------------------------------------------------------------------
# Progress / Report (host-facing)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Progress:
    """Per-iteration snapshot handed to the progress callback
    (reference ``Progress``, ``src/core.rs:223-269``)."""

    x: torch.Tensor
    gx: torch.Tensor
    #: float64: exact for the wide objective scalar too
    fx: float
    xnorm: float
    gnorm: float
    step: float
    niter: int
    neval: int
    ncall: int


@dataclasses.dataclass
class Report:
    """Final optimization outcome (reference ``Report``, ``src/core.rs:273-299``),
    plus ``x``, ``niter``, ``status`` and the damping cases."""

    #: float64: exact for the wide objective scalar too
    fx: float
    xnorm: float
    gnorm: float
    neval: int
    x: torch.Tensor = None
    niter: int = 0
    status: int = 0
    #: iterations without damping, with case 1, with case 2 (damped runs)
    damping_cases: tuple = (0, 0, 0)
