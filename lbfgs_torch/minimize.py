"""Optimization entry points.

  * ``minimize`` / ``LbfgsState`` — a host loop of one ``propagate`` per
    iteration with Progress callbacks and cancellation; parity with the
    reference's ``Lbfgs::minimize`` and its build/propagate/report state
    machine (``src/lbfgs.rs:399-421, 443-499``).  Keeps the previous point
    so a failed line search reverts the vectors as the reference does.
  * ``minimize_jit`` — the whole run in one loop (``_run_while``) over the
    LEAN state: no previous-point slots, the epilogue kernel writes each
    accepted point over the last one, and a line-search failure ends the
    run.  The name is the JAX package's, so the API reads the same.

Inside ``parallel.kernels_on_mesh(mesh)`` each entry point takes this
rank's shard of x0 (``parallel.shard_vector``) and returns the shard of
x, as the JAX package's ``with kernels_on_mesh(mesh): minimize_jit(...)``
does; every other value of a state or report is the whole run's, the
same on every rank.  The native backend raises there, as do generic
objectives (``solver.check_supported``).

Fatal statuses raise ``LbfgsError``, mirroring the reference's ``anyhow``
error propagation out of ``propagate``.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch

from .core import (
    ProblemDef,
    Progress,
    Report,
    SolverState,
    _required_positional,
    gnorm_of,
    normalize_objective,
    pseudo_gradient,
    xnorm_of,
)
from .ops.collective import active_mesh
from .params import LbfgsParams
from .solver import init_state, propagate_hot, start_state, stop_status
from .status import LS_ERROR_MESSAGES, LbfgsError, Status, is_fatal, is_ls_error

logger = logging.getLogger("lbfgs_torch")


def _log_stop_status(code: int) -> None:
    """Reference-parity log lines for the stop conditions
    (``src/lbfgs.rs:717, 730, 743, 778``)."""
    if code == Status.CONVERGED:
        logger.info("L-BFGS reaches convergence.")
    elif code == Status.MAX_ITERATIONS:
        logger.warning("max iterations reached!")
    elif code == Status.MAX_EVALUATIONS:
        logger.warning("Max allowed evaluations reached!")


def _make_pdef(evaluate: Callable, params: LbfgsParams) -> ProblemDef:
    return ProblemDef(value_and_grad=normalize_objective(evaluate),
                      owlqn=params.orthantwise)


def _report(st: SolverState) -> Report:
    return Report(
        fx=np.float64(st.prob.fx),
        xnorm=float(xnorm_of(st.prob)),
        gnorm=float(gnorm_of(st.prob)),
        neval=st.prob.neval,
        x=st.prob.x,
        niter=st.k,
        status=st.status,
        damping_cases=st.damping_cases,
    )


class LbfgsState:
    """Resumable step-at-a-time optimizer state (reference ``LbfgsState``,
    ``src/lbfgs.rs:424-499``); the full state is the ``SolverState`` in
    ``.state``."""

    def __init__(self, pdef: ProblemDef, params: LbfgsParams, state: SolverState):
        self.pdef = pdef
        self.params = params
        self.state = state

    @classmethod
    def build(cls, params: LbfgsParams, x0: torch.Tensor, evaluate: Callable) -> "LbfgsState":
        """Initial evaluation + direction (``Lbfgs::build``, src/lbfgs.rs:443-481)."""
        pdef = _make_pdef(evaluate, params)
        return cls(pdef, params, init_state(pdef, params, x0))

    def restore(self, state: SolverState) -> None:
        """Swap in a saved ``SolverState``."""
        self.state = state

    # -- reference API ------------------------------------------------------

    def is_converged(self) -> bool:
        """Stop-conditions check on the current state (``src/lbfgs.rs:489-494``)."""
        code = stop_status(self.params, self.state)
        if code != Status.RUNNING and self.state.status == Status.RUNNING:
            self.state = self.state._replace(status=code)
        if code != Status.RUNNING:
            _log_stop_status(code)
        return code != Status.RUNNING

    def propagate(self) -> Progress:
        """One L-BFGS step; returns per-iteration Progress
        (``src/lbfgs.rs:503-560``).  Raises ``LbfgsError`` on fatal status."""
        if self.state.k == 0:
            # k == 1 reports the initial point without searching
            # (src/lbfgs.rs:507-510)
            self.state = start_state(self.state, self.params)
        else:
            self.state = propagate_hot(self.pdef, self.params, self.state)
            ls_code = self.state.ls_status
            if is_ls_error(ls_code):
                # the reference logs at the failure site before reverting
                # (src/line.rs:213-220)
                logger.error("line search failed, revert to the previous point!")
                logger.error("%s", LS_ERROR_MESSAGES.get(Status(ls_code), ls_code))
            if ls_code != 0:
                # vector revert (reference Problem::revert, src/core.rs:201-210),
                # the pseudo-gradient with them under OWL-QN (pg is a
                # function of (x, g): recomputed by K11, as the JAX package
                # does, lbfgs_tpu/minimize.py:136-139); the carried scalars
                # were reverted inside propagate.  The combine+probe slot
                # keeps what that propagate computed, as the JAX package's
                # revert leaves it: the failure is fatal, no search reads it
                st = self.state
                prob = st.prob._replace(x=st.prob.xp, gx=st.prob.gp)
                if self.pdef.orthantwise:
                    prob = prob._replace(pg=pseudo_gradient(self.pdef, prob.x, prob.gx))
                self.state = st._replace(prob=prob)
        if is_fatal(self.state.status):
            raise LbfgsError(Status(self.state.status))
        return self.get_progress()

    def get_progress(self) -> Progress:
        st = self.state
        return Progress(
            x=st.prob.x,
            gx=st.prob.gx,
            fx=np.float64(st.prob.fx),
            xnorm=float(xnorm_of(st.prob)),
            gnorm=float(gnorm_of(st.prob)),
            step=float(st.step_ls),
            niter=st.k,
            neval=st.prob.neval,
            ncall=st.ncall,
        )

    def report(self) -> Report:
        """Final outcome (``src/lbfgs.rs:497-499``, ``src/core.rs:288-298``)."""
        return _report(self.state)


def minimize(
    params: LbfgsParams,
    x0: torch.Tensor,
    evaluate: Callable,
    progress: Optional[Callable[[Progress], bool]] = None,
    backend: str = "torch",
) -> Report:
    """Host loop (reference ``Lbfgs::minimize``, ``src/lbfgs.rs:399-421``):

      loop { if converged break; propagate; if progress(prgr) -> cancel }

    The progress callback returning True cancels the optimization.

    ``backend="native"`` routes to the sequential C++ core (``native``), a
    host core with no device: the choice for small problems, where launch
    latency dominates, and the reference-parity path.
    """
    if backend == "native":
        if active_mesh() is not None:
            raise NotImplementedError("the native backend on a mesh (it is one host core)")
        return _minimize_native_backend(params, x0, evaluate, progress)
    if backend != "torch":
        raise ValueError(f"unknown backend: {backend!r} (use 'torch' or 'native')")
    state = LbfgsState.build(params, x0, evaluate)
    logger.info("start lbfgs loop...")
    while True:
        if state.is_converged():
            break
        prgr = state.propagate()
        if progress is not None and progress(prgr):
            logger.info("The minimization process has been canceled.")
            state.state = state.state._replace(status=int(Status.CANCELLED))
            break
    return state.report()


def _minimize_native_backend(params: LbfgsParams, x0, evaluate: Callable,
                             progress: Optional[Callable] = None) -> Report:
    """Route to the native core (``lbfgs_tpu/minimize.py:208-249``),
    adapting the objective to its closure over the core's float64 buffers:
    a reference-style closure ``f(x, g) -> fx`` is passed through, handed
    CPU float64 tensors over those buffers (this package's closure
    convention); a one-argument objective is evaluated at such a tensor
    and its gradient copied back.  x0 is copied, never iterated in place."""
    from .native import minimize_native

    if _required_positional(evaluate) >= 2:
        def closure(x, g):
            return evaluate(torch.from_numpy(x), torch.from_numpy(g))
    else:
        vag = normalize_objective(evaluate)

        def closure(x, g):
            fx, gx = vag(torch.from_numpy(x))
            torch.from_numpy(g).copy_(gx)
            return float(fx)

    return minimize_native(params, x0, closure, progress)


# ---------------------------------------------------------------------------
# Whole-run loop
# ---------------------------------------------------------------------------


def _run_while(pdef: ProblemDef, params: LbfgsParams, st: SolverState) -> SolverState:
    """while !stop: propagate.  The k == 1 bookkeeping step runs once
    first, behind the same stop check the reference applies before every
    propagate (``src/lbfgs.rs:407-410``)."""

    def running(s: SolverState) -> bool:
        return s.status == Status.RUNNING and stop_status(params, s) == Status.RUNNING

    if running(st):
        st = start_state(st, params)
    while running(st):
        st = propagate_hot(pdef, params, st)
    if st.status == Status.RUNNING:
        # record why we stopped (fatal statuses already recorded by propagate)
        st = st._replace(status=stop_status(params, st))
    return st


def minimize_jit(
    params: LbfgsParams,
    x0: torch.Tensor,
    evaluate: Callable,
    return_state: bool = False,
):
    """The whole minimization in one loop over the lean state.

    Returns a ``Report`` (or the final ``SolverState`` when
    ``return_state``, which also does not raise on a fatal status).
    """
    pdef = _make_pdef(evaluate, params)
    st = _run_while(pdef, params, init_state(pdef, params, x0, lean=True))
    if return_state:
        return st
    if is_fatal(st.status):
        raise LbfgsError(Status(st.status))
    _log_stop_status(st.status)
    return _report(st)
