"""Solver configuration: parameter dataclasses + chaining builder.

The reference's builder pattern (``LbfgsParam`` ``src/lbfgs.rs:72-177``
and the 15 ``with_*`` setters ``src/lbfgs.rs:194-383``; ``LineSearch``
params ``src/line.rs:91-163``), field for field the same as
``lbfgs_tpu.params``.  Some fields select features this package does not
run yet (the scan two-loop; speculation); ``solver.init_state`` raises
``NotImplementedError`` naming them.  Damping, damping_fixed,
gradient_only, fx_wide and the adaptive entry step run, plain and under
OWL-QN.

Defaults are the reference defaults, including the documented quirks:
``max_linesearch`` defaults to 20 (the reference docstring claims 40,
``src/line.rs:141-144`` vs ``:158``), and ``past``/``delta`` are accepted
but inert unless ``fx_delta_enabled`` is set (the reference's delta test is
dead code, ``src/lbfgs.rs:702``).
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from typing import Optional

from .orthantwise import Orthantwise

_logger = logging.getLogger("lbfgs_torch")


class LineSearchAlgorithm:
    """Line search algorithm names (``src/line.rs:40-81``)."""

    MoreThuente = "MoreThuente"
    BacktrackingArmijo = "BacktrackingArmijo"
    BacktrackingWolfe = "BacktrackingWolfe"
    BacktrackingStrongWolfe = "BacktrackingStrongWolfe"

    ALL = (MoreThuente, BacktrackingArmijo, BacktrackingWolfe, BacktrackingStrongWolfe)


@dataclasses.dataclass(frozen=True)
class LineSearchParams:
    """Line-search knobs, defaults per ``src/line.rs:150-163``."""

    algorithm: str = LineSearchAlgorithm.MoreThuente
    ftol: float = 1e-4
    gtol: float = 0.9
    xtol: float = sys.float_info.epsilon
    min_step: float = 1e-20
    max_step: float = 1e20
    max_linesearch: int = 20
    gradient_only: bool = False
    #: speculative K-way backtracking (1 = off, the reference-faithful
    #: sequential search); values above 1 are not ported yet
    speculative: int = 1
    #: log the reference's ascent-direction warning (``src/core.rs:78-92``)
    warn_ascent: bool = True


@dataclasses.dataclass(frozen=True)
class LbfgsParams:
    """All solver knobs, defaults per ``src/lbfgs.rs:156-177``."""

    m: int = 6
    epsilon: float = 1e-5
    past: int = 0
    delta: float = 1e-5
    max_iterations: int = 0
    max_evaluations: int = 0
    linesearch: LineSearchParams = dataclasses.field(default_factory=LineSearchParams)
    orthantwise: Optional[Orthantwise] = None
    initial_inverse_hessian: float = 1.0
    max_step_size: float = 1.0
    damping: bool = False
    constrain_step_size: bool = True

    # -- extensions (gated; defaults preserve reference behavior) --
    #: enable the (dead-in-reference) past/delta fx-plateau stop test
    fx_delta_enabled: bool = False
    #: apply the *intended* damping case-2 write-back (the reference computes
    #: the blend but drops it, src/lbfgs.rs:681-685)
    damping_fixed: bool = False
    #: use the Byrd–Nocedal–Schnabel compact two-loop (batched matvec) path
    compact_two_loop: bool = True
    #: storage dtype for the (s, y) correction history ("bfloat16" halves
    #: the history traffic, which dominates each iteration; reductions
    #: still accumulate in the vectors' dtype).  None keeps the history in
    #: the iterate's dtype (reference-faithful default)
    history_dtype: Optional[str] = None
    #: adaptive line-search entry step (0.0 = off, the reference-literal
    #: policy); not ported yet
    adaptive_entry_step: float = 0.0
    #: wide (f64) objective-scalar carry over f32 vectors; not ported yet
    fx_wide: bool = False

    def replace(self, **kw) -> "LbfgsParams":
        return dataclasses.replace(self, **kw)

    def replace_ls(self, **kw) -> "LbfgsParams":
        return self.replace(linesearch=dataclasses.replace(self.linesearch, **kw))


class Lbfgs:
    """Chaining builder mirroring the reference API (``src/lbfgs.rs:185-421``).

    Each ``with_*`` validates its argument with the same predicate the
    reference asserts, then returns a new builder (immutable, unlike the
    reference's move-self, but the chaining style is identical)::

        report = (
            lbfgs()
            .with_orthantwise(1.0, 0, 99)
            .with_epsilon(1e-4)
            .minimize(x0, evaluate, progress)
        )
    """

    def __init__(self, params: LbfgsParams | None = None):
        self.param = params or LbfgsParams()

    def _new(self, params: LbfgsParams) -> "Lbfgs":
        return Lbfgs(params)

    # -- setters, one per reference builder method --------------------------

    def with_epsilon(self, epsilon: float) -> "Lbfgs":
        assert epsilon >= 0.0, "Invalid parameter epsilon specified."
        return self._new(self.param.replace(epsilon=epsilon))

    def with_initial_step_size(self, b: float) -> "Lbfgs":
        assert b >= 0.0, "Invalid beta parameter for scaling the initial step size."
        return self._new(self.param.replace(initial_inverse_hessian=b))

    def with_max_step_size(self, s: float) -> "Lbfgs":
        assert s >= 0.0, "Invalid max_step_size parameter."
        return self._new(self.param.replace(max_step_size=s))

    def with_damping(self, damped: bool) -> "Lbfgs":
        return self._new(self.param.replace(damping=damped))

    def with_orthantwise(self, c: float, start: int, end: Optional[int]) -> "Lbfgs":
        assert c >= 0.0, "Invalid parameter orthantwise c parameter specified."
        # routing enforces backtracking for OWL-QN; same warning as the
        # reference emits at param-set time (src/lbfgs.rs:236)
        _logger.warning(
            "Only the backtracking line search is available for OWL-QN algorithm."
        )
        ow = Orthantwise(c=c, start=start, end=end)
        return self._new(self.param.replace(orthantwise=ow))

    def with_linesearch_ftol(self, ftol: float) -> "Lbfgs":
        assert ftol >= 0.0, "Invalid parameter ftol specified."
        # order-independent ftol < gtol cross-validation: the reference
        # only validates in the gtol setter (src/lbfgs.rs:258-266), so
        # setting ftol AFTER gtol could silently break the invariant
        assert ftol < self.param.linesearch.gtol, "Invalid parameter ftol specified."
        return self._new(self.param.replace_ls(ftol=ftol))

    def with_linesearch_gtol(self, gtol: float) -> "Lbfgs":
        assert (
            0.0 <= gtol < 1.0 and gtol > self.param.linesearch.ftol
        ), "Invalid parameter gtol specified."
        return self._new(self.param.replace_ls(gtol=gtol))

    def with_gradient_only(self) -> "Lbfgs":
        """Gradient-only mode: allow fx rises; implies Powell damping and the
        strong-Wolfe backtracking line search (``src/lbfgs.rs:283-289``)."""
        p = self.param.replace(damping=True)
        p = dataclasses.replace(
            p,
            linesearch=dataclasses.replace(
                p.linesearch,
                gradient_only=True,
                algorithm=LineSearchAlgorithm.BacktrackingStrongWolfe,
            ),
        )
        return self._new(p)

    def with_max_linesearch(self, n: int) -> "Lbfgs":
        return self._new(self.param.replace_ls(max_linesearch=n))

    def with_linesearch_xtol(self, xtol: float) -> "Lbfgs":
        assert xtol >= 0.0, "Invalid parameter xtol specified."
        return self._new(self.param.replace_ls(xtol=xtol))

    def with_linesearch_min_step(self, min_step: float) -> "Lbfgs":
        assert min_step >= 0.0, "Invalid parameter min_step specified."
        return self._new(self.param.replace_ls(min_step=min_step))

    def with_max_iterations(self, niter: int) -> "Lbfgs":
        return self._new(self.param.replace(max_iterations=niter))

    def with_max_evaluations(self, neval: int) -> "Lbfgs":
        return self._new(self.param.replace(max_evaluations=neval))

    def with_fx_delta(self, delta: float, past: int) -> "Lbfgs":
        assert delta >= 0.0, "Invalid parameter delta specified."
        return self._new(self.param.replace(past=past, delta=delta))

    def with_linesearch_algorithm(self, algo: str) -> "Lbfgs":
        name_map = {
            "MoreThuente": LineSearchAlgorithm.MoreThuente,
            "BacktrackingArmijo": LineSearchAlgorithm.BacktrackingArmijo,
            "BacktrackingStrongWolfe": LineSearchAlgorithm.BacktrackingStrongWolfe,
            "BacktrackingWolfe": LineSearchAlgorithm.BacktrackingWolfe,
            "Backtracking": LineSearchAlgorithm.BacktrackingWolfe,
        }
        if algo not in name_map:
            raise NotImplementedError(f"unknown line search algorithm: {algo}")
        return self._new(self.param.replace_ls(algorithm=name_map[algo]))

    def with_constrain_step_size(self, constrain: bool) -> "Lbfgs":
        """Toggle the post-two-loop step constraint
        step = min(max_step_size, ||d||)/||d|| (``src/lbfgs.rs:547-551``).
        False restores the pre-2019 libLBFGS behavior (step = 1.0) that the
        reference's golden comments were recorded under — see PARITY.md."""
        return self._new(self.param.replace(constrain_step_size=constrain))

    # -- extensions ----------------------------------------------------------

    def with_fx_delta_enabled(self, enabled: bool = True) -> "Lbfgs":
        return self._new(self.param.replace(fx_delta_enabled=enabled))

    def with_damping_fixed(self, fixed: bool = True) -> "Lbfgs":
        return self._new(self.param.replace(damping_fixed=fixed))

    def with_compact_two_loop(self, enabled: bool = True) -> "Lbfgs":
        return self._new(self.param.replace(compact_two_loop=enabled))

    def with_speculative_linesearch(self, k: int) -> "Lbfgs":
        """Speculative K-way backtracking (extension; not ported yet)."""
        assert int(k) >= 1, "Invalid speculative line-search width."
        return self._new(self.param.replace_ls(speculative=int(k)))

    def with_adaptive_entry_step(self, growth: float = 2.0) -> "Lbfgs":
        """Adaptive line-search entry step (extension; not ported yet)."""
        assert growth >= 0.0, "Invalid adaptive entry-step growth."
        return self._new(self.param.replace(adaptive_entry_step=float(growth)))

    def with_fx_wide(self, enabled: bool = True) -> "Lbfgs":
        """Wide objective scalar (extension): fx and the line search's
        f-values carry as float64 over float32 vectors."""
        return self._new(self.param.replace(fx_wide=bool(enabled)))

    def with_history_dtype(self, dtype) -> "Lbfgs":
        """Mixed-precision correction history (extension): store the
        [m, n] (s, y) stacks in a narrower dtype, e.g. "bfloat16"."""
        if dtype is not None:
            dtype = str(dtype).removeprefix("torch.")
            if dtype.startswith("float8"):
                raise NotImplementedError(f"fp8 history ({dtype})")
            assert dtype in ("float32", "bfloat16", "float64", "float16"), dtype
        return self._new(self.param.replace(history_dtype=dtype))

    # -- entry points (implemented in minimize.py; bound here lazily to
    #    avoid import cycles) ----------------------------------------------

    def minimize(self, x0, evaluate, progress=None, backend="torch", **kw):
        from .minimize import minimize as _minimize

        return _minimize(self.param, x0, evaluate, progress, backend=backend, **kw)

    def minimize_jit(self, x0, evaluate, **kw):
        from .minimize import minimize_jit as _minimize_jit

        return _minimize_jit(self.param, x0, evaluate, **kw)

    def minimize_batched(self, x0_batch, evaluate, **kw):
        raise NotImplementedError("batched runs (minimize_batched)")

    def build(self, x0, evaluate):
        from .minimize import LbfgsState

        return LbfgsState.build(self.param, x0, evaluate)


def lbfgs() -> Lbfgs:
    """Create a default L-BFGS optimizer builder (``src/lib.rs:74-76``)."""
    return Lbfgs()
