"""Scenario batches: B independent minimizations advanced together.

The port of ``lbfgs_tpu/batched.py``.  The JAX package vmaps its whole
solver over a [B, n] batch and freezes each instance by a select once it
stops.  The port's line search runs on the host, so it cannot be vmapped;
here one host loop drives the whole batch instead:

  * the per-instance scalars the host decides on (fx, the carried norms,
    the step, the counters and the statuses) are numpy arrays of shape
    [B]; the vectors are [B, n] tensors and the history [B, m, n] rings
    on the run's device;
  * the instances still running advance in lockstep: they share the
    iteration count, the ring row ``end`` and the number of active pairs;
  * each iteration's line searches run together (``_batched_search``):
    one trip is one batched probe (K2 b) over the instances still
    searching and one read of their [B] (ft, g.d) pairs;
  * then one epilogue (K4 b) over the instances whose search succeeded,
    the compact two-loop's [m]-algebra on [B, m] tensors (the loops of
    ``solver.two_loop_compact`` with one [B] vector per element, so the
    launches do not grow with B), one combine (K3 b), and one read of the
    [B] scalars of the stop and status tests.

Every kernel takes the batch's live mask: a stopped instance's vectors,
ring rows and counters are never written again (the JAX select, done by
masking instead of copying [B, n]).  An instance whose search fails is
left out of that iteration's epilogue and combine, so its point and
gradient stay the previous ones: that is the JAX runner's revert
(``lbfgs_tpu/batched.py:59-66``) without a copy; its ring, Gram blocks,
direction and entry step stay those of the iteration before, where the
JAX runner's state holds the failed iteration's.  The run is on the card
when the batch lies on it, and on the CPU, through the kernels' plain
versions, when the caller puts it there.

Under OWL-QN the iteration is the solo OWL-QN path's at the capped step:
each trip one projected probe (K8 b, the orthant rebuilt from each
instance's (x, pg)), then one OWL-QN epilogue (K14 b: the point, its
gradient and pseudo-gradient, the pair and the 6m products against
-pg), the two-loop's algebra on d0 = -pg and one combine with the
direction constraint (K13 b); the init adds each instance's L1 term in
torch and takes pg and ||pg||^2 from one K10 b.  An instance whose search
fails keeps its pg too, so it ends with the JAX runner's values without
the JAX runner's closing pseudo-gradient pass
(``lbfgs_tpu/batched.py:55-68``).

With the step uncapped (``constrain_step_size=False``) each instance's
next entry step is known before the combine: 1.0, or under the adaptive
entry step clip(growth * step_ls, 2^-16, 1) of its own last search,
literal 1.0 while k <= 2 (``solver.propagate_core``'s rule per
instance).  The combine is then the combine+probe fusion (K15 b, under
OWL-QN K16 b), which also probes each instance's next search at its
entry step; the [B] probe values are read in the iteration's one read
and carried (``BatchedState.probe1``) into the next search's first trip,
which then makes no launch for the instances that carried.  An objective
without the fusion's hooks runs the uncapped step unfused: K3 b (K13 b)
and a probe on every trip.

Under Powell damping (``damping``, ``damping_fixed``; the gradient-only
mode implies it) the iteration is the solo fused branches'
(``solver.propagate_core``) per instance: the epilogue adds its . gp
column (K4 b, K14 b with gp.gp and gp.pg_new), the damped pair's Gram
quantities come from ``solver._damped_gram`` over [B, m] on the device,
and the damped ring row y_d = (a - b)*y + b*g is persisted by the combine
on the plain branch, its coefficient split as ``solver.two_loop_compact``
splits it (K6 b at the cap, K15 b's fix form uncapped), and blended in
torch before the combine under OWL-QN (``solver._blend_row`` per
instance).  Only the instances whose search succeeded have their row
damped; the [B] damping cases ride in the iteration's one read (for the
reference's debug traces), and no per-instance count of them is kept, as
the JAX batched state keeps none.  The gradient-only mode's literal exit
runs in ``_batched_search``.

A generic objective (one without the batched probe and trial that
``ops.factory.make_fused_objective`` attaches, e.g. the Poisson
regression of ``models.logistic``, or any user function) runs the
JAX package's generic branch under its vmap instead: each trip
materializes every running instance's trial point, xp + stp*d in torch
(under OWL-QN K9 b, the orthant rebuilt from each instance's (xp, pg)),
evaluates the batch with ``torch.func.vmap`` over the objective and reads
the [B] (f + c*||x||_1, g.d); the trials stay in [B, n] buffers, and an
accepted instance takes its last trial as its point and gradient.  Then
the pair + Gram pass: K12 b under OWL-QN (after K10 b's new pg and
||pg||^2), the torch pass over the stored pair on the plain branch
(``fused.pair_gram_stored_batched``), and damped, plain or OWL-QN, the
batched ``solver.update_pair_batched`` and that torch pass over the
stored damped pair, as the JAX package composes it; "x not changed" is
s.s == 0 per instance.  The combine is K3 b (K13 b) at the capped and
the uncapped step alike (a generic objective carries no fusion), and the
OWL-QN init takes pg from K11 b.  A value-and-grad objective and a scalar
one (its gradient from ``torch.func.grad_and_value``) run; a mutating
closure f(x, g) and an objective ``torch.func.vmap`` cannot trace raise
``ValueError``, as the JAX runner cannot vmap their host callbacks
(``batched_objective``).

Where the objective carries the batched probe and trial but the batched
epilogue does not run (``route``'s ``TRIAL``: an objective with a fused
trial and no epilogue, the scan two-loop, a float16 ring) each trip is
the batched probe as above, and the accepted instances' points are
materialized by one batched trial (K1 b; under OWL-QN K7 b, its orthant
rebuilt from (xp, pg)) at the search's evaluated step, the JAX package's
remat materialization under its vmap (``lbfgs_tpu/linesearch.py:
285-361``); under OWL-QN K10 b follows.  Then, as the solo solver runs
each setting per instance:

  * the compact two-loop over a ring the kernels take: K5 b (with its
    . gp column and ``solver._damped_gram`` damped, then K6 b) and K3 b;
    under OWL-QN K12 b and K13 b, damped the composed pair;
  * the scan two-loop (``compact_two_loop=False``): the composed pair
    (``solver.update_pair_batched``) written into ring row ``end``, then
    ``solver.two_loop_scan_batched`` (2m row products and axpys in torch
    ops, no ring kernel) and under OWL-QN the direction constraint;
  * a float16 ring: the JAX package's jnp route in torch, the pair + Gram
    pass over the stored pair (``fused.pair_gram_stored_batched``, damped
    after ``update_pair_batched``) and the combine
    (``fused.combine_plain_batched``, ``combine_ow_plain_batched``).

A generic objective takes the same three settings on its own branch (the
scan and the float16 ring in torch ops as above).

Under the wide objective scalar (``params.fx_wide``, float32 vectors) the
runner works inside ``fused.wide_fx``: fx, the searches' f-values and the
past/delta ring are float64 [B] arrays, every objective sum of the batched
kernels is taken in float64 per instance, and the init of an objective
with the batched trial is one K1 b at stp = 0 (under OWL-QN one K7 b with
the identity projection, then K10 b); nothing else changes, and float64
vectors run as without it.

The runner runs plain L-BFGS and OWL-QN, on factory objectives
(``ops.factory.make_fused_objective``), objectives with only a fused trial,
and generic ones, with More-Thuente (routed to backtracking under OWL-QN,
as ``linesearch.find`` routes it) or any of the three backtracking
searches, the step capped or not, damped or not, at any history depth
(above ``factory.MAX_M`` ring rows the deep forms of K4 b, K14 b, K15 b
and K16 b, and K3 b, K13 b and K6 b with their coefficients sized at
launch; K5 b and K12 b take any depth), under either objective scalar,
with either two-loop and any history dtype, and under the speculative
K-way search (``_batched_search.backtracking_speculative``: each round
one K-lane probe, K2 b s or K8 b s, over the running instances, or on a
generic objective one ``torch.func.vmap`` over the B*K candidate points,
and one read; then the ``TRIAL`` route, or on a generic objective the
accepted points evaluated once), as the JAX runner runs it
(``tests/test_speculative.py:193-218``); ``check_supported_batched``
raises ``NotImplementedError`` for a mesh, which the JAX runner does not
take either.
"""

from __future__ import annotations

import logging
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import _batched_search, solver
from .core import History, _required_positional, np_type, ring_zeros, to_host_rows
from .linesearch import candidate_values
from .ops import fused
from .orthantwise import choose_orthant, project_window
from .params import LbfgsParams
from .status import Status


class BatchedState(NamedTuple):
    """The batched run's state: instance b's slice of each field is its
    solo ``SolverState`` (lean: no previous-point slots).  A failed
    instance keeps the ring, Gram blocks, direction and entry step of the
    iteration before its failed search (see the module docstring)."""

    x: torch.Tensor          #: points                          [B, n]
    gx: torch.Tensor         #: gradients                       [B, n]
    d: torch.Tensor          #: search directions               [B, n]
    hist: History            #: s, y [B, m, n]; ys, alpha [B, m]; sy, yy [B, m, m]
    fx: np.ndarray           #: objective values (host)         [B]
    gnorm2: np.ndarray       #: carried squared gradient norms  [B]
    xnorm2: np.ndarray       #: carried squared point norms     [B]
    neval: np.ndarray        #: evaluations                     [B]
    k: np.ndarray            #: iteration counters              [B]
    end: np.ndarray          #: ring slot of each next pair     [B]
    step: np.ndarray         #: entry step of each next search  [B]
    step_ls: np.ndarray      #: step of each last search        [B]
    ncall: np.ndarray        #: evaluations of each last search [B]
    status: np.ndarray       #: Status codes                    [B]
    ls_status: np.ndarray    #: status of each last search      [B]
    dg0: np.ndarray          #: dginit of each next search      [B]
    #: the past/delta plateau test's fx rings [B, past], when enabled
    pf: Optional[np.ndarray] = None
    #: OWL-QN's pseudo-gradients [B, n] (None without OWL-QN); gnorm2 then
    #: carries ||pg||^2
    pg: Optional[torch.Tensor] = None
    #: the combine+probe fusion's carried first probes (ft, g.d, stp_probe),
    #: [B] each, where the fusion runs (``solver.SolverState.probe1`` per
    #: instance; seeded dead, stp_probe = -1), else None
    probe1: Optional[tuple] = None


#: the batched runner's three routes (``route``)
EPILOGUE, TRIAL, GENERIC = "epilogue", "trial", "generic"


def route(params: LbfgsParams, evaluate: Callable, x: torch.Tensor, S: torch.Tensor) -> str:
    """How the runner takes ``evaluate`` over the [B, n] points ``x`` and the
    [B, m, n] ring ``S`` (under OWL-QN through its OWL-QN hooks):

      * ``EPILOGUE``: each trip one batched probe (K2 b; K8 b) and each
        iteration the batched one-pass epilogue (K4 b; K14 b), which
        ``ops.factory.make_fused_objective`` attaches: with the compact
        two-loop over a ring the kernels take;
      * ``TRIAL``: each trip one batched probe, and the accepted points
        materialized by one batched trial (K1 b; K7 b), where the objective
        carries them but the epilogue does not run (an objective with a
        fused trial and no epilogue, the scan two-loop, a float16 ring, the
        speculative search, whose rounds are K-lane probes, K2 b s and K8 b
        s, and which materializes the accepted points itself);
      * ``GENERIC``: each trip the trials materialized and evaluated with
        ``torch.func.vmap``, for an objective without the batched probe and
        trial (the JAX package's generic branch)."""
    pre = "__lbfgs_owlqn_" if params.orthantwise is not None else "__lbfgs_"
    probe = "__lbfgs_owlqn_probe_pg_batched__" if pre != "__lbfgs_" else "__lbfgs_probe_batched__"
    has = lambda name: getattr(evaluate, name, None) is not None
    if not has(probe):
        return GENERIC
    if (has(pre + "trial_pair_gram_batched__") and params.compact_two_loop
            and int(params.linesearch.speculative) <= 1
            and (x.dtype, S.dtype) in fused.SUPPORTED):
        return EPILOGUE
    return TRIAL if has(pre + "trial_batched__") else GENERIC


def batched_objective(evaluate: Callable, x0_batch: torch.Tensor) -> Callable:
    """The single-instance objective ``x -> (fx, g)`` that the runner
    evaluates a batch with, under ``torch.func.vmap``: ``evaluate`` itself
    when it is a value-and-grad objective, else its
    ``torch.func.grad_and_value``.  As the JAX runner decides by the
    objective's shape (``lbfgs_tpu/core.py:216-248``) and then vmaps it:

      * a factory or marked objective (``__lbfgs_value_and_grad__``) is
        taken as it is;
      * a mutating closure ``f(x, g)`` raises ``ValueError``: the JAX
        package bridges it with an ordered host callback, which its vmap
        refuses;
      * a one-argument objective is traced once over ``x0_batch[:1]``: a
        tuple makes it value-and-grad, a scalar makes it scalar; if
        ``torch.func.vmap`` cannot trace it (a host function: the JAX
        package's host-callback fallback, which its vmap refuses), it
        raises ``ValueError`` too."""
    if getattr(evaluate, "__lbfgs_value_and_grad__", False):
        return evaluate
    name = getattr(evaluate, "__qualname__", repr(evaluate))
    if _required_positional(evaluate) >= 2:
        raise ValueError(
            f"minimize_batched: the mutating closure f(x, g) {name} cannot run batched (the "
            f"JAX package bridges it with an ordered io_callback, which jax.vmap refuses); "
            f"pass a value-and-grad or a scalar objective")
    try:
        out = torch.func.vmap(evaluate)(x0_batch[:1])
    except Exception as e:
        raise ValueError(
            f"minimize_batched: the objective {name} cannot be traced by torch.func.vmap (a "
            f"host objective: the JAX package bridges it with an ordered io_callback, which "
            f"jax.vmap refuses)") from e
    if isinstance(out, (tuple, list)):
        return evaluate

    def value_and_grad(x):
        g, fx = torch.func.grad_and_value(evaluate)(x)
        return fx, g

    value_and_grad.__lbfgs_value_and_grad__ = True
    # fx alone, for the speculative search's candidates (no gradient)
    value_and_grad.__lbfgs_value__ = evaluate
    return value_and_grad


def check_supported_batched(params: LbfgsParams, evaluate: Callable,
                            x0_batch: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` naming each setting the batched runner
    does not run: a mesh (``parallel``: the JAX runner takes none)."""
    if fused.active_mesh() is not None:
        raise NotImplementedError("minimize_batched: a mesh (sharded batches are not ported)")


def _to_device(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device)


def _fusion(params: LbfgsParams, evaluate: Callable, x: torch.Tensor, S: torch.Tensor):
    """The objective's batched combine+probe fusion (K15 b, under OWL-QN
    K16 b) where the runner runs it, else None: as ``solver._fusion``
    decides it for one instance (the step uncapped, the compact two-loop,
    the hooks present and their ``_ok__`` test passed)."""
    if params.constrain_step_size or not params.compact_two_loop:
        return None
    name = ("__lbfgs_combine_ow_probe_batched" if params.orthantwise is not None
            else "__lbfgs_combine_probe_batched")
    fn = getattr(evaluate, name + "__", None)
    ok = getattr(evaluate, name + "_ok__", None)
    return fn if fn is not None and ok is not None and ok(x, S) else None


def init_state(params: LbfgsParams, evaluate: Callable, x0_batch: torch.Tensor) -> BatchedState:
    """Each instance's initial evaluation, steepest-descent direction and
    initial step (``solver.init_state``), the batch evaluated at once by
    ``torch.func.vmap`` over the objective's own evaluation, as the JAX
    package vmaps its ``init_state`` (``lbfgs_tpu/batched.py:30-33``), and
    read in one transfer.  ``evaluate`` is a value-and-grad objective
    (``batched_objective``).  Under OWL-QN a factory objective's pg and
    ||pg||^2 come from K10 b, another's pg from K11 b and ||pg||^2 from a
    row product (the solo generic init's K11 and dot).  Under the wide
    objective scalar (float32 vectors) an objective with the batched trial
    is evaluated instead by one K1 b at stp = 0, under OWL-QN one K7 b with
    the identity projection followed by K10 b, so that fx and its L1 term
    are summed in float64 (``lbfgs_tpu/solver.py:1159-1192``); fx is then
    float64 [B]."""
    with fused.wide_fx(params.fx_wide):
        return _init_state(params, evaluate, x0_batch)


def _init_state(params: LbfgsParams, evaluate: Callable, x0_batch: torch.Tensor) -> BatchedState:
    B, n = x0_batch.shape
    m = params.m
    f = np_type(x0_batch.dtype)
    x = x0_batch.contiguous().clone()
    ow = params.orthantwise
    every = torch.ones(B, dtype=torch.bool, device=x.device)
    pre = "__lbfgs_owlqn_" if ow is not None else "__lbfgs_"
    trial = getattr(evaluate, pre + "trial_batched__", None)
    pg = None
    if ow is not None:
        lo, hi = ow.start_end(n)
        pg_norm = getattr(evaluate, "__lbfgs_pseudo_gradient_norm_batched__", None)
    if trial is not None and fused.wide(x.dtype):
        # the wide init: x0 + 0*x0 is x0, and with pg = x0 K7 b's orthant is
        # each element's own sign, so nothing is projected
        zero = torch.zeros(B, dtype=x.dtype, device=x.device)
        xt, g = torch.empty_like(x), torch.empty_like(x)
        if ow is None:
            fx_t, _dg, gg, xx, _ch = trial(x, x, zero, every, xt, g)
        else:
            fx_t, _dg, xx, _ch = trial(x, x, x, zero, ow.c, lo, hi, every, xt, g)
            pg = torch.empty_like(x)
            gg = (pg_norm or fused.pseudo_gradient_norm_batched)(xt, g, ow.c, lo, hi, every, pg)
        x = xt
    else:
        def one(xi):
            fx, g = evaluate(xi)
            return fx, g, torch.dot(g, g), torch.dot(xi, xi)

        fx_t, g, gg, xx = torch.func.vmap(one)(x)
        # the kernels take contiguous rows (a vmapped product may hand back a
        # transposed layout)
        g = g.contiguous()
        fx_t = fused.obj_lift(fx_t, x.dtype)
        if ow is not None:
            # fx gains c*||x||_1 over the window (a torch reduction, as the
            # solo init adds it), and K10 b gives pg and ||pg||^2
            fx_t = fx_t + fused.l1_batched(x, lo, hi) * ow.c
            pg = torch.empty_like(x)
            if pg_norm is None:
                fused.pseudo_gradient_batched(x, g, ow.c, lo, hi, every, pg)
                gg = fused.row_dot(pg, pg)
            else:
                gg = pg_norm(x, g, ow.c, lo, hi, every, pg)
    fx, gnorm2, xnorm2 = to_host_rows(fx_t, gg, xx)
    # step = initial_inverse_hessian / ||d||, and ||d|| = ||g|| (||pg||)
    step = f(params.initial_inverse_hessian) / np.sqrt(np.where(gnorm2 != 0.0, gnorm2, f(1.0)))
    hdtype = getattr(torch, params.history_dtype) if params.history_dtype else x.dtype
    z = dict(dtype=x.dtype, device=x.device)
    hist = History(
        s=ring_zeros((B, m, n), hdtype, x.device),
        y=ring_zeros((B, m, n), hdtype, x.device),
        ys=torch.zeros((B, m), **z), alpha=torch.zeros((B, m), **z),
        sy=torch.zeros((B, m, m), **z), yy=torch.zeros((B, m, m), **z),
    )
    pf = None
    if params.fx_delta_enabled and params.past > 0:
        pf = np.zeros((B, params.past), dtype=fx.dtype)
        pf[:, 0] = fx
    ints = lambda: np.zeros(B, np.int64)
    # the combine+probe slots, iff the fusion will run in propagate
    # (lbfgs_tpu/solver.py:1237-1258), seeded dead: the probed step -1
    # equals no entry step
    probe1 = None
    if _fusion(params, evaluate, x, hist.s) is not None:
        probe1 = (fx.copy(), -gnorm2, np.full(B, f(-1.0)))
    return BatchedState(
        x=x, gx=g, d=(-(g if pg is None else pg)).contiguous(), hist=hist, fx=fx,
        gnorm2=gnorm2, xnorm2=xnorm2, neval=np.ones(B, np.int64), k=ints(), end=ints(),
        step=step, step_ls=step.copy(), ncall=ints(), status=ints(), ls_status=ints(),
        # d = -g (-pg), so dginit = -||g||^2 exactly (IEEE sign symmetry)
        dg0=-gnorm2, pf=pf, pg=pg, probe1=probe1,
    )


def stop_status(params: LbfgsParams, st: BatchedState) -> np.ndarray:
    """``solver.stop_status`` per instance: a recorded status, then
    max_iterations, max_evaluations and the scaled gnorm test."""
    f = st.gnorm2.dtype.type
    out = np.where(st.status != Status.RUNNING, st.status, int(Status.RUNNING))
    if params.max_iterations != 0:
        out = np.where(st.k >= params.max_iterations, int(Status.MAX_ITERATIONS), out)
    if params.max_evaluations != 0:
        out = np.where((out == Status.RUNNING) & (st.neval >= params.max_evaluations),
                       int(Status.MAX_EVALUATIONS), out)
    with np.errstate(all="ignore"):
        small = np.sqrt(st.gnorm2) / np.maximum(np.sqrt(st.xnorm2), f(1.0)) <= f(params.epsilon)
    return np.where((out == Status.RUNNING) & small, int(Status.CONVERGED), out)


def fx_delta_step(params: LbfgsParams, st: BatchedState, live: np.ndarray) -> BatchedState:
    """``solver.fx_delta_step`` for the live instances (the flag-gated
    past/delta plateau test: compare with the ring slot, then store)."""
    if not (params.fx_delta_enabled and params.past > 0):
        return st
    rows = np.arange(st.fx.shape[0])
    slot = st.k % params.past
    with np.errstate(all="ignore"):
        rate = np.abs(st.pf[rows, slot] - st.fx) / st.fx
    hit = live & (st.status == Status.RUNNING) & (st.k >= params.past) & (rate < params.delta)
    pf = st.pf.copy()
    pf[rows[live], slot[live]] = st.fx[live]
    return st._replace(pf=pf, status=np.where(hit, int(Status.CONVERGED), st.status))


def _log_damping(case: np.ndarray, ok: np.ndarray) -> None:
    """The reference's damping traces (``solver._log_damping``) of each
    accepted instance that damped its pair."""
    if solver.logger.isEnabledFor(logging.DEBUG):
        for c in case[ok & (case != 0)]:
            solver._log_damping(int(c))


def _two_loop(hist: History, gamma: torch.Tensor, bound: int, end: int, Sd_ring: torch.Tensor,
              Yd_ring: torch.Tensor) -> tuple:
    """``solver.two_loop_compact``'s recurrences with the sign folded in
    (``neg=True``), each element a [B] vector: the combine's coefficient
    rows [B, 2m + 1] = [-gamma, cs, cy] and the alphas in ring order."""
    B, m = hist.ys.shape
    idx = torch.remainder(end - torch.arange(bound, device=gamma.device), m)
    Sd, Yd, ys = Sd_ring[:, idx], Yd_ring[:, idx], hist.ys[:, idx]
    SY = hist.sy[:, idx][:, :, idx]
    YY = hist.yy[:, idx][:, :, idx]
    alphas = torch.zeros((B, bound), dtype=gamma.dtype, device=gamma.device)
    for p in range(bound):
        alphas[:, p] = (Sd[:, p] - (SY[:, p, :p] * alphas[:, :p]).sum(dim=-1)) / ys[:, p]
    Yq0 = Yd - (YY * alphas[:, None, :]).sum(dim=-1)
    coefs = torch.zeros_like(alphas)
    for p in range(bound - 1, -1, -1):
        beta = (gamma * Yq0[:, p] + (SY[:, p + 1:, p] * coefs[:, p + 1:]).sum(dim=-1)) / ys[:, p]
        coefs[:, p] = alphas[:, p] - beta
    coef = torch.zeros((B, 1 + 2 * m), dtype=gamma.dtype, device=gamma.device)
    coef[:, 0] = -gamma
    coef[:, 1 + idx] = coefs
    coef[:, 1 + m + idx] = -gamma[:, None] * alphas
    alpha_ring = hist.alpha.clone()
    alpha_ring[:, idx] = alphas
    return coef, alpha_ring


def propagate(params: LbfgsParams, evaluate: Callable, st: BatchedState,
              live: np.ndarray) -> BatchedState:
    """One iteration (``solver.propagate_hot``) of every live instance,
    on the objective's route (``route``; see the module docstring), under
    the wide objective scalar when ``params.fx_wide``."""
    with fused.wide_fx(params.fx_wide):
        return _propagate(params, evaluate, st, live)


def _propagate(params: LbfgsParams, evaluate: Callable, st: BatchedState,
               live: np.ndarray) -> BatchedState:
    k = st.k + live
    if len(set(k[live].tolist())) != 1 or len(set(st.end[live].tolist())) != 1:
        raise ValueError("the running instances must share their iteration count and ring row")
    end = int(st.end[live][0])
    kk = int(k[live][0])
    m = params.m
    bound = min(m, kk - 1)
    # the step and derivative scalars' dtype (fx may be float64: the wide
    # objective scalar)
    f = np_type(st.x.dtype)
    x, g, d, hist, pg = st.x, st.gx, st.d, st.hist, st.pg
    ow = params.orthantwise
    damped = params.damping
    scan = not params.compact_two_loop
    # a ring the kernels do not take (float16): the composed pair + Gram
    # pass and combine in torch ops, as the JAX package runs jnp there
    composed = (x.dtype, hist.s.dtype) not in fused.SUPPORTED
    way = route(params, evaluate, x, hist.s)
    if ow is not None:
        c, (lo, hi) = ow.c, ow.start_end(x.shape[1])

    if way == GENERIC:
        # the trial buffers: each instance's last evaluated trial point and
        # gradient, written by the trips it runs (the others keep theirs)
        xt, gt = x.clone(), g.clone()

        def trial(stp, run):
            # the running instances' trial points and gradients into xt, gt;
            # (ft, g) of the whole batch, evaluated at once
            stp, run = _to_device(stp, x), _to_device(run, x)
            if ow is None:
                xt.copy_(torch.where(run[:, None], x + stp[:, None] * d, xt))
            else:
                # K9 b: the projected points, the orthant from (x, pg)
                fused.owlqn_trial_step_batched(x, d, pg, stp, lo, hi, run, xt)
            ft, g_all = torch.func.vmap(evaluate)(xt)
            gt.copy_(torch.where(run[:, None], g_all, gt))
            ft = fused.obj_lift(ft, x.dtype)
            if ow is not None:
                ft = ft + fused.l1_batched(xt, lo, hi) * c
            return ft, g_all

        def probe(stp, run):
            ft, g_all = trial(stp, run)
            return to_host_rows(ft, fused.row_dot(g_all, d))
    else:
        def probe(stp, run):
            stp, run = _to_device(stp, x), _to_device(run, x)
            if ow is None:
                return to_host_rows(*evaluate.__lbfgs_probe_batched__(x, d, stp, run))
            # the projected probe, its orthant rebuilt from (x, pg)
            return to_host_rows(*evaluate.__lbfgs_owlqn_probe_pg_batched__(x, d, pg, stp, c, lo,
                                                                          hi, run))

    def probe_steps(steps, run):
        # the speculative search's round: the [B, lanes] f-values of K2 b s
        # (K8 b s, its orthant rebuilt from (x, pg)), or of a generic
        # objective at the B*lanes candidate points under one vmap (the JAX
        # package's double vmap, its OWL-QN points by the plain projection
        # formula), and one read
        stp = fused.to_device(torch.from_numpy(np.ascontiguousarray(steps)), x)
        run = fused.to_device(torch.from_numpy(run), x)
        hook = ("__lbfgs_probe_steps_batched__" if ow is None
                else "__lbfgs_owlqn_probe_pg_steps_batched__")
        lanes = getattr(evaluate, hook, None)
        if lanes is not None and way != GENERIC:
            ft = (lanes(x, d, stp, run) if ow is None
                  else lanes(x, d, pg, stp, c, lo, hi, run))
        else:
            ft = candidate_values(evaluate, x, d, stp, ow,
                                  None if ow is None else choose_orthant(ow, x, pg))
        return np.stack(to_host_rows(*ft.unbind(1)), axis=1)

    ls = _batched_search.find(params.linesearch, live, st.fx, st.dg0, st.step, st.neval,
                              probe, ow=ow is not None, probe1=st.probe1,
                              probe_steps=probe_steps)
    ok = live & (ls.status == 0)
    fx_mat = None
    if way == GENERIC and int(params.linesearch.speculative) > 1 and ok.any():
        # the speculative rounds wrote no trial: the accepted points, their
        # gradients and f-values, at each accepted instance's evaluated
        # step (fx from this evaluation, as the solo search takes it)
        fx_mat, _ = trial(ls.step_eval, ok)
    status = np.where(live, int(Status.ERR_X_NOT_CHANGED), st.status)
    gnorm2, xnorm2, dg0, step = st.gnorm2, st.xnorm2, st.dg0, st.step
    step_ls = np.where(ls.status != 0, st.step, ls.step)
    # each instance's next entry step, known before the combine where the
    # step is not capped (solver.propagate_core's rule, in the vectors'
    # dtype): 1.0, or under the adaptive policy clip(growth*step_ls, 2^-16,
    # 1), literal 1.0 while k <= 2
    stp_pred = None
    if not params.constrain_step_size:
        stp_pred = np.full(st.step.shape, f(1.0))
        if params.adaptive_entry_step > 0.0 and kk > 2:
            stp_pred = np.clip(f(params.adaptive_entry_step) * step_ls, f(2.0 ** -16), f(1.0))
    fusion = _fusion(params, evaluate, x, hist.s)
    probe1 = None if fusion is None else st.probe1
    if ok.any():
        okd = _to_device(ok, x)
        case = row_fix = changed = pu = None
        if way == EPILOGUE:
            stp = _to_device(ls.step_eval, x)
            # the epilogue: x, g (and pg) and ring row `end` in place, the 6m
            # products against d0 = -g (-pg); damped, the 8m with the . gp
            # column (under OWL-QN also gp.gp and gp.pg_new)
            if ow is None:
                _gd, gg, xx, changed, SP, YP = evaluate.__lbfgs_trial_pair_gram_batched__(
                    x, d, g, stp, hist.s, hist.y, end, okd, with_gp=damped)
            else:
                xx, gg, changed, SP, YP, *gp_scalars = \
                    evaluate.__lbfgs_owlqn_trial_pair_gram_batched__(
                        x, d, g, pg, stp, c, lo, hi, hist.s, hist.y, end, okd, with_gp=damped)
            ys_new, yy_new = SP[:, end, 0], YP[:, end, 0]
            # gamma = ys/yy of the new pair, pre-damping (src/lbfgs.rs:653-656)
            gamma = ys_new / torch.where(yy_new == 0.0, torch.ones_like(yy_new), yy_new)
            # S . y_new, Y . y_new, Y . s_new and Y . d0
            u, v, w, Yd_ring = SP[:, :, 0], YP[:, :, 0], YP[:, :, 1], YP[:, :, 2]
            if damped:
                # the damped pair's Gram quantities per instance
                # (solver.propagate_core's reconstructions): the plain one
                # with the search's evaluated step and the carried ||gp||^2,
                # gp.d0 = -(y.gp + gp.gp); the OWL-QN one with the reported
                # step and K14 b's own gp.gp and gp.pg_new, gp.d0 = -gp.pg_new
                if ow is None:
                    gpgp = _to_device(st.gnorm2, x)
                    u, v, w, Yd_ring, a, b, case = solver._damped_gram(
                        params, SP, YP, end, stp, gpgp, -(YP[:, end, 3] + gpgp))
                    # the damped row, persisted by the combine (K6 b, or K15
                    # b's fix form) from its (ca, cb)
                    row_fix = (a - b, b)
                else:
                    gpgp, gppg = gp_scalars
                    u, v, w, Yd_ring, a, b, case = solver._damped_gram(
                        params, SP, YP, end, _to_device(step_ls, x), gpgp, -gppg)
                    # the damped row from the new gradient, blended in torch
                    # (solver._blend_row per instance), of the accepted
                    # instances
                    y_end = hist.y[:, end]
                    blend = ((a - b)[:, None] * y_end.to(x.dtype) + b[:, None] * g).to(
                        y_end.dtype)
                    hist.y[:, end] = torch.where(okd[:, None], blend, y_end)
        else:
            # the accepted instances' points and gradients: a failed or
            # frozen instance keeps its own, and xp, gp stay for the pair
            xp, gp = x, g
            if way == GENERIC:
                # their last trials
                x = torch.where(okd[:, None], xt, xp)
                g = torch.where(okd[:, None], gt, gp)
                del xt, gt
                xx = fused.row_dot(x, x)
                if ow is None:
                    gg = fused.row_dot(g, g)
            else:
                # one batched trial at each accepted instance's evaluated
                # step (K1 b; K7 b, its orthant from (xp, pg)): the point of
                # the search's last probe, written over copies of xp, gp
                stp = _to_device(ls.step_eval, x)
                x, g = xp.clone(), gp.clone()
                if ow is None:
                    _ft, _gd, gg, xx, changed = evaluate.__lbfgs_trial_batched__(
                        xp, d, stp, okd, x, g)
                else:
                    _ft, _gd, xx, changed = evaluate.__lbfgs_owlqn_trial_batched__(
                        xp, d, pg, stp, c, lo, hi, okd, x, g)
            if ow is not None:
                # K10 b: the new pg (over the old, of the accepted only) and
                # ||pg||^2
                gg = getattr(evaluate, "__lbfgs_pseudo_gradient_norm_batched__",
                             fused.pseudo_gradient_norm_batched)(x, g, c, lo, hi, okd, pg)
            g0 = g if ow is None else pg
            if scan or (damped and (way == GENERIC or composed or ow is not None)):
                # the composed pair (solver.update_pair per instance; damped
                # if asked) with the reported step, its ys and gamma
                # pre-damping.  Scan: stored into ring row `end`, with no
                # Gram products (lbfgs_tpu/solver.py:628-637); else the
                # products of the STORED pair (generic objectives, a float16
                # ring, and OWL-QN without K14 b damped, as the JAX package
                # composes them)
                pu = solver.update_pair_batched(params, x, xp, g, gp, _to_device(step_ls, x))
                if scan:
                    keep_row = okd[:, None]
                    hist.s[:, end] = torch.where(keep_row, pu.s.to(hist.s.dtype), hist.s[:, end])
                    hist.y[:, end] = torch.where(keep_row, pu.y.to(hist.y.dtype), hist.y[:, end])
                else:
                    SP, YP = fused.pair_gram_stored_batched(pu.s, pu.y, g0, hist.s, hist.y, end,
                                                            okd)
                ys_new, yy_new, case, ss = pu.ys, pu.yy, pu.case, pu.ss
            elif composed or (way == GENERIC and ow is None):
                # the JAX package's jnp pass over the stored pair
                SP, YP = fused.pair_gram_stored_batched(x - xp, g - gp, g0, hist.s, hist.y, end,
                                                        okd)
                ys_new, yy_new, ss = SP[:, end, 0], YP[:, end, 0], SP[:, end, 1]
            elif ow is not None:
                # K12 b: the pair of the projected step, against -pg
                SP, YP = fused.pair_gram_xg_batched(x, xp, g, gp, pg, hist.s, hist.y, end, okd)
                ys_new, yy_new, ss = SP[:, end, 0], YP[:, end, 0], SP[:, end, 1]
            else:
                # K5 b: the pair from s = stp*d (with the . gp column damped)
                SP, YP = fused.pair_gram_sd_batched(stp, d, g, gp, hist.s, hist.y, end, okd,
                                                    with_gp=damped)
                ys_new, yy_new, ss = SP[:, end, 0], YP[:, end, 0], SP[:, end, 1]
            if changed is None or pu is not None or composed:
                # the reference's s == 0 test (src/lbfgs.rs:646), per
                # instance, where no trial's changed count decides it
                changed = ss != 0.0
            gamma = ys_new / torch.where(yy_new == 0.0, torch.ones_like(yy_new), yy_new)
            if not scan:
                u, v, w, Yd_ring = SP[:, :, 0], YP[:, :, 0], YP[:, :, 1], YP[:, :, 2]
                if damped and pu is None:
                    # K5 b's . gp column: the epilogue's plain reconstruction
                    gpgp = _to_device(st.gnorm2, x)
                    u, v, w, Yd_ring, a, b, case = solver._damped_gram(
                        params, SP, YP, end, stp, gpgp, -(YP[:, end, 3] + gpgp))
                    row_fix = (a - b, b)
        ys = hist.ys.clone()
        ys[:, end] = ys_new
        fused_out = ()
        if scan:
            # the literal two-loop per instance (solver.two_loop_scan, the
            # recursion over [B] vectors) on d0 = -g (-pg), then under
            # OWL-QN the direction constraint (src/lbfgs.rs:554), ||d||^2
            # before it and dginit = g . d (pg . d) as row products
            sy, yy = hist.sy, hist.yy
            dnew, alpha = solver.two_loop_scan_batched(hist._replace(ys=ys), -g0, gamma, bound,
                                                       end)
            dd = fused.row_dot(dnew, dnew)
            if ow is not None:
                dnew = project_window(dnew, -pg, lo, hi)
                rc2 = fused.row_dot(dnew, dnew)
            rd = fused.row_dot(g0, dnew)
            d.copy_(torch.where(okd[:, None], dnew, d))
        else:
            sy = hist.sy.clone()
            sy[:, :, end] = u
            sy[:, end, :] = w
            yy = hist.yy.clone()
            yy[:, :, end] = v
            yy[:, end, :] = v
            new = hist._replace(ys=ys, sy=sy, yy=yy)
            coef, alpha = _two_loop(new, gamma, bound, end, SP[:, :, 2], Yd_ring)
            if row_fix is not None:
                # ring row `end` still holds the pre-damping y: its
                # coefficient splits into cy[end]*ca on the row and
                # cy[end]*cb on g (solver.two_loop_compact's row_fix), and
                # (ca, cb) follow
                ca, cb = row_fix
                cy_end = coef[:, 1 + m + end].clone()
                coef[:, 0] = coef[:, 0] + cy_end * cb
                coef[:, 1 + m + end] = cy_end * ca
                coef = torch.cat([coef, ca[:, None], cb[:, None]], dim=1)
            # the combine: the next direction over d, its norm and dginit;
            # under OWL-QN over pg, constrained to its orthant
            # (src/lbfgs.rs:554), its norm before the constraint, ||rc||^2
            # and dginit = rc . pg.  Fused, it also probes each instance's
            # next search at x + stp_pred*d.  Damped plain, it also persists
            # the damped row.  Over a float16 ring, torch ops
            if fusion is None:
                if composed and ow is not None:
                    dd, rc2, rd = fused.combine_ow_plain_batched(pg, hist.s, hist.y, coef, okd, d,
                                                                 lo, hi)
                elif composed:
                    dd, rd = fused.combine_plain_batched(g, hist.s, hist.y, coef, okd, d)
                elif ow is not None:
                    dd, rc2, rd = getattr(evaluate, "__lbfgs_combine_ow_batched__",
                                          fused.combine_ow_batched)(pg, hist.s, hist.y, coef, okd,
                                                                    d, lo, hi)
                elif row_fix is not None:
                    dd, rd = getattr(evaluate, "__lbfgs_combine_fix_batched__",
                                     fused.combine_fix_batched)(g, hist.s, hist.y, coef, okd, d,
                                                                end)
                else:
                    dd, rd = getattr(evaluate, "__lbfgs_combine_batched__",
                                     fused.combine_batched)(g, hist.s, hist.y, coef, okd, d)
            else:
                stp1 = _to_device(stp_pred, x)
                if ow is None:
                    dd, rd, *fused_out = fusion(g, x, hist.s, hist.y, coef, stp1, okd, d,
                                                fix=None if row_fix is None else end)
                else:
                    dd, rc2, rd, *fused_out = fusion(pg, x, hist.s, hist.y, coef, c, lo, hi,
                                                     stp1, okd, d)
        extra = (() if ow is None else (rc2,)) + (() if case is None else (case,))
        keep = lambda a, b: torch.where(okd.view(-1, *([1] * (a.ndim - 1))), a, b)
        hist = History(s=hist.s, y=hist.y, ys=keep(ys, hist.ys), alpha=keep(alpha, hist.alpha),
                       sy=keep(sy, hist.sy), yy=keep(yy, hist.yy))
        # the one read of the iteration's epilogue (or pair update) and
        # combine, the fusion's probe and the damping cases included
        vals = to_host_rows(*(() if fx_mat is None else (fx_mat,)), gg, xx, yy_new, dd, rd,
                            changed, *extra, *fused_out)
        if fx_mat is not None:
            fx_mat, *vals = vals
        gg_h, xx_h, yy_h, dd_h, rd_h, changed_h, *rest = vals
        rc2_h = rest[:1] if ow is not None else ()
        if case is not None:
            _log_damping(rest[len(extra) - 1], ok)
        if fusion is not None:
            old = st.probe1 or (st.fx, -st.gnorm2, np.full(st.step.shape, f(-1.0)))
            p_ft, p_dg = rest[len(extra):]
            probe1 = (np.where(ok, p_ft, old[0]), np.where(ok, p_dg, old[1]),
                      np.where(ok, stp_pred, old[2]))
        with np.errstate(all="ignore"):
            dnorm = np.sqrt(dd_h)
            st_ok = np.where(~changed_h, int(Status.ERR_X_NOT_CHANGED),
                             np.where(yy_h == 0.0, int(Status.ERR_G_NOT_CHANGED), 0))
            # dnorm.is_sign_positive() accepts +0.0 (src/lbfgs.rs:544)
            st_ok = np.where((st_ok == 0) & ~(dnorm >= 0.0), int(Status.ERR_INVALID_DNORM),
                             st_ok)
            if ow is not None:
                # the constrained direction must not vanish (the reference's
                # assertion in constrain_search_direction, src/orthantwise.rs:140-161)
                st_ok = np.where((st_ok == 0) & (rc2_h[0] == 0.0),
                                 int(Status.ERR_OWLQN_ZERO_DIRECTION), st_ok)
            # the next entry step (src/lbfgs.rs:547-551), from the norm before
            # the OWL-QN constraint; uncapped, the entry predicted above
            if params.constrain_step_size:
                step_next = (np.minimum(f(params.max_step_size), dnorm)
                             / np.where(dnorm != 0.0, dnorm, f(1.0)))
            else:
                step_next = stp_pred
        status = np.where(ok, st_ok, status)
        gnorm2, xnorm2 = np.where(ok, gg_h, gnorm2), np.where(ok, xx_h, xnorm2)
        dg0, step = np.where(ok, rd_h, dg0), np.where(ok, step_next, step)
    # a negative entry step bubbles out of the search (src/line.rs:197-201)
    status = np.where(live & (ls.status == Status.ERR_NEGATIVE_STEP),
                      int(Status.ERR_NEGATIVE_STEP), status)
    at = lambda new, old: np.where(live, new, old)
    fx = ls.fx if fx_mat is None else np.where(ok, fx_mat, ls.fx).astype(ls.fx.dtype)
    st = st._replace(
        x=x, gx=g, hist=hist, fx=at(fx, st.fx), gnorm2=gnorm2, xnorm2=xnorm2,
        neval=at(ls.neval, st.neval), k=k, end=at((st.end + 1) % m, st.end), step=step,
        step_ls=at(step_ls, st.step_ls), ncall=at(ls.ncall, st.ncall), status=status,
        ls_status=at(ls.status, st.ls_status), dg0=dg0, probe1=probe1,
    )
    return fx_delta_step(params, st, live)


def run(params: LbfgsParams, evaluate: Callable, st: BatchedState) -> BatchedState:
    """while any instance runs: step the running ones
    (``lbfgs_tpu/batched.py:35-52``), then record the stop status of each
    instance still RUNNING.  A step of an instance at k == 0 is the k == 1
    bookkeeping (``src/lbfgs.rs:504-510``: it reports the initial point);
    the others propagate together, and must share their iteration count
    and ring row (as every run from ``init_state`` does).
    ``evaluate`` is a value-and-grad objective (``batched_objective``).
    """

    def running(s: BatchedState) -> np.ndarray:
        return (s.status == Status.RUNNING) & (stop_status(params, s) == Status.RUNNING)

    while (live := running(st)).any():
        first = live & (st.k == 0)
        if first.any():
            st = st._replace(k=st.k + first, step_ls=np.where(first, st.step, st.step_ls))
            st = fx_delta_step(params, st, first)
        if (rest := live & ~first).any():
            st = propagate(params, evaluate, st, rest)
    return st._replace(status=np.where(st.status == Status.RUNNING, stop_status(params, st),
                                       st.status))


def minimize_batched(params: LbfgsParams, x0_batch: torch.Tensor, evaluate: Callable,
                     return_state: bool = False):
    """Minimize a [B, n] batch of independent instances of one objective
    (``lbfgs_tpu.batched.minimize_batched``).

    ``evaluate`` is the single-instance objective: a factory objective
    (``ops.factory.make_fused_objective``), whose batched kernels the run
    takes, or a generic one, value-and-grad or scalar, vmapped
    (``batched_objective``; a mutating closure raises ``ValueError``).
    The run takes place on x0_batch's device.  Returns the JAX package's dict of per-instance
    results, tensors on that device: fx ([B], the objective scalar's dtype:
    float64 under the wide scalar, else the vectors'), xnorm, gnorm ([B],
    the vectors' dtype; gnorm is ||pg|| under OWL-QN, as the JAX package's
    ``gnorm_of``), neval, niter, status ([B] int32) and x ([B, n]); or with
    ``return_state`` the final ``BatchedState``.  A fatal status is
    reported per instance, never raised.
    """
    if not isinstance(x0_batch, torch.Tensor) or x0_batch.ndim != 2:
        raise ValueError("x0_batch must be a [B, n] tensor")
    fused.check_dtypes(x0_batch.dtype)
    if not 1 <= x0_batch.shape[0] <= fused.MAX_BATCH:
        raise ValueError(f"B={x0_batch.shape[0]} outside [1, {fused.MAX_BATCH}]")
    # the ascent warning is a per-search log line; off, as in the JAX runner
    if params.linesearch.warn_ascent:
        params = params.replace_ls(warn_ascent=False)
    check_supported_batched(params, evaluate, x0_batch)
    evaluate = batched_objective(evaluate, x0_batch)
    st = run(params, evaluate, init_state(params, evaluate, x0_batch))
    if return_state:
        return st
    on = lambda a, dtype: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=x0_batch.device, dtype=dtype)
    vd = x0_batch.dtype
    return dict(
        fx=on(st.fx, torch.from_numpy(st.fx).dtype), xnorm=on(np.sqrt(st.xnorm2), vd), gnorm=on(np.sqrt(st.gnorm2), vd),
        neval=on(st.neval, torch.int32), niter=on(st.k, torch.int32),
        status=on(st.status, torch.int32), x=st.x,
    )
