"""The line searches, run on the host: More-Thuente and backtracking.

Both are sequential by nature: each trial step depends on the scalars of
the one before.  So a search runs as a Python loop over numpy scalars of
the vectors' dtype (``np.float32`` for float32 runs, which round as the
JAX package's float32 search does), and each trip reads exactly two
scalars from the device, (ft, g.d), in one transfer (``core.to_host``).
The vectors never leave the device.

Under the wide objective scalar (``params.fx_wide``) the f-values (finit,
ft, and More-Thuente's fx, fy) are ``np.float64`` while the step and
derivative scalars stay in the vectors' dtype, as in the JAX package
(``lbfgs_tpu/linesearch.py:136-152, 423-439``): numpy promotes a float64
f-value against a float32 step to float64 where they meet, and the
results are cast back, the geometry to the vectors' dtype and the
f-values to their own.

For objectives with the fused protocol (``__lbfgs_trial_probe__``, or
under OWL-QN ``__lbfgs_owlqn_probe_pg__`` / ``__lbfgs_owlqn_probe__``)
each trip is one probe kernel that writes no vector; the accepted point
is materialized afterwards, either by one trial here
(``materialize=True``: K1, or under OWL-QN K7) or by the solver's
one-pass epilogue (``materialize=False``).  Generic objectives evaluate
(x, f, g) on every trip, under OWL-QN at the projected point of K9.

Routing (``find``, reference ``src/line.rs:193-223``): More-Thuente only
when the algorithm selects it AND OWL-QN is off; otherwise backtracking,
and under OWL-QN with the Armijo-only exit and every trial point
projected onto the orthant chosen before the loop.

Reference quirks kept (each cited in ``lbfgs_tpu/linesearch.py``): the
More-Thuente loop makes at most ``max_linesearch - 1`` trials and then
succeeds with ``max_linesearch`` (``src/line.rs:258,395-398``); its first
convergence test returns on the curvature condition alone
(``src/line.rs:315-321``); ``uinfo`` never becomes nonzero.  Backtracking
exhausts the same way and then reports the next, never evaluated, step
(``src/line.rs:777``); its gradient_only exit is the literal, nearly
unsatisfiable test (``src/line.rs:768-774``).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import orthantwise as ow_ops
from .core import ProblemDef, evaluate, np_type, to_host
from .ops import fused
from .params import LineSearchAlgorithm, LineSearchParams
from .status import Status

logger = logging.getLogger("lbfgs_torch")


# ---------------------------------------------------------------------------
# mcstep: safeguarded trial value & interval-of-uncertainty update
# ---------------------------------------------------------------------------


def _cubic_minimizer(u, fu, du, v, fv, dv):
    """Minimizer of the cubic interpolating (u, fu, du), (v, fv, dv)
    (reference ``cubic_minimizer``, ``src/line.rs:620-637``)."""
    return _cubic_minimizer_d(u, fu - fv, du, v, dv)


def _cubic_minimizer_d(u, dfuv, du, v, dv):
    """Difference-parameterized form: ``dfuv = fu - fv``."""
    d = v - u
    theta = dfuv * 3.0 / d + du + dv
    s = np.maximum(np.maximum(np.abs(theta), np.abs(du)), np.abs(dv))
    a = theta / s
    gamma = s * np.sqrt(a * a - (du / s) * (dv / s))
    if v < u:
        gamma = -gamma
    p = gamma - du + theta
    q = gamma - du + gamma + dv
    r = p / q
    return u + r * d


def _cubic_minimizer2(u, fu, du, v, fv, dv, xmin, xmax):
    """Clamped cubic minimizer (``src/line.rs:652-680``)."""
    return _cubic_minimizer2_d(u, fu - fv, du, v, dv, xmin, xmax)


def _cubic_minimizer2_d(u, dfuv, du, v, dv, xmin, xmax):
    d = v - u
    theta = dfuv * 3.0 / d + du + dv
    s = np.maximum(np.maximum(np.abs(theta), np.abs(du)), np.abs(dv))
    a = theta / s
    gamma = s * np.sqrt(np.maximum(0.0, a * a - (du / s) * (dv / s)))
    if u < v:
        gamma = -gamma
    p = gamma - dv + theta
    q = gamma - dv + gamma + du
    r = p / q
    if r < 0.0 and gamma != 0.0:
        return v - r * d
    return xmax if v > u else xmin


def _quad_minimizer(u, fu, du, v, fv):
    """Quadratic (function-value) minimizer (``src/line.rs:692-695``)."""
    return _quad_minimizer_d(u, fu - fv, du, v)


def _quad_minimizer_d(u, dfuv, du, v):
    a = v - u
    return u + du / (dfuv / a + du) / 2.0 * a


def _quad_minimizer2(u, du, v, dv):
    """Quadratic (secant) minimizer (``src/line.rs:706-709``)."""
    a = u - v
    return v + dv / (dv - du) * a


class McstepResult(NamedTuple):
    x: np.floating
    fx: np.floating
    dx: np.floating
    y: np.floating
    fy: np.floating
    dy: np.floating
    t: np.floating
    brackt: bool
    status: int  # 0 on success; LS_* code on error


def update_trial_interval(x, fx, dx, y, fy, dy, t, ft, dt, tmin, tmax,
                          brackt) -> McstepResult:
    """MCSTEP (reference ``mcstep::update_trial_interval``,
    ``src/line.rs:446-606``): 4-case cubic/quadratic trial selection,
    interval endpoint update, [tmin, tmax] clipping and the 0.66
    far-endpoint safeguard.  Arguments are numpy scalars of the step's
    dtype and the f-values (fx, fy, ft) of their own; the f-values enter
    the geometry only through their differences."""
    brackt = bool(brackt)
    with np.errstate(all="ignore"):
        dsign = dt * (dx / np.abs(dx)) < 0.0

        # input validation (only when already bracketed), src/line.rs:470-481
        err = 0
        if brackt:
            if t <= np.minimum(x, y) or np.maximum(x, y) <= t:
                err = int(Status.LS_OUT_OF_INTERVAL)
            elif 0.0 <= dx * (t - x):
                err = int(Status.LS_INCREASE_GRADIENT)
            elif tmax < tmin:
                err = int(Status.LS_INVALID_INTERVAL)

        case1 = fx < ft
        case2 = (not case1) and dsign
        case3 = (not case1) and (not dsign) and np.abs(dt) < np.abs(dx)
        d_fx_ft = fx - ft

        if case1:
            mc = _cubic_minimizer_d(x, d_fx_ft, dx, t, dt)
            mq1 = _quad_minimizer_d(x, d_fx_ft, dx, t)
            newt = mc if np.abs(mc - x) < np.abs(mq1 - x) else mc + 0.5 * (mq1 - mc)
        elif case2:
            mc = _cubic_minimizer_d(x, d_fx_ft, dx, t, dt)
            mq2 = _quad_minimizer2(x, dx, t, dt)
            newt = mc if np.abs(mc - t) > np.abs(mq2 - t) else mq2
        elif case3:
            mc3 = _cubic_minimizer2_d(x, d_fx_ft, dx, t, dt, tmin, tmax)
            mq2 = _quad_minimizer2(x, dx, t, dt)
            if brackt:
                newt = mc3 if np.abs(t - mc3) < np.abs(t - mq2) else mq2
            else:
                newt = mc3 if np.abs(t - mc3) > np.abs(t - mq2) else mq2
        elif brackt:
            newt = _cubic_minimizer_d(t, ft - fy, dt, y, dy)
        else:
            newt = tmax if x < t else tmin
        bound = case1 or case3
        brackt_new = brackt or case1 or case2

        # interval-of-uncertainty update (src/line.rs:555-579)
        if case1:
            y_new, fy_new, dy_new = t, ft, dt
            x_new, fx_new, dx_new = x, fx, dx
        else:
            if dsign:
                y_new, fy_new, dy_new = x, fx, dx
            else:
                y_new, fy_new, dy_new = y, fy, dy
            x_new, fx_new, dx_new = t, ft, dt

        newt = np.minimum(np.maximum(newt, tmin), tmax)

        # far-endpoint 0.66 safeguard (src/line.rs:591-600)
        if brackt_new and bound:
            mq_s = x_new + 0.66 * (y_new - x_new)
            newt = np.minimum(newt, mq_s) if x_new < y_new else np.maximum(newt, mq_s)

    # the geometry back to the step's dtype, the f-values to their own
    # (float64 under the wide objective scalar; lbfgs_tpu/linesearch.py:
    # 232-241)
    cast = np.asarray(t).dtype.type
    fcast = np.result_type(fx, fy, ft).type
    return McstepResult(
        x=cast(x_new), fx=fcast(fx_new), dx=cast(dx_new), y=cast(y_new),
        fy=fcast(fy_new), dy=cast(dy_new), t=cast(newt), brackt=brackt_new,
        status=err,
    )


# ---------------------------------------------------------------------------
# Line-search result, trials and probes
# ---------------------------------------------------------------------------


class LineSearchResult(NamedTuple):
    x: Optional[torch.Tensor]   #: evaluated trial point (None: scalars-only mode)
    fx: np.floating             #: objective there (host)
    gx: Optional[torch.Tensor]  #: gradient there
    step: np.floating           #: accepted step length (reported)
    ncall: int                  #: evaluations used (0 on failure)
    neval: int                  #: updated global evaluation counter
    status: int                 #: 0 success; LS_* on internal error
    gg: Optional[torch.Tensor] = None       #: gx . gx (device, 0-d)
    xx: Optional[torch.Tensor] = None       #: x . x (device, 0-d)
    changed: Optional[torch.Tensor] = None  #: any(x != xp); None for
                                            #: generic objectives
    #: the step that actually PRODUCED x: differs from ``step`` on a
    #: loop-exhaustion exit, where the reference reports the next (never
    #: evaluated) proposal (src/line.rs:777,395-398)
    step_eval: np.floating = None


def _has_fused_trial(pdef: ProblemDef) -> bool:
    """The plain fused trial applies with OWL-QN off only: under OWL-QN
    the trial point is projected and fx carries the L1 term."""
    return (getattr(pdef.value_and_grad, "__lbfgs_trial__", None) is not None
            and not pdef.orthantwise)


def _has_fused_owlqn_trial(pdef: ProblemDef) -> bool:
    """The OWL-QN counterpart: the objective has the projected trial K7
    (``__lbfgs_owlqn_trial__``), so a materializing OWL-QN search probes
    each trip and materializes once (``lbfgs_tpu/linesearch.py:293-312``)."""
    return (pdef.orthantwise
            and getattr(pdef.value_and_grad, "__lbfgs_owlqn_trial__", None) is not None)


def _owlqn_args(pdef: ProblemDef, n: int):
    start, end = pdef.owlqn.start_end(n)
    return pdef.owlqn.c, start, end


def _probe(pdef: ProblemDef, xp, d, stp, wp=None, wp_is_pg=False):
    """(ft, dg) of one trial on the host, without materializing the trial
    point or gradient: the objective's probe kernel when it has one.
    Under OWL-QN the probe (K8) is projected onto the orthant ``wp``, or
    with ``wp_is_pg`` onto the one it rebuilds in registers from (xp,
    pg)."""
    vag = pdef.value_and_grad
    if pdef.orthantwise:
        c, start, end = _owlqn_args(pdef, xp.shape[0])
        probe = vag.__lbfgs_owlqn_probe_pg__ if wp_is_pg else vag.__lbfgs_owlqn_probe__
        ft, dg = probe(xp, d, wp, stp, c, start, end)
    elif getattr(vag, "__lbfgs_trial_probe__", None) is not None:
        ft, dg = vag.__lbfgs_trial_probe__(xp, d, stp)
    else:
        res = vag.__lbfgs_trial__(xp, d, stp)
        ft, dg = res[1], res[3]
    return to_host(ft, dg)


def _trial(pdef: ProblemDef, xp, d, stp, wp=None):
    """One materialized trial: (xt, ft, gt, g.d[, gg, xx, changed]) as
    device tensors — the objective's fused trial when it has one
    (reference ``take_line_step`` + ``evaluate`` + the dg dot,
    ``src/line.rs:285-290``).  Under OWL-QN the point is projected onto
    ``wp`` and ft includes the L1 term: K7 gives (xt, ft, gt, g.d, xx,
    changed) where the objective has it, else the projected point comes
    from K9 and the objective is evaluated there
    (``lbfgs_tpu/linesearch.py:272-283, 345-363``)."""
    if _has_fused_trial(pdef):
        return pdef.value_and_grad.__lbfgs_trial__(xp, d, stp)
    if pdef.orthantwise:
        c, start, end = _owlqn_args(pdef, xp.shape[0])
        if _has_fused_owlqn_trial(pdef):
            return pdef.value_and_grad.__lbfgs_owlqn_trial__(xp, d, wp, stp, c, start, end)
        xt = fused.owlqn_trial_step(xp, d, wp, stp, start, end)
    else:
        xt = xp + float(stp) * d
    ft, gt = evaluate(pdef, xt)
    return xt, ft, gt, torch.dot(gt, d)


# ---------------------------------------------------------------------------
# More-Thuente
# ---------------------------------------------------------------------------


def morethuente(
    pdef: ProblemDef,
    ls: LineSearchParams,
    xp: torch.Tensor,
    finit: np.floating,
    gp: torch.Tensor,
    d: torch.Tensor,
    stp0: np.floating,
    dginit: np.floating,
    neval0: int,
    materialize: bool = True,
) -> LineSearchResult:
    """More-Thuente bracketing search (reference ``line_search_morethuente``,
    ``src/line.rs:226-399``): sufficient decrease + curvature via the
    stage-1 modified-function trick and mcstep interval updates.  One loop
    trip is one objective evaluation.

    With a fused-trial objective the trips only probe (remat mode); the
    accepted point is re-evaluated once at the end (``materialize``), not
    counted in ``neval`` since it repeats an evaluation of the loop, or
    left to the caller (``materialize=False``: x/gx/gg/xx/changed None).
    """
    # step and derivative scalars in the vectors' dtype, f-values in their
    # own (float64 under the wide objective scalar)
    f = np_type(xp.dtype)
    ff = np.dtype(finit.dtype).type
    finit, dginit = ff(finit), f(dginit)
    ftol, gtol, xtol = f(ls.ftol), f(ls.gtol), f(ls.xtol)
    min_step, max_step = f(ls.min_step), f(ls.max_step)
    max_ls = ls.max_linesearch
    remat = _has_fused_trial(pdef)

    dgtest = ftol * dginit
    width = f(max_step - min_step)
    prev_width = f(2.0) * width
    stp, stx, sty = f(stp0), f(0.0), f(0.0)
    fx = fy = ft = finit
    dgx = dgy = dginit
    brackt, stage1, uinfo = False, True, 0
    count, done, result, status = 1, False, max_ls, 0
    neval = neval0
    stp_eval = f(0.0)
    xt, gt = xp, gp

    with np.errstate(all="ignore"):
        while not done and count < max_ls:
            # interval of uncertainty (src/line.rs:261-265)
            if brackt:
                stmin, stmax = np.minimum(stx, sty), np.maximum(stx, sty)
            else:
                stmin, stmax = stx, stp + f(4.0) * (stp - stx)

            stp = np.minimum(np.maximum(stp, min_step), max_step)

            # unusual termination -> lowest point so far (src/line.rs:277-281)
            unusual = brackt and (
                stp <= stmin or stmax <= stp or max_ls <= count + 1
                or uinfo != 0 or stmax - stmin <= xtol * stmax
            )
            if unusual:
                stp = stx

            if remat:
                ft, dg = _probe(pdef, xp, d, stp)
            else:
                xt, ft_t, gt, dg_t = _trial(pdef, xp, d, stp)[:4]
                ft, dg = to_host(ft_t, dg_t)
            ft, dg = ff(ft), f(dg)
            neval += 1
            ftest1 = finit + stp * dgtest

            # error exits (src/line.rs:292-313)
            status = 0
            if brackt and (stp <= stmin or stmax <= stp or uinfo != 0):
                status = int(Status.LS_ROUNDING)
            elif brackt and stmax - stmin <= xtol * stmax:
                status = int(Status.LS_XTOL)
            elif stp == max_step and ft <= ftest1 and dg <= dgtest:
                status = int(Status.LS_MAX_STEP)
            elif stp == min_step and (ftest1 < ft or dgtest <= dg):
                status = int(Status.LS_MIN_STEP)

            # convergence: curvature condition alone (quirk parity,
            # src/line.rs:315-321: the combined branch is unreachable)
            success = status == 0 and np.abs(dg) <= gtol * (-dginit)

            # stage-1 update (src/line.rs:324-326)
            stage1 = stage1 and not (ft <= ftest1 and min(ftol, gtol) * dginit <= dg)
            use_mod = stage1 and ftest1 < ft and ft <= fx

            # modified function values (src/line.rs:333-340)
            if use_mod:
                mcs = update_trial_interval(
                    stx, fx - stx * dgtest, dgx - dgtest,
                    sty, fy - sty * dgtest, dgy - dgtest,
                    stp, ft - stp * dgtest, dg - dgtest, stmin, stmax, brackt,
                )
                fx_n = mcs.fx + mcs.x * dgtest
                fy_n = mcs.fy + mcs.y * dgtest
                dgx_n = mcs.dx + dgtest
                dgy_n = mcs.dy + dgtest
            else:
                mcs = update_trial_interval(
                    stx, fx, dgx, sty, fy, dgy, stp, ft, dg, stmin, stmax, brackt
                )
                fx_n, fy_n, dgx_n, dgy_n = mcs.fx, mcs.fy, mcs.dx, mcs.dy
            stx, sty = mcs.x, mcs.y
            fx, fy, dgx, dgy = ff(fx_n), ff(fy_n), f(dgx_n), f(dgy_n)
            stp_n = mcs.t
            brackt = mcs.brackt
            if status == 0 and mcs.status != 0:
                status = mcs.status
            errored = status != 0

            # force sufficient interval shrinkage (src/line.rs:382-391)
            if brackt and f(0.66) * prev_width <= np.abs(sty - stx):
                stp_n = stx + f(0.5) * (sty - stx)
            if brackt:
                prev_width, width = width, np.abs(sty - stx)

            done = errored or success
            stp_eval = stp
            if success:
                result = count
            if not (success or errored):
                stp = f(stp_n)
            count += 1

    ncall = 0 if status != 0 else result
    if remat and not materialize:
        return LineSearchResult(
            x=None, fx=ft, gx=None, step=stp, ncall=ncall, neval=neval,
            status=status, step_eval=stp_eval,
        )
    if remat:
        # materialize the accepted trial (one deterministic re-evaluation:
        # its fx equals the probe's, so the host value ft stands)
        xt, _ft, gt, _dg, gg, xx, changed = _trial(pdef, xp, d, stp_eval)
    else:
        gg, xx, changed = torch.dot(gt, gt), torch.dot(xt, xt), None
    return LineSearchResult(
        x=xt, fx=ft, gx=gt, step=stp, ncall=ncall, neval=neval, status=status,
        gg=gg, xx=xx, changed=changed, step_eval=stp_eval,
    )


# ---------------------------------------------------------------------------
# Backtracking
# ---------------------------------------------------------------------------


def backtracking(
    pdef: ProblemDef,
    ls: LineSearchParams,
    xp: torch.Tensor,
    finit: np.floating,
    gp: torch.Tensor,
    d: torch.Tensor,
    stp0: np.floating,
    dginit: np.floating,
    neval0: int,
    wp: Optional[torch.Tensor] = None,
    materialize: bool = True,
    wp_is_pg: bool = False,
) -> LineSearchResult:
    """Backtracking search with the Armijo / Wolfe / strong-Wolfe exit
    ladder (reference ``line_search_backtracking``, ``src/line.rs:716-784``):
    the step shrinks by 0.5 or grows by 2.1 until the ladder's exit holds,
    ``validate_step`` fails (``LS_MIN_STEP``/``LS_MAX_STEP``), or the loop
    runs out after ``max_linesearch - 1`` trials.

    Under OWL-QN every trial point is projected onto the orthant chosen
    before the loop (``src/line.rs:733-736``), and only the Armijo exit
    applies (``src/line.rs:747-751``).  ``wp`` is that orthant, or with
    ``wp_is_pg`` the pseudo-gradient at xp, from which each probe
    rebuilds the orthant in registers.  A fused trial (K1, or under
    OWL-QN K7) makes the search remat: each trip probes, and the
    accepted point is materialized once (``materialize``, see
    ``morethuente``).  The Armijo test compares the float64 ft with
    finit + stp*dgtest, the product in the vectors' dtype, under the wide
    objective scalar (``lbfgs_tpu/linesearch.py:778``).
    """
    f = np_type(xp.dtype)
    ff = np.dtype(finit.dtype).type
    finit, dginit = ff(finit), f(dginit)
    dec, inc = f(0.5), f(2.1)
    dgtest = f(ls.ftol) * dginit
    gtol = f(ls.gtol)
    min_step, max_step = f(ls.min_step), f(ls.max_step)
    armijo_only = (ls.algorithm == LineSearchAlgorithm.BacktrackingArmijo
                   or pdef.orthantwise)
    wolfe = ls.algorithm == LineSearchAlgorithm.BacktrackingWolfe
    max_ls = ls.max_linesearch
    remat = _has_fused_trial(pdef) or _has_fused_owlqn_trial(pdef) or wp_is_pg

    stp, stp_eval = f(stp0), f(0.0)
    count, done, result, status = 1, False, max_ls, 0
    neval = neval0
    ft = finit
    xt, gt = xp, gp

    with np.errstate(all="ignore"):
        while not done and count < max_ls:
            if remat:
                ft, dg = _probe(pdef, xp, d, stp, wp, wp_is_pg)
            else:
                xt, ft_t, gt, dg_t = _trial(pdef, xp, d, stp, wp)[:4]
                ft, dg = to_host(ft_t, dg_t)
            ft, dg = ff(ft), f(dg)
            neval += 1

            armijo_fail = ft > finit + stp * dgtest
            if armijo_only:
                # Armijo-only exit ladder (src/line.rs:745-751)
                success, width = not armijo_fail, dec
            elif wolfe:
                # regular Wolfe (src/line.rs:754-757)
                curv_low = dg < gtol * dginit
                success = not armijo_fail and not curv_low
                width = dec if armijo_fail else inc
            else:
                # strong Wolfe (src/line.rs:759-763)
                curv_low = dg < gtol * dginit
                curv_high = dg > -gtol * dginit
                success = not (armijo_fail or curv_low or curv_high)
                width = dec if armijo_fail else (inc if curv_low else dec)
            if ls.gradient_only:
                # literal quirk: |dg| <= -gtol*|dginit| holds only when
                # dginit == 0 (src/line.rs:768-774)
                success = success or np.abs(dg) <= -gtol * np.abs(dginit)

            # validate_step after a failed trial (src/line.rs:776, :166-178)
            status = 0
            if not success and stp < min_step:
                status = int(Status.LS_MIN_STEP)
            elif not success and stp > max_step:
                status = int(Status.LS_MAX_STEP)

            done = success or status != 0
            stp_eval = stp
            if success:
                result = count
            if not done:
                stp = f(stp * width)
            count += 1

    ncall = 0 if status != 0 else result
    if remat and not materialize:
        # the solver's one-pass epilogue materializes the accepted point
        return LineSearchResult(
            x=None, fx=ft, gx=None, step=stp, ncall=ncall, neval=neval,
            status=status, step_eval=stp_eval,
        )
    if remat and pdef.orthantwise:
        # K7 at the accepted step: its ft equals the probe's bit for bit
        # (the remat contract), so the host value ft stands; the solver
        # needs ||pg||^2, not ||g||^2
        xt, _ft, gt, _dg, xx, changed = _trial(pdef, xp, d, stp_eval, wp)
        gg = None
    elif remat:
        # one deterministic re-evaluation, whose fx equals the probe's
        xt, _ft, gt, _dg, gg, xx, changed = _trial(pdef, xp, d, stp_eval)
    else:
        # under OWL-QN the solver needs ||pg||^2, not ||g||^2
        gg = None if pdef.orthantwise else torch.dot(gt, gt)
        xx, changed = torch.dot(xt, xt), None
    return LineSearchResult(
        x=xt, fx=ft, gx=gt, step=stp, ncall=ncall, neval=neval, status=status,
        gg=gg, xx=xx, changed=changed, step_eval=stp_eval,
    )


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------


def find(
    pdef: ProblemDef,
    ls: LineSearchParams,
    xp: torch.Tensor,
    finit: np.floating,
    gp: torch.Tensor,
    d: torch.Tensor,
    stp0: np.floating,
    neval0: int,
    dginit: Optional[np.floating] = None,
    materialize: bool = True,
    pgp: Optional[torch.Tensor] = None,
) -> LineSearchResult:
    """Line-search entry (reference ``LineSearch::find``,
    ``src/line.rs:193-223``).

    Routing parity: More-Thuente only when the algorithm selects it AND
    OWL-QN is off; otherwise backtracking.  Under OWL-QN (``pgp`` the
    pseudo-gradient at xp) the orthant is chosen before the loop
    (``src/line.rs:733-736``), or, when the solver's epilogue will
    materialize (``materialize=False``), pg is passed on and each probe
    (K8) rebuilds the orthant in registers.  The reference's
    gradient_only + More-Thuente combination is a hard error
    (``src/line.rs:208``).  A negative entry
    step is a logic error that leaves find before any evaluation
    (``src/line.rs:197-201``).  On an internal search failure the caller
    reverts (``src/line.rs:213-220``).
    """
    ow = pdef.orthantwise
    has_pg_probe = getattr(pdef.value_and_grad, "__lbfgs_owlqn_probe_pg__",
                           None) is not None
    if not materialize and not (has_pg_probe if ow else _has_fused_trial(pdef)):
        raise ValueError(
            "materialize=False requires a fused-trial objective "
            "(__lbfgs_trial__, or __lbfgs_owlqn_probe_pg__ under OWL-QN)"
        )
    use_mt = ls.algorithm == LineSearchAlgorithm.MoreThuente and not ow
    if use_mt and ls.gradient_only:
        raise ValueError(
            "Gradient only optimization is incompatible with MoreThuente line search."
        )
    if dginit is None:
        # pg.d under OWL-QN, else g.d (src/core.rs:78-92)
        (dginit,) = to_host(torch.dot(pgp if ow else gp, d))
    if not ow and ls.warn_ascent and dginit > 0.0:
        # ascent-direction warning (reference Problem::dginit, src/core.rs:78-92)
        logger.warning(
            "The current search direction increases the objective "
            "function value. dginit = %-0.4f", float(dginit),
        )
    if np.signbit(stp0):
        return LineSearchResult(
            x=xp, fx=finit, gx=gp, step=stp0, ncall=0, neval=neval0,
            status=int(Status.ERR_NEGATIVE_STEP), step_eval=stp0,
        )
    if use_mt:
        return morethuente(pdef, ls, xp, finit, gp, d, stp0, dginit, neval0,
                           materialize=materialize)
    wp = None
    wp_is_pg = ow and not materialize
    if ow:
        wp = pgp if wp_is_pg else ow_ops.choose_orthant(pdef.owlqn, xp, pgp)
    return backtracking(pdef, ls, xp, finit, gp, d, stp0, dginit, neval0, wp,
                        materialize=materialize, wp_is_pg=wp_is_pg)
