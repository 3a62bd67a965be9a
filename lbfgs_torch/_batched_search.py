"""The line searches of ``minimize_batched``, vectorized over instances.

The batched runner advances B independent problems in lockstep, and
each iteration runs one line search per instance.  ``linesearch`` runs
its searches as Python loops over numpy scalars, one device read per
trip.  Here the same searches run as loops over numpy arrays of shape
[B]: every instance whose search is still going takes its next trip at
once, which is one batched probe (``probe(stp, live)``, K2 b on the
card) and one read of the [B] (ft, g.d) pairs.  An instance whose search
has ended stays out of the later trips (``live``), as the JAX package's
vmapped while loop freezes it by a select.

Each instance's arithmetic is that of the scalar search, operation for
operation and in the same dtypes, so every instance's trials, steps and
status equal ``linesearch.morethuente`` and ``linesearch.backtracking``
bit for bit, the reference quirks included (at most ``max_linesearch -
1`` trials, the curvature-only first convergence test, backtracking's
unevaluated exhaustion step).  Where the scalar code branches, this code
computes every branch and selects (``update_trial_interval``, the
JAX package's branch-free form, ``lbfgs_tpu/linesearch.py:136-241``);
the branches not taken may divide by zero, so they run under
``np.errstate`` and their values never pass a select.

The step and derivative scalars are of the vectors' dtype (``stp0``'s),
the f-values (finit, ft and More-Thuente's fx, fy) of their own
(``finit``'s): float64 under the wide objective scalar, where numpy
promotes a float64 f-value against a float32 step to float64 where they
meet and the results are cast back, as the scalar searches do
(``linesearch``'s docstring; ``lbfgs_tpu/linesearch.py:136-152``).

Under OWL-QN (``ow``) the searches are those of the solo OWL-QN path:
backtracking with the Armijo exit only (More-Thuente routed to it, as
``linesearch.find`` routes it), its probe the projected one (K8 b on the
card), whose point the caller rebuilds from each instance's orthant.

With the combine+probe fusion (K15 b, K16 b) each instance carries the
first probe of its next search, ``probe1`` = (ft [B], g.d [B], stp [B]):
on the first trip an instance whose step is its probed one takes the
carried (ft, g.d), as ``linesearch.carried`` does for one search, and is
left out of that trip's probe; it still counts the evaluation.  A trip
on which every instance carried makes no probe and no read.

The gradient-only mode (``LineSearchParams.gradient_only``) adds the
scalar backtracking's literal exit, |g.d| <= -gtol*|dginit|, which holds
only where dginit == 0, per instance; with More-Thuente it raises the
scalar ``find``'s ``ValueError``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np

from .linesearch import carried, check_speculative
from .params import LineSearchAlgorithm, LineSearchParams
from .status import Status


class IntervalUpdate(NamedTuple):
    """``linesearch.McstepResult`` over [B] arrays."""

    x: np.ndarray
    fx: np.ndarray
    dx: np.ndarray
    y: np.ndarray
    fy: np.ndarray
    dy: np.ndarray
    t: np.ndarray
    brackt: np.ndarray
    status: np.ndarray


def _cubic_minimizer_d(u, dfuv, du, v, dv):
    d = v - u
    theta = dfuv * 3.0 / d + du + dv
    s = np.maximum(np.maximum(np.abs(theta), np.abs(du)), np.abs(dv))
    a = theta / s
    gamma = s * np.sqrt(a * a - (du / s) * (dv / s))
    gamma = np.where(v < u, -gamma, gamma)
    p = gamma - du + theta
    q = gamma - du + gamma + dv
    r = p / q
    return u + r * d


def _cubic_minimizer2_d(u, dfuv, du, v, dv, xmin, xmax):
    """The clamped cubic minimizer and where it is the clamp (xmax or xmin,
    of the step's dtype where the scalar code returns them: with float64
    f-values the interpolated value is float64)."""
    d = v - u
    theta = dfuv * 3.0 / d + du + dv
    s = np.maximum(np.maximum(np.abs(theta), np.abs(du)), np.abs(dv))
    a = theta / s
    gamma = s * np.sqrt(np.maximum(0.0, a * a - (du / s) * (dv / s)))
    gamma = np.where(u < v, -gamma, gamma)
    p = gamma - dv + theta
    q = gamma - dv + gamma + du
    r = p / q
    clamp = ~((r < 0.0) & (gamma != 0.0))
    return np.where(clamp, np.where(v > u, xmax, xmin), v - r * d), clamp


def _quad_minimizer_d(u, dfuv, du, v):
    a = v - u
    return u + du / (dfuv / a + du) / 2.0 * a


def _quad_minimizer2(u, du, v, dv):
    a = u - v
    return v + dv / (dv - du) * a


def update_trial_interval(x, fx, dx, y, fy, dy, t, ft, dt, tmin, tmax,
                          brackt) -> IntervalUpdate:
    """``linesearch.update_trial_interval`` (MCSTEP, ``src/line.rs:446-606``)
    over [B] arrays: all four cases' trial values are computed and one is
    selected per instance.  Each instance's result equals the scalar
    function's on its elements bit for bit, NaNs included."""
    brackt = np.asarray(brackt, dtype=bool)
    with np.errstate(all="ignore"):
        dsign = dt * (dx / np.abs(dx)) < 0.0

        # input validation (only when already bracketed), src/line.rs:470-481
        err = np.where(brackt & ((t <= np.minimum(x, y)) | (np.maximum(x, y) <= t)),
                       int(Status.LS_OUT_OF_INTERVAL), 0)
        err = np.where(brackt & (err == 0) & (0.0 <= dx * (t - x)),
                       int(Status.LS_INCREASE_GRADIENT), err)
        err = np.where(brackt & (err == 0) & (tmax < tmin), int(Status.LS_INVALID_INTERVAL), err)

        case1 = fx < ft
        case2 = ~case1 & dsign
        case3 = ~case1 & ~dsign & (np.abs(dt) < np.abs(dx))
        d_fx_ft = fx - ft

        mc = _cubic_minimizer_d(x, d_fx_ft, dx, t, dt)
        mq1 = _quad_minimizer_d(x, d_fx_ft, dx, t)
        newt1 = np.where(np.abs(mc - x) < np.abs(mq1 - x), mc, mc + 0.5 * (mq1 - mc))
        mq2 = _quad_minimizer2(x, dx, t, dt)
        newt2 = np.where(np.abs(mc - t) > np.abs(mq2 - t), mc, mq2)
        mc3, clamp = _cubic_minimizer2_d(x, d_fx_ft, dx, t, dt, tmin, tmax)
        # |t - mc3| as the scalar code takes it: in the step's dtype where
        # mc3 is the clamp, else in mc3's (float64 under the wide scalar)
        dist3 = np.where(clamp, np.abs(t - mc3.astype(np.asarray(t).dtype)), np.abs(t - mc3))
        newt3 = np.where(brackt,
                         np.where(dist3 < np.abs(t - mq2), mc3, mq2),
                         np.where(dist3 > np.abs(t - mq2), mc3, mq2))
        newt4 = np.where(brackt, _cubic_minimizer_d(t, ft - fy, dt, y, dy),
                         np.where(x < t, tmax, tmin))
        newt = np.where(case1, newt1, np.where(case2, newt2, np.where(case3, newt3, newt4)))
        bound = case1 | case3
        brackt_new = brackt | case1 | case2

        # interval-of-uncertainty update (src/line.rs:555-579)
        y_new = np.where(case1, t, np.where(dsign, x, y))
        fy_new = np.where(case1, ft, np.where(dsign, fx, fy))
        dy_new = np.where(case1, dt, np.where(dsign, dx, dy))
        x_new = np.where(case1, x, t)
        fx_new = np.where(case1, fx, ft)
        dx_new = np.where(case1, dx, dt)

        newt = np.minimum(np.maximum(newt, tmin), tmax)

        # far-endpoint 0.66 safeguard (src/line.rs:591-600)
        mq_s = x_new + 0.66 * (y_new - x_new)
        safe = np.where(x_new < y_new, np.minimum(newt, mq_s), np.maximum(newt, mq_s))
        newt = np.where(brackt_new & bound, safe, newt)

    cast = np.asarray(t).dtype
    fcast = np.result_type(fx, fy, ft)
    return IntervalUpdate(
        x=x_new.astype(cast), fx=fx_new.astype(fcast), dx=dx_new.astype(cast),
        y=y_new.astype(cast), fy=fy_new.astype(fcast), dy=dy_new.astype(cast),
        t=newt.astype(cast), brackt=brackt_new, status=err,
    )


class BatchedSearch(NamedTuple):
    """The [B] outcomes of one batched line search (``linesearch.
    LineSearchResult``'s host fields).  Instances outside the search keep
    fx = finit, step = step_eval = their entry step, ncall 0, their
    evaluation count and status 0."""

    fx: np.ndarray         #: objective at the last trial
    step: np.ndarray       #: the reported step
    step_eval: np.ndarray  #: the step that produced the last trial
    ncall: np.ndarray      #: evaluations the search used (0 on failure)
    neval: np.ndarray      #: the global evaluation counts
    status: np.ndarray     #: 0 success; LS_* or ERR_NEGATIVE_STEP


#: probe(stp [B], live [B] bool) -> (ft [B], g.d [B]), ft in the
#: f-values' dtype and g.d in the vectors': one batched evaluation of the
#: instances in ``live``
Probe = Callable[[np.ndarray, np.ndarray], tuple]


def _trip(probe: Probe, stp, run, probe1: Optional[tuple], count: int, ff, f) -> tuple:
    """One trip's (ft, g.d) for the instances in ``run``, ft of the
    f-values' dtype ``ff`` and g.d of the vectors' ``f``: on the first trip
    the carried ``probe1`` of each instance whose step is its probed one
    (``linesearch.carried``; each use counted in ``carried.used``), one
    probe over the others, and none when every instance carried."""
    carry = np.zeros_like(run)
    if probe1 is not None and count == 1:
        carry = run & (stp == probe1[2])
    go = run & ~carry
    if not carry.any():
        ft, dg = probe(stp, go)
    else:
        carried.used += int(carry.sum())
        ft, dg = probe(stp, go) if go.any() else (probe1[0], probe1[1])
        ft, dg = np.where(carry, probe1[0], ft), np.where(carry, probe1[1], dg)
    return np.asarray(ft).astype(ff), np.asarray(dg).astype(f)


def morethuente(ls: LineSearchParams, live, finit, dginit, stp0, neval0,
                probe: Probe, probe1: Optional[tuple] = None) -> BatchedSearch:
    """``linesearch.morethuente`` in probe-only mode over the instances in
    ``live``, one ``probe`` per trip (``src/line.rs:226-399``), the first
    trip carried in from ``probe1`` where its step is the probed one."""
    # step and derivative scalars in the vectors' dtype, f-values in their own
    f, ff = stp0.dtype.type, finit.dtype.type
    ftol, gtol, xtol = f(ls.ftol), f(ls.gtol), f(ls.xtol)
    min_step, max_step = f(ls.min_step), f(ls.max_step)
    max_ls = ls.max_linesearch
    B = finit.shape[0]

    dgtest = ftol * dginit
    width = np.full(B, f(max_step - min_step))
    prev_width = f(2.0) * width
    stp, stx, sty = stp0.copy(), np.zeros(B, f), np.zeros(B, f)
    fx, fy, ft = finit.copy(), finit.copy(), finit.copy()
    dgx, dgy = dginit.copy(), dginit.copy()
    brackt, stage1 = np.zeros(B, bool), np.ones(B, bool)
    done = np.zeros(B, bool)
    result = np.full(B, max_ls)
    status = np.zeros(B, np.int64)
    neval = neval0.copy()
    stp_eval = stp0.copy()
    stp_eval[live] = f(0.0)
    count = 1

    with np.errstate(all="ignore"):
        while count < max_ls:
            run = live & ~done
            if not run.any():
                break
            # interval of uncertainty (src/line.rs:261-265)
            stmin = np.where(brackt, np.minimum(stx, sty), stx)
            stmax = np.where(brackt, np.maximum(stx, sty), stp + f(4.0) * (stp - stx))
            s = np.minimum(np.maximum(stp, min_step), max_step)
            # unusual termination -> lowest point so far (src/line.rs:277-281)
            unusual = brackt & ((s <= stmin) | (stmax <= s) | (max_ls <= count + 1)
                                | (stmax - stmin <= xtol * stmax))
            s = np.where(unusual, stx, s)

            ft_t, dg_t = _trip(probe, s, run, probe1, count, ff, f)
            ftest1 = finit + s * dgtest

            # error exits (src/line.rs:292-313)
            st = np.where(brackt & ((s <= stmin) | (stmax <= s)), int(Status.LS_ROUNDING), 0)
            st = np.where((st == 0) & brackt & (stmax - stmin <= xtol * stmax),
                          int(Status.LS_XTOL), st)
            st = np.where((st == 0) & (s == max_step) & (ft_t <= ftest1) & (dg_t <= dgtest),
                          int(Status.LS_MAX_STEP), st)
            st = np.where((st == 0) & (s == min_step) & ((ftest1 < ft_t) | (dgtest <= dg_t)),
                          int(Status.LS_MIN_STEP), st)
            # convergence: the curvature condition alone (src/line.rs:315-321)
            success = (st == 0) & (np.abs(dg_t) <= gtol * (-dginit))
            # stage-1 update (src/line.rs:324-326)
            stage1_t = stage1 & ~((ft_t <= ftest1) & (min(ftol, gtol) * dginit <= dg_t))
            use_mod = stage1_t & (ftest1 < ft_t) & (ft_t <= fx)

            # one interval update, where use_mod on the modified function
            # values (src/line.rs:333-340): the update is elementwise, so
            # selecting its inputs selects its outputs
            fmod = lambda v, t: np.where(use_mod, v - t * dgtest, v)
            dmod = lambda v: np.where(use_mod, v - dgtest, v)
            u = update_trial_interval(stx, fmod(fx, stx), dmod(dgx), sty, fmod(fy, sty),
                                      dmod(dgy), s, fmod(ft_t, s), dmod(dg_t), stmin, stmax,
                                      brackt)
            fx_t = np.where(use_mod, u.fx + u.x * dgtest, u.fx)
            fy_t = np.where(use_mod, u.fy + u.y * dgtest, u.fy)
            dgx_t = np.where(use_mod, u.dx + dgtest, u.dx)
            dgy_t = np.where(use_mod, u.dy + dgtest, u.dy)
            stx_t, sty_t, stp_n, brackt_t = u.x, u.y, u.t, u.brackt
            st = np.where((st == 0) & (u.status != 0), u.status, st)
            fin = (st != 0) | success

            # force sufficient interval shrinkage (src/line.rs:382-391)
            shrink = brackt_t & (f(0.66) * prev_width <= np.abs(sty_t - stx_t))
            stp_n = np.where(shrink, stx_t + f(0.5) * (sty_t - stx_t), stp_n)
            prev_width_t = np.where(brackt_t, width, prev_width)
            width_t = np.where(brackt_t, np.abs(sty_t - stx_t), width)

            # the trip's carry, for the instances that took it
            keep = lambda new, old: np.where(run, new, old)
            ft = keep(ft_t, ft)
            neval = neval + run
            stx, sty, fx, fy = keep(stx_t, stx), keep(sty_t, sty), keep(fx_t, fx), keep(fy_t, fy)
            dgx, dgy = keep(dgx_t, dgx), keep(dgy_t, dgy)
            brackt, stage1 = keep(brackt_t, brackt), keep(stage1_t, stage1)
            prev_width, width = keep(prev_width_t, prev_width), keep(width_t, width)
            status = keep(st, status)
            stp_eval = keep(s, stp_eval)
            result = np.where(run & success, count, result)
            stp = keep(np.where(fin, s, stp_n), stp)
            done = done | (run & fin)
            count += 1

    ncall = np.where(live & (status == 0), result, 0)
    return BatchedSearch(fx=ft, step=stp, step_eval=stp_eval, ncall=ncall, neval=neval,
                         status=status)


def backtracking(ls: LineSearchParams, live, finit, dginit, stp0, neval0,
                 probe: Probe, ow: bool = False,
                 probe1: Optional[tuple] = None) -> BatchedSearch:
    """``linesearch.backtracking`` in probe-only mode over the instances in
    ``live``: the Armijo, Wolfe or strong-Wolfe exit ladder
    (``src/line.rs:716-784``), then in the gradient-only mode its literal
    exit, one ``probe`` per trip, the first trip carried in from
    ``probe1`` where its step is the probed one.  Under OWL-QN (``ow``)
    only the Armijo exit applies (``src/line.rs:747-751``), whatever the
    ladder."""
    f, ff = stp0.dtype.type, finit.dtype.type
    dec, inc = f(0.5), f(2.1)
    dgtest = f(ls.ftol) * dginit
    gtol = f(ls.gtol)
    min_step, max_step = f(ls.min_step), f(ls.max_step)
    armijo_only = ls.algorithm == LineSearchAlgorithm.BacktrackingArmijo or ow
    wolfe = ls.algorithm == LineSearchAlgorithm.BacktrackingWolfe
    max_ls = ls.max_linesearch
    B = finit.shape[0]

    stp = stp0.copy()
    stp_eval = stp0.copy()
    stp_eval[live] = f(0.0)
    done = np.zeros(B, bool)
    result = np.full(B, max_ls)
    status = np.zeros(B, np.int64)
    neval = neval0.copy()
    ft = finit.copy()
    count = 1

    with np.errstate(all="ignore"):
        while count < max_ls:
            run = live & ~done
            if not run.any():
                break
            ft_t, dg_t = _trip(probe, stp, run, probe1, count, ff, f)
            armijo_fail = ft_t > finit + stp * dgtest
            if armijo_only:
                # Armijo-only exit ladder (src/line.rs:745-751)
                success, width = ~armijo_fail, dec
            elif wolfe:
                # regular Wolfe (src/line.rs:754-757)
                curv_low = dg_t < gtol * dginit
                success = ~armijo_fail & ~curv_low
                width = np.where(armijo_fail, dec, inc)
            else:
                # strong Wolfe (src/line.rs:759-763)
                curv_low = dg_t < gtol * dginit
                curv_high = dg_t > -gtol * dginit
                success = ~(armijo_fail | curv_low | curv_high)
                width = np.where(armijo_fail, dec, np.where(curv_low, inc, dec))
            if ls.gradient_only:
                # literal quirk: |dg| <= -gtol*|dginit| holds only where
                # dginit == 0 (src/line.rs:768-774)
                success = success | (np.abs(dg_t) <= -gtol * np.abs(dginit))
            # validate_step after a failed trial (src/line.rs:776, :166-178)
            st = np.where(~success & (stp < min_step), int(Status.LS_MIN_STEP),
                          np.where(~success & (stp > max_step), int(Status.LS_MAX_STEP), 0))
            fin = success | (st != 0)

            keep = lambda new, old: np.where(run, new, old)
            ft = keep(ft_t, ft)
            neval = neval + run
            status = keep(st, status)
            stp_eval = keep(stp, stp_eval)
            result = np.where(run & success, count, result)
            stp = keep(np.where(fin, stp, stp * width), stp)
            done = done | (run & fin)
            count += 1

    ncall = np.where(live & (status == 0), result, 0)
    return BatchedSearch(fx=ft, step=stp, step_eval=stp_eval, ncall=ncall, neval=neval,
                         status=status)


#: probe_steps(steps [B, lanes], live [B] bool) -> ft [B, lanes]: the
#: f-values of the instances in ``live`` at ``lanes`` steps each, one
#: candidate pass and one read
ProbeSteps = Callable[[np.ndarray, np.ndarray], np.ndarray]


def backtracking_speculative(ls: LineSearchParams, live, finit, dginit, stp0, neval0,
                             probe_steps: ProbeSteps,
                             probe1: Optional[tuple] = None) -> BatchedSearch:
    """``linesearch.backtracking_speculative`` over the instances in
    ``live``: each round one ``probe_steps`` of K ladder steps per running
    instance (K2 b s, K8 b s on the card; only the trials left in the last
    round), and each instance selects its first event in ladder order,
    the Armijo test or after a failed trial the step bounds, as the scalar
    search does for it, bit for bit.  An instance that selected leaves the
    later rounds; a frozen one never enters.  The carried first trials
    ``probe1`` go unused (``linesearch.carried.ignored`` counts the
    instances that would have used them)."""
    f, ff = stp0.dtype.type, finit.dtype.type
    K = int(ls.speculative)
    max_ls = ls.max_linesearch
    trials = max_ls - 1  # `for count in 1..max_linesearch` (src/line.rs:739)
    dec = f(0.5)
    dgtest = f(ls.ftol) * dginit
    min_step, max_step = f(ls.min_step), f(ls.max_step)
    B = finit.shape[0]
    if probe1 is not None:
        carried.ignored += int((live & (probe1[2] == stp0)).sum())

    stp_eval = stp0.copy()
    stp_eval[live] = f(0.0)
    if trials <= 0:
        # zero-trial parity: the entry points, result = max_linesearch
        return BatchedSearch(fx=finit.copy(), step=stp0.copy(), step_eval=stp_eval,
                             ncall=np.where(live, max_ls, 0), neval=neval0.copy(),
                             status=np.zeros(B, np.int64))
    ladder = dec ** np.arange(K).astype(f)  # [K]: 1, 0.5, 0.25, ...
    stp_base = stp0.copy()
    done = np.zeros(B, bool)
    count = np.zeros(B, np.int64)
    status = np.zeros(B, np.int64)
    sel_step = stp0.copy()
    ft = finit.copy()
    r = 0
    with np.errstate(all="ignore"):
        while r * K < trials:
            run = live & ~done
            if not run.any():
                break
            lanes = min(K, trials - r * K)
            steps = stp_base[:, None] * ladder[None, :lanes]
            fts = probe_steps(steps, run)
            for j in range(lanes):
                stp, ft_j = steps[:, j], fts[:, j].astype(ff)
                # Armijo test (src/line.rs:745-751); step validation only after
                # a failed trial (src/line.rs:776, :166-178)
                fail = ft_j > finit + stp * dgtest
                st = np.where(fail & (stp < min_step), int(Status.LS_MIN_STEP),
                              np.where(fail & (stp > max_step), int(Status.LS_MAX_STEP), 0))
                hit = run & ~done & (~fail | (st != 0))
                count = np.where(hit, 1 + r * K + j, count)
                sel_step = np.where(hit, stp, sel_step)
                status = np.where(hit, st, status)
                # the last evaluated trial's f-value (the accepted one, or on
                # exhaustion the ladder's last)
                ft = np.where(run & ~done, ft_j, ft)
                done = done | hit
            stp_base = stp_base * dec ** K
            r += 1

    # exhaustion parity (src/line.rs:777): x at the last evaluated trial,
    # the next (never evaluated) step reported, ncall max_linesearch
    last = stp0 * dec ** (trials - 1)
    ended = live & ~done
    stp_eval = np.where(done, sel_step, np.where(ended, last, stp_eval))
    step = np.where(done, sel_step, np.where(ended, last * dec, stp0))
    ncall = np.where(done & (status == 0), count, np.where(ended, max_ls, 0))
    neval = neval0 + np.where(done, count, np.where(ended, trials, 0))
    return BatchedSearch(fx=ft, step=step, step_eval=stp_eval, ncall=ncall, neval=neval,
                         status=status)


def find(ls: LineSearchParams, live, finit, dginit, stp0, neval0,
         probe: Probe, ow: bool = False, probe1: Optional[tuple] = None,
         probe_steps: Optional[ProbeSteps] = None) -> BatchedSearch:
    """``linesearch.find`` over [B] instances: More-Thuente when the
    algorithm selects it and OWL-QN (``ow``) is off, else backtracking,
    each with the combine+probe fusion's carried first trips ``probe1``
    (ft, g.d, stp_probe; [B] each) when given; under the speculative
    search (``ls.speculative`` > 1) ``backtracking_speculative`` over
    ``probe_steps``, with the scalar ``find``'s rules (the Armijo-only
    ladder without the gradient-only mode, else ``ValueError``).  The
    gradient-only mode with More-Thuente is the reference's hard error
    (``src/line.rs:208``).  An instance with a negative entry step leaves
    before any evaluation with ``ERR_NEGATIVE_STEP``
    (``src/line.rs:197-201``)."""
    use_mt = ls.algorithm == LineSearchAlgorithm.MoreThuente and not ow
    if use_mt and ls.gradient_only:
        raise ValueError(
            "Gradient only optimization is incompatible with MoreThuente line search.")
    neg = live & np.signbit(stp0)
    if int(ls.speculative) > 1:
        check_speculative(ls, ow)
        out = backtracking_speculative(ls, live & ~neg, finit, dginit, stp0, neval0,
                                       probe_steps, probe1)
    elif use_mt:
        out = morethuente(ls, live & ~neg, finit, dginit, stp0, neval0, probe, probe1)
    else:
        out = backtracking(ls, live & ~neg, finit, dginit, stp0, neval0, probe, ow, probe1)
    if neg.any():
        out = out._replace(status=np.where(neg, int(Status.ERR_NEGATIVE_STEP), out.status))
    return out
