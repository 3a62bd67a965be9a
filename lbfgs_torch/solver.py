"""L-BFGS iteration: line search, history update, two-loop.

The reference optimizer loop (``src/lbfgs.rs:424-693``) as one
``propagate`` per iteration.  The vectors and the history stay on the
run's device; the line search and the control decisions run on the host
(see ``linesearch``).  On the main path an iteration is:

  1. the line search, one probe kernel per trip (K2; under OWL-QN K8,
     projected, with the orthant rebuilt from (xp, pg) in registers);
  2. the one-pass epilogue (K4; under OWL-QN K14, which also gives the
     new pseudo-gradient): the accepted point and gradient, the
     correction pair written into ring row ``end``, and all 6m Gram
     products;
  3. the compact two-loop's O(m^2) recurrences on [m]-sized tensors, and
     the direction combine (K3; under OWL-QN K13, which applies the
     direction constraint in the same pass), which also yields ||d||^2
     and the next search's dginit;
  4. one device-to-host read of the scalars the host decides on.

An objective without the one-pass epilogue takes the composed branch:
the search materializes each trial (under OWL-QN at K9's projected
point), and under OWL-QN the pseudo-gradient (K10) and the pair update
(K12) follow as separate passes.  A fused-trial objective without the
epilogue takes K5 for the pair.

Under the wide objective scalar (``params.fx_wide``) the solver runs
inside ``fused.wide_fx``: fx and the line search's f-values carry as
float64 over float32 vectors (``lbfgs_tpu/solver.py:467-473,
1133-1147``); nothing else changes.

Powell damping (``src/lbfgs.rs:658-691``) runs on every branch the JAX
package has.  On the fused branches (K4 or K5 with the . gp column, K14
with it under OWL-QN, or K12 with it where K14 does not run) the damped pair is y_d = a*y + b*gp with scalars
(a, b) from global sums only, so every post-damping Gram quantity is
[m]-scalar algebra on the 4-column basis, on the device, and the damped
ring row is persisted by K6 (or K15's ``fix`` form) inside the combine
(under OWL-QN by a plain row blend before K13 or K16).  Generic
objectives take the composed ``update_pair``.  Stored ys and gamma stay
pre-damping everywhere.

Where the objective carries the combine+probe fusion (K15; under OWL-QN
K16) and the step is not capped, the combine of step 3 is that fusion:
the same pass also probes the next search at its entry step, which is
known before the combine, and the scalars come back in step 4's read, so
a first trip at that step costs no launch and no read
(``SolverState.probe1``).  On the damped plain branch K15's ``fix`` form
persists the damped row in the same pass, as K6 does.  Under the step
cap the entry comes from ||d||, after the combine, so the solver keeps
K3 (K6, K13) there.  ``params.adaptive_entry_step`` (the JAX package's
extension) enters each search at clip(growth*step, 2^-16, 1) of the last
accepted step instead of 1.0, where the step is not capped.

Under the speculative search (``LineSearchParams.speculative`` = K > 1,
``linesearch.backtracking_speculative``) each round of the search is one
K-lane candidate pass (K2 s; under OWL-QN K8 s) and one read, and the
search materializes the accepted point itself (K1; K7), so the one-pass
epilogue is off, as in the JAX package (``lbfgs_tpu/solver.py:518,
542``): the pair + Gram pass is K5 (K12 under OWL-QN), then the
combine.  K5's pair s = stp*d is not K4's x - xp in float32, so the
iterates are not the default sequential run's; against the sequential
search on the same route (an objective without the epilogue) they are
the same.  The combine+probe fusion still runs where the step is not
capped (its slot is the JAX package's), and its carried probe goes
unused (``linesearch.carried.ignored``).

With ``compact_two_loop=False`` an iteration is the reference's literal
one (``lbfgs_tpu/solver.py:628-653, 726-728``): the search materializes
the accepted point, ``update_pair`` forms the pair and writes it into the
ring with no Gram products, and ``two_loop_scan`` walks the ring (Nocedal's
Algorithm 7.4) in torch ops; under OWL-QN the direction is constrained
after it.  No one-pass epilogue, pair + Gram kernel or combine runs there.

A history dtype the kernels that read the ring do not take (``(vectors,
history)`` outside ``fused.SUPPORTED``, e.g. float16) takes the JAX
package's composed route for it (``lbfgs_tpu/solver.py:475-484``, the
combine at ``:144``): the pair + Gram pass is ``fused.pair_gram_ref`` and
the combine ``fused.combine_plain`` (``combine_ow_plain`` under OWL-QN),
torch ops as they are jnp ops there; the trial and probe kernels still
run.

On a mesh (``parallel``: x and every [n] vector this rank's shard, the
rings [m, n_local]) each kernel's scalars arrive summed over the ranks
(``ops.collective``), and every reduction the solver takes outside a
kernel goes through ``ops.vecmath`` or ``collective.mesh_sum``, one
collective for the products of one pass; the [m]-sized algebra and the
host's decisions then run on every rank alike.  A generic objective runs
there on every branch above when it keeps the local contract
(``collective.local_objective``: it gets the rank's shard and returns the
whole fx, the same on every rank, and the shard's gradient); without the
contract it raises (``check_supported``).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import orthantwise as ow_ops
from .core import (
    History,
    ProblemDef,
    ProblemState,
    SolverState,
    evaluate,
    gnorm_of,
    np_type,
    pseudo_gradient,
    pseudo_gradient_and_norm,
    ring_zeros,
    to_host,
    xnorm_of,
)
from .linesearch import find as ls_find
from .ops import fused
from .ops import vecmath as vm
from .ops.collective import active_mesh, keeps_local_contract, mesh_sum
from .params import LbfgsParams
from .status import Status

logger = logging.getLogger("lbfgs_torch")

# ---------------------------------------------------------------------------
# Two-loop recursion, literal scan form
# ---------------------------------------------------------------------------


def two_loop_scan(hist: History, d: torch.Tensor, gamma: torch.Tensor, bound: int, end: int):
    """Nocedal's Algorithm 7.4 over the circular history
    (``src/lbfgs.rs:569-604``; ``lbfgs_tpu/solver.py:121-166``).

    ``end`` is the ring slot of the NEWEST pair (already written);
    ``bound = min(m, k - 1)`` pairs are active, newest to oldest and back,
    and the inactive slots are left out (the JAX package masks them to
    the same values).  Each ring row is widened to ``d``'s dtype before
    its dot and its axpy.  Returns (q, alpha): the new direction and the
    alphas written back in ring order over ``hist.alpha``."""
    m = hist.s.shape[0]
    q = d
    alphas = []
    for i in range(bound):
        j = (end - i) % m
        a = vm.dot(hist.s[j].to(d.dtype), q) / hist.ys[j]
        q = q - a * hist.y[j].to(d.dtype)
        alphas.append(a)
    q = q * gamma
    for i in range(bound):
        p = bound - 1 - i                  # newest-first index, oldest first
        j = (end - p) % m
        beta = vm.dot(hist.y[j].to(d.dtype), q) / hist.ys[j]
        q = q + (alphas[p] - beta) * hist.s[j].to(d.dtype)
    alpha_ring = hist.alpha.clone()
    if bound:
        idx = torch.remainder(end - torch.arange(bound, device=d.device), m)
        alpha_ring[idx] = torch.stack(alphas)
    return q, alpha_ring


def two_loop_scan_batched(hist: History, d: torch.Tensor, gamma: torch.Tensor, bound: int,
                          end: int):
    """``two_loop_scan`` over B instances (the batched runner's scan
    two-loop): ``d`` [B, n], ``gamma`` [B], the rings [B, m, n] and ys,
    alpha [B, m]; ``bound`` and ``end`` are shared by the instances, which
    advance in lockstep.  Each element of the recursion is a [B] vector:
    2*bound row products and axpys over [B, n] in torch ops (no ring
    kernel, as in the solo scan), each instance's arithmetic the solo
    recursion's with its dots taken as row sums.  Returns (q [B, n], alpha
    [B, m])."""
    m = hist.s.shape[1]
    q = d
    alphas = []
    for i in range(bound):
        j = (end - i) % m
        a = fused.row_dot(hist.s[:, j].to(d.dtype), q) / hist.ys[:, j]
        q = q - a[:, None] * hist.y[:, j].to(d.dtype)
        alphas.append(a)
    q = q * gamma[:, None]
    for i in range(bound):
        p = bound - 1 - i                  # newest-first index, oldest first
        j = (end - p) % m
        beta = fused.row_dot(hist.y[:, j].to(d.dtype), q) / hist.ys[:, j]
        q = q + (alphas[p] - beta)[:, None] * hist.s[:, j].to(d.dtype)
    alpha_ring = hist.alpha.clone()
    if bound:
        idx = torch.remainder(end - torch.arange(bound, device=d.device), m)
        alpha_ring[:, idx] = torch.stack(alphas, dim=1)
    return q, alpha_ring


# ---------------------------------------------------------------------------
# Two-loop recursion, compact form
# ---------------------------------------------------------------------------


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A @ v for the [m, m] blocks, as an elementwise product and a sum:
    no matmul, so it runs in full precision whatever the TF32 setting."""
    return (A * v).sum(dim=-1)


def two_loop_compact(
    hist: History,
    d: torch.Tensor,
    gamma: torch.Tensor,
    bound: int,
    end: int,
    Sd_ring: Optional[torch.Tensor] = None,
    Yd_ring: Optional[torch.Tensor] = None,
    neg: bool = False,
    combine=fused.combine,
    ow_window: Optional[tuple] = None,
    combine_ow=fused.combine_ow,
    row_fix: Optional[tuple] = None,
    combine_fix=fused.combine_fix,
    probe_fuse: Optional[tuple] = None,
):
    """Byrd-Nocedal-Schnabel compact two-loop.

    With pairs ordered newest-first p = 0..bound-1 (ring slot j = end - p):

      backward:  alpha_p = (s_p.d - sum_{i<p} alpha_i (s_p.y_i)) / ys_p
      forward (oldest first):
                 beta_p = (gamma*(y_p.d) - gamma*sum_i alpha_i (y_p.y_i)
                           + sum_{i older than p} (alpha_i - beta_i) (y_p.s_i)) / ys_p
      result:    r = gamma*d - gamma*Y^T alpha + S^T (alpha - beta)

    The length-n products come in as ``Sd_ring``/``Yd_ring`` (the
    epilogue's Gram columns) and the [m, m] blocks from the cached Gram
    matrices, so the history is streamed once, by the combine.  ``bound``
    and ``end`` are host ints, so the recurrences loop only over active
    pairs; the scalars stay on the device (no host read).

    ``neg=True`` means ``d`` is the POSITIVE gradient and the two-loop
    input is ``-d``: the sign is folded into the coefficients and the
    combine's gamma (bitwise the same as negating the vector, by IEEE sign
    symmetry), and the combine's r . d is then dginit = d_new . g of the
    next line search.  Returns (r, alpha_ring, r.r, r.d, probe), probe
    None unless ``probe_fuse`` is given.

    Under OWL-QN (``ow_window`` = (start, end), ``d`` the pseudo-gradient)
    the combine is ``combine_ow`` (K13), which applies the direction
    constraint r <- pi(r; -pg) (``src/lbfgs.rs:554``) in the same pass: r
    is then the constrained direction, r.r stays the norm BEFORE the
    constraint (the reference's dnorm) and the fourth value is the pair
    (||rc||^2, rc . pg).

    ``row_fix`` = (end, ca, cb) (the plain damped branch, ``neg=True``):
    ring row ``end`` of Y still holds the PRE-damping y, and the damped
    row is ca*Y[end] + cb*d.  Its coefficient is split exactly, cy[end]*ca
    on the stored row and cy[end]*cb added to the combine's gamma, and the
    combine is ``combine_fix`` (K6), which also persists the damped row
    into Y in place (``lbfgs_tpu/solver.py:317-339``).

    ``probe_fuse`` (the combine+probe fusion, ``lbfgs_tpu/solver.py:
    296-356``) = (fn, x, stp1), under OWL-QN (fn, x, c, stp1): the combine
    is ``fn`` (K15, K16), which also probes the next search at x + stp1*r,
    and ``probe`` is that probe's (ft, g.r).  With ``row_fix`` too the
    damped row goes to K15's ``fix`` form in place of K6.
    """
    m = hist.s.shape[0]
    if Sd_ring is None:
        Sd_ring, Yd_ring = mesh_sum(hist.s.to(d.dtype) @ d, hist.y.to(d.dtype) @ d)
        if neg:
            Sd_ring, Yd_ring = -Sd_ring, -Yd_ring
    # ring slot of newest-first position p (made on the device: a host
    # index list would be a synchronising copy)
    idx = torch.remainder(end - torch.arange(bound, device=d.device), m)
    Sd, Yd, ys = Sd_ring[idx], Yd_ring[idx], hist.ys[idx]
    SY = hist.sy[idx][:, idx]
    YY = hist.yy[idx][:, idx]

    # backward recurrence for alpha (newest-first order)
    alphas = torch.zeros(bound, dtype=d.dtype, device=d.device)
    for p in range(bound):
        alphas[p] = (Sd[p] - torch.dot(SY[p, :p], alphas[:p])) / ys[p]

    # y_p . q0  where q0 = d - Y^T alpha
    Yq0 = Yd - _mv(YY, alphas)

    # forward recurrence (oldest first): coef_p = alpha_p - beta_p
    coefs = torch.zeros(bound, dtype=d.dtype, device=d.device)
    for p in range(bound - 1, -1, -1):
        beta = (gamma * Yq0[p] + torch.dot(SY[p + 1:, p], coefs[p + 1:])) / ys[p]
        coefs[p] = alphas[p] - beta

    # back to ring order, then r = gamma*d + S^T coef_s + Y^T coef_y
    coef_s = torch.zeros(m, dtype=d.dtype, device=d.device)
    coef_y = torch.zeros(m, dtype=d.dtype, device=d.device)
    coef_s[idx] = coefs
    coef_y[idx] = -gamma * alphas
    gamma_eff = -gamma if neg else gamma
    probe = None
    if ow_window is not None:
        if probe_fuse is not None:
            fn, x, c, stp1 = probe_fuse
            r, rr, rc2, rcd, *probe = fn(d, x, hist.s, hist.y, gamma_eff, coef_s, coef_y, c,
                                         *ow_window, stp1)
        else:
            r, rr, rc2, rcd = combine_ow(d, hist.s, hist.y, gamma_eff, coef_s, coef_y,
                                         *ow_window)
        rd = (rc2, rcd)
    else:
        if (row_fix is not None or probe_fuse is not None) and not neg:
            raise ValueError("row_fix and probe_fuse need the sign-folded two-loop (neg=True)")
        if row_fix is not None:
            fix_end, ca, cb = row_fix
            cy_end = coef_y[fix_end].clone()
            gamma_eff = gamma_eff + cy_end * cb
            coef_y[fix_end] = cy_end * ca
        args = (hist.s, hist.y, gamma_eff, coef_s, coef_y)
        if probe_fuse is not None:
            fn, x, stp1 = probe_fuse
            r, rr, rd, *probe = fn(d, x, *args, stp1, fix=row_fix)
        elif row_fix is not None:
            r, rr, rd = combine_fix(d, *args, *row_fix)
        else:
            r, rr, rd = combine(d, *args)
    alpha_ring = hist.alpha.clone()
    alpha_ring[idx] = alphas
    return r, alpha_ring, rr, rd, probe


# ---------------------------------------------------------------------------
# Correction-pair update (+ Powell/Al-Baali damping)
# ---------------------------------------------------------------------------

#: Powell damping's sigma2 and sigma3 (src/lbfgs.rs:662-663)
SIGMA2, SIGMA3 = 0.6, 3.0


class PairUpdate(NamedTuple):
    s: torch.Tensor
    y: torch.Tensor
    ys: torch.Tensor
    gamma: torch.Tensor
    status: int
    #: damping case: 0 none, 1, 2 (case 2 counts even where the literal
    #: reference drops its write-back)
    case: int = 0


def _log_damping(case: int) -> None:
    """The reference's damping traces (src/lbfgs.rs:667, 676-687)."""
    if case and logger.isEnabledFor(logging.DEBUG):
        logger.debug("Applying Powell damping, sigma2 = %s, sigma3 = %s", SIGMA2, SIGMA3)
        logger.debug("damping case%d", case)


def update_pair(params: LbfgsParams, x, xp, gx, gp, step=None) -> PairUpdate:
    """The new correction pair (reference ``IterationData::update``,
    ``src/lbfgs.rs:640-692``) with the literal damping semantics:
    B s ~ -step*gp; case 1 (ys < (1 - sigma2) sbs) blends y toward it;
    case 2 (ys > (1 + sigma3) sbs) is computed and stored only under
    ``damping_fixed`` (the reference drops it); ys and gamma stay
    pre-damping.  ``step`` (a host scalar, the reported step) is needed
    under damping only.  Reads (s.s, y.y) and the damping case to the
    host in one transfer, for the reference's two fatal checks."""
    s = x - xp
    y = gx - gp
    pairs = [(y, s), (s, s), (y, y)]
    if params.damping:
        if step is None:
            raise ValueError("the damped update needs the step")
        bs = -float(step) * gp
        pairs.append((s, bs))
    # one collective for the pass's products on a mesh
    ys, ss, yy, *sbs = vm.dots(*pairs)
    # gamma = ys / yy from the PRE-damping pair (src/lbfgs.rs:653-656)
    gamma = ys / torch.where(yy == 0.0, torch.ones_like(yy), yy)
    case = 0
    if params.damping:
        y, case = _damp_pair(params, y, bs, ys, sbs[0])
        ss_h, yy_h, case = to_host(ss, yy, case)
        case = int(case)
        _log_damping(case)
    else:
        ss_h, yy_h = to_host(ss, yy)
    status = 0
    if ss_h == 0.0:
        status = int(Status.ERR_X_NOT_CHANGED)
    elif yy_h == 0.0:
        status = int(Status.ERR_G_NOT_CHANGED)
    return PairUpdate(s=s, y=y, ys=ys, gamma=gamma, status=status, case=case)


def _damp_pair(params: LbfgsParams, y, bs, ys, sbs) -> tuple:
    """The damped y of ``update_pair`` and its case (0, 1, 2 in ys's dtype):
    case 1 (ys < (1 - sigma2) sbs) blends y toward bs, case 2 (ys > (1 +
    sigma3) sbs) only under ``damping_fixed``, each blend (1 - theta)*bs +
    theta*y.  One pair (y, bs [n]; ys, sbs 0-d) or, over a batch, each
    instance's (y, bs [B, n]; ys, sbs [B]): the blends are selected per
    instance, so an instance's y is its solo call's bit for bit for the
    same products.  No guard on the denominators, as in the JAX package:
    a blend not selected may divide by zero and is dropped."""
    col = lambda v: v.unsqueeze(-1)
    case1 = ys < (1.0 - SIGMA2) * sbs
    case2 = ~case1 & (ys > (1.0 + SIGMA3) * sbs)
    theta, apply = SIGMA2 * sbs / (sbs - ys), case1
    if params.damping_fixed:
        theta = torch.where(case1, theta, SIGMA3 * sbs / (ys - sbs))
        apply = case1 | case2
    y = torch.where(col(apply), (1.0 - col(theta)) * bs + col(theta) * y, y)
    return y, torch.where(case1, 1.0, torch.where(case2, 2.0, 0.0)).to(ys.dtype)


class PairUpdateBatched(NamedTuple):
    """``update_pair_batched``'s [B, n] pair and [B] scalars, on the device."""

    s: torch.Tensor
    y: torch.Tensor
    ys: torch.Tensor
    gamma: torch.Tensor
    #: s.s and y.y, for the caller's "x / g not changed" tests
    ss: torch.Tensor
    yy: torch.Tensor
    #: damping case per instance (0, 1, 2 in ys's dtype), None undamped
    case: Optional[torch.Tensor] = None


def update_pair_batched(params: LbfgsParams, x, xp, gx, gp, step=None) -> PairUpdateBatched:
    """``update_pair`` over B instances ([B, n] vectors; ``step`` the [B]
    reported steps on the device, needed under damping only), the batched
    runner's composed damped branch: each instance's products are [B] row
    products, its case and its damped y ``_damp_pair``'s.  Nothing is read
    to the host: ss, yy and the case ride the caller's one read."""
    s = x - xp
    y = gx - gp
    dot = fused.row_dot
    ys, ss, yy = dot(y, s), dot(s, s), dot(y, y)
    # gamma = ys / yy from the PRE-damping pair (src/lbfgs.rs:653-656)
    gamma = ys / torch.where(yy == 0.0, torch.ones_like(yy), yy)
    case = None
    if params.damping:
        if step is None:
            raise ValueError("the damped update needs the step")
        bs = -step[:, None] * gp
        y, case = _damp_pair(params, y, bs, ys, dot(s, bs))
    return PairUpdateBatched(s=s, y=y, ys=ys, gamma=gamma, ss=ss, yy=yy, case=case)


def _blend_row(Y: torch.Tensor, end: int, a, b, gx: torch.Tensor) -> None:
    """Persist the damped ring row in place from the NEW gradient (gp is
    gone in the lean state): a*y + b*gp = (a - b)*y + b*gx, rounded to
    the history dtype (``lbfgs_tpu/solver.py:766-769, 818-821``)."""
    Y[end] = ((a - b) * Y[end].to(gx.dtype) + b * gx).to(Y.dtype)


def _damped_gram(params: LbfgsParams, SP, YP, end: int, stp_d, gpgp, gp_d0):
    """The post-damping Gram quantities of the fused branches from the
    4-column basis SP = S.[y, s, d0, gp], YP = Y.[y, s, d0, gp] of the
    PRE-damping pair (``lbfgs_tpu/solver.py:704-771, 772-823``).  The
    damped pair is y_d = a*y + b*gp, with (a, b) from ys = s.y and sbs =
    s.(-stp_d*gp) alone, so every product with y_d is linear in the basis
    except y_d.y_d = a^2 yy + 2ab y.gp + b^2 gp.gp.  ``gpgp`` is gp.gp and
    ``gp_d0`` gp.d0.  [m]-scalar torch ops on the device: no host read.
    Returns (u, v, w, Yd_ring, a, b, case), case (0, 1, 2) in SP's dtype.

    The batched runner takes the same algebra over instances: SP, YP [B,
    m, 4] and stp_d, gpgp, gp_d0 [B] tensors give u, v, w, Yd_ring [B, m]
    and a, b, case [B], each instance's those of its solo call."""
    m = SP.shape[-2]
    if not torch.is_tensor(stp_d):
        stp_d = float(stp_d)
    ys_raw, yy_raw = SP[..., end, 0], YP[..., end, 0]
    sgp, ygp = SP[..., end, 3], YP[..., end, 3]
    sbs = -stp_d * sgp
    case1 = ys_raw < (1.0 - SIGMA2) * sbs
    case2 = ~case1 & (ys_raw > (1.0 + SIGMA3) * sbs)
    den1 = sbs - ys_raw
    theta1 = SIGMA2 * sbs / torch.where(den1 == 0.0, 1.0, den1)
    if params.damping_fixed:
        den2 = ys_raw - sbs
        theta2 = SIGMA3 * sbs / torch.where(den2 == 0.0, 1.0, den2)
        theta = torch.where(case1, theta1, torch.where(case2, theta2, 1.0))
        apply = case1 | case2
    else:
        # the literal case 2: computed (and counted), never stored
        theta = torch.where(case1, theta1, 1.0)
        apply = case1
    a = torch.where(apply, theta, 1.0)
    b = torch.where(apply, -(1.0 - theta) * stp_d, 0.0)
    # each instance's scalar against its [m] rows
    col = lambda v: v[..., None]
    is_end = torch.arange(m, device=SP.device) == end
    # S . y_d (row end is s . y_d, the same linear form)
    u = col(a) * SP[..., 0] + col(b) * SP[..., 3]
    # Y . s: the old rows are damped already; row end is y_d . s = s . y_d
    w = torch.where(is_end, u[..., end, None], YP[..., 1])
    # Y . y_d: linear for the old rows; row end the quadratic form
    ydyd = a * a * yy_raw + 2.0 * a * b * ygp + b * b * gpgp
    v = torch.where(is_end, col(ydyd), col(a) * YP[..., 0] + col(b) * YP[..., 3])
    Yd_ring = torch.where(is_end, col(a * YP[..., end, 2] + b * gp_d0), YP[..., 2])
    case = torch.where(case1, 1.0, torch.where(case2, 2.0, 0.0)).to(SP.dtype)
    return u, v, w, Yd_ring, a, b, case


# ---------------------------------------------------------------------------
# One full L-BFGS iteration (the k >= 2 path of LbfgsState::propagate)
# ---------------------------------------------------------------------------


def _fusion(pdef: ProblemDef, params: LbfgsParams, x: torch.Tensor, S: torch.Tensor):
    """The objective's combine+probe fusion (K15, under OWL-QN K16) where
    the solver runs it, else None: the objective carries it, it takes
    these operands, and the next search's entry step is known before the
    combine, i.e. the step is not capped (under the cap a probe at a
    guessed step would mostly be wasted), and the two-loop is the compact
    one."""
    if params.constrain_step_size or not params.compact_two_loop:
        return None
    name = "__lbfgs_combine_ow_probe" if pdef.orthantwise else "__lbfgs_combine_probe"
    fn = getattr(pdef.value_and_grad, name + "__", None)
    ok = getattr(pdef.value_and_grad, name + "_ok__", None)
    return fn if fn is not None and ok is not None and ok(x, S) else None


def propagate_core(pdef: ProblemDef, params: LbfgsParams, st: SolverState) -> SolverState:
    """One optimization iteration: line search, history update, two-loop,
    step size, and under OWL-QN the direction constraint
    (``LbfgsState::propagate``, ``src/lbfgs.rs:503-560``, minus the k == 1
    bookkeeping, which the callers do), under the wide objective scalar
    when ``params.fx_wide``.

    A line-search failure is terminal here: ERR_X_NOT_CHANGED is set in
    the same call (the reference errors on the next propagate, after its
    revert, src/line.rs:213-220); the carried scalars revert here and the
    vectors are reverted by the step-at-a-time loop.
    """
    with fused.wide_fx(params.fx_wide):
        return _propagate_core(pdef, params, st)


def _propagate_core(pdef: ProblemDef, params: LbfgsParams, st: SolverState) -> SolverState:
    prob = st.prob
    m = params.m
    lean = prob.xp is None
    ow = pdef.orthantwise
    damping = params.damping
    vag = pdef.value_and_grad
    hist = st.hist
    end = st.end
    scan = not params.compact_two_loop

    # save state (src/core.rs:207-210): same buffers, no copy
    xp, gp = prob.x, prob.gx

    # the one-pass epilogue: K4, or under OWL-QN K14; not under the
    # speculative search, whose candidate pass materializes nothing: it
    # materializes the accepted point itself (K1, K7), and the pair + Gram
    # pass is K5 or K12 (lbfgs_tpu/solver.py:518, 542)
    prefix = "__lbfgs_owlqn_trial_pair_gram" if ow else "__lbfgs_trial_pair_gram"
    mega_fn = getattr(vag, prefix + "__", None)
    mega_ok = getattr(vag, prefix + "_ok__", None)
    use_mega = (not scan and int(params.linesearch.speculative) <= 1 and mega_fn is not None
                and mega_ok is not None and mega_ok(xp, hist.s))
    # a history the ring kernels refuse (float16): the composed pair +
    # Gram pass and combine in torch ops (lbfgs_tpu/solver.py:475-484, 144)
    composed = not fused.can_pair_gram(xp, hist.s)
    if composed:
        def combine(*a):
            return fused.summed(fused.combine_plain(*a))

        def combine_ow(*a):
            return fused.summed(fused.combine_ow_plain(*a))
    else:
        combine = getattr(vag, "__lbfgs_combine__", fused.combine)
        combine_ow = getattr(vag, "__lbfgs_combine_ow__", fused.combine_ow)
    combine_fix = getattr(vag, "__lbfgs_combine_fix__", fused.combine_fix)

    ls = ls_find(pdef, params.linesearch, xp, prob.fx, gp, prob.d, st.step,
                 prob.neval, dginit=st.dg0, materialize=not use_mega, pgp=prob.pg,
                 probe1=st.probe1)
    ls_failed = ls.status != 0
    step_ls = st.step if ls_failed else ls.step

    # the next search's entry step, known before the two-loop where the
    # step is not capped (lbfgs_tpu/solver.py:883-910): 1.0, or under the
    # adaptive policy clip(growth*step_ls, 2^-16, 1), literal 1.0 while
    # k <= 2 (the first search's step reflects the init's entry, not the
    # ladder).  Under the cap it comes from ||d|| after the combine
    f = type(st.step)
    stp_pred = None
    if not params.constrain_step_size:
        stp_pred = f(1.0)
        if params.adaptive_entry_step > 0.0 and st.k > 2:
            stp_pred = f(np.clip(f(params.adaptive_entry_step) * step_ls, f(2.0 ** -16),
                                 f(1.0)))
    fusion = _fusion(pdef, params, xp, hist.s)

    pg = pgpg = pu = gp_scalars = None
    if use_mega and ow:
        # one pass: the accepted projected point, its gradient and
        # pseudo-gradient, the pair (x - xp, g - gp) written into ring row
        # `end` and all 6m products against (y, s, -pg); in the lean state
        # x, g and pg overwrite xp, gp and the previous pg in place.
        # Damped: also the . gp column, gp.gp and gp.pg (K14 with_gp)
        lo, hi = pdef.owlqn.start_end(xp.shape[0])
        (x, gx, pg, SP, YP, ls_xx, pgpg, ls_changed, *gp_scalars) = mega_fn(
            xp, prob.d, gp, prob.pg, ls.step_eval, pdef.owlqn.c, lo, hi,
            hist.s, hist.y, end, inplace=lean, with_gp=damping,
        )
    elif use_mega:
        # one pass: the accepted (x, g), the pair written into ring row
        # `end` and all 6m Gram products (8m damped: K4 with_gp); in the
        # lean state x and g overwrite xp and gp in place
        (x, _fx, gx, _dg, ls_gg, ls_xx, ls_changed, SP, YP) = mega_fn(
            xp, prob.d, gp, ls.step_eval, hist.s, hist.y, end, inplace=lean,
            with_gp=damping,
        )
    else:
        x, gx = ls.x, ls.gx
        ls_gg, ls_xx, ls_changed = ls.gg, ls.xx, ls.changed
        if ow:
            # pseudo-gradient and its norm (K10)
            pg, pgpg = pseudo_gradient_and_norm(pdef, x, gx)
        if scan:
            # the literal iteration (lbfgs_tpu/solver.py:628-637): the
            # pair (damped if asked), stored, and no Gram products
            pu = update_pair(params, x, xp, gx, gp, step_ls)
            hist.s[end] = pu.s.to(hist.s.dtype)
            hist.y[end] = pu.y.to(hist.y.dtype)
        elif damping and (ls_changed is None or composed):
            # composed damped branch (generic objectives, or a history the
            # ring kernels refuse; plain or OWL-QN; lbfgs_tpu/solver.py:
            # 628-650): the damped pair, stored, then the Gram products of
            # the STORED pair with d0 = -g (-pg)
            pu = update_pair(params, x, xp, gx, gp, step_ls)
            SP, YP = fused.pair_gram_ref(pu.s, pu.y, pg if ow else gx,
                                         hist.s, hist.y, end)
        elif composed:
            # the JAX package's jnp pair + Gram pass (lbfgs_tpu/solver.py:
            # 475-484), whose s.s == 0 test decides "x not changed"
            ls_changed = None
            SP, YP = fused.pair_gram_ref(x - xp, gx - gp, pg if ow else gx,
                                         hist.s, hist.y, end)
        elif ow:
            # composed OWL-QN branch: the pair of the projected step,
            # s = x - xp, with d0 = -pg, in one pass (K12).  Damped (a
            # fused trial without K14, e.g. a ring deeper than it takes):
            # with the . gp column, gp.gp and gp.pg, for K14's
            # reconstruction below, as the JAX package runs K14 at any depth
            SP, YP, *gp_scalars = fused.pair_gram_xg(x, xp, gx, gp, pg, hist.s, hist.y,
                                                     end, with_gp=damping)
        elif ls_changed is not None:
            # fused trial but no one-pass epilogue: K5 from s = stp*d
            # (with the . gp column when damped)
            SP, YP = fused.pair_gram_sd(ls.step_eval, prob.d, gx, gp, hist.s, hist.y,
                                        end, with_gp=damping)
        else:
            SP, YP = fused.pair_gram_ref(x - xp, gx - gp, gx, hist.s, hist.y, end)
    fx = ls.fx
    bound = min(m, st.k - 1)
    row_fix = case = probe = None
    if scan:
        # the literal two-loop (src/lbfgs.rs:538-540; lbfgs_tpu/solver.py:
        # 726-728) on d0 = -g (-pg), then under OWL-QN the direction
        # constraint (src/lbfgs.rs:554), ||d||^2 before it and the next
        # search's dginit = g . d (pg . d) as dots
        ys = hist.ys.clone()
        ys[end] = pu.ys
        hist = hist._replace(ys=ys)
        g0 = pg if ow else gx
        d, alpha_ring = two_loop_scan(hist, -g0, pu.gamma, bound, end)
        if ow:
            dd = torch.dot(d, d)
            d = ow_ops.constrain_direction(pdef.owlqn, d, pg)
            dd, *rd = mesh_sum(dd, torch.dot(d, d), torch.dot(g0, d))
        else:
            dd, rd = vm.dots((d, d), (g0, d))
    else:
        u = SP[:, 0]         # S . y_new
        v = YP[:, 0]         # Y . y_new
        w = YP[:, 1]         # Y . s_new
        Sd_ring = SP[:, 2]   # S . d0
        Yd_ring = YP[:, 2]   # Y . d0
        ss_new, ys_new, yy_new = SP[end, 1], SP[end, 0], YP[end, 0]
        if damping and pu is None:
            # the fused reconstructions (lbfgs_tpu/solver.py:704-823): the
            # plain one with the search's evaluated step and the carried
            # ||gp||^2, gp.d0 = -(y.gp + gp.gp); the OWL-QN one with the
            # reported step and K14's own gp.gp and gp.pg_new (the carried
            # norm is ||pg_prev||^2 there; K12's where K14 did not run),
            # gp.d0 = -gp.pg_new
            if ow:
                gpgp, gppg = gp_scalars
                u, v, w, Yd_ring, a, b, case = _damped_gram(
                    params, SP, YP, end, step_ls, gpgp, -gppg)
                _blend_row(hist.y, end, a, b, gx)
            else:
                gpgp = float(prob.gnorm2)
                u, v, w, Yd_ring, a, b, case = _damped_gram(
                    params, SP, YP, end, ls.step_eval, gpgp, -(YP[end, 3] + gpgp))
                # the same row, persisted by the combine (K6, or K15's fix
                # form; the JAX package blends it before K15,
                # lbfgs_tpu/solver.py:758-769)
                row_fix = (end, a - b, b)
        sy = hist.sy.clone()
        sy[:, end] = u
        sy[end, :] = w
        yy = hist.yy.clone()
        yy[:, end] = v
        yy[end, :] = v
        if pu is not None:
            # composed: ys and gamma from update_pair, pre-damping
            ys_new, gamma = pu.ys, pu.gamma
        else:
            # gamma = ys/yy of the new pair, pre-damping (src/lbfgs.rs:653-656)
            gamma = ys_new / torch.where(yy_new == 0.0, torch.ones_like(yy_new), yy_new)
        ys = hist.ys.clone()
        ys[end] = ys_new
        hist = History(s=hist.s, y=hist.y, ys=ys, alpha=hist.alpha, sy=sy, yy=yy)

        # two-loop (src/lbfgs.rs:538-540) on d0 = -g (-pg under OWL-QN), the
        # sign folded in; under OWL-QN the combine also constrains the
        # direction (src/lbfgs.rs:554)
        probe_fuse = None
        if fusion is not None:
            probe_fuse = (fusion, x) + ((pdef.owlqn.c,) if ow else ()) + (stp_pred,)
        d, alpha_ring, dd, rd, probe = two_loop_compact(
            hist, pg if ow else gx, gamma, bound, end, Sd_ring, Yd_ring, neg=True,
            combine=combine, combine_ow=combine_ow,
            ow_window=pdef.owlqn.start_end(xp.shape[0]) if ow else None,
            row_fix=row_fix, combine_fix=combine_fix, probe_fuse=probe_fuse,
        )
    hist = hist._replace(alpha=alpha_ring)

    # the one read of the iteration: what the host decides on next, the
    # fused branches' damping case and the fusion's probe included.
    # Generic objectives carry no `changed` count: the reference's s.s == 0
    # test decides then (src/lbfgs.rs:646).  The combine's fourth value is
    # r . g, under OWL-QN (||rc||^2, rc . pg)
    # update_pair has read (s.s, y.y) and decided the status itself
    if pu is None and ls_changed is None:
        ls_changed = ss_new != 0.0
    rc2, rd = rd if ow else (None, rd)
    extra = ([rc2] if ow else []) + ([case] if case is not None else [])
    lead = [dd, rd] if pu is not None else [yy_new, dd, rd, ls_changed]
    # the speculative search leaves its fx, the materialized trial's, on
    # the device for this read
    fx_dev = [fx] if torch.is_tensor(fx) else []
    scalars = fx_dev + lead + extra + (probe or [])
    if ls_failed:
        gnorm2, xnorm2 = prob.gnorm2, prob.xnorm2
        vals = to_host(*scalars)
    else:
        gnorm2, xnorm2, *vals = to_host(pgpg if ow else ls_gg, ls_xx, *scalars)
    if fx_dev:
        fx, *vals = vals
    if pu is not None:
        dd_h, dg0, *extra_h = vals
    else:
        yy_h, dd_h, dg0, changed, *extra_h = vals
    probe1 = None
    if probe:
        *extra_h, p_ft_h, p_dg_h = extra_h
        probe1 = (p_ft_h, p_dg_h, stp_pred)
    rc2_h = extra_h[0] if ow else None
    if case is not None:
        case = int(extra_h[-1])
        _log_damping(case)
    elif pu is not None:
        case = pu.case

    # status: the reference's s == 0 "x not changed" test
    # (src/lbfgs.rs:646) is decided by the trial's exact `changed` count,
    # or on the composed damped branch by update_pair's own read
    if ls_failed:
        status = int(Status.ERR_X_NOT_CHANGED)
    elif pu is not None:
        status = pu.status
    elif not changed:
        status = int(Status.ERR_X_NOT_CHANGED)
    elif yy_h == 0.0:
        status = int(Status.ERR_G_NOT_CHANGED)
    else:
        status = 0
    dnorm = np.sqrt(dd_h)
    # the reference's check is `dnorm.is_sign_positive()`, which ACCEPTS
    # +0.0 (src/lbfgs.rs:544); only NaN/negative is fatal
    if status == 0 and not dnorm >= 0.0:
        status = int(Status.ERR_INVALID_DNORM)
    # OWL-QN: the constrained direction must not vanish (the reference's
    # assertion in constrain_search_direction, src/orthantwise.rs:140-161)
    if status == 0 and ow and rc2_h == 0.0:
        status = int(Status.ERR_OWLQN_ZERO_DIRECTION)

    # next-iteration step size (src/lbfgs.rs:547-551), from the norm
    # before the OWL-QN constraint; uncapped, the entry predicted above
    if params.constrain_step_size:
        dnorm_safe = dnorm if dnorm != 0.0 else f(1.0)
        step_next = np.minimum(f(params.max_step_size), dnorm) / dnorm_safe
    else:
        step_next = stp_pred
    if ls.status == Status.ERR_NEGATIVE_STEP:
        # a negative entry step bubbles out of find (src/line.rs:197-201)
        status = int(Status.ERR_NEGATIVE_STEP)

    prob_new = ProblemState(
        x=x, fx=fx, gx=gx,
        xp=None if lean else xp, gp=None if lean else gp, pg=pg,
        d=d, neval=ls.neval, gnorm2=gnorm2, xnorm2=xnorm2,
    )
    cases = st.damping_cases
    if case is not None:
        cases = tuple(c + (i == case) for i, c in enumerate(cases))
    return SolverState(
        prob=prob_new, hist=hist, end=(end + 1) % m, step=f(step_next),
        step_ls=step_ls, k=st.k, ncall=ls.ncall, status=status,
        ls_status=ls.status, pf=st.pf, dg0=dg0, damping_cases=cases, probe1=probe1,
    )


def fx_delta_step(params: LbfgsParams, st: SolverState) -> SolverState:
    """Compare-then-store for the (flag-gated) past/delta fx-plateau stop
    test, once per iteration in every loop: the literal semantics of
    the reference's dead-code ``satisfying_delta`` (``src/lbfgs.rs:767-787``),
    rate = |pf[k % past] - fx| / fx with the current fx as (signed)
    denominator, firing once ``past <= k``."""
    if not (params.fx_delta_enabled and params.past > 0):
        return st
    fx = st.prob.fx
    slot = st.k % params.past
    with np.errstate(all="ignore"):
        rate = np.abs(st.pf[slot] - fx) / fx
    status = st.status
    if status == Status.RUNNING and st.k >= params.past and rate < params.delta:
        status = int(Status.CONVERGED)
    pf = st.pf.copy()
    pf[slot] = fx
    return st._replace(pf=pf, status=status)


def propagate_hot(pdef: ProblemDef, params: LbfgsParams, st: SolverState) -> SolverState:
    """Propagate for states past the k == 1 bookkeeping step."""
    return fx_delta_step(params, propagate_core(pdef, params, st._replace(k=st.k + 1)))


def start_state(st: SolverState, params: Optional[LbfgsParams] = None) -> SolverState:
    """The k == 1 "report initial point" bookkeeping
    (``src/lbfgs.rs:504-510``): no compute; Progress.step is the initial
    step (``src/lbfgs.rs:564``)."""
    st = st._replace(k=1, step_ls=st.step)
    if params is not None:
        st = fx_delta_step(params, st)
    return st


# ---------------------------------------------------------------------------
# Initialization (the build path)
# ---------------------------------------------------------------------------


def check_supported(params: LbfgsParams, pdef: Optional[ProblemDef] = None) -> None:
    """Raise ``NotImplementedError`` naming any setting this package does
    not run: on a mesh a generic objective that does not declare the local
    contract
    (``ops.collective.local_objective``: handed this rank's shard, it
    returns the whole vector's fx and the shard's gradient).  On a mesh an
    objective built by ``ops.factory.make_fused_objective`` runs its
    kernels on the shard, and a generic one under the contract runs every
    branch a generic objective takes without one: plain, OWL-QN, damped,
    the scan two-loop and the wide objective scalar."""
    vag = None if pdef is None else pdef.value_and_grad
    if (vag is not None and active_mesh() is not None
            and getattr(vag, "__lbfgs_trial__", None) is None
            and not keeps_local_contract(vag)):
        name = getattr(vag, "__qualname__", repr(vag))
        raise NotImplementedError(
            f"a generic objective ({name}) on a mesh without the local contract: "
            "declare it with parallel.local_objective once, handed this rank's shard "
            "of x, it returns the whole vector's fx (the same on every rank) and the "
            "shard's gradient; or build it with make_fused_objective")


def init_state(pdef: ProblemDef, params: LbfgsParams, x0: torch.Tensor,
               lean: bool = False) -> SolverState:
    """Initial evaluation, steepest-descent direction and initial step
    (``Lbfgs::build``, ``src/lbfgs.rs:443-481``; ``lbfgs_tpu/solver.py:
    1159-1201``).

    With a fused-trial objective the evaluation is its trial at stp = 0
    (K1): x0 + 0*x0 reproduces x0, and fx, g, ||g||^2 and ||x||^2 come
    out of one pass.  Under OWL-QN fx gains c*||x0||_1 over the window (a
    torch reduction, as the JAX package computes it outside any kernel)
    and K10 gives the pseudo-gradient and its norm.  Under the wide
    objective scalar an OWL-QN factory objective is evaluated instead by
    its projected trial (K7) at stp = 0 with wp = x0, which projects
    nothing, so fx and its L1 term are summed in float64; the default
    init keeps its pinned numerics.  A generic objective is evaluated
    once, and under OWL-QN K11 gives pg and a dot its norm.  Then d =
    -pg (-g), the step is initial_inverse_hessian / ||d|| and dginit =
    -||d||^2.  ``lean=True`` carries no previous-point slots (the
    whole-run loop; see ``ProblemState``).
    """
    check_supported(params, pdef)
    fused.check_dtypes(x0.dtype)
    if x0.ndim != 1:
        raise ValueError(f"x0 must be 1-D, got shape {tuple(x0.shape)}")
    hdtype = getattr(torch, params.history_dtype) if params.history_dtype else x0.dtype
    with fused.wide_fx(params.fx_wide):
        return _init_state(pdef, params, x0.contiguous(), hdtype, lean)


def _init_state(pdef: ProblemDef, params: LbfgsParams, x0: torch.Tensor,
                hdtype: torch.dtype, lean: bool) -> SolverState:
    n, m = x0.shape[0], params.m
    f = np_type(x0.dtype)
    vag = pdef.value_and_grad
    trial = getattr(vag, "__lbfgs_trial__", None)
    ow_trial = getattr(vag, "__lbfgs_owlqn_trial__", None)
    pg = None
    if pdef.orthantwise and ow_trial is not None and fused.wide(x0.dtype):
        c, lo, hi = pdef.owlqn.c, *pdef.owlqn.start_end(n)
        x, fx_t, gx, _dg, xx_t, _ch = ow_trial(x0, x0, x0, f(0.0), c, lo, hi)
        pg, gg_t = pseudo_gradient_and_norm(pdef, x, gx)
    elif trial is not None:
        x, fx_t, gx, _dg, gg_t, xx_t, _ch = trial(x0, x0, f(0.0))
        if pdef.orthantwise:
            fx_t = fx_t + ow_ops.x1norm(pdef.owlqn, x)
            pg, gg_t = pseudo_gradient_and_norm(pdef, x, gx)
    else:
        x = x0.clone()
        fx_t, gx = evaluate(pdef, x)
        if pdef.orthantwise:
            pg = pseudo_gradient(pdef, x, gx)
        xx_t, gg_t = vm.dots((x, x), (gx, gx) if pg is None else (pg, pg))
    # fx in the objective scalar's dtype (float64 under the wide mode), the
    # norms in the vectors'
    fx_h, gnorm2, xnorm2 = to_host(fx_t, gg_t, xx_t)
    fx = np_type(fused.obj_dtype(x0.dtype))(fx_h)
    gnorm2, xnorm2 = f(gnorm2), f(xnorm2)
    d = -(gx if pg is None else pg)
    # step = initial_inverse_hessian / ||d||, and ||d|| = ||g|| (||pg||)
    step = f(params.initial_inverse_hessian) / np.sqrt(gnorm2 if gnorm2 != 0.0 else f(1.0))

    prob = ProblemState(
        x=x, fx=fx, gx=gx,
        xp=None if lean else torch.zeros_like(x),
        gp=None if lean else torch.zeros_like(x),
        pg=pg, d=d, neval=1, gnorm2=gnorm2, xnorm2=xnorm2,
    )
    z = dict(dtype=x0.dtype, device=x0.device)
    hist = History(
        s=ring_zeros((m, n), hdtype, x0.device),
        y=ring_zeros((m, n), hdtype, x0.device),
        ys=torch.zeros(m, **z), alpha=torch.zeros(m, **z),
        sy=torch.zeros((m, m), **z), yy=torch.zeros((m, m), **z),
    )
    if params.fx_delta_enabled and params.past > 0:
        # zero-initialized like the reference's pf, with the k == 0 store
        pf = np.zeros(params.past, dtype=type(fx))
        pf[0] = fx
    else:
        pf = None
    # the combine+probe slot, iff the fusion will run in propagate
    # (lbfgs_tpu/solver.py:1237-1258).  Its first value is dead: the probed
    # step -1 equals no entry step, not even an initial step of exactly
    # 1.0 (initial_inverse_hessian == ||d||)
    fusion = _fusion(pdef, params, x0, hist.s)
    probe1 = None if fusion is None else (fx, -gnorm2, f(-1.0))
    return SolverState(
        prob=prob, hist=hist, end=0, step=f(step), step_ls=f(step), k=0,
        ncall=0, status=0, ls_status=0, pf=pf,
        # d = -g (-pg), so dginit = -||g||^2 exactly (IEEE sign symmetry)
        dg0=-gnorm2, probe1=probe1,
    )


# ---------------------------------------------------------------------------
# Stop conditions (src/lbfgs.rs:695-748)
# ---------------------------------------------------------------------------


def stop_status(params: LbfgsParams, st: SolverState) -> int:
    """The stop Status of the CURRENT state (checked before each
    propagate, ``src/lbfgs.rs:407-410``), or RUNNING.  Order parity with
    ``satisfying_stop_conditions`` (``src/lbfgs.rs:697-709``):
    max_iterations, then max_evaluations, then the scaled gnorm.  Reads
    only host scalars."""
    out = int(Status.RUNNING)
    if st.status != Status.RUNNING:
        out = st.status
    if params.max_iterations != 0 and st.k >= params.max_iterations:
        out = int(Status.MAX_ITERATIONS)
    if (params.max_evaluations != 0 and out == Status.RUNNING
            and st.prob.neval >= params.max_evaluations):
        out = int(Status.MAX_EVALUATIONS)
    f = type(st.prob.gnorm2)
    gnorm, xnorm = gnorm_of(st.prob), xnorm_of(st.prob)
    if out == Status.RUNNING and gnorm / np.maximum(xnorm, f(1.0)) <= f(params.epsilon):
        out = int(Status.CONVERGED)
    return out
