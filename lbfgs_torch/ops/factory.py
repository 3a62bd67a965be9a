"""Objective-agnostic fused-kernel factory (``make_fused_objective``).

The user supplies an objective as a per-block body plus its plain torch
``value_and_grad``; the factory returns an objective carrying the fused
protocol the solver looks for:

  * ``__lbfgs_trial__(xp, d, stp)`` — K1: xt = xp + stp*d, (fx, g) at xt,
    and g.d, g.g, xt.xt, any(xt != xp) from one pass;
  * ``__lbfgs_trial_probe__(xp, d, stp)`` — K2: (fx, g.d) at xp + stp*d
    with no vector written (the More-Thuente step);
  * ``__lbfgs_trial_pair_gram__(...)`` / ``..._ok__`` — K4: the trial, the
    correction pair written into ring row ``end``, and all 6m Gram
    products in one pass (the iteration's epilogue); ``with_gp=True``
    adds the damped update's . gp column;
  * ``__lbfgs_owlqn_trial__`` — K7: the OWL-QN trial point pi(xp +
    stp*d; wp) and its gradient, with fx + c*L1, g.d, x.x and changed from
    one pass (the wide mode's init, and the OWL-QN search when the
    solver's epilogue does not materialize);
  * ``__lbfgs_owlqn_probe__`` / ``__lbfgs_owlqn_probe_pg__`` — K8: (fx +
    c*L1, g.d) at the same point, writing no vector, the orthant given,
    or rebuilt in registers from (xp, pg);
  * ``__lbfgs_owlqn_trial_pair_gram__(...)`` / ``..._ok__`` — K14: the
    OWL-QN epilogue, the projected point with its gradient and
    pseudo-gradient, the pair (x - xp, g - gp) written into ring row
    ``end`` and all 6m products against (y, s, -pg); ``with_gp=True``
    adds the . gp column, gp.gp and gp.pg (damped OWL-QN);
  * ``__lbfgs_combine__`` / ``__lbfgs_combine_fix__`` /
    ``__lbfgs_combine_ow__`` — the direction combine (K3,
    ``fused.combine``), its form that persists the damped ring row (K6,
    ``fused.combine_fix``) and its OWL-QN form (K13, ``fused.combine_ow``);
  * ``__lbfgs_pseudo_gradient_norm__`` / ``__lbfgs_pseudo_gradient__`` —
    OWL-QN's (pg, pg.pg) (K10, ``fused.pseudo_gradient_norm``), which the
    solver's init runs, and pg alone (K11, ``fused.pseudo_gradient``),
    which the revert of a failed search runs;
  * ``__lbfgs_combine_probe__`` / ``__lbfgs_combine_ow_probe__`` (and
    their ``_ok__`` predicates) — the combine+probe fusions K15 and K16:
    K3's (K13's) combine with the next search's first probe at x +
    stp1*r in the same pass, its (ft, g.r) those of K2 (K8's pg form) at
    that point bit for bit; K15's ``fix`` form also persists K6's damped
    ring row.  The solver runs them wherever the step is not capped.

Under the wide objective scalar (``fused.wide_fx``, ``params.fx_wide``)
the objective's column of K1, K2, K4, K7 and K8 and the L1 column of K7
and K8 are summed in float64 (``fused.obj_reduce``), and K7's and K8's
fx + c*L1 is formed in float64; every other output is that of the
default launch, bit for bit.

Each wrapper launches its Triton kernel (``ops/_factory_triton.py``) on a
CUDA tensor and runs its plain version (``*_ref``, same module) on a CPU
tensor.  Launches and plain calls are counted on the functions
(``fn.launches``, ``ref.calls``; K4's and K14's ``.gp_launches`` count
their ``with_gp`` launches among ``.launches``, K15's ``.fix_launches``
its damped-row launches).  ``objective.plain`` is
a twin objective whose protocol runs the plain versions on any device:
the reference that a run through the kernels is compared with on the
card.

Contract for the body: a ``@triton.jit`` function ``body(x, gidx) ->
(fx_elem, g)`` over one ``[ROWS, row]`` block (``gidx`` the global
element indices), in which elements couple only within a row of ``row``
elements (Rosenbrock's (2i, 2i+1) pairs: ``row=2``).  ``fx_elem`` holds
the per-element objective terms; the kernels mask the ragged tail.
``block_fn`` is a zero-argument loader returning that body, called at the
first launch, so that ``triton`` is only imported where a kernel runs.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from . import _build, fused
from ..orthantwise import (Orthantwise, choose_orthant, project_window, pseudo_gradient,
                           x1norm)

#: elements per kernel program (a power of two; ``row`` divides it)
BLOCK = 1024
NUM_WARPS = 4
#: launch options of K1, K2 and K4.  No multiply-add contraction: with it
#: the compiler may form y = g - gp as one fma from the body's last
#: product, so the stored ring row would not be round(g - gp) of the g the
#: kernel returns; without it every kernel computes x = xp + stp*d and the
#: body as the plain versions do, and K2 and K4 see the same point
LAUNCH = dict(num_warps=NUM_WARPS, enable_fp_fusion=False)


#: the launch of the epilogues K4 and K14 per (vector, history) dtype pair:
#: tiles of T elements (a power of two) addressed as [T // V, V], so each
#: thread holds runs of V consecutive elements; each program loops over
#: ``tiles`` consecutive tiles and keeps its sums in registers across them
#: (``epilogue_grid``).  Chosen on an NVIDIA H100 80GB HBM3 at its 700 W
#: limit with ``tools/tune_epilogues.py`` and
#: ``tools/screen_epilogue_launches.py`` (n = 2^24, m = 6): f32/bf16 at T =
#: 512, V = 4, 4 warps, 1 stage, 32 programs per SM took K4 0.2805 ms, ·gp
#: 0.3302, K14 0.3254, ·gp 0.3947 with 124-148 registers and no spill, and
#: every n = 2^24 path of chip_smoke.py ended as it must.  V = 8 (16-byte
#: bf16 loads; 168-216 registers) ran 0.2709 / 0.3282 / 0.3339 / 0.3950 at
#: 32 programs per SM, and 0.2614-0.2708 / 0.2873-0.3059 / 0.3388-0.3393 /
#: 0.3708-0.3710 at 8, but under every V = 8 launch screened an epsilon-0
#: path ended in "x not changed" or the damped plain-versions check parted,
#: as under 4 of the 5 V = 4 launches screened (PERF.md, section 6).  Float64
#: sums (0.305 / 0.385 / 0.430 / 0.393) were slower and parted the main
#: path.  f32/f32 and f64 take the widest V that spills nothing.
EPILOGUE = {
    (torch.float32, torch.bfloat16): dict(T=512, V=4, num_warps=4, num_stages=1),
    (torch.float32, torch.float32): dict(T=512, V=4, num_warps=4, num_stages=1),
    (torch.float64, torch.float64): dict(T=256, V=2, num_warps=4, num_stages=1),
}
#: most programs an epilogue launches: 32 on each of the H100's 132 SMs
EPILOGUE_PROGRAMS = 32 * 132


def epilogue_grid(n: int, vdtype: torch.dtype, hdtype: torch.dtype) -> SimpleNamespace:
    """The launch of K4 and K14 at n elements of ``vdtype`` vectors with a
    ``hdtype`` history: the tile T and the run V of consecutive elements a
    thread holds, the tiles of T elements that cover n, the tiles each
    program loops over and the program count (at most
    ``EPILOGUE_PROGRAMS``; fewer, with one tile each, for a small n).  The
    last program's tiles may run past n: they are masked, and their
    objective partials are 0."""
    cfg = EPILOGUE[(vdtype, hdtype)]
    ntiles = -(-n // cfg["T"])
    tiles = -(-ntiles // EPILOGUE_PROGRAMS)
    programs = -(-ntiles // tiles)
    return SimpleNamespace(**cfg, ntiles=ntiles, tiles=tiles, programs=programs)


def epilogue_partials(grid: SimpleNamespace, m: int, owlqn: bool, with_gp: bool) -> dict:
    """The shapes of an epilogue's partials: the objective's (K4 only), one
    per tile of every program; the program's sums ([programs, 4 + 6m] for
    K4: g.d, g.g, x.x, changed, then the six products of each ring row;
    [programs, 3 + 6m] for K14: x.x, pg.pg, changed, then the products);
    with ``with_gp`` the . gp column's ([programs, 2m] for K4, [programs,
    2 + 2m] for K14 with gp.gp, gp.pg first)."""
    out = {} if owlqn else {"fx": (grid.programs * grid.tiles,)}
    out["part"] = (grid.programs, (3 if owlqn else 4) + 6 * m)
    if with_gp:
        out["gpart"] = (grid.programs, (2 if owlqn else 0) + 2 * m)
    return out


def _epilogue_buffers(x: torch.Tensor, eg: SimpleNamespace, m: int, owlqn: bool,
                      with_gp: bool) -> dict:
    """An epilogue's partials on x's device, in the vectors' dtype."""
    return {k: torch.empty(v, dtype=x.dtype, device=x.device)
            for k, v in epilogue_partials(eg, m, owlqn, with_gp).items()}


def _rows(m: int) -> int:
    """m rounded up to a power of two: the ring tile's row count."""
    return 1 << (m - 1).bit_length()


def _kernels():
    _build.import_triton()
    from . import _factory_triton

    return _factory_triton


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A host scalar as a 1-element tensor on like's device and dtype (the
    kernels load the step from memory: a Python float argument would be
    narrowed to float32)."""
    return torch.full((1,), float(v), dtype=like.dtype, device=like.device)


_window = fused._check_window


def _fx(part: torch.Tensor, tot: torch.Tensor) -> torch.Tensor:
    """The objective from column 0 of a kernel's partials: summed in
    float64 under the wide mode, else the column's fixed-order sum."""
    return fused.obj_reduce(part[:, 0]) if fused.wide(part.dtype) else tot[0]


def _fx_tiles(fxp: torch.Tensor) -> torch.Tensor:
    """The objective from an epilogue's per-tile partials: summed in
    float64 under the wide mode, else their fixed-order sum."""
    return fused.obj_reduce(fxp) if fused.wide(fxp.dtype) else fused.reduce_partials(fxp)


def _epilogue_launch(eg: SimpleNamespace) -> dict:
    """Launch options of K4 and K14: ``LAUNCH``'s, with the warps and
    pipeline stages of ``EPILOGUE``."""
    return dict(LAUNCH, num_warps=eg.num_warps, num_stages=eg.num_stages)


def _ow_probe_scalars(part: torch.Tensor, c: float) -> tuple:
    """(fx + c*L1, g.d) from K7's or K8's [programs, 3] (f, L1, g.d)
    partials, by one code path for both kernels: fx + c*L1 in float64
    under the wide mode (``lbfgs_tpu/ops/factory.py:440-448``), else in
    the vectors' dtype."""
    tot = fused.reduce_partials(part)
    if fused.wide(part.dtype):
        fx, l1 = fused.obj_reduce(part[:, :2])
        return fx + c * l1, tot[2]
    return tot[0] + tot[1] * c, tot[2]


def make_fused_objective(block_fn, value_and_grad, *, row: int = 1,
                         validate=None):
    """Build a fused objective from a per-block body.

    Args:
      block_fn: zero-argument loader of the ``@triton.jit`` body (see the
        module docstring).
      value_and_grad: plain torch ``x -> (fx, gx)``; the plain versions
        of the kernels evaluate through it.
      row: width of the rows the body couples elements in.
      validate: optional ``validate(n)`` raising on unsupported sizes.
    """
    if BLOCK % row or any(cfg["T"] % row for cfg in EPILOGUE.values()):
        raise ValueError(f"row={row} must divide the block of {BLOCK} and the epilogues' tiles")
    rows = BLOCK // row

    def _check(x: torch.Tensor) -> None:
        fused.check_dtypes(x.dtype)
        if x.ndim != 1:
            raise ValueError(f"expected a 1-D iterate, got shape {tuple(x.shape)}")
        if validate is not None:
            validate(x.shape[0])
        if x.shape[0] % row:
            raise ValueError(f"n={x.shape[0]} is not a multiple of row={row}")

    def _grid(n: int) -> tuple[int]:
        return (-(-n // BLOCK),)

    # ------------------------------------------------------------ K1 trial

    def trial_ref(xp, d, stp):
        """Plain version of ``trial``."""
        trial_ref.calls += 1
        xt = xp + float(stp) * d
        fx, g = value_and_grad(xt)
        return (xt, fused.obj_lift(fx, xt.dtype), g, torch.dot(g, d), torch.dot(g, g),
                torch.dot(xt, xt), torch.any(xt != xp))

    def trial(xp, d, stp):
        """(xt, fx, g, g.d, g.g, xt.xt, changed) at xt = xp + stp*d; the
        scalars are 0-d tensors on xp's device."""
        _check(xp)
        if not fused.on_cuda(xp, "trial"):
            return trial_ref(xp, d, stp)
        fused.check_contiguous("trial", xp, d)
        n = xp.shape[0]
        grid = _grid(n)
        xt = torch.empty_like(xp)
        g = torch.empty_like(xp)
        part = torch.empty((grid[0], 5), dtype=xp.dtype, device=xp.device)
        _kernels().trial_kernel[grid](
            xp, d, _scalar(stp, xp), xt, g, part, n,
            body=block_fn(), ROWS=rows, W=row, **LAUNCH,
        )
        trial.launches += 1
        tot = fused.reduce_partials(part)
        return xt, _fx(part, tot), g, tot[1], tot[2], tot[3], tot[4] > 0

    # ------------------------------------------------------------ K2 probe

    def _probe_plain(xp, d, stp):
        fx, g = value_and_grad(xp + float(stp) * d)
        return fused.obj_lift(fx, xp.dtype), torch.dot(g, d)

    def probe_ref(xp, d, stp):
        """Plain version of ``probe``."""
        probe_ref.calls += 1
        return _probe_plain(xp, d, stp)

    def probe(xp, d, stp):
        """(fx, g.d) at xp + stp*d, writing no vector."""
        _check(xp)
        if not fused.on_cuda(xp, "probe"):
            return probe_ref(xp, d, stp)
        fused.check_contiguous("probe", xp, d)
        n = xp.shape[0]
        grid = _grid(n)
        part = torch.empty((grid[0], 2), dtype=xp.dtype, device=xp.device)
        _kernels().probe_kernel[grid](
            xp, d, _scalar(stp, xp), part, n,
            body=block_fn(), ROWS=rows, W=row, **LAUNCH,
        )
        probe.launches += 1
        tot = fused.reduce_partials(part)
        return _fx(part, tot), tot[1]

    # ------------------------------------------- K4 trial + pair + Gram

    def trial_pair_gram_ref(xp, d, gp, stp, S, Y, end, inplace=False, with_gp=False):
        """Plain version of ``trial_pair_gram``."""
        trial_pair_gram_ref.calls += 1
        stp = float(stp)
        x = xp + stp * d
        fx, g = value_and_grad(x)
        SP, YP = fused.pair_products(stp * d, g - gp, -g, S, Y, end,
                                     gp=gp if with_gp else None)
        out = (fused.obj_lift(fx, x.dtype), torch.dot(g, d), torch.dot(g, g),
               torch.dot(x, x), torch.any(x != xp))
        if inplace:
            xp.copy_(x)
            gp.copy_(g)
            x, g = xp, gp
        return (x, out[0], g, *out[1:], SP, YP)

    def trial_pair_gram(xp, d, gp, stp, S, Y, end, inplace=False, with_gp=False):
        """One-pass epilogue: the trial at xp + stp*d, the correction pair
        (s, y) = (stp*d, g - gp) written into ring row ``end`` of S and Y
        (in place), and SP = S.[y, s, -g], YP = Y.[y, s, -g] ([m, 3]) over
        the updated rings.  Returns (x, fx, g, g.d, g.g, x.x, changed, SP,
        YP).  ``inplace=True`` writes x over xp and g over gp (the lean
        whole-run state, which never reads the previous point again).
        ``with_gp=True`` appends the damped update's basis column S.gp,
        Y.gp ([m, 4]); every other output is that of the plain launch bit
        for bit."""
        _check(xp)
        fused._check_hist(xp, S, Y)
        if not fused.on_cuda(xp, "trial_pair_gram"):
            return trial_pair_gram_ref(xp, d, gp, stp, S, Y, end, inplace, with_gp)
        fused.check_contiguous("trial_pair_gram", xp, d, gp, S, Y)
        m, n = S.shape
        eg = epilogue_grid(n, xp.dtype, S.dtype)
        x = xp if inplace else torch.empty_like(xp)
        g = gp if inplace else torch.empty_like(gp)
        bufs = _epilogue_buffers(xp, eg, m, False, with_gp)
        part = bufs["part"]
        trial_pair_gram.compiled[(xp.dtype, S.dtype, bool(with_gp))] = \
            _kernels().trial_pair_gram_kernel[(eg.programs,)](
                xp, d, gp, _scalar(stp, xp), x, g, S, Y, bufs["fx"], part,
                bufs.get("gpart", part), n, int(end), eg.tiles, body=block_fn(), M=m,
                MP=_rows(m), T=eg.T, V=eg.V, W=row, WITH_GP=bool(with_gp),
                **_epilogue_launch(eg))
        trial_pair_gram.launches += 1
        trial_pair_gram.gp_launches += bool(with_gp)
        tot = fused.reduce_partials(part)
        P = tot[4:].reshape(m, 6)
        SP, YP = P[:, :3], P[:, 3:]
        if with_gp:
            SP, YP = fused.append_gp(SP, YP, fused.reduce_partials(bufs["gpart"]))
        return (x, _fx_tiles(bufs["fx"]), g, tot[0], tot[1], tot[2], tot[3] > 0, SP, YP)

    def trial_pair_gram_ok(xp, S) -> bool:
        # shape and dtype only: a size the objective rejects raises inside
        # the wrapper instead of quietly taking the composed path
        return fused.can_pair_gram(xp, S)

    # ------------------------------------------- K8 OWL-QN probe

    def _ow_eval(xp, d, wp, stp, c, start, end):
        """(x, fx + c*L1, g) at the projected trial point."""
        x = project_window(xp + float(stp) * d, wp, start, end)
        fx, g = value_and_grad(x)
        return x, fused.obj_lift(fx, x.dtype) + x1norm(Orthantwise(c, start, end), x), g

    # ------------------------------------------- K7 OWL-QN trial

    def owlqn_trial_ref(xp, d, wp, stp, c, start, end):
        """Plain version of ``owlqn_trial``
        (``lbfgs_tpu/ops/factory.py:579-590``)."""
        owlqn_trial_ref.calls += 1
        x, ft, g = _ow_eval(xp, d, wp, stp, c, start, end)
        return x, ft, g, torch.dot(g, d), torch.dot(x, x), torch.any(x != xp)

    def owlqn_trial(xp, d, wp, stp, c, start, end):
        """(x, fx + c*L1, g, g.d, x.x, changed) at x = pi(xp + stp*d; wp)
        inside the window [start, end), from one pass.  Its ft equals
        ``owlqn_probe``'s at the same step and orthant, bit for bit."""
        _check(xp)
        if not fused.on_cuda(xp, "owlqn_trial"):
            return owlqn_trial_ref(xp, d, wp, stp, c, start, end)
        fused.check_contiguous("owlqn_trial", xp, d, wp)
        n = xp.shape[0]
        lo, hi = _window(n, start, end)
        grid = _grid(n)
        x = torch.empty_like(xp)
        g = torch.empty_like(xp)
        ppart = torch.empty((grid[0], 3), dtype=xp.dtype, device=xp.device)
        part = torch.empty((grid[0], 2), dtype=xp.dtype, device=xp.device)
        _kernels().owlqn_trial_kernel[grid](
            xp, d, wp, _scalar(stp, xp), x, g, ppart, part, n, lo, hi,
            body=block_fn(), ROWS=rows, W=row, **LAUNCH,
        )
        owlqn_trial.launches += 1
        ft, dg = _ow_probe_scalars(ppart, c)
        tot = fused.reduce_partials(part)
        return x, ft, g, dg, tot[0], tot[1] > 0

    def owlqn_probe_ref(xp, d, wp, stp, c, start, end):
        """Plain version of ``owlqn_probe``."""
        owlqn_probe_ref.calls += 1
        _, ft, g = _ow_eval(xp, d, wp, stp, c, start, end)
        return ft, torch.dot(g, d)

    def _ow_probe_pg_plain(xp, d, pg, stp, c, start, end):
        wp = choose_orthant(Orthantwise(c, start, end), xp, pg)
        _, ft, g = _ow_eval(xp, d, wp, stp, c, start, end)
        return ft, torch.dot(g, d)

    def owlqn_probe_pg_ref(xp, d, pg, stp, c, start, end):
        """Plain version of ``owlqn_probe_pg``."""
        owlqn_probe_pg_ref.calls += 1
        return _ow_probe_pg_plain(xp, d, pg, stp, c, start, end)

    def _ow_probe(xp, d, w, stp, c, start, end, wp_is_pg):
        fused.check_contiguous("owlqn_probe", xp, d, w)
        n = xp.shape[0]
        lo, hi = _window(n, start, end)
        grid = _grid(n)
        part = torch.empty((grid[0], 3), dtype=xp.dtype, device=xp.device)
        _kernels().owlqn_probe_kernel[grid](
            xp, d, w, _scalar(stp, xp), part, n, lo, hi,
            body=block_fn(), ROWS=rows, W=row, WP_IS_PG=wp_is_pg, **LAUNCH,
        )
        return _ow_probe_scalars(part, c)

    def owlqn_probe(xp, d, wp, stp, c, start, end):
        """(fx + c*L1, g.d) at x = pi(xp + stp*d; wp) inside the window
        [start, end), writing no vector."""
        _check(xp)
        if not fused.on_cuda(xp, "owlqn_probe"):
            return owlqn_probe_ref(xp, d, wp, stp, c, start, end)
        out = _ow_probe(xp, d, wp, stp, c, start, end, False)
        owlqn_probe.launches += 1
        return out

    def owlqn_probe_pg(xp, d, pg, stp, c, start, end):
        """``owlqn_probe`` with the orthant rebuilt in registers from
        (xp, pg) by ``choose_orthant``'s formula: the same scalars, bit
        for bit, without the orthant vector."""
        _check(xp)
        if not fused.on_cuda(xp, "owlqn_probe_pg"):
            return owlqn_probe_pg_ref(xp, d, pg, stp, c, start, end)
        out = _ow_probe(xp, d, pg, stp, c, start, end, True)
        owlqn_probe_pg.launches += 1
        return out

    # ------------------------ K14 OWL-QN trial + pseudo-gradient + pair + Gram

    def owlqn_trial_pair_gram_ref(xp, d, gp, pg, stp, c, start, end_w, S, Y, end,
                                  inplace=False, with_gp=False):
        """Plain version of ``owlqn_trial_pair_gram``."""
        owlqn_trial_pair_gram_ref.calls += 1
        ow = Orthantwise(c, start, end_w)
        x, _, g = _ow_eval(xp, d, choose_orthant(ow, xp, pg), stp, c, start, end_w)
        pg_new = pseudo_gradient(ow, x, g)
        SP, YP = fused.pair_products(x - xp, g - gp, -pg_new, S, Y, end,
                                     gp=gp if with_gp else None)
        out = (torch.dot(x, x), torch.dot(pg_new, pg_new), torch.any(x != xp))
        if with_gp:
            out += (torch.dot(gp, gp), torch.dot(gp, pg_new))
        if inplace:
            xp.copy_(x)
            gp.copy_(g)
            pg.copy_(pg_new)
            x, g, pg_new = xp, gp, pg
        return (x, g, pg_new, SP, YP, *out)

    def owlqn_trial_pair_gram(xp, d, gp, pg, stp, c, start, end_w, S, Y, end,
                              inplace=False, with_gp=False):
        """OWL-QN's one-pass epilogue: the accepted point x = pi(xp +
        stp*d; wp), wp = choose_orthant(xp, pg) rebuilt in registers, its
        gradient g and pseudo-gradient pg_new (L1 weight ``c`` on the
        window [start, end_w)), the pair (x - xp, g - gp) written into
        ring row ``end`` of S and Y (in place), and SP = S.[y, s, -pg_new],
        YP = Y.[y, s, -pg_new] ([m, 3]).  Returns (x, g, pg_new, SP, YP,
        x.x, pg_new.pg_new, changed); fx is the search's last probe.
        ``inplace=True`` writes x, g and pg_new over xp, gp and pg.
        ``with_gp=True`` (damped OWL-QN) appends the . gp column to SP and
        YP ([m, 4]) and gp.gp, gp.pg_new to the returns, taken before g
        overwrites gp; every other output is that of the plain launch bit
        for bit."""
        _check(xp)
        fused._check_hist(xp, S, Y)
        if not fused.on_cuda(xp, "owlqn_trial_pair_gram"):
            return owlqn_trial_pair_gram_ref(xp, d, gp, pg, stp, c, start, end_w,
                                             S, Y, end, inplace, with_gp)
        fused.check_contiguous("owlqn_trial_pair_gram", xp, d, gp, pg, S, Y)
        m, n = S.shape
        lo, hi = _window(n, start, end_w)
        eg = epilogue_grid(n, xp.dtype, S.dtype)
        x = xp if inplace else torch.empty_like(xp)
        g = gp if inplace else torch.empty_like(gp)
        pg_new = pg if inplace else torch.empty_like(pg)
        bufs = _epilogue_buffers(xp, eg, m, True, with_gp)
        part = bufs["part"]
        gpart = bufs.get("gpart", part)
        owlqn_trial_pair_gram.compiled[(xp.dtype, S.dtype, bool(with_gp))] = \
            _kernels().owlqn_trial_pair_gram_kernel[(eg.programs,)](
                xp, d, gp, pg, _scalar(stp, xp), _scalar(c, xp), x, g, pg_new, S, Y,
                part, gpart, n, lo, hi, int(end), eg.tiles, body=block_fn(), M=m,
                MP=_rows(m), T=eg.T, V=eg.V, W=row, WITH_GP=bool(with_gp),
                **_epilogue_launch(eg))
        owlqn_trial_pair_gram.launches += 1
        owlqn_trial_pair_gram.gp_launches += bool(with_gp)
        tot = fused.reduce_partials(part)
        P = tot[3:].reshape(m, 6)
        if not with_gp:
            return x, g, pg_new, P[:, :3], P[:, 3:], tot[0], tot[1], tot[2] > 0
        G = fused.reduce_partials(gpart)
        SP, YP = fused.append_gp(P[:, :3], P[:, 3:], G[2:])
        return x, g, pg_new, SP, YP, tot[0], tot[1], tot[2] > 0, G[0], G[1]

    # ------------------------- K15 / K16 combine + the next first probe

    def combine_probe_ref(g, x, S, Y, gamma, coef_s, coef_y, stp1, fix=None):
        """Plain version of ``combine_probe``: ``fused.combine_ref``'s
        arithmetic (with ``fix``, ``fused.combine_fix_ref``'s), then
        ``probe_ref``'s at x + stp1*r (``lbfgs_tpu/ops/factory.py:
        1291-1296``), none counted as a call of its own."""
        combine_probe_ref.calls += 1
        if fix is None:
            r, rr, rd = fused.combine_plain(g, S, Y, gamma, coef_s, coef_y)
        else:
            r, rr, rd = fused.combine_fix_plain(g, S, Y, gamma, coef_s, coef_y, *fix)
        return (r, rr, rd, *_probe_plain(x, r, stp1))

    def _check_combine(kernel, d, x, S, Y):
        _check(x)
        fused._check_hist(d, S, Y)
        if x.shape != d.shape or x.dtype != d.dtype:
            raise ValueError(f"{kernel}: x {x.dtype} {tuple(x.shape)} against the "
                             f"direction's {d.dtype} {tuple(d.shape)}")

    def _combine_launch(kernel, d, x, S, Y, coefs, stp1, nparts, *args, **consts):
        """Launch K15 or K16, whose combine and probe partials are both
        [programs, nparts] arrays (2 columns for K15, 3 for K16); returns
        (r, column sums of the combine's partials, the probe's partials)."""
        fused.check_contiguous(kernel, d, x, S, Y)
        m, n = S.shape
        grid = _grid(n)
        r = torch.empty_like(d)
        cpart = torch.empty((grid[0], nparts), dtype=d.dtype, device=d.device)
        ppart = torch.empty((grid[0], nparts), dtype=d.dtype, device=d.device)
        getattr(_kernels(), kernel + "_kernel")[grid](
            d, x, S, Y, fused.coef_vector(d, *coefs), _scalar(stp1, d), r, cpart, ppart,
            n, *args, body=block_fn(), M=m, ROWS=rows, W=row, **consts, **LAUNCH,
        )
        return r, fused.reduce_partials(cpart), ppart

    def combine_probe(g, x, S, Y, gamma, coef_s, coef_y, stp1, fix=None):
        """The direction combine r = gamma*g + coef_s @ S + coef_y @ Y with
        r.r and r.g (``fused.combine``'s function), and the next search's
        first probe (ft, g(xt).r) at xt = x + stp1*r, from one pass (K15).
        The probe's scalars equal ``probe(x, r, stp1)``'s bit for bit.
        ``gamma`` (0-d) and the coefficients ([m]) are tensors on g's
        device, ``stp1`` a host scalar.  ``fix`` = (end, ca, cb), ca and
        cb 0-d tensors on g's device, adds ``fused.combine_fix``'s damped
        row: Y[end] <- round(ca*Y[end] + cb*g) in place, after the row is
        read (counted in ``.fix_launches`` too).  Returns (r, r.r, r.g, ft,
        g.r)."""
        _check_combine("combine_probe", g, x, S, Y)
        if fix is not None:
            fix = (fused._check_row(S, fix[0]), *fix[1:])
        if not fused.on_cuda(g, "combine_probe"):
            return combine_probe_ref(g, x, S, Y, gamma, coef_s, coef_y, stp1, fix)
        coefs = (gamma, coef_s, coef_y) + (() if fix is None else fix[1:])
        r, ctot, ppart = _combine_launch("combine_probe", g, x, S, Y, coefs, stp1, 2,
                                         0 if fix is None else fix[0], FIX=fix is not None)
        combine_probe.launches += 1
        combine_probe.fix_launches += fix is not None
        ptot = fused.reduce_partials(ppart)
        return r, ctot[0], ctot[1], _fx(ppart, ptot), ptot[1]

    def combine_ow_probe_ref(pg, x, S, Y, gamma, coef_s, coef_y, c, start, end, stp1):
        """Plain version of ``combine_ow_probe``: ``fused.combine_ow_ref``'s
        arithmetic, then ``owlqn_probe_pg_ref``'s at (x, rc, pg, stp1)
        (``lbfgs_tpu/ops/factory.py:1457-1466``), neither counted."""
        combine_ow_probe_ref.calls += 1
        rc, rr, rc2, rcd = fused.combine_ow_plain(pg, S, Y, gamma, coef_s, coef_y, start, end)
        return (rc, rr, rc2, rcd, *_ow_probe_pg_plain(x, rc, pg, stp1, c, start, end))

    def combine_ow_probe(pg, x, S, Y, gamma, coef_s, coef_y, c, start, end, stp1):
        """OWL-QN's combine with the direction constraint
        (``fused.combine_ow``'s function: rc = pi(r; -pg) inside [start,
        end), r.r before the constraint, rc.rc, rc.pg) and the next
        search's first probe at pi(x + stp1*rc; wp), wp rebuilt from (x,
        pg), with fx + c*L1 and g.rc, from one pass (K16).  The probe's
        scalars equal ``owlqn_probe_pg(x, rc, pg, stp1, c, start, end)``'s
        bit for bit.  Returns (rc, r.r, rc.rc, rc.pg, ft, g.rc)."""
        _check_combine("combine_ow_probe", pg, x, S, Y)
        lo, hi = _window(x.shape[0], start, end)
        if not fused.on_cuda(pg, "combine_ow_probe"):
            return combine_ow_probe_ref(pg, x, S, Y, gamma, coef_s, coef_y, c, lo, hi, stp1)
        rc, ctot, ppart = _combine_launch("combine_ow_probe", pg, x, S, Y,
                                          (gamma, coef_s, coef_y), stp1, 3, lo, hi)
        combine_ow_probe.launches += 1
        return (rc, ctot[0], ctot[1], ctot[2], *_ow_probe_scalars(ppart, c))

    def combine_probe_ok(x, S) -> bool:
        """Whether K15 and K16 take these operands: the shapes and dtypes
        of ``lbfgs_tpu/ops/factory.py:1332-1341``."""
        try:
            _check(x)
        except (TypeError, ValueError):
            return False
        return fused.can_combine(x, S)

    for fn in (trial, probe, trial_pair_gram, owlqn_trial, owlqn_probe, owlqn_probe_pg,
               owlqn_trial_pair_gram, combine_probe, combine_ow_probe):
        fn.launches = 0
    # the . gp (damped) specialisations of K4 and K14 and K15's damped-row
    # form, counted apart too
    trial_pair_gram.gp_launches = owlqn_trial_pair_gram.gp_launches = 0
    # the epilogues' last compiled Triton kernel per (vector dtype, history
    # dtype, with_gp): its registers, spills and PTX
    trial_pair_gram.compiled, owlqn_trial_pair_gram.compiled = {}, {}
    combine_probe.fix_launches = 0
    for fn in (trial_ref, probe_ref, trial_pair_gram_ref, owlqn_trial_ref, owlqn_probe_ref,
               owlqn_probe_pg_ref, owlqn_trial_pair_gram_ref, combine_probe_ref,
               combine_ow_probe_ref):
        fn.calls = 0

    ns = SimpleNamespace(
        trial=trial, trial_ref=trial_ref,
        probe=probe, probe_ref=probe_ref,
        trial_pair_gram=trial_pair_gram,
        trial_pair_gram_ref=trial_pair_gram_ref,
        trial_pair_gram_ok=trial_pair_gram_ok,
        owlqn_trial=owlqn_trial, owlqn_trial_ref=owlqn_trial_ref,
        owlqn_probe=owlqn_probe, owlqn_probe_ref=owlqn_probe_ref,
        owlqn_probe_pg=owlqn_probe_pg, owlqn_probe_pg_ref=owlqn_probe_pg_ref,
        owlqn_trial_pair_gram=owlqn_trial_pair_gram,
        owlqn_trial_pair_gram_ref=owlqn_trial_pair_gram_ref,
        combine_probe=combine_probe, combine_probe_ref=combine_probe_ref,
        combine_probe_ok=combine_probe_ok,
        combine_ow_probe=combine_ow_probe, combine_ow_probe_ref=combine_ow_probe_ref,
    )

    def vag(x):
        return value_and_grad(x)

    def plain(x):
        return value_and_grad(x)

    _attach(vag, trial, probe, trial_pair_gram, trial_pair_gram_ok, owlqn_trial,
            owlqn_probe, owlqn_probe_pg, owlqn_trial_pair_gram,
            fused.combine, fused.combine_fix, fused.combine_ow,
            fused.pseudo_gradient_norm, fused.pseudo_gradient,
            combine_probe, combine_ow_probe, combine_probe_ok)
    _attach(plain, trial_ref, probe_ref, trial_pair_gram_ref, trial_pair_gram_ok,
            owlqn_trial_ref, owlqn_probe_ref, owlqn_probe_pg_ref, owlqn_trial_pair_gram_ref,
            fused.combine_ref, fused.combine_fix_ref, fused.combine_ow_ref,
            fused.pseudo_gradient_norm_ref, fused.pseudo_gradient_ref,
            combine_probe_ref, combine_ow_probe_ref, combine_probe_ok)
    vag.kernels = plain.kernels = ns
    vag.plain = plain
    return vag


def _attach(obj, trial, probe, tpg, tpg_ok, ow_trial, ow_probe, ow_probe_pg, ow_tpg,
            combine, combine_fix, combine_ow, pg_norm, pg, cp, cp_ow, cp_ok) -> None:
    obj.__lbfgs_value_and_grad__ = True
    obj.__lbfgs_trial__ = trial
    obj.__lbfgs_trial_probe__ = probe
    obj.__lbfgs_trial_pair_gram__ = tpg
    obj.__lbfgs_trial_pair_gram_ok__ = tpg_ok
    obj.__lbfgs_owlqn_trial__ = ow_trial
    obj.__lbfgs_owlqn_probe__ = ow_probe
    obj.__lbfgs_owlqn_probe_pg__ = ow_probe_pg
    obj.__lbfgs_owlqn_trial_pair_gram__ = ow_tpg
    # the OWL-QN epilogue takes the same shapes and dtypes as K4's
    obj.__lbfgs_owlqn_trial_pair_gram_ok__ = tpg_ok
    obj.__lbfgs_combine__ = combine
    obj.__lbfgs_combine_fix__ = combine_fix
    obj.__lbfgs_combine_ow__ = combine_ow
    obj.__lbfgs_pseudo_gradient_norm__ = pg_norm
    obj.__lbfgs_pseudo_gradient__ = pg
    obj.__lbfgs_combine_probe__ = cp
    obj.__lbfgs_combine_probe_ok__ = cp_ok
    obj.__lbfgs_combine_ow_probe__ = cp_ow
    # K16 takes the same shapes and dtypes as K15
    obj.__lbfgs_combine_ow_probe_ok__ = cp_ok
