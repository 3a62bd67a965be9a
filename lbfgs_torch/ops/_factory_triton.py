"""Triton kernels K1 (trial), K2 (probe), K4 (trial + pair + Gram), and
OWL-QN's K7 (projected trial), K8 (projected probe) and K14 (projected
trial + pseudo-gradient + pair + Gram).

This module imports ``triton`` at the top, so only the launching wrappers
in ``ops/factory.py`` import it, at their first launch on a CUDA tensor.

Every kernel takes the objective's per-block body as the
``tl.constexpr`` parameter ``body``: a ``@triton.jit`` function
``body(x, gidx) -> (fx_elem, g)`` over one [ROWS, W] block of the iterate
(``gidx`` its global element indices; elements couple only inside a row
of W).  That is the counterpart of ``make_fused_objective(block_fn)`` in
the JAX package, and any objective written to that contract reuses the
kernels unchanged.

The wrappers launch them without multiply-add contraction
(``factory.LAUNCH``), so each rounds as its plain version does and the
stored pairs of K4 and K14 are exactly the rounded pair of the kernel's
own registers.

Each program of K1, K2, K7, K8, K15 and K16 handles one block of ROWS*W
consecutive elements and writes its partial sums into its own row of a
[programs, k] array, which ``fused.reduce_partials`` adds in a fixed
order: no float atomics, so runs repeat bit for bit.  Every reduction is
masked by global index (n need not be a multiple of the block).  The
epilogues K4 and K14 take many more sums per element (6m to 8m products)
and are laid out otherwise, below.

What bounds them on the H100 is bytes; each kernel reads and writes every
vector it touches once, computes the objective in registers, and writes
nothing that is not a result:

  * K1 ``trial_kernel`` (replaces lbfgs_tpu/ops/factory.py:_trial_kernel):
    reads xp, d; writes xt, g (16 B/elem in f32).
  * K2 ``probe_kernel`` (replaces factory.py:_probe_kernel): reads xp, d,
    writes only two partials per program (8 B/elem).
  * K4 ``trial_pair_gram_kernel`` (replaces
    factory.py:_trial_pair_gram_kernel): reads xp, d, gp and the m-1 old
    ring rows of S and Y, writes x, g and ring row ``end`` of S and Y
    (in f32 with a bf16 history, m = 6: 12 + 20 + 8 + 4 = 44 B/elem),
    with all 6m Gram products taken in the same pass.  Row ``end`` is
    never read: its products use the unrounded (s, y) held in registers,
    and only the stored row is rounded to the history dtype.  With
    ``WITH_GP`` (the damped path) it adds the 2m products S_j.gp, Y_j.gp
    into partials of their own: gp already streams, so no byte is added,
    and the other partials are those of the plain launch bit for bit.
  * K7 ``owlqn_trial_kernel`` (replaces factory.py:_owlqn_trial_kernel):
    the OWL-QN trial point x = pi(xp + stp*d; wp) inside the window
    [lo, hi), its gradient, and per program the objective, the window's
    sum |x|, g.d, x.x and the changed count.  It reads xp, d, wp and
    writes x, g (20 B/elem in f32).  The wide mode's init and the
    materializing OWL-QN search run it.
  * K8 ``owlqn_probe_kernel`` (replaces factory.py:_owlqn_probe_body):
    the same point, and per program the objective, the window's sum |x|
    and g.d, writing no vector.  With ``WP_IS_PG`` the third operand is
    the pseudo-gradient and the orthant wp is rebuilt in registers from
    (xp, pg), as ``orthantwise.choose_orthant`` would materialize it, so
    the search needs no orthant pass (12 B/elem in f32 either way).
    K7 and K8 write their objective, L1 and g.d partials through one
    function (``_store_ow_probe``) into [programs, 3] arrays, which the
    wrappers reduce by one code path: at the same step and orthant K7's
    ft and g.d are K8's bit for bit (the remat contract; K7's x.x and
    changed go to an array of their own, since a column of a wider
    partials array would be summed in another order).
  * K14 ``owlqn_trial_pair_gram_kernel`` (replaces
    factory.py:_owlqn_tpg_kernel): the accepted projected point x with wp
    rebuilt from (xp, pg_old), its gradient g and pseudo-gradient pg, the
    pair (x - xp, g - gp) written into ring row ``end`` and the 6m
    products against (y, s, -pg), with x.x, pg.pg and the changed count.
    It reads xp, d, gp, pg_old and m-1 rows of each ring and writes x, g,
    pg and one row of each (in f32 with a bf16 history, m = 6: 16 + 20 +
    12 + 4 = 52 B/elem).  x, g and pg may alias xp, gp and pg_old: each
    element is loaded before it is stored and no element reads another's.
    With ``WITH_GP`` (damped OWL-QN) it adds gp.gp, gp.pg and the 2m
    products S_j.gp, Y_j.gp, in partials of their own, at no byte.

  How K4 and K14 are laid out.  The JAX kernels keep the [m, 3|4] sums
  resident across their sequential grid and write only the objective's
  partial per block.  On Hopper the blocks run in parallel, so a loop
  inside the program takes that grid's place: each program walks
  ``tiles`` consecutive tiles of T elements (``factory.epilogue_grid``)
  and adds every product into per-thread registers.  A tile is addressed
  as [T // V, V] (``_tile``): each thread holds runs of V consecutive
  elements of every vector and ring row, so its loads are V wide (V = 4:
  16 bytes of float32, 8 of bf16), and it folds each product over its V
  elements in the thread.  The ring rows stream one at a time (row
  ``end`` is the unrounded new pair, never read) and each fold lands in
  column j of a [T // V, MP] sum (MP = m rounded up to a power of two;
  ``_add_col``), so a thread carries 6 (8) x MP sums.  Only after the
  last tile does the program reduce across its threads: one reduction per
  product kind for all rows, into one partials row, where the block
  layout took 6m (8m) per 1024 elements.  The body sees its [T // W, W]
  view by a reshape.  The objective keeps one partial per tile (K4's fx
  array, as the JAX kernel's fxp), which the wide mode sums in float64.
  The six products' folds and reductions are the same code with and
  without ``WITH_GP``, so columns 0-2 stay those of the 3-column launch
  bit for bit.  Tensor cores do not apply: the Gram products cost ~2.7
  flops per byte against float32's ridge of ~20, so bytes bound them.

  * K15 ``combine_probe_kernel`` (replaces
    factory.py:_combine_probe_kernel): the two-loop's direction combine
    r = gamma*g + sum_j cs_j S_j + sum_j cy_j Y_j (K3's function) with
    r.r and r.g, and the next search's first probe at x + stp1*r in the
    same pass.  It reads g, x and the 2m ring rows and writes r (in f32
    with a bf16 history, m = 6: 3*4 + 2*6*2 = 36 B/elem, against 32 + 8
    for K3 and a K2).  The probe's point and its (f, g.r) partials are
    formed by K2's expressions and K2's store into a [programs, 2] array
    of K2's layout, so the wrapper's (ft, g.r) equal ``probe(x, r, stp1)``
    bit for bit; the combine's sums go to an array of their own.  With
    ``FIX`` (the damped path) it also persists the damped ring row as K6
    does, Y[end] <- round(ca*Y[end] + cb*g) from the row as read, which
    adds one row's store (2 B/elem with a bf16 history).
  * K16 ``combine_ow_probe_kernel`` (replaces
    factory.py:_combine_ow_probe_kernel): K13's function, rc = pi(r; -pg)
    inside the window with r.r before the constraint, rc.rc and rc.pg,
    and the OWL-QN probe at pi(x + stp1*rc; wp) with the orthant rebuilt
    from (x, pg) as K8's ``WP_IS_PG`` form does, its (f, L1, g.rc)
    partials through ``_store_ow_probe``: equal to
    ``owlqn_probe_pg(x, rc, pg, stp1)`` bit for bit (36 B/elem).

The orthant tests use ``_msign``, which maps NaN to 0 as the reference's
signum does; the pseudo-gradient's x != 0 branch uses ``_sign``, which
keeps NaN, as ``jnp.sign`` does in the JAX kernels.
"""

from __future__ import annotations

import triton
import triton.language as tl


@triton.jit
def _block_sum(v, mask):
    return tl.sum(tl.sum(tl.where(mask, v, 0.0), axis=1), axis=0)


@triton.jit
def _offsets(ROWS: tl.constexpr, W: tl.constexpr):
    pid = tl.program_id(0)
    rows = tl.arange(0, ROWS)[:, None]
    cols = tl.arange(0, W)[None, :]
    return pid * (ROWS * W) + rows * W + cols


@triton.jit
def _msign(v):
    # NaN and +-0 -> 0 (the reference's signum)
    return tl.where(v > 0, 1.0, tl.where(v < 0, -1.0, 0.0))


@triton.jit
def _sign(v):
    # +-1, 0 at +-0, NaN at NaN (jnp.sign)
    return tl.where(v > 0, 1.0, tl.where(v < 0, -1.0, v))


@triton.jit
def _ow_point(xp, d, stp, wp_sign, in_win):
    # x = pi(xp + stp*d; wp) inside the window
    xr = xp + stp * d
    return tl.where(in_win & (_msign(xr) != wp_sign), 0.0, xr)


@triton.jit
def _store_ow_probe(part_ptr, fe, x, g, d, mask, in_win):
    # the objective's, the window's |x| and g.d partials of K7 and K8
    part = part_ptr + tl.program_id(0) * 3
    tl.store(part + 0, _block_sum(fe, mask))
    tl.store(part + 1, _block_sum(tl.abs(x), mask & in_win))
    tl.store(part + 2, _block_sum(g * d, mask))


@triton.jit
def _store_probe(part_ptr, fe, g, d, mask):
    # the objective's and g.d partials of K2 and K15
    part = part_ptr + tl.program_id(0) * 2
    tl.store(part + 0, _block_sum(fe, mask))
    tl.store(part + 1, _block_sum(g * d, mask))


@triton.jit
def _combination(g_ptr, S_ptr, Y_ptr, coef_ptr, offs, mask, n, fix_end, M: tl.constexpr,
                 FIX: tl.constexpr):
    # (g, r) with r = gamma*g + sum_j cs_j S_j + sum_j cy_j Y_j: the ring
    # rows widen in registers; coef = [gamma, cs_0 .. cs_{M-1}, cy_0 ..]
    # and with FIX then (ca, cb): ring row fix_end is rewritten as
    # round(ca*Y[fix_end] + cb*g) from the row as read (K6's damped row)
    g = tl.load(g_ptr + offs, mask=mask, other=0.0)
    acc_s = tl.zeros_like(g)
    acc_y = tl.zeros_like(g)
    s_row = S_ptr + offs
    y_row = Y_ptr + offs
    for j in tl.static_range(M):
        Sj = tl.load(s_row, mask=mask, other=0.0).to(g.dtype)
        Yj = tl.load(y_row, mask=mask, other=0.0).to(g.dtype)
        acc_s += tl.load(coef_ptr + 1 + j) * Sj
        acc_y += tl.load(coef_ptr + 1 + M + j) * Yj
        if FIX:
            fixed = tl.load(coef_ptr + 1 + 2 * M) * Yj + tl.load(coef_ptr + 2 + 2 * M) * g
            tl.store(y_row, fixed.to(y_row.dtype.element_ty), mask=mask & (fix_end == j))
        s_row += n
        y_row += n
    return g, tl.load(coef_ptr) * g + (acc_s + acc_y)


@triton.jit
def trial_kernel(xp_ptr, d_ptr, stp_ptr, xt_ptr, g_ptr, part_ptr, n,
                 body: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr):
    offs = _offsets(ROWS, W)
    mask = offs < n
    stp = tl.load(stp_ptr)
    xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + offs, mask=mask, other=0.0)
    x = xp + stp * d
    fe, g = body(x, offs)
    tl.store(xt_ptr + offs, x, mask=mask)
    tl.store(g_ptr + offs, g, mask=mask)
    part = part_ptr + tl.program_id(0) * 5
    tl.store(part + 0, _block_sum(fe, mask))
    tl.store(part + 1, _block_sum(g * d, mask))
    tl.store(part + 2, _block_sum(g * g, mask))
    tl.store(part + 3, _block_sum(x * x, mask))
    tl.store(part + 4, _block_sum(tl.where(x != xp, 1.0, 0.0).to(x.dtype), mask))


@triton.jit
def probe_kernel(xp_ptr, d_ptr, stp_ptr, part_ptr, n,
                 body: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr):
    offs = _offsets(ROWS, W)
    mask = offs < n
    stp = tl.load(stp_ptr)
    xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + offs, mask=mask, other=0.0)
    x = xp + stp * d
    fe, g = body(x, offs)
    _store_probe(part_ptr, fe, g, d, mask)


@triton.jit(do_not_specialize=["fix_end"])
def combine_probe_kernel(g_ptr, x_ptr, S_ptr, Y_ptr, coef_ptr, stp_ptr, r_ptr, cpart_ptr,
                         ppart_ptr, n, fix_end, body: tl.constexpr, M: tl.constexpr,
                         ROWS: tl.constexpr, W: tl.constexpr, FIX: tl.constexpr):
    offs = _offsets(ROWS, W)
    mask = offs < n
    g, r = _combination(g_ptr, S_ptr, Y_ptr, coef_ptr, offs, mask, n, fix_end, M, FIX)
    tl.store(r_ptr + offs, r, mask=mask)
    cpart = cpart_ptr + tl.program_id(0) * 2
    tl.store(cpart + 0, _block_sum(r * r, mask))
    tl.store(cpart + 1, _block_sum(r * g, mask))
    # the next search's first probe, as K2 forms it at (x, r, stp1)
    stp = tl.load(stp_ptr)
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    xt = x + stp * r
    fe, gt = body(xt, offs)
    _store_probe(ppart_ptr, fe, gt, r, mask)


@triton.jit(do_not_specialize=["lo", "hi"])
def combine_ow_probe_kernel(pg_ptr, x_ptr, S_ptr, Y_ptr, coef_ptr, stp_ptr, r_ptr, cpart_ptr,
                            ppart_ptr, n, lo, hi, body: tl.constexpr, M: tl.constexpr,
                            ROWS: tl.constexpr, W: tl.constexpr):
    offs = _offsets(ROWS, W)
    mask = offs < n
    pg, r = _combination(pg_ptr, S_ptr, Y_ptr, coef_ptr, offs, mask, n, 0, M, False)
    in_win = (offs >= lo) & (offs < hi)
    # the direction constraint against -pg inside the window (K13's)
    rc = tl.where(in_win & (_msign(r) != _msign(-pg)), 0.0, r)
    tl.store(r_ptr + offs, rc, mask=mask)
    cpart = cpart_ptr + tl.program_id(0) * 3
    tl.store(cpart + 0, _block_sum(r * r, mask))
    tl.store(cpart + 1, _block_sum(rc * rc, mask))
    tl.store(cpart + 2, _block_sum(rc * pg, mask))
    # the next search's first probe, as K8's WP_IS_PG form at (x, rc, pg, stp1)
    stp = tl.load(stp_ptr)
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    wp_sign = tl.where(x == 0.0, _msign(-pg), _msign(x))
    xt = _ow_point(x, rc, stp, wp_sign, in_win)
    fe, gt = body(xt, offs)
    _store_ow_probe(ppart_ptr, fe, xt, gt, rc, mask, in_win)


@triton.jit
def _tile(tile, T: tl.constexpr, V: tl.constexpr):
    # the offsets of tile `tile` of T elements as [T // V, V]: each thread
    # holds runs of V consecutive elements that start at a multiple of V,
    # so its loads can be V wide
    r = tl.arange(0, T // V)[:, None]
    c = tl.arange(0, V)[None, :]
    return tl.max_contiguous(tl.multiple_of(tile * T + r * V + c, [1, V]), [1, V])


@triton.jit
def _fold(v):
    # a [T // V, V] product summed over each thread's run of V elements
    return tl.sum(v, axis=1)


@triton.jit
def _add_col(acc, f, j: tl.constexpr, MP: tl.constexpr):
    # f ([T // V], each thread's fold of its elements) added into column j
    # of the per-thread sums acc ([T // V, MP]); the column test is on an
    # in-thread index, so the compiler keeps one add
    col = tl.arange(0, MP)[None, :]
    return tl.where(col == j, acc + f[:, None], acc)


@triton.jit
def _gram_row(Sj, Yj, y, s, d0, a0, a1, a2, a3, a4, a5, j: tl.constexpr,
              MP: tl.constexpr):
    # the six products of ring row j against (y, s, d0), each folded in the
    # thread and added into column j; their order does not depend on WITH_GP
    a0 = _add_col(a0, _fold(Sj * y), j, MP)
    a1 = _add_col(a1, _fold(Sj * s), j, MP)
    a2 = _add_col(a2, _fold(Sj * d0), j, MP)
    a3 = _add_col(a3, _fold(Yj * y), j, MP)
    a4 = _add_col(a4, _fold(Yj * s), j, MP)
    a5 = _add_col(a5, _fold(Yj * d0), j, MP)
    return a0, a1, a2, a3, a4, a5


@triton.jit
def _ring_pass(S_ptr, Y_ptr, offs, mask, n, end, s, y, d0, gp, a0, a1, a2, a3, a4, a5, b0,
               b1, M: tl.constexpr, MP: tl.constexpr, WITH_GP: tl.constexpr):
    # one tile's pass over the rings: the m-1 old rows widen in registers,
    # row `end` is the new pair, unrounded and never read; the new pair is
    # then stored into row `end`, rounded to the history dtype
    s_row = S_ptr + offs
    y_row = Y_ptr + offs
    for j in tl.static_range(M):
        is_end = end == j
        Sj = tl.load(s_row, mask=mask & (end != j), other=0.0).to(s.dtype)
        Yj = tl.load(y_row, mask=mask & (end != j), other=0.0).to(s.dtype)
        Sj = tl.where(is_end, s, Sj)
        Yj = tl.where(is_end, y, Yj)
        a0, a1, a2, a3, a4, a5 = _gram_row(Sj, Yj, y, s, d0, a0, a1, a2, a3, a4, a5, j, MP)
        if WITH_GP:
            # the damped update's basis column, in sums of its own
            b0 = _add_col(b0, _fold(Sj * gp), j, MP)
            b1 = _add_col(b1, _fold(Yj * gp), j, MP)
        s_row += n
        y_row += n
    row = end.to(tl.int64) * n
    tl.store(S_ptr + row + offs, s.to(S_ptr.dtype.element_ty), mask=mask)
    tl.store(Y_ptr + row + offs, y.to(Y_ptr.dtype.element_ty), mask=mask)
    return a0, a1, a2, a3, a4, a5, b0, b1


@triton.jit
def _store_gram(part, a0, a1, a2, a3, a4, a5, M: tl.constexpr, MP: tl.constexpr):
    # the program's partials of the 6m products, row j at part + 6j: one
    # cross-thread reduction per product kind for all rows
    r = tl.arange(0, MP)
    keep = r < M
    pj = part + 6 * r
    tl.store(pj + 0, tl.sum(a0, axis=0), mask=keep)
    tl.store(pj + 1, tl.sum(a1, axis=0), mask=keep)
    tl.store(pj + 2, tl.sum(a2, axis=0), mask=keep)
    tl.store(pj + 3, tl.sum(a3, axis=0), mask=keep)
    tl.store(pj + 4, tl.sum(a4, axis=0), mask=keep)
    tl.store(pj + 5, tl.sum(a5, axis=0), mask=keep)


@triton.jit
def _store_gp(gpart, b0, b1, M: tl.constexpr, MP: tl.constexpr):
    # the . gp column's partials, (S_j.gp, Y_j.gp) at gpart + 2j
    r = tl.arange(0, MP)
    keep = r < M
    tl.store(gpart + 2 * r, tl.sum(b0, axis=0), mask=keep)
    tl.store(gpart + 2 * r + 1, tl.sum(b1, axis=0), mask=keep)


@triton.jit(do_not_specialize=["end", "tiles"])
def trial_pair_gram_kernel(xp_ptr, d_ptr, gp_ptr, stp_ptr, x_ptr, g_ptr,
                           S_ptr, Y_ptr, fx_ptr, part_ptr, gpart_ptr, n, end, tiles,
                           body: tl.constexpr, M: tl.constexpr, MP: tl.constexpr,
                           T: tl.constexpr, V: tl.constexpr, W: tl.constexpr,
                           WITH_GP: tl.constexpr):
    # program pid takes tiles pid*tiles .. pid*tiles + tiles - 1 of T
    # elements each; the sums stay in per-thread registers across them
    pid = tl.program_id(0)
    dt = xp_ptr.dtype.element_ty
    stp = tl.load(stp_ptr)
    R: tl.constexpr = T // V
    a_gd = tl.zeros([R], dt)
    a_gg = tl.zeros([R], dt)
    a_xx = tl.zeros([R], dt)
    a_ch = tl.zeros([R], dt)
    a0 = tl.zeros([R, MP], dt)
    a1 = tl.zeros([R, MP], dt)
    a2 = tl.zeros([R, MP], dt)
    a3 = tl.zeros([R, MP], dt)
    a4 = tl.zeros([R, MP], dt)
    a5 = tl.zeros([R, MP], dt)
    b0 = tl.zeros([R, MP], dt)
    b1 = tl.zeros([R, MP], dt)
    for t in range(tiles):
        tile = pid * tiles + t
        offs = _tile(tile, T, V)
        mask = offs < n
        xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
        d = tl.load(d_ptr + offs, mask=mask, other=0.0)
        gp = tl.load(gp_ptr + offs, mask=mask, other=0.0)
        x = xp + stp * d
        # the body sees the [T // W, W] view of the tile
        fe, g = body(tl.reshape(x, [T // W, W]), tl.reshape(offs, [T // W, W]))
        fe = tl.reshape(fe, [R, V])
        g = tl.reshape(g, [R, V])
        # the objective: one partial per tile, as the JAX kernel's fxp
        tl.store(fx_ptr + tile, tl.sum(tl.sum(tl.where(mask, fe, 0.0), axis=1), axis=0))
        g = tl.where(mask, g, 0.0)
        # the correction pair (s = stp*d exactly on the projection-free
        # path, src/core.rs:155-164) and the two-loop's steepest direction
        s = stp * d
        y = g - gp
        d0 = -g
        a_gd += _fold(g * d)
        a_gg += _fold(g * g)
        a_xx += _fold(x * x)
        a_ch += _fold(tl.where(x != xp, 1.0, 0.0).to(dt))
        a0, a1, a2, a3, a4, a5, b0, b1 = _ring_pass(S_ptr, Y_ptr, offs, mask, n, end, s, y,
                                                    d0, gp, a0, a1, a2, a3, a4, a5, b0, b1,
                                                    M, MP, WITH_GP)
        tl.store(x_ptr + offs, x, mask=mask)
        tl.store(g_ptr + offs, g, mask=mask)
    part = part_ptr + pid * (4 + 6 * M)
    tl.store(part + 0, tl.sum(a_gd, axis=0))
    tl.store(part + 1, tl.sum(a_gg, axis=0))
    tl.store(part + 2, tl.sum(a_xx, axis=0))
    tl.store(part + 3, tl.sum(a_ch, axis=0))
    _store_gram(part + 4, a0, a1, a2, a3, a4, a5, M, MP)
    if WITH_GP:
        _store_gp(gpart_ptr + pid * (2 * M), b0, b1, M, MP)


@triton.jit(do_not_specialize=["lo", "hi"])
def owlqn_trial_kernel(xp_ptr, d_ptr, wp_ptr, stp_ptr, xt_ptr, g_ptr, ppart_ptr, part_ptr,
                       n, lo, hi, body: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr):
    offs = _offsets(ROWS, W)
    mask = offs < n
    stp = tl.load(stp_ptr)
    xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + offs, mask=mask, other=0.0)
    wp = tl.load(wp_ptr + offs, mask=mask, other=0.0)
    in_win = (offs >= lo) & (offs < hi)
    x = _ow_point(xp, d, stp, _msign(wp), in_win)
    fe, g = body(x, offs)
    tl.store(xt_ptr + offs, x, mask=mask)
    tl.store(g_ptr + offs, g, mask=mask)
    _store_ow_probe(ppart_ptr, fe, x, g, d, mask, in_win)
    part = part_ptr + tl.program_id(0) * 2
    tl.store(part + 0, _block_sum(x * x, mask))
    tl.store(part + 1, _block_sum(tl.where(x != xp, 1.0, 0.0).to(x.dtype), mask))


@triton.jit(do_not_specialize=["lo", "hi"])
def owlqn_probe_kernel(xp_ptr, d_ptr, w_ptr, stp_ptr, part_ptr, n, lo, hi,
                       body: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr,
                       WP_IS_PG: tl.constexpr):
    offs = _offsets(ROWS, W)
    mask = offs < n
    stp = tl.load(stp_ptr)
    xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + offs, mask=mask, other=0.0)
    w = tl.load(w_ptr + offs, mask=mask, other=0.0)
    if WP_IS_PG:
        # the orthant in registers from (xp, pg): choose_orthant's formula
        wp_sign = tl.where(xp == 0.0, _msign(-w), _msign(xp))
    else:
        wp_sign = _msign(w)
    in_win = (offs >= lo) & (offs < hi)
    x = _ow_point(xp, d, stp, wp_sign, in_win)
    fe, g = body(x, offs)
    _store_ow_probe(part_ptr, fe, x, g, d, mask, in_win)


@triton.jit(do_not_specialize=["end", "lo", "hi", "tiles"])
def owlqn_trial_pair_gram_kernel(xp_ptr, d_ptr, gp_ptr, pg_ptr, stp_ptr, c_ptr,
                                 x_ptr, g_ptr, pgn_ptr, S_ptr, Y_ptr, part_ptr, gpart_ptr,
                                 n, lo, hi, end, tiles, body: tl.constexpr, M: tl.constexpr,
                                 MP: tl.constexpr, T: tl.constexpr, V: tl.constexpr,
                                 W: tl.constexpr, WITH_GP: tl.constexpr):
    pid = tl.program_id(0)
    dt = xp_ptr.dtype.element_ty
    stp = tl.load(stp_ptr)
    c = tl.load(c_ptr)
    R: tl.constexpr = T // V
    a_xx = tl.zeros([R], dt)
    a_pp = tl.zeros([R], dt)
    a_ch = tl.zeros([R], dt)
    a_gg = tl.zeros([R], dt)
    a_gpg = tl.zeros([R], dt)
    a0 = tl.zeros([R, MP], dt)
    a1 = tl.zeros([R, MP], dt)
    a2 = tl.zeros([R, MP], dt)
    a3 = tl.zeros([R, MP], dt)
    a4 = tl.zeros([R, MP], dt)
    a5 = tl.zeros([R, MP], dt)
    b0 = tl.zeros([R, MP], dt)
    b1 = tl.zeros([R, MP], dt)
    for t in range(tiles):
        offs = _tile(pid * tiles + t, T, V)
        mask = offs < n
        # every element is loaded before it is stored, and no element reads
        # another's: x, g and pg may alias xp, gp and pg_old
        xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
        d = tl.load(d_ptr + offs, mask=mask, other=0.0)
        gp = tl.load(gp_ptr + offs, mask=mask, other=0.0)
        pgo = tl.load(pg_ptr + offs, mask=mask, other=0.0)
        in_win = (offs >= lo) & (offs < hi)
        # orthant from the previous point's (x, pg): the search's choose_orthant
        wp_sign = tl.where(xp == 0.0, _msign(-pgo), _msign(xp))
        x = _ow_point(xp, d, stp, wp_sign, in_win)
        _, g = body(tl.reshape(x, [T // W, W]), tl.reshape(offs, [T // W, W]))
        g = tl.reshape(g, [R, V])
        g = tl.where(mask, g, 0.0)
        # pseudo-gradient at the new point (Andrew & Gao Eq. 4)
        right = g + c
        left = g - c
        at_zero = tl.where(right < 0.0, right, tl.where(left > 0.0, left, 0.0))
        inside = tl.where(x != 0.0, g + _sign(x) * c, at_zero)
        pg = tl.where(in_win, inside, g)
        # the pair of the PROJECTED step and the two-loop's d0 = -pg
        s = x - xp
        y = g - gp
        d0 = -pg
        a_xx += _fold(x * x)
        a_pp += _fold(pg * pg)
        a_ch += _fold(tl.where(x != xp, 1.0, 0.0).to(dt))
        if WITH_GP:
            # the damped reconstruction's gp.gp and gp.pg: under OWL-QN the
            # carried norm is ||pg_prev||^2, and gp is gone after an
            # in-place pass, so both come from here
            a_gg += _fold(gp * gp)
            a_gpg += _fold(gp * pg)
        a0, a1, a2, a3, a4, a5, b0, b1 = _ring_pass(S_ptr, Y_ptr, offs, mask, n, end, s, y,
                                                    d0, gp, a0, a1, a2, a3, a4, a5, b0, b1,
                                                    M, MP, WITH_GP)
        tl.store(x_ptr + offs, x, mask=mask)
        tl.store(g_ptr + offs, g, mask=mask)
        tl.store(pgn_ptr + offs, pg, mask=mask)
    part = part_ptr + pid * (3 + 6 * M)
    tl.store(part + 0, tl.sum(a_xx, axis=0))
    tl.store(part + 1, tl.sum(a_pp, axis=0))
    tl.store(part + 2, tl.sum(a_ch, axis=0))
    _store_gram(part + 3, a0, a1, a2, a3, a4, a5, M, MP)
    if WITH_GP:
        gpart = gpart_ptr + pid * (2 + 2 * M)
        tl.store(gpart + 0, tl.sum(a_gg, axis=0))
        tl.store(gpart + 1, tl.sum(a_gpg, axis=0))
        _store_gp(gpart + 2, b0, b1, M, MP)
