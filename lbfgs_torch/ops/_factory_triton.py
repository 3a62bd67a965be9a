"""Triton kernels K1 (trial), K2 (probe), K4 (trial + pair + Gram), and
OWL-QN's K7 (projected trial), K8 (projected probe) and K14 (projected
trial + pseudo-gradient + pair + Gram).

This module imports ``triton`` at the top, so only the launching wrappers
in ``ops/factory.py`` import it, at their first launch on a CUDA tensor.

Every kernel takes the objective's per-block body as the
``tl.constexpr`` parameter ``body``: a ``@triton.jit`` function
``body(x, gidx, *ex) -> (fx_elem, g)`` over one [ROWS, W] block of the
iterate (``gidx`` its global element indices; elements couple only inside
a row of W, at least 2 wide: ``factory.make_fused_objective``), and the
tuple ``ex`` of the objective's extra [n] operands
(weights, targets, ...), whose blocks each kernel loads at x's offsets
and mask and passes to the body after gidx (``_extras``; K15's and K16's
probes see the same blocks, at the point they probe).  That is the
counterpart of ``make_fused_objective(block_fn, extras=...)`` in the JAX
package, and any objective written to that contract reuses the kernels
unchanged.  The tuple's length is part of the kernel's specialisation;
with no extras the body is called as ``body(x, gidx)`` and nothing else
is loaded.

The wrappers launch them without multiply-add contraction
(``factory.LAUNCH``), so each rounds as its plain version does and the
stored pairs of K4 and K14 are exactly the rounded pair of the kernel's
own registers.

Each program of K1, K2, K7, K8, K15 and K16 handles one block of ROWS*W
consecutive elements and writes its partial sums into its own row of a
[programs, k] array, which ``fused.reduce_partials`` (R) adds in an order
that the row count alone fixes: no float atomics, so runs repeat bit for
bit, and a column sums alike in arrays of any width.  Every reduction is
masked by global index (n need not be a multiple of the block).  The
epilogues K4 and K14 take many more sums per element (6m to 8m products)
and are laid out otherwise, below.

What bounds them on the H100 is bytes; each kernel reads and writes every
vector it touches once, computes the objective in registers, and writes
nothing that is not a result (each extra adds its element's bytes, 4 B in
float32, to every kernel's count below):

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
  * K2 s ``probe_steps_kernel`` and K8 s ``owlqn_probe_steps_kernel``
    (the speculative search's candidate pass; they replace no Pallas
    kernel: the JAX package runs it as XLA's fusion of the vmapped
    ``value_and_grad``, ``lbfgs_tpu/linesearch.py:999-1008``): K2's and
    K8's block at K steps of the backtracking ladder in one pass.  Each
    program loads its blocks of xp, d (K8: the orthant's operand) and
    the extras once and runs the body per lane, so the vectors are read
    once whatever K is (8 and 12 B/elem in f32, K2's and K8's); K is a
    compile-time constant (``factory.SPEC_MAX_LANES`` at most: the
    wrappers launch more lanes in chunks), and the body's work grows with
    it.  Each program stores its lanes side by side, lane-minor, in one
    [programs, K] (K8: [programs, K, 2]) array: lane k's objective sum
    (and the window's |x|) by K2's (K8's) expressions over the same
    1024-element block, so its per-program partial is K2's (K8's) column
    0 (and 1) bit for bit.  The wrappers add every lane with one launch
    of R, whose order depends on the row count alone, so each lane's fx
    equals K2's (K8's) at that step bit for bit.  No g.d column is
    stored: the gradient's product is never formed.
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
  ``tiles`` consecutive tiles of T elements (``factory.solo_epilogue_grid``)
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
  bit for bit.  Bytes bound them: the Gram products cost ~2.7 flops per
  byte against float32's ridge of ~20 (the batched forms below put them on
  the tensor cores all the same, to take their sums out of the registers).

  Above ``factory.EPILOGUE_MAX_M`` ring rows (per dtype pair: the
  deepest history whose static form spills nothing and is no slower) the
  sums of every row would not fit a thread, so the deep forms
  ``trial_pair_gram_deep_kernel`` and
  ``owlqn_trial_pair_gram_deep_kernel`` (the same functions at any m, one
  compile for every m) take the ring rows in groups of G
  (``factory.DEEP_GROUP``, by dtype pair): each program keeps the static
  form's tiles and passes over them once per group, recomputing the
  point, the body and the pair, with [T // V, G] sums per product kind
  reduced once per group.  The ring rows stream once; the vectors of a
  program's tiles (a few tens of KB) are read again each pass, from L2
  while they stay there.  Only the last pass stores x, g (pg)
  and folds the point's sums, in the static form's order, so they equal
  the static launch's bit for bit, and x, g and pg may still alias xp,
  gp and pg_old: no other program reads these tiles, and the passes
  before have read them.  The group that holds row ``end`` stores the
  new pair there.

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

  K15 and K16 unroll their loop over the ring rows up to
  ``factory.MAX_M`` rows; above it the same kernels loop at run time (M =
  0, the deep forms), adding the rows in the same order, so r and the
  probe do not depend on the form.

The batched runner's forms, K2 b ``probe_batched_kernel`` and K4 b
``trial_pair_gram_batched_kernel`` (both replace their kernel above under
the JAX package's vmap, ``lbfgs_tpu/batched.py``), take a [B, n] batch of
instances with the instance as grid axis 1: program (i, b) is program i
of the solo kernel at the same n, on instance b, so each instance is
tiled and summed as the solo kernel tiles and sums it, and its stored x,
g and ring row, and its partials, equal the solo kernel's on that
instance alone bit for bit.  The instance's offset b*n (b*m*n in the
rings) goes to the pointers only: the body sees the instance's own
element indices, and the extras, which the instances share, load at
them.  Each instance reads its own step (``stp_ptr + b``), and a frozen
instance (``live_ptr[b] == 0``) has every load and store masked off, its
partials included.  They are bound by bytes as their solo kernels, per
instance: 8 and 44 B/elem at f32 vectors with a bf16 history, m = 6
(K4 b writes no objective partial: the runner takes fx from the search;
with ``WITH_GP``, the damped runs, it adds the . gp column as K4 does, at
no byte).  OWL-QN's forms are laid out the same way:
K8 b ``owlqn_probe_batched_kernel`` is K8's ``WP_IS_PG`` form per
instance (12 B/elem), and K14 b ``owlqn_trial_pair_gram_batched_kernel``
K14 in place (52 B/elem), with ``WITH_GP`` (damped OWL-QN) its gp.gp,
gp.pg and . gp column; the window [lo, hi)
and the L1 weight are the same for every instance, the window in each
instance's own indices.  With the step uncapped the batched runner's
combine is K15 b ``combine_probe_batched_kernel`` or, under OWL-QN, K16 b
``combine_ow_probe_batched_kernel``: K15's and K16's block per instance,
with the instance's coefficient row and its own entry step stp1 (36
B/elem each, as their solo kernels), M = m up to ``factory.MAX_M`` rows
and M = 0 above; K15 b's ``FIX`` form (the damped runs) persists the
damped row of the ring row the instances share, as K15's does (38
B/elem).  Where no batched epilogue runs (the wide init, the scan
two-loop, a float16 ring, an objective without the epilogue) the accepted
points are materialized by K1 b ``trial_batched_kernel`` and, under
OWL-QN, K7 b ``owlqn_trial_batched_kernel`` (with the orthant rebuilt
from (xp, pg) as K8 b rebuilds it): K1's and K7's block per instance (16
and 20 B/elem), their (f, g.d) and (f, L1, g.d) partials written by K2
b's and K8 b's expressions into arrays of K2 b's and K8 b's layout, so
that at the same step their scalars are K2 b's and K8 b's bit for bit
(the remat contract).  Each batched form's r, x, g, pg and ring rows are
its solo kernel's on that instance alone bit for bit, and so are its
partials, but K4 b's and K14 b's.  The speculative search's batched
candidate pass is K2 b s ``probe_steps_batched_kernel`` (K8 b s
``owlqn_probe_steps_batched_kernel`` under OWL-QN): K2 b's (K8 b's)
program at K steps per instance, each instance's steps a row of a [B, K]
array, lane k's partials in K2 b's (K8 b's) [B, programs, 2 | 3] layout,
so that each lane's fx is K2 b's (K8 b's) at that step bit for bit.

  How K4 b and K14 b are laid out.  Their launch is sized over the whole
  batch (``factory.batched_epilogue_grid``), not per instance: each
  instance is cut into a few programs of several consecutive tiles (at
  1024 x 2^14, 4 programs of 8 tiles of 512 elements an instance, the
  solo kernel's shape at n = 2^24), so the launch stays near
  ``factory.EPILOGUE_PROGRAMS`` programs and each program's cross-thread
  reductions cover thousands of elements, not one tile.  A program never
  straddles two instances.  x, g, pg and the ring row are formed element
  by element as the solo kernels form them, so they stay those kernels'
  bit for bit; the sums and products are taken in another order, within
  the sum tolerance.  The static and deep forms
  (``trial_pair_gram_batched_kernel``, ``..._deep_batched_kernel`` and
  K14 b's) keep the solo kernels' per-thread folds and group passes on
  that grid.  With f32 vectors over a bf16 ring, from
  ``factory.MMA_MIN_M`` to ``factory.MMA_MAX_M`` rows, the Gram products
  go to the tensor cores instead (``trial_pair_gram_mma_batched_kernel``,
  ``owlqn_trial_pair_gram_mma_batched_kernel``): per chunk of K elements
  the ring rows are one ``tl.dot`` operand ([RP, K] bf16, exact), the
  pair's vectors y, s, d0 and gp, each split into three bf16 parts that
  carry float32's 24 bits, the other ([K, 16]); each chunk's [RP, 16]
  float32 products are added to the program's running sums by float32
  adds (``CARRY_RN``, below), and each product is (p1 + p2) + p3 at the
  end.  That takes the 6 (8) per-thread
  [T // V, MP] sums out of the registers, so no depth up to MMA_MAX_M
  needs a group pass: xp, d, gp (pg) are read and the body runs once per
  element.  Row ``end`` (the new pair, unrounded, never read) is masked
  out of the operand and its products are folded in float32 from the
  pair in registers.  The . gp column rides in the same operand, so the
  3-column launch and the . gp launch run one binary (``with_gp`` a
  run-time flag that only stores the column).  The bound stays bytes: at
  m = 80 the products are 8192 operations per element (RP = 128 rows, 16
  columns, two rings), 0.14 ms of the tensor cores' bf16 rate against a
  1.70 ms byte bound at 1024 x 2^14.

  The solo K4 and K14 take the same tensor-core form on one instance
  (``trial_pair_gram_mma_kernel``, ``owlqn_trial_pair_gram_mma_kernel``;
  ``factory.solo_epilogue_grid``): one chunk body per kernel
  (``_k4_chunk``, ``_k14_chunk``) serves the solo and the batched form,
  so a batched instance's x, g, pg and ring row are the solo launch's bit
  for bit.  The solo forms add what the batch lacks: x, g and pg may alias
  xp, gp and pg_old (the lean state's in-place call; only the program
  that owns a chunk reads and writes it), the objective's partial per
  chunk, and the body's global indices on a shard (``_gidx``); they have
  no live mask.  One instance gives far fewer chunks than a batch (8192
  of 128 elements at n = 2^20), so the launch caps its programs
  (``factory.SOLO_MMA_PROGRAMS``) to spread each program's closing
  reductions over more chunks; and since the MMA's own accumulation does
  not round to nearest, every tensor-core form, solo and batched, adds
  each chunk's products to its running sums by float32 adds
  (``_ring_chunk``'s ``CARRY_RN``), so the products stay within ~1e-7
  normwise of the float64 product at any chunk count, and sums at most
  ``factory.MMA_MAX_CHUNKS`` chunks a program.  Every ring reader takes
  the ring's row stride ld (row j at j*ld): n, or n rounded up to a
  multiple of 16 with zero pad columns (the solver's rings,
  ``core.ring_zeros``), and the constant LD_IS_N (ld == n), with which it
  takes n as its stride and compiles to its code before the stride
  argument (``_stride``).  The tensor-core forms take a ring whose ld is
  a multiple of 16, at any n; over a padded ring they mask its tile by
  offs < ld, so that it loads in vectors.  A ring of row stride n at an
  n off a multiple of 16 takes the fold forms, solo and batched
  (``factory.MMA_ALIGN``).

  Where the solo fold forms' group passes ran (f32 and f64 rings above the
  static cap, bf16 rings above 256 rows) the solo K4 and K14 take the
  tensor-core row-block form (``trial_pair_gram_mma_rows_kernel``,
  ``owlqn_trial_pair_gram_mma_rows_kernel``; ``factory.MMA_ROWS_EPILOGUE``):
  the same chunk bodies, once per block of ring rows (``_k4_rows_pass``,
  ``_k14_rows_pass``: RP rows a block, the last one RT, so 260 bf16 rows
  take two blocks of 128 and one of 16 where the deep fold form passed
  over the vectors 33 times).  Each block's rows are the dot's first operand in
  the ring's own dtype (``_ring_dot``): a bf16 ring as it is; an f32 ring
  split into three bf16 parts as the vectors are, so every part's product
  is exact in the MMA and the nine are summed there; an f64 ring against
  the f64 vectors as they are (``_operand``), in a float64 dot.  The sums
  and accumulators take the vectors' dtype.  The point's outputs, the
  objective's partials and the scalar sums come from the last block's
  pass, which alone stores x, g (pg), so in-place calls stay safe as in the
  deep fold form; the block that holds row ``end`` stores the new pair.
  Bytes still bound it: the f32 ring's split costs ~6 ALU operations and
  three MMAs per ring element, the f64 dot (Hopper's FP64 MMA, whose n8
  shape the [K, 8] operand takes) 8 columns of which 4 are the vectors.
  K4 b and K14 b take the row-block form at the same depths, on the
  batch-wide grid (``trial_pair_gram_mma_rows_batched_kernel``,
  ``owlqn_trial_pair_gram_mma_rows_batched_kernel``): the one-pass batched
  kernels' instance offsets, step and live mask, and the same passes
  (``_k4_rows_pass``, ``_k14_rows_pass``) with the live flag masking
  every load and store, the objective's partial off (``FX``) and no shard
  offset, so an instance's x, g, pg and ring row stay the solo launch's
  bit for bit; the solo kernels pass True and the constant flags, which
  fold, so their code is as it was.

On a mesh each kernel runs on one rank's shard of the vectors: ``off``,
the shard's global offset, is added to the local offsets only where the
body sees them (its ``gidx``, ``lbfgs_tpu/ops/factory.py:174``;
``_gidx``); the pointers, the masks and the OWL-QN window (translated by
the wrappers) stay in the shard's own indices.  The add is compiled in
only where the offset is not 0 (``SHARD``), so a launch with no offset
is the single-process kernel, code and all.  The batched kernels are not
sharded and take no offset.

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
def _gidx(offs, off, SHARD: tl.constexpr):
    # the global element indices the body sees: a shard's offset added only
    # where it is not 0, so the single-process kernels compile unchanged
    if SHARD:
        offs = offs + off
    return offs


@triton.jit
def _extras(ex, offs, mask):
    # the blocks of the extra operands at x's offsets and mask
    exb = ()
    for i in tl.static_range(len(ex)):
        exb = exb + (tl.load(ex[i] + offs, mask=mask, other=0.0),)
    return exb


@triton.jit
def _view(exb, R: tl.constexpr, W: tl.constexpr):
    # the epilogues' extras blocks in the body's [R, W] view, as x's
    out = ()
    for i in tl.static_range(len(exb)):
        out = out + (tl.reshape(exb[i], [R, W]),)
    return out


@triton.jit
def _msign(v):
    # NaN and +-0 -> 0 (the reference's signum)
    return tl.where(v > 0, 1.0, tl.where(v < 0, -1.0, 0.0))


@triton.jit
def _sign(v):
    # +-1, 0 at +-0, NaN at NaN (jnp.sign)
    return tl.where(v > 0, 1.0, tl.where(v < 0, -1.0, v))


@triton.jit
def _pseudo_grad(g, x, c, in_win):
    # K14's pseudo-gradient at the new point inside the window (Andrew &
    # Gao Eq. 4), g outside it
    right = g + c
    left = g - c
    at_zero = tl.where(right < 0.0, right, tl.where(left > 0.0, left, 0.0))
    inside = tl.where(x != 0.0, g + _sign(x) * c, at_zero)
    return tl.where(in_win, inside, g)


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
def _stride(n, ld, LD_IS_N: tl.constexpr):
    # the ring's row stride: n where the ring is not padded (LD_IS_N: the
    # kernel then compiles as it did before the stride argument, bar that
    # parameter, which comes after the others), else ld.  On an H100 a
    # stride used where n would do slowed some fold forms by 3-14%, and
    # the parameter among the others cost the batched f32 row-block K14 b
    # two spilled registers
    if LD_IS_N:
        return n
    else:
        return ld


@triton.jit
def _combine_row(g, acc_s, acc_y, s_row, y_row, coef_ptr, mask, fix_end, j, m, FIX: tl.constexpr):
    # ring row j's terms of the combination, in K3's order (cs_j*S_j into
    # acc_s, then cy_j*Y_j into acc_y), the row widened in registers; with
    # FIX row fix_end is rewritten as round(ca*Y[fix_end] + cb*g) from the
    # row as read (K6's damped row)
    Sj = tl.load(s_row, mask=mask, other=0.0).to(g.dtype)
    Yj = tl.load(y_row, mask=mask, other=0.0).to(g.dtype)
    acc_s += tl.load(coef_ptr + 1 + j) * Sj
    acc_y += tl.load(coef_ptr + 1 + m + j) * Yj
    if FIX:
        fixed = tl.load(coef_ptr + 1 + 2 * m) * Yj + tl.load(coef_ptr + 2 + 2 * m) * g
        tl.store(y_row, fixed.to(y_row.dtype.element_ty), mask=mask & (fix_end == j))
    return acc_s, acc_y


@triton.jit
def _combination(g_ptr, S_ptr, Y_ptr, coef_ptr, offs, mask, st, m, fix_end, M: tl.constexpr,
                 FIX: tl.constexpr):
    # (g, r) with r = gamma*g + sum_j cs_j S_j + sum_j cy_j Y_j over the m
    # ring rows; coef = [gamma, cs_0 .. cs_{m-1}, cy_0 ..] and with FIX then
    # (ca, cb).  M > 0 unrolls the M = m rows (the static forms, m <=
    # factory.MAX_M); M = 0 loops over the m rows at run time (the deep
    # forms: one compile for every m).  Both add the rows in the same order
    # and round the same, so r does not depend on the form.  Ring row j
    # starts at j*st (the ring's row stride, ``_stride``)
    g = tl.load(g_ptr + offs, mask=mask, other=0.0)
    acc_s = tl.zeros_like(g)
    acc_y = tl.zeros_like(g)
    s_row = S_ptr + offs
    y_row = Y_ptr + offs
    if M > 0:
        for j in tl.static_range(M):
            acc_s, acc_y = _combine_row(g, acc_s, acc_y, s_row, y_row, coef_ptr, mask, fix_end,
                                        j, M, FIX)
            s_row += st
            y_row += st
    else:
        for j in range(m):
            acc_s, acc_y = _combine_row(g, acc_s, acc_y, s_row, y_row, coef_ptr, mask, fix_end,
                                        j, m, FIX)
            s_row += st
            y_row += st
    return g, tl.load(coef_ptr) * g + (acc_s + acc_y)


@triton.jit
def trial_kernel(xp_ptr, d_ptr, stp_ptr, xt_ptr, g_ptr, part_ptr, n, off, ex,
                 body: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr,
                 SHARD: tl.constexpr):
    offs = _offsets(ROWS, W)
    mask = offs < n
    stp = tl.load(stp_ptr)
    xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + offs, mask=mask, other=0.0)
    exb = _extras(ex, offs, mask)
    x = xp + stp * d
    fe, g = body(x, _gidx(offs, off, SHARD), *exb)
    tl.store(xt_ptr + offs, x, mask=mask)
    tl.store(g_ptr + offs, g, mask=mask)
    part = part_ptr + tl.program_id(0) * 5
    tl.store(part + 0, _block_sum(fe, mask))
    tl.store(part + 1, _block_sum(g * d, mask))
    tl.store(part + 2, _block_sum(g * g, mask))
    tl.store(part + 3, _block_sum(x * x, mask))
    tl.store(part + 4, _block_sum(tl.where(x != xp, 1.0, 0.0).to(x.dtype), mask))


@triton.jit
def probe_kernel(xp_ptr, d_ptr, stp_ptr, part_ptr, n, off, ex,
                 body: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr,
                 SHARD: tl.constexpr):
    offs = _offsets(ROWS, W)
    mask = offs < n
    stp = tl.load(stp_ptr)
    xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + offs, mask=mask, other=0.0)
    exb = _extras(ex, offs, mask)
    x = xp + stp * d
    fe, g = body(x, _gidx(offs, off, SHARD), *exb)
    _store_probe(part_ptr, fe, g, d, mask)


@triton.jit
def probe_batched_kernel(xp_ptr, d_ptr, stp_ptr, live_ptr, part_ptr, n, ex,
                         body: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr):
    # program (i, b): K2's block i of instance b
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    offs = _offsets(ROWS, W)
    mask = (offs < n) & live
    stp = tl.load(stp_ptr + b)
    xp = tl.load(xp_ptr + row + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + row + offs, mask=mask, other=0.0)
    exb = _extras(ex, offs, mask)
    x = xp + stp * d
    fe, g = body(x, offs, *exb)
    part = part_ptr + (b.to(tl.int64) * tl.num_programs(0) + tl.program_id(0)) * 2
    tl.store(part + 0, _block_sum(fe, mask), mask=live)
    tl.store(part + 1, _block_sum(g * d, mask), mask=live)


@triton.jit(do_not_specialize=["lo", "hi"])
def owlqn_probe_batched_kernel(xp_ptr, d_ptr, pg_ptr, stp_ptr, live_ptr, part_ptr, n, lo, hi,
                               ex, body: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr):
    # program (i, b): K8's block i of instance b, the orthant rebuilt from
    # (xp, pg) as K8's WP_IS_PG form does
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    offs = _offsets(ROWS, W)
    mask = (offs < n) & live
    stp = tl.load(stp_ptr + b)
    xp = tl.load(xp_ptr + row + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + row + offs, mask=mask, other=0.0)
    pg = tl.load(pg_ptr + row + offs, mask=mask, other=0.0)
    exb = _extras(ex, offs, mask)
    wp_sign = tl.where(xp == 0.0, _msign(-pg), _msign(xp))
    in_win = (offs >= lo) & (offs < hi)
    x = _ow_point(xp, d, stp, wp_sign, in_win)
    fe, g = body(x, offs, *exb)
    part = part_ptr + (b.to(tl.int64) * tl.num_programs(0) + tl.program_id(0)) * 3
    tl.store(part + 0, _block_sum(fe, mask), mask=live)
    tl.store(part + 1, _block_sum(tl.abs(x), mask & in_win), mask=live)
    tl.store(part + 2, _block_sum(g * d, mask), mask=live)


@triton.jit
def trial_batched_kernel(xp_ptr, d_ptr, stp_ptr, live_ptr, xt_ptr, g_ptr, ppart_ptr, part_ptr,
                         n, ex, body: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr):
    # program (i, b): K1's block i of instance b.  The objective's and g.d
    # partials go to a [B, programs, 2] array through K2 b's expressions, so
    # the wrapper sums them as it sums K2 b's (the remat contract); g.g, x.x
    # and the changed count to a [B, programs, 3] array of their own
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    offs = _offsets(ROWS, W)
    mask = (offs < n) & live
    stp = tl.load(stp_ptr + b)
    xp = tl.load(xp_ptr + row + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + row + offs, mask=mask, other=0.0)
    exb = _extras(ex, offs, mask)
    x = xp + stp * d
    fe, g = body(x, offs, *exb)
    tl.store(xt_ptr + row + offs, x, mask=mask)
    tl.store(g_ptr + row + offs, g, mask=mask)
    ppart = _batched_part(ppart_ptr, b, 2)
    tl.store(ppart + 0, _block_sum(fe, mask), mask=live)
    tl.store(ppart + 1, _block_sum(g * d, mask), mask=live)
    part = _batched_part(part_ptr, b, 3)
    tl.store(part + 0, _block_sum(g * g, mask), mask=live)
    tl.store(part + 1, _block_sum(x * x, mask), mask=live)
    tl.store(part + 2, _block_sum(tl.where(x != xp, 1.0, 0.0).to(x.dtype), mask), mask=live)


@triton.jit(do_not_specialize=["lo", "hi"])
def owlqn_trial_batched_kernel(xp_ptr, d_ptr, pg_ptr, stp_ptr, live_ptr, xt_ptr, g_ptr,
                               ppart_ptr, part_ptr, n, lo, hi, ex, body: tl.constexpr,
                               ROWS: tl.constexpr, W: tl.constexpr):
    # program (i, b): K7's block i of instance b, the orthant rebuilt from
    # (xp, pg) as K8 b rebuilds it; the (f, L1, g.d) partials through K8 b's
    # expressions into a [B, programs, 3] array, x.x and the changed count
    # into a [B, programs, 2] array of their own
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    offs = _offsets(ROWS, W)
    mask = (offs < n) & live
    stp = tl.load(stp_ptr + b)
    xp = tl.load(xp_ptr + row + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + row + offs, mask=mask, other=0.0)
    pg = tl.load(pg_ptr + row + offs, mask=mask, other=0.0)
    exb = _extras(ex, offs, mask)
    wp_sign = tl.where(xp == 0.0, _msign(-pg), _msign(xp))
    in_win = (offs >= lo) & (offs < hi)
    x = _ow_point(xp, d, stp, wp_sign, in_win)
    fe, g = body(x, offs, *exb)
    tl.store(xt_ptr + row + offs, x, mask=mask)
    tl.store(g_ptr + row + offs, g, mask=mask)
    ppart = _batched_part(ppart_ptr, b, 3)
    tl.store(ppart + 0, _block_sum(fe, mask), mask=live)
    tl.store(ppart + 1, _block_sum(tl.abs(x), mask & in_win), mask=live)
    tl.store(ppart + 2, _block_sum(g * d, mask), mask=live)
    part = _batched_part(part_ptr, b, 2)
    tl.store(part + 0, _block_sum(x * x, mask), mask=live)
    tl.store(part + 1, _block_sum(tl.where(x != xp, 1.0, 0.0).to(x.dtype), mask), mask=live)


@triton.jit(do_not_specialize=["m", "fix_end"])
def combine_probe_kernel(g_ptr, x_ptr, S_ptr, Y_ptr, coef_ptr, stp_ptr, r_ptr, cpart_ptr, ppart_ptr,
                         n, m, fix_end, off, ex, ld, body: tl.constexpr, M: tl.constexpr,
                         ROWS: tl.constexpr, W: tl.constexpr, FIX: tl.constexpr,
                         SHARD: tl.constexpr, LD_IS_N: tl.constexpr):
    # M = m: the static form; M = 0: the deep form (``_combination``)
    st = _stride(n, ld, LD_IS_N)
    offs = _offsets(ROWS, W)
    mask = offs < n
    g, r = _combination(g_ptr, S_ptr, Y_ptr, coef_ptr, offs, mask, st, m, fix_end, M, FIX)
    tl.store(r_ptr + offs, r, mask=mask)
    cpart = cpart_ptr + tl.program_id(0) * 2
    tl.store(cpart + 0, _block_sum(r * r, mask))
    tl.store(cpart + 1, _block_sum(r * g, mask))
    # the next search's first probe, as K2 forms it at (x, r, stp1)
    stp = tl.load(stp_ptr)
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    exb = _extras(ex, offs, mask)
    xt = x + stp * r
    fe, gt = body(xt, _gidx(offs, off, SHARD), *exb)
    _store_probe(ppart_ptr, fe, gt, r, mask)


@triton.jit(do_not_specialize=["m", "lo", "hi"])
def combine_ow_probe_kernel(pg_ptr, x_ptr, S_ptr, Y_ptr, coef_ptr, stp_ptr, r_ptr, cpart_ptr,
                            ppart_ptr, n, m, lo, hi, off, ex, ld, body: tl.constexpr,
                            M: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr,
                            SHARD: tl.constexpr, LD_IS_N: tl.constexpr):
    # M = m: the static form; M = 0: the deep form (``_combination``)
    st = _stride(n, ld, LD_IS_N)
    offs = _offsets(ROWS, W)
    mask = offs < n
    pg, r = _combination(pg_ptr, S_ptr, Y_ptr, coef_ptr, offs, mask, st, m, 0, M, False)
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
    exb = _extras(ex, offs, mask)
    wp_sign = tl.where(x == 0.0, _msign(-pg), _msign(x))
    xt = _ow_point(x, rc, stp, wp_sign, in_win)
    fe, gt = body(xt, _gidx(offs, off, SHARD), *exb)
    _store_ow_probe(ppart_ptr, fe, xt, gt, rc, mask, in_win)


@triton.jit
def _batched_part(part_ptr, b, k: tl.constexpr):
    # program (i, b)'s row of a batched launch's [B, programs, k] partials
    return part_ptr + (b.to(tl.int64) * tl.num_programs(0) + tl.program_id(0)) * k


@triton.jit(do_not_specialize=["m", "fix_end"])
def combine_probe_batched_kernel(g_ptr, x_ptr, S_ptr, Y_ptr, coef_ptr, stp_ptr, live_ptr, r_ptr,
                                 cpart_ptr, ppart_ptr, n, m, fix_end, ex, ld, body: tl.constexpr,
                                 M: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr,
                                 FIX: tl.constexpr, LD_IS_N: tl.constexpr):
    # program (i, b): K15's block i of instance b, its coefficient row and
    # its own stp1; M = m the static form, M = 0 the deep form.  With FIX
    # the row ends in (ca, cb) and ring row fix_end of the instance is
    # rewritten as K15's fix form rewrites it
    st = _stride(n, ld, LD_IS_N)
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    offs = _offsets(ROWS, W)
    mask = (offs < n) & live
    ncoef = 1 + 2 * m
    if FIX:
        ncoef += 2
    ring = (b.to(tl.int64) * st) * m
    g, r = _combination(g_ptr + row, S_ptr + ring, Y_ptr + ring,
                        coef_ptr + b.to(tl.int64) * ncoef, offs, mask, st, m, fix_end, M, FIX)
    tl.store(r_ptr + row + offs, r, mask=mask)
    cpart = _batched_part(cpart_ptr, b, 2)
    tl.store(cpart + 0, _block_sum(r * r, mask), mask=live)
    tl.store(cpart + 1, _block_sum(r * g, mask), mask=live)
    # the instance's next first probe, as K2 b forms it at (x, r, stp1)
    stp = tl.load(stp_ptr + b)
    x = tl.load(x_ptr + row + offs, mask=mask, other=0.0)
    exb = _extras(ex, offs, mask)
    xt = x + stp * r
    fe, gt = body(xt, offs, *exb)
    ppart = _batched_part(ppart_ptr, b, 2)
    tl.store(ppart + 0, _block_sum(fe, mask), mask=live)
    tl.store(ppart + 1, _block_sum(gt * r, mask), mask=live)


@triton.jit(do_not_specialize=["m", "lo", "hi"])
def combine_ow_probe_batched_kernel(pg_ptr, x_ptr, S_ptr, Y_ptr, coef_ptr, stp_ptr, live_ptr, r_ptr,
                                    cpart_ptr, ppart_ptr, n, m, lo, hi, ex, ld, body: tl.constexpr,
                                    M: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr,
                                    LD_IS_N: tl.constexpr):
    # program (i, b): K16's block i of instance b, the window in the
    # instance's own indices
    st = _stride(n, ld, LD_IS_N)
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    offs = _offsets(ROWS, W)
    mask = (offs < n) & live
    ring = (b.to(tl.int64) * st) * m
    pg, r = _combination(pg_ptr + row, S_ptr + ring, Y_ptr + ring,
                         coef_ptr + b.to(tl.int64) * (1 + 2 * m), offs, mask, st, m, 0, M, False)
    in_win = (offs >= lo) & (offs < hi)
    rc = tl.where(in_win & (_msign(r) != _msign(-pg)), 0.0, r)
    tl.store(r_ptr + row + offs, rc, mask=mask)
    cpart = _batched_part(cpart_ptr, b, 3)
    tl.store(cpart + 0, _block_sum(r * r, mask), mask=live)
    tl.store(cpart + 1, _block_sum(rc * rc, mask), mask=live)
    tl.store(cpart + 2, _block_sum(rc * pg, mask), mask=live)
    # the projected probe, as K8 b forms it at (x, rc, pg, stp1)
    stp = tl.load(stp_ptr + b)
    x = tl.load(x_ptr + row + offs, mask=mask, other=0.0)
    exb = _extras(ex, offs, mask)
    wp_sign = tl.where(x == 0.0, _msign(-pg), _msign(x))
    xt = _ow_point(x, rc, stp, wp_sign, in_win)
    fe, gt = body(xt, offs, *exb)
    ppart = _batched_part(ppart_ptr, b, 3)
    tl.store(ppart + 0, _block_sum(fe, mask), mask=live)
    tl.store(ppart + 1, _block_sum(tl.abs(xt), mask & in_win), mask=live)
    tl.store(ppart + 2, _block_sum(gt * rc, mask), mask=live)


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
def _ring_pass(S_ptr, Y_ptr, offs, mask, st, end, s, y, d0, gp, a0, a1, a2, a3, a4, a5, b0,
               b1, M: tl.constexpr, MP: tl.constexpr, WITH_GP: tl.constexpr):
    # one tile's pass over the rings: the m-1 old rows widen in registers,
    # row `end` is the new pair, unrounded and never read; the new pair is
    # then stored into row `end`, rounded to the history dtype; ring row j
    # starts at j*st (``_stride``)
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
        s_row += st
        y_row += st
    row = end.to(tl.int64) * st
    tl.store(S_ptr + row + offs, s.to(S_ptr.dtype.element_ty), mask=mask)
    tl.store(Y_ptr + row + offs, y.to(Y_ptr.dtype.element_ty), mask=mask)
    return a0, a1, a2, a3, a4, a5, b0, b1


@triton.jit
def _group_pass(S_ptr, Y_ptr, offs, mask, st, m, end, j0, s, y, d0, gp, a0, a1, a2, a3, a4, a5,
                b0, b1, G: tl.constexpr, WITH_GP: tl.constexpr):
    # ``_ring_pass`` over ring rows j0 .. j0 + G - 1 alone (those below m),
    # row j0 + c into column c of the [T // V, G] sums; the group that holds
    # row `end` stores the new pair there
    s_row = S_ptr + j0.to(tl.int64) * st + offs
    y_row = Y_ptr + j0.to(tl.int64) * st + offs
    for c in tl.static_range(G):
        j = j0 + c
        is_end = end == j
        live = mask & (end != j) & (j < m)
        Sj = tl.load(s_row, mask=live, other=0.0).to(s.dtype)
        Yj = tl.load(y_row, mask=live, other=0.0).to(s.dtype)
        Sj = tl.where(is_end, s, Sj)
        Yj = tl.where(is_end, y, Yj)
        a0, a1, a2, a3, a4, a5 = _gram_row(Sj, Yj, y, s, d0, a0, a1, a2, a3, a4, a5, c, G)
        if WITH_GP:
            b0 = _add_col(b0, _fold(Sj * gp), c, G)
            b1 = _add_col(b1, _fold(Yj * gp), c, G)
        s_row += st
        y_row += st
    holds_end = (end >= j0) & (end < j0 + G)
    row = end.to(tl.int64) * st
    tl.store(S_ptr + row + offs, s.to(S_ptr.dtype.element_ty), mask=mask & holds_end)
    tl.store(Y_ptr + row + offs, y.to(Y_ptr.dtype.element_ty), mask=mask & holds_end)
    return a0, a1, a2, a3, a4, a5, b0, b1


@triton.jit
def _store_gram(part, j0, m, a0, a1, a2, a3, a4, a5, MP: tl.constexpr):
    # the program's partials of the products of ring rows j0 .. j0 + MP - 1
    # (those below m; column c of the sums is row j0 + c), row j at part +
    # 6j: one cross-thread reduction per product kind for all MP rows
    r = j0 + tl.arange(0, MP)
    keep = r < m
    pj = part + 6 * r
    tl.store(pj + 0, tl.sum(a0, axis=0), mask=keep)
    tl.store(pj + 1, tl.sum(a1, axis=0), mask=keep)
    tl.store(pj + 2, tl.sum(a2, axis=0), mask=keep)
    tl.store(pj + 3, tl.sum(a3, axis=0), mask=keep)
    tl.store(pj + 4, tl.sum(a4, axis=0), mask=keep)
    tl.store(pj + 5, tl.sum(a5, axis=0), mask=keep)


@triton.jit
def _store_gp(gpart, j0, m, b0, b1, MP: tl.constexpr):
    # the . gp column's partials, (S_j.gp, Y_j.gp) at gpart + 2j, for the
    # rows of ``_store_gram``
    r = j0 + tl.arange(0, MP)
    keep = r < m
    tl.store(gpart + 2 * r, tl.sum(b0, axis=0), mask=keep)
    tl.store(gpart + 2 * r + 1, tl.sum(b1, axis=0), mask=keep)


@triton.jit(do_not_specialize=["end", "tiles"])
def trial_pair_gram_kernel(xp_ptr, d_ptr, gp_ptr, stp_ptr, x_ptr, g_ptr, S_ptr, Y_ptr, fx_ptr,
                           part_ptr, gpart_ptr, n, end, tiles, off, ex, ld, body: tl.constexpr,
                           M: tl.constexpr, MP: tl.constexpr, T: tl.constexpr, V: tl.constexpr,
                           W: tl.constexpr, WITH_GP: tl.constexpr, SHARD: tl.constexpr,
                           LD_IS_N: tl.constexpr):
    # program pid takes tiles pid*tiles .. pid*tiles + tiles - 1 of T
    # elements each; the sums stay in per-thread registers across them
    st = _stride(n, ld, LD_IS_N)
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
        exb = _view(_extras(ex, offs, mask), T // W, W)
        x = xp + stp * d
        # the body sees the [T // W, W] view of the tile
        gidx = tl.reshape(_gidx(offs, off, SHARD), [T // W, W])
        fe, g = body(tl.reshape(x, [T // W, W]), gidx, *exb)
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
        a0, a1, a2, a3, a4, a5, b0, b1 = _ring_pass(S_ptr, Y_ptr, offs, mask, st, end, s, y,
                                                    d0, gp, a0, a1, a2, a3, a4, a5, b0, b1,
                                                    M, MP, WITH_GP)
        tl.store(x_ptr + offs, x, mask=mask)
        tl.store(g_ptr + offs, g, mask=mask)
    part = part_ptr + pid * (4 + 6 * M)
    tl.store(part + 0, tl.sum(a_gd, axis=0))
    tl.store(part + 1, tl.sum(a_gg, axis=0))
    tl.store(part + 2, tl.sum(a_xx, axis=0))
    tl.store(part + 3, tl.sum(a_ch, axis=0))
    _store_gram(part + 4, 0, M, a0, a1, a2, a3, a4, a5, MP)
    if WITH_GP:
        _store_gp(gpart_ptr + pid * (2 * M), 0, M, b0, b1, MP)


@triton.jit(do_not_specialize=["m", "end", "tiles"])
def trial_pair_gram_deep_kernel(xp_ptr, d_ptr, gp_ptr, stp_ptr, x_ptr, g_ptr, S_ptr, Y_ptr, fx_ptr,
                                part_ptr, gpart_ptr, n, end, tiles, off, ex, m, ld,
                                body: tl.constexpr, G: tl.constexpr, T: tl.constexpr,
                                V: tl.constexpr, W: tl.constexpr, WITH_GP: tl.constexpr,
                                SHARD: tl.constexpr, LD_IS_N: tl.constexpr):
    # K4 at any depth: program pid takes the static form's tiles
    # (``factory.solo_epilogue_grid``) and passes over them once per group of G
    # ring rows, recomputing the point, the body and the pair each pass and
    # holding that group's sums in registers; the point's outputs and sums
    # come from the last pass alone.  x and g may alias xp and gp (the lean
    # state's in-place call): only this program reads its tiles, and every
    # earlier pass has read them before the last one stores over them.  The
    # last pass forms and folds the point's sums as the static form does,
    # tile by tile in the same order, so x, g, the objective's partials and
    # the scalar partials are the static launch's bit for bit
    st = _stride(n, ld, LD_IS_N)
    pid = tl.program_id(0)
    dt = xp_ptr.dtype.element_ty
    stp = tl.load(stp_ptr)
    R: tl.constexpr = T // V
    a_gd = tl.zeros([R], dt)
    a_gg = tl.zeros([R], dt)
    a_xx = tl.zeros([R], dt)
    a_ch = tl.zeros([R], dt)
    part = part_ptr + pid * (4 + 6 * m)
    groups = tl.cdiv(m, G)
    for grp in range(groups):
        j0 = grp * G
        last = grp == groups - 1
        a0 = tl.zeros([R, G], dt)
        a1 = tl.zeros([R, G], dt)
        a2 = tl.zeros([R, G], dt)
        a3 = tl.zeros([R, G], dt)
        a4 = tl.zeros([R, G], dt)
        a5 = tl.zeros([R, G], dt)
        b0 = tl.zeros([R, G], dt)
        b1 = tl.zeros([R, G], dt)
        for t in range(tiles):
            tile = pid * tiles + t
            offs = _tile(tile, T, V)
            mask = offs < n
            xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
            d = tl.load(d_ptr + offs, mask=mask, other=0.0)
            gp = tl.load(gp_ptr + offs, mask=mask, other=0.0)
            exb = _view(_extras(ex, offs, mask), T // W, W)
            x = xp + stp * d
            gidx = tl.reshape(_gidx(offs, off, SHARD), [T // W, W])
            fe, g = body(tl.reshape(x, [T // W, W]), gidx, *exb)
            fe = tl.reshape(fe, [R, V])
            g = tl.reshape(g, [R, V])
            g = tl.where(mask, g, 0.0)
            if last:
                # the point's work before the ring rows: only s, y, d0 and
                # gp stay live through them
                tl.store(fx_ptr + tile, tl.sum(tl.sum(tl.where(mask, fe, 0.0), axis=1), axis=0))
                a_gd += _fold(g * d)
                a_gg += _fold(g * g)
                a_xx += _fold(x * x)
                a_ch += _fold(tl.where(x != xp, 1.0, 0.0).to(dt))
                tl.store(x_ptr + offs, x, mask=mask)
                tl.store(g_ptr + offs, g, mask=mask)
            s = stp * d
            y = g - gp
            d0 = -g
            a0, a1, a2, a3, a4, a5, b0, b1 = _group_pass(S_ptr, Y_ptr, offs, mask, st, m, end,
                                                         j0, s, y, d0, gp, a0, a1, a2, a3, a4,
                                                         a5, b0, b1, G, WITH_GP)
        _store_gram(part + 4, j0, m, a0, a1, a2, a3, a4, a5, G)
        if WITH_GP:
            _store_gp(gpart_ptr + pid * (2 * m), j0, m, b0, b1, G)
    tl.store(part + 0, tl.sum(a_gd, axis=0))
    tl.store(part + 1, tl.sum(a_gg, axis=0))
    tl.store(part + 2, tl.sum(a_xx, axis=0))
    tl.store(part + 3, tl.sum(a_ch, axis=0))


@triton.jit
def _store_gram_live(part, live, j0, m, a0, a1, a2, a3, a4, a5, MP: tl.constexpr):
    # ``_store_gram`` for a batched program: nothing for a frozen instance
    r = j0 + tl.arange(0, MP)
    keep = (r < m) & live
    pj = part + 6 * r
    tl.store(pj + 0, tl.sum(a0, axis=0), mask=keep)
    tl.store(pj + 1, tl.sum(a1, axis=0), mask=keep)
    tl.store(pj + 2, tl.sum(a2, axis=0), mask=keep)
    tl.store(pj + 3, tl.sum(a3, axis=0), mask=keep)
    tl.store(pj + 4, tl.sum(a4, axis=0), mask=keep)
    tl.store(pj + 5, tl.sum(a5, axis=0), mask=keep)


@triton.jit
def _store_gp_live(gpart, live, j0, m, b0, b1, MP: tl.constexpr):
    # ``_store_gp`` for a batched program: nothing for a frozen instance
    r = j0 + tl.arange(0, MP)
    keep = (r < m) & live
    tl.store(gpart + 2 * r, tl.sum(b0, axis=0), mask=keep)
    tl.store(gpart + 2 * r + 1, tl.sum(b1, axis=0), mask=keep)


@triton.jit(do_not_specialize=["end", "tiles"])
def trial_pair_gram_batched_kernel(xp_ptr, d_ptr, gp_ptr, stp_ptr, live_ptr, S_ptr, Y_ptr, part_ptr,
                                   gpart_ptr, n, end, tiles, ex, ld, body: tl.constexpr,
                                   M: tl.constexpr, MP: tl.constexpr, T: tl.constexpr,
                                   V: tl.constexpr, W: tl.constexpr, WITH_GP: tl.constexpr,
                                   LD_IS_N: tl.constexpr):
    # program (pid, b): K4's program pid of instance b, in place, without
    # the objective's partials; with WITH_GP the . gp column into partials
    # of its own, [B, programs, 2m], as K4's WITH_GP form adds it
    st = _stride(n, ld, LD_IS_N)
    pid = tl.program_id(0)
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    xp_ptr += row
    d_ptr += row
    gp_ptr += row
    S_ptr += (b.to(tl.int64) * st) * M
    Y_ptr += (b.to(tl.int64) * st) * M
    dt = xp_ptr.dtype.element_ty
    stp = tl.load(stp_ptr + b)
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
        offs = _tile(pid * tiles + t, T, V)
        mask = (offs < n) & live
        xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
        d = tl.load(d_ptr + offs, mask=mask, other=0.0)
        gp = tl.load(gp_ptr + offs, mask=mask, other=0.0)
        exb = _view(_extras(ex, offs, mask), T // W, W)
        x = xp + stp * d
        _, g = body(tl.reshape(x, [T // W, W]), tl.reshape(offs, [T // W, W]), *exb)
        g = tl.reshape(g, [R, V])
        g = tl.where(mask, g, 0.0)
        s = stp * d
        y = g - gp
        d0 = -g
        a_gd += _fold(g * d)
        a_gg += _fold(g * g)
        a_xx += _fold(x * x)
        a_ch += _fold(tl.where(x != xp, 1.0, 0.0).to(dt))
        a0, a1, a2, a3, a4, a5, b0, b1 = _ring_pass(S_ptr, Y_ptr, offs, mask, st, end, s, y, d0,
                                                    gp, a0, a1, a2, a3, a4, a5, b0, b1, M, MP,
                                                    WITH_GP)
        tl.store(xp_ptr + offs, x, mask=mask)
        tl.store(gp_ptr + offs, g, mask=mask)
    prog = b.to(tl.int64) * tl.num_programs(0) + pid
    part = part_ptr + prog * (4 + 6 * M)
    tl.store(part + 0, tl.sum(a_gd, axis=0), mask=live)
    tl.store(part + 1, tl.sum(a_gg, axis=0), mask=live)
    tl.store(part + 2, tl.sum(a_xx, axis=0), mask=live)
    tl.store(part + 3, tl.sum(a_ch, axis=0), mask=live)
    _store_gram_live(part + 4, live, 0, M, a0, a1, a2, a3, a4, a5, MP)
    if WITH_GP:
        _store_gp_live(gpart_ptr + prog * (2 * M), live, 0, M, b0, b1, MP)


@triton.jit(do_not_specialize=["m", "end", "tiles"])
def trial_pair_gram_deep_batched_kernel(xp_ptr, d_ptr, gp_ptr, stp_ptr, live_ptr, S_ptr, Y_ptr,
                                        part_ptr, gpart_ptr, n, end, tiles, ex, m, ld,
                                        body: tl.constexpr, G: tl.constexpr, T: tl.constexpr,
                                        V: tl.constexpr, W: tl.constexpr, WITH_GP: tl.constexpr,
                                        LD_IS_N: tl.constexpr):
    # program (pid, b): the deep K4's program pid of instance b, in place,
    # without the objective's partials (with WITH_GP the . gp column, per
    # group, as the deep K4's WITH_GP form); x and g go over xp and gp on
    # the last pass alone, as the deep K4 stores them
    st = _stride(n, ld, LD_IS_N)
    pid = tl.program_id(0)
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    xp_ptr += row
    d_ptr += row
    gp_ptr += row
    S_ptr += (b.to(tl.int64) * st) * m
    Y_ptr += (b.to(tl.int64) * st) * m
    dt = xp_ptr.dtype.element_ty
    stp = tl.load(stp_ptr + b)
    R: tl.constexpr = T // V
    a_gd = tl.zeros([R], dt)
    a_gg = tl.zeros([R], dt)
    a_xx = tl.zeros([R], dt)
    a_ch = tl.zeros([R], dt)
    prog = b.to(tl.int64) * tl.num_programs(0) + pid
    part = part_ptr + prog * (4 + 6 * m)
    groups = tl.cdiv(m, G)
    for grp in range(groups):
        j0 = grp * G
        last = grp == groups - 1
        a0 = tl.zeros([R, G], dt)
        a1 = tl.zeros([R, G], dt)
        a2 = tl.zeros([R, G], dt)
        a3 = tl.zeros([R, G], dt)
        a4 = tl.zeros([R, G], dt)
        a5 = tl.zeros([R, G], dt)
        b0 = tl.zeros([R, G], dt)
        b1 = tl.zeros([R, G], dt)
        for t in range(tiles):
            offs = _tile(pid * tiles + t, T, V)
            mask = (offs < n) & live
            xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
            d = tl.load(d_ptr + offs, mask=mask, other=0.0)
            gp = tl.load(gp_ptr + offs, mask=mask, other=0.0)
            exb = _view(_extras(ex, offs, mask), T // W, W)
            x = xp + stp * d
            _, g = body(tl.reshape(x, [T // W, W]), tl.reshape(offs, [T // W, W]), *exb)
            g = tl.reshape(g, [R, V])
            g = tl.where(mask, g, 0.0)
            if last:
                a_gd += _fold(g * d)
                a_gg += _fold(g * g)
                a_xx += _fold(x * x)
                a_ch += _fold(tl.where(x != xp, 1.0, 0.0).to(dt))
                tl.store(xp_ptr + offs, x, mask=mask)
                tl.store(gp_ptr + offs, g, mask=mask)
            s = stp * d
            y = g - gp
            d0 = -g
            a0, a1, a2, a3, a4, a5, b0, b1 = _group_pass(S_ptr, Y_ptr, offs, mask, st, m, end,
                                                         j0, s, y, d0, gp, a0, a1, a2, a3, a4,
                                                         a5, b0, b1, G, WITH_GP)
        _store_gram_live(part + 4, live, j0, m, a0, a1, a2, a3, a4, a5, G)
        if WITH_GP:
            _store_gp_live(gpart_ptr + prog * (2 * m), live, j0, m, b0, b1, G)
    tl.store(part + 0, tl.sum(a_gd, axis=0), mask=live)
    tl.store(part + 1, tl.sum(a_gg, axis=0), mask=live)
    tl.store(part + 2, tl.sum(a_xx, axis=0), mask=live)
    tl.store(part + 3, tl.sum(a_ch, axis=0), mask=live)


@triton.jit(do_not_specialize=["lo", "hi"])
def owlqn_trial_kernel(xp_ptr, d_ptr, wp_ptr, stp_ptr, xt_ptr, g_ptr, ppart_ptr, part_ptr,
                       n, lo, hi, off, ex, body: tl.constexpr, ROWS: tl.constexpr,
                       W: tl.constexpr, SHARD: tl.constexpr):
    offs = _offsets(ROWS, W)
    mask = offs < n
    stp = tl.load(stp_ptr)
    xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + offs, mask=mask, other=0.0)
    wp = tl.load(wp_ptr + offs, mask=mask, other=0.0)
    exb = _extras(ex, offs, mask)
    in_win = (offs >= lo) & (offs < hi)
    x = _ow_point(xp, d, stp, _msign(wp), in_win)
    fe, g = body(x, _gidx(offs, off, SHARD), *exb)
    tl.store(xt_ptr + offs, x, mask=mask)
    tl.store(g_ptr + offs, g, mask=mask)
    _store_ow_probe(ppart_ptr, fe, x, g, d, mask, in_win)
    part = part_ptr + tl.program_id(0) * 2
    tl.store(part + 0, _block_sum(x * x, mask))
    tl.store(part + 1, _block_sum(tl.where(x != xp, 1.0, 0.0).to(x.dtype), mask))


@triton.jit(do_not_specialize=["lo", "hi"])
def owlqn_probe_kernel(xp_ptr, d_ptr, w_ptr, stp_ptr, part_ptr, n, lo, hi, off, ex,
                       body: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr,
                       WP_IS_PG: tl.constexpr, SHARD: tl.constexpr):
    offs = _offsets(ROWS, W)
    mask = offs < n
    stp = tl.load(stp_ptr)
    xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + offs, mask=mask, other=0.0)
    w = tl.load(w_ptr + offs, mask=mask, other=0.0)
    exb = _extras(ex, offs, mask)
    if WP_IS_PG:
        # the orthant in registers from (xp, pg): choose_orthant's formula
        wp_sign = tl.where(xp == 0.0, _msign(-w), _msign(xp))
    else:
        wp_sign = _msign(w)
    in_win = (offs >= lo) & (offs < hi)
    x = _ow_point(xp, d, stp, wp_sign, in_win)
    fe, g = body(x, _gidx(offs, off, SHARD), *exb)
    _store_ow_probe(part_ptr, fe, x, g, d, mask, in_win)


@triton.jit(do_not_specialize=["stride"])
def probe_steps_kernel(xp_ptr, d_ptr, stp_ptr, part_ptr, stride, n, off, ex,
                       body: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr,
                       K: tl.constexpr, SHARD: tl.constexpr):
    # K2 s: K2's block at the K steps stp_ptr[0 .. K-1], xp, d and the
    # extras loaded once; lane k's objective sum (K2's column 0; the search
    # reads the objective alone, so g.d is not formed) at part_ptr +
    # program*stride + k, the lanes of one program side by side
    offs = _offsets(ROWS, W)
    mask = offs < n
    xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + offs, mask=mask, other=0.0)
    exb = _extras(ex, offs, mask)
    gidx = _gidx(offs, off, SHARD)
    part = part_ptr + tl.program_id(0).to(tl.int64) * stride
    for k in tl.static_range(K):
        x = xp + tl.load(stp_ptr + k) * d
        fe, g = body(x, gidx, *exb)
        tl.store(part + k, _block_sum(fe, mask))


@triton.jit(do_not_specialize=["stp_stride", "stride"])
def probe_steps_batched_kernel(xp_ptr, d_ptr, stp_ptr, stp_stride, live_ptr, part_ptr, stride,
                               n, ex, body: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr,
                               K: tl.constexpr):
    # K2 b s: program (i, b) is K2 b's at the K steps stp_ptr[b*stp_stride
    # + k]; lane k's objective sum at part_ptr + (b*programs + i)*stride +
    # k, as K2 s
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    offs = _offsets(ROWS, W)
    mask = (offs < n) & live
    xp = tl.load(xp_ptr + row + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + row + offs, mask=mask, other=0.0)
    exb = _extras(ex, offs, mask)
    progs = tl.num_programs(0).to(tl.int64)
    part = part_ptr + (b.to(tl.int64) * progs + tl.program_id(0)) * stride
    for k in tl.static_range(K):
        x = xp + tl.load(stp_ptr + b * stp_stride + k) * d
        fe, g = body(x, offs, *exb)
        tl.store(part + k, _block_sum(fe, mask), mask=live)


@triton.jit(do_not_specialize=["stride", "lo", "hi"])
def owlqn_probe_steps_kernel(xp_ptr, d_ptr, wp_ptr, stp_ptr, part_ptr, stride, n, lo, hi, off,
                             ex, body: tl.constexpr, ROWS: tl.constexpr, W: tl.constexpr,
                             K: tl.constexpr, SHARD: tl.constexpr):
    # K8 s: K8's block at K steps, the orthant's signs formed once; lane k's
    # objective and window |x| sums (K8's columns 0 and 1; g.d is not
    # formed) at part_ptr + program*stride + 2k and + 2k + 1
    offs = _offsets(ROWS, W)
    mask = offs < n
    xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + offs, mask=mask, other=0.0)
    wp_sign = _msign(tl.load(wp_ptr + offs, mask=mask, other=0.0))
    exb = _extras(ex, offs, mask)
    in_win = (offs >= lo) & (offs < hi)
    gidx = _gidx(offs, off, SHARD)
    part = part_ptr + tl.program_id(0).to(tl.int64) * stride
    for k in tl.static_range(K):
        x = _ow_point(xp, d, tl.load(stp_ptr + k), wp_sign, in_win)
        fe, g = body(x, gidx, *exb)
        tl.store(part + 2 * k, _block_sum(fe, mask))
        tl.store(part + 2 * k + 1, _block_sum(tl.abs(x), mask & in_win))


@triton.jit(do_not_specialize=["stp_stride", "stride", "lo", "hi"])
def owlqn_probe_steps_batched_kernel(xp_ptr, d_ptr, pg_ptr, stp_ptr, stp_stride, live_ptr,
                                     part_ptr, stride, n, lo, hi, ex, body: tl.constexpr,
                                     ROWS: tl.constexpr, W: tl.constexpr, K: tl.constexpr):
    # K8 b s: program (i, b) is K8 b's at K steps, the orthant rebuilt from
    # (xp, pg) once; lane k's (f, L1) sums at part_ptr + (b*programs +
    # i)*stride + 2k and + 2k + 1, as K8 s
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    offs = _offsets(ROWS, W)
    mask = (offs < n) & live
    xp = tl.load(xp_ptr + row + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + row + offs, mask=mask, other=0.0)
    pg = tl.load(pg_ptr + row + offs, mask=mask, other=0.0)
    exb = _extras(ex, offs, mask)
    wp_sign = tl.where(xp == 0.0, _msign(-pg), _msign(xp))
    in_win = (offs >= lo) & (offs < hi)
    progs = tl.num_programs(0).to(tl.int64)
    part = part_ptr + (b.to(tl.int64) * progs + tl.program_id(0)) * stride
    for k in tl.static_range(K):
        x = _ow_point(xp, d, tl.load(stp_ptr + b * stp_stride + k), wp_sign, in_win)
        fe, g = body(x, offs, *exb)
        tl.store(part + 2 * k, _block_sum(fe, mask), mask=live)
        tl.store(part + 2 * k + 1, _block_sum(tl.abs(x), mask & in_win), mask=live)


@triton.jit(do_not_specialize=["end", "lo", "hi", "tiles"])
def owlqn_trial_pair_gram_kernel(xp_ptr, d_ptr, gp_ptr, pg_ptr, stp_ptr, c_ptr, x_ptr, g_ptr,
                                 pgn_ptr, S_ptr, Y_ptr, part_ptr, gpart_ptr, n, lo, hi, end, tiles,
                                 off, ex, ld, body: tl.constexpr, M: tl.constexpr, MP: tl.constexpr,
                                 T: tl.constexpr, V: tl.constexpr, W: tl.constexpr,
                                 WITH_GP: tl.constexpr, SHARD: tl.constexpr, LD_IS_N: tl.constexpr):
    st = _stride(n, ld, LD_IS_N)
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
        exb = _view(_extras(ex, offs, mask), T // W, W)
        in_win = (offs >= lo) & (offs < hi)
        # orthant from the previous point's (x, pg): the search's choose_orthant
        wp_sign = tl.where(xp == 0.0, _msign(-pgo), _msign(xp))
        x = _ow_point(xp, d, stp, wp_sign, in_win)
        gidx = tl.reshape(_gidx(offs, off, SHARD), [T // W, W])
        _, g = body(tl.reshape(x, [T // W, W]), gidx, *exb)
        g = tl.reshape(g, [R, V])
        g = tl.where(mask, g, 0.0)
        pg = _pseudo_grad(g, x, c, in_win)
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
        a0, a1, a2, a3, a4, a5, b0, b1 = _ring_pass(S_ptr, Y_ptr, offs, mask, st, end, s, y,
                                                    d0, gp, a0, a1, a2, a3, a4, a5, b0, b1,
                                                    M, MP, WITH_GP)
        tl.store(x_ptr + offs, x, mask=mask)
        tl.store(g_ptr + offs, g, mask=mask)
        tl.store(pgn_ptr + offs, pg, mask=mask)
    part = part_ptr + pid * (3 + 6 * M)
    tl.store(part + 0, tl.sum(a_xx, axis=0))
    tl.store(part + 1, tl.sum(a_pp, axis=0))
    tl.store(part + 2, tl.sum(a_ch, axis=0))
    _store_gram(part + 3, 0, M, a0, a1, a2, a3, a4, a5, MP)
    if WITH_GP:
        gpart = gpart_ptr + pid * (2 + 2 * M)
        tl.store(gpart + 0, tl.sum(a_gg, axis=0))
        tl.store(gpart + 1, tl.sum(a_gpg, axis=0))
        _store_gp(gpart + 2, 0, M, b0, b1, MP)


@triton.jit(do_not_specialize=["m", "end", "lo", "hi", "tiles"])
def owlqn_trial_pair_gram_deep_kernel(xp_ptr, d_ptr, gp_ptr, pg_ptr, stp_ptr, c_ptr, x_ptr, g_ptr,
                                      pgn_ptr, S_ptr, Y_ptr, part_ptr, gpart_ptr, n, lo, hi, end,
                                      tiles, off, ex, m, ld, body: tl.constexpr, G: tl.constexpr,
                                      T: tl.constexpr, V: tl.constexpr, W: tl.constexpr,
                                      WITH_GP: tl.constexpr, SHARD: tl.constexpr,
                                      LD_IS_N: tl.constexpr):
    # K14 at any depth, laid out as ``trial_pair_gram_deep_kernel``: a pass
    # over the program's tiles per group of G ring rows, the point's
    # outputs and sums (x, g, pg, x.x, pg.pg, changed, and gp.gp, gp.pg
    # with WITH_GP) from the last pass alone, so x, g and pg may alias xp,
    # gp and pg_old, and each is the static launch's bit for bit
    st = _stride(n, ld, LD_IS_N)
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
    part = part_ptr + pid * (3 + 6 * m)
    gpart = gpart_ptr + pid * (2 + 2 * m)
    groups = tl.cdiv(m, G)
    for grp in range(groups):
        j0 = grp * G
        last = grp == groups - 1
        a0 = tl.zeros([R, G], dt)
        a1 = tl.zeros([R, G], dt)
        a2 = tl.zeros([R, G], dt)
        a3 = tl.zeros([R, G], dt)
        a4 = tl.zeros([R, G], dt)
        a5 = tl.zeros([R, G], dt)
        b0 = tl.zeros([R, G], dt)
        b1 = tl.zeros([R, G], dt)
        for t in range(tiles):
            offs = _tile(pid * tiles + t, T, V)
            mask = offs < n
            xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
            d = tl.load(d_ptr + offs, mask=mask, other=0.0)
            gp = tl.load(gp_ptr + offs, mask=mask, other=0.0)
            pgo = tl.load(pg_ptr + offs, mask=mask, other=0.0)
            exb = _view(_extras(ex, offs, mask), T // W, W)
            in_win = (offs >= lo) & (offs < hi)
            wp_sign = tl.where(xp == 0.0, _msign(-pgo), _msign(xp))
            x = _ow_point(xp, d, stp, wp_sign, in_win)
            gidx = tl.reshape(_gidx(offs, off, SHARD), [T // W, W])
            _, g = body(tl.reshape(x, [T // W, W]), gidx, *exb)
            g = tl.reshape(g, [R, V])
            g = tl.where(mask, g, 0.0)
            pg = _pseudo_grad(g, x, c, in_win)
            if last:
                a_xx += _fold(x * x)
                a_pp += _fold(pg * pg)
                a_ch += _fold(tl.where(x != xp, 1.0, 0.0).to(dt))
                if WITH_GP:
                    a_gg += _fold(gp * gp)
                    a_gpg += _fold(gp * pg)
                tl.store(x_ptr + offs, x, mask=mask)
                tl.store(g_ptr + offs, g, mask=mask)
                tl.store(pgn_ptr + offs, pg, mask=mask)
            s = x - xp
            y = g - gp
            d0 = -pg
            a0, a1, a2, a3, a4, a5, b0, b1 = _group_pass(S_ptr, Y_ptr, offs, mask, st, m, end,
                                                         j0, s, y, d0, gp, a0, a1, a2, a3, a4,
                                                         a5, b0, b1, G, WITH_GP)
        _store_gram(part + 3, j0, m, a0, a1, a2, a3, a4, a5, G)
        if WITH_GP:
            _store_gp(gpart + 2, j0, m, b0, b1, G)
    tl.store(part + 0, tl.sum(a_xx, axis=0))
    tl.store(part + 1, tl.sum(a_pp, axis=0))
    tl.store(part + 2, tl.sum(a_ch, axis=0))
    if WITH_GP:
        tl.store(gpart + 0, tl.sum(a_gg, axis=0))
        tl.store(gpart + 1, tl.sum(a_gpg, axis=0))


@triton.jit(do_not_specialize=["end", "lo", "hi", "tiles"])
def owlqn_trial_pair_gram_batched_kernel(xp_ptr, d_ptr, gp_ptr, pg_ptr, stp_ptr, c_ptr, live_ptr,
                                         S_ptr, Y_ptr, part_ptr, gpart_ptr, n, lo, hi, end, tiles,
                                         ex, ld, body: tl.constexpr, M: tl.constexpr,
                                         MP: tl.constexpr, T: tl.constexpr, V: tl.constexpr,
                                         W: tl.constexpr, WITH_GP: tl.constexpr,
                                         LD_IS_N: tl.constexpr):
    # program (pid, b): K14's program pid of instance b, in place (x, g and
    # pg over xp, gp and pg_old); with WITH_GP gp.gp, gp.pg and the . gp
    # column into partials of their own, [B, programs, 2 + 2m], taken
    # before g overwrites gp, as K14's WITH_GP form takes them
    st = _stride(n, ld, LD_IS_N)
    pid = tl.program_id(0)
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    xp_ptr += row
    d_ptr += row
    gp_ptr += row
    pg_ptr += row
    S_ptr += (b.to(tl.int64) * st) * M
    Y_ptr += (b.to(tl.int64) * st) * M
    dt = xp_ptr.dtype.element_ty
    stp = tl.load(stp_ptr + b)
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
        mask = (offs < n) & live
        xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
        d = tl.load(d_ptr + offs, mask=mask, other=0.0)
        gp = tl.load(gp_ptr + offs, mask=mask, other=0.0)
        pgo = tl.load(pg_ptr + offs, mask=mask, other=0.0)
        exb = _view(_extras(ex, offs, mask), T // W, W)
        in_win = (offs >= lo) & (offs < hi)
        wp_sign = tl.where(xp == 0.0, _msign(-pgo), _msign(xp))
        x = _ow_point(xp, d, stp, wp_sign, in_win)
        _, g = body(tl.reshape(x, [T // W, W]), tl.reshape(offs, [T // W, W]), *exb)
        g = tl.reshape(g, [R, V])
        g = tl.where(mask, g, 0.0)
        pg = _pseudo_grad(g, x, c, in_win)
        s = x - xp
        y = g - gp
        d0 = -pg
        a_xx += _fold(x * x)
        a_pp += _fold(pg * pg)
        a_ch += _fold(tl.where(x != xp, 1.0, 0.0).to(dt))
        if WITH_GP:
            a_gg += _fold(gp * gp)
            a_gpg += _fold(gp * pg)
        a0, a1, a2, a3, a4, a5, b0, b1 = _ring_pass(S_ptr, Y_ptr, offs, mask, st, end, s, y, d0,
                                                    gp, a0, a1, a2, a3, a4, a5, b0, b1, M, MP,
                                                    WITH_GP)
        tl.store(xp_ptr + offs, x, mask=mask)
        tl.store(gp_ptr + offs, g, mask=mask)
        tl.store(pg_ptr + offs, pg, mask=mask)
    prog = b.to(tl.int64) * tl.num_programs(0) + pid
    part = part_ptr + prog * (3 + 6 * M)
    tl.store(part + 0, tl.sum(a_xx, axis=0), mask=live)
    tl.store(part + 1, tl.sum(a_pp, axis=0), mask=live)
    tl.store(part + 2, tl.sum(a_ch, axis=0), mask=live)
    _store_gram_live(part + 3, live, 0, M, a0, a1, a2, a3, a4, a5, MP)
    if WITH_GP:
        gpart = gpart_ptr + prog * (2 + 2 * M)
        tl.store(gpart + 0, tl.sum(a_gg, axis=0), mask=live)
        tl.store(gpart + 1, tl.sum(a_gpg, axis=0), mask=live)
        _store_gp_live(gpart + 2, live, 0, M, b0, b1, MP)


@triton.jit(do_not_specialize=["m", "end", "lo", "hi", "tiles"])
def owlqn_trial_pair_gram_deep_batched_kernel(xp_ptr, d_ptr, gp_ptr, pg_ptr, stp_ptr, c_ptr,
                                              live_ptr, S_ptr, Y_ptr, part_ptr, gpart_ptr, n, lo,
                                              hi, end, tiles, ex, m, ld, body: tl.constexpr,
                                              G: tl.constexpr, T: tl.constexpr, V: tl.constexpr,
                                              W: tl.constexpr, WITH_GP: tl.constexpr,
                                              LD_IS_N: tl.constexpr):
    # program (pid, b): the deep K14's program pid of instance b, in place
    # (with WITH_GP gp.gp and gp.pg from the last pass and the . gp column
    # per group, as the deep K14's WITH_GP form); x, g and pg go over xp,
    # gp and pg_old on the last pass alone
    st = _stride(n, ld, LD_IS_N)
    pid = tl.program_id(0)
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    xp_ptr += row
    d_ptr += row
    gp_ptr += row
    pg_ptr += row
    S_ptr += (b.to(tl.int64) * st) * m
    Y_ptr += (b.to(tl.int64) * st) * m
    dt = xp_ptr.dtype.element_ty
    stp = tl.load(stp_ptr + b)
    c = tl.load(c_ptr)
    R: tl.constexpr = T // V
    a_xx = tl.zeros([R], dt)
    a_pp = tl.zeros([R], dt)
    a_ch = tl.zeros([R], dt)
    a_gg = tl.zeros([R], dt)
    a_gpg = tl.zeros([R], dt)
    prog = b.to(tl.int64) * tl.num_programs(0) + pid
    part = part_ptr + prog * (3 + 6 * m)
    gpart = gpart_ptr + prog * (2 + 2 * m)
    groups = tl.cdiv(m, G)
    for grp in range(groups):
        j0 = grp * G
        last = grp == groups - 1
        a0 = tl.zeros([R, G], dt)
        a1 = tl.zeros([R, G], dt)
        a2 = tl.zeros([R, G], dt)
        a3 = tl.zeros([R, G], dt)
        a4 = tl.zeros([R, G], dt)
        a5 = tl.zeros([R, G], dt)
        b0 = tl.zeros([R, G], dt)
        b1 = tl.zeros([R, G], dt)
        for t in range(tiles):
            offs = _tile(pid * tiles + t, T, V)
            mask = (offs < n) & live
            xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
            d = tl.load(d_ptr + offs, mask=mask, other=0.0)
            gp = tl.load(gp_ptr + offs, mask=mask, other=0.0)
            pgo = tl.load(pg_ptr + offs, mask=mask, other=0.0)
            exb = _view(_extras(ex, offs, mask), T // W, W)
            in_win = (offs >= lo) & (offs < hi)
            wp_sign = tl.where(xp == 0.0, _msign(-pgo), _msign(xp))
            x = _ow_point(xp, d, stp, wp_sign, in_win)
            _, g = body(tl.reshape(x, [T // W, W]), tl.reshape(offs, [T // W, W]), *exb)
            g = tl.reshape(g, [R, V])
            g = tl.where(mask, g, 0.0)
            pg = _pseudo_grad(g, x, c, in_win)
            if last:
                a_xx += _fold(x * x)
                a_pp += _fold(pg * pg)
                a_ch += _fold(tl.where(x != xp, 1.0, 0.0).to(dt))
                if WITH_GP:
                    a_gg += _fold(gp * gp)
                    a_gpg += _fold(gp * pg)
                tl.store(xp_ptr + offs, x, mask=mask)
                tl.store(gp_ptr + offs, g, mask=mask)
                tl.store(pg_ptr + offs, pg, mask=mask)
            s = x - xp
            y = g - gp
            d0 = -pg
            a0, a1, a2, a3, a4, a5, b0, b1 = _group_pass(S_ptr, Y_ptr, offs, mask, st, m, end,
                                                         j0, s, y, d0, gp, a0, a1, a2, a3, a4,
                                                         a5, b0, b1, G, WITH_GP)
        _store_gram_live(part + 3, live, j0, m, a0, a1, a2, a3, a4, a5, G)
        if WITH_GP:
            _store_gp_live(gpart + 2, live, j0, m, b0, b1, G)
    tl.store(part + 0, tl.sum(a_xx, axis=0), mask=live)
    tl.store(part + 1, tl.sum(a_pp, axis=0), mask=live)
    tl.store(part + 2, tl.sum(a_ch, axis=0), mask=live)
    if WITH_GP:
        tl.store(gpart + 0, tl.sum(a_gg, axis=0), mask=live)
        tl.store(gpart + 1, tl.sum(a_gpg, axis=0), mask=live)


@triton.jit
def _chunk(tile, K: tl.constexpr):
    # the offsets of chunk `tile` of K consecutive elements
    return tl.max_contiguous(tl.multiple_of(tile * K + tl.arange(0, K), K), K)


@triton.jit
def _split_operand(y, s, d0, gp):
    # the pair's vectors ([K] float32) as the products' [K, 16] bf16 operand:
    # column 4v + p holds part p of vector v (y, s, d0, gp), each split into
    # b1 = bf16(b), b2 = bf16(b - b1), b3 = bf16(b - b1 - b2), which carry
    # float32's 24 bits (each difference is exact); column 4v + 3 is zero.
    # A non-finite b gives b - b1 = NaN, so its products stay non-finite.
    # tl.join(a, b) stacks on a new last axis: the [K, 2, 2] below is (y,
    # s, d0, gp) in row-major order, and the [K, 4, 2, 2] (b1, b2, b3, 0)
    K: tl.constexpr = y.shape[0]
    b = tl.reshape(tl.join(tl.join(y, d0), tl.join(s, gp)), [K, 4])
    b1 = b.to(tl.bfloat16)
    r1 = b - b1.to(tl.float32)
    b2 = r1.to(tl.bfloat16)
    b3 = (r1 - b2.to(tl.float32)).to(tl.bfloat16)
    return tl.reshape(tl.join(tl.join(b1, b3), tl.join(b2, tl.zeros_like(b1))), [K, 16])


@triton.jit
def _operand(y, s, d0, gp):
    # the pair's vectors as the products' operand: float32 vectors in three
    # bf16 parts each ([K, 16], ``_split_operand``); float64 vectors as they
    # are ([K, 8]: the FP64 MMA's n8 shape), vector v (y, s, d0, gp) in
    # column 2v and the odd columns zero
    if y.dtype == tl.float64:
        K: tl.constexpr = y.shape[0]
        b = tl.reshape(tl.join(tl.join(y, d0), tl.join(s, gp)), [K, 4])
        return tl.reshape(tl.join(b, tl.zeros_like(b)), [K, 8])
    else:
        return _split_operand(y, s, d0, gp)


@triton.jit
def _ring_dot(R, op, acc):
    # one ring's [RP, K] tile R times the operand, added to acc by adds of
    # acc's dtype (``_ring_chunk``'s CARRY_RN).  A bf16 tile is exact as a
    # bf16 operand and a float64 tile goes to a float64 dot as it is; a
    # float32 tile is split into three bf16 parts as the vectors are (each
    # difference exact, b1 + b2 + b3 == R for a finite R), the nine products
    # of the parts exact in the MMA and summed there over the chunk, the
    # smallest parts first.  The zero is acc times 0, not a constant: the
    # compiler folds an add of a dot from a constant zero back into the
    # MMA's accumulator
    if R.dtype == tl.float32:
        R1 = R.to(tl.bfloat16)
        r1 = R - R1.to(tl.float32)
        R2 = r1.to(tl.bfloat16)
        R3 = (r1 - R2.to(tl.float32)).to(tl.bfloat16)
        c = tl.dot(R3, op, acc * 0.0)
        c = tl.dot(R2, op, c)
        return acc + tl.dot(R1, op, c)
    elif R.dtype == tl.float64:
        return acc + tl.dot(R, op, acc * 0.0, out_dtype=tl.float64)
    else:
        return acc + tl.dot(R, op, acc * 0.0)


@triton.jit
def _column(acc, v: tl.constexpr):
    # the [RP] products of the ring rows with vector v: its three parts'
    # sums, each picked out of acc ([RP, 16]) exactly, added as (p1 + p2)
    # + p3; with float64 vectors column 2v of acc ([RP, 8]) alone
    if acc.dtype == tl.float64:
        col8 = tl.arange(0, 8)[None, :]
        return tl.sum(tl.where(col8 == 2 * v, acc, 0.0), axis=1)
    else:
        col = tl.arange(0, 16)[None, :]
        p1 = tl.sum(tl.where(col == 4 * v, acc, 0.0), axis=1)
        p2 = tl.sum(tl.where(col == 4 * v + 1, acc, 0.0), axis=1)
        p3 = tl.sum(tl.where(col == 4 * v + 2, acc, 0.0), axis=1)
        return (p1 + p2) + p3


@triton.jit
def _ring_chunk(S_ptr, Y_ptr, offs, mask, live, st, m, end, j0, holds_end, s, y, d0, gp, acc_s,
                acc_y, RP: tl.constexpr, CARRY_RN: tl.constexpr, LD_IS_N: tl.constexpr):
    # one chunk's pass over ring rows j0 .. j0 + RP - 1: the old rows (j <
    # m, j != end) as the first operand ([RP, K], in the ring's dtype:
    # ``_ring_dot``), row `end` masked to zero (its products are the folds
    # of the unrounded pair), the vectors as the second (``_operand``),
    # summed into acc_s and acc_y ([RP, 16] float32 for float32 vectors,
    # [RP, 8] float64 for float64) by the tensor cores; then, where the rows
    # hold `end` (``holds_end``), the new pair stored into row `end`,
    # rounded to the ring's dtype.  The MMA's own accumulation does not
    # round to nearest: carried through it across chunks, the products drift
    # from the float64 product about linearly in the chunk count.  With
    # CARRY_RN each chunk's products start from zero and are added to the
    # running sums by adds of the sums' dtype, which round to nearest.
    # Ring row j starts at j*st (``_stride``).  Over a padded ring (LD_IS_N
    # off) the tile is masked by the ring's columns, offs < st, not by the
    # vectors' offs < n: st is a multiple of 16, so the mask is constant
    # over each run of 16 elements and the tile loads in vectors at any n;
    # a frozen instance (``live`` off) is masked by its rows.  The pad
    # columns past n are zero, and so are the vectors there (loaded as 0
    # off ``mask``), so they add nothing, and the new row stored over them
    # is zeros (s and y are 0 there)
    op = _operand(y, s, d0, gp)
    rows = j0 + tl.arange(0, RP)
    if LD_IS_N:
        rmask = ((rows < m) & (rows != end))[:, None] & mask[None, :]
    else:
        rmask = ((rows < m) & (rows != end) & live)[:, None] & (offs < st)[None, :]
    roffs = rows.to(tl.int64)[:, None] * st + offs[None, :]
    if CARRY_RN:
        acc_s = _ring_dot(tl.load(S_ptr + roffs, mask=rmask, other=0.0), op, acc_s)
        acc_y = _ring_dot(tl.load(Y_ptr + roffs, mask=rmask, other=0.0), op, acc_y)
    else:
        acc_s = tl.dot(tl.load(S_ptr + roffs, mask=rmask, other=0.0), op, acc_s)
        acc_y = tl.dot(tl.load(Y_ptr + roffs, mask=rmask, other=0.0), op, acc_y)
    row = end.to(tl.int64) * st
    if LD_IS_N:
        keep = mask & holds_end
    else:
        keep = (offs < st) & (holds_end & live)
    tl.store(S_ptr + row + offs, s.to(S_ptr.dtype.element_ty), mask=keep)
    tl.store(Y_ptr + row + offs, y.to(Y_ptr.dtype.element_ty), mask=keep)
    return acc_s, acc_y


@triton.jit
def _store_gram_mma(part, gpart, live, j0, m, end, with_gp, acc_s, acc_y, e_sy, e_ss, e_sd,
                    e_sg, e_yy, e_yd, e_yg, RP: tl.constexpr):
    # the program's partials of the products of ring rows j0 .. j0 + RP - 1
    # (row j at part + 6j, in ``_store_gram``'s order) and with with_gp the
    # . gp column's (S_j.gp, Y_j.gp at gpart + 2j): each row's from the
    # tensor cores, row `end`'s from the folds of the unrounded pair;
    # nothing for a frozen instance
    r = j0 + tl.arange(0, RP)
    keep = (r < m) & live
    at_end = r == end
    sy = tl.sum(e_sy, axis=0)
    pj = part + 6 * r
    tl.store(pj + 0, tl.where(at_end, sy, _column(acc_s, 0)), mask=keep)
    tl.store(pj + 1, tl.where(at_end, tl.sum(e_ss, axis=0), _column(acc_s, 1)), mask=keep)
    tl.store(pj + 2, tl.where(at_end, tl.sum(e_sd, axis=0), _column(acc_s, 2)), mask=keep)
    tl.store(pj + 3, tl.where(at_end, tl.sum(e_yy, axis=0), _column(acc_y, 0)), mask=keep)
    tl.store(pj + 4, tl.where(at_end, sy, _column(acc_y, 1)), mask=keep)
    tl.store(pj + 5, tl.where(at_end, tl.sum(e_yd, axis=0), _column(acc_y, 2)), mask=keep)
    keep = keep & (with_gp != 0)
    tl.store(gpart + 2 * r, tl.where(at_end, tl.sum(e_sg, axis=0), _column(acc_s, 3)),
             mask=keep)
    tl.store(gpart + 2 * r + 1, tl.where(at_end, tl.sum(e_yg, axis=0), _column(acc_y, 3)),
             mask=keep)


@triton.jit
def _k4_chunk(xp_ptr, d_ptr, gp_ptr, x_ptr, g_ptr, S_ptr, Y_ptr, offs, gidx, mask, live, st, m,
              end, j0, last, holds_end, stp, ex, a_gd, a_gg, a_xx, a_ch, e_sy, e_ss, e_sd, e_sg,
              e_yy, e_yd, e_yg, acc_s, acc_y, body: tl.constexpr, RP: tl.constexpr,
              K: tl.constexpr, W: tl.constexpr, CARRY_RN: tl.constexpr, LD_IS_N: tl.constexpr):
    # one chunk of K4's tensor-core forms (the solo kernels and K4 b's): the
    # point, the body (at the indices gidx) and the pair as K4 forms them,
    # the scalar sums and row end's products folded into per-element sums
    # of the sums' dtype, the products of ring rows j0 .. j0 + RP - 1 with
    # the vectors into acc_s and acc_y (``_ring_chunk``; the new pair stored
    # where ``holds_end``), x and g stored where ``last`` (the one pass
    # over the rows, or the last of several).  x_ptr and g_ptr may be
    # xp_ptr and gp_ptr: each element is loaded before it is stored, no
    # element reads another's, and no pass follows the one that stores.
    # Returns the body's objective terms ([K], zero off the mask) and the
    # sums
    xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + offs, mask=mask, other=0.0)
    gp = tl.load(gp_ptr + offs, mask=mask, other=0.0)
    exb = _view(_extras(ex, offs, mask), K // W, W)
    x = xp + stp * d
    fe, g = body(tl.reshape(x, [K // W, W]), tl.reshape(gidx, [K // W, W]), *exb)
    g = tl.where(mask, tl.reshape(g, [K]), 0.0)
    s = stp * d
    y = g - gp
    d0 = -g
    a_gd += g * d
    a_gg += g * g
    a_xx += x * x
    a_ch += tl.where(x != xp, 1.0, 0.0)
    e_sy += s * y
    e_ss += s * s
    e_sd += s * d0
    e_sg += s * gp
    e_yy += y * y
    e_yd += y * d0
    e_yg += y * gp
    acc_s, acc_y = _ring_chunk(S_ptr, Y_ptr, offs, mask, live, st, m, end, j0, holds_end, s, y,
                               d0, gp, acc_s, acc_y, RP, CARRY_RN, LD_IS_N)
    tl.store(x_ptr + offs, x, mask=mask & last)
    tl.store(g_ptr + offs, g, mask=mask & last)
    fe = tl.where(mask, tl.reshape(fe, [K]), 0.0)
    return fe, a_gd, a_gg, a_xx, a_ch, e_sy, e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, acc_s, acc_y


@triton.jit
def _k14_chunk(xp_ptr, d_ptr, gp_ptr, pg_ptr, x_ptr, g_ptr, pgn_ptr, S_ptr, Y_ptr, offs, gidx,
               mask, live, st, m, lo, hi, end, j0, last, holds_end, stp, c, ex, a_xx, a_pp, a_ch,
               a_gg, a_gpg, e_sy, e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, acc_s, acc_y,
               body: tl.constexpr, RP: tl.constexpr, K: tl.constexpr, W: tl.constexpr,
               CARRY_RN: tl.constexpr, LD_IS_N: tl.constexpr):
    # one chunk of K14's tensor-core forms, as ``_k4_chunk``: the projected
    # point with the orthant from (xp, pg_old) (the window [lo, hi) in the
    # kernel's own indices offs), its gradient and pseudo-gradient, the
    # pair (x - xp, g - gp) and d0 = -pg; gp.gp and gp.pg summed in every
    # launch; x, g and pg stored where ``last`` (they may alias xp, gp and
    # pg_old)
    xp = tl.load(xp_ptr + offs, mask=mask, other=0.0)
    d = tl.load(d_ptr + offs, mask=mask, other=0.0)
    gp = tl.load(gp_ptr + offs, mask=mask, other=0.0)
    pgo = tl.load(pg_ptr + offs, mask=mask, other=0.0)
    exb = _view(_extras(ex, offs, mask), K // W, W)
    in_win = (offs >= lo) & (offs < hi)
    wp_sign = tl.where(xp == 0.0, _msign(-pgo), _msign(xp))
    x = _ow_point(xp, d, stp, wp_sign, in_win)
    _, g = body(tl.reshape(x, [K // W, W]), tl.reshape(gidx, [K // W, W]), *exb)
    g = tl.where(mask, tl.reshape(g, [K]), 0.0)
    pg = _pseudo_grad(g, x, c, in_win)
    s = x - xp
    y = g - gp
    d0 = -pg
    a_xx += x * x
    a_pp += pg * pg
    a_ch += tl.where(x != xp, 1.0, 0.0)
    a_gg += gp * gp
    a_gpg += gp * pg
    e_sy += s * y
    e_ss += s * s
    e_sd += s * d0
    e_sg += s * gp
    e_yy += y * y
    e_yd += y * d0
    e_yg += y * gp
    acc_s, acc_y = _ring_chunk(S_ptr, Y_ptr, offs, mask, live, st, m, end, j0, holds_end, s, y,
                               d0, gp, acc_s, acc_y, RP, CARRY_RN, LD_IS_N)
    tl.store(x_ptr + offs, x, mask=mask & last)
    tl.store(g_ptr + offs, g, mask=mask & last)
    tl.store(pgn_ptr + offs, pg, mask=mask & last)
    return a_xx, a_pp, a_ch, a_gg, a_gpg, e_sy, e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, acc_s, acc_y


@triton.jit(do_not_specialize=["m", "end", "tiles", "with_gp"])
def trial_pair_gram_mma_batched_kernel(xp_ptr, d_ptr, gp_ptr, stp_ptr, live_ptr, S_ptr, Y_ptr,
                                       part_ptr, gpart_ptr, n, end, tiles, with_gp, ex, m, ld,
                                       body: tl.constexpr, RP: tl.constexpr, K: tl.constexpr,
                                       W: tl.constexpr, LD_IS_N: tl.constexpr):
    # K4 b with the Gram products on the tensor cores (f32 vectors, a bf16
    # ring of at most RP rows): program (pid, b) takes chunks pid*tiles ..
    # pid*tiles + tiles - 1 of K elements of instance b, in place.  Per
    # chunk the point, the body and the pair as K4 b forms them, the
    # scalar sums and row end's products folded into per-element float32
    # sums, and the ring rows' products with the split vectors by
    # ``tl.dot``, each chunk's added to the program's sums by float32 adds
    # (``CARRY_RN``).  The . gp column rides in the
    # same operand: the . gp launch and the 3-column one run this one
    # binary, and with_gp (a run-time flag) only stores the column
    st = _stride(n, ld, LD_IS_N)
    pid = tl.program_id(0)
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    xp_ptr += row
    d_ptr += row
    gp_ptr += row
    S_ptr += (b.to(tl.int64) * st) * m
    Y_ptr += (b.to(tl.int64) * st) * m
    stp = tl.load(stp_ptr + b)
    a_gd = tl.zeros([K], tl.float32)
    a_gg = tl.zeros([K], tl.float32)
    a_xx = tl.zeros([K], tl.float32)
    a_ch = tl.zeros([K], tl.float32)
    e_sy = tl.zeros([K], tl.float32)
    e_ss = tl.zeros([K], tl.float32)
    e_sd = tl.zeros([K], tl.float32)
    e_sg = tl.zeros([K], tl.float32)
    e_yy = tl.zeros([K], tl.float32)
    e_yd = tl.zeros([K], tl.float32)
    e_yg = tl.zeros([K], tl.float32)
    acc_s = tl.zeros([RP, 16], tl.float32)
    acc_y = tl.zeros([RP, 16], tl.float32)
    for t in range(tiles):
        offs = _chunk(pid * tiles + t, K)
        _, a_gd, a_gg, a_xx, a_ch, e_sy, e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, acc_s, acc_y = \
            _k4_chunk(xp_ptr, d_ptr, gp_ptr, xp_ptr, gp_ptr, S_ptr, Y_ptr, offs, offs,
                      (offs < n) & live, live, st, m, end, 0, True, True, stp, ex,
                      a_gd, a_gg, a_xx, a_ch, e_sy, e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, acc_s,
                      acc_y, body, RP, K, W, True, LD_IS_N)
    prog = b.to(tl.int64) * tl.num_programs(0) + pid
    part = part_ptr + prog * (4 + 6 * m)
    tl.store(part + 0, tl.sum(a_gd, axis=0), mask=live)
    tl.store(part + 1, tl.sum(a_gg, axis=0), mask=live)
    tl.store(part + 2, tl.sum(a_xx, axis=0), mask=live)
    tl.store(part + 3, tl.sum(a_ch, axis=0), mask=live)
    _store_gram_mma(part + 4, gpart_ptr + prog * (2 * m), live, 0, m, end, with_gp, acc_s, acc_y,
                    e_sy, e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, RP)


@triton.jit(do_not_specialize=["m", "end", "lo", "hi", "tiles", "with_gp"])
def owlqn_trial_pair_gram_mma_batched_kernel(xp_ptr, d_ptr, gp_ptr, pg_ptr, stp_ptr, c_ptr,
                                             live_ptr, S_ptr, Y_ptr, part_ptr, gpart_ptr, n, lo, hi,
                                             end, tiles, with_gp, ex, m, ld, body: tl.constexpr,
                                             RP: tl.constexpr, K: tl.constexpr, W: tl.constexpr,
                                             LD_IS_N: tl.constexpr):
    # K14 b laid out as ``trial_pair_gram_mma_batched_kernel``, in place (x,
    # g and pg over xp, gp and pg_old): the projected point with the
    # orthant from (xp, pg_old), its gradient and pseudo-gradient, the pair
    # (x - xp, g - gp) and d0 = -pg; gp.gp and gp.pg are summed in both
    # launches and stored with with_gp
    st = _stride(n, ld, LD_IS_N)
    pid = tl.program_id(0)
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    xp_ptr += row
    d_ptr += row
    gp_ptr += row
    pg_ptr += row
    S_ptr += (b.to(tl.int64) * st) * m
    Y_ptr += (b.to(tl.int64) * st) * m
    stp = tl.load(stp_ptr + b)
    c = tl.load(c_ptr)
    a_xx = tl.zeros([K], tl.float32)
    a_pp = tl.zeros([K], tl.float32)
    a_ch = tl.zeros([K], tl.float32)
    a_gg = tl.zeros([K], tl.float32)
    a_gpg = tl.zeros([K], tl.float32)
    e_sy = tl.zeros([K], tl.float32)
    e_ss = tl.zeros([K], tl.float32)
    e_sd = tl.zeros([K], tl.float32)
    e_sg = tl.zeros([K], tl.float32)
    e_yy = tl.zeros([K], tl.float32)
    e_yd = tl.zeros([K], tl.float32)
    e_yg = tl.zeros([K], tl.float32)
    acc_s = tl.zeros([RP, 16], tl.float32)
    acc_y = tl.zeros([RP, 16], tl.float32)
    for t in range(tiles):
        offs = _chunk(pid * tiles + t, K)
        (a_xx, a_pp, a_ch, a_gg, a_gpg, e_sy, e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, acc_s,
         acc_y) = _k14_chunk(xp_ptr, d_ptr, gp_ptr, pg_ptr, xp_ptr, gp_ptr, pg_ptr, S_ptr, Y_ptr,
                             offs, offs, (offs < n) & live, live, st, m, lo, hi,
                             end, 0, True, True, stp, c, ex, a_xx, a_pp, a_ch, a_gg, a_gpg, e_sy,
                             e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, acc_s, acc_y, body, RP, K, W,
                             True, LD_IS_N)
    prog = b.to(tl.int64) * tl.num_programs(0) + pid
    part = part_ptr + prog * (3 + 6 * m)
    tl.store(part + 0, tl.sum(a_xx, axis=0), mask=live)
    tl.store(part + 1, tl.sum(a_pp, axis=0), mask=live)
    tl.store(part + 2, tl.sum(a_ch, axis=0), mask=live)
    gpart = gpart_ptr + prog * (2 + 2 * m)
    tl.store(gpart + 0, tl.sum(a_gg, axis=0), mask=live & (with_gp != 0))
    tl.store(gpart + 1, tl.sum(a_gpg, axis=0), mask=live & (with_gp != 0))
    _store_gram_mma(part + 3, gpart + 2, live, 0, m, end, with_gp, acc_s, acc_y, e_sy, e_ss, e_sd,
                    e_sg, e_yy, e_yd, e_yg, RP)


@triton.jit(do_not_specialize=["m", "end", "tiles", "with_gp"])
def trial_pair_gram_mma_kernel(xp_ptr, d_ptr, gp_ptr, stp_ptr, x_ptr, g_ptr, S_ptr, Y_ptr, fx_ptr,
                               part_ptr, gpart_ptr, n, end, tiles, with_gp, off, ex, m, ld,
                               body: tl.constexpr, RP: tl.constexpr, K: tl.constexpr,
                               W: tl.constexpr, SHARD: tl.constexpr, LD_IS_N: tl.constexpr):
    # the solo K4 with the Gram products on the tensor cores (f32 vectors,
    # a bf16 ring of at most RP rows): program pid takes chunks pid*tiles ..
    # pid*tiles + tiles - 1 of K elements (``factory.solo_epilogue_grid``),
    # each through K4 b's chunk body (``_k4_chunk``), the body at the
    # global indices (``_gidx``: a shard's offset with SHARD), and writes
    # the objective's partial per chunk; x and g may alias xp and gp.  The
    # . gp column rides in the operand, so the . gp launch and the 3-column
    # one run this one binary and with_gp only stores the column
    st = _stride(n, ld, LD_IS_N)
    pid = tl.program_id(0)
    stp = tl.load(stp_ptr)
    a_gd = tl.zeros([K], tl.float32)
    a_gg = tl.zeros([K], tl.float32)
    a_xx = tl.zeros([K], tl.float32)
    a_ch = tl.zeros([K], tl.float32)
    e_sy = tl.zeros([K], tl.float32)
    e_ss = tl.zeros([K], tl.float32)
    e_sd = tl.zeros([K], tl.float32)
    e_sg = tl.zeros([K], tl.float32)
    e_yy = tl.zeros([K], tl.float32)
    e_yd = tl.zeros([K], tl.float32)
    e_yg = tl.zeros([K], tl.float32)
    acc_s = tl.zeros([RP, 16], tl.float32)
    acc_y = tl.zeros([RP, 16], tl.float32)
    for t in range(tiles):
        chunk = pid * tiles + t
        offs = _chunk(chunk, K)
        fe, a_gd, a_gg, a_xx, a_ch, e_sy, e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, acc_s, acc_y = \
            _k4_chunk(xp_ptr, d_ptr, gp_ptr, x_ptr, g_ptr, S_ptr, Y_ptr, offs,
                      _gidx(offs, off, SHARD), offs < n, True, st, m, end, 0, True, True,
                      stp, ex,
                      a_gd, a_gg, a_xx, a_ch, e_sy, e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, acc_s,
                      acc_y, body, RP, K, W, True, LD_IS_N)
        tl.store(fx_ptr + chunk, tl.sum(fe, axis=0))
    part = part_ptr + pid * (4 + 6 * m)
    tl.store(part + 0, tl.sum(a_gd, axis=0))
    tl.store(part + 1, tl.sum(a_gg, axis=0))
    tl.store(part + 2, tl.sum(a_xx, axis=0))
    tl.store(part + 3, tl.sum(a_ch, axis=0))
    _store_gram_mma(part + 4, gpart_ptr + pid * (2 * m), True, 0, m, end, with_gp, acc_s, acc_y,
                    e_sy, e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, RP)


@triton.jit(do_not_specialize=["m", "end", "lo", "hi", "tiles", "with_gp"])
def owlqn_trial_pair_gram_mma_kernel(xp_ptr, d_ptr, gp_ptr, pg_ptr, stp_ptr, c_ptr, x_ptr, g_ptr,
                                     pgn_ptr, S_ptr, Y_ptr, part_ptr, gpart_ptr, n, lo, hi, end,
                                     tiles, with_gp, off, ex, m, ld, body: tl.constexpr,
                                     RP: tl.constexpr, K: tl.constexpr, W: tl.constexpr,
                                     SHARD: tl.constexpr, LD_IS_N: tl.constexpr):
    # the solo K14 laid out as ``trial_pair_gram_mma_kernel``, through K14
    # b's chunk body (``_k14_chunk``): x, g and pg may alias xp, gp and
    # pg_old; the window [lo, hi) in the shard's own indices (the wrapper
    # translates it), the body at the global ones; gp.gp and gp.pg summed in
    # both launches and stored with with_gp
    st = _stride(n, ld, LD_IS_N)
    pid = tl.program_id(0)
    stp = tl.load(stp_ptr)
    c = tl.load(c_ptr)
    a_xx = tl.zeros([K], tl.float32)
    a_pp = tl.zeros([K], tl.float32)
    a_ch = tl.zeros([K], tl.float32)
    a_gg = tl.zeros([K], tl.float32)
    a_gpg = tl.zeros([K], tl.float32)
    e_sy = tl.zeros([K], tl.float32)
    e_ss = tl.zeros([K], tl.float32)
    e_sd = tl.zeros([K], tl.float32)
    e_sg = tl.zeros([K], tl.float32)
    e_yy = tl.zeros([K], tl.float32)
    e_yd = tl.zeros([K], tl.float32)
    e_yg = tl.zeros([K], tl.float32)
    acc_s = tl.zeros([RP, 16], tl.float32)
    acc_y = tl.zeros([RP, 16], tl.float32)
    for t in range(tiles):
        offs = _chunk(pid * tiles + t, K)
        (a_xx, a_pp, a_ch, a_gg, a_gpg, e_sy, e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, acc_s,
         acc_y) = _k14_chunk(xp_ptr, d_ptr, gp_ptr, pg_ptr, x_ptr, g_ptr, pgn_ptr, S_ptr, Y_ptr,
                             offs, _gidx(offs, off, SHARD), offs < n, True, st, m, lo, hi,
                             end, 0, True, True, stp, c, ex, a_xx, a_pp, a_ch, a_gg, a_gpg, e_sy,
                             e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, acc_s, acc_y, body, RP, K, W,
                             True, LD_IS_N)
    part = part_ptr + pid * (3 + 6 * m)
    tl.store(part + 0, tl.sum(a_xx, axis=0))
    tl.store(part + 1, tl.sum(a_pp, axis=0))
    tl.store(part + 2, tl.sum(a_ch, axis=0))
    gpart = gpart_ptr + pid * (2 + 2 * m)
    tl.store(gpart + 0, tl.sum(a_gg, axis=0), mask=with_gp != 0)
    tl.store(gpart + 1, tl.sum(a_gpg, axis=0), mask=with_gp != 0)
    _store_gram_mma(part + 3, gpart + 2, True, 0, m, end, with_gp, acc_s, acc_y, e_sy, e_ss, e_sd,
                    e_sg, e_yy, e_yd, e_yg, RP)


@triton.jit
def _k4_rows_pass(xp_ptr, d_ptr, gp_ptr, x_ptr, g_ptr, S_ptr, Y_ptr, fx_ptr, part, gpart, live, n,
                  st, m, end, j0, stp, pid, tiles, with_gp, off, ex, body: tl.constexpr,
                  RP: tl.constexpr, K: tl.constexpr, W: tl.constexpr, SHARD: tl.constexpr,
                  LAST: tl.constexpr, FX: tl.constexpr, LD_IS_N: tl.constexpr):
    # one pass of the row-block K4 over the program's chunks with ring rows
    # j0 .. j0 + RP - 1 as the dot's operand: their products stored, and on
    # the LAST pass the point (x, g) and, with FX, the objective's partial
    # per chunk; the scalar sums returned (the last pass's are stored).
    # ``live`` masks every load and store of a frozen instance (the solo
    # kernels pass True, the batched one the instance's flag)
    dt = xp_ptr.dtype.element_ty
    holds_end = (end >= j0) & (end < j0 + RP)
    a_gd = tl.zeros([K], dt)
    a_gg = tl.zeros([K], dt)
    a_xx = tl.zeros([K], dt)
    a_ch = tl.zeros([K], dt)
    e_sy = tl.zeros([K], dt)
    e_ss = tl.zeros([K], dt)
    e_sd = tl.zeros([K], dt)
    e_sg = tl.zeros([K], dt)
    e_yy = tl.zeros([K], dt)
    e_yd = tl.zeros([K], dt)
    e_yg = tl.zeros([K], dt)
    # the running products: [RP, 16] float32 (three parts of four vectors)
    # with float32 vectors, [RP, 8] float64 with float64 ones (``_operand``)
    if dt == tl.float64:
        acc_s = tl.zeros([RP, 8], dt)
        acc_y = tl.zeros([RP, 8], dt)
    else:
        acc_s = tl.zeros([RP, 16], dt)
        acc_y = tl.zeros([RP, 16], dt)
    for t in range(tiles):
        chunk = pid * tiles + t
        offs = _chunk(chunk, K)
        fe, a_gd, a_gg, a_xx, a_ch, e_sy, e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, acc_s, acc_y = \
            _k4_chunk(xp_ptr, d_ptr, gp_ptr, x_ptr, g_ptr, S_ptr, Y_ptr, offs,
                      _gidx(offs, off, SHARD), (offs < n) & live, live, st, m, end, j0, LAST,
                      holds_end, stp, ex, a_gd, a_gg, a_xx, a_ch, e_sy, e_ss, e_sd, e_sg, e_yy,
                      e_yd, e_yg, acc_s, acc_y, body, RP, K, W, True, LD_IS_N)
        if LAST:
            if FX:
                tl.store(fx_ptr + chunk, tl.sum(fe, axis=0))
    _store_gram_mma(part + 4, gpart, live, j0, m, end, with_gp, acc_s, acc_y, e_sy, e_ss, e_sd,
                    e_sg, e_yy, e_yd, e_yg, RP)
    return a_gd, a_gg, a_xx, a_ch


@triton.jit(do_not_specialize=["m", "end", "tiles", "with_gp"])
def trial_pair_gram_mma_rows_kernel(xp_ptr, d_ptr, gp_ptr, stp_ptr, x_ptr, g_ptr, S_ptr, Y_ptr,
                                    fx_ptr, part_ptr, gpart_ptr, n, end, tiles, with_gp, off, ex, m,
                                    ld, body: tl.constexpr, RP: tl.constexpr, RT: tl.constexpr,
                                    K: tl.constexpr, W: tl.constexpr, SHARD: tl.constexpr,
                                    LD_IS_N: tl.constexpr):
    # the solo K4 with the Gram products on the tensor cores over any
    # dtype pair and any depth (``factory.solo_epilogue_grid``'s
    # "mma_rows" form): program pid takes the tensor-core form's chunks
    # and passes over them once per block of ring rows, RP rows a block and
    # RT in the last (one pass up to RP rows), each chunk through
    # ``_k4_chunk`` with the block's rows as the dot's operand: f32 vectors
    # over a bf16 ring (above the one-pass form's 256 rows), over an f32
    # ring (its rows in three bf16 parts) and f64 vectors over an f64 ring
    # (float64 dots), the sums in the vectors' dtype.  The point's outputs,
    # the objective's partials and the scalar sums come from the last pass,
    # so x and g may alias xp and gp (every earlier pass has read the
    # program's chunks before the last one stores over them, and no other
    # program reads them); the block that holds row `end` stores the new
    # pair there.  The . gp column rides in the operand: one binary for
    # both launches, with_gp only stores it
    st = _stride(n, ld, LD_IS_N)
    pid = tl.program_id(0)
    stp = tl.load(stp_ptr)
    part = part_ptr + pid * (4 + 6 * m)
    gpart = gpart_ptr + pid * (2 * m)
    for p in range(tl.cdiv(m - RT, RP)):
        _k4_rows_pass(xp_ptr, d_ptr, gp_ptr, x_ptr, g_ptr, S_ptr, Y_ptr, fx_ptr, part, gpart,
                      True, n, st, m, end, p * RP, stp, pid, tiles, with_gp, off, ex, body, RP,
                      K, W, SHARD, False, True, LD_IS_N)
    a_gd, a_gg, a_xx, a_ch = _k4_rows_pass(
        xp_ptr, d_ptr, gp_ptr, x_ptr, g_ptr, S_ptr, Y_ptr, fx_ptr, part, gpart, True, n, st, m,
        end, tl.cdiv(m - RT, RP) * RP, stp, pid, tiles, with_gp, off, ex, body, RT, K, W, SHARD,
        True, True, LD_IS_N)
    tl.store(part + 0, tl.sum(a_gd, axis=0))
    tl.store(part + 1, tl.sum(a_gg, axis=0))
    tl.store(part + 2, tl.sum(a_xx, axis=0))
    tl.store(part + 3, tl.sum(a_ch, axis=0))


@triton.jit
def _k14_rows_pass(xp_ptr, d_ptr, gp_ptr, pg_ptr, x_ptr, g_ptr, pgn_ptr, S_ptr, Y_ptr, part,
                   gpart, live, n, st, m, lo, hi, end, j0, stp, c, pid, tiles, with_gp, off, ex,
                   body: tl.constexpr, RP: tl.constexpr, K: tl.constexpr, W: tl.constexpr,
                   SHARD: tl.constexpr, LAST: tl.constexpr, LD_IS_N: tl.constexpr):
    # ``_k4_rows_pass`` for K14: x, g and pg stored on the LAST pass
    dt = xp_ptr.dtype.element_ty
    holds_end = (end >= j0) & (end < j0 + RP)
    a_xx = tl.zeros([K], dt)
    a_pp = tl.zeros([K], dt)
    a_ch = tl.zeros([K], dt)
    a_gg = tl.zeros([K], dt)
    a_gpg = tl.zeros([K], dt)
    e_sy = tl.zeros([K], dt)
    e_ss = tl.zeros([K], dt)
    e_sd = tl.zeros([K], dt)
    e_sg = tl.zeros([K], dt)
    e_yy = tl.zeros([K], dt)
    e_yd = tl.zeros([K], dt)
    e_yg = tl.zeros([K], dt)
    # the running products: [RP, 16] float32 (three parts of four vectors)
    # with float32 vectors, [RP, 8] float64 with float64 ones (``_operand``)
    if dt == tl.float64:
        acc_s = tl.zeros([RP, 8], dt)
        acc_y = tl.zeros([RP, 8], dt)
    else:
        acc_s = tl.zeros([RP, 16], dt)
        acc_y = tl.zeros([RP, 16], dt)
    for t in range(tiles):
        offs = _chunk(pid * tiles + t, K)
        (a_xx, a_pp, a_ch, a_gg, a_gpg, e_sy, e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, acc_s,
         acc_y) = _k14_chunk(xp_ptr, d_ptr, gp_ptr, pg_ptr, x_ptr, g_ptr, pgn_ptr, S_ptr, Y_ptr,
                             offs, _gidx(offs, off, SHARD), (offs < n) & live, live, st, m, lo,
                             hi, end, j0, LAST, holds_end, stp, c, ex, a_xx, a_pp, a_ch, a_gg,
                             a_gpg, e_sy, e_ss, e_sd, e_sg, e_yy, e_yd, e_yg, acc_s, acc_y, body,
                             RP, K, W, True, LD_IS_N)
    _store_gram_mma(part + 3, gpart + 2, live, j0, m, end, with_gp, acc_s, acc_y, e_sy, e_ss,
                    e_sd, e_sg, e_yy, e_yd, e_yg, RP)
    return a_xx, a_pp, a_ch, a_gg, a_gpg


@triton.jit(do_not_specialize=["m", "end", "lo", "hi", "tiles", "with_gp"])
def owlqn_trial_pair_gram_mma_rows_kernel(xp_ptr, d_ptr, gp_ptr, pg_ptr, stp_ptr, c_ptr, x_ptr,
                                          g_ptr, pgn_ptr, S_ptr, Y_ptr, part_ptr, gpart_ptr, n, lo,
                                          hi, end, tiles, with_gp, off, ex, m, ld,
                                          body: tl.constexpr, RP: tl.constexpr, RT: tl.constexpr,
                                          K: tl.constexpr, W: tl.constexpr, SHARD: tl.constexpr,
                                          LD_IS_N: tl.constexpr):
    # the solo K14 laid out as ``trial_pair_gram_mma_rows_kernel``, through
    # ``_k14_chunk``: x, g and pg (which may alias xp, gp and pg_old)
    # stored by the last pass; gp.gp and gp.pg summed in both launches and
    # stored with with_gp
    st = _stride(n, ld, LD_IS_N)
    pid = tl.program_id(0)
    stp = tl.load(stp_ptr)
    c = tl.load(c_ptr)
    part = part_ptr + pid * (3 + 6 * m)
    gpart = gpart_ptr + pid * (2 + 2 * m)
    for p in range(tl.cdiv(m - RT, RP)):
        _k14_rows_pass(xp_ptr, d_ptr, gp_ptr, pg_ptr, x_ptr, g_ptr, pgn_ptr, S_ptr, Y_ptr, part,
                       gpart, True, n, st, m, lo, hi, end, p * RP, stp, c, pid, tiles, with_gp,
                       off, ex, body, RP, K, W, SHARD, False, LD_IS_N)
    a_xx, a_pp, a_ch, a_gg, a_gpg = _k14_rows_pass(
        xp_ptr, d_ptr, gp_ptr, pg_ptr, x_ptr, g_ptr, pgn_ptr, S_ptr, Y_ptr, part, gpart, True, n,
        st, m, lo, hi, end, tl.cdiv(m - RT, RP) * RP, stp, c, pid, tiles, with_gp, off, ex, body,
        RT, K, W, SHARD, True, LD_IS_N)
    tl.store(part + 0, tl.sum(a_xx, axis=0))
    tl.store(part + 1, tl.sum(a_pp, axis=0))
    tl.store(part + 2, tl.sum(a_ch, axis=0))
    tl.store(gpart + 0, tl.sum(a_gg, axis=0), mask=with_gp != 0)
    tl.store(gpart + 1, tl.sum(a_gpg, axis=0), mask=with_gp != 0)


@triton.jit(do_not_specialize=["m", "end", "tiles", "with_gp"])
def trial_pair_gram_mma_rows_batched_kernel(xp_ptr, d_ptr, gp_ptr, stp_ptr, live_ptr, S_ptr, Y_ptr,
                                            part_ptr, gpart_ptr, n, end, tiles, with_gp, ex, m, ld,
                                            body: tl.constexpr, RP: tl.constexpr, RT: tl.constexpr,
                                            K: tl.constexpr, W: tl.constexpr,
                                            LD_IS_N: tl.constexpr):
    # K4 b in the row-block form (``factory.batched_epilogue_grid``'s
    # "mma_rows": f32 and f64 rings from ``factory.rows_min_m`` rows, bf16
    # rings above 256; bytes bound it, as the solo form): program (pid, b)
    # takes chunks pid*tiles .. pid*tiles + tiles - 1 of instance b, laid
    # out as ``trial_pair_gram_mma_batched_kernel`` (the instance's
    # offsets, its step, its live flag masking every load and store), and
    # passes over them once per block of ring rows as
    # ``trial_pair_gram_mma_rows_kernel`` does, through the same
    # ``_k4_rows_pass``: no objective partial (the runner takes fx from the
    # search), the body at the instance's own indices.  x and g go over xp
    # and gp on the last pass alone; every earlier pass reads the program's
    # chunks first, and no program reads another's
    st = _stride(n, ld, LD_IS_N)
    pid = tl.program_id(0)
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    xp_ptr += row
    d_ptr += row
    gp_ptr += row
    S_ptr += (b.to(tl.int64) * st) * m
    Y_ptr += (b.to(tl.int64) * st) * m
    stp = tl.load(stp_ptr + b)
    prog = b.to(tl.int64) * tl.num_programs(0) + pid
    part = part_ptr + prog * (4 + 6 * m)
    gpart = gpart_ptr + prog * (2 * m)
    for p in range(tl.cdiv(m - RT, RP)):
        _k4_rows_pass(xp_ptr, d_ptr, gp_ptr, xp_ptr, gp_ptr, S_ptr, Y_ptr, part_ptr, part, gpart,
                      live, n, st, m, end, p * RP, stp, pid, tiles, with_gp, 0, ex, body, RP, K,
                      W, False, False, False, LD_IS_N)
    a_gd, a_gg, a_xx, a_ch = _k4_rows_pass(
        xp_ptr, d_ptr, gp_ptr, xp_ptr, gp_ptr, S_ptr, Y_ptr, part_ptr, part, gpart, live, n, st,
        m, end, tl.cdiv(m - RT, RP) * RP, stp, pid, tiles, with_gp, 0, ex, body, RT, K, W, False,
        True, False, LD_IS_N)
    tl.store(part + 0, tl.sum(a_gd, axis=0), mask=live)
    tl.store(part + 1, tl.sum(a_gg, axis=0), mask=live)
    tl.store(part + 2, tl.sum(a_xx, axis=0), mask=live)
    tl.store(part + 3, tl.sum(a_ch, axis=0), mask=live)


@triton.jit(do_not_specialize=["m", "end", "lo", "hi", "tiles", "with_gp"])
def owlqn_trial_pair_gram_mma_rows_batched_kernel(xp_ptr, d_ptr, gp_ptr, pg_ptr, stp_ptr, c_ptr,
                                                  live_ptr, S_ptr, Y_ptr, part_ptr, gpart_ptr, n,
                                                  lo, hi, end, tiles, with_gp, ex, m, ld,
                                                  body: tl.constexpr, RP: tl.constexpr,
                                                  RT: tl.constexpr, K: tl.constexpr,
                                                  W: tl.constexpr, LD_IS_N: tl.constexpr):
    # K14 b laid out as ``trial_pair_gram_mma_rows_batched_kernel``, through
    # ``_k14_rows_pass``: x, g and pg over xp, gp and pg_old on the last
    # pass alone; gp.gp and gp.pg summed in both launches and stored with
    # with_gp
    st = _stride(n, ld, LD_IS_N)
    pid = tl.program_id(0)
    b = tl.program_id(1)
    live = tl.load(live_ptr + b) != 0
    row = b.to(tl.int64) * n
    xp_ptr += row
    d_ptr += row
    gp_ptr += row
    pg_ptr += row
    S_ptr += (b.to(tl.int64) * st) * m
    Y_ptr += (b.to(tl.int64) * st) * m
    stp = tl.load(stp_ptr + b)
    c = tl.load(c_ptr)
    prog = b.to(tl.int64) * tl.num_programs(0) + pid
    part = part_ptr + prog * (3 + 6 * m)
    gpart = gpart_ptr + prog * (2 + 2 * m)
    for p in range(tl.cdiv(m - RT, RP)):
        _k14_rows_pass(xp_ptr, d_ptr, gp_ptr, pg_ptr, xp_ptr, gp_ptr, pg_ptr, S_ptr, Y_ptr, part,
                       gpart, live, n, st, m, lo, hi, end, p * RP, stp, c, pid, tiles, with_gp, 0,
                       ex, body, RP, K, W, False, False, LD_IS_N)
    a_xx, a_pp, a_ch, a_gg, a_gpg = _k14_rows_pass(
        xp_ptr, d_ptr, gp_ptr, pg_ptr, xp_ptr, gp_ptr, pg_ptr, S_ptr, Y_ptr, part, gpart, live,
        n, st, m, lo, hi, end, tl.cdiv(m - RT, RP) * RP, stp, c, pid, tiles, with_gp, 0, ex, body,
        RT, K, W, False, True, LD_IS_N)
    tl.store(part + 0, tl.sum(a_xx, axis=0), mask=live)
    tl.store(part + 1, tl.sum(a_pp, axis=0), mask=live)
    tl.store(part + 2, tl.sum(a_ch, axis=0), mask=live)
    tl.store(gpart + 0, tl.sum(a_gg, axis=0), mask=live & (with_gp != 0))
    tl.store(gpart + 1, tl.sum(a_gpg, axis=0), mask=live & (with_gp != 0))
