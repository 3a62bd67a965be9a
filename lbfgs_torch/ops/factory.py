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
  * ``__lbfgs_probe_batched__`` / ``__lbfgs_trial_pair_gram_batched__`` /
    ``__lbfgs_combine_batched__`` / ``__lbfgs_combine_fix_batched__`` — the
    batched runner's K2 b, K4 b, K3 b and K6 b: K2, K4 (with the . gp
    column when damped), K3 and K6 over a [B, n] batch of instances, one
    launch for all, with a per-instance step or coefficients and a mask
    of the live instances, whose rows alone are read and written; under
    OWL-QN ``__lbfgs_owlqn_probe_pg_batched__``,
    ``__lbfgs_owlqn_trial_pair_gram_batched__``,
    ``__lbfgs_combine_ow_batched__`` and
    ``__lbfgs_pseudo_gradient_norm_batched__``: K8 b (the pg form), K14 b
    (with the . gp column and scalars when damped), K13 b and K10 b; with
    the step uncapped ``__lbfgs_combine_probe_batched__`` /
    ``__lbfgs_combine_ow_probe_batched__`` (and their ``_ok__``
    predicates): K15 b (with K6 b's damped row in its ``fix`` form) and
    K16 b, each instance's combine and its next first probe at its own
    entry step.  At every depth: above ``MAX_M`` ring rows K15 b and K16 b
    take their solo kernels' deep forms; K4 b and K14 b take the form and
    the batch-wide launch of ``batched_epilogue_grid`` (their Gram products
    on the tensor cores with f32 vectors over a bf16 ring from
    ``MMA_MIN_M`` to ``MMA_MAX_M`` rows, and in the row-block form over f32
    and f64 rings from ``rows_min_m`` rows and bf16 rings above
    ``MMA_MAX_M``), as K4 and K14 take theirs on one instance
    (``solo_epilogue_grid``).
    ``__lbfgs_trial_batched__`` / ``__lbfgs_owlqn_trial_batched__``: K1 b
    and K7 b, K1 and K7 over a batch, which materialize the accepted
    points where no batched epilogue runs (the scan two-loop, a float16
    ring, an objective without the epilogue, the speculative search) and
    evaluate the wide init.
  * ``__lbfgs_probe_steps__`` / ``__lbfgs_owlqn_probe_steps__`` — K2 s and
    K8 s, the speculative search's candidate pass: the objective (+ c*L1)
    at K steps of the backtracking ladder from one pass over the vectors,
    each lane K2's (K8's) fx at its step bit for bit; over a batch
    ``__lbfgs_probe_steps_batched__`` /
    ``__lbfgs_owlqn_probe_pg_steps_batched__`` (K2 b s, K8 b s: [B, K]
    steps, each lane K2 b's and K8 b's).  Above ``SPEC_MAX_LANES`` lanes a
    call launches in chunks.

Under the wide objective scalar (``fused.wide_fx``, ``params.fx_wide``)
the objective's column of K1, K2, K4, K7, K8, K15 and K16 and of their
batched forms, and the L1 column of K7, K8, K16 and theirs, are summed in
float64 (``fused.obj_reduce``; per instance over its programs in the
batched forms), and fx + c*L1 is formed in float64; every other output
is that of the default launch, bit for bit.

Each wrapper launches its Triton kernel (``ops/_factory_triton.py``) on a
CUDA tensor and runs its plain version (``*_ref``, same module) on a CPU
tensor.  Launches and plain calls are counted on the functions
(``fn.launches``, ``ref.calls``; K4's and K14's ``.gp_launches`` count
their ``with_gp`` launches among ``.launches``, K15's ``.fix_launches``
its damped-row launches).  ``objective.plain`` is
a twin objective whose protocol runs the plain versions on any device:
the reference that a run through the kernels is compared with on the
card.

Contract for the body (``lbfgs_tpu/ops/factory.py:71-105``): a
``@triton.jit`` function ``body(x, gidx, *ex) -> (fx_elem, g)`` over one
``[ROWS, W]`` block (``gidx`` the global element indices, ``ex`` the
blocks of the bound ``extras`` at the same indices), in which elements
couple only within a row of ``row`` elements (Rosenbrock's (2i, 2i+1)
pairs: ``row=2``); W = max(row, 2), so an elementwise body (``row=1``)
sees rows of two elements.  ``fx_elem`` holds the per-element objective terms;
the kernels mask the ragged tail.  ``block_fn`` is a zero-argument loader
returning that body, called at the first launch, so that ``triton`` is
only imported where a kernel runs.  ``block_ref(x, gidx, *ex)`` is its
plain torch twin over ``[n // row, row]`` views; without a
``value_and_grad`` the factory builds the plain evaluation from it, as
the JAX factory builds its own from the block.

``extras`` are per-element operand streams (weights, targets, ...): [n]
tensors bound at factory time, contiguous, of the iterate's dtype and on
its device.  Every kernel streams them beside the iterate (each adds its
element's bytes to every kernel's traffic), and the plain versions see
them through ``value_and_grad``.

On a mesh (``fused.kernels_on_mesh``) every wrapper takes this rank's
shard of the iterate (``lbfgs_tpu/ops/factory.py:252-270``): the kernel
runs on it with the shard's global offset ``off`` (the body sees the
global indices ``off + local``), the extras sliced to the shard (an extra
of the whole vector's length is narrowed, one of the shard's is taken as
it is), the OWL-QN window translated into the shard's indices, and the
launch's scalars are added over the ranks in one all-reduce
(``collective.mesh_sum``; K1's, K4's and K14's ``changed`` is "on any
rank").  A shard the kernels cannot take (not a multiple of ``row``)
raises ``ValueError`` naming the split.  The plain versions evaluate the
shard through ``block_ref`` at its global indices and the extras' shards
(an objective without ``block_ref`` through ``value_and_grad`` of the
shard, which then must have no extras).  The batched kernels are not
sharded.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from . import _build, fused
from ..core import ring_stride
from ..orthantwise import Orthantwise, choose_orthant, project_window, pseudo_gradient, x1sum

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
#: (``solo_epilogue_grid``).  Chosen on an NVIDIA H100 80GB HBM3 at its 700 W
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
#: deepest history of the static forms of K15 and K16 (and of the bound
#: above which every K4 and K14 launch counts in ``.deep_launches``): the
#: fusions unroll their loop over the ring rows, compiled per m.  A deeper
#: history takes their deep forms, which loop over the rows at run time,
#: one compile for every m
MAX_M = 64
#: deepest history of the static fold forms of K4 and K14 (solo and
#: batched) per (vector, history) dtype pair: they hold per-thread [T // V,
#: MP] sums per product kind (MP = m rounded up to a power of two), which
#: spill as MP grows.  The deepest m at which the static K4 and K14, each
#: with and without the . gp column, spill nothing and are no slower than
#: the deep form, from ``tools/deep_crossover.py`` at n = 2^20 on an NVIDIA
#: H100 80GB HBM3 at its 700 W limit: at m = 16 K14 ·gp spills over a bf16
#: ring (38 spills), every form over an f32 ring (10-58) and over f64
#: (118-1624); at m = 8 every form spills nothing over f32 rings and runs
#: 6-33% under the deep form (K4 ·gp over an f32 ring ties it, 0.0903
#: against 0.0899 ms); over f64 at m = 8 K14 ·gp spills and K4 loses to
#: the deep form, at m = 7 all four are spill-free and 2-17% ahead.  A
#: deeper history takes the deep form (``DEEP_GROUP`` rows a pass), one
#: compile for every m.  With f32 vectors over a bf16 ring the tensor-core
#: form takes ``MMA_MIN_M`` to ``MMA_MAX_M`` rows first; the solo and
#: batched kernels take the row-block form from ``MMA_ROWS_MIN_M`` rows
#: (the deep form keeps a ring whose row stride is n at an n off a
#: multiple of ``MMA_ALIGN``; the solver's rings are padded, ``MMA_ALIGN``)
EPILOGUE_MAX_M = {
    (torch.float32, torch.bfloat16): 8,
    (torch.float32, torch.float32): 8,
    (torch.float64, torch.float64): 7,
}
#: ring rows per pass of the deep fold epilogues per (vector, history)
#: dtype pair: their per-thread sums are [T // V, G] per product kind.  The
#: largest G (a power of two) at which no form spills on an NVIDIA H100
#: with n divisible by 16 and not: 8 with float32 vectors (148-214
#: registers), 2 with float64 (106-124; at 4 and 8 K4's . gp form spills)
DEEP_GROUP = {
    (torch.float32, torch.bfloat16): 8,
    (torch.float32, torch.float32): 8,
    (torch.float64, torch.float64): 2,
}


#: the batched epilogues' Gram products on the tensor cores (f32 vectors
#: over a bf16 ring, ``MMA_MIN_M`` to ``MMA_MAX_M`` ring rows): each program
#: walks chunks of K elements of one instance; the ring rows of a chunk are
#: one operand ([RP, K] bf16, RP = m rounded up to a power of two, at least
#: 16), the pair's vectors split into three bf16 parts the other ([K, 16]),
#: and ``tl.dot`` gives each chunk's [RP, 16] float32 products, added to the
#: program's sums by float32 adds (``_factory_triton._ring_chunk``'s
#: ``CARRY_RN``, solo and batched alike).  Per RP: the
#: chunk K, warps and pipeline stages, the fastest launch that spills
#: nothing in ``tools/tune_batched_epilogues.py``'s sweep (K 64-256, 4 or 8
#: warps, 1-3 stages; K4 b ·gp and K14 b ·gp at 1024 x 2^14 and m = 6, 19,
#: 48, 80, 200) on an NVIDIA H100 80GB HBM3 at its 700 W limit
MMA_EPILOGUE = {
    16: dict(K=128, num_warps=4, num_stages=3),
    32: dict(K=128, num_warps=4, num_stages=3),
    64: dict(K=256, num_warps=4, num_stages=3),
    128: dict(K=128, num_warps=8, num_stages=3),
    256: dict(K=64, num_warps=8, num_stages=3),
}
#: the depths the tensor-core form takes, solo and batched.  Up to 8 rows
#: the static form's per-thread sums are [T // V, 8] and it is the faster
#: (the same tool's crossover, at m = 6 and 8); from 9 rows they are
#: [T // V, 16] and the tensor-core form is ahead from m = 12 on.  One
#: instance (``--solo``) crosses at the same depths: at m = 9 the static
#: form leads at n = 2^24 and trails at 2^20, from m = 12 the tensor-core
#: form leads at both widths.  Above MMA_MAX_M the deep form runs
MMA_MIN_M, MMA_MAX_M = 9, max(MMA_EPILOGUE)
#: the one dtype pair whose ring values are exact as a bf16 operand
MMA_DTYPES = (torch.float32, torch.bfloat16)
#: the epilogues' tensor-core form over any dtype pair and any depth, solo
#: and batched (``"mma_rows"``: ``trial_pair_gram_mma_rows_kernel``,
#: ``owlqn_trial_pair_gram_mma_rows_kernel`` and their ``_batched``
#: forms): the chunks of the form above, passed over once per block of at
#: most ``MMA_ROWS_RP[pair]`` ring rows (one pass up to that many rows; the
#: last block ``rows_tail`` rows), each block's rows one ``tl.dot``
#: operand: a bf16 ring as it is, an f32 ring in three bf16 parts (as the
#: vectors are split: exact, where one bf16 part is not), an f64 ring in
#: float64 dots (Hopper's FP64 MMA); the sums in the vectors' dtype.  It
#: takes f32 and f64 rings from ``rows_min_m`` rows and bf16 rings above
#: ``MMA_MAX_M``.  The launch per (pair, RP), RP the block's rows (m
#: rounded up to a power of two, at least 16, at most ``MMA_ROWS_RP``):
#: the fastest launch that spills nothing in ``tools/tune_batched_epilogues.py
#: --solo --rows``'s sweep (blocks of 16-256 rows, K 16-128, 4 or 8 warps,
#: 1-3 stages; K4 ·gp and K14 ·gp at n = 2^20, f32 and f64 rings at m =
#: 9-200, bf16 at 260) on an NVIDIA H100 80GB HBM3 at its 700 W limit.
#: Blocks of 128 bf16 rows ran 260 rows (K4 ·gp) in 0.483 ms against 0.557
#: in blocks of 256; f32 rings in blocks of 64 (m = 80: K4 ·gp 0.3381 ms,
#: K14 ·gp 0.3398, against 0.3350 and 0.3776 in blocks of 128; at 200 and
#: 260 rows blocks of 64 lead both), where the f32 tile's split keeps every
#: launch at 253-255 registers; f64 rings in blocks of 128 (m = 80: K4 ·gp
#: 0.5114 ms, K14 ·gp 0.5143, against 0.5360 and 0.5407 in blocks of 64),
#: their [RP, 8] sums in the FP64 MMA's n8 shape (with [RP, 16] sums the
#: fastest f64 launch that spilled nothing ran m = 80 in 0.7988 and 0.9535
#: ms).  The batched K4 b and K14 b take the same launches but where an
#: entry names its own (``batched``; None: the batched form takes no block
#: of that many rows), from ``tools/tune_batched_epilogues.py --rows
#: --batched``'s sweep at 1024 x 2^14 (K 16-128, 4 or 8 warps, 2 or 3
#: stages; K4 b ·gp and K14 b ·gp, f32 rings at m = 25, 32, 48, 80, f64 at
#: 11, 16, 32, 80, bf16 at 260) on the same card.  There the solo launches
#: of blocks of 16 and 64 f64 rows, 64 f32 rows and 128 bf16 rows are the
#: fastest that spill nothing on the paths' binaries (f64 m = 80 in blocks
#: of 64: 7.73 / 7.90 ms; f32 m = 80: 4.62 / 4.84; bf16 m = 260: 6.40 /
#: 6.56); the f64 launch of 128-row blocks spills (6 and 10 registers) and
#: the fastest that does not ran 8.80 / 9.07 ms, so the batched form takes
#: f64 rings in blocks of 64; the f32 launch of 32-row blocks spills 2 in
#: K14 b, and K 32 with 3 stages ran m = 32 in 1.93 / 2.10 ms spill-free.
#: The f32 launch of 64-row blocks spills 2-4 registers where one pass
#: takes all the rows (m = 33-64: m = 48 2.50 / 2.58 ms, against 3.08 /
#: 3.28 for the fastest that does not, which at m = 80 loses to the deep
#: fold form).  Over a padded ring at an n off 16 the batched kernels take
#: an entry's ``batched_padded`` launch where it has one: there the f32
#: launch of 64-row blocks spills (2 in K14 b at m = 80, 1024 x (2^14 +
#: 2)), and the fastest that does not in ``tools/tune_batched_epilogues.py
#: --rows --batched --pairs f32 --depths 80 --rps 64 32 --n 16386``'s sweep
#: on the same card is K 32, 4 warps, 3 stages (K4 b ·gp 6.11 ms, K14 b ·gp
#: 6.48, against 5.59 and 5.72 with the spill)
MMA_ROWS_EPILOGUE = {
    (torch.float32, torch.bfloat16): {128: dict(K=128, num_warps=8, num_stages=3)},
    (torch.float32, torch.float32): {
        16: dict(K=64, num_warps=4, num_stages=2),
        32: dict(K=64, num_warps=4, num_stages=2,
                 batched=dict(K=32, num_warps=4, num_stages=3)),
        64: dict(K=64, num_warps=4, num_stages=3,
                 batched_padded=dict(K=32, num_warps=4, num_stages=3)),
    },
    (torch.float64, torch.float64): {
        16: dict(K=32, num_warps=4, num_stages=3),
        32: dict(K=32, num_warps=4, num_stages=3),
        64: dict(K=32, num_warps=4, num_stages=3),
        128: dict(K=32, num_warps=8, num_stages=3, batched=None),
    },
}
MMA_ROWS_RP = {pair: max(cfgs) for pair, cfgs in MMA_ROWS_EPILOGUE.items()}
#: the depth from which the solo K4 and K14 take the row-block form, per
#: dtype pair: above the one-pass form over a bf16 ring; over f32 and f64
#: rings the depth from which it beats the deep fold form (the static form
#: spills above its cap), from ``tools/deep_crossover.py --forms deep rows``
#: at n = 2^20 on an NVIDIA H100 80GB HBM3 at its 700 W limit.  f32 rings:
#: the deep form's passes are one per 8 rows, so its time steps at 25 rows,
#: and there the row-block form leads all four launches (K4 0.1440 ms
#: against 0.1636, K4 ·gp 0.1496 against 0.1789, K14 0.1408 against 0.1582,
#: K14 ·gp 0.1459 against 0.1675); at 24 the deep form leads both ·gp
#: launches (0.1466 against 0.1485, 0.1398 against 0.1462).  f64 rings:
#: the deep form passes once per 2 rows; at 12 rows (its 6 passes, as at
#: 11) the row-block form leads all four (K4 0.1549 against 0.1596, K4 ·gp
#: 0.1586 against 0.1934, K14 0.1365 against 0.1812, K14 ·gp 0.1418
#: against 0.2011), at 8 the deep form leads K4 (0.1138 against 0.1533)
#: and K4 ·gp (0.1399 against 0.1592).  The batched K4 b and K14 b take the
#: same depths but where the pair has an entry of its own (``(vector,
#: history, "batched")``), from ``tools/deep_crossover.py --batched
#: --forms deep rows`` at 1024 x 2^14 on the same card.  Over f64 rings at
#: 11 rows the row-block form leads all four launches (K14 b ·gp 2.06 ms
#: against 2.24), at 10 it ties K14 b ·gp (2.055 against 2.049) and at 8
#: trails it (2.04 against 1.60).  Over f32 rings the batch-wide grid gives
#: the deep fold form 61-68% of its bound (its solo form 38-52%): at 25-28
#: rows the row-block form leads K4 b, K14 b and K4 b ·gp by 10-18% and
#: trails K14 b ·gp (2.08-2.11 ms against 1.93-1.98); at 31 and 32 it
#: leads the three by 17-22% and ties K14 b ·gp within the turns' spread
#: (2.03-2.12 against 2.05-2.19); from 33 rows (one block of 64) it leads
#: the three by 6-13% and trails K14 b ·gp by up to 3% until the deep
#: form's next pass (2.44-2.48 against 2.40-2.41 at 33; at 48 2.58
#: against 3.13)
MMA_ROWS_MIN_M = {
    (torch.float32, torch.bfloat16): MMA_MAX_M + 1,
    (torch.float32, torch.float32): 25,
    (torch.float64, torch.float64): 11,
    (torch.float32, torch.float32, "batched"): 32,
}


def rows_min_m(pair: tuple, batched: bool = False) -> int:
    """The depth from which K4 and K14 (with ``batched``, K4 b and K14 b)
    take the row-block form over the dtype pair's ring
    (``MMA_ROWS_MIN_M``)."""
    if batched:
        return MMA_ROWS_MIN_M.get((*pair, "batched"), MMA_ROWS_MIN_M[pair])
    return MMA_ROWS_MIN_M[pair]


def rows_launch(pair: tuple, m: int, batched: bool = False, padded: bool = False) -> tuple:
    """(RP, launch) of the row-block form at m ring rows: RP is m rounded up
    to a power of two, at least 16, at most the pair's largest block
    (``MMA_ROWS_RP``; for the batched kernels the largest whose entry has a
    batched launch), the launch ``MMA_ROWS_EPILOGUE``'s, an entry's
    ``batched`` launch for the batched kernels, and its ``batched_padded``
    launch for them over a padded ring at an n off 16 (``padded``)."""
    table = MMA_ROWS_EPILOGUE[pair]
    top = MMA_ROWS_RP[pair]
    if batched:
        pick = lambda cfg: (cfg["batched_padded"] if padded and "batched_padded" in cfg
                            else cfg.get("batched", cfg))
        table = {rp: pick(cfg) for rp, cfg in table.items()}
        top = max(rp for rp, cfg in table.items() if cfg is not None and rp <= top)
    rp = min(max(16, _rows(m)), top)
    return rp, table[rp]


#: the most programs a solo tensor-core launch takes (each walks ``tiles``
#: consecutive chunks of ``MMA_EPILOGUE``'s K, with its warps and stages):
#: the cap that summed the least time relative to each launch's fastest in
#: ``tools/tune_batched_epilogues.py --solo``'s sweep (132 x 2-32 programs;
#: K4 and K14 ±·gp at n = 2^20 and 2^24, m = 16, 19, 80 and 200) on an
#: NVIDIA H100 80GB HBM3 at its 700 W limit, at every RP.  One instance at
#: n = 2^20 gives 8192 chunks of 128; each program's closing reductions
#: are paid once, so fewer, longer programs win there (m = 80: 256
#: programs 0.149 ms, 4096 programs 0.256), and at 2^24 the cap hardly
#: matters (1.945-2.000 ms)
SOLO_MMA_PROGRAMS = 2 * 132
#: the most chunks a solo tensor-core program sums: a launch takes more
#: programs rather than more chunks a program.  At n = 2^24 the cap alone
#: gives 264 programs of 497 chunks; 2048 of 64 run as fast on an H100
#: (K4 at m = 80: 1.9603 ms against 1.9586), and with them every n = 2^24
#: path of ``chip_smoke.py`` ends as it must, where with 497 the deep main
#: path at epsilon 0 (m = 80, f32) stopped on a search direction that
#: increases the objective (its sums add in another order; both within
#: the sum tolerance of the float64 product)
MMA_MAX_CHUNKS = 64
#: the tensor-core forms take a ring whose row stride is a multiple of
#: MMA_ALIGN elements: then every ring row starts on a 32-byte boundary and
#: a chunk's [RP, K] ring tile, masked by the ring's columns (offs < ld,
#: constant over each run of 16), loads as 16-byte vectors.  The solver's
#: rings have such a stride at any n (``core.ring_zeros``: n rounded up to
#: a multiple of 16, the pad columns zero), so the rule is on the stride,
#: not on n.  A ring of row stride n at an n off a multiple of 16 (one
#: handed in contiguous) takes the fold forms: there the rows are not
#: aligned, the loads go scalar, and on an H100 the tensor-core kernels
#: spilled from RP = 64 (96-248 spills at 1-3 pipeline stages) and ran
#: 1.4-3x slower than at an aligned n (m = 80: 0.43-0.51 ms at n = 2^20 +
#: 2 with row stride n, 0.15-0.17 at 2^20)
MMA_ALIGN = 16

#: most lanes one launch of the K-lane probes (K2 s, K8 s and their batched
#: forms) takes: each lane is one more unrolled body call in the kernel, so
#: the lanes are a compile-time constant; more lanes run as launches of at
#: most this many before the search's one read of the round
SPEC_MAX_LANES = 8


def spec_chunks(K: int) -> list:
    """The (first lane, lanes) of each launch of a K-lane probe."""
    return [(k0, min(SPEC_MAX_LANES, K - k0)) for k0 in range(0, K, SPEC_MAX_LANES)]


def _epilogue_form(m: int, vdtype: torch.dtype, hdtype: torch.dtype,
                   mma: bool = True, batched: bool = False, padded: bool = False) -> tuple:
    """(form, its launch table's entry, its tile or chunk T, its
    compile-time constants) of K4 and K14 (with ``batched``, K4 b and K14
    b) at m ring rows: the tensor-core form (``"mma"``; with ``mma`` on:
    the ring's row stride a multiple of ``MMA_ALIGN``)
    for f32 vectors over a bf16 ring from ``MMA_MIN_M`` to ``MMA_MAX_M``
    rows, else the static fold form up to ``EPILOGUE_MAX_M`` rows, then
    (with ``mma`` on) the tensor-core row-block form (``"mma_rows"``) from
    ``rows_min_m`` rows in ``rows_launch``'s blocks (``padded``: a ring
    whose stride is padded past n, which may take a launch of its own),
    and the deep fold form between, the fold forms on ``EPILOGUE``'s
    tiles."""
    pair = (vdtype, hdtype)
    if mma and pair == MMA_DTYPES and MMA_MIN_M <= m <= MMA_MAX_M:
        rp = max(16, _rows(m))
        cfg = MMA_EPILOGUE[rp]
        return "mma", cfg, cfg["K"], dict(m=m, RP=rp, K=cfg["K"])
    cfg = EPILOGUE[pair]
    if m <= EPILOGUE_MAX_M[pair]:
        return "static", cfg, cfg["T"], dict(M=m, MP=_rows(m), T=cfg["T"], V=cfg["V"])
    if mma and m >= rows_min_m(pair, batched):
        rp, cfg = rows_launch(pair, m, batched, padded)
        return "mma_rows", cfg, cfg["K"], dict(m=m, RP=rp, RT=rows_tail(m, rp), K=cfg["K"])
    return "deep", cfg, cfg["T"], dict(m=m, G=DEEP_GROUP[pair], T=cfg["T"], V=cfg["V"])


def rows_tail(m: int, rp: int) -> int:
    """The row-block form's last block: the rows left after the full blocks
    of rp rows (rp when none is left), rounded up to a power of two, at
    least 16, so that a few rows past a block do not take a whole block's
    products."""
    return max(16, _rows(m - (-(-m // rp) - 1) * rp))


def _form_grid(form: str, cfg: dict, T: int, consts: dict, ntiles: int, per: int,
               B: int, most: int) -> SimpleNamespace:
    """A form's launch over ``ntiles`` tiles (chunks) an instance, at most
    ``per`` programs each, as few tiles a program as that allows, and at
    most ``most`` tiles a program."""
    tiles = min(-(-ntiles // per), most)
    programs = -(-ntiles // tiles)
    return SimpleNamespace(form=form, T=T, ntiles=ntiles, tiles=tiles, programs=programs,
                           total=B * programs, consts=consts,
                           launch=dict(num_warps=cfg["num_warps"],
                                       num_stages=cfg["num_stages"]))


def solo_epilogue_grid(n: int, m: int, vdtype: torch.dtype, hdtype: torch.dtype,
                       ld: int | None = None) -> SimpleNamespace:
    """The form and launch of the solo K4 and K14 (the ·gp launch and the
    3-column one alike) at n elements and m ring rows (``_epilogue_form``):
    the fold forms on ``EPILOGUE``'s tiles of T elements, the tiles each
    program loops over and the program count (at most
    ``EPILOGUE_PROGRAMS``; fewer, with one tile each, for a small n); the
    tensor-core forms (``"mma"`` and ``"mma_rows"``), where the ring's row
    stride ``ld`` is a multiple of ``MMA_ALIGN`` (by default the solver's
    ring's, ``core.ring_stride(n)``, which is at any n; a ring of row
    stride n at an n off 16 takes the fold forms), on chunks of K, at most
    ``SOLO_MMA_PROGRAMS`` programs
    (more where a program would sum more than ``MMA_MAX_CHUNKS`` chunks),
    each taking ``tiles`` consecutive chunks (``"mma_rows"``: once per
    block of RP ring rows).  The last program's tiles may run past n,
    masked.  Fields as ``batched_epilogue_grid``'s at B = 1."""
    ld = ring_stride(n) if ld is None else ld
    form, cfg, T, consts = _epilogue_form(m, vdtype, hdtype, mma=ld % MMA_ALIGN == 0)
    ntiles = -(-n // T)
    if form in ("mma", "mma_rows"):
        return _form_grid(form, cfg, T, consts, ntiles, SOLO_MMA_PROGRAMS, 1, MMA_MAX_CHUNKS)
    return _form_grid(form, cfg, T, consts, ntiles, EPILOGUE_PROGRAMS, 1, ntiles)


def batched_epilogue_grid(B: int, n: int, m: int, vdtype: torch.dtype, hdtype: torch.dtype,
                          ld: int | None = None) -> SimpleNamespace:
    """The form and launch of K4 b and K14 b (the ·gp launch and the
    3-column one alike) on B instances of n elements with m ring rows, the
    form as the solo kernels' (``_epilogue_form``), the row-block form's
    depth and launch the batched ones (``rows_min_m``, ``rows_launch``).
    The launch is sized over the whole batch: each instance's n elements
    are cut into ``ntiles`` tiles of T elements (the tensor-core forms'
    chunks of K), and each of its ``programs`` programs takes ``tiles``
    consecutive ones, so that B * programs stays at or under
    ``EPILOGUE_PROGRAMS`` wherever B does (one program an instance above
    it).  The tensor-core forms (``"mma"`` and ``"mma_rows"``) take the
    solo forms' rules: the rings' row stride ``ld`` a multiple of
    ``MMA_ALIGN`` (by default ``core.ring_stride(n)``, the runner's rings';
    a ring of row stride n at an n off 16 takes the fold forms), and at
    most ``MMA_MAX_CHUNKS`` chunks a program (a larger n takes more
    programs, not more chunks).  A program never
    straddles two instances; the last one's tiles may run past n, masked.
    ``consts`` are the form's compile-time constants, ``launch`` its warps
    and stages."""
    ld = ring_stride(n) if ld is None else ld
    form, cfg, T, consts = _epilogue_form(m, vdtype, hdtype, mma=ld % MMA_ALIGN == 0,
                                          batched=True, padded=ld != n)
    ntiles = -(-n // T)
    most = MMA_MAX_CHUNKS if form in ("mma", "mma_rows") else ntiles
    return _form_grid(form, cfg, T, consts, ntiles, max(1, EPILOGUE_PROGRAMS // B), B, most)


def batched_epilogue_partials(grid: SimpleNamespace, B: int, m: int, owlqn: bool,
                              with_gp: bool) -> dict:
    """The shapes of K4 b's and K14 b's partials on ``grid``
    (``batched_epilogue_grid``): [B, programs, 4 + 6m] (K4 b) or [B,
    programs, 3 + 6m] (K14 b), ``epilogue_partials``' columns per program,
    and with ``with_gp`` the . gp column's [B, programs, 2m] ([B, programs,
    2 + 2m] for K14 b)."""
    out = {"part": (B, grid.programs, (3 if owlqn else 4) + 6 * m)}
    if with_gp:
        out["gpart"] = (B, grid.programs, (2 if owlqn else 0) + 2 * m)
    return out


def bf16_split_ref(v: torch.Tensor) -> tuple:
    """The tensor-core forms' split of a float32 vector, or of an f32
    ring's rows, into three bf16 parts (``_factory_triton._split_operand``,
    ``_ring_dot``), in torch: b1 = bf16(v), b2 = bf16(v - b1), b3 = bf16(v
    - b1 - b2).  For a finite v below bf16's largest value b1 + b2 + b3 ==
    v exactly; an inf or NaN leaves NaN in b2 and b3."""
    b1 = v.to(torch.bfloat16)
    r1 = v - b1.float()
    b2 = r1.to(torch.bfloat16)
    return b1, b2, (r1 - b2.float()).to(torch.bfloat16)


def mma_products_ref(R: torch.Tensor, V: torch.Tensor, K: int) -> torch.Tensor:
    """The tensor-core forms' products R.V of ring rows R ([r, n]: bf16,
    float32 or float64) with vectors V ([n, c]: float32 or float64), in
    torch, split as the kernels split their operands
    (``_factory_triton._operand``, ``_ring_dot``): f32 vectors in three bf16
    parts each (``bf16_split_ref``), an f32 ring's rows in three bf16 parts
    too, a bf16 ring and f64 operands as they are; per chunk of K elements
    every part's product summed in the sums' dtype (float32 for f32
    vectors, float64 for f64; the ring's smallest parts first), each
    chunk's sums added to the running sums in that dtype (``CARRY_RN``),
    and each product (p1 + p2) + p3 over the vector's parts.  Returns [r,
    c] in the sums' dtype."""
    if V.dtype == torch.float64:
        rings, parts = [R.double()], [V]
    else:
        rings = [q.float() for q in (bf16_split_ref(R) if R.dtype == torch.float32 else (R,))]
        parts = [q.float() for q in bf16_split_ref(V)]
    sums = [torch.zeros(R.shape[0], V.shape[1], dtype=V.dtype, device=V.device) for _ in parts]
    for c0 in range(0, R.shape[1], K):
        for i, v in enumerate(parts):
            chunk = rings[-1][:, c0:c0 + K] @ v[c0:c0 + K]
            for q in reversed(rings[:-1]):
                chunk = chunk + q[:, c0:c0 + K] @ v[c0:c0 + K]
            sums[i] = sums[i] + chunk
    out = sums[0]
    for t in sums[1:]:
        out = out + t
    return out


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


def _batched_buffers(xp: torch.Tensor, grid: SimpleNamespace, m: int, owlqn: bool,
                     with_gp: bool) -> tuple:
    """K4 b's or K14 b's (part, gpart) on ``grid`` and xp's device ([B, n]
    iterates), gpart the part array itself without ``with_gp``."""
    bufs = {k: torch.empty(v, dtype=xp.dtype, device=xp.device)
            for k, v in batched_epilogue_partials(grid, xp.shape[0], m, owlqn, with_gp).items()}
    return bufs["part"], bufs.get("gpart", bufs["part"])


def _rows(m: int) -> int:
    """m rounded up to a power of two: the ring tile's row count."""
    return 1 << (m - 1).bit_length()


def _launch_epilogue(fn, eg: SimpleNamespace, m: int, vdtype: torch.dtype,
                     hdtype: torch.dtype, with_gp: bool, *args, **kw) -> None:
    """Launch K4 or K14 (``fn``, the solo or batched wrapper) in the form
    and over the grid ``eg`` (``solo_epilogue_grid``,
    ``batched_epilogue_grid``: the batched grid's axis 1 is the instance),
    keep the compiled kernel in the form's dict (``fn.mma_compiled``,
    ``fn.mma_rows_compiled``, ``fn.compiled``, ``fn.deep_compiled``) and,
    with the geometry, in ``fn.last_form``, and count the launch
    (``_count``; ``fn.mma_launches`` for the tensor-core form,
    ``fn.mma_rows_launches`` for the row-block form).  ``args`` run up to the tiles argument,
    ``kw`` names the rest."""
    batched = fn.__name__.endswith("_batched")
    name = fn.__name__.removesuffix("_batched")
    name += {"mma": "_mma", "mma_rows": "_mma_rows", "static": "", "deep": "_deep"}[eg.form]
    name += "_batched_kernel" if batched else "_kernel"
    grid = (eg.programs, eg.total // eg.programs) if batched else (eg.programs,)
    compiled = getattr(fn, {"mma": "mma_compiled", "mma_rows": "mma_rows_compiled",
                            "static": "compiled", "deep": "deep_compiled"}[eg.form])
    # the tensor-core forms' . gp column is a run-time flag (one binary for
    # both launches); the fold forms' a compile-time one
    mma = eg.form in ("mma", "mma_rows")
    flag = dict(with_gp=int(with_gp)) if mma else dict(WITH_GP=bool(with_gp))
    ck = getattr(_kernels(), name)[grid](*args, eg.tiles, **flag, **kw, **eg.consts,
                                         **dict(LAUNCH, **eg.launch))
    compiled[(vdtype, hdtype, bool(with_gp))] = ck
    fn.last_form = SimpleNamespace(kernel=name, compiled=ck, dtypes=(vdtype, hdtype), **vars(eg))
    fn.mma_launches += eg.form == "mma"
    if eg.form == "mma_rows":
        fn.mma_rows_launches += 1
    _count(fn, m > MAX_M, gp=bool(with_gp))


def _count(fn, deep: bool, **forms: bool) -> None:
    """One launch of a wrapper's kernel: ``fn.launches``, and
    ``fn.deep_launches`` for a deep form (above ``MAX_M`` rows); each of
    ``forms`` that is on (K4's and K14's ``gp``, K15's ``fix``) counts in
    ``fn.<form>_launches`` too, and for a deep form in
    ``fn.deep_<form>_launches``."""
    fn.launches += 1
    fn.deep_launches += deep
    for form, on in forms.items():
        setattr(fn, form + "_launches", getattr(fn, form + "_launches") + on)
        setattr(fn, f"deep_{form}_launches", getattr(fn, f"deep_{form}_launches") + (on and deep))


def _kernels():
    _build.import_triton()
    from . import _factory_triton

    return _factory_triton


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A host scalar as a 1-element tensor on like's device and dtype (the
    kernels load the step from memory: a Python float argument would be
    narrowed to float32)."""
    return torch.full((1,), float(v), dtype=like.dtype, device=like.device)


_window = fused.kernel_window


def _fx(part: torch.Tensor, tot: torch.Tensor) -> torch.Tensor:
    """The objective from column 0 of a kernel's partials: summed in
    float64 under the wide mode, else the column's fixed-order sum."""
    return fused.obj_reduce(part[:, 0]) if fused.wide(part.dtype) else tot[0]


def _fx_tiles(fxp: torch.Tensor) -> torch.Tensor:
    """The objective from an epilogue's per-tile partials: summed in
    float64 under the wide mode, else their fixed-order sum."""
    return fused.obj_reduce(fxp) if fused.wide(fxp.dtype) else fused.reduce_partials(fxp)


def _ow_probe_scalars(part: torch.Tensor, c: float, *more: torch.Tensor) -> tuple:
    """(fx + c*L1, g.d, *more) from K7's, K8's or K16's [programs, 3] (f,
    L1, g.d) partials, by one code path for all three kernels: fx + c*L1 in
    float64 under the wide mode (``lbfgs_tpu/ops/factory.py:440-448``),
    else in the vectors' dtype.  On a mesh the three sums and the launch's
    other sums ``more`` are added over the ranks in one collective first."""
    tot = fused.reduce_partials(part)
    if fused.wide(part.dtype):
        fx, l1 = fused.obj_reduce(part[:, :2])
        fx, l1, dg, *more = fused.mesh_sum(fx, l1, tot[2], *more)
        return (fx + c * l1, dg, *more)
    fx, l1, dg, *more = fused.mesh_sum(tot[0], tot[1], tot[2], *more)
    return (fx + l1 * c, dg, *more)


def _fx_batched(part: torch.Tensor, tot: torch.Tensor) -> torch.Tensor:
    """The [B] objective from column 0 of a batched kernel's [B, programs,
    k] partials: summed per instance in float64 under the wide mode, else
    the column's sum ``tot[:, 0]``."""
    return fused.obj_reduce(part[:, :, 0], dim=1) if fused.wide(part.dtype) else tot[:, 0]


def _ow_scalars_batched(part: torch.Tensor, c: float) -> tuple:
    """[B] (fx + c*L1, g.d) from K7 b's, K8 b's or K16 b's [B, programs, 3]
    (f, L1, g.d) partials, by one code path for the three: under the wide
    mode the f and L1 columns summed in float64 and fx + c*L1 formed there
    (``_ow_probe_scalars``' wide form per instance), else in the vectors'
    dtype."""
    tot = fused.reduce_partials(part, dim=1)
    if fused.wide(part.dtype):
        fl = fused.obj_reduce(part[:, :, :2], dim=1)
        return fl[:, 0] + c * fl[:, 1], tot[:, 2]
    return tot[:, 0] + tot[:, 1] * c, tot[:, 2]


def _lane_sums(part: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The K-lane probes' objective (and L1) columns, [programs, K*c]
    (batched: [B, programs, K*c]), summed over their programs by one
    launch of R: in float64 under the wide mode, as ``_fx`` and
    ``_ow_probe_scalars`` sum K2's and K8's columns, else in the vectors'
    dtype.  R's order depends on the row count alone, so each column is
    the one-lane kernel's sum bit for bit."""
    if fused.wide(part.dtype):
        return fused.obj_reduce(part, dim)
    return fused.reduce_partials(part, dim)


def _ow_lanes_total(fx: torch.Tensor, l1: torch.Tensor, c: float) -> torch.Tensor:
    """The lanes' [K] fx + c*L1 from their (f, L1) sums, added over the mesh
    in one collective first, as ``_ow_probe_scalars`` forms one lane's."""
    fx, l1 = fused.mesh_sum(fx, l1)
    return fx + l1 * c


def make_fused_objective(block_fn, value_and_grad=None, *, extras=(), row: int = 1,
                         validate=None, block_ref=None):
    """Build a fused objective from a per-block body.

    Args:
      block_fn: zero-argument loader of the ``@triton.jit`` body (see the
        module docstring).
      value_and_grad: plain torch ``x -> (fx, gx)``; the plain versions
        of the kernels evaluate through it.  When None, it is built from
        ``block_ref`` over the whole vector.
      extras: tuple of [n] tensors streamed beside the iterate into every
        kernel and passed to the body after gidx.
      row: width of the rows the body couples elements in.
      validate: optional ``validate(n)`` raising on unsupported sizes.
      block_ref: the body's plain torch twin ``(x, gidx, *ex) -> (fx_elem,
        g)``; needed when ``value_and_grad`` is None.
    """
    tiles = ([cfg["T"] for cfg in EPILOGUE.values()] + [cfg["K"] for cfg in MMA_EPILOGUE.values()]
             + [cfg["K"] for cfgs in MMA_ROWS_EPILOGUE.values() for cfg in cfgs.values()])
    if BLOCK % row or any(t % row for t in tiles):
        raise ValueError(f"row={row} must divide the block of {BLOCK} and the epilogues' tiles")
    # the kernels lay a block out as rows of W elements, at least two: with
    # rows of one element (an elementwise body) a 16-byte bf16 ring load
    # holds twice the elements of a float32 one, Triton lays K15's and
    # K16's pass out by the ring loads, and their probes' sums would add in
    # another order than K2's and K8's (the remat contract); with two,
    # every load of every kernel holds the same two elements a thread
    W = max(row, 2)
    rows = BLOCK // W
    extras = tuple(extras)
    if value_and_grad is None:
        if block_ref is None:
            raise ValueError("make_fused_objective needs value_and_grad or block_ref")
        value_and_grad = _synthesized(block_ref, extras, row)

    def _check(x: torch.Tensor) -> tuple[int, tuple]:
        """Check an iterate (on a mesh, this rank's shard of it); returns the
        shard's global offset (0 with no mesh) and the extras at its
        elements (``_mesh_splits``, ``lbfgs_tpu/ops/factory.py:123-130``)."""
        fused.check_dtypes(x.dtype)
        if x.ndim != 1:
            raise ValueError(f"expected a 1-D iterate, got shape {tuple(x.shape)}")
        n = x.shape[0]
        whole = fused.global_length(n)
        if validate is not None:
            validate(whole)
        if n % row:
            if whole == n:
                raise ValueError(f"n={n} is not a multiple of row={row}")
            raise ValueError(f"a shard of {n} elements (n={whole} over {whole // n} ranks) "
                             f"is not a multiple of row={row}: the kernels cannot take "
                             f"that split")
        off = fused.shard_offset(n)
        ex = []
        for i, e in enumerate(extras):
            if whole != n and e.ndim == 1 and e.shape[0] == whole:
                e = e.narrow(0, off, n)
            if e.shape != x.shape or e.dtype != x.dtype or e.device != x.device:
                raise ValueError(f"extra {i}: {e.dtype} {tuple(e.shape)} on {e.device} "
                                 f"against the iterate's {x.dtype} {tuple(x.shape)} on "
                                 f"{x.device}")
            if not e.is_contiguous():
                raise ValueError(f"extra {i} must be contiguous")
            ex.append(e)
        return off, tuple(ex)

    def _evaluate(x: torch.Tensor):
        """The plain evaluation (fx, g) at x: ``value_and_grad``, or on a
        mesh that of the shard x at its global indices with the extras'
        shards (its fx the shard's terms only)."""
        if fused.active_mesh() is None:
            return value_and_grad(x)
        if block_ref is not None:
            return _block_eval(block_ref, x, *_check(x), row)
        if extras:
            raise NotImplementedError("the plain evaluation of an objective with extras on a "
                                      "mesh needs its block_ref")
        return value_and_grad(x)

    def _grid(n: int) -> tuple[int]:
        return (-(-n // BLOCK),)

    def _check_batched(kernel: str, xp: torch.Tensor, live: torch.Tensor) -> int:
        # a [B, n] batch of iterates: each row an iterate of this objective
        B = fused.check_batch(kernel, xp, live)
        n = xp.shape[1]
        if validate is not None:
            validate(n)
        if n % row:
            raise ValueError(f"n={n} is not a multiple of row={row}")
        for i, e in enumerate(extras):
            if e.shape != (n,) or e.dtype != xp.dtype or e.device != xp.device:
                raise ValueError(f"extra {i}: {e.dtype} {tuple(e.shape)} on {e.device} "
                                 f"against the instances' {xp.dtype} [{n}] on {xp.device}")
        return B

    def _batched_scalars(kernel: str, xp: torch.Tensor, stp: torch.Tensor, *vs) -> None:
        if stp.shape != (xp.shape[0],) or stp.dtype != xp.dtype or stp.device != xp.device:
            raise ValueError(f"{kernel}: stp must be a [B] tensor of the iterates' dtype "
                             f"on their device")
        for v in vs:
            if v.shape != xp.shape or v.dtype != xp.dtype:
                raise ValueError(f"{kernel}: operands must be [B, n] of one dtype")

    # ------------------------------------------------------------ K1 trial

    def trial_ref(xp, d, stp):
        """Plain version of ``trial``."""
        trial_ref.calls += 1
        xt = xp + float(stp) * d
        fx, g = _evaluate(xt)
        fx, dg, gg, xx, changed = fused.mesh_sum(
            fused.obj_lift(fx, xt.dtype), torch.dot(g, d), torch.dot(g, g), torch.dot(xt, xt),
            torch.any(xt != xp))
        return xt, fx, g, dg, gg, xx, changed

    def trial(xp, d, stp):
        """(xt, fx, g, g.d, g.g, xt.xt, changed) at xt = xp + stp*d; the
        scalars are 0-d tensors on xp's device."""
        off, ex = _check(xp)
        if not fused.on_cuda(xp, "trial"):
            return trial_ref(xp, d, stp)
        fused.check_contiguous("trial", xp, d)
        n = xp.shape[0]
        grid = _grid(n)
        xt = torch.empty_like(xp)
        g = torch.empty_like(xp)
        part = torch.empty((grid[0], 5), dtype=xp.dtype, device=xp.device)
        _kernels().trial_kernel[grid](
            xp, d, _scalar(stp, xp), xt, g, part, n, off, ex=ex, SHARD=off != 0,
            body=block_fn(), ROWS=rows, W=W, **LAUNCH,
        )
        trial.launches += 1
        tot = fused.reduce_partials(part)
        fx, dg, gg, xx, changed = fused.mesh_sum(_fx(part, tot), tot[1], tot[2], tot[3],
                                                 tot[4] > 0)
        return xt, fx, g, dg, gg, xx, changed

    # ------------------------------------------------------------ K2 probe

    def _probe_plain(xp, d, stp):
        # the shard's (fx, g.d), not summed over the mesh
        fx, g = _evaluate(xp + float(stp) * d)
        return fused.obj_lift(fx, xp.dtype), torch.dot(g, d)

    def probe_ref(xp, d, stp):
        """Plain version of ``probe``."""
        probe_ref.calls += 1
        return fused.mesh_sum(*_probe_plain(xp, d, stp))

    def probe(xp, d, stp):
        """(fx, g.d) at xp + stp*d, writing no vector."""
        off, ex = _check(xp)
        if not fused.on_cuda(xp, "probe"):
            return probe_ref(xp, d, stp)
        fused.check_contiguous("probe", xp, d)
        n = xp.shape[0]
        grid = _grid(n)
        part = torch.empty((grid[0], 2), dtype=xp.dtype, device=xp.device)
        _kernels().probe_kernel[grid](
            xp, d, _scalar(stp, xp), part, n, off, ex=ex, SHARD=off != 0,
            body=block_fn(), ROWS=rows, W=W, **LAUNCH,
        )
        probe.launches += 1
        tot = fused.reduce_partials(part)
        return fused.mesh_sum(_fx(part, tot), tot[1])

    # ------------------------------------------- K2 b: the batched probe

    def _probe_batched_plain(xp, d, stp):
        fx, g = torch.func.vmap(value_and_grad)(xp + stp[:, None] * d)
        return fused.obj_lift(fx, xp.dtype), _dot(g, d)

    def probe_batched_ref(xp, d, stp, live):
        """Plain version of ``probe_batched``."""
        probe_batched_ref.calls += 1
        return _probe_batched_plain(xp, d, stp)

    def probe_batched(xp, d, stp, live):
        """K2 over B instances (K2 b): (fx [B], g.d [B]) at xp[b] +
        stp[b]*d[b] for every live instance b, writing no vector; a frozen
        instance's values are undefined.  ``xp``, ``d`` [B, n]; ``stp`` [B]
        in their dtype and ``live`` [B] bool, on their device.  On the card
        an instance's sums equal ``probe``'s on that instance alone bit for
        bit."""
        B = _check_batched("probe_batched", xp, live)
        _batched_scalars("probe_batched", xp, stp, d)
        if not fused.on_cuda(xp, "probe_batched"):
            return probe_batched_ref(xp, d, stp, live)
        fused.check_contiguous("probe_batched", xp, d, stp, live)
        n = xp.shape[1]
        grid = (_grid(n)[0], B)
        part = torch.empty((B, grid[0], 2), dtype=xp.dtype, device=xp.device)
        _kernels().probe_batched_kernel[grid](
            xp, d, stp, live.view(torch.uint8), part, n, ex=extras, body=block_fn(), ROWS=rows,
            W=W, **LAUNCH,
        )
        probe_batched.launches += 1
        tot = fused.reduce_partials(part, dim=1)
        return _fx_batched(part, tot), tot[:, 1]

    # ----------------------------------------- K1 b: the batched trial

    def trial_batched_ref(xp, d, stp, live, xt, g):
        """Plain version of ``trial_batched``: ``probe_batched_ref``'s
        point and evaluation, so that its (fx, g.d) are K2 b's plain ones."""
        trial_batched_ref.calls += 1
        x = xp + stp[:, None] * d
        fx, gt = torch.func.vmap(value_and_grad)(x)
        out = (fused.obj_lift(fx, xp.dtype), _dot(gt, d), _dot(gt, gt), _dot(x, x),
               (x != xp).any(dim=1))
        _write_live(live, (xt, x), (g, gt))
        return out

    def trial_batched(xp, d, stp, live, xt, g):
        """K1 over B instances (K1 b): for every live instance b the trial
        point xp[b] + stp[b]*d[b] written to xt[b] and its gradient to g[b],
        and the [B] sums fx, g.d, g.g, x.x and changed (any x != xp).
        ``xp``, ``d``, ``xt``, ``g`` [B, n]; ``stp`` [B] in their dtype and
        ``live`` [B] bool, on their device.  A frozen instance's rows of xt
        and g are never written, and its sums are undefined.  xt and g may
        be xp and d's own buffers only where the caller no longer needs
        them (each element is read before it is written).  On the card an
        instance's point and gradient equal ``trial``'s on that instance
        alone bit for bit, and its (fx, g.d) ``probe_batched``'s at the same
        step (the remat contract; both modes of the objective scalar).
        Returns (fx, g.d, g.g, x.x, changed)."""
        B = _check_batched("trial_batched", xp, live)
        _batched_scalars("trial_batched", xp, stp, d, xt, g)
        if not fused.on_cuda(xp, "trial_batched"):
            return trial_batched_ref(xp, d, stp, live, xt, g)
        fused.check_contiguous("trial_batched", xp, d, stp, live, xt, g)
        n = xp.shape[1]
        grid = (_grid(n)[0], B)
        ppart = torch.empty((B, grid[0], 2), dtype=xp.dtype, device=xp.device)
        part = torch.empty((B, grid[0], 3), dtype=xp.dtype, device=xp.device)
        trial_batched.compiled[xp.dtype] = _kernels().trial_batched_kernel[grid](
            xp, d, stp, live.view(torch.uint8), xt, g, ppart, part, n, ex=extras,
            body=block_fn(), ROWS=rows, W=W, **LAUNCH,
        )
        trial_batched.launches += 1
        ptot, tot = fused.reduce_partials(ppart, dim=1), fused.reduce_partials(part, dim=1)
        return _fx_batched(ppart, ptot), ptot[:, 1], tot[:, 0], tot[:, 1], tot[:, 2] > 0

    # ------------------------------------------- K4 trial + pair + Gram

    def trial_pair_gram_ref(xp, d, gp, stp, S, Y, end, inplace=False, with_gp=False):
        """Plain version of ``trial_pair_gram``."""
        trial_pair_gram_ref.calls += 1
        stp = float(stp)
        x = xp + stp * d
        fx, g = _evaluate(x)
        SP, YP = fused.pair_products(stp * d, g - gp, -g, S, Y, end,
                                     gp=gp if with_gp else None)
        *out, SP, YP = fused.mesh_sum(fused.obj_lift(fx, x.dtype), torch.dot(g, d),
                                      torch.dot(g, g), torch.dot(x, x), torch.any(x != xp),
                                      SP, YP)
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
        for bit.  The form is ``solo_epilogue_grid``'s: the static fold up
        to ``EPILOGUE_MAX_M`` ring rows, the deep fold above (x, g, the ring
        row and every sum but the products the static form's bit for bit),
        with f32 vectors over a bf16 ring the tensor-core form from
        ``MMA_MIN_M`` to ``MMA_MAX_M`` rows (x, g and the ring row the fold
        forms' bit for bit, the sums and the objective in its own order,
        counted in ``.mma_launches``), and over f32 and f64 rings from
        ``MMA_ROWS_MIN_M`` rows and bf16 rings above ``MMA_MAX_M`` the
        tensor-core row-block form (the same relation to the fold forms,
        counted in ``.mma_rows_launches``)."""
        off, ex = _check(xp)
        fused._check_hist(xp, S, Y)
        if not fused.on_cuda(xp, "trial_pair_gram"):
            return trial_pair_gram_ref(xp, d, gp, stp, S, Y, end, inplace, with_gp)
        fused.check_contiguous("trial_pair_gram", xp, d, gp)
        ld = fused.ring_ld("trial_pair_gram", S, Y)
        m, n = S.shape
        eg = solo_epilogue_grid(n, m, xp.dtype, S.dtype, ld)
        x = xp if inplace else torch.empty_like(xp)
        g = gp if inplace else torch.empty_like(gp)
        bufs = _epilogue_buffers(xp, eg, m, False, with_gp)
        part = bufs["part"]
        _launch_epilogue(trial_pair_gram, eg, m, xp.dtype, S.dtype, with_gp,
                         xp, d, gp, _scalar(stp, xp), x, g, S, Y, bufs["fx"], part,
                         bufs.get("gpart", part), n, int(end), off=off, ex=ex, ld=ld,
                         SHARD=off != 0, body=block_fn(), W=W, LD_IS_N=ld == n)
        tot = fused.reduce_partials(part)
        sums = (_fx_tiles(bufs["fx"]), tot[0], tot[1], tot[2], tot[3] > 0, tot[4:])
        if with_gp:
            sums += (fused.reduce_partials(bufs["gpart"]),)
        fx, dg, gg, xx, changed, P, *G = fused.mesh_sum(*sums)
        P = P.reshape(m, 6)
        SP, YP = P[:, :3], P[:, 3:]
        if with_gp:
            SP, YP = fused.append_gp(SP, YP, G[0])
        return (x, fx, g, dg, gg, xx, changed, SP, YP)

    def trial_pair_gram_ok(xp, S) -> bool:
        # shape and dtype only, at any depth (the deep forms above MAX_M): a
        # size the objective rejects raises inside the wrapper instead of
        # quietly taking the composed path
        return fused.can_pair_gram(xp, S)

    # ------------------------------------- K4 b: the batched epilogue

    def trial_pair_gram_batched_ref(xp, d, gp, stp, S, Y, end, live, with_gp=False):
        """Plain version of ``trial_pair_gram_batched``."""
        trial_pair_gram_batched_ref.calls += 1
        s = stp[:, None] * d
        x = xp + s
        _, g = torch.func.vmap(value_and_grad)(x)
        y = g - gp
        SP, YP = fused.pair_products_batched(s, y, -g, S, Y, end, live, gp if with_gp else None)
        out = (_dot(g, d), _dot(g, g), _dot(x, x), (x != xp).any(dim=1), SP, YP)
        _write_live(live, (xp, x), (gp, g))
        return out

    def trial_pair_gram_batched(xp, d, gp, stp, S, Y, end, live, with_gp=False):
        """K4 over B instances (K4 b), in place: for every live instance b
        the accepted point x = xp[b] + stp[b]*d[b] written over xp[b], its
        gradient g over gp[b], the pair (s, y) = (stp[b]*d[b], g - gp[b])
        written into ring row ``end`` of S[b] and Y[b], rounded to the
        history dtype, and the 6m products SP = S[b].[y, s, -g], YP =
        Y[b].[y, s, -g] over the updated rings, row ``end`` from the
        unrounded pair.  ``xp``, ``d``, ``gp`` [B, n]; ``S``, ``Y`` [B, m,
        n]; ``stp`` [B]; ``live`` [B] bool; ``end`` a host int shared by the
        live instances.  A frozen instance's vectors and ring rows are
        never written, and its outputs are undefined.  Returns (g.d, g.g,
        x.x, changed) as [B] tensors and SP, YP [B, m, 3].  ``with_gp=True``
        (the damped runs) appends the . gp column S[b].gp[b], Y[b].gp[b]
        (SP, YP [B, m, 4]), counted in ``.gp_launches`` too; every other
        output is that of the 3-column launch bit for bit.  On the card an
        instance's x, g and ring row equal ``trial_pair_gram``'s on that
        instance alone bit for bit, its sums within the sum tolerance (the
        launch is sized over the batch and sums in its own order).  The
        form (static, tensor-core, row-block or deep) and the grid are
        ``batched_epilogue_grid``'s."""
        B = _check_batched("trial_pair_gram_batched", xp, live)
        _batched_scalars("trial_pair_gram_batched", xp, stp, d, gp)
        fused._check_hist_batched("trial_pair_gram_batched", xp, S, Y)
        m, n = S.shape[1], S.shape[2]
        end = fused._check_row(S[0], end)
        if not fused.on_cuda(xp, "trial_pair_gram_batched"):
            return trial_pair_gram_batched_ref(xp, d, gp, stp, S, Y, end, live, with_gp)
        fused.check_contiguous("trial_pair_gram_batched", xp, d, gp, stp, live)
        ld = fused.ring_ld("trial_pair_gram_batched", S, Y)
        eg = batched_epilogue_grid(B, n, m, xp.dtype, S.dtype, ld)
        part, gpart = _batched_buffers(xp, eg, m, False, with_gp)
        _launch_epilogue(
            trial_pair_gram_batched, eg, m, xp.dtype, S.dtype, with_gp,
            xp, d, gp, stp, live.view(torch.uint8), S, Y, part, gpart, n, int(end),
            ex=extras, ld=ld, body=block_fn(), W=W, LD_IS_N=ld == n)
        tot = fused.reduce_partials(part, dim=1)
        P = tot[:, 4:].reshape(B, m, 6)
        SP, YP = P[:, :, :3], P[:, :, 3:]
        if with_gp:
            SP, YP = fused.append_gp(SP, YP, fused.reduce_partials(gpart, dim=1))
        return tot[:, 0], tot[:, 1], tot[:, 2], tot[:, 3] > 0, SP, YP

    # ----------------------------------- K8 b: the batched OWL-QN probe

    def _ow_point_batched(xp, d, pg, stp, c, start, end):
        # the instances' projected points, the orthant from (xp, pg)
        wp = choose_orthant(Orthantwise(c, start, end), xp, pg)
        return project_window(xp + stp[:, None] * d, wp, start, end)

    def _ow_eval_batched(xp, d, pg, stp, c, start, end):
        # the instances' projected points, their gradients and fx + c*L1
        # (the L1 sum two-stage under the wide mode, ``fused.l1_batched``)
        x = _ow_point_batched(xp, d, pg, stp, c, start, end)
        fx, g = torch.func.vmap(value_and_grad)(x)
        return x, fused.obj_lift(fx, xp.dtype) + fused.l1_batched(x, start, end) * c, g

    def _ow_probe_batched_plain(xp, d, pg, stp, c, start, end):
        _, ft, g = _ow_eval_batched(xp, d, pg, stp, c, start, end)
        return ft, _dot(g, d)

    def owlqn_probe_pg_batched_ref(xp, d, pg, stp, c, start, end, live):
        """Plain version of ``owlqn_probe_pg_batched``."""
        owlqn_probe_pg_batched_ref.calls += 1
        return _ow_probe_batched_plain(xp, d, pg, stp, c, start, end)

    def owlqn_probe_pg_batched(xp, d, pg, stp, c, start, end, live):
        """K8's pg form over B instances (K8 b): (fx + c*L1 [B], g.d [B]) at
        x = pi(xp[b] + stp[b]*d[b]; wp) for every live instance b, wp
        rebuilt in registers from (xp[b], pg[b]), L1 weight ``c`` on the
        window [start, end) of each instance, writing no vector; a frozen
        instance's values are undefined.  ``xp``, ``d``, ``pg`` [B, n];
        ``stp`` [B] in their dtype and ``live`` [B] bool, on their device.
        On the card an instance's point is ``owlqn_probe_pg``'s on that
        instance alone bit for bit."""
        B = _check_batched("owlqn_probe_pg_batched", xp, live)
        _batched_scalars("owlqn_probe_pg_batched", xp, stp, d, pg)
        start, end = fused._check_window(xp.shape[1], start, end)
        if not fused.on_cuda(xp, "owlqn_probe_pg_batched"):
            return owlqn_probe_pg_batched_ref(xp, d, pg, stp, c, start, end, live)
        fused.check_contiguous("owlqn_probe_pg_batched", xp, d, pg, stp, live)
        n = xp.shape[1]
        grid = (_grid(n)[0], B)
        part = torch.empty((B, grid[0], 3), dtype=xp.dtype, device=xp.device)
        _kernels().owlqn_probe_batched_kernel[grid](
            xp, d, pg, stp, live.view(torch.uint8), part, n, start, end, ex=extras,
            body=block_fn(), ROWS=rows, W=W, **LAUNCH,
        )
        owlqn_probe_pg_batched.launches += 1
        return _ow_scalars_batched(part, c)

    # ---------------------------------- K7 b: the batched OWL-QN trial

    def owlqn_trial_batched_ref(xp, d, pg, stp, c, start, end, live, xt, g):
        """Plain version of ``owlqn_trial_batched``: ``owlqn_probe_pg_batched_ref``'s
        point and evaluation."""
        owlqn_trial_batched_ref.calls += 1
        x, ft, gt = _ow_eval_batched(xp, d, pg, stp, c, start, end)
        out = (ft, _dot(gt, d), _dot(x, x), (x != xp).any(dim=1))
        _write_live(live, (xt, x), (g, gt))
        return out

    def owlqn_trial_batched(xp, d, pg, stp, c, start, end, live, xt, g):
        """K7 over B instances (K7 b): for every live instance b the
        projected trial point x = pi(xp[b] + stp[b]*d[b]; wp), wp rebuilt
        from (xp[b], pg[b]) as ``owlqn_probe_pg_batched`` rebuilds it,
        written to xt[b] and its gradient to g[b], with the [B] sums fx +
        c*L1 (L1 weight ``c`` on the window [start, end) of each
        instance), g.d, x.x and changed.  Operands as
        ``trial_batched``'s, with ``pg`` [B, n].  With stp = 0 and pg = xp
        the projection is the identity (the wide init's evaluation of x0).
        A frozen instance's rows are never written, and its sums are
        undefined.  On the card an instance's point and gradient equal
        ``owlqn_trial``'s with wp = ``choose_orthant(xp[b], pg[b])`` on
        that instance alone bit for bit, and its (ft, g.d)
        ``owlqn_probe_pg_batched``'s at the same step (both modes of the
        objective scalar).  Returns (ft, g.d, x.x, changed)."""
        B = _check_batched("owlqn_trial_batched", xp, live)
        _batched_scalars("owlqn_trial_batched", xp, stp, d, pg, xt, g)
        start, end = fused._check_window(xp.shape[1], start, end)
        if not fused.on_cuda(xp, "owlqn_trial_batched"):
            return owlqn_trial_batched_ref(xp, d, pg, stp, c, start, end, live, xt, g)
        fused.check_contiguous("owlqn_trial_batched", xp, d, pg, stp, live, xt, g)
        n = xp.shape[1]
        grid = (_grid(n)[0], B)
        ppart = torch.empty((B, grid[0], 3), dtype=xp.dtype, device=xp.device)
        part = torch.empty((B, grid[0], 2), dtype=xp.dtype, device=xp.device)
        owlqn_trial_batched.compiled[xp.dtype] = _kernels().owlqn_trial_batched_kernel[grid](
            xp, d, pg, stp, live.view(torch.uint8), xt, g, ppart, part, n, start, end,
            ex=extras, body=block_fn(), ROWS=rows, W=W, **LAUNCH,
        )
        owlqn_trial_batched.launches += 1
        tot = fused.reduce_partials(part, dim=1)
        return (*_ow_scalars_batched(ppart, c), tot[:, 0], tot[:, 1] > 0)

    # ------------------------------------------- K8 OWL-QN probe

    def _ow_eval(xp, d, wp, stp, c, start, end):
        """(x, fx, L1, g) at the projected trial point, fx and the window's
        sum |x| the shard's (not summed over the mesh)."""
        x = project_window(xp + float(stp) * d, wp, start, end)
        fx, g = _evaluate(x)
        return x, fused.obj_lift(fx, x.dtype), x1sum(Orthantwise(c, start, end), x), g

    # ------------------------------------------- K7 OWL-QN trial

    def owlqn_trial_ref(xp, d, wp, stp, c, start, end):
        """Plain version of ``owlqn_trial``
        (``lbfgs_tpu/ops/factory.py:579-590``)."""
        owlqn_trial_ref.calls += 1
        x, fx, l1, g = _ow_eval(xp, d, wp, stp, c, start, end)
        fx, l1, dg, xx, changed = fused.mesh_sum(fx, l1, torch.dot(g, d), torch.dot(x, x),
                                                 torch.any(x != xp))
        return x, fx + l1 * c, g, dg, xx, changed

    def owlqn_trial(xp, d, wp, stp, c, start, end):
        """(x, fx + c*L1, g, g.d, x.x, changed) at x = pi(xp + stp*d; wp)
        inside the window [start, end), from one pass.  Its ft equals
        ``owlqn_probe``'s at the same step and orthant, bit for bit."""
        off, ex = _check(xp)
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
            xp, d, wp, _scalar(stp, xp), x, g, ppart, part, n, lo, hi, off, ex=ex, SHARD=off != 0,
            body=block_fn(), ROWS=rows, W=W, **LAUNCH,
        )
        owlqn_trial.launches += 1
        tot = fused.reduce_partials(part)
        ft, dg, xx, changed = _ow_probe_scalars(ppart, c, tot[0], tot[1] > 0)
        return x, ft, g, dg, xx, changed

    def owlqn_probe_ref(xp, d, wp, stp, c, start, end):
        """Plain version of ``owlqn_probe``."""
        owlqn_probe_ref.calls += 1
        _, fx, l1, g = _ow_eval(xp, d, wp, stp, c, start, end)
        fx, l1, dg = fused.mesh_sum(fx, l1, torch.dot(g, d))
        return fx + l1 * c, dg

    def _ow_probe_pg_plain(xp, d, pg, stp, c, start, end):
        # the shard's (fx, L1, g.d), not summed over the mesh
        wp = choose_orthant(Orthantwise(c, start, end), xp, pg)
        _, fx, l1, g = _ow_eval(xp, d, wp, stp, c, start, end)
        return fx, l1, torch.dot(g, d)

    def owlqn_probe_pg_ref(xp, d, pg, stp, c, start, end):
        """Plain version of ``owlqn_probe_pg``."""
        owlqn_probe_pg_ref.calls += 1
        fx, l1, dg = fused.mesh_sum(*_ow_probe_pg_plain(xp, d, pg, stp, c, start, end))
        return fx + l1 * c, dg

    def _ow_probe(xp, d, w, stp, c, start, end, wp_is_pg, off, ex):
        fused.check_contiguous("owlqn_probe", xp, d, w)
        n = xp.shape[0]
        lo, hi = _window(n, start, end)
        grid = _grid(n)
        part = torch.empty((grid[0], 3), dtype=xp.dtype, device=xp.device)
        _kernels().owlqn_probe_kernel[grid](
            xp, d, w, _scalar(stp, xp), part, n, lo, hi, off, ex=ex, SHARD=off != 0,
            body=block_fn(), ROWS=rows, W=W, WP_IS_PG=wp_is_pg, **LAUNCH,
        )
        return _ow_probe_scalars(part, c)

    def owlqn_probe(xp, d, wp, stp, c, start, end):
        """(fx + c*L1, g.d) at x = pi(xp + stp*d; wp) inside the window
        [start, end), writing no vector."""
        off, ex = _check(xp)
        if not fused.on_cuda(xp, "owlqn_probe"):
            return owlqn_probe_ref(xp, d, wp, stp, c, start, end)
        out = _ow_probe(xp, d, wp, stp, c, start, end, False, off, ex)
        owlqn_probe.launches += 1
        return out

    def owlqn_probe_pg(xp, d, pg, stp, c, start, end):
        """``owlqn_probe`` with the orthant rebuilt in registers from
        (xp, pg) by ``choose_orthant``'s formula: the same scalars, bit
        for bit, without the orthant vector."""
        off, ex = _check(xp)
        if not fused.on_cuda(xp, "owlqn_probe_pg"):
            return owlqn_probe_pg_ref(xp, d, pg, stp, c, start, end)
        out = _ow_probe(xp, d, pg, stp, c, start, end, True, off, ex)
        owlqn_probe_pg.launches += 1
        return out

    # ------------------- K2 s, K8 s: the speculative search's K-lane probes

    def _lanes(kernel: str, stps, like: torch.Tensor) -> torch.Tensor:
        # the lanes' steps (a host sequence) as a [K] tensor on like's device
        stp = torch.as_tensor(stps, dtype=like.dtype).reshape(-1)
        if stp.numel() < 1:
            raise ValueError(f"{kernel}: no steps")
        return fused.to_device(stp, like)

    def probe_steps_ref(xp, d, stps):
        """Plain version of ``probe_steps``: ``probe_ref``'s evaluation at each
        step in turn."""
        probe_steps_ref.calls += 1
        (fx,) = fused.mesh_sum(torch.stack([_probe_plain(xp, d, s)[0] for s in stps]))
        return fx

    def probe_steps(xp, d, stps):
        """K2 s: the [K] objective values fx(xp + stps[k]*d) of K steps
        (a host sequence in the vectors' dtype) from one pass over xp and d
        (several launches above ``SPEC_MAX_LANES`` steps), each lane equal
        to ``probe``'s fx at its step bit for bit; on a mesh the lanes' sums
        are added over the ranks in one collective."""
        off, ex = _check(xp)
        if not fused.on_cuda(xp, "probe_steps"):
            return probe_steps_ref(xp, d, stps)
        fused.check_contiguous("probe_steps", xp, d)
        n = xp.shape[0]
        grid = _grid(n)
        stp = _lanes("probe_steps", stps, xp)
        K = stp.shape[0]
        part = torch.empty((grid[0], K), dtype=xp.dtype, device=xp.device)
        for k0, kc in spec_chunks(K):
            probe_steps.compiled[(xp.dtype, kc)] = _kernels().probe_steps_kernel[grid](
                xp, d, stp[k0:], part[:, k0:], K, n, off, ex=ex, SHARD=off != 0,
                body=block_fn(), ROWS=rows, W=W, K=kc, **LAUNCH,
            )
            probe_steps.launches += 1
            probe_steps.lanes += kc
        (fx,) = fused.mesh_sum(_lane_sums(part))
        return fx

    def owlqn_probe_steps_ref(xp, d, wp, stps, c, start, end):
        """Plain version of ``owlqn_probe_steps``: ``owlqn_probe_ref``'s
        evaluation at each step in turn."""
        owlqn_probe_steps_ref.calls += 1
        lanes = [_ow_eval(xp, d, wp, s, c, start, end)[1:3] for s in stps]
        return _ow_lanes_total(torch.stack([f for f, _ in lanes]),
                               torch.stack([l1 for _, l1 in lanes]), c)

    def owlqn_probe_steps(xp, d, wp, stps, c, start, end):
        """K8 s: the [K] values fx + c*L1 at x = pi(xp + stps[k]*d; wp)
        inside the window [start, end) from one pass, each lane equal to
        ``owlqn_probe``'s ft at its step bit for bit; on a mesh one
        collective for all lanes."""
        off, ex = _check(xp)
        if not fused.on_cuda(xp, "owlqn_probe_steps"):
            return owlqn_probe_steps_ref(xp, d, wp, stps, c, start, end)
        fused.check_contiguous("owlqn_probe_steps", xp, d, wp)
        n = xp.shape[0]
        lo, hi = _window(n, start, end)
        grid = _grid(n)
        stp = _lanes("owlqn_probe_steps", stps, xp)
        K = stp.shape[0]
        part = torch.empty((grid[0], K, 2), dtype=xp.dtype, device=xp.device)
        for k0, kc in spec_chunks(K):
            owlqn_probe_steps.compiled[(xp.dtype, kc)] = _kernels().owlqn_probe_steps_kernel[grid](
                xp, d, wp, stp[k0:], part[:, k0:], 2 * K, n, lo, hi, off, ex=ex,
                SHARD=off != 0, body=block_fn(), ROWS=rows, W=W, K=kc, **LAUNCH,
            )
            owlqn_probe_steps.launches += 1
            owlqn_probe_steps.lanes += kc
        fl = _lane_sums(part.view(grid[0], 2 * K)).view(K, 2)
        return _ow_lanes_total(fl[:, 0], fl[:, 1], c)

    def _check_steps(kernel: str, xp: torch.Tensor, stps: torch.Tensor) -> int:
        if (stps.ndim != 2 or stps.shape[0] != xp.shape[0] or stps.shape[1] < 1
                or stps.dtype != xp.dtype or stps.device != xp.device
                or stps.stride(1) != 1):
            raise ValueError(f"{kernel}: stps must be a [B, K] tensor of the iterates' dtype "
                             f"on their device, each row contiguous")
        return stps.shape[1]

    def probe_steps_batched_ref(xp, d, stps, live):
        """Plain version of ``probe_steps_batched``: ``probe_batched_ref``'s
        evaluation at each lane's steps in turn."""
        probe_steps_batched_ref.calls += 1
        return torch.stack([_probe_batched_plain(xp, d, stps[:, k])[0]
                            for k in range(stps.shape[1])], dim=1)

    def probe_steps_batched(xp, d, stps, live):
        """K2 s over B instances (K2 b s): the [B, K] objective values at
        xp[b] + stps[b, k]*d[b] for every live instance b from one pass over
        its xp and d, each equal to ``probe_batched``'s fx at that step bit
        for bit; a frozen instance's values are undefined."""
        B = _check_batched("probe_steps_batched", xp, live)
        K = _check_steps("probe_steps_batched", xp, stps)
        _batched_scalars("probe_steps_batched", xp, stps[:, 0], d)
        if not fused.on_cuda(xp, "probe_steps_batched"):
            return probe_steps_batched_ref(xp, d, stps, live)
        fused.check_contiguous("probe_steps_batched", xp, d, live)
        n = xp.shape[1]
        grid = (_grid(n)[0], B)
        part = torch.empty((B, grid[0], K), dtype=xp.dtype, device=xp.device)
        for k0, kc in spec_chunks(K):
            probe_steps_batched.compiled[(xp.dtype, kc)] = \
                _kernels().probe_steps_batched_kernel[grid](
                    xp, d, stps[:, k0:], stps.stride(0), live.view(torch.uint8),
                    part[:, :, k0:], K, n, ex=extras, body=block_fn(), ROWS=rows, W=W, K=kc,
                    **LAUNCH,
                )
            probe_steps_batched.launches += 1
            probe_steps_batched.lanes += kc * B
        return _lane_sums(part, dim=1)

    def owlqn_probe_pg_steps_batched_ref(xp, d, pg, stps, c, start, end, live):
        """Plain version of ``owlqn_probe_pg_steps_batched``:
        ``owlqn_probe_pg_batched_ref``'s evaluation at each lane's steps in
        turn."""
        owlqn_probe_pg_steps_batched_ref.calls += 1
        return torch.stack([_ow_probe_batched_plain(xp, d, pg, stps[:, k], c, start, end)[0]
                            for k in range(stps.shape[1])], dim=1)

    def owlqn_probe_pg_steps_batched(xp, d, pg, stps, c, start, end, live):
        """K8's pg form over B instances at K steps each (K8 b s): the
        [B, K] values fx + c*L1 at pi(xp[b] + stps[b, k]*d[b]; wp), wp
        rebuilt from (xp[b], pg[b]), each equal to
        ``owlqn_probe_pg_batched``'s ft at that step bit for bit; a frozen
        instance's values are undefined."""
        B = _check_batched("owlqn_probe_pg_steps_batched", xp, live)
        K = _check_steps("owlqn_probe_pg_steps_batched", xp, stps)
        _batched_scalars("owlqn_probe_pg_steps_batched", xp, stps[:, 0], d, pg)
        start, end = fused._check_window(xp.shape[1], start, end)
        if not fused.on_cuda(xp, "owlqn_probe_pg_steps_batched"):
            return owlqn_probe_pg_steps_batched_ref(xp, d, pg, stps, c, start, end, live)
        fused.check_contiguous("owlqn_probe_pg_steps_batched", xp, d, pg, live)
        n = xp.shape[1]
        grid = (_grid(n)[0], B)
        part = torch.empty((B, grid[0], K, 2), dtype=xp.dtype, device=xp.device)
        for k0, kc in spec_chunks(K):
            owlqn_probe_pg_steps_batched.compiled[(xp.dtype, kc)] = \
                _kernels().owlqn_probe_steps_batched_kernel[grid](
                    xp, d, pg, stps[:, k0:], stps.stride(0), live.view(torch.uint8),
                    part[:, :, k0:], 2 * K, n, start, end, ex=extras, body=block_fn(),
                    ROWS=rows, W=W, K=kc, **LAUNCH,
                )
            owlqn_probe_pg_steps_batched.launches += 1
            owlqn_probe_pg_steps_batched.lanes += kc * B
        fl = _lane_sums(part.view(B, grid[0], 2 * K), dim=1).view(B, K, 2)
        return fl[..., 0] + fl[..., 1] * c

    # ------------------------ K14 OWL-QN trial + pseudo-gradient + pair + Gram

    def owlqn_trial_pair_gram_ref(xp, d, gp, pg, stp, c, start, end_w, S, Y, end,
                                  inplace=False, with_gp=False):
        """Plain version of ``owlqn_trial_pair_gram``."""
        owlqn_trial_pair_gram_ref.calls += 1
        ow = Orthantwise(c, start, end_w)
        x, _, _, g = _ow_eval(xp, d, choose_orthant(ow, xp, pg), stp, c, start, end_w)
        pg_new = pseudo_gradient(ow, x, g)
        SP, YP = fused.pair_products(x - xp, g - gp, -pg_new, S, Y, end,
                                     gp=gp if with_gp else None)
        out = (torch.dot(x, x), torch.dot(pg_new, pg_new), torch.any(x != xp))
        if with_gp:
            out += (torch.dot(gp, gp), torch.dot(gp, pg_new))
        SP, YP, *out = fused.mesh_sum(SP, YP, *out)
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
        for bit.  The form is ``solo_epilogue_grid``'s, as
        ``trial_pair_gram``'s."""
        off, ex = _check(xp)
        fused._check_hist(xp, S, Y)
        if not fused.on_cuda(xp, "owlqn_trial_pair_gram"):
            return owlqn_trial_pair_gram_ref(xp, d, gp, pg, stp, c, start, end_w,
                                             S, Y, end, inplace, with_gp)
        fused.check_contiguous("owlqn_trial_pair_gram", xp, d, gp, pg)
        ld = fused.ring_ld("owlqn_trial_pair_gram", S, Y)
        m, n = S.shape
        lo, hi = _window(n, start, end_w)
        eg = solo_epilogue_grid(n, m, xp.dtype, S.dtype, ld)
        x = xp if inplace else torch.empty_like(xp)
        g = gp if inplace else torch.empty_like(gp)
        pg_new = pg if inplace else torch.empty_like(pg)
        bufs = _epilogue_buffers(xp, eg, m, True, with_gp)
        part = bufs["part"]
        gpart = bufs.get("gpart", part)
        _launch_epilogue(owlqn_trial_pair_gram, eg, m, xp.dtype, S.dtype,
                         with_gp, xp, d, gp, pg, _scalar(stp, xp), _scalar(c, xp), x, g, pg_new,
                         S, Y, part, gpart, n, lo, hi, int(end), off=off, ex=ex, ld=ld,
                         SHARD=off != 0, body=block_fn(), W=W, LD_IS_N=ld == n)
        tot = fused.reduce_partials(part)
        sums = (tot[0], tot[1], tot[2] > 0, tot[3:])
        if with_gp:
            sums += (fused.reduce_partials(gpart),)
        xx, pp, changed, P, *G = fused.mesh_sum(*sums)
        P = P.reshape(m, 6)
        if not with_gp:
            return x, g, pg_new, P[:, :3], P[:, 3:], xx, pp, changed
        G = G[0]
        SP, YP = fused.append_gp(P[:, :3], P[:, 3:], G[2:])
        return x, g, pg_new, SP, YP, xx, pp, changed, G[0], G[1]

    # --------------------------- K14 b: the batched OWL-QN epilogue

    def owlqn_trial_pair_gram_batched_ref(xp, d, gp, pg, stp, c, start, end_w, S, Y, end,
                                          live, with_gp=False):
        """Plain version of ``owlqn_trial_pair_gram_batched``."""
        owlqn_trial_pair_gram_batched_ref.calls += 1
        x = _ow_point_batched(xp, d, pg, stp, c, start, end_w)
        _, g = torch.func.vmap(value_and_grad)(x)
        pg_new = pseudo_gradient(Orthantwise(c, start, end_w), x, g)
        SP, YP = fused.pair_products_batched(x - xp, g - gp, -pg_new, S, Y, end, live,
                                        gp if with_gp else None)
        out = (_dot(x, x), _dot(pg_new, pg_new), (x != xp).any(dim=1), SP, YP)
        if with_gp:
            out += (_dot(gp, gp), _dot(gp, pg_new))
        _write_live(live, (xp, x), (gp, g), (pg, pg_new))
        return out

    def owlqn_trial_pair_gram_batched(xp, d, gp, pg, stp, c, start, end_w, S, Y, end, live,
                                      with_gp=False):
        """K14 over B instances (K14 b), in place: for every live instance
        b the accepted point x = pi(xp[b] + stp[b]*d[b]; wp), wp rebuilt
        from (xp[b], pg[b]), written over xp[b], its gradient g over gp[b]
        and its pseudo-gradient pg_new (L1 weight ``c`` on the window
        [start, end_w) of each instance) over pg[b], the pair (x - xp, g -
        gp) written into ring row ``end`` of S[b] and Y[b], rounded to the
        history dtype, and the 6m products SP = S[b].[y, s, -pg_new], YP =
        Y[b].[y, s, -pg_new] over the updated rings, row ``end`` from the
        unrounded pair.  Operands as ``trial_pair_gram_batched``'s, with
        ``pg`` [B, n].  A frozen instance's vectors and ring rows are never
        written, and its outputs are undefined.  Returns (x.x, pg_new.pg_new,
        changed) as [B] tensors and SP, YP [B, m, 3].  ``with_gp=True``
        (damped OWL-QN) appends the . gp column (SP, YP [B, m, 4]) and the
        [B] gp.gp and gp.pg_new to the returns, taken before g overwrites
        gp, as ``owlqn_trial_pair_gram``'s ``with_gp``; every other output
        is that of the plain launch bit for bit.  On the card an instance's
        x, g, pg and ring row equal ``owlqn_trial_pair_gram``'s on that
        instance alone bit for bit, its sums within the sum tolerance; the
        form and the grid are ``batched_epilogue_grid``'s."""
        B = _check_batched("owlqn_trial_pair_gram_batched", xp, live)
        _batched_scalars("owlqn_trial_pair_gram_batched", xp, stp, d, gp, pg)
        fused._check_hist_batched("owlqn_trial_pair_gram_batched", xp, S, Y)
        m, n = S.shape[1], S.shape[2]
        end = fused._check_row(S[0], end)
        start, end_w = fused._check_window(n, start, end_w)
        if not fused.on_cuda(xp, "owlqn_trial_pair_gram_batched"):
            return owlqn_trial_pair_gram_batched_ref(xp, d, gp, pg, stp, c, start, end_w, S, Y,
                                                     end, live, with_gp)
        fused.check_contiguous("owlqn_trial_pair_gram_batched", xp, d, gp, pg, stp, live)
        ld = fused.ring_ld("owlqn_trial_pair_gram_batched", S, Y)
        eg = batched_epilogue_grid(B, n, m, xp.dtype, S.dtype, ld)
        part, gpart = _batched_buffers(xp, eg, m, True, with_gp)
        _launch_epilogue(
            owlqn_trial_pair_gram_batched, eg, m, xp.dtype, S.dtype, with_gp,
            xp, d, gp, pg, stp, _scalar(c, xp), live.view(torch.uint8), S, Y, part, gpart, n,
            start, end_w, int(end), ex=extras, ld=ld, body=block_fn(), W=W, LD_IS_N=ld == n)
        tot = fused.reduce_partials(part, dim=1)
        P = tot[:, 3:].reshape(B, m, 6)
        out = (tot[:, 0], tot[:, 1], tot[:, 2] > 0, P[:, :, :3], P[:, :, 3:])
        if not with_gp:
            return out
        G = fused.reduce_partials(gpart, dim=1)
        SP, YP = fused.append_gp(out[3], out[4], G[:, 2:])
        return (*out[:3], SP, YP, G[:, 0], G[:, 1])

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
        return (r, *fused.mesh_sum(rr, rd, *_probe_plain(x, r, stp1)))

    def _check_combine(kernel, d, x, S, Y):
        shard = _check(x)
        fused._check_hist(d, S, Y)
        if x.shape != d.shape or x.dtype != d.dtype:
            raise ValueError(f"{kernel}: x {x.dtype} {tuple(x.shape)} against the "
                             f"direction's {d.dtype} {tuple(d.shape)}")
        return shard

    def _combine_launch(fn, d, x, S, Y, coefs, stp1, nparts, shard, *args, **consts):
        """Launch K15 or K16 (``fn``, its wrapper), whose combine and probe
        partials are both [programs, nparts] arrays (2 columns for K15, 3
        for K16), on the shard (``shard`` = (off, extras), ``_check``), and
        count the launch (``_count``; K15's ``fix`` form by the constant
        ``FIX``); returns (r, column sums of the combine's partials, the
        probe's partials)."""
        kernel = fn.__name__
        fused.check_contiguous(kernel, d, x)
        ld = fused.ring_ld(kernel, S, Y)
        m, n = S.shape
        off, ex = shard
        grid = _grid(n)
        r = torch.empty_like(d)
        cpart = torch.empty((grid[0], nparts), dtype=d.dtype, device=d.device)
        ppart = torch.empty((grid[0], nparts), dtype=d.dtype, device=d.device)
        # M = m unrolls the rows (the static form), M = 0 loops over them
        # at run time (the deep form, above MAX_M rows)
        deep = m > MAX_M
        compiled = getattr(_kernels(), kernel + "_kernel")[grid](
            d, x, S, Y, fused.coef_vector(d, *coefs), _scalar(stp1, d), r, cpart, ppart,
            n, m, *args, off, ex=ex, ld=ld, SHARD=off != 0, body=block_fn(),
            M=0 if deep else m, ROWS=rows, W=W, LD_IS_N=ld == n, **consts, **LAUNCH,
        )
        flags = {k.lower(): v for k, v in consts.items()}
        if deep:
            fn.deep_compiled[(d.dtype, S.dtype, bool(consts.get("FIX")))] = compiled
        _count(fn, deep, **flags)
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
        g.r).  Above ``MAX_M`` ring rows the deep form runs, with the same
        r and probe, bit for bit."""
        shard = _check_combine("combine_probe", g, x, S, Y)
        if fix is not None:
            fix = (fused._check_row(S, fix[0]), *fix[1:])
        if not fused.on_cuda(g, "combine_probe"):
            return combine_probe_ref(g, x, S, Y, gamma, coef_s, coef_y, stp1, fix)
        coefs = (gamma, coef_s, coef_y) + (() if fix is None else fix[1:])
        r, ctot, ppart = _combine_launch(combine_probe, g, x, S, Y, coefs, stp1, 2, shard,
                                         0 if fix is None else fix[0], FIX=fix is not None)
        ptot = fused.reduce_partials(ppart)
        return (r, *fused.mesh_sum(ctot[0], ctot[1], _fx(ppart, ptot), ptot[1]))

    def combine_ow_probe_ref(pg, x, S, Y, gamma, coef_s, coef_y, c, start, end, stp1):
        """Plain version of ``combine_ow_probe``: ``fused.combine_ow_ref``'s
        arithmetic, then ``owlqn_probe_pg_ref``'s at (x, rc, pg, stp1)
        (``lbfgs_tpu/ops/factory.py:1457-1466``), neither counted."""
        combine_ow_probe_ref.calls += 1
        rc, rr, rc2, rcd = fused.combine_ow_plain(pg, S, Y, gamma, coef_s, coef_y, start, end)
        rr, rc2, rcd, fx, l1, dg = fused.mesh_sum(
            rr, rc2, rcd, *_ow_probe_pg_plain(x, rc, pg, stp1, c, start, end))
        return rc, rr, rc2, rcd, fx + l1 * c, dg

    def combine_ow_probe(pg, x, S, Y, gamma, coef_s, coef_y, c, start, end, stp1):
        """OWL-QN's combine with the direction constraint
        (``fused.combine_ow``'s function: rc = pi(r; -pg) inside [start,
        end), r.r before the constraint, rc.rc, rc.pg) and the next
        search's first probe at pi(x + stp1*rc; wp), wp rebuilt from (x,
        pg), with fx + c*L1 and g.rc, from one pass (K16).  The probe's
        scalars equal ``owlqn_probe_pg(x, rc, pg, stp1, c, start, end)``'s
        bit for bit.  Returns (rc, r.r, rc.rc, rc.pg, ft, g.rc)."""
        shard = _check_combine("combine_ow_probe", pg, x, S, Y)
        start, end = fused._check_window(x.shape[0], start, end)
        if not fused.on_cuda(pg, "combine_ow_probe"):
            return combine_ow_probe_ref(pg, x, S, Y, gamma, coef_s, coef_y, c, start, end, stp1)
        rc, ctot, ppart = _combine_launch(combine_ow_probe, pg, x, S, Y,
                                          (gamma, coef_s, coef_y), stp1, 3, shard,
                                          *fused.local_window(start, end, x.shape[0]))
        ft, dg, rr, rc2, rcd = _ow_probe_scalars(ppart, c, ctot[0], ctot[1], ctot[2])
        return rc, rr, rc2, rcd, ft, dg

    def combine_probe_ok(x, S) -> bool:
        """Whether K15 and K16 take these operands: the shapes and dtypes
        of ``lbfgs_tpu/ops/factory.py:1332-1341`` at any depth (the deep
        forms above ``MAX_M`` rows), and n a multiple of W (else the ring
        rows after the first lose the vectors' alignment, their loads
        narrow, and the probe's sums would not be K2's and K8's bit for
        bit; the unfused path takes such an n, as the JAX package's kernels
        take no n off its 128 lanes)."""
        try:
            _check(x)
        except (TypeError, ValueError):
            return False
        return fused.can_combine(x, S) and x.shape[0] % W == 0

    # --------------------- K15 b / K16 b: the batched combine + probe

    def combine_probe_batched_ok(x, S) -> bool:
        """``combine_probe_ok`` for a batch: its test on instance 0 of x
        [B, n] and the rings S [B, m, n] (the instances share n and m)."""
        return x.ndim == 2 and S.ndim == 3 and combine_probe_ok(x[0], S[0])

    def _check_combine_batched(kernel, d, x, S, Y, coef, stp1, live, out, fix=False):
        _check_batched(kernel, x, live)
        fused._check_combine_batched(kernel, d, S, Y, coef, live, out, fix)
        _batched_scalars(kernel, x, stp1, d)

    def _combine_batched_launch(fn, d, x, S, Y, coef, stp1, live, out, nparts, *args,
                                **consts):
        """Launch K15 b or K16 b (``fn``, its wrapper), M = m up to
        ``MAX_M`` rows and M = 0 (the deep form) above, and count the launch
        (``_count``; K15 b's ``fix`` form by the constant ``FIX``); returns
        the [B, nparts] column sums of the combine's [B, programs, nparts]
        partials and the probe's partials themselves."""
        kernel = fn.__name__
        fused.check_contiguous(kernel, d, x, coef, stp1, live, out)
        ld = fused.ring_ld(kernel, S, Y)
        B, m, n = S.shape
        grid = (_grid(n)[0], B)
        cpart = torch.empty((B, grid[0], nparts), dtype=d.dtype, device=d.device)
        ppart = torch.empty((B, grid[0], nparts), dtype=d.dtype, device=d.device)
        deep = m > MAX_M
        key = (d.dtype, S.dtype, deep, *consts.values())
        fn.compiled[key] = getattr(_kernels(), kernel + "_kernel")[grid](
            d, x, S, Y, coef, stp1, live.view(torch.uint8), out, cpart, ppart, n, m, *args,
            ex=extras, ld=ld, body=block_fn(), M=0 if deep else m, ROWS=rows, W=W,
            LD_IS_N=ld == n, **consts, **LAUNCH)
        _count(fn, deep, **{k.lower(): v for k, v in consts.items()})
        return fused.reduce_partials(cpart, dim=1), ppart

    def combine_probe_batched_ref(g, x, S, Y, coef, stp1, live, out, fix=None):
        """Plain version of ``combine_probe_batched``: K3 b's plain
        arithmetic (with ``fix``, K6 b's), then K2 b's at x + stp1*r, so
        that a fused run on the CPU is its unfused run bit for bit."""
        combine_probe_batched_ref.calls += 1
        m = S.shape[1]
        r = fused._combination_batched(g, S, Y, coef[:, :1 + 2 * m])
        if fix is not None:
            fused.fix_row_batched(g, Y, coef, fix, live)
        out[live] = r[live]
        return (_dot(r, r), _dot(r, g), *_probe_batched_plain(x, r, stp1))

    def combine_probe_batched(g, x, S, Y, coef, stp1, live, out, fix=None):
        """K15 over B instances (K15 b): for each live instance b, K3 b's
        r = coef[b, 0]*g[b] + coef[b, 1:m+1] @ S[b] + coef[b, m+1:] @ Y[b]
        written to out[b], with r.r and r.g, and the instance's next first
        probe (ft, g(xt).r) at xt = x[b] + stp1[b]*r, from one pass.
        ``g``, ``x``, ``out`` [B, n]; ``S``, ``Y`` [B, m, n]; ``coef`` [B,
        2m + 1] and ``stp1`` [B] in g's dtype; ``live`` [B] bool.  A frozen
        instance's row of ``out`` is never written, and its sums are
        undefined.  Returns (r.r, r.g, ft, g.r) as [B] tensors.  On the card
        an instance's r equals ``combine_probe``'s (and ``fused.combine``'s)
        on that instance alone bit for bit, and so does its probe's (ft,
        g.r) ``probe(x[b], r, stp1[b])``'s.  Above ``MAX_M`` ring rows the
        deep form runs (M = 0), with the same r and probe.  ``fix`` = end,
        the ring row the live instances share, with ``coef`` [B, 2m + 3]
        ending in (ca, cb), adds ``fused.combine_fix_batched``'s damped
        row: Y[b, end] <- round(ca*Y[b, end] + cb*g[b]) in place, after
        the row is read (counted in ``.fix_launches`` too); an instance's
        row equals the solo fix form's (and ``fused.combine_fix``'s) bit for
        bit."""
        _check_combine_batched("combine_probe_batched", g, x, S, Y, coef, stp1, live, out,
                               fix is not None)
        if fix is not None:
            fix = fused._check_row(S[0], fix)
        if not fused.on_cuda(g, "combine_probe_batched"):
            return combine_probe_batched_ref(g, x, S, Y, coef, stp1, live, out, fix)
        ctot, ppart = _combine_batched_launch(combine_probe_batched, g, x, S, Y, coef, stp1, live,
                                              out, 2, 0 if fix is None else fix,
                                              FIX=fix is not None)
        ptot = fused.reduce_partials(ppart, dim=1)
        return ctot[:, 0], ctot[:, 1], _fx_batched(ppart, ptot), ptot[:, 1]

    def combine_ow_probe_batched_ref(pg, x, S, Y, coef, c, start, end, stp1, live, out):
        """Plain version of ``combine_ow_probe_batched``: K13 b's plain
        arithmetic, then K8 b's at (x, rc, pg, stp1)."""
        combine_ow_probe_batched_ref.calls += 1
        r = fused._combination_batched(pg, S, Y, coef)
        rc = project_window(r, -pg, start, end)
        out[live] = rc[live]
        return (_dot(r, r), _dot(rc, rc), _dot(rc, pg),
                *_ow_probe_batched_plain(x, rc, pg, stp1, c, start, end))

    def combine_ow_probe_batched(pg, x, S, Y, coef, c, start, end, stp1, live, out):
        """K16 over B instances (K16 b): for each live instance b, K13 b's
        rc (r over pg[b] constrained to the orthant of -pg[b] inside the
        window [start, end) of each instance) written to out[b], with r.r,
        rc.rc and rc.pg, and the instance's next first probe at pi(x[b] +
        stp1[b]*rc; wp), wp rebuilt from (x[b], pg[b]), with fx + c*L1 and
        g.rc, from one pass.  Operands as ``combine_probe_batched``'s, pg
        in g's place.  Returns (r.r, rc.rc, rc.pg, ft, g.rc) as [B]
        tensors.  On the card an instance's rc equals ``combine_ow_probe``'s
        (and ``fused.combine_ow``'s) on that instance alone bit for bit, and
        so does its probe's ``owlqn_probe_pg``'s."""
        _check_combine_batched("combine_ow_probe_batched", pg, x, S, Y, coef, stp1, live, out)
        start, end = fused._check_window(x.shape[1], start, end)
        if not fused.on_cuda(pg, "combine_ow_probe_batched"):
            return combine_ow_probe_batched_ref(pg, x, S, Y, coef, c, start, end, stp1, live,
                                                out)
        ctot, ppart = _combine_batched_launch(combine_ow_probe_batched, pg, x, S, Y, coef, stp1,
                                              live, out, 3, start, end)
        return (ctot[:, 0], ctot[:, 1], ctot[:, 2], *_ow_scalars_batched(ppart, c))

    batched_fusions = (combine_probe_batched, combine_ow_probe_batched)
    # the K-lane probes: their launches (one per chunk of at most
    # SPEC_MAX_LANES lanes), the lanes they evaluated (instance-lanes in
    # the batched forms) and their compiled kernels per (dtype, lanes)
    lane_probes = (probe_steps, owlqn_probe_steps, probe_steps_batched,
                   owlqn_probe_pg_steps_batched)
    for fn in lane_probes:
        fn.launches, fn.lanes, fn.compiled = 0, 0, {}
    for fn in (probe_steps_ref, owlqn_probe_steps_ref, probe_steps_batched_ref,
               owlqn_probe_pg_steps_batched_ref):
        fn.calls = 0
    for fn in (trial, probe, trial_pair_gram, owlqn_trial, owlqn_probe, owlqn_probe_pg,
               owlqn_trial_pair_gram, combine_probe, combine_ow_probe, probe_batched,
               trial_pair_gram_batched, owlqn_probe_pg_batched, owlqn_trial_pair_gram_batched,
               trial_batched, owlqn_trial_batched, *batched_fusions):
        fn.launches = 0
    # the deep forms of K4, K14, K15 and K16 and of their batched forms,
    # the . gp (damped) specialisations of K4 and K14 and K15's damped-row
    # form, and theirs of K4 b, K14 b and K15 b, counted apart too
    # (``_count``)
    for fn in (trial_pair_gram, owlqn_trial_pair_gram, combine_probe, combine_ow_probe,
               trial_pair_gram_batched, owlqn_trial_pair_gram_batched, *batched_fusions):
        fn.deep_launches = 0
    for fn in (trial_pair_gram, owlqn_trial_pair_gram, trial_pair_gram_batched,
               owlqn_trial_pair_gram_batched):
        fn.gp_launches = fn.deep_gp_launches = 0
    for fn in (combine_probe, combine_probe_batched):
        fn.fix_launches = fn.deep_fix_launches = 0
    # the epilogues' last compiled Triton kernel per (vector dtype, history
    # dtype, with_gp), the static forms' and the deep forms' apart, the
    # batched epilogues' too: their registers, spills and PTX
    for fn in (trial_pair_gram, owlqn_trial_pair_gram, trial_pair_gram_batched,
               owlqn_trial_pair_gram_batched):
        fn.compiled, fn.deep_compiled = {}, {}
    # the epilogues' tensor-core forms: their launches, compiled kernels,
    # and each launch's form and geometry (``solo_epilogue_grid``,
    # ``batched_epilogue_grid``)
    for fn in (trial_pair_gram, owlqn_trial_pair_gram, trial_pair_gram_batched,
               owlqn_trial_pair_gram_batched):
        fn.mma_launches, fn.mma_compiled, fn.last_form = 0, {}, None
    # the epilogues' tensor-core row-block form (``"mma_rows"``)
    for fn in (trial_pair_gram, owlqn_trial_pair_gram, trial_pair_gram_batched,
               owlqn_trial_pair_gram_batched):
        fn.mma_rows_launches, fn.mma_rows_compiled = 0, {}
    # the fusions' deep forms per (vector dtype, history dtype, fix), and
    # the batched fusions' forms per (vector dtype, history dtype, deep,
    # and for K15 b fix)
    combine_probe.deep_compiled, combine_ow_probe.deep_compiled = {}, {}
    for fn in batched_fusions:
        fn.compiled = {}
    # K1 b's and K7 b's compiled kernels per vector dtype
    trial_batched.compiled, owlqn_trial_batched.compiled = {}, {}
    for fn in (trial_ref, probe_ref, trial_pair_gram_ref, owlqn_trial_ref, owlqn_probe_ref,
               owlqn_probe_pg_ref, owlqn_trial_pair_gram_ref, combine_probe_ref,
               combine_ow_probe_ref, probe_batched_ref, trial_pair_gram_batched_ref,
               owlqn_probe_pg_batched_ref, owlqn_trial_pair_gram_batched_ref,
               combine_probe_batched_ref, combine_ow_probe_batched_ref, trial_batched_ref,
               owlqn_trial_batched_ref):
        fn.calls = 0

    ns = SimpleNamespace(
        extras=extras,
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
        probe_batched=probe_batched, probe_batched_ref=probe_batched_ref,
        trial_pair_gram_batched=trial_pair_gram_batched,
        trial_pair_gram_batched_ref=trial_pair_gram_batched_ref,
        owlqn_probe_pg_batched=owlqn_probe_pg_batched,
        owlqn_probe_pg_batched_ref=owlqn_probe_pg_batched_ref,
        owlqn_trial_pair_gram_batched=owlqn_trial_pair_gram_batched,
        owlqn_trial_pair_gram_batched_ref=owlqn_trial_pair_gram_batched_ref,
        combine_probe_batched=combine_probe_batched,
        combine_probe_batched_ref=combine_probe_batched_ref,
        combine_probe_batched_ok=combine_probe_batched_ok,
        combine_ow_probe_batched=combine_ow_probe_batched,
        combine_ow_probe_batched_ref=combine_ow_probe_batched_ref,
        trial_batched=trial_batched, trial_batched_ref=trial_batched_ref,
        owlqn_trial_batched=owlqn_trial_batched,
        owlqn_trial_batched_ref=owlqn_trial_batched_ref,
        probe_steps=probe_steps, probe_steps_ref=probe_steps_ref,
        owlqn_probe_steps=owlqn_probe_steps, owlqn_probe_steps_ref=owlqn_probe_steps_ref,
        probe_steps_batched=probe_steps_batched, probe_steps_batched_ref=probe_steps_batched_ref,
        owlqn_probe_pg_steps_batched=owlqn_probe_pg_steps_batched,
        owlqn_probe_pg_steps_batched_ref=owlqn_probe_pg_steps_batched_ref,
    )

    def vag(x):
        """(fx, g) at x; on a mesh x is this rank's shard, g the shard's
        gradient and fx the whole objective (one collective)."""
        if fused.active_mesh() is None:
            return value_and_grad(x)
        fx, g = _evaluate(x)
        return (*fused.mesh_sum(fx), g)

    def plain(x):
        return vag(x)

    _attach(vag, trial, probe, trial_pair_gram, trial_pair_gram_ok, owlqn_trial,
            owlqn_probe, owlqn_probe_pg, owlqn_trial_pair_gram,
            fused.combine, fused.combine_fix, fused.combine_ow,
            fused.pseudo_gradient_norm, fused.pseudo_gradient,
            combine_probe, combine_ow_probe, combine_probe_ok)
    _attach_batched(vag, probe_batched, trial_pair_gram_batched, fused.combine_batched,
                    fused.combine_fix_batched, owlqn_probe_pg_batched,
                    owlqn_trial_pair_gram_batched, fused.combine_ow_batched,
                    fused.pseudo_gradient_norm_batched, combine_probe_batched,
                    combine_ow_probe_batched, combine_probe_batched_ok, trial_batched,
                    owlqn_trial_batched)
    _attach(plain, trial_ref, probe_ref, trial_pair_gram_ref, trial_pair_gram_ok,
            owlqn_trial_ref, owlqn_probe_ref, owlqn_probe_pg_ref, owlqn_trial_pair_gram_ref,
            fused.combine_ref, fused.combine_fix_ref, fused.combine_ow_ref,
            fused.pseudo_gradient_norm_ref, fused.pseudo_gradient_ref,
            combine_probe_ref, combine_ow_probe_ref, combine_probe_ok)
    _attach_batched(plain, probe_batched_ref, trial_pair_gram_batched_ref,
                    fused.combine_batched_ref, fused.combine_fix_batched_ref,
                    owlqn_probe_pg_batched_ref, owlqn_trial_pair_gram_batched_ref,
                    fused.combine_ow_batched_ref, fused.pseudo_gradient_norm_batched_ref,
                    combine_probe_batched_ref, combine_ow_probe_batched_ref,
                    combine_probe_batched_ok, trial_batched_ref, owlqn_trial_batched_ref)
    _attach_speculative(vag, probe_steps, owlqn_probe_steps, probe_steps_batched,
                        owlqn_probe_pg_steps_batched)
    _attach_speculative(plain, probe_steps_ref, owlqn_probe_steps_ref, probe_steps_batched_ref,
                        owlqn_probe_pg_steps_batched_ref)
    vag.kernels = plain.kernels = ns
    vag.plain = plain
    return vag


def _synthesized(block_ref, extras: tuple, row: int):
    """The plain evaluation built from the body's torch twin over the whole
    vector (``lbfgs_tpu/ops/factory.py:85-105``)."""
    def value_and_grad(x):
        return _block_eval(block_ref, x, 0, extras, row)

    return value_and_grad


def _block_eval(block_ref, x: torch.Tensor, off: int, extras: tuple, row: int):
    """The body's torch twin in one call on the [n // row, row] views of x,
    its global indices (``off`` + the local ones) and the extras, the
    objective's terms summed by ``fused.obj_sum``."""
    gidx = (torch.arange(x.shape[0], device=x.device) + off).view(-1, row)
    fe, g = block_ref(x.view(-1, row), gidx, *(e.view(-1, row) for e in extras))
    return fused.obj_sum(fe.reshape(-1)), g.reshape(-1)


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


def _attach_batched(obj, probe, tpg, combine, combine_fix, ow_probe_pg, ow_tpg, combine_ow,
                    pg_norm, cp, cp_ow, cp_ok, trial, ow_trial) -> None:
    """The batched runner's protocol (``batched.minimize_batched``): K2 b,
    K4 b and K3 b (K6 b damped), and under OWL-QN K8 b, K14 b, K13 b and
    K10 b; with the step uncapped the fusions K15 b and K16 b; the trials
    K1 b and K7 b, which materialize the accepted points where no batched
    epilogue runs and evaluate the wide init."""
    obj.__lbfgs_trial_batched__ = trial
    obj.__lbfgs_owlqn_trial_batched__ = ow_trial
    obj.__lbfgs_probe_batched__ = probe
    obj.__lbfgs_trial_pair_gram_batched__ = tpg
    obj.__lbfgs_combine_batched__ = combine
    obj.__lbfgs_combine_fix_batched__ = combine_fix
    obj.__lbfgs_owlqn_probe_pg_batched__ = ow_probe_pg
    obj.__lbfgs_owlqn_trial_pair_gram_batched__ = ow_tpg
    obj.__lbfgs_combine_ow_batched__ = combine_ow
    obj.__lbfgs_pseudo_gradient_norm_batched__ = pg_norm
    obj.__lbfgs_combine_probe_batched__ = cp
    obj.__lbfgs_combine_probe_batched_ok__ = cp_ok
    obj.__lbfgs_combine_ow_probe_batched__ = cp_ow
    # K16 b takes the same shapes and dtypes as K15 b
    obj.__lbfgs_combine_ow_probe_batched_ok__ = cp_ok


def _attach_speculative(obj, probe_steps, ow_probe_steps, probe_steps_batched,
                        ow_probe_steps_batched) -> None:
    """The speculative search's candidate passes: K2 s and K8 s, and over a
    batch K2 b s and K8 b s (the pg form)."""
    obj.__lbfgs_probe_steps__ = probe_steps
    obj.__lbfgs_owlqn_probe_steps__ = ow_probe_steps
    obj.__lbfgs_probe_steps_batched__ = probe_steps_batched
    obj.__lbfgs_owlqn_probe_pg_steps_batched__ = ow_probe_steps_batched


#: the [B] row products of two [B, n] batches
_dot = fused.row_dot


def _write_live(live, *pairs) -> None:
    """Each (dst, src) pair: the live instances' rows of src over dst's."""
    for dst, src in pairs:
        dst[live] = src[live]
