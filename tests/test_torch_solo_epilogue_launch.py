"""The solo epilogues K4 and K14 as laid out on one instance
(``factory.solo_epilogue_grid``), on the CPU where their plain versions
run:

  * the launch geometry as pure Python: which form each (dtype pair, m)
    takes (the tensor-core form for f32 vectors over a bf16 ring from
    ``factory.MMA_MIN_M`` to ``factory.MMA_MAX_M`` rows, else the static
    fold form up to the pair's ``factory.EPILOGUE_MAX_M`` and the deep fold
    form above, while K15 and K16 keep ``factory.MAX_M``; the tensor-core
    row-block form over f32 and f64 rings from ``factory.MMA_ROWS_MIN_M``
    rows and over bf16 rings above 256, which the batched forms take by
    the same rule; at any n over the solver's rings, whose row stride is
    padded to a multiple of 16, and the fold forms over a ring of row
    stride n at an n off 16), every element covered by exactly one
    (program, chunk) and every ring row by one block, the programs at or
    under the form's cap, one objective partial per chunk, and the . gp
    launch's partials on the 3-column launch's programs;
  * the row-block form's split of an f32 ring into three bf16 parts
    (exact) and its products emulated in torch
    (``factory.mma_products_ref``) against the float64 product;
  * the plain K4 and K14, with and without the . gp column, at m = 19 and
    200 (depths the tensor-core form takes that
    ``tests/test_torch_deep_fusions.py`` skips): in float32 against the JAX
    package's Pallas kernels in interpret mode (their . gp launch, whose
    columns 0-2 are its 3-column launch's; the rows not written and K4's
    S[end] bit for bit, vectors normwise 1e-5 and sums 1e-4, as that file
    holds them: XLA contracts the JAX kernels' multiply-adds), and in
    float64 against the JAX package's plain versions (its Pallas epilogues
    keep float32 partials and refuse float64 operands): ring rows bit for
    bit, vectors rel 1e-12, sums rel 1e-10.

The cases marked ``cuda`` hold the card's solo form at m = 9, 16, 19,
64, 80, 200 and 256 and n = 64, 100, 2^14 + 2 and 2^20 (the tensor-core
form over the padded ring at every n) to its plain
version (vectors 1e-5, sums, products and fx 1e-4 normwise, ring rows bit
for bit) and, for the tensor-core form, to the fold form on the same
inputs (x, g, pg, the rings and the changed flag bit for bit), the . gp
launch's other outputs to the 3-column launch's and an in-place launch to
the launch into fresh vectors (bit for bit, both ways), its compiled
kernel spilling nothing; the tensor-core products to the float64 product of its own
operands at 2, 32 and 256 chunks per program (1e-4 normwise); and an inf
in gp to non-finite products.  The row-block form's ``cuda`` cases hold
it the same way over f32 and f64 rings at m = 9, 19, 80 and 200 and bf16
rings at 257 and 260 (its products within 1e-6 / 1e-12 of the float64
product at 2, 32 and 64 chunks a program).  They skip without a card.
This module imports JAX only inside the tests that compare with it, so the card's
cases run without it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbfgs_torch.core import as_ring
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import factory

K = t_rosen.value_and_grad.kernels
F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64
PAIRS = [(F32, BF16), (F32, F32), (F64, F64)]
PAIR_IDS = ["f32-bf16", "f32-f32", "f64-f64"]
STP, C = 0.37, 0.7


# ---------------------------------------------------------------------------
# the launch geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("m", [1, 6, 8, 9, 12, 16, 17, 19, 32, 64, 65, 80, 200, 256, 257])
def test_solo_form_by_dtype_pair_and_depth(pair, m):
    g = factory.solo_epilogue_grid(1 << 20, m, *pair)
    if pair == factory.MMA_DTYPES and factory.MMA_MIN_M <= m <= factory.MMA_MAX_M:
        assert g.form == "mma"
        rp = g.consts["RP"]
        assert rp >= max(16, m) and rp & (rp - 1) == 0 and rp < 2 * max(16, m)
        assert g.T == g.consts["K"] == factory.MMA_EPILOGUE[rp]["K"]
        assert g.tiles <= factory.MMA_MAX_CHUNKS
        assert g.programs <= max(factory.SOLO_MMA_PROGRAMS,
                                 -(-g.ntiles // factory.MMA_MAX_CHUNKS))
    elif m <= factory.EPILOGUE_MAX_M[pair]:
        assert g.form == "static"
        assert g.T == factory.EPILOGUE[pair]["T"] and g.programs <= factory.EPILOGUE_PROGRAMS
    elif m >= factory.MMA_ROWS_MIN_M[pair]:
        # above the static cap over f32 and f64 rings, and above the
        # one-pass form over a bf16 ring: the tensor-core row-block form
        assert g.form == "mma_rows"
        rp = g.consts["RP"]
        assert rp == min(max(16, 1 << (m - 1).bit_length()), factory.MMA_ROWS_RP[pair])
        assert g.T == g.consts["K"] == factory.MMA_ROWS_EPILOGUE[pair][rp]["K"]
        assert g.tiles <= factory.MMA_MAX_CHUNKS
    else:
        assert g.form == "deep"
        assert g.T == factory.EPILOGUE[pair]["T"] and g.programs <= factory.EPILOGUE_PROGRAMS
        assert g.consts["G"] == factory.DEEP_GROUP[pair]
    # one choice of form for the solo and the batched epilogues, the
    # row-block form's too, from the batched kernels' own crossover depth
    b = factory.batched_epilogue_grid(1024, 1 << 14, m, *pair).form
    assert b == ("deep" if g.form == "mma_rows" and m < factory.rows_min_m(pair, True)
                 else g.form)


@pytest.mark.parametrize("n", [100, (1 << 14) + 2, 3_000_002, (1 << 20) + 8])
@pytest.mark.parametrize("m", [9, 19, 80, 256])
def test_unaligned_n_takes_the_fold_forms(n, m):
    """A ring row that does not start on a 16-element boundary (a ring of
    row stride n at an n off a multiple of 16) takes the fold form (the
    tensor-core form's ring loads would go scalar); the batched launch
    takes the same rule.  The solver's rings have a row stride padded to a
    multiple of 16 (``core.ring_stride``, the grids' default), so at the
    same n they take the tensor-core form, as at an aligned n."""
    assert n % factory.MMA_ALIGN
    g = factory.solo_epilogue_grid(n, m, F32, BF16, ld=n)
    assert g.form == ("static" if m <= factory.EPILOGUE_MAX_M[(F32, BF16)] else "deep")
    assert factory.solo_epilogue_grid(n - n % 16, m, F32, BF16).form == "mma"
    assert factory.batched_epilogue_grid(1024, n, m, F32, BF16, ld=n).form == g.form
    padded = factory.solo_epilogue_grid(n, m, F32, BF16)
    assert padded.form == factory.solo_epilogue_grid(n - n % 16, m, F32, BF16).form
    assert padded.form == factory.solo_epilogue_grid(n, m, F32, BF16, ld=n + 16 - n % 16).form
    assert factory.batched_epilogue_grid(1024, n, m, F32, BF16).form == padded.form


def test_fold_caps_and_the_fusions_cap():
    """Each pair's static epilogue cap lies under the fusions' (K15 and K16
    unroll their rows up to ``MAX_M`` = 64, and do not spill), and covers
    every depth below the tensor-core form with f32 vectors over a bf16
    ring."""
    assert factory.MAX_M == 64
    assert set(factory.EPILOGUE_MAX_M) == set(factory.EPILOGUE) == set(PAIRS)
    assert all(1 <= cap < factory.MAX_M for cap in factory.EPILOGUE_MAX_M.values())
    assert factory.EPILOGUE_MAX_M[factory.MMA_DTYPES] >= factory.MMA_MIN_M - 1


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("n", [64, 100, (1 << 14) + 2, 3_000_002, 1 << 20, 1 << 24])
@pytest.mark.parametrize("m", [6, 19, 80, 200, 260])
def test_every_element_once_and_programs_capped(pair, n, m):
    g = factory.solo_epilogue_grid(n, m, *pair)
    # program p takes chunks p*tiles .. p*tiles + tiles - 1 of T elements,
    # so an element lies in exactly one (program, chunk)
    covered = np.zeros(g.programs * g.tiles * g.T, np.int64)
    for p in range(g.programs):
        for t in range(g.tiles):
            chunk = p * g.tiles + t
            covered[chunk * g.T:(chunk + 1) * g.T] += 1
    assert np.all(covered[:n] == 1)
    assert g.ntiles == -(-n // g.T)
    # no program lies wholly past n, and as few chunks a program as the cap allows
    assert (g.programs - 1) * g.tiles < g.ntiles <= g.programs * g.tiles
    if g.form in ("mma", "mma_rows"):
        # the cap, unless a program would then sum more than MMA_MAX_CHUNKS
        cap = max(factory.SOLO_MMA_PROGRAMS, -(-g.ntiles // factory.MMA_MAX_CHUNKS))
        assert g.tiles <= factory.MMA_MAX_CHUNKS
    else:
        cap = factory.EPILOGUE_PROGRAMS
    assert g.programs <= cap and g.total == g.programs
    if g.tiles > 1:
        assert -(-g.ntiles // (g.tiles - 1)) > cap


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_m6_main_path_keeps_its_launch(pair):
    """At m = 6 the solo epilogues keep the static form's launch of the
    main path: tiles of ``EPILOGUE``'s T, 4096 programs of 8 tiles at
    n = 2^24 (f32 vectors; 4096 of 16 tiles of 256 in float64), one tile a
    program at 2^20, under ``EPILOGUE_PROGRAMS``."""
    cfg = factory.EPILOGUE[pair]
    big, small = (factory.solo_epilogue_grid(n, 6, *pair) for n in (1 << 24, 1 << 20))
    assert big.form == small.form == "static" and big.T == small.T == cfg["T"]
    assert (big.programs, big.tiles) == (4096, (1 << 24) // (4096 * cfg["T"]))
    assert small.tiles == 1 and small.programs == (1 << 20) // cfg["T"]
    assert big.launch == dict(num_warps=cfg["num_warps"], num_stages=cfg["num_stages"])


@pytest.mark.parametrize("owlqn", [False, True])
@pytest.mark.parametrize("m", [6, 19, 80, 200])
@pytest.mark.parametrize("n", [100, (1 << 14) + 2, 1 << 20])
def test_partials_per_chunk_and_gp_launch_on_the_3_column_grid(owlqn, m, n):
    for pair in PAIRS:
        g = factory.solo_epilogue_grid(n, m, *pair)
        three = factory.epilogue_partials(g, m, owlqn, False)
        gp = factory.epilogue_partials(g, m, owlqn, True)
        assert gp["part"] == three["part"] == (g.programs, (3 if owlqn else 4) + 6 * m)
        assert gp["gpart"] == (g.programs, (2 if owlqn else 0) + 2 * m)
        assert "gpart" not in three
        if owlqn:
            assert "fx" not in three and "fx" not in gp
        else:
            # the objective: one partial per chunk (tile) of every program
            assert three["fx"] == gp["fx"] == (g.programs * g.tiles,)


#: the depths and widths the row-block form's routing is held at
ROWS_DEPTHS = [9, 16, 64, 80, 200, 256, 257, 260, 512]
ROWS_WIDTHS = [64, 100, (1 << 14) + 2, 1 << 14, (1 << 20) + 2, 1 << 20]


def _fold_form(m, pair):
    return "static" if m <= factory.EPILOGUE_MAX_M[pair] else "deep"


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("n", ROWS_WIDTHS)
@pytest.mark.parametrize("m", ROWS_DEPTHS)
def test_rows_form_by_pair_depth_and_width(pair, n, m):
    """The solo epilogues' form by dtype pair, depth and width: f32 vectors
    over a bf16 ring the one-pass tensor-core form up to 256 rows and the
    row-block form above; f32 and f64 rings the row-block form from
    ``MMA_ROWS_MIN_M`` rows (the fold forms below), at any n over the
    solver's padded ring; a ring of row stride n at an n off a multiple of
    16 the fold forms everywhere.  The row-block form's blocks are RP rows
    (m rounded up to a power of two, at least 16, at most the pair's
    ``MMA_ROWS_RP``), the last one RT (the rows left, rounded up), so it
    passes over its chunks cdiv(m, RP) times: at most three at 260 bf16
    rows, where the deep fold form passed 33 times."""
    if n % factory.MMA_ALIGN:
        assert factory.solo_epilogue_grid(n, m, *pair, ld=n).form == _fold_form(m, pair)
    g = factory.solo_epilogue_grid(n, m, *pair)
    if pair == factory.MMA_DTYPES and m <= factory.MMA_MAX_M:
        assert g.form == "mma"
        return
    if m < factory.MMA_ROWS_MIN_M[pair]:
        # under the crossover depth the deep fold form is the faster
        assert g.form == _fold_form(m, pair)
        return
    assert g.form == "mma_rows"
    rp, cfg = g.consts["RP"], factory.MMA_ROWS_EPILOGUE[pair][g.consts["RP"]]
    assert 16 <= rp <= factory.MMA_ROWS_RP[pair] and rp & (rp - 1) == 0
    passes = -(-m // rp)
    assert (passes - 1) * rp < m <= passes * rp
    assert passes == 1 or rp == factory.MMA_ROWS_RP[pair]
    # the last block: the rows left, rounded up to a power of two (at least
    # 16), so the tail of a deep ring takes no whole block's products
    rt = g.consts["RT"]
    assert rt & (rt - 1) == 0 and 16 <= rt <= rp
    left = m - (passes - 1) * rp
    assert rt == max(16, 1 << (left - 1).bit_length()) and left <= rt
    assert g.consts == dict(m=m, RP=rp, RT=rt, K=cfg["K"]) and g.T == cfg["K"]
    assert g.launch == dict(num_warps=cfg["num_warps"], num_stages=cfg["num_stages"])
    if pair == factory.MMA_DTYPES and m == 260:
        # blocks of 128 or 256 rows and a tail of 16, where the deep fold
        # form passed over the vectors 33 times
        assert passes <= 3 and rt == 16
    # the launch is the one-pass form's: at most SOLO_MMA_PROGRAMS programs
    # (more where one would sum more than MMA_MAX_CHUNKS chunks)
    assert g.tiles <= factory.MMA_MAX_CHUNKS
    assert g.programs <= max(factory.SOLO_MMA_PROGRAMS, -(-g.ntiles // factory.MMA_MAX_CHUNKS))


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("B,n", [(1, 1 << 20), (4, 1 << 16), (1024, 1 << 14), (2, 100)])
@pytest.mark.parametrize("m", [6, 8, 9, 19, 80, 200, 256, 257, 260, 512])
def test_batched_grids_keep_their_forms(pair, B, n, m):
    """The batched epilogues take the solo forms' rule: the tensor-core
    form with f32 vectors over a bf16 ring from ``MMA_MIN_M`` to
    ``MMA_MAX_M`` rows and the row-block form from ``MMA_ROWS_MIN_M`` rows
    (f32 and f64 rings above the static cap, bf16 rings above 256), both at
    a ring row stride that is a multiple of 16 (the runner's padded rings,
    the grid's default, at any n), on chunks of their launch's K, at most
    ``MMA_MAX_CHUNKS`` a program; else the static fold form up to the
    pair's cap and the deep fold form above, on the fold forms' tiles;
    every form on the batch-wide program count.  A ring of row stride n
    at an n off 16 takes the fold forms."""
    if n % factory.MMA_ALIGN:
        assert factory.batched_epilogue_grid(B, n, m, *pair, ld=n).form == \
            factory._epilogue_form(m, *pair, mma=False, batched=True)[0]
    g = factory.batched_epilogue_grid(B, n, m, *pair)
    # the form is the solo grid's at the same width and depth, but between
    # the solo and the batched row-block depths
    solo = factory.solo_epilogue_grid(n, m, *pair).form
    assert g.form == ("deep" if solo == "mma_rows" and m < factory.rows_min_m(pair, True)
                      else solo)
    assert factory._epilogue_form(m, *pair, batched=True)[0] == g.form
    per = max(1, factory.EPILOGUE_PROGRAMS // B)
    assert g.total == B * g.programs
    if pair == factory.MMA_DTYPES and factory.MMA_MIN_M <= m <= factory.MMA_MAX_M:
        assert g.form == "mma"
        return
    if m >= factory.rows_min_m(pair, True):
        assert g.form == "mma_rows"
        # over a padded ring (an n off 16) an entry's batched_padded launch
        rp, cfg = factory.rows_launch(pair, m, True, n % factory.MMA_ALIGN != 0)
        assert g.consts["RP"] == rp <= factory.MMA_ROWS_RP[pair]
        assert rp == min(max(16, 1 << (m - 1).bit_length()), max(
            r for r, c in factory.MMA_ROWS_EPILOGUE[pair].items() if c.get("batched", c)))
        assert g.consts == dict(m=m, RP=rp, RT=factory.rows_tail(m, rp), K=cfg["K"])
        assert g.T == cfg["K"] and g.launch == dict(num_warps=cfg["num_warps"],
                                                    num_stages=cfg["num_stages"])
        assert g.tiles == min(-(-g.ntiles // per), factory.MMA_MAX_CHUNKS)
        return
    assert g.form == _fold_form(m, pair)
    cfg = factory.EPILOGUE[pair]
    assert g.T == cfg["T"] and g.launch == dict(num_warps=cfg["num_warps"],
                                                num_stages=cfg["num_stages"])
    assert g.tiles == -(-g.ntiles // per)
    assert "RP" not in g.consts


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("n", [1 << 14, 3_000_000, 1 << 20, 1 << 24])
@pytest.mark.parametrize("m", [9, 33, 80, 260, 512])
def test_rows_form_covers_every_element_and_row_once(pair, n, m):
    """The row-block form's launch: each element in exactly one (program,
    chunk), at most ``MMA_MAX_CHUNKS`` chunks a program, and each ring row
    in exactly one block of RP rows, so every (row, element) product is
    taken once and the point is stored once, by the last pass."""
    g = factory.solo_epilogue_grid(n, m, *pair)
    if m < factory.MMA_ROWS_MIN_M[pair] and pair != factory.MMA_DTYPES:
        assert g.form == "deep"
        return
    assert g.form == "mma_rows" or (pair == factory.MMA_DTYPES and g.form == "mma")
    covered = np.zeros(g.programs * g.tiles * g.T, np.int64)
    for p in range(g.programs):
        for t in range(g.tiles):
            chunk = p * g.tiles + t
            covered[chunk * g.T:(chunk + 1) * g.T] += 1
    assert np.all(covered[:n] == 1) and g.tiles <= factory.MMA_MAX_CHUNKS
    rp = g.consts["RP"]
    rt = g.consts.get("RT", rp)
    # the kernel's blocks: cdiv(m - RT, RP) full blocks, then one of RT rows
    full = -(-(m - rt) // rp)
    blocks = [(j * rp, rp) for j in range(full)] + [(full * rp, rt)]
    rows = np.zeros(full * rp + rt, np.int64)
    for j0, r in blocks:
        rows[j0:j0 + r] += 1
    assert np.all(rows[:m] == 1)
    # row `end` lies in exactly one block, which stores the new pair
    for end in (0, m // 2, m - 1):
        assert sum(j0 <= end < j0 + r for j0, r in blocks) == 1


def test_f32_ring_split_is_exact():
    """An f32 ring row's three bf16 parts (``factory.bf16_split_ref``, the
    row-block form's split of its [RP, K] ring tile) sum exactly to the
    row, over float32's exponents and at bf16's rounding ties; an inf
    leaves NaN in the lower parts (its products stay non-finite)."""
    rng = np.random.default_rng(25)
    v = rng.standard_normal(1 << 16) * np.exp2(rng.integers(-100, 100, 1 << 16))
    exps = np.resize(np.arange(-120, 121), 256)
    ties = (1.0 + np.arange(1, 257) * 2.0 ** -8 + 2.0 ** -9) * 2.0 ** exps
    v = torch.from_numpy(np.concatenate([v, ties, -ties, [0.0, -0.0, 1e-30, 3e38]])).float()
    b1, b2, b3 = factory.bf16_split_ref(v)
    assert all(b.dtype == torch.bfloat16 for b in (b1, b2, b3))
    assert torch.isfinite(v).all()
    assert torch.equal((b1.double() + b2.double()) + b3.double(), v.double())
    assert torch.equal((b1.float() + b2.float()) + b3.float(), v)
    inf = factory.bf16_split_ref(torch.tensor([float("inf")]))
    assert torch.isinf(inf[0]).all() and torch.isnan(inf[1]).all() and torch.isnan(inf[2]).all()


@pytest.mark.parametrize("hd", [F32, BF16, F64], ids=["f32-ring", "bf16-ring", "f64-ring"])
@pytest.mark.parametrize("K", [32, 64, 128])
def test_mma_products_twin_near_float64(hd, K):
    """The row-block form's products emulated in torch
    (``factory.mma_products_ref``: the split operands' products summed per
    chunk of K in the sums' dtype, the chunks carried in adds of that
    dtype) at n = 2^12 against the float64 product of the same operands:
    within 1e-6 normwise with f32 vectors (an f32 ring in three bf16
    parts), 1e-12 with f64 vectors."""
    n = 1 << 12
    vd = F64 if hd == F64 else F32
    rng = np.random.default_rng(K)
    R = torch.from_numpy(rng.standard_normal((80, n))).to(hd)
    V = torch.from_numpy(rng.standard_normal((n, 4))).to(vd)
    P = factory.mma_products_ref(R, V, K)
    assert P.dtype == vd and P.shape == (80, 4)
    want = R.double() @ V.double()
    gap = float((P.double() - want).abs().max() / want.abs().max())
    assert gap <= (1e-12 if vd == F64 else 1e-6)
    if hd == F32:
        # one bf16 part of the ring would not do: its products part from
        # the float64 product by bf16's rounding
        one = factory.mma_products_ref(R.bfloat16(), V, K)
        assert float((one.double() - want).abs().max() / want.abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# the plain K4 and K14 against the JAX package at m = 19 and 200
# ---------------------------------------------------------------------------

#: n for the Pallas comparison: one 128-lane row of the JAX kernels' tiles
#: (their interpreter takes minutes a launch at 200 ring rows)
N_PALLAS = 128
#: an OWL-QN window whose ends fall inside the row
LO, HI = 5, N_PALLAS - 9
DEPTHS = (19, 200)


def _t(a):
    return torch.from_numpy(np.array(a))


def _normwise(t, j, tol, what):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    j = np.asarray(j, np.float64).reshape(t.shape)
    err = np.abs(t - j).max() / max(np.abs(j).max(), 1e-300)
    assert err <= tol, f"{what}: normwise {err:.3e} above {tol:.0e}"


def _close(t, j, rtol):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * np.abs(j).max())


def _inputs(m, n, dt):
    rng = np.random.default_rng(m)
    x0 = np.where(np.arange(n) % 2 == 0, -1.2, 1.0)
    return dict(
        m=m, end=m - 3,
        xp=(x0 + 0.1 * rng.standard_normal(n)).astype(dt),
        xp0=np.where(np.arange(n) % 17 == 0, 0.0, x0 + 0.1 * rng.standard_normal(n)).astype(dt),
        d=(0.1 * rng.standard_normal(n)).astype(dt), gp=rng.standard_normal(n).astype(dt),
        pg=rng.standard_normal(n).astype(dt),
        S=(0.1 * rng.standard_normal((m, n))).astype(dt),
        Y=(0.1 * rng.standard_normal((m, n))).astype(dt))


@pytest.fixture(scope="module", params=DEPTHS, ids=lambda m: f"m{m}")
def pallas(request):
    """The JAX package's K4 and K14 (. gp launches) in interpret mode on
    float32 inputs at depth m."""
    jnp = pytest.importorskip("jax.numpy")
    from lbfgs_tpu.models import rosenbrock as j_rosen

    a = _inputs(request.param, N_PALLAS, np.float32)
    m = a["m"]
    ring = lambda H: jnp.asarray(H).reshape(m, N_PALLAS // 128, 128)
    a["k4"] = j_rosen.trial_pair_gram_pallas(
        *(jnp.asarray(a[k]) for k in ("xp", "d", "gp")), STP, ring(a["S"]), ring(a["Y"]),
        a["end"], interpret=True, with_gp=True)
    a["k14"] = j_rosen.owlqn_trial_pair_gram_pallas(
        *(jnp.asarray(a[k]) for k in ("xp0", "d", "gp", "pg")), STP, C, LO, HI, ring(a["S"]),
        ring(a["Y"]), a["end"], interpret=True, with_gp=True)
    return a


def _rings_kept(St, Yt, S_j, Y_j, a):
    m, end = a["m"], a["end"]
    keep = [j for j in range(m) if j != end]
    S_j, Y_j = np.asarray(S_j).reshape(m, -1), np.asarray(Y_j).reshape(m, -1)
    for t, j, inp in ((St, S_j, a["S"]), (Yt, Y_j, a["Y"])):
        assert np.array_equal(t.numpy()[keep], inp[keep])
        assert np.array_equal(j[keep], inp[keep])
    return S_j, Y_j


@pytest.mark.parametrize("with_gp", [False, True], ids=["3col", "gp"])
def test_k4_plain_matches_pallas(pallas, with_gp):
    a, j = pallas, pallas["k4"]
    St, Yt = _t(a["S"]), _t(a["Y"])
    t = K.trial_pair_gram(_t(a["xp"]), _t(a["d"]), _t(a["gp"]), np.float32(STP), St, Yt,
                          a["end"], with_gp=with_gp)
    S_j, Y_j = _rings_kept(St, Yt, j[7], j[8], a)
    assert np.array_equal(St.numpy()[a["end"]], S_j[a["end"]])
    _normwise(Yt[a["end"]], Y_j[a["end"]], 1e-5, "Y[end]")
    _normwise(t[0], j[0], 1e-5, "x")
    _normwise(t[2], j[2], 1e-5, "g")
    for i in (1, 3, 4, 5):
        _normwise(t[i], j[i], 1e-4, f"sum {i}")
    assert bool(t[6]) == bool(j[6])
    cols = 4 if with_gp else 3
    assert t[7].shape == t[8].shape == (a["m"], cols)
    _normwise(t[7], np.asarray(j[9])[:, :cols], 1e-4, "SP")
    _normwise(t[8], np.asarray(j[10])[:, :cols], 1e-4, "YP")


@pytest.mark.parametrize("with_gp", [False, True], ids=["3col", "gp"])
def test_k14_plain_matches_pallas(pallas, with_gp):
    a, j = pallas, pallas["k14"]
    # (x, g, pg, S, Y, SP, YP, xx, pgpg, changed, gpgp, gppg)
    St, Yt = _t(a["S"]), _t(a["Y"])
    t = K.owlqn_trial_pair_gram(*(_t(a[k]) for k in ("xp0", "d", "gp", "pg")), np.float32(STP),
                                C, LO, HI, St, Yt, a["end"], with_gp=with_gp)
    S_j, Y_j = _rings_kept(St, Yt, j[3], j[4], a)
    _normwise(St[a["end"]], S_j[a["end"]], 1e-5, "S[end]")
    _normwise(Yt[a["end"]], Y_j[a["end"]], 1e-5, "Y[end]")
    for i, what in ((0, "x"), (1, "g"), (2, "pg")):
        _normwise(t[i], j[i], 1e-5, what)
    np.testing.assert_array_equal(t[0].numpy() == 0, np.asarray(j[0]) == 0)
    cols = 4 if with_gp else 3
    _normwise(t[3], np.asarray(j[5])[:, :cols], 1e-4, "SP")
    _normwise(t[4], np.asarray(j[6])[:, :cols], 1e-4, "YP")
    _normwise(t[5], j[7], 1e-4, "x.x")
    _normwise(t[6], j[8], 1e-4, "pg.pg")
    assert bool(t[7]) == bool(j[9])
    if with_gp:
        _normwise(t[8], j[10], 1e-4, "gp.gp")
        _normwise(t[9], j[11], 1e-4, "gp.pg")


@pytest.fixture(scope="module")
def jax_side():
    jnp = pytest.importorskip("jax.numpy")
    from lbfgs_tpu.models import rosenbrock as j_rosen
    from lbfgs_tpu.ops import fused as j_fused
    return jnp, j_rosen, j_fused


@pytest.mark.parametrize("m", DEPTHS)
@pytest.mark.parametrize("with_gp", [False, True], ids=["3col", "gp"])
def test_k4_plain_matches_jax_f64(jax_side, m, with_gp):
    jnp, j_rosen, j_fused = jax_side
    a = _inputs(m, 256, np.float64)
    end = a["end"]
    xp, gp, S, Y = (_t(a[k]) for k in ("xp", "gp", "S", "Y"))
    x, _fx, g, gd, gg, xx, changed, SP, YP = K.trial_pair_gram(xp, _t(a["d"]), gp, STP, S, Y,
                                                               end, with_gp=with_gp)
    assert SP.shape == YP.shape == (m, 4 if with_gp else 3)
    jx, _jfx, jg, jgd, jgg, jxx, jch = j_rosen.trial_ref(jnp.asarray(a["xp"]),
                                                        jnp.asarray(a["d"]), STP)
    js, jy, jSP, jYP = j_fused.pair_gram_sd_ref(STP, jnp.asarray(a["d"]), jg,
                                                jnp.asarray(a["gp"]), jnp.asarray(a["S"]),
                                                jnp.asarray(a["Y"]), end, with_gp=with_gp)
    _close(x, jx, 1e-12)
    _close(g, jg, 1e-12)
    for t, j in ((gd, jgd), (gg, jgg), (xx, jxx), (SP, jSP), (YP, jYP)):
        _close(t, j, 1e-10)
    assert bool(changed) == bool(jch)
    assert np.array_equal(S[end].numpy(), np.asarray(js))
    assert np.array_equal(Y[end].numpy(), np.asarray(jy))
    keep = [j for j in range(m) if j != end]
    assert np.array_equal(S[keep].numpy(), a["S"][keep])
    assert np.array_equal(Y[keep].numpy(), a["Y"][keep])


@pytest.mark.parametrize("m", DEPTHS)
@pytest.mark.parametrize("with_gp", [False, True], ids=["3col", "gp"])
def test_k14_plain_matches_jax_f64(jax_side, m, with_gp):
    jnp, j_rosen = jax_side[:2]
    a = _inputs(m, 256, np.float64)
    end, lo, hi = a["end"], 5, 256 - 9
    St, Yt = _t(a["S"]), _t(a["Y"])
    out = K.owlqn_trial_pair_gram(*(_t(a[k]) for k in ("xp0", "d", "gp", "pg")), STP, C, lo,
                                  hi, St, Yt, end, with_gp=with_gp)
    j = j_rosen.owlqn_trial_pair_gram_ref(
        *(jnp.asarray(a[k]) for k in ("xp0", "d", "gp", "pg")), STP, C, lo, hi,
        jnp.asarray(a["S"]), jnp.asarray(a["Y"]), end, with_gp=with_gp)
    for i in (0, 1, 2):
        _close(out[i], j[i], 1e-12)
    for t, jv in ((out[3], j[5]), (out[4], j[6]), (out[5], j[7]), (out[6], j[8])):
        _close(t, jv, 1e-10)
    if with_gp:
        _close(out[8], j[10], 1e-10)
        _close(out[9], j[11], 1e-10)
    assert bool(out[7]) == bool(j[9])
    assert np.array_equal(St.numpy(), np.asarray(j[3]))
    assert np.array_equal(Yt.numpy(), np.asarray(j[4]))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card(dev, m, n, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + m + n)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    xp = t_rosen.initial_point(n, F32, dev) + 0.1 * r(n)
    xp0 = xp.clone()
    xp0[::17] = 0.0
    return dict(xp=xp, xp0=xp0, d=0.1 * r(n), gp=r(n), pg=r(n),
                S=as_ring((0.1 * r(m, n)).to(BF16)), Y=as_ring((0.1 * r(m, n)).to(BF16)),
                end=m - 3, window=(5, max(n - 9, 6)))


def _launch(a, ow, with_gp, inplace=False, ring=None):
    """One launch of the solo K4 or K14 on copies of the inputs; returns
    (its outputs, the vectors it wrote or returned, the rings: copies in
    the solver's padded layout, ``core.as_ring``)."""
    S, Y = ring if ring is not None else (as_ring(a["S"].clone()), as_ring(a["Y"].clone()))
    if ow:
        xp, gp, pg = a["xp0"].clone(), a["gp"].clone(), a["pg"].clone()
        lo, hi = a["window"]
        out = K.owlqn_trial_pair_gram(xp, a["d"], gp, pg, STP, C, lo, hi, S, Y, a["end"],
                                      inplace=inplace, with_gp=with_gp)
        vecs, given = out[:3], (xp, gp, pg)
    else:
        xp, gp = a["xp"].clone(), a["gp"].clone()
        out = K.trial_pair_gram(xp, a["d"], gp, STP, S, Y, a["end"], inplace=inplace,
                                with_gp=with_gp)
        vecs, given = (out[0], out[2]), (xp, gp)
    if inplace:
        assert all(v.data_ptr() == w.data_ptr() for v, w in zip(vecs, given))
    return out, vecs, (S, Y)


def _bits(u, v):
    return u.shape == v.shape and u.dtype == v.dtype and torch.equal(
        u.reshape(-1).view(torch.uint8) if u.dtype != torch.bool else u.reshape(-1),
        v.reshape(-1).view(torch.uint8) if v.dtype != torch.bool else v.reshape(-1))


def _normwise_t(u, v):
    return float((u.double() - v.double()).abs().max() / max(float(v.double().abs().max()),
                                                             1e-300))


#: the outputs of K4 (x, fx, g, g.d, g.g, x.x, changed, SP, YP) and K14 (x,
#: g, pg, SP, YP, x.x, pg.pg, changed, gp.gp, gp.pg) that are vectors, sums
#: and flags
VECS = {False: (0, 2), True: (0, 1, 2)}
FLAG = {False: 6, True: 7}


@pytest.mark.cuda
@pytest.mark.parametrize("ow", [False, True], ids=["K4", "K14"])
@pytest.mark.parametrize("n", [64, 100, (1 << 14) + 2, 1 << 20])
@pytest.mark.parametrize("m", [9, 16, 19, 64, 80, 200, 256])
def test_solo_tensor_core_form_on_card(cuda, m, n, ow, monkeypatch):
    a = _card(cuda, m, n)
    fn = K.owlqn_trial_pair_gram if ow else K.trial_pair_gram
    mma = fn.mma_launches
    form = factory.solo_epilogue_grid(n, m, F32, BF16).form
    # the padded ring takes the tensor-core form at every n
    assert form == "mma"
    out, vecs, (S, Y) = _launch(a, ow, True)
    assert fn.last_form.form == form and fn.mma_launches == mma + (form == "mma")
    assert fn.last_form.compiled.n_spills == 0
    # against the plain version
    refn = K.owlqn_trial_pair_gram_ref if ow else K.trial_pair_gram_ref
    Sp, Yp = a["S"].clone(), a["Y"].clone()
    if ow:
        lo, hi = a["window"]
        ref = refn(a["xp0"], a["d"], a["gp"], a["pg"], STP, C, lo, hi, Sp, Yp, a["end"],
                   with_gp=True)
    else:
        ref = refn(a["xp"], a["d"], a["gp"], STP, Sp, Yp, a["end"], with_gp=True)
    assert _bits(S, Sp) and _bits(Y, Yp)
    for i, (u, v) in enumerate(zip(out, ref)):
        if i == FLAG[ow]:
            assert bool(u) == bool(v)
        else:
            assert _normwise_t(u, v) <= (1e-5 if i in VECS[ow] else 1e-4), i
    # the 3-column launch: every output but the . gp column bit for bit
    three, _, (S3, Y3) = _launch(a, ow, False)
    assert _bits(S3, S) and _bits(Y3, Y)
    cols = (3, 4) if ow else (7, 8)
    for i, u in enumerate(three):
        v = out[i][:, :3] if i in cols else out[i]
        assert _bits(u, v), i
    # in place, both ways: the outputs of the launch into fresh vectors
    ip, _, (Si, Yi) = _launch(a, ow, True, inplace=True)
    assert _bits(Si, S) and _bits(Yi, Y)
    assert all(_bits(u, v) for u, v in zip(ip, out))
    ip3, _, _ = _launch(a, ow, False, inplace=True)
    assert all(_bits(u, v) for u, v in zip(ip3, three))
    # the fold form on the same inputs: the vectors, the rings and the flag
    monkeypatch.setattr(factory, "MMA_MAX_M", 0)
    fold, fvecs, (Sf, Yf) = _launch(a, ow, True)
    assert fn.last_form.form in ("static", "deep")
    assert _bits(Sf, S) and _bits(Yf, Y)
    assert all(_bits(u, v) for u, v in zip(vecs, fvecs))
    assert bool(fold[FLAG[ow]]) == bool(out[FLAG[ow]])
    for i, (u, v) in enumerate(zip(out, fold)):
        if i not in VECS[ow] and i != FLAG[ow]:
            assert _normwise_t(u, v) <= 1e-4, i


def _products_f64(S, Y, s, y, d0, gp, end):
    V = torch.stack([y, s, d0, gp], dim=1).double()
    out = []
    for R, new in ((S, s), (Y, y)):
        P = R.double() @ V
        P[end] = new.double() @ V
        out.append(P)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [2, 32, 256])
@pytest.mark.parametrize("m", [19, 80, 200])
def test_tensor_core_products_near_float64_on_card(cuda, m, chunks, monkeypatch):
    """The solo K4's SP and YP (with the . gp column) against the float64
    product of its own operands (the bf16 ring widened, row end the
    unrounded pair, the float32 vectors widened) at n = 2^20, with the
    program cap set for ``chunks`` chunks per program."""
    n = 1 << 20
    a = _card(cuda, m, n, seed=7)
    g0 = factory.solo_epilogue_grid(n, m, F32, BF16)
    monkeypatch.setattr(factory, "SOLO_MMA_PROGRAMS", -(-g0.ntiles // chunks))
    monkeypatch.setattr(factory, "MMA_MAX_CHUNKS", chunks)
    S, Y = a["S"].clone(), a["Y"].clone()
    out = K.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, S, Y, a["end"], with_gp=True)
    assert K.trial_pair_gram.last_form.tiles == chunks
    s = torch.full((1,), STP, dtype=F32, device=cuda) * a["d"]
    g = out[2]
    SPw, YPw = _products_f64(S, Y, s, g - a["gp"], -g, a["gp"], a["end"])
    assert _normwise_t(out[7], SPw) <= 1e-4
    assert _normwise_t(out[8], YPw) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("ow", [False, True], ids=["K4", "K14"])
def test_inf_in_gp_gives_non_finite_products_on_card(cuda, ow):
    """An inf in gp: the . gp column and the products with y are non-finite,
    as the fold's are."""
    a = _card(cuda, 19, 1 << 14)
    a["gp"][1234] = float("inf")
    out, _, _ = _launch(a, ow, True)
    SP, YP = out[3:5] if ow else out[7:9]
    assert not torch.isfinite(SP[:, 3]).all() and not torch.isfinite(YP[:, 3]).all()
    assert not torch.isfinite(SP[:, 0]).all() and not torch.isfinite(YP[:, 0]).all()


# ---------------------------------------------------------------------------
# the row-block form on the card
# ---------------------------------------------------------------------------


def _card_pair(dev, m, n, vd, hd, seed=0):
    """``_card``'s inputs with vectors of ``vd`` and rings of ``hd``."""
    g = torch.Generator(device=dev).manual_seed(seed + m + n)
    r = lambda *s: torch.randn(*s, generator=g, device=dev, dtype=F64)
    xp = (t_rosen.initial_point(n, F64, dev) + 0.1 * r(n)).to(vd)
    xp0 = xp.clone()
    xp0[::17] = 0.0
    return dict(xp=xp, xp0=xp0, d=(0.1 * r(n)).to(vd), gp=r(n).to(vd), pg=r(n).to(vd),
                S=as_ring((0.1 * r(m, n)).to(hd)), Y=as_ring((0.1 * r(m, n)).to(hd)),
                end=m - 3, window=(5, max(n - 9, 6)))


#: (vector dtype, ring dtype, m) of the row-block form's card cases: f32
#: and f64 rings from one row past the static cap to several blocks, bf16
#: rings past the one-pass form
ROWS_CARD = ([(F32, F32, m) for m in (9, 19, 80, 200)] + [(F64, F64, m) for m in (9, 19, 80, 200)]
             + [(F32, BF16, m) for m in (257, 260)])


def _no_rows_form(monkeypatch):
    """The fold forms alone (the tensor-core forms off)."""
    monkeypatch.setattr(factory, "MMA_MAX_M", 0)
    monkeypatch.setattr(factory, "MMA_ROWS_MIN_M", dict.fromkeys(factory.MMA_ROWS_MIN_M, 1 << 62))


@pytest.mark.cuda
@pytest.mark.parametrize("ow", [False, True], ids=["K4", "K14"])
@pytest.mark.parametrize("n", [64, 100, (1 << 14) + 2, 1 << 20])
@pytest.mark.parametrize("vd,hd,m", ROWS_CARD, ids=str)
def test_rows_form_on_card(cuda, vd, hd, m, n, ow, monkeypatch):
    """The row-block form (at an n off a multiple of 16, the fold form;
    forced at the depths the routing gives to the deep fold form) with
    the . gp column against its plain version (ring rows bit for bit,
    vectors 1e-5 / 1e-12, sums and products 1e-4 / 1e-10 normwise in f32 /
    f64) and against the fold form on the same inputs (x, g, pg, the rings
    and the changed flag bit for bit, the sums at the sum tolerance); the
    3-column launch's outputs the . gp launch's bit for bit, an in-place
    launch the launch into fresh vectors', and no spill."""
    tv, ts = (1e-5, 1e-4) if vd == F32 else (1e-12, 1e-10)
    # the row-block form wherever the static form does not run (the
    # routing gives the shallower of these depths to the deep fold form)
    monkeypatch.setattr(factory, "MMA_ROWS_MIN_M", dict.fromkeys(factory.MMA_ROWS_MIN_M, 1))
    a = _card_pair(cuda, m, n, vd, hd)
    fn = K.owlqn_trial_pair_gram if ow else K.trial_pair_gram
    rows = fn.mma_rows_launches
    form = factory.solo_epilogue_grid(n, m, vd, hd).form
    assert form == "mma_rows"
    out, vecs, (S, Y) = _launch(a, ow, True)
    assert fn.last_form.form == form and fn.mma_rows_launches == rows + (form == "mma_rows")
    assert fn.last_form.compiled.n_spills == 0
    refn = K.owlqn_trial_pair_gram_ref if ow else K.trial_pair_gram_ref
    Sp, Yp = a["S"].clone(), a["Y"].clone()
    if ow:
        lo, hi = a["window"]
        ref = refn(a["xp0"], a["d"], a["gp"], a["pg"], STP, C, lo, hi, Sp, Yp, a["end"],
                   with_gp=True)
    else:
        ref = refn(a["xp"], a["d"], a["gp"], STP, Sp, Yp, a["end"], with_gp=True)
    assert _bits(S, Sp) and _bits(Y, Yp)
    for i, (u, v) in enumerate(zip(out, ref)):
        if i == FLAG[ow]:
            assert bool(u) == bool(v)
        else:
            assert _normwise_t(u, v) <= (tv if i in VECS[ow] else ts), i
    three, _, (S3, Y3) = _launch(a, ow, False)
    assert _bits(S3, S) and _bits(Y3, Y)
    cols = (3, 4) if ow else (7, 8)
    for i, u in enumerate(three):
        assert _bits(u, out[i][:, :3] if i in cols else out[i]), i
    ip, _, (Si, Yi) = _launch(a, ow, True, inplace=True)
    assert _bits(Si, S) and _bits(Yi, Y)
    assert all(_bits(u, v) for u, v in zip(ip, out))
    _no_rows_form(monkeypatch)
    fold, fvecs, (Sf, Yf) = _launch(a, ow, True)
    assert fn.last_form.form in ("static", "deep")
    assert _bits(Sf, S) and _bits(Yf, Y)
    assert all(_bits(u, v) for u, v in zip(vecs, fvecs))
    assert bool(fold[FLAG[ow]]) == bool(out[FLAG[ow]])
    for i, (u, v) in enumerate(zip(out, fold)):
        if i not in VECS[ow] and i != FLAG[ow]:
            assert _normwise_t(u, v) <= ts, i


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [2, 32, 64])
@pytest.mark.parametrize("vd,hd,m", [(F32, F32, 80), (F64, F64, 80), (F32, BF16, 260)],
                         ids=str)
def test_rows_form_products_near_float64_on_card(cuda, vd, hd, m, chunks, monkeypatch):
    """The row-block K4's SP and YP (with the . gp column) against the
    float64 product of its own operands (the ring widened, row end the
    unrounded pair, the vectors widened) at n = 2^20 with ``chunks`` chunks
    a program: within 1e-6 normwise with f32 vectors, 1e-12 with f64."""
    n = 1 << 20
    a = _card_pair(cuda, m, n, vd, hd, seed=7)
    g0 = factory.solo_epilogue_grid(n, m, vd, hd)
    assert g0.form == "mma_rows"
    monkeypatch.setattr(factory, "SOLO_MMA_PROGRAMS", -(-g0.ntiles // chunks))
    monkeypatch.setattr(factory, "MMA_MAX_CHUNKS", chunks)
    S, Y = a["S"].clone(), a["Y"].clone()
    out = K.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, S, Y, a["end"], with_gp=True)
    assert K.trial_pair_gram.last_form.tiles == chunks
    s = torch.full((1,), STP, dtype=vd, device=cuda) * a["d"]
    g = out[2]
    SPw, YPw = _products_f64(S, Y, s, g - a["gp"], -g, a["gp"], a["end"])
    tol = 1e-6 if vd == F32 else 1e-12
    assert _normwise_t(out[7], SPw) <= tol
    assert _normwise_t(out[8], YPw) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("ow", [False, True], ids=["K4", "K14"])
@pytest.mark.parametrize("vd,hd,m", [(F32, F32, 80), (F64, F64, 80), (F32, BF16, 260)],
                         ids=str)
def test_rows_form_inf_in_gp_on_card(cuda, vd, hd, m, ow):
    """An inf in gp: the row-block form's . gp column and products with y
    are non-finite, as the fold's are."""
    a = _card_pair(cuda, m, 1 << 14, vd, hd)
    a["gp"][1234] = float("inf")
    out, _, _ = _launch(a, ow, True)
    assert (K.owlqn_trial_pair_gram if ow else K.trial_pair_gram).last_form.form == "mma_rows"
    SP, YP = out[3:5] if ow else out[7:9]
    assert not torch.isfinite(SP[:, 3]).all() and not torch.isfinite(YP[:, 3]).all()
    assert not torch.isfinite(SP[:, 0]).all() and not torch.isfinite(YP[:, 0]).all()
