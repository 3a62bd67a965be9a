"""The batched epilogues K4 b and K14 b as laid out over the whole batch
(``factory.batched_epilogue_grid``), on the CPU where their plain versions
run:

  * the launch geometry as pure Python: which form each (dtype pair, m)
    takes, every element of every instance covered by exactly one
    (program, tile) of its own instance, the launch's programs at or under
    ``factory.EPILOGUE_PROGRAMS`` wherever B allows, and the . gp launch's
    partials on the 3-column launch's programs;
  * the tensor-core form's three-way bf16 split through its torch twin
    (``factory.bf16_split_ref``): exact for finite float32 inputs, its
    products against a bf16 ring within 1e-6 normwise of the float64
    product, and non-finite inputs giving non-finite products;
  * the plain K4 b and K14 b, with and without the . gp column, against the
    JAX package's oracles in float64 at m = 19, a depth the other batched
    tests skip (rel 1e-12 on vectors, 1e-10 on sums, ring rows bit for
    bit, frozen instances untouched).

The cases marked ``cuda`` hold the card's forms to their plain versions
(vectors 1e-5, sums 1e-4 normwise; 1e-12 and 1e-10 in float64), to the
solo K4 and K14 on each live instance (x, g, pg and the rings bit for bit)
and the . gp launch's other outputs to the 3-column launch's (bit for
bit): over a bf16 ring at m = 6, 19, 40, 80, 200 and 260 (every form and
tensor-core launch, the row-block form at 260;
``tests/test_torch_batched_rows.py`` holds that form over every ring) and
n = 2^14 and 2^14 + 2 (which takes the same forms over the runner's
padded ring, as the solo launch does), over f32 and f64 rings of row
stride n at m = 6 and 80 (at an n off 16: the fold forms), a third
of the instances frozen; the tensor-core products against the float64
product of their own operands (3e-7 normwise) and the forms' spills; and
an inf in gp to non-finite products.  They skip without a card.  This module imports JAX
only inside the tests that compare with it, so the card's cases run
without it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbfgs_torch.core import as_ring, is_ring
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import factory

K = t_rosen.value_and_grad.kernels
F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64
PAIRS = [(F32, BF16), (F32, F32), (F64, F64)]


# ---------------------------------------------------------------------------
# the launch geometry
# ---------------------------------------------------------------------------

GEOMETRIES = [(1, 64), (3, 64), (10_000, 64), (1024, 1 << 14), (1024, (1 << 14) + 2),
              (6, 1 << 12), (4224, 4096), (4225, 640), (17, 1_000_002), (1, 1 << 20)]


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "/".join(str(t)[6:] for t in p))
@pytest.mark.parametrize("m", [1, 6, 8, 9, 19, 64, 65, 80, 128, 129, 256, 257])
def test_form_by_dtype_pair_and_depth(pair, m):
    g = factory.batched_epilogue_grid(1024, 1 << 14, m, *pair)
    if pair == (F32, BF16) and factory.MMA_MIN_M <= m <= factory.MMA_MAX_M:
        assert g.form == "mma"
        assert g.consts["RP"] >= max(16, m) and g.consts["RP"] & (g.consts["RP"] - 1) == 0
        assert g.T == g.consts["K"]
    elif m >= factory.rows_min_m(pair, True):
        # f32 and f64 rings from the row-block form's depth, bf16 rings
        # above the one-pass form's: the row-block form, at most
        # MMA_ROWS_RP rows a block
        assert g.form == "mma_rows"
        assert 16 <= g.consts["RP"] <= factory.MMA_ROWS_RP[pair]
        assert g.T == g.consts["K"]
    else:
        assert g.form == ("static" if m <= factory.EPILOGUE_MAX_M[pair] and (
            pair != (F32, BF16) or m < factory.MMA_MIN_M) else "deep")
        assert g.T == factory.EPILOGUE[pair]["T"]
    # the static form's per-thread sums stay [T // V, 8] below the tensor
    # cores, and at least 128 rows take them
    assert factory.MMA_MIN_M <= 9 and factory.MMA_MAX_M >= 128


@pytest.mark.parametrize("B,n", GEOMETRIES, ids=lambda v: str(v))
@pytest.mark.parametrize("m", [6, 80, 130])
def test_every_element_once_and_programs_capped(B, n, m):
    for pair in PAIRS:
        g = factory.batched_epilogue_grid(B, n, m, *pair)
        # program p of an instance takes tiles p*tiles .. p*tiles + tiles - 1
        # of T elements of that instance alone (grid axis 1 is the
        # instance), so an element e lies in exactly one (program, tile)
        covered = np.zeros(g.programs * g.tiles * g.T, np.int64)
        for p in range(g.programs):
            for t in range(g.tiles):
                tile = p * g.tiles + t
                covered[tile * g.T:(tile + 1) * g.T] += 1
        assert np.all(covered[:n] == 1)
        assert g.ntiles == -(-n // g.T)
        # no program lies wholly past the instance's end
        assert (g.programs - 1) * g.tiles < g.ntiles <= g.programs * g.tiles
        assert g.total == B * g.programs
        # the tensor-core forms sum at most MMA_MAX_CHUNKS chunks a program
        capped = g.form in ("mma", "mma_rows") and g.tiles == factory.MMA_MAX_CHUNKS
        if B <= factory.EPILOGUE_PROGRAMS and not capped:
            assert g.total <= factory.EPILOGUE_PROGRAMS
        elif not capped:
            assert g.programs == 1
        # as few tiles a program as the cap allows
        if g.tiles > 1 and not capped:
            assert B * -(-g.ntiles // (g.tiles - 1)) > factory.EPILOGUE_PROGRAMS


@pytest.mark.parametrize("n", [100, (1 << 14) + 2, 3_000_002, (1 << 20) + 8])
@pytest.mark.parametrize("m", [9, 19, 80, 256])
def test_unaligned_n_takes_the_fold_forms(n, m):
    """The solo form's alignment rule: rings of row stride n at an n off a
    multiple of MMA_ALIGN take the fold forms (the tensor-core form's ring
    loads would go scalar and spill), as the solo launch does at that n;
    the runner's rings, whose row stride is padded to a multiple of 16
    (the grid's default), take the tensor-core form there, as at an
    aligned n."""
    assert n % factory.MMA_ALIGN
    for B in (1, 4, 1024):
        g = factory.batched_epilogue_grid(B, n, m, F32, BF16, ld=n)
        assert g.form == ("static" if m <= factory.EPILOGUE_MAX_M[(F32, BF16)] else "deep")
        assert g.form == factory.solo_epilogue_grid(n, m, F32, BF16, ld=n).form
        assert factory.batched_epilogue_grid(B, n - n % 16, m, F32, BF16).form == "mma"
        assert factory.batched_epilogue_grid(B, n, m, F32, BF16).form == "mma"


@pytest.mark.parametrize("m", [19, 80, 200])
@pytest.mark.parametrize("B,n", [(4, 1 << 24), (1, 1 << 26), (2, 5 << 22), (1024, 1 << 14)])
def test_mma_programs_sum_at_most_max_chunks(B, n, m):
    """The tensor-core form sums at most MMA_MAX_CHUNKS chunks a program:
    a large n takes more programs (B = 4 at n = 2^24: 2048 programs of 64
    chunks an instance, not 1056 of 124), and every chunk lies in one
    program of its instance."""
    g = factory.batched_epilogue_grid(B, n, m, F32, BF16)
    assert g.form == "mma"
    assert g.tiles <= factory.MMA_MAX_CHUNKS
    assert (g.programs - 1) * g.tiles < g.ntiles <= g.programs * g.tiles
    assert g.total == B * g.programs
    per = max(1, factory.EPILOGUE_PROGRAMS // B)
    if -(-g.ntiles // per) > factory.MMA_MAX_CHUNKS:
        assert g.tiles == factory.MMA_MAX_CHUNKS
        assert g.programs == -(-g.ntiles // factory.MMA_MAX_CHUNKS)
    else:
        assert g.total <= max(factory.EPILOGUE_PROGRAMS, B)
    if (B, n) == (4, 1 << 24):
        assert (g.programs, g.tiles) == ((1 << 24) // g.T // 64, 64)


def test_main_path_shape_takes_the_solo_2e24_shape():
    """At 1024 x 2^14 the fold forms run 4 programs of 8 tiles an instance,
    4096 in all: the solo kernel's shape at n = 2^24."""
    g = factory.batched_epilogue_grid(1024, 1 << 14, 6, F32, F32)
    assert (g.programs, g.tiles, g.total) == (4, 8, 4096)
    solo = factory.solo_epilogue_grid(1 << 24, 6, F32, F32)
    assert (g.tiles, g.total) == (solo.tiles, solo.programs)
    assert factory.batched_epilogue_grid(1024, 1 << 14, 80, F32, BF16).programs == 4


@pytest.mark.parametrize("owlqn", [False, True])
@pytest.mark.parametrize("m", [6, 19, 80])
@pytest.mark.parametrize("B,n", [(1, 64), (10_000, 64), (1024, (1 << 14) + 2)])
def test_gp_launch_takes_the_3_column_geometry(owlqn, m, B, n):
    for pair in PAIRS:
        g = factory.batched_epilogue_grid(B, n, m, *pair)
        three = factory.batched_epilogue_partials(g, B, m, owlqn, False)
        gp = factory.batched_epilogue_partials(g, B, m, owlqn, True)
        assert gp["part"] == three["part"] == (B, g.programs, (3 if owlqn else 4) + 6 * m)
        assert gp["gpart"] == (B, g.programs, (2 if owlqn else 0) + 2 * m)
        assert "gpart" not in three


# ---------------------------------------------------------------------------
# the three-way bf16 split
# ---------------------------------------------------------------------------


def _finite_f32(n, seed):
    g = torch.Generator().manual_seed(seed)
    mag = torch.exp(torch.empty(n, dtype=F64).uniform_(-60.0, 60.0, generator=g))
    v = (torch.randn(n, dtype=F64, generator=g).sign() * mag).float()
    return torch.cat([v, torch.tensor([0.0, -0.0, 1.0, -1.5, 3.0e38, -3.0e38, 1e-30],
                                      dtype=F32)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_reconstructs_finite_inputs(seed):
    v = _finite_f32(4096, seed)
    b1, b2, b3 = factory.bf16_split_ref(v)
    assert b1.dtype == b2.dtype == b3.dtype == BF16
    total = b1.double() + b2.double() + b3.double()
    assert torch.equal(total, v.double())


def _products(ring, vecs):
    """The kernel's arithmetic in torch: each vector split in three, each
    part's product with the ring rows summed in float32, then (p1 + p2) +
    p3."""
    parts = [torch.stack(p, dim=1).float() for p in zip(*(factory.bf16_split_ref(v)
                                                          for v in vecs))]
    p1, p2, p3 = (ring.float() @ p for p in parts)
    return (p1 + p2) + p3


@pytest.mark.parametrize("m,n", [(6, 512), (19, 4096), (80, 1 << 14)])
def test_split_products_near_float64(m, n):
    g = torch.Generator().manual_seed(m)
    ring = (0.1 * torch.randn(m, n, generator=g)).to(BF16)
    vecs = [torch.randn(n, generator=g) * s for s in (1.0, 1e-3, 37.0, 1e5)]
    got = _products(ring, vecs)
    want = ring.double() @ torch.stack(vecs, dim=1).double()
    # normwise per vector: the four columns differ in scale by 1e8
    gap = ((got.double() - want).abs().amax(dim=0) / want.abs().amax(dim=0)).max()
    assert float(gap) <= 1e-6, gap


@pytest.mark.parametrize("bad", [float("inf"), -float("inf"), float("nan")])
def test_split_products_non_finite(bad):
    g = torch.Generator().manual_seed(5)
    ring = torch.randn(8, 256, generator=g).to(BF16)
    vecs = [torch.randn(256, generator=g) for _ in range(4)]
    vecs[3][17] = bad
    got = _products(ring, vecs)
    assert not torch.isfinite(got[:, 3]).any()
    assert torch.isfinite(got[:, :3]).all()


# ---------------------------------------------------------------------------
# the plain K4 b and K14 b against the JAX package at m = 19
# ---------------------------------------------------------------------------

M19 = 19
LIVE = np.array([True, False, True, True])
WINDOWS = {"edge": (0, 63), "interior": (5, 50)}


@pytest.fixture(scope="module")
def jax_side():
    jnp = pytest.importorskip("jax.numpy")
    from lbfgs_tpu.models import rosenbrock as j_rosen
    from lbfgs_tpu.ops import fused as j_fused
    return jnp, j_rosen, j_fused


@pytest.fixture(scope="module")
def batch19():
    n = 64
    rng = np.random.RandomState(19)
    Bk = len(LIVE)
    xp = np.where(np.arange(n) % 2 == 0, -1.2, 1.0) + 0.1 * rng.randn(Bk, n)
    xp[:, ::9] = 0.0
    return dict(m=M19, end=7, xp=xp, d=0.3 * rng.randn(Bk, n), gp=rng.randn(Bk, n),
                pg=rng.randn(Bk, n), S=rng.randn(Bk, M19, n), Y=rng.randn(Bk, M19, n),
                stp=0.2 + rng.rand(Bk), c=0.7)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, rtol):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * np.abs(j).max())


def _frozen_untouched(a, outs, names):
    for b in np.flatnonzero(~LIVE):
        for t, k in zip(outs, names):
            assert np.array_equal(t[b].numpy(), a[k][b])


@pytest.mark.parametrize("with_gp", [False, True], ids=["3col", "gp"])
def test_k4b_plain_matches_jax_m19(batch19, jax_side, with_gp):
    jnp, j_rosen, j_fused = jax_side
    a, end = batch19, batch19["end"]
    xp, gp, S, Y = (_t(a[k]) for k in ("xp", "gp", "S", "Y"))
    gd, gg, xx, changed, SP, YP = K.trial_pair_gram_batched(
        xp, _t(a["d"]), gp, _t(a["stp"]), S, Y, end, _t(LIVE), with_gp=with_gp)
    assert SP.shape[1:] == YP.shape[1:] == (M19, 4 if with_gp else 3)
    _frozen_untouched(a, (xp, gp, S, Y), ("xp", "gp", "S", "Y"))
    for b in np.flatnonzero(LIVE):
        jx, _jfx, jg, jgd, jgg, jxx, jch = j_rosen.trial_ref(
            jnp.asarray(a["xp"][b]), jnp.asarray(a["d"][b]), a["stp"][b])
        js, jy, jSP, jYP = j_fused.pair_gram_sd_ref(
            a["stp"][b], jnp.asarray(a["d"][b]), jg, jnp.asarray(a["gp"][b]),
            jnp.asarray(a["S"][b]), jnp.asarray(a["Y"][b]), end, with_gp=with_gp)
        _close(xp[b], jx, 1e-12)
        _close(gp[b], jg, 1e-12)
        for t, j in ((gd, jgd), (gg, jgg), (xx, jxx), (SP, jSP), (YP, jYP)):
            _close(t[b], j, 1e-10)
        assert bool(changed[b]) == bool(jch)
        assert np.array_equal(S[b, end].numpy(), np.asarray(js))
        assert np.array_equal(Y[b, end].numpy(), np.asarray(jy))
        keep = [j for j in range(M19) if j != end]
        assert np.array_equal(S[b, keep].numpy(), a["S"][b, keep])
        assert np.array_equal(Y[b, keep].numpy(), a["Y"][b, keep])


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("with_gp", [False, True], ids=["3col", "gp"])
def test_k14b_plain_matches_jax_m19(batch19, jax_side, window, with_gp):
    jnp, j_rosen = jax_side[:2]
    a, end, (lo, hi) = batch19, batch19["end"], WINDOWS[window]
    xp, gp, pg, S, Y = (_t(a[k]) for k in ("xp", "gp", "pg", "S", "Y"))
    out = K.owlqn_trial_pair_gram_batched(xp, _t(a["d"]), gp, pg, _t(a["stp"]), a["c"], lo, hi,
                                          S, Y, end, _t(LIVE), with_gp=with_gp)
    xx, pp, changed, SP, YP = out[:5]
    _frozen_untouched(a, (xp, gp, pg, S, Y), ("xp", "gp", "pg", "S", "Y"))
    for b in np.flatnonzero(LIVE):
        j = j_rosen.owlqn_trial_pair_gram_ref(
            *(jnp.asarray(a[k][b]) for k in ("xp", "d", "gp", "pg")), a["stp"][b], a["c"], lo,
            hi, jnp.asarray(a["S"][b]), jnp.asarray(a["Y"][b]), end, with_gp=with_gp)
        jx, jg, jpg, jS, jY, jSP, jYP, jxx, jpp, jch = j[:10]
        for t, jv in ((xp, jx), (gp, jg), (pg, jpg)):
            _close(t[b], jv, 1e-12)
        for t, jv in ((SP, jSP), (YP, jYP), (xx, jxx), (pp, jpp)):
            _close(t[b], jv, 1e-10)
        if with_gp:
            _close(out[5][b], j[10], 1e-10)
            _close(out[6][b], j[11], 1e-10)
        assert bool(changed[b]) == bool(jch)
        assert np.array_equal(S[b].numpy(), np.asarray(jS))
        assert np.array_equal(Y[b].numpy(), np.asarray(jY))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_batch(dev, m, n, Bk=24, seed=0, vd=F32, hd=BF16, padded=True):
    # the rings in the runner's padded layout, or (``padded`` off) of row
    # stride n
    ring = as_ring if padded else (lambda t: t)
    g = torch.Generator(device=dev).manual_seed(seed + m)
    r = lambda *s: torch.randn(*s, generator=g, device=dev, dtype=vd)
    live = torch.ones(Bk, dtype=torch.bool, device=dev)
    live[2::3] = False
    xp = t_rosen.initial_point(n, vd, dev)[None, :] + 0.1 * r(Bk, n)
    xp[:, ::17] = 0.0
    return dict(xp=xp, d=0.1 * r(Bk, n), gp=r(Bk, n), pg=r(Bk, n),
                S=ring((0.1 * r(Bk, m, n)).to(hd)), Y=ring((0.1 * r(Bk, m, n)).to(hd)),
                stp=0.2 + torch.rand(Bk, generator=g, device=dev, dtype=vd), live=live,
                end=m - 3, window=(5, n - 7), c=0.7)


NAMES = ("xp", "gp", "pg", "S", "Y")


def _copy(t):
    # a copy of an input in its own layout (a padded ring's too)
    return as_ring(t.clone()) if t.ndim > 1 and is_ring(t) else t.clone()


def _run(a, fn, ow, **kw):
    t = {n_: _copy(a[n_]) for n_ in NAMES}
    lo, hi = a["window"]
    if ow:
        out = fn(t["xp"], a["d"], t["gp"], t["pg"], a["stp"], a["c"], lo, hi, t["S"], t["Y"],
                 a["end"], a["live"], **kw)
    else:
        out = fn(t["xp"], a["d"], t["gp"], a["stp"], t["S"], t["Y"], a["end"], a["live"], **kw)
    return t, out


def _normwise(u, v):
    return float((u.double() - v.double()).abs().max() / v.double().abs().max())


def _held(a, ow, solo=True, vtol=1e-5, stol=1e-4):
    """One card launch of K4 b or K14 b (with the . gp column) against its
    plain version, the 3-column launch (bit for bit) and, with ``solo``,
    the solo kernel on each live instance (x, g, pg and the rings bit for
    bit); returns the launch's form."""
    live, end = a["live"], a["end"]
    kern = K.owlqn_trial_pair_gram_batched if ow else K.trial_pair_gram_batched
    ref = K.owlqn_trial_pair_gram_batched_ref if ow else K.trial_pair_gram_batched_ref
    B, n = a["xp"].shape
    form = factory.batched_epilogue_grid(B, n, a["S"].shape[1], a["xp"].dtype,
                                         a["S"].dtype, a["S"].stride(-2)).form
    mma = kern.mma_launches
    tk, ok = _run(a, kern, ow, with_gp=True)
    assert kern.last_form.form == form
    assert kern.mma_launches == mma + (form == "mma")
    t3, o3 = _run(a, kern, ow)
    tp, op = _run(a, ref, ow, with_gp=True)
    for n_ in NAMES:
        assert torch.equal(tk[n_], t3[n_]), n_
        assert torch.equal(tk[n_][~live], a[n_][~live]), n_
    for u, v in zip(ok, o3):
        assert torch.equal((u[..., :3] if u.ndim == 3 else u)[live], v[live])
    for n_ in ("xp", "gp") + (("pg",) if ow else ()):
        assert _normwise(tk[n_][live], tp[n_][live]) <= vtol, n_
    for u, v in zip(ok, op):
        if u.dtype == torch.bool:
            assert torch.equal(u[live], v[live])
        else:
            assert _normwise(u[live], v[live]) <= stol
    lo, hi = a["window"]
    for b in torch.nonzero(live).flatten().tolist() if solo else ():
        Sb, Yb = _copy(a["S"][b]), _copy(a["Y"][b])
        stp = float(a["stp"][b])
        if ow:
            x1, g1, pg1 = K.owlqn_trial_pair_gram(a["xp"][b], a["d"][b], a["gp"][b], a["pg"][b],
                                                  stp, a["c"], lo, hi, Sb, Yb, end)[:3]
            assert torch.equal(tk["pg"][b], pg1)
        else:
            x1, _, g1 = K.trial_pair_gram(a["xp"][b], a["d"][b], a["gp"][b], stp, Sb, Yb,
                                          end)[:3]
        assert torch.equal(tk["xp"][b], x1) and torch.equal(tk["gp"][b], g1)
        assert torch.equal(tk["S"][b], Sb) and torch.equal(tk["Y"][b], Yb)
    return form


@pytest.mark.cuda
@pytest.mark.parametrize("ow", [False, True], ids=["K4b", "K14b"])
@pytest.mark.parametrize("n", [1 << 14, (1 << 14) + 2])
@pytest.mark.parametrize("m", [6, 19, 40, 80, 200, 260])
def test_batched_epilogues_on_card(cuda, m, n, ow):
    """f32 vectors over a bf16 ring: the static form at m = 6, the
    tensor-core form at every RP it takes (19, 40, 80, 200) and the
    row-block form above ``factory.MMA_MAX_M`` (260), at an n off 16 too
    (the padded ring), each against its plain version, the 3-column launch and (but
    at m = 40, whose solo static form compiles for minutes) the solo
    kernel."""
    form = _held(_card_batch(cuda, m, n), ow, solo=m != 40)
    assert form == ("static" if m < factory.MMA_MIN_M else
                    "mma" if m <= factory.MMA_MAX_M else "mma_rows")


def _products_f64(a, t, ow, b):
    """Instance b's SP and YP ([m, 4] against y, s, d0, gp) in float64 from
    the tensor-core form's own operands: the ring rows as the launch left
    them, widened, row ``end`` the unrounded pair."""
    gp = a["gp"][b]
    g = t["gp"][b]
    s = t["xp"][b] - a["xp"][b] if ow else float(a["stp"][b]) * a["d"][b]
    d0 = -t["pg"][b] if ow else -g
    V = torch.stack([g - gp, s, d0, gp], dim=1).double()
    out = []
    for ring, new in (("S", s), ("Y", g - gp)):
        P = t[ring][b].double() @ V
        P[a["end"]] = new.double() @ V
        out.append(P)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("ow", [False, True], ids=["K4b", "K14b"])
@pytest.mark.parametrize("n", [1 << 14, (1 << 14) + 2])
@pytest.mark.parametrize("m", [19, 80])
def test_batched_forms_take_the_solo_rules_on_card(cuda, m, n, ow):
    """The batched epilogues under the solo forms' rules: over the padded
    ring an n off a multiple of 16 takes the tensor-core form, as the
    solo launch does, and spills nothing; the tensor-core form sums its chunks
    in float32 adds, so each live instance's products (with the . gp
    column) stay within 3e-7 normwise of the float64 product of its own
    operands; both against the plain version and the solo kernel
    (``_held``)."""
    a = _card_batch(cuda, m, n)
    form = _held(a, ow)
    kern = K.owlqn_trial_pair_gram_batched if ow else K.trial_pair_gram_batched
    assert form == factory.solo_epilogue_grid(n, m, F32, BF16).form
    assert form == "mma"
    assert kern.last_form.compiled.n_spills == 0
    t, out = _run(a, kern, ow, with_gp=True)
    SP, YP = out[3:5] if ow else out[4:6]
    if form == "mma":
        assert kern.last_form.tiles <= factory.MMA_MAX_CHUNKS
        for b in torch.nonzero(a["live"]).flatten().tolist():
            want = _products_f64(a, t, ow, b)
            assert _normwise(SP[b], want[0]) <= 3e-7
            assert _normwise(YP[b], want[1]) <= 3e-7


@pytest.mark.cuda
@pytest.mark.parametrize("ow", [False, True], ids=["K4b", "K14b"])
@pytest.mark.parametrize("m", [6, 80])
@pytest.mark.parametrize("pair", [(F32, F32), (F64, F64)], ids=["f32", "f64"])
def test_fold_forms_on_the_batch_grid_on_card(cuda, pair, m, ow):
    """The f32/f32 and f64 rings of row stride n at an n off 16 keep the
    static and deep fold forms, on the batch-wide grid: against their
    plain versions, the 3-column launch and the solo kernels."""
    vtol, stol = (1e-5, 1e-4) if pair[0] == F32 else (1e-12, 1e-10)
    a = _card_batch(cuda, m, (1 << 12) + 2, vd=pair[0], hd=pair[1], padded=False)
    assert _held(a, ow, vtol=vtol, stol=stol) == ("static" if m <= factory.EPILOGUE_MAX_M[pair]
                                                  else "deep")


@pytest.mark.cuda
@pytest.mark.parametrize("ow", [False, True], ids=["K4b", "K14b"])
def test_inf_in_gp_gives_non_finite_products_on_card(cuda, ow):
    """An inf in one live instance's gp: that instance's . gp column and the
    products with y are non-finite, as the fold's are; the other instances'
    products are finite."""
    a = _card_batch(cuda, 19, 1 << 14)
    a["gp"][0, 1234] = float("inf")
    _, out = _run(a, K.owlqn_trial_pair_gram_batched if ow else K.trial_pair_gram_batched, ow,
                  with_gp=True)
    SP, YP = out[3:5] if ow else out[4:6]
    live = a["live"].clone()
    live[0] = False
    for P in (SP, YP):
        assert not torch.isfinite(P[0][:, 0]).any()
        assert not torch.isfinite(P[0][:, 3]).any()
        assert torch.isfinite(P[live]).all()
