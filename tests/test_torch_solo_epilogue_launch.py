"""The solo epilogues K4 and K14 as laid out on one instance
(``factory.solo_epilogue_grid``), on the CPU where their plain versions
run:

  * the launch geometry as pure Python: which form each (dtype pair, m)
    takes (the tensor-core form for f32 vectors over a bf16 ring from
    ``factory.MMA_MIN_M`` to ``factory.MMA_MAX_M`` rows, else the static
    fold form up to the pair's ``factory.EPILOGUE_MAX_M`` and the deep fold
    form above, while K15 and K16 keep ``factory.MAX_M``), every element
    covered by exactly one (program, chunk), the programs at or under the
    form's cap, one objective partial per chunk, and the . gp launch's
    partials on the 3-column launch's programs;
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
form where n is a multiple of 16, the fold form else) to its plain
version (vectors 1e-5, sums, products and fx 1e-4 normwise, ring rows bit
for bit) and, for the tensor-core form, to the fold form on the same
inputs (x, g, pg, the rings and the changed flag bit for bit), the . gp
launch's other outputs to the 3-column launch's and an in-place launch to
the launch into fresh vectors (bit for bit, both ways), its compiled
kernel spilling nothing; the tensor-core products to the float64 product of its own
operands at 2, 32 and 256 chunks per program (1e-4 normwise); and an inf
in gp to non-finite products.  They skip without a card.  This module
imports JAX only inside the tests that compare with it, so the card's
cases run without it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
    else:
        assert g.form == ("static" if m <= factory.EPILOGUE_MAX_M[pair] else "deep")
        assert g.T == factory.EPILOGUE[pair]["T"] and g.programs <= factory.EPILOGUE_PROGRAMS
        if g.form == "deep":
            assert g.consts["G"] == factory.DEEP_GROUP[pair]
    # one choice of form for the solo and the batched epilogues
    assert g.form == factory.batched_epilogue_grid(1024, 1 << 14, m, *pair).form


@pytest.mark.parametrize("n", [100, (1 << 14) + 2, 3_000_002, (1 << 20) + 8])
@pytest.mark.parametrize("m", [9, 19, 80, 256])
def test_unaligned_n_takes_the_fold_forms(n, m):
    """A ring row that does not start on a 16-element boundary takes the
    fold form (the tensor-core form's ring loads would go scalar); the
    batched launch takes the same rule."""
    assert n % factory.MMA_ALIGN
    g = factory.solo_epilogue_grid(n, m, F32, BF16)
    assert g.form == ("static" if m <= factory.EPILOGUE_MAX_M[(F32, BF16)] else "deep")
    assert factory.solo_epilogue_grid(n - n % 16, m, F32, BF16).form == "mma"
    assert factory.batched_epilogue_grid(1024, n, m, F32, BF16).form == g.form


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
    if g.form == "mma":
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
    return dict(xp=xp, xp0=xp0, d=0.1 * r(n), gp=r(n), pg=r(n), S=(0.1 * r(m, n)).to(BF16),
                Y=(0.1 * r(m, n)).to(BF16), end=m - 3, window=(5, max(n - 9, 6)))


def _launch(a, ow, with_gp, inplace=False, ring=None):
    """One launch of the solo K4 or K14 on copies of the inputs; returns
    (its outputs, the vectors it wrote or returned, the rings)."""
    S, Y = ring if ring is not None else (a["S"].clone(), a["Y"].clone())
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
    assert form == ("mma" if n % factory.MMA_ALIGN == 0 else "deep" if m > 8 else "static")
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
