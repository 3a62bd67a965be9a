"""The port's batched runner at the uncapped step, with the adaptive entry
step and at any history depth (``lbfgs_torch.batched`` with
``constrain_step_size=False``, ``adaptive_entry_step > 0`` or ``m > 64``),
against the JAX package's (``lbfgs_tpu.batched``) and against its own solo
runs, on the CPU, where K15 b, K16 b and the deep K4 b and K14 b run their
plain versions.

  * the vectorized searches with the combine+probe fusion's carried first
    trip against the scalar ``linesearch.morethuente`` / ``backtracking``
    with ``probe1``, plain and OWL-QN, bit for bit, instances whose probed
    step is not their entry step included; a trip on which every instance
    carried makes no probe;
  * the plain versions of K15 b and K16 b per instance against the JAX
    package's jnp oracles in float64 at m = 6 and 80, and of the deep K4 b
    and K14 b at m = 65 and 80: rel 1e-12 on vectors, 1e-10 on sums, ring
    rows bit for bit, a frozen instance untouched;
  * eight perturbed instances in float64 against the JAX batched run,
    uncapped and adaptive (growth 2), plain and OWL-QN: after 15
    iterations the same k, evaluations and status per instance, and fx,
    entry step and dginit rel 1e-9; to epsilon as
    ``tests/test_torch_batched.py`` holds its runs; one run at m = 80;
  * a run resumed from the JAX package's fused batched state with its
    carried probes; batched runs against the port's solo ``minimize_jit``
    (float64, and float32 with a bfloat16 ring under the fused-vs-unfused
    rule); the lasso; the launch path, and the fused run against the same
    run without the fusion's hooks, bit for bit.

The cases marked ``cuda`` hold K15 b, K16 b, K4 b deep and K14 b deep to
their plain versions and, per instance, to the solo kernels on the card,
and skip without one.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from lbfgs_torch import _batched_search as bs
from lbfgs_torch import batched as t_batched
from lbfgs_torch import interop
from lbfgs_torch import lbfgs as t_lbfgs
from lbfgs_torch import linesearch as t_ls
from lbfgs_torch.core import ProblemDef
from lbfgs_torch.minimize import minimize_jit as t_minimize_jit
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.models import separable as t_sep
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.orthantwise import Orthantwise as TOrthantwise
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_torch.params import LineSearchParams as TLsParams
from lbfgs_torch.status import Status
from lbfgs_tpu import lbfgs as j_lbfgs
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.ops import fused as j_fused
from lbfgs_tpu.orthantwise import Orthantwise as JOrthantwise
from lbfgs_tpu.orthantwise import choose_orthant as j_choose_orthant
from test_torch_batched import ALGOS, B, N, _Poly, _close, _np, _same, _scalar_objective, _t
from test_torch_batched_owlqn import OW, PERTURBED, _owlqn_stand_in

K = t_rosen.value_and_grad.kernels


# ---------------------------------------------------------------------------
# the vectorized searches with a carried first trip
# ---------------------------------------------------------------------------


def _search_case(seed: int, K_: int = 120):
    dtype = np.float32
    rng = np.random.RandomState(seed)
    poly = _Poly(rng, K_, dtype)
    finit, dginit = poly(np.zeros(K_, dtype))
    stp0 = (rng.rand(K_) * 3.0 + 0.01).astype(dtype)
    stp0[::17] = dtype(1.0)
    neval0 = np.arange(K_, dtype=np.int64)
    live = rng.rand(K_) < 0.9
    return poly, finit, dginit, stp0, neval0, live, rng


def _scalar_find(poly, i, ls, ow, finit, dginit, stp0, neval0, probe1):
    xp = torch.zeros(1, dtype=torch.float32)
    if ow:
        pdef = ProblemDef(value_and_grad=_owlqn_stand_in(poly, i), owlqn=TOrthantwise(*OW))
        kw = dict(pgp=xp)
    else:
        pdef = ProblemDef(value_and_grad=_scalar_objective(poly, i, np.float32))
        kw = {}
    one = None if probe1 is None else tuple(p[i] for p in probe1)
    return t_ls.find(pdef, ls, xp, finit[i], xp, xp, stp0[i], int(neval0[i]),
                     dginit=dginit[i], materialize=False, probe1=one, **kw)


@pytest.mark.parametrize("ow", [False, True], ids=["plain", "owlqn"])
@pytest.mark.parametrize("algo", ALGOS)
def test_carried_search_matches_scalar(algo, ow):
    """Carried values moved off the polynomial (so that a use shows), at the
    entry step for about two instances in three, at another step or dead
    (-1) for the rest: every instance's search is the scalar one's with
    the same slot, bit for bit, the carried instances stay out of the first
    trip's probe, and each use is counted."""
    poly, finit, dginit, stp0, neval0, live, rng = _search_case(9 + ow)
    dtype = np.float32
    ls = TLsParams(algorithm=algo)
    ft, dg = poly(stp0)
    stp_c = np.where(rng.rand(len(stp0)) < 2 / 3, stp0, stp0 * dtype(0.5)).astype(dtype)
    stp_c[::11] = dtype(-1.0)
    probe1 = ((ft + dtype(1e-3) * np.abs(ft)).astype(dtype), dg.astype(dtype), stp_c)
    trips = []

    def probe(stp, run):
        trips.append(run.copy())
        return poly(stp)

    used = t_ls.carried.used
    got = bs.find(ls, live, finit, dginit, stp0, neval0, probe, ow=ow, probe1=probe1)
    carry = live & (stp0 == stp_c)
    assert t_ls.carried.used - used == carry.sum() > 0
    assert np.array_equal(trips[0], live & ~carry)
    for i in range(len(stp0)):
        if not live[i]:
            assert (got.neval[i], got.ncall[i], got.status[i]) == (neval0[i], 0, 0)
            continue
        want = _scalar_find(poly, i, ls, ow, finit, dginit, stp0, neval0, probe1)
        assert _same(want.fx, got.fx[i]) and _same(want.step, got.step[i]), i
        assert _same(want.step_eval, got.step_eval[i]), i
        assert (want.ncall, want.neval, want.status) == (
            got.ncall[i], got.neval[i], got.status[i]), i


@pytest.mark.parametrize("ow", [False, True], ids=["plain", "owlqn"])
def test_all_carried_trip_makes_no_probe(ow):
    """Every live instance carries its first trip, the carried values the
    probe's own: the search is the uncarried one bit for bit, with one
    probe call fewer, and the evaluations still counted."""
    poly, finit, dginit, stp0, neval0, live, _ = _search_case(21)
    ls = TLsParams(algorithm="MoreThuente")
    calls = {True: [], False: []}

    def probe_of(key):
        def probe(stp, run):
            calls[key].append(int(run.sum()))
            return poly(stp)
        return probe

    probe1 = (*poly(stp0), stp0.copy())
    got = bs.find(ls, live, finit, dginit, stp0, neval0, probe_of(True), ow=ow, probe1=probe1)
    ref = bs.find(ls, live, finit, dginit, stp0, neval0, probe_of(False), ow=ow)
    for name in got._fields:
        assert _same(getattr(got, name), getattr(ref, name)), name
    assert calls[True] == calls[False][1:]


# ---------------------------------------------------------------------------
# the plain versions against the JAX package's references (float64)
# ---------------------------------------------------------------------------

WINDOWS = {"edge": (0, 255), "interior": (5, 250)}
LIVE = np.array([True, True, False, True])


@pytest.fixture(scope="module", params=(6, 80), ids=lambda m: f"m{m}")
def fusion_batch(request):
    m, n = request.param, 256
    rng = np.random.RandomState(16 + m)
    Bk = len(LIVE)
    x = np.where(np.arange(n) % 2 == 0, -1.2, 1.0) + 0.1 * rng.randn(Bk, n)
    x[:, ::7] = 0.0            # the orthant's at-zero choice
    return dict(m=m, g=rng.randn(Bk, n), pg=rng.randn(Bk, n), x=x, d=rng.randn(Bk, n),
                S=0.1 * rng.randn(Bk, m, n), Y=0.1 * rng.randn(Bk, m, n),
                coef=0.1 * rng.randn(Bk, 1 + 2 * m), stp1=np.array([1.0, 0.37, 0.125, 2.0 ** -3]),
                c=0.8)


def test_k15b_plain_matches_jax(fusion_batch):
    a, m = fusion_batch, fusion_batch["m"]
    out = _t(a["d"])
    got = K.combine_probe_batched(_t(a["g"]), _t(a["x"]), _t(a["S"]), _t(a["Y"]),
                                  _t(a["coef"]), _t(a["stp1"]), _t(LIVE), out)
    for b in range(len(LIVE)):
        if not LIVE[b]:
            assert np.array_equal(out[b].numpy(), a["d"][b])
            continue
        c = a["coef"][b]
        j = j_rosen.combine_probe_ref(*(jnp.asarray(a[k][b]) for k in ("g", "x", "S", "Y")),
                                      c[0], jnp.asarray(c[1:1 + m]), jnp.asarray(c[1 + m:]),
                                      a["stp1"][b])
        _close(out[b], j[0], 1e-12)
        for t, jv in zip(got, j[1:]):
            _close(t[b], jv, 1e-10)


@pytest.mark.parametrize("window", list(WINDOWS))
def test_k16b_plain_matches_jax(fusion_batch, window):
    a, m, (lo, hi) = fusion_batch, fusion_batch["m"], WINDOWS[window]
    out = _t(a["d"])
    got = K.combine_ow_probe_batched(_t(a["pg"]), _t(a["x"]), _t(a["S"]), _t(a["Y"]),
                                     _t(a["coef"]), a["c"], lo, hi, _t(a["stp1"]), _t(LIVE),
                                     out)
    for b in range(len(LIVE)):
        if not LIVE[b]:
            assert np.array_equal(out[b].numpy(), a["d"][b])
            continue
        c = a["coef"][b]
        j = j_rosen.combine_ow_probe_ref(
            *(jnp.asarray(a[k][b]) for k in ("pg", "x", "S", "Y")), c[0],
            jnp.asarray(c[1:1 + m]), jnp.asarray(c[1 + m:]), a["c"], lo, hi,
            stp1=a["stp1"][b])
        np.testing.assert_array_equal(out[b].numpy() == 0, np.asarray(j[0]) == 0)
        _close(out[b], j[0], 1e-12)
        for t, jv in zip(got, j[1:]):
            _close(t[b], jv, 1e-10)


@pytest.fixture(scope="module", params=(65, 80), ids=lambda m: f"m{m}")
def deep_batch(request):
    m, n = request.param, 64
    rng = np.random.RandomState(m)
    Bk = len(LIVE)
    x0 = np.where(np.arange(n) % 2 == 0, -1.2, 1.0)
    xp = x0 + 0.1 * rng.randn(Bk, n)
    xp[:, ::9] = 0.0
    return dict(m=m, end=m - 3, xp=xp, d=0.3 * rng.randn(Bk, n), gp=rng.randn(Bk, n),
                pg=rng.randn(Bk, n), S=rng.randn(Bk, m, n), Y=rng.randn(Bk, m, n),
                stp=0.2 + rng.rand(Bk), c=0.7)


def _rings_kept(S, Y, a, b):
    keep = [j for j in range(a["m"]) if j != a["end"]]
    assert np.array_equal(S[b, keep].numpy(), a["S"][b, keep])
    assert np.array_equal(Y[b, keep].numpy(), a["Y"][b, keep])


def test_k4b_deep_plain_matches_jax(deep_batch):
    a, end = deep_batch, deep_batch["end"]
    xp, gp, S, Y = (_t(a[k]) for k in ("xp", "gp", "S", "Y"))
    gd, gg, xx, changed, SP, YP = K.trial_pair_gram_batched(
        xp, _t(a["d"]), gp, _t(a["stp"]), S, Y, end, _t(LIVE))
    for b in range(len(LIVE)):
        if not LIVE[b]:
            for t, k in ((xp, "xp"), (gp, "gp"), (S, "S"), (Y, "Y")):
                assert np.array_equal(t[b].numpy(), a[k][b])
            continue
        jx, _jfx, jg, jgd, jgg, jxx, jch = j_rosen.trial_ref(
            jnp.asarray(a["xp"][b]), jnp.asarray(a["d"][b]), a["stp"][b])
        js, jy, jSP, jYP = j_fused.pair_gram_sd_ref(
            a["stp"][b], jnp.asarray(a["d"][b]), jg, jnp.asarray(a["gp"][b]),
            jnp.asarray(a["S"][b]), jnp.asarray(a["Y"][b]), end)
        _close(xp[b], jx, 1e-12)
        _close(gp[b], jg, 1e-12)
        for t, j in ((gd, jgd), (gg, jgg), (xx, jxx)):
            _close(t[b], j, 1e-10)
        assert bool(changed[b]) == bool(jch)
        assert SP.shape[1:] == YP.shape[1:] == (a["m"], 3)
        _close(SP[b], jSP, 1e-10)
        _close(YP[b], jYP, 1e-10)
        assert np.array_equal(S[b, end].numpy(), np.asarray(js))
        assert np.array_equal(Y[b, end].numpy(), np.asarray(jy))
        _rings_kept(S, Y, a, b)


@pytest.mark.parametrize("window", ["edge", "interior"])
def test_k14b_deep_plain_matches_jax(deep_batch, window):
    a, end = deep_batch, deep_batch["end"]
    lo, hi = {"edge": (0, 63), "interior": (5, 50)}[window]
    xp, gp, pg, S, Y = (_t(a[k]) for k in ("xp", "gp", "pg", "S", "Y"))
    xx, pp, changed, SP, YP = K.owlqn_trial_pair_gram_batched(
        xp, _t(a["d"]), gp, pg, _t(a["stp"]), a["c"], lo, hi, S, Y, end, _t(LIVE))
    for b in range(len(LIVE)):
        if not LIVE[b]:
            for t, k in ((xp, "xp"), (gp, "gp"), (pg, "pg"), (S, "S"), (Y, "Y")):
                assert np.array_equal(t[b].numpy(), a[k][b])
            continue
        jxp, jpg = jnp.asarray(a["xp"][b]), jnp.asarray(a["pg"][b])
        wp = j_choose_orthant(JOrthantwise(c=a["c"], start=lo, end=hi), jxp, jpg)
        jx, _jf, jg, _jgd, jxx, jch = j_rosen.owlqn_trial_ref(
            jxp, jnp.asarray(a["d"][b]), wp, a["stp"][b], a["c"], lo, hi)
        jpgn = j_fused.owlqn_pseudo_gradient_ref(jx, jg, a["c"], lo, hi)
        js, jy, jSP, jYP = j_fused.pair_gram_xg_ref(
            jx, jxp, jg, jnp.asarray(a["gp"][b]), jpgn, jnp.asarray(a["S"][b]),
            jnp.asarray(a["Y"][b]), end)
        _close(xp[b], jx, 1e-12)
        _close(gp[b], jg, 1e-12)
        _close(pg[b], jpgn, 1e-12)
        _close(xx[b], jxx, 1e-10)
        _close(pp[b], jnp.dot(jpgn, jpgn), 1e-10)
        assert bool(changed[b]) == bool(jch)
        _close(SP[b], jSP, 1e-10)
        _close(YP[b], jYP, 1e-10)
        assert np.array_equal(S[b, end].numpy(), np.asarray(js))
        assert np.array_equal(Y[b, end].numpy(), np.asarray(jy))
        _rings_kept(S, Y, a, b)


# ---------------------------------------------------------------------------
# whole runs against the JAX package
# ---------------------------------------------------------------------------

#: the settings this slice opens, plain and under OWL-QN (c = 1 on the whole
#: vector, More-Thuente routed to Armijo as in both packages)
RUNS = {
    "uncapped": lambda b: b.with_constrain_step_size(False),
    "adaptive": lambda b: b.with_constrain_step_size(False).with_adaptive_entry_step(2.0),
    "owlqn_uncapped": lambda b: b.with_orthantwise(*OW).with_constrain_step_size(False),
    "owlqn_adaptive": lambda b: b.with_orthantwise(*OW).with_constrain_step_size(False)
    .with_adaptive_entry_step(2.0),
}


@pytest.fixture(autouse=True)
def _quiet():
    # ``with_orthantwise``'s one-line notice that OWL-QN runs backtracking only
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


def _both(x0b, configure, **kw):
    j = configure(j_lbfgs()).minimize_batched(jnp.asarray(x0b), j_rosen.value_and_grad, **kw)
    t = configure(t_lbfgs()).minimize_batched(_t(x0b), t_rosen.value_and_grad, **kw)
    return j, t


def _hold_states(j, t, rtol=1e-9):
    """The same k, evaluations and status per instance; fx, the next entry
    step and dginit within ``rtol``."""
    js = interop.batched_state_from_jax(j, "cpu")
    for name in ("k", "neval", "status"):
        assert np.array_equal(getattr(t, name), getattr(js, name)), (
            name, getattr(t, name), getattr(js, name))
    for name in ("fx", "step", "dg0"):
        np.testing.assert_allclose(getattr(t, name), getattr(js, name), rtol=rtol, atol=0,
                                   err_msg=name)
    np.testing.assert_allclose(t.x.numpy(), js.x.numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("run", list(RUNS))
def test_batched_matches_jax_15_iterations(run):
    j, t = _both(PERTURBED, lambda b: RUNS[run](b).with_max_iterations(15), return_state=True)
    _hold_states(j, t)
    if run.endswith("adaptive"):
        # the adaptive policy moved some entry step off 1.0
        assert np.any(t.step != 1.0)


@pytest.mark.parametrize("run", list(RUNS))
def test_batched_matches_jax_to_epsilon(run):
    j, t = _both(PERTURBED, RUNS[run])
    assert np.array_equal(_np(j["status"]), _np(t["status"]))
    if run.startswith("owlqn"):
        # OWL-QN's runs stay in lockstep to the end
        for name in ("niter", "neval"):
            assert np.array_equal(_np(j[name]), _np(t[name])), name
        np.testing.assert_allclose(_np(t["fx"]), _np(j["fx"]), rtol=1e-9, atol=0)
        np.testing.assert_allclose(_np(t["x"]), _np(j["x"]), atol=1e-6, rtol=0)
        return
    assert np.all(_np(t["status"]) == Status.CONVERGED)
    assert np.all(_np(t["fx"]) <= 1e-8)
    np.testing.assert_allclose(_np(t["x"]), _np(j["x"]), atol=1e-4, rtol=0)
    # iterations: uncapped, these Rosenbrock runs part on the last bits
    # after some 25 iterations (the first 15 are held above), and rounding
    # alone then scatters an instance's iterations to epsilon by up to ~40%
    # (the JAX package's own batched run against its solo runs: 201 against
    # 144 iterations on instance 0 with the adaptive entry); their sum over
    # the eight instances stays within 10% of the JAX batched run's
    got, want = int(_np(t["niter"]).sum()), int(_np(j["niter"]).sum())
    assert abs(got - want) <= 0.1 * want, (_np(t["niter"]), _np(j["niter"]))


def test_batched_deep_matches_jax():
    """m = 80 ring rows (the deep K4 b and M = 0 K15 b on the card), uncapped,
    after 15 iterations."""
    cfg = lambda b: b._new(b.param.replace(m=80)).with_constrain_step_size(False) \
        .with_max_iterations(15)
    j, t = _both(PERTURBED, cfg, return_state=True)
    assert t.hist.s.shape == (B, 80, N)
    _hold_states(j, t)


N_FUSED = j_fused.MIN_FUSED_N


def test_resume_from_jax_fused_batched_state(monkeypatch):
    """Four iterations of the JAX package's fused batched run (float32, n =
    2^14, its kernels in interpret mode), four more in the port from its
    state, carried probes included: every first trip of the port's
    searches takes the carried one, and the run ends with the JAX run's
    iterations and evaluations, fx rel 1e-3."""
    monkeypatch.setenv("LBFGS_TPU_KERNELS_INTERPRET", "1")
    monkeypatch.setenv("LBFGS_TPU_KERNELS", "all")
    Bk = 2
    rng = np.random.RandomState(0)
    base = np.asarray(j_rosen.initial_point(N_FUSED, dtype=jnp.float32))
    x0b = jnp.asarray(base[None, :] + 0.05 * rng.randn(Bk, N_FUSED).astype(np.float32))
    cfg = lambda it: j_lbfgs().with_constrain_step_size(False).with_epsilon(0.0) \
        .with_max_iterations(it)
    j4 = cfg(4).minimize_batched(x0b, j_rosen.value_and_grad, return_state=True)
    st = interop.batched_state_from_jax(j4, "cpu")
    assert st.probe1 is not None
    assert all(p.shape == (Bk,) and p.dtype == np.float32 for p in st.probe1)
    np.testing.assert_array_equal(st.probe1[2], np.float32(1.0))
    st = st._replace(status=np.zeros(Bk, np.int64))
    used = t_ls.carried.used
    t8 = t_batched.run(TParams(max_iterations=8, epsilon=0.0, constrain_step_size=False),
                       t_rosen.value_and_grad, st)
    assert t_ls.carried.used - used == 4 * Bk
    j8 = cfg(8).minimize_batched(x0b, j_rosen.value_and_grad, return_state=True)
    assert np.array_equal(t8.k, np.asarray(j8.k))
    assert np.array_equal(t8.neval, np.asarray(j8.prob.neval))
    np.testing.assert_allclose(t8.fx, np.asarray(j8.prob.fx), rtol=1e-3)


# ---------------------------------------------------------------------------
# against the port's own solo runs
# ---------------------------------------------------------------------------

PARAMS = {
    "uncapped": TParams(constrain_step_size=False),
    "adaptive": TParams(constrain_step_size=False, adaptive_entry_step=2.0),
    "owlqn_uncapped": TParams(constrain_step_size=False, orthantwise=TOrthantwise(*OW)),
    "owlqn_adaptive": TParams(constrain_step_size=False, adaptive_entry_step=2.0,
                              orthantwise=TOrthantwise(*OW)),
}


@pytest.mark.parametrize("run", list(PARAMS))
def test_batched_matches_port_solo_f64(run):
    p = PARAMS[run].replace(max_iterations=15)
    st = t_batched.minimize_batched(p, _t(PERTURBED), t_rosen.value_and_grad, return_state=True)
    for b in range(B):
        so = t_minimize_jit(p, _t(PERTURBED[b]), t_rosen.value_and_grad, return_state=True)
        assert (so.k, so.prob.neval, so.status) == (int(st.k[b]), int(st.neval[b]),
                                                    int(st.status[b]))
        assert float(st.fx[b]) == pytest.approx(float(so.prob.fx), rel=1e-9)
        assert float(st.step[b]) == pytest.approx(float(so.step), rel=1e-9)
        np.testing.assert_allclose(st.x[b].numpy(), so.prob.x.numpy(), atol=1e-9)


@pytest.mark.parametrize("run", ["uncapped", "adaptive", "owlqn_uncapped"])
def test_batched_matches_port_solo_f32_bf16(run):
    """The main path's dtypes (float32 vectors, a bfloat16 ring) at a small
    size, the fusion on in both, held to solo runs by the fused-vs-unfused
    rule: the same iterations and evaluations, fx rel 1e-3, after 8
    iterations."""
    n, Bk = 1 << 10, 4
    rng = np.random.RandomState(0)
    base = np.asarray(t_rosen.initial_point(n, torch.float32, "cpu"))
    x0b = torch.from_numpy(base[None, :] + 0.05 * rng.randn(Bk, n).astype(np.float32))
    p = PARAMS[run].replace(max_iterations=9, epsilon=0.0, history_dtype="bfloat16")
    if p.orthantwise is not None:
        p = p.replace(orthantwise=TOrthantwise(1.0, 0, n - 1))
    st = t_batched.minimize_batched(p, x0b, t_rosen.value_and_grad, return_state=True)
    assert st.hist.s.dtype == torch.bfloat16 and st.probe1 is not None
    for b in range(Bk):
        solo = t_minimize_jit(p, x0b[b].clone(), t_rosen.value_and_grad, return_state=True)
        assert (solo.k, solo.prob.neval) == (int(st.k[b]), int(st.neval[b]))
        assert float(st.fx[b]) == pytest.approx(float(solo.prob.fx), rel=1e-3)


def test_batched_lasso_uncapped():
    """The lasso (the weighted quadratic's two extras under OWL-QN, c =
    0.3), uncapped with the adaptive entry: each instance takes its solo
    run's iterations and ends at the soft-threshold oracle, through K16 b."""
    n, Bk, c = 64, 3, 0.3
    rng = np.random.RandomState(2)
    w = torch.from_numpy(0.5 + rng.rand(n))
    tgt = torch.from_numpy(rng.randn(n))
    obj = t_sep.quadratic(w, tgt)
    x0b = torch.from_numpy(rng.randn(Bk, n))
    p = TParams(epsilon=1e-8, orthantwise=TOrthantwise(c, 0, None), constrain_step_size=False,
                adaptive_entry_step=2.0)
    out = t_batched.minimize_batched(p, x0b, obj)
    assert obj.kernels.combine_ow_probe_batched_ref.calls > 0
    oracle = torch.sign(tgt) * torch.clamp(tgt.abs() - c / w, min=0.0)
    for b in range(Bk):
        solo = t_minimize_jit(p, x0b[b].clone(), obj)
        assert int(out["niter"][b]) == solo.niter
        assert int(out["status"][b]) == Status.CONVERGED
        np.testing.assert_allclose(out["x"][b].numpy(), oracle.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the launch path, and the fusion against the same run without it
# ---------------------------------------------------------------------------


def _unfused(fn):
    """``fn`` without the combine+probe fusions' hooks, solo and batched
    (``chip_smoke.unfused``): the runner then takes K3 b (K13 b)."""
    def vag(x):
        return fn(x)

    vag.__dict__.update({k: v for k, v in fn.__dict__.items()
                         if not k.startswith(("__lbfgs_combine_probe", "__lbfgs_combine_ow_probe"))})
    return vag


def _refs(owlqn: bool) -> tuple:
    """(the fusion, the combine, the probe) plain versions of a path."""
    if owlqn:
        return (K.combine_ow_probe_batched_ref, t_fused.combine_ow_batched_ref,
                K.owlqn_probe_pg_batched_ref)
    return K.combine_probe_batched_ref, t_fused.combine_batched_ref, K.probe_batched_ref


@pytest.mark.parametrize("run", ["uncapped", "owlqn_uncapped", "adaptive"])
def test_launch_path_and_fusion_off_bit_for_bit(run):
    """One combine+probe per iteration, no combine, and a probe on no trip
    that every instance carried (the literal entry: every first trip after
    the first iteration's is carried); the same run on the objective
    without the fusion's hooks takes K3 b (K13 b) and one probe more per
    iteration, and ends in the same state bit for bit."""
    p = PARAMS[run].replace(max_iterations=12)
    refs = _refs(p.orthantwise is not None)
    x0b = _t(PERTURBED)

    def counted(fn):
        before = [f.calls for f in refs]
        used = t_ls.carried.used
        st = t_batched.minimize_batched(p, x0b.clone(), fn, return_state=True)
        return st, [f.calls - b0 for f, b0 in zip(refs, before)], t_ls.carried.used - used

    on, (cp, comb, probes_on), used = counted(t_rosen.value_and_grad)
    off, (cp_off, comb_off, probes_off), used_off = counted(_unfused(t_rosen.value_and_grad))
    iters = int(on.k.max()) - 1
    assert (cp, comb) == (iters, 0) and (cp_off, comb_off) == (0, iters)
    assert used_off == 0 and used > 0
    if run != "adaptive":
        # the literal entry step is the probed one on every search after
        # the first: each of those iterations saves its first trip's probe
        assert used == int(np.maximum(on.k - 2, 0).sum())
        assert probes_off - probes_on == iters - 1
    for name in ("k", "neval", "status", "fx", "step", "step_ls", "dg0", "gnorm2", "xnorm2"):
        assert _same(getattr(on, name), getattr(off, name)), name
    for name in ("x", "gx", "d"):
        assert torch.equal(getattr(on, name), getattr(off, name)), name
    assert torch.equal(on.hist.s, off.hist.s) and torch.equal(on.hist.y, off.hist.y)
    assert on.probe1 is not None and off.probe1 is None


def test_fusion_refused_runs_unfused():
    """Where the fusion's test refuses the shape (the quadratic at an odd n:
    the fusions take n a multiple of their two-element rows), the uncapped
    step runs unfused, K3 b and a probe on every trip, and each instance
    is its solo run."""
    n, Bk = 11, 3
    rng = np.random.RandomState(3)
    obj = t_sep.quadratic(torch.from_numpy(0.5 + rng.rand(n)), torch.from_numpy(rng.randn(n)))
    x0b = torch.from_numpy(rng.randn(Bk, n))
    p = TParams(constrain_step_size=False, adaptive_entry_step=2.0, epsilon=1e-8)
    fused_calls = obj.kernels.combine_probe_batched_ref.calls
    combines = t_fused.combine_batched_ref.calls
    st = t_batched.minimize_batched(p, x0b, obj, return_state=True)
    assert st.probe1 is None
    assert obj.kernels.combine_probe_batched_ref.calls == fused_calls
    assert t_fused.combine_batched_ref.calls - combines == int(st.k.max()) - 1
    for b in range(Bk):
        so = t_minimize_jit(p, x0b[b].clone(), obj, return_state=True)
        assert (so.k, so.prob.neval) == (int(st.k[b]), int(st.neval[b]))
        assert float(st.fx[b]) == pytest.approx(float(so.prob.fx), rel=1e-9, abs=1e-15)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_batch(dev, m, Bk=6, n=(1 << 12) + 2, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    live = torch.ones(Bk, dtype=torch.bool, device=dev)
    live[1::3] = False
    xp = -1.0 + 0.1 * r(Bk, n)
    xp[:, ::17] = 0.0
    return dict(xp=xp, d=0.1 * r(Bk, n), gp=r(Bk, n), pg=r(Bk, n),
                S=(0.1 * r(Bk, m, n)).bfloat16(), Y=(0.1 * r(Bk, m, n)).bfloat16(),
                stp=0.2 + torch.rand(Bk, generator=g, device=dev),
                coef=0.1 * r(Bk, 1 + 2 * m), live=live, end=m - 3, c=0.7, window=(3, n - 5))


def _vec(a, b):
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def _sum(a, b):
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [6, 80])
def test_batched_fusions_on_card(cuda, m):
    """K15 b and K16 b (M = m, and M = 0 at m = 80) against their plain
    versions on the card (vectors 1e-5, sums 1e-4), and per live instance
    against the solo K15 and K16 on that instance: r and rc bit for bit,
    the sums within 1e-6 (each instance's partials are the solo kernel's,
    but torch adds a [B, programs, k] array's columns in an order that
    depends on B at this size; ``chip_smoke.py`` holds them bit for bit at
    the main path's 1024 x 2^14); a frozen instance untouched."""
    a = _card_batch(cuda, m)
    live, (lo, hi), c = a["live"], a["window"], a["c"]
    fns = {
        "K15b": (lambda f, out: f(a["gp"], a["xp"], a["S"], a["Y"], a["coef"], a["stp"], live,
                                  out), K.combine_probe_batched, K.combine_probe_batched_ref),
        "K16b": (lambda f, out: f(a["pg"], a["xp"], a["S"], a["Y"], a["coef"], c, lo, hi,
                                  a["stp"], live, out), K.combine_ow_probe_batched,
                 K.combine_ow_probe_batched_ref),
    }
    for name, (call, kern, ref) in fns.items():
        rk, rp = torch.zeros_like(a["d"]), torch.zeros_like(a["d"])
        sk, sp = call(kern, rk), call(ref, rp)
        _vec(rk, rp)
        for u, v in zip(sk, sp):
            _sum(u[live], v[live])
        assert not rk[~live].any(), name
        for b in torch.nonzero(live).flatten().tolist():
            cf = a["coef"][b]
            gamma, cs, cy = cf[0], cf[1:1 + m], cf[1 + m:]
            stp = float(a["stp"][b])
            if name == "K15b":
                solo = K.combine_probe(a["gp"][b], a["xp"][b], a["S"][b], a["Y"][b], gamma, cs,
                                       cy, stp)
            else:
                solo = K.combine_ow_probe(a["pg"][b], a["xp"][b], a["S"][b], a["Y"][b], gamma,
                                          cs, cy, c, lo, hi, stp)
            assert torch.equal(rk[b], solo[0]), (name, b)
            for u, v in zip(sk, solo[1:]):
                torch.testing.assert_close(u[b], v, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_batched_deep_epilogues_on_card(cuda):
    """K4 b deep and K14 b deep at m = 80 against their plain versions
    (vectors 1e-5, sums 1e-4, ring rows the rounding of the kernel's own
    pair) and per live instance against the solo deep K4 and K14: x, g, pg
    and the rings bit for bit; a frozen instance untouched."""
    a = _card_batch(cuda, 80)
    live, (lo, hi), c, end = a["live"], a["window"], a["c"], a["end"]
    names = ("xp", "gp", "pg", "S", "Y")

    def run(fn, ow):
        t = {n_: a[n_].clone() for n_ in names}
        if ow:
            out = fn(t["xp"], a["d"], t["gp"], t["pg"], a["stp"], c, lo, hi, t["S"], t["Y"], end,
                     live)
        else:
            out = fn(t["xp"], a["d"], t["gp"], a["stp"], t["S"], t["Y"], end, live)
        return t, out

    for ow, kern, ref in ((False, K.trial_pair_gram_batched, K.trial_pair_gram_batched_ref),
                          (True, K.owlqn_trial_pair_gram_batched,
                           K.owlqn_trial_pair_gram_batched_ref)):
        deep = kern.deep_launches
        tk, ok_ = run(kern, ow)
        assert kern.deep_launches == deep + 1
        tp, op = run(ref, ow)
        for n_ in ("xp", "gp") + (("pg",) if ow else ()):
            _vec(tk[n_][live], tp[n_][live])
        for u, v in zip(ok_, op):
            if u.dtype != torch.bool:
                _sum(u[live], v[live])
        s_new = ((tk["xp"] - a["xp"]) if ow else a["stp"][:, None] * a["d"]).bfloat16()
        assert torch.equal(tk["S"][live][:, end], s_new[live])
        assert torch.equal(tk["Y"][live][:, end], (tk["gp"] - a["gp"]).bfloat16()[live])
        for n_ in names:
            assert torch.equal(tk[n_][~live], a[n_][~live]), n_
        for b in torch.nonzero(live).flatten().tolist():
            Sb, Yb = a["S"][b].clone(), a["Y"][b].clone()
            stp = float(a["stp"][b])
            if ow:
                x1, g1, pg1 = K.owlqn_trial_pair_gram(a["xp"][b], a["d"][b], a["gp"][b],
                                                      a["pg"][b], stp, c, lo, hi, Sb, Yb,
                                                      end)[:3]
                assert torch.equal(tk["pg"][b], pg1)
            else:
                x1, _, g1 = K.trial_pair_gram(a["xp"][b], a["d"][b], a["gp"][b], stp, Sb, Yb,
                                              end)[:3]
            assert torch.equal(tk["xp"][b], x1) and torch.equal(tk["gp"][b], g1)
            assert torch.equal(tk["S"][b], Sb) and torch.equal(tk["Y"][b], Yb)


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["uncapped", "owlqn_uncapped"])
def test_batched_uncapped_run_on_card(cuda, run):
    """A fused uncapped batched run on the card (m = 6 and 80) against the
    same run's plain versions on the card after 8 iterations
    (fused-vs-unfused rule)."""
    n, Bk = 1 << 12, 16
    x0b = (t_rosen.initial_point(n, torch.float32, "cuda")[None, :]
           + 0.05 * torch.randn(Bk, n, device=cuda, generator=torch.Generator(
               device=cuda).manual_seed(0)))
    fn = t_rosen.value_and_grad
    for m in (6, 80):
        p = PARAMS[run].replace(max_iterations=9, epsilon=0.0, history_dtype="bfloat16", m=m)
        if p.orthantwise is not None:
            p = p.replace(orthantwise=TOrthantwise(1.0, 0, n - 1))
        a = t_batched.minimize_batched(p, x0b, fn)
        b = t_batched.minimize_batched(p, x0b, fn.plain)
        assert torch.equal(a["niter"], b["niter"]) and torch.equal(a["neval"], b["neval"])
        torch.testing.assert_close(a["fx"], b["fx"], rtol=1e-3, atol=0)
