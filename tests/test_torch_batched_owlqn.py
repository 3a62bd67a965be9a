"""The port's batched runner under OWL-QN (``lbfgs_torch.batched``
with ``with_orthantwise``, at the capped step) against the JAX package's
(``lbfgs_tpu.batched``) and against its own solo runs, on the CPU, where
K8 b, K14 b, K13 b and K10 b run their plain versions.

  * the vectorized backtracking search under OWL-QN (the Armijo exit
    only, More-Thuente routed to it) against the scalar
    ``linesearch.backtracking`` with OWL-QN on, bit for bit, on seeded
    polynomial probes;
  * the batched plain versions of K8, K14, K13 and K10, per instance,
    against the JAX package's jnp oracles in float64, on a window at the
    vector's edge and an interior one: rel 1e-12 on vectors, 1e-10 on
    sums, ring rows bit for bit, a frozen instance untouched;
  * ``tests/test_batched.py::test_batched_owlqn`` through both packages;
    eight perturbed instances in float64 against the JAX batched run,
    after 15 iterations and to epsilon; a run resumed from the JAX
    package's batched OWL-QN state; batched runs against the port's solo
    ``minimize_jit`` (float64, and float32 vectors with a float32 or a
    bfloat16 ring under the fused-vs-unfused rule); the lasso (an
    objective with extras); an instance whose search fails.

The cases marked ``cuda`` hold the four forms to their plain versions
and to the solo kernels on the card, and skip without one.
"""

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
from test_torch_batched import ALGOS, B, N, _Poly, _close, _np, _same, _t

#: the L1 term of the whole runs: c = 1 on the whole vector, as the JAX
#: package's test_batched_owlqn
OW = (1.0, 0, None)


# ---------------------------------------------------------------------------
# the vectorized OWL-QN search against the scalar one
# ---------------------------------------------------------------------------


def _owlqn_stand_in(poly, i):
    """An objective whose projected probe (K8's pg form) is instance i's
    polynomial: the scalar search sees exactly the batched search's values."""

    def vag(x):
        raise AssertionError("not evaluated")

    def probe_pg(xp, d, pg, stp, c, start, end):
        ft, dg = poly(poly.dtype(stp), i)
        return torch.tensor(ft), torch.tensor(dg)

    vag.__lbfgs_owlqn_probe_pg__ = probe_pg
    return vag


@pytest.mark.parametrize("max_ls", [20, 4])
@pytest.mark.parametrize("algo", ALGOS)
def test_batched_owlqn_search_matches_scalar(algo, max_ls):
    dtype = np.float32
    K = 120
    rng = np.random.RandomState(7)
    poly = _Poly(rng, K, dtype)
    ls = TLsParams(algorithm=algo, max_linesearch=max_ls)
    finit, dginit = poly(np.zeros(K, dtype))
    stp0 = (rng.rand(K) * 3.0 + 0.01).astype(dtype)
    stp0[::13] = dtype(1.0)
    neval0 = np.arange(K, dtype=np.int64)
    live = rng.rand(K) < 0.9
    trips = []

    def probe(stp, run):
        trips.append(int(run.sum()))
        return poly(stp)

    got = bs.find(ls, live, finit, dginit, stp0, neval0, probe, ow=True)
    xp = torch.zeros(1, dtype=torch.float32)
    for i in range(K):
        if not live[i]:
            assert (got.neval[i], got.ncall[i], got.status[i]) == (neval0[i], 0, 0)
            continue
        pdef = ProblemDef(value_and_grad=_owlqn_stand_in(poly, i), owlqn=TOrthantwise(*OW))
        want = t_ls.find(pdef, ls, xp, finit[i], xp, xp, stp0[i], int(neval0[i]),
                         dginit=dginit[i], materialize=False, pgp=xp)
        assert _same(want.fx, got.fx[i]) and _same(want.step, got.step[i]), i
        assert _same(want.step_eval, got.step_eval[i]), i
        assert (want.ncall, want.neval, want.status) == (
            got.ncall[i], got.neval[i], got.status[i]), i
    assert trips[0] == live.sum() and trips[-1] < trips[0]
    if algo != "BacktrackingArmijo":
        # the OWL-QN rule, not the ladder asked for: some instance ends
        # otherwise without it
        plain = bs.find(ls, live, finit, dginit, stp0, neval0, lambda stp, run: poly(stp))
        assert not (np.array_equal(plain.step, got.step)
                    and np.array_equal(plain.neval, got.neval))


# ---------------------------------------------------------------------------
# the batched plain versions against the JAX package's references
# ---------------------------------------------------------------------------

WINDOWS = {"edge": (0, 63), "interior": (5, 50)}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(4)
    Bk, n, m = 4, 64, 6
    x0 = np.where(np.arange(n) % 2 == 0, -1.2, 1.0)
    xp = x0 + 0.1 * rng.randn(Bk, n)
    xp[:, ::9] = 0.0           # the orthant's at-zero choice
    return dict(
        xp=xp, d=0.3 * rng.randn(Bk, n), gp=rng.randn(Bk, n), pg=rng.randn(Bk, n),
        S=rng.randn(Bk, m, n), Y=rng.randn(Bk, m, n), stp=0.2 + rng.rand(Bk),
        coef=rng.randn(Bk, 1 + 2 * m), end=2, m=m, c=0.7,
        live=np.array([True, True, False, True]),
    )


def _jow(a, lo, hi):
    return JOrthantwise(c=a["c"], start=lo, end=hi)


@pytest.mark.parametrize("window", list(WINDOWS))
def test_k8b_plain_matches_jax(batch, window):
    a, (lo, hi) = batch, WINDOWS[window]
    ft, dg = t_rosen.value_and_grad.kernels.owlqn_probe_pg_batched(
        _t(a["xp"]), _t(a["d"]), _t(a["pg"]), _t(a["stp"]), a["c"], lo, hi, _t(a["live"]))
    for b in np.flatnonzero(a["live"]):
        jf, jd = j_rosen.owlqn_probe_pg_ref(
            jnp.asarray(a["xp"][b]), jnp.asarray(a["d"][b]), jnp.asarray(a["pg"][b]),
            a["stp"][b], a["c"], lo, hi)
        _close(ft[b], jf, 1e-10)
        _close(dg[b], jd, 1e-10)


@pytest.mark.parametrize("window", list(WINDOWS))
def test_k14b_plain_matches_jax(batch, window):
    """K14 b per instance against the JAX package's oracles composed:
    ``owlqn_trial_ref`` at the orthant of (xp, pg), then
    ``owlqn_pseudo_gradient_ref`` and ``pair_gram_xg_ref``."""
    a, end, (lo, hi) = batch, batch["end"], WINDOWS[window]
    xp, gp, pg, S, Y = (_t(a[k]) for k in ("xp", "gp", "pg", "S", "Y"))
    xx, pp, changed, SP, YP = t_rosen.value_and_grad.kernels.owlqn_trial_pair_gram_batched(
        xp, _t(a["d"]), gp, pg, _t(a["stp"]), a["c"], lo, hi, S, Y, end, _t(a["live"]))
    for b in range(a["xp"].shape[0]):
        if not a["live"][b]:
            for t, k in ((xp, "xp"), (gp, "gp"), (pg, "pg"), (S, "S"), (Y, "Y")):
                assert np.array_equal(t[b].numpy(), a[k][b])
            continue
        jxp, jpg = jnp.asarray(a["xp"][b]), jnp.asarray(a["pg"][b])
        wp = j_choose_orthant(_jow(a, lo, hi), jxp, jpg)
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
        keep = [j for j in range(a["m"]) if j != end]
        assert np.array_equal(S[b, keep].numpy(), a["S"][b, keep])
        assert np.array_equal(Y[b, keep].numpy(), a["Y"][b, keep])


@pytest.mark.parametrize("window", list(WINDOWS))
def test_k13b_plain_matches_jax(batch, window):
    a, m, (lo, hi) = batch, batch["m"], WINDOWS[window]
    out = _t(a["d"])
    rr, rc2, rcpg = t_fused.combine_ow_batched(_t(a["pg"]), _t(a["S"]), _t(a["Y"]),
                                               _t(a["coef"]), _t(a["live"]), out, lo, hi)
    for b in range(a["xp"].shape[0]):
        if not a["live"][b]:
            assert np.array_equal(out[b].numpy(), a["d"][b])
            continue
        c = a["coef"][b]
        jrc, jrr, jrc2, jrcd = j_fused.combine_ow_ref(
            jnp.asarray(a["pg"][b]), jnp.asarray(a["S"][b]), jnp.asarray(a["Y"][b]), c[0],
            jnp.asarray(c[1:1 + m]), jnp.asarray(c[1 + m:]), lo, hi)
        _close(out[b], jrc, 1e-12)
        for t, j in ((rr, jrr), (rc2, jrc2), (rcpg, jrcd)):
            _close(t[b], j, 1e-10)


@pytest.mark.parametrize("window", list(WINDOWS))
def test_k10b_plain_matches_jax(batch, window):
    a, (lo, hi) = batch, WINDOWS[window]
    out = _t(a["d"])
    pp = t_fused.pseudo_gradient_norm_batched(_t(a["xp"]), _t(a["gp"]), a["c"], lo, hi,
                                              _t(a["live"]), out)
    for b in range(a["xp"].shape[0]):
        if not a["live"][b]:
            assert np.array_equal(out[b].numpy(), a["d"][b])
            continue
        jpg, jpp = j_fused.owlqn_pseudo_gradient_norm_ref(
            jnp.asarray(a["xp"][b]), jnp.asarray(a["gp"][b]), a["c"], lo, hi)
        _close(out[b], jpg, 1e-12)
        _close(pp[b], jpp, 1e-10)


# ---------------------------------------------------------------------------
# whole runs against the JAX package
# ---------------------------------------------------------------------------


def _perturbed():
    """Eight perturbed Rosenbrock starts (seed 0), as tests/test_batched.py's
    plain case."""
    rng = np.random.RandomState(0)
    return np.tile(np.asarray(j_rosen.initial_point(N)), (B, 1)) + 0.1 * rng.randn(B, N)


PERTURBED = _perturbed()


def _both(x0b, configure=lambda b: b, fn=(j_rosen.value_and_grad, t_rosen.value_and_grad),
          **kw):
    ow = lambda b: configure(b.with_orthantwise(*OW))
    j = ow(j_lbfgs()).minimize_batched(jnp.asarray(x0b), fn[0], **kw)
    t = ow(t_lbfgs()).minimize_batched(_t(x0b), fn[1], **kw)
    return j, t


def test_batched_owlqn_matches_jax_test():
    """``tests/test_batched.py::test_batched_owlqn`` through both packages:
    four identical instances from x0 = 1, every one CONVERGED, identical
    rows, and the JAX run's iterations, evaluations, fx and x."""
    x0b = np.ones((4, N))
    j, t = _both(x0b)
    assert np.all(_np(t["status"]) == Status.CONVERGED)
    xs = _np(t["x"])
    np.testing.assert_array_equal(xs, np.tile(xs[0], (xs.shape[0], 1)))
    for k in ("status", "niter", "neval"):
        assert np.array_equal(_np(j[k]), _np(t[k])), k
    np.testing.assert_allclose(_np(t["fx"]), _np(j["fx"]), rtol=1e-9, atol=0)
    np.testing.assert_allclose(xs, _np(j["x"]), rtol=0, atol=1e-6)
    # gnorm is ||pg||, the JAX package's gnorm_of under OWL-QN
    np.testing.assert_allclose(_np(t["gnorm"]), _np(j["gnorm"]), rtol=1e-3)
    assert set(t) == set(j)


def test_batched_owlqn_matches_jax_15_iterations():
    j, t = _both(PERTURBED, lambda b: b.with_max_iterations(15))
    for k in ("status", "niter", "neval"):
        assert np.array_equal(_np(j[k]), _np(t[k])), (k, _np(j[k]), _np(t[k]))
    np.testing.assert_allclose(_np(t["fx"]), _np(j["fx"]), rtol=1e-9, atol=0)
    for k in ("fx", "xnorm", "gnorm", "x"):
        assert t[k].dtype == torch.float64 and t[k].device.type == "cpu"


def test_batched_owlqn_matches_jax_to_epsilon():
    j, t = _both(PERTURBED)
    # instance 4 ends on the zero-direction check in both packages
    assert np.array_equal(_np(j["status"]), _np(t["status"]))
    assert (_np(t["status"]) == Status.CONVERGED).sum() == B - 1
    np.testing.assert_allclose(_np(t["fx"]), _np(j["fx"]), rtol=1e-9, atol=0)
    np.testing.assert_allclose(_np(t["x"]), _np(j["x"]), atol=1e-6, rtol=0)


def test_resume_from_jax_batched_owlqn_state():
    """Eight iterations in the JAX package, seven more in the port from its
    state (``interop.batched_state_from_jax``, pg included), against
    fifteen in JAX."""
    cfg = lambda it: j_lbfgs().with_orthantwise(*OW).with_max_iterations(it)
    j8 = cfg(8).minimize_batched(jnp.asarray(PERTURBED), j_rosen.value_and_grad,
                                 return_state=True)
    st = interop.batched_state_from_jax(j8, "cpu")
    assert st.pg is not None and st.pg.shape == (B, N)
    np.testing.assert_array_equal(st.pg.numpy(), np.asarray(j8.prob.pg))
    st = st._replace(status=np.zeros(B, np.int64))
    t15 = t_batched.run(TParams(max_iterations=15, orthantwise=TOrthantwise(*OW)),
                        t_rosen.value_and_grad, st)
    j15 = cfg(15).minimize_batched(jnp.asarray(PERTURBED), j_rosen.value_and_grad,
                                   return_state=True)
    assert np.array_equal(t15.k, np.asarray(j15.k))
    assert np.array_equal(t15.neval, np.asarray(j15.prob.neval))
    np.testing.assert_allclose(t15.fx, np.asarray(j15.prob.fx), rtol=1e-9)
    np.testing.assert_allclose(t15.x.numpy(), np.asarray(j15.prob.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t15.pg.numpy(), np.asarray(j15.prob.pg), rtol=0, atol=1e-8)


def test_failed_search_keeps_x_g_pg():
    """With min_step = 1e-3 instance 4's search fails at iteration 10
    (LS_MIN_STEP) in both packages: the port's instance keeps the x, g and
    pg of iteration 9 bit for bit, and ends where the JAX run reverts it
    to, its pg the one the JAX runner recomputes there."""
    cfg = lambda b, it: b.with_orthantwise(*OW).with_linesearch_min_step(1e-3) \
        .with_max_iterations(it)
    j = cfg(j_lbfgs(), 40).minimize_batched(jnp.asarray(PERTURBED), j_rosen.value_and_grad,
                                            return_state=True)
    t = cfg(t_lbfgs(), 40).minimize_batched(_t(PERTURBED), t_rosen.value_and_grad,
                                            return_state=True)
    t9 = cfg(t_lbfgs(), 9).minimize_batched(_t(PERTURBED), t_rosen.value_and_grad,
                                            return_state=True)
    failed = np.flatnonzero(t.ls_status != 0)
    assert failed.tolist() == [4] and t.k[4] == 10
    assert np.array_equal(t.status, np.asarray(j.status))
    assert np.array_equal(t.ls_status, np.asarray(j.ls_status))
    assert np.array_equal(t.k, np.asarray(j.k))
    for name in ("x", "gx", "pg"):
        assert torch.equal(getattr(t, name)[4], getattr(t9, name)[4]), name
    np.testing.assert_allclose(t.x[4].numpy(), np.asarray(j.prob.x[4]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.gx[4].numpy(), np.asarray(j.prob.gx[4]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(t.pg[4].numpy(), np.asarray(j.prob.pg[4]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(t.fx, np.asarray(j.prob.fx), rtol=1e-9)


# ---------------------------------------------------------------------------
# against the port's own solo runs
# ---------------------------------------------------------------------------


OW_PARAMS = TParams(orthantwise=TOrthantwise(*OW))


def test_batched_owlqn_matches_port_solo_f64():
    p = OW_PARAMS.replace(max_iterations=15)
    out = t_batched.minimize_batched(p, _t(PERTURBED), t_rosen.value_and_grad)
    for b in range(B):
        st = t_minimize_jit(p, _t(PERTURBED[b]), t_rosen.value_and_grad, return_state=True)
        assert (st.k, st.prob.neval, st.status) == (
            int(out["niter"][b]), int(out["neval"][b]), int(out["status"][b]))
        assert float(out["fx"][b]) == pytest.approx(float(st.prob.fx), rel=1e-9)
        assert float(out["gnorm"][b]) == pytest.approx(float(np.sqrt(st.prob.gnorm2)),
                                                       rel=1e-6)
        np.testing.assert_allclose(out["x"][b].numpy(), st.prob.x.numpy(), atol=1e-9)


@pytest.mark.parametrize("hdtype", ["float32", "bfloat16"])
def test_batched_owlqn_matches_port_solo_f32(hdtype):
    """float32 vectors with a float32 or bfloat16 ring at a small size,
    held to solo runs by the fused-vs-unfused rule: the same iterations and
    evaluations, fx rel 1e-3, after 8 iterations."""
    n, Bk = 1 << 10, 4
    rng = np.random.RandomState(0)
    base = np.asarray(t_rosen.initial_point(n, torch.float32, "cpu"))
    x0b = torch.from_numpy(base[None, :] + 0.05 * rng.randn(Bk, n).astype(np.float32))
    p = OW_PARAMS.replace(max_iterations=9, epsilon=0.0, history_dtype=hdtype,
                          orthantwise=TOrthantwise(1.0, 0, n - 1))
    st = t_batched.minimize_batched(p, x0b, t_rosen.value_and_grad, return_state=True)
    assert st.hist.s.dtype == getattr(torch, hdtype) and st.pg.dtype == torch.float32
    for b in range(Bk):
        solo = t_minimize_jit(p, x0b[b].clone(), t_rosen.value_and_grad, return_state=True)
        assert (solo.k, solo.prob.neval) == (int(st.k[b]), int(st.neval[b]))
        assert float(st.fx[b]) == pytest.approx(float(solo.prob.fx), rel=1e-3)


def test_batched_lasso():
    """The lasso (the weighted quadratic with its two extras under OWL-QN,
    c = 0.3): the instances share w and t, each takes its solo run's
    iterations and ends at the soft-threshold oracle."""
    n, Bk, c = 64, 3, 0.3
    rng = np.random.RandomState(2)
    w = torch.from_numpy(0.5 + rng.rand(n))
    tgt = torch.from_numpy(rng.randn(n))
    obj = t_sep.quadratic(w, tgt)
    x0b = torch.from_numpy(rng.randn(Bk, n))
    p = TParams(epsilon=1e-8, orthantwise=TOrthantwise(c, 0, None))
    out = t_batched.minimize_batched(p, x0b, obj)
    k = obj.kernels
    assert k.owlqn_probe_pg_batched_ref.calls > 0 and k.owlqn_trial_pair_gram_batched_ref.calls > 0
    oracle = torch.sign(tgt) * torch.clamp(tgt.abs() - c / w, min=0.0)
    for b in range(Bk):
        solo = t_minimize_jit(p, x0b[b].clone(), obj)
        assert int(out["niter"][b]) == solo.niter
        assert int(out["status"][b]) == Status.CONVERGED
        np.testing.assert_allclose(out["x"][b].numpy(), oracle.numpy(), atol=1e-6)


def test_batched_owlqn_launch_path():
    """One run's kernel path on the CPU: K10 b once, K8 b per search trip,
    K14 b and K13 b once per iteration, and nothing of the plain path."""
    x0b = _t(PERTURBED)
    k = t_rosen.value_and_grad.kernels
    refs = (k.owlqn_probe_pg_batched_ref, k.owlqn_trial_pair_gram_batched_ref,
            t_fused.combine_ow_batched_ref, t_fused.pseudo_gradient_norm_batched_ref,
            k.probe_batched_ref, k.trial_pair_gram_batched_ref, t_fused.combine_batched_ref)
    before = [f.calls for f in refs]
    st = t_lbfgs().with_orthantwise(*OW).with_max_iterations(6).minimize_batched(
        x0b, t_rosen.value_and_grad, return_state=True)
    calls = [f.calls - b0 for f, b0 in zip(refs, before)]
    iters = int(st.k.max()) - 1
    assert calls[1] == calls[2] == iters and calls[3] == 1
    assert calls[0] >= iters and calls[4:] == [0, 0, 0]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_batch(dev, Bk=6, n=1 << 12, m=6, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    live = torch.ones(Bk, dtype=torch.bool, device=dev)
    live[1::3] = False
    xp = -1.0 + 0.1 * r(Bk, n)
    xp[:, ::17] = 0.0
    return dict(xp=xp, d=0.1 * r(Bk, n), gp=r(Bk, n), pg=r(Bk, n),
                S=r(Bk, m, n).bfloat16(), Y=r(Bk, m, n).bfloat16(),
                stp=0.2 + torch.rand(Bk, generator=g, device=dev),
                coef=r(Bk, 1 + 2 * m), live=live, end=2, c=0.7, window=(3, n - 5))


@pytest.mark.cuda
def test_batched_owlqn_kernels_match_plain_on_card(cuda):
    """K8 b, K14 b, K13 b and K10 b against their plain versions on the
    card: vectors within 1e-5 normwise, sums 1e-4, ring rows bit for bit."""
    a = _card_batch(cuda)
    k = t_rosen.value_and_grad.kernels
    lo, hi = a["window"]
    live = a["live"]
    tol = dict(rtol=1e-5, atol=1e-5)
    got = k.owlqn_probe_pg_batched(a["xp"], a["d"], a["pg"], a["stp"], a["c"], lo, hi, live)
    want = k.owlqn_probe_pg_batched_ref(a["xp"], a["d"], a["pg"], a["stp"], a["c"], lo, hi,
                                        live)
    for u, v in zip(got, want):
        torch.testing.assert_close(u[live], v[live], rtol=1e-4, atol=1e-3)

    def k14(fn):
        t = {n_: a[n_].clone() for n_ in ("xp", "gp", "pg", "S", "Y")}
        out = fn(t["xp"], a["d"], t["gp"], t["pg"], a["stp"], a["c"], lo, hi, t["S"], t["Y"],
                 a["end"], live)
        return t, out

    tk, ok_ = k14(k.owlqn_trial_pair_gram_batched)
    tp, op = k14(k.owlqn_trial_pair_gram_batched_ref)
    for n_ in ("xp", "gp", "pg"):
        torch.testing.assert_close(tk[n_][live], tp[n_][live], **tol)
    # ring row end of a live instance the rounding of the kernel's own pair
    s_new, y_new = (tk["xp"] - a["xp"]).bfloat16(), (tk["gp"] - a["gp"]).bfloat16()
    assert torch.equal(tk["S"][live][:, a["end"]], s_new[live])
    assert torch.equal(tk["Y"][live][:, a["end"]], y_new[live])
    keep = [j for j in range(a["S"].shape[1]) if j != a["end"]]
    assert torch.equal(tk["S"][:, keep], a["S"][:, keep])
    assert torch.equal(tk["Y"][:, keep], a["Y"][:, keep])
    for n_ in ("xp", "gp", "pg", "S", "Y"):
        assert torch.equal(tk[n_][~live], a[n_][~live])
    out = torch.zeros_like(a["d"])
    ref = torch.zeros_like(a["d"])
    sk = t_fused.combine_ow_batched(a["pg"], a["S"], a["Y"], a["coef"], live, out, lo, hi)
    sp = t_fused.combine_ow_batched_ref(a["pg"], a["S"], a["Y"], a["coef"], live, ref, lo, hi)
    torch.testing.assert_close(out, ref, **tol)
    for u, v in zip(sk, sp):
        torch.testing.assert_close(u[live], v[live], rtol=1e-4, atol=1e-3)
    pgk, pgp = torch.zeros_like(a["d"]), torch.zeros_like(a["d"])
    ppk = t_fused.pseudo_gradient_norm_batched(a["xp"], a["gp"], a["c"], lo, hi, live, pgk)
    ppp = t_fused.pseudo_gradient_norm_batched_ref(a["xp"], a["gp"], a["c"], lo, hi, live, pgp)
    assert torch.equal(pgk, pgp)
    torch.testing.assert_close(ppk[live], ppp[live], rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_batched_owlqn_kernels_match_solo_on_card(cuda):
    """Each live instance's x, g, pg and ring rows from K14 b, rc from K13 b
    and pg from K10 b equal the solo K14, K13 and K10 on that instance
    alone bit for bit; K8 b's point is K8's (its sums within 1e-6)."""
    a = _card_batch(cuda)
    k = t_rosen.value_and_grad.kernels
    lo, hi = a["window"]
    live, m, c = a["live"], a["S"].shape[1], a["c"]
    ft, dg = k.owlqn_probe_pg_batched(a["xp"], a["d"], a["pg"], a["stp"], c, lo, hi, live)
    xp, gp, pg, S, Y = (a[n_].clone() for n_ in ("xp", "gp", "pg", "S", "Y"))
    k.owlqn_trial_pair_gram_batched(xp, a["d"], gp, pg, a["stp"], c, lo, hi, S, Y, a["end"],
                                    live)
    r = torch.zeros_like(a["d"])
    t_fused.combine_ow_batched(pg, S, Y, a["coef"], live, r, lo, hi)
    pgb = torch.zeros_like(a["d"])
    t_fused.pseudo_gradient_norm_batched(a["xp"], a["gp"], c, lo, hi, live, pgb)
    for b in range(a["xp"].shape[0]):
        if not live[b]:
            assert not r[b].any() and not pgb[b].any()
            continue
        stp = float(a["stp"][b])
        sft, sdg = k.owlqn_probe_pg(a["xp"][b], a["d"][b], a["pg"][b], stp, c, lo, hi)
        torch.testing.assert_close(ft[b], sft, rtol=1e-6, atol=0)
        torch.testing.assert_close(dg[b], sdg, rtol=1e-6, atol=1e-6)
        Sb, Yb = a["S"][b].clone(), a["Y"][b].clone()
        x1, g1, pg1 = k.owlqn_trial_pair_gram(a["xp"][b], a["d"][b], a["gp"][b], a["pg"][b],
                                              stp, c, lo, hi, Sb, Yb, a["end"])[:3]
        assert torch.equal(xp[b], x1) and torch.equal(gp[b], g1) and torch.equal(pg[b], pg1)
        assert torch.equal(S[b], Sb) and torch.equal(Y[b], Yb)
        cf = a["coef"][b]
        r1 = t_fused.combine_ow(pg1, Sb, Yb, cf[0], cf[1:1 + m], cf[1 + m:], lo, hi)[0]
        assert torch.equal(r[b], r1)
        p1 = t_fused.pseudo_gradient_norm(a["xp"][b], a["gp"][b], c, lo, hi)[0]
        assert torch.equal(pgb[b], p1)


@pytest.mark.cuda
def test_batched_owlqn_run_on_card(cuda):
    """A batched OWL-QN run on the card against the same run's plain
    versions on the card after 8 iterations (fused-vs-unfused rule)."""
    n, Bk = 1 << 12, 16
    x0b = (t_rosen.initial_point(n, torch.float32, "cuda")[None, :]
           + 0.05 * torch.randn(Bk, n, device=cuda, generator=torch.Generator(
               device=cuda).manual_seed(0)))
    p = OW_PARAMS.replace(max_iterations=9, epsilon=0.0, history_dtype="bfloat16",
                          orthantwise=TOrthantwise(1.0, 0, n - 1))
    fn = t_rosen.value_and_grad
    a = t_batched.minimize_batched(p, x0b, fn)
    b = t_batched.minimize_batched(p, x0b, fn.plain)
    assert torch.equal(a["niter"], b["niter"]) and torch.equal(a["neval"], b["neval"])
    torch.testing.assert_close(a["fx"], b["fx"], rtol=1e-3, atol=0)
