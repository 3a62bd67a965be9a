"""The port's batched runner (``lbfgs_torch.batched.minimize_batched``)
against the JAX package's (``lbfgs_tpu.batched``) and against its own
solo runs, on the CPU, where K2 b, K4 b and K3 b run their plain versions.

  * the vectorized searches (``lbfgs_torch._batched_search``) against the
    scalar ones of ``lbfgs_torch.linesearch``, bit for bit, on seeded
    random cases: the trial-interval update (NaN positions included) and
    whole More-Thuente and backtracking searches over a polynomial probe
    computed alike for both;
  * the batched plain versions of K2, K4 and K3, per instance, against the
    JAX package's jnp references in float64: rel 1e-12 on vectors, 1e-10
    on sums, ring rows bit for bit, a frozen instance untouched;
  * ``tests/test_batched.py``'s two plain cases through both packages in
    float64 on the same inputs: after 15 iterations the same status,
    iterations and evaluations per instance and fx rel 1e-9; run to
    epsilon, the same status, fx <= 1e-8 and x within 1e-4 of the JAX
    run, and iterations within 2, or within the spread the JAX package's
    own batched run shows against its solo runs on the same instances
    where that is wider (long Rosenbrock runs part on the last bits);
  * the three backtracking searches against the JAX package, a run
    resumed from the JAX package's batched state, batched runs against
    the port's solo ``minimize_jit`` (float64, and float32 with a bfloat16
    ring under the fused-vs-unfused rule), an objective with extras, the
    returned state, and every setting the batched runner refuses.

The cases marked ``cuda`` hold K2 b, K4 b and K3 b to their plain
versions and to the solo kernels on the card, and skip without one.
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
from lbfgs_torch.minimize import minimize_jit as t_minimize_jit
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.models import separable as t_sep
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_torch.params import LineSearchParams as TLsParams
from lbfgs_torch.status import Status
from lbfgs_tpu import lbfgs as j_lbfgs
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.ops import fused as j_fused

ALGOS = ("MoreThuente", "BacktrackingArmijo", "BacktrackingWolfe", "BacktrackingStrongWolfe")
N, B = 10, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(a, b):
    """Bit for bit, NaN positions included."""
    a, b = np.asarray(a), np.asarray(b)
    nan = np.isnan(a) if a.dtype.kind == "f" else np.zeros(a.shape, bool)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(nan, np.isnan(b) if b.dtype.kind == "f" else nan)
            and np.array_equal(a[~nan], b[~nan]))


# ---------------------------------------------------------------------------
# the vectorized searches against the scalar ones
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("brackt", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_update_trial_interval_matches_scalar(dtype, brackt):
    rng = np.random.RandomState(11 + brackt)
    K = 3000
    v = lambda scale=1.0: (rng.randn(K) * scale).astype(dtype)
    x, y, t = v(), v(), v()
    fx, fy, ft = v(), v(), v()
    dx, dy, dt = v(), v(), v()
    # degenerate cases: zero derivatives, equal points, equal values
    for a in (dx, dt, dy):
        a[rng.rand(K) < 0.05] = 0.0
    eq = rng.rand(K) < 0.05
    t[eq] = x[eq]
    feq = rng.rand(K) < 0.05
    ft[feq] = fx[feq]
    tmin = np.minimum(x, y) - np.abs(v())
    tmax = np.maximum(x, y) + np.abs(v(4.0))
    swap = rng.rand(K) < 0.05
    tmin[swap], tmax[swap] = tmax[swap], tmin[swap]
    got = bs.update_trial_interval(x, fx, dx, y, fy, dy, t, ft, dt, tmin, tmax,
                                   np.full(K, brackt))
    nans = 0
    for i in range(K):
        want = t_ls.update_trial_interval(x[i], fx[i], dx[i], y[i], fy[i], dy[i], t[i], ft[i],
                                          dt[i], tmin[i], tmax[i], brackt)
        for name in want._fields:
            w, g = np.asarray(getattr(want, name)), np.asarray(getattr(got, name)[i])
            if name == "brackt":
                assert bool(w) == bool(g), (i, name)
            elif name == "status":
                assert int(w) == int(g), (i, name)
            else:
                assert _same(w, g.astype(w.dtype)) and g.dtype == w.dtype, (i, name, w, g)
                nans += bool(np.isnan(w))
    # the cases reach the NaN branches too
    assert nans > 0


class _Poly:
    """phi(t) = c0 + c1 t + c2 t^2 + c3 t^4 per instance, and phi'(t), in
    one dtype: the same numpy operations whether they run on scalars (the
    scalar search's probe) or on [B] arrays (the batched search's)."""

    def __init__(self, rng, K, dtype):
        g = lambda: rng.randn(K).astype(dtype)
        self.c0, self.c2 = g(), g()
        self.c1 = -(np.abs(g()) + dtype(0.1))
        self.c3 = np.abs(g()) * dtype(0.1) + dtype(1e-3)
        self.dtype = dtype

    def __call__(self, t, i=slice(None)):
        c0, c1, c2, c3 = self.c0[i], self.c1[i], self.c2[i], self.c3[i]
        two, four = self.dtype(2.0), self.dtype(4.0)
        ft = c0 + t * (c1 + t * (c2 + t * t * c3))
        dg = c1 + t * (two * c2 + t * t * (four * c3))
        return ft, dg


def _scalar_objective(poly, i, dtype):
    """A fused-protocol stand-in whose probe is instance i's polynomial:
    the scalar search's probes see exactly the batched search's values."""
    tdtype = torch.float32 if dtype == np.float32 else torch.float64

    def vag(x):
        raise AssertionError("not evaluated")

    def probe(xp, d, stp):
        ft, dg = poly(dtype(stp), i)
        return torch.tensor(ft, dtype=tdtype), torch.tensor(dg, dtype=tdtype)

    vag.__lbfgs_trial__ = lambda *a: None
    vag.__lbfgs_trial_probe__ = probe
    return vag


@pytest.mark.parametrize("max_ls", [20, 4])
@pytest.mark.parametrize("algo", ALGOS)
def test_batched_search_matches_scalar(algo, max_ls):
    from lbfgs_torch.core import ProblemDef

    dtype = np.float32
    K = 120
    rng = np.random.RandomState(5)
    poly = _Poly(rng, K, dtype)
    ls = TLsParams(algorithm=algo, max_linesearch=max_ls)
    finit, dginit = poly(np.zeros(K, dtype))
    stp0 = (rng.rand(K) * 3.0 + 0.01).astype(dtype)
    stp0[::17] = dtype(1.0)
    neval0 = np.arange(K, dtype=np.int64)
    live = rng.rand(K) < 0.9
    trips = []

    def probe(stp, run):
        trips.append(int(run.sum()))
        return poly(stp)

    got = bs.find(ls, live, finit, dginit, stp0, neval0, probe)
    xp = torch.zeros(1, dtype=torch.float32)
    for i in range(K):
        if not live[i]:
            assert (got.neval[i], got.ncall[i], got.status[i]) == (neval0[i], 0, 0)
            assert got.step[i] == stp0[i] and got.fx[i] == finit[i]
            continue
        pdef = ProblemDef(value_and_grad=_scalar_objective(poly, i, dtype))
        want = t_ls.find(pdef, ls, xp, finit[i], xp, xp, stp0[i], int(neval0[i]),
                         dginit=dginit[i], materialize=False)
        assert _same(want.fx, got.fx[i]) and _same(want.step, got.step[i]), i
        assert _same(want.step_eval, got.step_eval[i]), i
        assert (want.ncall, want.neval, want.status) == (
            got.ncall[i], got.neval[i], got.status[i]), i
    # the trips narrow as the instances finish
    assert trips[0] == live.sum() and trips[-1] < trips[0]


# ---------------------------------------------------------------------------
# the batched plain versions against the JAX package's references
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(3)
    Bk, n, m = 4, 64, 6
    x0 = np.where(np.arange(n) % 2 == 0, -1.2, 1.0)
    return dict(
        xp=x0 + 0.1 * rng.randn(Bk, n), d=0.1 * rng.randn(Bk, n), gp=rng.randn(Bk, n),
        S=rng.randn(Bk, m, n), Y=rng.randn(Bk, m, n), stp=0.2 + rng.rand(Bk),
        coef=rng.randn(Bk, 1 + 2 * m), end=2, m=m, live=np.array([True, True, False, True]),
    )


def _close(t, j, rtol):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * np.abs(j).max())


def test_k2b_plain_matches_jax(batch):
    a = batch
    ft, dg = t_rosen.value_and_grad.kernels.probe_batched(
        _t(a["xp"]), _t(a["d"]), _t(a["stp"]), _t(a["live"]))
    for b in np.flatnonzero(a["live"]):
        jf, jd = j_rosen.probe_ref(jnp.asarray(a["xp"][b]), jnp.asarray(a["d"][b]), a["stp"][b])
        _close(ft[b], jf, 1e-10)
        _close(dg[b], jd, 1e-10)


def test_k4b_plain_matches_jax(batch):
    a, end = batch, batch["end"]
    xp, gp, S, Y = (_t(a[k]) for k in ("xp", "gp", "S", "Y"))
    live = _t(a["live"])
    gd, gg, xx, changed, SP, YP = t_rosen.value_and_grad.kernels.trial_pair_gram_batched(
        xp, _t(a["d"]), gp, _t(a["stp"]), S, Y, end, live)
    for b in range(a["xp"].shape[0]):
        if not a["live"][b]:
            # a frozen instance: nothing written
            for t, k in ((xp, "xp"), (gp, "gp"), (S, "S"), (Y, "Y")):
                assert np.array_equal(t[b].numpy(), a[k][b])
            continue
        jx, jfx, jg, jgd, jgg, jxx, jch = j_rosen.trial_ref(
            jnp.asarray(a["xp"][b]), jnp.asarray(a["d"][b]), a["stp"][b])
        js, jy, jSP, jYP = j_fused.pair_gram_sd_ref(
            a["stp"][b], jnp.asarray(a["d"][b]), jg, jnp.asarray(a["gp"][b]),
            jnp.asarray(a["S"][b]), jnp.asarray(a["Y"][b]), end)
        _close(xp[b], jx, 1e-12)
        _close(gp[b], jg, 1e-12)
        for t, j in ((gd, jgd), (gg, jgg), (xx, jxx)):
            _close(t[b], j, 1e-10)
        assert bool(changed[b]) == bool(jch)
        _close(SP[b], jSP, 1e-10)
        _close(YP[b], jYP, 1e-10)
        # the ring rows bit for bit: row `end` the pair, the others kept
        assert np.array_equal(S[b, end].numpy(), np.asarray(js))
        assert np.array_equal(Y[b, end].numpy(), np.asarray(jy))
        keep = [j for j in range(a["m"]) if j != end]
        assert np.array_equal(S[b, keep].numpy(), a["S"][b, keep])
        assert np.array_equal(Y[b, keep].numpy(), a["Y"][b, keep])


def test_k3b_plain_matches_jax(batch):
    a, m = batch, batch["m"]
    out = _t(a["d"])
    rr, rg = t_fused.combine_batched(_t(a["gp"]), _t(a["S"]), _t(a["Y"]), _t(a["coef"]),
                                     _t(a["live"]), out)
    for b in range(a["xp"].shape[0]):
        if not a["live"][b]:
            assert np.array_equal(out[b].numpy(), a["d"][b])
            continue
        c = a["coef"][b]
        jr = j_fused.combine_ref(jnp.asarray(a["gp"][b]), jnp.asarray(a["S"][b]),
                                 jnp.asarray(a["Y"][b]), c[0], jnp.asarray(c[1:1 + m]),
                                 jnp.asarray(c[1 + m:]))
        _close(out[b], jr, 1e-12)
        _close(rr[b], jnp.dot(jr, jr), 1e-10)
        _close(rg[b], jnp.dot(jr, jnp.asarray(a["gp"][b])), 1e-10)


# ---------------------------------------------------------------------------
# whole runs against the JAX package
# ---------------------------------------------------------------------------


def _cases():
    """``tests/test_batched.py``'s two plain cases: eight perturbed
    Rosenbrock starts (seed 0), and the early finisher (x0 = 1 beside the
    standard start)."""
    rng = np.random.RandomState(0)
    x0b = np.tile(np.asarray(j_rosen.initial_point(N)), (B, 1)) + 0.1 * rng.randn(B, N)
    early = np.stack([np.ones(N), np.asarray(j_rosen.initial_point(N))])
    return {"perturbed": x0b, "early_finisher": early}


CASES = _cases()


def _both(x0b, configure=lambda b: b, **kw):
    j = configure(j_lbfgs()).minimize_batched(jnp.asarray(x0b), j_rosen.value_and_grad, **kw)
    t = configure(t_lbfgs()).minimize_batched(_t(x0b), t_rosen.value_and_grad, **kw)
    return j, t


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_lockstep(j, t, rtol=1e-9):
    for k in ("status", "niter", "neval"):
        assert np.array_equal(_np(j[k]), _np(t[k])), (k, _np(j[k]), _np(t[k]))
    np.testing.assert_allclose(_np(t["fx"]), _np(j["fx"]), rtol=rtol, atol=0)
    for k in ("fx", "xnorm", "gnorm", "x"):
        assert t[k].dtype == torch.float64 and t[k].device.type == "cpu"


@pytest.mark.parametrize("case", list(CASES))
def test_batched_matches_jax_15_iterations(case):
    j, t = _both(CASES[case], lambda b: b.with_max_iterations(15))
    _assert_lockstep(j, t)
    assert set(t) == set(j)


@pytest.mark.parametrize("case", list(CASES))
def test_batched_matches_jax_to_epsilon(case):
    x0b = CASES[case]
    j, t = _both(x0b)
    assert np.array_equal(_np(j["status"]), _np(t["status"]))
    assert np.all(_np(t["status"]) == Status.CONVERGED)
    assert np.all(_np(t["fx"]) <= 1e-8)
    np.testing.assert_allclose(_np(t["x"]), _np(j["x"]), atol=1e-4, rtol=0)
    # iterations: within 2, or within the JAX package's own batched-vs-solo
    # spread on these instances where that is wider
    solo = np.array([j_lbfgs().minimize_jit(jnp.asarray(x), j_rosen.value_and_grad).niter
                     for x in x0b])
    spread = max(2, int(np.abs(solo - _np(j["niter"])).max()))
    assert np.abs(_np(t["niter"]) - _np(j["niter"])).max() <= spread
    if case == "early_finisher":
        assert int(t["niter"][0]) == 0 and int(t["neval"][0]) == 1
        assert np.array_equal(_np(t["niter"]), _np(j["niter"]))


@pytest.mark.parametrize("algo", ALGOS[1:])
def test_batched_backtracking_matches_jax(algo):
    j, t = _both(CASES["perturbed"],
                 lambda b: b.with_linesearch_algorithm(algo).with_max_iterations(15))
    _assert_lockstep(j, t)


def test_resume_from_jax_batched_state():
    """Eight iterations in the JAX package, seven more in the port from its
    state (``interop.batched_state_from_jax``), against fifteen in JAX."""
    x0b = CASES["perturbed"]
    j8 = j_lbfgs().with_max_iterations(8).minimize_batched(
        jnp.asarray(x0b), j_rosen.value_and_grad, return_state=True)
    st = interop.batched_state_from_jax(j8, "cpu")
    assert st.x.shape == (B, N) and st.hist.s.shape == (B, 6, N)
    st = st._replace(status=np.zeros(B, np.int64))
    t15 = t_batched.run(TParams(max_iterations=15), t_rosen.value_and_grad, st)
    j15 = j_lbfgs().with_max_iterations(15).minimize_batched(
        jnp.asarray(x0b), j_rosen.value_and_grad, return_state=True)
    assert np.array_equal(t15.k, np.asarray(j15.k))
    assert np.array_equal(t15.neval, np.asarray(j15.prob.neval))
    np.testing.assert_allclose(t15.fx, np.asarray(j15.prob.fx), rtol=1e-9)
    np.testing.assert_allclose(t15.x.numpy(), np.asarray(j15.prob.x), rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# against the port's own solo runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("params", [
    TParams(max_iterations=15),
    # the past/delta plateau test stops instances on their own iterations
    TParams(max_iterations=40, fx_delta_enabled=True, past=3, delta=0.05),
], ids=["defaults", "fx_delta"])
def test_batched_matches_port_solo_f64(params):
    x0b = CASES["perturbed"]
    p = params
    out = t_batched.minimize_batched(p, _t(x0b), t_rosen.value_and_grad)
    for b in range(B):
        st = t_minimize_jit(p, _t(x0b[b]), t_rosen.value_and_grad, return_state=True)
        assert (st.k, st.prob.neval, st.status) == (
            int(out["niter"][b]), int(out["neval"][b]), int(out["status"][b]))
        assert float(out["fx"][b]) == pytest.approx(float(st.prob.fx), rel=1e-9)
        np.testing.assert_allclose(out["x"][b].numpy(), st.prob.x.numpy(), atol=1e-9)


def test_batched_matches_port_solo_f32_bf16():
    """The main path's dtypes (float32 vectors, a bfloat16 ring) at a small
    size, held to solo runs by the fused-vs-unfused rule: the same
    iterations and evaluations, fx rel 1e-3, after 8 iterations."""
    n, Bk = 1 << 10, 4
    rng = np.random.RandomState(0)
    base = np.asarray(t_rosen.initial_point(n, torch.float32, "cpu"))
    x0b = torch.from_numpy(base[None, :] + 0.05 * rng.randn(Bk, n).astype(np.float32))
    p = TParams(max_iterations=9, epsilon=0.0, history_dtype="bfloat16")
    st = t_batched.minimize_batched(p, x0b, t_rosen.value_and_grad, return_state=True)
    assert st.hist.s.dtype == torch.bfloat16 and st.x.dtype == torch.float32
    for b in range(Bk):
        solo = t_minimize_jit(p, x0b[b].clone(), t_rosen.value_and_grad, return_state=True)
        assert (solo.k, solo.prob.neval) == (int(st.k[b]), int(st.neval[b]))
        assert float(st.fx[b]) == pytest.approx(float(solo.prob.fx), rel=1e-3)


def test_batched_extras_objective():
    """An objective with extras (the weighted quadratic): the instances
    share w and t, and each ends where its solo run ends, at x = t."""
    n, Bk = 64, 3
    rng = np.random.RandomState(2)
    w = torch.from_numpy(0.5 + rng.rand(n))
    tgt = torch.from_numpy(rng.randn(n))
    obj = t_sep.quadratic(w, tgt)
    x0b = torch.from_numpy(rng.randn(Bk, n))
    p = TParams(epsilon=1e-8)
    out = t_batched.minimize_batched(p, x0b, obj)
    assert obj.kernels.probe_batched_ref.calls > 0
    for b in range(Bk):
        solo = t_minimize_jit(p, x0b[b].clone(), obj)
        assert int(out["niter"][b]) == solo.niter
        np.testing.assert_allclose(out["x"][b].numpy(), tgt.numpy(), atol=1e-6)


def test_return_state():
    x0b = CASES["early_finisher"]
    st = t_lbfgs().with_max_iterations(15).minimize_batched(
        _t(x0b), t_rosen.value_and_grad, return_state=True)
    assert isinstance(st, t_batched.BatchedState)
    assert st.x.shape == st.gx.shape == st.d.shape == (2, N)
    assert st.hist.s.shape == (2, 6, N) and st.hist.sy.shape == (2, 6, 6)
    # the early finisher: frozen at its start, nothing of it written
    assert st.k[0] == 0 and st.neval[0] == 1 and st.status[0] == Status.CONVERGED
    assert np.array_equal(st.x[0].numpy(), np.ones(N))
    assert not st.hist.s[0].any() and not st.hist.sy[0].any()
    assert st.k[1] == 15 and st.status[1] == Status.MAX_ITERATIONS
    j = j_lbfgs().with_max_iterations(15).minimize_batched(
        jnp.asarray(x0b), j_rosen.value_and_grad, return_state=True)
    js = interop.batched_state_from_jax(j, "cpu")
    for name in ("k", "neval", "status", "end", "ncall", "ls_status"):
        assert np.array_equal(getattr(st, name), getattr(js, name)), name
    for name in ("fx", "step", "step_ls", "dg0", "gnorm2", "xnorm2"):
        np.testing.assert_allclose(getattr(st, name), getattr(js, name), rtol=1e-9,
                                   err_msg=name)
    for name in ("s", "y", "ys", "sy", "yy", "alpha"):
        np.testing.assert_allclose(getattr(st.hist, name).numpy(),
                                   getattr(js.hist, name).numpy(), rtol=1e-7, atol=1e-9)


UNSUPPORTED = {
    # the settings the batched runner refused until it took them: OWL-QN,
    # the uncapped step, the adaptive entry step, any depth
    # (tests/test_torch_batched_uncapped.py), damping and the gradient-only
    # mode (tests/test_torch_batched_damped.py), generic objectives
    # (tests/test_torch_batched_generic.py), and the wide objective scalar,
    # the scan two-loop and a float16 history
    # (tests/test_torch_batched_settings.py) run batched now, and so does
    # the speculative search (on the Armijo ladder it takes;
    # tests/test_torch_batched_speculative.py), which raised
    # ``NotImplementedError`` until it was ported; with the gradient-only
    # mode it raises ``ValueError``, as ``lbfgs_tpu`` does
    "damped_fx_wide": lambda b: b.with_damping(True).with_fx_wide(),
    "damped_scan_two_loop": lambda b: b.with_damping(True).with_compact_two_loop(False),
    "damped_float16_history": lambda b: b.with_damping(True).with_history_dtype("float16"),
    "gradient_only_speculative": lambda b: b.with_gradient_only().with_speculative_linesearch(4),
    "generic_damped_fx_wide": lambda b: b.with_damping(True).with_fx_wide(),
    "damped_owlqn_float16_history": lambda b: b.with_orthantwise(1.0, 0, None)
    .with_damping(True).with_history_dtype("float16"),
    "fx_wide": lambda b: b.with_fx_wide(),
    "scan_two_loop": lambda b: b.with_compact_two_loop(False),
    "float16_history": lambda b: b.with_history_dtype("float16"),
    "float16_deep_history": lambda b: b._new(b.param.replace(m=80)).with_history_dtype("float16"),
    "speculative": lambda b: (b.with_linesearch_algorithm("BacktrackingArmijo")
                              .with_speculative_linesearch(4)),
    "generic_float16_history": lambda b: b.with_history_dtype("float16"),
}
#: the settings of ``UNSUPPORTED`` the batched runner refuses, as
#: ``lbfgs_tpu`` refuses them
STILL_REFUSED = ("gradient_only_speculative",)


@pytest.mark.parametrize("setting", list(UNSUPPORTED))
def test_unsupported_settings_raise(setting):
    """The speculative search with the gradient-only mode raises
    ``ValueError``, as ``lbfgs_tpu`` does; each setting the runner refused
    until it took it
    now runs, every instance of the early-finisher batch as its solo run
    (the whole-run loop): the same iterations, evaluations and status, fx
    rel 1e-9 (1e-5 over a float16 ring, whose 11-bit pairs carry the
    batched row sums' and the solo dots' last bits into the trajectory:
    3e-7 after 20 iterations)."""
    x0b = _t(CASES["early_finisher"])
    opt, fn = UNSUPPORTED[setting](t_lbfgs()), t_rosen.value_and_grad
    if setting.startswith("generic"):
        fn = t_rosen._plain_value_and_grad
    if setting in STILL_REFUSED:
        with pytest.raises(ValueError, match="Armijo-only ladder"):
            opt.minimize_batched(x0b, fn)
        return
    opt = opt.with_max_iterations(20)
    out = opt.minimize_batched(x0b, fn)
    for b in range(len(x0b)):
        solo = opt.minimize_jit(x0b[b].clone(), fn)
        assert (int(out["niter"][b]), int(out["neval"][b]), int(out["status"][b])) == (
            solo.niter, solo.neval, solo.status), (setting, b)
        rel = 1e-5 if "float16" in setting else 1e-9
        assert float(out["fx"][b]) == pytest.approx(float(solo.fx), rel=rel, abs=1e-300)


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
    return dict(xp=-1.0 + 0.1 * r(Bk, n), d=0.1 * r(Bk, n), gp=r(Bk, n),
                S=r(Bk, m, n).bfloat16(), Y=r(Bk, m, n).bfloat16(),
                stp=0.2 + torch.rand(Bk, generator=g, device=dev),
                coef=r(Bk, 1 + 2 * m), live=live, end=2)


@pytest.mark.cuda
def test_batched_kernels_match_solo_on_card(cuda):
    """Each live instance's x, g, ring row and r from K4 b and K3 b equal
    the solo K4 and K3 on that instance bit for bit; K2 b's sums K2's; a
    frozen instance is untouched."""
    a = _card_batch(cuda)
    k = t_rosen.value_and_grad.kernels
    ft, dg = k.probe_batched(a["xp"], a["d"], a["stp"], a["live"])
    xp, gp, S, Y = (a[n].clone() for n in ("xp", "gp", "S", "Y"))
    k.trial_pair_gram_batched(xp, a["d"], gp, a["stp"], S, Y, a["end"], a["live"])
    r = torch.zeros_like(a["d"])
    t_fused.combine_batched(gp, S, Y, a["coef"], a["live"], r)
    m = S.shape[1]
    for b in range(a["xp"].shape[0]):
        if not a["live"][b]:
            for t, n in ((xp, "xp"), (gp, "gp"), (S, "S"), (Y, "Y")):
                assert torch.equal(t[b], a[n][b])
            assert not r[b].any()
            continue
        stp = float(a["stp"][b])
        sft, sdg = k.probe(a["xp"][b], a["d"][b], stp)
        assert torch.equal(ft[b], sft) and torch.equal(dg[b], sdg)
        Sb, Yb = a["S"][b].clone(), a["Y"][b].clone()
        x1, _, g1 = k.trial_pair_gram(a["xp"][b], a["d"][b], a["gp"][b], stp, Sb, Yb,
                                      a["end"])[:3]
        assert torch.equal(xp[b], x1) and torch.equal(gp[b], g1)
        assert torch.equal(S[b], Sb) and torch.equal(Y[b], Yb)
        c = a["coef"][b]
        r1 = t_fused.combine(g1, Sb, Yb, c[0], c[1:1 + m], c[1 + m:])[0]
        assert torch.equal(r[b], r1)


@pytest.mark.cuda
@pytest.mark.parametrize("hdtype", ["bfloat16", "float32"])
def test_batched_run_on_card(cuda, hdtype):
    """A batched run on the card against the same run's plain versions on
    the card after 8 iterations (fused-vs-unfused rule)."""
    n, Bk = 1 << 12, 16
    x0b = (t_rosen.initial_point(n, torch.float32, "cuda")[None, :]
           + 0.05 * torch.randn(Bk, n, device=cuda, generator=torch.Generator(
               device=cuda).manual_seed(0)))
    p = TParams(max_iterations=9, epsilon=0.0, history_dtype=hdtype)
    fn = t_rosen.value_and_grad
    a = t_batched.minimize_batched(p, x0b, fn)
    b = t_batched.minimize_batched(p, x0b, fn.plain)
    assert torch.equal(a["niter"], b["niter"]) and torch.equal(a["neval"], b["neval"])
    torch.testing.assert_close(a["fx"], b["fx"], rtol=1e-3, atol=0)
