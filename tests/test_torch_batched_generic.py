"""The port's batched runner on generic objectives (``lbfgs_torch.batched``
with an objective that carries no batched kernels), against the JAX
package's (``lbfgs_tpu.batched``, whose vmap runs its generic branch) and
against its own solo runs, on the CPU, where K9 b, K11 b and K12 b run
their plain versions.

  * the plain versions of K9 b, K11 b and K12 b per instance against the
    JAX package's jnp oracles in float64 (rel 1e-12 on vectors, 1e-10 on
    sums; K12 b at m = 6 and 80), each instance's point, pg and ring rows
    bit for bit the solo plain versions', frozen instances untouched; the
    batched ``solver.update_pair_batched`` per instance against the solo
    ``update_pair``;
  * eight perturbed instances in float64 against the JAX batched run on a
    hook-free Rosenbrock, after 15 iterations: the same k, evaluations,
    status, ring row, ``ncall`` and ``ls_status``; fx, the entry step,
    dginit and the carried norms rel 1e-9; the rings, their Gram blocks
    and the alphas rtol 1e-7.  Plain capped, uncapped and adaptive,
    More-Thuente and the three backtracking searches, OWL-QN capped and
    uncapped, damped, ``damping_fixed``, gradient-only, damped OWL-QN,
    m = 80, and the L1 Poisson regression (500 x 21, c = 1 on [1, 21));
  * the objective shapes: a scalar objective runs as JAX runs it, a
    mutating closure and a host function raise ``ValueError`` as JAX does;
  * one case through the JAX package's vmapped Pallas kernels K9, K12 and
    K13 in interpret mode (float32, a bfloat16 ring, n = 2^14);
  * each instance against the port's solo run; failed and frozen
    instances keep their x, g, pg, rings and Gram blocks; the launch path
    (K11 b once, K9 b per trip, K10 b, K12 b and K13 b per OWL-QN
    iteration, K3 b per plain one, no K12 b damped) and the reads.

The cases marked ``cuda`` hold K9 b, K11 b and K12 b to their plain
versions and, on instances 0, B/2 and B - 1, to the solo kernels on the
card, and skip without one.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from lbfgs_torch import batched as t_batched
from lbfgs_torch import interop
from lbfgs_torch import lbfgs as t_lbfgs
from lbfgs_torch import orthantwise as t_ow
from lbfgs_torch import solver as t_solver
from lbfgs_torch.core import to_host
from lbfgs_torch.minimize import minimize as t_minimize
from lbfgs_torch.minimize import minimize_jit as t_minimize_jit
from lbfgs_torch.models import logistic as t_logistic
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.orthantwise import Orthantwise as TOrthantwise
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_torch.params import LineSearchParams as TLsParams
from lbfgs_torch.status import Status
from lbfgs_tpu import batched as j_batched
from lbfgs_tpu import lbfgs as j_lbfgs
from lbfgs_tpu.models import logistic as j_logistic
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.ops import fused as j_fused
from test_torch_batched import B, N, _close, _t
from test_torch_batched_owlqn import OW, PERTURBED
from test_torch_batched_uncapped import LIVE

T_PLAIN = t_rosen._plain_value_and_grad


def j_plain(x):
    """The JAX package's Rosenbrock without its kernel hooks: a generic
    objective, which its batched runner vmaps."""
    return j_rosen.value_and_grad(x)


@pytest.fixture(autouse=True)
def _quiet():
    # ``with_orthantwise``'s one-line notice that OWL-QN runs backtracking only
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


# ---------------------------------------------------------------------------
# the plain versions against the JAX package's references (float64)
# ---------------------------------------------------------------------------

WINDOWS = {"edge": (0, 63), "interior": (5, 50)}


@pytest.fixture(scope="module", params=(6, 80), ids=lambda m: f"m{m}")
def generic_batch(request):
    m, n = request.param, 64
    rng = np.random.RandomState(18 + m)
    Bk = len(LIVE)
    xp = np.where(np.arange(n) % 2 == 0, -1.2, 1.0) + 0.1 * rng.randn(Bk, n)
    xp[:, ::9] = 0.0
    x = xp + 0.3 * rng.randn(Bk, n)
    x[:, ::7] = 0.0
    return dict(m=m, end=m - 3, xp=xp, x=x, d=0.3 * rng.randn(Bk, n), gx=rng.randn(Bk, n),
                gp=rng.randn(Bk, n), pg=rng.randn(Bk, n), S=rng.randn(Bk, m, n),
                Y=rng.randn(Bk, m, n), stp=0.2 + rng.rand(Bk), c=0.7)


@pytest.mark.parametrize("window", list(WINDOWS))
def test_k9b_plain_matches_jax(generic_batch, window):
    """The projected trial points against the JAX package's K9 oracle with
    the search's orthant, and per instance the solo K9's plain version bit
    for bit; a frozen instance's row untouched."""
    a = generic_batch
    lo, hi = WINDOWS[window]
    out = _t(a["d"])
    got = t_fused.owlqn_trial_step_batched(_t(a["xp"]), _t(a["d"]), _t(a["pg"]), _t(a["stp"]),
                                           lo, hi, _t(LIVE), out)
    assert got is out
    for b in range(len(LIVE)):
        if not LIVE[b]:
            assert np.array_equal(out[b].numpy(), a["d"][b])
            continue
        wp = t_ow.choose_orthant(TOrthantwise(1.0, lo, hi), _t(a["xp"][b]), _t(a["pg"][b]))
        jx = j_fused.owlqn_trial_step_ref(jnp.asarray(a["xp"][b]), jnp.asarray(a["d"][b]),
                                          jnp.asarray(wp.numpy()), a["stp"][b], lo, hi)
        _close(out[b], jx, 1e-12)
        solo = t_fused.owlqn_trial_step_ref(_t(a["xp"][b]), _t(a["d"][b]), wp, a["stp"][b], lo,
                                            hi)
        assert torch.equal(out[b], solo), b
    # the window projects something, and the at-zero orthant choice is used
    assert (out[LIVE][:, lo:hi] == 0).any()


@pytest.mark.parametrize("window", list(WINDOWS))
def test_k11b_plain_matches_jax(generic_batch, window):
    a = generic_batch
    lo, hi = WINDOWS[window]
    out = _t(a["pg"])
    t_fused.pseudo_gradient_batched(_t(a["x"]), _t(a["gx"]), a["c"], lo, hi, _t(LIVE), out)
    for b in range(len(LIVE)):
        if not LIVE[b]:
            assert np.array_equal(out[b].numpy(), a["pg"][b])
            continue
        jpg = j_fused.owlqn_pseudo_gradient_ref(jnp.asarray(a["x"][b]), jnp.asarray(a["gx"][b]),
                                                a["c"], lo, hi)
        _close(out[b], jpg, 1e-12)
        solo = t_fused.pseudo_gradient_ref(_t(a["x"][b]), _t(a["gx"][b]), a["c"], lo, hi)
        assert torch.equal(out[b], solo), b
        # K10 b's pg is K11 b's
        pgn = _t(a["pg"])
        t_fused.pseudo_gradient_norm_batched(_t(a["x"]), _t(a["gx"]), a["c"], lo, hi, _t(LIVE),
                                             pgn)
        assert torch.equal(pgn[b], out[b])


def test_k12b_plain_matches_jax(generic_batch):
    """The pair + Gram update against the JAX package's K12 oracle: sums
    1e-10, ring rows bit for bit; per instance the solo K12's plain version
    (ring rows bit for bit, sums 1e-12: torch's batched and unbatched
    products may add in other orders); a frozen instance's rings
    untouched."""
    a, end = generic_batch, generic_batch["end"]
    S, Y = _t(a["S"]), _t(a["Y"])
    SP, YP = t_fused.pair_gram_xg_batched(*(_t(a[k]) for k in ("x", "xp", "gx", "gp", "pg")),
                                          S, Y, end, _t(LIVE))
    assert SP.shape[1:] == YP.shape[1:] == (a["m"], 3)
    for b in range(len(LIVE)):
        if not LIVE[b]:
            assert np.array_equal(S[b].numpy(), a["S"][b])
            assert np.array_equal(Y[b].numpy(), a["Y"][b])
            continue
        js, jy, jSP, jYP = j_fused.pair_gram_xg_ref(
            *(jnp.asarray(a[k][b]) for k in ("x", "xp", "gx", "gp", "pg", "S", "Y")), end)
        _close(SP[b], jSP, 1e-10)
        _close(YP[b], jYP, 1e-10)
        assert np.array_equal(S[b, end].numpy(), np.asarray(js))
        assert np.array_equal(Y[b, end].numpy(), np.asarray(jy))
        Sb, Yb = _t(a["S"][b]), _t(a["Y"][b])
        sSP, sYP = t_fused.pair_gram_xg_ref(*(_t(a[k][b]) for k in ("x", "xp", "gx", "gp", "pg")),
                                            Sb, Yb, end)
        assert torch.equal(S[b], Sb) and torch.equal(Y[b], Yb), b
        _close(SP[b], sSP.numpy(), 1e-12)
        _close(YP[b], sYP.numpy(), 1e-12)


@pytest.mark.parametrize("fixed", [False, True], ids=["literal", "fixed"])
def test_update_pair_batched_matches_solo(fixed):
    """``update_pair_batched`` per instance against the solo ``update_pair``
    on pairs where damping cases 0, 1 and 2 all occur: the same case and
    s, ys, ss, yy and gamma rel 1e-13 (row products against dots); the
    damped y bit for bit the solo blend of the same products."""
    rng = np.random.RandomState(40 + fixed)
    Bk, n = 24, 50
    x, xp = _t(rng.randn(Bk, n)), _t(rng.randn(Bk, n))
    step = _t(0.2 + rng.rand(Bk))
    # gp against s, so that s.(-step*gp) > 0, and y = t*(-step*gp) + noise
    # with t on both sides of the bounds 1 - sigma2 and 1 + sigma3
    gp = -0.5 * (x - xp) + 0.1 * _t(rng.randn(Bk, n))
    t = _t(rng.uniform(-1.0, 6.0, (Bk, 1)))
    gx = gp + t * (-step[:, None] * gp) + 0.01 * _t(rng.randn(Bk, n))
    p = TParams(damping=True, damping_fixed=fixed)
    pu = t_solver.update_pair_batched(p, x, xp, gx, gp, step)
    cases = set()
    for b in range(Bk):
        solo = t_solver.update_pair(p, x[b], xp[b], gx[b], gp[b], np.float64(step[b]))
        assert int(pu.case[b]) == solo.case, b
        cases.add(solo.case)
        assert torch.equal(pu.s[b], solo.s)
        y0 = gx[b] - gp[b]
        for got, want in ((pu.ys[b], solo.ys), (pu.gamma[b], solo.gamma),
                          (pu.ss[b], torch.dot(solo.s, solo.s)), (pu.yy[b], torch.dot(y0, y0))):
            assert float(got) == pytest.approx(float(want), rel=1e-13)
        np.testing.assert_allclose(pu.y[b].numpy(), solo.y.numpy(), rtol=1e-11, atol=1e-12)
        # the blend of one instance from the same products
        bs = -step[b] * gp[b]
        y1, c1 = t_solver._damp_pair(p, y0, bs, pu.ys[b], (pu.s[b] * bs).sum())
        assert torch.equal(y1, pu.y[b]) and int(c1) == solo.case, b
    assert cases == {0, 1, 2}
    # the same pair undamped: y untouched, no case
    pu0 = t_solver.update_pair_batched(TParams(), x, xp, gx, gp)
    assert pu0.case is None and torch.equal(pu0.y, gx - gp)


# ---------------------------------------------------------------------------
# whole runs against the JAX package
# ---------------------------------------------------------------------------

_m80 = lambda b: b._new(b.param.replace(m=80))
_ow = lambda b: b.with_orthantwise(*OW)
_unc = lambda b: b.with_constrain_step_size(False)
_damp = lambda b: b.with_damping(True)
_algo = lambda name: lambda b: b.with_linesearch_algorithm(name)

#: the settings this slice opens on generic objectives (OWL-QN: c = 1 on
#: the whole vector)
RUNS = {
    "capped": lambda b: b,
    "uncapped": _unc,
    "adaptive": lambda b: _unc(b).with_adaptive_entry_step(2.0),
    "armijo": _algo("BacktrackingArmijo"),
    "wolfe": _algo("BacktrackingWolfe"),
    "strong_wolfe": _algo("BacktrackingStrongWolfe"),
    "owlqn": _ow,
    "owlqn_uncapped": lambda b: _unc(_ow(b)),
    "damped": _damp,
    "damped_uncapped": lambda b: _unc(_damp(b)),
    "damping_fixed": lambda b: _damp(b).with_damping_fixed(),
    "gradient_only": lambda b: b.with_gradient_only(),
    "owlqn_damped": lambda b: _ow(_damp(b)),
    "m80": _m80,
    "m80_owlqn": lambda b: _ow(_m80(b)),
}


def _hold(j, t, rtol=1e-9, rings=1e-7):
    """The same k, evaluations, status, ring row, ncall and ls_status per
    instance; fx, the entry step, dginit and the carried norms within
    ``rtol`` of the batch's largest (``_close``: the objective's sums add
    in numpy's and XLA's order on one side and torch's on the other, and a
    generic run carries that into dginit, e.g. 2.9e-9 of one instance's
    own after 15 Armijo iterations); the rings, Gram blocks and alphas
    within ``rings`` of each array's largest (a ring element of y is a
    difference of gradients, and cancels); under OWL-QN pg within 1e-9."""
    js = interop.batched_state_from_jax(j, "cpu")
    for name in ("k", "neval", "status", "end", "ncall", "ls_status"):
        assert np.array_equal(getattr(t, name), getattr(js, name)), (
            name, getattr(t, name), getattr(js, name))
    for name in ("fx", "step", "dg0", "gnorm2", "xnorm2"):
        _close(getattr(t, name), getattr(js, name), rtol)
    np.testing.assert_allclose(t.x.numpy(), js.x.numpy(), rtol=0, atol=1e-9)
    if t.pg is not None:
        np.testing.assert_allclose(t.pg.numpy(), js.pg.numpy(), rtol=0, atol=1e-9)
    for name in ("s", "y", "sy", "yy", "ys", "alpha"):
        _close(getattr(t.hist, name), getattr(js.hist, name).numpy(), rings)


def _both(configure, x0b=PERTURBED, fn=(j_plain, T_PLAIN), iters=15):
    c = lambda b: configure(b).with_max_iterations(iters)
    j = c(j_lbfgs()).minimize_batched(jnp.asarray(x0b), fn[0], return_state=True)
    t = c(t_lbfgs()).minimize_batched(_t(x0b), fn[1], return_state=True)
    return j, t


@pytest.mark.parametrize("run", list(RUNS))
def test_batched_generic_matches_jax_15_iterations(run):
    j, t = _both(RUNS[run])
    _hold(j, t)
    assert (t.k == 15).sum() >= B - 1
    if run.startswith("m80"):
        assert t.hist.s.shape == (B, 80, N)


def _poisson(dtype=np.float64):
    """The reference's 500 x 21 Poisson data (``synthetic_dataset``) and four
    starts: beta0 = 0 and three seeded N(0, 1e-3) offsets."""
    X, y = j_logistic.synthetic_dataset(500, 21)
    X, y = np.asarray(X, dtype), np.asarray(y, dtype)
    rng = np.random.RandomState(3)
    x0b = np.zeros((4, 21), dtype)
    x0b[1:] = 1e-3 * rng.randn(3, 21)
    return X, y, x0b


@pytest.mark.parametrize("damped", [False, True], ids=["owlqn", "owlqn_damped"])
def test_batched_poisson_matches_jax(damped):
    """The L1 Poisson regression (c = 1 on [1, 21)) through 10 iterations,
    held as ``_hold`` holds the Rosenbrock runs; then undamped to epsilon
    1e-4: the same iterations, evaluations and status per instance, fx rel
    1e-9, beta within 1e-9 (past that the last iterations' dginit is the
    products' rounding noise, ~1e-13)."""
    X, y, x0b = _poisson()
    fn = (j_logistic.make_objective(jnp.asarray(X), jnp.asarray(y)),
          t_logistic.make_objective(_t(X), _t(y)))
    ow = lambda b: (_damp(b) if damped else b).with_orthantwise(1.0, 1, 21)
    j, t = _both(lambda b: ow(b).with_epsilon(0.0), x0b, fn, iters=10)
    _hold(j, t)
    assert np.all(t.k == 10)
    if damped:
        return
    j, t = _both(lambda b: ow(b).with_epsilon(1e-4), x0b, fn, iters=200)
    js = interop.batched_state_from_jax(j, "cpu")
    for name in ("k", "neval", "status"):
        assert np.array_equal(getattr(t, name), getattr(js, name)), name
    assert np.all(t.status == Status.CONVERGED) and np.all(t.k > 5)
    np.testing.assert_allclose(t.fx, js.fx, rtol=1e-9)
    np.testing.assert_allclose(t.x.numpy(), js.x.numpy(), rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# the objective shapes
# ---------------------------------------------------------------------------


def _t_scalar(x):
    return T_PLAIN(x)[0]


def _j_scalar(x):
    return j_plain(x)[0]


def test_scalar_objective_runs_as_jax():
    """A scalar objective (its gradient from torch.func.grad_and_value, as
    jax.value_and_grad gives the JAX package's) runs as the JAX package runs
    it, and as the value-and-grad form of the same function."""
    j, t = _both(RUNS["capped"], fn=(_j_scalar, _t_scalar))
    _hold(j, t)
    vg = t_lbfgs().with_max_iterations(15).minimize_batched(_t(PERTURBED), T_PLAIN,
                                                            return_state=True)
    assert np.array_equal(vg.k, t.k) and np.array_equal(vg.neval, t.neval)
    np.testing.assert_allclose(t.fx, vg.fx, rtol=1e-12)


def _closure(x, g):
    fx, gx = T_PLAIN(torch.as_tensor(np.asarray(x)))
    np.copyto(g, gx.numpy()) if isinstance(g, np.ndarray) else g.copy_(gx)
    return float(fx)


def _j_closure(x, g):
    fx, gx = j_plain(jnp.asarray(x))
    g[...] = np.asarray(gx)
    return float(fx)


def _host(x):
    # a host function: leaves the tracer for numpy
    v = x.detach().numpy().copy()
    fx, g = T_PLAIN(torch.from_numpy(v))
    return fx, g


def _j_host(x):
    fx, g = j_plain(jnp.asarray(np.asarray(x)))
    return float(fx), np.asarray(g)


@pytest.mark.parametrize("shape", ["closure", "host"])
def test_refused_objective_shapes_raise(shape):
    """A mutating closure f(x, g) and a function the tracer cannot follow:
    the JAX package bridges both with an ordered io_callback, which its vmap
    refuses with ValueError; the port raises ValueError naming the shape,
    and runs each solo."""
    t_fn, j_fn = {"closure": (_closure, _j_closure), "host": (_host, _j_host)}[shape]
    with pytest.raises(ValueError, match="vmap"):
        j_lbfgs().with_max_iterations(3).minimize_batched(jnp.asarray(PERTURBED), j_fn)
    with pytest.raises(ValueError, match="closure" if shape == "closure" else "traced"):
        t_lbfgs().with_max_iterations(3).minimize_batched(_t(PERTURBED), t_fn)
    assert t_lbfgs().with_max_iterations(3).minimize(_t(PERTURBED[0]), t_fn).niter == 3


# ---------------------------------------------------------------------------
# the JAX package's vmapped Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

N_KERNEL = j_fused.MIN_FUSED_N


def test_owlqn_against_jax_vmapped_kernels_interpret(monkeypatch):
    """Three OWL-QN iterations at n = 2^14, B = 2, float32 vectors and a
    bfloat16 ring, c = 1 on [0, n - 1), the JAX package's vmapped K9, K12
    and K13 in interpret mode against the port's batched generic route: the
    same iterations and evaluations, fx rel 1e-5, the ring rows within a
    bfloat16 ulp."""
    monkeypatch.setenv("LBFGS_TPU_KERNELS_INTERPRET", "1")
    monkeypatch.setenv("LBFGS_TPU_KERNELS", "all")
    # the JAX run is traced anew, through the Pallas kernels counted here
    monkeypatch.setattr(j_batched, "_BATCH_CACHE", {})
    traced = dict.fromkeys(("owlqn_trial_step_pallas", "pair_gram_update_xg_pallas",
                            "combine_ow_pallas"), 0)

    def counted(name, fn):
        def wrapper(*a, **kw):
            traced[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name in traced:
        monkeypatch.setattr(j_fused, name, counted(name, getattr(j_fused, name)))
    rng = np.random.RandomState(0)
    base = np.asarray(j_rosen.initial_point(N_KERNEL, dtype=jnp.float32))
    x0b = base[None, :] + 0.05 * rng.randn(2, N_KERNEL).astype(np.float32)
    cfg = lambda b: b.with_orthantwise(1.0, 0, N_KERNEL - 1).with_history_dtype(
        "bfloat16").with_epsilon(0.0).with_max_iterations(4)
    j = cfg(j_lbfgs()).minimize_batched(jnp.asarray(x0b), j_plain, return_state=True)
    assert all(traced.values()), traced
    calls = t_fused.pair_gram_xg_batched_ref.calls
    t = cfg(t_lbfgs()).minimize_batched(_t(x0b), T_PLAIN, return_state=True)
    assert t_fused.pair_gram_xg_batched_ref.calls - calls == 3
    js = interop.batched_state_from_jax(j, "cpu")
    assert np.array_equal(t.k, js.k) and np.array_equal(t.neval, js.neval)
    np.testing.assert_allclose(t.fx, js.fx, rtol=1e-5)
    assert t.hist.s.dtype == torch.bfloat16
    for name in ("s", "y"):
        np.testing.assert_allclose(getattr(t.hist, name).float().numpy(),
                                   getattr(js.hist, name).float().numpy(), rtol=1e-2, atol=1e-3)


# ---------------------------------------------------------------------------
# against the port's own solo runs
# ---------------------------------------------------------------------------

_TOW = TOrthantwise(*OW)
PARAMS = {
    "capped": TParams(),
    "uncapped": TParams(constrain_step_size=False),
    "owlqn": TParams(orthantwise=_TOW),
    "damped": TParams(damping=True),
    "owlqn_damped": TParams(damping=True, orthantwise=_TOW),
    "gradient_only": t_lbfgs().with_gradient_only().param,
}


@pytest.mark.parametrize("run", list(PARAMS))
def test_batched_generic_matches_port_solo(run):
    """Each instance against its solo run (the whole-run loop on the same
    generic objective) after 15 iterations: the same k, evaluations and
    status, fx rel 1e-9, x within 1e-9."""
    p = PARAMS[run].replace(max_iterations=15)
    st = t_batched.minimize_batched(p, _t(PERTURBED), T_PLAIN, return_state=True)
    for b in range(B):
        so = t_minimize_jit(p, _t(PERTURBED[b]), T_PLAIN, return_state=True)
        assert (so.k, so.prob.neval, so.status) == (int(st.k[b]), int(st.neval[b]),
                                                    int(st.status[b])), b
        assert float(st.fx[b]) == pytest.approx(float(so.prob.fx), rel=1e-9)
        np.testing.assert_allclose(st.x[b].numpy(), so.prob.x.numpy(), atol=1e-9, rtol=0)


def test_batched_poisson_matches_port_solo():
    X, y, x0b = _poisson()
    obj = t_logistic.make_objective(_t(X), _t(y))
    p = TParams(orthantwise=TOrthantwise(1.0, 1, 21), epsilon=1e-4)
    st = t_batched.minimize_batched(p, _t(x0b), obj, return_state=True)
    for b in range(len(x0b)):
        so = t_minimize(p, _t(x0b[b]), obj)
        assert (so.niter, so.neval, so.status) == (int(st.k[b]), int(st.neval[b]),
                                                   int(st.status[b])), b
        assert float(st.fx[b]) == pytest.approx(float(so.fx), rel=1e-9)


#: damped OWL-QN on ``_frozen_batch`` with epsilon 1e-2 and at most 40
#: iterations, the step capped with min_step 1e-2 or uncapped with 0.1:
#: some instances fail their searches and one converges early
FROZEN = {"capped": 1e-2, "uncapped": 0.1}


def _frozen_batch():
    rng = np.random.RandomState(5)
    near = np.tile([0.25, 0.0575], N // 2) + 1e-3 * rng.randn(N)
    return np.stack([PERTURBED[4], PERTURBED[5], near, PERTURBED[2]])


@pytest.mark.parametrize("run", list(FROZEN))
def test_frozen_and_failed_instances_keep_state(run):
    """Under damped OWL-QN on a generic objective an instance whose search
    fails and an early finisher end with the x, g, pg, d, rings, Gram
    blocks, ys and alphas of the last iteration that accepted a step, bit
    for bit."""
    x0b = _t(_frozen_batch())
    p = TParams(damping=True, orthantwise=_TOW, linesearch=TLsParams(min_step=FROZEN[run]),
                epsilon=1e-2, max_iterations=40, constrain_step_size=run == "capped")
    st = t_batched.minimize_batched(p, x0b.clone(), T_PLAIN, return_state=True)
    failed = st.ls_status != 0
    assert failed.any() and (st.k < 40).sum() >= 2, (st.k, st.ls_status)
    for b in np.flatnonzero(st.k < 40):
        last = int(st.k[b]) - int(failed[b])
        before = t_batched.minimize_batched(p.replace(max_iterations=last), x0b.clone(), T_PLAIN,
                                            return_state=True)
        for name in ("x", "gx", "pg", "d"):
            assert torch.equal(getattr(st, name)[b], getattr(before, name)[b]), (b, name)
        for name in ("s", "y", "sy", "yy", "ys", "alpha"):
            assert torch.equal(getattr(st.hist, name)[b], getattr(before.hist, name)[b]), (
                b, name)


# ---------------------------------------------------------------------------
# the launch path and the reads
# ---------------------------------------------------------------------------

#: (plain versions per iteration, plain versions never called), by path
PATHS = {
    "capped": ((t_fused.combine_batched_ref,),
               (t_fused.pair_gram_xg_batched_ref, t_fused.owlqn_trial_step_batched_ref)),
    "uncapped": ((t_fused.combine_batched_ref,),
                 (t_fused.pair_gram_xg_batched_ref, t_fused.combine_fix_batched_ref)),
    "damped": ((t_fused.combine_batched_ref,),
               (t_fused.combine_fix_batched_ref, t_fused.pair_gram_xg_batched_ref)),
    "owlqn": ((t_fused.pseudo_gradient_norm_batched_ref, t_fused.pair_gram_xg_batched_ref,
               t_fused.combine_ow_batched_ref), (t_fused.combine_batched_ref,)),
    "owlqn_damped": ((t_fused.pseudo_gradient_norm_batched_ref,
                      t_fused.combine_ow_batched_ref),
                     (t_fused.pair_gram_xg_batched_ref, t_fused.combine_batched_ref)),
}


@pytest.mark.parametrize("run", list(PATHS))
def test_generic_launch_path_and_reads(run):
    """Per iteration one of each of the path's kernels (K3 b plain; K10 b,
    K12 b and K13 b under OWL-QN, no K12 b damped), none of the others;
    under OWL-QN one K11 b at the init and one K9 b per search trip; and
    one read per trip and per iteration after the init's."""
    p = PARAMS[run].replace(max_iterations=12)
    want, none = PATHS[run]
    trips = t_fused.owlqn_trial_step_batched_ref
    refs = (*want, *none, t_fused.pseudo_gradient_batched_ref, trips)
    before, reads = [f.calls for f in refs], to_host.reads
    st = t_batched.minimize_batched(p, _t(PERTURBED), T_PLAIN, return_state=True)
    calls = [f.calls - b0 for f, b0 in zip(refs, before)]
    reads = to_host.reads - reads
    iters = int(st.k.max()) - 1
    assert iters == 11
    assert calls[:len(want)] == [iters] * len(want)
    assert calls[len(want):len(want) + len(none)] == [0] * len(none)
    ow = p.orthantwise is not None
    assert calls[-2] == int(ow)
    # each trip one evaluation of every instance that searches, at least
    # one trip per iteration
    assert calls[-1] == (reads - 1 - iters if ow else 0)
    assert reads - 1 - iters >= iters
    # the evaluations: one per trip of each searching instance
    assert int(st.neval.max()) <= 1 + reads - 1 - iters


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
    x = xp + 0.1 * r(Bk, n)
    x[:, ::13] = 0.0
    return dict(xp=xp, x=x, d=0.1 * r(Bk, n), gx=r(Bk, n), gp=r(Bk, n), pg=r(Bk, n),
                S=(0.1 * r(Bk, m, n)).bfloat16(), Y=(0.1 * r(Bk, m, n)).bfloat16(),
                stp=0.2 + torch.rand(Bk, generator=g, device=dev), live=live, end=m - 3, c=0.7,
                window=(3, n - 5))


def _vec(a, b):
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def _sum(a, b):
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def _solo_rows(Bk):
    return sorted({0, Bk // 2, Bk - 1})


@pytest.mark.cuda
def test_k9b_k11b_on_card(cuda):
    """K9 b and K11 b against their plain versions (1e-5) and, on instances
    0, B/2 and B - 1 when live, against the solo K9 (with the search's
    orthant) and K11 bit for bit; a frozen instance's row untouched."""
    a = _card_batch(cuda, 6)
    live, (lo, hi), c = a["live"], a["window"], a["c"]
    for kern, ref, args, solo in (
            (t_fused.owlqn_trial_step_batched, t_fused.owlqn_trial_step_batched_ref,
             lambda: (a["xp"], a["d"], a["pg"], a["stp"], lo, hi, live),
             lambda b: t_fused.owlqn_trial_step(
                 a["xp"][b], a["d"][b],
                 t_ow.choose_orthant(TOrthantwise(1.0, lo, hi), a["xp"][b], a["pg"][b]),
                 float(a["stp"][b]), lo, hi)),
            (t_fused.pseudo_gradient_batched, t_fused.pseudo_gradient_batched_ref,
             lambda: (a["x"], a["gx"], c, lo, hi, live),
             lambda b: t_fused.pseudo_gradient(a["x"][b], a["gx"][b], c, lo, hi))):
        launches = kern.launches
        out_k, out_p = torch.zeros_like(a["d"]), torch.zeros_like(a["d"])
        kern(*args(), out_k)
        ref(*args(), out_p)
        assert kern.launches == launches + 1
        _vec(out_k[live], out_p[live])
        assert not out_k[~live].any()
        for b in _solo_rows(len(live)):
            if live[b]:
                assert torch.equal(out_k[b], solo(b)), b


@pytest.mark.cuda
@pytest.mark.parametrize("m", [6, 80])
def test_k12b_on_card(cuda, m):
    """K12 b against its plain version (sums 1e-4, ring rows bit for bit)
    and, on instances 0, B/2 and B - 1 when live, against the solo K12: the
    rings bit for bit, the sums within the sum tolerance (each instance's
    partials are the solo kernel's; torch adds [B, blocks, 6m] partials in
    an order that depends on B); a frozen instance's rings untouched."""
    a = _card_batch(cuda, m)
    live, end = a["live"], a["end"]
    vecs = tuple(a[k] for k in ("x", "xp", "gx", "gp", "pg"))
    Sk, Yk, Sp, Yp = a["S"].clone(), a["Y"].clone(), a["S"].clone(), a["Y"].clone()
    launches = t_fused.pair_gram_xg_batched.launches
    SPk, YPk = t_fused.pair_gram_xg_batched(*vecs, Sk, Yk, end, live)
    SPp, YPp = t_fused.pair_gram_xg_batched_ref(*vecs, Sp, Yp, end, live)
    assert t_fused.pair_gram_xg_batched.launches == launches + 1
    _sum(SPk[live], SPp[live])
    _sum(YPk[live], YPp[live])
    assert torch.equal(Sk, Sp) and torch.equal(Yk, Yp)
    assert torch.equal(Sk[~live], a["S"][~live]) and torch.equal(Yk[~live], a["Y"][~live])
    for b in _solo_rows(len(live)):
        if not live[b]:
            continue
        Sb, Yb = a["S"][b].clone(), a["Y"][b].clone()
        SP1, YP1 = t_fused.pair_gram_xg(*(v[b] for v in vecs), Sb, Yb, end)
        assert torch.equal(Sk[b], Sb) and torch.equal(Yk[b], Yb), b
        _sum(SPk[b], SP1)
        _sum(YPk[b], YP1)


@pytest.mark.cuda
@pytest.mark.parametrize("ow", [False, True], ids=["plain", "owlqn"])
def test_batched_generic_run_on_card(cuda, ow):
    """A generic batched run on the card (float32, a bfloat16 ring) against
    each instance's solo run on the card after 8 iterations: the same
    iterations and evaluations, fx rel 1e-3."""
    n, Bk = 1 << 12, 4
    x0b = (t_rosen.initial_point(n, torch.float32, "cuda")[None, :]
           + 0.05 * torch.randn(Bk, n, device=cuda, generator=torch.Generator(
               device=cuda).manual_seed(0)))
    p = TParams(max_iterations=9, epsilon=0.0, history_dtype="bfloat16")
    if ow:
        p = p.replace(orthantwise=TOrthantwise(1.0, 0, n - 1))
    st = t_batched.minimize_batched(p, x0b, T_PLAIN, return_state=True)
    for b in range(Bk):
        so = t_minimize(p, x0b[b].clone(), T_PLAIN)
        assert (so.niter, so.neval) == (int(st.k[b]), int(st.neval[b]))
        assert float(st.fx[b]) == pytest.approx(float(so.fx), rel=1e-3)
