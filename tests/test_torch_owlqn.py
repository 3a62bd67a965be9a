"""OWL-QN in the PyTorch port against ``lbfgs_tpu`` on the CPU.

The sign functions and orthant operators on NaN and signed zeros; one
port ``propagate_hot`` per iteration from the JAX package's own OWL-QN
state (carried across with ``interop``, iterations 1-15, float64, rel
1e-9); the recorded OWL-QN golden (172 iterations, fx 43.50249999999999,
tests/test_native_parity.py:57-66) through every entry point and both
solver branches; the revert of a failed search, pg included; and the
line search's routing under OWL-QN.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import lbfgs_torch
from lbfgs_torch import interop
from lbfgs_torch import linesearch as tls
from lbfgs_torch import orthantwise as tow
from lbfgs_torch import solver as tsol
from lbfgs_torch.core import ProblemDef as TDef
from lbfgs_torch.minimize import LbfgsState as TState
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_torch.params import LineSearchParams as TLS
from lbfgs_tpu import orthantwise as jow
from lbfgs_tpu import solver as jsol
from lbfgs_tpu.core import ProblemDef as JDef
from lbfgs_tpu.minimize import LbfgsState as JState
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.params import LbfgsParams as JParams

N, ITERS, REL = 256, 15, 1e-9
GOLDEN_FX, GOLDEN_NITER = 43.50249999999999, 172
#: float64 values with NaN and both zeros where the sign conventions part
SPECIAL = np.array([np.nan, 0.0, -0.0, 1.5, -2.0, np.nan, -0.0, 0.0, 3.0, -1e-300])


def _close(t, j, what, rel=REL):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    j = np.asarray(j, np.float64).reshape(t.shape)
    scale = max(np.abs(j).max(), 1e-300)
    np.testing.assert_allclose(t, j, rtol=rel, atol=rel * scale, err_msg=what)


def _same(t, j):
    """Equal as float64 arrays, NaN equal to NaN and -0 distinct from +0."""
    t = t.numpy().astype(np.float64)
    j = np.asarray(j, np.float64)
    np.testing.assert_array_equal(t.view(np.int64), j.view(np.int64))


# ---------------------------------------------------------------------------
# sign functions and orthant operators
# ---------------------------------------------------------------------------


def test_signum_maps_nan_to_zero():
    s = tow.signum(torch.tensor([np.nan, -np.nan, 0.0, -0.0, 2.0, -3.0]))
    assert s.tolist() == [0.0, 0.0, 0.0, 0.0, 1.0, -1.0]
    # sign (the pseudo-gradient's, jnp.sign) keeps NaN
    assert torch.isnan(tow.sign(torch.tensor(np.nan)))


@pytest.mark.parametrize("op", ["sign", "signum", "project", "choose_orthant",
                                "project_line_point", "constrain_direction",
                                "pseudo_gradient"])
def test_orthant_ops_on_nan_and_signed_zeros_match_jax(op):
    a = SPECIAL
    b = np.roll(SPECIAL, 3)
    ow_t, ow_j = tow.Orthantwise(0.5, 2, 9), jow.Orthantwise(0.5, 2, 9)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    t, j = {
        "sign": lambda: (tow.sign(ta), jnp.sign(ja)),
        "signum": lambda: (tow.signum(ta), jow.signum(ja)),
        "project": lambda: (tow.project(ta, tb), jow.project(ja, jb)),
        "choose_orthant": lambda: (tow.choose_orthant(ow_t, ta, tb),
                                   jow.choose_orthant(ow_j, ja, jb)),
        "project_line_point": lambda: (tow.project_line_point(ow_t, ta, tb),
                                       jow.project_line_point(ow_j, ja, jb)),
        "constrain_direction": lambda: (tow.constrain_direction(ow_t, ta, tb),
                                        jow.constrain_direction(ow_j, ja, jb)),
        "pseudo_gradient": lambda: (tow.pseudo_gradient(ow_t, ta, tb),
                                    jow.pseudo_gradient(ow_j, ja, jb)),
    }[op]()
    _same(t, j)


def test_x1norm_and_window_match_jax():
    x = np.random.default_rng(4).standard_normal(40)
    for args in ((1.0, 0, None), (0.3, 5, 31), (2.0, 7, 99)):
        t = tow.x1norm(tow.Orthantwise(*args), torch.from_numpy(x))
        j = jow.x1norm(jow.Orthantwise(*args), jnp.asarray(x))
        _close(t, j, f"x1norm {args}", rel=1e-14)
        np.testing.assert_array_equal(tow.Orthantwise(*args).window_mask(40).numpy(),
                                      np.asarray(jow.Orthantwise(*args).window_mask(40)))


# ---------------------------------------------------------------------------
# one propagate per iteration from JAX's own OWL-QN state
# ---------------------------------------------------------------------------


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_states():
    ow = jow.Orthantwise(1.0, 0, N - 1)
    pdef = JDef(value_and_grad=j_rosen.value_and_grad, owlqn=ow)
    params = JParams(orthantwise=ow)
    step = jax.jit(lambda st: jsol.propagate_hot(pdef, params, st))
    st = jsol.start_state(jsol.init_state(pdef, params, j_rosen.initial_point(N)), params)
    states = [_np(st)]
    for _ in range(ITERS):
        st = step(st)
        states.append(_np(st))
    return states


def _tdef():
    ow = tow.Orthantwise(1.0, 0, N - 1)
    return TDef(value_and_grad=t_rosen.value_and_grad, owlqn=ow), TParams(orthantwise=ow)


@pytest.mark.parametrize("k", range(1, ITERS + 1))
def test_owlqn_propagate_matches_jax(jax_states, k):
    pdef, params = _tdef()
    st = interop.state_from_jax(jax_states[k - 1], "cpu")
    out = tsol.propagate_hot(pdef, params, st)
    ref = jax_states[k]
    assert out.status == int(ref.status) == 0
    assert (out.k, out.end, out.ncall, out.prob.neval) == (
        int(ref.k), int(ref.end), int(ref.ncall), int(ref.prob.neval))
    for name in ("x", "gx", "pg", "d", "xp", "gp"):
        _close(getattr(out.prob, name), getattr(ref.prob, name), name)
    for name in ("fx", "gnorm2", "xnorm2"):
        _close(getattr(out.prob, name), getattr(ref.prob, name), name)
    for name in ("step", "step_ls", "dg0"):
        _close(getattr(out, name), getattr(ref, name), name)
    for name in ("s", "y", "ys", "alpha", "sy", "yy"):
        _close(getattr(out.hist, name), getattr(ref.hist, name), name)


def test_owlqn_init_state_matches_jax():
    pdef, params = _tdef()
    j = _np(jsol.init_state(JDef(value_and_grad=j_rosen.value_and_grad,
                                 owlqn=jow.Orthantwise(1.0, 0, N - 1)),
                            JParams(orthantwise=jow.Orthantwise(1.0, 0, N - 1)),
                            j_rosen.initial_point(N)))
    t = tsol.init_state(pdef, params, t_rosen.initial_point(N, device="cpu"))
    for name in ("x", "gx", "pg", "d", "fx", "gnorm2", "xnorm2"):
        _close(getattr(t.prob, name), getattr(j.prob, name), name)
    _close(t.step, j.step, "step")
    _close(t.dg0, j.dg0, "dg0")


def test_pg_carries_both_ways(jax_states):
    st = interop.state_from_jax(jax_states[4], "cpu")
    np.testing.assert_array_equal(st.prob.pg.numpy(), jax_states[4].prob.pg)
    back = interop.state_to_numpy(st)
    np.testing.assert_array_equal(back["prob"]["pg"], jax_states[4].prob.pg)
    # plain L-BFGS carries no pg
    assert interop.state_to_numpy(
        tsol.init_state(TDef(t_rosen.value_and_grad), TParams(),
                        t_rosen.initial_point(8, device="cpu")))["prob"]["pg"] is None


# ---------------------------------------------------------------------------
# the recorded golden, every entry point and both solver branches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lbfgs_solution():
    """The 2018 L-BFGS solution the recorded OWL-QN run starts from."""
    rep = lbfgs_torch.lbfgs().with_constrain_step_size(False).minimize(
        t_rosen.initial_point(100, device="cpu"), lbfgs_torch.default_evaluate())
    assert rep.niter == 38
    return rep.x


def _generic(x):
    return t_rosen._plain_value_and_grad(x)


@pytest.mark.parametrize("entry", ["minimize", "minimize_jit", "LbfgsState"])
@pytest.mark.parametrize("objective", ["fused", "generic"])
def test_owlqn_golden(lbfgs_solution, entry, objective):
    fn = lbfgs_torch.default_evaluate() if objective == "fused" else _generic
    b = lbfgs_torch.lbfgs().with_orthantwise(1.0, 0, 99).with_constrain_step_size(False)
    standins = (t_fused.pair_gram_xg_ref.calls, t_fused.owlqn_trial_step_ref.calls)
    if entry == "LbfgsState":
        st = b.build(lbfgs_solution.clone(), fn)
        while not st.is_converged():
            st.propagate()
        rep = st.report()
    else:
        rep = getattr(b, entry)(lbfgs_solution.clone(), fn)
    assert rep.niter == GOLDEN_NITER
    assert rep.fx == pytest.approx(GOLDEN_FX, rel=1e-9)
    assert float(rep.x[0]) == pytest.approx(0.2500000069348678, rel=1e-8)
    assert float(rep.x[1]) == pytest.approx(0.057500004213084016, rel=1e-8)
    used = (t_fused.pair_gram_xg_ref.calls - standins[0],
            t_fused.owlqn_trial_step_ref.calls - standins[1])
    # the fused objective takes the one-pass epilogue (K8, K14) and never a
    # plain stand-in; a generic one takes the composed branch
    assert (used == (0, 0)) == (objective == "fused")


# ---------------------------------------------------------------------------
# revert, routing
# ---------------------------------------------------------------------------


def test_failed_search_reverts_pg_like_jax():
    """min_step = 0.05 makes the search at iteration 77 fail (LS_MIN_STEP):
    the host loop reverts x, g and pg and raises "x not changed" at the
    same iteration as the JAX package."""
    logging.disable(logging.ERROR)
    try:
        out = []
        for mod, rosen, x0 in (
                (lbfgs_torch, t_rosen, t_rosen.initial_point(100, device="cpu")),
                (__import__("lbfgs_tpu"), j_rosen, j_rosen.initial_point(100))):
            st = (mod.lbfgs().with_orthantwise(1.0, 0, 99).with_linesearch_min_step(0.05)
                  .build(x0, rosen.value_and_grad))
            with pytest.raises(Exception, match="x not changed"):
                while not st.is_converged():
                    st.propagate()
            p = st.state.prob
            out.append((int(st.state.k), int(st.state.ls_status), np.asarray(p.x),
                        np.asarray(p.xp), np.asarray(p.gx), np.asarray(p.gp),
                        np.asarray(p.pg)))
    finally:
        logging.disable(logging.NOTSET)
    (kt, lt, xt, xpt, gt, gpt, pgt), (kj, lj, xj, _, _, _, pgj) = out
    assert (kt, lt) == (kj, lj) == (77, 13)
    np.testing.assert_array_equal(xt, xpt)
    np.testing.assert_array_equal(gt, gpt)
    ow = tow.Orthantwise(1.0, 0, 99)
    np.testing.assert_array_equal(
        pgt, tow.pseudo_gradient(ow, torch.from_numpy(xt), torch.from_numpy(gt)).numpy())
    # 77 iterations from x0: the two packages' roundings have drifted to
    # ~6e-9 (their pair updates take s = x - xp in different passes)
    _close(torch.from_numpy(xt), xj, "x", rel=1e-7)
    _close(torch.from_numpy(pgt), pgj, "pg", rel=1e-7)


def test_owlqn_routes_more_thuente_to_armijo_backtracking(monkeypatch):
    """With the default More-Thuente setting OWL-QN still takes the
    backtracking search with the Armijo-only exit (src/line.rs:204-211)."""
    monkeypatch.setattr(tls, "morethuente", None)
    ow = tow.Orthantwise(1.0, 0, 99)
    pdef = TDef(t_rosen.value_and_grad, owlqn=ow)
    x = t_rosen.initial_point(100, device="cpu")
    fx, g = t_rosen._plain_value_and_grad(x)
    pg = tow.pseudo_gradient(ow, x, g)
    fx = np.float64(fx + tow.x1norm(ow, x))
    args = (pdef, None, x, fx, g, -pg, np.float64(0.01), 1)
    kw = dict(pgp=pg, materialize=False)
    r_mt = tls.find(args[0], TLS(), *args[2:], **kw)
    r_bt = tls.find(args[0], TLS(algorithm="BacktrackingStrongWolfe"), *args[2:], **kw)
    assert (r_mt.step, r_mt.fx, r_mt.ncall) == (r_bt.step, r_bt.fx, r_bt.ncall)
    # gradient_only with More-Thuente stays an error without OWL-QN
    with pytest.raises(ValueError, match="incompatible with MoreThuente"):
        tls.find(TDef(t_rosen.value_and_grad), TLS(gradient_only=True), x, fx, g, -g,
                 np.float64(0.1), 1)
