"""The port's host backtracking search against ``lbfgs_tpu`` in float64.

The three exit ladders (Armijo, Wolfe, strong Wolfe) on objectives whose
(f, g) along the line are fixed by construction, so each case walks a
known sequence of trial steps: shrinking past an overshoot, growing on a
weak slope, the strong-Wolfe curvature exit, ``LS_MIN_STEP``,
``LS_MAX_STEP`` and loop exhaustion (where the reported step is the next,
never evaluated one and ``step_eval`` the last evaluated).  Then the
searches on extended Rosenbrock through the fused probes, and one port
``propagate_hot`` per iteration from the JAX package's own state for each
ladder (rel 1e-9), as in tests/test_torch_solver.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from lbfgs_torch import interop
from lbfgs_torch import linesearch as tls
from lbfgs_torch import solver as tsol
from lbfgs_torch.core import ProblemDef as TDef
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_torch.params import LineSearchParams as TLS
from lbfgs_torch.status import Status
from lbfgs_tpu import linesearch as jls
from lbfgs_tpu import solver as jsol
from lbfgs_tpu.core import ProblemDef as JDef
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.params import LbfgsParams as JParams
from lbfgs_tpu.params import LineSearchParams as JLS

F = np.float64
LADDERS = ["BacktrackingArmijo", "BacktrackingWolfe", "BacktrackingStrongWolfe"]
A = np.ones(4)

#: objectives as (torch, jax) value-and-grad pairs
OBJECTIVES = {
    # 0.5 ||x - a||^2: along d = 4a from 0 the minimum is at stp = 1/4
    "quad": (lambda x: (0.5 * torch.sum((x - torch.from_numpy(A)) ** 2),
                        x - torch.from_numpy(A)),
             lambda x: (0.5 * jnp.sum((x - A) ** 2), x - A)),
    # -x0: every step along e0 decreases f at slope -1
    "down": (lambda x: (-x[0], torch.zeros_like(x).index_fill(0, torch.tensor([0]), -1.0)),
             lambda x: (-x[0], jnp.zeros_like(x).at[0].set(-1.0))),
    # +x0, searched with a claimed dginit of -1: Armijo fails on every trip
    "up": (lambda x: (x[0], torch.zeros_like(x).index_fill(0, torch.tensor([0]), 1.0)),
           lambda x: (x[0], jnp.zeros_like(x).at[0].set(1.0))),
    # +x0 with a zero gradient reported: Armijo fails, g.d = 0 everywhere
    "blind": (lambda x: (x[0], torch.zeros_like(x)),
              lambda x: (x[0], jnp.zeros_like(x))),
}
E0 = np.eye(4)[0]
#: case: (objective, d, stp0, dginit or None for g.d, line-search settings)
CASES = {
    "overshoot": ("quad", 4 * A, 1.0, None, {}),
    "weak_slope": ("quad", 4 * A, 0.01, None, {}),
    "curvature_high": ("quad", 4 * A, 0.48, None, {}),
    "min_step": ("quad", 4 * A, 1.0, None, dict(min_step=0.6)),
    "max_step": ("down", E0, 1.0, None, dict(max_step=10.0)),
    "exhausted": ("up", E0, 1.0, -1.0, dict(max_linesearch=5)),
    "gradient_only": ("down", E0, 1.0, None, dict(max_step=10.0, gradient_only=True)),
    # the literal gradient-only exit |dg| <= -gtol*|dginit| accepts only
    # when dginit = 0 (src/line.rs:768-774): here it accepts a trial that
    # every ladder's own test rejects
    "gradient_only_quirk": ("blind", E0, 1.0, 0.0, dict(gradient_only=True)),
}


def _run_both(case, algorithm):
    name, d, stp0, dginit, kw = CASES[case]
    t_fn, j_fn = OBJECTIVES[name]
    xp = np.zeros(4)
    fx, g = j_fn(jnp.asarray(xp))
    finit = F(fx)
    dginit = F(np.dot(np.asarray(g), d)) if dginit is None else F(dginit)
    tr = tls.backtracking(TDef(t_fn), TLS(algorithm=algorithm, **kw), torch.from_numpy(xp),
                          finit, torch.from_numpy(np.asarray(g)), torch.from_numpy(d),
                          F(stp0), dginit, 1)
    jr = jls.backtracking(JDef(value_and_grad=j_fn), JLS(algorithm=algorithm, **kw),
                          jnp.asarray(xp), jnp.float64(finit), g, jnp.asarray(d),
                          jnp.float64(stp0), jnp.float64(dginit), jnp.int32(1),
                          jnp.asarray(xp))
    return tr, jr


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("algorithm", LADDERS)
def test_backtracking_ladder_matches_jax(case, algorithm):
    tr, jr = _run_both(case, algorithm)
    assert tr.status == int(jr.status)
    assert (tr.ncall, tr.neval) == (int(jr.ncall), int(jr.neval))
    assert tr.step == float(jr.step) and tr.step_eval == float(jr.step_eval)
    # the objectives sum in another order: fx to the last ulps only
    assert tr.fx == pytest.approx(float(jr.fx), rel=1e-14)
    np.testing.assert_array_equal(tr.x.numpy(), np.asarray(jr.x))
    np.testing.assert_array_equal(tr.gx.numpy(), np.asarray(jr.gx))


def test_backtracking_exits_are_the_reference_codes():
    """The cases reach the exits they are named for."""
    assert _run_both("min_step", "BacktrackingArmijo")[0].status == Status.LS_MIN_STEP
    assert _run_both("max_step", "BacktrackingWolfe")[0].status == Status.LS_MAX_STEP
    r = _run_both("exhausted", "BacktrackingWolfe")[0]
    # four trials, then success by exhaustion with the next, never
    # evaluated step reported (src/line.rs:777)
    assert (r.status, r.ncall, r.neval) == (0, 5, 5)
    assert (r.step_eval, r.step) == (0.125, 0.0625)
    # weak slope: Wolfe grows 0.01 -> 0.021 -> 0.0441; Armijo takes 0.01
    assert _run_both("weak_slope", "BacktrackingWolfe")[0].step == F(0.01) * F(2.1) * F(2.1)
    assert _run_both("weak_slope", "BacktrackingArmijo")[0].step == 0.01
    # strong Wolfe shrinks where the slope turned too far up
    assert _run_both("curvature_high", "BacktrackingStrongWolfe")[0].step == 0.24
    assert _run_both("curvature_high", "BacktrackingWolfe")[0].step == 0.48
    # the gradient-only quirk takes the first trial although Armijo fails
    for algorithm in LADDERS:
        r = _run_both("gradient_only_quirk", algorithm)[0]
        assert (r.status, r.ncall, r.step) == (0, 1, 1.0)


@pytest.mark.parametrize("algorithm", LADDERS)
@pytest.mark.parametrize("seed", [0, 1])
def test_rosenbrock_search_matches_jax(algorithm, seed):
    """Searches through the fused probes (remat, then one materializing
    trial) against the JAX package's on the same point."""
    rng = np.random.default_rng(seed)
    n = 64
    x = t_rosen.initial_point(n, device="cpu").numpy() + 0.3 * rng.standard_normal(n)
    fx, g = t_rosen._plain_value_and_grad(torch.from_numpy(x))
    g = g.numpy()
    d = -g
    stp0, finit = F(1.0 / np.linalg.norm(g)), F(fx)
    tr = tls.find(TDef(t_rosen.value_and_grad), TLS(algorithm=algorithm),
                  torch.from_numpy(x), finit, torch.from_numpy(g), torch.from_numpy(d),
                  stp0, 1)
    jr = jls.find(JDef(value_and_grad=j_rosen.value_and_grad), JLS(algorithm=algorithm),
                  jnp.asarray(x), jnp.float64(finit), jnp.asarray(g), None, jnp.asarray(d),
                  jnp.float64(stp0), jnp.int32(1))
    assert tr.status == int(jr.status)
    assert (tr.ncall, tr.neval) == (int(jr.ncall), int(jr.neval))
    assert float(tr.step) == pytest.approx(float(jr.step), rel=1e-12)
    assert float(tr.fx) == pytest.approx(float(jr.fx), rel=1e-12)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tr.gx.numpy(), np.asarray(jr.gx), rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# plain L-BFGS through each ladder, one propagate per iteration
# ---------------------------------------------------------------------------

N, ITERS, REL = 256, 8, 1e-9


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=LADDERS)
def ladder_states(request):
    pdef = JDef(value_and_grad=j_rosen.value_and_grad)
    params = JParams().replace_ls(algorithm=request.param)
    step = jax.jit(lambda st: jsol.propagate_hot(pdef, params, st))
    st = jsol.start_state(jsol.init_state(pdef, params, j_rosen.initial_point(N)), params)
    states = [_np(st)]
    for _ in range(ITERS):
        st = step(st)
        states.append(_np(st))
    return request.param, states


def _close(t, j, what):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    j = np.asarray(j, np.float64).reshape(t.shape)
    scale = max(np.abs(j).max(), 1e-300)
    np.testing.assert_allclose(t, j, rtol=REL, atol=REL * scale, err_msg=what)


@pytest.mark.parametrize("k", range(1, ITERS + 1))
def test_ladder_propagate_matches_jax(ladder_states, k):
    algorithm, states = ladder_states
    params = TParams().replace_ls(algorithm=algorithm)
    out = tsol.propagate_hot(TDef(t_rosen.value_and_grad), params,
                             interop.state_from_jax(states[k - 1], "cpu"))
    ref = states[k]
    assert out.status == int(ref.status) == 0
    assert (out.k, out.end, out.ncall, out.prob.neval) == (
        int(ref.k), int(ref.end), int(ref.ncall), int(ref.prob.neval))
    for name in ("x", "gx", "d"):
        _close(getattr(out.prob, name), getattr(ref.prob, name), name)
    for name in ("fx", "gnorm2", "xnorm2"):
        _close(getattr(out.prob, name), getattr(ref.prob, name), name)
    for name in ("step", "step_ls", "dg0"):
        _close(getattr(out, name), getattr(ref, name), name)
    for name in ("s", "y", "sy", "yy"):
        _close(getattr(out.hist, name), getattr(ref.hist, name), name)


@pytest.mark.parametrize("algorithm", LADDERS)
def test_ladder_runs_in_lock_step_with_jax(algorithm):
    """30 iterations of the step-at-a-time loop on both sides from x0:
    the same evaluations at every iteration and fx to rel 1e-9 (past ~45
    iterations the Armijo-only ladder, which takes the first decrease it
    finds, amplifies the packages' different roundings)."""
    from lbfgs_torch import lbfgs as t_lbfgs
    from lbfgs_tpu import lbfgs as j_lbfgs

    st_t = t_lbfgs().with_linesearch_algorithm(algorithm).build(
        t_rosen.initial_point(100, device="cpu"), t_rosen.value_and_grad)
    st_j = j_lbfgs().with_linesearch_algorithm(algorithm).build(
        j_rosen.initial_point(100), j_rosen.value_and_grad)
    for _ in range(30):
        a, b = st_t.propagate(), st_j.propagate()
        assert (a.niter, a.neval, a.ncall) == (b.niter, b.neval, b.ncall)
        assert a.fx == pytest.approx(b.fx, rel=1e-9)
