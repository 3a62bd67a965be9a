"""The port's solver step against the JAX package in float64.

A JAX run of extended Rosenbrock provides the states of iterations 1-15;
each is carried across with ``lbfgs_torch.interop`` and one port
``propagate_hot`` from it is held to the JAX ``propagate_hot`` from the
same state, to rel 1e-9.  Every step starts from JAX's own state, so
differences do not add up.  The JAX package on the CPU takes its
composed pair update (s = x - xp) where the port takes its one-pass
epilogue (s = stp*d): the two differ by rounding only.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from lbfgs_torch import interop
from lbfgs_torch import solver as tsol
from lbfgs_torch.core import ProblemDef as TDef
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_tpu import solver as jsol
from lbfgs_tpu.core import ProblemDef as JDef
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.params import LbfgsParams as JParams

N, ITERS, REL = 256, 15, 1e-9


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_states():
    pdef = JDef(value_and_grad=j_rosen.value_and_grad)
    params = JParams()
    step = jax.jit(lambda st: jsol.propagate_hot(pdef, params, st))
    st = jsol.start_state(jsol.init_state(pdef, params, j_rosen.initial_point(N)), params)
    states = [_np(st)]
    for _ in range(ITERS):
        st = step(st)
        states.append(_np(st))
    return states


def _close(t, j, what):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    j = np.asarray(j, np.float64).reshape(t.shape)
    scale = max(np.abs(j).max(), 1e-300)
    np.testing.assert_allclose(t, j, rtol=REL, atol=REL * scale, err_msg=what)


@pytest.mark.parametrize("k", range(1, ITERS + 1))
def test_propagate_matches_jax(jax_states, k):
    pdef = TDef(value_and_grad=t_rosen.value_and_grad)
    st = interop.state_from_jax(jax_states[k - 1], "cpu")
    out = tsol.propagate_hot(pdef, TParams(), st)
    ref = jax_states[k]
    assert out.status == int(ref.status) == 0
    assert (out.k, out.end, out.ncall, out.prob.neval) == (
        int(ref.k), int(ref.end), int(ref.ncall), int(ref.prob.neval))
    for name in ("x", "gx", "d", "xp", "gp"):
        _close(getattr(out.prob, name), getattr(ref.prob, name), name)
    for name in ("fx", "gnorm2", "xnorm2"):
        _close(getattr(out.prob, name), getattr(ref.prob, name), name)
    for name in ("step", "step_ls", "dg0"):
        _close(getattr(out, name), getattr(ref, name), name)
    for name in ("s", "y", "ys", "alpha", "sy", "yy"):
        _close(getattr(out.hist, name), getattr(ref.hist, name), name)


def test_init_state_matches_jax():
    x0 = j_rosen.initial_point(N)
    j = _np(jsol.init_state(JDef(value_and_grad=j_rosen.value_and_grad), JParams(), x0))
    t = tsol.init_state(TDef(value_and_grad=t_rosen.value_and_grad), TParams(),
                        t_rosen.initial_point(N, device="cpu"))
    for name in ("x", "gx", "d", "fx", "gnorm2", "xnorm2"):
        _close(getattr(t.prob, name), getattr(j.prob, name), name)
    _close(t.step, j.step, "step")
    _close(t.dg0, j.dg0, "dg0")
    assert (t.k, t.end, t.prob.neval) == (0, 0, 1)


def test_state_round_trip(jax_states):
    st = interop.state_from_jax(jax_states[5], "cpu")
    back = interop.state_to_numpy(st)
    ref = jax_states[5]
    np.testing.assert_array_equal(back["prob"]["x"], ref.prob.x)
    np.testing.assert_array_equal(back["hist"]["s"], np.asarray(ref.hist.s).reshape(6, N))
    assert back["end"] == int(ref.end) and back["k"] == int(ref.k)
    assert back["step"] == ref.step and type(back["step"]) is np.float64


def test_bf16_ring_major_history_carries_bit_for_bit():
    import jax.numpy as jnp

    S = jnp.asarray(np.random.default_rng(3).standard_normal((6, 2, 128)), jnp.bfloat16)
    t = interop._tensor(np.asarray(S).reshape(6, -1), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(S).astype(np.float32).reshape(6, -1))


def test_two_loop_compact_matches_jax():
    """The compact two-loop alone, from seeded random history."""
    import jax.numpy as jnp

    m, n, bound, end = 6, 64, 4, 2
    rng = np.random.default_rng(5)
    S, Y = rng.standard_normal((m, n)), rng.standard_normal((m, n))
    Y += 2.0 * S  # keep s.y positive
    g = rng.standard_normal(n)
    hist_j = jsol.make_history(jnp.asarray(S), jnp.asarray(Y),
                               jnp.asarray((S * Y).sum(1)), jnp.zeros(m))
    r_j, a_j, _, _ = jsol.two_loop_compact(hist_j, jnp.asarray(g), jnp.float64(0.7),
                                           jnp.int32(bound), jnp.int32(end), neg=True)
    hist_t = tsol.History(
        s=torch.from_numpy(S), y=torch.from_numpy(Y),
        ys=torch.from_numpy((S * Y).sum(1)), alpha=torch.zeros(m, dtype=torch.float64),
        sy=torch.from_numpy(S @ Y.T), yy=torch.from_numpy(Y @ Y.T),
    )
    r_t, a_t, rr, rd, probe = tsol.two_loop_compact(
        hist_t, torch.from_numpy(g), torch.tensor(0.7, dtype=torch.float64),
        bound, end, neg=True)
    assert probe is None
    _close(r_t, r_j, "r")
    _close(a_t, a_j, "alpha")
    _close(rr, float(np.dot(r_j, r_j)), "r.r")
    _close(rd, float(np.dot(r_j, g)), "r.g")


def test_update_pair_matches_jax():
    rng = np.random.default_rng(9)
    x, xp, gx, gp = (rng.standard_normal(32) for _ in range(4))
    j = jsol.update_pair(JParams(), *(jax.numpy.asarray(v) for v in (x, xp, gx, gp)), 1.0)
    t = tsol.update_pair(TParams(), *(torch.from_numpy(v) for v in (x, xp, gx, gp)))
    for name in ("s", "y", "ys", "gamma"):
        _close(getattr(t, name), getattr(j, name), name)
    assert t.status == int(j.status) == 0
    same = torch.from_numpy(x)
    assert tsol.update_pair(TParams(), same, same, same, same).status == 20


def test_stop_status_order():
    """max_iterations, then max_evaluations, then the scaled gnorm."""
    st = tsol.init_state(TDef(value_and_grad=t_rosen.value_and_grad), TParams(),
                         t_rosen.initial_point(100, device="cpu"))
    st = st._replace(k=5)
    assert tsol.stop_status(TParams(max_iterations=5, max_evaluations=1), st) == 2
    assert tsol.stop_status(TParams(max_evaluations=1), st) == 3
    assert tsol.stop_status(TParams(epsilon=1e9), st) == 1
    assert tsol.stop_status(TParams(), st) == 0
