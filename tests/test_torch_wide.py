"""The wide objective scalar (``params.fx_wide``) in the PyTorch port,
against ``lbfgs_tpu`` on the CPU.

Under the wide mode x, g, d, pg and the history stay float32, and so do
the step and derivative scalars, while fx and the line searches'
f-values carry as float64 (``lbfgs_tpu/linesearch.py:136-152``): the
host read that keeps each value in its own dtype (``core.to_host``); the
interval update's casts against the JAX package's; the two-stage sums;
wide against default runs (the same iterations, fx rel 1e-3, the port's
copies of ``tests/test_wide_fx.py:121-180``); one ``propagate_hot`` per
iteration from the JAX package's own wide state (iterations 1-15, rel
1e-4 on the float32 vectors); float64 vectors, which the mode leaves
bit for bit as they are; and where K7 runs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import lbfgs_torch
from lbfgs_torch import core as tcore
from lbfgs_torch import interop
from lbfgs_torch import linesearch as tls
from lbfgs_torch import solver as tsol
from lbfgs_torch.core import ProblemDef as TDef
from lbfgs_torch.minimize import minimize_jit as t_minimize_jit
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.orthantwise import Orthantwise as TOW
from lbfgs_torch.orthantwise import x1norm as t_x1norm
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_tpu import linesearch as jls
from lbfgs_tpu import solver as jsol
from lbfgs_tpu.core import ProblemDef as JDef
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.ops import fused as j_fused
from lbfgs_tpu.orthantwise import Orthantwise as JOW
from lbfgs_tpu.orthantwise import x1norm as j_x1norm
from lbfgs_tpu.params import LbfgsParams as JParams

N, ITERS = 2048, 15


def _close(t, j, what, rel):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    j = np.asarray(j, np.float64).reshape(t.shape)
    scale = max(np.abs(j).max(), 1e-300)
    np.testing.assert_allclose(t, j, rtol=rel, atol=rel * scale, err_msg=what)


def test_to_host_keeps_each_values_dtype():
    """One transfer, each value in its own dtype: a float64 fx beside
    float32 step scalars keeps the digits float32 would round away."""
    fx = torch.tensor(243.17596411705017, dtype=torch.float64)
    dg = torch.tensor(-1.25e-8, dtype=torch.float32)
    before = tcore.to_host.reads
    out = tcore.to_host(dg, fx, torch.tensor(True))
    assert tcore.to_host.reads == before + 1
    assert [type(v) for v in out] == [np.float32, np.float64, np.bool_]
    assert out[1] == 243.17596411705017 and out[0] == np.float32(-1.25e-8) and out[2]


@pytest.mark.parametrize("case", range(6))
def test_interval_update_casts_like_jax(case):
    """mcstep with float64 f-values and float32 geometry: the results' dtypes
    and values as the JAX package's under x64."""
    rng = np.random.default_rng(case)
    f32, f64 = np.float32, np.float64
    fx, fy, ft = (f64(243.0 + 1e-9 * v) for v in rng.standard_normal(3))
    x, y, t = sorted(f32(v) for v in rng.uniform(0.0, 2.0, 3))
    dx, dy, dt = (f32(v) for v in rng.standard_normal(3))
    brackt = bool(case % 2)
    args = (x, fx, dx, y, fy, dy, t, ft, dt, f32(0.0), f32(4.0), brackt)
    r = tls.update_trial_interval(*args)
    j = jls.update_trial_interval(*(jnp.asarray(a) for a in args[:-1]), jnp.asarray(brackt))
    for name in ("x", "dx", "y", "dy", "t"):
        assert type(getattr(r, name)) is np.float32, name
        _close(getattr(r, name), getattr(j, name), name, rel=1e-6)
    for name in ("fx", "fy"):
        assert type(getattr(r, name)) is np.float64, name
        assert getattr(r, name) == np.asarray(getattr(j, name)), name
    assert (r.brackt, r.status) == (bool(j.brackt), int(j.status))


def test_two_stage_sums_match_jax():
    # positive terms: the two packages' float32 block sums add in other
    # orders, which a cancelling sum would magnify
    x = np.abs(np.random.default_rng(3).standard_normal(5 * 2048 + 77)).astype(np.float32) * 30
    ow_t, ow_j = TOW(0.7, 5, x.size - 3), JOW(0.7, 5, x.size - 3)
    with t_fused.wide_fx(), j_fused.wide_fx():
        for t, j in ((t_fused.obj_sum(torch.from_numpy(x)), j_fused.obj_sum(jnp.asarray(x))),
                     (t_x1norm(ow_t, torch.from_numpy(x)), j_x1norm(ow_j, jnp.asarray(x)))):
            assert t.dtype == torch.float64
            _close(t, j, "sum", rel=1e-6)
    # outside the mode: one plain sum in the vectors' dtype
    assert t_fused.obj_sum(torch.from_numpy(x)).dtype == torch.float32


def _params(Params, Ow, wide, ow, iters=12, algo=None):
    p = Params(max_iterations=iters + 1, epsilon=0.0, fx_wide=wide, constrain_step_size=False,
               orthantwise=Ow(1.0, 0, N - 1) if ow else None)
    return p.replace_ls(algorithm=algo) if algo else p


@pytest.mark.parametrize("ow", [False, True], ids=["morethuente", "owlqn"])
def test_wide_against_default_end_to_end(ow):
    """tests/test_wide_fx.py:121-163: whole runs through ``minimize_jit``,
    wide against default: the same iterations, fx rel 1e-3, fx float64 and
    the vectors float32."""
    x0 = t_rosen.initial_point(N, dtype=torch.float32)
    st_w = t_minimize_jit(_params(TParams, TOW, True, ow), x0, lbfgs_torch.default_evaluate(),
                          return_state=True)
    st_d = t_minimize_jit(_params(TParams, TOW, False, ow), x0, lbfgs_torch.default_evaluate(),
                          return_state=True)
    assert type(st_w.prob.fx) is np.float64 and type(st_d.prob.fx) is np.float32
    assert st_w.prob.x.dtype == st_w.prob.gx.dtype == torch.float32
    assert type(st_w.step) is np.float32 and type(st_w.dg0) is np.float32
    if ow:
        assert st_w.prob.pg.dtype == torch.float32
    assert st_w.k == st_d.k
    assert float(st_w.prob.fx) == pytest.approx(float(st_d.prob.fx), rel=1e-3)


def test_wide_host_loop_with_a_generic_objective():
    """tests/test_wide_fx.py:166-180: the step-at-a-time loop and a
    generic objective, fx float64 at every iteration."""
    b = lbfgs_torch.lbfgs().with_fx_wide().with_max_iterations(10)
    st = b.build(t_rosen.initial_point(100, dtype=torch.float32), t_rosen._plain_value_and_grad)
    assert type(st.state.prob.fx) is np.float64
    while not st.is_converged():
        p = st.propagate()
        assert type(st.state.prob.fx) is np.float64 and type(p.fx) is np.float64
    assert np.isfinite(st.report().fx)


@pytest.mark.parametrize("entry", ["minimize", "minimize_jit"])
@pytest.mark.parametrize("ow", [False, True], ids=["plain", "owlqn"])
def test_wide_changes_nothing_for_float64_vectors(entry, ow):
    x0 = t_rosen.initial_point(100)
    reps = []
    for wide in (False, True):
        b = lbfgs_torch.lbfgs().with_fx_wide(wide).with_max_iterations(40)
        if ow:
            b = b.with_orthantwise(1.0, 0, 99)
        reps.append(getattr(b, entry)(x0, lbfgs_torch.default_evaluate()))
    a, w = reps
    assert (a.niter, a.neval, a.fx) == (w.niter, w.neval, w.fx)
    assert torch.equal(a.x, w.x)


# ---------------------------------------------------------------------------
# one propagate per iteration from the JAX package's wide state
# ---------------------------------------------------------------------------


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=[False, True], ids=["morethuente", "owlqn"])
def jax_wide_states(request):
    ow = JOW(1.0, 0, N - 1) if request.param else None
    pdef = JDef(value_and_grad=j_rosen.value_and_grad, owlqn=ow)
    params = JParams(orthantwise=ow, fx_wide=True, constrain_step_size=False)
    step = jax.jit(lambda st: jsol.propagate_hot(pdef, params, st))
    st = jsol.start_state(jsol.init_state(pdef, params, j_rosen.initial_point(
        N, dtype=jnp.float32)), params)
    states = [_np(st)]
    for _ in range(ITERS):
        st = step(st)
        states.append(_np(st))
    return request.param, states


def test_wide_propagate_matches_jax(jax_wide_states):
    """Iterations 1-15 of plain and OWL-QN Rosenbrock at float32 with the
    wide scalar, each from the JAX package's own state: the same search
    (evaluations, status), the float64 fx at rel 1e-6 and the float32
    vectors at rel 1e-4 (the two packages sum in other orders, and the
    direction's two-loop cancels)."""
    ow, states = jax_wide_states
    owt = TOW(1.0, 0, N - 1) if ow else None
    pdef = TDef(t_rosen.value_and_grad, owlqn=owt)
    params = TParams(orthantwise=owt, fx_wide=True, constrain_step_size=False)
    assert states[0].prob.fx.dtype == np.float64
    for k in range(1, ITERS + 1):
        st = interop.state_from_jax(states[k - 1], "cpu")
        assert type(st.prob.fx) is np.float64
        out = tsol.propagate_hot(pdef, params, st)
        ref = states[k]
        assert type(out.prob.fx) is np.float64 and type(out.step) is np.float32
        assert (out.status, out.ncall, out.prob.neval) == (
            int(ref.status), int(ref.ncall), int(ref.prob.neval)), k
        _close(out.prob.fx, ref.prob.fx, f"fx {k}", rel=1e-6)
        for name in ("x", "gx", "d"):
            _close(getattr(out.prob, name), getattr(ref.prob, name), f"{name} {k}", rel=1e-4)


# ---------------------------------------------------------------------------
# where K7 runs
# ---------------------------------------------------------------------------


def test_k7_evaluates_the_wide_owlqn_init_only():
    """Under the wide mode the OWL-QN init of a factory objective is K7 at
    stp = 0 with wp = x0, whose point is x0 itself; the default init stays
    K1 plus the L1 term.  (On the CPU the wrappers run the counted plain
    versions.)"""
    x0 = t_rosen.initial_point(N, dtype=torch.float32)
    ow = TOW(1.0, 0, N - 1)
    pdef = TDef(t_rosen.value_and_grad, owlqn=ow)
    out = {}
    for wide in (False, True):
        before = (t_rosen.owlqn_trial_ref.calls, t_rosen.trial_ref.calls)
        st = tsol.init_state(pdef, TParams(orthantwise=ow, fx_wide=wide), x0)
        out[wide] = (t_rosen.owlqn_trial_ref.calls - before[0],
                     t_rosen.trial_ref.calls - before[1], st)
    assert out[False][:2] == (0, 1) and out[True][:2] == (1, 0)
    d, w = out[False][2], out[True][2]
    assert torch.equal(d.prob.x, w.prob.x) and torch.equal(d.prob.pg, w.prob.pg)
    assert float(w.prob.fx) == pytest.approx(float(d.prob.fx), rel=1e-6)
    j = jsol.init_state(JDef(j_rosen.value_and_grad, owlqn=JOW(1.0, 0, N - 1)),
                        JParams(orthantwise=JOW(1.0, 0, N - 1), fx_wide=True),
                        j_rosen.initial_point(N, dtype=jnp.float32))
    assert np.asarray(j.prob.fx).dtype == np.float64
    _close(w.prob.fx, j.prob.fx, "fx", rel=1e-7)


def test_k7_materializes_the_owlqn_search_without_an_epilogue():
    """A factory objective without the one-pass epilogue: under OWL-QN the
    search probes with K8 and materializes once with K7
    (``lbfgs_tpu/linesearch.py:838-839``), then K10, K12 and K13 follow;
    the run follows the generic objective's, which evaluates every trip."""
    vag = t_rosen.value_and_grad

    def no_epilogue(x):
        return vag(x)

    for name in ("__lbfgs_value_and_grad__", "__lbfgs_trial__", "__lbfgs_trial_probe__",
                 "__lbfgs_owlqn_trial__", "__lbfgs_owlqn_probe__"):
        setattr(no_epilogue, name, getattr(vag, name))
    b = lbfgs_torch.lbfgs().with_orthantwise(1.0, 0, 99).with_max_iterations(20)
    x0 = t_rosen.initial_point(100)
    before = (t_rosen.owlqn_trial_ref.calls, t_rosen.owlqn_probe_ref.calls,
              t_fused.pair_gram_xg_ref.calls)
    r = b.minimize_jit(x0, no_epilogue)
    used = (t_rosen.owlqn_trial_ref.calls - before[0],
            t_rosen.owlqn_probe_ref.calls - before[1],
            t_fused.pair_gram_xg_ref.calls - before[2])
    assert used == (r.niter - 1, r.neval - 1, r.niter - 1)
    g = b.minimize_jit(x0, t_rosen._plain_value_and_grad)
    assert (r.niter, r.neval) == (g.niter, g.neval)
    assert r.fx == pytest.approx(g.fx, rel=1e-12)
