"""The port's slice end to end on the CPU: the n = 100 goldens, the float32
lock-step with the JAX kernel path, both entry points and the revert on a
failed line search, and the vector primitives."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import lbfgs_torch
from lbfgs_torch import LbfgsError
from lbfgs_torch.minimize import LbfgsState as TState
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import vecmath as tvm
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_tpu.minimize import LbfgsState as JState
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.ops import vecmath as jvm
from lbfgs_tpu.params import LbfgsParams as JParams

# the recorded 2018 trajectory (tests/test_native_parity.py:143-153)
GOLDEN_FX, GOLDEN_GNORM = 1.2832127771605377e-15, 9.486547293218877e-07


def _trial_only_objective():
    """Rosenbrock with the trial and probe protocols but no one-pass
    epilogue: the solver composes the pair update from s = stp*d."""
    def vag(x):
        return t_rosen._plain_value_and_grad(x)

    vag.__lbfgs_value_and_grad__ = True
    vag.__lbfgs_trial__ = t_rosen.trial
    vag.__lbfgs_trial_probe__ = t_rosen.probe
    return vag


@pytest.mark.parametrize("entry", ["minimize", "minimize_jit"])
@pytest.mark.parametrize("objective", ["fused", "trial_only", "generic"])
def test_goldens_n100(entry, objective):
    fn = {"fused": lbfgs_torch.default_evaluate,
          "trial_only": _trial_only_objective,
          "generic": lambda: t_rosen._plain_value_and_grad}[objective]()
    x0 = t_rosen.initial_point(100, device="cpu")
    rep = getattr(lbfgs_torch.lbfgs(), entry)(x0, fn)
    assert rep.niter == 35
    rep = getattr(lbfgs_torch.lbfgs().with_constrain_step_size(False), entry)(x0, fn)
    assert rep.fx == pytest.approx(GOLDEN_FX, rel=1e-3)
    assert rep.gnorm == pytest.approx(GOLDEN_GNORM, rel=1e-6)
    assert rep.niter == 38
    # the caller's x0 is never written
    assert torch.equal(x0, t_rosen.initial_point(100, device="cpu"))


def _run(state_cls, params, x0, vag):
    st = state_cls.build(params, x0, vag)
    while not st.is_converged():
        st.propagate()
    return st.report()


def test_f32_lock_step_with_jax_kernel_path(monkeypatch):
    """8 iterations at n = 2^14: the port's plain path against the JAX
    Pallas kernels in interpret mode (tests/test_native_parity.py:186-234)."""
    n = 1 << 14
    rep_t = _run(TState, TParams(max_iterations=8, epsilon=0.0),
                 t_rosen.initial_point(n, torch.float32, device="cpu"), t_rosen.value_and_grad)
    monkeypatch.setenv("LBFGS_TPU_KERNELS_INTERPRET", "1")
    rep_j = _run(JState, JParams(max_iterations=8, epsilon=0.0),
                 j_rosen.initial_point(n, dtype=jnp.float32), j_rosen.value_and_grad)
    assert rep_t.niter == rep_j.niter == 8
    assert rep_t.fx == pytest.approx(rep_j.fx, rel=1e-4)
    assert rep_t.gnorm == pytest.approx(rep_j.gnorm, rel=1e-2)


def test_bf16_history_whole_run_matches_step_at_a_time():
    params = TParams(m=6, history_dtype="bfloat16", constrain_step_size=False,
                     epsilon=0.0, max_iterations=21)
    x0 = t_rosen.initial_point(2048, torch.float32, device="cpu")
    a = lbfgs_torch.minimize.minimize_jit(params, x0, t_rosen.value_and_grad)
    b = _run(TState, params, x0, t_rosen.value_and_grad)
    assert a.niter == b.niter == 21
    assert a.fx == b.fx and a.gnorm == b.gnorm
    assert torch.equal(a.x, b.x)


def test_failed_search_reverts_like_jax():
    """xtol = 10 makes the first bracketing trip fail (LS_ROUNDING): the
    host loop reverts x and raises "x not changed" at the same
    iteration as the JAX package."""
    out = []
    for cls, P, x0, vag in (
        (TState, TParams, t_rosen.initial_point(100, device="cpu"), t_rosen.value_and_grad),
        (JState, JParams, j_rosen.initial_point(100), j_rosen.value_and_grad),
    ):
        st = cls.build(P().replace_ls(xtol=10.0), x0, vag)
        with pytest.raises(Exception) as exc:
            while not st.is_converged():
                st.propagate()
        assert "x not changed" in str(exc.value)
        out.append((int(st.state.k), int(st.state.ls_status),
                    np.asarray(st.state.prob.x), np.asarray(st.state.prob.xp)))
    (kt, lt, xt, xpt), (kj, lj, xj, xpj) = out
    assert (kt, lt) == (kj, lj) == (9, 10)
    np.testing.assert_array_equal(xt, xpt)
    np.testing.assert_allclose(xt, xj, rtol=1e-9)


def test_whole_run_raises_on_fatal_status():
    b = lbfgs_torch.lbfgs().with_linesearch_xtol(10.0)
    with pytest.raises(LbfgsError, match="x not changed"):
        b.minimize_jit(t_rosen.initial_point(100, device="cpu"), lbfgs_torch.default_evaluate())
    st = lbfgs_torch.minimize.minimize_jit(
        b.param, t_rosen.initial_point(100, device="cpu"), lbfgs_torch.default_evaluate(),
        return_state=True)
    assert st.status == 20 and st.k == 9


def test_fx_delta_plateau_test_matches_jax():
    kw = dict(fx_delta_enabled=True, past=3, delta=1e-2)
    rt = lbfgs_torch.minimize.minimize(TParams(**kw), t_rosen.initial_point(100, device="cpu"),
                                       t_rosen.value_and_grad)
    from lbfgs_tpu.minimize import minimize as jmin

    rj = jmin(JParams(**kw), j_rosen.initial_point(100), j_rosen.value_and_grad)
    assert rt.status == rj.status == 1
    assert rt.niter == rj.niter
    assert rt.fx == pytest.approx(rj.fx, rel=1e-9)


@pytest.mark.parametrize("op", ["axpy", "dot", "scale", "copy", "ncopy", "diff",
                                "norm2", "norm2inv"])
def test_vecmath_matches_jax(op):
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal(33), rng.standard_normal(33)
    args = {"axpy": (y, x, 0.7), "dot": (x, y), "scale": (y, 1.5), "copy": (x,),
            "ncopy": (x,), "diff": (x, y), "norm2": (x,), "norm2inv": (x,)}[op]
    t = getattr(tvm, op)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                           for a in args))
    j = getattr(jvm, op)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                           for a in args))
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=1e-12)
