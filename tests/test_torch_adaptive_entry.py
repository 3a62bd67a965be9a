"""The adaptive line-search entry step of the PyTorch port against the JAX
package (``params.adaptive_entry_step``, ``with_adaptive_entry_step``).

Where the step is not capped, each search after the second enters at
clip(growth * last accepted step, 2^-16, 1) instead of 1.0.  The four
cases of ``tests/test_adaptive_entry.py``, with a generic stiff quadratic
(a plain torch value-and-grad) in place of the JAX package's
``separable.quadratic``, which the port does not have; the per-iteration
entry step against the JAX package's in float64 (rel 1e-12); and, with
the combine+probe fusion, the speculation at the predicted step and the
damped run, whose row K15's fix form persists, against the JAX package's
damped fusion-on run.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import lbfgs_torch
from lbfgs_torch.linesearch import carried
from lbfgs_torch.minimize import LbfgsState as TState
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.models import separable as t_separable
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.orthantwise import Orthantwise as TOW
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_torch.params import LineSearchAlgorithm as TAlgo
from lbfgs_tpu.minimize import LbfgsState as JState
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.models import separable
from lbfgs_tpu.ops import fused as j_fused
from lbfgs_tpu.orthantwise import Orthantwise as JOW
from lbfgs_tpu.params import LbfgsParams as JParams
from lbfgs_tpu.params import LineSearchAlgorithm as JAlgo


def _params(cls, algo, **kw):
    return cls(**kw).replace_ls(algorithm=algo.BacktrackingArmijo)


def _run(st):
    while not st.is_converged():
        st.propagate()
    return st.report()


def test_entry_step_follows_policy():
    n, growth = 256, np.float32(2.0)
    params = _params(TParams, TAlgo, epsilon=0.0, max_iterations=12,
                     constrain_step_size=False, adaptive_entry_step=float(growth))
    st = TState.build(params, t_rosen.initial_point(n, torch.float32, device="cpu"),
                      t_rosen.value_and_grad)
    st.propagate()  # k == 1 bookkeeping
    for _ in range(6):
        st.propagate()
        s = st.state
        # the first real search adapts from the init's entry, which says
        # nothing of the ladder: literal 1.0
        want = np.float32(1.0) if s.k <= 2 else np.clip(growth * s.step_ls, np.float32(2.0 ** -16),
                                                         np.float32(1.0))
        assert type(s.step) is np.float32 and s.step == want


def test_entry_steps_match_jax_f64():
    """Every iteration's entry step against the JAX package's, float64,
    n = 256, rel 1e-12: OWL-QN (c = 1), whose Armijo ladder accepts steps
    below 1, so the policy's clip and its growth both act."""
    n = 256
    kw = dict(epsilon=0.0, max_iterations=13, constrain_step_size=False,
              adaptive_entry_step=2.0)
    out = []
    logging.disable(logging.WARNING)
    try:
        for st in (TState.build(_params(TParams, TAlgo, orthantwise=TOW(1.0, 0, n - 1), **kw),
                                t_rosen.initial_point(n, device="cpu"), t_rosen.value_and_grad),
                   JState.build(_params(JParams, JAlgo, orthantwise=JOW(1.0, 0, n - 1), **kw),
                                j_rosen.initial_point(n), j_rosen.value_and_grad)):
            steps = []
            while not st.is_converged():
                st.propagate()
                steps.append((int(st.state.k), float(st.state.step),
                              float(st.state.step_ls)))
            out.append(np.array(steps))
    finally:
        logging.disable(logging.NOTSET)
    t, j = out
    assert t.shape == j.shape == (13, 3)
    np.testing.assert_array_equal(t[:, 0], j[:, 0])
    np.testing.assert_allclose(t[:, 1:], j[:, 1:], rtol=1e-12)
    # past k = 2 the policy moved the entry off the literal 1.0
    assert (t[2:, 1] < 1.0).any() and (t[:2, 1] == [t[0, 1], 1.0]).all()


def _stiff_quad(n, seed=0, w_scale=64.0):
    """The same uniformly stiff diagonal quadratic 1/2 sum w (x - t)^2 in
    both packages: the port's ``separable.quadratic`` (its kernels' plain
    versions on the CPU) here, the JAX package's there
    (``tests/test_adaptive_entry.py:42-50``)."""
    w = np.full(n, w_scale, np.float32)
    t = (np.random.RandomState(seed + 1).randn(n)).astype(np.float32)
    t_obj = t_separable.quadratic(torch.from_numpy(w), torch.from_numpy(t))
    return t_obj, separable.quadratic(jnp.asarray(w), jnp.asarray(t)), t


def test_adaptive_no_regression_on_well_scaled():
    """On a uniformly scaled quadratic the literal entry is optimal; the
    k <= 2 literal guard keeps the adaptive run from crawling back up to
    1.0.  The port's evaluations are the JAX package's."""
    n = 256
    t_obj, j_obj, target = _stiff_quad(n, seed=20)
    base = dict(epsilon=1e-4, max_iterations=60, constrain_step_size=False)
    reps = {}
    for growth in (0.0, 2.0):
        reps["t", growth] = _run(TState.build(
            _params(TParams, TAlgo, adaptive_entry_step=growth, **base),
            torch.zeros(n), t_obj))
        reps["j", growth] = _run(JState.build(
            _params(JParams, JAlgo, adaptive_entry_step=growth, **base),
            jnp.zeros(n, jnp.float32), j_obj))
    np.testing.assert_allclose(reps["t", 2.0].x.numpy(), target, rtol=1e-3, atol=1e-3)
    assert reps["t", 2.0].neval <= reps["t", 0.0].neval + 2
    for growth in (0.0, 2.0):
        assert (reps["t", growth].niter, reps["t", growth].neval) == (
            int(reps["j", growth].niter), int(reps["j", growth].neval))


def test_adaptive_cuts_owlqn_ladder():
    """OWL-QN Rosenbrock's Armijo ladder at n = 2^14: entering near the last
    accepted step cuts evaluations by more than 8% without losing the
    solution.  The port takes 172 -> 155 evaluations; the JAX package 172
    -> 140 in float32, and both packages 178 -> 155 in float64: where a
    float32 ladder lands is rounding luck."""
    n = 1 << 14
    x0 = t_rosen.initial_point(n, torch.float32, device="cpu")
    base = TParams(epsilon=3e-2, max_iterations=400, constrain_step_size=False,
                   orthantwise=TOW(c=1.0, start=0, end=None))
    logging.disable(logging.WARNING)
    try:
        rep_lit = _run(TState.build(base, x0, t_rosen.value_and_grad))
        rep_ad = _run(TState.build(base.replace(adaptive_entry_step=2.0), x0,
                                   t_rosen.value_and_grad))
    finally:
        logging.disable(logging.NOTSET)
    assert rep_lit.status == rep_ad.status == lbfgs_torch.Status.CONVERGED
    assert rep_ad.neval < rep_lit.neval * 0.92, (rep_ad.neval, rep_lit.neval)
    assert rep_ad.fx == pytest.approx(rep_lit.fx, rel=1e-3)


def _unfused(fn):
    """``fn`` without the combine+probe fusion's hooks (the solver then
    takes K3, K6, K13)."""
    def vag(x):
        return fn(x)

    vag.__dict__.update({k: v for k, v in fn.__dict__.items()
                         if not k.startswith(("__lbfgs_combine_probe", "__lbfgs_combine_ow_probe"))})
    return vag


def test_probe_speculation_at_predicted_step():
    """With the combine+probe fusion the speculation is at the adaptive
    prediction, which is the next entry step by construction: every first
    trip after the first takes the carried probe, and the run is the
    fusion-off run bit for bit."""
    n = j_fused.MIN_FUSED_N
    params = _params(TParams, TAlgo, epsilon=0.0, max_iterations=12,
                     constrain_step_size=False, adaptive_entry_step=2.0)
    x0 = t_rosen.initial_point(n, torch.float32, device="cpu")
    reps = {}
    for on in (False, True):
        calls, carried.used = t_rosen.probe_ref.calls, 0
        fn = lbfgs_torch.default_evaluate()
        st = TState.build(params, x0, fn if on else _unfused(fn))
        entries = []
        while not st.is_converged():
            st.propagate()
            entries.append(st.state.step)
        reps[on] = (st.report(), entries, t_rosen.probe_ref.calls - calls, carried.used)
    (r_off, e_off, p_off, _), (r_on, e_on, p_on, used) = reps[False], reps[True]
    assert (r_on.niter, r_on.neval, r_on.fx) == (r_off.niter, r_off.neval, r_off.fx)
    assert torch.equal(r_on.x, r_off.x) and e_on == e_off
    assert min(e_on) < 1.0
    assert used == r_on.niter - 2 and p_on == p_off - used


def test_damped_fusion_skips_k6_and_matches_jax(monkeypatch):
    """Damped with the fusion: K15's fix form persists the damped ring row
    (the JAX package blends it before K15, ``lbfgs_tpu/solver.py:
    758-769``), so K6's plain version never runs, and the run tracks the
    JAX package's damped fusion-on run (float32, n = MIN_FUSED_N, the
    Pallas interpreter, the step uncapped as the port fuses only there):
    the same iterations and evaluations, fx to rel 1e-3."""
    n = j_fused.MIN_FUSED_N
    kw = dict(max_iterations=8, epsilon=0.0, damping=True, constrain_step_size=False)
    monkeypatch.setenv("LBFGS_TPU_KERNELS_INTERPRET", "1")
    monkeypatch.setenv("LBFGS_TPU_KERNELS", "all")
    js = JState.build(JParams(**kw), j_rosen.initial_point(n, dtype=jnp.float32),
                      j_rosen.value_and_grad)
    assert js.state.probe1 is not None
    rep_j = _run(js)
    calls = t_fused.combine_fix_ref.calls
    ts = TState.build(TParams(**kw), t_rosen.initial_point(n, torch.float32, device="cpu"),
                      lbfgs_torch.default_evaluate())
    assert ts.state.probe1 is not None
    rep_t = _run(ts)
    assert t_fused.combine_fix_ref.calls == calls
    assert sum(rep_t.damping_cases[1:]) > 0
    assert rep_t.niter == int(rep_j.niter) == 8
    assert rep_t.neval == int(rep_j.neval)
    assert rep_t.fx == pytest.approx(float(rep_j.fx), rel=1e-3)
