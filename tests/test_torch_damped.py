"""Powell damping in the PyTorch port against ``lbfgs_tpu`` on the CPU.

``update_pair`` on constructed pairs that hit case 1, case 2 and no
damping, with and without ``damping_fixed`` (the literal case-2 no-op
pinned); one port ``propagate_hot`` per iteration from the JAX package's
own damped state (``interop``, iterations 1-15, float64, rel 1e-9) on
each port branch: the fused plain branch (K4 with the . gp column and K6,
their plain versions here), the K5 branch (a fused trial without the
epilogue), the fused OWL-QN branch (K14 with . gp and the row blend) and
the generic composed branch.  On the CPU in float64 the JAX package
takes its composed ``update_pair`` branch (``lbfgs_tpu/solver.py:847-869``)
for every objective, since its fused kernels take float32 only: that
branch is what each port branch is held to, and the port's fused
reconstructions differ from it by rounding only.  Then whole runs: the
50-iteration damped OWL-QN prefix at the bounds the JAX package pins
itself to the native core with (tests/test_damped_fused.py:221-226),
every entry point, the K5 route, the routing rules, and the constants
``chip_smoke.py`` holds the card to.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import lbfgs_torch
import lbfgs_tpu
from lbfgs_torch import interop
from lbfgs_torch import solver as tsol
from lbfgs_torch.core import ProblemDef as TDef
from lbfgs_torch.minimize import LbfgsState as TState
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.orthantwise import Orthantwise as TOw
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_tpu import solver as jsol
from lbfgs_tpu.core import ProblemDef as JDef
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.orthantwise import Orthantwise as JOw
from lbfgs_tpu.params import LbfgsParams as JParams

N, ITERS, REL = 256, 15, 1e-9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(t, j, what, rel=REL):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    j = np.asarray(j, np.float64).reshape(t.shape)
    scale = max(np.abs(j).max(), 1e-300)
    np.testing.assert_allclose(t, j, rtol=rel, atol=rel * scale, err_msg=what)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# update_pair: the three cases, literal and fixed
# ---------------------------------------------------------------------------


def _pair(case: str, seed: int = 11):
    """(x, xp, gx, gp, step) whose pair has ys / sbs = 0.1 (case 1), 5
    (case 2) or 1 (none), with sbs = s.(-step*gp) > 0."""
    rng = np.random.default_rng(seed)
    n, step = 64, 0.5
    s = rng.standard_normal(n)
    gp = -s + 0.3 * rng.standard_normal(n)
    sbs = np.dot(s, -step * gp)
    ratio = {"case1": 0.1, "case2": 5.0, "none": 1.0}[case]
    r = rng.standard_normal(n)
    r -= np.dot(r, s) / np.dot(s, s) * s          # orthogonal to s
    y = ratio * sbs / np.dot(s, s) * s + r
    xp = rng.standard_normal(n)
    return xp + s, xp, gp + y, gp, step


@pytest.mark.parametrize("fixed", [False, True], ids=["literal", "fixed"])
@pytest.mark.parametrize("case", ["case1", "case2", "none"])
def test_update_pair_cases_match_jax(case, fixed):
    x, xp, gx, gp, step = _pair(case)
    j = jsol.update_pair(JParams(damping=True, damping_fixed=fixed),
                         *(jnp.asarray(v) for v in (x, xp, gx, gp)), jnp.float64(step))
    t = tsol.update_pair(TParams(damping=True, damping_fixed=fixed),
                         *(torch.from_numpy(v) for v in (x, xp, gx, gp)), np.float64(step))
    for name in ("s", "y", "ys", "gamma"):
        _close(getattr(t, name), getattr(j, name), name, rel=1e-13)
    assert t.status == int(j.status) == 0
    assert t.case == {"case1": 1, "case2": 2, "none": 0}[case]
    raw = gx - gp
    stored = t.y.numpy()
    if case == "none" or (case == "case2" and not fixed):
        # no damping, and the literal case 2: computed, never stored
        np.testing.assert_array_equal(stored, raw)
    else:
        assert not np.allclose(stored, raw)
    # ys and gamma stay pre-damping in every case
    assert float(t.ys) == pytest.approx(np.dot(raw, x - xp), rel=1e-13)


def test_update_pair_needs_the_step_when_damped():
    v = torch.ones(4)
    with pytest.raises(ValueError, match="step"):
        tsol.update_pair(TParams(damping=True), v, v * 2, v, v * 3)


# ---------------------------------------------------------------------------
# one propagate per iteration from JAX's own damped state
# ---------------------------------------------------------------------------

#: (orthantwise, damping_fixed) of each JAX run; its states feed the port
RUNS = {"plain": (False, False), "plain_fixed": (False, True),
        "owlqn": (True, False), "owlqn_fixed": (True, True)}


@pytest.fixture(scope="module")
def jax_states():
    cache = {}

    def get(run):
        if run not in cache:
            ow_on, fixed = RUNS[run]
            ow = JOw(1.0, 0, N - 1) if ow_on else None
            pdef = JDef(value_and_grad=j_rosen.value_and_grad, owlqn=ow)
            params = JParams(damping=True, damping_fixed=fixed, orthantwise=ow)
            step = jax.jit(lambda st: jsol.propagate_hot(pdef, params, st))
            st = jsol.start_state(jsol.init_state(pdef, params, j_rosen.initial_point(N)),
                                  params)
            states = [_np(st)]
            for _ in range(ITERS):
                st = step(st)
                states.append(_np(st))
            cache[run] = states
        return cache[run]

    return get


def _trial_only_objective():
    """Rosenbrock with the trial and probe protocols but no one-pass
    epilogue: the solver takes K5 for the pair."""
    def vag(x):
        return t_rosen._plain_value_and_grad(x)

    vag.__lbfgs_value_and_grad__ = True
    vag.__lbfgs_trial__ = t_rosen.trial
    vag.__lbfgs_trial_probe__ = t_rosen.probe
    return vag


#: port branch -> (JAX run, objective)
BRANCHES = {
    "fused": ("plain", lambda: t_rosen.value_and_grad),
    "fused_fixed": ("plain_fixed", lambda: t_rosen.value_and_grad),
    "k5": ("plain", _trial_only_objective),
    "generic": ("plain", lambda: t_rosen._plain_value_and_grad),
    "owlqn_fused": ("owlqn", lambda: t_rosen.value_and_grad),
    "owlqn_fused_fixed": ("owlqn_fixed", lambda: t_rosen.value_and_grad),
    "owlqn_generic": ("owlqn_fixed", lambda: t_rosen._plain_value_and_grad),
}


def _calls():
    return (t_rosen.trial_pair_gram_ref.calls, t_rosen.owlqn_trial_pair_gram_ref.calls,
            t_fused.pair_gram_sd_ref.calls, t_fused.combine_fix_ref.calls)


@pytest.mark.parametrize("k", range(1, ITERS + 1))
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_damped_propagate_matches_jax(jax_states, branch, k):
    run, objective = BRANCHES[branch]
    ow_on, fixed = RUNS[run]
    ow = TOw(1.0, 0, N - 1) if ow_on else None
    pdef = TDef(value_and_grad=objective(), owlqn=ow)
    params = TParams(damping=True, damping_fixed=fixed, orthantwise=ow)
    states = jax_states(run)
    st = interop.state_from_jax(states[k - 1], "cpu")
    before = _calls()
    out = tsol.propagate_hot(pdef, params, st)
    used = [b - a for a, b in zip(before, _calls())]
    ref = states[k]
    assert out.status == int(ref.status) == 0
    assert (out.k, out.end, out.ncall, out.prob.neval) == (
        int(ref.k), int(ref.end), int(ref.ncall), int(ref.prob.neval))
    for name in ("x", "gx", "d", "xp", "gp") + (("pg",) if ow_on else ()):
        _close(getattr(out.prob, name), getattr(ref.prob, name), name)
    for name in ("fx", "gnorm2", "xnorm2"):
        _close(getattr(out.prob, name), getattr(ref.prob, name), name)
    for name in ("step", "step_ls", "dg0"):
        _close(getattr(out, name), getattr(ref, name), name)
    for name in ("s", "y", "ys", "alpha", "sy", "yy"):
        _close(getattr(out.hist, name), getattr(ref.hist, name), name)
    # the branch taken: K4 + K6, K5 + K6, K14 (+ row blend), or composed
    want = {"fused": [1, 0, 0, 1], "fused_fixed": [1, 0, 0, 1], "k5": [0, 0, 1, 1],
            "generic": [0, 0, 0, 0], "owlqn_fused": [0, 1, 0, 0],
            "owlqn_fused_fixed": [0, 1, 0, 0], "owlqn_generic": [0, 0, 0, 0]}[branch]
    assert used == want
    assert sum(out.damping_cases) == 1


@pytest.mark.parametrize("run", list(RUNS))
def test_damping_fires_in_the_pinned_prefix(jax_states, run):
    """Within iterations 1-15 each run meets a damping case, so the
    propagate pins exercise the reconstruction and not only a = 1, b = 0:
    a stored damping (case 1, or case 2 under ``damping_fixed``) in all
    runs but the literal OWL-QN one, where only case 2 fires and the pin
    holds its write-back to the no-op."""
    ow_on, fixed = RUNS[run]
    ow = TOw(1.0, 0, N - 1) if ow_on else None
    st = interop.state_from_jax(jax_states(run)[0], "cpu")
    pdef = TDef(value_and_grad=t_rosen.value_and_grad, owlqn=ow)
    params = TParams(damping=True, damping_fixed=fixed, orthantwise=ow)
    for _ in range(ITERS):
        st = tsol.propagate_hot(pdef, params, st)
    none, case1, case2 = st.damping_cases
    assert none + case1 + case2 == ITERS
    if run == "owlqn":
        assert case2 > 0
    else:
        assert case1 + (case2 if fixed else 0) > 0


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------


def _trace(builder, x0, fn):
    out = []

    def cb(p):
        out.append((p.niter, float(p.fx), float(p.gnorm), float(p.step), p.neval))
        return False

    rep = builder.minimize(x0, fn, cb)
    return out, rep


@pytest.fixture(scope="module")
def owlqn_prefix_jax():
    b = lbfgs_tpu.lbfgs().with_orthantwise(1.0, 0, 99).with_damping(True).with_max_iterations(50)
    return _trace(b, j_rosen.initial_point(100), j_rosen.value_and_grad)[0]


@pytest.mark.parametrize("objective", ["fused", "generic"])
def test_damped_owlqn_50_iterations_match_jax(owlqn_prefix_jax, objective):
    """The JAX package's 50-step damped OWL-QN prefix (the run it pins to
    the native core), per iteration at the same bounds: neval equal, fx
    rel 1e-9, gnorm and step rel 1e-6; damping case 1 fires."""
    fn = t_rosen.value_and_grad if objective == "fused" else t_rosen._plain_value_and_grad
    b = lbfgs_torch.lbfgs().with_orthantwise(1.0, 0, 99).with_damping(True).with_max_iterations(50)
    tt, rep = _trace(b, t_rosen.initial_point(100, device="cpu"), fn)
    assert len(tt) == len(owlqn_prefix_jax) == 50
    for (kt, ft, gt, st, et), (kj, fj, gj, sj, ej) in zip(tt, owlqn_prefix_jax):
        assert kt == kj and et == ej
        assert ft == pytest.approx(fj, rel=1e-9)
        assert gt == pytest.approx(gj, rel=1e-6)
        assert st == pytest.approx(sj, rel=1e-6)
    assert rep.damping_cases[1] > 0


#: damped configurations of the whole-run checks
CONFIGS = {
    "damped": lambda b: b.with_damping(True),
    "damped_fixed": lambda b: b.with_damping(True).with_damping_fixed(),
    "damped_owlqn": lambda b: b.with_orthantwise(1.0, 0, 99).with_damping(True),
    "gradient_only": lambda b: b.with_gradient_only(),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_entry_points_agree_and_match_jax(config):
    """``minimize``, ``minimize_jit`` and ``LbfgsState`` take the same
    damped run (bit for bit, all on the fused branch), and it ends where
    the JAX package's does."""
    b = CONFIGS[config](lbfgs_torch.lbfgs()).with_max_iterations(50)
    x0 = t_rosen.initial_point(100, device="cpu")
    reps = [b.minimize(x0, t_rosen.value_and_grad),
            b.minimize_jit(x0, t_rosen.value_and_grad)]
    st = b.build(x0, t_rosen.value_and_grad)
    while not st.is_converged():
        st.propagate()
    reps.append(st.report())
    for r in reps[1:]:
        assert (r.niter, r.fx, r.gnorm, r.status) == (
            reps[0].niter, reps[0].fx, reps[0].gnorm, reps[0].status)
        assert r.damping_cases == reps[0].damping_cases
        assert torch.equal(r.x, reps[0].x)
    rj = CONFIGS[config](lbfgs_tpu.lbfgs()).with_max_iterations(50).minimize(
        j_rosen.initial_point(100), j_rosen.value_and_grad)
    assert reps[0].niter == rj.niter and reps[0].status == int(rj.status)
    # Rosenbrock's valley amplifies the rounding of the two packages'
    # different passes to ~1e-5 rel by the end, where fx is ~1e-13
    assert reps[0].fx == pytest.approx(float(rj.fx), rel=1e-3, abs=1e-12)
    assert sum(reps[0].damping_cases) == reps[0].niter - 1


def test_k5_route_runs_damped_like_the_epilogue():
    """A fused trial without the epilogue takes K5 (here its plain
    version) with the . gp column, then K6: the same run as the K4 route,
    to the rounding of a separate pass."""
    b = lbfgs_torch.lbfgs().with_damping(True).with_damping_fixed().with_max_iterations(20)
    x0 = t_rosen.initial_point(100, device="cpu")
    before = t_fused.pair_gram_sd_ref.calls
    r5 = b.minimize_jit(x0, _trial_only_objective())
    assert t_fused.pair_gram_sd_ref.calls - before == 19
    r4 = b.minimize_jit(x0, t_rosen.value_and_grad)
    assert r5.niter == r4.niter and r5.damping_cases == r4.damping_cases
    assert r5.fx == pytest.approx(r4.fx, rel=1e-9)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_damped_owlqn_takes_k14_with_gp_and_never_k5(monkeypatch):
    """Damped OWL-QN on a factory objective runs K14's . gp form and
    never K5 (tests/test_damped_fused.py:142-177), nor K6."""
    def refuse(*a, **kw):
        raise AssertionError("K5 ran under OWL-QN")

    monkeypatch.setattr(t_fused, "pair_gram_sd", refuse)
    seen = []
    orig = t_rosen.value_and_grad.__lbfgs_owlqn_trial_pair_gram__

    def spy(*a, **kw):
        seen.append(kw.get("with_gp"))
        return orig(*a, **kw)

    monkeypatch.setattr(t_rosen.value_and_grad, "__lbfgs_owlqn_trial_pair_gram__", spy)
    fix = t_fused.combine_fix_ref.calls
    rep = (lbfgs_torch.lbfgs().with_orthantwise(1.0, 0, 99).with_damping(True)
           .with_max_iterations(6).minimize(t_rosen.initial_point(100, device="cpu"), t_rosen.value_and_grad))
    assert rep.niter == 6
    assert seen and all(seen)
    assert t_fused.combine_fix_ref.calls == fix


def test_gradient_only_with_more_thuente_still_raises():
    b = lbfgs_torch.lbfgs().with_gradient_only().with_linesearch_algorithm("MoreThuente")
    with pytest.raises(ValueError, match="incompatible with MoreThuente"):
        b.minimize(t_rosen.initial_point(100, device="cpu"), t_rosen.value_and_grad)


def test_gradient_only_selects_strong_wolfe_and_damping():
    p = lbfgs_torch.lbfgs().with_gradient_only().param
    assert p.damping and p.linesearch.gradient_only
    assert p.linesearch.algorithm == "BacktrackingStrongWolfe"


# ---------------------------------------------------------------------------
# chip_smoke.py's recorded constants
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("config", ["damped", "damped_fixed", "damped_owlqn"])
def test_chip_smoke_damped_constants_are_lbfgs_tpus(config):
    """The n = 100 float64 damped runs' niter, fx after 15 iterations and
    final fx that ``chip_smoke.py`` holds the card to are the JAX
    package's current output."""
    want = _chip_smoke().DAMPED_N100[config]
    b = CONFIGS[config](lbfgs_tpu.lbfgs()).with_max_iterations(50)
    trace, rep = _trace(b, j_rosen.initial_point(100), j_rosen.value_and_grad)
    assert rep.niter == want["niter"]
    assert trace[14][1] == pytest.approx(want["fx15"], rel=1e-12)
    assert float(rep.fx) == pytest.approx(want["fx"], rel=1e-12)
