"""Histories deeper than 64 rows in the PyTorch port against ``lbfgs_tpu``.

Above ``factory.MAX_M`` ring rows the Triton kernels K4, K14, K15 and K16
run their deep forms, so the solver takes the one-pass epilogue (K4, K14
under OWL-QN) and the combine+probe fusion (K15, K16) at any depth, as
the JAX package runs its kernels at every depth
(``lbfgs_tpu/ops/fused.py:1010-1021, 1604-1614``); on the CPU their plain
versions run.  An objective without the epilogue's and the fusion's hooks
takes K1 (K7 under OWL-QN), then K5 (K12) and K3, K6 or K13, each of
which takes any depth too.

Whole runs at m = 65 and 80, n = 100, float64, each held to the JAX
package's run with the same settings: the same iterations and status,
and fx within rel 1e-6.  Plain L-BFGS and OWL-QN (c = 1 on [0, 99)) run
with the uncapped step, the damped runs with the default, capped step
(as the repository's other damped pins do) and the fixed damping also
uncapped.  Uncapped, the plain damped run ends at fx ~2.5e-14, where the
two packages' damped reconstructions part by rounding alone (1.7e-19
apart, rel 6.7e-6): that case is held to the same iterations and status
and fx within 1e-18 absolute.  Damped OWL-QN takes K14 with its . gp
column, and without the epilogue K12 with its . gp column and K14's
damped reconstruction, as the JAX package runs K14 at every depth.  Then
one port step per iteration from the JAX package's own state over the
first 15 iterations at m = 65, rel 1e-9 (as ``tests/test_torch_solver.py``).
The deep forms themselves are held to the JAX package's kernels in
``tests/test_torch_deep_fusions.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from lbfgs_torch import default_evaluate as t_evaluate
from lbfgs_torch import interop
from lbfgs_torch import solver as tsol
from lbfgs_torch.core import ProblemDef as TDef
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import factory as t_factory
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.params import Lbfgs as TLbfgs
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_tpu import default_evaluate as j_evaluate
from lbfgs_tpu import solver as jsol
from lbfgs_tpu.core import ProblemDef as JDef
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.params import Lbfgs as JLbfgs
from lbfgs_tpu.params import LbfgsParams as JParams

N, FX_REL, ITERS, REL = 100, 1e-6, 15, 1e-9
#: the uncapped damped run's fx bound: its rounding scale near fx ~2.5e-14
FX_ABS_UNCAPPED_DAMPED = 1e-18

#: each case's builder chain, applied to both packages' builders
CASES = {
    "plain": lambda b: b.with_constrain_step_size(False),
    "damped": lambda b: b.with_damping(True),
    "damped_fixed": lambda b: b.with_damping(True).with_damping_fixed(),
    "damped_fixed_uncapped": lambda b: (b.with_damping(True).with_damping_fixed()
                                        .with_constrain_step_size(False)),
    "owlqn": lambda b: b.with_orthantwise(1.0, 0, 99).with_constrain_step_size(False),
    "damped_owlqn": lambda b: b.with_orthantwise(1.0, 0, 99).with_damping(True),
}


#: the hooks of the one-pass epilogue (K4, K14) and of the combine+probe
#: fusion (K15, K16)
EPILOGUE_AND_FUSION = ("__lbfgs_trial_pair_gram", "__lbfgs_owlqn_trial_pair_gram",
                       "__lbfgs_combine_probe", "__lbfgs_combine_ow_probe")


def _objective(drop=(), **hooks):
    """Rosenbrock's fused objective without the hooks whose names start with
    one of ``drop``, and with ``hooks`` in place of its own."""
    vag = t_rosen.value_and_grad

    def fn(x):
        return vag(x)

    fn.__dict__.update({k: v for k, v in vag.__dict__.items() if not k.startswith(drop)})
    fn.__dict__.update(hooks)
    return fn


def _run(case: str, m: int, which: str, fn=None):
    if which == "port":
        b = TLbfgs(TParams(m=m))
        x0, fn = t_rosen.initial_point(N, device="cpu"), fn or t_evaluate()
    else:
        b = JLbfgs(JParams(m=m))
        x0, fn = j_rosen.initial_point(N), j_evaluate()
    return CASES[case](b.with_max_iterations(200)).minimize(x0, fn)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("m", [65, 80])
def test_deep_history_run_matches_jax(m, case):
    t = _run(case, m, "port")
    j = _run(case, m, "jax")
    assert (t.niter, int(t.status)) == (j.niter, int(j.status))
    assert int(t.status) == 1  # CONVERGED
    assert t.fx == pytest.approx(float(j.fx), rel=FX_REL)


@pytest.mark.parametrize("m", [65, 80])
def test_deep_history_uncapped_damped_run_matches_jax(m):
    """The plain damped run with the uncapped step (K4 with . gp and K15's
    fix form): the same iterations and status as the JAX package, fx
    within ``FX_ABS_UNCAPPED_DAMPED``."""
    uncapped = lambda b: b.with_damping(True).with_constrain_step_size(False)
    t = uncapped(TLbfgs(TParams(m=m)).with_max_iterations(200)).minimize(
        t_rosen.initial_point(N, device="cpu"), t_evaluate())
    j = uncapped(JLbfgs(JParams(m=m)).with_max_iterations(200)).minimize(
        j_rosen.initial_point(N), j_evaluate())
    assert (t.niter, int(t.status)) == (j.niter, int(j.status))
    assert int(t.status) == 1  # CONVERGED
    assert abs(t.fx - float(j.fx)) <= FX_ABS_UNCAPPED_DAMPED


def test_deep_history_damped_owlqn_routes_through_k12_with_gp(monkeypatch):
    """Damped OWL-QN at m = 65: each iteration's pair goes through K14 with
    its . gp column (its plain version on the CPU), never K12; through an
    objective without the epilogue's and the fusion's hooks, through K12
    with its . gp column.  Neither takes the composed ``update_pair``."""
    vag = t_rosen.value_and_grad
    k14_forms, k12_forms = [], []

    def k14_spy(*a, with_gp=False, **kw):
        k14_forms.append(with_gp)
        return vag.__lbfgs_owlqn_trial_pair_gram__(*a, with_gp=with_gp, **kw)

    ref = t_fused.pair_gram_xg_ref

    def k12_spy(x, xp, gx, gp, pg, S, Y, end, with_gp=False):
        k12_forms.append(with_gp)
        return ref(x, xp, gx, gp, pg, S, Y, end, with_gp)

    k12_spy.calls = 0  # the plain version counts its calls on the module's name
    def no_update_pair(*a, **kw):
        raise AssertionError("the composed damped branch ran")

    monkeypatch.setattr(t_fused, "pair_gram_xg_ref", k12_spy)
    monkeypatch.setattr(tsol, "update_pair", no_update_pair)
    r = _run("damped_owlqn", 65, "port",
             _objective(__lbfgs_owlqn_trial_pair_gram__=k14_spy))
    assert int(r.status) == 1
    assert k14_forms == [True] * (r.niter - 1) and k12_forms == []
    k = vag.kernels
    before = k.owlqn_trial_pair_gram_ref.calls
    r = _run("damped_owlqn", 65, "port", _objective(EPILOGUE_AND_FUSION))
    assert int(r.status) == 1
    assert k.owlqn_trial_pair_gram_ref.calls == before
    assert k12_forms == [True] * (r.niter - 1)


def test_deep_history_routes_through_the_any_depth_kernels():
    """At m = 65 the predicates take the ring and the run takes K4 and K15
    (their plain versions on the CPU) once per iteration, and no K5 or K3;
    an objective without the epilogue's and the fusion's hooks takes K1,
    K5 and K3 instead."""
    x = t_rosen.initial_point(N, device="cpu")
    S = torch.zeros((65, N), dtype=torch.float64)
    vag = t_rosen.value_and_grad
    assert t_factory.MAX_M == 64
    assert t_fused.can_pair_gram(x, S) and t_fused.can_combine(x, S)
    assert vag.__lbfgs_trial_pair_gram_ok__(x, S)
    assert vag.__lbfgs_combine_probe_ok__(x, S)
    k = vag.kernels

    def calls():
        return dict(trial=k.trial_ref.calls, tpg=k.trial_pair_gram_ref.calls,
                    k5=t_fused.pair_gram_sd_ref.calls, k3=t_fused.combine_ref.calls,
                    cp=k.combine_probe_ref.calls)

    before = calls()
    r = _run("plain", 65, "port")
    # one pair update and one combine per iteration after the first
    iters, after = r.niter - 1, calls()
    assert after["tpg"] - before["tpg"] == iters
    assert after["cp"] - before["cp"] == iters
    assert (after["k5"], after["k3"]) == (before["k5"], before["k3"])
    before = after
    r = _run("plain", 65, "port", _objective(EPILOGUE_AND_FUSION))
    iters, after = r.niter - 1, calls()
    assert (after["tpg"], after["cp"]) == (before["tpg"], before["cp"])
    assert after["k5"] - before["k5"] == iters
    assert after["k3"] - before["k3"] == iters
    assert after["trial"] - before["trial"] >= iters


@pytest.fixture(scope="module")
def jax_states():
    params = JParams(m=65, constrain_step_size=False)
    pdef = JDef(value_and_grad=j_rosen.value_and_grad)
    step = jax.jit(lambda st: jsol.propagate_hot(pdef, params, st))
    st = jsol.start_state(jsol.init_state(pdef, params, j_rosen.initial_point(N)), params)
    states = [jax.tree.map(np.asarray, st)]
    for _ in range(ITERS):
        st = step(st)
        states.append(jax.tree.map(np.asarray, st))
    return states


def _close(t, j, what):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    j = np.asarray(j, np.float64).reshape(t.shape)
    scale = max(np.abs(j).max(), 1e-300)
    np.testing.assert_allclose(t, j, rtol=REL, atol=REL * scale, err_msg=what)


@pytest.mark.parametrize("k", range(1, ITERS + 1))
def test_deep_history_step_matches_jax(jax_states, k):
    """One port step at m = 65 (K4 and K15's plain versions) from the JAX
    package's state of iteration k - 1, against its next state."""
    pdef = TDef(value_and_grad=t_rosen.value_and_grad)
    st = interop.state_from_jax(jax_states[k - 1], "cpu")
    out = tsol.propagate_hot(pdef, TParams(m=65, constrain_step_size=False), st)
    ref = jax_states[k]
    assert out.status == int(ref.status) == 0
    assert (out.k, out.end, out.prob.neval) == (int(ref.k), int(ref.end), int(ref.prob.neval))
    for name in ("x", "gx", "d"):
        _close(getattr(out.prob, name), getattr(ref.prob, name), name)
    for name in ("fx", "gnorm2", "xnorm2"):
        _close(getattr(out.prob, name), getattr(ref.prob, name), name)
    for name in ("s", "y", "ys", "alpha", "sy", "yy"):
        _close(getattr(out.hist, name), getattr(ref.hist, name), name)


@pytest.mark.parametrize("m", [64, 65, 130])
def test_deep_history_kernels_plain_versions(m):
    """K3, K6, K13, K5 and K12's wrappers take any depth on the CPU (their
    plain versions), with the ring rows they write."""
    rng = np.random.default_rng(m)
    n = 300
    v = lambda: torch.from_numpy(rng.standard_normal(n))
    d, gx, gp, x, xp, pg = (v() for _ in range(6))
    S = torch.from_numpy(rng.standard_normal((m, n)))
    Y = torch.from_numpy(rng.standard_normal((m, n)))
    cs, cy = (torch.from_numpy(rng.standard_normal(m)) for _ in range(2))
    gamma = torch.tensor(0.7, dtype=torch.float64)
    r, rr, rd = t_fused.combine(d, S, Y, gamma, cs, cy)
    want = gamma * d + cs @ S + cy @ Y
    torch.testing.assert_close(r, want, rtol=1e-12, atol=1e-12)
    Yf = Y.clone()
    rf = t_fused.combine_fix(d, S, Yf, gamma, cs, cy, m - 1, gamma, gamma)[0]
    assert torch.equal(rf, r)
    assert torch.equal(Yf[m - 1], gamma * Y[m - 1] + gamma * d)
    rc = t_fused.combine_ow(pg, S, Y, gamma, cs, cy, 0, n)[0]
    assert rc.shape == (n,)
    S5, Y5 = S.clone(), Y.clone()
    SP, YP = t_fused.pair_gram_sd(0.37, d, gx, gp, S5, Y5, m - 1, with_gp=True)
    assert SP.shape == YP.shape == (m, 4)
    assert torch.equal(S5[m - 1], 0.37 * d) and torch.equal(Y5[m - 1], gx - gp)
    S12, Y12 = S.clone(), Y.clone()
    SP, YP = t_fused.pair_gram_xg(x, xp, gx, gp, pg, S12, Y12, 0)
    assert SP.shape == YP.shape == (m, 3)
    assert torch.equal(S12[0], x - xp)
    S12, Y12 = S.clone(), Y.clone()
    SPg, YPg, gpgp, gppg = t_fused.pair_gram_xg(x, xp, gx, gp, pg, S12, Y12, 0, with_gp=True)
    assert SPg.shape == YPg.shape == (m, 4)
    assert torch.equal(SPg[:, :3], SP) and torch.equal(YPg[:, :3], YP)
    assert torch.equal(SPg[1:, 3], S[1:] @ gp) and torch.equal(YPg[0, 3], (gx - gp) @ gp)
    assert torch.equal(gpgp, gp @ gp) and torch.equal(gppg, gp @ pg)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.bfloat16),
                                    (torch.float32, torch.float32),
                                    (torch.float64, torch.float64)], ids=str)
@pytest.mark.parametrize("m", [65, 80, 130])
def test_deep_history_kernels_on_card(cuda, dtypes, m):
    """K3, K6, K13, K5 and K12 (both forms each) at m > 64 against their plain
    versions on the card at a ragged n: ring rows and K6's fixed row bit
    for bit, the direction normwise 1e-5 (1e-12 in float64), the sums
    1e-4 (1e-10)."""
    vd, hd = dtypes
    n, end = 100_006, m - 3
    tv, ts = (1e-5, 1e-4) if vd == torch.float32 else (1e-12, 1e-10)
    g = torch.Generator(device="cuda").manual_seed(m)
    r = lambda *s, dt=vd: torch.randn(*s, generator=g, device="cuda",
                                      dtype=torch.float64).to(dt)
    d, gx, gp, xp, pg = 0.1 * r(n), r(n), r(n), r(n), r(n)
    S0, Y0 = r(m, n, dt=hd), r(m, n, dt=hd)
    gamma, cs, cy = torch.tensor(0.8, dtype=vd, device="cuda"), r(m), r(m)
    ca, cb = torch.tensor(0.7, dtype=vd, device="cuda"), torch.tensor(-0.2, dtype=vd,
                                                                      device="cuda")

    def near(a, b, tol):
        a, b = a.double().cpu(), b.double().cpu()
        assert float((a - b).abs().max()) <= tol * max(float(b.abs().max()), 1e-300)

    def same(a, b):
        return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))

    k, p = t_fused.combine(gp, S0, Y0, gamma, cs, cy), t_fused.combine_ref(gp, S0, Y0, gamma,
                                                                          cs, cy)
    near(k[0], p[0], tv)
    near(k[1], p[1], ts), near(k[2], p[2], ts)
    Yk, Yp = Y0.clone(), Y0.clone()
    k6 = t_fused.combine_fix(gp, S0, Yk, gamma, cs, cy, end, ca, cb)
    t_fused.combine_fix_ref(gp, S0, Yp, gamma, cs, cy, end, ca, cb)
    assert same(Yk, Yp) and same(k6[0], k[0])
    k = t_fused.combine_ow(pg, S0, Y0, gamma, cs, cy, 5, n - 9)
    p = t_fused.combine_ow_ref(pg, S0, Y0, gamma, cs, cy, 5, n - 9)
    near(k[0], p[0], tv)
    for i in (1, 2, 3):
        near(k[i], p[i], ts)
    for with_gp in (False, True):
        Sk, Yk, Sp, Yp = S0.clone(), Y0.clone(), S0.clone(), Y0.clone()
        k = t_fused.pair_gram_sd(0.37, d, gx, gp, Sk, Yk, end, with_gp=with_gp)
        p = t_fused.pair_gram_sd_ref(0.37, d, gx, gp, Sp, Yp, end, with_gp=with_gp)
        assert same(Sk, Sp) and same(Yk, Yp)
        near(k[0], p[0], ts), near(k[1], p[1], ts)
    x = xp + d
    base = None
    for with_gp in (False, True):
        Sk, Yk, Sp, Yp = S0.clone(), Y0.clone(), S0.clone(), Y0.clone()
        k = t_fused.pair_gram_xg(x, xp, gx, gp, pg, Sk, Yk, end, with_gp=with_gp)
        p = t_fused.pair_gram_xg_ref(x, xp, gx, gp, pg, Sp, Yp, end, with_gp=with_gp)
        assert same(Sk, Sp) and same(Yk, Yp)
        for i in range(len(p)):
            near(k[i], p[i], ts)
        if with_gp:
            # the 3-column launch's columns, bit for bit
            assert same(k[0][:, :3], base[0]) and same(k[1][:, :3], base[1])
        base = k


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 6, 33, 64])
def test_fusion_direction_is_the_combines_at_every_depth_on_card(cuda, m):
    """K15's r is K3's, K15-fix's r and row K6's, K16's rc K13's, bit for
    bit, at depths up to the Triton kernels' 64 rows."""
    n = 100_006
    g = torch.Generator(device="cuda").manual_seed(m)
    r = lambda *s, dt=torch.float32: torch.randn(*s, generator=g, device="cuda").to(dt)
    gp, x, pg = r(n), r(n), r(n)
    S0, Y0 = r(m, n, dt=torch.bfloat16), r(m, n, dt=torch.bfloat16)
    gamma, cs, cy = torch.tensor(0.8, device="cuda"), r(m), r(m)
    ca, cb = torch.tensor(0.7, device="cuda"), torch.tensor(-0.2, device="cuda")
    same = lambda a, b: torch.equal(a.contiguous().view(torch.uint8),
                                    b.contiguous().view(torch.uint8))
    assert same(t_rosen.combine_probe(gp, x, S0, Y0, gamma, cs, cy, 1.0)[0],
                t_fused.combine(gp, S0, Y0, gamma, cs, cy)[0])
    Yk, Y6 = Y0.clone(), Y0.clone()
    k = t_rosen.combine_probe(gp, x, S0, Yk, gamma, cs, cy, 1.0, fix=(m - 1, ca, cb))
    k6 = t_fused.combine_fix(gp, S0, Y6, gamma, cs, cy, m - 1, ca, cb)
    assert same(k[0], k6[0]) and same(Yk, Y6)
    assert same(t_rosen.combine_ow_probe(pg, x, S0, Y0, gamma, cs, cy, 0.7, 0, n, 1.0)[0],
                t_fused.combine_ow(pg, S0, Y0, gamma, cs, cy, 0, n)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.bfloat16),
                                    (torch.float64, torch.float64)], ids=str)
def test_combines_past_48kb_of_coefficients_on_card(cuda, dtypes):
    """K3, K6 and K13 at m = 7000, whose 2m + 3 coefficients pass the
    default 48 KB of shared memory in float64 (the launch raises the
    kernel's limit), against their plain versions at a small ragged n."""
    vd, hd = dtypes
    m, n, end = 7000, 1030, 6998
    tv, ts = (1e-5, 1e-4) if vd == torch.float32 else (1e-12, 1e-10)
    g = torch.Generator(device="cuda").manual_seed(m)
    r = lambda *s, dt=vd: torch.randn(*s, generator=g, device="cuda",
                                      dtype=torch.float64).to(dt)
    gp, pg = r(n), r(n)
    S0, Y0 = r(m, n, dt=hd), r(m, n, dt=hd)
    gamma, cs, cy = torch.tensor(0.8, dtype=vd, device="cuda"), r(m), r(m)
    ca, cb = (torch.tensor(v, dtype=vd, device="cuda") for v in (0.7, -0.2))

    def near(a, b, tol):
        a, b = a.double().cpu(), b.double().cpu()
        assert float((a - b).abs().max()) <= tol * max(float(b.abs().max()), 1e-300)

    k, p = t_fused.combine(gp, S0, Y0, gamma, cs, cy), t_fused.combine_ref(gp, S0, Y0, gamma,
                                                                          cs, cy)
    near(k[0], p[0], tv)
    near(k[1], p[1], ts), near(k[2], p[2], ts)
    Yk, Yp = Y0.clone(), Y0.clone()
    k = t_fused.combine_fix(gp, S0, Yk, gamma, cs, cy, end, ca, cb)
    p = t_fused.combine_fix_ref(gp, S0, Yp, gamma, cs, cy, end, ca, cb)
    assert torch.equal(Yk.view(torch.uint8), Yp.view(torch.uint8))
    near(k[0], p[0], tv)
    k = t_fused.combine_ow(pg, S0, Y0, gamma, cs, cy, 3, n - 5)
    p = t_fused.combine_ow_ref(pg, S0, Y0, gamma, cs, cy, 3, n - 5)
    near(k[0], p[0], tv)
    for i in (1, 2, 3):
        near(k[i], p[i], ts)
