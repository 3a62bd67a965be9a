"""The port's speculative K-way backtracking search against ``lbfgs_tpu``
(the counterpart of ``tests/test_speculative.py``, case for case), on the
CPU in float64.

The Armijo-only ladder's candidate steps stp*0.5^j are known before any
is evaluated, so each round evaluates K of them in one candidate pass (the
plain K2 s, a loop of ``probe_ref``, on a factory objective; a
``torch.func.vmap`` pass on a generic one) and reads them once.  Held:

- the port's ``backtracking_speculative`` against the JAX package's on the
  same inputs (the quadratic 0.5 ||x||^2 from x = 1): status, ncall,
  neval, step and step_eval equal, x, fx and gx within 1e-12; and against
  the port's sequential ``backtracking``: the same, x bit for bit;
- whole runs against the port's sequential runs: the same iterations and
  evaluations, x bit for bit on a factory objective and within 1e-12 on a
  generic one, through both entry points; against the JAX package's
  speculative run, fx and x after each of the first 15 iterations (rel
  1e-9); the OWL-QN golden 43.5025 under K = 4; ``minimize_jit`` against
  ``minimize``; fx from the one materialization, not the candidates, on
  a generic objective; under OWL-QN on the windows [0, n) and [0, n - 1)
  in float32, the sequential run's status (a vanishing constrained
  direction on [0, n) with the step capped);
- the refusals ``lbfgs_tpu`` makes (More-Thuente, the Wolfe ladders,
  gradient_only, a mutating closure, ``materialize=False``), as
  ``ValueError``;
- the K-lane probes' plain versions per lane against ``probe_ref`` and
  ``owlqn_probe_ref`` bit for bit, with the quadratic's extras and in
  both modes of the objective scalar; a ladder of t trials reads ceil(t/K)
  times; the one-pass epilogue off (K1 and K5, K7 and K12 instead);
- two gloo ranks (``tests/_torch_mesh_ranks.py``): the ranks alike bit
  for bit, and world size 1 the run with no mesh bit for bit.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import _torch_mesh_ranks as ranks
import lbfgs_torch
from lbfgs_torch import linesearch as tls
from lbfgs_torch.core import ProblemDef as TDef
from lbfgs_torch.core import to_host
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.models import separable
from lbfgs_torch.ops import factory, fused
from lbfgs_torch.orthantwise import Orthantwise, choose_orthant
from lbfgs_torch.params import LineSearchParams as TLS
from lbfgs_torch.status import Status
from lbfgs_tpu import lbfgs as j_lbfgs
from lbfgs_tpu.core import ProblemDef as JDef
from lbfgs_tpu.linesearch import backtracking_speculative as j_spec
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.params import LineSearchParams as JLS

TOL = 1e-12


@pytest.fixture(autouse=True)
def _quiet():
    # the ascent warnings of the exhaustion cases and the Armijo runs
    logger = logging.getLogger("lbfgs_torch")
    level = logger.level
    logger.setLevel(logging.ERROR)
    yield
    logger.setLevel(level)


def _t_vag(x):
    return 0.5 * torch.sum(x * x), x


_t_vag.__lbfgs_value_and_grad__ = True


def _j_vag(x):
    return 0.5 * jnp.sum(x ** 2), x


_j_vag.__lbfgs_value_and_grad__ = True

#: the port's quadratic 0.5 ||x||^2: generic (vmapped candidates) or a
#: factory objective (the plain K2 s)
OBJECTIVES = {"generic": lambda: _t_vag, "factory": separable.sphere}


def _run(obj: str, n: int, d_sign: float, stp0: float, K: int, **kw):
    """The port's speculative and sequential searches and the JAX
    package's speculative search from x = 1 along d = d_sign * x."""
    vag = OBJECTIVES[obj]()
    xp = torch.ones(n, dtype=torch.float64)
    d = d_sign * xp
    fx, g = _t_vag(xp)
    finit, dginit = np.float64(fx), np.float64(torch.dot(g, d))
    ls = TLS(algorithm="BacktrackingArmijo", speculative=K, **kw)
    pdef = TDef(value_and_grad=vag)
    spec = tls.backtracking_speculative(pdef, ls, xp, finit, g, d, np.float64(stp0), dginit, 1)
    seq = tls.backtracking(pdef, ls, xp, finit, g, d, np.float64(stp0), dginit, 1)
    jx = jnp.ones(n)
    jfx, jg = _j_vag(jx)
    jspec = j_spec(JDef(value_and_grad=_j_vag), JLS(algorithm="BacktrackingArmijo",
                                                     speculative=K, **kw),
                   jx, jfx, jg, d_sign * jx, jnp.float64(stp0), jnp.dot(jg, d_sign * jx),
                   jnp.int32(1), jx)
    return spec, seq, jspec


def _held(spec, seq, jspec) -> None:
    for name in ("status", "ncall", "neval"):
        assert int(getattr(spec, name)) == int(getattr(jspec, name)) == int(getattr(seq, name)), \
            name
    for name in ("step", "step_eval"):
        assert float(getattr(spec, name)) == float(getattr(jspec, name)) \
            == float(getattr(seq, name)), name
    for got, want in ((spec.x, jspec.x), (spec.gx, jspec.gx)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert float(spec.fx) == pytest.approx(float(jspec.fx), rel=TOL, abs=TOL)
    assert torch.equal(spec.x, seq.x) and float(spec.fx) == float(seq.fx)


@pytest.mark.parametrize("obj", list(OBJECTIVES))
@pytest.mark.parametrize("K", [2, 3, 4, 8])
@pytest.mark.parametrize("stp0", [1.0, 8.0, 64.0])
def test_matches_jax_on_quadratic(obj, K, stp0):
    """Deep ladders cross round boundaries: stp0 = 64 needs ~7 halvings."""
    spec, seq, jspec = _run(obj, 5, -1.0, stp0, K)
    assert int(seq.status) == 0 and int(seq.ncall) >= 1
    _held(spec, seq, jspec)


@pytest.mark.parametrize("obj", list(OBJECTIVES))
@pytest.mark.parametrize("K", [2, 5])
def test_matches_jax_on_exhaustion(obj, K):
    """An ascent direction: Armijo never passes; ncall = max_linesearch and
    the reported step the never evaluated next one (src/line.rs:777)."""
    spec, seq, jspec = _run(obj, 3, 1.0, 1.0, K, max_linesearch=6)
    assert int(seq.ncall) == 6 and float(spec.step) == float(spec.step_eval) / 2
    _held(spec, seq, jspec)


@pytest.mark.parametrize("obj", list(OBJECTIVES))
def test_matches_jax_on_min_step_error(obj):
    spec, seq, jspec = _run(obj, 3, 1.0, 0.5, 3, min_step=1.0)
    assert int(seq.status) == Status.LS_MIN_STEP
    _held(spec, seq, jspec)


@pytest.mark.parametrize("obj", list(OBJECTIVES))
def test_matches_jax_on_max_step_error(obj):
    spec, seq, jspec = _run(obj, 3, 1.0, 8.0, 4, max_step=4.0)
    assert int(seq.status) == Status.LS_MAX_STEP
    _held(spec, seq, jspec)


@pytest.mark.parametrize("obj", list(OBJECTIVES))
def test_zero_trial_parity(obj):
    """max_linesearch = 1: no trial; the entry point, result max_linesearch."""
    spec, _, jspec = _run(obj, 3, -1.0, 1.0, 4, max_linesearch=1)
    for name in ("status", "ncall", "neval"):
        assert int(getattr(spec, name)) == int(getattr(jspec, name)), name
    assert float(spec.step) == float(jspec.step) and float(spec.step_eval) == 0.0
    assert torch.equal(spec.x, torch.ones(3, dtype=torch.float64))


@pytest.mark.parametrize("K", [2, 3, 8])
def test_reads_once_per_round(K):
    """A ladder of t trials: ceil(t/K) candidate passes and reads (t = 7
    from stp0 = 64), then one materialization."""
    obj = separable.sphere()
    k = obj.kernels
    xp = torch.ones(5, dtype=torch.float64)
    fx, g = _t_vag(xp)
    k.probe_steps_ref.calls = k.trial_ref.calls = 0
    to_host.reads = 0
    spec = tls.backtracking_speculative(
        TDef(value_and_grad=obj), TLS(algorithm="BacktrackingArmijo", speculative=K), xp,
        np.float64(fx), g, -xp, np.float64(64.0), np.float64(-5.0), 1)
    assert int(spec.ncall) == 7 and spec.neval == 8
    assert to_host.reads == k.probe_steps_ref.calls == -(-7 // K)
    assert k.trial_ref.calls == 1


def test_lane_chunks():
    """Above ``SPEC_MAX_LANES`` a K-lane probe launches in chunks."""
    assert factory.spec_chunks(11) == [(0, factory.SPEC_MAX_LANES), (8, 3)]
    assert factory.spec_chunks(4) == [(0, 4)]


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

#: the factory Rosenbrock (its K2 s / K8 s plain versions) and the
#: hook-free one (vmapped candidates)
RUN_OBJECTIVES = {"factory": t_rosen.value_and_grad, "generic": t_rosen._plain_value_and_grad}
ENTRIES = ["minimize", "minimize_jit"]


def _same_run(a, b, obj) -> None:
    assert (a.niter, a.neval, a.status) == (b.niter, b.neval, b.status)
    if obj == "factory":
        assert torch.equal(a.x, b.x) and a.fx == b.fx
    else:
        np.testing.assert_allclose(a.x.numpy(), b.x.numpy(), rtol=TOL, atol=TOL)
        assert a.fx == pytest.approx(b.fx, rel=TOL, abs=TOL)


@pytest.mark.parametrize("obj", list(RUN_OBJECTIVES))
@pytest.mark.parametrize("entry", ENTRIES)
def test_armijo_run_matches_sequential(obj, entry):
    """The eval-hungry Armijo ladder, 20-dim, 60 iterations, K = 4."""
    x0 = t_rosen.initial_point(20, device="cpu")
    base = (lbfgs_torch.lbfgs().with_linesearch_algorithm("BacktrackingArmijo")
            .with_max_iterations(60))
    fn = RUN_OBJECTIVES[obj]
    seq = getattr(base, entry)(x0, fn)
    spec = getattr(base.with_speculative_linesearch(4), entry)(x0, fn)
    assert seq.niter == 60 and seq.neval > 3 * seq.niter
    _same_run(spec, seq, obj)


@pytest.mark.parametrize("obj", list(RUN_OBJECTIVES))
@pytest.mark.parametrize("entry", ENTRIES)
def test_owlqn_run_matches_sequential(obj, entry):
    """OWL-QN always takes the Armijo-only ladder: 40-dim, 80 iterations,
    K = 3."""
    x0 = t_rosen.initial_point(40, device="cpu")
    base = lbfgs_torch.lbfgs().with_orthantwise(1.0, 0, 39).with_max_iterations(80)
    fn = RUN_OBJECTIVES[obj]
    seq = getattr(base, entry)(x0, fn)
    spec = getattr(base.with_speculative_linesearch(3), entry)(x0, fn)
    _same_run(spec, seq, obj)


def _trace(builder, x0, fn):
    """(fx, x) after each iteration of the host loop."""
    out = []

    def progress(p):
        out.append((float(p.fx), np.asarray(p.x, dtype=np.float64).copy()))
        return False

    builder.minimize(x0, fn, progress)
    return out


SETTINGS = {
    "armijo": lambda b: b.with_linesearch_algorithm("BacktrackingArmijo"),
    "owlqn": lambda b: b.with_orthantwise(1.0, 0, 39),
}


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("obj", list(RUN_OBJECTIVES))
def test_run_matches_jax_pointwise(setting, obj):
    """The first 15 iterations against the JAX package's speculative run
    (K = 4): fx and x after each, rel 1e-9."""
    n = 40
    t = _trace(SETTINGS[setting](lbfgs_torch.lbfgs()).with_speculative_linesearch(4)
               .with_max_iterations(15), t_rosen.initial_point(n, device="cpu"),
               RUN_OBJECTIVES[obj])
    j = _trace(SETTINGS[setting](j_lbfgs()).with_speculative_linesearch(4)
               .with_max_iterations(15), j_rosen.initial_point(n), j_rosen.value_and_grad)
    assert len(t) == len(j) >= 15
    for (tf, tx), (jf, jx) in zip(t, j):
        assert tf == pytest.approx(jf, rel=1e-9)
        np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-9 * np.abs(jx).max())


@pytest.mark.parametrize("obj", list(RUN_OBJECTIVES))
def test_owlqn_golden_with_speculation(obj):
    """The reference golden (tests/simple.rs:42-54) under K = 4."""
    fn = RUN_OBJECTIVES[obj]
    x0 = t_rosen.initial_point(100, device="cpu")
    rep1 = lbfgs_torch.lbfgs().minimize(x0, fn)
    rep = (lbfgs_torch.lbfgs().with_orthantwise(1.0, 0, 99).with_speculative_linesearch(4)
           .minimize(rep1.x, fn))
    assert rep.fx == pytest.approx(43.5025, abs=1e-4 * 43.5025)
    assert float(rep.x[0]) == pytest.approx(0.25, abs=1e-4)
    assert float(rep.x[1]) == pytest.approx(0.0575, abs=1e-4)


@pytest.mark.parametrize("obj", list(RUN_OBJECTIVES))
def test_jit_driver_matches_host_driver(obj):
    x0 = t_rosen.initial_point(20, device="cpu")
    b = (lbfgs_torch.lbfgs().with_linesearch_algorithm("BacktrackingArmijo")
         .with_speculative_linesearch(4).with_max_iterations(40))
    r_host = b.minimize(x0, RUN_OBJECTIVES[obj])
    r_jit = b.minimize_jit(x0, RUN_OBJECTIVES[obj])
    assert r_jit.niter == r_host.niter and r_jit.fx == r_host.fx


def test_wide_scalar_matches_sequential():
    """float32 vectors under the wide objective scalar: fx float64, the
    sequential wide run's iterations, evaluations and x bit for bit."""
    x0 = t_rosen.initial_point(100, torch.float32, device="cpu")
    base = (lbfgs_torch.lbfgs().with_fx_wide().with_linesearch_algorithm("BacktrackingArmijo")
            .with_max_iterations(30))
    seq = base.minimize_jit(x0, t_rosen.value_and_grad)
    spec = base.with_speculative_linesearch(4).minimize_jit(x0, t_rosen.value_and_grad)
    assert type(spec.fx) is np.float64 and spec.x.dtype == torch.float32
    _same_run(spec, seq, "factory")


@pytest.mark.parametrize("uncapped", [False, True])
def test_epilogue_off_and_carried_probe_unused(uncapped):
    """Under speculation the one-pass epilogue does not run: each iteration
    materializes with K1 and takes K5 (OWL-QN: K7 and K12); uncapped, the
    combine+probe fusion still runs and its carried probe goes unused."""
    obj = t_rosen.value_and_grad
    k = obj.kernels
    for name in ("trial_ref", "trial_pair_gram_ref", "probe_ref", "probe_steps_ref",
                 "combine_probe_ref"):
        getattr(k, name).calls = 0
    fused.pair_gram_sd_ref.calls = 0
    tls.carried.ignored = 0
    b = (lbfgs_torch.lbfgs().with_linesearch_algorithm("BacktrackingArmijo")
         .with_speculative_linesearch(4).with_max_iterations(20)
         .with_constrain_step_size(not uncapped))
    rep = b.minimize_jit(t_rosen.initial_point(100, device="cpu"), obj)
    # the init's K1, then one search and one pair + Gram pass an iteration
    iters = rep.niter - 1
    assert rep.status == Status.MAX_ITERATIONS
    assert k.trial_pair_gram_ref.calls == 0 and k.probe_ref.calls == 0
    assert k.trial_ref.calls == iters + 1 and fused.pair_gram_sd_ref.calls == iters
    assert k.probe_steps_ref.calls >= iters
    assert k.combine_probe_ref.calls == (iters if uncapped else 0)
    # every search after the first had a live carried probe at its step
    assert tls.carried.ignored == (iters - 1 if uncapped else 0)
    ow = b.with_orthantwise(1.0, 0, None)
    k.owlqn_trial_ref.calls = k.owlqn_trial_pair_gram_ref.calls = 0
    fused.pair_gram_xg_ref.calls = 0
    rep = ow.minimize_jit(t_rosen.initial_point(100, device="cpu"), obj)
    assert k.owlqn_trial_pair_gram_ref.calls == 0
    assert k.owlqn_trial_ref.calls == fused.pair_gram_xg_ref.calls == rep.niter - 1


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("owlqn", [False, True])
def test_fx_from_the_materialized_point(owlqn):
    """On a generic objective fx, x and gx come from the one
    materialization at the accepted step, as the JAX package's ``_finish``
    takes them: an fx-only form 1e-9 above the objective, which the
    candidates are evaluated with, does not reach the result."""
    def vag(x):
        return t_rosen._plain_value_and_grad(x)

    vag.__lbfgs_value_and_grad__ = True
    vag.__lbfgs_value__ = lambda x: t_rosen._plain_value_and_grad(x)[0] + 1e-9
    b = (lbfgs_torch.lbfgs().with_linesearch_algorithm("BacktrackingArmijo")
         .with_max_iterations(6).with_speculative_linesearch(4))
    if owlqn:
        b = b.with_orthantwise(1.0, 0, None)
    st = b.minimize_jit(t_rosen.initial_point(16, device="cpu"), vag, return_state=True)
    want = t_rosen._plain_value_and_grad(st.prob.x)[0]
    if owlqn:
        want = want + torch.sum(torch.abs(st.prob.x))
    assert type(st.prob.fx) is np.float64 and st.prob.fx == float(want)


@pytest.mark.parametrize("capped", [True, False])
@pytest.mark.parametrize("end", ["whole", "but_last"])
def test_owlqn_window_status_on_cpu(end, capped):
    """The card test's runs in float32 with the plain kernels: under OWL-QN
    on the window [0, n) or [0, n - 1) the speculative run is the
    sequential run on its route bit for bit, its status included, and ends
    as the sequential run with the epilogue; on [0, n) with the step
    capped all three end on a vanishing constrained direction."""
    fn = t_rosen.value_and_grad
    bare = lambda x: fn(x)  # noqa: E731
    bare.__dict__.update({key: v for key, v in fn.__dict__.items()
                          if "trial_pair_gram" not in key})
    n = 1 << 14
    b = (lbfgs_torch.lbfgs().with_linesearch_algorithm("BacktrackingArmijo")
         .with_history_dtype("bfloat16").with_max_iterations(25)
         .with_constrain_step_size(capped)
         .with_orthantwise(1.0, 0, n if end == "whole" else n - 1))
    x0 = t_rosen.initial_point(n, torch.float32, "cpu")
    spec = b.with_speculative_linesearch(4).minimize_jit(x0, fn, return_state=True)
    seq = b.minimize_jit(x0, bare, return_state=True)
    epi = b.minimize_jit(x0, fn, return_state=True)
    assert (spec.k, spec.prob.neval, spec.status) == (seq.k, seq.prob.neval, seq.status)
    assert spec.prob.fx == seq.prob.fx and torch.equal(spec.prob.x, seq.prob.x)
    assert epi.status == spec.status
    if end == "whole" and capped:
        assert spec.status == Status.ERR_OWLQN_ZERO_DIRECTION


@pytest.mark.parametrize("builder", [
    lambda b: b,  # More-Thuente
    lambda b: b.with_linesearch_algorithm("BacktrackingWolfe"),
    lambda b: b.with_linesearch_algorithm("BacktrackingStrongWolfe"),
    lambda b: b.with_gradient_only(),
], ids=["more_thuente", "wolfe", "strong_wolfe", "gradient_only"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_rejects_non_armijo_ladders(builder, entry):
    b = builder(lbfgs_torch.lbfgs()).with_speculative_linesearch(4)
    with pytest.raises(ValueError):
        getattr(b, entry)(t_rosen.initial_point(10, device="cpu"), t_rosen.value_and_grad)


def test_rejects_mutating_closure():
    """``tests/test_round2_behaviors.py:212-224``'s counterpart."""
    def mut_closure(x, g):
        g.copy_(2.0 * x)
        return float(torch.dot(x, x))

    with pytest.raises(ValueError, match="traceable objective"):
        (lbfgs_torch.lbfgs().with_linesearch_algorithm("BacktrackingArmijo")
         .with_speculative_linesearch(4).minimize(torch.ones(4, dtype=torch.float64),
                                                  mut_closure))


@pytest.mark.parametrize("shape", ["scalar", "value_and_grad"])
def test_objective_shapes_run(shape):
    """A scalar objective's candidates are evaluated through fx alone under
    ``torch.func.vmap`` (its gradient by autograd only at the accepted
    point): both one-argument shapes run as their sequential runs."""
    def scalar(x):
        return t_rosen._plain_value_and_grad(x)[0]

    fn = {"scalar": scalar, "value_and_grad": t_rosen._plain_value_and_grad}[shape]
    x0 = t_rosen.initial_point(20, device="cpu")
    b = lbfgs_torch.lbfgs().with_linesearch_algorithm("BacktrackingArmijo").with_max_iterations(30)
    _same_run(b.with_speculative_linesearch(4).minimize(x0, fn), b.minimize(x0, fn), "generic")


def test_rejects_scalar_mode():
    x = t_rosen.initial_point(10, device="cpu")
    fx, g = t_rosen._plain_value_and_grad(x)
    ls = TLS(algorithm="BacktrackingArmijo", speculative=4)
    with pytest.raises(ValueError, match="materialize=False"):
        tls.find(TDef(t_rosen.value_and_grad), ls, x, np.float64(fx), g, -g, np.float64(0.1), 1,
                 materialize=False)


# ---------------------------------------------------------------------------
# the K-lane probes' plain versions
# ---------------------------------------------------------------------------


def _objective(name: str, n: int, dtype):
    if name == "rosenbrock":
        return t_rosen.value_and_grad.kernels
    g = torch.Generator().manual_seed(3)
    w = (0.5 + torch.rand(n, generator=g, dtype=torch.float64)).to(dtype)
    t = torch.randn(n, generator=g, dtype=torch.float64).to(dtype)
    return separable.quadratic(w, t).kernels


@pytest.mark.parametrize("model", ["rosenbrock", "quadratic"])
@pytest.mark.parametrize("dtype", ["float64", "float32", "float32_wide"])
def test_lane_probes_per_lane(model, dtype):
    """Each lane of K2 s and K8 s and of K2 b s and K8 b s (its orthant
    rebuilt from pg) equals the one-lane plain probe at its step bit for
    bit, at 1 to 11 lanes (past ``factory.SPEC_MAX_LANES``, where the card
    launches in chunks)."""
    vd = torch.float64 if dtype == "float64" else torch.float32
    n, c, lo, hi = 34, 0.7, 3, 30
    k = _objective(model, n, vd)
    g = torch.Generator().manual_seed(4)
    x = (1.0 + torch.randn(n, generator=g, dtype=torch.float64)).to(vd)
    x[::5] = 0.0
    d = (0.3 * torch.randn(n, generator=g, dtype=torch.float64)).to(vd)
    pg = torch.randn(n, generator=g, dtype=torch.float64).to(vd)
    wp = choose_orthant(Orthantwise(c, lo, hi), x, pg)
    f = np.float32 if vd == torch.float32 else np.float64
    assert factory.SPEC_MAX_LANES < 11
    for K in range(1, 12):
        steps = f(0.9) * f(0.5) ** np.arange(K).astype(f)
        with fused.wide_fx(dtype == "float32_wide"):
            fx = k.probe_steps(x, d, steps)
            fw = k.owlqn_probe_steps(x, d, wp, steps, c, lo, hi)
            assert fx.shape == fw.shape == (K,)
            for j, s in enumerate(steps):
                assert torch.equal(fx[j], k.probe_ref(x, d, s)[0])
                assert torch.equal(fw[j], k.owlqn_probe_ref(x, d, wp, s, c, lo, hi)[0])
            xb, db, pgb = x[None].repeat(3, 1), d[None].repeat(3, 1), pg[None].repeat(3, 1)
            xb[1] = xb[1] * 0.5
            live = torch.tensor([True, True, False])
            st = torch.from_numpy(np.stack([steps, steps * f(0.25), steps]))
            fb = k.probe_steps_batched(xb, db, st, live)
            fo = k.owlqn_probe_pg_steps_batched(xb, db, pgb, st, c, lo, hi, live)
            assert fb.shape == fo.shape == (3, K)
            for j in range(K):
                col = st[:, j].contiguous()
                assert torch.equal(fb[:2, j], k.probe_batched_ref(xb, db, col, live)[0][:2])
                assert torch.equal(
                    fo[:2, j], k.owlqn_probe_pg_batched_ref(xb, db, pgb, col, c, lo, hi, live)[0][:2])
        if dtype == "float32_wide":
            assert fx.dtype == fw.dtype == fb.dtype == fo.dtype == torch.float64


def test_lane_probes_refuse_bad_steps():
    k = t_rosen.value_and_grad.kernels
    x = torch.ones((2, 8), dtype=torch.float64)
    live = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="stps"):
        k.probe_steps_batched(x, x, torch.ones(2, 3, dtype=torch.float32), live)
    with pytest.raises(ValueError, match="stps"):
        k.probe_steps_batched(x, x, torch.ones(3, 3, dtype=torch.float64), live)


# ---------------------------------------------------------------------------
# on a mesh: two gloo ranks, and world size 1 against no mesh
# ---------------------------------------------------------------------------

MESH_N = 128
MESH_PATHS = {
    "armijo": dict(algorithm="BacktrackingArmijo", speculative=4, max_iterations=40),
    "armijo_k11": dict(algorithm="BacktrackingArmijo", speculative=11, max_iterations=30),
    "owlqn": dict(orthantwise=[1.0, 0, MESH_N - 1], algorithm="BacktrackingArmijo",
                  speculative=4, max_iterations=40),
}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The factory Rosenbrock's runs (``job_runs``) and the generic one's
    under the local contract (``job_generic``), float64, on 1 and 2 ranks."""
    out = {}
    for world in (1, 2):
        d = tmp_path_factory.mktemp(f"spec{world}")
        out[("factory", world)] = ranks.launch(
            "runs", world, d / "runs", dict(n=MESH_N, dtype="float64", paths=MESH_PATHS))
        out[("generic", world)] = ranks.launch(
            "generic", world, d / "generic",
            dict(n=MESH_N, poisson=[16, 32, 5], paths={"rosenbrock": MESH_PATHS}))
    return out


def _key(kind: str, name: str) -> str:
    return name if kind == "factory" else f"rosenbrock_{name}"


@pytest.mark.parametrize("kind", ["factory", "generic"])
@pytest.mark.parametrize("name", list(MESH_PATHS))
def test_mesh_world1_is_solo_bit_for_bit(mesh_runs, kind, name):
    (r,) = mesh_runs[(kind, 1)]
    got = r[_key(kind, name)]
    for field in ("k", "neval", "status", "fx_hex", "x_sha"):
        assert got[field] == got["solo"][field], field
    assert got["collectives"]["gathers"] == 0


@pytest.mark.parametrize("kind", ["factory", "generic"])
@pytest.mark.parametrize("name", list(MESH_PATHS))
def test_mesh_two_ranks_alike(mesh_runs, kind, name):
    r0, r1 = mesh_runs[(kind, 2)]
    a, b = r0[_key(kind, name)], r1[_key(kind, name)]
    for field in ("k", "neval", "status", "fx_hex", "x_sha"):
        assert a[field] == b[field], field
    (w1,) = mesh_runs[(kind, 1)]
    solo = w1[_key(kind, name)]["solo"]
    # the same ladder decisions as one process; fx only near it: the two
    # shards' partial sums reassociate, and 30-40 unconverged Rosenbrock
    # iterations carry that into the 7th digit
    assert (a["k"], a["neval"], a["status"]) == (solo["k"], solo["neval"], solo["status"])
    assert a["fx"] == pytest.approx(solo["fx"], rel=1e-5)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 14, (1 << 14) + 2, 1 << 20, 1 << 24])
@pytest.mark.parametrize("K", [3, 11])
@pytest.mark.parametrize("wide", [False, True])
def test_lane_kernels_on_card(cuda, n, K, wide):
    """K2 s and K8 s (11 lanes launch as 8 + 3) and
    K2 b s and K8 b s: each lane the one-lane kernel's fx at its step bit
    for bit, on the live instances of a batch, at 16 to 16384 programs
    (n = 2^14 to 2^24), in both modes of the objective scalar."""
    with fused.wide_fx(wide):
        _lane_kernels_on_card(n, K)


def _lane_kernels_on_card(n, K):
    cuda = torch.device("cuda")
    k = t_rosen.value_and_grad.kernels
    g = torch.Generator(device=cuda).manual_seed(n + K)
    x = t_rosen.initial_point(n, torch.float32, "cuda") + 0.1 * torch.randn(
        n, generator=g, device=cuda)
    x[::7] = 0.0
    d = 0.1 * torch.randn(n, generator=g, device=cuda)
    pg = torch.randn(n, generator=g, device=cuda)
    c, lo, hi = 0.7, 3, n - 5
    wp = choose_orthant(Orthantwise(c, lo, hi), x, pg)
    steps = np.float32(0.9) * np.float32(0.5) ** np.arange(K).astype(np.float32)
    f2 = k.probe_steps(x, d, steps)
    fw = k.owlqn_probe_steps(x, d, wp, steps, c, lo, hi)
    for j, s in enumerate(steps):
        assert torch.equal(f2[j], k.probe(x, d, s)[0])
        assert torch.equal(fw[j], k.owlqn_probe(x, d, wp, s, c, lo, hi)[0])
    if n % 16:
        return
    B = 6
    xb = x[None].repeat(B, 1) + 0.01 * torch.randn(B, n, generator=g, device=cuda)
    db, pgb = d[None].repeat(B, 1), pg[None].repeat(B, 1)
    live = torch.tensor([True, False, True, True, False, True], device=cuda)
    st = (0.2 + torch.rand(B, 1, generator=g, device=cuda)) * 0.5 ** torch.arange(
        K, device=cuda)
    fb = k.probe_steps_batched(xb, db, st, live)
    fo = k.owlqn_probe_pg_steps_batched(xb, db, pgb, st, c, lo, hi, live)
    for j in range(K):
        col = st[:, j].contiguous()
        assert torch.equal(fb[live, j], k.probe_batched(xb, db, col, live)[0][live])
        assert torch.equal(fo[live, j],
                           k.owlqn_probe_pg_batched(xb, db, pgb, col, c, lo, hi, live)[0][live])


@pytest.mark.cuda
@pytest.mark.parametrize("capped", [True, False])
@pytest.mark.parametrize("window", [None, "whole", "but_last"])
def test_speculative_run_on_card(cuda, window, capped):
    """A run through K2 s (K8 s under OWL-QN, on the window [0, n) or, as
    the OWL-QN main path, [0, n - 1)) on the card is the sequential run on
    its route (the objective without the one-pass epilogue) bit for bit,
    its status included (``test_owlqn_window_status_on_cpu``: on [0, n)
    with the step capped both end on a vanishing constrained direction)."""
    fn = t_rosen.value_and_grad
    bare = lambda x: fn(x)  # noqa: E731
    bare.__dict__.update({key: v for key, v in fn.__dict__.items()
                          if "trial_pair_gram" not in key})
    n = 1 << 14
    owlqn = window is not None
    b = (lbfgs_torch.lbfgs().with_linesearch_algorithm("BacktrackingArmijo")
         .with_history_dtype("bfloat16").with_max_iterations(25)
         .with_constrain_step_size(capped))
    if owlqn:
        b = b.with_orthantwise(1.0, 0, n if window == "whole" else n - 1)
    x0 = t_rosen.initial_point(n, torch.float32, "cuda")
    k = fn.kernels
    k.probe_steps.launches = k.owlqn_probe_steps.launches = 0
    spec = b.with_speculative_linesearch(4).minimize_jit(x0, fn, return_state=True)
    seq = b.minimize_jit(x0, bare, return_state=True)
    assert (k.owlqn_probe_steps if owlqn else k.probe_steps).launches >= spec.k - 1
    assert (spec.k, spec.prob.neval, spec.status) == (seq.k, seq.prob.neval, seq.status)
    assert spec.prob.fx == seq.prob.fx and torch.equal(spec.prob.x, seq.prob.x)
