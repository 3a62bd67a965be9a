"""The batched runner under the speculative K-way search, against
``lbfgs_tpu``'s batched speculative run and against the port's own solo
and sequential runs, on the CPU (the counterpart of
``tests/test_speculative.py::test_speculative_batched_matches_sequential_batched``).

Each round of ``_batched_search.backtracking_speculative`` is one K-lane
probe over the running instances (K2 b s, K8 b s; on a generic objective
one ``torch.func.vmap`` over the B*K candidate points) and one read, and
each instance selects its own first event.  Held:

- the vectorized search against the scalar ``linesearch.
  backtracking_speculative`` per instance, bit for bit, on seeded
  polynomial lines (successes, exhaustion, both step-bound errors, a
  frozen instance), and one read per round;
- 8 x 16 batches (plain Armijo and OWL-QN, factory and generic
  objectives) against the JAX package's batched speculative run at its
  own tolerances (fx rel 1e-10, x abs 1e-8), against the port's batched
  sequential run (the same iterations and evaluations, fx and x bit for
  bit on the factory objective, 1e-12 on the generic one), and each
  instance against its solo speculative run (the same iterations and
  evaluations, fx rel 1e-9); on a generic objective each accepted
  instance's fx from its materialized point, not its candidate;
- the route: the one-pass epilogue K4 b / K14 b off, K1 b / K7 b and
  K5 b / K12 b instead; uncapped, the fusion's carried probes unused;
  the wide objective scalar; the refusals ``lbfgs_tpu`` makes.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from lbfgs_torch import _batched_search as bs
from lbfgs_torch import lbfgs as t_lbfgs
from lbfgs_torch import linesearch as t_ls
from lbfgs_torch.core import ProblemDef, to_host
from lbfgs_torch.minimize import minimize_jit as t_minimize_jit
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.params import LineSearchParams as TLS
from lbfgs_torch.status import Status
from lbfgs_tpu import lbfgs as j_lbfgs
from lbfgs_tpu.models import rosenbrock as j_rosen


@pytest.fixture(autouse=True)
def _quiet():
    logger = logging.getLogger("lbfgs_torch")
    level = logger.level
    logger.setLevel(logging.ERROR)
    yield
    logger.setLevel(level)


# ---------------------------------------------------------------------------
# the vectorized search against the scalar one
# ---------------------------------------------------------------------------


class _Line:
    """phi(t) = c0 + c1 t + c2 t^2 + c3 t^4 per instance, by the same numpy
    operations on a scalar (the scalar search's lane) or a [B] array."""

    def __init__(self, rng, B, dtype):
        g = lambda: rng.randn(B).astype(dtype)
        self.c0, self.c2 = g(), g()
        self.c1 = -(np.abs(g()) + dtype(0.1))
        self.c3 = np.abs(g()) * dtype(0.1) + dtype(1e-3)

    def __call__(self, t, i=slice(None)):
        c0, c1, c2, c3 = self.c0[i], self.c1[i], self.c2[i], self.c3[i]
        return c0 + t * (c1 + t * (c2 + t * t * c3))


def _scalar_objective(line, i, dtype):
    """A stand-in whose K-lane probe is instance i's line, and whose trial
    gives the line's value at its step (the remat contract)."""
    tdtype = torch.float32 if dtype == np.float32 else torch.float64

    def vag(x):
        raise AssertionError("not evaluated")

    z = torch.zeros((), dtype=tdtype)
    vag.__lbfgs_trial__ = lambda xp, d, stp: (
        xp, torch.tensor(line(stp, i), dtype=tdtype), xp, z, z, z, torch.ones((), dtype=bool))
    vag.__lbfgs_probe_steps__ = lambda xp, d, steps: torch.tensor(
        np.array([line(s, i) for s in steps], dtype), dtype=tdtype)
    return vag


@pytest.mark.parametrize("K", [2, 3, 8])
@pytest.mark.parametrize("case", ["default", "short", "min_step", "max_step"])
def test_batched_search_matches_scalar(K, case):
    dtype = np.float32
    B = 120
    rng = np.random.RandomState(7 + K)
    line = _Line(rng, B, dtype)
    kw = {"default": {}, "short": dict(max_linesearch=2), "min_step": dict(min_step=2.0),
          "max_step": dict(max_step=0.5)}[case]
    ls = TLS(algorithm="BacktrackingArmijo", speculative=K, **kw)
    finit = line(np.zeros(B, dtype))
    dginit = line.c1.copy()
    stp0 = (rng.rand(B) * 6.0 + 0.01).astype(dtype)
    stp0[::13] = dtype(1.0)
    neval0 = np.arange(B, dtype=np.int64)
    live = rng.rand(B) < 0.9
    rounds = []

    def probe_steps(steps, run):
        rounds.append(int(run.sum()))
        return np.stack([line(steps[:, j]) for j in range(steps.shape[1])], axis=1)

    def probe(stp, run):
        raise AssertionError("the speculative search probes in rounds")

    got = bs.find(ls, live, finit, dginit, stp0, neval0, probe, probe_steps=probe_steps)
    xp = torch.zeros(1, dtype=torch.float32)
    statuses = set()
    for i in range(B):
        if not live[i]:
            assert (got.neval[i], got.ncall[i], got.status[i]) == (neval0[i], 0, 0)
            assert got.step[i] == stp0[i] and got.fx[i] == finit[i]
            continue
        pdef = ProblemDef(value_and_grad=_scalar_objective(line, i, dtype))
        want = t_ls.find(pdef, ls, xp, finit[i], xp, xp, stp0[i], int(neval0[i]),
                         dginit=dginit[i])
        # the scalar search's fx is its materialized trial's, on the device
        (want_fx,) = to_host(want.fx) if torch.is_tensor(want.fx) else (want.fx,)
        assert want_fx == got.fx[i] and want_fx.dtype == got.fx.dtype, i
        assert want.step == got.step[i] and want.step_eval == got.step_eval[i], i
        assert (want.ncall, want.neval, want.status) == (
            got.ncall[i], got.neval[i], got.status[i]), i
        exhausted = want.status == 0 and want.ncall == ls.max_linesearch
        statuses.add("exhausted" if exhausted else int(want.status))
    # the rounds narrow as the instances select
    assert rounds[0] == live.sum() and (len(rounds) == 1 or rounds[-1] < rounds[0])
    expect = {"default": 0, "short": "exhausted", "min_step": int(Status.LS_MIN_STEP),
              "max_step": int(Status.LS_MAX_STEP)}[case]
    assert expect in statuses and 0 in statuses, statuses


def test_one_read_per_round():
    """The runner's round reads the [B, K] f-values once."""
    x0b = t_rosen.initial_point(16, device="cpu")[None].repeat(4, 1)
    x0b[1:] += 0.01 * torch.arange(3, dtype=torch.float64)[:, None]
    k = t_rosen.value_and_grad.kernels
    k.probe_steps_batched_ref.calls = 0
    to_host.reads = 0
    out = (t_lbfgs().with_linesearch_algorithm("BacktrackingArmijo").with_max_iterations(10)
           .with_speculative_linesearch(4).minimize_batched(x0b, t_rosen.value_and_grad))
    iters = int(out["niter"].max()) - 1
    # the init's read, then each iteration's rounds and its one read
    assert to_host.reads == 1 + k.probe_steps_batched_ref.calls + iters


# ---------------------------------------------------------------------------
# whole batched runs
# ---------------------------------------------------------------------------

OBJECTIVES = {"factory": t_rosen.value_and_grad, "generic": t_rosen._plain_value_and_grad}
SETTINGS = {
    "armijo": lambda b: b.with_linesearch_algorithm("BacktrackingArmijo").with_max_iterations(30),
    "owlqn": lambda b: b.with_orthantwise(1.0, 0, None).with_max_iterations(30),
}


def _x0b():
    rng = np.random.default_rng(0)
    return rng.uniform(-2.0, 2.0, size=(8, 16))


@pytest.mark.parametrize("obj", list(OBJECTIVES))
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_matches_jax_batched_speculative(obj, setting):
    """At the JAX package's own tolerances (its doubly vmapped candidate
    pass reassociates the objective's reductions), over 20 iterations: the
    two frameworks' float64 reductions part on the last bits, and 30
    unconverged Rosenbrock iterations carry that to rel 1.5e-10."""
    x0b = _x0b()
    t = SETTINGS[setting](t_lbfgs()).with_max_iterations(20).with_speculative_linesearch(
        4).minimize_batched(torch.from_numpy(x0b), OBJECTIVES[obj])
    j = SETTINGS[setting](j_lbfgs()).with_max_iterations(20).with_speculative_linesearch(
        4).minimize_batched(jnp.asarray(x0b), j_rosen.value_and_grad)
    np.testing.assert_allclose(t["fx"].numpy(), np.asarray(j["fx"]), rtol=1e-10)
    np.testing.assert_allclose(t["x"].numpy(), np.asarray(j["x"]), atol=1e-8)
    assert np.array_equal(t["niter"].numpy(), np.asarray(j["niter"]))
    assert np.array_equal(t["status"].numpy(), np.asarray(j["status"]))


@pytest.mark.parametrize("obj", list(OBJECTIVES))
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_matches_batched_sequential(obj, setting):
    x0b = torch.from_numpy(_x0b())
    base = SETTINGS[setting](t_lbfgs())
    seq = base.minimize_batched(x0b, OBJECTIVES[obj])
    spec = base.with_speculative_linesearch(4).minimize_batched(x0b, OBJECTIVES[obj])
    for name in ("niter", "neval", "status"):
        assert torch.equal(spec[name], seq[name]), name
    if obj == "factory":
        assert torch.equal(spec["x"], seq["x"]) and torch.equal(spec["fx"], seq["fx"])
    else:
        np.testing.assert_allclose(spec["x"].numpy(), seq["x"].numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(spec["fx"].numpy(), seq["fx"].numpy(), rtol=1e-12)


@pytest.mark.parametrize("obj", list(OBJECTIVES))
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_instances_match_solo_runs(obj, setting):
    """Each instance as its solo speculative run (the whole-run loop)."""
    x0b = torch.from_numpy(_x0b())
    opt = SETTINGS[setting](t_lbfgs()).with_speculative_linesearch(3)
    out = opt.minimize_batched(x0b, OBJECTIVES[obj])
    for b in range(len(x0b)):
        solo = opt.minimize_jit(x0b[b].clone(), OBJECTIVES[obj])
        assert (int(out["niter"][b]), int(out["neval"][b]), int(out["status"][b])) == (
            solo.niter, solo.neval, solo.status), b
        assert float(out["fx"][b]) == pytest.approx(float(solo.fx), rel=1e-9, abs=1e-300)


def _offset_candidates():
    """The generic Rosenbrock whose fx-only form, which the candidate pass
    evaluates, is 1e-9 above its value: an fx taken from the candidates
    and not from the materialized point shows."""
    def vag(x):
        return t_rosen._plain_value_and_grad(x)

    vag.__lbfgs_value_and_grad__ = True
    vag.__lbfgs_value__ = lambda x: t_rosen._plain_value_and_grad(x)[0] + 1e-9
    return vag


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_fx_from_the_materialized_points(setting):
    """fx is each accepted instance's value at its materialized point (the
    solo search's contract, ``lbfgs_tpu/linesearch.py:942-957``), not its
    candidate's."""
    vag = _offset_candidates()
    x0b = torch.from_numpy(_x0b())
    st = SETTINGS[setting](t_lbfgs()).with_max_iterations(6).with_speculative_linesearch(
        4).minimize_batched(x0b, vag, return_state=True)
    for b in range(len(x0b)):
        want = float(t_rosen._plain_value_and_grad(st.x[b])[0])
        if setting == "owlqn":
            want += float(st.x[b].abs().sum())
        assert float(st.fx[b]) == pytest.approx(want, rel=1e-14, abs=1e-14), b


@pytest.mark.parametrize("uncapped", [False, True])
@pytest.mark.parametrize("owlqn", [False, True])
def test_trial_route_under_speculation(uncapped, owlqn):
    """No batched epilogue: K1 b and K5 b (OWL-QN: K7 b, K10 b and K12 b)
    per iteration; uncapped, the fusion's carried probes go unused."""
    k = t_rosen.value_and_grad.kernels
    refs = ("trial_pair_gram_batched_ref", "owlqn_trial_pair_gram_batched_ref",
            "trial_batched_ref", "owlqn_trial_batched_ref", "probe_batched_ref",
            "owlqn_probe_pg_batched_ref", "probe_steps_batched_ref",
            "owlqn_probe_pg_steps_batched_ref", "combine_probe_batched_ref",
            "combine_ow_probe_batched_ref")
    for name in refs:
        getattr(k, name).calls = 0
    t_fused.pair_gram_sd_batched_ref.calls = t_fused.pair_gram_xg_batched_ref.calls = 0
    t_ls.carried.ignored = 0
    x0b = torch.from_numpy(_x0b())
    opt = (t_lbfgs().with_linesearch_algorithm("BacktrackingArmijo").with_max_iterations(12)
           .with_constrain_step_size(not uncapped).with_speculative_linesearch(4))
    if owlqn:
        opt = opt.with_orthantwise(1.0, 0, None)
    st = opt.minimize_batched(x0b, t_rosen.value_and_grad, return_state=True)
    iters = int(st.k.max()) - 1
    assert (st.status == Status.MAX_ITERATIONS).all()
    c = {name: getattr(k, name).calls for name in refs}
    assert c["trial_pair_gram_batched_ref"] == c["owlqn_trial_pair_gram_batched_ref"] == 0
    assert c["probe_batched_ref"] == c["owlqn_probe_pg_batched_ref"] == 0
    trial, lanes = (("owlqn_trial_batched_ref", "owlqn_probe_pg_steps_batched_ref") if owlqn
                    else ("trial_batched_ref", "probe_steps_batched_ref"))
    assert c[trial] == iters and c[lanes] >= iters
    pair = t_fused.pair_gram_xg_batched_ref if owlqn else t_fused.pair_gram_sd_batched_ref
    assert pair.calls == iters
    fusion = "combine_ow_probe_batched_ref" if owlqn else "combine_probe_batched_ref"
    assert c[fusion] == (iters if uncapped else 0)
    assert t_ls.carried.ignored == (8 * (iters - 1) if uncapped else 0)


def test_wide_scalar_matches_sequential():
    x0b = torch.from_numpy(_x0b()).float()
    base = (t_lbfgs().with_fx_wide().with_linesearch_algorithm("BacktrackingArmijo")
            .with_max_iterations(20))
    seq = base.minimize_batched(x0b, t_rosen.value_and_grad)
    spec = base.with_speculative_linesearch(4).minimize_batched(x0b, t_rosen.value_and_grad)
    assert spec["fx"].dtype == torch.float64 and spec["x"].dtype == torch.float32
    for name in ("niter", "neval", "status", "fx", "x"):
        assert torch.equal(spec[name], seq[name]), name


def test_frozen_instance_untouched():
    """An instance that starts converged never enters a round."""
    x0b = torch.from_numpy(_x0b())
    x0b[0] = 1.0
    st = (t_lbfgs().with_linesearch_algorithm("BacktrackingArmijo").with_max_iterations(10)
          .with_speculative_linesearch(4).minimize_batched(x0b, t_rosen.value_and_grad,
                                                           return_state=True))
    assert st.k[0] == 0 and st.neval[0] == 1 and st.status[0] == Status.CONVERGED
    assert torch.equal(st.x[0], torch.ones(16, dtype=torch.float64))
    assert (st.k[1:] == 10).all()


@pytest.mark.parametrize("builder", [
    lambda b: b,  # More-Thuente
    lambda b: b.with_linesearch_algorithm("BacktrackingWolfe"),
    lambda b: b.with_linesearch_algorithm("BacktrackingStrongWolfe"),
    lambda b: b.with_linesearch_algorithm("BacktrackingArmijo").with_gradient_only(),
], ids=["more_thuente", "wolfe", "strong_wolfe", "gradient_only"])
def test_rejects_non_armijo_ladders(builder):
    b = builder(t_lbfgs()).with_speculative_linesearch(4)
    with pytest.raises(ValueError, match="Armijo-only ladder"):
        b.minimize_batched(torch.from_numpy(_x0b()), t_rosen.value_and_grad)


def test_solo_and_batched_runs_agree_in_float32():
    """float32 vectors over a bfloat16 ring: each instance as its solo run
    through the same K-lane plain versions under the fused-vs-unfused rule
    (``tests/test_combine_probe.py:113-116``): the same iterations and
    evaluations after 8 iterations, fx rel 1e-3 (the batched and the solo
    pair + Gram passes sum in other orders, and float32 Rosenbrock carries
    that to 4e-4 by 15 iterations)."""
    x0b = torch.from_numpy(_x0b()).float()
    opt = (t_lbfgs().with_linesearch_algorithm("BacktrackingArmijo").with_max_iterations(9)
           .with_history_dtype("bfloat16").with_speculative_linesearch(4))
    out = opt.minimize_batched(x0b, t_rosen.value_and_grad)
    for b in range(len(x0b)):
        solo = t_minimize_jit(opt.param, x0b[b].clone(), t_rosen.value_and_grad)
        assert (int(out["niter"][b]), int(out["neval"][b])) == (solo.niter, solo.neval)
        assert float(out["fx"][b]) == pytest.approx(float(solo.fx), rel=1e-3)
