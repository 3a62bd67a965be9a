"""Generic objectives on a mesh under the local contract, against the JAX
package (the counterpart of ``tests/test_sharding.py:29-40``, which runs
the JAX package's jnp Rosenbrock sharded).

The port's runs go over W gloo ranks (``_torch_mesh_ranks.job_generic``,
one job per W): the generic Rosenbrock (``rosenbrock.generic_value_and_grad``,
float64, n = 128) on the plain path with More-Thuente capped and uncapped
and with the backtracking ladders, OWL-QN (c = 1 on [0, n - 1), Armijo),
damped, damped OWL-QN (15 iterations), the wide objective scalar and the
scan two-loop; and the Poisson regression over a seeded 64 x 256 float64
X split by columns (``parallel.shard_vector``), OWL-QN (c = 1 on [1, n),
Armijo) and plain More-Thuente capped.  Each path runs through
``minimize_jit``, five of them also step by step (``LbfgsState``).  Held:

- against ``lbfgs_tpu``'s ``minimize_jit`` unsharded, on
  ``rosenbrock._plain_value_and_grad`` and ``logistic.make_objective`` over
  the whole X: the same iterations and evaluations, fx abs 1e-12 and x at
  rtol 1e-9, atol 1e-12 (the Poisson fx rel 1e-10, and x, whose minimizer
  lies in a flat valley of 256 coefficients over 64 rows, at rtol 1e-4,
  atol 1e-6);
- W = 1 the run with no mesh bit for bit, and the ranks alike bit for bit;
- the step-by-step runs the same bits as ``minimize_jit``'s;
- the collectives: each search trip costs the objective's own all-reduce
  and one for g.d (under OWL-QN one more, the L1 term), each iteration
  three more (the accepted point's norms, the pair + Gram pass, the
  combine), one more under OWL-QN (K10) and one more damped
  (``update_pair``'s products), pinned exactly; two at the init (three
  under OWL-QN); no gather of an [n] vector inside a run;
- an objective without the contract raises ``NotImplementedError`` on the
  mesh, and a Rosenbrock shard of odd length ``ValueError``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks
from lbfgs_tpu.minimize import minimize_jit as j_minimize_jit
from lbfgs_tpu.models import logistic as j_logistic
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.orthantwise import Orthantwise as JOw
from lbfgs_tpu.params import LbfgsParams as JParams

N = 128
POISSON = [64, 256, 5]
_OW = dict(orthantwise=[1.0, 0, N - 1], algorithm="BacktrackingArmijo")
PATHS = {
    "rosenbrock": {
        "plain_capped": {},
        "plain_uncapped": dict(constrain_step_size=False),
        "armijo": dict(algorithm="BacktrackingArmijo"),
        "wolfe": dict(algorithm="BacktrackingWolfe"),
        "strong_wolfe": dict(algorithm="BacktrackingStrongWolfe"),
        "owlqn": _OW,
        "damped": dict(damping=True),
        "damped_owlqn": dict(damping=True, max_iterations=15, **_OW),
        "wide": dict(fx_wide=True),
        "scan": dict(compact_two_loop=False),
    },
    "poisson": {
        "owlqn": dict(orthantwise=[1.0, 1, POISSON[1]], algorithm="BacktrackingArmijo"),
        "plain_capped": {},
    },
}
CASES = [(model, name) for model, paths in PATHS.items() for name in paths]
#: the paths also run step by step through ``LbfgsState``
STEPWISE = ["rosenbrock_plain_capped", "rosenbrock_owlqn", "rosenbrock_damped",
            "rosenbrock_wide", "poisson_plain_capped"]
IDS = [f"{model}_{name}" for model, name in CASES]
#: the paths whose collectives are pinned (the scan's dots vary with the
#: active pairs)
PINNED = [c for c in CASES if c[1] != "scan"]
WORLDS = (1, 2, 4)
X_TOL = dict(rtol=1e-9, atol=1e-12)


def _jparams(cfg: dict) -> JParams:
    p = JParams(**{k: v for k, v in cfg.items() if k not in ("orthantwise", "algorithm")})
    if "orthantwise" in cfg:
        p = p.replace(orthantwise=JOw(*cfg["orthantwise"]))
    if "algorithm" in cfg:
        p = p.replace_ls(algorithm=cfg["algorithm"])
    return p


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = {}
    for w in WORLDS:
        d = tmp_path_factory.mktemp(f"generic_w{w}")
        res = ranks.launch("generic", w, d, dict(n=N, poisson=POISSON, paths=PATHS,
                                                 stepwise=STEPWISE), timeout=240)
        xs = {f"{m}_{p}": np.load(d / f"{m}_{p}.npy") for m, p in CASES}
        out[w] = (res, xs)
    return out


_JAX = {}


def _jax_run(model: str, name: str):
    if (model, name) not in _JAX:
        import jax.numpy as jnp

        params = _jparams(PATHS[model][name])
        if model == "rosenbrock":
            x0, obj = j_rosen.initial_point(N), j_rosen._plain_value_and_grad
        else:
            X, y = ranks.poisson_data(*POISSON)
            x0, obj = jnp.zeros(POISSON[1]), j_logistic.make_objective(jnp.asarray(X),
                                                                       jnp.asarray(y))
        _JAX[(model, name)] = j_minimize_jit(params, x0, obj)
    return _JAX[(model, name)]


@pytest.mark.parametrize("model,name", CASES, ids=IDS)
@pytest.mark.parametrize("w", WORLDS)
def test_generic_run_matches_jax(port, w, model, name):
    res, xs = port[w]
    rep = _jax_run(model, name)
    got = res[0][f"{model}_{name}"]
    assert (got["k"], got["neval"]) == (rep.niter, rep.neval)
    if model == "rosenbrock":
        assert got["fx"] == pytest.approx(float(rep.fx), abs=1e-12)
        np.testing.assert_allclose(xs[f"{model}_{name}"], np.asarray(rep.x), **X_TOL)
    else:
        # 256 coefficients over 64 rows: the minimizer is a flat valley, so
        # the outcome compared is fx (x agrees to ~1e-6 there)
        assert got["fx"] == pytest.approx(float(rep.fx), rel=1e-10)
        np.testing.assert_allclose(xs[f"{model}_{name}"], np.asarray(rep.x), rtol=1e-4,
                                   atol=1e-6)


KEYS = ("k", "neval", "status", "fx_hex", "x_sha")


@pytest.mark.parametrize("model,name", CASES, ids=IDS)
@pytest.mark.parametrize("w", WORLDS)
def test_ranks_agree_bit_for_bit(port, w, model, name):
    res, _ = port[w]
    assert len({tuple(r[f"{model}_{name}"][k] for k in KEYS) for r in res}) == 1


@pytest.mark.parametrize("case", STEPWISE)
@pytest.mark.parametrize("w", WORLDS)
def test_stepwise_is_minimize_jit(port, w, case):
    got = port[w][0][0][case]
    assert {k: got["stepwise"][k] for k in KEYS} == {k: got[k] for k in KEYS}


@pytest.mark.parametrize("model,name", CASES, ids=IDS)
def test_world_size_one_is_the_run_with_no_mesh(port, model, name):
    got = port[1][0][0][f"{model}_{name}"]
    solo = got["solo"]
    assert {k: got[k] for k in solo} == solo


@pytest.mark.parametrize("model,name", PINNED, ids=[f"{m}_{p}" for m, p in PINNED])
@pytest.mark.parametrize("w", WORLDS)
def test_collectives_per_iteration(port, w, model, name):
    got = port[w][0][0][f"{model}_{name}"]
    c = got["collectives"]
    cfg = PATHS[model][name]
    ow, damped = "orthantwise" in cfg, bool(cfg.get("damping"))
    iters, trips = got["k"] - 1, got["neval"] - 1
    assert c["gathers"] == 0
    assert c["init"] == (3 if ow else 2)
    # per trip: the objective's fx, g.d (and the L1 term); per iteration:
    # the point's norms, the pair + Gram pass, the combine (K10; the
    # damped pair's products)
    assert c["iterations"] == (2 + ow) * trips + (3 + ow + damped) * iters


@pytest.mark.parametrize("w", WORLDS)
def test_refusals_on_a_mesh(port, w):
    res = port[w][0][0]
    assert "generic objective" in res["refused"] and "local contract" in res["refused"]
    assert "requires even n" in res["odd_shard"]


def test_contract_marker_survives_normalization():
    from lbfgs_torch.core import normalize_objective
    from lbfgs_torch.models import logistic, rosenbrock
    from lbfgs_torch.parallel import keeps_local_contract, local_objective

    X, y = (torch.from_numpy(a) for a in ranks.poisson_data(8, 16, 1))
    for fn in (rosenbrock.generic_value_and_grad, logistic.make_objective(X, y),
               local_objective(lambda x: ((x * x).sum(), 2 * x))):
        assert keeps_local_contract(normalize_objective(fn))
    assert not keeps_local_contract(rosenbrock._plain_value_and_grad)
    # with no mesh the generic form is the plain evaluation bit for bit
    x = torch.linspace(-1.0, 1.0, 10, dtype=torch.float64)
    for a, b in zip(rosenbrock.generic_value_and_grad(x), rosenbrock._plain_value_and_grad(x)):
        assert torch.equal(a, b)
