"""Whole sharded runs of the PyTorch port against the JAX package's
(the counterpart of ``tests/test_sharding.py`` and, for the collectives,
``tests/test_hlo_collectives.py``).

The port's run is ``minimize_jit`` under ``kernels_on_mesh`` over W gloo
ranks (``_torch_mesh_ranks.job_runs``, one job per W, every rank a
subprocess that runs the plain versions on its shard); the JAX run is
``minimize_jit`` under ``kernels_on_mesh`` on a W-device mesh of the
conftest's virtual CPU devices.  Rosenbrock from its start, n = 1024,
float64, 14 iterations, on the plain path (capped and uncapped),
OWL-QN (c = 1 on [0, n - 1), Armijo), damped, damped OWL-QN and the
literal scan two-loop (``compact_two_loop=False``: ``vecmath``'s dots).
Held:

- the same iterations and evaluations; fx rel 1e-9; x, gathered after
  the run, at rtol 1e-9 and atol 1e-12 (``tests/test_sharding.py:38-41``);
- every rank's k, evaluations, fx and gathered x the same bits;
- W = 1 the run with no mesh, bit for bit;
- a resume from a JAX state (k = 5) that ``interop.state_from_jax(...,
  mesh=...)`` slices, through ``LbfgsState``, against the JAX steps from
  the same state; ``gather_state`` of ``shard_state`` is that state bit
  for bit;
- the collectives: one per launch, so per iteration one per search trip
  that the combine+probe fusion did not carry in, one for the epilogue
  and one for the combine: at most 3 plus one per extra trip, pinned
  exactly on the fused paths; the init one (K1), three under OWL-QN (K1,
  the L1 term, K10);
  no gather of an [n] vector inside a run;
- under a mesh the native backend, the batched runner and a generic
  objective without the local contract raise ``NotImplementedError``
  naming the setting (checkpoints and objectives under the contract run
  there: ``tests/test_torch_sharded_checkpoint.py``,
  ``tests/test_torch_sharded_generic.py``).
"""

import pickle
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import _torch_mesh_ranks as ranks
from lbfgs_tpu import solver as jsol
from lbfgs_tpu.core import ProblemDef as JDef
from lbfgs_tpu.minimize import minimize_jit as j_minimize_jit
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.orthantwise import Orthantwise as JOw
from lbfgs_tpu.params import LbfgsParams as JParams
from lbfgs_tpu.parallel import kernels_on_mesh as j_kernels_on_mesh
from lbfgs_tpu.parallel import make_mesh as j_make_mesh
from lbfgs_tpu.parallel import shard_vector as j_shard_vector

N, ITERS = 1024, 15
_OW = dict(orthantwise=[1.0, 0, N - 1], algorithm="BacktrackingArmijo")
PATHS = {
    "plain_capped": dict(max_iterations=ITERS),
    "plain_uncapped": dict(max_iterations=ITERS, constrain_step_size=False),
    "owlqn": dict(max_iterations=ITERS, **_OW),
    "damped": dict(max_iterations=ITERS, damping=True),
    "damped_owlqn": dict(max_iterations=ITERS, damping=True, **_OW),
    "scan": dict(max_iterations=ITERS, compact_two_loop=False),
}
#: the paths whose passes are all kernels (one collective per launch)
FUSED = [name for name in PATHS if name != "scan"]
WORLDS = (1, 2, 4)
RESUME_AT = 5
REL, X_TOL = 1e-9, dict(rtol=1e-9, atol=1e-12)


def _jparams(cfg: dict) -> JParams:
    p = JParams(**{k: v for k, v in cfg.items() if k not in ("orthantwise", "algorithm")})
    if "orthantwise" in cfg:
        p = p.replace(orthantwise=JOw(*cfg["orthantwise"]))
    if "algorithm" in cfg:
        p = p.replace_ls(algorithm=cfg["algorithm"])
    return p


def _plain_tree(v):
    """A JAX state as SimpleNamespaces of numpy leaves: what a rank
    unpickles without importing JAX."""
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return types.SimpleNamespace(**{f: _plain_tree(getattr(v, f)) for f in v._fields})
    if isinstance(v, tuple):
        return tuple(_plain_tree(e) for e in v)
    return None if v is None else np.asarray(v)


@pytest.fixture(scope="module")
def jax_resume(tmp_path_factory):
    """The JAX step-at-a-time states of the plain path from k = RESUME_AT
    to ITERS; the first pickled for the ranks."""
    params = _jparams(PATHS["plain_capped"])
    pdef = JDef(value_and_grad=j_rosen.value_and_grad)
    step = jax.jit(lambda st: jsol.propagate_hot(pdef, params, st))
    st = jsol.start_state(jsol.init_state(pdef, params, j_rosen.initial_point(N)), params)
    while int(st.k) < RESUME_AT:
        st = step(st)
    path = tmp_path_factory.mktemp("resume") / "state.pkl"
    with open(path, "wb") as f:
        pickle.dump(_plain_tree(st), f)
    while int(st.k) < ITERS:
        st = step(st)
    return str(path), jax.tree.map(np.asarray, st)


@pytest.fixture(scope="module")
def port(tmp_path_factory, jax_resume):
    out = {}
    for w in WORLDS:
        d = tmp_path_factory.mktemp(f"runs_w{w}")
        res = ranks.launch("runs", w, d, dict(
            n=N, dtype="float64", paths=PATHS,
            resume=dict(state=jax_resume[0], params=PATHS["plain_capped"])), timeout=180)
        xs = {name: np.load(d / f"{name}.npy") for name in (*PATHS, "resume")}
        out[w] = (res, xs)
    return out


_JAX_RUNS = {}


def _jax_run(w: int, name: str):
    key = (w, name)
    if key not in _JAX_RUNS:
        mesh = j_make_mesh(jax.devices()[:w])
        with j_kernels_on_mesh(mesh):
            _JAX_RUNS[key] = j_minimize_jit(
                _jparams(PATHS[name]), j_shard_vector(j_rosen.initial_point(N), mesh),
                j_rosen.value_and_grad)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("name", list(PATHS))
@pytest.mark.parametrize("w", [2, 4])
def test_sharded_run_matches_jax(port, w, name):
    res, xs = port[w]
    rep = _jax_run(w, name)
    got = res[0][name]
    assert (got["k"], got["neval"]) == (rep.niter, rep.neval)
    assert got["fx"] == pytest.approx(float(rep.fx), rel=REL)
    np.testing.assert_allclose(xs[name], np.asarray(rep.x), **X_TOL)


@pytest.mark.parametrize("name", list(PATHS))
@pytest.mark.parametrize("w", WORLDS)
def test_ranks_agree_bit_for_bit(port, w, name):
    res, _ = port[w]
    keys = ("k", "neval", "status", "fx_hex", "x_sha")
    assert len({tuple(r[name][k] for k in keys) for r in res}) == 1


@pytest.mark.parametrize("name", list(PATHS))
def test_world_size_one_is_the_run_with_no_mesh(port, name):
    got = port[1][0][0][name]
    solo = got["solo"]
    assert {k: got[k] for k in solo} == solo


@pytest.mark.parametrize("w", WORLDS)
def test_resume_from_a_sliced_jax_state(port, jax_resume, w):
    res, xs = port[w]
    ref = jax_resume[1]
    got = res[0]["resume"]
    assert (got["k"], got["neval"]) == (int(ref.k), int(ref.prob.neval))
    assert got["fx"] == pytest.approx(float(ref.prob.fx), rel=REL)
    np.testing.assert_allclose(xs["resume"], np.asarray(ref.prob.x), **X_TOL)
    assert len({r["resume"]["x_sha"] for r in res}) == 1


@pytest.mark.parametrize("w", WORLDS)
def test_state_round_trip(port, w):
    assert all(r["state_round_trip"] for r in port[w][0])


@pytest.mark.parametrize("name", FUSED)
@pytest.mark.parametrize("w", [2, 4])
def test_collectives_per_iteration(port, w, name):
    got = port[w][0][0][name]
    c = got["collectives"]
    iters, trips = got["k"] - 1, got["neval"] - 1
    assert c["gathers"] == 0
    assert c["init"] == (3 if "owlqn" in name else 1)
    # one per search trip not carried in, one epilogue, one combine
    assert c["iterations"] == trips - c["carried"] + 2 * iters
    assert c["iterations"] <= 3 * iters + (trips - iters)


@pytest.mark.parametrize("setting", ["native backend", "batched", "generic objective"])
def test_refused_on_a_mesh(tmp_path, setting):
    import lbfgs_torch
    from lbfgs_torch.models import rosenbrock
    from lbfgs_torch.parallel import kernels_on_mesh

    x0 = rosenbrock.initial_point(64, device="cpu")
    b = lbfgs_torch.lbfgs()
    calls = {
        "native backend": lambda: b.minimize(x0, rosenbrock.value_and_grad, backend="native"),
        "batched": lambda: b.minimize_batched(x0[None], rosenbrock.value_and_grad),
        # an objective without the local contract
        "generic objective": lambda: b.minimize_jit(x0, lambda x: ((x * x).sum(), 2 * x)),
    }
    with ranks.local_mesh() as mesh, kernels_on_mesh(mesh):
        with pytest.raises(NotImplementedError, match=setting):
            calls[setting]()
