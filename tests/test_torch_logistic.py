"""The Poisson regression (the reference's L1 workload, ``tests/owlqn.rs``)
in the PyTorch port against ``lbfgs_tpu`` on the CPU.

The objective against the JAX package's in float64 and float32; the
synthetic dataset value for value; the composed OWL-QN branch (K11 at the
start, K9 per trial point, K10, K12 and K13 per iteration) one
``propagate_hot`` per iteration from the JAX package's own state
(float64, rel 1e-9, up to each run's convergence); whole runs through every entry
point; the counted plain versions along that branch; the reference
golden where its CSV fixtures are present; and the float32 objective
floor with the wide objective scalar on the JAX test's own data.
"""

import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import lbfgs_torch
from lbfgs_torch import LbfgsError, interop
from lbfgs_torch import solver as tsol
from lbfgs_torch.core import ProblemDef as TDef
from lbfgs_torch.minimize import LbfgsState as TState
from lbfgs_torch.models import logistic as t_log
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.orthantwise import Orthantwise as TOW
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_torch.params import LineSearchAlgorithm as TAlgo
from lbfgs_torch.status import Status
from lbfgs_torch.utils.csvio import read_r_csv
from lbfgs_tpu import solver as jsol
from lbfgs_tpu.core import ProblemDef as JDef
from lbfgs_tpu.minimize import LbfgsState as JState
from lbfgs_tpu.models import logistic as j_log
from lbfgs_tpu.orthantwise import Orthantwise as JOW
from lbfgs_tpu.params import LbfgsParams as JParams
from lbfgs_tpu.params import LineSearchAlgorithm as JAlgo

ITERS, REL = 15, 1e-9
#: the reference checkout's ``tests`` directory (x.csv, y.csv), if any
REF_DIR = os.environ.get("LBFGS_REFERENCE_TESTS", "")
#: the JAX package's synthetic OWL-QN run (tests/test_owlqn_logistic.py:
#: 146-163): 300 x 11, seed 3, c = 30 on [1, 11), to epsilon 1e-4
C, LO, NCOL = 30.0, 1, 11
#: the per-iteration lock-step, (ncol, c, iterations): that run converges
#: at iteration 9, past which pg is the products' rounding noise, so it is
#: held to iteration 8, and 300 x 21, seed 3, c = 3 on [1, 21), which
#: converges at iteration 16, is held to iteration 15
STEP_RUNS = {"300x11_c30": (NCOL, C, 8), "300x21_c3": (21, 3.0, ITERS)}


def _close(t, j, what, rel=REL):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    j = np.asarray(j, np.float64).reshape(t.shape)
    scale = max(np.abs(j).max(), 1e-300)
    np.testing.assert_allclose(t, j, rtol=rel, atol=rel * scale, err_msg=what)


@pytest.fixture(scope="module")
def data():
    X, y = j_log.synthetic_dataset(nrow=300, ncol=NCOL, seed=3)
    return np.asarray(X), np.asarray(y)


def test_synthetic_dataset_is_the_jax_packages(data):
    X, y = t_log.synthetic_dataset(300, NCOL, seed=3, device="cpu")
    assert X.dtype == y.dtype == torch.float64
    np.testing.assert_array_equal(X.numpy(), data[0])
    np.testing.assert_array_equal(y.numpy(), data[1])
    X5, y5 = t_log.synthetic_dataset(device="cpu")
    X5j, y5j = j_log.synthetic_dataset()
    np.testing.assert_array_equal(X5.numpy(), np.asarray(X5j))
    np.testing.assert_array_equal(y5.numpy(), np.asarray(y5j))


@pytest.mark.parametrize("dtype,rel", [(np.float64, 1e-12), (np.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("prec", [0.0, 0.3])
def test_objective_matches_jax(data, dtype, rel, prec):
    X, y = (a.astype(dtype) for a in data)
    beta = np.random.default_rng(1).standard_normal(NCOL).astype(dtype) * 0.1
    ft, gt = interop.logistic_objective(X, y, "cpu", prec=prec)(torch.from_numpy(beta))
    fj, gj = j_log.make_objective(jnp.asarray(X), jnp.asarray(y), prec=prec)(jnp.asarray(beta))
    assert ft.dtype == gt.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    _close(ft, fj, "fx", rel)
    _close(gt, gj, "g", rel)


def test_objective_refuses_what_is_not_ported():
    X = torch.zeros(4, 3)
    # a bfloat16 X runs over float32 vectors since it was ported; y in
    # bfloat16 is still refused, by the rule on y
    with pytest.raises(NotImplementedError, match=r"over y torch\.bfloat16"):
        t_log.make_objective(X.bfloat16(), torch.zeros(4).bfloat16())
    with pytest.raises(ValueError, match="precision"):
        t_log.make_objective(X, torch.zeros(4), precision="bf16")


def test_synthetic_on_a_cpu_generator_has_its_law():
    g = torch.Generator().manual_seed(0)
    X, y = t_log.synthetic(512, 64, nnz=8, device="cpu", generator=g)
    assert X.shape == (512, 64) and y.shape == (512,) and X.dtype == y.dtype == torch.float32
    assert bool((X[:, 0] == 1.0).all())
    assert bool((y >= 0).all()) and bool((y == y.round()).all())
    again = t_log.synthetic(512, 64, nnz=8, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    assert torch.equal(X, again[0]) and torch.equal(y, again[1])


# ---------------------------------------------------------------------------
# the composed OWL-QN branch, one propagate per iteration from JAX's state
# ---------------------------------------------------------------------------


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_runs():
    """Per lock-step run: its data and the JAX package's states 0..iterations."""
    runs = {}
    for name, (ncol, c, iters) in STEP_RUNS.items():
        X, y = (np.asarray(a) for a in j_log.synthetic_dataset(nrow=300, ncol=ncol, seed=3))
        ow = JOW(c, LO, ncol)
        pdef = JDef(value_and_grad=j_log.make_objective(jnp.asarray(X), jnp.asarray(y)),
                    owlqn=ow)
        params = JParams(orthantwise=ow)
        step = jax.jit(lambda st, pdef=pdef, params=params: jsol.propagate_hot(pdef, params, st))
        st = jsol.start_state(jsol.init_state(pdef, params, jnp.zeros(ncol)), params)
        states = [_np(st)]
        for _ in range(iters):
            st = step(st)
            states.append(_np(st))
        runs[name] = ((X, y), states)
    return runs


def _tdef(name, data):
    ncol, c, _ = STEP_RUNS[name]
    ow = TOW(c, LO, ncol)
    return TDef(interop.logistic_objective(*data, "cpu"), owlqn=ow), TParams(orthantwise=ow)


@pytest.mark.parametrize("name", list(STEP_RUNS))
def test_composed_init_matches_jax(jax_runs, name):
    data, states = jax_runs[name]
    pdef, params = _tdef(name, data)
    t = tsol.init_state(pdef, params, torch.zeros(STEP_RUNS[name][0], dtype=torch.float64))
    j = states[0]
    for key in ("x", "gx", "pg", "d", "fx", "gnorm2", "xnorm2"):
        _close(getattr(t.prob, key), getattr(j.prob, key), key)
    _close(t.step, j.step, "step")


@pytest.mark.parametrize("name,k", [(name, k) for name, (_, _, iters) in STEP_RUNS.items()
                                    for k in range(1, iters + 1)])
def test_composed_propagate_matches_jax(jax_runs, name, k):
    data, states = jax_runs[name]
    pdef, params = _tdef(name, data)
    st = interop.state_from_jax(states[k - 1], "cpu")
    out = tsol.propagate_hot(pdef, params, st)
    ref = states[k]
    assert (out.status, out.ls_status) == (int(ref.status), int(ref.ls_status))
    assert (out.k, out.end, out.ncall, out.prob.neval) == (
        int(ref.k), int(ref.end), int(ref.ncall), int(ref.prob.neval))
    for name in ("x", "gx", "pg", "d", "fx", "gnorm2", "xnorm2"):
        _close(getattr(out.prob, name), getattr(ref.prob, name), name)
    for name in ("step", "step_ls"):
        _close(getattr(out, name), getattr(ref, name), name)
    for name in ("s", "y", "ys", "sy", "yy"):
        _close(getattr(out.hist, name), getattr(ref.hist, name), name)


def _counts():
    return dict(K11=t_fused.pseudo_gradient_ref.calls,
                K9=t_fused.owlqn_trial_step_ref.calls,
                K10=t_fused.pseudo_gradient_norm_ref.calls,
                K12=t_fused.pair_gram_xg_ref.calls,
                K13=t_fused.combine_ow_ref.calls)


@pytest.mark.parametrize("entry", ["minimize", "minimize_jit", "LbfgsState"])
def test_composed_run_to_epsilon(data, entry):
    """The JAX package's ``test_owlqn_logistic_synthetic`` outcome, and the
    launch rule of the composed branch through the counted plain
    versions: K11 once, K9 per trial point, K10, K12 and K13 per
    iteration."""
    X, y = (jnp.asarray(a) for a in data)
    rj = lbfgs_tpu_minimize(X, y)
    b = lbfgs_torch.lbfgs().with_orthantwise(C, LO, NCOL).with_epsilon(1e-4)
    obj = interop.logistic_objective(*data, "cpu")
    before = _counts()
    x0 = torch.zeros(NCOL, dtype=torch.float64)
    if entry == "LbfgsState":
        st = b.build(x0, obj)
        while not st.is_converged():
            st.propagate()
        rep = st.report()
    else:
        rep = getattr(b, entry)(x0, obj)
    used = {k: v - before[k] for k, v in _counts().items()}
    iters = rep.niter - 1
    assert used == dict(K11=1, K9=rep.neval - 1, K10=iters, K12=iters, K13=iters)
    assert rep.status == Status.CONVERGED
    assert (rep.niter, rep.neval) == (int(rj.niter), int(rj.neval))
    assert rep.fx == pytest.approx(float(rj.fx), rel=REL)
    _close(rep.x, rj.x, "x", rel=1e-8)
    beta = rep.x.numpy()
    assert np.sum(beta[1:] == 0.0) >= 1 and beta[0] != 0.0


def lbfgs_tpu_minimize(X, y):
    from lbfgs_tpu import lbfgs

    return (lbfgs().with_orthantwise(C, LO, NCOL).with_epsilon(1e-4)
            .minimize(jnp.zeros(NCOL), j_log.make_objective(X, y)))


@pytest.mark.skipif(not os.path.exists(os.path.join(REF_DIR, "x.csv")),
                    reason="the reference's CSV fixtures (LBFGS_REFERENCE_TESTS) are absent")
def test_reference_golden():
    """Golden fx = -42724.136705 at rel 1e-6 (tests/owlqn.rs:60)."""
    X = read_r_csv(os.path.join(REF_DIR, "x.csv"))
    y = read_r_csv(os.path.join(REF_DIR, "y.csv")).ravel()
    assert X.shape == (500, 21) and y.shape == (500,)
    rep = (lbfgs_torch.lbfgs().with_orthantwise(1.0, 1, 21).with_epsilon(1e-4)
           .minimize(torch.zeros(21, dtype=torch.float64),
                     interop.logistic_objective(X, y, "cpu")))
    assert abs(rep.fx - -42724.136705) <= 1e-6 * 42724.136705
    assert rep.niter <= 250


def test_read_r_csv(tmp_path):
    p = tmp_path / "x.csv"
    p.write_text('"","V1","V2"\n"1",1.5,-2\n"2",3,"4e-1"\n')
    np.testing.assert_array_equal(read_r_csv(str(p)), [[1.5, -2.0], [3.0, 0.4]])


# ---------------------------------------------------------------------------
# the float32 objective floor and the wide objective scalar
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def floor_data():
    """The JAX test's own arrays (tests/test_owlqn_logistic.py:90-143):
    512 x 64, seed 0, nnz 8, made by the JAX package and handed to both."""
    X, y = j_log.synthetic_device(512, 64, seed=0, dtype=jnp.float32,
                                  x_dtype=jnp.float32, nnz=8)
    return np.asarray(X), np.asarray(y)


def _floor_run(state_cls, params, x0, obj):
    st = state_cls.build(params, x0, obj)
    trace, err = [], None
    logging.disable(logging.ERROR)
    try:
        while not st.is_converged():
            trace.append(float(st.propagate().fx))
    except Exception as e:  # the fatal statuses of both packages
        err = e
    finally:
        logging.disable(logging.NOTSET)
    return st, err, trace


@pytest.mark.parametrize("wide", [False, True], ids=["f32", "wide"])
def test_f32_floor_and_wide_fx_against_jax(floor_data, wide):
    """Both packages on the same arrays, c = 5 on [1, 64), Armijo, 60
    iterations.  Per iteration the port follows the JAX run to the f32
    rounding of their different matrix products (rel 1e-6 over the first
    15 iterations); fx is float64 under the wide mode and float32
    without, the vectors float32.  Where each run stops is not held: past
    the objective floor both runs live at the f32 VECTOR floor, where a
    pair with s.y or y.y exactly 0 ends the run (ERR_G_NOT_CHANGED, or a
    NaN direction), and which iteration first rounds to such a pair
    depends on the summation order of the products (PERF.md, section 6).
    Both end at the same basin, fx within 2e-6 rel of each other."""
    X, y = floor_data
    tp = TParams(max_iterations=60, epsilon=1e-4, orthantwise=TOW(5.0, 1, 64),
                 fx_wide=wide).replace_ls(algorithm=TAlgo.BacktrackingArmijo)
    jp = JParams(max_iterations=60, epsilon=1e-4, orthantwise=JOW(5.0, 1, 64),
                 fx_wide=wide).replace_ls(algorithm=JAlgo.BacktrackingArmijo)
    st, err, tr = _floor_run(TState, tp, torch.zeros(64), interop.logistic_objective(X, y,
                                                                                    "cpu"))
    sj, errj, trj = _floor_run(JState, jp, jnp.zeros(64, jnp.float32),
                               j_log.make_objective(jnp.asarray(X), jnp.asarray(y),
                                                    precision=None))
    assert type(st.state.prob.fx) is (np.float64 if wide else np.float32)
    assert st.state.prob.x.dtype == st.state.prob.gx.dtype == torch.float32
    assert type(st.report().fx) is np.float64
    assert len(tr) >= ITERS and len(trj) >= ITERS
    np.testing.assert_allclose(tr[:ITERS], trj[:ITERS], rtol=1e-6)
    fatal = (Status.ERR_X_NOT_CHANGED, Status.ERR_G_NOT_CHANGED, Status.ERR_INVALID_DNORM)
    assert (err is None and st.state.k == 60) or (
        isinstance(err, LbfgsError) and st.state.status in fatal)
    assert float(st.state.prob.fx) == pytest.approx(float(sj.state.prob.fx), rel=2e-6)
