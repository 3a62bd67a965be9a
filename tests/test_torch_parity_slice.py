"""The single-device settings ported last, against ``lbfgs_tpu`` on the CPU:
a bfloat16 X for the Poisson regression, the native backend, the scan
two-loop, float16 history, checkpoint and the pytree front end.

Inputs are made with numpy from fixed seeds (or, for the Poisson runs, by
the JAX package's own generator and carried over through numpy); each
setting is held to the JAX package's function or run in the same process
with the tolerance named at its test.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import ml_dtypes

import lbfgs_torch
import lbfgs_tpu
from lbfgs_torch import interop
from lbfgs_torch import native as t_native
from lbfgs_torch import solver as tsol
from lbfgs_torch.core import ProblemDef as TDef
from lbfgs_torch.core import History as THist
from lbfgs_torch.minimize import LbfgsState as TState
from lbfgs_torch.minimize import minimize_jit as t_minimize_jit
from lbfgs_torch.models import logistic as t_log
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import _build
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.orthantwise import Orthantwise as TOw
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_torch.params import LineSearchAlgorithm as TAlgo
from lbfgs_torch.pytree_api import minimize_pytree as t_minimize_pytree
from lbfgs_torch.utils.checkpoint import fields, load_state, save_state
from lbfgs_tpu import solver as jsol
from lbfgs_tpu.core import History as JHist
from lbfgs_tpu.core import ProblemDef as JDef
from lbfgs_tpu.models import logistic as j_log
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.native import minimize_native as j_minimize_native
from lbfgs_tpu.native import minimize_native_rosenbrock as j_native_rosenbrock
from lbfgs_tpu.orthantwise import Orthantwise as JOw
from lbfgs_tpu.params import LbfgsParams as JParams
from lbfgs_tpu.params import LineSearchAlgorithm as JAlgo
from lbfgs_tpu.pytree_api import minimize_pytree as j_minimize_pytree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the recorded 2018 trajectories (tests/test_native_parity.py:48-67)
GOLDEN_FX, GOLDEN_GNORM = 1.2832127771605377e-15, 9.486547293218877e-07
OWLQN_FX, OWLQN_X0, OWLQN_X1 = 43.50249999999999, 0.2500000069348678, 0.057500004213084016


def _close(t, j, what, rel):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    j = np.asarray(j, np.float64).reshape(t.shape)
    scale = max(np.abs(j).max(), 1e-300)
    np.testing.assert_allclose(t, j, rtol=rel, atol=rel * scale, err_msg=what)


def _trace(builder, x0, fn, upto=None):
    """(fx, gnorm) per iteration of ``builder.minimize``, and its report."""
    out = []

    def progress(p):
        out.append((float(p.fx), float(p.gnorm)))
        return upto is not None and len(out) >= upto

    rep = builder.minimize(x0, fn, progress)
    return out, rep


# ---------------------------------------------------------------------------
# A bfloat16 X for the Poisson regression
# ---------------------------------------------------------------------------


def _bf16(a: np.ndarray) -> np.ndarray:
    return a.astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("prec", [0.0, 0.5])
def test_bf16_x_objective_matches_jax(prec):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((64, 32)).astype(np.float32)
    X[:, 0] = 1.0
    y = rng.poisson(1.5, 64).astype(np.float32)
    beta = (rng.standard_normal(32) * 0.1).astype(np.float32)
    Xb = _bf16(X)
    ft, gt = interop.logistic_objective(Xb, y, "cpu", prec=prec)(torch.from_numpy(beta))
    fj, gj = j_log.make_objective(jnp.asarray(Xb), jnp.asarray(y), prec=prec,
                                  precision=None)(jnp.asarray(beta))
    assert ft.dtype == gt.dtype == torch.float32
    assert float(ft) == pytest.approx(float(fj), rel=1e-5)
    g_err = np.abs(gt.numpy() - np.asarray(gj)).max() / np.abs(np.asarray(gj)).max()
    assert g_err <= 1e-4


def test_bf16_x_is_carried_bit_for_bit_and_products_are_the_widened_ones():
    rng = np.random.default_rng(6)
    Xb = _bf16(rng.standard_normal((48, 20)).astype(np.float32))
    Xt = interop._tensor(Xb, "cpu")
    assert Xt.dtype == torch.bfloat16
    assert np.array_equal(Xt.view(torch.int16).numpy().view(np.uint16), Xb.view(np.uint16))
    v = torch.from_numpy(rng.standard_normal(20).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal(48).astype(np.float32))
    # exact per term in float32: the widened product of the rounded operand
    assert torch.equal(t_log.bf16_matvec(Xt, v), Xt.float() @ v.bfloat16().float())
    assert torch.equal(t_log.bf16_matvec(Xt.T, r), Xt.float().T @ r.bfloat16().float())


#: the JAX package's bfloat16-X configuration (tests/test_owlqn_logistic.py:45-86)
BF16_NROW, BF16_NCOL = 512, 64


@pytest.fixture(scope="module")
def poisson_512():
    """(X float32, X bfloat16, y) from the JAX package's generator, seed 0,
    as numpy."""
    X, y = j_log.synthetic_device(BF16_NROW, BF16_NCOL, seed=0, dtype=jnp.float32, nnz=8)
    Xb, _ = j_log.synthetic_device(BF16_NROW, BF16_NCOL, seed=0, dtype=jnp.float32,
                                   x_dtype=jnp.bfloat16, nnz=8)
    return np.asarray(X), np.asarray(Xb), np.asarray(y)


def _poisson_builders():
    kw = dict(max_iterations=20, epsilon=1e-3)
    t = lbfgs_torch.lbfgs().with_orthantwise(5.0, 1, BF16_NCOL)
    j = lbfgs_tpu.lbfgs().with_orthantwise(5.0, 1, BF16_NCOL)
    t = lbfgs_torch.Lbfgs(t.param.replace(**kw).replace_ls(algorithm=TAlgo.BacktrackingArmijo))
    j = lbfgs_tpu.Lbfgs(j.param.replace(**kw).replace_ls(algorithm=JAlgo.BacktrackingArmijo))
    return t, j


def _poisson_trace(builder, x0, fn, error):
    """(fx per iteration, final status) of ``builder.minimize``: a fatal
    status (``error`` raised) ends the trace as the whole-run loop would."""
    out = []
    try:
        rep = builder.minimize(x0, fn, lambda p: out.append(float(p.fx)) or False)
        return out, int(rep.status)
    except error as e:
        return out, int(e.status)


def test_bf16_x_poisson_run_matches_jax(poisson_512):
    """The port's run of the JAX package's bfloat16-X configuration (512 x
    64, c = 5 on [1, 64), Armijo, epsilon 1e-3, 20 iterations) against
    JAX's: the same iterations and final status (both end on "gx not
    changed" here, the residual rounded to bfloat16), fx per iteration rel
    1e-4 up to 15, and the final fx within 2e-2 of the float32 run, as
    tests/test_owlqn_logistic.py:83-86 holds it."""
    X, Xb, y = poisson_512
    bt, bj = _poisson_builders()
    x0 = torch.zeros(BF16_NCOL)
    tr_t, status_t = _poisson_trace(bt, x0, interop.logistic_objective(Xb, y, "cpu"),
                                    lbfgs_torch.LbfgsError)
    tr_j, status_j = _poisson_trace(
        bj, jnp.zeros(BF16_NCOL, jnp.float32),
        j_log.make_objective(jnp.asarray(Xb), jnp.asarray(y), precision=None),
        lbfgs_tpu.LbfgsError)
    assert (len(tr_t), status_t) == (len(tr_j), status_j)
    for i in range(min(15, len(tr_j))):
        assert tr_t[i] == pytest.approx(tr_j[i], rel=1e-4), i
    tr32, _ = _poisson_trace(bt, x0, interop.logistic_objective(X, y, "cpu"),
                             lbfgs_torch.LbfgsError)
    assert np.isfinite(tr_t[-1])
    assert abs(tr_t[-1] - tr32[-1]) <= 2e-2 * abs(tr32[-1])


def test_bf16_x_runs_through_minimize_jit(poisson_512):
    """The whole-run loop ends where the step-at-a-time one does."""
    X, Xb, y = poisson_512
    bt, _ = _poisson_builders()
    fn = interop.logistic_objective(Xb, y, "cpu")
    tr, status = _poisson_trace(bt, torch.zeros(BF16_NCOL), fn, lbfgs_torch.LbfgsError)
    st = t_minimize_jit(bt.param, torch.zeros(BF16_NCOL), fn, return_state=True)
    # the fatal propagate counts its iteration and reports no progress
    assert (st.k, int(st.status), float(st.prob.fx)) == (len(tr) + 1, status, tr[-1])


@pytest.mark.parametrize("case", ["y_bf16", "x_bf16_f64_vectors", "x_f16", "x_fp8"])
def test_poisson_refuses_other_dtype_mixes(case):
    X = torch.zeros(4, 3)
    y = torch.zeros(4)
    args, rule = {
        "y_bf16": ((X.bfloat16(), y.bfloat16()), r"over y torch\.bfloat16"),
        "x_bf16_f64_vectors": ((X.bfloat16(), y.double()), "takes float32 vectors"),
        "x_f16": ((X.half(), y), "no float16 or fp8 X"),
        "x_fp8": ((X.to(torch.float8_e4m3fn), y), "no float16 or fp8 X"),
    }[case]
    with pytest.raises(NotImplementedError, match=rule):
        t_log.make_objective(*args)


# ---------------------------------------------------------------------------
# The native backend
# ---------------------------------------------------------------------------


def rosen_seq(x, g):
    """The reference closure (src/lib.rs:79-94), sequential accumulation
    (tests/test_native_parity.py:27-39)."""
    n = len(x)
    fx = 0.0
    for i in range(0, n, 2):
        t1 = 1.0 - x[i]
        t2 = 10.0 * (x[i + 1] - x[i] * x[i])
        g[i + 1] = 20.0 * t2
        g[i] = -2.0 * (x[i] * g[i + 1] + t1)
        fx += t1 * t1 + t2 * t2
    return fx


def booth_np(x, g):
    fx = (x[0] + 2 * x[1] - 7) ** 2 + (2 * x[0] + x[1] - 5) ** 2
    g[0] = 10 * x[0] + 8 * x[1] - 34
    g[1] = 8 * x[0] + 10 * x[1] - 38
    return fx


def x0_np(n=100):
    x = np.zeros(n)
    x[0::2] = -1.2
    x[1::2] = 1.0
    return x


def _same_report(t, j):
    """The port's native report is the JAX package's, bit for bit: both
    come from the same source with the same flags."""
    assert (t.fx, t.xnorm, t.gnorm, t.neval, t.niter, t.status) == (
        j.fx, j.xnorm, j.gnorm, j.neval, j.niter, j.status)
    assert np.array_equal(t.x.numpy(), np.asarray(j.x))


def test_native_reproduces_recorded_lbfgs_trajectory():
    params = dict(constrain_step_size=False)
    rep = t_native.minimize_native(TParams(**params), x0_np(), rosen_seq)
    assert rep.fx == pytest.approx(GOLDEN_FX, rel=1e-9)
    assert rep.gnorm == pytest.approx(GOLDEN_GNORM, rel=1e-9)
    assert rep.niter == 38
    _same_report(rep, j_minimize_native(JParams(**params), x0_np(), rosen_seq))


def test_native_reproduces_recorded_owlqn_trajectory():
    r1 = t_native.minimize_native(TParams(constrain_step_size=False), x0_np(), rosen_seq)
    x1 = r1.x.numpy().copy()
    rep = t_native.minimize_native(
        TParams(orthantwise=TOw(1.0, 0, 99), constrain_step_size=False), x1, rosen_seq)
    assert rep.fx == pytest.approx(OWLQN_FX, rel=1e-12)
    assert float(rep.x[0]) == pytest.approx(OWLQN_X0, rel=1e-8)
    assert float(rep.x[1]) == pytest.approx(OWLQN_X1, rel=1e-8)
    assert rep.niter == 172
    _same_report(rep, j_minimize_native(
        JParams(orthantwise=JOw(1.0, 0, 99), constrain_step_size=False), x1, rosen_seq))


def test_native_booth():
    rep = t_native.minimize_native(TParams(), np.array([-1.2, 1.0]), booth_np)
    assert float(rep.x[0]) == pytest.approx(1.0, abs=1e-6)
    assert float(rep.x[1]) == pytest.approx(3.0, abs=1e-6)
    _same_report(rep, j_minimize_native(JParams(), np.array([-1.2, 1.0]), booth_np))


def test_native_cancellation_and_caps():
    seen = []

    def progress(p):
        seen.append((p.niter, p.x.dtype))
        return p.niter >= 3

    rep = t_native.minimize_native(TParams(), x0_np(10), rosen_seq, progress=progress)
    assert rep.niter == 3 and seen[-1] == (3, torch.float64)
    _same_report(rep, j_minimize_native(JParams(), x0_np(10), rosen_seq,
                                        progress=lambda p: p.niter >= 3))
    rep = t_native.minimize_native(TParams(max_iterations=5), x0_np(10), rosen_seq)
    assert rep.niter == 5
    assert rep.status == 2


def test_native_rosenbrock_evaluator_matches_jax():
    params = dict(max_iterations=12)
    x0 = x0_np(1 << 10)
    _same_report(t_native.minimize_native_rosenbrock(TParams(**params), x0),
                 j_native_rosenbrock(JParams(**params), x0))


@pytest.mark.parametrize("shape", ["value_and_grad", "scalar", "closure"])
def test_builder_native_backend_routing(shape):
    """``minimize(..., backend="native")`` runs the C++ core with each
    objective shape: the recorded trajectory through the builder."""
    def scalar(x):
        return t_rosen._plain_value_and_grad(x)[0]

    def closure(x, g):
        fx, gx = t_rosen._plain_value_and_grad(x)
        g.copy_(gx)
        return float(fx)

    fn = {"value_and_grad": t_rosen.value_and_grad, "scalar": scalar,
          "closure": closure}[shape]
    x0 = t_rosen.initial_point(100, device="cpu")
    rep = lbfgs_torch.lbfgs().with_constrain_step_size(False).minimize(x0, fn,
                                                                       backend="native")
    assert rep.fx == pytest.approx(GOLDEN_FX, rel=1e-6)
    assert rep.niter == 38
    assert rep.x.dtype == torch.float64 and rep.x.device.type == "cpu"


def test_native_backend_does_not_mutate_caller_x0():
    x0 = t_rosen.initial_point(100, device="cpu")
    before = x0.clone()
    lbfgs_torch.lbfgs().minimize(x0, t_rosen.value_and_grad, backend="native")
    assert torch.equal(x0, before)
    x1 = x0_np()
    t_native.minimize_native(TParams(), x1, rosen_seq)
    np.testing.assert_array_equal(x1, x0_np())


def test_native_library_is_built_into_the_package_build_dir():
    path = t_native.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.exists()
    assert not str(path).startswith(os.path.join(REPO, "lbfgs_tpu"))


def test_unknown_backend_is_a_value_error():
    with pytest.raises(ValueError, match="native"):
        lbfgs_torch.lbfgs().minimize(t_rosen.initial_point(10, device="cpu"),
                                     t_rosen.value_and_grad, backend="jax")


# ---------------------------------------------------------------------------
# The scan two-loop
# ---------------------------------------------------------------------------


def _rand_ring(seed, m=6, n=40):
    rng = np.random.RandomState(seed)
    S, Y = rng.randn(m, n), rng.randn(m, n)
    ys = np.einsum("ij,ij->i", S, Y)
    alpha = rng.randn(m)
    d, gamma = rng.randn(n), abs(rng.randn()) + 0.1
    return S, Y, ys, alpha, d, gamma


def _scan_both(S, Y, ys, alpha, d, gamma, bound, end, hdtype=None):
    m = S.shape[0]
    z = np.zeros((m, m))
    jh = JHist(s=jnp.asarray(S, hdtype), y=jnp.asarray(Y, hdtype), ys=jnp.asarray(ys),
               alpha=jnp.asarray(alpha), sy=jnp.asarray(z), yy=jnp.asarray(z))
    rj, aj = jsol.two_loop_scan(jh, jnp.asarray(d), jnp.asarray(gamma), jnp.int32(bound),
                                jnp.int32(end))
    tt = lambda a: interop._tensor(np.asarray(a), "cpu")
    hist = THist(s=tt(jh.s), y=tt(jh.y), ys=tt(ys), alpha=tt(alpha), sy=tt(z), yy=tt(z))
    rt, at = tsol.two_loop_scan(hist, tt(d), torch.tensor(gamma, dtype=torch.float64),
                                bound, end)
    return (rt, at), (rj, aj)


@pytest.mark.parametrize("bound,end", [(1, 0), (3, 2), (6, 5), (6, 1)]
                         + [(b, e) for b in (0, 1, 2, 4, 6) for e in (0, 3, 5)])
def test_two_loop_scan_matches_jax(bound, end):
    """The cases of tests/test_two_loop.py:35-92 (bounds, ends, bound 0),
    float64: the direction and the ring-ordered alphas, rel 1e-12."""
    ring = _rand_ring(bound * 7 + end)
    (rt, at), (rj, aj) = _scan_both(*ring, bound, end)
    _close(rt, rj, "r", 1e-12)
    _close(at, aj, "alpha", 1e-12)
    if bound == 0:
        _, _, _, alpha, d, gamma = ring
        assert torch.equal(at, torch.from_numpy(alpha))
        _close(rt, gamma * d, "gamma * d", 1e-15)


def test_two_loop_scan_widens_a_bfloat16_ring():
    S, Y, ys, alpha, d, gamma = _rand_ring(3)
    (rt, at), (rj, aj) = _scan_both(S, Y, ys, alpha, d, gamma, 4, 2, jnp.bfloat16)
    _close(rt, rj, "r", 1e-12)
    _close(at, aj, "alpha", 1e-12)


@pytest.mark.parametrize("entry", ["minimize", "minimize_jit"])
def test_scan_reproduces_recorded_trajectory(entry):
    """tests/test_native_parity.py:69-80 through the port's kernels' plain
    versions: 38 iterations, fx rel 1e-3, gnorm rel 1e-6."""
    b = lbfgs_torch.lbfgs().with_compact_two_loop(False).with_constrain_step_size(False)
    rep = getattr(b, entry)(t_rosen.initial_point(100, device="cpu"), t_rosen.value_and_grad)
    assert rep.fx == pytest.approx(GOLDEN_FX, rel=1e-3)
    assert rep.gnorm == pytest.approx(GOLDEN_GNORM, rel=1e-6)
    assert rep.niter == 38


def test_scan_matches_native_current_defaults():
    """tests/test_native_parity.py:83-94: 35 iterations, x rtol 1e-6."""
    rep_n = t_native.minimize_native(TParams(), x0_np(), rosen_seq)
    rep = lbfgs_torch.lbfgs().with_compact_two_loop(False).minimize(
        t_rosen.initial_point(100, device="cpu"), t_rosen.value_and_grad)
    assert rep.niter == rep_n.niter == 35
    assert rep.fx == pytest.approx(rep_n.fx, rel=1e-6)
    assert rep.gnorm == pytest.approx(rep_n.gnorm, rel=1e-6)
    np.testing.assert_allclose(rep.x.numpy(), rep_n.x.numpy(), rtol=1e-6)


SCAN_BRANCHES = {
    "plain": lambda b: b,
    "owlqn": lambda b: b.with_orthantwise(1.0, 0, 99),
    "damped": lambda b: b.with_damping(True),
    "damped_owlqn": lambda b: b.with_damping(True).with_orthantwise(1.0, 0, 99),
}


@pytest.mark.parametrize("objective", ["fused", "generic"])
@pytest.mark.parametrize("branch", list(SCAN_BRANCHES))
def test_scan_trajectory_matches_jax(branch, objective):
    """Per iteration against JAX's ``minimize`` with compact_two_loop=False,
    15 iterations, float64: fx and gnorm rel 1e-10.  OWL-QN starts from the
    L-BFGS solution, as the recorded OWL-QN run does."""
    fn = {"fused": t_rosen.value_and_grad, "generic": t_rosen._plain_value_and_grad}[objective]
    x0 = t_rosen.initial_point(100, device="cpu")
    if "owlqn" in branch:
        x0 = lbfgs_torch.lbfgs().with_constrain_step_size(False).minimize(x0, fn).x
    mod = SCAN_BRANCHES[branch]
    tr_t, _ = _trace(mod(lbfgs_torch.lbfgs().with_compact_two_loop(False)), x0, fn, 16)
    tr_j, _ = _trace(mod(lbfgs_tpu.lbfgs().with_compact_two_loop(False)),
                     jnp.asarray(x0.numpy()), j_rosen.value_and_grad, 16)
    assert len(tr_t) == len(tr_j) == 16
    for i, ((ft, gt), (fj, gj)) in enumerate(zip(tr_t, tr_j)):
        assert ft == pytest.approx(fj, rel=1e-10), i
        assert gt == pytest.approx(gj, rel=1e-10), i


@pytest.mark.parametrize("branch", list(SCAN_BRANCHES))
def test_scan_entry_points_agree(branch):
    """``minimize_jit`` (the lean state) ends where ``minimize`` does on
    every scan branch, bit for bit."""
    x0 = t_rosen.initial_point(100, device="cpu")
    if "owlqn" in branch:
        x0 = lbfgs_torch.lbfgs().with_constrain_step_size(False).minimize(
            x0, t_rosen.value_and_grad).x
    b = SCAN_BRANCHES[branch](lbfgs_torch.lbfgs().with_compact_two_loop(False)
                              .with_max_iterations(50))
    rep = b.minimize(x0, t_rosen.value_and_grad)
    rep_jit = b.minimize_jit(x0, t_rosen.value_and_grad)
    assert (rep_jit.niter, rep_jit.fx, rep_jit.damping_cases) == (
        rep.niter, rep.fx, rep.damping_cases)
    assert torch.equal(rep_jit.x, rep.x)


def test_scan_path_runs_no_ring_kernel():
    """The scan branch runs the trial and probe kernels' plain versions and
    nothing that reads the ring: no epilogue, pair + Gram or combine."""
    k = t_rosen.value_and_grad.kernels
    refs = (k.trial_pair_gram_ref, k.owlqn_trial_pair_gram_ref, k.combine_probe_ref,
            k.combine_ow_probe_ref, t_fused.combine_ref, t_fused.combine_fix_ref,
            t_fused.combine_ow_ref, t_fused.pair_gram_sd_ref, t_fused.pair_gram_xg_ref)
    before = [f.calls for f in refs]
    trial = k.trial_ref.calls
    lbfgs_torch.lbfgs().with_compact_two_loop(False).with_constrain_step_size(False).minimize(
        t_rosen.initial_point(100, device="cpu"), t_rosen.value_and_grad)
    assert [f.calls for f in refs] == before
    assert k.trial_ref.calls > trial


# ---------------------------------------------------------------------------
# Float16 history
# ---------------------------------------------------------------------------

F16_N, F16_ITERS = 1000, 15
F16_RUNS = {"plain": None, "owlqn": (1.0, 0, F16_N - 1)}


@pytest.fixture(scope="module")
def f16_states():
    """The JAX package's float16-history run per iteration (n = 1000
    Rosenbrock, float32 vectors), as numpy states."""
    cache = {}

    def get(run):
        if run not in cache:
            ow = JOw(*F16_RUNS[run]) if F16_RUNS[run] else None
            pdef = JDef(value_and_grad=j_rosen.value_and_grad, owlqn=ow)
            params = JParams(history_dtype="float16", orthantwise=ow)
            step = jax.jit(lambda st: jsol.propagate_hot(pdef, params, st))
            x0 = j_rosen.initial_point(F16_N, dtype=jnp.float32)
            st = jsol.start_state(jsol.init_state(pdef, params, x0), params)
            states = [jax.tree.map(np.asarray, st)]
            for _ in range(F16_ITERS):
                st = step(st)
                states.append(jax.tree.map(np.asarray, st))
            cache[run] = states
        return cache[run]

    return get


@pytest.mark.parametrize("k", range(1, F16_ITERS + 1))
@pytest.mark.parametrize("run", list(F16_RUNS))
def test_float16_history_propagate_matches_jax(f16_states, run, k):
    """One port iteration from the JAX package's own float16-history state
    k - 1 against its state k: fx rel 1e-5, the iterate and the stored
    ring row within float32 and float16 rounding.  Per iteration from a
    common state, since float32 Rosenbrock amplifies the two packages'
    summation orders past a few iterations."""
    ow = TOw(*F16_RUNS[run]) if F16_RUNS[run] else None
    pdef = TDef(value_and_grad=t_rosen.value_and_grad, owlqn=ow)
    params = TParams(history_dtype="float16", orthantwise=ow)
    states = f16_states(run)
    st = interop.state_from_jax(states[k - 1], "cpu")
    assert st.hist.s.dtype == torch.float16
    calls = (t_fused.pair_gram_sd_ref.calls, t_fused.combine_ref.calls,
             t_fused.combine_ow_ref.calls)
    out = tsol.propagate_hot(pdef, params, st)
    # the composed route: no ring kernel's plain version stood in
    assert (t_fused.pair_gram_sd_ref.calls, t_fused.combine_ref.calls,
            t_fused.combine_ow_ref.calls) == calls
    ref = states[k]
    assert out.status == int(ref.status) == 0
    assert (out.k, out.end, out.prob.neval) == (int(ref.k), int(ref.end), int(ref.prob.neval))
    assert out.hist.s.dtype == torch.float16
    assert float(out.prob.fx) == pytest.approx(float(ref.prob.fx), rel=1e-5)
    _close(out.prob.x, ref.prob.x, "x", 1e-5)
    row = int(ref.end) - 1
    _close(out.hist.y[row], np.asarray(ref.hist.y).reshape(params.m, -1)[row], "y", 2e-3)


@pytest.mark.parametrize("entry", ["minimize", "minimize_jit"])
@pytest.mark.parametrize("setting", ["plain", "owlqn", "damped"])
def test_float16_history_runs_through_both_entry_points(entry, setting):
    b = lbfgs_torch.lbfgs().with_history_dtype("float16").with_max_iterations(30)
    b = {"plain": b, "owlqn": b.with_orthantwise(1.0, 0, F16_N - 1),
         "damped": b.with_damping(True)}[setting]
    x0 = t_rosen.initial_point(F16_N, torch.float32, device="cpu")
    rep = getattr(b, entry)(x0, t_rosen.value_and_grad)
    assert rep.niter == 30 and np.isfinite(rep.fx)
    assert rep.fx < float(t_rosen._plain_value_and_grad(x0)[0])


def test_float16_history_keeps_the_kernels_dtype_rules():
    """The ring kernels still refuse (float32, float16): the solver takes
    the composed route instead of widening the set."""
    assert (torch.float32, torch.float16) not in t_fused.SUPPORTED
    assert not t_fused.can_pair_gram(torch.zeros(8), torch.zeros(2, 8, dtype=torch.float16))


# ---------------------------------------------------------------------------
# Checkpoint
# ---------------------------------------------------------------------------


def _same_state(a, b):
    ia, ib = dict(fields(a)), dict(fields(b))
    assert ia.keys() == ib.keys()
    for key, va in ia.items():
        vb = ib[key]
        if isinstance(va, torch.Tensor):
            assert va.dtype == vb.dtype and va.shape == vb.shape, key
            assert torch.equal(va.reshape(-1).view(torch.uint8),
                               vb.reshape(-1).view(torch.uint8)), key
        elif isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), key
        else:
            assert type(va) is type(vb), key
            assert (va == vb) or (va != va and vb != vb), key


CHECKPOINTS = {
    "f64": (TParams(), torch.float64),
    "f32_bf16_ring": (TParams(history_dtype="bfloat16", constrain_step_size=False),
                      torch.float32),
    "f32_f16_ring": (TParams(history_dtype="float16"), torch.float32),
    "owlqn_wide": (TParams(orthantwise=TOw(1.0, 0, 255), fx_wide=True,
                           fx_delta_enabled=True, past=3), torch.float32),
}


@pytest.mark.parametrize("lean", [False, True], ids=["full", "lean"])
@pytest.mark.parametrize("case", list(CHECKPOINTS))
def test_checkpoint_round_trip_is_bit_exact(tmp_path, case, lean):
    from lbfgs_torch.core import ProblemDef

    params, dtype = CHECKPOINTS[case]
    pdef = ProblemDef(t_rosen.value_and_grad, params.orthantwise)
    x0 = t_rosen.initial_point(256, dtype, device="cpu")
    st = tsol.start_state(tsol.init_state(pdef, params, x0, lean=lean), params)
    for _ in range(7):
        st = tsol.propagate_hot(pdef, params, st)
    path = str(tmp_path / "state.npz")
    save_state(path, st)
    like = tsol.init_state(pdef, params, x0, lean=lean)
    _same_state(load_state(path, like), st)


def test_checkpoint_restores_bf16_history_into_f32_template(tmp_path):
    x0 = t_rosen.initial_point(256, torch.float32, device="cpu")
    saver = TState.build(TParams(history_dtype="bfloat16"), x0, t_rosen.value_and_grad)
    for _ in range(4):
        saver.propagate()
    path = str(tmp_path / "bf16.npz")
    save_state(path, saver.state)
    loader = TState.build(TParams(), x0, t_rosen.value_and_grad)
    st = load_state(path, loader.state)
    assert st.hist.s.dtype == torch.float32
    assert torch.equal(st.hist.s, saver.state.hist.s.float())
    loader.restore(st)
    for _ in range(3):
        assert np.isfinite(loader.propagate().fx)


@pytest.mark.parametrize("other", ["m", "n", "owlqn"])
def test_checkpoint_mismatch_raises(tmp_path, other):
    x0 = t_rosen.initial_point(256, device="cpu")
    saver = TState.build(TParams(m=6), x0, t_rosen.value_and_grad)
    saver.propagate()
    saver.propagate()
    path = str(tmp_path / "m6.npz")
    save_state(path, saver.state)
    loader = {
        "m": lambda: TState.build(TParams(m=4), x0, t_rosen.value_and_grad),
        "n": lambda: TState.build(TParams(), t_rosen.initial_point(128, device="cpu"),
                                  t_rosen.value_and_grad),
        "owlqn": lambda: TState.build(TParams(orthantwise=TOw(1.0, 0, 255)), x0,
                                      t_rosen.value_and_grad),
    }[other]()
    with pytest.raises(ValueError, match="element count" if other != "owlqn" else "slot"):
        load_state(path, loader.state)


@pytest.mark.parametrize("setting", ["plain", "owlqn_damped"])
def test_resumed_run_ends_as_the_uninterrupted_run(tmp_path, setting):
    params = TParams(history_dtype="bfloat16", constrain_step_size=False, epsilon=0.0)
    if setting == "owlqn_damped":
        params = params.replace(orthantwise=TOw(1.0, 0, 511), damping=True)
    x0 = t_rosen.initial_point(512, torch.float32, device="cpu")
    whole = TState.build(params, x0, t_rosen.value_and_grad)
    for _ in range(20):
        whole.propagate()
    first = TState.build(params, x0, t_rosen.value_and_grad)
    for _ in range(10):
        first.propagate()
    path = str(tmp_path / "at10.npz")
    save_state(path, first.state)
    resumed = TState.build(params, x0, t_rosen.value_and_grad)
    resumed.restore(load_state(path, resumed.state))
    for _ in range(10):
        resumed.propagate()
    _same_state(resumed.state, whole.state)


# ---------------------------------------------------------------------------
# The pytree front end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jit_driver", [False, True], ids=["minimize", "jit_driver"])
def test_minimize_pytree_matches_jax(jit_driver):
    """Least squares over {"w": [4, 4], "b": [4]} with fixed numpy data,
    float64: the same niter, fx rel 1e-10, leaves rtol 1e-8."""
    rng = np.random.default_rng(3)
    A, B = rng.standard_normal((20, 4)), rng.standard_normal((20, 4))
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)

    def loss_t(p):
        return torch.sum((At @ p["w"] + p["b"] - Bt) ** 2)

    def loss_j(p):
        return jnp.sum((jnp.asarray(A) @ p["w"] + p["b"] - jnp.asarray(B)) ** 2)

    rep_t, out_t = t_minimize_pytree(
        loss_t, {"w": torch.zeros(4, 4, dtype=torch.float64),
                 "b": torch.zeros(4, dtype=torch.float64)},
        lbfgs_torch.lbfgs(), jit_driver=jit_driver)
    rep_j, out_j = j_minimize_pytree(loss_j, {"w": jnp.zeros((4, 4)), "b": jnp.zeros(4)},
                                     lbfgs_tpu.lbfgs(), jit_driver=jit_driver)
    assert rep_t.niter == rep_j.niter
    assert rep_t.fx == pytest.approx(float(rep_j.fx), rel=1e-10)
    assert out_t["w"].shape == (4, 4) and out_t["b"].shape == (4,)
    for k in ("w", "b"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), rtol=1e-8)


def test_ravel_pytree_round_trips_shapes_and_dtypes():
    from lbfgs_torch.pytree_api import ravel_pytree

    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(2, dtype=torch.float64), torch.zeros(())]}
    flat, unravel = ravel_pytree(tree)
    assert flat.dtype == torch.float64 and flat.shape == (9,)
    back = unravel(flat)
    assert back["a"].dtype == torch.float32 and back["a"].shape == (2, 3)
    assert torch.equal(back["a"], tree["a"]) and back["b"][1].shape == ()


@pytest.mark.cuda
def test_bf16_matvec_on_card_matches_widened_product():
    """On the card the products are ``torch.mm`` with a float32 output over
    X as stored: normwise within 1e-4 of the widened product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's route has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((256, 4096), generator=g, device="cuda").bfloat16()
    v = torch.randn(4096, generator=g, device="cuda")
    r = torch.randn(256, generator=g, device="cuda")
    for A, w in ((X, v), (X.T, r)):
        out = t_log.bf16_matvec(A, w)
        ref = A.float() @ w.bfloat16().float()
        assert out.dtype == torch.float32
        assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-4
