"""The port's batched runner under the wide objective scalar, the scan
two-loop and a float16 history, against the JAX package's
(``lbfgs_tpu.batched``, whose vmap runs every solver setting) and against
its own solo runs, on the CPU.

  * the scan two-loop in float64, eight perturbed instances, against the
    JAX batched run after 15 iterations (``_hold``: the same k,
    evaluations, status, ring row, ``ncall`` and ``ls_status``; fx, the
    entry step, dginit and the carried norms rel 1e-9; the rings, Gram
    blocks and alphas rtol 1e-7): plain capped and uncapped, OWL-QN,
    damped, damped OWL-QN, and on a generic objective; the batched
    ``solver.two_loop_scan_batched`` per instance against the solo
    recursion;
  * the wide scalar and the float16 ring in float32, one batched
    ``propagate`` at a time from the JAX package's own batched state
    (``interop.batched_state_from_jax``) over iterations 1-15: the same
    search per instance, fx rel 1e-6 (float64 under the wide scalar), the
    float32 vectors rel 1e-4 (as ``tests/test_torch_wide.py`` holds the solo
    wide run); plain capped and uncapped (K15 b's wide probe), OWL-QN,
    damped and a generic objective under the wide scalar, plain, OWL-QN and
    damped over a float16 ring;
  * a wide JAX batched state carried across (fx, pf and the carried
    probe's ft keep float64, bit for bit), wide against default batched
    runs, and float64 vectors, which the wide mode leaves bit for bit;
  * each instance against the port's solo run; the launch path (wide: one
    K1 b, under OWL-QN one K7 b and one K10 b, at the init; scan and
    float16: one K1 b or K7 b per iteration and no K3 b, K4 b, K5 b, K13 b
    or K14 b) and the reads.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbfgs_torch import batched as t_batched
from lbfgs_torch import interop
from lbfgs_torch import lbfgs as t_lbfgs
from lbfgs_torch import solver as t_solver
from lbfgs_torch.core import History, to_host
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import fused as t_fused
from lbfgs_tpu import lbfgs as j_lbfgs
from lbfgs_tpu import solver as j_solver
from lbfgs_tpu.core import ProblemDef as JDef
from lbfgs_tpu.models import rosenbrock as j_rosen
from test_torch_batched import B, _t
from test_torch_batched_generic import T_PLAIN, _both, _hold, j_plain
from test_torch_batched_owlqn import OW, PERTURBED

K = t_rosen.value_and_grad.kernels


@pytest.fixture(autouse=True)
def _quiet():
    # ``with_orthantwise``'s one-line notice that OWL-QN runs backtracking only
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


_ow = lambda b: b.with_orthantwise(*OW)
_unc = lambda b: b.with_constrain_step_size(False)
_damp = lambda b: b.with_damping(True)
_scan = lambda b: b.with_compact_two_loop(False)


# ---------------------------------------------------------------------------
# the scan two-loop against the JAX package (float64)
# ---------------------------------------------------------------------------

SCAN_RUNS = {
    "capped": _scan,
    "uncapped": lambda b: _unc(_scan(b)),
    "owlqn": lambda b: _ow(_scan(b)),
    "damped": lambda b: _damp(_scan(b)),
    "owlqn_damped": lambda b: _ow(_damp(_scan(b))),
}


@pytest.mark.parametrize("run", list(SCAN_RUNS))
def test_scan_matches_jax_15_iterations(run):
    j, t = _both(SCAN_RUNS[run], fn=(j_rosen.value_and_grad, t_rosen.value_and_grad))
    _hold(j, t)
    assert (t.k == 15).sum() >= B - 1


@pytest.mark.parametrize("ow", [False, True], ids=["plain", "owlqn"])
def test_generic_scan_matches_jax_15_iterations(ow):
    j, t = _both(lambda b: _ow(_scan(b)) if ow else _scan(b))
    _hold(j, t)


def test_two_loop_scan_batched_matches_solo():
    """The batched recursion per instance against ``two_loop_scan`` on that
    instance alone: the direction and the alphas rel 1e-13 (row sums
    against dots), the unused ring slots' alphas untouched."""
    rng = np.random.RandomState(7)
    Bk, m, n = 5, 6, 40
    S, Y = _t(rng.randn(Bk, m, n)), _t(rng.randn(Bk, m, n))
    ys = _t(1.0 + rng.rand(Bk, m))
    hist = History(s=S, y=Y, ys=ys, alpha=_t(rng.randn(Bk, m)), sy=_t(np.zeros((Bk, m, m))),
                   yy=_t(np.zeros((Bk, m, m))))
    d, gamma = _t(rng.randn(Bk, n)), _t(0.5 + rng.rand(Bk))
    for bound, end in ((0, 0), (3, 1), (6, 4)):
        q, alpha = t_solver.two_loop_scan_batched(hist, d, gamma, bound, end)
        for b in range(Bk):
            hb = History(s=S[b], y=Y[b], ys=ys[b], alpha=hist.alpha[b], sy=hist.sy[b],
                         yy=hist.yy[b])
            qs, alphas = t_solver.two_loop_scan(hb, d[b], gamma[b], bound, end)
            np.testing.assert_allclose(q[b].numpy(), qs.numpy(), rtol=1e-13, atol=1e-13)
            np.testing.assert_allclose(alpha[b].numpy(), alphas.numpy(), rtol=1e-13,
                                       atol=1e-13)
        if bound == 0:
            assert torch.equal(q, d * gamma[:, None]) and torch.equal(alpha, hist.alpha)


# ---------------------------------------------------------------------------
# one propagate per iteration from the JAX package's batched state (float32)
# ---------------------------------------------------------------------------

N32, B32, ITERS = 256, 4, 15


def _x0_f32():
    rng = np.random.RandomState(3)
    base = np.asarray(j_rosen.initial_point(N32, dtype=jnp.float32))
    return (base[None, :] + 0.05 * rng.randn(B32, N32)).astype(np.float32)


_wide = lambda b: b.with_fx_wide()
_f16 = lambda b: b.with_history_dtype("float16")
_ow32 = lambda b: b.with_orthantwise(1.0, 0, N32 - 1)

#: (configuration, objective: "factory" or "generic")
STEP_RUNS = {
    "wide_capped": (_wide, "factory"),
    "wide_uncapped": (lambda b: _unc(_wide(b)), "factory"),
    "wide_owlqn": (lambda b: _ow32(_wide(b)), "factory"),
    "wide_damped": (lambda b: _damp(_wide(b)), "factory"),
    "wide_generic": (_wide, "generic"),
    "float16": (_f16, "factory"),
    "float16_owlqn": (lambda b: _ow32(_f16(b)), "factory"),
    "float16_damped": (lambda b: _damp(_f16(b)), "factory"),
}
OBJECTIVES = {"factory": (j_rosen.value_and_grad, t_rosen.value_and_grad),
              "generic": (j_plain, T_PLAIN)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(STEP_RUNS))
def jax_batched_states(request):
    """The JAX package's batched states after its k == 1 bookkeeping and
    after each of ``ITERS`` vmapped iterations (no instance stops: epsilon
    0), as its batched runner steps them."""
    configure, obj = STEP_RUNS[request.param]
    jfn, tfn = OBJECTIVES[obj]
    jp = configure(j_lbfgs()).with_epsilon(0.0).param
    pdef = JDef(value_and_grad=jfn, owlqn=jp.orthantwise)
    init = jax.jit(jax.vmap(lambda x0: j_solver.start_state(
        j_solver.init_state(pdef, jp, x0), jp)))
    step = jax.jit(jax.vmap(lambda st: j_solver.propagate_hot(pdef, jp, st)))
    st = init(jnp.asarray(_x0_f32()))
    states = [_np(st)]
    for _ in range(ITERS):
        st = step(st)
        states.append(_np(st))
    tp = configure(t_lbfgs()).with_epsilon(0.0).param.replace_ls(warn_ascent=False)
    return request.param, tp, tfn, states


def _rel(t, j, what, rel):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    j = np.asarray(j, np.float64).reshape(t.shape)
    np.testing.assert_allclose(t, j, rtol=rel, atol=rel * max(np.abs(j).max(), 1e-300),
                               err_msg=what)


def test_batched_propagate_matches_jax(jax_batched_states):
    """Iterations 1-15, each from the JAX package's own batched state: the
    same search per instance (evaluations, ``ncall``, status), fx rel 1e-6
    in the objective scalar's dtype (float64 under the wide scalar), the
    float32 vectors rel 1e-4 of each array's largest (the two packages sum
    in other orders, and the direction's two-loop cancels); over a float16
    ring 1e-3, where the direction combines half-precision rows whose
    products part in their last bits, and one element of d in 1024 parts
    by up to 5.4e-4 of the array's largest."""
    name, params, fn, states = jax_batched_states
    wide = name.startswith("wide")
    vec_rel = 1e-3 if name.startswith("float16") else 1e-4
    live = np.ones(B32, bool)
    for k in range(1, ITERS + 1):
        st = interop.batched_state_from_jax(states[k - 1], "cpu")
        assert st.fx.dtype == (np.float64 if wide else np.float32)
        out = t_batched.propagate(params, fn, st, live)
        ref = interop.batched_state_from_jax(states[k], "cpu")
        assert out.fx.dtype == ref.fx.dtype and out.x.dtype == torch.float32
        for field in ("status", "ncall", "neval", "ls_status", "end"):
            assert np.array_equal(getattr(out, field), getattr(ref, field)), (name, k, field)
        _rel(out.fx, ref.fx, f"{name} fx {k}", 1e-6)
        for field in ("x", "gx", "d") + (("pg",) if out.pg is not None else ()):
            _rel(getattr(out, field), getattr(ref, field), f"{name} {field} {k}", vec_rel)
        if name.startswith("float16"):
            assert out.hist.s.dtype == torch.float16


def test_wide_state_carried_across():
    """A wide JAX batched state (float32 vectors, with the past/delta ring)
    comes across with fx and pf float64, bit for bit, and everything else
    float32; a carried probe's ft keeps float64 too.  The port's own wide
    run of the same batch carries the same dtypes, the combine+probe slot's
    ft float64 where its fusion runs (uncapped)."""
    x0b = jnp.asarray(_x0_f32())
    cfg = lambda b: _unc(b).with_fx_wide().with_fx_delta(1e-5, 3).with_fx_delta_enabled() \
        .with_epsilon(0.0).with_max_iterations(4)
    j = cfg(j_lbfgs()).minimize_batched(x0b, j_rosen.value_and_grad, return_state=True)
    st = interop.batched_state_from_jax(j, "cpu")
    for got, want in ((st.fx, j.prob.fx), (st.pf, j.pf)):
        want = np.asarray(want)
        assert got.dtype == want.dtype == np.float64
        assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    assert st.x.dtype == torch.float32 and st.gnorm2.dtype == st.step.dtype == np.float32
    wide_slot = (np.asarray(j.prob.fx), -np.asarray(j.prob.gnorm2), np.full(B32, -1.0,
                                                                            np.float32))
    carried = interop.batched_state_from_jax(j._replace(probe1=wide_slot), "cpu").probe1
    assert carried[0].dtype == np.float64 and carried[1].dtype == carried[2].dtype == np.float32
    assert np.array_equal(carried[0].view(np.uint64), st.fx.view(np.uint64))
    t = cfg(t_lbfgs()).minimize_batched(_t(np.asarray(x0b)), t_rosen.value_and_grad,
                                         return_state=True)
    assert t.fx.dtype == t.pf.dtype == t.probe1[0].dtype == np.float64
    assert np.array_equal(t.k, st.k) and np.array_equal(t.neval, st.neval)


# ---------------------------------------------------------------------------
# whole runs: wide against default, float64 vectors, the port's solo runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ow", [False, True], ids=["morethuente", "owlqn"])
def test_wide_against_default_batched(ow):
    """``tests/test_wide_fx.py:121-163`` batched: 12 iterations with the
    wide scalar against the default, per instance the same iterations and
    fx rel 1e-3; fx float64 [B] (the result dict too) and the vectors
    float32."""
    x0b = _t(_x0_f32())
    cfg = lambda b: (_ow32(b) if ow else b).with_epsilon(0.0).with_max_iterations(13)
    w = cfg(t_lbfgs()).with_fx_wide().minimize_batched(x0b, t_rosen.value_and_grad,
                                                       return_state=True)
    d = cfg(t_lbfgs()).minimize_batched(x0b, t_rosen.value_and_grad, return_state=True)
    assert w.fx.dtype == np.float64 and d.fx.dtype == np.float32
    assert w.x.dtype == w.gx.dtype == w.hist.y.dtype == torch.float32
    assert w.step.dtype == w.dg0.dtype == np.float32
    assert np.array_equal(w.k, d.k)
    np.testing.assert_allclose(w.fx, d.fx, rtol=1e-3)
    out = cfg(t_lbfgs()).with_fx_wide().minimize_batched(x0b, t_rosen.value_and_grad)
    assert out["fx"].dtype == torch.float64 and out["gnorm"].dtype == torch.float32


@pytest.mark.parametrize("ow", [False, True], ids=["plain", "owlqn"])
def test_wide_changes_nothing_for_float64_vectors(ow):
    x0b = _t(PERTURBED)
    runs = []
    for wide in (False, True):
        b = t_lbfgs().with_fx_wide(wide).with_max_iterations(25)
        runs.append((_ow(b) if ow else b).minimize_batched(x0b, t_rosen.value_and_grad,
                                                            return_state=True))
    a, w = runs
    for name in ("k", "neval", "fx", "status"):
        assert np.array_equal(getattr(a, name), getattr(w, name)), name
    assert torch.equal(a.x, w.x)


SOLO = {
    "wide": _wide,
    "wide_owlqn": lambda b: _ow32(_wide(b)),
    "wide_damped_uncapped": lambda b: _unc(_damp(_wide(b))),
    "scan": _scan,
    "scan_owlqn": lambda b: _ow32(_scan(b)),
    "float16": _f16,
    "float16_owlqn_damped": lambda b: _damp(_ow32(_f16(b))),
}


@pytest.mark.parametrize("run", list(SOLO))
def test_batched_settings_match_port_solo(run):
    """Each instance in float32 against its solo run (the whole-run loop)
    after 8 iterations: the same iterations, evaluations and status, fx of
    the same dtype and rel 1e-5 (the batched row sums and the solo dots
    part in the last bits: ~1e-7 here), over a float16 ring rel 1e-3 (the
    half-precision pairs carry those bits into the trajectory: 1.1e-4)."""
    x0b = _t(_x0_f32())
    opt = SOLO[run](t_lbfgs()).with_epsilon(0.0).with_max_iterations(9)
    st = opt.minimize_batched(x0b, t_rosen.value_and_grad, return_state=True)
    rel = 1e-3 if run.startswith("float16") else 1e-5
    for b in range(B32):
        so = opt.minimize_jit(x0b[b].clone(), t_rosen.value_and_grad, return_state=True)
        assert (so.k, so.prob.neval, so.status) == (int(st.k[b]), int(st.neval[b]),
                                                    int(st.status[b])), b
        assert float(st.fx[b]) == pytest.approx(float(so.prob.fx), rel=rel)
        assert type(so.prob.fx) is type(st.fx[b]), b


# ---------------------------------------------------------------------------
# the launch path and the reads
# ---------------------------------------------------------------------------

_NO_RING_KERNEL = (t_fused.combine_batched_ref, t_fused.combine_fix_batched_ref,
                   t_fused.combine_ow_batched_ref, t_fused.pair_gram_sd_batched_ref,
                   t_fused.pair_gram_xg_batched_ref, K.trial_pair_gram_batched_ref,
                   K.owlqn_trial_pair_gram_batched_ref, K.combine_probe_batched_ref,
                   K.combine_ow_probe_batched_ref)

#: (configuration, plain versions at the init, plain versions per
#: iteration, plain versions never called)
LAUNCH_PATHS = {
    "wide": (_wide, (K.trial_batched_ref,),
             (K.trial_pair_gram_batched_ref, t_fused.combine_batched_ref), ()),
    "wide_owlqn": (lambda b: _ow32(_wide(b)),
                   (K.owlqn_trial_batched_ref, t_fused.pseudo_gradient_norm_batched_ref),
                   (K.owlqn_trial_pair_gram_batched_ref, t_fused.combine_ow_batched_ref), ()),
    "scan": (_scan, (), (K.trial_batched_ref,), _NO_RING_KERNEL),
    "scan_owlqn": (lambda b: _ow32(_scan(b)), (t_fused.pseudo_gradient_norm_batched_ref,),
                   (K.owlqn_trial_batched_ref, t_fused.pseudo_gradient_norm_batched_ref),
                   _NO_RING_KERNEL),
    "float16": (_f16, (), (K.trial_batched_ref,), _NO_RING_KERNEL),
    "float16_owlqn": (lambda b: _ow32(_f16(b)), (t_fused.pseudo_gradient_norm_batched_ref,),
                      (K.owlqn_trial_batched_ref, t_fused.pseudo_gradient_norm_batched_ref),
                      _NO_RING_KERNEL),
}


@pytest.mark.parametrize("run", list(LAUNCH_PATHS))
def test_settings_launch_path_and_reads(run):
    """Wide: the init is one K1 b (under OWL-QN one K7 b and one K10 b),
    and the iterations run the epilogue route's kernels, no K1 b (K7 b);
    the default OWL-QN init one K10 b.
    Scan and float16: one K1 b (K7 b, then K10 b) per iteration, and no ring
    kernel (K3 b, K4 b, K5 b, K6 b, K12 b, K13 b, K14 b, K15 b, K16 b): the
    recursion, the pair + Gram pass and the combine run in torch ops.  Each
    trip one batched probe and one read, one read per iteration after the
    init's."""
    configure, at_init, per_iter, none = LAUNCH_PATHS[run]
    opt = configure(t_lbfgs()).with_epsilon(0.0).with_max_iterations(12)
    ow = opt.param.orthantwise is not None
    trips = K.owlqn_probe_pg_batched_ref if ow else K.probe_batched_ref
    every = list(dict.fromkeys((*at_init, *per_iter, *none, trips)))
    count = lambda: {f: f.calls for f in every}
    before, reads = count(), to_host.reads
    x0b = _t(_x0_f32())
    st0 = t_batched.init_state(opt.param, t_rosen.value_and_grad, x0b)
    after = count()
    assert {f: after[f] - before[f] for f in every} == {f: int(f in at_init) for f in every}
    assert to_host.reads - reads == 1
    st = t_batched.run(opt.param.replace_ls(warn_ascent=False), t_rosen.value_and_grad, st0)
    after = count()
    calls = {f: after[f] - before[f] for f in every}
    reads = to_host.reads - reads
    iters = int(st.k.max()) - 1
    assert iters == 11
    for f in (*at_init, *per_iter, *none):
        assert calls[f] == (f in at_init) + iters * (f in per_iter), f
    assert calls[trips] == reads - 1 - iters >= iters
