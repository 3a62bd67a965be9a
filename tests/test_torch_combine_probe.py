"""The combine+probe fusions K15 and K16 and the axpy + dot kernel K17 of
the PyTorch port against the JAX package.

On the CPU each wrapper runs its plain version; here those meet the JAX
package's plain references in float64 (rel 1e-12: the same arithmetic in
another summation order) and its Pallas kernels run through the
interpreter in float32 at the JAX tests' tolerances
(``tests/test_combine_probe.py:26-70,153-181``).  Then whole runs: the
solver fuses wherever the objective carries the fusion and the step is
not capped, and such a run equals the run of the same objective without
the fusion's hooks bit for bit (the plain versions compute the same
probe), with one plain probe fewer for each first trip that took the
carried (ft, g.d); it tracks the JAX package's fusion-on run
(``LBFGS_TPU_KERNELS=all``).  The case marked ``cuda`` holds the
hand-written kernels to their plain versions on the card.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import lbfgs_torch
from lbfgs_torch import interop
from lbfgs_torch import solver as tsol
from lbfgs_torch.core import ProblemDef as TDef
from lbfgs_torch.linesearch import carried
from lbfgs_torch.minimize import LbfgsState as TState
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.orthantwise import Orthantwise as TOW
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_tpu.minimize import LbfgsState as JState
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.ops import fused as j_fused
from lbfgs_tpu.orthantwise import Orthantwise as JOW
from lbfgs_tpu.params import LbfgsParams as JParams

M = 6
N_FUSED = j_fused.MIN_FUSED_N


def _t(a):
    return torch.from_numpy(np.array(a))


def _ring(H):
    m, n = H.shape
    return jnp.asarray(H).reshape(m, n // 128, 128)


def _inputs(n, seed, dtype):
    """g, x, S, Y, cs, cy as the JAX test makes them, x with exact zeros at
    every 7th element (the orthant's at-zero branch)."""
    rng = np.random.RandomState(seed)
    g = rng.randn(n).astype(dtype)
    x = np.where(np.arange(n) % 2 == 0, -1.2, 1.0).astype(dtype)
    x[::7] = 0.0
    S, Y = ((rng.randn(M, n) * 0.1).astype(dtype) for _ in range(2))
    cs, cy = ((rng.randn(M) * 0.1).astype(dtype) for _ in range(2))
    return g, x, S, Y, cs, cy


def _port_k15(g, x, S, Y, gamma, cs, cy, stp1):
    return t_rosen.combine_probe(_t(g), _t(x), _t(S), _t(Y), torch.tensor(gamma, dtype=_t(g).dtype),
                                 _t(cs), _t(cy), stp1)


def _port_k16(pg, x, S, Y, gamma, cs, cy, c, lo, hi, stp1):
    return t_rosen.combine_ow_probe(_t(pg), _t(x), _t(S), _t(Y),
                                    torch.tensor(gamma, dtype=_t(pg).dtype), _t(cs), _t(cy),
                                    c, lo, hi, stp1)


def _unfused(fn):
    """``fn`` without the combine+probe fusion's hooks: the solver then
    takes K3 (K6, K13), as for an objective that does not carry them."""
    def vag(x):
        return fn(x)

    vag.__dict__.update({k: v for k, v in fn.__dict__.items()
                         if not k.startswith(("__lbfgs_combine_probe", "__lbfgs_combine_ow_probe"))})
    return vag


def _close(t, j, rtol, atol=0.0):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    np.testing.assert_allclose(t, np.asarray(j, np.float64).reshape(t.shape), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# The plain versions against the JAX package's references (float64)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stp1", [1.0, 0.37, 2.0 ** -3])
def test_k15_plain_matches_jax_reference_f64(stp1):
    g, x, S, Y, cs, cy = _inputs(4096, 51, np.float64)
    t = _port_k15(g, x, S, Y, -0.37, cs, cy, stp1)
    j = j_rosen.combine_probe_ref(*(jnp.asarray(v) for v in (g, x, S, Y)), -0.37,
                                  jnp.asarray(cs), jnp.asarray(cy), stp1)
    for a, b in zip(t, j):
        _close(a, b, rtol=1e-12, atol=1e-12 * float(np.abs(np.asarray(b)).max()))


@pytest.mark.parametrize("window", [(0, 4095), (300, 1000)])
def test_k16_plain_matches_jax_reference_f64(window):
    pg, x, S, Y, cs, cy = _inputs(4096, 61, np.float64)
    for stp1 in (1.0, 0.37):
        t = _port_k16(pg, x, S, Y, -0.37, cs, cy, 0.8, *window, stp1)
        j = j_rosen.combine_ow_probe_ref(*(jnp.asarray(v) for v in (pg, x, S, Y)), -0.37,
                                         jnp.asarray(cs), jnp.asarray(cy), 0.8, *window,
                                         stp1=stp1)
        np.testing.assert_array_equal(t[0].numpy() == 0, np.asarray(j[0]) == 0)
        for a, b in zip(t, j):
            _close(a, b, rtol=1e-12, atol=1e-12 * float(np.abs(np.asarray(b)).max()))


def test_k17_plain_matches_jax_reference_f64():
    rng = np.random.default_rng(3)
    y, x, w = (rng.standard_normal(4099) for _ in range(3))
    z, zw = t_fused.axpy_dot(_t(y), _t(x), 0.37, _t(w))
    zj, zwj = j_fused.axpy_dot_ref(jnp.asarray(y), jnp.asarray(x), 0.37, jnp.asarray(w))
    _close(z, zj, rtol=1e-12)
    _close(zw, zwj, rtol=1e-12)


# ---------------------------------------------------------------------------
# Against the Pallas kernels in interpret mode (float32)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [4096, 128 * 9])
def test_k15_matches_pallas_f32(n):
    g, x, S, Y, cs, cy = _inputs(n, 52, np.float32)
    t = _port_k15(g, x, S, Y, -0.4, cs, cy, 1.0)
    j = j_rosen.combine_probe_pallas(jnp.asarray(g), jnp.asarray(x), _ring(S), _ring(Y), -0.4,
                                     jnp.asarray(cs), jnp.asarray(cy), interpret=True)
    _close(t[0], j[0], rtol=1e-5, atol=1e-5)
    assert float(t[1]) == pytest.approx(float(j[1]), rel=1e-4)
    assert float(t[2]) == pytest.approx(float(j[2]), rel=1e-4, abs=1e-2)
    assert float(t[3]) == pytest.approx(float(j[3]), rel=1e-4)
    assert float(t[4]) == pytest.approx(float(j[4]), rel=1e-4, abs=1e-2)


@pytest.mark.parametrize("window", [(0, 4095), (300, 1000)])
@pytest.mark.parametrize("n", [4096, 128 * 9])
def test_k16_matches_pallas_f32(n, window):
    lo, hi = window[0], min(window[1], n - 1)
    pg, x, S, Y, cs, cy = _inputs(n, 62, np.float32)
    t = _port_k16(pg, x, S, Y, -0.37, cs, cy, 0.8, lo, hi, 1.0)
    j = j_rosen.combine_ow_probe_pallas(jnp.asarray(pg), jnp.asarray(x), _ring(S), _ring(Y),
                                        -0.37, jnp.asarray(cs), jnp.asarray(cy), 0.8, lo, hi,
                                        interpret=True)
    np.testing.assert_array_equal(t[0].numpy() == 0, np.asarray(j[0]) == 0)
    _close(t[0], j[0], rtol=1e-5, atol=1e-5)
    for i, abs_ in ((1, 0), (2, 0), (3, 1e-2), (4, 0), (5, 1e-2)):
        assert float(t[i]) == pytest.approx(float(j[i]), rel=1e-4, abs=abs_)


@pytest.mark.parametrize("n", [4096, 128 * 9])
def test_k17_matches_pallas_f32(n):
    rng = np.random.default_rng(n)
    y, x, w = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    z, zw = t_fused.axpy_dot(_t(y), _t(x), 0.37, _t(w))
    zj, zwj = j_fused.axpy_dot_pallas(jnp.asarray(y), jnp.asarray(x), 0.37, jnp.asarray(w),
                                      interpret=True)
    _close(z, zj, rtol=1e-6, atol=1e-6)
    assert float(zw) == pytest.approx(float(zwj), rel=1e-4, abs=1e-3)


def test_k15_probe_is_k2s_probe_and_k16s_is_k8s():
    """The fusions' probe scalars are those of the probe kernels' plain
    versions at the direction they return, bit for bit, in both
    objective-scalar modes."""
    g, x, S, Y, cs, cy = _inputs(1000, 53, np.float32)
    for wide in (False, True):
        with t_fused.wide_fx(wide):
            t = _port_k15(g, x, S, Y, -0.4, cs, cy, 0.37)
            p = t_rosen.probe(_t(x), t[0], 0.37)
            assert t[3].dtype == (torch.float64 if wide else torch.float32)
            assert (t[3].item(), t[4].item()) == (p[0].item(), p[1].item())
            t = _port_k16(g, x, S, Y, -0.4, cs, cy, 0.8, 3, 997, 0.37)
            p = t_rosen.owlqn_probe_pg(_t(x), t[0], _t(g), 0.37, 0.8, 3, 997)
            assert (t[4].item(), t[5].item()) == (p[0].item(), p[1].item())


def test_profiling_helpers_on_cpu(tmp_path):
    """The calibration kernel's plain version, and the trace and timing
    helpers (``lbfgs_torch.utils.profiling``)."""
    from lbfgs_torch.utils import profiling

    x = torch.arange(profiling.NULL_ELEMS, dtype=torch.float32)
    calls = profiling.null_launch_ref.calls
    assert torch.equal(profiling.null_launch(x), x + 1.0)
    assert profiling.null_launch_ref.calls == calls + 1
    with pytest.raises(ValueError, match="float32"):
        profiling.null_launch(torch.zeros(16))
    path = tmp_path / "trace.json"
    with profiling.trace(str(path)):
        profiling.null_launch(x)
    assert path.stat().st_size > 0
    assert profiling.timed(lambda: profiling.null_launch(x), warmup=1, repeats=2) > 0.0


@pytest.mark.parametrize("call", [
    lambda v, S, z: t_rosen.combine_probe(v, v[:-2], S, S, z[0], z, z, 1.0),
    lambda v, S, z: t_rosen.combine_probe(v[:-1], v[:-1], S[:, :-1], S[:, :-1], z[0], z, z,
                                          1.0),
    lambda v, S, z: t_rosen.combine_ow_probe(v, v, S, S, z[0], z, z, 1.0, 0, v.shape[0] + 1,
                                             1.0),
    lambda v, S, z: t_fused.axpy_dot(v, v[:-2], 0.5, v),
], ids=["x_shape", "odd_n", "window", "axpy_shapes"])
def test_fusions_reject_bad_arguments(call):
    v, S, z = torch.zeros(16), torch.zeros(M, 16), torch.zeros(M)
    with pytest.raises(ValueError):
        call(v, S, z)


@pytest.mark.parametrize("dtypes", [(torch.float64, torch.float64),
                                    (torch.float32, torch.bfloat16)], ids=["f64", "f32_bf16"])
def test_k15_fix_form_is_k6_then_the_probe(dtypes):
    """K15's damped-row form (the plain version on the CPU): r, r.r, r.g
    and the fixed ring bit for bit those of K6's plain version, and the
    probe's (ft, g.r) bit for bit K2's plain probe at that r."""
    vd, hd = dtypes
    g, x, S, Y, cs, cy = (_t(a) for a in _inputs(1000, 54, np.float64))
    g, x, cs, cy = (v.to(vd) for v in (g, x, cs, cy))
    S, Y = S.to(hd), Y.to(hd)
    gamma, ca, cb = (torch.tensor(v, dtype=vd) for v in (-0.4, 0.7, -0.2))
    Yk, Yp = Y.clone(), Y.clone()
    k = t_rosen.combine_probe(g, x, S, Yk, gamma, cs, cy, 0.37, fix=(2, ca, cb))
    p = t_fused.combine_fix_ref(g, S, Yp, gamma, cs, cy, 2, ca, cb)
    assert all(torch.equal(a, b) for a, b in zip(k[:3], p))
    assert torch.equal(Yk, Yp) and not torch.equal(Yk[2], Y[2])
    assert torch.equal(Yk[[0, 1, 3, 4, 5]], Y[[0, 1, 3, 4, 5]])
    ft, dg = t_rosen.probe_ref(x, k[0], 0.37)
    assert (k[3].item(), k[4].item()) == (ft.item(), dg.item())
    with pytest.raises(ValueError, match="ring row"):
        t_rosen.combine_probe(g, x, S, Yk, gamma, cs, cy, 0.37, fix=(M, ca, cb))


def test_protocol_attached_and_ok():
    vag = t_rosen.value_and_grad
    assert vag.__lbfgs_combine_probe__ is t_rosen.combine_probe
    assert vag.__lbfgs_combine_ow_probe__ is t_rosen.combine_ow_probe
    assert vag.plain.__lbfgs_combine_probe__ is t_rosen.combine_probe_ref
    assert vag.plain.__lbfgs_combine_ow_probe__ is t_rosen.combine_ow_probe_ref
    x, S = torch.zeros(64), torch.zeros(M, 64)
    assert vag.__lbfgs_combine_probe_ok__(x, S)
    assert vag.plain.__lbfgs_combine_ow_probe_ok__(x, S)
    assert not vag.__lbfgs_combine_probe_ok__(torch.zeros(63), torch.zeros(M, 63))  # odd n
    assert not vag.__lbfgs_combine_probe_ok__(x, torch.zeros(M, 64, dtype=torch.float16))


# ---------------------------------------------------------------------------
# Whole runs on the CPU: fusion on against off, bit for bit
# ---------------------------------------------------------------------------


def _g0_norm(x0):
    g = t_rosen._plain_value_and_grad(x0)[1]
    return float(np.sqrt(torch.dot(g, g).numpy()))


FUSION_CASES = {
    "more_thuente": (lambda b: b.with_constrain_step_size(False), 100, torch.float64),
    "owlqn_armijo": (lambda b: (b.with_orthantwise(1.0, 0, 99).with_constrain_step_size(False)
                                .with_max_iterations(60)), 100, torch.float64),
    "fx_wide": (lambda b: (b.with_constrain_step_size(False).with_fx_wide()
                           .with_history_dtype("bfloat16").with_max_iterations(25)),
                2048, torch.float32),
    "damped": (lambda b: (b.with_constrain_step_size(False).with_damping(True)
                          .with_max_iterations(40)), 100, torch.float64),
    "constrained": (lambda b: b, 100, torch.float64),
    "dead_slot": (lambda b, x0=None: b.with_initial_step_size(
        _g0_norm(t_rosen.initial_point(100, device="cpu"))).with_constrain_step_size(False),
        100, torch.float64),
}


def _steps(builder, x0, on: bool, fuses: bool):
    """Run to the end through the step-at-a-time loop, on the objective
    with the fusion's hooks (``on``) or without; returns (report, final
    state, entry step of every search, plain probe calls, carried first
    trips, plain calls of K6)."""
    probes = (t_rosen.probe_ref, t_rosen.owlqn_probe_pg_ref)
    before = sum(p.calls for p in probes), t_fused.combine_fix_ref.calls
    carried.used = 0
    fn = lbfgs_torch.default_evaluate()
    st = builder.build(x0, fn if on else _unfused(fn))
    assert (st.state.probe1 is not None) == (on and fuses)
    entries = []
    while not st.is_converged():
        if st.state.k >= 1:
            entries.append(st.state.step)
        st.propagate()
    return (st.report(), st.state, entries, sum(p.calls for p in probes) - before[0],
            carried.used, t_fused.combine_fix_ref.calls - before[1])


def _same_state(a, b):
    da, db = interop.state_to_numpy(a), interop.state_to_numpy(b)
    da.pop("probe1"), db.pop("probe1")

    def walk(u, v, path):
        if isinstance(u, dict):
            for k in u:
                walk(u[k], v[k], f"{path}.{k}")
        elif isinstance(u, np.ndarray):
            np.testing.assert_array_equal(u, v, err_msg=path)
        else:
            assert u == v or (u != u and v != v), (path, u, v)

    walk(da, db, "state")


@pytest.mark.parametrize("case", list(FUSION_CASES))
def test_fusion_on_equals_off_bit_for_bit(case):
    chain, n, dtype = FUSION_CASES[case]
    # under the step cap the entry comes from ||d|| after the combine, so
    # the solver does not fuse there at all
    fuses = case != "constrained"
    logging.disable(logging.WARNING)
    try:
        x0 = t_rosen.initial_point(n, dtype, device="cpu")
        b = chain(lbfgs_torch.lbfgs())
        r_off, s_off, e_off, p_off, c_off, f_off = _steps(b, x0, False, fuses)
        r_on, s_on, e_on, p_on, c_on, f_on = _steps(b, x0, True, fuses)
    finally:
        logging.disable(logging.NOTSET)
    assert (r_on.niter, r_on.neval, r_on.fx) == (r_off.niter, r_off.neval, r_off.fx)
    _same_state(s_on, s_off)
    assert c_off == 0 and (c_on > 0) == fuses
    # one plain probe fewer for each first trip that took the carried one
    assert p_on == p_off - c_on
    # which searches took it: every one after the first whose entry is the
    # probed step (1.0 under the literal policy), never the first, whose
    # slot is dead
    assert e_on == e_off
    assert c_on == (sum(e == 1.0 for e in e_off[1:]) if fuses else 0)
    if case == "dead_slot":
        assert e_off[0] == 1.0
    # damped, K15's fix form persists the row in K6's place
    if case == "damped":
        assert f_off == r_off.niter - 1 and f_on == 0
        assert sum(r_on.damping_cases[1:]) > 0


def test_failed_search_with_fusion_reverts_like_without():
    """xtol = 10 fails the first bracketing trip (LS_ROUNDING): with the
    fusion the host loop reverts the vectors and raises "x not changed" at
    the same iteration, with the same state, as without; the slot keeps
    what the failed propagate computed (the JAX package's revert replaces
    only the vectors)."""
    out = {}
    for on in (False, True):
        fn = lbfgs_torch.default_evaluate()
        st = lbfgs_torch.lbfgs().with_linesearch_xtol(10.0).with_constrain_step_size(False).build(
            t_rosen.initial_point(100, device="cpu"), fn if on else _unfused(fn))
        logging.disable(logging.ERROR)
        try:
            with pytest.raises(lbfgs_torch.LbfgsError, match="x not changed"):
                while not st.is_converged():
                    st.propagate()
        finally:
            logging.disable(logging.NOTSET)
        out[on] = st.state
    assert (out[True].k, out[True].ls_status) == (out[False].k, out[False].ls_status) == (8, 10)
    _same_state(out[True], out[False])
    assert out[False].probe1 is None and out[True].probe1[2] == 1.0


# ---------------------------------------------------------------------------
# Against the JAX package's fusion-on runs (float32, the interpreter)
# ---------------------------------------------------------------------------


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_run(params, monkeypatch, keep_states=False):
    monkeypatch.setenv("LBFGS_TPU_KERNELS_INTERPRET", "1")
    monkeypatch.setenv("LBFGS_TPU_KERNELS", "all")
    st = JState.build(params, j_rosen.initial_point(N_FUSED, dtype=jnp.float32),
                      j_rosen.value_and_grad)
    assert st.state.probe1 is not None
    states = [_np(st.state)]
    while not st.is_converged():
        st.propagate()
        if keep_states:
            states.append(_np(st.state))
    return st.report(), states


def _port_run(params):
    st = TState.build(params, t_rosen.initial_point(N_FUSED, torch.float32, device="cpu"),
                      lbfgs_torch.default_evaluate())
    assert st.state.probe1 is not None
    while not st.is_converged():
        st.propagate()
    return st.report()


@pytest.fixture(scope="module")
def jax_fused_plain():
    """The JAX package's fusion-on run, 8 iterations at its test's
    defaults but with the step uncapped (where the port fuses), with the
    state after every iteration."""
    mp = pytest.MonkeyPatch()
    try:
        return _jax_run(JParams(max_iterations=8, epsilon=0.0, constrain_step_size=False), mp,
                        keep_states=True)
    finally:
        mp.undo()


def test_port_matches_jax_fusion_on_plain(jax_fused_plain, monkeypatch):
    rep_j, _ = jax_fused_plain
    rep_t = _port_run(TParams(max_iterations=8, epsilon=0.0, constrain_step_size=False))
    assert rep_t.niter == rep_j.niter == 8
    assert rep_t.neval == rep_j.neval
    assert rep_t.fx == pytest.approx(float(rep_j.fx), rel=1e-3)


def test_port_matches_jax_fusion_on_owlqn(monkeypatch):
    kw = dict(max_iterations=8, epsilon=0.0, constrain_step_size=False)
    rep_j, _ = _jax_run(JParams(orthantwise=JOW(1.0, 0, N_FUSED - 1), **kw), monkeypatch)
    logging.disable(logging.WARNING)
    try:
        rep_t = _port_run(TParams(orthantwise=TOW(1.0, 0, N_FUSED - 1), **kw))
    finally:
        logging.disable(logging.NOTSET)
    assert rep_t.niter == rep_j.niter == 8
    assert rep_t.neval == rep_j.neval
    assert rep_t.fx == pytest.approx(float(rep_j.fx), rel=1e-3)


@pytest.mark.parametrize("k", [2, 4, 7])
def test_carried_probe_after_one_propagate_from_jax_state(jax_fused_plain, k):
    """From JAX's state after iteration k - 1 (carried over by ``interop``,
    its probe slot included), one port propagate gives the probe slot
    JAX's state after iteration k holds."""
    _, states = jax_fused_plain
    st = interop.state_from_jax(states[k - 1], "cpu")
    assert st.probe1 is not None and type(st.probe1[0]) is np.float32
    out = tsol.propagate_hot(TDef(value_and_grad=t_rosen.value_and_grad),
                             TParams(max_iterations=8, epsilon=0.0, constrain_step_size=False),
                             st)
    want = states[k].probe1
    assert out.probe1[2] == np.float32(np.asarray(want[2]))
    # the slot is the plain probe at the port's own new point and direction
    ft, dgt = t_rosen.probe_ref(out.prob.x, out.prob.d, out.probe1[2])
    assert (out.probe1[0], out.probe1[1]) == (ft.item(), dgt.item())
    # and JAX's: ft at rel 1e-4; g(x + d).d at rel 1e-3, since on this
    # curvature it moves ~13x the directions' own float32 gap (1.8e-5
    # normwise at k = 4 gives 2.5e-4 there)
    _close(out.prob.d, states[k].prob.d, rtol=0, atol=1e-4 * np.abs(states[k].prob.d).max())
    assert float(out.probe1[0]) == pytest.approx(float(np.asarray(want[0])), rel=1e-4)
    assert float(out.probe1[1]) == pytest.approx(float(np.asarray(want[1])), rel=1e-3)
    assert float(out.prob.fx) == pytest.approx(float(states[k].prob.fx), rel=1e-4)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["combine_probe", "combine_probe_fix", "combine_ow_probe",
                                    "axpy_dot"])
def test_kernel_matches_plain_on_card(cuda, kernel):
    n, lo, hi, c = 1 << 16, 3 * 1024 + 5, (1 << 16) - 7 * 1024 - 3, 0.7
    g, x, S, Y, cs, cy = (_t(a).to(cuda) for a in _inputs(n, 70, np.float32))
    gamma = torch.tensor(-0.4, device=cuda)
    S, Y = S.to(torch.bfloat16), Y.to(torch.bfloat16)
    if kernel.startswith("combine_probe"):
        fix = (2, *(torch.tensor(v, device=cuda) for v in (0.7, -0.2)))
        fix = fix if kernel.endswith("fix") else None
        Yk, Yp = Y.clone(), Y.clone()
        k = t_rosen.combine_probe(g, x, S, Yk, gamma, cs, cy, 0.37, fix=fix)
        p = t_rosen.combine_probe_ref(g, x, S, Yp, gamma, cs, cy, 0.37, fix=fix)
        k2 = t_rosen.probe(x, k[0], 0.37)
        assert _same_bits(k[3], k2[0]) and _same_bits(k[4], k2[1])
        # K6's ring row, bit for bit
        assert _same_bits(Yk, Yp) and _same_bits(Yk, Y) == (fix is None)
    elif kernel == "combine_ow_probe":
        k = t_rosen.combine_ow_probe(g, x, S, Y, gamma, cs, cy, c, lo, hi, 0.37)
        p = t_rosen.combine_ow_probe_ref(g, x, S, Y, gamma, cs, cy, c, lo, hi, 0.37)
        k8 = t_rosen.owlqn_probe_pg(x, k[0], g, 0.37, c, lo, hi)
        assert _same_bits(k[4], k8[0]) and _same_bits(k[5], k8[1])
    else:
        k = t_fused.axpy_dot(g, x, 0.37, S[0].float())
        p = t_fused.axpy_dot_ref(g, x, 0.37, S[0].float())
        assert _same_bits(k[0], p[0])
    for a, b in zip(k, p):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
