"""The port's batched runner under Powell damping and in the gradient-only
mode (``lbfgs_torch.batched`` with ``damping=True``, ``damping_fixed`` or
``with_gradient_only()``), against the JAX package's
(``lbfgs_tpu.batched``) and against its own solo runs, on the CPU, where
K4 b and K14 b with their . gp columns, K6 b and K15 b's fix form run
their plain versions.

  * the vectorized backtracking with the gradient-only exit against the
    scalar ``linesearch.backtracking``, plain and OWL-QN, bit for bit,
    instances with dginit == 0 included; More-Thuente raises;
  * the plain versions of K4 b ·gp, K14 b ·gp, K6 b and K15 b fix per
    instance against the JAX package's jnp oracles in float64 at m = 6 and
    80 (rel 1e-12 on vectors, 1e-10 on sums, ring rows and the damped row
    bit for bit, frozen instances untouched), the . gp launch's columns
    0-2 and the fix form's row bit for bit the 3-column launch's and K6
    b's, and the batched damping algebra per instance bit for bit the
    solo ``solver._damped_gram``;
  * eight perturbed instances in float64 against the JAX batched run,
    damped capped and uncapped (literal and adaptive), plain and OWL-QN,
    ``damping_fixed``, gradient-only and m = 80: after 15 iterations the
    same k, evaluations, status and ring row, fx, entry step and dginit rel
    1e-9, the rings rtol 1e-7;
  * each instance against the port's solo damped run (``minimize_jit``),
    where damping cases 1 and 2 both fire; an early finisher and instances
    whose searches fail under damped OWL-QN keep their rings and Gram
    blocks; a run resumed from the JAX package's fused damped batched
    state; the launch path (K6 b, K15 b fix, K13 b, K16 b), the fused run
    against the unfused one bit for bit, and the host reads per iteration
    those of the undamped run; float32 with a bfloat16 ring against solo
    runs.

The cases marked ``cuda`` hold the new forms to their plain versions and,
per instance, to the solo kernels on the card (and K3 b and K13 b at m =
80 to the solo combines), and skip without one.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from lbfgs_torch import _batched_search as bs
from lbfgs_torch import batched as t_batched
from lbfgs_torch import interop
from lbfgs_torch import lbfgs as t_lbfgs
from lbfgs_torch import linesearch as t_ls
from lbfgs_torch import solver as t_solver
from lbfgs_torch.core import ProblemDef, to_host
from lbfgs_torch.minimize import minimize_jit as t_minimize_jit
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.orthantwise import Orthantwise as TOrthantwise
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_torch.params import LineSearchParams as TLsParams
from lbfgs_torch.status import Status
from lbfgs_tpu import lbfgs as j_lbfgs
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.ops import fused as j_fused
from test_torch_batched import B, N, _Poly, _close, _same, _scalar_objective, _t
from test_torch_batched_owlqn import OW, PERTURBED, _owlqn_stand_in
from test_torch_batched_uncapped import LIVE, N_FUSED, _hold_states, _unfused

K = t_rosen.value_and_grad.kernels


@pytest.fixture(autouse=True)
def _quiet():
    # ``with_orthantwise``'s one-line notice that OWL-QN runs backtracking only
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


# ---------------------------------------------------------------------------
# the gradient-only exit of the vectorized backtracking
# ---------------------------------------------------------------------------


class _RisingPoly(_Poly):
    """``_Poly`` with every seventh instance rising at zero slope: phi(t) =
    c0 + |c1| t and phi'(t) = 0, so its dginit is 0 and every trial fails
    the Armijo test, and only the literal gradient-only exit (|g.d| <=
    -gtol*|dginit|, which holds there) ends its search."""

    def __init__(self, rng, K, dtype):
        super().__init__(rng, K, dtype)
        self.rising = np.arange(K) % 7 == 0

    def __call__(self, t, i=slice(None)):
        ft, dg = super().__call__(t, i)
        up = self.rising[i]
        rise = self.c0[i] + t * np.abs(self.c1[i])
        return np.where(up, rise, ft)[()], np.where(up, self.dtype(0.0), dg)[()]


def _gradient_only_case(seed: int, K_: int = 120):
    """Seeded polynomial searches (``_RisingPoly``), some of them dead."""
    dtype = np.float32
    rng = np.random.RandomState(seed)
    poly = _RisingPoly(rng, K_, dtype)
    finit, dginit = poly(np.zeros(K_, dtype))
    stp0 = (rng.rand(K_) * 3.0 + 0.01).astype(dtype)
    neval0 = np.arange(K_, dtype=np.int64)
    live = rng.rand(K_) < 0.9
    return poly, finit, dginit, stp0, neval0, live


def _scalar_find(poly, i, ls, ow, finit, dginit, stp0, neval0):
    xp = torch.zeros(1, dtype=torch.float32)
    if ow:
        pdef = ProblemDef(value_and_grad=_owlqn_stand_in(poly, i), owlqn=TOrthantwise(*OW))
        kw = dict(pgp=xp)
    else:
        pdef = ProblemDef(value_and_grad=_scalar_objective(poly, i, np.float32))
        kw = {}
    return t_ls.find(pdef, ls, xp, finit[i], xp, xp, stp0[i], int(neval0[i]),
                     dginit=dginit[i], materialize=False, **kw)


@pytest.mark.parametrize("max_ls", [20, 4])
@pytest.mark.parametrize("ow", [False, True], ids=["plain", "owlqn"])
def test_gradient_only_search_matches_scalar(ow, max_ls):
    """``with_gradient_only()``'s search (strong-Wolfe backtracking with the
    literal exit) per instance is the scalar one bit for bit; the exit ends
    the rising dginit == 0 searches at their first trial, which the ladder
    alone would not end, and changes no other search."""
    poly, finit, dginit, stp0, neval0, live = _gradient_only_case(5 + ow + max_ls)
    ls = TLsParams(algorithm="BacktrackingStrongWolfe", gradient_only=True,
                   max_linesearch=max_ls)
    probe = lambda stp, run: poly(stp)
    got = bs.find(ls, live, finit, dginit, stp0, neval0, probe, ow=ow)
    ladder = bs.find(TLsParams(algorithm="BacktrackingStrongWolfe", max_linesearch=max_ls),
                     live, finit, dginit, stp0, neval0, probe, ow=ow)
    for i in range(len(stp0)):
        if not live[i]:
            assert (got.neval[i], got.ncall[i], got.status[i]) == (neval0[i], 0, 0)
            continue
        want = _scalar_find(poly, i, ls, ow, finit, dginit, stp0, neval0)
        assert _same(want.fx, got.fx[i]) and _same(want.step, got.step[i]), i
        assert _same(want.step_eval, got.step_eval[i]), i
        assert (want.ncall, want.neval, want.status) == (
            got.ncall[i], got.neval[i], got.status[i]), i
    up = live & poly.rising
    assert np.all(dginit[poly.rising] == 0.0) and np.all(got.ncall[up] == 1)
    assert np.all(ladder.ncall[up] != 1)
    for name in got._fields:
        assert _same(getattr(got, name)[live & ~up], getattr(ladder, name)[live & ~up]), name


def test_gradient_only_more_thuente_raises():
    """The scalar ``find``'s hard error (``src/line.rs:208``); under OWL-QN
    More-Thuente is routed to backtracking and runs."""
    poly, finit, dginit, stp0, neval0, live = _gradient_only_case(3)
    ls = TLsParams(algorithm="MoreThuente", gradient_only=True)
    probe = lambda stp, run: poly(stp)
    with pytest.raises(ValueError, match="Gradient only"):
        bs.find(ls, live, finit, dginit, stp0, neval0, probe)
    out = bs.find(ls, live, finit, dginit, stp0, neval0, probe, ow=True)
    assert np.all(out.neval[live] > neval0[live])


# ---------------------------------------------------------------------------
# the plain versions against the JAX package's references (float64)
# ---------------------------------------------------------------------------

WINDOWS = {"edge": (0, 63), "interior": (5, 50)}


@pytest.fixture(scope="module", params=(6, 80), ids=lambda m: f"m{m}")
def damped_batch(request):
    m, n = request.param, 64
    rng = np.random.RandomState(17 + m)
    Bk = len(LIVE)
    xp = np.where(np.arange(n) % 2 == 0, -1.2, 1.0) + 0.1 * rng.randn(Bk, n)
    xp[:, ::9] = 0.0
    return dict(m=m, end=m - 3, xp=xp, d=0.3 * rng.randn(Bk, n), gp=rng.randn(Bk, n),
                pg=rng.randn(Bk, n), S=rng.randn(Bk, m, n), Y=rng.randn(Bk, m, n),
                stp=0.2 + rng.rand(Bk), coef=(0.5 / m ** 0.5) * rng.randn(Bk, 3 + 2 * m),
                stp1=np.array([1.0, 0.37, 0.125, 2.0 ** -3]), c=0.7)


def _rings_kept(S, Y, a, b):
    keep = [j for j in range(a["m"]) if j != a["end"]]
    assert np.array_equal(S[b, keep].numpy(), a["S"][b, keep])
    assert np.array_equal(Y[b, keep].numpy(), a["Y"][b, keep])


def test_k4b_gp_plain_matches_jax(damped_batch):
    a, end = damped_batch, damped_batch["end"]
    xp, gp, S, Y = (_t(a[k]) for k in ("xp", "gp", "S", "Y"))
    gd, gg, xx, changed, SP, YP = K.trial_pair_gram_batched(
        xp, _t(a["d"]), gp, _t(a["stp"]), S, Y, end, _t(LIVE), with_gp=True)
    assert SP.shape[1:] == YP.shape[1:] == (a["m"], 4)
    # columns 0-2 and every other output are the 3-column launch's
    ref = {k: _t(a[k]) for k in ("xp", "gp", "S", "Y")}
    out3 = K.trial_pair_gram_batched(ref["xp"], _t(a["d"]), ref["gp"], _t(a["stp"]), ref["S"],
                                     ref["Y"], end, _t(LIVE))
    for u, v in zip((gd, gg, xx, changed), out3[:4]):
        assert torch.equal(u, v)
    assert torch.equal(SP[..., :3], out3[4]) and torch.equal(YP[..., :3], out3[5])
    for b in range(len(LIVE)):
        if not LIVE[b]:
            for t, k in ((xp, "xp"), (gp, "gp"), (S, "S"), (Y, "Y")):
                assert np.array_equal(t[b].numpy(), a[k][b])
            continue
        jx, _jfx, jg, _jgd, _jgg, _jxx, _jch = j_rosen.trial_ref(
            jnp.asarray(a["xp"][b]), jnp.asarray(a["d"][b]), a["stp"][b])
        js, jy, jSP, jYP = j_fused.pair_gram_sd_ref(
            a["stp"][b], jnp.asarray(a["d"][b]), jg, jnp.asarray(a["gp"][b]),
            jnp.asarray(a["S"][b]), jnp.asarray(a["Y"][b]), end, with_gp=True)
        _close(xp[b], jx, 1e-12)
        _close(gp[b], jg, 1e-12)
        _close(SP[b], jSP, 1e-10)
        _close(YP[b], jYP, 1e-10)
        assert np.array_equal(S[b, end].numpy(), np.asarray(js))
        assert np.array_equal(Y[b, end].numpy(), np.asarray(jy))
        _rings_kept(S, Y, a, b)


@pytest.mark.parametrize("window", list(WINDOWS))
def test_k14b_gp_plain_matches_jax(damped_batch, window):
    a, end = damped_batch, damped_batch["end"]
    lo, hi = WINDOWS[window]
    xp, gp, pg, S, Y = (_t(a[k]) for k in ("xp", "gp", "pg", "S", "Y"))
    xx, pp, changed, SP, YP, gpgp, gppg = K.owlqn_trial_pair_gram_batched(
        xp, _t(a["d"]), gp, pg, _t(a["stp"]), a["c"], lo, hi, S, Y, end, _t(LIVE),
        with_gp=True)
    ref = {k: _t(a[k]) for k in ("xp", "gp", "pg", "S", "Y")}
    out3 = K.owlqn_trial_pair_gram_batched(ref["xp"], _t(a["d"]), ref["gp"], ref["pg"],
                                           _t(a["stp"]), a["c"], lo, hi, ref["S"], ref["Y"],
                                           end, _t(LIVE))
    for u, v in zip((xx, pp, changed), out3[:3]):
        assert torch.equal(u, v)
    assert torch.equal(SP[..., :3], out3[3]) and torch.equal(YP[..., :3], out3[4])
    for b in range(len(LIVE)):
        if not LIVE[b]:
            for t, k in ((xp, "xp"), (gp, "gp"), (pg, "pg"), (S, "S"), (Y, "Y")):
                assert np.array_equal(t[b].numpy(), a[k][b])
            continue
        j = j_rosen.owlqn_trial_pair_gram_ref(
            *(jnp.asarray(a[k][b]) for k in ("xp", "d", "gp", "pg")), a["stp"][b], a["c"], lo,
            hi, jnp.asarray(a["S"][b]), jnp.asarray(a["Y"][b]), end, with_gp=True)
        jx, jg, jpg, jS, jY, jSP, jYP, jxx, jpp, jch, jgpgp, jgppg = j
        for t, jv in ((xp, jx), (gp, jg), (pg, jpg)):
            _close(t[b], jv, 1e-12)
        for t, jv in ((SP, jSP), (YP, jYP), (xx, jxx), (pp, jpp), (gpgp, jgpgp),
                      (gppg, jgppg)):
            _close(t[b], jv, 1e-10)
        assert bool(changed[b]) == bool(jch)
        assert np.array_equal(S[b].numpy(), np.asarray(jS))
        assert np.array_equal(Y[b].numpy(), np.asarray(jY))


def _jax_fix(a, b):
    """The JAX package's K6 oracle on instance b: (r, r.r, r.g, Y_new)."""
    m, c = a["m"], a["coef"][b]
    return j_fused.combine_fix_ref(jnp.asarray(a["gp"][b]), jnp.asarray(a["S"][b]),
                                   jnp.asarray(a["Y"][b]), c[0], jnp.asarray(c[1:1 + m]),
                                   jnp.asarray(c[1 + m:1 + 2 * m]), a["end"], c[1 + 2 * m],
                                   c[2 + 2 * m])


def test_k6b_plain_matches_jax(damped_batch):
    a, end = damped_batch, damped_batch["end"]
    out, Y = _t(a["d"]), _t(a["Y"])
    rr, rg = t_fused.combine_fix_batched(_t(a["gp"]), _t(a["S"]), Y, _t(a["coef"]), _t(LIVE),
                                         out, end)
    for b in range(len(LIVE)):
        if not LIVE[b]:
            assert np.array_equal(out[b].numpy(), a["d"][b])
            assert np.array_equal(Y[b].numpy(), a["Y"][b])
            continue
        jr, jrr, jrg, jY = _jax_fix(a, b)
        _close(out[b], jr, 1e-12)
        _close(rr[b], jrr, 1e-10)
        _close(rg[b], jrg, 1e-10)
        # the damped row is the same products and sum, rounded one by one
        assert np.array_equal(Y[b].numpy(), np.asarray(jY))


def test_k15b_fix_plain_matches_jax(damped_batch):
    """K15 b's fix form: r, the sums and the probe against the JAX
    package's K15 oracle, the damped row against its K6 oracle, and r and
    the row bit for bit K6 b's plain version."""
    a, m, end = damped_batch, damped_batch["m"], damped_batch["end"]
    out, Y = _t(a["d"]), _t(a["Y"])
    got = K.combine_probe_batched(_t(a["gp"]), _t(a["xp"]), _t(a["S"]), Y, _t(a["coef"]),
                                  _t(a["stp1"]), _t(LIVE), out, fix=end)
    out6, Y6 = _t(a["d"]), _t(a["Y"])
    t_fused.combine_fix_batched(_t(a["gp"]), _t(a["S"]), Y6, _t(a["coef"]), _t(LIVE), out6,
                                end)
    assert torch.equal(out, out6) and torch.equal(Y, Y6)
    for b in range(len(LIVE)):
        if not LIVE[b]:
            assert np.array_equal(out[b].numpy(), a["d"][b])
            assert np.array_equal(Y[b].numpy(), a["Y"][b])
            continue
        c = a["coef"][b]
        j = j_rosen.combine_probe_ref(*(jnp.asarray(a[k][b]) for k in ("gp", "xp", "S", "Y")),
                                      c[0], jnp.asarray(c[1:1 + m]),
                                      jnp.asarray(c[1 + m:1 + 2 * m]), a["stp1"][b])
        _close(out[b], j[0], 1e-12)
        for t, jv in zip(got, j[1:]):
            _close(t[b], jv, 1e-10)
        assert np.array_equal(Y[b].numpy(), np.asarray(_jax_fix(a, b)[3]))


@pytest.mark.parametrize("fixed", [False, True], ids=["literal", "fixed"])
@pytest.mark.parametrize("ow", [False, True], ids=["plain", "owlqn"])
def test_damped_gram_batched_matches_solo(ow, fixed):
    """The damping algebra over [B, m] (``solver._damped_gram`` on [B, m,
    4] bases and [B] scalars) per instance bit for bit the solo call, which
    takes the step as a host float (and on the plain branch the carried
    ||gp||^2 too), on bases where cases 0, 1 and 2 all occur."""
    rng = np.random.RandomState(31 + 2 * ow + fixed)
    Bk, m, end = 24, 7, 4
    SP, YP = torch.from_numpy(rng.randn(Bk, m, 4)), torch.from_numpy(rng.randn(Bk, m, 4))
    stp = torch.from_numpy(0.1 + rng.rand(Bk))
    gpgp = torch.from_numpy(1.0 + rng.rand(Bk))
    gp_d0 = torch.from_numpy(rng.randn(Bk))
    p = TParams(damping=True, damping_fixed=fixed)
    got = t_solver._damped_gram(p, SP, YP, end, stp, gpgp, gp_d0)
    cases = set()
    for b in range(Bk):
        g = gpgp[b] if ow else float(gpgp[b])
        want = t_solver._damped_gram(p, SP[b], YP[b], end, float(stp[b]), g, gp_d0[b])
        for u, v in zip(got, want):
            assert torch.equal(u[b], v), b
        cases.add(int(want[-1]))
    assert cases == {0, 1, 2}


# ---------------------------------------------------------------------------
# whole runs against the JAX package
# ---------------------------------------------------------------------------

_m80 = lambda b: b._new(b.param.replace(m=80))
_ow = lambda b: b.with_orthantwise(*OW)
_unc = lambda b: b.with_constrain_step_size(False)
_damp = lambda b: b.with_damping(True)

#: the settings this slice opens (OWL-QN: c = 1 on the whole vector)
RUNS = {
    "damped": _damp,
    "damped_uncapped": lambda b: _unc(_damp(b)),
    "damped_adaptive": lambda b: _unc(_damp(b)).with_adaptive_entry_step(2.0),
    "damping_fixed": lambda b: _damp(b).with_damping_fixed(),
    "damping_fixed_uncapped": lambda b: _unc(_damp(b).with_damping_fixed()),
    "gradient_only": lambda b: b.with_gradient_only(),
    "owlqn_damped": lambda b: _ow(_damp(b)),
    "owlqn_damped_uncapped": lambda b: _unc(_ow(_damp(b))),
    "owlqn_damped_adaptive": lambda b: _unc(_ow(_damp(b))).with_adaptive_entry_step(2.0),
    "owlqn_gradient_only": lambda b: _ow(b.with_gradient_only()),
    "m80_damped": lambda b: _damp(_m80(b)),
    "m80_damped_uncapped": lambda b: _unc(_damp(_m80(b))),
    "m80_owlqn_damped": lambda b: _ow(_damp(_m80(b))),
}


def _both(configure, x0b=PERTURBED):
    c = lambda b: configure(b).with_max_iterations(15)
    j = c(j_lbfgs()).minimize_batched(jnp.asarray(x0b), j_rosen.value_and_grad,
                                      return_state=True)
    t = c(t_lbfgs()).minimize_batched(_t(x0b), t_rosen.value_and_grad, return_state=True)
    return j, t


@pytest.mark.parametrize("run", list(RUNS))
def test_batched_damped_matches_jax_15_iterations(run):
    """The same k, evaluations, status and ring row per instance; fx, the
    next entry step and dginit rel 1e-9; the rings, their Gram blocks and
    the alphas rtol 1e-7."""
    j, t = _both(RUNS[run])
    _hold_states(j, t)
    js = interop.batched_state_from_jax(j, "cpu")
    assert np.array_equal(t.end, js.end)
    for name in ("s", "y", "sy", "yy", "ys", "alpha"):
        np.testing.assert_allclose(getattr(t.hist, name).numpy(),
                                   getattr(js.hist, name).numpy(), rtol=1e-7, atol=0,
                                   err_msg=name)
    if run.startswith("m80"):
        assert t.hist.s.shape == (B, 80, N)


# ---------------------------------------------------------------------------
# against the port's own solo runs
# ---------------------------------------------------------------------------

_TOW = TOrthantwise(*OW)
PARAMS = {
    "damped": TParams(damping=True),
    "damped_uncapped": TParams(damping=True, constrain_step_size=False),
    "damping_fixed": TParams(damping=True, damping_fixed=True),
    "owlqn_damped": TParams(damping=True, orthantwise=_TOW),
    "owlqn_damped_uncapped": TParams(damping=True, orthantwise=_TOW,
                                     constrain_step_size=False),
    "gradient_only": t_lbfgs().with_gradient_only().param,
}


@pytest.mark.parametrize("run", list(PARAMS))
def test_batched_damped_matches_port_solo_f64(run):
    """Each instance against its solo run after 15 iterations: the same k,
    evaluations and status, fx and the entry step rel 1e-9, x within 1e-9;
    damping cases 1 and 2 both fire in the solo runs."""
    p = PARAMS[run].replace(max_iterations=15)
    st = t_batched.minimize_batched(p, _t(PERTURBED), t_rosen.value_and_grad, return_state=True)
    fired = np.zeros(3, np.int64)
    for b in range(B):
        so = t_minimize_jit(p, _t(PERTURBED[b]), t_rosen.value_and_grad, return_state=True)
        assert (so.k, so.prob.neval, so.status) == (int(st.k[b]), int(st.neval[b]),
                                                    int(st.status[b]))
        assert float(st.fx[b]) == pytest.approx(float(so.prob.fx), rel=1e-9)
        assert float(st.step[b]) == pytest.approx(float(so.step), rel=1e-9)
        np.testing.assert_allclose(st.x[b].numpy(), so.prob.x.numpy(), atol=1e-9, rtol=0)
        fired += np.asarray(so.damping_cases)
    assert fired[1] > 0 and fired[2] > 0, fired


@pytest.mark.parametrize("run", ["damped_uncapped", "owlqn_damped", "owlqn_damped_uncapped"])
def test_batched_damped_matches_port_solo_f32_bf16(run):
    """The main path's dtypes (float32 vectors, a bfloat16 ring) at a small
    size, held to solo runs by the fused-vs-unfused rule: the same
    iterations and evaluations, fx rel 1e-3, after 8 iterations."""
    n, Bk = 1 << 10, 4
    rng = np.random.RandomState(0)
    base = np.asarray(t_rosen.initial_point(n, torch.float32, "cpu"))
    x0b = torch.from_numpy(base[None, :] + 0.05 * rng.randn(Bk, n).astype(np.float32))
    p = PARAMS[run].replace(max_iterations=9, epsilon=0.0, history_dtype="bfloat16")
    if p.orthantwise is not None:
        p = p.replace(orthantwise=TOrthantwise(1.0, 0, n - 1))
    st = t_batched.minimize_batched(p, x0b, t_rosen.value_and_grad, return_state=True)
    assert st.hist.y.dtype == torch.bfloat16
    for b in range(Bk):
        solo = t_minimize_jit(p, x0b[b].clone(), t_rosen.value_and_grad, return_state=True)
        assert (solo.k, solo.prob.neval) == (int(st.k[b]), int(st.neval[b]))
        assert float(st.fx[b]) == pytest.approx(float(solo.prob.fx), rel=1e-3)


def _frozen_batch():
    """Two perturbed starts, one near the solution of the L1 problem and one
    more perturbed start (see ``FROZEN``)."""
    rng = np.random.RandomState(5)
    near = np.tile([0.25, 0.0575], N // 2) + 1e-3 * rng.randn(N)
    return np.stack([PERTURBED[4], PERTURBED[5], near, PERTURBED[2]])


#: damped OWL-QN on ``_frozen_batch`` with epsilon 1e-2, at most 40
#: iterations: (min_step, each instance's last k).  Capped, instances 0
#: and 1 fail their searches at iterations 9 and 34 and instance 2
#: converges after iteration 3; uncapped, instance 0 fails at iteration 27
#: and instance 2 at its first
FROZEN = {"capped": (1e-2, [9, 34, 3, 40]), "uncapped": (0.1, [27, 40, 2, 40])}


@pytest.mark.parametrize("run", list(FROZEN))
def test_frozen_and_failed_instances_keep_rings_and_gram(run):
    """An early finisher and instances whose searches fail, under damped
    OWL-QN: each ends with the x, g, pg, d, rings, Gram blocks, ys and
    alphas of the last iteration that accepted its step, bit for bit: no
    later epilogue, combine or row blend wrote them."""
    min_step, ks = FROZEN[run]
    x0b = _t(_frozen_batch())
    p = TParams(damping=True, orthantwise=_TOW, linesearch=TLsParams(min_step=min_step),
                epsilon=1e-2, max_iterations=40, constrain_step_size=run == "capped")
    st = t_batched.minimize_batched(p, x0b.clone(), t_rosen.value_and_grad, return_state=True)
    assert st.k.tolist() == ks
    failed = st.ls_status != 0
    assert failed.tolist() == [True, run == "capped", run == "uncapped", False]
    assert run == "uncapped" or st.status[2] == Status.CONVERGED
    for b in np.flatnonzero(st.k < 40):
        last = int(st.k[b]) - int(failed[b])
        before = t_batched.minimize_batched(p.replace(max_iterations=last), x0b.clone(),
                                            t_rosen.value_and_grad, return_state=True)
        for name in ("x", "gx", "pg", "d"):
            assert torch.equal(getattr(st, name)[b], getattr(before, name)[b]), (b, name)
        for name in ("s", "y", "sy", "yy", "ys", "alpha"):
            assert torch.equal(getattr(st.hist, name)[b], getattr(before.hist, name)[b]), (
                b, name)


def test_resume_from_jax_fused_damped_batched_state(monkeypatch):
    """Four iterations of the JAX package's fused damped batched run (float32,
    n = 2^14, uncapped, its kernels in interpret mode), four more in the
    port from its state: every first trip takes the carried probe, and the
    run ends with the JAX run's iterations and evaluations, fx rel 1e-3."""
    monkeypatch.setenv("LBFGS_TPU_KERNELS_INTERPRET", "1")
    monkeypatch.setenv("LBFGS_TPU_KERNELS", "all")
    Bk = 2
    rng = np.random.RandomState(0)
    base = np.asarray(j_rosen.initial_point(N_FUSED, dtype=jnp.float32))
    x0b = jnp.asarray(base[None, :] + 0.05 * rng.randn(Bk, N_FUSED).astype(np.float32))
    cfg = lambda it: j_lbfgs().with_damping(True).with_constrain_step_size(False) \
        .with_epsilon(0.0).with_max_iterations(it)
    j4 = cfg(4).minimize_batched(x0b, j_rosen.value_and_grad, return_state=True)
    st = interop.batched_state_from_jax(j4, "cpu")
    assert st.probe1 is not None
    st = st._replace(status=np.zeros(Bk, np.int64))
    used = t_ls.carried.used
    t8 = t_batched.run(TParams(max_iterations=8, epsilon=0.0, constrain_step_size=False,
                               damping=True), t_rosen.value_and_grad, st)
    assert t_ls.carried.used - used == 4 * Bk
    j8 = cfg(8).minimize_batched(x0b, j_rosen.value_and_grad, return_state=True)
    assert np.array_equal(t8.k, np.asarray(j8.k))
    assert np.array_equal(t8.neval, np.asarray(j8.prob.neval))
    np.testing.assert_allclose(t8.fx, np.asarray(j8.prob.fx), rtol=1e-3)


# ---------------------------------------------------------------------------
# the launch path, the fusion against the same run without it, the reads
# ---------------------------------------------------------------------------

#: (plain versions a damped run must call once per iteration, those it must
#: not call), by path
DAMPED_REFS = {
    "damped": ((t_fused.combine_fix_batched_ref,),
               (t_fused.combine_batched_ref, K.combine_probe_batched_ref)),
    "damped_uncapped": ((K.combine_probe_batched_ref,),
                        (t_fused.combine_batched_ref, t_fused.combine_fix_batched_ref)),
    "owlqn_damped": ((t_fused.combine_ow_batched_ref,),
                     (t_fused.combine_fix_batched_ref, K.combine_ow_probe_batched_ref)),
    "owlqn_damped_uncapped": ((K.combine_ow_probe_batched_ref,),
                              (t_fused.combine_ow_batched_ref, t_fused.combine_fix_batched_ref)),
}


@pytest.mark.parametrize("run", list(DAMPED_REFS))
def test_damped_launch_path_and_reads(run):
    """One epilogue with the . gp column and one combine of the path's
    (K6 b, K15 b fix, K13 b, K16 b) per iteration and none of the others,
    and per iteration the undamped run's reads: one per probe that ran
    and one for the epilogue and combine, the damping cases in it."""
    p = PARAMS[run].replace(max_iterations=12)
    want, none = DAMPED_REFS[run]
    epilogue = (K.owlqn_trial_pair_gram_batched_ref if p.orthantwise is not None
                else K.trial_pair_gram_batched_ref)
    probes = (K.owlqn_probe_pg_batched_ref, K.probe_batched_ref)

    def counted(params):
        refs = (*want, *none, epilogue, *probes)
        before, reads, used = [f.calls for f in refs], to_host.reads, t_ls.carried.used
        st = t_batched.minimize_batched(params, _t(PERTURBED), t_rosen.value_and_grad,
                                        return_state=True)
        calls = [f.calls - b0 for f, b0 in zip(refs, before)]
        return st, calls, to_host.reads - reads, t_ls.carried.used - used

    st, calls, reads, _ = counted(p)
    iters = int(st.k.max()) - 1
    assert calls[:len(want)] == [iters] * len(want)
    assert calls[len(want):len(want) + len(none)] == [0] * len(none)
    assert calls[-3] == iters
    # the init's read, then one per probe launch and one per iteration
    assert reads == 1 + sum(calls[-2:]) + iters
    und, u_calls, u_reads, _ = counted(p.replace(damping=False))
    assert u_reads == 1 + sum(u_calls[-2:]) + int(und.k.max()) - 1


@pytest.mark.parametrize("run", ["damped_uncapped", "owlqn_damped_uncapped"])
def test_damped_fusion_off_bit_for_bit(run):
    """The damped uncapped run on the objective without the fusion's hooks
    takes K6 b (K13 b and the row blend under OWL-QN) and a probe on every
    trip, and ends in the fused run's state bit for bit."""
    p = PARAMS[run].replace(max_iterations=12)
    on = t_batched.minimize_batched(p, _t(PERTURBED), t_rosen.value_and_grad,
                                    return_state=True)
    fix = t_fused.combine_fix_batched_ref.calls
    off = t_batched.minimize_batched(p, _t(PERTURBED), _unfused(t_rosen.value_and_grad),
                                     return_state=True)
    if p.orthantwise is None:
        assert t_fused.combine_fix_batched_ref.calls - fix == int(off.k.max()) - 1
    for name in ("k", "neval", "status", "fx", "step", "dg0", "gnorm2", "xnorm2"):
        assert _same(getattr(on, name), getattr(off, name)), name
    for name in ("x", "gx", "d"):
        assert torch.equal(getattr(on, name), getattr(off, name)), name
    for name in ("s", "y", "sy", "yy"):
        assert torch.equal(getattr(on.hist, name), getattr(off.hist, name)), name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_batch(dev, m, Bk=6, n=(1 << 12) + 2, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    live = torch.ones(Bk, dtype=torch.bool, device=dev)
    live[1::3] = False
    xp = -1.0 + 0.1 * r(Bk, n)
    xp[:, ::17] = 0.0
    return dict(xp=xp, d=0.1 * r(Bk, n), gp=r(Bk, n), pg=r(Bk, n),
                S=(0.1 * r(Bk, m, n)).bfloat16(), Y=(0.1 * r(Bk, m, n)).bfloat16(),
                stp=0.2 + torch.rand(Bk, generator=g, device=dev),
                coef=(0.5 / m ** 0.5) * r(Bk, 3 + 2 * m), live=live, end=m - 3, c=0.7,
                window=(3, n - 5))


def _vec(a, b):
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def _sum(a, b):
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [6, 80])
def test_batched_gp_epilogues_on_card(cuda, m):
    """K4 b ·gp and K14 b ·gp against their plain versions (vectors 1e-5,
    sums 1e-4), columns 0-2 and every other sum bit for bit the 3-column
    launch's (on the live instances: a frozen one's sums are never
    written), and per live instance against the solo K4 and K14 with_gp:
    x, g, pg and the rings bit for bit, the . gp sums within the sum
    tolerance (each instance's partials are the solo kernel's, but torch
    adds a [B, programs, k] array's columns in an order that depends on
    B); a frozen instance untouched."""
    a = _card_batch(cuda, m)
    live, (lo, hi), c, end = a["live"], a["window"], a["c"], a["end"]
    names = ("xp", "gp", "pg", "S", "Y")

    def run(fn, ow, **kw):
        t = {n_: a[n_].clone() for n_ in names}
        if ow:
            out = fn(t["xp"], a["d"], t["gp"], t["pg"], a["stp"], c, lo, hi, t["S"], t["Y"], end,
                     live, **kw)
        else:
            out = fn(t["xp"], a["d"], t["gp"], a["stp"], t["S"], t["Y"], end, live, **kw)
        return t, out

    for ow, kern, ref in ((False, K.trial_pair_gram_batched, K.trial_pair_gram_batched_ref),
                          (True, K.owlqn_trial_pair_gram_batched,
                           K.owlqn_trial_pair_gram_batched_ref)):
        gp_launches = kern.gp_launches
        tk, ok_ = run(kern, ow, with_gp=True)
        assert kern.gp_launches == gp_launches + 1
        t3, o3 = run(kern, ow)
        tp, op = run(ref, ow, with_gp=True)
        for n_ in names:
            assert torch.equal(tk[n_], t3[n_]), n_
        for i, (u, v) in enumerate(zip(ok_, o3)):
            assert torch.equal((u[..., :3] if u.ndim == 3 else u)[live], v[live]), i
        for n_ in ("xp", "gp") + (("pg",) if ow else ()):
            _vec(tk[n_][live], tp[n_][live])
        for u, v in zip(ok_, op):
            if u.dtype != torch.bool:
                _sum(u[live], v[live])
        for n_ in names:
            assert torch.equal(tk[n_][~live], a[n_][~live]), n_
        for b in torch.nonzero(live).flatten().tolist():
            Sb, Yb = a["S"][b].clone(), a["Y"][b].clone()
            stp = float(a["stp"][b])
            if ow:
                x1, g1, pg1, SP1, YP1, *_, gg1, gpg1 = K.owlqn_trial_pair_gram(
                    a["xp"][b], a["d"][b], a["gp"][b], a["pg"][b], stp, c, lo, hi, Sb, Yb, end,
                    with_gp=True)
                assert torch.equal(tk["pg"][b], pg1)
                _sum(ok_[5][b], gg1)
                _sum(ok_[6][b], gpg1)
                SPb, YPb = ok_[3][b], ok_[4][b]
            else:
                x1, _, g1, *_, SP1, YP1 = K.trial_pair_gram(
                    a["xp"][b], a["d"][b], a["gp"][b], stp, Sb, Yb, end, with_gp=True)
                SPb, YPb = ok_[4][b], ok_[5][b]
            assert torch.equal(tk["xp"][b], x1) and torch.equal(tk["gp"][b], g1)
            assert torch.equal(tk["S"][b], Sb) and torch.equal(tk["Y"][b], Yb)
            _sum(SPb[:, 3], SP1[:, 3])
            _sum(YPb[:, 3], YP1[:, 3])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [6, 80])
def test_batched_fix_combines_on_card(cuda, m):
    """K6 b and K15 b's fix form against their plain versions (vectors
    1e-5, sums 1e-4, the damped rows bit for bit), and per live instance
    against the solo K6 and K15 fix: r and the damped row bit for bit; a
    frozen instance untouched."""
    a = _card_batch(cuda, m)
    live, end = a["live"], a["end"]
    stp1 = torch.full_like(a["stp"], 0.37)

    def k6(fn):
        Y, out = a["Y"].clone(), torch.zeros_like(a["d"])
        return Y, out, fn(a["gp"], a["S"], Y, a["coef"], live, out, end)

    def k15(fn):
        Y, out = a["Y"].clone(), torch.zeros_like(a["d"])
        return Y, out, fn(a["gp"], a["xp"], a["S"], Y, a["coef"], stp1, live, out, fix=end)

    fix = K.combine_probe_batched.fix_launches
    for call, kern, ref in ((k6, t_fused.combine_fix_batched, t_fused.combine_fix_batched_ref),
                            (k15, K.combine_probe_batched, K.combine_probe_batched_ref)):
        Yk, rk, sk = call(kern)
        Yp, rp, sp = call(ref)
        _vec(rk[live], rp[live])
        for u, v in zip(sk, sp):
            _sum(u[live], v[live])
        assert torch.equal(Yk, Yp)
        assert not rk[~live].any() and torch.equal(Yk[~live], a["Y"][~live])
        for b in torch.nonzero(live).flatten().tolist():
            cf = a["coef"][b]
            args = (cf[0], cf[1:1 + m], cf[1 + m:1 + 2 * m])
            Yb = a["Y"][b].clone()
            if call is k6:
                r1 = t_fused.combine_fix(a["gp"][b], a["S"][b], Yb, *args, end, cf[1 + 2 * m],
                                         cf[2 + 2 * m])[0]
            else:
                r1 = K.combine_probe(a["gp"][b], a["xp"][b], a["S"][b], Yb, *args, 0.37,
                                     fix=(end, cf[1 + 2 * m], cf[2 + 2 * m]))[0]
            assert torch.equal(rk[b], r1) and torch.equal(Yk[b], Yb), b
    assert K.combine_probe_batched.fix_launches == fix + 1


@pytest.mark.cuda
def test_batched_capped_combines_at_m80_on_card(cuda):
    """K3 b and K13 b at m = 80 (the coefficients sized at launch): r and rc
    bit for bit the solo K3 and K13 on each live instance."""
    m = 80
    a = _card_batch(cuda, m)
    live, (lo, hi) = a["live"], a["window"]
    coef = a["coef"][:, :1 + 2 * m].contiguous()
    r, rc = torch.zeros_like(a["d"]), torch.zeros_like(a["d"])
    t_fused.combine_batched(a["gp"], a["S"], a["Y"], coef, live, r)
    t_fused.combine_ow_batched(a["pg"], a["S"], a["Y"], coef, live, rc, lo, hi)
    for b in torch.nonzero(live).flatten().tolist():
        args = (coef[b, 0], coef[b, 1:1 + m], coef[b, 1 + m:])
        assert torch.equal(r[b], t_fused.combine(a["gp"][b], a["S"][b], a["Y"][b], *args)[0])
        assert torch.equal(rc[b], t_fused.combine_ow(a["pg"][b], a["S"][b], a["Y"][b], *args,
                                                     lo, hi)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["damped", "damped_uncapped", "owlqn_damped",
                                 "owlqn_damped_uncapped"])
def test_batched_damped_run_on_card(cuda, run):
    """A damped batched run on the card (m = 6 and 80) against the same run's
    plain versions on the card after 8 iterations (fused-vs-unfused
    rule)."""
    n, Bk = 1 << 12, 16
    x0b = (t_rosen.initial_point(n, torch.float32, "cuda")[None, :]
           + 0.05 * torch.randn(Bk, n, device=cuda, generator=torch.Generator(
               device=cuda).manual_seed(0)))
    fn = t_rosen.value_and_grad
    for m in (6, 80):
        p = PARAMS[run].replace(max_iterations=9, epsilon=0.0, history_dtype="bfloat16", m=m)
        if p.orthantwise is not None:
            p = p.replace(orthantwise=TOrthantwise(1.0, 0, n - 1))
        a = t_batched.minimize_batched(p, x0b, fn)
        b = t_batched.minimize_batched(p, x0b, fn.plain)
        assert torch.equal(a["niter"], b["niter"]) and torch.equal(a["neval"], b["neval"])
        torch.testing.assert_close(a["fx"], b["fx"], rtol=1e-3, atol=0)
