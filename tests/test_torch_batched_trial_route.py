"""The port's batched runner on an objective with a fused trial and probe
but no one-pass epilogue (``lbfgs_torch.batched``'s ``TRIAL`` route),
against the JAX package's (``lbfgs_tpu.batched``, whose vmap materializes
the accepted point with the trial and takes K5 for the pair) and against
its own solo runs, on the CPU, where K1 b, K7 b and K5 b run their plain
versions.

  * the plain versions of K1 b, K7 b and K5 b per instance against the JAX
    package's jnp oracles in float64 (rel 1e-12 on vectors, 1e-10 on
    sums; K5 b at m = 6 and 80, with and without the . gp column), each
    instance's point, gradient and ring rows bit for bit the solo plain
    versions', frozen instances untouched, K1 b's and K7 b's (f, g.d) bit
    for bit K2 b's and K8 b's (the remat contract);
  * eight perturbed instances in float64 against the JAX batched run on the
    same trial-only Rosenbrock after 15 iterations: the same k,
    evaluations, status, ring row, ``ncall`` and ``ls_status``; fx, the
    entry step, dginit and the carried norms rel 1e-9; the rings, Gram
    blocks and alphas rtol 1e-7.  Plain capped and uncapped, damped both
    ways, OWL-QN, damped OWL-QN and m = 80;
  * one case each way through the JAX package's vmapped Pallas K1, K5 and
    K7 in interpret mode (float32, a bfloat16 ring, n = 2^14);
  * each instance against the port's solo run; the launch path (K1 b, K5 b
    and K3 b per plain iteration, K6 b damped; K7 b, K10 b, K12 b and K13 b
    under OWL-QN; never K4 b or K14 b) and the reads.

The card's cases are in ``tests/test_torch_batched_trial_card.py``.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from lbfgs_torch import batched as t_batched
from lbfgs_torch import interop
from lbfgs_torch import lbfgs as t_lbfgs
from lbfgs_torch import orthantwise as t_ow
from lbfgs_torch.core import to_host
from lbfgs_torch.minimize import minimize_jit as t_minimize_jit
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.orthantwise import Orthantwise as TOrthantwise
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_tpu import batched as j_batched
from lbfgs_tpu import lbfgs as j_lbfgs
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.ops import fused as j_fused
from test_torch_batched import B, _close, _t
from test_torch_batched_generic import _both, _hold
from test_torch_batched_owlqn import OW, PERTURBED
from test_torch_batched_uncapped import LIVE

K = t_rosen.value_and_grad.kernels

#: the solo protocol of an objective with a fused trial and probe, and no
#: one-pass epilogue and no combine+probe fusion (both packages)
TRIAL_HOOKS = ("__lbfgs_value_and_grad__", "__lbfgs_trial__", "__lbfgs_trial_probe__",
               "__lbfgs_owlqn_trial__", "__lbfgs_owlqn_probe__", "__lbfgs_owlqn_probe_pg__")
#: and the port's batched probe and trial
BATCHED_TRIAL_HOOKS = ("__lbfgs_trial_batched__", "__lbfgs_owlqn_trial_batched__",
                       "__lbfgs_probe_batched__", "__lbfgs_owlqn_probe_pg_batched__")


def trial_only(vag, hooks):
    """``vag`` with only the attributes ``hooks`` of its protocol."""
    def fn(x):
        return vag(x)

    for name in hooks:
        setattr(fn, name, getattr(vag, name))
    return fn


T_TRIAL = trial_only(t_rosen.value_and_grad, TRIAL_HOOKS + BATCHED_TRIAL_HOOKS)
J_TRIAL = trial_only(j_rosen.value_and_grad, TRIAL_HOOKS)


@pytest.fixture(autouse=True)
def _quiet():
    # ``with_orthantwise``'s one-line notice that OWL-QN runs backtracking only
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


# ---------------------------------------------------------------------------
# the plain versions against the JAX package's references (float64)
# ---------------------------------------------------------------------------

WINDOWS = {"edge": (0, 63), "interior": (5, 50)}


@pytest.fixture(scope="module")
def trial_batch():
    n = 64
    rng = np.random.RandomState(19)
    Bk = len(LIVE)
    xp = np.where(np.arange(n) % 2 == 0, -1.2, 1.0) + 0.1 * rng.randn(Bk, n)
    xp[:, ::9] = 0.0
    return dict(xp=xp, d=0.3 * rng.randn(Bk, n), pg=rng.randn(Bk, n), stp=0.2 + rng.rand(Bk),
                c=0.7, sx=rng.randn(Bk, n), sg=rng.randn(Bk, n))


def test_k1b_plain_matches_jax(trial_batch):
    """The batched trial against the JAX package's K1 oracle, per instance
    the solo K1's plain version bit for bit (point and gradient), its (fx,
    g.d) K2 b's bit for bit; a frozen instance's rows untouched."""
    a = trial_batch
    xt, g = _t(a["sx"]), _t(a["sg"])
    args = (_t(a["xp"]), _t(a["d"]), _t(a["stp"]), _t(LIVE))
    fx, dg, gg, xx, changed = K.trial_batched(*args, xt, g)
    for b in range(len(LIVE)):
        if not LIVE[b]:
            assert np.array_equal(xt[b].numpy(), a["sx"][b])
            assert np.array_equal(g[b].numpy(), a["sg"][b])
            continue
        jx, jf, jg, jdg, jgg, jxx, jch = j_rosen.trial_ref(
            jnp.asarray(a["xp"][b]), jnp.asarray(a["d"][b]), a["stp"][b])
        _close(xt[b], jx, 1e-12)
        _close(g[b], jg, 1e-12)
        for got, want in ((fx, jf), (dg, jdg), (gg, jgg), (xx, jxx)):
            _close(got[b], want, 1e-10)
        assert bool(changed[b]) == bool(jch)
        sx, _sf, sg, *_ = K.trial_ref(_t(a["xp"][b]), _t(a["d"][b]), a["stp"][b])
        assert torch.equal(xt[b], sx) and torch.equal(g[b], sg), b
    pf, pd = K.probe_batched(*args)
    live = _t(LIVE)
    assert torch.equal(fx[live], pf[live]) and torch.equal(dg[live], pd[live])


@pytest.mark.parametrize("window", list(WINDOWS))
def test_k7b_plain_matches_jax(trial_batch, window):
    """The batched projected trial against the JAX package's K7 oracle with
    the search's orthant, per instance the solo K7's plain version bit for
    bit, its (ft, g.d) K8 b's bit for bit; a frozen instance's rows
    untouched; the window projects something."""
    a = trial_batch
    lo, hi = WINDOWS[window]
    xt, g = _t(a["sx"]), _t(a["sg"])
    args = (_t(a["xp"]), _t(a["d"]), _t(a["pg"]), _t(a["stp"]), a["c"], lo, hi, _t(LIVE))
    ft, dg, xx, changed = K.owlqn_trial_batched(*args, xt, g)
    for b in range(len(LIVE)):
        if not LIVE[b]:
            assert np.array_equal(xt[b].numpy(), a["sx"][b])
            continue
        wp = t_ow.choose_orthant(TOrthantwise(1.0, lo, hi), _t(a["xp"][b]), _t(a["pg"][b]))
        jx, jft, jg, jdg, jxx, jch = j_rosen.owlqn_trial_ref(
            jnp.asarray(a["xp"][b]), jnp.asarray(a["d"][b]), jnp.asarray(wp.numpy()),
            a["stp"][b], a["c"], lo, hi)
        _close(xt[b], jx, 1e-12)
        _close(g[b], jg, 1e-12)
        for got, want in ((ft, jft), (dg, jdg), (xx, jxx)):
            _close(got[b], want, 1e-10)
        assert bool(changed[b]) == bool(jch)
        sx, _sf, sg, *_ = K.owlqn_trial_ref(_t(a["xp"][b]), _t(a["d"][b]), wp, a["stp"][b],
                                            a["c"], lo, hi)
        assert torch.equal(xt[b], sx) and torch.equal(g[b], sg), b
    pf, pd = K.owlqn_probe_pg_batched(*args)
    live = _t(LIVE)
    assert torch.equal(ft[live], pf[live]) and torch.equal(dg[live], pd[live])
    assert (xt[live][:, lo:hi] == 0).any()


@pytest.fixture(scope="module", params=(6, 80), ids=lambda m: f"m{m}")
def pair_batch(request):
    m, n = request.param, 64
    rng = np.random.RandomState(21 + m)
    Bk = len(LIVE)
    return dict(m=m, end=m - 3, d=0.3 * rng.randn(Bk, n), gx=rng.randn(Bk, n),
                gp=rng.randn(Bk, n), S=rng.randn(Bk, m, n), Y=rng.randn(Bk, m, n),
                stp=0.2 + rng.rand(Bk))


@pytest.mark.parametrize("with_gp", [False, True], ids=["3col", "gp"])
def test_k5b_plain_matches_jax(pair_batch, with_gp):
    """The batched pair + Gram update against the JAX package's K5 oracle
    (sums 1e-10, ring rows bit for bit), per instance the solo K5's plain
    version (ring rows bit for bit, sums 1e-12: torch's batched and
    unbatched products may add in other orders); the . gp launch's columns
    0-2 the 3-column launch's bit for bit; a frozen instance's rings
    untouched."""
    a, end = pair_batch, pair_batch["end"]
    vecs = (_t(a["stp"]), _t(a["d"]), _t(a["gx"]), _t(a["gp"]))
    S, Y = _t(a["S"]), _t(a["Y"])
    SP, YP = t_fused.pair_gram_sd_batched(*vecs, S, Y, end, _t(LIVE), with_gp=with_gp)
    assert SP.shape[1:] == YP.shape[1:] == (a["m"], 4 if with_gp else 3)
    if with_gp:
        SP3, YP3 = t_fused.pair_gram_sd_batched(*vecs, _t(a["S"]), _t(a["Y"]), end, _t(LIVE))
        assert torch.equal(SP[..., :3], SP3) and torch.equal(YP[..., :3], YP3)
    for b in range(len(LIVE)):
        if not LIVE[b]:
            assert np.array_equal(S[b].numpy(), a["S"][b])
            assert np.array_equal(Y[b].numpy(), a["Y"][b])
            continue
        s = a["stp"][b] * a["d"][b]
        js, jy, jSP, jYP = j_fused.pair_gram_ref(
            jnp.asarray(s), jnp.zeros_like(jnp.asarray(s)),
            *(jnp.asarray(a[k][b]) for k in ("gx", "gp", "S", "Y")), end, with_gp=with_gp)
        _close(SP[b], jSP, 1e-10)
        _close(YP[b], jYP, 1e-10)
        assert np.array_equal(S[b, end].numpy(), np.asarray(js))
        assert np.array_equal(Y[b, end].numpy(), np.asarray(jy))
        Sb, Yb = _t(a["S"][b]), _t(a["Y"][b])
        sSP, sYP = t_fused.pair_gram_sd_ref(a["stp"][b], *(_t(a[k][b]) for k in ("d", "gx", "gp")),
                                            Sb, Yb, end, with_gp=with_gp)
        assert torch.equal(S[b], Sb) and torch.equal(Y[b], Yb), b
        _close(SP[b], sSP.numpy(), 1e-12)
        _close(YP[b], sYP.numpy(), 1e-12)


# ---------------------------------------------------------------------------
# whole runs against the JAX package
# ---------------------------------------------------------------------------

_ow = lambda b: b.with_orthantwise(*OW)
_unc = lambda b: b.with_constrain_step_size(False)
_damp = lambda b: b.with_damping(True)

RUNS = {
    "capped": lambda b: b,
    "uncapped": _unc,
    "damped": _damp,
    "damped_uncapped": lambda b: _unc(_damp(b)),
    "owlqn": _ow,
    "owlqn_damped": lambda b: _ow(_damp(b)),
    "m80": lambda b: b._new(b.param.replace(m=80)),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_trial_route_matches_jax_15_iterations(run):
    j, t = _both(RUNS[run], fn=(J_TRIAL, T_TRIAL))
    _hold(j, t)
    assert (t.k == 15).sum() >= B - 1
    if run == "m80":
        assert t.hist.s.shape[1] == 80


# ---------------------------------------------------------------------------
# the JAX package's vmapped Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

N_KERNEL = j_fused.MIN_FUSED_N


@pytest.mark.parametrize("ow", [False, True], ids=["plain", "owlqn"])
def test_against_jax_vmapped_kernels_interpret(monkeypatch, ow):
    """Three iterations at n = 2^14, B = 2, float32 vectors and a bfloat16
    ring, the JAX package's vmapped K1 and K5 (plain) or K7 (OWL-QN, c = 1
    on [0, n - 1)) in interpret mode against the port's trial route: the
    same iterations and evaluations, fx rel 1e-5, the ring rows within 1e-2
    of each ring's largest element (y = g - gp cancels, so one element of y
    may part by two bfloat16 ulps of its own)."""
    monkeypatch.setenv("LBFGS_TPU_KERNELS_INTERPRET", "1")
    monkeypatch.setenv("LBFGS_TPU_KERNELS", "all")
    # the JAX run is traced anew, through the Pallas kernels counted here
    monkeypatch.setattr(j_batched, "_BATCH_CACHE", {})
    jk = j_rosen.value_and_grad.kernels
    names = ("owlqn_trial_pallas",) if ow else ("trial_pallas", "pair_gram_update_pallas")
    traced = dict.fromkeys(names, 0)

    def counted(name, fn):
        def wrapper(*a, **kw):
            traced[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name in traced:
        owner = j_fused if name.startswith("pair_gram") else jk
        monkeypatch.setattr(owner, name, counted(name, getattr(owner, name)))
    rng = np.random.RandomState(1)
    base = np.asarray(j_rosen.initial_point(N_KERNEL, dtype=jnp.float32))
    x0b = base[None, :] + 0.05 * rng.randn(2, N_KERNEL).astype(np.float32)

    def cfg(b):
        b = b.with_history_dtype("bfloat16").with_epsilon(0.0).with_max_iterations(4)
        return b.with_orthantwise(1.0, 0, N_KERNEL - 1) if ow else b

    j = cfg(j_lbfgs()).minimize_batched(jnp.asarray(x0b), J_TRIAL, return_state=True)
    assert all(traced.values()), traced
    refs = ((K.owlqn_trial_batched_ref,) if ow else
            (K.trial_batched_ref, t_fused.pair_gram_sd_batched_ref))
    calls = [f.calls for f in refs]
    t = cfg(t_lbfgs()).minimize_batched(_t(x0b), T_TRIAL, return_state=True)
    assert [f.calls - c for f, c in zip(refs, calls)] == [3] * len(refs)
    js = interop.batched_state_from_jax(j, "cpu")
    assert np.array_equal(t.k, js.k) and np.array_equal(t.neval, js.neval)
    np.testing.assert_allclose(t.fx, js.fx, rtol=1e-5)
    assert t.hist.s.dtype == torch.bfloat16
    for name in ("s", "y"):
        _close(getattr(t.hist, name).float(), getattr(js.hist, name).float().numpy(), 1e-2)


# ---------------------------------------------------------------------------
# against the port's own solo runs
# ---------------------------------------------------------------------------

_TOW = TOrthantwise(*OW)
PARAMS = {
    "capped": TParams(),
    "uncapped": TParams(constrain_step_size=False),
    "damped": TParams(damping=True),
    "owlqn": TParams(orthantwise=_TOW),
    "owlqn_damped": TParams(damping=True, orthantwise=_TOW),
}


@pytest.mark.parametrize("run", list(PARAMS))
def test_trial_route_matches_port_solo(run):
    """Each instance against its solo run on the same objective (the K5
    route; under damped OWL-QN the solo run takes K12's . gp form where the
    batch composes its pair, as the JAX runner does) after 15 iterations:
    the same k, evaluations and status, fx rel 1e-9, x within 1e-9."""
    p = PARAMS[run].replace(max_iterations=15)
    st = t_batched.minimize_batched(p, _t(PERTURBED), T_TRIAL, return_state=True)
    for b in range(B):
        so = t_minimize_jit(p, _t(PERTURBED[b]), T_TRIAL, return_state=True)
        assert (so.k, so.prob.neval, so.status) == (int(st.k[b]), int(st.neval[b]),
                                                    int(st.status[b])), b
        assert float(st.fx[b]) == pytest.approx(float(so.prob.fx), rel=1e-9)
        np.testing.assert_allclose(st.x[b].numpy(), so.prob.x.numpy(), atol=1e-9, rtol=0)


def test_route_names_the_branch():
    """``batched.route``: the factory objective takes its epilogue over a
    ring the kernels take with the compact two-loop, the trial route where
    the epilogue does not run (the scan, a float16 ring, no epilogue hook),
    and a hook-free objective the generic branch."""
    x, S = torch.zeros(2, 8), torch.zeros(2, 3, 8)
    p = TParams()
    route = t_batched.route
    assert route(p, t_rosen.value_and_grad, x, S) == t_batched.EPILOGUE
    assert route(p, t_rosen.value_and_grad, x, S.half()) == t_batched.TRIAL
    assert route(p.replace(compact_two_loop=False), t_rosen.value_and_grad, x,
                 S) == t_batched.TRIAL
    for q in (p, p.replace(orthantwise=_TOW)):
        assert route(q, T_TRIAL, x, S) == t_batched.TRIAL
        assert route(q, t_rosen._plain_value_and_grad, x, S) == t_batched.GENERIC
    # the probe without the batched trial: the generic branch
    probe_only = trial_only(t_rosen.value_and_grad, ("__lbfgs_probe_batched__",))
    assert route(p, probe_only, x, S) == t_batched.GENERIC


# ---------------------------------------------------------------------------
# the launch path and the reads
# ---------------------------------------------------------------------------

#: (plain versions per iteration, plain versions never called), by path
PATHS = {
    "capped": ((K.trial_batched_ref, t_fused.pair_gram_sd_batched_ref,
                t_fused.combine_batched_ref),
               (K.trial_pair_gram_batched_ref, t_fused.combine_fix_batched_ref,
                t_fused.pair_gram_xg_batched_ref)),
    "damped": ((K.trial_batched_ref, t_fused.pair_gram_sd_batched_ref,
                t_fused.combine_fix_batched_ref),
               (K.trial_pair_gram_batched_ref, t_fused.combine_batched_ref)),
    "owlqn": ((K.owlqn_trial_batched_ref, t_fused.pseudo_gradient_norm_batched_ref,
               t_fused.pair_gram_xg_batched_ref, t_fused.combine_ow_batched_ref),
              (K.owlqn_trial_pair_gram_batched_ref, t_fused.pair_gram_sd_batched_ref,
               K.trial_batched_ref)),
    "owlqn_damped": ((K.owlqn_trial_batched_ref, t_fused.pseudo_gradient_norm_batched_ref,
                      t_fused.combine_ow_batched_ref),
                     (K.owlqn_trial_pair_gram_batched_ref, t_fused.pair_gram_xg_batched_ref,
                      t_fused.pair_gram_sd_batched_ref)),
}


@pytest.mark.parametrize("run", list(PATHS))
def test_trial_route_launch_path_and_reads(run):
    """Per iteration one of each of the path's kernels (K1 b, K5 b and K3 b,
    damped K6 b; under OWL-QN K7 b, K10 b, K12 b and K13 b, damped no K12
    b), never K4 b or K14 b; each trip one batched probe (K2 b; K8 b) and
    one read, and one read per iteration after the init's."""
    p = PARAMS[run].replace(max_iterations=12)
    want, none = PATHS[run]
    trips = K.owlqn_probe_pg_batched_ref if p.orthantwise else K.probe_batched_ref
    refs = (*want, *none, trips)
    before, reads = [f.calls for f in refs], to_host.reads
    st = t_batched.minimize_batched(p, _t(PERTURBED), T_TRIAL, return_state=True)
    calls = [f.calls - b0 for f, b0 in zip(refs, before)]
    reads = to_host.reads - reads
    iters = int(st.k.max()) - 1
    assert iters == 11
    assert calls[:len(want)] == [iters] * len(want)
    assert calls[len(want):len(want) + len(none)] == [0] * len(none)
    assert calls[-1] == reads - 1 - iters >= iters
