"""K1 b, K7 b and K5 b on the card (``cuda``-marked; they skip without
one): each against its plain version and, on instances 0, B/2 and B - 1,
against the solo kernels, and a batched run of the trial-only objective
against its instances' solo runs.  This file imports no JAX: the card's
cases compare with the port's own plain versions and solo kernels."""

import pytest

torch = pytest.importorskip("torch")

from lbfgs_torch import batched as t_batched
from lbfgs_torch import orthantwise as t_ow
from lbfgs_torch.minimize import minimize_jit as t_minimize_jit
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.orthantwise import Orthantwise as TOrthantwise
from lbfgs_torch.params import LbfgsParams as TParams

K = t_rosen.value_and_grad.kernels

#: Rosenbrock with its solo and batched trials and probes, and no one-pass
#: epilogue and no combine+probe fusion: the batched runner's trial route
HOOKS = ("__lbfgs_value_and_grad__", "__lbfgs_trial__", "__lbfgs_trial_probe__",
         "__lbfgs_owlqn_trial__", "__lbfgs_owlqn_probe__", "__lbfgs_owlqn_probe_pg__",
         "__lbfgs_trial_batched__", "__lbfgs_owlqn_trial_batched__", "__lbfgs_probe_batched__",
         "__lbfgs_owlqn_probe_pg_batched__")


def _trial_only(x):
    return t_rosen.value_and_grad(x)


for _name in HOOKS:
    setattr(_trial_only, _name, getattr(t_rosen.value_and_grad, _name))

PARAMS = {
    "capped": TParams(),
    "damped": TParams(damping=True),
    "owlqn": TParams(orthantwise=TOrthantwise(1.0, 0, None)),
}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_batch(dev, m=6, Bk=6, n=(1 << 12) + 2, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    live = torch.ones(Bk, dtype=torch.bool, device=dev)
    live[1::3] = False
    xp = -1.0 + 0.1 * r(Bk, n)
    xp[:, ::17] = 0.0
    return dict(xp=xp, d=0.1 * r(Bk, n), gx=r(Bk, n), gp=r(Bk, n), pg=r(Bk, n),
                S=(0.1 * r(Bk, m, n)).bfloat16(), Y=(0.1 * r(Bk, m, n)).bfloat16(),
                stp=0.2 + torch.rand(Bk, generator=g, device=dev), live=live, end=m - 3, c=0.7,
                window=(3, n - 5))


def _vec(a, b):
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def _sum(a, b):
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def _solo_rows(Bk):
    return sorted({0, Bk // 2, Bk - 1})


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["default", "wide"])
def test_k1b_k7b_on_card(cuda, wide):
    """K1 b and K7 b against their plain versions (1e-5 vectors, 1e-4 sums)
    and, on instances 0, B/2 and B - 1 when live, the solo K1 and K7 (with
    the search's orthant) bit for bit; their (fx, g.d) bit for bit K2 b's
    and K8 b's at the same step, in both modes of the objective scalar; a
    frozen instance's rows untouched."""
    a = _card_batch(cuda)
    live, (lo, hi), c = a["live"], a["window"], a["c"]
    with t_fused.wide_fx(wide):
        for ow in (False, True):
            kern = K.owlqn_trial_batched if ow else K.trial_batched
            ref = K.owlqn_trial_batched_ref if ow else K.trial_batched_ref
            args = ((a["xp"], a["d"], a["pg"], a["stp"], c, lo, hi, live) if ow else
                    (a["xp"], a["d"], a["stp"], live))
            launches = kern.launches
            xk, gk = torch.zeros_like(a["xp"]), torch.zeros_like(a["xp"])
            xr, gr = torch.zeros_like(a["xp"]), torch.zeros_like(a["xp"])
            sk, sr = kern(*args, xk, gk), ref(*args, xr, gr)
            assert kern.launches == launches + 1
            _vec(xk[live], xr[live])
            _vec(gk[live], gr[live])
            assert not xk[~live].any() and not gk[~live].any()
            for got, want in zip(sk[:-1], sr[:-1]):
                _sum(got[live].double(), want[live].double())
            if wide:
                assert sk[0].dtype == torch.float64
            probe = (K.owlqn_probe_pg_batched if ow else K.probe_batched)(*args)
            assert torch.equal(sk[0][live], probe[0][live]) and torch.equal(
                sk[1][live], probe[1][live])
            for b in _solo_rows(len(live)):
                if not live[b]:
                    continue
                if ow:
                    wp = t_ow.choose_orthant(TOrthantwise(1.0, lo, hi), a["xp"][b], a["pg"][b])
                    solo = K.owlqn_trial(a["xp"][b], a["d"][b], wp, float(a["stp"][b]), c, lo, hi)
                else:
                    solo = K.trial(a["xp"][b], a["d"][b], float(a["stp"][b]))
                assert torch.equal(xk[b], solo[0]) and torch.equal(gk[b], solo[2]), b


@pytest.mark.cuda
@pytest.mark.parametrize("m", [6, 80])
def test_k5b_on_card(cuda, m):
    """K5 b against its plain version (sums 1e-4, ring rows bit for bit)
    and, on instances 0, B/2 and B - 1 when live, against the solo K5: the
    rings bit for bit, the sums within the sum tolerance; the . gp launch's
    columns 0-2 and ring rows the 3-column launch's bit for bit; a frozen
    instance's rings untouched."""
    a = _card_batch(cuda, m)
    live, end = a["live"], a["end"]
    vecs = (a["stp"], a["d"], a["gx"], a["gp"])
    out = {}
    for with_gp in (False, True):
        Sk, Yk, Sp, Yp = a["S"].clone(), a["Y"].clone(), a["S"].clone(), a["Y"].clone()
        launches = t_fused.pair_gram_sd_batched.launches
        SPk, YPk = t_fused.pair_gram_sd_batched(*vecs, Sk, Yk, end, live, with_gp=with_gp)
        SPp, YPp = t_fused.pair_gram_sd_batched_ref(*vecs, Sp, Yp, end, live, with_gp=with_gp)
        assert t_fused.pair_gram_sd_batched.launches == launches + 1
        _sum(SPk[live], SPp[live])
        _sum(YPk[live], YPp[live])
        assert torch.equal(Sk, Sp) and torch.equal(Yk, Yp)
        assert torch.equal(Sk[~live], a["S"][~live]) and torch.equal(Yk[~live], a["Y"][~live])
        out[with_gp] = (SPk, YPk, Sk, Yk)
        for b in _solo_rows(len(live)):
            if not live[b]:
                continue
            Sb, Yb = a["S"][b].clone(), a["Y"][b].clone()
            SP1, YP1 = t_fused.pair_gram_sd(float(a["stp"][b]), *(v[b] for v in vecs[1:]), Sb, Yb,
                                            end, with_gp=with_gp)
            assert torch.equal(Sk[b], Sb) and torch.equal(Yk[b], Yb), b
            _sum(SPk[b], SP1)
            _sum(YPk[b], YP1)
    (SP3, YP3, S3, Y3), (SPg, YPg, Sg, Yg) = out[False], out[True]
    assert torch.equal(SPg[live][..., :3], SP3[live]) and torch.equal(YPg[live][..., :3],
                                                                       YP3[live])
    assert torch.equal(S3, Sg) and torch.equal(Y3, Yg)


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["capped", "damped", "owlqn"])
def test_batched_trial_route_run_on_card(cuda, run):
    """A batched run of the trial-only objective on the card (float32, a
    bfloat16 ring) against each instance's solo run on the card after 8
    iterations: the same iterations and evaluations, fx rel 1e-3."""
    n, Bk = 1 << 12, 4
    x0b = (t_rosen.initial_point(n, torch.float32, "cuda")[None, :]
           + 0.05 * torch.randn(Bk, n, device=cuda, generator=torch.Generator(
               device=cuda).manual_seed(0)))
    p = PARAMS[run].replace(max_iterations=9, epsilon=0.0, history_dtype="bfloat16")
    if p.orthantwise is not None:
        p = p.replace(orthantwise=TOrthantwise(1.0, 0, n - 1))
    st = t_batched.minimize_batched(p, x0b, _trial_only, return_state=True)
    for b in range(Bk):
        so = t_minimize_jit(p, x0b[b].clone(), _trial_only)
        assert (so.niter, so.neval) == (int(st.k[b]), int(st.neval[b]))
        assert float(st.fx[b]) == pytest.approx(float(so.fx), rel=1e-3)
