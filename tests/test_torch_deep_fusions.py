"""The one-pass epilogues K4 and K14 and the combine+probe fusions K15 and
K16 of the PyTorch port above ``factory.MAX_M`` = 64 ring rows, where the
card runs their deep forms, against the JAX package, which runs its Pallas
kernels at every depth.

On the CPU each wrapper runs its plain version at any depth; here those
meet the JAX package's kernels run through the Pallas interpreter on the
same inputs (float32 vectors and rings, n = 256, made from a seed with
numpy) at m = 65 and 80: K4 and K14 with the . gp column (the JAX
kernel's columns 0-2 are its 3-column launch's, so one launch holds both
of the port's column sets), K15 (K6's combine with K2's probe at its r
for the damped-row form, as the JAX package has no fused form of it) and
K16.  Tolerances, stated per output:

- ring rows: the rows not written bit for bit; row ``end`` of S in K4 (s
  = stp*d, one rounding in both) bit for bit; the rows that hold a
  gradient or a projected point (K4's Y row, K14's two rows) and K15-fix's
  damped row normwise 1e-5, since XLA on the CPU contracts the JAX
  kernels' multiply-adds (x = xp + stp*d, the body's gradient) where the
  port rounds each operation;
- vectors (x, g, pg, r, rc): normwise 1e-5 (max |port - JAX| over max
  |JAX|), for the same reason;
- sums and products (the scalars, the [m, 3|4] Gram blocks): normwise
  1e-4: the JAX kernels add in their own order.

Then the route at m = 65: one solver run's iterations through K4 and K15
(under OWL-QN K14 and K16), counted by their plain versions, and none
through K1 (K7), K5 (K12) or K3 (K13).  The cases marked ``cuda`` hold
each deep form to its plain version and to the kernels it shares its
function with on the card, and skip without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import factory as t_factory
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.params import Lbfgs as TLbfgs
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.ops import fused as j_fused

N, STP, C = 256, 0.37, 0.7
#: an OWL-QN window whose ends fall inside the 128-lane rows
LO, HI = 5, N - 9
VEC = 1e-5
SUM = 1e-4
DEPTHS = (65, 80)


def _normwise(t, j, tol, what):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    j = np.asarray(j, np.float64).reshape(t.shape)
    err = np.abs(t - j).max() / max(np.abs(j).max(), 1e-300)
    assert err <= tol, f"{what}: normwise {err:.3e} above {tol:.0e}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _ring(H):
    m, n = H.shape
    return jnp.asarray(H).reshape(m, n // 128, 128)


@pytest.fixture(scope="module", params=DEPTHS, ids=lambda m: f"m{m}")
def data(request):
    m = request.param
    rng = np.random.default_rng(m)
    f32 = lambda a: np.asarray(a, np.float32)
    x0 = np.where(np.arange(N) % 2 == 0, -1.2, 1.0)
    return dict(
        m=m, end=m - 3,
        xp=f32(x0 + 0.1 * rng.standard_normal(N)),
        # a point with exact zeros (the orthant's at-zero choice)
        xp0=f32(np.where(np.arange(N) % 17 == 0, 0.0, x0 + 0.1 * rng.standard_normal(N))),
        d=f32(0.1 * rng.standard_normal(N)), gp=f32(rng.standard_normal(N)),
        pg=f32(rng.standard_normal(N)),
        S=f32(0.1 * rng.standard_normal((m, N))), Y=f32(0.1 * rng.standard_normal((m, N))),
        cs=f32(0.1 * rng.standard_normal(m)), cy=f32(0.1 * rng.standard_normal(m)),
    )


def _rings_written(St, Yt, S_j, Y_j, data, exact_s):
    """The port's rings after an epilogue against the JAX kernel's: every
    row but ``end`` unchanged, bit for bit; row end of S bit for bit where
    ``exact_s``, else normwise; row end of Y normwise."""
    m, end = data["m"], data["end"]
    S_j, Y_j = np.asarray(S_j).reshape(m, N), np.asarray(Y_j).reshape(m, N)
    keep = [j for j in range(m) if j != end]
    for ring, t, j, inp in (("S", St, S_j, data["S"]), ("Y", Yt, Y_j, data["Y"])):
        assert np.array_equal(t.numpy()[keep], inp[keep]), ring
        assert np.array_equal(j[keep], inp[keep]), ring
    if exact_s:
        assert np.array_equal(St.numpy()[end], S_j[end])
    else:
        _normwise(St[end], S_j[end], VEC, "S[end]")
    _normwise(Yt[end], Y_j[end], VEC, "Y[end]")


def test_k4_deep_matches_pallas(data):
    """K4's plain version at m > 64, both column sets, against the JAX
    kernel's . gp launch in interpret mode."""
    j = j_rosen.trial_pair_gram_pallas(
        *(jnp.asarray(data[k]) for k in ("xp", "d", "gp")), STP, _ring(data["S"]),
        _ring(data["Y"]), data["end"], interpret=True, with_gp=True)
    for with_gp in (False, True):
        St, Yt = _t(data["S"]), _t(data["Y"])
        t = t_rosen.trial_pair_gram(_t(data["xp"]), _t(data["d"]), _t(data["gp"]),
                                    np.float32(STP), St, Yt, data["end"], with_gp=with_gp)
        _rings_written(St, Yt, j[7], j[8], data, exact_s=True)
        _normwise(t[0], j[0], VEC, "x")
        _normwise(t[2], j[2], VEC, "g")
        for i in (1, 3, 4, 5):
            _normwise(t[i], j[i], SUM, f"sum {i}")
        assert bool(t[6]) == bool(j[6])
        cols = 4 if with_gp else 3
        assert t[7].shape == t[8].shape == (data["m"], cols)
        _normwise(t[7], np.asarray(j[9])[:, :cols], SUM, "SP")
        _normwise(t[8], np.asarray(j[10])[:, :cols], SUM, "YP")


def test_k14_deep_matches_pallas(data):
    """K14's plain version at m > 64, both column sets (with gp.gp and
    gp.pg), against the JAX kernel's . gp launch in interpret mode."""
    j = j_rosen.owlqn_trial_pair_gram_pallas(
        *(jnp.asarray(data[k]) for k in ("xp0", "d", "gp", "pg")), STP, C, LO, HI,
        _ring(data["S"]), _ring(data["Y"]), data["end"], interpret=True, with_gp=True)
    # (x, g, pg, S, Y, SP, YP, xx, pgpg, changed, gpgp, gppg)
    for with_gp in (False, True):
        St, Yt = _t(data["S"]), _t(data["Y"])
        t = t_rosen.owlqn_trial_pair_gram(
            *(_t(data[k]) for k in ("xp0", "d", "gp", "pg")), np.float32(STP), C, LO, HI,
            St, Yt, data["end"], with_gp=with_gp)
        _rings_written(St, Yt, j[3], j[4], data, exact_s=False)
        for i, what in ((0, "x"), (1, "g"), (2, "pg")):
            _normwise(t[i], j[i], VEC, what)
        np.testing.assert_array_equal(t[0].numpy() == 0, np.asarray(j[0]) == 0)
        cols = 4 if with_gp else 3
        _normwise(t[3], np.asarray(j[5])[:, :cols], SUM, "SP")
        _normwise(t[4], np.asarray(j[6])[:, :cols], SUM, "YP")
        _normwise(t[5], j[7], SUM, "x.x")
        _normwise(t[6], j[8], SUM, "pg.pg")
        assert bool(t[7]) == bool(j[9])
        if with_gp:
            _normwise(t[8], j[10], SUM, "gp.gp")
            _normwise(t[9], j[11], SUM, "gp.pg")


def _coefs(data):
    return (torch.tensor(-0.4), _t(data["cs"]), _t(data["cy"]))


def test_k15_deep_matches_pallas(data):
    """K15's plain version at m > 64 against the JAX kernel, and its
    damped-row form against the JAX package's K6 (r, r.r, r.g and the
    row) with K2's probe at that r."""
    g, x = (data[k] for k in ("gp", "xp"))
    for stp1 in (1.0, 0.37):
        t = t_rosen.combine_probe(_t(g), _t(x), _t(data["S"]), _t(data["Y"]), *_coefs(data),
                                  stp1)
        j = j_rosen.combine_probe_pallas(jnp.asarray(g), jnp.asarray(x), _ring(data["S"]),
                                         _ring(data["Y"]), -0.4, jnp.asarray(data["cs"]),
                                         jnp.asarray(data["cy"]), stp1, interpret=True)
        _normwise(t[0], j[0], VEC, "r")
        for i in (1, 2, 3, 4):
            _normwise(t[i], j[i], SUM, f"sum {i}")
    ca, cb, end = 0.7, -0.2, data["end"]
    Yt = _t(data["Y"])
    t = t_rosen.combine_probe(_t(g), _t(x), _t(data["S"]), Yt, *_coefs(data), 0.37,
                              fix=(end, torch.tensor(ca), torch.tensor(cb)))
    r, rr, rd, Y_j = j_fused.combine_fix_pallas(
        jnp.asarray(g), _ring(data["S"]), _ring(data["Y"]), -0.4, jnp.asarray(data["cs"]),
        jnp.asarray(data["cy"]), end, ca, cb, interpret=True)
    ft, dg = j_rosen.probe_pallas(jnp.asarray(x), r, 0.37, interpret=True)
    _normwise(t[0], r, VEC, "r")
    for i, ref in ((1, rr), (2, rd), (3, ft), (4, dg)):
        _normwise(t[i], ref, SUM, f"sum {i}")
    keep = [j for j in range(data["m"]) if j != end]
    Y_j = np.asarray(Y_j).reshape(data["m"], N)
    assert np.array_equal(Yt.numpy()[keep], data["Y"][keep])
    assert np.array_equal(Y_j[keep], data["Y"][keep])
    _normwise(Yt[end], Y_j[end], VEC, "damped row")


def test_k16_deep_matches_pallas(data):
    """K16's plain version at m > 64 against the JAX kernel."""
    pg, x = (data[k] for k in ("pg", "xp0"))
    for stp1 in (1.0, 0.37):
        t = t_rosen.combine_ow_probe(_t(pg), _t(x), _t(data["S"]), _t(data["Y"]),
                                     *_coefs(data), C, LO, HI, stp1)
        j = j_rosen.combine_ow_probe_pallas(
            jnp.asarray(pg), jnp.asarray(x), _ring(data["S"]), _ring(data["Y"]), -0.4,
            jnp.asarray(data["cs"]), jnp.asarray(data["cy"]), C, LO, HI, stp1,
            interpret=True)
        np.testing.assert_array_equal(t[0].numpy() == 0, np.asarray(j[0]) == 0)
        _normwise(t[0], j[0], VEC, "rc")
        for i in (1, 2, 3, 4, 5):
            _normwise(t[i], j[i], SUM, f"sum {i}")


# ---------------------------------------------------------------------------
# The route at m = 65
# ---------------------------------------------------------------------------


def _calls():
    k = t_rosen.value_and_grad.kernels
    refs = dict(K1=k.trial_ref, K4=k.trial_pair_gram_ref, K7=k.owlqn_trial_ref,
                K14=k.owlqn_trial_pair_gram_ref, K15=k.combine_probe_ref,
                K16=k.combine_ow_probe_ref, K3=t_fused.combine_ref, K5=t_fused.pair_gram_sd_ref,
                K12=t_fused.pair_gram_xg_ref, K13=t_fused.combine_ow_ref)
    return {name: fn.calls for name, fn in refs.items()}


@pytest.mark.parametrize("owlqn", [False, True], ids=["plain", "owlqn"])
def test_deep_history_takes_the_epilogue_and_the_fusion(owlqn):
    """At m = 65 with the uncapped step every iteration runs K4 and K15
    (K14 and K16 under OWL-QN) once; the trial kernel runs at the start
    only, and K5, K12, K3 and K13 never."""
    b = (TLbfgs(TParams(m=65)).with_constrain_step_size(False).with_max_iterations(6))
    if owlqn:
        b = b.with_orthantwise(1.0, 0, 99)
    before = _calls()
    r = b.minimize(t_rosen.initial_point(100, device="cpu"), t_rosen.value_and_grad)
    iters = r.niter - 1
    assert iters >= 3
    d = {k: v - before[k] for k, v in _calls().items()}
    epilogue, fusion = ("K14", "K16") if owlqn else ("K4", "K15")
    assert (d[epilogue], d[fusion]) == (iters, iters), d
    assert d["K1"] == 1 and d["K7"] == 0, d
    assert d["K3"] == d["K5"] == d["K12"] == d["K13"] == 0, d


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    a, b = a.reshape(-1).contiguous(), b.reshape(-1).contiguous()
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.uint8), b.view(torch.uint8))


def _near(a, b, tol, what):
    a, b = a.double().cpu(), b.double().cpu()
    err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
    assert err <= tol, f"{what}: normwise {err:.3e} above {tol:.0e}"


def _card_inputs(n, m, vd, hd):
    g = torch.Generator(device="cuda").manual_seed(m)
    r = lambda *s, dt=vd: torch.randn(*s, generator=g, device="cuda",
                                      dtype=torch.float64).to(dt)
    x0 = torch.where(torch.arange(n, device="cuda") % 2 == 0, -1.2, 1.0).to(torch.float64)
    xp = (x0 + 0.1 * r(n, dt=torch.float64)).to(vd)
    xp0 = xp.clone()
    xp0[::17] = 0.0
    return dict(xp=xp, xp0=xp0, d=0.1 * r(n), gp=r(n), pg=r(n), S=r(m, n, dt=hd),
                Y=r(m, n, dt=hd), coefs=(torch.tensor(0.8, dtype=vd, device="cuda"), r(m), r(m)))


#: (n, m, dtypes): every depth in the three dtype pairs at a ragged n, and
#: programs of two tiles each (``factory.solo_epilogue_grid``) at m = 65
CARD_CASES = [(100_006, m, dt) for m in (65, 80, 130)
              for dt in ((torch.float32, torch.bfloat16), (torch.float32, torch.float32),
                         (torch.float64, torch.float64))]
CARD_CASES.append((2_500_002, 65, (torch.float32, torch.bfloat16)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,dtypes", CARD_CASES, ids=str)
def test_deep_forms_on_card(cuda, n, m, dtypes, monkeypatch):
    """The deep forms (the tensor-core forms off: the solo K4 and K14 take
    them at these depths, ``tests/test_torch_solo_epilogue_launch.py``)
    against their plain versions: ring rows bit for bit;
    K4's and K14's x, g, pg, objective and changed bit for bit the static
    launch's at m = 6 on the same vectors and their scalar sums at the sum
    tolerance (torch sums the partials' columns by the array's width); the
    . gp launch's columns 0-2 and other outputs bit for bit the 3-column
    launch's; an in-place launch bit for bit the launch into fresh
    vectors; K15's r bit for bit K3's and its probe K2's, K15-fix's r and
    row K6's, K16's rc K13's and its probe K8's pg form's; every other
    output normwise 1e-5 (vectors) and 1e-4 (sums) in float32, 1e-12 and
    1e-10 in float64; no deep form spills registers."""
    vd, hd = dtypes
    tv, ts = (1e-5, 1e-4) if vd == torch.float32 else (1e-12, 1e-10)
    monkeypatch.setattr(t_factory, "MMA_MAX_M", 0)
    monkeypatch.setattr(t_factory, "MMA_ROWS_MIN_M",
                        dict.fromkeys(t_factory.MMA_ROWS_MIN_M, 1 << 62))
    a = _card_inputs(n, m, vd, hd)
    xp, xp0, d, gp, pg, S, Y = (a[k] for k in ("xp", "xp0", "d", "gp", "pg", "S", "Y"))
    end, lo, hi = m - 3, 5, n - 9
    k = t_rosen.value_and_grad.kernels
    assert m > t_factory.MAX_M
    # K4 and K14, each against the static launch at m = 6 and its plain version
    st4 = k.trial_pair_gram(xp, d, gp, STP, S[:6].clone(), Y[:6].clone(), 2)
    st14 = k.owlqn_trial_pair_gram(xp0, d, gp, pg, STP, C, lo, hi, S[:6].clone(),
                                   Y[:6].clone(), 2, with_gp=True)
    base = {}
    for with_gp in (False, True):
        for form in ("K4", "K14"):
            before = getattr(k, "trial_pair_gram" if form == "K4"
                             else "owlqn_trial_pair_gram").deep_launches
            rings = [(S.clone(), Y.clone()) for _ in range(3)]
            if form == "K4":
                call = lambda ring, *v, **kw: k.trial_pair_gram(*v, STP, *ring, end,
                                                                 with_gp=with_gp, **kw)
                vecs = (xp, d, gp)
                ref = k.trial_pair_gram_ref(xp, d, gp, STP, *rings[1], end, with_gp=with_gp)
                point, flag, static, sums = (0, 1, 2), 6, st4, (3, 4, 5)
                pair = lambda out, x0_: (STP * d, out[2] - gp)
            else:
                call = lambda ring, *v, **kw: k.owlqn_trial_pair_gram(
                    *v, STP, C, lo, hi, *ring, end, with_gp=with_gp, **kw)
                vecs = (xp0, d, gp, pg)
                ref = k.owlqn_trial_pair_gram_ref(xp0, d, gp, pg, STP, C, lo, hi, *rings[1],
                                                  end, with_gp=with_gp)
                point, flag, static = (0, 1, 2), 7, st14
                sums = (5, 6, 8, 9) if with_gp else (5, 6)
                pair = lambda out, x0_: (out[0] - x0_, out[1] - gp)
            out = call(rings[0], *vecs)
            assert getattr(k, "trial_pair_gram" if form == "K4"
                           else "owlqn_trial_pair_gram").deep_launches == before + 1
            for (Sr, Yr), o in ((rings[0], out), (rings[1], ref)):
                s, y = pair(o, vecs[0])
                keep = [j for j in range(m) if j != end]
                assert _same(Sr[keep], S[keep]) and _same(Yr[keep], Y[keep]), form
                assert _same(Sr[end], s.to(hd)) and _same(Yr[end], y.to(hd)), form
            for i in point + (flag,):
                assert _same(out[i], static[i]), (form, with_gp, i)
            for i in sums:
                _near(out[i], static[i], ts, f"{form} sum {i} vs static")
            for i, (o, r_) in enumerate(zip(out, ref)):
                if o.dtype == torch.bool:
                    assert bool(o) == bool(r_)
                else:
                    _near(o, r_, tv if o.shape == xp.shape else ts, f"{form} {i}")
            if with_gp:
                cols = (7, 8) if form == "K4" else (3, 4)
                b_out, b_ring = base[form]
                for i, (o3, o4) in enumerate(zip(b_out, out)):
                    assert _same(o3, o4[:, :3] if i in cols else o4), (form, i)
                assert _same(rings[0][0], b_ring[0]) and _same(rings[0][1], b_ring[1])
            base[form] = (out, rings[0])
            fresh = tuple(v.clone() for v in vecs)
            inplace = call(rings[2], *fresh, inplace=True)
            assert all(_same(o, i) for o, i in zip(out, inplace)), form
            assert _same(rings[2][0], rings[0][0]) and _same(rings[2][1], rings[0][1])
    # K15 and its damped row against K3, K6 and K2; K16 against K13 and K8
    coefs = a["coefs"]
    r3 = t_fused.combine(gp, S, Y, *coefs)
    out = k.combine_probe(gp, xp, S, Y, *coefs, 1.0)
    ref = k.combine_probe_ref(gp, xp, S, Y, *coefs, 1.0)
    assert _same(out[0], r3[0])
    assert all(_same(o, p) for o, p in zip(out[3:], k.probe(xp, out[0], 1.0)))
    _near(out[0], ref[0], tv, "K15 r")
    for i in (1, 2, 3, 4):
        _near(out[i], ref[i], ts, f"K15 sum {i}")
    ca, cb = (torch.tensor(v, dtype=vd, device="cuda") for v in (0.7, -0.2))
    Yk, Yp, Y6 = Y.clone(), Y.clone(), Y.clone()
    out = k.combine_probe(gp, xp, S, Yk, *coefs, 0.37, fix=(end, ca, cb))
    k.combine_probe_ref(gp, xp, S, Yp, *coefs, 0.37, fix=(end, ca, cb))
    r6 = t_fused.combine_fix(gp, S, Y6, *coefs, end, ca, cb)
    assert _same(Yk, Yp) and _same(Yk, Y6) and _same(out[0], r6[0])
    assert all(_same(o, p) for o, p in zip(out[3:], k.probe(xp, out[0], 0.37)))
    r13 = t_fused.combine_ow(pg, S, Y, *coefs, lo, hi)
    out = k.combine_ow_probe(pg, xp0, S, Y, *coefs, C, lo, hi, 1.0)
    ref = k.combine_ow_probe_ref(pg, xp0, S, Y, *coefs, C, lo, hi, 1.0)
    assert _same(out[0], r13[0])
    assert all(_same(o, p) for o, p in zip(out[4:],
                                           k.owlqn_probe_pg(xp0, out[0], pg, 1.0, C, lo, hi)))
    _near(out[0], ref[0], tv, "K16 rc")
    for i in (1, 2, 3, 4, 5):
        _near(out[i], ref[i], ts, f"K16 sum {i}")
    for fn in (k.trial_pair_gram, k.owlqn_trial_pair_gram, k.combine_probe,
               k.combine_ow_probe):
        for key, compiled in fn.deep_compiled.items():
            compiled._init_handles()
            assert compiled.n_spills == 0, (fn.__name__, key, compiled.n_regs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.bfloat16),
                                    (torch.float32, torch.float32),
                                    (torch.float64, torch.float64)], ids=str)
def test_deep_epilogues_are_the_static_ones_where_both_run(cuda, dtypes, monkeypatch):
    """At m = 19, which both fold forms take with their caps raised (several
    groups of rows, the last partial; the tensor-core form off), the deep
    epilogues' outputs are the static forms' bit for bit: x, g, pg, the
    rings and every scalar sum (the partials have the same shape, so torch
    sums their columns alike); the products at the sum tolerance."""
    vd, hd = dtypes
    ts = 1e-4 if vd == torch.float32 else 1e-10
    n, m = 100_006, 19
    a = _card_inputs(n, m, vd, hd)
    k = t_rosen.value_and_grad.kernels

    def run():
        out = {}
        for with_gp in (False, True):
            Sk, Yk = a["S"].clone(), a["Y"].clone()
            out["K4", with_gp] = (*k.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, Sk, Yk, 4,
                                                     with_gp=with_gp), Sk, Yk)
            Sk, Yk = a["S"].clone(), a["Y"].clone()
            out["K14", with_gp] = (*k.owlqn_trial_pair_gram(
                a["xp0"], a["d"], a["gp"], a["pg"], STP, C, 5, n - 9, Sk, Yk, 4,
                with_gp=with_gp), Sk, Yk)
        return out

    monkeypatch.setattr(t_factory, "MMA_MAX_M", 0)
    monkeypatch.setattr(t_factory, "MMA_ROWS_MIN_M",
                        dict.fromkeys(t_factory.MMA_ROWS_MIN_M, 1 << 62))
    monkeypatch.setattr(t_factory, "EPILOGUE_MAX_M",
                        dict.fromkeys(t_factory.EPILOGUE_MAX_M, t_factory.MAX_M))
    static = run()
    before = k.trial_pair_gram.deep_launches
    monkeypatch.setattr(t_factory, "MAX_M", 6)
    monkeypatch.setattr(t_factory, "EPILOGUE_MAX_M", dict.fromkeys(t_factory.EPILOGUE_MAX_M, 6))
    deep = run()
    assert k.trial_pair_gram.deep_launches == before + 2
    for key, outs in deep.items():
        products = (7, 8) if key[0] == "K4" else (3, 4)
        for i, (o, s) in enumerate(zip(outs, static[key])):
            if i in products:
                _near(o, s, ts, f"{key} products {i}")
            else:
                assert _same(o, s), (key, i)
