"""The composed OWL-QN kernels K9, K11 and K12 and the projected trial K7
of the PyTorch port against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain version; here those plain
versions meet the TPU kernels run through the Pallas interpreter (or the
JAX package's plain reference where its kernel needs a lane-aligned n) on
the same inputs, made from a seed with numpy, with NaN and signed zeros
in the point and the orthant and windows whose ends fall inside the
blocks.  Tolerances: K9's zero pattern exact and its values at the JAX
test's rel 1e-5 (the TPU kernel may fuse xp + stp*d into an fma; the
port rounds each operation); K11 at rel 1e-6 and bit for bit the port's
own K10 pseudo-gradient; K12's ring rows exact and its products at rel
3e-4, at an f32 history only: the JAX package's plain reference takes the
products of the STORED row, the kernels of the unrounded pair, which
differ at a bf16 history; K7 at rel 1e-5 on vectors and sums, its ft bit
for bit K8's (the remat contract), in both objective-scalar modes.  The
cases marked ``cuda`` hold each hand-written kernel to its plain version
on the card and skip without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.orthantwise import Orthantwise, choose_orthant
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.ops import fused as j_fused

STP, M = 0.37, 6
#: float32 values where the sign conventions part (NaN and both zeros)
SPECIAL = np.array([np.nan, 0.0, -0.0, 1.5, -2.0, -0.0, 0.0, np.nan], np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _close(t, j, rtol, atol=0.0):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    np.testing.assert_allclose(t, np.asarray(j, np.float64).reshape(t.shape), rtol=rtol,
                               atol=atol)


def _vectors(n, seed, special=True):
    """xp, d, wp, g with exact zeros, and with NaN and signed zeros planted
    at a stride in xp and wp."""
    rng = np.random.default_rng(seed)
    f = lambda: rng.standard_normal(n).astype(np.float32)
    xp, d, wp, g = f(), f(), np.sign(f()), f()
    xp[::7] = 0.0
    if special:
        for a in (xp, wp):
            k = np.arange(3, n, 29)
            a[k] = SPECIAL[np.arange(k.size) % SPECIAL.size]
    return xp, d, wp, g


def _windows(n):
    return [(0, n), (3, n - 5), (n // 3 + 1, n - n // 4 - 1)]


@pytest.mark.parametrize("n", [100, 4096 + 17])
def test_k9_trial_step_matches_pallas(n):
    xp, d, wp, _ = _vectors(n, 1)
    for lo, hi in _windows(n):
        t = t_fused.owlqn_trial_step(_t(xp), _t(d), _t(wp), STP, lo, hi)
        j = np.asarray(j_fused.owlqn_trial_step_pallas(
            jnp.asarray(xp), jnp.asarray(d), jnp.asarray(wp), STP, lo, hi, interpret=True))
        tn = t.numpy()
        np.testing.assert_array_equal(tn == 0, j == 0)
        np.testing.assert_array_equal(np.isnan(tn), np.isnan(j))
        _close(t, j, rtol=1e-5, atol=1e-6)
        # the point is round(xp + round(stp*d)) projected: the port's rule
        want = torch.where(
            (torch.arange(n) >= lo) & (torch.arange(n) < hi)
            & (torch.sign(torch.nan_to_num(_t(xp) + STP * _t(d), nan=0.0))
               != torch.sign(torch.nan_to_num(_t(wp), nan=0.0))),
            0.0, _t(xp) + STP * _t(d))
        assert torch.equal(t.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n", [100, 4096 + 17])
def test_k11_pseudo_gradient_matches_pallas_and_k10(n):
    x, _, _, g = _vectors(n, 2)
    for lo, hi in _windows(n):
        t = t_fused.pseudo_gradient(_t(x), _t(g), 0.8, lo, hi)
        j = j_fused.owlqn_pseudo_gradient_pallas(jnp.asarray(x), jnp.asarray(g), 0.8, lo, hi,
                                                 interpret=True)
        _close(t, j, rtol=1e-6)
        np.testing.assert_array_equal(np.isnan(t.numpy()), np.isnan(np.asarray(j)))
        k10 = t_fused.pseudo_gradient_norm(_t(x), _t(g), 0.8, lo, hi)[0]
        assert torch.equal(t.view(torch.int32), k10.view(torch.int32))


def _pair_inputs(n, seed):
    rng = np.random.default_rng(seed)
    x, xp, gx, gp, pg = (rng.standard_normal(n).astype(np.float32) for _ in range(5))
    S, Y = (rng.standard_normal((M, n)).astype(np.float32) for _ in range(2))
    return x, xp, gx, gp, pg, S, Y


@pytest.mark.parametrize("end", [0, 5])
@pytest.mark.parametrize("n", [4096, 128 * 9])
def test_k12_pair_gram_xg_matches_pallas(n, end):
    x, xp, gx, gp, pg, S, Y = _pair_inputs(n, 17)
    St, Yt = _t(S), _t(Y)
    SP, YP = t_fused.pair_gram_xg(_t(x), _t(xp), _t(gx), _t(gp), _t(pg), St, Yt, end)
    ring = lambda a: jnp.asarray(a).reshape(M, n // 128, 128)
    S_j, Y_j, SP_j, YP_j = j_fused.pair_gram_update_xg_pallas(
        *(jnp.asarray(v) for v in (x, xp, gx, gp, pg)), ring(S), ring(Y), end,
        interpret=True)
    np.testing.assert_array_equal(St.numpy(), np.asarray(S_j).reshape(M, n))
    np.testing.assert_array_equal(Yt.numpy(), np.asarray(Y_j).reshape(M, n))
    _close(SP, SP_j, rtol=3e-4, atol=5e-2)
    _close(YP, YP_j, rtol=3e-4, atol=5e-2)


def test_k12_ragged_n_matches_jax_reference():
    """The JAX kernel needs a lane-aligned n: a ragged n is held against the
    JAX package's plain reference (f32 history, where its stored row is the
    unrounded pair)."""
    n, end = 4096 + 17, 3
    x, xp, gx, gp, pg, S, Y = _pair_inputs(n, 18)
    St, Yt = _t(S), _t(Y)
    SP, YP = t_fused.pair_gram_xg(_t(x), _t(xp), _t(gx), _t(gp), _t(pg), St, Yt, end)
    s_j, y_j, SP_j, YP_j = j_fused.pair_gram_xg_ref(
        *(jnp.asarray(v) for v in (x, xp, gx, gp, pg, S, Y)), end)
    np.testing.assert_array_equal(St[end].numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(Yt[end].numpy(), np.asarray(y_j))
    _close(SP, SP_j, rtol=1e-5, atol=1e-3)
    _close(YP, YP_j, rtol=1e-5, atol=1e-3)


def test_k12_bf16_ring_row_is_the_rounded_pair():
    """At a bf16 history the stored row is round(x - xp), round(gx - gp)
    and the products of row ``end`` use the unrounded pair."""
    n, end = 1000, 2
    x, xp, gx, gp, pg, S, Y = _pair_inputs(n, 19)
    Sb, Yb = _t(S, torch.bfloat16), _t(Y, torch.bfloat16)
    SP, YP = t_fused.pair_gram_xg(_t(x), _t(xp), _t(gx), _t(gp), _t(pg), Sb, Yb, end)
    s, y = _t(x) - _t(xp), _t(gx) - _t(gp)
    assert torch.equal(Sb[end], s.to(torch.bfloat16))
    assert torch.equal(Yb[end], y.to(torch.bfloat16))
    assert float(SP[end, 1]) == float(s @ s) and float(YP[end, 0]) == float(y @ y)


@pytest.mark.parametrize("wide", [False, True], ids=["f32", "wide"])
def test_k7_owlqn_trial_matches_pallas(wide):
    n, c = 4096 + 18, 0.8
    xp, d, wp, _ = _vectors(n, 30, special=False)
    wp = np.sign(np.random.default_rng(32).standard_normal(n)).astype(np.float32)
    lo, hi = 3, n - 5
    ctx = lambda mod: mod.wide_fx(wide)
    with ctx(t_fused):
        t = t_rosen.owlqn_trial(_t(xp), _t(d), _t(wp), STP, c, lo, hi)
        tp = t_rosen.owlqn_probe(_t(xp), _t(d), _t(wp), STP, c, lo, hi)
    args = (jnp.asarray(xp), jnp.asarray(d), jnp.asarray(wp), STP, c, lo, hi)
    with ctx(j_fused):
        jr = j_rosen.owlqn_trial_ref(*args)
        jk = j_rosen.owlqn_trial_pallas(*args, interpret=True)
    want_ft = torch.float64 if wide else torch.float32
    assert t[1].dtype == want_ft and t[0].dtype == t[2].dtype == torch.float32
    # the remat contract: K7's ft is K8's bit for bit
    assert t[1].item() == tp[0].item() and t[3].item() == tp[1].item()
    for j in (jr, jk):
        np.testing.assert_array_equal(t[0].numpy() == 0, np.asarray(j[0]) == 0)
        _close(t[0], j[0], rtol=1e-5, atol=1e-6)
        _close(t[2], j[2], rtol=1e-5, atol=1e-3)
        assert float(t[1]) == pytest.approx(float(j[1]), rel=1e-6)
        assert float(t[3]) == pytest.approx(float(j[3]), rel=1e-4, abs=1e-2)
        assert float(t[4]) == pytest.approx(float(j[4]), rel=1e-5)
        assert bool(t[5]) == bool(j[5])
    # the wide ft against an f64 sum of the f32 trial point
    x64 = t[0].double()
    f64 = t_rosen._plain_value_and_grad(x64)[0] + c * x64[lo:hi].abs().sum()
    assert abs(float(t[1]) / float(f64) - 1) < 1e-5


def test_k7_is_attached_and_plain_twin_routes_to_its_plain_version():
    vag = t_rosen.value_and_grad
    assert vag.__lbfgs_owlqn_trial__ is t_rosen.owlqn_trial
    assert vag.plain.__lbfgs_owlqn_trial__ is t_rosen.owlqn_trial_ref
    assert vag.__lbfgs_pseudo_gradient__ is t_fused.pseudo_gradient
    assert vag.plain.__lbfgs_pseudo_gradient__ is t_fused.pseudo_gradient_ref
    n = 64
    xp, d, wp, _ = (_t(a) for a in _vectors(n, 5, special=False))
    before = (t_rosen.owlqn_trial_ref.calls, t_rosen.owlqn_trial.launches)
    vag.plain.__lbfgs_owlqn_trial__(xp, d, wp, STP, 1.0, 0, n)
    vag.__lbfgs_owlqn_trial__(xp, d, wp, STP, 1.0, 0, n)
    assert (t_rosen.owlqn_trial_ref.calls, t_rosen.owlqn_trial.launches) == (
        before[0] + 2, before[1])


@pytest.mark.parametrize("call", [
    lambda v: t_fused.owlqn_trial_step(v, v, v, STP, 0, v.shape[0] + 1),
    lambda v: t_fused.pseudo_gradient(v, v, -1.0, 0, v.shape[0]),
    lambda v: t_fused.pseudo_gradient(v, v[:-1], 1.0, 0, v.shape[0]),
    lambda v: t_fused.pair_gram_xg(v, v, v, v, v, torch.zeros(M, v.shape[0]),
                                   torch.zeros(M, v.shape[0]), M),
], ids=["window", "negative_c", "shapes", "ring_row"])
def test_composed_kernels_reject_bad_arguments(call):
    with pytest.raises(ValueError):
        call(torch.zeros(16))


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
        a.reshape(-1).contiguous().view(torch.uint8), b.reshape(-1).contiguous().view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["owlqn_trial_step", "pseudo_gradient", "pair_gram_xg",
                                    "owlqn_trial", "owlqn_trial_wide"])
def test_kernel_matches_plain_on_card(cuda, kernel):
    n, lo, hi, c = 1 << 16, 3 * 1024 + 5, (1 << 16) - 7 * 1024 - 3, 0.7
    xp, d, wp, g = (_t(a).to(cuda) for a in _vectors(n, 40))
    if kernel == "owlqn_trial_step":
        k = t_fused.owlqn_trial_step(xp, d, wp, STP, lo, hi)
        assert _same_bits(k, t_fused.owlqn_trial_step_ref(xp, d, wp, STP, lo, hi))
    elif kernel == "pseudo_gradient":
        k = t_fused.pseudo_gradient(xp, g, c, lo, hi)
        assert _same_bits(k, t_fused.pseudo_gradient_norm(xp, g, c, lo, hi)[0])
        assert _same_bits(k, t_fused.pseudo_gradient_ref(xp, g, c, lo, hi))
    elif kernel == "pair_gram_xg":
        x, xp_, gx, gp, pg, S, Y = (_t(a).to(cuda) for a in _pair_inputs(n, 41))
        S, Y = S.to(torch.bfloat16), Y.to(torch.bfloat16)
        S2, Y2 = S.clone(), Y.clone()
        k = t_fused.pair_gram_xg(x, xp_, gx, gp, pg, S, Y, 2)
        p = t_fused.pair_gram_xg_ref(x, xp_, gx, gp, pg, S2, Y2, 2)
        assert _same_bits(S, S2) and _same_bits(Y, Y2)
        for a, b in zip(k, p):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    else:
        xp, d = (_t(a).to(cuda) for a in _vectors(n, 42, special=False)[:2])
        wp = choose_orthant(Orthantwise(c, lo, hi), xp, g)
        with t_fused.wide_fx(kernel.endswith("wide")):
            k = t_rosen.owlqn_trial(xp, d, wp, STP, c, lo, hi)
            kp = t_rosen.owlqn_probe(xp, d, wp, STP, c, lo, hi)
            p = t_rosen.owlqn_trial_ref(xp, d, wp, STP, c, lo, hi)
        assert _same_bits(k[1], kp[0]) and _same_bits(k[3], kp[1])
        assert _same_bits(k[0], p[0])
        for a, b in zip(k[1:5], p[1:5]):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        assert bool(k[5]) == bool(p[5])
