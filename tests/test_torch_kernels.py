"""K1-K4, OWL-QN's K8, K10, K13 and K14, and the damped path's K5, K6 and
the . gp columns of K4 and K14 of the PyTorch port against the JAX
package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain version; here those plain
versions meet the TPU kernels run through the Pallas interpreter on the
same inputs (n = 2^14, m = 6, f32 vectors, bf16 history), made from a
seed with numpy.  Tolerances: rel 1e-5 on vectors (the same f32
elementwise arithmetic), rel 1e-4 on the reductions (the sums run in
another order); ring rows within one bf16 ulp of the JAX kernel's and bit
for bit the port's own rounding; with the . gp column, columns 0-2 and
every other output bit for bit those of the 3-column form.  The OWL-QN
window's ends fall inside the 128-lane rows.  The cases marked ``cuda`` hold each hand-written
kernel to its plain version on the card and skip without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import factory as t_factory
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.orthantwise import Orthantwise, choose_orthant
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.ops import fused as j_fused

N, M, STP, END = 1 << 14, 6, 0.37, 2
#: OWL-QN's L1 weight and a window whose ends are off the kernel blocks
C, LO, HI = 0.7, 3 * 128 + 5, N - 7 * 128 - 3
VEC = dict(rtol=1e-5)
SUM = dict(rtol=1e-4)


def _close(t, j, tol, scale=None):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    j = np.asarray(j).astype(np.float64)
    atol = tol["rtol"] * (np.abs(j).max() if scale is None else scale)
    np.testing.assert_allclose(t, j, rtol=tol["rtol"], atol=atol)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    x0 = np.where(np.arange(N) % 2 == 0, -1.2, 1.0)
    f32 = lambda a: a.astype(np.float32)
    return dict(
        xp=f32(x0 + 0.1 * rng.standard_normal(N)),
        d=f32(0.1 * rng.standard_normal(N)),
        gp=f32(rng.standard_normal(N)),
        S=f32(rng.standard_normal((M, N))),
        Y=f32(rng.standard_normal((M, N))),
        cs=f32(rng.standard_normal(M)),
        cy=f32(rng.standard_normal(M)),
        # OWL-QN: a point with exact zeros (the orthant's at-zero choice)
        # and a pseudo-gradient
        xp0=f32(np.where(np.arange(N) % 17 == 0, 0.0, x0 + 0.1 * rng.standard_normal(N))),
        pg=f32(rng.standard_normal(N)),
    )


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _ring(a):
    """bf16 [m, n] -> the JAX package's ring-major [m, n/128, 128]."""
    return jnp.asarray(a, jnp.bfloat16).reshape(M, N // 128, 128)


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _assert_ring_write(S, Y, S0, Y0, s, y):
    """K4's ring write, bit for bit: row END holds (s, y) rounded to the
    history dtype, every other row its input."""
    keep = [j for j in range(M) if j != END]
    assert _same_bits(S[END], s.to(S.dtype))
    assert _same_bits(Y[END], y.to(Y.dtype))
    assert _same_bits(S[keep], S0[keep])
    assert _same_bits(Y[keep], Y0[keep])


def test_k1_trial_matches_pallas(data):
    t = t_rosen.trial(_t(data["xp"]), _t(data["d"]), np.float32(STP))
    j = j_rosen.trial_pallas(jnp.asarray(data["xp"]), jnp.asarray(data["d"]),
                             STP, interpret=True)
    _close(t[0], j[0], VEC)
    _close(t[2], j[2], VEC)
    for i in (1, 3, 4, 5):
        _close(t[i], j[i], SUM)
    assert bool(t[6]) == bool(j[6])


def test_k2_probe_matches_pallas(data):
    t = t_rosen.probe(_t(data["xp"]), _t(data["d"]), np.float32(STP))
    j = j_rosen.probe_pallas(jnp.asarray(data["xp"]), jnp.asarray(data["d"]),
                             STP, interpret=True)
    _close(t[0], j[0], SUM)
    _close(t[1], j[1], SUM)


def test_k3_combine_matches_pallas(data):
    S, Y = _t(data["S"], torch.bfloat16), _t(data["Y"], torch.bfloat16)
    t = t_fused.combine(_t(data["gp"]), S, Y, torch.tensor(-0.8),
                        _t(data["cs"]), _t(data["cy"]))
    j = j_fused.combine_pallas(jnp.asarray(data["gp"]), _ring(data["S"]),
                               _ring(data["Y"]), -0.8, jnp.asarray(data["cs"]),
                               jnp.asarray(data["cy"]), interpret=True)
    _close(t[0], j[0], VEC)
    _close(t[1], j[1], SUM)
    _close(t[2], j[2], SUM)


def test_k4_trial_pair_gram_matches_pallas(data):
    S, Y = _t(data["S"], torch.bfloat16), _t(data["Y"], torch.bfloat16)
    xp = _t(data["xp"])
    t = t_rosen.trial_pair_gram(xp, _t(data["d"]), _t(data["gp"]), np.float32(STP),
                                S, Y, END)
    j = j_rosen.trial_pair_gram_pallas(
        jnp.asarray(data["xp"]), jnp.asarray(data["d"]), jnp.asarray(data["gp"]),
        STP, _ring(data["S"]), _ring(data["Y"]), END, interpret=True)
    _close(t[0], j[0], VEC)
    _close(t[2], j[2], VEC)
    for i in (1, 3, 4, 5):
        _close(t[i], j[i], SUM)
    assert bool(t[6]) == bool(j[6])
    # ring row `end` written in place, rounded to bf16; the other rows kept
    _close(S.float(), np.asarray(j[7]).astype(np.float32).reshape(M, N), VEC)
    _close(Y.float(), np.asarray(j[8]).astype(np.float32).reshape(M, N), VEC)
    _assert_ring_write(S, Y, _t(data["S"], torch.bfloat16), _t(data["Y"], torch.bfloat16),
                       float(np.float32(STP)) * _t(data["d"]), t[2] - _t(data["gp"]))
    # 6m products, row `end` from the unrounded pair
    _close(t[7], j[9], SUM)
    _close(t[8], j[10], SUM)
    # without inplace the previous point is left as it was
    assert torch.equal(xp, _t(data["xp"]))


def test_k4_inplace_overwrites_previous_point(data):
    xp, gp = _t(data["xp"]), _t(data["gp"])
    S, Y = _t(data["S"]), _t(data["Y"])
    x, _, g = t_rosen.trial_pair_gram(xp, _t(data["d"]), gp, np.float32(STP),
                                      S, Y, END, inplace=True)[:3]
    assert x.data_ptr() == xp.data_ptr() and g.data_ptr() == gp.data_ptr()
    np.testing.assert_array_equal(xp.numpy(), data["xp"] + np.float32(STP) * data["d"])


def _bf16_ulps(a, b):
    """Distance in bf16 units in the last place, element by element."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def test_k8_owlqn_probe_matches_pallas(data):
    xp, d, pg = (_t(data[k]) for k in ("xp0", "d", "pg"))
    wp = choose_orthant(Orthantwise(C, LO, HI), xp, pg)
    t_wp = t_rosen.owlqn_probe(xp, d, wp, np.float32(STP), C, LO, HI)
    t_pg = t_rosen.owlqn_probe_pg(xp, d, pg, np.float32(STP), C, LO, HI)
    jx = [jnp.asarray(data[k]) for k in ("xp0", "d")]
    j_wp = j_rosen.owlqn_probe_pallas(*jx, jnp.asarray(wp.numpy()), STP, C, LO, HI,
                                      interpret=True)
    j_pg = j_rosen.owlqn_probe_pg_pallas(*jx, jnp.asarray(data["pg"]), STP, C, LO, HI,
                                         interpret=True)
    for t, j in ((t_wp, j_wp), (t_pg, j_pg)):
        _close(t[0], j[0], SUM)
        _close(t[1], j[1], SUM)
    # the orthant rebuilt from (xp, pg) gives the materialized one's scalars
    assert _same_bits(t_wp[0].reshape(1), t_pg[0].reshape(1))
    assert _same_bits(t_wp[1].reshape(1), t_pg[1].reshape(1))


def test_k10_pseudo_gradient_norm_matches_pallas(data):
    t = t_fused.pseudo_gradient_norm(_t(data["xp0"]), _t(data["gp"]), C, LO, HI)
    j = j_fused.owlqn_pseudo_gradient_norm_pallas(
        jnp.asarray(data["xp0"]), jnp.asarray(data["gp"]), C, LO, HI, interpret=True)
    _close(t[0], j[0], VEC)
    _close(t[1], j[1], SUM)


def test_k13_combine_ow_matches_pallas(data):
    S, Y = _t(data["S"], torch.bfloat16), _t(data["Y"], torch.bfloat16)
    t = t_fused.combine_ow(_t(data["pg"]), S, Y, torch.tensor(-0.8), _t(data["cs"]),
                           _t(data["cy"]), LO, HI)
    j = j_fused.combine_ow_pallas(jnp.asarray(data["pg"]), _ring(data["S"]),
                                  _ring(data["Y"]), -0.8, jnp.asarray(data["cs"]),
                                  jnp.asarray(data["cy"]), LO, HI, interpret=True)
    _close(t[0], j[0], VEC)
    for i in (1, 2, 3):
        _close(t[i], j[i], SUM)
    # the constraint zeroed elements inside the window only
    rc = t[0].numpy()
    assert (rc[LO:HI] == 0).any() and (rc[:LO] != 0).all()


def test_k14_owlqn_trial_pair_gram_matches_pallas(data):
    S, Y = _t(data["S"], torch.bfloat16), _t(data["Y"], torch.bfloat16)
    xp, d, gp, pg = (_t(data[k]) for k in ("xp0", "d", "gp", "pg"))
    t = t_rosen.owlqn_trial_pair_gram(xp, d, gp, pg, np.float32(STP), C, LO, HI,
                                      S, Y, END)
    j = j_rosen.owlqn_trial_pair_gram_pallas(
        *(jnp.asarray(data[k]) for k in ("xp0", "d", "gp", "pg")), STP, C, LO, HI,
        _ring(data["S"]), _ring(data["Y"]), END, interpret=True)
    for i in (0, 1, 2):          # x, g, pg_new
        _close(t[i], j[i], VEC)
    np.testing.assert_array_equal(t[0].numpy() == 0, np.asarray(j[0]) == 0)
    _close(t[3], j[5], SUM)      # SP, YP: row `end` from the unrounded pair
    _close(t[4], j[6], SUM)
    _close(t[5], j[7], SUM)      # x.x
    _close(t[6], j[8], SUM)      # pg.pg
    assert bool(t[7]) == bool(j[9])
    # ring row `end`: one bf16 ulp of the JAX kernel's, bit for bit the
    # port's own rounding of its (x - xp, g - gp); the other rows kept
    for ring, jr in ((S, j[3]), (Y, j[4])):
        jr = torch.from_numpy(np.asarray(jr).astype(np.float32).reshape(M, N))
        assert int(_bf16_ulps(ring[END], jr[END].to(torch.bfloat16)).max()) <= 1
    _assert_ring_write(S, Y, _t(data["S"], torch.bfloat16), _t(data["Y"], torch.bfloat16),
                       t[0] - xp, t[1] - gp)


def test_k14_inplace_overwrites_previous_point(data):
    xp, gp, pg = _t(data["xp0"]), _t(data["gp"]), _t(data["pg"])
    S, Y = _t(data["S"]), _t(data["Y"])
    want = t_rosen.owlqn_trial_pair_gram(xp.clone(), _t(data["d"]), gp.clone(),
                                         pg.clone(), np.float32(STP), C, LO, HI,
                                         S.clone(), Y.clone(), END)
    x, g, pg_new = t_rosen.owlqn_trial_pair_gram(xp, _t(data["d"]), gp, pg,
                                                 np.float32(STP), C, LO, HI, S, Y, END,
                                                 inplace=True)[:3]
    assert (x.data_ptr(), g.data_ptr(), pg_new.data_ptr()) == (
        xp.data_ptr(), gp.data_ptr(), pg.data_ptr())
    for a, b in zip((xp, gp, pg), want[:3]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the damped path: K5, K6, and the . gp columns of K4 and K14
# ---------------------------------------------------------------------------


def _assert_row_near_jax(ring, jax_ring):
    """Ring row END within one bf16 ulp of the JAX kernel's."""
    jr = torch.from_numpy(np.asarray(jax_ring).astype(np.float32).reshape(M, N))
    assert int(_bf16_ulps(ring[END], jr[END].to(torch.bfloat16)).max()) <= 1


@pytest.mark.parametrize("with_gp", [False, True], ids=["3col", "4col"])
def test_k5_pair_gram_matches_pallas(data, with_gp):
    S, Y = _t(data["S"], torch.bfloat16), _t(data["Y"], torch.bfloat16)
    d, gx, gp = _t(data["d"]), _t(data["xp"]), _t(data["gp"])
    SP, YP = t_fused.pair_gram_sd(np.float32(STP), d, gx, gp, S, Y, END, with_gp=with_gp)
    j = j_fused.pair_gram_update_pallas(
        STP, jnp.asarray(data["d"]), jnp.asarray(data["xp"]), jnp.asarray(data["gp"]),
        _ring(data["S"]), _ring(data["Y"]), END, interpret=True, with_gp=with_gp)
    assert SP.shape == YP.shape == (M, 4 if with_gp else 3)
    _close(SP, j[2], SUM)
    _close(YP, j[3], SUM)
    # ring row `end`: one bf16 ulp of the JAX kernel's, bit for bit the
    # port's own rounding of (stp*d, gx - gp); the other rows kept
    _assert_row_near_jax(S, j[0])
    _assert_row_near_jax(Y, j[1])
    _assert_ring_write(S, Y, _t(data["S"], torch.bfloat16), _t(data["Y"], torch.bfloat16),
                       float(np.float32(STP)) * d, gx - gp)


def test_k5_plain_version_uses_the_unrounded_pair(data):
    """At a bf16 history the plain K5 is ``pair_products`` of the
    unrounded pair bit for bit, as the kernel holds it in registers; the
    old stand-in, whose products saw the stored (rounded) row, differs."""
    S0, Y0 = _t(data["S"], torch.bfloat16), _t(data["Y"], torch.bfloat16)
    d, gx, gp = _t(data["d"]), _t(data["xp"]), _t(data["gp"])
    stp = float(np.float32(STP))
    out = t_fused.pair_gram_sd_ref(stp, d, gx, gp, S0.clone(), Y0.clone(), END)
    want = t_fused.pair_products(stp * d, gx - gp, -gx, S0.clone(), Y0.clone(), END)
    old = t_fused.pair_gram_ref(stp * d, gx - gp, gx, S0.clone(), Y0.clone(), END)
    for a, b in zip(out, want):
        assert _same_bits(a, b)
    assert not torch.equal(out[0][END], old[0][END])
    assert not torch.equal(out[1][END], old[1][END])
    # rows other than `end` see the same stored rings either way
    keep = [j for j in range(M) if j != END]
    assert torch.equal(out[0][keep], old[0][keep])


@pytest.mark.parametrize("kernel", ["pair_gram_sd", "trial_pair_gram",
                                    "owlqn_trial_pair_gram"])
def test_with_gp_columns_extend_the_base_form(data, kernel):
    """Columns 0-2 and every other output of the . gp form equal the
    3-column form bit for bit (tests/test_damped_fused.py:52-67)."""
    S0, Y0 = _t(data["S"], torch.bfloat16), _t(data["Y"], torch.bfloat16)
    d, gp, pg = _t(data["d"]), _t(data["gp"]), _t(data["pg"])

    def run(with_gp):
        S, Y = S0.clone(), Y0.clone()
        if kernel == "pair_gram_sd":
            out = t_fused.pair_gram_sd(np.float32(STP), d, _t(data["xp"]), gp, S, Y, END,
                                       with_gp=with_gp)
        elif kernel == "trial_pair_gram":
            out = t_rosen.trial_pair_gram(_t(data["xp"]), d, gp, np.float32(STP), S, Y, END,
                                          with_gp=with_gp)
        else:
            out = t_rosen.owlqn_trial_pair_gram(_t(data["xp0"]), d, gp, pg, np.float32(STP),
                                                C, LO, HI, S, Y, END, with_gp=with_gp)
        return list(out), S, Y

    base, S3, Y3 = run(False)
    ext, S4, Y4 = run(True)
    assert _same_bits(S3, S4) and _same_bits(Y3, Y4)
    sp = {"pair_gram_sd": 0, "trial_pair_gram": 7, "owlqn_trial_pair_gram": 3}[kernel]
    for i, (a, b) in enumerate(zip(base, ext)):
        if i in (sp, sp + 1):
            assert b.shape == (M, 4)
            b = b[:, :3].contiguous()
        assert _same_bits(a.reshape(-1), b.reshape(-1)), i
    assert len(ext) == len(base) + (2 if kernel == "owlqn_trial_pair_gram" else 0)


def test_k4_with_gp_matches_pallas(data):
    S, Y = _t(data["S"], torch.bfloat16), _t(data["Y"], torch.bfloat16)
    t = t_rosen.trial_pair_gram(_t(data["xp"]), _t(data["d"]), _t(data["gp"]),
                                np.float32(STP), S, Y, END, with_gp=True)
    j = j_rosen.trial_pair_gram_pallas(
        jnp.asarray(data["xp"]), jnp.asarray(data["d"]), jnp.asarray(data["gp"]),
        STP, _ring(data["S"]), _ring(data["Y"]), END, interpret=True, with_gp=True)
    _close(t[0], j[0], VEC)
    _close(t[2], j[2], VEC)
    for i in (1, 3, 4, 5):
        _close(t[i], j[i], SUM)
    _close(t[7], j[9], SUM)       # SP, YP [m, 4]
    _close(t[8], j[10], SUM)
    _assert_row_near_jax(S, j[7])
    _assert_row_near_jax(Y, j[8])


def test_k14_with_gp_matches_pallas(data):
    S, Y = _t(data["S"], torch.bfloat16), _t(data["Y"], torch.bfloat16)
    xp, d, gp, pg = (_t(data[k]) for k in ("xp0", "d", "gp", "pg"))
    t = t_rosen.owlqn_trial_pair_gram(xp, d, gp, pg, np.float32(STP), C, LO, HI,
                                      S, Y, END, with_gp=True)
    j = j_rosen.owlqn_trial_pair_gram_pallas(
        *(jnp.asarray(data[k]) for k in ("xp0", "d", "gp", "pg")), STP, C, LO, HI,
        _ring(data["S"]), _ring(data["Y"]), END, interpret=True, with_gp=True)
    for i in (0, 1, 2):          # x, g, pg_new
        _close(t[i], j[i], VEC)
    _close(t[3], j[5], SUM)      # SP, YP [m, 4]
    _close(t[4], j[6], SUM)
    for i, ji in ((5, 7), (6, 8), (8, 10), (9, 11)):   # x.x, pg.pg, gp.gp, gp.pg
        _close(t[i], j[ji], SUM)
    assert bool(t[7]) == bool(j[9])
    _assert_row_near_jax(S, j[3])
    _assert_row_near_jax(Y, j[4])


def test_k6_combine_fix_matches_pallas(data):
    S, Y = _t(data["S"], torch.bfloat16), _t(data["Y"], torch.bfloat16)
    Y0 = Y.clone()
    ca, cb = torch.tensor(0.7), torch.tensor(-0.2)
    g = _t(data["gp"])
    t = t_fused.combine_fix(g, S, Y, torch.tensor(-0.4), _t(data["cs"]), _t(data["cy"]),
                            END, ca, cb)
    j = j_fused.combine_fix_pallas(jnp.asarray(data["gp"]), _ring(data["S"]),
                                   _ring(data["Y"]), -0.4, jnp.asarray(data["cs"]),
                                   jnp.asarray(data["cy"]), END, 0.7, -0.2, interpret=True)
    _close(t[0], j[0], VEC)      # r over the rings BEFORE the fix
    _close(t[1], j[1], SUM)
    _close(t[2], j[2], SUM)
    # the fixed row: one bf16 ulp of the JAX kernel's, bit for bit the
    # port's own round(ca*Y[end] + cb*g); the other rows untouched
    _assert_row_near_jax(Y, j[3])
    want = (ca * Y0[END].float() + cb * g).to(torch.bfloat16)
    assert _same_bits(Y[END], want)
    keep = [i for i in range(M) if i != END]
    assert _same_bits(Y[keep], Y0[keep])
    assert _same_bits(S, _t(data["S"], torch.bfloat16))


def test_plain_versions_are_counted_and_kernels_are_not_on_cpu(data):
    before = (t_rosen.probe_ref.calls, t_rosen.probe.launches)
    t_rosen.probe(_t(data["xp"]), _t(data["d"]), np.float32(STP))
    assert t_rosen.probe_ref.calls == before[0] + 1
    assert t_rosen.probe.launches == before[1]


@pytest.mark.parametrize("combo", [
    (torch.float32, torch.float16), (torch.float64, torch.float32),
    (torch.float16, torch.float16),
])
def test_unsupported_dtype_combinations_raise(combo):
    vd, hd = combo
    d = torch.ones(8, dtype=vd)
    S = torch.zeros((2, 8), dtype=hd)
    with pytest.raises(TypeError):
        t_fused.combine(d, S, S, torch.tensor(1.0, dtype=vd),
                        torch.zeros(2, dtype=vd), torch.zeros(2, dtype=vd))


def test_odd_n_raises():
    x = torch.ones(7)
    with pytest.raises(ValueError, match="even n"):
        t_rosen.trial(x, x, 0.0)
    with pytest.raises(ValueError, match="even n"):
        t_rosen.initial_point(7, device="cpu")


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _cuda_inputs(data, dev, hd=torch.bfloat16):
    g = lambda k, dt=torch.float32: _t(data[k], dt).to(dev)
    return g("xp"), g("d"), g("gp"), g("S", hd), g("Y", hd), g("cs"), g("cy")


def _cuda_close(a, b, rtol):
    a, b = a.double().cpu(), b.double().cpu()
    assert float((a - b).abs().max()) <= rtol * max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["trial", "probe", "combine", "trial_pair_gram",
                                    "owlqn_probe", "owlqn_probe_pg",
                                    "pseudo_gradient_norm", "combine_ow",
                                    "owlqn_trial_pair_gram", "pair_gram_sd",
                                    "pair_gram_sd_gp", "combine_fix",
                                    "trial_pair_gram_gp", "owlqn_trial_pair_gram_gp"])
def test_kernel_matches_plain_on_card(cuda, data, kernel):
    xp, d, gp, S, Y, cs, cy = _cuda_inputs(data, cuda)
    xp0, pg = _t(data["xp0"]).to(cuda), _t(data["pg"]).to(cuda)
    wp = choose_orthant(Orthantwise(C, LO, HI), xp0, pg)
    with_gp = kernel.endswith("_gp")
    if kernel.startswith("pair_gram_sd"):
        S0, Y0, S2, Y2 = S.clone(), Y.clone(), S.clone(), Y.clone()
        k = t_fused.pair_gram_sd(STP, d, xp, gp, S, Y, END, with_gp=with_gp)
        p = t_fused.pair_gram_sd_ref(STP, d, xp, gp, S2, Y2, END, with_gp=with_gp)
        _assert_ring_write(S, Y, S0, Y0, STP * d, xp - gp)
        assert _same_bits(S, S2) and _same_bits(Y, Y2)
    elif kernel == "combine_fix":
        Y2 = Y.clone()
        gamma, ca, cb = (torch.tensor(v, device=cuda) for v in (-0.4, 0.7, -0.2))
        k = t_fused.combine_fix(gp, S, Y, gamma, cs, cy, END, ca, cb)
        p = t_fused.combine_fix_ref(gp, S, Y2, gamma, cs, cy, END, ca, cb)
        assert _same_bits(Y, Y2)
    elif kernel in ("trial_pair_gram_gp", "owlqn_trial_pair_gram_gp"):
        S2, Y2, S3, Y3 = S.clone(), Y.clone(), S.clone(), Y.clone()
        if kernel == "trial_pair_gram_gp":
            args = (xp, d, gp, STP)
            fn = t_rosen.trial_pair_gram
        else:
            args = (xp0, d, gp, pg, STP, C, LO, HI)
            fn = t_rosen.owlqn_trial_pair_gram
        k = fn(*args, S, Y, END, with_gp=True)
        p = getattr(t_rosen, kernel[:-3] + "_ref")(*args, S2, Y2, END, with_gp=True)
        base = fn(*args, S3, Y3, END)
        for a, b in zip(base, k):
            b = b[:, :3].contiguous() if b.ndim == 2 else b
            assert _same_bits(a.reshape(-1), b.reshape(-1))
    elif kernel in ("owlqn_probe", "owlqn_probe_pg"):
        w = wp if kernel == "owlqn_probe" else pg
        k = getattr(t_rosen, kernel)(xp0, d, w, STP, C, LO, HI)
        p = getattr(t_rosen, kernel + "_ref")(xp0, d, w, STP, C, LO, HI)
        if kernel == "owlqn_probe_pg":
            other = t_rosen.owlqn_probe(xp0, d, wp, STP, C, LO, HI)
            assert all(_same_bits(a.reshape(1), b.reshape(1)) for a, b in zip(k, other))
    elif kernel == "pseudo_gradient_norm":
        k = t_fused.pseudo_gradient_norm(xp0, gp, C, LO, HI)
        p = t_fused.pseudo_gradient_norm_ref(xp0, gp, C, LO, HI)
    elif kernel == "combine_ow":
        gamma = torch.tensor(-0.8, device=cuda)
        k = t_fused.combine_ow(pg, S, Y, gamma, cs, cy, LO, HI)
        p = t_fused.combine_ow_ref(pg, S, Y, gamma, cs, cy, LO, HI)
    elif kernel == "owlqn_trial_pair_gram":
        S0, Y0, S2, Y2 = S.clone(), Y.clone(), S.clone(), Y.clone()
        k = t_rosen.owlqn_trial_pair_gram(xp0, d, gp, pg, STP, C, LO, HI, S, Y, END)
        p = t_rosen.owlqn_trial_pair_gram_ref(xp0, d, gp, pg, STP, C, LO, HI, S2, Y2, END)
        _assert_ring_write(S, Y, S0, Y0, k[0] - xp0, k[1] - gp)
        _assert_ring_write(S2, Y2, S0, Y0, p[0] - xp0, p[1] - gp)
    elif kernel == "combine":
        gamma = torch.tensor(-0.8, device=cuda)
        k = t_fused.combine(gp, S, Y, gamma, cs, cy)
        p = t_fused.combine_ref(gp, S, Y, gamma, cs, cy)
    elif kernel == "trial_pair_gram":
        S0, Y0, S2, Y2 = S.clone(), Y.clone(), S.clone(), Y.clone()
        k = t_rosen.trial_pair_gram(xp, d, gp, STP, S, Y, END)
        p = t_rosen.trial_pair_gram_ref(xp, d, gp, STP, S2, Y2, END)
        _assert_ring_write(S, Y, S0, Y0, STP * d, k[2] - gp)
        _assert_ring_write(S2, Y2, S0, Y0, STP * d, p[2] - gp)
    else:
        k = getattr(t_rosen, kernel)(xp, d, STP)
        p = getattr(t_rosen, kernel + "_ref")(xp, d, STP)
    for a, b in zip(k, p):
        if a.dtype == torch.bool:
            assert bool(a) == bool(b)
        else:
            _cuda_close(a, b, 1e-4)


# ---------------------------------------------------------------------------
# The epilogues' launch (K4, K14): programs that loop over tiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.bfloat16),
                                    (torch.float32, torch.float32),
                                    (torch.float64, torch.float64)], ids=str)
@pytest.mark.parametrize("n", [100, 3_000_002, 1 << 24])
def test_epilogue_grid_covers_n_once(n, dtypes):
    """The tiles of T elements cover n; each program takes ``tiles`` of
    them, the last program's last tiles may lie past n (masked), and no
    program is left without one.  A small n takes one tile per program,
    fewer programs than the card has SMs."""
    eg = t_factory.epilogue_grid(n, *dtypes)
    cfg = t_factory.EPILOGUE[dtypes]
    assert (eg.T, eg.V, eg.num_warps) == (cfg["T"], cfg["V"], cfg["num_warps"])
    # whole runs of V per thread, rows of the body's W = 2 inside them
    assert eg.T % (32 * eg.num_warps * eg.V) == 0 and eg.V % 2 == 0
    assert eg.ntiles == -(-n // eg.T)
    assert (eg.ntiles - 1) * eg.T < n <= eg.ntiles * eg.T
    assert (eg.programs - 1) * eg.tiles < eg.ntiles <= eg.programs * eg.tiles
    assert eg.programs <= t_factory.EPILOGUE_PROGRAMS
    if n == 100:
        assert (eg.programs, eg.tiles) == (1, 1) and eg.programs < 132
    if n == 3_000_002 and dtypes[1] == torch.bfloat16:
        # several tiles per program, the last real tile partial
        assert eg.tiles > 1 and n % eg.T
    if n == 1 << 24 and dtypes[1] == torch.bfloat16:
        assert eg.programs * eg.tiles == eg.ntiles == n // eg.T


@pytest.mark.parametrize("with_gp", [False, True])
@pytest.mark.parametrize("owlqn", [False, True])
@pytest.mark.parametrize("n", [100, 3_000_002, 1 << 24])
def test_epilogue_partials_shapes(n, owlqn, with_gp):
    """K4: one objective partial per tile of every program, [programs, 4 +
    6m] sums, [programs, 2m] for the . gp column; K14: [programs, 3 + 6m]
    and [programs, 2 + 2m] (gp.gp, gp.pg first), no objective column."""
    eg = t_factory.epilogue_grid(n, torch.float32, torch.bfloat16)
    shapes = t_factory.epilogue_partials(eg, M, owlqn, with_gp)
    want = {"part": (eg.programs, (3 if owlqn else 4) + 6 * M)}
    if not owlqn:
        want["fx"] = (eg.programs * eg.tiles,)
    if with_gp:
        want["gpart"] = (eg.programs, (2 if owlqn else 0) + 2 * M)
    assert shapes == want


def test_ring_rows_round_up_to_a_power_of_two():
    assert [t_factory._rows(m) for m in (1, 2, 3, 5, 6, 8, 9, 64)] == [1, 2, 4, 8, 8, 8, 16, 64]


@pytest.fixture(scope="module")
def ragged():
    """Inputs at n = 3,000,002 (several tiles per epilogue program, the
    last tile partial), made with numpy."""
    n = 3_000_002
    rng = np.random.default_rng(11)
    x0 = np.where(np.arange(n) % 2 == 0, -1.2, 1.0)
    f32 = lambda a: a.astype(np.float32)
    return dict(
        n=n, xp=f32(x0 + 0.1 * rng.standard_normal(n)), d=f32(0.1 * rng.standard_normal(n)),
        gp=f32(rng.standard_normal(n)), S=f32(rng.standard_normal((M, n))),
        Y=f32(rng.standard_normal((M, n))),
        xp0=f32(np.where(np.arange(n) % 17 == 0, 0.0, x0 + 0.1 * rng.standard_normal(n))),
        pg=f32(rng.standard_normal(n)))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["trial_pair_gram", "owlqn_trial_pair_gram"])
def test_epilogue_spanning_tiles_on_card(cuda, ragged, kernel):
    """K4 and K14, both forms, at a ragged n with several tiles per
    program: the ring rows bit for bit, the . gp form's outputs bit for
    bit the 3-column form's, the sums against the plain version."""
    n = ragged["n"]
    g = lambda k, dt=torch.float32: _t(ragged[k], dt).to(cuda)
    S0, Y0 = g("S", torch.bfloat16), g("Y", torch.bfloat16)
    if kernel == "trial_pair_gram":
        args = (g("xp"), g("d"), g("gp"), STP)
    else:
        args = (g("xp0"), g("d"), g("gp"), g("pg"), STP, C, 3 * 1024 + 5, n - 7 * 1024 - 3)
    fn, ref = getattr(t_rosen, kernel), getattr(t_rosen, kernel + "_ref")
    runs = {}
    for with_gp in (False, True):
        S, Y, S2, Y2 = S0.clone(), Y0.clone(), S0.clone(), Y0.clone()
        k = fn(*args, S, Y, END, with_gp=with_gp)
        p = ref(*args, S2, Y2, END, with_gp=with_gp)
        if kernel == "trial_pair_gram":
            s, y = STP * args[1], k[2] - args[2]
        else:
            s, y = k[0] - args[0], k[1] - args[2]
        keep = [j for j in range(M) if j != END]
        assert _same_bits(S[END], s.to(S.dtype)) and _same_bits(Y[END], y.to(Y.dtype))
        assert _same_bits(S[keep], S0[keep]) and _same_bits(Y[keep], Y0[keep])
        for a, b in zip(k, p):
            if a.dtype == torch.bool:
                assert bool(a) == bool(b)
            else:
                _cuda_close(a, b, 1e-4)
        runs[with_gp] = (k, S, Y)
    (base, S3, Y3), (ext, S4, Y4) = runs[False], runs[True]
    assert _same_bits(S3, S4) and _same_bits(Y3, Y4)
    for a, b in zip(base, ext):
        b = b[:, :3].contiguous() if b.ndim == 2 else b
        assert _same_bits(a.reshape(-1), b.reshape(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [torch.bfloat16, torch.float32])
def test_fusions_direction_bit_for_bit_the_combines_on_card(cuda, data, hd):
    """The CUDA combines round as the Triton fusions do: K15's r is K3's,
    K15's fix form's r and ring row K6's, K16's rc K13's, bit for bit."""
    xp, d, gp, S, Y, cs, cy = _cuda_inputs(data, cuda, hd)
    xp0, pg = _t(data["xp0"]).to(cuda), _t(data["pg"]).to(cuda)
    gamma, ca, cb = (torch.tensor(v, device=cuda) for v in (-0.8, 0.7, -0.2))
    k15 = t_rosen.combine_probe(gp, xp, S, Y, gamma, cs, cy, 1.0)
    k3 = t_fused.combine(gp, S, Y, gamma, cs, cy)
    assert _same_bits(k15[0], k3[0])
    Y15, Y6 = Y.clone(), Y.clone()
    k15 = t_rosen.combine_probe(gp, xp, S, Y15, gamma, cs, cy, 1.0, fix=(END, ca, cb))
    k6 = t_fused.combine_fix(gp, S, Y6, gamma, cs, cy, END, ca, cb)
    assert _same_bits(k15[0], k6[0]) and _same_bits(Y15, Y6)
    k16 = t_rosen.combine_ow_probe(pg, xp0, S, Y, gamma, cs, cy, C, LO, HI, 1.0)
    k13 = t_fused.combine_ow(pg, S, Y, gamma, cs, cy, LO, HI)
    assert _same_bits(k16[0], k13[0])


# ---------------------------------------------------------------------------
# K5's launch: blocks that loop over tiles, sums in registers
# ---------------------------------------------------------------------------

DTYPE_PAIRS = [(torch.float32, torch.bfloat16), (torch.float32, torch.float32),
               (torch.float64, torch.float64)]


@pytest.mark.parametrize("dtypes", DTYPE_PAIRS, ids=str)
@pytest.mark.parametrize("n", [100, 3_000_002, 1 << 24])
def test_pair_gram_grid_covers_n_once(n, dtypes):
    """K5's tiles cover n once, each block's run of tiles holds at least one
    real tile, and no more than ``PAIR_GRAM_BLOCKS`` blocks launch; a
    thread's run is one 16-byte load of the vectors' dtype."""
    g = t_fused.pair_gram_grid(n, *dtypes)
    cfg = t_fused.PAIR_GRAM[dtypes]
    assert (g.T, g.V) == (cfg["T"], cfg["V"])
    assert g.T == 256 * g.V and g.V * dtypes[0].itemsize == 16
    assert (g.ntiles - 1) * g.T < n <= g.ntiles * g.T
    assert (g.blocks - 1) * g.tiles < g.ntiles <= g.blocks * g.tiles
    assert g.blocks <= t_fused.PAIR_GRAM_BLOCKS
    if n == 100:
        assert (g.blocks, g.tiles) == (1, 1)
    if n == 3_000_002:
        # several tiles per block, the last tile partial
        assert g.tiles > 1 and n % g.T
    if n == 1 << 24:
        assert g.tiles > 1 and n % g.T == 0


@pytest.mark.parametrize("with_gp", [False, True])
@pytest.mark.parametrize("m", [1, 3, 6, 12, 64])
def test_pair_gram_partials_shapes(m, with_gp):
    """[blocks, 6m] partials, and [blocks, 2m] for the . gp column."""
    g = t_fused.pair_gram_grid(3_000_002, torch.float32, torch.bfloat16)
    want = {"part": (g.blocks, 6 * m)}
    if with_gp:
        want["gpart"] = (g.blocks, 2 * m)
    assert t_fused.pair_gram_partials(g, m, with_gp) == want


@pytest.mark.parametrize("m", [64, 65])
def test_pair_gram_sd_takes_at_most_max_m_rows(m):
    """K5 takes 1 <= m <= 64 ring rows (``fused.can_pair_gram``), on the CPU
    as on the card."""
    rng = np.random.default_rng(5)
    d, gx, gp = (torch.from_numpy(rng.standard_normal(300)) for _ in range(3))
    S = torch.from_numpy(rng.standard_normal((m, 300)))
    Y = S.clone()
    if m <= t_fused.MAX_M:
        SP, YP = t_fused.pair_gram_sd(STP, d, gx, gp, S, Y, m - 1)
        assert SP.shape == YP.shape == (m, 3)
    else:
        with pytest.raises(ValueError, match="exceeds 64"):
            t_fused.pair_gram_sd(STP, d, gx, gp, S, Y, m - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", DTYPE_PAIRS, ids=str)
@pytest.mark.parametrize("m,end", [(1, 0), (3, 2), (6, 2), (8, 7), (12, 9)])
def test_k5_spanning_tiles_on_card(cuda, dtypes, m, end):
    """K5 at a ragged n with many tiles per block, in both forms: ring rows
    bit for bit the rounded pair, the . gp form's columns 0-2 and rings bit
    for bit the 3-column form's, the sums against the plain version (1e-4
    f32, 1e-10 f64).  m = 12 takes two groups of ring rows, the new row in
    the second."""
    vd, hd = dtypes
    n = 3_000_002
    assert t_fused.pair_gram_grid(n, vd, hd).tiles > 1
    rng = np.random.default_rng(13)
    g = lambda *s, dt=vd: torch.from_numpy(rng.standard_normal(s)).to(dt).to(cuda)
    d, gx, gp = 0.1 * g(n), g(n), g(n)
    S0, Y0 = g(m, n, dt=hd), g(m, n, dt=hd)
    tol = 1e-4 if vd == torch.float32 else 1e-10
    keep = [j for j in range(m) if j != end]
    runs = {}
    for with_gp in (False, True):
        S, Y, S2, Y2 = S0.clone(), Y0.clone(), S0.clone(), Y0.clone()
        k = t_fused.pair_gram_sd(STP, d, gx, gp, S, Y, end, with_gp=with_gp)
        p = t_fused.pair_gram_sd_ref(STP, d, gx, gp, S2, Y2, end, with_gp=with_gp)
        assert _same_bits(S[end], (STP * d).to(hd)) and _same_bits(Y[end], (gx - gp).to(hd))
        assert _same_bits(S[keep], S0[keep]) and _same_bits(Y[keep], Y0[keep])
        for a, b in zip(k, p):
            _cuda_close(a, b, tol)
        runs[with_gp] = (k, S, Y)
    (base, S3, Y3), (ext, S4, Y4) = runs[False], runs[True]
    assert _same_bits(S3, S4) and _same_bits(Y3, Y4)
    for a, b in zip(base, ext):
        assert _same_bits(a, b[:, :3].contiguous())
