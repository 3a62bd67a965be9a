"""The fused-kernel factory's extra operand streams and the separable
models (``separable.quadratic``, ``sphere``, ``scaled_quartic``) and
``booth`` of the PyTorch port against the JAX package.

On the CPU each factory wrapper runs its plain version, which evaluates
through the objective's ``value_and_grad`` (the extras bound in it); here
those meet the JAX package's Pallas kernels of the same objective run
through the interpreter (``tests/test_factory_objective.py:66-276``), on
seeded numpy inputs at n = 2^14 (the JAX package's ``MIN_FUSED_N``), float32
vectors.  Tolerances, as the JAX tests state them: rel 2e-5 on the trial's
vectors and scalars, rel 2e-4 with atol 2e-3 (1e-2 for the fusions'
scalars) on the products and sums (another summation order); the
solver's outcomes within the JAX test's kernel-against-jnp bounds
(iterations within 2, fx rel 1e-2 or abs 1e-4), and the minimizers
against their oracles (x = t at rtol and atol 1e-3; the soft threshold
at rtol 1e-2, atol 2e-3).  The counterparts of the JAX package's mesh
tests (``:279-347``), the quadratic's extras and a body that reads the
global index on a mesh, are in ``tests/test_torch_kernels_mesh.py``.

The cases marked ``cuda`` hold every factory kernel with 0, 1, 2 and 3
extras to its plain version on the card and skip without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from lbfgs_torch import lbfgs as t_lbfgs
from lbfgs_torch.minimize import minimize_jit as t_minimize_jit
from lbfgs_torch.models import booth as t_booth
from lbfgs_torch.models import separable as t_sep
from lbfgs_torch.ops import factory as t_factory
from lbfgs_torch.orthantwise import Orthantwise as TOw
from lbfgs_torch.orthantwise import choose_orthant
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_tpu import lbfgs as j_lbfgs
from lbfgs_tpu.minimize import minimize_jit as j_minimize_jit
from lbfgs_tpu.models import booth as j_booth
from lbfgs_tpu.models import separable as j_sep
from lbfgs_tpu.ops import fused as j_fused
from lbfgs_tpu.orthantwise import Orthantwise as JOw
from lbfgs_tpu.params import LbfgsParams as JParams

M, N = 6, j_fused.MIN_FUSED_N
VEC = dict(rtol=2e-5, atol=2e-5)
PROD = dict(rtol=2e-4, atol=2e-3)
FUSION = dict(rtol=2e-4, atol=1e-2)


def _rand(shape, seed, scale=1.0):
    """The JAX tests' inputs: float32 normals from numpy's seed."""
    return (np.random.RandomState(seed).randn(*np.atleast_1d(shape)) * scale).astype(
        np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _ring(H):
    m, n = H.shape
    return jnp.asarray(H).reshape(m, n // 128, 128)


def _quad(seed=0, n=N):
    """(port objective, JAX objective, w, t) of the weighted quadratic."""
    w = 0.5 + np.abs(_rand(n, seed + 1))
    t = _rand(n, seed + 2)
    return t_sep.quadratic(_t(w), _t(t)), j_sep.quadratic(jnp.asarray(w), jnp.asarray(t)), w, t


def _close(t, j, tol):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    np.testing.assert_allclose(t, np.asarray(j, np.float64).reshape(t.shape), **tol)


# ---------------------------------------------------------------------------
# The objectives and the factory's contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [256, 300])
def test_sphere_synthesized_vag(n):
    """No value_and_grad given: the factory builds the plain evaluation from
    the body's torch twin, as the JAX factory builds its own from the
    block (n = 300 is not a multiple of the JAX package's 128 lanes)."""
    x = _rand(n, 3)
    fx, g = t_sep.sphere()(_t(x))
    jfx, jg = j_sep.sphere()(jnp.asarray(x))
    assert float(fx) == pytest.approx(float(jfx), rel=1e-6)
    assert float(fx) == pytest.approx(float(0.5 * np.sum(x.astype(np.float64) ** 2)), rel=1e-6)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


@pytest.mark.parametrize("which", ["quadratic", "scaled_quartic"])
def test_separable_vag_matches_jax_and_twin(which):
    """The plain evaluation equals the JAX package's, and the body's torch
    twin gives the same terms and gradient."""
    x, w, t = _rand(N, 5), 0.5 + np.abs(_rand(N, 6)), _rand(N, 7)
    if which == "quadratic":
        obj, jobj = t_sep.quadratic(_t(w), _t(t)), j_sep.quadratic(jnp.asarray(w),
                                                                   jnp.asarray(t))
        fe, g2 = t_sep._quadratic_ref(_t(x), None, _t(w), _t(t))
    else:
        obj, jobj = t_sep.scaled_quartic(_t(w)), j_sep.scaled_quartic(jnp.asarray(w))
        fe, g2 = t_sep._quartic_ref(_t(x), None, _t(w))
    fx, g = obj(_t(x))
    jfx, jg = jobj(jnp.asarray(x))
    assert float(fx) == pytest.approx(float(jfx), rel=1e-6)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert torch.equal(g2, g) and float(fe.sum()) == pytest.approx(float(fx), rel=1e-6)


@pytest.mark.parametrize("nex", [0, 1, 2, 3])
def test_factory_binds_any_number_of_extras(nex):
    """An objective built from a torch twin alone, with nex extras: the
    synthesized evaluation passes each extra's view to the twin, row by
    row, and the fused protocol's plain versions see them."""
    n, row = 64, 2
    ex = tuple(_t(_rand(n, 20 + i)) for i in range(nex))
    seen = []

    def twin(x, gidx, *eb):
        seen.append((x.shape, gidx.shape, tuple(e.shape for e in eb)))
        s = sum(eb) if eb else torch.zeros_like(x)
        return 0.5 * (x * x) + s * x, x + s

    obj = t_factory.make_fused_objective(lambda: None, extras=ex, row=row, block_ref=twin)
    x = _t(_rand(n, 9))
    fx, g = obj(x)
    s = sum(ex) if ex else torch.zeros_like(x)
    assert torch.equal(g, x + s)
    assert float(fx) == pytest.approx(float((0.5 * x * x + s * x).double().sum()), rel=1e-6)
    assert seen[-1] == ((n // row, row), (n // row, row), ((n // row, row),) * nex)
    assert obj.kernels.extras == ex
    out = obj.kernels.trial(x, x, 0.5)
    assert torch.equal(out[2], obj(1.5 * x)[1])


def test_factory_checks_extras():
    """An extra of another length, dtype or device, or not contiguous,
    raises in the wrappers, and the fusion's predicate refuses it."""
    n = 64
    x = _t(_rand(n, 1))
    S = torch.zeros((M, n))
    for bad in (torch.ones(n + 1), torch.ones(n, dtype=torch.float64),
                torch.ones(2 * n)[::2]):
        obj = t_factory.make_fused_objective(
            lambda: None, extras=(bad,), block_ref=lambda x, i, e: (x * x, x))
        with pytest.raises(ValueError, match="extra 0"):
            obj.kernels.trial(x, x, 0.5)
        assert not obj.__lbfgs_combine_probe_ok__(x, S)
    with pytest.raises(ValueError, match="value_and_grad or block_ref"):
        t_factory.make_fused_objective(lambda: None)


def test_fusion_takes_even_n_for_an_elementwise_body():
    """The kernels lay an elementwise body's blocks out in rows of two, and
    K15 and K16 keep their probes K2's and K8's bit for bit only where n
    is a multiple of that width: for an odd n the fusion's predicate
    refuses, and the solver runs the unfused path (the JAX package's
    kernels take no n off its 128 lanes)."""
    obj = t_sep.sphere()
    for n, ok in ((64, True), (63, False)):
        x = torch.zeros(n)
        assert obj.__lbfgs_combine_probe_ok__(x, torch.zeros((M, n))) is ok
        assert obj.__lbfgs_trial_pair_gram_ok__(x, torch.zeros((M, n)))
    rep = t_lbfgs().with_constrain_step_size(False).minimize(torch.ones(63), obj)
    assert rep.fx < 1e-10 and obj.kernels.combine_probe_ref.calls == 0


def test_booth_matches_jax():
    """Booth to (1, 3) from (-1.2, 1.0) (``tests/simple.rs:57-83``), with
    the JAX package's iterations, through both entry points."""
    x0 = np.array([-1.2, 1.0])
    j = j_lbfgs().minimize(jnp.asarray(x0), j_booth.value_and_grad)
    for entry in ("minimize", "minimize_jit"):
        t = getattr(t_lbfgs(), entry)(torch.from_numpy(x0), t_booth.value_and_grad)
        assert t.niter == j.niter
        assert abs(float(t.x[0]) - 1.0) <= 1e-6 and abs(float(t.x[1]) - 3.0) <= 1e-6
        assert t.fx == pytest.approx(float(j.fx), rel=1e-6, abs=1e-20)


# ---------------------------------------------------------------------------
# The quadratic's kernels' plain versions against the JAX package's kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [N, 128 * 9])
def test_quadratic_trial_probe_kernels(n):
    obj, jobj, w, t = _quad(n=n)
    xp, d = _rand(n, 10), _rand(n, 11)
    out = obj.kernels.trial(_t(xp), _t(d), 0.37)
    ref = jobj.kernels.trial_pallas(jnp.asarray(xp), jnp.asarray(d), 0.37, interpret=True)
    for i in range(6):
        _close(out[i], ref[i], VEC)
    assert bool(out[6]) == bool(ref[6])
    # the probe's scalars are the trial's (the plain versions share the
    # evaluation), as the JAX kernels' are bit for bit
    ft, dg = obj.kernels.probe(_t(xp), _t(d), 0.37)
    assert float(ft) == float(out[1]) and float(dg) == float(out[3])


def test_quadratic_owlqn_trial_probe_kernels():
    obj, jobj, w, t = _quad(seed=20)
    k, jk = obj.kernels, jobj.kernels
    xp, d, pg = _rand(N, 21), _rand(N, 22), _rand(N, 23)
    c, lo, hi = 0.25, 130, N - 7
    wp = choose_orthant(TOw(c, lo, hi), _t(xp), _t(pg))
    out = k.owlqn_trial(_t(xp), _t(d), wp, 0.5, c, lo, hi)
    ref = jk.owlqn_trial_pallas(jnp.asarray(xp), jnp.asarray(d), jnp.asarray(wp.numpy()),
                                0.5, c, lo, hi, interpret=True)
    for i in range(5):
        _close(out[i], ref[i], VEC)
    assert bool(out[5]) == bool(ref[5])
    ftp, dgp = k.owlqn_probe(_t(xp), _t(d), wp, 0.5, c, lo, hi)
    assert float(ftp) == float(out[1])
    ftg, dgg = k.owlqn_probe_pg(_t(xp), _t(d), _t(pg), 0.5, c, lo, hi)
    assert (float(ftg), float(dgg)) == (float(ftp), float(dgp))
    jg = jk.owlqn_probe_pg_pallas(jnp.asarray(xp), jnp.asarray(d), jnp.asarray(pg), 0.5, c,
                                  lo, hi, interpret=True)
    _close(ftg, jg[0], VEC)
    _close(dgg, jg[1], PROD)


def test_quadratic_epilogue_kernels():
    obj, jobj, w, t = _quad(seed=30)
    k, jk = obj.kernels, jobj.kernels
    xp, d, gp, pg = _rand(N, 31), _rand(N, 32), _rand(N, 33), _rand(N, 34)
    S, Y = _rand((M, N), 35, 0.1), _rand((M, N), 36, 0.1)
    end = 2
    for with_gp in (False, True):
        St, Yt = _t(S), _t(Y)
        out = k.trial_pair_gram(_t(xp), _t(d), _t(gp), 0.37, St, Yt, end, with_gp=with_gp)
        ref = jk.trial_pair_gram_pallas(jnp.asarray(xp), jnp.asarray(d), jnp.asarray(gp),
                                        0.37, _ring(S), _ring(Y), end, interpret=True,
                                        with_gp=with_gp)
        for i in (0, 1, 2):
            _close(out[i], ref[i], VEC)
        for i in (3, 4, 5):
            _close(out[i], ref[i], PROD)
        assert bool(out[6]) == bool(ref[6])
        _close(St, np.asarray(ref[7]).reshape(M, N), VEC)
        _close(Yt, np.asarray(ref[8]).reshape(M, N), VEC)
        _close(out[7], ref[9], PROD)
        _close(out[8], ref[10], PROD)
        assert out[7].shape == (M, 4 if with_gp else 3)
    c, lo, hi = 0.25, 0, N
    for with_gp in (False, True):
        St, Yt = _t(S), _t(Y)
        out = k.owlqn_trial_pair_gram(_t(xp), _t(d), _t(gp), _t(pg), 0.5, c, lo, hi, St, Yt,
                                      end, with_gp=with_gp)
        ref = jk.owlqn_trial_pair_gram_pallas(
            jnp.asarray(xp), jnp.asarray(d), jnp.asarray(gp), jnp.asarray(pg), 0.5, c, lo,
            hi, _ring(S), _ring(Y), end, interpret=True, with_gp=with_gp)
        # (x, g, pg, SP, YP, xx, pgpg, changed[, gpgp, gppg]) against the
        # JAX package's (x, g, pg, S, Y, SP, YP, xx, pgpg, changed[, ...])
        for i in (0, 1, 2):
            _close(out[i], ref[i], VEC)
        _close(St, np.asarray(ref[3]).reshape(M, N), VEC)
        _close(Yt, np.asarray(ref[4]).reshape(M, N), VEC)
        for a, b in zip(out[3:], ref[5:]):
            if a.dtype == torch.bool:
                assert bool(a) == bool(b)
            else:
                _close(a, b, PROD)


def test_quadratic_combine_probe_kernels():
    obj, jobj, w, t = _quad(seed=40)
    k, jk = obj.kernels, jobj.kernels
    g, x, pg = _rand(N, 41), _rand(N, 42), _rand(N, 43)
    S, Y = _rand((M, N), 44, 0.1), _rand((M, N), 45, 0.1)
    cs, cy = _rand(M, 46, 0.1), _rand(M, 47, 0.1)
    gamma = torch.tensor(-0.4)
    for stp1 in (1.0, 0.37):
        out = k.combine_probe(_t(g), _t(x), _t(S), _t(Y), gamma, _t(cs), _t(cy), stp1)
        ref = jk.combine_probe_pallas(jnp.asarray(g), jnp.asarray(x), _ring(S), _ring(Y),
                                      -0.4, jnp.asarray(cs), jnp.asarray(cy), stp1,
                                      interpret=True)
        for a, b in zip(out, ref):
            _close(a, b, FUSION)
        # the probe's scalars are the probe kernel's at (x, r, stp1)
        ft, dg = k.probe(_t(x), out[0], stp1)
        assert (float(ft), float(dg)) == (float(out[3]), float(out[4]))
        out = k.combine_ow_probe(_t(pg), _t(x), _t(S), _t(Y), gamma, _t(cs), _t(cy), 0.25,
                                 130, N - 7, stp1)
        ref = jk.combine_ow_probe_pallas(jnp.asarray(pg), jnp.asarray(x), _ring(S), _ring(Y),
                                         -0.4, jnp.asarray(cs), jnp.asarray(cy), 0.25, 130,
                                         N - 7, stp1, interpret=True)
        for a, b in zip(out, ref):
            _close(a, b, FUSION)
        ft, dg = k.owlqn_probe_pg(_t(x), out[0], _t(pg), stp1, 0.25, 130, N - 7)
        assert (float(ft), float(dg)) == (float(out[4]), float(out[5]))


# ---------------------------------------------------------------------------
# Whole runs
# ---------------------------------------------------------------------------


def _calls(obj):
    k = obj.kernels
    return {name: getattr(k, name + "_ref").calls
            for name in ("trial", "probe", "trial_pair_gram", "owlqn_trial", "owlqn_probe_pg",
                         "owlqn_trial_pair_gram", "combine_probe", "combine_ow_probe")}


def test_quadratic_solver_engages_epilogue():
    """A factory objective with extras drives the one-pass epilogue and the
    combine+probe fusion (their plain versions' counters), reaches x = t,
    and ends as the JAX package's kernel run does."""
    obj, jobj, w, t = _quad(seed=50)
    params = dict(epsilon=1e-5, max_iterations=60, constrain_step_size=False)
    x0 = np.zeros(N, np.float32)
    rep = t_minimize_jit(TParams(**params), _t(x0), obj)
    calls = _calls(obj)
    iters = rep.niter - 1
    assert calls["trial_pair_gram"] == iters and calls["combine_probe"] == iters
    np.testing.assert_allclose(rep.x.numpy(), t, rtol=1e-3, atol=1e-3)
    jrep = j_minimize_jit(JParams(**params), jnp.asarray(x0), jobj)
    assert rep.niter == pytest.approx(jrep.niter, abs=2)
    assert rep.fx == pytest.approx(float(jrep.fx), rel=1e-2, abs=1e-4)


def test_quartic_nontrivial_convergence():
    """A separable member that is not quadratic: the history has curvature
    to learn; the port reaches the minimizer 0 as the JAX package does."""
    w = 0.5 + np.abs(_rand(N, 60))
    x0 = _rand(N, 61)
    params = dict(epsilon=1e-5, max_iterations=80, constrain_step_size=False)
    obj = t_sep.scaled_quartic(_t(w))
    rep = t_minimize_jit(TParams(**params), _t(x0), obj)
    assert rep.fx < 1e-8
    assert float(rep.x.abs().max()) < 1e-3
    jrep = j_minimize_jit(JParams(**params), jnp.asarray(x0), j_sep.scaled_quartic(jnp.asarray(w)))
    assert rep.niter == pytest.approx(jrep.niter, abs=2)
    assert _calls(obj)["trial_pair_gram"] == rep.niter - 1


def test_damped_quartic_matches_jax():
    """The damped path on the quartic (K4's . gp column and K15's damped-row
    form, their plain versions here) reaches the minimizer within the
    budget, as the JAX package's run does."""
    w = 0.5 + np.abs(_rand(N, 62))
    x0 = _rand(N, 63)
    params = dict(epsilon=1e-5, max_iterations=120, constrain_step_size=False, damping=True)
    obj = t_sep.scaled_quartic(_t(w))
    rep = t_minimize_jit(TParams(**params), _t(x0), obj)
    assert rep.fx < 1e-8 and float(rep.x.abs().max()) < 1e-3
    assert obj.kernels.combine_probe_ref.calls == rep.niter - 1
    jrep = j_minimize_jit(JParams(**params), jnp.asarray(x0), j_sep.scaled_quartic(jnp.asarray(w)))
    assert rep.niter == pytest.approx(jrep.niter, abs=2)


def test_owlqn_quadratic_soft_threshold():
    """OWL-QN on the diagonal quadratic has the analytic solution x* =
    sign(t) * max(|t| - c/w, 0): the port's OWL-QN path (the one-pass
    OWL-QN epilogue and K16, their plain versions here) lands on it, and
    ends as the JAX package's run does."""
    obj, jobj, w, t = _quad(seed=70)
    c = 0.3
    params = dict(epsilon=1e-4, max_iterations=200, constrain_step_size=False)
    x0 = np.zeros(N, np.float32)
    rep = t_minimize_jit(TParams(**params, orthantwise=TOw(c, 0, None)), _t(x0), obj)
    calls = _calls(obj)
    assert calls["owlqn_trial_pair_gram"] == rep.niter - 1
    assert calls["combine_ow_probe"] == rep.niter - 1
    x_star = np.sign(t) * np.maximum(np.abs(t) - c / w, 0.0)
    np.testing.assert_allclose(rep.x.numpy(), x_star, rtol=1e-2, atol=2e-3)
    jrep = j_minimize_jit(JParams(**params, orthantwise=JOw(c=c, start=0, end=None)),
                          jnp.asarray(x0), jobj)
    assert rep.niter == pytest.approx(jrep.niter, abs=2)
    assert rep.fx == pytest.approx(float(jrep.fx), rel=1e-4)


# ---------------------------------------------------------------------------
# On the card: every factory kernel with 0-3 extras against its plain
# version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _objective(nex: int, n: int, dev, dt=torch.float32):
    """A factory objective with nex extras of dtype dt on dev: the sphere
    (0), the quartic (1), the quadratic (2), and a three-extra body defined
    here."""
    g = torch.Generator().manual_seed(nex)
    w = (0.5 + torch.rand(n, generator=g)).to(dev, dt)
    t = torch.randn(n, generator=g).to(dev, dt)
    if nex == 0:
        return t_sep.sphere()
    if nex == 1:
        return t_sep.scaled_quartic(w)
    if nex == 2:
        return t_sep.quadratic(w, t)
    c = (0.1 * torch.randn(n, generator=g)).to(dev, dt)

    def body():
        import triton

        @triton.jit
        def three(x, gidx, a, b, cc):
            r = x - b
            return 0.5 * (a * (r * r)) + cc * x, a * r + cc

        return three

    def twin(x, gidx, a, b, cc):
        r = x - b
        return 0.5 * (a * (r * r)) + cc * x, a * r + cc

    return t_factory.make_fused_objective(body, extras=(w, t, c), block_ref=twin)


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8), b.reshape(-1).contiguous().view(torch.uint8))


def _near(a, b, rtol):
    if a.dtype == torch.bool:
        assert bool(a) == bool(b)
        return
    a, b = a.double().cpu(), b.double().cpu()
    assert float((a - b).abs().max()) <= rtol * max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("nex,dtypes", [
    (0, (torch.float32, torch.bfloat16)), (1, (torch.float32, torch.bfloat16)),
    (2, (torch.float32, torch.bfloat16)), (3, (torch.float32, torch.bfloat16)),
    (2, (torch.float64, torch.float64)), (3, (torch.float64, torch.float64))], ids=str)
def test_extras_kernels_match_plain_on_card(cuda, nex, dtypes):
    """K1, K2, K4 (and . gp), K7, K8 (both forms), K14 (and . gp), K15 (and
    its damped-row form) and K16 with nex extras against their plain
    versions at a ragged n (rings bit for bit, sums normwise 1e-4 in
    float32, 1e-10 in float64), and the remat contract bit for bit: K7's
    ft and g.d against K8's, K15's probe against K2's, K16's against K8's
    pg form, the . gp forms' columns 0-2 against the 3-column launch; no
    compiled epilogue form spills."""
    vd, hd = dtypes
    tol = 1e-4 if vd == torch.float32 else 1e-10
    _near_t = lambda a, b: _near(a, b, tol)
    n, end, stp = 3 * 4096 + 6, 2, 0.37
    obj = _objective(nex, n, cuda, vd)
    k = obj.kernels
    g = torch.Generator(device="cuda").manual_seed(11)
    r = lambda *s, dt=vd: torch.randn(*s, generator=g, device="cuda",
                                      dtype=torch.float64).to(dt)
    xp, d, gp, pg = r(n), 0.1 * r(n), r(n), r(n)
    xp0 = torch.where(torch.arange(n, device="cuda") % 17 == 0, torch.zeros_like(xp), xp)
    S0, Y0 = r(M, n, dt=hd), r(M, n, dt=hd)
    gamma, cs, cy = torch.tensor(0.8, dtype=vd, device="cuda"), r(M), r(M)
    ca, cb = (torch.tensor(v, dtype=vd, device="cuda") for v in (0.7, -0.2))
    c, lo, hi = 0.7, 3 * 1024 + 5, n - 7
    wp = choose_orthant(TOw(c, lo, hi), xp0, pg)
    for a, b in zip(k.trial(xp, d, stp), k.trial_ref(xp, d, stp)):
        _near_t(a, b)
    for a, b in zip(k.probe(xp, d, stp), k.probe_ref(xp, d, stp)):
        _near_t(a, b)
    k7, k8 = k.owlqn_trial(xp0, d, wp, stp, c, lo, hi), k.owlqn_probe(xp0, d, wp, stp, c, lo, hi)
    for a, b in zip(k7, k.owlqn_trial_ref(xp0, d, wp, stp, c, lo, hi)):
        _near_t(a, b)
    assert _same(k7[1], k8[0]) and _same(k7[3], k8[1])
    k8pg = k.owlqn_probe_pg(xp0, d, pg, stp, c, lo, hi)
    assert _same(k8pg[0], k8[0]) and _same(k8pg[1], k8[1])
    for a, b in zip(k8pg, k.owlqn_probe_pg_ref(xp0, d, pg, stp, c, lo, hi)):
        _near_t(a, b)
    for fn, ref, args in (
            (k.trial_pair_gram, k.trial_pair_gram_ref, (xp, d, gp, stp)),
            (k.owlqn_trial_pair_gram, k.owlqn_trial_pair_gram_ref,
             (xp0, d, gp, pg, stp, c, lo, hi))):
        base = None
        for with_gp in (False, True):
            Sk, Yk, Sp, Yp = S0.clone(), Y0.clone(), S0.clone(), Y0.clone()
            out = fn(*args, Sk, Yk, end, with_gp=with_gp)
            for a, b in zip(out, ref(*args, Sp, Yp, end, with_gp=with_gp)):
                _near_t(a, b)
            if base is None:
                base, ring = out, (Sk, Yk)
                continue
            assert _same(Sk, ring[0]) and _same(Yk, ring[1])
            for a, b in zip(base, out):
                assert _same(a, b[:, :3].contiguous() if b.ndim == 2 else b)
    for stp1 in (1.0, 0.37):
        out = k.combine_probe(gp, xp, S0, Y0, gamma, cs, cy, stp1)
        for a, b in zip(out, k.combine_probe_ref(gp, xp, S0, Y0, gamma, cs, cy, stp1)):
            _near_t(a, b)
        k2 = k.probe(xp, out[0], stp1)
        assert _same(out[3], k2[0]) and _same(out[4], k2[1])
        Yk, Yp = Y0.clone(), Y0.clone()
        out = k.combine_probe(gp, xp, S0, Yk, gamma, cs, cy, stp1, fix=(end, ca, cb))
        ref = k.combine_probe_ref(gp, xp, S0, Yp, gamma, cs, cy, stp1, fix=(end, ca, cb))
        assert _same(Yk, Yp)
        for a, b in zip(out, ref):
            _near_t(a, b)
        out = k.combine_ow_probe(pg, xp0, S0, Y0, gamma, cs, cy, c, lo, hi, stp1)
        for a, b in zip(out, k.combine_ow_probe_ref(pg, xp0, S0, Y0, gamma, cs, cy, c, lo, hi,
                                                    stp1)):
            _near_t(a, b)
        k8 = k.owlqn_probe_pg(xp0, out[0], pg, stp1, c, lo, hi)
        assert _same(out[4], k8[0]) and _same(out[5], k8[1])
    for fn in (k.trial_pair_gram, k.owlqn_trial_pair_gram):
        for kern in fn.compiled.values():
            kern._init_handles()
            assert kern.n_spills == 0


@pytest.mark.cuda
def test_quadratic_run_on_card(cuda):
    """The quadratic through the kernels on the card ends at x = t, with
    the plain versions' run's iterations and evaluations after 8."""
    n = 1 << 20
    g = torch.Generator(device="cuda").manual_seed(3)
    w = 0.5 + torch.rand(n, generator=g, device="cuda")
    t = torch.randn(n, generator=g, device="cuda")
    obj = t_sep.quadratic(w, t)
    params = TParams(epsilon=1e-5, max_iterations=100, constrain_step_size=False,
                     history_dtype="bfloat16")
    x0 = torch.zeros(n, device="cuda")
    st = t_minimize_jit(params, x0, obj, return_state=True)
    assert int(st.status) == 1
    torch.testing.assert_close(st.prob.x, t, rtol=1e-3, atol=1e-3)
    p8 = params.replace(epsilon=0.0, max_iterations=9)
    a = t_minimize_jit(p8, x0, obj, return_state=True)
    b = t_minimize_jit(p8, x0, obj.plain, return_state=True)
    assert (a.k, a.prob.neval) == (b.k, b.prob.neval)
    assert float(a.prob.fx) == pytest.approx(float(b.prob.fx), rel=1e-3)
