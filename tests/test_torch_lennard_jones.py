"""The Lennard-Jones cluster in the PyTorch port against ``lbfgs_tpu`` on
the CPU: the chemistry workload of the reference's gradient-only and
damped modes (``examples/lj.rs``), as tests/test_lennard_jones.py pins the
JAX package.  The LJ objective is generic, so a damped run takes the
solver's composed branch (``update_pair``) and the direction combine."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lbfgs_torch
import lbfgs_tpu
from lbfgs_torch.models import lennard_jones as t_lj
from lbfgs_torch.ops import fused as t_fused
from lbfgs_tpu.models import lennard_jones as j_lj

E0, E_RELAXED = -116.84147098, -164.2701507


def test_lj_gradient_matches_autograd():
    """The hand-derived gradient equals torch.autograd's of the energy."""
    lj = t_lj.LennardJones()
    x = t_lj.lj38_positions().requires_grad_(True)
    e, g = lj.value_and_grad(x)
    (g_auto,) = torch.autograd.grad(e, x)
    np.testing.assert_allclose(g.detach().numpy(), g_auto.numpy(), rtol=1e-9)


@pytest.mark.parametrize("start", ["lj38", "grid"])
def test_lj_value_and_grad_match_jax(start):
    t_x = {"lj38": t_lj.lj38_positions, "grid": t_lj.lj38_grid_start}[start]()
    j_x = {"lj38": j_lj.lj38_positions, "grid": j_lj.lj38_grid_start}[start]()
    np.testing.assert_array_equal(t_x.numpy(), np.asarray(j_x))
    et, gt = t_lj.LennardJones(1.3, 0.9).value_and_grad(t_x)
    ej, gj = j_lj.LennardJones(1.3, 0.9).value_and_grad(j_x)
    assert float(et) == pytest.approx(float(ej), rel=1e-13)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-11,
                               atol=1e-11 * np.abs(np.asarray(gj)).max())


def test_lj_dimer_minimum():
    """Two atoms relax to the pair minimum r = 2^(1/6) sigma, E = -epsilon."""
    x0 = torch.tensor([0.0, 0.0, 0.0, 1.5, 0.0, 0.0], dtype=torch.float64)
    rep = lbfgs_torch.lbfgs().minimize(x0, t_lj.make_objective())
    p = rep.x.numpy().reshape(2, 3)
    assert np.linalg.norm(p[0] - p[1]) == pytest.approx(2 ** (1 / 6), abs=1e-5)
    assert rep.fx == pytest.approx(-1.0, abs=1e-8)


def test_lj38_relaxation_default():
    """Default L-BFGS relaxes the reference start into the basin at
    E = -164.27015 (tests/test_lennard_jones.py:38-50)."""
    obj = t_lj.make_objective()
    x0 = t_lj.lj38_positions()
    assert float(obj(x0)[0]) == pytest.approx(E0, abs=1e-6)
    rep = lbfgs_torch.lbfgs().with_max_iterations(400).minimize(x0, obj)
    assert rep.fx == pytest.approx(E_RELAXED, abs=1e-4)


def test_lj38_grid_start_relaxation():
    obj = t_lj.make_objective()
    x0 = t_lj.lj38_grid_start()
    rep = lbfgs_torch.lbfgs().with_max_iterations(400).minimize(x0, obj)
    assert rep.fx < float(obj(x0)[0]) and rep.fx < -140.0


def _trace(builder, x0, fn):
    out = []

    def cb(p):
        out.append((p.niter, float(p.fx), float(p.gnorm), float(p.step), p.neval))
        return False

    rep = builder.minimize(x0, fn, cb)
    return out, rep


@pytest.fixture(scope="module")
def gradient_only_jax():
    b = lbfgs_tpu.lbfgs().with_gradient_only().with_max_iterations(50)
    return _trace(b, j_lj.lj38_positions(), j_lj.make_objective())[0]


def test_lj38_gradient_only_matches_jax(gradient_only_jax):
    """Gradient-only + damped (the chemistry configuration,
    src/lbfgs.rs:283-289) through the composed damped branch: the JAX
    package's 50-step prefix per iteration at the bounds it pins itself
    to the native core with (tests/test_lennard_jones.py:100-104), and the
    prefix descends below -150 (:106)."""
    before = t_fused.combine_ref.calls
    tt, rep = _trace(lbfgs_torch.lbfgs().with_gradient_only().with_max_iterations(50),
                     t_lj.lj38_positions(), t_lj.make_objective())
    assert len(tt) == len(gradient_only_jax) == 50
    for (kt, ft, gt, st, et), (kj, fj, gj, sj, ej) in zip(tt, gradient_only_jax):
        assert kt == kj and et == ej
        assert ft == pytest.approx(fj, rel=1e-8)
        assert gt == pytest.approx(gj, rel=1e-6)
        assert st == pytest.approx(sj, rel=1e-6)
    assert tt[-1][1] < -150.0
    # one combine per iteration after the first, the composed branch's
    # damping case counted on every one
    assert t_fused.combine_ref.calls - before == 49
    assert sum(rep.damping_cases) == 49


def test_lj38_gradient_only_minimize_jit_is_the_same_run():
    b = lbfgs_torch.lbfgs().with_gradient_only().with_max_iterations(30)
    x0 = t_lj.lj38_positions()
    a = b.minimize(x0, t_lj.make_objective())
    c = b.minimize_jit(x0, t_lj.make_objective())
    assert (a.niter, a.fx, a.gnorm, a.damping_cases) == (c.niter, c.fx, c.gnorm,
                                                         c.damping_cases)
    assert torch.equal(a.x, c.x)
