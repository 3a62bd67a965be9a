"""The port's host More-Thuente search against the JAX package in float64:
the four interpolating minimizers, the mcstep interval update on seeded
random cases (the generator of tests/test_mcstep_fuzz.py), and whole
searches on extended Rosenbrock."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from lbfgs_torch import linesearch as tls
from lbfgs_torch.core import ProblemDef as TDef
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.params import LineSearchParams as TLS
from lbfgs_tpu import linesearch as jls
from lbfgs_tpu.core import ProblemDef as JDef
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.params import LineSearchParams as JLS

F = np.float64


def _gen_case(rng):
    """Random but structurally valid mcstep input."""
    x = rng.uniform(-2, 2)
    dx = -abs(rng.uniform(0.1, 3))
    fx = rng.uniform(-1, 1)
    brackt = rng.random() < 0.5
    if brackt:
        y = x + rng.uniform(0.2, 3)
        t = rng.uniform(min(x, y) + 1e-6, max(x, y) - 1e-6)
    else:
        y = x
        t = x + abs(rng.uniform(0.05, 2))
    fy = fx + rng.uniform(-0.5, 1.5)
    dy = rng.uniform(-3, 3)
    ft = fx + rng.uniform(-0.5, 1.5)
    dt = rng.uniform(-3, 3)
    tmin = min(x, t) - rng.uniform(0, 1)
    tmax = max(x, t) + rng.uniform(0.5, 5)
    return x, fx, dx, y, fy, dy, t, ft, dt, tmin, tmax, brackt


def _same(a, b, rel=1e-12):
    a, b = float(a), float(b)
    if np.isnan(a) and np.isnan(b):
        return True
    return a == pytest.approx(b, rel=rel, abs=1e-12)


@pytest.mark.parametrize("name,nargs", [
    ("_cubic_minimizer", 6), ("_cubic_minimizer2", 8),
    ("_quad_minimizer", 5), ("_quad_minimizer2", 4),
])
def test_minimizers_match_jax(name, nargs):
    rng = np.random.default_rng(11)
    jf = jax.jit(getattr(jls, name))
    tf = getattr(tls, name)
    for _ in range(300):
        args = [F(v) for v in rng.uniform(-3, 3, nargs)]
        if name == "_cubic_minimizer2":
            args[6], args[7] = F(min(args[6], args[7])), F(max(args[6], args[7]))
        with np.errstate(all="ignore"):
            t = tf(*args)
        assert _same(t, jf(*args)), (name, args)


@pytest.mark.parametrize("seed", range(3))
def test_update_trial_interval_matches_jax(seed):
    rng = np.random.default_rng(seed)
    jf = jax.jit(jls.update_trial_interval)
    agree = 0
    for _ in range(300):
        args = _gen_case(rng)
        t = tls.update_trial_interval(*(F(v) for v in args[:11]), args[11])
        j = jf(*(jnp.float64(v) for v in args[:11]), jnp.asarray(args[11]))
        assert t.status == int(j.status), args
        if t.status:
            continue
        agree += 1
        for name in ("x", "fx", "dx", "y", "fy", "dy", "t"):
            assert _same(getattr(t, name), getattr(j, name)), (name, args)
        assert t.brackt == bool(j.brackt)
    assert agree > 150


@pytest.mark.parametrize("seed,entry", [(0, "scaled"), (1, "one"), (2, "one")])
def test_more_thuente_search_matches_jax(seed, entry):
    rng = np.random.default_rng(seed)
    n = 64
    x = t_rosen.initial_point(n, device="cpu").numpy() + 0.3 * rng.standard_normal(n)
    fx, g = t_rosen._plain_value_and_grad(torch.from_numpy(x))
    g = g.numpy()
    d = -g
    stp0 = F(1.0 / np.linalg.norm(g)) if entry == "scaled" else F(1.0)
    finit = F(fx)

    tr = tls.find(TDef(t_rosen.value_and_grad), TLS(), torch.from_numpy(x), finit,
                  torch.from_numpy(g), torch.from_numpy(d), stp0, 1)
    jr = jls.find(JDef(value_and_grad=j_rosen.value_and_grad), JLS(), jnp.asarray(x),
                  jnp.float64(finit), jnp.asarray(g), None, jnp.asarray(d),
                  jnp.float64(stp0), jnp.int32(1))
    assert tr.status == int(jr.status)
    assert (tr.ncall, tr.neval) == (int(jr.ncall), int(jr.neval))
    assert float(tr.step) == pytest.approx(float(jr.step), rel=1e-12)
    assert float(tr.fx) == pytest.approx(float(jr.fx), rel=1e-12)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tr.gx.numpy(), np.asarray(jr.gx), rtol=1e-10, atol=1e-12)


def test_negative_entry_step_is_fatal_before_any_evaluation():
    x = t_rosen.initial_point(8, device="cpu")
    fx, g = t_rosen._plain_value_and_grad(x)
    calls = t_rosen.probe_ref.calls
    r = tls.find(TDef(t_rosen.value_and_grad), TLS(), x, F(fx), g, -g, F(-0.0), 3)
    assert r.status == 24 and r.neval == 3 and r.ncall == 0
    assert t_rosen.probe_ref.calls == calls


def test_float32_search_stays_in_float32():
    x = t_rosen.initial_point(64, torch.float32, device="cpu")
    fx, g = t_rosen._plain_value_and_grad(x)
    r = tls.find(TDef(t_rosen.value_and_grad), TLS(), x, np.float32(fx), g, -g,
                 np.float32(0.01), 1, materialize=False)
    assert type(r.step) is np.float32 and type(r.fx) is np.float32
    assert r.x is None and r.status == 0
