"""The port's example scripts (``examples/*_torch.py``), each run on the CPU
at a small size through its ``main`` and held to its JAX counterpart's
settings run through ``lbfgs_tpu``: the same iterations and evaluations,
fx rel 1e-9 in float64 and 1e-3 in float32 (where a float32 run's
iterations may part by summation order, its final fx and status; LJ38's
~200 iterations part too, and its relaxed energy is compared).
``sharded_giant_torch.py`` runs on two gloo ranks (one process each, the
rendezvous that ``torchrun`` would set in the environment), in float64."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import _torch_mesh_ranks as ranks
from lbfgs_tpu import lbfgs as j_lbfgs
from lbfgs_tpu.models import lennard_jones as j_lj
from lbfgs_tpu.models import logistic as j_logistic
from lbfgs_tpu.models import rosenbrock as j_rosen
from lbfgs_tpu.models import separable as j_sep
from lbfgs_tpu.ops.factory import make_fused_objective as j_make_fused_objective

EXAMPLES = os.path.join(ranks.REPO, "examples")
sys.path.insert(0, EXAMPLES)


def _same(t, j, rel):
    assert (t.niter, t.neval) == (int(j.niter), int(j.neval))
    assert float(t.fx) == pytest.approx(float(j.fx), rel=rel)


def test_sample():
    import sample_torch

    rep = sample_torch.main(["--device", "cpu"])
    _same(rep, j_lbfgs().minimize(j_rosen.initial_point(100), j_rosen.value_and_grad), 1e-9)
    assert rep.fx < 1e-10


def test_lj():
    import lj_torch

    rep = lj_torch.main(["--device", "cpu"])
    want = j_lbfgs().with_max_iterations(500).minimize(j_lj.lj38_positions(),
                                                        j_lj.make_objective())
    # ~200 iterations on a rugged landscape: the two packages' sums part
    # the trajectories on the way (194 and 197 iterations), so the outcome
    # is compared, the relaxed energy and the status
    assert rep.status == int(want.status)
    assert float(rep.fx) == pytest.approx(float(want.fx), abs=1e-6)
    assert rep.fx == pytest.approx(-164.2701507, abs=1e-4)


def test_owlqn_logistic():
    import owlqn_logistic_torch

    rep = owlqn_logistic_torch.main(["--device", "cpu", "--nrow", "300", "--ncol", "11"])
    X, y = j_logistic.synthetic_dataset(nrow=300, ncol=11, seed=7)
    want = (j_lbfgs().with_orthantwise(1.0, 1, 11).with_epsilon(1e-4)
            .minimize(jnp.zeros(11), j_logistic.make_objective(X, y)))
    _same(rep, want, 1e-9)
    np.testing.assert_allclose(rep.x.numpy(), np.asarray(want.x), rtol=1e-6, atol=1e-9)


def test_owlqn_wide_fx():
    import owlqn_wide_fx_torch

    n = 4096
    rep = owlqn_wide_fx_torch.main(["--device", "cpu", "--n", str(n)])
    want = (j_lbfgs().with_orthantwise(1.0, 0, n - 1).with_fx_wide()
            .with_constrain_step_size(False).with_epsilon(3e-2).with_max_iterations(300)
            .minimize_jit(j_rosen.initial_point(n, dtype=jnp.float32), j_rosen.value_and_grad))
    assert rep.status == int(want.status) == 1
    assert isinstance(rep.fx, np.float64) and rep.x.dtype == torch.float32
    assert float(rep.fx) == pytest.approx(float(want.fx), rel=1e-3)


def test_separable():
    import separable_torch

    n = 1024
    reps = separable_torch.main(["--device", "cpu", "--n", str(n)])
    rng = np.random.RandomState(0)
    w = jnp.asarray(0.5 + np.abs(rng.randn(n)), jnp.float32)
    t = jnp.asarray(rng.randn(n), jnp.float32)
    zeros = jnp.zeros(n, jnp.float32)

    def huber(x, gidx, tb):
        r = x - tb
        scale = 1.0 + 0.25 * (gidx % 4).astype(x.dtype)
        a = jnp.abs(r)
        fx_elem = scale * jnp.where(a <= 1.0, 0.5 * (r * r), a - 0.5)
        return fx_elem, scale * jnp.where(a <= 1.0, r, jnp.sign(r))

    want = [
        j_lbfgs().with_epsilon(1e-5).with_constrain_step_size(False)
        .minimize(zeros, j_sep.quadratic(w, t)),
        j_lbfgs().with_orthantwise(0.3, 0, None).with_constrain_step_size(False)
        .with_adaptive_entry_step(2.0).with_epsilon(1e-4).minimize(zeros, j_sep.quadratic(w, t)),
        j_lbfgs().with_epsilon(1e-5).with_constrain_step_size(False)
        .minimize(zeros, j_make_fused_objective(huber, extras=(t,))),
    ]
    for rep, j in zip(reps, want):
        assert rep.status == int(j.status)
        assert (rep.niter, rep.neval) == (int(j.niter), int(j.neval))
        assert float(rep.fx) == pytest.approx(float(j.fx), rel=1e-3, abs=1e-6)
        np.testing.assert_allclose(rep.x.numpy(), np.asarray(j.x), rtol=1e-3, atol=1e-4)
    # the twin of the Huber body against the JAX package's on a few points
    x = np.linspace(-3.0, 3.0, 16).astype(np.float32)
    tb = np.zeros(16, np.float32)
    gidx = np.arange(16)
    for a, b in zip(separable_torch.huber_ref(torch.from_numpy(x), torch.from_numpy(gidx),
                                              torch.from_numpy(tb)),
                    huber(jnp.asarray(x), jnp.asarray(gidx), jnp.asarray(tb))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sharded_giant_on_two_gloo_ranks(tmp_path):
    # n = 256 converges (42 iterations), so the run's end is compared
    n, world = 256, 2
    port = ranks.free_port()
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import sharded_giant_torch as m; "
            "reps = m.main(sys.argv[3:]); json.dump([dict(niter=r.niter, neval=r.neval, "
            "fx=float(r.fx), x=r.x.tolist()) for r in reps], open(sys.argv[2], 'w'))")
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=ranks.REPO, OMP_NUM_THREADS="1",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                   RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, EXAMPLES, str(tmp_path / f"rank{r}.json"),
             "--device", "cpu", "--n", str(n), "--dtype", "float64"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
    outs = []
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    assert f"2 ranks (gloo), n = {n}" in outs[0]
    got = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(world)]
    assert got[0] == got[1]
    want = (j_lbfgs().with_epsilon(1e-3).with_max_iterations(60)
            .minimize_jit(j_rosen.initial_point(n), j_rosen.value_and_grad))
    for rep in got[0]:
        assert (rep["niter"], rep["neval"]) == (int(want.niter), int(want.neval))
        assert rep["fx"] == pytest.approx(float(want.fx), rel=1e-9)
        np.testing.assert_allclose(rep["x"], np.asarray(want.x), rtol=1e-9, atol=1e-12)
