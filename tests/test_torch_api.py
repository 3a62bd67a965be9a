"""The PyTorch port's public surface against ``lbfgs_tpu``: builder fields,
status codes, cancellation, and the settings the port does not run yet."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lbfgs_torch
import lbfgs_tpu
from lbfgs_torch import status as t_status
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_tpu import status as j_status

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHAINS = {
    "defaults": [],
    "epsilon": [("with_epsilon", 1e-4)],
    "initial_step": [("with_initial_step_size", 2.0)],
    "max_step": [("with_max_step_size", 3.0)],
    "damping": [("with_damping", True)],
    "orthantwise": [("with_orthantwise", 1.0, 0, 99)],
    "ftol_gtol": [("with_linesearch_gtol", 0.8), ("with_linesearch_ftol", 1e-3)],
    "gradient_only": [("with_gradient_only",)],
    "max_linesearch": [("with_max_linesearch", 30)],
    "xtol": [("with_linesearch_xtol", 1e-10)],
    "min_step": [("with_linesearch_min_step", 1e-15)],
    "max_iterations": [("with_max_iterations", 7)],
    "max_evaluations": [("with_max_evaluations", 9)],
    "fx_delta": [("with_fx_delta", 1e-3, 4), ("with_fx_delta_enabled",)],
    "algorithm": [("with_linesearch_algorithm", "Backtracking")],
    "constrain": [("with_constrain_step_size", False)],
    "damping_fixed": [("with_damping_fixed",)],
    "scan_two_loop": [("with_compact_two_loop", False)],
    "speculative": [("with_speculative_linesearch", 3)],
    "adaptive": [("with_adaptive_entry_step", 1.5)],
    "fx_wide": [("with_fx_wide",)],
    "history_bf16": [("with_history_dtype", "bfloat16")],
}


def _apply(builder, chain):
    for name, *args in chain:
        builder = getattr(builder, name)(*args)
    return builder


@pytest.mark.parametrize("chain", list(CHAINS.values()), ids=list(CHAINS))
def test_builder_fields_match_jax(chain):
    t = dataclasses.asdict(_apply(lbfgs_torch.lbfgs(), chain).param)
    j = dataclasses.asdict(_apply(lbfgs_tpu.lbfgs(), chain).param)
    assert t == j


def test_history_dtype_accepts_torch_dtype():
    assert lbfgs_torch.lbfgs().with_history_dtype(torch.bfloat16).param.history_dtype == "bfloat16"


@pytest.mark.parametrize("setter,arg", [
    ("with_epsilon", -1.0), ("with_max_step_size", -1.0),
    ("with_linesearch_gtol", 1.5), ("with_linesearch_xtol", -1.0),
])
def test_builder_rejects_like_jax(setter, arg):
    for mod in (lbfgs_torch, lbfgs_tpu):
        with pytest.raises(AssertionError):
            getattr(mod.lbfgs(), setter)(arg)
    with pytest.raises(NotImplementedError):
        lbfgs_torch.lbfgs().with_linesearch_algorithm("Nope")


def test_status_codes_match_jax():
    assert {s.name: int(s) for s in t_status.Status} == {
        s.name: int(s) for s in j_status.Status}
    assert t_status.FATAL_MESSAGES == {
        t_status.Status(int(k)): v for k, v in j_status.FATAL_MESSAGES.items()}
    for c in range(0, 40):
        assert t_status.is_fatal(c) == j_status.is_fatal(c)
        assert t_status.is_ls_error(c) == j_status.is_ls_error(c)
    e = t_status.LbfgsError(t_status.Status.ERR_X_NOT_CHANGED, "at k=3")
    assert str(e) == "x not changed at k=3"


def test_orthantwise_window_matches_jax():
    from lbfgs_torch.orthantwise import Orthantwise as T
    from lbfgs_tpu.orthantwise import Orthantwise as J

    for args, n in [((1.0, 0, None), 10), ((0.5, 2, 99), 10), ((1.0, 3, 7), 10)]:
        assert T(*args).start_end(n) == J(*args).start_end(n)
    with pytest.raises(ValueError):
        T(1.0, 5, 3).start_end(10)


def test_progress_cancellation_gives_status_4():
    calls = []

    def progress(p):
        calls.append(p.niter)
        return True

    x0 = t_rosen.initial_point(100, device="cpu")
    rep = lbfgs_torch.lbfgs().minimize(x0, lbfgs_torch.default_evaluate(), progress)
    assert rep.status == t_status.Status.CANCELLED == 4
    assert calls == [1] and rep.niter == 1


#: OWL-QN, the backtracking searches, damping (damped OWL-QN included),
#: gradient_only, the wide objective scalar, the adaptive entry step, the
#: scan two-loop, float16 history and the speculative (K-way) search run.
#: Each case raised until its setting was ported and now checks that both
#: entry points run it (fx carried as float64 over float32 vectors under
#: ``fx_wide``): ``fx_wide``, ``adaptive_entry_step``, ``damping`` (here
#: with the scan two-loop), ``scan_two_loop``, ``float16_history``, and
#: ``orthantwise`` (damped, wide, speculative) and ``speculative`` (on the
#: Armijo ladder, the one it takes) once the speculative search was.
#: ``gradient_only`` and ``backtracking`` (the Wolfe ladder) with the
#: speculative search raised ``NotImplementedError`` with it, and now
#: raise ``ValueError`` as ``lbfgs_tpu`` does: the speculative search takes
#: the Armijo-only ladder without gradient_only
UNPORTED = {
    "orthantwise": lambda b: (b.with_orthantwise(1.0, 0, 99).with_damping(True)
                              .with_fx_wide().with_speculative_linesearch(2)),
    "damping": lambda b: b.with_damping(True).with_compact_two_loop(False),
    "gradient_only": lambda b: b.with_gradient_only().with_speculative_linesearch(2),
    "backtracking": lambda b: (b.with_linesearch_algorithm("BacktrackingWolfe")
                               .with_speculative_linesearch(2)),
    "scan_two_loop": lambda b: b.with_compact_two_loop(False),
    "fx_wide": lambda b: b.with_fx_wide(),
    "speculative": lambda b: (b.with_linesearch_algorithm("BacktrackingArmijo")
                              .with_speculative_linesearch(2)),
    "adaptive_entry_step": lambda b: b.with_adaptive_entry_step(2.0),
    "float16_history": lambda b: b.with_history_dtype("float16"),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_settings_raise(name):
    b = UNPORTED[name](lbfgs_torch.lbfgs())
    if name == "fx_wide":
        x0 = t_rosen.initial_point(100, dtype=torch.float32, device="cpu")
        for entry in ("minimize", "minimize_jit"):
            rep = getattr(b, entry)(x0, lbfgs_torch.default_evaluate())
            assert type(rep.fx) is np.float64 and rep.x.dtype == torch.float32
            assert rep.fx < 1e-3
        return
    if name == "adaptive_entry_step":
        x0 = t_rosen.initial_point(100, device="cpu")
        for entry in ("minimize", "minimize_jit"):
            rep = getattr(b.with_constrain_step_size(False), entry)(
                x0, lbfgs_torch.default_evaluate())
            assert np.isfinite(rep.fx) and rep.fx < 1e-3
        return
    if name in ("damping", "scan_two_loop", "float16_history"):
        # a float16 ring over float32 vectors ends its searches on rounding
        # before epsilon 1e-5 at this size: 30 iterations, from fx = 2420
        f16 = name == "float16_history"
        x0 = t_rosen.initial_point(100, dtype=torch.float32 if f16 else torch.float64,
                                   device="cpu")
        for entry in ("minimize", "minimize_jit"):
            rep = getattr(b.with_max_iterations(30 if f16 else 60), entry)(
                x0, lbfgs_torch.default_evaluate())
            assert np.isfinite(rep.fx) and rep.fx < (1.0 if f16 else 1e-3)
        return
    x0 = t_rosen.initial_point(100, device="cpu")
    if name in ("gradient_only", "backtracking"):
        for entry in ("minimize", "minimize_jit"):
            with pytest.raises(ValueError, match="Armijo-only ladder"):
                getattr(b, entry)(x0, lbfgs_torch.default_evaluate())
        return
    # both to convergence: "orthantwise" to the OWL-QN golden's fx,
    # "speculative" (675 iterations of the Armijo ladder) to Rosenbrock's 0
    for entry in ("minimize", "minimize_jit"):
        rep = getattr(b, entry)(x0, lbfgs_torch.default_evaluate())
        assert rep.status == t_status.Status.CONVERGED
        if name == "orthantwise":
            assert type(rep.fx) is np.float64 and rep.fx == pytest.approx(43.5025, rel=1e-6)
        else:
            assert rep.fx < 1e-9


def test_unported_entry_points_raise():
    x0 = t_rosen.initial_point(100, device="cpu")
    b = lbfgs_torch.lbfgs()
    with pytest.raises(NotImplementedError, match="fp8"):
        b.with_history_dtype("float8_e4m3fn")
    # the batched runner raised until it was ported: now a batch of one
    # runs the defaults' 35 iterations, and the settings it does not run
    # yet still raise
    out = b.minimize_batched(x0[None], lbfgs_torch.default_evaluate())
    assert int(out["niter"][0]) == 35 and float(out["fx"][0]) < 1e-9
    # batched OWL-QN raised until it was ported, at the capped step and
    # then at the uncapped one, and damped until damping was: now a batch
    # of one takes the solo run's iterations each way, and a setting the
    # batched runner does not run yet still raises, damped too
    ow = b.with_orthantwise(1.0, 0, None)
    damped = ow.with_constrain_step_size(False).with_damping(True)
    # and the wide objective scalar, the scan two-loop, a float16 history
    # and the speculative search until they were: now each runs as its
    # solo run, damped too
    for opt in (ow, ow.with_constrain_step_size(False), damped, damped.with_fx_wide(),
                damped.with_compact_two_loop(False), damped.with_history_dtype("float16"),
                damped.with_speculative_linesearch(4)):
        out = opt.minimize_batched(x0[None], lbfgs_torch.default_evaluate())
        solo = opt.minimize_jit(x0, lbfgs_torch.default_evaluate())
        assert int(out["niter"][0]) == solo.niter and int(out["status"][0]) == solo.status
        assert float(out["fx"][0]) == pytest.approx(float(solo.fx), rel=1e-9)
    # the native backend raised until it was ported: now it runs the C++
    # core (the defaults' 35 iterations, tests/test_native_parity.py:83-94)
    rep = b.minimize(x0, lbfgs_torch.default_evaluate(), backend="native")
    assert rep.niter == 35 and rep.fx < 1e-9
    # sharding raised until it was ported: now a world-size-1 gloo mesh
    # runs the defaults' 35 iterations, bit for bit the run with no mesh,
    # and a setting it does not run on a mesh raises naming it
    import _torch_mesh_ranks as ranks
    from lbfgs_torch.parallel import kernels_on_mesh, shard_vector

    with ranks.local_mesh() as mesh, kernels_on_mesh(mesh):
        sharded = b.minimize_jit(shard_vector(x0, mesh), lbfgs_torch.default_evaluate())
        with pytest.raises(NotImplementedError, match="native backend"):
            b.minimize(x0, lbfgs_torch.default_evaluate(), backend="native")
    solo = b.minimize_jit(x0, lbfgs_torch.default_evaluate())
    assert sharded.niter == solo.niter == 35 and sharded.fx == solo.fx
    assert torch.equal(sharded.x, solo.x)


def test_gradient_only_with_more_thuente_is_a_value_error():
    from lbfgs_torch.core import ProblemDef
    from lbfgs_torch.linesearch import find
    from lbfgs_torch.params import LineSearchParams

    x = t_rosen.initial_point(100, device="cpu")
    fx, g = t_rosen._plain_value_and_grad(x)
    with pytest.raises(ValueError, match="incompatible with MoreThuente"):
        find(ProblemDef(t_rosen.value_and_grad), LineSearchParams(gradient_only=True),
             x, np.float64(fx), g, -g, np.float64(0.1), 1)


def test_import_leaves_out_jax_and_triton():
    code = (
        "import sys, lbfgs_torch, lbfgs_torch.minimize, lbfgs_torch.interop, "
        "lbfgs_torch.models.rosenbrock, lbfgs_torch.models.lennard_jones, "
        "lbfgs_torch.models.logistic, lbfgs_torch.utils.csvio, "
        "lbfgs_torch.utils.profiling, lbfgs_torch.native, "
        "lbfgs_torch.utils.checkpoint, lbfgs_torch.pytree_api, "
        "lbfgs_torch.ops.fused, "
        "lbfgs_torch.ops.factory, lbfgs_torch.ops._build; "
        "bad = [m for m in ('jax', 'triton') if m in sys.modules]; "
        "assert not bad, bad"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)


@pytest.mark.parametrize("shape", ["scalar", "value_and_grad", "closure"])
def test_three_objective_shapes(shape):
    def scalar(x):
        return t_rosen._plain_value_and_grad(x)[0]

    def closure(x, g):
        fx, gx = t_rosen._plain_value_and_grad(x)
        g.copy_(gx)
        return float(fx)

    fn = {"scalar": scalar, "value_and_grad": t_rosen._plain_value_and_grad,
          "closure": closure}[shape]
    rep = lbfgs_torch.lbfgs().minimize(t_rosen.initial_point(100, device="cpu"), fn)
    assert rep.niter == 35
    assert rep.fx < 1e-9
