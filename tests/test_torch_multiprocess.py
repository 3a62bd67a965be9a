"""The PyTorch port's solver across OS processes (the counterpart of
``tests/test_multiprocess.py:155-180``).

Each rank is a process of one gloo group that holds a shard of the
[n] vector; ``minimize_jit`` runs the whole L-BFGS loop under
``kernels_on_mesh`` with every kernel's scalars crossing the process
boundary in one all-reduce (``_torch_mesh_ranks.job_runs``).  Rosenbrock
from its start, 25 iterations at lbfgs()'s defaults:

  * 2 processes, n = 128, float64;
  * 4 processes, n = 2^16, float32, at the defaults and on OWL-QN's path
    (c = 1 on [0, n - 1), Armijo);
  * 4 processes on the combine+probe fusion's path (the uncapped step),
    at n = 4096 in float64 and at n = 2^16 in float32.

Each asserts that all ranks end with the same bits (k, evaluations, fx,
gathered x) and that the run lands on the single-process port run: the
same iterations, fx at the JAX test's bounds (rel 1e-6 with abs 1e-10 in
float64; rel 1e-3 in float32, where the four-way split reassociates the
reductions).  The split only reassociates sums, so fx after the first
iteration agrees to a few float32 ulps (rel 1e-6), and through the first
8 iterations within the bound the JAX package holds another summation
order of this path to (rel 1e-3, ``tests/test_combine_probe.py:113-114``);
past that Rosenbrock amplifies the ulps (``tools/f32_reassociation.py``
prints the gap per iteration: on the uncapped float32 path it reaches
~1e-2 mid-run and shrinks again by iteration 25).

The single-process run is made on one thread, as each rank runs: torch's
CPU reductions split over threads, so its float32 fx moves with the
thread count alone (the same tool: at n = 2^16 uncapped, by rel 2.9e-3
after 25 iterations between 2 and 8 threads), more than the bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks
from lbfgs_torch.minimize import minimize_jit
from lbfgs_torch.models import rosenbrock

ITERS = 25
RUNS = {
    "two_process_f64": (2, 128, "float64", dict(max_iterations=ITERS)),
    "four_process_f32": (4, 1 << 16, "float32", dict(max_iterations=ITERS)),
    "four_process_f64_fused": (4, 4096, "float64",
                               dict(max_iterations=ITERS, constrain_step_size=False)),
    "four_process_f32_fused": (4, 1 << 16, "float32",
                               dict(max_iterations=ITERS, constrain_step_size=False)),
    "four_process_f32_owlqn": (4, 1 << 16, "float32",
                               dict(max_iterations=ITERS, orthantwise=[1.0, 0, (1 << 16) - 1],
                                    algorithm="BacktrackingArmijo")),
}
TOL = {"float64": dict(rel=1e-6, abs=1e-10), "float32": dict(rel=1e-3)}
#: fx after the first iteration: a few ulps of the dtype
FIRST = {"float64": 1e-12, "float32": 1e-6}
#: the iterations held to TOL one by one
EARLY = 8


def _single_process(params, x0):
    """The port's run with no mesh on one thread (as each rank runs), and
    its fx after each iteration."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return ranks.fx_trace(
            lambda: minimize_jit(params, x0, rosenbrock.value_and_grad, return_state=True))
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = {}
    for w in sorted({w for w, *_ in RUNS.values()}):
        for dtype in sorted({d for ww, _, d, _ in RUNS.values() if ww == w}):
            mine = {k: v for k, v in RUNS.items() if v[0] == w and v[2] == dtype}
            (n,) = {v[1] for v in mine.values()}
            res = ranks.launch("runs", w, tmp_path_factory.mktemp(f"mp_{w}_{dtype}"), dict(
                n=n, dtype=dtype, paths={k: v[3] for k, v in mine.items()}), timeout=240)
            for k in mine:
                out[k] = [r[k] for r in res]
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_multiprocess_run_matches_single_process(jobs, name):
    w, n, dtype, cfg = RUNS[name]
    got = jobs[name]
    assert len(got) == w
    keys = ("k", "neval", "status", "fx_hex", "x_sha")
    assert len({tuple(r[k] for k in keys) for r in got}) == 1
    params = ranks._params(cfg)
    x0 = rosenbrock.initial_point(n, getattr(torch, dtype), device="cpu")
    ref, trace = _single_process(params, x0)
    assert got[0]["k"] == ref.k
    assert np.isfinite(got[0]["fx"])
    assert got[0]["fx"] == pytest.approx(float(ref.prob.fx), **TOL[dtype])
    assert got[0]["collectives"]["gathers"] == 0
    # the split reassociates sums only: the runs start together and part
    # slowly
    mine = got[0]["fx_trace"]
    assert len(mine) == len(trace)
    assert mine[0] == pytest.approx(trace[0], rel=FIRST[dtype])
    for i, (a, b) in enumerate(zip(mine[:EARLY], trace[:EARLY])):
        assert a == pytest.approx(b, **TOL[dtype]), f"iteration {i + 1}"
