"""How far float32 reassociation alone moves the port's Rosenbrock run at
n = 2^16, 25 iterations from its start, on the CPU: the witness behind
the float32 bounds of tests/test_torch_multiprocess.py.

    PYTHONPATH=. python tools/f32_reassociation.py

For the capped (lbfgs()'s defaults) and the uncapped path, prints one
JSON line each:

- the single-process run's iterations, evaluations and fx at 1, 2, 4 and
  8 torch threads (torch's CPU reductions split over threads, so only
  their summation order differs);
- the same run on four gloo ranks (``tests/_torch_mesh_ranks.py``, one
  thread each) and its fx gap to the one-thread run after every
  iteration.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tests"))

import _torch_mesh_ranks as ranks  # noqa: E402
from lbfgs_torch.minimize import minimize_jit  # noqa: E402
from lbfgs_torch.models import rosenbrock  # noqa: E402

N, ITERS, WORLD = 1 << 16, 25, 4
PATHS = {"capped": dict(max_iterations=ITERS),
         "uncapped": dict(max_iterations=ITERS, constrain_step_size=False)}


def _solo(params, threads: int):
    torch.set_num_threads(threads)
    x0 = rosenbrock.initial_point(N, torch.float32, device="cpu")
    return ranks.fx_trace(
        lambda: minimize_jit(params, x0, rosenbrock.value_and_grad, return_state=True))


def main() -> None:
    with tempfile.TemporaryDirectory() as d:
        mesh = ranks.launch("runs", WORLD, d, dict(n=N, dtype="float32", paths=PATHS))[0]
    for name, cfg in PATHS.items():
        params = ranks._params(cfg)
        solo = {t: _solo(params, t) for t in (1, 2, 4, 8)}
        trace = solo[1][1]
        print(json.dumps(dict(
            path=name, n=N, dtype="float32",
            solo={t: dict(k=int(st.k), neval=int(st.prob.neval), fx=float(st.prob.fx))
                  for t, (st, _) in solo.items()},
            ranks=dict(world=WORLD, k=mesh[name]["k"], neval=mesh[name]["neval"],
                       fx=mesh[name]["fx"]),
            rel_gap_per_iter=[abs(a / b - 1) for a, b in zip(mesh[name]["fx_trace"], trace)])))


if __name__ == "__main__":
    main()
