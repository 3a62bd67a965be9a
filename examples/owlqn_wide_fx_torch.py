"""OWL-QN at scale with the wide (float64) objective-scalar carry, on the
PyTorch port: the counterpart of ``examples/owlqn_wide_fx.py``.

At large n the L1 term pins |fx| at a magnitude where float32's ~7
significant digits cannot represent the Armijo sufficient-decrease
differences: the search ladders exhaust and the run stalls.
``with_fx_wide()`` keeps every vector float32 but carries the objective
scalars in float64 (float32 per-program partials of the kernels, a
float64 sum across them): the same configuration then converges.  On the
card the ring is bfloat16, as the JAX script takes it off the CPU.

    python examples/owlqn_wide_fx_torch.py                 # n = 2^16
    python examples/owlqn_wide_fx_torch.py --n 100000000   # at scale
    python examples/owlqn_wide_fx_torch.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from lbfgs_torch import lbfgs
from lbfgs_torch.models import rosenbrock


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=int(os.environ.get("BENCH_N", 1 << 16)))
    args = ap.parse_args(argv)
    n = args.n
    x0 = rosenbrock.initial_point(n, torch.float32, device=args.device)

    report = (
        lbfgs()
        .with_orthantwise(1.0, 0, n - 1)
        .with_fx_wide()                    # float64 objective-scalar carry
        .with_history_dtype("bfloat16" if x0.is_cuda else None)
        .with_constrain_step_size(False)   # the 2018 step policy
        .with_epsilon(3e-2)
        .with_max_iterations(300)
        .minimize_jit(x0, rosenbrock.value_and_grad)
    )
    print(f"n = {n}")
    print(f"status = {report.status}, iterations = {report.niter}, "
          f"evaluations = {report.neval}")
    print(f"fx = {report.fx!r}  (carried as float64; x stays float32)")
    print(f"scaled ||pg|| = {report.gnorm / max(1.0, report.xnorm):.3e}")
    return report


if __name__ == "__main__":
    main()
