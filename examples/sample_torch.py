"""Extended-Rosenbrock sample run (reference ``examples/sample.rs``) on the
PyTorch port: the counterpart of ``examples/sample.py``.

N = 100, x0 alternating (-1.2, 1.0), default parameters, printing
per-iteration progress.  On the card (its kernels: K1 at the start, K2
per probe, K4 and K3 per iteration), or on the CPU:

    python examples/sample_torch.py
    python examples/sample_torch.py --device cpu
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
    ap.add_argument("--n", type=int, default=100, help="vector length (even)")
    args = ap.parse_args(argv)
    x0 = rosenbrock.initial_point(args.n, torch.float64, device=args.device)

    def progress(p):
        print(f"Iteration {p.niter}:")
        print(f"  fx = {p.fx}, x[0] = {float(p.x[0])}, x[1] = {float(p.x[1])}")
        print(f"  xnorm = {p.xnorm}, gnorm = {p.gnorm}, step = {p.step}")
        print()
        return False

    rep = lbfgs().minimize(x0, rosenbrock.value_and_grad, progress)
    print(f"  fx = {rep.fx}, x[0] = {float(rep.x[0])}, x[1] = {float(rep.x[1])}")
    return rep


if __name__ == "__main__":
    main()
