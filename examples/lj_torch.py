"""Lennard-Jones cluster relaxation (reference ``examples/lj.rs``) on the
PyTorch port: the counterpart of ``examples/lj.py``.

Relaxes a 38-atom LJ cluster (114 variables, float64) with the default
L-BFGS; the chemistry workload that motivated the reference's
gradient-only and damped modes.  Gradient = -forces.  The objective is a
generic one, so each iteration runs the composed pair + Gram pass and the
combine (K3) on the card:

    python examples/lj_torch.py
    python examples/lj_torch.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lbfgs_torch import lbfgs
from lbfgs_torch.models import lennard_jones


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--max-iterations", type=int, default=500)
    args = ap.parse_args(argv)
    x0 = lennard_jones.lj38_positions(device=args.device)
    obj = lennard_jones.make_objective()

    def progress(p):
        print(f"Iteration {p.niter}, Evaluation: {p.neval}")
        print(f"  energy = {p.fx:.6f}, gnorm = {p.gnorm:.6f}, step = {p.step}")
        return False

    rep = lbfgs().with_max_iterations(args.max_iterations).minimize(x0, obj, progress)
    print(f"final energy: {rep.fx:.6f} (LJ38 global minimum is -173.928427)")
    return rep


if __name__ == "__main__":
    main()
