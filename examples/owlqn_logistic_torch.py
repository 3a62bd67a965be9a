"""OWL-QN L1-regularized log-linear regression (reference
``tests/owlqn.rs`` as a runnable example) on the PyTorch port: the
counterpart of ``examples/owlqn_logistic.py``.  The intercept is excluded
from the L1 window.  The Poisson objective is generic: each search trial
is projected by K9, each iteration runs K10, K12 and K13, the start K11:

    python examples/owlqn_logistic_torch.py
    python examples/owlqn_logistic_torch.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from lbfgs_torch import lbfgs
from lbfgs_torch.models import logistic


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--nrow", type=int, default=500)
    ap.add_argument("--ncol", type=int, default=21)
    args = ap.parse_args(argv)
    X, y = logistic.synthetic_dataset(nrow=args.nrow, ncol=args.ncol, seed=7,
                                      device=args.device)
    obj = logistic.make_objective(X, y)
    rep = (
        lbfgs()
        .with_orthantwise(1.0, 1, args.ncol)
        .with_epsilon(1e-4)
        .minimize(torch.zeros(args.ncol, dtype=torch.float64, device=args.device), obj)
    )
    beta = rep.x.cpu().numpy()
    print(f"fx = {rep.fx:.6f}  niter = {rep.niter}  neval = {rep.neval}")
    print(f"nonzero coefficients: {np.sum(beta != 0)}/{args.ncol}")
    print("beta:", np.array2string(beta, precision=4, suppress_small=True))
    return rep


if __name__ == "__main__":
    main()
