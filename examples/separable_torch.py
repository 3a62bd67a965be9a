"""Custom objectives at full kernel speed through the factory, on the
PyTorch port: the counterpart of ``examples/separable.py``.

``make_fused_objective`` turns a per-block Triton body and its torch twin
into a complete fused-kernel objective: trial and probe, the OWL-QN
variants, the one-pass epilogues and the combine+probe fusions (K1, K2,
K4, K15; K8, K14, K16).  Three runs at n = 2^16: the ready-made weighted
quadratic, the diagonal LASSO on it, and a custom index-weighted Huber
loss (its Triton body in ``_huber_block.py``).

    python examples/separable_torch.py
    python examples/separable_torch.py --device cpu
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np
import torch

from lbfgs_torch import lbfgs
from lbfgs_torch.models import separable
from lbfgs_torch.ops.factory import make_fused_objective


def huber_ref(x, gidx, tb):
    """The Huber body's torch twin: (scale * huber(x - t), its gradient)."""
    r = x - tb
    scale = 1.0 + 0.25 * (gidx % 4).to(x.dtype)
    a = torch.abs(r)
    quad = 0.5 * (r * r)
    lin = a - 0.5
    fx_elem = scale * torch.where(a <= 1.0, quad, lin)
    g = scale * torch.where(a <= 1.0, r, torch.sign(r))
    return fx_elem, g


def _huber_block():
    """Loader of the Triton body (imports triton)."""
    sys.path.insert(0, HERE)
    from _huber_block import huber_block

    return huber_block


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=1 << 16)
    args = ap.parse_args(argv)
    n, dev = args.n, args.device
    rng = np.random.RandomState(0)
    w = torch.from_numpy((0.5 + np.abs(rng.randn(n))).astype(np.float32)).to(dev)
    t = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    zeros = lambda: torch.zeros(n, dtype=torch.float32, device=dev)
    reports = []

    # ready-made family member: weighted quadratic with bound extras
    rep = (
        lbfgs()
        .with_epsilon(1e-5)
        .with_constrain_step_size(False)
        .minimize(zeros(), separable.quadratic(w, t))
    )
    print(f"quadratic: fx={rep.fx:.3e} niter={rep.niter} "
          f"max|x-t|={float(torch.max(torch.abs(rep.x - t))):.2e}")
    reports.append(rep)

    # OWL-QN on the same family: diagonal LASSO with an analytic solution
    c = 0.3
    rep = (
        lbfgs()
        .with_orthantwise(c, 0, None)
        .with_constrain_step_size(False)
        .with_adaptive_entry_step(2.0)
        .with_epsilon(1e-4)
        .minimize(zeros(), separable.quadratic(w, t))
    )
    x_star = torch.sign(t) * torch.clamp(torch.abs(t) - c / w, min=0.0)
    print(f"owlqn lasso: niter={rep.niter} neval={rep.neval} "
          f"max|x-x*|={float(torch.max(torch.abs(rep.x - x_star))):.2e} "
          f"zeros={int(torch.sum(rep.x == 0.0))}/{n}")
    reports.append(rep)

    # a custom body, one screen of code: index-weighted Huber-like loss
    obj = make_fused_objective(_huber_block, extras=(t,), block_ref=huber_ref)
    rep = (
        lbfgs()
        .with_epsilon(1e-5)
        .with_constrain_step_size(False)
        .minimize(zeros(), obj)
    )
    print(f"huber: fx={rep.fx:.3e} niter={rep.niter} "
          f"max|x-t|={float(torch.max(torch.abs(rep.x - t))):.2e}")
    reports.append(rep)
    return reports


if __name__ == "__main__":
    main()
