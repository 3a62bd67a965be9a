"""Giant-vector regime demo on the PyTorch port: Rosenbrock sharded over
one process per GPU (the counterpart of ``examples/sharded_giant.py``).

Run under ``torchrun``, one rank per card (NCCL), or on the CPU over gloo:

    torchrun --nproc_per_node=4 examples/sharded_giant_torch.py
    torchrun --nproc_per_node=2 examples/sharded_giant_torch.py --device cpu

Each rank holds a contiguous 1/W of every vector and of both history
rings, runs the kernels on its shard, and adds each launch's scalars
over the ranks in one all-reduce.  The first run is the factory
Rosenbrock (its Triton kernels on the shard); the second the generic
Rosenbrock under the local contract (``parallel.local_objective``: it gets
the shard and returns the whole fx, summed over the ranks, and the
shard's gradient), which takes the composed branch (K3 per iteration).
"""

import argparse
import datetime
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import torch
import torch.distributed as dist

from lbfgs_torch import lbfgs
from lbfgs_torch.models import rosenbrock
from lbfgs_torch.parallel import (gather_vector, init_distributed, kernels_on_mesh, make_mesh,
                                  shard_vector)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (NCCL, default) or cpu (gloo)")
    ap.add_argument("--n", type=int, default=1 << 22, help="vector length")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --device cpu")
    init_distributed(backend="nccl" if cuda else "gloo",
                     timeout=datetime.timedelta(seconds=600))
    reports = []
    try:
        mesh = make_mesh()
        if not cuda:
            mesh.device = torch.device("cpu")
        n = args.n
        if mesh.rank == 0:
            print(f"{mesh.size} ranks ({dist.get_backend()}), n = {n}")
        x0 = rosenbrock.initial_point(n, getattr(torch, args.dtype), device=mesh.device)
        for name, obj in (("fused", rosenbrock.value_and_grad),
                          ("generic", rosenbrock.generic_value_and_grad)):
            xs = shard_vector(x0, mesh)
            t0 = time.time()
            with kernels_on_mesh(mesh):
                rep = (
                    lbfgs()
                    .with_epsilon(1e-3)
                    .with_max_iterations(60)
                    .minimize_jit(xs, obj)
                )
            wall = time.time() - t0
            if mesh.rank == 0:
                print(f"{name}: niter {rep.niter}  fx {rep.fx:.3e}  gnorm {rep.gnorm:.3e}  "
                      f"wall {wall:.1f}s")
            rep.x = gather_vector(rep.x, mesh)
            reports.append(rep)
    finally:
        dist.destroy_process_group()
    return reports


if __name__ == "__main__":
    main()
