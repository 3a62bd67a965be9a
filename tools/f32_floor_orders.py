"""Where the 512 x 64 Poisson runs of tests/test_owlqn_logistic.py:90-143
stop, float32 and wide, in both packages and under four summation orders
of the port's two matrix products, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/f32_floor_orders.py

The data are the JAX test's own (``synthetic_device(512, 64, seed=0,
nnz=8)``), handed to both packages as numpy arrays.  Each run is c = 5
on [1, 64), BacktrackingArmijo, epsilon 1e-4, at most 60 iterations of
the step-at-a-time loop.  Prints one JSON line per run: the package,
the product order, the mode, the iteration and the status it stopped at,
and its final fx.
"""

from __future__ import annotations

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lbfgs_torch.minimize import LbfgsState as TState
from lbfgs_torch.ops import fused
from lbfgs_torch.orthantwise import Orthantwise as TOW
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_torch.params import LineSearchAlgorithm as TAlgo
from lbfgs_tpu.minimize import LbfgsState as JState
from lbfgs_tpu.models import logistic as j_log
from lbfgs_tpu.orthantwise import Orthantwise as JOW
from lbfgs_tpu.params import LbfgsParams as JParams
from lbfgs_tpu.params import LineSearchAlgorithm as JAlgo


def _objective(X: torch.Tensor, y: torch.Tensor, order: str, Xj):
    """The Poisson regression with its products X beta and X^T r taken in
    one of four orders: torch.matmul; a float64 product rounded to
    float32; an elementwise product and a row sum; the JAX package's own
    jitted product."""
    jmv = jax.jit(lambda b: jnp.matmul(Xj, b, precision=None))
    jmvt = jax.jit(lambda r: jnp.matmul(Xj.T, r, precision=None))
    XT = X.T.contiguous()

    def mv(A, b, jfn):
        if order == "matmul":
            return A @ b
        if order == "float64":
            return (A.double() @ b.double()).float()
        if order == "rowsum":
            return (A * b).sum(dim=1)
        return torch.from_numpy(np.array(jfn(jnp.asarray(b.numpy()))))

    def vag(beta):
        xb = mv(X, beta, jmv)
        e = torch.exp(xb)
        fx = -fused.obj_sum(y * xb - e)
        return fx, -mv(XT if order != "matmul" else X.T, y - e, jmvt)

    vag.__lbfgs_value_and_grad__ = True
    return vag


def _run(state_cls, params, x0, obj) -> dict:
    st = state_cls.build(params, x0, obj)
    err = None
    try:
        while not st.is_converged():
            st.propagate()
    except Exception as e:  # the fatal statuses of both packages
        err = str(e)
    return dict(k=int(st.state.k), status=int(st.state.status), error=err,
                fx=float(st.state.prob.fx))


def main() -> None:
    jax.config.update("jax_enable_x64", True)
    logging.disable(logging.ERROR)
    Xj, yj = j_log.synthetic_device(512, 64, seed=0, dtype=jnp.float32,
                                    x_dtype=jnp.float32, nnz=8)
    X, y = torch.from_numpy(np.array(Xj)), torch.from_numpy(np.array(yj))
    for wide in (False, True):
        jp = JParams(max_iterations=60, epsilon=1e-4, orthantwise=JOW(5.0, 1, 64),
                     fx_wide=wide).replace_ls(algorithm=JAlgo.BacktrackingArmijo)
        out = _run(JState, jp, jnp.zeros(64, jnp.float32),
                   j_log.make_objective(Xj, yj, precision=None))
        print(json.dumps(dict(package="lbfgs_tpu", order="xla", fx_wide=wide, **out)))
        tp = TParams(max_iterations=60, epsilon=1e-4, orthantwise=TOW(5.0, 1, 64),
                     fx_wide=wide).replace_ls(algorithm=TAlgo.BacktrackingArmijo)
        for order in ("matmul", "float64", "rowsum", "jax_products"):
            out = _run(TState, tp, torch.zeros(64), _objective(X, y, order, Xj))
            print(json.dumps(dict(package="lbfgs_torch", order=order, fx_wide=wide, **out)))


if __name__ == "__main__":
    main()
