"""L1-regularizable log-linear (Poisson) regression objective.

The reference's realistic OWL-QN workload (``tests/owlqn.rs:24-46``): over
a [nrow, ncol] design matrix X and a count vector y,

    fx(beta) = -sum(y * X beta - exp(X beta)) + 0.5 * prec * sum(beta^2)
    g(beta)  = -X^T (y - exp(X beta)) + prec * beta

The objective is generic: it carries no fused trial, so under OWL-QN the
solver takes the composed branch (K9 per trial point, K10, K12 and K13
per iteration, K11 at the start).  Its two products with X are plain
matrix products, as the JAX package leaves them to XLA outside any
Pallas kernel: ``torch.matmul`` in full float32 (the port does not touch
the TF32 or matmul-precision settings).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fused


def make_objective(X: torch.Tensor, y: torch.Tensor, prec: float = 0.0,
                   precision: str | None = "highest"):
    """The Poisson regression's value-and-grad over the design matrix X
    (``lbfgs_tpu/models/logistic.py:20-48``).  fx sums through
    ``fused.obj_sum``, so ``params.fx_wide`` carries it in float64.

    ``precision`` is the JAX package's argument: "highest" and None (the
    backend's default) are both torch's full-precision float32 product
    here.  X must have the vectors' dtype: a bfloat16 X (the TPU bench's
    storage) needs a product with a float32 output from bfloat16 inputs,
    which ``torch.matmul`` does not give, and is not ported."""
    if precision not in ("highest", None):
        raise ValueError(f"unknown matmul precision {precision!r} (use 'highest' or None)")
    if X.dtype not in (torch.float32, torch.float64) or y.dtype != X.dtype:
        raise NotImplementedError(
            f"Poisson regression over X {X.dtype}, y {y.dtype}: X and y must share the "
            "vectors' float32 or float64 dtype (a bfloat16 X is not ported)")
    if X.ndim != 2 or y.shape != (X.shape[0],):
        raise ValueError(f"expected X [nrow, ncol] and y [nrow]; got {tuple(X.shape)}, "
                         f"{tuple(y.shape)}")

    def vag(beta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if beta.dtype != X.dtype:
            raise ValueError(f"beta {beta.dtype} against X {X.dtype}")
        xbeta = torch.matmul(X, beta)
        exp_xbeta = torch.exp(xbeta)
        fx = -fused.obj_sum(y * xbeta - exp_xbeta) + 0.5 * prec * torch.sum(beta * beta)
        g = -torch.matmul(X.T, y - exp_xbeta) + prec * beta
        return fx, g

    vag.__lbfgs_value_and_grad__ = True
    return vag


def synthetic(nrow: int, ncol: int, seed: int = 0, dtype=torch.float32, x_dtype=None,
              nnz: int = 32, device="cuda", generator: torch.Generator | None = None):
    """A synthetic Poisson-regression dataset made on the device: the
    counterpart of ``lbfgs_tpu/models/logistic.py:synthetic_device``
    (its shapes and its law, not its random stream).  Column 0 is the
    intercept; the true beta has ``nnz`` nonzero coefficients, +-0.3 on
    columns 1..nnz, so the L1 path has sparsity to recover; y is Poisson
    with rate exp(clip(X beta, -6, 6)).  The draws come from
    ``generator``, or from a new one on ``device`` seeded with ``seed``.
    Returns (X, y), X in ``x_dtype`` (default ``dtype``)."""
    x_dtype = x_dtype or dtype
    g = generator if generator is not None else torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((nrow, ncol), generator=g, dtype=dtype, device=g.device)
    X[:, 0] = 1.0
    idx = torch.arange(ncol, device=X.device)
    sign = torch.where(idx % 2 == 0, 1.0, -1.0)
    beta = torch.where((idx >= 1) & (idx <= nnz), 0.3 * sign, 0.0).to(dtype)
    lam = torch.exp(torch.clamp(torch.matmul(X, beta), -6.0, 6.0))
    y = torch.poisson(lam, generator=g).to(dtype)
    return X.to(x_dtype), y


def synthetic_dataset(nrow: int = 500, ncol: int = 21, seed: int = 7, dtype=torch.float64,
                      device="cuda"):
    """The JAX package's deterministic dataset shaped like the reference's
    tests/x.csv (500 x 21), made with numpy as there, value for value
    (``lbfgs_tpu/models/logistic.py:81-94``).  Returns (X, y) on
    ``device``."""
    rng = np.random.RandomState(seed)
    X = rng.randn(nrow, ncol)
    X[:, 0] = 1.0  # intercept
    beta_true = np.zeros(ncol)
    beta_true[0] = 0.3
    beta_true[1:6] = np.array([0.4, -0.3, 0.2, 0.0, -0.2])
    lam = np.exp(np.clip(X @ beta_true, -10, 10))
    y = rng.poisson(lam).astype(float)
    return (torch.from_numpy(X).to(device=device, dtype=dtype),
            torch.from_numpy(y).to(device=device, dtype=dtype))
