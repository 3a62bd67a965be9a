"""L1-regularizable log-linear (Poisson) regression objective.

The reference's realistic OWL-QN workload (``tests/owlqn.rs:24-46``): over
a [nrow, ncol] design matrix X and a count vector y,

    fx(beta) = -sum(y * X beta - exp(X beta)) + 0.5 * prec * sum(beta^2)
    g(beta)  = -X^T (y - exp(X beta)) + prec * beta

The objective is generic: it carries no fused trial, so under OWL-QN the
solver takes the composed branch (K9 per trial point, K10, K12 and K13
per iteration, K11 at the start).  It keeps the mesh's local contract
(``ops.collective.local_objective``) with X split by columns: on a mesh X
is this rank's column block (``parallel.shard_vector``) and beta its
shard, each rank forms its partial X_local . beta_local, one all-reduce
adds the partials with the shard's sum of beta^2 (the ``prec`` term), and
fx and the residual follow from the reduced X . beta on every rank alike;
the gradient X_local^T r + prec*beta_local is the shard's.  With no mesh
that all-reduce is the identity and the objective is the single-process
one bit for bit.  Its two products with X are plain
matrix products, as the JAX package leaves them to XLA outside any
Pallas kernel: ``torch.matmul`` in full float32 (the port does not touch
the TF32 or matmul-precision settings).

X may be stored in bfloat16 over float32 vectors (half the bytes of the
two passes that set this objective's time), as the JAX package's
accelerator cell runs it (``bench_logistic.py:160-161``): each product
takes bfloat16 inputs, beta (then the residual) rounded to bfloat16, and
gives a float32 output.  On the card that is ``torch.mm(...,
out_dtype=torch.float32)`` over X and its transposed view, so X is never
widened; on the CPU it is a float32 product over widened copies, which is
exact per term (a product of two bfloat16 values fits float32), so only
the order of the sums differs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fused
from ..ops.collective import active_mesh, local_objective, mesh_sum


def make_objective(X: torch.Tensor, y: torch.Tensor, prec: float = 0.0,
                   precision: str | None = "highest"):
    """The Poisson regression's value-and-grad over the design matrix X
    (``lbfgs_tpu/models/logistic.py:20-48``).  fx sums through
    ``fused.obj_sum``, so ``params.fx_wide`` carries it in float64.

    ``precision`` is the JAX package's argument: "highest" and None (the
    backend's default) are both torch's full-precision float32 product
    here.  y (and beta) are the vectors: float32 or float64.  X has
    their dtype, or is bfloat16 over float32 vectors
    (``lbfgs_tpu/models/logistic.py:35-36, 43-44``: beta and the residual
    rounded to bfloat16, float32 outputs; see ``bf16_matvec``)."""
    if precision not in ("highest", None):
        raise ValueError(f"unknown matmul precision {precision!r} (use 'highest' or None)")
    if y.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"Poisson regression over y {y.dtype}: y is a vector of the run, float32 "
            "or float64")
    if X.dtype == torch.bfloat16:
        if y.dtype != torch.float32:
            raise NotImplementedError(
                f"Poisson regression over a bfloat16 X with {y.dtype} vectors: a "
                "bfloat16 X takes float32 vectors (y and beta)")
    elif X.dtype != y.dtype:
        raise NotImplementedError(
            f"Poisson regression over X {X.dtype}, y {y.dtype}: X has the vectors' "
            "dtype, or is bfloat16 over float32 vectors (no float16 or fp8 X)")
    if X.ndim != 2 or y.shape != (X.shape[0],):
        raise ValueError(f"expected X [nrow, ncol] and y [nrow]; got {tuple(X.shape)}, "
                         f"{tuple(y.shape)}")
    narrow = X.dtype == torch.bfloat16
    # the CPU's plain version widens X once; the card never does
    Xw = X.float() if narrow and not fused.on_cuda(X, "bf16_matvec") else None

    def vag(beta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if beta.dtype != y.dtype:
            raise ValueError(f"beta {beta.dtype} against y {y.dtype}")
        if beta.shape[0] != X.shape[1]:
            where = " (on a mesh X is this rank's column block: parallel.shard_vector)" \
                if active_mesh() is not None else ""
            raise ValueError(f"beta has {beta.shape[0]} elements against X's {X.shape[1]} "
                             f"columns{where}")
        if narrow:
            xbeta = bf16_matvec(X, beta, Xw)
        else:
            xbeta = torch.matmul(X, beta)
        # the ranks' partials of X . beta and of beta . beta in one
        # collective (the identity with no mesh)
        xbeta, bb = mesh_sum(xbeta, torch.sum(beta * beta))
        exp_xbeta = torch.exp(xbeta)
        fx = -fused.obj_sum(y * xbeta - exp_xbeta) + 0.5 * prec * bb
        r = y - exp_xbeta
        if narrow:
            xtr = bf16_matvec(X.T, r, None if Xw is None else Xw.T)
        else:
            xtr = torch.matmul(X.T, r)
        return fx, -xtr + prec * beta

    return local_objective(vag)


def bf16_matvec(A: torch.Tensor, v: torch.Tensor, Aw: torch.Tensor | None = None):
    """A . round_bf16(v) with a float32 output, A bfloat16 [r, c] (X or
    its transposed view) and v float32 [c]: the JAX package's
    ``jnp.matmul(A, v.astype(bfloat16), preferred_element_type=float32)``.
    On the card ``torch.mm`` with ``out_dtype=torch.float32`` (bfloat16
    inputs, float32 accumulation and output; A is read as it is stored);
    on the CPU a float32 product over ``Aw``, A widened (made here if not
    given), and v rounded then widened: each term is exact in float32,
    only the order of the sums differs from the card's."""
    b = v.to(torch.bfloat16)
    if fused.on_cuda(A, "bf16_matvec"):
        return torch.mm(A, b[:, None], out_dtype=torch.float32)[:, 0]
    return torch.mv(A.float() if Aw is None else Aw, b.float())


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
