"""Orthant-Wise Limited-memory Quasi-Newton (OWL-QN) operators.

The reference OWL-QN module (``src/orthantwise.rs:1-181``) as elementwise
torch expressions over the parameter vector, with the ``[start, end)``
regularization window as an index mask.  These are the plain forms; the
kernels that carry the same arithmetic on the card are in ``ops``.

Semantics parity notes (as ``lbfgs_tpu.orthantwise``):
  * ``signum`` follows the mathematical convention: 0 at 0 and NaN, else
    +/-1 (``src/orthantwise.rs:174-180``); every orthant comparison goes
    through it.  Only the pseudo-gradient's ``x != 0`` branch uses
    ``sign``, which keeps NaN, as the JAX package uses ``jnp.sign`` there.
    ``sign`` is written out rather than ``torch.sign``, which on some
    builds maps NaN to 0 and -0 to +0.
  * the pseudo-gradient implements Eq. 4 of Andrew & Gao (2007) including
    the subgradient selection at x_i == 0 (``src/orthantwise.rs:82-112``).
  * ``project`` zeroes entries whose sign disagrees with the orthant
    indicator (``src/orthantwise.rs:165-171``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Orthantwise:
    """OWL-QN configuration: minimize F(x) + c * sum_{i in [start,end)} |x_i|.

    Mirrors the reference parameter struct (``src/orthantwise.rs:19-55``):
    ``c`` defaults to 1.0, ``start`` to 0, ``end=None`` means "up to n".
    """

    c: float = 1.0
    start: int = 0
    end: Optional[int] = None

    def start_end(self, n: int) -> tuple[int, int]:
        """Clamp the window to the vector length (``src/orthantwise.rs:59-67``)."""
        end = n if self.end is None else min(self.end, n)
        if not self.start < end:
            raise ValueError(
                f"invalid start for orthantwise: {self.start} (end = {end})"
            )
        return self.start, end

    def window_mask(self, n: int, device=None) -> torch.Tensor:
        """Boolean mask selecting the regularized index window."""
        start, end = self.start_end(n)
        idx = torch.arange(n, device=device)
        return (idx >= start) & (idx < end)


def sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: +/-1, and x itself at +-0 and NaN."""
    one = torch.ones_like(x)
    return torch.where(x > 0.0, one, torch.where(x < 0.0, -one, x))


def signum(x: torch.Tensor) -> torch.Tensor:
    """Mathematical sign: 0 at 0 and NaN, else +/-1 (``src/orthantwise.rs:174-180``)."""
    return torch.where(torch.isnan(x), torch.zeros_like(x), sign(x))


def project(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pi alignment operator: zero x_i where signum(x_i) != signum(y_i)
    (reference ``project``, ``src/orthantwise.rs:165-171``)."""
    return torch.where(signum(x) != signum(y), torch.zeros_like(x), x)


def x1norm(ow: Orthantwise, x: torch.Tensor) -> torch.Tensor:
    """c * sum_{i in window} |x_i| (``src/orthantwise.rs:70-79``), a 0-d
    tensor of x's dtype.  Under the wide objective scalar
    (``ops.fused.wide_fx``) with float32 vectors the sum is two-stage,
    float32 block sums and a float64 total over the masked vector
    (``fused.obj_sum``, as ``lbfgs_tpu/orthantwise.py:71-83``), and the
    result is float64."""
    from .ops import fused

    start, end = ow.start_end(x.shape[0])
    if fused.wide(x.dtype):
        mask = ow.window_mask(x.shape[0], x.device)
        return fused.obj_sum(torch.abs(x) * mask) * ow.c
    return torch.sum(torch.abs(x[start:end])) * ow.c


def pseudo_gradient(ow: Orthantwise, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Pseudo-gradient of F(x) + c|x| per Andrew & Gao Eq. 4.

    Outside the window pg = g; inside, at differentiable points
    pg = g + sign(x)*c; at x_i == 0 pick the one-sided partial derivative
    that allows descent, else 0 (``src/orthantwise.rs:82-112``).
    """
    c = ow.c
    if c < 0:
        raise ValueError(f"invalid orthantwise param c: {c}")
    right = g + c
    left = g - c
    zero = torch.zeros_like(g)
    at_zero = torch.where(right < 0.0, right, torch.where(left > 0.0, left, zero))
    inside = torch.where(x != 0.0, g + sign(x) * c, at_zero)
    return torch.where(ow.window_mask(x.shape[0], x.device), inside, g)


def project_window(v: torch.Tensor, w: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """pi(v; w) inside the window [start, end) only, the window given as
    indices as the kernels take it."""
    idx = torch.arange(v.shape[0], device=v.device)
    kill = (idx >= start) & (idx < end) & (signum(v) != signum(w))
    return torch.where(kill, torch.zeros_like(v), v)


def project_line_point(ow: Orthantwise, x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """Project a trial line-search point onto the chosen orthant ``wp``,
    inside the window only (reference ``constraint_line_search``,
    ``src/orthantwise.rs:118-133``)."""
    return project_window(x, wp, *ow.start_end(x.shape[0]))


def constrain_direction(ow: Orthantwise, d: torch.Tensor, pg: torch.Tensor) -> torch.Tensor:
    """d <- pi(d; -pg) inside the window (reference
    ``constrain_search_direction``, ``src/orthantwise.rs:140-161``); the
    solver carries the reference's non-zero assertion as a status."""
    return project_window(d, -pg, *ow.start_end(d.shape[0]))


def choose_orthant(ow: Orthantwise, xp: torch.Tensor, pg: torch.Tensor) -> torch.Tensor:
    """The orthant indicator of a new point: signum(xp_i), or
    signum(-pg_i) where xp_i == 0 (reference
    ``Problem::update_orthant_new_point``, ``src/core.rs:167-180``, over
    the FULL vector as the reference computes it, not just the window)."""
    return torch.where(xp == 0.0, signum(-pg), signum(xp))
