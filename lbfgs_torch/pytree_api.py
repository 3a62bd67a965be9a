"""Pytree front end.

The counterpart of ``lbfgs_tpu/pytree_api.py``: the solver optimizes one
flat vector, and users carry parameters as nested dicts, lists and tuples
of tensors.  ``minimize_pytree`` flattens them with
``torch.utils._pytree``, concatenates the leaves into one vector on the
leaves' device (in the leaves' promoted dtype, as ``ravel_pytree`` does),
and wraps a scalar objective ``f(pytree) -> fx`` whose gradient comes from
``torch.autograd``.  Every solver feature applies unchanged (OWL-QN
windows index the flattened vector).

Example::

    params0 = {"w": torch.zeros(4, 4), "b": torch.zeros(4)}
    def loss(p): ...
    report, final_params = minimize_pytree(loss, params0, lbfgs())
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Tuple

import torch
from torch.utils import _pytree

from .core import Report
from .params import Lbfgs, lbfgs as _lbfgs


def ravel_pytree(tree: Any) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """(flat vector, unravel): the leaves concatenated in flattening order,
    and the function that splits a vector back into the leaves' shapes and
    dtypes."""
    leaves, spec = _pytree.tree_flatten(tree)
    if not leaves:
        raise ValueError("the pytree has no leaves")
    dtype = functools.reduce(torch.promote_types, (l.dtype for l in leaves))
    shapes = [l.shape for l in leaves]
    dtypes = [l.dtype for l in leaves]
    sizes = [l.numel() for l in leaves]
    flat = torch.cat([l.reshape(-1).to(dtype) for l in leaves])

    def unravel(x: torch.Tensor) -> Any:
        parts = torch.split(x, sizes)
        return _pytree.tree_unflatten(
            [p.reshape(s).to(d) for p, s, d in zip(parts, shapes, dtypes)], spec)

    return flat, unravel


def minimize_pytree(
    fun: Callable[[Any], Any],
    x0_pytree: Any,
    optimizer: Lbfgs | None = None,
    progress: Callable | None = None,
    jit_driver: bool = False,
) -> Tuple[Report, Any]:
    """Minimize a scalar function of a pytree; returns (Report, pytree).

    ``optimizer`` is a configured ``lbfgs()`` builder (defaults if
    omitted).  ``jit_driver=True`` takes the whole-run loop
    (``minimize_jit``), which has no progress callback."""
    opt = optimizer or _lbfgs()
    flat0, unravel = ravel_pytree(x0_pytree)

    def vag(x: torch.Tensor):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            fx = fun(unravel(xg))
            (g,) = torch.autograd.grad(fx, xg)
        return fx.detach(), g

    vag.__lbfgs_value_and_grad__ = True
    if jit_driver:
        report = opt.minimize_jit(flat0, vag)
    else:
        report = opt.minimize(flat0, vag, progress)
    return report, unravel(report.x)
