"""Extended Rosenbrock objective (the reference's default/benchmark problem).

Per-pair form with a = 1, b = 10 (squared inside), matching the reference
``default_evaluate`` (``src/lib.rs:79-94``):

    for even i:  t1 = 1 - x_i;  t2 = 10*(x_{i+1} - x_i^2)
                 g_{i+1} = 20*t2;  g_i = -2*(x_i*g_{i+1} + t1)
                 fx += t1^2 + t2^2

``value_and_grad`` carries the fused-kernel protocol generated by
``ops.factory.make_fused_objective`` from the per-block Triton body
``_rosenbrock_block.rosen_block``; ``_plain_value_and_grad`` is the plain
torch evaluation, which the kernels' plain versions use (on a mesh their
dispatchers sum its partials over the ranks, so it never reduces on its
own).  ``generic_value_and_grad`` is the generic form, with no kernel hooks,
that keeps the mesh's local contract (``ops.collective.local_objective``):
the pair view of this rank's shard, and fx summed over the ranks.
"""

from __future__ import annotations

import torch

from ..ops import factory, fused
from ..ops.collective import local_objective, mesh_sum


def _plain_value_and_grad(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fx and the gradient on the pair view [n/2, 2] of x; fx through
    ``fused.obj_sum``, so the wide objective scalar sums it in float64."""
    _check_even(x.shape[0])
    pairs = x.view(-1, 2)
    xe, xo = pairs[:, 0], pairs[:, 1]
    t1 = 1.0 - xe
    t2 = 10.0 * (xo - xe * xe)
    go = 20.0 * t2
    ge = -2.0 * (xe * go + t1)
    fx = fused.obj_sum(t1 * t1 + t2 * t2)
    return fx, torch.stack([ge, go], dim=1).reshape(-1)


@local_objective
def generic_value_and_grad(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Extended Rosenbrock as a generic objective (the JAX package's jnp
    ``value_and_grad``, ``lbfgs_tpu/models/rosenbrock.py:31-55``) under the
    local contract: on a mesh x is this rank's shard, the pairs (x_i,
    x_{i+1}) start at even i, so a shard of even length holds whole pairs,
    and fx is the shards' sums added over the ranks in one collective, in
    the objective scalar's dtype (float64 under ``params.fx_wide``); the
    gradient is the shard's.  With no mesh it is ``_plain_value_and_grad``
    bit for bit.  A shard of odd length raises ``ValueError``, as an odd n
    does (``_check_even``)."""
    fx, g = _plain_value_and_grad(x)
    (fx,) = mesh_sum(fx)
    return fx, g


def _check_even(n: int) -> None:
    if n % 2:
        # the pair form is defined for even n only; the reference panics on
        # odd n (index out of bounds in the pair loop): fail loudly too
        raise ValueError(f"extended Rosenbrock requires even n, got {n}")


def _rosen_block():
    """Loader of the per-block Triton body (imports triton)."""
    from ._rosenbrock_block import rosen_block

    return rosen_block


value_and_grad = factory.make_fused_objective(
    _rosen_block, _plain_value_and_grad, row=2, validate=_check_even
)

_k = value_and_grad.kernels
trial = _k.trial
trial_ref = _k.trial_ref
probe = _k.probe
probe_ref = _k.probe_ref
trial_pair_gram = _k.trial_pair_gram
trial_pair_gram_ref = _k.trial_pair_gram_ref
trial_pair_gram_ok = _k.trial_pair_gram_ok
owlqn_trial = _k.owlqn_trial
owlqn_trial_ref = _k.owlqn_trial_ref
owlqn_probe = _k.owlqn_probe
owlqn_probe_ref = _k.owlqn_probe_ref
owlqn_probe_pg = _k.owlqn_probe_pg
owlqn_probe_pg_ref = _k.owlqn_probe_pg_ref
owlqn_trial_pair_gram = _k.owlqn_trial_pair_gram
owlqn_trial_pair_gram_ref = _k.owlqn_trial_pair_gram_ref
combine_probe = _k.combine_probe
combine_probe_ref = _k.combine_probe_ref
combine_probe_ok = _k.combine_probe_ok
combine_ow_probe = _k.combine_ow_probe
combine_ow_probe_ref = _k.combine_ow_probe_ref


def initial_point(n: int, dtype=torch.float64, device="cuda") -> torch.Tensor:
    """x0 alternating (-1.2, 1.0) (``examples/sample.rs:13-17``), on the
    card unless ``device`` names another."""
    _check_even(n)
    x = torch.empty((n,), dtype=dtype, device=device)
    x[0::2] = -1.2
    x[1::2] = 1.0
    return x
