"""Solver state and data carried between this package and ``lbfgs_tpu``.

Extended Rosenbrock has no weights, so the solver state is what a run on
one side must hand the other: ``state_from_jax`` takes a ``lbfgs_tpu``
``SolverState`` whose leaves are numpy arrays (``np.asarray`` of each
leaf) and builds this package's state on a device; ``state_to_numpy`` is
the reverse, and ``batched_state_from_jax`` takes a batched run's state.
The Poisson regression's "weights" are its data:
``logistic_objective`` makes the port's objective from numpy (X, y) on a
device.  None of them imports JAX.

Layouts: the JAX package may store the (s, y) history ring-major,
``[m, n/128, 128]`` (``lbfgs_tpu/core.py:113-129``); here it is always
``[m, n]``.  A bfloat16 history arrives as numpy's ``bfloat16`` extension
dtype and is carried over bit for bit; ``state_to_numpy`` widens it to
float32, which is exact.  With a ``mesh`` (``parallel``) ``state_from_jax``
hands this rank its shard of the JAX state: the weights carried across
into a sharded run.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core import History, ProblemState, SolverState, as_ring


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def state_from_jax(tree: Any, device, mesh=None) -> SolverState:
    """This package's ``SolverState`` from a JAX ``SolverState`` with
    numpy leaves, the OWL-QN pseudo-gradient included.  Host scalars keep
    the vectors' dtype, except fx and the fx ring, which keep their own:
    float64 in a wide (``fx_wide``) state over float32 vectors, and so
    does the combine+probe slot's ft (``probe1``).  With a ``mesh``
    (``parallel.make_mesh``) the state is this rank's shard
    (``parallel.shard_state``), on the mesh's device."""
    if mesh is not None:
        from .parallel import shard_state

        return shard_state(state_from_jax(tree, "cpu"), mesh)
    p, h = tree.prob, tree.hist
    f = np.asarray(p.x).dtype.type
    m = np.asarray(h.s).shape[0]
    vec = lambda a: None if a is None else _tensor(a, device)
    fx = np.asarray(p.fx)
    prob = ProblemState(
        x=vec(p.x), fx=fx.dtype.type(fx), gx=vec(p.gx),
        xp=vec(p.xp), gp=vec(p.gp), pg=vec(p.pg), d=vec(p.d),
        neval=int(np.asarray(p.neval)),
        gnorm2=f(np.asarray(p.gnorm2)), xnorm2=f(np.asarray(p.xnorm2)),
    )
    hist = History(
        s=as_ring(_tensor(np.asarray(h.s).reshape(m, -1), device)),
        y=as_ring(_tensor(np.asarray(h.y).reshape(m, -1), device)),
        ys=vec(h.ys), alpha=vec(h.alpha), sy=vec(h.sy), yy=vec(h.yy),
    )
    scalar = lambda a: None if a is None else f(np.asarray(a))
    return SolverState(
        prob=prob, hist=hist, end=int(np.asarray(tree.end)),
        step=f(np.asarray(tree.step)), step_ls=f(np.asarray(tree.step_ls)),
        k=int(np.asarray(tree.k)), ncall=int(np.asarray(tree.ncall)),
        status=int(np.asarray(tree.status)),
        ls_status=int(np.asarray(tree.ls_status)) if tree.ls_status is not None else 0,
        pf=None if tree.pf is None else np.array(tree.pf),
        dg0=scalar(tree.dg0),
        probe1=_probe1(getattr(tree, "probe1", None), f),
    )


def batched_state_from_jax(tree: Any, device):
    """This package's ``batched.BatchedState`` from the JAX package's
    batched ``SolverState`` (``lbfgs_tpu.batched.minimize_batched(...,
    return_state=True)``) with numpy leaves, each with a leading instance
    axis: the vectors, the [B, m, n] rings (from a ring-major [B, m, n/128,
    128] layout too) and the [B] host scalars, the vectors' dtype kept;
    fx, the past/delta ring pf and the carried probe's ft keep their own
    (float64 in a wide, ``fx_wide``, state over float32 vectors).  The JAX
    state's previous-point slots are dropped: the port's batched state is
    lean.  Under OWL-QN the pseudo-gradients ``pg`` come along, and where
    the JAX state carries the combine+probe slot its [B] (ft, dgt,
    stp_probe)."""
    from .batched import BatchedState

    p, h = tree.prob, tree.hist
    B, m = np.asarray(h.s).shape[:2]
    f = np.asarray(p.x).dtype.type
    vec = lambda a: _tensor(a, device)
    host = lambda a, t=f: np.asarray(a).astype(t)
    return BatchedState(
        x=vec(p.x), gx=vec(p.gx), d=vec(p.d),
        hist=History(s=as_ring(_tensor(np.asarray(h.s).reshape(B, m, -1), device)),
                     y=as_ring(_tensor(np.asarray(h.y).reshape(B, m, -1), device)),
                     ys=vec(h.ys), alpha=vec(h.alpha), sy=vec(h.sy), yy=vec(h.yy)),
        fx=np.array(p.fx), gnorm2=host(p.gnorm2), xnorm2=host(p.xnorm2),
        neval=host(p.neval, np.int64), k=host(tree.k, np.int64), end=host(tree.end, np.int64),
        step=host(tree.step), step_ls=host(tree.step_ls), ncall=host(tree.ncall, np.int64),
        status=host(tree.status, np.int64), ls_status=host(tree.ls_status, np.int64),
        dg0=host(tree.dg0), pf=None if tree.pf is None else np.array(tree.pf),
        pg=None if p.pg is None else vec(p.pg),
        probe1=_probe1(getattr(tree, "probe1", None), f),
    )


def _probe1(slot, f):
    """The combine+probe slot (ft, dgt, stp_probe) on the host, scalars (or
    the batched state's [B] arrays): ft in its own dtype, the others in the
    vectors' (``f``)."""
    if slot is None:
        return None
    ft, dgt, stp = (np.asarray(v) for v in slot)
    return ft.dtype.type(ft), f(dgt), f(stp)


def logistic_objective(X, y, device, prec: float = 0.0):
    """The port's Poisson-regression objective over numpy (X, y), moved to
    ``device`` in their own dtype (``models.logistic.make_objective``); a
    bfloat16 X (numpy's ``bfloat16`` extension dtype) is carried over bit
    for bit."""
    from .models import logistic

    return logistic.make_objective(_tensor(X, device), _tensor(y, device), prec=prec)


def _numpy(t: torch.Tensor | None):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def state_to_numpy(st: SolverState) -> dict:
    """The state as nested dicts of numpy arrays and scalars, with the
    field names of both packages' ``SolverState`` and the history as
    ``[m, n]`` (reshape for a ring-major JAX layout); fx keeps its own
    dtype (float64 under the wide objective scalar)."""
    p, h = st.prob, st.hist
    return {
        "prob": {
            "x": _numpy(p.x), "fx": p.fx, "gx": _numpy(p.gx),
            "xp": _numpy(p.xp), "gp": _numpy(p.gp), "pg": _numpy(p.pg),
            "d": _numpy(p.d),
            "neval": p.neval, "gnorm2": p.gnorm2, "xnorm2": p.xnorm2,
        },
        "hist": {k: _numpy(getattr(h, k)) for k in History._fields},
        "end": st.end, "step": st.step, "step_ls": st.step_ls, "k": st.k,
        "ncall": st.ncall, "status": st.status, "ls_status": st.ls_status,
        "pf": st.pf, "dg0": st.dg0, "probe1": st.probe1,
    }
