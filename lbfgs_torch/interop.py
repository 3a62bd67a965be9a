"""Solver state and data carried between this package and ``lbfgs_tpu``.

Extended Rosenbrock has no weights, so the solver state is what a run on
one side must hand the other: ``state_from_jax`` takes a ``lbfgs_tpu``
``SolverState`` whose leaves are numpy arrays (``np.asarray`` of each
leaf) and builds this package's state on a device; ``state_to_numpy`` is
the reverse.  The Poisson regression's "weights" are its data:
``logistic_objective`` makes the port's objective from numpy (X, y) on a
device.  None of them imports JAX.

Layouts: the JAX package may store the (s, y) history ring-major,
``[m, n/128, 128]`` (``lbfgs_tpu/core.py:113-129``); here it is always
``[m, n]``.  A bfloat16 history arrives as numpy's ``bfloat16`` extension
dtype and is carried over bit for bit; ``state_to_numpy`` widens it to
float32, which is exact.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core import History, ProblemState, SolverState


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def state_from_jax(tree: Any, device) -> SolverState:
    """This package's ``SolverState`` from a JAX ``SolverState`` with
    numpy leaves, the OWL-QN pseudo-gradient included.  Host scalars keep
    the vectors' dtype, except fx and the fx ring, which keep their own:
    float64 in a wide (``fx_wide``) state over float32 vectors.  The
    speculative-probe slots are not carried (unported)."""
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
        s=_tensor(np.asarray(h.s).reshape(m, -1), device),
        y=_tensor(np.asarray(h.y).reshape(m, -1), device),
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
    )


def logistic_objective(X, y, device, prec: float = 0.0):
    """The port's Poisson-regression objective over numpy (X, y), moved to
    ``device`` in their own dtype (``models.logistic.make_objective``)."""
    from .models import logistic

    return logistic.make_objective(torch.from_numpy(np.array(X)).to(device),
                                   torch.from_numpy(np.array(y)).to(device), prec=prec)


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
        "pf": st.pf, "dg0": st.dg0,
    }
