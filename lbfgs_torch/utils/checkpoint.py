"""Checkpoint and resume for the solver state.

The counterpart of ``lbfgs_tpu/utils/checkpoint.py``: the resumable
``build``/``propagate`` state machine (``src/lbfgs.rs:443-499``) saved as
plain ``.npz``.  This package's ``SolverState`` mixes device tensors with
host scalars (fx, the carried norms, the step and counters) and optional
slots (``xp``/``gp`` of the full state, ``pg`` under OWL-QN, ``pf``,
``probe1``), so each value is stored under its field path (``prob.x``,
``hist.s``, ``probe1.0``, ...) rather than its position, and a slot that
is ``None`` is not stored.  A bfloat16 or float16 tensor is bit-cast to
``uint16``, with its dtype name stored beside it under ``dtype/<path>``.
A sharded checkpoint is not ported: on a mesh both functions raise
``NotImplementedError`` (``parallel.gather_state`` gives the whole state,
which saves outside the mesh).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import SolverState
from ..ops.collective import active_mesh

_NARROW = (torch.bfloat16, torch.float16)


def _refuse_mesh() -> None:
    if active_mesh() is not None:
        raise NotImplementedError("a checkpoint on a mesh (sharded checkpoints are not "
                                  "ported; save parallel.gather_state's whole state)")


def fields(obj, path: str = ""):
    """(field path, value) of every slot of a state, None slots included:
    the keys ``save_state`` writes."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for name in obj._fields:
            yield from fields(getattr(obj, name), f"{path}{name}.")
    elif isinstance(obj, tuple):
        for i, v in enumerate(obj):
            yield from fields(v, f"{path}{i}.")
    else:
        yield path[:-1], obj


def save_state(path: str, state: SolverState) -> None:
    """Write ``state`` to ``path`` (``.npz``)."""
    _refuse_mesh()
    payload = {}
    for key, v in fields(state):
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            if t.dtype in _NARROW:
                payload["dtype/" + key] = np.asarray(str(t.dtype).removeprefix("torch."))
                t = t.view(torch.int16)
            a = t.numpy()
            payload[key] = a.view(np.uint16) if a.dtype == np.int16 else a
        else:
            payload[key] = np.asarray(v)
    np.savez(path, **payload)


def _restore(like, path: str, data):
    """``like`` rebuilt with every slot read from ``data``."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_restore(getattr(like, name), f"{path}{name}.", data)
                            for name in like._fields))
    if isinstance(like, tuple):
        return tuple(_restore(v, f"{path}{i}.", data) for i, v in enumerate(like))
    key = path[:-1]
    if (like is None) != (key not in data.files):
        raise ValueError(
            f"checkpoint slot {key!r} is {'present' if like is None else 'missing'} where "
            "the template's is not: built with a different solver configuration?")
    if like is None:
        return None
    a = data[key]
    if isinstance(like, (torch.Tensor, np.ndarray)):
        count = like.numel() if isinstance(like, torch.Tensor) else like.size
        if a.size != count:
            raise ValueError(
                f"checkpoint slot {key!r} has shape {a.shape} but the template expects "
                f"{tuple(like.shape)} (different element count: m, n or configuration)")
        a = a.reshape(like.shape)
        if not isinstance(like, torch.Tensor):
            return a.astype(like.dtype)
        t = torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)
        if "dtype/" + key in data.files:
            t = t.view(getattr(torch, str(data["dtype/" + key])))
        return t.to(device=like.device, dtype=like.dtype)
    return type(like)(a)


def load_state(path: str, like: SolverState) -> SolverState:
    """Load a checkpoint written by ``save_state`` into the structure of
    ``like``, a fresh state of the same solver configuration
    (``init_state`` or ``LbfgsState.build``).  Each tensor goes to
    ``like``'s device in ``like``'s dtype (a bfloat16 history restores
    into a float32 template), each host scalar takes ``like``'s type.  A
    slot whose element count differs from the template's (m or n
    changed), or that one side has and the other does not, raises
    ``ValueError``."""
    _refuse_mesh()
    with np.load(path) as data:
        return _restore(like, "", data)
