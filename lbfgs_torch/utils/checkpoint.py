"""Checkpoint and resume for the solver state.

The counterpart of ``lbfgs_tpu/utils/checkpoint.py``: the resumable
``build``/``propagate`` state machine (``src/lbfgs.rs:443-499``) saved as
plain numpy files.  This package's ``SolverState`` mixes device tensors
with host scalars (fx, the carried norms, the step and counters) and
optional slots (``xp``/``gp`` of the full state, ``pg`` under OWL-QN,
``pf``, ``probe1``), so each value is stored under its field path
(``prob.x``, ``hist.s``, ``probe1.0``, ...) rather than its position, and
a slot that is ``None`` is not stored.  A bfloat16 or float16 tensor is
bit-cast to ``uint16``, with its dtype name stored beside it.

With no mesh a checkpoint is one ``.npz`` file.  On a mesh
(``ops.collective.kernels_on_mesh``) it is a directory: each rank writes
its own element range of every [n] field and ring row as ``.npy`` pieces
(``<field>.rank<r>.npy``), rank 0 the replicated values (the [m] stacks,
the Gram blocks and the host scalars, ``replicated.npz``) and, once every
piece is in place, ``manifest.json`` (the world size, n and each sharded
field's whole shape and dtype).  Each file is written under a temporary
name and renamed.  A load reads only the element ranges that overlap the
loading rank's shard, at whatever world size it loads under (none, one or
any other that divides n): from the pieces by memory map, from a
single-process ``.npz`` by seeking inside its uncompressed members.  No
rank ever assembles the whole vector or ring (``Mesh.gathers`` stays 0).
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from ..core import SolverState, as_ring
from ..ops.collective import active_mesh, global_length, shard_offset
from ..parallel.sharding import RINGS, VECTORS

_NARROW = (torch.bfloat16, torch.float16)
#: the field paths split over a mesh's ranks on their last (n) axis
RING_KEYS = tuple(f"hist.{f}" for f in RINGS)
SHARDED = tuple(f"prob.{f}" for f in VECTORS) + RING_KEYS
MANIFEST = "manifest.json"
REPLICATED = "replicated.npz"
FORMAT = "lbfgs_torch sharded checkpoint"


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


def _host_array(t: torch.Tensor) -> tuple:
    """(numpy array, narrow dtype name or None) of a tensor: a bfloat16 or
    float16 tensor bit-cast to uint16."""
    t = t.detach().cpu()
    narrow = None
    if t.dtype in _NARROW:
        narrow = str(t.dtype).removeprefix("torch.")
        t = t.view(torch.int16)
    a = t.numpy()
    return (a.view(np.uint16) if a.dtype == np.int16 else a), narrow


def _payload(items) -> dict:
    """The ``.npz`` payload of (key, value) items (None slots left out)."""
    payload = {}
    for key, v in items:
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            payload[key], narrow = _host_array(v)
            if narrow:
                payload["dtype/" + key] = np.asarray(narrow)
        else:
            payload[key] = np.asarray(v)
    return payload


def _replace_into(path: str, write) -> None:
    """``write(file)`` to a temporary file beside ``path``, then rename it
    to ``path``: a reader sees the old file or the whole new one."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def save_state(path: str, state: SolverState) -> None:
    """Write ``state`` to ``path``: with no mesh one ``.npz`` file; on a
    mesh the directory ``path``, each rank its own element range of every
    [n] field and ring row, rank 0 the replicated values and the manifest
    (module docstring).  Every rank of the mesh calls it; it returns once
    the whole checkpoint is written."""
    mesh = active_mesh()
    if mesh is None:
        np.savez(path, **_payload(fields(state)))
        return
    import torch.distributed as dist

    os.makedirs(path, exist_ok=True)
    sharded, replicated = {}, []
    for key, v in fields(state):
        if key in SHARDED and v is not None:
            a, narrow = _host_array(v)
            _replace_into(os.path.join(path, f"{key}.rank{mesh.rank}.npy"),
                          lambda f, a=a: np.save(f, a))
            shape = list(a.shape)
            shape[-1] = global_length(shape[-1])
            sharded[key] = dict(shape=shape, dtype=narrow or str(a.dtype))
        else:
            replicated.append((key, v))
    if mesh.rank == 0:
        payload = _payload(replicated)
        _replace_into(os.path.join(path, REPLICATED), lambda f: np.savez(f, **payload))
    # every piece in place before the manifest names them
    dist.barrier(group=mesh.group)
    if mesh.rank == 0:
        n = global_length(state.prob.x.shape[0])
        manifest = dict(format=FORMAT, world=mesh.size, n=n, sharded=sharded)
        _replace_into(os.path.join(path, MANIFEST),
                      lambda f: f.write(json.dumps(manifest, indent=1).encode()))
    dist.barrier(group=mesh.group)


class _Npz:
    """A single-process checkpoint (``.npz``): whole arrays, and a sharded
    field's element range read by seeking inside its member (``np.savez``
    stores its members uncompressed)."""

    def __init__(self, path: str):
        self.data = np.load(path)
        self.zip = zipfile.ZipFile(path)

    def close(self) -> None:
        self.data.close()
        self.zip.close()

    def has(self, key: str) -> bool:
        return key in self.data.files

    def narrow(self, key: str):
        return str(self.data["dtype/" + key]) if "dtype/" + key in self.data.files else None

    def whole(self, key: str) -> np.ndarray:
        return self.data[key]

    def shape(self, key: str) -> tuple:
        with self.zip.open(key + ".npy") as f:
            return _npy_header(f)[0]

    def range(self, key: str, lo: int, hi: int) -> np.ndarray:
        """Elements [lo, hi) of the last axis of every row of ``key``."""
        with self.zip.open(key + ".npy") as f:
            shape, dtype, start = _npy_header(f)
            n, rows = shape[-1], int(np.prod(shape[:-1], dtype=np.int64))
            out = np.empty((rows, hi - lo), dtype)
            for r in range(rows):
                f.seek(start + (r * n + lo) * dtype.itemsize)
                out[r] = np.frombuffer(f.read((hi - lo) * dtype.itemsize), dtype)
            return out.reshape(*shape[:-1], hi - lo)


def _npy_header(f) -> tuple:
    """(shape, dtype, offset of the data) of an open ``.npy`` stream."""
    version = np.lib.format.read_magic(f)
    read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
            else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read(f)
    if fortran:
        raise ValueError("a Fortran-ordered checkpoint array")
    return shape, dtype, f.tell()


class _Pieces:
    """A sharded checkpoint (a directory): the replicated values whole, a
    sharded field's element range from the pieces that overlap it, each
    read by memory map."""

    def __init__(self, path: str):
        with open(os.path.join(path, MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(f"{path} is not a sharded checkpoint of this package")
        self.path = path
        self.data = np.load(os.path.join(path, REPLICATED))

    def close(self) -> None:
        self.data.close()

    def has(self, key: str) -> bool:
        return key in self.manifest["sharded"] or key in self.data.files

    def narrow(self, key: str):
        if key in self.manifest["sharded"]:
            name = self.manifest["sharded"][key]["dtype"]
            return name if name in ("bfloat16", "float16") else None
        return str(self.data["dtype/" + key]) if "dtype/" + key in self.data.files else None

    def whole(self, key: str) -> np.ndarray:
        return self.data[key]

    def shape(self, key: str) -> tuple:
        return tuple(self.manifest["sharded"][key]["shape"])

    def range(self, key: str, lo: int, hi: int) -> np.ndarray:
        world = self.manifest["world"]
        k = self.manifest["n"] // world
        parts = []
        for r in range(lo // k, -(-hi // k)):
            piece = np.load(os.path.join(self.path, f"{key}.rank{r}.npy"), mmap_mode="r")
            a, b = max(lo, r * k) - r * k, min(hi, (r + 1) * k) - r * k
            parts.append(np.ascontiguousarray(piece[..., a:b]))
        return np.concatenate(parts, axis=-1)


def _tensor(a: np.ndarray, narrow, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a.view(np.int16) if a.dtype == np.uint16 else a))
    if narrow:
        t = t.view(getattr(torch, narrow))
    return t.to(device=like.device, dtype=like.dtype)


def _restore(like, path: str, src):
    """``like`` rebuilt with every slot read from ``src`` (``_Npz`` or
    ``_Pieces``): a sharded field's element range of this rank's shard,
    everything else whole."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_restore(getattr(like, name), f"{path}{name}.", src)
                            for name in like._fields))
    if isinstance(like, tuple):
        return tuple(_restore(v, f"{path}{i}.", src) for i, v in enumerate(like))
    key = path[:-1]
    if (like is None) != (not src.has(key)):
        raise ValueError(
            f"checkpoint slot {key!r} is {'present' if like is None else 'missing'} where "
            "the template's is not: built with a different solver configuration?")
    if like is None:
        return None
    if key in SHARDED and isinstance(like, torch.Tensor):
        n_loc = like.shape[-1]
        want = (*like.shape[:-1], global_length(n_loc))
        if tuple(src.shape(key)) != want:
            raise ValueError(
                f"checkpoint slot {key!r} has shape {tuple(src.shape(key))} but the template "
                f"expects {want} (different element count: m, n or configuration)")
        off = shard_offset(n_loc)
        t = _tensor(src.range(key, off, off + n_loc), src.narrow(key), like)
        # a ring in the padded layout the kernels take (``core.as_ring``)
        return as_ring(t) if key in RING_KEYS else t
    a = src.whole(key)
    if isinstance(like, (torch.Tensor, np.ndarray)):
        count = like.numel() if isinstance(like, torch.Tensor) else like.size
        if a.size != count:
            raise ValueError(
                f"checkpoint slot {key!r} has shape {a.shape} but the template expects "
                f"{tuple(like.shape)} (different element count: m, n or configuration)")
        a = a.reshape(like.shape)
        if not isinstance(like, torch.Tensor):
            return a.astype(like.dtype)
        return _tensor(a, src.narrow(key), like)
    return type(like)(a)


def load_state(path: str, like: SolverState) -> SolverState:
    """Load a checkpoint written by ``save_state`` into the structure of
    ``like``, a fresh state of the same solver configuration
    (``init_state`` or ``LbfgsState.build``; on a mesh its shard).  Either
    format loads with or without a mesh, at any world size that divides n:
    each rank reads the element ranges of its shard only.  Each tensor goes
    to ``like``'s device in ``like``'s dtype (a bfloat16 history restores
    into a float32 template), each host scalar takes ``like``'s type.  A
    slot whose element count differs from the template's (m or n
    changed), or that one side has and the other does not, raises
    ``ValueError``."""
    src = _Pieces(path) if os.path.isdir(path) else _Npz(path)
    try:
        return _restore(like, "", src)
    finally:
        src.close()
