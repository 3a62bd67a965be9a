"""The CUDA C++ kernels (K3, K5, K6, K9-K13) and what the fused kernels
share.

  * ``combine`` (K3) — r = gamma*d + coef_s @ S + coef_y @ Y with ||r||^2
    and r . d from one pass (the compact two-loop's output direction).
  * ``combine_fix`` (K6) — the same pass, which also persists the damped
    ring row Y[end] <- ca*Y[end] + cb*d in place.
  * ``combine_ow`` (K13) — the same pass with OWL-QN's direction
    constraint rc = pi(r; -pg) inside the window, returning ||r||^2
    before the constraint, ||rc||^2 and rc . pg.
  * ``pair_gram_sd`` (K5) — the correction pair (stp*d, gx - gp) written
    into ring row ``end`` and all 6m Gram products (8m with the damped
    update's . gp column), for fused-trial objectives that have no
    one-pass epilogue.
  * ``pair_gram_xg`` (K12) — the same for OWL-QN's composed branch
    (generic objectives): the pair (x - xp, gx - gp) of the projected
    step and the products against d0 = -pg.
  * ``owlqn_trial_step`` (K9) — the projected trial point pi(xp + stp*d;
    wp) inside the window, for the composed OWL-QN search.
  * ``pseudo_gradient`` (K11) and ``pseudo_gradient_norm`` (K10) —
    OWL-QN's pseudo-gradient, alone and with its squared norm.

  * ``combine_batched`` (K3 b), ``combine_ow_batched`` (K13 b),
    ``combine_fix_batched`` (K6 b) and ``pseudo_gradient_norm_batched``
    (K10 b) — K3, K13, K6 and K10 over a [B, n] batch of instances (one
    coefficient row each), the batched runner's combines and its OWL-QN
    init.
  * ``pseudo_gradient_batched`` (K11 b), ``owlqn_trial_step_batched``
    (K9 b) and ``pair_gram_xg_batched`` (K12 b) — K11, K9 and K12 over a
    batch: the batched runner's OWL-QN kernels for generic objectives (the
    init's pseudo-gradient, each trial point, each iteration's pair
    update); K12 b also runs for an OWL-QN objective with a fused trial
    but no one-pass epilogue.
  * ``pair_gram_sd_batched`` (K5 b) — K5 over a batch (with the . gp
    column when damped): the pair + Gram pass of a plain objective with a
    fused trial but no one-pass epilogue.

  * ``axpy_dot`` (K17) — z = y + c*x and z . w in one pass.  No solver
    path runs it (the compact two-loop takes its products from the
    epilogues), as in the JAX package.

  On a CUDA tensor each launches its hand-written kernel
  (``csrc/combine.cu``, ``csrc/pair_gram.cu``, ``csrc/owlqn.cu``,
  ``csrc/axpy_dot.cu``); on a CPU tensor it runs its plain version
  (``*_ref``).

  * ``reduce_partials`` (R, ``csrc/partials.cu``) — the fixed-order
    cross-block sum that every kernel of the package uses: each kernel
    program writes its own partial sums, and this adds them, so no float
    atomics touch the trajectory and runs repeat bit for bit.  "Fixed
    order" means fixed by the row count alone: a column's sum does not
    depend on the array's width, on the batch or on the lanes around it,
    so the solo, batched and K-lane forms of a kernel agree bit for bit
    wherever their programs' partials do (``reduce_partials_order_ref``
    writes the order in torch ops).  On a CPU tensor it is torch's sum.
  * the wide objective scalar (``wide_fx``, ``params.fx_wide``):
    ``obj_reduce`` and ``obj_sum`` take the objective's sums in float64
    over float32 vectors.
  * ``pair_products`` — the 6m (8m) products of the one-pass epilogues'
    and K5's and K12's plain versions, with row ``end`` taken from the
    unrounded pair as the kernels hold it in registers.
  * ``pair_gram_ref`` — the composed pair update whose products see the
    STORED pair (the damped composed branch, and generic objectives);
    ``pair_gram_stored_batched`` the same over a batch.
  * ``pair_products_batched`` — ``pair_products`` over a batch, shared by
    the batched epilogues' and K12 b's plain versions.
  * the predicates ``can_combine`` / ``can_pair_gram`` and the dtype
    rules all kernels follow.

On a mesh (``kernels_on_mesh``, ``collective``) every wrapper here and in
``factory`` runs its kernel, or its plain version, on this rank's shard:
the vectors and ring rows it writes are those of the single-process
launch on the same elements, bit for bit, and its scalars are the
shards' fixed-order sums added across the ranks by one all-reduce per
launch (``collective.mesh_sum``), as the JAX dispatchers psum them under
``shard_map``.  The OWL-QN window is always the global one: a kernel
launch takes it translated into the shard's indices
(``kernel_window``), and the plain versions index by global position
(``orthantwise.project_window``, ``Orthantwise.window_mask``).

Dtypes: vectors are float32 or float64; the history is bfloat16 or
float32 with float32 vectors, float64 with float64 vectors.  Partial sums
accumulate in the vectors' dtype.  Any other combination raises (the
solver runs another history dtype, e.g. float16, through
``pair_gram_ref`` and ``combine_plain`` instead, as the JAX package runs
it through jnp).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from . import _build
from .collective import (active_mesh, global_length, kernels_on_mesh, local_window,
                         mesh_sum, shard_offset)
from .. import orthantwise as ow_ops
from ..core import RING_ALIGN, ring_stride
from ..orthantwise import Orthantwise, project_window

#: (vector dtype, history dtype) pairs the kernels take
SUPPORTED = {
    (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32),
    (torch.float64, torch.float64),
}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}

def check_dtypes(vec_dtype: torch.dtype, hist_dtype: torch.dtype | None = None) -> None:
    if vec_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vectors must be float32 or float64, got {vec_dtype}")
    if hist_dtype is not None and (vec_dtype, hist_dtype) not in SUPPORTED:
        raise TypeError(
            f"history dtype {hist_dtype} is not supported with {vec_dtype} vectors"
        )


def on_cuda(t: torch.Tensor, kernel: str) -> bool:
    """Dispatch rule of every kernel wrapper: True for a CUDA tensor (the
    kernel launches), False for a CPU tensor (the plain version runs);
    any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{kernel}: no kernel for device {t.device}")


def check_contiguous(kernel: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")


def ring_ld(kernel: str, S: torch.Tensor, Y: torch.Tensor) -> int:
    """The row stride ld (in elements) of the rings S and Y ([m, n], or a
    batch's [B, m, n]) that a kernel takes: each row contiguous, ld n or
    ``ring_stride(n)`` (``core.ring_zeros``' padded layout, whose pads are
    zero), S and Y alike, and a batch's instances m*ld apart.  A padded
    ring's storage holds every row's pad, the last row's too: the
    tensor-core epilogues load the ring over [0, ld) and store row end's
    pad as zeros, so a wider view of some other buffer is refused."""
    n, ld = S.shape[-1], S.stride(-2)
    rows = S.numel() // max(n, 1)
    held = all((R.storage_offset() + rows * ld) * R.element_size()
               <= R.untyped_storage().nbytes() for R in (S, Y))
    ok = (S.stride() == Y.stride() and S.stride(-1) == 1
          and (ld == n or (ld == ring_stride(n) and held))
          and (S.ndim == 2 or S.stride(0) == S.shape[1] * ld))
    if not ok:
        raise ValueError(f"{kernel}: ring rows must be contiguous, with a row stride of n or "
                         f"{ring_stride(n)} (n rounded up to a multiple of {RING_ALIGN}; got "
                         f"strides {S.stride()}, {Y.stride()} at n = {n})")
    return ld


def to_device(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A small host tensor on like's device without a synchronisation: to
    a card through a pinned staging copy and an asynchronous transfer (a
    copy from pageable memory waits for the card to drain), elsewhere as
    it is."""
    if like.device.type != "cuda":
        return host.to(like.device)
    return host.pin_memory().to(like.device, non_blocking=True)


#: lanes of R's order of addition (``csrc/partials.cu``, kLanes)
PARTIAL_LANES = 1024
#: R takes its two-launch form (``csrc/partials.cu``) from
#: ``PARTIAL_TILE_COLS`` columns, more than ``PARTIAL_LANES`` rows and
#: ``PARTIAL_TILE_ELEMS`` values an instance (kTileCols, kTileMinElems)
PARTIAL_TILE_COLS, PARTIAL_TILE_ELEMS = 32, 1 << 18


def partials_scratch(B: int, P: int, C: int) -> int:
    """Elements of the scratch R's two-launch form needs for B instances of
    [P, C] partials (``lbfgs_partials_scratch``): the [B, PARTIAL_LANES,
    C] lane sums, or none in the one-launch forms."""
    two = C >= PARTIAL_TILE_COLS and P > PARTIAL_LANES and P * C >= PARTIAL_TILE_ELEMS
    return B * PARTIAL_LANES * C if two else 0

_PARTIALS = {(torch.float32, False): "f32", (torch.float32, True): "f32_wide",
             (torch.float64, False): "f64", (torch.float64, True): "f64"}


def _partials_view(partials: torch.Tensor, dim: int) -> tuple:
    """(B, P, C, strides in elements, the output's shape) of a partials
    array summed over its axis ``dim``: [P] or [P, C] with dim = 0, a
    batch's [B, P] or [B, P, C] with dim = 1."""
    shape, st = list(partials.shape), list(partials.stride())
    if dim == 0 and partials.ndim in (1, 2):
        shape, st = [1] + shape, [0] + st
    elif not (dim == 1 and partials.ndim in (2, 3)):
        raise ValueError(f"reduce_partials: cannot sum a {partials.ndim}-d array over axis {dim}")
    if len(shape) == 2:
        shape, st = shape + [1], st + [0]
    out = tuple(partials.shape[:dim]) + tuple(partials.shape[dim + 1:])
    return (*shape, *st, out)


def reduce_partials_ref(partials: torch.Tensor, dim: int = 0,
                        wide: bool = False) -> torch.Tensor:
    """Plain version of ``reduce_partials``: torch's sum over axis ``dim``
    (in float64 with ``wide``)."""
    return (partials.to(torch.float64) if wide else partials).sum(dim=dim)


def reduce_partials_order_ref(partials: torch.Tensor, dim: int = 0,
                              wide: bool = False) -> torch.Tensor:
    """R's order of addition in torch ops, for checks: with L =
    min(``PARTIAL_LANES``, P rounded up to a power of two) lanes, lane l
    adds rows l, l + PARTIAL_LANES, ... in turn from +0, then lane l takes
    lane l + h for h = L/2, ..., 1.  Every add is one rounded IEEE add, so
    on any device this gives R's bits."""
    x = (partials.to(torch.float64) if wide else partials).movedim(dim, 0)
    P = x.shape[0]
    lanes = 1
    while lanes < min(P, PARTIAL_LANES):
        lanes *= 2
    acc = x.new_zeros((lanes,) + tuple(x.shape[1:]))
    for r0 in range(0, P, PARTIAL_LANES):
        rows = x[r0:r0 + PARTIAL_LANES]
        acc[:rows.shape[0]] = acc[:rows.shape[0]] + rows
    while lanes > 1:
        lanes //= 2
        acc = acc[:lanes] + acc[lanes:2 * lanes]
    return acc[0]


def reduce_partials(partials: torch.Tensor, dim: int = 0, wide: bool = False) -> torch.Tensor:
    """R: the sums of a kernel's partials over its programs, axis ``dim``
    ([P] or [P, C] with dim = 0; a batched kernel's [B, P] or [B, P, C]
    per instance with dim = 1), each column in the order its row count P
    fixes (``reduce_partials_order_ref``), whatever the width, the batch
    or the strides.  With ``wide`` float32 partials are added in float64
    (``obj_reduce``).  On a CPU tensor the plain version, torch's sum."""
    if not on_cuda(partials, "reduce_partials"):
        return reduce_partials_ref(partials, dim, wide)
    sfx = _PARTIALS.get((partials.dtype, bool(wide)))
    if sfx is None:
        raise TypeError(f"reduce_partials: no kernel for {partials.dtype} partials")
    B, P, C, sB, sP, sC, shape = _partials_view(partials, dim)
    lib = _build.load_library()
    dtype = torch.float64 if wide else partials.dtype
    out = torch.empty(shape, device=partials.device, dtype=dtype)
    need = partials_scratch(B, P, C)
    scratch = torch.empty(need, device=partials.device, dtype=dtype) if need else None
    code = getattr(lib, f"lbfgs_partials_{sfx}")(
        partials.data_ptr(), out.data_ptr(), B, P, C, sB, sP, sC,
        None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(partials.device).cuda_stream)
    _build.check_launch(code, "reduce_partials")
    reduce_partials.launches += 1
    return out


reduce_partials.launches = 0


# ---------------------------------------------------------------------------
# The wide objective scalar (params.fx_wide)
# ---------------------------------------------------------------------------
#
# float32 vectors cap the objective scalar at ~7 digits: at the n = 1e8
# OWL-QN scale the L1 term holds fx near 4e7, which float32 resolves only
# to 4, coarser than the Armijo test's decrease can be.  Under ``wide_fx``
# every vector stays float32, but the objective's per-program float32
# partials are summed in float64 outside the kernel, and fx and the
# line search's f-values carry as float64 on the host.  The solver enters
# ``wide_fx(params.fx_wide)`` around its work; the kernel wrappers and
# ``obj_sum`` read it.  Float64 vectors carry fx in float64 already, so the
# mode changes nothing for them, bit for bit.

_WIDE_FX: list = []


class wide_fx:
    """Context manager: objective scalars of float32 runs reduce and carry
    in float64 inside."""

    def __init__(self, enabled: bool = True):
        self._enabled = bool(enabled)

    def __enter__(self):
        _WIDE_FX.append(self._enabled)
        return self

    def __exit__(self, *exc):
        _WIDE_FX.pop()
        return False


def wide(vdtype: torch.dtype) -> bool:
    """Whether objective scalars of ``vdtype`` vectors take the wide form:
    under ``wide_fx`` with float32 vectors."""
    return vdtype == torch.float32 and bool(_WIDE_FX and _WIDE_FX[-1])


def obj_dtype(vdtype: torch.dtype) -> torch.dtype:
    """The dtype objective scalars carry in."""
    return torch.float64 if wide(vdtype) else vdtype


def obj_reduce(parts: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Column sums of a [programs, k] array of objective partials (or the
    sum of a [programs] one) in float64: the wide form of
    ``reduce_partials`` for the objective's columns.  A batched kernel's
    [B, programs, k] (or [B, programs]) partials are summed per instance
    over their programs, ``dim=1``."""
    return reduce_partials(parts, dim, wide=True)


#: elements per float32 partial in ``obj_sum``'s wide form
OBJ_SUM_BLOCK = 2048


def obj_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum of an objective's terms outside the kernels (the plain
    versions and generic objectives).  Under the wide mode it is two-stage
    as the kernels are, float32 sums over blocks of ``OBJ_SUM_BLOCK``
    elements and a float64 total (``lbfgs_tpu/ops/fused.py:299-313``);
    the kernels' blocks hold 1024 elements, so the two forms differ in the
    last bits of the blocks' float32 sums.  Otherwise one plain sum.  Both
    stages are torch's on every device: it runs under ``torch.func``
    transforms (a batch of generic objectives), where no kernel can."""
    if not wide(v.dtype):
        return torch.sum(v)
    pad = (-v.shape[0]) % OBJ_SUM_BLOCK
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    return reduce_partials_ref(v.reshape(-1, OBJ_SUM_BLOCK).sum(dim=1), wide=True)


def l1_batched(x: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """Each instance's sum |x| over the OWL-QN window [start, end) of a
    [B, n] batch: under the wide mode ``orthantwise.x1sum``'s two-stage
    float64 sum per instance (the solo sum of each row), else one sum per
    row in the vectors' dtype."""
    if wide(x.dtype):
        ow = Orthantwise(1.0, start, end)
        return torch.func.vmap(lambda v: ow_ops.x1sum(ow, v))(x)
    return torch.abs(x[:, start:end]).sum(dim=1)


def obj_lift(fx: torch.Tensor, vdtype: torch.dtype) -> torch.Tensor:
    """An objective value in the dtype objective scalars carry in (a
    no-op when the objective's own ``obj_sum`` made it wide already)."""
    return fx.to(obj_dtype(vdtype))


def _check_hist(d: torch.Tensor, S: torch.Tensor, Y: torch.Tensor) -> None:
    check_dtypes(d.dtype, S.dtype)
    if d.ndim != 1 or S.ndim != 2 or S.shape != Y.shape or S.shape[1] != d.shape[0]:
        raise ValueError(
            f"expected d [n] and S, Y [m, n]; got {tuple(d.shape)}, "
            f"{tuple(S.shape)}, {tuple(Y.shape)}"
        )
    if Y.dtype != S.dtype:
        raise TypeError("S and Y must share a dtype")


def can_combine(d: torch.Tensor, S: torch.Tensor) -> bool:
    """Whether ``combine`` takes these operands (shape and dtype rules; any
    history depth m >= 1)."""
    return (
        d.ndim == 1
        and S.ndim == 2
        and S.shape[1] == d.shape[0]
        and S.shape[0] >= 1
        and (d.dtype, S.dtype) in SUPPORTED
    )


can_pair_gram = can_combine


# ---------------------------------------------------------------------------
# K3: direction combine
# ---------------------------------------------------------------------------


def _combination(d, S, Y, gamma, coef_s, coef_y):
    return gamma * d + (coef_s @ S.to(d.dtype) + coef_y @ Y.to(d.dtype))


def combine_plain(d, S, Y, gamma, coef_s, coef_y):
    """(r, r.r, r.d) in plain torch, uncounted: the arithmetic of
    ``combine_ref``, which the combine+probe fusion's plain version
    (``factory``) shares."""
    r = _combination(d, S, Y, gamma, coef_s, coef_y)
    return r, torch.dot(r, r), torch.dot(r, d)


def combine_ref(d, S, Y, gamma, coef_s, coef_y):
    """Plain version of ``combine``: (r, r.r, r.d)."""
    combine_ref.calls += 1
    return summed(combine_plain(d, S, Y, gamma, coef_s, coef_y))


def summed(out: tuple) -> tuple:
    """A plain form's (vector, *sums) with the sums added over the mesh in
    one collective (as they are with no mesh)."""
    return (out[0], *mesh_sum(*out[1:]))


combine_ref.calls = 0


def coef_vector(d, *coefs) -> torch.Tensor:
    """The combine kernels' coefficients [gamma, cs_0 .., cy_0 .., ...] as
    one tensor of d's dtype on its device (no host read)."""
    return torch.cat([torch.as_tensor(c, dtype=d.dtype, device=d.device).reshape(-1)
                      for c in coefs])


def _launch_combine(name, d, S, Y, coefs, nparts, *args):
    """Launch the combine kernel ``name`` (K3; K6 with ``coefs`` ending in
    (ca, cb) and ``args`` = (end,); K13 with ``args`` = (lo, hi)); returns
    (r, column sums of its [blocks, nparts] partials)."""
    m, n = S.shape
    check_contiguous(name, d)
    ld = ring_ld(name, S, Y)
    lib = _build.load_library()
    coef = coef_vector(d, *coefs)
    blocks = -(-n // lib.lbfgs_combine_block_elems())
    r = torch.empty_like(d)
    part = torch.empty((blocks, nparts), dtype=d.dtype, device=d.device)
    fn = getattr(lib, f"lbfgs_{name}_{_SUFFIX[d.dtype]}_{_SUFFIX[S.dtype]}")
    code = fn(d.data_ptr(), S.data_ptr(), Y.data_ptr(), coef.data_ptr(),
              r.data_ptr(), part.data_ptr(), n, ld, m, *args,
              torch.cuda.current_stream(d.device).cuda_stream)
    _build.check_launch(code, name)
    return r, reduce_partials(part)


def combine(d, S, Y, gamma, coef_s, coef_y):
    """r = gamma*d + coef_s @ S + coef_y @ Y, with r.r and r.d.

    ``gamma`` (0-d) and ``coef_s``/``coef_y`` ([m]) are tensors on d's
    device, so the launch needs no host read.  With the two-loop's sign
    folded in (d = +g, gamma_eff = -gamma) the third value is the next
    line search's dginit = d_new . g.
    """
    _check_hist(d, S, Y)
    if not on_cuda(d, "combine"):
        return combine_ref(d, S, Y, gamma, coef_s, coef_y)
    r, tot = _launch_combine("combine", d, S, Y, (gamma, coef_s, coef_y), 2)
    combine.launches += 1
    return (r, *mesh_sum(tot[0], tot[1]))


combine.launches = 0


# ---------------------------------------------------------------------------
# K3 b: the batched runner's combine
# ---------------------------------------------------------------------------

#: most instances a batched kernel takes: the grid's second axis (CUDA's
#: gridDim.y and Triton's axis 1) holds the instance
MAX_BATCH = 65535


def check_batch(kernel: str, x: torch.Tensor, live: torch.Tensor) -> int:
    """Check a batched kernel's [B, n] vectors and its [B] mask of live
    instances; returns B."""
    check_dtypes(x.dtype)
    if x.ndim != 2:
        raise ValueError(f"{kernel}: expected [B, n] vectors, got shape {tuple(x.shape)}")
    B = x.shape[0]
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"{kernel}: B={B} outside [1, {MAX_BATCH}]")
    if live.shape != (B,) or live.dtype != torch.bool or live.device != x.device:
        raise ValueError(f"{kernel}: live must be a [{B}] bool tensor on {x.device}, got "
                         f"{live.dtype} {tuple(live.shape)} on {live.device}")
    return B


def _check_hist_batched(kernel: str, g, S, Y) -> None:
    check_dtypes(g.dtype, S.dtype)
    B, n = g.shape
    if S.ndim != 3 or S.shape[0] != B or S.shape[2] != n or S.shape != Y.shape:
        raise ValueError(f"{kernel}: expected [B, n] vectors and [B, m, n] rings; got "
                         f"{tuple(g.shape)}, {tuple(S.shape)}, {tuple(Y.shape)}")
    if Y.dtype != S.dtype:
        raise TypeError("S and Y must share a dtype")


def _combination_batched(g, S, Y, coef):
    m = S.shape[1]
    gamma, cs, cy = coef[:, :1], coef[:, None, 1:1 + m], coef[:, None, 1 + m:]
    return gamma * g + (torch.bmm(cs, S.to(g.dtype))[:, 0] + torch.bmm(cy, Y.to(g.dtype))[:, 0])


def combine_plain_batched(g, S, Y, coef, live, out):
    """``combine_batched``'s function in plain torch, uncounted: the
    arithmetic of its plain version, and the batched runner's composed
    combine over a ring the kernels do not take (float16), as the JAX
    package runs jnp there."""
    r = _combination_batched(g, S, Y, coef)
    out[live] = r[live]
    return (r * r).sum(dim=1), (r * g).sum(dim=1)


def combine_batched_ref(g, S, Y, coef, live, out):
    """Plain version of ``combine_batched``."""
    combine_batched_ref.calls += 1
    return combine_plain_batched(g, S, Y, coef, live, out)


combine_batched_ref.calls = 0


def _check_combine_batched(kernel: str, g, S, Y, coef, live, out, fix: bool = False) -> None:
    """Check a batched combine's operands: ``coef`` [B, 2m + 1], or with
    ``fix`` (the damped row's (ca, cb) appended) [B, 2m + 3]."""
    check_batch(kernel, g, live)
    _check_hist_batched(kernel, g, S, Y)
    B, m, n = S.shape
    ncoef = 2 * m + (3 if fix else 1)
    if coef.shape != (B, ncoef) or coef.dtype != g.dtype or out.shape != g.shape \
            or out.dtype != g.dtype:
        raise ValueError(f"{kernel}: coef must be [B, {ncoef - 2 * m} + 2m] and out [B, n], "
                         f"in g's dtype")


def _launch_combine_batched(name: str, g, S, Y, coef, live, out, nparts: int, *args):
    """Launch K3 b (``name`` "combine_batched"), K13 b ("combine_ow_batched",
    with the window (lo, hi)) or K6 b ("combine_fix_batched", with the ring
    row end); returns the [B, nparts] column sums of its [B, blocks,
    nparts] partials, each instance's in the order its solo launch's
    would be added."""
    check_contiguous(name, g, coef, live, out)
    ld = ring_ld(name, S, Y)
    B, m, n = S.shape
    lib = _build.load_library()
    blocks = -(-n // lib.lbfgs_combine_block_elems())
    part = torch.empty((B, blocks, nparts), dtype=g.dtype, device=g.device)
    fn = getattr(lib, f"lbfgs_{name}_{_SUFFIX[g.dtype]}_{_SUFFIX[S.dtype]}")
    code = fn(g.data_ptr(), S.data_ptr(), Y.data_ptr(), coef.data_ptr(), live.data_ptr(),
              out.data_ptr(), part.data_ptr(), n, ld, m, *args, B,
              torch.cuda.current_stream(g.device).cuda_stream)
    _build.check_launch(code, name)
    return reduce_partials(part, dim=1)


def combine_batched(g, S, Y, coef, live, out):
    """K3 over B instances (K3 b): for each live instance b, out[b] =
    coef[b, 0]*g[b] + coef[b, 1:m+1] @ S[b] + coef[b, m+1:] @ Y[b], and
    the [B] sums r.r and r.g.  ``g``, ``out`` [B, n]; ``S``, ``Y`` [B, m,
    n]; ``coef`` [B, 2m + 1] in g's dtype; ``live`` [B] bool, all on one
    device.  A frozen instance's row of ``out`` is never written, and its
    sums are undefined.  On the card an instance's r equals ``combine``'s
    on that instance alone bit for bit.  Returns (r.r, r.g)."""
    _check_combine_batched("combine_batched", g, S, Y, coef, live, out)
    if not on_cuda(g, "combine_batched"):
        return combine_batched_ref(g, S, Y, coef, live, out)
    tot = _launch_combine_batched("combine_batched", g, S, Y, coef, live, out, 2)
    combine_batched.launches += 1
    return tot[:, 0], tot[:, 1]


combine_batched.launches = 0


# ---------------------------------------------------------------------------
# K13 b: the batched runner's OWL-QN combine
# ---------------------------------------------------------------------------


def combine_ow_plain_batched(pg, S, Y, coef, live, out, start: int, end: int):
    """``combine_ow_batched``'s function in plain torch, uncounted (its plain
    version's arithmetic; the composed OWL-QN combine of a float16 ring)."""
    r = _combination_batched(pg, S, Y, coef)
    rc = project_window(r, -pg, start, end)
    out[live] = rc[live]
    return (r * r).sum(dim=1), (rc * rc).sum(dim=1), (rc * pg).sum(dim=1)


def combine_ow_batched_ref(pg, S, Y, coef, live, out, start: int, end: int):
    """Plain version of ``combine_ow_batched``."""
    combine_ow_batched_ref.calls += 1
    return combine_ow_plain_batched(pg, S, Y, coef, live, out, start, end)


combine_ow_batched_ref.calls = 0


def combine_ow_batched(pg, S, Y, coef, live, out, start: int, end: int):
    """K13 over B instances (K13 b): for each live instance b, r =
    coef[b, 0]*pg[b] + coef[b, 1:m+1] @ S[b] + coef[b, m+1:] @ Y[b],
    constrained to the orthant of -pg[b] inside the window [start, end)
    (the same for every instance, in its own indices) and written to
    out[b], with the [B] sums ||r||^2 before the constraint, ||rc||^2 and
    rc . pg.  Operands as ``combine_batched``'s, ``pg`` in g's place.  A
    frozen instance's row of ``out`` is never written, and its sums are
    undefined.  On the card an instance's rc equals ``combine_ow``'s on
    that instance alone bit for bit.  Returns (r.r, rc.rc, rc.pg)."""
    _check_combine_batched("combine_ow_batched", pg, S, Y, coef, live, out)
    start, end = _check_window(pg.shape[1], start, end)
    if not on_cuda(pg, "combine_ow_batched"):
        return combine_ow_batched_ref(pg, S, Y, coef, live, out, start, end)
    tot = _launch_combine_batched("combine_ow_batched", pg, S, Y, coef, live, out, 3, start,
                                  end)
    combine_ow_batched.launches += 1
    return tot[:, 0], tot[:, 1], tot[:, 2]


combine_ow_batched.launches = 0


# ---------------------------------------------------------------------------
# K6: combine + damped ring-row persist
# ---------------------------------------------------------------------------


def _check_row(S, end: int) -> int:
    if not 0 <= int(end) < S.shape[0]:
        raise ValueError(f"ring row {end} outside [0, {S.shape[0]})")
    return int(end)


def combine_fix_plain(d, S, Y, gamma, coef_s, coef_y, end: int, ca, cb):
    """(r, r.r, r.d) with Y[end] fixed in place, in plain torch, uncounted:
    the arithmetic of ``combine_fix_ref``, which the damped form of the
    combine+probe fusion's plain version (``factory``) shares."""
    end = _check_row(S, end)
    r = _combination(d, S, Y, gamma, coef_s, coef_y)
    Y[end] = (ca * Y[end].to(d.dtype) + cb * d).to(Y.dtype)
    return r, torch.dot(r, r), torch.dot(r, d)


def combine_fix_ref(d, S, Y, gamma, coef_s, coef_y, end: int, ca, cb):
    """Plain version of ``combine_fix``: (r, r.r, r.d), Y[end] fixed in
    place."""
    combine_fix_ref.calls += 1
    return summed(combine_fix_plain(d, S, Y, gamma, coef_s, coef_y, end, ca, cb))


combine_fix_ref.calls = 0


def combine_fix(d, S, Y, gamma, coef_s, coef_y, end: int, ca, cb):
    """``combine`` over the history as it stands, then the damped ring row
    persisted in place: Y[end] <- round(ca*Y[end] + cb*d) to the history
    dtype, the products and the sum rounded one by one in the vectors'
    dtype.  The caller has folded the damping into gamma and coef_y
    (``solver.two_loop_compact``'s ``row_fix``), so r is the direction of
    the damped history although the combine reads the row before the fix.
    ``ca`` and ``cb`` are 0-d tensors on d's device (no host read).
    Returns (r, r.r, r.d)."""
    _check_hist(d, S, Y)
    if not on_cuda(d, "combine_fix"):
        return combine_fix_ref(d, S, Y, gamma, coef_s, coef_y, end, ca, cb)
    end = _check_row(S, end)
    r, tot = _launch_combine("combine_fix", d, S, Y, (gamma, coef_s, coef_y, ca, cb),
                             2, end)
    combine_fix.launches += 1
    return (r, *mesh_sum(tot[0], tot[1]))


combine_fix.launches = 0


# ---------------------------------------------------------------------------
# K6 b: the batched runner's combine + damped ring-row persist
# ---------------------------------------------------------------------------


def fix_row_batched(g, Y, coef, end: int, live) -> None:
    """The damped ring row of ``combine_fix_batched``'s plain version (and
    of the fused batched combine's fix form): Y[b, end] <- round(ca*Y[b,
    end] + cb*g[b]) for each live instance, (ca, cb) the last two columns
    of its coefficient row, by ``combine_fix_plain``'s arithmetic."""
    ca, cb = coef[:, -2:-1], coef[:, -1:]
    fixed = (ca * Y[:, end].to(g.dtype) + cb * g).to(Y.dtype)
    Y[live, end] = fixed[live]


def combine_fix_batched_ref(g, S, Y, coef, live, out, end: int):
    """Plain version of ``combine_fix_batched``."""
    combine_fix_batched_ref.calls += 1
    m = S.shape[1]
    r = _combination_batched(g, S, Y, coef[:, :1 + 2 * m])
    fix_row_batched(g, Y, coef, end, live)
    out[live] = r[live]
    return (r * r).sum(dim=1), (r * g).sum(dim=1)


combine_fix_batched_ref.calls = 0


def combine_fix_batched(g, S, Y, coef, live, out, end: int):
    """K6 over B instances (K6 b): ``combine_batched``'s r over the rings
    as they stand, then for each live instance b the damped ring row
    persisted in place, Y[b, end] <- round(ca*Y[b, end] + cb*g[b]) to the
    history dtype, (ca, cb) = coef[b, 2m + 1:] (``coef`` [B, 2m + 3]:
    [gamma, cs, cy, ca, cb], the damping folded into gamma and cy[end] as
    for ``combine_fix``).  ``end`` is a host int shared by the live
    instances.  A frozen instance's row of ``out`` and its ring are never
    written.  On the card an instance's r and damped row equal
    ``combine_fix``'s on that instance alone bit for bit.  Returns (r.r,
    r.g)."""
    _check_combine_batched("combine_fix_batched", g, S, Y, coef, live, out, fix=True)
    end = _check_row(S[0], end)
    if not on_cuda(g, "combine_fix_batched"):
        return combine_fix_batched_ref(g, S, Y, coef, live, out, end)
    tot = _launch_combine_batched("combine_fix_batched", g, S, Y, coef, live, out, 2, end)
    combine_fix_batched.launches += 1
    return tot[:, 0], tot[:, 1]


combine_fix_batched.launches = 0


# ---------------------------------------------------------------------------
# K13: OWL-QN combine with the direction constraint
# ---------------------------------------------------------------------------


def combine_ow_plain(d, S, Y, gamma, coef_s, coef_y, start: int, end: int):
    """(rc, r.r, rc.rc, rc.d) in plain torch, uncounted (``combine_ow_ref``'s
    arithmetic, shared with the OWL-QN combine+probe fusion's plain
    version); the sums are the shard's."""
    r = _combination(d, S, Y, gamma, coef_s, coef_y)
    rc = project_window(r, -d, start, end)
    return rc, torch.dot(r, r), torch.dot(rc, rc), torch.dot(rc, d)


def combine_ow_ref(d, S, Y, gamma, coef_s, coef_y, start: int, end: int):
    """Plain version of ``combine_ow``: (rc, r.r, rc.rc, rc.d)."""
    combine_ow_ref.calls += 1
    return summed(combine_ow_plain(d, S, Y, gamma, coef_s, coef_y, start, end))


combine_ow_ref.calls = 0


def combine_ow(d, S, Y, gamma, coef_s, coef_y, start: int, end: int):
    """The combine of ``combine`` with OWL-QN's direction constraint in
    the same pass: ``d`` is the pseudo-gradient pg (the two-loop's sign
    folded into gamma and the coefficients), and r is projected onto the
    orthant of -pg inside the window [start, end).  Returns (rc, ||r||^2
    before the constraint, ||rc||^2, rc . pg): the reference's dnorm
    (``src/lbfgs.rs:544``), the zero-direction check and the next
    search's dginit."""
    _check_hist(d, S, Y)
    if not on_cuda(d, "combine_ow"):
        return combine_ow_ref(d, S, Y, gamma, coef_s, coef_y, start, end)
    r, tot = _launch_combine("combine_ow", d, S, Y, (gamma, coef_s, coef_y), 3,
                             *local_window(int(start), int(end), d.shape[0]))
    combine_ow.launches += 1
    return (r, *mesh_sum(tot[0], tot[1], tot[2]))


combine_ow.launches = 0


# ---------------------------------------------------------------------------
# K10: OWL-QN pseudo-gradient and its norm
# ---------------------------------------------------------------------------


def _check_vectors(kernel: str, *vs: torch.Tensor) -> None:
    check_dtypes(vs[0].dtype)
    if vs[0].ndim != 1 or any(v.shape != vs[0].shape or v.dtype != vs[0].dtype
                              for v in vs):
        raise ValueError(f"{kernel}: expected [n] vectors of one dtype; got "
                         f"{[(tuple(v.shape), v.dtype) for v in vs]}")


def _check_window(n: int, start: int, end: int) -> tuple[int, int]:
    """The global OWL-QN window, checked against the whole vector (of which
    ``n`` elements are this rank's shard under a mesh)."""
    whole = global_length(n)
    if not 0 <= start < end <= whole:
        raise ValueError(f"OWL-QN window [{start}, {end}) outside [0, {whole})")
    return int(start), int(end)


def kernel_window(n: int, start: int, end: int) -> tuple[int, int]:
    """The checked global window in a kernel's own indices: the window
    itself, or on a mesh its part in the shard of ``n`` elements, in the
    shard's indices (possibly empty)."""
    return local_window(*_check_window(n, start, end), n)


def _check_pg(x, g, c: float, start: int, end: int) -> tuple[int, int]:
    _check_vectors("pseudo_gradient", x, g)
    if c < 0:
        raise ValueError(f"invalid orthantwise param c: {c}")
    return _check_window(x.shape[0], start, end)


def _launch_pseudo_grad(name: str, x, g, c: float, start: int, end: int, norm: bool):
    """Launch K10 (``norm``) or K11 from ``csrc/owlqn.cu``; returns pg and
    the [blocks, 1] partials of pg . pg (None without the norm)."""
    check_contiguous(name, x, g)
    lib = _build.load_library()
    n = x.shape[0]
    start, end = local_window(start, end, n)
    pg = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if norm:
        blocks = -(-n // lib.lbfgs_owlqn_block_elems())
        part = torch.empty((blocks, 1), dtype=x.dtype, device=x.device)
        code = getattr(lib, f"lbfgs_pseudo_grad_norm_{_SUFFIX[x.dtype]}")(
            x.data_ptr(), g.data_ptr(), float(c), start, end, pg.data_ptr(),
            part.data_ptr(), n, stream)
    else:
        part = None
        code = getattr(lib, f"lbfgs_pseudo_grad_{_SUFFIX[x.dtype]}")(
            x.data_ptr(), g.data_ptr(), float(c), start, end, pg.data_ptr(), n, stream)
    _build.check_launch(code, name)
    return pg, part


def pseudo_gradient_norm_ref(x, g, c: float, start: int, end: int):
    """Plain version of ``pseudo_gradient_norm``."""
    pseudo_gradient_norm_ref.calls += 1
    pg = ow_ops.pseudo_gradient(Orthantwise(c=c, start=start, end=end), x, g)
    return summed((pg, torch.dot(pg, pg)))


pseudo_gradient_norm_ref.calls = 0


def pseudo_gradient_norm(x, g, c: float, start: int, end: int):
    """(pg, pg . pg): OWL-QN's pseudo-gradient (Andrew & Gao Eq. 4, L1
    weight ``c`` on the window [start, end)) and its squared norm in one
    pass (K10)."""
    start, end = _check_pg(x, g, c, start, end)
    if not on_cuda(x, "pseudo_gradient_norm"):
        return pseudo_gradient_norm_ref(x, g, c, start, end)
    pg, part = _launch_pseudo_grad("pseudo_gradient_norm", x, g, c, start, end, True)
    pseudo_gradient_norm.launches += 1
    return (pg, *mesh_sum(reduce_partials(part)[0]))


pseudo_gradient_norm.launches = 0


# ---------------------------------------------------------------------------
# K10 b: the batched runner's pseudo-gradient and norm
# ---------------------------------------------------------------------------


def pseudo_gradient_norm_batched_ref(x, g, c: float, start: int, end: int, live, out):
    """Plain version of ``pseudo_gradient_norm_batched``."""
    pseudo_gradient_norm_batched_ref.calls += 1
    pg = ow_ops.pseudo_gradient(Orthantwise(c=c, start=start, end=end), x, g)
    out[live] = pg[live]
    return (pg * pg).sum(dim=1)


pseudo_gradient_norm_batched_ref.calls = 0


def pseudo_gradient_norm_batched(x, g, c: float, start: int, end: int, live, out):
    """K10 over B instances (K10 b): for each live instance b, OWL-QN's
    pseudo-gradient of (x[b], g[b]) written to out[b] (L1 weight ``c`` on
    the window [start, end), the same for every instance, in its own
    indices), and the [B] sums pg.pg.  ``x``, ``g``, ``out`` [B, n] of
    one dtype; ``live`` [B] bool.  A frozen instance's row of ``out`` is
    never written, and its sum is undefined.  On the card an instance's
    pg equals ``pseudo_gradient_norm``'s on that instance alone bit for
    bit.  Returns pg.pg [B]."""
    B, (start, end) = _check_pg_batched("pseudo_gradient_norm_batched", x, g, c, start, end,
                                        live, out)
    if not on_cuda(x, "pseudo_gradient_norm_batched"):
        return pseudo_gradient_norm_batched_ref(x, g, c, start, end, live, out)
    check_contiguous("pseudo_gradient_norm_batched", x, g, live, out)
    lib = _build.load_library()
    n = x.shape[1]
    part = torch.empty((B, -(-n // lib.lbfgs_owlqn_block_elems())), dtype=x.dtype,
                       device=x.device)
    code = getattr(lib, f"lbfgs_pseudo_grad_norm_batched_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), g.data_ptr(), float(c), start, end, live.data_ptr(), out.data_ptr(),
        part.data_ptr(), n, B, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(code, "pseudo_gradient_norm_batched")
    pseudo_gradient_norm_batched.launches += 1
    return reduce_partials(part, dim=1)


pseudo_gradient_norm_batched.launches = 0


def _check_pg_batched(kernel: str, x, g, c: float, start: int, end: int, live, out) -> tuple:
    """Check a batched pseudo-gradient's [B, n] operands; returns (B, the
    checked window)."""
    B = check_batch(kernel, x, live)
    if g.shape != x.shape or out.shape != x.shape or not x.dtype == g.dtype == out.dtype:
        raise ValueError(f"{kernel}: x, g and out must be [B, n] of one dtype")
    if c < 0:
        raise ValueError(f"invalid orthantwise param c: {c}")
    return B, _check_window(x.shape[1], start, end)


# ---------------------------------------------------------------------------
# K11 b: the batched runner's pseudo-gradient alone
# ---------------------------------------------------------------------------


def pseudo_gradient_batched_ref(x, g, c: float, start: int, end: int, live, out):
    """Plain version of ``pseudo_gradient_batched``."""
    pseudo_gradient_batched_ref.calls += 1
    pg = ow_ops.pseudo_gradient(Orthantwise(c=c, start=start, end=end), x, g)
    out[live] = pg[live]
    return out


pseudo_gradient_batched_ref.calls = 0


def pseudo_gradient_batched(x, g, c: float, start: int, end: int, live, out):
    """K11 over B instances (K11 b): for each live instance b, OWL-QN's
    pseudo-gradient of (x[b], g[b]) written to out[b], as
    ``pseudo_gradient_norm_batched`` writes it, without the norm.
    Operands as there.  A frozen instance's row of ``out`` is never
    written.  On the card an instance's pg equals ``pseudo_gradient``'s on
    that instance alone bit for bit.  Returns ``out``."""
    B, (start, end) = _check_pg_batched("pseudo_gradient_batched", x, g, c, start, end, live,
                                        out)
    if not on_cuda(x, "pseudo_gradient_batched"):
        return pseudo_gradient_batched_ref(x, g, c, start, end, live, out)
    check_contiguous("pseudo_gradient_batched", x, g, live, out)
    code = getattr(_build.load_library(), f"lbfgs_pseudo_grad_batched_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), g.data_ptr(), float(c), start, end, live.data_ptr(), out.data_ptr(),
        x.shape[1], B, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(code, "pseudo_gradient_batched")
    pseudo_gradient_batched.launches += 1
    return out


pseudo_gradient_batched.launches = 0


# ---------------------------------------------------------------------------
# K11: OWL-QN pseudo-gradient alone
# ---------------------------------------------------------------------------


def pseudo_gradient_ref(x, g, c: float, start: int, end: int):
    """Plain version of ``pseudo_gradient``."""
    pseudo_gradient_ref.calls += 1
    return ow_ops.pseudo_gradient(Orthantwise(c=c, start=start, end=end), x, g)


pseudo_gradient_ref.calls = 0


def pseudo_gradient(x, g, c: float, start: int, end: int):
    """OWL-QN's pseudo-gradient alone (K11, K10's body without the norm):
    the same pg as ``pseudo_gradient_norm``, bit for bit.  The generic
    objectives' init and the revert of a failed search use it."""
    start, end = _check_pg(x, g, c, start, end)
    if not on_cuda(x, "pseudo_gradient"):
        return pseudo_gradient_ref(x, g, c, start, end)
    pg, _ = _launch_pseudo_grad("pseudo_gradient", x, g, c, start, end, False)
    pseudo_gradient.launches += 1
    return pg


pseudo_gradient.launches = 0


# ---------------------------------------------------------------------------
# K9: OWL-QN projected trial point
# ---------------------------------------------------------------------------


def owlqn_trial_step_ref(xp, d, wp, stp, start: int, end: int):
    """Plain version of ``owlqn_trial_step``."""
    owlqn_trial_step_ref.calls += 1
    return project_window(xp + float(stp) * d, wp, start, end)


owlqn_trial_step_ref.calls = 0


def owlqn_trial_step(xp, d, wp, stp, start: int, end: int):
    """The projected trial point x = pi(xp + stp*d; wp) inside the window
    [start, end) (K9): zero where signum(x) != signum(wp), the step
    rounded as xp + round(stp*d), so the point is that of the plain
    version and of K8's and K14's projection bit for bit.  ``stp`` is a
    host scalar."""
    _check_vectors("owlqn_trial_step", xp, d, wp)
    start, end = _check_window(xp.shape[0], start, end)
    if not on_cuda(xp, "owlqn_trial_step"):
        return owlqn_trial_step_ref(xp, d, wp, stp, start, end)
    check_contiguous("owlqn_trial_step", xp, d, wp)
    lib = _build.load_library()
    x = torch.empty_like(xp)
    lo, hi = local_window(start, end, xp.shape[0])
    code = getattr(lib, f"lbfgs_owlqn_trial_step_{_SUFFIX[xp.dtype]}")(
        xp.data_ptr(), d.data_ptr(), wp.data_ptr(), float(stp), lo, hi,
        x.data_ptr(), xp.shape[0], torch.cuda.current_stream(xp.device).cuda_stream)
    _build.check_launch(code, "owlqn_trial_step")
    owlqn_trial_step.launches += 1
    return x


owlqn_trial_step.launches = 0


# ---------------------------------------------------------------------------
# K9 b: the batched runner's projected trial points
# ---------------------------------------------------------------------------


def owlqn_trial_step_batched_ref(xp, d, pg, stp, start: int, end: int, live, out):
    """Plain version of ``owlqn_trial_step_batched``."""
    owlqn_trial_step_batched_ref.calls += 1
    wp = ow_ops.choose_orthant(Orthantwise(1.0, start, end), xp, pg)
    x = project_window(xp + stp[:, None] * d, wp, start, end)
    out[live] = x[live]
    return out


owlqn_trial_step_batched_ref.calls = 0


def owlqn_trial_step_batched(xp, d, pg, stp, start: int, end: int, live, out):
    """K9 over B instances (K9 b): for each live instance b the projected
    trial point pi(xp[b] + stp[b]*d[b]; wp) inside the window [start, end)
    written to out[b], wp the orthant the search chose from (xp[b], pg[b])
    (``orthantwise.choose_orthant``), rebuilt in registers.  ``xp``, ``d``,
    ``pg``, ``out`` [B, n] of one dtype; ``stp`` [B] of that dtype;
    ``live`` [B] bool.  A frozen instance's row of ``out`` is never
    written.  On the card an instance's point equals ``owlqn_trial_step``'s
    with that wp bit for bit.  Returns ``out``."""
    B = check_batch("owlqn_trial_step_batched", xp, live)
    if any(t.shape != xp.shape or t.dtype != xp.dtype for t in (d, pg, out)):
        raise ValueError("owlqn_trial_step_batched: xp, d, pg and out must be [B, n] of one "
                         "dtype")
    if stp.shape != (B,) or stp.dtype != xp.dtype or stp.device != xp.device:
        raise ValueError(f"owlqn_trial_step_batched: stp must be [{B}] of the vectors' dtype")
    start, end = _check_window(xp.shape[1], start, end)
    if not on_cuda(xp, "owlqn_trial_step_batched"):
        return owlqn_trial_step_batched_ref(xp, d, pg, stp, start, end, live, out)
    check_contiguous("owlqn_trial_step_batched", xp, d, pg, stp, live, out)
    code = getattr(_build.load_library(), f"lbfgs_owlqn_trial_step_batched_{_SUFFIX[xp.dtype]}")(
        xp.data_ptr(), d.data_ptr(), pg.data_ptr(), stp.data_ptr(), start, end, live.data_ptr(),
        out.data_ptr(), xp.shape[1], B, torch.cuda.current_stream(xp.device).cuda_stream)
    _build.check_launch(code, "owlqn_trial_step_batched")
    owlqn_trial_step_batched.launches += 1
    return out


owlqn_trial_step_batched.launches = 0


# ---------------------------------------------------------------------------
# Pair + Gram updates: K5 and the composed forms
# ---------------------------------------------------------------------------


def pair_gram_ref(s, y, g, S, Y, end: int):
    """Composed correction-pair update: write (s, y) into ring row ``end``
    of S and Y (in place, rounded to the history dtype), then SP = S . Z
    and YP = Y . Z with Z = [y, s, -g] ([m, 3] each, in the vectors'
    dtype).  The products of row ``end`` see the STORED (rounded) pair,
    as the JAX package's composed path does; on a mesh they are summed
    over the ranks in one collective."""
    S[end] = s.to(S.dtype)
    Y[end] = y.to(Y.dtype)
    Z = torch.stack([y, s, -g], dim=1)
    return mesh_sum(S.to(s.dtype) @ Z, Y.to(s.dtype) @ Z)


def pair_products(s, y, d0, S, Y, end: int, gp=None):
    """SP = S . [y, s, d0] and YP = Y . [y, s, d0] ([m, 3]) over the rings
    with row ``end`` replaced by the new pair UNROUNDED (the kernels hold
    it in registers), then the pair stored into ring row ``end``, rounded
    to the history dtype.  With ``gp`` a fourth column S . gp, Y . gp
    ([m, 4]), taken apart so that columns 0-2 are those of the 3-column
    form bit for bit.  Shared by the plain versions of K4, K5 and K14;
    the products are the shard's."""
    Sw, Yw = S.to(s.dtype), Y.to(s.dtype)
    Z = torch.stack([y, s, d0], dim=1)
    SP = Sw @ Z
    YP = Yw @ Z
    SP[end] = torch.stack([s @ y, s @ s, s @ d0])
    YP[end] = torch.stack([y @ y, y @ s, y @ d0])
    if gp is not None:
        Sg, Yg = Sw @ gp, Yw @ gp
        Sg[end], Yg[end] = s @ gp, y @ gp
        SP = torch.cat([SP, Sg[:, None]], dim=1)
        YP = torch.cat([YP, Yg[:, None]], dim=1)
    S[end] = s.to(S.dtype)
    Y[end] = y.to(Y.dtype)
    return SP, YP


def row_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The [B] row products of two [B, n] batches."""
    return (a * b).sum(dim=1)


def pair_products_batched(s, y, d0, S, Y, end: int, live, gp=None) -> tuple:
    """``pair_products`` over a batch: SP = S[b].[y, s, d0], YP =
    Y[b].[y, s, d0] ([B, m, 3]) with ring row ``end`` replaced by the new
    pair UNROUNDED, then the pair stored into row ``end`` of the live
    instances' rings, rounded to the history dtype.  With ``gp`` a fourth
    column S[b].gp[b], Y[b].gp[b] ([B, m, 4]), taken apart so that columns
    0-2 are those of the 3-column form bit for bit."""
    Sw, Yw = S.to(s.dtype), Y.to(s.dtype)
    Z = torch.stack([y, s, d0], dim=2)
    SP = torch.bmm(Sw, Z)
    YP = torch.bmm(Yw, Z)
    SP[:, end] = torch.stack([row_dot(s, y), row_dot(s, s), row_dot(s, d0)], dim=1)
    YP[:, end] = torch.stack([row_dot(y, y), row_dot(y, s), row_dot(y, d0)], dim=1)
    if gp is not None:
        Sg, Yg = torch.bmm(Sw, gp[:, :, None]), torch.bmm(Yw, gp[:, :, None])
        Sg[:, end, 0], Yg[:, end, 0] = row_dot(s, gp), row_dot(y, gp)
        SP, YP = torch.cat([SP, Sg], dim=2), torch.cat([YP, Yg], dim=2)
    S[live, end] = s[live].to(S.dtype)
    Y[live, end] = y[live].to(Y.dtype)
    return SP, YP


def pair_gram_stored_batched(s, y, g, S, Y, end: int, live) -> tuple:
    """``pair_gram_ref`` over a batch: the pair written into ring row
    ``end`` of the live instances' rings (rounded to the history dtype;
    ``live`` a [B] bool tensor, no host read), then SP = S[b].[y, s, -g],
    YP = Y[b].[y, s, -g] ([B, m, 3]) over the rings as stored.  The
    batched runner's composed pair + Gram pass for generic objectives
    (plain L-BFGS, and the damped pair), the JAX package's jnp pass
    (``lbfgs_tpu/solver.py:693-704``) under its vmap."""
    keep = live[:, None]
    S[:, end] = torch.where(keep, s.to(S.dtype), S[:, end])
    Y[:, end] = torch.where(keep, y.to(Y.dtype), Y[:, end])
    Z = torch.stack([y, s, -g], dim=2)
    return torch.bmm(S.to(s.dtype), Z), torch.bmm(Y.to(s.dtype), Z)


def _check_pair(d, gx, gp, S, Y, end: int) -> int:
    _check_hist(d, S, Y)
    if gx.shape != d.shape or gp.shape != d.shape or not (
            gx.dtype == gp.dtype == d.dtype):
        raise ValueError("d, gx and gp must be [n] vectors of one dtype")
    return _check_row(S, end)


def append_gp(SP, YP, G):
    """SP, YP ([m, 3]) with the . gp column appended from ``G``, the [2m]
    sums (S_0.gp, Y_0.gp, S_1.gp, ...) of a kernel's . gp partials; or
    per instance, SP, YP [B, m, 3] and G [B, 2m]."""
    G = G.reshape(*SP.shape[:-1], 2)
    return torch.cat([SP, G[..., :1]], dim=-1), torch.cat([YP, G[..., 1:]], dim=-1)


#: K5's and K12's launch (``csrc/pair_gram.cu``): a tile of T elements,
#: 256 threads each holding V consecutive ones (16 bytes of the vectors'
#: dtype); each block loops over a run of tiles with its sums in registers
#: (``pair_gram_grid``).  The tile is compiled into the kernel, which
#: refuses another.
PAIR_GRAM = {
    (torch.float32, torch.bfloat16): dict(T=1024, V=4),
    (torch.float32, torch.float32): dict(T=1024, V=4),
    (torch.float64, torch.float64): dict(T=512, V=2),
}
#: most blocks K5 and K12 launch per group of ring rows: 2 on each of the
#: H100's 132 SMs, the blocks K5 holds at once at the main path's shapes
#: (chosen on an NVIDIA H100 80GB HBM3 at its 700 W limit with
#: ``tools/tune_pair_gram.py``: 1 to 8 per SM ran K5's . gp form at n =
#: 2^24, m = 6 in 0.209-0.258 ms, 2 and 4 fastest; PERF.md, section 6)
PAIR_GRAM_BLOCKS = 2 * 132


def pair_gram_grid(n: int, vdtype: torch.dtype, hdtype: torch.dtype) -> SimpleNamespace:
    """K5's and K12's launch at n elements of ``vdtype`` vectors with a
    ``hdtype`` history: the tile T and the run V a thread holds, the tiles
    of T elements that cover n, the tiles each block loops over and the
    block count per group of ring rows (at most ``PAIR_GRAM_BLOCKS``;
    fewer, with one tile each, for a small n).  The last block's run may
    end early; the last tile's elements past n are masked."""
    cfg = PAIR_GRAM[(vdtype, hdtype)]
    ntiles = -(-n // cfg["T"])
    tiles = -(-ntiles // PAIR_GRAM_BLOCKS)
    return SimpleNamespace(**cfg, ntiles=ntiles, tiles=tiles, blocks=-(-ntiles // tiles))


def pair_gram_partials(grid: SimpleNamespace, m: int, with_gp: bool,
                       xg: bool = False) -> dict:
    """The shapes of K5's and K12's (``xg``) partials: [blocks, 6m], each
    block's six products of every ring row, and with ``with_gp`` its
    (S_j.gp, Y_j.gp): [blocks, 2m] for K5, [blocks, 2 + 2m] for K12, whose
    first two columns are gp.gp and gp.pg."""
    out = {"part": (grid.blocks, 6 * m)}
    if with_gp:
        out["gpart"] = (grid.blocks, 2 * m + 2 * xg)
    return out


def _launch_pair_gram(kernel: str, entry: str, lead: tuple, vectors: tuple, S, Y, end: int,
                      with_gp: bool, xg: bool = False) -> tuple:
    """Launch K5 or K12 (``xg``) through its C entry point ``entry`` on the
    grid of ``pair_gram_grid``: ``lead`` the host scalars before the
    pointers (K5's stp), then the ``vectors``, the rings and the partials.
    Returns the reduced [m, 6] products and, with ``with_gp``, the . gp
    partials' column sums (else None)."""
    v = vectors[0]
    m, n = S.shape
    check_contiguous(kernel, *vectors)
    ld = ring_ld(kernel, S, Y)
    lib = _build.load_library()
    grid = pair_gram_grid(n, v.dtype, S.dtype)
    bufs = {k: torch.empty(shape, dtype=v.dtype, device=v.device)
            for k, shape in pair_gram_partials(grid, m, with_gp, xg).items()}
    part = bufs["part"]
    fn = getattr(lib, f"{entry}_{_SUFFIX[v.dtype]}_{_SUFFIX[S.dtype]}")
    code = fn(*lead, *(t.data_ptr() for t in vectors), S.data_ptr(), Y.data_ptr(),
              part.data_ptr(), bufs.get("gpart", part).data_ptr(), n, ld, m, end, int(with_gp),
              grid.T, grid.tiles, grid.blocks, torch.cuda.current_stream(v.device).cuda_stream)
    _build.check_launch(code, kernel)
    P = reduce_partials(part).reshape(m, 6)
    return P, reduce_partials(bufs["gpart"]) if with_gp else None


def pair_gram_sd_ref(stp, d, gx, gp, S, Y, end: int, with_gp: bool = False):
    """Plain version of ``pair_gram_sd``: ``pair_products`` of s = stp*d,
    y = gx - gp and d0 = -gx, whose products of row ``end`` see the
    unrounded pair, as K5 (``lbfgs_tpu/ops/fused.py:_pair_gram_kernel``)
    holds it in registers."""
    pair_gram_sd_ref.calls += 1
    end = _check_pair(d, gx, gp, S, Y, end)
    return mesh_sum(*pair_products(float(stp) * d, gx - gp, -gx, S, Y, end,
                                   gp=gp if with_gp else None))


pair_gram_sd_ref.calls = 0


def pair_gram_sd(stp, d, gx, gp, S, Y, end: int, with_gp: bool = False):
    """The correction pair of the projection-free step (s = stp*d exactly,
    src/core.rs:155-164, and y = gx - gp) written into ring row ``end`` of
    S and Y in place, rounded to the history dtype, and SP = S . [y, s,
    -gx], YP = Y . [y, s, -gx] over the updated rings ([m, 3]), with the
    new row's products from the unrounded pair.  ``with_gp`` adds the
    damped update's basis column . gp ([m, 4]); columns 0-2 stay those of
    the 3-column launch bit for bit.  ``stp`` is a host scalar.  The
    trial's ``changed`` count, not this pass, decides "x not changed".
    Takes any depth m >= 1 on either device (ring rows in groups of 6 on
    the card)."""
    end = _check_pair(d, gx, gp, S, Y, end)
    if not on_cuda(d, "pair_gram_sd"):
        return pair_gram_sd_ref(stp, d, gx, gp, S, Y, end, with_gp)
    P, G = _launch_pair_gram("pair_gram_sd", "lbfgs_pair_gram", (float(stp),), (d, gx, gp),
                             S, Y, end, with_gp)
    pair_gram_sd.launches += 1
    if with_gp:
        P, G = mesh_sum(P, G)
        return append_gp(P[:, :3], P[:, 3:], G)
    (P,) = mesh_sum(P)
    return P[:, :3], P[:, 3:]


pair_gram_sd.launches = 0


# ---------------------------------------------------------------------------
# K5 b: the batched runner's pair + Gram update (a fused trial, no epilogue)
# ---------------------------------------------------------------------------


def pair_gram_sd_batched_ref(stp, d, gx, gp, S, Y, end: int, live, with_gp: bool = False):
    """Plain version of ``pair_gram_sd_batched``: ``pair_products_batched``
    of s = stp*d, y = gx - gp and d0 = -gx, row ``end``'s products from the
    unrounded pair, as ``pair_gram_sd_ref`` per instance."""
    pair_gram_sd_batched_ref.calls += 1
    return pair_products_batched(stp[:, None] * d, gx - gp, -gx, S, Y, end, live,
                                 gp if with_gp else None)


pair_gram_sd_batched_ref.calls = 0


def pair_gram_sd_batched(stp, d, gx, gp, S, Y, end: int, live, with_gp: bool = False):
    """K5 over B instances (K5 b): for each live instance b the pair (s, y)
    = (stp[b]*d[b], gx[b] - gp[b]) written into ring row ``end`` of S[b]
    and Y[b] in place, rounded to the history dtype, and SP = S[b].[y, s,
    -gx[b]], YP = Y[b].[y, s, -gx[b]] over the updated rings ([B, m, 3]),
    the new row's products from the unrounded pair.  ``with_gp`` (the
    damped runs) appends the . gp column S[b].gp[b], Y[b].gp[b] ([B, m,
    4]); columns 0-2 stay those of the 3-column launch bit for bit.  ``d``,
    ``gx``, ``gp`` [B, n]; ``S``, ``Y`` [B, m, n], any m >= 1; ``stp`` [B]
    in the vectors' dtype; ``end`` a host int shared by the live instances;
    ``live`` [B] bool.  A frozen instance's ring rows are never written,
    and its products are undefined.  On the card an instance's ring rows
    equal ``pair_gram_sd``'s on that instance alone bit for bit, and so do
    its partials (its blocks are the solo launch's); torch adds the [B,
    blocks, 6m] partials in an order that may depend on B.  The trial's
    ``changed`` count, not this pass, decides "x not changed"."""
    B = check_batch("pair_gram_sd_batched", d, live)
    _check_hist_batched("pair_gram_sd_batched", d, S, Y)
    if any(t.shape != d.shape or t.dtype != d.dtype for t in (gx, gp)):
        raise ValueError("pair_gram_sd_batched: d, gx and gp must be [B, n] of one dtype")
    if stp.shape != (B,) or stp.dtype != d.dtype or stp.device != d.device:
        raise ValueError(f"pair_gram_sd_batched: stp must be [{B}] of the vectors' dtype")
    end = _check_row(S[0], end)
    if not on_cuda(d, "pair_gram_sd_batched"):
        return pair_gram_sd_batched_ref(stp, d, gx, gp, S, Y, end, live, with_gp)
    check_contiguous("pair_gram_sd_batched", stp, d, gx, gp, live)
    ld = ring_ld("pair_gram_sd_batched", S, Y)
    _, m, n = S.shape
    grid = pair_gram_grid(n, d.dtype, S.dtype)
    part = torch.empty((B, grid.blocks, 6 * m), dtype=d.dtype, device=d.device)
    gpart = (torch.empty((B, grid.blocks, 2 * m), dtype=d.dtype, device=d.device)
             if with_gp else part)
    fn = getattr(_build.load_library(),
                 f"lbfgs_pair_gram_batched_{_SUFFIX[d.dtype]}_{_SUFFIX[S.dtype]}")
    code = fn(stp.data_ptr(), d.data_ptr(), gx.data_ptr(), gp.data_ptr(), S.data_ptr(),
              Y.data_ptr(), live.data_ptr(), part.data_ptr(), gpart.data_ptr(), n, ld, m, end,
              int(with_gp), grid.T, grid.tiles, grid.blocks, B,
              torch.cuda.current_stream(d.device).cuda_stream)
    _build.check_launch(code, "pair_gram_sd_batched")
    pair_gram_sd_batched.launches += 1
    pair_gram_sd_batched.gp_launches += bool(with_gp)
    P = reduce_partials(part, dim=1).reshape(B, m, 6)
    SP, YP = P[..., :3], P[..., 3:]
    if with_gp:
        SP, YP = append_gp(SP, YP, reduce_partials(gpart, dim=1))
    return SP, YP


pair_gram_sd_batched.launches = 0
#: the launches with the . gp column, counted among ``launches`` too
pair_gram_sd_batched.gp_launches = 0


# ---------------------------------------------------------------------------
# K12: OWL-QN pair + Gram update of the composed branch
# ---------------------------------------------------------------------------


def pair_gram_xg_ref(x, xp, gx, gp, pg, S, Y, end: int, with_gp: bool = False):
    """Plain version of ``pair_gram_xg``: ``pair_products`` of s = x - xp,
    y = gx - gp and d0 = -pg, the products of row ``end`` from the
    unrounded pair as K12 holds it in registers; ``with_gp`` as there."""
    pair_gram_xg_ref.calls += 1
    end = _check_row(S, end)
    SP, YP = pair_products(x - xp, gx - gp, -pg, S, Y, end, gp=gp if with_gp else None)
    if not with_gp:
        return mesh_sum(SP, YP)
    return mesh_sum(SP, YP, torch.dot(gp, gp), torch.dot(gp, pg))


pair_gram_xg_ref.calls = 0


def pair_gram_xg(x, xp, gx, gp, pg, S, Y, end: int, with_gp: bool = False):
    """OWL-QN's pair + Gram update where the one-pass epilogue does not run
    (K12): the pair of the PROJECTED step, s = x - xp and y = gx - gp,
    written into ring row ``end`` of S and Y in place, rounded to the
    history dtype, and SP = S . [y, s, -pg], YP = Y . [y, s, -pg] ([m, 3])
    over the updated rings, the new row's products from the unrounded pair
    (``lbfgs_tpu/ops/fused.py:_pair_gram_xg_kernel``).  ``with_gp`` (damped
    OWL-QN) appends the . gp column ([m, 4]) and returns gp.gp and gp.pg
    after them, as K14's . gp form does; columns 0-2 are those of the
    3-column launch.  Any depth m >= 1."""
    _check_hist(x, S, Y)
    _check_vectors("pair_gram_xg", x, xp, gx, gp, pg)
    end = _check_row(S, end)
    if not on_cuda(x, "pair_gram_xg"):
        return pair_gram_xg_ref(x, xp, gx, gp, pg, S, Y, end, with_gp)
    P, G = _launch_pair_gram("pair_gram_xg", "lbfgs_pair_gram_xg", (), (x, xp, gx, gp, pg),
                             S, Y, end, with_gp, xg=True)
    pair_gram_xg.launches += 1
    pair_gram_xg.gp_launches += bool(with_gp)
    if not with_gp:
        (P,) = mesh_sum(P)
        return P[:, :3], P[:, 3:]
    P, G = mesh_sum(P, G)
    return (*append_gp(P[:, :3], P[:, 3:], G[2:]), G[0], G[1])


pair_gram_xg.launches = 0
#: the launches with the . gp column, counted among ``launches`` too
pair_gram_xg.gp_launches = 0


# ---------------------------------------------------------------------------
# K12 b: the batched runner's OWL-QN pair + Gram update (generic objectives)
# ---------------------------------------------------------------------------


def pair_gram_xg_batched_ref(x, xp, gx, gp, pg, S, Y, end: int, live):
    """Plain version of ``pair_gram_xg_batched``: ``pair_products_batched``
    of s = x - xp, y = gx - gp and d0 = -pg, row ``end``'s products from
    the unrounded pair, as ``pair_gram_xg_ref`` per instance."""
    pair_gram_xg_batched_ref.calls += 1
    return pair_products_batched(x - xp, gx - gp, -pg, S, Y, end, live)


pair_gram_xg_batched_ref.calls = 0


def pair_gram_xg_batched(x, xp, gx, gp, pg, S, Y, end: int, live):
    """K12 over B instances (K12 b): for each live instance b the pair
    (x[b] - xp[b], gx[b] - gp[b]) written into ring row ``end`` of S[b] and
    Y[b] in place, rounded to the history dtype, and SP = S[b].[y, s,
    -pg[b]], YP = Y[b].[y, s, -pg[b]] over the updated rings, the new row's
    products from the unrounded pair.  ``x``, ``xp``, ``gx``, ``gp``, ``pg``
    [B, n]; ``S``, ``Y`` [B, m, n], any m >= 1; ``end`` a host int shared by
    the live instances; ``live`` [B] bool.  A frozen instance's ring rows
    are never written, and its products are undefined.  On the card an
    instance's ring rows equal ``pair_gram_xg``'s on that instance alone
    bit for bit, and so do its partials (its blocks are the solo launch's);
    torch adds the [B, blocks, 6m] partials in an order that may depend on
    B.  Returns SP, YP [B, m, 3]."""
    B = check_batch("pair_gram_xg_batched", x, live)
    _check_hist_batched("pair_gram_xg_batched", x, S, Y)
    if any(t.shape != x.shape or t.dtype != x.dtype for t in (xp, gx, gp, pg)):
        raise ValueError("pair_gram_xg_batched: x, xp, gx, gp and pg must be [B, n] of one "
                         "dtype")
    end = _check_row(S[0], end)
    if not on_cuda(x, "pair_gram_xg_batched"):
        return pair_gram_xg_batched_ref(x, xp, gx, gp, pg, S, Y, end, live)
    check_contiguous("pair_gram_xg_batched", x, xp, gx, gp, pg, live)
    ld = ring_ld("pair_gram_xg_batched", S, Y)
    _, m, n = S.shape
    grid = pair_gram_grid(n, x.dtype, S.dtype)
    part = torch.empty((B, grid.blocks, 6 * m), dtype=x.dtype, device=x.device)
    fn = getattr(_build.load_library(),
                 f"lbfgs_pair_gram_xg_batched_{_SUFFIX[x.dtype]}_{_SUFFIX[S.dtype]}")
    code = fn(x.data_ptr(), xp.data_ptr(), gx.data_ptr(), gp.data_ptr(), pg.data_ptr(),
              S.data_ptr(), Y.data_ptr(), live.data_ptr(), part.data_ptr(), n, ld, m, end,
              grid.T, grid.tiles, grid.blocks, B, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(code, "pair_gram_xg_batched")
    pair_gram_xg_batched.launches += 1
    P = reduce_partials(part, dim=1).reshape(B, m, 6)
    return P[..., :3], P[..., 3:]


pair_gram_xg_batched.launches = 0


# ---------------------------------------------------------------------------
# K17: fused axpy + dot
# ---------------------------------------------------------------------------


def axpy_dot_ref(y, x, c, w):
    """Plain version of ``axpy_dot``."""
    axpy_dot_ref.calls += 1
    z = y + float(c) * x
    return z, torch.dot(z, w)


axpy_dot_ref.calls = 0


def axpy_dot(y, x, c, w):
    """z = y + c*x and z . w from one pass (K17,
    ``lbfgs_tpu/ops/fused.py:_axpy_dot_kernel``).  ``c`` is a host scalar,
    rounded to the vectors' dtype; the product and the sum are rounded
    one by one, so z is the plain version's bit for bit.  No solver path
    runs it, and as in the JAX package it has no mesh form."""
    _check_vectors("axpy_dot", y, x, w)
    if active_mesh() is not None:
        raise NotImplementedError("axpy_dot (K17) has no mesh form")
    if not on_cuda(y, "axpy_dot"):
        return axpy_dot_ref(y, x, c, w)
    check_contiguous("axpy_dot", y, x, w)
    lib = _build.load_library()
    n = y.shape[0]
    blocks = -(-n // lib.lbfgs_axpy_dot_block_elems())
    z = torch.empty_like(y)
    part = torch.empty((blocks, 1), dtype=y.dtype, device=y.device)
    code = getattr(lib, f"lbfgs_axpy_dot_{_SUFFIX[y.dtype]}")(
        y.data_ptr(), x.data_ptr(), float(c), w.data_ptr(), z.data_ptr(), part.data_ptr(),
        n, torch.cuda.current_stream(y.device).cuda_stream)
    _build.check_launch(code, "axpy_dot")
    axpy_dot.launches += 1
    return z, reduce_partials(part)[0]


axpy_dot.launches = 0
