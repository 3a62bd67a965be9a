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

  * ``axpy_dot`` (K17) — z = y + c*x and z . w in one pass.  No solver
    path runs it (the compact two-loop takes its products from the
    epilogues), as in the JAX package.

  On a CUDA tensor each launches its hand-written kernel
  (``csrc/combine.cu``, ``csrc/pair_gram.cu``, ``csrc/owlqn.cu``,
  ``csrc/axpy_dot.cu``); on a CPU tensor it runs its plain version
  (``*_ref``).

  * ``reduce_partials`` — the fixed-order cross-block sum that every
    kernel of the package uses: each kernel program writes its own
    partial sums, and this adds them, so no float atomics touch the
    trajectory and runs repeat bit for bit.
  * the wide objective scalar (``wide_fx``, ``params.fx_wide``):
    ``obj_reduce`` and ``obj_sum`` take the objective's sums in float64
    over float32 vectors.
  * ``pair_products`` — the 6m (8m) products of the one-pass epilogues'
    and K5's and K12's plain versions, with row ``end`` taken from the
    unrounded pair as the kernels hold it in registers.
  * ``pair_gram_ref`` — the composed pair update whose products see the
    STORED pair (the damped composed branch, and generic objectives).
  * the predicates ``can_combine`` / ``can_pair_gram`` and the dtype
    rules all kernels follow.

Dtypes: vectors are float32 or float64; the history is bfloat16 or
float32 with float32 vectors, float64 with float64 vectors.  Partial sums
accumulate in the vectors' dtype.  Any other combination raises.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from . import _build
from .. import orthantwise as ow_ops
from ..orthantwise import Orthantwise, project_window

#: (vector dtype, history dtype) pairs the kernels take
SUPPORTED = {
    (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32),
    (torch.float64, torch.float64),
}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}

#: largest history the combine kernel takes (its coefficients live in
#: shared memory; ``csrc/combine.cu`` kMaxM), and K5 (``csrc/pair_gram.cu``)
MAX_M = 64


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


def reduce_partials(partials: torch.Tensor) -> torch.Tensor:
    """Column sums of a [programs, k] partial-sum array, in a fixed order
    (the same shape always reduces the same way; no atomics)."""
    return partials.sum(dim=0)


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


def obj_reduce(parts: torch.Tensor) -> torch.Tensor:
    """Column sums of a [programs, k] array of objective partials (or the
    sum of a [programs] one) in float64: the wide form of
    ``reduce_partials`` for the objective's columns."""
    return parts.to(torch.float64).sum(dim=0)


#: elements per float32 partial in ``obj_sum``'s wide form
OBJ_SUM_BLOCK = 2048


def obj_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum of an objective's terms outside the kernels (the plain
    versions and generic objectives).  Under the wide mode it is two-stage
    as the kernels are, float32 sums over blocks of ``OBJ_SUM_BLOCK``
    elements and a float64 total (``lbfgs_tpu/ops/fused.py:299-313``);
    the kernels' blocks hold 1024 elements, so the two forms differ in the
    last bits of the blocks' float32 sums.  Otherwise one plain sum."""
    if not wide(v.dtype):
        return torch.sum(v)
    pad = (-v.shape[0]) % OBJ_SUM_BLOCK
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    return obj_reduce(v.reshape(-1, OBJ_SUM_BLOCK).sum(dim=1))


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
    """Whether ``combine`` takes these operands (shape and dtype rules)."""
    return (
        d.ndim == 1
        and S.ndim == 2
        and S.shape[1] == d.shape[0]
        and 1 <= S.shape[0] <= MAX_M
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
    return combine_plain(d, S, Y, gamma, coef_s, coef_y)


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
    if m > MAX_M:
        raise ValueError(f"{name}: m = {m} exceeds {MAX_M}")
    check_contiguous(name, d, S, Y)
    lib = _build.load_library()
    coef = coef_vector(d, *coefs)
    blocks = -(-n // lib.lbfgs_combine_block_elems())
    r = torch.empty_like(d)
    part = torch.empty((blocks, nparts), dtype=d.dtype, device=d.device)
    fn = getattr(lib, f"lbfgs_{name}_{_SUFFIX[d.dtype]}_{_SUFFIX[S.dtype]}")
    code = fn(d.data_ptr(), S.data_ptr(), Y.data_ptr(), coef.data_ptr(),
              r.data_ptr(), part.data_ptr(), n, m, *args,
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
    return r, tot[0], tot[1]


combine.launches = 0


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
    return combine_fix_plain(d, S, Y, gamma, coef_s, coef_y, end, ca, cb)


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
    return r, tot[0], tot[1]


combine_fix.launches = 0


# ---------------------------------------------------------------------------
# K13: OWL-QN combine with the direction constraint
# ---------------------------------------------------------------------------


def combine_ow_plain(d, S, Y, gamma, coef_s, coef_y, start: int, end: int):
    """(rc, r.r, rc.rc, rc.d) in plain torch, uncounted (``combine_ow_ref``'s
    arithmetic, shared with the OWL-QN combine+probe fusion's plain
    version)."""
    r = _combination(d, S, Y, gamma, coef_s, coef_y)
    rc = project_window(r, -d, start, end)
    return rc, torch.dot(r, r), torch.dot(rc, rc), torch.dot(rc, d)


def combine_ow_ref(d, S, Y, gamma, coef_s, coef_y, start: int, end: int):
    """Plain version of ``combine_ow``: (rc, r.r, rc.rc, rc.d)."""
    combine_ow_ref.calls += 1
    return combine_ow_plain(d, S, Y, gamma, coef_s, coef_y, start, end)


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
                             int(start), int(end))
    combine_ow.launches += 1
    return r, tot[0], tot[1], tot[2]


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
    if not 0 <= start < end <= n:
        raise ValueError(f"OWL-QN window [{start}, {end}) outside [0, {n})")
    return int(start), int(end)


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
    return pg, torch.dot(pg, pg)


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
    return pg, reduce_partials(part)[0]


pseudo_gradient_norm.launches = 0


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
    code = getattr(lib, f"lbfgs_owlqn_trial_step_{_SUFFIX[xp.dtype]}")(
        xp.data_ptr(), d.data_ptr(), wp.data_ptr(), float(stp), start, end,
        x.data_ptr(), xp.shape[0], torch.cuda.current_stream(xp.device).cuda_stream)
    _build.check_launch(code, "owlqn_trial_step")
    owlqn_trial_step.launches += 1
    return x


owlqn_trial_step.launches = 0


# ---------------------------------------------------------------------------
# Pair + Gram updates: K5 and the composed forms
# ---------------------------------------------------------------------------


def pair_gram_ref(s, y, g, S, Y, end: int):
    """Composed correction-pair update: write (s, y) into ring row ``end``
    of S and Y (in place, rounded to the history dtype), then SP = S . Z
    and YP = Y . Z with Z = [y, s, -g] ([m, 3] each, in the vectors'
    dtype).  The products of row ``end`` see the STORED (rounded) pair,
    as the JAX package's composed path does."""
    S[end] = s.to(S.dtype)
    Y[end] = y.to(Y.dtype)
    Z = torch.stack([y, s, -g], dim=1)
    return S.to(s.dtype) @ Z, Y.to(s.dtype) @ Z


def pair_products(s, y, d0, S, Y, end: int, gp=None):
    """SP = S . [y, s, d0] and YP = Y . [y, s, d0] ([m, 3]) over the rings
    with row ``end`` replaced by the new pair UNROUNDED (the kernels hold
    it in registers), then the pair stored into ring row ``end``, rounded
    to the history dtype.  With ``gp`` a fourth column S . gp, Y . gp
    ([m, 4]), taken apart so that columns 0-2 are those of the 3-column
    form bit for bit.  Shared by the plain versions of K4, K5 and K14."""
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


def _check_pair(d, gx, gp, S, Y, end: int) -> int:
    _check_hist(d, S, Y)
    if gx.shape != d.shape or gp.shape != d.shape or not (
            gx.dtype == gp.dtype == d.dtype):
        raise ValueError("d, gx and gp must be [n] vectors of one dtype")
    return _check_row(S, end)


def append_gp(SP, YP, G):
    """SP, YP ([m, 3]) with the . gp column appended from ``G``, the [2m]
    sums (S_0.gp, Y_0.gp, S_1.gp, ...) of a kernel's . gp partials."""
    G = G.reshape(-1, 2)
    return torch.cat([SP, G[:, :1]], dim=1), torch.cat([YP, G[:, 1:]], dim=1)


#: K5's launch (``csrc/pair_gram.cu``): a tile of T elements, 256 threads
#: each holding V consecutive ones (16 bytes of the vectors' dtype); each
#: block loops over a run of tiles with its sums in registers
#: (``pair_gram_grid``).  The tile is compiled into the kernel, which
#: refuses another.
PAIR_GRAM = {
    (torch.float32, torch.bfloat16): dict(T=1024, V=4),
    (torch.float32, torch.float32): dict(T=1024, V=4),
    (torch.float64, torch.float64): dict(T=512, V=2),
}
#: most blocks K5 launches per group of ring rows: 2 on each of the H100's
#: 132 SMs, the blocks it holds at once at the main path's shapes (chosen
#: on an NVIDIA H100 80GB HBM3 at its 700 W limit with
#: ``tools/tune_pair_gram.py``: 1 to 8 per SM ran the . gp form at n =
#: 2^24, m = 6 in 0.209-0.258 ms, 2 and 4 fastest; PERF.md, section 6)
PAIR_GRAM_BLOCKS = 2 * 132


def pair_gram_grid(n: int, vdtype: torch.dtype, hdtype: torch.dtype) -> SimpleNamespace:
    """K5's launch at n elements of ``vdtype`` vectors with a ``hdtype``
    history: the tile T and the run V a thread holds, the tiles of T
    elements that cover n, the tiles each block loops over and the block
    count (at most ``PAIR_GRAM_BLOCKS``; fewer, with one tile each, for a
    small n).  The last block's run may end early; the last tile's
    elements past n are masked."""
    cfg = PAIR_GRAM[(vdtype, hdtype)]
    ntiles = -(-n // cfg["T"])
    tiles = -(-ntiles // PAIR_GRAM_BLOCKS)
    return SimpleNamespace(**cfg, ntiles=ntiles, tiles=tiles, blocks=-(-ntiles // tiles))


def pair_gram_partials(grid: SimpleNamespace, m: int, with_gp: bool) -> dict:
    """The shapes of K5's partials: [blocks, 6m], each block's six products
    of every ring row, and with ``with_gp`` [blocks, 2m], its (S_j.gp,
    Y_j.gp)."""
    out = {"part": (grid.blocks, 6 * m)}
    if with_gp:
        out["gpart"] = (grid.blocks, 2 * m)
    return out


def pair_gram_sd_ref(stp, d, gx, gp, S, Y, end: int, with_gp: bool = False):
    """Plain version of ``pair_gram_sd``: ``pair_products`` of s = stp*d,
    y = gx - gp and d0 = -gx, whose products of row ``end`` see the
    unrounded pair, as K5 (``lbfgs_tpu/ops/fused.py:_pair_gram_kernel``)
    holds it in registers."""
    pair_gram_sd_ref.calls += 1
    end = _check_pair(d, gx, gp, S, Y, end)
    return pair_products(float(stp) * d, gx - gp, -gx, S, Y, end,
                         gp=gp if with_gp else None)


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
    Takes 1 <= m <= ``MAX_M`` ring rows on either device."""
    end = _check_pair(d, gx, gp, S, Y, end)
    m, n = S.shape
    if m > MAX_M:
        raise ValueError(f"pair_gram_sd: m = {m} exceeds {MAX_M}")
    if not on_cuda(d, "pair_gram_sd"):
        return pair_gram_sd_ref(stp, d, gx, gp, S, Y, end, with_gp)
    check_contiguous("pair_gram_sd", d, gx, gp, S, Y)
    lib = _build.load_library()
    grid = pair_gram_grid(n, d.dtype, S.dtype)
    bufs = {k: torch.empty(v, dtype=d.dtype, device=d.device)
            for k, v in pair_gram_partials(grid, m, with_gp).items()}
    part = bufs["part"]
    fn = getattr(lib, f"lbfgs_pair_gram_{_SUFFIX[d.dtype]}_{_SUFFIX[S.dtype]}")
    code = fn(float(stp), d.data_ptr(), gx.data_ptr(), gp.data_ptr(), S.data_ptr(),
              Y.data_ptr(), part.data_ptr(), bufs.get("gpart", part).data_ptr(), n, m, end,
              int(with_gp), grid.T, grid.tiles, grid.blocks,
              torch.cuda.current_stream(d.device).cuda_stream)
    _build.check_launch(code, "pair_gram_sd")
    pair_gram_sd.launches += 1
    P = reduce_partials(part).reshape(m, 6)
    if with_gp:
        return append_gp(P[:, :3], P[:, 3:], reduce_partials(bufs["gpart"]))
    return P[:, :3], P[:, 3:]


pair_gram_sd.launches = 0


# ---------------------------------------------------------------------------
# K12: OWL-QN pair + Gram update of the composed branch
# ---------------------------------------------------------------------------


def pair_gram_xg_ref(x, xp, gx, gp, pg, S, Y, end: int):
    """Plain version of ``pair_gram_xg``: ``pair_products`` of s = x - xp,
    y = gx - gp and d0 = -pg, the products of row ``end`` from the
    unrounded pair as K12 holds it in registers."""
    pair_gram_xg_ref.calls += 1
    end = _check_row(S, end)
    return pair_products(x - xp, gx - gp, -pg, S, Y, end)


pair_gram_xg_ref.calls = 0


def pair_gram_xg(x, xp, gx, gp, pg, S, Y, end: int):
    """OWL-QN's pair + Gram update for generic objectives (K12): the pair
    of the PROJECTED step, s = x - xp and y = gx - gp, written into ring
    row ``end`` of S and Y in place, rounded to the history dtype, and SP
    = S . [y, s, -pg], YP = Y . [y, s, -pg] ([m, 3]) over the updated
    rings, the new row's products from the unrounded pair
    (``lbfgs_tpu/ops/fused.py:_pair_gram_xg_kernel``)."""
    _check_hist(x, S, Y)
    _check_vectors("pair_gram_xg", x, xp, gx, gp, pg)
    end = _check_row(S, end)
    if not on_cuda(x, "pair_gram_xg"):
        return pair_gram_xg_ref(x, xp, gx, gp, pg, S, Y, end)
    m, n = S.shape
    check_contiguous("pair_gram_xg", x, xp, gx, gp, pg, S, Y)
    lib = _build.load_library()
    blocks = -(-n // lib.lbfgs_pair_gram_block_elems())
    part = torch.empty((blocks, 6 * m), dtype=x.dtype, device=x.device)
    fn = getattr(lib, f"lbfgs_pair_gram_xg_{_SUFFIX[x.dtype]}_{_SUFFIX[S.dtype]}")
    code = fn(x.data_ptr(), xp.data_ptr(), gx.data_ptr(), gp.data_ptr(), pg.data_ptr(),
              S.data_ptr(), Y.data_ptr(), part.data_ptr(), n, m, end,
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(code, "pair_gram_xg")
    pair_gram_xg.launches += 1
    P = reduce_partials(part).reshape(m, 6)
    return P[:, :3], P[:, 3:]


pair_gram_xg.launches = 0


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
    runs it."""
    _check_vectors("axpy_dot", y, x, w)
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
