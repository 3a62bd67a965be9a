"""The rank side of the port's sharded tests, and the launcher that runs it.

Gloo needs a process per rank, so each test file runs ONE job per world
size (``launch``): W copies of this script, each a rank of a gloo group
over its own free localhost port, run every case of the job on the
plain versions (the CPU) and write their results as JSON; the tests
assert one case each from them.  Every job has its own timeout: the
group's (``init_process_group(timeout=...)``) and the launcher's
(``communicate(timeout=...)``, after which every rank is killed), so a
hang fails its tests and never runs on.

    python tests/_torch_mesh_ranks.py JOB WORLD RANK PORT OUT_DIR

reads OUT_DIR/args.json and writes OUT_DIR/rank<RANK>.json.  This module
imports torch and ``lbfgs_torch`` only (never JAX), so a rank starts in
about a second.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import socket
import subprocess
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Launcher (the pytest side)
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(job: str, world: int, out_dir, args: dict, timeout: float = 240.0) -> list:
    """Run ``job`` on ``world`` gloo ranks; returns each rank's results in
    rank order.  A rank that fails, or a job past ``timeout`` seconds,
    raises with the ranks' output (every rank killed first)."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "args.json"), "w") as f:
        json.dump(dict(args, timeout=timeout), f)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(world), str(r), str(port), out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{job} on {world} ranks ran past {timeout} s") from None
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{job}: rank {r} of {world} failed:\n{out[-4000:]}"
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


@contextlib.contextmanager
def local_mesh():
    """A world-size-1 gloo mesh in this process (an in-memory store), torn
    down after."""
    import torch.distributed as dist

    from lbfgs_torch.parallel import make_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Rank side
# ---------------------------------------------------------------------------


def _bits(a, b) -> bool:
    """a and b hold the same bits (shape, dtype and every element)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return bool(torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def _val(t):
    """A scalar or small tensor as JSON (floats hold float32 exactly)."""
    import torch

    if isinstance(t, torch.Tensor):
        return t.double().tolist() if t.dtype != torch.bool else t.tolist()
    return float(t)


class _Case:
    """One dispatcher case: the single-process call on the whole inputs and
    the mesh call on this rank's shard, its vectors and ring rows compared
    bit for bit, its scalars recorded side by side."""

    def __init__(self, mesh):
        self.mesh, self.bits, self.scalars = mesh, {}, {}

    def shard(self, t):
        from lbfgs_torch.parallel import shard_vector

        return shard_vector(t, self.mesh)

    def vec(self, name, mesh_out, single_out):
        self.bits[name] = _bits(mesh_out, self.shard(single_out))

    def scal(self, name, mesh_out, single_out):
        self.scalars[name] = [_val(mesh_out), _val(single_out)]


def _inputs(n: int, m: int):
    import numpy as np
    import torch

    def r(shape, seed, scale=1.0):
        a = np.random.RandomState(seed).randn(*np.atleast_1d(shape)) * scale
        return torch.from_numpy(a.astype(np.float32))

    return types.SimpleNamespace(
        xp=r(n, 1), d=r(n, 2) * 0.1, gp=r(n, 3), gx=r(n, 4), pg=r(n, 5), x=r(n, 6),
        wp=torch.sign(r(n, 7)), xz=r(n, 8).index_fill_(0, torch.arange(0, n, 5), 0.0),
        S=r((m, n), 9, 0.1).to(torch.bfloat16), Y=r((m, n), 10, 0.1).to(torch.bfloat16),
        cs=r(m, 11), cy=r(m, 12), w=0.5 + r(n, 13).abs(), t=r(n, 14))


def job_kernels(mesh, args: dict) -> dict:
    """Every dispatcher's mesh form against its single-process form on the
    same seeded inputs (f32 vectors, a bf16 ring), the OWL-QN ones on
    each window of ``args["windows"]``, the factory's extras given whole
    and as shards, a body that reads the global index, and a split the
    kernels cannot take."""
    import torch

    from lbfgs_torch.models import rosenbrock, separable
    from lbfgs_torch.ops import factory, fused
    from lbfgs_torch.ops import vecmath as vm
    from lbfgs_torch.parallel import kernels_on_mesh

    n, m = args["n"], args["m"]
    a = _inputs(n, m)
    k = rosenbrock.value_and_grad.kernels
    gamma, ca, cb, c = torch.tensor(0.7), torch.tensor(0.8), torch.tensor(-0.15), 0.8
    out = {}
    ctx_shard = _Case(mesh).shard

    def case(name, fn, vecs=(), scal=(), rings=False):
        # fn(ctx) -> outputs on the inputs the context gives (whole or shard)
        ctx = _Case(mesh)
        S1, Y1 = a.S.clone(), a.Y.clone()
        whole = types.SimpleNamespace(**vars(a), S_=S1, Y_=Y1, sh=lambda t: t)
        single = fn(whole)
        S2, Y2 = ctx.shard(a.S), ctx.shard(a.Y)
        part = types.SimpleNamespace(**{key: ctx.shard(v) if key not in ("cs", "cy") else v
                                        for key, v in vars(a).items()},
                                     S_=S2, Y_=Y2, sh=ctx.shard)
        with kernels_on_mesh(mesh):
            got = fn(part)
        for i in vecs:
            ctx.vec(f"out{i}", got[i], single[i])
        for i in scal:
            ctx.scal(f"out{i}", got[i], single[i])
        if rings:
            ctx.bits["S"] = _bits(S2, ctx.shard(S1))
            ctx.bits["Y"] = _bits(Y2, ctx.shard(Y1))
        out[name] = dict(bits=ctx.bits, scalars=ctx.scalars)

    case("K1_trial", lambda v: k.trial(v.xp, v.d, 0.2), (0, 2), (1, 3, 4, 5, 6))
    case("K2_probe", lambda v: k.probe(v.xp, v.d, 0.2), (), (0, 1))
    case("K3_combine", lambda v: fused.combine(v.d, v.S_, v.Y_, gamma, v.cs, v.cy), (0,),
         (1, 2))
    for gp in (False, True):
        sfx = "_gp" if gp else ""
        case("K4_trial_pair_gram" + sfx, lambda v: k.trial_pair_gram(
            v.xp, v.d, v.gp, 0.6, v.S_, v.Y_, 4, with_gp=gp), (0, 2), (1, 3, 4, 5, 6, 7, 8),
             rings=True)
        case("K5_pair_gram" + sfx, lambda v: fused.pair_gram_sd(
            0.4, v.d, v.gx, v.gp, v.S_, v.Y_, 2, with_gp=gp), (), (0, 1), rings=True)
        case("K12_pair_gram_xg" + sfx, lambda v: fused.pair_gram_xg(
            v.x, v.xp, v.gx, v.gp, v.pg, v.S_, v.Y_, 2, with_gp=gp), (),
             (0, 1, 2, 3) if gp else (0, 1), rings=True)
    case("K6_combine_fix", lambda v: fused.combine_fix(
        v.d, v.S_, v.Y_, gamma, v.cs, v.cy, 4, ca, cb), (0,), (1, 2), rings=True)
    for fix in (None, (4, ca, cb)):
        case("K15_combine_probe" + ("_fix" if fix else ""), lambda v: k.combine_probe(
            v.gp, v.x, v.S_, v.Y_, gamma, v.cs, v.cy, 0.3, fix=fix), (0,), (1, 2, 3, 4),
             rings=True)
    # K17 lies on no solver path and has no mesh form: refused
    with kernels_on_mesh(mesh):
        try:
            fused.axpy_dot(ctx_shard(a.xp), ctx_shard(a.d), 0.3, ctx_shard(a.gp))
            out["K17_on_mesh"] = None
        except NotImplementedError as exc:
            out["K17_on_mesh"] = str(exc)
    case("vecmath", lambda v: (vm.dot(v.xp, v.d), vm.norm2(v.gp),
                               *vm.dots((v.x, v.x), (v.x, v.gp))), (), (0, 1, 2, 3))
    for wname, (lo, hi) in args["windows"].items():
        sfx = "_" + wname
        case("K7_owlqn_trial" + sfx, lambda v: k.owlqn_trial(
            v.xz, v.d, v.wp, 0.37, c, lo, hi), (0, 2), (1, 3, 4, 5))
        case("K8_owlqn_probe" + sfx, lambda v: k.owlqn_probe(
            v.xz, v.d, v.wp, 0.37, c, lo, hi), (), (0, 1))
        case("K8_owlqn_probe_pg" + sfx, lambda v: k.owlqn_probe_pg(
            v.xz, v.d, v.pg, 0.37, c, lo, hi), (), (0, 1))
        case("K9_owlqn_trial_step" + sfx, lambda v: (fused.owlqn_trial_step(
            v.xp, v.d, v.wp, 0.3, lo, hi),), (0,))
        case("K10_pseudo_gradient_norm" + sfx, lambda v: fused.pseudo_gradient_norm(
            v.xz, v.gx, c, lo, hi), (0,), (1,))
        case("K11_pseudo_gradient" + sfx, lambda v: (fused.pseudo_gradient(
            v.xz, v.gx, c, lo, hi),), (0,))
        case("K13_combine_ow" + sfx, lambda v: fused.combine_ow(
            v.pg, v.S_, v.Y_, -gamma, v.cs, v.cy, lo, hi), (0,), (1, 2, 3))
        for gp in (False, True):
            case("K14_owlqn_trial_pair_gram" + ("_gp" if gp else "") + sfx,
                 lambda v: k.owlqn_trial_pair_gram(v.xz, v.d, v.gp, v.pg, 0.37, c, lo, hi,
                                                   v.S_, v.Y_, 2, with_gp=gp),
                 (0, 1, 2), (3, 4, 5, 6, 7) + ((8, 9) if gp else ()), rings=True)
        case("K16_combine_ow_probe" + sfx, lambda v: k.combine_ow_probe(
            v.pg, v.xz, v.S_, v.Y_, -gamma, v.cs, v.cy, c, lo, hi, 0.3), (0,),
             (1, 2, 3, 4, 5))

    # the quadratic's two extras: given whole (each rank narrows them to
    # its shard) and as the shards themselves
    quad = separable.quadratic(a.w, a.t)
    case("quadratic_extras", lambda v: quad.kernels.trial(v.xp, v.d, 0.37), (0, 2),
         (1, 3, 4, 5, 6))
    sharded = separable.quadratic(_Case(mesh).shard(a.w), _Case(mesh).shard(a.t))
    case("quadratic_extras_shards", lambda v: (quad if v.sh(a.w) is a.w else sharded)
         .kernels.trial(v.xp, v.d, 0.37), (0, 2), (1, 3, 4, 5, 6))
    case("quadratic_epilogue", lambda v: quad.kernels.trial_pair_gram(
        v.xp, v.d, v.gp, 0.3, v.S_, v.Y_, 1), (0, 2), (1, 3, 4, 5, 6, 7, 8), rings=True)

    # a body that reads the global element index
    def gidx_ref(x, gidx):
        w = 1.0 + 0.1 * (gidx % 7).to(x.dtype)
        return 0.5 * (w * (x * x)), w * x

    def no_triton():
        raise AssertionError("the CPU runs the plain versions")

    gobj = factory.make_fused_objective(no_triton, block_ref=gidx_ref)
    case("gidx_body", lambda v: gobj.kernels.trial(v.xp, v.d, 0.4), (0, 2), (1, 3, 4, 5))
    ctx = _Case(mesh)
    xt = ctx.shard(a.xp + 0.4 * a.d)
    _, g_no_off = factory._block_eval(gidx_ref, xt, 0, (), 1)
    _, g_whole = factory._block_eval(gidx_ref, a.xp + 0.4 * a.d, 0, (), 1)
    out["gidx_body"]["without_offset_matches"] = _bits(g_no_off, ctx.shard(g_whole))

    # a shard the kernels cannot take: odd, against Rosenbrock's rows of 2
    bad = torch.zeros(args["n_bad"] // mesh.size)
    with kernels_on_mesh(mesh):
        try:
            k.trial(bad, bad, 0.1)
            out["bad_split"] = None
        except ValueError as exc:
            out["bad_split"] = str(exc)
    return out


def _params(cfg: dict):
    from lbfgs_torch.orthantwise import Orthantwise
    from lbfgs_torch.params import LbfgsParams

    ls = ("algorithm", "speculative")
    p = LbfgsParams(**{key: v for key, v in cfg.items() if key != "orthantwise"
                       and key not in ls})
    if "orthantwise" in cfg:
        p = p.replace(orthantwise=Orthantwise(*cfg["orthantwise"]))
    return p.replace_ls(**{key: cfg[key] for key in ls if key in cfg})


def fx_trace(run):
    """``run()`` with fx recorded after every iteration: (its result, the
    list of fx)."""
    from lbfgs_torch import minimize

    trace, hot = [], minimize.propagate_hot

    def step(*a):
        st = hot(*a)
        trace.append(float(st.prob.fx))
        return st

    minimize.propagate_hot = step
    try:
        return run(), trace
    finally:
        minimize.propagate_hot = hot


def _run(mesh, params, x0):
    """One sharded ``minimize_jit`` from x0 (whole, on the CPU): its state,
    x gathered after the run, the mesh's counts of that run split into
    the init's and the iterations', and fx after each iteration."""
    from lbfgs_torch import solver
    from lbfgs_torch.core import ProblemDef
    from lbfgs_torch.linesearch import carried
    from lbfgs_torch.minimize import _run_while
    from lbfgs_torch.models import rosenbrock
    from lbfgs_torch.parallel import gather_vector, kernels_on_mesh, shard_vector

    pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad, owlqn=params.orthantwise)
    xs = shard_vector(x0, mesh)
    mesh.reset_counts()
    carried.used = 0
    with kernels_on_mesh(mesh):
        st = solver.init_state(pdef, params, xs, lean=True)
        init = mesh.collectives
        st, trace = fx_trace(lambda: _run_while(pdef, params, st))
    counts = dict(init=init, iterations=mesh.collectives - init, gathers=mesh.gathers,
                  bytes=mesh.collective_bytes, carried=carried.used)
    return st, gather_vector(st.prob.x, mesh), counts, trace


def _summary(st, x) -> dict:
    import hashlib

    import numpy as np

    return dict(k=int(st.k), neval=int(st.prob.neval), status=int(st.status),
                fx=float(st.prob.fx), fx_hex=float(st.prob.fx).hex(),
                x_sha=hashlib.sha256(np.ascontiguousarray(x.numpy()).tobytes()).hexdigest())


def job_runs(mesh, args: dict) -> dict:
    """Whole sharded ``minimize_jit`` runs of Rosenbrock from its start,
    one per path of ``args["paths"]`` (LbfgsParams fields), at the dtype
    of ``args["dtype"]``: each run's iterations, evaluations, fx, x
    (rank 0 writes it to OUT_DIR/<path>.npy) and its collectives; at world
    size 1 also the run with no mesh.  With
    ``args["resume"]`` (a pickled JAX state with numpy leaves and its
    path), the run resumed from this rank's shard of it through
    ``LbfgsState``, and whether ``gather_state`` of ``shard_state`` gives
    that state back bit for bit."""
    import pickle

    import numpy as np
    import torch

    from lbfgs_torch.core import ProblemDef
    from lbfgs_torch.interop import state_from_jax
    from lbfgs_torch.minimize import LbfgsState, minimize_jit
    from lbfgs_torch.models import rosenbrock
    from lbfgs_torch.parallel import gather_state, gather_vector, kernels_on_mesh, shard_state
    from lbfgs_torch.utils.checkpoint import fields

    dtype = getattr(torch, args["dtype"])
    x0 = rosenbrock.initial_point(args["n"], dtype, device="cpu")
    out = {}
    for name, cfg in args["paths"].items():
        params = _params(cfg)
        st, x, counts, trace = _run(mesh, params, x0)
        res = dict(_summary(st, x), collectives=counts, fx_trace=trace)
        if mesh.rank == 0:
            np.save(os.path.join(args["out_dir"], f"{name}.npy"), x.numpy())
        if mesh.size == 1:
            solo = minimize_jit(params, x0.clone(), rosenbrock.value_and_grad, return_state=True)
            res["solo"] = _summary(solo, solo.prob.x)
        out[name] = res
    if args.get("resume"):
        with open(args["resume"]["state"], "rb") as f:
            tree = pickle.load(f)
        params = _params(args["resume"]["params"])
        pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad, owlqn=params.orthantwise)
        whole = state_from_jax(tree, "cpu")
        back = gather_state(shard_state(whole, mesh), mesh)
        out["state_round_trip"] = all(
            (_bits(a, b) if isinstance(a, torch.Tensor) else a == b)
            for (_, a), (_, b) in zip(fields(whole), fields(back)))
        state = LbfgsState(pdef, params, state_from_jax(tree, "cpu", mesh=mesh))
        with kernels_on_mesh(mesh):
            while not state.is_converged():
                state.propagate()
        st = state.state
        x = gather_vector(st.prob.x, mesh)
        if mesh.rank == 0:
            np.save(os.path.join(args["out_dir"], "resume.npy"), x.numpy())
        out["resume"] = _summary(st, x)
    return out


def poisson_data(nrow: int, ncol: int, seed: int):
    """The generic tests' Poisson regression data, float64, made with numpy
    from ``seed`` (the same on every rank and in the test process): X with
    an intercept column, y Poisson counts of a sparse true beta."""
    import numpy as np

    rng = np.random.RandomState(seed)
    X = rng.randn(nrow, ncol) * 0.3
    X[:, 0] = 1.0
    beta = np.zeros(ncol)
    beta[1:9] = 0.4 * (-1.0) ** np.arange(8)
    y = rng.poisson(np.exp(np.clip(X @ beta, -6, 6))).astype(float)
    return X, y


def generic_problem(model: str, args: dict, mesh=None):
    """(objective, whole x0) of a generic model under the local contract:
    ``rosenbrock`` (``generic_value_and_grad`` at args["n"]) or ``poisson``
    (``logistic.make_objective`` over this rank's column block of the
    seeded X, or the whole X with no mesh), float64 unless
    args["dtype"] says otherwise."""
    import torch

    from lbfgs_torch.models import logistic, rosenbrock
    from lbfgs_torch.parallel import shard_vector

    dtype = getattr(torch, args.get("dtype", "float64"))
    if model == "rosenbrock":
        return rosenbrock.generic_value_and_grad, rosenbrock.initial_point(
            args["n"], dtype, device="cpu")
    X, y = (torch.from_numpy(a).to(dtype) for a in poisson_data(*args["poisson"]))
    return (logistic.make_objective(X if mesh is None else shard_vector(X, mesh), y),
            torch.zeros(X.shape[1], dtype=dtype))


def _generic_run(mesh, params, obj, x0, stepwise: bool = False):
    """One sharded run of a generic objective from x0 (whole): through
    ``minimize_jit`` (or, ``stepwise``, ``LbfgsState`` step by step, as
    ``minimize`` runs it); its state, x gathered after the run and the
    mesh's counts of the run (the init's, the iterations', gathers)."""
    from lbfgs_torch import solver
    from lbfgs_torch.core import ProblemDef, normalize_objective
    from lbfgs_torch.minimize import LbfgsState, _run_while
    from lbfgs_torch.parallel import gather_vector, kernels_on_mesh, shard_vector

    pdef = ProblemDef(value_and_grad=normalize_objective(obj), owlqn=params.orthantwise)
    xs = shard_vector(x0, mesh)
    mesh.reset_counts()
    with kernels_on_mesh(mesh):
        if stepwise:
            state = LbfgsState(pdef, params, solver.init_state(pdef, params, xs))
            init = mesh.collectives
            while not state.is_converged():
                state.propagate()
            st = state.state
        else:
            st = solver.init_state(pdef, params, xs, lean=True)
            init = mesh.collectives
            st = _run_while(pdef, params, st)
    counts = dict(init=init, iterations=mesh.collectives - init, gathers=mesh.gathers)
    return st, gather_vector(st.prob.x, mesh), counts


def job_generic(mesh, args: dict) -> dict:
    """Whole runs of the generic Rosenbrock and the column-split Poisson
    regression under the local contract, one per path of
    ``args["paths"]`` (model -> {name: LbfgsParams fields}): each run's
    iterations, evaluations, fx, x (rank 0 writes it to
    OUT_DIR/<model>_<name>.npy) and collectives, through ``minimize_jit``
    and, for the paths named in ``args["stepwise"]``, step by step
    (``LbfgsState``); at world size 1 also the run with no mesh.  Then the refusals: an objective without the contract, and a
    Rosenbrock shard of odd length."""
    import numpy as np

    from lbfgs_torch.minimize import minimize_jit
    from lbfgs_torch.models import rosenbrock
    from lbfgs_torch.parallel import kernels_on_mesh, shard_vector

    out = {}
    for model, paths in args["paths"].items():
        obj, x0 = generic_problem(model, args, mesh)
        for name, cfg in paths.items():
            params = _params(cfg)
            st, x, counts = _generic_run(mesh, params, obj, x0)
            res = dict(_summary(st, x), collectives=counts)
            if f"{model}_{name}" in args.get("stepwise", ()):
                st2, x2, _ = _generic_run(mesh, params, obj, x0, stepwise=True)
                res["stepwise"] = _summary(st2, x2)
            if mesh.rank == 0:
                np.save(os.path.join(args["out_dir"], f"{model}_{name}.npy"), x.numpy())
            if mesh.size == 1:
                solo_obj, _ = generic_problem(model, args)
                solo = minimize_jit(params, x0.clone(), solo_obj, return_state=True)
                res["solo"] = _summary(solo, solo.prob.x)
            out[f"{model}_{name}"] = res
    x0 = shard_vector(rosenbrock.initial_point(args["n"], device="cpu"), mesh)
    with kernels_on_mesh(mesh):
        try:
            minimize_jit(_params({}), x0, lambda x: ((x * x).sum(), 2 * x))
            out["refused"] = None
        except NotImplementedError as exc:
            out["refused"] = str(exc)
        try:
            rosenbrock.generic_value_and_grad(x0[:-1])
            out["odd_shard"] = None
        except ValueError as exc:
            out["odd_shard"] = str(exc)
    return out


def checkpoint_case(case: dict, mesh=None):
    """(params, objective, whole x0) of a checkpoint case: a generic model
    of ``generic_problem`` with its LbfgsParams fields and dtype."""
    obj, x0 = generic_problem(case["model"], case, mesh)
    return _params(case["params"]), obj, x0


def _until(state, k: int = None) -> None:
    """Propagate ``state`` (an ``LbfgsState``) to iteration k, or to its
    end."""
    while not state.is_converged() and (k is None or state.state.k < k):
        state.propagate()


def _state_bits(a, b) -> bool:
    """Two states hold the same slots, tensors bit for bit (dtype too)."""
    import numpy as np
    import torch

    from lbfgs_torch.utils.checkpoint import fields

    for (ka, va), (kb, vb) in zip(fields(a), fields(b)):
        if ka != kb or (va is None) != (vb is None):
            return False
        if isinstance(va, torch.Tensor):
            if not _bits(va.cpu(), vb.cpu()):
                return False
        elif va is not None and not np.array_equal(np.asarray(va), np.asarray(vb)):
            return False
    return True


def job_checkpoint(mesh, args: dict) -> dict:
    """Sharded checkpoints.  ``args["mode"]`` "save": each case of
    ``args["cases"]`` runs to iteration ``args["at"]`` through
    ``LbfgsState`` on this rank's shard and is saved with ``save_state``
    under the mesh into ``<dir>/<case>_w<W>``; rank 0 also writes the
    gathered whole state with no mesh (``<case>_w<W>_whole.npz``); the run
    then goes on to its end.  "load": for each (case, source, whole) of
    ``args["loads"]`` the checkpoint ``source`` is loaded under the mesh
    into this rank's fresh state (the gathers of the load counted), the
    loaded state gathered against ``whole`` loaded with no mesh (bit for
    bit), and two runs resumed to their ends, one from the loaded state and
    one from ``shard_state`` of the whole; beside them the run of the same
    case uninterrupted.  With ``args["mismatch"]`` a template with another
    m or n must raise ``ValueError``."""
    import torch

    from lbfgs_torch.minimize import LbfgsState
    from lbfgs_torch.parallel import gather_state, gather_vector, kernels_on_mesh, shard_state
    from lbfgs_torch.parallel import shard_vector
    from lbfgs_torch.utils.checkpoint import load_state, save_state

    root, out = args["dir"], {}

    def build(params, obj, x0):
        with kernels_on_mesh(mesh):
            return LbfgsState.build(params, shard_vector(x0, mesh), obj)

    def finish(state):
        # the run to its end (its gathers counted), then x gathered
        before = mesh.gathers
        with kernels_on_mesh(mesh):
            _until(state)
        st = state.state
        return dict(_summary(st, gather_vector(st.prob.x, mesh)),
                    gathers=mesh.gathers - 1 - before)

    if args["mode"] == "save":
        for name, case in args["cases"].items():
            params, obj, x0 = checkpoint_case(case, mesh)
            state = build(params, obj, x0)
            with kernels_on_mesh(mesh):
                _until(state, args["at"])
                mesh.reset_counts()
                save_state(os.path.join(root, f"{name}_w{mesh.size}"), state.state)
                gathers = mesh.gathers
            whole = gather_state(state.state, mesh)
            if mesh.rank == 0:
                save_state(os.path.join(root, f"{name}_w{mesh.size}_whole.npz"), whole)
            out[name] = dict(saved_k=int(state.state.k), save_gathers=gathers,
                             uninterrupted=finish(state))
        return out
    for name, src, whole_path in args["loads"]:
        case = args["cases"][name]
        params, obj, x0 = checkpoint_case(case, mesh)
        template = build(params, obj, x0)
        mesh.reset_counts()
        with kernels_on_mesh(mesh):
            loaded = load_state(src, template.state)
        load_gathers = mesh.gathers
        wparams, wobj, _ = checkpoint_case(case)
        whole = load_state(whole_path, LbfgsState.build(wparams, x0.clone(), wobj).state)
        same = _state_bits(gather_state(loaded, mesh), whole)
        a = LbfgsState(template.pdef, params, loaded)
        b = LbfgsState(template.pdef, params, shard_state(whole, mesh))
        out[f"{name}<-{os.path.basename(src)}"] = dict(
            loaded_bits=same, load_gathers=load_gathers, resumed=finish(a),
            resumed_from_shard_state=finish(b), uninterrupted=finish(build(params, obj, x0)))
    if args.get("mismatch"):
        name, src = args["mismatch"]
        case = args["cases"][name]
        params, obj, x0 = checkpoint_case(case, mesh)
        out["mismatch"] = {}
        for what, p, x in (("m", params.replace(m=params.m - 2), x0),
                           ("n", params, torch.cat([x0, x0[:2 * mesh.size]]))):
            try:
                with kernels_on_mesh(mesh):
                    load_state(src, build(p, obj, x).state)
                out["mismatch"][what] = None
            except ValueError as exc:
                out["mismatch"][what] = str(exc)
    return out


def job_ragged(mesh, args: dict) -> dict:
    """A ring sharded at a width off a multiple of 16: the run with no mesh
    to ``args["at"]`` iterations (its state), ``shard_state`` of that state
    (whether the ring shards have the padded layout for the shard's own
    width, zero pads and the whole ring's values), then the run continued
    on the mesh to ``args["iters"]`` (its summary, x on rank 0, and whether
    the pads stay zero) beside the same continuation with no mesh, and
    ``gather_state`` of the result (the whole rings' layout and values)."""
    import numpy as np
    import torch

    from lbfgs_torch.core import ProblemDef, is_ring, ring_stride
    from lbfgs_torch.minimize import _run_while
    from lbfgs_torch.models import rosenbrock
    from lbfgs_torch.parallel import gather_state, gather_vector, kernels_on_mesh, shard_state
    from lbfgs_torch.parallel import shard_vector
    from lbfgs_torch import solver

    def pads_zero(R):
        m, k = R.shape
        ld = R.stride(0)
        return bool((R.as_strided((m, ld), (ld, 1))[:, k:] == 0).all())

    params = _params(args["params"])
    pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad, owlqn=params.orthantwise)
    x0 = rosenbrock.initial_point(args["n"], torch.float64, device="cpu")
    st = _run_while(pdef, params.replace(max_iterations=args["at"]),
                    solver.init_state(pdef, params, x0, lean=True))
    st = st._replace(status=0)

    def resume(s):
        # the run continued step by step to args["iters"] iterations
        while s.status == 0 and s.k < args["iters"]:
            s = solver.propagate_hot(pdef, params, s)
        return s

    # the shards first: a lean run writes its state's buffers in place
    part = shard_state(st, mesh)
    k = part.prob.x.shape[0]
    out = dict(k_local=k, stride=[list(part.hist.s.stride()), list(part.hist.y.stride())],
               want_stride=ring_stride(k),
               layout=all(is_ring(R) for R in (part.hist.s, part.hist.y)),
               pads_zero=all(pads_zero(R) for R in (part.hist.s, part.hist.y)),
               values=all(_bits(R, shard_vector(W, mesh))
                          for R, W in ((part.hist.s, st.hist.s), (part.hist.y, st.hist.y))))
    solo = resume(st)
    with kernels_on_mesh(mesh):
        done = resume(part)
    x = gather_vector(done.prob.x, mesh)
    out["pads_zero_after"] = all(pads_zero(R) for R in (done.hist.s, done.hist.y))
    out["layout_after"] = all(is_ring(R) for R in (done.hist.s, done.hist.y))
    # the whole state gathered back: its rings in the padded layout of the
    # whole width, each rank's columns its shard's
    back = gather_state(done, mesh)
    whole = (back.hist.s, back.hist.y)
    out["gathered_stride"] = [list(R.stride()) for R in whole]
    out["gathered_layout"] = all(is_ring(R) and pads_zero(R) for R in whole)
    out["gathered_values"] = all(_bits(W.narrow(-1, mesh.rank * k, k), R) for W, R in
                                 zip(whole, (done.hist.s, done.hist.y)))
    out["run"] = _summary(done, x)
    out["solo"] = _summary(solo, solo.prob.x)
    if mesh.rank == 0:
        np.save(os.path.join(args["out_dir"], "x.npy"), x.numpy())
        np.save(os.path.join(args["out_dir"], "x_solo.npy"), solo.prob.x.numpy())
    return out


JOBS = {"kernels": job_kernels, "runs": job_runs, "generic": job_generic,
        "checkpoint": job_checkpoint, "ragged": job_ragged}


def main() -> None:
    job, world, rank, port, out_dir = sys.argv[1], *map(int, sys.argv[2:5]), sys.argv[5]
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    from lbfgs_torch.parallel import init_distributed, make_mesh

    with open(os.path.join(out_dir, "args.json")) as f:
        args = dict(json.load(f), out_dir=out_dir)
    init_distributed(backend="gloo", init_method=f"tcp://localhost:{port}",
                     world_size=world, rank=rank,
                     timeout=datetime.timedelta(seconds=args["timeout"]))
    try:
        res = JOBS[job](make_mesh(), args)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
