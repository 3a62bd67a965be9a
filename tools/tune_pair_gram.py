"""Tune and time K5 and K12, the pair + Gram passes, on one CUDA card.

    PYTHONPATH=. python3 tools/tune_pair_gram.py [--per-sm K ...] [--parent DIR [--route]]
                                                 [--screen] [--reps N]

For each launch (at most K blocks per group of ring rows on each of the
H100's 132 SMs, ``fused.PAIR_GRAM_BLOCKS``): K5 and K12 checked against
their plain versions in the three dtype pairs at n = 2^24 and at a ragged
n (``chip_smoke.check_k5_k6`` at the depths of ``chip_smoke.K5_RINGS``,
``chip_smoke.check_k12_depths`` at those of ``chip_smoke.K12_RINGS`` and on
a misaligned view: ring rows and the . gp forms' columns 0-2 bit for bit,
the sums at the sum tolerance), then both forms of each timed at the main
path's shapes (n = 2^24, f32 vectors, bf16 history, m = 6) and at the
deep-history path's (n = 2^20, m = 80; ``chip_smoke.device_time``:
torch.profiler).  Every instantiation's registers and spills come first
(``chip_smoke.pair_gram_compiled``).

With ``--screen`` each launch also runs chip_smoke's K5 and K12 route
phases (n = 2^24, damped, 11 iterations) and prints their end states.

With ``--parent DIR`` (the root of another tree of this repository, e.g. a
``git archive`` of the parent commit unpacked under ``build/``) that tree's
forms are timed in turns with this tree's at ``fused.PAIR_GRAM_BLOCKS``'s
choice (other, this, this, other), and its K12 is held to this tree's:
ring rows bit for bit, sums within the sum tolerance (at n = 2^24 and the
ragged n, m = 6, and at n = 2^20, m = 80).  With ``--route`` as well, the
K5 route, the K12 route and the Poisson main path run through each tree
under torch.profiler in the same turns: device busy ms per iteration, and
the pair + Gram kernel's ms per launch inside the run.

Prints one JSON line per launch and form; the card's nvidia-smi name and
power limit first.
"""

from __future__ import annotations

import argparse
import importlib
import re
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from lbfgs_torch.ops import _build, fused
from tools.tune_epilogues import load_tree

SMS = 132


def forms(fz, a: dict, deep: dict) -> dict:
    """form: K5 or K12 launch of the ``fused`` module ``fz``: at m = 6 on
    a's rings, and at m = 80 (``_m80``) on deep's."""
    out = {}
    for sfx, b in (("", a), ("_m80", deep)):
        n = b["xp0"].shape[0]
        x9 = fused.owlqn_trial_step(b["xp0"], b["d"], torch.sign(b["xp0"]), cs.STP, 0, n - 1)
        k5 = (cs.STP, b["d"], b["pg"], b["gp"], b["S"], b["Y"], cs.END)
        k12 = (x9, b["xp0"], b["pg"], b["gp"], b["xp"], b["S"], b["Y"], cs.END)
        out.update({
            "K5" + sfx: lambda k5=k5: fz.pair_gram_sd(*k5),
            "K5_gp" + sfx: lambda k5=k5: fz.pair_gram_sd(*k5, with_gp=True),
            "K12" + sfx: lambda k12=k12: fz.pair_gram_xg(*k12),
            "K12_gp" + sfx: lambda k12=k12: fz.pair_gram_xg(*k12, with_gp=True),
        })
    return out


def check_all() -> None:
    """K5 (and K6, which ``chip_smoke.check_k5_k6`` checks beside it) and
    K12 against their plain versions in every dtype pair, at both sizes
    and every ring depth of ``chip_smoke.K5_RINGS`` and
    ``chip_smoke.K12_RINGS``; raises on a mismatch."""
    errs = dict.fromkeys(cs.KERNELS, (0.0, 0.0))
    for n in (cs.N_RAGGED, cs.N_BIG):
        for vd, hd in cs.DTYPES:
            a = cs.inputs(n, vd, hd, cs.SEED + n)
            tag = f"n={n} {vd} {hd}"
            cs.check_k5_k6(errs, a, tag, cs.TOL[(vd, "vec")], cs.TOL[(vd, "sum")])
            cs.check_k12_depths(errs, a, tag, cs.TOL[(vd, "sum")])
            del a
            torch.cuda.empty_cache()


def k12_agrees(parent_fused, a: dict) -> dict:
    """The other tree's K12 (both forms) against this tree's on the same
    inputs: ring rows bit for bit, the sums' largest normwise difference
    within the sum tolerance (raises otherwise)."""
    n = a["xp0"].shape[0]
    x9 = fused.owlqn_trial_step(a["xp0"], a["d"], torch.sign(a["xp0"]), cs.STP, 0, n - 1)
    tol, worst = cs.TOL[(a["xp0"].dtype, "sum")], 0.0
    for with_gp in (False, True):
        outs = []
        for fz in (fused, parent_fused):
            S, Y = a["S"].clone(), a["Y"].clone()
            outs.append((fz.pair_gram_xg(x9, a["xp0"], a["pg"], a["gp"], a["xp"], S, Y, cs.END,
                                         with_gp=with_gp), S, Y))
        (mine, Sm, Ym), (theirs, St, Yt) = outs
        if not (cs.same_bits(Sm, St) and cs.same_bits(Ym, Yt)):
            raise AssertionError(f"K12 (with_gp={with_gp}) rings differ from the other tree's")
        for i, (p, q) in enumerate(zip(mine, theirs)):
            worst = max(worst, cs.check(f"K12 (with_gp={with_gp}) output {i} vs the other "
                                        f"tree", p, q, tol)[1])
    return dict(rings="bit-exact", max_normwise_err=worst, tol=tol)


def _package(pkg: str) -> dict:
    """The modules of the package ``pkg`` (``lbfgs_torch`` or another
    tree's) a route run needs."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    return dict(params=mod("params"), rosen=mod("models.rosenbrock"),
                logistic=mod("models.logistic"), ow=mod("orthantwise"),
                minimize_jit=mod("minimize").minimize_jit)


def trial_only(rosen):
    """chip_smoke's ``trial_only_objective`` on the Rosenbrock module
    ``rosen``: trial and probe kernels, no one-pass epilogue."""
    def vag(x):
        return rosen.value_and_grad(x)

    vag.__lbfgs_value_and_grad__ = True
    vag.__lbfgs_trial__ = rosen.trial
    vag.__lbfgs_trial_probe__ = rosen.probe
    vag.__lbfgs_owlqn_trial__ = rosen.owlqn_trial
    vag.__lbfgs_owlqn_probe__ = rosen.owlqn_probe
    vag.__lbfgs_owlqn_probe_pg__ = rosen.owlqn_probe_pg
    return vag


def route_runner(pkg: str, route: str, poisson_data=None):
    """One run of chip_smoke's K5 route (n = 2^24 Rosenbrock, damped, 10
    iterations, no epilogue), K12 route (the same under damped OWL-QN,
    c = 1 on [0, n - 1), Armijo, epsilon 0) or Poisson main path (2048 x
    2^20, 100 iterations, on ``poisson_data``) through the package ``pkg``,
    with that package's own parameters and kernels."""
    p = _package(pkg)
    P = p["params"]
    armijo = P.LineSearchAlgorithm.BacktrackingArmijo
    if route == "poisson":
        X, y = poisson_data
        params = P.LbfgsParams(
            m=cs.M, history_dtype="bfloat16", constrain_step_size=False, epsilon=0.0,
            max_iterations=101, orthantwise=p["ow"].Orthantwise(1.0, 1, cs.POISSON_NCOL),
        ).replace_ls(algorithm=armijo)
        obj = p["logistic"].make_objective(X, y)
        x0 = torch.zeros(cs.POISSON_NCOL, device="cuda")
    else:
        params = P.LbfgsParams(m=cs.M, history_dtype="bfloat16", constrain_step_size=False,
                               epsilon=0.0, max_iterations=11, damping=True)
        if route == "k12":
            params = params.replace(
                orthantwise=p["ow"].Orthantwise(1.0, 0, cs.N_BIG - 1)).replace_ls(
                algorithm=armijo)
        obj = trial_only(p["rosen"])
        x0 = p["rosen"].initial_point(cs.N_BIG, torch.float32, "cuda")
    return lambda: p["minimize_jit"](params, x0, obj, return_state=True)


#: the pair + Gram kernel of each route, by a part of its kernel's name
ROUTE_KERNEL = {"k5": "K5", "k12": "K12", "poisson": "K12"}


def route_profile(run, kernel: str) -> dict:
    """Device busy ms per iteration of one profiled route run (after an
    unprofiled one), and the pair + Gram kernel's device ms per launch in
    it (K5: the kernel without the OWL-QN pair; K12: with it)."""
    run()
    torch.cuda.synchronize()
    prof, st = cs.profiled(run)
    if prof is None:
        raise AssertionError("the profiler recorded no device time")
    iters = st.k - 1
    dev = cs.device_events(prof)
    # this tree's body names K12's instantiations by their last template
    # argument (kXg: "true>" demangled, "ELb1EE" mangled), the other
    # tree's pair_gram_xg_kernel
    is_k12 = lambda key: ("xg" in key or "ELb1EE" in key
                          or re.search(r"pair_gram_kernel<[^>]*true>", key) is not None)
    pg = [e for e in dev if "pair_gram" in e.key and is_k12(e.key) == (kernel == "K12")]
    return dict(iters=iters, evals=st.prob.neval,
                busy_ms_per_iter=sum(e.self_device_time_total for e in dev) / 1e3 / iters,
                kernel_ms=sum(e.self_device_time_total for e in pg) / 1e3
                / max(1, sum(e.count for e in pg)),
                launches=sum(e.count for e in pg))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--per-sm", nargs="*", type=int, default=[1, 2, 3, 4, 6, 8, 16])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--screen", action="store_true")
    ap.add_argument("--route", action="store_true",
                    help="with --parent: the routes' device ms per iteration, in turns")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    _build.load_library()
    try:
        cs.pair_gram_compiled()
    except AssertionError as e:  # reported: chip_smoke.py refuses a spilling build
        cs.emit(compiled_error=str(e)[:600])
    chosen = fused.PAIR_GRAM_BLOCKS
    a = cs.inputs(cs.N_BIG, torch.float32, torch.bfloat16, cs.SEED)
    deep = cs.deep_inputs(torch.float32, torch.bfloat16)
    for k in args.per_sm:
        fused.PAIR_GRAM_BLOCKS = k * SMS
        try:
            check_all()
        except AssertionError as e:  # a launch that fails is reported, not taken
            cs.emit(per_sm=k, error=str(e)[:300])
            continue
        grid = fused.pair_gram_grid(cs.N_BIG, torch.float32, torch.bfloat16)
        for form, fn in forms(fused, a, deep).items():
            ms = min(cs.device_time(fn, args.reps) for _ in range(2))
            cs.emit(per_sm=k, form=form, ms=ms, blocks=grid.blocks, tiles=grid.tiles)
        if args.screen:
            for name, phase in (("k5_route", cs.phase_k5_route),
                                ("k12_route", cs.phase_k12_route)):
                cs.reset_counts()
                try:
                    phase()
                    cs.emit(per_sm=k, screen=name, ok=True)
                except Exception as e:  # the screen records the phase's outcome
                    cs.emit(per_sm=k, screen=name, ok=False,
                            error=f"{type(e).__name__}: {str(e)[:300]}")
                torch.cuda.empty_cache()
    fused.PAIR_GRAM_BLOCKS = chosen
    if args.parent:
        load_tree(args.parent.resolve(), "parent_lbfgs_torch")
        parent = importlib.import_module("parent_lbfgs_torch.ops.fused")
        mine, theirs = forms(fused, a, deep), forms(parent, a, deep)
        for form in mine:
            p1, k1, k2, p2 = (cs.device_time(f, args.reps)
                              for f in (theirs[form], mine[form], mine[form], theirs[form]))
            cs.emit(compare="parent", form=form, parent_ms=min(p1, p2), ms=min(k1, k2),
                    runs=[p1, k1, k2, p2], per_sm=chosen // SMS)
        del mine, theirs
        agree = {"n=2^20 m=80": k12_agrees(parent, deep)}
        for n in (cs.N_BIG, cs.N_RAGGED):
            agree[f"n={n} m=6"] = k12_agrees(parent, cs.inputs(n, torch.float32, torch.bfloat16,
                                                               cs.SEED + n))
        cs.emit(compare="parent", form="K12_agreement", cases=agree)
        del a, deep
        torch.cuda.empty_cache()
        if args.route:
            for route in ("k5", "k12", "poisson"):
                data = None
                if route == "poisson":
                    data = cs.logistic.synthetic(cs.POISSON_NROW, cs.POISSON_NCOL, seed=0,
                                                 device="cuda")
                mine = route_runner("lbfgs_torch", route, data)
                theirs = route_runner("parent_lbfgs_torch", route, data)
                runs = [route_profile(f, ROUTE_KERNEL[route])
                        for f in (theirs, mine, mine, theirs)]
                cs.emit(compare="parent", form=f"{route}_route", runs=runs)
                del data, mine, theirs
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
