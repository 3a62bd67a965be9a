"""Tune and time K5, the pair + Gram pass, on one CUDA card.

    PYTHONPATH=. python3 tools/tune_pair_gram.py [--per-sm K ...] [--parent DIR [--route]]
                                                 [--screen] [--reps N]

For each launch (at most K blocks on each of the H100's 132 SMs,
``fused.PAIR_GRAM_BLOCKS``): K5's two forms (3 columns, and the . gp
column as the K5 route runs it) checked against the plain version in
the three dtype pairs at n = 2^24 and at a ragged n, at the ring depths
of ``chip_smoke.K5_RINGS`` (``chip_smoke.check_k5``: ring rows and the
. gp form's columns 0-2 bit for bit, the sums at the sum tolerance), then
timed at the main path's shapes (n = 2^24, f32 vectors, bf16 history,
m = 6; ``chip_smoke.device_time``: torch.profiler).  Every instantiation's
registers and spills come first (``chip_smoke.pair_gram_compiled``).

With ``--screen`` each launch also runs chip_smoke's K5 route phase
(n = 2^24, damped, 11 iterations) and prints its end state.

With ``--parent DIR`` (the root of another tree of this repository, e.g. a
``git archive`` of the parent commit unpacked under ``build/``) that tree's
K5 forms are timed in turns with this tree's at ``fused.PAIR_GRAM_BLOCKS``'s
choice (parent, this, this, parent), and its K12 is held to this tree's
bit for bit (sums and rings, at n = 2^24 and the ragged n).  With
``--route`` as well, the K5 route runs through each tree under
torch.profiler in the same turns: device busy ms per iteration, and K5's
ms per launch inside the run.

Prints one JSON line per launch and form; the card's nvidia-smi name and
power limit first.
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from lbfgs_torch.ops import _build, fused
from tools.tune_epilogues import load_tree

SMS = 132


def forms(fz, a: dict) -> dict:
    """form: K5 launch of the ``fused`` module ``fz`` on a's rings."""
    args = (cs.STP, a["d"], a["pg"], a["gp"], a["S"], a["Y"], cs.END)
    return {"K5": lambda: fz.pair_gram_sd(*args),
            "K5_gp": lambda: fz.pair_gram_sd(*args, with_gp=True)}


def check_all() -> None:
    """K5 (and K6, which ``chip_smoke.check_k5_k6`` checks beside it)
    against its plain version in every dtype pair, at both sizes and every
    ring depth of ``chip_smoke.K5_RINGS``; raises on a mismatch."""
    errs = dict.fromkeys(cs.KERNELS, (0.0, 0.0))
    for n in (cs.N_RAGGED, cs.N_BIG):
        for vd, hd in cs.DTYPES:
            a = cs.inputs(n, vd, hd, cs.SEED + n)
            cs.check_k5_k6(errs, a, f"n={n} {vd} {hd}", cs.TOL[(vd, "vec")],
                           cs.TOL[(vd, "sum")])
            del a
            torch.cuda.empty_cache()


def k12_same(parent_fused, n: int) -> bool:
    """The other tree's K12 against this tree's on the same inputs, sums
    and rings bit for bit."""
    a = cs.inputs(n, torch.float32, torch.bfloat16, cs.SEED + n)
    x9 = fused.owlqn_trial_step(a["xp0"], a["d"], a["pg"], cs.STP, 0, n - 1)
    outs = []
    for fz in (fused, parent_fused):
        S, Y = a["S"].clone(), a["Y"].clone()
        outs.append((*fz.pair_gram_xg(x9, a["xp0"], a["pg"], a["gp"], a["xp"], S, Y, cs.END),
                     S, Y))
    return all(cs.same_bits(p, q) for p, q in zip(*outs))


def route_runner(pkg: str):
    """One K5 route run (chip_smoke's: n = 2^24 Rosenbrock, damped, 10
    iterations, on an objective with the trial and probe kernels but no
    epilogue) through the package ``pkg`` (``lbfgs_torch`` or another
    tree's), with that package's own parameters and kernels."""
    params = importlib.import_module(pkg + ".params").LbfgsParams(
        m=cs.M, history_dtype="bfloat16", constrain_step_size=False, epsilon=0.0,
        max_iterations=11, damping=True)
    rosen = importlib.import_module(pkg + ".models.rosenbrock")
    minimize_jit = importlib.import_module(pkg + ".minimize").minimize_jit

    def vag(x):
        return rosen.value_and_grad(x)

    vag.__lbfgs_value_and_grad__ = True
    vag.__lbfgs_trial__ = rosen.trial
    vag.__lbfgs_trial_probe__ = rosen.probe
    x0 = rosen.initial_point(cs.N_BIG, torch.float32, "cuda")
    return lambda: minimize_jit(params, x0, vag, return_state=True)


def route_profile(run) -> dict:
    """Device busy ms per iteration of one profiled K5 route run (after an
    unprofiled one), and K5's device ms per launch in it."""
    run()
    torch.cuda.synchronize()
    prof, st = cs.profiled(run)
    if prof is None:
        raise AssertionError("the profiler recorded no device time")
    iters = st.k - 1
    dev = cs.device_events(prof)
    k5 = [e for e in dev if "pair_gram" in e.key and "xg" not in e.key]
    return dict(iters=iters, busy_ms_per_iter=sum(e.self_device_time_total for e in dev)
                / 1e3 / iters,
                k5_ms=sum(e.self_device_time_total for e in k5) / 1e3
                / max(1, sum(e.count for e in k5)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--per-sm", nargs="*", type=int, default=[1, 2, 3, 4, 6, 8, 16])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--screen", action="store_true")
    ap.add_argument("--route", action="store_true",
                    help="with --parent: the K5 route's device ms per iteration, in turns")
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
    for k in args.per_sm:
        fused.PAIR_GRAM_BLOCKS = k * SMS
        try:
            check_all()
        except AssertionError as e:  # a launch that fails is reported, not taken
            cs.emit(per_sm=k, error=str(e)[:300])
            continue
        grid = fused.pair_gram_grid(cs.N_BIG, torch.float32, torch.bfloat16)
        for form, fn in forms(fused, a).items():
            ms = min(cs.device_time(fn, args.reps) for _ in range(2))
            cs.emit(per_sm=k, form=form, ms=ms, blocks=grid.blocks, tiles=grid.tiles)
        if args.screen:
            cs.reset_counts()
            try:
                out = cs.phase_k5_route()
                cs.emit(per_sm=k, screen="k5_route", ok=True, launches=out["K5_pair_gram"])
            except Exception as e:  # the screen records the phase's outcome
                cs.emit(per_sm=k, screen="k5_route", ok=False,
                        error=f"{type(e).__name__}: {str(e)[:300]}")
            torch.cuda.empty_cache()
    fused.PAIR_GRAM_BLOCKS = chosen
    if args.parent:
        load_tree(args.parent.resolve(), "parent_lbfgs_torch")
        parent = importlib.import_module("parent_lbfgs_torch.ops.fused")
        mine, theirs = forms(fused, a), forms(parent, a)
        for form in mine:
            p1, k1, k2, p2 = (cs.device_time(f, args.reps)
                              for f in (theirs[form], mine[form], mine[form], theirs[form]))
            cs.emit(compare="parent", form=form, parent_ms=min(p1, p2), ms=min(k1, k2),
                    runs=[p1, k1, k2, p2], per_sm=chosen // SMS)
        cs.emit(compare="parent", form="K12_bits",
                same={n: k12_same(parent, n) for n in (cs.N_BIG, cs.N_RAGGED)})
        if args.route:
            mine, theirs = route_runner("lbfgs_torch"), route_runner("parent_lbfgs_torch")
            runs = [route_profile(f) for f in (theirs, mine, mine, theirs)]
            cs.emit(compare="parent", form="k5_route", runs=runs)


if __name__ == "__main__":
    main()
