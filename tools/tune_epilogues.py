"""Tune and time the epilogues K4 and K14 on one CUDA card.

    PYTHONPATH=. python3 tools/tune_epilogues.py [--configs T:V:WARPS:STAGES:PER_SM ...]
                                                 [--parent DIR] [--reps N]

At the main path's shapes (n = 2^24, f32 vectors, bf16 history, m = 6),
for each launch configuration of ``factory.EPILOGUE[(float32, bfloat16)]`` (T
elements per tile, V consecutive elements per thread, warps, pipeline
stages, programs per SM): each
form's (K4, K4 with the . gp column, K14, K14 . gp) registers and spills
from the compiled Triton kernel, its PTX's global loads by width, its
outputs against the plain version (ring rows, and the . gp form's columns
0-2 against the 3-column launch, bit for bit; the sums at the normwise sum
tolerance) at n = 2^24 and at a ragged n, and its device time
(``chip_smoke.device_time``: torch.profiler).  Then the float32-history
and float64 forms under the launches of ``--other`` in turn, checked the
same way, until one spills no register.

With ``--parent DIR`` (the root of another tree of this repository, e.g. a
``git archive`` of the parent commit unpacked under ``build/``) that tree's
four forms are timed in turns with this tree's at ``factory.EPILOGUE``'s
choice: parent, this, this, parent.

Prints one JSON line per configuration and form; the card's nvidia-smi name
and power limit first.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from lbfgs_torch.models import rosenbrock
from lbfgs_torch.ops import factory

N_RAGGED = 3_000_002
FORMS = ("K4", "K4_gp", "K14", "K14_gp")


def load_tree(root: Path, name: str):
    """The Rosenbrock objective of the ``lbfgs_torch`` package under
    ``root``, imported as the top-level package ``name``."""
    spec = importlib.util.spec_from_file_location(
        name, root / "lbfgs_torch" / "__init__.py",
        submodule_search_locations=[str(root / "lbfgs_torch")])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(name + ".models.rosenbrock")


def launchers(rosen, a: dict, n: int) -> dict:
    """form: (kernel launch, plain launch), each on rings of its own."""
    S, Y, hi = a["S"], a["Y"], n - 1

    def k4(with_gp, fn):
        return lambda S=S, Y=Y: fn(a["xp"], a["d"], a["gp"], cs.STP, S, Y, cs.END,
                                   with_gp=with_gp)

    def k14(with_gp, fn):
        return lambda S=S, Y=Y: fn(a["xp0"], a["d"], a["gp"], a["pg"], cs.STP, 1.0, 0, hi,
                                   S, Y, cs.END, with_gp=with_gp)

    return {
        "K4": (k4(False, rosen.trial_pair_gram), k4(False, rosen.trial_pair_gram_ref)),
        "K4_gp": (k4(True, rosen.trial_pair_gram), k4(True, rosen.trial_pair_gram_ref)),
        "K14": (k14(False, rosen.owlqn_trial_pair_gram),
                k14(False, rosen.owlqn_trial_pair_gram_ref)),
        "K14_gp": (k14(True, rosen.owlqn_trial_pair_gram),
                   k14(True, rosen.owlqn_trial_pair_gram_ref)),
    }


def check(n: int, vd, hd) -> None:
    """Every form against its plain version at n; raises on a mismatch."""
    a = cs.inputs(n, vd, hd, cs.SEED + n)
    ts = cs.TOL[(vd, "sum")]
    run = launchers(rosenbrock, a, n)
    outs = {}
    for form, (kern, plain) in run.items():
        Sk, Yk, Sp, Yp = (a["S"].clone(), a["Y"].clone(), a["S"].clone(), a["Y"].clone())
        k, p = kern(Sk, Yk), plain(Sp, Yp)
        tag = f"{form} n={n} {vd} {hd}"
        if form.startswith("K4"):
            s, y = cs.STP * a["d"], k[2] - a["gp"]
            sums = (1, 3, 4, 5, 7, 8)
        else:
            s, y = k[0] - a["xp0"], k[1] - a["gp"]
            sums = (3, 4, 5, 6) + ((8, 9) if form.endswith("gp") else ())
        cs.check_ring(tag, Sk, Yk, a["S"], a["Y"], s, y)
        for i in sums:
            cs.check(f"{tag} sum{i}", k[i], p[i], ts)
        outs[form] = (k, Sk, Yk)
    for base in ("K4", "K14"):
        k3, S3, Y3 = outs[base]
        k4, S4, Y4 = outs[base + "_gp"]
        cols = (7, 8) if base == "K4" else (3, 4)
        cs.check_extends(f"{base}+gp n={n}", k3, k4[:len(k3)], cols)
        if not (cs.same_bits(S3, S4) and cs.same_bits(Y3, Y4)):
            raise AssertionError(f"{base}+gp ring differs from the 3-column launch n={n}")


def compiled_info(vd, hd) -> dict:
    """form: registers, spills and the PTX's global loads by vector width of
    the last compiled kernel of each form."""
    out = {}
    for form in FORMS:
        fn = rosenbrock.trial_pair_gram if form.startswith("K4") else \
            rosenbrock.owlqn_trial_pair_gram
        k = fn.compiled[(vd, hd, form.endswith("gp"))]
        k._init_handles()
        loads = [ln for ln in k.asm["ptx"].splitlines() if "ld.global" in ln]
        out[form] = dict(
            n_regs=k.n_regs, n_spills=k.n_spills,
            ld_global={w: sum(f".{w}." in ln for ln in loads) for w in ("v4", "v2")},
            ld_global_all=len(loads))
    return out


def _set(pair, spec: str) -> None:
    T, V, warps, stages, per_sm = map(int, spec.split(":"))
    factory.EPILOGUE[pair] = dict(T=T, V=V, num_warps=warps, num_stages=stages)
    factory.EPILOGUE_PROGRAMS = per_sm * 132


def _checked(pair, spec: str):
    """Set the launch, check every form at the ragged n and at n = 2^24;
    returns the n = 2^24 kernels' compiled_info, or None (printed) where a
    check fails."""
    _set(pair, spec)
    try:
        check(N_RAGGED, *pair)
        check(cs.N_BIG, *pair)
    except Exception as e:  # a configuration that fails is reported, not taken
        cs.emit(config=spec, dtypes=[str(t) for t in pair],
                error=f"{type(e).__name__}: {str(e)[:300]}")
        return None
    return compiled_info(*pair)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs", nargs="*", default=[
        "512:4:4:1:8", "512:4:4:3:8", "1024:8:4:1:8", "256:2:4:1:8", "512:4:4:1:4",
        "512:4:4:1:16"])
    ap.add_argument("--other", nargs="*", default=["512:4:4:1:8", "256:2:4:1:8",
                                                   "128:1:4:1:8"],
                    help="launches tried, in order, for the f32/f32 and f64/f64 forms")
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    main_pair = (torch.float32, torch.bfloat16)
    chosen = dict(factory.EPILOGUE), factory.EPILOGUE_PROGRAMS
    a = cs.inputs(cs.N_BIG, *main_pair, cs.SEED)
    for spec in args.configs:
        info = _checked(main_pair, spec)
        if info is None:
            continue
        for form, (kern, _) in launchers(rosenbrock, a, cs.N_BIG).items():
            ms = min(cs.device_time(kern, args.reps) for _ in range(2))
            cs.emit(config=spec, form=form, ms=ms, **info[form])
    # the other dtype pairs: checked, registers and spills of each launch
    # tried, until one spills nothing
    for pair in ((torch.float32, torch.float32), (torch.float64, torch.float64)):
        for spec in args.other:
            info = _checked(pair, spec)
            if info is None:
                continue
            cs.emit(config=spec, dtypes=[str(t) for t in pair], compiled=info)
            if not any(f["n_spills"] for f in info.values()):
                break
    factory.EPILOGUE.clear()
    factory.EPILOGUE.update(chosen[0])
    factory.EPILOGUE_PROGRAMS = chosen[1]
    if args.parent:
        parent = load_tree(args.parent.resolve(), "parent_lbfgs_torch")
        mine, theirs = launchers(rosenbrock, a, cs.N_BIG), launchers(parent, a, cs.N_BIG)
        for form in FORMS:
            p1, k1, k2, p2 = (cs.device_time(f, args.reps)
                              for f in (theirs[form][0], mine[form][0], mine[form][0],
                                        theirs[form][0]))
            cs.emit(compare="parent", form=form, parent_ms=min(p1, p2), ms=min(k1, k2),
                    runs=[p1, k1, k2, p2], launch=factory.EPILOGUE[main_pair])


if __name__ == "__main__":
    main()
