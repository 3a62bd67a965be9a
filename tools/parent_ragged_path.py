"""Time the batched runner's path at an n off 16 in this tree and in another,
in turns, on one CUDA card.

    PYTHONPATH=. python3 tools/parent_ragged_path.py --parent DIR
        [--pairs f32 f64 bf16] [--configs plain owlqn] [--runs 2] [--out FILE]

DIR is the root of another tree of this repository (e.g. a ``git archive``
of the parent commit unpacked under ``build/``), whose ``lbfgs_torch`` is
imported beside this one.  Each setting is one of ``chip_smoke``'s
``phase_ragged_paths`` batched runs: ``minimize_batched`` of the Rosenbrock
objective (``default_evaluate``) from ``chip_smoke.batched_x0``'s starts at
1024 x (2^14 + 2), m = 80 ring rows of the pair's dtype (f32 vectors over
an f32 or a bf16 ring, f64 over f64), epsilon 0, ``RAGGED_ITERS`` - 1
iterations, the uncapped step, plain or OWL-QN (``BATCHED_DEEP_PARAMS``).
Both trees run it once warm, then timed other, this, this, other, ``--runs``
times each turn (wall seconds, the card synchronised around each run; the
least of a turn's runs kept); then once each under ``torch.profiler``: the
device milliseconds by kernel.  Prints the card's nvidia-smi name and power
limit, then one JSON line a setting: the walls, wall ms per iteration and
its change, device ms per iteration, the five costliest kernels of each
tree, each tree's iterations and statuses, and the largest relative gap
between the two trees' fx (the forms differ in their sums' order).
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from tools.tune_epilogues import load_tree

PAIRS = {"f32": (torch.float32, "float32"), "f64": (torch.float64, "float64"),
         "bf16": (torch.float32, "bfloat16")}


def params_of(pkg, label: str, hd: str):
    """The ragged path's settings, built from ``pkg``'s own classes."""
    P = importlib.import_module(pkg + ".params")
    Ow = importlib.import_module(pkg + ".orthantwise").Orthantwise
    p = P.LbfgsParams(m=cs.DEEP_M, history_dtype=hd, epsilon=0.0,
                      max_iterations=cs.RAGGED_ITERS, constrain_step_size=False)
    if label == "owlqn":
        p = p.replace(orthantwise=Ow(1.0, 0, cs.BATCH_N - 1)).replace_ls(
            algorithm=P.LineSearchAlgorithm.BacktrackingArmijo)
    return p


def run(mod, params, x0b, fn) -> tuple:
    """(wall seconds, final state) of one ``minimize_batched``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = mod.minimize_batched(params, x0b.clone(), fn, return_state=True)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, st


def profile(mod, params, x0b, fn) -> tuple:
    """(device ms of the run, its five costliest kernels in ms)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        mod.minimize_batched(params, x0b.clone(), fn)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    ev.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in ev) / 1e3
    return total, [(e.key[:60], e.self_device_time_total / 1e3) for e in ev[:5]]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--pairs", nargs="+", default=list(PAIRS), choices=list(PAIRS))
    ap.add_argument("--configs", nargs="+", default=["plain", "owlqn"],
                    choices=["plain", "owlqn"])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args()
    out = open(args.out, "w") if args.out else None
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    load_tree(args.parent.resolve(), "lbfgs_torch_other")
    trees = {"this": ("lbfgs_torch", importlib.import_module("lbfgs_torch.batched"),
                      importlib.import_module("lbfgs_torch").default_evaluate()),
             "other": ("lbfgs_torch_other",
                       importlib.import_module("lbfgs_torch_other.batched"),
                       importlib.import_module("lbfgs_torch_other").default_evaluate())}
    B, n = cs.BATCH_B, cs.RAGGED_BN
    for pair in args.pairs:
        vd, hd = PAIRS[pair]
        x0b = cs.batched_x0(B, n).to(vd)
        for label in args.configs:
            want = cs.BATCHED_DEEP_PARAMS[label][0].replace(
                m=cs.DEEP_M, history_dtype=hd, max_iterations=cs.RAGGED_ITERS)
            if params_of("lbfgs_torch", label, hd) != want:
                raise AssertionError(f"{label}: the settings are not the ragged path's")
            prm = {t: params_of(pkg, label, hd) for t, (pkg, _, _) in trees.items()}
            walls, states = {"this": [], "other": []}, {}
            for t, (_, mod, fn) in trees.items():
                run(mod, prm[t], x0b, fn)
            for t in ("other", "this", "this", "other"):
                _, mod, fn = trees[t]
                best = float("inf")
                for _ in range(args.runs):
                    w, states[t] = run(mod, prm[t], x0b, fn)
                    best = min(best, w)
                walls[t].append(best)
                torch.cuda.empty_cache()
            iters = {t: int(st.k.max()) - 1 for t, st in states.items()}
            dev = {t: profile(trees[t][1], prm[t], x0b, trees[t][2]) for t in trees}
            fx = {t: np.asarray(st.fx, dtype=np.float64) for t, st in states.items()}
            gap = float(np.max(np.abs(fx["this"] - fx["other"])
                               / np.maximum(np.abs(fx["other"]), 1e-300)))
            line = json.dumps(dict(
                pair=pair, config=label, B=B, n=n, m=cs.DEEP_M,
                ring_stride={t: int(st.hist.s.stride(1)) for t, st in states.items()},
                other_wall_s=walls["other"], this_wall_s=walls["this"],
                other_ms_per_iter=1e3 * min(walls["other"]) / iters["other"],
                this_ms_per_iter=1e3 * min(walls["this"]) / iters["this"],
                change=min(walls["this"]) / min(walls["other"]) * iters["other"]
                / iters["this"] - 1,
                device_ms_per_iter={t: d[0] / iters[t] for t, d in dev.items()},
                top_kernels_ms={t: d[1] for t, d in dev.items()}, iters=iters,
                status={t: sorted(set(np.asarray(st.status).tolist()))
                        for t, st in states.items()},
                fx_rel_gap=gap))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            del states
            torch.cuda.empty_cache()
        del x0b


if __name__ == "__main__":
    main()
