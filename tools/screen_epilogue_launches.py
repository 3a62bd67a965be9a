"""Run chip_smoke.py's n = 2^24 path phases under several launches of the
epilogues K4 and K14, and print which phases pass under each.

    PYTHONPATH=. python3 tools/screen_epilogue_launches.py [T:V:WARPS:STAGES:PER_SM ...]

Every launch sums the epilogues' products in its own order (the tile, the
run a thread folds, the tiles per program).  The products agree with the
plain versions to ~1e-7 normwise under all of them, but the runs at
epsilon 0 end where float32 rounding decides (a line search that cannot
move x, a damping case near its threshold), and chip_smoke.py holds those
end states and the plain-versions trajectories after 8 iterations.  For
each launch of ``factory.EPILOGUE[(float32, bfloat16)]`` this runs the
phases that reach K4 or K14 at n = 2^24 (plain, OWL-QN, damped,
gradient-only, damped OWL-QN, wide OWL-QN, the unfused three, the
adaptive entry, both north stars) and prints one JSON line per launch:
each phase "ok" or its error.  Needs one CUDA card; run from the root of
the repository.
"""

from __future__ import annotations

import json
import sys

import torch

import chip_smoke as cs
from lbfgs_torch.ops import factory

DEFAULT = ["1024:8:4:1:8", "1024:8:4:1:4", "1024:8:4:1:16", "1024:8:4:1:32",
           "512:4:4:1:8", "512:4:4:1:4", "512:4:4:1:16"]


def screen() -> dict:
    """Every phase in chip_smoke.main's order, each run whatever the
    earlier ones gave (a failed phase hands on a stand-in of its output)."""
    out, res = {}, {}

    def run(name, fn, *a, fallback=None):
        try:
            res[name] = fn(*a)
            out[name] = "ok"
        except Exception as e:  # the screen records each phase's outcome
            out[name] = f"{type(e).__name__}: {str(e)[:240]}"
            res[name] = fallback
        torch.cuda.empty_cache()
        return res[name]

    stub = dict(iters=1, evals=1, ms_per_iter=1.0, syncs_per_iter=99.0, probes_per_iter=1.0)
    _, main_out = run("main_path", cs.phase_main_path, fallback=(None, stub))
    _, ow_out = run("owlqn_main_path", cs.phase_owlqn_main_path, fallback=(None, stub))
    run("north_star", cs.phase_north_star)
    _, d_out = run("damped_main_path", cs.phase_damped_main_path, main_out["syncs_per_iter"],
                   fallback=(None, stub))
    run("gradient_only_main_path", cs.phase_gradient_only_main_path)
    run("damped_owlqn_main_path", cs.phase_damped_owlqn_main_path)
    run("wide_owlqn_main_path", cs.phase_wide_owlqn_main_path)
    run("owlqn_north_star", cs.phase_owlqn_north_star)
    run("unfused_main_path", cs.phase_unfused_main_path, main_out)
    run("unfused_owlqn_main_path", cs.phase_unfused_owlqn_main_path, ow_out)
    run("adaptive_entry", cs.phase_adaptive_entry, ow_out)
    run("unfused_damped_main_path", cs.phase_unfused_damped_main_path, d_out)
    return out


def main() -> None:
    specs = sys.argv[1:] or DEFAULT
    cs.phase_device()
    cs.phase_build()
    pair = (torch.float32, torch.bfloat16)
    for spec in specs:
        T, V, warps, stages, per_sm = map(int, spec.split(":"))
        factory.EPILOGUE[pair] = dict(T=T, V=V, num_warps=warps, num_stages=stages)
        factory.EPILOGUE_PROGRAMS = per_sm * 132
        out = screen()
        print(json.dumps({"screen": spec, "all_ok": all(v == "ok" for v in out.values()),
                          "phases": out}), flush=True)


if __name__ == "__main__":
    main()
