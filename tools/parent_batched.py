"""Hold this tree's static batched epilogues to another tree's, bit for bit,
and time both in turns, on one CUDA card.

    PYTHONPATH=. python3 tools/parent_batched.py --parent DIR [--reps N]

DIR is the root of another tree of this repository (e.g. a ``git archive``
of the parent commit unpacked under ``build/``), whose ``lbfgs_torch`` is
imported beside this one.  K4 b (``trial_pair_gram_batched``) and K14 b
(``owlqn_trial_pair_gram_batched``) run at the batched main path's shapes
(B x n = 1024 x 2^14, f32 vectors, bf16 rings, m = 6, end = 3, on
``chip_smoke.batched_owlqn_inputs``, a third of the instances frozen, K14
b on the window [0, n - 1)) in both trees: the points, gradients,
pseudo-gradients, rings and every output must be the other tree's bit for
bit.  Then each is timed with every instance live, other tree, this,
this, other (``chip_smoke.device_time``).  Prints one JSON line per
kernel, the card's nvidia-smi name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from lbfgs_torch.models import rosenbrock
from tools.tune_epilogues import load_tree


def calls(k, a: dict, live, fresh: bool = True) -> dict:
    """name: a call of the batched epilogue, in place on copies of the
    inputs (new ones each call with ``fresh``, else made once, as a timed
    loop advances them), returning (the vectors and rings it wrote, its
    outputs)."""
    lo, hi = 0, cs.BATCH_N - 1
    once = {n: a[n].clone() for n in ("xp", "gp", "pg", "S", "Y")}

    def copies():
        return {n: a[n].clone() for n in once} if fresh else once

    def k4():
        t = copies()
        out = k.trial_pair_gram_batched(t["xp"], a["d"], t["gp"], a["stp"], t["S"], t["Y"],
                                        cs.BATCH_END, live)
        return t, out

    def k14():
        t = copies()
        out = k.owlqn_trial_pair_gram_batched(t["xp"], a["d"], t["gp"], t["pg"], a["stp"], 1.0,
                                              lo, hi, t["S"], t["Y"], cs.BATCH_END, live)
        return t, out

    return {"K4b": k4, "K14b": k14}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    other = load_tree(args.parent.resolve(), "lbfgs_torch_other").value_and_grad.kernels
    this = rosenbrock.value_and_grad.kernels
    a = cs.batched_owlqn_inputs(cs.SEED + 14)
    live = a["live"]
    mine, theirs = calls(this, a, live), calls(other, a, live)
    every = torch.ones_like(live)
    timed_mine, timed_theirs = calls(this, a, every, False), calls(other, a, every, False)
    for name in mine:
        (tv, ov), (tw, ow) = mine[name](), theirs[name]()
        same = all(cs.same_bits(tv[n], tw[n]) for n in tv) and all(
            cs.same_bits(u, v) for u, v in zip(ov, ow))
        if not same:
            raise AssertionError(f"{name}: this tree's outputs differ from the other tree's")
        o1, t1, t2, o2 = (cs.device_time(f, args.reps)
                          for f in (timed_theirs[name], timed_mine[name], timed_mine[name],
                                    timed_theirs[name]))
        print(json.dumps(dict(kernel=name, bit_for_bit=True, other_ms=[o1, o2], this_ms=[t1, t2],
                              change=min(t1, t2) / min(o1, o2) - 1)), flush=True)


if __name__ == "__main__":
    main()
