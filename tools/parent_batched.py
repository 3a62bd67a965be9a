"""Hold this tree's batched epilogues K4 b and K14 b to another tree's and
time both in turns, on one CUDA card.

    PYTHONPATH=. python3 tools/parent_batched.py --parent DIR [--reps N]
        [--pairs bf16 f32 f64] [--depths 6 19 80] [--forms K4b K4b_gp K14b K14b_gp]
        [--ragged] [--timed-n 16384]

DIR is the root of another tree of this repository (e.g. a ``git archive``
of the parent commit unpacked under ``build/``), whose ``lbfgs_torch`` is
imported beside this one.  Each form (K4 b ``trial_pair_gram_batched``
and K14 b ``owlqn_trial_pair_gram_batched``, each with and without the .
gp column) runs at each ring depth m and dtype pair of ``--pairs`` (f32
vectors over a bf16 ring, the default, or over an f32 ring; f64 over
f64) at the batched main path's shapes (n = 2^14, end = m - 3, a third of
the instances frozen, K14 b on a window whose ends fall inside the
kernels' tiles), and with ``--ragged`` at n = 2^14 + 2 too, in both trees:
the points, gradients, pseudo-gradients and rings must be the other
tree's bit for bit (a frozen instance's untouched), the sums and products
within the sum tolerance of ``chip_smoke.TOL`` (normwise; the products'
gap printed), and a . gp launch's other outputs this tree's 3-column
launch's bit for bit.  The checks take ``CHECK_B`` instances (they hold
four copies of the rings), the timings ``chip_smoke.BATCH_B`` = 1024.
Then, at each n of ``--timed-n`` (2^14 by default) with every instance
live, each form is timed other tree, this, this, other
(``chip_smoke.device_time``), both trees on one copy of the inputs.
Prints one JSON line per form, pair, depth and timed n, with this tree's
form and launch geometry (``factory.batched_epilogue_grid``), the card's
nvidia-smi name and power limit first (``--out`` writes the lines to a
file too).  With
``--fold`` this tree runs its fold forms alone, on the batch-wide grid
(``factory.MMA_MAX_M`` = 0): the launch sizing without the tensor cores.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from lbfgs_torch.models import rosenbrock
from lbfgs_torch.ops import factory
from tools.tune_epilogues import load_tree

FORMS = ("K4b", "K4b_gp", "K14b", "K14b_gp")
NAMES = ("xp", "gp", "pg", "S", "Y")
#: the dtype pairs of ``--pairs``: (vectors, rings)
PAIRS = {"bf16": (torch.float32, torch.bfloat16), "f32": (torch.float32, torch.float32),
         "f64": (torch.float64, torch.float64)}
#: the instances the checks take per pair: an f32 ring of 80 rows at 1024 x
#: 2^14 is 10.7 GB and an f64 one 21.5 GB, and a check holds four copies
CHECK_B = {"bf16": cs.BATCH_B, "f32": 512, "f64": 256}


def inputs(seed: int, m: int, n: int, pair: str = "bf16", B: int = cs.BATCH_B) -> dict:
    """Seeded inputs of the batched epilogues at B instances of n elements
    and m ring rows, vectors and rings of the dtype pair ``pair``; xp zero
    at every 17th element, every third instance from the third frozen.
    The rings are drawn 16 rows at a time in their own dtype's width."""
    vd, hd = PAIRS[pair]
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda", dtype=vd)
    live = torch.ones(B, dtype=torch.bool, device="cuda")
    live[2::3] = False
    xp = rosenbrock.initial_point(n, vd, "cuda")[None, :] + 0.1 * r(B, n)
    xp[:, ::17] = 0.0
    a = dict(xp=xp, d=0.1 * r(B, n), gp=r(B, n), pg=r(B, n),
             stp=0.2 + torch.rand(B, generator=g, device="cuda", dtype=vd), live=live, m=m,
             n=n)
    for ring in ("S", "Y"):
        a[ring] = torch.empty((B, m, n), dtype=hd, device="cuda")
        for j in range(0, m, 16):
            a[ring][:, j:j + 16] = 0.1 * r(B, min(16, m - j), n)
    return a


def call(k, form: str, a: dict, t: dict, live, with_gp=None):
    """One launch of ``form`` through the objective's kernels ``k``, in
    place on the vectors and rings ``t``; ``with_gp`` overrides the form's
    column count."""
    gp = form.endswith("_gp") if with_gp is None else with_gp
    end = a["m"] - 3
    if form.startswith("K14b"):
        lo, hi = cs.windows(a["n"])[1]
        return k.owlqn_trial_pair_gram_batched(t["xp"], a["d"], t["gp"], t["pg"], a["stp"],
                                               cs.C_L1, lo, hi, t["S"], t["Y"], end, live,
                                               with_gp=gp)
    return k.trial_pair_gram_batched(t["xp"], a["d"], t["gp"], a["stp"], t["S"], t["Y"], end,
                                     live, with_gp=gp)


def fresh(a: dict) -> dict:
    return {n_: a[n_].clone() for n_ in NAMES}


def compare(this, other, form: str, a: dict) -> dict:
    """Both trees' launches of ``form`` on ``a``: the vectors and rings bit
    for bit, the sums within the sum tolerance, the . gp launch's other
    outputs this tree's 3-column launch's; returns the largest normwise
    gaps of the sums and of the products."""
    live = a["live"]
    tv, ov = fresh(a), fresh(a)
    out_t, out_o = call(this, form, a, tv, live), call(other, form, a, ov, live)
    bits = {n_: cs.same_bits(tv[n_], ov[n_]) for n_ in NAMES}
    bits["frozen"] = all(cs.same_bits(tv[n_][~live], a[n_][~live]) for n_ in NAMES)
    if not all(bits.values()):
        raise AssertionError(f"{form} m={a['m']} n={a['n']}: vectors or rings differ from the "
                             f"other tree's: {bits}")
    ts = cs.TOL[(a["xp"].dtype, "sum")]
    prod = (3, 4) if form.startswith("K14b") else (4, 5)
    gaps = {}
    for i, (u, v) in enumerate(zip(out_t, out_o)):
        if u.dtype == torch.bool:
            if not torch.equal(u[live], v[live]):
                raise AssertionError(f"{form} m={a['m']}: changed differs from the other tree's")
            continue
        gaps[i] = cs.err(u[live], v[live])
    worst = max(gaps.values())
    if worst > ts:
        raise AssertionError(f"{form} m={a['m']} n={a['n']}: sums {gaps} beyond {ts}")
    if form.endswith("_gp"):
        t3 = fresh(a)
        out3 = call(this, form, a, t3, live, with_gp=False)
        same = all(cs.same_bits(t3[n_], tv[n_]) for n_ in NAMES) and all(
            cs.same_bits((u[..., :3] if u.ndim == 3 else u)[live], v[live])
            for u, v in zip(out_t, out3))
        if not same:
            raise AssertionError(f"{form} m={a['m']}: columns 0-2 or another output differ "
                                 f"from the 3-column launch's")
    return dict(sums=max(g for i, g in gaps.items() if i not in prod),
                products=max(gaps[i] for i in prod))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--depths", type=int, nargs="+", default=[6, 19, 80])
    ap.add_argument("--pairs", nargs="+", default=["bf16"], choices=list(PAIRS))
    ap.add_argument("--timed-n", type=int, nargs="+", default=[cs.BATCH_N])
    ap.add_argument("--forms", nargs="+", default=list(FORMS), choices=FORMS)
    ap.add_argument("--ragged", action="store_true")
    ap.add_argument("--fold", action="store_true",
                    help="this tree's fold forms alone (no tensor-core form), on the "
                         "batch-wide grid")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.fold:
        factory.MMA_MAX_M = 0
    out = open(args.out, "w") if args.out else None
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    other = load_tree(args.parent.resolve(), "lbfgs_torch_other").value_and_grad.kernels
    this = rosenbrock.value_and_grad.kernels
    for pair, m in ((p, m) for p in args.pairs for m in args.depths):
        vd, hd = PAIRS[pair]
        sizes = [cs.BATCH_N] + ([cs.BATCH_N + 2] if args.ragged else [])
        for form in args.forms:
            gaps = {}
            for n in sizes:
                a = inputs(cs.SEED + 20 + m, m, n, pair, CHECK_B[pair])
                gaps[n] = compare(this, other, form, a)
                del a
                torch.cuda.empty_cache()
            for n in args.timed_n:
                a = inputs(cs.SEED + 20 + m, m, n, pair)
                every = torch.ones_like(a["live"])
                t = fresh(a)
                del a["S"], a["Y"]
                mine = lambda: call(this, form, a, t, every)
                theirs = lambda: call(other, form, a, t, every)
                reps = args.reps if m <= factory.MAX_M else max(5, args.reps // 4)
                o1, t1, t2, o2 = (cs.device_time(f, reps) for f in (theirs, mine, mine, theirs))
                fn = this.owlqn_trial_pair_gram_batched if form.startswith("K14b") else \
                    this.trial_pair_gram_batched
                pfn = other.owlqn_trial_pair_gram_batched if form.startswith("K14b") else \
                    other.trial_pair_gram_batched
                geo = fn.last_form
                name = ("K14b_owlqn_trial_pair_gram_batched" if form.startswith("K14b")
                        else "K4b_trial_pair_gram_batched") + ("_gp" if form.endswith("_gp")
                                                               else "")
                bound_ms = cs.bound(name, cs.BATCH_B * n, vd.itemsize, hd.itemsize, m)[0]
                line = json.dumps(dict(
                    kernel=form, dtypes=pair, m=m, B=cs.BATCH_B, n=n, checked_B=CHECK_B[pair],
                    vectors_rings_bit_for_bit=True,
                    normwise_gap={str(k_): g for k_, g in gaps.items()}, other_ms=[o1, o2],
                    this_ms=[t1, t2], change=min(t1, t2) / min(o1, o2) - 1, bound_ms=bound_ms,
                    share_of_bound=bound_ms / min(t1, t2),
                    other_share_of_bound=bound_ms / min(o1, o2),
                    timed_by=cs.device_time.source, other_kernel=pfn.last_form.kernel,
                    form=dict(kernel=geo.kernel, programs=geo.programs, tiles=geo.tiles,
                              tile=geo.T, total=geo.total,
                              **{k: v for k, v in geo.consts.items() if k != "m"}, **geo.launch,
                              **cs._compiled_info(geo.compiled))))
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
                del a, t
                torch.cuda.empty_cache()

if __name__ == "__main__":
    main()
