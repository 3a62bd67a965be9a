"""Registers, spills and times of the epilogues' static and deep fold
forms at a few ring depths, and the deep forms' registers at other group
sizes, on one CUDA card: what ``factory.EPILOGUE_MAX_M`` is chosen from.

    PYTHONPATH=. python3 tools/deep_crossover.py [--depths 8 16 32] [--reps N]
        [--pairs bf16 f32 f64] [--forms static deep rows] [--groups 8 4 2]
        [--n 1048576] [--batched [--batch 1024]]

For each dtype pair of ``--pairs`` (f32 vectors over a bf16 or an f32
history, f64 over f64) and depth m, at the deep-history path's n = 2^20
(``chip_smoke.deep_inputs``): K4 and K14, each with and without the . gp
column, in each form of ``--forms``: the static form and the deep form
(each forced by ``chip_smoke.static_forms_up_to``: m rows static, 0 rows
static; the tensor-core forms off) and the tensor-core row-block form
(``rows``: forced by ``chip_smoke.rows_form_from``), each form's
registers and spills from its compiled Triton kernel, and the device time
of each in turns, the forms in order and then in reverse (static, deep,
deep, static by default; ``chip_smoke.device_time``): what
``factory.EPILOGUE_MAX_M`` and ``factory.MMA_ROWS_MIN_M`` are chosen from.
The static forms compile per m and unroll every ring row, so at 32 rows
and more their compiles take minutes: this runs apart from
``chip_smoke.py``.

With ``--groups``, for each group size G in turn (``factory.DEEP_GROUP``
set to G for every dtype pair), the registers and spills of the deep K4
and K14, each with and without the . gp column, in the three dtype pairs,
compiled at m = 80 and at an n divisible by 16 and one that is not (Triton
specialises on that): what ``factory.DEEP_GROUP`` is chosen from.

``--n`` sets the vectors' length (an n off a multiple of 16 keeps the
fold forms whatever is forced).  With ``--batched`` the same forms of the
batched K4 b and K14 b run instead, on ``--batch`` instances of ``--n``
elements (1024 x 2^14 by default, the batched main path's shape, every
instance live; ``chip_smoke.batched_generic_inputs``): what the batched
entries of ``factory.MMA_ROWS_MIN_M`` are chosen from.

Prints one JSON line per depth and form; the card's nvidia-smi name and
power limit first.
"""

from __future__ import annotations

import argparse

import torch

import chip_smoke as cs
from lbfgs_torch.models import rosenbrock
from lbfgs_torch.ops import factory


PAIRS = {"bf16": (torch.float32, torch.bfloat16), "f32": (torch.float32, torch.float32),
         "f64": (torch.float64, torch.float64)}
#: each form of ``--forms`` forced at depth m
FORCED = {"static": cs.static_forms_up_to, "deep": lambda m: cs.static_forms_up_to(0),
          "rows": cs.rows_form_from}


def batched(args) -> None:
    """``--batched``: the forms of K4 b and K14 b (each with and without
    the . gp column) at each pair and depth, in turns, on ``args.batch``
    instances of ``args.n`` elements, every instance live."""
    k = rosenbrock.value_and_grad.kernels
    B, n = args.batch, args.n or cs.BATCH_N
    lo, hi = cs.windows(n)[1]
    for pair in args.pairs:
        vd, hd = PAIRS[pair]
        for m in args.depths:
            a = cs.batched_generic_inputs(cs.SEED + 30 + m, vd, hd, m, B, n)
            every = torch.ones_like(a["live"])
            end = m - 3
            for gp in (False, True):
                forms = {
                    "K4b": (k.trial_pair_gram_batched, lambda gp=gp: k.trial_pair_gram_batched(
                        a["xp"], a["d"], a["gp"], a["stp"], a["S"], a["Y"], end, every,
                        with_gp=gp)),
                    "K14b": (k.owlqn_trial_pair_gram_batched,
                             lambda gp=gp: k.owlqn_trial_pair_gram_batched(
                                 a["xp"], a["d"], a["gp"], a["pg"], a["stp"], cs.C_L1, lo, hi,
                                 a["S"], a["Y"], end, every, with_gp=gp)),
                }
                for name, (fn, call) in forms.items():
                    ms, regs = {form: [] for form in args.forms}, {}
                    for form in args.forms + args.forms[::-1]:
                        with FORCED[form](m):
                            call()
                            regs[form] = dict(kernel=fn.last_form.kernel,
                                              programs=fn.last_form.total,
                                              chunks_per_program=fn.last_form.tiles,
                                              **cs._compiled_info(fn.last_form.compiled))
                            ms[form].append(cs.device_time(call, args.reps))
                    table = ("K4b_trial_pair_gram_batched" if name == "K4b"
                             else "K14b_owlqn_trial_pair_gram_batched") + ("_gp" if gp else "")
                    cs.emit(form=name + ("_gp" if gp else ""), m=m, B=B, n=n,
                            dtypes=f"{vd}/{hd}".replace("torch.", ""), ms=ms,
                            bound_ms=cs.bound(table, B * n, vd.itemsize, hd.itemsize, m)[0],
                            timed_by=cs.device_time.source, registers=regs,
                            chosen=factory.batched_epilogue_grid(B, n, m, vd, hd).form)
            del a, every
            torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depths", type=int, nargs="*", default=[8, 16, 32])
    ap.add_argument("--pairs", nargs="*", default=["bf16", "f32", "f64"],
                    choices=["bf16", "f32", "f64"])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--groups", type=int, nargs="*", default=[])
    ap.add_argument("--forms", nargs="*", default=["static", "deep"],
                    choices=["static", "deep", "rows"])
    ap.add_argument("--n", type=int)
    ap.add_argument("--batched", action="store_true")
    ap.add_argument("--batch", type=int, default=cs.BATCH_B)
    args = ap.parse_args()
    cs.phase_device()
    if args.batched:
        batched(args)
        return
    k = rosenbrock.value_and_grad.kernels
    chosen = dict(factory.DEEP_GROUP)
    for G in args.groups:
        factory.DEEP_GROUP = dict.fromkeys(chosen, G)
        for n in (4096, 4098):
            forms = []
            for fn in (k.trial_pair_gram, k.owlqn_trial_pair_gram):
                fn.deep_compiled.clear()
            for vd, hd in cs.DTYPES:
                x = torch.ones(n, dtype=vd, device="cuda")
                S = torch.zeros((cs.DEEP_M, n), dtype=hd, device="cuda")
                for gp in (False, True):
                    k.trial_pair_gram(x, x, x.clone(), 0.0, S, S.clone(), 1, with_gp=gp)
                    k.owlqn_trial_pair_gram(x, x, x.clone(), x.clone(), 0.0, 1.0, 0, n - 1, S,
                                            S.clone(), 1, with_gp=gp)
            for name, fn in (("K4", k.trial_pair_gram), ("K14", k.owlqn_trial_pair_gram)):
                for (vd, hd, gp), c in sorted(fn.deep_compiled.items(), key=str):
                    forms.append(dict(form=name + ("_gp" if gp else ""),
                                      dtypes=f"{vd}/{hd}".replace("torch.", ""),
                                      **cs._compiled_info(c)))
            cs.emit(group=G, m=cs.DEEP_M, n=n, forms=forms)
    factory.DEEP_GROUP = chosen
    for fn in (k.trial_pair_gram, k.owlqn_trial_pair_gram):
        fn.deep_compiled.clear()
    n = args.n or cs.DEEP_N
    hi = n - 1
    for pair in args.pairs:
        vd, hd = PAIRS[pair]
        for m in args.depths:
            a = cs.deep_inputs(vd, hd, m, n)
            S, Y = a["S"], a["Y"]
            for gp in (False, True):
                forms = {
                    "K4": (k.trial_pair_gram, lambda gp=gp: k.trial_pair_gram(
                        a["xp"], a["d"], a["gp"], cs.STP, S, Y, cs.END, with_gp=gp)),
                    "K14": (k.owlqn_trial_pair_gram, lambda gp=gp: k.owlqn_trial_pair_gram(
                        a["xp0"], a["d"], a["gp"], a["pg"], cs.STP, 1.0, 0, hi, S, Y, cs.END,
                        with_gp=gp)),
                }
                for name, (fn, call) in forms.items():
                    ms, regs = {form: [] for form in args.forms}, {}
                    for form in args.forms + args.forms[::-1]:
                        with FORCED[form](m):
                            call()
                            regs[form] = dict(kernel=fn.last_form.kernel,
                                              **cs._compiled_info(fn.last_form.compiled))
                            ms[form].append(cs.device_time(call, args.reps))
                    cs.emit(form=name + ("_gp" if gp else ""), m=m, n=n,
                            dtypes=f"{vd}/{hd}".replace("torch.", ""), ms=ms,
                            bound_ms=cs.bound(("K4_trial_pair_gram" if name == "K4" else
                                               "K14_owlqn_trial_pair_gram")
                                              + ("_gp" if gp else ""), n, vd.itemsize,
                                              hd.itemsize, m)[0],
                            timed_by=cs.device_time.source, registers=regs,
                            chosen=factory.solo_epilogue_grid(n, m, vd, hd).form)
            del a, S, Y
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
