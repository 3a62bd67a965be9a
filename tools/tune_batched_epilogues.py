"""Tune the batched epilogues' tensor-core launch and find the depths it
should take, on one CUDA card.

    PYTHONPATH=. python3 tools/tune_batched_epilogues.py [--depths 6 19 48 80 200]
        [--crossover 6 8 12 16 19 32] [--reps N] [--out PATH]

At the batched main path's shapes (B x n = 1024 x 2^14, f32 vectors, bf16
rings, a third of the instances frozen in the checks, every instance live
in the timings; ``tools/parent_batched.inputs``):

  * the sweep: at each ring depth of ``--depths`` (its RP, m rounded up to
    a power of two, at least 16), every launch of the tensor-core form
    (chunk K in 64-256, 128 at most from RP = 128, 4 or 8 warps, 1-3
    pipeline stages; a launch the compiler refuses is printed as such) runs K4 b ·gp
    and K14 b ·gp, each held to its plain version (vectors 1e-5, sums and
    products 1e-4 normwise) and timed (``chip_smoke.device_time``), with
    its registers and spills; the fastest launch that spills nothing, per
    RP, is printed beside ``factory.MMA_EPILOGUE``'s;
  * the crossover: at each depth of ``--crossover`` the static fold form
    (on the batch-wide grid) and the tensor-core form (at
    ``factory.MMA_EPILOGUE``'s launch) are timed in turns, static,
    tensor-core, tensor-core, static, for K4 b and K14 b with and without
    the . gp column (the tensor-core form runs one binary for both).

Prints one JSON line per launch and depth, the card's nvidia-smi name and
power limit first; ``--out`` writes the same lines to a file.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

import chip_smoke as cs
from lbfgs_torch.models import rosenbrock
from lbfgs_torch.ops import factory
from tools import parent_batched as pb

K = rosenbrock.value_and_grad.kernels
GRID = [(k, w, s) for k in (64, 128, 256) for w in (4, 8) for s in (1, 2, 3)]


class Plain:
    """The plain versions under the wrappers' names (``pb.call``'s ``k``)."""
    trial_pair_gram_batched = K.trial_pair_gram_batched_ref
    owlqn_trial_pair_gram_batched = K.owlqn_trial_pair_gram_batched_ref


def table_name(form: str) -> str:
    return (("K14b_owlqn_trial_pair_gram_batched" if form.startswith("K14b")
             else "K4b_trial_pair_gram_batched") + ("_gp" if form.endswith("_gp") else ""))


def compiled(form: str) -> dict:
    """Registers and spills of the form's last launch."""
    fn = K.owlqn_trial_pair_gram_batched if form.startswith("K14b") else K.trial_pair_gram_batched
    f = fn.last_form
    ck = {"mma": fn.mma_compiled, "static": fn.compiled, "deep": fn.deep_compiled}[f.form][
        (torch.float32, torch.bfloat16, form.endswith("_gp"))]
    ck._init_handles()
    return dict(kernel=f.kernel, n_regs=ck.n_regs, n_spills=ck.n_spills)


def gaps(form: str, a: dict, want: tuple) -> tuple:
    """(vectors, sums) normwise gaps of one launch against the plain one."""
    live = a["live"]
    t = pb.fresh(a)
    out = pb.call(K, form, a, t, live)
    tq, oq = want
    vec = max(cs.err(t[n][live], tq[n][live]) for n in ("xp", "gp", "pg"))
    sums = max(cs.err(u[live], v[live]) for u, v in zip(out, oq) if u.dtype != torch.bool)
    return vec, sums


def timer(form: str, a: dict, reps: int):
    every = torch.ones_like(a["live"])
    t = pb.fresh(a)
    return lambda: cs.device_time(lambda: pb.call(K, form, a, t, every), reps)


def sweep(m: int, reps: int, emit) -> None:
    rp = max(16, 1 << (m - 1).bit_length())
    keep, kept = dict(factory.MMA_EPILOGUE.get(rp, {})), (factory.MMA_MIN_M, factory.MMA_MAX_M)
    factory.MMA_MIN_M, factory.MMA_MAX_M = 1, max(kept[1], rp)
    a = pb.inputs(cs.SEED + 50 + m, m, cs.BATCH_N)
    want = {}
    for form in ("K4b_gp", "K14b_gp"):
        t = pb.fresh(a)
        want[form] = (t, pb.call(Plain, form, a, t, a["live"]))
    best = {}
    for k, w, s in GRID:
        if rp >= 128 and k > 128:
            continue
        factory.MMA_EPILOGUE[rp] = dict(K=k, num_warps=w, num_stages=s)
        for form in ("K4b_gp", "K14b_gp"):
            try:
                vec, sums = gaps(form, a, want[form])
            except Exception as e:  # a launch the compiler refuses is a result of the sweep
                emit(dict(sweep=form, m=m, RP=rp, K=k, num_warps=w, num_stages=s,
                          refused=f"{type(e).__name__}: {str(e)[-300:]}"))
                continue
            row = dict(sweep=form, m=m, RP=rp, K=k, num_warps=w, num_stages=s,
                       ms=timer(form, a, reps)(), vec_gap=vec, sum_gap=sums, **compiled(form))
            emit(row)
            ok = row["n_spills"] == 0 and vec <= 1e-5 and sums <= 1e-4
            if ok and (form not in best or row["ms"] < best[form]["ms"]):
                best[form] = row
    emit(dict(best=m, RP=rp, chosen=keep, fastest={f: {k_: r[k_] for k_ in (
        "K", "num_warps", "num_stages", "ms", "n_regs")} for f, r in best.items()}))
    factory.MMA_EPILOGUE[rp] = keep
    factory.MMA_MIN_M, factory.MMA_MAX_M = kept
    if not keep:
        del factory.MMA_EPILOGUE[rp]


def crossover(m: int, reps: int, emit) -> None:
    a = pb.inputs(cs.SEED + 60 + m, m, cs.BATCH_N)
    lo = factory.MMA_MIN_M
    chosen = factory.batched_epilogue_grid(cs.BATCH_B, cs.BATCH_N, m, torch.float32,
                                           torch.bfloat16).form
    try:
        for form in pb.FORMS:
            def run(label):
                factory.MMA_MIN_M = m + 1 if label == "static" else 1
                return timer(form, a, reps)()

            info = {}
            for label in ("static", "mma"):
                factory.MMA_MIN_M = m + 1 if label == "static" else 1
                pb.call(K, form, a, pb.fresh(a), a["live"])
                info[label] = compiled(form)
            s1, t1, t2, s2 = (run(label) for label in ("static", "mma", "mma", "static"))
            emit(dict(crossover=form, m=m, static_ms=[s1, s2], mma_ms=[t1, t2],
                      bound_ms=cs.bound(table_name(form), cs.BATCH_B * cs.BATCH_N, 4, 2, m)[0],
                      chosen=chosen, **info))
    finally:
        factory.MMA_MIN_M = lo


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depths", type=int, nargs="*", default=[6, 19, 48, 80, 200])
    ap.add_argument("--crossover", type=int, nargs="*", default=[6, 8, 12, 16, 19, 32])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out")
    args = ap.parse_args()
    out = open(args.out, "w") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    emit(dict(card=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip()))
    for m in args.depths:
        sweep(m, args.reps if m <= factory.MAX_M else max(3, args.reps // 2), emit)
        torch.cuda.empty_cache()
    for m in args.crossover:
        crossover(m, args.reps, emit)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
