"""Tune the batched epilogues' tensor-core launch and find the depths it
should take, on one CUDA card; with ``--solo``, the same for the solo
epilogues K4 and K14.

    PYTHONPATH=. python3 tools/tune_batched_epilogues.py [--depths 6 19 48 80 200]
        [--crossover 6 8 12 16 19 32] [--reps N] [--out PATH]
    PYTHONPATH=. python3 tools/tune_batched_epilogues.py --solo [--depths 16 19 80 200]
        [--crossover 8 9 12 16] [--widths 1048576 16777216] [--reps N] [--out PATH]

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

With ``--solo`` (one instance, f32 vectors over a bf16 ring,
``chip_smoke.numerics_inputs``; K14 on the window [5, n - 9)):

  * the sweep: at each ring depth of ``--depths`` and width of
    ``--widths`` (n = 2^20 and 2^24),
    the solo tensor-core form of K4 and K14, each with and without the .
    gp column, at every program cap of ``SOLO_CAPS`` (132 x 1-32; the
    chunk, warps and stages of ``factory.MMA_EPILOGUE``), timed, with its
    registers and spills and, at 2^20, its gaps to the plain version; per
    RP the cap whose launches spill nothing and sum the least time
    relative to the fastest launch of each (depth, n, form) is printed
    beside ``factory.SOLO_MMA_PROGRAMS`` (each program at most
    ``factory.MMA_MAX_CHUNKS`` chunks, as the grid keeps it);
  * the crossover: at each depth of ``--crossover`` and each width,
    the static fold form and the tensor-core form in turns, static,
    tensor-core, tensor-core, static, for K4 and K14 with and without the
    . gp column, with both forms' registers.

With ``--rows`` (the solo K4 and K14 in their tensor-core row-block form,
``factory.MMA_ROWS_EPILOGUE``; ``chip_smoke.deep_inputs``, K14 on the
window [5, n - 9)):

    PYTHONPATH=. python3 tools/tune_batched_epilogues.py --rows [--batched]
        [--pairs f32 f64 bf16] [--depths 9 19 80 200] [--rps 64 128] [--widths 1048576]
        [--jobs 6] [--reps N] [--out PATH]

  at each dtype pair of ``--pairs`` (f32 vectors over an f32 or a bf16
  ring, f64 over f64) and depth of ``--depths`` (bf16: above
  ``factory.MMA_MAX_M`` only), every launch of ``ROWS_GRID`` (block rows
  RP, chunk K, warps, stages) runs the . gp launches of K4 and K14 (one
  binary with the 3-column launch), timed (``chip_smoke.event_time``) with
  its registers, spills and gaps to the plain version; ``--jobs`` worker
  processes compile every launch first (``--rows-warm``), so the timing
  process only loads them.  Per (pair, RP) the launch whose runs spill
  nothing and sum the least time relative to the fastest of each (depth,
  n, form) is printed beside ``factory.MMA_ROWS_EPILOGUE``'s.  ``--rps``
  keeps the blocks of those row counts only.  With ``--batched`` the
  batched K4 b and K14 b run the sweep instead, at the batched main path's
  1024 x 2^14 (``chip_smoke.batched_generic_inputs``, every instance live
  in the timings), each launch's gaps to the plain version taken on
  ``BATCHED_CHECK_B`` instances, in place on copies (``--widths`` unused);
  ``--n 16386`` runs it at an n off 16 over the runner's padded ring.

Prints one JSON line per launch and depth, the card's nvidia-smi name and
power limit first; ``--out`` writes the same lines to a file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

import chip_smoke as cs
from lbfgs_torch.core import as_ring, is_ring
from lbfgs_torch.models import rosenbrock
from lbfgs_torch.ops import factory
from tools import parent_batched as pb

K = rosenbrock.value_and_grad.kernels
GRID = [(k, w, s) for k in (64, 128, 256) for w in (4, 8) for s in (1, 2, 3)]
#: the solo sweep's program caps and widths
SOLO_CAPS = [132 * k for k in (1, 2, 4, 8, 16, 32)]
SOLO_N = (1 << 20, 1 << 24)
#: the solo forms' rows in ``chip_smoke.cost``
SOLO_NAMES = {"K4": "K4_trial_pair_gram", "K4_gp": "K4_trial_pair_gram_gp",
              "K14": "K14_owlqn_trial_pair_gram", "K14_gp": "K14_owlqn_trial_pair_gram_gp"}


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


def solo_calls(a: dict) -> dict:
    """form: (the solo wrapper, its kernel call, its plain call), the ·gp
    forms with ``_gp``; each writes ring row ``cs.END`` of the inputs'
    rings (the same row every call)."""
    n = a["xp"].shape[0]
    out = {}
    for gp in (False, True):
        sfx = "_gp" if gp else ""
        for name, fn, args in (
                ("K4", "trial_pair_gram", (a["xp"], a["d"], a["gp"], cs.STP)),
                ("K14", "owlqn_trial_pair_gram",
                 (a["xp0"], a["d"], a["gp"], a["pg"], cs.STP, cs.C_L1, 5, n - 9))):
            out[name + sfx] = (getattr(K, fn), lambda f=getattr(K, fn), args=args, gp=gp: f(
                *args, a["S"], a["Y"], cs.END, with_gp=gp), lambda f=getattr(K, fn + "_ref"),
                args=args, gp=gp: f(*args, a["S"], a["Y"], cs.END, with_gp=gp))
    return out


def solo_sweep(m: int, widths: list, reps: int, emit) -> list:
    """The solo tensor-core form at depth m over ``widths`` and
    ``SOLO_CAPS``; returns the rows."""
    rp = max(16, 1 << (m - 1).bit_length())
    keep = factory.SOLO_MMA_PROGRAMS
    rows = []
    try:
        for n in widths:
            a = cs.numerics_inputs(n, m, cs.SEED + 70 + m)
            calls = solo_calls(a)
            want = {}
            if n <= 1 << 20:
                for form, (_, _, plain) in calls.items():
                    want[form] = plain()
            for cap in SOLO_CAPS:
                factory.SOLO_MMA_PROGRAMS = cap
                for form, (fn, call, _) in calls.items():
                    out = call()
                    f = fn.last_form
                    row = dict(solo_sweep=form, m=m, n=n, RP=rp, cap=cap, programs=f.programs,
                               chunks_per_program=f.tiles, K=f.T, kernel=f.kernel,
                               ms=cs.device_time(call, reps), timed_by=cs.device_time.source,
                               bound_ms=cs.bound(SOLO_NAMES[form], n, 4, 2, m)[0],
                               **cs._compiled_info(f.compiled))
                    if form in want:
                        row["sum_gap"] = max(cs.err(u, v) for u, v in zip(out, want[form])
                                             if u.dtype != torch.bool and u.ndim <= 2
                                             and u.numel() < n)
                    emit(row)
                    rows.append(row)
                    del out
            del a, calls, want
            torch.cuda.empty_cache()
    finally:
        factory.SOLO_MMA_PROGRAMS = keep
    return rows


def solo_best(rows: list, emit) -> None:
    """Per RP, the cap whose launches spill nothing and sum the least time
    relative to the fastest launch of each (depth, n, form)."""
    fastest = {}
    for r in rows:
        key = (r["m"], r["n"], r["solo_sweep"])
        fastest[key] = min(fastest.get(key, r["ms"]), r["ms"])
    for rp in sorted({r["RP"] for r in rows}):
        score = {}
        for r in rows:
            if r["RP"] == rp:
                rel = r["ms"] / fastest[(r["m"], r["n"], r["solo_sweep"])]
                score[r["cap"]] = score.get(r["cap"], 0.0) + (rel if r["n_spills"] == 0
                                                              else float("inf"))
        emit(dict(solo_best=rp, chosen=factory.SOLO_MMA_PROGRAMS,
                  fastest=min(score, key=score.get), relative_time_sums=score))


def solo_crossover(m: int, widths: list, reps: int, emit) -> None:
    """The static fold form against the tensor-core form at depth m, in
    turns, at ``widths``."""
    lo = factory.MMA_MIN_M
    try:
        for n in widths:
            factory.MMA_MIN_M = lo
            chosen = factory.solo_epilogue_grid(n, m, torch.float32, torch.bfloat16).form
            a = cs.numerics_inputs(n, m, cs.SEED + 80 + m)
            for form, (fn, call, _) in solo_calls(a).items():
                def run(label):
                    factory.MMA_MIN_M = m + 1 if label == "static" else 1
                    return cs.device_time(call, reps)

                info = {}
                for label in ("static", "mma"):
                    factory.MMA_MIN_M = m + 1 if label == "static" else 1
                    call()
                    info[label] = dict(kernel=fn.last_form.kernel,
                                       **cs._compiled_info(fn.last_form.compiled))
                s1, t1, t2, s2 = (run(label) for label in ("static", "mma", "mma", "static"))
                emit(dict(solo_crossover=form, m=m, n=n, static_ms=[s1, s2], mma_ms=[t1, t2],
                          bound_ms=cs.bound(SOLO_NAMES[form], n, 4, 2, m)[0], chosen=chosen,
                          **info))
            del a
            torch.cuda.empty_cache()
    finally:
        factory.MMA_MIN_M = lo


#: the row-block sweep's launches per dtype pair: (block rows RP, chunk K,
#: warps, stages)
ROWS_GRID = {
    pair: [(rp, k, w, st) for rp in rps for k in ks for w in (4, 8) for st in (1, 2, 3)]
    for pair, rps, ks in (("bf16", (128, 256), (32, 64, 128)),
                          ("f32", (16, 32, 64, 128), (32, 64, 128)),
                          ("f64", (16, 32, 64, 128), (16, 32, 64)))}
ROWS_PAIRS = {"bf16": (torch.float32, torch.bfloat16), "f32": (torch.float32, torch.float32),
              "f64": (torch.float64, torch.float64)}


#: the batched sweep's narrower grid per pair: (chunk K, warps, stages)
#: around the solo sweep's choices
BATCHED_GRID = {"bf16": ((64, 128), (4, 8), (2, 3)), "f32": ((32, 64), (4, 8), (2, 3)),
                "f64": ((16, 32), (4, 8), (2, 3))}


def rows_launches(pairs: list, depths: list, rps=None, batched: bool = False) -> list:
    """(pair name, m, RP, K, warps, stages) of every row-block launch the
    sweep runs: each depth at the RPs it can take (m rounded up to a power
    of two, at least 16, or a smaller block; with ``rps`` only those).
    ``batched``: each depth at its own RP (m rounded up, at most the
    grid's largest block) and those of ``rps``, over ``BATCHED_GRID``."""
    out = []
    for name in pairs:
        for m in depths:
            if name == "bf16" and m <= factory.MMA_MAX_M:
                continue
            top = max(16, 1 << (m - 1).bit_length())
            if batched:
                own = min(top, max(rp for rp, *_ in ROWS_GRID[name]))
                ks, ws, sts = BATCHED_GRID[name]
                out += [(name, m, rp, k, w, st) for rp, k, w, st in ROWS_GRID[name]
                        if (rp == own or rp in (rps or ())) and rp <= top and k in ks
                        and w in ws and st in sts]
                continue
            out += [(name, m, rp, k, w, st) for rp, k, w, st in ROWS_GRID[name]
                    if rp <= top and (not rps or rp in rps)]
    return out


#: the batched sweep's check instances (its timings take ``cs.BATCH_B``)
BATCHED_CHECK_B = 48
#: the batched sweep's launches: (wrapper, ``chip_smoke.cost``'s row)
BATCHED_FORMS = {"K4b_gp": ("trial_pair_gram_batched", "K4b_trial_pair_gram_batched_gp"),
                 "K14b_gp": ("owlqn_trial_pair_gram_batched",
                             "K14b_owlqn_trial_pair_gram_batched_gp")}


def batched_call(fn, a: dict, t: dict):
    """The . gp launch of the batched wrapper (or plain version) ``fn``
    (K4 b or K14 b by name) on the vectors and rings t, in place, every
    instance live."""
    n, m = a["xp"].shape[1], a["S"].shape[1]
    lo, hi = cs.windows(n)[1]
    every = torch.ones_like(a["live"])
    if fn.__name__.startswith("owlqn"):
        return fn(t["xp"], a["d"], t["gp"], t["pg"], a["stp"], cs.C_L1, lo, hi, t["S"], t["Y"],
                  m - 3, every, with_gp=True)
    return fn(t["xp"], a["d"], t["gp"], a["stp"], t["S"], t["Y"], m - 3, every, with_gp=True)


def padded(a: dict) -> dict:
    """The inputs with their rings in the runner's padded layout
    (``core.as_ring``: a row stride of n rounded up to a multiple of 16)."""
    return dict(a, S=as_ring(a["S"]), Y=as_ring(a["Y"]))


def fresh(a: dict) -> dict:
    """Copies of the vectors and rings, each ring in its own layout."""
    return {k: as_ring(v.clone()) if k in ("S", "Y") and is_ring(v) else v.clone()
            for k, v in pb.fresh(a).items()}


def batched_warm(part: int, parts: int, pairs: list, depths: list, rps, n: int) -> None:
    """``rows_warm`` for the batched forms: K4 b and K14 b . gp on 2 x
    4096 (at an n off 16, 2 x 4098 over the padded ring)."""
    for i, (name, m, rp, k, w, st) in enumerate(rows_launches(pairs, depths, rps, True)):
        if i % parts != part:
            continue
        a = padded(cs.batched_generic_inputs(cs.SEED, *ROWS_PAIRS[name], m, 2,
                                             4096 + n % 16))
        with rows_launch(ROWS_PAIRS[name], m, rp, k, w, st):
            for wrapper, _ in BATCHED_FORMS.values():
                try:
                    batched_call(getattr(K, wrapper), a, fresh(a))
                except Exception:  # the timing process records the refusal
                    pass
    torch.cuda.synchronize()


def batched_rows_sweep(pairs: list, depths: list, rps, reps: int, emit,
                       n: int = cs.BATCH_N) -> list:
    """Every batched row-block launch at 1024 x n (2^14 by default; the
    rings in the runner's padded layout), timed in place with every
    instance live, with its registers, spills and its gaps to the plain
    version on ``BATCHED_CHECK_B`` instances; returns the rows."""
    rows = []
    for name in pairs:
        pair = ROWS_PAIRS[name]
        vd, hd = pair
        for m in depths:
            launches = rows_launches([name], [m], rps, True)
            if not launches:
                continue
            small = padded(cs.batched_generic_inputs(cs.SEED + 90 + m, vd, hd, m,
                                                     BATCHED_CHECK_B, n))
            want = {}
            for form, (wrapper, _) in BATCHED_FORMS.items():
                t = fresh(small)
                want[form] = (t, batched_call(getattr(K, wrapper + "_ref"), small, t))
            a = padded(cs.batched_generic_inputs(cs.SEED + 91 + m, vd, hd, m, cs.BATCH_B, n))
            for _, _, rp, k, w, st in launches:
                with rows_launch(pair, m, rp, k, w, st):
                    for form, (wrapper, table) in BATCHED_FORMS.items():
                        fn = getattr(K, wrapper)
                        base = dict(rows_sweep=form, dtypes=name, m=m, B=cs.BATCH_B,
                                    n=n, RP=rp, K=k, num_warps=w, num_stages=st)
                        try:
                            t = fresh(small)
                            out = batched_call(fn, small, t)
                            torch.cuda.synchronize()
                        except Exception as e:  # a refused launch is a result
                            emit(dict(base, refused=f"{type(e).__name__}: {str(e)[-300:]}"))
                            continue
                        tq, oq = want[form]
                        vec = max(cs.err(t[v], tq[v]) for v in ("xp", "gp", "pg"))
                        sums = max(cs.err(u, v) for u, v in zip(out, oq)
                                   if u.dtype != torch.bool)
                        del t, out
                        row = dict(base, passes=-(-m // rp),
                                   ms=cs.event_time(lambda: batched_call(fn, a, a), reps),
                                   programs=fn.last_form.total,
                                   chunks_per_program=fn.last_form.tiles,
                                   bound_ms=cs.bound(table, cs.BATCH_B * n,
                                                     vd.itemsize, hd.itemsize, m)[0],
                                   vec_gap=vec, sum_gap=sums,
                                   **cs._compiled_info(fn.last_form.compiled))
                        emit(row)
                        rows.append(row)
            del a, small, want
            torch.cuda.empty_cache()
    return rows


class rows_launch:
    """Inside, the solo K4 and K14 take the row-block form at depth m with
    the launch (RP, K, warps, stages) for the pair."""

    def __init__(self, pair, m, rp, k, w, st):
        self.pair, self.m, self.cfg = pair, m, (rp, dict(K=k, num_warps=w, num_stages=st))

    def __enter__(self):
        self.saved = (dict(factory.MMA_ROWS_EPILOGUE), dict(factory.MMA_ROWS_RP))
        rp, cfg = self.cfg
        factory.MMA_ROWS_EPILOGUE[self.pair] = {rp: cfg}
        factory.MMA_ROWS_RP[self.pair] = rp
        self.forced = cs.rows_form_from(self.m)
        self.forced.__enter__()

    def __exit__(self, *exc):
        self.forced.__exit__(*exc)
        factory.MMA_ROWS_EPILOGUE, factory.MMA_ROWS_RP = (dict(t) for t in self.saved)


def rows_warm(part: int, parts: int, pairs: list, depths: list) -> None:
    """Compile launches part, part + parts, ... of ``rows_launches`` (a
    worker of ``--jobs``): K4 and K14 . gp at n = 4096."""
    for i, (name, m, rp, k, w, st) in enumerate(rows_launches(pairs, depths)):
        if i % parts != part:
            continue
        a = cs.deep_inputs(*ROWS_PAIRS[name], m, 4096)
        with rows_launch(ROWS_PAIRS[name], m, rp, k, w, st):
            for form in ("K4_gp", "K14_gp"):
                try:
                    solo_calls(a)[form][1]()
                except Exception:  # the timing process records the refusal
                    pass
    torch.cuda.synchronize()


def rows_sweep(pairs: list, depths: list, widths: list, reps: int, emit) -> list:
    """Every row-block launch at every width, timed, with its registers,
    spills and, at n <= 2^20, its gaps to the plain version; returns the
    rows."""
    rows = []
    for name in pairs:
        pair = ROWS_PAIRS[name]
        vd, hd = pair
        for m in depths:
            launches = [x for x in rows_launches([name], [m])]
            if not launches:
                continue
            for n in widths:
                a = cs.deep_inputs(vd, hd, m, n)
                calls = solo_calls(a)
                want = ({form: calls[form][2]() for form in ("K4_gp", "K14_gp")}
                        if n <= 1 << 20 else {})
                for _, _, rp, k, w, st in launches:
                    with rows_launch(pair, m, rp, k, w, st):
                        for form in ("K4_gp", "K14_gp"):
                            fn, call, _ = calls[form]
                            base = dict(rows_sweep=form, dtypes=name, m=m, n=n, RP=rp, K=k,
                                        num_warps=w, num_stages=st)
                            try:
                                out = call()
                                torch.cuda.synchronize()
                            except Exception as e:  # a refused launch is a result
                                emit(dict(base, refused=f"{type(e).__name__}: {str(e)[-300:]}"))
                                continue
                            f = fn.last_form
                            row = dict(base, passes=-(-m // rp), programs=f.programs,
                                       chunks_per_program=f.tiles,
                                       ms=cs.event_time(call, reps),
                                       bound_ms=cs.bound(SOLO_NAMES[form], n, vd.itemsize,
                                                         hd.itemsize, m)[0],
                                       **cs._compiled_info(f.compiled))
                            if form in want:
                                row["sum_gap"] = max(cs.err(u, v) for u, v in
                                                     zip(out, want[form])
                                                     if u.dtype != torch.bool and u.ndim <= 2
                                                     and u.numel() < n)
                            emit(row)
                            rows.append(row)
                            del out
                del a, calls, want
                torch.cuda.empty_cache()
    return rows


def rows_best(rows: list, emit) -> None:
    """Per (pair, RP), the launch whose runs spill nothing and sum the least
    time relative to the fastest run of each (depth, n, form)."""
    fastest = {}
    for r in rows:
        key = (r["dtypes"], r["m"], r["n"], r["rows_sweep"])
        fastest[key] = min(fastest.get(key, r["ms"]), r["ms"])
    for pair in sorted({r["dtypes"] for r in rows}):
        for rp in sorted({r["RP"] for r in rows if r["dtypes"] == pair}):
            score = {}
            for r in rows:
                if (r["dtypes"], r["RP"]) == (pair, rp):
                    launch = (r["K"], r["num_warps"], r["num_stages"])
                    rel = r["ms"] / fastest[(pair, r["m"], r["n"], r["rows_sweep"])]
                    score[launch] = score.get(launch, 0.0) + (rel if r["n_spills"] == 0
                                                              else float("inf"))
            best = min(score, key=score.get)
            emit(dict(rows_best=pair, RP=rp, K=best[0], num_warps=best[1], num_stages=best[2],
                      relative_time_sum=score[best],
                      chosen=factory.MMA_ROWS_EPILOGUE[ROWS_PAIRS[pair]].get(rp)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depths", type=int, nargs="*")
    ap.add_argument("--crossover", type=int, nargs="*")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out")
    ap.add_argument("--widths", type=int, nargs="*", default=list(SOLO_N))
    ap.add_argument("--solo", action="store_true",
                    help="the solo K4 and K14 at one instance instead of the batched forms")
    ap.add_argument("--rows", action="store_true",
                    help="the solo K4 and K14 in their tensor-core row-block form")
    ap.add_argument("--pairs", nargs="*", default=["f32", "f64", "bf16"],
                    choices=list(ROWS_PAIRS))
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--batched", action="store_true",
                    help="with --rows: the batched K4 b and K14 b at 1024 x 2^14")
    ap.add_argument("--rps", type=int, nargs="*", help="with --rows: these block row counts only")
    ap.add_argument("--n", type=int, default=cs.BATCH_N,
                    help="with --rows --batched: the instances' width (an n off 16 over the "
                         "padded ring)")
    ap.add_argument("--rows-warm", nargs=2, type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rows_warm:
        if args.batched:
            batched_warm(*args.rows_warm, args.pairs, args.depths, args.rps, args.n)
        else:
            rows_warm(*args.rows_warm, args.pairs, args.depths)
        return
    if args.depths is None:
        args.depths = ([9, 19, 80, 200, 260] if args.rows else [16, 19, 80, 200] if args.solo
                       else [6, 19, 48, 80, 200])
    if args.crossover is None:
        args.crossover = [8, 9, 12, 16] if args.solo else [6, 8, 12, 16, 19, 32]
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
    if args.rows:
        workers = [subprocess.Popen([sys.executable, __file__, "--rows-warm", str(i),
                                     str(args.jobs), "--pairs", *args.pairs, "--depths",
                                     *map(str, args.depths)]
                                    + (["--batched", "--n", str(args.n)] if args.batched else [])
                                    + (["--rps", *map(str, args.rps)] if args.rps else []))
                   for i in range(args.jobs)]
        for w in workers:
            w.wait()
        if args.batched:
            rows = batched_rows_sweep(args.pairs, args.depths, args.rps, args.reps, emit, args.n)
        else:
            rows = rows_sweep(args.pairs, args.depths, args.widths, args.reps, emit)
        rows_best(rows, emit)
        return
    if args.solo:
        rows = []
        for m in args.depths:
            rows += solo_sweep(m, args.widths, args.reps, emit)
        solo_best(rows, emit)
        for m in args.crossover:
            solo_crossover(m, args.widths, args.reps, emit)
        return
    for m in args.depths:
        sweep(m, args.reps if m <= factory.MAX_M else max(3, args.reps // 2), emit)
        torch.cuda.empty_cache()
    for m in args.crossover:
        crossover(m, args.reps, emit)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
