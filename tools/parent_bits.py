"""Hold this tree's kernels to another tree's, bit for bit, on one CUDA card.

    PYTHONPATH=. python3 tools/parent_bits.py --parent DIR [--reps N]
        [--epilogue-depths 16 19 80 [--epilogue-n 1048576 16777216]
         [--epilogue-pairs bf16 f32 f64]] [--binaries]

DIR is the root of another tree of this repository (e.g. a ``git archive``
of the parent commit unpacked under ``build/``), whose ``lbfgs_torch`` is
imported beside this one.  On the same seeded inputs (``chip_smoke.inputs``)
both trees run:

  * every Triton kernel on the Rosenbrock objective, which binds no
    extras: K1, K2, K4 and its . gp form, K7, K8 in both forms, K14 and
    its . gp form, K15 and its damped-row form, K16, at m = 6 and 3, in
    the three dtype pairs, at n = 2^24 and at the ragged n; with the
    compiled epilogues' registers and spills;
  * the CUDA kernels K3, K6, K13, K5 (both forms) and K12 (both forms) at
    the ring depths ``DEPTHS``, in the three dtype pairs, at the ragged n
    (and m = 6 at n = 2^24).

Every output and every ring must be the other tree's bit for bit, except
K12's sums, which are held to the other tree's within the sum tolerance
(``chip_smoke.TOL``: K12's summation order is its own since it moved onto
K5's body); K12's rings stay bit for bit.  The first difference raises.
Then K3, K6, K13, K5 . gp, K4, K15, K1, K2, K8 (pg form), K14 and K16 are
timed at the main path's shapes (n = 2^24, f32 vectors, bf16 history,
m = 6) in turns, other tree, this, this, other (``chip_smoke.device_time``).

With ``--epilogue-depths`` it runs only the solo epilogues K4 and K14,
each with and without the . gp column, at those ring depths and the
widths of ``--epilogue-n``, in the dtype pairs of ``--epilogue-pairs``
(f32 vectors over bf16 rings, ``chip_smoke.numerics_inputs``, by default;
f32 over f32 rings and f64 over f64, ``chip_smoke.deep_inputs``; K14 on
the window [5, n - 9)): x, g, pg and both rings must be the other tree's
bit for bit (whatever form each tree picks), the sums and products within
the sum tolerance (normwise, the gap printed), then each is timed other
tree, this, this, other, with the form each tree ran and, where both ran
the same kernel, whether its PTX is the other tree's (``same_ptx``).

With ``--binaries`` it compiles, in both trees, every solo K4 and K14
form (at m = 6 in the three dtype pairs, the tensor-core form over bf16
rings of 16-256 rows, the fold forms at an n off a multiple of 16, the
row-block form over f32 and f64 rings at m = 80 and a bf16 ring at 260)
and every batched K4 b and K14 b form, each with and without the . gp
column at small sizes, and prints whether each kernel's PTX is the other
tree's (``ptx_code``: the debug lines and sections aside, the first
differing lines where it is not), on rings of row stride n; then the
Triton kernels that read no ring (K1 b, K7 b and the K-lane probes K2 s,
K8 s, K2 b s and K8 b s, at 4 lanes, n divisible by 16 or not, f32 and
f64), whose PTX must be the other tree's (``untouched_same``).  Against a
tree whose kernels take no ring stride every ring reader's PTX differs by
the stride's parameter and its row offsets.

Prints one JSON line per check group and per timed kernel; the card's
nvidia-smi name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from lbfgs_torch.models import rosenbrock
from lbfgs_torch.ops import fused
from tools.tune_epilogues import load_tree

#: ring depths the CUDA kernels are held to the other tree's at (80: the
#: deep-history path's)
DEPTHS = (1, 3, 5, 6, 8, 12, 33, 64, 80)


def _rings(a: dict, m: int) -> tuple:
    """Rings of m rows built from the inputs' M rows (repeated)."""
    reps = -(-m // cs.M)
    S = torch.cat([a["S"], a["Y"]] * reps)[:m].contiguous()
    Y = torch.cat([a["Y"], a["S"]] * reps)[:m].contiguous()
    return S, Y


def triton_calls(rosen, a: dict, n: int, S, Y) -> dict:
    """name: a call of one Triton kernel of the Rosenbrock module ``rosen``
    returning (outputs, rings it wrote)."""
    xp, d, gp, pg, xp0 = a["xp"], a["d"], a["gp"], a["pg"], a["xp0"]
    m = S.shape[0]
    coefs = (a["gamma"], a["cs"][:m], a["cy"][:m])
    ca, cb = (torch.tensor(v, dtype=xp.dtype, device="cuda") for v in (0.7, -0.2))
    hi = n - 1
    wp = torch.sign(xp0)

    def ring(fn):
        def call():
            Sk, Yk = S.clone(), Y.clone()
            out = fn(Sk, Yk)
            return out, (Sk, Yk)
        return call

    return {
        "K1": lambda: (rosen.trial(xp, d, cs.STP), ()),
        "K2": lambda: (rosen.probe(xp, d, cs.STP), ()),
        "K4": ring(lambda Sk, Yk: rosen.trial_pair_gram(xp, d, gp, cs.STP, Sk, Yk, 1)),
        "K4_gp": ring(lambda Sk, Yk: rosen.trial_pair_gram(xp, d, gp, cs.STP, Sk, Yk, 1,
                                                           with_gp=True)),
        "K7": lambda: (rosen.owlqn_trial(xp0, d, wp, cs.STP, cs.C_L1, 0, hi), ()),
        "K8": lambda: (rosen.owlqn_probe(xp0, d, wp, cs.STP, cs.C_L1, 0, hi), ()),
        "K8_pg": lambda: (rosen.owlqn_probe_pg(xp0, d, pg, cs.STP, cs.C_L1, 0, hi), ()),
        "K14": ring(lambda Sk, Yk: rosen.owlqn_trial_pair_gram(
            xp0, d, gp, pg, cs.STP, cs.C_L1, 0, hi, Sk, Yk, 1)),
        "K14_gp": ring(lambda Sk, Yk: rosen.owlqn_trial_pair_gram(
            xp0, d, gp, pg, cs.STP, cs.C_L1, 0, hi, Sk, Yk, 1, with_gp=True)),
        "K15": lambda: (rosen.combine_probe(gp, xp, S, Y, *coefs, 1.0), ()),
        "K15_fix": ring(lambda Sk, Yk: rosen.combine_probe(gp, xp, Sk, Yk, *coefs, 0.37,
                                                           fix=(1, ca, cb))),
        "K16": lambda: (rosen.combine_ow_probe(pg, xp0, S, Y, *coefs, cs.C_L1, 0, hi, 1.0),
                        ()),
    }


def cuda_calls(fz, a: dict, S, Y, x9) -> dict:
    """name: a call of one CUDA kernel of the ``fused`` module ``fz``."""
    m = S.shape[0]
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + m)
    cs_, cy_ = (torch.randn(m, generator=g, device="cuda", dtype=torch.float64).to(a["gp"].dtype)
                for _ in range(2))
    coefs = (a["gamma"], cs_, cy_)
    ca, cb = (torch.tensor(v, dtype=a["gp"].dtype, device="cuda") for v in (0.7, -0.2))
    end = m - 1
    return {
        "K3": lambda: (fz.combine(a["gp"], S, Y, *coefs), ()),
        "K6": lambda: _ring(lambda Sk, Yk: fz.combine_fix(a["gp"], Sk, Yk, *coefs, end, ca,
                                                          cb), S, Y),
        "K13": lambda: (fz.combine_ow(a["pg"], S, Y, *coefs, 0, a["gp"].shape[0] - 1), ()),
        "K5": lambda: _ring(lambda Sk, Yk: fz.pair_gram_sd(cs.STP, a["d"], a["pg"], a["gp"],
                                                           Sk, Yk, end), S, Y),
        "K5_gp": lambda: _ring(lambda Sk, Yk: fz.pair_gram_sd(
            cs.STP, a["d"], a["pg"], a["gp"], Sk, Yk, end, with_gp=True), S, Y),
        "K12": lambda: _ring(lambda Sk, Yk: fz.pair_gram_xg(
            x9, a["xp0"], a["pg"], a["gp"], a["xp"], Sk, Yk, end), S, Y),
        "K12_gp": lambda: _ring(lambda Sk, Yk: fz.pair_gram_xg(
            x9, a["xp0"], a["pg"], a["gp"], a["xp"], Sk, Yk, end, with_gp=True), S, Y),
    }


def _ring(fn, S, Y):
    Sk, Yk = S.clone(), Y.clone()
    return fn(Sk, Yk), (Sk, Yk)


def _flat(out) -> list:
    res = []
    for v in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(v, (tuple, list)):
            res.extend(_flat(v))
        elif isinstance(v, torch.Tensor):
            res.append(v)
    return res


def same(name: str, mine, theirs) -> None:
    a, b = _flat(mine), _flat(theirs)
    if len(a) != len(b):
        raise AssertionError(f"{name}: {len(a)} outputs against {len(b)}")
    for i, (p, q) in enumerate(zip(a, b)):
        if not cs.same_bits(p, q):
            raise AssertionError(f"{name}: output {i} differs from the other tree's")


def agrees(name: str, mine, theirs, tol: float) -> None:
    """K12 against the other tree's: the rings (the last two outputs) bit
    for bit, every other output within the normwise tolerance."""
    a, b = _flat(mine), _flat(theirs)
    if len(a) != len(b):
        raise AssertionError(f"{name}: {len(a)} outputs against {len(b)}")
    for i, (p, q) in enumerate(zip(a, b)):
        if i >= len(a) - 2:
            if not cs.same_bits(p, q):
                raise AssertionError(f"{name}: ring {i} differs from the other tree's")
        else:
            cs.check(f"{name}: output {i} against the other tree's", p, q, tol)


def compiled(rosen) -> dict:
    out = {}
    for kern, fn in (("K4", rosen.trial_pair_gram), ("K14", rosen.owlqn_trial_pair_gram)):
        for (vd, hd, with_gp), k in fn.compiled.items():
            k._init_handles()
            key = f"{kern}{'_gp' if with_gp else ''} {vd} {hd}".replace("torch.", "")
            out[key] = (k.n_regs, k.n_spills)
    return out


#: the dtype pairs of ``--epilogue-pairs``
PAIRS = {"bf16": (torch.float32, torch.bfloat16), "f32": (torch.float32, torch.float32),
         "f64": (torch.float64, torch.float64)}


def ptx_code(ck) -> list:
    """A compiled Triton kernel's PTX lines without its debug lines
    (``.loc``, ``.file``, comments, the ``$L__tmp`` labels that mark source
    locations) and debug sections, which follow the source's lines."""
    ptx = ck.asm["ptx"]
    cut = ptx.find(".section\t.debug")
    lines = (ptx if cut < 0 else ptx[:cut]).splitlines()
    return [ln for ln in lines if not ln.strip().startswith((".loc", ".file", "//", "$L__tmp"))]


def same_ptx(mine, theirs):
    """Whether two launches' last compiled kernels (``fn.last_form``) have
    the same PTX, or None where they ran different kernels."""
    f, g = mine.last_form, theirs.last_form
    return ptx_code(f.compiled) == ptx_code(g.compiled) if f.kernel == g.kernel else None


def ptx_diff(mine, theirs, lines: int = 12) -> list:
    """The first lines where two launches' PTX differ (``difflib``)."""
    import difflib
    a, b = ptx_code(theirs.last_form.compiled), ptx_code(mine.last_form.compiled)
    return [ln for ln in difflib.unified_diff(a, b, "other", "this", n=0, lineterm="")][:lines]


def ptx_diff_lines(mine, theirs) -> int:
    """How many PTX lines two launches' kernels differ by (``difflib``)."""
    import difflib
    a, b = ptx_code(theirs.last_form.compiled), ptx_code(mine.last_form.compiled)
    return sum(1 for ln in difflib.unified_diff(a, b, n=0, lineterm="")
               if ln[:1] in "+-" and not ln.startswith(("+++", "---")))


def epilogue_depths(prosen, depths: list, widths: list, reps: int, pairs=("bf16",)) -> None:
    """``--epilogue-depths``: the solo K4 and K14 (±·gp) of both trees."""
    for pair, n, m in ((p, n, m) for p in pairs for n in widths for m in depths):
        vd, hd = PAIRS[pair]
        tol = cs.TOL[(vd, "sum")]
        a = (cs.numerics_inputs(n, m, cs.SEED + 40 + m) if pair == "bf16"
             else cs.deep_inputs(vd, hd, m, n))

        def calls(rosen, S, Y):
            return {
                "K4": lambda: rosen.trial_pair_gram(a["xp"], a["d"], a["gp"], cs.STP, S, Y,
                                                    cs.END),
                "K4_gp": lambda: rosen.trial_pair_gram(a["xp"], a["d"], a["gp"], cs.STP, S,
                                                       Y, cs.END, with_gp=True),
                "K14": lambda: rosen.owlqn_trial_pair_gram(
                    a["xp0"], a["d"], a["gp"], a["pg"], cs.STP, cs.C_L1, 5, n - 9, S, Y,
                    cs.END),
                "K14_gp": lambda: rosen.owlqn_trial_pair_gram(
                    a["xp0"], a["d"], a["gp"], a["pg"], cs.STP, cs.C_L1, 5, n - 9, S, Y,
                    cs.END, with_gp=True),
            }

        for name in ("K4", "K4_gp", "K14", "K14_gp"):
            outs = {}
            for label, rosen in (("this", rosenbrock), ("other", prosen)):
                S, Y = a["S"].clone(), a["Y"].clone()
                out = calls(rosen, S, Y)[name]()
                outs[label] = (out, S, Y)
            (mine, S1, Y1), (theirs, S2, Y2) = outs["this"], outs["other"]
            if not (cs.same_bits(S1, S2) and cs.same_bits(Y1, Y2)):
                raise AssertionError(f"{name} m={m} n={n}: the rings differ")
            vec = (0, 1, 2) if name.startswith("K14") else (0, 2)
            gaps = []
            for i, (u, v) in enumerate(zip(mine, theirs)):
                if i in vec or u.dtype == torch.bool:
                    if not cs.same_bits(u, v):
                        raise AssertionError(f"{name} m={m} n={n}: output {i} differs")
                else:
                    gaps.append(cs.check(f"{name} m={m} n={n} output {i}", u, v, tol)[1])
            del outs, mine, theirs, S1, Y1, S2, Y2
            wrapper = ("owlqn_trial_pair_gram" if name.startswith("K14")
                       else "trial_pair_gram")
            fn, pfn = getattr(rosenbrock, wrapper), getattr(prosen, wrapper)
            mk, tk = calls(rosenbrock, a["S"], a["Y"])[name], calls(prosen, a["S"],
                                                                     a["Y"])[name]
            p1, k1, k2, p2 = (cs.device_time(f, reps) for f in (tk, mk, mk, tk))
            cs.emit(compare="other_tree", kernel=name, dtypes=pair, m=m, n=n,
                    other_ms=min(p1, p2), ms=min(k1, k2), runs=[p1, k1, k2, p2],
                    timed_by=cs.device_time.source, form=fn.last_form.kernel,
                    other_form=pfn.last_form.kernel, programs=fn.last_form.programs,
                    chunks_per_program=fn.last_form.tiles,
                    **cs._compiled_info(fn.last_form.compiled),
                    same_ptx=same_ptx(fn, pfn),
                    bound_ms=cs.bound(("K4_trial_pair_gram" if name.startswith("K4")
                                       else "K14_owlqn_trial_pair_gram")
                                      + ("_gp" if name.endswith("_gp") else ""),
                                      n, vd.itemsize, hd.itemsize, m)[0],
                    vectors_and_rings="bit for bit", sum_gap=max(gaps))
        del a
        torch.cuda.empty_cache()


def binaries(prosen) -> None:
    """``--binaries``: the PTX of every solo and batched epilogue form, in
    both trees."""
    prosen_k = prosen.value_and_grad.kernels
    mine_k = rosenbrock.value_and_grad.kernels
    bf16 = PAIRS["bf16"]
    # (pair, m, n, whether the batched form there is the row-block form,
    # which the other tree does not have)
    cases = [(pair, m, n, False) for pair in PAIRS.values() for m, n in ((6, 4096), (6, 4098))]
    cases += [(bf16, m, 4096, False) for m in (16, 19, 80, 256)]
    cases += [(pair, 80, 4098, False) for pair in PAIRS.values()] + [(bf16, 260, 4098, False)]
    cases += [(pair, 80, 4096, True) for pair in (PAIRS["f32"], PAIRS["f64"])]
    cases += [(bf16, 260, 4096, True)]
    wrappers = (("trial_pair_gram", True), ("owlqn_trial_pair_gram", True),
                ("trial_pair_gram_batched", False), ("owlqn_trial_pair_gram_batched", False))
    rows = []
    for (vd, hd), m, n, rows_batched in cases:
        a = cs.deep_inputs(vd, hd, m, n)
        for gp in (False, True):
            for wrapper, solo in wrappers:
                for k in (mine_k, prosen_k):
                    fn = getattr(k, wrapper)
                    if solo and wrapper.startswith("owlqn"):
                        fn(a["xp0"], a["d"], a["gp"], a["pg"], cs.STP, 1.0, 5, n - 9,
                           a["S"].clone(), a["Y"].clone(), cs.END, with_gp=gp)
                    elif solo:
                        fn(a["xp"], a["d"], a["gp"], cs.STP, a["S"].clone(), a["Y"].clone(),
                           cs.END, with_gp=gp)
                    else:
                        x = torch.stack([a["xp"], a["xp0"]])
                        stp = torch.full((2,), cs.STP, dtype=vd, device="cuda")
                        live = torch.ones(2, dtype=torch.bool, device="cuda")
                        S, Y = torch.stack([a["S"]] * 2), torch.stack([a["Y"]] * 2)
                        args = (x, torch.stack([a["d"]] * 2), torch.stack([a["gp"]] * 2))
                        if wrapper.startswith("owlqn"):
                            fn(*args, torch.stack([a["pg"]] * 2), stp, 1.0, 5, n - 9, S, Y,
                               cs.END, live, with_gp=gp)
                        else:
                            fn(*args, stp, S, Y, cs.END, live, with_gp=gp)
                mine, theirs = getattr(mine_k, wrapper), getattr(prosen_k, wrapper)
                row = dict(kernel=mine.last_form.kernel, dtypes=f"{vd}/{hd}".replace(
                    "torch.", ""), m=m, n=n, with_gp=gp, same_ptx=same_ptx(mine, theirs),
                           new=rows_batched and not solo)
                if row["same_ptx"] is False:
                    row["diff"] = ptx_diff(mine, theirs)
                    row["diff_lines"] = ptx_diff_lines(mine, theirs)
                rows.append(row)
        del a
    untouched = []
    for vd in (torch.float32, torch.float64):
        for n in (4096, 4098):
            x = torch.ones(n, dtype=vd, device="cuda")
            xb = torch.ones((2, n), dtype=vd, device="cuda")
            stb = torch.full((2, 4), 0.5, dtype=vd, device="cuda")
            stp2 = torch.zeros(2, dtype=vd, device="cuda")
            live = torch.ones(2, dtype=torch.bool, device="cuda")
            for k in (mine_k, prosen_k):
                k.trial_batched(xb, xb, stp2, live, xb.clone(), xb.clone())
                k.owlqn_trial_batched(xb, xb, xb, stp2, 1.0, 0, n - 1, live, xb.clone(),
                                      xb.clone())
                k.probe_steps(x, x, stb[0].cpu().numpy())
                k.owlqn_probe_steps(x, x, x, stb[0].cpu().numpy(), 1.0, 0, n - 1)
                k.probe_steps_batched(xb, xb, stb, live)
                k.owlqn_probe_pg_steps_batched(xb, xb, xb, stb, 1.0, 0, n - 1, live)
    for wrapper in ("trial_batched", "owlqn_trial_batched", "probe_steps", "owlqn_probe_steps",
                    "probe_steps_batched", "owlqn_probe_pg_steps_batched"):
        mine, theirs = getattr(mine_k, wrapper).compiled, getattr(prosen_k, wrapper).compiled
        for key in sorted(mine, key=str):
            untouched.append(dict(kernel=wrapper, key=str(key), same_ptx=key in theirs and (
                ptx_code(mine[key]) == ptx_code(theirs[key]))))
    cs.emit(check="binaries", forms=rows,
            ring_readers_same=sum(bool(r["same_ptx"]) for r in rows),
            ring_readers=len(rows), untouched=untouched,
            untouched_same=all(r["same_ptx"] for r in untouched),
            new=[r["kernel"] for r in rows if r["new"]])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--epilogue-depths", type=int, nargs="*")
    ap.add_argument("--epilogue-n", type=int, nargs="*", default=[1 << 20])
    ap.add_argument("--epilogue-pairs", nargs="*", default=["bf16"], choices=list(PAIRS))
    ap.add_argument("--binaries", action="store_true")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    prosen = load_tree(args.parent.resolve(), "parent_lbfgs_torch")
    if args.binaries:
        binaries(prosen)
    if args.epilogue_depths:
        epilogue_depths(prosen, args.epilogue_depths, args.epilogue_n, args.reps,
                        args.epilogue_pairs)
    if args.binaries or args.epilogue_depths:
        return
    pfused = sys.modules["parent_lbfgs_torch.ops.fused"]
    for n in (cs.N_RAGGED, cs.N_BIG):
        for vd, hd in cs.DTYPES:
            a = cs.inputs(n, vd, hd, cs.SEED + n)
            tag = f"n={n} {vd} {hd}".replace("torch.", "")
            for m in (cs.M, 3):
                S, Y = a["S"][:m].contiguous(), a["Y"][:m].contiguous()
                mine, theirs = (triton_calls(r, a, n, S, Y) for r in (rosenbrock, prosen))
                for name in mine:
                    same(f"{name} m={m} {tag}", mine[name](), theirs[name]())
            x9 = fused.owlqn_trial_step(a["xp0"], a["d"], torch.sign(a["xp0"]), cs.STP, 0,
                                        n - 1)
            for m in (DEPTHS if n == cs.N_RAGGED else (cs.M,)):
                S, Y = _rings(a, m)
                mine, theirs = (cuda_calls(f, a, S, Y, x9) for f in (fused, pfused))
                for name in mine:
                    if name.startswith("K12"):
                        agrees(f"{name} m={m} {tag}", mine[name](), theirs[name](),
                               cs.TOL[(vd, "sum")])
                    else:
                        same(f"{name} m={m} {tag}", mine[name](), theirs[name]())
                del S, Y
            cs.emit(check="same_bits", n=n, dtypes=tag, triton_m=[cs.M, 3],
                    cuda_m=list(DEPTHS if n == cs.N_RAGGED else (cs.M,)))
            del a
            torch.cuda.empty_cache()
    cs.emit(check="registers", this=compiled(rosenbrock), other=compiled(prosen))
    a = cs.inputs(cs.N_BIG, torch.float32, torch.bfloat16, cs.SEED)
    S, Y, coefs = a["S"], a["Y"], (a["gamma"], a["cs"], a["cy"])
    ca, cb = (torch.tensor(v, device="cuda") for v in (0.7, -0.2))
    timed = {
        "K3": lambda f, r: lambda: f.combine(a["gp"], S, Y, *coefs),
        "K6": lambda f, r: lambda: f.combine_fix(a["gp"], S, Y, *coefs, cs.END, ca, cb),
        "K13": lambda f, r: lambda: f.combine_ow(a["pg"], S, Y, *coefs, 0, cs.N_BIG - 1),
        "K5_gp": lambda f, r: lambda: f.pair_gram_sd(cs.STP, a["d"], a["pg"], a["gp"], S, Y,
                                                     cs.END, with_gp=True),
        "K4": lambda f, r: lambda: r.trial_pair_gram(a["xp"], a["d"], a["gp"], cs.STP, S, Y,
                                                     cs.END),
        "K15": lambda f, r: lambda: r.combine_probe(a["gp"], a["xp"], S, Y, *coefs, 1.0),
        "K1": lambda f, r: lambda: r.trial(a["xp"], a["d"], cs.STP),
        "K2": lambda f, r: lambda: r.probe(a["xp"], a["d"], cs.STP),
        "K8_pg": lambda f, r: lambda: r.owlqn_probe_pg(a["xp0"], a["d"], a["pg"], cs.STP,
                                                       cs.C_L1, 0, cs.N_BIG - 1),
        "K14": lambda f, r: lambda: r.owlqn_trial_pair_gram(
            a["xp0"], a["d"], a["gp"], a["pg"], cs.STP, cs.C_L1, 0, cs.N_BIG - 1, S, Y, cs.END),
        "K16": lambda f, r: lambda: r.combine_ow_probe(a["pg"], a["xp0"], S, Y, *coefs,
                                                       cs.C_L1, 0, cs.N_BIG - 1, 1.0),
    }
    for name, make in timed.items():
        mk, tk = make(fused, rosenbrock), make(pfused, prosen)
        p1, k1, k2, p2 = (cs.device_time(f, args.reps) for f in (tk, mk, mk, tk))
        cs.emit(compare="other_tree", kernel=name, other_ms=min(p1, p2), ms=min(k1, k2),
                runs=[p1, k1, k2, p2])


if __name__ == "__main__":
    main()
