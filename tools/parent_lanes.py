"""The K-lane probes and R, the partials' second stage, against another tree
on one CUDA card.

    PYTHONPATH=. python3 tools/parent_lanes.py --parent DIR [--reps N] [--out FILE]

DIR is the root of another tree of this repository (e.g. a ``git archive``
of the parent commit unpacked under ``build/``), whose ``lbfgs_torch`` is
imported beside this one (``tools.tune_epilogues.load_tree``).  On the
seeded inputs of ``chip_smoke`` it runs:

  * bits: at 2, 4, 8 and 11 lanes, in both modes of the objective scalar,
    each lane of this tree's K2 s and K8 s (n = 2^24, f32; K8 s on the
    window [0, n - 1)) and of K2 b s and K8 b s (B x n = 1024 x 2^14, a
    third of the instances frozen) against this tree's one-lane K2, K8,
    K2 b and K8 b bit for bit; the first difference raises.  The gap to
    the other tree's lanes (R and torch's sums add in other orders) is
    printed, normwise;
  * times: each K-lane probe at 2, 4 and 8 lanes (the batched ones with
    every instance live), the wrapper's whole call (kernel and second
    stage), in turns other tree, this, this, other (``chip_smoke.device_time``), beside its bound
    (``chip_smoke.bound``) and the kernel alone in each tree (one
    profiler session, ``chip_smoke._kernel_only_ms``);
  * R against torch's sum at the paths' shapes (P = 16384 with C = 1-8 and
    4 + 6m at m = 6 and 80, K4's 4224 x 40, the batched [1024, 16, c]
    summed per instance; float32, and the wide form against torch's
    float64 sum), in turns torch, R, R, torch, with R held to its order
    twin bit for bit;
  * the deep epilogues' scalar sums against the static launch's (the
    fold forms alone, ``chip_smoke.static_forms_up_to``): K4 and K14,
    with and without the . gp column, at m = 65 against m = 6 on the same
    vectors at n = 2^20, in both trees: bit for bit or the normwise gap.

Prints one JSON line per result (and writes them to FILE with ``--out``),
the card's nvidia-smi name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from lbfgs_torch.models import rosenbrock
from lbfgs_torch.ops import factory, fused
from lbfgs_torch.orthantwise import Orthantwise, choose_orthant
from tools.tune_epilogues import load_tree

#: lane counts timed in turns, and checked (11: two launches, 8 + 3)
TIMED_LANES = (2, 4, 8)
CHECKED_LANES = (2, 4, 8, 11)
#: R's shapes: (rows, columns, instances); instances > 1 sum over axis 1
R_SHAPES = [(16384, c, 1) for c in (1, 2, 4, 5, 8, 4 + 6 * cs.M, 4 + 6 * 80)]
R_SHAPES += [(4224, 4 + 6 * cs.M, 1)] + [(16, c, 1024) for c in (2, 4, 8)]

OUT = []


def emit(**kw) -> None:
    OUT.append(kw)
    print(json.dumps(kw), flush=True)


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def lane_calls(rosen, s: dict, b: dict, K: int) -> dict:
    """name: the K-lane call of one tree on the solo inputs s and batched b."""
    rosen = rosen.value_and_grad.kernels
    steps = cs._ladder(cs.STP, K, torch.float32)
    stps = (b["stp"][:, None] * 0.5 ** torch.arange(K, device="cuda")).contiguous()
    lo, hi = 0, cs.N_BIG - 1
    return {
        "K2s": lambda: rosen.probe_steps(s["xp"], s["d"], steps),
        "K8s": lambda: rosen.owlqn_probe_steps(s["xp0"], s["d"], s["wp"], steps, cs.C_L1, lo,
                                               hi),
        "K2bs": lambda: rosen.probe_steps_batched(b["xp"], b["d"], stps, b["live"]),
        "K8bs": lambda: rosen.owlqn_probe_pg_steps_batched(b["xp"], b["d"], b["pg"], stps,
                                                           cs.C_L1, 0, cs.BATCH_N - 1,
                                                           b["live"]),
    }


def one_lane(rosen, s: dict, b: dict, K: int) -> dict:
    """name: the one-lane kernels' values at each of the K steps, [K] or
    [B, K]."""
    rosen = rosen.value_and_grad.kernels
    steps = cs._ladder(cs.STP, K, torch.float32)
    stps = (b["stp"][:, None] * 0.5 ** torch.arange(K, device="cuda")).contiguous()
    cols = [stps[:, j].contiguous() for j in range(K)]
    lo, hi = 0, cs.N_BIG - 1
    return {
        "K2s": torch.stack([rosen.probe(s["xp"], s["d"], t)[0] for t in steps]),
        "K8s": torch.stack([rosen.owlqn_probe(s["xp0"], s["d"], s["wp"], t, cs.C_L1, lo, hi)[0]
                            for t in steps]),
        "K2bs": torch.stack([rosen.probe_batched(b["xp"], b["d"], c, b["live"])[0]
                             for c in cols], dim=1),
        "K8bs": torch.stack([rosen.owlqn_probe_pg_batched(b["xp"], b["d"], b["pg"], c, cs.C_L1,
                                                          0, cs.BATCH_N - 1, b["live"])[0]
                             for c in cols], dim=1),
    }


def lanes(prosen, reps: int) -> None:
    s = cs.inputs(cs.N_BIG, torch.float32, torch.bfloat16, cs.SEED + 30)
    s["wp"] = choose_orthant(Orthantwise(cs.C_L1, 0, cs.N_BIG - 1), s["xp0"], s["pg"])
    b = cs.batched_inputs(cs.SEED + 32)
    b["pg"] = torch.randn(b["xp"].shape, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(cs.SEED + 33))
    live = b["live"]
    pfused = sys.modules["parent_lbfgs_torch.ops.fused"]
    for K in CHECKED_LANES:
        for wide in (False, True):
            with fused.wide_fx(wide), pfused.wide_fx(wide):
                mine = {k: f() for k, f in lane_calls(rosenbrock, s, b, K).items()}
                want = one_lane(rosenbrock, s, b, K)
                theirs = {k: f() for k, f in lane_calls(prosen, s, b, K).items()}
            gaps = {}
            for name, got in mine.items():
                w, t = want[name], theirs[name]
                if got.ndim == 2:
                    got, w, t = got[live], w[live], t[live]
                if not torch.equal(got, w):
                    raise AssertionError(f"{name} K={K} wide={wide}: a lane differs from "
                                         f"the one-lane kernel")
                gaps[name] = gap(got, t)
            emit(check="lanes_vs_one_lane_kernels", lanes=K, wide=wide, bits="equal",
                 gap_to_other_tree=gaps)
    # timed with every instance live, as the batched main paths start
    every = dict(b, live=torch.ones_like(live))
    for K in TIMED_LANES:
        for name in ("K2s", "K8s", "K2bs", "K8bs"):
            mk = lane_calls(rosenbrock, s, every, K)[name]
            tk = lane_calls(prosen, s, every, K)[name]
            p1, k1, k2, p2 = (cs.device_time(f, reps) for f in (tk, mk, mk, tk))
            row = {"K2s": "K2_probe", "K8s": "K8_owlqn_probe", "K2bs": "K2_probe",
                   "K8bs": "K8_owlqn_probe"}[name]
            bnd = cs.bound(row, cs.N_BIG, 4, 2, cs.M)[0]
            emit(compare="other_tree", kernel=name, lanes=K, other_ms=min(p1, p2),
                 ms=min(k1, k2), runs=[p1, k1, k2, p2], bound_ms=bnd,
                 share_of_bound=bnd / min(k1, k2),
                 kernel_alone_ms=cs._kernel_only_ms(mk, reps, "probe_steps"),
                 other_kernel_alone_ms=cs._kernel_only_ms(tk, reps, "probe_steps"))


def r_shapes(reps: int) -> None:
    for P, C, B in R_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(P * C + B)
        shape, dim = ((P, C), 0) if B == 1 else ((B, P, C), 1)
        x = torch.randn(shape, generator=g, device="cuda")
        for wide in (False, True):
            got = fused.reduce_partials(x, dim, wide)
            if not torch.equal(got, fused.reduce_partials_order_ref(x, dim, wide)):
                raise AssertionError(f"R {shape} wide={wide}: not its order twin's bits")
            lib = lambda: (x.double() if wide else x).sum(dim=dim)
            mine = lambda: fused.reduce_partials(x, dim, wide)
            l1, k1, k2, l2 = (cs.device_time(f, reps) for f in (lib, mine, mine, lib))
            nbytes = x.numel() * 4 + got.numel() * got.element_size()
            emit(compare="torch_sum", shape=list(shape), dim=dim, wide=wide,
                 torch_ms=min(l1, l2), ms=min(k1, k2), runs=[l1, k1, k2, l2],
                 bound_ms=1e3 * max(nbytes / cs.HBM_BYTES_PER_S, x.numel() / cs.F32_OPS_PER_S),
                 gap_to_float64=gap(got, x.double().sum(dim=dim)))


def deep_sums(prosen) -> None:
    """K4 and K14 (±·gp) at m = 65 (deep fold form) against m = 6 (static)
    on the same vectors, in each tree."""
    n, m = 1 << 20, 65
    a = cs.deep_inputs(torch.float32, torch.bfloat16, m=m, n=n)
    xp, xp0, d, gp, pg, S, Y = (a[k] for k in ("xp", "xp0", "d", "gp", "pg", "S", "Y"))
    pfactory = sys.modules["parent_lbfgs_torch.ops.factory"]
    for label, rosen, fac in (("this", rosenbrock, factory), ("other", prosen, pfactory)):
        saved = fac.MMA_MAX_M
        fac.MMA_MAX_M = 0
        try:
            out = {}
            for with_gp in (False, True):
                for depth in (cs.M, m):
                    Sk, Yk = S[:depth].clone(), Y[:depth].clone()
                    k4 = rosen.trial_pair_gram(xp, d, gp, cs.STP, Sk, Yk, 2, with_gp=with_gp)
                    Sk, Yk = S[:depth].clone(), Y[:depth].clone()
                    k14 = rosen.owlqn_trial_pair_gram(xp0, d, gp, pg, cs.STP, cs.C_L1, 5, n - 9,
                                                      Sk, Yk, 2, with_gp=with_gp)
                    out[(with_gp, depth)] = (k4, k14)
            res = {}
            for with_gp in (False, True):
                (s4, s14), (d4, d14) = out[(with_gp, cs.M)], out[(with_gp, m)]
                sums = {"K4": ((1, 3, 4, 5), s4, d4),
                        "K14": ((5, 6, 8, 9) if with_gp else (5, 6), s14, d14)}
                for form, (idx, st, dp) in sums.items():
                    key = f"{form}{' gp' if with_gp else ''}"
                    res[key] = {str(i): ("equal" if torch.equal(dp[i], st[i])
                                         else gap(dp[i], st[i])) for i in idx}
            emit(check="deep_vs_static_sums", tree=label, n=n, m=[cs.M, m], sums=res)
        finally:
            fac.MMA_MAX_M = saved


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    emit(card=card, lanes_of_r=fused.PARTIAL_LANES,
         library_lanes=fused._build.load_library().lbfgs_partials_lanes())
    prosen = load_tree(args.parent.resolve(), "parent_lbfgs_torch")
    try:
        lanes(prosen, args.reps)
        r_shapes(args.reps)
        deep_sums(prosen)
    finally:
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text("".join(json.dumps(r) + "\n" for r in OUT))


if __name__ == "__main__":
    main()
