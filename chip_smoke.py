"""Drive the PyTorch port of the solver end to end on one NVIDIA GPU.

    python3 chip_smoke.py [--profile PATH]

Phases (any failure raises and the script exits nonzero):

  1. device: requires CUDA and prints the card's name and power limit;
  2. build: compiles the CUDA C++ kernels (nvcc, one process per source)
     and every Triton specialisation the later phases launch, and prints
     the seconds;
  3. kernels: K1-K4 and OWL-QN's K8 (both forms), K10, K13 and K14
     against their plain torch versions on the card at n = 2^24 and at a
     ragged even n, for f32 vectors with a bf16 and an f32 history and for
     f64 with f64, the OWL-QN kernels with the window [0, n - 1) and with
     one whose ends are off the blocks' boundaries (K4's and K14's ring
     writes bit for bit, K8's two forms bit for bit against each other),
     and each kernel's time at n = 2^24 beside its plain version's (device
     time from torch.profiler, a session that saw nothing on the card run
     again and, after three such, CUDA events behind a spin kernel; the
     event times of every kernel are printed beside the profiler's);
  4. goldens: the n = 100 float64 Rosenbrock runs through the kernels
     (35 iterations at the defaults; the recorded 2018 trajectory,
     38 iterations, without the step cap), through ``lbfgs().minimize``
     and through ``minimize_jit``;
  5. OWL-QN golden: from that L-BFGS solution, OWL-QN with c = 1 on
     [0, 99) without the step cap, through both entry points and the
     kernels (the recorded fx 43.50249999999999, x[0] 0.25, x[1] 0.0575);
  6. main path: n = 2^24 Rosenbrock, f32, m = 6, bf16 history,
     More-Thuente, uncapped step, epsilon 0, 100 iterations of
     ``minimize_jit``, with the kernel launch counts checked (K1 once, K4
     and the combine+probe fusion K15 per iteration, K2 per probe that
     K15 did not carry in); then ``minimize_jit`` through the plain
     versions on the card against the kernels, after 8 and after 15
     iterations;
  7. OWL-QN main path: n = 2^24, f32, m = 6, bf16 history, c = 1 on
     [0, n - 1), BacktrackingArmijo, uncapped step, time to epsilon 3e-2
     within 300 iterations of ``minimize_jit`` (K1 and K10 once, K14 and
     K16 per iteration, K8 per probe not carried in), with the launch
     counts checked (no plain version and no plain stand-in runs); then
     the plain versions against the kernels after 8 and 15 iterations;
  8. north star: n = 1e8, m = 3, time to epsilon 3e-2;
  9. damped f64 n = 100: Powell damping, with ``damping_fixed``, and
     damped OWL-QN (c = 1 on [0, 99)), 50 iterations each through
     ``minimize`` with a progress callback (the capped step: K6, K13),
     per iteration against the same runs on the CPU, and against the JAX
     package's recorded runs (``DAMPED_N100``); damping case 1 and case 2
     must fire;
 10. LJ38: the reference's 38-atom cluster in f64 on the card, default
     L-BFGS to the relaxed energy, and ``with_gradient_only()`` for 50
     iterations per iteration against the CPU (the composed damped
     branch and K3);
 11. damped main path: the plain main path with ``damping=True`` (K1, K2
     per probe not carried in, K4 with its . gp column and K15's form
     that persists the damped row per iteration), then through the plain
     versions against the kernels after 8 and 15 iterations;
 12. gradient-only main path: the same size with
     ``with_gradient_only()``, 50 iterations;
 13. damped OWL-QN main path: the OWL-QN main path with ``damping=True``
     (K8 per probe not carried in, K14 with its . gp columns and K16 per
     iteration);
 14. K5 route: a Rosenbrock that has the trial and probe kernels but no
     one-pass epilogue, damped, 10 iterations at n = 2^24 (K1 per
     materialized trial, K2, K5 with the . gp column and K6);
 15. Poisson main path: the L1 Poisson regression at the JAX package's
     at-scale width (2048 x 2^20, X float32, seed 0), c = 1 on [1, n),
     m = 6, bf16 history, BacktrackingArmijo, epsilon 0, 100 iterations
     of ``minimize_jit`` through the composed OWL-QN branch (K11 once, K9
     per trial point, K10, K12 and K13 per iteration), then the same with
     ``with_fx_wide()``;
 16. Poisson f64: 500 x 21 float64 (the reference's shape), c = 1 on
     [1, 21), epsilon 1e-4, through ``minimize`` per iteration against
     the same run on the CPU;
 17. f32 floor: the 512 x 64 Poisson pair of runs, float32 and wide,
     through the step-at-a-time loop, their statuses recorded;
 18. wide OWL-QN main path: the OWL-QN main path with ``with_fx_wide()``
     (K7 once at the start, then K8, K14, K16): 12 iterations against the
     default run, then the run to epsilon 3e-2;
 19. OWL-QN north star: n = 1e8, m = 3, c = 1 on [0, n - 1), epsilon
     3e-2, within 300 iterations, wide and then default;
 20. unfused main path: the main path on an objective without the
     combine+probe fusion's hooks, so K3 runs in place of K15 and K2 on
     every probe; its syncs and probes per iteration beside the main
     path's (the fusion must save at least half a read per iteration);
     the main path against it and against its plain versions after 8
     and 15 iterations; ms/iter of both in turns; then both stepped side
     by side, printing for how many iterations they agree bit for bit
     and in their evaluations;
 21. unfused OWL-QN main path: the same for the OWL-QN main path, K13 in
     place of K16, CONVERGED at epsilon 3e-2;
 22. adaptive entry: the OWL-QN main path with
     ``with_adaptive_entry_step(2.0)``, with and without the fusion, each
     CONVERGED, evaluations beside the literal run's;
 23. unfused damped main path: 30 iterations with K6 in place of K15's
     damped-row form, and the same trajectory checks;
 24. launch_overhead: microseconds per back-to-back launch of the
     calibration kernel (``csrc/calibrate.cu``) and per launch with one
     synchronising read, and the share of each main path's ms/iter that
     its launches and reads per iteration explain;
 25. with ``--profile PATH`` only: one run of each main path (plain,
     OWL-QN, damped, damped OWL-QN, Poisson, and the first three without
     the fusion) under torch.profiler (device busy time against the
     unprofiled walls, device items, host launch and copy calls); the
     operator tables go to PATH.

Phase 3 also holds K15 (with its damped-row form), K16 (the
combine+probe fusions), K17 (axpy + dot) and the calibration kernel to
their plain versions (K15's and K16's probe scalars bit for bit those of
K2 and of K8's pg form at the point they form, in both objective-scalar
modes; their directions bit for bit K3's, K6's and K13's, so the step
cap, which picks one or the other, does not change the trajectory; the
damped row bit for bit K6's), prints each K4/K14 form's registers,
spills and 16-byte loads (``epilogue_compiled``: a form that spills
fails), and holds the OWL-QN kernels K7, K9, K11 and K12 to their plain
versions (K9's point, K11's pg against K10's, K12's ring rows and K7's
ft against K8's bit for bit), and a ``wide_kernels`` phase checks the
wide objective scalar's forms of K1, K2, K4, K7 and K8 against the
default launches and against a float64 sum on the host.

Prints one JSON line per phase result, the kernel table as one JSON line
before the last, and ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from lbfgs_torch import LbfgsError, default_evaluate, lbfgs
from lbfgs_torch.core import to_host
from lbfgs_torch.linesearch import carried
from lbfgs_torch.minimize import minimize_jit
from lbfgs_torch.models import lennard_jones, logistic, rosenbrock
from lbfgs_torch.ops import _build, factory, fused
from lbfgs_torch.orthantwise import Orthantwise, choose_orthant
from lbfgs_torch.params import Lbfgs, LbfgsParams, LineSearchAlgorithm
from lbfgs_torch.status import Status
from lbfgs_torch.utils import profiling

SEED = 20261016
N_BIG = 1 << 24
N_RAGGED = 3_000_002          # even, not a multiple of any kernel block
M = 6
STP, END = 0.37, 2
#: normwise tolerances (max |kernel - plain| / max |plain|): the kernels
#: sum in another order and may fuse a multiply-add, so f32 agrees to a
#: few ulps per element and to ~1e-6 on sums of 2^24 terms.  K4's ring
#: write has no tolerance: it is checked bit for bit (``check_ring``)
TOL = {
    (torch.float32, "vec"): 1e-5, (torch.float32, "sum"): 1e-4,
    (torch.float64, "vec"): 1e-12, (torch.float64, "sum"): 1e-10,
}
KERNELS = {
    "K1_trial": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                 "lbfgs_tpu/ops/factory.py:161"),
    "K2_probe": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                 "lbfgs_tpu/ops/factory.py:280"),
    "K3_combine": ("cuda", "lbfgs_torch/csrc/combine.cu",
                   "lbfgs_tpu/ops/fused.py:1359"),
    "K4_trial_pair_gram": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                           "lbfgs_tpu/ops/factory.py:722"),
    "K4_trial_pair_gram_gp": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                              "lbfgs_tpu/ops/factory.py:722 (with_gp)"),
    "K5_pair_gram": ("cuda", "lbfgs_torch/csrc/pair_gram.cu",
                     "lbfgs_tpu/ops/fused.py:837"),
    "K6_combine_fix": ("cuda", "lbfgs_torch/csrc/combine.cu",
                       "lbfgs_tpu/ops/fused.py:1216"),
    "K7_owlqn_trial": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                       "lbfgs_tpu/ops/factory.py:389"),
    "K8_owlqn_probe": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                       "lbfgs_tpu/ops/factory.py:487"),
    "K9_owlqn_trial_step": ("cuda", "lbfgs_torch/csrc/owlqn.cu",
                            "lbfgs_tpu/ops/fused.py:481"),
    "K10_pseudo_gradient_norm": ("cuda", "lbfgs_torch/csrc/owlqn.cu",
                                 "lbfgs_tpu/ops/fused.py:619"),
    "K11_pseudo_gradient": ("cuda", "lbfgs_torch/csrc/owlqn.cu",
                            "lbfgs_tpu/ops/fused.py:567"),
    "K12_pair_gram_xg": ("cuda", "lbfgs_torch/csrc/pair_gram.cu",
                         "lbfgs_tpu/ops/fused.py:1055"),
    "K13_combine_ow": ("cuda", "lbfgs_torch/csrc/combine.cu",
                       "lbfgs_tpu/ops/fused.py:1464"),
    "K14_owlqn_trial_pair_gram": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                                  "lbfgs_tpu/ops/factory.py:923"),
    "K14_owlqn_trial_pair_gram_gp": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                                     "lbfgs_tpu/ops/factory.py:923 (with_gp)"),
    "K15_combine_probe": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                          "lbfgs_tpu/ops/factory.py:1195"),
    "K15_combine_probe_fix": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                              "lbfgs_tpu/ops/factory.py:1195 (with K6's damped row, "
                              "lbfgs_tpu/ops/fused.py:1216)"),
    "K16_combine_ow_probe": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                             "lbfgs_tpu/ops/factory.py:1345"),
    "K17_axpy_dot": ("cuda", "lbfgs_torch/csrc/axpy_dot.cu", "lbfgs_tpu/ops/fused.py:743"),
    "cal_null_launch": ("cuda", "lbfgs_torch/csrc/calibrate.cu", "bench_kernels.py:108"),
}
#: the kernels each main path must launch, and whose launches the kernel
#: table shows from that path
PLAIN_PATH = ("K1_trial", "K2_probe", "K4_trial_pair_gram", "K15_combine_probe")
OWLQN_PATH = ("K1_trial", "K8_owlqn_probe", "K10_pseudo_gradient_norm",
              "K14_owlqn_trial_pair_gram", "K16_combine_ow_probe")
#: the kernel of each other path whose launches the kernel table shows
DAMPED_PATH = ("K4_trial_pair_gram_gp", "K15_combine_probe_fix")
DAMPED_OWLQN_PATH = ("K14_owlqn_trial_pair_gram_gp",)
K5_PATH = ("K5_pair_gram",)
POISSON_PATH = ("K9_owlqn_trial_step", "K11_pseudo_gradient", "K12_pair_gram_xg")
WIDE_OWLQN_PATH = ("K7_owlqn_trial",)
UNFUSED_PATH = ("K3_combine",)
UNFUSED_OWLQN_PATH = ("K13_combine_ow",)
UNFUSED_DAMPED_PATH = ("K6_combine_fix",)
#: stp1 values the fusions are checked at: the literal entry, and two an
#: adaptive entry can take
STP1 = (1.0, 0.37, 2.0 ** -3)
#: elements of the calibration kernel's one block
N_NULL = profiling.NULL_ELEMS


def cost(name: str, v: int, h: int, m: int) -> tuple:
    """(bytes, float operations) per element of one call of the kernel as
    the main paths run it, with v-byte vectors, an h-byte history and ring
    depth m: each input read once and each output written once (the ring
    row ``end`` that a pair update overwrites is not read), and the
    multiply-adds of its sums counted as two operations."""
    rings = 2 * (m - 1) * h + 2 * h
    return {
        "K1_trial": (4 * v, 20),
        "K2_probe": (2 * v, 16),
        "K3_combine": (2 * v + 2 * m * h, 4 * m + 6),
        "K4_trial_pair_gram": (5 * v + rings, 12 * m + 24),
        "K4_trial_pair_gram_gp": (5 * v + rings, 16 * m + 24),
        "K5_pair_gram": (3 * v + rings, 16 * m + 4),
        "K6_combine_fix": (2 * v + 2 * m * h + h, 4 * m + 10),
        "K7_owlqn_trial": (5 * v, 30),
        "K8_owlqn_probe": (3 * v, 24),
        "K9_owlqn_trial_step": (4 * v, 4),
        "K10_pseudo_gradient_norm": (3 * v, 6),
        "K11_pseudo_gradient": (3 * v, 4),
        "K12_pair_gram_xg": (5 * v + rings, 12 * m + 3),
        "K13_combine_ow": (2 * v + 2 * m * h, 4 * m + 10),
        "K14_owlqn_trial_pair_gram": (7 * v + rings, 12 * m + 40),
        "K14_owlqn_trial_pair_gram_gp": (7 * v + rings, 16 * m + 44),
        # K3's pass with x read and K2's probe added; K13's with K8's
        "K15_combine_probe": (3 * v + 2 * m * h, 4 * m + 22),
        # and K6's damped row: one more row written, its blend
        "K15_combine_probe_fix": (3 * v + 2 * m * h + h, 4 * m + 26),
        "K16_combine_ow_probe": (3 * v + 2 * m * h, 4 * m + 34),
        "K17_axpy_dot": (4 * v, 4),
        # reads and writes one float32 per element, at n = N_NULL
        "cal_null_launch": (8, 1),
    }[name]


#: the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM3
#: bytes/s and float32 operations/s outside the tensor cores
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12


def bound(name: str, n: int, v: int, h: int, m: int) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take
    for one call at n elements, the larger of its two bounds."""
    b, f = cost(name, v, h, m)
    t_bytes, t_ops = n * b / HBM_BYTES_PER_S, n * f / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
#: the OWL-QN kernels' L1 weight in the kernel checks (not 1: its
#: rounding to the vectors' dtype is part of what is checked)
C_L1 = 0.7
DTYPES = [
    (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32),
    (torch.float64, torch.float64),
]


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Normwise error max |a - b| / max |b|."""
    a, b = a.double(), b.double()
    scale = max(float(b.abs().max()), 1e-300)
    return float((a - b).abs().max()) / scale


def check(name: str, a: torch.Tensor, b: torch.Tensor, tol: float) -> tuple:
    """Hold a kernel output to its plain version's within the normwise
    tolerance; returns (max absolute error, normwise error)."""
    e = err(a, b)
    if not e <= tol:
        raise AssertionError(f"{name}: normwise error {e:.3e} exceeds {tol:.1e}")
    return float((a.double() - b.double()).abs().max()), e


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                            b.reshape(-1).contiguous().view(torch.uint8)))


def check_ring(name: str, S_out, Y_out, S_in, Y_in, s, y, end: int = END) -> None:
    """K4's, K5's and K14's ring write, bit for bit: row ``end`` holds the
    pair (s, y) rounded to the history dtype (round to nearest even), every
    other row is its input unchanged."""
    keep = [j for j in range(S_in.shape[0]) if j != end]
    for ring, out, inp, new in (("S", S_out, S_in, s), ("Y", Y_out, Y_in, y)):
        want = new.to(out.dtype)
        if not same_bits(out[end], want):
            bad = int((out[end] != want).sum())
            raise AssertionError(f"{name}: {ring}[end] differs from the rounded "
                                 f"pair in {bad} elements")
        if not same_bits(out[keep], inp[keep]):
            raise AssertionError(f"{name}: {ring} rows other than end changed")


def check_extends(name: str, base, ext, cols) -> None:
    """A . gp launch against the 3-column launch on the same inputs, bit
    for bit: the outputs at ``cols`` ([m, 4]) in their columns 0-2, every
    other output whole."""
    for i, (a, b) in enumerate(zip(base, ext)):
        if i in cols:
            if b.shape[1] != 4:
                raise AssertionError(f"{name}: output {i} has shape {tuple(b.shape)}")
            b = b[:, :3]
        if not same_bits(a, b):
            raise AssertionError(f"{name}: output {i} differs from the 3-column launch")


def wall_ms(fn, reps: int) -> float:
    """Milliseconds of host wall per call of fn over reps calls back to
    back, the card drained before and after (``profiling.timed``).  Where
    the host launches slower than the card runs (K1 and K2's wrappers)
    this is the host's launch time, not the card's."""
    return 1e3 * profiling.timed(lambda: [fn() for _ in range(reps)]) / reps


def device_events(prof) -> list:
    """The kernels and copies a torch.profiler run saw on the card."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


#: profiler sessions that saw nothing on the card and were run again, and
#: device times that came from CUDA events because every session was empty
PROFILER_MISSES = {"empty_sessions": 0, "event_timed": 0}


def profiled(fn, tries: int = 3):
    """(profiler, fn's value) of one call of fn under torch.profiler
    (``profiling.trace``), the card drained before the session closes.
    CUPTI now and then delivers no device activity for a session; such a
    session is run again, and after ``tries`` empty ones the profiler
    returned is None."""
    for _ in range(tries):
        with profiling.trace() as prof:
            out = fn()
            torch.cuda.synchronize()
        if sum(e.self_device_time_total for e in device_events(prof)) > 0:
            return prof, out
        PROFILER_MISSES["empty_sessions"] += 1
    return None, out


#: SM cycles per millisecond the spin kernel is sized by; above the
#: H100's 1.98 GHz boost clock, so the spin lasts at least as long as asked
SPIN_CYCLES_PER_MS = 2_000_000


def event_time(fn, reps: int) -> float:
    """Device milliseconds per call of fn from CUDA events around reps
    calls queued behind a spin kernel (``torch.cuda._sleep``) that lasts
    twice the host's time to launch them: the card reaches the first event
    only after the host has queued every call, so the events time the
    card's work and its gaps between kernels, not the host's launch rate.
    A call that reads back to the host drains the queue, and is then timed
    at its wall."""
    host_ms = wall_ms(fn, reps) * reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * host_ms * SPIN_CYCLES_PER_MS) + 1)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_time(fn, reps: int) -> float:
    """Device milliseconds per call of fn: the summed durations of every
    kernel and copy it puts on the card (kernel, partial sums,
    allocations' fills), from torch.profiler; from ``event_time`` where
    every profiler session came back empty."""
    fn()
    torch.cuda.synchronize()
    prof, _ = profiled(lambda: [fn() for _ in range(reps)])
    if prof is None:
        PROFILER_MISSES["event_timed"] += 1
        return event_time(fn, reps)
    return sum(e.self_device_time_total for e in device_events(prof)) / 1e3 / reps


def inputs(n: int, vd, hd, seed: int):
    """Seeded inputs of every kernel; xp has exact zeros at every 17th
    element (the OWL-QN orthant's at-zero choice) and pg is random."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda", dtype=torch.float64)
    xp = (rosenbrock.initial_point(n, torch.float64, "cuda") + 0.1 * r(n)).to(vd)
    xp0 = xp.clone()
    xp0[::17] = 0.0
    return dict(
        xp=xp, d=(0.1 * r(n)).to(vd), gp=r(n).to(vd),
        S=r(M, n).to(hd), Y=r(M, n).to(hd),
        gamma=torch.tensor(0.8, dtype=vd, device="cuda"),
        cs=r(M).to(vd), cy=r(M).to(vd),
        xp0=xp0, pg=r(n).to(vd),
    )


def windows(n: int) -> list:
    """The OWL-QN windows the kernels are checked on: the main path's
    [0, n - 1), and one whose ends fall inside kernel blocks."""
    return [(0, n - 1), (3 * 1024 + 5, n - 7 * 1024 - 3)]


# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # full-precision float32 products everywhere (the two-loop's [m, m]
    # algebra and the plain versions' matvecs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0], nvidia_smi=smi)
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    t_nvcc = time.perf_counter() - t0
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)
    # one launch per Triton specialisation the later phases use: the
    # dtype pair, n divisible by 16 or not, and the ring depth m
    t1 = time.perf_counter()
    for vd, hd in DTYPES:
        for n in (4096, 4098):
            for m in (M, 3):
                x = torch.ones(n, dtype=vd, device="cuda")
                S = torch.zeros((m, n), dtype=hd, device="cuda")
                rosenbrock.trial(x, x, 0.0)
                rosenbrock.probe(x, x, 0.0)
                rosenbrock.trial_pair_gram(x, x, x.clone(), 0.0, S, S.clone(), 1)
                z = torch.zeros(m, dtype=vd, device="cuda")
                fused.combine(x, S, S, z[0], z, z)
                # the combine+probe fusions (K15 with and without its
                # damped-row form, K16)
                rosenbrock.combine_probe(x, x, S, S, z[0], z, z, 1.0)
                rosenbrock.combine_probe(x, x, S, S.clone(), z[0], z, z, 1.0,
                                         fix=(1, z[0], z[0]))
                rosenbrock.combine_ow_probe(x, x, S, S, z[0], z, z, 1.0, 0, n - 1, 1.0)
            # the OWL-QN kernels run at m = M only
            S = torch.zeros((M, n), dtype=hd, device="cuda")
            rosenbrock.owlqn_trial(x, x, x, 0.0, 1.0, 0, n - 1)
            rosenbrock.owlqn_probe(x, x, x, 0.0, 1.0, 0, n - 1)
            rosenbrock.owlqn_probe_pg(x, x, x, 0.0, 1.0, 0, n - 1)
            rosenbrock.owlqn_trial_pair_gram(x, x, x.clone(), x.clone(), 0.0, 1.0, 0,
                                             n - 1, S, S.clone(), 1)
            # the damped paths' . gp specialisations
            rosenbrock.trial_pair_gram(x, x, x.clone(), 0.0, S, S.clone(), 1, with_gp=True)
            rosenbrock.owlqn_trial_pair_gram(x, x, x.clone(), x.clone(), 0.0, 1.0, 0,
                                             n - 1, S, S.clone(), 1, with_gp=True)
    # the OWL-QN north star's ring depth
    x = torch.ones(4096, device="cuda")
    S = torch.zeros((3, 4096), dtype=torch.bfloat16, device="cuda")
    rosenbrock.owlqn_trial_pair_gram(x, x, x.clone(), x.clone(), 0.0, 1.0, 0, 4095, S,
                                     S.clone(), 1)
    torch.cuda.synchronize()
    emit(phase="build", nvcc_s=round(t_nvcc, 3),
         triton_s=round(time.perf_counter() - t1, 3),
         triton=_build.import_triton().__version__)


def _fold(errs: dict, name: str, *pairs) -> None:
    a, r = errs[name]
    errs[name] = (max([a] + [p[0] for p in pairs]), max([r] + [p[1] for p in pairs]))


def phase_kernels() -> dict:
    errs = {k: (0.0, 0.0) for k in KERNELS}
    for n in (N_BIG, N_RAGGED):
        for vd, hd in DTYPES:
            a = inputs(n, vd, hd, SEED + n)
            tv, ts = TOL[(vd, "vec")], TOL[(vd, "sum")]
            tag = f"n={n} {vd} {hd}"
            # K1
            k = rosenbrock.trial(a["xp"], a["d"], STP)
            p = rosenbrock.trial_ref(a["xp"], a["d"], STP)
            _fold(errs, "K1_trial",
                  check(f"K1 xt {tag}", k[0], p[0], tv),
                  check(f"K1 g {tag}", k[2], p[2], tv),
                  *(check(f"K1 sum{i} {tag}", k[i], p[i], ts) for i in (1, 3, 4, 5)))
            if bool(k[6]) != bool(p[6]):
                raise AssertionError(f"K1 changed flag differs {tag}")
            # K2
            k = rosenbrock.probe(a["xp"], a["d"], STP)
            p = rosenbrock.probe_ref(a["xp"], a["d"], STP)
            _fold(errs, "K2_probe", *(check(f"K2 {tag} {i}", k[i], p[i], ts) for i in (0, 1)))
            # K3
            k = fused.combine(a["gp"], a["S"], a["Y"], a["gamma"], a["cs"], a["cy"])
            p = fused.combine_ref(a["gp"], a["S"], a["Y"], a["gamma"], a["cs"], a["cy"])
            _fold(errs, "K3_combine", check(f"K3 r {tag}", k[0], p[0], tv),
                  *(check(f"K3 sum{i} {tag}", k[i], p[i], ts) for i in (1, 2)))
            # K4 (the rings are written in place: each side gets a copy).
            # Row end must hold s = STP*d and y = g - gp, each side's own g,
            # rounded to the history dtype, bit for bit
            Sk, Yk, Sp, Yp = (a["S"].clone(), a["Y"].clone(),
                              a["S"].clone(), a["Y"].clone())
            k = rosenbrock.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, Sk, Yk, END)
            p = rosenbrock.trial_pair_gram_ref(a["xp"], a["d"], a["gp"], STP, Sp, Yp, END)
            s = STP * a["d"]
            check_ring(f"K4 kernel {tag}", Sk, Yk, a["S"], a["Y"], s, k[2] - a["gp"])
            check_ring(f"K4 plain {tag}", Sp, Yp, a["S"], a["Y"], s, p[2] - a["gp"])
            _fold(errs, "K4_trial_pair_gram",
                  check(f"K4 x {tag}", k[0], p[0], tv),
                  check(f"K4 g {tag}", k[2], p[2], tv),
                  *(check(f"K4 sum{i} {tag}", k[i], p[i], ts)
                    for i in (1, 3, 4, 5, 7, 8)))
            if bool(k[6]) != bool(p[6]):
                raise AssertionError(f"K4 changed flag differs {tag}")
            # K4 with the . gp column: the 3-column launch's outputs and
            # ring bit for bit, the column against the plain version
            Sg, Yg, Sq, Yq = (a["S"].clone(), a["Y"].clone(),
                              a["S"].clone(), a["Y"].clone())
            kg = rosenbrock.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, Sg, Yg, END,
                                            with_gp=True)
            pg_ = rosenbrock.trial_pair_gram_ref(a["xp"], a["d"], a["gp"], STP, Sq, Yq, END,
                                                 with_gp=True)
            check_extends(f"K4+gp {tag}", k, kg, (7, 8))
            if not (same_bits(Sg, Sk) and same_bits(Yg, Yk)):
                raise AssertionError(f"K4+gp ring differs from the 3-column launch {tag}")
            _fold(errs, "K4_trial_pair_gram_gp",
                  check(f"K4+gp g {tag}", kg[2], pg_[2], tv),
                  *(check(f"K4+gp sum{i} {tag}", kg[i], pg_[i], ts) for i in (7, 8)))
            del Sk, Yk, Sp, Yp, Sg, Yg, Sq, Yq, k, p, kg, pg_, s
            check_k5_k6(errs, a, tag, tv, ts)
            check_fusions(errs, a, n, tag, tv, ts)
            for lo, hi in windows(n):
                check_owlqn(errs, a, lo, hi, f"{tag} window=[{lo},{hi})", tv, ts)
                check_composed(errs, a, lo, hi, f"{tag} window=[{lo},{hi})", tv, ts)
            del a
            torch.cuda.empty_cache()
        emit(phase="kernels", n=n, max_abs_err={k: v[0] for k, v in errs.items()},
             max_normwise_err={k: v[1] for k, v in errs.items()},
             tol={"f32_vec": TOL[(torch.float32, "vec")],
                  "f32_sum": TOL[(torch.float32, "sum")],
                  "f64_vec": TOL[(torch.float64, "vec")],
                  "f64_sum": TOL[(torch.float64, "sum")],
                  "k4_k5_k6_k12_k14_ring_row": "bit-exact", "k8_forms": "bit-exact",
                  "with_gp_columns_0_2": "bit-exact", "k9_point": "bit-exact",
                  "k11_vs_k10_pg": "bit-exact", "k7_ft_vs_k8": "bit-exact",
                  "k15_probe_vs_k2": "bit-exact", "k16_probe_vs_k8_pg": "bit-exact",
                  "k15_fix_row_vs_k6": "bit-exact", "k15_r_vs_k3": "bit-exact",
                  "k15_fix_r_vs_k6": "bit-exact", "k16_rc_vs_k13": "bit-exact",
                  "k17_z": "bit-exact", "null_launch": "bit-exact"})

    check_k17_null(errs)

    # times at the main path's shapes: n = 2^24, f32 vectors, bf16 history
    a = inputs(N_BIG, torch.float32, torch.bfloat16, SEED)
    S, Y = a["S"], a["Y"]
    cases = {
        "K1_trial": (lambda: rosenbrock.trial(a["xp"], a["d"], STP),
                     lambda: rosenbrock.trial_ref(a["xp"], a["d"], STP)),
        "K2_probe": (lambda: rosenbrock.probe(a["xp"], a["d"], STP),
                     lambda: rosenbrock.probe_ref(a["xp"], a["d"], STP)),
        "K3_combine": (
            lambda: fused.combine(a["gp"], S, Y, a["gamma"], a["cs"], a["cy"]),
            lambda: fused.combine_ref(a["gp"], S, Y, a["gamma"], a["cs"], a["cy"])),
        "K4_trial_pair_gram": (
            lambda: rosenbrock.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, S, Y, END),
            lambda: rosenbrock.trial_pair_gram_ref(a["xp"], a["d"], a["gp"], STP, S, Y, END)),
    }
    # the OWL-QN kernels in the form the OWL-QN main path runs them: c = 1
    # on [0, n - 1), K8 with the orthant rebuilt from pg
    xp0, pg, hi = a["xp0"], a["pg"], N_BIG - 1
    ca, cb = (torch.tensor(v, dtype=torch.float32, device="cuda") for v in (0.7, -0.2))
    # the damped kernels in the form their paths run them: K4, K5 and K14
    # with the . gp column
    cases.update({
        "K4_trial_pair_gram_gp": (
            lambda: rosenbrock.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, S, Y, END,
                                               with_gp=True),
            lambda: rosenbrock.trial_pair_gram_ref(a["xp"], a["d"], a["gp"], STP, S, Y,
                                                   END, with_gp=True)),
        "K5_pair_gram": (
            lambda: fused.pair_gram_sd(STP, a["d"], pg, a["gp"], S, Y, END, with_gp=True),
            lambda: fused.pair_gram_sd_ref(STP, a["d"], pg, a["gp"], S, Y, END,
                                           with_gp=True)),
        "K6_combine_fix": (
            lambda: fused.combine_fix(a["gp"], S, Y, a["gamma"], a["cs"], a["cy"], END,
                                      ca, cb),
            lambda: fused.combine_fix_ref(a["gp"], S, Y, a["gamma"], a["cs"], a["cy"],
                                          END, ca, cb)),
        "K14_owlqn_trial_pair_gram_gp": (
            lambda: rosenbrock.owlqn_trial_pair_gram(xp0, a["d"], a["gp"], pg, STP, 1.0,
                                                     0, hi, S, Y, END, with_gp=True),
            lambda: rosenbrock.owlqn_trial_pair_gram_ref(xp0, a["d"], a["gp"], pg, STP,
                                                         1.0, 0, hi, S, Y, END,
                                                         with_gp=True)),
    })
    cases.update({
        "K8_owlqn_probe": (
            lambda: rosenbrock.owlqn_probe_pg(xp0, a["d"], pg, STP, 1.0, 0, hi),
            lambda: rosenbrock.owlqn_probe_pg_ref(xp0, a["d"], pg, STP, 1.0, 0, hi)),
        "K10_pseudo_gradient_norm": (
            lambda: fused.pseudo_gradient_norm(xp0, a["gp"], 1.0, 0, hi),
            lambda: fused.pseudo_gradient_norm_ref(xp0, a["gp"], 1.0, 0, hi)),
        "K13_combine_ow": (
            lambda: fused.combine_ow(pg, S, Y, a["gamma"], a["cs"], a["cy"], 0, hi),
            lambda: fused.combine_ow_ref(pg, S, Y, a["gamma"], a["cs"], a["cy"], 0, hi)),
        "K14_owlqn_trial_pair_gram": (
            lambda: rosenbrock.owlqn_trial_pair_gram(xp0, a["d"], a["gp"], pg, STP, 1.0,
                                                     0, hi, S, Y, END),
            lambda: rosenbrock.owlqn_trial_pair_gram_ref(xp0, a["d"], a["gp"], pg, STP,
                                                         1.0, 0, hi, S, Y, END)),
    })
    # the composed OWL-QN kernels in the form the Poisson main path runs
    # them, and K7 as the wide OWL-QN main path's init
    wp = choose_orthant(Orthantwise(1.0, 0, hi), xp0, pg)
    x9 = fused.owlqn_trial_step(xp0, a["d"], wp, STP, 0, hi)
    cases.update({
        "K7_owlqn_trial": (
            lambda: rosenbrock.owlqn_trial(xp0, a["d"], wp, STP, 1.0, 0, hi),
            lambda: rosenbrock.owlqn_trial_ref(xp0, a["d"], wp, STP, 1.0, 0, hi)),
        "K9_owlqn_trial_step": (
            lambda: fused.owlqn_trial_step(xp0, a["d"], wp, STP, 0, hi),
            lambda: fused.owlqn_trial_step_ref(xp0, a["d"], wp, STP, 0, hi)),
        "K11_pseudo_gradient": (
            lambda: fused.pseudo_gradient(xp0, a["gp"], 1.0, 0, hi),
            lambda: fused.pseudo_gradient_ref(xp0, a["gp"], 1.0, 0, hi)),
        "K12_pair_gram_xg": (
            lambda: fused.pair_gram_xg(x9, xp0, pg, a["gp"], a["xp"], S, Y, END),
            lambda: fused.pair_gram_xg_ref(x9, xp0, pg, a["gp"], a["xp"], S, Y, END)),
    })
    # the fusions in the form their main paths run them (stp1 = 1; the
    # damped-row form on a ring of its own, which it rewrites), K17 on
    # three of the inputs' vectors, the calibration kernel on one block
    xn = torch.zeros(N_NULL, device="cuda")
    Yf = Y.clone()
    cases.update({
        "K15_combine_probe": (
            lambda: rosenbrock.combine_probe(a["gp"], a["xp"], S, Y, a["gamma"], a["cs"],
                                             a["cy"], 1.0),
            lambda: rosenbrock.combine_probe_ref(a["gp"], a["xp"], S, Y, a["gamma"], a["cs"],
                                                 a["cy"], 1.0)),
        "K15_combine_probe_fix": (
            lambda: rosenbrock.combine_probe(a["gp"], a["xp"], S, Yf, a["gamma"], a["cs"],
                                             a["cy"], 1.0, fix=(END, ca, cb)),
            lambda: rosenbrock.combine_probe_ref(a["gp"], a["xp"], S, Yf, a["gamma"], a["cs"],
                                                 a["cy"], 1.0, fix=(END, ca, cb))),
        "K16_combine_ow_probe": (
            lambda: rosenbrock.combine_ow_probe(pg, xp0, S, Y, a["gamma"], a["cs"], a["cy"],
                                                1.0, 0, hi, 1.0),
            lambda: rosenbrock.combine_ow_probe_ref(pg, xp0, S, Y, a["gamma"], a["cs"],
                                                    a["cy"], 1.0, 0, hi, 1.0)),
        "K17_axpy_dot": (lambda: fused.axpy_dot(a["gp"], a["d"], 0.37, a["xp"]),
                         lambda: fused.axpy_dot_ref(a["gp"], a["d"], 0.37, a["xp"])),
        "cal_null_launch": (lambda: profiling.null_launch(xn),
                            lambda: profiling.null_launch_ref(xn)),
    })
    times, walls = {}, {}
    for name, (kern, plain) in cases.items():
        # plain, kernel, kernel, plain: both sides see the same clocks
        p1, k1, k2, p2 = (device_time(f, 20) for f in (plain, kern, kern, plain))
        times[name] = (min(k1, k2), min(p1, p2))
        walls[name] = (event_time(kern, 20), event_time(plain, 20))
    # the one kernel a single PyTorch call computes: the calibration
    # kernel's o = x + 1 (timed here only, used nowhere in the port)
    library = {"cal_null_launch": min(device_time(lambda: torch.add(xn, 1.0), 20)
                                      for _ in range(2))}
    # each kernel's bound from this run's shapes: n = 2^24, 4-byte vectors,
    # a 2-byte history, m = M
    bounds = {name: bound(name, N_NULL if name == "cal_null_launch" else N_BIG,
                          xp0.element_size(), S.element_size(), S.shape[0])
              for name in KERNELS}
    # what K15 replaces: K3 and one K2, two launches and 40 B/elem
    k3_k2 = dict(ms=times["K3_combine"][0] + times["K2_probe"][0],
                 bound_ms=bounds["K3_combine"][0] + bounds["K2_probe"][0])
    emit(phase="kernel_times", n=N_BIG, dtype="f32/bf16",
         device_ms={k: {"kernel": v[0], "plain": v[1], "bound": bounds[k][0]}
                    for k, v in times.items()},
         event_ms={k: {"kernel": v[0], "plain": v[1]} for k, v in walls.items()},
         library_ms=library, k15_replaces_k3_plus_k2=k3_k2)
    epilogue_compiled()
    pair_gram_compiled()
    del a, S, Y, Yf, x9, xn
    torch.cuda.empty_cache()
    return {"errs": errs, "times": times, "bounds": bounds, "library": library}


def epilogue_compiled() -> None:
    """Registers and spills of every compiled form of K4 and K14 (the last
    launch of each: at n = 2^24 for f32/bf16, the ragged n for the other
    dtype pairs), and the 16- and 8-byte global loads in its PTX; a form
    that spills fails the phase (the launch in ``factory.EPILOGUE`` is
    chosen not to)."""
    forms = []
    for kern, fn in (("K4", rosenbrock.trial_pair_gram),
                     ("K14", rosenbrock.owlqn_trial_pair_gram)):
        for (vd, hd, with_gp), k in sorted(fn.compiled.items(), key=str):
            k._init_handles()
            forms.append(dict(form=kern + ("_gp" if with_gp else ""),
                              vectors=str(vd).removeprefix("torch."),
                              history=str(hd).removeprefix("torch."), n_regs=k.n_regs,
                              n_spills=k.n_spills,
                              ld_global_v4=k.asm["ptx"].count("ld.global.v4"),
                              ld_global_v2=k.asm["ptx"].count("ld.global.v2")))
    emit(phase="epilogue_compiled", launch={"/".join(str(t).removeprefix("torch.") for t in k): v
                                            for k, v in factory.EPILOGUE.items()},
         programs_max=factory.EPILOGUE_PROGRAMS, forms=forms)
    spilled = [f for f in forms if f["n_spills"]]
    if spilled:
        raise AssertionError(f"K4/K14 forms spill registers: {spilled}")


#: K5's instantiations in ptxas's mangled names: vector and history type
#: (f float, d double, 13__nv_bfloat16), ring rows MP, the . gp column
K5_KERNEL = re.compile(r"pair_gram_sd_kernelI([fd])(13__nv_bfloat16|[fd])Li(\d+)ELb([01])E")
K5_TYPES = {"f": "float32", "d": "float64", "13__nv_bfloat16": "bfloat16"}


def ptxas_kernels(log: str) -> dict:
    """kernel (mangled name): registers, shared memory and spill bytes, from
    the ``-Xptxas=-v`` lines of the build log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        if m := re.search(r"Used (\d+) registers", line):
            out[name]["n_regs"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(smem.group(1)) if smem else 0
    return out


def pair_gram_compiled() -> list:
    """Registers, shared memory and spills of every K5 instantiation (three
    dtype pairs, six row counts, with and without the . gp column) from
    the build log; a form that spills, or a log that does not show all 36,
    fails the phase."""
    forms = []
    for name, info in ptxas_kernels(_build.build_log()).items():
        m = K5_KERNEL.search(name)
        if m:
            forms.append(dict(vectors=K5_TYPES[m.group(1)], history=K5_TYPES[m.group(2)],
                              rows=int(m.group(3)), with_gp=m.group(4) == "1", **info))
    forms.sort(key=lambda f: (f["vectors"], f["history"], f["rows"], f["with_gp"]))
    emit(phase="pair_gram_compiled", launch={"/".join(str(t).removeprefix("torch.") for t in k): v
                                             for k, v in fused.PAIR_GRAM.items()},
         blocks_max=fused.PAIR_GRAM_BLOCKS, forms=forms)
    if len(forms) != 36 or any("n_regs" not in f or "spill_stores" not in f for f in forms):
        raise AssertionError(f"K5: the build log shows {len(forms)} of 36 instantiations")
    spilled = [f for f in forms if f["spill_stores"] or f["spill_loads"]]
    if spilled:
        raise AssertionError(f"K5 instantiations spill registers: {spilled}")
    return forms


def check_fusions(errs: dict, a: dict, n: int, tag: str, tv: float, ts: float) -> None:
    """K15 and K16 against their plain versions at every stp1 of ``STP1``
    (K16 on both windows); their probe scalars bit for bit those of K2 at
    (x, r, stp1) and of K8's pg form at (x, rc, pg, stp1), in both
    objective-scalar modes (the remat contract); their directions bit for
    bit K3's, K6's and K13's (the CUDA combines round as the fusions do, so
    the step cap, which picks one or the other, does not change the
    trajectory), their r.r and r.g against those at the sum tolerance
    (another reduction tree)."""
    xp, gp, pg, S, Y = a["xp"], a["gp"], a["pg"], a["S"], a["Y"]
    coefs = (a["gamma"], a["cs"], a["cy"])
    k3 = fused.combine(gp, S, Y, *coefs)
    for stp1 in STP1:
        t = f"{tag} stp1={stp1}"
        k = rosenbrock.combine_probe(gp, xp, S, Y, *coefs, stp1)
        p = rosenbrock.combine_probe_ref(gp, xp, S, Y, *coefs, stp1)
        if not same_bits(k[0], k3[0]):
            raise AssertionError(f"K15's r differs from K3's in "
                                 f"{int((k[0] != k3[0]).sum())} elements {t}")
        _fold(errs, "K15_combine_probe", check(f"K15 r {t}", k[0], p[0], tv),
              *(check(f"K15 sum{i} {t}", k[i], p[i], ts) for i in (1, 2, 3, 4)),
              *(check(f"K15 sum{i} vs K3 {t}", k[i], k3[i], ts) for i in (1, 2)))
        for wide in (False, True):
            with fused.wide_fx(wide):
                kw = rosenbrock.combine_probe(gp, xp, S, Y, *coefs, stp1)
                k2 = rosenbrock.probe(xp, kw[0], stp1)
            if not (same_bits(kw[3], k2[0]) and same_bits(kw[4], k2[1])):
                raise AssertionError(f"K15's probe differs from K2's (wide={wide}) {t}: "
                                     f"{kw[3].item()} {k2[0].item()}")
    # K15's damped-row form: the fixed ring bit for bit the plain
    # version's and K6's, the probe bit for bit K2's at its r
    ca, cb = (torch.tensor(v, dtype=gp.dtype, device="cuda") for v in (0.7, -0.2))
    Yk, Yp, Y6 = Y.clone(), Y.clone(), Y.clone()
    k = rosenbrock.combine_probe(gp, xp, S, Yk, *coefs, 0.37, fix=(END, ca, cb))
    p = rosenbrock.combine_probe_ref(gp, xp, S, Yp, *coefs, 0.37, fix=(END, ca, cb))
    k6 = fused.combine_fix(gp, S, Y6, *coefs, END, ca, cb)
    if not (same_bits(Yk, Yp) and same_bits(Yk, Y6)):
        raise AssertionError(f"K15's damped row differs from the plain version's or K6's {tag}")
    if not same_bits(k[0], k6[0]):
        raise AssertionError(f"K15's fix form's r differs from K6's in "
                             f"{int((k[0] != k6[0]).sum())} elements {tag}")
    k2 = rosenbrock.probe(xp, k[0], 0.37)
    if not (same_bits(k[3], k2[0]) and same_bits(k[4], k2[1])):
        raise AssertionError(f"K15's damped-row form's probe differs from K2's {tag}")
    _fold(errs, "K15_combine_probe_fix", check(f"K15 fix r {tag}", k[0], p[0], tv),
          *(check(f"K15 fix sum{i} {tag}", k[i], p[i], ts) for i in (1, 2, 3, 4)),
          *(check(f"K15 fix sum{i} vs K6 {tag}", k[i], k6[i], ts) for i in (1, 2)))
    del Yk, Yp, Y6, k6
    for lo, hi in windows(n):
        k13 = fused.combine_ow(pg, S, Y, *coefs, lo, hi)
        for stp1 in STP1:
            t = f"{tag} window=[{lo},{hi}) stp1={stp1}"
            k = rosenbrock.combine_ow_probe(pg, a["xp0"], S, Y, *coefs, C_L1, lo, hi, stp1)
            p = rosenbrock.combine_ow_probe_ref(pg, a["xp0"], S, Y, *coefs, C_L1, lo, hi,
                                                stp1)
            if not same_bits(k[0], k13[0]):
                raise AssertionError(f"K16's rc differs from K13's in "
                                     f"{int((k[0] != k13[0]).sum())} elements {t}")
            _fold(errs, "K16_combine_ow_probe", check(f"K16 rc {t}", k[0], p[0], tv),
                  *(check(f"K16 sum{i} {t}", k[i], p[i], ts) for i in (1, 2, 3, 4, 5)),
                  *(check(f"K16 sum{i} vs K13 {t}", k[i], k13[i], ts) for i in (1, 2, 3)))
            for wide in (False, True):
                with fused.wide_fx(wide):
                    kw = rosenbrock.combine_ow_probe(pg, a["xp0"], S, Y, *coefs, C_L1, lo,
                                                     hi, stp1)
                    k8 = rosenbrock.owlqn_probe_pg(a["xp0"], kw[0], pg, stp1, C_L1, lo, hi)
                if not (same_bits(kw[4], k8[0]) and same_bits(kw[5], k8[1])):
                    raise AssertionError(f"K16's probe differs from K8's (wide={wide}) {t}: "
                                         f"{kw[4].item()} {k8[0].item()}")


def check_k17_null(errs: dict) -> None:
    """K17 at n = 2^24 and at N_RAGGED in both vector dtypes (z bit for bit
    the plain version's: the product and the sum are rounded one by one),
    and the calibration kernel bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    for n in (N_BIG, N_RAGGED):
        for vd in (torch.float32, torch.float64):
            y, x, w = (torch.randn(n, generator=g, device="cuda", dtype=vd) for _ in range(3))
            k = fused.axpy_dot(y, x, 0.37, w)
            p = fused.axpy_dot_ref(y, x, 0.37, w)
            if not same_bits(k[0], p[0]):
                raise AssertionError(f"K17's z differs from the plain version's n={n} {vd}")
            _fold(errs, "K17_axpy_dot", check(f"K17 z.w n={n} {vd}", k[1], p[1],
                                              TOL[(vd, "sum")]))
    x = torch.randn(N_NULL, generator=g, device="cuda")
    if not same_bits(profiling.null_launch(x), profiling.null_launch_ref(x)):
        raise AssertionError("the calibration kernel differs from x + 1")
    _fold(errs, "cal_null_launch", (0.0, 0.0))


def check_owlqn(errs: dict, a: dict, lo: int, hi: int, tag: str, tv: float,
                ts: float) -> None:
    """K8 (both forms), K10, K13 and K14 against their plain versions on
    one window; K8's two forms bit for bit against each other, K14's ring
    write bit for bit."""
    xp, d, gp, pg = a["xp0"], a["d"], a["gp"], a["pg"]
    wp = choose_orthant(Orthantwise(C_L1, lo, hi), xp, pg)
    # K8: materialized orthant and the orthant rebuilt from (xp, pg)
    k = rosenbrock.owlqn_probe(xp, d, wp, STP, C_L1, lo, hi)
    p = rosenbrock.owlqn_probe_ref(xp, d, wp, STP, C_L1, lo, hi)
    k2 = rosenbrock.owlqn_probe_pg(xp, d, pg, STP, C_L1, lo, hi)
    p2 = rosenbrock.owlqn_probe_pg_ref(xp, d, pg, STP, C_L1, lo, hi)
    _fold(errs, "K8_owlqn_probe",
          *(check(f"K8 wp {tag} {i}", k[i], p[i], ts) for i in (0, 1)),
          *(check(f"K8 pg {tag} {i}", k2[i], p2[i], ts) for i in (0, 1)))
    if not (same_bits(k[0], k2[0]) and same_bits(k[1], k2[1])):
        raise AssertionError(f"K8's two forms differ {tag}: {k} {k2}")
    # K10 on a point with exact zeros
    k = fused.pseudo_gradient_norm(xp, gp, C_L1, lo, hi)
    p = fused.pseudo_gradient_norm_ref(xp, gp, C_L1, lo, hi)
    _fold(errs, "K10_pseudo_gradient_norm", check(f"K10 pg {tag}", k[0], p[0], tv),
          check(f"K10 pg.pg {tag}", k[1], p[1], ts))
    # K13 with d = pg
    args = (pg, a["S"], a["Y"], a["gamma"], a["cs"], a["cy"], lo, hi)
    k = fused.combine_ow(*args)
    p = fused.combine_ow_ref(*args)
    _fold(errs, "K13_combine_ow", check(f"K13 rc {tag}", k[0], p[0], tv),
          *(check(f"K13 sum{i} {tag}", k[i], p[i], ts) for i in (1, 2, 3)))
    # K14: the ring row is the pair of each side's own projected x and g
    Sk, Yk, Sp, Yp = (a["S"].clone(), a["Y"].clone(), a["S"].clone(), a["Y"].clone())
    k = rosenbrock.owlqn_trial_pair_gram(xp, d, gp, pg, STP, C_L1, lo, hi, Sk, Yk, END)
    p = rosenbrock.owlqn_trial_pair_gram_ref(xp, d, gp, pg, STP, C_L1, lo, hi, Sp, Yp, END)
    check_ring(f"K14 kernel {tag}", Sk, Yk, a["S"], a["Y"], k[0] - xp, k[1] - gp)
    check_ring(f"K14 plain {tag}", Sp, Yp, a["S"], a["Y"], p[0] - xp, p[1] - gp)
    _fold(errs, "K14_owlqn_trial_pair_gram",
          *(check(f"K14 {name} {tag}", k[i], p[i], tv)
            for i, name in ((0, "x"), (1, "g"), (2, "pg"))),
          *(check(f"K14 sum{i} {tag}", k[i], p[i], ts) for i in (3, 4, 5, 6)))
    if bool(k[7]) != bool(p[7]):
        raise AssertionError(f"K14 changed flag differs {tag}")
    # K14 with the . gp column, gp.gp and gp.pg: the 3-column launch's
    # outputs and ring bit for bit, the rest against the plain version
    Sg, Yg, Sq, Yq = (a["S"].clone(), a["Y"].clone(), a["S"].clone(), a["Y"].clone())
    kg = rosenbrock.owlqn_trial_pair_gram(xp, d, gp, pg, STP, C_L1, lo, hi, Sg, Yg, END,
                                          with_gp=True)
    pg_ = rosenbrock.owlqn_trial_pair_gram_ref(xp, d, gp, pg, STP, C_L1, lo, hi, Sq, Yq,
                                               END, with_gp=True)
    check_extends(f"K14+gp {tag}", k, kg[:8], (3, 4))
    if not (same_bits(Sg, Sk) and same_bits(Yg, Yk)):
        raise AssertionError(f"K14+gp ring differs from the 3-column launch {tag}")
    _fold(errs, "K14_owlqn_trial_pair_gram_gp",
          check(f"K14+gp pg {tag}", kg[2], pg_[2], tv),
          *(check(f"K14+gp sum{i} {tag}", kg[i], pg_[i], ts) for i in (3, 4, 8, 9)))


def check_composed(errs: dict, a: dict, lo: int, hi: int, tag: str, tv: float,
                   ts: float) -> None:
    """K9, K11, K12 and K7 against their plain versions on one window, bit
    for bit where the issue is a rounding rule: K9's projected point
    (round(xp + round(stp*d)), no fma), K11's pg against K10's, K12's ring
    rows (the rounded pair of K9's point), K7's point against K9's, and
    K7's ft and g.d against K8's at the same step and orthant in both
    objective-scalar modes (the remat contract)."""
    xp, d, gp, pg = a["xp0"], a["d"], a["gp"], a["pg"]
    wp = choose_orthant(Orthantwise(C_L1, lo, hi), xp, pg)
    x = fused.owlqn_trial_step(xp, d, wp, STP, lo, hi)
    if not same_bits(x, fused.owlqn_trial_step_ref(xp, d, wp, STP, lo, hi)):
        raise AssertionError(f"K9's point differs from the plain version's {tag}")
    k = fused.pseudo_gradient(xp, gp, C_L1, lo, hi)
    if not same_bits(k, fused.pseudo_gradient_norm(xp, gp, C_L1, lo, hi)[0]):
        raise AssertionError(f"K11's pg differs from K10's {tag}")
    _fold(errs, "K11_pseudo_gradient",
          check(f"K11 pg {tag}", k, fused.pseudo_gradient_ref(xp, gp, C_L1, lo, hi), tv))
    # K12 on K9's point, with the random pg as the new gradient
    gx = a["pg"]
    Sk, Yk, Sp, Yp = (a["S"].clone(), a["Y"].clone(), a["S"].clone(), a["Y"].clone())
    kk = fused.pair_gram_xg(x, xp, gx, gp, k, Sk, Yk, END)
    p = fused.pair_gram_xg_ref(x, xp, gx, gp, k, Sp, Yp, END)
    check_ring(f"K12 kernel {tag}", Sk, Yk, a["S"], a["Y"], x - xp, gx - gp)
    check_ring(f"K12 plain {tag}", Sp, Yp, a["S"], a["Y"], x - xp, gx - gp)
    _fold(errs, "K12_pair_gram_xg", *(check(f"K12 {tag} {i}", kk[i], p[i], ts) for i in (0, 1)))
    del Sk, Yk, Sp, Yp
    for wide in (False, True):
        with fused.wide_fx(wide):
            k7 = rosenbrock.owlqn_trial(xp, d, wp, STP, C_L1, lo, hi)
            k8 = rosenbrock.owlqn_probe(xp, d, wp, STP, C_L1, lo, hi)
            p = rosenbrock.owlqn_trial_ref(xp, d, wp, STP, C_L1, lo, hi)
        want = torch.float64 if wide or xp.dtype == torch.float64 else xp.dtype
        if k7[1].dtype != want or p[1].dtype != want:
            raise AssertionError(f"K7 ft dtype {k7[1].dtype}, plain {p[1].dtype} {tag}")
        if not (same_bits(k7[1], k8[0]) and same_bits(k7[3], k8[1])):
            raise AssertionError(f"K7 and K8 differ at one step (wide={wide}) {tag}: "
                                 f"{k7[1].item()} {k8[0].item()}")
        if not same_bits(k7[0], x):
            raise AssertionError(f"K7's point differs from K9's {tag}")
        _fold(errs, "K7_owlqn_trial",
              *(check(f"K7 {name} {tag}", k7[i], p[i], tv) for i, name in ((0, "x"), (2, "g"))),
              *(check(f"K7 sum{i} {tag}", k7[i], p[i], ts) for i in (1, 3, 4)))
        if bool(k7[5]) != bool(p[5]):
            raise AssertionError(f"K7 changed flag differs {tag}")
    _fold(errs, "K9_owlqn_trial_step", (0.0, 0.0))


#: K5's ring depths and new rows in the kernel checks: the main path's,
#: the north star's, and one that takes two groups of ring rows with the
#: new row in the second
K5_RINGS = ((M, END), (3, END), (2 * M, END + M))


def check_k5(errs: dict, tag: str, ts: float, d, gx, gp, S, Y, end: int) -> None:
    """K5 (3 and 4 columns) against its plain version: the ring write bit
    for bit (row ``end`` the rounded (STP*d, gx - gp)), the 4-column
    launch's columns 0-2 and rings bit for bit the 3-column launch's, the
    sums at the sum tolerance."""
    S3, Y3, S4, Y4, Sp, Yp = (S.clone(), Y.clone(), S.clone(), Y.clone(), S.clone(),
                              Y.clone())
    k3 = fused.pair_gram_sd(STP, d, gx, gp, S3, Y3, end)
    k4 = fused.pair_gram_sd(STP, d, gx, gp, S4, Y4, end, with_gp=True)
    p4 = fused.pair_gram_sd_ref(STP, d, gx, gp, Sp, Yp, end, with_gp=True)
    check_ring(f"K5 kernel {tag}", S3, Y3, S, Y, STP * d, gx - gp, end)
    check_ring(f"K5 plain {tag}", Sp, Yp, S, Y, STP * d, gx - gp, end)
    check_extends(f"K5 4 columns {tag}", k3, k4, (0, 1))
    if not (same_bits(S4, S3) and same_bits(Y4, Y3)):
        raise AssertionError(f"K5's two forms wrote different rings {tag}")
    _fold(errs, "K5_pair_gram", *(check(f"K5 {tag} {i}", k4[i], p4[i], ts) for i in (0, 1)))


def check_k5_k6(errs: dict, a: dict, tag: str, tv: float, ts: float) -> None:
    """K5 at each depth of ``K5_RINGS`` (``check_k5``; gx here the random
    pg) and K6 against their plain versions: K6's fixed row round(ca*Y[END]
    + cb*g) bit for bit the plain version's, the other rows untouched."""
    d, gx, gp, S, Y = a["d"], a["pg"], a["gp"], a["S"], a["Y"]
    for m, end in K5_RINGS:
        # rings of m rows from the inputs' M
        Sm = torch.cat([S, Y])[:m] if m > M else S[:m]
        Ym = torch.cat([Y, S])[:m] if m > M else Y[:m]
        check_k5(errs, f"{tag} m={m}", ts, d, gx, gp, Sm.contiguous(), Ym.contiguous(), end)
        del Sm, Ym
    ca, cb = (torch.tensor(v, dtype=d.dtype, device="cuda") for v in (0.7, -0.2))
    Yk, Yq = Y.clone(), Y.clone()
    k = fused.combine_fix(gp, S, Yk, a["gamma"], a["cs"], a["cy"], END, ca, cb)
    p = fused.combine_fix_ref(gp, S, Yq, a["gamma"], a["cs"], a["cy"], END, ca, cb)
    if not same_bits(Yk, Yq):
        raise AssertionError(f"K6's fixed ring differs from the plain version's {tag}")
    keep = [j for j in range(M) if j != END]
    if not same_bits(Yk[keep], Y[keep]):
        raise AssertionError(f"K6 changed rows other than end {tag}")
    _fold(errs, "K6_combine_fix", check(f"K6 r {tag}", k[0], p[0], tv),
          *(check(f"K6 sum{i} {tag}", k[i], p[i], ts) for i in (1, 2)))


def launches() -> dict:
    tpg, ow_tpg = rosenbrock.trial_pair_gram, rosenbrock.owlqn_trial_pair_gram
    return {
        "K1_trial": rosenbrock.trial.launches,
        "K2_probe": rosenbrock.probe.launches,
        "K3_combine": fused.combine.launches,
        "K4_trial_pair_gram": tpg.launches - tpg.gp_launches,
        "K4_trial_pair_gram_gp": tpg.gp_launches,
        "K5_pair_gram": fused.pair_gram_sd.launches,
        "K6_combine_fix": fused.combine_fix.launches,
        "K7_owlqn_trial": rosenbrock.owlqn_trial.launches,
        "K8_owlqn_probe": (rosenbrock.owlqn_probe.launches
                           + rosenbrock.owlqn_probe_pg.launches),
        "K9_owlqn_trial_step": fused.owlqn_trial_step.launches,
        "K10_pseudo_gradient_norm": fused.pseudo_gradient_norm.launches,
        "K11_pseudo_gradient": fused.pseudo_gradient.launches,
        "K12_pair_gram_xg": fused.pair_gram_xg.launches,
        "K13_combine_ow": fused.combine_ow.launches,
        "K14_owlqn_trial_pair_gram": ow_tpg.launches - ow_tpg.gp_launches,
        "K14_owlqn_trial_pair_gram_gp": ow_tpg.gp_launches,
        "K15_combine_probe": (rosenbrock.combine_probe.launches
                              - rosenbrock.combine_probe.fix_launches),
        "K15_combine_probe_fix": rosenbrock.combine_probe.fix_launches,
        "K16_combine_ow_probe": rosenbrock.combine_ow_probe.launches,
        "K17_axpy_dot": fused.axpy_dot.launches,
        "cal_null_launch": profiling.null_launch.launches,
    }


#: the plain versions
PLAIN = {
    "K1_trial": rosenbrock.trial_ref,
    "K2_probe": rosenbrock.probe_ref,
    "K3_combine": fused.combine_ref,
    "K4_trial_pair_gram": rosenbrock.trial_pair_gram_ref,
    "K8_owlqn_probe": rosenbrock.owlqn_probe_ref,
    "K8_owlqn_probe_pg": rosenbrock.owlqn_probe_pg_ref,
    "K10_pseudo_gradient_norm": fused.pseudo_gradient_norm_ref,
    "K13_combine_ow": fused.combine_ow_ref,
    "K14_owlqn_trial_pair_gram": rosenbrock.owlqn_trial_pair_gram_ref,
    "K5_pair_gram": fused.pair_gram_sd_ref,
    "K6_combine_fix": fused.combine_fix_ref,
    "K7_owlqn_trial": rosenbrock.owlqn_trial_ref,
    "K9_owlqn_trial_step": fused.owlqn_trial_step_ref,
    "K11_pseudo_gradient": fused.pseudo_gradient_ref,
    "K12_pair_gram_xg": fused.pair_gram_xg_ref,
    "K15_combine_probe": rosenbrock.combine_probe_ref,
    "K16_combine_ow_probe": rosenbrock.combine_ow_probe_ref,
    "K17_axpy_dot": fused.axpy_dot_ref,
    "cal_null_launch": profiling.null_launch_ref,
}


def plain_calls() -> dict:
    return {name: fn.calls for name, fn in PLAIN.items()}


def reset_counts() -> None:
    for fn in (rosenbrock.trial, rosenbrock.probe, fused.combine,
               rosenbrock.trial_pair_gram, rosenbrock.owlqn_probe,
               rosenbrock.owlqn_probe_pg, fused.pseudo_gradient_norm,
               fused.combine_ow, rosenbrock.owlqn_trial_pair_gram,
               fused.pair_gram_sd, fused.combine_fix, rosenbrock.owlqn_trial,
               fused.owlqn_trial_step, fused.pseudo_gradient, fused.pair_gram_xg,
               rosenbrock.combine_probe, rosenbrock.combine_ow_probe, fused.axpy_dot,
               profiling.null_launch):
        fn.launches = 0
    rosenbrock.trial_pair_gram.gp_launches = 0
    rosenbrock.owlqn_trial_pair_gram.gp_launches = 0
    rosenbrock.combine_probe.fix_launches = 0
    for fn in PLAIN.values():
        fn.calls = 0
    to_host.reads = 0
    carried.used = 0


def phase_goldens() -> None:
    x0 = rosenbrock.initial_point(100, torch.float64, "cuda")
    for entry in ("minimize", "minimize_jit"):
        reset_counts()
        b = lbfgs()
        r = getattr(b, entry)(x0, default_evaluate())
        if r.niter != 35:
            raise AssertionError(f"{entry} defaults: niter {r.niter} != 35")
        b = lbfgs().with_constrain_step_size(False)
        r2 = getattr(b, entry)(x0, default_evaluate())
        ok = (r2.niter == 38
              and abs(r2.fx / 1.2832127771605377e-15 - 1) <= 1e-3
              and abs(r2.gnorm / 9.486547293218877e-07 - 1) <= 1e-6)
        if not ok:
            raise AssertionError(f"{entry} golden: {r2}")
        # the capped run takes K3, the uncapped one K15
        lc, pc = launches(), plain_calls()
        if min(lc[k] for k in PLAIN_PATH + UNFUSED_PATH) == 0 or max(pc.values()) != 0:
            raise AssertionError(f"{entry} golden did not run on the kernels: {lc} {pc}")
        emit(phase="golden_f64_n100", entry=entry, niter_default=r.niter,
             niter=r2.niter, fx=r2.fx, gnorm=r2.gnorm, launches=lc)


#: the recorded OWL-QN trajectory (tests/test_native_parity.py:57-66)
OWLQN_GOLDEN = dict(fx=43.50249999999999, x0=0.25, x1=0.0575, niter=172)

#: the JAX package's n = 100 float64 damped runs from initial_point(100),
#: at most 50 iterations through ``minimize``: iterations, fx after 15 and
#: the final fx (tests/test_torch_damped.py holds these to lbfgs_tpu)
DAMPED_N100 = {
    "damped": dict(niter=34, fx15=40.059866126029206, fx=7.9619800215897e-14),
    "damped_fixed": dict(niter=43, fx15=90.57043092482998, fx=3.912403849224467e-14),
    "damped_owlqn": dict(niter=50, fx15=257.9911080938514, fx=47.247445716752445),
}


def phase_owlqn_golden() -> None:
    x0 = rosenbrock.initial_point(100, torch.float64, "cuda")
    x1 = lbfgs().with_constrain_step_size(False).minimize(x0, default_evaluate()).x
    b = lbfgs().with_orthantwise(1.0, 0, 99).with_constrain_step_size(False)
    for entry in ("minimize", "minimize_jit"):
        reset_counts()
        r = getattr(b, entry)(x1.clone(), default_evaluate())
        lc, pc = launches(), plain_calls()
        g = OWLQN_GOLDEN
        ok = (abs(r.fx / g["fx"] - 1) <= 1e-6 and abs(float(r.x[0]) - g["x0"]) <= 1e-4
              and abs(float(r.x[1]) - g["x1"]) <= 1e-4)
        if not ok:
            raise AssertionError(f"{entry} OWL-QN golden: {r}")
        if min(lc[k] for k in OWLQN_PATH) == 0 or max(pc.values()) != 0:
            raise AssertionError(f"{entry} OWL-QN golden did not run on the kernels: "
                                 f"{lc} {pc}")
        emit(phase="owlqn_golden_f64_n100", entry=entry, niter=r.niter,
             niter_recorded=g["niter"], fx=r.fx, x0=float(r.x[0]), x1=float(r.x[1]),
             gnorm=r.gnorm, launches=lc)


#: the main path: n = 2^24 (N_BIG), f32, m = 6, bf16 history, More-Thuente,
#: uncapped step, epsilon 0, at most 100 iterations
MAIN_PARAMS = LbfgsParams(m=M, history_dtype="bfloat16", constrain_step_size=False,
                          epsilon=0.0, max_iterations=101)
#: (iterations, rel fx, normwise x) bounds of the plain run against the
#: kernel run: the kernels sum in another order, and Rosenbrock amplifies
#: those ulps (15 iterations is the pointwise horizon of the
#: kernel-vs-composed pins; past ~18 the trajectories part)
VS_PLAIN = ((8, 1e-3, 1e-2), (15, 5e-2, 0.25))


def phase_main_path() -> dict:
    params = MAIN_PARAMS
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    f0 = float(rosenbrock.probe_ref(x0, x0, 0.0)[0])
    st, dt, lc, pc, reads = _run_2e24("main path", params)
    used = carried.used
    iters, probes = st.k - 1, st.prob.neval - 1
    fx = float(st.prob.fx)
    if not (np.isfinite(fx) and fx < f0):
        raise AssertionError(f"main path: fx {fx} (start {f0})")
    _expect("main path", lc, pc, K1_trial=1, K2_probe=probes - used, K4_trial_pair_gram=iters,
            K15_combine_probe=iters)
    _carried_all("main path", used, iters)
    # bytes per iteration from the shapes (f32 vectors, bf16 history):
    # K2 reads xp, d; K4 reads xp, d, gp and m-1 rows of S and Y, writes
    # x, g and one row of each; K15 reads g, x and both rings, writes d
    v, h = 4, 2
    bpi = N_BIG * (lc["K2_probe"] / iters * 2 * v + (5 * v + 2 * (M - 1) * h + 2 * h)
                   + (3 * v + 2 * M * h))
    out = _report_2e24("main_path", st, dt, lc, reads,
                       carried_probes=used, k2_per_iter=lc["K2_probe"] / iters,
                       bytes_per_iter_model=bpi, gb_per_s_model=bpi * iters / dt / 1e9,
                       gb_per_s_vs_1_44=1.44 * iters / dt, fx0=f0, plain_calls=pc)

    # the same entry point through the plain versions on the card, against
    # the kernels, at two iteration budgets
    for n_it, fx_tol, x_tol in VS_PLAIN:
        p = params.replace(max_iterations=n_it + 1)
        st_k = minimize_jit(p, x0, default_evaluate(), return_state=True)
        st_p = minimize_jit(p, x0, default_evaluate().plain, return_state=True)
        rel = abs(float(st_k.prob.fx) / float(st_p.prob.fx) - 1)
        x_err = err(st_k.prob.x, st_p.prob.x)
        if st_k.k != st_p.k or st_k.k != n_it + 1:
            raise AssertionError(f"plain run: niter {st_p.k - 1}, kernel {st_k.k - 1}, "
                                 f"budget {n_it}")
        if not (rel <= fx_tol and x_err <= x_tol):
            raise AssertionError(f"plain vs kernel after {n_it} iterations: rel fx "
                                 f"{rel:.3e} (tol {fx_tol}), x {x_err:.3e} (tol {x_tol})")
        emit(phase="main_path_vs_plain", iters=n_it, rel_fx=rel, fx_tol=fx_tol,
             x_err=x_err, x_tol=x_tol)
        del st_k, st_p
    del st
    torch.cuda.empty_cache()
    return lc, out


#: the OWL-QN main path (bench_owlqn.py:61-76 at n = 2^24): f32, m = 6,
#: bf16 history, c = 1 on [0, n - 1), BacktrackingArmijo, uncapped step,
#: time to epsilon 3e-2 within 300 iterations
OWLQN_PARAMS = LbfgsParams(
    m=M, history_dtype="bfloat16", constrain_step_size=False, epsilon=3e-2,
    max_iterations=301, orthantwise=Orthantwise(1.0, 0, N_BIG - 1),
).replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo)
#: bound on the plain-vs-kernel rel fx after 15 OWL-QN iterations, set
#: before the first run (PERF.md, section 6); printed, not asserted
OWLQN_VS_PLAIN_15 = 1e-2


def phase_owlqn_main_path() -> dict:
    params = OWLQN_PARAMS
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    f0 = float(rosenbrock.probe_ref(x0, x0, 0.0)[0]) + float(x0[:-1].abs().sum())
    st, dt, lc, pc, reads = _run_2e24("OWL-QN main path", params)
    used = carried.used
    iters, probes = st.k - 1, st.prob.neval - 1
    fx = float(st.prob.fx)
    if st.status != Status.CONVERGED:
        raise AssertionError(f"OWL-QN main path: status {st.status} after {iters} "
                             f"iterations (fx {fx})")
    if not (np.isfinite(fx) and fx < f0):
        raise AssertionError(f"OWL-QN main path: fx {fx} (start {f0})")
    _expect("OWL-QN main path", lc, pc, **_owlqn_launches(iters, probes, used))
    _carried_all("OWL-QN main path", used, iters)
    out = _report_2e24("owlqn_main_path", st, dt, lc, reads, eps=3e-2,
                       carried_probes=used, k8_per_iter=lc["K8_owlqn_probe"] / iters,
                       fx0=f0, gnorm=float(np.sqrt(st.prob.gnorm2)), plain_calls=pc)

    # minimize_jit through the plain versions on the card against the
    # kernels: the same evaluations and fx to rel 1e-4 after 8 iterations
    # (tests/test_native_parity.py:228-229); after 15 the difference is
    # printed beside the bound set before the first run
    for n_it in (8, 15):
        p = params.replace(epsilon=0.0, max_iterations=n_it + 1)
        st_k = minimize_jit(p, x0, default_evaluate(), return_state=True)
        st_p = minimize_jit(p, x0, default_evaluate().plain, return_state=True)
        rel = abs(float(st_k.prob.fx) / float(st_p.prob.fx) - 1)
        x_err = err(st_k.prob.x, st_p.prob.x)
        same = (st_k.k, st_k.prob.neval) == (st_p.k, st_p.prob.neval)
        if n_it == 8 and not (same and st_k.k == n_it + 1 and rel <= 1e-4):
            raise AssertionError(
                f"OWL-QN plain vs kernel after 8 iterations: k/neval {st_k.k}/"
                f"{st_k.prob.neval} vs {st_p.k}/{st_p.prob.neval}, rel fx {rel:.3e}")
        emit(phase="owlqn_main_path_vs_plain", iters=n_it, neval_kernel=st_k.prob.neval,
             neval_plain=st_p.prob.neval, rel_fx=rel,
             fx_tol=1e-4 if n_it == 8 else OWLQN_VS_PLAIN_15, asserted=n_it == 8,
             x_err=x_err)
        del st_k, st_p
    del st
    torch.cuda.empty_cache()
    return lc, out


def phase_profile(path: str) -> None:
    """For each main path (plain, OWL-QN, damped, damped OWL-QN, Poisson,
    and the first three on the objective without the combine+probe
    fusion's hooks), one run under torch.profiler after three unprofiled
    ones: device busy time (the summed durations of the kernels and copies
    the profiler saw on the card) against the walls, the device items by
    time, and the host's launch and copy calls.  The full operator tables
    go to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for name, params in (("main_path", MAIN_PARAMS), ("owlqn_main_path", OWLQN_PARAMS),
                             ("damped_main_path", DAMPED_PARAMS),
                             ("damped_owlqn_main_path", DAMPED_OWLQN_PARAMS)):
            _profile_one(name, params, f)
        for name, params in (("main_path_unfused", MAIN_PARAMS),
                             ("owlqn_main_path_unfused", OWLQN_PARAMS),
                             ("damped_main_path_unfused", DAMPED_PARAMS)):
            _profile_one(name, params, f, fn=unfused(default_evaluate()))
        X, y = logistic.synthetic(POISSON_NROW, POISSON_NCOL, seed=0, device="cuda")
        _profile_one("poisson_main_path", poisson_params(False), f,
                     torch.zeros(POISSON_NCOL, device="cuda"), logistic.make_objective(X, y))
        del X, y
        torch.cuda.empty_cache()


def _profile_one(name: str, params: LbfgsParams, f, x0=None, fn=None) -> None:
    if x0 is None:
        x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    fn = fn or default_evaluate()
    walls = [1e3 * profiling.timed(lambda: minimize_jit(params, x0, fn, return_state=True),
                                   warmup=0)
             for _ in range(3)]

    def one_run():
        t0 = time.perf_counter()
        st = minimize_jit(params, x0, fn, return_state=True)
        torch.cuda.synchronize()
        return st, 1e3 * (time.perf_counter() - t0)

    prof, (st, wall_prof) = profiled(one_run)
    if prof is None:
        raise AssertionError(f"{name}: the profiler recorded no device time")
    iters = st.k - 1
    ka = prof.key_averages()
    dev = sorted(device_events(prof), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    api = {e.key: e.count for e in ka
           if e.key.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy"))}
    top = [dict(name=e.key[:70], ms=e.self_device_time_total / 1e3, count=e.count)
           for e in dev[:12]]
    out = dict(phase="profile", path=name, n=x0.shape[0], iters=iters, walls_ms=walls,
               profiled_wall_ms=wall_prof, device_busy_ms=busy,
               device_busy_ms_per_iter=busy / iters,
               busy_share_of_walls=[busy / w for w in walls],
               device_items=len(dev), host_calls=api, top=top)
    f.write(json.dumps(out) + "\n\n")
    f.write(ka.table(sort_by="self_device_time_total", row_limit=60) + "\n\n")
    emit(**out)


# ---------------------------------------------------------------------------
# The damped paths
# ---------------------------------------------------------------------------

#: the damped n = 100 configurations (DAMPED_N100 holds their JAX runs)
DAMPED_CONFIGS = {
    "damped": lambda b: b.with_damping(True),
    "damped_fixed": lambda b: b.with_damping(True).with_damping_fixed(),
    "damped_owlqn": lambda b: b.with_orthantwise(1.0, 0, 99).with_damping(True),
}
#: per-iteration bounds of a card run against the same run on the CPU:
#: the JAX package's own pins to the native core (damped OWL-QN,
#: tests/test_damped_fused.py:221-226; LJ38, tests/test_lennard_jones.py:
#: 100-104).  The plain damped Rosenbrock runs are held to them up to
#: HORIZON iterations only: the valley amplifies a sum's rounding ~10x
#: every two iterations (the port against the JAX package on the CPU:
#: rel fx 1.3e-10 at iteration 16, 7.3e-9 at 22, 5.5e-6 at 34), so past it
#: only the iterations, the status and the final fx are held
TRACE_TOL = dict(fx=1e-9, gnorm=1e-6, step=1e-6)
LJ_TOL = dict(fx=1e-8, gnorm=1e-6, step=1e-6)
HORIZON = 15


def run_traced(builder: Lbfgs, x0: torch.Tensor, fn) -> tuple:
    """``minimize`` with a progress callback that records (niter, fx,
    gnorm, step, neval) per iteration; returns (trace, report)."""
    trace = []

    def progress(p) -> bool:
        trace.append((p.niter, p.fx, p.gnorm, p.step, p.neval))
        return False

    return trace, builder.minimize(x0, fn, progress)


def compare_traces(name: str, card: list, cpu: list, tol: dict, upto: int) -> dict:
    """Hold the card's trace to the CPU's per iteration up to ``upto``:
    the same evaluations, fx, gnorm and step within ``tol`` (relative).
    Returns the largest relative gaps over the whole common prefix."""
    worst = dict.fromkeys(tol, 0.0)
    if len(card) != len(cpu):
        raise AssertionError(f"{name}: {len(card)} iterations on the card, {len(cpu)} on "
                             "the CPU")
    for (k, *a, ea), (kc, *b, eb) in zip(card, cpu):
        gaps = {key: abs(x - y) / max(abs(y), 1e-300) for key, x, y in zip(tol, a, b)}
        for key, g in gaps.items():
            worst[key] = max(worst[key], g)
        if k > upto:
            continue
        if k != kc or ea != eb:
            raise AssertionError(f"{name}: iteration {k}/{kc}, evaluations {ea}/{eb}")
        bad = {key: g for key, g in gaps.items() if not g <= tol[key]}
        if bad:
            raise AssertionError(f"{name}: iteration {k} differs from the CPU: {bad}")
    return worst


def phase_damped_n100() -> dict:
    """The three damped f64 runs at n = 100 through the kernels, each held
    to the same run on the CPU and to the JAX package's recorded run;
    returns the damping cases seen."""
    x0 = rosenbrock.initial_point(100, torch.float64, "cuda")
    seen = {}
    for name, chain in DAMPED_CONFIGS.items():
        b = chain(lbfgs()).with_max_iterations(50)
        ow = name == "damped_owlqn"
        reset_counts()
        tk, rk = run_traced(b, x0, default_evaluate())
        lc, pc = launches(), plain_calls()
        tc, rc = run_traced(b, x0.cpu(), default_evaluate())
        worst = compare_traces(name, tk, tc, TRACE_TOL, 50 if ow else HORIZON)
        if (rk.niter, rk.status) != (rc.niter, rc.status):
            raise AssertionError(f"{name}: card {rk.niter}/{rk.status}, CPU "
                                 f"{rc.niter}/{rc.status}")
        # the JAX package's run: iterations, fx after 15, the final fx
        # (rel 1e-9 under OWL-QN; the plain runs end at fx ~1e-13, where
        # the packages' rounding has grown to ~1e-5 rel)
        want = DAMPED_N100[name]
        fx15 = tk[HORIZON - 1][1]
        final_tol = 1e-9 if ow else 1e-3
        if not (rk.niter == want["niter"]
                and abs(fx15 / want["fx15"] - 1) <= 1e-9
                and abs(rk.fx / want["fx"] - 1) <= final_tol):
            raise AssertionError(f"{name}: niter {rk.niter}, fx15 {fx15}, fx {rk.fx} "
                                 f"against the JAX package's {want}")
        iters, probes = rk.niter - 1, rk.neval - 1
        if ow:
            _expect(name, lc, pc, K1_trial=1, K10_pseudo_gradient_norm=1,
                    K8_owlqn_probe=probes, K13_combine_ow=iters,
                    K14_owlqn_trial_pair_gram_gp=iters)
        else:
            _expect(name, lc, pc, K1_trial=1, K2_probe=probes,
                    K4_trial_pair_gram_gp=iters, K6_combine_fix=iters)
        seen[name] = rk.damping_cases
        emit(phase="damped_f64_n100", config=name, niter=rk.niter, status=rk.status,
             fx=rk.fx, fx15=fx15, fx_jax=want["fx"], neval=rk.neval,
             damping_cases=dict(zip(("none", "case1", "case2"), rk.damping_cases)),
             max_rel_gap_vs_cpu=worst, asserted_to=50 if ow else HORIZON, launches=lc)
    if seen["damped"][1] == 0 or seen["damped_fixed"][2] == 0:
        raise AssertionError(f"damping did not fire: {seen}")
    return seen


def phase_lj38() -> None:
    """LJ38 in f64 on the card: the start energy, default L-BFGS to the
    relaxed energy, and 50 gradient-only iterations against the CPU."""
    obj = lennard_jones.make_objective()
    x0 = lennard_jones.lj38_positions(device="cuda")
    e0 = float(obj(x0)[0])
    if abs(e0 - (-116.84147098)) > 1e-6:
        raise AssertionError(f"LJ38 start energy {e0}")
    reset_counts()
    t0 = time.perf_counter()
    r = lbfgs().with_max_iterations(400).minimize(x0, obj)
    dt = time.perf_counter() - t0
    if abs(r.fx - (-164.2701507)) > 1e-4:
        raise AssertionError(f"LJ38 default L-BFGS: fx {r.fx} after {r.niter} iterations")
    emit(phase="lj38_default", niter=r.niter, fx=r.fx, status=r.status, seconds=dt)
    b = lbfgs().with_gradient_only().with_max_iterations(50)
    reset_counts()
    tk, rk = run_traced(b, x0, obj)
    lc, pc = launches(), plain_calls()
    tc, _ = run_traced(b, x0.cpu(), obj)
    worst = compare_traces("lj38 gradient_only", tk, tc, LJ_TOL, 50)
    if not tk[-1][1] < -150.0:
        raise AssertionError(f"LJ38 gradient-only ends at fx {tk[-1][1]}")
    _expect("LJ38 gradient-only", lc, pc, K3_combine=rk.niter - 1)
    emit(phase="lj38_gradient_only", niter=rk.niter, fx=rk.fx, neval=rk.neval,
         damping_cases=dict(zip(("none", "case1", "case2"), rk.damping_cases)),
         max_rel_gap_vs_cpu=worst, tol=LJ_TOL, launches=lc)


def _run_2e24(name: str, params: LbfgsParams, fn=None) -> tuple:
    """One warm and one timed ``minimize_jit`` at n = 2^24 (the counts
    reset between them); returns (state, seconds, launches, plain calls,
    host reads)."""
    fn = fn or default_evaluate()
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    minimize_jit(params, x0, fn, return_state=True)
    torch.cuda.synchronize()
    reset_counts()
    out = []
    dt = profiling.timed(lambda: out.append(minimize_jit(params, x0, fn, return_state=True)),
                         warmup=0)
    st = out[0]
    lc, pc, reads = launches(), plain_calls(), to_host.reads
    if st.status not in (Status.CONVERGED, Status.MAX_ITERATIONS):
        raise AssertionError(f"{name}: status {st.status} after {st.k - 1} iterations")
    if not np.isfinite(float(st.prob.fx)):
        raise AssertionError(f"{name}: fx {st.prob.fx}")
    return st, dt, lc, pc, reads


def _expect(name: str, lc: dict, pc: dict, **counts) -> None:
    """A run's launches are ``counts`` for the named kernels and none of
    any other, and it called no plain version (stand-ins included)."""
    want = dict.fromkeys(KERNELS, 0)
    want.update(counts)
    if lc != want:
        raise AssertionError(f"{name} launch counts {lc}, expected {want}")
    if max(pc.values()) != 0:
        raise AssertionError(f"{name} called plain versions: {pc}")


def _carried_all(name: str, used: int, iters: int) -> None:
    """Every search after the first took the combine+probe fusion's carried
    first trip (the entry step is the probed one by construction)."""
    if used != iters - 1:
        raise AssertionError(f"{name}: {used} carried first trips in {iters} iterations")


def _owlqn_launches(iters: int, probes: int, used: int) -> dict:
    """The OWL-QN main path's launches: K1 and K10 once, K14 and K16 per
    iteration, K8 per probe the fusion did not carry in."""
    return dict(K1_trial=1, K10_pseudo_gradient_norm=1, K8_owlqn_probe=probes - used,
                K14_owlqn_trial_pair_gram=iters, K16_combine_ow_probe=iters)


def unfused(fn):
    """The objective ``fn`` without the combine+probe fusion's hooks, as an
    objective that does not carry them: the solver then runs K3 (K6, K13)
    and probes every first trip (the fusion-off side of the comparisons)."""
    def vag(x):
        return fn(x)

    vag.__dict__.update({k: v for k, v in fn.__dict__.items()
                         if not k.startswith(("__lbfgs_combine_probe", "__lbfgs_combine_ow_probe"))})
    return vag


def _report_2e24(phase: str, st, dt: float, lc: dict, reads: int, **extra) -> dict:
    iters = st.k - 1
    out = dict(phase=phase, n=N_BIG, iters=iters, status=st.status, seconds=dt,
               iters_per_s=iters / dt, ms_per_iter=1e3 * dt / iters,
               evals=st.prob.neval, probes_per_iter=(st.prob.neval - 1) / iters,
               syncs_per_iter=reads / iters, fx=float(st.prob.fx),
               damping_cases=dict(zip(("none", "case1", "case2"), st.damping_cases)),
               launches=lc, **extra)
    emit(**out)
    return out


#: the damped main path: bench.py's BENCH_DAMPING=1 configuration
#: (bench.py:21, 101) at the main path's widths, epsilon 0, at most 100
#: iterations
DAMPED_PARAMS = MAIN_PARAMS.replace(damping=True)
#: the damped OWL-QN main path: the OWL-QN main path with damping
DAMPED_OWLQN_PARAMS = OWLQN_PARAMS.replace(damping=True)


def phase_damped_main_path(undamped_syncs: float) -> dict:
    st, dt, lc, pc, reads = _run_2e24("damped main path", DAMPED_PARAMS)
    used = carried.used
    iters = st.k - 1
    _expect("damped main path", lc, pc, K1_trial=1, K2_probe=st.prob.neval - 1 - used,
            K4_trial_pair_gram_gp=iters, K15_combine_probe_fix=iters)
    _carried_all("damped main path", used, iters)
    out = _report_2e24("damped_main_path", st, dt, lc, reads,
                       carried_probes=used, syncs_per_iter_undamped=undamped_syncs)
    del st
    torch.cuda.empty_cache()
    return lc, out


def phase_gradient_only_main_path() -> None:
    params = Lbfgs(MAIN_PARAMS).with_gradient_only().with_max_iterations(51).param
    st, dt, lc, pc, reads = _run_2e24("gradient-only main path", params)
    used = carried.used
    iters = st.k - 1
    _expect("gradient-only main path", lc, pc, K1_trial=1, K2_probe=st.prob.neval - 1 - used,
            K4_trial_pair_gram_gp=iters, K15_combine_probe_fix=iters)
    _report_2e24("gradient_only_main_path", st, dt, lc, reads, carried_probes=used)
    del st
    torch.cuda.empty_cache()


def phase_damped_owlqn_main_path() -> dict:
    st, dt, lc, pc, reads = _run_2e24("damped OWL-QN main path", DAMPED_OWLQN_PARAMS)
    used = carried.used
    iters, probes = st.k - 1, st.prob.neval - 1
    want = _owlqn_launches(iters, probes, used)
    want["K14_owlqn_trial_pair_gram_gp"] = want.pop("K14_owlqn_trial_pair_gram")
    _expect("damped OWL-QN main path", lc, pc, **want)
    _report_2e24("damped_owlqn_main_path", st, dt, lc, reads, eps=3e-2, carried_probes=used,
                 gnorm=float(np.sqrt(st.prob.gnorm2)))
    del st
    torch.cuda.empty_cache()
    return lc


def trial_only_objective():
    """Rosenbrock with its trial (K1) and probe (K2) kernels but no one-pass
    epilogue, so that the damped solver takes K5 and K6: the K5 route."""
    def vag(x):
        return rosenbrock.value_and_grad(x)

    vag.__lbfgs_value_and_grad__ = True
    vag.__lbfgs_trial__ = rosenbrock.trial
    vag.__lbfgs_trial_probe__ = rosenbrock.probe
    return vag


def phase_k5_route() -> dict:
    params = DAMPED_PARAMS.replace(max_iterations=11)
    st, dt, lc, pc, reads = _run_2e24("K5 route", params, trial_only_objective())
    iters = st.k - 1
    # K1 at the start and once per iteration to materialize the search's
    # accepted point
    _expect("K5 route", lc, pc, K1_trial=1 + iters, K2_probe=st.prob.neval - 1,
            K5_pair_gram=iters, K6_combine_fix=iters)
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    p = DAMPED_PARAMS.replace(max_iterations=9)
    st5 = minimize_jit(p, x0, trial_only_objective(), return_state=True)
    st4 = minimize_jit(p, x0, default_evaluate(), return_state=True)
    _report_2e24("k5_route", st, dt, lc, reads,
                 vs_epilogue_after_8=dict(
                     rel_fx=abs(float(st5.prob.fx) / float(st4.prob.fx) - 1),
                     neval=(st5.prob.neval, st4.prob.neval)))
    del st, st5, st4
    torch.cuda.empty_cache()
    return lc


# ---------------------------------------------------------------------------
# The wide objective scalar and the Poisson regression
# ---------------------------------------------------------------------------


def _rosen_f64(x: torch.Tensor) -> float:
    """Extended Rosenbrock of a float32 point, summed in float64 on the host."""
    x = x.double().cpu()
    t1 = 1.0 - x[0::2]
    t2 = 10.0 * (x[1::2] - x[0::2] ** 2)
    return float((t1 * t1 + t2 * t2).sum())


def phase_wide_kernels() -> None:
    """The wide forms of K1, K2, K4, K7 and K8 at n = 2^24 on a 1e12-sized
    fx (Rosenbrock at x0 + 10, tests/test_wide_fx.py:47-75): the objective
    (and K7's and K8's L1) column reduced in float64, every other output
    bit for bit the default launch's; each form's fx against a float64
    sum on the host.  With float64 vectors the mode changes nothing, bit
    for bit."""
    n, c, lo, hi = N_BIG, 1.0, 0, N_BIG - 1
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    xp = rosenbrock.initial_point(n, torch.float32, "cuda") + 10.0
    d = 1e-3 * torch.randn(n, generator=g, device="cuda")
    gp, pg = (torch.randn(n, generator=g, device="cuda") for _ in range(2))
    S, Y = (torch.randn((M, n), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    wp = choose_orthant(Orthantwise(c, lo, hi), xp, pg)
    forms = {  # name: (launch, index of fx)
        "K1_trial": (lambda: rosenbrock.trial(xp, d, STP), 1),
        "K2_probe": (lambda: rosenbrock.probe(xp, d, STP), 0),
        "K4_trial_pair_gram": (
            lambda: rosenbrock.trial_pair_gram(xp, d, gp, STP, S.clone(), Y.clone(), END)
            + (S, Y), 1),
        "K7_owlqn_trial": (lambda: rosenbrock.owlqn_trial(xp, d, wp, STP, c, lo, hi), 1),
        "K8_owlqn_probe": (lambda: rosenbrock.owlqn_probe(xp, d, wp, STP, c, lo, hi), 0),
        "K8_owlqn_probe_pg": (lambda: rosenbrock.owlqn_probe_pg(xp, d, pg, STP, c, lo, hi), 0),
    }
    xt = rosenbrock.trial(xp, d, STP)[0]
    x7 = rosenbrock.owlqn_trial(xp, d, wp, STP, c, lo, hi)[0]
    exact = _rosen_f64(xt)
    exact_ow = _rosen_f64(x7) + c * float(x7[lo:hi].double().abs().sum())
    rel = {}
    for name, (launch, fi) in forms.items():
        base = launch()
        with fused.wide_fx():
            wide = launch()
        if base[fi].dtype != torch.float32 or wide[fi].dtype != torch.float64:
            raise AssertionError(f"{name}: fx dtypes {base[fi].dtype}, {wide[fi].dtype}")
        for i, (a, b) in enumerate(zip(base, wide)):
            if i != fi and not same_bits(a, b):
                raise AssertionError(f"{name}: output {i} differs under the wide mode")
        want = exact_ow if name.startswith(("K7", "K8")) else exact
        rel[name] = dict(f32=abs(float(base[fi]) / want - 1), wide=abs(float(wide[fi]) / want - 1))
        if not rel[name]["wide"] <= 1e-6:
            raise AssertionError(f"{name}: wide fx off the float64 sum by {rel[name]['wide']}")
    x64 = xp.double()
    base = rosenbrock.trial(x64, d.double(), STP)
    with fused.wide_fx():
        wide = rosenbrock.trial(x64, d.double(), STP)
    if not all(same_bits(a, b) for a, b in zip(base, wide)):
        raise AssertionError("the wide mode changed a float64 launch")
    emit(phase="wide_kernels", n=n, fx_f64=exact, fx_owlqn_f64=exact_ow, rel_err=rel,
         others="bit-exact against the default launch", f64_vectors="unchanged")
    del xp, d, gp, pg, S, Y, wp, xt, x7
    torch.cuda.empty_cache()


#: the Poisson main path: the JAX package's at-scale configuration
#: (bench_logistic.py:13-17, 81-129) with X in float32: 2048 x 2^20
POISSON_NROW, POISSON_NCOL = 1 << 11, 1 << 20


def poisson_params(wide: bool, iters: int = 100) -> LbfgsParams:
    """c = 1 on [1, n) (the intercept outside the L1 window), m = 6, bf16
    history, BacktrackingArmijo, uncapped step, epsilon 0."""
    return LbfgsParams(
        m=M, history_dtype="bfloat16", constrain_step_size=False, epsilon=0.0,
        max_iterations=iters + 1, fx_wide=wide,
        orthantwise=Orthantwise(1.0, 1, POISSON_NCOL),
    ).replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo)


def _expect_composed(name: str, st, lc: dict, pc: dict) -> None:
    """The composed OWL-QN branch's launches: K11 once at the start, K9 per
    trial point, K10, K12 and K13 per iteration, and nothing else."""
    iters = st.k - 1
    _expect(name, lc, pc, K9_owlqn_trial_step=st.prob.neval - 1, K10_pseudo_gradient_norm=iters,
            K11_pseudo_gradient=1, K12_pair_gram_xg=iters, K13_combine_ow=iters)


def phase_poisson_main_path() -> dict:
    t0 = time.perf_counter()
    X, y = logistic.synthetic(POISSON_NROW, POISSON_NCOL, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    obj = logistic.make_objective(X, y)
    x0 = torch.zeros(POISSON_NCOL, device="cuda")
    n = POISSON_NCOL
    minimize_jit(poisson_params(False, 2), x0, obj, return_state=True)  # warm
    out = {}
    for wide in (False, True):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = minimize_jit(poisson_params(wide), x0, obj, return_state=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        lc, pc, reads = launches(), plain_calls(), to_host.reads
        name = "Poisson main path" + (" (wide)" if wide else "")
        _expect_composed(name, st, lc, pc)
        iters, evals = st.k - 1, st.prob.neval
        fx = st.prob.fx
        nnz = int((st.prob.x[1:] != 0).sum())
        if type(fx) is not (np.float64 if wide else np.float32):
            raise AssertionError(f"{name}: fx is {type(fx).__name__}")
        if not (np.isfinite(fx) and 0 < nnz < n - 1):
            raise AssertionError(f"{name}: fx {fx}, {nnz} nonzero coefficients")
        out[wide] = dict(status=st.status, iters=iters)
        if not wide:
            lc_main = lc
        emit(phase="poisson_main_path", nrow=POISSON_NROW, ncol=n, x_dtype="float32",
             fx_wide=wide, iters=iters, evals=evals, status=st.status,
             status_name=Status(st.status).name, seconds=dt, iters_per_s=iters / dt,
             evals_per_s=evals / dt, ms_per_eval=1e3 * dt / evals,
             syncs_per_iter=reads / max(iters, 1), fx=float(fx), fx_dtype=type(fx).__name__,
             nnz=nnz, data_seconds=t_data, launches=lc, plain_calls=pc,
             f32_run=out.get(False) if wide else None)
        del st
    del X, y, obj
    torch.cuda.empty_cache()
    return lc_main


def phase_poisson_f64_vs_cpu() -> None:
    """500 x 21 float64 (the reference's shape, ``synthetic_dataset``), c = 1
    on [1, 21), epsilon 1e-4, through ``minimize``: per iteration the card
    against the port on the CPU (fx rel 1e-9), the composed branch's
    launches on the card."""
    b = lbfgs().with_orthantwise(1.0, 1, 21).with_epsilon(1e-4)
    runs = {}
    for dev in ("cuda", "cpu"):
        X, y = logistic.synthetic_dataset(500, 21, device=dev)
        reset_counts()
        runs[dev] = run_traced(b, torch.zeros(21, dtype=torch.float64, device=dev),
                               logistic.make_objective(X, y))
        if dev == "cuda":
            lc, pc = launches(), plain_calls()
    (tk, rk), (tc, rc) = runs["cuda"], runs["cpu"]
    tol = dict(fx=1e-9, gnorm=1e-6, step=1e-6)
    worst = compare_traces("Poisson f64", tk, tc, tol, len(tk))
    if (rk.niter, rk.status) != (rc.niter, rc.status) or rk.status != Status.CONVERGED:
        raise AssertionError(f"Poisson f64: card {rk.niter}/{rk.status}, CPU "
                             f"{rc.niter}/{rc.status}")
    iters = rk.niter - 1
    _expect("Poisson f64", lc, pc, K9_owlqn_trial_step=rk.neval - 1,
            K10_pseudo_gradient_norm=iters, K11_pseudo_gradient=1, K12_pair_gram_xg=iters,
            K13_combine_ow=iters)
    emit(phase="poisson_f64_vs_cpu", nrow=500, ncol=21, niter=rk.niter, neval=rk.neval,
         fx=rk.fx, fx_cpu=rc.fx, max_rel_gap_vs_cpu=worst, tol=tol, launches=lc)


def phase_f32_floor() -> None:
    """The f32 objective floor (tests/test_owlqn_logistic.py:90-143): 512 x 64
    Poisson data from the port's generator (seed 0 on the CPU, moved to the
    card), c = 5 on [1, 64), Armijo, epsilon 1e-4, 60 iterations of the
    step-at-a-time loop, float32 and wide.  The wide run must carry fx
    in float64; where each run stops is recorded, not held: past the
    objective floor both live at the f32 vector floor, where the first
    pair with s.y or y.y exactly 0 ends a run, and which iteration rounds
    to one depends on the order of the products' sums (PERF.md)."""
    X, y = logistic.synthetic(512, 64, nnz=8, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    obj = logistic.make_objective(X.cuda(), y.cuda())
    res = {}
    for wide in (False, True):
        b = (lbfgs().with_orthantwise(5.0, 1, 64).with_linesearch_algorithm("BacktrackingArmijo")
             .with_epsilon(1e-4).with_max_iterations(60).with_fx_wide(wide))
        st = b.build(torch.zeros(64, device="cuda"), obj)
        error = None
        try:
            while not st.is_converged():
                st.propagate()
        except LbfgsError as e:
            error = str(e)
        fx = st.state.prob.fx
        res["wide" if wide else "f32"] = dict(
            k=st.state.k, status=st.state.status, status_name=Status(st.state.status).name,
            error=error, fx=float(fx), fx_dtype=type(fx).__name__)
    if res["wide"]["fx_dtype"] != "float64" or res["f32"]["fx_dtype"] != "float32":
        raise AssertionError(f"f32 floor: fx dtypes {res}")
    if not all(np.isfinite(r["fx"]) for r in res.values()):
        raise AssertionError(f"f32 floor: {res}")
    emit(phase="f32_floor", nrow=512, ncol=64, runs=res,
         wide_stops_no_earlier=res["wide"]["k"] >= res["f32"]["k"])


def phase_wide_owlqn_main_path() -> dict:
    """The OWL-QN main path with the wide objective scalar: K7 once at the
    start, then K8 per probe, K14 and K13 per iteration.  12 iterations at
    epsilon 0 against the default run (the same iterations, fx rel 1e-3,
    tests/test_wide_fx.py:121-163), then the run to epsilon 3e-2."""
    wide = OWLQN_PARAMS.replace(fx_wide=True)
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    short = dict(epsilon=0.0, max_iterations=13)
    reset_counts()
    st_w = minimize_jit(wide.replace(**short), x0, default_evaluate(), return_state=True)
    lc, pc, used = launches(), plain_calls(), carried.used
    st_d = minimize_jit(OWLQN_PARAMS.replace(**short), x0, default_evaluate(),
                        return_state=True)
    rel = abs(float(st_w.prob.fx) / float(st_d.prob.fx) - 1)
    if type(st_w.prob.fx) is not np.float64 or st_w.k != st_d.k or not rel <= 1e-3:
        raise AssertionError(f"wide OWL-QN after 12: k {st_w.k} vs {st_d.k}, rel fx {rel}, "
                             f"fx {type(st_w.prob.fx).__name__}")
    _expect("wide OWL-QN, 12 iterations", lc, pc,
            **_wide_owlqn_launches(st_w.k - 1, st_w.prob.neval - 1, used))
    emit(phase="wide_owlqn_vs_default", iters=12, rel_fx=rel, fx_wide=float(st_w.prob.fx),
         fx_default=float(st_d.prob.fx), neval=(st_w.prob.neval, st_d.prob.neval))
    del st_w, st_d
    st, dt, lc, pc, reads = _run_2e24("wide OWL-QN main path", wide)
    used = carried.used
    _expect("wide OWL-QN main path", lc, pc,
            **_wide_owlqn_launches(st.k - 1, st.prob.neval - 1, used))
    _report_2e24("wide_owlqn_main_path", st, dt, lc, reads, eps=3e-2, carried_probes=used,
                 status_name=Status(st.status).name, fx_dtype=type(st.prob.fx).__name__,
                 gnorm=float(np.sqrt(st.prob.gnorm2)))
    del st
    torch.cuda.empty_cache()
    return lc


def _wide_owlqn_launches(iters: int, probes: int, used: int) -> dict:
    """The OWL-QN main path's launches with K7 in K1's place at the start."""
    want = _owlqn_launches(iters, probes, used)
    want["K7_owlqn_trial"] = want.pop("K1_trial")
    return want


def phase_owlqn_north_star() -> None:
    """OWL-QN at n = 1e8, m = 3, bf16 history, c = 1 on [0, n - 1), epsilon
    3e-2 within 300 iterations: the configuration the wide objective scalar
    was built for, wide and then default, with each run's status."""
    n = 100_000_000
    params = LbfgsParams(
        m=3, history_dtype="bfloat16", constrain_step_size=False, epsilon=3e-2,
        max_iterations=301, orthantwise=Orthantwise(1.0, 0, n - 1),
    ).replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo)
    x0 = rosenbrock.initial_point(n, torch.float32, "cuda")
    for wide in (True, False):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = minimize_jit(params.replace(fx_wide=wide), x0, default_evaluate(),
                          return_state=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        lc = launches()
        fx = st.prob.fx
        if not np.isfinite(fx) or (wide and lc["K7_owlqn_trial"] != 1):
            raise AssertionError(f"OWL-QN n=1e8 (wide={wide}): fx {fx}, launches {lc}")
        emit(phase="owlqn_north_star", n=n, m=3, eps=3e-2, fx_wide=wide, status=st.status,
             status_name=Status(st.status).name, iters=st.k - 1, evals=st.prob.neval,
             seconds=dt, ms_per_iter=1e3 * dt / max(st.k - 1, 1), fx=float(fx),
             fx_dtype=type(fx).__name__, gnorm=float(np.sqrt(st.prob.gnorm2)),
             launches={k: v for k, v in lc.items() if v})
        del st
        torch.cuda.empty_cache()


def phase_north_star() -> None:
    n = 100_000_000
    params = LbfgsParams(m=3, history_dtype="bfloat16", constrain_step_size=False,
                         epsilon=3e-2)
    x0 = rosenbrock.initial_point(n, torch.float32, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = minimize_jit(params, x0, default_evaluate(), return_state=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if st.status != Status.CONVERGED:
        raise AssertionError(f"n=1e8 did not converge: status {st.status}")
    emit(phase="north_star", n=n, m=3, eps=3e-2, iters=st.k - 1, seconds=dt,
         ms_per_iter=1e3 * dt / max(st.k - 1, 1), fx=float(st.prob.fx))


# ---------------------------------------------------------------------------
# The combine+probe fusions against the unfused paths, the adaptive entry
# step and the launch overhead
# ---------------------------------------------------------------------------


#: the fused run against the unfused run, and the fused run's plain
#: versions against its kernels: the same iterations (and evaluations) and
#: fx within rel 1e-3 after 8 iterations (tests/test_combine_probe.py:
#: 113-116); after 15 printed
FUSION_TOL_8 = 1e-3


def _fusion_trajectories(name: str, params: LbfgsParams) -> None:
    """After 8 and 15 iterations at epsilon 0: the fused run against the
    same run on the objective without the fusion's hooks, and the fused
    run through the plain versions against the kernels; asserted after 8,
    printed after 15."""
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    fn = default_evaluate()
    for n_it in (8, 15):
        p = params.replace(epsilon=0.0, max_iterations=n_it + 1)
        st_on = minimize_jit(p, x0, fn, return_state=True)
        st_pl = minimize_jit(p, x0, fn.plain, return_state=True)
        st_off = minimize_jit(p, x0, unfused(fn), return_state=True)
        rel_off = abs(float(st_on.prob.fx) / float(st_off.prob.fx) - 1)
        rel_pl = abs(float(st_on.prob.fx) / float(st_pl.prob.fx) - 1)
        key = lambda st: (st.k, st.prob.neval)
        if n_it == 8 and not (key(st_on) == key(st_off) == key(st_pl)
                              and st_on.k == n_it + 1
                              and max(rel_off, rel_pl) <= FUSION_TOL_8):
            raise AssertionError(
                f"{name} after 8 iterations: k/neval fused {key(st_on)}, unfused "
                f"{key(st_off)}, plain {key(st_pl)}; rel fx vs unfused {rel_off:.3e}, vs "
                f"plain {rel_pl:.3e}")
        emit(phase=f"{name}_trajectory", iters=n_it, k_neval_fused=key(st_on),
             k_neval_unfused=key(st_off), k_neval_plain=key(st_pl), rel_fx_vs_unfused=rel_off,
             rel_fx_vs_plain=rel_pl, fx_tol=FUSION_TOL_8, asserted=n_it == 8,
             x_err_vs_unfused=err(st_on.prob.x, st_off.prob.x))
        del st_on, st_pl, st_off
    _agreement(name, params)


def _agreement(name: str, params: LbfgsParams) -> None:
    """Step the fused and the unfused run side by side (``LbfgsState``)
    until either stops or their evaluations part, and print for how many
    iterations the two agree: bit for bit (iterate and fx), and in their
    evaluations.  The directions are the same bit for bit (K15 against K3,
    K16 against K13, K15's fix form against K6), but r.r and r.g come from
    other reduction trees, so a search that interpolates may step
    otherwise in the last bits."""
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    b = Lbfgs(params)
    runs = [b.build(x0, fn) for fn in (default_evaluate(), unfused(default_evaluate()))]
    bits, evals, rel = 0, 0, 0.0

    def step(run):
        # a run that ends in an error status (at epsilon 0 the last
        # iterations may) stops both; its status is printed
        try:
            return run.propagate()
        except LbfgsError:
            return None

    while not any([r.is_converged() for r in runs]):
        on, off = (step(r) for r in runs)
        if on is None or off is None or (on.niter, on.neval) != (off.niter, off.neval):
            break
        evals = on.niter
        rel = max(rel, abs(on.fx / off.fx - 1) if off.fx else abs(on.fx))
        if bits == on.niter - 1 and on.fx == off.fx and same_bits(on.x, off.x):
            bits = on.niter
    emit(phase=f"{name}_agreement", iters_bit_identical=bits, iters_same_evals=evals,
         max_rel_fx_while_same_evals=rel, stopped_at=[int(r.state.k) for r in runs],
         statuses=[int(r.state.status) for r in runs])
    del runs
    torch.cuda.empty_cache()


def _walls(params: LbfgsParams) -> dict:
    """ms per iteration of ``minimize_jit`` at n = 2^24 with the fusion and
    without it, in turns (off, on, on, off, off, on): the host's pace
    drifts within a call, so the two are compared only side by side."""
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    fn = default_evaluate()
    out = {"off": [], "on": []}
    for on in (False, True, True, False, False, True):
        runs = []
        dt = profiling.timed(lambda: runs.append(
            minimize_jit(params, x0, fn if on else unfused(fn), return_state=True)), warmup=0)
        out["on" if on else "off"].append(1e3 * dt / (runs[0].k - 1))
        del runs
    return out


def _unfused_run(name: str, params: LbfgsParams, fused: dict, expect, converged: bool):
    """One timed ``minimize_jit`` of a main path on the objective without
    the fusion's hooks: its launches are ``expect(iters, probes)``, no
    plain version runs and no first trip is carried in; printed beside
    the fused run ``fused`` of this call, with ms/iter of both in turns.
    The fusion must save at least half a read per iteration."""
    st, dt, lc, pc, reads = _run_2e24(name, params, unfused(default_evaluate()))
    iters, probes = st.k - 1, st.prob.neval - 1
    if converged and st.status != Status.CONVERGED:
        raise AssertionError(f"{name}: status {st.status} after {iters} iterations")
    _expect(name, lc, pc, **expect(iters, probes))
    if carried.used:
        raise AssertionError(f"{name}: {carried.used} carried first trips without the fusion")
    out = _report_2e24(
        name.replace(" ", "_"), st, dt, lc, reads,
        fused={k: fused[k] for k in ("iters", "evals", "ms_per_iter", "syncs_per_iter",
                                     "probes_per_iter")},
        ms_per_iter_in_turns=_walls(params))
    if not fused["syncs_per_iter"] <= out["syncs_per_iter"] - 0.5:
        raise AssertionError(f"{name}: {fused['syncs_per_iter']} syncs per iteration with the "
                             f"fusion against {out['syncs_per_iter']} without")
    del st
    torch.cuda.empty_cache()
    return lc, out


def phase_unfused_main_path(fused: dict) -> tuple:
    """The main path without the fusion: K3 in place of K15, K2 on every
    probe (``fused``: the main path of this call)."""
    lc, out = _unfused_run(
        "unfused main path", MAIN_PARAMS, fused,
        lambda it, pr: dict(K1_trial=1, K2_probe=pr, K3_combine=it, K4_trial_pair_gram=it),
        converged=False)
    _fusion_trajectories("main_path_vs_unfused", MAIN_PARAMS)
    return lc, out


def phase_unfused_owlqn_main_path(fused: dict) -> tuple:
    """The OWL-QN main path without the fusion: K13 in place of K16,
    CONVERGED at 3e-2."""
    lc, out = _unfused_run(
        "unfused OWL-QN main path", OWLQN_PARAMS, fused,
        lambda it, pr: dict(K1_trial=1, K10_pseudo_gradient_norm=1, K8_owlqn_probe=pr,
                            K13_combine_ow=it, K14_owlqn_trial_pair_gram=it),
        converged=True)
    _fusion_trajectories("owlqn_main_path_vs_unfused", OWLQN_PARAMS)
    return lc, out


def phase_unfused_damped_main_path(fused: dict) -> dict:
    """The damped main path without the fusion: K6 persists the damped row
    in place of K15's fix form; then the damped main path against it and
    against its plain versions after 8 and 15 iterations."""
    lc, _ = _unfused_run(
        "unfused damped main path", DAMPED_PARAMS, fused,
        lambda it, pr: dict(K1_trial=1, K2_probe=pr, K4_trial_pair_gram_gp=it,
                            K6_combine_fix=it),
        converged=False)
    _fusion_trajectories("damped_main_path_vs_unfused", DAMPED_PARAMS)
    return lc


def phase_adaptive_entry(literal: dict) -> dict:
    """The OWL-QN main path with ``with_adaptive_entry_step(2.0)``, with and
    without the fusion: each CONVERGED; evaluations beside the literal
    run's (``literal``).  Then the JAX package's own case at n = 2^14
    (``tests/test_adaptive_entry.py:93-115``: c = 1 on the whole vector,
    f32 history, at most 400 iterations), literal and adaptive, to set the
    main path's count beside the scale the policy was measured at."""
    params = OWLQN_PARAMS.replace(adaptive_entry_step=2.0)
    runs = {}
    for on in (True, False):
        name = "adaptive entry" + ("" if on else " unfused")
        fn = default_evaluate()
        st, dt, lc, pc, reads = _run_2e24(name, params, fn if on else unfused(fn))
        used = carried.used
        iters, probes = st.k - 1, st.prob.neval - 1
        if st.status != Status.CONVERGED:
            raise AssertionError(f"{name}: status {st.status} after {iters} iterations")
        want = _owlqn_launches(iters, probes, used)
        if not on:
            want["K13_combine_ow"] = want.pop("K16_combine_ow_probe")
        _expect(name, lc, pc, **want)
        if on:
            _carried_all(name, used, iters)
        runs[on] = _report_2e24(
            "adaptive_entry", st, dt, lc, reads, fusion=on, growth=2.0, eps=3e-2,
            carried_probes=used, literal_evals=literal["evals"],
            literal_iters=literal["iters"], literal_ms_per_iter=literal["ms_per_iter"],
            gnorm=float(np.sqrt(st.prob.gnorm2)))
        del st
    n = 1 << 14
    small = LbfgsParams(epsilon=3e-2, max_iterations=400, constrain_step_size=False,
                        orthantwise=Orthantwise(1.0, 0, None))
    x0 = rosenbrock.initial_point(n, torch.float32, "cuda")
    at_2e14 = {}
    for growth in (0.0, 2.0):
        st = minimize_jit(small.replace(adaptive_entry_step=growth), x0, default_evaluate(),
                          return_state=True)
        if st.status != Status.CONVERGED:
            raise AssertionError(f"adaptive entry at n = 2^14 (growth {growth}): status "
                                 f"{st.status}")
        at_2e14[growth] = dict(iters=st.k - 1, evals=st.prob.neval, fx=float(st.prob.fx))
    emit(phase="adaptive_entry_2e14", n=n, literal=at_2e14[0.0], adaptive=at_2e14[2.0])
    torch.cuda.empty_cache()
    return runs


#: the host's launch and copy calls as torch.profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchKernelExC")


def _host_us(fn, reps: int) -> float:
    """Microseconds of host wall per call of fn, back to back, the card
    drained before and after."""
    return 1e3 * wall_ms(fn, reps)


def phase_launch_overhead(paths: dict) -> dict:
    """Launch and read costs from the calibration kernel, and what they
    explain of each main path's ms/iter.

    Per call, back to back: the calibration kernel through the port's
    ctypes wrapper (how K3, K5, K6 and K9-K13, K17 launch), a one-program
    K2 launched by Triton's own launcher with its operands made before
    (the launch of K1, K2, K4, K7, K8, K14-K16, without the wrapper's
    step fill and partial sums, which are torch ops), a torch elementwise
    op (the two-loop's [m]-sized algebra, the fills and sums), the
    calibration kernel followed by a one-element copy to the host (the
    synchronising read, without ``to_host``'s own torch ops), and the same
    followed by one ``to_host`` read instead (printed; the model below
    counts ``to_host``'s torch ops among the torch launches).  Then, for each
    path (name: (params, fused, ms_per_iter, syncs_per_iter) of this call,
    ``fused`` False for the objective without the fusion's hooks), one
    15-iteration run under torch.profiler counts the host's launch calls
    per iteration, split by route from the kernels' own counters, and
    the modelled host ms/iter = Triton launches x Triton us + ctypes
    launches x null us + other launches x torch us + reads x read us is
    printed beside the measured ms/iter."""
    reset_counts()
    x = torch.zeros(N_NULL, device="cuda")
    xp = torch.ones(factory.BLOCK, device="cuda")
    stp, part = torch.full((1,), 0.5, device="cuda"), torch.empty((1, 2), device="cuda")
    probe_kernel, body = factory._kernels().probe_kernel, rosenbrock._rosen_block()

    def triton_launch():
        probe_kernel[(1,)](xp, xp, stp, part, factory.BLOCK, body=body,
                           ROWS=factory.BLOCK // 2, W=2, **factory.LAUNCH)

    us = dict(
        null=_host_us(lambda: profiling.null_launch(x), 2000),
        triton=_host_us(triton_launch, 2000),
        torch_op=_host_us(lambda: torch.add(x, 1.0), 2000),
        null_read=_host_us(lambda: profiling.null_launch(x)[:1].cpu(), 500),
        null_to_host=_host_us(lambda: to_host(profiling.null_launch(x)[0]), 500),
    )
    us["read"] = us["null_read"] - us["null"]
    null_launches = profiling.null_launch.launches
    triton_k = [k for k, (route, *_r) in KERNELS.items() if route == "triton"]
    cuda_k = [k for k, (route, *_r) in KERNELS.items() if route == "cuda"]
    out = {}
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    for name, (params, fused, ms_per_iter, syncs) in paths.items():
        fn = default_evaluate() if fused else unfused(default_evaluate())

        def one_run():
            reset_counts()
            return minimize_jit(params.replace(epsilon=0.0, max_iterations=16), x0, fn,
                                return_state=True)

        prof, st = profiled(one_run)
        iters, lc = st.k - 1, launches()
        per = dict(triton=sum(lc[k] for k in triton_k) / iters,
                   cuda=sum(lc[k] for k in cuda_k) / iters)
        if prof is None:
            # no session saw the card: the host's launch calls are unknown
            out[name] = dict(launches_per_iter=per, launch_calls_per_iter=None,
                             syncs_per_iter=syncs, ms_per_iter=ms_per_iter,
                             modelled_host_ms_per_iter=None, share_explained=None)
            continue
        calls = sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS)
        per["torch_op"] = calls / iters - per["triton"] - per["cuda"]
        model = 1e-3 * (per["triton"] * us["triton"] + per["cuda"] * us["null"]
                        + per["torch_op"] * us["torch_op"] + syncs * us["read"])
        out[name] = dict(launches_per_iter=per, launch_calls_per_iter=calls / iters,
                         syncs_per_iter=syncs, ms_per_iter=ms_per_iter,
                         modelled_host_ms_per_iter=model,
                         share_explained=model / ms_per_iter)
        del st
    emit(phase="launch_overhead", us_per_call=us, paths=out)
    return {"cal_null_launch": null_launches}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="also profile one run of each main path; operator tables to PATH")
    args = ap.parse_args()
    seconds = {}

    def run(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[fn.__name__.removeprefix("phase_")] = round(time.perf_counter() - t0, 3)
        return out

    run(phase_device)
    run(phase_build)
    k = run(phase_kernels)
    run(phase_goldens)
    run(phase_owlqn_golden)
    lc_main, main_out = run(phase_main_path)
    lc_ow, ow_out = run(phase_owlqn_main_path)
    run(phase_north_star)
    run(phase_damped_n100)
    run(phase_lj38)
    lc_d, d_out = run(phase_damped_main_path, main_out["syncs_per_iter"])
    run(phase_gradient_only_main_path)
    lc_dow = run(phase_damped_owlqn_main_path)
    lc_k5 = run(phase_k5_route)
    run(phase_wide_kernels)
    lc_poisson = run(phase_poisson_main_path)
    run(phase_poisson_f64_vs_cpu)
    run(phase_f32_floor)
    lc_wide = run(phase_wide_owlqn_main_path)
    run(phase_owlqn_north_star)
    lc_un, un_out = run(phase_unfused_main_path, main_out)
    lc_unow, unow_out = run(phase_unfused_owlqn_main_path, ow_out)
    run(phase_adaptive_entry, ow_out)
    lc_und = run(phase_unfused_damped_main_path, d_out)
    lc_cal = run(phase_launch_overhead, {
        name: (params, fused, out["ms_per_iter"], out["syncs_per_iter"])
        for name, params, fused, out in (
            ("main_path", MAIN_PARAMS, True, main_out),
            ("owlqn_main_path", OWLQN_PARAMS, True, ow_out),
            ("main_path_unfused", MAIN_PARAMS, False, un_out),
            ("owlqn_main_path_unfused", OWLQN_PARAMS, False, unow_out))})
    if args.profile:
        run(phase_profile, args.profile)
    emit(phase="timing", seconds=seconds, profiler_misses=PROFILER_MISSES)
    # each kernel's launches on its own path; K17 lies on no solver path,
    # and its count is the main path's run's, which stays 0
    lc = {**{name: lc_main[name] for name in PLAIN_PATH},
          **{name: lc_ow[name] for name in OWLQN_PATH if name not in PLAIN_PATH},
          **{name: lc_d[name] for name in DAMPED_PATH},
          **{name: lc_dow[name] for name in DAMPED_OWLQN_PATH},
          **{name: lc_k5[name] for name in K5_PATH},
          **{name: lc_poisson[name] for name in POISSON_PATH},
          **{name: lc_wide[name] for name in WIDE_OWLQN_PATH},
          **{name: lc_un[name] for name in UNFUSED_PATH},
          **{name: lc_unow[name] for name in UNFUSED_OWLQN_PATH},
          **{name: lc_und[name] for name in UNFUSED_DAMPED_PATH},
          "K17_axpy_dot": lc_main["K17_axpy_dot"], **lc_cal}
    # library_ms: one PyTorch call computing the same function, where one
    # exists (only the calibration kernel's o = x + 1)
    table = [
        dict(name=name, route=route, source=src, replaces=rep, launches=lc[name],
             max_abs_err=k["errs"][name][0], max_normwise_err=k["errs"][name][1],
             ms=k["times"][name][0], plain_ms=k["times"][name][1],
             bound_ms=k["bounds"][name][0], bound_by=k["bounds"][name][1],
             library_ms=k["library"].get(name))
        for name, (route, src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
