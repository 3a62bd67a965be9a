"""ctypes bindings for the native C++ core (``csrc/lbfgs_native.cpp``).

The counterpart of ``lbfgs_tpu/native/__init__.py``, and like it a host
core by definition: the reference's sequential float64 algorithm, with
no device.  Two uses:

  * ``minimize(..., backend="native")``, the fast path for small problems
    where launch latency dominates, and the sequential-float64 oracle the
    reference's recorded trajectories are pinned to;
  * ``minimize_native_rosenbrock``, the reference-equivalent CPU baseline
    of a benchmark (its C++ Rosenbrock, no Python callback).

The library is compiled from the repository's ``csrc/lbfgs_native.cpp``
with ``g++`` at first use, into the package's gitignored build directory
(``ops._build.BUILD_DIR``), under a name keyed by a hash of the source and
the flags.  It is written to a per-process temporary file first and moved
into place, so parallel processes do not race; nothing is written
anywhere else.
"""

from __future__ import annotations

import ctypes as ct
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..core import Progress, Report
from ..ops._build import BUILD_DIR
from ..status import LbfgsError, Status, is_fatal

SRC = Path(__file__).resolve().parents[2] / "csrc" / "lbfgs_native.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-shared")


class NativeConfig(ct.Structure):
    _fields_ = [
        ("m", ct.c_int32),
        ("epsilon", ct.c_double),
        ("max_iterations", ct.c_int64),
        ("max_evaluations", ct.c_int64),
        ("ls_algo", ct.c_int32),
        ("ftol", ct.c_double),
        ("gtol", ct.c_double),
        ("xtol", ct.c_double),
        ("min_step", ct.c_double),
        ("max_step", ct.c_double),
        ("max_linesearch", ct.c_int32),
        ("gradient_only", ct.c_int32),
        ("owlqn_enabled", ct.c_int32),
        ("owlqn_c", ct.c_double),
        ("owlqn_start", ct.c_int64),
        ("owlqn_end", ct.c_int64),
        ("initial_inverse_hessian", ct.c_double),
        ("max_step_size", ct.c_double),
        ("damping", ct.c_int32),
        ("constrain_step_size", ct.c_int32),
    ]


class NativeReport(ct.Structure):
    _fields_ = [
        ("fx", ct.c_double),
        ("xnorm", ct.c_double),
        ("gnorm", ct.c_double),
        ("neval", ct.c_int64),
        ("niter", ct.c_int64),
        ("status", ct.c_int32),
    ]


#: fx = eval(x, g, n, user, fail): the objective callback
EVAL_FN = ct.CFUNCTYPE(
    ct.c_double, ct.POINTER(ct.c_double), ct.POINTER(ct.c_double), ct.c_int64,
    ct.c_void_p, ct.POINTER(ct.c_int32),
)
#: cancel = progress(niter, fx, xnorm, gnorm, step, neval, ncall, user)
PROGRESS_FN = ct.CFUNCTYPE(
    ct.c_int32, ct.c_int64, ct.c_double, ct.c_double, ct.c_double, ct.c_double,
    ct.c_int64, ct.c_int64, ct.c_void_p,
)


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"liblbfgs_native_{h.hexdigest()[:16]}.so"


@functools.cache
def load() -> ct.CDLL:
    """Load the native library, compiling it first if no library of the
    current source exists."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)], check=True)
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    lib = ct.CDLL(str(out))
    lib.lbfgs_native_minimize.restype = ct.c_int32
    lib.lbfgs_native_minimize.argtypes = [
        ct.c_int64, ct.POINTER(ct.c_double), EVAL_FN, ct.c_void_p, PROGRESS_FN,
        ct.c_void_p, ct.POINTER(NativeConfig), ct.POINTER(NativeReport),
    ]
    lib.lbfgs_native_default_config.argtypes = [ct.POINTER(NativeConfig)]
    lib.lbfgs_native_abi_version.restype = ct.c_int32
    if lib.lbfgs_native_abi_version() != 1:
        raise RuntimeError("native core: unexpected ABI version")
    lib.lbfgs_native_rosenbrock_eval.restype = ct.c_double
    return lib


_LS_ALGO_CODES = {
    "MoreThuente": 0,
    "BacktrackingArmijo": 1,
    "BacktrackingWolfe": 2,
    "BacktrackingStrongWolfe": 3,
}


def config_from_params(params) -> NativeConfig:
    """Translate an ``LbfgsParams`` into the native config struct."""
    lib = load()
    cfg = NativeConfig()
    lib.lbfgs_native_default_config(ct.byref(cfg))
    cfg.m = params.m
    cfg.epsilon = params.epsilon
    cfg.max_iterations = params.max_iterations
    cfg.max_evaluations = params.max_evaluations
    ls = params.linesearch
    cfg.ls_algo = _LS_ALGO_CODES[ls.algorithm]
    cfg.ftol = ls.ftol
    cfg.gtol = ls.gtol
    cfg.xtol = ls.xtol
    cfg.min_step = ls.min_step
    cfg.max_step = ls.max_step
    cfg.max_linesearch = ls.max_linesearch
    cfg.gradient_only = int(ls.gradient_only)
    ow = params.orthantwise
    if ow is not None:
        cfg.owlqn_enabled = 1
        cfg.owlqn_c = ow.c
        cfg.owlqn_start = ow.start
        cfg.owlqn_end = -1 if ow.end is None else ow.end
    cfg.initial_inverse_hessian = params.initial_inverse_hessian
    cfg.max_step_size = params.max_step_size
    cfg.damping = int(params.damping)
    cfg.constrain_step_size = int(params.constrain_step_size)
    return cfg


def _run(params, x: np.ndarray, eval_cb, progress_cb) -> Report:
    """One call of the core over ``x`` (float64, iterated in place)."""
    rep = NativeReport()
    load().lbfgs_native_minimize(
        x.shape[0], x.ctypes.data_as(ct.POINTER(ct.c_double)), eval_cb, None,
        progress_cb, None, ct.byref(config_from_params(params)), ct.byref(rep),
    )
    if is_fatal(rep.status):
        raise LbfgsError(Status(rep.status))
    return Report(fx=rep.fx, xnorm=rep.xnorm, gnorm=rep.gnorm, neval=rep.neval,
                  x=torch.from_numpy(x), niter=rep.niter, status=rep.status)


def _copy(x0) -> np.ndarray:
    """A float64 copy of x0 for the core to iterate in place: never the
    caller's buffer."""
    if isinstance(x0, torch.Tensor):
        x0 = x0.detach().cpu().numpy()
    return np.array(x0, dtype=np.float64)


def minimize_native_rosenbrock(params, x0) -> Report:
    """Run the native solver with the built-in C++ Rosenbrock evaluator
    (no Python callback): the reference-equivalent CPU baseline of a
    benchmark.  ``Report.x`` is a CPU float64 tensor."""
    lib = load()
    x = _copy(x0)
    return _run(params, x, ct.cast(lib.lbfgs_native_rosenbrock_eval, EVAL_FN),
                ct.cast(None, PROGRESS_FN))


def minimize_native(
    params,
    x0,
    evaluate: Callable[[np.ndarray, np.ndarray], float],
    progress: Optional[Callable[[Progress], bool]] = None,
) -> Report:
    """Run the native sequential solver.

    ``evaluate(x, gx) -> fx`` is the reference-style closure over numpy
    float64 views of the core's buffers: it writes the gradient into
    ``gx``.  ``progress(Progress) -> bool`` cancels on True (its ``x`` is
    a CPU tensor over the core's iterate, ``gx`` None).  ``x0`` (numpy or
    a tensor) is copied, never iterated in place.  Returns a ``Report``
    whose ``x`` is a CPU float64 tensor.
    """
    ls = params.linesearch
    if ls.algorithm == "MoreThuente" and ls.gradient_only and params.orthantwise is None:
        raise ValueError(
            "Gradient only optimization is incompatible with MoreThuente line search.")
    x = _copy(x0)

    @EVAL_FN
    def eval_cb(xp, gp, nn, user, fail):
        xv = np.ctypeslib.as_array(xp, shape=(nn,))
        gv = np.ctypeslib.as_array(gp, shape=(nn,))
        try:
            return float(evaluate(xv, gv))
        except Exception:
            fail[0] = 1
            return float("nan")

    if progress is not None:
        xt = torch.from_numpy(x)

        @PROGRESS_FN
        def progress_cb(niter, fx, xnorm, gnorm, step, neval, ncall, user):
            p = Progress(x=xt, gx=None, fx=fx, xnorm=xnorm, gnorm=gnorm, step=step,
                         niter=niter, neval=neval, ncall=ncall)
            return 1 if progress(p) else 0
    else:
        progress_cb = ct.cast(None, PROGRESS_FN)
    return _run(params, x, eval_cb, progress_cb)
