"""Build and load the package's CUDA C++ kernels, and set up Triton.

The sources under ``lbfgs_torch/csrc/*.cu`` are compiled at first use with
``nvcc``, one process per source, all started together, and the objects
are linked into one shared library with a plain C interface, which is
loaded with ``ctypes``.  The library lands in the repository's ``build/``
directory (listed in ``.gitignore``) under a name keyed by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses the
library.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: the C entry points and their argument types; every pointer and the
#: stream go as c_void_p, or ctypes would pass them as 32-bit ints
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "lbfgs_combine_block_elems": ([], ctypes.c_int),
    "lbfgs_owlqn_block_elems": ([], ctypes.c_int),
    "lbfgs_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    **{
        f"lbfgs_combine_{sfx}": (
            [_P, _P, _P, _P, _P, _P, _LL, _LL, ctypes.c_int, _P], ctypes.c_int)
        for sfx in ("f32_bf16", "f32_f32", "f64_f64")
    },
    **{
        f"lbfgs_combine_fix_{sfx}": (
            [_P, _P, _P, _P, _P, _P, _LL, _LL, ctypes.c_int, ctypes.c_int, _P], ctypes.c_int)
        for sfx in ("f32_bf16", "f32_f32", "f64_f64")
    },
    **{
        f"lbfgs_combine_batched_{sfx}": (
            [_P, _P, _P, _P, _P, _P, _P, _LL, _LL, ctypes.c_int, ctypes.c_int, _P],
            ctypes.c_int)
        for sfx in ("f32_bf16", "f32_f32", "f64_f64")
    },
    **{
        f"lbfgs_combine_fix_batched_{sfx}": (
            [_P, _P, _P, _P, _P, _P, _P, _LL, _LL, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _P], ctypes.c_int)
        for sfx in ("f32_bf16", "f32_f32", "f64_f64")
    },
    **{
        f"lbfgs_combine_ow_batched_{sfx}": (
            [_P, _P, _P, _P, _P, _P, _P, _LL, _LL, ctypes.c_int, _LL, _LL, ctypes.c_int, _P],
            ctypes.c_int)
        for sfx in ("f32_bf16", "f32_f32", "f64_f64")
    },
    **{
        f"lbfgs_pair_gram_{sfx}": (
            [ctypes.c_double, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, _LL, _LL, _LL, _P], ctypes.c_int)
        for sfx in ("f32_bf16", "f32_f32", "f64_f64")
    },
    **{
        f"lbfgs_combine_ow_{sfx}": (
            [_P, _P, _P, _P, _P, _P, _LL, _LL, ctypes.c_int, _LL, _LL, _P], ctypes.c_int)
        for sfx in ("f32_bf16", "f32_f32", "f64_f64")
    },
    **{
        f"lbfgs_pair_gram_xg_{sfx}": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, _LL, _LL, _LL, _P], ctypes.c_int)
        for sfx in ("f32_bf16", "f32_f32", "f64_f64")
    },
    **{
        f"lbfgs_pseudo_grad_norm_{sfx}": (
            [_P, _P, ctypes.c_double, _LL, _LL, _P, _P, _LL, _P], ctypes.c_int)
        for sfx in ("f32", "f64")
    },
    **{
        f"lbfgs_pseudo_grad_norm_batched_{sfx}": (
            [_P, _P, ctypes.c_double, _LL, _LL, _P, _P, _P, _LL, ctypes.c_int, _P],
            ctypes.c_int)
        for sfx in ("f32", "f64")
    },
    **{
        f"lbfgs_pair_gram_xg_batched_{sfx}": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, ctypes.c_int, ctypes.c_int, _LL, _LL,
             _LL, ctypes.c_int, _P], ctypes.c_int)
        for sfx in ("f32_bf16", "f32_f32", "f64_f64")
    },
    **{
        f"lbfgs_pair_gram_batched_{sfx}": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, _LL, _LL, _LL, ctypes.c_int, _P], ctypes.c_int)
        for sfx in ("f32_bf16", "f32_f32", "f64_f64")
    },
    **{
        f"lbfgs_pseudo_grad_batched_{sfx}": (
            [_P, _P, ctypes.c_double, _LL, _LL, _P, _P, _LL, ctypes.c_int, _P], ctypes.c_int)
        for sfx in ("f32", "f64")
    },
    **{
        f"lbfgs_owlqn_trial_step_batched_{sfx}": (
            [_P, _P, _P, _P, _LL, _LL, _P, _P, _LL, ctypes.c_int, _P], ctypes.c_int)
        for sfx in ("f32", "f64")
    },
    **{
        f"lbfgs_pseudo_grad_{sfx}": (
            [_P, _P, ctypes.c_double, _LL, _LL, _P, _LL, _P], ctypes.c_int)
        for sfx in ("f32", "f64")
    },
    **{
        f"lbfgs_owlqn_trial_step_{sfx}": (
            [_P, _P, _P, ctypes.c_double, _LL, _LL, _P, _LL, _P], ctypes.c_int)
        for sfx in ("f32", "f64")
    },
    "lbfgs_axpy_dot_block_elems": ([], ctypes.c_int),
    **{
        f"lbfgs_axpy_dot_{sfx}": (
            [_P, _P, ctypes.c_double, _P, _P, _P, _LL, _P], ctypes.c_int)
        for sfx in ("f32", "f64")
    },
    "lbfgs_partials_lanes": ([], ctypes.c_int),
    "lbfgs_partials_scratch": ([_LL, _LL, _LL], _LL),
    **{
        f"lbfgs_partials_{sfx}": ([_P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P], ctypes.c_int)
        for sfx in ("f32", "f64", "f32_wide")
    },
    "lbfgs_null_elems": ([], ctypes.c_int),
    "lbfgs_null_launch": ([_P, _P, _P], ctypes.c_int),
}


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblbfgs_torch_{h.hexdigest()[:16]}.so"


def _run(procs: list) -> str:
    """Wait for every compiler process; raise with the output of the
    first that failed.  Returns what they printed."""
    out, failed = [], None
    for cmd, proc in procs:
        stdout, _ = proc.communicate()
        out.append(stdout)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stdout}"
    if failed:
        raise RuntimeError(failed)
    return "".join(out)


def _start(cmd: list) -> tuple:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` if no library of the current sources exists,
    load it, and declare every entry point's signature.  The sources
    compile in parallel, one ``nvcc`` each.  The compiler's output
    (``-Xptxas=-v``: registers, shared memory, spills per kernel) is kept
    beside the library as ``<name>.log``."""
    out = _library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
        tmp = out.with_name(f"{tag}.tmp.so")
        try:
            log = _run([_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
                        for src, obj in zip(srcs, objs)])
            log += _run([_start([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                                 *map(str, objs)])])
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def build_log() -> str:
    """What nvcc printed when the current library was built."""
    log = _library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check_launch(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = load_library().lbfgs_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({code}: {msg})")


def import_triton():
    """Import ``triton`` on first launch, with its compile cache kept
    under the repository's build directory."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton

    return triton
