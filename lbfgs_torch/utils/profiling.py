"""Profiling helpers (the counterpart of ``lbfgs_tpu/utils/profiling.py``).

Usage::

    from lbfgs_torch.utils.profiling import trace, timed

    with trace("build/lbfgs-trace.json"):      # chrome://tracing, Perfetto
        report = lbfgs().minimize_jit(x0, objective)

    dt = timed(lambda: lbfgs().minimize_jit(x0, objective))

``null_launch`` launches the calibration kernel (``csrc/calibrate.cu``,
the counterpart of the JAX package's harness kernel in
``bench_kernels.py``): o = x + 1 on one block of 1024 float32 elements,
whose time per launch is the cost every kernel launch adds beyond its
work.  ``null_launch_ref`` is its plain version, which a CPU tensor gets.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable

import torch

from ..ops import _build, fused


@contextmanager
def trace(path: str | None = None):
    """Record the enclosed block with ``torch.profiler`` (host and, where
    a card is present, device activity) and, given ``path``, write a
    Chrome trace there.  Yields the profiler, whose ``key_averages()``
    gives the per-operator sums."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    if path is not None:
        prof.export_chrome_trace(path)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn: Callable[[], object], warmup: int = 1, repeats: int = 1) -> float:
    """Steady-state wall time of ``fn()`` in seconds, best of ``repeats``
    after ``warmup`` untimed calls, each call ended by
    ``torch.cuda.synchronize`` (PyTorch returns before the card is done)."""
    for _ in range(warmup):
        fn()
        _sync()
    best = float("inf")
    for _ in range(repeats):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


#: elements of the calibration kernel's one block (``csrc/calibrate.cu``)
NULL_ELEMS = 1024


def _check_null(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.shape != (NULL_ELEMS,):
        raise ValueError(f"null_launch takes a float32 [{NULL_ELEMS}] tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")


def null_launch_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``null_launch``."""
    null_launch_ref.calls += 1
    _check_null(x)
    return x + 1.0


null_launch_ref.calls = 0


def null_launch(x: torch.Tensor) -> torch.Tensor:
    """o = x + 1 by the calibration kernel: one block, 1024 float32
    elements, so its time is launch overhead."""
    _check_null(x)
    if not fused.on_cuda(x, "null_launch"):
        return null_launch_ref(x)
    fused.check_contiguous("null_launch", x)
    lib = _build.load_library()
    o = torch.empty_like(x)
    code = lib.lbfgs_null_launch(x.data_ptr(), o.data_ptr(),
                                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(code, "null_launch")
    null_launch.launches += 1
    return o


null_launch.launches = 0
