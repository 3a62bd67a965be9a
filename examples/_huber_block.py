"""The Triton body of ``separable_torch.py``'s index-weighted Huber loss.

Imports ``triton`` at the top: the example loads this module at the first
kernel launch only (a CPU run never does).  The body computes as its torch
twin ``separable_torch.huber_ref`` does, operation by operation.
"""

import triton
import triton.language as tl


@triton.jit
def huber_block(x, gidx, tb):
    """(scale * huber(x - t), its gradient), scale = 1 + (gidx mod 4) / 4"""
    r = x - tb
    scale = 1.0 + 0.25 * (gidx % 4).to(x.dtype)
    a = tl.abs(r)
    quad = 0.5 * (r * r)
    lin = a - 0.5
    fx_elem = scale * tl.where(a <= 1.0, quad, lin)
    sign = tl.where(r > 0.0, 1.0, tl.where(r < 0.0, -1.0, 0.0))
    g = scale * tl.where(a <= 1.0, r, sign)
    return fx_elem, g
