"""R (``fused.reduce_partials``, ``csrc/partials.cu``) on the card, marked
``cuda`` (they skip without one; no JAX needed: ``python -m pytest
tests/test_torch_partials_card.py -m cuda``).

- R against a float64 sum of the same partials: per column |R - sum| <=
  tol * sum |x|, tol 1e-6 in float32 (R's lanes add at most 16 rows at
  these counts, then a tree of 10 levels: ~26 roundings of 6e-8), 1e-14
  in float64 and in the wide form (float32 partials added in float64);
- R bit for bit its order twin, ``fused.reduce_partials_order_ref``, run
  in torch ops on the card;
- R's column j the same bits at widths 1, 2, 5, 8, 4 + 6m (m = 6 and
  80), as one instance of a batch and through a strided view: what lets
  one launch sum every lane of K2 s and K8 s with each lane's bits K2's
  and K8's;
- one launch per call, counted; a dtype without a kernel raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbfgs_torch.ops import fused

TOL = {"float32": 1e-6, "float64": 1e-14, "wide": 1e-14}
#: row counts of the paths: the batched kernels' 16 programs an instance
#: at 2^14, K2 at 2^20 and 2^24, K4's 4224 programs, and odd ones
ROWS = (1, 5, 16, 32, 33, 1024, 3001, 4224, 16384)
WIDTHS = (1, 2, 5, 8, 4 + 6 * 6, 4 + 6 * 80)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _partials(shape, dtype: str, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp(rng.uniform(-3, 3, shape))
    return torch.from_numpy(x.astype(np.float64 if dtype == "float64" else np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64", "wide"])
@pytest.mark.parametrize("P", ROWS)
def test_r_against_float64(cuda, dtype, P):
    wide = dtype == "wide"
    for shape, dim in (((P, 5), 0), ((6, P, 3), 1)):
        x = _partials(shape, dtype, P + len(shape), cuda)
        before = fused.reduce_partials.launches
        got = fused.reduce_partials(x, dim, wide)
        assert fused.reduce_partials.launches == before + 1
        assert got.dtype == (torch.float64 if wide or dtype == "float64" else torch.float32)
        want = x.double().sum(dim=dim)
        scale = x.double().abs().sum(dim=dim)
        assert torch.all((got.double() - want).abs() <= TOL[dtype] * scale)
        assert torch.equal(got, fused.reduce_partials_order_ref(x, dim, wide))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64", "wide"])
@pytest.mark.parametrize("P", ROWS)
def test_r_column_bits_whatever_the_width(cuda, dtype, P):
    wide = dtype == "wide"
    col = _partials((P,), dtype, 7 * P, cuda)
    want = fused.reduce_partials(col, 0, wide)
    assert want.shape == ()
    for C in WIDTHS:
        j = C // 3
        x = _partials((P, C), dtype, C, cuda)
        x[:, j] = col
        assert torch.equal(fused.reduce_partials(x, 0, wide)[j], want), C
        assert torch.equal(fused.reduce_partials(x[:, j], 0, wide), want), C
        xb = _partials((4, P, C), dtype, C + 1, cuda)
        xb[2, :, j] = col
        assert torch.equal(fused.reduce_partials(xb, 1, wide)[2, j], want), C
        assert torch.equal(fused.reduce_partials(xb[:, :, j], 1, wide)[2], want), C


@pytest.mark.cuda
def test_r_refuses_other_dtypes(cuda):
    with pytest.raises(TypeError, match="reduce_partials"):
        fused.reduce_partials(torch.ones(8, 2, dtype=torch.bfloat16, device=cuda))
    with pytest.raises(ValueError, match="reduce_partials"):
        fused.reduce_partials(torch.ones(2, 8, 2, device=cuda), 0)
