"""R, the second stage of the port's kernel partials (``fused.reduce_partials``,
``csrc/partials.cu``), on the CPU against ``lbfgs_tpu``.

On a CPU tensor R runs its plain version, torch's sum (in float64 for the
wide form), so the CPU paths keep their bits.  Held here, on numpy-seeded
partials of [P, C] and [B, P, C] in float32, float64 and the wide form:

- the plain version against the JAX package's ``obj_reduce``
  (``lbfgs_tpu/ops/fused.py:285-296``, jnp.sum) per column, and so is
  ``reduce_partials_order_ref``, R's order of addition in torch ops, which
  the card's R equals bit for bit (``tests/test_torch_partials_card.py``).
  Tolerance: |sum - jnp.sum| <= tol * sum |x| per column, tol 1e-6 for
  float32 sums (at most 16384 terms: R's lanes add 16 rows each and a
  tree of 10 levels, jnp.sum its own order, each ~log2(P) roundings of
  6e-8), 1e-14 for float64 and the wide form (float64 adds of the same
  terms);
- the plain version is torch's sum bit for bit, on every shape and
  strided view the wrappers pass;
- the order twin's column j is the same bits whatever the array's width
  (1, 2, 5, 8, 4 + 6m), the batch or the strides: what makes one launch
  for all lanes of K2 s and K8 s give each lane K2's and K8's bits;
- the launch chunks of the K-lane probes cover the lanes in order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from lbfgs_torch.ops import factory, fused
from lbfgs_tpu.ops import fused as j_fused

#: per-column tolerance relative to sum |x|, by the sums' dtype
TOL = {"float32": 1e-6, "float64": 1e-14, "wide": 1e-14}
#: row counts: one lane, the group form's widths, the block form's, and
#: the n = 2^20, 2^24 and K4 (4224 programs) kernels' counts
ROWS = (1, 3, 16, 33, 1024, 1025, 4224, 16384)
#: the widths the wrappers pass: K-lane sums (1-8, 2K), K2's 2, K1's 5,
#: K4's 4 + 6m at m = 6
WIDTHS = (1, 2, 5, 8, 40)


def _partials(shape, dtype: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp(rng.uniform(-3, 3, shape))
    return x.astype(np.float64 if dtype == "float64" else np.float32)


def _j_columns(x: np.ndarray, dtype: str) -> np.ndarray:
    """jnp's obj_reduce of each column (float64 under the wide mode)."""
    vd = jnp.float64 if dtype == "float64" else jnp.float32
    cols = x.reshape(x.shape[0], -1)
    with j_fused.wide_fx(dtype == "wide"):
        return np.array([np.asarray(j_fused.obj_reduce(jnp.asarray(cols[:, j]), vd))
                         for j in range(cols.shape[1])])


def _held(got: torch.Tensor, x: np.ndarray, dtype: str, dim: int) -> None:
    """got (R's sums over axis dim) against jnp per column, per instance."""
    xs = np.moveaxis(x, dim, 0)
    want = _j_columns(xs, dtype).reshape(got.shape)
    scale = np.abs(xs.astype(np.float64)).sum(axis=0).reshape(got.shape)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert np.all(err <= TOL[dtype] * scale), float((err / scale).max())


@pytest.mark.parametrize("dtype", ["float32", "float64", "wide"])
@pytest.mark.parametrize("P", ROWS)
def test_plain_and_order_against_jax(dtype, P):
    wide = dtype == "wide"
    x = _partials((P, 5), dtype, P)
    t = torch.from_numpy(x)
    for fn in (fused.reduce_partials, fused.reduce_partials_order_ref):
        got = fn(t, 0, wide)
        assert got.shape == (5,)
        assert got.dtype == (torch.float64 if wide or dtype == "float64" else torch.float32)
        _held(got, x, dtype, 0)
    xb = _partials((3, min(P, 1025), 4), dtype, P + 1)
    tb = torch.from_numpy(xb)
    for fn in (fused.reduce_partials, fused.reduce_partials_order_ref):
        got = fn(tb, 1, wide)
        assert got.shape == (3, 4)
        _held(got, xb, dtype, 1)


def test_wide_mode_reads_obj_reduce():
    """``obj_reduce`` is R's wide form: float64 sums of float32 partials."""
    x = torch.from_numpy(_partials((1000, 3), "float32", 7))
    assert torch.equal(fused.obj_reduce(x), x.double().sum(dim=0))
    assert torch.equal(fused.obj_reduce(x[:, 0]), x[:, 0].double().sum())
    xb = x.reshape(10, 100, 3)
    assert torch.equal(fused.obj_reduce(xb, dim=1), xb.double().sum(dim=1))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_is_torch_sum_bit_for_bit(dtype):
    """On the CPU every wrapper keeps torch's sums: the plain version is
    ``Tensor.sum`` on each shape and view the wrappers pass."""
    x = torch.from_numpy(_partials((4, 1000, 6), dtype, 11))
    for t, dim in ((x[0], 0), (x[0, :, 0], 0), (x[0, :, :2], 0), (x, 1), (x[:, :, 0], 1),
                   (x[:, :, :2], 1)):
        assert torch.equal(fused.reduce_partials(t, dim), t.sum(dim=dim))


@pytest.mark.parametrize("P", ROWS)
@pytest.mark.parametrize("dtype", ["float32", "float64", "wide"])
def test_order_depends_on_rows_alone(P, dtype):
    """The twin's column j: the same bits at every width, as one instance
    of a batch, and read through a strided view."""
    wide = dtype == "wide"
    col = torch.from_numpy(_partials((P,), dtype, 3 * P))
    want = fused.reduce_partials_order_ref(col, 0, wide)
    for C in WIDTHS + (4 + 6 * 80,):
        rng = np.random.default_rng(C)
        j = int(rng.integers(C))
        x = torch.from_numpy(_partials((P, C), dtype, C))
        x[:, j] = col
        assert torch.equal(fused.reduce_partials_order_ref(x, 0, wide)[j], want), C
        assert torch.equal(fused.reduce_partials_order_ref(x[:, j], 0, wide), want), C
        xb = torch.from_numpy(_partials((3, P, C), dtype, C + 1))
        xb[1, :, j] = col
        assert torch.equal(fused.reduce_partials_order_ref(xb, 1, wide)[1, j], want), C


def test_order_is_lanes_then_pairs():
    """The twin's order written out at P = 2500 (3 rows a lane up to lane
    451, then 2): lane sums from +0 in row order, then pairs at distance
    512, 256, ..., 1."""
    x = torch.from_numpy(_partials((2500,), "float32", 5))
    lanes = torch.zeros(fused.PARTIAL_LANES, dtype=torch.float32)
    for r in range(2500):
        lanes[r % fused.PARTIAL_LANES] += x[r]
    h = fused.PARTIAL_LANES
    while h > 1:
        h //= 2
        lanes = lanes[:h] + lanes[h:2 * h]
    assert torch.equal(fused.reduce_partials_order_ref(x), lanes[0])


def test_partials_views():
    """The (B, P, C, strides) R is launched with, for each form a wrapper
    passes; any other rank or axis raises."""
    x = torch.zeros(4, 10, 3)
    assert fused._partials_view(x[0], 0) == (1, 10, 3, 0, 3, 1, (3,))
    assert fused._partials_view(x[0, :, 0], 0) == (1, 10, 1, 0, 3, 0, ())
    assert fused._partials_view(x[:, :, :2], 1) == (4, 10, 2, 30, 3, 1, (4, 2))
    assert fused._partials_view(x[:, :, 1], 1) == (4, 10, 1, 30, 3, 0, (4,))
    for t, dim in ((x, 0), (x[0, 0], 1), (x.reshape(2, 2, 10, 3), 1)):
        with pytest.raises(ValueError, match="reduce_partials"):
            fused._partials_view(t, dim)


@pytest.mark.parametrize("B,P,C,need", [(1, 16384, 2, 0), (1, 16384, 31, 0), (1, 1024, 484, 0),
                                         (3, 4224, 40, 0), (1, 8192, 32, 1024 * 32),
                                         (2, 16384, 40, 2 * 1024 * 40)])
def test_two_launch_form_scratch(B, P, C, need):
    """R's two-launch form (from 32 columns, more than 1024 rows and 2^18
    values an instance) takes a [B, 1024, C] scratch of lane sums; every
    other shape none."""
    assert fused.partials_scratch(B, P, C) == need


@pytest.mark.parametrize("K", range(1, 3 * factory.SPEC_MAX_LANES + 2))
def test_lane_chunks_cover_the_lanes(K):
    chunks = factory.spec_chunks(K)
    assert [k0 for k0, _ in chunks] == list(range(0, K, factory.SPEC_MAX_LANES))
    assert sum(kc for _, kc in chunks) == K
    assert all(1 <= kc <= factory.SPEC_MAX_LANES for _, kc in chunks)
