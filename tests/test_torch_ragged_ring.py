"""The ring's padded row stride in the PyTorch port, on the CPU.

The solver and the batched runner store each ring as the ``[:, :n]`` view
of a zero-filled ``[m, ld]`` buffer (``[B, m, ld]`` batched), ``ld =
core.ring_stride(n)``: n where it is a multiple of 16, else n rounded up
to one, so that the tensor-core epilogues (K4, K14, K4 b, K14 b) load the
ring in vectors at any n.  Here, at n = 1000 and 1026 (off a multiple of
16), m = 10 and 30, float32 vectors over a bfloat16 ring and float64 over
float64 (the plain versions run on the CPU):

  * the layout helpers, and the kernels' stride rule (``fused.ring_ld``):
    a ring of row stride n or of a padded stride is taken, another refused;
  * whole ``minimize_jit`` runs (plain, OWL-QN, damped, the literal scan
    two-loop, a generic objective's composed pair, a float16 ring): the
    rings keep the padded layout with every pad column exactly zero, and
    each run is the run over contiguous rings bit for bit;
  * against the JAX package: plain, OWL-QN and damped runs pointwise, one
    port step from each of the JAX package's first 15 states
    (``interop.state_from_jax``, whose rings take the padded layout), at
    rel 1e-9 in float64 as ``tests/test_torch_depth.py``; and by outcome
    (iterations, status, fx rel 1e-6 in float64, 1e-4 in float32);
  * ``minimize_batched`` at B = 4 against the JAX package (15 iterations
    in lock-step, fx rel 1e-9) and against the port's solo runs over a
    bfloat16 ring, a resume from the JAX package's batched state, the
    padded [B, m, ld] rings with zero pads;
  * checkpoints: a padded state's round trip is bit for bit (the ``.npz``
    ring arrays stay [m, n]), and a checkpoint written from contiguous
    rings loads into the padded layout;
  * on two gloo ranks a state sharded at a width off 16 (n = 2052, 1026 a
    rank): the ring shards padded for their own width, the run continued
    on the mesh against the run with no mesh (rel 1e-9), pads zero after,
    and ``gather_state`` giving the whole rings back in the padded layout.

The cases marked ``cuda`` hold each redesigned form at n = 2^14 + 2 over
the padded ring to its plain version and to the fold form on a ring of
row stride n (x, g, pg and the ring rows bit for bit); they skip without
a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks

from lbfgs_torch import batched as t_batched
from lbfgs_torch import interop
from lbfgs_torch import solver as tsol
from lbfgs_torch.core import ProblemDef as TDef
from lbfgs_torch.core import as_ring, is_ring, ring_stride, ring_zeros
from lbfgs_torch.minimize import minimize_jit as t_minimize_jit
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import factory
from lbfgs_torch.ops import fused as t_fused
from lbfgs_torch.orthantwise import Orthantwise as TOw
from lbfgs_torch.params import LbfgsParams as TParams
from lbfgs_torch.utils import checkpoint

SIZES, DEPTHS = (1000, 1026), (10, 30)
#: (vector dtype, ring dtype name or None for the vectors')
PAIRS = {"f32-bf16": (torch.float32, "bfloat16"), "f64": (torch.float64, None)}
#: each case's LbfgsParams fields at n (the OWL-QN window [0, n - 1), c = 1)
CASES = {
    "plain": lambda n: dict(constrain_step_size=False),
    "owlqn": lambda n: dict(orthantwise=(1.0, 0, n - 1), constrain_step_size=False,
                            ls=dict(algorithm="BacktrackingArmijo")),
    "damped": lambda n: dict(damping=True),
}
REL, ITERS = 1e-9, 15
FX_REL = {torch.float32: 1e-4, torch.float64: 1e-6}


def _tparams(case: str, n: int, m: int, hd=None, **kw) -> TParams:
    cfg = dict(CASES[case](n), m=m, history_dtype=hd)
    cfg.update(kw)
    ls = cfg.pop("ls", {})
    ow = cfg.pop("orthantwise", None)
    p = TParams(**cfg)
    if ow is not None:
        p = p.replace(orthantwise=TOw(*ow))
    return p.replace_ls(**ls)


def _jparams(case: str, n: int, m: int, hd=None, **kw):
    from lbfgs_tpu.orthantwise import Orthantwise as JOw
    from lbfgs_tpu.params import LbfgsParams as JParams

    cfg = dict(CASES[case](n), m=m, history_dtype=hd)
    cfg.update(kw)
    ls = cfg.pop("ls", {})
    ow = cfg.pop("orthantwise", None)
    p = JParams(**cfg)
    if ow is not None:
        p = p.replace(orthantwise=JOw(*ow))
    return p.replace_ls(**ls)


def _pads(R: torch.Tensor) -> torch.Tensor:
    """The pad columns [n, ld) of every row of a padded ring."""
    *lead, n = R.shape
    ld = R.stride(-2)
    rows = int(np.prod(lead))
    return R.as_strided((rows, ld), (ld, 1), R.storage_offset())[:, n:]


def _padded(R: torch.Tensor) -> bool:
    """R has the padded layout and every pad column is exactly zero."""
    return is_ring(R) and R.stride(-2) == ring_stride(R.shape[-1]) and bool(
        (_pads(R) == 0).all())


def _bits(a, b) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


# ---------------------------------------------------------------------------
# the layout and the kernels' stride rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 15, 16, 1000, 1024, 1026])
def test_ring_layout_helpers(n):
    ld = ring_stride(n)
    assert ld % 16 == 0 and n <= ld < n + 16 and (ld == n) == (n % 16 == 0)
    R = ring_zeros((5, n), torch.bfloat16, "cpu")
    assert R.shape == (5, n) and R.stride() == (ld, 1) and is_ring(R) and _padded(R)
    Rb = ring_zeros((3, 5, n), torch.float64, "cpu")
    assert Rb.stride() == (5 * ld, ld, 1) and is_ring(Rb) and is_ring(Rb[1])
    # a contiguous ring takes the layout through a copy, a padded one stays
    C = torch.arange(5 * n, dtype=torch.float64).reshape(5, n)
    P = as_ring(C)
    assert torch.equal(P, C) and _padded(P) and (P is C) == (n % 16 == 0)
    assert as_ring(P) is P
    # the kernels take the padded ring and a ring of row stride n
    assert t_fused.ring_ld("k", P, as_ring(C.clone())) == ld
    assert t_fused.ring_ld("k", C, C.clone()) == n
    assert t_fused.ring_ld("k", Rb, as_ring(Rb.clone())) == ld


@pytest.mark.parametrize("bad", ["stride", "wider", "storage", "mixed", "instances"])
def test_ring_stride_rule_refuses(bad):
    n, m = 1026, 4
    S = ring_zeros((m, n), torch.float32, "cpu")
    if bad == "stride":  # a stride neither n nor a multiple of 16
        R = torch.zeros(m, n + 4)[:, :n]
        args = (R, R)
    elif bad == "wider":  # a multiple of 16 past ring_stride(n): a view of a wider buffer
        R = torch.randn(m, 1056)[:, :n]
        args = (R, R)
    elif bad == "storage":  # the last row's pad not held by the storage
        R = torch.zeros(m * ring_stride(n) - 8).as_strided((m, n), (ring_stride(n), 1))
        args = (R, R)
    elif bad == "mixed":  # S and Y of different strides
        args = (S, torch.zeros(m, n))
    else:  # instances not m*ld apart
        R = torch.zeros(2, m + 1, ring_stride(n))[:, :m, :n]
        args = (R, R)
    with pytest.raises(ValueError, match="row stride"):
        t_fused.ring_ld("k", *args)


def test_grids_take_the_tensor_core_forms_over_the_padded_ring():
    """At an n off 16 the epilogues' form follows the ring's stride: the
    padded ring (the grids' default) the tensor-core forms, a ring of row
    stride n the fold forms."""
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    for n in ((1 << 20) + 2, (1 << 14) + 2, 1000):
        assert factory.solo_epilogue_grid(n, 80, f32, bf16).form == "mma"
        assert factory.solo_epilogue_grid(n, 80, f32, f32).form == "mma_rows"
        assert factory.solo_epilogue_grid(n, 80, f64, f64).form == "mma_rows"
        assert factory.solo_epilogue_grid(n, 260, f32, bf16).form == "mma_rows"
        assert factory.batched_epilogue_grid(1024, n, 80, f64, f64).form == "mma_rows"
        for pair in ((f32, bf16), (f32, f32), (f64, f64)):
            assert factory.solo_epilogue_grid(n, 80, *pair, ld=n).form == "deep"
            assert factory.batched_epilogue_grid(4, n, 80, *pair, ld=n).form == "deep"
        # the batched f32 row-block form over a padded ring takes a launch of
        # its own (the aligned one spills there), the solo form the aligned one
        padded = factory.batched_epilogue_grid(1024, n, 80, f32, f32)
        aligned = factory.batched_epilogue_grid(1024, n - n % 16, 80, f32, f32)
        assert padded.form == aligned.form == "mma_rows"
        want = factory.MMA_ROWS_EPILOGUE[(f32, f32)][64]["batched_padded"]
        assert padded.consts["K"] == want["K"] != aligned.consts["K"]
        assert padded.launch == dict(num_warps=want["num_warps"], num_stages=want["num_stages"])
        assert factory.solo_epilogue_grid(n, 80, f32, f32).consts == \
            factory.solo_epilogue_grid(n - n % 16, 80, f32, f32).consts
        assert factory.batched_epilogue_grid(4, n, 80, f64, f64).consts == \
            factory.batched_epilogue_grid(4, n - n % 16, 80, f64, f64).consts
        # the depths the fold forms still own
        assert factory.solo_epilogue_grid(n, 20, f32, f32).form == "deep"
        assert factory.batched_epilogue_grid(4, n, 31, f32, f32).form == "deep"
        assert factory.solo_epilogue_grid(n, 10, f64, f64).form == "deep"


# ---------------------------------------------------------------------------
# whole port runs: the layout kept, the results those over contiguous rings
# ---------------------------------------------------------------------------


def _generic():
    return t_rosen._plain_value_and_grad


#: the port's run variants beyond CASES: the literal scan two-loop, a
#: generic objective (the composed ``update_pair``), a float16 ring
VARIANTS = {**{c: {} for c in CASES}, "scan": dict(compact_two_loop=False),
            "generic": {}, "float16": {}}


def _port_run(variant, n, m, pair, contiguous=False, monkeypatch=None):
    vd, hd = PAIRS[pair]
    case = variant if variant in CASES else "plain"
    hd = "float16" if variant == "float16" else hd
    p = _tparams(case, n, m, hd, max_iterations=30, **VARIANTS[variant])
    fn = _generic() if variant == "generic" else t_rosen.value_and_grad
    if contiguous:
        monkeypatch.setattr(tsol, "ring_zeros",
                            lambda shape, dtype, device: torch.zeros(shape, dtype=dtype,
                                                                     device=device))
    try:
        return t_minimize_jit(p, t_rosen.initial_point(n, vd, "cpu"), fn, return_state=True)
    finally:
        if contiguous:
            monkeypatch.undo()


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("m", DEPTHS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_port_run_keeps_the_padded_ring(variant, n, m, pair, monkeypatch):
    if variant == "float16" and pair == "f64":
        pytest.skip("a float16 ring is taken with float32 vectors only")
    st = _port_run(variant, n, m, pair)
    assert st.k > 5
    for R in (st.hist.s, st.hist.y):
        assert R.shape == (m, n) and R.stride() == (ring_stride(n), 1)
        assert _padded(R)
    ref = _port_run(variant, n, m, pair, contiguous=True, monkeypatch=monkeypatch)
    assert ref.hist.s.is_contiguous()
    assert (st.k, st.prob.neval, st.status) == (ref.k, ref.prob.neval, ref.status)
    assert st.prob.fx == ref.prob.fx
    for a, b in ((st.prob.x, ref.prob.x), (st.prob.gx, ref.prob.gx), (st.hist.s, ref.hist.s),
                 (st.hist.y, ref.hist.y), (st.hist.sy, ref.hist.sy)):
        assert _bits(a, b)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


#: (pair, n, m) of the runs held to the JAX package by outcome
OUTCOME = [("f64", 1026, 30), ("f64", 1000, 10), ("f32-bf16", 1000, 10)]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("pair,n,m", OUTCOME, ids=lambda v: str(v))
def test_run_matches_jax_by_outcome(case, pair, n, m):
    """float64 to convergence: the same iterations and status, fx rel 1e-6;
    float32 over a bfloat16 ring, whose whole runs end on rounding that the
    two packages' sums meet at different iterations, as
    ``tests/test_torch_slice.py`` holds it: 8 iterations at epsilon 0 with
    the capped step, fx rel 1e-4 and ||g|| rel 1e-2."""
    from lbfgs_tpu.minimize import minimize_jit as j_minimize_jit
    from lbfgs_tpu.models import rosenbrock as j_rosen

    vd, hd = PAIRS[pair]
    run = dict(max_iterations=200) if vd == torch.float64 else dict(
        max_iterations=8, epsilon=0.0, constrain_step_size=True)
    t = t_minimize_jit(_tparams(case, n, m, hd, **run), t_rosen.initial_point(n, vd, "cpu"),
                       t_rosen.value_and_grad, return_state=True)
    assert all(_padded(R) for R in (t.hist.s, t.hist.y))
    x0 = j_rosen.initial_point(n).astype(np.float32 if vd == torch.float32 else np.float64)
    j = j_minimize_jit(_jparams(case, n, m, hd, **run), x0, j_rosen.value_and_grad)
    assert (t.k, int(t.status)) == (j.niter, int(j.status))
    assert float(t.prob.fx) == pytest.approx(float(j.fx), rel=FX_REL[vd], abs=1e-12)
    if vd == torch.float32:
        assert float(np.sqrt(t.prob.gnorm2)) == pytest.approx(float(j.gnorm), rel=1e-2)


@pytest.fixture(scope="module")
def jax_states():
    """The JAX package's states 0-15 of each case at n = 1026, m = 30,
    float64."""
    import jax

    from lbfgs_tpu import solver as jsol
    from lbfgs_tpu.core import ProblemDef as JDef
    from lbfgs_tpu.models import rosenbrock as j_rosen

    out = {}
    for case in CASES:
        params = _jparams(case, 1026, 30)
        pdef = JDef(value_and_grad=j_rosen.value_and_grad, owlqn=params.orthantwise)
        step = jax.jit(lambda st, pdef=pdef, params=params: jsol.propagate_hot(pdef, params, st))
        st = jsol.start_state(jsol.init_state(pdef, params, j_rosen.initial_point(1026)),
                              params)
        states = [jax.tree.map(np.asarray, st)]
        for _ in range(ITERS):
            st = step(st)
            states.append(jax.tree.map(np.asarray, st))
        out[case] = states
    return out


def _close(t, j, what):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    j = np.asarray(j, np.float64).reshape(t.shape)
    scale = max(np.abs(j).max(), 1e-300)
    np.testing.assert_allclose(t, j, rtol=REL, atol=REL * scale, err_msg=what)


@pytest.mark.parametrize("k", range(1, ITERS + 1))
@pytest.mark.parametrize("case", list(CASES))
def test_step_from_jax_state_matches_jax(jax_states, case, k):
    """One port step from the JAX package's state of iteration k - 1 (its
    rings taken into the padded layout) against its next state."""
    params = _tparams(case, 1026, 30)
    pdef = TDef(value_and_grad=t_rosen.value_and_grad, owlqn=params.orthantwise)
    st = interop.state_from_jax(jax_states[case][k - 1], "cpu")
    assert all(_padded(R) for R in (st.hist.s, st.hist.y))
    out = tsol.propagate_hot(pdef, params, st)
    ref = jax_states[case][k]
    assert out.status == int(ref.status) == 0
    assert (out.k, out.end, out.prob.neval) == (int(ref.k), int(ref.end), int(ref.prob.neval))
    assert all(_padded(R) for R in (out.hist.s, out.hist.y))
    for name in ("x", "gx", "d"):
        _close(getattr(out.prob, name), getattr(ref.prob, name), name)
    for name in ("fx", "gnorm2", "xnorm2"):
        _close(getattr(out.prob, name), getattr(ref.prob, name), name)
    for name in ("s", "y", "ys", "alpha", "sy", "yy"):
        _close(getattr(out.hist, name), getattr(ref.hist, name), name)


# ---------------------------------------------------------------------------
# the batched runner
# ---------------------------------------------------------------------------


def _x0b(n, B=4, dtype=np.float64):
    from lbfgs_tpu.models import rosenbrock as j_rosen

    rng = np.random.RandomState(27)
    base = np.asarray(j_rosen.initial_point(n), np.float64)
    return (base[None, :] + 0.1 * rng.randn(B, n)).astype(dtype)


@pytest.mark.parametrize("case", ["plain", "owlqn"])
@pytest.mark.parametrize("n", SIZES)
def test_batched_matches_jax(case, n):
    import jax.numpy as jnp

    from lbfgs_tpu.batched import minimize_batched as j_minimize_batched
    from lbfgs_tpu.models import rosenbrock as j_rosen

    x0b = _x0b(n)
    t = t_batched.minimize_batched(_tparams(case, n, 10, max_iterations=ITERS),
                                   torch.from_numpy(x0b), t_rosen.value_and_grad,
                                   return_state=True)
    assert t.hist.s.stride() == (10 * ring_stride(n), ring_stride(n), 1)
    assert all(_padded(R) for R in (t.hist.s, t.hist.y))
    j = j_minimize_batched(_jparams(case, n, 10, max_iterations=ITERS), jnp.asarray(x0b),
                           j_rosen.value_and_grad)
    assert np.array_equal(t.k, np.asarray(j["niter"]))
    assert np.array_equal(t.status, np.asarray(j["status"]))
    assert np.array_equal(t.neval, np.asarray(j["neval"]))
    np.testing.assert_allclose(t.fx, np.asarray(j["fx"]), rtol=REL, atol=0)


def test_batched_f32_bf16_matches_port_solo():
    """f32 vectors over a bf16 ring at n = 1026, m = 30: each instance the
    port's solo run's iterations and evaluations, fx rel 1e-3 (the batched
    sums add in their own order), the rings padded with zero pads."""
    n, m = 1026, 30
    x0b = torch.from_numpy(_x0b(n, dtype=np.float32))
    p = TParams(m=m, max_iterations=9, epsilon=0.0, history_dtype="bfloat16",
                constrain_step_size=False)
    st = t_batched.minimize_batched(p, x0b, t_rosen.value_and_grad, return_state=True)
    assert st.hist.s.dtype == torch.bfloat16
    assert all(_padded(R) for R in (st.hist.s, st.hist.y))
    for b in range(x0b.shape[0]):
        solo = t_minimize_jit(p, x0b[b].clone(), t_rosen.value_and_grad, return_state=True)
        assert (solo.k, solo.prob.neval) == (int(st.k[b]), int(st.neval[b]))
        assert float(st.fx[b]) == pytest.approx(float(solo.prob.fx), rel=1e-3)


def test_resume_from_jax_batched_state():
    """Eight iterations in the JAX package at n = 1026, seven more in the
    port from its state (``interop.batched_state_from_jax``, the rings
    taken into the padded layout), against fifteen in JAX."""
    import jax.numpy as jnp

    from lbfgs_tpu import lbfgs as j_lbfgs
    from lbfgs_tpu.models import rosenbrock as j_rosen

    n = 1026
    x0b = _x0b(n)
    j8 = j_lbfgs().with_max_iterations(8).minimize_batched(
        jnp.asarray(x0b), j_rosen.value_and_grad, return_state=True)
    st = interop.batched_state_from_jax(j8, "cpu")
    assert all(_padded(R) for R in (st.hist.s, st.hist.y))
    st = st._replace(status=np.zeros(x0b.shape[0], np.int64))
    t15 = t_batched.run(TParams(max_iterations=15), t_rosen.value_and_grad, st)
    j15 = j_lbfgs().with_max_iterations(15).minimize_batched(
        jnp.asarray(x0b), j_rosen.value_and_grad, return_state=True)
    assert np.array_equal(t15.k, np.asarray(j15.k))
    assert np.array_equal(t15.neval, np.asarray(j15.prob.neval))
    np.testing.assert_allclose(t15.fx, np.asarray(j15.prob.fx), rtol=REL)
    np.testing.assert_allclose(t15.x.numpy(), np.asarray(j15.prob.x), rtol=0, atol=1e-9)
    assert all(_padded(R) for R in (t15.hist.s, t15.hist.y))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _state(pair, n=1026, m=10, iters=12):
    vd, hd = PAIRS[pair]
    p = _tparams("plain", n, m, hd, max_iterations=iters)
    return p, t_minimize_jit(p, t_rosen.initial_point(n, vd, "cpu"), t_rosen.value_and_grad,
                             return_state=True)


def _template(p, pair, n=1026):
    vd = PAIRS[pair][0]
    pdef = TDef(value_and_grad=t_rosen.value_and_grad)
    return tsol.init_state(pdef, p, t_rosen.initial_point(n, vd, "cpu"), lean=True)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_checkpoint_round_trip_is_bit_for_bit(tmp_path, pair):
    p, st = _state(pair)
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, st)
    with np.load(path) as f:
        assert f["hist.s"].shape == f["hist.y"].shape == (10, 1026)
    back = checkpoint.load_state(path, _template(p, pair))
    assert all(_padded(R) for R in (back.hist.s, back.hist.y))
    for (ka, a), (kb, b) in zip(checkpoint.fields(st), checkpoint.fields(back)):
        assert ka == kb
        if isinstance(a, torch.Tensor):
            assert _bits(a, b), ka
        else:
            assert (a is None and b is None) or np.array_equal(np.asarray(a), np.asarray(b)), ka


@pytest.mark.parametrize("pair", list(PAIRS))
def test_checkpoint_from_contiguous_rings_loads(tmp_path, pair):
    """A checkpoint written from rings of row stride n (as before the
    padded layout) loads, into the padded layout, with the same values."""
    p, st = _state(pair)
    flat = st._replace(hist=st.hist._replace(s=st.hist.s.contiguous(),
                                             y=st.hist.y.contiguous()))
    assert flat.hist.s.stride() == (1026, 1)
    path = str(tmp_path / "flat.npz")
    checkpoint.save_state(path, flat)
    back = checkpoint.load_state(path, _template(p, pair))
    assert all(_padded(R) for R in (back.hist.s, back.hist.y))
    assert _bits(back.hist.s, st.hist.s) and _bits(back.hist.y, st.hist.y)
    assert _bits(back.prob.x, st.prob.x)


# ---------------------------------------------------------------------------
# a ring sharded at a width off 16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ragged_mesh(tmp_path_factory):
    d = tmp_path_factory.mktemp("ragged_w2")
    res = ranks.launch("ragged", 2, d, dict(n=2052, at=5, iters=15,
                                            params=dict(m=10, constrain_step_size=False)),
                       timeout=180)
    return res, np.load(d / "x.npy"), np.load(d / "x_solo.npy")


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_state_pads_each_ring_shard(ragged_mesh, rank):
    r = ragged_mesh[0][rank]
    assert r["k_local"] == 1026 and r["want_stride"] == 1040
    assert r["stride"] == [[1040, 1], [1040, 1]]
    assert r["layout"] and r["pads_zero"] and r["values"]
    assert r["layout_after"] and r["pads_zero_after"]


@pytest.mark.parametrize("rank", [0, 1])
def test_gather_state_gives_the_padded_ring(ragged_mesh, rank):
    r = ragged_mesh[0][rank]
    assert r["gathered_stride"] == [[2064, 1], [2064, 1]]
    assert r["gathered_layout"] and r["gathered_values"]


def test_sharded_ragged_run_matches_the_run_with_no_mesh(ragged_mesh):
    res, x, x_solo = ragged_mesh
    for r in res:
        got, solo = r["run"], r["solo"]
        assert (got["k"], got["neval"], got["status"]) == (solo["k"], solo["neval"],
                                                           solo["status"])
        assert got["fx"] == pytest.approx(solo["fx"], rel=REL)
    assert len({r["run"]["x_sha"] for r in res}) == 1
    np.testing.assert_allclose(x, x_solo, rtol=REL, atol=1e-12)


# ---------------------------------------------------------------------------
# on the card: the redesigned forms at an n off 16
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


#: (vector dtype, ring dtype, m) of the card cases: the row-block form over
#: f32 and f64 rings, the one-pass tensor-core form over a bf16 ring at 80
#: rows and the row-block form above 256
CARD = [(torch.float32, torch.float32, 80), (torch.float64, torch.float64, 80),
        (torch.float32, torch.bfloat16, 80), (torch.float32, torch.bfloat16, 260)]
STP, C = 0.37, 0.7


def _card_inputs(dev, vd, hd, m, n, B=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + m + n)
    lead = () if B is None else (B,)
    r = lambda *s: torch.randn(*lead, *s, generator=g, device=dev, dtype=torch.float64)
    xp = (t_rosen.initial_point(n, torch.float64, dev) + 0.1 * r(n)).to(vd)
    return dict(xp=xp, d=(0.1 * r(n)).to(vd), gp=r(n).to(vd), pg=r(n).to(vd),
                S=as_ring((0.1 * r(m, n)).to(hd)), Y=as_ring((0.1 * r(m, n)).to(hd)),
                end=m - 3, window=(5, n - 7))


def _k(kernels, ow, batched, ref=False):
    name = ("owlqn_" if ow else "") + "trial_pair_gram" + ("_batched" if batched else "")
    return getattr(kernels, name + ("_ref" if ref else ""))


def _call(fn, a, ow, R, stp, live=None, with_gp=True):
    """fn on copies of a's vectors and the rings R; (the copies, outputs)."""
    t = {k: a[k].clone() for k in ("xp", "gp", "pg")}
    S, Y = R
    lo, hi = a["window"]
    if live is None:
        if ow:
            out = fn(t["xp"], a["d"], t["gp"], t["pg"], stp, C, lo, hi, S, Y, a["end"],
                     inplace=True, with_gp=with_gp)
        else:
            out = fn(t["xp"], a["d"], t["gp"], stp, S, Y, a["end"], inplace=True,
                     with_gp=with_gp)
    elif ow:
        out = fn(t["xp"], a["d"], t["gp"], t["pg"], stp, C, lo, hi, S, Y, a["end"], live,
                 with_gp=with_gp)
    else:
        out = fn(t["xp"], a["d"], t["gp"], stp, S, Y, a["end"], live, with_gp=with_gp)
    return t, out


def _normwise(u, v):
    return float((u.double() - v.double()).abs().max() / max(float(v.double().abs().max()),
                                                             1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True], ids=["solo", "batched"])
@pytest.mark.parametrize("ow", [False, True], ids=["K4", "K14"])
@pytest.mark.parametrize("vd,hd,m", CARD, ids=str)
def test_ragged_forms_on_card(cuda, vd, hd, m, ow, batched):
    n = (1 << 14) + 2
    B = 6 if batched else None
    a = _card_inputs(cuda, vd, hd, m, n, B)
    k = t_rosen.value_and_grad.kernels
    fn = _k(k, ow, batched)
    live = None
    stp = STP
    if batched:
        live = torch.ones(B, dtype=torch.bool, device=cuda)
        live[1::3] = False
        stp = torch.full((B,), STP, dtype=vd, device=cuda)
    want = "mma" if hd == torch.bfloat16 and m <= factory.MMA_MAX_M else "mma_rows"
    ring = lambda: (as_ring(a["S"].clone()), as_ring(a["Y"].clone()))
    Rk = ring()
    tk, ok = _call(fn, a, ow, Rk, stp, live)
    assert fn.last_form.form == want and fn.last_form.compiled.n_spills == 0
    assert all(_padded(R) for R in Rk)
    # the plain version: vectors and sums normwise, the rings bit for bit
    tv, ts = (1e-5, 1e-4) if vd == torch.float32 else (1e-12, 1e-10)
    Rp = (a["S"].clone(), a["Y"].clone())
    tp, op = _call(_k(k, ow, batched, ref=True), a, ow, Rp, stp, live)
    sel = (lambda v: v[live]) if batched else (lambda v: v)
    assert all(torch.equal(sel(u), sel(v)) for u, v in zip(Rk, Rp))
    for name in ("xp", "gp") + (("pg",) if ow else ()):
        assert _normwise(sel(tk[name]), sel(tp[name])) <= tv, name
    for u, v in zip(ok, op):
        if isinstance(u, torch.Tensor) and u.dtype.is_floating_point:
            assert _normwise(sel(u), sel(v)) <= ts
    # the fold form over a ring of row stride n: x, g, pg and rings bit for bit
    Rf = (a["S"].clone().contiguous(), a["Y"].clone().contiguous())
    tf, of = _call(fn, a, ow, Rf, stp, live)
    assert fn.last_form.form == "deep"
    assert all(torch.equal(u, v) for u, v in zip(Rk, Rf))
    for name in ("xp", "gp") + (("pg",) if ow else ()):
        assert torch.equal(tk[name], tf[name]), name
