"""The batched epilogues K4 b and K14 b in the tensor-core row-block form
(``factory.batched_epilogue_grid``'s ``"mma_rows"``: f32 and f64 rings
from ``factory.MMA_ROWS_MIN_M`` rows, bf16 rings above
``factory.MMA_MAX_M``), on the CPU where their plain versions run:

  * the launch geometry as pure Python: each element of each instance in
    exactly one (program, chunk) of its own instance, at most
    ``factory.MMA_MAX_CHUNKS`` chunks a program, each ring row in exactly
    one block of RP rows (the last block RT rows) and row ``end`` in
    exactly one, so every (row, element) product is taken once and the
    point is stored once, by the last pass;
  * the plain K4 b and K14 b, with and without the . gp column, over f32
    and f64 rings at m = 80 and over a bf16 ring at m = 260 (B = 3, n =
    256, inputs from a numpy seed, instance 1 frozen) against the JAX
    package's plain versions vmapped over the batch (``jax.vmap`` of
    ``trial_ref`` with ``pair_gram_sd_ref``, and of
    ``owlqn_trial_pair_gram_ref``), the forms its solver runs on the CPU:
    f64 vectors rel 1e-12 and sums rel 1e-10, f32 vectors 1e-5 and sums
    1e-4 normwise (XLA contracts the float32 multiply-adds), the ring rows
    bit for bit, the frozen instance untouched.  The JAX oracles take the
    products of row ``end`` over the ring as stored, which over a bf16
    ring is the pair rounded; the kernels (the JAX package's Pallas ones
    and the port's) take the unrounded pair there, so the bf16 ring's
    products are held to the oracles over the ring widened to float32
    (exact), and its rows to the oracles over the bf16 ring.

The cases marked ``cuda`` hold the card's row-block form (forced at
shallow depths the routing gives to the fold forms) at 1024 x 2^14's
layout on 24 instances, a third frozen, to its plain version (vectors
1e-5 / 1e-12, sums 1e-4 / 1e-10 normwise in f32 / f64), to the deep fold
form on the same inputs (x, g, pg, the rings and the flags bit for bit),
to the solo K4 and K14 on each live instance (x, g, pg and the rings bit
for bit) and the . gp launch's other outputs to the 3-column launch's
(bit for bit), with no spill, at n = 2^14 and 2^14 + 2 (the runner's
ring padded to a multiple of 16 there); the products against the float64 product of their own
operands at 2, 32 and 64 chunks a program (3e-7 with f32 vectors, 2e-15
with f64); and an inf in gp to non-finite products.  They skip without a
card.  This module imports JAX only inside the tests that compare with
it, so the card's cases run without it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbfgs_torch.core import as_ring
from lbfgs_torch.models import rosenbrock as t_rosen
from lbfgs_torch.ops import factory

K = t_rosen.value_and_grad.kernels
F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64
C = 0.7


# ---------------------------------------------------------------------------
# the launch geometry
# ---------------------------------------------------------------------------

#: (vector dtype, ring dtype, m): each pair from the row-block form's first
#: depth to several blocks
ROWS_SETTINGS = ([(F32, F32, m) for m in (factory.rows_min_m((F32, F32), True), 80, 200)]
                 + [(F64, F64, m) for m in (factory.rows_min_m((F64, F64), True), 80, 200)]
                 + [(F32, BF16, m) for m in (257, 260, 512)])
#: (B, n): the batched main path's shape, a small batch, one above
#: ``factory.EPILOGUE_PROGRAMS`` instances, and wide instances
ROWS_SHAPES = [(1024, 1 << 14), (3, 256), (17, 4096), (4225, 640), (4, 1 << 20)]


def _ids(v):
    return str(v).removeprefix("torch.")


@pytest.mark.parametrize("vd,hd,m", ROWS_SETTINGS, ids=_ids)
@pytest.mark.parametrize("B,n", ROWS_SHAPES, ids=_ids)
def test_batched_rows_grid_covers_every_element_and_row_once(vd, hd, m, B, n):
    g = factory.batched_epilogue_grid(B, n, m, vd, hd)
    assert g.form == "mma_rows"
    assert g.total == B * g.programs
    assert g.tiles <= factory.MMA_MAX_CHUNKS
    # program (p, b) takes chunks p*tiles .. p*tiles + tiles - 1 of K
    # elements of instance b, at b*n + the chunk's offsets, masked at n:
    # the same layout in every instance, so one instance's coverage is each
    # one's, and no program reaches into another instance
    covered = np.zeros(g.programs * g.tiles * g.T, np.int64)
    for p in range(g.programs):
        lo = p * g.tiles * g.T
        hi = lo + g.tiles * g.T
        assert lo < n  # no program lies wholly past its instance
        covered[lo:hi] += 1
        assert 0 <= min(hi, n) - lo <= g.tiles * g.T
    assert np.all(covered[:n] == 1)
    assert g.ntiles == -(-n // g.T)
    assert (g.programs - 1) * g.tiles < g.ntiles <= g.programs * g.tiles
    # as few chunks a program as the batch-wide cap allows, at most
    # MMA_MAX_CHUNKS
    per = max(1, factory.EPILOGUE_PROGRAMS // B)
    assert g.tiles == min(-(-g.ntiles // per), factory.MMA_MAX_CHUNKS)
    # the ring rows: cdiv(m - RT, RP) blocks of RP rows, then one of RT,
    # RP the batched launch's (m rounded up, at most the largest block the
    # pair's table gives the batched kernels)
    rp, rt = g.consts["RP"], g.consts["RT"]
    top = max(r for r, c in factory.MMA_ROWS_EPILOGUE[(vd, hd)].items() if c.get("batched", c))
    assert rp == min(max(16, 1 << (m - 1).bit_length()), top)
    assert factory.rows_launch((vd, hd), m, True)[0] == rp
    full = -(-(m - rt) // rp)
    blocks = [(j * rp, rp) for j in range(full)] + [(full * rp, rt)]
    rows = np.zeros(full * rp + rt, np.int64)
    for j0, r in blocks:
        rows[j0:j0 + r] += 1
    assert np.all(rows[:m] == 1)
    # row `end` lies in exactly one block, which stores the new pair
    for end in (0, m // 2, m - 3, m - 1):
        assert sum(j0 <= end < j0 + r for j0, r in blocks) == 1
    cfg = factory.rows_launch((vd, hd), m, True)[1]
    assert g.T == g.consts["K"] == cfg["K"]
    assert g.launch == dict(num_warps=cfg["num_warps"], num_stages=cfg["num_stages"])


# ---------------------------------------------------------------------------
# the plain K4 b and K14 b against the JAX package's plain versions
# ---------------------------------------------------------------------------

B_JAX, N_JAX = 3, 256
LIVE = np.array([True, False, True])
LO, HI = 5, N_JAX - 9
#: (vector dtype, ring dtype, m) of the JAX comparisons: the chip's settings
JAX_SETTINGS = [(np.float32, "float32", 80), (np.float64, "float64", 80),
                (np.float32, "bfloat16", 260)]


def _ring_np(a, dt: str):
    """A ring drawn in float64 as the ring dtype's values, in float32 (a
    bf16 ring's values are exact there) or float64."""
    t = torch.from_numpy(a).to(getattr(torch, dt))
    return t.to(torch.float64 if dt == "float64" else torch.float32).numpy()


@pytest.fixture(scope="module", params=JAX_SETTINGS, ids=lambda s: f"{s[1]}-m{s[2]}")
def batch(request):
    vd, hd, m = request.param
    rng = np.random.default_rng(m + (hd == "float64"))
    B, n = B_JAX, N_JAX
    xp = np.where(np.arange(n) % 2 == 0, -1.2, 1.0) + 0.1 * rng.standard_normal((B, n))
    xp[:, ::9] = 0.0
    return dict(vd=vd, hd=hd, m=m, end=m - 3, xp=xp.astype(vd),
                d=(0.3 * rng.standard_normal((B, n))).astype(vd),
                gp=rng.standard_normal((B, n)).astype(vd),
                pg=rng.standard_normal((B, n)).astype(vd),
                S=_ring_np(0.1 * rng.standard_normal((B, m, n)), hd),
                Y=_ring_np(0.1 * rng.standard_normal((B, m, n)), hd),
                stp=(0.2 + rng.random(B)).astype(vd))


@pytest.fixture(scope="module")
def jax_side():
    jax = pytest.importorskip("jax")
    from lbfgs_tpu.models import rosenbrock as j_rosen
    from lbfgs_tpu.ops import fused as j_fused
    return jax, j_rosen, j_fused


def _torch_in(a):
    hd = getattr(torch, a["hd"])
    t = {k: torch.from_numpy(a[k].copy()) for k in ("xp", "d", "gp", "pg", "stp")}
    t["S"], t["Y"] = (torch.from_numpy(a[k]).to(hd) for k in ("S", "Y"))
    return t


def _jax_ring(jax, a, k, widened):
    """The inputs' ring as the JAX oracles take it: in its own dtype, or
    widened to the vectors' (the kernels' products over a bf16 ring)."""
    v = jax.numpy.asarray(a[k])
    return v if widened or a["hd"] != "bfloat16" else v.astype(jax.numpy.bfloat16)


def _check(t, j, vd, tol32, tol64, what):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    j = np.asarray(j, np.float64).reshape(t.shape)
    if vd == np.float64:
        np.testing.assert_allclose(t, j, rtol=tol64, atol=tol64 * np.abs(j).max(),
                                   err_msg=what)
    else:
        err = np.abs(t - j).max() / max(np.abs(j).max(), 1e-300)
        assert err <= tol32, f"{what}: normwise {err:.3e} above {tol32:.0e}"


def _rings_bits(a, St, Yt, jS, jY):
    """The kernels' rings against the oracles' ring write: the live
    instances' rows bit for bit, the frozen instance's untouched."""
    for t, j, k in ((St, jS, "S"), (Yt, jY, "Y")):
        t = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        j = np.asarray(j.astype("float32") if a["hd"] == "bfloat16" else j)
        assert np.array_equal(t[LIVE], j[LIVE]), k
        assert np.array_equal(t[~LIVE], a[k][~LIVE]), k


@pytest.mark.parametrize("with_gp", [False, True], ids=["3col", "gp"])
def test_k4b_rows_plain_matches_jax(batch, jax_side, with_gp):
    jax, j_rosen, j_fused = jax_side
    a, end, vd = batch, batch["end"], batch["vd"]
    t = _torch_in(a)
    gd, gg, xx, changed, SP, YP = K.trial_pair_gram_batched(
        t["xp"], t["d"], t["gp"], t["stp"], t["S"], t["Y"], end, torch.from_numpy(LIVE),
        with_gp=with_gp)
    assert SP.shape == YP.shape == (B_JAX, a["m"], 4 if with_gp else 3)
    jnp = jax.numpy
    jx, _jfx, jg, jgd, jgg, jxx, jch = jax.vmap(j_rosen.trial_ref)(
        jnp.asarray(a["xp"]), jnp.asarray(a["d"]), jnp.asarray(a["stp"]))

    def pair(widened):
        return jax.vmap(lambda stp, d, g, gp, S, Y: j_fused.pair_gram_sd_ref(
            stp, d, g, gp, S, Y, end, with_gp=with_gp))(
            jnp.asarray(a["stp"]), jnp.asarray(a["d"]), jg, jnp.asarray(a["gp"]),
            _jax_ring(jax, a, "S", widened), _jax_ring(jax, a, "Y", widened))

    _, _, jSP, jYP = pair(True)
    js, jy, _, _ = pair(False)
    S_w = np.asarray(_jax_ring(jax, a, "S", False)).copy()
    Y_w = np.asarray(_jax_ring(jax, a, "Y", False)).copy()
    S_w[:, end], Y_w[:, end] = np.asarray(js).astype(S_w.dtype), np.asarray(jy).astype(Y_w.dtype)
    _rings_bits(a, t["S"], t["Y"], S_w, Y_w)
    live = torch.from_numpy(LIVE)
    assert np.array_equal(t["xp"][~live].numpy(), a["xp"][~LIVE])
    assert np.array_equal(t["gp"][~live].numpy(), a["gp"][~LIVE])
    _check(t["xp"][live], np.asarray(jx)[LIVE], vd, 1e-5, 1e-12, "x")
    _check(t["gp"][live], np.asarray(jg)[LIVE], vd, 1e-5, 1e-12, "g")
    for u, j, what in ((gd, jgd, "g.d"), (gg, jgg, "g.g"), (xx, jxx, "x.x"), (SP, jSP, "SP"),
                       (YP, jYP, "YP")):
        _check(u[live], np.asarray(j)[LIVE], vd, 1e-4, 1e-10, what)
    assert np.array_equal(changed[live].numpy(), np.asarray(jch)[LIVE])


@pytest.mark.parametrize("with_gp", [False, True], ids=["3col", "gp"])
def test_k14b_rows_plain_matches_jax(batch, jax_side, with_gp):
    jax, j_rosen = jax_side[:2]
    a, end, vd = batch, batch["end"], batch["vd"]
    t = _torch_in(a)
    out = K.owlqn_trial_pair_gram_batched(t["xp"], t["d"], t["gp"], t["pg"], t["stp"], C, LO,
                                          HI, t["S"], t["Y"], end, torch.from_numpy(LIVE),
                                          with_gp=with_gp)
    xx, pp, changed, SP, YP = out[:5]
    jnp = jax.numpy

    def ref(widened):
        return jax.vmap(lambda xp, d, gp, pg, stp, S, Y: j_rosen.owlqn_trial_pair_gram_ref(
            xp, d, gp, pg, stp, C, LO, HI, S, Y, end, with_gp=with_gp))(
            *(jnp.asarray(a[k]) for k in ("xp", "d", "gp", "pg", "stp")),
            _jax_ring(jax, a, "S", widened), _jax_ring(jax, a, "Y", widened))

    j = ref(True)
    jx, jg, jpg, _, _, jSP, jYP, jxx, jpp, jch = j[:10]
    jS, jY = ref(False)[3:5]
    _rings_bits(a, t["S"], t["Y"], jS, jY)
    live = torch.from_numpy(LIVE)
    for k, jv in (("xp", jx), ("gp", jg), ("pg", jpg)):
        assert np.array_equal(t[k][~live].numpy(), a[k][~LIVE])
        _check(t[k][live], np.asarray(jv)[LIVE], vd, 1e-5, 1e-12, k)
    for u, jv, what in ((SP, jSP, "SP"), (YP, jYP, "YP"), (xx, jxx, "x.x"), (pp, jpp, "pg.pg")):
        _check(u[live], np.asarray(jv)[LIVE], vd, 1e-4, 1e-10, what)
    if with_gp:
        _check(out[5][live], np.asarray(j[10])[LIVE], vd, 1e-4, 1e-10, "gp.gp")
        _check(out[6][live], np.asarray(j[11])[LIVE], vd, 1e-4, 1e-10, "gp.pg")
    assert np.array_equal(changed[live].numpy(), np.asarray(jch)[LIVE])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


NAMES = ("xp", "gp", "pg", "S", "Y")


def _card_batch(dev, vd, hd, m, n, Bk=24, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + m + n)
    r = lambda *s: torch.randn(*s, generator=g, device=dev, dtype=vd)
    live = torch.ones(Bk, dtype=torch.bool, device=dev)
    live[2::3] = False
    xp = t_rosen.initial_point(n, vd, dev)[None, :] + 0.1 * r(Bk, n)
    xp[:, ::17] = 0.0
    return dict(xp=xp, d=0.1 * r(Bk, n), gp=r(Bk, n), pg=r(Bk, n),
                S=as_ring((0.1 * r(Bk, m, n)).to(hd)), Y=as_ring((0.1 * r(Bk, m, n)).to(hd)),
                stp=0.2 + torch.rand(Bk, generator=g, device=dev, dtype=vd), live=live,
                end=m - 3, window=(5, n - 7))


def _copy(a, k):
    # a copy of an input, the rings in the runner's padded layout
    return as_ring(a[k].clone()) if k in ("S", "Y") else a[k].clone()


def _run(a, ow, fn=None, with_gp=True, live=None):
    """One launch of K4 b or K14 b (or ``fn``) on copies of the vectors and
    rings; returns (the copies, the outputs)."""
    t = {k: _copy(a, k) for k in NAMES}
    live = a["live"] if live is None else live
    lo, hi = a["window"]
    if ow:
        fn = fn or K.owlqn_trial_pair_gram_batched
        out = fn(t["xp"], a["d"], t["gp"], t["pg"], a["stp"], C, lo, hi, t["S"], t["Y"],
                 a["end"], live, with_gp=with_gp)
    else:
        fn = fn or K.trial_pair_gram_batched
        out = fn(t["xp"], a["d"], t["gp"], a["stp"], t["S"], t["Y"], a["end"], live,
                 with_gp=with_gp)
    return t, out


def _normwise(u, v):
    return float((u.double() - v.double()).abs().max() / max(float(v.double().abs().max()),
                                                             1e-300))


def _fold_only(monkeypatch):
    """The fold forms alone (the tensor-core forms off)."""
    monkeypatch.setattr(factory, "MMA_MAX_M", 0)
    monkeypatch.setattr(factory, "MMA_ROWS_MIN_M", dict.fromkeys(factory.MMA_ROWS_MIN_M, 1 << 62))


#: (vector dtype, ring dtype, m) of the card cases: f32 and f64 rings one
#: block deep (forced: the routing gives 19 rows to the deep fold form)
#: and at m = 80, bf16 rings past the one-pass form
ROWS_CARD = [(F32, F32, 19), (F32, F32, 80), (F64, F64, 19), (F64, F64, 80), (F32, BF16, 257),
             (F32, BF16, 260)]


@pytest.mark.cuda
@pytest.mark.parametrize("ow", [False, True], ids=["K4b", "K14b"])
@pytest.mark.parametrize("n", [1 << 14, (1 << 14) + 2])
@pytest.mark.parametrize("vd,hd,m", ROWS_CARD, ids=_ids)
def test_batched_rows_form_on_card(cuda, vd, hd, m, n, ow, monkeypatch):
    tv, ts = (1e-5, 1e-4) if vd == F32 else (1e-12, 1e-10)
    monkeypatch.setattr(factory, "MMA_ROWS_MIN_M", dict.fromkeys(factory.MMA_ROWS_MIN_M, 1))
    a = _card_batch(cuda, vd, hd, m, n)
    live = a["live"]
    kern = K.owlqn_trial_pair_gram_batched if ow else K.trial_pair_gram_batched
    ref = K.owlqn_trial_pair_gram_batched_ref if ow else K.trial_pair_gram_batched_ref
    form = factory.batched_epilogue_grid(24, n, m, vd, hd).form
    assert form == "mma_rows"
    rows = kern.mma_rows_launches
    tk, ok = _run(a, ow)
    assert kern.last_form.form == form
    assert kern.mma_rows_launches == rows + (form == "mma_rows")
    assert kern.last_form.compiled.n_spills == 0
    # against the plain version; frozen instances untouched
    tp, op = _run(a, ow, ref)
    vecs = ("xp", "gp", "pg") if ow else ("xp", "gp")
    for k in NAMES:
        assert torch.equal(tk[k][~live], a[k][~live]), k
    assert torch.equal(tk["S"], tp["S"]) and torch.equal(tk["Y"], tp["Y"])
    for k in vecs:
        assert _normwise(tk[k][live], tp[k][live]) <= tv, k
    for i, (u, v) in enumerate(zip(ok, op)):
        if u.dtype == torch.bool:
            assert torch.equal(u[live], v[live])
        else:
            assert _normwise(u[live], v[live]) <= ts, i
    # the 3-column launch: the . gp launch's other outputs bit for bit
    t3, o3 = _run(a, ow, with_gp=False)
    for k in NAMES:
        assert torch.equal(t3[k], tk[k]), k
    for u, v in zip(ok, o3):
        assert torch.equal((u[..., :3] if u.ndim == 3 else u)[live], v[live])
    # the solo kernels on each live instance
    lo, hi = a["window"]
    for b in torch.nonzero(live).flatten().tolist()[:4]:
        Sb, Yb = as_ring(a["S"][b].clone()), as_ring(a["Y"][b].clone())
        stp = float(a["stp"][b])
        if ow:
            x1, g1, pg1 = K.owlqn_trial_pair_gram(a["xp"][b], a["d"][b], a["gp"][b], a["pg"][b],
                                                  stp, C, lo, hi, Sb, Yb, a["end"])[:3]
            assert torch.equal(tk["pg"][b], pg1)
        else:
            x1, _, g1 = K.trial_pair_gram(a["xp"][b], a["d"][b], a["gp"][b], stp, Sb, Yb,
                                          a["end"])[:3]
        assert torch.equal(tk["xp"][b], x1) and torch.equal(tk["gp"][b], g1)
        assert torch.equal(tk["S"][b], Sb) and torch.equal(tk["Y"][b], Yb)
    # the fold form on the same inputs: x, g, pg, the rings and the flags
    _fold_only(monkeypatch)
    tf, of = _run(a, ow)
    assert kern.last_form.form in ("static", "deep")
    for k in NAMES:
        assert torch.equal(tf[k], tk[k]), k
    for i, (u, v) in enumerate(zip(ok, of)):
        if u.dtype == torch.bool:
            assert torch.equal(u[live], v[live])
        else:
            assert _normwise(u[live], v[live]) <= ts, i


def _products_f64(a, t, ow, b):
    """Instance b's SP and YP ([m, 4] against y, s, d0, gp) in float64 from
    the launch's own operands: the ring rows as it left them, widened, row
    ``end`` the unrounded pair."""
    gp, g = a["gp"][b], t["gp"][b]
    s = t["xp"][b] - a["xp"][b] if ow else a["stp"][b] * a["d"][b]
    d0 = -t["pg"][b] if ow else -g
    V = torch.stack([g - gp, s, d0, gp], dim=1).double()
    out = []
    for ring, new in (("S", s), ("Y", g - gp)):
        P = t[ring][b].double() @ V
        P[a["end"]] = new.double() @ V
        out.append(P)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("ow", [False, True], ids=["K4b", "K14b"])
@pytest.mark.parametrize("chunks", [2, 32, 64])
@pytest.mark.parametrize("vd,hd,m", [(F32, F32, 80), (F64, F64, 80), (F32, BF16, 260)],
                         ids=_ids)
def test_batched_rows_products_near_float64_on_card(cuda, vd, hd, m, chunks, ow, monkeypatch):
    """Each live instance's SP and YP (with the . gp column) against the
    float64 product of its own operands with ``chunks`` chunks a program:
    within 3e-7 normwise with f32 vectors, 2e-15 with f64."""
    a = _card_batch(cuda, vd, hd, m, 1 << 14, Bk=6, seed=7)
    monkeypatch.setattr(factory, "EPILOGUE_PROGRAMS", 6)
    monkeypatch.setattr(factory, "MMA_MAX_CHUNKS", chunks)
    t, out = _run(a, ow)
    kern = K.owlqn_trial_pair_gram_batched if ow else K.trial_pair_gram_batched
    assert kern.last_form.form == "mma_rows" and kern.last_form.tiles == chunks
    SP, YP = out[3:5] if ow else out[4:6]
    tol = 3e-7 if vd == F32 else 2e-15
    for b in torch.nonzero(a["live"]).flatten().tolist():
        want = _products_f64(a, t, ow, b)
        assert _normwise(SP[b], want[0]) <= tol
        assert _normwise(YP[b], want[1]) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("ow", [False, True], ids=["K4b", "K14b"])
@pytest.mark.parametrize("vd,hd,m", [(F32, F32, 80), (F64, F64, 80), (F32, BF16, 260)],
                         ids=_ids)
def test_batched_rows_inf_in_gp_on_card(cuda, vd, hd, m, ow):
    """An inf in one live instance's gp: that instance's . gp column and the
    products with y are non-finite, as the fold's are; the other live
    instances' products are finite."""
    a = _card_batch(cuda, vd, hd, m, 1 << 14, Bk=6)
    a["gp"][0, 1234] = float("inf")
    _, out = _run(a, ow)
    kern = K.owlqn_trial_pair_gram_batched if ow else K.trial_pair_gram_batched
    assert kern.last_form.form == "mma_rows"
    SP, YP = out[3:5] if ow else out[4:6]
    live = a["live"].clone()
    live[0] = False
    for P in (SP, YP):
        assert not torch.isfinite(P[0][:, 0]).all()
        assert not torch.isfinite(P[0][:, 3]).all()
        assert torch.isfinite(P[live]).all()
