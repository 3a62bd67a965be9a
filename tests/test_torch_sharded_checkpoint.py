"""Sharded checkpoints (``utils/checkpoint.py`` under ``kernels_on_mesh``)
moving between world sizes, against the JAX package's portable
checkpoints (``lbfgs_tpu/utils/checkpoint.py:35-50``,
``tests/test_checkpoint_portability.py``: a state saved under one device
count restores under any other).

Three runs, each saved after 10 iterations (``_torch_mesh_ranks.
job_checkpoint``): the generic Rosenbrock (float64, n = 128, More-Thuente
capped), the column-split Poisson regression (float64, 64 x 256, OWL-QN c =
1 on [1, n) with Armijo, 40 iterations) and the generic Rosenbrock in
float32 over a bfloat16 ring (uncapped).  Saved at W = 2 and loaded at 1
and 4, saved at 4 and loaded at 2, saved with no mesh (one ``.npz``) and
loaded at 2, and saved at 2 and loaded with no mesh.  Held:

- the loaded state, gathered, bit for bit the saved one (the bf16 ring's
  bits too; the no-mesh loads against the whole state);
- the run resumed from it bit for bit the run resumed from ``shard_state``
  of the whole state;
- the resumed run ending with the uninterrupted run's status, and in
  float64 on its iteration with fx rel 1e-10 (float32 sums over other
  shards part the last steps);
- ``Mesh.gathers`` 0 while saving, loading and running;
- a template with another m or n raising ``ValueError`` on the mesh.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks
from lbfgs_torch.minimize import LbfgsState
from lbfgs_torch.utils.checkpoint import MANIFEST, load_state, save_state

AT = 10
CASES = {
    "rosen_f64": dict(model="rosenbrock", n=128, params={}),
    "poisson_owlqn": dict(model="poisson", poisson=[64, 256, 5], params=dict(
        orthantwise=[1.0, 1, 256], algorithm="BacktrackingArmijo", max_iterations=40)),
    "rosen_bf16": dict(model="rosenbrock", n=128, dtype="float32", params=dict(
        history_dtype="bfloat16", constrain_step_size=False, max_iterations=60)),
}
#: (world size of the load, the world size saved at, or 0 with no mesh)
LOADS = [(1, 2), (4, 2), (2, 4), (2, 0)]
IDS = [f"w{s}_to_w{w}" for w, s in LOADS]


def _whole(root, name, saved_w):
    return os.path.join(root, f"{name}_w{saved_w}_whole.npz" if saved_w else f"{name}_nomesh.npz")


def _source(root, name, saved_w):
    return os.path.join(root, f"{name}_w{saved_w}") if saved_w else _whole(root, name, 0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt"))
    saves = {}
    for w in (2, 4):
        saves[w] = ranks.launch("checkpoint", w, os.path.join(root, f"save{w}"), dict(
            mode="save", cases=CASES, at=AT, dir=root), timeout=180)
    # the same runs with no mesh, saved as one .npz
    nomesh = {}
    for name, case in CASES.items():
        params, obj, x0 = ranks.checkpoint_case(case)
        state = LbfgsState.build(params, x0, obj)
        ranks._until(state, AT)
        save_state(_whole(root, name, 0), state.state)
        ranks._until(state)
        nomesh[name] = ranks._summary(state.state, state.state.prob.x)
    loads = {}
    for w in sorted({w for w, _ in LOADS}):
        todo = [(name, _source(root, name, s), _whole(root, name, s))
                for lw, s in LOADS if lw == w for name in CASES]
        loads[w] = ranks.launch("checkpoint", w, os.path.join(root, f"load{w}"), dict(
            mode="load", cases=CASES, dir=root, loads=todo,
            mismatch=["rosen_f64", _source(root, "rosen_f64", 2)]), timeout=180)
    return root, saves, nomesh, loads


def _load(runs, w, saved_w, name):
    root, _, _, loads = runs
    key = f"{name}<-{os.path.basename(_source(root, name, saved_w))}"
    return [r[key] for r in loads[w]]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("w", [2, 4])
def test_save_writes_pieces_and_a_manifest_without_gathers(runs, w, name):
    root, saves, _, _ = runs
    assert all(r[name]["saved_k"] == AT and r[name]["save_gathers"] == 0 for r in saves[w])
    d = os.path.join(root, f"{name}_w{w}")
    assert os.path.exists(os.path.join(d, MANIFEST))
    assert all(os.path.exists(os.path.join(d, f"prob.x.rank{r}.npy")) for r in range(w))
    assert not [f for f in os.listdir(d) if ".tmp" in f]
    # the ranks' uninterrupted runs alike
    assert len({tuple(sorted(r[name]["uninterrupted"].items())) for r in saves[w]}) == 1


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("w,saved_w", LOADS, ids=IDS)
def test_loaded_state_is_the_saved_one_bit_for_bit(runs, w, saved_w, name):
    for r in _load(runs, w, saved_w, name):
        assert r["loaded_bits"]
        assert r["load_gathers"] == 0


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("w,saved_w", LOADS, ids=IDS)
def test_resumed_run_is_the_run_from_shard_state(runs, w, saved_w, name):
    keys = ("k", "neval", "status", "fx_hex", "x_sha")
    got = _load(runs, w, saved_w, name)
    for r in got:
        assert r["resumed"]["gathers"] == r["resumed_from_shard_state"]["gathers"] == 0
        assert {k: r["resumed"][k] for k in keys} == {
            k: r["resumed_from_shard_state"][k] for k in keys}
    # every rank alike
    assert len({r["resumed"]["x_sha"] for r in got}) == 1


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("w,saved_w", LOADS, ids=IDS)
def test_resumed_run_ends_as_the_uninterrupted_run(runs, w, saved_w, name):
    r = _load(runs, w, saved_w, name)[0]
    got, ref = r["resumed"], r["uninterrupted"]
    assert got["status"] == ref["status"]
    if CASES[name].get("dtype") == "float32":
        # float32 sums taken over other shards part the runs' last steps
        return
    assert got["k"] == ref["k"]
    assert got["fx"] == pytest.approx(ref["fx"], rel=1e-10)


@pytest.mark.parametrize("what", ["m", "n"])
@pytest.mark.parametrize("w", sorted({w for w, _ in LOADS}))
def test_mismatch_raises_on_a_mesh(runs, w, what):
    for r in runs[3][w]:
        assert r["mismatch"][what] is not None
        assert "element count" in r["mismatch"][what]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("saved_w", [2, 4])
def test_sharded_checkpoint_loads_with_no_mesh(runs, saved_w, name):
    """A directory written at W ranks loads in one process with no mesh:
    the whole state, bit for bit the gathered one, and the run resumed
    from it ends as the uninterrupted run with no mesh."""
    root, _, nomesh, _ = runs
    params, obj, x0 = ranks.checkpoint_case(CASES[name])
    st = load_state(_source(root, name, saved_w), LbfgsState.build(params, x0, obj).state)
    whole = load_state(_whole(root, name, saved_w), LbfgsState.build(params, x0, obj).state)
    assert ranks._state_bits(st, whole)
    state = LbfgsState.build(params, x0, obj)
    state.restore(st)
    ranks._until(state)
    assert state.state.status == nomesh[name]["status"]
    if CASES[name].get("dtype") != "float32":
        assert state.state.k == nomesh[name]["k"]
        assert float(state.state.prob.fx) == pytest.approx(nomesh[name]["fx"], rel=1e-10)


def test_npz_range_reads_match_whole_reads(tmp_path):
    """The single-process format's range reads (what a rank of a mesh reads
    of an .npz) against slices of the whole arrays, a bf16 ring included."""
    from lbfgs_torch.utils import checkpoint as ck

    g = torch.Generator().manual_seed(4)
    ring = torch.randn(5, 96, generator=g).bfloat16()
    vec = torch.randn(96, generator=g, dtype=torch.float64)
    path = str(tmp_path / "a.npz")
    np.savez(path, **ck._payload([("hist.s", ring), ("prob.x", vec)]))
    src = ck._Npz(path)
    try:
        for lo, hi in ((0, 96), (24, 48), (95, 96)):
            got = ck._tensor(src.range("hist.s", lo, hi), src.narrow("hist.s"), ring)
            assert torch.equal(got.view(torch.int16), ring[:, lo:hi].contiguous().view(torch.int16))
            got = ck._tensor(src.range("prob.x", lo, hi), None, vec)
            assert torch.equal(got, vec[lo:hi])
    finally:
        src.close()
