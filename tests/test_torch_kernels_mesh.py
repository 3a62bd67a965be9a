"""Every kernel dispatcher of the PyTorch port on a mesh, against its
single-process form (the counterpart of ``tests/test_kernels_mesh.py``),
and ``vecmath``'s reductions.

One job of four gloo ranks (``_torch_mesh_ranks.job_kernels``, n = 4096,
m = 6, float32 vectors, a bfloat16 ring, seeded numpy inputs) calls each
dispatcher once with no mesh on the whole inputs and once under
``kernels_on_mesh`` on the rank's shard; on the CPU both run the plain
versions, on the shards the mesh form's local sums and its one
all-reduce.  Each case here asserts, on every rank:

- the vectors and ring rows it writes equal the single-process ones on
  the shard's elements, bit for bit;
- its scalars are the same bits on every rank, and match the
  single-process scalars within ``tests/test_kernels_mesh.py``'s bounds:
  rel 1e-5 on objective values and squared norms (fx, g.g, x.x, r.r,
  pg.pg), rel 1e-4 with abs 1e-2 on the directional products (g.d, r.d),
  rtol 2e-4 with atol 1e-2 on the Gram products; ``changed`` equal.

The OWL-QN dispatchers run on a window that starts and ends inside
different shards and on one that lies inside one shard and misses the
others; the factory's extras run given whole and given as shards, and a
body that reads the global index shows the shard's offset at work.

A second job holds every case at m = 65 ring rows on two ranks, past
``factory.MAX_M``, where the card runs the deep forms of K15 and K16 and
of K4 and K14 (the tensor-core form with f32 vectors over a bf16 ring;
their plain versions here), to the same bounds.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import _torch_mesh_ranks as ranks

W, N, M = 4, 4096, 6
#: the deep job: two ranks, a ring deeper than the static forms take
W_DEEP, M_DEEP = 2, 65
#: windows: from inside shard 0 to inside shard 3, and one inside shard 1
WINDOWS = {"cross": (130, N - 7), "one_shard": (1100, 2000)}
#: a Rosenbrock iterate whose shards hold an odd number of elements
N_BAD = W * 1023

NORM = dict(rtol=1e-5, atol=0.0)
DOT = dict(rtol=1e-4, atol=1e-2)
GRAM = dict(rtol=2e-4, atol=1e-2)
EQUAL = None

_TRIAL = {"out1": NORM, "out3": DOT, "out4": NORM, "out5": NORM, "out6": EQUAL}
_EPILOGUE = dict(_TRIAL, out7=GRAM, out8=GRAM)
_PAIR = {"out0": GRAM, "out1": GRAM}
_COMBINE = {"out1": NORM, "out2": DOT}
_OW_PROBE = {"out0": NORM, "out1": DOT}
_OW_EPILOGUE = {"out3": GRAM, "out4": GRAM, "out5": NORM, "out6": NORM, "out7": EQUAL}

#: case -> the bound of each scalar output
CASES = {
    "K1_trial": _TRIAL,
    "K2_probe": {"out0": NORM, "out1": DOT},
    "K3_combine": _COMBINE,
    "K4_trial_pair_gram": _EPILOGUE,
    "K4_trial_pair_gram_gp": _EPILOGUE,
    "K5_pair_gram": _PAIR,
    "K5_pair_gram_gp": _PAIR,
    "K6_combine_fix": _COMBINE,
    "K12_pair_gram_xg": _PAIR,
    "K12_pair_gram_xg_gp": dict(_PAIR, out2=NORM, out3=DOT),
    "K15_combine_probe": dict(_COMBINE, out3=NORM, out4=DOT),
    "K15_combine_probe_fix": dict(_COMBINE, out3=NORM, out4=DOT),
    "quadratic_extras": _TRIAL,
    "quadratic_extras_shards": _TRIAL,
    "quadratic_epilogue": _EPILOGUE,
    "gidx_body": {"out1": NORM, "out3": DOT, "out4": NORM, "out5": NORM},
    # vecmath's dot, norm2 and dots: one scalar for the whole vector
    # (tests/test_sharding.py::test_sharded_dot_reduction)
    "vecmath": {"out0": DOT, "out1": NORM, "out2": NORM, "out3": DOT},
}
#: the cases that write no vector
NO_VECTORS = {"K2_probe", "vecmath"} | {f"K8_owlqn_probe{pg}_{w}" for pg in ("", "_pg")
                                        for w in WINDOWS}
for _w in WINDOWS:
    CASES.update({
        f"K7_owlqn_trial_{_w}": {"out1": NORM, "out3": DOT, "out4": NORM, "out5": EQUAL},
        f"K8_owlqn_probe_{_w}": _OW_PROBE,
        f"K8_owlqn_probe_pg_{_w}": _OW_PROBE,
        f"K9_owlqn_trial_step_{_w}": {},
        f"K10_pseudo_gradient_norm_{_w}": {"out1": NORM},
        f"K11_pseudo_gradient_{_w}": {},
        f"K13_combine_ow_{_w}": {"out1": NORM, "out2": NORM, "out3": DOT},
        f"K14_owlqn_trial_pair_gram_{_w}": _OW_EPILOGUE,
        f"K14_owlqn_trial_pair_gram_gp_{_w}": dict(_OW_EPILOGUE, out8=NORM, out9=DOT),
        f"K16_combine_ow_probe_{_w}": {"out1": NORM, "out2": NORM, "out3": DOT,
                                       "out4": NORM, "out5": DOT},
    })


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    return ranks.launch("kernels", W, tmp_path_factory.mktemp("kernels_mesh"),
                        dict(n=N, m=M, n_bad=N_BAD, windows=WINDOWS), timeout=180)


@pytest.fixture(scope="module")
def job_deep(tmp_path_factory):
    return ranks.launch("kernels", W_DEEP, tmp_path_factory.mktemp("kernels_mesh_deep"),
                        dict(n=N, m=M_DEEP, n_bad=W_DEEP * 1023, windows=WINDOWS), timeout=180)


def _check_case(job, name):
    bounds = CASES[name]
    for r, res in enumerate(job):
        case = res[name]
        assert all(case["bits"].values()) and (bool(case["bits"]) != (name in NO_VECTORS)), \
            (r, case)
        assert set(case["scalars"]) == set(bounds), (r, sorted(case["scalars"]))
        for out, tol in bounds.items():
            got, want = case["scalars"][out]
            # every rank reads the same all-reduced bits
            assert got == job[0][name]["scalars"][out][0], (r, out)
            if tol is EQUAL:
                assert got == want, (r, out)
            else:
                np.testing.assert_allclose(got, want, **tol, err_msg=f"rank {r} {out}")


@pytest.mark.parametrize("name", list(CASES))
def test_dispatcher_on_mesh_matches_single_process(job, name):
    _check_case(job, name)


@pytest.mark.parametrize("name", list(CASES))
def test_deep_dispatcher_on_mesh_matches_single_process(job_deep, name):
    """Every case at m = 65 on two ranks: vectors and ring rows bit for bit
    the single-process form's, scalars within the same bounds."""
    _check_case(job_deep, name)


def test_gidx_body_needs_the_offset(job):
    """Without the shard's offset the body would weight every shard as
    shard 0: the gradient of shards 1-3 then differs from the whole
    vector's (the mesh form above matches it bit for bit)."""
    assert job[0]["gidx_body"]["without_offset_matches"]
    for res in job[1:]:
        assert not res["gidx_body"]["without_offset_matches"]


def test_axpy_dot_has_no_mesh_form(job):
    """K17 lies on no solver path and, as in the JAX package, has no mesh
    form: under a mesh it raises, naming itself."""
    for res in job:
        msg = res["K17_on_mesh"]
        assert msg is not None and "K17" in msg, msg


def test_split_the_kernels_cannot_take_raises(job):
    """Rosenbrock couples (2i, 2i+1): a shard of an odd number of
    elements is refused with a ValueError naming the split, never run on
    a plain path (``tests/test_kernels_mesh.py:164``)."""
    for res in job:
        msg = res["bad_split"]
        assert msg is not None and "1023" in msg and "split" in msg, msg
