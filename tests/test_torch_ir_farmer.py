"""Port parity: the farmer builder and the IR functions of
`mpisppy_tpu_torch` against the JAX package.

The builder is numpy up to the final wrap on both sides, so its arrays
must be EQUAL, in float64 and in float32.  The IR functions (dense and
shared-A batched matvecs, the per-node segment sum) are compared to
1e-12 on inputs drawn from a seeded numpy generator.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpisppy_tpu import ir as jir
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu_torch import ir
from mpisppy_tpu_torch.models import farmer


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small cases: more intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

FIELDS = ("c", "qdiag", "A", "row_lo", "row_hi", "lb", "ub", "obj_const",
          "nonant_idx", "integer_mask", "stage_cost_c")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_build_batch_equals_jax_builder(dtype):
    jb = jfarmer.build_batch(5, crops_multiplier=2, dtype=dtype)
    tb = farmer.build_batch(5, crops_multiplier=2, dtype=dtype,
                            device="cpu")
    for f in FIELDS:
        want = np.asarray(getattr(jb, f))
        got = getattr(tb, f).numpy()
        if want.dtype.kind == "f":
            assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(tb.tree.prob.numpy(),
                                  np.asarray(jb.tree.prob))
    np.testing.assert_array_equal(tb.tree.node_of.numpy(),
                                  np.asarray(jb.tree.node_of))
    assert tb.tree.num_nodes == jb.tree.num_nodes
    assert tuple(tb.tree.stage_of) == tuple(jb.tree.stage_of)
    assert tb.tree.nonant_names == jb.tree.nonant_names
    assert tb.tree.scen_names == jb.tree.scen_names
    assert tb.var_names == jb.var_names
    for a, b in zip(tb.model_meta["A_delta_idx"],
                    jb.model_meta["A_delta_idx"]):
        np.testing.assert_array_equal(a, b)
    assert (tb.num_scens, tb.num_rows, tb.num_vars, tb.num_nonants) == \
        (5, 13, 24, 6)


def test_scenario_yields_equal_and_split_refused():
    for i in (0, 4, 17):
        np.testing.assert_array_equal(farmer.scenario_yields(i, 3, 7),
                                      jfarmer.scenario_yields(i, 3, 7))
    # split storage is ported (tests/test_torch_split_native.py); what is
    # refused of a split batch is its dense copy beyond 5e8 elements (a
    # shared block of 10000 x 20000 that is a view of one zero, so the
    # test allocates nothing)
    b = farmer.build_batch(3, split=True, device="cpu")
    assert b.split_A and b.A.shape == (3, 7, 12)
    big = dataclasses.replace(b, A=dataclasses.replace(
        b.A, shared=torch.zeros((), dtype=torch.float64).expand(10000,
                                                                20000)))
    with pytest.raises(MemoryError, match="densify"):
        big.densify()


@pytest.fixture(scope="module")
def rand():
    rng = np.random.default_rng(7)
    S, M, N, K = 6, 5, 9, 4
    return {"A": rng.standard_normal((S, M, N)),
            "A1": rng.standard_normal((1, M, N)),
            "x": rng.standard_normal((S, N)),
            "y": rng.standard_normal((S, M)),
            "v": rng.standard_normal((S, K)),
            "node_of": rng.integers(0, 3, size=(S, K)).astype(np.int32)}


@pytest.mark.parametrize("shared", [False, True])
def test_bmatvec_and_transpose_match_jax(rand, shared):
    A = rand["A1"] if shared else rand["A"]
    t = {k: torch.from_numpy(rand[k]) for k in ("x", "y")}
    got = ir.bmatvec(torch.from_numpy(A), t["x"]).numpy()
    want = np.asarray(jir.bmatvec(jnp.asarray(A), jnp.asarray(rand["x"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    got_t = ir.bmatvec_t(torch.from_numpy(A), t["y"]).numpy()
    want_t = np.asarray(jir.bmatvec_t(jnp.asarray(A),
                                      jnp.asarray(rand["y"])))
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=1e-12)


def test_node_segment_sum_matches_jax(rand):
    fl, seg = ir.node_segment_sum(torch.from_numpy(rand["node_of"]), 3)
    jfl, jseg = jir.node_segment_sum(jnp.asarray(rand["node_of"]), 3)
    np.testing.assert_array_equal(fl.numpy(), np.asarray(jfl))
    got = seg(torch.from_numpy(rand["v"])).numpy()
    want = np.asarray(jseg(jnp.asarray(rand["v"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_batch_helpers_and_device_move():
    b = farmer.build_batch(4, device="cpu")
    x = torch.arange(b.num_scens * b.num_vars, dtype=torch.float64
                     ).reshape(b.num_scens, b.num_vars)
    np.testing.assert_array_equal(b.nonants(x).numpy(),
                                  x.numpy()[:, :b.num_nonants])
    want = (b.c * x).sum(1) + b.obj_const
    assert torch.equal(b.objective(x), want)
    assert ir.delta_idx(b) is b.model_meta["A_delta_idx"]
    moved = b.to("cpu")
    assert moved.device.type == "cpu"
