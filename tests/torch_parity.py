"""Shared helpers of the port's parity tests for the remaining
algorithms (`tests/test_torch_lshaped.py`, `test_torch_aph.py`,
`test_torch_fwph.py`, `test_torch_sc.py`, `test_torch_mip.py`,
`test_torch_bundles.py`): a one-device JAX mesh, the JAX PRNGKey draw
for the port's power iterations, relative errors and a hub that records
its bound trace at every sync."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpisppy_tpu.parallel.mesh import ScenarioMesh
from mpisppy_tpu_torch.ops import pdhg

# one JAX device: padding farmer-3 to the 8 virtual test devices would
# change the batch (and triple the solve work)
ONE = ScenarioMesh(devices=jax.devices()[:1])
TOL = 1e-6


def jax_normal_draw(shape, dtype, device, seed=0):
    """The JAX package's power-iteration start vector
    (jax.random.normal(PRNGKey(seed))), for the port's preps built
    inside an algorithm (a root LP, a hull QP, a stacked probe)."""
    jd = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    return torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed), shape, jd)), device=device)


@pytest.fixture(scope="module")
def jax_draw():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pdhg, "normal_draw", jax_normal_draw)
        yield


@pytest.fixture(scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


def tracing(hub_cls):
    """`hub_cls` recording (iteration, outer, inner, outer char, inner
    char) at every screen trace, i.e. at every sync."""

    class Tracing(hub_cls):
        def setup_hub(self):
            super().setup_hub()
            self.trace = []

        def screen_trace(self):
            self.trace.append((self.current_iteration(),
                               float(self.BestOuterBound),
                               float(self.BestInnerBound),
                               self.latest_ob_char, self.latest_ib_char))
            return super().screen_trace()

    return Tracing


def assert_traces_match(t, j, tol=TOL):
    assert len(t) == len(j), (t, j)
    for a, b in zip(t, j):
        assert a[0] == b[0] and a[3:] == b[3:], (a, b)
        for x, y in zip(a[1:3], b[1:3]):
            if np.isfinite(y):
                assert rel(x, y) <= tol, (a, b)
            else:
                assert x == y, (a, b)


BATCH_FIELDS = ("c", "qdiag", "A", "row_lo", "row_hi", "lb", "ub",
                "obj_const", "nonant_idx", "integer_mask", "stage_cost_c",
                "var_prob")


def assert_same_batch(t, j, names=True, prob_ulps=0):
    """Exact equality of the port's batch `t` and the JAX batch `j`:
    every array (a SplitA field by field), the tree, the names.
    prob_ulps: for stacked batches, the probabilities may differ by
    that many units in the last place: the port divides by the
    correctly rounded total (`math.fsum`), the JAX package by
    `jnp.sum`, which can round six 1/6 to 1 - 2^-53."""
    from mpisppy_tpu_torch.device import host
    from mpisppy_tpu_torch.ir import SplitA

    for f in BATCH_FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        if isinstance(a, SplitA):
            for g in ("shared", "rows", "cols", "vals"):
                np.testing.assert_array_equal(host(getattr(a, g)),
                                              np.asarray(getattr(b, g)))
            continue
        a, b = host(a), np.asarray(b)
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(host(t.tree.node_of),
                                  np.asarray(j.tree.node_of))
    if prob_ulps:
        np.testing.assert_array_max_ulp(host(t.tree.prob),
                                        np.asarray(j.tree.prob), prob_ulps)
    else:
        np.testing.assert_array_equal(host(t.tree.prob),
                                      np.asarray(j.tree.prob))
    assert t.tree.num_nodes == j.tree.num_nodes
    assert tuple(t.tree.stage_of) == tuple(j.tree.stage_of)
    assert tuple(t.tree.nonant_names) == tuple(j.tree.nonant_names)
    if names:
        assert tuple(t.tree.scen_names) == tuple(j.tree.scen_names)
        assert tuple(t.var_names) == tuple(j.var_names)


@pytest.fixture(scope="module")
def jax_ci_one_mesh():
    """The JAX confidence-interval modules' ExtensiveForm and Xhat_Eval
    on the one-device mesh: on the default 8-device test mesh each
    sampled solve pads its batch and compiles anew (~4 s a call)."""
    import functools

    from mpisppy_tpu.confidence_intervals import (ciutils,
                                                  multi_seqsampling,
                                                  sample_tree, seqsampling,
                                                  zhat4xhat)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (ciutils, multi_seqsampling, sample_tree, seqsampling,
                    zhat4xhat):
            for name in ("ExtensiveForm", "Xhat_Eval"):
                cls = getattr(mod, name, None)
                if cls is not None:
                    mp.setattr(mod, name,
                               functools.partial(cls, mesh=ONE))
        yield
