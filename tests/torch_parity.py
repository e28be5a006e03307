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
