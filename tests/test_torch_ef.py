"""Port parity: `mpisppy_tpu_torch/opt/ef.py` against the JAX package's
`mpisppy_tpu/opt/ef.py`, float64 on the CPU.

Both sides build their own preps.  The port draws the start vectors of
its power iterations from `ops.pdhg.normal_draw`, which this module
replaces by the JAX package's PRNGKey draw, so that both take the same
step sizes.

* ExtensiveForm on farmer-3 and on SIPLIB sslp_5_25 at S=5: objective,
  dual bound and root solution within 1e-6 relative of JAX, farmer-3 at
  its golden E[obj] = -108390 +- 20 and x = (170, 80, 250); the f64
  re-solve of an EF whose fast solve stops at its cap (`certify`)
  within 1e-6 of JAX's.
* ef_dual_bound on UC (S=4, H=6, fleet_multiplier=1): within 1e-6 of
  JAX, and never above the inner bound of the PH-recovered commitment.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.models import uc as juc
from mpisppy_tpu.opt.ef import ExtensiveForm as JEF
from mpisppy_tpu.opt.ef import ef_dual_bound as jef_dual_bound
from mpisppy_tpu.parallel.mesh import ScenarioMesh
from mpisppy_tpu_torch.models import farmer, sslp, uc
from mpisppy_tpu_torch.ops import pdhg
from mpisppy_tpu_torch.opt.ef import ExtensiveForm, ef_dual_bound
from mpisppy_tpu_torch.opt.ph import PH

ONE = ScenarioMesh(devices=jax.devices()[:1])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These cases are small: more intra-op threads than one only
    contend with the other test workers (several times slower under
    pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_normal_draw(shape, dtype, device, seed=0):
    jd = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    return torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed), shape, jd)), device=device)


@pytest.fixture(scope="module", autouse=True)
def jax_draw():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pdhg, "normal_draw", jax_normal_draw)
        yield


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


CASES = {
    "farmer3": (lambda: jfarmer.build_batch(3),
                lambda: farmer.build_batch(3, device="cpu"),
                {"pdhg_eps": 1e-7, "pdhg_max_iters": 200000}),
    "sslp_5_25_S5": (lambda: jsslp.build_batch(5, instance="sslp_5_25"),
                     lambda: sslp.build_batch(5, instance="sslp_5_25",
                                              device="cpu"),
                     {"pdhg_eps": 1e-6, "pdhg_max_iters": 200000}),
}


def _pair(name, **over):
    jbuild, tbuild, opts = CASES[name]
    opts = dict(opts, **over)
    jb, tb = jbuild(), tbuild()
    names = list(jb.tree.scen_names)
    jef = JEF(opts, names, batch=jb, mesh=ONE)
    tef = ExtensiveForm(opts, names, batch=tb, device="cpu")
    return jef, tef


@pytest.mark.parametrize("name", sorted(CASES))
def test_extensive_form_matches_jax(name):
    jef, tef = _pair(name)
    assert not tef.solved
    with pytest.raises(RuntimeError, match="solve_extensive_form"):
        tef.get_objective_value()
    jres = jef.solve_extensive_form()
    res = tef.solve_extensive_form()
    assert tef.solved and bool(res.converged.all())
    assert res.iters == int(jres.iters)
    assert _rel(tef.get_objective_value(), jef.get_objective_value()) <= 1e-6
    assert _rel(tef.get_dual_bound(), jef.get_dual_bound()) <= 1e-6
    assert _rel(tef.get_root_solution(), jef.get_root_solution()) <= 1e-6
    assert tef.nonants().shape == (tef.n_real_scens, tef.batch.num_nonants)
    stats = tef.solve_stats()
    assert stats["device"] == "cpu" and stats["flops"] > 0
    assert stats["solve_wall_s"] > 0 and stats["dtype"] == "float64"
    assert tef.pdhg_stats()["consensus_chunks"] > 0
    if name == "farmer3":
        assert abs(tef.get_objective_value() - -108390.0) < 20.0
        np.testing.assert_allclose(tef.get_root_solution(),
                                   [170.0, 80.0, 250.0], atol=0.5)


def test_certified_ef_resolve_matches_jax():
    """A cap of 200 iterations leaves the fast solve unconverged; the
    f64 full-batch consensus re-solve (100,000 iterations allowed) then
    certifies it, on each side."""
    jef, tef = _pair("sslp_5_25_S5", pdhg_max_iters=200)
    jres = jef.solve_extensive_form()
    res = tef.solve_extensive_form()
    assert bool(res.converged.all()) and bool(np.all(jres.converged))
    assert tef.solve_stats()["certify_wall_s"] > 0
    assert _rel(tef.get_objective_value(), jef.get_objective_value()) <= 1e-6
    assert _rel(tef.get_dual_bound(), jef.get_dual_bound()) <= 1e-6
    unc = tef.solve_extensive_form(certify=False)
    assert not bool(unc.converged.all())


def test_ef_dual_bound_on_uc_matches_jax_and_is_valid():
    S = 4
    names = uc.scenario_names_creator(S)
    jbound, _ = jef_dual_bound(juc.build_batch(S, H=6), names)
    tb = uc.build_batch(S, H=6, device="cpu")
    bound, secs = ef_dual_bound(tb, names, device="cpu")
    assert np.isfinite(bound) and secs >= 0.0
    assert _rel(bound, jbound) <= 1e-6
    ph = PH({"defaultPHrho": 50.0, "PHIterLimit": 2, "convthresh": 0.0,
             "pdhg_eps": 1e-6, "pdhg_max_iters": 100000},
            names, batch=tb, device="cpu")
    ph.Iter0()
    ph.ph_iteration()
    cands = uc.commitment_candidates(tb, ph.root_xbar())
    objs, feas = ph.evaluate_candidates(cands)
    assert feas.any()
    inner, ok = ph.evaluate_xhat(cands[int(np.argmin(np.where(
        feas, objs, np.inf)))])
    assert ok and bound <= inner + 1e-6 * abs(inner)
    assert bound >= ph.trivial_bound - 1e-6 * (1 + abs(bound))
