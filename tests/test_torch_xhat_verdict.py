"""The xhat feasibility verdict below the loop dtype's eps floor (the
fault behind a `wheel_row_telemetry` run that ended 40 supersteps
without an inner bound; ROADMAP.md §C).

An f32 batch solved at pdhg_eps 1e-7 converges at the f32 floor
(100 ulp = 1.19e-5), so a scenario can be "converged" with a primal
residual above the feasibility test's 10 x solver_eps = 1e-6.  The
certify that the failed test triggers used to re-solve the unconverged
scenarios only, none here, so the candidate stayed infeasible however
often the spoke evaluated it.  The port now re-solves every scenario
that fails the test; the JAX package still reports such a candidate
infeasible (its witness below: the same candidate, the same verdict
the port gave before the repair).
"""

import numpy as np
import pytest
import torch

import jax

from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.parallel.mesh import ScenarioMesh
from mpisppy_tpu.utils.xhat_eval import Xhat_Eval as JXhat_Eval
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.opt.ph import PH
from mpisppy_tpu_torch.spopt import SPOpt
from mpisppy_tpu_torch.utils.xhat_eval import Xhat_Eval

S = 6
NAMES = farmer.scenario_names_creator(S)
# chip_smoke.py's WHEEL_OPTS (the wheel_mpmd row's options)
OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 40, "convthresh": 0.0,
        "pdhg_eps": 1e-7, "pdhg_max_iters": 30000}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def candidate():
    """Scenario 0's nonants after Iter0 on f32 farmer-6."""
    b = farmer.build_batch(S, dtype=np.float32, device="cpu")
    ph = PH(dict(OPTS), NAMES, batch=b, device="cpu")
    ph.Iter0()
    return b.nonants(ph.state.x)[0].numpy()


def test_converged_but_infeasible_scenarios_are_certified(candidate,
                                                          monkeypatch):
    seen = []
    resolve = SPOpt._certified_resolve

    def spy(self, res, *a, select=None, **kw):
        seen.append((res, select))
        return resolve(self, res, *a, select=select, **kw)

    monkeypatch.setattr(SPOpt, "_certified_resolve", spy)
    b = farmer.build_batch(S, dtype=np.float32, device="cpu")
    xe = Xhat_Eval(dict(OPTS), NAMES, batch=b, device="cpu")
    obj, feas = xe.evaluate_xhat(candidate)
    tol = 10 * float(xe.solver_eps)
    (fast, select), = seen
    # the cause: every scenario converged at the f32 floor, some above
    # the feasibility test's tolerance
    assert bool(fast.converged.all())
    assert float(fast.pres.max()) >= tol
    assert torch.equal(select, fast.pres >= tol)
    # the repair: those scenarios were re-solved in f64 and pass
    assert feas and np.isfinite(obj)
    xe2 = Xhat_Eval(dict(OPTS), NAMES, batch=b, device="cpu")
    obj2, feas2 = xe2.evaluate_xhat(candidate, certify=True)
    assert feas2 and abs(obj2 - obj) <= 1e-6 * abs(obj)


def test_jax_package_keeps_the_old_verdict(candidate):
    """Witness: the JAX package, on the same f32 batch and candidate,
    certifies nothing (all scenarios converged) and reports the
    candidate infeasible."""
    jxe = JXhat_Eval(dict(OPTS), NAMES,
                     batch=jfarmer.build_batch(S, dtype=np.float32),
                     mesh=ScenarioMesh(devices=jax.devices()[:1]))
    _, feas = jxe.evaluate_xhat(candidate)
    assert not feas
