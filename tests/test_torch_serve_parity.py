"""Port parity: the serve layer's solves (`mpisppy_tpu_torch/serve/`)
against the port's own `PH.ph_main` and the JAX package's
`SolverService`, on the CPU.

* A batch-of-one service result is bitwise equal to the port's
  standalone `PH.ph_main` (the same superstep), within 1e-6 of the JAX
  service's result on the same request, and on the farmer goldens.
* A coalesced group of 4 distinct requests (farmer S=6, `seedoffset`
  0-3: scenarios 3-5 draw their yields from it) runs as ONE dispatch and
  matches the JAX service's coalesced group to 1e-6 (relative; the
  convergence metric, an average of |x - x̄|, relative to x̄'s scale) and
  the port's solo runs to 1e-9, each request with its own iteration
  count.
* A request past its deadline inside a group times out at an iteration
  while its batchmate finishes; admission control rejects structurally.
* One process replica (`serve_replica_mode="process"`) boots on the CPU
  and its result is bitwise equal to `PH.ph_main`.

The JAX services run once per module (a fixture).
"""

import time

import numpy as np
import pytest
import torch

from mpisppy_tpu_torch import disable_tictoc_output, reenable_tictoc_output
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.opt.ph import PH
from mpisppy_tpu_torch.serve.service import SolverService

GOLDEN_OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 200,
               "convthresh": 1e-5, "pdhg_eps": 1e-7}
GROUP_OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 25, "convthresh": 1e-6,
              "pdhg_eps": 1e-7}
FAST_OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 4, "convthresh": 1e-4,
             "pdhg_eps": 1e-7, "superstep_eps": 1e-5}
NAMES3 = [f"scen{i}" for i in range(3)]
NAMES6 = [f"scen{i}" for i in range(6)]
GROUP = range(4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    disable_tictoc_output()
    yield
    reenable_tictoc_output()
    torch.set_num_threads(n)


def _port_batch(S, seedoffset=0):
    return farmer.build_batch(S, seedoffset=seedoffset, device="cpu")


@pytest.fixture(scope="module")
def port_golden():
    ph = PH(dict(GOLDEN_OPTS), NAMES3, batch=_port_batch(3), device="cpu")
    conv, eobj, trivial = ph.ph_main()
    return {"conv": conv, "eobj": eobj, "trivial_bound": trivial,
            "xbar": ph.root_xbar().numpy()}


@pytest.fixture(scope="module")
def jax_results():
    """The JAX service's batch-of-one golden solve and its coalesced
    group of the 4 requests (submitted before the worker starts, so
    they dispatch as one group)."""
    from mpisppy_tpu.models import farmer as jfarmer
    from mpisppy_tpu.serve.service import SolverService as JaxService
    svc = JaxService({"serve_max_batch": 8}).start()
    try:
        one = svc.solve(jfarmer.build_batch(3), GOLDEN_OPTS,
                        scenario_names=NAMES3, model="farmer",
                        timeout=600)
    finally:
        svc.shutdown()
    svc = JaxService({"serve_max_batch": 8})
    hs = [svc.submit(jfarmer.build_batch(6, seedoffset=so), GROUP_OPTS,
                     scenario_names=NAMES6, model="farmer")
          for so in GROUP]
    svc.start()
    try:
        group = [svc.result(h, timeout=600) for h in hs]
    finally:
        svc.shutdown()
    assert svc._dispatches == 1
    return {"one": one, "group": group}


def test_batch_of_one_bitwise_and_within_jax(port_golden, jax_results):
    svc = SolverService(device="cpu").start()
    try:
        res = svc.solve(_port_batch(3), GOLDEN_OPTS,
                        scenario_names=NAMES3, model="farmer",
                        timeout=600)
    finally:
        svc.shutdown()
    assert res["status"] == "ok"
    # bitwise: plain float equality, no tolerance
    for k in ("conv", "eobj", "trivial_bound"):
        assert res[k] == port_golden[k], k
    assert np.array_equal(res["xbar"], port_golden["xbar"])
    j = jax_results["one"]
    assert j["status"] == "ok"
    for k in ("eobj", "trivial_bound"):
        assert abs(res[k] - j[k]) <= 1e-6 * abs(j[k]), k
    np.testing.assert_allclose(res["xbar"], np.asarray(j["xbar"]),
                               rtol=1e-6, atol=1e-6)
    assert res["iterations"] == j["iterations"]
    # the farmer goldens
    assert abs(res["eobj"] - -108390.0) < 20
    assert abs(res["trivial_bound"] - -115405.55) < 5
    assert np.allclose(res["xbar"], [170.0, 80.0, 250.0], atol=0.5)


def test_group_of_four_matches_jax_group_and_solo(jax_results):
    svc = SolverService({"serve_max_batch": 8}, device="cpu")
    hs = [svc.submit(_port_batch(6, so), GROUP_OPTS, scenario_names=NAMES6,
                     model="farmer") for so in GROUP]
    svc.start()
    try:
        group = [svc.result(h, timeout=600) for h in hs]
    finally:
        svc.shutdown()
    assert svc._dispatches == 1          # one coalesced group
    assert svc.cache.stats()["misses"] == 1
    eobjs = set()
    for so, res, j in zip(GROUP, group, jax_results["group"]):
        assert res["status"] == "ok" and j["status"] == "ok"
        eobjs.add(res["eobj"])
        for k in ("eobj", "trivial_bound"):
            assert abs(res[k] - j[k]) <= 1e-6 * max(1.0, abs(j[k])), k
        # conv averages |x - x̄| over values of x̄'s scale: 1e-6 of it
        xscale = float(np.max(np.abs(np.asarray(j["xbar"]))))
        assert abs(res["conv"] - j["conv"]) <= 1e-6 * xscale
        np.testing.assert_allclose(res["xbar"], np.asarray(j["xbar"]),
                                   rtol=1e-6, atol=1e-6)
        assert res["iterations"] == j["iterations"]
        solo = PH(dict(GROUP_OPTS), NAMES6, batch=_port_batch(6, so),
                  device="cpu")
        solo.ph_main()
        sd = solo.solution_dict()
        for k in ("eobj", "trivial_bound", "conv"):
            assert abs(res[k] - sd[k]) <= 1e-9 * max(1.0, abs(sd[k])), k
        np.testing.assert_allclose(res["xbar"], sd["xbar"], rtol=1e-9,
                                   atol=1e-9)
        assert res["iterations"] == sd["iterations"]
        assert res["solve_iters"] == sd["solve_iters"]
    assert len(eobjs) == len(GROUP)      # four distinct problems


def test_deadline_inside_a_group_and_admission():
    svc = SolverService({"serve_max_batch": 4, "serve_max_queue": 2},
                        device="cpu")
    ok_h = svc.submit(_port_batch(3), FAST_OPTS)
    doomed_h = svc.submit(
        _port_batch(3), dict(FAST_OPTS, PHIterLimit=10 ** 6,
                             convthresh=0.0), deadline=0.4)
    full = svc.result(svc.submit(_port_batch(3), FAST_OPTS), timeout=1)
    assert full["status"] == "rejected" and full["reason"] == "queue_full"
    svc.start()
    try:
        ok_res = svc.result(ok_h, timeout=600)
        doomed = svc.result(doomed_h, timeout=600)
    finally:
        svc.shutdown()
    assert ok_res["status"] == "ok" and ok_res["iterations"] == 4
    assert doomed["status"] == "timeout"
    assert doomed["where"] == "iteration" and doomed["iterations"] >= 1
    assert svc._dispatches == 1          # they ran as one group
    later = svc.result(svc.submit(_port_batch(3), FAST_OPTS), timeout=1)
    assert later["status"] == "rejected" and later["reason"] == "shutdown"
    # a request that waits past its deadline in the queue
    svc = SolverService(device="cpu")
    h = svc.submit(_port_batch(3), FAST_OPTS, deadline=0.05)
    time.sleep(0.2)
    svc.start()
    try:
        res = svc.result(h, timeout=60)
    finally:
        svc.shutdown()
    assert res["status"] == "timeout" and res["where"] == "queued"


def test_process_replica_boots_on_cpu(port_golden):
    from mpisppy_tpu_torch.serve.router import Router
    router = Router({"serve_replicas": 1, "serve_replica_mode": "process",
                     "router_hedge_threshold": None},
                    device="cpu").start()
    try:
        res = router.solve(_port_batch(3), GOLDEN_OPTS,
                           scenario_names=NAMES3, model="farmer",
                           idempotency_key="golden", timeout=600)
        again = router.solve(_port_batch(3), GOLDEN_OPTS,
                             scenario_names=NAMES3, model="farmer",
                             idempotency_key="golden", timeout=60)
        st = router.stats()
    finally:
        router.shutdown(timeout=30)
    assert res["status"] == "ok"
    for k in ("conv", "eobj", "trivial_bound"):
        assert res[k] == port_golden[k], k
    assert np.array_equal(res["xbar"], port_golden["xbar"])
    assert again["eobj"] == res["eobj"]  # the idempotency table
    assert st["replica_mode"] == "process"
    assert st["replicas"] == ["p0i0"]
