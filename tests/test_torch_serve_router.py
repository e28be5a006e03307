"""Port parity: the serve layer's traffic logic (`serve/router.py`,
`serve/replica.py`) against the JAX package's, and the port's replica
set under chaos on the CPU.

* `TokenBucket` and `CircuitBreaker` take the same decisions, states
  and reopen times as the JAX package's under one scripted fake clock.
* The brownout ladder (`Router._eval_brownout`) steps through the same
  levels at the same fake times as the JAX router's under one scripted
  load, each router over a set of inert replicas.
* Two thread replicas on the CPU under `replica_crash`, `slow_replica`
  and a poison request mid-stream: every other request completes ok
  (bitwise equal to the port's `PH.ph_main`), the poison is
  quarantined, the crashed replica is replaced.
"""

import random
import time

import pytest
import torch

from mpisppy_tpu.serve import router as jrouter

from mpisppy_tpu_torch import disable_tictoc_output, reenable_tictoc_output
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.opt.ph import PH
from mpisppy_tpu_torch.serve import router as prouter

FAST_OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 4, "convthresh": 1e-4,
             "pdhg_eps": 1e-7, "superstep_eps": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    disable_tictoc_output()
    yield
    reenable_tictoc_output()
    torch.set_num_threads(n)


def test_token_bucket_and_breaker_step_like_jax():
    rng = random.Random(0)
    tb = [m.TokenBucket(rate=5.0, burst=3) for m in (jrouter, prouter)]
    br = [m.CircuitBreaker(fail_threshold=2, backoff=0.5, backoff_cap=4.0)
          for m in (jrouter, prouter)]
    for b in tb + br:
        if hasattr(b, "stamp"):
            b.stamp = 0.0
    t = 0.0
    for _ in range(400):
        t += rng.choice((0.0, 0.01, 0.1, 0.3, 1.0))
        took = [b.take(t) for b in tb]
        assert took[0] == took[1]
        assert tb[0].tokens == tb[1].tokens
        op = rng.choice(("allow", "ok", "fail", "fail", "trip"))
        out = []
        for b in br:
            if op == "allow":
                out.append(b.allow(t))
            elif op == "ok":
                out.append(b.record_success(t))
            elif op == "fail":
                out.append(b.record_failure(t))
            else:
                out.append(b.trip(t))
        assert out[0] == out[1], op
        assert (br[0].state, br[0].failures, br[0].opens, br[0].reopen_at) \
            == (br[1].state, br[1].failures, br[1].opens, br[1].reopen_at)
    assert br[0].states_seen() == br[1].states_seen()
    assert {"open", "half_open", "closed"} <= set(br[1].states_seen())


class _Inert:
    """A replica that is never asked to do anything (the ladder reads
    only its liveness)."""

    def __init__(self, slot):
        self.slot, self.incarnation = slot, 0
        self.name = f"n{slot}"
        self.condemned = self.failed = False
        self.assigned = {}


class _InertSet:
    def __init__(self, n):
        self.replicas = [_Inert(i) for i in range(n)]

    def __len__(self):
        return len(self.replicas)

    def __iter__(self):
        return iter(self.replicas)

    def __getitem__(self, slot):
        return self.replicas[slot]


def test_brownout_ladder_steps_like_jax():
    opts = {"serve_max_inflight": 10, "router_brownout_sustain": 2,
            "router_brownout_interval": 0.25}
    routers = [m.Router(dict(opts), replica_set=_InertSet(2))
               for m in (jrouter, prouter)]
    rng = random.Random(1)
    t = 100.0
    load = 0
    for _ in range(300):
        t += rng.choice((0.1, 0.26, 0.5))
        load = max(0, min(20, load + rng.choice((-6, -2, 0, 3, 6))))
        for r in routers:
            r._open = {i: None for i in range(load)}
            r._eval_brownout(t)
        assert routers[0].brownout_level == routers[1].brownout_level
    assert routers[0].brownout_transitions \
        == routers[1].brownout_transitions
    assert max(lv for lv, _ in routers[1].brownout_transitions) == 3


def test_replica_set_under_chaos_on_cpu():
    names = [f"scen{i}" for i in range(3)]
    ph = PH(dict(FAST_OPTS), names,
            batch=farmer.build_batch(3, device="cpu"), device="cpu")
    _, eobj, _ = ph.ph_main()
    router = prouter.Router({
        "serve_replicas": 2, "serve_max_batch": 1,
        "serve_restart_backoff": 0.01, "serve_restart_backoff_cap": 0.05,
        "router_tick": 0.01, "router_probe_interval": 0.02,
        "router_hedge_threshold": 1.0, "router_breaker_backoff": 0.05,
        "router_breaker_backoff_cap": 0.5, "router_drain_deadline": 0.3,
        "chaos": {"replica_crash": 1, "slow_replica": 0.02,
                  "poison_request": True, "chaos_replica": 0}},
        device="cpu").start()
    try:
        batch = farmer.build_batch(3, device="cpu")
        handles, poison = [], None
        for i in range(6):
            handles.append(router.submit(batch, FAST_OPTS, model="farmer",
                                         scenario_names=names,
                                         idempotency_key=f"r{i}"))
            if i == 3:
                poison = router.submit(
                    batch, dict(FAST_OPTS, chaos_poison=True),
                    model="farmer", idempotency_key="poison")
            time.sleep(0.02)
        results = [router.result(h, timeout=300) for h in handles]
        bad = router.result(poison, timeout=300)
        st = router.stats()
    finally:
        router.shutdown(timeout=10)
    assert [r["status"] for r in results] == ["ok"] * 6
    assert {r["eobj"] for r in results} == {eobj}
    assert bad["status"] == "failed"
    assert bad["reason"].startswith("quarantined")
    assert st["replica_restarts"] >= 1
    assert st["replica_mode"] == "thread"
