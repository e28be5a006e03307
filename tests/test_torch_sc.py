"""Port parity: the Schur-complement IPM (`mpisppy_tpu_torch/opt/sc.py`)
against the JAX package, float64, on the CPU.

* farmer-3 and farmer-5: the objective agrees to 1e-8 relative, the
  first-stage solution to 1e-6; the objective is the EF optimum.
* farmer S=10, crops_multiplier=10 at the default 100 iterations: both
  packages stop at the same point (1e-6), far from the EF optimum
  (HiGHS):
  the iteration count, not the port, sets how close SC gets there.
* An integer batch raises, as in the JAX package; a Cholesky
  factorization that fails raises instead of returning NaNs.
"""

import pytest
import torch

from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.opt.sc import SchurComplement as JSC
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.opt.sc import SchurComplement
from torch_parity import ONE, one_torch_thread, rel  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("S", [3, 5])
def test_objective_matches_jax(S):
    names = [f"scen{i}" for i in range(S)]
    j = JSC({}, names, batch=jfarmer.build_batch(S), mesh=ONE)
    jobj, jx = j.solve()
    t = SchurComplement({}, names, batch=farmer.build_batch(
        S, device="cpu"), device="cpu")
    tobj, tx = t.solve()
    assert abs(tobj - jobj) <= 1e-8 * abs(jobj)
    assert rel(tx, jx) <= 1e-6
    if S == 3:
        assert tobj == pytest.approx(-108390.0, rel=1e-6)


def test_default_iterations_stop_short_in_both_packages():
    from efcheck import ef_linprog
    S = 10
    names = [f"scen{i}" for i in range(S)]
    jb = jfarmer.build_batch(S, crops_multiplier=10)
    jobj, _ = JSC({}, names, batch=jb, mesh=ONE).solve()
    tobj, _ = SchurComplement({}, names, batch=farmer.build_batch(
        S, crops_multiplier=10, device="cpu"), device="cpu").solve()
    # an iterate far from the optimum amplifies the summation order:
    # 1e-6 here, where the converged cases above agree to 1e-8
    assert abs(tobj - jobj) <= 1e-6 * abs(jobj)
    opt, _ = ef_linprog(jb, n_real=S)
    assert abs(tobj - opt) > 0.1 * abs(opt)


def test_integer_batch_raises():
    b = farmer.build_batch(3, use_integer=True, device="cpu")
    with pytest.raises(RuntimeError, match="continuous"):
        SchurComplement({}, ["a", "b", "c"], batch=b, device="cpu")


def test_failed_factorization_raises(monkeypatch):
    real = torch.linalg.cholesky_ex

    def broken(M):
        L, info = real(M)
        return L, torch.ones_like(info)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", broken)
    t = SchurComplement({"sc_max_iter": 2}, ["a", "b", "c"],
                        batch=farmer.build_batch(3, device="cpu"),
                        device="cpu")
    with pytest.raises(RuntimeError, match="Cholesky"):
        t.solve()
