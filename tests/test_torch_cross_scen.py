"""Port parity: cross-scenario cuts (`utils/cross_scenario.py`,
`extensions/cross_scen_extension.py`, `cylinders/cross_scen_spoke.py`
and the hub's wiring of the extension to its spoke) against the JAX
package on farmer-3, float64, on the CPU.

* `add_cross_scenario_capacity` is exactly equal (every array, the
  appended eta column and cut rows), and `cross_meta` reads the same
  layout.
* The cross-scenario wheel (a PH hub over the augmented batch with
  CrossScenarioExtension, the cut spoke on the base batch,
  interleaved), 2 PH iterations: the same cut count, x̄ and trivial
  bound (the seeded wait-and-see cut's) within 1e-6 relative (they
  agree to ~1e-13).  The
  JAX wheel runs on one device (`torch_parity.ONE`); every prep that
  a cut rebuilds starts its power iteration from the JAX PRNGKey draw.
  The blended subproblems end at their iteration caps (2,500); at a
  5,000 cap the two trajectories drift apart by rounding from the
  third PH iteration on (4.6e-6 relative in x̄ after 3 iterations,
  2.6e-5 after 6), so parity is held over the first two.
"""

import numpy as np
import pytest

from mpisppy_tpu.cylinders.cross_scen_spoke import (
    CrossScenarioCutSpoke as JCutSpoke)
from mpisppy_tpu.cylinders.hub import PHHub as JPHHub
from mpisppy_tpu.extensions.cross_scen_extension import (
    CrossScenarioExtension as JCrossExt)
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.opt.ph import PH as JPH
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
from mpisppy_tpu.utils.cross_scenario import (
    add_cross_scenario_capacity as jadd, cross_meta as jcross_meta)
from mpisppy_tpu.utils.xhat_eval import Xhat_Eval as JXhat_Eval
from mpisppy_tpu_torch.cylinders.cross_scen_spoke import (
    CrossScenarioCutSpoke)
from mpisppy_tpu_torch.cylinders.hub import PHHub
from mpisppy_tpu_torch.extensions.cross_scen_extension import (
    CrossScenarioExtension)
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.opt.ph import PH
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.utils.cross_scenario import (
    add_cross_scenario_capacity, cross_meta)
from mpisppy_tpu_torch.utils.xhat_eval import Xhat_Eval
from torch_parity import ONE, TOL, jax_draw, one_torch_thread, rel  # noqa

pytestmark = pytest.mark.usefixtures("jax_draw", "one_torch_thread")

S = 3
NAMES = [f"scen{i}" for i in range(S)]
OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 2, "convthresh": 1e-5,
        "pdhg_eps": 1e-7, "pdhg_max_iters": 2500}
FIELDS = ("c", "qdiag", "A", "row_lo", "row_hi", "lb", "ub", "obj_const",
          "nonant_idx", "integer_mask")


@pytest.mark.parametrize("max_cuts,w", [(5, 0.1), (40, 0.25)])
def test_capacity_equals_jax(max_cuts, w):
    jb = jadd(jfarmer.build_batch(S), max_cuts=max_cuts, eta_weight=w)
    tb = add_cross_scenario_capacity(farmer.build_batch(S, device="cpu"),
                                     max_cuts=max_cuts, eta_weight=w)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), f)
    assert tb.stage_cost_c is None and jb.stage_cost_c is None
    assert tb.var_names == jb.var_names
    assert cross_meta(tb) == jcross_meta(jb)


def test_cross_scenario_wheel_equals_jax():
    jbase = jfarmer.build_batch(S)
    jws = JWheelSpinner(
        {"hub_class": JPHHub, "opt_class": JPH,
         "hub_kwargs": {"options": {"rel_gap": 1e-4}},
         "opt_kwargs": {"options": dict(OPTS), "all_scenario_names": NAMES,
                        "batch": jadd(jbase, max_cuts=40, eta_weight=0.1),
                        "mesh": ONE, "extensions": JCrossExt}},
        [{"spoke_class": JCutSpoke, "opt_class": JXhat_Eval,
          "opt_kwargs": {"options": dict(OPTS), "all_scenario_names": NAMES,
                         "batch": jbase, "mesh": ONE}}]).spin()
    base = farmer.build_batch(S, device="cpu")
    ws = WheelSpinner(
        {"hub_class": PHHub, "opt_class": PH,
         "hub_kwargs": {"options": {"rel_gap": 1e-4}},
         "opt_kwargs": {"options": dict(OPTS), "all_scenario_names": NAMES,
                        "batch": add_cross_scenario_capacity(
                            base, max_cuts=40, eta_weight=0.1),
                        "device": "cpu",
                        "extensions": CrossScenarioExtension}},
        [{"spoke_class": CrossScenarioCutSpoke, "opt_class": Xhat_Eval,
          "opt_kwargs": {"options": dict(OPTS), "all_scenario_names": NAMES,
                         "batch": base}}]).spin()
    jo, to = jws.spcomm.opt, ws.spcomm.opt
    # the hub wired the extension to its spoke, which sent cuts
    assert to.extobject._spoke is ws.spcomm.spokes[0]
    assert to.extobject.n_cuts == jo.extobject.n_cuts > 1
    assert cross_meta(to.batch)["n_cuts"] == to.extobject.n_cuts
    assert int(to.state.it) == int(jo.state.it) == 2
    assert rel(to.root_xbar().numpy(), np.asarray(jo.root_xbar())) <= TOL
    assert rel(to.trivial_bound, jo.trivial_bound) <= TOL
    assert abs(to.trivial_bound - -115405.55) < 5.0
