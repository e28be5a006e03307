"""Port parity: L-shaped (`mpisppy_tpu_torch/opt/lshaped.py`), its hub
(`cylinders/hub.LShapedHub`), its xhat spoke
(`cylinders/lshaped_bounder.py`) and vanilla's `lshaped_hub` /
`xhatlshaped_spoke`, against the JAX package on farmer-3, float64, on
the CPU.

* `LShapedMethod.lshaped_algorithm`, multi-cut and single-cut: the
  outer bound, the inner bound and x̂ after every iteration agree to
  1e-6 relative.  The port's subproblems solve on the JAX package's
  PreparedBatch (`convert.py`), and every root prep starts its power
  iteration from the JAX PRNGKey draw (the root LP is degenerate: a
  norm estimate apart changes the optimal vertex).
* The L-shaped hub with the xhat spoke, interleaved: the bound trace
  at every sync agrees to 1e-6.
* `examples/farmer_lshapedhub.py`'s command line through the port's
  config and vanilla runs and brackets the farmer-3 optimum.
* The configuration `chip_smoke.py`'s `alg_lshaped` runs on the card
  (farmer_lshapedhub.py's flags at S=100, cm=10, one iteration): the
  outer and inner bounds agree with the JAX package's to 1e-6.  Here
  the JAX package's first root converges at the primal weight 1.0 and
  the port's stalls there and is solved again from the weight's floor
  (`opt/lshaped.py`).  That root is degenerate, so the two x̂ differ;
  the port's root solution is held to the JAX package's root LP
  instead: feasible to 10 x eps and of the same objective.
"""

import numpy as np
import pytest

from mpisppy_tpu.cylinders import hub as jhub
from mpisppy_tpu.cylinders.lshaped_bounder import (
    XhatLShapedInnerBound as JXhatLShaped)
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.opt.lshaped import LShapedMethod as JLShaped
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
from mpisppy_tpu.utils.xhat_eval import Xhat_Eval as JXhat_Eval
from mpisppy_tpu_torch.convert import prep_from_arrays, to_arrays
from mpisppy_tpu_torch.cylinders import hub
from mpisppy_tpu_torch.cylinders.lshaped_bounder import XhatLShapedInnerBound
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.opt.lshaped import LShapedMethod
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.utils import config, vanilla
from mpisppy_tpu_torch.utils.xhat_eval import Xhat_Eval
from torch_parity import (ONE, TOL, assert_traces_match, jax_draw,  # noqa
                          one_torch_thread, rel, tracing)

pytestmark = pytest.mark.usefixtures("jax_draw", "one_torch_thread")

S = 3
NAMES = [f"scen{i}" for i in range(S)]
OPTIMUM = -108390.0
OPTS = {"max_iter": 6, "tol": 0.0, "pdhg_eps": 1e-7}


class _JRecording(JLShaped):
    """The JAX method, recording (outer, inner, x̂) after each root
    solve, as the port's `history` does."""

    def _root_solve(self):
        xhat, obj = super()._root_solve()
        self.history = getattr(self, "history", [])
        self.history.append((obj, self.inner_bound, np.array(xhat)))
        return xhat, obj


@pytest.fixture(scope="module")
def runs(jax_draw, one_torch_thread):
    out = {}
    for mode, extra in (("multi", {}), ("single", {"single_cut": True})):
        opts = dict(OPTS, **extra)
        j = _JRecording(dict(opts), NAMES, batch=jfarmer.build_batch(S),
                        mesh=ONE)
        j.lshaped_algorithm()
        t = LShapedMethod(dict(opts), NAMES,
                          batch=farmer.build_batch(S, device="cpu"),
                          device="cpu",
                          prep=prep_from_arrays(to_arrays(j.prep),
                                                device="cpu"))
        t.lshaped_algorithm()
        out[mode] = (t, j)
    return out


@pytest.mark.parametrize("mode", ["multi", "single"])
def test_every_iteration_matches_jax(runs, mode):
    t, j = runs[mode]
    assert len(t.history) == len(j.history) == OPTS["max_iter"]
    for k, (a, b) in enumerate(zip(t.history, j.history)):
        assert rel(a[0], b[0]) <= TOL, (k, a, b)
        assert rel(a[1], b[1]) <= TOL, (k, a, b)
        assert rel(a[2], b[2]) <= TOL, (k, a, b)
    assert t._root["n_cuts"] == j._root["n_cuts"]
    # every root converged at the primal weight 1.0, as in the JAX package
    assert t.root_resolves == 0
    np.testing.assert_allclose(t._root["row_lo"], j._root["row_lo"],
                               rtol=1e-6, atol=1e-6)
    assert rel(t.best_xhat, j.best_xhat) <= TOL
    # the bounds bracket the optimum
    assert t.outer_bound <= OPTIMUM + 1.0 and t.inner_bound >= OPTIMUM - 1.0


def test_root_skeleton_matches_jax(runs):
    t, j = runs["multi"]
    np.testing.assert_array_equal(t._fs_rows, j._fs_rows)
    assert t.max_cuts == j.max_cuts == S * (OPTS["max_iter"] + 1)
    for f in ("c", "ub"):
        np.testing.assert_array_equal(t._root[f], j._root[f], err_msg=f)
    # eta's bounds come from the wait-and-see duals: a few ulp apart
    np.testing.assert_allclose(t._root["lb"], j._root["lb"], rtol=1e-12)
    assert t._root["A"].shape == j._root["A"].shape


def _wheel(hub_cls, opt_cls, spoke_cls, spoke_opt, batch, **kw):
    opts = {"max_iter": 6, "tol": 1e-6, "pdhg_eps": 1e-7}
    return ({"hub_class": tracing(hub_cls), "opt_class": opt_cls,
             "hub_kwargs": {"options": {"rel_gap": 1e-5}},
             "opt_kwargs": {"options": dict(opts),
                            "all_scenario_names": NAMES, "batch": batch,
                            **kw}},
            [{"spoke_class": spoke_cls, "opt_class": spoke_opt,
              "opt_kwargs": {"options": dict(opts),
                             "all_scenario_names": NAMES}}])


def test_hub_wheel_matches_jax():
    jws = JWheelSpinner(*_wheel(jhub.LShapedHub, JLShaped, JXhatLShaped,
                                JXhat_Eval, jfarmer.build_batch(S),
                                mesh=ONE)).spin()
    prep = prep_from_arrays(to_arrays(jws.spcomm.opt.prep), device="cpu")
    tws = WheelSpinner(*_wheel(hub.LShapedHub, LShapedMethod,
                               XhatLShapedInnerBound, Xhat_Eval,
                               farmer.build_batch(S, device="cpu"),
                               device="cpu", prep=prep)).spin()
    assert_traces_match(tws.spcomm.trace, jws.spcomm.trace)
    for f in ("BestOuterBound", "BestInnerBound"):
        assert rel(getattr(tws, f), getattr(jws, f)) <= TOL, f
    assert tws.BestOuterBound <= OPTIMUM + 1.0 <= tws.BestInnerBound + 2.0
    assert tws.spcomm.failed_spokes == []
    sol = tws.spcomm.best_nonant_solution
    assert sol is not None and rel(sol, jws.spcomm.best_nonant_solution) \
        <= TOL


def test_farmer_lshapedhub_command_line():
    """examples/farmer_lshapedhub.py's row of examples/run_all.py,
    through the port's config and vanilla (iterations cut to 4)."""
    cfg = config.Config()
    cfg.popular_args()
    cfg.two_sided_args()
    cfg.xhatlshaped_args()
    farmer.inparser_adder(cfg)
    cfg.parse_command_line("farmer_lshapedhub", args=[
        "--num-scens", "3", "--max-iterations", "4", "--xhatlshaped"])
    names = farmer.scenario_names_creator(cfg.num_scens)
    batch = farmer.build_batch(cfg.num_scens, device="cpu")
    hub_dict = vanilla.lshaped_hub(cfg, farmer.scenario_creator, None,
                                   names, batch=batch)
    hub_dict["opt_kwargs"]["device"] = "cpu"
    spokes = [vanilla.xhatlshaped_spoke(cfg, farmer.scenario_creator,
                                        None, names, batch=batch)]
    assert hub_dict["opt_kwargs"]["options"]["max_iter"] == 4
    ws = WheelSpinner(hub_dict, spokes).spin()
    assert ws.spcomm.opt.iter <= 4
    assert ws.BestOuterBound <= OPTIMUM + 1.0 <= ws.BestInnerBound + 2.0


CARD_S = 100


def _card_options():
    """The options vanilla.lshaped_hub builds from chip_smoke.py's
    alg_lshaped command line."""
    cfg = config.Config()
    cfg.popular_args()
    cfg.two_sided_args()
    cfg.xhatlshaped_args()
    farmer.inparser_adder(cfg)
    cfg.parse_command_line("farmer_lshapedhub", args=[
        "--num-scens", str(CARD_S), "--crops-multiplier", "10",
        "--max-iterations", "1", "--xhatlshaped"])
    return vanilla.lshaped_hub(cfg, farmer.scenario_creator, None,
                               farmer.scenario_names_creator(CARD_S),
                               )["opt_kwargs"]["options"]


def test_chip_smoke_configuration_matches_jax():
    opts = _card_options()
    assert opts["max_iter"] == 1
    names = farmer.scenario_names_creator(CARD_S)
    j = _JRecording(dict(opts), names, mesh=ONE,
                    batch=jfarmer.build_batch(CARD_S, crops_multiplier=10))
    j.lshaped_algorithm()
    t = LShapedMethod(dict(opts), names, device="cpu",
                      batch=farmer.build_batch(CARD_S, crops_multiplier=10,
                                               device="cpu"),
                      prep=prep_from_arrays(to_arrays(j.prep),
                                            device="cpu"))
    t.lshaped_algorithm()
    assert t.root_unconverged == 0
    assert len(t.history) == len(j.history) == 1
    (to, ti, _), (jo, ji, _) = t.history[0], j.history[0]
    assert rel(to, jo) <= TOL and rel(ti, ji) <= TOL
    assert jo <= ji
    # the port's root optimum is optimal for the JAX package's root LP
    r, z = j._root, t._root_warm[0][0].numpy()
    tol = 10 * t.root_eps
    az, lo, hi = r["A"][0] @ z, r["row_lo"][0], r["row_hi"][0]
    assert np.all(az >= lo - tol * (1.0 + np.abs(lo)))
    assert np.all(az <= hi + tol * (1.0 + np.abs(hi)))
    assert np.all(z >= r["lb"][0] - tol * (1.0 + np.abs(r["lb"][0])))
    assert np.all(z <= r["ub"][0] + tol * (1.0 + np.abs(r["ub"][0])))
    assert rel(float(r["c"][0] @ z), jo) <= TOL
