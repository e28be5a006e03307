"""Port parity: APH (`mpisppy_tpu_torch/opt/aph.py`), `APHHub` and
vanilla's `aph_hub`, against the JAX package on farmer-3, float64, on
the CPU.

* `APH.APH_main` with dispatch_frac 0.5 (two of three scenarios
  dispatched per iteration): conv, theta, phi, W, z and the dispatch
  record after every iteration agree to 1e-6 relative (the dispatch
  record exactly).  The port solves on the JAX package's
  PreparedBatch.
* The interleaved APH-hub wheel with a Lagrangian and an xhat-shuffle
  spoke: the bound trace at every sync agrees to 1e-6.  The Lagrangian
  spoke reads the W that APH mirrors into `opt.state`.
* `vanilla.aph_hub` builds the same hub dict as the JAX package's.
"""

import numpy as np
import pytest

from mpisppy_tpu.cylinders import hub as jhub
from mpisppy_tpu.cylinders.lagrangian_bounder import (
    LagrangianOuterBound as JLagrangian)
from mpisppy_tpu.cylinders.xhatshufflelooper_bounder import (
    XhatShuffleInnerBound as JShuffle)
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.opt.aph import APH as JAPH
from mpisppy_tpu.opt.ph import PH as JPH
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
from mpisppy_tpu.utils import config as jconfig
from mpisppy_tpu.utils import vanilla as jvanilla
from mpisppy_tpu.utils.xhat_eval import Xhat_Eval as JXhat_Eval
from mpisppy_tpu_torch.convert import prep_from_arrays, to_arrays
from mpisppy_tpu_torch.cylinders import hub
from mpisppy_tpu_torch.cylinders.lagrangian_bounder import (
    LagrangianOuterBound)
from mpisppy_tpu_torch.cylinders.xhatshufflelooper_bounder import (
    XhatShuffleInnerBound)
from mpisppy_tpu_torch.device import host
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.opt.aph import APH
from mpisppy_tpu_torch.opt.ph import PH
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.utils import config, vanilla
from mpisppy_tpu_torch.utils.xhat_eval import Xhat_Eval
from torch_parity import (ONE, TOL, assert_traces_match, jax_draw,  # noqa
                          one_torch_thread, rel, tracing)

pytestmark = pytest.mark.usefixtures("jax_draw", "one_torch_thread")

S = 3
NAMES = [f"scen{i}" for i in range(S)]
OPTIMUM = -108390.0
OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 10, "convthresh": 0.0,
        "pdhg_eps": 1e-7, "APHgamma": 1.0, "APHnu": 1.0,
        "dispatch_frac": 0.5}
FIELDS = ("conv", "theta", "phi", "W", "z")


def _record(st, out):
    out.append({f: np.array(host(getattr(st, f))) for f in FIELDS
                + ("last_dispatch",)})
    return st


class _TRec(APH):
    def _aph_superstep(self, *args):
        self.rec = getattr(self, "rec", [])
        return _record(super()._aph_superstep(*args), self.rec)


class _JRec(JAPH):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.rec = []
        step = self._aph_superstep
        self._aph_superstep = lambda *a: _record(step(*a), self.rec)


@pytest.fixture(scope="module")
def runs(jax_draw, one_torch_thread):
    j = _JRec(dict(OPTS), NAMES, batch=jfarmer.build_batch(S), mesh=ONE)
    jout = j.APH_main()
    t = _TRec(dict(OPTS), NAMES, batch=farmer.build_batch(S, device="cpu"),
              device="cpu",
              prep=prep_from_arrays(to_arrays(j.prep), device="cpu"))
    tout = t.APH_main()
    return t, j, tout, jout


def test_every_iteration_matches_jax(runs):
    t, j, tout, jout = runs
    assert t.n_dispatch == j.n_dispatch == 2
    assert len(t.rec) == len(j.rec) == OPTS["PHIterLimit"]
    for k, (a, b) in enumerate(zip(t.rec, j.rec)):
        np.testing.assert_array_equal(a["last_dispatch"],
                                      b["last_dispatch"])
        for f in FIELDS:
            assert rel(a[f], b[f]) <= TOL, (k, f, a[f], b[f])
    for x, y in zip(tout, jout):
        assert rel(x, y) <= TOL
    assert rel(host(t.root_z()), np.asarray(j.root_z())) <= TOL
    # the mirrored PHState the hub reads
    assert rel(host(t.state.W), np.asarray(j.state.W)) <= TOL
    assert int(t.state.it) == int(j.state.it)


def _wheel(hub_cls, opt_cls, spokes, batch, **kw):
    opts = dict(OPTS, PHIterLimit=4)
    return ({"hub_class": tracing(hub_cls), "opt_class": opt_cls,
             "hub_kwargs": {"options": {"rel_gap": 1e-5}},
             "opt_kwargs": {"options": dict(opts),
                            "all_scenario_names": NAMES, "batch": batch,
                            **kw}},
            [{"spoke_class": c, "opt_class": o,
              "opt_kwargs": {"options": dict(opts),
                             "all_scenario_names": NAMES}}
             for c, o in spokes])


def test_aph_hub_wheel_matches_jax():
    jws = JWheelSpinner(*_wheel(
        jhub.APHHub, JAPH, [(JLagrangian, JPH), (JShuffle, JXhat_Eval)],
        jfarmer.build_batch(S), mesh=ONE)).spin()
    prep = prep_from_arrays(to_arrays(jws.spcomm.opt.prep), device="cpu")
    tws = WheelSpinner(*_wheel(
        hub.APHHub, APH, [(LagrangianOuterBound, PH),
                          (XhatShuffleInnerBound, Xhat_Eval)],
        farmer.build_batch(S, device="cpu"), device="cpu",
        prep=prep)).spin()
    assert_traces_match(tws.spcomm.trace, jws.spcomm.trace)
    assert tws.spcomm.current_iteration() == jws.spcomm.current_iteration()
    assert np.isfinite(tws.BestOuterBound) and np.isfinite(
        tws.BestInnerBound)
    assert tws.BestOuterBound <= OPTIMUM + 1.0 <= tws.BestInnerBound + 2.0
    assert tws.spcomm.failed_spokes == []


def test_vanilla_aph_hub_matches_jax():
    dicts = []
    for cfgmod, van in ((config, vanilla), (jconfig, jvanilla)):
        cfg = cfgmod.Config()
        cfg.popular_args()
        cfg.ph_args()
        cfg.aph_args()
        cfg.parse_command_line("aph", args=["--dispatch-frac", "0.5"])
        dicts.append(van.aph_hub(cfg, None, None, NAMES))
    t, j = dicts
    assert t["hub_class"] is hub.APHHub and t["opt_class"] is APH
    assert t["hub_kwargs"] == j["hub_kwargs"]
    assert t["opt_kwargs"]["options"] == j["opt_kwargs"]["options"]
