"""Port parity: FWPH (`mpisppy_tpu_torch/fwph/fwph.py`), its spoke
(`cylinders/fwph_spoke.py`) and vanilla's `fwph_spoke`, against the
JAX package on farmer-3, float64, on the CPU.

* `FWPH.fwph_main` with a column bank of 3 (so that columns are
  evicted): the dual bound of every outer pass agrees to 1e-6
  relative, and the bank's active mask after every pass is the same
  exactly.  The port solves on the JAX package's PreparedBatch and
  every hull-QP prep starts its power iteration from the JAX PRNGKey
  draw.
* A PH hub with the FWPH spoke, interleaved: the bound trace at every
  sync agrees to 1e-6; the spoke's bound is below the optimum.
* `--fwph` on the command line selects the spoke through
  `vanilla.build_spokes`, with the `fwph` solver root.
"""

import numpy as np
import pytest

from mpisppy_tpu.cylinders import hub as jhub
from mpisppy_tpu.cylinders.fwph_spoke import (
    FrankWolfeOuterBound as JFrankWolfe)
from mpisppy_tpu.fwph.fwph import FWPH as JFWPH
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.opt.ph import PH as JPH
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
from mpisppy_tpu_torch.convert import prep_from_arrays, to_arrays
from mpisppy_tpu_torch.cylinders import hub
from mpisppy_tpu_torch.cylinders.fwph_spoke import FrankWolfeOuterBound
from mpisppy_tpu_torch.fwph.fwph import FWPH
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.opt.ph import PH
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.utils import config, vanilla
from torch_parity import (ONE, TOL, assert_traces_match, jax_draw,  # noqa
                          one_torch_thread, rel, tracing)

pytestmark = pytest.mark.usefixtures("jax_draw", "one_torch_thread")

S = 3
NAMES = [f"scen{i}" for i in range(S)]
OPTIMUM = -108390.0
OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 4, "convthresh": 0.0,
        "pdhg_eps": 1e-7, "FW_iter_limit": 2, "column_bank": 3}


def _record(opt):
    opt.masks.append(np.array(opt._active))
    opt.lams.append(np.array(opt._lam))


class _TRec(FWPH):
    def fwph_iteration(self):
        self.masks = getattr(self, "masks", [])
        self.lams = getattr(self, "lams", [])
        conv = super().fwph_iteration()
        _record(self)
        return conv


class _JRec(JFWPH):
    def fwph_iteration(self):
        self.masks = getattr(self, "masks", [])
        self.lams = getattr(self, "lams", [])
        conv = super().fwph_iteration()
        _record(self)
        return conv


@pytest.fixture(scope="module")
def runs(jax_draw, one_torch_thread):
    j = _JRec(dict(OPTS), NAMES, batch=jfarmer.build_batch(S), mesh=ONE)
    jout = j.fwph_main()
    t = _TRec(dict(OPTS), NAMES, batch=farmer.build_batch(S, device="cpu"),
              device="cpu",
              prep=prep_from_arrays(to_arrays(j.prep), device="cpu"))
    tout = t.fwph_main()
    return t, j, tout, jout


def test_every_pass_matches_jax(runs):
    t, j, tout, jout = runs
    assert len(t._dual_bounds) == len(j._dual_bounds) == OPTS["PHIterLimit"]
    for k, (a, b) in enumerate(zip(t._dual_bounds, j._dual_bounds)):
        assert rel(a, b) <= TOL, (k, a, b)
    # the bank bookkeeping: the same slots filled and evicted
    for k, (a, b) in enumerate(zip(t.masks, j.masks)):
        np.testing.assert_array_equal(a, b, err_msg=f"pass {k}")
    assert t._active.all()      # the 3-column bank filled up
    assert t.sdm_early_stops == j.sdm_early_stops
    for x, y in zip(tout, jout):
        assert rel(x, y) <= TOL
    assert rel(t._V, j._V) <= TOL
    assert t.dual_bound <= OPTIMUM + 1.0


def test_column_eviction_matches_jax():
    """_add_columns on a partly full bank: the first free slot, else
    the column of least hull weight (the first one on ties), as the JAX
    package's per-scenario loop does."""
    x_new = np.random.default_rng(0).standard_normal((4, 2))
    banks = []
    for cls in (FWPH, JFWPH):
        opt = cls.__new__(cls)
        opt._V = np.zeros((4, 3, 2))
        opt._active = np.array([[1, 1, 1], [1, 0, 1], [0, 0, 0],
                                [1, 1, 1]], bool)
        opt._lam = np.array([[0.5, 0.2, 0.3], [0.1, 0.0, 0.9],
                             [0.0, 0.0, 0.0], [0.4, 0.2, 0.2]])
        opt._add_columns(x_new)
        banks.append((opt._active, opt._lam, opt._V))
    for t, j in zip(*banks):
        np.testing.assert_array_equal(t, j)


def _wheel(hub_cls, hub_opt, spoke_cls, spoke_opt, batch, **kw):
    opts = dict(OPTS, PHIterLimit=3)
    return ({"hub_class": tracing(hub_cls), "opt_class": hub_opt,
             "hub_kwargs": {"options": {"rel_gap": 1e-5}},
             "opt_kwargs": {"options": dict(opts),
                            "all_scenario_names": NAMES, "batch": batch,
                            **kw}},
            [{"spoke_class": spoke_cls, "opt_class": spoke_opt,
              "opt_kwargs": {"options": dict(opts),
                             "all_scenario_names": NAMES}}])


def test_fwph_spoke_wheel_matches_jax():
    jws = JWheelSpinner(*_wheel(jhub.PHHub, JPH, JFrankWolfe, JFWPH,
                                jfarmer.build_batch(S), mesh=ONE)).spin()
    prep = prep_from_arrays(to_arrays(jws.spcomm.opt.prep), device="cpu")
    tws = WheelSpinner(*_wheel(hub.PHHub, PH, FrankWolfeOuterBound, FWPH,
                               farmer.build_batch(S, device="cpu"),
                               device="cpu", prep=prep)).spin()
    assert_traces_match(tws.spcomm.trace, jws.spcomm.trace)
    sp = tws.spcomm.spokes[0]
    assert rel(sp.bound, jws.spcomm.spokes[0].bound) <= TOL
    assert sp.bound <= OPTIMUM + 1.0
    # the spoke's best bound never decreases
    db = np.maximum.accumulate(sp.opt._dual_bounds)
    assert sp.bound == db[-1]
    assert tws.spcomm.failed_spokes == []


def test_fwph_flag_selects_the_spoke():
    cfg = config.Config()
    for g in ("popular_args", "ph_args", "fwph_args"):
        getattr(cfg, g)()
    cfg.parse_command_line("fwph", args=["--fwph"])
    cfg["fwph_solver_eps"] = 1e-5
    spokes = vanilla.build_spokes(cfg, None, None, NAMES)
    assert [d["spoke_class"] for d in spokes] == [FrankWolfeOuterBound]
    assert spokes[0]["opt_class"] is FWPH
    assert spokes[0]["opt_kwargs"]["options"]["pdhg_eps"] == 1e-5
