"""Port parity: bundling (`mpisppy_tpu_torch/utils/bundles.py`), the
bundle files (`utils/pickle_bundle.py`), aircondB (`models/aircondB.py`)
and `variable_probability` (`spbase`, `phbase.compute_xbar`,
`spopt.check_W_bound_supported`, `convert.py`), against the JAX
package, float64, on the CPU.

* `bundle_batch` of a two-stage batch with matrix-uncertainty
  coordinates (farmer-6 by 2), a multistage one (aircond (3, 2) by 2,
  proper bundles) and a shared-A one (uc by 4, which stays shared):
  every array, the tree and the remapped `A_delta_idx` equal the JAX
  package's exactly; a bundle that splits a subtree raises the same
  error.
* The `.npz` bundle file round-trips across the packages both ways.
* aircondB: its bundle files written and read back by the port equal
  the built batch; PH on the bundles agrees with the JAX package's PH
  at every iteration (conv, E[obj], x̄) to 1e-6; the amalgamator runs
  aircondB's EF, and its objective is the multistage EF's.
* variable_probability: x̄ under non-uniform (S, K) weights agrees to
  1e-12; the sum warning, the shape error and the refused W-based
  bound are the JAX package's; `convert.batch_from_arrays` carries
  var_prob.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest

from mpisppy_tpu.models import aircond as jaircond
from mpisppy_tpu.models import aircondB as jaircondB
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import uc as juc
from mpisppy_tpu.opt.ph import PH as JPH
from mpisppy_tpu.utils import bundles as jbundles
from mpisppy_tpu.utils import pickle_bundle as jpickle
from mpisppy_tpu_torch.convert import batch_from_arrays, to_arrays
from mpisppy_tpu_torch.device import host
from mpisppy_tpu_torch.models import aircond, aircondB, farmer, uc
from mpisppy_tpu_torch.opt.ef import ExtensiveForm
from mpisppy_tpu_torch.opt.ph import PH
from mpisppy_tpu_torch.utils import amalgamator, bundles, config
from mpisppy_tpu_torch.utils import pickle_bundle
from torch_parity import ONE, one_torch_thread, rel  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = ("c", "qdiag", "A", "row_lo", "row_hi", "lb", "ub", "obj_const",
          "nonant_idx", "integer_mask")


def assert_same(t, j):
    for f in FIELDS:
        a, b = host(getattr(t, f)), np.asarray(getattr(j, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(host(t.tree.node_of),
                                  np.asarray(j.tree.node_of))
    np.testing.assert_array_equal(host(t.tree.prob),
                                  np.asarray(j.tree.prob))
    assert t.tree.num_nodes == j.tree.num_nodes
    assert tuple(t.tree.stage_of) == tuple(j.tree.stage_of)
    assert t.tree.nonant_names == j.tree.nonant_names
    assert t.tree.scen_names == j.tree.scen_names
    assert t.var_names == j.var_names
    assert t.stage_cost_c is None and j.stage_cost_c is None


@pytest.mark.parametrize("case", ["farmer_6_by_2", "aircond_3x2_by_2",
                                  "uc_shared_by_4"])
def test_bundle_batch_equals_jax(case):
    if case == "farmer_6_by_2":
        t, j, m = farmer.build_batch(6, device="cpu"), \
            jfarmer.build_batch(6), 2
    elif case == "aircond_3x2_by_2":
        t, j, m = aircond.build_batch((3, 2), device="cpu"), \
            jaircond.build_batch((3, 2)), 2
    else:
        t, j, m = uc.build_batch(8, H=4, device="cpu"), \
            juc.build_batch(8, H=4), 4
        assert t.shared_A
    tb, jb = bundles.bundle_batch(t, m), jbundles.bundle_batch(j, m)
    assert_same(tb, jb)
    assert tb.shared_A == jb.shared_A
    tm, jm = tb.model_meta, jb.model_meta
    if isinstance(jm, dict) and "A_delta_idx" in jm:
        for a, b in zip(tm["A_delta_idx"], jm["A_delta_idx"]):
            np.testing.assert_array_equal(a, b)
    else:
        assert not (isinstance(tm, dict) and "A_delta_idx" in tm)


def test_improper_bundle_raises_as_jax():
    msgs = []
    for mod, bmod in ((aircond, bundles), (jaircond, jbundles)):
        kw = {"device": "cpu"} if mod is aircond else {}
        with pytest.raises(ValueError, match="entire subtrees") as e:
            bmod.bundle_batch(mod.build_batch((3, 2), **kw), 3)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_npz_round_trip_across_packages(tmp_path):
    t = bundles.bundle_batch(farmer.build_batch(6, device="cpu"), 2)
    j = jbundles.bundle_batch(jfarmer.build_batch(6), 2)
    pickle_bundle.dill_pickle(t, tmp_path / "port")
    jpickle.dill_pickle(j, tmp_path / "jax")
    # the JAX package reads the port's file, the port the JAX package's
    assert_same(pickle_bundle.dill_unpickle(tmp_path / "jax",
                                            device="cpu"), j)
    back = jpickle.dill_unpickle(str(tmp_path / "port"))
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(j, f)),
                                      err_msg=f)
    assert back.tree.scen_names == j.tree.scen_names


def test_aircondB_files_round_trip(tmp_path):
    d = str(tmp_path / "bundles")
    bb = aircondB.build_batch((3, 2), pickle_bundles_dir=d, device="cpu")
    back = aircondB.build_batch((3, 2), unpickle_bundles_dir=d,
                                device="cpu")
    jback = jaircondB.build_batch((3, 2), unpickle_bundles_dir=d)
    for f in FIELDS:
        np.testing.assert_array_equal(host(getattr(back, f)),
                                      host(getattr(bb, f)), err_msg=f)
        np.testing.assert_array_equal(np.asarray(getattr(jback, f)),
                                      host(getattr(bb, f)), err_msg=f)
    assert aircondB.bundle_names(6, 2) == jaircondB.bundle_names(6, 2)


def _rec_ph(cls):
    class Rec(cls):
        def ph_iteration(self):
            conv = super().ph_iteration()
            self.rec = getattr(self, "rec", [])
            self.rec.append((float(conv),
                             float(self.Eobjective(self.state.obj)),
                             np.array(host(self.state.xbar))))
            return conv
    return Rec


def test_aircondB_ph_matches_jax():
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 8, "convthresh": 0.0,
            "pdhg_eps": 1e-7}
    names = aircondB.scenario_names_creator(6, scenarios_per_bundle=2)
    j = _rec_ph(JPH)(dict(opts), names, batch=jaircondB.build_batch(
        (3, 2)), mesh=ONE)
    j.ph_main()
    from mpisppy_tpu_torch.convert import prep_from_arrays
    t = _rec_ph(PH)(dict(opts), names, batch=aircondB.build_batch(
        (3, 2), device="cpu"), device="cpu",
        prep=prep_from_arrays(to_arrays(j.prep), device="cpu"))
    t.ph_main()
    assert len(t.rec) == len(j.rec) == opts["PHIterLimit"]
    for k, (a, b) in enumerate(zip(t.rec, j.rec)):
        for x, y in zip(a, b):
            assert rel(x, y) <= 1e-6, (k, a, b)
    assert rel(t.trivial_bound, j.trivial_bound) <= 1e-6


def test_aircondB_amalgamator_ef():
    cfg = config.Config()
    for g in ("popular_args", "ph_args", "ef_args"):
        getattr(cfg, g)()
    aircondB.inparser_adder(cfg)
    am = amalgamator.from_module(aircondB, cfg, args=[
        "--EF", "--branching-factors", "3,2", "--solver-eps", "1e-7",
        "--solver-max-iters", "100000"], device="cpu")
    am.run()
    ef = ExtensiveForm({"pdhg_eps": 1e-7, "pdhg_max_iters": 100000},
                       [f"s{i}" for i in range(6)],
                       batch=aircond.build_batch((3, 2), device="cpu"),
                       device="cpu")
    ef.solve_extensive_form()
    assert am.ef.batch.num_scens == 3
    assert am.ef.get_objective_value() == pytest.approx(
        ef.get_objective_value(), rel=1e-5)


# ---- variable_probability -------------------------------------------------

S = 3
NAMES = [f"scen{i}" for i in range(S)]
OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 3, "convthresh": 0.0,
        "pdhg_eps": 1e-7}


def _vp(K):
    rng = np.random.default_rng(7)
    vp = rng.uniform(0.2, 1.0, (S, K))
    return vp / vp.sum(axis=0, keepdims=True)


def test_var_prob_xbar_matches_jax():
    from mpisppy_tpu.phbase import compute_xbar as jcompute_xbar
    from mpisppy_tpu_torch.phbase import compute_xbar
    jb = jfarmer.build_batch(S)
    vp = _vp(jb.num_nonants)
    j = JPH(dict(OPTS), NAMES, batch=jb, variable_probability=vp,
            mesh=ONE)
    j.ph_main()
    from mpisppy_tpu_torch.convert import prep_from_arrays
    t = PH(dict(OPTS), NAMES, batch=farmer.build_batch(S, device="cpu"),
           variable_probability=lambda b: vp, device="cpu",
           prep=prep_from_arrays(to_arrays(j.prep), device="cpu"))
    t.ph_main()
    np.testing.assert_array_equal(host(t.batch.var_prob),
                                  np.asarray(j.batch.var_prob))
    assert rel(host(t.state.xbar), np.asarray(j.state.xbar)) <= 1e-6
    # x̄ of the same x to 1e-12, and against a numpy weighting
    x = np.asarray(j.batch.nonants(j.state.x))
    import torch
    xb, xsq = compute_xbar(t.batch, torch.as_tensor(np.array(x)))
    jxb, jxsq = jcompute_xbar(j.batch, x)
    assert rel(host(xb), np.asarray(jxb)) <= 1e-12
    assert rel(host(xsq), np.asarray(jxsq)) <= 1e-12
    want = (vp * x).sum(axis=0) / vp.sum(axis=0)
    assert rel(host(xb)[0], want) <= 1e-12


def test_var_prob_warning_and_errors_match_jax():
    outs = []
    for cls, mod, kw in ((PH, farmer, {"device": "cpu"}),
                         (JPH, jfarmer, {"mesh": ONE})):
        b = mod.build_batch(S, **({"device": "cpu"} if mod is farmer
                                  else {}))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ph = cls(dict(OPTS), NAMES, batch=b, variable_probability=(
                np.full((S, b.num_nonants), 0.5)), **kw)
        warn = [ln.split("] ", 1)[1] for ln in buf.getvalue().splitlines()
                if "variable_probability" in ln]
        with pytest.raises(ValueError) as shape_err:
            cls(dict(OPTS), NAMES, batch=b,
                variable_probability=np.ones((S, 2)), **kw)
        ph.Iter0()
        with pytest.raises(NotImplementedError) as bound_err:
            ph.lagrangian_bound()
        outs.append((warn, str(shape_err.value), str(bound_err.value)))
    assert outs[0] == outs[1]
    assert len(outs[0][0]) == 1


def test_convert_carries_var_prob():
    jb = jfarmer.build_batch(S)
    vp = _vp(jb.num_nonants)
    jb = dataclasses.replace(jb, var_prob=vp)
    tb = batch_from_arrays(to_arrays(jb), device="cpu")
    np.testing.assert_array_equal(host(tb.var_prob), vp)
    assert bundles.bundle_batch is not None
    with pytest.raises(ValueError, match="variable_probability"):
        bundles.bundle_batch(tb, 3)
