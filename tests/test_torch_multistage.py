"""Port parity: multistage problems (`scenario_tree.py`, more than one
tree node in `ir.node_segment_sum`, PH, the EF's consensus spec, the
xhat spokes and the amalgamator's multistage path) against the JAX
package, float64 on the CPU.

* `MultistageTree` and `create_nodenames_from_branching_factors` give
  the JAX package's names, paths, probabilities and parents.
* Hydro PH from the same PreparedBatch (the JAX prep, carried over
  with `convert.prep_from_arrays`): the trivial bound, conv, E[obj] and
  x̄ of every (scenario, slot), i.e. per tree node, agree within 1e-6
  relative at Iter0 and every iteration; the goldens hold (trivial
  bound 180 and E[obj] 190 at 2 significant figures,
  tests/test_hydro_multistage.py:98-112).
* acopf3 (2,2), whose qdiag is nonzero: 3 PH iterations, 1e-6.
* The EF of hydro and of aircond (3,2) matches JAX to 1e-6, and its
  nonants agree within each tree node.
* An interleaved hydro wheel (PH hub, Lagrangian and XhatShuffle) gives
  the JAX wheel's bound trace at every sync to 1e-6.  Interleaved, not
  threads: the JAX package's threads-mode hydro wheel test fails on
  some hosts (ROADMAP.md §C).
* The amalgamator's multistage path builds the JAX amalgamator's batch
  from examples/run_all.py's command lines, and its `--EF` gives the
  JAX objective.

The port's power iterations start from the JAX PRNGKey draw
(`ops.pdhg.normal_draw` is replaced in this module), so preps built on
both sides take the same step sizes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpisppy_tpu import scenario_tree as jtree
from mpisppy_tpu.cylinders import hub as jhub
from mpisppy_tpu.cylinders.lagrangian_bounder import (
    LagrangianOuterBound as JLagrangian)
from mpisppy_tpu.cylinders.xhatshufflelooper_bounder import (
    XhatShuffleInnerBound as JShuffle)
from mpisppy_tpu.models import acopf3 as jacopf3
from mpisppy_tpu.models import aircond as jaircond
from mpisppy_tpu.models import hydro as jhydro
from mpisppy_tpu.opt.ef import ExtensiveForm as JExtensiveForm
from mpisppy_tpu.opt.ph import PH as JPH
from mpisppy_tpu.parallel.mesh import ScenarioMesh
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
from mpisppy_tpu.utils import amalgamator as jamalgamator
from mpisppy_tpu.utils import config as jconfig
from mpisppy_tpu.utils.xhat_eval import Xhat_Eval as JXhat_Eval
from mpisppy_tpu_torch import scenario_tree
from mpisppy_tpu_torch.convert import prep_from_arrays, to_arrays
from mpisppy_tpu_torch.cylinders import hub
from mpisppy_tpu_torch.cylinders.lagrangian_bounder import (
    LagrangianOuterBound)
from mpisppy_tpu_torch.cylinders.xhatshufflelooper_bounder import (
    XhatShuffleInnerBound)
from mpisppy_tpu_torch.device import host
from mpisppy_tpu_torch.models import acopf3, aircond, hydro
from mpisppy_tpu_torch.ops import pdhg
from mpisppy_tpu_torch.opt.ef import ExtensiveForm
from mpisppy_tpu_torch.opt.ph import PH
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.utils import amalgamator, config
from mpisppy_tpu_torch.utils.xhat_eval import Xhat_Eval

ONE = ScenarioMesh(devices=jax.devices()[:1])
TOL = 1e-6
HYDRO_NAMES = hydro.scenario_names_creator(9)
PH_OPTS = {"defaultPHrho": 1.0, "convthresh": 0.0, "pdhg_eps": 1e-8,
           "pdhg_max_iters": 40000}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
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


def round_pos_sig(x, sig=2):
    return round(x, -int(np.floor(np.log10(abs(x)))) + (sig - 1))


# ---- the tree --------------------------------------------------------------

@pytest.mark.parametrize("bfs", [[3, 3], [2, 2, 2], [4, 3, 2], [10, 10, 10]])
def test_tree_matches_jax(bfs):
    t, j = scenario_tree.MultistageTree(bfs), jtree.MultistageTree(bfs)
    assert t.nodenames == j.nodenames == \
        scenario_tree.create_nodenames_from_branching_factors(bfs)
    assert (t.num_nodes, t.num_scens, t.n_stages) == \
        (j.num_nodes, j.num_scens, j.n_stages)
    stage_of = tuple(s for s in range(1, t.n_stages) for _ in range(2))
    for s in range(0, t.num_scens, max(1, t.num_scens // 37)):
        assert t.nodes_for_scen(s) == j.nodes_for_scen(s)
        assert t.scen_probability(s) == j.scen_probability(s)
        assert t.node_of_slots(s, stage_of).tolist() == \
            j.node_of_slots(s, stage_of).tolist()
    for n in range(t.num_nodes):
        assert t.parent_of(n) == j.parent_of(n)
        assert t.stage_of_node(n) == j.stage_of_node(n)
    assert t.scens_of_node(t.num_nodes - 1) == \
        j.scens_of_node(j.num_nodes - 1)
    two = scenario_tree.two_stage_tree(4)
    assert two.num_nodes == 1 and two.num_scens == 4


# ---- PH --------------------------------------------------------------------

def _row(ph, bound):
    return {"bound": bound, "conv": ph.conv,
            "eobj": float(ph.Eobjective(ph.state.obj)),
            "xbar": host(ph.state.xbar)}


def _ph_pair(tbatch, jbatch, names, opts, n_iters):
    jph = JPH(opts, names, batch=jbatch, mesh=ONE)
    tph = PH(opts, names, batch=tbatch, device="cpu",
             prep=prep_from_arrays(to_arrays(jph.prep), device="cpu"))
    traj = {}
    for key, ph in (("jax", jph), ("torch", tph)):
        rows = [_row(ph, ph.Iter0())]
        for _ in range(n_iters):
            ph.ph_iteration()
            rows.append(_row(ph, None))
        traj[key] = rows
    return jph, tph, traj


def _assert_traj(traj):
    assert _rel(traj["torch"][0]["bound"], traj["jax"][0]["bound"]) <= TOL
    for k, (t, j) in enumerate(zip(traj["torch"], traj["jax"])):
        for f in ("conv", "eobj", "xbar"):
            assert _rel(t[f], j[f]) <= TOL, (k, f, t[f], j[f])


@pytest.fixture(scope="module")
def hydro_pair():
    opts = dict(PH_OPTS, PHIterLimit=8)
    return _ph_pair(hydro.build_batch(device="cpu"), jhydro.build_batch(),
                    HYDRO_NAMES, opts, 8)


def test_hydro_ph_matches_jax(hydro_pair):
    _assert_traj(hydro_pair[2])


def test_hydro_xbar_is_per_node(hydro_pair):
    """x̄ is one value per (tree node, slot): stage-1 slots agree across
    all 9 scenarios, stage-2 slots within each stage-2 node's 3."""
    _, tph, _ = hydro_pair
    xbar, node_of = host(tph.state.xbar), host(tph.batch.tree.node_of)
    assert tph.batch.tree.num_nodes == 4
    for n in range(4):
        cols = np.where((node_of == n).any(axis=0))[0]
        rows = np.where((node_of[:, cols] == n).all(axis=1))[0]
        assert rows.size == (9 if n == 0 else 3)
        blk = xbar[np.ix_(rows, cols)]
        assert np.array_equal(blk, np.broadcast_to(blk[0], blk.shape))
    assert not np.allclose(xbar[0, 4:], xbar[-1, 4:])


def test_hydro_ph_goldens():
    """tests/test_hydro_multistage.py:98-112 on the port alone, with its
    options (PH to convthresh 1e-6): trivial bound 180, and the
    implementable consensus' E[obj] 190 at 2 significant figures."""
    ph = PH(dict(PH_OPTS, PHIterLimit=100, convthresh=1e-6), HYDRO_NAMES,
            batch=hydro.build_batch(device="cpu"), device="cpu")
    conv, eobj, tbound = ph.ph_main()
    assert round_pos_sig(tbound, 2) == 180
    assert round_pos_sig(eobj, 2) == 190
    inner, feas = ph.evaluate_xhat(ph.state.xbar)
    assert feas and round_pos_sig(inner, 2) == 190
    outer = ph.lagrangian_bound()
    assert tbound - 1e-6 <= outer <= inner + 1e-6 * abs(inner)


def test_acopf3_qp_ph_matches_jax():
    """acopf3 (2,2): a nonzero diagonal quadratic (generator cost) on a
    3-node tree; 3 PH iterations."""
    tb = acopf3.build_batch((2, 2), device="cpu")
    assert int((tb.qdiag != 0).sum()) == 36 and tb.tree.num_nodes == 3
    opts = dict(PH_OPTS, defaultPHrho=5.0, PHIterLimit=3, pdhg_eps=1e-7)
    _, _, traj = _ph_pair(tb, jacopf3.build_batch((2, 2)),
                          acopf3.scenario_names_creator(4), opts, 3)
    _assert_traj(traj)


# ---- the extensive form ----------------------------------------------------

@pytest.mark.parametrize("which", ["hydro", "aircond"])
def test_ef_matches_jax(which):
    if which == "hydro":
        tb, jb = hydro.build_batch(device="cpu"), jhydro.build_batch()
    else:
        tb = aircond.build_batch((3, 2), device="cpu")
        jb = jaircond.build_batch((3, 2))
    names = list(tb.tree.scen_names)
    opts = {"pdhg_eps": 1e-8, "pdhg_max_iters": 60000}
    tef = ExtensiveForm(dict(opts), names, batch=tb, device="cpu")
    jef = JExtensiveForm(dict(opts), names, batch=jb, mesh=ONE)
    tef.solve_extensive_form()
    jef.solve_extensive_form()
    obj = tef.get_objective_value()
    assert _rel(obj, jef.get_objective_value()) <= TOL
    assert _rel(tef.get_root_solution(), jef.get_root_solution()) <= TOL
    if which == "hydro":
        assert abs(obj - 186.17) < 0.01
    # nonanticipativity within each node
    x_na, node_of = tef.nonants(), host(tb.tree.node_of)
    for n in range(tb.tree.num_nodes):
        sel = node_of == n
        for j in np.where(sel.any(axis=0))[0]:
            v = x_na[sel[:, j], j]
            assert np.max(np.abs(v - v[0])) <= 1e-6 * max(1.0, abs(v[0]))


# ---- the wheel -------------------------------------------------------------

def _tracing(hub_cls):
    class Tracing(hub_cls):
        def setup_hub(self):
            super().setup_hub()
            self.trace = []

        def screen_trace(self):
            self.trace.append((self.current_iteration(),
                               float(self.BestOuterBound),
                               float(self.BestInnerBound),
                               self.latest_ob_char, self.latest_ib_char))
            return super().screen_trace()

    return Tracing


def _wheel_dicts(hub_cls, ph_cls, spokes, opts, batch, **hub_kw):
    hub_dict = {"hub_class": _tracing(hub_cls),
                "hub_kwargs": {"options": {"rel_gap": 1e-5,
                                           "abs_gap": 1e-3}},
                "opt_class": ph_cls,
                "opt_kwargs": {"options": dict(opts),
                               "all_scenario_names": HYDRO_NAMES,
                               "batch": batch, **hub_kw}}
    spoke_dicts = [{"spoke_class": cls, "spoke_kwargs": {"options": {}},
                    "opt_class": ocls,
                    "opt_kwargs": {"options": dict(opts),
                                   "all_scenario_names": HYDRO_NAMES}}
                   for cls, ocls in spokes]
    return hub_dict, spoke_dicts


def test_interleaved_hydro_wheel_matches_jax():
    # early candidates are infeasible: each runs its xhat solve to the
    # cap, then the f64 certify to its own; both caps are cut so that
    # the port's host loop stays quick on the CPU
    opts = dict(PH_OPTS, PHIterLimit=5, pdhg_eps=1e-7, pdhg_max_iters=4000,
                certify_max_iters=2000)
    jws = JWheelSpinner(*_wheel_dicts(
        jhub.PHHub, JPH, [(JLagrangian, JPH), (JShuffle, JXhat_Eval)],
        opts, jhydro.build_batch(), mesh=ONE))
    jws.spin()
    tws = WheelSpinner(*_wheel_dicts(
        hub.PHHub, PH, [(LagrangianOuterBound, PH),
                        (XhatShuffleInnerBound, Xhat_Eval)],
        opts, hydro.build_batch(device="cpu"), device="cpu",
        prep=prep_from_arrays(to_arrays(jws.spcomm.opt.prep),
                              device="cpu")))
    tws.spin()
    t, j = tws.spcomm.trace, jws.spcomm.trace
    assert len(t) == len(j) > 0
    for a, b in zip(t, j):
        assert a[0] == b[0] and a[3:] == b[3:], (a, b)
        for x, y in zip(a[1:3], b[1:3]):
            assert (x == y) if not np.isfinite(y) else _rel(x, y) <= TOL
    outer, inner = tws.BestOuterBound, tws.BestInnerBound
    assert np.isfinite(outer) and np.isfinite(inner)
    assert outer <= 186.174 <= inner
    assert tws.spcomm.failed_spokes == []
    assert _rel(tws.best_nonant_solution(),
                jws.best_nonant_solution()) <= TOL


# ---- the amalgamator -------------------------------------------------------

def _cfg(mod):
    cfg = mod.Config()
    for g in ("popular_args", "ph_args", "two_sided_args",
              "lagrangian_args", "xhatshuffle_args", "ef_args"):
        getattr(cfg, g)()
    return cfg


# examples/run_all.py's multistage rows (the amalgamator's input)
RUN_ALL = {
    "hydro": ["--branching-factors", "3,3", "--max-iterations", "40",
              "--default-rho", "1", "--lagrangian", "--xhatshuffle"],
    "aircond": ["--branching-factors", "3,2", "--max-iterations", "30",
                "--default-rho", "1", "--lagrangian", "--xhatshuffle"],
    "acopf3": ["--branching-factors", "3,2,2", "--max-iterations", "10",
               "--default-rho", "5", "--case", "ieee14", "--lagrangian",
               "--xhatshuffle"],
}


@pytest.mark.parametrize("name", list(RUN_ALL))
def test_amalgamator_multistage_batch_matches_jax(name):
    mods = {"hydro": (hydro, jhydro), "aircond": (aircond, jaircond),
            "acopf3": (acopf3, jacopf3)}[name]
    ta = amalgamator.from_module(mods[0], _cfg(config), args=RUN_ALL[name],
                                 device="cpu")
    ja = jamalgamator.from_module(mods[1], _cfg(jconfig),
                                  args=RUN_ALL[name])
    tb, tnames = ta._make_batch_and_names()
    jb, jnames, _, _ = ja._make_batch_and_names()
    assert tnames == jnames and tb.num_scens == len(tnames)
    for f in ("c", "qdiag", "A", "row_lo", "row_hi", "lb", "ub"):
        np.testing.assert_array_equal(host(getattr(tb, f)),
                                      np.asarray(getattr(jb, f)))
    np.testing.assert_array_equal(host(tb.tree.node_of),
                                  np.asarray(jb.tree.node_of))
    assert tb.tree.num_nodes == jb.tree.num_nodes > 1


def test_amalgamator_multistage_ef_matches_jax():
    args = ["--branching-factors", "3,3", "--EF", "--EF-solver-eps", "1e-8"]
    ta = amalgamator.from_module(hydro, _cfg(config), args=args,
                                 device="cpu").run()
    ja = jamalgamator.from_module(jhydro, _cfg(jconfig), args=args).run()
    assert ta.ef.batch.tree.num_nodes == 4
    assert _rel(ta.EF_Obj, ja.EF_Obj) <= TOL
    assert _rel(ta.first_stage_solution, ja.first_stage_solution) <= TOL
    assert ta.best_outer_bound <= ta.EF_Obj + TOL * abs(ta.EF_Obj)
