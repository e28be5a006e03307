"""Port parity: the modelling layer and the model corpus
(`mpisppy_tpu_torch/model.py`, `ir.stack_scenarios`,
`ir.pad_scenarios`, `spbase`'s `scenario_creator` path and
`models/`) against the JAX package, on the CPU.

* Every ported builder's arrays equal the JAX builder's exactly, one
  case per model (the random draws of aircond, battery, netdes, gbd
  and usar included), at the shapes of examples/run_all.py's rows.
* `LinearModel.lower` equals the JAX one; farmer's and hydro's
  `scenario_creator`, stacked, equal their `build_batch` exactly and
  JAX's `stack_scenarios` of the JAX creators; `SPBase(
  scenario_creator=...)` builds the same batch as the JAX SPBase (the
  stacked probabilities within 2 ulp: see
  `torch_parity.assert_same_batch`).
* `pad_scenarios` of a dense, a shared and a SplitA batch equals JAX's.
* `xhat_generator_aircond` (an EF through the port's opt/ef) returns
  the JAX package's stage-1 decisions.
* `stack_scenarios` refuses mismatched shapes and nonant layouts.
* What was refused and is ported since constructs and runs: the MIP
  extensive form that usar's integer model needs and aircondB (item
  10), acopf3's SOC relaxation (9) and aircond's `scenario_source`
  (12).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpisppy_tpu import ir as jir
from mpisppy_tpu import model as jmodel
from mpisppy_tpu.models import aircond as jaircond
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import hydro as jhydro
from mpisppy_tpu.parallel.mesh import ScenarioMesh
from mpisppy_tpu.spbase import SPBase as JSPBase
from mpisppy_tpu_torch import ir, model
from mpisppy_tpu_torch.device import host
from mpisppy_tpu_torch.models import acopf3, aircond, aircondB, farmer, hydro
from mpisppy_tpu_torch.ops import pdhg
from mpisppy_tpu_torch.opt import mip
from mpisppy_tpu_torch.spbase import SPBase
from mpisppy_tpu_torch.utils import amalgamator, config
from torch_parity import assert_same_batch

FIELDS = ("c", "qdiag", "A", "row_lo", "row_hi", "lb", "ub", "obj_const",
          "nonant_idx", "integer_mask", "stage_cost_c")
TREE = ("node_of", "prob")



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small cases: more intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (module, positional num_scens or None, keyword arguments): the
# examples/run_all.py rows' sizes, and the variants that draw otherwise
BUILDERS = [
    ("hydro", None, {"branching_factors": (3, 3)}),
    ("aircond", None, {"branching_factors": (3, 2)}),
    ("aircond", None, {"branching_factors": (2, 2, 2), "start_ups": True,
                       "QuadShortCoeff": 0.3, "start_seed": 7}),
    ("acopf3", None, {"branching_factors": (2, 2)}),
    ("acopf3", None, {"branching_factors": (3, 2, 2), "case": "ieee14"}),
    ("sizes", 3, {}),
    ("sizes", 10, {"tighten": False, "dtype": np.float32}),
    ("apl1p", 4, {}),
    ("battery", 8, {}),
    ("netdes", 5, {}),
    ("gbd", 10, {}),
    ("usar", 3, {}),
]


@pytest.mark.parametrize(
    "mod,num_scens,kw", BUILDERS,
    ids=[f"{m}-{i}" for i, (m, _, _) in enumerate(BUILDERS)])
def test_builder_equals_jax(mod, num_scens, kw):
    tm = importlib.import_module(f"mpisppy_tpu_torch.models.{mod}")
    jm = importlib.import_module(f"mpisppy_tpu.models.{mod}")
    args = () if num_scens is None else (num_scens,)
    t = tm.build_batch(*args, device="cpu", **kw)
    assert t.c.device.type == "cpu"
    assert_same_batch(t, jm.build_batch(*args, **kw))


def test_linear_model_lower_equals_jax():
    """A model with every feature of the API: blocks, a scalar, an
    integer block, a LinearExpr with a constant, vectorized rows,
    three stages' costs, maximize, padded rows, node ids."""
    def build(mod):
        m = mod.LinearModel(sense=-1)
        x = m.add_vars("x", (2, 3), lb=-1.0, ub=[1, 2, 3, 4, 5, 6])
        z = m.add_var("z", lb=0.0, ub=10.0, integer=True)
        m.add_constr({x[0, 0]: 1.0, x[1, 2]: -2.0, z: 0.5}, lo=-3.0,
                     hi=4.0)
        m.add_constr(mod.LinearExpr({x[0, 1]: 2.0}, const=1.5), hi=6.0)
        m.add_constr_rows([[1.0, 1.0], [2.0, -1.0]], [[0, 1], [2, 3]],
                          lo=[0.0, -1.0], hi=[5.0, 7.0])
        m.add_cost(1, {x[0, 0]: 3.0, z: 1.0}, const=2.0)
        m.add_cost(2, mod.LinearExpr({x[1, 1]: -1.0}, const=0.5))
        m.add_cost(3, {x[1, 2]: 4.0, x[0, 0]: 1.0})
        m.set_nonants([x], stage=1)
        m.set_nonants([m._blocks["z"]], stage=2)
        return m

    kw = dict(prob=0.25, name="s7", node_ids=[0] * 6 + [2], num_nodes=3,
              pad_rows_to=6)
    t = build(model).lower(device="cpu", **kw)
    assert_same_batch(t, build(jmodel).lower(**kw))
    assert t.num_rows == 6 and t.tree.num_nodes == 3


@pytest.mark.parametrize("which", ["farmer", "hydro"])
def test_creators_stack_to_build_batch(which):
    """Stacked through stack_scenarios, the creators equal build_batch
    (exactly) and JAX's stack of the JAX creators."""
    if which == "farmer":
        names = farmer.scenario_names_creator(6)
        kw = {"crops_multiplier": 2, "num_scens": 6}
        mods, fast = (farmer, jfarmer), farmer.build_batch(
            6, crops_multiplier=2, split=False, device="cpu")
    else:
        names = hydro.scenario_names_creator(9)
        kw = {"branching_factors": [3, 3]}
        mods, fast = (hydro, jhydro), hydro.build_batch(device="cpu")
    t = ir.stack_scenarios([mods[0].scenario_creator(n, device="cpu", **kw)
                            for n in names], scen_names=names)
    j = jir.stack_scenarios([mods[1].scenario_creator(n, **kw)
                             for n in names], scen_names=names)
    assert_same_batch(t, j, prob_ulps=2)
    for f in FIELDS:
        np.testing.assert_array_equal(host(getattr(t, f)),
                                      host(getattr(fast, f)))
    for f in TREE:
        np.testing.assert_array_equal(host(getattr(t.tree, f)),
                                      host(getattr(fast.tree, f)))
    assert t.tree.num_nodes == fast.tree.num_nodes


@pytest.mark.parametrize("which", ["farmer", "hydro"])
def test_spbase_creator_path_equals_jax(which):
    if which == "farmer":
        names, creator, jcreator = (farmer.scenario_names_creator(3),
                                    farmer.scenario_creator,
                                    jfarmer.scenario_creator)
        kw = {"crops_multiplier": 1, "num_scens": 3}
    else:
        names, creator, jcreator = (hydro.scenario_names_creator(9),
                                    hydro.scenario_creator,
                                    jhydro.scenario_creator)
        kw = {"branching_factors": [3, 3]}
    t = SPBase({}, names, scenario_creator=creator,
               scenario_creator_kwargs=dict(kw), device="cpu")
    j = JSPBase({}, names, scenario_creator=jcreator,
                scenario_creator_kwargs=dict(kw),
                mesh=ScenarioMesh(devices=jax.devices()[:1]))
    assert t.batch.c.device.type == "cpu" and t.n_real_scens == len(names)
    assert_same_batch(t.batch, j.batch, prob_ulps=2)
    with pytest.raises(ValueError, match="batch or a scenario_creator"):
        SPBase({}, names, device="cpu")


def test_aircond_xhat_generator_matches_jax(monkeypatch):
    """xhat_generator_aircond solves the sampled tree's EF with the
    port's opt/ef: the stage-1 decisions equal the JAX package's (the
    EF's power iteration started from the JAX PRNGKey draw)."""
    def jax_draw(shape, dtype, device, seed=0):
        jd = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
        return torch.tensor(np.asarray(jax.random.normal(
            jax.random.PRNGKey(seed), shape, jd)), device=device)

    monkeypatch.setattr(pdhg, "normal_draw", jax_draw)
    names = aircond.scenario_names_creator(6, start=4)
    kw = {"branching_factors": (3, 2),
          "solver_options": {"pdhg_eps": 1e-8}}
    got = aircond.xhat_generator_aircond(names, device="cpu", **kw)
    want = np.asarray(jaircond.xhat_generator_aircond(names, **kw))
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="scenario names"):
        aircond.xhat_generator_aircond(names[:5], device="cpu", **kw)


def _pad_cases():
    dense = farmer.build_batch(3, split=False, device="cpu")
    jdense = jfarmer.build_batch(3, split=False)
    return {
        "dense": (dense, jdense),
        "shared": (dataclasses.replace(dense, A=dense.A[:1]),
                   dataclasses.replace(jdense, A=jdense.A[:1])),
        "split": (farmer.build_batch(3, split=True, device="cpu"),
                  jfarmer.build_batch(3, split=True)),
        "multistage": (hydro.build_batch(device="cpu"),
                       jhydro.build_batch()),
    }


@pytest.mark.parametrize("form", ["dense", "shared", "split",
                                  "multistage"])
def test_pad_scenarios_equals_jax(form):
    t, j = _pad_cases()[form]
    to = t.num_scens + 5
    tp, jp = ir.pad_scenarios(t, to), jir.pad_scenarios(j, to)
    assert_same_batch(tp, jp)
    assert tp.num_scens == to and tp.tree.num_nodes == t.tree.num_nodes + 1
    assert float(tp.prob[t.num_scens:].abs().sum()) == 0.0
    if form == "shared":
        assert tp.A is t.A                    # pads reuse the matrix
    if form == "split":
        assert torch.equal(tp.A.shared, t.A.shared)
        assert float(tp.A.vals[t.num_scens:].abs().sum()) == 0.0
    assert ir.pad_scenarios(t, t.num_scens) is t


def test_stack_scenarios_refuses_mismatches():
    a = farmer.scenario_creator("scen0", device="cpu")
    b = farmer.scenario_creator("scen1", crops_multiplier=2, device="cpu")
    with pytest.raises(ValueError, match="share"):
        ir.stack_scenarios([a, b])
    c = dataclasses.replace(a, nonant_idx=a.nonant_idx.flip(0))
    with pytest.raises(ValueError, match="nonant"):
        ir.stack_scenarios([a, c])
    with pytest.raises(ValueError, match="no scenarios"):
        ir.stack_scenarios([])
    # unnormalized probabilities (creators without num_scens) sum to 1
    s = ir.stack_scenarios([farmer.scenario_creator(f"scen{i}",
                                                    device="cpu")
                            for i in range(4)])
    assert torch.equal(s.prob, torch.full((4,), 0.25, dtype=s.prob.dtype))


def _cfg():
    cfg = config.Config()
    for g in ("popular_args", "ph_args", "ef_args"):
        getattr(cfg, g)()
    return cfg


@pytest.mark.parametrize("case", ["aircond.scenario_source",
                                  "opt.mip.ExtensiveFormMIP",
                                  "aircondB.build_batch",
                                  "aircondB.amalgamator",
                                  "acopf3.soc"])
def test_still_refused_name_their_item(case):
    """What is still refused names its item; the parts ported since
    (the MIP EF, aircondB, acopf3's SOC relaxation) now construct or
    run."""
    if case == "opt.mip.ExtensiveFormMIP":
        # usar's integer model, the MIP EF's first user in the corpus
        from mpisppy_tpu_torch.models import usar
        b = usar.build_batch(2, time_horizon=3, device="cpu")
        ef = mip.ExtensiveFormMIP({}, list(b.tree.scen_names), batch=b,
                                  device="cpu")
        assert ef.consensus.num_nodes == b.tree.num_nodes
        return
    if case == "aircondB.build_batch":
        bb = aircondB.build_batch((3, 2), device="cpu")
        assert bb.num_scens == 3 and int(bb.tree.node_of.max()) == 0
        return
    if case == "aircondB.amalgamator":
        am = amalgamator.from_module(aircondB, _cfg(), args=["--EF"],
                                     device="cpu")
        am.run()
        assert am.ef.batch.num_scens == 3
        return
    if case == "acopf3.soc":
        # the SOC relaxation (queue A item 9's residual) is ported: the
        # builder, the violation and one round of cuts run (held to
        # the JAX package in tests/test_torch_soc.py)
        b = acopf3.build_soc_batch((2, 2), device="cpu")
        assert b.model_meta["soc_cut_slots"] == 6
        x = b.ub * 0.5
        v = acopf3.soc_violation(b, x)
        assert v.shape == (4, 3, 6) and np.all(v[b.model_meta[
            "soc_alive"] == 0] == 0.0)
        b2, mv, n = acopf3.add_soc_cuts(b, x, 0)
        assert n > 0 and mv == v.max() and b2.A.shape == b.A.shape
        return
    # aircond.scenario_source (queue A item 12) is ported: it serves
    # blocks of the host-built tree (held to the JAX package in
    # tests/test_torch_streaming.py)
    src = aircond.scenario_source(6, {"branching_factors": "3,2"})
    blk = src.block([0, 5])
    assert src.total_scens == 6 and blk.num_scens == 2
    assert blk.c.device.type == "cpu"
