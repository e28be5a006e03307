"""Port parity: PH on farmer through `mpisppy_tpu_torch` against the
JAX package, float64 on the CPU.

* trajectory: both sides run farmer-3 from the same PreparedBatch (the
  JAX prep, carried over with `convert.prep_from_arrays` through
  `PH(prep=)`), so every superstep solves the same problems with the
  same step sizes.  The trivial bound, conv, E[obj] and xbar agree
  within 1e-6 relative at Iter0 and each of the first 8 iterations, and
  so does the Lagrangian bound.  `evaluate_xhat` builds its own reduced
  prep on each side, whose power-iteration start vectors differ
  (PRNGKey(0) against a torch.Generator), so its E[obj] is held to the
  KKT tolerance instead: 1e-5 relative at pdhg_eps 1e-7.
* goldens: the port alone reproduces tests/test_ph_farmer.py:33-66.
"""

import numpy as np
import pytest

import jax

from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.opt.ph import PH as JPH
from mpisppy_tpu.parallel.mesh import ScenarioMesh
from mpisppy_tpu_torch.convert import (batch_from_arrays, prep_from_arrays,
                                       state_from_arrays, to_arrays)
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.opt.ph import PH

NAMES = [f"scen{i}" for i in range(3)]
N_ITERS = 8


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


def _row(ph, bound):
    return {"bound": bound, "conv": ph.conv,
            "eobj": float(ph.Eobjective(ph.state.obj)),
            "xbar": np.asarray(ph.root_xbar())}


@pytest.fixture(scope="module")
def pair():
    opts = {"defaultPHrho": 1.0, "PHIterLimit": N_ITERS,
            "convthresh": 0.0, "pdhg_eps": 1e-7, "no_split_prep": True}
    jph = JPH(opts, NAMES, batch=jfarmer.build_batch(3),
              mesh=ScenarioMesh(devices=jax.devices()[:1]))
    tph = PH(opts, NAMES, batch=farmer.build_batch(3, device="cpu"),
             device="cpu",
             prep=prep_from_arrays(to_arrays(jph.prep), device="cpu"))
    traj = {}
    for key, ph in (("jax", jph), ("torch", tph)):
        rows = [_row(ph, ph.Iter0())]
        for _ in range(N_ITERS):
            ph.ph_iteration()
            rows.append(_row(ph, None))
        traj[key] = rows
    return jph, tph, traj


def test_trajectory_matches_jax(pair):
    _, _, traj = pair
    assert _rel(traj["torch"][0]["bound"], traj["jax"][0]["bound"]) <= 1e-6
    for k, (t, j) in enumerate(zip(traj["torch"], traj["jax"])):
        for f in ("conv", "eobj", "xbar"):
            assert _rel(t[f], j[f]) <= 1e-6, (k, f, t[f], j[f])


def test_bounds_match_jax(pair):
    jph, tph, _ = pair
    assert _rel(tph.lagrangian_bound(), jph.lagrangian_bound()) <= 1e-6
    xbar = np.asarray(jph.root_xbar())
    t_in, t_feas = tph.evaluate_xhat(xbar)
    j_in, j_feas = jph.evaluate_xhat(xbar)
    assert t_feas and j_feas
    assert _rel(t_in, j_in) <= 1e-5


def test_fix_and_unfix_nonants_match_jax(pair):
    jph, tph, _ = pair
    rng = np.random.default_rng(11)
    mask = rng.random((3, 3)) < 0.5
    vals = rng.random((3, 3)) * 100.0
    for ph in (jph, tph):
        ph.fix_nonants(mask, vals)
    for f in ("lb_eff", "ub_eff"):
        np.testing.assert_array_equal(np.asarray(getattr(tph, f)),
                                      np.asarray(getattr(jph, f)))
    for ph in (jph, tph):
        ph.unfix_nonants(np.ones((3, 3), bool))
    np.testing.assert_array_equal(tph.lb_eff.numpy(), tph.batch.lb.numpy())
    np.testing.assert_array_equal(tph.ub_eff.numpy(), tph.batch.ub.numpy())


def test_state_converts_from_jax(pair):
    jph, tph, _ = pair
    st = state_from_arrays(to_arrays(jph.state), device="cpu")
    assert st.it == int(jph.state.it) == N_ITERS
    np.testing.assert_array_equal(st.W.numpy(), np.asarray(jph.state.W))
    b = batch_from_arrays(to_arrays(jph.batch), device="cpu")
    np.testing.assert_array_equal(b.A.numpy(), tph.batch.A.numpy())
    assert b.tree.scen_names == tph.batch.tree.scen_names


# ---- goldens (the port alone; tests/test_ph_farmer.py) -------------------

@pytest.fixture(scope="module")
def ph3():
    ph = PH({"defaultPHrho": 1.0, "PHIterLimit": 200, "convthresh": 1e-5,
             "pdhg_eps": 1e-7}, NAMES,
            batch=farmer.build_batch(3, device="cpu"), device="cpu")
    ph.ph_main()
    return ph


def test_golden_trivial_bound(ph3):
    assert abs(ph3.trivial_bound - -115405.55) < 5.0


def test_golden_eobj_and_xbar(ph3):
    assert abs(float(ph3.Eobjective(ph3.state.obj)) - -108390.0) < 20.0
    assert np.allclose(ph3.root_xbar().numpy(), [170.0, 80.0, 250.0],
                       atol=0.5)


def test_golden_lagrangian_bound_valid(ph3):
    lb = ph3.lagrangian_bound()
    assert ph3.trivial_bound - 1.0 <= lb <= -108389.0


def test_golden_xhat_inner_bound(ph3):
    eobj, feas = ph3.evaluate_xhat(ph3.root_xbar().numpy())
    assert feas and abs(eobj - -108390.0) < 20.0
    bad, feas2 = ph3.evaluate_xhat(np.array([0.0, 0.0, 0.0]))
    assert feas2 and bad > eobj + 1000


def test_scenario_denouement_contract():
    seen = {}

    def denouement(rank, name, scen):
        assert rank == 0 and scen.name == name
        assert scen.x.shape == (12,) and scen.nonants.shape == (3,)
        seen[name] = (scen.obj, scen.prob)

    ph = PH({"defaultPHrho": 1.0, "PHIterLimit": 20, "convthresh": 1e-4,
             "pdhg_eps": 1e-6}, NAMES,
            batch=farmer.build_batch(3, device="cpu"), device="cpu",
            scenario_denouement=denouement)
    conv, eobj, triv = ph.ph_main()
    assert set(seen) == set(NAMES)
    assert abs(sum(p * o for o, p in seen.values()) - eobj) < 1e-6
    assert eobj >= triv - 1.0
    sol = ph.solution_dict()
    assert sol["iterations"] == int(ph.state.it) and sol["xbar"].shape == (3,)


def test_bench_options_path_hot_f32_ladder():
    """The bench's accelerator options at a small size: an f32 batch,
    the f32 hot loop, the eps ladder and promotion of the pdhg_eps=1e-5
    solves (below the f32 floor) to the full-precision pair."""
    S = 12
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 3, "convthresh": 0.0,
            "pdhg_eps": 1e-5, "superstep_eps": 1e-4,
            "lagrangian_eps": 1e-4, "pdhg_max_iters": 30000,
            "eps_ladder": {"start": 1e-3, "min": 1e-4, "couple": 0.1},
            "pdhg_hot_dtype": "f32"}
    ph = PH(opts, [f"scen{i}" for i in range(S)],
            batch=farmer.build_batch(S, crops_multiplier=2,
                                     dtype=np.float32, device="cpu"),
            device="cpu")
    triv = ph.Iter0()
    for _ in range(3):
        ph.ph_iteration()
    inner, feas = ph.evaluate_xhat(ph.root_xbar())
    outer = ph.lagrangian_bound()
    assert feas and np.isfinite([triv, inner, outer]).all()
    assert max(triv, outer) <= inner + 1e-6 * abs(inner)
    assert ph.pdhg_stats()["promotions_total"] >= 1
    assert ph.state.x.dtype == ph.batch.c.dtype


def test_bench_options_path_bf16x():
    """chip_smoke.py's bf16x phase at a small size: an f32 batch under
    hot_dtype="bf16x".  Iter0 at pdhg_eps=1e-5 (below the f32 floor)
    promotes to full precision; the ladder's PH iterations and the
    Lagrangian bound run with A stored in bfloat16."""
    S = 12
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 2, "convthresh": 0.0,
            "pdhg_eps": 1e-5, "superstep_eps": 1e-4,
            "lagrangian_eps": 1e-4, "pdhg_max_iters": 30000,
            "eps_ladder": {"start": 1e-3, "min": 1e-4, "couple": 0.1},
            "pdhg_hot_dtype": "bf16x"}
    ph = PH(opts, [f"scen{i}" for i in range(S)],
            batch=farmer.build_batch(S, crops_multiplier=2,
                                     dtype=np.float32, device="cpu"),
            device="cpu")
    triv = ph.Iter0()
    promoted = ph.pdhg_stats()["promotions_total"]
    assert promoted >= 1
    for _ in range(2):
        ph.ph_iteration()
    assert ph.pdhg_stats()["promotions_total"] == promoted
    assert ph.solve_stats()["dtype"] == "bfloat16"
    inner, feas = ph.evaluate_xhat(ph.root_xbar())
    outer = ph.lagrangian_bound()
    assert feas and np.isfinite([triv, inner, outer]).all()
    assert max(triv, outer) <= inner + 1e-6 * abs(inner)
    assert ph.state.x.dtype == ph.batch.c.dtype
