"""Port parity: the uc and sslp models and the candidate-screening API
of `SPOpt` against the JAX package, float64 on the CPU.

* build_batch: every array, name and metadata entry of
  `mpisppy_tpu_torch/models/uc.py` and `models/sslp.py` equals the JAX
  package's exactly (UC shared and dense, with min_up_down and
  reserve_factor; sslp synthetic and SIPLIB sslp_5_25).
* `repair_min_up_down`, `commitment_candidate(s)`: exactly equal.
* PH on UC (S=4, H=6) with bench.py's UC options cut to 5 iterations:
  conv, E[obj] and xbar within 1e-6 relative at Iter0 and every
  iteration, and the Lagrangian bound too.  Both sides build their own
  preps; the port's power iterations start from the JAX PRNGKey draw
  (`ops.pdhg.normal_draw` is replaced in this module), so the step sizes
  agree.
* `evaluate_candidates` on the threshold candidates: objectives within
  1e-6, the same feasibility and feasible mass, with and without an
  `iters_cap`; `uc.one_opt_commitment`, screened and exhaustive: the
  same candidate and value within 1e-6.
* `fixed_nonant_bounds` with and without `upto_stage`, the small SPOpt
  helpers, and the streaming entry points of uc that stay refused.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.models import uc as juc
from mpisppy_tpu.opt.ph import PH as JPH
from mpisppy_tpu.parallel.mesh import ScenarioMesh
from mpisppy_tpu_torch.convert import to_arrays
from mpisppy_tpu_torch.models import farmer, sslp, uc
from mpisppy_tpu_torch.ops import pdhg
from mpisppy_tpu_torch.opt.ph import PH

ONE = ScenarioMesh(devices=jax.devices()[:1])
S = 4
N_ITERS = 5
# bench.py's UC options (its CPU row: f64, pdhg_eps 1e-5), 5 iterations
UC_OPTS = {"defaultPHrho": 50.0, "PHIterLimit": N_ITERS,
           "convthresh": 0.0, "pdhg_eps": 1e-5, "superstep_eps": 1e-4,
           "lagrangian_eps": 1e-4, "pdhg_max_iters": 20000,
           "iter0_infeasibility_ok": True, "iter0_certify": False,
           "certify_max_iters": 30000}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These cases are small: more intra-op threads than one only
    contend with the other test workers (several times slower under
    pytest-xdist)."""
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


def _assert_batches_equal(tb, jb):
    t, j = to_arrays(tb), to_arrays(jb)
    for f in ("c", "qdiag", "A", "row_lo", "row_hi", "lb", "ub",
              "obj_const", "nonant_idx", "integer_mask", "stage_cost_c"):
        np.testing.assert_array_equal(t[f], np.asarray(j[f]), err_msg=f)
        if f not in ("nonant_idx",):
            assert t[f].dtype == np.asarray(j[f]).dtype, f
    for f in ("node_of", "prob"):
        np.testing.assert_array_equal(t["tree"][f],
                                      np.asarray(j["tree"][f]))
    for f in ("num_nodes", "stage_of", "nonant_names", "scen_names"):
        assert tuple(np.atleast_1d(t["tree"][f])) == tuple(
            np.atleast_1d(j["tree"][f])), f
    assert t["var_names"] == j["var_names"]
    tm, jm = t["model_meta"] or {}, j["model_meta"] or {}
    assert sorted(tm) == sorted(jm)
    for k in tm:
        np.testing.assert_array_equal(np.asarray(tm[k]), np.asarray(jm[k]))


@pytest.mark.parametrize("kw", [
    {"H": 6}, {"H": 6, "shared_A": False},
    {"H": 5, "min_up_down": True, "reserve_factor": 0.25},
    {"H": 4, "fleet_multiplier": 2, "dtype": np.float32},
    {"H": 6, "n_units": 2, "seed": 7},
], ids=["shared", "dense", "mud_reserve", "fleet2_f32", "n_units"])
def test_uc_build_batch_matches_jax(kw):
    tb = uc.build_batch(S, device="cpu", **kw)
    jb = juc.build_batch(S, **kw)
    _assert_batches_equal(tb, jb)
    assert tb.shared_A == jb.shared_A


@pytest.mark.parametrize("kw", [
    {"m_sites": 3, "n_clients": 6}, {"m_sites": 5, "n_clients": 10,
                                     "max_servers": 2},
    {"instance": "sslp_5_25"}, {"instance": "sslp_5_25",
                                "dtype": np.float32},
], ids=["synthetic", "synthetic_cap", "siplib", "siplib_f32"])
def test_sslp_build_batch_matches_jax(kw):
    _assert_batches_equal(sslp.build_batch(5, device="cpu", **kw),
                          jsslp.build_batch(5, **kw))


def test_model_helpers_match_jax():
    for i in (0, 7, 49):
        np.testing.assert_array_equal(sslp.siplib_presence(i),
                                      jsslp.siplib_presence(i))
    np.testing.assert_array_equal(sslp.client_presence(3, 5, 9),
                                  jsslp.client_presence(3, 5, 9))
    for got, want in zip(sslp._instance(4, 7), jsslp._instance(4, 7)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="50"):
        sslp.build_batch(51, instance="sslp_5_25", device="cpu")
    assert sslp.scenario_names_creator(3, 2) == \
        jsslp.scenario_names_creator(3, 2)
    opts = {"m_sites": 4, "sslp_instance": "sslp_5_25"}
    assert sslp.kw_creator(opts) == jsslp.kw_creator(opts)
    opts = {"uc_hours": 24, "uc_fleet_multiplier": 7}
    assert uc.kw_creator(opts) == juc.kw_creator(opts)
    assert uc.scenario_names_creator(4) == juc.scenario_names_creator(4)


def test_commitment_repair_and_candidates_match_jax():
    tb = uc.build_batch(S, H=6, min_up_down=True, device="cpu")
    jb = juc.build_batch(S, H=6, min_up_down=True)
    ut, dt_ = jb.model_meta["uc_ut"], jb.model_meta["uc_dt"]
    rng = np.random.default_rng(0)
    for _ in range(20):
        u = (rng.random(18) < 0.5).astype(float)
        np.testing.assert_array_equal(
            uc.repair_min_up_down(u, ut, dt_, 6),
            juc.repair_min_up_down(u, ut, dt_, 6))
    xbar = rng.random(tb.num_nonants)
    np.testing.assert_array_equal(uc.commitment_candidates(tb, xbar),
                                  juc.commitment_candidates(jb, xbar))
    # a tensor consensus vector (what root_xbar returns) works alike
    np.testing.assert_array_equal(
        uc.commitment_candidate(tb, torch.from_numpy(xbar), 0.3),
        juc.commitment_candidate(jb, xbar, 0.3))
    assert uc._infer_H(tb, 18) == juc._infer_H(jb, 18) == 6


def test_uc_streaming_entry_points_stay_refused():
    for fn, args in ((uc.scenario_block, ([0, 1],)),
                     (uc.scenario_source, (4,)),
                     (uc.export_corpus, ("x", 4))):
        with pytest.raises(NotImplementedError, match="item 12"):
            fn(*args)


@pytest.fixture(scope="module")
def uc_pair():
    names = [f"s{i}" for i in range(S)]
    jph = JPH(dict(UC_OPTS), names, batch=juc.build_batch(S, H=6),
              mesh=ONE)
    tph = PH(dict(UC_OPTS), names,
             batch=uc.build_batch(S, H=6, device="cpu"), device="cpu")
    traj = {}
    for key, ph in (("jax", jph), ("torch", tph)):
        rows = [(ph.Iter0(), ph.conv, float(ph.Eobjective(ph.state.obj)),
                 np.asarray(ph.state.xbar))]
        for _ in range(N_ITERS):
            ph.ph_iteration()
            rows.append((None, ph.conv,
                         float(ph.Eobjective(ph.state.obj)),
                         np.asarray(ph.state.xbar)))
        traj[key] = rows
    return jph, tph, traj


def test_ph_on_uc_matches_jax(uc_pair):
    jph, tph, traj = uc_pair
    assert _rel(traj["torch"][0][0], traj["jax"][0][0]) <= 1e-6
    for k, (t, j) in enumerate(zip(traj["torch"], traj["jax"])):
        for i in (1, 2, 3):
            assert _rel(t[i], j[i]) <= 1e-6, (k, i, t[i], j[i])
    assert _rel(tph.lagrangian_bound(), jph.lagrangian_bound()) <= 1e-6


@pytest.mark.parametrize("screen", [None, {"eps": 3e-3, "iters_cap": 200,
                                           "tol": 3e-2}],
                         ids=["full", "capped"])
def test_evaluate_candidates_matches_jax(uc_pair, screen):
    jph, tph, _ = uc_pair
    cands = juc.commitment_candidates(jph.batch,
                                      np.asarray(jph.state.xbar)[0])
    np.testing.assert_array_equal(
        uc.commitment_candidates(tph.batch, tph.root_xbar()), cands)
    kw = dict(screen or {}, return_mass=True)
    to, tf, tm = tph.evaluate_candidates(cands, **kw)
    jo, jf, jm = jph.evaluate_candidates(cands, **kw)
    np.testing.assert_array_equal(tf, np.asarray(jf))
    np.testing.assert_array_equal(tm, np.asarray(jm))
    assert _rel(to, jo) <= 1e-6
    assert tf.any()
    # one live stack: a call with another k drops the stack of k=5
    # (on both sides, so that both keep the same warm starts)
    to, _, _ = tph.evaluate_candidates(cands[:2], **kw)
    jo, _, _ = jph.evaluate_candidates(cands[:2], **kw)
    assert _rel(to, jo) <= 1e-6
    assert [k for k in tph._np_cache if isinstance(k, tuple)
            and k[0] == "xhat_stack"] == [("xhat_stack", 2)]


@pytest.mark.parametrize("kw", [
    {"max_sweeps": 2, "chunk": 8, "screen_eps": 3e-3, "screen_cap": 200},
    {"max_sweeps": 1, "flip_slots": np.arange(6)},
], ids=["screened", "exhaustive"])
def test_one_opt_commitment_matches_jax(uc_pair, kw):
    jph, tph, _ = uc_pair
    cands = juc.commitment_candidates(jph.batch,
                                      np.asarray(jph.state.xbar)[0])
    start = cands[-1]          # threshold 0.75: room for improving flips
    jc, jv = juc.one_opt_commitment(jph, jph.batch, start, **kw)
    tc, tv = uc.one_opt_commitment(tph, tph.batch, start, **kw)
    np.testing.assert_array_equal(tc, jc)
    assert np.isfinite(tv) and _rel(tv, jv) <= 1e-6


def test_fixed_nonant_bounds_and_helpers_match_jax(uc_pair):
    jph, tph, _ = uc_pair
    rng = np.random.default_rng(4)
    K = tph.batch.num_nonants
    for vals in (rng.random(K), rng.random((S, K))):
        for upto in (None, 0, 1):
            tl, tu = tph.fixed_nonant_bounds(vals, upto_stage=upto)
            jl, ju = jph.fixed_nonant_bounds(vals, upto_stage=upto)
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
            np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    # a two-stage batch: stage 1 pins everything, stage 0 nothing
    tl, _ = tph.fixed_nonant_bounds(np.full(K, 0.5), upto_stage=0)
    assert torch.equal(tl, tph.batch.lb)
    res = tph.solve_loop()
    assert tph.infeas_prob(res) == pytest.approx(
        jph.infeas_prob(jph.solve_loop()), abs=1e-12)
    assert tph.avg_min_max(res.obj) == pytest.approx(
        jph.avg_min_max(np.asarray(res.obj)))
    tph.check_W_bound_supported()


def test_fixed_nonant_bounds_on_farmer_matches_jax():
    tb = farmer.build_batch(3, device="cpu")
    tph = PH({}, ["s0", "s1", "s2"], batch=tb, device="cpu")
    jph = JPH({}, ["s0", "s1", "s2"], batch=jfarmer.build_batch(3),
              mesh=ONE)
    for upto in (None, 1):
        tl, tu = tph.fixed_nonant_bounds([100.0, 150.0, 250.0], upto)
        jl, ju = jph.fixed_nonant_bounds(np.array([100.0, 150.0, 250.0]),
                                         upto)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
