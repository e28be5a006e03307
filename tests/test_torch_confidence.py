"""The port's confidence-interval layer
(`mpisppy_tpu_torch/confidence_intervals/`) held to the JAX package's
on the CPU, at the JAX tests' sizes (farmer samples of 10, solver eps 1e-7):
`gap_estimators` (plain and pooled), `zhat4xhat`, the MMW interval
and sequential sampling against the JAX package to 1e-6; the
multistage drivers (sample_tree, IndepScens_SeqSampling) on aircond;
the xhat readers and writers and the quarantine debit."""

import os

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX package's tests configure it)

from mpisppy_tpu.confidence_intervals import ciutils as jci
from mpisppy_tpu.confidence_intervals.mmw_ci import \
    MMWConfidenceIntervals as JMMW
from mpisppy_tpu.confidence_intervals.seqsampling import \
    SeqSampling as JSeq
from mpisppy_tpu.confidence_intervals.zhat4xhat import zhat4xhat as jzhat
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu_torch.confidence_intervals import ciutils
from mpisppy_tpu_torch.confidence_intervals.mmw_ci import \
    MMWConfidenceIntervals
from mpisppy_tpu_torch.confidence_intervals.multi_seqsampling import \
    IndepScens_SeqSampling
from mpisppy_tpu_torch.confidence_intervals.sample_tree import \
    SampleSubtree
from mpisppy_tpu_torch.confidence_intervals.seqsampling import SeqSampling
from mpisppy_tpu_torch.confidence_intervals.zhat4xhat import zhat4xhat
from mpisppy_tpu_torch.device import host
from mpisppy_tpu_torch.models import aircond, farmer
from mpisppy_tpu_torch.opt.ef import ExtensiveForm
from torch_parity import (jax_ci_one_mesh, jax_draw,  # noqa: F401
                          one_torch_thread, rel)

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_draw",
                                     "jax_ci_one_mesh")

XHAT_STAR = np.array([170.0, 80.0, 250.0])   # farmer optimum
OPTS = {"solver_eps": 1e-7}
TOL = 1e-6
KEYS = ("G", "std", "zhats", "zstar")


GAP_CASES = [(XHAT_STAR, 10, 500, 1),
             (np.array([500.0, 0.0, 0.0]), 10, 700, 1),
             (XHAT_STAR, 20, 900, 2)]


def test_gap_estimators_match_jax():
    for case in GAP_CASES:
        _check_gap_estimators(*case)


def _check_gap_estimators(xhat, n, seed, arrp):
    t = ciutils.gap_estimators(xhat, farmer, num_scens=n, seed=seed,
                               cfg=OPTS, ArRP=arrp, objective_gap=True,
                               device="cpu")
    j = jci.gap_estimators(xhat, jfarmer, num_scens=n, seed=seed,
                           cfg=OPTS, ArRP=arrp, objective_gap=True)
    assert t["seed"] == j["seed"]
    for k in KEYS + ("Gobj",):
        assert rel(t[k], j[k]) <= TOL, (k, t[k], j[k])
    if arrp == 1 and xhat[0] == 500.0:
        assert t["G"] > 100.0                 # a clearly worse candidate


def test_zhat4xhat_and_mmw_match_jax():
    _check_zhat4xhat()
    _check_mmw()


def _check_zhat4xhat():
    t = zhat4xhat(farmer, XHAT_STAR, num_samples=4, sample_size=10,
                  seed=300, options=OPTS, device="cpu")
    j = jzhat(jfarmer, XHAT_STAR, num_samples=4, sample_size=10,
              seed=300, options=OPTS)
    assert rel(t[0], j[0]) <= TOL and rel(t[1], j[1]) <= TOL
    assert rel(t[2], j[2]) <= TOL
    assert t[2][0] <= t[0] <= t[2][1] and -130000 < t[0] < -90000


def _check_mmw():
    t = MMWConfidenceIntervals(farmer, dict(OPTS), XHAT_STAR,
                               num_batches=3, batch_size=10, start=1000,
                               mname_is_module=True, device="cpu").run()
    j = JMMW(jfarmer, dict(OPTS), XHAT_STAR, num_batches=3,
             batch_size=10, start=1000, mname_is_module=True).run()
    for k in ("gap_inner_bound", "Gbar", "std", "zhat_bar", "zstar_bar"):
        assert rel(t[k], j[k]) <= TOL, k
    assert rel(t["Glist"], j["Glist"]) <= TOL
    assert 0.0 <= t["gap_inner_bound"] < 0.05 * abs(t["zstar_bar"])


def test_seqsampling_matches_jax_and_bpl_runs():
    _check_seqsampling_bm()
    _check_seqsampling_bpl()


def _check_seqsampling_bm():
    o = {"BM_h": 2.0, "BM_eps": 500.0, "n0min": 10, "max_seq_iters": 3,
         **OPTS}
    t = SeqSampling(farmer, o, seed=42, device="cpu").run()
    j = JSeq(jfarmer, o, seed=42).run()
    assert t["T"] == j["T"] and t["num_scens"] == j["num_scens"]
    assert rel(t["xhat_one"], j["xhat_one"]) <= TOL
    for (tn, tG, ts), (jn, jG, js) in zip(t["history"], j["history"]):
        assert tn == jn and rel([tG, ts], [jG, js]) <= TOL
    assert rel(t["CI"], j["CI"]) <= TOL
    assert abs(t["xhat_one"][2] - 250.0) < 60.0


def _check_seqsampling_bpl():
    r = SeqSampling(farmer, {"BPL_eps": 2000.0, "n0min": 10,
                             "max_seq_iters": 2, **OPTS},
                    seed=99, stopping_criterion="BPL", device="cpu").run()
    assert r["num_scens"] >= 10 and r["xhat_one"].shape == (3,)


def test_multistage_drivers_on_aircond():
    b = aircond.build_batch(branching_factors=(2, 2), device="cpu")
    ef = ExtensiveForm({"pdhg_eps": 1e-7}, list(b.tree.scen_names),
                       batch=b, device="cpu")
    ef.solve_extensive_form()
    xhat = ef.get_root_solution()
    eobj, feas = SampleSubtree(aircond, xhat, starting_stage=1,
                               branching_factors=[2, 2], seed=17,
                               options={}, device="cpu").run()
    assert feas and eobj > 0
    r = IndepScens_SeqSampling(
        aircond, {"branching_factors": [2, 2], "BM_h": 3.0,
                  "BM_eps": 100.0, "n0min": 4, "max_seq_iters": 1,
                  "num_eval_samples": 2, **OPTS},
        seed=5, stopping_criterion="BM", device="cpu").run()
    assert r["xhat_one"] is not None and np.isfinite(r["G"])


def test_sampling_xhat_io_and_debit(tmp_path):
    b1 = ciutils.sample_batch(farmer, 5, seed=100, device="cpu")
    b2 = ciutils.sample_batch(farmer, 5, seed=200, device="cpu")
    assert not np.allclose(host(b1.A), host(b2.A))
    np.testing.assert_array_equal(
        host(b1.A), np.asarray(jci.sample_batch(jfarmer, 5, seed=100).A))
    p = os.fspath(tmp_path / "xhat.npy")
    ciutils.write_xhat(XHAT_STAR, p)
    np.testing.assert_array_equal(ciutils.read_xhat(p), XHAT_STAR)
    pt = os.fspath(tmp_path / "xhat.txt")
    ciutils.writetxt_xhat(XHAT_STAR, pt)
    np.testing.assert_allclose(ciutils.readtxt_xhat(pt), XHAT_STAR)
    est = {"G": 10.0, "zhats": -1000.0, "zstar": -900.0}
    assert ciutils.debit_quarantined_mass(dict(est), 0.0) == 0.0
    for frac in (0.01, 0.25):
        e, je = dict(est), dict(est)
        assert ciutils.debit_quarantined_mass(e, frac) == \
            jci.debit_quarantined_mass(je, frac) == frac * 1000.0
        assert e == je
    assert ciutils.t_quantile(0.95, 7) == jci.t_quantile(0.95, 7)
