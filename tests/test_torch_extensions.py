"""Port parity: PH extensions, convergers and the W/x̄ I/O
(`mpisppy_tpu_torch/extensions/`, `convergers/`, `utils/wtracker.py`,
`utils/gradient.py`, `utils/wxbarutils.py`, `phbase`'s converger
wiring and `count_fixed`) against the JAX package, float64 on the CPU.

Every case runs farmer-3 (tests/test_extensions.py's options) once in
each package, the port from the JAX package's PreparedBatch
(`convert.py`) and with the JAX PRNGKey draw as the power iterations'
start vector (`ops.pdhg.normal_draw` is replaced in this module), so
both take the same steps.  A recording extension, last in a
MultiExtension, keeps each iteration's conv, E[obj], x̄, rho,
solver_eps, count_fixed and effective nonant bounds.  Held to the JAX
run: the hook order and MultiExtension's fan-out; the Gapper's eps at
every iteration (and its rounding to an f32 batch); the Fixer's
fixed masks, pinned values and lb_eff/ub_eff on integer farmer, and
its reduced costs (1e-10, also on a SplitA batch against the dense
einsum); rho after each norm-rho, mult-rho and gradient update; each
converger's stopping iteration and convergence_value (and the PD
converger's CSV); each in-hub xhatter's inner bound and XhatClosest's
choice; the W tracker's moving statistics; the Diagnoser's and
PHTracker's CSVs; grad_cost and find_rho with their CSV round trips;
W/x̄ files written by one package and read by the other.  Traces and
bounds to 1e-6 relative; masks, counts and eps exactly.
"""

import csv
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpisppy_tpu.convergers.fracintsnotconv as j_frac
import mpisppy_tpu.convergers.norm_rho_converger as j_nrc
import mpisppy_tpu.convergers.primal_dual_converger as j_pdc
import mpisppy_tpu.extensions as j_ext
import mpisppy_tpu.extensions.avgminmaxer as j_mma
import mpisppy_tpu.extensions.diagnoser as j_diag
import mpisppy_tpu.extensions.fixer as j_fixer
import mpisppy_tpu.extensions.gradient_extension as j_grad_ext
import mpisppy_tpu.extensions.mipgapper as j_gapper
import mpisppy_tpu.extensions.mult_rho_updater as j_mult
import mpisppy_tpu.extensions.norm_rho_updater as j_norm
import mpisppy_tpu.extensions.phtracker as j_pht
import mpisppy_tpu.extensions.wtracker_extension as j_wt
import mpisppy_tpu.extensions.xhatter as j_xhat
import mpisppy_tpu.utils.gradient as j_gradient
import mpisppy_tpu.utils.wxbarutils as j_wx
import mpisppy_tpu_torch.convergers.fracintsnotconv as t_frac
import mpisppy_tpu_torch.convergers.norm_rho_converger as t_nrc
import mpisppy_tpu_torch.convergers.primal_dual_converger as t_pdc
import mpisppy_tpu_torch.extensions as t_ext
import mpisppy_tpu_torch.extensions.avgminmaxer as t_mma
import mpisppy_tpu_torch.extensions.diagnoser as t_diag
import mpisppy_tpu_torch.extensions.fixer as t_fixer
import mpisppy_tpu_torch.extensions.gradient_extension as t_grad_ext
import mpisppy_tpu_torch.extensions.mipgapper as t_gapper
import mpisppy_tpu_torch.extensions.mult_rho_updater as t_mult
import mpisppy_tpu_torch.extensions.norm_rho_updater as t_norm
import mpisppy_tpu_torch.extensions.phtracker as t_pht
import mpisppy_tpu_torch.extensions.wtracker_extension as t_wt
import mpisppy_tpu_torch.extensions.xhatter as t_xhat
import mpisppy_tpu_torch.utils.gradient as t_gradient
import mpisppy_tpu_torch.utils.wxbarutils as t_wx
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.opt.ph import PH as JPH
from mpisppy_tpu.parallel.mesh import ScenarioMesh
from mpisppy_tpu_torch.convert import (prep_from_arrays, state_from_arrays,
                                       to_arrays)
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg
from mpisppy_tpu_torch.opt.ph import PH

ONE = ScenarioMesh(devices=jax.devices()[:1])
NAMES = [f"scen{i}" for i in range(3)]
OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 10, "convthresh": 1e-6,
        "pdhg_eps": 1e-6, "pdhg_max_iters": 4000}
TOL = 1e-6

# each package's modules, by the same keys
MODS = {
    "jax": dict(ext=j_ext, fixer=j_fixer, gapper=j_gapper, norm=j_norm,
                mult=j_mult, grad=j_grad_ext, xhat=j_xhat, wt=j_wt,
                mma=j_mma, diag=j_diag, pht=j_pht, pdc=j_pdc, nrc=j_nrc,
                frac=j_frac),
    "torch": dict(ext=t_ext, fixer=t_fixer, gapper=t_gapper, norm=t_norm,
                  mult=t_mult, grad=t_grad_ext, xhat=t_xhat, wt=t_wt,
                  mma=t_mma, diag=t_diag, pht=t_pht, pdc=t_pdc, nrc=t_nrc,
                  frac=t_frac),
}


def _hooks(m):
    """Two hook recorders of package m (MultiExtension's fan-out)."""
    out = []
    for tag in ("A", "B"):
        def make(tag=tag):
            def hook(name):
                def f(self):
                    self.opt._calls.append((tag, name))
                return f
            names = ("pre_iter0", "post_iter0", "post_iter0_after_sync",
                     "miditer", "enditer", "enditer_after_sync",
                     "post_everything", "pre_solve_loop", "post_solve_loop")
            return type(f"Hook{tag}", (m["ext"].Extension,),
                        {n: hook(n) for n in names})
        out.append(make())
    return out


# name -> (extension classes of package m, options, integer farmer,
#          extra options made from a tmp dir)
CASES = {
    "hooks": (lambda m: _hooks(m) + [m["mma"].MinMaxAvg, m["diag"].Diagnoser,
                                     m["pht"].PHTracker],
              {"PHIterLimit": 3, "convthresh": 0.0}, False,
              lambda d: {"diagnoser_options": {"diagnoser_outdir":
                                               os.path.join(d, "diag")},
                         "phtracker_options": {"results_folder":
                                               os.path.join(d, "pht")}}),
    "fixer_gapper": (lambda m: [m["fixer"].Fixer, m["gapper"].Gapper],
                     {"PHIterLimit": 12, "convthresh": 0.0,
                      "defaultPHrho": 2.0,
                      "fixeroptions": {"boundtol": 0.5, "nb": 2},
                      "gapperoptions": {"mipgapdict": {0: 1e-3, 2: 1e-5}}},
                     True, None),
    "norm_rho": (lambda m: [m["norm"].NormRhoUpdater,
                            m["wt"].Wtracker_extension],
                 {"PHIterLimit": 6, "convthresh": 0.0,
                  "defaultPHrho": 1e-4,
                  "norm_rho_options": {"ratio": 2.0, "step": 2.0},
                  "wtracker_options": {"wlen": 3}}, False, None),
    "mult_rho": (lambda m: [m["mult"].MultRhoUpdater],
                 {"PHIterLimit": 6, "convthresh": 0.0,
                  "defaultPHrho": 1e-5,
                  "mult_rho_options": {"convergence_tolerance": 1e-12,
                                       "rho_multiplier": 3.0}}, False, None),
    "gradient": (lambda m: [m["grad"].Gradient_extension],
                 {"PHIterLimit": 4, "convthresh": 0.0,
                  "gradient_extension_options": {
                      "grad_rho_update_interval": 2}}, False, None),
    "xhatters": (lambda m: [m["xhat"].XhatClosest, m["xhat"].XhatXbar,
                            m["xhat"].XhatLooper, m["xhat"].XhatSpecific],
                 {"PHIterLimit": 2, "convthresh": 0.0}, False, None),
    "primal_dual": (lambda m: [], {"PHIterLimit": 100, "convthresh": 0.0,
                                   "ph_converger": "pdc",
                                   "primal_dual_converger_options": {
                                       "tol": 3e-2}}, False,
                    lambda d: {"primal_dual_converger_options": {
                        "tol": 3e-2,
                        "tracking_csv": os.path.join(d, "pd.csv")}}),
    "norm_rho_conv": (lambda m: [], {"PHIterLimit": 100, "convthresh": 0.0,
                                     "ph_converger": "nrc",
                                     "norm_rho_converger_tol": 3e-2},
                      False, None),
    "fractional": (lambda m: [], {"PHIterLimit": 60, "convthresh": 0.0,
                                  "defaultPHrho": 2.0,
                                  "ph_converger": "frac",
                                  "fracintsnotconv_tol": 0.5}, True, None),
}
CONVERGERS = {"pdc": "PrimalDualConverger", "nrc": "NormRhoConverger",
              "frac": "FractionalConverger"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small cases: more intra-op threads only contend with the other
    test workers."""
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


def _h(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


def _recorder(m):
    """The last extension of a case: one row per PH iteration (at
    enditer, after every other extension's miditer)."""
    class Recorder(m["ext"].Extension):
        def __init__(self, ph):
            super().__init__(ph)
            self.rows = []

        def enditer(self):
            ph, st = self.opt, self.opt.state
            na = _h(ph.batch.nonant_idx)
            fixer = getattr(ph.extobject, "extdict", {}).get("Fixer")
            self.rows.append({
                "it": int(st.it), "conv": float(st.conv),
                "eobj": float(ph.Eobjective(st.obj)),
                "xbar": _h(st.xbar)[0], "rho": _h(ph.rho).copy(),
                "eps": float(ph.solver_eps),
                "count_fixed": int(ph.count_fixed()),
                "lb": _h(ph.lb_eff)[:, na], "ub": _h(ph.ub_eff)[:, na],
                "fixed": None if fixer is None else fixer._fixed.copy(),
                "fixed_vals": None if fixer is None
                else fixer._fixed_vals.copy()})

    return Recorder


def _ph(pkg, name, tmp):
    exts, extra, integer, tmp_opts = CASES[name]
    m = MODS[pkg]
    opts = dict(OPTS, **extra)
    os.makedirs(os.path.join(tmp, pkg), exist_ok=True)
    if tmp_opts is not None:
        opts.update(tmp_opts(os.path.join(tmp, pkg)))
    if "ph_converger" in opts:
        opts["ph_converger"] = getattr(m[opts["ph_converger"]],
                                       CONVERGERS[opts["ph_converger"]])
    kw = dict(extensions=m["ext"].MultiExtension,
              extension_kwargs={"ext_classes": exts(m) + [_recorder(m)]})
    if pkg == "jax":
        ph = JPH(opts, NAMES, batch=jfarmer.build_batch(
            3, use_integer=integer), mesh=ONE, **kw)
    else:
        jprep = JPH(opts, NAMES, batch=jfarmer.build_batch(3),
                    mesh=ONE).prep
        ph = PH(opts, NAMES, batch=farmer.build_batch(
            3, use_integer=integer, device="cpu"), device="cpu",
            prep=prep_from_arrays(to_arrays(jprep), device="cpu"), **kw)
    ph._calls = []
    ph.ph_main()
    return ph


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case run once per package: {name: (jax PH, port PH, tmp)}."""
    tmp = str(tmp_path_factory.mktemp("ext"))
    return {name: (_ph("jax", name, tmp), _ph("torch", name, tmp), tmp)
            for name in CASES}


def _rows(ph):
    return ph.extobject.extensions[-1].rows


def _ext(ph, cls_name):
    return ph.extobject.extdict[cls_name]


# ---- every case: the trace -------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_trace_matches_jax(runs, name):
    jph, tph, _ = runs[name]
    j, t = _rows(jph), _rows(tph)
    assert [r["it"] for r in t] == [r["it"] for r in j]
    assert int(tph.state.it) == int(jph.state.it)
    for rt, rj in zip(t, j):
        for f in ("conv", "eobj", "xbar", "rho"):
            assert _rel(rt[f], rj[f]) <= TOL, (rt["it"], f, rt[f], rj[f])
        assert rt["eps"] == rj["eps"]
        assert rt["count_fixed"] == rj["count_fixed"]


# ---- hooks -----------------------------------------------------------------

def test_hook_order_and_fan_out_match_jax(runs):
    jph, tph, _ = runs["hooks"]
    calls = tph._calls
    assert calls == jph._calls
    assert calls[:2] == [("A", "pre_iter0"), ("B", "pre_iter0")]
    assert calls[-2:] == [("A", "post_everything"),
                          ("B", "post_everything")]
    # MultiExtension fans each hook out in list order
    assert all(a == ("A", h) and b == ("B", h)
               for (a, b), h in zip(zip(calls[::2], calls[1::2]),
                                    [c[1] for c in calls[::2]]))
    per_iter = ["pre_solve_loop", "post_solve_loop", "miditer", "enditer",
                "enditer_after_sync"]
    for hook in per_iter:
        assert calls.count(("A", hook)) == 3, hook
    assert calls.count(("A", "post_iter0_after_sync")) == 0


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_diagnoser_and_phtracker_csvs_match_jax(runs):
    _, _, tmp = runs["hooks"]
    for sub, names in (("diag", ["diag_iter0_iter0.csv",
                                 "diag_iter3_enditer.csv"]),
                       ("pht/hub", ["bounds.csv", "gaps.csv", "xbars.csv",
                                    "duals.csv", "nonants.csv",
                                    "scen_costs.csv"])):
        for fname in names:
            t = _csv_rows(os.path.join(tmp, "torch", sub, fname))
            j = _csv_rows(os.path.join(tmp, "jax", sub, fname))
            assert t[0] == j[0] and len(t) == len(j), fname
            for rt, rj in zip(t[1:], j[1:]):
                if sub == "diag":
                    assert rt[0] == rj[0]
                    rt, rj = rt[1:], rj[1:]
                # NaN where no hub supplies bounds, in both
                np.testing.assert_allclose(np.array(rt, float),
                                           np.array(rj, float),
                                           rtol=TOL, atol=TOL)


# ---- Gapper ----------------------------------------------------------------

def test_gapper_eps_each_iteration(runs):
    jph, tph, _ = runs["fixer_gapper"]
    eps = [r["eps"] for r in _rows(tph)]
    assert eps == [r["eps"] for r in _rows(jph)]
    assert eps == [1e-3] + [1e-5] * 11


def test_gapper_rounds_to_the_batch_dtype():
    opts = dict(OPTS, gapperoptions={"mipgapdict": {0: 1e-5}})
    tph = PH(opts, NAMES, batch=farmer.build_batch(
        3, dtype=np.float32, device="cpu"), device="cpu",
        extensions=t_gapper.Gapper)
    jph = JPH(opts, NAMES, batch=jfarmer.build_batch(3, dtype=np.float32),
              mesh=ONE, extensions=j_gapper.Gapper)
    for ph in (tph, jph):
        ph.extobject.pre_iter0()
    assert float(tph.solver_eps) == float(jph.solver_eps) \
        == float(np.float32(1e-5)) != 1e-5


# ---- Fixer -----------------------------------------------------------------

def test_fixer_matches_jax(runs):
    jph, tph, _ = runs["fixer_gapper"]
    for rt, rj in zip(_rows(tph), _rows(jph)):
        np.testing.assert_array_equal(rt["fixed"], rj["fixed"])
        np.testing.assert_array_equal(rt["fixed_vals"], rj["fixed_vals"])
        np.testing.assert_array_equal(rt["lb"], rj["lb"])
        np.testing.assert_array_equal(rt["ub"], rj["ub"])
    end = _rows(tph)[-1]
    assert tph.count_fixed() == jph.count_fixed() == end["count_fixed"] > 0
    fixed = end["lb"] == end["ub"]
    np.testing.assert_array_equal(fixed, end["fixed"])
    assert np.array_equal(end["lb"][fixed], np.round(end["lb"][fixed]))
    # the box projection holds a slot pinned before the last superstep
    # at its value
    pinned = _rows(tph)[-2]["fixed"]
    assert pinned.any()
    na = _h(tph.batch.nonant_idx)
    x_na = _h(tph.state.x)[:, na]
    np.testing.assert_array_equal(x_na[pinned], end["lb"][pinned])


def test_pinned_reduced_costs_match_jax(runs):
    jph, tph, _ = runs["fixer_gapper"]
    jfix = _ext(jph, "Fixer")
    tfix = _ext(tph, "Fixer")
    # the JAX end state in the port, so both compute on the same iterate
    tph.state = state_from_arrays(to_arrays(jph.state), device="cpu")
    tph.rho = torch.as_tensor(np.asarray(jph.rho))
    want = np.asarray(jfix._pinned_reduced_costs())
    assert _rel(tfix._pinned_reduced_costs(), want) <= 1e-10
    # A'y through ir.bmatvec_t on a SplitA batch equals the dense einsum
    sph = PH(OPTS, NAMES, batch=farmer.build_batch(
        3, use_integer=True, split=True, device="cpu"), device="cpu",
        extensions=t_fixer.Fixer)
    assert sph.batch.split_A
    sph.state, sph.rho = tph.state, tph.rho
    b = sph.batch
    na = b.nonant_idx
    dense = torch.einsum("smn,sm->sn", b.A.to_dense(), tph.state.y)
    c_eff = b.c.clone()
    c_eff[:, na] += tph.state.W - tph.rho * tph.state.xbar
    q_eff = b.qdiag.clone()
    q_eff[:, na] += tph.rho
    ref = (c_eff + q_eff * tph.state.x + dense)[:, na]
    assert _rel(sph.extobject._pinned_reduced_costs(), _h(ref)) <= 1e-10


# ---- rho updaters ----------------------------------------------------------

@pytest.mark.parametrize("name", ["norm_rho", "mult_rho", "gradient"])
def test_rho_each_iteration_matches_jax(runs, name):
    jph, tph, _ = runs[name]
    rows_t, rows_j = _rows(tph), _rows(jph)
    for rt, rj in zip(rows_t, rows_j):
        assert _rel(rt["rho"], rj["rho"]) <= TOL, (rt["it"], rt["rho"])
    rho0 = CASES[name][1].get("defaultPHrho", 1.0)
    assert not np.allclose(rows_t[-1]["rho"], rho0)
    assert tph.rho.dtype == tph.batch.c.dtype
    assert tph.rho.shape == (3, 3)


def test_wtracker_matches_jax(runs):
    jph, tph, _ = runs["norm_rho"]
    jt = _ext(jph, "Wtracker_extension").wtracker
    tt = _ext(tph, "Wtracker_extension").wtracker
    assert [it for it, _ in tt._hist] == [it for it, _ in jt._hist] \
        == [4, 5, 6]
    for a, b in zip(tt.moving_stats(), jt.moving_stats()):
        assert _rel(a, b) <= TOL
    assert tt.report_by_moving_stats(1.0) == jt.report_by_moving_stats(1.0)


# ---- convergers ------------------------------------------------------------

@pytest.mark.parametrize("name", ["primal_dual", "norm_rho_conv",
                                  "fractional"])
def test_converger_stops_as_jax(runs, name):
    jph, tph, _ = runs[name]
    cap = CASES[name][1]["PHIterLimit"]
    assert int(tph.state.it) == int(jph.state.it) < cap
    tv = tph.convobject.convergence_value
    jv = jph.convobject.convergence_value
    assert abs(tv - jv) <= TOL * max(1.0, abs(jv))
    assert type(tph.convobject).__name__ == type(jph.convobject).__name__


def test_primal_dual_history_and_csv_match_jax(runs):
    jph, tph, tmp = runs["primal_dual"]
    th, jh = tph.convobject.history, jph.convobject.history
    assert [h[0] for h in th] == [h[0] for h in jh]
    assert _rel([h[1] for h in th], [h[1] for h in jh]) <= TOL
    assert np.isinf(th[0][2]) and np.isinf(jh[0][2])
    assert _rel([h[2] for h in th[1:]], [h[2] for h in jh[1:]]) <= TOL
    t = _csv_rows(os.path.join(tmp, "torch", "pd.csv"))
    j = _csv_rows(os.path.join(tmp, "jax", "pd.csv"))
    assert t[0] == j[0] == ["iteration", "primal", "dual"]
    assert len(t) == len(j) == len(th) + 1


# ---- in-hub xhatters -------------------------------------------------------

def test_xhatters_match_jax(runs):
    jph, tph, _ = runs["xhatters"]
    for cls in ("XhatClosest", "XhatXbar", "XhatLooper", "XhatSpecific"):
        te, je = _ext(tph, cls), _ext(jph, cls)
        assert np.isfinite(te.best_inner_bound), cls
        assert _rel(te.best_inner_bound, je.best_inner_bound) <= TOL, cls
        assert _rel(te.best_nonants, je.best_nonants) <= TOL, cls
    # the optimizer holds the last improvement of any of them
    assert tph.best_inner_bound in [_ext(tph, c).best_inner_bound for c in (
        "XhatClosest", "XhatXbar", "XhatLooper", "XhatSpecific")]
    assert _rel(tph.best_inner_bound, jph.best_inner_bound) <= TOL
    # XhatClosest picks the same scenario as the JAX one
    te, je = _ext(tph, "XhatClosest"), _ext(jph, "XhatClosest")
    x_t = _h(tph.batch.nonants(tph.state.x))
    x_j = np.asarray(jph.batch.nonants(jph.state.x))
    pick_t = int(np.argmin(np.abs(x_t - te.candidates()[0]).sum(axis=1)))
    pick_j = int(np.argmin(np.abs(x_j - je.candidates()[0]).sum(axis=1)))
    assert pick_t == pick_j


# ---- gradient rho ----------------------------------------------------------

def test_grad_cost_and_find_rho_match_jax(runs, tmp_path):
    jph, tph, _ = runs["mult_rho"]
    g_t, g_j = t_gradient.grad_cost(tph), j_gradient.grad_cost(jph)
    assert _rel(g_t, g_j) <= TOL
    r_t = t_gradient.find_rho(tph, order_stat=0.5)
    r_j = j_gradient.find_rho(jph, order_stat=0.5)
    assert r_t.shape == (3,) and (r_t > 0).all()
    assert _rel(r_t, r_j) <= TOL
    # CSV round trips across the packages
    j_gradient.write_grad_cost(tmp_path / "g.csv", jph)
    assert _rel(t_gradient.read_grad_cost(tmp_path / "g.csv", tph),
                g_j) <= TOL
    t_gradient.write_rho(tmp_path / "r.csv", tph, tph.rho)
    np.testing.assert_array_equal(
        j_gradient.read_rho(tmp_path / "r.csv", jph), _h(tph.rho)[0])


# ---- W / x̄ files -----------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_wxbar_file_crosses_packages(runs, tmp_path, writer):
    jph, tph, _ = runs["mult_rho"]
    src, dst = (jph, tph) if writer == "jax" else (tph, jph)
    wmod, rmod = (j_wx, t_wx) if writer == "jax" else (t_wx, j_wx)
    W0, xbar0 = _h(src.state.W).copy(), _h(src.state.xbar).copy()
    keep = dst.state
    try:
        wmod.write_W_and_xbar(tmp_path / "wx", src)
        assert (tmp_path / "wx.npz").exists()
        assert not (tmp_path / "wx.npz.tmp").exists()
        rmod.read_W_and_xbar(tmp_path / "wx", dst)
        np.testing.assert_array_equal(_h(dst.state.W), W0)
        np.testing.assert_array_equal(_h(dst.state.xbar), xbar0)
        assert _h(dst.state.W).dtype == np.float64
        wmod.write_W_csv(tmp_path / "w.csv", src)
        np.testing.assert_array_equal(
            rmod.read_W_csv(tmp_path / "w.csv", dst), W0)
    finally:
        dst.state = keep


def test_wxbar_extensions_round_trip(tmp_path):
    """WXBarWriter writes at every iteration; WXBarReader installs the
    file after Iter0 of a new run."""
    from mpisppy_tpu_torch.extensions.wxbarreader import WXBarReader
    from mpisppy_tpu_torch.extensions.wxbarwriter import WXBarWriter
    path = str(tmp_path / "snap")
    w = PH(dict(OPTS, PHIterLimit=2, W_fname=path), NAMES,
           batch=farmer.build_batch(3, device="cpu"), device="cpu",
           extensions=WXBarWriter)
    w.ph_main()
    r = PH(dict(OPTS, init_W_fname=path), NAMES,
           batch=farmer.build_batch(3, device="cpu"), device="cpu",
           extensions=WXBarReader)
    r.Iter0()
    np.testing.assert_array_equal(r.state.W.numpy(), w.state.W.numpy())
    np.testing.assert_array_equal(r.state.xbar.numpy(),
                                  w.state.xbar.numpy())
    z = np.load(path + ".npz", allow_pickle=True)
    assert int(z["it"]) == 2


# ---- the cross-scenario parts (once refused, queue A item 11) ------------

def test_cross_scenario_parts_refuse():
    """The parts once refused run: the capacity and its layout, the
    extension's check of the eta column, and its seeded wait-and-see
    cut, which repairs the blended Iter0's trivial bound (held to the
    JAX package in tests/test_torch_cross_scen.py)."""
    from mpisppy_tpu_torch.extensions.cross_scen_extension import (
        CrossScenarioExtension)
    from mpisppy_tpu_torch.utils import cross_scenario
    b = farmer.build_batch(3, device="cpu")
    with pytest.raises(RuntimeError, match="eta column missing"):
        PH(OPTS, NAMES, batch=b, device="cpu",
           extensions=CrossScenarioExtension)
    assert cross_scenario.cross_meta(b) is None
    ab = cross_scenario.add_cross_scenario_capacity(b, max_cuts=5)
    assert cross_scenario.cross_meta(ab) == {
        "first_cut_row": b.num_rows, "max_cuts": 5, "n_cuts": 0,
        "eta_col": b.num_vars}
    ph = PH(OPTS, NAMES, batch=ab, device="cpu",
            extensions=CrossScenarioExtension)
    ph.Iter0()
    assert ph.extobject.n_cuts == 1
    assert cross_scenario.cross_meta(ph.batch)["n_cuts"] == 1
    assert abs(ph.trivial_bound - -115405.55) < 5.0
