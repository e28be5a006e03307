"""Port parity: converged-scenario compaction (`PDHGSolver.
solve_compacted`, `_gather_prep`, `width_bucket`), the MPISPPY_TPU_PDHG
option overlay and the per-cylinder solver options
(`utils/solver_spec.py`) against the JAX package, float64 on the CPU.

* The knob plumbing of tests/test_pdhg_adaptive.py and
  tests/test_solver_spec.py, run on both packages: both build solvers
  with equal `config_key()` from the same options, overlay and
  `{root}_solver_*` cascade.
* The compaction cases of tests/test_pdhg_adaptive.py on the port:
  scenarios frozen before the first gather are bit-identical to the
  uncompacted solve, survivors agree to the KKT tolerance, compaction
  off is the plain solve, prob-0 padding never counts as active, and
  `_gather_prep` leaves shared leaves alone.
* Against the JAX package, on the dense, shared and split preps (the
  JAX prep handed over through `convert.py`): the same segment
  trajectory (width, active, iterations) and results within 1e-8.
* Through `solve_loop`: Iter0, one xhat and one Lagrangian bound with
  pdhg_compact_threshold set give the JAX package's `_active_traj`,
  `_flops_saved` and bounds (1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.opt.ph import PH as JPH
from mpisppy_tpu.parallel.mesh import ScenarioMesh
from mpisppy_tpu.serve.compile_cache import width_bucket as jwidth_bucket
from mpisppy_tpu.utils import solver_spec as jsolver_spec
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg
from mpisppy_tpu_torch.opt.ph import PH
from mpisppy_tpu_torch.utils import solver_spec

ONE = ScenarioMesh(devices=jax.devices()[:1])
PKGS = {"jax": (jpdhg, jsolver_spec, jwidth_bucket),
        "torch": (pdhg, solver_spec, pdhg.width_bucket)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_draw():
    """The port's power iterations start from the JAX PRNGKey draw, so
    preps built on both sides carry the same norm estimate."""
    def draw(shape, dtype, device, seed=0):
        jd = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
        return torch.tensor(np.asarray(jax.random.normal(
            jax.random.PRNGKey(seed), shape, jd)), device=device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pdhg, "normal_draw", draw)
        yield


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


# ---- knob plumbing, both packages ----------------------------------------

@pytest.mark.parametrize("pkg", list(PKGS))
def test_width_bucket(pkg):
    wb = PKGS[pkg][2]
    assert [wb(n) for n in (1, 2, 3, 4, 5, 8, 9, 1000)] \
        == [1, 2, 4, 4, 8, 8, 16, 1024]
    assert wb(3, floor=8) == 8
    assert wb(0) == 1


@pytest.mark.parametrize("pkg", list(PKGS))
def test_from_options_maps_adaptive_knobs(pkg):
    P = PKGS[pkg][0].PDHGSolver
    s = P.from_options({"pdhg_restart_mode": "fixed",
                        "pdhg_restart_beta_sufficient": 0.1,
                        "pdhg_restart_beta_necessary": 0.9,
                        "pdhg_compact_threshold": 0.25})
    assert s.restart_mode == "fixed"
    assert s.restart_beta_sufficient == 0.1
    assert s.restart_beta_necessary == 0.9
    assert s.compact_threshold == 0.25
    d = P.from_options({})
    assert d.restart_mode == "adaptive"
    assert d.compact_threshold == 0.0


@pytest.mark.parametrize("pkg", list(PKGS))
def test_env_overlay_wins(monkeypatch, pkg):
    monkeypatch.setenv("MPISPPY_TPU_PDHG",
                       "restart_mode=fixed pdhg_compact_threshold=0.5")
    s = PKGS[pkg][0].PDHGSolver.from_options(
        {"pdhg_restart_mode": "adaptive", "pdhg_compact_threshold": 0.0})
    assert s.restart_mode == "fixed"
    assert s.compact_threshold == 0.5


@pytest.mark.parametrize("env", [
    None, "restart_mode=fixed pdhg_compact_threshold=0.5",
    "eps=1e-5 max_iters=3000 check_every=20 restart_every=8",
    "pdhg_hot_dtype=f32 restart_beta_sufficient=0.3"])
def test_overlay_config_key_matches_jax(monkeypatch, env):
    """Equal config_key() under the same options and overlay."""
    if env is None:
        monkeypatch.delenv("MPISPPY_TPU_PDHG", raising=False)
    else:
        monkeypatch.setenv("MPISPPY_TPU_PDHG", env)
    opts = {"pdhg_eps": 1e-7, "pdhg_max_iters": 5000,
            "pdhg_compact_threshold": 0.25}
    assert pdhg.PDHGSolver.from_options(opts).config_key() == \
        jpdhg.PDHGSolver.from_options(opts).config_key()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_clone_and_config_key(pkg):
    s = PKGS[pkg][0].PDHGSolver(eps=1e-7, restart_beta_sufficient=0.3,
                                compact_threshold=0.5)
    c = s.clone(max_iters=123)
    assert c.max_iters == 123
    assert c.restart_beta_sufficient == 0.3
    assert c.compact_threshold == 0.5
    ka, kb = s.config_key(), c.config_key()
    assert [a for a, b in zip(ka, kb) if a != b] == [s.max_iters]
    assert s.config_key() != s.clone(restart_mode="fixed").config_key()
    assert s.config_key() != \
        s.clone(compact_threshold=0.25).config_key()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_option_string_parsing(pkg):
    ss = PKGS[pkg][1]
    d = ss.option_string_to_dict("eps=1e-6 max_iters=30000 flag")
    assert d == {"eps": 1e-6, "max_iters": 30000, "flag": True}
    assert ss.option_string_to_dict(None) is None


@pytest.mark.parametrize("pkg", list(PKGS))
def test_prefix_cascade(pkg):
    ss = PKGS[pkg][1]
    cfg = {"lagrangian_solver_eps": 1e-5, "solver_eps": 1e-7,
           "solver_max_iters": 40000}
    root, opts = ss.solver_specification(cfg, ["lagrangian", ""])
    assert root == "lagrangian"
    assert opts == {"pdhg_eps": 1e-5}
    root, opts = ss.solver_specification(cfg, ["fwph", ""])
    assert root == ""
    assert opts == {"pdhg_eps": 1e-7, "pdhg_max_iters": 40000}


@pytest.mark.parametrize("pkg", list(PKGS))
def test_options_string_root(pkg):
    ss = PKGS[pkg][1]
    cfg = {"ef_solver_options": "eps=1e-8 restart_every=32"}
    root, opts = ss.solver_specification(cfg, ["ef", ""])
    assert root == "ef"
    assert opts == {"pdhg_eps": 1e-8, "pdhg_restart_every": 32}


@pytest.mark.parametrize("pkg", list(PKGS))
def test_name_required_raises(pkg):
    ss = PKGS[pkg][1]
    with pytest.raises(RuntimeError):
        ss.solver_specification({}, ["ph"], name_required=True)
    root, opts = ss.solver_specification({}, ["ph"])
    assert root is None and opts == {}


@pytest.mark.parametrize("cfg, roots", [
    ({"lagrangian_solver_eps": 1e-5, "solver_max_iters": 9000},
     ["lagrangian", ""]),
    ({"xhatshuffle_solver_options": "eps=1e-6 compact_threshold=0.5",
      "solver_eps": 1e-7}, ["xhatshuffle", ""]),
    ({"solver_options": "restart_mode=fixed max_iters=400"},
     ["lagrangian", ""]),
    ({"ph_solver_hot_dtype": "f32", "ph_solver_options": "eps=1e-4"},
     ["ph", ""]),
])
def test_cylinder_solver_config_matches_jax(cfg, roots):
    """The same per-cylinder options give both packages the same root,
    the same optimizer options and solvers with equal config_key()."""
    t_root, t_opts = solver_spec.solver_specification(cfg, roots)
    j_root, j_opts = jsolver_spec.solver_specification(cfg, roots)
    assert (t_root, t_opts) == (j_root, j_opts)
    assert pdhg.PDHGSolver.from_options(t_opts).config_key() == \
        jpdhg.PDHGSolver.from_options(j_opts).config_key()


# ---- compaction on the port ----------------------------------------------

def _split_difficulty(pkg_batch):
    """farmer-8 with a strong prox term on scenarios 0-3
    (tests/test_pdhg_adaptive.py): those need ~4x the iterations of the
    plain LPs 4-7, the early/late split compaction exists for."""
    b = pkg_batch
    q = np.array(b.qdiag)
    c = np.array(b.c)
    q[:4] += 100.0
    c[:4, :3] -= 100.0 * 150.0
    return c, q


def _port_case(prep_kind="dense"):
    b = farmer.build_batch(8, device="cpu")
    c, q = _split_difficulty(b)
    prep = {"dense": lambda: pdhg.prepare_batch(b.A, b.row_lo, b.row_hi),
            "shared": lambda: pdhg.prepare_batch(
                b.A[:1].clone(), b.row_lo, b.row_hi),
            "split": lambda: pdhg.prepare_batch_split(
                b.A, *[torch.as_tensor(np.asarray(i))
                       for i in b.model_meta["A_delta_idx"]],
                b.row_lo, b.row_hi)}[prep_kind]()
    return b, prep, torch.as_tensor(c), torch.as_tensor(q)


def test_compaction_parity_frozen_bit_identical():
    b, prep, c, q = _port_case()
    seg = 2560
    sc = pdhg.PDHGSolver(max_iters=20000, eps=1e-7, compact_threshold=0.9)
    su = sc.clone(compact_threshold=0.0)
    traj = []
    res_c = sc.solve_compacted(prep, c, q, b.lb, b.ub,
                               obj_const=b.obj_const, segment_iters=seg,
                               on_segment=traj.append)
    res_u = su.solve(prep, c, q, b.lb, b.ub, obj_const=b.obj_const)
    assert bool(res_c.converged.all()) and bool(res_u.converged.all())
    widths = [t["width"] for t in traj]
    assert widths[-1] < b.num_scens
    assert widths == sorted(widths, reverse=True)
    assert all(w == pdhg.width_bucket(w) for w in widths)
    probe = su.solve(prep, c, q, b.lb, b.ub, obj_const=b.obj_const,
                     iters_cap=seg)
    frozen = probe.converged.numpy()
    assert frozen[4:].all() and not frozen.all()
    for f in ("x", "y", "obj", "pres", "dres", "gap"):
        a = getattr(res_c, f).numpy()[frozen]
        u = getattr(res_u, f).numpy()[frozen]
        assert np.array_equal(a, u), f
    np.testing.assert_allclose(res_c.obj.numpy(), res_u.obj.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_compaction_disabled_is_plain_solve():
    b = farmer.build_batch(4, device="cpu")
    prep = pdhg.prepare_batch(b.A, b.row_lo, b.row_hi)
    s = pdhg.PDHGSolver(max_iters=20000, eps=1e-7)
    ra = s.solve_compacted(prep, b.c, b.qdiag, b.lb, b.ub,
                           obj_const=b.obj_const)
    rb = s.solve(prep, b.c, b.qdiag, b.lb, b.ub, obj_const=b.obj_const)
    assert torch.equal(ra.x, rb.x)


def test_compaction_skips_padding_scenarios():
    b, prep, c, q = _port_case()
    probs = np.array([0.25, 0.25, 0.25, 0.25, 0.0, 0.0, 0.0, 0.0])
    s = pdhg.PDHGSolver(max_iters=20000, eps=1e-7, compact_threshold=0.9)
    traj = []
    res = s.solve_compacted(prep, c, q, b.lb, b.ub, obj_const=b.obj_const,
                            probs=probs, segment_iters=640,
                            on_segment=traj.append)
    assert bool(res.converged[:4].all())
    assert traj[-1]["active"] == 0
    assert int(res.iters) < s.max_iters


def test_gather_prep_keeps_shared_leaves():
    b = farmer.build_batch(6, device="cpu")
    prep = pdhg.prepare_batch(b.A, b.row_lo, b.row_hi)
    ii = torch.tensor([1, 4])
    g = pdhg._gather_prep(prep, ii)
    assert g.A.shape[0] == 2 and tuple(g.anorm.shape) == (2,)
    shared = pdhg.PreparedBatch(
        A=prep.A, row_lo=prep.row_lo, row_hi=prep.row_hi,
        d_row=prep.d_row[:1], d_col=prep.d_col[:1], anorm=prep.anorm)
    g2 = pdhg._gather_prep(shared, ii)
    assert g2.d_row.shape[0] == 1
    assert g2.row_lo.shape[0] == 2
    # a SplitA gathers its per-scenario values only, as a contiguous
    # (2, nnz) tensor; the shared block and coordinates stay as they are
    sp = pdhg.prepare_batch_split(
        b.A, *[torch.as_tensor(np.asarray(i))
               for i in b.model_meta["A_delta_idx"]], b.row_lo, b.row_hi)
    g3 = pdhg._gather_prep(sp, ii)
    assert g3.A.shared is sp.A.shared and g3.A.rows is sp.A.rows
    assert tuple(g3.A.vals.shape) == (2, sp.A.vals.shape[1])
    assert g3.A.vals.is_contiguous()
    assert torch.equal(g3.A.vals, sp.A.vals[ii])


# ---- against the JAX package ---------------------------------------------

def _jax_case(prep_kind):
    b = jfarmer.build_batch(8)
    c, q = _split_difficulty(b)
    if prep_kind == "dense":
        prep = jpdhg.prepare_batch(b.A, b.row_lo, b.row_hi)
    elif prep_kind == "shared":
        prep = jpdhg.prepare_batch(b.A[:1], b.row_lo, b.row_hi)
    else:
        rows, cols = b.model_meta["A_delta_idx"]
        prep = jpdhg.prepare_batch_split(
            b.A, jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
            b.row_lo, b.row_hi)
    return b, prep, jnp.asarray(c), jnp.asarray(q)


@pytest.mark.parametrize("prep_kind", ["dense", "shared", "split"])
def test_compacted_trajectory_matches_jax(prep_kind):
    jb, jprep, jc, jq = _jax_case(prep_kind)
    tb = farmer.build_batch(8, device="cpu")
    tprep = convert.prep_from_arrays(convert.to_arrays(jprep), device="cpu")
    if prep_kind == "split":
        assert isinstance(tprep.A, pdhg.SplitA)
    elif prep_kind == "shared":
        assert tuple(tprep.A.shape)[0] == 1
    kw = dict(max_iters=20000, eps=1e-7, compact_threshold=0.9)
    jt, tt = [], []
    jr = jpdhg.PDHGSolver(**kw).solve_compacted(
        jprep, jc, jq, jb.lb, jb.ub, obj_const=jb.obj_const,
        segment_iters=1280, on_segment=jt.append)
    tr = pdhg.PDHGSolver(**kw).solve_compacted(
        tprep, torch.as_tensor(np.array(jc)),
        torch.as_tensor(np.array(jq)), tb.lb, tb.ub,
        obj_const=tb.obj_const, segment_iters=1280, on_segment=tt.append)
    assert tt == jt
    assert min(t["width"] for t in tt) < 8
    assert int(tr.iters) == int(jr.iters)
    assert np.array_equal(tr.converged.numpy(), np.asarray(jr.converged))
    assert np.array_equal(tr.restarts.numpy(), np.asarray(jr.restarts))
    for f in ("x", "y", "obj", "dual_obj"):
        assert _rel(getattr(tr, f).numpy(),
                    np.asarray(getattr(jr, f))) <= 1e-8, f


N_PH = 2


@pytest.fixture(scope="module")
def ph_pair():
    """Iter0, N_PH PH iterations, one xhat and one Lagrangian bound with
    pdhg_compact_threshold on both sides (farmer-8, the JAX prep)."""
    opts = {"defaultPHrho": 1.0, "PHIterLimit": N_PH, "convthresh": 0.0,
            "pdhg_eps": 1e-7, "no_split_prep": True,
            "pdhg_compact_threshold": 0.9, "lagrangian_eps": 1e-7}
    names = [f"scen{i}" for i in range(8)]
    jph = JPH(opts, names, batch=jfarmer.build_batch(8), mesh=ONE)
    tph = PH(opts, names, batch=farmer.build_batch(8, device="cpu"),
             device="cpu", prep=convert.prep_from_arrays(
                 convert.to_arrays(jph.prep), device="cpu"))
    out = {}
    for key, ph in (("jax", jph), ("torch", tph)):
        rows = {"iter0": ph.Iter0()}
        rows["iter0_traj"] = list(ph._active_traj)
        for _ in range(N_PH):
            ph.ph_iteration()
        xbar = np.asarray(jph.root_xbar()) if key == "torch" \
            else np.asarray(ph.root_xbar())
        rows["xhat"] = ph.evaluate_xhat(xbar)
        rows["lagrangian"] = ph.lagrangian_bound()
        rows["lagrangian_traj"] = list(ph._active_traj)
        rows["stats"] = ph.pdhg_stats()
        out[key] = rows
    return out


def test_solve_loop_compaction_matches_jax(ph_pair):
    t, j = ph_pair["torch"], ph_pair["jax"]
    # Iter0 gathers its survivors; the trajectories are the JAX ones
    assert t["iter0_traj"] == j["iter0_traj"]
    assert len(t["iter0_traj"]) >= 1
    assert t["lagrangian_traj"] == j["lagrangian_traj"]
    assert _rel(t["iter0"], j["iter0"]) <= 1e-6
    assert _rel(t["lagrangian"], j["lagrangian"]) <= 1e-6
    assert t["xhat"][1] and j["xhat"][1]
    assert _rel(t["xhat"][0], j["xhat"][0]) <= 1e-6
    ts, js = t["stats"], j["stats"]
    assert ts["flops_saved"] == js["flops_saved"]
    assert ts["active_fraction_traj"] == js["active_fraction_traj"]
    assert ts["inner_iters"] == js["inner_iters"]
    assert ts["restarts_total"] == js["restarts_total"]
    assert ts["active_fraction_final"] == js["active_fraction_final"]
