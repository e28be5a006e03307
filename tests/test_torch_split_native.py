"""Port parity: split-native farmer (`farmer.build_batch(..., split=True)`,
or "auto" above 1 GB of dense A), its prep, PH, xhat and certify, and
the sparse shared block, against the JAX package, float64 on the CPU.

* builder: the split storage equals the JAX builder's `split=True`
  arrays exactly, and assembles to the dense builder's A.
* prep: `prepare_split_native` gives the JAX Ruiz factors, scaled
  shared block and values to 1e-12, and the norm estimate to 1e-12 with
  the JAX PRNGKey(0) start vector as `v0`.
* PH farmer-3 born split: fed the JAX prep, conv, E[obj] and xbar agree
  to 1e-6 at Iter0 and 3 iterations; the xhat inner bound, whose
  reduced system is the shared block with the nonant columns zeroed
  and whose row shift is a SplitA over the reduced columns, to 1e-5.
* `densify` refuses above 5e8 elements; the f64 certify prep of a
  split-native batch stays split.
* `SparseSplitA`: the sparse shared block's products agree with the
  dense block's to 1e-12 and its density with the JAX package's,
  `pdhg_sparse_threshold` builds it from PH's options, and bfloat16
  storage of it is refused.
* the matmul route (an operator too large for the kernel's tile) takes
  the JAX solver's decisions on split-native farmer at cm=30, also for
  one straggler re-solved in float64 on the shared (1, M, N) xhat
  system, which keeps its shared form (and route) at S=1.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpisppy_tpu import ir as jir
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.opt.ph import PH as JPH
from mpisppy_tpu.parallel.mesh import ScenarioMesh
from mpisppy_tpu_torch import ir
from mpisppy_tpu_torch.convert import (batch_from_arrays, prep_from_arrays,
                                       to_arrays)
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
from mpisppy_tpu_torch.opt.ph import PH


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small cases: more intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

NAMES = [f"scen{i}" for i in range(3)]
N_ITERS = 3
OPTS = {"defaultPHrho": 1.0, "PHIterLimit": N_ITERS, "convthresh": 0.0,
        "pdhg_eps": 1e-7}


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_split_builder_equals_jax(dtype):
    jb = jfarmer.build_batch(5, crops_multiplier=3, dtype=dtype, split=True)
    tb = farmer.build_batch(5, crops_multiplier=3, dtype=dtype, split=True,
                            device="cpu")
    assert tb.split_A and not tb.shared_A
    for f in ("shared", "rows", "cols", "vals"):
        got, want = getattr(tb.A, f).numpy(), np.asarray(getattr(jb.A, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("c", "qdiag", "row_lo", "row_hi", "lb", "ub", "obj_const",
              "stage_cost_c"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    dense = farmer.build_batch(5, crops_multiplier=3, dtype=dtype,
                               split=False, device="cpu")
    assert torch.equal(tb.A.to_dense(), dense.A)
    assert torch.equal(tb.densify().A, dense.A)
    assert tb.num_rows == dense.num_rows and tb.num_vars == dense.num_vars
    # convert carries a JAX SplitA batch over
    cb = batch_from_arrays(to_arrays(jb), device="cpu")
    assert isinstance(cb.A, ir.SplitA)
    assert torch.equal(cb.A.to_dense(), dense.A)


def test_split_auto_picks_by_dense_size():
    """"auto" stores split exactly when the dense A would pass 1 GB
    (200 x 601 x 1200 in f64 is 1.15 GB), as the JAX builder decides."""
    assert not farmer.build_batch(3, device="cpu").split_A
    b = farmer.build_batch(200, crops_multiplier=100, device="cpu")
    assert b.split_A and b.A.shape == (200, 601, 1200)
    assert b.A.vals.shape == (200, 600)


def test_densify_refuses_above_5e8_elements():
    sp = ir.SplitA(shared=torch.zeros((1000, 1000)),
                   rows=torch.zeros((1,), dtype=torch.int32),
                   cols=torch.zeros((1,), dtype=torch.int32),
                   vals=torch.ones((501, 1)))
    b = farmer.build_batch(501, device="cpu")
    big = ir.ScenarioBatch(**{**{f: getattr(b, f) for f in
                                 ("c", "qdiag", "row_lo", "row_hi", "lb",
                                  "ub", "obj_const", "nonant_idx",
                                  "integer_mask", "tree")}, "A": sp})
    with pytest.raises(MemoryError, match="densify"):
        big.densify()


def test_prepare_split_native_matches_jax():
    jb = jfarmer.build_batch(8, crops_multiplier=2, split=True)
    jp = jpdhg.prepare_split_native(jb.A, jnp.asarray(jb.row_lo),
                                    jnp.asarray(jb.row_hi))
    tb = farmer.build_batch(8, crops_multiplier=2, split=True, device="cpu")
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                      tuple(tb.c.shape), jnp.float64))
    tp = pdhg.prepare_split_native(tb.A, tb.row_lo, tb.row_hi, v0=v0)
    assert (tp.d_row.shape, tp.d_col.shape) == ((1, 13), (1, 24))
    for f in ("d_row", "d_col", "anorm", "row_lo", "row_hi"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)),
                                   rtol=1e-12, atol=0, err_msg=f)
    for f in ("shared", "vals"):
        np.testing.assert_allclose(getattr(tp.A, f).numpy(),
                                   np.asarray(getattr(jp.A, f)),
                                   rtol=1e-12, atol=0, err_msg=f)


def _row(ph, bound):
    return {"bound": bound, "conv": ph.conv,
            "eobj": float(ph.Eobjective(ph.state.obj)),
            "xbar": np.asarray(ph.root_xbar())}


@pytest.fixture(scope="module")
def native_pair():
    jph = JPH(dict(OPTS), NAMES, batch=jfarmer.build_batch(3, split=True),
              mesh=ScenarioMesh(devices=jax.devices()[:1]))
    tph = PH(dict(OPTS), NAMES,
             batch=farmer.build_batch(3, split=True, device="cpu"),
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


def test_ph_split_native_trajectory_matches_jax(native_pair):
    jph, tph, traj = native_pair
    assert isinstance(tph.prep.A, ir.SplitA)
    assert _rel(traj["torch"][0]["bound"], traj["jax"][0]["bound"]) <= 1e-6
    for k, (t, j) in enumerate(zip(traj["torch"], traj["jax"])):
        for f in ("conv", "eobj", "xbar"):
            assert _rel(t[f], j[f]) <= 1e-6, (k, f, t[f], j[f])
    # the port's own prep for a batch born split is the split prep
    own = PH(dict(OPTS), NAMES,
             batch=farmer.build_batch(3, split=True, device="cpu"),
             device="cpu")
    assert isinstance(own.prep.A, ir.SplitA)
    assert own.prep.d_row.shape == (1, own.batch.num_rows)


def test_ph_split_native_xhat_matches_jax(native_pair):
    jph, tph, _ = native_pair
    xbar = np.asarray(jph.root_xbar())
    t_in, t_feas = tph.evaluate_xhat(xbar)
    j_in, j_feas = jph.evaluate_xhat(xbar)
    assert t_feas and j_feas
    assert _rel(t_in, j_in) <= 1e-5
    t, j = tph._xhat_cache(None), jph._xhat_cache(None)
    assert isinstance(t["A_na"], ir.SplitA)
    for f in ("shared", "rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(t["A_na"], f).numpy(),
                                      np.asarray(getattr(j["A_na"], f)))
    np.testing.assert_array_equal(t["A_red"].numpy(), np.asarray(j["A_red"]))
    assert t["A_red"].shape[0] == 1


def test_xhat_split_native_needs_nonant_delta_columns():
    b = farmer.build_batch(3, split=True, device="cpu")
    moved = b.A.cols.clone()
    moved[0] = b.num_vars - 1          # a delta in a kept column
    bad = type(b)(**{**b.__dict__,
                     "A": ir.SplitA(shared=b.A.shared, rows=b.A.rows,
                                    cols=moved, vals=b.A.vals)})
    ph = PH(dict(OPTS), NAMES, batch=bad, device="cpu")
    with pytest.raises(NotImplementedError, match="nonant"):
        ph._xhat_cache(None)


def test_certify_of_split_native_stays_split(native_pair):
    _, tph, _ = native_pair
    res = tph.solve_loop(warm=False, iters_cap=40)
    pick = torch.ones((3,), dtype=torch.bool)
    out = tph._certified_resolve(res, select=pick)
    full = tph._np_cache["_prep64"]
    assert isinstance(full.A, ir.SplitA) and full.A.dtype == torch.float64
    assert full.d_row.shape == (1, tph.batch.num_rows)
    assert bool(out.converged.all())
    ref = tph.solve_loop(warm=False, eps=1e-9)
    np.testing.assert_allclose(out.obj.numpy(), ref.obj.numpy(), rtol=1e-6)


def test_sparse_split_matches_jax():
    """The sparse shared block against the dense one (whose products
    match the JAX package's to 1e-12, tests/test_torch_split.py), and
    its density against the JAX package's `shared_density`."""
    jb = jfarmer.build_batch(6, crops_multiplier=3, split=True)
    tb = farmer.build_batch(6, crops_multiplier=3, split=True, device="cpu")
    tsp = ir.sparsify_split(tb.A, 0.5)
    assert isinstance(tsp, ir.SparseSplitA)
    assert ir.sparsify_split(tb.A, 0.01) is tb.A      # denser than 1%
    assert ir.sparsify_split(tb.A, 0.0) is tb.A
    assert tsp.shared_nnz_frac == ir.shared_density(tb.A) \
        == jir.shared_density(jb.A)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(tuple(tb.c.shape)))
    y = torch.from_numpy(rng.standard_normal(tuple(tb.row_lo.shape)))
    for fn, v in ((ir.bmatvec, x), (ir.bmatvec_t, y)):
        np.testing.assert_allclose(fn(tsp, v).numpy(), fn(tb.A, v).numpy(),
                                   rtol=0, atol=1e-12)
    dr, dc = torch.rand(tb.num_rows) + 0.5, torch.rand(tb.num_vars) + 0.5
    np.testing.assert_allclose(
        tsp.scale_shared(dr, dc).to_dense().numpy(),
        tb.A.scale_shared(dr, dc).numpy(), rtol=1e-15)
    np.testing.assert_array_equal(tsp.to_dense().numpy(),
                                  tb.A.to_dense().numpy())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsp.astype(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ir.sparsify_split(tb.A.astype(torch.bfloat16), 0.5)


def test_sparse_threshold_option_builds_the_sparse_prep():
    b = farmer.build_batch(3, split=True, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ph = PH(dict(OPTS, pdhg_sparse_threshold=0.5), NAMES, batch=b,
                device="cpu")
    assert isinstance(ph.prep.A, ir.SparseSplitA)
    dense = PH(dict(OPTS), NAMES, batch=b, device="cpu",
               prep=_dense_shared_prep(ph.prep))
    a = ph.solve_loop(warm=False)
    d = dense.solve_loop(warm=False)
    assert a.iters == d.iters
    np.testing.assert_allclose(a.x.numpy(), d.x.numpy(), rtol=0, atol=1e-9)
    st = ph.pdhg_stats()
    assert st["sparse_matvecs"] == 2 * a.iters
    assert st["shared_nnz_frac"] == pytest.approx(ph.prep.A.shared_nnz_frac)
    assert dense.pdhg_stats()["sparse_matvecs"] == 0


def _dense_shared_prep(prep):
    """The same prep with its SparseSplitA's shared block dense."""
    A = prep.A
    return pdhg.PreparedBatch(
        A=ir.SplitA(shared=A.shared_dense(), rows=A.rows, cols=A.cols,
                    vals=A.vals),
        row_lo=prep.row_lo, row_hi=prep.row_hi, d_row=prep.d_row,
        d_col=prep.d_col, anorm=prep.anorm)


def test_matmul_route_solver_matches_jax():
    """crops_multiplier=30 (M=181, N=360) is too large for the kernel's
    tile in f64, so the port's chunks take the matmul route (the JAX
    package's XLA body as torch ops); fed the JAX split-native prep it
    takes the JAX solver's decisions, with iterates within 1e-8."""
    jb = jfarmer.build_batch(2, crops_multiplier=30, split=True)
    jp = jpdhg.prepare_split_native(jb.A, jnp.asarray(jb.row_lo),
                                    jnp.asarray(jb.row_hi))
    tb = farmer.build_batch(2, crops_multiplier=30, split=True, device="cpu")
    assert pdhg_chunk.pick_route("split", tb.num_rows, tb.num_vars,
                                 torch.float64) == "matmul"
    jres = jpdhg.PDHGSolver(eps=1e-5).solve(
        jp, jnp.asarray(jb.c), jnp.asarray(jb.qdiag), jnp.asarray(jb.lb),
        jnp.asarray(jb.ub))
    m0 = pdhg.matmul_chunks
    res = pdhg.PDHGSolver(eps=1e-5).solve(
        prep_from_arrays(to_arrays(jp), device="cpu"), tb.c, tb.qdiag,
        tb.lb, tb.ub)
    assert pdhg.matmul_chunks - m0 == res.iters // 40 > 0
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    assert res.iters == int(jres.iters)
    np.testing.assert_array_equal(res.restarts.numpy(),
                                  np.asarray(jres.restarts))
    for f in ("x", "y", "obj", "dual_obj"):
        assert _rel(getattr(res, f), getattr(jres, f)) <= 1e-8, f


def test_single_straggler_on_a_shared_A_takes_the_matmul_route():
    """The float64 re-solve of one straggler on the xhat's reduced
    system (crops_multiplier=30: the shared matrix with the nonant
    columns zeroed, (1, 181, 360), beyond the kernel's tile).  The prep
    gathered to that one scenario keeps A shared, so its chunks take
    the matmul route (on the card the kernel cannot take this operator),
    with the JAX solver's decisions and iterates within 1e-8."""
    jb = jfarmer.build_batch(2, crops_multiplier=30, split=True)
    tb = farmer.build_batch(2, crops_multiplier=30, split=True, device="cpu")
    na = np.asarray(jb.nonant_idx)
    A_red = np.array(jb.A.shared)[None]
    A_red[:, :, na] = 0.0
    jp = jpdhg._gather_prep(
        jpdhg.prepare_batch(jnp.asarray(A_red), jnp.asarray(jb.row_lo),
                            jnp.asarray(jb.row_hi)), jnp.asarray([1]))

    def red(t):
        t = np.array(t)[1:2]
        t[:, na] = 0.0
        return t

    c, q, lb, ub = (red(t) for t in (jb.c, jb.qdiag, jb.lb, jb.ub))
    jres = jpdhg.PDHGSolver(eps=1e-5).solve(
        jp, *(jnp.asarray(t) for t in (c, q, lb, ub)))
    prep = prep_from_arrays(to_arrays(jp), device="cpu")
    assert tuple(prep.A.shape) == (1, tb.num_rows, tb.num_vars)
    assert pdhg_chunk.operator_form(prep.A, 1) == "shared"
    assert pdhg_chunk.pick_route("shared", tb.num_rows, tb.num_vars,
                                 torch.float64) == "matmul"
    m0 = pdhg.matmul_chunks
    res = pdhg.PDHGSolver(eps=1e-5).solve(
        prep, *(torch.from_numpy(t) for t in (c, q, lb, ub)))
    assert pdhg.matmul_chunks - m0 == res.iters // 40 > 0
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    assert res.iters == int(jres.iters)
    np.testing.assert_array_equal(res.restarts.numpy(),
                                  np.asarray(jres.restarts))
    for f in ("x", "y", "obj", "dual_obj"):
        assert _rel(getattr(res, f), getattr(jres, f)) <= 1e-8, f
