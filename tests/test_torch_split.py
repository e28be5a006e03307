"""Port parity: the SplitA and shared-A operator forms on farmer's
default prep (the delta-split route of `spopt._build_prep`), against
the JAX package, float64 on the CPU.

* operators: `ir.bmatvec` / `bmatvec_t` on a SplitA and on a shared
  (1, M, N) A agree to 1e-12 with the JAX package's (the same products;
  only the summation order of the shared matmul may differ).
* preps: `prepare_batch_split` and `prepare_batch` on a shared A give
  the JAX Ruiz factors and scaled operator to 1e-12 (max and products
  are the same operations in the same order), and the norm estimate to
  1e-12 when the JAX PRNGKey(0) start vector is handed over as `v0`.
* solver: fed the JAX split prep (`convert.prep_from_arrays`), the port
  takes the same decisions on farmer-8 (converged mask, iterations,
  restarts) and x, y and obj agree within 1e-8 relative to the largest
  magnitude, as for the dense prep.  The split form's chunks go through
  the wrapper's split plain version here (CPU tensors).
* PH farmer-3 with default options (no `no_split_prep`): the port now
  builds the split prep, with one shared scaling (d_row (1, M)), as the
  JAX package does; fed the JAX prep, conv, E[obj] and xbar agree to
  1e-6 at Iter0 and 5 iterations, and the xhat inner bound (whose
  reduced system is shared (1, M, N) on both sides, with its own prep)
  to 1e-5.
* the chunk kernel's route rule at the tile edges and at the true-size
  shapes, and the wrapper's shared and split forms on CPU tensors.
"""

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
from mpisppy_tpu_torch.convert import prep_from_arrays, to_arrays
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
from mpisppy_tpu_torch.ops.pdhg_chunk import pick_route
from mpisppy_tpu_torch.opt.ph import PH

import h100_occupancy as card

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16


def _close(got, want, rel):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    assert float(np.max(np.abs(got - want))) <= rel * scale


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


def _jax_draw(S, N):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (S, N),
                                        jnp.float64))


@pytest.fixture(scope="module")
def farmer8():
    jb = jfarmer.build_batch(8, crops_multiplier=2)
    rows, cols = jb.model_meta["A_delta_idx"]
    jprep = jpdhg.prepare_batch_split(
        jnp.asarray(jb.A), jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(jb.row_lo), jnp.asarray(jb.row_hi))
    return jb, jprep, farmer.build_batch(8, crops_multiplier=2,
                                         device="cpu")


@pytest.mark.parametrize("form", ["split", "shared"])
def test_bmatvec_split_and_shared_match_jax(farmer8, form):
    jb, jprep, _ = farmer8
    rng = np.random.default_rng(4)
    S, M, N = np.asarray(jb.A).shape
    x, y = rng.standard_normal((S, N)), rng.standard_normal((S, M))
    if form == "split":
        jA = jprep.A
        tA = prep_from_arrays(to_arrays(jprep), device="cpu").A
        assert isinstance(tA, ir.SplitA)
    else:
        jA = jnp.asarray(jb.A)[:1]
        tA = torch.from_numpy(np.asarray(jb.A)[:1].copy())
    for fn, jfn, v in ((ir.bmatvec, jir.bmatvec, x),
                       (ir.bmatvec_t, jir.bmatvec_t, y)):
        got = fn(tA, torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, np.asarray(jfn(jA, jnp.asarray(v))),
                                   rtol=0, atol=1e-12)


def test_prepare_batch_split_matches_jax(farmer8):
    jb, jprep, tb = farmer8
    rows, cols = tb.model_meta["A_delta_idx"]
    v0 = _jax_draw(*tb.c.shape)
    tp = pdhg.prepare_batch_split(tb.A, rows, cols, tb.row_lo, tb.row_hi,
                                  v0=v0)
    assert isinstance(tp.A, ir.SplitA)
    assert tp.d_row.shape == (1, tb.num_rows)
    assert tp.d_col.shape == (1, tb.num_vars)
    for f in ("d_row", "d_col", "anorm", "row_lo", "row_hi"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jprep, f)),
                                   rtol=1e-12, atol=0, err_msg=f)
    for f in ("shared", "vals", "rows", "cols"):
        np.testing.assert_allclose(getattr(tp.A, f).numpy(),
                                   np.asarray(getattr(jprep.A, f)),
                                   rtol=1e-12, atol=0, err_msg=f)
    np.testing.assert_allclose(tp.A.to_dense().numpy(),
                               np.asarray(jprep.A.to_dense()), rtol=1e-12,
                               atol=0)


def test_prepare_batch_shared_matches_jax(farmer8):
    jb, _, tb = farmer8
    A1 = np.asarray(jb.A)[:1]
    jp = jpdhg.prepare_batch(jnp.asarray(A1), jnp.asarray(jb.row_lo),
                             jnp.asarray(jb.row_hi))
    tp = pdhg.prepare_batch(torch.from_numpy(A1.copy()), tb.row_lo,
                            tb.row_hi, v0=_jax_draw(1, tb.num_vars))
    assert tp.A.shape == (1, tb.num_rows, tb.num_vars)
    assert (tp.d_row.shape, tp.d_col.shape, tp.anorm.shape) == \
        ((1, tb.num_rows), (1, tb.num_vars), (1,))
    for f in ("A", "d_row", "d_col", "anorm", "row_lo", "row_hi"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)),
                                   rtol=1e-12, atol=0, err_msg=f)


def test_solver_on_split_prep_matches_jax(farmer8):
    jb, jprep, tb = farmer8
    cfg = {"eps": 1e-7}
    jres = jpdhg.PDHGSolver(**cfg).solve(
        jprep, jnp.asarray(jb.c), jnp.asarray(jb.qdiag),
        jnp.asarray(jb.lb), jnp.asarray(jb.ub),
        obj_const=jnp.asarray(jb.obj_const))
    prep = prep_from_arrays(to_arrays(jprep), device="cpu")
    res = pdhg.PDHGSolver(**cfg).solve(prep, tb.c, tb.qdiag, tb.lb, tb.ub,
                                       obj_const=tb.obj_const)
    assert bool(res.converged.all())
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    assert res.iters == int(jres.iters)
    np.testing.assert_array_equal(res.restarts.numpy(),
                                  np.asarray(jres.restarts))
    for f in ("x", "y", "obj", "dual_obj"):
        _close(getattr(res, f), getattr(jres, f), 1e-8)


NAMES = [f"scen{i}" for i in range(3)]
N_ITERS = 5
DEFAULT_OPTS = {"defaultPHrho": 1.0, "PHIterLimit": N_ITERS,
                "convthresh": 0.0, "pdhg_eps": 1e-7}


def _row(ph, bound):
    return {"bound": bound, "conv": ph.conv,
            "eobj": float(ph.Eobjective(ph.state.obj)),
            "xbar": np.asarray(ph.root_xbar())}


def _run(ph):
    rows = [_row(ph, ph.Iter0())]
    for _ in range(N_ITERS):
        ph.ph_iteration()
        rows.append(_row(ph, None))
    return rows


@pytest.fixture(scope="module")
def default_pair():
    jph = JPH(dict(DEFAULT_OPTS), NAMES, batch=jfarmer.build_batch(3),
              mesh=ScenarioMesh(devices=jax.devices()[:1]))
    tph = PH(dict(DEFAULT_OPTS), NAMES,
             batch=farmer.build_batch(3, device="cpu"), device="cpu",
             prep=prep_from_arrays(to_arrays(jph.prep), device="cpu"))
    return jph, tph, _run(jph), _run(tph)


def test_default_options_take_the_split_prep():
    """The repaired fault: without `no_split_prep` a batch that declares
    A_delta_idx gets the split prep's one shared scaling, as in the JAX
    package, not a per-scenario dense one."""
    b = farmer.build_batch(3, device="cpu")
    ph = PH(dict(DEFAULT_OPTS), NAMES, batch=b, device="cpu")
    assert isinstance(ph.prep.A, ir.SplitA)
    assert ph.prep.d_row.shape == (1, b.num_rows)
    assert ph.prep.d_col.shape == (1, b.num_vars)
    dense = PH(dict(DEFAULT_OPTS, no_split_prep=True), NAMES, batch=b,
               device="cpu")
    assert dense.prep.d_row.shape == (3, b.num_rows)


def test_ph_default_options_trajectory_matches_jax(default_pair):
    jph, tph, jrows, trows = default_pair
    assert isinstance(tph.prep.A, ir.SplitA)
    assert tph.prep.d_row.shape == (1, tph.batch.num_rows)
    assert _rel(trows[0]["bound"], jrows[0]["bound"]) <= 1e-6
    for k, (t, j) in enumerate(zip(trows, jrows)):
        for f in ("conv", "eobj", "xbar"):
            assert _rel(t[f], j[f]) <= 1e-6, (k, f, t[f], j[f])


def test_ph_default_options_bounds_match_jax(default_pair):
    jph, tph, _, _ = default_pair
    assert _rel(tph.lagrangian_bound(), jph.lagrangian_bound()) <= 1e-6
    xbar = np.asarray(jph.root_xbar())
    t_in, t_feas = tph.evaluate_xhat(xbar)
    j_in, j_feas = jph.evaluate_xhat(xbar)
    assert t_feas and j_feas
    assert _rel(t_in, j_in) <= 1e-5


def test_xhat_reduced_system_is_shared(default_pair):
    """Farmer's delta columns are all nonants, so the reduced xhat
    system collapses to a shared (1, M, N) A, as in
    tests/test_split_a.py:139; `no_split_prep` keeps it per scenario."""
    jph, tph, _, _ = default_pair
    t = tph._xhat_cache(None)
    j = jph._xhat_cache(None)
    assert t["A_red"].shape == tuple(j["A_red"].shape) \
        == (1, tph.batch.num_rows, tph.batch.num_vars)
    np.testing.assert_array_equal(t["A_red"].numpy(), np.asarray(j["A_red"]))
    assert t["prep"].d_row.shape == (1, tph.batch.num_rows)
    ph2 = PH(dict(DEFAULT_OPTS, no_split_prep=True), NAMES,
             batch=farmer.build_batch(3, device="cpu"), device="cpu")
    assert ph2._xhat_cache(None)["A_red"].shape[0] == ph2.batch.num_scens


@pytest.mark.parametrize("form, M, N, dtype, want", [
    ("dense", 61, 120, F32, "kernel"),
    ("dense", 200, 200, F64, "kernel"),       # global-memory source
    ("dense", 6001, 12000, F32, "matmul"),    # state beyond shared memory
    ("dense", 6001, 12000, F64, "matmul"),
    ("shared", 61, 120, F32, "kernel"),       # farmer cm=10
    ("split", 61, 120, F32, "kernel"),
    ("split", 61, 120, F64, "kernel"),
    ("split", 61, 120, BF16, "kernel"),
    ("split", 64, 128, F32, "kernel"),        # register tile's edge
    ("split", 65, 128, F32, "kernel"),        # shared-memory source
    ("shared", 64, 129, F64, "kernel"),
    ("split", 200, 200, F32, "kernel"),       # 160 KB of A in smem
    ("split", 200, 200, F64, "matmul"),       # 320 KB: global source
    ("shared", 200, 200, F64, "matmul"),
    ("split", 6001, 12000, F32, "matmul"),    # true-size farmer
    ("shared", 6001, 12000, F32, "matmul"),
    ("shared", 6001, 12000, F64, "matmul"),   # the xhat's f64 re-solve
    ("split", 6001, 12000, F64, "matmul"),
    ("split", 6001, 12000, BF16, "matmul"),
    ("sparse", 61, 120, F32, "matmul"),
])
def test_route_rule(form, M, N, dtype, want):
    assert pick_route(form, M, N, dtype) == want


@pytest.mark.parametrize("S", [1, 2, 1000])
def test_a_shared_operator_keeps_its_form_at_any_S(S):
    """The form follows the operator's shape, not the number of
    scenarios: one straggler left for the float64 re-solve on the
    true-size xhat system (1, 6001, 12000) still takes the matmul route
    (the kernel's state alone would exceed the shared-memory limit)."""
    A = torch.zeros((), dtype=F64).expand(1, 6001, 12000)
    form = pdhg_chunk.operator_form(A, S)
    assert form == "shared"
    assert pick_route(form, 6001, 12000, F64) == "matmul"
    with pytest.raises(ValueError, match="cannot launch"):
        card.pick(S, 6001, 12000, F64)
    dense = torch.zeros((), dtype=F64).expand(2, 6001, 12000)
    assert pdhg_chunk.operator_form(dense, 2) == "dense"
    assert pick_route("dense", 6001, 12000, F64) == "matmul"


def test_route_rule_follows_the_variant():
    """A shared or split A takes the kernel exactly where the register
    tile covers it or one block holds the whole matrix beside a state of
    (15 Np + 4 Mp) values (the rule's limits); there the variant is the
    register tile or the cluster kernel with the matrix resident, which
    one block alone could hold."""
    optin = pdhg_chunk.H100_SMEM_OPTIN
    for M, N in ((61, 120), (65, 129), (121, 240), (200, 200), (9, 300)):
        for dt in (F32, F64, BF16):
            cb, sb = pdhg_chunk.compute_dtype(dt).itemsize, dt.itemsize
            state = (15 * (-(-N // 128) * 128) + 4 * (-(-M // 32) * 32)) \
                * cb + M * N * sb
            reg = M <= 64 and N <= 128
            want = "kernel" if reg or state <= optin else "matmul"
            assert pick_route("split", M, N, dt) == want
            assert pick_route("shared", M, N, dt) == want
            if want == "kernel":
                v = card.pick(1000, M, N, dt)
                assert v.source == ("registers" if reg else "resident")
                assert reg or pdhg_chunk.Variant("resident", 1).smem_bytes(
                    M, N, cb, sb) <= optin
    with pytest.raises(ValueError, match="unknown operator form"):
        pick_route("bogus", 61, 120, F32)
    # the split form's register tile keeps a delta patch of 32 values a
    # thread in shared memory beside the state
    v = card.pick(1000, 61, 120, F32)
    assert v.smem_bytes(61, 120, 4, 4, "split") \
        - v.smem_bytes(61, 120, 4, 4) == 256 * 32 * 4


def _chunk_inputs(tb, prep):
    dc = prep.d_col
    qs = tb.qdiag * dc * dc
    lbs = tb.lb / dc
    ubs = torch.where(torch.isfinite(tb.ub), tb.ub / dc, tb.ub)
    x = torch.clamp(0.5 * (lbs + torch.clamp(ubs, max=1e3)), min=0.0)
    tau = 0.9 / (prep.anorm + 0.9 * qs.amax(dim=1))
    sigma = (0.9 / prep.anorm).expand(tau.shape).contiguous()
    return [t.contiguous() for t in (tb.c * dc, qs, lbs, ubs, prep.row_lo,
                                     prep.row_hi, x,
                                     torch.zeros_like(prep.row_lo), tau,
                                     sigma)]


def test_wrapper_split_and_shared_forms_on_cpu(farmer8):
    """On CPU tensors the wrapper runs each form's plain version (the
    dense plain version on the assembled per-scenario matrices), counts
    no launch, and the matmul route gives the same iterates."""
    _, jprep, tb = farmer8
    prep = prep_from_arrays(to_arrays(jprep), device="cpu")
    vec = _chunk_inputs(tb, prep)
    sp = prep.A.contiguous()
    sh = sp.shared[None].contiguous()
    before = pdhg_chunk.launches
    assert pdhg_chunk.operator_form(sp, 8) == "split"
    assert pdhg_chunk.operator_form(sh, 8) == "shared"
    assert pdhg_chunk.operator_form(sh, 1) == "shared"
    assert pdhg_chunk.operator_form(sp.to_dense(), 8) == "dense"
    got = pdhg_chunk.fused_chunk(sp, *vec, 40)
    want = pdhg_chunk.fused_chunk_reference(sp.to_dense(), *vec, 40)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    mm = pdhg.matmul_chunk(sp, *vec, 40)
    for g, w in zip(mm, want):
        _close(g, w, 1e-12)
    got = pdhg_chunk.fused_chunk(sh, *vec, 40)
    want = pdhg_chunk.fused_chunk_reference(sh.expand(8, -1, -1), *vec, 40)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert pdhg_chunk.launches == before
    bad = ir.SplitA(shared=sp.shared, rows=sp.rows.long(), cols=sp.cols,
                    vals=sp.vals)
    with pytest.raises(TypeError, match="int32"):
        pdhg_chunk.fused_chunk(bad, *vec, 3)
    with pytest.raises(ValueError, match="vals"):
        pdhg_chunk.fused_chunk(
            ir.SplitA(shared=sp.shared, rows=sp.rows, cols=sp.cols,
                      vals=sp.vals[:3].contiguous()), *vec, 3)
    with pytest.raises(TypeError, match="matmul route"):
        pdhg_chunk.fused_chunk(ir.sparsify_split(sp, 0.9), *vec, 3)
