"""Port parity: `mpisppy_tpu_torch/ops/pdhg.py` against the JAX
package's `mpisppy_tpu/ops/pdhg.py`, float64 on the CPU.

* prep: the Ruiz factors and the scaled operator agree to 1e-12; the
  norm estimate agrees to 1e-12 when the JAX PRNGKey(0) start vector is
  handed to the port as `v0` (torch's generator draws other numbers).
* solver: fed the JAX prep (converted with `convert.prep_from_arrays`),
  the port takes the same decisions — converged mask, iteration count,
  restart counts — and x, y and obj agree within 1e-8 relative to the
  largest magnitude.  The two sides differ only in floating-point
  summation order, far below every decision threshold on these
  instances.
* hot_dtype="bf16x" (A stored in bfloat16, float32 arithmetic) on an
  f32 farmer-8 batch, the main path's dtype: the same decisions, and x,
  y, obj and dual_obj within 1e-4 relative to the largest magnitude.
  The loop runs in float32, where the two sides' summation orders drift
  apart from ~1e-7 by some 1e-5 over a solve; the eps values are ones
  whose restart decisions stay clear of that drift.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu_torch import ir
from mpisppy_tpu_torch.convert import prep_from_arrays, to_arrays
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg


def _close(got, want, rel):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    assert float(np.max(np.abs(got - want))) <= rel * scale


@pytest.fixture(scope="module")
def farmer8():
    jb = jfarmer.build_batch(8)
    jprep = jpdhg.prepare_batch(jnp.asarray(jb.A), jnp.asarray(jb.row_lo),
                                jnp.asarray(jb.row_hi))
    return jb, jprep, farmer.build_batch(8, device="cpu")


def test_prepare_batch_matches_jax(farmer8):
    jb, jprep, tb = farmer8
    S, N = tb.c.shape
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (S, N),
                                      jnp.float64))
    tp = pdhg.prepare_batch(tb.A, tb.row_lo, tb.row_hi, v0=v0)
    for f in ("A", "d_row", "d_col", "anorm"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jprep, f)),
                                   rtol=1e-12, atol=0, err_msg=f)
    for f in ("row_lo", "row_hi"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jprep, f)),
                                   rtol=1e-12, err_msg=f)
    # torch's own draw gives an estimate of the same norm: 40 power
    # steps stop short of full convergence on farmer (close top
    # singular values), so another start vector moves it by ~0.2%
    own = pdhg.prepare_batch(tb.A, tb.row_lo, tb.row_hi)
    np.testing.assert_allclose(own.anorm.numpy(), np.asarray(jprep.anorm),
                               rtol=1e-2)


@pytest.mark.parametrize("cfg", [
    {"eps": 1e-7},
    {"eps": 1e-7, "restart_mode": "fixed", "restart_every": 4},
    {"eps": 1e-9, "max_iters": 2000},
], ids=["adaptive", "fixed", "capped"])
def test_solver_matches_jax_on_farmer8(farmer8, cfg):
    jb, jprep, tb = farmer8
    jres = jpdhg.PDHGSolver(**cfg).solve(
        jprep, jnp.asarray(jb.c), jnp.asarray(jb.qdiag),
        jnp.asarray(jb.lb), jnp.asarray(jb.ub),
        obj_const=jnp.asarray(jb.obj_const))
    prep = prep_from_arrays(to_arrays(jprep), device="cpu")
    res = pdhg.PDHGSolver(**cfg).solve(prep, tb.c, tb.qdiag, tb.lb, tb.ub,
                                       obj_const=tb.obj_const)
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    assert res.iters == int(jres.iters)
    np.testing.assert_array_equal(res.restarts.numpy(),
                                  np.asarray(jres.restarts))
    for f in ("x", "y", "obj", "dual_obj"):
        _close(getattr(res, f), getattr(jres, f), 1e-8)


def test_warm_start_eps_override_and_iters_cap(farmer8):
    jb, jprep, tb = farmer8
    prep = prep_from_arrays(to_arrays(jprep), device="cpu")
    js = jpdhg.PDHGSolver(eps=1e-6)
    ts = pdhg.PDHGSolver(eps=1e-6)
    rng = np.random.default_rng(3)
    x0 = np.abs(rng.standard_normal(np.asarray(jb.c).shape)) * 50.0
    jres = js.solve(jprep, jnp.asarray(jb.c), jnp.asarray(jb.qdiag),
                    jnp.asarray(jb.lb), jnp.asarray(jb.ub),
                    x0=jnp.asarray(x0), eps=jnp.asarray(1e-4),
                    iters_cap=jnp.asarray(200, jnp.int32))
    res = ts.solve(prep, tb.c, tb.qdiag, tb.lb, tb.ub,
                   x0=torch.from_numpy(x0), eps=1e-4, iters_cap=200)
    assert res.iters == int(jres.iters) <= 200
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    _close(res.x, jres.x, 1e-8)


def test_residuals_match_jax(farmer8):
    jb, jprep, tb = farmer8
    rng = np.random.default_rng(5)
    x = rng.standard_normal(np.asarray(jb.c).shape) * 10
    y = rng.standard_normal(np.asarray(jb.row_lo).shape)
    args = ("c", "qdiag", "A", "row_lo", "row_hi", "lb", "ub")
    want = jpdhg._residuals(jnp.asarray(x), jnp.asarray(y),
                            *(jnp.asarray(getattr(jb, a)) for a in args))
    got = pdhg._residuals(torch.from_numpy(x), torch.from_numpy(y),
                          *(getattr(tb, a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def test_hot_dtype_promotion_rule_matches_jax():
    for eps in (1e-3, 1e-5, 1e-7):
        js = jpdhg.PDHGSolver(eps=eps, hot_dtype="f32")
        ts = pdhg.PDHGSolver(eps=eps, hot_dtype="f32")
        assert ts.wants_promotion() == js.wants_promotion()
        assert ts.hot_eps_floor() == pytest.approx(js.hot_eps_floor())
    ts = pdhg.PDHGSolver(hot_dtype="f32")
    assert ts._hot_pair(torch.float64) == (torch.float32, torch.float32)
    assert ts._hot_pair(torch.float32) is None
    assert ts.clone(hot_dtype=None).config_key()[-2] is None
    assert pdhg.eps_floor(torch.float32) == jpdhg.eps_floor("float32")


def test_bf16x_knob_matches_jax():
    js = jpdhg.PDHGSolver(hot_dtype="bf16x")
    ts = pdhg.PDHGSolver(hot_dtype="bf16x")
    assert ts.hot_dtype == js.hot_dtype == "bf16x"
    # bf16x accumulates in f32, so its floor is f32's
    assert ts.hot_eps_floor() == pytest.approx(js.hot_eps_floor())
    for eps in (1e-4, 1e-5, 1e-6):
        assert ts.wants_promotion(eps) == js.wants_promotion(eps)
    for caller in (torch.float32, torch.float64):
        assert ts._hot_pair(caller) == (torch.bfloat16, torch.float32)
    assert ts.config_key() != ts.clone(hot_dtype="f32").config_key()


@pytest.fixture(scope="module")
def farmer8_f32():
    jb = jfarmer.build_batch(8, dtype=np.float32)
    jprep = jpdhg.prepare_batch(jnp.asarray(jb.A), jnp.asarray(jb.row_lo),
                                jnp.asarray(jb.row_hi))
    return jb, jprep, farmer.build_batch(8, dtype=np.float32, device="cpu")


@pytest.mark.parametrize("eps", [1e-4, 1e-5])
def test_bf16x_solver_matches_jax_on_farmer8(farmer8_f32, eps):
    jb, jprep, tb = farmer8_f32
    jres = jpdhg.PDHGSolver(eps=eps, hot_dtype="bf16x").solve(
        jprep, jnp.asarray(jb.c), jnp.asarray(jb.qdiag),
        jnp.asarray(jb.lb), jnp.asarray(jb.ub),
        obj_const=jnp.asarray(jb.obj_const))
    prep = prep_from_arrays(to_arrays(jprep), device="cpu")
    res = pdhg.PDHGSolver(eps=eps, hot_dtype="bf16x").solve(
        prep, tb.c, tb.qdiag, tb.lb, tb.ub, obj_const=tb.obj_const)
    assert res.x.dtype == torch.float32
    assert bool(res.converged.all())
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    assert res.iters == int(jres.iters)
    np.testing.assert_array_equal(res.restarts.numpy(),
                                  np.asarray(jres.restarts))
    for f in ("x", "y", "obj", "dual_obj"):
        _close(getattr(res, f), getattr(jres, f), 1e-4)


def test_hot_f32_loop_reaches_f64_verdict(farmer8):
    """An f64 batch under hot_dtype="f32": the loop runs in float32 and
    the final verdict is rechecked in float64, as in the JAX package."""
    _, _, tb = farmer8
    prep = pdhg.prepare_batch(tb.A.float(), tb.row_lo.float(),
                              tb.row_hi.float())
    res = pdhg.PDHGSolver(eps=1e-4, hot_dtype="f32").solve(
        prep, tb.c, tb.qdiag, tb.lb, tb.ub)
    assert res.x.dtype == torch.float64
    assert bool(res.converged.all())
    ref = pdhg.PDHGSolver(eps=1e-8).solve(
        pdhg.prepare_batch(tb.A, tb.row_lo, tb.row_hi),
        tb.c, tb.qdiag, tb.lb, tb.ub)
    np.testing.assert_allclose(res.obj.numpy(), ref.obj.numpy(), rtol=1e-3)


def test_unported_paths_refuse(monkeypatch):
    # compaction and the MPISPPY_TPU_PDHG overlay are ported
    # (tests/test_torch_compact.py holds them against the JAX package)
    assert pdhg.PDHGSolver(compact_threshold=0.5).compact_threshold == 0.5
    assert pdhg.PDHGSolver(hot_dtype="bf16x").hot_dtype == "bf16x"
    # the sparse shared block is ported, bar its bfloat16 storage
    assert pdhg.PDHGSolver(sparse_threshold=0.3).sparse_threshold == 0.3
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ir.sparsify_split(ir.SplitA(
            shared=torch.eye(2), rows=torch.zeros(1, dtype=torch.int32),
            cols=torch.zeros(1, dtype=torch.int32),
            vals=torch.ones((2, 1))), 0.9).astype(torch.bfloat16)
    assert callable(pdhg.PDHGSolver().solve_compacted)
    monkeypatch.setenv("MPISPPY_TPU_PDHG", "restart_mode=fixed")
    assert pdhg.PDHGSolver.from_options({}).restart_mode == "fixed"
