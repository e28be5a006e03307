"""Port parity: the consensus (extensive-form) solves of
`mpisppy_tpu_torch/ops/pdhg.py` against the JAX package, float64 on the
CPU.

* shared_cols: the Ruiz factors of `_ruiz(shared_cols=True)` and of
  `prepare_batch(shared_cols=True)` agree with JAX's to 1e-12, for a
  dense (S, M, N) and a shared (1, M, N) A.
* consensus solves: fed the JAX prep (`convert.prep_from_arrays`) and
  the JAX PRNGKey(0) start vector of the EF power iteration
  (`ConsensusSpec.v0`), the port takes the same decisions (converged
  mask, iteration count, restart counts) and x, y, obj and dual_obj
  agree within 1e-8 relative to the largest magnitude.  Cases: farmer-3
  (its split prep), synthetic sslp (S=4, m=3, n=6), SIPLIB sslp_5_25 at
  S=5, and two stacked copies (num_copies=2).
* num_copies=2: each copy of the stacked solve equals the solve of that
  copy alone (given the same start vectors), and the stacked solve
  equals the JAX stacked solve.
* the route: a consensus solve runs on `consensus_chunk` and never on
  the kernel's wrapper or the matmul route.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.models import uc as juc
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.opt.ef import ExtensiveForm as JEF
from mpisppy_tpu.parallel.mesh import ScenarioMesh
from mpisppy_tpu_torch.convert import (batch_from_arrays,
                                       consensus_from_arrays,
                                       prep_from_arrays, to_arrays)
from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk

TOL = 1e-8
# one device: the JAX package pads a batch to its mesh size otherwise
ONE = ScenarioMesh(devices=jax.devices()[:1])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These cases are small: more intra-op threads than one only
    contend with the other test workers (several times slower under
    pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draw(S, N):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (S, N),
                                      jnp.float64))


def _close(got, want, rel=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    assert float(np.max(np.abs(got - want))) <= rel * scale


def _same(res, jres):
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    assert res.iters == int(jres.iters)
    np.testing.assert_array_equal(res.restarts.numpy(),
                                  np.asarray(jres.restarts))
    for f in ("x", "y", "obj", "dual_obj"):
        _close(getattr(res, f), getattr(jres, f))


@pytest.mark.parametrize("shared", [False, True], ids=["dense", "shared"])
def test_shared_cols_ruiz_matches_jax(shared):
    jb = (juc.build_batch(3, H=4) if shared
          else jsslp.build_batch(4, m_sites=3, n_clients=6))
    A = np.asarray(jb.A)
    jA, jdr, jdc = jpdhg._ruiz(jnp.asarray(A), shared_cols=True)
    tA, tdr, tdc = pdhg._ruiz(torch.from_numpy(A), shared_cols=True)
    assert tuple(tdc.shape) == (A.shape[0], A.shape[2])
    for got, want in ((tA, jA), (tdr, jdr), (tdc, jdc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=0)
    jp = jpdhg.prepare_batch(jnp.asarray(A), jnp.asarray(jb.row_lo),
                             jnp.asarray(jb.row_hi), shared_cols=True)
    tp = pdhg.prepare_batch(
        torch.from_numpy(A), torch.from_numpy(np.asarray(jb.row_lo)),
        torch.from_numpy(np.asarray(jb.row_hi)), shared_cols=True,
        v0=_jax_draw(A.shape[0], A.shape[2]))
    for f in ("A", "d_row", "d_col", "anorm", "row_lo", "row_hi"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)),
                                   rtol=1e-12, err_msg=f)


def _ef_case(name):
    """(JAX batch, JAX ExtensiveForm options) of a parity case."""
    if name == "farmer3":
        return jfarmer.build_batch(3), {"pdhg_eps": 1e-7}
    if name == "sslp_synthetic":
        return (jsslp.build_batch(4, m_sites=3, n_clients=6),
                {"pdhg_eps": 1e-7})
    return (jsslp.build_batch(5, instance="sslp_5_25"),
            {"pdhg_eps": 1e-6})


def _jax_ef(name):
    jb, opts = _ef_case(name)
    opts = dict(opts, pdhg_max_iters=200000)
    jef = JEF(opts, list(jb.tree.scen_names), batch=jb, mesh=ONE)
    return jb, jef, opts


def _port_inputs(jb, jef, v0=None):
    """The port's batch, the JAX EF's prep and spec carried over, and
    the probability-weighted objective arrays."""
    b = batch_from_arrays(to_arrays(jb), device="cpu")
    prep = prep_from_arrays(to_arrays(jef.prep), device="cpu")
    S, N = b.c.shape
    spec = consensus_from_arrays(to_arrays(jef.consensus), device="cpu",
                                 v0=_jax_draw(S, N) if v0 is None else v0)
    p = b.prob[:, None]
    return b, prep, spec, (b.c * p, b.qdiag * p, b.lb, b.ub,
                           b.obj_const * b.prob)


@pytest.mark.parametrize("name", ["farmer3", "sslp_synthetic",
                                  "sslp_5_25_S5"])
def test_consensus_solve_matches_jax(name):
    jb, jef, opts = _jax_ef(name)
    jres = jef.solve_extensive_form(certify=False)
    b, prep, spec, (c, q, lb, ub, oc) = _port_inputs(jb, jef)
    solver = pdhg.PDHGSolver.from_options(opts)
    k0, m0, c0 = (pdhg_chunk.launches, pdhg.matmul_chunks,
                  pdhg.consensus_chunks)
    res = solver.solve(prep, c, q, lb, ub, obj_const=oc, consensus=spec)
    # the consensus route, chosen by the spec: no kernel, no matmul chunk
    assert pdhg.consensus_chunks - c0 == res.iters // 40 > 0
    assert pdhg_chunk.launches == k0 and pdhg.matmul_chunks == m0
    assert bool(res.converged.all())
    _same(res, jres)
    # every scenario holds the same first-stage values
    x_na = b.nonants(res.x)
    assert float((x_na - x_na[0]).abs().max()) <= 1e-6 * max(
        1.0, float(x_na.abs().max()))


def _stacked(jb, jef, k_bounds):
    """The JAX EF's system stacked len(k_bounds)-fold as opt/mip's
    `_lp_multi` stacks it: node ids offset per copy, num_copies set;
    copy i takes its (lb, ub) from k_bounds[i]."""
    k = len(k_bounds)
    S = jb.num_scens
    prep = jef.prep

    def tile(a):
        return jnp.tile(jnp.asarray(a), (k,) + (1,) * (a.ndim - 1))

    sprep = dataclasses.replace(
        prep, A=tile(prep.A), row_lo=tile(prep.row_lo),
        row_hi=tile(prep.row_hi), d_row=tile(prep.d_row),
        d_col=tile(prep.d_col), anorm=tile(prep.anorm))
    node_of = np.asarray(jb.tree.node_of)
    spec = jpdhg.ConsensusSpec(
        node_of=jnp.asarray(np.concatenate(
            [node_of + i * jb.tree.num_nodes for i in range(k)])),
        nonant_idx=jb.nonant_idx, num_nodes=k * jb.tree.num_nodes,
        num_copies=k)
    p = np.asarray(jb.prob)[:, None]
    arrs = (np.tile(np.asarray(jb.c) * p, (k, 1)),
            np.tile(np.asarray(jb.qdiag) * p, (k, 1)),
            np.concatenate([lo for lo, _ in k_bounds]),
            np.concatenate([hi for _, hi in k_bounds]),
            np.tile(np.asarray(jb.obj_const) * np.asarray(jb.prob), k))
    return sprep, spec, arrs, S


def test_two_stacked_copies_match_separate_solves_and_jax():
    jb, jef, opts = _jax_ef("sslp_synthetic")
    lb, ub = np.asarray(jb.lb), np.asarray(jb.ub).copy()
    ub_closed = ub.copy()
    ub_closed[:, 0] = 0.0                       # copy 2: site 0 closed
    bounds = [(lb, ub), (lb, ub_closed)]
    sprep, sspec, arrs, S = _stacked(jb, jef, bounds)
    jsolver = jpdhg.PDHGSolver.from_options(opts)
    jres = jsolver.solve(sprep, *map(jnp.asarray, arrs[:4]),
                         obj_const=jnp.asarray(arrs[4]), consensus=sspec)
    N = arrs[0].shape[1]
    v0 = _jax_draw(2 * S, N)
    solver = pdhg.PDHGSolver.from_options(opts)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    spec = consensus_from_arrays(to_arrays(sspec), device="cpu", v0=v0)
    res = solver.solve(prep_from_arrays(to_arrays(sprep), device="cpu"),
                       *t[:4], obj_const=t[4], consensus=spec)
    assert bool(res.converged.all())
    _same(res, jres)
    # each copy alone, from the same rows of the start vector
    prep1 = prep_from_arrays(to_arrays(jef.prep), device="cpu")
    spec1 = consensus_from_arrays(to_arrays(jef.consensus), device="cpu")
    iters = []
    for i in range(2):
        sl = slice(i * S, (i + 1) * S)
        one = solver.solve(prep1, *(a[sl] for a in t[:4]),
                           obj_const=t[4][sl],
                           consensus=dataclasses.replace(spec1,
                                                         v0=v0[sl]))
        iters.append(one.iters)
        np.testing.assert_array_equal(one.converged.numpy(),
                                      res.converged[sl].numpy())
        np.testing.assert_array_equal(one.restarts.numpy(),
                                      res.restarts[sl].numpy())
        for f in ("x", "y", "obj", "dual_obj"):
            _close(getattr(res, f)[sl], getattr(one, f))
    assert res.iters == max(iters)
    # the copies are different problems: closing site 0 moves the EF
    assert abs(float(res.obj[:S].sum() - res.obj[S:].sum())) > 1e-3


def test_consensus_route_for_every_operator_form():
    """The route follows the spec, never the operator's form: a shared
    (1, M, N) UC operator (the kernel's shared form outside consensus)
    goes to consensus_chunk too, and agrees with JAX there."""
    jb = juc.build_batch(3, H=4)
    jef = JEF({"pdhg_eps": 1e-6, "pdhg_max_iters": 100000},
              list(jb.tree.scen_names), batch=jb, mesh=ONE)
    jres = jef.solve_extensive_form(certify=False)
    b, prep, spec, (c, q, lb, ub, oc) = _port_inputs(jb, jef)
    assert tuple(prep.A.shape)[0] == 1
    solver = pdhg.PDHGSolver(eps=1e-6, max_iters=100000)
    k0, c0 = pdhg_chunk.launches, pdhg.consensus_chunks
    res = solver.solve(prep, c, q, lb, ub, obj_const=oc, consensus=spec)
    assert pdhg.consensus_chunks - c0 == res.iters // 40
    assert pdhg_chunk.launches == k0
    _same(res, jres)
