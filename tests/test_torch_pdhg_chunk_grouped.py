"""Port parity: the chunk kernel's grouped forms (a coalesced group of B
requests, each with its own matrix: an `ir.GroupedA`, or a SplitA
whose shared block is (B, M, N); the S / B consecutive scenarios of a
request read its matrix).

* The grouped plain versions (`ops/pdhg_chunk.py`), request by request,
  against the JAX package's Pallas kernel
  `mpisppy_tpu.ops.pallas_pdhg.fused_chunk` in interpret mode on that
  request's dense matrices, at the tolerances of
  tests/test_torch_pdhg_chunk.py (atol 1e-10 in float64; with A stored
  in bfloat16, rtol 1e-5 and atol 1e-6 of the largest magnitude).
* The grouped operator products (`ir.bmatvec` / `bmatvec_t`, the
  solver's unscaling) equal each request's own; a group whose split
  deltas sit at different coordinates is refused, not densified, and a
  plain (B, M, N) tensor is never taken for a group.
The grouped kernel itself runs on the card:
tests/test_torch_cuda_grouped.py (jax-free, marked `cuda`).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpisppy_tpu.ops.pallas_pdhg import fused_chunk as jax_fused_chunk
from mpisppy_tpu_torch.ir import GroupedA, SplitA, bmatvec, bmatvec_t
from mpisppy_tpu_torch.ops import pdhg_chunk
from mpisppy_tpu_torch.ops.pdhg import PreparedBatch, _unscale_A
from mpisppy_tpu_torch.phbase import GroupRefused, stack_preps

B, PB, M, N = 3, 2, 5, 7          # 3 requests of 2 scenarios each
ROWS = np.array([0, 2, 4, 2], np.int32)
COLS = np.array([1, 3, 3, 6], np.int32)    # column 3 twice


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vectors(S, seed, dtype=torch.float64, device="cpu"):
    """cs, qs, lb, ub, rlo, rhi, x, y, tau, sigma of a random chunk input
    (infinite row lower bounds included)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((S, N)),
            np.abs(rng.standard_normal((S, N))) * 0.1, np.zeros((S, N)),
            np.full((S, N), 10.0),
            np.where(rng.random((S, M)) < 0.5, -np.inf,
                     -rng.random((S, M))),
            rng.random((S, M)) + 1.0, rng.random((S, N)),
            rng.standard_normal((S, M)) * 0.1,
            0.1 + 0.05 * rng.random(S), 0.1 + 0.05 * rng.random(S)]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrs]


def _group(form, storage, seed=0, device="cpu", bases=B, per_base=PB):
    """(A, vectors) of a group: the grouped operator in `storage`, the
    vectors in its compute dtype."""
    rng = np.random.default_rng(100 + seed)
    S = bases * per_base
    compute = pdhg_chunk.compute_dtype(storage)
    vec = _vectors(S, seed, compute, device)
    shared = torch.as_tensor(rng.standard_normal((bases, M, N)),
                             device=device)
    if form == "shared":
        return GroupedA(stack=shared.to(storage), per_base=per_base), vec
    shared[:, ROWS, COLS] = 0.0
    A = SplitA(shared=shared.to(storage),
               rows=torch.as_tensor(ROWS, device=device),
               cols=torch.as_tensor(COLS, device=device),
               vals=torch.as_tensor(rng.standard_normal((S, ROWS.size)),
                                    device=device).to(storage))
    return A, vec


def _request_dense(A, b, S):
    """Request b's per-scenario dense matrices (PB, M, N)."""
    if isinstance(A, SplitA):
        return A.to_dense()[b * PB:(b + 1) * PB]
    return A.stack[b:b + 1].expand(PB, M, N)


@pytest.mark.parametrize("form", ["shared", "split"])
def test_grouped_plain_versions_match_pallas_per_request(form):
    for storage in (torch.float64, torch.bfloat16):
        A, vec = _group(form, storage)
        got = pdhg_chunk.fused_chunk(A, *vec, 7)
        ref = pdhg_chunk.REFERENCE[form](A, *vec, 7)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        for b in range(B):
            rows = slice(b * PB, (b + 1) * PB)
            dense = _request_dense(A, b, B * PB).to(torch.float32
                                                    if storage
                                                    == torch.bfloat16
                                                    else storage)
            Aj = jnp.asarray(dense.numpy())
            if storage == torch.bfloat16:
                Aj = Aj.astype(jnp.bfloat16)
            want = jax_fused_chunk(Aj, *(jnp.asarray(v[rows].numpy())
                                         for v in vec), 7, tile_s=PB,
                                   interpret=True)
            for name, g, w in zip(("x", "y", "xs", "ys"), got, want):
                w = np.asarray(w)
                if storage == torch.float64:
                    np.testing.assert_allclose(g[rows].numpy(), w, rtol=0,
                                               atol=1e-10, err_msg=name)
                else:
                    scale = max(1.0, float(np.max(np.abs(w))))
                    np.testing.assert_allclose(g[rows].numpy(), w,
                                               rtol=1e-5,
                                               atol=1e-6 * scale,
                                               err_msg=name)


def test_grouped_operators_and_refusals():
    S = B * PB
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((S, N)))
    y = torch.as_tensor(np.random.default_rng(2).standard_normal((S, M)))
    for form in ("shared", "split"):
        A, _ = _group(form, torch.float64)
        assert pdhg_chunk.operator_form(A, S) == form
        for b in range(B):
            rows = slice(b * PB, (b + 1) * PB)
            if form == "split":
                one = dataclasses.replace(A, shared=A.shared[b],
                                          vals=A.vals[rows])
            else:
                one = A.stack[b:b + 1]
            torch.testing.assert_close(bmatvec(A, x)[rows],
                                       bmatvec(one, x[rows]), rtol=0,
                                       atol=1e-12)
            torch.testing.assert_close(bmatvec_t(A, y)[rows],
                                       bmatvec_t(one, y[rows]), rtol=0,
                                       atol=1e-12)
        # the unscaled operator: each request by its own scaling
        dr = torch.rand(S, M, dtype=torch.float64) + 0.5
        dc = torch.rand(S, N, dtype=torch.float64) + 0.5
        dr = dr[::PB].repeat_interleave(PB, 0)
        dc = dc[::PB].repeat_interleave(PB, 0)
        un = _unscale_A(A, dr, dc)
        dense = (un.to_dense() if form == "split"
                 else un.stack.repeat_interleave(PB, 0))
        want = ((A.to_dense() if form == "split"
                 else A.stack.repeat_interleave(PB, 0))
                / dr[:, :, None] / dc[:, None, :])
        torch.testing.assert_close(dense, want, rtol=1e-14, atol=0)
    # a plain tensor of B matrices is no group: the kernel's wrapper
    # refuses it
    A, vec = _group("shared", torch.float64)
    with pytest.raises(ValueError, match=r"\(S, M, N\) or \(1, M, N\)"):
        pdhg_chunk.fused_chunk(A.stack, *vec, 7)
    # the route rule reads one matrix a block, grouped or not
    assert pdhg_chunk.pick_route("shared", 174, 114, torch.float32) \
        == "kernel"

    def prep(A):
        return PreparedBatch(A=A, row_lo=torch.zeros(PB, M),
                             row_hi=torch.ones(PB, M),
                             d_row=torch.ones(1, M), d_col=torch.ones(1, N),
                             anorm=torch.ones(1))
    one, _ = _group("split", torch.float32, bases=1)
    one = dataclasses.replace(one, shared=one.shared[0])
    moved = dataclasses.replace(one, cols=one.cols.flip(0))
    g = stack_preps([prep(one), prep(one)], PB)
    assert g.A.shared.shape == (2, M, N) and g.A.per_base == PB
    assert g.anorm.shape == (2 * PB,) and g.d_row.shape == (2 * PB, M)
    with pytest.raises(GroupRefused, match="different coordinates"):
        stack_preps([prep(one), prep(moved)], PB)
    with pytest.raises(GroupRefused):
        stack_preps([prep(one), prep(torch.zeros(1, M, N))], PB)
    g = stack_preps([prep(torch.zeros(1, M, N)), prep(torch.ones(1, M, N))],
                    PB)
    assert isinstance(g.A, GroupedA) and g.A.per_base == PB
    assert pdhg_chunk.operator_form(g.A, 2 * PB) == "shared"
