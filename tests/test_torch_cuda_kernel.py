"""The CUDA PDHG chunk kernel on the card, against its plain torch twin.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch with CUDA.  There the repository's
conftest (which imports jax) is skipped:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernel.py

Without a CUDA device every test skips (decided inside the fixture).
The shared (1, M, N) and split (`ir.SplitA`) forms assemble the same
per-scenario tile as the dense form, so on the card each equals the
dense kernel on `A.to_dense()` bit for bit, and matches its own plain
version to the tolerance below.
Tolerance: max|kernel - twin| <= tol * max(1, max|twin|), tol 1e-9 in
float64 and 2e-4 in float32 and with A stored in bfloat16 (float32
vectors; the twin casts the same bf16 values up) — the two differ only
in the summation order inside the matvecs (chip_smoke.py uses the same
figures at the main path's shapes).  The shapes include the edges of
the register tiles (M 64/65, N 128/129), the looping variants with A in
shared and in global memory, and a batch of 3 scenarios that leaves
most of the card idle.
"""

import numpy as np
import pytest
import torch

from mpisppy_tpu_torch import ir
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
from mpisppy_tpu_torch.ops.pdhg import (PDHGSolver, prepare_batch,
                                        prepare_split_native)
from mpisppy_tpu_torch.ops.pdhg_chunk import (compute_dtype, fused_chunk,
                                              fused_chunk_reference,
                                              pick_variant)

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-9, torch.float32: 2e-4, torch.bfloat16: 2e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: run on the card with "
                    "python -m pytest --noconftest "
                    "tests/test_torch_cuda_kernel.py")
    return torch.device("cuda")


def _instance(S, M, N, seed, dtype, device):
    """A random PDHG chunk input with infinite row lower bounds; A is
    stored in `dtype`, the vectors in its compute dtype."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((S, M, N)), rng.standard_normal((S, N)),
            np.abs(rng.standard_normal((S, N))) * 0.1, np.zeros((S, N)),
            np.full((S, N), 10.0),
            np.where(rng.random((S, M)) < 0.5, -np.inf,
                     -rng.random((S, M))),
            rng.random((S, M)) + 1.0, rng.random((S, N)),
            rng.standard_normal((S, M)) * 0.1,
            0.05 + 0.02 * rng.random(S), 0.05 + 0.02 * rng.random(S)]
    out = [torch.as_tensor(a, dtype=compute_dtype(dtype), device=device)
           for a in arrs]
    out[0] = out[0].to(dtype)
    return out


def _assert_matches(got, want, dtype):
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 7), (16, 61, 120), (4, 9, 300),
                                   (2, 200, 200), (5, 64, 128),
                                   (5, 65, 128), (5, 64, 129),
                                   (3, 61, 120)],
                         ids=["tiny", "farmer_cm10", "wide_N", "A_global",
                              "tile_full", "M_edge", "N_edge", "S3"])
def test_kernel_matches_twin(cuda, dtype, shape):
    S, M, N = shape
    args = _instance(S, M, N, 1, dtype, cuda)
    v = pick_variant(M, N, dtype, pdhg_chunk.smem_optin())
    if shape == (2, 200, 200) and dtype == torch.float64:
        assert v.source == "global"     # 320 KB of A
    if shape == (16, 61, 120):
        assert v.source == "registers"  # the main path's shapes
    before = pdhg_chunk.launches
    key = ("dense", S, M, N, str(dtype).replace("torch.", ""))
    by_key = pdhg_chunk.launch_shapes[key]
    got = fused_chunk(*args, 40)
    torch.cuda.synchronize()
    assert pdhg_chunk.launches == before + 1
    assert pdhg_chunk.launch_shapes[key] == by_key + 1
    for g in got:
        assert g.dtype == compute_dtype(dtype)
    _assert_matches(got, fused_chunk_reference(*args, 40), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_occupancy_at_the_main_path_shape(cuda, dtype):
    v, blocks = pdhg_chunk.occupancy(61, 120, dtype)
    assert v.source == "registers"
    assert blocks >= 1
    if dtype != torch.float64:
        assert blocks >= 2


@pytest.mark.parametrize("n_steps", [0, 1, 7])
def test_kernel_short_chunks(cuda, n_steps):
    args = _instance(5, 13, 24, 2, torch.float64, cuda)
    got = fused_chunk(*args, n_steps)
    _assert_matches(got, fused_chunk_reference(*args, n_steps),
                    torch.float64)


def test_wrapper_refuses_mixed_devices(cuda):
    args = _instance(3, 5, 7, 3, torch.float64, cuda)
    args[7] = args[7].cpu()
    with pytest.raises(ValueError, match="is on cpu"):
        fused_chunk(*args, 3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_solver_on_card_matches_cpu(cuda, dtype):
    """farmer-8 solved on the card (through the kernel) and on the CPU
    (through the twin) from the same prep: same verdict, objectives
    within the solve tolerance."""
    b = farmer.build_batch(8, crops_multiplier=2, dtype=dtype,
                           device="cpu")
    prep = prepare_batch(b.A, b.row_lo, b.row_hi)
    eps = 1e-4 if dtype == np.float32 else 1e-7
    solver = PDHGSolver(eps=eps)
    ref = solver.solve(prep, b.c, b.qdiag, b.lb, b.ub)
    bc = b.to(cuda)
    before = pdhg_chunk.launches
    res = solver.solve(prep.map(lambda t: t.to(cuda)), bc.c, bc.qdiag,
                       bc.lb, bc.ub)
    assert pdhg_chunk.launches - before == res.iters // 40 > 0
    assert bool(res.converged.all()) and bool(ref.converged.all())
    np.testing.assert_allclose(res.obj.cpu().numpy(), ref.obj.numpy(),
                               rtol=10 * eps)


def test_bf16x_solver_on_card_matches_cpu(cuda):
    """farmer-8 in f32 under hot_dtype="bf16x": on the card the chunks
    launch the bf16 kernel; the verdict and objectives match the CPU
    run through the twin within the solve tolerance."""
    b = farmer.build_batch(8, crops_multiplier=2, dtype=np.float32,
                           device="cpu")
    prep = prepare_batch(b.A, b.row_lo, b.row_hi)
    solver = PDHGSolver(eps=1e-4, hot_dtype="bf16x")
    ref = solver.solve(prep, b.c, b.qdiag, b.lb, b.ub)
    bc = b.to(cuda)
    key = ("dense", 8, b.A.shape[1], b.A.shape[2], "bfloat16")
    before = pdhg_chunk.launch_shapes[key]
    res = solver.solve(prep.map(lambda t: t.to(cuda)), bc.c, bc.qdiag,
                       bc.lb, bc.ub)
    assert pdhg_chunk.launch_shapes[key] - before == res.iters // 40 > 0
    assert bool(res.converged.all()) and bool(ref.converged.all())
    np.testing.assert_allclose(res.obj.cpu().numpy(), ref.obj.numpy(),
                               rtol=1e-3)


def _split_of(A, rng, nnz):
    """A SplitA whose assembled matrices are A with `nnz` random delta
    slots per scenario (a repeated (row, col) pair included)."""
    S, M, N = A.shape
    rows = rng.integers(0, M, size=nnz).astype(np.int32)
    cols = rng.integers(0, N, size=nnz).astype(np.int32)
    rows[-1], cols[-1] = rows[0], cols[0]
    shared = A[0].clone()
    shared[torch.as_tensor(rows).long(), torch.as_tensor(cols).long()] = 0
    vals = torch.as_tensor(rng.standard_normal((S, nnz)), dtype=A.dtype,
                           device=A.device)
    return ir.SplitA(shared=shared.contiguous(),
                     rows=torch.as_tensor(rows, device=A.device),
                     cols=torch.as_tensor(cols, device=A.device),
                     vals=vals)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 61, 120), (5, 64, 128),
                                   (4, 65, 129), (3, 9, 300)],
                         ids=["farmer_cm10", "tile_full", "smem_edge",
                              "wide_N"])
@pytest.mark.parametrize("form", ["shared", "split"])
def test_shared_and_split_forms_equal_the_dense_kernel(cuda, dtype, shape,
                                                       form):
    S, M, N = shape
    args = _instance(S, M, N, 5, dtype, cuda)
    rng = np.random.default_rng(6)
    if form == "shared":
        A = args[0][:1].contiguous()
        dense = A.expand(S, M, N).contiguous()
        ref = pdhg_chunk.fused_chunk_shared_reference
    else:
        A = _split_of(args[0], rng, 2 * M)
        dense = A.to_dense().contiguous()
        ref = pdhg_chunk.fused_chunk_split_reference
    before = pdhg_chunk.launches_by("form").get(form, 0)
    got = fused_chunk(A, *args[1:], 40)
    torch.cuda.synchronize()
    assert pdhg_chunk.launches_by("form")[form] == before + 1
    want_dense = fused_chunk(dense, *args[1:], 40)
    for g, w in zip(got, want_dense):
        assert torch.equal(g, w)
    _assert_matches(got, ref(A, *args[1:], 40), dtype)


def test_occupancy_of_the_forms(cuda):
    for form in ("dense", "shared", "split"):
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            v, blocks = pdhg_chunk.occupancy(61, 120, dtype, form)
            assert v.source == "registers" and blocks >= 1


def test_wrapper_refuses_a_matmul_route_operator(cuda):
    A = torch.zeros((1, 300, 300), dtype=torch.float64, device=cuda)
    args = _instance(2, 300, 300, 7, torch.float64, cuda)
    with pytest.raises(ValueError, match="matmul route"):
        fused_chunk(A, *args[1:], 3)


def test_split_prep_solver_on_card_matches_cpu(cuda):
    """farmer-8 born split: the card runs the split form of the kernel,
    the CPU its plain version, from one prep; the verdicts and
    objectives match within the solve tolerance, and the matmul route
    on the card gives the same objectives."""
    b = farmer.build_batch(8, crops_multiplier=2, split=True, device="cpu")
    prep = prepare_split_native(b.A, b.row_lo, b.row_hi)
    solver = PDHGSolver(eps=1e-7)
    ref = solver.solve(prep, b.c, b.qdiag, b.lb, b.ub)
    bc = b.to(cuda)
    pc = prep.map(lambda t: t.to(cuda))
    before = pdhg_chunk.launches_by("form").get("split", 0)
    res = solver.solve(pc, bc.c, bc.qdiag, bc.lb, bc.ub)
    assert pdhg_chunk.launches_by("form")["split"] - before \
        == res.iters // 40 > 0
    assert bool(res.converged.all()) and bool(ref.converged.all())
    np.testing.assert_allclose(res.obj.cpu().numpy(), ref.obj.numpy(),
                               rtol=1e-6)
    m0 = pdhg.matmul_chunks
    sparse = pdhg.PreparedBatch(**{**prep.__dict__, "A": ir.sparsify_split(
        pc.A, 0.9)}).map(lambda t: t.to(cuda))
    mm = solver.solve(sparse, bc.c, bc.qdiag, bc.lb, bc.ub)
    assert pdhg.matmul_chunks - m0 == mm.iters // 40 > 0
    assert bool(mm.converged.all())
    np.testing.assert_allclose(mm.obj.cpu().numpy(), ref.obj.numpy(),
                               rtol=1e-6)


def test_single_straggler_on_a_shared_A_beyond_the_tile(cuda):
    """One scenario left for a float64 re-solve on a shared (1, M, N)
    operator whose kernel state would not fit in shared memory: the
    operator keeps its shared form at S=1, so the solve takes the matmul
    route instead of failing to launch, and agrees with the same solve
    on the CPU."""
    M, N = 1500, 3000
    with pytest.raises(ValueError, match="cannot launch"):
        pick_variant(M, N, torch.float64)
    rng = np.random.default_rng(11)
    A = torch.from_numpy(rng.standard_normal((1, M, N)) / np.sqrt(N))
    rlo = torch.from_numpy(-rng.random((1, M)) - 1.0)
    rhi = torch.from_numpy(rng.random((1, M)) + 1.0)
    c = torch.from_numpy(rng.standard_normal((1, N)))
    q = torch.full((1, N), 0.1, dtype=torch.float64)
    lb, ub = torch.full((1, N), -5.0, dtype=torch.float64), \
        torch.full((1, N), 5.0, dtype=torch.float64)
    solver = PDHGSolver(max_iters=120, eps=1e-9)
    prep = prepare_batch(A, rlo, rhi, v0=torch.ones((1, N),
                                                    dtype=torch.float64))
    ref = solver.solve(prep, c, q, lb, ub)
    m0, k0 = pdhg.matmul_chunks, pdhg_chunk.launches
    got = solver.solve(prep.map(lambda t: t.to(cuda)),
                       *(t.to(cuda) for t in (c, q, lb, ub)))
    assert pdhg.matmul_chunks - m0 == got.iters // 40 == 3
    assert pdhg_chunk.launches == k0
    assert got.iters == ref.iters
    for f in ("x", "y", "obj"):
        g, w = getattr(got, f).cpu(), getattr(ref, f)
        assert float((g - w).abs().max()) <= 1e-9 * max(
            1.0, float(w.abs().max()))
