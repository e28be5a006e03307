"""The CUDA PDHG chunk kernel on the card, against its plain torch twin.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch with CUDA.  There the repository's
conftest (which imports jax) is skipped:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernel.py

Without a CUDA device every test skips (decided inside the fixture).
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

from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg_chunk
from mpisppy_tpu_torch.ops.pdhg import PDHGSolver, prepare_batch
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
    key = (S, M, N, str(dtype).replace("torch.", ""))
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
    key = (8, b.A.shape[1], b.A.shape[2], "bfloat16")
    before = pdhg_chunk.launch_shapes[key]
    res = solver.solve(prep.map(lambda t: t.to(cuda)), bc.c, bc.qdiag,
                       bc.lb, bc.ub)
    assert pdhg_chunk.launch_shapes[key] - before == res.iters // 40 > 0
    assert bool(res.converged.all()) and bool(ref.converged.all())
    np.testing.assert_allclose(res.obj.cpu().numpy(), ref.obj.numpy(),
                               rtol=1e-3)
