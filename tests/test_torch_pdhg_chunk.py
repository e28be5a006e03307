"""Port parity: the PDHG chunk kernel's wrapper and its plain twin
(`mpisppy_tpu_torch/ops/pdhg_chunk.py`) against the JAX package's
Pallas kernel `mpisppy_tpu.ops.pallas_pdhg.fused_chunk`, run in
interpret mode on the CPU as the JAX package's own tests run it.

Tolerance: atol 1e-10 in float64 — the twin does the kernel's
arithmetic in the same order; only the summation order inside the two
matvecs differs (einsum against multiply-and-reduce).  With A stored in
bfloat16 and float32 vectors both sides cast the same bf16 values up
once and run in float32: rtol 1e-5 and atol 1e-6, the tolerance of the
JAX package's own bf16-storage test (tests/test_precision.py:469-471),
with atol taken relative to the output's largest magnitude: farmer's
iterates reach a few hundred, and an entry that cancels to ~0 keeps
rounding of the f32 ulp of the terms it sums.

`pick_variant`, the kernel's choice of tile shape and of where it reads
A from, is plain Python and is checked here over a grid of shapes that
includes the register tiles' edges.

The CUDA kernel itself can only run on the card: see
tests/test_torch_cuda_kernel.py (jax-free, marked `cuda`) and
`python3 chip_smoke.py`, which holds the kernel against the twin at the
main path's shapes on the H100.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.ops.pallas_pdhg import fused_chunk as jax_fused_chunk
from mpisppy_tpu.ops.pdhg import prepare_batch as jax_prepare_batch
from mpisppy_tpu_torch.ops import pdhg_chunk
from mpisppy_tpu_torch.ops.pdhg_chunk import (Variant, fused_chunk,
                                              fused_chunk_reference,
                                              pick_variant)

ORDER = ("A", "cs", "qs", "lb", "ub", "rlo", "rhi", "x", "y", "tau",
         "sigma")


def _random_instance():
    """The random instance of tests/test_pallas_kernel.py (infinite
    row lower bounds included)."""
    rng = np.random.RandomState(0)
    S, M, N = 4, 5, 7
    return {
        "A": rng.randn(S, M, N), "cs": rng.randn(S, N),
        "qs": np.abs(rng.randn(S, N)) * 0.1, "lb": np.zeros((S, N)),
        "ub": np.full((S, N), 10.0),
        "rlo": np.where(rng.rand(S, M) < 0.5, -np.inf, -rng.rand(S, M)),
        "rhi": rng.rand(S, M) + 1.0, "x": rng.rand(S, N),
        "y": rng.randn(S, M) * 0.1, "tau": 0.1 + 0.05 * rng.rand(S),
        "sigma": 0.1 + 0.05 * rng.rand(S)}


def _farmer_instance():
    """Solver-space inputs of farmer-8 as PDHGSolver hands them to the
    chunk (Ruiz-scaled, omega=1 step sizes, cold start)."""
    b = jfarmer.build_batch(8)
    p = jax_prepare_batch(jnp.asarray(b.A), jnp.asarray(b.row_lo),
                          jnp.asarray(b.row_hi))
    dc = np.asarray(p.d_col)
    anorm = np.asarray(p.anorm)
    qs = np.asarray(b.qdiag) * dc * dc
    S, N = dc.shape
    M = np.asarray(p.row_lo).shape[1]
    return {
        "A": np.asarray(p.A), "cs": np.asarray(b.c) * dc, "qs": qs,
        "lb": np.asarray(b.lb) / dc, "ub": np.asarray(b.ub) / dc,
        "rlo": np.asarray(p.row_lo), "rhi": np.asarray(p.row_hi),
        "x": np.zeros((S, N)), "y": np.zeros((S, M)),
        "tau": 0.9 / (anorm + 0.9 * qs.max(axis=1)),
        "sigma": 0.9 / anorm}


@pytest.fixture(scope="module", params=["random", "farmer8"])
def instance(request):
    return _random_instance() if request.param == "random" \
        else _farmer_instance()


def _torch(inst, dtype=torch.float64, device="cpu"):
    return [torch.as_tensor(np.array(inst[k]), dtype=dtype, device=device)
            for k in ORDER]


@pytest.mark.parametrize("n_steps", [1, 7, 40])
def test_twin_matches_pallas_interpret(instance, n_steps):
    want = jax_fused_chunk(*(jnp.asarray(instance[k]) for k in ORDER),
                           n_steps, tile_s=2, interpret=True)
    got = fused_chunk_reference(*_torch(instance), n_steps)
    for name, g, w in zip(("x", "y", "xs", "ys"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-10, err_msg=name)


@pytest.mark.parametrize("n_steps", [7, 40])
def test_twin_bf16_storage_matches_pallas_interpret(instance, n_steps):
    """A stored in bfloat16, vectors in float32 (hot_dtype="bf16x"):
    the Pallas body casts its tile up once, the twin casts A up once."""
    vecs = [np.asarray(instance[k], np.float32) for k in ORDER[1:]]
    A32 = np.asarray(instance["A"], np.float32)
    want = jax_fused_chunk(jnp.asarray(A32).astype(jnp.bfloat16),
                           *(jnp.asarray(v) for v in vecs), n_steps,
                           tile_s=2, interpret=True)
    got = fused_chunk_reference(
        torch.from_numpy(A32).to(torch.bfloat16),
        *(torch.from_numpy(v) for v in vecs), n_steps)
    for name, g, w in zip(("x", "y", "xs", "ys"), got, want):
        assert g.dtype == torch.float32
        scale = max(1.0, float(np.max(np.abs(np.asarray(w)))))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=name)


def test_wrapper_takes_bf16_storage_with_f32_vectors_only():
    args = _torch(_random_instance(), dtype=torch.float32)
    args[0] = args[0].to(torch.bfloat16)
    before = pdhg_chunk.launches
    got = fused_chunk(*args, 5)
    want = fused_chunk_reference(*args, 5)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    assert pdhg_chunk.launches == before
    wide = [args[0]] + [a.double() for a in args[1:]]
    with pytest.raises(TypeError, match="bfloat16 A takes float32"):
        fused_chunk(*wide, 5)


def test_wrapper_on_cpu_is_the_twin_and_counts_no_launch(instance):
    before = pdhg_chunk.launches
    args = _torch(instance)
    got = fused_chunk(*args, 5)
    want = fused_chunk_reference(*args, 5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert pdhg_chunk.launches == before
    assert sum(pdhg_chunk.launch_shapes.values()) == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = _torch(_random_instance())
    mixed = list(args)
    mixed[1] = mixed[1].float()
    with pytest.raises(TypeError, match="share one dtype"):
        fused_chunk(*mixed, 3)
    halves = [a.half() for a in args]
    with pytest.raises(TypeError, match="float32 or float64"):
        fused_chunk(*halves, 3)
    bad = list(args)
    bad[7] = bad[7][:, :-1].contiguous()          # x (S, N-1)
    with pytest.raises(ValueError, match="x must be"):
        fused_chunk(*bad, 3)
    bad = list(args)
    bad[9] = bad[9][:, None]                      # tau (S, 1)
    with pytest.raises(ValueError, match="tau must be"):
        fused_chunk(*bad, 3)
    bad = list(args)
    bad[0] = bad[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_chunk(*bad, 3)
    with pytest.raises(ValueError, match="n_steps"):
        fused_chunk(*args, -1)
    with pytest.raises(ValueError, match="A must be"):
        fused_chunk(args[0][0], *args[1:], 3)


F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16


REG = Variant(8, 1, 8, "registers")
SHARED = Variant(4, 1, 8, "shared")
GLOBAL = Variant(4, 1, 8, "global")


@pytest.mark.parametrize("M, N, dtype, want", [
    (61, 120, F32, REG),          # the main path: farmer cm=10
    (61, 120, BF16, REG),
    (61, 120, F64, REG),          # the f64 certify
    (13, 24, F32, REG),           # farmer cm=2
    (1, 1, F32, REG),
    (64, 128, F32, REG),
    (64, 128, BF16, REG),
    (64, 128, F64, REG),
    (65, 128, F32, SHARED),
    (64, 129, F32, SHARED),
    (65, 129, BF16, SHARED),
    (65, 128, F64, SHARED),
    (64, 129, F64, SHARED),
    (9, 300, F32, SHARED),
    (9, 300, F64, SHARED),
    (200, 200, F32, SHARED),
    (200, 200, BF16, SHARED),
    (200, 200, F64, GLOBAL),      # 320 KB of A
])
def test_pick_variant(M, N, dtype, want):
    v = pick_variant(M, N, dtype)
    assert v == want
    if v.source == "registers":
        assert M <= v.tile_rows and N <= v.tile_cols
        # 32 values of A a thread, held in the compute dtype (bf16
        # storage is converted as it is loaded)
        assert v.rows_per_thread * 4 * v.vectors_per_lane == 32


def test_pick_variant_sizes_and_limits():
    v = pick_variant(61, 120, F32)
    assert (v.warps, v.tile_rows, v.tile_cols) == (8, 64, 128)
    # x, x~, c, q, lb, ub, xsum and the (8, 128) reduction buffer over
    # 128 columns; y, rlo, rhi, ysum over 64 rows
    assert v.smem_bytes(61, 120, 4, 4) == (15 * 128 + 4 * 64) * 4
    g = Variant(4, 1, 8, "shared")
    assert g.smem_bytes(9, 300, 4, 2) - g.smem_bytes(9, 300, 4, 4) \
        == -9 * 300 * 2
    # A in shared memory only while it fits the opt-in limit
    assert pick_variant(200, 200, F32, smem_optin=100_000).source == "global"
    with pytest.raises(ValueError, match="cannot launch"):
        pick_variant(4, 100_000, F64)
    with pytest.raises(TypeError, match="no kernel"):
        pick_variant(61, 120, torch.float16)
