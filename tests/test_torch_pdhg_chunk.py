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

`pick_variant`, the kernel's choice of tile shape, of where it reads
A from and of the cluster size, is plain Python and is checked here
over a grid of shapes that includes the register tiles' edges, with
the occupancy an H100 reported for each variant at those shapes
(`tests/h100_occupancy.py`) standing in for the card's query.

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

import h100_occupancy as card

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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, restored after the module: under the tier-1
    run's xdist workers more threads only slow these small products."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


REG = pdhg_chunk.REGISTER_TILE


def _res(C):
    return Variant("resident", C)


# (S, M, N, dtype, the variant pick_variant gives with an H100's
# occupancy readings): the register tile's edges, and the cluster
# kernel at every shape that reaches it on a path (aircondB's bundles,
# acopf3 ieee14 and its f64 certify at S'=4, FWPH's hull QP, sizes,
# UC's fallback, usar)
@pytest.mark.parametrize("S, M, N, dtype, want", [
    (1000, 61, 120, F32, REG),          # the main path: farmer cm=10
    (1000, 61, 120, BF16, REG),
    (1000, 61, 120, F64, REG),          # the f64 certify
    (1000, 13, 24, F32, REG),           # farmer cm=2
    (1, 1, 1, F32, REG),
    (5, 64, 128, F32, REG),
    (5, 64, 128, BF16, REG),
    (5, 64, 128, F64, REG),
    (4, 39, 72, F32, REG),              # acopf3 (2,2)
    (5, 65, 128, F32, _res(1)),         # the cluster's cost outweighs
    (5, 64, 129, F32, _res(1)),         # a band of 65 rows
    (5, 65, 128, F64, _res(1)),
    (5, 65, 129, BF16, _res(1)),
    (5, 64, 129, F64, _res(1)),
    (5, 9, 300, F32, _res(1)),          # one band of 9 rows
    (5, 9, 300, F64, _res(1)),
    (5, 200, 200, F32, _res(16)),
    (5, 200, 200, BF16, _res(16)),
    (5, 200, 200, F64, _res(16)),       # 320 KB of A across a cluster
    (1000, 65, 129, F32, _res(1)),
    (10, 1552, 1600, F32, Variant("streamed", 16, 7)),  # aircondB
    (10, 1552, 1600, BF16, Variant("streamed", 16, 8)),
    (12, 151, 268, F32, _res(16)),      # acopf3 ieee14
    (12, 151, 268, F64, _res(16)),
    (4, 151, 268, F64, _res(16)),       # its f64 certify
    (1000, 121, 136, F32, _res(1)),     # FWPH's hull QP
    (1000, 121, 136, F64, _res(2)),     # one block an SM at C = 1
    (3, 62, 150, F32, _res(1)),         # sizes
    (3, 62, 150, F64, _res(1)),
    (250, 174, 114, F32, _res(1)),      # UC's fallback
    (250, 174, 114, F64, _res(2)),     # one block an SM at C = 1
    (250, 174, 114, BF16, _res(1)),
    (3, 251, 314, F32, _res(16)),       # usar
    (3, 251, 314, F64, _res(16)),
    (1000, 151, 268, F64, _res(5)),     # C = 1 cannot hold A
    (1000, 251, 314, F32, _res(5)),
    (1000, 65, 129, F32, _res(1)),      # S fills the card: C = 1
])
def test_pick_variant(S, M, N, dtype, want):
    v = card.pick(S, M, N, dtype)
    assert v == want
    cb, sb = pdhg_chunk.compute_dtype(dtype).itemsize, dtype.itemsize
    assert v.smem_bytes(M, N, cb, sb) <= card.SMEM_OPTIN
    if v.source == "registers":
        assert M <= v.tile_rows and N <= v.tile_cols
        # 32 values of A a thread, held in the compute dtype (bf16
        # storage is converted as it is loaded)
        assert v.rows_per_thread * 4 * v.vectors_per_lane == 32
    else:
        assert M > v.tile_rows or N > v.tile_cols
        assert v.cluster <= max(1, M // pdhg_chunk.MIN_BAND_ROWS)


@pytest.mark.parametrize("M, N, dtype", [
    (1552, 1600, F32), (151, 268, F64), (121, 136, F32), (121, 136, F64),
    (62, 150, F32), (174, 114, BF16), (251, 314, F64), (200, 200, F64),
    (9, 300, F32), (40, 3000, F32), (700, 900, BF16)])
@pytest.mark.parametrize("S", [1, 3, 12, 131, 132, 1000])
def test_cluster_size_and_source_rules(S, M, N, dtype):
    """The rules behind pick_variant, at every shape of the cluster
    kernel's rows and a few more: A resident whenever some cluster size
    up to the band floor holds it, streamed only where none does; the
    smallest size that fits where S clusters of it fill the card with
    two blocks or more an SM; else the size that minimises rounds x
    (rows a block + CLUSTER_STEP_ROWS beyond one block).  The blocks an
    SM and clusters held are the card's readings."""
    cb, sb = pdhg_chunk.compute_dtype(dtype).itemsize, dtype.itemsize
    optin = card.SMEM_OPTIN
    v = card.pick(S, M, N, dtype)
    sizes = range(1, min(pdhg_chunk.MAX_CLUSTER,
                         max(1, M // pdhg_chunk.MIN_BAND_ROWS)) + 1)
    resident = [C for C in sizes
                if _res(C).smem_bytes(M, N, cb, sb) <= optin]
    assert v.source == ("resident" if resident else "streamed")
    assert v.smem_bytes(M, N, cb, sb) <= optin
    if v.source == "streamed":
        assert 1 <= v.stage_rows <= pdhg_chunk.STAGE_ROWS
    pool = resident or [C for C in sizes if pdhg_chunk._streamed(
        C, M, N, cb, sb, optin) is not None]

    def variant(C):
        return (_res(C) if v.source == "resident"
                else pdhg_chunk._streamed(C, M, N, cb, sb, optin))

    first = pool[0]
    blocks, held = card.occupancy_of(variant(first), M, N, dtype)
    if held and S * first >= card.SMS and blocks >= 2:
        assert v.cluster == first
        return

    def cost(C):
        held = card.occupancy_of(variant(C), M, N, dtype)[1]
        extra = pdhg_chunk.CLUSTER_STEP_ROWS if C > 1 else 0
        return -(-S // held) * (-(-M // C) + extra) if held else None

    costs = {C: cost(C) for C in pool if cost(C) is not None}
    best = min(costs.values())
    assert v.cluster == min(C for C, c in costs.items() if c == best)


def test_cluster_size_follows_the_reported_occupancy():
    """pick_variant reads the clusters held at once from its occupancy
    callback (the card's query there): uneven GPCs that hold fewer
    clusters of 16 move the choice to a smaller size."""
    def pick(S, dtype, table):
        return pick_variant(S, M, N, dtype, card.SMEM_OPTIN, card.SMS,
                            lambda v, M, N, dtype: (
                                1, table.get(v.cluster, 0)))

    M, N = 151, 268
    assert pick(4, F64, {c: 132 // c for c in range(1, 17)}) == _res(16)
    # a card that holds no cluster of more than 8 blocks
    assert pick(4, F64, {c: 132 // c for c in range(1, 9)}) == _res(8)
    # 12 scenarios, room for only 4 clusters of 16 but 12 of 11: one
    # round of 14 rows a block beats three rounds of 10
    assert pick(12, F32, {**{c: 132 // c for c in range(1, 16)},
                          16: 4}) == _res(11)
    with pytest.raises(ValueError, match="no cluster size"):
        pick(4, F64, {})


def test_chunk_bytes_charges_a_wave_beyond_the_chip():
    """chip_smoke.py's bound counts A once, plus, at every step of each
    wave, what of the A of the scenarios the card holds at once exceeds
    its on-chip memory (an H100: 132 x 232,448 B of shared memory and
    50 MiB of L2)."""
    import chip_smoke

    on_chip = 132 * 232448 + 50 * 2 ** 20

    def nbytes(S, M, N, dtype, wave, shared=False):
        def t(*shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device="meta")
        vec = [t(S, N)] * 4 + [t(S, M)] * 2 + [t(S, N), t(S, M)] \
            + [t(S)] * 2
        return chip_smoke.chunk_bytes(t(1 if shared else S, M, N), vec,
                                      40, on_chip, wave)

    def vectors(S, M, N, b):
        return (7 * S * N + 5 * S * M + 2 * S) * b

    # aircondB: ten bundles of 9.9 MB, all held at once (14 clusters)
    a = 10 * 1552 * 1600 * 4
    assert nbytes(10, 1552, 1600, F32, 14) \
        == a + 40 * (a - on_chip) + vectors(10, 1552, 1600, 4)
    # FWPH's f64 hull QP: 131.6 MB in all, but the 198 scenarios held at
    # once take 26 MB: A once; the whole batch as one wave would not fit
    a = 1000 * 121 * 136 * 8
    assert nbytes(1000, 121, 136, F64, 198) \
        == a + vectors(1000, 121, 136, 8)
    assert nbytes(1000, 121, 136, F64, None) \
        == a + 40 * (a - on_chip) + vectors(1000, 121, 136, 8)
    # a shared matrix counts once, whatever the wave
    assert nbytes(250, 174, 114, F32, 2, shared=True) \
        == 174 * 114 * 4 + vectors(250, 174, 114, 4)


def test_pick_variant_sizes_and_limits():
    v = card.pick(1000, 61, 120, F32)
    assert (v.warps, v.tile_rows, v.tile_cols) == (8, 64, 128)
    # x, x~, c, q, lb, ub, xsum and the (8, 128) reduction buffer over
    # 128 columns; y, rlo, rhi, ysum over 64 rows
    assert v.smem_bytes(61, 120, 4, 4) == (15 * 128 + 4 * 64) * 4
    # the cluster kernel's state is sized to N and the band, not padded:
    # x~ (136), the partial A^T y (256 = threads), six slice vectors and
    # four band vectors, then the band of A
    assert _res(1).smem_bytes(121, 136, 4, 4) \
        == (136 + 256 + 6 * 136 + 4 * 121) * 4 + 121 * 136 * 4
    assert _res(4).smem_bytes(121, 136, 8, 8) \
        == (136 + 256 + 6 * 34 + 4 * 31) * 8 + 31 * 136 * 8
    # streamed: 2 stages of 4 rows (+16 bytes for a band that starts off
    # 16 bytes), the dot's (8 warps x 8 rows) partials, no band of A
    assert Variant("streamed", 16, 4).smem_bytes(1552, 1600, 4, 4) \
        == 2 * (4 * 1600 * 4 + 16) \
        + (2 * 1600 + 6 * 100 + 4 * 97 + 64) * 4
    assert _res(2).smem_bytes(10, 304, 4, 2) \
        - _res(2).smem_bytes(10, 304, 4, 4) == -5 * 304 * 2
    # A resident only while a band fits the opt-in limit (a card whose
    # SMs each hold one block of any cluster size)
    assert pick_variant(3, 200, 200, F32, 10_000, card.SMS,
                        lambda v, M, N, dtype: (1, 132 // v.cluster)
                        ).source == "streamed"
    with pytest.raises(ValueError, match="cannot launch"):
        card.pick(1, 4, 100_000, F64)
    with pytest.raises(ValueError, match="cannot launch"):
        card.pick(1, 6001, 12000, F64)
    with pytest.raises(TypeError, match="no kernel"):
        card.pick(1000, 61, 120, torch.float16)


@pytest.mark.parametrize("M, N", [(151, 268), (1552, 1600), (6001, 12000),
                                  (174, 114), (65, 129), (9, 300)])
@pytest.mark.parametrize("dtype", [F32, F64, BF16])
def test_every_kernel_route_shape_launches(M, N, dtype):
    """The route rule keeps its limits; every dense shape it sends to the
    kernel has a variant, and every shared or split one a variant whose
    one block (or register tile) holds the whole matrix."""
    for form in ("dense", "shared", "split"):
        if pdhg_chunk.pick_route(form, M, N, dtype) != "kernel":
            continue
        cb, sb = pdhg_chunk.compute_dtype(dtype).itemsize, dtype.itemsize
        for S in (1, 7, 1000):
            v = card.pick(S, M, N, dtype)
            if form != "dense":
                assert v.source in ("registers", "resident")
                assert v.source == "registers" or _res(1).smem_bytes(
                    M, N, cb, sb) <= card.SMEM_OPTIN


# ---- a model of the cluster kernel's schedule -----------------------------

def _owner(j, N, C):
    """csrc slice_owner: the block whose column slice holds column j."""
    return (C * (j + 1) - 1) // N


def test_slice_owner_formula():
    for N in (1, 5, 7, 136, 268, 1600):
        for C in range(1, 17):
            for p in range(C):
                for j in range(p * N // C, (p + 1) * N // C):
                    assert _owner(j, N, C) == p


def _lane_dot(A_rows, xt):
    """(S, R) row dots: lane l sums columns l, l + 32, ... with one FMA
    chain, then the 32 lanes are totalled (the kernel's reduce-scatter
    adds them in another tree order)."""
    S, R, N = A_rows.shape
    lanes = torch.zeros((S, R, 32), dtype=A_rows.dtype)
    for j in range(N):
        lanes[:, :, j % 32] = lanes[:, :, j % 32] + A_rows[:, :, j] * xt[:, None, j]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, :, [l ^ o for l in range(32)]]
    return lanes[:, :, 0]


def cluster_schedule(A, cs, qs, lb, ub, rlo, rhi, x, y, tau, sigma, n_steps,
                     C, stage_rows=None, threads=256):
    """The cluster kernel's schedule in torch: C blocks a scenario, block
    r owning rows [r M / C, (r + 1) M / C) and columns [r N / C, (r + 1)
    N / C); a carry-only pass forms A^T y0; each step sums the C blocks'
    partial A^T y (by row group g = band row % G) in a fixed order, does
    the primal update, then one pass over each band row by row (the dot
    and the dual update, then the carry of A^T y(new), skipped at the
    last step).  `stage_rows` cuts each band into streamed stages (the
    carry resumes its sums across them)."""
    S, M, N = A.shape
    G = threads // N if N < threads else 1
    bands = [(r * M // C, (r + 1) * M // C) for r in range(C)]
    t2, s2 = tau[:, None], sigma[:, None]
    xs, ys = torch.zeros_like(x), torch.zeros_like(y)

    def carry(y):
        # per stage and row group: four running sums over every fourth
        # row of the group, added pairwise, the first resuming the sum
        parts = []
        for r0, r1 in bands:
            part = torch.zeros((S, G, N), dtype=A.dtype)
            rows = stage_rows or max(1, r1 - r0)
            for i0 in range(0, r1 - r0, rows):
                i1 = min(r1 - r0, i0 + rows)
                for g in range(G):
                    grp = [i for i in range(i0, i1) if i % G == g]
                    acc = [part[:, g]] + [torch.zeros_like(part[:, g])] * 3
                    for k, i in enumerate(grp):
                        acc[k % 4] = acc[k % 4] + A[:, r0 + i] \
                            * y[:, r0 + i, None]
                    part[:, g] = (acc[0] + acc[1]) + (acc[2] + acc[3])
            parts.append(part)
        return parts

    parts = carry(y) if n_steps > 0 else None
    for step in range(n_steps):
        # C = 1: the row groups in order; else the peers four at a time
        # (a row group's four peers, then the next group's)
        aty = torch.zeros_like(x)
        for j in range(N):
            tot = None
            for p0 in range(0, C, 4):
                for g in range(G):
                    for p in range(p0, min(C, p0 + 4)):
                        v = parts[p][:, g, j]
                        tot = v if tot is None else tot + v
            aty[:, j] = tot
        xn = _proj(x - t2 * (cs + qs * x + aty), lb, ub)
        xt = 2.0 * xn - x
        yn = y.clone()
        for r0, r1 in bands:
            if r1 > r0:
                ax = _lane_dot(A[:, r0:r1], xt)
                v = y[:, r0:r1] + s2 * ax
                yn[:, r0:r1] = v - s2 * _proj(v / s2, rlo[:, r0:r1],
                                              rhi[:, r0:r1])
        x, y = xn, yn
        xs, ys = xs + xn, ys + yn
        if step + 1 < n_steps:
            parts = carry(y)
    return x, y, xs, ys


def _proj(v, lo, hi):
    return torch.minimum(torch.maximum(v, lo), hi)


@pytest.mark.parametrize("shape", [(2, 11, 7), (3, 20, 300)])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("n_steps", [0, 1, 5])
def test_cluster_schedule_matches_the_plain_version(shape, C, n_steps):
    """The band partition, the carried A^T y, the fixed-order cluster
    sums and the extra first pass give the plain version's iterates in
    float64 (resident, and streamed in stages of 3 rows)."""
    S, M, N = shape
    rng = np.random.default_rng(7)
    args = [torch.as_tensor(a) for a in (
        rng.standard_normal((S, M, N)), rng.standard_normal((S, N)),
        np.abs(rng.standard_normal((S, N))) * 0.1, -np.ones((S, N)),
        np.full((S, N), 3.0),
        np.where(rng.random((S, M)) < 0.5, -np.inf, -rng.random((S, M))),
        rng.random((S, M)) + 1.0, rng.random((S, N)),
        rng.standard_normal((S, M)) * 0.1, 0.05 + 0.02 * rng.random(S),
        0.05 + 0.02 * rng.random(S))]
    want = fused_chunk_reference(*args, n_steps)
    for stage_rows in (None, 3):
        got = cluster_schedule(*args, n_steps, C, stage_rows)
        for name, g, w in zip(("x", "y", "xs", "ys"), got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-12, err_msg=name)
