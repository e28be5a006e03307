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
the register tiles (M 64/65, N 128/129), the cluster kernel with A
resident and streamed, and a batch of 3 scenarios that the cluster
kernel spreads over the card.
"""

import numpy as np
import pytest
import torch

from mpisppy_tpu_torch import ir
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
from mpisppy_tpu_torch.ops.pdhg import (PDHGSolver, prepare_batch,
                                        prepare_split_native)
from mpisppy_tpu_torch.ops.pdhg_chunk import (Variant, compute_dtype,
                                              fused_chunk,
                                              fused_chunk_reference)

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
    v = pdhg_chunk.card_variant(S, M, N, dtype)
    if shape == (2, 200, 200) and dtype == torch.float64:
        # 320 KB of A: resident across a cluster
        assert v.source == "resident" and v.cluster >= 2
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
    v, blocks, held = pdhg_chunk.occupancy(1000, 61, 120, dtype)
    assert v.source == "registers"
    assert blocks >= 1 and held == blocks * pdhg_chunk.sm_count()
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
            v, blocks, _ = pdhg_chunk.occupancy(1000, 61, 120, dtype, form)
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
    assert pdhg_chunk.pick_route("shared", M, N, torch.float64) == "matmul"
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_shared_form_at_the_uc_fallback_shape(cuda, dtype):
    """UC at bench.py's fallback size (fleet_multiplier=2, H=6) is one
    shared (1, 174, 114) matrix: the cluster kernel with A resident in
    one block's shared memory, against its plain version and the dense
    kernel."""
    from mpisppy_tpu_torch.models import uc
    S = 250
    b = uc.build_batch(S, H=6, fleet_multiplier=2, device="cpu")
    assert tuple(b.A.shape) == (1, 174, 114)
    v = pdhg_chunk.card_variant(S, 174, 114, dtype)
    assert v.source == "resident"
    args = _instance(S, 174, 114, 12, dtype, cuda)
    A = prepare_batch(b.A, b.row_lo, b.row_hi).A.to(cuda, dtype)
    before = pdhg_chunk.launch_shapes[("shared", S, 174, 114,
                                       str(dtype).replace("torch.", ""))]
    got = fused_chunk(A, *args[1:], 40)
    torch.cuda.synchronize()
    assert pdhg_chunk.launch_shapes[(
        "shared", S, 174, 114, str(dtype).replace("torch.", ""))] \
        == before + 1
    _assert_matches(got, pdhg_chunk.fused_chunk_shared_reference(
        A, *args[1:], 40), dtype)
    dense = fused_chunk(A.expand(S, -1, -1).contiguous(), *args[1:], 40)
    for g, w in zip(got, dense):
        assert torch.equal(g, w)


def test_consensus_solve_on_card_matches_cpu(cuda):
    """An EF (consensus) solve of SIPLIB sslp_5_25 at S=5 in float64 on
    the card against the same solve on the CPU: the same decisions and
    iterates within 1e-9 (the segment sums use atomics on the card, so
    not bit for bit).  It runs on the consensus route: no launch of the
    chunk kernel, no matmul-route chunk."""
    from mpisppy_tpu_torch.models import sslp
    from mpisppy_tpu_torch.opt.ef import ExtensiveForm
    import dataclasses
    opts = {"pdhg_eps": 1e-6, "pdhg_max_iters": 200000}
    names = sslp.scenario_names_creator(5)
    ref = ExtensiveForm(opts, names, device="cpu", batch=sslp.build_batch(
        5, instance="sslp_5_25", device="cpu"))
    ef = ExtensiveForm(opts, names, device=cuda, prep=ref.prep,
                       batch=sslp.build_batch(5, instance="sslp_5_25",
                                              device="cpu"))
    # one start vector for the EF's power iteration on both devices (the
    # CPU and CUDA generators draw different numbers)
    v0 = np.random.default_rng(13).standard_normal(
        tuple(ref.batch.c.shape))
    for e in (ref, ef):
        e.consensus = dataclasses.replace(e.consensus, v0=v0)
    cpu = ref.solve_extensive_form()
    k0, m0, c0 = (pdhg_chunk.launches, pdhg.matmul_chunks,
                  pdhg.consensus_chunks)
    got = ef.solve_extensive_form()
    torch.cuda.synchronize()
    assert pdhg_chunk.launches == k0 and pdhg.matmul_chunks == m0
    assert pdhg.consensus_chunks - c0 == got.iters // 40 > 0
    assert got.iters == cpu.iters
    assert torch.equal(got.converged.cpu(), cpu.converged)
    for f in ("x", "y", "obj", "dual_obj"):
        g, w = getattr(got, f).cpu(), getattr(cpu, f)
        assert float((g - w).abs().max()) <= 1e-9 * max(
            1.0, float(w.abs().max()))
    assert abs(ef.get_objective_value() - ref.get_objective_value()) \
        <= 1e-9 * abs(ref.get_objective_value())


@pytest.mark.parametrize("mode", ["interleaved", "threads"])
def test_farmer_wheel_on_card(cuda, monkeypatch, mode):
    """A PH hub with a Lagrangian and an XhatShuffle spoke on farmer-3 at
    crops_multiplier=2, float64, on the card.  The default (split) prep
    sends the supersteps and Lagrangian solves to the kernel's split
    form and the xhat system to its shared form; both must launch, the
    launch counter must equal an independent count of the wrapper's
    calls (the spokes launch from their own threads in threads mode),
    and the bounds must bracket the EF optimum (the port's
    ExtensiveForm in float64 on the card) within 1e-6 relative."""
    import threading

    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.cylinders.lagrangian_bounder import (
        LagrangianOuterBound)
    from mpisppy_tpu_torch.cylinders.xhatshufflelooper_bounder import (
        XhatShuffleInnerBound)
    from mpisppy_tpu_torch.opt.ef import ExtensiveForm
    from mpisppy_tpu_torch.opt.ph import PH
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    from mpisppy_tpu_torch.utils.xhat_eval import Xhat_Eval
    S, cm = 3, 2
    names = farmer.scenario_names_creator(S)
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 40, "convthresh": 0.0,
            "pdhg_eps": 1e-7, "pdhg_max_iters": 20000}
    calls, lock = [0], threading.Lock()
    launch = pdhg.fused_chunk

    def counted(*a):
        with lock:
            calls[0] += 1
        return launch(*a)

    monkeypatch.setattr(pdhg, "fused_chunk", counted)
    hub = {"hub_class": PHHub,
           "hub_kwargs": {"options": {"rel_gap": 1e-4, "abs_gap": 1.0}},
           "opt_class": PH,
           "opt_kwargs": {"options": dict(opts), "all_scenario_names": names,
                          "batch": farmer.build_batch(S, crops_multiplier=cm,
                                                      device=cuda)}}
    spokes = [{"spoke_class": cls, "spoke_kwargs": {"options": {}},
               "opt_class": ocls,
               "opt_kwargs": {"options": dict(opts),
                              "all_scenario_names": names}}
              for cls, ocls in ((LagrangianOuterBound, PH),
                                (XhatShuffleInnerBound, Xhat_Eval))]
    pdhg_chunk.launches = 0
    pdhg_chunk.launch_shapes.clear()
    ws = WheelSpinner(hub, spokes, mode=mode).spin()
    torch.cuda.synchronize()
    by_form = pdhg_chunk.launches_by("form")
    assert by_form.get("split", 0) > 0 and by_form.get("shared", 0) > 0
    assert pdhg_chunk.launches == calls[0] == sum(by_form.values())
    assert ws.spcomm.failed_spokes == []
    assert ws.spcomm.finalize_failures == []
    assert ws.spcomm.opt.state.x.device.type == "cuda"
    ef = ExtensiveForm({"pdhg_eps": 1e-9, "pdhg_max_iters": 400000}, names,
                       batch=farmer.build_batch(S, crops_multiplier=cm,
                                                device=cuda))
    ef.solve_extensive_form()
    opt = ef.get_objective_value()
    tol = 1e-6 * abs(opt)
    assert np.isfinite(ws.BestOuterBound) and np.isfinite(ws.BestInnerBound)
    assert ws.BestOuterBound <= opt + tol
    assert ws.BestInnerBound >= opt - tol


@pytest.mark.parametrize("form", ["dense", "split"])
def test_kernel_on_a_compacted_slab(cuda, form):
    """The dense and split forms on a prep gathered to 5 of 16 farmer
    scenarios (`ops.pdhg._gather_prep`, as `solve_compacted` gathers its
    survivors): the kernel matches its plain version, and the gathered
    SplitA keeps the full prep's shared block and a contiguous (5, nnz)
    block of values."""
    b = farmer.build_batch(16, crops_multiplier=2, device=cuda)
    if form == "split":
        prep = pdhg.prepare_batch_split(b.A, *b.model_meta["A_delta_idx"],
                                        b.row_lo, b.row_hi)
    else:
        prep = prepare_batch(b.A, b.row_lo, b.row_hi)
    ii = torch.tensor([0, 3, 7, 8, 15], device=cuda)
    g = pdhg._gather_prep(prep, ii)
    if form == "split":
        assert g.A.shared is prep.A.shared
        assert tuple(g.A.vals.shape) == (5, prep.A.vals.shape[1])
        assert g.A.vals.is_contiguous()
    dc = g.d_col
    qs = (b.qdiag[ii] * dc * dc).contiguous()
    lbs = (b.lb[ii] / dc).contiguous()
    ubs = torch.where(torch.isfinite(b.ub[ii]), b.ub[ii] / dc,
                      b.ub[ii]).contiguous()
    x = torch.clamp(0.5 * (lbs + torch.clamp(ubs, max=1e3)), min=0.0)
    y = torch.zeros_like(g.row_lo)
    tau = (0.9 / (g.anorm + 0.9 * qs.amax(dim=1))).contiguous()
    sigma = (0.9 / g.anorm).expand(tau.shape).contiguous()
    args = ((b.c[ii] * dc).contiguous(), qs, lbs, ubs, g.row_lo.contiguous(),
            g.row_hi.contiguous(), x.contiguous(), y, tau, sigma, 40)
    A = g.A.contiguous()
    n0 = pdhg_chunk.launch_shapes[(form, 5, b.num_rows, b.num_vars,
                                   "float64")]
    got = fused_chunk(A, *args)
    assert pdhg_chunk.launch_shapes[(form, 5, b.num_rows, b.num_vars,
                                     "float64")] == n0 + 1
    _assert_matches(got, pdhg_chunk.REFERENCE[form](A, *args),
                    torch.float64)


def test_farmer_wheel_with_telemetry_on_card(cuda, tmp_path):
    """An interleaved farmer-3 wheel with telemetry into a dir on the
    card: no spoke fails in a step or in its final pass, and trace.json
    has one row each for the hub and the two spokes."""
    import json

    from mpisppy_tpu_torch import telemetry
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.cylinders.lagrangian_bounder import (
        LagrangianOuterBound)
    from mpisppy_tpu_torch.cylinders.xhatshufflelooper_bounder import (
        XhatShuffleInnerBound)
    from mpisppy_tpu_torch.opt.ph import PH
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    from mpisppy_tpu_torch.utils.xhat_eval import Xhat_Eval
    names = farmer.scenario_names_creator(3)
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 10, "convthresh": 0.0,
            "pdhg_eps": 1e-7, "pdhg_max_iters": 20000,
            "telemetry": {"dir": str(tmp_path)}}
    hub = {"hub_class": PHHub,
           "hub_kwargs": {"options": {"rel_gap": 1e-4, "abs_gap": 1.0}},
           "opt_class": PH,
           "opt_kwargs": {"options": dict(opts), "all_scenario_names": names,
                          "batch": farmer.build_batch(3, device=cuda)}}
    spokes = [{"spoke_class": cls, "spoke_kwargs": {"options": {}},
               "opt_class": ocls,
               "opt_kwargs": {"options": dict(opts),
                              "all_scenario_names": names}}
              for cls, ocls in ((LagrangianOuterBound, PH),
                                (XhatShuffleInnerBound, Xhat_Eval))]
    telemetry.reset()
    try:
        ws = WheelSpinner(hub, spokes).spin()
        traffic = telemetry.traffic_counters()
    finally:
        telemetry.reset()
    assert ws.spcomm.failed_spokes == []
    assert ws.spcomm.finalize_failures == []
    evs = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    rows = sorted(e["args"]["name"] for e in evs if e["ph"] == "M")
    assert rows == ["hub", "spoke0:LagrangianOuterBound",
                    "spoke1:XhatShuffleInnerBound"]
    assert traffic["window_writes"] > 0 and traffic["window_reads"] > 0
    snap = json.loads((tmp_path / "metrics.jsonl").read_text()
                      .splitlines()[-1])
    assert snap["histograms"]["ph.phase.solve_seconds"]["count"] > 0


# the cluster kernel's rows: (S, M, N, A's storage dtypes, source), the
# shapes that reach it on the paths (aircondB's bundles, acopf3 ieee14
# and its f64 certify at S'=4, FWPH's hull QP, sizes, UC's fallback,
# usar)
CLUSTER_ROWS = [
    ((10, 1552, 1600), (torch.float32,), "streamed"),
    ((12, 151, 268), (torch.float32, torch.float64), "resident"),
    ((4, 151, 268), (torch.float64,), "resident"),
    ((1000, 121, 136), (torch.float32, torch.float64), "resident"),
    ((3, 62, 150), (torch.float32, torch.float64), "resident"),
    ((250, 174, 114), (torch.float32, torch.float64, torch.bfloat16),
     "resident"),
    ((3, 251, 314), (torch.float32, torch.float64), "resident")]


@pytest.mark.parametrize("shape, dtypes, source", CLUSTER_ROWS,
                         ids=["aircondB", "ieee14", "ieee14_certify",
                              "hull_qp", "sizes", "uc_fallback", "usar"])
def test_cluster_kernel_rows_match_twin(cuda, shape, dtypes, source):
    S, M, N = shape
    for dtype in dtypes:
        args = _instance(S, M, N, 21, dtype, cuda)
        # step sizes 0.9 / ||A||_2, as the solver's prep sets them: the
        # fixed ones of _instance make the larger shapes diverge
        norm = torch.linalg.matrix_norm(args[0].double(), ord=2)
        args[9] = (0.9 / norm).to(args[9].dtype)
        args[10] = args[9].clone()
        v = pdhg_chunk.card_variant(S, M, N, dtype)
        assert v.source == source
        key = ("dense", S, M, N, str(dtype).replace("torch.", ""),
               v.source, v.cluster)
        before = pdhg_chunk.variant_launches[key]
        got = fused_chunk(*args, 40)
        torch.cuda.synchronize()
        assert pdhg_chunk.variant_launches[key] == before + 1
        _assert_matches(got, fused_chunk_reference(*args, 40), dtype)
        del args, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 67, 150), (5, 131, 37)])
@pytest.mark.parametrize("variant", [
    Variant("resident", 1), Variant("resident", 3), Variant("resident", 16),
    Variant("streamed", 1, 1), Variant("streamed", 3, 3),
    Variant("streamed", 16, 2)], ids=lambda v: f"{v.source}{v.cluster}")
def test_cluster_kernel_forms_equal_the_dense_kernel(cuda, dtype, shape,
                                                     variant):
    """Each source of the cluster kernel at three cluster sizes: the
    shared and split forms equal the dense kernel on the assembled
    matrices bit for bit, and each matches its plain version."""
    S, M, N = shape
    args = _instance(S, M, N, 22, dtype, cuda)
    rng = np.random.default_rng(23)
    for form in ("shared", "split"):
        if form == "shared":
            A = args[0][:1].contiguous()
            dense = A.expand(S, M, N).contiguous()
        else:
            A = _split_of(args[0], rng, 2 * M)
            dense = A.to_dense().contiguous()
        for n_steps in (0, 1, 7):
            got = fused_chunk(A, *args[1:], n_steps, variant=variant)
            want = fused_chunk(dense, *args[1:], n_steps, variant=variant)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            _assert_matches(got, pdhg_chunk.REFERENCE[form](
                A, *args[1:], n_steps), dtype)


def test_a_variant_that_cannot_launch_is_refused(cuda):
    args = _instance(3, 300, 300, 24, torch.float32, cuda)
    with pytest.raises(ValueError, match="cannot launch"):
        fused_chunk(*args, 3, variant=Variant("resident", 1))  # 360 KB
    with pytest.raises(ValueError, match="cannot launch"):
        fused_chunk(*args, 3, variant=Variant("registers"))
