"""The chunk kernel's grouped forms on the card (jax-free; marked
`cuda`, skipped without one): a coalesced group's launch (B matrices,
each read by its request's scenarios) against its plain version (2e-4
in f32 and bf16, 1e-9 in f64, relative to the largest magnitude),
bit-equal to the B requests' solo launches at the same variant, and a
group of one matrix bit-equal to the ungrouped launch; on the register
tile (M=5, N=7) and on the cluster kernel (M=70, N=130).

    python -m pytest --noconftest -q tests/test_torch_cuda_grouped.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpisppy_tpu_torch.ir import GroupedA, SplitA
from mpisppy_tpu_torch.ops import pdhg_chunk

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-9, torch.float32: 2e-4, torch.bfloat16: 2e-4}
B = 3


def _group(form, storage, M, N, per_base, seed=0):
    rng = np.random.default_rng(seed)
    S = B * per_base
    dev = "cuda"
    compute = pdhg_chunk.compute_dtype(storage)
    arrs = [rng.standard_normal((S, N)),
            np.abs(rng.standard_normal((S, N))) * 0.1, np.zeros((S, N)),
            np.full((S, N), 10.0),
            np.where(rng.random((S, M)) < 0.5, -np.inf,
                     -rng.random((S, M))),
            rng.random((S, M)) + 1.0, rng.random((S, N)),
            rng.standard_normal((S, M)) * 0.1,
            0.05 + 0.02 * rng.random(S), 0.05 + 0.02 * rng.random(S)]
    vec = [torch.as_tensor(a, dtype=compute, device=dev) for a in arrs]
    shared = torch.as_tensor(rng.standard_normal((B, M, N)), device=dev)
    if form == "shared":
        return GroupedA(stack=shared.to(storage), per_base=per_base), vec
    rows = np.array([0, 2, M - 1, 2], np.int32)
    cols = np.array([1, 3, 3, N - 1], np.int32)
    shared[:, rows, cols] = 0.0
    return SplitA(shared=shared.to(storage),
                  rows=torch.as_tensor(rows, device=dev),
                  cols=torch.as_tensor(cols, device=dev),
                  vals=torch.as_tensor(rng.standard_normal((S, 4)),
                                       device=dev).to(storage)), vec


def test_grouped_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: run on the card with "
                    "python -m pytest --noconftest "
                    "tests/test_torch_cuda_grouped.py")
    for M, N in ((5, 7), (70, 130)):
        for storage in (torch.float32, torch.float64, torch.bfloat16):
            for form in ("shared", "split"):
                for per_base in (2, 40):
                    A, vec = _group(form, storage, M, N, per_base)
                    S = B * per_base
                    got = pdhg_chunk.fused_chunk(A, *vec, 40)
                    want = pdhg_chunk.REFERENCE[form](
                        A.to("cpu"), *[v.cpu() for v in vec], 40)
                    for g, w in zip(got, want):
                        assert bool(torch.isfinite(g).all())
                        scale = max(1.0, float(w.abs().max()))
                        assert float((g.cpu() - w).abs().max()) \
                            <= TOL[storage] * scale
                    v = pdhg_chunk.card_variant(S, M, N, storage)
                    for b in range(B):
                        rows = slice(b * per_base, (b + 1) * per_base)
                        one = (dataclasses.replace(
                            A, shared=A.shared[b], vals=A.vals[rows])
                            if form == "split" else A.stack[b:b + 1])
                        part = [t[rows].contiguous() for t in vec]
                        solo = pdhg_chunk.fused_chunk(one, *part, 40,
                                                      variant=v)
                        for g, s in zip(got, solo):
                            assert torch.equal(g[rows], s)
                    # a group of one matrix
                    one1 = (dataclasses.replace(one, shared=one.shared[None])
                            if form == "split"
                            else GroupedA(stack=one, per_base=per_base))
                    a = pdhg_chunk.fused_chunk(one1, *part, 40, variant=v)
                    for g, s in zip(a, solo):
                        assert torch.equal(g, s)
