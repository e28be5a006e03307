"""FLOP accounting for the batched solver (port of
`mpisppy_tpu/utils/mfu.py`, `pdhg_flops` only).

Device peak tables and the MFU gauge are not ported yet: H100 peaks
live in `chip_smoke.py`, which measures on the card.
"""

from __future__ import annotations


def pdhg_flops(iters, S, M, N, check_every=40, density=1.0):
    """FLOPs of `iters` PDHG iterations over an (S, M, N) batch: two
    batched matvecs per inner iteration (2*S*M*N FLOP each, one FLOP
    per multiply and per add), plus the KKT check's two matvecs every
    `check_every` iterations.  `density` debits the model when the
    shared block's products go through the sparse product
    (ir.SparseSplitA): they touch only its stored entries."""
    per_iter = 4.0 * S * M * N * density
    checks = 4.0 * S * M * N * density / max(check_every, 1)
    return float(iters) * (per_iter + checks)
