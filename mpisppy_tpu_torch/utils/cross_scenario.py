"""Batch augmentation for cross-scenario cuts (port of
`mpisppy_tpu/utils/cross_scenario.py`; reference:
mpisppy/extensions/cross_scen_extension.py and the opt/lshaped eta
machinery).

`add_cross_scenario_capacity(batch, max_cuts, eta_weight)` appends

  * one variable `_eta_cross` (an epigraph of the EXPECTED value
    function E[f](x)), and
  * `max_cuts` initially free constraint rows that the hub-side
    extension fills with aggregate optimality cuts,

and blends every scenario's objective to (1-w) f_s + w eta.  With tight
cuts, eta = E[f](x) at consensus, so the blended expected objective
equals E[f]; in between, each subproblem sees the other scenarios'
costs through eta.

The augmented A is dense per scenario (a shared or split A is expanded
first: each cut is one more row of every scenario) and keeps the
batch's dtype and device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import host
from ..ir import ScenarioBatch

BIG = 1e9


def add_cross_scenario_capacity(batch: ScenarioBatch, max_cuts=20,
                                eta_weight=0.1) -> ScenarioBatch:
    batch = batch.densify()
    S, N, M = batch.num_scens, batch.num_vars, batch.num_rows
    w = float(eta_weight)
    dt, dev = batch.c.dtype, batch.c.device

    def pad_col(v, fill):
        return torch.cat([v, torch.full((S, 1), fill, dtype=v.dtype,
                                        device=dev)], dim=1)

    A = torch.zeros((S, M + max_cuts, N + 1), dtype=batch.A.dtype,
                    device=dev)
    A[:, :M, :N] = batch.A
    inf = torch.full((S, max_cuts), float("inf"), dtype=dt, device=dev)
    return ScenarioBatch(
        c=pad_col((1.0 - w) * batch.c, w),
        qdiag=pad_col((1.0 - w) * batch.qdiag, 0.0),
        A=A,
        row_lo=torch.cat([batch.row_lo, -inf], dim=1),
        row_hi=torch.cat([batch.row_hi, inf], dim=1),
        lb=pad_col(batch.lb, -BIG),
        ub=pad_col(batch.ub, BIG),
        obj_const=(1.0 - w) * batch.obj_const,
        nonant_idx=batch.nonant_idx,
        integer_mask=pad_col(batch.integer_mask, False),
        tree=batch.tree,
        stage_cost_c=None,
        var_names=tuple(batch.var_names or ()) + ("_eta_cross",),
    )


def cross_meta(batch: ScenarioBatch):
    """The cut-buffer layout, derived from the batch: the eta column is
    the last variable (named _eta_cross); the cut buffer is the
    trailing block of rows that are either still free (all-zero,
    unbounded) or installed cuts (coefficient 1.0 on eta).  None for a
    batch without the eta column."""
    if not batch.var_names or batch.var_names[-1] != "_eta_cross":
        return None
    A0 = host(batch.A[0])
    lo0 = host(batch.row_lo[0])
    hi0 = host(batch.row_hi[0])
    M, N = A0.shape
    eta = N - 1
    first = M
    n_cuts = 0
    for r in range(M - 1, -1, -1):
        is_free = (not A0[r].any()) and np.isinf(lo0[r]) and \
            np.isinf(hi0[r])
        is_cut = A0[r, eta] == 1.0
        if is_free or is_cut:
            first = r
            if is_cut:
                n_cuts += 1
        else:
            break
    return {"first_cut_row": first, "max_cuts": M - first,
            "n_cuts": n_cuts, "eta_col": eta}
