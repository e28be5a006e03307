"""Lagrangian outer-bound spoke (port of
`mpisppy_tpu/cylinders/lagrangian_bounder.py`).

Receives PH's W from the hub, re-solves every scenario with the
W-modified objective (no prox term) and reports the probability-
weighted dual bound: valid because the probability-weighted W sums to
zero within each tree node.  The solve is the hub's batched PDHG
solve (the chunk kernel on the card) with its own warm-start cache.
"""

from __future__ import annotations

import torch

from .spoke import _BoundWSpoke


class LagrangianOuterBound(_BoundWSpoke):
    converger_spoke_char = "L"

    def _solve_pass(self, W):
        """W-only re-solve and its dual bound."""
        self.opt.check_W_bound_supported()
        b = self.opt.batch
        c_eff = b.c.clone()
        c_eff[:, b.nonant_idx] += torch.as_tensor(W, dtype=b.c.dtype,
                                                  device=b.c.device)
        res = self.opt.solve_loop(c=c_eff, warm=True)
        # valid_Ebound: finite-box LPs are valid at any iterate;
        # otherwise uncertified scenarios mask the bound to -inf
        self.update_if_improving(float(self.opt.valid_Ebound(res)))

    def step(self):
        W, is_new = self.fresh_Ws()
        if self._killed or not is_new:
            return False
        self._solve_pass(W)
        return True

    def finalize(self):
        """One final pass with the last W."""
        W, _ = self.fresh_Ws()
        self._solve_pass(W)
        return self.bound
