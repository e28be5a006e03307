"""Xhat-xbar inner-bound spoke (port of
`mpisppy_tpu/cylinders/xhatxbar_bounder.py`): the candidate is the
consensus average x̄ itself, rounded on integer slots."""

from __future__ import annotations

import torch

from ..device import host
from ..phbase import compute_xbar
from ..utils.xhat_utils import round_integer_nonants
from .spoke import InnerBoundNonantSpoke


class XhatXbarInnerBound(InnerBoundNonantSpoke):
    converger_spoke_char = "B"

    def step(self):
        x_na, is_new = self.fresh_nonants()
        if self._killed or not is_new:
            return False
        b = self.opt.batch
        xbar, _ = compute_xbar(b, torch.as_tensor(
            x_na, dtype=b.c.dtype, device=b.c.device))
        cand = round_integer_nonants(b, host(xbar))
        obj, feas = self.opt.evaluate_xhat(cand)
        if feas:
            self.update_if_improving(obj, solution=cand)
        return True
