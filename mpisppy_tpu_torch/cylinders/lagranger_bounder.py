"""Lagranger outer-bound spoke (port of
`mpisppy_tpu/cylinders/lagranger_bounder.py`): an independent
Lagrangian that takes the hub's nonant values (not its W), keeps its
own W by xbar and dual updates at its own rho, and reports the dual
bounds.  Optional per-iteration rho rescale factors
(`lagranger_rho_rescale_factors_json`) accumulate.
"""

from __future__ import annotations

import json

import torch

from ..phbase import compute_xbar, update_W
from .spoke import OuterBoundNonantSpoke


class LagrangerOuterBound(OuterBoundNonantSpoke):
    converger_spoke_char = "A"

    def __init__(self, spbase_object, options=None):
        super().__init__(spbase_object, options=options)
        b = self.opt.batch
        rho0 = float(self.opt.options.get("defaultPHrho", 1.0))
        shape = (b.num_scens, b.num_nonants)
        self.rho = torch.full(shape, rho0, dtype=b.c.dtype,
                              device=b.c.device)
        self.W = torch.zeros(shape, dtype=b.c.dtype, device=b.c.device)
        self._iter = 0
        path = self.opt.options.get("lagranger_rho_rescale_factors_json")
        self.rho_rescale_factors = None
        if path is not None:
            with open(path) as f:
                din = json.load(f)
            self.rho_rescale_factors = {int(i): float(v)
                                        for i, v in din.items()}

    def step(self):
        x_na, is_new = self.fresh_nonants()
        if self._killed or not is_new:
            return False
        return self._solve_pass(x_na)

    def _solve_pass(self, x_na):
        if self.rho_rescale_factors is not None and \
                self._iter in self.rho_rescale_factors:
            self.rho = self.rho * self.rho_rescale_factors[self._iter]
        b = self.opt.batch
        x_na = torch.as_tensor(x_na, dtype=b.c.dtype, device=b.c.device)
        xbar, _ = compute_xbar(b, x_na)
        self.W = update_W(self.W, self.rho, x_na, xbar)
        c_eff = b.c.clone()
        c_eff[:, b.nonant_idx] += self.W
        self.opt.check_W_bound_supported()
        res = self.opt.solve_loop(c=c_eff, warm=True)
        self.update_if_improving(float(self.opt.valid_Ebound(res)))
        self._iter += 1
        return True

    def finalize(self):
        """Final bound pass with the last nonants, after the kill."""
        x_na, _ = self.fresh_nonants()
        self._solve_pass(x_na)
        return self.bound
